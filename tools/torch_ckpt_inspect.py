#!/usr/bin/env python
"""Inspect / diff sharded checkpoints with the PyTorch port.

The port's twin of ``tools/ckpt_inspect.py``: the same commands, output
and exit codes, read through ``mxnet_tpu_torch.checkpoint``'s ``layout``
and ``reader`` and ``mxnet_tpu_torch.online.compat``.  The checkpoint
format is the JAX package's, so it reads checkpoints written by either
package.

Usage::

    python tools/torch_ckpt_inspect.py show  <ckpt-dir> [--verify]
                                             [--shards]
    python tools/torch_ckpt_inspect.py list  <root>
    python tools/torch_ckpt_inspect.py diff  <ckpt-dir-a> <ckpt-dir-b> [--compat]

``show`` prints the manifest: every array with shape, dtype, shard map
(file, [start,stop) index, bytes, checksum), plus the meta block; with
``--verify`` each shard file is read back and checksummed, printing
OK/CORRUPT per array, and the exit code is 2 if any is corrupt.
``list`` enumerates committed steps under a checkpoint root.  ``diff``
compares two checkpoints structurally (arrays added/removed,
shape/dtype changes) and by content (the assembled values' bytes) and
exits 1 when they differ.

``diff --compat`` prints ONE JSON verdict of whether B's weights can
hot-swap into a consumer serving A's: ``compatible`` plus the ``added``
/ ``removed`` / ``changed`` (shape/dtype) weight deltas and each side's
manifest compat stamp when present; exit 0 when compatible, 1 when not.
Values are never read.  The verdict comes from
``mxnet_tpu_torch.online.compat.check_compat``, the predicate the port's
``Engine.swap_weights`` and ``Router.rolling_swap`` use.
"""
from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def _human(n: int) -> str:
    for unit in ("B", "KiB", "MiB", "GiB"):
        if n < 1024 or unit == "GiB":
            return f"{n:.1f} {unit}" if unit != "B" else f"{n} B"
        n /= 1024.0
    return f"{n} B"


def cmd_show(args) -> int:
    from mxnet_tpu_torch.checkpoint import layout, reader
    manifest = layout.read_manifest(args.ckpt)
    print(f"checkpoint: {args.ckpt}")
    print(f"  format_version: {manifest['format_version']}   "
          f"step: {manifest['step']}   "
          f"process_count: {manifest['process_count']}")
    meta = manifest.get("meta", {})
    if meta:
        print("  meta:")
        for k, v in sorted(meta.items()):
            text = repr(v)
            if len(text) > 96:
                text = text[:93] + "..."
            print(f"    {k}: {text}")
    arrays = manifest["arrays"]
    total = sum(layout.entry_nbytes(e) for e in arrays.values())
    print(f"  arrays: {len(arrays)}   total: {_human(total)}")
    status = {}
    if args.verify:
        cache = reader._ShardFileCache(args.ckpt, verify=True)
        for name, entry in arrays.items():
            try:
                for shard in entry["shards"]:
                    cache.shard_data(name, entry, shard)
                status[name] = "OK"
            except Exception as e:
                status[name] = f"CORRUPT ({e})"
    for name, entry in sorted(arrays.items()):
        line = (f"    {name}  shape={tuple(entry['shape'])} "
                f"dtype={entry['dtype']} shards={len(entry['shards'])} "
                f"{_human(layout.entry_nbytes(entry))}")
        if args.verify:
            line += f"  [{status[name]}]"
        print(line)
        if args.shards:
            for s in entry["shards"]:
                print(f"        {s['file']}  index={s['index']} "
                      f"{_human(s['nbytes'])}  {s['checksum']}")
    if args.verify and any(v != "OK" for v in status.values()):
        return 2
    return 0


def cmd_list(args) -> int:
    from mxnet_tpu_torch.checkpoint import layout
    steps = layout.committed_steps(args.root)
    if not steps:
        print(f"no committed checkpoints under {args.root}")
        return 0
    for step in steps:
        path = layout.step_path(args.root, step)
        manifest = layout.read_manifest(path)
        total = sum(layout.entry_nbytes(e)
                    for e in manifest["arrays"].values())
        print(f"  step {step:>8d}  {len(manifest['arrays']):>4d} arrays  "
              f"{_human(total):>10s}  {path}")
    staging = layout.staging_dirs(args.root)
    if staging:
        print(f"  ({len(staging)} in-flight/stale staging dir(s))")
    return 0


def cmd_diff(args) -> int:
    from mxnet_tpu_torch.checkpoint import layout, reader
    ma = layout.read_manifest(args.a)
    mb = layout.read_manifest(args.b)
    if getattr(args, "compat", False):
        return _diff_compat(ma, mb)
    aa, ab = ma["arrays"], mb["arrays"]
    differs = False
    for name in sorted(set(aa) - set(ab)):
        print(f"- {name}  (only in {args.a})")
        differs = True
    for name in sorted(set(ab) - set(aa)):
        print(f"+ {name}  (only in {args.b})")
        differs = True
    for name in sorted(set(aa) & set(ab)):
        ea, eb = aa[name], ab[name]
        if ea["shape"] != eb["shape"] or ea["dtype"] != eb["dtype"]:
            print(f"! {name}  {tuple(ea['shape'])}/{ea['dtype']} -> "
                  f"{tuple(eb['shape'])}/{eb['dtype']}")
            differs = True
            continue
        # content compare on assembled values — shard layout (device
        # count at save time) is allowed to differ without flagging
        va = reader.read_array(args.a, name, ea, verify=False)
        vb = reader.read_array(args.b, name, eb, verify=False)
        if va.tobytes() != vb.tobytes():
            import numpy as np
            delta = np.max(np.abs(va.astype(np.float64)
                                  - vb.astype(np.float64))) \
                if va.dtype.kind in "fiu" else "?"
            print(f"~ {name}  values differ (max |delta| = {delta})")
            differs = True
    if not differs:
        print("checkpoints are identical (modulo shard layout)")
    return 1 if differs else 0


def _diff_compat(ma, mb) -> int:
    """``diff --compat``: the hot-swap verdict, exit 0/1."""
    import json

    from mxnet_tpu_torch.online.compat import (check_compat,
                                         signature_of_manifest)
    report = check_compat(signature_of_manifest(ma),
                          signature_of_manifest(mb))
    verdict = report.to_dict()
    verdict["stamp_a"] = ma.get("meta", {}).get("compat")
    verdict["stamp_b"] = mb.get("meta", {}).get("compat")
    print(json.dumps(verdict, indent=2, sort_keys=True))
    return 0 if report.compatible else 1


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Inspect / diff sharded checkpoints (PyTorch port)")
    sub = parser.add_subparsers(dest="cmd", required=True)
    p_show = sub.add_parser("show", help="print a checkpoint's manifest")
    p_show.add_argument("ckpt", help="checkpoint step directory")
    p_show.add_argument("--verify", action="store_true",
                        help="read + checksum every shard file")
    p_show.add_argument("--shards", action="store_true",
                        help="print the per-shard file map")
    p_list = sub.add_parser("list", help="list committed steps in a root")
    p_list.add_argument("root", help="checkpoint root directory")
    p_diff = sub.add_parser("diff", help="diff two checkpoints")
    p_diff.add_argument("a")
    p_diff.add_argument("b")
    p_diff.add_argument("--compat", action="store_true",
                        help="print the hot-swap compatibility verdict "
                        "as JSON (key-set/shape/dtype deltas only, no "
                        "value reads); exit 0 compatible / 1 not — the "
                        "same predicate Engine.swap_weights and "
                        "Router.rolling_swap use")
    args = parser.parse_args(argv)
    return {"show": cmd_show, "list": cmd_list, "diff": cmd_diff}[args.cmd](
        args)


if __name__ == "__main__":
    sys.exit(main())
