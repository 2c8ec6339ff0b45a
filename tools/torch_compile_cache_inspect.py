#!/usr/bin/env python
"""Inspect / maintain the port's persistent program cache.

The port's twin of ``tools/compile_cache_inspect.py``.  Operates on the
``<cache_dir>/programs/`` sidecars written by
``mxnet_tpu_torch.compile_cache.ProgramCache`` (a captured graph cannot
be serialized, so a sidecar is the whole entry: its key fields, label
and capture seconds) and on the kernel builds under ``<cache_dir>/cuda``
— no torch import, so it runs instantly on a login node:

    torch_compile_cache_inspect.py list                 # one line a program
    torch_compile_cache_inspect.py show <digest-prefix> # full key fields
    torch_compile_cache_inspect.py size                 # totals
    torch_compile_cache_inspect.py evict <digest-prefix>
    torch_compile_cache_inspect.py clear

The cache root comes from ``--cache-dir`` or ``MXNET_TPU_CACHE_DIR``.
``size`` also counts the kernel libraries and their build files under
``<dir>/cuda`` (as a byte total, where the JAX tool counts ``<dir>/xla``).
Exit codes: 0 done, 1 no matching entry, 2 no cache dir.
"""
import argparse
import json
import os
import sys
import time

ENV_CACHE_DIR = "MXNET_TPU_CACHE_DIR"


def _progdir(root):
    return os.path.join(root, "programs")


def _entries(root):
    d = _progdir(root)
    if not os.path.isdir(d):
        return []
    out = []
    for name in sorted(os.listdir(d)):
        if not name.endswith(".json"):
            continue
        try:
            with open(os.path.join(d, name)) as f:
                out.append(json.load(f))
        except (OSError, ValueError):
            print(f"warning: unreadable sidecar {name}", file=sys.stderr)
    return out


def _tree_bytes(path):
    """(files, bytes) under ``path``."""
    total = n = 0
    for dirpath, _, files in os.walk(path):
        for f in files:
            try:
                total += os.path.getsize(os.path.join(dirpath, f))
                n += 1
            except OSError:
                pass
    return n, total


def _fmt_bytes(b):
    for unit in ("B", "KiB", "MiB", "GiB"):
        if b < 1024 or unit == "GiB":
            return f"{b:.1f} {unit}" if unit != "B" else f"{b} B"
        b /= 1024


def cmd_list(root, args):
    ents = _entries(root)
    if not ents:
        print(f"no cached programs under {_progdir(root)}")
        return 0
    print(f"{'digest':14s} {'label':28s} {'capture_s':>9s} {'age':>8s} "
          "aval summary")
    now = time.time()
    for e in ents:
        age_h = (now - e.get("created", now)) / 3600
        # the first leaf of the aval string is enough to recognize a program
        avals = e.get("fields", {}).get("avals", "")
        summary = avals.split(";")[0][:40] if avals else ""
        print(f"{e.get('digest', '?')[:12]:14s} "
              f"{e.get('label', '')[:28]:28s} "
              f"{e.get('compile_seconds', 0):9.2f} {age_h:7.1f}h {summary}")
    return 0


def cmd_show(root, args):
    ents = [e for e in _entries(root)
            if e.get("digest", "").startswith(args.digest)]
    if not ents:
        print(f"no entry matching {args.digest!r}", file=sys.stderr)
        return 1
    for e in ents:
        print(json.dumps(e, indent=2, sort_keys=True))
    return 0


def cmd_size(root, args):
    pn, pb = _tree_bytes(_progdir(root))
    cn, cb = _tree_bytes(os.path.join(root, "cuda"))
    print(f"programs: {len(_entries(root))} entries, {_fmt_bytes(pb)}")
    print(f"cuda:     {cn} files, {_fmt_bytes(cb)}")
    print(f"total:    {_fmt_bytes(pb + cb)}")
    return 0


def _remove_sidecars(d, match):
    removed = []
    if os.path.isdir(d):
        for name in sorted(os.listdir(d)):
            if name.endswith(".json") and match(name):
                try:
                    os.remove(os.path.join(d, name))
                    removed.append(name)
                except OSError as e:
                    print(f"could not remove {name}: {e}", file=sys.stderr)
    return removed


def cmd_evict(root, args):
    removed = _remove_sidecars(_progdir(root),
                               lambda name: name.startswith(args.digest))
    if not removed:
        print(f"no entry matching {args.digest!r}", file=sys.stderr)
        return 1
    print(f"evicted {len(removed)} file(s): " + ", ".join(removed))
    return 0


def cmd_clear(root, args):
    removed = _remove_sidecars(_progdir(root), lambda name: True)
    print(f"removed {len(removed)} file(s) from {_progdir(root)}")
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cache-dir", default=os.environ.get(ENV_CACHE_DIR),
                    help=f"cache root (default: ${ENV_CACHE_DIR})")
    sub = ap.add_subparsers(dest="cmd", required=True)
    sub.add_parser("list", help="one line per cached program")
    p = sub.add_parser("show", help="full key fields of matching entries")
    p.add_argument("digest", help="digest prefix")
    sub.add_parser("size", help="entry count and byte totals")
    p = sub.add_parser("evict", help="remove entries by digest prefix")
    p.add_argument("digest", help="digest prefix")
    sub.add_parser("clear", help="remove every cached program")
    args = ap.parse_args(argv)
    if not args.cache_dir:
        print(f"no cache dir: pass --cache-dir or set ${ENV_CACHE_DIR}",
              file=sys.stderr)
        return 2
    return {"list": cmd_list, "show": cmd_show, "size": cmd_size,
            "evict": cmd_evict, "clear": cmd_clear}[args.cmd](
        args.cache_dir, args)


if __name__ == "__main__":
    sys.exit(main())
