#!/usr/bin/env python
"""Per-shape conv forward, dgrad and wgrad probe on the card.

The port's twin of ``tools/conv_probe.py``.  It times every distinct
ResNet-50 conv shape (batch 256, bf16 by default) in these forms:

* ``fwd``: ``F.conv2d``, as the ``Convolution`` op runs it (cuDNN);
* ``dgrad`` and ``wgrad``: cuDNN's own transpose, through
  ``torch.ops.aten.convolution_backward`` with one output mask each
  (what autograd runs under ``MXNET_TPU_CONV_BWD=xla``, the default);
* the candidates that ``MXNET_TPU_CONV_BWD=tuned`` would pick, the very
  code of ``mxnet_tpu_torch/ops/conv_backward.py``: ``dgrad_phase``
  (stride 2), ``wgrad_mm`` and ``dgrad_mm`` (1x1 stride 1).

Timing: CUDA events around each call, the median of ``--reps`` (50)
calls after two warm-ups, the L2 cache flushed (a 256 MiB write) before
each call.  The JAX tool's two-point ``fori_loop`` slope is not copied:
it works around XLA's fusion and a remote chip's round trip, and neither
is here.  Each row (one JSON object a line) gives ms and TFLOP/s (2 x
MACs over the time); rows above the card's published dense peak for the
dtype (989 TFLOP/s bf16, 67 f32) are flagged ``suspect`` and win
nothing.  The last line holds the totals over ResNet-50 (each shape
times its count): forward, cuDNN's dgrad and wgrad, and the backward
with the fastest form of each side.  The card's name and power limit
(``nvidia-smi``) head the table.

``--check`` holds every candidate to cuDNN's gradient on the same data
before it is timed: max |difference| <= 1e-2 x max(1, max |reference|)
in bf16 (the JAX tool's bound), 1e-4 x the same in float32 (no TF32).

Usage: python tools/torch_conv_probe.py [--filter 3x3_s2] [--batch 256]
           [--dtype bfloat16|float32] [--reps 50] [--check]
It needs a card; without one it exits 2 and times nothing.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

# (name, cin, hw_in, cout, k, stride, pad, count_in_resnet50):
# tools/conv_probe.py's table
RESNET50_SHAPES = [
    ("stem_7x7_s2", 3, 224, 64, 7, 2, 3, 1),
    ("s1_1x1_64_64", 64, 56, 64, 1, 1, 0, 1),
    ("s1_3x3_64", 64, 56, 64, 3, 1, 1, 3),
    ("s1_1x1_64_256", 64, 56, 256, 1, 1, 0, 4),
    ("s1_1x1_256_64", 256, 56, 64, 1, 1, 0, 2),
    ("s2_1x1_256_128", 256, 56, 128, 1, 1, 0, 1),
    ("s2_3x3_128_s2", 128, 56, 128, 3, 2, 1, 1),
    ("s2_1x1_sc_s2", 256, 56, 512, 1, 2, 0, 1),
    ("s2_1x1_128_512", 128, 28, 512, 1, 1, 0, 4),
    ("s2_1x1_512_128", 512, 28, 128, 1, 1, 0, 3),
    ("s2_3x3_128", 128, 28, 128, 3, 1, 1, 3),
    ("s3_1x1_512_256", 512, 28, 256, 1, 1, 0, 1),
    ("s3_3x3_256_s2", 256, 28, 256, 3, 2, 1, 1),
    ("s3_1x1_sc_s2", 512, 28, 1024, 1, 2, 0, 1),
    ("s3_1x1_256_1024", 256, 14, 1024, 1, 1, 0, 6),
    ("s3_1x1_1024_256", 1024, 14, 256, 1, 1, 0, 5),
    ("s3_3x3_256", 256, 14, 256, 3, 1, 1, 5),
    ("s4_1x1_1024_512", 1024, 14, 512, 1, 1, 0, 1),
    ("s4_3x3_512_s2", 512, 14, 512, 3, 2, 1, 1),
    ("s4_1x1_sc_s2", 1024, 14, 2048, 1, 2, 0, 1),
    ("s4_1x1_512_2048", 512, 7, 2048, 1, 1, 0, 3),
    ("s4_1x1_2048_512", 2048, 7, 512, 1, 1, 0, 2),
    ("s4_3x3_512", 512, 7, 512, 3, 1, 1, 2),
]

# published dense peaks of one H100 SXM (TFLOP/s): bf16 tensor cores,
# float32 outside them
PEAK_TFLOPS = {"bfloat16": 989.0, "float32": 67.0}
CHECK_RTOL = {"bfloat16": 1e-2, "float32": 1e-4}
FLUSH_BYTES = 256 << 20


def card_line():
    """The card's name and power limit, as ``nvidia-smi`` prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def check_error(torch, got, ref, dtype):
    """``(max |got - ref|, bound)``: the bound is ``CHECK_RTOL[dtype] x
    max(1, max |ref|)``."""
    err = float((got.float() - ref.float()).abs().max())
    bound = CHECK_RTOL[dtype] * max(1.0, float(ref.float().abs().max()))
    return err, bound


def time_ms(torch, fn, reps, flush):
    """Median ms of ``fn()`` over ``reps`` calls, each after an L2 flush,
    by CUDA events; two warm-up calls first."""
    for _ in range(2):
        fn()
    pairs = []
    for _ in range(reps):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def forms(torch, cin, hw, cout, k, s, p, batch, dtype, gen):
    """``(operands, {form: fn})`` of one shape on ``gen``'s device: ``fwd``,
    cuDNN's ``dgrad``/``wgrad``, and the tuned candidates the policy
    would pick for it."""
    import torch.nn.functional as F

    from mxnet_tpu_torch.ops import conv_backward as cb
    dt = getattr(torch, dtype)
    ho = (hw + 2 * p - k) // s + 1

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=gen.device).to(dt)

    x, w, dy = (randn(batch, cin, hw, hw), randn(cout, cin, k, k),
                randn(batch, cout, ho, ho))
    st, pd = (s, s), (p, p)
    out = {"fwd": lambda: F.conv2d(x, w, stride=st, padding=pd),
           "dgrad": lambda: cb._backend_grads(dy, x, w, st, pd,
                                              (True, False))[0],
           "wgrad": lambda: cb._backend_grads(dy, x, w, st, pd,
                                              (False, True))[1]}
    if s > 1:
        out["dgrad_phase"] = lambda: cb._phase_dgrad(dy, w, x.shape, k, s, p)
    if k == 1 and s == 1 and p == 0:
        out["wgrad_mm"] = lambda: cb._wgrad_mm(x, dy, w.shape)
        out["dgrad_mm"] = lambda: cb._dgrad_mm(dy, w, x.shape)
    return (x, w, dy), out


def probe_shape(torch, shape, batch, dtype, reps, check, flush, gen):
    """The rows of one ``RESNET50_SHAPES`` entry: one dict a form, with
    ``ms``, ``tflops``, ``suspect`` and, under ``check``, the candidate's
    error against cuDNN and its bound.  Raises ``AssertionError`` when a
    checked candidate is outside its bound."""
    name, cin, hw, cout, k, s, p, count = shape
    ho = (hw + 2 * p - k) // s + 1
    flops = 2.0 * batch * ho * ho * cout * cin * k * k
    _, fns = forms(torch, cin, hw, cout, k, s, p, batch, dtype, gen)
    rows = []
    for form, fn in fns.items():
        row = {"shape": name, "form": form, "batch": batch, "dtype": dtype,
               "count": count}
        if check and "_" in form:
            err, bound = check_error(torch, fn(), fns[form.split("_")[0]](),
                                     dtype)
            row.update(check_max_err=err, check_bound=bound)
            if not err <= bound:
                raise AssertionError(f"{name}/{form}: max abs error {err} "
                                     f"above {bound}")
        ms = time_ms(torch, fn, reps, flush)
        tflops = flops / (ms * 1e-3) / 1e12
        row.update(ms=ms, tflops=tflops,
                   suspect=tflops > PEAK_TFLOPS[dtype])
        rows.append(row)
    return rows


def totals(rows):
    """ResNet-50 totals (ms, each shape times its count): forward, cuDNN's
    dgrad and wgrad, and the backward with the fastest trusted form of
    each side; also the forms that beat cuDNN, by shape."""
    out = {"fwd": 0.0, "dgrad": 0.0, "wgrad": 0.0, "best_bwd": 0.0}
    wins = {}
    for name in dict.fromkeys(r["shape"] for r in rows):
        mine = [r for r in rows if r["shape"] == name]
        count = mine[0]["count"]
        by = {r["form"]: r for r in mine}
        for base in ("fwd", "dgrad", "wgrad"):
            out[base] += count * by[base]["ms"]
        for side in ("dgrad", "wgrad"):
            best = min((r for r in mine if r["form"].startswith(side)
                        and not r["suspect"]), key=lambda r: r["ms"],
                       default=by[side])
            out["best_bwd"] += count * best["ms"]
            if best["form"] != side:
                wins.setdefault(name, []).append(
                    {"form": best["form"], "ms": best["ms"],
                     "cudnn_ms": by[side]["ms"]})
    return {"totals_ms": out, "wins": wins}


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="per-shape conv fwd/dgrad/wgrad probe on the card")
    ap.add_argument("--filter", default="")
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--dtype", default="bfloat16",
                    choices=sorted(PEAK_TFLOPS))
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--check", action="store_true",
                    help="hold each candidate to cuDNN's gradient first")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("torch_conv_probe: no CUDA device; nothing was timed",
              file=sys.stderr)
        return 2
    # float32 stays float32 (no TF32), as the port trains
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(card_line(), flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "torch": torch.__version__, "batch": args.batch,
                      "dtype": args.dtype, "reps": args.reps}), flush=True)
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for shape in RESNET50_SHAPES:
        if args.filter and args.filter not in shape[0]:
            continue
        for row in probe_shape(torch, shape, args.batch, args.dtype,
                               args.reps, args.check, flush, gen):
            rows.append(row)
            print(json.dumps(row), flush=True)
    print(json.dumps(totals(rows)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
