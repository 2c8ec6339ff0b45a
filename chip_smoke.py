#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``mxnet_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100::

    python3 chip_smoke.py

It imports torch and the port, never jax nor ``mxnet_tpu``, and:

1. prints the card (``nvidia-smi`` name and power limit, torch's name);
2. builds every kernel of ``mxnet_tpu_torch/csrc`` with nvcc (timed);
3. holds each kernel against its plain PyTorch version on the card, at
   the serving path's shapes and at edge cases, with stated tolerances;
4. serves the transformer-LM at full width (6 layers, d_model 512, 8
   heads, 32k vocab, random weights from seed 0) through ``Engine``:
   warmup, then 16 requests; checks every request finished, that two of
   them served again alone give the same streams, that every greedy token
   is the argmax of a teacher-forced forward over the same tokens, that
   the pool drains, and that the kernel launched ``num_layers`` times per
   decode step; prints tokens/s, p50 TTFT and the median decode-step time;
5. times each kernel with CUDA events (median, L2 flushed between
   launches) beside its plain version, a library yardstick and the
   card's bound for the same work;
6. prints one ``{"kernels": [...]}`` line and, last, the ``{"ok": true,
   "device": {...}}`` line.

It exits non-zero, printing no result, when CUDA is not available or the
port is not beside it, and on any failed check.
"""
import json
import os
import subprocess
import sys
import time

# ---------------------------------------------------------------------------
# Card constants (NVIDIA H100 SXM data sheet, dense, at the 700 W limit)
# ---------------------------------------------------------------------------
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12          # float32 outside the tensor cores

TOL = {"float32": 2e-5,         # summation order only
       "bfloat16": 1e-2}        # summation order + one bf16 rounding of out

# serving configuration: bench.py's transformer-LM default at full width
VOCAB, LAYERS, D_MODEL, HEADS = 32000, 6, 512, 8
ENGINE_KW = dict(heads=HEADS, block_size=16, num_blocks=520, max_batch=8,
                 max_prompt_len=512, max_seq_len=1024)
N_REQUESTS, NEW_TOKENS = 16, 64
SAMPLED = {3: 0.8, 7: 1.0, 11: 0.7}      # request index -> temperature
DEVICE = "cuda"


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(*args):
    print(*args, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    check(out, "nvidia-smi printed nothing")
    return out[0]


# ---------------------------------------------------------------------------
# Phase 3: kernel against its plain version
# ---------------------------------------------------------------------------

def decode_inputs(torch, np, *, seed, B, H, hd, BS, nblk, npool, lengths,
                  dtype, q_dtype=None, trash_rows=()):
    """Paged decode operands on the card: random pools, distinct random
    blocks per row, rows in ``trash_rows`` padded as the engine pads them
    (table of trash slots, length 1)."""
    rng = np.random.RandomState(seed)
    q = torch.from_numpy(rng.randn(B, H, hd).astype(np.float32))
    kp = torch.from_numpy(rng.randn(npool, BS, H, hd).astype(np.float32))
    vp = torch.from_numpy(rng.randn(npool, BS, H, hd).astype(np.float32))
    tables = np.zeros((B, nblk), np.int32)
    lens = np.asarray(lengths, np.int32).copy()
    for b in range(B):
        if b in trash_rows:
            lens[b] = 1
            continue
        used = -(-int(lens[b]) // BS)
        tables[b, :used] = rng.choice(np.arange(1, npool), used,
                                      replace=False)
    dev = torch.device(DEVICE)
    return (q.to(dev, q_dtype or dtype), kp.to(dev, dtype),
            vp.to(dev, dtype), torch.from_numpy(tables).to(dev),
            torch.from_numpy(lens).to(dev))


def kernel_cases(torch, np):
    rng = np.random.RandomState(7)
    eng = dict(B=8, H=8, hd=64, BS=16, nblk=64, npool=520)
    ragged = rng.randint(1, 64 * 16 + 1, size=8)
    return [
        ("engine shapes, 8 splits", dict(eng, lengths=ragged),
         torch.float32, None),
        ("split 1", dict(eng, lengths=ragged), torch.float32, 1),
        ("3 splits over 20 columns", dict(eng, nblk=20,
                                          lengths=rng.randint(1, 321, 8)),
         torch.float32, 3),
        ("length-1 trash rows", dict(eng, lengths=ragged,
                                     trash_rows=(5, 6, 7)),
         torch.float32, None),
        ("bf16 q and pool", dict(eng, lengths=ragged), torch.bfloat16, None),
        ("f32 q, bf16 pool", dict(eng, lengths=ragged, q_dtype=torch.float32),
         torch.bfloat16, None),
    ]


def phase_kernel_vs_plain(torch, np, fd):
    errs = {}
    for i, (name, kw, dtype, split_k) in enumerate(kernel_cases(torch, np)):
        args = decode_inputs(torch, np, seed=100 + i, dtype=dtype, **kw)
        out = fd.flash_decode_attention(*args, split_k=split_k)
        ref = fd.flash_decode_attention_ref(*args, split_k=split_k)
        torch.cuda.synchronize()
        check(out.dtype == ref.dtype and out.shape == ref.shape,
              f"{name}: kernel gave {out.dtype}{tuple(out.shape)}, plain "
              f"{ref.dtype}{tuple(ref.shape)}")
        check(bool(torch.isfinite(out.float()).all()),
              f"{name}: non-finite kernel output")
        err = (out.float() - ref.float()).abs().max().item()
        tol = TOL[str(out.dtype).replace("torch.", "")]
        log(f"  kernel vs plain [{name}]: max_abs_err {err:.3e} "
            f"(tol {tol:g})")
        check(err <= tol, f"{name}: kernel disagrees with its plain "
              f"version: max_abs_err {err} > {tol}")
        errs[name] = err
    return errs


# ---------------------------------------------------------------------------
# Phase 4: serving at full width
# ---------------------------------------------------------------------------

def request_set(np):
    rng = np.random.RandomState(1)
    reqs = []
    for i in range(N_REQUESTS):
        plen = int(rng.randint(32, 513))
        prompt = rng.randint(0, VOCAB, size=plen).tolist()
        kw = dict(max_new_tokens=NEW_TOKENS)
        if i in SAMPLED:
            kw.update(temperature=SAMPLED[i], top_k=50, seed=1000 + i)
        reqs.append((prompt, kw))
    return reqs


def teacher_forced_check(torch, eng, prompt, tokens, transformer):
    """Every greedy token must be the argmax, within 1e-5, of a dense
    causal forward over prompt + generated tokens (no cache, no kernel)."""
    seq = torch.tensor([prompt + tokens[:-1]], dtype=torch.int32,
                       device=eng.device)
    with torch.no_grad():
        logits, _, _ = transformer.transformer_lm_prefill(
            eng._params, seq, heads=eng.heads)
    rows = logits[0, len(prompt) - 1:].float()
    chosen = rows[torch.arange(len(tokens), device=rows.device),
                  torch.tensor(tokens, device=rows.device)]
    gap = (rows.max(dim=-1).values - chosen).max().item()
    check(gap <= 1e-5, f"served token is not the teacher-forced argmax "
          f"(logit gap {gap})")
    return gap


def phase_serve(torch, np, fd):
    from mxnet_tpu_torch.models import transformer
    from mxnet_tpu_torch.serve import Engine, EngineConfig
    from mxnet_tpu_torch.serve.scheduler import FINISHED

    t0 = time.perf_counter()
    params = transformer.init_params(VOCAB, LAYERS, D_MODEL, seed=0)
    eng = Engine(params, EngineConfig(**ENGINE_KW), device=DEVICE)
    check(eng.attn_impl == ("flash" if DEVICE == "cuda" else "dense"),
          f"engine resolved {eng.attn_impl}")
    log(f"  engine built in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    infos = eng.warmup()
    torch.cuda.synchronize()
    log(f"  warmup {time.perf_counter() - t0:.2f} s: " + ", ".join(
        f"{i['kind']}@{i['bucket']} {i['ms']:.1f} ms" for i in infos))

    reqs = request_set(np)
    # the main path's run: every count starts at 0 here
    fd.flash_decode_attention.launches = 0
    eng.counters.clear()
    t_start = time.perf_counter()
    ids = [eng.submit(p, **kw) for p, kw in reqs]
    decode_ms = []
    while not eng.sched.idle():
        prefills = eng.counters["prefills"]
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        if eng.counters["prefills"] == prefills:
            decode_ms.append((time.perf_counter() - t0) * 1e3)
    wall = time.perf_counter() - t_start
    launches = fd.flash_decode_attention.launches
    counters = dict(eng.counters)

    done = [eng.requests[i] for i in ids]
    check(all(r.state == FINISHED and len(r.tokens) == NEW_TOKENS
              for r in done), "not every request finished with "
          f"{NEW_TOKENS} tokens: {[(r.state, len(r.tokens)) for r in done]}")
    check(eng.alloc.num_used == 0,
          f"{eng.alloc.num_used} KV blocks still held after drain")
    check(launches > 0, "the flash-decode kernel never launched")
    check(launches == LAYERS * counters["decode_steps"]
          == counters["kernel_launches"],
          f"kernel launches {launches} != {LAYERS} x decode steps "
          f"{counters['decode_steps']} (engine counted "
          f"{counters['kernel_launches']})")
    n_tok = sum(len(r.tokens) for r in done)
    ttft = sorted((r.first_token_t - r.submit_t) * 1e3 for r in done)
    stats = {"requests": len(done), "tokens": n_tok,
             "tokens_per_s": n_tok / wall, "wall_s": wall,
             "p50_ttft_ms": float(np.median(ttft)),
             "decode_steps": counters["decode_steps"],
             "median_decode_step_ms": float(np.median(decode_ms)),
             "prefills": counters["prefills"],
             "preemptions": counters.get("preemptions", 0)}
    log("  serve: " + json.dumps(stats))

    # correctness: greedy tokens against a cache-free dense forward
    greedy = [i for i in range(N_REQUESTS) if i not in SAMPLED]
    for i in (greedy[0], greedy[-1]):
        gap = teacher_forced_check(torch, eng, reqs[i][0], done[i].tokens,
                                   transformer)
        log(f"  teacher-forced check, request {i}: max logit gap {gap:.2e}")
    # replay: one greedy and one sampled request served again, alone
    for i in (greedy[1], sorted(SAMPLED)[0]):
        again = eng.result(eng.submit(reqs[i][0], **reqs[i][1]))
        check(again == done[i].tokens,
              f"request {i} served alone differs from its batched stream")
        log(f"  request {i} served alone: identical stream")
    check(eng.alloc.num_used == 0, "KV blocks leaked by the replays")
    return launches, stats


# ---------------------------------------------------------------------------
# Phase 5: kernel timing
# ---------------------------------------------------------------------------

def time_ms(torch, fn, reps=50):
    """Median per-launch time with CUDA events, L2 flushed before each."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=DEVICE)
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def phase_timing(torch, np, fd):
    import torch.nn.functional as F
    B, H, hd, BS, nblk = 8, 8, 64, 16, 64
    rng = np.random.RandomState(11)
    # decode-time lengths of the served mix: prompts 32-512 + 64 new
    lengths = rng.randint(32 + 1, 512 + NEW_TOKENS + 1, size=B)
    q, kp, vp, tables, lens = decode_inputs(
        torch, np, seed=12, B=B, H=H, hd=hd, BS=BS, nblk=nblk, npool=520,
        lengths=lengths, dtype=torch.float32)

    def library():
        idx = tables.long()
        k = kp[idx].reshape(B, nblk * BS, H, hd).transpose(1, 2)
        v = vp[idx].reshape(B, nblk * BS, H, hd).transpose(1, 2)
        mask = (torch.arange(nblk * BS, device=DEVICE)[None, :]
                < lens[:, None])[:, None, None, :]
        return F.scaled_dot_product_attention(q[:, :, None, :], k, v,
                                              attn_mask=mask)[:, :, 0]

    out = fd.flash_decode_attention(q, kp, vp, tables, lens)
    lib_err = (library() - out).abs().max().item()
    torch.cuda.synchronize()
    check(lib_err <= 1e-4, f"library yardstick disagrees: {lib_err}")
    ms = time_ms(torch, lambda: fd.flash_decode_attention(
        q, kp, vp, tables, lens))
    plain_ms = time_ms(torch, lambda: fd.flash_decode_attention_ref(
        q, kp, vp, tables, lens))
    library_ms = time_ms(torch, library)
    # the least work: each valid K/V position read once, each used table
    # entry, q and lengths read once, the output written once
    esize = kp.element_size()
    valid = int(lengths.sum())
    used_cols = int(sum(-(-int(n) // BS) for n in lengths))
    nbytes = (2 * valid * H * hd * esize + used_cols * 4 + B * 4
              + 2 * B * H * hd * q.element_size())
    flops = 4 * valid * H * hd          # q.k and p.v, multiply + add
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    row = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "bytes": nbytes, "flops": flops, "library_max_abs_err": lib_err}
    log("  timing: " + json.dumps(row))
    return row


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import numpy as np
        from mxnet_tpu_torch import _build
        from mxnet_tpu_torch.serve import flash_decode as fd
    except ImportError as exc:
        print(f"chip_smoke: the port is not importable here ({exc})",
              file=sys.stderr)
        return 3
    # float32 products stay full float32 (the defaults, stated)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    log("[1/6] device")
    smi = card_line()
    log(smi)
    kind = torch.cuda.get_device_name(0)
    log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, {kind}, "
        f"{torch.cuda.device_count()} device(s)")

    log("[2/6] build")
    t0 = time.perf_counter()
    built = _build.build_all()
    log(f"  built {sorted(built)} in {time.perf_counter() - t0:.2f} s")
    for name, info in built.items():
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    log("[3/6] kernels against their plain versions")
    errs = phase_kernel_vs_plain(torch, np, fd)

    log("[4/6] serving transformer-LM 6L d512 8 heads, 32k vocab")
    launches, _ = phase_serve(torch, np, fd)

    log("[5/6] kernel timing")
    timing = phase_timing(torch, np, fd)

    log("[6/6] result")
    kernels = [{
        "name": "flash_decode",
        "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/flash_decode.cu",
        "replaces": "mxnet_tpu/serve/flash_decode.py:60",
        "launches": launches,
        "max_abs_err": max(v for k, v in errs.items() if "bf16" not in k),
        "ms": timing["ms"],
        "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"],
        "bound_by": timing["bound_by"],
        "library_ms": timing["library_ms"],
    }]
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
