#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``mxnet_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100::

    python3 chip_smoke.py

It imports torch and the port, never jax nor ``mxnet_tpu``, and:

1. prints the card (``nvidia-smi`` name and power limit, torch's name);
2. builds every kernel of ``mxnet_tpu_torch/csrc`` with nvcc, one process
   per source, all at once (timed);
3. holds each kernel against its plain PyTorch version on the card, at
   the main paths' shapes and at edge cases: flash decode (K5), the
   row softmax (K1) and flash attention forward (K3) and backward (K4)
   within stated tolerances, the fused optimizer update (K2) bitwise
   against the unfused per-parameter update;
4. serves the transformer-LM at full width (6 layers, d_model 512, 8
   heads, 32k vocab, random weights from seed 0) through ``Engine``:
   warmup, then 16 requests; checks every request finished, that two of
   them served again alone give the same streams, that every greedy token
   is the argmax of a teacher-forced forward over the same tokens, that
   the pool drains, and that the kernel launched ``num_layers`` times per
   decode step; prints tokens/s, p50 TTFT and the median decode-step time;
5. trains ResNet-50 at full width (depth 50, 3x224x224, 1000 classes,
   batch 64, f32; parameters drawn with numpy from seed 0 by the default
   initializer rule) through ``ShardedTrainer`` with SGD (lr 0.1,
   momentum 0.9, wd 1e-4), the guard and clip 5.0: one warm-up and 5
   timed steps on one fixed batch, then a step on a batch with a NaN;
   checks finite falling losses, a bitwise no-op on the NaN step, one K1
   launch and one K2 launch per bucket (25) per step, and a bitwise
   fused-vs-unfused update from the same gradients; prints the median
   step time and images/s;
6. times each kernel with CUDA events (median, L2 flushed between
   launches) beside its plain version, a library yardstick and the
   card's bound for the same work; K3 and K4 at the LM's shapes in f32
   and bf16 beside ``F.scaled_dot_product_attention`` (forward, and its
   backward alone);
7. trains the transformer-LM at ``bench.py``'s LM-row settings (6
   layers, d_model 512, 8 heads, 32k vocab, batch 8, seq 2048, loss
   head, Adam lr 1e-3, ``compute_dtype="bfloat16"``; parameters drawn
   with numpy from seed 0) through ``ShardedTrainer``: one warm-up and 5
   timed steps on one fixed batch of numpy tokens (labels are the next
   tokens); checks a finite falling loss, K3 and K4 launched once per
   layer per step, the dense and blockwise attention paths never run,
   one K2 launch per bucket per step, and a bitwise fused-vs-unfused
   Adam update from the same gradients; prints the median step,
   tokens/s, the peak memory and one profiled step by layer;
8. prints one ``{"kernels": [...]}`` line and, last, the ``{"ok": true,
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
BF16_FLOP_PER_S = 989e12        # bf16 on the tensor cores

TOL = {"float32": 2e-5,         # summation order only
       "bfloat16": 1e-2}        # summation order + one bf16 rounding of out
# K1 against its plain version: the online rescale of the running sum
# changes only the last bits of an f32 probability
K1_TOL = {"float32": 1e-6, "bfloat16": 1e-2}

# serving configuration: bench.py's transformer-LM default at full width
VOCAB, LAYERS, D_MODEL, HEADS = 32000, 6, 512, 8
ENGINE_KW = dict(heads=HEADS, block_size=16, num_blocks=520, max_batch=8,
                 max_prompt_len=512, max_seq_len=1024)
N_REQUESTS, NEW_TOKENS = 16, 64
SAMPLED = {3: 0.8, 7: 1.0, 11: 0.7}      # request index -> temperature

# training configuration: __graft_entry__.entry's ResNet-50
DEPTH, CLASSES, IMAGE, BATCH = 50, 1000, (3, 224, 224), 64
TRAIN_OPT = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}
CLIP, TIMED_STEPS, N_BUCKETS = 5.0, 5, 25
K1_SHAPES = [(64, 1000), (8, 10), (3, 16384), (37, 1001)]
K2_LEN = 1003 + 3 * 1048576               # three full buckets' worth + odd

# LM training configuration: bench.py's LM row (bench_lm, batch 8, seq
# 2048, loss head, Adam lr 1e-3, bf16 compute) at full width and depth
LM_BATCH, LM_SEQ = 8, 2048
LM_OPT = {"learning_rate": 1e-3}
# K3/K4 against their plain versions: f32 as tests/test_flash_attention.py
# (forward and lse 2e-5, gradients 2e-4: summation order); bf16 within
# 2e-2 of 1 + |plain| (p and ds are rounded to bf16 inside, and a value on
# a rounding boundary may round either way after an f32 summation-order
# difference: up to two bf16 units in the last place of the result)
K34_TOL = {"fwd": 2e-5, "bwd": 2e-4, "bf16_rel": 2e-2}
# (name, layout, B, H, Lq, Lk, D, causal, external delta)
K34_CASES = [
    ("LM shape", "blhd", 8, 8, 2048, 2048, 64, True, False),
    ("non-causal", "bhld", 2, 4, 512, 512, 64, False, False),
    ("cross Lq 256 Lk 768", "blhd", 2, 4, 256, 768, 64, False, False),
    ("D 128", "blhd", 2, 4, 512, 512, 128, True, False),
    ("D 256", "blhd", 2, 2, 512, 512, 256, True, False),
    ("D 100", "bhld", 1, 3, 256, 256, 100, False, False),
    ("external delta", "bhld", 2, 4, 512, 512, 64, True, True),
]
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


def phase_k1_vs_plain(torch, np, nn_ops):
    """K1 against its plain version, f32 and bf16, at the training shape
    and at edges (few columns, the column limit, a ragged row length);
    the last case has -inf logits, which must give probability 0."""
    errs = {}
    rng = np.random.RandomState(21)
    for shape in K1_SHAPES + [(5, 300)]:
        x = (4.0 * rng.randn(*shape)).astype(np.float32)
        if shape == (5, 300):
            x[:, ::7] = -np.inf
        for dtype in (torch.float32, torch.bfloat16):
            t = torch.from_numpy(x).to(DEVICE, dtype)
            out = nn_ops.softmax_rows(t)
            ref = nn_ops.softmax_rows_ref(t)
            torch.cuda.synchronize()
            dname = str(dtype).replace("torch.", "")
            name = f"{'x'.join(map(str, shape))} {dname}"
            check(out.dtype == dtype and out.shape == t.shape,
                  f"K1 {name}: kernel gave {out.dtype}{tuple(out.shape)}")
            check(bool(torch.isfinite(out.float()).all()),
                  f"K1 {name}: non-finite output")
            err = (out.float() - ref.float()).abs().max().item()
            log(f"  K1 vs plain [{name}]: max_abs_err {err:.3e} "
                f"(tol {K1_TOL[dname]:g})")
            check(err <= K1_TOL[dname], f"K1 {name}: kernel disagrees with "
                  f"its plain version: max_abs_err {err}")
            errs[name] = err
    return errs


# (kind, scalars (lr or lr_t, adamw's second), wd vector, mult, ok, clip)
K2_CASES = [
    ("sgd", False, False, None, None),
    ("sgd_momentum", True, True, True, 0.05),
    ("sgd_momentum", False, False, None, None),
    ("sgd_momentum", True, True, False, 0.05),
    ("adam", False, True, True, 0.05),
    ("adamw", False, False, None, None),
    ("adamw", True, True, True, 0.05),
    ("adamw", True, False, False, None),
]


def k2_operands(torch, np, kind, n, seed):
    """A random bucket: grads, weights, state, and a wd vector made of
    segments (the parameters of the bucket), each with its own wd."""
    rng = np.random.RandomState(seed)
    dev = torch.device(DEVICE)
    g = torch.from_numpy(rng.randn(n).astype(np.float32)).to(dev)
    w = torch.from_numpy(rng.randn(n).astype(np.float32)).to(dev)
    nst = {"sgd": 0, "sgd_momentum": 1, "adam": 2, "adamw": 2}[kind]
    state = [torch.from_numpy(rng.randn(n).astype(np.float32)).to(dev)
             for _ in range(nst)]
    if nst == 2:
        state[1] = state[1].abs()
    cuts = sorted(rng.choice(np.arange(1, n), 6, replace=False).tolist())
    bounds = list(zip([0] + cuts, cuts + [n]))
    seg_wd = [float(v) for v in rng.choice([0.0, 1e-4, 5e-3], len(bounds))]
    return g, w, state, bounds, seg_wd


def k2_unfused(torch, optimizer, kind, g, w, state, bounds, seg_wd, lr, t,
               mult, ok, clip, use_wdvec, base_wd, rescale):
    """The trainer's unfused update over the bucket's segments: per
    segment, ``g * mult``, ``_functional_step`` and ``where(ok, ...)``;
    returns the concatenated ``(new_w, *new_state)``."""
    kw = dict(rescale_grad=rescale, clip_gradient=clip, learning_rate=0.0)
    if kind == "sgd":
        opt = optimizer.SGD(**kw)
    elif kind == "sgd_momentum":
        opt = optimizer.SGD(momentum=0.9, **kw)
    else:
        opt = (optimizer.Adam if kind == "adam" else optimizer.AdamW)(**kw)
    hyper = opt._hyper()
    step = type(opt)._functional_step
    outs = [[] for _ in range(1 + len(state))]
    for (a, b), wdseg in zip(bounds, seg_wd):
        gs, ws = g[a:b], w[a:b]
        ss = [s[a:b] for s in state]
        st = (None if kind == "sgd" else ss[0] if kind == "sgd_momentum"
              else tuple(ss))
        if mult is not None:
            gs = gs * mult
        w2, s2 = step(hyper, ws, gs, st, lr, wdseg if use_wdvec else base_wd,
                      t, None)
        s2 = () if s2 is None else (s2,) if kind == "sgd_momentum" else s2
        if ok is not None:
            w2 = torch.where(ok, w2, ws)
            s2 = tuple(torch.where(ok, x, y) for x, y in zip(s2, ss))
        for lst, v in zip(outs, (w2,) + tuple(s2)):
            lst.append(v)
    return tuple(torch.cat(lst) for lst in outs)


def k2_kernel_args(torch, optimizer, kind, lr, t, use_wdvec, base_wd):
    """The kind's scalar chain, as the trainer forms it."""
    if kind in ("sgd", "sgd_momentum"):
        return (lr,)
    lr_t = optimizer.adam_lr_t(lr, 0.9, 0.999, t)
    if kind == "adam":
        return (lr_t,)
    return (lr_t, lr if use_wdvec else lr * base_wd)


def phase_k2_vs_unfused(torch, np, fu, optimizer):
    """K2 on a bucket whose length is not a multiple of any block, for
    every kind and the wd-vector, clip, mult and ok=False variants:
    bitwise equal to the unfused per-parameter update and to the plain
    version; ok=False leaves w and the state bitwise unchanged."""
    dev = torch.device(DEVICE)
    f32 = dict(dtype=torch.float32, device=dev)
    rescale, base_wd = 1.0 / 64, 1e-4
    for i, (kind, use_wdvec, use_mult, ok_v, clip) in enumerate(K2_CASES):
        g, w, state, bounds, seg_wd = k2_operands(torch, np, kind, K2_LEN,
                                                  seed=300 + i)
        lr = torch.full((), 0.1 if kind.startswith("sgd") else 1e-3, **f32)
        t = torch.full((), 3.0, **f32)
        mult = torch.full((), 0.37, **f32) if use_mult else None
        ok = None if ok_v is None else torch.tensor(ok_v, device=dev)
        wdvec = None
        if use_wdvec:
            wdvec = torch.empty(K2_LEN, **f32)
            for (a, b), v in zip(bounds, seg_wd):
                wdvec[a:b] = v
        want = k2_unfused(torch, optimizer, kind, g, w, state, bounds,
                          seg_wd, lr, t, mult, ok, clip, use_wdvec, base_wd,
                          rescale)
        scalars = k2_kernel_args(torch, optimizer, kind, lr, t, use_wdvec,
                                 base_wd)
        hyper = dict(momentum=0.9, beta1=0.9, beta2=0.999, epsilon=1e-8,
                     wd=0.0 if use_wdvec else base_wd, rescale_grad=rescale,
                     clip_gradient=clip)
        plain = fu.reference_update(g, w, tuple(state), scalars, kind=kind,
                                    mult=mult, ok=ok, wd_vec=wdvec, **hyper)
        before = [x.clone() for x in [w] + state]
        kw_, ks_ = w.clone(), [s.clone() for s in state]
        fu.fused_update(g, kw_, tuple(ks_), scalars, kind=kind, mult=mult,
                        ok=ok, wd_vec=wdvec, **hyper)
        torch.cuda.synchronize()
        name = (f"{kind}{' wd_vec' if use_wdvec else ''}"
                f"{' mult' if use_mult else ''}"
                f"{'' if ok_v is None else ' ok' if ok_v else ' ok=False'}"
                f"{' clip' if clip else ''}")
        for label, ref in (("unfused", want), ("plain", plain)):
            for got, exp in zip([kw_] + ks_, ref):
                check(torch.equal(got.view(torch.int32),
                                  exp.view(torch.int32)),
                      f"K2 {name}: kernel is not bitwise equal to the "
                      f"{label} update (max_abs_err "
                      f"{(got - exp).abs().max().item():.3e})")
        if ok_v is False:
            for got, old in zip([kw_] + ks_, before):
                check(torch.equal(got.view(torch.int32),
                                  old.view(torch.int32)),
                      f"K2 {name}: ok=False changed the bucket")
        log(f"  K2 vs unfused and plain [{name}], n={K2_LEN}: bitwise "
            "equal")
    return 0.0


def attn_operands(torch, np, seed, layout, B, H, Lq, Lk, D, dtype):
    """q, k, v and an output gradient on the card in ``layout``."""
    rng = np.random.RandomState(seed)
    qs = (B, Lq, H, D) if layout == "blhd" else (B, H, Lq, D)
    ks = (B, Lk, H, D) if layout == "blhd" else (B, H, Lk, D)
    return [torch.from_numpy(rng.randn(*s).astype(np.float32)).to(
        DEVICE, dtype) for s in (qs, ks, ks, qs)]


def attn_err(torch, got, want, dtype):
    """f32: max abs error; bf16: max of |got - want| / (1 + |want|)."""
    diff = (got.float() - want.float()).abs()
    if dtype == torch.bfloat16:
        diff = diff / (1.0 + want.float().abs())
    return diff.max().item()


def phase_k34_vs_plain(torch, np, fa):
    """K3 and K4 against their plain versions, f32 and bf16, at the LM's
    shape and at edges: K3's (out, lse) against ``flash_fwd_ref``; K4's
    (dq, dk, dv) against ``flash_bwd_ref`` from the same out and lse."""
    errs = {}
    for i, (name, layout, B, H, Lq, Lk, D, causal, ext) in enumerate(
            K34_CASES):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, do = attn_operands(torch, np, 400 + i, layout, B, H,
                                        Lq, Lk, D, dtype)
            kw = dict(causal=causal, scale=1.0 / D ** 0.5, layout=layout)
            delta = None
            if ext:
                delta = torch.from_numpy(np.random.RandomState(500 + i).randn(
                    B, H, Lq).astype(np.float32)).to(DEVICE)
            out, lse = fa.flash_fwd(q, k, v, **kw)
            ref_out, ref_lse = fa.flash_fwd_ref(q, k, v, **kw)
            grads = fa.flash_bwd(q, k, v, out, lse, do, delta=delta, **kw)
            ref_grads = fa.flash_bwd_ref(q, k, v, out, lse, do, delta=delta,
                                         **kw)
            torch.cuda.synchronize()
            dname = "bf16" if dtype == torch.bfloat16 else "f32"
            label = f"{name} {layout} {dname}"
            for what, got, want in (("out", out, ref_out),
                                    ("dq", grads[0], ref_grads[0]),
                                    ("dk", grads[1], ref_grads[1]),
                                    ("dv", grads[2], ref_grads[2])):
                check(got.dtype == dtype and got.shape == want.shape,
                      f"K3/K4 {label} {what}: {got.dtype}"
                      f"{tuple(got.shape)}")
                check(bool(torch.isfinite(got.float()).all()),
                      f"K3/K4 {label} {what}: non-finite")
            e_fwd = max(attn_err(torch, out, ref_out, dtype),
                        (lse - ref_lse).abs().max().item())
            e_bwd = max(attn_err(torch, g, r, dtype)
                        for g, r in zip(grads, ref_grads))
            tol_f = K34_TOL["fwd" if dname == "f32" else "bf16_rel"]
            tol_b = K34_TOL["bwd" if dname == "f32" else "bf16_rel"]
            log(f"  K3 vs plain [{label}]: {e_fwd:.3e} (tol {tol_f:g}); "
                f"K4 vs plain: {e_bwd:.3e} (tol {tol_b:g})")
            check(e_fwd <= tol_f, f"K3 {label}: kernel disagrees with its "
                  f"plain version: {e_fwd}")
            check(e_bwd <= tol_b, f"K4 {label}: kernel disagrees with its "
                  f"plain version: {e_bwd}")
            errs[label] = (e_fwd, e_bwd)
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
# Phase 5: ResNet-50 training at full width
# ---------------------------------------------------------------------------

def init_numpy(np, sym, shapes, aux_shapes, seed=0):
    """Parameters and aux states drawn with numpy by the default
    initializer rule: Uniform(0.07) weights, gamma 1, beta and bias 0,
    moving mean 0, moving var 1."""
    rng = np.random.RandomState(seed)
    args = {}
    for n, s in zip(sym.list_arguments(), shapes):
        if n in ("data", "softmax_label"):
            continue
        if n.endswith("weight"):
            args[n] = rng.uniform(-0.07, 0.07, s).astype(np.float32)
        elif n.endswith("gamma"):
            args[n] = np.ones(s, np.float32)
        else:
            args[n] = np.zeros(s, np.float32)
    aux = {n: (np.ones if n.endswith("var") else np.zeros)(s, np.float32)
           for n, s in zip(sym.list_auxiliary_states(), aux_shapes)}
    return args, aux


def cross_entropy(torch, prob, label):
    picked = prob[torch.arange(prob.shape[0], device=prob.device),
                  label.long()]
    return float(-torch.log(picked).mean())


def bits(torch, t):
    return t.detach().contiguous().view(torch.int32)


def phase_train(torch, np, nn_ops, fu):
    from mxnet_tpu_torch import models
    from mxnet_tpu_torch.parallel import ShardedTrainer

    t0 = time.perf_counter()
    sym = models.get_symbol("resnet", num_classes=CLASSES, depth=DEPTH)
    shapes = dict(data=(BATCH,) + IMAGE, softmax_label=(BATCH,))
    arg_shapes, _, aux_shapes = sym.infer_shape(**shapes)
    args, aux = init_numpy(np, sym, arg_shapes, aux_shapes, seed=0)
    n_params = sum(int(v.size) for v in args.values())

    def trainer(fused, arg_params, aux_params):
        tr = ShardedTrainer(sym, optimizer="sgd",
                            optimizer_params=dict(TRAIN_OPT), guard=True,
                            clip_global_norm=CLIP, fused_update=fused,
                            device=DEVICE)
        return tr.bind({"data": shapes["data"]},
                       {"softmax_label": shapes["softmax_label"]},
                       arg_params=arg_params, aux_params=aux_params)

    tr = trainer(True, args, aux)
    check(tr._fused and tr._flat_wd is not None,
          "the trainer did not take the fused path with a wd vector")
    n_buckets = len(tr._fused_plan.buckets)
    check(n_buckets == N_BUCKETS or DEVICE != "cuda",
          f"{n_buckets} buckets, expected {N_BUCKETS}")
    rng = np.random.RandomState(2)
    batch = tr.place_batch({
        "data": rng.rand(*shapes["data"]).astype(np.float32),
        "softmax_label": rng.randint(0, CLASSES, BATCH).astype(np.float32)})
    label = batch["softmax_label"]
    torch.cuda.synchronize()
    log(f"  ResNet-{DEPTH}: {n_params} parameters in {n_buckets} buckets, "
        f"bound in {time.perf_counter() - t0:.2f} s")

    # the main path's run: every count starts at 0 here
    nn_ops.softmax_rows.launches = 0
    fu.fused_update.launches = 0
    losses, step_ms = [], []
    torch.cuda.reset_peak_memory_stats()
    for i in range(1 + TIMED_STEPS):
        t0 = time.perf_counter()
        heads = tr.step(batch)
        torch.cuda.synchronize()
        if i:
            step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(cross_entropy(torch, heads[0], label))
    check(int(tr._guard_state["skipped"]) == 0, "a clean step was skipped")
    # one step on a batch with a NaN: a bitwise no-op on the whole state
    bad = dict(batch)
    bad["data"] = batch["data"].clone()
    bad["data"][0, 0, 0, 0] = float("nan")
    before = [bits(torch, t).clone() for t in
              [tr._flat_w] + tr._flat_state + list(tr._aux.values())]
    heads = tr.step(bad)
    torch.cuda.synchronize()
    after = [bits(torch, t) for t in
             [tr._flat_w] + tr._flat_state + list(tr._aux.values())]
    k1 = nn_ops.softmax_rows.launches
    k2 = fu.fused_update.launches
    steps = 2 + TIMED_STEPS
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30

    log(f"  losses {['%.4f' % v for v in losses]}")
    check(all(np.isfinite(losses)), f"non-finite loss: {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    check(int(tr._guard_state["skipped"]) == 1,
          "the NaN step was not skipped")
    check(all(torch.equal(a, b) for a, b in zip(before, after)),
          "the NaN step changed parameters, optimizer state or moving "
          "statistics")
    check(k1 == steps, f"softmax_rows launched {k1} times in {steps} steps")
    check(k2 == n_buckets * steps, f"fused_update launched {k2} times in "
          f"{steps} steps of {n_buckets} buckets")
    log(f"  NaN step: skipped, state bitwise unchanged; launches K1 {k1}, "
        f"K2 {k2} over {steps} steps")
    profile = profile_step(torch, tr, batch)

    # fused vs unfused from the same gradients, bitwise: cuDNN's backward
    # is not deterministic, so both updates consume one set of gradients
    arg_now, aux_now = tr.get_params()
    ref = trainer(False, arg_now, aux_now)
    with torch.no_grad():
        for n, st in tr.opt_state_by_param().items():
            ref._opt_state[n].copy_(st[0])
    ref._num_update = tr._num_update
    _, grads, auxu = tr._forward_backward(batch)
    for t in (tr, ref):
        t._num_update += 1
        t._apply_update(grads, auxu)
    torch.cuda.synchronize()
    fused_state = tr.opt_state_by_param()
    for n in tr._param_names:
        check(torch.equal(bits(torch, tr._params[n]),
                          bits(torch, ref._params[n])),
              f"fused and unfused updates differ on {n}")
        check(torch.equal(bits(torch, fused_state[n][0]),
                          bits(torch, ref._opt_state[n])),
              f"fused and unfused momentum differ on {n}")
    for n in tr._aux:
        check(torch.equal(bits(torch, tr._aux[n]), bits(torch, ref._aux[n])),
              f"fused and unfused aux states differ on {n}")
    log("  fused vs unfused update from the same gradients: bitwise equal")

    med = float(np.median(step_ms))
    stats = {"params": n_params, "buckets": n_buckets, "batch": BATCH,
             "median_step_ms": med, "step_ms": step_ms,
             "images_per_s": BATCH / med * 1e3,
             "loss_first": losses[0], "loss_last": losses[-1],
             "peak_gib": peak_gb, "profile": profile}
    log("  train: " + json.dumps(stats))
    return {"softmax_rows": k1, "fused_update": k2}, stats


# kernel-name fragments -> the layer whose work the kernel does
_KERNEL_GROUPS = (
    ("K1 softmax_rows", ("softmax_rows_kernel",)),
    ("K2 fused_update", ("fused_update_kernel",)),
    ("convolution/matmul (cuDNN, cuBLAS)",
     ("conv", "xmma", "cudnn", "implicit", "gemm", "wgrad", "dgrad",
      "fprop", "winograd", "cutlass", "fft")),
    ("pooling", ("pool",)),
    ("reductions (BatchNorm statistics, grad norm)", ("reduce",)),
    ("gradient bucket cat", ("CatArray", "cat_")),
    ("elementwise (BatchNorm, ReLU, add, guard)", ("elementwise",)),
)


# kernel-name fragments of the LM step -> the layer whose work it does
_LM_KERNEL_GROUPS = (
    ("K3 flash attention forward", ("flash_fwd_",)),
    ("K4 flash attention backward", ("flash_bwd_",)),
    ("K2 fused update", ("fused_update_kernel",)),
    ("matmul (cuBLAS)", ("gemm", "xmma", "cutlass", "sm90_", "cublas",
                         "nvjet")),
    ("gradient bucket cat", ("CatArray", "cat_")),
    ("reductions (LayerNorm, logsumexp, softmax, grad norm)",
     ("reduce", "softmax", "Softmax", "SoftMax", "norm")),
    ("embedding gather/scatter", ("index", "embedding", "gather",
                                  "scatter", "sort", "radix")),
    ("elementwise (casts, LayerNorm, ReLU, residual, loss head)",
     ("elementwise",)),
)
# CPU ops whose kernels are the loss head's (inclusive device time)
_LOSS_HEAD_OPS = ("aten::logsumexp", "aten::gather",
                  "_SoftmaxOutputFnBackward")


def profile_step(torch, tr, batch, groups_spec=_KERNEL_GROUPS,
                 loss_ops=()):
    """One more training step under ``torch.profiler``: device time by
    layer, the busiest kernels, and the share of the step's wall time in
    which the card ran no kernel.  ``loss_ops`` names CPU ops whose
    inclusive device time is reported as ``loss_head_ms`` (those kernels
    also sit in the groups)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tr.step(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    groups, kernels, other, loss_us = {}, [], [], {}
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            for op in loss_ops:
                # the autograd wrapper event and the node share a name:
                # keep the largest, so nothing counts twice
                if op in ev.key:
                    loss_us[op] = max(loss_us.get(op, 0.0),
                                      ev.device_time_total)
            continue
        us = ev.self_device_time_total
        kernels.append((us, ev.key, ev.count))
        group = next((g for g, frags in groups_spec
                      if any(f in ev.key for f in frags)), "other")
        groups[group] = groups.get(group, 0.0) + us / 1e3
        if group == "other":
            other.append((us, ev.key))
    busy_ms = sum(groups.values())
    kernels.sort(reverse=True)
    out = {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "idle_share": (1.0 - busy_ms / wall_ms) if busy_ms else None,
           "by_layer_ms": dict(sorted(groups.items(),
                                      key=lambda kv: -kv[1])),
           "top_kernels": [{"name": k[:80], "ms": us / 1e3, "count": c}
                           for us, k, c in kernels[:10]],
           "top_other": [{"name": k[:80], "ms": us / 1e3}
                         for us, k in sorted(other, reverse=True)[:4]]}
    if loss_ops:
        out["loss_head_ms"] = sum(loss_us.values()) / 1e3
        out["loss_head_ops_ms"] = {k: v / 1e3 for k, v in loss_us.items()}
    log("  profiled step: " + json.dumps(out))
    return out


# ---------------------------------------------------------------------------
# Phase 6: kernel timing
# ---------------------------------------------------------------------------

def time_ms(torch, fn, reps=50, hide_host=True):
    """Median per-call device time with CUDA events, L2 flushed before
    each call.  With ``hide_host`` a sleep kernel (about 0.5 ms) runs
    between the flush and the start event, so the host has enqueued all
    of ``fn``'s launches before the card reaches them: the events then
    time the device work alone, not the Python launch overhead.  Without
    it the time is per call as a caller sees it (host gaps included)."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=DEVICE)
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        if hide_host:
            torch.cuda._sleep(1 << 20)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def time_row(torch, kernel, plain, library):
    """Device times of the kernel, its plain version and the library
    call, plus the kernel's per-call time with host overhead."""
    return {"ms": time_ms(torch, kernel), "plain_ms": time_ms(torch, plain),
            "library_ms": time_ms(torch, library),
            "call_ms": time_ms(torch, kernel, hide_host=False)}


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
    times = time_row(
        torch, lambda: fd.flash_decode_attention(q, kp, vp, tables, lens),
        lambda: fd.flash_decode_attention_ref(q, kp, vp, tables, lens),
        library)
    # the least work: each valid K/V position read once, each used table
    # entry, q and lengths read once, the output written once
    esize = kp.element_size()
    valid = int(lengths.sum())
    used_cols = int(sum(-(-int(n) // BS) for n in lengths))
    nbytes = (2 * valid * H * hd * esize + used_cols * 4 + B * 4
              + 2 * B * H * hd * q.element_size())
    flops = 4 * valid * H * hd          # q.k and p.v, multiply + add
    row = dict(bound(nbytes, flops), **times, library_max_abs_err=lib_err)
    log("  timing K5: " + json.dumps(row))
    return row


def bound(nbytes, flops, flop_rate=F32_FLOP_PER_S):
    """The least time the card could take: bytes over the memory rate or
    operations over the rate for their type (f32 by default), whichever
    is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_rate * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops}


def phase_timing_k1(torch, np, nn_ops):
    """K1 at the training shape [64, 1000] f32."""
    n, c = BATCH, CLASSES
    x = torch.from_numpy(np.random.RandomState(13).randn(n, c).astype(
        np.float32)).to(DEVICE)
    lib_err = (torch.softmax(x, -1) - nn_ops.softmax_rows(x)).abs().max()
    check(lib_err.item() <= K1_TOL["float32"],
          f"library yardstick disagrees: {lib_err.item()}")
    # each element read once and written once; max, subtract, exp, add and
    # divide per element
    row = dict(bound(2 * n * c * 4, 5 * n * c),
               **time_row(torch, lambda: nn_ops.softmax_rows(x),
                          lambda: nn_ops.softmax_rows_ref(x),
                          lambda: torch.softmax(x, -1)),
               library_max_abs_err=lib_err.item())
    log("  timing K1: " + json.dumps(row))
    return row


def phase_timing_k2(torch, np, fu):
    """K2 over one full bucket (1,048,576 elements), sgd with momentum, a
    wd vector, mult and ok: the configuration the training phase runs."""
    n = 1 << 20
    rng = np.random.RandomState(14)
    dev = torch.device(DEVICE)
    f32 = dict(dtype=torch.float32, device=dev)
    g = torch.from_numpy(rng.randn(n).astype(np.float32)).to(dev)
    w = torch.from_numpy(rng.randn(n).astype(np.float32)).to(dev)
    mom = torch.zeros(n, **f32)
    wdvec = torch.from_numpy(rng.choice([0.0, 1e-4], n).astype(
        np.float32)).to(dev)
    lr = torch.full((), 0.1, **f32)
    mult = torch.full((), 0.5, **f32)
    ok = torch.tensor(True, device=dev)
    hyper = dict(momentum=0.9, rescale_grad=1.0 / BATCH)

    def kernel():
        fu.fused_update(g, w, (mom,), (lr,), kind="sgd_momentum",
                        mult=mult, ok=ok, wd_vec=wdvec, **hyper)

    def plain():
        fu.reference_update(g, w, (mom,), (lr,), kind="sgd_momentum",
                            mult=mult, ok=ok, wd_vec=wdvec, **hyper)

    # torch's own fused SGD over the same flat bucket (its formula: a
    # scalar weight decay, no mult or ok): a yardstick, never used by the
    # port
    p = torch.nn.Parameter(w.clone())
    p.grad = g.clone()
    sgd = torch.optim.SGD([p], lr=0.1, momentum=0.9, weight_decay=1e-4,
                          fused=True)
    sgd.step()
    # g, w, mom and the wd vector read once; w and mom written once; about
    # ten operations per element
    row = dict(bound(6 * 4 * n, 10 * n),
               **time_row(torch, kernel, plain, sgd.step))
    log("  timing K2: " + json.dumps(row))
    return row


def phase_timing_k34(torch, np, fa):
    """K3 and K4 at the LM's shape (B 8, H 8, L 2048, D 64, causal,
    blhd) in f32 and bf16, beside their plain versions and
    ``F.scaled_dot_product_attention`` on the same inputs in [B, H, L, D]:
    its forward for K3, its backward alone (from a retained graph) for
    K4."""
    import torch.nn.functional as F
    B, H, L, D = LM_BATCH, HEADS, LM_SEQ, D_MODEL // HEADS
    kw = dict(causal=True, scale=1.0 / D ** 0.5, layout="blhd")
    rows = {}
    for dtype, rate, dname in ((torch.float32, F32_FLOP_PER_S, "f32"),
                               (torch.bfloat16, BF16_FLOP_PER_S, "bf16")):
        q, k, v, do = attn_operands(torch, np, 600, "blhd", B, H, L, L, D,
                                    dtype)
        out, lse = fa.flash_fwd(q, k, v, **kw)
        qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                      for t in (q, k, v))
        dot = do.transpose(1, 2).contiguous()
        lib_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
        # the yardstick computes the same function (its own rounding)
        lib_err = attn_err(torch, lib_out.transpose(1, 2), out,
                           torch.bfloat16)
        torch.cuda.synchronize()
        check(lib_err <= K34_TOL["bf16_rel"],
              f"SDPA yardstick disagrees with K3 ({dname}): {lib_err}")

        def lib_fwd():
            with torch.no_grad():
                F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)

        def lib_bwd():
            torch.autograd.grad(lib_out, (qt, kt, vt), dot,
                                retain_graph=True)

        esize = q.element_size()
        n = B * H * L * D
        # causal: half the L x L score matrix
        mm = 2 * B * H * D * L * L // 2
        # K3: q, k, v read and out written once, lse written; two products
        fwd = dict(bound(4 * n * esize + B * H * L * 4, 2 * mm, rate),
                   **time_row(
                       torch, lambda: fa.flash_fwd(q, k, v, **kw),
                       lambda: fa.flash_fwd_ref(q, k, v, **kw), lib_fwd),
                   library_max_rel_err=lib_err)
        # K4: q, k, v, out, do and lse read, dq, dk, dv written once;
        # five products (s, do v^T, ds k, ds^T q, p^T do)
        bwd = dict(bound(8 * n * esize + B * H * L * 4, 5 * mm, rate),
                   **time_row(
                       torch, lambda: fa.flash_bwd(q, k, v, out, lse, do,
                                                   **kw),
                       lambda: fa.flash_bwd_ref(q, k, v, out, lse, do,
                                                **kw),
                       lib_bwd))
        rows[dname] = {"flash_attn_fwd": fwd, "flash_attn_bwd": bwd}
        log(f"  timing K3 {dname}: " + json.dumps(fwd))
        log(f"  timing K4 {dname}: " + json.dumps(bwd))
    return rows


# ---------------------------------------------------------------------------
# Phase 7: transformer-LM training at full width and depth
# ---------------------------------------------------------------------------

def lm_batch(np, seed=0):
    """One fixed batch of numpy tokens; the labels are the next tokens."""
    toks = np.random.RandomState(seed).randint(0, VOCAB,
                                               (LM_BATCH, LM_SEQ + 1))
    return {"data": toks[:, :-1].astype(np.float32),
            "softmax_label": toks[:, 1:].astype(np.float32)}


def phase_train_lm(torch, np, fa, fu):
    from mxnet_tpu_torch import models
    from mxnet_tpu_torch.parallel import ShardedTrainer
    from mxnet_tpu_torch.parallel import ring_attention as ra

    t0 = time.perf_counter()
    sym = models.get_symbol("transformer-lm", vocab_size=VOCAB,
                            num_layers=LAYERS, d_model=D_MODEL, heads=HEADS,
                            batch_size=LM_BATCH, seq_len=LM_SEQ,
                            loss_head=True)
    shapes = dict(data=(LM_BATCH, LM_SEQ), softmax_label=(LM_BATCH, LM_SEQ))
    arg_shapes, _, aux_shapes = sym.infer_shape(**shapes)
    args, aux = init_numpy(np, sym, arg_shapes, aux_shapes, seed=0)
    n_params = sum(int(v.size) for v in args.values())

    def trainer(fused, arg_params):
        tr = ShardedTrainer(sym, optimizer="adam",
                            optimizer_params=dict(LM_OPT),
                            compute_dtype="bfloat16", fused_update=fused,
                            device=DEVICE)
        return tr.bind({"data": shapes["data"]},
                       {"softmax_label": shapes["softmax_label"]},
                       arg_params=arg_params)

    tr = trainer(True, args)
    check(tr._fused and tr._fused_kind == "adam",
          "the LM trainer did not take the fused Adam path")
    n_buckets = len(tr._fused_plan.buckets)
    batch = tr.place_batch(lm_batch(np))
    torch.cuda.synchronize()
    log(f"  LM: {n_params} parameters in {n_buckets} buckets, bound in "
        f"{time.perf_counter() - t0:.2f} s")

    # the main path's run: every count starts at 0 here
    fa.flash_fwd.launches = 0
    fa.flash_bwd.launches = 0
    fu.fused_update.launches = 0
    ra.local_attention.dense_calls = 0
    ra.blockwise_attention.calls = 0
    losses, step_ms = [], []
    torch.cuda.reset_peak_memory_stats()
    for i in range(1 + TIMED_STEPS):
        t0 = time.perf_counter()
        heads = tr.step(batch)
        torch.cuda.synchronize()
        if i:
            step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(heads[0].float().mean()))
    k3, k4 = fa.flash_fwd.launches, fa.flash_bwd.launches
    k2 = fu.fused_update.launches
    dense, blockwise = ra.local_attention.dense_calls, \
        ra.blockwise_attention.calls
    steps = 1 + TIMED_STEPS
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30

    log(f"  losses {['%.4f' % v for v in losses]}")
    check(heads[0].shape == (LM_BATCH * LM_SEQ,)
          and heads[0].dtype == torch.float32,
          f"loss head gave {heads[0].dtype}{tuple(heads[0].shape)}")
    check(all(np.isfinite(losses)), f"non-finite loss: {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    check(k3 == LAYERS * steps, f"K3 launched {k3} times in {steps} steps "
          f"of {LAYERS} layers")
    check(k4 == LAYERS * steps, f"K4 launched {k4} times in {steps} steps "
          f"of {LAYERS} layers")
    check(dense == 0 and blockwise == 0, f"attention left the flash path: "
          f"dense {dense}, blockwise {blockwise} calls")
    check(k2 == n_buckets * steps, f"fused_update launched {k2} times in "
          f"{steps} steps of {n_buckets} buckets")
    log(f"  launches over {steps} steps: K3 {k3}, K4 {k4}, K2 {k2}; dense "
        f"and blockwise attention 0")
    profile = profile_step(torch, tr, batch, _LM_KERNEL_GROUPS,
                           _LOSS_HEAD_OPS)

    # fused vs unfused Adam from the same gradients, bitwise (the
    # embedding's scatter-add on the card need not be deterministic, so
    # both updates consume one set of gradients)
    arg_now, _ = tr.get_params()
    ref = trainer(False, arg_now)
    with torch.no_grad():
        for n, st in tr.opt_state_by_param().items():
            for dst, src in zip(ref._opt_state[n], st):
                dst.copy_(src)
    ref._num_update = tr._num_update
    _, grads, auxu = tr._forward_backward(batch)
    for t in (tr, ref):
        t._num_update += 1
        t._apply_update(grads, auxu)
    torch.cuda.synchronize()
    fused_state = tr.opt_state_by_param()
    for n in tr._param_names:
        check(torch.equal(bits(torch, tr._params[n]),
                          bits(torch, ref._params[n])),
              f"fused and unfused Adam updates differ on {n}")
        for a, b in zip(fused_state[n], ref._opt_state[n]):
            check(torch.equal(bits(torch, a), bits(torch, b)),
                  f"fused and unfused Adam moments differ on {n}")
    log("  fused vs unfused Adam update from the same gradients: bitwise "
        "equal")

    med = float(np.median(step_ms))
    stats = {"params": n_params, "buckets": n_buckets, "batch": LM_BATCH,
             "seq": LM_SEQ, "median_step_ms": med, "step_ms": step_ms,
             "tokens_per_s": LM_BATCH * LM_SEQ / med * 1e3,
             "loss_first": losses[0], "loss_last": losses[-1],
             "peak_gib": peak_gb, "profile": profile}
    log("  train LM: " + json.dumps(stats))
    return {"flash_attn_fwd": k3, "flash_attn_bwd": k4,
            "fused_update": k2}, stats


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import numpy as np
        from mxnet_tpu_torch import _build, optimizer
        from mxnet_tpu_torch.ops import fused_update as fu
        from mxnet_tpu_torch.ops import nn_ops
        from mxnet_tpu_torch.parallel import flash_attention as fa
        from mxnet_tpu_torch.serve import flash_decode as fd
    except ImportError as exc:
        print(f"chip_smoke: the port is not importable here ({exc})",
              file=sys.stderr)
        return 3
    # float32 products stay full float32 (the defaults, stated)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    log("[1/8] device")
    smi = card_line()
    log(smi)
    kind = torch.cuda.get_device_name(0)
    log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, {kind}, "
        f"{torch.cuda.device_count()} device(s)")

    log("[2/8] build")
    t0 = time.perf_counter()
    built = _build.build_all()
    log(f"  built {sorted(built)} in {time.perf_counter() - t0:.2f} s")
    for name, info in built.items():
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    log("[3/8] kernels against their plain versions")
    errs = phase_kernel_vs_plain(torch, np, fd)
    k1_errs = phase_k1_vs_plain(torch, np, nn_ops)
    k2_err = phase_k2_vs_unfused(torch, np, fu, optimizer)
    k34_errs = phase_k34_vs_plain(torch, np, fa)

    log("[4/8] serving transformer-LM 6L d512 8 heads, 32k vocab")
    k5_launches, _ = phase_serve(torch, np, fd)

    log(f"[5/8] training ResNet-{DEPTH}, batch {BATCH}, "
        f"{'x'.join(map(str, IMAGE))}, {CLASSES} classes, f32")
    train_launches, _ = phase_train(torch, np, nn_ops, fu)

    log("[6/8] kernel timing")
    timing = {"flash_decode": phase_timing(torch, np, fd),
              "softmax_rows": phase_timing_k1(torch, np, nn_ops),
              "fused_update": phase_timing_k2(torch, np, fu)}
    k34_timing = phase_timing_k34(torch, np, fa)
    # the LM's main path runs K3/K4 in bf16: those times go to the line
    timing.update(k34_timing["bf16"])

    log(f"[7/8] training transformer-LM {LAYERS}L d{D_MODEL} {HEADS} heads, "
        f"{VOCAB} vocab, batch {LM_BATCH}, seq {LM_SEQ}, bf16 compute, "
        "Adam")
    lm_launches, _ = phase_train_lm(torch, np, fa, fu)

    log("[8/8] result")
    f32_errs = [v for k, v in k34_errs.items() if k.endswith("f32")]
    rows = [
        ("flash_decode", "mxnet_tpu_torch/csrc/flash_decode.cu",
         "mxnet_tpu/serve/flash_decode.py:60", k5_launches,
         max(v for k, v in errs.items() if "bf16" not in k)),
        ("softmax_rows", "mxnet_tpu_torch/csrc/softmax_rows.cu",
         "mxnet_tpu/ops/nn_ops.py:847", train_launches["softmax_rows"],
         max(v for k, v in k1_errs.items() if "float32" in k)),
        # K2 runs on both training paths: ResNet-50 (SGD) and the LM (Adam)
        ("fused_update", "mxnet_tpu_torch/csrc/fused_update.cu",
         "mxnet_tpu/ops/fused_update.py:216",
         train_launches["fused_update"] + lm_launches["fused_update"],
         k2_err),
        ("flash_attn_fwd", "mxnet_tpu_torch/csrc/flash_attn_fwd.cu",
         "mxnet_tpu/parallel/flash_attention.py:77",
         lm_launches["flash_attn_fwd"], max(e[0] for e in f32_errs)),
        ("flash_attn_bwd", "mxnet_tpu_torch/csrc/flash_attn_bwd.cu",
         "mxnet_tpu/parallel/flash_attention.py:264",
         lm_launches["flash_attn_bwd"], max(e[1] for e in f32_errs)),
    ]
    kernels = [{
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches, "max_abs_err": err,
        "ms": timing[name]["ms"], "plain_ms": timing[name]["plain_ms"],
        "bound_ms": timing[name]["bound_ms"],
        "bound_by": timing[name]["bound_by"],
        "library_ms": timing[name]["library_ms"],
    } for name, source, replaces, launches, err in rows]
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
