"""Fused optimizer update of the PyTorch port (mxnet_tpu_torch/ops/
fused_update.py, kernel K2) on the CPU.

* K2's plain version against the JAX package's ``fu.reference_update``
  (not ``pallas_update``, which fails on the reference tree: ROADMAP
  Queue 3) for every kind and the wd_vec / mult / ok / clip variants,
  bitwise (the port's square root is correctly rounded on the CPU too,
  ``optimizer.sqrt_rn``), and ``ok=False`` bitwise unchanged;
* the per-parameter entry ``fused_update_params`` (the hopper form's
  route) over tensors of odd sizes, at flat offsets off the 16-byte grid,
  bitwise equal to the JAX reference over the concatenation and to the
  bucket route; its chunk plan and its operand checks;
* ``build_plan`` / ``FusedPlan`` layouts equal the JAX package's;
* the port's fused trainer, in both routes, is a BITWISE twin of its
  unfused trainer: parameters, optimizer state and heads after every
  step, for every kind, with the guard and a poisoned step (the JAX
  package's ``tests/test_fused_update.py`` contract).
"""
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu.models import resnet as jax_resnet
from mxnet_tpu.ops import fused_update as jfu

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch import symbol as S
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import fused_update as tfu
from mxnet_tpu_torch.parallel import ShardedTrainer

HYPER = dict(momentum=0.9, beta1=0.9, beta2=0.999, epsilon=1e-8,
             rescale_grad=1.0 / 16)

# (kind, scalars, use wd_vec, use mult, ok, clip)
CASES = [
    ("sgd", (0.1,), False, False, None, None),
    ("sgd", (0.1,), True, True, True, 0.05),
    ("sgd_momentum", (0.1,), False, False, None, None),
    ("sgd_momentum", (0.1,), True, True, True, None),
    ("sgd_momentum", (0.1,), True, False, None, 0.05),
    ("sgd_momentum", (0.1,), True, True, False, 0.05),
    ("adam", (1e-3,), False, False, None, None),
    ("adam", (1e-3,), False, True, True, 0.05),
    ("adamw", (1e-3, 1e-5), False, False, None, None),
    ("adamw", (1e-3, 1e-3), True, True, True, 0.05),
    ("adamw", (1e-3, 1e-3), True, True, False, None),
]
IDS = [f"{k}{'_wdvec' if v else ''}{'_mult' if m else ''}"
       f"{'' if ok is None else '_ok' if ok else '_notok'}"
       f"{'_clip' if c else ''}" for k, _, v, m, ok, c in CASES]


def _operands(kind, n=1003, seed=0):
    rng = np.random.RandomState(seed)
    g = rng.randn(n).astype(np.float32)
    w = rng.randn(n).astype(np.float32)
    state = [rng.randn(n).astype(np.float32) for _ in range(
        tfu._N_STATE[kind])]
    if kind in ("adam", "adamw"):
        state[1] = np.abs(state[1])           # a second moment
    wdv = rng.choice([0.0, 1e-4, 5e-3], n).astype(np.float32)
    return g, w, state, wdv


@pytest.mark.parametrize("kind,scalars,use_wdvec,use_mult,ok,clip", CASES,
                         ids=IDS)
def test_plain_version_matches_jax_reference(kind, scalars, use_wdvec,
                                             use_mult, ok, clip):
    g, w, state, wdv = _operands(kind)
    kw = dict(HYPER, kind=kind, wd=1e-4, clip_gradient=clip)
    mult = np.float32(0.37) if use_mult else None
    want = jfu.reference_update(
        jnp.asarray(g), jnp.asarray(w), tuple(jnp.asarray(s) for s in state),
        tuple(jnp.float32(s) for s in scalars),
        mult=None if mult is None else jnp.float32(mult),
        ok=None if ok is None else jnp.asarray(ok),
        wd_vec=jnp.asarray(wdv) if use_wdvec else None, **kw)
    t = torch.from_numpy
    ts = lambda v: torch.tensor(v, dtype=torch.float32)   # noqa: E731
    tw, tstate = t(w.copy()), tuple(t(s.copy()) for s in state)
    plain = tfu.reference_update(
        t(g), tw, tstate, tuple(ts(s) for s in scalars),
        mult=None if mult is None else ts(mult),
        ok=None if ok is None else torch.tensor(ok),
        wd_vec=t(wdv) if use_wdvec else None, **kw)
    for a, b in zip(plain, want):
        assert a.numpy().tobytes() == np.asarray(b).tobytes()
    if ok is False:
        for a, b in zip(plain, (w, *state)):
            assert a.numpy().tobytes() == b.tobytes()
    # the wrapper on CPU tensors: the plain version, written in place
    before = tfu.fused_update.launches
    out = tfu.fused_update(
        t(g), tw, tstate, tuple(ts(s) for s in scalars),
        mult=None if mult is None else ts(mult),
        ok=None if ok is None else torch.tensor(ok),
        wd_vec=t(wdv) if use_wdvec else None, **kw)
    assert tfu.fused_update.launches == before
    assert out[0] is tw
    for a, b in zip((tw,) + tstate, plain):
        assert a.numpy().tobytes() == b.numpy().tobytes()


@pytest.mark.parametrize("budget", [4 << 20, 4096, 1000])
def test_plan_layout_equals_jax(budget):
    with mx.name.NameManager(), mxt.name.NameManager():
        jnet = jax_resnet(num_classes=10, depth=50)
        tnet = mxt.models.resnet(num_classes=10, depth=50)
    shapes, _, _ = tnet.infer_shape(data=(2, 3, 32, 32),
                                    softmax_label=(2,))
    names = [n for n in tnet.list_arguments()
             if n not in ("data", "softmax_label")]
    assert names == [n for n in jnet.list_arguments()
                     if n not in ("data", "softmax_label")]
    shape_of = dict(zip(tnet.list_arguments(), shapes))
    jp = jfu.build_plan(names, shape_of, budget)
    tp = tfu.build_plan(names, shape_of, budget)
    assert tp.order == jp.order
    assert tp.buckets == jp.buckets
    assert tp.bucket_sizes == jp.bucket_sizes
    # the buckets tile the concatenation of the parameters in plan order
    offs, flat = tp.offsets, 0
    for bucket in tp.buckets:
        for n, s0, s1 in bucket:
            assert offs[n] + s0 == flat
            flat += s1 - s0
    assert flat == sum(int(np.prod(shape_of[n])) for n in names)


def test_resnet50_has_25_buckets():
    net = mxt.models.get_symbol("resnet", num_classes=1000, depth=50)
    shapes, _, _ = net.infer_shape(data=(1, 3, 224, 224),
                                   softmax_label=(1,))
    names = [n for n in net.list_arguments()
             if n not in ("data", "softmax_label")]
    plan = tfu.build_plan(names, dict(zip(net.list_arguments(), shapes)),
                          4 << 20)
    assert sum(plan.bucket_sizes) == 25557032
    assert len(plan.buckets) == 25
    assert max(plan.bucket_sizes) == 1 << 18 << 2


def test_wrapper_validates_operands():
    g = torch.zeros(8)
    lr = torch.tensor(0.1)
    with pytest.raises(MXNetError, match="state operands"):
        tfu.fused_update(g, g.clone(), (), (lr,), kind="sgd_momentum")
    with pytest.raises(MXNetError, match="flat float32"):
        tfu.fused_update(g, torch.zeros(7), (), (lr,), kind="sgd")
    with pytest.raises(MXNetError, match="one-element float32"):
        tfu.fused_update(g, g.clone(), (), (torch.zeros(2),), kind="sgd")
    with pytest.raises(MXNetError, match="bool"):
        tfu.fused_update(g, g.clone(), (), (lr,), kind="sgd",
                         ok=torch.tensor(1.0))
    with pytest.raises(MXNetError, match="unsupported fused kind"):
        tfu.fused_update(g, g.clone(), (), (lr,), kind="nag")


# ----------------------------------------------------------------------
# the per-parameter entry (the hopper form's route) and its chunk plan
# ----------------------------------------------------------------------

# odd sizes put flat offsets off the 16-byte grid
PARAM_SIZES = (1, 3, 1001, 7, 64, 130, 2)


def _param_layout(seed):
    """Tensor sizes, a shuffled list order and flat offsets in another
    order with gaps of 0-2 elements: ``(sizes, offsets, flat length)``."""
    rng = np.random.RandomState(seed)
    sizes = [PARAM_SIZES[i] for i in rng.permutation(len(PARAM_SIZES))]
    offsets, off = [0] * len(sizes), 0
    for i in rng.permutation(len(sizes)):
        off += int(rng.randint(0, 3))
        offsets[i] = off
        off += sizes[i]
    return sizes, offsets, off + 1


@pytest.mark.parametrize("kind,scalars,use_wdvec,use_mult,ok,clip", CASES,
                         ids=IDS)
def test_params_entry_matches_jax_reference_and_bucket_route(
        kind, scalars, use_wdvec, use_mult, ok, clip):
    sizes, offsets, total = _param_layout(len(kind) + 3 * use_wdvec)
    assert any(o % 4 for o in offsets)
    g, w, state, wdv = _operands(kind, n=total, seed=5)
    grads = [g[o:o + n].copy() for o, n in zip(offsets, sizes)]
    kw = dict(HYPER, kind=kind, wd=1e-4, clip_gradient=clip)
    t = torch.from_numpy
    ts = lambda v: torch.tensor(v, dtype=torch.float32)   # noqa: E731
    tw, tstate = t(w.copy()), tuple(t(s.copy()) for s in state)
    opt_kw = dict(mult=None if not use_mult else ts(0.37),
                  ok=None if ok is None else torch.tensor(ok),
                  wd_vec=t(wdv) if use_wdvec else None, **kw)
    before = dict(tfu.fused_update.launches_by_form)
    out = tfu.fused_update_params([t(x) for x in grads], tw, tstate,
                                  offsets, tuple(ts(s) for s in scalars),
                                  **opt_kw)
    assert tfu.fused_update.launches_by_form == before
    assert out[0] is tw
    # JAX's reference and the bucket route over the concatenation, in
    # the list's order
    idx = np.concatenate([np.arange(o, o + n)
                          for o, n in zip(offsets, sizes)])
    cat = lambda a: np.ascontiguousarray(a[idx])            # noqa: E731
    want = jfu.reference_update(
        jnp.asarray(np.concatenate(grads)), jnp.asarray(cat(w)),
        tuple(jnp.asarray(cat(s)) for s in state),
        tuple(jnp.float32(s) for s in scalars),
        mult=jnp.float32(0.37) if use_mult else None,
        ok=None if ok is None else jnp.asarray(ok),
        wd_vec=jnp.asarray(cat(wdv)) if use_wdvec else None, **kw)
    bw, bstate = t(cat(w)), tuple(t(cat(s)) for s in state)
    tfu.fused_update(t(np.concatenate(grads)), bw, bstate,
                     tuple(ts(s) for s in scalars), form="bucket",
                     **dict(opt_kw, wd_vec=t(cat(wdv)) if use_wdvec
                            else None))
    for got, old, jx, bk in zip((tw,) + tstate, (w, *state), want,
                                (bw,) + bstate):
        got = got.numpy()
        assert cat(got).tobytes() == np.asarray(jx).tobytes()
        assert cat(got).tobytes() == bk.numpy().tobytes()
        # the gaps between the tensors are never written
        gaps = np.setdiff1d(np.arange(total), idx)
        assert got[gaps].tobytes() == old[gaps].tobytes()
        if ok is False:
            assert got.tobytes() == old.tobytes()


# (offsets, sizes, chunk, table)
PLANS = [
    ([0, 1, 4, 1005, 1012], [1, 3, 1001, 7, 64], 4096, 256),
    ([9000, 0, 4100], [5, 4099, 4096], 8, 256),
    ([7 * i + (i % 3) for i in range(300)], [5] * 300, 4, 256),
    ([0, 10, 20, 30, 40], [10] * 5, 4, 2),
]


@pytest.mark.parametrize("offsets,sizes,chunk,table", PLANS,
                         ids=["odd", "unordered", "two_tables", "tiny_tables"])
def test_chunk_plan_tiles_each_tensor_once(offsets, sizes, chunk, table):
    plan = tfu.plan_chunks(offsets, sizes, chunk=chunk, table=table)
    assert plan.extent == max(o + n for o, n in zip(offsets, sizes))
    assert len(plan.tables) == -(-len(sizes) // table)
    covered = [np.zeros(n, np.int32) for n in sizes]
    c_next = t_next = 0
    for t0, t1, c0, c1 in plan.tables:
        assert (t0, c0) == (t_next, c_next) and 0 < t1 - t0 <= table
        t_next, c_next = t1, c1
        for local, start, length, aligned in plan.chunks[c0:c1]:
            i = t0 + int(local)
            assert t0 <= i < t1 and 0 < length <= chunk
            assert start % chunk == 0 and start + length <= sizes[i]
            covered[i][start:start + length] += 1
            assert bool(aligned) == ((offsets[i] + start) % 4 == 0)
    assert (t_next, c_next) == (len(sizes), len(plan.chunks))
    assert all((c == 1).all() for c in covered)


@pytest.mark.parametrize("offsets,sizes,match", [
    ([0, 3], [4, 4], "overlap"),
    ([-1], [4], "offset -1"),
    ([0], [0], "0 elements"),
    ([0, 4], [4], "2 offsets for 1 sizes"),
], ids=["overlap", "negative", "empty", "count"])
def test_chunk_plan_rejects_bad_layouts(offsets, sizes, match):
    with pytest.raises(MXNetError, match=match):
        tfu.plan_chunks(offsets, sizes)


def _resnet50_and_lm_layouts():
    out = []
    with mxt.name.NameManager():
        net = mxt.models.get_symbol("resnet", num_classes=1000, depth=50)
    out.append((net, dict(data=(1, 3, 224, 224), softmax_label=(1,))))
    with mxt.name.NameManager():
        lm = mxt.models.get_symbol("transformer-lm", vocab_size=32000,
                                   num_layers=6, d_model=512, heads=8,
                                   batch_size=8, seq_len=2048,
                                   loss_head=True)
    out.append((lm, dict(data=(8, 2048), softmax_label=(8, 2048))))
    return out


def test_main_paths_chunk_plans_stay_on_the_16_byte_grid():
    """ResNet-50 (161 tensors) and the LM (101): one table each, every
    chunk on the grid, so the hopper kernel's scalar path never runs."""
    for (net, shapes), (tensors, total) in zip(
            _resnet50_and_lm_layouts(),
            [(161, 25557032), (101, 51715328)]):
        arg_shapes, _, _ = net.infer_shape(**shapes)
        shape_of = dict(zip(net.list_arguments(), arg_shapes))
        names = [n for n in net.list_arguments() if n not in shapes]
        plan = tfu.build_plan(names, shape_of, 4 << 20)
        offs = plan.offsets
        cp = tfu.plan_chunks([offs[n] for n in plan.order],
                             [int(np.prod(plan.shapes[n]))
                              for n in plan.order])
        assert len(cp.sizes) == tensors and sum(cp.sizes) == total
        assert len(cp.tables) == 1
        assert cp.chunks[:, 3].all()


def _params_args(n_tensors=3, size=8):
    grads = [torch.zeros(size) for _ in range(n_tensors)]
    offsets = [i * size for i in range(n_tensors)]
    w = torch.zeros(n_tensors * size)
    return grads, w, offsets


@pytest.mark.parametrize("bad,match", [
    ("count", "plan has 3 tensors, got 2 gradients"),
    ("dtype", "contiguous float32"),
    ("strided", "non-contiguous"),
    ("size", "of 8 elements"),
    ("past", "past the flat buffers"),
    ("state", "flat float32 buffer"),
], ids=["count", "dtype", "strided", "size", "past", "state"])
def test_params_wrapper_validates_operands(bad, match):
    grads, w, offsets = _params_args()
    lr = torch.tensor(0.1)
    plan = tfu.plan_chunks(offsets, [8, 8, 8])
    state = (torch.zeros_like(w),)
    if bad == "count":
        grads = grads[:2]
    elif bad == "dtype":
        grads[1] = grads[1].double()
    elif bad == "strided":
        grads[2] = torch.zeros(16)[::2]
    elif bad == "size":
        grads[0] = torch.zeros(9)
    elif bad == "past":
        plan = tfu.plan_chunks([0, 8, 20], [8, 8, 8])
    elif bad == "state":
        state = (torch.zeros(23),)
    with pytest.raises(MXNetError, match=match):
        tfu.fused_update_params(grads, w, state, plan, (lr,),
                                kind="sgd_momentum", momentum=0.9)


def test_kernel_form_and_forced_forms():
    x = torch.zeros(8)
    assert tfu.kernel_form(x, None, x) == "hopper"
    assert tfu.kernel_form(x, torch.zeros(16)[::2]) == "bucket"
    assert tfu.kernel_form(x.double()) == "bucket"
    lr = torch.tensor(0.1)
    before = dict(tfu.fused_update.launches_by_form)
    for form in tfu.KERNEL_FORMS:
        w = torch.ones(8)
        tfu.fused_update(torch.ones(8), w, (), (lr,), kind="sgd", form=form)
        assert (w == 0.9).all()
    assert tfu.fused_update.launches_by_form == before
    with pytest.raises(MXNetError, match="unknown form"):
        tfu.fused_update(x, x.clone(), (), (lr,), kind="sgd", form="warp")


# ----------------------------------------------------------------------
# the fused trainer is a bitwise twin of the unfused one
# ----------------------------------------------------------------------

def _mlp(no_bias=False):
    with mxt.name.NameManager():
        d = S.Variable("data")
        net = S.FullyConnected(d, num_hidden=32, name="fc1", no_bias=no_bias)
        net = S.Activation(net, act_type="relu")
        net = S.FullyConnected(net, num_hidden=10, name="fc2",
                               no_bias=no_bias)
        return S.SoftmaxOutput(net, name="softmax")


def _trainer(fused, optimizer="sgd", opt_params=None, no_bias=False,
             route=None, **kw):
    """A bound MLP trainer; ``route="bucket"`` forces the fused update's
    bucket form (kernel_form picks the hopper form for the flat
    buffers)."""
    tr = ShardedTrainer(_mlp(no_bias), optimizer=optimizer,
                        optimizer_params=opt_params
                        or {"learning_rate": 0.1, "momentum": 0.9},
                        fused_update=fused, device="cpu", seed=7, **kw)
    tr.bind(data_shapes={"data": (16, 8)},
            label_shapes={"softmax_label": (16,)})
    if route is not None:
        tr._fused_route = route
    return tr


def _feeds(n=3, seed=0):
    rng = np.random.RandomState(seed)
    return [{"data": rng.rand(16, 8).astype(np.float32),
             "softmax_label": rng.randint(0, 10, (16,)).astype(np.float32)}
            for _ in range(n)]


def _params_bytes(tr):
    return {n: v.asnumpy().tobytes() for n, v in tr.get_params()[0].items()}


def _state_bytes(tr):
    return {n: [s.numpy().tobytes() for s in ss]
            for n, ss in tr.opt_state_by_param().items()}


KINDS = [
    ("sgd", {"learning_rate": 0.1}, False),
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9}, False),
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 0.01,
             "clip_gradient": 0.5}, True),
    ("adam", {"learning_rate": 1e-3}, False),
    ("adamw", {"learning_rate": 1e-3, "wd": 0.01}, True),
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 0.01,
             "clip_gradient": 0.5}, False),
    ("adamw", {"learning_rate": 1e-3, "wd": 0.01}, False),
]


@pytest.mark.parametrize("opt,op,no_bias", KINDS,
                         ids=["sgd", "sgd_momentum", "sgd_wd_clip", "adam",
                              "adamw", "sgd_wdvec", "adamw_wdvec"])
def test_fused_trainer_is_bitwise_twin_of_unfused(opt, op, no_bias):
    a = _trainer(True, opt, op, no_bias=no_bias)
    c = _trainer(True, opt, op, no_bias=no_bias, route="bucket")
    b = _trainer(False, opt, op, no_bias=no_bias)
    assert a._fused and c._fused and not b._fused
    assert (a._fused_route, c._fused_route) == ("hopper", "bucket")
    assert _params_bytes(a) == _params_bytes(b)        # same seeded init
    if op.get("wd") and not no_bias:
        assert a._flat_wd is not None
    for si, f in enumerate(_feeds()):
        ha, hc, hb = a.step(f), c.step(f), b.step(f)
        for fused in (a, c):
            assert _params_bytes(fused) == _params_bytes(b), si
            assert _state_bytes(fused) == _state_bytes(b), si
        assert ha[0].numpy().tobytes() == hb[0].numpy().tobytes(), si
        assert hc[0].numpy().tobytes() == hb[0].numpy().tobytes(), si


@pytest.mark.parametrize("opt,op", [
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9}),
    ("adam", {"learning_rate": 1e-3}),
], ids=["sgd_momentum", "adam"])
def test_fused_guard_twin_and_poisoned_step_is_bitwise_noop(opt, op):
    a = _trainer(True, opt, op, guard=True, clip_global_norm=0.1)
    c = _trainer(True, opt, op, guard=True, clip_global_norm=0.1,
                 route="bucket")
    b = _trainer(False, opt, op, guard=True, clip_global_norm=0.1)
    feeds = _feeds(4)
    feeds[2]["data"][0, 0] = np.nan
    for si, f in enumerate(feeds):
        pre_w, pre_s = _params_bytes(a), _state_bytes(a)
        a.step(f), c.step(f), b.step(f)
        if si == 2:
            assert _params_bytes(a) == pre_w
            assert _state_bytes(a) == pre_s
        for fused in (a, c):
            assert _params_bytes(fused) == _params_bytes(b), si
            assert _state_bytes(fused) == _state_bytes(b), si
    assert int(a._guard_state["skipped"]) == 1
    assert int(c._guard_state["skipped"]) == 1


def test_multi_bucket_and_split_params_stay_bitwise():
    a = _trainer(True, grad_bucket_bytes=1024)
    c = _trainer(True, grad_bucket_bytes=1024, route="bucket")
    b = _trainer(False, grad_bucket_bytes=1024)
    assert (a._fused_route, c._fused_route) == ("hopper", "bucket")
    assert len(a._fused_plan.buckets) > 1
    per_bucket = [{n for n, _, _ in b_} for b_ in a._fused_plan.buckets]
    assert any(per_bucket[i] & per_bucket[i + 1]
               for i in range(len(per_bucket) - 1))
    # the hopper route's chunks follow the parameters, not the buckets
    assert len(a._chunk_plan.sizes) == len(a._fused_plan.order)
    for si, f in enumerate(_feeds()):
        a.step(f), c.step(f), b.step(f)
        for fused in (a, c):
            assert _params_bytes(fused) == _params_bytes(b), si
            assert _state_bytes(fused) == _state_bytes(b), si


def test_eligibility_gate(monkeypatch):
    op = {"learning_rate": 1e-3, "wd": 0.01}
    tr = _trainer(None, "adamw", op)
    assert tr._fused and not tr._fused_wd_uniform
    assert set(np.unique(tr._flat_wd.numpy())) <= {np.float32(0.0),
                                                   np.float32(0.01)}
    # adam with weight decay cannot fuse: silent fallback, or an error
    assert not _trainer(None, "adam", op)._fused
    with pytest.raises(MXNetError, match="adam with weight decay"):
        _trainer(True, "adam", op)
    # per-param lr_mult cannot fuse
    opt = mxt.optimizer.create("sgd", learning_rate=0.1)
    opt.set_lr_mult({"fc1_weight": 0.5})
    tr = ShardedTrainer(_mlp(), optimizer=opt, fused_update=True,
                        device="cpu")
    with pytest.raises(MXNetError, match="lr_mult"):
        tr.bind({"data": (16, 8)}, {"softmax_label": (16,)})
    monkeypatch.setenv("MXNET_TPU_FUSED_UPDATE", "0")
    assert not _trainer(None)._fused
    assert _trainer(True)._fused
