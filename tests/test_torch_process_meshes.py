"""``ShardedTrainer`` of the PyTorch port over meshes that span processes
on any axis (``parallel/process_mesh.py``, the bridges of
``parallel/members.py``) against the JAX trainer over 4 virtual devices
with the same mesh shape, on the same numpy seeds and parameters.

One module-scoped run of 2 processes over gloo (this file as the
program: ``python tests/test_torch_process_meshes.py``), each process
with 2 CPU members (``init_distributed(device=[cpu(0), cpu(1)])``), a
global mesh of 4.  ``h0, h1`` are the first process's members and ``t0,
t1`` the second's; ``make_mesh(axes, members)`` lays them out row-major.
The trainers run in sequence:

* (i) the small LM (2 layers, d 32, 2 heads, V 62, batch 4 x 32) under
  ``megatron_rules()`` over ``{"data": 2, "model": 2}``, data across the
  processes (``h0, h1, t0, t1``): each process feeds its rows;
* (ii) the same mesh with the model axis across the processes (``h0,
  t0, h1, t1``): each process feeds the whole batch, the split plan
  meets across them;
* (iii) the LM over ``{"data": 2, "seq": 2}``, seq across the processes:
  the ring crosses them;
* (iv) the MoE net (``MoEFFN``, E 4, d 8, h 16, top-1 at capacity 4.0)
  over ``{"data": 2, "expert": 2}``, expert across the processes, each
  holding its experts (``P("expert")``);
* (v) an MLP under Adam with ZeRO over ``{"data": 4}`` (data across and
  inside the processes), then ``save_state`` (viii);
* (vi) the MLP with ``fc1_weight`` cut ``P("data", None)`` over
  ``{"data": 4}``, and ``P(("data", "model"), None)`` over ``{"data": 2,
  "model": 2}`` with data across;
* (vii) the MLP with int8 compression and error feedback over
  ``{"data": 4}``;
* a BatchNorm net with ``grad_accum=2`` (each process feeds its rows of
  every microbatch), bf16 compression into the fused update, and the
  guard's clip over pieces that both processes hold;
* the exact integer pattern of ``tests/dist_collective_worker.py``'s
  linear net over the model-across layout of (ii), its weight cut
  ``P("model", None)``: bitwise the closed form;
* ``fit`` with a checkpoint manager whose clock policy fires on one
  process only, then with a preemption signal on one process only: both
  save at the same updates, and both stop at the preempted one.

After their steps, the cases in ``RESUMED`` (of either run) save their
state over the processes, restore it into a fresh trainer on the same
layout and take one more step beside the uninterrupted trainer: bitwise
the same on every process.

A second module-scoped run of 4 processes with one member each lays
``{"data": 2, "model": 2}`` over them row-major, so both axes cross
processes at once and a piece's gradient meets over two of the four:
the LM under Megatron's rules, ZeRO, a rule over the model axis, int8
with error feedback, each against the JAX trainer.  In this process:
``ProcessLayout``'s boxes, lines and refusals.

Tolerances are ``tests/test_torch_dist_collective.py``'s: parameters rtol
1e-4 / atol 1e-6, heads rtol 1e-5 / atol 1e-5 (a reduction across
processes sums in another order than XLA's).  Every process's copy of a
replicated value is bitwise the other's.  (viii): the checkpoint the two
processes wrote restores, in this process, into a trainer over 4 CPU
members and into one member, bitwise what the ranks held; a save asked
for inside a step is written by both at the step's end.
"""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

_HERE = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(_HERE)
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

PARAM = dict(rtol=1e-4, atol=1e-6)
HEAD = dict(rtol=1e-5, atol=1e-5)
STEPS = 2

B, L, VOCAB, D_LM, HEADS = 4, 32, 62, 32, 2
E, D_MOE, H_MOE, B_MOE = 4, 8, 16, 8
B_MLP, IN_MLP = 8, 6
LIN_BATCH, LIN_FEAT = 8, 3

# (name, axes, layout, net, rules, optimizer, trainer kwargs); a layout
# names the global member order: "data" puts the processes along the
# first axis (h0 h1 t0 t1), "inner" along the second (h0 t0 h1 t1)
CASES = [
    ("lm-data-across", {"data": 2, "model": 2}, "data", "lm", "megatron",
     "sgd", {}),
    ("lm-model-across", {"data": 2, "model": 2}, "inner", "lm", "megatron",
     "sgd", {}),
    ("lm-seq-across", {"data": 2, "seq": 2}, "inner", "lm", None, "sgd", {}),
    ("moe-expert-across", {"data": 2, "expert": 2}, "inner", "moe",
     [(r"moe_expert\d_(weight|bias)", ("expert",))], "sgd", {}),
    ("mlp-zero", {"data": 4}, "data", "mlp", None, "adam",
     {"shard_optimizer": True}),
    ("mlp-rule-over-data", {"data": 4}, "data", "mlp",
     [("fc1_weight", ("data", None))], "sgd", {}),
    ("mlp-rule-over-data-model", {"data": 2, "model": 2}, "data", "mlp",
     [("fc1_weight", (("data", "model"), None))], "sgd", {}),
    ("mlp-int8-ef", {"data": 4}, "data", "mlp", None, "sgd",
     {"grad_compression": "int8", "error_feedback": True}),
    # each process's rows of every microbatch (a BatchNorm net: the
    # microbatches' batch statistics tell them apart); the bf16 wire's
    # reduced buckets straight into the fused update; the guard's clip
    # over the pieces of both processes
    ("bn-data-across-accum2", {"data": 2, "model": 2}, "data", "bn",
     None, "sgd", {"grad_accum": 2}),
    ("mlp-bf16-fused", {"data": 4}, "data", "mlp", None, "sgd",
     {"grad_compression": "bf16", "fused_update": True}),
    ("mlp-rule-clip", {"data": 2, "model": 2}, "data", "mlp",
     [("fc1_weight", (("data", "model"), None))], "sgd",
     {"clip_global_norm": 0.05}),
]
# a second run of 4 processes with one CPU member each, the mesh laid
# out row-major over them: both axes cross processes at once (a piece of
# a model cut is held by two of the four, a data coordinate by two)
CASES4 = [
    ("4p-lm-megatron", {"data": 2, "model": 2}, "data", "lm", "megatron",
     "sgd", {}),
    ("4p-mlp-zero", {"data": 2, "model": 2}, "data", "mlp", None, "adam",
     {"shard_optimizer": True}),
    ("4p-mlp-rule-over-model", {"data": 2, "model": 2}, "data", "mlp",
     [("fc1_weight", ("model", None))], "sgd", {}),
    ("4p-mlp-int8-ef", {"data": 2, "model": 2}, "data", "mlp", None, "sgd",
     {"grad_compression": "int8", "error_feedback": True}),
]
OPT = {"sgd": {"learning_rate": 0.1}, "adam": {"learning_rate": 0.01}}
# the cases whose state each process saves after their steps and restores
# into a fresh trainer on the same layout, which then steps on beside the
# uninterrupted one: Megatron's pieces within and across processes, ZeRO
# slices, int8 error-feedback residuals
RESUMED = ["lm-data-across", "lm-model-across", "mlp-zero", "mlp-int8-ef",
           "4p-lm-megatron", "4p-mlp-zero", "4p-mlp-int8-ef"]
# fit's batches over data across the processes (FIT_BATCHES of B_MLP rows)
FIT_BATCHES = 4


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


# ---------------------------------------------------------------------------
# the nets, their parameters and batches (either package)
# ---------------------------------------------------------------------------

def _net(kind, pkg):
    import importlib
    S = pkg.symbol
    if kind == "lm":
        models = importlib.import_module(pkg.__name__ + ".models")
        return models.get_symbol(
            "transformer-lm", vocab_size=VOCAB, num_layers=2, d_model=D_LM,
            heads=HEADS, batch_size=B, seq_len=L)
    if kind == "moe":
        net = S.MoEFFN(data=S.Variable("data"), num_experts=E,
                       hidden_size=H_MOE, capacity_factor=4.0, top_k=1,
                       name="moe")
        return S.LinearRegressionOutput(data=net, name="lro")
    if kind in ("mlp", "bn"):
        h = S.FullyConnected(data=S.Variable("data"), num_hidden=16,
                             name="fc1")
        if kind == "bn":
            h = S.BatchNorm(data=h, name="bn1")
        h = S.Activation(data=h, act_type="relu", name="relu1")
        h = S.FullyConnected(data=h, num_hidden=5, name="fc2")
        return S.SoftmaxOutput(data=h, name="softmax",
                               normalization="batch" if kind == "bn"
                               else "null")
    net = S.FullyConnected(data=S.Variable("data"), num_hidden=2, name="fc")
    return S.LinearRegressionOutput(data=net, label=S.Variable("lro_label"),
                                    name="lro")


def _shapes(kind):
    if kind == "lm":
        return {"data": (B, L)}, {"softmax_label": (B, L)}
    if kind == "moe":
        return {"data": (B_MOE, D_MOE)}, {"lro_label": (B_MOE, D_MOE)}
    if kind in ("mlp", "bn"):
        return {"data": (B_MLP, IN_MLP)}, {"softmax_label": (B_MLP,)}
    return {"data": (LIN_BATCH, LIN_FEAT)}, {"lro_label": (LIN_BATCH, 2)}


def _args(kind, pkg):
    with pkg.name.NameManager():
        sym = _net(kind, pkg)
    data, label = _shapes(kind)
    arg_shapes, _, _ = sym.infer_shape(**data, **label)
    rng = np.random.RandomState(11)
    scale = 0.3 if kind == "moe" else 0.1 if kind == "lm" else 0.4
    return {n: rng.uniform(-scale, scale, s).astype(np.float32)
            for n, s in zip(sym.list_arguments(), arg_shapes)
            if n not in data and n not in label}


def _batches(kind):
    rng = np.random.RandomState(7)
    out = []
    for _ in range(STEPS):
        if kind == "lm":
            x = rng.randint(0, VOCAB, (B, L)).astype(np.float32)
            out.append({"data": x, "softmax_label": np.roll(x, -1, axis=1)})
        elif kind == "moe":
            out.append({"data": rng.randn(B_MOE, D_MOE).astype(np.float32),
                        "lro_label": rng.randn(B_MOE, D_MOE)
                        .astype(np.float32)})
        else:
            x = rng.randn(B_MLP, IN_MLP).astype(np.float32)
            x[:B_MLP // 2] += 2.0   # the first process's rows differ
            out.append({"data": x, "softmax_label": rng.randint(0, 5, B_MLP)
                        .astype(np.float32)})
    return out


def _linear_batch():
    gx = np.arange(LIN_BATCH * LIN_FEAT, dtype=np.float32).reshape(
        LIN_BATCH, LIN_FEAT)
    gy = (np.arange(LIN_BATCH * 2, dtype=np.float32).reshape(
        LIN_BATCH, 2) % 5) - 2
    return gx, gy


def _rows(axes, layout, rank, n, accum=1, nproc=2):
    """The rows of a global batch of ``n`` that process ``rank`` of
    ``nproc`` feeds: those of the data coordinates its members hold, the
    batch viewed as ``[accum, data, rows]``."""
    if layout == "inner" or "data" not in axes:
        return np.arange(n)
    nd = axes["data"]
    view = np.arange(n).reshape(accum, nd, n // (accum * nd))
    if nproc == 4:
        # one member a process, row-major: data coordinate rank // 2
        return view[:, rank // 2].reshape(-1)
    return view[:, rank * nd // 2:(rank + 1) * nd // 2].reshape(-1)


# ---------------------------------------------------------------------------
# the program of each process
# ---------------------------------------------------------------------------

def worker_main() -> int:
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import checkpoint
    from mxnet_tpu_torch.parallel import (PartitionSpec, ShardedTrainer,
                                          ShardingRules, dist, make_mesh,
                                          megatron_rules)
    from mxnet_tpu_torch.parallel.collectives import count_collectives
    nproc = int(os.environ["MXTPU_NUM_PROC"])
    dist.init_distributed(device=[mx.cpu(0), mx.cpu(1)][:4 // nproc])
    rank, out = dist.process_index(), {}
    assert dist.backend() == "gloo"
    if nproc == 4:
        order = {"data": dist.global_contexts()}
    else:
        h0, h1, t0, t1 = dist.global_contexts()
        order = {"data": [h0, h1, t0, t1], "inner": [h0, t0, h1, t1]}

    def rules_of(spec):
        if spec is None:
            return None
        if spec == "megatron":
            return megatron_rules()
        return ShardingRules([(p, PartitionSpec(*s)) for p, s in spec])

    def resumed(name, tr, make, kind, feed):
        """``tr``'s state saved by every process and restored into a fresh
        trainer on the same layout (``make()``, its own initial values
        and seed); one more step of each: the heads and parameters that
        differ."""
        mgr = checkpoint.CheckpointManager(
            os.environ["MESH_TEST_CKPT"] + "-resume-" + name)
        tr.save_state(mgr)
        fresh = make(seed=5)
        fresh.bind(*_shapes(kind))
        fresh.restore_state(mgr)
        mgr.close()
        a, b = tr.step(feed), fresh.step(feed)
        diff = [f"head{q}" for q, (x, y) in enumerate(zip(a, b))
                if x.numpy().tobytes() != y.numpy().tobytes()]
        pa, pb = tr.get_params()[0], fresh.get_params()[0]
        diff += [n for n in pa if pa[n].asnumpy().tobytes()
                 != pb[n].asnumpy().tobytes()]
        del fresh
        return np.array(diff, dtype=object)

    for name, axes, layout, kind, spec, opt, kw in (CASES if nproc == 2
                                                    else CASES4):
        with mx.name.NameManager():
            sym = _net(kind, mx)

        def make(sym=sym, axes=axes, layout=layout, spec=spec, opt=opt,
                 kw=kw, **more):
            return ShardedTrainer(sym, opt, dict(OPT[opt]),
                                  mesh=make_mesh(axes, order[layout]),
                                  rules=rules_of(spec), **kw, **more)
        tr = make()
        tr.bind(*_shapes(kind), arg_params=_args(kind, mx))
        if tr._tp_plan is not None:
            out[f"{name}:plan"] = np.array(tr._tp_plan.plan)
        for step, b in enumerate(_batches(kind)):
            rows = _rows(axes, layout, rank, len(b["data"]),
                         kw.get("grad_accum", 1), nproc)
            with count_collectives() as st:
                heads = tr.step({k: v[rows] for k, v in b.items()})
            for q, h in enumerate(heads):
                out[f"{name}:head{q}:{step}"] = h.numpy()
            by = {}
            for r in st.records:
                if r["kind"] == "process":
                    by[r["axis"]] = by.get(r["axis"], 0) + r["wire_nbytes"]
            out[f"{name}:crossed:{step}"] = np.array(sorted(by.items()),
                                                     dtype=object)
        arg, aux = tr.get_params()
        for n, v in list(arg.items()) + list(aux.items()):
            out[f"{name}:param:{n}"] = v.asnumpy()
        if name == "lm-model-across":
            info = tr.compile()[0]
            out[f"{name}:compile"] = np.array([info["source"],
                                               info["reason"]])
            piece = tr._member_params(0)["layer0_q_weight"]
            out[f"{name}:piece"] = np.array(piece.shape)
        if name == "mlp-zero":
            # (viii): every process writes its share; the state dumped
            # beside it
            mgr = checkpoint.CheckpointManager(os.environ["MESH_TEST_CKPT"])
            tr.save_state(mgr)
            mgr.close()
            for n, leaves in tr.opt_state_by_param().items():
                for i, leaf in enumerate(leaves):
                    out[f"{name}:opt:{n}:{i}"] = leaf.numpy()
            out[f"{name}:num_update"] = np.array(tr._num_update)
            out[f"{name}:zero_bytes"] = np.array(
                tr.optimizer_state_bytes_per_device())
            if nproc == 2:
                # a save asked for inside a step (a preemption hook) runs
                # at the step's end, on every process at the same update
                mgr = checkpoint.CheckpointManager(
                    os.environ["MESH_TEST_CKPT"] + "-deferred")
                tr._in_step = True
                tr.save_state(mgr)
                tr._in_step = False
                out[f"{name}:deferred_before"] = np.array(
                    mgr.latest_step() is None)
                tr.step({k: v[rows] for k, v in b.items()})
                out[f"{name}:deferred_step"] = np.array(mgr.latest_step())
                mgr.close()
        if name in RESUMED:
            b = _batches(kind)[0]
            out[f"{name}:resume_diff"] = resumed(
                name, tr, make, kind,
                {k: v[_rows(axes, layout, rank, len(b["data"]), 1, nproc)]
                 for k, v in b.items()})
        del tr
    if nproc == 4:
        np.savez(os.path.join(os.environ["MESH_TEST_OUT"],
                              f"rank{rank}.npz"), **out)
        dist.shutdown()
        return 0

    out.update(fit_over_processes(rank, order["data"]))

    # the exact integer pattern over the model-across layout
    tr = ShardedTrainer(_net("linear", mx), "sgd", {"learning_rate": 1.0},
                        mesh=make_mesh({"data": 2, "model": 2},
                                       order["inner"]),
                        rules=ShardingRules([("fc_weight",
                                              PartitionSpec("model",
                                                            None))]))
    tr.bind(*_shapes("linear"))
    tr.set_params({n: np.zeros(s, np.float32)
                   for n, s in tr._shapes.items()})
    gx, gy = _linear_batch()
    out["lin:head"] = tr.step({"data": gx, "lro_label": gy})[0].numpy()
    out["lin:piece"] = np.array(tr._member_params(0)["fc_weight"].shape)
    for n, v in tr.get_params()[0].items():
        out[f"lin:{n}"] = v.asnumpy()
    np.savez(os.path.join(os.environ["MESH_TEST_OUT"], f"rank{rank}.npz"),
             **out)
    dist.shutdown()
    return 0


def fit_over_processes(rank, members):
    """``fit`` of the MLP over ``{"data": 4}``, data across the two
    processes (each its rows of every batch), with a checkpoint manager:
    first under a clock policy that says yes on process 0 only, then with
    a preemption signal (SIGTERM through the manager's hook) on process 1
    only, at its second batch.  Each process's update count, committed
    steps and preemption flag."""
    import signal
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import checkpoint
    from mxnet_tpu_torch.parallel import ShardedTrainer, make_mesh
    rng = np.random.RandomState(5)
    x = rng.randn(FIT_BATCHES * B_MLP, IN_MLP).astype(np.float32)
    y = rng.randint(0, 5, FIT_BATCHES * B_MLP).astype(np.float32)
    half = B_MLP // 2
    mine = (np.arange(FIT_BATCHES)[:, None] * B_MLP + rank * half
            + np.arange(half)).reshape(-1)
    with mx.name.NameManager():
        sym = _net("mlp", mx)
    tr = ShardedTrainer(sym, "sgd", dict(OPT["sgd"]),
                        mesh=make_mesh({"data": 4}, members))
    tr.bind(*_shapes("mlp"), arg_params=_args("mlp", mx))
    out = {}

    def batches():
        return mx.io.NDArrayIter(x[mine], y[mine], batch_size=half)

    base = os.environ["MESH_TEST_CKPT"] + "-fit"
    # a clock read by each process: process 0's interval has always
    # passed (after the first ask arms it), process 1's never
    mgr = checkpoint.CheckpointManager(
        base + "-clock", keep_last=FIT_BATCHES,
        save_interval_seconds=1e-9 if rank == 0 else 3600.0)
    tr.fit(batches(), num_epoch=1, checkpoint_manager=mgr)
    out["fit:clock:update"] = np.array(tr._num_update)
    out["fit:clock:steps"] = np.array(mgr.all_steps())
    mgr.close()

    mgr = checkpoint.CheckpointManager(base + "-preempt")
    if rank == 1:
        mgr.install_preemption_hook(
            lambda: tr.save_state(mgr, blocking=True))

    def signal_at_second(param):
        if rank == 1 and param.nbatch == 2:
            os.kill(os.getpid(), signal.SIGTERM)
    tr.fit(batches(), num_epoch=1, checkpoint_manager=mgr,
           batch_end_callback=signal_at_second)
    mgr.uninstall_preemption_hook()
    out["fit:preempt:update"] = np.array(tr._num_update)
    out["fit:preempt:steps"] = np.array(mgr.all_steps())
    out["fit:preempt:flag"] = np.array(mgr.preempted)
    mgr.close()
    return out


# ---------------------------------------------------------------------------
# in this process
# ---------------------------------------------------------------------------

@pytest.fixture(autouse=True)
def _keep_random_state():
    """Restore the port's global key sequence and device generators and
    the JAX package's key state after each test."""
    from mxnet_tpu import random as jrandom
    from mxnet_tpu_torch import random as port_random
    saved_j = dict(jrandom._state)
    saved = dict(port_random._state)
    gens = {d: g.get_state() for d, g in port_random._generators.items()}
    yield
    jrandom._state.update(saved_j)
    port_random._state.update(saved)
    for d in list(port_random._generators):
        if d in gens:
            port_random._generators[d].set_state(gens[d])
        else:
            del port_random._generators[d]


def _spawn(tmp, nproc):
    """This file as the program of ``nproc`` processes; their results."""
    port = _free_port()
    procs = []
    for rank in range(nproc):
        env = dict(os.environ, MXTPU_COORDINATOR=f"127.0.0.1:{port}",
                   MXTPU_NUM_PROC=str(nproc), MXTPU_PROC_ID=str(rank),
                   MESH_TEST_OUT=str(tmp), MESH_TEST_CKPT=str(tmp / "ckpt"),
                   PYTHONPATH=_ROOT, OMP_NUM_THREADS="2")
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0].decode("utf-8",
                                                             "replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {rank} failed:\n{out}"
    return [dict(np.load(tmp / f"rank{r}.npz", allow_pickle=True))
            for r in range(nproc)]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("process-meshes")
    return _spawn(tmp, 2), str(tmp / "ckpt")


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    return _spawn(tmp_path_factory.mktemp("process-meshes-4"), 4)


_JAX = {}


def _jax_run(case):
    """The JAX trainer over 4 virtual devices with the case's mesh shape:
    each step's heads and the parameters after them."""
    key = repr(case[1:])
    if key in _JAX:
        return _JAX[key]
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as JP
    import mxnet_tpu as jmx
    from mxnet_tpu.parallel import ShardedTrainer as JaxTrainer
    from mxnet_tpu.parallel import ShardingRules as JRules
    from mxnet_tpu.parallel import make_mesh as jmake_mesh
    from mxnet_tpu.parallel import megatron_rules as jmegatron_rules
    _, axes, _, kind, spec, opt, kw = case
    rules = (None if spec is None else jmegatron_rules()
             if spec == "megatron"
             else JRules([(p, JP(*s)) for p, s in spec]))
    with jmx.name.NameManager():
        sym = _net(kind, jmx)
    tr = JaxTrainer(sym, optimizer=opt, optimizer_params=dict(OPT[opt]),
                    mesh=jmake_mesh(axes, jax.devices()[:4]), rules=rules,
                    **kw)
    tr.bind(*_shapes(kind), arg_params={
        k: jnp.asarray(v) for k, v in _args(kind, jmx).items()})
    heads = [[np.asarray(jax.device_get(h)) for h in tr.step(b)]
             for b in _batches(kind)]
    arg, aux = tr.get_params()
    params = {n: v.asnumpy() for n, v in list(arg.items())
              + list(aux.items())}
    _JAX[key] = heads, params
    return _JAX[key]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_trainer_over_processes_matches_jax(ranks, case):
    """Each case's heads at every step and parameters after the last,
    on both processes, against the JAX trainer over 4 devices; the
    processes' replicated values bitwise equal; the bytes that crossed
    processes are counted along the axis that spans them."""
    (r0, r1), _ = ranks
    name, axes, layout, kind, spec, _, kw = case
    jheads, jparams = _jax_run(case)
    for n, want in jparams.items():
        a, b = r0[f"{name}:param:{n}"], r1[f"{name}:param:{n}"]
        assert a.tobytes() == b.tobytes(), n
        np.testing.assert_allclose(a, want, **PARAM, err_msg=n)
    for step, want in enumerate(jheads):
        for q, wq in enumerate(want):
            a, b = r0[f"{name}:head{q}:{step}"], r1[f"{name}:head{q}:{step}"]
            if layout == "data":
                # each process holds its rows of the global batch
                got = np.empty_like(wq)
                n, acc = len(_batches(kind)[0]["data"]), kw.get("grad_accum",
                                                                1)
                per = len(wq) // n
                for r, h in ((0, a), (1, b)):
                    idx = _rows(axes, layout, r, n, acc)
                    got[(idx[:, None] * per + np.arange(per)).reshape(-1)] \
                        = h.reshape(len(idx) * per, *wq.shape[1:])
                # (a head of per-row values, ``per`` of them a row)
            else:
                assert a.tobytes() == b.tobytes(), (step, q)
                got = a
            np.testing.assert_allclose(got, wq, **HEAD,
                                       err_msg=f"step {step} head {q}")
    across = "data" if layout == "data" else list(axes)[1]
    crossed = dict(r0[f"{name}:crossed:0"])
    assert crossed.get(across, 0) > 0, crossed
    if spec == "megatron":
        assert str(r0[f"{name}:plan"]) == "split"
    if kw.get("shard_optimizer"):
        # each process holds the optimizer state of its own slices only
        assert int(r0[f"{name}:zero_bytes"]) > 0


@pytest.mark.parametrize("case", CASES4, ids=[c[0] for c in CASES4])
def test_both_axes_across_four_processes_match_jax(four_ranks, case):
    """Over 4 processes of one member each, ``{"data": 2, "model": 2}``
    laid out row-major: both axes cross processes, a model coordinate's
    pieces are held by two of the four (their sums meet over those two
    alone) and a data coordinate by two; heads and parameters against
    the JAX trainer over 4 devices, every process's replicated values
    bitwise the others'."""
    name, axes, layout, kind, spec, _, kw = case
    jheads, jparams = _jax_run(case)
    for n, want in jparams.items():
        got = [r[f"{name}:param:{n}"] for r in four_ranks]
        assert all(g.tobytes() == got[0].tobytes() for g in got), n
        np.testing.assert_allclose(got[0], want, **PARAM, err_msg=n)
    n = len(_batches(kind)[0]["data"])
    for step, want in enumerate(jheads):
        for q, wq in enumerate(want):
            per = len(wq) // n
            for rank, r in enumerate(four_ranks):
                idx = _rows(axes, layout, rank, n, 1, 4)
                rows = (idx[:, None] * per + np.arange(per)).reshape(-1)
                np.testing.assert_allclose(
                    r[f"{name}:head{q}:{step}"].reshape(wq[rows].shape),
                    wq[rows], **HEAD, err_msg=f"rank {rank} step {step}")
    crossed = dict(four_ranks[0][f"{name}:crossed:0"])
    assert sum(crossed.values()) > 0, crossed


def test_model_axis_across_processes_holds_pieces_and_runs_eagerly(ranks):
    """The model-across layout: each member holds its heads' rows of q
    (one head of 2 a member), and ``compile()`` runs the step eagerly
    with the gloo/NCCL reason."""
    (r0, r1), _ = ranks
    assert tuple(r0["lm-model-across:piece"]) == (D_LM // 2, D_LM)
    source, reason = r0["lm-model-across:compile"]
    assert source == "eager"
    assert "gloo" in reason and "NCCL" in reason


def test_exact_integer_pattern_with_model_across_processes(ranks):
    """``dist_collective_worker.py``'s linear net (zero parameters,
    integer data, one SGD step at rate 1) over ``{"data": 2, "model":
    2}`` with the model axis across the processes and its weight cut
    over it: both processes hold bitwise the closed form."""
    (r0, r1), _ = ranks
    gx, gy = _linear_batch()
    d_w = (0.0 - gy).T @ gx / (LIN_BATCH * 2)
    d_b = (0.0 - gy).sum(axis=0) / (LIN_BATCH * 2)
    for r in (r0, r1):
        np.testing.assert_array_equal(r["lin:fc_weight"],
                                      -d_w.astype(np.float32))
        np.testing.assert_array_equal(r["lin:fc_bias"],
                                      -d_b.astype(np.float32))
        np.testing.assert_array_equal(r["lin:head"],
                                      np.zeros((LIN_BATCH, 2), np.float32))
    assert tuple(r0["lin:piece"]) == (1, LIN_FEAT)


def test_save_asked_for_inside_a_step_runs_at_its_end_on_every_process(
        ranks):
    """``save_state`` called inside a step over a mesh that spans
    processes (a preemption hook's) saves nothing then, and both
    processes write and commit it at the step's end, at the next
    update."""
    from mxnet_tpu_torch.checkpoint import layout
    (r0, r1), ckpt = ranks
    for r in (r0, r1):
        assert bool(r["mlp-zero:deferred_before"])
        assert int(r["mlp-zero:deferred_step"]) == STEPS + 1
    manifest = layout.read_manifest(layout.step_path(ckpt + "-deferred",
                                                     STEPS + 1))
    assert manifest["process_count"] == 2
    assert manifest["meta"]["num_update"] == STEPS + 1


@pytest.mark.parametrize("name", RESUMED)
def test_restore_into_the_same_processes_continues_bitwise(request, name):
    """Each process's share of a trainer's state, saved over processes
    and restored into a fresh trainer on the same layout (its own initial
    values and seed), takes the next step bitwise as the uninterrupted
    trainer does, on every process: Megatron's pieces within and across
    processes, ZeRO slices, int8 error-feedback residuals."""
    ranks = (request.getfixturevalue("four_ranks") if name.startswith("4p")
             else request.getfixturevalue("ranks")[0])
    for rank, r in enumerate(ranks):
        assert list(r[f"{name}:resume_diff"]) == [], (rank, name)


@pytest.mark.parametrize("policy", ["clock", "preempt"])
def test_fit_over_processes_saves_at_one_update(ranks, policy):
    """``fit`` with a checkpoint manager over processes: a clock policy
    that fires on one process only, and a preemption signal that reaches
    one process only, make both processes commit the same steps (each
    process's share, process 0 the manifest), and a preemption stops
    both at the same update."""
    from mxnet_tpu_torch.checkpoint import layout
    (r0, r1), ckpt = ranks
    for k in ("update", "steps"):
        a, b = r0[f"fit:{policy}:{k}"], r1[f"fit:{policy}:{k}"]
        assert a.tolist() == b.tolist(), (k, a, b)
    steps = r0[f"fit:{policy}:steps"].tolist()
    if policy == "clock":
        # the first ask arms process 0's clock; every later batch saves
        assert int(r0["fit:clock:update"]) == FIT_BATCHES
        assert steps == list(range(2, FIT_BATCHES + 1))
    else:
        # the signal at the second batch of the second epoch
        assert int(r0["fit:preempt:update"]) == FIT_BATCHES + 2
        assert steps == [FIT_BATCHES + 2]
        assert bool(r0["fit:preempt:flag"]) and bool(r1["fit:preempt:flag"])
    manifest = layout.read_manifest(layout.step_path(
        f"{ckpt}-fit-{policy}", steps[-1]))
    assert manifest["process_count"] == 2


def _ctx(p, i):
    """Member ``i`` of process ``p`` as this process (process 0) sees
    it."""
    from mxnet_tpu_torch.context import Context
    return Context("cpu", i, process=None if p == 0 else p)


# (axes, members as (process, index), this process's box, lines along
# each axis, the processes that hold data coordinate 1)
LAYOUTS = [
    ("data-across", {"data": 2, "model": 2},
     [(0, 0), (0, 1), (1, 0), (1, 1)], ((0, 1), (0, 2)),
     {"data": [[0, 1]], "model": [[0], [1]]}, (1,)),
    ("model-across", {"data": 2, "model": 2},
     [(0, 0), (1, 0), (0, 1), (1, 1)], ((0, 2), (0, 1)),
     {"data": [[0], [1]], "model": [[0, 1]]}, (0, 1)),
    ("four-processes", {"data": 2, "model": 2},
     [(0, 0), (1, 0), (2, 0), (3, 0)], ((0, 1), (0, 1)),
     {"data": [[0, 2], [1, 3]], "model": [[0, 1], [2, 3]]}, (2, 3)),
    ("second-process-first", {"data": 2, "model": 2},
     [(1, 0), (1, 1), (0, 0), (0, 1)], ((1, 2), (0, 2)),
     {"data": [[1, 0]], "model": [[0], [1]]}, (0,)),
    ("uneven", {"data": 3}, [(0, 0), (0, 1), (1, 0)], ((0, 2),),
     {"data": [[0, 1]]}, (0,)),
]


@pytest.mark.parametrize("axes,members,box,lines,holders",
                         [c[1:] for c in LAYOUTS],
                         ids=[c[0] for c in LAYOUTS])
def test_process_layout_boxes_and_lines(axes, members, box, lines,
                                        holders):
    """``ProcessLayout``: this process's box of the mesh, each axis's
    lines of processes in the order of their offsets, the processes that
    hold a data coordinate, the local mesh of this process's members."""
    from mxnet_tpu_torch.parallel import make_mesh
    from mxnet_tpu_torch.parallel.process_mesh import ProcessLayout
    mesh = make_mesh(axes, [_ctx(p, i) for p, i in members])
    pl = ProcessLayout(mesh, 0)
    assert pl.box == box
    for ax, want in lines.items():
        assert pl.lines(ax) == want, ax
        assert pl.spans(ax) == (box[pl.axes.index(ax)][1]
                                - box[pl.axes.index(ax)][0] < axes[ax])
    assert pl.holders("data", 1) == holders
    local = pl.local_mesh(mesh)
    assert local.members == [mesh.members[g] for g in pl.gidx]
    assert all(m.process is None for m in local.members)


@pytest.mark.parametrize("members,why", [
    ([(0, 0), (1, 0), (1, 1), (0, 1)], "do not form a box"),
    ([(0, 0), (0, 1), (1, 0), (2, 0)], "overlap"),
], ids=["not-a-box", "not-a-grid"])
def test_process_layout_refuses_what_is_no_grid_of_boxes(members, why):
    """A process whose members form no box of the mesh, and boxes that
    do not tile the mesh as a grid, are refused with the reason."""
    from mxnet_tpu_torch.base import MXNetError
    from mxnet_tpu_torch.parallel import make_mesh
    from mxnet_tpu_torch.parallel.process_mesh import ProcessLayout
    mesh = make_mesh({"data": 2, "model": 2},
                     [_ctx(p, i) for p, i in members])
    with pytest.raises(MXNetError, match=why):
        ProcessLayout(mesh, 0)


@pytest.mark.parametrize("where", ["four-members", "one-member"])
def test_checkpoint_of_two_processes_restores_in_one(ranks, where):
    """(viii): the ZeRO trainer's checkpoint, written by both processes
    (each its own slices, process 0 the manifest), restores in this
    process into a ZeRO trainer over 4 CPU members and into one member:
    parameters, Adam moments, the update count and the seed bitwise what
    the processes held."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import checkpoint
    from mxnet_tpu_torch.checkpoint import layout
    from mxnet_tpu_torch.parallel import ShardedTrainer, make_mesh
    (r0, r1), ckpt = ranks
    mgr = checkpoint.CheckpointManager(ckpt)
    step = mgr.latest_step()
    manifest = layout.read_manifest(mgr.step_path(step))
    assert manifest["process_count"] == 2
    files = {sh["file"] for e in manifest["arrays"].values()
             for sh in e["shards"]}
    assert any(f.endswith(".p1.bin") for f in files), sorted(files)[:6]
    assert checkpoint.verify_checkpoint(mgr.step_path(step))["arrays"] \
        == len(manifest["arrays"])
    n = 4 if where == "four-members" else 1
    with mx.name.NameManager():
        sym = _net("mlp", mx)
    tr = ShardedTrainer(sym, "adam", dict(OPT["adam"]), shard_optimizer=True,
                        mesh=make_mesh({"data": n},
                                       [mx.cpu(i) for i in range(n)]),
                        seed=99)
    tr.bind(*_shapes("mlp"))
    _, got_step = tr.restore_state(mgr)
    mgr.close()
    assert got_step == step == int(r0["mlp-zero:num_update"]) == STEPS
    assert tr._num_update == STEPS and tr._seed == 0
    for k, v in tr.get_params()[0].items():
        assert v.asnumpy().tobytes() == r0[f"mlp-zero:param:{k}"].tobytes()
    for k, leaves in tr.opt_state_by_param().items():
        for i, leaf in enumerate(leaves):
            want = r0[f"mlp-zero:opt:{k}:{i}"]
            assert want.tobytes() == r1[f"mlp-zero:opt:{k}:{i}"].tobytes()
            assert leaf.numpy().tobytes() == want.tobytes(), (k, i)


if __name__ == "__main__":
    sys.exit(worker_main())
