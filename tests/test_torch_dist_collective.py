"""The collective tier of the PyTorch port across processes
(``parallel/dist.py``, meshes that span processes, ``ShardedTrainer``
over them) against the JAX package, after ``tests/test_dist_collective.py``.

One run of 2 processes over gloo (this file as the program: ``python
tests/test_torch_dist_collective.py``), each process with 2 CPU members
(``init_distributed(device=[cpu(0), cpu(1)])``), a global data mesh of 4:

* a raw process-group sum of the global vector 0..15 is exactly 120;
* ``dist_collective_worker.py``'s linear net (zero parameters, integer
  data, one SGD step at rate 1) aggregates exactly: its parameters are
  bitwise the closed form on both processes, and bitwise the JAX
  ``ShardedTrainer``'s over 4 virtual devices of this process on the same
  global batch; each process's heads are its rows of the JAX heads;
* a BatchNorm net with a ``batch``-normalized softmax head and a global
  head (a ``sum`` over the batch) takes 2 SGD steps: the batch moments,
  the normalization's count and the global head meet across processes,
  and the global head's gradient crosses back through the links.  Both
  processes hold bitwise the same parameters and moving statistics;
  against the JAX trainer over 4 devices: parameters and moving
  statistics rtol 1e-4 / atol 1e-6, heads rtol 1e-5 / atol 1e-5 (the
  summation order of the process-group reduction differs from XLA's).

In this process: the backend rule, the environment the rendezvous needs,
and the refusals by name over a mesh that spans processes.
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

GLOBAL_BATCH, FEAT = 8, 3
BN_BATCH, BN_IN, BN_STEPS = 16, 5, 2
PARAM = dict(rtol=1e-4, atol=1e-6)
HEAD = dict(rtol=1e-5, atol=1e-5)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _linear_net(S):
    net = S.FullyConnected(data=S.Variable("data"), num_hidden=2, name="fc")
    return S.LinearRegressionOutput(data=net, label=S.Variable("lro_label"),
                                    name="lro")


def _linear_batch():
    gx = np.arange(GLOBAL_BATCH * FEAT, dtype=np.float32).reshape(
        GLOBAL_BATCH, FEAT)
    gy = (np.arange(GLOBAL_BATCH * 2, dtype=np.float32).reshape(
        GLOBAL_BATCH, 2) % 5) - 2
    return gx, gy


def _bn_net(S):
    d = S.Variable("data")
    h = S.FullyConnected(data=d, num_hidden=6, name="fc1")
    h = S.BatchNorm(data=h, name="bn1")
    h = S.Activation(data=h, act_type="relu", name="relu1")
    h = S.FullyConnected(data=h, num_hidden=3, name="fc2")
    soft = S.SoftmaxOutput(data=h, normalization="batch", name="softmax")
    total = S.MakeLoss(S.sum(S.square(h), name="sq_sum") * 0.01, name="glob")
    return S.Group([soft, total])


def _bn_state(net):
    shapes = {"data": (BN_BATCH, BN_IN), "softmax_label": (BN_BATCH,)}
    arg_shapes, _, aux_shapes = net.infer_shape(**shapes)
    rng = np.random.RandomState(5)
    args = {n: (0.4 * rng.randn(*s)).astype(np.float32)
            for n, s in zip(net.list_arguments(), arg_shapes)
            if n not in shapes}
    aux = {n: (np.ones(s, np.float32) if n.endswith("var")
               else np.zeros(s, np.float32))
           for n, s in zip(net.list_auxiliary_states(), aux_shapes)}
    return args, aux


def _bn_batches():
    rng = np.random.RandomState(6)
    out = []
    for _ in range(BN_STEPS):
        x = rng.randn(BN_BATCH, BN_IN).astype(np.float32)
        x[:BN_BATCH // 2] += 2.0   # the first process's rows differ
        out.append({"data": x, "softmax_label": rng.randint(
            0, 3, BN_BATCH).astype(np.float32)})
    return out


# ---------------------------------------------------------------------------
# the program of each process
# ---------------------------------------------------------------------------

def worker_main() -> int:
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.parallel import (ShardedTrainer, collectives, dist,
                                          make_mesh)
    dist.init_distributed(device=[mx.cpu(0), mx.cpu(1)])
    rank, out = dist.process_index(), {}
    assert dist.process_count() == 2
    local = torch.arange(8, dtype=torch.float64) + 8 * rank
    out["raw_sum"] = collectives.allreduce_processes([local])[0].sum().item()
    mesh = make_mesh({"data": -1})
    assert mesh.size == 4 and mesh.processes == [0, 0, 1, 1]
    out["backend"] = np.array(dist.backend())

    tr = ShardedTrainer(_linear_net(mx.symbol), mesh=mesh, optimizer="sgd",
                        optimizer_params={"learning_rate": 1.0})
    tr.bind({"data": (GLOBAL_BATCH, FEAT)},
            {"lro_label": (GLOBAL_BATCH, 2)})
    tr.set_params({n: np.zeros(tuple(v.shape), np.float32)
                   for n, v in tr._params.items()})
    gx, gy = _linear_batch()
    rows = slice(4 * rank, 4 * rank + 4)
    out["lin_head"] = tr.step({"data": gx[rows],
                               "lro_label": gy[rows]})[0].numpy()
    for n, v in tr.get_params()[0].items():
        out[f"lin:{n}"] = v.asnumpy()

    net = _bn_net(mx.symbol)
    args, aux = _bn_state(net)
    tr = ShardedTrainer(net, mesh=mesh, optimizer="sgd",
                        optimizer_params={"learning_rate": 0.1})
    tr.bind({"data": (BN_BATCH, BN_IN)}, {"softmax_label": (BN_BATCH,)},
            arg_params=args, aux_params=aux)
    half = BN_BATCH // 2
    for step, b in enumerate(_bn_batches()):
        heads = tr.step({k: v[half * rank:half * (rank + 1)]
                         for k, v in b.items()})
        for q, h in enumerate(heads):
            out[f"bn_head{q}:{step}"] = h.numpy()
    arg, auxp = tr.get_params()
    for n, v in list(arg.items()) + list(auxp.items()):
        out[f"bn:{n}"] = v.asnumpy()
    np.savez(os.path.join(os.environ["COLL_TEST_OUT"], f"rank{rank}.npz"),
             **out)
    dist.shutdown()
    return 0


# ---------------------------------------------------------------------------
# in this process
# ---------------------------------------------------------------------------

def test_backend_follows_the_layout():
    from mxnet_tpu_torch.parallel.dist import choose_backend
    one_each = [[("h", "gpu", 0)], [("h", "gpu", 1)]]
    assert choose_backend(one_each) == "nccl"
    assert choose_backend([[("h", "gpu", 0)], [("g", "gpu", 0)]]) == "nccl"
    # two processes on one card: NCCL refuses that layout
    assert choose_backend([[("h", "gpu", 0)], [("h", "gpu", 0)]]) == "gloo"
    assert choose_backend([[("h", "cpu", 0)], [("h", "cpu", 0)]]) == "gloo"
    assert choose_backend([[("h", "gpu", 0), ("h", "gpu", 1)],
                           [("h", "gpu", 2)]]) == "gloo"


def test_init_distributed_needs_its_environment(monkeypatch):
    from mxnet_tpu_torch.base import MXNetError
    from mxnet_tpu_torch.parallel import dist
    for v in ("MXTPU_COORDINATOR", "MXTPU_NUM_PROC", "MXTPU_PROC_ID",
              "MXTPU_WATCHDOG"):
        monkeypatch.delenv(v, raising=False)
    with pytest.raises(MXNetError, match="MXTPU_COORDINATOR"):
        dist.init_distributed(device="cpu")
    # the watchdog needs an address: MXTPU_WATCHDOG or the coordinator's
    # (tests/test_torch_watchdog.py starts it over two processes)
    with pytest.raises(MXNetError, match="watchdog requires MXTPU_WATCHDOG "
                                         "or a coordinator address"):
        dist.init_distributed(device="cpu", watchdog=True)
    monkeypatch.setenv("MXTPU_WATCHDOG", "127.0.0.1:1")
    with pytest.raises(MXNetError, match="MXTPU_COORDINATOR"):
        dist.init_distributed(device="cpu")
    assert not dist.is_initialized()
    assert (dist.process_index(), dist.process_count(), dist.backend()) == \
        (0, 1, None)


def test_refusals_over_processes_name_what_is_missing():
    """Over a mesh whose other members belong to another process, what
    is still refused says why: members of one process that do not form a
    box of the mesh, ``grad_compression`` beside a seq axis across the
    processes, and ``compile()``, which runs such a trainer eagerly.
    (Another split axis, compressed gradients, ZeRO, sharding rules and
    ``save_state`` over processes train in
    ``tests/test_torch_process_meshes.py``.)"""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.base import MXNetError
    from mxnet_tpu_torch.context import Context
    from mxnet_tpu_torch.parallel import ShardedTrainer, make_mesh
    here = [mx.cpu(0), mx.cpu(1)]
    there = [Context("cpu", 0, process=1), Context("cpu", 1, process=1)]
    net = _linear_net(mx.symbol)
    mesh = make_mesh({"data": 4}, here + there)
    assert mesh.spans_processes and mesh.processes == [0, 0, 1, 1]
    with pytest.raises(MXNetError, match="belongs|member of process 1"):
        _ = there[0].torch_device
    tr = ShardedTrainer(net, mesh=mesh)
    assert tr._devices == [here[0].torch_device] * 2
    assert (tr._ndata, tr._dcoord, tr._shard_n) == (4, [0, 1], 2)
    why = tr._uncapturable()
    assert "runs eagerly" in why and "gloo" in why and "NCCL" in why
    # the model axis across the processes: this process's box holds
    # model coordinate 0 of both data coordinates
    tr = ShardedTrainer(net, mesh=make_mesh(
        {"data": 2, "model": 2}, [here[0], there[0], here[1], there[1]]))
    assert (tr._ndata, tr._dcoord, tr._rep_members) == (2, [0, 1], [0, 1])
    with pytest.raises(MXNetError, match="do not form a box"):
        ShardedTrainer(net, mesh=make_mesh(
            {"data": 2, "model": 2}, [here[0], there[0], there[1], here[1]]))
    with pytest.raises(MXNetError, match="'seq' axis"):
        ShardedTrainer(net, grad_compression="int8", mesh=make_mesh(
            {"data": 2, "seq": 2}, [here[0], there[0], here[1], there[1]]))


# ---------------------------------------------------------------------------
# the 2-process run
# ---------------------------------------------------------------------------

def _jax_trainer(net_fn, shapes, args=None, aux=None, lr=0.1):
    import jax
    import jax.numpy as jnp
    import mxnet_tpu as jmx
    from mxnet_tpu.parallel import ShardedTrainer as JaxTrainer
    from mxnet_tpu.parallel import make_mesh as jmake_mesh
    jt = JaxTrainer(net_fn(jmx.symbol), optimizer="sgd",
                    optimizer_params={"learning_rate": lr},
                    mesh=jmake_mesh({"data": 4}, jax.devices()[:4]))
    jt.bind(*shapes,
            arg_params=None if args is None else
            {k: jnp.asarray(v) for k, v in args.items()},
            aux_params=None if aux is None else
            {k: jnp.asarray(v) for k, v in aux.items()})
    return jt


@pytest.fixture
def two_processes(tmp_path):
    port = _free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, MXTPU_COORDINATOR=f"127.0.0.1:{port}",
                   MXTPU_NUM_PROC="2", MXTPU_PROC_ID=str(rank),
                   COLL_TEST_OUT=str(tmp_path), PYTHONPATH=_ROOT)
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
    return [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(2)]


def test_two_processes_match_the_closed_form_and_jax(two_processes):
    import jax
    import mxnet_tpu as jmx
    r0, r1 = two_processes
    assert r0["raw_sum"] == r1["raw_sum"] == 120.0
    assert str(r0["backend"]) == str(r1["backend"]) == "gloo"
    for k in r0:
        if not k.startswith(("lin_head", "bn_head")):
            assert r0[k].tobytes() == r1[k].tobytes(), k

    # the linear net: the closed form, and the JAX trainer on 4 devices
    gx, gy = _linear_batch()
    d_w = (0.0 - gy).T @ gx / (GLOBAL_BATCH * 2)
    d_b = (0.0 - gy).sum(axis=0) / (GLOBAL_BATCH * 2)
    np.testing.assert_array_equal(r0["lin:fc_weight"],
                                  -d_w.astype(np.float32))
    np.testing.assert_array_equal(r0["lin:fc_bias"],
                                  -d_b.astype(np.float32))
    jt = _jax_trainer(_linear_net, ({"data": (GLOBAL_BATCH, FEAT)},
                                    {"lro_label": (GLOBAL_BATCH, 2)}),
                      lr=1.0)
    jt.set_params({n: np.zeros(v.shape, np.float32)
                   for n, v in jt._params.items()})
    jh = np.asarray(jax.device_get(jt.step({"data": gx,
                                            "lro_label": gy})[0]))
    np.testing.assert_array_equal(np.concatenate([r0["lin_head"],
                                                  r1["lin_head"]]), jh)
    for n, v in jt.get_params()[0].items():
        np.testing.assert_array_equal(r0[f"lin:{n}"], v.asnumpy())

    # the BatchNorm net with the global head
    with jmx.name.NameManager():
        args, aux = _bn_state(_bn_net(jmx.symbol))
    jt = _jax_trainer(_bn_net, ({"data": (BN_BATCH, BN_IN)},
                                {"softmax_label": (BN_BATCH,)}), args, aux)
    half = BN_BATCH // 2
    for step, b in enumerate(_bn_batches()):
        jheads = [np.asarray(jax.device_get(h)) for h in jt.step(b)]
        np.testing.assert_allclose(
            np.concatenate([r0[f"bn_head0:{step}"], r1[f"bn_head0:{step}"]]),
            jheads[0], **HEAD)
        assert r0[f"bn_head0:{step}"].shape[0] == half
        for r in (r0, r1):   # the global head: the global batch's value
            np.testing.assert_allclose(r[f"bn_head1:{step}"], jheads[1],
                                       **HEAD)
    jarg, jaux = jt.get_params()
    for n, v in list(jarg.items()) + list(jaux.items()):
        np.testing.assert_allclose(r0[f"bn:{n}"], v.asnumpy(), **PARAM,
                                   err_msg=n)
    # the moving mean is the global batch's (the processes' rows differ)
    assert not np.allclose(r0["bn:bn1_moving_mean"], 0.0, atol=1e-3)


if __name__ == "__main__":
    sys.exit(worker_main())
