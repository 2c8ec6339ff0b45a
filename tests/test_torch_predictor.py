"""The deployment predictor of the PyTorch port (``Predictor``, ``create``,
``load_ndarray_file``, ``export_model``, ``load_exported`` in
``mxnet_tpu_torch/predictor.py``) against the JAX package's, on the CPU,
and the slice as a whole: records into ``fit``, then ``create``.

A small net with BatchNorm (an aux state), ReLU and a softmax head, with
seeded numpy weights, is saved as a legacy prefix and as a
``CheckpointManager`` directory by either package; ``create`` in both
packages reads each, and the outputs agree within rtol 1e-5 (f32
summation order of the convolution).  ``Predictor`` from a ``.params``
blob and with ``output_names`` (an internal layer) agrees likewise; an
Embedding net takes int token ids (``set_input`` keeps the bound dtype).
An exported artifact (``MXTPTEXP1``, the JAX package's JSON header, a
``torch.export`` program) serves in-process and in a subprocess that
poisons ``mxnet_tpu_torch`` and imports only torch, within rtol 1e-5 of
the ``Predictor`` (both run K1's plain version on the CPU); an int
input keeps its dtype.  A JAX artifact (``MXTPUEXP2``) is refused with a
message that names it, and the JAX package refuses the port's.

The slice: 24 images packed by the JAX package (``.raw``, 16x16) feed
``ShardedTrainer.fit`` for 2 batches of 12 through each package's
``ImageRecordIter`` (SGD with momentum, the same numpy weights); the
parameters agree within rtol 1e-4 (as the other trainer tests), and the
weights each package saved predict the same outputs through both
packages' ``predictor.create`` within rtol 1e-4.
"""
import json
import os
import struct
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu import checkpoint as jckpt
from mxnet_tpu import model as jmodel
from mxnet_tpu import predictor as jpred
from mxnet_tpu import random as jrandom
from mxnet_tpu import recordio as jrec
from mxnet_tpu import sym as jsym
from mxnet_tpu.base import MXNetError as JaxError
from mxnet_tpu.image_io import ImageRecordIter as JaxIter
from mxnet_tpu.parallel import ShardedTrainer as JaxTrainer, make_mesh

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch import checkpoint as tckpt
from mxnet_tpu_torch import model as tmodel
from mxnet_tpu_torch import predictor as tpred
from mxnet_tpu_torch import random as trandom
from mxnet_tpu_torch import sym as tsym
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.image_io import ImageRecordIter
from mxnet_tpu_torch.parallel import ShardedTrainer

RTOL, ATOL = 1e-5, 1e-6
SHAPE = (4, 3, 8, 8)


@pytest.fixture(autouse=True)
def _keep_random_state():
    """Executors and trainers draw from both packages' global generators:
    restore them for the test files that run after this one."""
    saved_j, saved_t = dict(jrandom._state), dict(trandom._state)
    gens = {d: g.get_state() for d, g in trandom._generators.items()}
    yield
    jrandom._state.update(saved_j)
    trandom._state.update(saved_t)
    for d in list(trandom._generators):
        if d in gens:
            trandom._generators[d].set_state(gens[d])
        else:
            del trandom._generators[d]


@pytest.fixture(autouse=True)
def on_cpu():
    with mxt.cpu():
        yield


def _net(S):
    d = S.Convolution(data=S.Variable("data"), num_filter=4, kernel=(3, 3),
                      pad=(1, 1), name="conv")
    d = S.BatchNorm(data=d, name="bn")
    d = S.Activation(data=d, act_type="relu", name="relu1")
    d = S.Pooling(data=d, kernel=(2, 2), stride=(2, 2), pool_type="max",
                  name="pool")
    d = S.FullyConnected(data=S.Flatten(data=d), num_hidden=5, name="fc")
    return S.SoftmaxOutput(data=d, name="softmax")


def _nets():
    with mx.name.NameManager(), mxt.name.NameManager():
        return _net(jsym), _net(tsym)


def _weights(net, seed=0):
    shapes, _, aux_shapes = net.infer_shape(data=SHAPE)
    rng = np.random.RandomState(seed)
    arg = {n: (0.3 * rng.randn(*s)).astype(np.float32)
           for n, s in zip(net.list_arguments(), shapes)
           if n not in ("data", "softmax_label")}
    aux = {n: (0.5 + rng.rand(*s)).astype(np.float32)
           for n, s in zip(net.list_auxiliary_states(), aux_shapes)}
    return arg, aux


def _save(writer, kind, path, net, arg, aux):
    """A checkpoint written by ``writer`` ("jax" or "port"); returns the
    source ``create`` reads."""
    pkg = {"jax": (jmodel, jckpt, mx.nd), "port": (tmodel, tckpt, mxt.nd)}
    model, ckpt, nd = pkg[writer]
    a = {k: nd.array(v) for k, v in arg.items()}
    x = {k: nd.array(v) for k, v in aux.items()}
    if kind == "legacy":
        model.save_checkpoint(path, 3, net, a, x)
        return path
    mgr = ckpt.CheckpointManager(path)
    mgr.save_model(3, net, a, x)
    mgr.close()
    return path


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("kind", ["legacy", "manifest"])
def test_create_matches_jax(tmp_path, writer, kind):
    jnet, tnet = _nets()
    arg, aux = _weights(tnet)
    src = _save(writer, kind, str(tmp_path / "m"),
                jnet if writer == "jax" else tnet, arg, aux)
    epoch = 3 if kind == "legacy" else None
    x = np.random.RandomState(1).rand(*SHAPE).astype(np.float32)
    t = tpred.create(src, epoch, {"data": SHAPE}, ctx=mxt.cpu())
    j = jpred.create(src, epoch, {"data": SHAPE}, ctx=mx.cpu())
    assert [i["source"] for i in t.aot_info] == ["eager"]
    assert t.num_outputs == 1       # before a forward (JAX's raises then)
    (tout,), (jout,) = t.predict(data=x), j.predict(data=x)
    assert t.num_outputs == j.num_outputs == 1
    np.testing.assert_allclose(tout, jout, rtol=RTOL, atol=ATOL)
    assert t.cache_stats().keys() == j.cache_stats().keys()


def test_predictor_blob_and_partial_outputs(tmp_path):
    jnet, tnet = _nets()
    arg, aux = _weights(tnet)
    prefix = _save("jax", "legacy", str(tmp_path / "m"), jnet, arg, aux)
    with open(f"{prefix}-symbol.json") as f:
        sjson = f.read()
    with open(f"{prefix}-0003.params", "rb") as f:
        blob = f.read()
    loaded = tpred.load_ndarray_file(blob)
    assert loaded.keys() == jpred.load_ndarray_file(blob).keys()
    x = np.random.RandomState(2).rand(*SHAPE).astype(np.float32)
    for names in (None, ["relu1", "fc"]):
        t = tpred.Predictor(sjson, blob, {"data": SHAPE}, ctx=mxt.cpu(),
                            output_names=names, warmup=False)
        j = jpred.Predictor(sjson, blob, {"data": SHAPE}, ctx=mx.cpu(),
                            output_names=names, warmup=False)
        t.set_input("data", x)
        t.forward()
        outs = [t.get_output(i) for i in range(t.num_outputs)]
        jouts = j.predict(data=x)
        assert len(outs) == len(jouts) == (1 if names is None else 2)
        for a, b in zip(outs, jouts):
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
    with pytest.raises(MXNetError):
        t.set_input("fc_weight", x)
    with pytest.raises(MXNetError):
        tpred.Predictor(sjson, blob, {"data": SHAPE}, ctx=mxt.cpu(),
                        output_names=["nope"])


def _emb_net(S):
    emb = S.Embedding(data=S.Variable("data"), input_dim=20, output_dim=6,
                      name="emb")
    fc = S.FullyConnected(data=S.Flatten(data=emb), num_hidden=3, name="fc")
    return S.SoftmaxOutput(data=fc, name="softmax")


def test_int_input(tmp_path):
    with mx.name.NameManager(), mxt.name.NameManager():
        jnet, tnet = _emb_net(jsym), _emb_net(tsym)
    rng = np.random.RandomState(3)
    arg = {"emb_weight": rng.randn(20, 6).astype(np.float32),
           "fc_weight": rng.randn(3, 24).astype(np.float32),
           "fc_bias": np.zeros(3, np.float32)}
    blob = {f"arg:{k}": v for k, v in arg.items()}
    ids = np.array([[1, 2, 3, 4], [19, 0, 7, 5]], np.int64)
    t = tpred.Predictor(tnet.tojson(), blob, {"data": (2, 4)}, ctx=mxt.cpu())
    j = jpred.Predictor(jnet.tojson(), blob, {"data": (2, 4)}, ctx=mx.cpu())
    (tout,), (jout,) = t.predict(data=ids), j.predict(data=ids)
    np.testing.assert_allclose(tout, jout, rtol=RTOL, atol=ATOL)
    out = str(tmp_path / "emb.mxtpt")
    tpred.export_model(tnet, arg, {}, {"data": (2, 4)}, out,
                       input_dtypes={"data": "int32"})
    exp = tpred.load_exported(out, device="cpu")
    assert exp.input_dtypes["data"] == np.dtype("int32")
    np.testing.assert_allclose(exp.predict(data=ids)[0], tout, rtol=RTOL,
                               atol=ATOL)


_SERVE = """
import sys
sys.modules["mxnet_tpu_torch"] = None   # any import of the port fails
sys.modules["mxnet_tpu"] = None
import io, json, struct
import numpy as np
import torch
from torch.export.passes import move_to_device_pass
with open({out!r}, "rb") as f:
    assert f.read(9) == b"MXTPTEXP1"
    (hlen,) = struct.unpack("<i", f.read(4))
    meta = json.loads(f.read(hlen).decode())
    program = torch.export.load(io.BytesIO(f.read()))
module = move_to_device_pass(program, "cpu").module()
x = torch.from_numpy(np.load({x!r}))
with torch.no_grad():
    (y,) = module(x)
np.save({y!r}, y.numpy())
print("served", meta["inputs"], meta["num_outputs"])
"""


def test_export_round_trip_without_the_port(tmp_path):
    jnet, tnet = _nets()
    arg, aux = _weights(tnet)
    out = str(tmp_path / "model.mxtpt")
    tpred.export_model(tnet, {k: mxt.nd.array(v) for k, v in arg.items()},
                       aux, {"data": SHAPE}, out)
    with open(out, "rb") as f:
        assert f.read(9) == b"MXTPTEXP1"
        (hlen,) = struct.unpack("<i", f.read(4))
        assert json.loads(f.read(hlen).decode()) == {
            "inputs": [["data", list(SHAPE), "float32"]], "num_outputs": 1}
    x = np.random.RandomState(4).rand(*SHAPE).astype(np.float32)
    blob = {f"arg:{k}": v for k, v in arg.items()}
    blob.update({f"aux:{k}": v for k, v in aux.items()})
    ref = tpred.Predictor(tnet.tojson(), blob, {"data": SHAPE},
                          ctx=mxt.cpu()).predict(data=x)[0]
    exp = tpred.load_exported(out, device="cpu")
    assert (exp.input_names, exp.num_outputs) == (["data"], 1)
    np.testing.assert_allclose(exp.predict(data=x)[0], ref, rtol=RTOL,
                               atol=ATOL)
    xp, yp = str(tmp_path / "x.npy"), str(tmp_path / "y.npy")
    np.save(xp, x)
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "-c",
                        _SERVE.format(out=out, x=xp, y=yp)],
                       capture_output=True, text=True, timeout=300,
                       cwd=str(tmp_path), env=env)
    assert r.returncode == 0, r.stderr
    assert "served" in r.stdout
    np.testing.assert_allclose(np.load(yp), ref, rtol=RTOL, atol=ATOL)


def test_artifacts_do_not_cross_packages(tmp_path):
    jnet, tnet = _nets()
    arg, aux = _weights(tnet)
    jout, tout = str(tmp_path / "j.mxtpu"), str(tmp_path / "t.mxtpt")
    jpred.export_model(jnet, {k: mx.nd.array(v) for k, v in arg.items()},
                       {k: mx.nd.array(v) for k, v in aux.items()},
                       {"data": SHAPE}, jout)
    tpred.export_model(tnet, arg, aux, {"data": SHAPE}, tout)
    with pytest.raises(MXNetError, match="JAX artifact.*MXTPUEXP2"):
        tpred.load_exported(jout, device="cpu")
    with pytest.raises(JaxError, match="not an exported model"):
        jpred.load_exported(tout)


N_REC, IMG_BATCH, CLASSES = 24, 12, 4


def _small_cnn(S):
    d = S.Convolution(data=S.Variable("data"), num_filter=4, kernel=(3, 3),
                      stride=(2, 2), pad=(1, 1), name="conv")
    d = S.Activation(data=d, act_type="relu")
    d = S.FullyConnected(data=S.Flatten(data=d), num_hidden=CLASSES,
                         name="fc")
    return S.SoftmaxOutput(data=d, name="softmax")


def test_records_fit_then_create_matches_jax(tmp_path):
    rng = np.random.RandomState(5)
    rec, idx = str(tmp_path / "d.rec"), str(tmp_path / "d.idx")
    w = jrec.MXIndexedRecordIO(idx, rec, "w")
    for i in range(N_REC):
        img = rng.randint(0, 255, (16, 16, 3)).astype(np.uint8)
        w.write_idx(i, jrec.pack_img((0, float(i % CLASSES), i, 0), img,
                                     img_fmt=".raw"))
    w.close()
    it_args = dict(path_imgrec=rec, path_imgidx=idx, data_shape=(3, 16, 16),
                   batch_size=IMG_BATCH, shuffle=True, rand_mirror=True,
                   scale=1.0 / 255)
    with mx.name.NameManager(), mxt.name.NameManager():
        jnet, tnet = _small_cnn(jsym), _small_cnn(tsym)
    shapes = ({"data": (IMG_BATCH, 3, 16, 16)},
              {"softmax_label": (IMG_BATCH,)})
    arg_shapes, _, _ = tnet.infer_shape(**shapes[0], **shapes[1])
    args = {n: (0.2 * rng.randn(*s)).astype(np.float32)
            for n, s in zip(tnet.list_arguments(), arg_shapes)
            if n not in ("data", "softmax_label")}
    opt = {"learning_rate": 0.1, "momentum": 0.9}
    jt = JaxTrainer(jnet, optimizer="sgd", optimizer_params=opt,
                    mesh=make_mesh({"data": 1}, jax.devices()[:1]))
    jt.bind(data_shapes=shapes[0], label_shapes=shapes[1],
            arg_params={k: jnp.asarray(v) for k, v in args.items()})
    tt = ShardedTrainer(tnet, optimizer="sgd", optimizer_params=opt,
                        device="cpu")
    tt.bind(*shapes, arg_params=args)
    jt.fit(JaxIter(**it_args), num_epoch=1)
    tt.fit(ImageRecordIter(**it_args), num_epoch=1)
    assert tt._num_update == 2
    jarg, jaux = jt.get_params()
    targ, taux = tt.get_params()
    for name in args:
        np.testing.assert_allclose(targ[name].asnumpy(),
                                   np.asarray(jarg[name].asnumpy()),
                                   rtol=1e-4, atol=1e-6, err_msg=name)
    jmodel.save_checkpoint(str(tmp_path / "j"), 1, jnet, jarg, jaux)
    tmodel.save_checkpoint(str(tmp_path / "t"), 1, tnet, targ, taux)
    x = rng.rand(IMG_BATCH, 3, 16, 16).astype(np.float32)
    outs = [pred.create(str(tmp_path / src), 1,
                        {"data": (IMG_BATCH, 3, 16, 16)}, ctx=ctx
                        ).predict(data=x)[0]
            for pred, ctx in ((tpred, mxt.cpu()), (jpred, mx.cpu()))
            for src in "tj"]
    for out in outs[1:]:
        np.testing.assert_allclose(out, outs[0], rtol=1e-4, atol=1e-6)
