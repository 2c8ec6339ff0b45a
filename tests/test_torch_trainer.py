"""ShardedTrainer of the PyTorch port (mxnet_tpu_torch/parallel/trainer.py)
against the JAX package's, on the CPU.

Both trainers get the same symbol (built by each package under a fresh
NameManager, so names match), the same numpy parameters and aux states,
the same batches, SGD with momentum 0.9 and wd 1e-4 (non-uniform
effective wd: gamma/beta/bias get 0, so the fused path takes the wd
vector), the guard on and global-norm clip 0.5 (tight enough to bind),
and the JAX side a one-device mesh.  Step 3 of 4 poisons one pixel with
NaN: both trainers must skip it.  After each step the heads, parameters
and BatchNorm moving statistics agree within

* heads: atol 1e-5 (softmax probabilities; f32 conv/matmul summation
  order differs between XLA and ATen);
* parameters and moving statistics: rtol 1e-4, atol 1e-6 (the same
  summation-order differences, carried through four updates and the
  clip multiplier).

Labels are float32 and parameters float32 on both sides (importing
mxnet_tpu enables x64).
"""
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu import models as jmodels
from mxnet_tpu import symbol as jsym
from mxnet_tpu.parallel import ShardedTrainer as JaxTrainer, make_mesh

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch import models as tmodels
from mxnet_tpu_torch import symbol as tsym
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.parallel import ShardedTrainer

# the modules (each package's `models.resnet` attribute is the function)
jresnet = sys.modules["mxnet_tpu.models.resnet"]
tresnet = sys.modules["mxnet_tpu_torch.models.resnet"]

BATCH = 8
OPT = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}
CLIP = 0.5
POISONED = 2


def _bottleneck_net(S, R):
    """3x3 conv stem, the 3x3 stride-2 max pool (ceil convention: 14 ->
    8), a projecting and an identity bottleneck unit, global pool,
    classifier."""
    net = R._bn_relu_conv(S.Variable("data"), 8, (3, 3), (1, 1), (1, 1))
    net = S.Pooling(data=net, pool_type="max", kernel=(3, 3), stride=(2, 2),
                    pad=(1, 1))
    net = R._bottleneck_unit(net, 16, (2, 2), dim_match=False)
    net = R._bottleneck_unit(net, 16, (1, 1), dim_match=True)
    net = S.Pooling(data=net, pool_type="avg", kernel=(7, 7),
                    global_pool=True, name="global_pool")
    net = S.Flatten(data=net)
    net = S.FullyConnected(data=net, num_hidden=10, name="fc1")
    return S.SoftmaxOutput(data=net, name="softmax")


NETS = {
    "resnet_cifar_n1": (lambda: jmodels.resnet_cifar(num_classes=10, n=1),
                        lambda: tmodels.resnet_cifar(num_classes=10, n=1),
                        (3, 12, 12)),
    "bottleneck_maxpool": (lambda: _bottleneck_net(jsym, jresnet),
                           lambda: _bottleneck_net(tsym, tresnet),
                           (3, 14, 14)),
}


def _build(make):
    with mx.name.NameManager(), mxt.name.NameManager():
        return make()


def _numpy_state(sym, image, seed=0):
    shapes, _, aux_shapes = sym.infer_shape(data=(BATCH,) + image,
                                            softmax_label=(BATCH,))
    rng = np.random.RandomState(seed)
    args = {}
    for n, s in zip(sym.list_arguments(), shapes):
        if n in ("data", "softmax_label"):
            continue
        if n.endswith("_gamma"):
            args[n] = (1.0 + 0.1 * rng.randn(*s)).astype(np.float32)
        else:
            args[n] = (0.2 * rng.randn(*s)).astype(np.float32)
    aux = {}
    for n, s in zip(sym.list_auxiliary_states(), aux_shapes):
        aux[n] = (rng.rand(*s).astype(np.float32) if n.endswith("var")
                  else (0.1 * rng.randn(*s)).astype(np.float32))
    return args, aux


def _batches(image, n=4, seed=1):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        data = rng.rand(BATCH, *image).astype(np.float32)
        if i == POISONED:
            data[0, 0, 0, 0] = np.nan
        out.append({"data": data, "softmax_label":
                    rng.randint(0, 10, BATCH).astype(np.float32)})
    return out


def _pair(net, fused=None):
    jmake, tmake, image = NETS[net]
    jnet, tnet = _build(jmake), _build(tmake)
    assert jnet.list_arguments() == tnet.list_arguments()
    args, aux = _numpy_state(tnet, image)
    jt = JaxTrainer(jnet, optimizer="sgd", optimizer_params=dict(OPT),
                    mesh=make_mesh({"data": 1}, jax.devices()[:1]),
                    guard=True, clip_global_norm=CLIP)
    jt.bind(data_shapes={"data": (BATCH,) + image},
            label_shapes={"softmax_label": (BATCH,)},
            arg_params={k: jnp.asarray(v) for k, v in args.items()},
            aux_params={k: jnp.asarray(v) for k, v in aux.items()})
    tt = ShardedTrainer(tnet, optimizer="sgd", optimizer_params=dict(OPT),
                        guard=True, clip_global_norm=CLIP,
                        fused_update=fused, device="cpu")
    tt.bind(data_shapes={"data": (BATCH,) + image},
            label_shapes={"softmax_label": (BATCH,)},
            arg_params=args, aux_params=aux)
    return jt, tt, image


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("net", sorted(NETS))
def test_trainer_matches_jax_over_steps_and_poisoned_step(net, fused):
    jt, tt, image = _pair(net, fused)
    assert tt._fused == fused
    if fused:
        assert tt._flat_wd is not None          # the wd-vector fused path
    for si, batch in enumerate(_batches(image)):
        before = {n: v.asnumpy() for n, v in tt.get_params()[0].items()}
        before_aux = {n: v.asnumpy() for n, v in tt.get_params()[1].items()}
        jh = jt.step(batch)
        th = tt.step(batch)
        jargs, jaux = jt.get_params()
        targs, taux = tt.get_params()
        if si == POISONED:
            assert not np.isfinite(th[0].numpy()).all()
            for n, v in targs.items():         # the guard skipped the step
                assert v.asnumpy().tobytes() == before[n].tobytes(), n
            for n, v in taux.items():
                assert v.asnumpy().tobytes() == before_aux[n].tobytes(), n
        else:
            np.testing.assert_allclose(th[0].numpy(), np.asarray(jh[0]),
                                       rtol=0, atol=1e-5,
                                       err_msg=f"heads, step {si}")
        for n in jargs:
            np.testing.assert_allclose(targs[n].asnumpy(),
                                       jargs[n].asnumpy(), rtol=1e-4,
                                       atol=1e-6, err_msg=f"{n}, step {si}")
        for n in jaux:
            np.testing.assert_allclose(taux[n].asnumpy(), jaux[n].asnumpy(),
                                       rtol=1e-4, atol=1e-6,
                                       err_msg=f"{n}, step {si}")
    assert int(tt._guard_state["skipped"]) == 1
    assert int(np.asarray(jt._guard_state["skipped"])) == 1
    # the clip bound: the mean effective norm of the steps taken is above it
    mean_norm = (float(tt._guard_state["norm_sum"])
                 / int(tt._guard_state["norm_cnt"]))
    assert mean_norm > CLIP
    np.testing.assert_allclose(
        mean_norm, float(np.asarray(jt._guard_state["norm_sum"]))
        / int(np.asarray(jt._guard_state["norm_cnt"])), rtol=1e-4)


def test_forward_matches_jax_in_eval_mode():
    jt, tt, image = _pair("bottleneck_maxpool")
    batch = _batches(image, n=1)[0]
    np.testing.assert_allclose(tt.forward(batch)[0].numpy(),
                               np.asarray(jt.forward(batch)[0]),
                               rtol=0, atol=1e-5)


def test_default_rescale_and_wd_mult_rules():
    _, tt, _ = _pair("resnet_cifar_n1")
    assert tt._rescale_grad == 1.0 / BATCH
    assert tt._wd_mult["fc1_weight"] == 1.0
    assert tt._wd_mult["fc1_bias"] == 0.0
    assert tt._wd_mult["batchnorm0_gamma"] == 0.0
    # the flat wd vector holds wd * wd_mult per parameter segment
    vals = set(np.unique(tt._flat_wd.numpy()).tolist())
    assert vals == {0.0, float(np.float32(1e-4))}


def test_initializer_draws_from_the_seeded_generator():
    s = _build(NETS["resnet_cifar_n1"][1])

    def params(seed):
        tr = ShardedTrainer(s, device="cpu", seed=seed)
        tr.bind({"data": (2, 3, 8, 8)}, {"softmax_label": (2,)})
        return tr.get_params()

    (a, aa), (b, _), (c, _) = params(0), params(0), params(1)
    w = "convolution0_weight"
    assert a[w].asnumpy().tobytes() == b[w].asnumpy().tobytes()
    assert a[w].asnumpy().tobytes() != c[w].asnumpy().tobytes()
    assert np.abs(a[w].asnumpy()).max() <= 0.07          # Uniform(0.07)
    assert (a["batchnorm0_gamma"].asnumpy() == 1).all()
    assert (a["fc1_bias"].asnumpy() == 0).all()
    assert (aa["batchnorm0_moving_var"].asnumpy() == 1).all()
    assert (aa["batchnorm0_moving_mean"].asnumpy() == 0).all()


def test_set_params_writes_through_to_the_fused_buffer():
    _, tt, _ = _pair("resnet_cifar_n1")
    w = tt.get_params()[0]["fc1_weight"].asnumpy()
    tt.set_params({"fc1_weight": w + 1.0})
    got = tt.get_params()[0]["fc1_weight"].asnumpy()
    np.testing.assert_array_equal(got, w + 1.0)
    off = tt._fused_plan.offsets["fc1_weight"]
    np.testing.assert_array_equal(
        tt._flat_w[off:off + w.size].numpy(), (w + 1.0).reshape(-1))


def test_unported_options_and_device_resolution():
    s = _build(NETS["resnet_cifar_n1"][1])
    for kw in ({"grad_accum": 2}, {"shard_optimizer": True},
               {"matmul_precision": "bfloat16"},
               {"grad_compression": "int8"},
               {"loss_scale": "dynamic"}, {"mesh": object()},
               {"guard": True, "guard_params": {"window": 8}}):
        with pytest.raises(MXNetError, match="not ported"):
            ShardedTrainer(s, device="cpu", **kw)
    tr = ShardedTrainer(s, device="cpu")
    with pytest.raises(MXNetError, match="not ported"):
        tr.fit(None)
    with pytest.raises(MXNetError, match="bind"):
        tr.step({})
    if not torch.cuda.is_available():
        # entry points run on the card by default, and never fall back
        with pytest.raises(MXNetError, match="CUDA is not available"):
            ShardedTrainer(s)
