"""The model zoo of the PyTorch port (``mxnet_tpu_torch/models``) against
the JAX package's, on the CPU.

* All ten zoo names build in both packages under a fresh NameManager to
  the same symbol JSON (names and attributes), and ``infer_shape`` at
  their full input shapes gives the same argument, output and aux shapes.
* The image nets run forward and backward through ``simple_bind`` at
  small inputs (batch 2; alexnet 67x67, vgg 32x32, googlenet and
  inception-bn 64x64, inception-bn-28-small 28x28) with the same numpy
  weights carried across by name; Dropout's masks are supplied by the
  test in both packages (the JAX side patched in this process only).
  In float32, outputs agree within atol 1e-5 and gradients within 1e-4
  of each array's largest magnitude (f32 convolution summation order
  differs between XLA and ATen).  The BatchNorm nets are ill-conditioned
  in f32 at random weights: single-pass batch statistics over 18-69
  BatchNorm layers put each package's first-layer gradients 0.1-1.8 %
  from a float64 run of the same net, and rounding flips near-ties of
  their max-pooling windows, which moves single elements of a gradient
  by up to its size.  So there the f32 outputs agree within atol 1e-4
  and each gradient's difference has at most 5e-2 of its L2 norm (3.4 %
  measured); moving statistics agree within rtol 1e-4 and the outputs'
  atol in every case.  The same nets also run in float64 on both sides, where
  outputs and gradients agree within 1e-9 of the largest magnitude.  A bias of a
  convolution that feeds a BatchNorm has an exact gradient of 0; both
  packages hold rounding noise there, checked to stay below 1e-3 of the
  convolution weight's largest gradient.
* One ``ShardedTrainer`` step (SGD, momentum 0.9, wd 1e-4, the guard) on
  googlenet and on alexnet (masks supplied) equals the JAX trainer's:
  heads within atol 1e-5, parameters within rtol 1e-4, atol 1e-6 (as
  ``tests/test_torch_trainer.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import models as jmodels
from mxnet_tpu import random as jrandom
from mxnet_tpu.parallel import ShardedTrainer as JaxTrainer, make_mesh

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch import models as tmodels
from mxnet_tpu_torch.ops import nn_ops as tnn
from mxnet_tpu_torch.parallel import ShardedTrainer

FULL = {
    "mlp": ((784,), {}),
    "lenet": ((1, 28, 28), {}),
    "inception-bn-28-small": ((3, 28, 28), {}),
    "resnet-28-small": ((3, 28, 28), {}),
    "resnet": ((3, 224, 224), {}),
    "inception-bn": ((3, 224, 224), {}),
    "googlenet": ((3, 224, 224), {}),
    "alexnet": ((3, 224, 224), {}),
    "vgg": ((3, 224, 224), {}),
    "transformer-lm": (None, {}),
}
SMALL = {
    "alexnet": (3, 67, 67),
    "vgg": (3, 32, 32),
    "googlenet": (3, 64, 64),
    "inception-bn": (3, 64, 64),
    "inception-bn-28-small": (3, 28, 28),
}
BATCH = 2
CLASSES = 10
OPT = {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4}


@pytest.fixture(autouse=True)
def _keep_jax_random_state():
    saved = dict(jrandom._state)
    yield
    jrandom._state.update(saved)


@pytest.fixture(autouse=True)
def on_cpu():
    with mxt.cpu():
        yield


def _mask(shape, keep):
    seed = int(np.prod(shape)) % (1 << 31)
    return np.random.RandomState(seed).uniform(size=shape) < keep


@pytest.fixture
def supplied_masks(monkeypatch):
    """Both packages' Dropout draws replaced by one mask per shape."""
    monkeypatch.setattr(jax.random, "bernoulli",
                        lambda key, k, s: jnp.asarray(_mask(tuple(s), k)))
    monkeypatch.setattr(tnn, "dropout_mask",
                        lambda x, k, g: torch.as_tensor(
                            _mask(tuple(x.shape), k), device=x.device))


def _build(name, **kw):
    with mx.name.NameManager(), mxt.name.NameManager():
        return jmodels.get_symbol(name, **kw), tmodels.get_symbol(name, **kw)


@pytest.mark.parametrize("name", sorted(FULL))
def test_zoo_symbols_and_full_shapes_match_jax(name):
    image, kw = FULL[name]
    j, t = _build(name, **kw)
    assert t.tojson() == j.tojson()
    assert t.list_arguments() == j.list_arguments()
    assert t.list_outputs() == j.list_outputs()
    assert t.list_auxiliary_states() == j.list_auxiliary_states()
    shapes = ({"data": (8, 64), "softmax_label": (8, 64)} if image is None
              else {"data": (64,) + image, "softmax_label": (64,)})
    tj = j.infer_shape(**shapes)
    tt = t.infer_shape(**shapes)
    for got, want in zip(tt, tj):
        assert [tuple(s) for s in got] == [tuple(s) for s in want]


def _weights(sym, image, seed=0):
    """He-scaled numpy weights by name (BatchNorm gamma 1, the rest 0)."""
    arg_shapes, _, aux_shapes = sym.infer_shape(
        data=(BATCH,) + image, softmax_label=(BATCH,))
    rng = np.random.RandomState(seed)
    args = {}
    for n, s in zip(sym.list_arguments(), arg_shapes):
        if n in ("data", "softmax_label"):
            continue
        if n.endswith("_weight"):
            fan_in = int(np.prod(s[1:]))
            args[n] = (rng.randn(*s) * np.sqrt(2.0 / fan_in)) \
                .astype(np.float32)
        elif n.endswith("_gamma"):
            args[n] = (1.0 + 0.1 * rng.randn(*s)).astype(np.float32)
        else:
            args[n] = (0.01 * rng.randn(*s)).astype(np.float32)
    aux = {n: (np.ones(s, np.float32) if n.endswith("var")
               else np.zeros(s, np.float32))
           for n, s in zip(sym.list_auxiliary_states(), aux_shapes)}
    return args, aux


def _batch(image, seed=1):
    rng = np.random.RandomState(seed)
    return (rng.rand(BATCH, *image).astype(np.float32),
            rng.randint(0, CLASSES, BATCH).astype(np.float32))


BN_NETS = ("inception-bn", "inception-bn-28-small")
# (output atol, gradient tolerance of the largest magnitude) per dtype and
# kind of net: see the module docstring
TOLS = {("float32", False): (1e-5, 1e-4), ("float32", True): (1e-4, 5e-2),
        ("float64", True): (1e-9, 1e-9)}
FWD_BWD = sorted([(n, "float32") for n in SMALL]
                 + [(n, "float64") for n in BN_NETS])


@pytest.mark.parametrize("name,dtype", FWD_BWD)
def test_zoo_forward_backward_matches_jax(name, dtype, supplied_masks):
    image = SMALL[name]
    j, t = _build(name, num_classes=CLASSES)
    out_tol, grad_tol = TOLS[(dtype, name in BN_NETS)]
    args, aux = ({n: v.astype(dtype) for n, v in d.items()}
                 for d in _weights(t, image))
    x, y = (v.astype(dtype) for v in _batch(image))
    shapes = {"data": (BATCH,) + image, "softmax_label": (BATCH,)}
    types = {n: dtype for n in t.list_arguments()}
    jex = j.simple_bind(mx.cpu(), type_dict=types, **shapes)
    tex = t.simple_bind(mxt.cpu(), type_dict=types, **shapes)
    for ex in (jex, tex):
        ex.copy_params_from(args, aux)
    jo = jex.forward(is_train=True, data=x, softmax_label=y)[0].asnumpy()
    to = tex.forward(is_train=True, data=x, softmax_label=y)[0].asnumpy()
    assert to.dtype == jo.dtype == np.dtype(dtype)
    np.testing.assert_allclose(to, jo, rtol=0, atol=out_tol,
                               err_msg="output")
    jex.backward()
    tex.backward()
    for n in args:
        jg, tg = jex.grad_dict[n].asnumpy(), tex.grad_dict[n].asnumpy()
        if name in BN_NETS and n.startswith("convolution") \
                and n.endswith("_bias"):
            scale = np.abs(jex.grad_dict[n[:-5] + "_weight"]
                           .asnumpy()).max()
            assert max(np.abs(jg).max(), np.abs(tg).max()) < 1e-3 * scale
            continue
        if (dtype, name in BN_NETS) == ("float32", True):
            gap = np.linalg.norm(tg - jg) / max(np.linalg.norm(jg), 1e-12)
            assert gap <= grad_tol, (n, gap)
            continue
        np.testing.assert_allclose(tg, jg, rtol=0,
                                   atol=grad_tol * max(np.abs(jg).max(),
                                                       1e-8),
                                   err_msg=f"grad {n}")
    for n in aux:
        np.testing.assert_allclose(tex.aux_dict[n].asnumpy(),
                                   jex.aux_dict[n].asnumpy(), rtol=1e-4,
                                   atol=out_tol, err_msg=f"aux {n}")


@pytest.mark.parametrize("name", ["googlenet", "alexnet"])
def test_trainer_step_matches_jax(name, supplied_masks):
    image = SMALL[name]
    j, t = _build(name, num_classes=CLASSES)
    args, aux = _weights(t, image)
    shapes = dict(data_shapes={"data": (BATCH,) + image},
                  label_shapes={"softmax_label": (BATCH,)})
    jt = JaxTrainer(j, optimizer="sgd", optimizer_params=dict(OPT),
                    mesh=make_mesh({"data": 1}, jax.devices()[:1]),
                    guard=True)
    jt.bind(arg_params={k: jnp.asarray(v) for k, v in args.items()},
            aux_params={k: jnp.asarray(v) for k, v in aux.items()},
            **shapes)
    tt = ShardedTrainer(t, optimizer="sgd", optimizer_params=dict(OPT),
                        guard=True, device="cpu")
    tt.bind(arg_params=args, aux_params=aux, **shapes)
    x, y = _batch(image)
    batch = {"data": x, "softmax_label": y}
    np.testing.assert_allclose(tt.step(batch)[0].numpy(),
                               np.asarray(jt.step(batch)[0]), rtol=0,
                               atol=1e-5, err_msg="heads")
    (jargs, jaux), (targs, taux) = jt.get_params(), tt.get_params()
    for n in jargs:
        np.testing.assert_allclose(targs[n].asnumpy(), jargs[n].asnumpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=n)
    for n in jaux:
        np.testing.assert_allclose(taux[n].asnumpy(), jaux[n].asnumpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=n)
