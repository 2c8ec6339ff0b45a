"""Symbol layer of the PyTorch port (mxnet_tpu_torch/symbol.py, name.py,
attribute.py, models/resnet.py) against the JAX package's.

The graphs are built by each package under a fresh NameManager; then
argument names, auxiliary-state names, inferred shapes, topological order
and the JSON text must be equal, and each package must load the other's
JSON back to the same text.  Everything here is exact (names, shapes and
strings; no arithmetic).
"""
import numpy as np
import pytest

import mxnet_tpu as mx
from mxnet_tpu import models as jmodels
from mxnet_tpu import symbol as jsym

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch import models as tmodels
from mxnet_tpu_torch import symbol as tsym
from mxnet_tpu_torch.base import MXNetError


def _both(jmake, tmake):
    with mx.name.NameManager(), mxt.name.NameManager():
        return jmake(), tmake()


NETS = {
    "resnet50": (lambda: jmodels.get_symbol("resnet", num_classes=1000,
                                            depth=50),
                 lambda: tmodels.get_symbol("resnet", num_classes=1000,
                                            depth=50),
                 (64, 3, 224, 224)),
    "resnet101": (lambda: jmodels.resnet(num_classes=100, depth=101),
                  lambda: tmodels.resnet(num_classes=100, depth=101),
                  (2, 3, 64, 64)),
    "resnet_cifar": (lambda: jmodels.get_symbol("resnet-28-small",
                                                num_classes=10, n=2),
                     lambda: tmodels.get_symbol("resnet-28-small",
                                                num_classes=10, n=2),
                     (8, 3, 32, 32)),
}


@pytest.mark.parametrize("net", sorted(NETS))
def test_names_and_shapes_equal_jax(net):
    jmake, tmake, dshape = NETS[net]
    j, t = _both(jmake, tmake)
    assert t.list_arguments() == j.list_arguments()
    assert t.list_auxiliary_states() == j.list_auxiliary_states()
    assert t.list_outputs() == j.list_outputs()
    assert [n.name for n in t._topo()] == [n.name for n in j._topo()]
    kw = dict(data=dshape, softmax_label=(dshape[0],))
    assert t.infer_shape(**kw) == j.infer_shape(**kw)
    assert t.infer_type(data=np.float32) == j.infer_type(data=np.float32)


def test_resnet50_at_224():
    with mxt.name.NameManager():
        t = tmodels.get_symbol("resnet", num_classes=1000, depth=50)
    args, outs, aux = t.infer_shape(data=(64, 3, 224, 224),
                                    softmax_label=(64,))
    shapes = dict(zip(t.list_arguments(), args))
    assert outs == [(64, 1000)]
    assert shapes["fc1_weight"] == (1000, 2048)
    n_params = sum(int(np.prod(s)) for n, s in shapes.items()
                   if n not in ("data", "softmax_label"))
    assert n_params == 25557032
    assert len(aux) == 2 * 53                      # 53 BatchNorms
    # the stem max pool keeps the reference's ceil convention: 112 -> 57
    internals = t.get_internals()
    _, int_shapes, _ = internals.infer_shape(data=(1, 3, 224, 224),
                                             softmax_label=(1,))
    pool = dict(zip(internals.list_outputs(), int_shapes))["pooling0_output"]
    assert pool == (1, 64, 57, 57)


@pytest.mark.parametrize("net", ["resnet50", "resnet_cifar"])
def test_json_is_shared_with_jax(net):
    jmake, tmake, _ = NETS[net]
    j, t = _both(jmake, tmake)
    text = t.tojson()
    assert text == j.tojson()
    assert jsym.load_json(text).tojson() == text
    assert tsym.load_json(j.tojson()).tojson() == text
    assert tsym.load_json(text).list_arguments() == j.list_arguments()


def test_naming_scopes_and_attributes():
    with mx.name.NameManager(), mxt.name.NameManager():
        with mx.name.Prefix("a_"), mxt.name.Prefix("a_"):
            with mx.AttrScope(lr_mult="0.5"), \
                    mxt.attribute.AttrScope(lr_mult="0.5"):
                jw = jsym.Variable("w", wd_mult=0.0, shape=(3, 4))
                tw = tsym.Variable("w", wd_mult=0.0, shape=(3, 4))
            j = jsym.FullyConnected(jsym.Variable("x"), weight=jw,
                                    num_hidden=3)
            t = tsym.FullyConnected(tsym.Variable("x"), weight=tw,
                                    num_hidden=3)
        j = (j + 1.0) * j - j / 2.0
        t = (t + 1.0) * t - t / 2.0
    assert t.list_arguments() == j.list_arguments() == [
        "x", "w", "a_fullyconnected0_bias"]
    assert t.attr_dict() == j.attr_dict()
    assert t.tojson() == j.tojson()
    opt = mxt.optimizer.create("sgd", sym=t)
    assert opt.lr_mult == {"w": 0.5} and opt.wd_mult == {"w": 0.0}


def test_compose_and_group():
    with mx.name.NameManager(), mxt.name.NameManager():
        jd, td = jsym.Variable("data"), tsym.Variable("data")
        jf = jsym.Activation(jsym.Variable("z"), act_type="relu")
        tf = tsym.Activation(tsym.Variable("z"), act_type="relu")
        jc = jf(z=jsym.Flatten(jd))
        tc = tf(z=tsym.Flatten(td))
        jg = jsym.Group([jc, jsym.Flatten(jd, name="f2")])
        tg = tsym.Group([tc, tsym.Flatten(td, name="f2")])
    assert tg.list_arguments() == jg.list_arguments() == ["data"]
    assert tg.list_outputs() == jg.list_outputs()
    assert tg.tojson() == jg.tojson()
    with pytest.raises(MXNetError, match="no variable named"):
        tf(q=td)


def test_unported_entry_points_raise():
    with pytest.raises(MXNetError, match="not ported"):
        tmodels.get_symbol("inception-bn")
    t = tmodels.resnet_cifar(n=1)
    with pytest.raises(MXNetError, match="not ported"):
        t.simple_bind(None, data=(1, 3, 8, 8))
    with pytest.raises(ValueError, match="unknown network"):
        tmodels.get_symbol("no-such-net")
