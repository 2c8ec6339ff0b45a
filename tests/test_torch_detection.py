"""Detection ops of the PyTorch port (``Proposal`` in
``mxnet_tpu_torch/ops/detection_ops.py``, ``ROIPooling`` in
``mxnet_tpu_torch/ops/nn_ops.py``) against the JAX package's, on the CPU.

``generate_anchors`` is bitwise the JAX function's.  ``bbox_transform_inv``
agrees within rtol 1e-6, atol 1e-5 (XLA's and ATen's ``exp`` may differ
in the last bit, on coordinates up to ~100).  The selections of
``fixed_nms`` and ``Proposal`` are exact: the scores carry ties
(quantized to quarters) and some boxes fall to the size filter (they tie
at ``-inf``), so the pre-NMS order among ties and the first-maximum rule
of the NMS loop are tested; the chosen scores are bitwise equal and the
boxes within the decode's tolerance, with and without ``output_score``.
``ROIPooling``'s forward is bitwise the JAX op's (corners rounded half to
even, empty bins 0, out-of-image corners), and its gradient, over data
with tied maxima, splits equally among the ties exactly as JAX's
``reduce_max`` does, also when the windows are made a chunk of rois at a
time.  ``Proposal`` feeding ``ROIPooling`` and the
detector graph of ``examples/rcnn_detection.py`` (RPN, ``Proposal``,
``ROIPooling``, head; the same numpy weights in both packages, not the
JAX package's global PRNG) give the same rois (batch indices exact,
corners within rtol 1e-5, atol 1e-4: the convolutions behind the deltas
sum in another order), pooled features and head output (rtol 1e-5), and
the backward through ``ROIPooling`` reaches the backbone with the same
gradients (rtol 1e-4).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu import random as jrandom
from mxnet_tpu import sym as jsym
from mxnet_tpu.ops import detection_ops as jdet
from mxnet_tpu.ops import registry as jreg

import mxnet_tpu_torch as mxt
import torch
from mxnet_tpu_torch import random as trandom
from mxnet_tpu_torch import sym as tsym
from mxnet_tpu_torch.ops import detection_ops as tdet
from mxnet_tpu_torch.ops import registry as treg

BOX_TOL = dict(rtol=1e-6, atol=1e-5)
# the detector's deltas come out of convolutions whose f32 summation order
# differs between XLA and ATen (~1e-6 relative), which the decode's exp
# carries into the box corners
GRAPH_BOX_TOL = dict(rtol=1e-5, atol=1e-4)
# examples/rcnn_detection.py's geometry at a reduced batch
IMG, STRIDE, FEAT, K, BATCH = 64, 4, 16, 8, 2
SCALES, RATIOS = (3.0, 5.0), (1.0,)
A = len(SCALES) * len(RATIOS)


@pytest.fixture(autouse=True)
def _keep_random_state():
    """Executors draw from both packages' global generators: restore them
    for the test files that run after this one in the same process."""
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


@pytest.mark.parametrize("args", [(16, (8.0, 16.0, 32.0), (0.5, 1.0, 2.0),
                                   3, 5), (4, SCALES, RATIOS, FEAT, FEAT)])
def test_generate_anchors_equal(args):
    t, j = tdet.generate_anchors(*args), jdet.generate_anchors(*args)
    assert t.dtype == j.dtype and t.tobytes() == j.tobytes()


def test_bbox_transform_inv_matches_jax():
    rng = np.random.RandomState(0)
    anchors = jdet.generate_anchors(4, SCALES, RATIOS, 6, 6)
    deltas = (rng.randn(len(anchors), 4) * 2).astype(np.float32)
    deltas[:3, 2:] = 15.0                       # clipped at exp(10)
    t = tdet.bbox_transform_inv(torch.tensor(anchors), torch.tensor(deltas))
    j = jdet.bbox_transform_inv(jnp.asarray(anchors), jnp.asarray(deltas))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **BOX_TOL)


def test_fixed_nms_selection_equal_with_ties():
    rng = np.random.RandomState(1)
    xy = rng.randint(0, 40, (30, 2)).astype(np.float32)
    wh = rng.randint(4, 20, (30, 2)).astype(np.float32)
    boxes = np.concatenate([xy, xy + wh], axis=1)
    scores = (np.round(rng.rand(30) * 4) / 4).astype(np.float32)
    scores[[3, 9, 20]] = -np.inf
    for k in (5, 40):                            # 40: past every box
        tb, ts = tdet.fixed_nms(torch.tensor(boxes), torch.tensor(scores),
                                k, 0.3)
        jb, js = jdet.fixed_nms(jnp.asarray(boxes), jnp.asarray(scores),
                                k, 0.3)
        assert ts.numpy().tobytes() == np.asarray(js).tobytes()
        assert tb.numpy().tobytes() == np.asarray(jb).tobytes()


def _proposal_inputs(seed=0, b=BATCH, h=6, w=6):
    rng = np.random.RandomState(seed)
    cls = (np.round(rng.rand(b, 2 * A, h, w) * 4) / 4).astype(np.float32)
    bbox = (rng.randn(b, 4 * A, h, w) * 0.5).astype(np.float32)
    bbox[:, 2::4, :2] = -6.0           # tiny widths: dropped by size
    info = np.array([[24, 24, 1.0], [24, 20, 1.5]], np.float32)[:b]
    return cls, bbox, info


@pytest.mark.parametrize("output_score", [False, True])
def test_proposal_matches_jax(output_score):
    raw = dict(feature_stride=4, scales=SCALES, ratios=RATIOS,
               rpn_pre_nms_top_n=40, rpn_post_nms_top_n=K, threshold=0.5,
               rpn_min_size=2, output_score=output_score)
    jop, top = jreg.get_op("Proposal"), treg.get_op("Proposal")
    ins = _proposal_inputs()
    jo = jop.forward(jreg.OpContext(), jop.parse_params(raw),
                     *map(jnp.asarray, ins))
    to = top.forward(treg.OpContext(), top.parse_params(raw),
                     *map(torch.tensor, ins))
    if not output_score:
        jo, to = (jo,), (to,)
    assert len(to) == len(jo) == 1 + output_score
    t_rois, j_rois = to[0].numpy(), np.asarray(jo[0])
    assert t_rois.shape == (BATCH * K, 5)
    assert t_rois[:, 0].tobytes() == j_rois[:, 0].tobytes()
    np.testing.assert_allclose(t_rois, j_rois, **BOX_TOL)
    if output_score:
        assert to[1].numpy().tobytes() == np.asarray(jo[1]).tobytes()
    assert not any(t.requires_grad for t in to)


def _roi_pooling_against_jax():
    """ROIPooling's forward and gradient over tied maxima, against the
    JAX op, bitwise."""
    rng = np.random.RandomState(2)
    data = np.round(rng.rand(2, 3, 8, 8) * 3).astype(np.float32)   # ties
    rois = np.array([[0, 0, 0, 15, 15], [1, 3.5, 2.5, 20, 9],
                     [0, 10, 10, 10, 10], [1, -4, -4, 40, 40],
                     [0, 30, 30, 31, 31], [1.9, 5, 1, 12, 14]], np.float32)
    raw = dict(pooled_size=(3, 3), spatial_scale=0.5)
    jop, top = jreg.get_op("ROIPooling"), treg.get_op("ROIPooling")

    def jf(d):
        return jop.forward(jreg.OpContext(), jop.parse_params(raw), d,
                           jnp.asarray(rois))

    jo, vjp = jax.vjp(jf, jnp.asarray(data))
    g = rng.rand(*jo.shape).astype(np.float32)
    jg = np.asarray(vjp(jnp.asarray(g))[0])
    td = torch.tensor(data, requires_grad=True)
    to = top.forward(treg.OpContext(), top.parse_params(raw), td,
                     torch.tensor(rois))
    to.backward(torch.tensor(g))
    assert to.shape == (6, 3, 3, 3)
    assert to.detach().numpy().tobytes() == np.asarray(jo).tobytes()
    assert not to.detach().numpy()[4].any()        # outside the image: 0
    assert td.grad.numpy().tobytes() == jg.tobytes()
    # the first roi's bins hold tied maxima (4 levels over 4x4 windows):
    # their cotangent is split, so some gradient is a fraction of one
    first = td.grad.numpy()[0]
    assert np.any((first > 0) & (first < g[0].min()))


def test_roi_pooling_forward_and_tied_gradient():
    _roi_pooling_against_jax()


@pytest.mark.parametrize("rois_a_chunk", [1, 4])
def test_roi_pooling_in_chunks_matches_jax(monkeypatch, rois_a_chunk):
    """The windows made a chunk of rois at a time (recomputed in the
    backward) give the one-pass bits: forward and tied gradient."""
    from mxnet_tpu_torch.ops import nn_ops
    monkeypatch.setattr(nn_ops, "ROI_POOL_CHUNK_ELEMS",
                        rois_a_chunk * 3 * 3 * 3 * 8 * 8)
    _roi_pooling_against_jax()


def _rpn_feats(S, b):
    """``examples/rcnn_detection.py``'s backbone and RPN heads."""
    data = S.Variable("data")
    f = S.Convolution(data=data, num_filter=16, kernel=(3, 3), stride=(2, 2),
                      pad=(1, 1), name="c1")
    f = S.Activation(data=f, act_type="relu")
    f = S.Convolution(data=f, num_filter=32, kernel=(3, 3), stride=(2, 2),
                      pad=(1, 1), name="c2")
    f = S.Activation(data=f, act_type="relu")
    f = S.Convolution(data=f, num_filter=32, kernel=(3, 3), stride=(1, 1),
                      pad=(1, 1), name="c3")
    feat = S.Activation(data=f, act_type="relu")
    r = S.Convolution(data=feat, num_filter=32, kernel=(5, 5),
                      stride=(1, 1), pad=(2, 2), name="rpn_conv")
    r = S.Activation(data=r, act_type="relu")
    cls = S.Convolution(data=r, num_filter=2 * A, kernel=(1, 1),
                        name="rpn_cls")
    bbox = S.Convolution(data=r, num_filter=4 * A, kernel=(1, 1),
                         name="rpn_bbox")
    return cls, bbox, feat


def detector(S, b):
    """``examples/rcnn_detection.py``'s ``build_detector``."""
    cls, bbox, feat = _rpn_feats(S, b)
    cls_prob = S.Reshape(
        data=S.SoftmaxActivation(data=S.Reshape(
            data=cls, shape=(b, 2, A * FEAT * FEAT)), mode="channel"),
        shape=(b, 2 * A, FEAT, FEAT))
    rois = S.Proposal(cls_prob=cls_prob, bbox_pred=bbox,
                      im_info=S.Variable("im_info"), feature_stride=STRIDE,
                      scales=SCALES, ratios=RATIOS, rpn_pre_nms_top_n=128,
                      rpn_post_nms_top_n=K, threshold=0.7, rpn_min_size=4,
                      name="proposal")
    pooled = S.ROIPooling(data=feat, rois=rois, pooled_size=(4, 4),
                          spatial_scale=1.0 / STRIDE, name="roi_pool")
    fc = S.FullyConnected(data=S.Flatten(data=pooled), num_hidden=32,
                          name="rcls_fc")
    fc = S.Activation(data=fc, act_type="relu")
    head = S.FullyConnected(data=fc, num_hidden=2, name="rcls")
    out = S.SoftmaxOutput(data=head, label=S.Variable("roi_label"),
                          name="rcnn_cls")
    return S.Group([out, rois, pooled])


def test_detector_graph_matches_jax():
    with mx.name.NameManager(), mxt.name.NameManager():
        jnet, tnet = detector(jsym, BATCH), detector(tsym, BATCH)
    assert tnet.tojson() == jnet.tojson()
    shapes = {"data": (BATCH, 1, IMG, IMG), "im_info": (BATCH, 3),
              "roi_label": (BATCH * K,)}
    arg_shapes, out_shapes, _ = tnet.infer_shape(**shapes)
    assert (arg_shapes, out_shapes) == jnet.infer_shape(**shapes)[:2]
    rng = np.random.RandomState(3)
    args = {n: (0.2 * rng.randn(*s)).astype(np.float32)
            for n, s in zip(tnet.list_arguments(), arg_shapes)
            if n not in shapes}
    x = rng.rand(BATCH, 1, IMG, IMG).astype(np.float32)
    info = np.array([[IMG, IMG, 1.0]] * BATCH, np.float32)
    outs = []
    for net, ctx in ((jnet, mx.cpu()), (tnet, mxt.cpu())):
        ex = net.simple_bind(ctx, grad_req="write", **shapes)
        for n, v in args.items():
            ex.arg_dict[n][:] = v
        ex.arg_dict["data"][:] = x
        ex.arg_dict["im_info"][:] = info
        ex.arg_dict["roi_label"][:] = np.arange(BATCH * K) % 2
        ex.forward(is_train=True)
        ex.backward()
        outs.append([o.asnumpy() for o in ex.outputs]
                    + [ex.grad_dict["rcls_fc_weight"].asnumpy(),
                       ex.grad_dict["c3_weight"].asnumpy()])
    (jo, jr, jp, jgf, jgc), (to, tr, tp, tgf, tgc) = outs
    assert tr[:, 0].tobytes() == jr[:, 0].tobytes()
    np.testing.assert_allclose(tr, jr, **GRAPH_BOX_TOL)
    np.testing.assert_allclose(tp, jp, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(to, jo, rtol=1e-5, atol=1e-6)
    # the backward runs through ROIPooling into the backbone
    np.testing.assert_allclose(tgf, jgf, rtol=1e-4,
                               atol=1e-5 * np.abs(jgf).max())
    np.testing.assert_allclose(tgc, jgc, rtol=1e-4,
                               atol=1e-5 * np.abs(jgc).max())
    assert np.abs(tgc).max() > 0
