"""Detection ops: anchor ``Proposal`` generation (rcnn pipeline support).

Counterpart of ``mxnet_tpu/ops/detection_ops.py``: the fixed-size
redesign of the reference's proposal op (``example/rcnn``), whose
post-NMS box count depends on the data.  Every stage has a static shape:
a pre-NMS top ``rpn_pre_nms_top_n``, an NMS of exactly
``rpn_post_nms_top_n`` steps with score masking, and a ``[B*K, 5]`` ROI
output whose unfilled slots are zero boxes with ``-inf`` scores.

The selection order is the JAX package's.  ``jax.lax.top_k`` keeps the
lower index first among equal scores, and every box the size filter drops
ties at ``-inf``; ``torch.topk`` promises no order among ties on CUDA, so
the pre-NMS top is a stable descending sort and a slice.  The NMS loop's
``argmax`` takes the first maximum in both packages.  Nothing is read on
the host: the loop has a fixed count, and an exhausted step is masked
with ``torch.where``, not skipped.  Outputs carry no gradient.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..base import MXNetError
from .registry import OpDef, OpParam, register_op

__all__ = ["generate_anchors", "bbox_transform_inv", "fixed_nms"]


def generate_anchors(feature_stride: int, scales, ratios, height: int,
                     width: int) -> np.ndarray:
    """All anchors for an H x W feature map: ``[H*W*A, 4]`` (x1,y1,x2,y2),
    A = len(scales) * len(ratios); the rcnn literature's base-anchor
    recipe (centered at each stride cell, area = (stride*scale)^2,
    aspect = ratio)."""
    base = float(feature_stride)
    anchors = []
    for r in ratios:
        for s in scales:
            area = (base * s) ** 2
            w = np.sqrt(area / r)
            h = w * r
            anchors.append([-w / 2, -h / 2, w / 2, h / 2])
    base_anchors = np.asarray(anchors, np.float32)        # [A, 4]
    sx = (np.arange(width) + 0.5) * feature_stride
    sy = (np.arange(height) + 0.5) * feature_stride
    cx, cy = np.meshgrid(sx, sy)                          # [H, W]
    centers = np.stack([cx, cy, cx, cy], axis=-1).reshape(-1, 1, 4)
    return (centers + base_anchors[None]).reshape(-1, 4).astype(np.float32)


def bbox_transform_inv(anchors, deltas):
    """Decode (dx, dy, dw, dh) deltas against anchors -> boxes
    (+1 width convention, exact identity for zero deltas); ``[..., N, 4]``
    deltas against ``[N, 4]`` anchors."""
    aw = anchors[..., 2] - anchors[..., 0] + 1.0
    ah = anchors[..., 3] - anchors[..., 1] + 1.0
    acx = anchors[..., 0] + 0.5 * (aw - 1.0)
    acy = anchors[..., 1] + 0.5 * (ah - 1.0)
    cx = deltas[..., 0] * aw + acx
    cy = deltas[..., 1] * ah + acy
    w = torch.exp(torch.clamp(deltas[..., 2], -10.0, 10.0)) * aw
    h = torch.exp(torch.clamp(deltas[..., 3], -10.0, 10.0)) * ah
    return torch.stack([cx - 0.5 * (w - 1.0), cy - 0.5 * (h - 1.0),
                        cx + 0.5 * (w - 1.0), cy + 0.5 * (h - 1.0)], dim=-1)


def _iou_one_many(box, boxes):
    """IoU of ``box [..., 4]`` with each of ``boxes [..., N, 4]``."""
    x1 = torch.maximum(box[..., 0, None], boxes[..., 0])
    y1 = torch.maximum(box[..., 1, None], boxes[..., 1])
    x2 = torch.minimum(box[..., 2, None], boxes[..., 2])
    y2 = torch.minimum(box[..., 3, None], boxes[..., 3])
    inter = (torch.clamp_min(x2 - x1 + 1, 0)
             * torch.clamp_min(y2 - y1 + 1, 0))
    a1 = ((box[..., 2] - box[..., 0] + 1)
          * (box[..., 3] - box[..., 1] + 1))[..., None]
    a2 = ((boxes[..., 2] - boxes[..., 0] + 1)
          * (boxes[..., 3] - boxes[..., 1] + 1))
    return inter / torch.clamp_min(a1 + a2 - inter, 1e-6)


def fixed_nms(boxes, scores, k: int, iou_threshold: float):
    """Fixed-output-size NMS: exactly ``k`` boxes out.

    ``k`` steps of select-argmax / suppress-overlaps over ``boxes [...,
    N, 4]`` and ``scores [..., N]`` (leading dims are independent
    images).  Returns ``(boxes [..., k, 4], scores [..., k])``; once every
    real candidate is consumed the remaining slots carry -inf scores and
    zero boxes.
    """
    neg_inf = torch.full((), -torch.inf, dtype=scores.dtype,
                         device=scores.device)
    ids = torch.arange(boxes.shape[-2], device=boxes.device)
    live = scores
    out_boxes, out_scores = [], []
    for _ in range(k):
        # gathers, not a 0-d tensor index (which reads it on the host)
        j = torch.argmax(live, dim=-1, keepdim=True)              # [..., 1]
        best = torch.gather(live, -1, j)[..., 0]
        box = torch.gather(boxes, -2, j[..., None].expand(
            j.shape + (4,)))[..., 0, :]
        valid = best > neg_inf
        out_boxes.append(torch.where(valid[..., None], box,
                                     torch.zeros_like(box)))
        out_scores.append(torch.where(valid, best, neg_inf))
        suppress = (_iou_one_many(box, boxes) > iou_threshold) | (ids == j)
        live = torch.where(valid[..., None] & suppress, neg_inf, live)
    return torch.stack(out_boxes, dim=-2), torch.stack(out_scores, dim=-1)


@functools.lru_cache(maxsize=32)
def _device_anchors(stride, scales, ratios, h, w, device):
    """:func:`generate_anchors` on ``device``, copied there once."""
    return torch.as_tensor(generate_anchors(stride, scales, ratios, h, w),
                           device=device)


def _proposal_fwd(ctx, params, cls_prob, bbox_pred, im_info):
    stride = params["feature_stride"]
    scales = params["scales"]
    ratios = params["ratios"]
    pre_n = params["rpn_pre_nms_top_n"]
    post_n = params["rpn_post_nms_top_n"]
    thresh = params["threshold"]
    min_size = params["rpn_min_size"]

    # proposals are sample selections, not differentiable outputs
    cls_prob, bbox_pred, im_info = (t.detach() for t in
                                    (cls_prob, bbox_pred, im_info))
    b, _, h, w = cls_prob.shape
    a = len(scales) * len(ratios)
    anchors = _device_anchors(stride, scales, ratios, h, w, cls_prob.device)
    # fg scores: channels [A:2A]; layout [A, H, W] -> [H*W*A]
    fg = cls_prob[:, a:].permute(0, 2, 3, 1).reshape(b, -1)
    deltas = bbox_pred.reshape(b, a, 4, h, w).permute(0, 3, 4, 1, 2)
    boxes = bbox_transform_inv(anchors, deltas.reshape(b, -1, 4))
    # clip to the image
    im_h, im_w = im_info[:, 0, None], im_info[:, 1, None]
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)
    boxes = torch.stack([
        torch.clamp(boxes[..., 0], zero, im_w - 1),
        torch.clamp(boxes[..., 1], zero, im_h - 1),
        torch.clamp(boxes[..., 2], zero, im_w - 1),
        torch.clamp(boxes[..., 3], zero, im_h - 1)], dim=-1)
    ws = boxes[..., 2] - boxes[..., 0] + 1
    hs = boxes[..., 3] - boxes[..., 1] + 1
    # min_size is in original-image pixels: scale by im_info[2] (the
    # resize factor), as the reference's proposal filter does
    min_sz = min_size * im_info[:, 2, None]
    keep = (ws >= min_sz) & (hs >= min_sz)
    fg = torch.where(keep, fg, torch.full((), -torch.inf, dtype=fg.dtype,
                                          device=fg.device))
    top = min(pre_n, fg.shape[1])
    top_scores, top_idx = torch.sort(fg, dim=-1, descending=True,
                                     stable=True)
    top_scores, top_idx = top_scores[:, :top], top_idx[:, :top]
    top_boxes = torch.gather(boxes, 1, top_idx[..., None].expand(b, top, 4))
    boxes, scores = fixed_nms(top_boxes, top_scores, post_n, thresh)
    batch_idx = torch.arange(b, dtype=boxes.dtype, device=boxes.device)
    batch_idx = batch_idx[:, None].expand(b, post_n).reshape(-1)
    rois = torch.cat([batch_idx[:, None], boxes.reshape(b * post_n, 4)],
                     dim=1)
    if params["output_score"]:
        return rois, scores.reshape(b * post_n)
    return rois


def _proposal_shape(params, in_shapes):
    cls, bbox, info = (list(in_shapes) + [None] * 3)[:3]
    if cls is None:
        outs = [None, None] if params["output_score"] else [None]
        return in_shapes, outs, []
    b, twoa, h, w = cls
    a = len(params["scales"]) * len(params["ratios"])
    if twoa != 2 * a:
        raise MXNetError(f"Proposal: cls_prob channels {twoa} != 2*A "
                         f"(A={a} from scales x ratios)")
    k = params["rpn_post_nms_top_n"]
    outs = ([(b * k, 5), (b * k,)] if params["output_score"]
            else [(b * k, 5)])
    return [tuple(cls), (b, 4 * a, h, w), (b, 3)], outs, []


register_op(OpDef(
    name="Proposal",
    forward=_proposal_fwd,
    arguments=("cls_prob", "bbox_pred", "im_info"),
    outputs=lambda p: (["output", "score"] if p["output_score"]
                       else ["output"]),
    params={
        "feature_stride": OpParam("feature_stride", "int", default=16),
        "scales": OpParam("scales", "floats", default=(8.0, 16.0, 32.0)),
        "ratios": OpParam("ratios", "floats", default=(0.5, 1.0, 2.0)),
        "rpn_pre_nms_top_n": OpParam("rpn_pre_nms_top_n", "int",
                                     default=512),
        "rpn_post_nms_top_n": OpParam("rpn_post_nms_top_n", "int",
                                      default=16),
        "threshold": OpParam("threshold", "float", default=0.7),
        "rpn_min_size": OpParam("rpn_min_size", "int", default=4),
        "output_score": OpParam("output_score", "bool", default=False),
    },
    infer_shape=_proposal_shape,
    doc="RPN proposal generation: decode anchor deltas, clip, fixed-K "
        "NMS -> [B*K, 5] rois (batch_idx, x1, y1, x2, y2).  All shapes "
        "static.",
))
