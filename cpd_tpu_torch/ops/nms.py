"""Rotated BEV NMS with fixed-size outputs, the axis-aligned NMS, the
class-agnostic and per-class NMS of the model's post-processing, and weighted
box fusion (port of cpd_tpu/ops/nms.py).

Ties in the top-k selections go lowest index first, as ``jax.lax.top_k``
orders them: every top-k here is a stable descending sort, sliced."""
from __future__ import annotations

import math

import torch

from .iou3d import boxes_aligned_iou_bev, boxes_iou_bev


def top_k(values, k: int):
    """(values, indices) of the k largest along the last axis, ties lowest
    index first."""
    v, i = torch.sort(values, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def _greedy_suppress(iou, valid, thresh):
    """iou (K, K) of score-sorted boxes, valid (K,) -> keep (K,) bool."""
    k = iou.shape[0]
    suppress = iou > thresh
    keep = torch.zeros(k, dtype=torch.bool, device=iou.device)
    suppressed = torch.zeros(k, dtype=torch.bool, device=iou.device)
    for i in range(k):
        is_kept = valid[i] & ~suppressed[i]
        keep[i] = is_kept
        row = suppress[i] & is_kept
        row[i] = False
        suppressed = suppressed | row
    return keep


def _fast_suppress(iou, valid, thresh):
    """Fast NMS: box i survives if no higher-scoring valid box overlaps it
    (suppressed boxes still suppress)."""
    k = iou.shape[0]
    j_lt_i = torch.triu(torch.ones((k, k), dtype=torch.bool, device=iou.device), diagonal=1)
    m = (iou > thresh) & j_lt_i & valid[:, None]
    return valid & ~torch.any(m, dim=0)


def nms_bev(boxes, scores, thresh, pre_max_size=1024, post_max_size=256, valid=None,
            fast=False):
    """Rotated-BEV NMS. boxes (N, 7+), scores (N,) -> (indices (post,),
    keep_mask (post,)); indices point into ``boxes``."""
    n = boxes.shape[0]
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=boxes.device)
    scores = torch.where(valid, scores, -math.inf)
    k = min(pre_max_size, n)
    top_scores, order = top_k(scores, k)
    top_valid = torch.isfinite(top_scores)
    top_boxes = boxes[order][:, :7]
    iou = boxes_iou_bev(top_boxes, top_boxes)
    suppress = _fast_suppress if fast else _greedy_suppress
    keep = suppress(iou, top_valid, thresh)
    keep_scores = torch.where(keep, top_scores, -math.inf)
    sel_scores, sel = top_k(keep_scores, min(post_max_size, k))
    return order[sel], torch.isfinite(sel_scores)


def nms_normal_bev(boxes, scores, thresh, pre_max_size=1024, post_max_size=256, valid=None):
    """NMS on the axis-aligned BEV footprints (``boxes_aligned_iou_bev``)."""
    n = boxes.shape[0]
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=boxes.device)
    scores = torch.where(valid, scores, -math.inf)
    k = min(pre_max_size, n)
    top_scores, order = top_k(scores, k)
    top_boxes = boxes[order][:, :7]
    keep = _greedy_suppress(boxes_aligned_iou_bev(top_boxes, top_boxes),
                            torch.isfinite(top_scores), thresh)
    sel_scores, sel = top_k(torch.where(keep, top_scores, -math.inf), min(post_max_size, k))
    return order[sel], torch.isfinite(sel_scores)


def class_agnostic_nms(box_scores, box_preds, nms_config, score_thresh=None, valid=None):
    """NMS over all classes at once under ``nms_config`` (NMS_THRESH,
    NMS_PRE_MAXSIZE, NMS_POST_MAXSIZE, USE_FAST_NMS) -> (indices, keep mask,
    scores of the kept boxes, 0 elsewhere)."""
    n = box_scores.shape[0]
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=box_scores.device)
    if score_thresh is not None:
        valid = valid & (box_scores >= score_thresh)
    idx, mask = nms_bev(box_preds, box_scores, thresh=nms_config["NMS_THRESH"],
                        pre_max_size=int(nms_config["NMS_PRE_MAXSIZE"]),
                        post_max_size=int(nms_config["NMS_POST_MAXSIZE"]), valid=valid,
                        fast=bool(nms_config.get("USE_FAST_NMS", False)))
    return idx, mask, torch.where(mask, box_scores[idx], 0.0)


def multi_classes_nms(cls_scores, box_preds, nms_config, score_thresh=None, valid=None):
    """Per-class NMS of (N, num_classes) scores -> (indices, masks, scores),
    each (num_classes, post_max): the class axis stays fixed."""
    outs = [class_agnostic_nms(cls_scores[:, c], box_preds, nms_config, score_thresh, valid)
            for c in range(cls_scores.shape[1])]
    return tuple(torch.stack([o[i] for o in outs]) for i in range(3))


def weighted_box_fusion(boxes, scores, labels, iou_thresh=0.7, valid=None):
    """Weighted Box Fusion with a circular-mean yaw (port of
    cpd_tpu/ops/nms.py::weighted_box_fusion; parity: model_nms_utils.py:14
    ``compute_WBF``). Greedy rotated NMS at ``iou_thresh`` picks the
    survivors; every valid box of a survivor's label whose rotated IoU with
    it is at least ``iou_thresh`` joins its cluster, and the survivor becomes
    the score-weighted mean of its cluster (yaw through the mean of sin and
    cos). Static shapes: boxes (N, 7+), scores (N,), labels (N,) ->
    (fused (N, 7), scores (N,), labels (N,), keep_mask (N,)), the survivors
    first in score order, zeros where ``keep_mask`` is False."""
    n = boxes.shape[0]
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=boxes.device)
    keep_idx, keep_mask = nms_bev(boxes, scores, thresh=iou_thresh, pre_max_size=n,
                                  post_max_size=n, valid=valid)
    iou = boxes_iou_bev(boxes[keep_idx][:, :7], boxes[:, :7])  # (K, N)
    same_label = labels[keep_idx][:, None] == labels[None, :]
    member = (iou >= iou_thresh) & valid[None, :] & keep_mask[:, None] & same_label
    w = torch.where(member, scores[None, :], 0.0)
    wn = w / torch.clamp(w.sum(dim=1, keepdim=True), min=1e-6)
    fused_xyzdim = wn @ boxes[:, :6]
    fused_yaw = torch.atan2(wn @ torch.sin(boxes[:, 6]), wn @ torch.cos(boxes[:, 6]))
    fused = torch.cat([fused_xyzdim, fused_yaw[:, None]], dim=-1)
    fused = torch.where(keep_mask[:, None], fused, 0.0)
    fused_scores = torch.where(keep_mask, scores[keep_idx], 0.0)
    fused_labels = torch.where(keep_mask, labels[keep_idx], 0)
    return fused, fused_scores, fused_labels, keep_mask
