"""Rotated BEV NMS with fixed-size outputs (port of cpd_tpu/ops/nms.py::nms_bev).

Ties in the top-k selections go lowest index first, as ``jax.lax.top_k``
orders them: every top-k here is a stable descending sort, sliced."""
from __future__ import annotations

import math

import torch

from .iou3d import boxes_iou_bev


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
