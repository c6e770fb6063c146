"""ATSS anchor target assigner (port of cpd_tpu/models/atss.py).

Per gt, the ``topk`` anchors nearest by BEV centre distance are candidates;
an anchor takes a gt when its axis-aligned BEV IoU reaches the mean plus
the population standard deviation of the candidates' IoUs and its centre
lies inside the gt box; among the gts that accept it, the one of highest
IoU (the first on ties).
"""
from __future__ import annotations

import torch

from ..ops.fps import fused_norm
from ..ops.geometry import points_in_boxes_mask
from ..ops.iou3d import boxes_aligned_iou_bev
from ..ops.nms import top_k


def atss_assign(anchors, gt_boxes, gt_valid, topk: int = 9):
    """anchors (A, 7+), gt_boxes (G, 8), gt_valid (G,) -> {"labels": (A,)
    int32 gt index or -1, "max_iou": (A,) the IoU with that gt, -1 where
    none accepts the anchor}."""
    a = anchors.shape[0]
    iou = boxes_aligned_iou_bev(anchors[:, :7], gt_boxes[:, :7])  # (A, G)
    iou = torch.where(gt_valid[None, :], iou, -1.0)
    dist = fused_norm(anchors[:, None, :2] - gt_boxes[None, :, :2])
    dist = torch.where(gt_valid[None, :], dist, float("inf"))
    _, cand = top_k(-dist.T, min(topk, a))  # (G, k), ties to the lower anchor
    cand_iou = torch.gather(iou.T, 1, cand)
    thr = cand_iou.mean(dim=1) + cand_iou.std(dim=1, correction=0)
    # the anchors' z is the mean over every gt row, the invalid ones included
    centres = torch.cat([anchors[:, :2], gt_boxes[:, 2].mean() * anchors.new_ones((a, 1))], dim=1)
    inside = points_in_boxes_mask(centres, gt_boxes[:, :7])  # (G, A)
    ok = (iou.T >= thr[:, None]) & inside & gt_valid[:, None]
    iou_masked = torch.where(ok.T, iou, -1.0)
    best_iou = iou_masked.amax(dim=1)
    best_gt = iou_masked.argmax(dim=1)  # the first of equal maxima, as jnp.argmax
    labels = torch.where(best_iou > 0, best_gt.to(torch.int32), -1)
    return {"labels": labels, "max_iou": best_iou}
