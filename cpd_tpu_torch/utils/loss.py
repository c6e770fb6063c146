"""Losses of the training path (port of cpd_tpu/utils/loss.py): plain
functions over batched tensors with validity masks. Weights and masks make
padding slots contribute exactly zero, and masked rows are made finite
BEFORE they are computed on (``sanitize_boxes``), so that neither the sum
nor its gradient can pick up an inf or a NaN from a row that does not count.

A batch-wide normaliser (a count of positives, of masked objects) is a count
over the GLOBAL batch under data parallelism
(``utils.collective.global_sum``), as under the JAX package's ``pjit``:
each rank's loss is then its share of the global loss.
"""
from __future__ import annotations

import math

import torch

from ..ops.geometry import boxes_to_corners_3d
from .collective import global_sum


def safe_norm(x, dim: int = -1, eps: float = 1e-9):
    """sqrt(sum(x^2) + eps): finite gradient at zero (a plain norm has none)."""
    return torch.sqrt(torch.sum(x * x, dim=dim) + eps)


def sigmoid_focal_loss(logits, targets, weights, gamma: float = 2.0, alpha: float = 0.25):
    """Per-anchor sigmoid focal loss. logits/targets: (..., C); weights
    broadcast against (...,). Returns (..., C)."""
    p = torch.sigmoid(logits)
    alpha_w = targets * alpha + (1 - targets) * (1 - alpha)
    pt = targets * (1.0 - p) + (1 - targets) * p
    focal = alpha_w * torch.pow(pt, gamma)
    return focal * binary_cross_entropy_with_logits(logits, targets) * weights[..., None]


def smooth_l1(diff, beta: float = 1.0 / 9.0):
    n = torch.abs(diff)
    return torch.where(n < beta, 0.5 * n ** 2 / beta, n - 0.5 * beta)


def weighted_smooth_l1_loss(preds, targets, weights, code_weights=None,
                            beta: float = 1.0 / 9.0):
    """preds/targets: (..., D); weights: (...,). Returns (..., D)."""
    diff = preds - targets
    if code_weights is not None:
        diff = diff * torch.as_tensor(code_weights, dtype=diff.dtype, device=diff.device)
    return smooth_l1(diff, beta) * weights[..., None]


def weighted_l1_loss(preds, targets, weights, code_weights=None):
    """preds/targets: (..., D); weights: (...,). Returns (..., D)."""
    diff = preds - targets
    if code_weights is not None:
        diff = diff * torch.as_tensor(code_weights, dtype=diff.dtype, device=diff.device)
    return torch.abs(diff) * weights[..., None]


def binary_cross_entropy_with_logits(logits, targets):
    return (torch.clamp(logits, min=0) - logits * targets
            + torch.log1p(torch.exp(-torch.abs(logits))))


def focal_loss_centernet(pred_hm, gt_hm, eps: float = 1e-4):
    """CornerNet penalty-reduced focal loss on sigmoid heatmaps. pred_hm
    (B, C, H, W) probabilities; gt_hm gaussian targets. Normalised by the
    number of positives (gt == 1) over the global batch."""
    pred = torch.clamp(pred_hm, eps, 1.0 - eps)
    pos_mask = (gt_hm >= 1.0).to(pred.dtype)
    neg_weights = torch.pow(1.0 - gt_hm, 4.0)
    pos_loss = -torch.log(pred) * torch.pow(1.0 - pred, 2.0) * pos_mask
    neg_loss = -torch.log(1.0 - pred) * torch.pow(pred, 2.0) * neg_weights * (1.0 - pos_mask)
    loss = torch.sum(pos_loss) + torch.sum(neg_loss)
    return loss / torch.clamp(global_sum(torch.sum(pos_mask)), min=1.0)


def reg_loss_centernet(pred_map, targets, inds, mask):
    """L1 at the gathered heatmap-peak locations. pred_map (B, D, H, W);
    targets (B, N, D); inds (B, N) flat HW indices; mask (B, N). Returns the
    per-channel (D,) mean over the masked objects of the global batch."""
    b, d, h, w = pred_map.shape
    flat = pred_map.reshape(b, d, h * w)
    gathered = torch.gather(flat, 2, inds.long()[:, None, :].expand(-1, d, -1))  # (B, D, N)
    m = mask[..., None].to(pred_map.dtype)
    loss = torch.abs(gathered.transpose(1, 2) - targets) * m
    return torch.sum(loss, dim=(0, 1)) / torch.clamp(global_sum(torch.sum(m)), min=1.0)


def sanitize_boxes(boxes, valid):
    """Replace masked box rows with a finite unit box at the origin.

    Static-shape losses compute EVERY row, including masked rois whose
    decoded sizes can overflow to inf. Masking the OUTPUT alone is not
    enough: in the backward an inf in the masked branch still meets a zero
    cotangent and gives NaN, so the inputs themselves must be finite on
    masked rows (the double-where pattern). ``valid`` broadcasts against
    ``boxes[..., 0]``."""
    unit = torch.zeros_like(boxes)
    unit[..., 3:6] = 1.0
    return torch.where((valid > 0)[..., None], boxes, unit)


def corner_loss_lidar(pred_boxes, gt_boxes, weights, beta: float = 1.0):
    """Huber loss over the 8 box corners, min over the gt heading flip.
    pred/gt: (N, 7); weights: (N,). Returns (N,)."""
    pred_boxes = sanitize_boxes(pred_boxes, weights)
    gt_boxes = sanitize_boxes(gt_boxes, weights)
    pred_corners = boxes_to_corners_3d(pred_boxes)
    gt_corners = boxes_to_corners_3d(gt_boxes)
    gt_flip = torch.cat([gt_boxes[:, :6], gt_boxes[:, 6:7] + math.pi, gt_boxes[:, 7:]], dim=-1)
    gt_corners_flip = boxes_to_corners_3d(gt_flip)
    dist = torch.minimum(safe_norm(pred_corners - gt_corners),
                         safe_norm(pred_corners - gt_corners_flip))  # (N, 8)
    loss = smooth_l1(dist, beta=beta)
    return torch.where(weights > 0, loss.mean(dim=-1) * weights, 0.0)


def _axis_overlap_ratio(c1, d1, c2, d2):
    """1D overlap divided by the HULL extent (max - min of the two
    intervals), not the union; the hull is clipped at 1e-6."""
    lo = torch.maximum(c1 - d1 / 2, c2 - d2 / 2)
    hi = torch.minimum(c1 + d1 / 2, c2 + d2 / 2)
    inter = torch.clamp(hi - lo, min=0.0)
    hull = torch.clamp(torch.maximum(c1 + d1 / 2, c2 + d2 / 2)
                       - torch.minimum(c1 - d1 / 2, c2 - d2 / 2), min=1e-6)
    return inter / hull


def _limit_angle(ang):
    """Wrap to (-pi, pi]."""
    ang = torch.remainder(ang, 2 * math.pi)
    ang = torch.where(ang > math.pi, ang - 2 * math.pi, ang)
    return torch.where(ang < -math.pi, ang + 2 * math.pi, ang)


def bb_loss(pred_boxes, gt_boxes):
    """CPD box-consistency loss: 1 - (product of the per-axis overlap/hull
    ratios times (1 - |sin dr|)) plus 1.25 (1 - |cos dr|) and the SQUARED
    centre distance, all times 1.5. pred/gt: (..., 7). Returns (...,)."""
    iou = 1.0
    for axis in range(3):
        iou = iou * _axis_overlap_ratio(pred_boxes[..., axis], pred_boxes[..., 3 + axis],
                                        gt_boxes[..., axis], gt_boxes[..., 3 + axis])
    ang_w = 1.0 - torch.abs(torch.sin(_limit_angle(pred_boxes[..., 6])
                                      - _limit_angle(gt_boxes[..., 6])))
    ang = pred_boxes[..., 6] - gt_boxes[..., 6]
    angle_term = 1.25 * (1.0 - torch.abs(torch.cos(ang)))
    center_term = torch.sum((pred_boxes[..., :3] - gt_boxes[..., :3]) ** 2, dim=-1)
    return 1.5 * ((1.0 - iou * ang_w) + angle_term + center_term)


def cosine_consistency_loss(feat_a, feat_b, mask=None):
    """Negative cosine between ``feat_a`` and the detached ``feat_b``,
    averaged over the mask (over every row without one) of the global batch."""
    b = feat_b.detach()
    an = feat_a / safe_norm(feat_a)[..., None]
    bn = b / safe_norm(b)[..., None]
    cos = torch.sum(an * bn, dim=-1)
    if mask is not None:
        m = mask.to(cos.dtype)
        return -torch.sum(cos * m) / torch.clamp(global_sum(torch.sum(m)), min=1.0)
    return -torch.sum(cos) / global_sum(cos.new_tensor(float(cos.numel())))


def odiou_3d(pred_boxes, gt_boxes, weights=None):
    """Rotated 3D IoU loss, 1 - IoU of each (N, 7) prediction with its
    label, averaged (weighted where ``weights`` is given); differentiable
    through the candidate-hull overlap."""
    from ..ops.iou3d import paired_iou3d

    loss = 1.0 - paired_iou3d(pred_boxes[:, :7], gt_boxes[:, :7])
    if weights is not None:
        return torch.sum(loss * weights) / torch.clamp(torch.sum(weights), min=1.0)
    return torch.mean(loss)
