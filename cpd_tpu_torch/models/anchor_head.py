"""Anchor-based RPN heads of the DBSCAN / OYSTER / PointPillars configs (port
of cpd_tpu/models/anchor_head.py).

Grid anchors per class at two rotations, axis-aligned nearest-BEV IoU
matching with per-class thresholds, force-match and ignore labels; the
focal + sin-difference smooth-L1 + direction-bin losses; decode with the
direction-bin yaw snap; and the V2 head's decomposed conv branches with the
batch-shared point-density anchor mask. Maps are NHWC, as in the JAX
package; the convs run in f32, as the JAX heads' (flax promotes their bf16
input to the f32 of the parameters).
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import iou3d
from ..ops.box_coders import ResidualCoder
from ..ops.geometry import limit_period
from ..utils.collective import get_world_size
from ..utils import loss as loss_utils
from .bev import conv2d
from .norm import BatchNorm2d


def generate_anchors(grid_size_xy, point_cloud_range, anchor_sizes,
                     anchor_rotations=(0.0, 1.5708), anchor_bottom_heights=(-1.0,),
                     device=None):
    """(H, W, S*R, 7) anchors at the cell centres of the BEV grid; anchor
    sizes (S, 3) per class; z = anchor_bottom_heights[0] + dz / 2."""
    nx, ny = grid_size_xy
    pcr = torch.tensor(point_cloud_range, dtype=torch.float32, device=device)
    stride_x = (pcr[3] - pcr[0]) / nx
    stride_y = (pcr[4] - pcr[1]) / ny
    xs = pcr[0] + (torch.arange(nx, device=device) + 0.5) * stride_x
    ys = pcr[1] + (torch.arange(ny, device=device) + 0.5) * stride_y
    yg, xg = torch.meshgrid(ys, xs, indexing="ij")  # (H=ny, W=nx)
    sizes = torch.tensor(anchor_sizes, dtype=torch.float32, device=device)  # (S, 3)
    rots = torch.tensor(anchor_rotations, dtype=torch.float32, device=device)  # (R,)
    s, r = sizes.shape[0], rots.shape[0]
    h, w = xg.shape
    z = torch.tensor(anchor_bottom_heights, dtype=torch.float32, device=device)[0] + sizes[:, 2] / 2
    shape = (h, w, s, r)
    anchors = torch.stack([
        xg[:, :, None, None].expand(shape), yg[:, :, None, None].expand(shape),
        z[None, None, :, None].expand(shape),
        sizes[None, None, :, None, 0].expand(shape), sizes[None, None, :, None, 1].expand(shape),
        sizes[None, None, :, None, 2].expand(shape), rots[None, None, None, :].expand(shape),
    ], dim=-1)
    return anchors.reshape(h, w, s * r, 7)


def assign_anchor_targets(anchors_flat, anchor_class, gt_boxes, gt_valid, matched_threshold,
                          unmatched_threshold, match_height: bool = False):
    """Axis-aligned anchor-to-label matching for ONE sample.

    anchors_flat (A, 7); anchor_class (A,) 1-based; gt_boxes (G, 8) with the
    class in column 7; gt_valid (G,); thresholds (A,). Returns labels (A,) in
    {-1 ignore, 0 background, c class} and gt_idx (A,) int32. Every label
    claims each anchor of its class tied at its best IoU (force-match); an
    anchor claimed by several takes the first of them, and every argmax
    takes the first maximum, as ``jnp.argmax`` does."""
    a = anchors_flat.shape[0]
    iou_fn = iou3d.boxes_iou3d if match_height else iou3d.boxes_aligned_iou_bev
    iou = iou_fn(anchors_flat[:, :7], gt_boxes[:, :7])  # (A, G)
    same_cls = anchor_class[:, None] == gt_boxes[None, :, 7].to(torch.int32)
    iou = torch.where(same_cls & gt_valid[None, :], iou, -1.0)
    best_iou, best_gt = iou.amax(dim=1), iou.argmax(dim=1)
    labels = torch.full((a,), -1, dtype=torch.int32, device=iou.device)
    labels = torch.where(best_iou < unmatched_threshold, 0, labels)
    fg = best_iou >= matched_threshold
    labels = torch.where(fg, anchor_class, labels)
    gt_best_anchor_iou = iou.amax(dim=0)  # (G,)
    is_gt_best = (iou >= torch.clamp(gt_best_anchor_iou[None, :], min=1e-6)) & gt_valid[None, :]
    force = is_gt_best.any(dim=1)
    force_gt = is_gt_best.to(torch.int32).argmax(dim=1)
    labels = torch.where(force, anchor_class, labels)
    best_gt = torch.where(force, force_gt, best_gt)
    return {"labels": labels, "gt_idx": best_gt.to(torch.int32)}


class _Conv(nn.Module):
    """Holder of a conv's weight (Cout, Cin, k, k) and bias."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int = 1):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(out_channels, in_channels, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def forward(self, x):
        k = self.weight.shape[-1]
        return conv2d(x, self.weight, self.bias, 1, k // 2)


class AnchorHeadSingle(nn.Module):
    """1x1 conv anchor head: cls, box and direction-bin maps. forward:
    (B, H, W, C) NHWC -> cls_preds (B, H, W, A, K), box_preds (B, H, W, A, 7),
    dir_preds (B, H, W, A, bins), spatial_shape."""

    def __init__(self, in_channels: int, num_classes: int = 3,
                 point_cloud_range: Tuple[float, ...] = (-75.2, -75.2, -2.0, 75.2, 75.2, 4.0),
                 anchor_sizes=((4.7, 2.1, 1.7), (0.91, 0.86, 1.73), (1.78, 0.84, 1.78)),
                 anchor_rotations=(0.0, 1.5708), matched_thresholds=(0.55, 0.5, 0.5),
                 unmatched_thresholds=(0.4, 0.35, 0.35), dir_offset: float = 0.78539,
                 dir_limit_offset: float = 0.0, num_dir_bins: int = 2, cls_weight: float = 1.0,
                 loc_weight: float = 2.0, dir_weight: float = 0.2,
                 code_weights=(1.0,) * 7):
        super().__init__()
        self.num_classes = num_classes
        self.point_cloud_range = tuple(point_cloud_range)
        self.anchor_sizes = tuple(tuple(s) for s in anchor_sizes)
        self.anchor_rotations = tuple(anchor_rotations)
        self.matched_thresholds = tuple(matched_thresholds)
        self.unmatched_thresholds = tuple(unmatched_thresholds)
        self.dir_offset = dir_offset
        self.dir_limit_offset = dir_limit_offset
        self.num_dir_bins = num_dir_bins
        self.cls_weight, self.loc_weight, self.dir_weight = cls_weight, loc_weight, dir_weight
        self.code_weights = tuple(code_weights)
        self.coder = ResidualCoder()
        self.code_size = 7
        self.num_anchors = len(self.anchor_sizes) * len(self.anchor_rotations)
        self._build(in_channels)

    def _build(self, in_channels):
        n = self.num_anchors
        self.conv_cls = _Conv(in_channels, n * self.num_classes)
        self.conv_box = _Conv(in_channels, n * self.code_size)
        self.conv_dir = _Conv(in_channels, n * self.num_dir_bins)

    def _out(self, y, last):
        """NCHW conv output -> (B, H, W, A, last)."""
        b, _, h, w = y.shape
        return y.permute(0, 2, 3, 1).reshape(b, h, w, self.num_anchors, last)

    def forward(self, bev_features, anchor_mask=None):
        x = bev_features.float().permute(0, 3, 1, 2)
        return {"cls_preds": self._out(self.conv_cls(x), self.num_classes),
                "box_preds": self._out(self.conv_box(x), self.code_size),
                "dir_preds": self._out(self.conv_dir(x), self.num_dir_bins),
                "spatial_shape": tuple(x.shape[2:]), "anchor_mask": anchor_mask}

    def anchors(self, spatial_shape, device=None):
        """(anchors (H, W, A, 7), 1-based class (H, W, A), matched and
        unmatched thresholds (H, W, A)) of an (H, W) map."""
        h, w = spatial_shape
        anch = generate_anchors((w, h), self.point_cloud_range, self.anchor_sizes,
                                self.anchor_rotations, device=device)
        n_rot = len(self.anchor_rotations)
        shape = (h, w, self.num_anchors)

        def per_anchor(values, dtype):
            t = torch.tensor(values, dtype=dtype, device=device).repeat_interleave(n_rot)
            return t[None, None].expand(shape)

        acls = per_anchor(range(1, len(self.anchor_sizes) + 1), torch.int32)
        return (anch, acls, per_anchor(self.matched_thresholds, torch.float32),
                per_anchor(self.unmatched_thresholds, torch.float32))

    def _mask_flat(self, preds):
        """The anchor mask repeated over each cell's anchors: (H*W*A,) or None."""
        mask = preds.get("anchor_mask")
        if mask is None:
            return None
        return mask.reshape(-1).repeat_interleave(self.num_anchors)

    def assign_targets(self, preds, gt_boxes, gt_valid):
        """labels (B, A) and gt_idx (B, A) of every anchor of the map, with
        the ignore label outside the anchor mask."""
        h, w = preds["spatial_shape"]
        anch, acls, m_thr, u_thr = self.anchors((h, w), gt_boxes.device)
        aflat, acflat = anch.reshape(-1, 7), acls.reshape(-1)
        tgt = [assign_anchor_targets(aflat, acflat, g, v, m_thr.reshape(-1), u_thr.reshape(-1))
               for g, v in zip(gt_boxes, gt_valid)]
        labels = torch.stack([t["labels"] for t in tgt])
        gt_idx = torch.stack([t["gt_idx"] for t in tgt])
        mflat = self._mask_flat(preds)
        if mflat is not None:
            # anchors away from every point leave the anchor set: ignored
            labels = torch.where(mflat[None, :], labels, -1)
        return aflat, labels, gt_idx

    def get_loss(self, preds, gt_boxes, gt_valid):
        """Focal cls + sin-difference smooth-L1 reg + direction CE -> (total,
        {"rpn_cls", "rpn_reg", "rpn_dir"}). Positives are counted per sample;
        the sums are divided by the global batch size (every rank holds the
        same number of samples)."""
        aflat, labels, gt_idx = self.assign_targets(preds, gt_boxes, gt_valid)
        b = labels.shape[0]
        b_global = b * get_world_size()
        cls_preds = preds["cls_preds"].reshape(b, -1, self.num_classes)
        box_preds = preds["box_preds"].reshape(b, -1, self.code_size)
        dir_preds = preds["dir_preds"].reshape(b, -1, self.num_dir_bins)

        cared = labels >= 0
        pos = labels > 0
        one_hot = F.one_hot(torch.clamp(labels - 1, min=0).long(), self.num_classes).float()
        one_hot = one_hot * pos[..., None]
        num_pos = torch.clamp(pos.sum(dim=1, keepdim=True).float(), min=1.0)
        cls_w = cared.float() / num_pos
        cls_loss = loss_utils.sigmoid_focal_loss(cls_preds, one_hot, cls_w).sum() / b_global

        matched_gt = torch.gather(gt_boxes, 1, gt_idx.long()[..., None].expand(-1, -1, 8))
        targets = self.coder.encode(matched_gt[..., :7], aflat.expand(b, -1, -1))
        # sin(a - b) on the heading channel
        sin_diff_pred = torch.cat([box_preds[..., :6], (torch.sin(box_preds[..., 6])
                                                        * torch.cos(targets[..., 6]))[..., None]], -1)
        sin_diff_tgt = torch.cat([targets[..., :6], (torch.cos(box_preds[..., 6])
                                                     * torch.sin(targets[..., 6]))[..., None]], -1)
        reg_w = pos.float() / num_pos
        reg_loss = loss_utils.weighted_smooth_l1_loss(
            sin_diff_pred, sin_diff_tgt, reg_w, self.code_weights).sum() / b_global
        rot_gt = matched_gt[..., 6] - self.dir_offset
        dir_tgt = torch.clamp(torch.floor(limit_period(rot_gt, 0.0, 2 * math.pi)
                                          / (2 * math.pi / self.num_dir_bins)).to(torch.int32),
                              0, self.num_dir_bins - 1)
        dir_oh = F.one_hot(dir_tgt.long(), self.num_dir_bins).float()
        dir_ce = -(dir_oh * torch.log_softmax(dir_preds, -1)).sum(-1)
        dir_loss = (dir_ce * reg_w).sum() / b_global
        total = (self.cls_weight * cls_loss + self.loc_weight * reg_loss
                 + self.dir_weight * dir_loss)
        return total, {"rpn_cls": cls_loss, "rpn_reg": reg_loss, "rpn_dir": dir_loss}

    def generate_predicted_boxes(self, preds):
        """Every anchor decoded -> boxes (B, A, 7) with the direction-bin yaw
        snap, and sigmoid scores (B, A, K), 0 outside the anchor mask."""
        h, w = preds["spatial_shape"]
        cls_preds = preds["cls_preds"]
        anch = self.anchors((h, w), cls_preds.device)[0]
        aflat = anch.reshape(-1, 7)
        b = cls_preds.shape[0]
        boxes = self.coder.decode(preds["box_preds"].reshape(b, -1, self.code_size), aflat)
        dir_labels = preds["dir_preds"].reshape(b, -1, self.num_dir_bins).argmax(-1)
        period = 2 * math.pi / self.num_dir_bins
        rot = limit_period(boxes[..., 6] - self.dir_offset, self.dir_limit_offset, period)
        yaw = rot + self.dir_offset + period * dir_labels.to(boxes.dtype)
        boxes = torch.cat([boxes[..., :6], yaw[..., None]], -1)
        scores = torch.sigmoid(cls_preds.reshape(b, -1, self.num_classes))
        mflat = self._mask_flat(preds)
        if mflat is not None:
            scores = torch.where(mflat[None, :, None], scores, 0.0)
        return boxes, scores


def point_density_anchor_mask(points, points_valid, spatial_shape, point_cloud_range,
                              grid_nx: int):
    """(H, W) bool anchor mask from the BEV density of ALL the batch's points
    (one mask shared by the batch). Points are rasterised into a grid ten
    times coarser than the map (stride round(x_range / grid_nx * 80) m); for
    each occupied coarse cell c, the fine rows / cols [10c - 10, 10c + 10)
    are marked, per axis. points (B, P, >= 2) world xy in columns 0:2;
    points_valid (B, P)."""
    h, w = spatial_shape
    hl, wl = max(h // 10, 1), max(w // 10, 1)
    dev = points.device
    pcr = torch.tensor(point_cloud_range, dtype=torch.float32, device=dev)
    voxel_size = (float(point_cloud_range[3]) - float(point_cloud_range[0])) / grid_nx
    # rounded after the cast to f32, as jnp.round rounds the Python float
    stride = float(torch.round(torch.tensor(voxel_size * 8.0 * 10.0, dtype=torch.float32)))
    ix = torch.clamp(((points[..., 0] - pcr[0]) / stride).to(torch.int32), 0, wl - 1)
    iy = torch.clamp(((points[..., 1] - pcr[1]) / stride).to(torch.int32), 0, hl - 1)
    flat = torch.where(points_valid, iy * wl + ix, hl * wl)  # slot hl * wl: dropped
    occ = torch.zeros(hl * wl + 1, dtype=torch.bool, device=dev)
    occ[flat.reshape(-1).long()] = True
    occ = occ[:hl * wl].reshape(hl, wl)
    # fine block b is marked iff coarse cell b or b + 1 is occupied (per axis)
    occ_p = F.pad(occ, (0, 1, 0, 1))
    dil = occ_p[:-1, :-1] | occ_p[1:, :-1] | occ_p[:-1, 1:] | occ_p[1:, 1:]
    fine = dil.repeat_interleave(10, 0).repeat_interleave(10, 1)
    out = torch.zeros((h, w), dtype=torch.bool, device=dev)
    hh, ww = min(h, fine.shape[0]), min(w, fine.shape[1])
    out[:hh, :ww] = fine[:hh, :ww]
    return out


class _ConvBranch(nn.Module):
    """3x3 conv (with bias) + BatchNorm2d + ReLU + 1x1 conv, NCHW."""

    def __init__(self, in_channels: int, out_dim: int):
        super().__init__()
        self.conv = _Conv(in_channels, in_channels, 3)
        self.bn = BatchNorm2d(in_channels)
        self.out = _Conv(in_channels, out_dim)

    def forward(self, x):
        return self.out(torch.relu(self.bn(self.conv(x))))


class AnchorHeadSingleV2(AnchorHeadSingle):
    """Decomposed-branch anchor head with the point-density anchor mask: a
    shared 3x3 conv (64 channels) + BN + ReLU feeds five branches (cls,
    xy-reg, height, dims, angle) whose box outputs are concatenated; the
    direction classifier reads the input features. ``anchor_mask`` rides in
    the predictions and sets the ignore labels and the zero scores outside
    it."""

    def __init__(self, in_channels: int, *args, shared_channels: int = 64, **kwargs):
        self.shared_channels = shared_channels
        super().__init__(in_channels, *args, **kwargs)

    def _build(self, in_channels):
        n, c = self.num_anchors, self.shared_channels
        self.shared_conv = _Conv(in_channels, c, 3)
        self.shared_bn = BatchNorm2d(c)
        self.conv_cls = _ConvBranch(c, n * self.num_classes)
        self.conv_reg = _ConvBranch(c, n * 2)
        self.conv_height = _ConvBranch(c, n * 1)
        self.conv_dim = _ConvBranch(c, n * 3)
        self.conv_ang = _ConvBranch(c, n * 1)
        self.conv_dir = _Conv(in_channels, n * self.num_dir_bins)

    def forward(self, bev_features, anchor_mask=None):
        x = bev_features.float().permute(0, 3, 1, 2)
        shared = torch.relu(self.shared_bn(self.shared_conv(x)))
        box = torch.cat([self._out(self.conv_reg(shared), 2),
                         self._out(self.conv_height(shared), 1),
                         self._out(self.conv_dim(shared), 3),
                         self._out(self.conv_ang(shared), 1)], dim=-1)
        return {"cls_preds": self._out(self.conv_cls(shared), self.num_classes),
                "box_preds": box,
                "dir_preds": self._out(self.conv_dir(x), self.num_dir_bins),
                "spatial_shape": tuple(x.shape[2:]), "anchor_mask": anchor_mask}
