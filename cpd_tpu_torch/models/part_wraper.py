"""PartWraper: part-based confidence re-scoring head (port of
cpd_tpu/models/part_wraper.py).

A 3x3 conv makes a confidence map from the BEV features; each box reads the
map bilinearly at a 4 x 7 grid of part points inside it, and the mean of
those reads is its part confidence. Trained with a focal loss against
IoU > 0.7 targets; at inference the confidences replace the box scores.
``bilinear_sample_bev`` is shared with the PFE and the X_TRAIN BEV
alignment.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from ..ops.geometry import rotate_points_along_z
from ..ops.iou3d import boxes_iou3d
from .bev import conv2d


def box_part_points(boxes, nx: int = 7, ny: int = 4):
    """(..., N, 7) boxes -> (..., N, ny*nx, 2) BEV part-point grid inside
    each box (y outer, x inner)."""
    f32 = dict(dtype=torch.float32, device=boxes.device)
    gx = (torch.arange(nx, **f32) + 0.5) / nx - 0.5
    gy = (torch.arange(ny, **f32) + 0.5) / ny - 0.5
    yy, xx = torch.meshgrid(gy, gx, indexing="ij")
    unit = torch.stack([xx.reshape(-1), yy.reshape(-1)], dim=-1)  # (P, 2)
    pts = unit * boxes[..., None, 3:5]
    pts3 = torch.cat([pts, torch.zeros_like(pts[..., :1])], dim=-1)
    pts3 = rotate_points_along_z(pts3, boxes[..., 6])
    return pts3[..., :2] + boxes[..., None, :2]


def bilinear_sample_bev(feature_map, xy, point_cloud_range, stride_m: float):
    """Bilinear reads of (B, H, W, C) maps at metric (B, ..., 2) points ->
    (B, ..., C) f32. The four corner cells are gathered at indices clamped to
    the map (a point off the map reads its edge), weighted in f32 as the JAX
    package weighs them."""
    b, h, w, c = feature_map.shape
    u = (xy[..., 0] - point_cloud_range[0]) / stride_m - 0.5
    v = (xy[..., 1] - point_cloud_range[1]) / stride_m - 0.5
    u0, v0 = torch.floor(u), torch.floor(v)
    du, dv = u - u0, v - v0
    u0, v0 = u0.long(), v0.long()
    flat = feature_map.reshape(b, h * w, c)

    def at(vi, ui):
        cell = (torch.clamp(vi, 0, h - 1) * w + torch.clamp(ui, 0, w - 1)).reshape(b, -1)
        rows = torch.gather(flat, 1, cell[..., None].expand(-1, -1, c))
        return rows.reshape(*vi.shape, c).float()

    return (at(v0, u0) * ((1 - du) * (1 - dv))[..., None]
            + at(v0, u0 + 1) * (du * (1 - dv))[..., None]
            + at(v0 + 1, u0) * ((1 - du) * dv)[..., None]
            + at(v0 + 1, u0 + 1) * (du * dv)[..., None])


class PartWraper(nn.Module):
    """Confidence-map head over the BEV features + part-pooled re-scoring.
    forward(bev_features (B, H, W, C), boxes (B, N, 7), box_valid (B, N)) ->
    (part confidences (B, N), 0 where not valid; confidence map (B, H, W, 1))."""

    def __init__(self, in_channels: int,
                 point_cloud_range: Tuple[float, ...] = (-75.2, -75.2, -2.0, 75.2, 75.2, 4.0),
                 feature_map_stride: int = 8,
                 voxel_size: Tuple[float, float, float] = (0.1, 0.1, 0.15),
                 iou_thresh: float = 0.7):
        super().__init__()
        self.point_cloud_range = tuple(point_cloud_range)
        self.stride_m = voxel_size[0] * feature_map_stride
        self.iou_thresh = iou_thresh
        self.conf_conv = nn.Module()
        self.conf_conv.weight = nn.Parameter(torch.zeros(1, in_channels, 3, 3))
        self.conf_conv.bias = nn.Parameter(torch.zeros(1))

    def forward(self, bev_features, boxes, box_valid):
        # f32, as flax promotes the bf16 features to its f32 kernel
        x = bev_features.float().permute(0, 3, 1, 2)
        conf_map = torch.sigmoid(conv2d(x, self.conf_conv.weight, self.conf_conv.bias, 1, 1))
        conf_map = conf_map.permute(0, 2, 3, 1)
        vals = bilinear_sample_bev(conf_map, box_part_points(boxes), self.point_cloud_range,
                                   self.stride_m)
        part_conf = vals[..., 0].mean(dim=-1)
        return torch.where(box_valid, part_conf, 0.0), conf_map

    def get_loss(self, part_conf, boxes, box_valid, gt_boxes, gt_valid):
        """Focal loss (gamma 2) of the part confidences against targets
        best-IoU > ``iou_thresh``, a mean over the valid boxes."""
        targets = []
        with torch.no_grad():  # a threshold: no gradient reaches the boxes through it
            for bxs, gt, gv in zip(boxes, gt_boxes, gt_valid):
                iou = torch.where(gv[None, :], boxes_iou3d(bxs[:, :7], gt[:, :7]), 0.0)
                targets.append((iou.amax(dim=1) > self.iou_thresh).float())
        targets = torch.stack(targets)
        p = torch.clamp(part_conf, 1e-4, 1 - 1e-4)
        focal = -(targets * (1 - p) ** 2 * torch.log(p)
                  + (1 - targets) * p ** 2 * torch.log(1 - p))
        m = box_valid.float()
        return torch.sum(focal * m) / torch.clamp(torch.sum(m), min=1.0)
