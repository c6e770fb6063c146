"""CenterNet gaussian heatmap targets and heatmap decode (port of
cpd_tpu/ops/gaussian.py)."""
from __future__ import annotations

import torch

from .nms import top_k


def gaussian_radius(height, width, min_overlap: float = 0.1):
    """CenterNet radius: smallest r keeping IoU >= min_overlap for 3 cases."""
    b1 = height + width
    c1 = width * height * (1 - min_overlap) / (1 + min_overlap)
    r1 = (b1 + torch.sqrt(torch.clamp(b1 ** 2 - 4 * c1, min=0.0))) / 2
    b2 = 2 * (height + width)
    c2 = (1 - min_overlap) * width * height
    r2 = (b2 + torch.sqrt(torch.clamp(b2 ** 2 - 16 * c2, min=0.0))) / 2
    a3 = 4 * min_overlap
    b3 = -2 * min_overlap * (height + width)
    c3 = (min_overlap - 1) * width * height
    r3 = (b3 + torch.sqrt(torch.clamp(b3 ** 2 - 4 * a3 * c3, min=0.0))) / 2
    return torch.minimum(torch.minimum(r1, r2), r3)


def _render_gaussian(cx, cy, radius, shape):
    """Full-map gaussians centred at (floor cx, floor cy) with square support
    of ``radius``. cx/cy/radius (N,) -> (N, H, W)."""
    h, w = shape
    ys = torch.arange(h, dtype=torch.float32, device=cx.device)[None, :, None]
    xs = torch.arange(w, dtype=torch.float32, device=cx.device)[None, None, :]
    dx = xs - torch.floor(cx)[:, None, None]
    dy = ys - torch.floor(cy)[:, None, None]
    r = radius[:, None, None]
    sigma = (2.0 * r + 1.0) / 6.0
    g = torch.exp(-(dx ** 2 + dy ** 2) / (2.0 * sigma ** 2 + 1e-12))
    return torch.where((dx.abs() <= r) & (dy.abs() <= r), g, 0.0)


@torch.no_grad()
def assign_center_targets(gt_boxes, gt_valid, num_classes: int, feature_map_size,
                          voxel_size, point_cloud_range, feature_map_stride: int = 8,
                          gaussian_overlap: float = 0.1, min_radius: int = 2):
    """CenterHead target assignment for ONE sample.

    gt_boxes (N_max, 8) [x y z dx dy dz heading class(1-based)]; gt_valid
    (N_max,). Returns heatmap (C, H, W), target_boxes (N_max, 8), inds
    (N_max,) flat HW index (int64), mask (N_max,)."""
    h, w = feature_map_size
    n_max = gt_boxes.shape[0]
    # the JAX package's assign_center_targets is jitted, and XLA rewrites its
    # divisions by the constant pixel size as products with the f32
    # reciprocal: a centre within an ulp of a pixel edge takes the pixel (and
    # a radius the integer) that the product gives
    inv_sx, inv_sy = (1.0 / torch.tensor(voxel_size[i] * feature_map_stride, dtype=gt_boxes.dtype,
                                         device=gt_boxes.device) for i in (0, 1))
    cx = (gt_boxes[:, 0] - point_cloud_range[0]) * inv_sx
    cy = (gt_boxes[:, 1] - point_cloud_range[1]) * inv_sy
    valid = (gt_valid & (cx >= 0) & (cx < w) & (cy >= 0) & (cy < h)
             & (gt_boxes[:, 3] > 0) & (gt_boxes[:, 4] > 0))
    radius = gaussian_radius(gt_boxes[:, 4] * inv_sy, gt_boxes[:, 3] * inv_sx, gaussian_overlap)
    radius = torch.clamp(torch.floor(radius), min=min_radius)
    heat = _render_gaussian(cx, cy, radius, (h, w))
    heat = torch.where(valid[:, None, None], heat, 0.0).reshape(n_max, h * w)
    # per-class max-merge; invalid objects go to the extra class that is cut off
    cls_ids = torch.where(valid, gt_boxes[:, 7].long() - 1, num_classes)
    flat = torch.zeros((num_classes + 1, h * w), dtype=heat.dtype, device=heat.device)
    flat.scatter_reduce_(0, cls_ids[:, None].expand(-1, h * w), heat, "amax")
    flat = flat[:num_classes].contiguous()
    # exactly 1.0 at the integer centre pixel of each valid object
    cxi = torch.clamp(torch.floor(cx).long(), 0, w - 1)
    cyi = torch.clamp(torch.floor(cy).long(), 0, h - 1)
    inds = cyi * w + cxi
    safe_cls = torch.clamp(cls_ids, 0, num_classes - 1)
    flat.view(-1).scatter_reduce_(0, safe_cls * (h * w) + inds, valid.to(heat.dtype), "amax")
    target_boxes = torch.stack([
        cx - cxi.to(cx.dtype), cy - cyi.to(cy.dtype), gt_boxes[:, 2],
        torch.log(torch.clamp(gt_boxes[:, 3], min=1e-6)),
        torch.log(torch.clamp(gt_boxes[:, 4], min=1e-6)),
        torch.log(torch.clamp(gt_boxes[:, 5], min=1e-6)),
        torch.sin(gt_boxes[:, 6]), torch.cos(gt_boxes[:, 6])], dim=-1)
    return {"heatmap": flat.reshape(num_classes, h, w),
            "target_boxes": torch.where(valid[:, None], target_boxes, 0.0),
            "inds": torch.where(valid, inds, 0), "mask": valid}


def decode_bbox_from_heatmap(heatmap, center, center_z, dim, rot, voxel_size,
                             point_cloud_range, feature_map_stride: int = 8,
                             k: int = 500, score_thresh: float = 0.1,
                             post_center_limit_range=None):
    """Top-K heatmap decode of ONE sample, or of a batch along leading axes.

    heatmap (..., C, H, W) sigmoid scores; center (..., 2, H, W); center_z
    (..., 1, H, W); dim (..., 3, H, W) log sizes; rot (..., 2, H, W) as
    (cos, sin). Returns (boxes (..., K, 7), scores (..., K), labels (..., K)
    int32 0-based, valid (..., K)).
    """
    c, h, w = heatmap.shape[-3:]
    k = min(k, c * h * w)
    scores, idx = top_k(heatmap.flatten(-3), k)
    labels = (idx // (h * w)).to(torch.int32)
    pix = idx % (h * w)
    ys = (pix // w).to(torch.float32)
    xs = (pix % w).to(torch.float32)

    def gather(m):
        flat = m.flatten(-2)
        return torch.gather(flat, -1, pix[..., None, :].expand(*flat.shape[:-1], k))

    off = gather(center)
    zc = gather(center_z)[..., 0, :]
    dims = torch.exp(gather(dim))
    r = gather(rot)
    angle = torch.atan2(r[..., 1, :], r[..., 0, :])
    x = (xs + off[..., 0, :]) * feature_map_stride * voxel_size[0] + point_cloud_range[0]
    y = (ys + off[..., 1, :]) * feature_map_stride * voxel_size[1] + point_cloud_range[1]
    boxes = torch.stack([x, y, zc, dims[..., 0, :], dims[..., 1, :], dims[..., 2, :], angle],
                        dim=-1)
    valid = scores > score_thresh
    if post_center_limit_range is not None:
        lim = torch.tensor(post_center_limit_range, dtype=boxes.dtype, device=boxes.device)
        valid = (valid & torch.all(boxes[..., :3] >= lim[:3], dim=-1)
                 & torch.all(boxes[..., :3] <= lim[3:], dim=-1))
    return boxes, scores, labels, valid
