"""CenterNet heatmap decode (port of cpd_tpu/ops/gaussian.py::decode_bbox_from_heatmap)."""
from __future__ import annotations

import torch

from .nms import top_k


def decode_bbox_from_heatmap(heatmap, center, center_z, dim, rot, voxel_size,
                             point_cloud_range, feature_map_stride: int = 8,
                             k: int = 500, score_thresh: float = 0.1,
                             post_center_limit_range=None):
    """Top-K heatmap decode for ONE sample.

    heatmap (C, H, W) sigmoid scores; center (2, H, W); center_z (1, H, W);
    dim (3, H, W) log sizes; rot (2, H, W) as (cos, sin).
    Returns (boxes (K, 7), scores (K,), labels (K,) int32 0-based, valid (K,)).
    """
    c, h, w = heatmap.shape
    k = min(k, c * h * w)
    scores, idx = top_k(heatmap.reshape(-1), k)
    labels = (idx // (h * w)).to(torch.int32)
    pix = idx % (h * w)
    ys = (pix // w).to(torch.float32)
    xs = (pix % w).to(torch.float32)

    def gather(m):
        return m.reshape(m.shape[0], h * w)[:, pix]

    off = gather(center)
    zc = gather(center_z)[0]
    dims = torch.exp(gather(dim))
    r = gather(rot)
    angle = torch.atan2(r[1], r[0])
    x = (xs + off[0]) * feature_map_stride * voxel_size[0] + point_cloud_range[0]
    y = (ys + off[1]) * feature_map_stride * voxel_size[1] + point_cloud_range[1]
    boxes = torch.stack([x, y, zc, dims[0], dims[1], dims[2], angle], dim=-1)
    valid = scores > score_thresh
    if post_center_limit_range is not None:
        lim = torch.tensor(post_center_limit_range, dtype=boxes.dtype, device=boxes.device)
        valid = (valid & torch.all(boxes[:, :3] >= lim[:3], dim=1)
                 & torch.all(boxes[:, :3] <= lim[3:], dim=1))
    return boxes, scores, labels, valid
