"""RoI-aware and RoI-point pooling (port of cpd_tpu/ops/roipool.py).

``roiaware_pool3d`` pools point features into a g x g x g grid over each
RoI (max, with 0 in empty cells, or the mean); ``roipoint_pool3d`` takes
the first ``num_sampled`` points inside each RoI in point order. Both run on
all RoIs at once, on the device of their inputs.
"""
from __future__ import annotations

import torch

from .geometry import box_local_coords


def _inside(local, boxes, points_valid, boxes_valid):
    """(M, N) bool: inside or on the boundary of each valid box, for valid
    points (``geometry.points_in_boxes_mask`` on the same local coords)."""
    inside = (torch.abs(local) <= boxes[:, None, 3:6] / 2.0).all(dim=-1)
    if points_valid is not None:
        inside = inside & points_valid[None, :]
    if boxes_valid is not None:
        inside = inside & boxes_valid[:, None]
    return inside


def roiaware_pool3d(points, point_features, boxes, out_size: int = 6, pool_method: str = "max",
                    points_valid=None, boxes_valid=None):
    """points (N, 3+), point_features (N, C), boxes (M, 7+) -> (M, g, g, g, C)
    pooled features, g = ``out_size``. ``max``: 0 for an empty cell;
    ``avg``: the mean over the cell's points. A point's cell is
    floor((local + dims/2) / (dims/g)), clipped to the grid."""
    if pool_method not in ("max", "avg"):
        raise ValueError(f"pool_method must be 'max' or 'avg', got {pool_method!r}")
    g = out_size
    m, n, c = boxes.shape[0], points.shape[0], point_features.shape[-1]
    local = box_local_coords(points, boxes)
    inside = _inside(local, boxes, points_valid, boxes_valid)
    dims = boxes[:, None, 3:6]
    cell = torch.floor((local + dims / 2.0) / (dims / g)).to(torch.int64).clamp(0, g - 1)
    flat = (cell[..., 0] * g + cell[..., 1]) * g + cell[..., 2]
    slots = g ** 3 + 1  # the last slot takes the points outside
    flat = torch.where(inside, flat, g ** 3)
    flat = (flat + torch.arange(m, device=flat.device)[:, None] * slots).reshape(-1)
    feats = point_features[None].expand(m, n, c)
    if pool_method == "avg":
        masked = torch.where(inside[..., None], feats, 0.0).reshape(-1, c)
        sums = masked.new_zeros((m * slots, c)).index_add_(0, flat, masked)
        cnt = masked.new_zeros(m * slots).index_add_(0, flat, inside.reshape(-1).to(masked.dtype))
        pooled = sums / torch.clamp(cnt[:, None], min=1.0)
    else:
        masked = torch.where(inside[..., None], feats, float("-inf")).reshape(-1, c)
        pooled = masked.new_full((m * slots, c), float("-inf")).scatter_reduce_(
            0, flat[:, None].expand(-1, c), masked, "amax")
        pooled = torch.where(torch.isfinite(pooled), pooled, 0.0)
    return pooled.reshape(m, slots, c)[:, :g ** 3].reshape(m, g, g, g, c)


def roipoint_pool3d(points, point_features, boxes, num_sampled: int = 512, points_valid=None,
                    boxes_valid=None):
    """The first ``num_sampled`` points inside each RoI, in point order.

    points (N, 3+), point_features (N, C), boxes (M, 7+) -> (pooled (M, K,
    3 + C) of xyz and features, 0 in unused slots; pooled_valid (M, K);
    empty (M,) for a RoI that holds no point)."""
    feats = torch.cat([points[:, :3], point_features], dim=-1)
    inside = _inside(box_local_coords(points, boxes), boxes, points_valid, boxes_valid)
    # a stable sort on "outside" puts the inside points first, in point order
    sel = torch.sort((~inside).to(torch.uint8), dim=1, stable=True)[1][:, :num_sampled]
    valid = torch.gather(inside, 1, sel)
    pooled = torch.where(valid[..., None], feats[sel], 0.0)
    return pooled, valid, ~inside.any(dim=1)
