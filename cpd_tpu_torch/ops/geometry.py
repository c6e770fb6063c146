"""Box/point geometry (port of cpd_tpu/ops/geometry.py)."""
from __future__ import annotations

import math

import torch


def limit_period(val, offset: float = 0.5, period: float = math.pi):
    """Wrap ``val`` into [-offset*period, (1-offset)*period)."""
    return val - torch.floor(val / period + offset) * period


def rotation_matrix_z(angle):
    """(...,) angles -> (..., 3, 3) rotation matrices around +z."""
    c, s = torch.cos(angle), torch.sin(angle)
    zeros = torch.zeros_like(c)
    ones = torch.ones_like(c)
    return torch.stack([c, s, zeros, -s, c, zeros, zeros, zeros, ones],
                       dim=-1).reshape(angle.shape + (3, 3))


def rotate_points_along_z(points, angle):
    """points: (..., N, 3 + C); angle: (...,) radians, counter-clockwise.
    Extra channels pass through untouched."""
    rot = rotation_matrix_z(angle)
    rotated = torch.einsum("...nj,...jk->...nk", points[..., :3], rot)
    return torch.cat([rotated, points[..., 3:]], dim=-1)


def boxes_to_corners_3d(boxes):
    """(N, 7[+]) boxes -> (N, 8, 3) corners: the bottom face counter-clockwise
    from (+x, +y), then the top face in the same order."""
    template = torch.tensor(
        [[1, 1, -1], [1, -1, -1], [-1, -1, -1], [-1, 1, -1],
         [1, 1, 1], [1, -1, 1], [-1, -1, 1], [-1, 1, 1]],
        dtype=boxes.dtype, device=boxes.device) / 2.0
    corners = boxes[:, None, 3:6] * template[None]
    corners = rotate_points_along_z(corners, boxes[:, 6])
    return corners + boxes[:, None, 0:3]


def boxes_to_corners_bev(boxes):
    """(N, 7[+]) boxes -> (N, 4, 2) BEV corners, counter-clockwise order."""
    half_dx = boxes[:, 3] / 2.0
    half_dy = boxes[:, 4] / 2.0
    local = torch.stack([
        torch.stack([half_dx, half_dy], dim=-1),
        torch.stack([-half_dx, half_dy], dim=-1),
        torch.stack([-half_dx, -half_dy], dim=-1),
        torch.stack([half_dx, -half_dy], dim=-1),
    ], dim=1)  # (N, 4, 2)
    c, s = torch.cos(boxes[:, 6]), torch.sin(boxes[:, 6])
    rot = torch.stack([c, s, -s, c], dim=-1).reshape(-1, 2, 2)
    corners = torch.einsum("nij,njk->nik", local, rot)
    return corners + boxes[:, None, 0:2]


def box_local_coords(points, boxes):
    """(N, 3+) world points, (M, 7+) boxes -> (M, N, 3) coordinates in each
    box's frame (x forward, y left, z up, origin at its centre)."""
    shifted = points[None, :, :3] - boxes[:, None, 0:3]
    c, s = torch.cos(-boxes[:, 6])[:, None], torch.sin(-boxes[:, 6])[:, None]
    return torch.stack([shifted[..., 0] * c - shifted[..., 1] * s,
                        shifted[..., 0] * s + shifted[..., 1] * c, shifted[..., 2]], dim=-1)


def points_in_boxes_mask(points, boxes):
    """(N, 3+) points, (M, 7+) boxes -> (M, N) bool: inside or on the
    boundary (the host route is ``datasets.box_np``'s NumPy mask)."""
    return (torch.abs(box_local_coords(points, boxes)) <= boxes[:, None, 3:6] / 2.0).all(dim=-1)


def points_in_box(points, box):
    """(N, 3+) points, (7+,) box -> (N,) bool: inside or on the boundary."""
    return points_in_boxes_mask(points, box[None])[0]


def points_in_boxes_index(points, boxes, valid_boxes=None):
    """(N, 3+) points, (M, 7+) boxes -> (N,) int32 index of the first box
    that holds each point, -1 where none does."""
    mask = points_in_boxes_mask(points, boxes)
    if valid_boxes is not None:
        mask = mask & valid_boxes[:, None]
    idx = mask.to(torch.uint8).argmax(dim=0).to(torch.int32)
    return torch.where(mask.any(dim=0), idx, -1)


def enlarge_box3d(boxes, extra_width=(0.0, 0.0, 0.0)):
    """Grow boxes by ``extra_width`` (dx, dy, dz) on each full dimension."""
    extra = torch.as_tensor(extra_width, dtype=boxes.dtype, device=boxes.device)
    out = boxes.clone()
    out[..., 3:6] = out[..., 3:6] + extra
    return out


def get_voxel_centers(voxel_coords, downsample_times, voxel_size, point_cloud_range):
    """(N, 3) integer zyx voxel coords -> (N, 3) xyz metric centres, f32."""
    coords_xyz = voxel_coords[:, [2, 1, 0]].float()
    size = torch.as_tensor(voxel_size, dtype=torch.float32,
                           device=voxel_coords.device) * downsample_times
    pc_min = torch.as_tensor(point_cloud_range[0:3], dtype=torch.float32,
                             device=voxel_coords.device)
    return (coords_xyz + 0.5) * size + pc_min


def mask_points_outside_range(points, point_cloud_range):
    """(N, 3+) -> (N,) bool: the points inside the (xmin, ymin, zmin, xmax,
    ymax, zmax) range, bounds included."""
    r = point_cloud_range
    return ((points[:, 0] >= r[0]) & (points[:, 0] <= r[3])
            & (points[:, 1] >= r[1]) & (points[:, 1] <= r[4])
            & (points[:, 2] >= r[2]) & (points[:, 2] <= r[5]))


def mask_boxes_outside_range(boxes, point_cloud_range, min_num_corners: int = 1):
    """(N, 7+) -> (N,) keep mask: at least ``min_num_corners`` BEV corners
    inside the range."""
    corners = boxes_to_corners_bev(boxes)
    r = point_cloud_range
    inside = ((corners[..., 0] >= r[0]) & (corners[..., 0] <= r[3])
              & (corners[..., 1] >= r[1]) & (corners[..., 1] <= r[4]))
    return inside.sum(dim=1) >= min_num_corners
