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
