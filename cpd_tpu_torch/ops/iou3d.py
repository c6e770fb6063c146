"""Rotated BEV and 3D box overlap and IoU (port of cpd_tpu/ops/iou3d.py).

The intersection polygon of two convex quads is spanned by the corners of
each inside the other plus the 16 edge-edge intersections; its area comes
from the sort-free candidate hull of the JAX package
(``_convex_area_from_candidates``), evaluated for all pairs at once.
"""
from __future__ import annotations

import math

import torch

from .geometry import boxes_to_corners_bev

_EPS = 1e-8
# pairs per chunk of the (N, M, 24, 24) candidate-hull tensors
_PAIR_CHUNK_ELEMS = 1 << 25


def _cross2(o, a, b):
    """z of (a-o) x (b-o); positive if o->a->b turns counter-clockwise."""
    return ((a[..., 0] - o[..., 0]) * (b[..., 1] - o[..., 1])
            - (a[..., 1] - o[..., 1]) * (b[..., 0] - o[..., 0]))


def _points_in_convex_quad(pts, quad):
    """pts (..., P, 2), quad (..., 4, 2) counter-clockwise -> (..., P) bool."""
    nxt = torch.roll(quad, -1, dims=-2)
    cross = _cross2(quad[..., None, :, :], nxt[..., None, :, :], pts[..., :, None, :])
    return torch.all(cross >= -_EPS, dim=-1)


def _segment_intersections(a_quad, b_quad):
    """All 16 edge-edge intersections of quads (..., 4, 2) ->
    (pts (..., 16, 2), valid (..., 16)), a-edge major."""
    p1 = a_quad[..., :, None, :]
    p2 = torch.roll(a_quad, -1, dims=-2)[..., :, None, :]
    q1 = b_quad[..., None, :, :]
    q2 = torch.roll(b_quad, -1, dims=-2)[..., None, :, :]
    r = p2 - p1
    s = q2 - q1
    denom = r[..., 0] * s[..., 1] - r[..., 1] * s[..., 0]
    qmp = q1 - p1
    t_num = qmp[..., 0] * s[..., 1] - qmp[..., 1] * s[..., 0]
    u_num = qmp[..., 0] * r[..., 1] - qmp[..., 1] * r[..., 0]
    ok = torch.abs(denom) > _EPS
    safe = torch.where(ok, denom, 1.0)
    t = t_num / safe
    u = u_num / safe
    valid = ok & (t >= -_EPS) & (t <= 1.0 + _EPS) & (u >= -_EPS) & (u <= 1.0 + _EPS)
    pts = p1 + t[..., None] * r
    return pts.flatten(-3, -2), valid.flatten(-2)


def _convex_area_from_candidates(pts, valid):
    """Area of the convex polygon spanned by the valid candidates.

    pts (..., K, 2), valid (..., K). The hull edge i -> j exists iff j has
    the smallest counter-clockwise angle gap from i around the centroid; an
    index-scaled epsilon on the angles makes successors unique."""
    k = pts.shape[-2]
    num_valid = valid.sum(-1)
    vf = valid.to(pts.dtype)[..., None]
    centroid = (pts * vf).sum(-2) / torch.clamp(num_valid, min=1).to(pts.dtype)[..., None]
    ang = torch.atan2(pts[..., 1] - centroid[..., None, 1], pts[..., 0] - centroid[..., None, 0])
    ang = ang + torch.arange(k, dtype=pts.dtype, device=pts.device) * 1e-6
    two_pi = 2.0 * math.pi
    gap = torch.remainder(ang[..., None, :] - ang[..., :, None], two_pi)
    gap = torch.where(gap <= 0.0, two_pi, gap)
    pair_ok = valid[..., :, None] & valid[..., None, :]
    gap = torch.where(pair_ok, gap, math.inf)
    succ = (gap == gap.amin(-1, keepdim=True)) & pair_ok
    x, y = pts[..., 0], pts[..., 1]
    cross = x[..., :, None] * y[..., None, :] - x[..., None, :] * y[..., :, None]
    area = 0.5 * torch.abs(torch.where(succ, cross, 0.0).sum((-2, -1)))
    return torch.where(num_valid >= 3, area, 0.0)


def _overlap_bev_corners(ca, cb):
    """ca (N, 4, 2), cb (M, 4, 2) ccw corners -> (N, M) overlap areas."""
    n, m = ca.shape[0], cb.shape[0]
    a = ca[:, None].expand(n, m, 4, 2)
    b = cb[None].expand(n, m, 4, 2)
    inter_pts, inter_valid = _segment_intersections(a, b)
    pts = torch.cat([a, b, inter_pts], dim=-2)  # (N, M, 24, 2)
    valid = torch.cat([_points_in_convex_quad(a, b), _points_in_convex_quad(b, a),
                       inter_valid], dim=-1)
    return _convex_area_from_candidates(pts, valid)


def boxes_overlap_bev(boxes_a, boxes_b):
    """(N, 7), (M, 7) -> (N, M) rotated BEV overlap areas, in row chunks
    that bound the (rows, M, 24, 24) hull tensors, each at most the smaller
    footprint ``dx * dy``. That bound matters for a box narrower than the
    f32 spacing at its place (a proposal of 1e-8 m at 70 m): its corners
    coincide, every point passes the inside test of its edges of length 0,
    and the candidate hull spans the other box; the JAX package's overlap
    (no bound) then gives such a pair an IoU of millions."""
    ca = boxes_to_corners_bev(boxes_a)
    cb = boxes_to_corners_bev(boxes_b)
    rows = max(1, _PAIR_CHUNK_ELEMS // max(1, cb.shape[0] * 24 * 24))
    if ca.shape[0] == 0:
        return ca.new_zeros((0, cb.shape[0]))
    overlap = torch.cat([_overlap_bev_corners(ca[i:i + rows], cb)
                         for i in range(0, ca.shape[0], rows)], dim=0)
    area_a = (boxes_a[:, 3] * boxes_a[:, 4])[:, None]
    area_b = (boxes_b[:, 3] * boxes_b[:, 4])[None, :]
    return torch.minimum(overlap, torch.minimum(area_a, area_b))


def boxes_iou_bev(boxes_a, boxes_b):
    """(N, 7), (M, 7) -> (N, M) rotated BEV IoU."""
    overlap = boxes_overlap_bev(boxes_a, boxes_b)
    area_a = (boxes_a[:, 3] * boxes_a[:, 4])[:, None]
    area_b = (boxes_b[:, 3] * boxes_b[:, 4])[None, :]
    return overlap / torch.clamp(area_a + area_b - overlap, min=1e-6)


def boxes_iou3d(boxes_a, boxes_b):
    """(N, 7), (M, 7) -> (N, M) 3D IoU: BEV overlap times the z-extent overlap."""
    overlap_bev = boxes_overlap_bev(boxes_a, boxes_b)
    a_zmin = (boxes_a[:, 2] - boxes_a[:, 5] / 2.0)[:, None]
    a_zmax = (boxes_a[:, 2] + boxes_a[:, 5] / 2.0)[:, None]
    b_zmin = (boxes_b[:, 2] - boxes_b[:, 5] / 2.0)[None, :]
    b_zmax = (boxes_b[:, 2] + boxes_b[:, 5] / 2.0)[None, :]
    overlap_h = torch.clamp(torch.minimum(a_zmax, b_zmax) - torch.maximum(a_zmin, b_zmin),
                            min=0.0)
    overlap_3d = overlap_bev * overlap_h
    vol_a = (boxes_a[:, 3] * boxes_a[:, 4] * boxes_a[:, 5])[:, None]
    vol_b = (boxes_b[:, 3] * boxes_b[:, 4] * boxes_b[:, 5])[None, :]
    return overlap_3d / torch.clamp(vol_a + vol_b - overlap_3d, min=1e-6)


def boxes_aligned_iou_bev(boxes_a, boxes_b):
    """(N, 7), (M, 7) -> (N, M) IoU of the axis-aligned BEV footprints: a
    heading nearer to +-pi/2 than to 0 or pi swaps dx and dy (the anchor
    matching's nearest-BEV IoU)."""

    def to_aabb(b):
        rot = torch.abs(torch.remainder(b[:, 6], math.pi))
        swap = (rot > math.pi / 4) & (rot < 3 * math.pi / 4)
        dx = torch.where(swap, b[:, 4], b[:, 3])
        dy = torch.where(swap, b[:, 3], b[:, 4])
        return torch.stack([b[:, 0] - dx / 2, b[:, 1] - dy / 2,
                            b[:, 0] + dx / 2, b[:, 1] + dy / 2], dim=-1)

    a, b = to_aabb(boxes_a), to_aabb(boxes_b)
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = ((a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1]))[:, None]
    area_b = ((b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1]))[None, :]
    return inter / torch.clamp(area_a + area_b - inter, min=1e-6)
