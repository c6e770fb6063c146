"""Rotated BEV and 3D box overlap and IoU (port of cpd_tpu/ops/iou3d.py).

Two formulations, as in the JAX package (``boxes_overlap_bev(method=)``):

* ``"clip"``: Sutherland-Hodgman clipping of one quad by the other's four
  half-planes with a fixed capacity of 8 vertices, then the shoelace area
  (JAX's ``_overlap_bev_clip``). Kernel B4a (``pairwise_overlap_bev``,
  ``csrc/nms_bev.cu``) computes it on the card, batched, one thread a pair;
  ``pairwise_overlap_bev_reference`` is its plain version, the same
  operations in the same order. B4a and B4b skip the clip of a pair that
  ``clip_reject`` finds disjoint, whose clip is exactly 0.0.
* ``"candidates"``: the intersection polygon of two convex quads is spanned
  by the corners of each inside the other plus the 16 edge-edge
  intersections; its area comes from the sort-free candidate hull
  (``_convex_area_from_candidates``), evaluated for all pairs at once. JAX's
  default, kept here for CPU tensors.

A CUDA tensor runs kernel B4a whatever ``method`` says; a CPU tensor runs the
formulation it names. Both cap the overlap at the smaller footprint.
"""
from __future__ import annotations

import ctypes
import math

import torch

from .cuda_build import load, on_cuda
from .geometry import boxes_to_corners_bev

_EPS = 1e-8
# pairs per chunk of the (N, M, 24, 24) candidate-hull tensors
_PAIR_CHUNK_ELEMS = 1 << 25
# pairs per chunk of the clip formulation's (pairs, 16) tensors
_CLIP_CHUNK_PAIRS = 1 << 20
_CLIP_CAP = 8
# the disjoint-pair reject (``clip_reject``): a box's least side against its
# coordinates' scale, and its circle's growth and pad (metres)
_REJECT_SOLID = 2.0 ** -10
_REJECT_GROW = 1.0 + 2.0 ** -6
_REJECT_PAD = 2.0 ** -10
_OVERLAP_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2


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


def bev_corners(boxes):
    """(..., 7+) boxes -> (..., 4, 2) BEV corners, counter-clockwise, each
    coordinate ``local_x * cos - local_y * sin + x`` (and ``local_x * sin +
    local_y * cos + y``) rounded op by op: kernel B4a's operands, and its
    plain version's, so that the two see the same corners."""
    hx, hy = boxes[..., 3] / 2.0, boxes[..., 4] / 2.0
    lx = torch.stack([hx, -hx, -hx, hx], dim=-1)
    ly = torch.stack([hy, hy, -hy, -hy], dim=-1)
    c, s = torch.cos(boxes[..., 6])[..., None], torch.sin(boxes[..., 6])[..., None]
    x = lx * c - ly * s + boxes[..., 0, None]
    y = lx * s + ly * c + boxes[..., 1, None]
    return torch.stack([x, y], dim=-1)


def _clip_area(ca, cb, count_ops=False):
    """Area of quad ``ca`` clipped by quad ``cb`` ((..., 4, 2) each, ccw,
    broadcast) -> (...,): JAX's ``_overlap_bev_clip`` restated. Each pass
    emits, slot by slot, the crossing point and then the next vertex (if
    inside), and keeps the first 8; the shoelace terms are summed slot by
    slot in order, as kernel B4a sums them. With ``count_ops`` also the f32
    operations the formulation needs for each pair: per pass 2 for the edge,
    6 for each vertex's side test, 8 for each crossing point; 4 for each
    shoelace term and 2 for the area."""
    shape = torch.broadcast_shapes(ca.shape[:-2], cb.shape[:-2])
    ca, cb = ca.expand(*shape, 4, 2), cb.expand(*shape, 4, 2)
    dev, dt = ca.device, ca.dtype
    px = torch.zeros(*shape, _CLIP_CAP, dtype=dt, device=dev)
    py = torch.zeros_like(px)
    px[..., :4], py[..., :4] = ca[..., 0], ca[..., 1]
    count = torch.full(shape, 4, dtype=torch.int64, device=dev)[..., None]
    slot = torch.arange(_CLIP_CAP, device=dev)
    ops = torch.zeros(shape, dtype=torch.int64, device=dev) if count_ops else None
    for e in range(4):
        ax, ay = cb[..., e, 0, None], cb[..., e, 1, None]
        evx = cb[..., (e + 1) % 4, 0, None] - ax
        evy = cb[..., (e + 1) % 4, 1, None] - ay
        active = slot < count
        nxt = torch.where(slot + 1 < count, slot + 1, 0).expand(*shape, _CLIP_CAP)
        nx, ny = torch.gather(px, -1, nxt), torch.gather(py, -1, nxt)
        cur_side = evx * (py - ay) - evy * (px - ax)
        nxt_side = evx * (ny - ay) - evy * (nx - ax)
        cur_in, nxt_in = cur_side >= -_EPS, nxt_side >= -_EPS
        denom = cur_side - nxt_side
        t = cur_side / torch.where(torch.abs(denom) > _EPS, denom, 1.0)
        ix, iy = px + t * (nx - px), py + t * (ny - py)
        flags = torch.stack([active & (cur_in ^ nxt_in), active & nxt_in], dim=-1).flatten(-2)
        pos = torch.cumsum(flags.to(torch.int64), dim=-1) - 1
        target = torch.where(flags & (pos < _CLIP_CAP), pos, _CLIP_CAP)
        if count_ops:
            ops += 2 + 6 * count[..., 0] + 8 * flags[..., 0::2].sum(-1)
        count = torch.clamp(flags.sum(-1, keepdim=True), max=_CLIP_CAP)
        out = torch.zeros(*shape, _CLIP_CAP + 1, dtype=dt, device=dev)
        px = out.scatter(-1, target, torch.stack([ix, nx], dim=-1).flatten(-2))[..., :_CLIP_CAP]
        py = out.scatter(-1, target, torch.stack([iy, ny], dim=-1).flatten(-2))[..., :_CLIP_CAP]
    nxt = torch.where(slot + 1 < count, slot + 1, 0).expand(*shape, _CLIP_CAP)
    nx, ny = torch.gather(px, -1, nxt), torch.gather(py, -1, nxt)
    term = px * ny - nx * py
    acc = torch.zeros(shape, dtype=dt, device=dev)
    for s in range(_CLIP_CAP):
        acc = acc + torch.where(s < count[..., 0], term[..., s], 0.0)
    area = torch.where(count[..., 0] >= 3, 0.5 * torch.abs(acc), 0.0)
    return (area, ops + 4 * count[..., 0] + 2) if count_ops else area


def clip_reject(boxes_a, boxes_b):
    """(..., 7+) and (..., 7+) boxes, broadcast -> (...) bool: the pairs
    whose clip (``_clip_area``) kernels B4a and B4b take as exactly 0.0
    without clipping. Each box has a circle: its centre, and half its
    footprint's diagonal times 1 + 2^-6, plus 2^-10 m. A pair is rejected
    where the centres lie further apart than the two radii. A box with a
    non-finite value, or with dx or dy below (|x| + |y| + 1) * 2^-10, gets a
    NaN radius and is never rejected: near the f32 spacing of its corners an
    edge's direction is noise, and a sliver's zero-length edges pass every
    point, so its clip is an unbounded strip that a far box across it keeps a
    residue of. The kernels' ``reject_circle`` and ``disjoint`` do the same
    f32 operations in the same order."""

    def circle(b):
        b = b[..., :7].float()
        x, y, dx, dy = b[..., 0], b[..., 1], b[..., 3], b[..., 4]
        least = (x.abs() + y.abs() + 1.0) * _REJECT_SOLID
        radius = 0.5 * torch.sqrt(dx * dx + dy * dy) * _REJECT_GROW + _REJECT_PAD
        solid = torch.isfinite(b).all(-1) & (dx >= least) & (dy >= least)
        return x, y, torch.where(solid, radius, math.nan)

    xa, ya, ra = circle(boxes_a)
    xb, yb, rb = circle(boxes_b)
    ex, ey, reach = xa - xb, ya - yb, ra + rb
    return ex * ex + ey * ey > reach * reach


def _footprint_cap(overlap, boxes_a, boxes_b):
    """``overlap`` (..., N, M) capped at the smaller footprint ``dx * dy``
    of each pair: for a box narrower than the f32 spacing at its place (a
    proposal of 1e-8 m at 70 m) the corners coincide, every point passes the
    inside test of its edges of length 0, and the uncapped overlap (the JAX
    package's) gives such a pair an IoU of millions."""
    area_a = (boxes_a[..., 3] * boxes_a[..., 4])[..., :, None]
    area_b = (boxes_b[..., 3] * boxes_b[..., 4])[..., None, :]
    return torch.minimum(overlap, torch.minimum(area_a, area_b))


def _check_pairs(boxes_a, boxes_b):
    if (boxes_a.dim() != 3 or boxes_b.dim() != 3 or boxes_a.shape[0] != boxes_b.shape[0]
            or boxes_a.shape[2] < 7 or boxes_b.shape[2] < 7):
        raise ValueError(f"want boxes (B, N, 7+) and (B, M, 7+), got {tuple(boxes_a.shape)} "
                         f"and {tuple(boxes_b.shape)}")


def pairwise_overlap_bev_reference(boxes_a, boxes_b, count_ops=False):
    """Plain PyTorch version of kernel B4a: (B, N, 7+), (B, M, 7+) ->
    (B, N, M) rotated BEV overlap areas by the clip formulation, capped at
    the smaller footprint; rows in chunks that bound the pair tensors. With
    ``count_ops`` also each pair's f32 operation count (``_clip_area``)."""
    _check_pairs(boxes_a, boxes_b)
    a, b = boxes_a[..., :7].float(), boxes_b[..., :7].float()
    ca, cb = bev_corners(a), bev_corners(b)
    n, m = a.shape[1], b.shape[1]
    rows = max(1, _CLIP_CHUNK_PAIRS // max(1, a.shape[0] * m))
    parts = [_clip_area(ca[:, i:i + rows, None], cb[:, None], count_ops)
             for i in range(0, max(n, 1), rows)]
    if count_ops:
        overlap, ops = (torch.cat(t, dim=1)[:, :n] for t in zip(*parts))
        return _footprint_cap(overlap, a, b), ops
    return _footprint_cap(torch.cat(parts, dim=1)[:, :n], a, b)


def overlap_operands(boxes):
    """Kernel B4a's and B4b's operands of (B, N, 7+) boxes: the corners
    (B, N, 8) f32 (``bev_corners``, x y interleaved) and the boxes (B, N, 7)
    f32, both contiguous."""
    b7 = boxes[..., :7].float().contiguous()
    return bev_corners(b7).flatten(-2).contiguous(), b7


def overlap_launch(corners_a, boxes_a, corners_b, boxes_b):
    """One launch of kernel B4a on ``overlap_operands``' tensors (counted in
    ``pairwise_overlap_bev.launches``) -> (B, N, M) f32."""
    bsz, n, m = boxes_a.shape[0], boxes_a.shape[1], boxes_b.shape[1]
    if bsz > 65535 or (m + 31) // 32 > 65535:
        raise ValueError(f"kernel B4a takes at most 65535 samples and 65535 * 32 columns, got "
                         f"B={bsz}, M={m}")
    out = torch.empty((bsz, n, m), dtype=torch.float32, device=boxes_a.device)
    if out.numel() == 0:
        return out
    fn = load("nms_bev", _OVERLAP_ARGTYPES, "cpd_pairwise_overlap_bev")
    with torch.cuda.device(out.device):
        err = fn(corners_a.data_ptr(), boxes_a.data_ptr(), corners_b.data_ptr(), boxes_b.data_ptr(),
                 bsz, n, m, out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"pairwise_overlap_bev kernel launch failed: CUDA error {err}")
    pairwise_overlap_bev.launches += 1
    return out


def pairwise_overlap_bev(boxes_a, boxes_b):
    """(B, N, 7+), (B, M, 7+) -> (B, N, M) rotated BEV overlap areas (the
    clip formulation, capped at the smaller footprint). CUDA tensors run
    kernel B4a (``pairwise_overlap_bev.launches`` counts the launches); CPU
    tensors the plain version."""
    _check_pairs(boxes_a, boxes_b)
    if not on_cuda((("boxes_a", boxes_a), ("boxes_b", boxes_b)), contiguous=False):
        return pairwise_overlap_bev_reference(boxes_a, boxes_b)
    return overlap_launch(*overlap_operands(boxes_a), *overlap_operands(boxes_b))


pairwise_overlap_bev.launches = 0


def boxes_overlap_bev(boxes_a, boxes_b, method: str = "candidates"):
    """(N, 7), (M, 7) -> (N, M) rotated BEV overlap areas, each at most the
    smaller footprint ``dx * dy`` (``_footprint_cap``). CUDA tensors run
    kernel B4a (the clip formulation) whatever ``method`` says. CPU tensors:
    ``method="candidates"`` (the JAX package's default) the candidate hull,
    in row chunks that bound its (rows, M, 24, 24) tensors; ``"clip"`` the
    plain version of B4a."""
    if method not in ("candidates", "clip"):
        raise ValueError(f"method must be 'candidates' or 'clip', got {method!r}")
    if boxes_a.is_cuda or boxes_b.is_cuda or method == "clip":
        return pairwise_overlap_bev(boxes_a[None], boxes_b[None])[0]
    ca = boxes_to_corners_bev(boxes_a)
    cb = boxes_to_corners_bev(boxes_b)
    rows = max(1, _PAIR_CHUNK_ELEMS // max(1, cb.shape[0] * 24 * 24))
    if ca.shape[0] == 0:
        return ca.new_zeros((0, cb.shape[0]))
    overlap = torch.cat([_overlap_bev_corners(ca[i:i + rows], cb)
                         for i in range(0, ca.shape[0], rows)], dim=0)
    return _footprint_cap(overlap, boxes_a, boxes_b)


def paired_iou3d(boxes_a, boxes_b):
    """(N, 7), (N, 7) -> (N,) 3D IoU of each row of ``boxes_a`` with the same
    row of ``boxes_b``: ``boxes_iou3d``'s diagonal, differentiable (the
    hull's successor choice is a constant under autograd)."""
    ca = boxes_to_corners_bev(boxes_a)
    cb = boxes_to_corners_bev(boxes_b)
    inter_pts, inter_valid = _segment_intersections(ca, cb)
    overlap = _convex_area_from_candidates(
        torch.cat([ca, cb, inter_pts], dim=-2),
        torch.cat([_points_in_convex_quad(ca, cb), _points_in_convex_quad(cb, ca), inter_valid],
                  dim=-1))
    overlap = torch.minimum(overlap, torch.minimum(boxes_a[:, 3] * boxes_a[:, 4],
                                                   boxes_b[:, 3] * boxes_b[:, 4]))
    overlap_h = torch.clamp(torch.minimum(boxes_a[:, 2] + boxes_a[:, 5] / 2.0,
                                          boxes_b[:, 2] + boxes_b[:, 5] / 2.0)
                            - torch.maximum(boxes_a[:, 2] - boxes_a[:, 5] / 2.0,
                                            boxes_b[:, 2] - boxes_b[:, 5] / 2.0), min=0.0)
    overlap_3d = overlap * overlap_h
    vol_a = boxes_a[:, 3] * boxes_a[:, 4] * boxes_a[:, 5]
    vol_b = boxes_b[:, 3] * boxes_b[:, 4] * boxes_b[:, 5]
    return overlap_3d / torch.clamp(vol_a + vol_b - overlap_3d, min=1e-6)


def iou_bev_from_overlap(overlap, boxes_a, boxes_b):
    """(..., N, M) BEV overlaps of (..., N, 7+) and (..., M, 7+) boxes ->
    their BEV IoU (kernel B4b's arithmetic)."""
    area_a = (boxes_a[..., 3] * boxes_a[..., 4])[..., :, None]
    area_b = (boxes_b[..., 3] * boxes_b[..., 4])[..., None, :]
    return overlap / torch.clamp(area_a + area_b - overlap, min=1e-6)


def iou3d_from_overlap(overlap_bev, boxes_a, boxes_b):
    """(..., N, M) BEV overlaps -> 3D IoU: the BEV overlap times the z-extent
    overlap (kernel B4b's arithmetic)."""
    a_zmin = (boxes_a[..., 2] - boxes_a[..., 5] / 2.0)[..., :, None]
    a_zmax = (boxes_a[..., 2] + boxes_a[..., 5] / 2.0)[..., :, None]
    b_zmin = (boxes_b[..., 2] - boxes_b[..., 5] / 2.0)[..., None, :]
    b_zmax = (boxes_b[..., 2] + boxes_b[..., 5] / 2.0)[..., None, :]
    overlap_h = torch.clamp(torch.minimum(a_zmax, b_zmax) - torch.maximum(a_zmin, b_zmin),
                            min=0.0)
    overlap_3d = overlap_bev * overlap_h
    vol_a = (boxes_a[..., 3] * boxes_a[..., 4] * boxes_a[..., 5])[..., :, None]
    vol_b = (boxes_b[..., 3] * boxes_b[..., 4] * boxes_b[..., 5])[..., None, :]
    return overlap_3d / torch.clamp(vol_a + vol_b - overlap_3d, min=1e-6)


def boxes_iou_bev(boxes_a, boxes_b):
    """(N, 7), (M, 7) -> (N, M) rotated BEV IoU (``boxes_overlap_bev``'s
    routes)."""
    return iou_bev_from_overlap(boxes_overlap_bev(boxes_a, boxes_b), boxes_a, boxes_b)


def boxes_iou3d(boxes_a, boxes_b):
    """(N, 7), (M, 7) -> (N, M) 3D IoU: BEV overlap times the z-extent
    overlap (``boxes_overlap_bev``'s routes)."""
    return iou3d_from_overlap(boxes_overlap_bev(boxes_a, boxes_b), boxes_a, boxes_b)


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
