"""Pooling primitives: RoI grid points, voxel queries, group-and-pool, ball
query, farthest point sampling and 3-NN interpolation (port of
cpd_tpu/ops/pool.py).

The RoI head reads ``voxel_query_multi`` (first hits in tap order); the PFE
reads ``voxel_query`` (the nearest voxels) and ``farthest_point_sample``,
which runs kernel F1 on the card (``ops/fps.py``). ``ball_query`` and
``three_nn_interpolate`` are plain functions that no path calls."""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from . import fps
from .geometry import rotate_points_along_z
from .sparse import INVALID_KEY, GridSpec, lookup


def roi_grid_points(rois, grid_size: int):
    """(N, 7+) rois -> (N, grid_size^3, 3) world xyz of the dense RoI grid."""
    g = grid_size
    idx = torch.arange(g, dtype=torch.float32, device=rois.device)
    zz, yy, xx = torch.meshgrid(idx, idx, idx, indexing="ij")
    unit = torch.stack([xx, yy, zz], dim=-1).reshape(-1, 3)
    local = (unit + 0.5) / g - 0.5
    pts = local[None, :, :] * rois[:, None, 3:6]
    pts = rotate_points_along_z(pts, rois[:, 6])
    return pts + rois[:, None, 0:3]


def _taps_for_radius_list(query_range: Tuple[int, int, int], voxel_size_eff,
                          radius: float, max_taps: int = 135):
    """Every (dz, dy, dx) offset whose nearest point to a query anywhere in
    its own cell lies within ``radius``, ordered by nominal center distance
    (ties lexicographic), truncated to ``max_taps``."""
    rz, ry, rx = query_range
    vsx, vsy, vsz = (float(v) for v in voxel_size_eff)
    offs = []
    for dz in range(-rz, rz + 1):
        for dy in range(-ry, ry + 1):
            for dx in range(-rx, rx + 1):
                md2 = ((max(abs(dx) - 0.5, 0.0) * vsx) ** 2
                       + (max(abs(dy) - 0.5, 0.0) * vsy) ** 2
                       + (max(abs(dz) - 0.5, 0.0) * vsz) ** 2)
                if md2 <= radius * radius + 1e-9:
                    offs.append((dz, dy, dx))
    offs.sort(key=lambda o: ((o[0] * vsz) ** 2 + (o[1] * vsy) ** 2 + (o[2] * vsx) ** 2, o))
    return offs[:max_taps]


def _window_offsets(query_range: Tuple[int, int, int], max_taps: int = 135):
    """(dz, dy, dx) offsets of the (2R+1)^3 window ordered by distance from
    the centre (ties lexicographic), truncated to the ``max_taps`` closest."""
    rz, ry, rx = query_range
    offs = [(dz, dy, dx) for dz in range(-rz, rz + 1) for dy in range(-ry, ry + 1)
            for dx in range(-rx, rx + 1)]
    offs.sort(key=lambda o: (o[0] ** 2 + o[1] ** 2 + o[2] ** 2, o))
    return offs[:max_taps]


def _top_k(score, k: int):
    """``jax.lax.top_k`` along the last axis: the ``k`` largest, ties to the
    lower index (a stable sort; ``torch.topk`` promises no tie order)."""
    top, sel = torch.sort(score, dim=-1, descending=True, stable=True)
    return top[..., :k], sel[..., :k]


def query_cells(query_xyz, pcr, vs):
    """floor((q - pcr) / vs) as the jitted JAX query computes it: XLA rewrites
    the division by the constant cell size as a product with its f32
    reciprocal, and a query within an ulp of a cell face lands in the cell
    that the product gives."""
    return torch.floor((query_xyz - pcr) * (1.0 / vs))


def voxel_centers(cells, vs, pcr):
    """f32 world centres ``(cells + 0.5) * vs + pcr`` of integer ``cells``
    as the jitted JAX query computes them: XLA:CPU contracts the product and
    the sum into one fused multiply-add, rounded once (emulated in f64, where
    the product of two f32 values is exact). Rounding the product first puts
    a centre an ulp off, and a query equidistant from two voxels then orders
    them otherwise."""
    half = (cells.to(torch.float32) + 0.5).double()
    return (half * vs.double() + pcr.double()).float()


def voxel_query(query_xyz, voxel_keys, grid: GridSpec, voxel_size, point_cloud_range,
                downsample: int, query_range: Tuple[int, int, int], radius: float,
                nsample: int):
    """For each query point the ``nsample`` nearest occupied voxels (by
    centre distance, ties to the lower tap) within ``radius`` m inside the
    (2R+1)^3 window of its own cell. query_xyz (Q, 3); voxel_keys (V,)
    sorted, INVALID_KEY padded.

    Returns (idx (Q, nsample) int32, valid (Q, nsample) bool, centers (Q,
    nsample, 3)). As in the JAX package, an unfilled slot holds the tap that
    ``top_k`` put there, and a tap that found no voxel the clamped
    insertion point of its key."""
    dev = query_xyz.device
    vs = torch.tensor(voxel_size, dtype=torch.float32, device=dev) * downsample
    pcr = torch.tensor(point_cloud_range[:3], dtype=torch.float32, device=dev)
    qc = query_cells(query_xyz, pcr, vs).to(torch.int64)  # (Q, 3) xyz
    offs = torch.tensor(_window_offsets(query_range), dtype=torch.int64, device=dev)
    nc = qc.flip(-1)[:, None, :] + offs[None]  # (Q, W, 3) zyx
    in_bounds = ((nc[..., 2] >= 0) & (nc[..., 2] < grid.nx) & (nc[..., 1] >= 0)
                 & (nc[..., 1] < grid.ny) & (nc[..., 0] >= 0) & (nc[..., 0] < grid.nz))
    nkeys = torch.where(in_bounds, (nc[..., 0] * grid.ny + nc[..., 1]) * grid.nx + nc[..., 2],
                        INVALID_KEY)
    keys64 = voxel_keys.long()
    idx = torch.clamp(torch.searchsorted(keys64, nkeys.reshape(-1)), 0, len(keys64) - 1)
    found = ((keys64[idx] == nkeys.reshape(-1)) & (nkeys.reshape(-1) != INVALID_KEY))
    idx, found = idx.reshape(nkeys.shape), found.reshape(nkeys.shape)
    centers = voxel_centers(nc.flip(-1), vs, pcr)  # (Q, W, 3) xyz
    dist = fps.fused_norm(centers - query_xyz[:, None, :])
    score = torch.where(found & (dist <= radius), -dist, float("-inf"))
    top, sel = _top_k(score, nsample)
    sel_centers = torch.gather(centers, 1, sel[..., None].expand(-1, -1, 3))
    return (torch.gather(idx, 1, sel).to(torch.int32), torch.isfinite(top), sel_centers)


def voxel_query_fast(query_xyz, voxel_keys, grid: GridSpec, voxel_size, point_cloud_range,
                     downsample: int, query_range: Tuple[int, int, int], radius: float,
                     nsample: int):
    """JAX's single-radius query with its default ``select="nearest"``: its
    tap set keeps every tap of the window that can hold a voxel within the
    radius, so it is ``voxel_query`` where the query's own cell lies in the
    grid, and finds nothing where it does not."""
    idx, valid, centers = voxel_query(query_xyz, voxel_keys, grid, voxel_size, point_cloud_range,
                                      downsample, query_range, radius, nsample)
    vs = torch.tensor(voxel_size, dtype=torch.float32, device=query_xyz.device) * downsample
    pcr = torch.tensor(point_cloud_range[:3], dtype=torch.float32, device=query_xyz.device)
    qc = query_cells(query_xyz, pcr, vs)
    size = torch.tensor((grid.nx, grid.ny, grid.nz), dtype=torch.float32, device=qc.device)
    in_grid = ((qc >= 0) & (qc < size)).all(dim=-1)
    return idx, valid & in_grid[:, None], centers


def voxel_query_multi(query_xyz, voxel_keys, grid: GridSpec, voxel_size, point_cloud_range,
                      downsample: int, query_range: Tuple[int, int, int],
                      radii: Tuple[float, ...], nsample: int, max_taps: int = 135):
    """Multi-radius voxel query: for each query point and radius, the first
    ``nsample`` occupied voxels within the radius in tap order.

    The union tap list is in nested-prefix order (the smallest radius's taps
    first, then each larger radius's new ones), so each radius reads a
    prefix of one shared lookup. query_xyz (Q, 3); voxel_keys (V,) sorted.
    Returns per radius (idx (Q, nsample) int32, valid (Q, nsample) bool,
    centers (Q, nsample, 3)); unfilled slots have idx 0, valid False and the
    center of tap 0.
    """
    dev = query_xyz.device
    vs = torch.tensor(voxel_size, dtype=torch.float32, device=dev) * downsample
    pcr = torch.tensor(point_cloud_range[:3], dtype=torch.float32, device=dev)
    qc = query_cells(query_xyz, pcr, vs).to(torch.int64)  # (Q, 3) xyz
    vs_eff = tuple(float(x) * downsample for x in voxel_size)
    union_list, prefix_len = [], {}
    for rr in sorted(set(radii)):
        for o in _taps_for_radius_list(query_range, vs_eff, rr, max_taps):
            if o not in union_list and len(union_list) < max_taps:
                union_list.append(o)
        prefix_len[rr] = len(union_list)
    offs = torch.tensor(union_list, dtype=torch.int64, device=dev)  # (W, 3) zyx
    nx_c = qc[None, :, 0] + offs[:, None, 2]  # (W, Q)
    ny_c = qc[None, :, 1] + offs[:, None, 1]
    nz_c = qc[None, :, 2] + offs[:, None, 0]
    # a query outside the grid finds nothing (its own cell has no key)
    in_grid = ((qc[:, 0] >= 0) & (qc[:, 0] < grid.nx) & (qc[:, 1] >= 0)
               & (qc[:, 1] < grid.ny) & (qc[:, 2] >= 0) & (qc[:, 2] < grid.nz))
    idx_all, found_all = lookup(voxel_keys, nz_c, ny_c, nx_c, grid,
                                in_grid[None, :].expand_as(nx_c))
    dxc = (nx_c.to(torch.float32) + 0.5) * vs[0] + pcr[0] - query_xyz[None, :, 0]
    dyc = (ny_c.to(torch.float32) + 0.5) * vs[1] + pcr[1] - query_xyz[None, :, 1]
    dzc = (nz_c.to(torch.float32) + 0.5) * vs[2] + pcr[2] - query_xyz[None, :, 2]
    dist2 = dxc * dxc + dyc * dyc + dzc * dzc
    q_n = query_xyz.shape[0]
    outs = []
    for radius in radii:
        wi = prefix_len[radius]
        ok = found_all[:wi] & (dist2[:wi] <= radius * radius)
        slot = torch.cumsum(ok.to(torch.int64), dim=0) - 1
        # slot nsample is the drop column for taps past the first nsample hits
        target = torch.where(ok & (slot < nsample), slot, nsample).T  # (Q, wi)
        taps = torch.arange(wi, device=dev).expand(q_n, wi)

        def place(vals, dtype):
            out = torch.zeros((q_n, nsample + 1), dtype=dtype, device=dev)
            return out.scatter_(1, target, vals.to(dtype))[:, :nsample]

        sel_idx = place(idx_all[:wi].T, torch.int32)
        sel_valid = place(torch.ones_like(target, dtype=torch.bool), torch.bool)
        tap_ids = place(taps, torch.int64)
        c_xyz = qc[:, None, :] + offs[tap_ids].flip(-1)  # (Q, nsample, 3) xyz
        sel_centers = (c_xyz.to(torch.float32) + 0.5) * vs + pcr
        outs.append((sel_idx, sel_valid, sel_centers))
    return tuple(outs)


def group_and_pool(features, idx, valid, rel_pos, mlp_fn):
    """Grouping + shared MLP + masked max-pool.

    features (V, C); idx/valid (Q, K); rel_pos (Q, K, 3) query-to-neighbour
    offsets; mlp_fn: (Q, K, C+3) -> (Q, K, D). Returns (Q, D).

    The row gather is ``F.embedding``: the same values as ``features[idx]``,
    but its backward is the sorted segment sum written for an index with
    many repeats (a voxel near an RoI is gathered thousands of times), where
    the backward of ``features[idx]`` took 1.5 s of a 1.9 s training step on
    an H100 (chip_smoke.py's profile)."""
    g = F.embedding(idx.long(), features)
    g = torch.cat([rel_pos.to(features.dtype), g], dim=-1)
    g = torch.where(valid[..., None], g, 0.0)
    h = mlp_fn(g)
    h = torch.where(valid[..., None], h, -1e9)
    pooled = h.amax(dim=1)
    return torch.where(valid.any(dim=1)[:, None], pooled, 0.0)


def ball_query(query_xyz, points_xyz, points_valid, radius: float, nsample: int):
    """Dense ball query: for each of (Q, 3) queries the ``nsample`` nearest
    valid points of (N, 3+) ``points_xyz`` within ``radius`` (ties to the
    lower index). Returns (idx (Q, nsample) int32, valid (Q, nsample))."""
    d = fps.fused_norm(query_xyz[:, None, :] - points_xyz[None, :, :3])
    ok = (d <= radius) & points_valid[None, :]
    top, sel = _top_k(torch.where(ok, -d, float("-inf")), nsample)
    return sel.to(torch.int32), torch.isfinite(top)


def farthest_point_sample(points, valid, num_samples: int):
    """Farthest point sampling of one cloud: (N, 3) points, (N,) bool valid
    -> (num_samples,) int32 indices (kernel F1 on the card, ``ops/fps.py``)."""
    return fps.farthest_point_sample(points[None], valid[None], num_samples)[0]


def three_nn_interpolate(query_xyz, support_xyz, support_valid, support_feats):
    """Inverse-distance interpolation from the 3 nearest valid support
    points: (Q, 3) queries, (N, 3) support with (N,) valid and (N, C)
    features -> (Q, C)."""
    d = fps.fused_norm(query_xyz[:, None, :] - support_xyz[None, :, :])
    d = torch.where(support_valid[None, :], d, float("inf"))
    nd, ni = _top_k(-d, 3)
    w = torch.where(torch.isfinite(nd), 1.0 / torch.clamp(-nd, min=1e-8), 0.0)
    w = w / torch.clamp(w.sum(dim=1, keepdim=True), min=1e-8)
    return torch.einsum("qk,qkc->qc", w, support_feats[ni])
