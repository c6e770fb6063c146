"""VectorPool aggregation (port of cpd_tpu/models/vector_pool.py).

Each query point owns a dense k x k x k grid of cells over [-R, R]^3; every
cell aggregates support features (3-NN inverse-distance interpolation at
its centre, the mean over its points, or its first point in scan order),
and a separate linear layer per cell mixes channels before shared MLPs.
All pairs of queries and support points are formed, in chunks of queries
that bound the (rows, N, 3) temporaries.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..ops.fps import fused_norm
from ..ops.nms import top_k
from .norm import MaskedBatchNorm

# query rows per chunk: rows * N stays at or below this many pairs
_PAIR_CHUNK = 1 << 26


def local_grid_offsets(num_voxels: Tuple[int, int, int], radius: float) -> np.ndarray:
    """(G, 3) f32 cell-centre offsets of the local grid in [-R, R]^3, x-major
    (z fastest)."""
    r = radius
    nx, ny, nz = num_voxels
    xs = np.linspace(-r + r / nx, r - r / nx, nx)
    ys = np.linspace(-r + r / ny, r - r / ny, ny)
    zs = np.linspace(-r + r / nz, r - r / nz, nz)
    gx, gy, gz = np.meshgrid(xs, ys, zs, indexing="ij")
    return np.stack([gx.ravel(), gy.ravel(), gz.ravel()], axis=1).astype(np.float32)


def _three_nn(flat, support_xyz, support_valid, max_dist, neighbor_type):
    """(Q, 3) queries -> (top (Q, 3) negated distances, idx (Q, 3)) of the
    three nearest valid support points within the cutoff (-inf where fewer
    qualify; ties to the lower index, as ``jax.lax.top_k``)."""
    diff = flat[:, None, :] - support_xyz[None, :, :]
    d = fused_norm(diff)  # the f32 chain jnp.linalg.norm makes under jit
    if neighbor_type == 1:
        in_range = d <= max_dist
    else:
        in_range = torch.abs(diff).amax(dim=-1) <= max_dist
    dm = torch.where(in_range & support_valid[None, :], d, float("inf"))
    return top_k(-dm, 3)


def three_nn_vector_pool(centers, centers_valid, support_xyz, support_valid, support_feats,
                         max_dist: float, neighbor_type: int = 0):
    """3-NN inverse-distance interpolation at each local-grid centre within
    a cutoff (``neighbor_type`` 1: the L2 ball, else the L-inf cube).

    centers (M, G, 3), centers_valid (M,); support (N, 3) / (N,) / (N, C).
    Returns (feats (M, G, C), local_xyz (M, G, 9), empty (M, G) bool)."""
    m, g, _ = centers.shape
    flat = centers.reshape(m * g, 3)
    rows = max(1, _PAIR_CHUNK // max(1, support_xyz.shape[0]))
    parts = [_three_nn(flat[i:i + rows], support_xyz, support_valid, max_dist, neighbor_type)
             for i in range(0, m * g, rows)]
    nd = torch.cat([p[0] for p in parts])
    ni = torch.cat([p[1] for p in parts])
    found = torch.isfinite(nd)
    w = torch.where(found, 1.0 / (torch.clamp(-nd, min=0.0) + 1e-8), 0.0)
    w = w / torch.clamp(w.sum(dim=1, keepdim=True), min=1e-8)
    feats = torch.einsum("qk,qkc->qc", w, support_feats[ni])
    local = flat[:, None, :] - support_xyz[ni]  # grid centre - neighbour
    local = torch.where(found[..., None], local, 0.0).reshape(m * g, 9)
    empty = ~found.any(dim=1) | ~centers_valid.repeat_interleave(g)
    feats = torch.where(empty[:, None], 0.0, feats)
    local = torch.where(empty[:, None], 0.0, local)
    return feats.reshape(m, g, -1), local.reshape(m, g, 9), empty.reshape(m, g)


def voxel_pool(centers_xyz, centers_valid, support_xyz, support_valid, support_feats,
               num_voxels: Tuple[int, int, int], radius: float, mode: str = "avg"):
    """Per-local-cell pooling: each support point within the [-R, R)^3 cube
    of a query lands in one of its G cells; ``avg`` takes the mean of the
    features and local xyz (point - centre) of a cell's points, ``choice``
    its first point in scan order. Returns (feats (M, G, C), local_xyz
    (M, G, 3), cnt (M, G))."""
    nx, ny, nz = num_voxels
    g = nx * ny * nz
    m, n = centers_xyz.shape[0], support_xyz.shape[0]
    loc = support_xyz[None, :, :] - centers_xyz[:, None, :]  # -(centre - point)
    ok = ((torch.abs(loc).amax(dim=-1) < radius) & support_valid[None, :]
          & centers_valid[:, None])
    size = torch.tensor([nx, ny, nz], dtype=torch.float32, device=loc.device)
    cell = torch.floor((loc + radius) / (2 * radius) * size)
    cell = torch.minimum(torch.clamp(cell, min=0.0), size - 1)
    cid = ((cell[..., 0] * ny + cell[..., 1]) * nz + cell[..., 2]).to(torch.int64)
    slot = torch.where(ok, cid + g * torch.arange(m, device=cid.device)[:, None], m * g)
    slot = slot.reshape(-1)  # row m * g takes the points of no cell
    dtype = support_feats.dtype
    cnt = torch.zeros(m * g + 1, dtype=dtype, device=loc.device).index_add_(
        0, slot, ok.reshape(-1).to(dtype))[:-1].reshape(m, g)
    feats = support_feats[None].expand(m, n, -1).reshape(m * n, -1)
    locs = loc.reshape(m * n, 3)
    if mode == "avg":
        fsum = feats.new_zeros((m * g + 1, feats.shape[1])).index_add_(0, slot, feats)
        xsum = locs.new_zeros((m * g + 1, 3)).index_add_(0, slot, locs)
        denom = torch.clamp(cnt, min=1.0)[..., None]
        return (fsum[:-1].reshape(m, g, -1) / denom, xsum[:-1].reshape(m, g, 3) / denom, cnt)
    # first-found choice: the lowest scan index among each cell's points
    order = torch.arange(m * n, device=slot.device)
    first = torch.full((m * g + 1,), m * n, dtype=torch.int64, device=slot.device)
    first = first.scatter_reduce(0, slot, order, "amin")[:-1]
    hit = first < m * n
    pick = torch.where(hit, first, 0)
    out_f = torch.where(hit[:, None], feats[pick], 0.0).reshape(m, g, -1)
    out_x = torch.where(hit[:, None], locs[pick], 0.0).reshape(m, g, 3)
    return out_f, out_x, cnt


class VectorPoolAggregation(nn.Module):
    """One VectorPool group on a batch: (B, N, 3) support xyz and (B, N, C)
    features at (B, M, 3) queries -> (B, M, post_mlps[-1]), 0 at invalid
    queries. Batch statistics in training mode come from the valid queries."""

    def __init__(self, input_channels: int, num_local_voxel: Tuple[int, int, int] = (3, 3, 3),
                 local_aggregation_type: str = "local_interpolation",
                 num_reduced_channels: int = 30, num_channels_of_local_aggregation: int = 32,
                 post_mlps: Sequence[int] = (128,), max_neighbor_distance: float = 1.6,
                 neighbor_nsample: int = -1, neighbor_type: int = 0,
                 neighbor_distance_multiplier: float = 2.0):
        super().__init__()
        if local_aggregation_type not in ("local_interpolation", "voxel_avg_pool",
                                          "voxel_random_choice"):
            raise ValueError(f"unknown local_aggregation_type {local_aggregation_type!r}")
        if input_channels % num_reduced_channels:
            raise ValueError(f"{input_channels} channels do not reduce by "
                             f"{num_reduced_channels}")
        self.num_local_voxel = tuple(num_local_voxel)
        self.local_aggregation_type = local_aggregation_type
        self.num_reduced_channels = num_reduced_channels
        self.max_neighbor_distance = max_neighbor_distance
        self.neighbor_nsample = neighbor_nsample
        self.neighbor_type = neighbor_type
        self.neighbor_distance_multiplier = neighbor_distance_multiplier
        g = int(np.prod(self.num_local_voxel))
        d = num_channels_of_local_aggregation
        cin_g = num_reduced_channels + (9 if local_aggregation_type == "local_interpolation"
                                        else 3)
        self.sep_kernel = nn.Parameter(torch.randn(g, cin_g, d) * np.sqrt(2.0 / cin_g))
        self.sep_bn = MaskedBatchNorm(g * d)
        self.num_post = len(post_mlps)
        width = g * d
        for i, ch in enumerate(post_mlps):
            setattr(self, f"post_{i}", nn.Linear(width, ch, bias=False))
            setattr(self, f"post_bn_{i}", MaskedBatchNorm(ch))
            width = ch
        self.register_buffer("offsets", torch.from_numpy(local_grid_offsets(
            self.num_local_voxel, max_neighbor_distance)), persistent=False)

    def _vectors(self, cx, cv, sx, sv, sf):
        """One sample's (M, G, cin_g) local vectors."""
        if self.local_aggregation_type == "local_interpolation":
            f, lx, _ = three_nn_vector_pool(
                cx[:, None, :] + self.offsets[None], cv, sx, sv, sf,
                self.max_neighbor_distance * self.neighbor_distance_multiplier,
                self.neighbor_type)
            return torch.cat([f, lx], dim=-1)
        mode = "avg" if self.local_aggregation_type == "voxel_avg_pool" else "choice"
        f, lx, _ = voxel_pool(cx, cv, sx, sv, sf, self.num_local_voxel,
                              self.max_neighbor_distance, mode)
        return torch.cat([lx, f], dim=-1)

    def forward(self, xyz, xyz_valid, features, new_xyz, new_valid):
        red = self.num_reduced_channels
        feats = features.reshape(*features.shape[:-1], -1, red).sum(dim=-2)
        vec = torch.stack([self._vectors(*a) for a in zip(new_xyz, new_valid, xyz, xyz_valid,
                                                          feats)])
        out = torch.einsum("bmgc,gcd->bmgd", vec, self.sep_kernel)
        out = out.reshape(out.shape[0], out.shape[1], -1)
        out = torch.relu(self.sep_bn(out, new_valid))
        for i in range(self.num_post):
            out = getattr(self, f"post_{i}")(out)
            out = torch.relu(getattr(self, f"post_bn_{i}")(out, new_valid))
        return torch.where(new_valid[..., None], out, 0.0)


class VectorPoolAggregationMSG(nn.Module):
    """Several VectorPool groups (``groups``: dicts of num_local_voxel,
    post_mlps, max_neighbor_distance and optionally neighbor_nsample), their
    outputs concatenated after the query xyz, then shared MLPs."""

    def __init__(self, input_channels: int, groups: Sequence[dict] = (),
                 local_aggregation_type: str = "local_interpolation",
                 num_reduced_channels: Optional[int] = None,
                 num_channels_of_local_aggregation: int = 32,
                 msg_post_mlps: Sequence[int] = (128,)):
        super().__init__()
        red = input_channels if num_reduced_channels is None else num_reduced_channels
        self.num_groups, self.num_post = len(groups), len(msg_post_mlps)
        width = 3
        for k, cfg in enumerate(groups):
            setattr(self, f"layer_{k}", VectorPoolAggregation(
                input_channels, num_local_voxel=tuple(cfg["num_local_voxel"]),
                local_aggregation_type=local_aggregation_type, num_reduced_channels=red,
                num_channels_of_local_aggregation=num_channels_of_local_aggregation,
                post_mlps=tuple(cfg["post_mlps"]),
                max_neighbor_distance=cfg["max_neighbor_distance"],
                neighbor_nsample=cfg.get("neighbor_nsample", -1)))
            width += cfg["post_mlps"][-1]
        for i, ch in enumerate(msg_post_mlps):
            setattr(self, f"msg_post_{i}", nn.Linear(width, ch, bias=False))
            setattr(self, f"msg_post_bn_{i}", MaskedBatchNorm(ch))
            width = ch

    def forward(self, xyz, xyz_valid, features, new_xyz, new_valid):
        outs = [getattr(self, f"layer_{k}")(xyz, xyz_valid, features, new_xyz, new_valid)
                for k in range(self.num_groups)]
        out = torch.cat([new_xyz] + outs, dim=-1)
        for i in range(self.num_post):
            out = getattr(self, f"msg_post_{i}")(out)
            out = torch.relu(getattr(self, f"msg_post_bn_{i}")(out, new_valid))
        return torch.where(new_valid[..., None], out, 0.0)
