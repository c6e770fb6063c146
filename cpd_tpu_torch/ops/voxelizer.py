"""Dynamic voxelization fused with the MeanVFE mean (port of
cpd_tpu/ops/voxelizer.py).

Sort the points by (voxel key, point index), segment-mean their features into
a fixed ``max_voxels`` table in ascending key order (a sorted segment sum, in
point order: deterministic on the card too), and emit the voxel coords and a
validity mask. Slot ``max_voxels`` of the segment sums is the overflow
bucket: voxels beyond the cap (the highest keys) are dropped there.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

INT32_MAX = 2**31 - 1


class VoxelizerSpec(NamedTuple):
    point_cloud_range: tuple  # (xmin, ymin, zmin, xmax, ymax, zmax)
    voxel_size: tuple  # (vx, vy, vz)
    grid_size: tuple  # (nx, ny, nz), derived
    max_voxels: int
    # spconv parity: mean over only the FIRST n points of each voxel in point
    # order; None = mean over all points of the voxel
    max_points_per_voxel: int = None

    @staticmethod
    def create(point_cloud_range: Sequence[float], voxel_size: Sequence[float],
               max_voxels: int, max_points_per_voxel: int = None):
        pcr = tuple(float(x) for x in point_cloud_range)
        vs = tuple(float(x) for x in voxel_size)
        grid = tuple(int(round((pcr[i + 3] - pcr[i]) / vs[i])) for i in range(3))
        return VoxelizerSpec(
            pcr, vs, grid, int(max_voxels),
            None if max_points_per_voxel is None else int(max_points_per_voxel))


class VoxelizedFrame(NamedTuple):
    features: torch.Tensor  # (V_cap, C) mean point features per voxel
    coords: torch.Tensor  # (V_cap, 3) int32 zyx coords, -1 padded
    num_points: torch.Tensor  # (V_cap,) int32 points per voxel
    valid: torch.Tensor  # (V_cap,) bool
    point_voxel_id: torch.Tensor  # (P_cap,) int32 row in the voxel table, -1 if dropped


def compute_voxel_keys(points, spec: VoxelizerSpec, valid=None):
    """(P, 3+) points -> (P,) int32 key ((z * ny) + y) * nx + x; -1 if the
    point is out of range or invalid."""
    pcr = torch.tensor(spec.point_cloud_range, dtype=points.dtype, device=points.device)
    vs = torch.tensor(spec.voxel_size, dtype=points.dtype, device=points.device)
    nx, ny, nz = spec.grid_size
    ijk = torch.floor((points[:, :3] - pcr[:3]) / vs).to(torch.int32)  # xyz
    in_range = ((ijk[:, 0] >= 0) & (ijk[:, 0] < nx) & (ijk[:, 1] >= 0)
                & (ijk[:, 1] < ny) & (ijk[:, 2] >= 0) & (ijk[:, 2] < nz))
    if valid is not None:
        in_range = in_range & valid
    key = (ijk[:, 2] * ny + ijk[:, 1]) * nx + ijk[:, 0]
    return torch.where(in_range, key, -1)


def key_to_coords(key, spec: VoxelizerSpec):
    """(V,) int32 keys -> (V, 3) int32 zyx coords (-1 rows preserved)."""
    nx, ny, _ = spec.grid_size
    coords = torch.stack([key // (nx * ny), (key // nx) % ny, key % nx], dim=-1)
    return torch.where(key[:, None] >= 0, coords, -1).to(torch.int32)


def voxelize(points, spec: VoxelizerSpec, valid=None,
             with_point_voxel_id: bool = False) -> VoxelizedFrame:
    """Dynamic voxelization + mean VFE for one frame.

    points: (P, C) with xyz in the first 3 channels; ``valid`` masks padded
    points. Voxels come out in ascending key order, padded rows at the end.
    ``with_point_voxel_id``: map each point to its voxel's row (only
    PillarVFE reads it); otherwise the field is all -1.
    """
    p_cap, c = points.shape
    v_cap = spec.max_voxels
    dev = points.device
    key = compute_voxel_keys(points, spec, valid)
    sort_key = torch.where(key >= 0, key, INT32_MAX)
    # a stable sort on the key orders ties by point index: the total
    # (key, index) order of the two-key sort in the JAX package
    skey, order = torch.sort(sort_key, stable=True)
    sorted_pts = points[order]
    first = torch.ones_like(skey, dtype=torch.bool)
    first[1:] = skey[1:] != skey[:-1]
    point_ok = skey < INT32_MAX
    first = first & point_ok
    slot = torch.cumsum(first.to(torch.int32), 0, dtype=torch.int32) - 1
    if spec.max_points_per_voxel is not None:
        iota = torch.arange(p_cap, dtype=torch.int64, device=dev)
        seg_start = torch.cummax(torch.where(first, iota, 0), 0).values
        point_ok = point_ok & (iota - seg_start < spec.max_points_per_voxel)
    # feature sums and point counts in ONE sorted segment sum: counts ride as
    # a ones column. The points are sorted by slot, so every slot's points are
    # contiguous and each sum runs in point order (no atomics: the same bits
    # on every run). Points that add nothing (invalid, past max_points) keep
    # their place with zeros; slot v_cap gathers the voxels past the cap.
    segment = torch.clamp(slot, 0, v_cap).to(torch.int64)
    aug = torch.cat([sorted_pts, torch.ones((p_cap, 1), dtype=points.dtype, device=dev)], 1)
    aug = torch.where(point_ok[:, None], aug, 0.0)
    lengths = torch.zeros(v_cap + 1, dtype=torch.int64, device=dev).scatter_add_(
        0, segment, torch.ones_like(segment))  # integer counts: exact in any order
    sums = torch.segment_reduce(aug, "sum", lengths=lengths, unsafe=True)[:v_cap]
    counts = sums[:, -1].to(torch.int32)
    feats = sums[:, :-1] / torch.clamp(counts[:, None], min=1).to(points.dtype)
    key_slot = torch.where(first & (slot < v_cap), slot, v_cap).to(torch.int64)
    voxel_keys = torch.full((v_cap + 1,), -1, dtype=torch.int32, device=dev)
    voxel_keys[key_slot] = skey.to(torch.int32)  # slot v_cap: dropped writes
    voxel_keys = voxel_keys[:v_cap]
    valid_voxels = counts > 0
    voxel_keys = torch.where(valid_voxels, voxel_keys, -1)
    point_voxel_id = torch.full((p_cap,), -1, dtype=torch.int32, device=dev)
    if with_point_voxel_id:
        # ``order`` is a permutation: every row is written once
        pv = torch.where(point_ok & (slot < v_cap), slot, -1)
        point_voxel_id.index_copy_(0, order, pv)
    return VoxelizedFrame(
        features=torch.where(valid_voxels[:, None], feats, 0.0),
        coords=key_to_coords(voxel_keys, spec),
        num_points=counts,
        valid=valid_voxels,
        point_voxel_id=point_voxel_id,
    )


def voxelize_batch(points, spec: VoxelizerSpec, valid=None,
                   with_point_voxel_id: bool = False) -> VoxelizedFrame:
    """points (B, P, C) -> VoxelizedFrame with a leading B axis."""
    if valid is None:
        valid = torch.ones(points.shape[:2], dtype=torch.bool, device=points.device)
    frames = [voxelize(points[i], spec, valid[i], with_point_voxel_id)
              for i in range(points.shape[0])]
    return VoxelizedFrame(*(torch.stack(f) for f in zip(*frames)))
