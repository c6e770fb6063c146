"""PointPillars components: PillarVFE and the scatter to BEV (port of
cpd_tpu/models/pillars.py).

The pillar net works on the dynamic voxelizer's output: every point, with
its offsets from its pillar's mean and centre, goes through linear + masked
batch norm + ReLU, and a segment max over the point -> pillar map pools
them. Both the segment max and the scatter write each target once (or take
an exact maximum), so a run gives the same bits every time on the card.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from ..ops.sparse import INVALID_KEY, GridSpec
from .norm import MaskedBatchNorm


class PillarVFE(nn.Module):
    """Pillar feature net over per-point inputs: points (P, C), point_voxel_id
    (P,) into the pillar table (-1: no pillar), pillar mean xyz (V, 3), pillar
    centres xy (V, 2). forward -> (V, num_filters[-1]); pillars without a
    point are 0."""

    def __init__(self, in_channels: int, num_filters: Tuple[int, ...] = (64,),
                 use_norm: bool = True):
        super().__init__()
        self.num_filters = tuple(num_filters)
        self.use_norm = use_norm
        c = in_channels + 5  # + offsets from the pillar's mean (3) and centre (2)
        for i, f in enumerate(self.num_filters):
            self.add_module(f"pfn{i}", nn.Linear(c, f, bias=not use_norm))
            if use_norm:
                self.add_module(f"bn{i}", MaskedBatchNorm(f, eps=1e-3, momentum=0.1))
            c = f

    def forward(self, points, point_voxel_id, pillar_mean, pillar_center, num_pillars: int):
        ok = point_voxel_id >= 0
        pid = torch.where(ok, point_voxel_id, num_pillars).long()
        row = torch.clamp(pid, 0, num_pillars - 1)
        x = torch.cat([points, points[:, :3] - pillar_mean[row],
                       points[:, :2] - pillar_center[row]], dim=-1)
        for i in range(len(self.num_filters)):
            x = getattr(self, f"pfn{i}")(x)
            if self.use_norm:
                x = getattr(self, f"bn{i}")(x, ok)
            x = torch.relu(x)
        x = torch.where(ok[:, None], x, -1e9)
        # segment max: an exact maximum, whatever the order of the writes
        pooled = x.new_full((num_pillars + 1, x.shape[1]), -torch.inf).scatter_reduce(
            0, pid[:, None].expand_as(x), x, "amax", include_self=True)[:num_pillars]
        any_point = torch.zeros(num_pillars + 1, dtype=torch.int32, device=x.device)
        any_point = any_point.scatter_reduce(0, pid, ok.to(torch.int32), "amax")
        return torch.where(any_point[:num_pillars, None] > 0, pooled, 0.0)


def pointpillar_scatter(pillar_features, keys, grid: GridSpec):
    """(V, D) pillar features + their keys -> (ny, nx, D) BEV image; pillar
    grids have one z cell, so a key is its BEV cell. Valid keys are unique:
    each cell is written once; invalid rows go to a spare row that is cut."""
    d = pillar_features.shape[-1]
    n_cells = grid.nx * grid.ny
    valid = keys != INVALID_KEY
    cell = torch.where(valid, keys % n_cells, n_cells).long()
    canvas = pillar_features.new_zeros((n_cells + 1, d))
    canvas = canvas.index_copy(0, cell, torch.where(valid[:, None], pillar_features, 0.0))
    return canvas[:n_cells].reshape(grid.ny, grid.nx, d)
