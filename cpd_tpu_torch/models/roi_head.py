"""VoxelRCNN RoI head, inference half (port of cpd_tpu/models/roi_head.py):
RoI grid points + voxel queries, multi-scale grid pooling, FC towers and the
box decode. Proposal sampling, losses and the MM/proto branch are not ported
yet."""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import pool
from ..ops.box_coders import ResidualCoder
from ..ops.geometry import rotate_points_along_z
from .norm import MaskedBatchNorm

SCALE_SPECS = (
    ("x_conv3", 4, ((2, 2, 2), 0.4), ((4, 4, 4), 0.8)),
    ("x_conv4", 8, ((2, 2, 2), 0.8), ((4, 4, 4), 1.6)),
)


def decode_roi_boxes(rois, rcnn_reg, coder: ResidualCoder):
    """Residuals in the RoI's canonical frame -> world boxes."""
    zeros3 = torch.zeros_like(rois[..., 0:3])
    local_anchor = torch.cat([zeros3, rois[..., 3:6], torch.zeros_like(rois[..., 6:7])], -1)
    local = coder.decode(rcnn_reg, local_anchor)
    xyz = rotate_points_along_z(local[..., None, 0:3], rois[..., 6])[..., 0, :]
    return torch.cat([xyz + rois[..., 0:3], local[..., 3:6], local[..., 6:7] + rois[..., 6:7]],
                     dim=-1)


def compute_pool_queries(rois, scale_features, scale_grids, scale_specs, voxel_size,
                         point_cloud_range, grid_size, nsample):
    """RoI grid points + the voxel queries of every (scale, radius group).
    Returns {f"{name}_{gi}": (idx, valid, rel)} with rel the (B, Q, nsample, 3)
    query-to-voxel-center offsets, Q = R * grid_size^3."""
    b, r = rois.shape[:2]
    queries = torch.stack([pool.roi_grid_points(rb, grid_size) for rb in rois])
    queries = queries.reshape(b, r * grid_size ** 3, 3)
    out = {}
    for name, ds, *groups in scale_specs:
        _, keys = scale_features[name]
        radii = tuple(float(rr) for _, rr in groups)
        qrange = tuple(max(g[0][d] for g in groups) for d in range(3))
        per_sample = [pool.voxel_query_multi(q, k, scale_grids[name], tuple(voxel_size),
                                             point_cloud_range, ds, qrange, radii, nsample)
                      for q, k in zip(queries, keys)]
        for gi in range(len(groups)):
            idx, valid, centers = (torch.stack(t) for t in zip(*(s[gi] for s in per_sample)))
            out[f"{name}_{gi}"] = (idx, valid, centers - queries[:, :, None, :])
    return out


class _Dense(nn.Module):
    """x @ W^T + b in ``compute_dtype`` (flax Dense semantics: the bias is
    added after the matmul, in the same dtype)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 compute_dtype=None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.weight = nn.Parameter(torch.zeros(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None

    def forward(self, x):
        cd = self.compute_dtype or x.dtype
        y = F.linear(x.to(cd), self.weight.to(cd))
        return y if self.bias is None else y + self.bias.to(cd)


class GridPoolBranch(nn.Module):
    """Pool multi-scale sparse features at the RoI grid points: a pre-MLP per
    scale, then per radius group a 2-layer MLP on (rel_pos, feature) and a
    masked max over the nsample neighbours. Its Dense layers are bf16, as
    the JAX module hard-codes them."""

    def __init__(self, scale_channels, grid_size: int = 6, nsample: int = 16,
                 mlp_channels: int = 32, scale_specs=SCALE_SPECS):
        super().__init__()
        self.grid_size = grid_size
        self.nsample = nsample
        self.scale_specs = scale_specs
        bf16 = torch.bfloat16
        for name, _, *groups in scale_specs:
            self.add_module(f"pre_{name}", _Dense(scale_channels[name], mlp_channels,
                                                  compute_dtype=bf16))
            for gi in range(len(groups)):
                self.add_module(f"mlp_{name}_{gi}", nn.Sequential(
                    _Dense(mlp_channels + 3, mlp_channels, compute_dtype=bf16), nn.ReLU(),
                    _Dense(mlp_channels, mlp_channels, compute_dtype=bf16), nn.ReLU()))

    def forward(self, rois, scale_features, query_results):
        """-> (B, R, grid^3 * C_total) pooled features."""
        b, r = rois.shape[:2]
        per_scale = []
        for name, _, *groups in self.scale_specs:
            feats, _ = scale_features[name]
            pre = torch.relu(getattr(self, f"pre_{name}")(feats))
            for gi in range(len(groups)):
                idx, valid, rel = query_results[f"{name}_{gi}"]
                mlp = getattr(self, f"mlp_{name}_{gi}")
                per_scale.append(torch.stack([
                    pool.group_and_pool(p, i, v, rp, mlp)
                    for p, i, v, rp in zip(pre, idx, valid, rel)]))
        cat = torch.cat(per_scale, dim=-1)
        return cat.reshape(b, r, self.grid_size ** 3 * cat.shape[-1])


class FCTower(nn.Module):
    """Per hidden layer: Linear(no bias) in compute_dtype + masked BN (eps
    1e-5) + ReLU (dropout is the identity at inference); then an optional
    f32 output Linear with bias (``out_dim=None``: the shared tower)."""

    def __init__(self, in_features: int, hidden=(256, 256), out_dim=1,
                 compute_dtype=torch.bfloat16):
        super().__init__()
        self.hidden = tuple(hidden)
        self.out_dim = out_dim
        c = in_features
        for i, h in enumerate(self.hidden):
            self.add_module(f"fc{i}", _Dense(c, h, bias=False, compute_dtype=compute_dtype))
            self.add_module(f"bn{i}", MaskedBatchNorm(h, eps=1e-5))
            c = h
        if out_dim is not None:
            self.out = _Dense(c, out_dim)

    def forward(self, x, valid):
        for i in range(len(self.hidden)):
            x = torch.relu(getattr(self, f"bn{i}")(getattr(self, f"fc{i}")(x), valid))
        return x if self.out_dim is None else self.out(x.float())


class VoxelRCNNProtoHead(nn.Module):
    """RoI head, branch 0 at inference: pool, shared tower, cls/reg towers,
    decoded boxes."""

    def __init__(self, scale_grids, scale_channels, grid_size: int = 6,
                 voxel_size=(0.1, 0.1, 0.15),
                 point_cloud_range=(-75.2, -75.2, -2.0, 75.2, 75.2, 4.0),
                 shared_fc: Tuple[int, ...] = (256, 256), mlp_channels: int = 32):
        super().__init__()
        self.scale_grids = scale_grids
        self.grid_size = grid_size
        self.voxel_size = tuple(voxel_size)
        self.point_cloud_range = tuple(point_cloud_range)
        self.coder = ResidualCoder()
        self.pool_branch = GridPoolBranch(scale_channels, grid_size, mlp_channels=mlp_channels)
        pooled = grid_size ** 3 * mlp_channels * sum(len(g) for _, _, *g in SCALE_SPECS)
        self.shared0 = FCTower(pooled, hidden=tuple(shared_fc), out_dim=None)
        self.cls_tower0 = FCTower(shared_fc[-1], out_dim=1)
        self.reg_tower0 = FCTower(shared_fc[-1], out_dim=7)

    def forward(self, proposals, backbone_out):
        rois = proposals["rois"]
        roi_valid = proposals["roi_valid"]
        scale_features = {k: (v[0], v[1]) for k, v in backbone_out.items()
                          if k in ("x_conv3", "x_conv4")}
        q0 = compute_pool_queries(rois, scale_features, self.scale_grids,
                                  self.pool_branch.scale_specs, self.voxel_size,
                                  self.point_cloud_range, self.grid_size,
                                  self.pool_branch.nsample)
        pooled0 = self.pool_branch(rois, scale_features, q0)
        shared0 = self.shared0(pooled0, roi_valid)
        rcnn_cls = self.cls_tower0(shared0, roi_valid)[..., 0]
        rcnn_reg = self.reg_tower0(shared0, roi_valid)
        return {
            "rcnn_cls": rcnn_cls,
            "rcnn_reg": rcnn_reg,
            "shared_features0": shared0,
            "rois": rois,
            "roi_labels": proposals["roi_labels"],
            "roi_valid": roi_valid,
            "batch_box_preds": decode_roi_boxes(rois, rcnn_reg, self.coder),
            "batch_cls_preds": rcnn_cls[..., None],
        }
