"""VoxelSetAbstraction: PV-RCNN-style keypoint features (port of
cpd_tpu/models/pfe.py).

Farthest point sampling picks ``num_keypoints`` keypoints from the raw cloud
(kernel F1 on the card, ``ops/fps.py``); at each scale of ``scale_specs``
the voxel features go through a linear layer + ReLU, each keypoint's
``nsample`` nearest voxels within the scale's radius (``ops.pool.
voxel_query``) are grouped with their offsets, through a two-layer MLP and
max-pooled (``ops.pool.group_and_pool``, the ``F.embedding`` gather); the
BEV map read bilinearly at the keypoints is appended. Everything computes in
f32 (flax promotes the bf16 voxel features to its f32 kernels).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..ops import fps, pool
from .part_wraper import bilinear_sample_bev

# (backbone output, downsample, query range (z, y, x), radius m)
SCALE_SPECS = (("x_conv3", 4, (2, 2, 2), 1.2), ("x_conv4", 8, (2, 2, 2), 2.4))


class VoxelSetAbstraction(nn.Module):
    """forward(points (B, P, C), points_valid (B, P), backbone_out, bev
    (B, H, W, Cb) or None) -> (keypoints (B, K, 3), features (B, K, D) with
    zero rows where the keypoint is padding, keypoint valid (B, K)).
    ``in_channels`` maps each scale's name to its voxel feature width;
    ``bev_channels`` is the BEV map's width (None: no BEV features)."""

    def __init__(self, in_channels: Dict[str, int], bev_channels: Optional[int] = None,
                 num_keypoints: int = 2048,
                 voxel_size: Tuple[float, float, float] = (0.1, 0.1, 0.15),
                 point_cloud_range: Tuple[float, ...] = (-75.2, -75.2, -2.0, 75.2, 75.2, 4.0),
                 feature_map_stride: int = 8, mlp_channels: int = 32, nsample: int = 16,
                 scale_specs=SCALE_SPECS, use_bev: bool = True):
        super().__init__()
        self.num_keypoints = num_keypoints
        self.voxel_size = tuple(voxel_size)
        self.point_cloud_range = tuple(point_cloud_range)
        self.stride_m = voxel_size[0] * feature_map_stride
        self.nsample = nsample
        self.scale_specs = tuple(scale_specs)
        self.use_bev = use_bev
        self.out_channels = mlp_channels * len(self.scale_specs)
        if use_bev and bev_channels:
            self.out_channels += bev_channels
        for name, *_ in self.scale_specs:
            self.add_module(f"pre_{name}", nn.Linear(in_channels[name], mlp_channels))
            self.add_module(f"mlp_{name}", nn.Sequential(
                nn.Linear(mlp_channels + 3, mlp_channels), nn.ReLU(),
                nn.Linear(mlp_channels, mlp_channels), nn.ReLU()))

    def forward(self, points, points_valid, backbone_out, bev_features=None):
        sel = fps.farthest_point_sample(points, points_valid, self.num_keypoints).long()
        keypoints = torch.gather(points[..., :3].float(), 1, sel[..., None].expand(-1, -1, 3))
        kp_valid = torch.gather(points_valid, 1, sel)
        feats = []
        for name, ds, qrange, radius in self.scale_specs:
            v_feats, v_keys, v_grid = backbone_out[name]
            pre = torch.relu(getattr(self, f"pre_{name}")(v_feats.float()))
            mlp = getattr(self, f"mlp_{name}")
            pooled = []
            for f, kp, keys in zip(pre, keypoints, v_keys):
                idx, valid, centers = pool.voxel_query(
                    kp, keys, v_grid, self.voxel_size, self.point_cloud_range, ds,
                    tuple(qrange), radius, self.nsample)
                pooled.append(pool.group_and_pool(f, idx, valid, centers - kp[:, None, :], mlp))
            feats.append(torch.stack(pooled))
        if self.use_bev and bev_features is not None:
            feats.append(bilinear_sample_bev(bev_features, keypoints[..., :2],
                                             self.point_cloud_range, self.stride_m))
        out = torch.where(kp_valid[..., None], torch.cat(feats, dim=-1), 0.0)
        return keypoints, out, kp_valid
