"""VoxelResBackBone8x, sparse path, branch 0 (port of cpd_tpu/models/backbone3d.py).

Stage rulebooks are built once per stage and shared by every submanifold
conv of that stage; all 21 convolutions of a forward run through kernel A1
(``ops/gather_gemm.py``). The MM siamese branch and the dense tail are not
ported yet.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..ops import sparse
from ..ops.sparse import GridSpec, Rulebook
from .norm import MaskedBatchNorm


def stage_grids(grid: GridSpec):
    """Static GridSpec per backbone output key (the 8x conv ladder)."""
    g1 = grid.downsample((2, 2, 2), (1, 1, 1), (3, 3, 3))
    g2 = g1.downsample((2, 2, 2), (1, 1, 1), (3, 3, 3))
    g3 = g2.downsample((2, 2, 2), (1, 1, 0), (3, 3, 3))
    g_out = g3.downsample((1, 1, 2), (0, 0, 0), (1, 1, 3))
    return {"x_conv1": grid, "x_conv2": g1, "x_conv3": g2, "x_conv4": g3, "encoded": g_out}


def build_branch_rulebooks(keys, grid: GridSpec, caps):
    """The 8 rulebooks of one encoder branch. keys: (B, V) sorted int32."""
    g = stage_grids(grid)
    rbs = {"subm1": sparse.build_subm_rulebook_batched(keys, g["x_conv1"])}
    rbs["down2"], _ = sparse.build_conv_rulebook_batched(
        keys, g["x_conv1"], (3, 3, 3), (2, 2, 2), (1, 1, 1), caps[0])
    k1 = rbs["down2"].out_keys
    rbs["subm2"] = sparse.build_subm_rulebook_batched(k1, g["x_conv2"])
    rbs["down3"], _ = sparse.build_conv_rulebook_batched(
        k1, g["x_conv2"], (3, 3, 3), (2, 2, 2), (1, 1, 1), caps[1])
    k2 = rbs["down3"].out_keys
    rbs["subm3"] = sparse.build_subm_rulebook_batched(k2, g["x_conv3"])
    rbs["down4"], _ = sparse.build_conv_rulebook_batched(
        k2, g["x_conv3"], (3, 3, 3), (2, 2, 2), (1, 1, 0), caps[2])
    k3 = rbs["down4"].out_keys
    rbs["subm4"] = sparse.build_subm_rulebook_batched(k3, g["x_conv4"])
    rbs["conv_out"], _ = sparse.build_conv_rulebook_batched(
        k3, g["x_conv4"], (1, 1, 3), (1, 1, 2), (0, 0, 0), caps[3])
    return rbs


class _SparseConvBN(nn.Module):
    """Sparse conv (weight (K, Cin, Cout), no bias) + masked BN."""

    def __init__(self, in_channels: int, out_channels: int, kernel_volume: int,
                 compute_dtype):
        super().__init__()
        self.compute_dtype = compute_dtype
        # zero-initialised: weights come from a state dict (utils/weights.py)
        self.weight = nn.Parameter(torch.zeros(kernel_volume, in_channels, out_channels))
        self.bn = MaskedBatchNorm(out_channels)

    def conv_bn(self, features, rulebook: Rulebook):
        # the conv result is rounded once to the activation dtype from the
        # kernel's f32 accumulator; the BN computes in f32
        out = sparse.sparse_conv_apply_batched(
            features, rulebook, self.weight, compute_dtype=self.compute_dtype,
            out_dtype=self.compute_dtype or torch.float32)
        return self.bn(out, rulebook.out_valid)


class SubMConvBN(_SparseConvBN):
    """Submanifold conv + masked BN + optional ReLU, on a prebuilt rulebook."""

    def __init__(self, in_channels, out_channels, kernel_volume=27, relu=True,
                 compute_dtype=torch.bfloat16):
        super().__init__(in_channels, out_channels, kernel_volume, compute_dtype)
        self.relu = relu

    def forward(self, features, rulebook: Rulebook):
        out = self.conv_bn(features, rulebook)
        return torch.relu(out) if self.relu else out


class StridedConvBN(_SparseConvBN):
    """Strided sparse conv + masked BN + ReLU; rulebook passed in."""

    def forward(self, features, rulebook: Rulebook):
        return torch.relu(self.conv_bn(features, rulebook))


class SparseBasicBlock(nn.Module):
    """Residual block of two submanifold convs."""

    def __init__(self, channels: int, compute_dtype=torch.bfloat16):
        super().__init__()
        self.conv1 = SubMConvBN(channels, channels, relu=True, compute_dtype=compute_dtype)
        self.conv2 = SubMConvBN(channels, channels, relu=False, compute_dtype=compute_dtype)

    def forward(self, features, rulebook: Rulebook):
        out = self.conv2(self.conv1(features, rulebook), rulebook)
        return torch.relu(out + features)


class ResBranch(nn.Module):
    """One encoder branch of VoxelResBackBone8x (sparse path).

    conv_input subm 3^3 -> C0, 2 blocks; down2/3/4 strided 3^3 s2 then 2
    blocks each (C1, C2, C3); conv_out kernel (1, 1, 3), z-stride 2 -> C3."""

    def __init__(self, in_channels: int = 5, num_filters=(16, 32, 64, 128),
                 compute_dtype=torch.bfloat16):
        super().__init__()
        c0, c1, c2, c3 = num_filters
        cd = compute_dtype
        self.conv_input = SubMConvBN(in_channels, c0, compute_dtype=cd)
        self.res1a = SparseBasicBlock(c0, cd)
        self.res1b = SparseBasicBlock(c0, cd)
        self.down2 = StridedConvBN(c0, c1, 27, cd)
        self.res2a = SparseBasicBlock(c1, cd)
        self.res2b = SparseBasicBlock(c1, cd)
        self.down3 = StridedConvBN(c1, c2, 27, cd)
        self.res3a = SparseBasicBlock(c2, cd)
        self.res3b = SparseBasicBlock(c2, cd)
        self.down4 = StridedConvBN(c2, c3, 27, cd)
        self.res4a = SparseBasicBlock(c3, cd)
        self.res4b = SparseBasicBlock(c3, cd)
        self.conv_out = StridedConvBN(c3, c3, 3, cd)

    def forward(self, features, rulebooks):
        rb0 = rulebooks["subm1"]
        x = self.conv_input(features, rb0)
        x = self.res1b(self.res1a(x, rb0), rb0)
        out = {"x_conv1": (x, rb0.out_keys)}
        x = self.down2(x, rulebooks["down2"])
        rb1 = rulebooks["subm2"]
        x = self.res2b(self.res2a(x, rb1), rb1)
        out["x_conv2"] = (x, rb1.out_keys)
        x = self.down3(x, rulebooks["down3"])
        rb2 = rulebooks["subm3"]
        x = self.res3b(self.res3a(x, rb2), rb2)
        out["x_conv3"] = (x, rb2.out_keys)
        x = self.down4(x, rulebooks["down4"])
        rb3 = rulebooks["subm4"]
        x = self.res4b(self.res4a(x, rb3), rb3)
        out["x_conv4"] = (x, rb3.out_keys)
        x = self.conv_out(x, rulebooks["conv_out"])
        out["encoded"] = (x, rulebooks["conv_out"].out_keys)
        return out


class VoxelResBackBone8x(nn.Module):
    """The CPD sparse backbone, branch 0. forward(features (B, V, C), keys
    (B, V)) -> {name: (features, keys, GridSpec)} for x_conv1..4 and encoded."""

    def __init__(self, grid: GridSpec, in_channels: int = 5,
                 num_filters: Tuple[int, ...] = (16, 32, 64, 128),
                 caps: Tuple[int, ...] = (80000, 60000, 40000, 40000),
                 compute_dtype: Optional[torch.dtype] = torch.bfloat16):
        super().__init__()
        self.grid = grid
        self.caps = tuple(caps)
        self.branch0 = ResBranch(in_channels, tuple(num_filters), compute_dtype)

    def forward(self, features, keys):
        rbs = build_branch_rulebooks(keys, self.grid, self.caps)
        raw = self.branch0(features, rbs)
        grids = stage_grids(self.grid)
        return {k: (f, ky, grids[k]) for k, (f, ky) in raw.items()}
