"""VoxelResBackBone8x, sparse path (port of cpd_tpu/models/backbone3d.py).

Stage rulebooks are built once per stage and shared by every submanifold
conv of that stage; every convolution runs through kernel A1
(``ops/gather_gemm.py``): 21 in branch 0 and, in training with ``mm=True``,
14 more in the light siamese branch 1 that encodes the proto-completed view
(one block at stages 2-4, no ``conv_out``). In training mode the rulebooks
come with their transposes (inverse rulebooks of the strided convs, the
flipped copy of each stage's submanifold rulebook), and every conv's
backward runs kernel A1 for dX and kernel A2 for dW. Activations are kept
for the backward (no rematerialisation: it changes no value). The dense
tail is not ported.
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


def build_branch_rulebooks(keys, grid: GridSpec, caps, with_transpose: bool = False,
                           with_conv_out: bool = True):
    """The rulebooks of one encoder branch. keys: (B, V) sorted int32.

    ``with_transpose`` adds what the backward needs (``*_T`` keys): the
    inverse rulebooks of the strided convs and, once per stage, the flipped
    copy of the submanifold rulebook. ``with_conv_out=False`` (the light
    branch) leaves out ``conv_out`` and its transpose."""
    g = stage_grids(grid)
    downs = (("down2", "x_conv1", "x_conv2", (3, 3, 3), (2, 2, 2), (1, 1, 1)),
             ("down3", "x_conv2", "x_conv3", (3, 3, 3), (2, 2, 2), (1, 1, 1)),
             ("down4", "x_conv3", "x_conv4", (3, 3, 3), (2, 2, 2), (1, 1, 0)),
             ("conv_out", "x_conv4", "encoded", (1, 1, 3), (1, 1, 2), (0, 0, 0)))
    rbs = {}
    for stage, (name, g_in, g_out, kernel, stride, padding) in enumerate(downs):
        subm = f"subm{stage + 1}"
        rbs[subm] = sparse.build_subm_rulebook_batched(keys, g[g_in])
        if with_transpose:
            rbs[subm + "_T"] = sparse.mirror_rulebook(rbs[subm])
        if name == "conv_out" and not with_conv_out:
            break
        rbs[name], _ = sparse.build_conv_rulebook_batched(
            keys, g[g_in], kernel, stride, padding, caps[stage])
        if with_transpose:
            rbs[name + "_T"] = sparse.build_inverse_rulebook_batched(
                keys, rbs[name].out_keys, g[g_in], g[g_out], kernel, stride, padding)
        keys = rbs[name].out_keys
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

    def conv_bn(self, features, rulebook: Rulebook, transpose=None):
        # the conv result is rounded once to the activation dtype from the
        # kernel's f32 accumulator; the BN computes in f32. ``transpose``
        # (the conv's transpose rulebook) makes the conv differentiable.
        out = sparse.sparse_conv_apply_batched(
            features, rulebook, self.weight, compute_dtype=self.compute_dtype,
            transpose=transpose, out_dtype=self.compute_dtype or torch.float32)
        return self.bn(out, rulebook.out_valid)


class SubMConvBN(_SparseConvBN):
    """Submanifold conv + masked BN + optional ReLU, on a prebuilt rulebook."""

    def __init__(self, in_channels, out_channels, kernel_volume=27, relu=True,
                 compute_dtype=torch.bfloat16):
        super().__init__(in_channels, out_channels, kernel_volume, compute_dtype)
        self.relu = relu

    def forward(self, features, rulebook: Rulebook, transpose=None):
        out = self.conv_bn(features, rulebook, transpose)
        return torch.relu(out) if self.relu else out


class StridedConvBN(_SparseConvBN):
    """Strided sparse conv + masked BN + ReLU; rulebook passed in."""

    def forward(self, features, rulebook: Rulebook, transpose=None):
        return torch.relu(self.conv_bn(features, rulebook, transpose))


class SparseBasicBlock(nn.Module):
    """Residual block of two submanifold convs."""

    def __init__(self, channels: int, compute_dtype=torch.bfloat16):
        super().__init__()
        self.conv1 = SubMConvBN(channels, channels, relu=True, compute_dtype=compute_dtype)
        self.conv2 = SubMConvBN(channels, channels, relu=False, compute_dtype=compute_dtype)

    def forward(self, features, rulebook: Rulebook, transpose=None):
        out = self.conv2(self.conv1(features, rulebook, transpose), rulebook, transpose)
        return torch.relu(out + features)


class ResBranch(nn.Module):
    """One encoder branch of VoxelResBackBone8x (sparse path).

    conv_input subm 3^3 -> C0, 2 blocks; down2/3/4 strided 3^3 s2 then 2
    blocks each (C1, C2, C3); conv_out kernel (1, 1, 3), z-stride 2 -> C3.
    ``light`` (the MM branch) keeps one block at stages 2-4 and has no
    conv_out. Rulebooks with ``*_T`` entries make the convs differentiable."""

    def __init__(self, in_channels: int = 5, num_filters=(16, 32, 64, 128),
                 compute_dtype=torch.bfloat16, light: bool = False):
        super().__init__()
        self.light = light
        cd = compute_dtype
        self.conv_input = SubMConvBN(in_channels, num_filters[0], compute_dtype=cd)
        c_in = num_filters[0]
        for stage, c in enumerate(num_filters, start=1):
            if stage > 1:
                self.add_module(f"down{stage}", StridedConvBN(c_in, c, 27, cd))
            self.add_module(f"res{stage}a", SparseBasicBlock(c, cd))
            if stage == 1 or not light:
                self.add_module(f"res{stage}b", SparseBasicBlock(c, cd))
            c_in = c
        if not light:
            self.conv_out = StridedConvBN(c_in, c_in, 3, cd)

    def forward(self, features, rulebooks):
        rb = rulebooks["subm1"]
        rb_t = rulebooks.get("subm1_T")
        x = self.conv_input(features, rb, rb_t)
        out = {}
        for stage in range(1, 5):
            if stage > 1:
                x = getattr(self, f"down{stage}")(x, rulebooks[f"down{stage}"],
                                                  rulebooks.get(f"down{stage}_T"))
                rb = rulebooks[f"subm{stage}"]
                rb_t = rulebooks.get(f"subm{stage}_T")
            x = getattr(self, f"res{stage}a")(x, rb, rb_t)
            if stage == 1 or not self.light:
                x = getattr(self, f"res{stage}b")(x, rb, rb_t)
            out[f"x_conv{stage}"] = (x, rb.out_keys)
        if not self.light:
            x = self.conv_out(x, rulebooks["conv_out"], rulebooks.get("conv_out_T"))
            out["encoded"] = (x, rulebooks["conv_out"].out_keys)
        return out


class VoxelResBackBone8x(nn.Module):
    """The CPD sparse backbone. forward(features (B, V, C), keys (B, V)) ->
    {name: (features, keys, GridSpec)} for x_conv1..4 and encoded. With
    ``mm=True``, in training mode and given the proto-completed view
    (``features_mm``, ``keys_mm``), the light branch 1 adds ``x_conv1_mm`` ..
    ``x_conv4_mm``."""

    def __init__(self, grid: GridSpec, in_channels: int = 5,
                 num_filters: Tuple[int, ...] = (16, 32, 64, 128),
                 caps: Tuple[int, ...] = (80000, 60000, 40000, 40000),
                 compute_dtype: Optional[torch.dtype] = torch.bfloat16, mm: bool = False):
        super().__init__()
        self.grid = grid
        self.caps = tuple(caps)
        self.branch0 = ResBranch(in_channels, tuple(num_filters), compute_dtype)
        if mm:
            self.branch1 = ResBranch(in_channels, tuple(num_filters), compute_dtype, light=True)

    def forward(self, features, keys, features_mm=None, keys_mm=None):
        train = self.training
        raw = self.branch0(features, build_branch_rulebooks(keys, self.grid, self.caps, train))
        if hasattr(self, "branch1") and train and features_mm is not None:
            rbs_mm = build_branch_rulebooks(keys_mm, self.grid, self.caps, train,
                                            with_conv_out=False)
            for k, v in self.branch1(features_mm, rbs_mm).items():
                raw[k + "_mm"] = v
        grids = stage_grids(self.grid)
        return {k: (f, ky, grids[k.replace("_mm", "")]) for k, (f, ky) in raw.items()}
