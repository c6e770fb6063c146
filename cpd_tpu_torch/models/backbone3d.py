"""VoxelResBackBone8x and VoxelBackBone8x (port of cpd_tpu/models/backbone3d.py).

Stage rulebooks are built once per stage and shared by every submanifold
conv of that stage; every sparse convolution runs through kernel A1
(``ops/gather_gemm.py``): 21 in branch 0 and, in training with ``mm=True``,
14 more in the light siamese branch 1 that encodes the proto-completed view
(one block at stages 2-4, no ``conv_out``). In training mode the rulebooks
come with their transposes (inverse rulebooks of the strided convs, the
flipped copy of each stage's submanifold rulebook), and every conv's
backward runs kernel A1 for dX and kernel A2 for dW. Activations are kept
for the backward (no rematerialisation: it changes no value).

With ``dense_tail=True`` stage 4 and ``conv_out`` run as dense ``conv3d``
(cuDNN) on the 8x-downsampled grid instead (``ResBranch._dense_tail``): the
stage-4 rulebooks are never built, 15 sparse convolutions remain in branch 0
(10 in the light branch), and the BEV map comes straight from the dense
``conv_out`` (``encoded_bev``). The conv modules take either a ``Rulebook``
or a ``DenseCtx``, so both settings share one parameter set. Below the stage
caps the two settings agree up to rounding; above them the dense tail keeps
in its BEV map the sites that the sparse path drops.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import rulebook as stage_tables
from ..ops import sparse
from ..ops.sparse import GridSpec, Rulebook
from .norm import MaskedBatchNorm


class DenseCtx(NamedTuple):
    """Dense-grid stand-in for a Rulebook: the conv modules take either.
    ``mask`` is the OUTPUT-site occupancy (B, D, H, W); ``kernel`` is
    (x, y, z) as in the rulebook builders; stride and padding are in conv
    order (z, y, x)."""

    mask: torch.Tensor
    kernel: Tuple[int, int, int]
    stride: Tuple[int, int, int]
    padding: Tuple[int, int, int]


def _dense_conv(features, w_taps, ctx: DenseCtx, compute_dtype):
    """3-D dense conv of (B, D, H, W, Cin) features with the rulebook
    tap-order weights.

    ``w_taps`` is the sparse path's (K, Cin, Cout) kernel whose taps run dz
    outer, dy, dx inner: a (kz, ky, kx, Cin, Cout) reshape, so both paths
    share one parameter. Both are cross-correlations (no flip). The conv
    sees a channels-first VIEW of the channels-last grid (channels_last_3d
    strides: no copy), accumulates in f32 and rounds once to the compute
    dtype."""
    kx, ky, kz = ctx.kernel
    cin, cout = w_taps.shape[-2:]
    cd = compute_dtype or features.dtype
    w = w_taps.to(cd).reshape(kz, ky, kx, cin, cout).permute(4, 3, 0, 1, 2)
    out = F.conv3d(features.to(cd).permute(0, 4, 1, 2, 3), w, None, ctx.stride, ctx.padding)
    return out.permute(0, 2, 3, 4, 1)


def _downsample_mask(mask, kernel_xyz, stride_xyz, pad_xyz):
    """Occupancy of a strided conv's output sites: every output cell whose
    receptive field touches an occupied input (SparseConv3d's active-set
    rule, ``ops/rulebook.py::downsample``). mask: (B, D, H, W) bool."""
    out = F.max_pool3d(mask[:, None].float(), kernel_xyz[::-1], stride_xyz[::-1], pad_xyz[::-1])
    return out[:, 0] > 0


def stage_grids(grid: GridSpec):
    """Static GridSpec per backbone output key (the 8x conv ladder)."""
    g1 = grid.downsample((2, 2, 2), (1, 1, 1), (3, 3, 3))
    g2 = g1.downsample((2, 2, 2), (1, 1, 1), (3, 3, 3))
    g3 = g2.downsample((2, 2, 2), (1, 1, 0), (3, 3, 3))
    g_out = g3.downsample((1, 1, 2), (0, 0, 0), (1, 1, 3))
    return {"x_conv1": grid, "x_conv2": g1, "x_conv3": g2, "x_conv4": g3, "encoded": g_out}


def build_branch_rulebooks(keys, grid: GridSpec, caps, with_transpose: bool = False,
                           with_conv_out: bool = True, dense_tail: bool = False):
    """The rulebooks of one encoder branch. keys: (B, V) sorted int32.

    ``with_transpose`` adds what the backward needs (``*_T`` keys): the
    inverse rulebooks of the strided convs and, once per stage, the flipped
    copy of the submanifold rulebook. ``with_conv_out=False`` (the light
    branch) leaves out ``conv_out`` and its transpose. ``dense_tail`` stops
    after stage 3: stage 4 and ``conv_out`` run as dense convs and need no
    rulebook.

    CUDA keys take one occupancy table a stage (``ops/rulebook.py``) and
    every book from it: the stage-0 table once from ``keys`` (kernel B1a),
    each later stage's from the strided conv's output set (B2, truncated to
    the cap), one lookup launch a book (B1b), all samples at once and no host
    sync. CPU keys take the plain twins of ``ops/sparse.py``."""
    return _branch_rulebooks(keys, grid, caps, with_transpose, with_conv_out, dense_tail,
                             tables=keys.is_cuda)


def _branch_rulebooks(keys, grid: GridSpec, caps, with_transpose=False, with_conv_out=True,
                      dense_tail=False, *, tables: bool):
    """``build_branch_rulebooks`` on stage tables (``tables``; for CPU keys
    their wrappers compute the kernels' plain versions) or on the plain
    twins."""
    g = stage_grids(grid)
    downs = (("down2", "x_conv1", "x_conv2", (3, 3, 3), (2, 2, 2), (1, 1, 1)),
             ("down3", "x_conv2", "x_conv3", (3, 3, 3), (2, 2, 2), (1, 1, 1)),
             ("down4", "x_conv3", "x_conv4", (3, 3, 3), (2, 2, 2), (1, 1, 0)),
             ("conv_out", "x_conv4", "encoded", (1, 1, 3), (1, 1, 2), (0, 0, 0)))
    keys = keys.contiguous()
    table = stage_tables.stage_table(keys, g["x_conv1"]) if tables else None
    rbs = {}
    for stage, (name, g_in, g_out, kernel, stride, padding) in enumerate(downs):
        subm = f"subm{stage + 1}"
        rbs[subm] = (stage_tables.subm_rulebook(keys, table) if tables
                     else sparse.subm_rulebook_reference(keys, g[g_in]))
        if with_transpose:
            rbs[subm + "_T"] = sparse.mirror_rulebook(rbs[subm])
        if (name == "conv_out" and not with_conv_out) or (name == "down4" and dense_tail):
            break
        if tables:
            rbs[name], table = stage_tables.conv_rulebook(table, kernel, stride, padding,
                                                          caps[stage])
        else:
            rbs[name], _ = sparse.conv_rulebook_reference(keys, g[g_in], kernel, stride, padding,
                                                          caps[stage])
        if with_transpose:
            rbs[name + "_T"] = (
                stage_tables.inverse_rulebook(keys, g[g_in], table, kernel, stride, padding)
                if tables else sparse.inverse_rulebook_reference(
                    keys, rbs[name].out_keys, g[g_in], g[g_out], kernel, stride, padding))
        keys = rbs[name].out_keys
    return rbs


class _SparseConvBN(nn.Module):
    """Sparse conv (weight (K, Cin, Cout), no bias) + masked BN. Given a
    ``DenseCtx`` for the rulebook, the same weight runs as a dense conv3d."""

    def __init__(self, in_channels: int, out_channels: int, kernel_volume: int,
                 compute_dtype):
        super().__init__()
        self.compute_dtype = compute_dtype
        # zero-initialised: weights come from a state dict (utils/weights.py)
        self.weight = nn.Parameter(torch.zeros(kernel_volume, in_channels, out_channels))
        self.bn = MaskedBatchNorm(out_channels)

    def conv_bn(self, features, rulebook, transpose=None):
        if isinstance(rulebook, DenseCtx):
            # unoccupied cells are zero on input and the masked BN zeroes them
            # again on output, so the dense sum equals the gather conv at
            # every occupied site
            out = _dense_conv(features, self.weight, rulebook, self.compute_dtype)
            return self.bn(out, rulebook.mask)
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

    def forward(self, features, rulebook, transpose=None):
        out = self.conv_bn(features, rulebook, transpose)
        return torch.relu(out) if self.relu else out


class StridedConvBN(_SparseConvBN):
    """Strided sparse conv + masked BN + ReLU; rulebook passed in."""

    def forward(self, features, rulebook, transpose=None):
        return torch.relu(self.conv_bn(features, rulebook, transpose))


class SparseBasicBlock(nn.Module):
    """Residual block of two submanifold convs."""

    def __init__(self, channels: int, compute_dtype=torch.bfloat16):
        super().__init__()
        self.conv1 = SubMConvBN(channels, channels, relu=True, compute_dtype=compute_dtype)
        self.conv2 = SubMConvBN(channels, channels, relu=False, compute_dtype=compute_dtype)

    def forward(self, features, rulebook, transpose=None):
        out = self.conv2(self.conv1(features, rulebook, transpose), rulebook, transpose)
        return torch.relu(out + features)


class ResBranch(nn.Module):
    """One encoder branch of VoxelResBackBone8x.

    conv_input subm 3^3 -> C0, 2 blocks; down2/3/4 strided 3^3 s2 then 2
    blocks each (C1, C2, C3); conv_out kernel (1, 1, 3), z-stride 2 -> C3.
    ``light`` (the MM branch) keeps one block at stages 2-4 and has no
    conv_out. Rulebooks with ``*_T`` entries make the convs differentiable.
    ``dense_tail=(grid, caps)`` runs stage 4 and conv_out as dense conv3d on
    the branch's input ``grid`` (``_dense_tail``); the parameters are the
    same either way."""

    def __init__(self, in_channels: int = 5, num_filters=(16, 32, 64, 128),
                 compute_dtype=torch.bfloat16, light: bool = False, dense_tail=None):
        super().__init__()
        self.light = light
        self.dense_tail = dense_tail
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
            if stage == 4 and self.dense_tail is not None:
                return self._dense_tail(x, rb.out_keys, out)
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

    def _dense_tail(self, x, keys3, out):
        """Stage 4 + conv_out on the dense (nz3, ny3, nx3) grid of stage 3.

        ``x_conv4`` and ``encoded`` rows are gathered back out of the dense
        grids for the RoI head, under the keys that rank compaction of the
        occupancy masks gives: the sorted key sets the capped rulebooks give.
        ``conv_out``'s dense output is also the BEV map (``encoded_bev``, in
        ``height_compression``'s z-major channel layout), with no sparse
        round trip.

        Above the caps the dense convs, norms and BEV map cover ALL occupied
        sites, while the sparse path drops the key-order tail everywhere:
        the two agree below the caps, which the shipped caps are sized for."""
        grid, caps = self.dense_tail
        g = stage_grids(grid)
        b, c3 = x.shape[0], self.res4a.conv1.weight.shape[-1]
        dense3 = torch.stack([sparse.to_dense(f, k, g["x_conv3"]) for f, k in zip(x, keys3)])
        mask3 = sparse.dense_mask_from_keys(keys3, g["x_conv3"])

        mask4 = _downsample_mask(mask3, (3, 3, 3), (2, 2, 2), (1, 1, 0))
        x4 = self.down4(dense3, DenseCtx(mask4, (3, 3, 3), (2, 2, 2), (0, 1, 1)))
        ctx4 = DenseCtx(mask4, (3, 3, 3), (1, 1, 1), (1, 1, 1))
        x4 = self.res4a(x4, ctx4)
        if not self.light:
            x4 = self.res4b(x4, ctx4)
        keys4, _ = sparse.keys_from_dense_mask(mask4.reshape(b, -1), caps[2])
        out["x_conv4"] = (sparse.rows_from_dense(x4.reshape(b, -1, c3), keys4), keys4)

        if not self.light:
            mask_out = _downsample_mask(mask4, (1, 1, 3), (1, 1, 2), (0, 0, 0))
            xo = self.conv_out(x4, DenseCtx(mask_out, (1, 1, 3), (2, 1, 1), (0, 0, 0)))
            keys_o, _ = sparse.keys_from_dense_mask(mask_out.reshape(b, -1), caps[3])
            out["encoded"] = (sparse.rows_from_dense(xo.reshape(b, -1, c3), keys_o), keys_o)
            # (B, nz, ny, nx, C) -> (B, ny, nx, nz*C)
            g_out = g["encoded"]
            out["encoded_bev"] = xo.permute(0, 2, 3, 1, 4).reshape(
                b, g_out.ny, g_out.nx, g_out.nz * c3)
        return out


class VoxelResBackBone8x(nn.Module):
    """The CPD sparse backbone. forward(features (B, V, C), keys (B, V)) ->
    {name: (features, keys, GridSpec)} for x_conv1..4 and encoded. With
    ``mm=True``, in training mode and given the proto-completed view
    (``features_mm``, ``keys_mm``), the light branch 1 adds ``x_conv1_mm`` ..
    ``x_conv4_mm``. With ``dense_tail=True`` stage 4 and conv_out run as
    dense conv3d and the output also holds the bare BEV map ``encoded_bev``
    (B, ny, nx, nz*C)."""

    def __init__(self, grid: GridSpec, in_channels: int = 5,
                 num_filters: Tuple[int, ...] = (16, 32, 64, 128),
                 caps: Tuple[int, ...] = (80000, 60000, 40000, 40000),
                 compute_dtype: Optional[torch.dtype] = torch.bfloat16, mm: bool = False,
                 dense_tail: bool = False):
        super().__init__()
        self.grid = grid
        self.caps = tuple(caps)
        self.dense_tail = dense_tail
        tail = (grid, self.caps) if dense_tail else None
        self.branch0 = ResBranch(in_channels, tuple(num_filters), compute_dtype, dense_tail=tail)
        if mm:
            self.branch1 = ResBranch(in_channels, tuple(num_filters), compute_dtype, light=True,
                                     dense_tail=tail)

    def forward(self, features, keys, features_mm=None, keys_mm=None):
        train = self.training
        raw = self.branch0(features, build_branch_rulebooks(
            keys, self.grid, self.caps, train, dense_tail=self.dense_tail))
        if hasattr(self, "branch1") and train and features_mm is not None:
            rbs_mm = build_branch_rulebooks(keys_mm, self.grid, self.caps, train,
                                            with_conv_out=False, dense_tail=self.dense_tail)
            for k, v in self.branch1(features_mm, rbs_mm).items():
                raw[k + "_mm"] = v
        grids = stage_grids(self.grid)
        return {k: v if k == "encoded_bev" else (*v, grids[k.replace("_mm", "")])
                for k, v in raw.items()}


PLAIN_OUT_CHANNELS = 128  # VoxelBackBone8x's conv_out width


class PlainBranch(nn.Module):
    """One encoder branch of VoxelBackBone8x: the stage and stride layout of
    ResBranch (``build_branch_rulebooks`` serves both) with plain stacks of
    two submanifold convs in place of the residual blocks. conv_input +
    conv1 (C0); down2/3/4 then conv{s}a, conv{s}b (C1, C2, C3); conv_out
    kernel (1, 1, 3), z-stride 2, fixed at 128 channels whatever C3 is:
    12 sparse convs."""

    def __init__(self, in_channels: int = 5, num_filters=(16, 32, 64, 64),
                 compute_dtype=torch.bfloat16):
        super().__init__()
        cd = compute_dtype
        c0 = num_filters[0]
        self.conv_input = SubMConvBN(in_channels, c0, compute_dtype=cd)
        self.conv1 = SubMConvBN(c0, c0, compute_dtype=cd)
        c_in = c0
        for stage, c in enumerate(num_filters[1:], start=2):
            self.add_module(f"down{stage}", StridedConvBN(c_in, c, 27, cd))
            self.add_module(f"conv{stage}a", SubMConvBN(c, c, compute_dtype=cd))
            self.add_module(f"conv{stage}b", SubMConvBN(c, c, compute_dtype=cd))
            c_in = c
        self.conv_out = StridedConvBN(c_in, PLAIN_OUT_CHANNELS, 3, cd)

    def forward(self, features, rulebooks):
        rb = rulebooks["subm1"]
        rb_t = rulebooks.get("subm1_T")
        x = self.conv1(self.conv_input(features, rb, rb_t), rb, rb_t)
        out = {"x_conv1": (x, rb.out_keys)}
        for stage in range(2, 5):
            x = getattr(self, f"down{stage}")(x, rulebooks[f"down{stage}"],
                                              rulebooks.get(f"down{stage}_T"))
            rb = rulebooks[f"subm{stage}"]
            rb_t = rulebooks.get(f"subm{stage}_T")
            x = getattr(self, f"conv{stage}a")(x, rb, rb_t)
            x = getattr(self, f"conv{stage}b")(x, rb, rb_t)
            out[f"x_conv{stage}"] = (x, rb.out_keys)
        x = self.conv_out(x, rulebooks["conv_out"], rulebooks.get("conv_out_T"))
        out["encoded"] = (x, rulebooks["conv_out"].out_keys)
        return out



class VoxelBackBone8x(nn.Module):
    """The plain (non-residual) 8x encoder of the registry (port of
    cpd_tpu/models/backbone3d.py::VoxelBackBone8x). forward(features
    (B, V, C), keys (B, V)) -> {name: (features, keys, GridSpec)} for
    x_conv1..4 and encoded (128 channels). With ``mm=True``, in training
    mode and given the proto-completed view, a second full branch adds
    ``x_conv1_mm`` .. ``encoded_mm``. No dense tail: the JAX module takes
    none."""

    def __init__(self, grid: GridSpec, in_channels: int = 5,
                 num_filters: Tuple[int, ...] = (16, 32, 64, 64),
                 caps: Tuple[int, ...] = (80000, 60000, 40000, 40000),
                 compute_dtype: Optional[torch.dtype] = torch.bfloat16, mm: bool = False):
        super().__init__()
        self.grid = grid
        self.caps = tuple(caps)
        self.branch0 = PlainBranch(in_channels, tuple(num_filters), compute_dtype)
        if mm:
            self.branch1 = PlainBranch(in_channels, tuple(num_filters), compute_dtype)

    def forward(self, features, keys, features_mm=None, keys_mm=None):
        train = self.training
        raw = self.branch0(features, build_branch_rulebooks(keys, self.grid, self.caps, train))
        if hasattr(self, "branch1") and train and features_mm is not None:
            rbs_mm = build_branch_rulebooks(keys_mm, self.grid, self.caps, train)
            for k, v in self.branch1(features_mm, rbs_mm).items():
                raw[k + "_mm"] = v
        grids = stage_grids(self.grid)
        return {k: (*v, grids[k.replace("_mm", "")]) for k, v in raw.items()}
