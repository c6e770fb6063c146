"""BEV stack: sparse->dense height compression + 2D conv pyramid, the BEVPool
projection and the X_TRAIN stage clones' de-augmentation (port of
cpd_tpu/models/bev.py).

Public maps are NHWC, as in the JAX package; the convolutions run on an
NCHW view of them (a channels-last view, so the permutes move no data on the
GPU). Parameters are f32 and the convs run in ``compute_dtype`` (bf16 by
default), casting at the JAX package's points.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import sparse
from ..ops.sparse import GridSpec
from .norm import BatchNorm2d


def height_compression(features, keys, grid: GridSpec):
    """(B, V, C) sparse encoded tensor -> (B, ny, nx, nz*C) dense BEV map.
    Channels are z-major (z * C + c), the JAX package's order."""
    b, _, c = features.shape
    dense = torch.stack([sparse.to_dense(f, k, grid) for f, k in zip(features, keys)])
    return dense.permute(0, 2, 3, 1, 4).reshape(b, grid.ny, grid.nx, grid.nz * c)


def conv2d(x, weight, bias=None, stride=1, padding=0, compute_dtype=None):
    """NCHW conv in ``compute_dtype``; the bias is added after the conv in
    that dtype, as flax's Conv adds it."""
    cd = compute_dtype or x.dtype
    y = F.conv2d(x.to(cd), weight.to(cd), None, stride, padding)
    return y if bias is None else y + bias.to(cd)[:, None, None]


class ConvBNReLU(nn.Module):
    """3x3 conv (no bias) + BatchNorm2d(eps 1e-3, momentum 0.01) + ReLU on NCHW maps."""

    def __init__(self, in_channels: int, features: int, kernel: int = 3, stride: int = 1,
                 compute_dtype=torch.bfloat16):
        super().__init__()
        self.stride = stride
        self.padding = kernel // 2
        self.compute_dtype = compute_dtype
        self.conv = nn.Module()
        self.conv.weight = nn.Parameter(torch.zeros(features, in_channels, kernel, kernel))
        self.bn = BatchNorm2d(features, eps=1e-3, momentum=0.01)

    def forward(self, x):
        x = conv2d(x, self.conv.weight, None, self.stride, self.padding, self.compute_dtype)
        return torch.relu(self.bn(x))


class BaseBEVBackbone(nn.Module):
    """Conv pyramid + deconv upsample concat. forward: (B, H, W, C) NHWC ->
    (B, H', W', sum(num_upsample_filters)) NHWC."""

    def __init__(self, in_channels: int, layer_nums=(5, 5), layer_strides=(1, 2),
                 num_filters=(128, 256), upsample_strides=(1, 2),
                 num_upsample_filters=(256, 256),
                 compute_dtype: Optional[torch.dtype] = torch.bfloat16):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.layer_nums = tuple(layer_nums)
        self.upsample_strides = tuple(upsample_strides)
        c_in = in_channels
        for i, (n, s, f) in enumerate(zip(layer_nums, layer_strides, num_filters)):
            self.add_module(f"block{i}_in", ConvBNReLU(c_in, f, 3, s, compute_dtype))
            for j in range(n):
                self.add_module(f"block{i}_conv{j}", ConvBNReLU(f, f, 3, 1, compute_dtype))
            us, uf = upsample_strides[i], num_upsample_filters[i]
            deblock = nn.Module()
            # stride > 1: a transposed conv, weight (Cin, Cout, us, us); else 1x1 conv
            shape = (f, uf, us, us) if us > 1 else (uf, f, 1, 1)
            deblock.weight = nn.Parameter(torch.zeros(shape))
            self.add_module(f"deblock{i}", deblock)
            self.add_module(f"deblock{i}_bn", BatchNorm2d(uf, eps=1e-3, momentum=0.01))
            c_in = f

    def forward(self, x):
        cd = self.compute_dtype or x.dtype
        x = x.permute(0, 3, 1, 2)
        ups = []
        for i, n in enumerate(self.layer_nums):
            x = getattr(self, f"block{i}_in")(x)
            for j in range(n):
                x = getattr(self, f"block{i}_conv{j}")(x)
            w = getattr(self, f"deblock{i}").weight.to(cd)
            us = self.upsample_strides[i]
            if us > 1:
                u = F.conv_transpose2d(x.to(cd), w, stride=us)
            else:
                u = F.conv2d(x.to(cd), w)
            ups.append(torch.relu(getattr(self, f"deblock{i}_bn")(u)))
        out = torch.cat(ups, dim=1) if len(ups) > 1 else ups[0]
        return out.permute(0, 2, 3, 1)


def bev_pool(features, keys, grid: GridSpec, pool: str = "max"):
    """BEVPool projection: (B, V, C) sparse features -> (B, ny, nx, C), each
    BEV cell the max (empty cells 0) or the mean over its occupied z cells,
    instead of stacking the depth slices into channels."""
    b, v, c = features.shape
    cells = grid.nx * grid.ny
    valid = keys != sparse.INVALID_KEY
    cell = torch.where(valid, keys.long() % cells, cells)  # padding -> a dropped cell
    index = cell[..., None].expand(-1, -1, c)
    if pool == "max":
        canvas = features.new_full((b, cells + 1, c), float("-inf"))
        canvas.scatter_reduce_(1, index, torch.where(valid[..., None], features, float("-inf")),
                               "amax")
        canvas = torch.where(torch.isfinite(canvas), canvas, 0.0)
    else:
        s = features.new_zeros((b, cells + 1, c)).scatter_add_(
            1, index, torch.where(valid[..., None], features, 0.0))
        n = features.new_zeros((b, cells + 1)).scatter_add_(1, cell, valid.to(features.dtype))
        canvas = s / torch.clamp(n[..., None], min=1.0)
    return canvas[:, :cells].reshape(b, grid.ny, grid.nx, c)


def _pseudo_grid(h: int, w: int, point_cloud_range, stride_m: float, device):
    """(H, W, 2) metric x, y of the BEV cell centres."""
    f32 = dict(dtype=torch.float32, device=device)
    ys = torch.tensor(point_cloud_range[1], **f32) + (torch.arange(h, **f32) + 0.5) * stride_m
    xs = torch.tensor(point_cloud_range[0], **f32) + (torch.arange(w, **f32) + 0.5) * stride_m
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx, gy], dim=-1)


def _rotate(xy, cth, sth):
    return torch.stack([xy[..., 0] * cth - xy[..., 1] * sth,
                        xy[..., 0] * sth + xy[..., 1] * cth], dim=-1)


def _fuse(aligned, fusion: str):
    if fusion == "first":
        return aligned[0]
    stack = torch.stack([a.float() for a in aligned])
    return stack.amax(dim=0) if fusion == "max" else stack.mean(dim=0)


def bev_align(bev_maps, transform_params, point_cloud_range, stride_m: float,
              fusion: str = "mean"):
    """Multi-stage BEV de-augmentation with host-side parameters: every
    (B, H, W, C) map of ``bev_maps`` is read bilinearly at the common frame's
    cell centres pushed forward through its stage's transform (an object
    with ``rot``, ``scale``, ``flip_x``, ``flip_y``, or None), then the maps
    are fused (``first`` / ``max`` / ``mean``)."""
    from .part_wraper import bilinear_sample_bev  # part_wraper imports this module

    b, h, w, _ = bev_maps[0].shape
    grid_xy = _pseudo_grid(h, w, point_cloud_range, stride_m, bev_maps[0].device)
    aligned = []
    for bev, p in zip(bev_maps, transform_params):
        xy = grid_xy
        if p is not None:
            xy = _rotate(xy * p.scale, math.cos(p.rot), math.sin(p.rot))
            if p.flip_x:
                xy = torch.stack([xy[..., 0], -xy[..., 1]], dim=-1)
            if p.flip_y:
                xy = torch.stack([-xy[..., 0], xy[..., 1]], dim=-1)
        aligned.append(bilinear_sample_bev(bev, xy.expand(b, h, w, 2), point_cloud_range,
                                           stride_m))
    return _fuse(aligned, fusion)


def bev_align_params(bev_maps, transform_param, point_cloud_range, stride_m: float,
                     names=("world_rotation", "world_flip", "world_scaling"),
                     fusion: str = "mean"):
    """The X_TRAIN clone protocol's BEV de-augmentation: stage i's map
    (i >= 1) is read bilinearly at the common frame's cell centres pushed
    forward through stage i's transform, then backward through stage 0's;
    stage 0's map is used as it is; the S maps are fused (``first`` /
    ``max`` / ``mean``, f32).

    bev_maps: S maps (B, H, W, C), stage 0 first; transform_param (B, S,
    n_cfg): each stage's parameter row, columns in ``names`` order."""
    from .part_wraper import bilinear_sample_bev  # part_wraper imports this module

    b, h, w, _ = bev_maps[0].shape
    grid_xy = _pseudo_grid(h, w, point_cloud_range, stride_m, bev_maps[0].device)
    rows = transform_param.float()

    def fwd(xy, row):  # row (B, n_cfg); xy (B, H, W, 2)
        for i, name in enumerate(names):
            v = row[:, i, None, None]
            if name == "world_rotation":
                xy = _rotate(xy, torch.cos(v), torch.sin(v))
            elif name == "world_flip":
                sign = 1.0 - 2.0 * (v > 0.5).float()
                xy = torch.stack([xy[..., 0], xy[..., 1] * sign], dim=-1)
            elif name == "world_scaling":
                xy = xy * v[..., None]
        return xy

    def bwd(xy, row):
        for i, name in reversed(list(enumerate(names))):
            v = row[:, i, None, None]
            if name == "world_rotation":
                xy = _rotate(xy, torch.cos(-v), torch.sin(-v))
            elif name == "world_flip":
                sign = 1.0 - 2.0 * (v > 0.5).float()
                xy = torch.stack([xy[..., 0], xy[..., 1] * sign], dim=-1)
            elif name == "world_scaling":
                xy = xy / v[..., None]
        return xy

    start = grid_xy.expand(b, h, w, 2)
    aligned = [bev_maps[0]]
    for i in range(1, len(bev_maps)):
        xy = bwd(fwd(start, rows[:, i]), rows[:, 0])
        aligned.append(bilinear_sample_bev(bev_maps[i], xy, point_cloud_range, stride_m))
    return _fuse(aligned, fusion)
