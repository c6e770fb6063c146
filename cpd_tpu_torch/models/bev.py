"""BEV stack: sparse->dense height compression + 2D conv pyramid (port of
cpd_tpu/models/bev.py).

Public maps are NHWC, as in the JAX package; the convolutions run on an
NCHW view of them (a channels-last view, so the permutes move no data on the
GPU). Parameters are f32 and the convs run in ``compute_dtype`` (bf16 by
default), casting at the JAX package's points.
"""
from __future__ import annotations

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
