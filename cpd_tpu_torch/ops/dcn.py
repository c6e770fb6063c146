"""Deformable convolution v1/v2 (port of cpd_tpu/ops/dcn.py), NHWC.

Each kernel tap samples the input bilinearly at its offset-shifted place
(taps outside the image read 0 through clipped indices), optionally scaled
by a modulation; the taps then go through one im2col product.
"""
from __future__ import annotations

import math

import torch
from torch import nn


def _bilinear_gather(img, ys, xs):
    """img (B, H, W, C); ys/xs (B, ...) float coords -> (B, ..., C)."""
    b, h, w, c = img.shape
    flat = img.reshape(b, h * w, c)
    y0 = torch.floor(ys).to(torch.int64)
    x0 = torch.floor(xs).to(torch.int64)
    dy = ys - y0
    dx = xs - x0
    rows = torch.arange(b, device=img.device).reshape((b,) + (1,) * (ys.dim() - 1))

    def at(yi, xi):
        ok = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        v = flat[rows, yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)]
        return torch.where(ok[..., None], v, 0.0)

    return (at(y0, x0) * ((1 - dy) * (1 - dx))[..., None]
            + at(y0, x0 + 1) * ((1 - dy) * dx)[..., None]
            + at(y0 + 1, x0) * (dy * (1 - dx))[..., None]
            + at(y0 + 1, x0 + 1) * (dy * dx)[..., None])


def deform_conv2d_batched(x, offsets, weights, mask=None, stride: int = 1):
    """``deform_conv2d`` on a batch: x (B, H, W, Cin), offsets (B, Ho, Wo,
    K*2), weights (K, Cin, Cout), mask (B, Ho, Wo, K) -> (B, Ho, Wo, Cout)."""
    b, _, _, cin = x.shape
    _, ho, wo, _ = offsets.shape
    k = weights.shape[0]
    kh = kw = int(round(k ** 0.5))
    base_y = torch.arange(ho, device=x.device) * stride
    base_x = torch.arange(wo, device=x.device) * stride
    yy, xx = torch.meshgrid(base_y, base_x, indexing="ij")
    off = offsets.reshape(b, ho, wo, k, 2)
    taps = [(i - kh // 2, j - kw // 2) for i in range(kh) for j in range(kw)]
    cols = []
    for t, (ti, tj) in enumerate(taps):
        v = _bilinear_gather(x, yy + ti + off[..., t, 0], xx + tj + off[..., t, 1])
        if mask is not None:
            v = v * mask[..., t][..., None]
        cols.append(v)
    col = torch.stack(cols, dim=3).reshape(b * ho * wo, k * cin)
    return torch.matmul(col, weights.reshape(k * cin, -1)).reshape(b, ho, wo, -1)


def deform_conv2d(x, offsets, weights, mask=None, stride: int = 1):
    """Deformable conv of ONE image. x (H, W, Cin); offsets (Ho, Wo, K*2),
    per tap (dy, dx); weights (K, Cin, Cout), K = kh*kw; mask an optional
    (Ho, Wo, K) modulation (DCNv2). Returns (Ho, Wo, Cout)."""
    return deform_conv2d_batched(x[None], offsets[None], weights,
                                 None if mask is None else mask[None], stride)[0]


class DeformConv2d(nn.Module):
    """DCNv1/v2 layer on (B, H, W, C): learned offsets (and a modulation of
    2 * sigmoid, ``modulated``) from a zero-initialised 'same' conv, then
    ``deform_conv2d``."""

    def __init__(self, in_channels: int, features: int, kernel: int = 3, modulated: bool = True):
        super().__init__()
        self.kernel, self.modulated = kernel, modulated
        k = kernel * kernel
        self.offset_conv = nn.Conv2d(in_channels, k * (3 if modulated else 2), kernel,
                                     padding=kernel // 2)
        nn.init.zeros_(self.offset_conv.weight)
        nn.init.zeros_(self.offset_conv.bias)
        self.weight = nn.Parameter(torch.empty(k, in_channels, features))
        nn.init.normal_(self.weight, 0.0, 1.0 / math.sqrt(in_channels))

    def forward(self, x):
        k = self.kernel * self.kernel
        off = self.offset_conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        mask = torch.sigmoid(off[..., 2 * k:]) * 2.0 if self.modulated else None
        return deform_conv2d_batched(x, off[..., :2 * k], self.weight, mask)
