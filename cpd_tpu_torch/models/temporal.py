"""Temporal BEV fusion: concatenation, ConvGRU and ConvLSTM (port of
cpd_tpu/models/temporal.py).

Each takes a (B, T, H, W, C) stack of BEV maps, the current frame first, and
returns one (B, H, W, C') map for the 2D backbone. The convolutions are
cuDNN ``conv2d`` in f32 (flax promotes the bf16 maps to its f32 kernels):
TemporalConcatenation a 1x1 conv over the T maps' channels, the recurrent
models a shared 3x3 cell stepped over T, after a 1x1 ``in_proj`` where C
differs from the hidden width. At full width the GRU's gates conv is
3x3x512x512 and the LSTM's 3x3x512x1024 on the 188 x 188 map.
"""
from __future__ import annotations

import torch
from torch import nn

from .bev import conv2d


class _Conv2d(nn.Module):
    """Weight (Cout, Cin, k, k) and bias of a 'SAME' conv."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int):
        super().__init__()
        self.padding = kernel // 2
        self.weight = nn.Parameter(torch.zeros(out_channels, in_channels, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def forward(self, x):
        return conv2d(x, self.weight, self.bias, 1, self.padding)


def _frames_nchw(bev_seq):
    """(B, T, H, W, C) -> list of T f32 (B, C, H, W) maps."""
    return [bev_seq[:, t].float().permute(0, 3, 1, 2) for t in range(bev_seq.shape[1])]


class TemporalConcatenation(nn.Module):
    """The T maps' channels side by side (frame-major) + 1x1 conv + ReLU."""

    def __init__(self, in_channels: int, num_frames: int, out_channels: int = 256):
        super().__init__()
        self.fuse = _Conv2d(num_frames * in_channels, out_channels, 1)

    def forward(self, bev_seq):
        x = torch.cat(_frames_nchw(bev_seq), dim=1)
        return torch.relu(self.fuse(x)).permute(0, 2, 3, 1)


class ConvGRUCell(nn.Module):
    def __init__(self, hidden: int, kernel: int = 3):
        super().__init__()
        self.gates = _Conv2d(2 * hidden, 2 * hidden, kernel)
        self.cand = _Conv2d(2 * hidden, hidden, kernel)

    def forward(self, h, x):
        z, r = torch.sigmoid(self.gates(torch.cat([h, x], dim=1))).chunk(2, dim=1)
        cand = self.cand(torch.cat([r * h, x], dim=1))
        return (1 - z) * h + z * torch.tanh(cand)


class ConvLSTMCell(nn.Module):
    def __init__(self, hidden: int, kernel: int = 3):
        super().__init__()
        self.gates = _Conv2d(2 * hidden, 4 * hidden, kernel)

    def forward(self, carry, x):
        h, c = carry
        i, f, o, g = self.gates(torch.cat([h, x], dim=1)).chunk(4, dim=1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        return torch.sigmoid(o) * torch.tanh(c_new), c_new


class _Recurrent(nn.Module):
    """A shared cell stepped over the T maps from a zero state."""

    cell_cls = None

    def __init__(self, in_channels: int, hidden: int = 256):
        super().__init__()
        self.hidden = hidden
        if in_channels != hidden:
            self.in_proj = _Conv2d(in_channels, hidden, 1)
        self.cell = self.cell_cls(hidden)

    def _inputs(self, bev_seq):
        frames = _frames_nchw(bev_seq)
        return [self.in_proj(x) for x in frames] if hasattr(self, "in_proj") else frames


class ConvGRU(_Recurrent):
    cell_cls = ConvGRUCell

    def forward(self, bev_seq):
        frames = self._inputs(bev_seq)
        h = frames[0].new_zeros((frames[0].shape[0], self.hidden) + frames[0].shape[2:])
        for x in frames:
            h = self.cell(h, x)
        return h.permute(0, 2, 3, 1)


class ConvLSTM(_Recurrent):
    cell_cls = ConvLSTMCell

    def forward(self, bev_seq):
        frames = self._inputs(bev_seq)
        h = frames[0].new_zeros((frames[0].shape[0], self.hidden) + frames[0].shape[2:])
        carry = (h, h)
        for x in frames:
            carry = self.cell(carry, x)
        return carry[0].permute(0, 2, 3, 1)


TEMPORAL_MODELS = {"TemporalConcatenation": TemporalConcatenation, "ConvGRU": ConvGRU,
                   "ConvLSTM": ConvLSTM}
