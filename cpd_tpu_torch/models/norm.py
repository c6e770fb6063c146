"""Batch norms, inference path (port of cpd_tpu/models/norm.py).

Both normalise with their running statistics in f32 and cast the result back
to the input dtype, at the JAX package's cast points. Batch statistics
(training) come with the training path; a module in training mode raises.
"""
from __future__ import annotations

import torch
from torch import nn


class _RunningNorm(nn.Module):
    def __init__(self, num_features: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def _normalize(self, x):
        if self.training:
            raise NotImplementedError("batch statistics (training mode) are not ported "
                                      "yet; call .eval()")
        return ((x.float() - self.running_mean) * torch.rsqrt(self.running_var + self.eps)
                * self.weight + self.bias)


class MaskedBatchNorm(_RunningNorm):
    """BatchNorm over (..., C) rows; rows outside ``valid`` come out zero."""

    def __init__(self, num_features: int, eps: float = 1e-3):
        super().__init__(num_features, eps)

    def forward(self, x, valid):
        y = self._normalize(x)
        return torch.where(valid[..., None], y, 0.0).to(x.dtype)


class BatchNorm2d(_RunningNorm):
    """BatchNorm over the channel axis of an NCHW map (torch eps default 1e-5)."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__(num_features, eps)

    def forward(self, x):
        y = self._normalize(x.movedim(1, -1)).movedim(-1, 1)
        return y.to(x.dtype)
