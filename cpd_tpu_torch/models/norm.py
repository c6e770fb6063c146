"""Batch norms (port of cpd_tpu/models/norm.py).

Both compute in f32 and cast the result back to the input dtype, at the JAX
package's cast points. In eval mode they normalise with their running
statistics. In training mode they normalise with the batch's own moments,
the gradient flows through those moments, and the running statistics move
by ``running = (1 - momentum) * running + momentum * batch`` with the BIASED
batch variance (torch's own BatchNorm stores the unbiased one).

Data-parallel: the batch moments are those of the GLOBAL batch, as under the
JAX package's ``pjit``. Each norm call sums its per-rank sums and count
across ranks with one differentiable collective
(``utils.collective.all_reduce_sum``), so every rank normalises with the
same moments and moves its running statistics identically. At world size
1 no collective runs.
"""
from __future__ import annotations

import torch
from torch import nn

from ..utils.collective import all_reduce_sum, get_world_size


class _RunningNorm(nn.Module):
    def __init__(self, num_features: int, eps: float, momentum: float):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def _update_running(self, mean, var):
        with torch.no_grad():
            self.running_mean.mul_(1.0 - self.momentum).add_(mean, alpha=self.momentum)
            self.running_var.mul_(1.0 - self.momentum).add_(var, alpha=self.momentum)

    def _normalize(self, x, mean, var):
        return (x.float() - mean) * torch.rsqrt(var + self.eps) * self.weight + self.bias


class MaskedBatchNorm(_RunningNorm):
    """BatchNorm over the valid rows of (..., C) features; rows outside
    ``valid`` come out zero and stay out of the batch moments, which are
    ``mean = E[x]``, ``var = clip(E[x^2] - mean^2, 0)`` over the valid rows."""

    def __init__(self, num_features: int, eps: float = 1e-3, momentum: float = 0.01):
        super().__init__(num_features, eps, momentum)

    def forward(self, x, valid):
        if self.training:
            mask = valid[..., None].float()
            xf = x.float()
            dims = tuple(range(x.dim() - 1))
            c = x.shape[-1]
            # [sum x, sum x^2, count] over every rank; the clamp after the sum,
            # so that a rank with no valid row still takes part
            stats = all_reduce_sum(torch.cat([(xf * mask).sum(dims), (xf * xf * mask).sum(dims),
                                              mask.sum().reshape(1)]))
            cnt = torch.clamp(stats[2 * c], min=1.0)
            mean = stats[:c] / cnt
            var = torch.clamp(stats[c:2 * c] / cnt - mean * mean, min=0.0)
            self._update_running(mean, var)
        else:
            mean, var = self.running_mean, self.running_var
        y = self._normalize(x, mean, var)
        return torch.where(valid[..., None], y, 0.0).to(x.dtype)


class BatchNorm2d(_RunningNorm):
    """BatchNorm over the channel axis of an NCHW map (torch defaults: eps
    1e-5, momentum 0.1). One process takes the two-pass variance of its
    batch; across ranks the moments come from [sum x, sum x^2, N H W] summed
    over them (``E[x^2] - E[x]^2``, as the JAX module's ``axis_name`` path)."""

    def __init__(self, num_features: int, eps: float = 1e-5, momentum: float = 0.1):
        super().__init__(num_features, eps, momentum)

    def forward(self, x):
        xc = x.movedim(1, -1)
        if self.training:
            xf = xc.float()
            dims = tuple(range(x.dim() - 1))
            if get_world_size() == 1:
                mean = xf.mean(dims)
                var = xf.var(dims, unbiased=False)
            else:
                c = x.shape[1]
                n = xf.new_full((1,), float(xf.numel() // c))
                stats = all_reduce_sum(torch.cat([xf.sum(dims), (xf * xf).sum(dims), n]))
                mean = stats[:c] / stats[2 * c]
                var = torch.clamp(stats[c:2 * c] / stats[2 * c] - mean * mean, min=0.0)
            self._update_running(mean, var)
        else:
            mean, var = self.running_mean, self.running_var
        return self._normalize(xc, mean, var).movedim(-1, 1).to(x.dtype)
