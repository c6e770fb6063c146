"""The adam_onecycle trainer on one device (port of cpd_tpu/parallel/trainer.py).

The CPD optimizer: gradients clipped to a global norm of 32, then AdamW with
decoupled weight decay, the learning rate on a cosine one-cycle schedule and
Adam's b1 on the mirrored momentum schedule (high -> low -> high). A train
step is forward + loss (``VoxelRCNN.loss_step``), backward, the non-finite
guard, clip and update. Data-parallel training over several cards (gradient
all-reduce, synchronised batch norm) is not ported.

``init_state`` places the model with ``utils.device.place``: on the CUDA
card unless the caller asks for another device; with no card and no such
request it raises. The step runs where the state's model lives.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import torch
from torch import nn

from ..utils.device import place, resolve_device  # noqa: F401 (resolve_device re-exported)


def _cosine_interpolate(start: float, end: float, pct: float) -> float:
    return end + (start - end) / 2.0 * (math.cos(math.pi * pct) + 1.0)


def cosine_onecycle_schedule(total_steps: int, peak_value: float, pct_start: float = 0.4,
                             div_factor: float = 10.0, final_div_factor: float = 1000.0):
    """The one-cycle learning rate, as optax's ``cosine_onecycle_schedule``
    computes it: a half cosine from peak / div_factor up to the peak over
    the first int(pct_start * total_steps) steps, then a half cosine down to
    peak / (div_factor * final_div_factor) at total_steps, constant after.
    (``torch.optim.lr_scheduler.OneCycleLR`` ends its phases one step
    earlier.)"""
    if total_steps <= 0:
        raise ValueError("the one-cycle schedule needs a positive number of steps")
    bounds = (0, int(pct_start * total_steps), int(total_steps))
    init = peak_value / div_factor
    values = (init, init * div_factor, init * div_factor / (div_factor * final_div_factor))

    def sched(count: int) -> float:
        for i in (0, 1):
            if bounds[i] <= count < bounds[i + 1]:
                pct = (count - bounds[i]) / (bounds[i + 1] - bounds[i])
                return _cosine_interpolate(values[i], values[i + 1], pct)
        return values[-1] if count >= bounds[-1] else 0.0

    return sched


def onecycle_momentum_schedule(total_steps: int, moms=(0.95, 0.85), pct_start: float = 0.4):
    """Cosine momentum annealing mirroring the one-cycle rate (high -> low -> high)."""
    hi, lo = moms
    warm = max(int(total_steps * pct_start), 1)

    def sched(step: int) -> float:
        if step < warm:
            frac = min(max(step / warm, 0.0), 1.0)
            return hi + (lo - hi) * 0.5 * (1 - math.cos(math.pi * frac))
        frac = min(max((step - warm) / max(total_steps - warm, 1), 0.0), 1.0)
        return lo + (hi - lo) * 0.5 * (1 - math.cos(math.pi * frac))

    return sched


class AdamOneCycle(torch.optim.Optimizer):
    """Clip by global norm, then AdamW (decoupled weight decay, bias-corrected
    moments) with the learning rate and b1 read from schedules of its own
    update count:

        g    = grad * min(1, clip / |grads|)
        mu   = b1 mu + (1 - b1) g;   nu = b2 nu + (1 - b2) g^2
        p   -= lr * (mu / (1 - b1^t) / (sqrt(nu / (1 - b2^t)) + eps) + wd * p)

    with lr = lr_schedule(t - 1), b1 = b1_schedule(t - 1) and t the count of
    updates including this one. ``step`` returns the gradient norm before
    clipping; a non-finite norm leaves parameters, moments and count as they
    were (the skipped update) and zeroes the gradients."""

    def __init__(self, params, lr_schedule, b1_schedule, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 1e-5, grad_norm_clip: float = 32.0):
        super().__init__(params, dict(b2=b2, eps=eps, weight_decay=weight_decay))
        self.lr_schedule = lr_schedule
        self.b1_schedule = b1_schedule
        self.grad_norm_clip = grad_norm_clip
        self.count = 0

    @torch.no_grad()
    def global_grad_norm(self):
        grads = [p.grad for g in self.param_groups for p in g["params"] if p.grad is not None]
        if not grads:
            return torch.zeros(())
        return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("AdamOneCycle takes no closure")
        gnorm = self.global_grad_norm()
        if not bool(torch.isfinite(gnorm)):
            for g in self.param_groups:
                for p in g["params"]:
                    if p.grad is not None:
                        p.grad.zero_()
            return gnorm
        lr = self.lr_schedule(self.count)
        b1 = self.b1_schedule(self.count)
        self.count += 1
        scale = torch.where(gnorm < self.grad_norm_clip, torch.ones_like(gnorm),
                            self.grad_norm_clip / gnorm)
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            b2, eps, wd = group["b2"], group["eps"], group["weight_decay"]
            for p in params:
                if not self.state[p]:
                    self.state[p] = {"mu": torch.zeros_like(p), "nu": torch.zeros_like(p)}
            grads = torch._foreach_mul([p.grad for p in params], scale)
            mus = [self.state[p]["mu"] for p in params]
            nus = [self.state[p]["nu"] for p in params]
            torch._foreach_mul_(mus, b1)
            torch._foreach_add_(mus, grads, alpha=1.0 - b1)
            torch._foreach_mul_(nus, b2)
            torch._foreach_addcmul_(nus, grads, grads, value=1.0 - b2)
            denom = torch._foreach_div(nus, 1.0 - b2 ** self.count)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, eps)
            update = torch._foreach_div(mus, 1.0 - b1 ** self.count)
            torch._foreach_div_(update, denom)
            torch._foreach_add_(update, params, alpha=wd)
            torch._foreach_add_(params, update, alpha=-lr)
        return gnorm


def build_optimizer(params, opt_cfg: Dict, total_steps: int) -> AdamOneCycle:
    """adam_onecycle (the CPD default) from the JAX package's config keys:
    LR, WEIGHT_DECAY, GRAD_NORM_CLIP, PCT_START, DIV_FACTOR, MOMS."""
    name = opt_cfg.get("OPTIMIZER", "adam_onecycle")
    if name != "adam_onecycle":
        raise KeyError(f"optimizer {name!r} is not ported (adam_onecycle is)")
    pct = float(opt_cfg.get("PCT_START", 0.4))
    return AdamOneCycle(
        params,
        cosine_onecycle_schedule(total_steps, float(opt_cfg.get("LR", 0.003)), pct,
                                 float(opt_cfg.get("DIV_FACTOR", 10)), 1000.0),
        onecycle_momentum_schedule(total_steps, tuple(opt_cfg.get("MOMS", (0.95, 0.85))), pct),
        weight_decay=float(opt_cfg.get("WEIGHT_DECAY", 1e-5)),
        grad_norm_clip=float(opt_cfg.get("GRAD_NORM_CLIP", 32)))


@dataclasses.dataclass
class TrainState:
    """What a train step carries: the model (parameters and batch-norm
    statistics), the optimizer (moments and its update count) and the step
    counter, which also advances on a skipped step."""

    step: int
    model: nn.Module
    optimizer: AdamOneCycle


def init_state(model: nn.Module, opt_cfg: Dict, total_steps: int, device=None) -> TrainState:
    """Move ``model`` to the device, put it in training mode and build its
    optimizer."""
    model = place(model, device).train()
    return TrainState(0, model, build_optimizer(model.parameters(), opt_cfg, total_steps))


def make_train_step():
    """-> ``train_step(state, batch, generator=None, sampling_uniforms=None)``
    returning ``(state, tb)``: one forward + loss + backward + update of
    ``state.model`` on the device ``init_state`` put it on.

    ``batch`` holds tensors (moved to that device if they are elsewhere); the
    step counter goes in as ``cur_it``. Non-finite guard: when the gradient
    norm is not finite the update is skipped, the batch-norm statistics that
    the forward moved are put back, and ``tb["skipped_nonfinite"]`` is 1; the
    step counter advances all the same (``tb["grad_norm"]`` reports the norm
    before clipping)."""
    def train_step(state: TrainState, batch, generator: Optional[torch.Generator] = None,
                   sampling_uniforms=None):
        model, optimizer = state.model, state.optimizer
        device = next(model.parameters()).device
        batch = {k: v.to(device) if isinstance(v, torch.Tensor) else v
                 for k, v in batch.items()}
        batch["cur_it"] = float(state.step)
        buffers = list(model.buffers())
        saved = [b.clone() for b in buffers]
        optimizer.zero_grad(set_to_none=True)
        loss, tb = model.loss_step(batch, sampling_uniforms, generator)
        loss.backward()
        gnorm = optimizer.step()
        finite = bool(torch.isfinite(gnorm))
        if not finite:
            with torch.no_grad():
                torch._foreach_copy_(buffers, saved)
        tb = {k: v.detach() for k, v in tb.items()}
        tb["grad_norm"] = gnorm
        tb["skipped_nonfinite"] = torch.tensor(0.0 if finite else 1.0, device=gnorm.device)
        state.step += 1
        return state, tb

    return train_step
