"""The trainer (port of cpd_tpu/parallel/trainer.py).

The CPD optimizer, adam_onecycle: gradients clipped to a global norm of 32,
then AdamW with decoupled weight decay, the learning rate on a cosine
one-cycle schedule and Adam's b1 on the mirrored momentum schedule (high ->
low -> high); ``adam`` and ``sgd`` clip the same way. A train step is
forward + loss (``VoxelRCNN.loss_step``), backward, the non-finite guard,
clip and update; ``step_generator`` seeds the step's random numbers (RoI
sampling, dropout) from the run's seed, the step counter and the rank.

Data parallel over the ranks of a ``torch.distributed`` group
(``comm.init_distributed``), with the JAX package's ``pjit`` semantics: the
step is the one-device step on the GLOBAL batch, each rank holding its
shard. The batch norms take their moments over every rank and the losses'
batch-wide counts are global (``comm``), so each rank's loss is its share of
the global loss; after the backward one all-reduce sums the shares'
gradients (``all_reduce_gradients``), and only then do the clip, the norm and
the guard read them: every rank updates, or skips, alike. No DDP wrapper:
the step runs through ``loss_step``, not ``forward``, and DDP would average
where the shares must be summed.

``init_state`` places the model with ``utils.device.place``: on the CUDA
card unless the caller asks for another device; with no card and no such
request it raises. The step runs where the state's model lives, under
``deterministic_cudnn``: one step from the same state gives the same bits
twice on the card, as a JAX step does.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from ..utils.device import place, resolve_device  # noqa: F401 (resolve_device re-exported)
from . import comm


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


class ClippedOptimizer(torch.optim.Optimizer):
    """Gradients clipped to a global norm, then the update rule of a subclass
    (``_update``), as optax's ``chain(clip_by_global_norm(clip), inner)``. A
    parameter without a gradient (``.grad`` None: no loss term reads it)
    takes a zero gradient in the update, as JAX's gradient of it is zero: its
    moments decay and AdamW's weight decay moves it. ``step`` returns the
    gradient norm before clipping (over the parameters that have a
    gradient); a non-finite norm
    leaves parameters, optimizer state and update count as they were (the
    skipped update) and zeroes the gradients. ``state_dict`` carries the
    update count, which the schedules read."""

    def __init__(self, params, defaults, grad_norm_clip: float = 32.0):
        super().__init__(params, defaults)
        self.grad_norm_clip = grad_norm_clip
        self.count = 0

    def state_dict(self):
        out = super().state_dict()
        out["count"] = self.count
        return out

    def load_state_dict(self, state_dict):
        state_dict = dict(state_dict)
        self.count = int(state_dict.pop("count"))
        super().load_state_dict(state_dict)

    @torch.no_grad()
    def global_grad_norm(self):
        grads = [p.grad for g in self.param_groups for p in g["params"] if p.grad is not None]
        if not grads:
            return torch.zeros(())
        return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError(f"{type(self).__name__} takes no closure")
        gnorm = self.global_grad_norm()
        if not bool(torch.isfinite(gnorm)):
            for g in self.param_groups:
                for p in g["params"]:
                    if p.grad is not None:
                        p.grad.zero_()
            return gnorm
        self.count += 1
        scale = torch.where(gnorm < self.grad_norm_clip, torch.ones_like(gnorm),
                            self.grad_norm_clip / gnorm)
        for group in self.param_groups:
            params = group["params"]
            grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
            if params:
                self._update(group, params, torch._foreach_mul(grads, scale))
        return gnorm

    def _update(self, group, params, grads):
        """Apply update number ``self.count`` to ``params`` from the clipped
        ``grads``."""
        raise NotImplementedError


class ClippedAdamW(ClippedOptimizer):
    """AdamW (decoupled weight decay, bias-corrected moments) with the
    learning rate and b1 read from schedules of the update count:

        g    = grad * min(1, clip / |grads|)
        mu   = b1 mu + (1 - b1) g;   nu = b2 nu + (1 - b2) g^2
        p   -= lr * (mu / (1 - b1^t) / (sqrt(nu / (1 - b2^t)) + eps) + wd * p)

    with lr = lr_schedule(t - 1), b1 = b1_schedule(t - 1) and t the count of
    updates including this one."""

    def __init__(self, params, lr_schedule, b1_schedule, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 1e-5, grad_norm_clip: float = 32.0):
        super().__init__(params, dict(b2=b2, eps=eps, weight_decay=weight_decay), grad_norm_clip)
        self.lr_schedule = lr_schedule
        self.b1_schedule = b1_schedule

    def _update(self, group, params, grads):
        t = self.count
        lr, b1 = self.lr_schedule(t - 1), self.b1_schedule(t - 1)
        b2, eps, wd = group["b2"], group["eps"], group["weight_decay"]
        for p in params:
            if not self.state[p]:
                self.state[p] = {"mu": torch.zeros_like(p), "nu": torch.zeros_like(p)}
        mus = [self.state[p]["mu"] for p in params]
        nus = [self.state[p]["nu"] for p in params]
        torch._foreach_mul_(mus, b1)
        torch._foreach_add_(mus, grads, alpha=1.0 - b1)
        torch._foreach_mul_(nus, b2)
        torch._foreach_addcmul_(nus, grads, grads, value=1.0 - b2)
        denom = torch._foreach_div(nus, 1.0 - b2 ** t)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, eps)
        update = torch._foreach_div(mus, 1.0 - b1 ** t)
        torch._foreach_div_(update, denom)
        torch._foreach_add_(update, params, alpha=wd)
        torch._foreach_add_(params, update, alpha=-lr)


class ClippedSGD(ClippedOptimizer):
    """SGD with heavy-ball momentum and no weight decay, as ``optax.sgd``:
    ``m = g + momentum * m;  p -= lr * m`` on the clipped gradients."""

    def __init__(self, params, lr: float, momentum: float = 0.9, grad_norm_clip: float = 32.0):
        super().__init__(params, dict(lr=lr, momentum=momentum), grad_norm_clip)

    def _update(self, group, params, grads):
        for p in params:
            if not self.state[p]:
                self.state[p] = {"trace": torch.zeros_like(p)}
        traces = [self.state[p]["trace"] for p in params]
        torch._foreach_mul_(traces, group["momentum"])
        torch._foreach_add_(traces, grads)
        torch._foreach_add_(params, traces, alpha=-group["lr"])


def build_optimizer(params, opt_cfg: Dict, total_steps: int) -> ClippedOptimizer:
    """The JAX package's three optimizers from the same config keys, each
    after a clip to GRAD_NORM_CLIP: adam_onecycle (the CPD default: AdamW
    with the one-cycle rate and b1 from LR, PCT_START, DIV_FACTOR, MOMS),
    adam (AdamW at the constant LR) and sgd (LR, MOMENTUM, no decay); both
    AdamWs decay by WEIGHT_DECAY. Another name raises a KeyError."""
    name = opt_cfg.get("OPTIMIZER", "adam_onecycle")
    lr = float(opt_cfg.get("LR", 0.003))
    wd = float(opt_cfg.get("WEIGHT_DECAY", 1e-5))
    clip = float(opt_cfg.get("GRAD_NORM_CLIP", 32))
    if name == "adam_onecycle":
        pct = float(opt_cfg.get("PCT_START", 0.4))
        return ClippedAdamW(
            params,
            cosine_onecycle_schedule(total_steps, lr, pct, float(opt_cfg.get("DIV_FACTOR", 10)),
                                     1000.0),
            onecycle_momentum_schedule(total_steps, tuple(opt_cfg.get("MOMS", (0.95, 0.85))), pct),
            weight_decay=wd, grad_norm_clip=clip)
    if name == "adam":
        return ClippedAdamW(params, lambda t: lr, lambda t: 0.9, weight_decay=wd,
                            grad_norm_clip=clip)
    if name == "sgd":
        return ClippedSGD(params, lr, float(opt_cfg.get("MOMENTUM", 0.9)), grad_norm_clip=clip)
    raise KeyError(f"unknown optimizer {name}")


@dataclasses.dataclass
class TrainState:
    """What a train step carries: the model (parameters and batch-norm
    statistics), the optimizer (moments and its update count) and the step
    counter, which also advances on a skipped step."""

    step: int
    model: nn.Module
    optimizer: ClippedOptimizer


def init_state(model: nn.Module, opt_cfg: Dict, total_steps: int, device=None) -> TrainState:
    """Move ``model`` to the device, put it in training mode and build its
    optimizer."""
    model = place(model, device).train()
    return TrainState(0, model, build_optimizer(model.parameters(), opt_cfg, total_steps))


def step_generator(seed: int, step: int, device, rank: int = 0) -> torch.Generator:
    """The generator of one train step's random numbers (RoI-sampling
    uniforms, dropout masks) on ``device``, seeded from ``(seed, step)``
    alone on rank 0 and from ``(seed, step, rank)`` on another rank: a run
    resumed at step n draws what an unbroken run draws there (the JAX
    trainer folds the step into one key drawn from the seed), and ranks
    draw apart."""
    entropy = (seed, step) if rank == 0 else (seed, step, rank)
    state = np.random.SeedSequence(entropy).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state))


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN with deterministic algorithms and no autotuning inside the
    scope; the caller's two flags are put back on leaving it, also when the
    scope raises. Other cuDNN settings (enabled, TF32) stay the caller's.
    Without it a convolution's weight gradient may sum with atomics, in an
    order that changes from run to run."""
    cudnn = torch.backends.cudnn
    saved = cudnn.benchmark, cudnn.deterministic
    cudnn.benchmark, cudnn.deterministic = False, True
    try:
        yield
    finally:
        cudnn.benchmark, cudnn.deterministic = saved


def all_reduce_gradients(params) -> int:
    """Sum every parameter's gradient over the ranks with one all-reduce of
    one flat f32 bucket: each gradient (zeros where this rank has None) and,
    behind them, a 1 for each parameter that has one. A parameter that no
    rank gave a gradient keeps None (the optimizer updates it with a zero
    gradient, as on one device). Returns the bucket's bytes; 0 at world size
    1, where nothing runs."""
    if comm.get_world_size() == 1:
        return 0
    params = list(params)
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
    has = torch.tensor([float(p.grad is not None) for p in params], device=grads[0].device)
    bucket = comm.all_reduce_(torch.cat([g.reshape(-1).float() for g in grads] + [has]), "grad")
    offset = 0
    for p, flag in zip(params, bucket[-len(params):].tolist()):
        n = p.numel()
        p.grad = bucket[offset:offset + n].view_as(p).to(p.dtype) if flag else None
        offset += n
    return bucket.numel() * bucket.element_size()


def kernel_launches() -> Dict[str, int]:
    """Launches so far of the kernels a train step runs: A1 (forward and
    dX) and A2 (dW)."""
    from ..ops import gather_gemm
    return {"A1": gather_gemm.gather_gemm.launches, "A2": gather_gemm.gather_gemm_dw.launches}


def make_train_step():
    """-> ``train_step(state, batch, generator=None, sampling_uniforms=None)``
    returning ``(state, tb)``: one forward + loss + backward + update of
    ``state.model`` on the device ``init_state`` put it on.

    ``batch`` holds tensors (moved to that device if they are elsewhere); the
    step counter goes in as ``cur_it``. In a process group ``batch`` is this
    rank's shard of the global batch, ``tb`` holds this rank's shares of the
    losses (their sum over the ranks is the global loss) and the gradients
    are summed over the ranks before the guard. Non-finite guard: when the
    gradient norm is not finite the update is skipped, the batch-norm
    statistics that the forward moved are put back, and
    ``tb["skipped_nonfinite"]`` is 1; the step counter advances all the same
    (``tb["grad_norm"]`` reports the norm before clipping).

    ``train_step.trace`` describes the last step: the kernel launches of its
    forward and of its backward (``kernel_launches``) and the gradient
    bucket's bytes."""
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
        launches = [kernel_launches()]
        with deterministic_cudnn():
            loss, tb = model.loss_step(batch, sampling_uniforms, generator)
            launches.append(kernel_launches())
            loss.backward()
        bucket_bytes = all_reduce_gradients(model.parameters())
        launches.append(kernel_launches())
        train_step.trace = {
            "forward": {k: launches[1][k] - launches[0][k] for k in launches[0]},
            "backward": {k: launches[2][k] - launches[1][k] for k in launches[0]},
            "grad_bucket_bytes": bucket_bytes}
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

    train_step.trace = None
    return train_step


def make_eval_step(model: nn.Module):
    """-> ``eval_step(batch)``: ``model.predict`` in eval mode under
    ``torch.no_grad()`` on the device the model lives on (port of
    cpd_tpu/parallel/trainer.py:189; tensors of ``batch`` that are elsewhere
    are moved there). No collective: in eval mode the norms read their
    running statistics, so each rank predicts its shard on its own."""
    model.eval()
    device = next(model.parameters()).device

    @torch.no_grad()
    def eval_step(batch):
        batch = {k: v.to(device) if isinstance(v, torch.Tensor) else v
                 for k, v in batch.items()}
        return model.predict(batch)

    return eval_step
