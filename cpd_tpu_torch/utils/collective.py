"""Sums across data-parallel ranks that the models and losses call (the
reference keeps its collectives under utils/, commu_utils.py): the world size
and rank of the ``torch.distributed`` process group (1 and 0 outside one),
``all_reduce_sum``, a sum with a gradient (the batch norms' moments), and
``global_sum``, one without (the losses' batch-wide counts). At world size 1
they return their argument and no collective runs.

Every collective that moves data is counted and timed by kind in
``COLLECTIVES`` (``"norm"``, ``"loss"``, ``"grad"``): CUDA events around it on
the card, the host clock on the CPU; ``take_collective_stats`` reads and
clears them. ``parallel.comm`` holds the rest of the collectives and joins
the process group.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict

import torch
import torch.distributed as dist


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def get_world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def get_rank() -> int:
    return dist.get_rank() if is_initialized() else 0


class CollectiveStats:
    """Calls, bytes and time of the collectives of one kind since the last
    ``take``."""

    def __init__(self):
        self.calls, self.nbytes, self._spans = 0, 0, []

    @contextlib.contextmanager
    def span(self, t: torch.Tensor):
        self.calls += 1
        self.nbytes += t.numel() * t.element_size()
        if t.is_cuda:
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            yield
            end.record()
            self._spans.append((start, end))
        else:
            t0 = time.perf_counter()
            yield
            self._spans.append((time.perf_counter() - t0) * 1e3)

    def take(self) -> Dict[str, float]:
        """{"calls", "bytes", "ms"} since the last call (waits for the card)."""
        ms = 0.0
        for s in self._spans:
            if isinstance(s, tuple):
                s[1].synchronize()
                ms += s[0].elapsed_time(s[1])
            else:
                ms += s
        out = {"calls": self.calls, "bytes": self.nbytes, "ms": ms}
        self.calls, self.nbytes, self._spans = 0, 0, []
        return out


COLLECTIVES = {kind: CollectiveStats() for kind in ("norm", "loss", "grad")}


def take_collective_stats() -> Dict[str, Dict[str, float]]:
    return {kind: s.take() for kind, s in COLLECTIVES.items()}


def all_reduce_(t: torch.Tensor, kind: str) -> torch.Tensor:
    """In-place sum of ``t`` over every rank, counted under ``kind``."""
    with COLLECTIVES[kind].span(t):
        dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return t


class _AllReduceSum(torch.autograd.Function):
    """y = sum over ranks of x. Every rank's y feeds its own share of the
    loss, so dL/dx on each rank is the sum over ranks of dL_r/dy: the
    backward is the same all-reduce of the incoming gradient."""

    @staticmethod
    def forward(ctx, x):
        return all_reduce_(x.clone(), "norm")

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.contiguous().clone(), "norm")


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """Sum of ``t`` over every rank, differentiable; ``t`` itself at world
    size 1. Every rank must call it in the same order, also in the
    backward: a rank's batch with nothing valid still calls it."""
    if get_world_size() == 1:
        return t
    return _AllReduceSum.apply(t)


def global_sum(t: torch.Tensor) -> torch.Tensor:
    """Sum of ``t`` over every rank without a gradient (a count that
    normalises a loss); ``t`` itself at world size 1."""
    if get_world_size() == 1:
        return t
    return all_reduce_(t.detach().clone(), "loss")
