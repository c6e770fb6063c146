"""Where a model runs: the CUDA card unless the caller asks for another device.

The kernel wrappers pick their path by the device of the tensors they are
given, so a model that was never moved computes everything on the CPU through
the plain versions, silently. ``place`` is the one entry that decides:
inference code calls it on a freshly built model, ``parallel.init_state``
calls it for training.
"""
from __future__ import annotations

import torch
from torch import nn


def resolve_device(device=None) -> torch.device:
    """``device`` as given, or the CUDA card; raises where there is neither."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card found: pass device='cpu' to run on the CPU")
    return torch.device("cuda")


def place(model: nn.Module, device=None) -> nn.Module:
    """Move ``model`` to the CUDA card and return it; without a card this
    raises unless ``device="cpu"`` (or another device) is asked for."""
    return model.to(resolve_device(device))
