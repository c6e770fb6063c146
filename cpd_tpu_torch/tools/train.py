"""Training CLI helpers (port of tools/train.py). Only ``device_batch``, which
the evaluation CLI shares, is ported; the training CLI itself is not yet."""
from __future__ import annotations

import numpy as np
import torch

# the arrays of a host batch that the model reads; metadata stays on the host
DEVICE_KEYS = ("points", "points_valid", "points1", "points1_valid",
               "gt_boxes", "gt_valid", "css_score")


def device_batch(batch, device):
    """Host batch (NumPy arrays + metadata) -> tensors of ``DEVICE_KEYS`` on
    ``device``; to a CUDA card they are copied from pinned memory without
    blocking the host."""
    device = torch.device(device)
    out = {}
    for k in DEVICE_KEYS:
        if k not in batch:
            continue
        t = torch.from_numpy(np.ascontiguousarray(batch[k]))
        if device.type == "cuda":
            t = t.pin_memory()
        out[k] = t.to(device, non_blocking=True)
    return out
