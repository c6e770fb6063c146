"""Checkpoint save/load with rotation + auto-resume (port of
cpd_tpu/utils/checkpoint.py, in the reference's format).

A checkpoint is the reference's ``.pth`` (tools/train_utils/train_utils.py:
100-149): ``torch.save`` of ``{model_state, optimizer_state, epoch, it,
version}`` as ``<root>/checkpoint_epoch_{epoch}.pth``, rotated to the newest
``max_keep``; ``auto_resume`` continues from the newest one (tools/train.py:
129-139). The JAX package keeps the same fields in orbax directories.

``state`` is what holds the weights: a ``parallel.TrainState`` (model,
optimizer and step counter) or a bare model (``optimizer_state`` is then
None and ``it`` 0). ``load_torch_checkpoint`` reads a published reference
checkpoint for ``utils.torch_import``.
"""
from __future__ import annotations

import re
from pathlib import Path

import torch
from torch import nn

VERSION = "cpd_tpu_torch-0.1"


def _parts(state):
    """(model, optimizer or None, step) of a TrainState or a bare model."""
    if isinstance(state, nn.Module):
        return state, None, 0
    return state.model, state.optimizer, int(state.step)


def _ckpt_path(root: Path, epoch: int) -> Path:
    return Path(root) / f"checkpoint_epoch_{epoch}.pth"


def save_checkpoint(root, state, epoch: int, max_keep: int = 30) -> Path:
    """Save ``state`` as checkpoint ``epoch``; remove the oldest beyond ``max_keep``."""
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    model, optimizer, step = _parts(state)
    payload = {
        "model_state": {k: v.detach().cpu() for k, v in model.state_dict().items()},
        "optimizer_state": optimizer.state_dict() if optimizer is not None else None,
        "epoch": int(epoch),
        "it": step,
        "version": VERSION,
    }
    path = _ckpt_path(root, epoch)
    torch.save(payload, path)
    # rotation (train_utils.py:100-112)
    ckpts = list_checkpoints(root)
    while len(ckpts) > max_keep:
        ckpts.pop(0)[1].unlink()
    return path


def list_checkpoints(root):
    """Sorted [(epoch, path)] of saved checkpoints."""
    root = Path(root)
    out = []
    if not root.exists():
        return out
    for p in root.iterdir():
        m = re.match(r"checkpoint_epoch_(\d+)\.pth$", p.name)
        if m:
            out.append((int(m.group(1)), p))
    return sorted(out)


def load_checkpoint(path, state=None, strict: bool = True) -> dict:
    """Read a checkpoint (tensors on the CPU); with ``state`` also load its
    ``model_state`` into the model (strict by default: every key present on
    both sides, shapes equal) and, where both have one, its
    ``optimizer_state`` into the optimizer. Returns the payload."""
    payload = torch.load(Path(path), map_location="cpu", weights_only=True)
    if state is not None:
        model, optimizer, _ = _parts(state)
        model.load_state_dict(payload["model_state"], strict=strict)
        if optimizer is not None and payload.get("optimizer_state") is not None:
            optimizer.load_state_dict(payload["optimizer_state"])
    return payload


def auto_resume(root, state):
    """Resume from the newest checkpoint if present (train.py:129-139):
    weights, optimizer state and step counter. Returns (state, start_epoch)."""
    ckpts = list_checkpoints(root)
    if not ckpts:
        return state, 0
    payload = load_checkpoint(ckpts[-1][1], state)
    if not isinstance(state, nn.Module):
        state.step = int(payload["it"])
    return state, int(payload["epoch"]) + 1


def load_params_from_file(state, path, logger=None):
    """Load weights only (--pretrained_model semantics): non-strict. Every
    tensor whose key and shape the model shares is loaded; the file's other
    keys and the model keys left as they were are logged."""
    model, _, _ = _parts(state)
    saved = torch.load(Path(path), map_location="cpu", weights_only=True)["model_state"]
    own = model.state_dict()
    loaded = {k: v for k, v in saved.items() if k in own and own[k].shape == v.shape}
    model.load_state_dict(loaded, strict=False)
    if logger:
        skipped = sorted(set(saved) - set(loaded))
        kept = sorted(set(own) - set(loaded))
        logger.info(f"loaded {len(loaded)}/{len(own)} pretrained tensors from {path}")
        if skipped:
            logger.info(f"skipped from the file (unknown key or other shape): {skipped}")
        if kept:
            logger.info(f"not updated in the model: {kept}")
    return state


def load_torch_checkpoint(pth_path) -> dict:
    """Read a reference .pth into a flat {name: np.ndarray} dict (its
    ``model_state`` where it has one), as the JAX package's
    ``load_torch_checkpoint`` does. The file is read with
    ``weights_only=True`` (tensors, containers, numbers and strings: what a
    reference checkpoint holds), so that no code in it runs. The key mapping
    into the port's model is ``utils.torch_import.convert_reference_state_dict``."""
    sd = torch.load(Path(pth_path), map_location="cpu", weights_only=True)
    if "model_state" in sd:
        sd = sd["model_state"]
    return {k: v.detach().cpu().numpy() for k, v in sd.items() if hasattr(v, "detach")}
