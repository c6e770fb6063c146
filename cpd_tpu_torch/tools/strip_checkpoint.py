"""Checkpoint surgery: strip a training checkpoint to its model weights
(port of tools/strip_checkpoint.py; parity: the reference's deploy tool
kitti_object_eval_python/save_model_paras.py keeps only ``model_state``).

    python -m cpd_tpu_torch.tools.strip_checkpoint <checkpoint_epoch_N.pth> [--out <path>]

Keeps ``model_state`` (parameters and the batch-norm statistics that
inference needs), ``epoch``, ``it`` and ``version`` of a ``.pth`` that
``utils.checkpoint.save_checkpoint`` wrote, and writes ``optimizer_state:
None``: under Adam the two moments are two thirds of the file. The output
defaults to ``<name>_deploy.pth`` beside the input.
"""
from __future__ import annotations

import argparse
from pathlib import Path

import torch


def strip_checkpoint(ckpt_path, out_path=None) -> Path:
    ckpt_path = Path(ckpt_path)
    out_path = Path(out_path) if out_path else ckpt_path.with_name(
        ckpt_path.stem + "_deploy" + ckpt_path.suffix)
    payload = torch.load(ckpt_path, map_location="cpu", weights_only=True)
    stripped = {
        "model_state": payload["model_state"],
        "optimizer_state": None,
        "epoch": payload.get("epoch", 0),
        "it": payload.get("it", 0),
        "version": payload.get("version", "cpd_tpu_torch-0.1"),
    }
    out_path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(stripped, out_path)
    return out_path


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("ckpt_dir", help="the checkpoint file (.pth) to strip")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    out = strip_checkpoint(args.ckpt_dir, args.out)
    print(f"wrote {out}")
    return out


if __name__ == "__main__":
    main()
