"""Training CLI (port of tools/train.py; parity with reference tools/train.py
flags and flow).

    python -m cpd_tpu_torch.tools.train --cfg_file tools/cfgs/models/voxel_rcnn_cproto_center.yaml \
        [--device cpu] [--set KEY VALUE ...]
    torchrun --nproc_per_node N -m cpd_tpu_torch.tools.train --cfg_file ... # N ranks

Flow: config -> the process group (``parallel.comm.init_distributed``: one
process without ``torchrun``) -> training dataloader (this rank's shard) ->
``build_network`` with weights drawn from ``--seed`` -> optimizer
(adam_onecycle, adam or sgd) -> ``--pretrained_model`` -> ``--ckpt`` or
auto-resume from ``<out>/ckpt`` -> the epoch loop (``device_batch``, then
``make_train_step``: on one device, or data-parallel with the gradients
summed over the ranks) -> a checkpoint per epoch with rotation -> optionally
the evaluation CLI on the last checkpoints, on every rank.
Writes ``log_train.txt``, ``metrics.jsonl`` and ``ckpt/`` under
``--output_dir`` (default ``output/<cfg TAG>/<extra_tag>``); under
``torchrun`` rank 0 alone writes, and every rank logs its own lines
(``rank R/W ...``: the kernel launches, the collectives and the host ms of
each logged step, phase means, peak memory and a checksum of its final
weights, which must agree over the ranks) to its console. The model runs on the CUDA card;
``--device cpu`` asks for the CPU, and without a card and without it the
CLI raises. ``--batch_size`` is the GLOBAL batch, as in the JAX CLI
(default ``BATCH_SIZE_PER_GPU`` times the ranks); the ranks must divide it.
The config is read into a fresh ConfigDict on every call (the JAX CLI merges
into the global ``cfg``).

Randomness is a function of the seed and the position in the run, so a run
stopped after an epoch and resumed gives the bits of an unbroken one: the
loader's order and the augmentations follow (seed, epoch, sample index), a
step's RoI sampling and dropout ``parallel.step_generator(seed, step, rank)``.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import logging
import time
from pathlib import Path

import numpy as np
import torch

# the arrays of a host batch that the model reads; metadata stays on the host
DEVICE_KEYS = ("points", "points_valid", "points1", "points1_valid",
               "gt_boxes", "gt_valid", "css_score")


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--cfg_file", required=True)
    p.add_argument("--batch_size", type=int, default=None,
                   help="global batch size (default: BATCH_SIZE_PER_GPU x ranks)")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--workers", type=int, default=4)
    p.add_argument("--extra_tag", default="default")
    p.add_argument("--ckpt", default=None)
    p.add_argument("--pretrained_model", default=None)
    p.add_argument("--fix_random_seed", action="store_true")
    p.add_argument("--seed", type=int, default=666)
    p.add_argument("--max_ckpt_save_num", type=int, default=30)
    p.add_argument("--output_dir", default=None)
    p.add_argument("--debug_steps", type=int, default=0,
                   help="stop after N optimizer steps (smoke runs)")
    p.add_argument("--log_every", type=int, default=20)
    p.add_argument("--eval_after", type=int, default=0,
                   help="evaluate the last N checkpoints after training (reference repeat_eval_ckpt)")
    p.add_argument("--device", default=None,
                   help="torch device to run on (default: the CUDA card)")
    p.add_argument("--set", dest="set_cfgs", nargs=argparse.REMAINDER, default=None)
    return p.parse_args(argv)


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


def global_batch_size(batch_size, per_gpu: int, world: int) -> int:
    """The global batch: ``batch_size`` as given, or ``per_gpu`` a rank;
    raises where the ranks cannot share it evenly."""
    batch_size = batch_size or per_gpu * world
    if batch_size % world:
        raise ValueError(f"the global batch {batch_size} does not divide over {world} ranks")
    return batch_size


def rank_logger(rank: int, world: int) -> logging.Logger:
    """Console logger of this rank's own lines, ``rank R/W ...``."""
    logger = logging.getLogger("cpd_tpu_torch.rank")
    logger.setLevel(logging.INFO)
    logger.propagate = False
    if not logger.handlers:
        logger.addHandler(logging.StreamHandler())
    logger.handlers[0].setFormatter(logging.Formatter(f"%(asctime)s  rank {rank}/{world}  "
                                                      f"%(message)s"))
    return logger


def state_checksum(model) -> str:
    """SHA-256 over the bytes of every parameter and buffer, in state-dict order."""
    h = hashlib.sha256()
    for k, v in model.state_dict().items():
        h.update(k.encode())
        h.update(v.detach().cpu().reshape(-1).contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def peak_memory(device):
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None


# tb entries that every rank holds alike; the others are the rank's shares
SHARED_TB = ("grad_norm", "skipped_nonfinite")


def main(argv=None, dataset=None):
    """Run the CLI on ``argv``; ``dataset`` replaces the one the config
    names. Returns the final ``parallel.TrainState``. Under ``torchrun`` it
    joins the process group (one the caller set up is kept) and leaves the
    group it joined at the end."""
    args = parse_args(argv)
    from ..parallel import comm

    owned = not comm.is_initialized()
    rank, world, device = comm.init_distributed(args.device)
    try:
        return _train(args, dataset, rank, world, device)
    finally:
        if owned:
            comm.shutdown()


def _train(args, dataset, rank, world, device):
    from ..config import ConfigDict, cfg_from_list, cfg_from_yaml_file
    from ..datasets import build_dataloader
    from ..models import build_network
    from ..parallel import comm, init_state, make_train_step, step_generator
    from ..utils.checkpoint import (auto_resume, list_checkpoints, load_checkpoint,
                                    load_params_from_file, save_checkpoint)
    from ..utils.common import MetricsLogger, PhaseTimer, create_logger, set_random_seed
    from ..utils.weights import seeded_state_dict

    cfg = cfg_from_yaml_file(args.cfg_file, ConfigDict())
    if args.set_cfgs:
        cfg_from_list(args.set_cfgs, cfg)

    batch_size = global_batch_size(args.batch_size, int(cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU),
                                   world)
    epochs = args.epochs or int(cfg.OPTIMIZATION.NUM_EPOCHS)

    out_dir = Path(args.output_dir or f"output/{cfg.TAG}/{args.extra_tag}")
    ckpt_dir = out_dir / "ckpt"
    out_dir.mkdir(parents=True, exist_ok=True)
    log_file = out_dir / "log_train.txt" if rank == 0 else None
    logger = create_logger(log_file, rank=rank)
    ranks = rank_logger(rank, world)
    logger.info(f"device: {device}  batch: {batch_size}  ranks: {world}  backend: "
                f"{comm.backend()}")
    ranks.info(f"device {device}, backend {comm.backend()}, {batch_size // world} samples a "
               f"step of the global {batch_size}")
    if args.fix_random_seed:
        set_random_seed(args.seed)

    train_set, train_loader, _ = build_dataloader(
        cfg.DATA_CONFIG, cfg.CLASS_NAMES, batch_size // world,
        root_path=cfg.DATA_CONFIG.get("DATA_PATH"), workers=args.workers,
        training=True, seed=args.seed, world_size=world, rank=rank, dataset=dataset,
    )
    logger.info(f"train samples: {len(train_set)}  steps/epoch: {len(train_loader)}")
    if len(train_set) == 0:
        raise SystemExit(
            f"dataset '{cfg.DATA_CONFIG.get('DATASET')}' is empty -- no processed "
            f"data under DATA_PATH={cfg.DATA_CONFIG.get('DATA_PATH')!r}. Build infos "
            "first or pass a dataset with samples."
        )

    model = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), cfg.DATA_CONFIG)
    model.load_state_dict(seeded_state_dict(model, args.seed), strict=True)
    total_steps = max(len(train_loader) * epochs, 1)
    state = init_state(model, cfg.OPTIMIZATION, total_steps, device=device)
    n_params = sum(p.numel() for p in model.parameters())
    logger.info(f"model params: {n_params / 1e6:.2f}M  optimizer: "
                f"{cfg.OPTIMIZATION.get('OPTIMIZER', 'adam_onecycle')}  total steps: {total_steps}")

    if args.pretrained_model:
        state = load_params_from_file(state, args.pretrained_model, logger)
    if args.ckpt:
        payload = load_checkpoint(args.ckpt, state)
        state.step = int(payload["it"])
        start_epoch = int(payload["epoch"]) + 1
    else:
        state, start_epoch = auto_resume(ckpt_dir, state)
        if start_epoch:
            logger.info(f"auto-resumed from epoch {start_epoch - 1}")

    train_step = make_train_step()
    metrics = MetricsLogger(out_dir) if rank == 0 else None
    timer = PhaseTimer()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    comm.take_collective_stats()
    stop = False
    for epoch in range(start_epoch, epochs):
        train_loader.set_epoch(epoch)
        if hasattr(train_set, "set_epoch"):
            train_set.set_epoch(epoch)
        t_epoch = time.time()
        steps = 0
        batches = iter(train_loader)
        try:
            for _ in range(len(train_loader)):
                with timer.phase("data"):
                    batch = next(batches)
                with timer.phase("h2d"):
                    db = device_batch(batch, device)
                with timer.phase("step"):
                    state, tb = train_step(state, db, step_generator(args.seed, state.step,
                                                                     device, rank))
                steps += 1
                it = state.step
                if it % args.log_every == 0 or args.debug_steps:
                    # the losses are this rank's shares: their sum is the global loss
                    tb_host = {k: float(v) for k, v in tb.items()}
                    tb_host.update(comm.reduce_dict(
                        {k: v for k, v in tb_host.items() if k not in SHARED_TB}, average=False))
                    logger.info(
                        f"epoch {epoch} it {it} " +
                        " ".join(f"{k}={v:.4f}" for k, v in sorted(tb_host.items()))
                    )
                    if metrics is not None:
                        metrics.log(it, tb_host)
                    ranks.info(f"step {it} " + json.dumps(dict(
                        train_step.trace, collectives=comm.take_collective_stats(),
                        step_ms=timer.last["step"] * 1e3,
                        total_loss_share=float(tb["total_loss"]))))
                if args.debug_steps and it >= args.debug_steps:
                    stop = True
                    break
        finally:
            batches.close()
        if rank == 0:
            save_checkpoint(ckpt_dir, state, epoch, args.max_ckpt_save_num)
        comm.synchronize()
        dt = time.time() - t_epoch
        means = {k: round(v, 6) for k, v in timer.summary().items()}
        logger.info(
            f"epoch {epoch} done in {dt:.1f}s ({steps} steps, {steps / max(dt, 1e-9):.3f} "
            f"steps/s); phase means: {means}"
        )
        ranks.info(f"epoch {epoch} " + json.dumps(dict(
            steps=steps, steps_per_s=steps / max(dt, 1e-9), means=means,
            peak_memory_bytes=peak_memory(device))))
        if stop:
            break
    if metrics is not None:
        metrics.close()
    checksum = state_checksum(state.model)
    ranks.info("state " + json.dumps(dict(step=state.step, checksum=checksum)))
    if len({str(c) for c in comm.all_gather_arrays(np.asarray(checksum))}) != 1:
        raise RuntimeError("the ranks' weights differ after training")
    logger.info("training complete")
    if args.eval_after:
        # reference behaviour: evaluate the last N epochs' checkpoints
        # (train.py:181-195 -> repeat_eval_ckpt), with this run's overrides,
        # on every rank
        from . import test as test_cli

        for ep, path in list_checkpoints(ckpt_dir)[-args.eval_after:]:
            create_logger(log_file, rank=rank).info(f"post-train eval of epoch {ep}")
            test_cli.main([
                "--cfg_file", args.cfg_file,
                "--output_dir", str(out_dir / f"eval_epoch_{ep}"),
                "--ckpt", str(path),
                "--workers", str(args.workers),
                "--device", str(device),
            ] + (["--set", *args.set_cfgs] if args.set_cfgs else []))
    return state


if __name__ == "__main__":
    main()
