"""Evaluation CLI (port of tools/test.py; parity with reference tools/test.py
+ eval_utils).

    python -m cpd_tpu_torch.tools.test --cfg_file tools/cfgs/models/voxel_rcnn_cproto_center.yaml \
        --ckpt output/.../ckpt/checkpoint_epoch_20.pth [--device cpu] [--set KEY VALUE ...]

Evaluates one checkpoint (``--ckpt``) or polls a checkpoint directory for new
epochs (``--eval_all --ckpt_dir``, reference test.py:85 repeat_eval_ckpt);
with neither it evaluates weights drawn from a seed (a smoke run). Writes
``result.pkl`` (the detections) and ``log_eval.txt`` under ``--output_dir``
(default ``output/<cfg TAG>/<extra_tag>/eval``) and logs frames/s. The model
runs on the CUDA card; ``--device cpu`` asks for the CPU, and without a card
and without it the CLI raises. The config is read into a fresh ConfigDict on
every call (the JAX CLI merges into the global ``cfg``).

Under ``torchrun`` (``torchrun --nproc_per_node N -m cpd_tpu_torch.tools.test
...``) every rank predicts its shard of the frames (the loader's padded,
strided ``EvalDistributedSampler``); ``parallel.comm.merge_results_dist``
gathers the detections through ``<out>/tmpdir`` into dataset order on rank
0, which alone writes ``result.pkl`` and the log and computes the AP; the
frames/s line counts the frames of every rank. ``--batch_size`` is the global
batch (default ``BATCH_SIZE_PER_GPU`` times the ranks).
"""
from __future__ import annotations

import argparse
import pickle
import time
from pathlib import Path


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--cfg_file", required=True)
    p.add_argument("--batch_size", type=int, default=None,
                   help="global batch size (default: BATCH_SIZE_PER_GPU x ranks)")
    p.add_argument("--workers", type=int, default=4)
    p.add_argument("--extra_tag", default="default")
    p.add_argument("--ckpt", default=None)
    p.add_argument("--ckpt_dir", default=None)
    p.add_argument("--eval_all", action="store_true", help="poll + eval every new ckpt")
    p.add_argument("--max_waiting_mins", type=int, default=30)
    p.add_argument("--start_epoch", type=int, default=0)
    p.add_argument("--output_dir", default=None)
    p.add_argument("--test_iter", type=int, default=0, help="TTA transform index")
    p.add_argument("--debug_steps", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="torch device to run on (default: the CUDA card)")
    p.add_argument("--set", dest="set_cfgs", nargs=argparse.REMAINDER, default=None)
    return p.parse_args(argv)


def eval_one_checkpoint(model, loader, dataset, class_names, logger, out_dir,
                        debug_steps=0):
    """The eval loop (reference eval_utils.py:24): predict every batch of
    this rank's shard, merge the ranks' detections on rank 0, which writes
    result.pkl and scores it. Returns the result dict ({} on other ranks)."""
    from ..evaluation.ap import recall_stats
    from ..parallel import comm, make_eval_step
    from .train import device_batch

    eval_step = make_eval_step(model)
    device = next(model.parameters()).device
    det_annos = []
    t0 = time.time()
    n = 0
    for i, batch in enumerate(loader):
        preds = eval_step(device_batch(batch, device))
        preds = {k: v.cpu().numpy() for k, v in preds.items()}
        det_annos += dataset.generate_prediction_dicts(batch, preds, class_names)
        n += batch["batch_size"]
        if debug_steps and i + 1 >= debug_steps:
            break
    world = comm.get_world_size()
    if world > 1:
        det_annos = comm.merge_results_dist(det_annos, len(dataset), out_dir / "tmpdir")
        if comm.get_rank() != 0:
            return {}
        n = len(det_annos)
    dt = time.time() - t0
    logger.info(f"eval: {n} frames in {dt:.1f}s ({n / max(dt, 1e-6):.2f} f/s)"
                + (f" over {world} ranks" if world > 1 else ""))
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / "result.pkl", "wb") as f:
        pickle.dump(det_annos, f)
    result_str, result_dict = dataset.evaluation(det_annos, class_names)
    rec = recall_stats(det_annos, dataset.collect_gt_annos()[: len(det_annos)])
    result_dict.update(rec)
    logger.info("recall: " + " ".join(f"{k}={v:.4f}" for k, v in rec.items() if k != "gt_count"))
    logger.info("\n" + result_str)
    return result_dict


def main(argv=None, dataset=None, state=None):
    """Run the CLI on ``argv``. ``dataset`` replaces the one the config names;
    ``state``, a model, replaces the one ``build_network`` makes (it is moved
    to the device; checkpoints load into it). Returns the result dict (a dict
    of them by epoch with ``--eval_all``; {} on ranks other than 0). Under
    ``torchrun`` it joins the process group (one the caller set up, as the
    training CLI's ``--eval_after``, is kept) and leaves the group it joined
    at the end."""
    args = parse_args(argv)
    from ..parallel import comm

    owned = not comm.is_initialized()
    rank, world, device = comm.init_distributed(args.device)
    try:
        return _evaluate(args, dataset, state, rank, world, device)
    finally:
        if owned:
            comm.shutdown()


def _evaluate(args, dataset, state, rank, world, device):
    from ..config import ConfigDict, cfg_from_list, cfg_from_yaml_file
    from ..datasets import build_dataloader
    from ..datasets.registry import build_dataset
    from ..models import build_network
    from ..parallel import comm
    from ..utils.checkpoint import list_checkpoints, load_checkpoint
    from ..utils.common import create_logger
    from ..utils.device import place
    from ..utils.weights import seeded_state_dict
    from .train import global_batch_size

    cfg = cfg_from_yaml_file(args.cfg_file, ConfigDict())
    if args.set_cfgs:
        cfg_from_list(args.set_cfgs, cfg)

    batch_size = global_batch_size(args.batch_size, int(cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU),
                                   world)
    out_dir = Path(args.output_dir or f"output/{cfg.TAG}/{args.extra_tag}/eval")
    out_dir.mkdir(parents=True, exist_ok=True)
    logger = create_logger(out_dir / "log_eval.txt" if rank == 0 else None, rank=rank)
    if world > 1:
        logger.info(f"device: {device}  batch: {batch_size}  ranks: {world}  backend: "
                    f"{comm.backend()}")

    root_path = cfg.DATA_CONFIG.get("DATA_PATH")
    if dataset is None:
        dataset = build_dataset(cfg.DATA_CONFIG, cfg.CLASS_NAMES, False, root_path, logger,
                                test_iter=args.test_iter)
    test_set, test_loader, _ = build_dataloader(
        cfg.DATA_CONFIG, cfg.CLASS_NAMES, batch_size // world, root_path=root_path,
        workers=args.workers, training=False, world_size=world, rank=rank, dataset=dataset,
    )
    model = state
    if model is None:
        model = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), cfg.DATA_CONFIG)
        if not (args.ckpt or (args.eval_all and args.ckpt_dir)):
            # no checkpoint: weights drawn from a seed (a smoke run)
            model.load_state_dict(seeded_state_dict(model, 0), strict=True)
    model = place(model, device)

    def run(out):
        return eval_one_checkpoint(model, test_loader, test_set, cfg.CLASS_NAMES, logger, out,
                                   args.debug_steps)

    if args.ckpt:
        load_checkpoint(args.ckpt, model)
        return run(out_dir)
    if args.eval_all and args.ckpt_dir:
        evaluated = set()
        waited = 0.0
        results = {}
        while waited < args.max_waiting_mins * 60:
            # rank 0 decides which checkpoints are new, so every rank
            # evaluates the same ones in the same order
            fresh = comm.broadcast_object([c for c in list_checkpoints(args.ckpt_dir)
                                           if c[0] >= args.start_epoch and c[0] not in evaluated])
            if not fresh:
                time.sleep(30)
                waited += 30
                continue
            waited = 0.0
            for epoch, path in fresh:
                logger.info(f"evaluating epoch {epoch}")
                load_checkpoint(path, model)
                results[epoch] = run(out_dir / f"epoch_{epoch}")
                evaluated.add(epoch)
        return results
    return run(out_dir)


if __name__ == "__main__":
    main()
