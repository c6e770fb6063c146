"""Collectives over ``torch.distributed`` (port of cpd_tpu/parallel/comm.py).

The seven names of the JAX module, on a process group: outside one (a plain
``python`` run) they take the single-process paths, as the JAX module does on
one host. ``init_distributed`` joins the group that ``torchrun`` describes in
its environment. The sums that models and losses call (``all_reduce_sum``,
with a gradient, for the batch norms' moments; ``global_sum``, without, for
the losses' batch-wide counts) and their counters live in
``utils.collective`` and are named here too.

Data parallelism here keeps the JAX package's semantics: under ``pjit`` with
the batch axis sharded, a train step is the one-device step on the GLOBAL
batch. So every batch-norm moment and every batch-wide loss normaliser is
taken over all ranks, each rank's loss is its share of the global loss, and
the gradients of the shares are summed (``parallel.trainer``).

At world size 1 no collective runs.
"""
from __future__ import annotations

import datetime
import os
import pickle
from pathlib import Path
from typing import Any, Dict, List

import numpy as np
import torch
import torch.distributed as dist

from ..utils.collective import (COLLECTIVES, all_reduce_, all_reduce_sum,  # noqa: F401
                                get_rank, get_world_size, global_sum, is_initialized,
                                take_collective_stats)
from ..utils.device import resolve_device

# a hung collective raises after this long instead of waiting forever
TIMEOUT = datetime.timedelta(minutes=5)


def backend() -> str:
    """The process group's backend, or "none" outside one."""
    return str(dist.get_backend()) if is_initialized() else "none"


def synchronize():
    """Barrier across ranks (commu_utils.synchronize parity)."""
    if get_world_size() > 1:
        dist.barrier()


def placement(device_arg, local_rank: int, local_world: int, n_cards: int):
    """(backend, device) of one local rank. ``--device cpu``: gloo on the
    CPU. Otherwise the card: nccl on ``cuda:local_rank`` when each local rank
    has a card of its own; gloo when local ranks share cards (NCCL refuses two
    ranks on one device), on ``cuda:local_rank % n_cards``. Raises without a
    card."""
    if device_arg is not None:
        kind = torch.device(device_arg).type
        if kind == "cpu":
            return "gloo", torch.device("cpu")
        if kind != "cuda":
            raise ValueError(f"data-parallel ranks run on the CPU or CUDA cards, not {device_arg}")
    if n_cards == 0:
        raise RuntimeError("no CUDA card found: pass device='cpu' to run on the CPU")
    if local_world <= n_cards:
        return "nccl", torch.device("cuda", local_rank)
    return "gloo", torch.device("cuda", local_rank % n_cards)


def init_distributed(device_arg=None):
    """-> (rank, world, device). Under ``torchrun`` (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE`` in the environment) join its process
    group with the backend and device of ``placement``, at every world size;
    a group the caller already set up is kept. A group it sets up runs a
    barrier before it returns. Without either, one process:
    ``(0, 1, resolve_device(device_arg))`` and no group."""
    if not is_initialized() and "RANK" not in os.environ:
        return 0, 1, resolve_device(device_arg)
    if is_initialized():
        rank, world = dist.get_rank(), dist.get_world_size()
    else:
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    name, device = placement(device_arg, local_rank, local_world, n_cards)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if not is_initialized():
        dist.init_process_group(name, init_method="env://", rank=rank, world_size=world,
                                timeout=TIMEOUT)
        # a first collective, so that a group that cannot work (NCCL refuses
        # two ranks on one card) fails here, at every world size
        dist.barrier(**({"device_ids": [device.index]} if name == "nccl" else {}))
    return rank, world, device


def shutdown():
    """Leave the process group, if there is one."""
    if is_initialized():
        dist.destroy_process_group()


def broadcast_object(obj):
    """Rank 0's ``obj`` on every rank (pickled); ``obj`` itself in one process."""
    if get_world_size() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def all_gather_arrays(x: np.ndarray) -> List[np.ndarray]:
    """Gather a host array from every rank, in rank order."""
    if get_world_size() == 1:
        return [np.asarray(x)]
    out: List[Any] = [None] * get_world_size()
    dist.all_gather_object(out, np.asarray(x))
    return out


def average_reduce_value(v: float) -> float:
    """Mean of a scalar across ranks (commu_utils.average_reduce_value)."""
    vals = all_gather_arrays(np.asarray([v], np.float64))
    return float(np.mean([x[0] for x in vals]))


def reduce_dict(d: Dict[str, float], average: bool = True) -> Dict[str, float]:
    """Mean (or sum) of each value across ranks; every rank gets the result."""
    keys = sorted(d)
    vec = np.asarray([float(d[k]) for k in keys], np.float64)
    parts = all_gather_arrays(vec)
    agg = np.mean(parts, axis=0) if average else np.sum(parts, axis=0)
    return dict(zip(keys, agg.tolist()))


def merge_results_dist(part_list: List[Any], size: int, tmpdir) -> List[Any]:
    """Merge every rank's list of results through ``tmpdir`` (common_utils.py:
    175 parity): a pickle a rank, a barrier, then rank 0 interleaves the
    parts round-robin (the eval sampler strides the dataset over the ranks,
    so this is dataset order) and truncates the padding to ``size``. Other
    ranks get []."""
    rank, world = get_rank(), get_world_size()
    tmpdir = Path(tmpdir)
    tmpdir.mkdir(parents=True, exist_ok=True)
    with open(tmpdir / f"result_part_{rank}.pkl", "wb") as f:
        pickle.dump(part_list, f)
    synchronize()
    if rank != 0:
        return []
    parts = []
    for r in range(world):
        with open(tmpdir / f"result_part_{r}.pkl", "rb") as f:
            parts.append(pickle.load(f))
    merged: List[Any] = []
    for i in range(max(len(x) for x in parts)):
        for r in range(world):
            if i < len(parts[r]):
                merged.append(parts[r][i])
    return merged[:size]
