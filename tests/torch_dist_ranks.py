"""Rank programs of the port's data-parallel CPU tests, and the launcher
that runs them: ``run_ranks`` spawns one process a rank (the ``spawn`` start
method), joins them in a gloo group through a ``file://`` store in a
temporary directory (no TCP port), runs one torch thread a rank, and waits
with a timeout. Every rank pickles what its program returns.

This module imports torch and the port, never JAX: each spawned rank
imports it afresh.
"""
from __future__ import annotations

import datetime
import pickle
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist


def _entry(rank, fn, world, tmp, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=120))
    try:
        out = fn(rank, world, Path(tmp), *args)
    finally:
        dist.destroy_process_group()
    with open(Path(tmp) / f"result_{rank}.pkl", "wb") as f:
        pickle.dump(out, f)


def start_ranks(fn, world, tmp, *args, timeout=300.0):
    """Start ``run_ranks``'s processes and return at once; calling what it
    returns waits for them and gives what ``run_ranks`` gives."""
    tmp = Path(tmp)
    tmp.mkdir(parents=True, exist_ok=True)
    ctx = torch.multiprocessing.start_processes(_entry, args=(fn, world, str(tmp), args),
                                                nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout

    def join():
        while not ctx.join(timeout=5.0):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                raise TimeoutError(f"{world} ranks still running after {timeout} s")
        if any(p.is_alive() for p in ctx.processes):
            raise AssertionError("a rank outlived its join")
        out = []
        for r in range(world):
            with open(tmp / f"result_{r}.pkl", "rb") as f:
                out.append(pickle.load(f))
        return out
    return join


def run_ranks(fn, world, tmp, *args, timeout=300.0):
    """[fn(rank, world, tmp, *args) for each rank], each run in its own
    process of a gloo group of ``world``; ``tmp`` must be a fresh directory.
    Raises a rank's exception, or TimeoutError (after killing the ranks)."""
    return start_ranks(fn, world, tmp, *args, timeout=timeout)()


# ------------------------------------------------------------------ rank programs

def norm_inputs(rank, kind):
    """This rank's seeded input, upstream gradient and (masked norm) valid
    rows; rank 1's batch of the masked norm has no valid row."""
    rng = np.random.default_rng([11, rank, int(kind == "2d")])
    if kind == "masked":
        x = rng.normal(0.5, 2.0, (2, 24, 6)).astype(np.float32)
        valid = rng.uniform(size=(2, 24)) < 0.7
        if rank == 1:
            valid[:] = False
        return x, rng.normal(size=x.shape).astype(np.float32), valid
    x = rng.normal(-0.3, 1.5, (2, 5, 4, 3)).astype(np.float32)
    return x, rng.normal(size=x.shape).astype(np.float32), None


def norm_step(norm, x, g, valid=None, device="cpu"):
    """One training forward + backward of ``norm`` on (x, upstream g) on
    ``device``: output, running statistics and the input, weight and bias
    gradients, as numpy arrays."""
    norm = norm.to(device)
    x = torch.from_numpy(x).to(device).requires_grad_()
    y = norm(x) if valid is None else norm(x, torch.from_numpy(valid).to(device))
    (y * torch.from_numpy(g).to(device)).sum().backward()
    host = lambda t: t.detach().cpu().numpy().copy()  # noqa: E731
    return {"y": host(y), "running_mean": host(norm.running_mean),
            "running_var": host(norm.running_var), "x_grad": host(x.grad),
            "weight_grad": host(norm.weight.grad), "bias_grad": host(norm.bias.grad)}


def make_norm(kind):
    from cpd_tpu_torch.models.norm import BatchNorm2d, MaskedBatchNorm
    torch.manual_seed(0)
    norm = MaskedBatchNorm(6) if kind == "masked" else BatchNorm2d(5)
    with torch.no_grad():
        norm.weight.uniform_(0.5, 1.5)
        norm.bias.uniform_(-0.2, 0.2)
    return norm.train()


def comm_and_norms(rank, world, tmp):
    """The comm names, ``all_reduce_sum``'s gradient and both norms on this
    rank's inputs."""
    from cpd_tpu_torch.parallel import comm
    out = {"rank": comm.get_rank(), "world": comm.get_world_size(), "backend": comm.backend()}
    comm.synchronize()
    out["gather"] = comm.all_gather_arrays(np.arange(3) + 10 * rank)
    out["average"] = comm.average_reduce_value(float(rank + 1))
    d = {"a": float(rank), "b": 2.0 + rank}
    out["mean"], out["sum"] = comm.reduce_dict(d), comm.reduce_dict(d, average=False)
    # 5 results over 2 ranks: rank 0 holds 0, 2, 4 and rank 1 holds 1, 3 and
    # a pad (0 again), as the eval sampler shards them
    shard = [i % 5 for i in range(rank, 6, world)]
    out["merged"] = comm.merge_results_dist([f"frame{i}" for i in shard], 5, tmp / "merge")
    out["broadcast"] = comm.broadcast_object({"from": rank})

    # all_reduce_sum: y = sum of every rank's x; rank r's loss is w_r . y
    x = torch.arange(4, dtype=torch.float64).add(rank).requires_grad_()
    y = comm.all_reduce_sum(x)
    (y * torch.full((4,), rank + 1.0, dtype=torch.float64)).sum().backward()
    out["reduce_y"], out["reduce_grad"] = y.detach().numpy(), x.grad.numpy()
    out["global_sum"] = float(comm.global_sum(torch.tensor(rank + 1.0)))

    for kind in ("masked", "2d"):
        out[kind] = norm_step(make_norm(kind), *norm_inputs(rank, kind))
    stats = comm.take_collective_stats()
    out["collective_calls"] = {k: v["calls"] for k, v in stats.items()}
    return out


def card_norms(rank, world, tmp):
    """``all_reduce_sum`` and MaskedBatchNorm on CUDA tensors of ranks that
    share the card (gloo stages them through the host)."""
    from cpd_tpu_torch.parallel import comm
    x = torch.arange(4, dtype=torch.float32, device="cuda").add(rank).requires_grad_()
    y = comm.all_reduce_sum(x)
    (y * (rank + 1.0)).sum().backward()
    return {"reduce_y": y.detach().cpu().numpy(), "reduce_grad": x.grad.cpu().numpy(),
            "masked": norm_step(make_norm("masked"), *norm_inputs(rank, "masked"),
                                device="cuda")}


def comm_norms_and_steps(rank, world, tmp, cases):
    """``comm_and_norms``, then one ``make_train_step`` step a case, on this
    rank's shard of the case's global batch: ``cases`` maps a name to (model
    kwargs, state dict, global batch of numpy arrays, f32?). Returns besides
    per case the rank's tb, its (summed) gradients, parameters and buffers
    after the step."""
    from cpd_tpu_torch.models.detector import VoxelRCNN, set_compute_dtype
    from cpd_tpu_torch.parallel import init_state, make_train_step, step_generator
    out = comm_and_norms(rank, world, tmp)
    for name, (kw, sd, batch, f32) in cases.items():
        model = VoxelRCNN(**kw)
        model.load_state_dict(sd, strict=True)
        if f32:
            set_compute_dtype(model, None)
        state = init_state(model, {"OPTIMIZER": "adam_onecycle", "LR": 0.003}, 100, device="cpu")
        n = len(batch["points"]) // world
        shard = {k: torch.from_numpy(np.ascontiguousarray(v[rank * n:(rank + 1) * n]))
                 for k, v in batch.items()}
        state, tb = make_train_step()(state, shard, step_generator(0, 0, "cpu", rank))
        out[name] = {
            "tb": {k: float(v) for k, v in tb.items()},
            "grads": {k: p.grad.numpy().copy() for k, p in model.named_parameters()
                      if p.grad is not None},
            "state": {k: v.numpy().copy() for k, v in model.state_dict().items()}}
    return out


def cli_runs(rank, world, tmp, argvs):
    """The training and evaluation CLIs in this rank's group: ``argvs`` is a
    list of (cli, argv), cli "train" or "test"; a call that raises records
    its exception's type and message instead. Torch's tensorboard writer is
    hidden (it imports TensorFlow and JAX where it is installed)."""
    import sys
    sys.modules["torch.utils.tensorboard"] = None
    from cpd_tpu_torch.tools import test as eval_cli
    from cpd_tpu_torch.tools import train as train_cli
    out = []
    for cli, argv in argvs:
        try:
            res = (train_cli if cli == "train" else eval_cli).main(argv)
        except (ValueError, RuntimeError) as e:
            out.append({"error": f"{type(e).__name__}: {e}"})
            continue
        if cli == "train":
            out.append({"step": res.step, "count": res.optimizer.count,
                        "checksum": train_cli.state_checksum(res.model)})
        else:
            out.append({"result": res})
    return out
