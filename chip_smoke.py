"""Smoke run of the PyTorch port on one CUDA card (an NVIDIA H100).

    python3 chip_smoke.py

Drives the port's two main paths at the bench configuration of the JAX
package (bench.py: 3 classes, range +-75.2 x [-2, 4] m, voxels (0.1, 0.1,
0.15) m, grid 1504 x 1504 x 41, voxel cap 90k, stage caps (80k, 48k, 24k,
20k), 200 test RoIs, sparse backbone tail) on 200k-point synthetic lidar
frames, with weights drawn from a seed:
``cpd_tpu_torch.models.detector.VoxelRCNN.predict`` (batch 1, MM branch off)
and the training step of ``cpd_tpu_torch.parallel`` (``VoxelRCNN.loss_step``
with ``mm=True``, batch 2, 64 label slots, backward, clip, adam_onecycle).
Phases, each raising on failure:

1. card: needs CUDA; prints the card's name and power limit;
2. build: compiles kernels A1 (csrc/gather_gemm.cu) and A2
   (csrc/gather_gemm_dw.cu) with nvcc for sm_90a, one process each;
3. kernel A1 against its plain PyTorch version on the (table, idx, found, W)
   of each of the 21 launches of one forward, recorded at the wrapper: f32
   within atol/rtol 1e-4 (TF32 off), bf16 (the main path's dtype) within
   rtol 1e-2 + 1e-2 of the layer's output scale; median kernel and plain
   times per layer shape;
4. predict path: cap-occupancy audit, A1 launch count (21 per forward), 2
   warm-ups then 5 timed predicts (frames/s median/min/max), peak memory,
   finite outputs, a per-stage time breakdown, and a torch.profiler window
   (device busy time and idle share per predict, and the top kernels);
5. a small-input check: the same weights on the CPU (plain kernel versions)
   and on the card agree within the bf16 tier;
6. the kernels of one training step on their real operands, recorded from a
   forward + backward: A1 forward (35 convs), A1 as dX (33) and A2 (35)
   against their plain versions, f32 (1e-4 of the output's scale: A2 sums
   up to 180,000 rows in another order) and bf16; times per layer shape;
7. training path, every step through ``make_train_step``: the launch counts
   of the first step (A1 35 forward + 33 dX, A2 35; the forward's share is
   read where that step's ``loss_step`` returns), a second warm-up, then 5
   timed steps (ms per step median/min/max, and the phases forward, backward,
   clip + update between CUDA events of those same steps), peak memory,
   finite losses with ``proto_loss`` among them, no skipped step, parameters
   of both branches moved, and a torch.profiler window of a step;
8. a small training step on the CPU and on the card, same weights, proposals
   and sampling uniforms: at f32 the losses agree to 1e-3 and the gradients
   to a cosine of 0.999; at bf16 (the main path's dtype) within a loose tier.

The last two lines of stdout are the card line and a JSON object; the line
before them is the kernels JSON. For each kernel use it gives the launches
of its path's counted run, the summed medians of the kernel and of its plain
version over those launches, and ``bound_ms``: the least time the card could
take for the same launches, per launch the larger of bytes / 3.35 TB/s (each
operand read once, the output written once) and found-tap operations /
989 TFLOP/s (bf16 tensor cores), from this run's operands. No single PyTorch
call computes a gather-GEMM, so ``library_ms`` is null.
"""
import json
import math
import statistics
import subprocess
import time

import numpy as np
import torch

from cpd_tpu_torch.models.backbone3d import build_branch_rulebooks, stage_grids
from cpd_tpu_torch.models.bev import height_compression
from cpd_tpu_torch.models.detector import VoxelRCNN, keys_from_frame
from cpd_tpu_torch.ops import gather_gemm as a1
from cpd_tpu_torch.ops import sparse
from cpd_tpu_torch.ops.voxelizer import voxelize_batch
from cpd_tpu_torch.parallel import init_state, make_train_step
from cpd_tpu_torch.utils.synthetic import (make_lidar_frame, make_tiny_train_batch,
                                           make_train_batch)
from cpd_tpu_torch.utils.weights import seeded_state_dict

BENCH = dict(
    num_classes=3,
    point_cloud_range=(-75.2, -75.2, -2.0, 75.2, 75.2, 4.0),
    voxel_size=(0.1, 0.1, 0.15),
    max_voxels=90_000,
    backbone_caps=(80_000, 48_000, 24_000, 20_000),
    mm=False,
    num_rois=500,
    num_rois_test=200,
    roi_per_image=130,
    dense_tail=False,
)
SMALL = dict(num_classes=3, point_cloud_range=(-8.0, -8.0, -2.0, 8.0, 8.0, 4.0),
             voxel_size=(0.5, 0.5, 0.15), max_voxels=1024,
             backbone_caps=(512, 256, 128, 128), num_rois_test=16,
             rpn_nms={"NMS_THRESH": 0.8, "NMS_PRE_MAXSIZE": 256})
N_POINTS = 200_000
TIMED_LOOPS = 5
A1_PER_FORWARD = 21
# one training step at mm=True: branch 0 has 21 sparse convs, the light branch
# 1 has 14 (one block at stages 2-4, no conv_out); every conv has a dW, and
# every conv but the two conv_input (voxel features are data) a dX
TRAIN_A1_FORWARD, TRAIN_A1_DX, TRAIN_A2 = 35, 33, 35
TRAIN_BATCH = 2
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
OPT_CFG = {"OPTIMIZER": "adam_onecycle", "LR": 0.003, "WEIGHT_DECAY": 1e-5,
           "GRAD_NORM_CLIP": 32}


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


def seeded_model(cfg, seed, device):
    model = VoxelRCNN(**cfg)
    model.load_state_dict(seeded_state_dict(model, seed), strict=True)
    return model.eval().to(device)


def paired_median_ms(fn_a, fn_b, reps=5):
    """Median single-call device times (CUDA events) of two versions, run in
    turns (a b, b a, ...) after a warm-up of each."""
    fn_a()
    fn_b()
    times = ([], [])
    for r in range(reps):
        for i in ((0, 1) if r % 2 == 0 else (1, 0)):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            (fn_a, fn_b)[i]()
            end.record()
            end.synchronize()
            times[i].append(start.elapsed_time(end))
    return statistics.median(times[0]), statistics.median(times[1])


def launch_bound(operands, out_numel, out_bytes_per_elem):
    """The least a launch on these operands could cost the card: (bytes,
    operations, milliseconds, which limit). Every operand is read once and
    the output written once at the card's memory rate; each found tap costs
    2 * Cin * Cout operations at its bf16 tensor-core rate; the bound is the
    larger of the two times."""
    table, idx, found, other = operands
    nbytes = sum(t.numel() * t.element_size() for t in operands) + out_numel * out_bytes_per_elem
    ops = 2.0 * float(found.sum()) * table.shape[-1] * other.shape[-1]
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / BF16_FLOPS * 1e3
    return nbytes, ops, max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def check_kernel(label, calls, kernel, plain, out_dtype):
    """One kernel use against its plain version on each recorded call's bf16
    operands ``(name, table, idx, found, other)``: in f32 (the kernel's
    arithmetic; TF32 is off) within 1e-4 of the output's scale plus rtol 1e-4,
    and in bf16 as the main path runs it, against the plain version's f32
    result, within rtol 1e-2 + 1e-2 of the output's scale; a second launch
    must give the same bits (no atomics in either kernel). ``kernel`` and
    ``plain`` take (table, idx, found, other, out_dtype). Returns the largest
    bf16 error and, per layer shape, the median times and the bound."""
    max_err = 0.0
    shapes = {}
    for name, table, idx, found, other in calls:
        t32, o32 = table.float(), other.float()
        out = kernel(t32, idx, found, o32, torch.float32)
        ref = plain(t32, idx, found, o32, torch.float32)
        torch.cuda.synchronize()
        scale = max(ref.abs().max().item(), 1e-3)
        err32 = (out - ref).abs()
        if not bool((err32 <= 1e-4 * ref.abs() + 1e-4 * scale).all()):
            raise AssertionError(f"{label} f32 mismatch at {name}: max err "
                                 f"{err32.max().item()} at output scale {scale}")
        out = kernel(table, idx, found, other, out_dtype)
        if not torch.equal(out, kernel(table, idx, found, other, out_dtype)):
            raise AssertionError(f"{label} at {name}: two launches gave different bits")
        out = out.float()
        ref = plain(table, idx, found, other, torch.float32)
        torch.cuda.synchronize()
        err = (out - ref).abs()
        if not bool((err <= 1e-2 * ref.abs() + 1e-2 * scale).all()):
            raise AssertionError(f"{label} bf16 mismatch at {name}: max err {err.max().item()}")
        max_err = max(max_err, err.max().item())
        b, n, k = idx.shape
        key = (b, n, k, table.shape[-1], other.shape[-1])
        if key not in shapes:
            ms, plain_ms = paired_median_ms(
                lambda: kernel(table, idx, found, other, out_dtype),
                lambda: plain(table, idx, found, other, out_dtype))
            shapes[key] = dict(layer=name, batch=b, rows=n, taps=k, cin=table.shape[-1],
                               cout=other.shape[-1], ms=ms, plain_ms=plain_ms, count=0,
                               bound_ms=0.0, bound_by={}, nbytes=0.0, ops=0.0)
        entry = shapes[key]
        entry["count"] += 1
        nbytes, ops, lim, by = launch_bound((table, idx, found, other), out.numel(),
                                            torch.empty(0, dtype=out_dtype).element_size())
        entry["nbytes"] += nbytes
        entry["ops"] += ops
        entry["bound_ms"] += lim
        entry["bound_by"][by] = entry["bound_by"].get(by, 0.0) + lim
        print(f"{label} {name}: B={b} N={n} K={k} C={table.shape[-1]}->{other.shape[-1]} "
              f"found={found.float().mean().item():.3f} f32 max err {err32.max().item():.3e}, "
              f"bf16 max err {err.max().item():.3e} (output scale {scale:.3e})")
    for e in shapes.values():
        print(f"{label} shape {e['layer']} x{e['count']}: B={e['batch']} N={e['rows']} "
              f"K={e['taps']} C={e['cin']}->{e['cout']}: kernel {e['ms']:.4f} ms, plain "
              f"{e['plain_ms']:.4f} ms (medians of 5, run in turns, bf16), bound "
              f"{e['bound_ms'] / e['count']:.5f} ms a launch by {'/'.join(e['bound_by'])} "
              f"({e['nbytes'] / e['count'] / 1e6:.2f} MB, "
              f"{e['ops'] / e['count'] / 1e9:.3f} GFLOP on found taps)")
    return max_err, list(shapes.values())


def kernel_entry(name, path, source, replaces, launches, max_err, shape_times):
    """One entry of the kernels line: times summed over the path's launches."""
    by = {}
    for e in shape_times:
        for k, v in e["bound_by"].items():
            by[k] = by.get(k, 0.0) + v
    return {"name": name, "path": path, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": max_err,
            "ms": sum(e["ms"] * e["count"] for e in shape_times),
            "plain_ms": sum(e["plain_ms"] * e["count"] for e in shape_times),
            "bound_ms": sum(e["bound_ms"] for e in shape_times),
            "bound_by": max(by, key=by.get), "library_ms": None}


def a1_kernel(table, idx, found, w, out_dtype):
    return a1.gather_gemm(table, idx, found, w, out_dtype)


def a1_plain(table, idx, found, w, out_dtype):
    return a1.gather_gemm_reference(table, idx, found, w, out_dtype)


def a2_kernel(table, idx, found, g_out, out_dtype):
    return a1.gather_gemm_dw(table, idx, found, g_out)


def a2_plain(table, idx, found, g_out, out_dtype):
    return a1.gather_gemm_dw_reference(table, idx, found, g_out)


def cap_audit(model, batch):
    frame = voxelize_batch(batch["points"], model.vox_spec, batch["points_valid"])
    keys = keys_from_frame(frame, model.grid)
    rbs = build_branch_rulebooks(keys, model.grid, model.backbone.caps)
    occ = {"stage0": (int(frame.valid.sum(-1).max()), model.vox_spec.max_voxels)}
    for name, cap in zip(("down2", "down3", "down4", "conv_out"), model.backbone.caps):
        occ[name] = (int(rbs[name].out_valid.sum(-1).max()), cap)
    print(f"stage occupancy / cap: {occ}")
    for name, (n, cap) in occ.items():
        if n >= cap:
            raise AssertionError(f"cap saturated at {name}: {n}/{cap}")


def stage_breakdown(model, batch):
    """Host-clock milliseconds per stage of one forward, synchronising after each."""
    times = {}
    state = {}

    def step(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state[name] = fn()
        torch.cuda.synchronize()
        times[name] = (time.perf_counter() - t0) * 1e3

    with torch.no_grad():
        step("voxelize", lambda: voxelize_batch(batch["points"], model.vox_spec,
                                                batch["points_valid"]))
        keys = keys_from_frame(state["voxelize"], model.grid)
        step("rulebooks", lambda: build_branch_rulebooks(keys, model.grid, model.backbone.caps))
        step("sparse_convs", lambda: model.backbone.branch0(state["voxelize"].features,
                                                            state["rulebooks"]))
        grids = stage_grids(model.grid)
        backbone_out = {k: (f, ky, grids[k]) for k, (f, ky) in state["sparse_convs"].items()}
        step("bev", lambda: model.bev_backbone(height_compression(*backbone_out["encoded"])))
        step("dense_head", lambda: model.dense_head(state["bev"]))
        rpn = dict(model.rpn_nms, NMS_POST_MAXSIZE=model.num_rois_test)
        step("proposals", lambda: model.dense_head.generate_predicted_boxes(
            state["dense_head"], k=500, score_thresh=0.1, nms_cfg=rpn,
            post_max_size=model.num_rois_test))
        step("roi_head", lambda: model.roi_head(state["proposals"], backbone_out))
        step("post_nms", lambda: model.post_processing(state["roi_head"]))
    return times


def device_profile(fn, what, unprofiled_ms, loops=3):
    """torch.profiler over ``loops`` calls of ``fn`` (a predict or a training
    step): device busy ms per call (the union of kernel intervals), the idle
    share against the unprofiled ``unprofiled_ms``, device ops per call, and
    the top kernels. Returns (busy ms, idle share)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(loops):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / loops
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, cur_s, cur_e = 0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            busy += 0 if cur_e is None else cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy = (busy + (0 if cur_e is None else cur_e - cur_s)) / 1e3 / loops
    kernels = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernels[e.name] = kernels.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / loops
    idle = 1 - busy / unprofiled_ms
    print(f"profile: {wall:.2f} ms per {what} under the profiler, device busy {busy:.2f} ms "
          f"per {what}, idle share {idle:.3f} of the unprofiled "
          f"{unprofiled_ms:.2f} ms, {len(spans) // loops} device ops per {what}")
    for name, ms in sorted(kernels.items(), key=lambda kv: -kv[1])[:8]:
        print(f"  {ms:8.3f} ms  {name[:100]}")
    return busy, idle


def small_input_check():
    """Port on the CPU (plain versions) vs on the card, same seeded weights."""
    rng = np.random.default_rng(1)
    pts = np.concatenate([rng.uniform(-8, 8, (2, 1024, 2)), rng.uniform(-2, 4, (2, 1024, 1)),
                          rng.uniform(0, 1, (2, 1024, 2))], -1).astype(np.float32)
    outs = []
    for device in ("cpu", "cuda"):
        model = seeded_model(SMALL, 3, device)
        batch = {"points": torch.from_numpy(pts).to(device),
                 "points_valid": torch.ones(2, 1024, dtype=torch.bool, device=device)}
        with torch.no_grad():
            out = model(batch)
        outs.append({k: out["backbone_out"][k][0].float().cpu()
                     for k in ("x_conv1", "encoded")} | {"hm": out["head_preds"]["hm"].cpu()})
    for k, ref in outs[0].items():
        err = (outs[1][k] - ref).abs().max().item()
        scale = max(ref.abs().max().item(), 1e-3)
        print(f"small input, card vs CPU {k}: max err {err:.3e} (scale {scale:.3e})")
        if err > 0.03 * scale:
            raise AssertionError(f"card and CPU disagree at {k}: {err} vs scale {scale}")


def to_device(batch, device):
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def training_proposals(model, batch):
    """The proposals of a training-mode forward (batch statistics, score
    threshold 0, ``num_rois`` of them), under no_grad."""
    model.train()
    with torch.no_grad():
        frame = voxelize_batch(batch["points"], model.vox_spec, batch["points_valid"])
        backbone_out = model.backbone(frame.features, keys_from_frame(frame, model.grid))
        preds = model.dense_head(model.bev_backbone(height_compression(*backbone_out["encoded"])))
        return model.dense_head.generate_predicted_boxes(
            preds, k=500, score_thresh=0.0,
            nms_cfg=dict(model.rpn_nms, NMS_POST_MAXSIZE=model.num_rois),
            post_max_size=model.num_rois)


def labels_on_proposals(model, batch, n_labelled):
    """Put the first ``n_labelled`` label boxes of each sample on proposals
    of the model's own training-mode forward (every k-th valid one whose
    sides are between 0.3 and 12 m, shifted by 3% of its size and 5% larger
    or smaller, with the proposal's class), so that the RoI sampling
    finds foreground and the regression, corner and proto terms are live:
    random labels would match no proposal of a randomly weighted model.
    A label is never left exactly on its proposal: the dense head's L1
    terms would sit on their kink, where the sign of the gradient is
    rounding noise. The forward moves the batch-norm running statistics
    once; the batch statistics, and so the proposals of the next step, are
    not affected."""
    props = training_proposals(model, batch)
    gt, gt_valid = batch["gt_boxes"].clone(), batch["gt_valid"].clone()
    matched = []
    for b in range(gt.shape[0]):
        dims = props["rois"][b, :, 3:6]
        sane = props["roi_valid"][b] & (dims.amin(-1) > 0.3) & (dims.amax(-1) < 12.0)
        cand = torch.nonzero(sane)[:, 0]
        cand = cand[::max(1, len(cand) // n_labelled)][:n_labelled]
        rois = props["rois"][b, cand]
        sign = torch.where(torch.arange(rois.shape[0] * 3, device=rois.device) % 2 == 0, 1.0, -1.0)
        gt[b, :len(cand), :7] = rois
        gt[b, :len(cand), 0:3] += 0.03 * rois[:, 3:6] * sign.reshape(-1, 3)
        gt[b, :len(cand), 3:6] *= 1.0 - 0.05 * sign.reshape(-1, 3)
        gt[b, :len(cand), 7] = props["roi_labels"][b, cand].to(gt.dtype)
        gt_valid[b, :len(cand)] = True
        matched.append(len(cand))
    return dict(batch, gt_boxes=gt, gt_valid=gt_valid), matched


class KernelRecorder:
    """Records the operands of every launch that the sparse convs make while
    it is active, as the wrappers receive them: A1 in the forward, A1 as dX
    and A2 in the backward (calls made after ``in_backward`` is set)."""

    def __init__(self):
        self.calls = {"forward": [], "dx": [], "dw": []}
        self.in_backward = False

    def __enter__(self):
        self.saved = (sparse.gather_gemm, sparse.gather_gemm_dw)

        def gather_gemm(table, idx, found, w_flat, out_dtype=torch.float32):
            kind = "dx" if self.in_backward else "forward"
            self.calls[kind].append((f"{kind}[{len(self.calls[kind])}]", table, idx, found, w_flat))
            return self.saved[0](table, idx, found, w_flat, out_dtype)

        def gather_gemm_dw(table, idx, found, g_out):
            self.calls["dw"].append((f"dw[{len(self.calls['dw'])}]", table, idx, found, g_out))
            return self.saved[1](table, idx, found, g_out)

        sparse.gather_gemm, sparse.gather_gemm_dw = gather_gemm, gather_gemm_dw
        return self

    def __exit__(self, *exc):
        sparse.gather_gemm, sparse.gather_gemm_dw = self.saved


def train_kernel_checks(model, batch, generator):
    """Record one forward + backward's kernel operands and hold every kernel
    use against its plain version on them. Returns {use: (max err, shapes)}."""
    model.train()
    with KernelRecorder() as rec:
        loss, _ = model.loss_step(batch, generator=generator)
        rec.in_backward = True
        loss.backward()
    torch.cuda.synchronize()
    model.zero_grad(set_to_none=True)
    counts = {k: len(v) for k, v in rec.calls.items()}
    want = {"forward": TRAIN_A1_FORWARD, "dx": TRAIN_A1_DX, "dw": TRAIN_A2}
    if counts != want:
        raise AssertionError(f"recorded kernel calls {counts}, want {want}")
    bf16 = torch.bfloat16
    return {"forward": check_kernel("A1 train forward", rec.calls["forward"], a1_kernel,
                                    a1_plain, bf16),
            "dx": check_kernel("A1 as dX", rec.calls["dx"], a1_kernel, a1_plain, bf16),
            "dw": check_kernel("A2", rec.calls["dw"], a2_kernel, a2_plain, torch.float32)}


def cuda_event():
    event = torch.cuda.Event(enable_timing=True)
    event.record()
    return event


class StepMarks:
    """Reads the trainer's own steps from inside: while it is active, every
    ``train_step(state, ...)`` records CUDA events (no synchronisation) where
    its ``loss_step`` starts and returns and where its optimizer step starts
    and returns, and the A1 and A2 launch counts where ``loss_step`` returns
    (the forward's share of the step's launches). One row per step."""

    def __init__(self, state):
        self.model, self.optimizer = state.model, state.optimizer
        self.rows = []

    def __enter__(self):
        loss_step, opt_step = self.model.loss_step, self.optimizer.step

        def marked_loss_step(*args, **kwargs):
            row = {"events": [cuda_event()]}
            self.rows.append(row)
            out = loss_step(*args, **kwargs)
            row["forward_launches"] = (a1.gather_gemm.launches, a1.gather_gemm_dw.launches)
            row["events"].append(cuda_event())
            return out

        def marked_opt_step(*args, **kwargs):
            self.rows[-1]["events"].append(cuda_event())
            out = opt_step(*args, **kwargs)
            self.rows[-1]["events"].append(cuda_event())
            return out

        self.model.loss_step, self.optimizer.step = marked_loss_step, marked_opt_step
        return self

    def __exit__(self, *exc):
        del self.model.loss_step, self.optimizer.step  # back to the classes' methods

    def phase_ms(self, rows):
        """Median device-timeline ms of forward + loss, backward, clip + update."""
        names = ("forward", "backward", "clip+update")
        return {n: statistics.median(r["events"][i].elapsed_time(r["events"][i + 1])
                                     for r in rows) for i, n in enumerate(names)}


def training_phase(dev):
    """The training path at full width. Returns the kernels-line entries of
    its three kernel uses."""
    cfg = dict(BENCH, mm=True)
    model = VoxelRCNN(**cfg)
    model.load_state_dict(seeded_state_dict(model, 0), strict=True)
    state = init_state(model, OPT_CFG, total_steps=100, device=dev)
    batch = to_device(make_train_batch(0, TRAIN_BATCH, N_POINTS), dev)
    batch, matched = labels_on_proposals(model, batch, n_labelled=40)
    print(f"training batch: {TRAIN_BATCH} frames of {N_POINTS} points, {batch['gt_boxes'].shape[1]} "
          f"label slots, {matched} labels a sample placed on proposals")
    generator = torch.Generator(device=dev).manual_seed(0)

    checks = train_kernel_checks(model, batch, generator)

    # the main path: the trainer's steps, the first counted from zero
    train_step = make_train_step()
    watched = {"branch0": model.backbone.branch0.res3a.conv1.weight,
               "branch1": model.backbone.branch1.res3a.conv1.weight,
               "tower1": model.roi_head.reg_tower1.fc0.weight}
    before = {k: v.detach().clone() for k, v in watched.items()}
    with StepMarks(state) as marks:
        a1.gather_gemm.launches = a1.gather_gemm_dw.launches = 0
        state, tb = train_step(state, batch, generator)
        torch.cuda.synchronize()
        a1_total, a2_launches = a1.gather_gemm.launches, a1.gather_gemm_dw.launches
        forward_launches, a2_in_forward = marks.rows[0]["forward_launches"]
        got = (forward_launches, a1_total - forward_launches, a2_launches, a2_in_forward)
        if got != (TRAIN_A1_FORWARD, TRAIN_A1_DX, TRAIN_A2, 0):
            raise AssertionError(f"the train step launched (A1 forward, A1 dX, A2, A2 in the "
                                 f"forward) = {got}, want "
                                 f"{(TRAIN_A1_FORWARD, TRAIN_A1_DX, TRAIN_A2, 0)}")
        first_loss = float(tb["total_loss"])
        print("first tb: " + ", ".join(f"{k} {float(v):.4f}" for k, v in tb.items()))
        if not float(tb["rcnn_reg0"]) > 0:
            raise AssertionError("no foreground RoI in the first step: the regression, corner "
                                 "and proto box terms were not exercised")
        state, tb = train_step(state, batch, generator)  # second warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step_s, skipped = [], 0.0
        for _ in range(TIMED_LOOPS):
            t0 = time.perf_counter()
            state, tb = train_step(state, batch, generator)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            skipped += float(tb["skipped_nonfinite"])
            bad = [k for k, v in tb.items() if not math.isfinite(float(v))]
            if bad:
                raise AssertionError(f"non-finite tb entries after step {state.step}: {bad}")
        peak = torch.cuda.max_memory_allocated()
        phases = marks.phase_ms(marks.rows[-TIMED_LOOPS:])
    if "proto_loss" not in tb or skipped:
        raise AssertionError(f"proto_loss in tb: {'proto_loss' in tb}; skipped steps: {skipped}")
    if state.step != 2 + TIMED_LOOPS or state.optimizer.count != state.step:
        raise AssertionError(f"step counter {state.step}, optimizer count {state.optimizer.count}")
    for k, v in watched.items():
        if torch.equal(before[k], v.detach()):
            raise AssertionError(f"parameters of {k} did not move")
    ms = sorted(s * 1e3 for s in step_s)
    print(f"train step ms over {TIMED_LOOPS} steps (forward, backward, clip, update): median "
          f"{statistics.median(ms):.2f} min {ms[0]:.2f} max {ms[-1]:.2f}; peak memory "
          f"{peak / 2**30:.2f} GiB; total loss first {first_loss:.4f} last "
          f"{float(tb['total_loss']):.4f}; grad norm {float(tb['grad_norm']):.2f}")
    print("last tb: " + ", ".join(f"{k} {float(v):.4f}" for k, v in tb.items()))
    print(f"train step phases ms (between CUDA events of the {TIMED_LOOPS} timed steps, medians): "
          + ", ".join(f"{k} {v:.2f}" for k, v in phases.items()))
    device_profile(lambda: train_step(state, batch, generator), "train step",
                   statistics.median(ms), loops=2)

    src1, src2 = "cpd_tpu_torch/csrc/gather_gemm.cu", "cpd_tpu_torch/csrc/gather_gemm_dw.cu"
    return [
        kernel_entry("gather_gemm", "train step, forward", src1, "cpd_tpu/ops/pallas_conv.py:77",
                     forward_launches, *checks["forward"]),
        kernel_entry("gather_gemm (dX)", "train step, backward", src1,
                     "cpd_tpu/ops/pallas_conv.py:77", a1_total - forward_launches, *checks["dx"]),
        kernel_entry("gather_gemm_dw", "train step, backward", src2,
                     "cpd_tpu/ops/pallas_conv.py:130", a2_launches, *checks["dw"]),
    ]


def set_compute_dtype(model, dtype):
    """Every module of the model that computes in a ``compute_dtype`` (sparse
    convs, BEV and head convs, the RoI MLPs and towers) to ``dtype``."""
    for m in model.modules():
        if hasattr(m, "compute_dtype"):
            m.compute_dtype = dtype
    return model


# gates of small_train_check per compute dtype: relative tb error (+ 1e-3 of
# slack at f32, 1e-2 at bf16), the dense-head entries' own, and per loss the
# least cosine and the widest norm ratio between the card's and the CPU's
# gradient
SMALL_TRAIN_GATES = {
    torch.float32: dict(tb=1e-3, tb_dense=1e-3, slack=1e-3, cosine={"RoI-head": 0.999,
                                                                   "dense-head": 0.999},
                        ratio=(0.98, 1.02)),
    torch.bfloat16: dict(tb=0.10, tb_dense=0.20, slack=1e-2, cosine={"RoI-head": 0.9,
                                                                    "dense-head": 0.3},
                         ratio=(0.5, 2.0)),
}


def small_train_check(dtype):
    """One training step of the port on the CPU (plain kernel versions) and
    on the card: same seeded weights, same labels, same sampling uniforms,
    dropout off, and the CPU run's proposals on both (the RoI head is
    discontinuous in them). The two losses are differentiated apart: the
    RoI-head loss reaches both backbone branches through the sparse convs'
    backward kernels and not the BEV stack; the dense-head loss goes through
    ``conv_out`` and the BEV stack.

    At f32 the two runs differ only in the order of their sums, and the
    check is tight: every tb entry within 1e-3, both gradients within a
    cosine of 0.999 and 2% in norm. At bf16, the main path's dtype, the dozen
    batch norms of the tiny configuration's 4 x 4 BEV maps take their
    statistics from 32 or 8 values a channel and amplify the rounding noise
    many times over, so that tier is loose (``SMALL_TRAIN_GATES``): it holds
    the bf16 kernels' use in the step, and the f32 run next to it shows that
    what it lets through is rounding and not a wrong backward."""
    gates = SMALL_TRAIN_GATES[dtype]
    what = f"small train step {str(dtype).split('.')[-1]}"
    cfg = dict(SMALL, mm=True, num_rois=16, roi_per_image=8, roi_head_cfg={"dp_ratio": 0.0})
    raw = make_tiny_train_batch(b=2, seed=1)
    table = np.random.default_rng(2).random((6, 2, 16)).astype(np.float32)
    names = ("fg", "hard", "easy", "fill", "prio", "hs")
    runs, shared = {}, {}
    for device in ("cpu", "cuda"):
        model = set_compute_dtype(VoxelRCNN(**cfg), dtype)
        model.load_state_dict(seeded_state_dict(model, 3), strict=True)
        model = model.to(device).train()
        batch = to_device(raw, device)
        if device == "cpu":
            batch, _ = labels_on_proposals(model, batch, n_labelled=6)
            model.load_state_dict(seeded_state_dict(model, 3), strict=True)
            shared["labels"] = (batch["gt_boxes"], batch["gt_valid"])
            shared["proposals"] = training_proposals(model, batch)
            model.load_state_dict(seeded_state_dict(model, 3), strict=True)
        else:
            batch = dict(batch, gt_boxes=shared["labels"][0].to(device),
                         gt_valid=shared["labels"][1].to(device))
        proposals = {k: v.to(device) for k, v in shared["proposals"].items()}
        model.dense_head.generate_predicted_boxes = lambda *a, _p=proposals, **kw: _p
        uniforms = {n: torch.from_numpy(table[i]).to(device) for i, n in enumerate(names)}
        a1.gather_gemm.launches = a1.gather_gemm_dw.launches = 0
        loss, tb = model.loss_step(dict(batch, cur_it=1000.0), sampling_uniforms=uniforms)
        named = dict(model.named_parameters())
        grads = {}
        for part, scalar in (("RoI-head", loss - tb["rpn_loss"]), ("dense-head", tb["rpn_loss"])):
            got = torch.autograd.grad(scalar, list(named.values()), retain_graph=True,
                                      allow_unused=True)
            grads[part] = {n: g.double().flatten().cpu() for n, g in zip(named, got)
                           if g is not None}
        launched = (a1.gather_gemm.launches, a1.gather_gemm_dw.launches)
        if (device == "cuda") != (launched[0] > 0 and launched[1] > 0):
            raise AssertionError(f"{what} on {device}: kernel launches (A1, A2) = {launched}")
        runs[device] = ({k: float(v.detach()) for k, v in tb.items()}, grads)
    (tb_c, g_c), (tb_g, g_g) = runs["cpu"], runs["cuda"]
    for k, ref in tb_c.items():
        print(f"{what}, card vs CPU {k}: {tb_g[k]:.6f} vs {ref:.6f}")
        tier = gates["tb_dense"] if k in ("hm_loss", "loc_loss", "rpn_loss") else gates["tb"]
        if not abs(tb_g[k] - ref) <= tier * abs(ref) + gates["slack"]:
            raise AssertionError(f"{what}: card and CPU disagree at {k}: {tb_g[k]} vs {ref}")
    if not tb_c["rcnn_reg0"] > 0:
        raise AssertionError(f"{what}: no foreground RoI, the regression terms are dead")
    lo, hi = gates["ratio"]
    for part, want in gates["cosine"].items():
        if set(g_c[part]) != set(g_g[part]):
            raise AssertionError(f"{what}: the {part} loss reaches other parameters on the card")
        c = torch.cat([g_c[part][n] for n in g_c[part]])
        g = torch.cat([g_g[part][n] for n in g_c[part]])
        cos = float(torch.dot(c, g) / (c.norm() * g.norm()))
        ratio = float(g.norm() / c.norm())
        branches = sorted({n.split(".")[1] for n in g_c[part] if n.startswith("backbone.")})
        print(f"{what}, card vs CPU gradient of the {part} loss ({c.numel()} values, "
              f"backbone {branches}): cosine {cos:.6f} (gate {want}), norm ratio {ratio:.6f} "
              f"(gate {lo} to {hi})")
        if not (bool(torch.isfinite(g).all()) and cos >= want and lo <= ratio <= hi):
            raise AssertionError(f"{what}: card and CPU gradients of the {part} loss disagree: "
                                 f"cosine {cos}, norm ratio {ratio}")


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA card; none is available")
    card = card_line()
    print(f"card: {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_start = time.perf_counter()
    secs = a1.build(verbose=True)
    print(f"A1 + A2 build: {secs:.1f} s compiling (two nvcc processes side by side)", flush=True)

    dev = torch.device("cuda")
    model = seeded_model(BENCH, 0, dev)
    pts, valid = make_lidar_frame(np.random.default_rng(0), N_POINTS)
    batch = {"points": torch.from_numpy(pts)[None].to(dev),
             "points_valid": torch.from_numpy(valid)[None].to(dev)}
    cap_audit(model, batch)

    with KernelRecorder() as rec, torch.no_grad():
        model(batch)
    convs = rec.calls["forward"]
    if len(convs) != A1_PER_FORWARD or rec.calls["dw"]:
        raise AssertionError(f"recorded {len(convs)} A1 and {len(rec.calls['dw'])} A2 launches "
                             f"in one forward, want {A1_PER_FORWARD} and 0")
    max_err, shape_times = check_kernel("A1", convs, a1_kernel, a1_plain, torch.bfloat16)
    del convs, rec

    a1.gather_gemm.launches = 0
    out = model.predict(batch)
    torch.cuda.synchronize()
    launches = a1.gather_gemm.launches
    if launches != A1_PER_FORWARD:
        raise AssertionError(f"A1 launched {launches} times in one forward, "
                             f"want {A1_PER_FORWARD}")
    want = {"pred_boxes": (1, BENCH["num_rois_test"], 7), "pred_scores": (1, BENCH["num_rois_test"]),
            "pred_labels": (1, BENCH["num_rois_test"]), "pred_valid": (1, BENCH["num_rois_test"])}
    if {k: tuple(v.shape) for k, v in out.items()} != want:
        raise AssertionError(f"predict shapes {({k: tuple(v.shape) for k, v in out.items()})}, "
                             f"want {want}")
    for k, v in out.items():
        if not torch.isfinite(v.float()).all():
            raise AssertionError(f"non-finite values in {k}")
    n_det = int(out["pred_valid"].sum())
    print(f"predict: {n_det} valid detections of {out['pred_valid'].numel()} slots; "
          f"shapes { {k: tuple(v.shape) for k, v in out.items()} }")

    model.predict(batch)  # second warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    a1.gather_gemm.launches = 0
    loop_s = []
    for _ in range(TIMED_LOOPS):
        t0 = time.perf_counter()
        out = model.predict(batch)
        torch.cuda.synchronize()
        loop_s.append(time.perf_counter() - t0)
    if a1.gather_gemm.launches != A1_PER_FORWARD * TIMED_LOOPS:
        raise AssertionError(f"A1 launched {a1.gather_gemm.launches} times in "
                             f"{TIMED_LOOPS} forwards")
    fps = sorted(1.0 / s for s in loop_s)
    peak = torch.cuda.max_memory_allocated()
    print(f"predict frames/s over {TIMED_LOOPS} loops: median {statistics.median(fps):.3f} "
          f"min {fps[0]:.3f} max {fps[-1]:.3f}; peak memory {peak / 2**30:.2f} GiB")
    runs = [stage_breakdown(model, batch) for _ in range(3)]
    breakdown = {k: statistics.median(r[k] for r in runs) for k in runs[0]}
    print("stage ms (host clock, synchronised, median of 3): "
          + ", ".join(f"{k} {v:.2f}" for k, v in breakdown.items()))
    device_profile(lambda: model.predict(batch), "predict", 1e3 / statistics.median(fps))
    kernels = [kernel_entry("gather_gemm", "predict", "cpd_tpu_torch/csrc/gather_gemm.cu",
                            "cpd_tpu/ops/pallas_conv.py:77", launches, max_err, shape_times)]
    del model, batch, out
    torch.cuda.empty_cache()

    small_input_check()
    print(f"predict phases done at {time.perf_counter() - t_start:.1f} s", flush=True)

    kernels += training_phase(dev)
    small_train_check(torch.float32)
    small_train_check(torch.bfloat16)
    print(f"total {time.perf_counter() - t_start:.1f} s")

    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
