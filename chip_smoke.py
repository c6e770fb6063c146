"""Smoke run of the PyTorch port on one CUDA card (an NVIDIA H100).

    python3 chip_smoke.py
    python3 chip_smoke.py --determinism RUNS [--no-cudnn]   # phase 11 alone

Drives the port's paths at the bench configuration of the JAX package
(bench.py: 3 classes, range +-75.2 x [-2, 4] m, voxels (0.1, 0.1, 0.15) m,
grid 1504 x 1504 x 41, voxel cap 90k, stage caps (80k, 48k, 24k, 20k), 200
test RoIs) on 200k-point synthetic lidar frames, with weights drawn from a
seed: ``cpd_tpu_torch.models.detector.VoxelRCNN.predict`` (batch 1, MM
branch off) with the dense backbone tail, as bench.py runs it, and with the
sparse tail; the training step of ``cpd_tpu_torch.parallel``
(``VoxelRCNN.loss_step`` with ``mm=True``, batch 2, 64 label slots, backward,
clip, adam_onecycle; sparse tail); and the gather-formulation probes of
``cpd_tpu_torch.probes.gather`` at the probe scripts' own sizes. Phases, each
raising on failure:

1. card: needs CUDA; prints the card's name and power limit;
2. build: compiles every kernel source under cpd_tpu_torch/csrc/ (A1, A2,
   G1-G4) with nvcc for sm_90a, one process each, side by side, and prints
   what ptxas reports per kernel (registers a thread, spills; for each
   instance of G1-G4 apart, among G4's the transpose that G3 and G4 share)
   and the dynamic shared memory a block of A1, A2 and G1 asks for at the
   widest layer, of G3's f32 product and G4 at P6/P7, and of G2 at P3;
3. kernel A1 against its plain PyTorch version on the (table, idx, found, W)
   of each of the 21 launches of one sparse-tail forward, recorded at the
   wrapper: f32 within atol/rtol 1e-4 (TF32 off), bf16 (the main path's
   dtype) within rtol 1e-2 + 1e-2 of the layer's output scale; a second
   launch gives the same bits; median kernel and plain times per layer shape
   (device times: a spin kernel ahead of each reading keeps the host's
   enqueue out of it), the found-tap TFLOP/s achieved, and the host time one
   wrapper call takes;
4. the probe kernels G1-G4 against their plain versions (f32 operands within
   1e-4 of the output's scale, bf16 operands within rtol 1e-2 + 1e-2 of it
   against the plain version's f32 result, G2 within rtol 1e-4 + 1e-4 of it
   on either route, G4 bit-equal, a second launch bit-equal) on (a) each
   probe's own operands (G1 at P1, P2, P4 and P5, G2 at P3, G3 at P6, G4 at
   P7) and (b) the real operands of the 9 layer shapes recorded in 3, with
   times run in turns against A1 and the plain version on the same operands
   (G2's lines name the route its wrapper took: ``own`` kernel or ``A1``'s;
   G3's and G4's times include the transpose of their table, which is also
   timed alone), G1 against G3 on P5's f32
   operands (the two exact-f32 products), and A1 against G1 (the flat
   formulation) and G3, and against G2, summed over a forward's 21 convs,
   with the shapes where each is faster than A1; then the probes' entry point
   (``probes.gather.run_probe`` for P1-P7) with the launch counts read
   around it;
5. predict, sparse tail: cap-occupancy audit, A1 launch count (21 per
   forward), 2 warm-ups then 3 timed predicts (frames/s median/min/max),
   peak memory, finite outputs, a per-stage time breakdown, and a
   torch.profiler window (device busy time and idle share per predict, and
   the top kernels);
6. predict, dense tail (this configuration is the one bench.py runs): A1 on
   the 15 recorded launches of its forward, the cap audit, 15 A1 launches
   per forward, 2 warm-ups and 5 timed predicts, the same breakdown and
   profile, and dense against sparse on the same frame and weights: the key
   sets of ``x_conv4`` and ``encoded`` equal, features, heatmap and final
   scores within the bf16 tier;
7. a small-input check: the same weights on the CPU (plain kernel versions)
   and on the card agree within the bf16 tier;
8. the kernels of one training step on their real operands, recorded from a
   forward + backward: A1 forward (35 convs), A1 as dX (33) and A2 (35)
   against their plain versions, f32 (1e-4 of the output's scale: A2 sums
   up to 180,000 rows in another order) and bf16; times per layer shape;
9. training path, every step through ``make_train_step``: the launch counts
   of the first step (A1 35 forward + 33 dX, A2 35; the forward's share is
   read where that step's ``loss_step`` returns), a second warm-up, then 5
   timed steps (ms per step median/min/max, and the phases forward, backward,
   clip + update between CUDA events of those same steps), peak memory,
   finite losses with ``proto_loss`` among them, no skipped step, parameters
   of both branches moved, and a torch.profiler window of a step;
10. a small training step on the CPU and on the card, same weights, proposals
    and sampling uniforms: at f32 the losses agree to 1e-3 and the gradients
    to a cosine of 0.999; at bf16 (the main path's dtype), on a configuration
    whose BEV maps are 32 x 32 and 16 x 16, within a looser tier;
11. step determinism, a gate: one training step (loss_step + backward under
    ``deterministic_cudnn``, as ``make_train_step`` runs it) three times in one
    process from the same state, the third under
    ``torch.use_deterministic_algorithms``: every forward tensor and gradient
    bit-identical to the first run's; reported beside it, two runs without
    the scope and the scope's cost in ms and device busy ms. With
    ``--determinism RUNS`` only the build and this phase run, with RUNS runs
    under the scope (``--no-cudnn``: the scope turns cuDNN off instead).

The last two lines of stdout are the card line and a JSON object; the line
before them is the kernels JSON. For each use of A1 and A2 it gives the
launches of its path's counted run, the summed medians of the kernel and of
its plain version over those launches, and ``bound_ms``: the least time the
card could take for the same launches, per launch the larger of bytes /
3.35 TB/s (each operand read once, the output written once) and found-tap
operations / 989 TFLOP/s (bf16 tensor cores; 67 TFLOP/s for the f32 operands
of two probes), from this run's operands. For
G1-G4 ``launches`` counts the probe entry point's run, and the times and the
bound are summed over one launch at each of the kernel's probes (``uses``
lists them, and the 9 layer shapes beside A1). No single PyTorch call
computes a gather-GEMM, so ``library_ms`` is null except for G4, the gather
alone, where it is ``torch.index_select``'s time.
"""
import argparse
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
from cpd_tpu_torch.ops import cuda_build
from cpd_tpu_torch.ops import gather_gemm as a1
from cpd_tpu_torch.ops import gather_probes as gp
from cpd_tpu_torch.ops import sparse
from cpd_tpu_torch.ops.voxelizer import voxelize_batch
from cpd_tpu_torch.parallel import init_state, make_train_step
from cpd_tpu_torch.probes import gather as probes
from cpd_tpu_torch.utils.device import place
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
SMALL = dict(num_classes=3, mm=False, point_cloud_range=(-8.0, -8.0, -2.0, 8.0, 8.0, 4.0),
             voxel_size=(0.5, 0.5, 0.15), max_voxels=1024,
             backbone_caps=(512, 256, 128, 128), num_rois_test=16,
             rpn_nms={"NMS_THRESH": 0.8, "NMS_PRE_MAXSIZE": 256})
# the bf16 tier of small_train_check: SMALL's caps over a 64 m square of
# 0.25 m voxels, so that the BEV maps are 32 x 32 and 16 x 16 (SMALL's are 4 x
# 4 and 2 x 2) and their batch norms take statistics from 2,048 and 512
# values a channel; the tiny batch's points are spread over it
SMALL_BEV = dict(SMALL, point_cloud_range=(-32.0, -32.0, -2.0, 32.0, 32.0, 4.0),
                 voxel_size=(0.25, 0.25, 0.15))
N_POINTS = 200_000
TIMED_LOOPS = 5
# sparse convs of one forward: 21 with the sparse tail; the dense tail runs
# stage 4 (down4 + 4) and conv_out as dense conv3d, which leaves conv_input
# + 4, down2 + 4, down3 + 4
A1_PER_FORWARD = {False: 21, True: 15}
PROBE_ITERS = 5
PROBE_TILE = 256  # rows per tile of G4's output layout on the layer shapes
# one training step at mm=True: branch 0 has 21 sparse convs, the light branch
# 1 has 14 (one block at stages 2-4, no conv_out); every conv has a dW, and
# every conv but the two conv_input (voxel features are data) a dX
TRAIN_A1_FORWARD, TRAIN_A1_DX, TRAIN_A2 = 35, 33, 35
TRAIN_BATCH = 2
HBM_BYTES_PER_S = 3.35e12
SPIN_CYCLES = 600_000  # about 0.3 ms of torch.cuda._sleep ahead of a timed call
# peak rate for the operands' type: bf16 on the tensor cores; f32 products
# keep their precision only outside them
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
OPT_CFG = {"OPTIMIZER": "adam_onecycle", "LR": 0.003, "WEIGHT_DECAY": 1e-5,
           "GRAD_NORM_CLIP": 32}


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


def seeded_model(cfg, seed, device):
    model = VoxelRCNN(**cfg)
    model.load_state_dict(seeded_state_dict(model, seed), strict=True)
    return place(model.eval(), device)


def paired_median_ms(*fns, reps=5):
    """Median single-call device times (CUDA events) of two or more versions,
    run in turns (a b c, c b a, ...) after a warm-up of each. A spin kernel
    of about 0.3 ms is queued ahead of each reading, so that the host has
    enqueued the call before the card reaches it: a kernel of 0.05 ms is
    timed, not the wrapper's Python around it (``wrapper_host_us`` times
    that)."""
    for fn in fns:
        fn()
    times = [[] for _ in fns]
    for r in range(reps):
        for i in (range(len(fns)) if r % 2 == 0 else reversed(range(len(fns)))):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(SPIN_CYCLES)
            start.record()
            fns[i]()
            end.record()
            end.synchronize()
            times[i].append(start.elapsed_time(end))
    return tuple(statistics.median(t) for t in times)


def wrapper_host_us(fn, calls=200):
    """Host microseconds one call of a kernel wrapper takes to return (checks,
    allocation, the launch itself), over ``calls`` back-to-back calls."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return host


def launch_bound(tensors, out_bytes, ops, dtype):
    """The least a launch could cost the card: (bytes, operations,
    milliseconds, which limit). Every operand in ``tensors`` is read once and
    ``out_bytes`` written once at the card's memory rate; ``ops`` run at its
    peak rate for operands of ``dtype``; the bound is the larger of the two
    times."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors if t is not None) + out_bytes
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / PEAK_FLOPS[dtype] * 1e3
    return nbytes, ops, max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def found_tap_ops(idx, found, cin, cout):
    """2 * Cin * Cout operations for each found tap (every tap without ``found``)."""
    return 2.0 * float(idx.numel() if found is None else found.sum()) * cin * cout


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
        nbytes, ops, lim, by = launch_bound(
            (table, idx, found, other),
            out.numel() * torch.empty(0, dtype=out_dtype).element_size(),
            found_tap_ops(idx, found, table.shape[-1], other.shape[-1]), table.dtype)
        entry["nbytes"] += nbytes
        entry["ops"] += ops
        entry["bound_ms"] += lim
        entry["bound_by"][by] = entry["bound_by"].get(by, 0.0) + lim
        print(f"{label} {name}: B={b} N={n} K={k} C={table.shape[-1]}->{other.shape[-1]} "
              f"found={found.float().mean().item():.3f} f32 max err {err32.max().item():.3e}, "
              f"bf16 max err {err.max().item():.3e} (output scale {scale:.3e})")
    name, table, idx, found, other = calls[0]
    host_us = wrapper_host_us(lambda: kernel(table, idx, found, other, out_dtype))
    print(f"{label}: the wrapper takes {host_us:.1f} us of host time a call (at {name}, 200 "
          f"calls back to back)")
    for e in shapes.values():
        print(f"{label} shape {e['layer']} x{e['count']}: B={e['batch']} N={e['rows']} "
              f"K={e['taps']} C={e['cin']}->{e['cout']}: kernel {e['ms']:.4f} ms, plain "
              f"{e['plain_ms']:.4f} ms (medians of 5, run in turns, bf16), bound "
              f"{e['bound_ms'] / e['count']:.5f} ms a launch by {'/'.join(e['bound_by'])} "
              f"({e['nbytes'] / e['count'] / 1e6:.2f} MB, "
              f"{e['ops'] / e['count'] / 1e9:.3f} GFLOP on found taps: "
              f"{e['ops'] / e['count'] / e['ms'] / 1e9:.2f} TFLOP/s achieved on them)")
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


def kernel_resource_lines():
    """What ptxas reports for the kernels of every source (registers a
    thread, spilled bytes, static shared memory) and, for A1 and A2, whose
    shared memory is dynamic, the bytes a block asks for at the widest
    layer's launch."""
    for name in cuda_build.SOURCES:
        rows = cuda_build.kernel_resources(name)
        if not rows:  # the library was built by an earlier process and reused
            print(f"{name}: reused an earlier build, no ptxas report")
            continue
        print(f"{name}: {len(rows)} kernels, {min(r[1] for r in rows)} to "
              f"{max(r[1] for r in rows)} registers a thread, "
              f"{sum(r[2] for r in rows)} bytes spilled, "
              f"{max(r[3] for r in rows)} bytes of static shared memory at most")
    for name in ("gather_gemm_flat", "gather_gemm_per_tap", "lane_gather_gemm", "lane_gather"):
        for kernel, regs, spilled, smem in cuda_build.kernel_resources(name):
            print(f"{name} instance {kernel}: {regs} registers a thread, {spilled} bytes "
                  f"spilled, {smem} bytes of static shared memory")
    for code, what in ((1, "bf16"), (0, "f32")):
        tm = a1.a1_tile_rows(1, 24000, 27, 128, 128, 4 - 2 * code)
        plan = a1.a2_plan(48000, 27, 128, 128)
        tm_g1 = gp.g1_tile_rows(24000, 27, 128, 4 - 2 * code)
        print(f"shared memory a block at 27 x 128 -> 128, {what}: A1 "
              f"{a1.kernel_smem_bytes('gather_gemm', 27, 128, 128, code, tm)} bytes at {tm} rows "
              f"a tile (24000 rows), A2 "
              f"{a1.kernel_smem_bytes('gather_gemm_dw', 128, 128, *plan, code)} bytes at "
              f"(chunk rows, taps) = {plan} (48000 rows), G1 "
              f"{a1.kernel_smem_bytes('gather_gemm_flat', 27, 128, code, 0, tm_g1)} bytes at "
              f"{tm_g1} rows a tile")
    print(f"shared memory a block of G3's f32 product at 27 x 64 -> 64 (P6): "
          f"{gp.g3_smem_bytes(27, 64)} bytes, {gp.g3_threads(64)} threads; G4: "
          f"{gp.g4_smem_bytes()} bytes, static")
    p3 = probes.PROBES["P3"]
    warps = gp.g2_warps(p3.v, p3.k, p3.cin, p3.cout)
    print(f"shared memory a block of G2 at P3 ({p3.v} x {p3.k} x {p3.cin} -> {p3.cout}): "
          f"{a1.kernel_smem_bytes('gather_gemm_per_tap', p3.k, p3.cin, p3.cout, warps)} bytes "
          f"at {warps} warps")


def cap_audit(model, batch):
    """Valid sites per stage of one backbone forward against the stage caps;
    raises where a cap is full (sites may have been dropped)."""
    with torch.no_grad():
        frame = voxelize_batch(batch["points"], model.vox_spec, batch["points_valid"])
        out = model.backbone(frame.features, keys_from_frame(frame, model.grid))
    occ = {"stage0": (int(frame.valid.sum(-1).max()), model.vox_spec.max_voxels)}
    for name, cap in zip(("x_conv2", "x_conv3", "x_conv4", "encoded"), model.backbone.caps):
        occ[name] = (int((out[name][1] != sparse.INVALID_KEY).sum(-1).max()), cap)
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
        step("rulebooks", lambda: build_branch_rulebooks(
            keys, model.grid, model.backbone.caps, dense_tail=model.backbone.dense_tail))
        # with the dense tail this stage holds the dense stage 4 and conv_out too
        step("sparse_convs", lambda: model.backbone.branch0(state["voxelize"].features,
                                                            state["rulebooks"]))
        raw = dict(state["sparse_convs"])
        bev_map = raw.pop("encoded_bev", None)
        grids = stage_grids(model.grid)
        backbone_out = {k: (f, ky, grids[k]) for k, (f, ky) in raw.items()}
        step("bev", lambda: model.bev_backbone(
            height_compression(*backbone_out["encoded"]) if bev_map is None else bev_map))
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


def _tensors(x):
    """Every tensor in a module's output (tensors, tuples, dicts, NamedTuples)."""
    if isinstance(x, torch.Tensor):
        return [x.detach().clone()]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _tensors(v)]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _tensors(v)]
    return []


def _first_differences(run_a, run_b):
    """(first forward tensor, first gradient) that differ between two runs
    of one step, in the order the forward made them and in parameter order;
    None where the runs agree bit for bit."""
    (rec_a, _, grads_a), (rec_b, _, grads_b) = run_a, run_b
    first_fwd = next((f"{name}[{i}]" for (name, ta), (_, tb) in zip(rec_a, rec_b)
                      for i, (x, y) in enumerate(zip(ta, tb)) if not torch.equal(x, y)), None)
    first_grad = next((n for (n, x), (_, y) in zip(grads_a, grads_b) if not torch.equal(x, y)),
                      None)
    return first_fwd, first_grad


def step_determinism(dev, runs=2, cudnn=True):
    """Phase 11, a gate. One training step (loss_step and backward, the bench
    configuration, batch 2, the labels placed once) run ``runs`` times from
    the same weights, statistics and generator seed, under
    ``deterministic_cudnn`` as ``make_train_step`` runs it (``cudnn=False``:
    with cuDNN off instead), and once more under
    ``torch.use_deterministic_algorithms(True, warn_only=True)`` (PyTorch's
    deterministic kernels where an op has them; the ops without one are
    named): every run must equal the first bit for bit, every tensor the
    forward made (the voxelizer's frames, then every module's output) and
    every parameter gradient. Reported beside it: two runs without the
    scope, and what the scope costs (ms of loss_step + backward, host clock,
    synchronised, in turns; device busy ms under the profiler). Should the
    gate fail, two runs with cuDNN off are compared before it raises, and
    the error says whether they agreed: cuDNN's engines or the machine."""
    import contextlib
    import warnings
    from cpd_tpu_torch.models import detector
    from cpd_tpu_torch.parallel import deterministic_cudnn
    model = VoxelRCNN(**dict(BENCH, mm=True))
    model.load_state_dict(seeded_state_dict(model, 0), strict=True)
    model = place(model, dev).train()
    batch = to_device(make_train_batch(0, TRAIN_BATCH, N_POINTS), dev)
    batch, _ = labels_on_proposals(model, batch, n_labelled=min(40, batch["gt_boxes"].shape[1]))
    start = {k: v.detach().clone() for k, v in model.state_dict().items()}
    voxelize = detector.voxelize_batch
    scopes = {"deterministic_cudnn": deterministic_cudnn,
              "cuDNN off": lambda: torch.backends.cudnn.flags(enabled=False),
              "no scope": contextlib.nullcontext}
    gated = "deterministic_cudnn" if cudnn else "cuDNN off"

    def bare_step(scope):
        model.load_state_dict(start, strict=True)
        model.zero_grad(set_to_none=True)
        with scopes[scope]():
            loss, _ = model.loss_step(batch, generator=torch.Generator(device=dev).manual_seed(0))
            loss.backward()
        torch.cuda.synchronize()
        return loss

    def one_step(scope=gated):
        record = []

        def recorded_voxelize(*args, **kwargs):
            frame = voxelize(*args, **kwargs)
            record.append(("voxelize_batch", _tensors(tuple(frame))))
            return frame
        hooks = [m.register_forward_hook(
            lambda mod, inp, out, name=name: record.append((name, _tensors(out))))
            for name, m in model.named_modules() if name]
        detector.voxelize_batch = recorded_voxelize
        try:
            loss = bare_step(scope)
        finally:
            detector.voxelize_batch = voxelize
            for h in hooks:
                h.remove()
        grads = [(n, p.grad.clone()) for n, p in model.named_parameters() if p.grad is not None]
        return record, float(loss.detach()), grads

    first = one_step()
    again = [one_step() for _ in range(runs - 1)]
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            again.append(one_step())
    finally:
        torch.use_deterministic_algorithms(False)
    differ = {f"run {r + 2}": _first_differences(first, run) for r, run in enumerate(again)}
    flagged = sorted({str(w.message).split(" does not have a deterministic")[0]
                      for w in caught if "deterministic" in str(w.message)})
    free = one_step("no scope"), one_step("no scope")
    print(f"step determinism (loss_step + backward from the same state under {gated}, cuDNN "
          f"{torch.backends.cudnn.version()}, {len(first[0])} recorded forward outputs, "
          f"{len(first[2])} gradients; run {runs + 1} under deterministic algorithms): losses "
          f"{[run[1] for run in [first] + again]}; first forward tensor and gradient that differ "
          f"from run 1: {differ}; ops flagged as not deterministic: {flagged or 'none'}",
          flush=True)
    print(f"step determinism without the scope (report): losses {free[0][1]!r}, "
          f"{free[1][1]!r}; first forward tensor and gradient that differ: "
          f"{_first_differences(*free)}", flush=True)

    times = {gated: [], "no scope": []}
    for r in range(2 * TIMED_LOOPS):
        scope = gated if r % 4 in (0, 3) else "no scope"  # in turns: with, without, without, ...
        t0 = time.perf_counter()
        bare_step(scope)
        times[scope].append((time.perf_counter() - t0) * 1e3)
    for scope, ms_list in times.items():
        ms = statistics.median(ms_list)
        print(f"loss_step + backward, {scope}: {ms:.2f} ms (median of {len(ms_list)}, in turns)",
              flush=True)
        device_profile(lambda: bare_step(scope), f"loss_step + backward, {scope}", ms, loops=2)
    if any(any(d) for d in differ.values()):
        off = one_step("cuDNN off"), one_step("cuDNN off")
        raise AssertionError(f"one training step is not bit-identical twice: {differ}; two runs "
                             f"with cuDNN off (losses {off[0][1]!r}, {off[1][1]!r}) differ at "
                             f"{_first_differences(*off)}")
    return differ


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
# gradient. bf16 on SMALL_BEV read cosines of 0.965 (RoI head) and 0.718
# (dense head; 0.344 on SMALL's 4 x 4 maps) on an H100
SMALL_TRAIN_GATES = {
    torch.float32: dict(tb=1e-3, tb_dense=1e-3, slack=1e-3, cosine={"RoI-head": 0.999,
                                                                   "dense-head": 0.999},
                        ratio=(0.98, 1.02)),
    torch.bfloat16: dict(tb=0.10, tb_dense=0.20, slack=1e-2, cosine={"RoI-head": 0.9,
                                                                    "dense-head": 0.6},
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
    cosine of 0.999 and 2% in norm. At bf16, the main path's dtype, the
    rounding of every layer differs between the two, and batch norms over
    few values a channel amplify it: on the tiny configuration's 4 x 4 BEV
    maps (32 or 8 values) the dense-head gradient's cosine read 0.344. So
    the bf16 tier runs on ``SMALL_BEV`` (BEV maps of 32 x 32 and 16 x 16)
    with gates of its own (``SMALL_TRAIN_GATES``): it holds the bf16
    kernels' use in the step, and the f32 run next to it shows that what it
    lets through is rounding and not a wrong backward."""
    gates = SMALL_TRAIN_GATES[dtype]
    what = f"small train step {str(dtype).split('.')[-1]}"
    base = SMALL if dtype == torch.float32 else SMALL_BEV
    cfg = dict(base, mm=True, num_rois=16, roi_per_image=8, roi_head_cfg={"dp_ratio": 0.0})
    raw = make_tiny_train_batch(b=2, seed=1)
    if base is SMALL_BEV:  # the tiny batch's points lie within +-8 m
        raw["points"][..., :2] *= 4.0
        raw["points1"] = raw["points"] + 0.01
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


PROBE_KERNELS = ("gather_gemm_flat", "gather_gemm_per_tap", "lane_gather_gemm", "lane_gather")


def hold_against_plain(label, kernel, plain, bf16, exact=False, tol=None):
    """One probe kernel launch against its plain version on the same
    operands (functions of no arguments, f32 results): bit-equal with
    ``exact``, else within ``tol`` of the output's scale plus rtol ``tol``:
    by default 1e-4 for f32 operands and 1e-2 for bf16 ones; a second launch
    must give the same bits. Returns (largest error, output bytes)."""
    out, ref = kernel(), plain()
    torch.cuda.synchronize()
    if out.shape != ref.shape or out.dtype != torch.float32:
        raise AssertionError(f"{label}: kernel gave {out.dtype} {tuple(out.shape)}, plain "
                             f"{ref.dtype} {tuple(ref.shape)}")
    if not torch.equal(out, kernel()):
        raise AssertionError(f"{label}: two launches gave different bits")
    err = (out - ref).abs()
    max_err = err.max().item() if err.numel() else 0.0
    if exact:
        if not torch.equal(out, ref):
            raise AssertionError(f"{label}: not bit-equal to the plain version, max err {max_err}")
    else:
        scale = max(ref.abs().max().item(), 1e-3)
        tol = tol or (1e-2 if bf16 else 1e-4)
        if not bool((err <= tol * ref.abs() + tol * scale).all()):
            raise AssertionError(f"{label} mismatch: max err {max_err} at output scale {scale}")
    return max_err, out.numel() * out.element_size()


def probe_use(kernel_name, at, kernel, plain, third, tensors, ops, bf16, transpose=None,
              route=None):
    """Hold one probe kernel against its plain version on one set of
    operands and time it in turns with the plain version, ``third`` (kernel
    A1 on the same operands, or for G4 the library call) and, for G3 and G4,
    ``transpose``: the transpose of the table that the kernel's time
    includes, alone. ``route``: G2's (``gp.g2_route``), held to rtol 1e-4 +
    1e-4 of the scale on either. Returns the record of this use for the
    kernels line."""
    gather_only = kernel_name == "lane_gather"
    max_err, out_bytes = hold_against_plain(f"{kernel_name} at {at}", kernel, plain, bf16,
                                            exact=gather_only, tol=1e-4 if route else None)
    fns = (kernel, plain, third) + ((transpose,) if transpose else ())
    ms, plain_ms, third_ms, *transpose_ms = paired_median_ms(*fns)
    transpose_ms = transpose_ms[0] if transpose_ms else None
    nbytes, _, bound_ms, by = launch_bound(tensors, out_bytes, ops,
                                           torch.bfloat16 if bf16 else torch.float32)
    beside = "index_select" if gather_only else "A1"
    of_it = "" if transpose is None else f" (of it the transpose alone {transpose_ms:.4f} ms)"
    via = f" (route {route})" if route else ""
    print(f"{kernel_name} at {at}{via}: kernel {ms:.4f} ms{of_it}, plain {plain_ms:.4f} ms, "
          f"{beside} {third_ms:.4f} ms (medians of 5, run in turns), bound {bound_ms:.5f} ms "
          f"by {by} ({nbytes / 1e6:.2f} MB, {ops / 1e9:.3f} GFLOP on found taps), max err "
          f"{max_err:.3e}")
    return {"at": at, "ms": ms, "plain_ms": plain_ms, "a1_ms": None if gather_only else third_ms,
            "library_ms": third_ms if gather_only else None, "bound_ms": bound_ms,
            "bound_by": by, "max_abs_err": max_err, "transpose_ms": transpose_ms, "route": route}


def lane_transpose(kernel_name, table_t):
    """G3's or G4's transpose of ``table_t`` alone, as a function of no
    arguments (None for the other probe kernels)."""
    if not kernel_name.startswith("lane_gather"):
        return None
    return lambda: gp.lane_rows(table_t)


def probes_on_own_operands(dev, uses):
    """(a) G1 at P1, P2, P4 and P5, G2 at P3, G3 at P6, G4 at P7: each
    probe's own operands, made by ``cpd_tpu_torch.probes.gather``."""
    for name, probe in probes.PROBES.items():
        ops = probes.make_operands(name, dev)
        third = probes.a1_call(ops) or probes.baseline_calls(ops)["index_select"]
        flops = 0.0 if ops.w is None else found_tap_ops(ops.idx, ops.found, probe.cin, probe.cout)
        route = (gp.g2_route(probe.k, probe.cin, probe.cout, ops.table.dtype)
                 if probe.kernel == "gather_gemm_per_tap" else None)
        uses[probe.kernel].append(probe_use(
            probe.kernel, name, probes.kernel_call(ops), probes.plain_call(ops), third,
            (ops.table, ops.idx, ops.found, ops.w), flops,
            bf16=probe.round_bf16 or ops.table.dtype == torch.bfloat16,
            transpose=lane_transpose(probe.kernel, ops.table), route=route))
        del ops, third
        torch.cuda.empty_cache()


def exact_f32_products_at_p5(dev):
    """G1's and G3's exact-f32 products compute one function on a row-major
    table: both on P5's f32 operands (no found), G3 on the table transposed,
    held against the plain version and timed in turns with G3's transpose
    alone (G3's time includes it)."""
    ops = probes.make_operands("P5", dev)
    table_t = ops.table.T.contiguous()

    def g3():
        return gp.lane_gather_gemm(table_t, ops.idx, ops.w)
    max_err, _ = hold_against_plain("lane_gather_gemm at P5", g3, probes.plain_call(ops), False)
    g1_ms, g3_ms, transpose_ms = paired_median_ms(probes.kernel_call(ops), g3,
                                                  lambda: gp.lane_rows(table_t))
    print(f"exact-f32 products at P5 (48000 x 27 x 32 -> 32, no found): G1 {g1_ms:.4f} ms, "
          f"G3 {g3_ms:.4f} ms (of it the transpose alone {transpose_ms:.4f} ms; medians of 5, "
          f"run in turns), G3 max err {max_err:.3e}", flush=True)


def probes_on_layer_shapes(convs, uses):
    """(b) All four probe kernels beside A1 on the real bf16 operands of each
    layer shape among the recorded convs of a forward (batch 1)."""
    seen = set()
    for name, table, idx, found, w in convs:
        (_, n, k), cin, cout = idx.shape, table.shape[-1], w.shape[-1]
        if (n, k, cin, cout) in seen:
            continue
        seen.add((n, k, cin, cout))
        t, i, f = table[0], idx[0], found[0]
        t_t, w3 = t.T.contiguous(), w.reshape(k, cin, cout)
        flat = i.reshape(-1)[:n // PROBE_TILE * PROBE_TILE * k]
        at = f"{name} N={n} K={k} C={cin}->{cout} found={f.float().mean().item():.3f}"
        flops = found_tap_ops(i, f, cin, cout)

        def a1_f32():
            return a1.gather_gemm(table, idx, found, w, torch.float32)

        uses["gather_gemm_flat"].append(probe_use(
            "gather_gemm_flat", at, lambda: gp.gather_gemm_flat(t, i, f, w),
            lambda: gp.gather_gemm_flat_reference(t, i, f, w), a1_f32, (t, i, f, w), flops, True))
        uses["gather_gemm_per_tap"].append(probe_use(
            "gather_gemm_per_tap", at, lambda: gp.gather_gemm_per_tap(t, i, f, w3),
            lambda: gp.gather_gemm_per_tap_reference(t, i, f, w3), a1_f32, (t, i, f, w), flops,
            True, route=gp.g2_route(k, cin, cout, t.dtype)))
        uses["lane_gather_gemm"].append(probe_use(
            "lane_gather_gemm", at, lambda: gp.lane_gather_gemm(t_t, i, w, f),
            lambda: gp.lane_gather_gemm_reference(t_t, i, w, f), a1_f32, (t, i, f, w), flops,
            True, lane_transpose("lane_gather_gemm", t_t)))
        uses["lane_gather"].append(probe_use(
            "lane_gather", at, lambda: gp.lane_gather(t_t, i, PROBE_TILE),
            lambda: gp.lane_gather_reference(t_t, i, PROBE_TILE),
            lambda: torch.index_select(t_t, 1, flat), (t_t, i), 0.0, True,
            lane_transpose("lane_gather", t_t)))
    if len(seen) != 9:
        raise AssertionError(f"{len(seen)} layer shapes among the recorded convs, want 9")
    # kernel A1 against G1 (the flat formulation) and G2, timed in the same turns
    counts = {}
    for _, table, idx, _, w in convs:
        key = (idx.shape[1], idx.shape[2], table.shape[-1], w.shape[-1])
        counts[key] = counts.get(key, 0) + 1
    for labels in (("G1", "G3"), ("G2",)):
        kernels = [{"G1": "gather_gemm_flat", "G2": "gather_gemm_per_tap",
                    "G3": "lane_gather_gemm"}[label] for label in labels]
        on_layers = [uses[kernel][-9:] for kernel in kernels]
        a1_sum = sum(u["a1_ms"] * n for u, n in zip(on_layers[0], counts.values()))
        sums = [sum(u["ms"] * n for u, n in zip(ul, counts.values())) for ul in on_layers]
        ahead = [f"{label} faster than A1 at: "
                 + str([f"{u['at'].split(' found')[0]} ({u['ms']:.4f} against {u['a1_ms']:.4f} "
                        f"ms)" for u in ul if u["a1_ms"] > u["ms"]] or "no shape")
                 for label, ul in zip(labels, on_layers)]
        print(f"A1 against {' and '.join(labels)} over the {sum(counts.values())} convs of a "
              f"forward (f32 output, batch 1): A1 {a1_sum:.4f} ms, "
              + ", ".join(f"{label} {t:.4f} ms" for label, t in zip(labels, sums))
              + "; " + "; ".join(ahead))
    g2 = list(zip(uses["gather_gemm_per_tap"][-9:], counts.values()))
    print("G2 by route over the same convs: " + "; ".join(
        f"{route}: {sum(n for u, n in g2 if u['route'] == route)} convs of "
        f"{sum(u['route'] == route for u, _ in g2)} shapes, G2 "
        f"{sum(u['ms'] * n for u, n in g2 if u['route'] == route):.4f} ms, A1 "
        f"{sum(u['a1_ms'] * n for u, n in g2 if u['route'] == route):.4f} ms"
        for route in ("own", "A1")))


def probe_phase(dev, convs):
    """Phase 4. Returns the kernels-line entries of G1-G4."""
    uses = {k: [] for k in PROBE_KERNELS}
    probes_on_own_operands(dev, uses)
    exact_f32_products_at_p5(dev)
    probes_on_layer_shapes(convs, uses)
    # this slice's path: the probes' entry point, with the counts read around it
    wrappers = {k: getattr(gp, k) for k in PROBE_KERNELS}
    for fn in wrappers.values():
        fn.launches = 0
    for name in probes.PROBES:
        probes.run_probe(name, dev, PROBE_ITERS)
    torch.cuda.synchronize()
    entries = []
    for k, fn in wrappers.items():
        if fn.launches == 0:
            raise AssertionError(f"the probe entry point never launched {k}")
        own = [u for u in uses[k] if u["at"] in probes.PROBES]
        by = {}
        for u in own:
            by[u["bound_by"]] = by.get(u["bound_by"], 0.0) + u["bound_ms"]
        library = [u["library_ms"] for u in own if u["library_ms"] is not None]
        entries.append({
            "name": k, "path": "probes", "route": "cuda", "source": f"cpd_tpu_torch/csrc/{k}.cu",
            "replaces": "; ".join(probes.PROBES[u["at"]].replaces for u in own),
            "launches": fn.launches, "max_abs_err": max(u["max_abs_err"] for u in uses[k]),
            "ms": sum(u["ms"] for u in own), "plain_ms": sum(u["plain_ms"] for u in own),
            "bound_ms": sum(u["bound_ms"] for u in own), "bound_by": max(by, key=by.get),
            "library_ms": sum(library) if library else None, "uses": uses[k]})
    print("probe entry point launches: "
          + ", ".join(f"{k} {fn.launches}" for k, fn in wrappers.items()))
    return entries


def recorded_forward(model, batch):
    """The (name, table, idx, found, W) of every A1 launch of one forward."""
    want = A1_PER_FORWARD[model.backbone.dense_tail]
    with KernelRecorder() as rec, torch.no_grad():
        model(batch)
    convs = rec.calls["forward"]
    if len(convs) != want or rec.calls["dw"]:
        raise AssertionError(f"recorded {len(convs)} A1 and {len(rec.calls['dw'])} A2 launches "
                             f"in one forward, want {want} and 0")
    return convs


def predict_phase(model, batch, what, timed_loops):
    """One predict path at full width: launch count, shapes, finite outputs,
    2 warm-ups, timed loops, peak memory, stage breakdown, profiler window.
    Returns the A1 launches of one counted predict."""
    want_launches = A1_PER_FORWARD[model.backbone.dense_tail]
    a1.gather_gemm.launches = 0
    out = model.predict(batch)
    torch.cuda.synchronize()
    launches = a1.gather_gemm.launches
    if launches != want_launches:
        raise AssertionError(f"{what}: A1 launched {launches} times in one forward, "
                             f"want {want_launches}")
    n_rois = BENCH["num_rois_test"]
    want = {"pred_boxes": (1, n_rois, 7), "pred_scores": (1, n_rois),
            "pred_labels": (1, n_rois), "pred_valid": (1, n_rois)}
    shapes = {k: tuple(v.shape) for k, v in out.items()}
    if shapes != want:
        raise AssertionError(f"{what}: predict shapes {shapes}, want {want}")
    for k, v in out.items():
        if not torch.isfinite(v.float()).all():
            raise AssertionError(f"{what}: non-finite values in {k}")
    print(f"predict, {what}: {int(out['pred_valid'].sum())} valid detections of "
          f"{out['pred_valid'].numel()} slots; {launches} A1 launches; shapes {shapes}")

    model.predict(batch)  # second warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    a1.gather_gemm.launches = 0
    loop_s = []
    for _ in range(timed_loops):
        t0 = time.perf_counter()
        model.predict(batch)
        torch.cuda.synchronize()
        loop_s.append(time.perf_counter() - t0)
    if a1.gather_gemm.launches != want_launches * timed_loops:
        raise AssertionError(f"{what}: A1 launched {a1.gather_gemm.launches} times in "
                             f"{timed_loops} forwards")
    fps = sorted(1.0 / s for s in loop_s)
    peak = torch.cuda.max_memory_allocated()
    print(f"predict, {what}: frames/s over {timed_loops} loops: median "
          f"{statistics.median(fps):.3f} min {fps[0]:.3f} max {fps[-1]:.3f}; peak memory "
          f"{peak / 2**30:.2f} GiB")
    runs = [stage_breakdown(model, batch) for _ in range(3)]
    breakdown = {k: statistics.median(r[k] for r in runs) for k in runs[0]}
    print(f"predict, {what}: stage ms (host clock, synchronised, median of 3): "
          + ", ".join(f"{k} {v:.2f}" for k, v in breakdown.items()))
    device_profile(lambda: model.predict(batch), f"predict ({what})",
                   1e3 / statistics.median(fps))
    return launches


def compare_tails(sparse_model, dense_model, batch):
    """Dense against sparse tail on the same frame and weights: the key sets
    of x_conv4 and encoded equal; features and the heatmap within the bf16
    tier (3% of the scale); and the RoI head's final scores, on the sparse
    run's proposals for both (the head is discontinuous in its proposals, and
    those follow the heatmap's rounding), within 0.05."""
    models = (sparse_model, dense_model)
    with torch.no_grad():
        s_out, d_out = (m(batch) for m in models)
        proposals = {k: s_out[k] for k in ("rois", "roi_scores", "roi_labels", "roi_valid")}
        heads = [m.roi_head(proposals, o["backbone_out"]) for m, o in zip(models, (s_out, d_out))]
        kept = [int(m.post_processing(o)["pred_valid"].sum()) for m, o in zip(models, (s_out, d_out))]

    def close(name, a, b):
        a, b = a.float(), b.float()
        err, scale = (a - b).abs().max().item(), max(a.abs().max().item(), 1e-3)
        print(f"dense vs sparse tail, {name}: max err {err:.3e} (scale {scale:.3e})")
        if not err <= 0.03 * scale:
            raise AssertionError(f"dense and sparse tail disagree at {name}: {err} vs {scale}")

    for name in ("x_conv4", "encoded"):
        (fs, ks, _), (fd, kd, _) = s_out["backbone_out"][name], d_out["backbone_out"][name]
        if not torch.equal(ks, kd):
            raise AssertionError(f"dense and sparse tail give other key sets at {name}")
        close(name, fs, fd)
    close("hm", s_out["head_preds"]["hm"], d_out["head_preds"]["hm"])
    valid = proposals["roi_valid"]
    scores = [torch.sigmoid(h["batch_cls_preds"][..., 0].float())[valid] for h in heads]
    if not all(bool(torch.isfinite(sc).all()) for sc in scores) or not int(valid.sum()):
        raise AssertionError("no valid RoI, or non-finite RoI scores")
    diff = (scores[0] - scores[1]).abs().max().item()
    print(f"dense vs sparse tail, final scores of the same {int(valid.sum())} RoIs: max "
          f"difference {diff:.4f}; detections kept by each run's own predict: {kept}")
    if diff > 0.05:
        raise AssertionError(f"dense and sparse tail disagree in their final scores: {diff}")


def main():
    parser = argparse.ArgumentParser(description="Smoke run of the PyTorch port on one card.")
    parser.add_argument("--determinism", type=int, metavar="RUNS",
                        help="run only phase 11 (after the build), with RUNS runs of the step "
                             "under the scope (at least 2)")
    parser.add_argument("--no-cudnn", action="store_true",
                        help="with --determinism: the scope turns cuDNN off instead")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA card; none is available")
    card = card_line()
    print(f"card: {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_start = time.perf_counter()
    secs = cuda_build.build(verbose=True)
    print(f"kernel build: {secs:.1f} s compiling {len(cuda_build.SOURCES)} sources (one nvcc "
          f"process each, side by side)", flush=True)
    dev = torch.device("cuda")
    if args.determinism:
        step_determinism(dev, max(args.determinism, 2), cudnn=not args.no_cudnn)
        print(f"total {time.perf_counter() - t_start:.1f} s")
        return
    kernel_resource_lines()

    src = "cpd_tpu_torch/csrc/gather_gemm.cu"
    pts, valid = make_lidar_frame(np.random.default_rng(0), N_POINTS)
    batch = {"points": torch.from_numpy(pts)[None].to(dev),
             "points_valid": torch.from_numpy(valid)[None].to(dev)}

    # the sparse tail: A1 on its 21 launches, then the probes on the same operands
    sparse_model = seeded_model(BENCH, 0, dev)
    cap_audit(sparse_model, batch)
    convs = recorded_forward(sparse_model, batch)
    max_err, shape_times = check_kernel("A1", convs, a1_kernel, a1_plain, torch.bfloat16)
    probe_entries = probe_phase(dev, convs)
    del convs
    torch.cuda.empty_cache()
    print(f"probe phase done at {time.perf_counter() - t_start:.1f} s", flush=True)
    launches = predict_phase(sparse_model, batch, "sparse tail", timed_loops=3)
    kernels = [kernel_entry("gather_gemm", "predict, sparse tail", src,
                            "cpd_tpu/ops/pallas_conv.py:77", launches, max_err, shape_times)]

    # the dense tail: the configuration of the JAX package's bench
    dense_model = seeded_model(dict(BENCH, dense_tail=True), 0, dev)
    cap_audit(dense_model, batch)
    convs = recorded_forward(dense_model, batch)
    max_err, shape_times = check_kernel("A1 dense-tail predict", convs, a1_kernel, a1_plain,
                                        torch.bfloat16)
    del convs
    launches = predict_phase(dense_model, batch, "dense tail", TIMED_LOOPS)
    kernels.append(kernel_entry("gather_gemm", "predict, dense tail", src,
                                "cpd_tpu/ops/pallas_conv.py:77", launches, max_err, shape_times))
    compare_tails(sparse_model, dense_model, batch)
    del sparse_model, dense_model, batch
    torch.cuda.empty_cache()

    small_input_check()
    print(f"predict phases done at {time.perf_counter() - t_start:.1f} s", flush=True)

    kernels += training_phase(dev)
    kernels += probe_entries
    small_train_check(torch.float32)
    small_train_check(torch.bfloat16)
    step_determinism(dev)
    print(f"total {time.perf_counter() - t_start:.1f} s")

    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
