"""Smoke run of the PyTorch port on one CUDA card (an NVIDIA H100).

    python3 chip_smoke.py

Drives the port's main path, ``cpd_tpu_torch.models.detector.VoxelRCNN.predict``,
at the bench configuration of the JAX package (bench.py: 3 classes, range
+-75.2 x [-2, 4] m, voxels (0.1, 0.1, 0.15) m, grid 1504 x 1504 x 41, voxel
cap 90k, stage caps (80k, 48k, 24k, 20k), MM branch off, 200 test RoIs, sparse
backbone tail) on one 200k-point synthetic lidar frame, with weights drawn
from a seed. Phases, each raising on failure:

1. card: needs CUDA; prints the card's name and power limit;
2. build: compiles kernel A1 (csrc/gather_gemm.cu) with nvcc for sm_90a;
3. kernel A1 against its plain PyTorch version on the (table, idx, found, W)
   of each of the 21 sparse convs of one forward: f32 within atol/rtol 1e-4
   (TF32 off), bf16 (the main path's dtype) within rtol 1e-2 + 1e-2 of the
   layer's output scale; median kernel and plain times per layer shape;
4. main path: cap-occupancy audit, A1 launch count (21 per forward), 2
   warm-ups then 5 timed predicts (frames/s median/min/max), peak memory,
   finite outputs, a per-stage time breakdown, and a torch.profiler window
   (device busy time and idle share per predict, and the top kernels);
5. a small-input check: the same weights on the CPU (plain kernel versions)
   and on the card agree within the bf16 tier.

The last two lines of stdout are the card line and a JSON object; the line
before them is the kernels JSON.
"""
import json
import statistics
import subprocess
import time

import numpy as np
import torch

from cpd_tpu_torch.models.backbone3d import _SparseConvBN, build_branch_rulebooks, stage_grids
from cpd_tpu_torch.models.bev import height_compression
from cpd_tpu_torch.models.detector import VoxelRCNN, keys_from_frame
from cpd_tpu_torch.ops import gather_gemm as a1
from cpd_tpu_torch.ops.voxelizer import voxelize_batch
from cpd_tpu_torch.utils.synthetic import make_lidar_frame
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


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


def seeded_model(cfg, seed, device):
    model = VoxelRCNN(**cfg)
    model.load_state_dict(seeded_state_dict(model, seed), strict=True)
    return model.eval().to(device)


def capture_conv_operands(model, batch):
    """Kernel A1's operands of every sparse conv in one forward, in order."""
    captured = []

    def hook(module, args):
        features, rulebook = args
        k, cin, cout = module.weight.shape
        cd = module.compute_dtype
        captured.append((module.name, features.to(cd).contiguous(), rulebook.idx,
                         rulebook.found, module.weight.to(cd).reshape(k * cin, cout)))

    handles = []
    for name, m in model.named_modules():
        if isinstance(m, _SparseConvBN):
            m.name = name
            handles.append(m.register_forward_pre_hook(hook))
    with torch.no_grad():
        model(batch)
    for h in handles:
        h.remove()
    return captured


def paired_median_ms(fn_a, fn_b, reps=7):
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


def check_kernel(convs):
    """Kernel A1 against its plain version on each conv's operands. Returns
    the largest bf16 error and the per-shape times."""
    max_err = 0.0
    shapes = {}
    for name, table, idx, found, w in convs:
        # f32 operands: the kernel's arithmetic against the plain version
        t32, w32 = table.float(), w.float()
        out = a1.gather_gemm(t32, idx, found, w32)
        ref = a1.gather_gemm_reference(t32, idx, found, w32)
        torch.cuda.synchronize()
        err32 = (out - ref).abs().max().item()
        if not torch.allclose(out, ref, rtol=1e-4, atol=1e-4):
            raise AssertionError(f"A1 f32 mismatch at {name}: max err {err32}")
        # bf16 operands and output, as the main path runs it, against the
        # plain version's f32 result: within the output's bf16 rounding
        out = a1.gather_gemm(table, idx, found, w, out_dtype=torch.bfloat16).float()
        ref = a1.gather_gemm_reference(table, idx, found, w)
        torch.cuda.synchronize()
        err = (out - ref).abs()
        bound = 1e-2 * ref.abs() + 1e-2 * max(ref.abs().max().item(), 1e-3)
        if not bool((err <= bound).all()):
            raise AssertionError(f"A1 bf16 mismatch at {name}: max err {err.max().item()}")
        max_err = max(max_err, err.max().item())
        b, n, k = idx.shape
        key = (n, k, table.shape[-1], w.shape[-1])
        if key not in shapes:
            ms, plain_ms = paired_median_ms(
                lambda: a1.gather_gemm(table, idx, found, w, torch.bfloat16),
                lambda: a1.gather_gemm_reference(table, idx, found, w, torch.bfloat16))
            shapes[key] = dict(layer=name, rows=n, taps=k, cin=table.shape[-1],
                               cout=w.shape[-1], ms=ms, plain_ms=plain_ms)
        shapes[key]["count"] = shapes[key].get("count", 0) + 1
        print(f"A1 {name}: N={n} K={k} Cin={table.shape[-1]} Cout={w.shape[-1]} "
              f"found={found.float().mean().item():.3f} f32 max err {err32:.3e}, "
              f"bf16 max err {err.max().item():.3e} (output scale "
              f"{ref.abs().max().item():.3e})")
    return max_err, list(shapes.values())


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


def device_profile(model, batch, predict_ms, loops=3):
    """torch.profiler over ``loops`` predicts: device busy ms per predict (the
    union of kernel intervals), the idle share against the unprofiled
    ``predict_ms``, device ops per predict, and the top kernels."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(loops):
            model.predict(batch)
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
    print(f"profile: {wall:.2f} ms per predict under the profiler, device busy {busy:.2f} ms "
          f"per predict, idle share {1 - busy / predict_ms:.3f} of the unprofiled "
          f"{predict_ms:.2f} ms, {len(spans) // loops} device ops per predict")
    for name, ms in sorted(kernels.items(), key=lambda kv: -kv[1])[:8]:
        print(f"  {ms:8.3f} ms  {name[:100]}")


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


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA card; none is available")
    card = card_line()
    print(f"card: {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    secs = a1.build(verbose=True)
    print(f"A1 build: {secs:.1f} s compiling ({time.perf_counter() - t0:.1f} s in all)",
          flush=True)

    dev = torch.device("cuda")
    model = seeded_model(BENCH, 0, dev)
    pts, valid = make_lidar_frame(np.random.default_rng(0), N_POINTS)
    batch = {"points": torch.from_numpy(pts)[None].to(dev),
             "points_valid": torch.from_numpy(valid)[None].to(dev)}
    cap_audit(model, batch)

    convs = capture_conv_operands(model, batch)
    if len(convs) != A1_PER_FORWARD:
        raise AssertionError(f"captured {len(convs)} sparse convs, want {A1_PER_FORWARD}")
    max_err, shape_times = check_kernel(convs)
    for s in shape_times:
        print(f"A1 shape {s['layer']} x{s['count']}: N={s['rows']} K={s['taps']} "
              f"Cin={s['cin']} Cout={s['cout']}: kernel {s['ms']:.4f} ms, "
              f"plain {s['plain_ms']:.4f} ms (medians of 7, run in turns, bf16)")
    del convs

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
    device_profile(model, batch, 1e3 / statistics.median(fps))

    small_input_check()

    print(json.dumps({"kernels": [{
        "name": "gather_gemm", "route": "cuda",
        "source": "cpd_tpu_torch/csrc/gather_gemm.cu",
        "replaces": "cpd_tpu/ops/pallas_conv.py:77",
        "launches": launches, "max_abs_err": max_err,
        "ms": sum(s["ms"] * s["count"] for s in shape_times),
        "plain_ms": sum(s["plain_ms"] * s["count"] for s in shape_times),
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
