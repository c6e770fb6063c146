"""Smoke run of the PyTorch port on one CUDA card (an NVIDIA H100).

    python3 chip_smoke.py
    python3 chip_smoke.py --determinism RUNS [--no-cudnn]   # phase 13 alone

Drives the port's paths at the bench configuration of the JAX package
(bench.py: 3 classes, range +-75.2 x [-2, 4] m, voxels (0.1, 0.1, 0.15) m,
grid 1504 x 1504 x 41, voxel cap 90k, stage caps (80k, 48k, 24k, 20k), 200
test RoIs) on 200k-point synthetic lidar frames, with weights drawn from a
seed: ``cpd_tpu_torch.models.detector.VoxelRCNN.predict`` (batch 1, MM
branch off) with the dense backbone tail, as bench.py runs it, and with the
sparse tail; the evaluation CLI ``cpd_tpu_torch.tools.test`` and the
training CLI ``cpd_tpu_torch.tools.train`` on the shipped
voxel_rcnn_cproto_center.yaml (batch 4, 8 written frames); the anchor-head
models of the DBSCAN, OYSTER and PointPillars yamls (predict, a batch-2
step, the training CLI on OYSTER); the pseudo-label factory's builder
(PPScore, MFCF + C_PROTO labels, the gt database) on a written 20-frame
drive and the training CLI on its labels; the training step
of ``cpd_tpu_torch.parallel``
(``VoxelRCNN.loss_step`` with ``mm=True``, batch 2, 64 label slots, backward,
clip, adam_onecycle; sparse tail); and the gather-formulation probes of
``cpd_tpu_torch.probes.gather`` at the probe scripts' own sizes. Phases, each
raising on failure:

1. card: needs CUDA; prints the card's name and power limit;
2. build: compiles every kernel source under cpd_tpu_torch/csrc/ (A1, A2,
   G1-G4, R1, R2) with nvcc for sm_90a, one process each, side by side, and prints
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
8. the evaluation CLI, ``cpd_tpu_torch.tools.test.main``, as a user runs it:
   the shipped tools/cfgs/models/voxel_rcnn_cproto_center.yaml at full width
   (``build_network``; MM weights present, off in eval), a checkpoint that
   ``save_checkpoint`` wrote from seeded weights (it must load back into a
   fresh model bit-equal), and a Waymo-layout sequence of 8 frames of 200k
   points written to a temporary directory (gt boxes in its infos; the
   pseudo-labels are drawn, their factory is not ported), read by the
   port's WaymoUnsupervisedDataset and threaded loader at the yaml's eval
   batch of 4. Before the CLI runs: the cap audit at batch 4 with the yaml's
   caps, and A1 against its plain version on the 21 convs of one batch-4
   forward. Then the CLI: 21 A1 launches a batch (42), one finite detection
   record a frame, result.pkl written, the AP/APH and recall keys in its
   result; its own frames/s beside ``predict`` alone on the same batches
   (the difference is the data layer's host cost), and the phase's seconds;
9. the training CLI, ``cpd_tpu_torch.tools.train.main``, as a user runs it:
   the same yaml at full width (MM on, adam_onecycle) on 8 written frames
   with prototype banks (the ``points1`` view), batch 4, two steps an
   epoch. Before the CLI runs: the cap audit of a batch-4 training batch,
   both views, and A1 forward, A1 as dX and A2 against their plain versions
   on the operands of one batch-4 step of the CLI's model, times per layer
   shape, and ``make_train_step`` alone on the same batches on the card.
   Then three calls: A ``--epochs 2 --debug_steps 2`` (stops after epoch
   0), A ``--epochs 2 --eval_after 1`` (auto-resumes; evaluates
   checkpoint_epoch_1), B ``--epochs 2``. Gates: A's checkpoint_epoch_1
   equal to B's bit for bit, 2 + 2 and 4 steps, every step's launches
   those of the first (A1 35 + 33, A2 35), finite losses with
   ``proto_loss``, no step skipped, one metrics.jsonl record a logged step,
   one finite detection record a frame, B's last checkpoint stripped by
   ``tools.strip_checkpoint`` gives the same predict outputs and result.pkl
   bit for bit, and ``tools.merge_detections`` of that result.pkl with the
   sequence's labelled boxes (twice: each has a twin) fuses on the card
   into input boxes. Prints the CLI's phase means (data, h2d, step),
   steps/s, each step's ms, the step alone, the training loader alone, the
   data layer's host share, peak memory and the phase's seconds;
10. the kernels of one training step on their real operands, recorded from a
   forward + backward: A1 forward (35 convs), A1 as dX (33) and A2 (35)
   against their plain versions, f32 (1e-4 of the output's scale: A2 sums
   up to 180,000 rows in another order) and bf16; times per layer shape;
11. training path, every step through ``make_train_step``: the launch counts
   of the first step (A1 35 forward + 33 dX, A2 35; the forward's share is
   read where that step's ``loss_step`` returns), a second warm-up, then 5
   timed steps (ms per step median/min/max, and the phases forward, backward,
   clip + update between CUDA events of those same steps), peak memory,
   finite losses with ``proto_loss`` among them, no skipped step, parameters
   of both branches moved, and a torch.profiler window of a step;
12. a small training step on the CPU and on the card, same weights, proposals
    and sampling uniforms: at f32 the losses agree to 1e-3 and the gradients
    to a cosine of 0.999; at bf16 (the main path's dtype), on a configuration
    whose BEV maps are 32 x 32 and 16 x 16, within a looser tier;
13. step determinism, a gate: one training step (loss_step + backward under
    ``deterministic_cudnn``, as ``make_train_step`` runs it) three times in one
    process from the same state, the third under
    ``torch.use_deterministic_algorithms``: every forward tensor and gradient
    bit-identical to the first run's; reported beside it, two runs without
    the scope and the scope's cost in ms and device busy ms. With
    ``--determinism RUNS`` only the build and this phase run, with RUNS runs
    under the scope (``--no-cudnn``: the scope turns cuDNN off instead);
14. the anchor-head models at full width (it runs right after phase 9): (a)
    the DBSCAN VoxelRCNN yaml as shipped (AnchorHeadSingleV2 with its
    point-density anchor mask, VoxelRCNNHead, MM off, 150k voxels, stage
    caps 80k / 40k / 20k / 20k, 212,064 anchors) on the bench frame: cap
    audit, A1 against its plain version on the 21 convs of its forward,
    predict (21 A1 launches, none of A2; 2 warm-ups then 3 timed; frames/s,
    peak memory, the stage breakdown with the proposal layer in parts:
    decode, top 4096, rotated IoU + NMS and the memory it adds at its peak;
    profiler window), the card against the CPU on a small input, then a
    batch-2 training step on labels moved onto its own proposals: A1
    forward, A1 as dX and A2 against their plain versions on its operands,
    the step bit-identical twice under ``deterministic_cudnn``, launches
    (21, 20, 21) through ``make_train_step``, finite anchor losses, 3 timed
    steps, peak memory, profiler window, and the dense head's forward, loss
    and backward alone on a detached BEV map with and without the scope;
    (b) the PointPillars yaml with its
    range widened to +-75.52 m (472 pillars a side: at +-75.2 m its BEV
    pyramid does not concatenate, in the JAX package either): pillar
    occupancy against the 32k cap, predict and a batch-2 step with no A1 or
    A2 launch, the same measurements and gates; (c) the training CLI on the
    OYSTER yaml as shipped: 4 written frames with OYSTER prototype banks and
    a written DB_INFO_PATH pickle (gt_sampling must paste objects), batch 2,
    ``--epochs 1 --debug_steps 2 --eval_after 1``: 2 steps of (21, 20, 21)
    launches, finite losses, result.pkl one finite record a frame; the CLI's
    phase means and each step's ms.
15. the pseudo-label factory on the card (it runs right after phase 14), as
    the builder CLI runs it: a drive of 20 frames of 200k points
    (``make_lidar_sequence``: the ego about 1 m a frame, parked and moving
    objects; depth cut from Waymo's ~198 frames) written with poses and no
    labels; kernel R1 (PPScore's radius count) against its plain version on
    the middle frame's 4 windows of 5 frames (exact counts, a second launch
    bit-equal); ``create_ppscore`` with the R1 and R2 launches counted
    around it (20 and 0); ``create_outline_boxes`` with the cproto dataset
    yaml (MFCF + C_PROTO; R2 launches counted, none of R1), the largest
    cloud it clusters recorded; kernel R2 (DBSCAN) against its plain version
    on that cloud (labels equal, twice); ``create_track_groundtruth_database``
    on the port's dataset. Gates: every frame's PPScore file (f16, finite),
    labels of every frame with (n, 7) finite boxes, a track of
    ``remove_short_track`` (2) frames or more, a prototype bank, the gt
    database's schema. Prints boxes a frame, tracks, banks, the launches and
    the seconds of each builder function and of each stage inside them;
    then 2 steps of the training CLI on the shipped cproto yaml on those
    labels and banks (finite losses).

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
alone, where it is ``torch.index_select``'s time. R1 and R2 (phase 15) give
the launches of ``create_ppscore`` and ``create_outline_boxes``, the median
ms of the launch alone (``ms``) and of the whole wrapper with its grid and
sorts (``wrapper_ms``), the plain version's ms of one call at the checked
shapes, and a bound from those inputs: bytes at 3.35 TB/s against the pairs
the function needs at 8 operations each (R1: the neighbour pairs its counts
hold; R2: the pairs within eps, each once, f64) over the CUDA cores' 67
TFLOP/s f32 (34 f64), not the kernels' own walks, which test 3-6 times as
many; ``library_ms`` is null (no PyTorch call computes either function).
"""
import argparse
import ast
import json
import logging
import math
import pickle
import re
import statistics
import subprocess
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from cpd_tpu_torch.config import ConfigDict, cfg_from_list, cfg_from_yaml_file
from cpd_tpu_torch.datasets import build_dataloader
from cpd_tpu_torch.datasets.box_np import points_in_boxes_mask_fast
from cpd_tpu_torch.datasets.registry import build_dataset
from cpd_tpu_torch.models import build_network
from cpd_tpu_torch.models.backbone3d import build_branch_rulebooks, stage_grids
from cpd_tpu_torch.models.bev import height_compression
from cpd_tpu_torch.models.anchor_head import point_density_anchor_mask
from cpd_tpu_torch.models.detector import VoxelRCNN, keys_from_frame, set_compute_dtype
from cpd_tpu_torch.ops import cuda_build
from cpd_tpu_torch.ops import gather_gemm as a1
from cpd_tpu_torch.ops import gather_probes as gp
from cpd_tpu_torch.ops import sparse
from cpd_tpu_torch import parallel
from cpd_tpu_torch.ops import nms
from cpd_tpu_torch.ops import dbscan as r2
from cpd_tpu_torch.ops import radius as r1
from cpd_tpu_torch.ops.voxelizer import voxelize_batch
from cpd_tpu_torch.parallel import init_state, make_train_step, step_generator
from cpd_tpu_torch.probes import gather as probes
from cpd_tpu_torch.tools import merge_detections
from cpd_tpu_torch.tools import test as eval_cli
from cpd_tpu_torch.tools import train as train_cli
from cpd_tpu_torch.tools.strip_checkpoint import strip_checkpoint
from cpd_tpu_torch.tools.train import device_batch
from cpd_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from cpd_tpu_torch.utils.common import PhaseTimer
from cpd_tpu_torch.utils.device import place
from cpd_tpu_torch.utils.yaml_subset import load_file
from cpd_tpu_torch.datasets import waymo_unsupervised as builder
from cpd_tpu_torch.unsupervised import outline
from cpd_tpu_torch.unsupervised.ppscore import frame_windows
from cpd_tpu_torch.utils.synthetic import (make_lidar_frame, make_lidar_sequence,
                                           make_tiny_train_batch,
                                           make_train_batch, write_gt_database,
                                           write_waymo_sequence)
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
# the eval-CLI phase: the shipped yaml at full width, its eval batch (4) and
# a written sequence of 8 frames, every frame kept (the yaml keeps every 10th)
EVAL_YAML = "tools/cfgs/models/voxel_rcnn_cproto_center.yaml"
DBSCAN_YAML = "tools/cfgs/models/voxel_rcnn_dbscan_single_train.yaml"
OYSTER_YAML = "tools/cfgs/models/voxel_rcnn_oyster_single_train.yaml"
PILLAR_YAML = "tools/cfgs/models/pointpillar_dbscan_single_train.yaml"
# the pillar yaml's one cut: +-75.52 m, 472 pillars a side, the least widening
# whose BEV pyramid concatenates (at its own +-75.2 m: 235, 236, 236)
PILLAR_SETS = ["DATA_CONFIG.POINT_CLOUD_RANGE", "[-75.52,-75.52,-2.0,75.52,75.52,4.0]"]
# one training step of the sparse tail with MM off: A1 21 forward + 20 dX (the
# input conv's features need no gradient), A2 21
ANCHOR_A1_FORWARD, ANCHOR_A1_DX, ANCHOR_A2 = 21, 20, 21
ANCHOR_TIMED_LOOPS = 3
OYSTER_FRAMES = 4
EVAL_FRAMES = 8
EVAL_SEQ = "segment-0000"
# phase 15, the pseudo-label factory: a drive of 20 frames at the full frame
# width, the cproto dataset yaml, f32 / f64 peaks of the CUDA cores
FACTORY_FRAMES = 20
# phase 15's gates on the factory's output: the share of label boxes that
# hold a point of their own frame, the margin (m) around a class's largest
# label box that holds its prototype banks' points, and the RoI and proto
# losses of 2 training steps at random weights (on labels placed on the
# proposals, phase 9, the same model reads at most 86)
FACTORY_BOXES_WITH_POINTS = 0.99
FACTORY_BANK_MARGIN = 0.5
FACTORY_LOSS_BOUND = 1e3
FACTORY_LOSS_BOUNDED = ("rcnn_reg0", "rcnn_reg1", "proto_loss", "rcnn_cls0", "rcnn_cls1")
CPROTO_DATA_YAML = "tools/cfgs/dataset_configs/waymo_unsupervised_cproto.yaml"
F32_CORE_FLOPS = 67e12   # H100 SXM, f32 outside the tensor cores (NVIDIA's H100 data sheet)
F64_CORE_FLOPS = 34e12   # H100 SXM, f64 outside the tensor cores (NVIDIA's H100 data sheet)


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


def labels_on_proposals(model, batch, n_labelled, props=None):
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
    not affected. ``props``: proposals to use instead of the CenterHead's."""
    props = training_proposals(model, batch) if props is None else props
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


def train_kernel_checks(model, batch, generator,
                        want=(TRAIN_A1_FORWARD, TRAIN_A1_DX, TRAIN_A2)):
    """Record one forward + backward's kernel operands and hold every kernel
    use against its plain version on them; ``want``: the launches of A1
    forward, A1 as dX and A2. Returns {use: (max err, shapes)}."""
    model.train()
    with KernelRecorder() as rec:
        loss, _ = model.loss_step(batch, generator=generator)
        rec.in_backward = True
        loss.backward()
    torch.cuda.synchronize()
    model.zero_grad(set_to_none=True)
    counts = {k: len(v) for k, v in rec.calls.items()}
    want = dict(zip(("forward", "dx", "dw"), want))
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
    """Phase 13, a gate. One training step (loss_step and backward, the bench
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


class LogLines(logging.Handler):
    """Keeps the messages of the port's logger while attached."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def write_eval_sequence(root, protos=False):
    """8 frames of ``make_lidar_frame`` at 200k points in the processed Waymo
    layout, with gt boxes in the infos and pseudo-labels drawn the same way
    (``protos``: and prototype banks, for the ``points1`` view of training):
    the pseudo-label factory that writes <seq>_outline_C_PROTO.pkl is not
    ported yet."""
    frames = [make_lidar_frame(np.random.default_rng(i), N_POINTS)[0] for i in range(EVAL_FRAMES)]
    write_waymo_sequence(root, EVAL_SEQ, frames, seed=0, n_boxes=8, protos=protos)


def eval_cli_phase(dev, card):
    """The evaluation entry point at full width: ``cpd_tpu_torch.tools.test.main``
    on the shipped yaml, a checkpoint written by ``save_checkpoint`` and a
    written Waymo sequence of 8 frames, batch 4. Gates: the checkpoint round
    trip is bit-equal; the caps of the yaml hold at batch 4; A1 against its
    plain version on the 21 convs of one batch-4 forward; 21 A1 launches a
    batch in the CLI's run; one detection record a frame with finite boxes
    and scores; result.pkl written; the result dict holds the AP and recall
    keys. Returns the kernels-line entry of A1 on this path."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        write_eval_sequence(tmp)
        sets = ["DATA_CONFIG.DATA_PATH", str(tmp), "DATA_CONFIG.SAMPLED_INTERVAL.test", "1"]
        cfg = cfg_from_list(sets, cfg_from_yaml_file(EVAL_YAML, ConfigDict()))
        batch_size = int(cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU)
        n_batches = math.ceil(EVAL_FRAMES / batch_size)

        model = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), cfg.DATA_CONFIG)
        model.load_state_dict(seeded_state_dict(model, 0), strict=True)
        ckpt = save_checkpoint(tmp / "ckpt", model, 0)
        fresh = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), cfg.DATA_CONFIG)
        load_checkpoint(ckpt, fresh)
        sd, back = model.state_dict(), fresh.state_dict()
        if set(sd) != set(back) or not all(torch.equal(sd[k], back[k]) for k in sd):
            raise AssertionError("eval CLI: the checkpoint round trip changed the state dict")
        print(f"eval CLI: checkpoint {ckpt.name} ({ckpt.stat().st_size / 2**20:.1f} MiB, "
              f"{len(sd)} tensors) loads back bit-equal", flush=True)

        # the CLI's own dataset and loader, for the gates on one batch-4 forward
        dataset = build_dataset(cfg.DATA_CONFIG, cfg.CLASS_NAMES, False, str(tmp))
        _, loader, _ = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, batch_size,
                                        training=False, dataset=dataset)
        t1 = time.perf_counter()
        host_batches = list(loader)
        loader_s = time.perf_counter() - t1
        t1 = time.perf_counter()
        batches = [device_batch(b, dev) for b in host_batches]
        torch.cuda.synchronize()
        copy_s = time.perf_counter() - t1
        model = place(fresh.eval(), dev)
        cap_audit(model, batches[0])
        convs = recorded_forward(model, batches[0])
        max_err, shape_times = check_kernel("A1 eval CLI", convs, a1_kernel, a1_plain,
                                            torch.bfloat16)
        del convs

        logger = logging.getLogger("cpd_tpu_torch")
        lines = LogLines()
        logger.addHandler(lines)
        out_dir = tmp / "eval"
        argv = ["--cfg_file", EVAL_YAML, "--ckpt", str(ckpt), "--output_dir", str(out_dir),
                "--set", *sets]
        try:
            torch.cuda.synchronize()
            a1.gather_gemm.launches = 0
            result = eval_cli.main(argv)
            torch.cuda.synchronize()
            launches = a1.gather_gemm.launches
        finally:
            logger.removeHandler(lines)
        want = A1_PER_FORWARD[False] * n_batches
        if launches != want:
            raise AssertionError(f"eval CLI: A1 launched {launches} times, want {want} "
                                 f"(21 x {n_batches} batches): off by {launches - want}")
        with open(out_dir / "result.pkl", "rb") as f:
            det_annos = pickle.load(f)
        want_ids = [f"{EVAL_SEQ}#{i:04d}" for i in range(EVAL_FRAMES)]
        if [a["frame_id"] for a in det_annos] != want_ids:
            raise AssertionError(f"eval CLI: detections for {[a['frame_id'] for a in det_annos]}, "
                                 f"want {want_ids}")
        for a in det_annos:
            if not (np.isfinite(a["boxes_lidar"]).all() and np.isfinite(a["score"]).all()):
                raise AssertionError(f"eval CLI: non-finite detections in {a['frame_id']}")
        keys = {f"{c}_{lv}/{m}" for c in cfg.CLASS_NAMES for lv in ("L1", "L2")
                for m in ("AP", "APH")} | {"recall_0.3", "recall_0.5", "recall_0.7", "gt_count"}
        if set(result) != keys:
            raise AssertionError(f"eval CLI: result keys {sorted(result)}, want {sorted(keys)}")
        fps_line = next((ln for ln in lines.lines if ln.startswith("eval: ")), "")
        m = re.match(r"eval: (\d+) frames in ([\d.]+)s \(([\d.]+) f/s\)", fps_line)
        if not m or int(m.group(1)) != EVAL_FRAMES:
            raise AssertionError(f"eval CLI: no frames/s line for {EVAL_FRAMES} frames: {fps_line!r}")
        cli_fps = float(m.group(3))

        # predict alone on the same batches, already on the card: the loader,
        # the host copies and the detection records taken out
        model.predict(batches[0])
        runs = []
        for _ in range(3):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            for b in batches:
                model.predict(b)
            torch.cuda.synchronize()
            runs.append(EVAL_FRAMES / (time.perf_counter() - t1))
        predict_fps = statistics.median(runs)
        n_det = sum(len(a["score"]) for a in det_annos)
        print(f"eval CLI ({card}): {EVAL_FRAMES} frames, batch {batch_size}, {launches} A1 "
              f"launches, {n_det} detections, result.pkl written; CLI {cli_fps:.2f} frames/s "
              f"(its own log line: {fps_line!r}), predict alone on the same batches "
              f"{predict_fps:.3f} frames/s (median of 3 runs over both batches: "
              f"{', '.join(f'{r:.3f}' for r in runs)}); the data layer and the detection "
              f"records take {1 - cli_fps / predict_fps:.1%} of the CLI's time")
        print(f"eval CLI host side ({card}): the loader alone {loader_s * 1e3:.1f} ms for "
              f"{EVAL_FRAMES} frames ({loader_s / EVAL_FRAMES * 1e3:.1f} ms a frame: read, "
              f"encode, range mask, pad, collate), their copies to the card "
              f"{copy_s * 1e3:.1f} ms (pinned, {n_batches} batches)")
        print("eval CLI result: " + ", ".join(f"{k}={v:.4f}" for k, v in sorted(result.items())))
    print(f"eval CLI phase: {time.perf_counter() - t0:.1f} s ({card})", flush=True)
    return kernel_entry("gather_gemm", "eval CLI, batch 4", "cpd_tpu_torch/csrc/gather_gemm.cu",
                        "cpd_tpu/ops/pallas_conv.py:77", launches, max_err, shape_times)


class CLISteps:
    """Reads the training CLI's own steps from inside: while it is active,
    every train step that ``parallel.make_train_step`` hands out (the CLI
    looks it up there) records its run's tag, its A1 and A2 launches split
    where its ``loss_step`` returns (forward, dX, A2, A2 in the forward), its
    host ms (synchronised) and its tb as numbers. One row per step."""

    def __init__(self):
        self.rows = []
        self.run = None

    def __enter__(self):
        self.saved = parallel.make_train_step, VoxelRCNN.loss_step
        make, loss_step = self.saved
        rows = self.rows

        def counts():
            return a1.gather_gemm.launches, a1.gather_gemm_dw.launches

        def counted_loss_step(model, *args, **kwargs):
            out = loss_step(model, *args, **kwargs)
            rows[-1]["forward"] = counts()
            return out

        def counted_make_train_step():
            step = make()

            def counted_step(state, batch, generator=None, sampling_uniforms=None):
                rows.append({"run": self.run, "start": counts()})
                t0 = time.perf_counter()
                state, tb = step(state, batch, generator, sampling_uniforms)
                torch.cuda.synchronize()
                row = rows[-1]
                (s1, s2), (f1, f2), (e1, e2) = row["start"], row["forward"], counts()
                row.update(launches=(f1 - s1, e1 - f1, e2 - s2, f2 - s2),
                           ms=(time.perf_counter() - t0) * 1e3,
                           tb={k: float(v) for k, v in tb.items()})
                return state, tb
            return counted_step

        parallel.make_train_step, VoxelRCNN.loss_step = counted_make_train_step, counted_loss_step
        return self

    def __exit__(self, *exc):
        parallel.make_train_step, VoxelRCNN.loss_step = self.saved


def _ckpt_difference(path_a, path_b):
    """The first tensor (model, then optimizer state) or number in which two
    checkpoints differ, or None where they are equal bit for bit."""
    a, b = (torch.load(p, map_location="cpu", weights_only=True) for p in (path_a, path_b))
    for key in ("epoch", "it"):
        if a[key] != b[key]:
            return f"{key}: {a[key]} vs {b[key]}"
    if set(a["model_state"]) != set(b["model_state"]):
        return "model_state keys"
    for k, v in a["model_state"].items():
        if not torch.equal(v, b["model_state"][k]):
            return f"model_state[{k!r}]"
    oa, ob = a["optimizer_state"], b["optimizer_state"]
    if oa["count"] != ob["count"] or oa["param_groups"] != ob["param_groups"]:
        return f"optimizer count {oa['count']} vs {ob['count']} or its param groups"
    if set(oa["state"]) != set(ob["state"]):
        return "optimizer_state keys"
    for k, st in oa["state"].items():
        for name, v in st.items():
            if not torch.equal(v, ob["state"][k][name]):
                return f"optimizer_state[{k}][{name!r}]"
    return None


def cudnn_off_runs_agree(model, batch, generator_seed, dev):
    """Two loss_step + backward runs from the same state with cuDNN off:
    None where every gradient agrees bit for bit, else the first that
    differs (tells cuDNN's engines from the machine, as phase 13 does)."""
    start = {k: v.detach().clone() for k, v in model.state_dict().items()}
    runs = []
    for _ in range(2):
        model.load_state_dict(start, strict=True)
        model.train().zero_grad(set_to_none=True)
        with torch.backends.cudnn.flags(enabled=False):
            loss, _ = model.loss_step(batch, generator=step_generator(generator_seed, 0, dev))
            loss.backward()
        torch.cuda.synchronize()
        runs.append([(n, p.grad.clone()) for n, p in model.named_parameters()
                     if p.grad is not None])
    return next((n for (n, x), (_, y) in zip(*runs) if not torch.equal(x, y)), None)


def _phase_means(lines):
    """{run's last epoch line: (steps, steps/s, {phase: mean s})} from the
    CLI's epoch log lines."""
    found = [re.match(r"epoch \d+ done in [\d.]+s \((\d+) steps, ([\d.]+) steps/s\); phase "
                      r"means: (\{.*\})", ln) for ln in lines]
    return [(int(m.group(1)), float(m.group(2)), ast.literal_eval(m.group(3)))
            for m in found if m]


def train_cli_phase(dev, card):
    """The training entry point at full width, as a user runs it:
    ``cpd_tpu_torch.tools.train.main`` on the shipped yaml (MM on, voxel cap
    150k, stage caps 80k / 40k / 20k / 20k, adam_onecycle) and a written
    Waymo sequence of 8 frames of 200k points with prototype banks, batch 4:
    two steps an epoch. Before the CLI: the cap audit of a batch-4 training
    batch (``points`` and the ``points1`` view), and A1 forward, A1 as dX
    and A2 against their plain versions on the operands of one batch-4 step
    of the CLI's model. Then three calls: A (a) ``--epochs 2 --debug_steps 2``
    (stops after epoch 0: ``--epochs`` sets the one-cycle schedule's length),
    (b) ``--epochs 2 --eval_after 1`` (auto-resumes, then evaluates
    checkpoint_epoch_1 through the eval CLI), B ``--epochs 2`` unbroken.
    Gates: A's and B's checkpoint_epoch_1 equal bit for bit; 2 + 2 and 4
    steps; every step's A1 (forward, dX) and A2 launches those of the first
    (35, 33, 35); finite losses with ``proto_loss``, no step skipped; one
    metrics.jsonl record a logged step; the eval's result.pkl one finite
    record a frame; B's last checkpoint stripped gives the same predict
    outputs and result.pkl bit for bit; ``merge_detections`` of that
    result.pkl and the sequence's labelled boxes (twice) fuses on the card,
    every fused box an input box within 1e-5. Returns the kernels-line
    entries of the three kernel uses."""
    t0 = time.perf_counter()
    seed = train_cli.parse_args(["--cfg_file", EVAL_YAML]).seed
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        write_eval_sequence(tmp, protos=True)
        sets = ["DATA_CONFIG.DATA_PATH", str(tmp), "DATA_CONFIG.SAMPLED_INTERVAL.train", "1",
                "DATA_CONFIG.SAMPLED_INTERVAL.test", "1"]
        cfg = cfg_from_list(sets, cfg_from_yaml_file(EVAL_YAML, ConfigDict()))
        batch_size = int(cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU)
        steps_per_epoch = EVAL_FRAMES // batch_size
        if (cfg.OPTIMIZATION.OPTIMIZER, cfg.MODEL.BACKBONE_3D.MM) != ("adam_onecycle", True):
            raise AssertionError("train CLI: the yaml no longer trains adam_onecycle with MM on")

        # epoch 0's batches in the CLI's order, and the CLI's model and weights
        dataset = build_dataset(cfg.DATA_CONFIG, cfg.CLASS_NAMES, True, str(tmp))
        _, loader, _ = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, batch_size,
                                        training=True, seed=seed, dataset=dataset)
        t1 = time.perf_counter()
        host_batches = list(loader)
        loader_s = time.perf_counter() - t1
        batches = [device_batch(b, dev) for b in host_batches]
        del host_batches
        model = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), cfg.DATA_CONFIG)
        model.load_state_dict(seeded_state_dict(model, seed), strict=True)
        state = init_state(model, cfg.OPTIMIZATION, steps_per_epoch * 2, device=dev)
        b0 = batches[0]
        cap_audit(model, b0)
        cap_audit(model, {"points": b0["points1"], "points_valid": b0["points1_valid"]})
        checks = train_kernel_checks(model, b0, step_generator(seed, 0, dev))

        # make_train_step alone on the same batches, already on the card
        train_step = make_train_step()
        state, _ = train_step(state, b0, step_generator(seed, state.step, dev))
        torch.cuda.synchronize()
        passes = []
        for _ in range(3):
            t1 = time.perf_counter()
            for b in batches:
                state, _ = train_step(state, b, step_generator(seed, state.step, dev))
            torch.cuda.synchronize()
            passes.append((time.perf_counter() - t1) / len(batches))
        step_alone = statistics.median(passes)
        del state, model
        torch.cuda.empty_cache()

        logger = logging.getLogger("cpd_tpu_torch")
        lines = LogLines()
        logger.addHandler(lines)
        calls = [("a", "A", ["--epochs", "2", "--debug_steps", str(steps_per_epoch),
                             "--fix_random_seed", "--log_every", "1"]),
                 ("b", "A", ["--epochs", "2", "--eval_after", "1"]),
                 ("c", "B", ["--epochs", "2", "--log_every", "2"])]
        states, logs, secs = {}, {}, {}
        try:
            with CLISteps() as steps:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                a1.gather_gemm.launches = a1.gather_gemm_dw.launches = 0
                for run, out, extra in calls:
                    steps.run, mark, t1 = run, len(lines.lines), time.perf_counter()
                    states[run] = train_cli.main(["--cfg_file", EVAL_YAML, "--output_dir",
                                                  str(tmp / out), *extra, "--set", *sets])
                    torch.cuda.synchronize()
                    secs[run], logs[run] = time.perf_counter() - t1, lines.lines[mark:]
                totals = a1.gather_gemm.launches, a1.gather_gemm_dw.launches
                peak = torch.cuda.max_memory_allocated()
        finally:
            logger.removeHandler(lines)

        # gates
        got = [r["run"] for r in steps.rows]
        want = ["a"] * steps_per_epoch + ["b"] * steps_per_epoch + ["c"] * 2 * steps_per_epoch
        if got != want or [states[r].step for r in "abc"] != [steps_per_epoch,
                                                             2 * steps_per_epoch,
                                                             2 * steps_per_epoch]:
            raise AssertionError(f"train CLI: steps by run {got}, want {want}; final steps "
                                 f"{[states[r].step for r in 'abc']}")
        if not any("auto-resumed from epoch 0" in ln for ln in logs["b"]):
            raise AssertionError("train CLI: the second call did not log its auto-resume")
        first = steps.rows[0]["launches"]
        if first != (TRAIN_A1_FORWARD, TRAIN_A1_DX, TRAIN_A2, 0) or any(
                r["launches"] != first for r in steps.rows):
            raise AssertionError(f"train CLI: (A1 forward, A1 dX, A2, A2 in the forward) per "
                                 f"step {[r['launches'] for r in steps.rows]}, want "
                                 f"{(TRAIN_A1_FORWARD, TRAIN_A1_DX, TRAIN_A2, 0)} every step")
        fwd, dx, a2 = (sum(r["launches"][i] for r in steps.rows) for i in range(3))
        eval_a1 = A1_PER_FORWARD[False] * math.ceil(EVAL_FRAMES / batch_size)
        if totals != (fwd + dx + eval_a1, a2):
            raise AssertionError(f"train CLI: the counters read (A1, A2) = {totals}, the steps "
                                 f"and the eval account for {(fwd + dx + eval_a1, a2)}")
        for r in steps.rows:
            bad = [k for k, v in r["tb"].items() if not math.isfinite(v)]
            if bad or "proto_loss" not in r["tb"] or r["tb"]["skipped_nonfinite"]:
                raise AssertionError(f"train CLI step of run {r['run']}: non-finite {bad}, tb "
                                     f"keys {sorted(r['tb'])}")
        diff = _ckpt_difference(tmp / "A" / "ckpt" / "checkpoint_epoch_1.pth",
                                tmp / "B" / "ckpt" / "checkpoint_epoch_1.pth")
        if diff is not None:
            model = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), cfg.DATA_CONFIG)
            load_checkpoint(tmp / "B" / "ckpt" / "checkpoint_epoch_0.pth", model)
            off = cudnn_off_runs_agree(place(model, dev), b0, seed, dev)
            raise AssertionError(f"train CLI: the resumed run's checkpoint_epoch_1 differs from "
                                 f"the unbroken run's, first at {diff}; two steps with cuDNN "
                                 f"off {'agree' if off is None else 'differ at ' + off}")
        # A logs every step of (a) (--debug_steps) and none of (b) (every 20th); B every 2nd
        for out, run_names, want_steps in (
                ("A", "ab", list(range(1, steps_per_epoch + 1))),
                ("B", "c", list(range(2, 2 * steps_per_epoch + 1, 2)))):
            with open(tmp / out / "metrics.jsonl") as f:
                recs = [json.loads(ln) for ln in f]
            logged = [int(m.group(1)) for run in run_names for ln in logs[run]
                      for m in [re.match(r"epoch \d+ it (\d+) ", ln)] if m]
            if not [r["step"] for r in recs] == logged == want_steps:
                raise AssertionError(f"train CLI {out}: metrics.jsonl steps "
                                     f"{[r['step'] for r in recs]}, logged steps {logged}")
        with open(tmp / "A" / "eval_epoch_1" / "result.pkl", "rb") as f:
            full = pickle.load(f)
        want_ids = [f"{EVAL_SEQ}#{i:04d}" for i in range(EVAL_FRAMES)]
        if [a["frame_id"] for a in full] != want_ids or not all(
                np.isfinite(a["boxes_lidar"]).all() and np.isfinite(a["score"]).all()
                for a in full):
            raise AssertionError(f"train CLI: the eval's result.pkl holds "
                                 f"{[a['frame_id'] for a in full]}, or non-finite detections")

        runs = {r: _phase_means(logs[r]) for r in "abc"}
        n_steps, _, means = runs["c"][-1]
        share = 1 - means["step"] / sum(means[k] for k in ("data", "h2d", "step"))
        print(f"train CLI ({card}): batch {batch_size}, {steps_per_epoch} steps an epoch, runs "
              f"(a) {secs['a']:.1f} s, (b) {secs['b']:.1f} s with its eval, (c) "
              f"{secs['c']:.1f} s; steps/s by epoch (a) {[e[1] for e in runs['a']]}, (b) "
              f"{[e[1] for e in runs['b']]}, (c) {[e[1] for e in runs['c']]}; the CLI's phase "
              f"means over run (c)'s {n_steps * len(runs['c'])} steps: "
              + ", ".join(f"{k} {v * 1e3:.1f} ms" for k, v in means.items()), flush=True)
        print(f"train CLI ({card}): make_train_step alone on the same {len(batches)} batches "
              f"on the card {step_alone * 1e3:.1f} ms a step (median of 3 passes: "
              f"{', '.join(f'{p * 1e3:.1f}' for p in passes)}); the data layer's host share "
              f"in training 1 - step / (data + h2d + step) = {share:.1%}; peak memory "
              f"{peak / 2**30:.2f} GiB; per step A1 {first[0]} forward + {first[1]} dX, A2 "
              f"{first[2]}; {len(steps.rows)} steps, {totals[0]} A1 launches with the eval's "
              f"{eval_a1}, {totals[1]} A2; the training loader alone {loader_s * 1e3:.1f} ms "
              f"for {EVAL_FRAMES} frames ({loader_s / EVAL_FRAMES * 1e3:.1f} ms a frame: read, "
              f"augment, prototypes, encode, pad, collate; {loader.num_threads} threads)",
              flush=True)
        print(f"train CLI ({card}): ms of each step inside the CLI, by call: " + "; ".join(
            f"({run}) " + ", ".join(f"{r['ms']:.1f}" for r in steps.rows if r["run"] == run)
            for run in "abc"), flush=True)
        for run in "abc":
            print(f"train CLI ({card}) run ({run}) log: " + " | ".join(
                ln for ln in logs[run]
                if re.match(r"(epoch \d+ |auto-resumed|model params)", ln)), flush=True)

        # the deploy checkpoint: the same weights, the same outputs. Four
        # steps on drawn labels leave the model detecting nothing (every
        # score under its threshold), so the raw predict outputs, kept slots
        # or not, are compared too
        last = tmp / "B" / "ckpt" / "checkpoint_epoch_1.pth"
        stripped = strip_checkpoint(last)
        models = []
        for path in (last, stripped):
            models.append(build_network(cfg.MODEL, len(cfg.CLASS_NAMES), cfg.DATA_CONFIG))
            load_checkpoint(path, models[-1])
        sd_full, sd_stripped = (m.state_dict() for m in models)
        if not all(torch.equal(v, sd_full[k]) for k, v in sd_stripped.items()):
            raise AssertionError("train CLI: the stripped checkpoint loads other weights")
        preds = [place(m.eval(), dev).predict(b0) for m in models]
        # bit for bit: slots that pred_valid leaves out may hold NaN
        differ = [k for k, v in preds[0].items() if not torch.equal(
            v.contiguous().view(torch.uint8), preds[1][k].contiguous().view(torch.uint8))]
        if differ:
            raise AssertionError(f"train CLI: the stripped checkpoint predicts other {differ}")
        del models, preds
        eval_cli.main(["--cfg_file", EVAL_YAML, "--ckpt", str(stripped), "--output_dir",
                       str(tmp / "deploy_eval"), "--set", *sets])
        with open(tmp / "deploy_eval" / "result.pkl", "rb") as f:
            again = pickle.load(f)
        same = len(again) == len(full) and all(
            a["frame_id"] == b["frame_id"] and all(np.array_equal(a[k], b[k]) for k in
                                                   ("boxes_lidar", "score", "name", "pred_labels"))
            for a, b in zip(again, full))
        if not same:
            raise AssertionError("train CLI: the stripped checkpoint's result.pkl differs from "
                                 "the full checkpoint's")
        n_deploy = sum(len(a["score"]) for a in again)

        # weighted box fusion on the card: the deploy result.pkl (it may hold
        # no box), and, as a detection file of well-formed boxes, the
        # sequence's labelled boxes with seeded scores, given twice so that
        # every box has an exact twin. The boxes a randomly weighted model
        # decodes are no stand-in: a 0.03 m wide sliver 100 km long has an f32
        # rotated IoU with itself near 0.06, and fusion (the JAX package's
        # arithmetic) leaves it out of its own cluster
        rng = np.random.default_rng(0)
        gt_annos = build_dataset(cfg.DATA_CONFIG, cfg.CLASS_NAMES, False,
                                 str(tmp)).collect_gt_annos()
        labelled = [{"frame_id": g["frame_id"], "name": g["name"],
                     "boxes_lidar": g["gt_boxes_lidar"].astype(np.float32),
                     "score": rng.uniform(0.1, 1.0, len(g["name"])).astype(np.float32)}
                    for g in gt_annos]
        with open(tmp / "labelled.pkl", "wb") as f:
            pickle.dump(labelled, f)
        n_in = sum(len(a["score"]) for a in labelled)
        fused_on = []
        wbf = nms.weighted_box_fusion

        def recorded_wbf(*args, **kwargs):
            out = wbf(*args, **kwargs)
            fused_on.append({t.device.type for t in out})
            return out
        nms.weighted_box_fusion = recorded_wbf
        inputs = [tmp / "deploy_eval" / "result.pkl"] + [tmp / "labelled.pkl"] * 2
        try:
            t1 = time.perf_counter()
            merged = merge_detections.main([str(tmp / "merged.pkl"), *map(str, inputs)])
            merge_s = time.perf_counter() - t1
        finally:
            nms.weighted_box_fusion = wbf
        with_boxes = sum(1 for a, b in zip(again, labelled) if len(a["score"]) + len(b["score"]))
        if len(fused_on) != with_boxes or any(d != {"cuda"} for d in fused_on):
            raise AssertionError(f"merge_detections fused on {fused_on}, want cuda for each of "
                                 f"the {with_boxes} frames with boxes")
        for m, a, b in zip(merged, again, labelled):
            if len(m["score"]) == 0:
                continue
            boxes = np.concatenate([a["boxes_lidar"].reshape(-1, 7), b["boxes_lidar"]])
            d = np.abs(m["boxes_lidar"][:, None, :] - boxes[None, :, :])
            d[..., 6] = np.abs((d[..., 6] + np.pi) % (2 * np.pi) - np.pi)
            if not (d.max(-1).min(-1) <= 1e-5).all():
                raise AssertionError(f"merge_detections: a fused box of {m['frame_id']} is no "
                                     f"survivor of the input (off by {d.max(-1).min(-1).max()})")
        n_merged = sum(len(m["score"]) for m in merged)
        if n_merged > n_deploy + n_in or n_merged < 1:
            raise AssertionError(f"merge_detections kept {n_merged} boxes of {n_deploy} + 2 x "
                                 f"{n_in} that pair")

    print(f"train CLI ({card}): resume bit-equal; the stripped checkpoint's predict outputs and "
          f"result.pkl ({n_deploy} detections) equal the full one's; merge_detections fused "
          f"them with 2 x {n_in} labelled boxes on the card in "
          f"{merge_s:.2f} s into {n_merged}", flush=True)
    print(f"train CLI phase: {time.perf_counter() - t0:.1f} s ({card})", flush=True)
    src1, src2 = "cpd_tpu_torch/csrc/gather_gemm.cu", "cpd_tpu_torch/csrc/gather_gemm_dw.cu"
    return [
        kernel_entry("gather_gemm", "train CLI, batch 4", src1, "cpd_tpu/ops/pallas_conv.py:77",
                     fwd, *checks["forward"]),
        kernel_entry("gather_gemm (dX)", "train CLI, batch 4", src1,
                     "cpd_tpu/ops/pallas_conv.py:77", dx, *checks["dx"]),
        kernel_entry("gather_gemm_dw", "train CLI, batch 4", src2,
                     "cpd_tpu/ops/pallas_conv.py:130", a2, *checks["dw"]),
    ]


def yaml_model(path, sets, seed, dev):
    """(config, model) of a shipped model yaml with ``sets``, seeded weights,
    in eval mode on ``dev``."""
    cfg = cfg_from_list(list(sets), cfg_from_yaml_file(path, ConfigDict()))
    model = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), cfg.DATA_CONFIG)
    model.load_state_dict(seeded_state_dict(model, seed), strict=True)
    return cfg, place(model.eval(), dev)


def anchor_proposals_of(model, batch):
    """The proposals of a training-mode forward of an anchor model (batch
    statistics, ``num_rois`` of them), without its RoI head, under no_grad."""
    model.train()
    with_roi, model.with_roi_head = model.with_roi_head, False
    try:
        with torch.no_grad():
            out = model(batch)
    finally:
        model.with_roi_head = with_roi
    return {k: out[k] for k in ("rois", "roi_scores", "roi_labels", "roi_valid")}


def anchor_stage_breakdown(model, batch):
    """Host-clock ms per stage of one anchor-model forward, synchronising
    after each; the proposal layer in its parts (decode of every anchor, the
    top ``NMS_PRE_MAXSIZE`` per sample, rotated IoU + NMS per sample), and
    the device memory that the IoU + NMS part adds at its peak."""
    times, state = {}, {}

    def step(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state[name] = fn()
        torch.cuda.synchronize()
        times[name] = (time.perf_counter() - t0) * 1e3

    n_rois = model.num_rois_test
    rpn = dict(model.rpn_nms, NMS_POST_MAXSIZE=n_rois)
    with torch.no_grad():
        if model.pillars:
            step("pillars", lambda: model._pillar_bev(batch["points"], batch["points_valid"]))
            bev_in, backbone_out = state["pillars"], {}
        else:
            step("voxelize", lambda: voxelize_batch(batch["points"], model.vox_spec,
                                                    batch["points_valid"]))
            keys = keys_from_frame(state["voxelize"], model.grid)
            step("rulebooks", lambda: build_branch_rulebooks(keys, model.grid,
                                                             model.backbone.caps))
            step("sparse_convs", lambda: model.backbone.branch0(state["voxelize"].features,
                                                                state["rulebooks"]))
            grids = stage_grids(model.grid)
            backbone_out = {k: (f, ky, grids[k]) for k, (f, ky) in state["sparse_convs"].items()}
            bev_in = height_compression(*backbone_out["encoded"])
        step("bev", lambda: model.bev_backbone(bev_in))
        mask = None
        if model.dense_head_name == "AnchorHeadSingleV2":
            step("anchor_mask", lambda: point_density_anchor_mask(
                batch["points"], batch["points_valid"], tuple(state["bev"].shape[1:3]),
                model.point_cloud_range, model.grid.nx))
            mask = state["anchor_mask"]
        step("dense_head", lambda: model.dense_head(state["bev"], mask))
        step("decode", lambda: model.dense_head.generate_predicted_boxes(state["dense_head"]))
        boxes, scores = state["decode"]
        pre = min(int(rpn.get("NMS_PRE_MAXSIZE", 4096)), boxes.shape[1])
        step("top_k", lambda: [nms.top_k(s.amax(-1), pre) for s in scores])
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        step("iou_nms", lambda: [nms.nms_bev(
            bx[ti], ts, thresh=rpn["NMS_THRESH"], pre_max_size=pre, post_max_size=n_rois,
            valid=ts > 0.0, fast=bool(rpn.get("USE_FAST_NMS", True)))
            for bx, (ts, ti) in zip(boxes, state["top_k"])])
        iou_peak = torch.cuda.max_memory_allocated() - base
        step("proposals", lambda: model._anchor_proposals(state["dense_head"], n_rois, rpn))
        last = state["proposals"]
        if model.with_roi_head:
            step("roi_head", lambda: model.roi_head(state["proposals"], backbone_out))
            last = state["roi_head"]
        step("post_nms", lambda: model.post_processing(last))
    return times, iou_peak, pre


def anchor_predict_phase(model, batch, what, card, want_a1):
    """One anchor-model predict at full width: A1 / A2 launch counts of a
    counted predict, finite outputs, 2 warm-ups then timed loops, peak
    memory, the stage breakdown with the proposal layer's parts and the IoU
    + NMS peak, and a profiler window. Returns the A1 launches."""
    a1.gather_gemm.launches = a1.gather_gemm_dw.launches = 0
    out = model.predict(batch)
    torch.cuda.synchronize()
    launches = (a1.gather_gemm.launches, a1.gather_gemm_dw.launches)
    if launches != (want_a1, 0):
        raise AssertionError(f"{what}: (A1, A2) launched {launches} times in one predict, "
                             f"want {(want_a1, 0)}")
    n = out["pred_boxes"].shape[1]
    if out["pred_boxes"].shape != (1, n, 7) or not all(
            torch.isfinite(v.float()).all() for v in out.values()):
        raise AssertionError(f"{what}: predict shapes "
                             f"{ {k: tuple(v.shape) for k, v in out.items()} } or non-finite")
    print(f"predict, {what} ({card}): {int(out['pred_valid'].sum())} valid detections of {n} "
          f"slots; (A1, A2) launches {launches}", flush=True)
    model.predict(batch)  # second warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    loop_s = []
    for _ in range(ANCHOR_TIMED_LOOPS):
        t0 = time.perf_counter()
        model.predict(batch)
        torch.cuda.synchronize()
        loop_s.append(time.perf_counter() - t0)
    fps = sorted(1.0 / s for s in loop_s)
    peak = torch.cuda.max_memory_allocated()
    runs = [anchor_stage_breakdown(model, batch) for _ in range(3)]
    breakdown = {k: statistics.median(r[0][k] for r in runs) for k in runs[0][0]}
    print(f"predict, {what} ({card}): frames/s over {ANCHOR_TIMED_LOOPS} loops: median "
          f"{statistics.median(fps):.3f} min {fps[0]:.3f} max {fps[-1]:.3f}; peak memory "
          f"{peak / 2**30:.2f} GiB; stage ms (host clock, synchronised, median of 3): "
          + ", ".join(f"{k} {v:.2f}" for k, v in breakdown.items())
          + f"; the rotated IoU + NMS over the top {runs[0][2]} proposals adds "
          f"{max(r[1] for r in runs) / 2**30:.2f} GiB at its peak", flush=True)
    device_profile(lambda: model.predict(batch), f"predict ({what})",
                   1e3 / statistics.median(fps))
    return launches[0]


def anchor_small_check(path, sets, what, card):
    """The anchor model of a yaml cut to a small range (same weights) on the
    CPU (plain kernel versions) and on the card: head maps and proposals'
    scores within the bf16 tier. The RPN NMS takes the top 256 anchors: the
    CPU's rotated IoU over 4096 x 4096 would take minutes."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(1)
    half = float(ast.literal_eval(sets[1])[3])
    sets = list(sets) + ["MODEL.DENSE_HEAD.POST_PROCESSING.NMS_CONFIG",
                         "{'NMS_THRESH': 0.8, 'NMS_PRE_MAXSIZE': 256}"]
    pts = np.concatenate([rng.uniform(-half, half, (2, 4096, 2)), rng.uniform(-2, 4, (2, 4096, 1)),
                          rng.uniform(0, 1, (2, 4096, 2))], -1).astype(np.float32)
    outs = []
    for device in ("cpu", "cuda"):
        _, model = yaml_model(path, sets, 3, device)
        batch = {"points": torch.from_numpy(pts).to(device),
                 "points_valid": torch.ones(2, 4096, dtype=torch.bool, device=device)}
        with torch.no_grad():
            out = model(batch)
        outs.append({k: out["head_preds"][k].cpu() for k in ("cls_preds", "box_preds")}
                    | {"roi_scores": out["roi_scores"].cpu()})
    for k, ref in outs[0].items():
        err = (outs[1][k] - ref).abs().max().item()
        scale = max(ref.abs().max().item(), 1e-3)
        print(f"small input, {what}, card ({card}) vs CPU {k}: max err {err:.3e} (scale "
              f"{scale:.3e})")
        if err > 0.03 * scale:
            raise AssertionError(f"{what}: card and CPU disagree at {k}: {err} vs scale {scale}")
    print(f"small input, {what}: the check took {time.perf_counter() - t0:.1f} s", flush=True)


def bev_features(model, batch):
    """The BEV map that feeds the dense head, from a training-mode forward
    under no_grad."""
    model.train()
    with torch.no_grad():
        if model.pillars:
            bev = model._pillar_bev(batch["points"], batch["points_valid"])
        else:
            frame = voxelize_batch(batch["points"], model.vox_spec, batch["points_valid"])
            out = model.backbone(frame.features, keys_from_frame(frame, model.grid))
            bev = height_compression(*out["encoded"])
        return model.bev_backbone(bev)


def dense_head_alone(model, batch, what, card):
    """The anchor head's share of a training step: on a detached BEV map, the
    head's forward, ``get_loss`` and backward alone, under
    ``deterministic_cudnn`` (as a step runs it) and without the scope: ms
    (median of 3, synchronised), the peak memory of a scoped run above what
    was allocated before it, and a profiler window of a scoped run."""
    from cpd_tpu_torch.parallel import deterministic_cudnn
    head = model.dense_head
    st = bev_features(model, batch)
    mask = (point_density_anchor_mask(batch["points"], batch["points_valid"],
                                      tuple(st.shape[1:3]), model.point_cloud_range,
                                      model.grid.nx)
            if model.dense_head_name == "AnchorHeadSingleV2" else None)

    def run(scope):
        head.zero_grad(set_to_none=True)
        with scope():
            preds = head(st, mask)
            loss, _ = head.get_loss(preds, batch["gt_boxes"], batch["gt_valid"])
            loss.backward()
        torch.cuda.synchronize()

    import contextlib
    times = {}
    for name, scope in (("deterministic_cudnn", deterministic_cudnn),
                        ("no scope", contextlib.nullcontext)):
        run(scope)
        ms = []
        for _ in range(3):
            t0 = time.perf_counter()
            run(scope)
            ms.append((time.perf_counter() - t0) * 1e3)
        times[name] = statistics.median(ms)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    run(deterministic_cudnn)
    peak = torch.cuda.max_memory_allocated() - base
    print(f"{what}, the dense head alone (forward + get_loss + backward on a detached "
          f"{tuple(st.shape)} BEV map, {card}): " + ", ".join(
              f"{k} {v:.2f} ms" for k, v in times.items())
          + f" (medians of 3); {peak / 2**30:.2f} GiB above the inputs at the peak", flush=True)
    device_profile(lambda: run(deterministic_cudnn), f"dense head step ({what})",
                   times["deterministic_cudnn"], loops=1)
    head.zero_grad(set_to_none=True)


def step_twice_identical(model, batch, dev, what, card):
    """One training step's loss_step + backward twice from the same state
    under ``deterministic_cudnn`` (as ``make_train_step`` runs it): the loss,
    every tb entry, every gradient and every buffer bit-identical, a gate."""
    from cpd_tpu_torch.parallel import deterministic_cudnn
    start = {k: v.detach().clone() for k, v in model.state_dict().items()}
    runs = []
    for _ in range(2):
        model.load_state_dict(start, strict=True)
        model.train().zero_grad(set_to_none=True)
        with deterministic_cudnn():
            loss, tb = model.loss_step(batch, generator=torch.Generator(device=dev).manual_seed(0))
            loss.backward()
        torch.cuda.synchronize()
        runs.append([("loss", loss.detach().clone())]
                    + [(f"tb[{k}]", v.detach().clone()) for k, v in tb.items()]
                    + [(n, p.grad.clone()) for n, p in model.named_parameters()
                       if p.grad is not None]
                    + [(n, b.clone()) for n, b in model.named_buffers()])
    model.load_state_dict(start, strict=True)
    model.zero_grad(set_to_none=True)
    differ = next((n for (n, x), (_, y) in zip(*runs) if not torch.equal(x, y)), None)
    print(f"step determinism, {what} ({card}): two runs of loss_step + backward under "
          f"deterministic_cudnn, {len(runs[0])} tensors: "
          f"{'bit-identical' if differ is None else 'first difference at ' + differ}", flush=True)
    if differ is not None:
        raise AssertionError(f"{what}: one training step is not bit-identical twice, first at "
                             f"{differ}")


def anchor_train_phase(model, batch, what, card, dev, want):
    """A batch-2 training step of an anchor model through ``make_train_step``
    on labels moved onto its own proposals: (A1 forward, A1 dX, A2) launches
    of the first step as ``want``, finite terms with the anchor losses, no
    step skipped, 2 warm-ups then timed steps (ms, phases, peak memory), a
    profiler window, and the step bit-identical twice."""
    batch, matched = labels_on_proposals(model, batch, n_labelled=40,
                                         props=anchor_proposals_of(model, batch))
    print(f"training batch, {what} ({card}): {TRAIN_BATCH} frames of {N_POINTS} points, "
          f"{batch['gt_boxes'].shape[1]} label slots, {matched} labels a sample placed on "
          f"proposals", flush=True)
    step_twice_identical(model, batch, dev, what, card)
    state = init_state(model, OPT_CFG, total_steps=100, device=dev)
    train_step = make_train_step()
    generator = torch.Generator(device=dev).manual_seed(0)
    with StepMarks(state) as marks:
        a1.gather_gemm.launches = a1.gather_gemm_dw.launches = 0
        state, tb = train_step(state, batch, generator)
        torch.cuda.synchronize()
        fwd, a2_fwd = marks.rows[0]["forward_launches"]
        got = (fwd, a1.gather_gemm.launches - fwd, a1.gather_gemm_dw.launches, a2_fwd)
        if got != tuple(want) + (0,):
            raise AssertionError(f"{what}: the train step launched (A1 forward, A1 dX, A2, A2 "
                                 f"in the forward) = {got}, want {tuple(want) + (0,)}")
        print(f"{what}, first tb: " + ", ".join(f"{k} {float(v):.4f}" for k, v in tb.items()),
              flush=True)
        state, tb = train_step(state, batch, generator)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step_s = []
        for _ in range(ANCHOR_TIMED_LOOPS):
            t0 = time.perf_counter()
            state, tb = train_step(state, batch, generator)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            bad = [k for k, v in tb.items() if not math.isfinite(float(v))]
            if bad or float(tb["skipped_nonfinite"]):
                raise AssertionError(f"{what}: non-finite tb {bad} or a skipped step")
        peak = torch.cuda.max_memory_allocated()
        phases = marks.phase_ms(marks.rows[-ANCHOR_TIMED_LOOPS:])
    if not {"rpn_cls", "rpn_reg", "rpn_dir", "rpn_loss"} <= set(tb) or float(tb["rpn_reg"]) <= 0:
        raise AssertionError(f"{what}: the anchor losses are missing or rpn_reg is 0: "
                             f"{sorted(tb)}")
    ms = sorted(x * 1e3 for x in step_s)
    print(f"train step, {what} ({card}): ms over {ANCHOR_TIMED_LOOPS} steps median "
          f"{statistics.median(ms):.2f} min {ms[0]:.2f} max {ms[-1]:.2f}; phases (CUDA events, "
          f"medians): " + ", ".join(f"{k} {v:.2f}" for k, v in phases.items())
          + f"; peak memory {peak / 2**30:.2f} GiB; launches a step (A1 forward, A1 dX, A2) "
          f"{got[:3]}; last tb: " + ", ".join(f"{k} {float(v):.4f}" for k, v in tb.items()),
          flush=True)
    device_profile(lambda: train_step(state, batch, generator), f"train step ({what})",
                   statistics.median(ms), loops=2)
    dense_head_alone(model, batch, what, card)
    return got[:3]


def pillar_occupancy(model, batch, card):
    """Valid pillars of the frame against the pillar cap; raises at the cap."""
    with torch.no_grad():
        frame = voxelize_batch(batch["points"], model.vox_spec, batch["points_valid"])
    n, cap = int(frame.valid.sum(-1).max()), model.vox_spec.max_voxels
    print(f"pillar occupancy / cap: {n} / {cap} (grid {model.grid.nx} x {model.grid.ny}; "
          f"{card})", flush=True)
    if n >= cap:
        raise AssertionError(f"the pillar cap is saturated: {n}/{cap}")


def oyster_cli_phase(dev, card):
    """The training CLI on the OYSTER yaml as shipped, as a user runs it:
    ``--epochs 1 --debug_steps 2 --eval_after 1`` at its batch of 2 on a
    written sequence of 4 frames of 200k points with OYSTER prototype banks
    and a written DB_INFO_PATH pickle, then the eval CLI on the checkpoint.
    Gates: gt_sampling pastes objects into the training samples; 2 steps,
    each with (21, 20, 21) launches of A1 forward, A1 dX and A2 and none in
    the forward; the counters accounted for with the eval's A1 launches;
    finite anchor and RoI losses, no step skipped; result.pkl one finite
    record a frame."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        frames = [make_lidar_frame(np.random.default_rng(i), N_POINTS)[0]
                  for i in range(OYSTER_FRAMES)]
        write_waymo_sequence(tmp, EVAL_SEQ, frames, seed=0, n_boxes=8, protos=True,
                             init_label_generator="OYSTER")
        sets = ["DATA_CONFIG.DATA_PATH", str(tmp), "DATA_CONFIG.SAMPLED_INTERVAL.train", "1",
                "DATA_CONFIG.SAMPLED_INTERVAL.test", "1"]
        cfg = cfg_from_list(sets, cfg_from_yaml_file(OYSTER_YAML, ConfigDict()))
        sampling = [a for a in cfg.DATA_CONFIG.DATA_AUGMENTOR.AUG_CONFIG_LIST
                    if a["NAME"] == "gt_sampling"][0]
        write_gt_database(tmp / sampling["DB_INFO_PATH"][0], seed=0)
        dataset = build_dataset(cfg.DATA_CONFIG, cfg.CLASS_NAMES, True, str(tmp))
        sample = dataset[0]
        pasted = int(((sample["proto_group_id"] == -1) & sample["gt_valid"]).sum())
        if dataset.data_augmentor.queue[0][0] != "gt_sampling" or pasted == 0:
            raise AssertionError("OYSTER: gt_sampling pasted no object into a training sample")
        batch_size = int(cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU)
        logger = logging.getLogger("cpd_tpu_torch")
        lines = LogLines()
        logger.addHandler(lines)
        try:
            with CLISteps() as steps:
                steps.run = "oyster"
                a1.gather_gemm.launches = a1.gather_gemm_dw.launches = 0
                t1 = time.perf_counter()
                state = train_cli.main(["--cfg_file", OYSTER_YAML, "--output_dir",
                                        str(tmp / "out"), "--epochs", "1", "--debug_steps", "2",
                                        "--log_every", "1", "--eval_after", "1", "--set", *sets])
                torch.cuda.synchronize()
                secs = time.perf_counter() - t1
                totals = a1.gather_gemm.launches, a1.gather_gemm_dw.launches
        finally:
            logger.removeHandler(lines)
        want = (ANCHOR_A1_FORWARD, ANCHOR_A1_DX, ANCHOR_A2, 0)
        if state.step != 2 or [r["launches"] for r in steps.rows] != [want, want]:
            raise AssertionError(f"OYSTER train CLI: {state.step} steps, launches "
                                 f"{[r['launches'] for r in steps.rows]}, want 2 x {want}")
        eval_a1 = A1_PER_FORWARD[False] * math.ceil(OYSTER_FRAMES / batch_size)
        if totals != (2 * (ANCHOR_A1_FORWARD + ANCHOR_A1_DX) + eval_a1, 2 * ANCHOR_A2):
            raise AssertionError(f"OYSTER train CLI: the counters read {totals}")
        for r in steps.rows:
            bad = [k for k, v in r["tb"].items() if not math.isfinite(v)]
            if bad or r["tb"]["skipped_nonfinite"] or not {"rpn_cls", "rpn_reg", "rcnn_cls0"} \
                    <= set(r["tb"]):
                raise AssertionError(f"OYSTER train CLI step: non-finite {bad}, tb keys "
                                     f"{sorted(r['tb'])}")
        with open(tmp / "out" / "eval_epoch_0" / "result.pkl", "rb") as f:
            result = pickle.load(f)
        want_ids = [f"{EVAL_SEQ}#{i:04d}" for i in range(OYSTER_FRAMES)]
        if [a["frame_id"] for a in result] != want_ids or not all(
                np.isfinite(a["boxes_lidar"]).all() and np.isfinite(a["score"]).all()
                for a in result):
            raise AssertionError("OYSTER train CLI: the eval's result.pkl is incomplete or "
                                 "non-finite")
        n_steps, rate, means = _phase_means(lines.lines)[-1]
        print(f"OYSTER train CLI ({card}): {pasted} objects pasted into sample 0; batch "
              f"{batch_size}, {n_steps} steps at {rate} steps/s; the CLI's phase means "
              + ", ".join(f"{k} {v * 1e3:.1f} ms" for k, v in means.items())
              + "; each step " + ", ".join(f"{r['ms']:.1f}" for r in steps.rows)
              + f" ms; per step A1 {want[0]} forward + {want[1]} dX, A2 {want[2]}; "
              f"{sum(len(a['score']) for a in result)} detections in result.pkl; the CLI call "
              f"{secs:.1f} s with its eval; last tb: "
              + ", ".join(f"{k} {v:.4f}" for k, v in steps.rows[-1]["tb"].items()), flush=True)
    print(f"OYSTER train CLI phase: {time.perf_counter() - t0:.1f} s ({card})", flush=True)


def anchor_phase(dev, card):
    """Phase 14, the anchor-head models at full width. (a) The DBSCAN
    VoxelRCNN yaml as shipped (AnchorHeadSingleV2, VoxelRCNNHead, MM off) on
    the bench frame: cap audit, A1 against its plain version on the 21 convs
    of its forward, predict, the card against the CPU on a small input, and a
    batch-2 training step with A1 forward, A1 as dX and A2 against their
    plain versions on its operands. (b) The PointPillars yaml at +-75.52 m:
    pillar occupancy, predict and a batch-2 step with no A1 or A2 launch.
    (c) The training CLI on the OYSTER yaml. Returns the kernels-line
    entries of the DBSCAN model's kernel uses."""
    t0 = time.perf_counter()
    src1, src2 = "cpd_tpu_torch/csrc/gather_gemm.cu", "cpd_tpu_torch/csrc/gather_gemm_dw.cu"
    pts, valid = make_lidar_frame(np.random.default_rng(0), N_POINTS)
    batch = {"points": torch.from_numpy(pts)[None].to(dev),
             "points_valid": torch.from_numpy(valid)[None].to(dev)}
    _, model = yaml_model(DBSCAN_YAML, [], 0, dev)
    cap_audit(model, batch)
    convs = recorded_forward(model, batch)
    max_err, shape_times = check_kernel("A1 DBSCAN predict", convs, a1_kernel, a1_plain,
                                        torch.bfloat16)
    del convs
    launches = anchor_predict_phase(model, batch, "DBSCAN VoxelRCNN", card, ANCHOR_A1_FORWARD)
    kernels = [kernel_entry("gather_gemm", "DBSCAN VoxelRCNN predict", src1,
                            "cpd_tpu/ops/pallas_conv.py:77", launches, max_err, shape_times)]
    cut = ["DATA_CONFIG.POINT_CLOUD_RANGE", "[-8.0,-8.0,-2.0,8.0,8.0,4.0]",
           "MODEL.BACKBONE_3D.VOXEL_CAPS", "[8000,4000,2000,2000]",
           "DATA_CONFIG.DATA_PROCESSOR", "[{'NAME': 'transform_points_to_voxels', "
           "'VOXEL_SIZE': [0.1, 0.1, 0.15], 'MAX_NUMBER_OF_VOXELS': {'train': 10000, "
           "'test': 10000}}]"]
    anchor_small_check(DBSCAN_YAML, cut, "DBSCAN VoxelRCNN", card)
    train_batch = to_device(make_train_batch(0, TRAIN_BATCH, N_POINTS), dev)
    checks = train_kernel_checks(model, labels_on_proposals(
        model, train_batch, 40, props=anchor_proposals_of(model, train_batch))[0],
        step_generator(0, 0, dev), want=(ANCHOR_A1_FORWARD, ANCHOR_A1_DX, ANCHOR_A2))
    got = anchor_train_phase(model, train_batch, "DBSCAN VoxelRCNN", card, dev,
                             (ANCHOR_A1_FORWARD, ANCHOR_A1_DX, ANCHOR_A2))
    kernels += [
        kernel_entry("gather_gemm", "DBSCAN VoxelRCNN train step, forward", src1,
                     "cpd_tpu/ops/pallas_conv.py:77", got[0], *checks["forward"]),
        kernel_entry("gather_gemm (dX)", "DBSCAN VoxelRCNN train step, backward", src1,
                     "cpd_tpu/ops/pallas_conv.py:77", got[1], *checks["dx"]),
        kernel_entry("gather_gemm_dw", "DBSCAN VoxelRCNN train step, backward", src2,
                     "cpd_tpu/ops/pallas_conv.py:130", got[2], *checks["dw"]),
    ]
    del model
    torch.cuda.empty_cache()
    print(f"DBSCAN VoxelRCNN done at {time.perf_counter() - t0:.1f} s of the phase", flush=True)

    _, model = yaml_model(PILLAR_YAML, PILLAR_SETS, 0, dev)
    pillar_occupancy(model, batch, card)
    anchor_predict_phase(model, batch, "PointPillars", card, 0)
    anchor_small_check(PILLAR_YAML, ["DATA_CONFIG.POINT_CLOUD_RANGE",
                                     "[-6.4,-6.4,-2.0,6.4,6.4,4.0]"], "PointPillars", card)
    anchor_train_phase(model, train_batch, "PointPillars", card, dev, (0, 0, 0))
    del model, train_batch
    torch.cuda.empty_cache()
    print(f"PointPillars done at {time.perf_counter() - t0:.1f} s of the phase", flush=True)

    oyster_cli_phase(dev, card)
    print(f"anchor phase: {time.perf_counter() - t0:.1f} s ({card})", flush=True)
    return kernels


def timed_once_ms(fn):
    """(result, device ms) of one call of ``fn``."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def grid_pair_tests(points, cell, groups=1, group=None):
    """Pair tests of a 27-cell grid walk, as kernels R1 and R2 make them:
    for every point of ``points`` (queries) and every group (R1's windows)
    the support points in the 9 column runs of its cell, with the support
    ``group`` (None: the points themselves) sorted by (group, cell)."""
    support, ids = (points, None) if group is None else group
    (qcell, scell), dims = r1.grid_cells((points, support), cell)
    keys, _ = torch.sort(r1.cell_keys(scell, dims, ids))
    total = 0
    for w in range(groups):
        g = qcell[:, 0] + w * dims[0]
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                base = ((g + dx) * dims[1] + qcell[:, 1] + dy) * dims[2] + qcell[:, 2]
                total += int((torch.searchsorted(keys, base + 2)
                              - torch.searchsorted(keys, base - 1)).sum())
    return total


def factory_entry(name, path, source, replaces, launches, ms, wrapper_ms, plain_ms, nbytes, ops,
                  flops):
    """One entry of the kernels line for R1 or R2: ``ms`` the launch alone,
    ``wrapper_ms`` with the wrapper's grid and sorts; the bound is the larger
    of ``nbytes`` at the memory rate and ``ops`` (the pairs the function
    needs, not the kernel's walk) at ``flops``."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / flops * 1e3
    return {"name": name, "path": path, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": 0.0, "ms": ms, "wrapper_ms": wrapper_ms,
            "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations", "library_ms": None}


def factory_r1_check(frames, poses, dev, card):
    """Kernel R1 against its plain version on the windows of the middle
    frame (every frame of the drive in windows of 5, as ``save_ppscore``
    gives them): exact counts, a second launch bit-equal. Returns (launch
    ms, wrapper ms, plain ms, bytes, operations): 8 f32 operations for each
    neighbour pair that the counts hold."""
    i = len(frames) // 2
    query, support, ids, w = (torch.from_numpy(a).to(dev) if isinstance(a, np.ndarray) else a
                              for a in frame_windows(frames[i][:, :3], poses[i], frames, poses))
    run = lambda: r1.radius_count(query, support, ids, w, 0.3)
    out, again = run(), run()
    ref, plain_ms = timed_once_ms(lambda: r1.radius_count_reference(query, support, ids, w, 0.3))
    if not (torch.equal(out, ref) and torch.equal(out, again)):
        raise AssertionError(f"R1: counts differ from the plain version on "
                             f"{int((out != ref).any(1).sum())} queries (or between launches)")
    ops = r1.radius_operands(query, support, ids, w, 0.3)
    ms, wrapper_ms = paired_median_ms(lambda: r1.radius_launch(ops), run)
    tests = grid_pair_tests(query, 0.3 * r1.CELL_MARGIN, w, (support, ids))
    pairs = int(out.sum())
    nbytes = query.numel() * 4 + support.numel() * 4 + ids.numel() * 4 + out.numel() * 4
    print(f"R1 radius_count ({card}): {query.shape[0]} queries, {support.shape[0]} support "
          f"points in {w} windows, {pairs} neighbour pairs, {tests} pair tests in the kernel's "
          f"walk ({tests / pairs:.2f} a pair); exact and bit-equal twice; launch {ms:.3f} ms, "
          f"wrapper {wrapper_ms:.3f} ms (grid and sorts included; medians of 5), plain "
          f"{plain_ms:.1f} ms (one call)", flush=True)
    return ms, wrapper_ms, plain_ms, nbytes, 8.0 * pairs


def factory_r2_check(cloud, dev, card):
    """Kernel R2 against its plain version on ``cloud`` = (points, eps,
    min_samples), the largest cloud that ``create_outline_boxes`` clustered:
    labels equal on every point, twice. Returns (launch ms, wrapper ms, plain
    ms, bytes, operations): 8 f64 operations for each pair within eps,
    counted once."""
    pts, eps, min_samples = cloud
    run = lambda: r2.dbscan_labels(pts, eps, min_samples)
    out, again = run(), run()
    ref, plain_ms = timed_once_ms(lambda: r2.dbscan_reference(pts, eps, min_samples))
    if not (torch.equal(out, ref) and torch.equal(out, again)):
        raise AssertionError(f"R2: labels differ from the plain version on "
                             f"{int((out != ref).sum())} of {len(out)} points (or between launches)")
    ops = r2.dbscan_operands(pts, eps)
    ms, wrapper_ms = paired_median_ms(lambda: r2.dbscan_launch(ops, min_samples), run)
    tests = grid_pair_tests(pts, eps * r1.CELL_MARGIN)
    pairs = (len(r2.neighbour_pairs(pts, eps)[0]) - len(pts)) // 2
    nbytes = pts.numel() * 8 + out.numel() * 4
    print(f"R2 dbscan ({card}): the largest cloud of create_outline_boxes: {len(pts)} points, "
          f"eps {eps}, min_samples {min_samples}: {int(out.max()) + 1} clusters, "
          f"{int((out < 0).sum())} noise, {pairs} pairs within eps, {tests} pair tests a walk "
          f"of the kernel (it walks three times: count, union, label); equal to plain on every "
          f"point, bit-equal twice; launch {ms:.3f} ms, wrapper {wrapper_ms:.3f} ms (medians of "
          f"5), plain {plain_ms:.1f} ms (one call)", flush=True)
    return ms, wrapper_ms, plain_ms, nbytes, 8.0 * pairs


class LargestCloud:
    """While active, ``outline.dbscan_labels`` (the call the factory's
    clustering makes) keeps the largest (points, eps, min_samples) it is
    given in ``self.cloud``."""

    def __enter__(self):
        self.cloud, self.saved = None, outline.dbscan_labels

        def recording(points, eps, min_samples):
            if self.cloud is None or len(points) > len(self.cloud[0]):
                self.cloud = (points.clone(), eps, min_samples)
            return self.saved(points, eps, min_samples)

        outline.dbscan_labels = recording
        return self

    def __exit__(self, *exc):
        outline.dbscan_labels = self.saved


def check_factory_outputs(seq_dir, seq, n_frames, n_points, min_track):
    """The files ``WaymoUnsupervisedDataset`` reads, with their schema, and
    their frames: at least ``FACTORY_BOXES_WITH_POINTS`` of the label boxes
    hold a point of their own frame (a box the tracker carried past its
    points may hold none), and every prototype bank point lies in the box
    frame, within its class's largest label box grown by
    ``FACTORY_BANK_MARGIN`` m on every side. Returns (boxes a frame, tracks
    of ``min_track`` frames or more, banks)."""
    for i in range(n_frames):
        pp = np.load(seq_dir / "ppscore" / f"{i:04d}.npy")
        if pp.dtype != np.float16 or pp.shape != (n_points,) or not np.isfinite(pp).all():
            raise AssertionError(f"factory: ppscore {i:04d} {pp.dtype} {pp.shape} or not finite")
    with open(seq_dir / f"{seq}_outline_C_PROTO.pkl", "rb") as f:
        labels = pickle.load(f)
    with open(seq_dir / f"{seq}_outline_MFCF_CSS_proto.pkl", "rb") as f:
        banks = pickle.load(f)["proto_points_set"]
    if sorted(labels) != list(range(n_frames)):
        raise AssertionError(f"factory: label frames {sorted(labels)}")
    frames_of, with_points = {}, 0
    for i, lab in labels.items():
        n = len(lab["outline_box"])
        shapes = [np.shape(lab[k]) for k in ("outline_cls", "outline_ids", "outline_score",
                                              "outline_proto_id")]
        if lab["outline_box"].shape != (n, 7) or not np.isfinite(lab["outline_box"]).all() \
                or shapes != [(n,)] * 4:
            raise AssertionError(f"factory: frame {i} labels {lab['outline_box'].shape} {shapes}")
        for tid in lab["outline_ids"]:
            frames_of[int(tid)] = frames_of.get(int(tid), 0) + 1
        if n:
            pts = np.load(seq_dir / f"{i:04d}.npy")[:, :3]
            with_points += int(points_in_boxes_mask_fast(pts, lab["outline_box"]).any(1).sum())
    n_banks = sum(len(v) for v in banks.values())
    long_tracks = sum(1 for v in frames_of.values() if v >= min_track)
    boxes = np.concatenate([lab["outline_box"] for lab in labels.values()])
    names = np.concatenate([lab["outline_cls"] for lab in labels.values()])
    scores = np.concatenate([lab["outline_score"] for lab in labels.values()])
    counts = {str(k): int(v) for k, v in zip(*np.unique(names, return_counts=True))}
    lo, hi = ([f"{v:.2f}" for v in f(boxes[:, 3:6], axis=0)] for f in (np.min, np.max))
    half = {c: boxes[names == c, 3:6].max(0) / 2 + FACTORY_BANK_MARGIN for c in counts}
    reach = {c: np.max([np.abs(np.asarray(b["points"])).max(0) for b in v.values()
                        if len(b["points"])], axis=0) for c, v in banks.items() if v}
    print(f"factory labels: {counts}; l, w, h from {lo} to {hi} m; CSS scores "
          f"{float(scores.min()):.3f}-{float(scores.max()):.3f}; "
          f"{int(sum((lab['outline_proto_id'] >= 0).sum() for lab in labels.values()))} boxes "
          f"with a prototype; {with_points} of {len(boxes)} boxes hold a point of their frame; "
          f"bank points reach " + ", ".join(
              f"{c} {'/'.join(f'{v:.2f}' for v in r)} (its largest label box "
              f"{'/'.join(f'{v:.2f}' for v in half[c] - FACTORY_BANK_MARGIN)})"
              for c, r in reach.items() if c in half) + " m", flush=True)
    if long_tracks == 0 or n_banks == 0 or not all(
            np.asarray(b["points"]).ndim == 2 and np.asarray(b["points"]).shape[1] == 3
            for v in banks.values() for b in v.values()):
        raise AssertionError(f"factory: {long_tracks} tracks of {min_track}+ frames, "
                             f"{n_banks} prototype banks")
    if with_points < FACTORY_BOXES_WITH_POINTS * len(boxes):
        raise AssertionError(f"factory: only {with_points} of {len(boxes)} label boxes hold a "
                             f"point of their frame")
    outside = [c for c, r in reach.items() if c not in half or (r > half[c]).any()]
    if outside:
        raise AssertionError(f"factory: bank points of {outside} outside their class's largest "
                             f"label box + {FACTORY_BANK_MARGIN} m")
    return [len(labels[i]["outline_box"]) for i in range(n_frames)], long_tracks, n_banks


def factory_phase(dev, card):
    """Phase 15, the pseudo-label factory on the card, as the builder CLI
    runs it: a drive of ``FACTORY_FRAMES`` frames of 200k points written
    with poses and no labels; R1 against its plain version on one frame's
    windows; ``create_ppscore`` (R1 launches counted around it);
    ``create_outline_boxes`` with the cproto dataset yaml (MFCF + C_PROTO;
    R2 launches counted); R2 against its plain version on the largest cloud
    that it clustered;
    ``create_track_groundtruth_database`` on the port's dataset; then the
    training CLI for 2 steps on those labels and prototype banks. Gates: the
    four outputs with their schema, a track of ``remove_short_track`` (2)
    frames or more, a prototype bank, nonzero R1 and R2 launches, finite
    losses. Returns the kernels-line entries of R1 and R2."""
    t0 = time.perf_counter()
    cfg = load_file(CPROTO_DATA_YAML)
    min_track = int(cfg["GeneratorConfig"].get("remove_short_track", 2))
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        frames, poses = make_lidar_sequence(0, n_frames=FACTORY_FRAMES, n_points=N_POINTS)
        write_waymo_sequence(tmp, EVAL_SEQ, frames, poses=poses, labels=False)
        root = tmp / "waymo_processed_data"
        seq_dir = root / EVAL_SEQ
        t_write = time.perf_counter() - t0
        r1_numbers = factory_r1_check(frames, poses, dev, card)
        del frames

        stages = {}
        r1.radius_count.launches = r2.dbscan_labels.launches = 0
        timer = PhaseTimer()
        t1 = time.perf_counter()
        builder.create_ppscore(root, [EVAL_SEQ], device=dev, timer=timer)
        stages["create_ppscore"] = time.perf_counter() - t1
        pp_launches = (r1.radius_count.launches, r2.dbscan_labels.launches)
        pp_stages = dict(timer.totals)

        r1.radius_count.launches = r2.dbscan_labels.launches = 0
        timer = PhaseTimer()
        t1 = time.perf_counter()
        with LargestCloud() as largest:
            builder.create_outline_boxes(root, [EVAL_SEQ], cfg, device=dev, timer=timer)
        stages["create_outline_boxes"] = time.perf_counter() - t1
        ob_launches = (r1.radius_count.launches, r2.dbscan_labels.launches)
        ob_stages = dict(timer.totals)
        r2_numbers = factory_r2_check(largest.cloud, dev, card)
        if pp_launches[0] != FACTORY_FRAMES or pp_launches[1] or ob_launches[0] \
                or ob_launches[1] == 0:
            raise AssertionError(f"factory: (R1, R2) launches {pp_launches} in create_ppscore "
                                 f"(want ({FACTORY_FRAMES}, 0)), {ob_launches} in "
                                 f"create_outline_boxes (want (0, > 0))")

        sets = ["DATA_CONFIG.DATA_PATH", str(tmp), "DATA_CONFIG.SAMPLED_INTERVAL.train", "1",
                "DATA_CONFIG.SAMPLED_INTERVAL.test", "1"]
        model_cfg = cfg_from_list(sets, cfg_from_yaml_file(EVAL_YAML, ConfigDict()))
        dataset = build_dataset(model_cfg.DATA_CONFIG, model_cfg.CLASS_NAMES, True, str(tmp))
        t1 = time.perf_counter()
        db = builder.create_track_groundtruth_database(dataset, root / "track_dbinfos_train.pkl")
        stages["create_track_groundtruth_database"] = time.perf_counter() - t1
        with open(root / "track_dbinfos_train.pkl", "rb") as f:
            db_pkl = pickle.load(f)
        if {k: len(v) for k, v in db_pkl.items()} != db or not all(
                {"name", "box3d_lidar", "points", "num_points_in_gt"} <= set(r)
                for v in db_pkl.values() for r in v):
            raise AssertionError(f"factory: track_dbinfos_train.pkl {db}")
        per_frame, long_tracks, n_banks = check_factory_outputs(
            seq_dir, EVAL_SEQ, FACTORY_FRAMES, N_POINTS, min_track)
        sample = dataset[0]
        print(f"factory ({card}): {FACTORY_FRAMES} frames of {N_POINTS} points, written in "
              f"{t_write:.1f} s; boxes a frame {per_frame}; {long_tracks} tracks of "
              f"{min_track}+ frames; {n_banks} prototype banks; gt database {db}; launches (R1, "
              f"R2): create_ppscore {pp_launches}, create_outline_boxes {ob_launches}; "
              f"training sample 0: {int(sample['gt_valid'].sum())} labelled boxes", flush=True)
        print("factory stages (s): " + ", ".join(f"{k} {v:.2f}" for k, v in stages.items())
              + "; inside create_ppscore: " + ", ".join(f"{k} {v:.2f}" for k, v in
                                                        pp_stages.items())
              + "; inside create_outline_boxes: " + ", ".join(f"{k} {v:.2f}" for k, v in
                                                              ob_stages.items()), flush=True)

        with CLISteps() as steps:
            steps.run = "factory"
            state = train_cli.main(["--cfg_file", EVAL_YAML, "--output_dir", str(tmp / "out"),
                                    "--epochs", "1", "--debug_steps", "2", "--log_every", "1",
                                    "--set", *sets])
            torch.cuda.synchronize()
        bad = [(k, v) for r in steps.rows for k, v in r["tb"].items() if not math.isfinite(v)]
        big = [(k, r["tb"][k]) for r in steps.rows for k in FACTORY_LOSS_BOUNDED
               if abs(r["tb"][k]) > FACTORY_LOSS_BOUND]
        if state.step != 2 or bad or big or any(r["tb"]["skipped_nonfinite"]
                                                for r in steps.rows):
            raise AssertionError(f"factory: training on the factory's labels: {state.step} "
                                 f"steps, non-finite {bad}, above {FACTORY_LOSS_BOUND}: {big}")
        print(f"factory training ({card}): 2 steps of the train CLI on the factory's labels and "
              f"prototype banks, each " + ", ".join(f"{r['ms']:.1f}" for r in steps.rows)
              + " ms; last tb: " + ", ".join(f"{k} {v:.4f}" for k, v in
                                               steps.rows[-1]["tb"].items()), flush=True)
    print(f"factory phase: {time.perf_counter() - t0:.1f} s ({card})", flush=True)
    return [
        factory_entry("radius_count", "factory: create_ppscore",
                      "cpd_tpu_torch/csrc/radius_count.cu",
                      "cpd_tpu/unsupervised/ppscore.py:83 (ppscore_jax, a JAX op chain; no "
                      "pl.pallas_call)", pp_launches[0], *r1_numbers, F32_CORE_FLOPS),
        factory_entry("dbscan", "factory: create_outline_boxes", "cpd_tpu_torch/csrc/dbscan.cu",
                      "cpd_tpu/unsupervised/outline.py:32 (dbscan_cluster, sklearn on the "
                      "host; no pl.pallas_call)", ob_launches[1], *r2_numbers,
                      F64_CORE_FLOPS),
    ]


def main():
    parser = argparse.ArgumentParser(description="Smoke run of the PyTorch port on one card.")
    parser.add_argument("--determinism", type=int, metavar="RUNS",
                        help="run only phase 13 (after the build), with RUNS runs of the step "
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
    kernels.append(eval_cli_phase(dev, card))
    torch.cuda.empty_cache()
    kernels += train_cli_phase(dev, card)
    torch.cuda.empty_cache()
    kernels += anchor_phase(dev, card)
    torch.cuda.empty_cache()
    kernels += factory_phase(dev, card)
    torch.cuda.empty_cache()

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
