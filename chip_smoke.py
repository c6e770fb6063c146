"""Smoke run of the PyTorch port on one CUDA card (an NVIDIA H100).

    python3 chip_smoke.py
    python3 chip_smoke.py --determinism RUNS [--no-cudnn]   # phase 13 alone
    python3 chip_smoke.py --registry                        # phase 18 alone
    python3 chip_smoke.py --ops                             # phase 19 alone
    python3 chip_smoke.py --parity                          # phases 20 and 21 alone
    python3 chip_smoke.py --nms                             # B4's paths and phase 22 alone
    python3 chip_smoke.py --factory                         # phase 15 alone
    python3 chip_smoke.py --rulebooks                       # phase 23 alone, path times
    python3 chip_smoke.py --path-times                      # the path times alone

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
step, the training CLI on OYSTER); both CLIs on ranks under ``torchrun``
(NCCL at one rank, gloo on 2 ranks sharing the card); the rest of the
detector registry (VoxelBackBone8x, VoxelSetAbstraction with kernel F1,
PartWraper, ConvGRU and CenterPoint through both CLIs, the X_TRAIN align
path); the pseudo-label factory's builder
(PPScore, MFCF + C_PROTO labels, the gt database) on a written 20-frame
drive and the training CLI on its labels; the training step
of ``cpd_tpu_torch.parallel``
(``VoxelRCNN.loss_step`` with ``mm=True``, batch 2, 64 label slots, backward,
clip, adam_onecycle; sparse tail); and the gather-formulation probes of
``cpd_tpu_torch.probes.gather`` at the probe scripts' own sizes. Phases, each
raising on failure:

1. card: needs CUDA; prints the card's name and power limit;
2. build: compiles every kernel source under cpd_tpu_torch/csrc/ (A1, A2,
   G1-G4, R1, R2, F1, B4a-c, B1a-B2) with nvcc for sm_90a, one process each, side by side, and
   the native host library (cpd_tpu_torch/native/src/pointcloud.cpp) with
   g++ beside them, and prints
   what ptxas reports per kernel (registers a thread, spills, stack frame; for each
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
    labels; first, what ptxas reports for kernels R1 and R2 (registers,
    stack frame, spills: neither may have a stack frame or spill); kernel
    R1 (PPScore's radius count) against its plain version on the middle
    frame's 4 windows of 5 frames (exact counts, a second launch
    bit-equal); ``create_ppscore`` with the R1 and R2 launches counted
    around it (20 and 0); ``create_outline_boxes`` with the cproto dataset
    yaml (MFCF + C_PROTO; R2 launches counted, none of R1), every R2 call
    recorded (its points and clouds, the launch's device ms between CUDA
    events and the wrapper's host ms, synchronised: their sums by calling
    function beside the record of one call a C-PROTO box); kernel R2
    (DBSCAN) against its plain version on the largest cloud it clustered
    and, in one segmented launch, on the C-PROTO call with the most box
    clouds (labels equal, twice); ``create_track_groundtruth_database`` on
    the port's dataset. Gates: every frame's PPScore file (f16, finite),
    labels of every frame with (n, 7) finite boxes, a track of
    ``remove_short_track`` (2) frames or more, a prototype bank, the gt
    database's schema, at most ``R2_CALLS_A_FRAME`` (2) R2 launches a
    frame, some of them segmented and some not (``dbscan_labels_batched.
    launches`` counts the segmented ones where they launch). Prints boxes a frame, tracks, banks, the launches
    and the seconds of each builder function and of each stage inside them;
    then 2 steps of the training CLI on the shipped cproto yaml on those
    labels and banks (finite losses). ``--factory`` runs the build and this
    phase alone.
16. KITTI and the native host library (it runs right after phase 15): (a)
    ``native.points_in_boxes_mask`` on the bench frame and 64 drawn boxes
    against its NumPy plain version (masks equal; host ms of each, median
    of 5 in turns), and phase 9's training loader alone on its sequence with
    the data layer's mask on either route (ms a frame, batches compared),
    beside phase 9's host share; (b) the evaluation CLI on the shipped
    voxel_rcnn_cproto_center_kitti.yaml at full width (MM weights present,
    150k voxels, stage caps 80k / 40k / 20k / 20k) on 8 KITTI-layout frames
    of 120k-point HDL-64E-like scans (``write_kitti_frames``), batch 2 (the
    yaml's), a checkpoint from ``save_checkpoint`` that must load back
    bit-equal with ``conv_input`` (27, 4, 16) in both branches; first the
    cap audit and A1 against its plain version on the 21 convs of one batch
    (the 4-channel input conv among them); gates: 21 A1 launches a batch,
    one finite record a frame with ``location``, ``dimensions``,
    ``rotation_y``, ``alpha`` and ``bbox``, R40 and R11 APs of Car,
    Pedestrian and Cyclist; its frames/s beside ``predict`` alone; (c) the
    training CLI on the same yaml and frames, ``--epochs 1 --debug_steps
    2``, MM on: first the cap audit of both views and A1 forward, A1 as dX
    and A2 against their plain versions on one step's operands; gates: (35
    + 33, 35) launches a step, the counters accounted for, finite losses
    with ``proto_loss``, no step skipped, a box labelled Car in the steps'
    batches; the CLI's phase means and each step's ms.
17. data parallel (it runs right after phase 16): the training and
    evaluation CLIs under ``python -m torch.distributed.run --standalone``
    on phase 9's yaml, frames and weights, global batch 4: (a) one rank on
    NCCL, 2 steps, then the eval CLI; (b) 2 ranks sharing the card over
    gloo (2 samples a rank): 2 steps stopped, 2 more auto-resumed with
    ``--eval_after 1``, 4 unbroken, then the eval CLI on 2 ranks; in the
    first (b) run each rank holds the A1 forward, A1 as dX and A2 operands
    of its first step against their plain versions. Gates (read from the ranks' ``rank R/W`` log lines):
    launches (35 + 33, 35) every step of every rank, the ranks' weights
    bit-equal, (b)'s resume bit-equal, (b)'s first loss within a relative
    0.5 of phase 9's, the merged result.pkl in dataset order and equal to
    (a)'s. Prints each rank's steps/s, phase means, step ms, peak memory,
    the gradient bucket's MB and all-reduce ms, and the norm collectives'
    count and ms (gloo staged through the host on one card, not NCCL
    across cards).
18. the rest of the detector registry (it runs right after phase 17), on
    phase 9's yaml, 8 written frames and seeded weights through a ``.pth``:
    (a) ``--set MODEL.BACKBONE_3D.NAME VoxelBackBone8x MODEL.PFE.NAME
    VoxelSetAbstraction MODEL.WRAP_HEAD.NAME PartWraper
    MODEL.TEMPORAL_MODEL.NAME ConvGRU``: A1 forward (24), A1 as dX (21) and
    A2 (23) against their plain versions on one batch-4 step's operands,
    kernel F1 against its plain version on one frame's 200k points and on
    the batch of 4 at 2048 keypoints (indices equal, the launch alone and
    the wrapper timed), the model's forward on that batch, which alone
    reads the PFE (1 F1 and 12 A1 launches, finite keypoint features), the
    evaluation CLI at batch 4 (12 A1 launches a batch, no F1: ``predict``
    reads no keypoint feature) and 2 steps of the training CLI with a weight
    decay of 1e-2 ((24, 21, 23) launches a step and no F1, finite losses
    with ``wrap_loss``, every PFE weight its seeded value decayed by AdamW
    alone); (b) ``--set MODEL.NAME CenterPoint`` through both CLIs ((21,
    20, 21) a step), A1 forward, A1 as dX and A2 held on one batch-4 step's
    operands and A1 on one batch-4 eval forward; (c) ``VoxelRCNN(align_stages=2,
    align_method="mean")`` with ConvGRU over one ``points_prev1`` frame at
    the bench width on XTransform clones of the bench frame: 42 A1
    launches packed, 63 sequential, the two predicts within the
    whole-predict tier, a finite ``loss_step``. Prints frames/s, step ms,
    F1's and its plain version's ms and peak memory. ``--registry`` runs the
    build and this phase alone.
19. the toolbox modules (``ops_phase``, right after 18): RoI-aware and
    RoI-point pooling, VectorPool, ATSS, DCN, the transformer, the NMS
    variants, the coders, the losses, the geometry helpers, the one-sample
    sparse conv and masked statistics, each at the CPU tests' size on the
    card and on the CPU (floats within 1e-4 of scale, integers equal), then
    at full size with its median ms and peak memory; no kernel of its own
    (the sparse conv launches A1, counted; the NMS calls launch B4b and
    B4c, counted, and their operands go to phase 22), so no kernels-line
    entry. ``--ops`` runs the build and this phase alone.
20. parity against the JAX package (``parity_phase``, right after 7): the
    f32 ``predict`` (TF32 off) of the bench configuration with both tails,
    on the committed reference's frame and weights
    (tests/torch_port_refs/bench_predict.npz: ``seeded_state_dict`` with
    its scaled output layers and calibrated norm statistics put over it),
    held to the jitted JAX predict it stores (``cpd_tpu_torch.utils.parity``):
    keys exact at every stage, features, head maps and RoIs within 1e-4 of
    scale, RoI labels exact, detections paired by box, the same count and
    labels, each pair within 1e-4 of scale and its score within 1e-3; a miss
    raises with the first differing key or the worst row; each tail's A1
    launches (15 and 21);
21. training with the dense tail (``dense_training_phase``, right after
    11): phase 11's batch, labels and weights with ``dense_tail=True``: one
    step at f32 against the sparse tail's on the same proposals, with the
    heads' output layers scaled by 0.05 (the loss within rtol 1e-4, as
    tests/test_torch_port_dense_tail_train.py holds the two tails; the
    gradients' worst leaf, cosine and norm ratio within 4 times those that
    the sparse tail's own order of summation gives: its step on the plain
    versions of A1 and A2; no fixed tier holds every leaf of a whole
    detector's step, where the sparse tail moves a leaf by up to 1.5e-2 of
    its module's scale against itself), A1 forward, A1 as
    dX and A2 against their plain versions on one bf16 step's operands, the
    trainer's first step launching (26, 24, 26) and no A2 in its forward,
    finite losses, then timed steps: ms, device busy ms, idle share, peak
    memory. ``--parity`` runs the build and phases 20 and 21 alone.
22. kernels B4a-c, rotated BEV overlap and NMS (``nms_phase``, right after
    19). Every path that runs them counts their launches around one run
    (``b4_counted``: the counts set to 0 just before, read just after, a
    ``B4 launches, <path>`` line; the flagship predict of both tails, the
    DBSCAN and PointPillars predicts, their batch-2 steps (the DBSCAN step
    launches B4a for the RoI head's target IoU), phase 19's NMS calls), and
    keeps copies of the operands of the NMS and BEV-overlap calls of that
    run (``recording_b4``; and of a batch-4 predict of the eval CLI phase).
    On each recorded NMS call's score-sorted operands (the flagship's
    proposal and final NMS at batch 1 and 4, the DBSCAN yaml's 4096
    proposals a sample at batch 2, phase 19's 8192-box call): B4b's words
    and B4c's keep sets (greedy or fast, as the call) equal to the plain
    versions, B4a on the same pairs within 2 ulp of its plain version; on
    each recorded overlap (the RoI head's target IoU) B4a. Each timed: the
    launch alone, the whole wrapper (corners and copies) and the plain
    version, medians of 5 in turns, with a bound. First, what ptxas reports
    for B4's kernels (registers, stack frame, spills): B4a and B4b must have
    neither a stack frame nor spills. ``--nms`` runs the build,
    these paths alone (the dense-tail predict with its stage ms, the DBSCAN
    predict with its ``iou_nms`` stage and memory, a DBSCAN training forward
    and loss at batch 2, the PointPillars predict, phase 19's NMS calls)
    and this phase.
23. kernels B1a, B1b and B2, rulebook construction (``rulebook_phase``,
    right after 6): first what ptxas reports for the four kernels (``B1
    ptxas`` lines: none may have a stack frame or spill); then the predicts
    of both tails (batch 1) and a training step (``mm=True``, batch 2: both
    branches, the transposes), each counted
    (``rb_counted``: the counts set to 0 just before, read just after; a
    ``B1 launches, <path>`` line; (B1a, B1b, B2) must be (1, 5, 2) with the
    dense tail, (1, 8, 4) with the sparse tail and (2, 22, 7) for the step)
    with the operands of each call and each branch call kept
    (``TableRecorder``). Then every book of those runs bit-equal to the plain
    twins of ``ops/sparse.py`` (on the CPU, on copies of the same keys: found,
    idx where found, out_keys, out_valid), each path's branch calls again
    under ``torch.cuda.set_sync_debug_mode("error")`` (no host sync), each
    kernel call equal to its plain version (``ops/rulebook.py``'s
    ``*_reference`` on the same operands), and the main path's calls (the
    dense-tail predict) timed: the wrapper's device ms (a spin ahead),
    its host ms a call, the plain version's ms, the bound (bytes at 3.35
    TB/s). ``--rulebooks`` runs the build, this phase on models of its own
    and the path times (``path_times``: each predict's ms, stage ms, busy
    ms and idle share, the step's ms and busy ms); ``--path-times`` the
    build and the path times alone, which run in the parent tree too.

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
the launches of ``create_ppscore`` and ``create_outline_boxes`` (R2 twice:
all its calls, with the largest cloud's times, and its segmented calls, with
the times of one frame's box clouds), the median
ms of the launch alone (``ms``) and of the whole wrapper with its grid and
sorts (``wrapper_ms``), the plain version's ms of one call at the checked
shapes, and a bound from those inputs: bytes at 3.35 TB/s against the pairs
the function needs at 8 operations each (R1: the neighbour pairs its counts
hold; R2: the pairs within eps, each once, f64) over the CUDA cores' 67
TFLOP/s f32 (34 f64), not the kernels' own walks, which test 3-6 times as
many; ``library_ms`` is null (no PyTorch call computes either function). F1
(phase 18) gives the F1 launches of (a)'s keypoint forward (the CLIs
launch none) and its ms (``forward_ms``), the median ms of the launch alone
(``ms``) and of the whole wrapper (``wrapper_ms``) and the plain version's
on one frame (and ``batch_*`` on the batch of 4), a bound
of the bytes (coordinates and mask read once, indices written once) at 3.35
TB/s against B x 2048 x N distance updates of 9 f32 operations at 67
TFLOP/s; ``library_ms`` null. B4a-c (phase 22) give the launches of their
main path's counted run (B4b and B4c: the flagship predict with the dense
tail; B4a: the DBSCAN batch-2 step, the RoI head's target IoU) and
``launches_by_path`` for every counted path, the launch-alone ms
(``ms``), the whole wrapper's (``wrapper_ms``) and the plain version's
summed over that run's recorded calls, and a bound: the boxes read once,
the output written once, at 3.35 TB/s, against the f32 operations these
pairs need (B4a every pair, B4b the valid pairs above the diagonal): 8 for
the disjoint-pair reject (``iou3d.clip_reject``) on each, the clip
formulation's on each pair the reject lets through (2 an edge pass, 6 a
vertex, 8 a crossing, 4 a shoelace term, 2 for the area), and 6 for B4b's
IoU and test, at 67 TFLOP/s (each line also prints the bound of the clip
on every pair); B4c is bound by its bytes (the words its
sweep needs, ``b4_suppress_bytes``). ``library_ms``
null: no PyTorch call computes rotated IoU or NMS. B1a, B1b and B2 (phase
23) give the launches of the dense-tail predict's counted run and
``launches_by_path`` for the three counted paths (B2's count is calls of its
wrapper, each of which launches two kernels, ``dilate`` and ``compact``, with
a ``torch.cumsum`` between them; B1a's wrapper launches one, ``set_bits``,
and a ``cumsum`` after it), the device ms of the
wrapper's launches (``ms``), its host ms a call (``wrapper_ms``) and the plain
version's ms, summed over that run's calls, ``max_abs_err`` the largest
difference of any output element from the plain version over every checked
call of the three paths (0: the check asks for equal integers), and a bound
of bytes alone at 3.35 TB/s: B1a the keys read and the words and prefixes written, B1b the row
keys and the table words (with their prefixes) its taps touch read and
idx, found and valid written, B2 the input words read and the output words,
prefixes, keys and valid flags written; ``library_ms`` null (no PyTorch
call builds a rulebook).
"""
import argparse
import ast
import contextlib
import json
import logging
import math
import os
import pickle
import re
import signal
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from cpd_tpu_torch.config import ConfigDict, cfg_from_list, cfg_from_yaml_file
from cpd_tpu_torch.datasets import build_dataloader
from cpd_tpu_torch.datasets.box_np import points_in_boxes_mask_fast
from cpd_tpu_torch.datasets.registry import build_dataset
from cpd_tpu_torch.models import backbone3d, build_network
from cpd_tpu_torch.models.backbone3d import build_branch_rulebooks, stage_grids
from cpd_tpu_torch.models.bev import height_compression
from cpd_tpu_torch.models.anchor_head import point_density_anchor_mask
from cpd_tpu_torch.datasets.augmentor import XTransform
from cpd_tpu_torch.models.centerpoint import CenterPoint
from cpd_tpu_torch.models.detector import VoxelRCNN, keys_from_frame, set_compute_dtype
from cpd_tpu_torch.ops import cuda_build
from cpd_tpu_torch.ops import gather_gemm as a1
from cpd_tpu_torch.ops import gather_probes as gp
from cpd_tpu_torch.ops import sparse
from cpd_tpu_torch import parallel
from cpd_tpu_torch.ops import iou3d
from cpd_tpu_torch.ops import nms
from cpd_tpu_torch.ops import dbscan as r2
from cpd_tpu_torch.ops import radius as r1
from cpd_tpu_torch.ops import fps as f1
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
from cpd_tpu_torch.utils import parity
from cpd_tpu_torch.utils.device import place
from cpd_tpu_torch.utils.yaml_subset import load_file
from cpd_tpu_torch.datasets import waymo_unsupervised as builder
from cpd_tpu_torch.unsupervised import outline
from cpd_tpu_torch.unsupervised.ppscore import frame_windows
from cpd_tpu_torch import native
from cpd_tpu_torch.utils.synthetic import (class_boxes, make_lidar_frame, make_lidar_sequence,
                                           make_tiny_train_batch,
                                           make_train_batch, write_gt_database,
                                           write_kitti_frames, write_waymo_sequence)
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
# the same step with the dense tail: stage 4 (and branch 0's conv_out) run as
# dense conv3d, which leaves branch 0 conv_input + 4, down2 + 4, down3 + 4 (15)
# and branch 1 conv_input + 4, down2 + 2, down3 + 2 (11) sparse convs
DENSE_TRAIN_A1_FORWARD, DENSE_TRAIN_A1_DX, DENSE_TRAIN_A2 = 26, 24, 26
# phase 21's gate: the loss within rtol 1e-4 (as tests/test_torch_port_dense_tail_train.py
# holds the two tails), and the gradients no further from the sparse tail's
# than 4 times what the sparse tail's own order of summation moves them
DENSE_TRAIN_LOSS_RTOL, DENSE_TRAIN_NOISE_FACTOR = 1e-4, 4.0
# the f32 gate's weights: phase 11's with the heads' output layers scaled, as
# the parity reference's (tests/test_torch_port_bench_parity.py): seeded, the
# heatmap saturates into the focal loss's clamp, whose kinks make the
# gradient a function of rounding
GATE_OUTPUT_SCALE = 0.05
DENSE_TRAIN_TIMED = 3
BENCH_REFERENCE = "tests/torch_port_refs/bench_predict.npz"
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
# phase 15's record of kernel R2's calls over create_outline_boxes when
# C-PROTO made one call a box (calls, summed launch ms, summed wrapper ms, the
# card), printed beside this run's; the gate on R2's calls a frame (MFCF's and
# C-PROTO's segmented call)
R2_BOX_CALLS = (2241, 4318.887, 6529.642, "NVIDIA H100 80GB HBM3, 700.00 W")
R2_CALLS_A_FRAME = 2
KITTI_YAML = "tools/cfgs/models/voxel_rcnn_cproto_center_kitti.yaml"
KITTI_FRAMES = 8
KITTI_POINTS = 120_000  # an HDL-64E scan
NATIVE_BOXES = 64
NATIVE_REPS = 5
PHASE9 = {}  # the train-CLI phase's host numbers, for phase 16's native-library line
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


def check_kernel(label, calls, kernel, plain, out_dtype, timed=True):
    """One kernel use against its plain version on each recorded call's bf16
    operands ``(name, table, idx, found, other)``: in f32 (the kernel's
    arithmetic; TF32 is off) within 1e-4 of the output's scale plus rtol 1e-4,
    and in bf16 as the main path runs it, against the plain version's f32
    result, within rtol 1e-2 + 1e-2 of the output's scale; a second launch
    must give the same bits (no atomics in either kernel). ``kernel`` and
    ``plain`` take (table, idx, found, other, out_dtype). Returns the largest
    bf16 error and, per layer shape, the median times (not ``timed``: none)
    and the bound."""
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
                lambda: plain(table, idx, found, other, out_dtype)) if timed else (None, None)
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
    if not timed:
        return max_err, list(shapes.values())
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
    thread, spilled bytes, stack frame, static shared memory) and, for A1 and A2, whose
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
              f"{max(r[4] for r in rows)} bytes of stack frame and "
              f"{max(r[3] for r in rows)} bytes of static shared memory at most")
    for name in ("gather_gemm_flat", "gather_gemm_per_tap", "lane_gather_gemm", "lane_gather"):
        for kernel, regs, spilled, smem, stack in cuda_build.kernel_resources(name):
            print(f"{name} instance {kernel}: {regs} registers a thread, {spilled} bytes "
                  f"spilled, {stack} bytes of stack frame, {smem} bytes of static shared memory")
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
    and A2 in the backward (calls made after ``in_backward`` is set). With
    ``copy`` it keeps copies, as they were at the launch (a weight moves
    with the optimizer's step)."""

    def __init__(self, copy=False):
        self.calls = {"forward": [], "dx": [], "dw": []}
        self.in_backward = False
        self.copy = copy

    def _keep(self, kind, *operands):
        if self.copy:
            operands = tuple(None if t is None else t.clone() for t in operands)
        self.calls[kind].append((f"{kind}[{len(self.calls[kind])}]", *operands))

    def __enter__(self):
        self.saved = (sparse.gather_gemm, sparse.gather_gemm_dw)

        def gather_gemm(table, idx, found, w_flat, out_dtype=torch.float32):
            self._keep("dx" if self.in_backward else "forward", table, idx, found, w_flat)
            return self.saved[0](table, idx, found, w_flat, out_dtype)

        def gather_gemm_dw(table, idx, found, g_out):
            self._keep("dw", table, idx, found, g_out)
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
    return recorded_train_checks(rec, want)


def recorded_train_checks(rec, want=(TRAIN_A1_FORWARD, TRAIN_A1_DX, TRAIN_A2), timed=True):
    """Every recorded launch of A1 forward, A1 as dX and A2 against its plain
    version (``timed``: and each shape timed); raises unless the recorder
    holds ``want`` launches of each. Returns {use: (max err, shapes)}."""
    counts = {k: len(v) for k, v in rec.calls.items()}
    want = dict(zip(("forward", "dx", "dw"), want))
    if counts != want:
        raise AssertionError(f"recorded kernel calls {counts}, want {want}")
    bf16 = torch.bfloat16
    return {"forward": check_kernel("A1 train forward", rec.calls["forward"], a1_kernel,
                                    a1_plain, bf16, timed),
            "dx": check_kernel("A1 as dX", rec.calls["dx"], a1_kernel, a1_plain, bf16, timed),
            "dw": check_kernel("A2", rec.calls["dw"], a2_kernel, a2_plain, torch.float32,
                               timed)}


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
                   statistics.median(ms), loops=1)

    src1, src2 = "cpd_tpu_torch/csrc/gather_gemm.cu", "cpd_tpu_torch/csrc/gather_gemm_dw.cu"
    return [
        kernel_entry("gather_gemm", "train step, forward", src1, "cpd_tpu/ops/pallas_conv.py:77",
                     forward_launches, *checks["forward"]),
        kernel_entry("gather_gemm (dX)", "train step, backward", src1,
                     "cpd_tpu/ops/pallas_conv.py:77", a1_total - forward_launches, *checks["dx"]),
        kernel_entry("gather_gemm_dw", "train step, backward", src2,
                     "cpd_tpu/ops/pallas_conv.py:130", a2_launches, *checks["dw"]),
    ]


@contextlib.contextmanager
def computing_in_f32(model):
    """``model`` computes in f32 inside the scope (TF32 is off), in its own
    compute dtypes after it."""
    saved = [(m, m.compute_dtype) for m in model.modules() if hasattr(m, "compute_dtype")]
    set_compute_dtype(model, None)
    try:
        yield model
    finally:
        for m, dtype in saved:
            m.compute_dtype = dtype


def dense_training_phase(dev, card):
    """Phase 21: the training step with the dense tail (``dense_tail=True``,
    ``mm=True``, batch 2, bf16 as the model ships), on the batch, labels and
    weights of phase 11's sparse-tail step. Gates: (a) one step at f32
    against the sparse tail's on the same proposals (the heads' output layers
    scaled by ``GATE_OUTPUT_SCALE``): the loss within rtol 1e-4, and the
    gradients' worst leaf (over its module's scale), 1 - cosine and norm
    ratio each within 4 times those of the sparse tail on the plain versions
    of A1 and A2 (reordering alone); (b) A1 forward, A1
    as dX and A2 against their plain versions on one step's operands; (c)
    the trainer's first step launches (26, 24, 26) and none of A2 in its
    forward; finite losses, no skipped step. Prints the step's ms, device
    busy ms and idle share, and peak memory. Returns the kernels-line
    entries of its three kernel uses."""
    t0 = time.perf_counter()
    cfg = dict(BENCH, mm=True)
    sparse_model = VoxelRCNN(**cfg)
    sparse_model.load_state_dict(seeded_state_dict(sparse_model, 0), strict=True)
    sparse_model = place(sparse_model, dev)
    raw = to_device(make_train_batch(0, TRAIN_BATCH, N_POINTS), dev)
    batch, matched = labels_on_proposals(sparse_model, raw, n_labelled=40)
    trained = {k: v.clone() for k, v in sparse_model.state_dict().items()}
    # the gate's weights and labels, placed on the scaled model's own proposals
    sparse_model.load_state_dict({k: v * GATE_OUTPUT_SCALE if k.endswith(".out.weight") else v
                                  for k, v in trained.items()}, strict=True)
    gate_batch, _ = labels_on_proposals(sparse_model, raw, n_labelled=40)
    model = place(VoxelRCNN(**dict(cfg, dense_tail=True)), dev)
    model.load_state_dict(sparse_model.state_dict(), strict=True)
    t_gate = time.perf_counter()
    t_setup = t_gate - t0
    with computing_in_f32(sparse_model), computing_in_f32(model):
        loss_s, _, grads_s, props = parity.loss_and_gradients(sparse_model, gate_batch, 0)
        loss_d, tb_d, grads_d, _ = parity.loss_and_gradients(model, gate_batch, 0, props)
        with parity.plain_sparse_convs():  # the sparse tail in another order of summation
            _, _, grads_p, _ = parity.loss_and_gradients(sparse_model, gate_batch, 0, props)
    torch.cuda.synchronize()
    t_gate = time.perf_counter() - t_gate
    rel = abs(loss_d - loss_s) / max(abs(loss_s), 1e-12)
    lines, misses = parity.compare_gradients(grads_d, grads_s,
                                             parity.gradient_errors(grads_p, grads_s),
                                             DENSE_TRAIN_NOISE_FACTOR)
    print(f"dense-tail step against the sparse tail at f32 on the same proposals: loss "
          f"{loss_d:.6f} against {loss_s:.6f} (rel {rel:.2e}); {lines[0]}", flush=True)
    gate = None  # raised after the timed steps, so that one run reports them too
    if not rel <= DENSE_TRAIN_LOSS_RTOL or misses or not float(tb_d["rcnn_reg0"]) > 0:
        gate = (f"dense-tail step against the sparse tail: loss rel {rel:.2e} (rcnn_reg0 "
                f"{tb_d['rcnn_reg0']}); " + "; ".join(misses))
    del sparse_model, grads_s, grads_d, grads_p, props, gate_batch, raw
    model.load_state_dict(trained, strict=True)
    model.zero_grad(set_to_none=True)
    torch.cuda.empty_cache()

    generator = torch.Generator(device=dev).manual_seed(0)
    want = (DENSE_TRAIN_A1_FORWARD, DENSE_TRAIN_A1_DX, DENSE_TRAIN_A2)
    t_checks = time.perf_counter()
    checks = train_kernel_checks(model, batch, generator, want=want)
    t_checks = time.perf_counter() - t_checks

    state = init_state(model, OPT_CFG, total_steps=100, device=dev)
    train_step = make_train_step()
    with StepMarks(state) as marks:
        a1.gather_gemm.launches = a1.gather_gemm_dw.launches = 0
        state, tb = train_step(state, batch, generator)
        torch.cuda.synchronize()
        a1_total, a2_launches = a1.gather_gemm.launches, a1.gather_gemm_dw.launches
        forward_launches, a2_in_forward = marks.rows[0]["forward_launches"]
        got = (forward_launches, a1_total - forward_launches, a2_launches, a2_in_forward)
        if got != want + (0,):
            raise AssertionError(f"the dense-tail train step launched (A1 forward, A1 dX, A2, "
                                 f"A2 in the forward) = {got}, want {want + (0,)}")
        first_loss = float(tb["total_loss"])
        state, tb = train_step(state, batch, generator)  # second warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step_s, skipped = [], 0.0
        for _ in range(DENSE_TRAIN_TIMED):
            t1 = time.perf_counter()
            state, tb = train_step(state, batch, generator)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t1)
            skipped += float(tb["skipped_nonfinite"])
            bad = [k for k, v in tb.items() if not math.isfinite(float(v))]
            if bad or not math.isfinite(first_loss):
                raise AssertionError(f"dense-tail step {state.step}: non-finite {bad}, first "
                                     f"loss {first_loss}")
        peak = torch.cuda.max_memory_allocated()
        phases = marks.phase_ms(marks.rows[-DENSE_TRAIN_TIMED:])
    if skipped or "proto_loss" not in tb:
        raise AssertionError(f"dense-tail steps: skipped {skipped}, proto_loss in tb "
                             f"{'proto_loss' in tb}")
    ms = sorted(s * 1e3 for s in step_s)
    t_profile = time.perf_counter()
    busy, idle = device_profile(lambda: train_step(state, batch, generator),
                                "train step (dense tail)", statistics.median(ms), loops=1)
    t_profile = time.perf_counter() - t_profile
    print(f"dense-tail train step ({TRAIN_BATCH} frames, {matched} labels a sample): launches "
          f"(A1 forward, A1 dX, A2) {want}; ms over {DENSE_TRAIN_TIMED} steps median "
          f"{statistics.median(ms):.2f} min {ms[0]:.2f} max {ms[-1]:.2f}; busy {busy:.2f} ms, "
          f"idle share {idle:.3f}; peak memory {peak / 2**30:.2f} GiB; total loss first "
          f"{first_loss:.4f} last {float(tb['total_loss']):.4f}; phases "
          + ", ".join(f"{k} {v:.2f}" for k, v in phases.items())
          + f"; {time.perf_counter() - t0:.1f} s, of it set-up {t_setup:.1f} s, the f32 gate "
          f"{t_gate:.1f} s, the kernel checks {t_checks:.1f} s, the profile {t_profile:.1f} s "
          f"({card})", flush=True)
    del state, model, batch
    torch.cuda.empty_cache()
    if gate:
        raise AssertionError(gate)
    src1, src2 = "cpd_tpu_torch/csrc/gather_gemm.cu", "cpd_tpu_torch/csrc/gather_gemm_dw.cu"
    return [
        kernel_entry("gather_gemm", "train step (dense tail), forward", src1,
                     "cpd_tpu/ops/pallas_conv.py:77", forward_launches, *checks["forward"]),
        kernel_entry("gather_gemm (dX)", "train step (dense tail), backward", src1,
                     "cpd_tpu/ops/pallas_conv.py:77", a1_total - forward_launches,
                     *checks["dx"]),
        kernel_entry("gather_gemm_dw", "train step (dense tail), backward", src2,
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
    with recording_b4(f"predict, {what}, batch 1"):
        out = b4_counted(f"predict, {what}", lambda: model.predict(batch), B4_NMS)
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


def parity_phase(dev, card):
    """Phase 20: the f32 predict at the bench configuration, with both tails,
    held to the JAX package's committed reference (``BENCH_REFERENCE``,
    ``cpd_tpu_torch.utils.parity``): the reference's weights over the seeded
    ones, its frame, TF32 off; keys exact at every stage, features, head maps
    and RoIs within 1e-4 of scale, RoI labels exact, detections paired by box
    with the same count and labels, every pair within 1e-4 of scale and its
    score within 1e-3. A miss raises with the first differing key or the
    worst row. Prints each tail's A1 launches."""
    t0 = time.perf_counter()
    ref = parity.load_reference(Path(__file__).resolve().parent / BENCH_REFERENCE)
    meta = ref["meta"]
    pts, valid = make_lidar_frame(np.random.default_rng(int(meta["frame_seed"])),
                                  int(meta["n_points"]))
    batch = {"points": torch.from_numpy(pts)[None].to(dev),
             "points_valid": torch.from_numpy(valid)[None].to(dev)}
    launches = {}
    for dense in (True, False):
        tail = "dense" if dense else "sparse"
        model = VoxelRCNN(**dict(BENCH, dense_tail=dense))
        model.load_state_dict(parity.reference_state_dict(model, ref), strict=True)
        model = set_compute_dtype(place(model.eval(), dev), None)
        a1.gather_gemm.launches = 0
        with torch.no_grad():
            out = model(batch)
            pred = model.post_processing(out)
        torch.cuda.synchronize()
        launches[tail] = a1.gather_gemm.launches
        lines, misses = parity.compare(parity.record(out, pred), ref)
        for line in lines:
            print(f"parity against JAX, {tail} tail: {line}")
        if misses:
            raise AssertionError(f"the {tail} tail's f32 predict differs from the JAX "
                                 f"reference:\n" + "\n".join(misses))
        if launches[tail] != A1_PER_FORWARD[dense]:
            raise AssertionError(f"parity, {tail} tail: A1 launched {launches[tail]} times, "
                                 f"want {A1_PER_FORWARD[dense]}")
        del model, out, pred
    print(f"parity against JAX: both tails within the tiers; A1 launches {launches}; "
          f"{time.perf_counter() - t0:.1f} s ({card})", flush=True)


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
        with recording_b4(f"eval CLI predict, batch {batch_size}"):
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
        self.saved = parallel.make_train_step, VoxelRCNN.loss_step, CenterPoint.loss_step
        make = self.saved[0]
        rows = self.rows

        def counts():
            return a1.gather_gemm.launches, a1.gather_gemm_dw.launches

        def counted(loss_step):
            def counted_loss_step(model, *args, **kwargs):
                out = loss_step(model, *args, **kwargs)
                rows[-1]["forward"] = counts()
                return out
            return counted_loss_step

        def counted_make_train_step():
            step = make()

            def counted_step(state, batch, generator=None, sampling_uniforms=None):
                rows.append({"run": self.run, "start": counts()})
                t0 = time.perf_counter()
                state, tb = step(state, batch, generator, sampling_uniforms)
                counted_step.trace = step.trace  # the CLI logs it
                torch.cuda.synchronize()
                row = rows[-1]
                (s1, s2), (f1, f2), (e1, e2) = row["start"], row["forward"], counts()
                row.update(launches=(f1 - s1, e1 - f1, e2 - s2, f2 - s2),
                           ms=(time.perf_counter() - t0) * 1e3,
                           tb={k: float(v) for k, v in tb.items()})
                return state, tb
            return counted_step

        parallel.make_train_step = counted_make_train_step
        VoxelRCNN.loss_step, CenterPoint.loss_step = (counted(f) for f in self.saved[1:])
        return self

    def __exit__(self, *exc):
        parallel.make_train_step, VoxelRCNN.loss_step, CenterPoint.loss_step = self.saved


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
        PHASE9.update(share=share, loader_ms=loader_s / EVAL_FRAMES * 1e3, means=means,
                      first_loss=steps.rows[0]["tb"]["total_loss"],
                      step_ms=[r["ms"] for r in steps.rows if r["run"] == "c"],
                      steps_per_s=statistics.median(e[1] for e in runs["c"]))
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
    top ``NMS_PRE_MAXSIZE`` per sample, rotated IoU + NMS of the batch: B4b
    and B4c), and the
    device memory that the IoU + NMS part adds at its peak."""
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
        step("top_k", lambda: nms.top_k(scores.amax(-1), pre))
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ts, ti = state["top_k"]
        nms_args = dict(thresh=rpn["NMS_THRESH"], pre_max_size=pre, post_max_size=n_rois,
                        fast=bool(rpn.get("USE_FAST_NMS", True)))
        step("iou_nms", lambda: nms.nms_bev_batched(
            nms.gather_rows(boxes, ti), ts, valid=ts > 0.0, **nms_args))
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
    with recording_b4(f"{what} predict, batch 1"):
        out = b4_counted(f"{what} predict", lambda: model.predict(batch), B4_NMS)
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
    # one call: the trace of an anchor predict holds about 30,000 device ops,
    # and reading three of them back took 48-54 s of the phase
    device_profile(lambda: model.predict(batch), f"predict ({what})",
                   1e3 / statistics.median(fps), loops=1)
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


def anchor_train_phase(model, batch, what, card, dev, want, b4_want):
    """A batch-2 training step of an anchor model through ``make_train_step``
    on labels moved onto its own proposals: (A1 forward, A1 dX, A2) launches
    of the first step as ``want``, finite terms with the anchor losses, no
    step skipped, 2 warm-ups then timed steps (ms, phases, peak memory), a
    profiler window, and the step bit-identical twice. ``b4_want`` flags the
    kernels of B4 (a, b, c) that its first step must launch."""
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
        with recording_b4(f"{what} step, batch {TRAIN_BATCH}"):
            state, tb = b4_counted(f"{what} step", lambda: train_step(state, batch, generator),
                                   b4_want)
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
    # one step: its trace holds about 97,000 device ops (93 s for two)
    device_profile(lambda: train_step(state, batch, generator), f"train step ({what})",
                   statistics.median(ms), loops=1)
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
                             (ANCHOR_A1_FORWARD, ANCHOR_A1_DX, ANCHOR_A2), B4_ALL)
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
    anchor_train_phase(model, train_batch, "PointPillars", card, dev, (0, 0, 0), B4_NONE)
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
    device_profile(run, "R1 call", wrapper_ms)
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
    device_profile(run, "R2 call", wrapper_ms)
    tests = grid_pair_tests(pts, eps * r1.CELL_MARGIN)
    pairs = (len(r2.neighbour_pairs(pts, eps)[0]) - len(pts)) // 2
    nbytes = pts.numel() * 8 + out.numel() * 4
    print(f"R2 dbscan ({card}): the largest cloud of create_outline_boxes: {len(pts)} points, "
          f"eps {eps}, min_samples {min_samples}: {int(out.max()) + 1} clusters, "
          f"{int((out < 0).sum())} noise, {pairs} pairs within eps, {tests} pair tests a walk "
          f"of the kernel's cells; equal to plain on every point, bit-equal twice; launch "
          f"{ms:.3f} ms, wrapper {wrapper_ms:.3f} ms (medians of 5), plain {plain_ms:.1f} ms "
          f"(one call)", flush=True)
    return ms, wrapper_ms, plain_ms, nbytes, 8.0 * pairs


def calling_function(skip_files):
    """Name of the nearest function on the stack outside ``skip_files``."""
    frame = sys._getframe(1)
    while frame is not None and Path(frame.f_code.co_filename).name in skip_files:
        frame = frame.f_back
    return frame.f_code.co_name if frame is not None else "?"


def factory_r2_segmented_check(batch, card):
    """Kernel R2's segmented launch against its plain version (each segment
    alone) on ``batch`` = (points, offsets, eps, min_samples), the C-PROTO
    call with the most box clouds: labels equal on every point, twice.
    Returns (launch ms, wrapper ms, plain ms, bytes, operations): 8 f64
    operations for each pair within eps of one segment, counted once."""
    pts, offsets, eps, min_samples = batch
    run = lambda: r2.dbscan_labels_batched(pts, offsets, eps, min_samples)
    out, again = run(), run()
    ref, plain_ms = timed_once_ms(
        lambda: r2.dbscan_batched_reference(pts, offsets, eps, min_samples))
    if not (torch.equal(out, ref) and torch.equal(out, again)):
        raise AssertionError(f"R2 segmented: labels differ from the plain version on "
                             f"{int((out != ref).sum())} of {len(out)} points (or between "
                             f"launches)")
    offs = r2.segment_offsets_of(offsets, len(pts))
    ops = r2.dbscan_operands(pts, eps, offs)
    ms, wrapper_ms = paired_median_ms(lambda: r2.dbscan_launch(ops, min_samples), run)
    device_profile(run, "segmented R2 call", wrapper_ms)
    bounds = offs.tolist()
    pairs = sum((len(r2.neighbour_pairs(pts[a:b], eps)[0]) - (b - a)) // 2
                for a, b in zip(bounds[:-1], bounds[1:]))
    sizes = offs[1:] - offs[:-1]
    clusters = sum(int(out[a:b].max()) + 1 for a, b in zip(bounds[:-1], bounds[1:]) if b > a)
    print(f"R2 dbscan segmented ({card}): one frame's C-PROTO box clouds in one launch: "
          f"{len(sizes)} segments of {int(sizes.min())}-{int(sizes.max())} points, {len(pts)} "
          f"in all, eps {eps}, min_samples {min_samples}: {clusters} clusters, "
          f"{int((out < 0).sum())} noise, {pairs} pairs within eps; equal to plain on every "
          f"point, bit-equal twice; launch {ms:.3f} ms, wrapper {wrapper_ms:.3f} ms (medians "
          f"of 5), plain {plain_ms:.1f} ms (one call)", flush=True)
    return ms, wrapper_ms, plain_ms, pts.numel() * 8 + out.numel() * 4, 8.0 * pairs


class R2Calls:
    """While active, every call that the factory's clustering makes into
    kernel R2 (the entries that ``outline`` imported from ``ops.dbscan``:
    ``dbscan_labels``, ``dbscan_labels_batched``) is recorded in
    ``self.calls`` as (calling function, entry, points, clouds, launch ms,
    wrapper ms): the launch is ``r2.dbscan_launch`` between two CUDA events
    (the kernels and whatever the card waits for between them), the wrapper
    the host clock from the call to its labels on the card, synchronised.
    The largest single cloud is kept in ``self.cloud`` as (points, eps,
    min_samples), the segmented call with the most segments in
    ``self.batch`` as (points, offsets, eps, min_samples)."""

    ENTRIES = ("dbscan_labels", "dbscan_labels_batched")

    def __enter__(self):
        self.calls, self.cloud, self.batch, self._launch_ms = [], None, None, 0.0
        self.saved = {name: getattr(outline, name) for name in self.ENTRIES
                      if hasattr(outline, name)}
        self.saved_launch = r2.dbscan_launch
        launch = self.saved_launch

        def timed_launch(*args, **kw):
            start = cuda_event()
            out = launch(*args, **kw)
            end = cuda_event()
            end.synchronize()
            self._launch_ms += start.elapsed_time(end)
            return out

        def recording(name, entry):
            def call(points, *args):
                offsets = args[0] if len(args) == 3 else None
                segments = 1 if offsets is None else len(offsets) - 1
                if offsets is None and (self.cloud is None or len(points) > len(self.cloud[0])):
                    self.cloud = (points.clone(), *args)
                if offsets is not None and (self.batch is None or
                                            segments > len(self.batch[1]) - 1):
                    self.batch = (points.clone(), np.array(offsets), *args[1:])
                caller = calling_function({"outline.py", Path(__file__).name})
                self._launch_ms = 0.0
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = entry(points, *args)
                torch.cuda.synchronize()
                self.calls.append((caller, name, len(points), segments, self._launch_ms,
                                   (time.perf_counter() - t0) * 1e3))
                return out
            return call

        for name, entry in self.saved.items():
            setattr(outline, name, recording(name, entry))
        r2.dbscan_launch = timed_launch
        return self

    def __exit__(self, *exc):
        for name, entry in self.saved.items():
            setattr(outline, name, entry)
        r2.dbscan_launch = self.saved_launch

    def summary(self, card):
        """Prints the calls, their summed launch and wrapper ms and the
        largest cloud, in all and by calling function, beside the record
        of one call a C-PROTO box; returns (calls, summed launch ms, summed
        wrapper ms)."""
        by = {}
        for caller, _, n, segments, launch, wrapper in self.calls:
            row = by.setdefault(caller, [0, 0, 0, 0, 0.0, 0.0])
            row[0] += 1
            row[1] += segments
            row[2] += n
            row[3] = max(row[3], n)
            row[4] += launch
            row[5] += wrapper
        launch_ms = sum(c[4] for c in self.calls)
        wrapper_ms = sum(c[5] for c in self.calls)
        print(f"R2 calls over create_outline_boxes ({card}): {len(self.calls)} calls of "
              f"{sum(c[3] for c in self.calls)} clouds, {sum(c[2] for c in self.calls)} points "
              f"in all, the largest call {max((c[2] for c in self.calls), default=0)}; summed "
              f"launch {launch_ms:.3f} ms, summed wrapper {wrapper_ms:.3f} ms (one call a "
              f"C-PROTO box, as recorded before the segmented call on {R2_BOX_CALLS[3]}: "
              f"{R2_BOX_CALLS[0]} calls, {R2_BOX_CALLS[1]:.3f} ms, {R2_BOX_CALLS[2]:.3f} ms); "
              f"by calling function: " + "; ".join(
                  f"{k}: {v[0]} calls of {v[1]} clouds, {v[2]} points, largest call {v[3]}, "
                  f"launch {v[4]:.3f} ms, wrapper {v[5]:.3f} ms" for k, v in by.items()),
              flush=True)
        return len(self.calls), launch_ms, wrapper_ms


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


def factory_resources():
    """Kernels R1 and R2 as ptxas reports them (registers, stack frame,
    spills); raises where one has a stack frame or spills."""
    for name in ("radius_count", "dbscan"):
        rows = cuda_build.kernel_resources(name)
        if not rows:
            print(f"{name} ptxas: the build was reused, no report in this process", flush=True)
        for kernel, regs, spilled, smem, stack in rows:
            print(f"{name} ptxas {kernel}: {regs} registers a thread, {stack} bytes of stack "
                  f"frame, {spilled} bytes spilled, {smem} bytes of static shared memory",
                  flush=True)
        if any(r[2] or r[4] for r in rows):
            raise AssertionError(f"{name}: a kernel with a stack frame or spills: {rows}")


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
    factory_resources()
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
        r2.dbscan_labels_batched.launches = 0
        timer = PhaseTimer()
        t1 = time.perf_counter()
        builder.create_ppscore(root, [EVAL_SEQ], device=dev, timer=timer)
        stages["create_ppscore"] = time.perf_counter() - t1
        pp_launches = (r1.radius_count.launches, r2.dbscan_labels.launches)
        pp_stages = dict(timer.totals)

        r1.radius_count.launches = r2.dbscan_labels.launches = 0
        r2.dbscan_labels_batched.launches = 0
        timer = PhaseTimer()
        t1 = time.perf_counter()
        with R2Calls() as r2_calls:
            builder.create_outline_boxes(root, [EVAL_SEQ], cfg, device=dev, timer=timer)
        stages["create_outline_boxes"] = time.perf_counter() - t1
        ob_launches = (r1.radius_count.launches, r2.dbscan_labels.launches)
        ob_segmented = r2.dbscan_labels_batched.launches  # a part of ob_launches[1]
        ob_stages = dict(timer.totals)
        print(f"factory builder ({card}): create_ppscore {stages['create_ppscore']:.2f} s, "
              f"create_outline_boxes {stages['create_outline_boxes']:.2f} s", flush=True)
        r2_calls.summary(card)
        r2_numbers = factory_r2_check(r2_calls.cloud, dev, card)
        segmented = (factory_r2_segmented_check(r2_calls.batch, card)
                     if r2_calls.batch is not None else None)
        if pp_launches[0] != FACTORY_FRAMES or pp_launches[1] or ob_launches[0] \
                or not 0 < ob_launches[1] <= R2_CALLS_A_FRAME * FACTORY_FRAMES \
                or not 0 < ob_segmented < ob_launches[1] or segmented is None:
            raise AssertionError(f"factory: (R1, R2) launches {pp_launches} in create_ppscore "
                                 f"(want ({FACTORY_FRAMES}, 0)), {ob_launches} in "
                                 f"create_outline_boxes (want (0, 1 to "
                                 f"{R2_CALLS_A_FRAME * FACTORY_FRAMES})); segmented R2 "
                                 f"launches {ob_segmented} (want 1 to {ob_launches[1] - 1})")

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
              f"R2): create_ppscore {pp_launches}, create_outline_boxes {ob_launches}, "
              f"{ob_segmented} of its R2 launches segmented; "
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
                      "host; no pl.pallas_call)", ob_launches[1] - ob_segmented, *r2_numbers,
                      F64_CORE_FLOPS),
        factory_entry("dbscan", "factory: create_outline_boxes, C-PROTO's box clouds of a "
                      "frame in one segmented launch", "cpd_tpu_torch/csrc/dbscan.cu",
                      "cpd_tpu/unsupervised/outline.py:32 (dbscan_cluster, sklearn on the "
                      "host; no pl.pallas_call)", ob_segmented,
                      *segmented, F64_CORE_FLOPS),
    ]


def timed_native_build():
    """Build the native host library (``native.build``): (path, seconds)."""
    t0 = time.perf_counter()
    path = native.build()
    return path, time.perf_counter() - t0


def host_ms_in_turns(fns, reps):
    """Median host milliseconds of each function, run in turns (a b, b a, ...)
    after a warm-up of each."""
    for fn in fns:
        fn()
    times = [[] for _ in fns]
    for r in range(reps):
        for i in (range(len(fns)) if r % 2 == 0 else reversed(range(len(fns)))):
            t0 = time.perf_counter()
            fns[i]()
            times[i].append((time.perf_counter() - t0) * 1e3)
    return [statistics.median(t) for t in times], times


def native_check(card):
    """Phase 16 (a): the native host library. ``points_in_boxes_mask`` on the
    bench frame (200k points) and 64 drawn boxes, native against its NumPy
    plain version (masks equal; host times in turns), then phase 9's training
    loader alone on the same written sequence with the data layer's mask on
    each route (``waymo_unsupervised.points_in_boxes_mask_fast`` is the
    native one; the NumPy one swapped in for the comparison)."""
    pts, _ = make_lidar_frame(np.random.default_rng(0), N_POINTS)
    boxes, _ = class_boxes(np.random.default_rng(1), NATIVE_BOXES, 70.0)
    mask = native.points_in_boxes_mask(pts[:, :3], boxes)
    plain = native.points_in_boxes_mask_np(pts[:, :3], boxes)
    if not np.array_equal(mask, plain):
        raise AssertionError(f"native points_in_boxes_mask differs from NumPy at "
                             f"{int((mask != plain).sum())} of {mask.size} entries")
    (native_ms, plain_ms), runs = host_ms_in_turns(
        [lambda: native.points_in_boxes_mask(pts[:, :3], boxes),
         lambda: native.points_in_boxes_mask_np(pts[:, :3], boxes)], NATIVE_REPS)
    print(f"native points_in_boxes_mask ({card}): bench frame {N_POINTS} points x "
          f"{NATIVE_BOXES} boxes ({int(mask.any(0).sum())} points in a box), masks equal; "
          f"native {native_ms:.2f} ms, NumPy {plain_ms:.2f} ms (host clock, median of "
          f"{NATIVE_REPS} in turns: native {', '.join(f'{t:.2f}' for t in runs[0])}; NumPy "
          f"{', '.join(f'{t:.2f}' for t in runs[1])})", flush=True)

    seed = train_cli.parse_args(["--cfg_file", EVAL_YAML]).seed
    with tempfile.TemporaryDirectory() as tmp:
        write_eval_sequence(tmp, protos=True)
        sets = ["DATA_CONFIG.DATA_PATH", str(tmp), "DATA_CONFIG.SAMPLED_INTERVAL.train", "1"]
        cfg = cfg_from_list(sets, cfg_from_yaml_file(EVAL_YAML, ConfigDict()))
        batch_size = int(cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU)
        fast = builder.points_in_boxes_mask_fast
        got = {}

        def load(route):
            builder.points_in_boxes_mask_fast = (fast if route == "native"
                                                 else native.points_in_boxes_mask_np)
            try:
                dataset = build_dataset(cfg.DATA_CONFIG, cfg.CLASS_NAMES, True, str(tmp))
                _, loader, _ = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, batch_size,
                                                training=True, seed=seed, dataset=dataset)
                got[route] = list(loader)
            finally:
                builder.points_in_boxes_mask_fast = fast
            return loader.num_threads
        threads = load("native")
        (native_ms, plain_ms), runs = host_ms_in_turns(
            [lambda: load("native"), lambda: load("numpy")], 3)
    same = all(np.array_equal(a[k], b[k]) for a, b in zip(got["native"], got["numpy"])
               for k in a if isinstance(a[k], np.ndarray))
    print(f"native training loader ({card}): phase 9's loader alone on its sequence "
          f"({EVAL_FRAMES} frames of {N_POINTS} points with prototypes, batch {batch_size}, "
          f"{threads} threads): native mask {native_ms / EVAL_FRAMES:.1f} ms a frame, NumPy "
          f"mask {plain_ms / EVAL_FRAMES:.1f} ms a frame (median of 3 in turns: native "
          f"{', '.join(f'{t / EVAL_FRAMES:.1f}' for t in runs[0])}; NumPy "
          f"{', '.join(f'{t / EVAL_FRAMES:.1f}' for t in runs[1])}); batches bit-equal "
          f"between the routes: {same}; phase 9 (native) read the loader alone at "
          f"{PHASE9.get('loader_ms', float('nan')):.1f} ms a frame and the data layer's host "
          f"share at {PHASE9.get('share', float('nan')):.1%}", flush=True)


def kitti_eval_cli(dev, card, tmp, sets, cfg):
    """Phase 16 (b): the evaluation CLI on the KITTI yaml. Returns A1's
    kernels-line entry."""
    t0 = time.perf_counter()
    batch_size = int(cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU)
    n_batches = math.ceil(KITTI_FRAMES / batch_size)
    model = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), cfg.DATA_CONFIG)
    model.load_state_dict(seeded_state_dict(model, 0), strict=True)
    ckpt = save_checkpoint(tmp / "ckpt", model, 0)
    fresh = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), cfg.DATA_CONFIG)
    load_checkpoint(ckpt, fresh)
    sd, back = model.state_dict(), fresh.state_dict()
    if set(sd) != set(back) or not all(torch.equal(sd[k], back[k]) for k in sd):
        raise AssertionError("KITTI eval CLI: the checkpoint round trip changed the state dict")
    widths = {b: tuple(back[f"backbone.{b}.conv_input.weight"].shape)
              for b in ("branch0", "branch1")}
    if set(widths.values()) != {(27, 4, 16)}:
        raise AssertionError(f"KITTI model: conv_input {widths}, want (27, 4, 16) in both")

    dataset = build_dataset(cfg.DATA_CONFIG, cfg.CLASS_NAMES, False, str(tmp))
    _, loader, _ = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, batch_size,
                                    training=False, dataset=dataset)
    t1 = time.perf_counter()
    host_batches = list(loader)
    loader_s = time.perf_counter() - t1
    batches = [device_batch(b, dev) for b in host_batches]
    in_fov = [int(b["points_valid"].sum()) for b in host_batches]
    model = place(fresh.eval(), dev)
    cap_audit(model, batches[0])
    convs = recorded_forward(model, batches[0])
    if not any(table.shape[-1] == 4 for _, table, _, _, _ in convs):
        raise AssertionError("KITTI eval: no conv of the forward reads the 4-channel input")
    max_err, shape_times = check_kernel("A1 KITTI eval CLI", convs, a1_kernel, a1_plain,
                                        torch.bfloat16)
    del convs

    logger = logging.getLogger("cpd_tpu_torch")
    lines = LogLines()
    logger.addHandler(lines)
    out_dir = tmp / "eval"
    try:
        torch.cuda.synchronize()
        a1.gather_gemm.launches = 0
        result = eval_cli.main(["--cfg_file", KITTI_YAML, "--ckpt", str(ckpt), "--output_dir",
                                str(out_dir), "--set", *sets])
        torch.cuda.synchronize()
        launches = a1.gather_gemm.launches
    finally:
        logger.removeHandler(lines)
    want = A1_PER_FORWARD[False] * n_batches
    if launches != want:
        raise AssertionError(f"KITTI eval CLI: A1 launched {launches} times, want {want}")
    with open(out_dir / "result.pkl", "rb") as f:
        det_annos = pickle.load(f)
    if [a["frame_id"] for a in det_annos] != dataset.sample_ids:
        raise AssertionError(f"KITTI eval CLI: records for {[a['frame_id'] for a in det_annos]}")
    for a in det_annos:
        n = len(a["score"])
        for key, shape in (("boxes_lidar", (n, 7)), ("score", (n,)), ("location", (n, 3)),
                           ("dimensions", (n, 3)), ("rotation_y", (n,)), ("alpha", (n,)),
                           ("bbox", (n, 4))):
            if key not in a or a[key].shape != shape or not np.isfinite(a[key]).all():
                raise AssertionError(f"KITTI eval CLI: {a['frame_id']}'s {key} is missing, "
                                     f"misshapen or not finite")
    keys = {f"{c}_{m}/{lv}_{r}" for c in cfg.CLASS_NAMES for m in ("3d", "bev", "bbox", "aos")
            for lv in ("easy", "moderate", "hard") for r in ("R40", "R11")}
    if not keys <= set(result) or result.get("gt_count", 0) == 0:
        raise AssertionError(f"KITTI eval CLI: result lacks {sorted(keys - set(result))[:6]} "
                             f"or counted no gt box")
    fps_line = next((ln for ln in lines.lines if ln.startswith("eval: ")), "")
    m = re.match(r"eval: (\d+) frames in ([\d.]+)s \(([\d.]+) f/s\)", fps_line)
    if not m or int(m.group(1)) != KITTI_FRAMES:
        raise AssertionError(f"KITTI eval CLI: no frames/s line for {KITTI_FRAMES} frames")
    cli_fps = float(m.group(3))
    model.predict(batches[0])
    runs = []
    for _ in range(3):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for b in batches:
            model.predict(b)
        torch.cuda.synchronize()
        runs.append(KITTI_FRAMES / (time.perf_counter() - t1))
    predict_fps = statistics.median(runs)
    print(f"KITTI eval CLI ({card}): {KITTI_FRAMES} frames of {KITTI_POINTS} points "
          f"({min(in_fov)}-{max(in_fov)} points a batch in the camera's view), batch "
          f"{batch_size}, {launches} A1 launches, {sum(len(a['score']) for a in det_annos)} "
          f"detections with camera fields; CLI {cli_fps:.2f} frames/s (its own log line: "
          f"{fps_line!r}), predict alone on the same batches {predict_fps:.3f} frames/s (median "
          f"of 3: {', '.join(f'{r:.3f}' for r in runs)}); the loader alone "
          f"{loader_s / KITTI_FRAMES * 1e3:.1f} ms a frame", flush=True)
    print("KITTI eval CLI result (moderate): " + ", ".join(
        f"{k}={result[k]:.4f}" for k in sorted(result) if "moderate" in k or k == "gt_count"))
    print(f"KITTI eval CLI phase: {time.perf_counter() - t0:.1f} s ({card})", flush=True)
    return kernel_entry("gather_gemm", "KITTI eval CLI, batch 2",
                        "cpd_tpu_torch/csrc/gather_gemm.cu", "cpd_tpu/ops/pallas_conv.py:77",
                        launches, max_err, shape_times)


def kitti_train_cli(dev, card, tmp, sets, cfg):
    """Phase 16 (c): the training CLI on the KITTI yaml, ``--epochs 1
    --debug_steps 2``, MM on. Returns the entries of A1, A1 as dX and A2."""
    t0 = time.perf_counter()
    seed = train_cli.parse_args(["--cfg_file", KITTI_YAML]).seed
    batch_size = int(cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU)
    dataset = build_dataset(cfg.DATA_CONFIG, cfg.CLASS_NAMES, True, str(tmp))
    _, loader, _ = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, batch_size,
                                    training=True, seed=seed, dataset=dataset)
    host_batches = list(loader)[:2]  # the two steps' batches, in the CLI's order
    labels = np.concatenate([b["gt_boxes"][b["gt_valid"]][:, 7] for b in host_batches])
    cars = int((labels == 1).sum())
    if cars == 0:
        raise AssertionError(f"KITTI train: no box labelled Car in the batches ({labels})")
    b0 = device_batch(host_batches[0], dev)
    model = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), cfg.DATA_CONFIG)
    model.load_state_dict(seeded_state_dict(model, seed), strict=True)
    place(model, dev)
    cap_audit(model, b0)
    cap_audit(model, {"points": b0["points1"], "points_valid": b0["points1_valid"]})
    checks = train_kernel_checks(model, b0, step_generator(seed, 0, dev))
    if not any(e["cin"] == 4 for e in checks["forward"][1]):
        raise AssertionError("KITTI train: no forward conv read the 4-channel input")
    del model
    torch.cuda.empty_cache()

    logger = logging.getLogger("cpd_tpu_torch")
    lines = LogLines()
    logger.addHandler(lines)
    try:
        with CLISteps() as steps:
            steps.run = "kitti"
            torch.cuda.synchronize()
            a1.gather_gemm.launches = a1.gather_gemm_dw.launches = 0
            t1 = time.perf_counter()
            state = train_cli.main(["--cfg_file", KITTI_YAML, "--output_dir", str(tmp / "out"),
                                    "--epochs", "1", "--debug_steps", "2", "--log_every", "1",
                                    "--set", *sets])
            torch.cuda.synchronize()
            secs = time.perf_counter() - t1
            totals = a1.gather_gemm.launches, a1.gather_gemm_dw.launches
    finally:
        logger.removeHandler(lines)
    want = (TRAIN_A1_FORWARD, TRAIN_A1_DX, TRAIN_A2, 0)
    if state.step != 2 or [r["launches"] for r in steps.rows] != [want, want]:
        raise AssertionError(f"KITTI train CLI: {state.step} steps, launches "
                             f"{[r['launches'] for r in steps.rows]}, want 2 x {want}")
    if totals != (2 * (TRAIN_A1_FORWARD + TRAIN_A1_DX), 2 * TRAIN_A2):
        raise AssertionError(f"KITTI train CLI: the counters read {totals}")
    for r in steps.rows:
        bad = [k for k, v in r["tb"].items() if not math.isfinite(v)]
        if bad or "proto_loss" not in r["tb"] or r["tb"]["skipped_nonfinite"]:
            raise AssertionError(f"KITTI train CLI step: non-finite {bad}, tb keys "
                                 f"{sorted(r['tb'])}")
    n_steps, rate, means = _phase_means(lines.lines)[-1]
    print(f"KITTI train CLI ({card}): batch {batch_size}, {cars} Car labels among "
          f"{len(labels)} in the two steps' batches, {n_steps} steps at {rate} steps/s; the "
          f"CLI's phase means " + ", ".join(f"{k} {v * 1e3:.1f} ms" for k, v in means.items())
          + "; each step " + ", ".join(f"{r['ms']:.1f}" for r in steps.rows)
          + f" ms; per step A1 {want[0]} forward + {want[1]} dX, A2 {want[2]}; the CLI call "
          f"{secs:.1f} s; last tb: "
          + ", ".join(f"{k} {v:.4f}" for k, v in steps.rows[-1]["tb"].items()), flush=True)
    print(f"KITTI train CLI phase: {time.perf_counter() - t0:.1f} s ({card})", flush=True)
    src1, src2 = "cpd_tpu_torch/csrc/gather_gemm.cu", "cpd_tpu_torch/csrc/gather_gemm_dw.cu"
    fwd, dx, a2 = (sum(r["launches"][i] for r in steps.rows) for i in range(3))
    return [
        kernel_entry("gather_gemm", "KITTI train CLI, batch 2", src1,
                     "cpd_tpu/ops/pallas_conv.py:77", fwd, *checks["forward"]),
        kernel_entry("gather_gemm (dX)", "KITTI train CLI, batch 2", src1,
                     "cpd_tpu/ops/pallas_conv.py:77", dx, *checks["dx"]),
        kernel_entry("gather_gemm_dw", "KITTI train CLI, batch 2", src2,
                     "cpd_tpu/ops/pallas_conv.py:130", a2, *checks["dw"]),
    ]


def kitti_phase(dev, card):
    """Phase 16: (a) the native host library, (b) the evaluation CLI and (c)
    the training CLI on the shipped KITTI yaml at full width, on 8 frames
    written by ``write_kitti_frames`` in KITTI's layout. Returns the
    kernels-line entries of A1 and A2 on the KITTI paths."""
    t0 = time.perf_counter()
    native_check(card)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        write_kitti_frames(tmp, KITTI_FRAMES, seed=0, n_points=KITTI_POINTS)
        sets = ["DATA_CONFIG.DATA_PATH", str(tmp)]
        cfg = cfg_from_list(sets, cfg_from_yaml_file(KITTI_YAML, ConfigDict()))
        if (list(cfg.CLASS_NAMES), cfg.MODEL.BACKBONE_3D.MM,
                cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU) != (["Car", "Pedestrian", "Cyclist"], True, 2):
            raise AssertionError("the KITTI yaml's classes, MM or batch moved")
        entries = [kitti_eval_cli(dev, card, tmp, sets, cfg)]
        torch.cuda.empty_cache()
        entries += kitti_train_cli(dev, card, tmp, sets, cfg)
    print(f"KITTI phase: {time.perf_counter() - t0:.1f} s ({card})", flush=True)
    return entries


REPO = Path(__file__).resolve().parent
DP_RANKS = 2  # phase 17 (b): ranks sharing the one card


def torchrun(nproc, target, args, what, timeout=600):
    """``python -m torch.distributed.run --standalone --nproc_per_node nproc
    target args`` from the repository's root, as a user launches the port on
    several ranks (``target``: ``["-m", module]`` or a script and its first
    arguments); -> (seconds, its output's lines). Raises with the end of the
    output where it fails; at the time limit its whole process group is
    killed."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           str(nproc), *target, *args]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        raise AssertionError(f"{what}: still running after {timeout} s; its output ends:\n"
                             + out[-6000:])
    if proc.returncode != 0:
        raise AssertionError(f"{what}: exit code {proc.returncode}; its output ends:\n"
                             + out[-6000:])
    return time.perf_counter() - t0, out.splitlines()


def rank_records(lines):
    """{rank: {"steps": [(it, record)], "epochs": [record], "state": record,
    "placement": text}} from the training CLI's per-rank lines."""
    out = {}
    for ln in lines:
        m = re.search(r"  rank (\d+)/\d+  (step (\d+) |epoch \d+ |state |device )(.*)$", ln)
        if not m:
            continue
        rec = out.setdefault(int(m.group(1)), {"steps": [], "epochs": []})
        kind, body = m.group(2), m.group(4)
        if kind.startswith("step"):
            rec["steps"].append((int(m.group(3)), json.loads(body)))
        elif kind.startswith("epoch"):
            rec["epochs"].append(json.loads(body))
        elif kind == "state ":
            rec["state"] = json.loads(body)
        else:
            rec["placement"] = "device " + body
    return out


def _read_result(path, n_frames):
    """A result.pkl with one finite record a frame, in dataset order."""
    with open(path, "rb") as f:
        annos = pickle.load(f)
    want = [f"{EVAL_SEQ}#{i:04d}" for i in range(n_frames)]
    if [a["frame_id"] for a in annos] != want or not all(
            np.isfinite(a["boxes_lidar"]).all() and np.isfinite(a["score"]).all() for a in annos):
        raise AssertionError(f"{path}: frames {[a['frame_id'] for a in annos]}, want {want} "
                             f"with finite detections")
    return annos


def results_within_eval_tier(got, want, what):
    """The whole-predict tier of tests/test_torch_port_cli_eval.py: per
    frame the same number of detections, paired by box with the same names;
    every pair within 0.1 m and 0.01 in score, 95% within 1e-4 of the scale.
    -> (pairs, tight, bit-equal)."""
    box_scale = max([np.abs(a["boxes_lidar"]).max() for a in want if len(a["score"])] + [1e-3])
    score_scale = max([np.abs(a["score"]).max() for a in want if len(a["score"])] + [1e-3])
    n = tight = same = 0
    for a, b in zip(got, want):
        if len(a["score"]) != len(b["score"]):
            raise AssertionError(f"{what} {a['frame_id']}: {len(a['score'])} detections, want "
                                 f"{len(b['score'])}")
        if not len(a["score"]):
            continue
        d = np.abs(a["boxes_lidar"][:, None, :6] - b["boxes_lidar"][None, :, :6]).max(-1)
        pair = d.argmin(1)
        if len(set(pair.tolist())) != len(pair) or not np.array_equal(a["name"], b["name"][pair]):
            raise AssertionError(f"{what} {a['frame_id']}: detections do not pair one to one")
        box_err = np.abs(a["boxes_lidar"] - b["boxes_lidar"][pair]).max(-1)
        score_err = np.abs(a["score"] - b["score"][pair])
        if box_err.max() > 0.1 or score_err.max() > 0.01:
            worst = int(box_err.argmax())
            raise AssertionError(
                f"{what} {a['frame_id']}: box err {box_err.max()}, score err {score_err.max()} "
                f"over {len(pair)} detections ({int((box_err == 0).sum())} boxes equal); the "
                f"worst pair {a['boxes_lidar'][worst].tolist()} against "
                f"{b['boxes_lidar'][pair[worst]].tolist()}")
        tight += int(((box_err <= 1e-4 * box_scale) & (score_err <= 1e-4 * score_scale)).sum())
        same += int(((box_err == 0) & (score_err == 0)).sum())
        n += len(pair)
    if tight < 0.95 * n:
        raise AssertionError(f"{what}: {tight} of {n} detections within 1e-4 of the scale")
    return n, tight, same


DP_RANK_CHECKS = "--data-parallel-rank-checks"


def dp_rank_checks(out_dir, argv):
    """Phase 17's ranks of run (b1), each started by ``torchrun`` as
    ``chip_smoke.py --data-parallel-rank-checks DIR <train CLI arguments>``:
    this rank joins the process group, runs the training CLI's ``main`` on
    ``argv`` in it with copies of the A1 forward, A1 as dX and A2 operands
    of its first step kept as the kernels got them (the global batch norms'
    moments included), then, once the CLI has returned, holds each kept
    launch against its plain version, one rank at a time from the last
    while the others wait (rank 0 last and timed, the card to itself).
    Writes {use: [max err, shapes]} to DIR/rank_R.json."""
    from cpd_tpu_torch.parallel import comm
    rank, world, _ = comm.init_distributed()
    rec = KernelRecorder(copy=True)
    make, loss_step = parallel.make_train_step, VoxelRCNN.loss_step

    def recorded_make_train_step():
        step = make()
        state = {"first": True}

        def recorded_step(*args, **kwargs):
            with rec if state["first"] else contextlib.nullcontext():
                out = step(*args, **kwargs)
            state["first"] = False
            recorded_step.trace = step.trace  # the CLI logs it
            return out
        return recorded_step

    def marked_loss_step(model, *args, **kwargs):
        out = loss_step(model, *args, **kwargs)
        rec.in_backward = True  # what the recorder sees next is the backward
        return out

    parallel.make_train_step, VoxelRCNN.loss_step = recorded_make_train_step, marked_loss_step
    try:
        train_cli.main(argv)
    finally:
        parallel.make_train_step, VoxelRCNN.loss_step = make, loss_step
    torch.cuda.synchronize()
    for turn in reversed(range(world)):
        if turn == rank:
            print(f"data parallel rank {rank}/{world}: the first step's kernel launches against "
                  f"their plain versions", flush=True)
            checks = recorded_train_checks(rec, timed=rank == 0)
            with open(Path(out_dir) / f"rank_{rank}.json", "w") as f:
                json.dump(checks, f, default=float)
            rec.calls = {k: [] for k in rec.calls}
            torch.cuda.empty_cache()
        comm.synchronize()
    comm.shutdown()


def data_parallel_phase(dev, card):
    """Phase 17: the training and evaluation CLIs on ranks that ``torchrun``
    launches, on phase 9's yaml at full width and 8 written frames with
    prototype banks, global batch 4. (a) NCCL at world size 1 (the route of a
    host with a card a rank): ``--epochs 1`` (2 steps), then the eval CLI on
    weights drawn from a seed. (b) 2 ranks sharing the card over gloo, 2
    samples a rank: 2 steps stopped (``--debug_steps 2``), 2 more
    auto-resumed with ``--eval_after 1``, 4 unbroken; then the eval CLI on
    the seeded weights on 2 ranks. (b)'s first run starts its ranks through
    ``dp_rank_checks``, which keeps the A1 forward, A1 as dX and A2 operands
    of each rank's first step (global batch-norm moments) and holds them
    against their plain versions once the CLI returns (rank 0 timed).
    Gates: every step of every rank launches A1 35 + 33 and A2 35 (read
    from the ranks' log lines); the ranks' final weights agree (their
    checksums); (b)'s resumed checkpoint_epoch_1 equals the unbroken one bit
    for bit; (b)'s first total loss within a relative 0.5 of phase 9's one
    process on the same 4 samples and weights; finite losses, no step
    skipped; the merged result.pkl of (b)'s eval holds the 8 frames in
    dataset order and equals (a)'s (2 frames a forward on either side)
    within the whole-predict tier of tests/test_torch_port_cli_eval.py.
    Returns the kernels-line entries of (b)'s A1, dX and A2 (rank 0)."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        write_eval_sequence(tmp, protos=True)
        sets = ["DATA_CONFIG.DATA_PATH", str(tmp), "DATA_CONFIG.SAMPLED_INTERVAL.train", "1",
                "DATA_CONFIG.SAMPLED_INTERVAL.test", "1"]
        cfg = cfg_from_list(sets, cfg_from_yaml_file(EVAL_YAML, ConfigDict()))
        batch_size = int(cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU)

        checks_dir = tmp / "rank_checks"
        checks_dir.mkdir()
        train, test = ["-m", "cpd_tpu_torch.tools.train"], ["-m", "cpd_tpu_torch.tools.test"]
        train_checked = [str(REPO / "chip_smoke.py"), DP_RANK_CHECKS, str(checks_dir)]
        common = ["--cfg_file", EVAL_YAML, "--batch_size", str(batch_size), "--log_every", "1"]
        # the evaluations read weights drawn from a seed (no --ckpt): after a
        # few steps on drawn labels the model detects nothing to compare. (a)'s
        # forwards take 2 frames, as each of (b)'s ranks does: cuBLAS and
        # cuDNN choose their kernels by the batch, and the RoI head turns
        # their rounding into other boxes
        calls = [
            ("a", 1, train, common + ["--output_dir", str(tmp / "P"), "--epochs", "1"]),
            ("ae", 1, test, ["--cfg_file", EVAL_YAML, "--batch_size",
                             str(batch_size // DP_RANKS), "--output_dir", str(tmp / "Pe")]),
            ("b1", DP_RANKS, train_checked, common + ["--output_dir", str(tmp / "Q"), "--epochs",
                                                      "2", "--debug_steps", "2",
                                                      "--fix_random_seed"]),
            ("b2", DP_RANKS, train, common + ["--output_dir", str(tmp / "Q"), "--epochs", "2",
                                              "--eval_after", "1"]),
            ("b3", DP_RANKS, train, common + ["--output_dir", str(tmp / "R"), "--epochs", "2"]),
            ("be", DP_RANKS, test, ["--cfg_file", EVAL_YAML, "--batch_size", str(batch_size),
                                    "--output_dir", str(tmp / "Qe")]),
        ]
        secs, recs = {}, {}
        for run, nproc, target, args in calls:
            secs[run], lines = torchrun(nproc, target, args + ["--set", *sets],
                                        f"data parallel ({run})")
            recs[run] = rank_records(lines)
            if run == "a":
                print(f"data parallel ({card}) run (a) log: " + " | ".join(
                    ln for ln in lines if re.search(r"(  rank 0/1  device|INFO  device:)", ln)),
                    flush=True)

        # gates
        want_steps = {"a": [1, 2], "b1": [1, 2], "b2": [3, 4], "b3": [1, 2, 3, 4]}
        launch = {"forward": {"A1": TRAIN_A1_FORWARD, "A2": 0},
                  "backward": {"A1": TRAIN_A1_DX, "A2": TRAIN_A2}}
        for run, steps in want_steps.items():
            ranks = recs[run]
            if sorted(ranks) != list(range(1 if run == "a" else DP_RANKS)):
                raise AssertionError(f"data parallel ({run}): rank lines of ranks {sorted(ranks)}")
            for r, rec in ranks.items():
                if [it for it, _ in rec["steps"]] != steps:
                    raise AssertionError(f"data parallel ({run}) rank {r}: steps "
                                         f"{[it for it, _ in rec['steps']]}, want {steps}")
                bad = [(it, x["forward"], x["backward"]) for it, x in rec["steps"]
                       if (x["forward"], x["backward"]) != (launch["forward"],
                                                            launch["backward"])]
                if bad:
                    raise AssertionError(f"data parallel ({run}) rank {r}: launches (step, "
                                         f"forward, backward) {bad}, want {launch} every step")
            sums = {rec["state"]["checksum"] for rec in ranks.values()}
            if len(sums) != 1:
                raise AssertionError(f"data parallel ({run}): the ranks' weights differ: {sums}")
        if "backend nccl" not in recs["a"][0]["placement"] or any(
                "backend gloo" not in recs["b1"][r]["placement"] for r in range(DP_RANKS)):
            raise AssertionError(f"data parallel: placements {recs['a'][0]['placement']!r}, "
                                 f"{[recs['b1'][r]['placement'] for r in range(DP_RANKS)]!r}")
        diff = _ckpt_difference(tmp / "Q" / "ckpt" / "checkpoint_epoch_1.pth",
                                tmp / "R" / "ckpt" / "checkpoint_epoch_1.pth")
        if diff is not None:
            raise AssertionError(f"data parallel (b): the resumed run's checkpoint_epoch_1 "
                                 f"differs from the unbroken run's, first at {diff}")
        metrics = {}
        for out in ("P", "Q", "R"):
            with open(tmp / out / "metrics.jsonl") as f:
                metrics[out] = [json.loads(ln) for ln in f]
            for m in metrics[out]:
                if not all(math.isfinite(v) for v in m.values()) or m["skipped_nonfinite"]:
                    raise AssertionError(f"data parallel {out}: step {m['step']} {m}")
        first = {out: metrics[out][0]["total_loss"] for out in ("P", "Q")}
        rel = {out: abs(v - PHASE9["first_loss"]) / max(abs(v), abs(PHASE9["first_loss"]))
               for out, v in first.items()}
        if rel["Q"] >= 0.5:
            raise AssertionError(f"data parallel (b): first total loss {first['Q']} against "
                                 f"phase 9's {PHASE9['first_loss']}")
        annos_a = _read_result(tmp / "Pe" / "result.pkl", EVAL_FRAMES)
        annos_b = _read_result(tmp / "Qe" / "result.pkl", EVAL_FRAMES)
        _read_result(tmp / "Q" / "eval_epoch_1" / "result.pkl", EVAL_FRAMES)
        checks = []
        for r in range(DP_RANKS):
            with open(checks_dir / f"rank_{r}.json") as f:
                checks.append(json.load(f))

    # what was measured
    def per_step(rec, kind, key):
        return statistics.mean(x["collectives"][kind][key] for _, x in rec["steps"])

    print(f"data parallel ({card}): (a) NCCL at world size 1, {recs['a'][0]['placement']}; "
          f"(b) {DP_RANKS} ranks on the one card over gloo, "
          f"{recs['b1'][0]['placement']}. Gloo stages a CUDA tensor's collective through the "
          f"host: these are times of the gloo route on one shared card, not of NCCL across "
          f"cards", flush=True)
    print(f"data parallel ({card}): seconds a call (process start, build, data, steps, eval): "
          + ", ".join(f"({k}) {v:.1f}" for k, v in secs.items()), flush=True)
    p9 = PHASE9["means"]
    print(f"data parallel ({card}): phase 9, one process at batch 4: {PHASE9['steps_per_s']:.3f} "
          f"steps/s, " + ", ".join(f"{k} {v * 1e3:.1f} ms" for k, v in p9.items())
          + "; run (c)'s steps " + ", ".join(f"{ms:.1f}" for ms in PHASE9["step_ms"]) + " ms",
          flush=True)
    for run in ("a", "b1", "b2", "b3"):
        for r, rec in sorted(recs[run].items()):
            ep = rec["epochs"][-1]
            peak = ep["peak_memory_bytes"]
            print(f"data parallel ({card}) ({run}) rank {r}: {ep['steps_per_s']:.3f} steps/s, "
                  + ", ".join(f"{k} {v * 1e3:.1f} ms" for k, v in ep["means"].items())
                  + "; each step's ms " + ", ".join(f"{x['step_ms']:.1f}" for _, x in rec["steps"])
                  + f"; peak memory {peak / 2**30:.2f} GiB; a step: gradient bucket "
                  f"{per_step(rec, 'grad', 'bytes') / 1e6:.2f} MB all-reduced in "
                  f"{per_step(rec, 'grad', 'ms'):.2f} ms, {per_step(rec, 'norm', 'calls'):.0f} "
                  f"norm collectives in {per_step(rec, 'norm', 'ms'):.2f} ms, "
                  f"{per_step(rec, 'loss', 'calls'):.0f} loss counts in "
                  f"{per_step(rec, 'loss', 'ms'):.2f} ms (CUDA events; a collective's time "
                  f"includes its wait for the other rank)", flush=True)
    print(f"data parallel ({card}): first total loss (b) {first['Q']:.6f}, (a) {first['P']:.6f}, "
          f"phase 9's one process {PHASE9['first_loss']:.6f}: relative difference (b) "
          f"{rel['Q']:.3e}, (a) {rel['P']:.3e}; ranks bit-equal after every run; (b) resume "
          f"bit-equal", flush=True)
    n_pairs, n_tight, n_same = results_within_eval_tier(annos_b, annos_a, "data parallel eval")
    print(f"data parallel ({card}): the eval CLI on seeded weights, 2 frames a forward, "
          f"(b)'s {DP_RANKS} ranks merged against (a)'s one: {EVAL_FRAMES} frames in order, "
          f"{n_pairs} detections paired, {n_tight} within 1e-4 of the scale, {n_same} bit-equal",
          flush=True)
    print(f"data parallel ({card}): each rank's first step of (b) held against the plain "
          f"versions, largest bf16 error (A1 forward, A1 as dX, A2): " + "; ".join(
              f"rank {r} " + ", ".join(f"{c[use][0]:.3e}" for use in ("forward", "dx", "dw"))
              for r, c in enumerate(checks)), flush=True)
    print(f"data parallel phase: {time.perf_counter() - t0:.1f} s ({card})", flush=True)
    rank0 = [x for run in ("b1", "b2", "b3") for _, x in recs[run][0]["steps"]]
    fwd, dx, a2 = (sum(x[part][k] for x in rank0) for part, k in
                   (("forward", "A1"), ("backward", "A1"), ("backward", "A2")))
    src1, src2 = "cpd_tpu_torch/csrc/gather_gemm.cu", "cpd_tpu_torch/csrc/gather_gemm_dw.cu"
    path = f"data parallel (b), rank 0 of {DP_RANKS}, 2 samples a rank"
    return [
        kernel_entry("gather_gemm", path, src1, "cpd_tpu/ops/pallas_conv.py:77", fwd,
                     *checks[0]["forward"]),
        kernel_entry("gather_gemm (dX)", path, src1, "cpd_tpu/ops/pallas_conv.py:77", dx,
                     *checks[0]["dx"]),
        kernel_entry("gather_gemm_dw", path, src2, "cpd_tpu/ops/pallas_conv.py:130", a2,
                     *checks[0]["dw"]),
    ]


# phase 18, the rest of the registry at full width on phase 9's yaml and frames
REGISTRY_SETS = ["MODEL.BACKBONE_3D.NAME", "VoxelBackBone8x", "MODEL.PFE.NAME",
                 "VoxelSetAbstraction", "MODEL.WRAP_HEAD.NAME", "PartWraper",
                 "MODEL.TEMPORAL_MODEL.NAME", "ConvGRU"]
# at the yaml's decay of 1e-5 two AdamW steps move a weight by 6e-9 of itself,
# below f32's resolution: the (a) training run decays by 1e-2, so that the
# gate on the PFE's weights (no gradient reaches them) sees the decay
REGISTRY_TRAIN_SETS = ["OPTIMIZATION.WEIGHT_DECAY", "0.01"]
CENTERPOINT_SETS = ["MODEL.NAME", "CenterPoint"]
# VoxelBackBone8x has 12 sparse convs a branch (conv_input, conv1, then a
# strided conv and two submanifold convs at stages 2-4, conv_out). A training
# step with MM runs both full branches: 24 forward; no loss reads branch 1's
# conv_out, so it takes no dW and no dX: 23 dW, and a dX for each of the 23
# but the two conv_input's: 21
PLAIN_A1_PER_FORWARD = 12
PLAIN_A1_FORWARD, PLAIN_A1_DX, PLAIN_A2 = 24, 21, 23
FPS_KEYPOINTS = 2048  # VoxelSetAbstraction's default
F1_OPS_PER_UPDATE = 9  # 3 subtractions, 1 product, 2 fused multiply-adds, sqrt, min, compare


def registry_cli_pair(dev, card, tmp, name, extra_sets, train_extra, want_step):
    """The evaluation CLI at batch 4 on a seeded checkpoint, then the
    training CLI for 2 steps (``--epochs 1``), on phase 9's yaml with
    ``extra_sets``. Gates: one finite record a frame in result.pkl; 2 steps,
    each with ``want_step`` launches (A1 forward, A1 dX, A2, A2 in the
    forward), finite losses and no step skipped. Returns what the phase
    prints and gates on."""
    sets = ["DATA_CONFIG.DATA_PATH", str(tmp), "DATA_CONFIG.SAMPLED_INTERVAL.train", "1",
            "DATA_CONFIG.SAMPLED_INTERVAL.test", "1", *extra_sets]
    cfg = cfg_from_list(sets, cfg_from_yaml_file(EVAL_YAML, ConfigDict()))
    model = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), cfg.DATA_CONFIG)
    model.load_state_dict(seeded_state_dict(model, 0), strict=True)
    ckpt = save_checkpoint(tmp / f"ckpt_{name}", model, 0)
    logger = logging.getLogger("cpd_tpu_torch")
    lines = LogLines()
    logger.addHandler(lines)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        a1.gather_gemm.launches = f1.farthest_point_sample.launches = 0
        eval_cli.main(["--cfg_file", EVAL_YAML, "--ckpt", str(ckpt), "--output_dir",
                       str(tmp / f"eval_{name}"), "--set", *sets])
        torch.cuda.synchronize()
        eval_launches = a1.gather_gemm.launches, f1.farthest_point_sample.launches
        eval_peak = torch.cuda.max_memory_allocated()
        fps_line = next((ln for ln in lines.lines if ln.startswith("eval: ")), "")
        with CLISteps() as steps:
            steps.run = name
            torch.cuda.reset_peak_memory_stats()
            a1.gather_gemm.launches = a1.gather_gemm_dw.launches = 0
            f1.farthest_point_sample.launches = 0
            state = train_cli.main(["--cfg_file", EVAL_YAML, "--output_dir",
                                    str(tmp / f"train_{name}"), "--epochs", "1", "--log_every",
                                    "1", "--set", *sets, *train_extra])
            torch.cuda.synchronize()
            train_f1 = f1.farthest_point_sample.launches
            train_peak = torch.cuda.max_memory_allocated()
    finally:
        logger.removeHandler(lines)
    with open(tmp / f"eval_{name}" / "result.pkl", "rb") as f:
        det_annos = pickle.load(f)
    want_ids = [f"{EVAL_SEQ}#{i:04d}" for i in range(EVAL_FRAMES)]
    if [a["frame_id"] for a in det_annos] != want_ids or not all(
            np.isfinite(a["boxes_lidar"]).all() and np.isfinite(a["score"]).all()
            for a in det_annos):
        raise AssertionError(f"{name} eval CLI: result.pkl incomplete or non-finite")
    m = re.match(r"eval: (\d+) frames in ([\d.]+)s \(([\d.]+) f/s\)", fps_line)
    if not m or int(m.group(1)) != EVAL_FRAMES:
        raise AssertionError(f"{name} eval CLI: no frames/s line: {fps_line!r}")
    if state.step != 2 or [r["launches"] for r in steps.rows] != [want_step] * 2:
        raise AssertionError(f"{name} train CLI: {state.step} steps, launches "
                             f"{[r['launches'] for r in steps.rows]}, want 2 x {want_step}")
    for r in steps.rows:
        bad = [k for k, v in r["tb"].items() if not math.isfinite(v)]
        if bad or r["tb"]["skipped_nonfinite"]:
            raise AssertionError(f"{name} train CLI step: non-finite {bad} or skipped")
    return dict(cfg=cfg, state=state, rows=steps.rows, eval_launches=eval_launches,
                train_f1=train_f1, cli_fps=float(m.group(3)), eval_peak=eval_peak,
                train_peak=train_peak, n_det=sum(len(a["score"]) for a in det_annos))


def pfe_decay_gate(run, seed):
    """Every PFE weight after the training CLI's steps against its seeded
    start moved by AdamW's decoupled decay alone (no gradient reaches the
    PFE): p <- p - lr_t * wd * p per step, within 1e-6 relative, and moved."""
    state = run["state"]
    start = seeded_state_dict(build_network(run["cfg"].MODEL, len(run["cfg"].CLASS_NAMES),
                                            run["cfg"].DATA_CONFIG), seed)
    wd = state.optimizer.param_groups[0]["weight_decay"]
    n = moved = 0
    for key, p in state.model.named_parameters():
        if not key.startswith("pfe."):
            continue
        want = start[key].to(p.device)
        for t in range(state.optimizer.count):
            want = want - state.optimizer.lr_schedule(t) * (wd * want)
        err = float(((p.detach() - want).abs() / want.abs().clamp(min=1e-12)).max())
        if err > 1e-6:
            raise AssertionError(f"registry train CLI: {key} is not its seeded value decayed "
                                 f"by AdamW alone (relative err {err})")
        n += 1
        moved += int(not torch.equal(p.detach(), start[key].to(p.device)))
    if not n or moved != n:
        raise AssertionError(f"registry train CLI: {moved} of {n} PFE weights moved")
    return n


def f1_check(points, valid, what, card):
    """Kernel F1 against its plain version on ``points`` (B, N, C): indices
    exactly equal, a second launch equal; median ms of the launch alone, of
    the whole wrapper and of the plain version (in turns), and the bound:
    the larger of the bytes (coordinates and mask read once, indices written
    once) at 3.35 TB/s and B x K x N distance updates of 9 f32 operations at
    67 TFLOP/s. -> (ms, wrapper ms, plain ms, bound ms, bound by, bytes, ops)."""
    k = FPS_KEYPOINTS
    got = f1.farthest_point_sample(points, valid, k)
    ref = f1.farthest_point_sample_reference(points, valid, k)
    if not (torch.equal(got, ref) and torch.equal(got, f1.farthest_point_sample(points, valid, k))):
        diff = int((got != ref).sum())
        raise AssertionError(f"F1 at {what}: {diff} indices differ from the plain version")
    ops = f1.fps_operands(points, valid)
    ms, wrapper_ms, plain_ms = paired_median_ms(
        lambda: f1.fps_launch(*ops, k), lambda: f1.farthest_point_sample(points, valid, k),
        lambda: f1.farthest_point_sample_reference(points, valid, k), reps=3)
    b, n = valid.shape
    nbytes = b * n * (12 + 1) + b * k * 4
    n_ops = float(b) * k * n * F1_OPS_PER_UPDATE
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, n_ops / F32_CORE_FLOPS * 1e3
    bound = max(t_bytes, t_ops)
    by = "bytes" if t_bytes >= t_ops else "operations"
    print(f"F1 at {what} ({card}): B={b} N={n} K={k}, indices equal to the plain version's; "
          f"launch {ms:.3f} ms, whole wrapper {wrapper_ms:.3f} ms, plain {plain_ms:.3f} ms "
          f"(medians of 3 in turns), bound {bound:.4f} ms by {by} ({nbytes / 1e6:.2f} MB, "
          f"{n_ops / 1e9:.2f} GFLOP)", flush=True)
    return ms, wrapper_ms, plain_ms, bound, by


def keypoint_forward(model, batch, card):
    """F1's path: the registry model's forward in eval mode, the entry point
    that returns the PFE's keypoint features (``predict`` and ``loss_step``
    read none, as JAX's jit drops them). Counts set to 0 just before it and
    read just after; gates: 1 F1 launch, 12 A1 launches, keypoint features
    (B, 2048, D) finite, zero on padded keypoints. Prints its ms (a second
    run) and returns {f1, a1, ms}."""
    with torch.no_grad():
        model(batch)
        torch.cuda.synchronize()
        a1.gather_gemm.launches = f1.farthest_point_sample.launches = 0
        t0 = time.perf_counter()
        out = model(batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    got = {"f1": f1.farthest_point_sample.launches, "a1": a1.gather_gemm.launches, "ms": ms}
    feats, kv = out["point_features"], out["point_valid"]
    b = batch["points"].shape[0]
    if (got["f1"], got["a1"]) != (1, PLAIN_A1_PER_FORWARD) \
            or tuple(feats.shape[:2]) != (b, FPS_KEYPOINTS) or not torch.isfinite(feats).all() \
            or feats[~kv].abs().sum() != 0 or not kv.any():
        raise AssertionError(f"registry keypoint forward: (F1, A1) launches "
                             f"({got['f1']}, {got['a1']}), want (1, {PLAIN_A1_PER_FORWARD}); "
                             f"features {tuple(feats.shape)}")
    print(f"registry (a) keypoint forward ({card}): batch {b}, {FPS_KEYPOINTS} keypoints a "
          f"sample, {feats.shape[-1]} features each, {int(kv.sum())} valid; {ms:.1f} ms "
          f"(1 F1 and {got['a1']} A1 launches)", flush=True)
    return got


def predict_records(pred):
    """predict's fixed-size outputs -> one detection record a sample, as the
    evaluation CLI writes them (for ``results_within_eval_tier``)."""
    out = []
    for i in range(pred["pred_boxes"].shape[0]):
        v = pred["pred_valid"][i].cpu().numpy()
        out.append({"frame_id": f"sample {i}",
                    "boxes_lidar": pred["pred_boxes"][i].cpu().numpy()[v],
                    "score": pred["pred_scores"][i].cpu().numpy()[v],
                    "name": pred["pred_labels"][i].cpu().numpy()[v]})
    return out


def align_check(dev, card):
    """Phase 18 (c): VoxelRCNN at the bench width with ``align_stages=2``
    (mean fusion) and ConvGRU over one history frame, on XTransform clones
    of the bench frame and ``points_prev1`` from another frame. Gates: the
    packed predict launches A1 for one pass of the 2 clones (21) and one of
    the history (21); the sequential predict 3 x 21; the two agree to the
    whole-predict tier; a loss_step is finite. Prints both predicts' ms."""
    frame = make_train_batch(0, batch=1)
    prev, _ = make_lidar_frame(np.random.default_rng(1), N_POINTS)
    rng = np.random.default_rng(0)
    xt = XTransform(stages=2)
    valid = frame["points_valid"][0]
    boxes = frame["gt_boxes"][0].copy()
    data = xt.input_transform({"points": frame["points"][0], "gt_boxes": boxes[:, :7]}, rng)
    boxes[:, :7] = np.where(frame["gt_valid"][0][:, None], data["gt_boxes"], 0.0)
    host = {"points": data["points"], "points_valid": valid, "points_stage1": data["points_stage1"],
            "points_stage1_valid": valid, "transform_param": data["transform_param"],
            "points_prev1": prev, "points_prev1_valid": np.ones(len(prev), bool),
            "gt_boxes": boxes, "gt_valid": frame["gt_valid"][0],
            "css_score": frame["css_score"][0]}
    batch = {k: torch.from_numpy(np.ascontiguousarray(v))[None].to(dev) for k, v in host.items()}
    model = seeded_model(dict(BENCH, align_stages=2, align_method="mean", temporal_name="ConvGRU",
                              num_frames=2), 0, dev)
    runs = {}
    for packed in (True, False):
        model.pack_align_stages = packed
        model.predict(batch)
        torch.cuda.synchronize()
        a1.gather_gemm.launches = 0
        t0 = time.perf_counter()
        pred = model.predict(batch)
        torch.cuda.synchronize()
        runs[packed] = (pred, a1.gather_gemm.launches, (time.perf_counter() - t0) * 1e3)
    want = {True: 2 * A1_PER_FORWARD[False], False: 3 * A1_PER_FORWARD[False]}
    if {k: v[1] for k, v in runs.items()} != want:
        raise AssertionError(f"align: A1 launches (packed, sequential) "
                             f"{runs[True][1]}, {runs[False][1]}, want {want[True]}, {want[False]}")
    n, tight, same = results_within_eval_tier(predict_records(runs[False][0]),
                                              predict_records(runs[True][0]), "align sequential")
    model.pack_align_stages = True
    model.train()
    loss, tb = model.loss_step(batch, generator=step_generator(0, 0, dev))
    model.eval()
    bad = [k for k, v in tb.items() if not math.isfinite(float(v.detach()))]
    if bad or not math.isfinite(float(loss.detach())):
        raise AssertionError(f"align: non-finite loss_step terms {bad}")
    print(f"align stages ({card}): VoxelRCNN at the bench width, 2 XTransform clones of the "
          f"bench frame + 1 history frame through ConvGRU; packed predict {runs[True][2]:.1f} ms "
          f"({runs[True][1]} A1 launches: the clones in one pass, the history in another), "
          f"sequential {runs[False][2]:.1f} ms ({runs[False][1]}); {n} detections paired, "
          f"{tight} within 1e-4 of the scale, {same} bit-equal; loss_step finite, total "
          f"{float(loss.detach()):.4f}", flush=True)


def registry_phase(dev, card):
    """Phase 18: the rest of the detector registry at full width, on phase
    9's yaml, 8 written frames of 200k points and seeded weights. (a)
    VoxelBackBone8x, VoxelSetAbstraction, PartWraper and ConvGRU through
    both CLIs (eval at batch 4, train 2 steps), with A1 forward, A1 as dX and
    A2 held against their plain versions on the operands of one batch-4
    step, F1 against its plain version on one frame's 200k points at 2048
    keypoints (indices equal), the forward that reads the PFE (F1's path:
    the CLIs' ``predict`` and ``loss_step`` read no keypoint feature and
    launch no F1) and every PFE weight decayed by AdamW alone; (b)
    CenterPoint through both CLIs, A1 forward, A1 as dX and A2 held on the
    operands of one batch-4 step and A1 on one batch-4 eval forward; (c) the
    X_TRAIN align path (``align_check``). Returns the kernels-line
    entries."""
    t0 = time.perf_counter()
    seed = train_cli.parse_args(["--cfg_file", EVAL_YAML]).seed
    src = "cpd_tpu_torch/csrc/gather_gemm.cu"
    entries = []
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        write_eval_sequence(tmp, protos=True)
        base = ["DATA_CONFIG.DATA_PATH", str(tmp), "DATA_CONFIG.SAMPLED_INTERVAL.train", "1"]
        cfg = cfg_from_list(base + REGISTRY_SETS, cfg_from_yaml_file(EVAL_YAML, ConfigDict()))
        batch_size = int(cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU)
        dataset = build_dataset(cfg.DATA_CONFIG, cfg.CLASS_NAMES, True, str(tmp))
        _, loader, _ = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, batch_size,
                                        training=True, seed=seed, dataset=dataset)
        b0 = device_batch(next(iter(loader)), dev)
        model = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), cfg.DATA_CONFIG)
        model.load_state_dict(seeded_state_dict(model, seed), strict=True)
        model = place(model, dev)
        checks = train_kernel_checks(model, b0, step_generator(seed, 0, dev),
                                     want=(PLAIN_A1_FORWARD, PLAIN_A1_DX, PLAIN_A2))
        f1_frame = f1_check(b0["points"][:1], b0["points_valid"][:1], "one frame", card)
        f1_batch = f1_check(b0["points"], b0["points_valid"], f"the batch of {batch_size}", card)
        kp = keypoint_forward(model.eval(), b0, card)
        del model
        torch.cuda.empty_cache()
        print(f"registry (a) kernel checks done at {time.perf_counter() - t0:.1f} s", flush=True)

        a = registry_cli_pair(dev, card, tmp, "registry", REGISTRY_SETS, REGISTRY_TRAIN_SETS,
                              (PLAIN_A1_FORWARD, PLAIN_A1_DX, PLAIN_A2, 0))
        n_batches = math.ceil(EVAL_FRAMES / batch_size)
        if a["eval_launches"] != (PLAIN_A1_PER_FORWARD * n_batches, 0) or a["train_f1"]:
            raise AssertionError(f"registry CLIs: (A1, F1) launches {a['eval_launches']} in the "
                                 f"eval, F1 {a['train_f1']} in training; want "
                                 f"({PLAIN_A1_PER_FORWARD * n_batches}, 0) and 0")
        if not {"wrap_loss", "hm_loss", "rcnn_cls0"} <= set(a["rows"][0]["tb"]):
            raise AssertionError(f"registry train CLI: tb keys {sorted(a['rows'][0]['tb'])}")
        n_pfe = pfe_decay_gate(a, seed)
        print(f"registry (a) CLIs ({card}): VoxelBackBone8x + VoxelSetAbstraction + PartWraper "
              f"+ ConvGRU; eval CLI {a['cli_fps']:.3f} frames/s at batch {batch_size}, "
              f"{a['n_det']} detections, peak {a['eval_peak'] / 2**30:.2f} GiB; train CLI steps "
              + ", ".join(f"{r['ms']:.1f}" for r in a["rows"])
              + f" ms (A1 {PLAIN_A1_FORWARD} forward + {PLAIN_A1_DX} dX, A2 {PLAIN_A2} a "
              f"step), peak {a['train_peak'] / 2**30:.2f} GiB; {n_pfe} PFE weights moved by "
              f"AdamW's decay alone; last tb: "
              + ", ".join(f"{k} {v:.4f}" for k, v in a["rows"][-1]["tb"].items()), flush=True)

        b = registry_cli_pair(dev, card, tmp, "centerpoint", CENTERPOINT_SETS, (),
                              (ANCHOR_A1_FORWARD, ANCHOR_A1_DX, ANCHOR_A2, 0))
        if b["eval_launches"] != (A1_PER_FORWARD[False] * n_batches, 0):
            raise AssertionError(f"CenterPoint eval CLI: (A1, F1) launches {b['eval_launches']}")
        if set(b["rows"][0]["tb"]) != {"hm_loss", "loc_loss", "total_loss", "grad_norm",
                                       "skipped_nonfinite"}:
            raise AssertionError(f"CenterPoint train CLI: tb keys {sorted(b['rows'][0]['tb'])}")
        cfg_b = cfg_from_list(base + CENTERPOINT_SETS, cfg_from_yaml_file(EVAL_YAML, ConfigDict()))
        cp = build_network(cfg_b.MODEL, len(cfg_b.CLASS_NAMES), cfg_b.DATA_CONFIG)
        cp.load_state_dict(seeded_state_dict(cp, 0), strict=True)
        cp = place(cp, dev)
        cp_checks = train_kernel_checks(cp, b0, step_generator(seed, 0, dev),
                                        want=(ANCHOR_A1_FORWARD, ANCHOR_A1_DX, ANCHOR_A2))
        convs = recorded_forward(cp.eval(), b0)
        cp_err, cp_shapes = check_kernel("A1 CenterPoint predict", convs, a1_kernel, a1_plain,
                                         torch.bfloat16)
        del convs, cp
        torch.cuda.empty_cache()
        print(f"registry (b) CenterPoint ({card}): eval CLI {b['cli_fps']:.3f} frames/s at batch "
              f"{batch_size}, {b['n_det']} detections, peak {b['eval_peak'] / 2**30:.2f} GiB; "
              "train CLI steps " + ", ".join(f"{r['ms']:.1f}" for r in b["rows"])
              + f" ms, peak {b['train_peak'] / 2**30:.2f} GiB; last tb: "
              + ", ".join(f"{k} {v:.4f}" for k, v in b["rows"][-1]["tb"].items()), flush=True)
    align_check(dev, card)

    for run, run_checks, what in ((a, checks, "VoxelBackBone8x + PFE + PartWraper + ConvGRU"),
                                  (b, cp_checks, "CenterPoint")):
        fwd, dx, dw = (sum(r["launches"][i] for r in run["rows"]) for i in range(3))
        path = f"registry: {what}, train CLI, batch 4"
        entries += [
            kernel_entry("gather_gemm", path, src, "cpd_tpu/ops/pallas_conv.py:77", fwd,
                         *run_checks["forward"]),
            kernel_entry("gather_gemm (dX)", path, src, "cpd_tpu/ops/pallas_conv.py:77", dx,
                         *run_checks["dx"]),
            kernel_entry("gather_gemm_dw", path, "cpd_tpu_torch/csrc/gather_gemm_dw.cu",
                         "cpd_tpu/ops/pallas_conv.py:130", dw, *run_checks["dw"])]
    entries.append(kernel_entry("gather_gemm", "registry: CenterPoint, eval CLI, batch 4", src,
                                "cpd_tpu/ops/pallas_conv.py:77", b["eval_launches"][0], cp_err,
                                cp_shapes))
    ms, wrapper_ms, plain_ms, bound, by = f1_frame
    entries.append({"name": "farthest_point_sample",
                    "path": "registry: PFE keypoints, model forward, batch 4",
                    "route": "cuda", "source": "cpd_tpu_torch/csrc/farthest_point_sample.cu",
                    "replaces": "cpd_tpu/ops/pool.py:408",
                    "launches": kp["f1"], "max_abs_err": 0.0, "forward_ms": kp["ms"],
                    "ms": ms, "wrapper_ms": wrapper_ms, "plain_ms": plain_ms, "bound_ms": bound,
                    "bound_by": by, "library_ms": None, "batch_ms": f1_batch[0],
                    "batch_plain_ms": f1_batch[2], "batch_bound_ms": f1_batch[3]})
    print(f"registry phase: {time.perf_counter() - t0:.1f} s ({card})", flush=True)
    return entries


# ---- phase 19: the toolbox modules -----------------------------------------

OPS_ROIS = 128
OPS_KEYPOINTS, OPS_SUPPORT, OPS_CHANNELS = 1024, 16_384, 32
OPS_MSG_GROUPS = ({"num_local_voxel": (3, 3, 3), "post_mlps": (32,), "max_neighbor_distance": 0.8},
                  {"num_local_voxel": (3, 3, 3), "post_mlps": (32,), "max_neighbor_distance": 1.6})
OPS_NMS = {"NMS_THRESH": 0.7, "NMS_PRE_MAXSIZE": 4096, "NMS_POST_MAXSIZE": 500}
OPS_GT_SLOTS = 64


def _ops_boxes(rng, n, extra=0, spread=6.0):
    cols = [rng.uniform(-spread, spread, (n, 2)), rng.uniform(-1, 1, (n, 1)),
            rng.uniform(0.8, 4.0, (n, 3)), rng.uniform(-np.pi, np.pi, (n, 1)),
            rng.normal(size=(n, extra))]
    return np.concatenate(cols, -1).astype(np.float32)


def _seeded_module(module, seed, dev):
    """``module`` with every parameter drawn from numpy (the same on each
    device), in eval mode on ``dev``."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(torch.from_numpy(rng.normal(0.0, 1.0 / math.sqrt(max(p[0].numel(), 1)),
                                                tuple(p.shape)).astype(np.float32)))
    return module.to(dev).eval()


def ops_small_cases():
    """{module: fn(dev) -> outputs} at the CPU tests' small sizes, every
    input made from a seed with numpy, for the card-against-CPU check."""
    from cpd_tpu_torch.models import atss, transformer, vector_pool
    from cpd_tpu_torch.ops import box_coders, dcn, geometry, roipool
    from cpd_tpu_torch.utils import loss as loss_utils

    def t(x, dev):
        return torch.from_numpy(np.array(x)).to(dev)

    def geometry_case(dev):
        rng = np.random.default_rng(0)
        pts = np.concatenate([rng.uniform(-8, 8, (300, 2)), rng.uniform(-2, 2, (300, 1)),
                              rng.normal(size=(300, 1))], -1).astype(np.float32)
        boxes, far = t(_ops_boxes(rng, 9, 1), dev), t(_ops_boxes(rng, 40, spread=9.0), dev)
        cut = (-6.0, -5.0, -1.0, 6.5, 5.5, 1.5)
        coords = t(rng.integers(0, 40, (50, 3)).astype(np.int32), dev)
        return [geometry.points_in_boxes_mask(t(pts, dev), boxes),
                geometry.points_in_boxes_index(t(pts, dev), boxes, t(np.arange(9) % 3 != 1, dev)),
                geometry.enlarge_box3d(boxes, (0.2, 0.3, 0.4)),
                geometry.get_voxel_centers(coords, 2, (0.4, 0.4, 0.15), BENCH["point_cloud_range"]),
                geometry.mask_points_outside_range(t(pts, dev), cut),
                geometry.mask_boxes_outside_range(far, cut, 2)]

    def coders_case(dev):
        rng = np.random.default_rng(1)
        boxes, anchors = t(_ops_boxes(rng, 20, 2), dev), t(_ops_boxes(rng, 20, 2), dev)
        codes = t(rng.normal(size=(20, 10)).astype(np.float32) * 0.5, dev)
        pts = t(rng.normal(size=(20, 3)).astype(np.float32), dev)
        cls = t(rng.integers(1, 4, 20), dev)
        point = box_coders.PointResidualCoder(mean_size=[[3.9, 1.6, 1.56], [0.8, 0.6, 1.73],
                                                         [1.76, 0.6, 1.73]])
        out = []
        for coder in (box_coders.ResidualCoder(encode_angle_by_sincos=True),
                      box_coders.ResidualCoderV2(encode_angle_by_sincos=True)):
            out += [coder.encode(boxes, anchors), coder.decode(codes, anchors)]
        return out + [point.encode(boxes, pts, cls), point.decode(codes[:, :8], pts, cls),
                      box_coders.PreviousResidualDecoder.decode(codes[:, :7], boxes[:, :7])]

    def nms_case(dev):
        rng = np.random.default_rng(5)
        boxes = _ops_boxes(rng, 60, spread=5.0)
        boxes[30:, :3] = boxes[:30, :3] + rng.normal(0, 0.3, (30, 3))
        rng.random(60)
        cls = t(rng.random((60, 3)).astype(np.float32), dev)
        cfg = {"NMS_THRESH": 0.3, "NMS_PRE_MAXSIZE": 50, "NMS_POST_MAXSIZE": 24}
        b = t(boxes, dev)
        return [*nms.nms_normal_bev(b, cls[:, 0], 0.1, 48, 20),
                *nms.multi_classes_nms(cls, b, cfg, 0.2),
                *nms.class_agnostic_nms(cls[:, 1], b, dict(cfg, USE_FAST_NMS=True), 0.2)]

    def losses_case(dev):
        rng = np.random.default_rng(7)
        gt = _ops_boxes(rng, 12)
        pred = gt + np.concatenate([rng.normal(0, 0.3, (12, 3)), rng.normal(0, 0.2, (12, 3)),
                                    rng.normal(0, 0.3, (12, 1))], -1).astype(np.float32)
        pred[:, 3:6] = np.abs(pred[:, 3:6]) + 0.3
        p = t(pred, dev).requires_grad_()
        loss = loss_utils.odiou_3d(p, t(gt, dev))
        loss.backward()
        l1 = loss_utils.weighted_l1_loss(t(pred, dev), t(gt, dev), t(np.ones(12, np.float32), dev),
                                         [1.0] * 6 + [0.5])
        return [loss.detach(), p.grad, l1]

    def roipool_case(dev):
        rng = np.random.default_rng(8)
        boxes = _ops_boxes(rng, 8, spread=4.0)
        boxes[-1, 3:6] = 0.3
        pts = np.concatenate([rng.uniform(-6, 6, (2000, 2)), rng.uniform(-2, 2, (2000, 1))],
                             -1).astype(np.float32)
        feats = rng.normal(size=(2000, 4)).astype(np.float32)
        args = (t(pts, dev), t(feats, dev), t(boxes, dev))
        kw = dict(points_valid=t(rng.random(2000) < 0.9, dev),
                  boxes_valid=t(np.arange(8) != 2, dev))
        return [roipool.roiaware_pool3d(*args, 4, "max", **kw),
                roipool.roiaware_pool3d(*args, 4, "avg", **kw),
                *roipool.roipoint_pool3d(*args, 16, **kw)]

    def sparse_case(dev):
        rng = np.random.default_rng(10)
        grid = sparse.GridSpec(6, 5, 8)
        keys = np.full(180, sparse.INVALID_KEY, np.int32)
        keys[:150] = np.sort(rng.choice(grid.num_cells, 150, replace=False))
        book = sparse.build_subm_rulebook(t(keys, dev), grid)
        feats = t(rng.normal(size=(180, 8)).astype(np.float32), dev)
        w = t(rng.normal(size=(27, 8, 16)).astype(np.float32) * 0.2, dev)
        x = t(rng.normal(1.0, 2.0, (2, 40, 6)).astype(np.float32), dev)
        bias = t(rng.normal(size=16).astype(np.float32), dev)
        return [sparse.sparse_conv_apply(feats, book, w, bias),
                *sparse.masked_batch_stats(x, t(rng.random((2, 40)) < 0.6, dev))]

    def atss_case(dev):
        rng = np.random.default_rng(1)
        xs = np.linspace(-7.5, 7.5, 12)
        gx, gy = np.meshgrid(xs, xs, indexing="ij")
        anchors = []
        for size in ((3.9, 1.6, 1.56), (0.8, 0.6, 1.73)):
            for rot in (0.0, np.pi / 2):
                a = np.zeros((144, 7), np.float32)
                a[:, 0], a[:, 1], a[:, 2] = gx.ravel(), gy.ravel(), -1.0
                a[:, 3:6], a[:, 6] = size, rot
                anchors.append(a)
        gt = np.zeros((10, 8), np.float32)
        gt[:, :2] = rng.uniform(-6, 6, (10, 2))
        gt[:, 2] = rng.uniform(-1.5, -0.5, 10)
        gt[:, 3:6] = rng.uniform([2.0, 1.2, 1.0], [5.0, 2.5, 2.0], (10, 3))
        gt[:, 6] = rng.uniform(-np.pi, np.pi, 10)
        gt[:, 7] = rng.integers(1, 4, 10)
        out = atss.atss_assign(t(np.concatenate(anchors), dev), t(gt, dev),
                               t(np.arange(10) < 7, dev))
        return [out["labels"], out["max_iou"]]

    def dcn_case(dev):
        rng = np.random.default_rng(2)
        x = t(rng.normal(size=(2, 9, 7, 5)).astype(np.float32), dev)
        out = []
        for modulated in (True, False):
            layer = _seeded_module(dcn.DeformConv2d(5, 6, modulated=modulated), 2, dev)
            with torch.no_grad():
                out.append(layer(x))
        return out

    def transformer_case(dev):
        rng = np.random.default_rng(5)
        tokens = t(rng.normal(size=(2, 9, 12)).astype(np.float32), dev)
        mask = t((np.arange(9)[None] < np.array([[9], [6]]))[:, None, None, :], dev)
        enc = _seeded_module(transformer.TransformerEncoder(16, 2, 4, in_channels=12), 5, dev)
        dec = _seeded_module(transformer.TransformerDecoder(16, 1, 4, num_queries=6), 6, dev)
        with torch.no_grad():
            memory = enc(tokens, mask)
            return [memory, dec(memory, mask)]

    def vector_pool_case(dev):
        rng = np.random.default_rng(10)
        sx = rng.uniform(-5, 5, (300, 3)).astype(np.float32)
        sv = rng.random(300) < 0.9
        sf = rng.normal(size=(300, 6)).astype(np.float32)
        cx = rng.uniform(-4, 4, (7, 3)).astype(np.float32)
        cv = np.arange(7) < 6
        groups = ({"num_local_voxel": (2, 2, 2), "post_mlps": (16,), "max_neighbor_distance": 0.8},
                  {"num_local_voxel": (3, 3, 3), "post_mlps": (16,), "max_neighbor_distance": 1.6})
        msg = vector_pool.VectorPoolAggregationMSG(6, groups, num_reduced_channels=3,
                                                   num_channels_of_local_aggregation=4,
                                                   msg_post_mlps=(24, 12))
        msg = _seeded_module(msg, 10, dev).train()
        out = msg(*(t(a, dev)[None] for a in (sx, sv, sf, cx, cv)))
        stats = [b for k, b in msg.named_buffers() if k.endswith(("running_mean", "running_var"))]
        return [out.detach(), *stats]

    return {"geometry": geometry_case, "box_coders": coders_case, "nms": nms_case,
            "losses (weighted_l1_loss, odiou_3d)": losses_case, "roipool": roipool_case,
            "sparse_conv_apply, masked_batch_stats": sparse_case, "atss_assign": atss_case,
            "DeformConv2d": dcn_case, "transformer": transformer_case,
            "VectorPoolAggregationMSG": vector_pool_case}


def ops_card_against_cpu():
    """Phase 19 (a): each module at the CPU tests' small sizes on the card
    and on the CPU (TF32 off): floats within 1e-4 of the CPU's scale,
    integers, labels, masks and indices equal."""
    for name, case in ops_small_cases().items():
        card, cpu = case(torch.device("cuda")), case(torch.device("cpu"))
        worst = 0.0
        for i, (a, b) in enumerate(zip(card, cpu, strict=True)):
            a = a.cpu()
            if a.shape != b.shape or a.dtype != b.dtype:
                raise AssertionError(f"{name} output {i}: card {a.dtype}{tuple(a.shape)}, "
                                     f"CPU {b.dtype}{tuple(b.shape)}")
            if not a.is_floating_point():
                if not torch.equal(a, b):
                    raise AssertionError(f"{name} output {i}: card and CPU differ at "
                                         f"{int((a != b).sum())} of {a.numel()} entries")
                continue
            scale = max(float(b.abs().max()), 1e-6) if b.numel() else 1.0
            err = float((a - b).abs().max()) if b.numel() else 0.0
            if not err <= 1e-4 * scale:
                raise AssertionError(f"{name} output {i}: card against CPU {err} at scale {scale}")
            worst = max(worst, err / scale)
        print(f"ops (a) {name}: card = CPU at the CPU tests' size ({len(cpu)} outputs, "
              f"worst float error {worst:.2e} of scale)", flush=True)


def ops_timed(name, fn, card, reps=3):
    """One module at its full size: the median device ms of ``reps`` calls
    after a warm-up, and the peak memory of those calls."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"ops (b) {name}: {statistics.median(times):.3f} ms (median of {reps} after a "
          f"warm-up), peak {peak:.2f} GiB ({card})", flush=True)
    return out


def ops_nms(dev, card):
    """Phase 19's NMS calls on 8192 boxes within +-70 m and their scores of 3
    classes (seed 8192): the class-agnostic and the per-class NMS at
    pre_max_size 4096, each first counted (B4b and B4c must launch) with its
    operands kept for phase 22, then timed."""
    rng = np.random.default_rng(8192)
    nms_boxes = torch.from_numpy(_ops_boxes(rng, 8192, spread=70.0)).to(dev)
    nms_scores = torch.from_numpy(rng.random((8192, 3)).astype(np.float32)).to(dev)
    agnostic = lambda: nms.class_agnostic_nms(nms_scores[:, 0], nms_boxes, OPS_NMS, 0.1)
    multi = lambda: nms.multi_classes_nms(nms_scores, nms_boxes, OPS_NMS, 0.1)
    with torch.no_grad():
        with recording_b4("phase 19 class_agnostic_nms, 8192 boxes"):
            b4_counted("phase 19 class_agnostic_nms", agnostic, B4_NMS)
        b4_counted("phase 19 multi_classes_nms", multi, B4_NMS)
        kept = ops_timed("class_agnostic_nms, 8192 boxes, pre_max_size 4096", agnostic, card)
        per_class = ops_timed("multi_classes_nms, 3 classes, pre_max_size 4096", multi, card)
    if not (kept[1].any() and per_class[1].any(dim=1).all()):
        raise AssertionError("NMS: nothing kept")


def ops_phase(dev, card):
    """Phase 19: every toolbox module of the port but the plotter on the
    card. (a) ``ops_card_against_cpu``; (b) each at its full size, timed:
    RoI-aware pooling (out_size 12, max and avg) and RoI-point pooling (512
    points) of 128 RoIs on the 200k-point bench frame with its 5 columns as
    features, VectorPoolAggregationMSG (1,024 keypoints over 16,384 support
    points of 32 channels, two 3 x 3 x 3 groups of radius 0.8 and 1.6 m, in
    training mode), DeformConv2d (batch 2, 188 x 188, 128 -> 128), the
    transformer encoder (dim 256, depth 3, 4 heads, 4,096 tokens, batch 2)
    and decoder (100 queries on that memory), ``atss_assign`` on the DBSCAN
    yaml's anchor grid with 64 gt slots, the class-agnostic and per-class NMS
    at pre_max_size 4,096, and the geometry, coders, losses, one-sample
    sparse conv (kernel A1), masked statistics and model helpers at the
    frame's scale. Raises on any failure."""
    from cpd_tpu_torch.models import (atss, load_data_to_device, model_fn_decorator,
                                      transformer, vector_pool)
    from cpd_tpu_torch.ops import box_coders, dcn, geometry, roipool
    from cpd_tpu_torch.utils import loss as loss_utils

    t0 = time.perf_counter()
    ops_card_against_cpu()
    rng = np.random.default_rng(0)
    pts, valid = make_lidar_frame(np.random.default_rng(0), N_POINTS)
    frame = load_data_to_device({"points": pts, "points_valid": valid}, dev)
    points, pv = frame["points"], frame["points_valid"]
    centres = pts[valid][rng.choice(int(valid.sum()), OPS_ROIS, replace=False), :3]
    rois = np.concatenate([centres, rng.uniform([3.5, 1.6, 1.4], [5.0, 2.2, 2.0], (OPS_ROIS, 3)),
                           rng.uniform(-np.pi, np.pi, (OPS_ROIS, 1))], -1).astype(np.float32)
    rois = torch.from_numpy(rois).to(dev)
    for method in ("max", "avg"):
        out = ops_timed(f"roiaware_pool3d {method}, out_size 12, {OPS_ROIS} RoIs, "
                        f"{N_POINTS} points x 5 columns",
                        lambda: roipool.roiaware_pool3d(points, points, rois, 12, method,
                                                        points_valid=pv), card)
        if not (torch.isfinite(out).all() and (out != 0).any()):
            raise AssertionError(f"roiaware_pool3d {method}: not finite or all zero")
    pooled, pooled_valid, empty = ops_timed(
        f"roipoint_pool3d, 512 points, {OPS_ROIS} RoIs",
        lambda: roipool.roipoint_pool3d(points, points, rois, 512, points_valid=pv), card)
    if empty.all() or not pooled_valid.any():
        raise AssertionError("roipoint_pool3d: every RoI empty")

    sel = np.nonzero(valid)[0][rng.choice(int(valid.sum()), OPS_SUPPORT, replace=False)]
    support = points[torch.from_numpy(sel).to(dev), :3][None]
    feats = torch.from_numpy(rng.normal(size=(1, OPS_SUPPORT, OPS_CHANNELS)).astype(
        np.float32)).to(dev)
    keys = support[:, torch.from_numpy(rng.choice(OPS_SUPPORT, OPS_KEYPOINTS, replace=False)).to(
        dev)]
    ones = torch.ones((1, OPS_SUPPORT), dtype=torch.bool, device=dev)
    kv = torch.ones((1, OPS_KEYPOINTS), dtype=torch.bool, device=dev)
    msg = vector_pool.VectorPoolAggregationMSG(OPS_CHANNELS, OPS_MSG_GROUPS,
                                               num_reduced_channels=8, msg_post_mlps=(64,))
    msg = _seeded_module(msg, 0, dev).train()
    with torch.no_grad():
        out = ops_timed(f"VectorPoolAggregationMSG, {OPS_KEYPOINTS} keypoints over "
                        f"{OPS_SUPPORT} points x {OPS_CHANNELS}",
                        lambda: msg(support, ones, feats, keys, kv), card)
    if not (torch.isfinite(out).all() and out.abs().sum() > 0):
        raise AssertionError("VectorPoolAggregationMSG: not finite or all zero")

    layer = _seeded_module(dcn.DeformConv2d(128, 128), 1, dev)
    x = torch.from_numpy(rng.normal(size=(2, 188, 188, 128)).astype(np.float32)).to(dev)
    with torch.no_grad():
        out = ops_timed("DeformConv2d, batch 2, 188 x 188, 128 -> 128", lambda: layer(x), card)
    if out.shape != (2, 188, 188, 128) or not torch.isfinite(out).all():
        raise AssertionError(f"DeformConv2d: {tuple(out.shape)}, "
                             f"finite {bool(torch.isfinite(out).all())}")
    del x, out

    enc = _seeded_module(transformer.TransformerEncoder(256, 3, 4), 2, dev)
    dec = _seeded_module(transformer.TransformerDecoder(256, 3, 4, num_queries=100), 3, dev)
    tokens = torch.from_numpy(rng.normal(size=(2, 4096, 256)).astype(np.float32)).to(dev)
    with torch.no_grad():
        memory = ops_timed("TransformerEncoder, dim 256, depth 3, 4 heads, 4096 tokens, batch 2",
                           lambda: enc(tokens), card)
        queries = ops_timed("TransformerDecoder, 100 queries on that memory",
                            lambda: dec(memory), card)
    if queries.shape != (2, 100, 256) or not torch.isfinite(queries).all():
        raise AssertionError("transformer: bad decoder output")

    _, dbscan = yaml_model(DBSCAN_YAML, [], 0, dev)
    grid = dbscan.dense_head.anchors((188, 188), dev)[0].reshape(-1, 7)
    del dbscan
    gt = np.zeros((OPS_GT_SLOTS, 8), np.float32)
    gt[:, :7] = _ops_boxes(rng, OPS_GT_SLOTS, spread=70.0)
    gt[:, 7] = rng.integers(1, 4, OPS_GT_SLOTS)
    gt_valid = torch.from_numpy(np.arange(OPS_GT_SLOTS) < 48).to(dev)
    gt = torch.from_numpy(gt).to(dev)
    assigned = ops_timed(f"atss_assign, the DBSCAN yaml's {grid.shape[0]} anchors, "
                         f"{OPS_GT_SLOTS} gt slots", lambda: atss.atss_assign(grid, gt, gt_valid),
                         card)
    if not (assigned["labels"] >= 0).any():
        raise AssertionError("atss_assign: no anchor assigned")

    ops_nms(dev, card)

    ops_timed(f"points_in_boxes_mask, {N_POINTS} points x {OPS_GT_SLOTS} boxes",
              lambda: geometry.points_in_boxes_index(points, gt, gt_valid), card)
    anchors = grid[:, :7]
    coder = box_coders.ResidualCoder(encode_angle_by_sincos=True)
    boxes = anchors + 0.1
    ops_timed(f"ResidualCoder (sincos) encode + decode, {anchors.shape[0]} anchors",
              lambda: coder.decode(coder.encode(boxes, anchors), anchors), card)
    pred = (gt[:, :7] + 0.05).repeat(64, 1).requires_grad_()
    target = gt[:, :7].repeat(64, 1)

    def odiou_step():
        pred.grad = None
        loss = loss_utils.odiou_3d(pred, target)
        loss.backward()
        return loss
    loss = ops_timed(f"odiou_3d loss and gradient, {pred.shape[0]} pairs", odiou_step, card)
    if not (torch.isfinite(loss) and torch.isfinite(pred.grad).all()):
        raise AssertionError("odiou_3d: not finite")

    a1_before = a1.gather_gemm.launches
    vox = torch.from_numpy(np.sort(rng.choice(1504 * 1504 * 41, 60_000, replace=False)).astype(
        np.int32)).to(dev)
    book = sparse.build_subm_rulebook(vox, sparse.GridSpec(1504, 1504, 41))
    vfeat = torch.from_numpy(rng.normal(size=(60_000, 16)).astype(np.float32)).to(dev)
    w = torch.from_numpy(rng.normal(0, 0.1, (27, 16, 16)).astype(np.float32)).to(dev)
    conv = ops_timed("sparse_conv_apply (kernel A1), 60000 voxels, 16 -> 16",
                     lambda: sparse.sparse_conv_apply(vfeat, book, w), card)
    if a1.gather_gemm.launches - a1_before != 4:
        raise AssertionError(f"sparse_conv_apply launched A1 {a1.gather_gemm.launches - a1_before} "
                             "times, not 4")
    ops_timed("masked_batch_stats, 60000 x 16",
              lambda: sparse.masked_batch_stats(conv, book.out_valid), card)

    small = VoxelRCNN(**SMALL)
    small.load_state_dict(seeded_state_dict(small, 0), strict=True)
    small = place(small, dev)
    fn = model_fn_decorator(small)
    state = {k: v.clone() for k, v in small.state_dict().items()}
    batch = make_tiny_train_batch(b=1, with_proto=True)
    first, tb, disp = fn(batch)
    small.load_state_dict(state)
    again, _, _ = fn(batch)
    first, again = float(first.detach()), float(again.detach())
    if not (math.isfinite(first) and first == again and "total_loss" in disp):
        raise AssertionError(f"model_fn_decorator: {first} then {again}")
    if not native.available():
        raise AssertionError("native.available() is False after the build")
    print(f"ops (b) model_fn_decorator: loss {first:.4f} twice on the SMALL model; "
          f"native.available(): True", flush=True)
    print(f"ops phase: {time.perf_counter() - t0:.1f} s ({card})", flush=True)


# ---- kernels B4a-c: rotated BEV overlap and NMS (phase 22) -----------------

B4_SRC = "cpd_tpu_torch/csrc/nms_bev.cu"
B4_KERNELS = (("pairwise_overlap_bev", "B4a", "cpd_tpu/ops/iou3d.py:166"),
              ("nms_mask_bev", "B4b", "cpd_tpu/ops/nms.py:55"),
              ("nms_suppress", "B4c", "cpd_tpu/ops/nms.py:24"))
B4_NMS, B4_ALL, B4_NONE = (False, True, True), (True, True, True), (False, False, False)
B4_MAIN_PATHS = {"B4a": "DBSCAN VoxelRCNN step", "B4b": "predict, dense tail",
                 "B4c": "predict, dense tail"}
B4_PATHS = {}    # path -> (B4a, B4b, B4c) launches of its counted run
B4_RECORDS = {}  # operand set -> [("nms", boxes, scores, valid, kwargs) | ("overlap", a, b)]
B4_RECORD_LIMIT = 4
B4_TIMED_REPS = 5


def b4_counts():
    return (iou3d.pairwise_overlap_bev.launches, nms.nms_mask_bev.launches,
            nms.nms_suppress.launches)


def b4_counted(path, fn, want):
    """``fn()`` with B4's launch counts set to 0 just before and read just
    after, kept under ``path``; raises where a kernel that ``want`` flags (B4a,
    B4b, B4c) launched no time."""
    iou3d.pairwise_overlap_bev.launches = nms.nms_mask_bev.launches = 0
    nms.nms_suppress.launches = 0
    out = fn()
    torch.cuda.synchronize()
    got = b4_counts()
    B4_PATHS[path] = got
    print(f"B4 launches, {path}: (B4a, B4b, B4c) = {got}", flush=True)
    missing = [tag for (_, tag, _), n, w in zip(B4_KERNELS, got, want) if w and not n]
    if missing:
        raise AssertionError(f"{path}: {missing} launched no time, (B4a, B4b, B4c) = {got}")
    return out


@contextlib.contextmanager
def recording_b4(name):
    """Keep copies of the operands of the rotated NMS (``nms.nms_bev_batched``)
    and BEV overlap (``iou3d.boxes_overlap_bev``) calls made inside, the first
    ``B4_RECORD_LIMIT`` of each, under ``name`` for phase 22."""
    calls = B4_RECORDS.setdefault(name, [])
    batched, overlap = nms.nms_bev_batched, iou3d.boxes_overlap_bev

    def nms_call(boxes, scores, thresh, pre_max_size=1024, post_max_size=256, valid=None,
                 use_bev_iou=True, fast=False):
        if sum(c[0] == "nms" for c in calls) < B4_RECORD_LIMIT:
            calls.append(("nms", boxes.detach().clone(), scores.detach().clone(),
                          None if valid is None else valid.clone(),
                          dict(thresh=thresh, pre_max_size=pre_max_size,
                               use_bev_iou=use_bev_iou, fast=fast)))
        return batched(boxes, scores, thresh, pre_max_size, post_max_size, valid, use_bev_iou,
                       fast)

    def overlap_call(boxes_a, boxes_b, method="candidates"):
        if sum(c[0] == "overlap" for c in calls) < B4_RECORD_LIMIT:
            calls.append(("overlap", boxes_a.detach().clone(), boxes_b.detach().clone()))
        return overlap(boxes_a, boxes_b, method)

    nms.nms_bev_batched, iou3d.boxes_overlap_bev = nms_call, overlap_call
    try:
        yield
    finally:
        nms.nms_bev_batched, iou3d.boxes_overlap_bev = batched, overlap


def b4_sorted_operands(boxes, scores, valid, thresh, pre_max_size, use_bev_iou, fast):
    """The score-sorted boxes and valid mask that ``nms_bev_batched`` hands
    B4b and B4c."""
    if valid is None:
        valid = torch.ones(scores.shape, dtype=torch.bool, device=scores.device)
    top, order = nms.top_k(torch.where(valid, scores, -math.inf), min(pre_max_size,
                                                                      scores.shape[1]))
    return nms.gather_rows(boxes[..., :7], order).contiguous(), torch.isfinite(top)


def b4_timed(kernel, launch, wrapper, plain, nbytes, ops, what, clip_all_ops=None):
    """Median device ms of the launch alone and of the whole wrapper
    (``B4_TIMED_REPS`` runs in turns), the plain version's ms (one call: it
    takes up to a second at K = 4096, and has just run in the check) and the
    bound: the larger of ``nbytes`` at 3.35 TB/s and ``ops`` f32 operations
    at 67 TFLOP/s. ``clip_all_ops``: the operations with the clip on every
    pair, whose bound the line prints beside."""
    ms, wrapper_ms = paired_median_ms(launch, wrapper, reps=B4_TIMED_REPS)
    _, plain_ms = timed_once_ms(plain)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_CORE_FLOPS * 1e3
    row = dict(kernel=kernel, ms=ms, wrapper_ms=wrapper_ms, plain_ms=plain_ms,
               bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations")
    old = "" if clip_all_ops is None else (
        f"; the clip on every pair: {max(t_bytes, clip_all_ops / F32_CORE_FLOPS * 1e3):.7f} ms")
    print(f"{kernel} at {what}: launch {ms:.4f} ms, wrapper {wrapper_ms:.4f} ms (medians of "
          f"{B4_TIMED_REPS}, in turns), plain {plain_ms:.4f} ms; bound {row['bound_ms']:.7f} "
          f"ms by {row['bound_by']} ({nbytes / 1e6:.3f} MB, {ops / 1e9:.5f} GFLOP){old}",
          flush=True)
    return row


def b4_pair_ops(a, b, clip_ops):
    """Each pair's f32 operations in B4a and B4b: the disjoint-pair reject's
    8 (two differences, three products, two sums, the compare) on every
    pair, and the clip's (``clip_ops``, from the plain version) only on the
    pairs the reject lets through (``iou3d.clip_reject``); and the pairs
    rejected."""
    rejected = iou3d.clip_reject(a[:, :, None], b[:, None])
    return 8 + torch.where(rejected, 0, clip_ops), rejected


def b4_resources():
    """B4's kernels as ptxas reports them (registers, stack frame, spills);
    raises where the clip's kernels (B4a, B4b) have a stack frame or spill:
    their polygon is to live in registers."""
    rows = cuda_build.kernel_resources("nms_bev")
    if not rows:
        print("B4 ptxas: the build was reused, no report in this process", flush=True)
        return
    for kernel, regs, spilled, smem, stack in rows:
        print(f"B4 ptxas {kernel}: {regs} registers a thread, {stack} bytes of stack frame, "
              f"{spilled} bytes spilled, {smem} bytes of static shared memory", flush=True)
    clip = [r for r in rows if "pairwise_overlap_bev" in r[0] or "nms_mask_bev" in r[0]]
    if len(clip) != 2 or any(r[2] or r[4] for r in clip):
        raise AssertionError(f"B4a/B4b: a stack frame or spills, or a kernel missing: {clip}")


def b4_overlap_check(a, b, what):
    """B4a against its plain version on (B, N, 7) and (B, M, 7) boxes: within
    2 ulp of it (equal bits expected; NaN where the plain version has NaN, as
    for the non-finite boxes of rows an NMS leaves invalid), the same bits
    twice; timed. Returns the row and each pair's clip operations."""
    got = iou3d.pairwise_overlap_bev(a, b)
    ref, ops = iou3d.pairwise_overlap_bev_reference(a, b, count_ops=True)
    torch.cuda.synchronize()
    nan = torch.isnan(ref)
    spacing = torch.nextafter(ref.abs(), torch.full_like(ref, math.inf)) - ref.abs()
    err = torch.where(nan, 0.0, (got - ref).abs())
    again = iou3d.pairwise_overlap_bev(a, b)
    if not (bool(((err <= 2 * spacing) | nan).all()) and torch.equal(torch.isnan(got), nan)
            and torch.equal(got.view(torch.int32), again.view(torch.int32))):
        raise AssertionError(f"B4a at {what}: off its plain version by {err.max().item()} "
                             f"(over 2 ulp), NaN elsewhere, or two launches differ")
    operands = iou3d.overlap_operands(a) + iou3d.overlap_operands(b)
    nbytes = (a.shape[0] * (a.shape[1] + b.shape[1]) * 7 + got.numel()) * 4
    pair_ops, rejected = b4_pair_ops(a, b, ops)
    rejected = float(rejected.float().mean()) if rejected.numel() else 0.0
    row = b4_timed("B4a", lambda: iou3d.overlap_launch(*operands),
                   lambda: iou3d.pairwise_overlap_bev(a, b),
                   lambda: iou3d.pairwise_overlap_bev_reference(a, b), nbytes,
                   float(pair_ops.sum()), f"{what} ({tuple(a.shape)} x {tuple(b.shape)}, "
                   f"{rejected:.4f} of the pairs rejected)", clip_all_ops=float(ops.sum()))
    row.update(max_abs_err=err.max().item(), pairs=got.numel(), nan_pairs=int(nan.sum()),
               equal_bits=bool(torch.equal(got.view(torch.int32), ref.view(torch.int32))),
               rejected=rejected)
    return row, ops


def b4_nms_exact(boxes, valid, thresh, use_bev_iou, fast, what):
    """B4b's words and B4c's keep set on one call's sorted operands, each
    equal to its plain version's; returns both."""
    words = nms.nms_mask_bev(boxes, valid, thresh, use_bev_iou)
    ref = nms.nms_mask_bev_reference(boxes, valid, thresh, use_bev_iou)
    keep = nms.nms_suppress(words, valid, fast)
    torch.cuda.synchronize()
    if not torch.equal(words, ref):
        bad = (words != ref).nonzero()[0].tolist()
        raise AssertionError(f"B4b at {what}: words differ from the plain version, first at "
                             f"(sample, row, word) {bad}")
    if not torch.equal(keep, nms.nms_suppress_reference(words, valid, fast)):
        raise AssertionError(f"B4c at {what}: keep differs from the plain version")
    return words, keep


def b4_suppresses(words, valid, keep):
    """Whether an NMS call set a bit and suppressed a valid row: only then
    can its exact comparison tell a B4b that writes zeros, or a B4c that
    keeps every valid row, from a right one."""
    return bool(words.ne(0).any()) and bool((valid & ~keep).any())


def b4_overlapping(boxes):
    """``boxes`` (B, K, 7) with each odd row a copy of the row before it,
    moved along its heading by a twentieth of its length: BEV and 3D IoU
    0.95 / 1.05 = 0.905 for each pair (2m, 2m + 1)."""
    out, pairs = boxes.clone(), boxes.shape[1] // 2
    src = boxes[:, 0:2 * pairs:2]
    step = 0.05 * src[..., 3]
    out[:, 1::2] = src
    out[:, 1::2, 0] += step * torch.cos(src[..., 6])
    out[:, 1::2, 1] += step * torch.sin(src[..., 6])
    return out.contiguous()


def b4_suppress_bytes(words, valid, keep, fast):
    """The bytes B4c must move on this call's data: ``valid`` read and
    ``keep`` written once, and of the words only those the sweep needs
    (none left of the diagonal holds a bit). Fast: each valid row's words
    from its diagonal word on, since a suppressed row still suppresses.
    Greedy: the same words of each kept row only; a row's removal is known
    from the rows above it before its words are read."""
    bsz, k, n_words = words.shape
    from_diag = n_words - torch.arange(k, device=words.device) // 64
    rows = valid if fast else keep
    return int((rows * from_diag).sum()) * 8 + 2 * bsz * k


def b4_nms_check(boxes, valid, thresh, use_bev_iou, fast, what):
    """B4b and B4c against their plain versions on one call's sorted
    operands: words and keep sets equal; timed. B4a on the same pairs.
    Returns the rows and whether the call suppressed (``b4_suppresses``)."""
    words, keep = b4_nms_exact(boxes, valid, thresh, use_bev_iou, fast, what)
    bsz, k = valid.shape
    corners, b7 = iou3d.overlap_operands(boxes)
    ok = valid.to(torch.uint8).contiguous()
    overlap_row, ops = b4_overlap_check(boxes, boxes, what)
    # the pairs B4b needs: j > i, both valid; on each the reject, and the clip
    # where the reject lets the pair through, then the IoU and its test (6)
    n_valid = valid.sum(1)
    upper = torch.triu(torch.ones((k, k), dtype=torch.bool, device=boxes.device), 1)
    needed = upper & valid[:, :, None] & valid[:, None, :]
    pair_ops, rejected = b4_pair_ops(boxes, boxes, ops)
    n_needed = int(needed.sum())
    mask_ops = float(pair_ops[needed].sum()) + 6.0 * n_needed
    share = int(rejected[needed].sum()) / max(n_needed, 1)
    rows = [b4_timed("B4b", lambda: nms.mask_launch(corners, b7, ok, thresh, use_bev_iou),
                     lambda: nms.nms_mask_bev(boxes, valid, thresh, use_bev_iou),
                     lambda: nms.nms_mask_bev_reference(boxes, valid, thresh, use_bev_iou),
                     bsz * k * 7 * 4 + bsz * k + words.numel() * 8, mask_ops,
                     f"{what} ({share:.4f} of the needed pairs rejected)",
                     clip_all_ops=float(ops[needed].sum()) + 6.0 * n_needed),
            b4_timed("B4c", lambda: nms.suppress_launch(words, ok, fast),
                     lambda: nms.nms_suppress(words, valid, fast),
                     lambda: nms.nms_suppress_reference(words, valid, fast),
                     b4_suppress_bytes(words, valid, keep, fast), 0.0,
                     f"{what} ({'fast' if fast else 'greedy'})")]
    for row in rows:
        row.update(max_abs_err=0.0, pairs=int(needed.sum()))
    print(f"B4b/B4c at {what}: B={bsz} K={k}, valid rows {n_valid.tolist()}, "
          f"{int(needed.sum())} pairs needed, {int(words.ne(0).sum())} nonzero words, kept "
          f"{keep.sum(1).tolist()}; words and keep sets equal to the plain versions", flush=True)
    return rows + [dict(overlap_row, on_nms_pairs=True)], b4_suppresses(words, valid, keep)


def nms_phase(card):
    """Phase 22: kernels B4a-c against their plain versions on every operand
    set recorded on the paths: each rotated NMS call's sorted operands (B4b
    words and B4c keep sets exactly; B4a on the same pairs within 2 ulp) and
    each recorded BEV overlap (B4a), timed. Returns the kernels-line entries
    of B4a-c: launches of its main path's counted run (``B4_MAIN_PATHS``),
    times and bounds summed over that path's recorded calls.
    Each operand set with NMS calls must have one that suppressed
    (``b4_suppresses``); where the seeded model's calls did not, its first
    call's operands with overlapping copies (``b4_overlapping``) at the same
    B and K must, with words and keep sets exact."""
    t0 = time.perf_counter()
    b4_resources()
    rows = {}
    for name, calls in B4_RECORDS.items():
        suppressed, first = False, None
        for call in calls:
            if call[0] == "overlap":
                rows.setdefault(name, []).append(b4_overlap_check(call[1][None], call[2][None],
                                                                  name)[0])
                continue
            boxes, scores, valid, kw = call[1:]
            top_boxes, top_valid = b4_sorted_operands(boxes, scores, valid, **kw)
            first = first or (top_boxes, top_valid, kw)
            got, hit = b4_nms_check(top_boxes, top_valid, kw["thresh"], kw["use_bev_iou"],
                                    kw["fast"], name)
            rows.setdefault(name, []).extend(got)
            suppressed |= hit
        if first is None or suppressed:
            continue
        top_boxes, top_valid, kw = first
        what = f"{name}, overlapping copies"
        words, keep = b4_nms_exact(b4_overlapping(top_boxes), top_valid, kw["thresh"],
                                   kw["use_bev_iou"], kw["fast"], what)
        if not b4_suppresses(words, top_valid, keep):
            raise AssertionError(f"B4b/B4c at {what}: no bit set or no valid row suppressed")
        print(f"B4b/B4c at {what}: B={top_valid.shape[0]} K={top_valid.shape[1]}, "
              f"{int(words.ne(0).sum())} nonzero words, kept {keep.sum(1).tolist()} of "
              f"{top_valid.sum(1).tolist()}; words and keep sets equal to the plain versions",
              flush=True)
    kernels = []
    for idx, (name, tag, replaces) in enumerate(B4_KERNELS):
        path = B4_MAIN_PATHS[tag]
        # B4a's launches on a path are its BEV overlaps, not the NMS pairs it is checked on
        mine = [r for n, rs in rows.items() if n.startswith(path) for r in rs
                if r["kernel"] == tag and not r.get("on_nms_pairs")]
        if not mine:
            raise AssertionError(f"{tag}: no recorded call on {path}: {sorted(rows)}")
        everywhere = [r for rs in rows.values() for r in rs if r["kernel"] == tag]
        kernels.append({
            "name": name, "path": path, "route": "cuda", "source": B4_SRC, "replaces": replaces,
            "launches": B4_PATHS[path][idx],
            "max_abs_err": max(r["max_abs_err"] for r in everywhere),
            "ms": sum(r["ms"] for r in mine), "wrapper_ms": sum(r["wrapper_ms"] for r in mine),
            "plain_ms": sum(r["plain_ms"] for r in mine),
            "bound_ms": sum(r["bound_ms"] for r in mine),
            "bound_by": max(("bytes", "operations"), key=lambda by: sum(
                r["bound_ms"] for r in mine if r["bound_by"] == by)),
            "library_ms": None,
            "launches_by_path": {p: n[idx] for p, n in B4_PATHS.items()}})
    print(f"B4 phase: {sum(len(r) for r in rows.values())} checks over {len(rows)} operand "
          f"sets in {time.perf_counter() - t0:.1f} s ({card})", flush=True)
    return kernels


def nms_paths(dev, card):
    """``--nms``: the paths that run B4, each counted and recorded: the
    flagship predict (dense tail, batch 1, its stage ms), the DBSCAN yaml's
    predict (frames/s, the ``iou_nms`` stage and its memory) and the
    training forward and loss of a batch-2 step (4096 proposals a sample,
    the RoI head's target IoU), PointPillars' predict, phase 19's NMS calls;
    then phase 22."""
    pts, valid = make_lidar_frame(np.random.default_rng(0), N_POINTS)
    batch = {"points": torch.from_numpy(pts)[None].to(dev),
             "points_valid": torch.from_numpy(valid)[None].to(dev)}
    model = seeded_model(dict(BENCH, dense_tail=True), 0, dev)
    predict_phase(model, batch, "dense tail", TIMED_LOOPS)
    del model
    _, model = yaml_model(DBSCAN_YAML, [], 0, dev)
    anchor_predict_phase(model, batch, "DBSCAN VoxelRCNN", card, ANCHOR_A1_FORWARD)
    train_batch = to_device(make_train_batch(0, TRAIN_BATCH, N_POINTS), dev)
    props = anchor_proposals_of(model, train_batch)
    labelled, _ = labels_on_proposals(model, train_batch, 40, props=props)
    model.train()
    with recording_b4(f"DBSCAN VoxelRCNN step, batch {TRAIN_BATCH}"):
        b4_counted("DBSCAN VoxelRCNN step", lambda: model.loss_step(labelled), B4_ALL)
    del model, train_batch, labelled
    torch.cuda.empty_cache()
    _, model = yaml_model(PILLAR_YAML, PILLAR_SETS, 0, dev)
    anchor_predict_phase(model, batch, "PointPillars", card, 0)
    del model
    torch.cuda.empty_cache()
    ops_nms(dev, card)
    return nms_phase(card)


RB_SRC = "cpd_tpu_torch/csrc/rulebook.cu"
RB_KERNELS = (("stage_table", "B1a", "cpd_tpu/ops/sparse.py:180"),
              ("lookup_taps", "B1b", "cpd_tpu/ops/sparse.py:246"),
              ("downsample", "B2", "cpd_tpu/ops/sparse.py:484"))
RB_MAIN_PATH = "predict, dense tail"
TRAIN_PATH = f"train step, batch {TRAIN_BATCH}"
# (B1a, B1b, B2) calls of one counted run: a table for each branch, a lookup
# a book (not the flipped submanifold transposes), an output set a strided
# conv; the train step's light branch has no conv_out
RB_WANT = {"predict, dense tail": (1, 5, 2), "predict, sparse tail": (1, 8, 4),
           TRAIN_PATH: (2, 12 + 10, 4 + 3)}
RB_TIMED_REPS = 5
RB_PATH_LOOPS = 5


def _stage_tables():
    """``cpd_tpu_torch.ops.rulebook``, imported at first use: ``--path-times``
    also runs in a tree without kernels B1a-B2 (the parent, in turns)."""
    from cpd_tpu_torch.ops import rulebook
    return rulebook


def rb_counts():
    st = _stage_tables()
    return st.stage_table.launches, st.lookup_taps.launches, st.downsample.launches


class TableRecorder:
    """Stands in for ``backbone3d.stage_tables`` and its
    ``build_branch_rulebooks`` while active: passes every call on, and keeps
    each branch call's arguments and books and the operands of each B1a,
    B1b and B2 call inside it (the tensors themselves: the builders write
    none of their inputs)."""

    def __init__(self):
        self.branches, self.calls = [], {"B1a": [], "B1b": [], "B2": []}

    def __enter__(self):
        self.module, self.branch = backbone3d.stage_tables, backbone3d.build_branch_rulebooks

        def branch_call(keys, grid, caps, *args, **kwargs):
            books = self.branch(keys, grid, caps, *args, **kwargs)
            self.branches.append((keys, grid, caps, args, kwargs, books))
            return books

        backbone3d.stage_tables, backbone3d.build_branch_rulebooks = self, branch_call
        return self

    def __exit__(self, *exc):
        backbone3d.stage_tables, backbone3d.build_branch_rulebooks = self.module, self.branch

    def stage_table(self, keys, grid):
        self.calls["B1a"].append((keys, grid))
        return self.module.stage_table(keys, grid)

    def subm_rulebook(self, keys, table, kernel=(3, 3, 3)):
        self.calls["B1b"].append((keys, table.grid, table, self.module.SUBM, kernel))
        return self.module.subm_rulebook(keys, table, kernel)

    def conv_rulebook(self, table, kernel, stride, padding, out_cap):
        book, out_table = self.module.conv_rulebook(table, kernel, stride, padding, out_cap)
        self.calls["B2"].append((table, kernel, stride, padding, out_cap))
        self.calls["B1b"].append((book.out_keys, out_table.grid, table, self.module.STRIDED,
                                  kernel, stride, padding))
        return book, out_table

    def inverse_rulebook(self, in_keys, in_grid, out_table, kernel, stride, padding):
        self.calls["B1b"].append((in_keys, in_grid, out_table, self.module.INVERSE, kernel,
                                  stride, padding))
        return self.module.inverse_rulebook(in_keys, in_grid, out_table, kernel, stride, padding)


def rb_resources():
    """What ptxas reports for B1a's, B1b's and B2's four kernels (registers,
    stack frame, spills); raises where one has a stack frame or spills (B2's
    dilation keeps no array) or is missing."""
    rows = cuda_build.kernel_resources("rulebook")
    if not rows:
        print("B1 ptxas: the build was reused, no report in this process", flush=True)
        return
    for kernel, regs, spilled, smem, stack in rows:
        print(f"B1 ptxas {kernel}: {regs} registers a thread, {stack} bytes of stack frame, "
              f"{spilled} bytes spilled, {smem} bytes of static shared memory", flush=True)
    if len(rows) != 4 or any(r[2] or r[4] for r in rows):
        raise AssertionError(f"B1a-B2: a stack frame or spills, or a kernel missing: {rows}")


def rb_counted(path, fn, records):
    """``fn()`` with B1a's, B1b's and B2's counts set to 0 just before and
    read just after, its operands recorded under ``path``; raises unless the
    counts are ``RB_WANT[path]``."""
    st = _stage_tables()
    st.stage_table.launches = st.lookup_taps.launches = st.downsample.launches = 0
    with TableRecorder() as rec:
        out = fn()
    torch.cuda.synchronize()
    got = rb_counts()
    records[path] = (got, rec)
    print(f"B1 launches, {path}: (B1a, B1b, B2) = {got}", flush=True)
    if got != RB_WANT[path]:
        raise AssertionError(f"{path}: (B1a, B1b, B2) launched {got}, want {RB_WANT[path]}")
    return out


def rb_same_book(got, want, what):
    """Two rulebooks equal: found, idx where found, out_keys, out_valid."""
    for field in ("found", "out_keys", "out_valid"):
        if not torch.equal(getattr(got, field).cpu(), getattr(want, field).cpu()):
            raise AssertionError(f"{what}: {field} differs from the plain twin")
    found = got.found.cpu()
    if not torch.equal(got.idx.cpu()[found], want.idx.cpu()[found]):
        raise AssertionError(f"{what}: idx differs from the plain twin where found")


def rb_books_against_twins(path, rec):
    """Every book of the path's branch calls against the plain twins of
    ``ops/sparse.py`` (run on the CPU on copies of the same keys)."""
    n = 0
    for i, (keys, grid, caps, args, kwargs, books) in enumerate(rec.branches):
        twins = backbone3d.build_branch_rulebooks(keys.cpu(), grid, caps, *args, **kwargs)
        if set(twins) != set(books):
            raise AssertionError(f"{path}: books {sorted(books)} against {sorted(twins)}")
        for name in twins:
            rb_same_book(books[name], twins[name], f"{path}, branch call {i}, {name}")
        n += len(twins)
    print(f"B1 books, {path}: {n} books of {len(rec.branches)} branch calls (keys "
          f"{[tuple(b[0].shape) for b in rec.branches]}) equal to the plain twins", flush=True)


def rb_sync_guard(path, rec):
    """The path's branch calls once more under
    ``torch.cuda.set_sync_debug_mode("error")``: raises on a host sync."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for keys, grid, caps, args, kwargs, _ in rec.branches:
            backbone3d.build_branch_rulebooks(keys, grid, caps, *args, **kwargs)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    print(f"B1 sync guard, {path}: {len(rec.branches)} branch calls without a host sync",
          flush=True)


def rb_nbytes(tag, args, out):
    """The bytes a call needs to move: inputs read once, outputs written
    once. B1b reads the table words (and their prefixes) that its taps
    touch, not the whole table; B2 reads every input word (each lies in some
    output word's field) and no prefix."""
    st = _stage_tables()
    size = lambda t: t.numel() * t.element_size()  # noqa: E731
    if tag == "B1a":
        return size(args[0]) + size(out.words) + size(out.prefix)
    if tag == "B2":
        table, words = args[0], out[0]
        return size(table.words) + size(words.words) + size(words.prefix) + size(out[1]) + \
            size(out[2])
    rows, row_grid, table, mode, *geom = args
    w, _, ok, _ = st.tap_words(rows, row_grid, table.grid, mode, *geom)
    n_words = int(torch.unique(w[ok] + torch.arange(w.shape[0], device=w.device).view(
        -1, 1, 1).expand_as(w)[ok] * table.words.shape[1]).numel())
    return size(rows) + 8 * n_words + sum(size(t) for t in out)


def rb_check(tag, args):
    """One recorded call: the kernel's result against its plain version on
    the same operands (equal) -> (the result, the largest absolute
    difference of any output element, as integers)."""
    st = _stage_tables()
    name = {t: n for n, t, _ in RB_KERNELS}[tag]
    out = getattr(st, name)(*args)
    ref = getattr(st, f"{name}_reference")(*args)
    torch.cuda.synchronize()
    pairs = ([(out.words, ref.words), (out.prefix, ref.prefix)] if tag == "B1a" else
             list(zip(out, ref)) if tag == "B1b" else
             [(out[0].words, ref[0].words), (out[0].prefix, ref[0].prefix), (out[1], ref[1]),
              (out[2], ref[2])])
    err = max((float((a.long() - b.long()).abs().max()) for a, b in pairs if a.numel()),
              default=0.0)
    if err or not all(torch.equal(a, b) for a, b in pairs):
        raise AssertionError(f"{tag}: differs from its plain version by {err} at {args[1:]}")
    return out, err


def rb_timed(tag, args, out):
    """Median device ms of the wrapper's launches (a spin ahead of each
    reading), its host ms a call, the plain version's ms, and the bound."""
    st = _stage_tables()
    name = {t: n for n, t, _ in RB_KERNELS}[tag]
    fn, plain = getattr(st, name), getattr(st, f"{name}_reference")
    ms, plain_ms = paired_median_ms(lambda: fn(*args), lambda: plain(*args), reps=RB_TIMED_REPS)
    wrapper_ms = wrapper_host_us(lambda: fn(*args), calls=50) / 1e3
    nbytes = rb_nbytes(tag, args, out)
    return dict(ms=ms, wrapper_ms=wrapper_ms, plain_ms=plain_ms, nbytes=nbytes,
                bound_ms=nbytes / HBM_BYTES_PER_S * 1e3)


def rb_describe(tag, args):
    if tag == "B1a":
        return f"keys {tuple(args[0].shape)} on {tuple(args[1])}"
    if tag == "B2":
        return f"{tuple(args[0].grid)} k{args[1]} s{args[2]} p{args[3]} cap {args[4]}"
    mode = ("subm", "strided", "inverse")[args[3]]
    return f"{mode} rows {tuple(args[0].shape)} on {tuple(args[1])}, table {tuple(args[2].grid)}"


def rulebook_phase(dev, card, batch, dense_model, sparse_model):
    """Phase 23: kernels B1a, B1b and B2 on the paths that build rulebooks:
    the predicts of both tails (batch 1) and a training step (``mm=True``,
    batch 2: both branches, the transposes). Each path's run is counted
    (``RB_WANT``) and recorded; then every book of it against the plain
    twins, the branch calls again under the sync guard, each kernel call
    against its plain version, and the main path's calls timed. Returns the
    kernels-line entries of B1a, B1b and B2."""
    t0 = time.perf_counter()
    rb_resources()
    records = {}
    with torch.no_grad():
        for path, model in ((RB_MAIN_PATH, dense_model), ("predict, sparse tail", sparse_model)):
            model.predict(batch)  # warm-up
            rb_counted(path, lambda: model.predict(batch), records)
    model = VoxelRCNN(**dict(BENCH, mm=True))
    model.load_state_dict(seeded_state_dict(model, 0), strict=True)
    state = init_state(model, OPT_CFG, total_steps=100, device=dev)
    train_batch = to_device(make_train_batch(0, TRAIN_BATCH, N_POINTS), dev)
    generator = torch.Generator(device=dev).manual_seed(0)
    train_step = make_train_step()
    state, _ = train_step(state, train_batch, generator)  # warm-up
    rb_counted(TRAIN_PATH, lambda: train_step(state, train_batch, generator), records)
    del state, model, train_batch
    for path, (_, rec) in records.items():
        rb_books_against_twins(path, rec)
        rb_sync_guard(path, rec)
    rows = {tag: [] for _, tag, _ in RB_KERNELS}
    errs = {tag: 0.0 for _, tag, _ in RB_KERNELS}
    for path, (_, rec) in records.items():
        for tag, calls in rec.calls.items():
            for args in calls:
                out, err = rb_check(tag, args)
                errs[tag] = max(errs[tag], err)
                if path == RB_MAIN_PATH:
                    row = rb_timed(tag, args, out)
                    rows[tag].append(row)
                    print(f"{tag} at {rb_describe(tag, args)}: launch {row['ms']:.4f} ms "
                          f"(median of {RB_TIMED_REPS}, device), wrapper {row['wrapper_ms']:.4f} "
                          f"ms of host a call, plain {row['plain_ms']:.4f} ms; bound "
                          f"{row['bound_ms']:.5f} ms by bytes ({row['nbytes'] / 1e6:.3f} MB)",
                          flush=True)
        print(f"B1 kernels, {path}: {sum(map(len, rec.calls.values()))} calls equal to their "
              f"plain versions", flush=True)
    kernels = []
    for i, (name, tag, replaces) in enumerate(RB_KERNELS):
        mine = rows[tag]
        kernels.append({
            "name": name, "path": RB_MAIN_PATH, "route": "cuda", "source": RB_SRC,
            "replaces": replaces, "launches": records[RB_MAIN_PATH][0][i], "max_abs_err": errs[tag],
            "ms": sum(r["ms"] for r in mine), "wrapper_ms": sum(r["wrapper_ms"] for r in mine),
            "plain_ms": sum(r["plain_ms"] for r in mine),
            "bound_ms": sum(r["bound_ms"] for r in mine), "bound_by": "bytes",
            "library_ms": None, "launches_by_path": {p: r[0][i] for p, r in records.items()}})
        print(f"{tag} ({name}) over the main path's {len(mine)} calls: launch "
              f"{kernels[-1]['ms']:.4f} ms, wrapper {kernels[-1]['wrapper_ms']:.4f} ms, plain "
              f"{kernels[-1]['plain_ms']:.4f} ms, bound {kernels[-1]['bound_ms']:.5f} ms ({card})",
              flush=True)
    print(f"B1 phase: {time.perf_counter() - t0:.1f} s ({card})", flush=True)
    return kernels


def path_times(dev, card):
    """``--path-times``: the predict of each tail (batch 1; frames/s over
    ``RB_PATH_LOOPS`` loops, the stage ms of ``stage_breakdown``, medians of
    5, device busy ms and idle share) and the training step (batch 2,
    ``mm=True``; ms over ``RB_PATH_LOOPS`` steps, busy ms). It needs nothing
    of kernels B1a-B2, so it runs in the parent tree too."""
    pts, valid = make_lidar_frame(np.random.default_rng(0), N_POINTS)
    batch = {"points": torch.from_numpy(pts)[None].to(dev),
             "points_valid": torch.from_numpy(valid)[None].to(dev)}
    for dense in (True, False):
        what = f"predict, {'dense' if dense else 'sparse'} tail"
        model = seeded_model(dict(BENCH, dense_tail=dense), 0, dev)
        with torch.no_grad():
            for _ in range(2):
                model.predict(batch)
            torch.cuda.synchronize()
            ms = []
            for _ in range(RB_PATH_LOOPS):
                t0 = time.perf_counter()
                model.predict(batch)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
            stages = [stage_breakdown(model, batch) for _ in range(5)]
            busy, idle = device_profile(lambda: model.predict(batch), what,
                                        statistics.median(ms))
        books = sorted(s["rulebooks"] for s in stages)
        print(f"path times, {what}: {statistics.median(ms):.2f} ms a frame (min {min(ms):.2f}, "
              f"max {max(ms):.2f}, {RB_PATH_LOOPS} loops); rulebooks stage "
              f"{statistics.median(books):.2f} ms (min {books[0]:.2f}, max {books[-1]:.2f}; "
              f"stage medians: " + ", ".join(f"{k} {statistics.median(s[k] for s in stages):.2f}"
                                             for k in stages[0])
              + f"); busy {busy:.2f} ms, idle share {idle:.3f} ({card})", flush=True)
        del model
    model = VoxelRCNN(**dict(BENCH, mm=True))
    model.load_state_dict(seeded_state_dict(model, 0), strict=True)
    state = init_state(model, OPT_CFG, total_steps=100, device=dev)
    train_batch = to_device(make_train_batch(0, TRAIN_BATCH, N_POINTS), dev)
    generator = torch.Generator(device=dev).manual_seed(0)
    train_step = make_train_step()
    for _ in range(2):
        state, _ = train_step(state, train_batch, generator)
    torch.cuda.synchronize()
    ms = []
    for _ in range(RB_PATH_LOOPS):
        t0 = time.perf_counter()
        state, _ = train_step(state, train_batch, generator)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    busy, idle = device_profile(lambda: train_step(state, train_batch, generator), "train step",
                                statistics.median(ms), loops=1)
    print(f"path times, {TRAIN_PATH}: {statistics.median(ms):.2f} ms a step (min {min(ms):.2f}, "
          f"max {max(ms):.2f}, {RB_PATH_LOOPS} steps); busy {busy:.2f} ms, idle share "
          f"{idle:.3f} ({card})", flush=True)


def rulebook_paths(dev, card):
    """``--rulebooks``: phase 23 on its own models, then ``path_times``."""
    pts, valid = make_lidar_frame(np.random.default_rng(0), N_POINTS)
    batch = {"points": torch.from_numpy(pts)[None].to(dev),
             "points_valid": torch.from_numpy(valid)[None].to(dev)}
    dense_model = seeded_model(dict(BENCH, dense_tail=True), 0, dev)
    sparse_model = seeded_model(BENCH, 0, dev)
    kernels = rulebook_phase(dev, card, batch, dense_model, sparse_model)
    del dense_model, sparse_model
    torch.cuda.empty_cache()
    path_times(dev, card)
    return kernels


def main():
    parser = argparse.ArgumentParser(description="Smoke run of the PyTorch port on one card.")
    parser.add_argument("--determinism", type=int, metavar="RUNS",
                        help="run only phase 13 (after the build), with RUNS runs of the step "
                             "under the scope (at least 2)")
    parser.add_argument("--no-cudnn", action="store_true",
                        help="with --determinism: the scope turns cuDNN off instead")
    parser.add_argument("--registry", action="store_true",
                        help="run only phase 18 (after the build) and print its kernels line")
    parser.add_argument("--ops", action="store_true",
                        help="run only phase 19, the toolbox modules (after the build)")
    parser.add_argument("--nms", action="store_true",
                        help="run only the paths that launch kernels B4a-c (counted and timed) "
                             "and phase 22, after the build, and print their kernels line")
    parser.add_argument("--factory", action="store_true",
                        help="run only phase 15, the pseudo-label factory (after the build), "
                             "and print its kernels line")
    parser.add_argument("--parity", action="store_true",
                        help="run only phases 20 (bench-scale parity against the committed JAX "
                             "reference) and 21 (dense-tail training), after the build")
    parser.add_argument("--rulebooks", action="store_true",
                        help="run only phase 23 (kernels B1a, B1b and B2 on the paths that "
                             "build rulebooks) and the path times, after the build, and print "
                             "their kernels line")
    parser.add_argument("--path-times", action="store_true",
                        help="run only the path times (both predicts' stage ms, busy ms and "
                             "idle share, the train step's ms and busy ms), after the build")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA card; none is available")
    card = card_line()
    print(f"card: {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_start = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        native_build = pool.submit(timed_native_build)
        secs = cuda_build.build(verbose=True)
        native_path, native_s = native_build.result()
    print(f"kernel build: {secs:.1f} s compiling {len(cuda_build.SOURCES)} sources (one nvcc "
          f"process each, side by side)", flush=True)
    print(f"native host library: {native_path.name} built in {native_s:.1f} s beside them "
          f"(g++ {' '.join(native.CXX_FLAGS)}, {native.SOURCE.name})", flush=True)
    dev = torch.device("cuda")
    if args.determinism:
        step_determinism(dev, max(args.determinism, 2), cudnn=not args.no_cudnn)
        print(f"total {time.perf_counter() - t_start:.1f} s")
        return
    if args.registry:
        print(json.dumps({"kernels": registry_phase(dev, card)}))
        print(f"total {time.perf_counter() - t_start:.1f} s")
        return
    if args.ops:
        ops_phase(dev, card)
        print(f"total {time.perf_counter() - t_start:.1f} s")
        return
    if args.nms:
        print(json.dumps({"kernels": nms_paths(dev, card)}))
        print(f"total {time.perf_counter() - t_start:.1f} s")
        return
    if args.factory:
        print(json.dumps({"kernels": factory_phase(dev, card)}))
        print(f"total {time.perf_counter() - t_start:.1f} s")
        return
    if args.parity:
        parity_phase(dev, card)
        print(json.dumps({"kernels": dense_training_phase(dev, card)}))
        print(f"total {time.perf_counter() - t_start:.1f} s")
        return
    if args.rulebooks:
        print(json.dumps({"kernels": rulebook_paths(dev, card)}))
        print(f"total {time.perf_counter() - t_start:.1f} s")
        return
    if args.path_times:
        path_times(dev, card)
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
    kernels += rulebook_phase(dev, card, batch, dense_model, sparse_model)
    del sparse_model, dense_model, batch
    torch.cuda.empty_cache()

    small_input_check()
    parity_phase(dev, card)
    print(f"predict phases done at {time.perf_counter() - t_start:.1f} s", flush=True)
    kernels.append(eval_cli_phase(dev, card))
    torch.cuda.empty_cache()
    kernels += train_cli_phase(dev, card)
    torch.cuda.empty_cache()
    kernels += anchor_phase(dev, card)
    torch.cuda.empty_cache()
    kernels += factory_phase(dev, card)
    torch.cuda.empty_cache()
    kernels += kitti_phase(dev, card)
    torch.cuda.empty_cache()
    kernels += data_parallel_phase(dev, card)
    torch.cuda.empty_cache()
    kernels += registry_phase(dev, card)
    torch.cuda.empty_cache()
    ops_phase(dev, card)
    torch.cuda.empty_cache()
    kernels += nms_phase(card)
    B4_RECORDS.clear()
    torch.cuda.empty_cache()

    kernels += training_phase(dev)
    kernels += dense_training_phase(dev, card)
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
    if sys.argv[1:2] == [DP_RANK_CHECKS]:
        dp_rank_checks(sys.argv[2], sys.argv[3:])
    else:
        main()
