"""The port's f32 predict at the bench configuration against the JAX package's.

``bench.py``'s model (``bench.py:67-78``: range +-75.2 x [-2, 4] m, voxels
0.1 x 0.1 x 0.15 m, 90k voxels, stage caps 80k / 48k / 24k / 20k, 200 test
RoIs, MM off, the dense backbone tail) on its frame,
``make_lidar_frame(default_rng(0), 200_000)``.

**The weights** (``reference_weights``, the one place of the recipe):
``seeded_state_dict(model, 0)``, the heads' output layers scaled by 0.05,
then every norm's running statistics set from one f32 forward on the frame
with only the norms in training mode, at momentum 1 (no dropout, no RoI
sampling). As seeded, the heatmap saturates to 1.0 in f32 and proposal sizes
reach 1e20 m, so ties decide the top-k and no tier holds anything; with the
recipe the scores lie near 0.2 and the sizes under a few metres.

**The reference** (``tests/torch_port_refs/bench_predict.npz``): the tensors
that differ from the seeded ones, and the jitted JAX predict in f32 (under
``jax_f32``, its NMS on the clip-method IoU, ``jax_nms_with_clip_iou``) with
the weights through ``jax_variables_from_state_dict``: per stage the valid
count, the keys and a seeded sample of feature rows; the heatmap whole and
a sample of the other head maps' cells; the 200 RoIs; the detections. The
``slow`` test recomputes it from live JAX (dense tail) and holds the sparse
tail's keys equal to the dense tail's.

**Tier-1** runs the port's CPU predict (dense tail, f32) once and holds it to
the reference with ``cpd_tpu_torch.utils.parity``'s tiers: keys exact at
every stage; features, head maps and RoIs within 1e-4 of scale, RoI labels
exact (RoIs paired by box: the f32 scores of two proposals can tie within
rounding, and the port and JAX may then sort them in either order);
detections equal in count, paired by box, labels exact, every pair
within 1e-4 of scale, scores within 1e-3. It also round-trips the weight
bridge (``state_dict_from_jax`` then ``jax_variables_from_state_dict``) bit
for bit on ``_TINY`` and on the bench model's tree.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpd_tpu.models.detector import VoxelRCNN as JVoxelRCNN
from cpd_tpu_torch.models.detector import VoxelRCNN, set_compute_dtype
from cpd_tpu_torch.models.norm import _RunningNorm
from cpd_tpu_torch.utils import parity
from cpd_tpu_torch.utils.synthetic import make_lidar_frame
from cpd_tpu_torch.utils.weights import (jax_variables_from_state_dict, seeded_state_dict,
                                         state_dict_from_jax)
from tests import torch_port_refs as refs
from tests.test_torch_port_build_network import jax_f32
from tests.test_torch_port_models import jax_nms_with_clip_iou, seeded_jax_variables
from tests.torch_port_refs import one_torch_thread  # noqa: F401

REF = "bench_predict"
BENCH = dict(num_classes=3, point_cloud_range=(-75.2, -75.2, -2.0, 75.2, 75.2, 4.0),
             voxel_size=(0.1, 0.1, 0.15), max_voxels=90_000,
             backbone_caps=(80_000, 48_000, 24_000, 20_000), mm=False, num_rois=500,
             num_rois_test=200, roi_per_image=130)
N_POINTS = 200_000
WEIGHT_SEED = FRAME_SEED = 0
OUTPUT_LAYERS = tuple(f"dense_head.head_{n}.out" for n in ("hm", "center", "center_z", "dim",
                                                            "rot")) + (
    "roi_head.cls_tower0.out", "roi_head.reg_tower0.out")
OUTPUT_SCALE = 0.05
ROW_SAMPLES = 256  # feature rows a stage
CELL_SAMPLES = 2048  # cells of each head map but the heatmap
SAMPLE_SEED = 0


def bench_batch():
    pts, valid = make_lidar_frame(np.random.default_rng(FRAME_SEED), N_POINTS)
    return pts[None], valid[None]


def port_model(dense_tail=True):
    return VoxelRCNN(**BENCH, dense_tail=dense_tail)


def reference_weights():
    """{state-dict key: array} of every tensor that the recipe changes."""
    model = port_model()
    seeded = seeded_state_dict(model, WEIGHT_SEED)
    sd = {k: v.clone() for k, v in seeded.items()}
    for layer in OUTPUT_LAYERS:
        sd[layer + ".weight"] *= OUTPUT_SCALE
    model.load_state_dict(sd, strict=True)
    set_compute_dtype(model.eval(), None)
    for m in model.modules():
        if isinstance(m, _RunningNorm):
            m.momentum = 1.0
            m.train()
    pts, valid = bench_batch()
    with torch.no_grad():
        model({"points": torch.from_numpy(pts), "points_valid": torch.from_numpy(valid)})
    return {k: v.numpy().copy() for k, v in model.state_dict().items()
            if not torch.equal(v, seeded[k])}


def jax_record(weights, dense_tail):
    """``parity.record`` of the jitted JAX f32 predict with the recipe's weights."""
    pm = port_model(dense_tail)
    sd = parity.reference_state_dict(pm, {"meta": {"weight_seed": WEIGHT_SEED},
                                          "weights": weights})
    pts, valid = bench_batch()
    batch = {"points": jnp.asarray(pts), "points_valid": jnp.asarray(valid)}
    with jax_f32(), jax_nms_with_clip_iou():
        jm = JVoxelRCNN(**BENCH, dense_tail=dense_tail)
        like = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), batch, False))
        jv = jax.tree_util.tree_map(jnp.asarray, jax_variables_from_state_dict(sd, pm, like))

        def forward(v, b):
            out = jm.apply(v, b, False)
            keep = {k: out[k] for k in parity.ROI_KEYS + ("batch_box_preds", "batch_cls_preds")}
            keep["backbone_out"] = {k: out["backbone_out"][k][:2] for k in parity.STAGES}
            keep["head_preds"] = {k: out["head_preds"][k] for k in parity.HEAD_MAPS}
            return keep

        out = jax.jit(forward)(jv, batch)
        post = ("batch_box_preds", "batch_cls_preds", "roi_labels", "roi_valid")
        pred = jax.jit(lambda v, o: jm.apply(v, o, method=JVoxelRCNN.post_processing))(
            jv, {k: out[k] for k in post})
    return parity.record(*jax.device_get((out, pred)))


def reference_tree(rec, weights):
    """The stored reference of a JAX ``record``."""
    rng = np.random.default_rng(SAMPLE_SEED)
    stages = {}
    for name in parity.STAGES:
        keys, feats = rec["stages"][name]
        rows = np.sort(rng.choice(len(keys), min(ROW_SAMPLES, len(keys)), replace=False))
        stages[name] = {"count": np.int32(len(keys)),
                        "key_deltas": np.diff(keys, prepend=0).astype(np.int32),
                        "rows": rows.astype(np.int32), "features": feats[rows]}
    head = {"hm": rec["head"]["hm"]}
    for name in parity.HEAD_MAPS[1:]:
        flat = rec["head"][name].ravel()
        cells = np.sort(rng.choice(flat.size, CELL_SAMPLES, replace=False))
        head[name] = {"cells": cells.astype(np.int32), "values": flat[cells]}
    meta = {"weight_seed": np.int32(WEIGHT_SEED), "frame_seed": np.int32(FRAME_SEED),
            "n_points": np.int32(N_POINTS)}
    return {"meta": meta, "weights": weights, "stages": stages, "head": head,
            "rois": rec["rois"], "pred": rec["pred"]}


@pytest.mark.slow
def test_bench_predict_reference_is_regenerated():
    weights = reference_weights()
    dense = jax_record(weights, dense_tail=True)
    sparse = jax_record(weights, dense_tail=False)
    for name in parity.STAGES:  # the two tails give the same key sets
        np.testing.assert_array_equal(sparse["stages"][name][0], dense["stages"][name][0],
                                      err_msg=name)
    refs.assert_regenerated(REF, reference_tree(dense, weights))


@pytest.fixture(scope="module")
def bench_compare():
    """(report lines, misses) of the port's CPU predict, dense tail, f32."""
    ref = parity.load_reference(refs.path(REF))
    model = port_model()
    model.load_state_dict(parity.reference_state_dict(model, ref), strict=True)
    set_compute_dtype(model.eval(), None)
    pts, valid = bench_batch()
    # two threads for this one forward: 21 s against 35 s on one, which keeps
    # the file inside its share of the tier-1 budget
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        with torch.no_grad():
            out = model({"points": torch.from_numpy(pts),
                         "points_valid": torch.from_numpy(valid)})
            pred = model.post_processing(out)
    finally:
        torch.set_num_threads(threads)
    return parity.compare(parity.record(out, pred), ref)


def _misses(compared, *prefixes):
    lines, misses = compared
    return [m for m in misses if m.startswith(prefixes)]


@pytest.mark.parametrize("stage", parity.STAGES)
def test_bench_stage_keys_and_features_match_jax(bench_compare, stage):
    assert not _misses(bench_compare, f"{stage}:", f"{stage} ")
    assert any(line.startswith(f"{stage} features") for line in bench_compare[0])


@pytest.mark.parametrize("head", parity.HEAD_MAPS)
def test_bench_head_maps_match_jax(bench_compare, head):
    assert not _misses(bench_compare, f"head {head}:", f"head {head} ")


def test_bench_proposals_match_jax(bench_compare):
    assert not _misses(bench_compare, "roi")
    ref = parity.load_reference(refs.path(REF))
    assert int(ref["rois"]["roi_valid"].sum()) == BENCH["num_rois_test"]
    # the recipe keeps the comparison well posed: sane sizes, scores off 0 and 1
    sizes = ref["rois"]["rois"][:, 3:6]
    assert sizes.max() < 10.0 and 0.05 < ref["rois"]["roi_scores"].min()
    assert ref["rois"]["roi_scores"].max() < 0.5


def test_bench_detections_match_jax(bench_compare):
    assert not _misses(bench_compare, "detection")
    assert int(parity.load_reference(refs.path(REF))["pred"]["pred_valid"].sum()) > 100


def _round_trip(jm, pm, shapes):
    variables = seeded_jax_variables(shapes, 0)
    sd = state_dict_from_jax(variables, pm)
    back = jax_variables_from_state_dict(sd, pm, shapes)
    flat_a = jax.tree_util.tree_leaves_with_path(variables)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b) == len(sd)
    for path, leaf in flat_a:
        got = flat_b[path]
        assert got.dtype == leaf.dtype and np.array_equal(got, leaf), jax.tree_util.keystr(path)
    return sd


def test_jax_variables_from_state_dict_round_trips_tiny():
    from __graft_entry__ import _TINY
    jm = JVoxelRCNN(**_TINY, mm=False)
    pm = VoxelRCNN(**{k: v for k, v in _TINY.items() if k != "remat"}, mm=False)
    batch = {"points": jnp.zeros((1, 64, 5)), "points_valid": jnp.ones((1, 64), bool)}
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), batch, False))
    sd = _round_trip(jm, pm, shapes)
    with pytest.raises(KeyError, match="has no state-dict key"):
        jax_variables_from_state_dict({k: v for k, v in sd.items()
                                       if k != "roi_head.shared0.fc1.weight"}, pm, shapes)
    with pytest.raises(KeyError, match="without a JAX leaf"):
        jax_variables_from_state_dict(dict(sd, extra=torch.zeros(3)), pm, shapes)


def test_jax_variables_from_state_dict_round_trips_the_bench_tree():
    batch = {"points": jnp.zeros((1, 64, 5)), "points_valid": jnp.ones((1, 64), bool)}
    jm = JVoxelRCNN(**BENCH, dense_tail=True)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), batch, False))
    sd = _round_trip(jm, port_model(), shapes)
    assert set(sd) == set(port_model().state_dict())
