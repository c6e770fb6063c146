"""The PointPillars path of the port (cpd_tpu_torch/models/pillars.py and the
pillar branch of VoxelRCNN) against the JAX package on the CPU, at f32.

* ``voxelize(..., with_point_voxel_id=True)``: the per-point pillar rows
  exactly equal (with the yaml's 0.32 x 0.32 x 6 m pillars, the cap
  saturated, and with the spconv-parity truncation);
* ``PillarVFE`` in eval and training mode, then ``pointpillar_scatter``, with
  the same seeded weights through ``state_dict_from_jax``: pooled features
  and the BEV image within 1e-4 of their scale, running statistics within
  1e-5;
* the shipped pointpillar_dbscan_single_train.yaml at its own range (+-75.2
  m: 470 pillars a side) fails in both packages where the BEV pyramid's
  upsampled maps (235, 236, 236) are concatenated; neither crops or pads;
* the whole model from ``build_network`` on that yaml at the cut scale
  ``PILLAR_SETS`` (+-12.8 m: an 80 x 80 pillar grid, a multiple of 8; caps
  and NMS sizes cut, every width the yaml's): ``predict``'s proposals within
  1e-4 of their scale and its detections (the final NMS on the proposals,
  no RoI head) at the tier of tests/test_torch_port_build_network.py, and
  ``loss_step``'s terms within 1e-4 relative.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from cpd_tpu.models import bev as jbev
from cpd_tpu.models import detector as jdet
from cpd_tpu.models import pillars as jpil
from cpd_tpu.ops import voxelizer as jvox
from cpd_tpu.ops.sparse import GridSpec as JGridSpec
from cpd_tpu_torch.models import build_network, pillars
from cpd_tpu_torch.ops import voxelizer
from cpd_tpu_torch.ops.sparse import GridSpec
from cpd_tpu_torch.utils.weights import state_dict_from_jax
from tests import torch_port_refs as refs
from tests.test_torch_port_anchor import jax_anchors_eager
from tests.test_torch_port_build_network import (_np, _scaled_close, frames_batch, jax_f32,
                                                 load_pair, pair_detections, seeded_pair)
from tests.test_torch_port_models import jax_nms_with_clip_iou, seeded_jax_variables
from tests.torch_port_refs import one_torch_thread  # noqa: F401

YAML = "tools/cfgs/models/pointpillar_dbscan_single_train.yaml"
R = 12.8
PILLAR_SETS = [
    "DATA_CONFIG.POINT_CLOUD_RANGE", f"[-{R},-{R},-2.0,{R},{R},4.0]",
    "DATA_CONFIG.POINT_CAP", "4096",
    "DATA_CONFIG.DATA_PROCESSOR",
    "[{'NAME': 'transform_points_to_voxels', 'VOXEL_SIZE': [0.32, 0.32, 6.0], "
    "'MAX_POINTS_PER_VOXEL': 32, 'MAX_NUMBER_OF_VOXELS': {'train': 3000, 'test': 3000}}]",
    "MODEL.DENSE_HEAD.POST_PROCESSING.NMS_CONFIG", "{'NMS_THRESH': 0.8, 'NMS_PRE_MAXSIZE': 512}",
]


def _t(x):
    return torch.from_numpy(np.array(x))


def _points(seed, n=3000, spread=R + 0.5):
    """(2, n, 5) points clustered into pillars, some outside the range."""
    rng = np.random.default_rng(seed)
    pts = np.concatenate([rng.uniform(-spread, spread, (2, n, 2)), rng.uniform(-2.5, 4.5, (2, n, 1)),
                          rng.uniform(0, 1, (2, n, 2))], -1).astype(np.float32)
    pts[:, : n // 2, :2] = pts[:, :1, :2] + rng.normal(0, 0.4, (2, n // 2, 2)).astype(np.float32)
    return pts, rng.random((2, n)) < 0.9


@pytest.mark.parametrize("max_points", [None, 32])
def test_voxelize_point_voxel_id_matches(max_points):
    pts, valid = _points(0)
    args = ((-R, -R, -2.0, R, R, 4.0), (0.32, 0.32, 6.0), 500)  # below the occupancy
    ref = jvox.voxelize_batch(jnp.asarray(pts), jvox.VoxelizerSpec.create(
        *args, max_points_per_voxel=max_points), jnp.asarray(valid), with_point_voxel_id=True)
    out = voxelizer.voxelize_batch(_t(pts), voxelizer.VoxelizerSpec.create(
        *args, max_points_per_voxel=max_points), _t(valid), with_point_voxel_id=True)
    assert int(np.asarray(ref.valid).sum(1).min()) == 500  # the cap saturates
    np.testing.assert_array_equal(out.point_voxel_id.numpy(), np.asarray(ref.point_voxel_id))
    np.testing.assert_array_equal(out.coords.numpy(), np.asarray(ref.coords))
    ids = out.point_voxel_id.numpy()
    assert (ids == -1).any() and ids.max() == 499
    plain = voxelizer.voxelize_batch(_t(pts), voxelizer.VoxelizerSpec.create(*args), _t(valid))
    assert (plain.point_voxel_id == -1).all()  # not asked for


class _Holder(nn.Module):
    """The port's PillarVFE under the name ``vfe``, as the detector holds it."""

    def __init__(self):
        super().__init__()
        self.vfe = pillars.PillarVFE(5, (64,))


def _vfe_inputs():
    """The pillar net's per-point inputs, from the JAX voxelizer (batch of 2
    offset into one table, as ``_pillar_bev`` does)."""
    pts, valid = _points(1)
    spec = jvox.VoxelizerSpec.create((-R, -R, -2.0, R, R, 4.0), (0.32, 0.32, 6.0), 1200)
    frame = jvox.voxelize_batch(jnp.asarray(pts), spec, jnp.asarray(valid), with_point_voxel_id=True)
    v = frame.features.shape[1]
    pid = np.asarray(frame.point_voxel_id)
    pid = np.where(pid >= 0, pid + np.arange(2)[:, None] * v, -1).astype(np.int32)
    coords = np.asarray(frame.coords).astype(np.float32)
    centers = np.stack([(coords[..., 2] + 0.5) * 0.32 - R, (coords[..., 1] + 0.5) * 0.32 - R], -1)
    keys = np.where(np.asarray(frame.valid), (coords[..., 1] * 80 + coords[..., 2]).astype(np.int32),
                    np.iinfo(np.int32).max)
    return (pts.reshape(-1, 5), pid.reshape(-1), np.asarray(frame.features)[..., :3].reshape(-1, 3),
            centers.reshape(-1, 2).astype(np.float32), 2 * v), keys


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_pillar_vfe_and_scatter_match(train):
    (points, pid, mean, centers, n), keys = _vfe_inputs()
    jm = jpil.PillarVFE(num_filters=(64,))
    jargs = (jnp.asarray(points), jnp.asarray(pid), jnp.asarray(mean), jnp.asarray(centers), n)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), *jargs, False))
    variables = {c: {"vfe": t} for c, t in seeded_jax_variables(shapes, 0).items()}
    holder = _Holder()
    holder.load_state_dict(state_dict_from_jax(variables, holder), strict=True)
    jv = jax.tree_util.tree_map(jnp.asarray, {c: t["vfe"] for c, t in variables.items()})
    ref, stats = jm.apply(jv, *jargs, train, mutable=["batch_stats"])
    holder.train(train)
    out = holder.vfe(_t(points), _t(pid), _t(mean), _t(centers), n)
    _scaled_close(out.detach().numpy(), np.asarray(ref), "pooled")
    assert float(np.abs(np.asarray(ref)).max()) > 0.1 and (np.asarray(ref) == 0).all(-1).any()
    grid = JGridSpec(80, 80, 2)
    v = n // 2
    for b in range(2):
        jbev_map = jpil.pointpillar_scatter(ref[b * v:(b + 1) * v], jnp.asarray(keys[b]), grid)
        pbev_map = pillars.pointpillar_scatter(out[b * v:(b + 1) * v], _t(keys[b]),
                                               GridSpec(80, 80, 2))
        _scaled_close(pbev_map.detach().numpy(), np.asarray(jbev_map), "bev")
    if train:
        bn = stats["batch_stats"]["MaskedBatchNorm_0"]
        np.testing.assert_allclose(holder.vfe.bn0.running_mean.numpy(), np.asarray(bn["mean"]),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(holder.vfe.bn0.running_var.numpy(), np.asarray(bn["var"]),
                                   rtol=1e-5, atol=1e-5)


def test_both_packages_fail_at_the_pillar_yaml_range():
    """470 pillars a side: the pyramid's maps are 235, 118 and 59, upsampled
    to 235, 236 and 236; both packages' concatenation raises."""
    port_cfg, jax_cfg = load_pair(YAML)
    assert tuple(port_cfg.DATA_CONFIG.POINT_CLOUD_RANGE) == (-75.2, -75.2, -2.0, 75.2, 75.2, 4.0)
    jm = jdet.build_network(jax_cfg.MODEL, 3, jax_cfg.DATA_CONFIG)
    pm = build_network(port_cfg.MODEL, 3, port_cfg.DATA_CONFIG).eval()
    assert pm.grid.nx == pm.grid.ny == 470
    pts, valid = _points(2, n=512, spread=70.0)
    batch = {"points": pts[:1], "points_valid": valid[:1]}
    with pytest.raises(TypeError, match="235, 235, 128.*236, 236, 128"):
        jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                       {k: jnp.asarray(v) for k, v in batch.items()}, False))
    bev = jbev.BaseBEVBackbone(layer_nums=(3, 5, 5), layer_strides=(2, 2, 2),
                               num_filters=(64, 128, 256), upsample_strides=(1, 2, 4),
                               num_upsample_filters=(128, 128, 128))
    with pytest.raises(TypeError, match="Cannot concatenate"):
        jax.eval_shape(lambda: bev.init(jax.random.PRNGKey(0), jnp.zeros((1, 470, 470, 64)), False))
    with pytest.raises(RuntimeError, match="Sizes of tensors must match"):
        pm.predict({k: _t(v) for k, v in batch.items()})


@pytest.fixture(scope="module")
def pillar_pair():
    port_cfg, jax_cfg = load_pair(YAML, PILLAR_SETS)
    with jax_f32():
        jm, variables, pm = seeded_pair(port_cfg, jax_cfg)
    assert pm.grid.nx == 80 and not pm.with_roi_head
    return jm, variables, pm


def jax_pillar_predict(jm, variables, pts, valid):
    jv = jax.tree_util.tree_map(jnp.asarray, variables)
    jbatch = {"points": jnp.asarray(pts), "points_valid": jnp.asarray(valid)}
    with jax_f32(), jax_nms_with_clip_iou():
        jout = jax.jit(lambda v, b: jm.apply(v, b, False))(jv, jbatch)
        keep = ("rois", "roi_scores", "roi_labels", "roi_valid")
        jpred = jax.jit(lambda v, o: jm.apply(v, o, method=type(jm).post_processing))(
            jv, {k: jout[k] for k in keep})
    jout, jpred = jax.device_get((jout, jpred))
    return {"out": {k: jout[k] for k in keep}, "pred": dict(jpred)}


def test_pillar_predict_matches(pillar_pair):
    """Against the JAX side's predict, the committed reference ``pillars``."""
    _, _, pm = pillar_pair
    pts, valid = frames_batch(2)
    ref = refs.load("pillars")["predict"]
    jout, jpred = ref["out"], ref["pred"]
    keep = ("rois", "roi_scores", "roi_labels", "roi_valid")
    with torch.no_grad():
        pout = pm({"points": _t(pts), "points_valid": _t(valid)})
        ppred = pm.post_processing(pout)
    p = _np({k: pout[k] for k in keep})
    for k in ("roi_valid", "roi_labels"):
        np.testing.assert_array_equal(p[k], np.asarray(jout[k], np.float32))
    for k in ("rois", "roi_scores"):
        _scaled_close(p[k], np.asarray(jout[k], np.float32), k)
    port, ref = _np(ppred), _np(jpred)
    n = 0
    for b in range(2):
        pb = {k: v[b] for k, v in port.items()}
        rb = {k: v[b] for k, v in ref.items()}
        pi, ri, _ = pair_detections(pb, rb)
        np.testing.assert_array_equal(pb["pred_labels"][pi], rb["pred_labels"][ri])
        _scaled_close(pb["pred_boxes"][pi], rb["pred_boxes"][ri], "pred_boxes")
        _scaled_close(pb["pred_scores"][pi], rb["pred_scores"][ri], "pred_scores")
        n += len(pi)
    assert n > 40


def pillar_loss_batch():
    pts, valid = frames_batch(2, seed=1)
    rng = np.random.default_rng(3)
    gt = np.zeros((2, 16, 8), np.float32)
    gt[..., :2] = rng.uniform(-R + 2, R - 2, (2, 16, 2))
    gt[..., 2] = rng.uniform(-1, 0.5, (2, 16))
    gt[..., 7] = rng.integers(1, 4, (2, 16))
    sizes = np.float32([[4.7, 2.1, 1.7], [0.91, 0.86, 1.73], [1.78, 0.84, 1.78]])
    gt[..., 3:6] = sizes[gt[..., 7].astype(int) - 1] * rng.uniform(0.8, 1.2, (2, 16, 3))
    gt[..., 6] = rng.uniform(-np.pi, np.pi, (2, 16))
    gv = np.arange(16)[None] < np.array([[12], [9]])
    return {"points": pts, "points_valid": valid, "gt_boxes": gt, "gt_valid": gv}


def jax_pillar_loss_step(jm, variables, batch):
    jv = jax.tree_util.tree_map(jnp.asarray, variables)
    with jax_f32(), jax_nms_with_clip_iou(), jax_anchors_eager():
        (jtotal, jtb), jstats = jax.device_get(jax.jit(lambda v, b: jm.apply(
            v, b, method=type(jm).loss_step, mutable=["batch_stats"]))(
            jv, {k: jnp.asarray(v) for k, v in batch.items()}))
    return {"total": jtotal, "tb": dict(jtb),
            "vfe_bn": dict(jstats["batch_stats"]["vfe"]["MaskedBatchNorm_0"])}


@pytest.mark.slow
def test_pillars_reference_is_regenerated(pillar_pair):
    jm, variables, _ = pillar_pair
    live = {"predict": jax_pillar_predict(jm, variables, *frames_batch(2)),
            "loss_step": jax_pillar_loss_step(jm, variables, pillar_loss_batch())}
    refs.assert_regenerated("pillars", live)


def test_pillar_loss_step_matches(pillar_pair):
    """Against the JAX side's training forward, the committed ``pillars``."""
    _, _, pm = pillar_pair
    pm = copy.deepcopy(pm)  # the step moves the running statistics
    batch = pillar_loss_batch()
    ref = refs.load("pillars")["loss_step"]
    jtotal, jtb = ref["total"], ref["tb"]
    jstats = {"batch_stats": {"vfe": {"MaskedBatchNorm_0": ref["vfe_bn"]}}}
    ptotal, ptb = pm.train().loss_step({k: _t(v) for k, v in batch.items()})
    assert set(ptb) == set(jtb) == {"rpn_cls", "rpn_reg", "rpn_dir", "rpn_loss", "total_loss"}
    for k in jtb:
        ref, port = float(jtb[k]), float(ptb[k].detach())
        assert abs(port - ref) <= 1e-4 * abs(ref), (k, port, ref)
    assert float(jtb["rpn_reg"]) > 0
    bn = jstats["batch_stats"]["vfe"]["MaskedBatchNorm_0"]
    np.testing.assert_allclose(pm.vfe.bn0.running_mean.numpy(), np.asarray(bn["mean"]),
                               rtol=1e-5, atol=1e-5)
