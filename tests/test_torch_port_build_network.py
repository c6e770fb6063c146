"""``build_network`` of the port against the JAX package's, on the CPU.

* All five shipped model yamls build in both packages at full width, and
  the JAX parameter tree of a training init maps key for key onto the
  port's state dict through ``state_dict_from_jax``: voxel_rcnn_cproto_center
  and its KITTI variant (MM on), the DBSCAN and OYSTER VoxelRCNN yamls
  (AnchorHeadSingleV2, VoxelRCNNHead, MM off) and the PointPillars yaml
  (PillarVFE, no 3D backbone, no RoI head; at +-75.52 m, where its BEV
  pyramid concatenates: at its own +-75.2 m neither package runs it, see
  tests/test_torch_port_pillars.py).
* Every module name that is not ported raises a KeyError that names it.
* With the scale overrides ``SCALE_SETS`` (range, voxel and RoI caps; no
  width changes), one f32 ``predict`` of the shipped yaml's model, same
  seeded weights, JAX under ``jax_nms_with_clip_iou`` and ``jax_f32``:
  proposals within 1e-4 of their scale, and the port's RoI head and final
  NMS on the JAX proposals within 1e-4 of the JAX outputs' scale, labels
  exact. Whole predict against whole predict, detections are paired by box:
  the RoI grid points are looked up in voxels, so a proposal that differs by
  f32 rounding can move a grid point into the next voxel and change
  that RoI's pooled features; at least 95% of the pairs are within 1e-4 of
  the scale, and all within 0.1 m and 0.01 in score.
"""
import contextlib
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from cpd_tpu import config as jconfig
from cpd_tpu.models import backbone3d as jbb
from cpd_tpu.models import bev as jbev
from cpd_tpu.models import center_head as jch
from cpd_tpu.models import detector as jdet
from cpd_tpu.models import roi_head as jroi
from cpd_tpu_torch import config
from cpd_tpu_torch.models import build_network
from cpd_tpu_torch.models.detector import VoxelRCNN, set_compute_dtype
from cpd_tpu_torch.utils.synthetic import make_lidar_frame
from cpd_tpu_torch.utils.weights import state_dict_from_jax
from tests.test_torch_port_models import jax_nms_with_clip_iou, seeded_jax_variables

SHIPPED = "tools/cfgs/models/voxel_rcnn_cproto_center.yaml"
PILLAR_RANGE_SETS = ["DATA_CONFIG.POINT_CLOUD_RANGE", "[-75.52,-75.52,-2.0,75.52,75.52,4.0]"]
# per yaml: the sets its full-width build takes, MM, the stage caps, the
# voxel (pillar) cap, the dense head, and a state-dict key with its shape
PORTED = {
    SHIPPED: ([], True, (80000, 40000, 20000, 20000), 150000, "CenterHead",
              ("roi_head.shared0.fc1.weight", (256, 256))),
    "tools/cfgs/models/voxel_rcnn_cproto_center_kitti.yaml": (
        [], True, (80000, 40000, 20000, 20000), 150000, "CenterHead",
        ("roi_head.shared0.fc1.weight", (256, 256))),
    "tools/cfgs/models/voxel_rcnn_dbscan_single_train.yaml": (
        [], False, (80000, 40000, 20000, 20000), 150000, "AnchorHeadSingleV2",
        ("dense_head.conv_cls.out.weight", (18, 64, 1, 1))),
    "tools/cfgs/models/voxel_rcnn_oyster_single_train.yaml": (
        [], False, (80000, 40000, 20000, 20000), 150000, "AnchorHeadSingleV2",
        ("dense_head.conv_reg.conv.weight", (64, 64, 3, 3))),
    "tools/cfgs/models/pointpillar_dbscan_single_train.yaml": (
        PILLAR_RANGE_SETS, False, None, 32000, "AnchorHeadSingle",
        ("vfe.pfn0.weight", (64, 10))),
}
RANGE = 12.0
# ``--set`` overrides that cut the scale for the CPU: a 24 m square (BEV maps
# of 30 x 30 and 15 x 15), voxel and stage caps, 4096 points a frame, 64 test
# RoIs a frame; every channel width stays the yaml's
SCALE_SETS = [
    "DATA_CONFIG.POINT_CLOUD_RANGE", f"[-{RANGE},-{RANGE},-2.0,{RANGE},{RANGE},4.0]",
    "DATA_CONFIG.POINT_CAP", "4096",
    "DATA_CONFIG.DATA_PROCESSOR",
    "[{'NAME': 'transform_points_to_voxels', 'VOXEL_SIZE': [0.1, 0.1, 0.15], "
    "'MAX_POINTS_PER_VOXEL': 5, 'MAX_NUMBER_OF_VOXELS': {'train': 8000, 'test': 8000}}]",
    "MODEL.BACKBONE_3D.VOXEL_CAPS", "[6000,3000,1500,1500]",
    "MODEL.ROI_HEAD.NMS_CONFIG.TEST.NMS_POST_MAXSIZE", "64",
]


class _F32Backbone(jbb.VoxelResBackBone8x):
    compute_dtype: Any = None


class _F32BEV(jbev.BaseBEVBackbone):
    compute_dtype: Any = None


class _F32CenterHead(jch.CenterHead):
    compute_dtype: Any = None


class _F32FCTower(jroi.FCTower):
    compute_dtype: Any = None


class _F32Linen:
    """flax.linen for cpd_tpu.models.roi_head with ``Dense`` computing in f32
    (GridPoolBranch hard-codes bf16); module names stay flax's."""

    def __getattr__(self, name):
        return getattr(fnn, name)

    @staticmethod
    def Dense(*args, dtype=None, **kwargs):  # noqa: N802 - flax's name
        return fnn.Dense(*args, **kwargs)


@contextlib.contextmanager
def jax_f32():
    """The JAX detector computing in f32 throughout: the modules that its
    ``setup`` builds with their bf16 default get f32 twins of the same name
    in the tree (the JAX package has no detector-wide switch)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jdet._BACKBONES_3D, "VoxelResBackBone8x", _F32Backbone)
        mp.setattr(jdet, "VoxelResBackBone8x", _F32Backbone)
        mp.setattr(jdet, "BaseBEVBackbone", _F32BEV)
        mp.setitem(jdet._DENSE_HEADS, "CenterHead", _F32CenterHead)
        mp.setattr(jdet, "CenterHead", _F32CenterHead)
        mp.setattr(jroi, "FCTower", _F32FCTower)
        mp.setattr(jroi, "nn", _F32Linen())
        yield


def load_pair(path, sets=()):
    """The yaml's config in the port and in the JAX package, with ``sets``."""
    port = config.cfg_from_list(list(sets), config.cfg_from_yaml_file(path, config.ConfigDict()))
    ref = jconfig.cfg_from_list(list(sets), jconfig.cfg_from_yaml_file(path, jconfig.ConfigDict()))
    return port, ref


def jax_shapes(jmodel, n_points=256):
    """Abstract variables of a training init (the MM branch included)."""
    rng = np.random.default_rng(0)
    pts = np.concatenate([rng.uniform(-8, 8, (1, n_points, 2)), rng.uniform(-2, 4, (1, n_points, 1)),
                          rng.uniform(0, 1, (1, n_points, 2))], -1).astype(np.float32)
    gt = np.zeros((1, 2, 8), np.float32)
    gt[..., 3:6], gt[..., 7] = 2.0, 1.0
    batch = {"points": jnp.asarray(pts), "points_valid": jnp.ones((1, n_points), bool),
             "gt_boxes": jnp.asarray(gt), "gt_valid": jnp.ones((1, 2), bool)}
    rngs = {k: jax.random.PRNGKey(i) for i, k in enumerate(("params", "sampling", "dropout"))}
    return jax.eval_shape(lambda: jmodel.init(rngs, batch, True))


def seeded_pair(port_cfg, jax_cfg, seed=0):
    """(JAX model, JAX variables as numpy, port model with the same weights,
    eval mode, f32), both from ``build_network``; build under ``jax_f32``."""
    jm = jdet.build_network(jax_cfg.MODEL, len(jax_cfg.CLASS_NAMES), jax_cfg.DATA_CONFIG)
    variables = seeded_jax_variables(jax_shapes(jm), seed)
    pm = build_network(port_cfg.MODEL, len(port_cfg.CLASS_NAMES), port_cfg.DATA_CONFIG)
    pm.load_state_dict(state_dict_from_jax(variables, pm), strict=True)
    return jm, variables, set_compute_dtype(pm.eval(), None)


@pytest.mark.parametrize("path", sorted(PORTED))
def test_ported_yaml_builds_at_full_width_with_one_to_one_keys(path):
    sets, mm, caps, max_voxels, head, (key, shape) = PORTED[path]
    port_cfg, jax_cfg = load_pair(path, sets)
    jm = jdet.build_network(jax_cfg.MODEL, len(jax_cfg.CLASS_NAMES), jax_cfg.DATA_CONFIG)
    pm = build_network(port_cfg.MODEL, len(port_cfg.CLASS_NAMES), port_cfg.DATA_CONFIG)
    assert pm.mm == jm.mm == mm
    assert pm.dense_head_name == jm.dense_head_name == head
    assert pm.with_roi_head == jm.with_roi_head == (caps is not None)
    if caps is not None:
        assert pm.backbone.caps == tuple(jm.backbone_caps) == caps
        assert pm.roi_head.mm == mm
    else:
        assert not hasattr(pm, "backbone") and pm.grid.nx == 472
    assert pm.vox_spec.max_voxels == jm.max_voxels == max_voxels
    shapes = jax_shapes(jm)
    n_leaves = sum(len(jax.tree_util.tree_leaves(shapes[c])) for c in ("params", "batch_stats"))
    sd = state_dict_from_jax(seeded_jax_variables(shapes, 0), pm)  # raises on any mismatch
    assert set(sd) == set(pm.state_dict()) and len(sd) == n_leaves
    if caps is not None:
        assert sd["backbone.branch0.conv_input.weight"].shape == (27, 5, 16)
    assert sd[key].shape == shape


@pytest.mark.parametrize("field,name", [
    ("backbone3d_name", "VoxelBackBone8x"), ("temporal_name", "ConvGRU"),
    ("pfe_name", "VoxelSetAbstraction"), ("wrap_head_name", "PartWraper")])
def test_constructor_names_the_module_it_lacks(field, name):
    with pytest.raises(KeyError, match=f"'{name}' is not ported yet"):
        VoxelRCNN(**{field: name})


@pytest.mark.parametrize("kwargs,match", [
    (dict(vfe_name="PillarVFE", with_roi_head=False), "requires MAP_TO_BEV PointPillarScatter"),
    (dict(vfe_name="PillarVFE", map_to_bev_name="PointPillarScatter"), "needs a 3D backbone"),
    (dict(backbone3d_name=None), "needs a BACKBONE_3D")])
def test_constructor_checks_the_topology_as_jax_does(kwargs, match):
    with pytest.raises(ValueError, match=match):
        VoxelRCNN(**kwargs)
    with pytest.raises(ValueError, match=match):
        jdet.VoxelRCNN(**kwargs).init(jax.random.PRNGKey(0), {"points": jnp.zeros((1, 8, 5))})


def test_model_name_not_ported():
    port_cfg, _ = load_pair(SHIPPED)
    port_cfg.MODEL.NAME = "CenterPoint"
    with pytest.raises(KeyError, match="'CenterPoint' is not ported yet"):
        build_network(port_cfg.MODEL, 3, port_cfg.DATA_CONFIG)


def frames_batch(n, seed=0, n_points=4096):
    """``n`` lidar frames cut to the SCALE_SETS square, padded to n_points."""
    pts = np.zeros((n, n_points, 5), np.float32)
    valid = np.zeros((n, n_points), bool)
    for i in range(n):
        frame, _ = make_lidar_frame(np.random.default_rng([seed, i]), 24_000)
        frame = frame[(np.abs(frame[:, 0]) < RANGE) & (np.abs(frame[:, 1]) < RANGE)][:n_points]
        pts[i, :len(frame)] = frame
        valid[i, :len(frame)] = True
    return pts, valid


def pair_detections(port, ref):
    """Port slot -> ref slot, each valid port detection paired with the
    nearest valid ref detection by box (x, y, z, dx, dy, dz); -> (port
    slots, ref slots, box distances)."""
    p_idx = np.nonzero(port["pred_valid"])[0]
    r_idx = np.nonzero(ref["pred_valid"])[0]
    assert len(p_idx) == len(r_idx), (len(p_idx), len(r_idx))
    d = np.abs(port["pred_boxes"][p_idx, None, :6] - ref["pred_boxes"][None, r_idx, :6]).max(-1)
    nearest = d.argmin(1)
    assert len(set(nearest.tolist())) == len(p_idx), "two detections paired with one"
    return p_idx, r_idx[nearest], d[np.arange(len(p_idx)), nearest]


def _np(tree):
    return {k: (v.float().numpy() if isinstance(v, torch.Tensor) else np.asarray(v, np.float32))
            for k, v in tree.items()}


@pytest.fixture(scope="module")
def f32_predict():
    port_cfg, jax_cfg = load_pair(SHIPPED, SCALE_SETS)
    pts, valid = frames_batch(2)
    with jax_f32():
        jm, variables, pm = seeded_pair(port_cfg, jax_cfg)
        jv = jax.tree_util.tree_map(jnp.asarray, variables)
        jbatch = {"points": jnp.asarray(pts), "points_valid": jnp.asarray(valid)}
        with jax_nms_with_clip_iou():
            jout = jax.jit(lambda v, b: jm.apply(v, b, False))(jv, jbatch)
            keep = ("batch_box_preds", "batch_cls_preds", "roi_labels", "roi_valid")
            jpred = jax.jit(lambda v, o: jm.apply(v, o, method=type(jm).post_processing))(
                jv, {k: jout[k] for k in keep})
    jout, jpred = jax.device_get((jout, jpred))
    pbatch = {"points": torch.from_numpy(pts), "points_valid": torch.from_numpy(valid)}
    with torch.no_grad():
        pout = pm(pbatch)
        ppred = pm.post_processing(pout)
        proposals = {k: torch.from_numpy(np.array(jout[k]))
                     for k in ("rois", "roi_scores", "roi_labels", "roi_valid")}
        handed = pm.post_processing(pm.roi_head(proposals, pout["backbone_out"]))
    return pout, ppred, handed, jout, jpred


def _scaled_close(port, ref, what):
    scale = max(float(np.abs(ref).max()), 1e-3)
    err = float(np.abs(port - ref).max())
    assert err <= 1e-4 * scale, f"{what}: max err {err} at scale {scale}"


def test_f32_predict_proposals_match(f32_predict):
    pout, _, _, jout, _ = f32_predict
    p, j = _np({k: pout[k] for k in ("rois", "roi_scores", "roi_labels", "roi_valid")}), jout
    np.testing.assert_array_equal(p["roi_valid"], np.asarray(j["roi_valid"], np.float32))
    np.testing.assert_array_equal(p["roi_labels"], np.asarray(j["roi_labels"], np.float32))
    assert p["roi_valid"].sum() > 40
    for k in ("rois", "roi_scores"):
        _scaled_close(p[k], np.asarray(j[k], np.float32), k)


def test_f32_roi_head_and_nms_on_the_same_proposals_match(f32_predict):
    _, _, handed, _, jpred = f32_predict
    port, ref = _np(handed), _np(jpred)
    np.testing.assert_array_equal(port["pred_valid"], ref["pred_valid"])
    np.testing.assert_array_equal(port["pred_labels"], ref["pred_labels"])
    assert port["pred_valid"].sum() > 40
    for k in ("pred_boxes", "pred_scores"):
        _scaled_close(port[k], ref[k], k)


def test_f32_predict_detections_match(f32_predict):
    _, ppred, _, _, jpred = f32_predict
    port, ref = _np(ppred), _np(jpred)
    n = 0
    for b in range(port["pred_boxes"].shape[0]):
        pb = {k: v[b] for k, v in port.items()}
        rb = {k: v[b] for k, v in ref.items()}
        p, r, dist = pair_detections(pb, rb)
        np.testing.assert_array_equal(pb["pred_labels"][p], rb["pred_labels"][r])
        score_err = np.abs(pb["pred_scores"][p] - rb["pred_scores"][r])
        box_err = np.abs(pb["pred_boxes"][p] - rb["pred_boxes"][r]).max(-1)
        tight = ((box_err <= 1e-4 * np.abs(rb["pred_boxes"]).max())
                 & (score_err <= 1e-4 * np.abs(rb["pred_scores"]).max()))
        assert tight.mean() >= 0.95, (tight.mean(), box_err.max(), score_err.max())
        assert box_err.max() <= 0.1 and score_err.max() <= 0.01, (box_err.max(), score_err.max())
        n += len(p)
    assert n > 40
