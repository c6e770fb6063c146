"""The shipped KITTI yaml (tools/cfgs/models/voxel_rcnn_cproto_center_kitti.yaml)
through the port on the CPU, at the cut scale ``SCALE_SETS`` of
tests/test_torch_port_build_network.py (a 24 m square, voxel and stage caps,
4096 points; every channel width stays the yaml's) with the proposal NMS
over the top 128 boxes (the CPU's rotated IoU over the yaml's 500 took 3 s
a sample), on 4 frames written by ``write_kitti_frames`` in KITTI's layout
(labels within 10 m, so that they lie in the cut square). The training run
also takes 16 RoIs an image at grid 4 (``SHRINK_SETS``' RoI cuts).

* ``python -m cpd_tpu_torch.tools.test`` on a checkpoint of seeded weights:
  one record a frame carrying the camera-protocol fields, the R40 and R11
  APs of Car, Pedestrian and Cyclist in its result.
* ``python -m cpd_tpu_torch.tools.train --epochs 1 --debug_steps 2``: two
  steps at the yaml's batch of 2 with finite losses and ``proto_loss``, cars
  among the labels (class 1), a checkpoint whose ``conv_input`` is
  ``(27, 4, 16)`` in both branches.
* The model's 4-column input against JAX: a JAX tree initialised on a
  ``Kitti2WaymoDataset`` batch goes through ``state_dict_from_jax``, and one
  f32 ``predict`` of a 2-frame KITTI batch is held at the whole-predict tier
  of tests/test_torch_port_build_network.py (proposals within 1e-4 of their
  scale; detections paired by box, 95% within 1e-4 of the scale, all within
  0.1 m and 0.01).
"""
import json
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpd_tpu.datasets import dataset as jds
from cpd_tpu.datasets.kitti import Kitti2WaymoDataset as JKitti
from cpd_tpu.models import detector as jdet
from cpd_tpu_torch.config import ConfigDict, cfg_from_list, cfg_from_yaml_file
from cpd_tpu_torch.datasets.dataset import collate_batch
from cpd_tpu_torch.datasets.kitti import Kitti2WaymoDataset
from cpd_tpu_torch.models import build_network
from cpd_tpu_torch.models.detector import set_compute_dtype
from cpd_tpu_torch.tools import test as eval_cli
from cpd_tpu_torch.tools import train as train_cli
from cpd_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from cpd_tpu_torch.utils.synthetic import write_kitti_frames
from cpd_tpu_torch.utils.weights import seeded_state_dict, state_dict_from_jax
from tests import torch_port_refs as refs
from tests.test_torch_port_build_network import (SCALE_SETS, jax_f32, load_pair,
                                                 pair_detections)
from tests.test_torch_port_models import jax_nms_with_clip_iou, seeded_jax_variables
from tests.test_torch_port_ppscore import one_torch_thread  # noqa: F401

KITTI_YAML = "tools/cfgs/models/voxel_rcnn_cproto_center_kitti.yaml"
CLASSES = ["Car", "Pedestrian", "Cyclist"]
N_FRAMES = 4


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tmp_path_factory.mktemp("kitti_cli")
    write_kitti_frames(root, N_FRAMES, seed=3, n_points=24_000, n_boxes=4, box_range=(4.0, 10.0))
    return root


KITTI_SETS = [*SCALE_SETS, "MODEL.DENSE_HEAD.POST_PROCESSING.NMS_CONFIG.NMS_PRE_MAXSIZE", "128"]
TRAIN_SETS = ["MODEL.ROI_HEAD.TARGET_CONFIG.ROI_PER_IMAGE", "16",
              "MODEL.ROI_HEAD.ROI_GRID_POOL.GRID_SIZE", "4"]
# the training run's voxel and stage caps, cut to a quarter (the plain
# sparse convs cost what their caps hold; these frames fill under 700 voxels)
TRAIN_CAPS = ["DATA_CONFIG.DATA_PROCESSOR",
              "[{'NAME': 'transform_points_to_voxels', 'VOXEL_SIZE': [0.1, 0.1, 0.15], "
              "'MAX_POINTS_PER_VOXEL': 5, 'MAX_NUMBER_OF_VOXELS': {'train': 2000, 'test': 2000}}]",
              "MODEL.BACKBONE_3D.VOXEL_CAPS", "[1500,1000,500,500]"]


def _sets(root):
    return ["DATA_CONFIG.DATA_PATH", str(root), *KITTI_SETS]


def _cfg(root):
    return cfg_from_list(_sets(root), cfg_from_yaml_file(KITTI_YAML, ConfigDict()))


def test_eval_cli_runs_the_kitti_yaml(root, tmp_path):
    cfg = _cfg(root)
    model = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), cfg.DATA_CONFIG)
    model.load_state_dict(seeded_state_dict(model, 0), strict=True)
    assert model.state_dict()["backbone.branch0.conv_input.weight"].shape == (27, 4, 16)
    ckpt = save_checkpoint(tmp_path / "ckpt", model, 0)
    result = eval_cli.main(["--cfg_file", KITTI_YAML, "--ckpt", str(ckpt), "--device", "cpu",
                            "--workers", "2", "--output_dir", str(tmp_path / "eval"),
                            "--set", *_sets(root)])
    with open(tmp_path / "eval" / "result.pkl", "rb") as f:
        dets = pickle.load(f)
    assert [d["frame_id"] for d in dets] == [f"{i:06d}" for i in range(N_FRAMES)]
    for d in dets:
        n = len(d["score"])
        for key, shape in (("location", (n, 3)), ("dimensions", (n, 3)), ("rotation_y", (n,)),
                           ("alpha", (n,)), ("bbox", (n, 4)), ("boxes_lidar", (n, 7))):
            assert d[key].shape == shape and np.isfinite(d[key]).all(), key
        assert set(d["name"]) <= set(CLASSES)
    assert sum(len(d["score"]) for d in dets) > 0
    for c in CLASSES:
        for metric in ("3d", "bev", "bbox", "aos"):
            assert {f"{c}_{metric}/moderate_R40", f"{c}_{metric}/moderate_R11"} <= set(result)
    assert result["gt_count"] > 0


def test_train_cli_runs_the_kitti_yaml(root, tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    cfg = _cfg(root)
    dataset = Kitti2WaymoDataset(cfg.DATA_CONFIG, cfg.CLASS_NAMES, True, str(root))
    labels = np.concatenate([s["gt_boxes"][s["gt_valid"], 7] for s in
                             (dataset[i] for i in range(len(dataset)))])
    assert (labels == 1).any() and set(labels) <= {1.0, 2.0, 3.0}
    out = tmp_path / "train"
    state = train_cli.main(["--cfg_file", KITTI_YAML, "--device", "cpu", "--workers", "2",
                            "--output_dir", str(out), "--epochs", "1", "--debug_steps", "2",
                            "--log_every", "1", "--set", *_sets(root), *TRAIN_SETS,
                            *TRAIN_CAPS])
    assert state.step == 2
    with open(out / "metrics.jsonl") as f:
        recs = [json.loads(ln) for ln in f]
    assert [r["step"] for r in recs] == [1, 2]
    for r in recs:
        values = {k: v for k, v in r.items() if k != "step"}
        assert "proto_loss" in values and all(np.isfinite(v) for v in values.values()), values
    payload = load_checkpoint(out / "ckpt" / "checkpoint_epoch_0.pth")
    for branch in ("branch0", "branch1"):
        assert payload["model_state"][f"backbone.{branch}.conv_input.weight"].shape == (27, 4, 16)


def _kitti_pair(root):
    """The eval batch of the written scans, the JAX model and its seeded
    variables (a training init on the training batch), and the port model
    with the same weights."""
    port_cfg, jax_cfg = load_pair(KITTI_YAML, _sets(root) + TRAIN_SETS)  # JAX inits in training
    train_batch = jds.collate_batch([JKitti(jax_cfg.DATA_CONFIG, jax_cfg.CLASS_NAMES, True,
                                            str(root))[i] for i in range(2)])
    port_ds = Kitti2WaymoDataset(port_cfg.DATA_CONFIG, port_cfg.CLASS_NAMES, False, str(root))
    batch = collate_batch([port_ds[i] for i in range(2)])
    assert batch["points"].shape[-1] == train_batch["points"].shape[-1] == 4
    with jax_f32():
        jm = jdet.build_network(jax_cfg.MODEL, len(jax_cfg.CLASS_NAMES), jax_cfg.DATA_CONFIG)
        rngs = {k: jax.random.PRNGKey(i) for i, k in enumerate(("params", "sampling", "dropout"))}
        init_batch = {k: jnp.asarray(train_batch[k]) for k in
                      ("points", "points_valid", "points1", "points1_valid", "gt_boxes",
                       "gt_valid")}
        shapes = jax.eval_shape(lambda: jm.init(rngs, init_batch, True))
        variables = seeded_jax_variables(shapes, 0)
        assert variables["params"]["backbone"]["branch1"]["conv_input"]["kernel"].shape == (
            27, 4, 16)
        pm = build_network(port_cfg.MODEL, len(port_cfg.CLASS_NAMES), port_cfg.DATA_CONFIG)
        pm.load_state_dict(state_dict_from_jax(variables, pm), strict=True)
        pm = set_compute_dtype(pm.eval(), None)
    return batch, jm, variables, pm


def jax_kitti_predict(batch, jm, variables):
    jv = jax.tree_util.tree_map(jnp.asarray, variables)
    jbatch = {"points": jnp.asarray(batch["points"]),
              "points_valid": jnp.asarray(batch["points_valid"])}
    with jax_f32(), jax_nms_with_clip_iou():
        jout = jax.jit(lambda v, b: jm.apply(v, b, False))(jv, jbatch)
        keep = ("batch_box_preds", "batch_cls_preds", "roi_labels", "roi_valid")
        jpred = jax.jit(lambda v, o: jm.apply(v, o, method=type(jm).post_processing))(
            jv, {k: jout[k] for k in keep})
    jout, jpred = jax.device_get((jout, jpred))
    return {"out": {k: jout[k] for k in ("rois", "roi_scores", "roi_valid")},
            "pred": dict(jpred)}


@pytest.mark.slow
def test_kitti_predict_reference_is_regenerated(root):
    batch, jm, variables, _ = _kitti_pair(root)
    refs.assert_regenerated("kitti_predict", jax_kitti_predict(batch, jm, variables))


def test_predict_on_a_kitti_batch_matches_jax(root):
    """The port's predict on the written scans against the JAX side's, the
    committed reference ``kitti_predict``."""
    batch, _, _, pm = _kitti_pair(root)
    ref = refs.load("kitti_predict")
    jout, jpred = ref["out"], ref["pred"]
    with torch.no_grad():
        pout = pm({"points": torch.from_numpy(batch["points"]),
                   "points_valid": torch.from_numpy(batch["points_valid"])})
        ppred = {k: v.float().numpy() for k, v in pm.post_processing(pout).items()}
    np.testing.assert_array_equal(pout["roi_valid"].numpy(), np.asarray(jout["roi_valid"]))
    assert pout["roi_valid"].sum() > 20
    for k in ("rois", "roi_scores"):
        ref = np.asarray(jout[k], np.float32)
        err = np.abs(pout[k].float().numpy() - ref).max()
        assert err <= 1e-4 * max(np.abs(ref).max(), 1e-3), (k, err)
    jpred = {k: np.asarray(v, np.float32) for k, v in jpred.items()}
    n = 0
    for b in range(2):
        pb = {k: v[b] for k, v in ppred.items()}
        rb = {k: v[b] for k, v in jpred.items()}
        p, r, _ = pair_detections(pb, rb)
        np.testing.assert_array_equal(pb["pred_labels"][p], rb["pred_labels"][r])
        box_err = np.abs(pb["pred_boxes"][p] - rb["pred_boxes"][r]).max(-1)
        score_err = np.abs(pb["pred_scores"][p] - rb["pred_scores"][r])
        tight = ((box_err <= 1e-4 * np.abs(rb["pred_boxes"]).max())
                 & (score_err <= 1e-4 * np.abs(rb["pred_scores"]).max()))
        assert tight.mean() >= 0.95 and box_err.max() <= 0.1 and score_err.max() <= 0.01
        n += len(p)
    assert n > 20
