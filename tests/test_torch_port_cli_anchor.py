"""Both CLIs of the port on the anchor-head yamls, on the CPU.

* The training CLI (``cpd_tpu_torch.tools.train``) on the DBSCAN and the
  OYSTER VoxelRCNN yamls, cut through ``--set`` as
  tests/test_torch_port_cli_train.py cuts the shipped yaml (16 m square,
  0.25 m voxels, 2048 points and voxels, stage caps 1024 to 256, 16 RoIs an
  image; every width the yaml's), on a written sequence of 4 frames whose
  prototype banks carry the yaml's InitLabelGenerator in their name (the
  label file is the default LabelRefiner's, C_PROTO), batch 2,
  ``--debug_steps 2 --eval_after 1``: finite anchor and RoI losses, one
  metrics record a step, the evaluation's result.pkl. OYSTER's
  ``gt_sampling`` reads a written DB_INFO_PATH pickle and pastes objects.
* Pasted objects leave the JAX package's CSS scores one row per original
  label, so its ``prepare_data`` raises an IndexError; the port's
  augmentor gives them CSS 1 and no prototype (both shown here).
* The evaluation CLI on the DBSCAN yaml against the JAX package's
  ``tools/test.py``, as tests/test_torch_port_cli_eval.py holds the CenterHead
  yaml: 8 written frames, the scale overrides of
  tests/test_torch_port_anchor_models.py, the same seeded weights (f32);
  result.pkl paired by box, names and labels exact, 95% of the pairs within
  1e-4 of the scale, all within 0.2 m and 0.01. The RoI head is
  discontinuous in its proposals (its grid points are looked up in voxels),
  and this model's random RoI towers turn a proposal that moved by f32
  rounding into up to 0.144 m (at most one detection of about 63 a frame
  outside the 1e-4 tier; the CenterHead yaml's stayed within 0.1 m).
  tests/test_torch_port_anchor_models.py holds the RoI head on the same
  proposals to 1e-4.
"""
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cpd_tpu import config as jconfig
from cpd_tpu.models import detector as jdet
from cpd_tpu.parallel.trainer import TrainState
from cpd_tpu_torch import config
from cpd_tpu_torch.datasets.waymo_unsupervised import WaymoUnsupervisedDataset
from cpd_tpu_torch.models import build_network
from cpd_tpu_torch.models.detector import set_compute_dtype
from cpd_tpu_torch.tools import test as port_eval
from cpd_tpu_torch.tools import train as port_train
from cpd_tpu_torch.utils.checkpoint import save_checkpoint
from cpd_tpu_torch.utils.synthetic import (make_lidar_frame, write_gt_database,
                                           write_waymo_sequence)
from cpd_tpu_torch.utils.weights import state_dict_from_jax
from tests import torch_port_refs as refs
from tests.test_torch_port_anchor_models import ANCHOR_SETS
from tests.test_torch_port_build_network import RANGE, jax_f32, jax_shapes, load_pair
from tests.test_torch_port_cli_eval import _frames, _pairs
from tests.test_torch_port_cli_train import SHRINK_SETS
from tests.test_torch_port_models import jax_nms_with_clip_iou, seeded_jax_variables

DBSCAN = "tools/cfgs/models/voxel_rcnn_dbscan_single_train.yaml"
OYSTER = "tools/cfgs/models/voxel_rcnn_oyster_single_train.yaml"
SEQ = "segment-0000"
HALF = 8.0
# the shrink of the CenterHead yaml, with the anchor yamls' RoI NMS cut too
ANCHOR_SHRINK_SETS = SHRINK_SETS + [
    "MODEL.ROI_HEAD.NMS_CONFIG.TRAIN.NMS_POST_MAXSIZE", "64",
    "MODEL.ROI_HEAD.NMS_CONFIG.TEST.NMS_POST_MAXSIZE", "32",
]
DB_NAME = "pcdet_waymo_track_dbinfos_train_cp.pkl"  # the OYSTER yaml's DB_INFO_PATH


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread, as in tests/test_torch_port_cli_train.py."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _write_train_data(root, generator):
    frames = []
    for i in range(4):
        pts, _ = make_lidar_frame(np.random.default_rng([5, i]), 20_000)
        frames.append(pts[(np.abs(pts[:, 0]) < HALF) & (np.abs(pts[:, 1]) < HALF)])
    write_waymo_sequence(root, SEQ, frames, seed=2, n_boxes=6, r_max=HALF - 1.0, protos=True,
                         init_label_generator=generator)
    write_gt_database(root / DB_NAME, seed=3, r_max=HALF - 1.0)


def _train_sets(root):
    return ["DATA_CONFIG.DATA_PATH", str(root), *ANCHOR_SHRINK_SETS]


@pytest.mark.parametrize("yaml,generator", [(DBSCAN, "DBSCAN"), (OYSTER, "OYSTER")],
                         ids=["dbscan", "oyster"])
def test_train_cli_runs_the_anchor_yaml(tmp_path, yaml, generator, monkeypatch):
    import json
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    _write_train_data(tmp_path, generator)
    out = tmp_path / "out"
    state = port_train.main(["--cfg_file", yaml, "--batch_size", "2", "--workers", "2",
                             "--device", "cpu", "--output_dir", str(out), "--epochs", "1",
                             "--debug_steps", "2", "--log_every", "1", "--eval_after", "1",
                             "--set", *_train_sets(tmp_path)])
    assert state.step == 2 and state.model.dense_head_name == "AnchorHeadSingleV2"
    recs = [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs] == [1, 2]
    for r in recs:
        assert {"rpn_cls", "rpn_reg", "rpn_dir", "rpn_loss", "rcnn_cls0", "rcnn_reg0",
                "total_loss", "grad_norm"} <= set(r)
        assert "proto_loss" not in r and "hm_loss" not in r
        assert all(np.isfinite(v) for v in r.values()), r
        assert r["skipped_nonfinite"] == 0.0 and r["rpn_cls"] > 0
    assert (out / "eval_epoch_0" / "result.pkl").exists()
    if generator == "OYSTER":
        cfg = config.cfg_from_list(_train_sets(tmp_path), config.cfg_from_yaml_file(
            yaml, config.ConfigDict()))
        ds = WaymoUnsupervisedDataset(dataset_cfg=cfg.DATA_CONFIG, class_names=cfg.CLASS_NAMES,
                                      training=True, root_path=str(tmp_path))
        assert ds.data_augmentor.queue[0][0] == "gt_sampling"
        pasted = sum(int(((ds[i]["proto_group_id"] == -1) & ds[i]["gt_valid"]).sum())
                     for i in range(len(ds)))
        assert pasted > 0


def test_jax_dataset_raises_where_gt_sampling_pastes(tmp_path):
    """A reference-side fault: the JAX dataset's ``prepare_data`` indexes the
    CSS scores of the prototype labels with the mask of all labels, pasted
    ones included. The port's sample has them row for row."""
    from cpd_tpu.datasets.waymo_unsupervised import WaymoUnsupervisedDataset as JDataset
    _write_train_data(tmp_path, "OYSTER")
    port_cfg, jax_cfg = load_pair(OYSTER, _train_sets(tmp_path))
    jds = JDataset(dataset_cfg=jax_cfg.DATA_CONFIG, class_names=jax_cfg.CLASS_NAMES,
                   training=True, root_path=str(tmp_path))
    with pytest.raises(IndexError, match="boolean index did not match"):
        jds[0]
    ds = WaymoUnsupervisedDataset(dataset_cfg=port_cfg.DATA_CONFIG,
                                  class_names=port_cfg.CLASS_NAMES, training=True,
                                  root_path=str(tmp_path))
    sample = ds[0]
    gv = sample["gt_valid"]
    assert (sample["proto_group_id"][gv] == -1).any() and (sample["proto_group_id"][gv] >= 0).any()
    np.testing.assert_array_equal(sample["css_score"][gv & (sample["proto_group_id"] == -1)], 1.0)


def _eval_argv(root, out, *extra):
    return ["--cfg_file", DBSCAN, "--batch_size", "8", "--workers", "2", "--output_dir", str(out),
            *extra, "--set", "DATA_CONFIG.DATA_PATH", str(root),
            "DATA_CONFIG.SAMPLED_INTERVAL.test", "1", *ANCHOR_SETS]


def _eval_sequence(tmp_path_factory):
    root = tmp_path_factory.mktemp("waymo_cli_anchor")
    write_waymo_sequence(root, SEQ, _frames(), seed=3, n_boxes=6, r_max=RANGE - 1.0)
    return root


def _jax_weights():
    _, jax_cfg = load_pair(DBSCAN, ANCHOR_SETS)
    with jax_f32():
        jm = jdet.build_network(jax_cfg.MODEL, len(jax_cfg.CLASS_NAMES), jax_cfg.DATA_CONFIG)
        return jm, seeded_jax_variables(jax_shapes(jm), 0)


def jax_eval_reference(root, jm, variables):
    """result.pkl of the JAX CLI (a TrainState with the seeded weights)."""
    from tools import test as jax_cli
    tx = optax.sgd(0.1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("JAX_COMPILATION_CACHE_DIR", str(root / "jax_cache"))
        jconfig.cfg.clear()
        try:
            with jax_f32(), jax_nms_with_clip_iou():
                jv = jax.tree_util.tree_map(jnp.asarray, variables)
                state = TrainState(step=jnp.zeros((), jnp.int32), params=jv["params"],
                                   batch_stats=jv["batch_stats"], opt_state=tx.init(jv["params"]),
                                   tx=tx, apply_fn=jm.apply)
                jax_cli.main(_eval_argv(root, root / "jax"), state=state)
        finally:
            jconfig.cfg.clear()
            jconfig.cfg["LOCAL_RANK"] = 0
    with open(root / "jax" / "result.pkl", "rb") as f:
        return {"results": pickle.load(f)}


@pytest.fixture(scope="module")
def eval_results(tmp_path_factory):
    """result.pkl of the port CLI (the seeded weights through a checkpoint)
    and the JAX CLI's, the committed reference ``cli_anchor_eval``."""
    root = _eval_sequence(tmp_path_factory)
    port_cfg, _ = load_pair(DBSCAN, ANCHOR_SETS)
    _, variables = _jax_weights()
    parts = (port_cfg.MODEL, len(port_cfg.CLASS_NAMES), port_cfg.DATA_CONFIG)
    model = build_network(*parts)
    model.load_state_dict(state_dict_from_jax(variables, model), strict=True)
    ckpt = save_checkpoint(root / "ckpt", model, 0)
    port_eval.main(_eval_argv(root, root / "port", "--ckpt", str(ckpt), "--device", "cpu"),
                   state=set_compute_dtype(build_network(*parts), None))
    with open(root / "port" / "result.pkl", "rb") as f:
        port = pickle.load(f)
    return {"jax": refs.load("cli_anchor_eval")["results"], "port": port}


@pytest.mark.slow
def test_cli_anchor_eval_reference_is_regenerated(tmp_path_factory):
    root = _eval_sequence(tmp_path_factory)
    refs.assert_regenerated("cli_anchor_eval", jax_eval_reference(root, *_jax_weights()))


def test_eval_cli_result_pkl_matches_the_jax_cli(eval_results):
    port, ref = eval_results["port"], eval_results["jax"]
    assert [a["frame_id"] for a in port] == [a["frame_id"] for a in ref] == [
        f"{SEQ}#{i:04d}" for i in range(8)]
    box_scale = max(np.abs(a["boxes_lidar"]).max() for a in ref)
    score_scale = max(np.abs(a["score"]).max() for a in ref)
    n, tight = 0, 0
    for a, b in zip(port, ref):
        assert set(a) == set(b)
        p, r = _pairs(a, b)
        np.testing.assert_array_equal(a["name"][p], b["name"][r])
        np.testing.assert_array_equal(a["pred_labels"][p], b["pred_labels"][r])
        box_err = np.abs(a["boxes_lidar"][p] - b["boxes_lidar"][r]).max(-1)
        score_err = np.abs(a["score"][p] - b["score"][r])
        assert box_err.max() <= 0.2 and score_err.max() <= 0.01, (box_err.max(), score_err.max())
        tight += int(((box_err <= 1e-4 * box_scale) & (score_err <= 1e-4 * score_scale)).sum())
        n += len(p)
    assert n > 100 and tight >= 0.95 * n, (tight, n)
