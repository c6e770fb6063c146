"""The port's evaluation CLI (``python -m cpd_tpu_torch.tools.test``)
against the JAX package's ``tools/test.py``, on the CPU.

One Waymo-layout sequence of 8 lidar frames (``write_waymo_sequence``), the
shipped voxel_rcnn_cproto_center.yaml with the scale overrides of
``SCALE_SETS`` (no width changes) and the same seeded weights: the JAX CLI
evaluates a TrainState holding them (f32 through ``jax_f32``, NMS under
``jax_nms_with_clip_iou``); the port CLI loads them from a checkpoint that
the port's ``save_checkpoint`` wrote after ``state_dict_from_jax``, into an
f32 model. Between the two runs the frames' gt boxes become the JAX run's
detections, so that the AP values are not all zero; the JAX reference dict
is the JAX CLI's own evaluation of its result.pkl against those.

``result.pkl``: frame ids exact, the same number of detections, paired by
box with names and labels exact; at least 95% of the pairs within 1e-4 of
the scale in box and score, every pair within 0.1 m and 0.01 (the RoI grid
points are looked up in voxels: see tests/test_torch_port_build_network.py,
which holds the RoI head to 1e-4 on the same proposals). The result dicts:
the same keys, and the difference between them accounted for by the pairs
outside the 1e-4 tier (``test_result_dict_matches_the_jax_cli``).
"""
import logging
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cpd_tpu import config as jconfig
from cpd_tpu.models import detector as jdet
from cpd_tpu.parallel.trainer import TrainState
from cpd_tpu_torch.models import build_network
from cpd_tpu_torch.models.detector import set_compute_dtype
from cpd_tpu_torch.tools import test as port_cli
from cpd_tpu_torch.utils.checkpoint import save_checkpoint
from cpd_tpu_torch.utils.synthetic import make_lidar_frame, write_waymo_sequence
from cpd_tpu_torch.utils.weights import state_dict_from_jax
from tests import torch_port_refs as refs
from tests.test_torch_port_build_network import (RANGE, SCALE_SETS, SHIPPED, jax_f32, jax_shapes,
                                                 load_pair, pair_detections)
from tests.test_torch_port_models import jax_nms_with_clip_iou, seeded_jax_variables

REPO = Path(__file__).resolve().parents[1]
SEQ = "segment-0000"
N_FRAMES = 8


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread, as in tests/test_torch_port_cli_train.py: beside
    the other test workers, torch's threads wait on busy cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _frames():
    out = []
    for i in range(N_FRAMES):
        pts, _ = make_lidar_frame(np.random.default_rng([7, i]), 20_000)
        out.append(pts[(np.abs(pts[:, 0]) < RANGE) & (np.abs(pts[:, 1]) < RANGE)][:3500])
    return out


def _port_model(variables):
    """The port's model with the JAX weights, f32."""
    model = build_network(*_port_parts())
    model.load_state_dict(state_dict_from_jax(variables, model), strict=True)
    return set_compute_dtype(model, None)


def _port_parts():
    port_cfg, _ = load_pair(SHIPPED, SCALE_SETS)
    return port_cfg.MODEL, len(port_cfg.CLASS_NAMES), port_cfg.DATA_CONFIG


def _argv(root, out, *extra):
    return ["--cfg_file", SHIPPED, "--batch_size", "8", "--workers", "2", "--output_dir", str(out),
            *extra, "--set", "DATA_CONFIG.DATA_PATH", str(root),
            "DATA_CONFIG.SAMPLED_INTERVAL.test", "1", *SCALE_SETS]


def _set_gt(root, det_annos, n_max=6):
    """The sequence's gt annos <- the highest-scoring detections of each frame."""
    info_path = root / "waymo_processed_data" / SEQ / f"{SEQ}.pkl"
    with open(info_path, "rb") as f:
        infos = pickle.load(f)
    for info, det in zip(infos, det_annos):
        top = np.argsort(-det["score"])[:n_max]
        info["annos"] = {"gt_boxes_lidar": det["boxes_lidar"][top].astype(np.float32),
                         "name": det["name"][top], "num_points_in_gt": np.full(len(top), 50),
                         "difficulty": np.zeros(len(top))}
    with open(info_path, "wb") as f:
        pickle.dump(infos, f)


def _jax_scored(det_annos, root):
    """What the JAX CLI's evaluation makes of ``det_annos``: its dataset's
    ``evaluation`` and ``recall_stats`` against the sequence's gt annos."""
    from cpd_tpu.datasets.waymo_unsupervised import WaymoUnsupervisedDataset
    from cpd_tpu.evaluation.ap import recall_stats
    _, jax_cfg = load_pair(SHIPPED, SCALE_SETS + ["DATA_CONFIG.DATA_PATH", str(root),
                                                  "DATA_CONFIG.SAMPLED_INTERVAL.test", "1"])
    ds = WaymoUnsupervisedDataset(dataset_cfg=jax_cfg.DATA_CONFIG, class_names=jax_cfg.CLASS_NAMES,
                                  training=False, root_path=str(root))
    _, out = ds.evaluation(det_annos, jax_cfg.CLASS_NAMES)
    out.update(recall_stats(det_annos, ds.collect_gt_annos()[: len(det_annos)]))
    return out


def jax_weights():
    """The JAX model built from the cut yaml and its seeded variables."""
    _, jax_cfg = load_pair(SHIPPED, SCALE_SETS)
    with jax_f32():
        jm = jdet.build_network(jax_cfg.MODEL, len(jax_cfg.CLASS_NAMES), jax_cfg.DATA_CONFIG)
        return jm, seeded_jax_variables(jax_shapes(jm), 0)


def jax_cli_reference(root, jm, variables):
    """What the JAX CLI makes of the written sequence under ``root`` with
    the seeded weights: its result.pkl, its result dict, whether it wrote a
    log with its frame rate, and the JAX evaluation of that result.pkl once
    the sequence's gt boxes are its detections (``_set_gt``)."""
    from tools import test as jax_cli
    tx = optax.sgd(0.1)
    # the JAX create_logger gives a log file only to a logger without one: a
    # file left by an earlier JAX CLI run in this process would take the lines
    jax_logger = logging.getLogger("cpd_tpu")
    for h in [h for h in jax_logger.handlers if isinstance(h, logging.FileHandler)]:
        jax_logger.removeHandler(h)
        h.close()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("JAX_COMPILATION_CACHE_DIR", str(root / "jax_cache"))
        jconfig.cfg.clear()
        try:
            with jax_f32(), jax_nms_with_clip_iou():
                jv = jax.tree_util.tree_map(jnp.asarray, variables)
                state = TrainState(step=jnp.zeros((), jnp.int32), params=jv["params"],
                                   batch_stats=jv["batch_stats"], opt_state=tx.init(jv["params"]),
                                   tx=tx, apply_fn=jm.apply)
                first = jax_cli.main(_argv(root, root / "jax"), state=state)
        finally:
            jconfig.cfg.clear()
            jconfig.cfg["LOCAL_RANK"] = 0
    with open(root / "jax" / "result.pkl", "rb") as f:
        results = pickle.load(f)
    _set_gt(root, results)
    return {"results": results, "first": {k: float(v) for k, v in first.items()},
            "log_has_rate": "f/s" in (root / "jax" / "log_eval.txt").read_text(),
            "scored": {k: float(v) for k, v in _jax_scored(results, root).items()}}


def _written_sequence(tmp_path_factory):
    root = tmp_path_factory.mktemp("waymo_cli")
    write_waymo_sequence(root, SEQ, _frames(), seed=3, n_boxes=6, r_max=RANGE - 1.0)
    return root


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """The JAX CLI's run is the committed reference ``cli_eval``; the
    sequence's gt boxes then become its detections, and the port CLI runs
    against those. The JAX reference dict is the JAX CLI's evaluation of its
    result.pkl against the same gt."""
    root = _written_sequence(tmp_path_factory)
    _, variables = jax_weights()
    ref = refs.load("cli_eval")
    results = {"jax": ref["results"]}
    assert ref["first"]["gt_count"] == N_FRAMES * 6  # the written boxes, before they are replaced
    assert ref["log_has_rate"]
    _set_gt(root, results["jax"])

    ckpt = save_checkpoint(root / "ckpt", _port_model(variables), 0)
    port_model = set_compute_dtype(build_network(*_port_parts()), None)
    port_result = port_cli.main(_argv(root, root / "port", "--ckpt", str(ckpt), "--device", "cpu"),
                                state=port_model)
    with open(root / "port" / "result.pkl", "rb") as f:
        results["port"] = pickle.load(f)
    return root, ckpt, port_result, ref["scored"], results


@pytest.mark.slow
def test_cli_eval_reference_is_regenerated(tmp_path_factory):
    """The committed ``cli_eval`` reference is what the JAX CLI writes now."""
    root = _written_sequence(tmp_path_factory)
    refs.assert_regenerated("cli_eval", jax_cli_reference(root, *jax_weights()))


def _pairs(port, ref):
    """Port detection -> JAX detection of one frame's annos, paired by box."""
    p, r, _ = pair_detections(
        {"pred_boxes": port["boxes_lidar"], "pred_valid": np.ones(len(port["score"]), bool)},
        {"pred_boxes": ref["boxes_lidar"], "pred_valid": np.ones(len(ref["score"]), bool)})
    return p, r


def test_result_pkl_matches_the_jax_cli(cli_runs):
    *_, results = cli_runs
    port, ref = results["port"], results["jax"]
    assert [a["frame_id"] for a in port] == [a["frame_id"] for a in ref] == [
        f"{SEQ}#{i:04d}" for i in range(N_FRAMES)]
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
        assert box_err.max() <= 0.1 and score_err.max() <= 0.01, (box_err.max(), score_err.max())
        tight += int(((box_err <= 1e-4 * box_scale) & (score_err <= 1e-4 * score_scale)).sum())
        n += len(p)
    assert n > 100 and tight >= 0.95 * n, (tight, n)


def _scored(det_annos, gt_annos):
    from cpd_tpu_torch.evaluation.ap import recall_stats, waymo_style_eval
    _, out = waymo_style_eval(det_annos, gt_annos, ["Vehicle", "Pedestrian", "Cyclist"])
    out.update(recall_stats(det_annos, gt_annos))
    return out


def test_result_dict_matches_the_jax_cli(cli_runs):
    """The port CLI's dict scores its own result.pkl; and the port's
    detections, with the pairs outside the 1e-4 tier taken from the JAX run,
    score the JAX dict (within 1e-6 of it, relative 1e-5: APH reads the
    headings, which differ at rounding level): the dicts differ only through
    those detections (a thin box moved by a centimetre can leave its gt's
    IoU threshold)."""
    root, _, port, ref, results = cli_runs
    assert list(port) == list(ref)
    assert port["gt_count"] == ref["gt_count"] == N_FRAMES * 6
    assert port["Vehicle_L1/AP"] > 50 and port["recall_0.7"] > 0.9
    with open(root / "waymo_processed_data" / SEQ / f"{SEQ}.pkl", "rb") as f:
        gts = [dict(i["annos"]) for i in pickle.load(f)]
    scored = _scored(results["port"], gts)
    np.testing.assert_allclose([scored[k] for k in port], list(port.values()), rtol=0, atol=1e-6)
    hybrid = []
    box_scale = max(np.abs(a["boxes_lidar"]).max() for a in results["jax"])
    score_scale = max(np.abs(a["score"]).max() for a in results["jax"])
    for a, b in zip(results["port"], results["jax"]):
        p, r = _pairs(a, b)
        loose = ((np.abs(a["boxes_lidar"][p] - b["boxes_lidar"][r]).max(-1) > 1e-4 * box_scale)
                 | (np.abs(a["score"][p] - b["score"][r]) > 1e-4 * score_scale))
        h = {k: np.array(v) for k, v in a.items() if k != "frame_id"}
        for k in ("boxes_lidar", "score"):
            h[k][p[loose]] = b[k][r[loose]]
        hybrid.append(dict(h, frame_id=a["frame_id"]))
    scored = _scored(hybrid, gts)
    np.testing.assert_allclose([scored[k] for k in ref], list(ref.values()), rtol=1e-5, atol=1e-6)


def test_outputs_are_written(cli_runs):
    """The port CLI's outputs; the JAX CLI's were checked when its
    reference was written (``log_has_rate``)."""
    root = cli_runs[0]
    assert (root / "port" / "result.pkl").exists()
    assert "f/s" in (root / "port" / "log_eval.txt").read_text()


def test_eval_all_polls_the_checkpoint_dir(cli_runs, monkeypatch):
    root, ckpt, *_ = cli_runs
    save_checkpoint(root / "ckpt", _loaded(ckpt), 1)
    monkeypatch.setattr(port_cli.time, "sleep", lambda s: None)
    argv = _argv(root, root / "all", "--eval_all", "--ckpt_dir", str(root / "ckpt"),
                 "--max_waiting_mins", "1", "--start_epoch", "1", "--debug_steps", "1",
                 "--device", "cpu")
    argv[argv.index("--batch_size") + 1] = "1"
    out = port_cli.main(argv)
    assert sorted(out) == [1]
    assert (root / "all" / "epoch_1" / "result.pkl").exists()


def _loaded(ckpt):
    model = build_network(*_port_parts())
    model.load_state_dict(torch.load(ckpt, weights_only=True)["model_state"], strict=True)
    return model


def test_without_a_card_the_cli_raises_unless_asked_for_the_cpu(tmp_path):
    with pytest.raises(RuntimeError, match="no CUDA card"):
        port_cli.main(["--cfg_file", SHIPPED, "--output_dir", str(tmp_path)])


def test_module_entry_point_runs_without_jax_yaml_or_cpd_tpu(cli_runs, tmp_path):
    root, ckpt, *_ = cli_runs
    argv = ["cpd_tpu_torch.tools.test"] + _argv(root, tmp_path / "out", "--ckpt", str(ckpt),
                                                "--device", "cpu", "--debug_steps", "1")
    argv[argv.index("--batch_size") + 1] = "1"
    code = ("import runpy, sys\n"
            f"sys.argv = {argv!r}\n"
            "runpy.run_module('cpd_tpu_torch.tools.test', run_name='__main__')\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'yaml', 'cpd_tpu')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert (tmp_path / "out" / "result.pkl").exists()
