"""The port's pseudo-label factory end to end against the JAX package's, on
the CPU (kernels R1 and R2 through their plain versions).

* ``unsupervised.driver.compute_outline_box`` for the DBSCAN, OYSTER and
  MFCF generators, each refined by C_PROTO with the shipped cproto dataset
  yaml, on one written sequence of 12 small frames from
  ``utils.synthetic.make_lidar_sequence`` (ego motion, moving and parked
  objects). Both packages read the same PPScore files (JAX's; the PPScore
  builders are compared in ``test_torch_port_ppscore.py``). The label
  pickle and the CSS prototype pickle must equal JAX's: integers, ids and
  names exactly, floats within 1e-6.
* The builder CLI: ``test_torch_port_factory_cli.py``.
* The port's and JAX's ``WaymoUnsupervisedDataset`` reading what the port
  wrote give the same samples, and ``create_track_groundtruth_database``
  the same database. Both take the NumPy points-in-box mask: JAX's native
  mask rounds in f32 and the fitted boxes' faces pass through their own
  points, so it moves points on a face in or out (the port has only the
  NumPy path, ``datasets/box_np.py``).
* ``tools.merge_detections.merge_detections_tracking`` equals JAX's.
"""
import copy
import pickle
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from cpd_tpu.datasets import waymo_unsupervised as jwu
from cpd_tpu.unsupervised import driver as jdriver
from cpd_tpu_torch.datasets import waymo_unsupervised as pwu
from cpd_tpu_torch.tools import merge_detections as pmerge
from cpd_tpu_torch.unsupervised import driver as pdriver
from cpd_tpu_torch.utils.synthetic import make_lidar_sequence, write_waymo_sequence
from cpd_tpu_torch.utils.yaml_subset import load_file
from tests.test_torch_port_datasets import CLASSES, WAYMO_CFG, assert_same
from tests.test_torch_port_ppscore import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
YAML = REPO / "tools" / "cfgs" / "dataset_configs" / "waymo_unsupervised_cproto.yaml"
SEQ = "segment-0000"
GENERATORS = ["DBSCAN", "OYSTER", "MFCF"]


def _sequence(seed=1, n_frames=12, n_points=4000):
    return make_lidar_sequence(seed, n_frames=n_frames, n_points=n_points, r_max=14.0,
                               n_parked=3, n_moving=2, n_walls=1)


def _assert_pickles_equal(got, want, path="$"):
    """Integers, ids, bools and names exactly; floats within 1e-6."""
    if isinstance(want, dict):
        assert set(got) == set(want), f"{path}: keys {sorted(got)} vs {sorted(want)}"
        for k in want:
            _assert_pickles_equal(got[k], want[k], f"{path}.{k}")
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, path
    if want.dtype.kind == "f":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6, err_msg=path)
    else:
        np.testing.assert_array_equal(got, want, err_msg=path)


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """One written sequence (frames and poses only) in a JAX and a port
    root, with JAX's PPScore files in both."""
    base = tmp_path_factory.mktemp("factory")
    frames, poses = _sequence()
    seq = write_waymo_sequence(base / "jax", SEQ, frames, poses=poses, labels=False)
    jdriver.save_ppscore(seq)
    shutil.copytree(base / "jax", base / "port")
    return {side: base / side / "waymo_processed_data" for side in ("jax", "port")}


@pytest.mark.parametrize("init", GENERATORS)
def test_compute_outline_box_matches_jax(roots, init):
    cfg = dict(copy.deepcopy(load_file(YAML)), InitLabelGenerator=init)
    for root in roots.values():
        for f in (root / SEQ).glob(f"{SEQ}_outline_*"):
            f.unlink()
    want = jdriver.compute_outline_box(SEQ, roots["jax"], cfg)
    got = pdriver.compute_outline_box(SEQ, roots["port"], cfg, device="cpu")
    _assert_pickles_equal(got, want)
    n_boxes = sum(len(r["outline_box"]) for r in want.values())
    assert n_boxes >= 30 and set(want) == set(range(12))
    for name in ("C_PROTO", f"{init}_CSS_proto"):
        with open(roots["jax"] / SEQ / f"{SEQ}_outline_{name}.pkl", "rb") as f:
            want_pkl = pickle.load(f)
        with open(roots["port"] / SEQ / f"{SEQ}_outline_{name}.pkl", "rb") as f:
            got_pkl = pickle.load(f)
        _assert_pickles_equal(got_pkl, want_pkl)
    assert want_pkl["proto_points_set"], "no prototype bank"
    # the cache: a second call reads the pickle back
    _assert_pickles_equal(pdriver.compute_outline_box(SEQ, roots["port"], cfg, device="cpu"),
                          want)


def test_dataset_and_gt_database_read_the_factory_output(roots, tmp_path, monkeypatch):
    """The MFCF + C_PROTO output as the datasets read it: the port's and
    JAX's ``WaymoUnsupervisedDataset`` (training mode, prototype views)
    give the same samples, and both ``create_track_groundtruth_database``
    the same database."""
    from cpd_tpu.datasets.box_np import points_in_boxes_mask_np

    monkeypatch.setattr(jwu, "points_in_boxes_mask_fast", points_in_boxes_mask_np)
    cfg = dict(copy.deepcopy(load_file(YAML)), InitLabelGenerator="MFCF")
    jdriver.compute_outline_box(SEQ, roots["jax"], cfg)  # cached when written above
    pdriver.compute_outline_box(SEQ, roots["port"], cfg, device="cpu")
    ds_cfg = dict(WAYMO_CFG, POINT_CLOUD_RANGE=[-16, -16, -2, 16, 16, 4])

    def run(mod, root):
        ds = mod.WaymoUnsupervisedDataset(dataset_cfg=ds_cfg, class_names=CLASSES,
                                          training=True, root_path=str(root.parent))
        ds.set_epoch(1)
        counts = mod.create_track_groundtruth_database(ds, tmp_path / f"{mod.__name__}.pkl")
        with open(tmp_path / f"{mod.__name__}.pkl", "rb") as f:
            db = pickle.load(f)
        return len(ds), [ds[i] for i in range(0, len(ds), 3)], counts, db

    port, ref = run(pwu, roots["port"]), run(jwu, roots["jax"])
    assert port[0] == ref[0] == 12
    assert_same(port[1], ref[1])
    assert port[2] == ref[2] and sum(port[2].values()) > 0
    assert_same(port[3], ref[3])
    assert any(s["gt_valid"].any() for s in port[1])


def test_merge_detections_tracking_matches_jax(tmp_path):
    """Both tools on one result.pkl of 10 frames: a mover, a parked box and
    noise boxes; boxes, scores, names and track ids equal."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("jmerge", REPO / "tools" / "merge_detections.py")
    jmerge = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jmerge)
    rng = np.random.default_rng(4)
    dets = []
    for f in range(10):
        boxes = [np.array([2.0 + 1.2 * f, 1.0, 0.8, 4.5, 2.0, 1.6, 0.0]),
                 np.array([15.0, -5.0, 0.8, 4.4, 1.9, 1.5, 1.1])]
        boxes += [rng.uniform(-30, 30, 7) * [1, 1, 0, 0, 0, 0, 1] + [0, 0, 0.5, 1, 1, 1, 0]
                  for _ in range(rng.integers(0, 3))]
        b = (np.asarray(boxes) + rng.normal(0, 0.03, (len(boxes), 7))).astype(np.float32)
        dets.append({"frame_id": f"seq#{f:04d}", "boxes_lidar": b,
                     "score": rng.uniform(0.3, 1, len(b)).astype(np.float32),
                     "name": np.asarray(["Vehicle"] * len(b))})
    with open(tmp_path / "result.pkl", "wb") as f:
        pickle.dump(dets, f)
    got = pmerge.merge_detections_tracking(tmp_path / "result.pkl", tmp_path / "port.pkl")
    want = jmerge.merge_detections_tracking(tmp_path / "result.pkl", tmp_path / "jax.pkl")
    assert len(got) == len(want) == 10
    for g, w in zip(got, want):
        _assert_pickles_equal(g, w)
    assert sum(len(g["track_ids"]) for g in got) >= 15


def test_written_sequence_without_labels(tmp_path):
    """``write_waymo_sequence(..., labels=False)`` writes frames and poses
    only; ``make_lidar_sequence`` is the same from the same seed."""
    frames, poses = _sequence(n_frames=3, n_points=2000)
    again, _ = _sequence(n_frames=3, n_points=2000)
    assert all(np.array_equal(a, b) for a, b in zip(frames, again))
    assert [f.shape for f in frames] == [(2000, 5)] * 3
    seq = write_waymo_sequence(tmp_path, SEQ, frames, poses=poses, labels=False)
    assert sorted(p.name for p in seq.iterdir()) == [
        "0000.npy", "0001.npy", "0002.npy", f"{SEQ}.pkl"]
    loaded = pdriver.load_sequence(seq)
    np.testing.assert_array_equal(loaded[2]["pose"], poses[2])
    assert loaded[1]["pose"][0, 3] == 1.0 and "annos" not in loaded[0]["info"]


def test_factory_entry_points_need_a_card_unless_the_cpu_is_asked_for(roots):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pdriver.compute_outline_box("missing", roots["port"], {})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pwu.create_ppscore(roots["port"], [SEQ], workers=1)
