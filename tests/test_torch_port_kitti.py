"""The port's KITTI reader (cpd_tpu_torch.datasets.kitti) against the JAX
package's, on the CPU, on frames written by ``write_kitti_frames`` (KITTI's
layout, a real calib, Car / Pedestrian / Cyclist labels and a DontCare).

Under Waymo class names every function and dataset method gives the JAX
package's output bit for bit. Under the shipped KITTI yaml's names
``[Car, Pedestrian, Cyclist]`` the JAX reader renames each car to Vehicle
and ``prepare_data`` drops it; the port keeps its cars (``kitti_name``)."""
import pickle

import numpy as np
import pytest

from cpd_tpu.datasets import kitti as jkitti
from cpd_tpu_torch.config import ConfigDict, cfg_from_yaml_file
from cpd_tpu_torch.datasets import kitti
from cpd_tpu_torch.datasets.registry import build_dataset
from cpd_tpu_torch.utils.synthetic import KITTI_CALIB, write_kitti_frames

KITTI_YAML = "tools/cfgs/models/voxel_rcnn_cproto_center_kitti.yaml"
WAYMO_NAMES = ["Vehicle", "Pedestrian", "Cyclist"]
N_FRAMES = 4


def assert_bits(port, ref, path="$"):
    """Same structure, every array equal bit for bit (dtype too)."""
    if isinstance(ref, dict):
        assert set(port) == set(ref), f"{path}: keys {sorted(port)} vs {sorted(ref)}"
        for k in ref:
            assert_bits(port[k], ref[k], f"{path}.{k}")
    elif isinstance(ref, (list, tuple)):
        assert len(port) == len(ref), path
        for i, (a, b) in enumerate(zip(port, ref)):
            assert_bits(a, b, f"{path}[{i}]")
    elif isinstance(ref, np.ndarray):
        assert port.dtype == ref.dtype and port.shape == ref.shape, path
        np.testing.assert_array_equal(port, ref, err_msg=path)
    else:
        assert port == ref, f"{path}: {port!r} vs {ref!r}"


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tmp_path_factory.mktemp("kitti")
    write_kitti_frames(root, N_FRAMES, seed=0, n_points=40_000)
    return root


@pytest.fixture(scope="module")
def data_cfg():
    cfg = cfg_from_yaml_file(KITTI_YAML, ConfigDict())
    return dict(cfg.DATA_CONFIG, POINT_CAP=40_000), list(cfg.CLASS_NAMES)


def _pair(data_cfg, root, names, training):
    return (kitti.Kitti2WaymoDataset(data_cfg, names, training, str(root)),
            jkitti.Kitti2WaymoDataset(data_cfg, names, training, str(root)))


def test_written_frames_are_kitti(root):
    ids = [x.strip() for x in (root / "ImageSets" / "val.txt").read_text().split()]
    assert ids == [f"{i:06d}" for i in range(N_FRAMES)]
    assert (root / "training" / "calib" / "000000.txt").read_text() == KITTI_CALIB
    scan = np.fromfile(root / "training" / "velodyne" / "000001.bin", np.float32)
    assert scan.shape == (40_000 * 4,) and np.isfinite(scan).all()
    names = {ln.split()[0] for i in range(N_FRAMES)
             for ln in (root / "training" / "label_2" / f"{i:06d}.txt").read_text().splitlines()}
    assert names == {"Car", "Pedestrian", "Cyclist", "DontCare"}


def test_calibration_labels_and_box_transforms_equal_jax(root):
    calib_file = root / "training" / "calib" / "000002.txt"
    pc, jc = kitti.Calibration(calib_file), jkitti.Calibration(calib_file)
    for k in ("P2", "R0", "V2C"):
        np.testing.assert_array_equal(getattr(pc, k), getattr(jc, k))
    rng = np.random.default_rng(0)
    pts = rng.uniform(-30, 30, (500, 3))
    np.testing.assert_array_equal(pc.lidar_to_rect(pts), jc.lidar_to_rect(pts))
    np.testing.assert_array_equal(pc.rect_to_lidar(pts), jc.rect_to_lidar(pts))
    assert_bits(pc.rect_to_img(pts), jc.rect_to_img(pts))
    lines = [ln for i in range(N_FRAMES) for ln in
             (root / "training" / "label_2" / f"{i:06d}.txt").read_text().splitlines()]
    po, jo = [kitti.Object3d(ln) for ln in lines], [jkitti.Object3d(ln) for ln in lines]
    for a, b in zip(po, jo):
        assert_bits({k: v for k, v in vars(a).items()}, {k: v for k, v in vars(b).items()})
        assert a.difficulty == b.difficulty
    assert {o.difficulty for o in po} - {3} and len({o.difficulty for o in po}) > 1
    objs_p = [o for o in po if o.cls_type != "DontCare"]
    objs_j = [o for o in jo if o.cls_type != "DontCare"]
    boxes = kitti.boxes_camera_to_lidar(objs_p, pc)
    np.testing.assert_array_equal(boxes, jkitti.boxes_camera_to_lidar(objs_j, jc))
    cam = kitti.boxes_lidar_to_camera(boxes, pc)
    assert_bits(cam, jkitti.boxes_lidar_to_camera(boxes, jc))
    np.testing.assert_array_equal(kitti.camera_boxes_to_image_bboxes(*cam, pc),
                                  jkitti.camera_boxes_to_image_bboxes(*cam, jc))
    # the written labels describe their lidar boxes: the image boxes match
    # within a pixel (the label's box and 3D fields are each rounded to 0.01)
    np.testing.assert_allclose(kitti.camera_boxes_to_image_bboxes(*cam, pc),
                               np.stack([o.box2d for o in objs_p]), rtol=0, atol=1.0)
    assert kitti.boxes_camera_to_lidar([], pc).shape == (0, 7)


@pytest.mark.parametrize("training", [True, False])
def test_dataset_equals_jax_under_waymo_names(root, data_cfg, training):
    port, ref = _pair(data_cfg[0], root, WAYMO_NAMES, training)
    assert len(port) == len(ref) == N_FRAMES
    for ds in (port, ref):
        ds.set_epoch(1)
    assert_bits([port[i] for i in range(N_FRAMES)], [ref[i] for i in range(N_FRAMES)])
    sid = port.sample_ids[1]
    np.testing.assert_array_equal(port.get_lidar(sid), ref.get_lidar(sid))
    pts = port.get_lidar(sid)
    np.testing.assert_array_equal(port.fov_mask(pts, port.get_calib(sid)),
                                  ref.fov_mask(pts, ref.get_calib(sid)))
    assert 0.05 < port.fov_mask(pts, port.get_calib(sid)).mean() < 0.5
    assert_bits(port.collect_gt_annos(), ref.collect_gt_annos())
    sample = port[0]
    assert sample["points"].shape == (40_000, 4) and sample["gt_valid"].sum() > 0
    assert ("points1" in sample) == training


def _predictions(gt_annos, rng):
    """Detections near every gt box, plus a padding row, as the eval step
    returns them."""
    n = max(len(a["name"]) for a in gt_annos) + 1
    b = len(gt_annos)
    boxes = np.zeros((b, n, 7), np.float32)
    scores = np.zeros((b, n), np.float32)
    labels = np.ones((b, n), np.int32)
    valid = np.zeros((b, n), bool)
    for i, a in enumerate(gt_annos):
        k = len(a["name"])
        boxes[i, :k] = a["gt_boxes_lidar"] + rng.normal(0, 0.05, (k, 7)).astype(np.float32)
        scores[i, :k] = rng.uniform(0.3, 1.0, k)
        labels[i, :k] = [WAYMO_NAMES.index(x) + 1 for x in a["name"]]
        valid[i, :k] = True
    return {"pred_boxes": boxes, "pred_scores": scores, "pred_labels": labels,
            "pred_valid": valid}


def test_predictions_and_evaluation_equal_jax(root, data_cfg):
    port, ref = _pair(data_cfg[0], root, WAYMO_NAMES, False)
    gts = port.collect_gt_annos()
    preds = _predictions(gts, np.random.default_rng(1))
    batch = {"batch_size": N_FRAMES, "frame_id": list(port.sample_ids)}
    dets = port.generate_prediction_dicts(batch, preds, WAYMO_NAMES)
    assert_bits(dets, ref.generate_prediction_dicts(batch, preds, WAYMO_NAMES))
    for k in ("location", "dimensions", "rotation_y", "alpha", "bbox"):
        assert k in dets[0]
    got, want = port.evaluation(dets, WAYMO_NAMES), ref.evaluation(dets, WAYMO_NAMES)
    assert got[0] == want[0]
    assert_bits(got[1], want[1])
    assert {f"{c}_3d/moderate_R40" for c in WAYMO_NAMES} | {
        f"{c}_3d/moderate_R11" for c in WAYMO_NAMES} <= set(got[1])
    assert got[1]["Vehicle_bev/moderate_R40"] > 50


def test_infos_and_gt_database_equal_jax(root, data_cfg, tmp_path):
    port, ref = _pair(data_cfg[0], root, WAYMO_NAMES, True)
    assert_bits(kitti.create_kitti_infos(port, tmp_path / "p.pkl"),
                jkitti.create_kitti_infos(ref, tmp_path / "j.pkl"))
    counts = kitti.create_kitti_groundtruth_database(port, tmp_path / "pdb.pkl")
    assert counts == jkitti.create_kitti_groundtruth_database(ref, tmp_path / "jdb.pkl")
    assert set(counts) == set(WAYMO_NAMES) and min(counts.values()) > 0
    dbs = []
    for name in ("pdb.pkl", "jdb.pkl"):
        with open(tmp_path / name, "rb") as f:
            dbs.append(pickle.load(f))
    assert_bits(*dbs)


def test_shipped_names_keep_the_cars_that_jax_drops(root, data_cfg, tmp_path):
    """The shipped KITTI yaml's ``[Car, Pedestrian, Cyclist]``: the JAX
    reader names each car Vehicle, ``prepare_data`` drops it, and its gt
    annotations say Vehicle while detections are named Car; the port keeps
    the cars as Car (label 1) in samples, annotations, infos and gt
    database. Pedestrians and cyclists are the same in both."""
    cfg, names = data_cfg
    assert names == ["Car", "Pedestrian", "Cyclist"]
    port, ref = _pair(cfg, root, names, True)
    cars = port_cars = ref_cars = 0
    for i in range(N_FRAMES):
        labels = [ln.split()[0] for ln in
                  (root / "training" / "label_2" / f"{port.sample_ids[i]}.txt").read_text()
                  .splitlines()]
        p, j = port[i], ref[i]
        cars += labels.count("Car")
        port_cars += int((p["gt_boxes"][p["gt_valid"], 7] == 1).sum())
        ref_cars += int((j["gt_boxes"][j["gt_valid"], 7] == 1).sum())
        others = sum(labels.count(c) for c in ("Pedestrian", "Cyclist"))
        assert p["gt_valid"].sum() == others + labels.count("Car")
        assert j["gt_valid"].sum() == others
    assert cars > 0 and port_cars == cars and ref_cars == 0
    pg, jg = port.collect_gt_annos(), ref.collect_gt_annos()
    assert "Car" in set(np.concatenate([a["name"] for a in pg]))
    assert "Vehicle" in set(np.concatenate([a["name"] for a in jg]))
    assert "Car" not in set(np.concatenate([a["name"] for a in jg]))
    infos = kitti.create_kitti_infos(port, tmp_path / "infos.pkl")
    assert "Car" in set(np.concatenate([i["annos"]["name"] for i in infos]))
    counts = kitti.create_kitti_groundtruth_database(port, tmp_path / "db.pkl")
    assert set(counts) == {"Car", "Pedestrian", "Cyclist"}
    assert set(jkitti.create_kitti_groundtruth_database(ref, tmp_path / "jdb.pkl")) == {
        "Vehicle", "Pedestrian", "Cyclist"}


def test_registry_builds_the_kitti_reader(root, data_cfg):
    cfg, names = data_cfg
    ds = build_dataset(cfg, names, False, str(root))
    assert isinstance(ds, kitti.Kitti2WaymoDataset) and ds.split == "val" and len(ds) == N_FRAMES
    with pytest.raises(KeyError, match="'NoSuchDataset'"):
        build_dataset(dict(cfg, DATASET="NoSuchDataset"), names, False, str(root))
