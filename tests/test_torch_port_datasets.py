"""The port's data layer (cpd_tpu_torch.datasets) against the JAX package's,
on the CPU: the same NumPy inputs, made from a seed, through both.

Every module is a NumPy copy, so integers, names, keys and booleans match
exactly and floats within 1e-6. The one difference by design is
``points_in_boxes_mask_fast``: the JAX package uses its C++ library
``cpd_tpu.native`` where that builds, the port the NumPy path; the two masks
are held equal where the library loads."""
import pickle

import numpy as np
import pytest

from cpd_tpu.datasets import augmentor as jaug
from cpd_tpu.datasets import box_np as jbox
from cpd_tpu.datasets import dataset as jds
from cpd_tpu.datasets import loader as jloader
from cpd_tpu.datasets import point_ops as jpo
from cpd_tpu.datasets import processor as jproc
from cpd_tpu.datasets.waymo_unsupervised import WaymoUnsupervisedDataset as JWaymo
from cpd_tpu_torch.datasets import augmentor, box_np, dataset, loader, point_ops, processor
from cpd_tpu_torch.datasets.waymo_unsupervised import WaymoUnsupervisedDataset
from cpd_tpu_torch.unsupervised.cproto import box_frame_inverse
from cpd_tpu_torch.unsupervised.ppscore import points_rigid_transform
from cpd_tpu_torch.utils.synthetic import write_waymo_sequence

CLASSES = ["Vehicle", "Pedestrian", "Cyclist"]


def assert_same(port, ref, path="$"):
    """Same structure; arrays: integers, bools and strings equal, floats
    within 1e-6."""
    if isinstance(ref, dict):
        assert set(port) == set(ref), f"{path}: keys {sorted(port)} vs {sorted(ref)}"
        for k in ref:
            assert_same(port[k], ref[k], f"{path}.{k}")
    elif isinstance(ref, (list, tuple)) and not (ref and isinstance(ref[0], (str, int))):
        assert len(port) == len(ref), path
        for i, (a, b) in enumerate(zip(port, ref)):
            assert_same(a, b, f"{path}[{i}]")
    elif isinstance(ref, np.ndarray) and ref.dtype.kind == "f":
        assert port.shape == ref.shape and port.dtype == ref.dtype, path
        np.testing.assert_allclose(port, ref, rtol=0, atol=1e-6, err_msg=path)
    elif isinstance(ref, np.ndarray):
        assert port.dtype == ref.dtype, path
        np.testing.assert_array_equal(port, ref, err_msg=path)
    else:
        assert port == ref, f"{path}: {port!r} vs {ref!r}"


def _boxes(rng, n, spread=15.0):
    b = np.zeros((n, 7), np.float32)
    b[:, :2] = rng.uniform(-spread, spread, (n, 2))
    b[:, 2] = rng.uniform(-1, 1, n)
    b[:, 3:6] = rng.uniform(0.5, 5.0, (n, 3))
    b[:, 6] = rng.uniform(-np.pi, np.pi, n)
    return b


def _points(rng, n, spread=20.0, c=5):
    p = rng.uniform(-spread, spread, (n, c)).astype(np.float32)
    p[:, 2] = rng.uniform(-2, 4, n)
    return p


def test_box_np_equals_jax():
    rng = np.random.default_rng(0)
    pts, boxes = _points(rng, 5000), _boxes(rng, 12)
    pcr = np.array([-10, -12, -1, 10, 12, 3], np.float32)
    for fn in ("points_in_boxes_mask_np", "points_in_boxes_mask_fast"):
        np.testing.assert_array_equal(getattr(box_np, fn)(pts[:, :3], boxes),
                                      jbox.points_in_boxes_mask_np(pts[:, :3], boxes), err_msg=fn)
    np.testing.assert_array_equal(box_np.points_in_box_np(pts, boxes[0]),
                                  jbox.points_in_box_np(pts, boxes[0]))
    np.testing.assert_array_equal(box_np.mask_points_by_range_np(pts, pcr),
                                  jbox.mask_points_by_range_np(pts, pcr))
    assert_same(box_np.boxes_to_corners_3d_np(boxes), jbox.boxes_to_corners_3d_np(boxes))
    assert box_np.points_in_boxes_mask_fast(pts, boxes[:0]).shape == (0, 5000)


def test_numpy_mask_equals_the_native_library():
    """The JAX package's fast path where its C++ library loads: the port's
    NumPy mask is the same, also on points placed on the box faces."""
    from cpd_tpu import native
    if not native.available():
        pytest.skip("the JAX package's C++ library does not build here")
    rng = np.random.default_rng(1)
    pts, boxes = _points(rng, 20000), _boxes(rng, 32)
    faces = boxes[:, None, :3] + np.stack([boxes[:, 3] / 2, np.zeros(32), np.zeros(32)], -1)[:, None]
    pts = np.concatenate([pts[:, :3], faces.reshape(-1, 3).astype(np.float32)])
    np.testing.assert_array_equal(box_np.points_in_boxes_mask_fast(pts, boxes),
                                  native.points_in_boxes_mask(pts, boxes))


def test_point_ops_equal_jax():
    rng = np.random.default_rng(2)
    pts, boxes = _points(rng, 4000), _boxes(rng, 6)
    assert_same(list(point_ops.box_cut(pts, boxes, (0.2, 0.2, 0.1))),
                list(jpo.box_cut(pts, boxes, (0.2, 0.2, 0.1))))
    assert_same(point_ops.la_sampling(pts), jpo.la_sampling(pts))
    assert_same(point_ops.random_drop_out(pts, 0.5, np.random.default_rng(3)),
                jpo.random_drop_out(pts, 0.5, np.random.default_rng(3)))
    assert_same(point_ops.radius_sampling(pts), jpo.radius_sampling(pts))
    names = np.asarray(["Vehicle"] * 6)
    assert_same(list(point_ops.remove_past(pts, boxes, names, 10.0)),
                list(jpo.remove_past(pts, boxes, names, 10.0)))
    pose = np.eye(4)
    pose[:3, :3] = [[0.6, -0.8, 0], [0.8, 0.6, 0], [0, 0, 1]]
    pose[:3, 3] = [1.0, -2.0, 0.5]
    from cpd_tpu.unsupervised import cproto as jcproto
    from cpd_tpu.unsupervised import ppscore as jppscore
    assert_same(points_rigid_transform(pts, pose), jppscore.points_rigid_transform(pts, pose))
    assert_same(box_frame_inverse(pts[:, :3], boxes[0]),
                jcproto.box_frame_inverse(pts[:, :3], boxes[0]))


PROCESSORS = [
    {"NAME": "mask_points_and_boxes_outside_range", "REMOVE_OUTSIDE_BOXES": True},
    {"NAME": "shuffle_points", "SHUFFLE_ENABLED": {"train": True, "test": False}},
    {"NAME": "sample_points", "NUM_POINTS": {"train": 1500, "test": 3000}},
    {"NAME": "transform_points_to_voxels", "VOXEL_SIZE": [0.1, 0.1, 0.15]},
]


@pytest.mark.parametrize("training", [True, False], ids=["train", "test"])
def test_processor_equals_jax(training):
    def run(mod):
        rng = np.random.default_rng(4)
        data = {"points": _points(rng, 2500, 25.0), "points1": _points(rng, 2000, 25.0),
                "gt_boxes": _boxes(rng, 10, 25.0), "gt_names": np.asarray(["Vehicle"] * 10),
                "css_score": rng.uniform(0, 1, 10).astype(np.float32)}
        proc = mod.DataProcessor(PROCESSORS, [-20, -20, -2, 20, 20, 4], training)
        return proc(data, np.random.default_rng(5)), proc.voxel_cfg
    assert_same(run(processor), run(jproc))


AUGS = [
    {"NAME": "random_world_flip", "ALONG_AXIS_LIST": ["x", "y"]},
    {"NAME": "random_world_rotation", "WORLD_ROT_ANGLE": [-0.78539816, 0.78539816]},
    {"NAME": "random_world_scaling", "WORLD_SCALE_RANGE": [0.95, 1.05]},
    {"NAME": "random_world_trans", "NOISE_TRANSLATE_STD": [0.2, 0.2, 0.2]},
    {"NAME": "random_local_noise"}, {"NAME": "random_local_pyramid_aug"},
    {"NAME": "random_local_flip"},
]


def _db(rng):
    return {c: [{"name": c, "box3d_lidar": _boxes(rng, 1, 30.0)[0],
                 "points": _points(rng, 60, 2.0), "num_points_in_gt": 60} for _ in range(5)]
            for c in CLASSES}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_augmentor_queue_equals_jax(seed):
    def run(mod):
        rng = np.random.default_rng(10 + seed)
        sampler = mod.DataBaseSampler(None, CLASSES, {"Vehicle": 4, "Cyclist": 2}, db=_db(rng))
        aug = mod.DataAugmentor([{"NAME": "gt_sampling"}] + AUGS, CLASSES, db_sampler=sampler)
        pts = _points(rng, 3000)
        data = {"points": pts, "points1": pts[::2].copy(), "gt_boxes": _boxes(rng, 5),
                "gt_names": np.asarray(["Vehicle", "Pedestrian", "Cyclist", "Vehicle", "Cyclist"])}
        out = aug.forward(data, np.random.default_rng(seed))
        params = out.pop("transform_params")
        return out, [(p.flip_x, p.flip_y, p.rot, p.scale, p.trans) for p in params]
    port, ref = run(augmentor), run(jaug)
    assert_same(port[0], ref[0])
    for a, b in zip(port[1], ref[1]):
        assert a[:4] == b[:4]
        np.testing.assert_array_equal(a[4], b[4])


def test_test_augmentor_and_x_transform_equal_jax():
    tta_list = [{"AUG_CONFIG_LIST": [{"NAME": "world_rotation", "WORLD_ROT": 0.39},
                                     {"NAME": "world_flip", "ALONG_AXIS": "x"},
                                     {"NAME": "world_scaling", "WORLD_SCALE": 1.02}]}]
    tta_dict = {"AUG_CONFIG_LIST": [{"NAME": "world_flip", "ALONG_AXIS_LIST": ["x", "y"]},
                                    {"NAME": "world_rotation", "WORLD_ROT_ANGLE": [0.3]}]}
    for cfg, it in ((tta_list, 0), (tta_dict, 1), (tta_dict, 2)):
        def run(mod):
            rng = np.random.default_rng(20)
            t = mod.TestAugmentor(cfg, test_iter=it)
            out = t.forward({"points": _points(rng, 500), "gt_boxes": _boxes(rng, 4)})
            return out, t.backward(out["gt_boxes"])
        assert_same(list(run(augmentor)), list(run(jaug)))

    def xt(mod):
        rng = np.random.default_rng(21)
        x = mod.XTransform(stages=3)
        data = x.input_transform({"points": _points(rng, 400), "gt_boxes": _boxes(rng, 3)},
                                 np.random.default_rng(22))
        return data, x.backward_row(data["gt_boxes_stage1"], data["transform_param"][1])
    assert_same(list(xt(augmentor)), list(xt(jaug)))


def test_da_sampler_and_collision_equal_jax():
    def run(mod):
        rng = np.random.default_rng(30)
        da = mod.DADataBaseSampler(None, CLASSES, {"Vehicle": 3}, db=_db(rng))
        pts = _points(rng, 1000)
        out = da(pts, _boxes(rng, 2), np.asarray(["Vehicle", "Cyclist"]), np.random.default_rng(31))
        return list(out) + [mod.box_collision_test(_boxes(rng, 8, 5.0), _boxes(rng, 6, 5.0))]
    assert_same(run(augmentor), run(jaug))


def _template(mod):
    class Frames(mod.DatasetTemplate):
        """In-memory samples through the template's prepare_data."""

        def __len__(self):
            return 10

        def __getitem__(self, idx):
            rng = np.random.default_rng(idx)
            pts = _points(rng, 3000)
            data = {"points": pts, "points1": pts.copy(), "gt_boxes": _boxes(rng, 5),
                    "gt_names": np.asarray(["Vehicle", "Pedestrian", "Cyclist", "Vehicle", "Sign"]),
                    "frame_id": f"f{idx}", "sample_idx": idx,
                    "css_score": rng.uniform(0.2, 1, 5).astype(np.float32),
                    "proto_group_id": np.arange(5)}
            return self.prepare_data(data)
    return Frames


TEMPLATE_CFG = {
    "POINT_CLOUD_RANGE": [-15, -15, -2, 15, 15, 4], "POINT_CAP": 2048, "GT_CAP": 8, "STAGES": 2,
    "POINT_FEATURE_ENCODING": {"used_feature_list": ["x", "y", "z", "intensity"],
                               "src_feature_list": ["x", "y", "z", "intensity", "time"]},
    "DATA_AUGMENTOR": {"AUG_CONFIG_LIST": AUGS[:3]},
    "TEST_AUGMENTOR": {"AUG_CONFIG_LIST": [{"NAME": "world_rotation", "WORLD_ROT_ANGLE": [0.2]}]},
}


@pytest.mark.parametrize("training", [True, False], ids=["train", "test"])
def test_prepare_data_and_collate_equal_jax(training):
    def run(mod):
        ds = _template(mod)(dataset_cfg=TEMPLATE_CFG, class_names=CLASSES, training=training)
        ds.set_epoch(3)
        return mod.collate_batch([ds[i] for i in (4, 1, 7)])
    port, ref = run(dataset), run(jds)
    assert_same(port, ref)
    assert port["points"].shape == (3, 2048, 4) and ("points1" in port) == training


@pytest.mark.parametrize("training,world_size", [(True, 1), (False, 1), (False, 2)])
def test_loader_order_equals_jax(training, world_size):
    def run(ds_mod, loader_mod):
        ds = _template(ds_mod)(dataset_cfg=TEMPLATE_CFG, class_names=CLASSES, training=training)
        out = []
        for rank in range(world_size):
            _, ld, _ = loader_mod.build_dataloader(TEMPLATE_CFG, CLASSES, 3, training=training,
                                                   workers=3, world_size=world_size, rank=rank,
                                                   seed=7, dataset=ds)
            out += list(ld)
        return out
    port, ref = run(dataset, loader), run(jds, jloader)
    assert len(port) == len(ref) > 0
    for a, b in zip(port, ref):
        assert_same(a, b)


def test_loader_raises_a_worker_error_and_stops_early():
    class Broken(_template(dataset)):
        def __getitem__(self, idx):
            if idx == 4:
                raise RuntimeError("sample 4 is broken")
            return super().__getitem__(idx)
    ds = Broken(dataset_cfg=TEMPLATE_CFG, class_names=CLASSES, training=False)
    with pytest.raises(RuntimeError, match="sample 4"):
        list(loader.DataLoader(ds, 2, shuffle=False, drop_last=False))
    first = next(iter(loader.DataLoader(ds, 2, shuffle=False, prefetch=1)))
    assert first["frame_id"] == ["f0", "f1"]


@pytest.fixture(scope="module")
def sequence(tmp_path_factory):
    root = tmp_path_factory.mktemp("waymo")
    rng = np.random.default_rng(40)
    frames = []
    for _ in range(4):
        pts = _points(rng, 6000, 30.0)
        pts[:, 3] = rng.uniform(0, 2, len(pts))
        frames.append(pts)
    write_waymo_sequence(root, "segment-0000", frames, seed=1, n_boxes=6, r_max=25.0,
                         protos=True)
    return root


WAYMO_CFG = {
    "PROCESSED_DATA_TAG": "waymo_processed_data",
    "POINT_CLOUD_RANGE": [-30, -30, -2, 30, 30, 4], "POINT_CAP": 4096, "GT_CAP": 16, "STAGES": 2,
    "InitLabelGenerator": "MFCF", "LabelRefiner": "C_PROTO", "NUM_FRAMES": 1,
    "DATA_SPLIT": {"train": "train", "test": "val"}, "SAMPLED_INTERVAL": {"train": 1, "test": 1},
    "LABEL_OFFSET": 0.07,
    "RefinerConfig": {"DiscardThreshMin": {"Vehicle": 0.3, "Pedestrian": 0.3, "Cyclist": 0.3},
                      "DiscardThreshMax": {"Vehicle": 0.7, "Pedestrian": 0.55, "Cyclist": 0.55}},
    "POINT_FEATURE_ENCODING": {"used_feature_list": ["x", "y", "z", "intensity", "time"],
                               "src_feature_list": ["x", "y", "z", "intensity", "time"]},
    "DATA_AUGMENTOR": {"AUG_CONFIG_LIST": AUGS[:3]},
}


@pytest.mark.parametrize("training,num_frames", [(True, 1), (False, 1), (False, 3)],
                         ids=["train", "eval", "eval-3-frames"])
def test_waymo_getitem_equals_jax(sequence, training, num_frames):
    cfg = dict(WAYMO_CFG, NUM_FRAMES=num_frames)

    def run(cls):
        ds = cls(dataset_cfg=cfg, class_names=CLASSES, training=training, root_path=str(sequence))
        ds.set_epoch(2)
        return len(ds), [ds[i] for i in range(len(ds))]
    port, ref = run(WaymoUnsupervisedDataset), run(JWaymo)
    assert port[0] == ref[0] == 4
    assert_same(port[1], ref[1])
    if training:
        assert any(s["gt_valid"].any() for s in port[1])
        assert all("points1" in s for s in port[1])


def test_waymo_predictions_gt_and_evaluation_equal_jax(sequence):
    def run(cls):
        ds = cls(dataset_cfg=WAYMO_CFG, class_names=CLASSES, training=False,
                 root_path=str(sequence))
        batch = {"batch_size": 2, "frame_id": ["segment-0000#0000", "segment-0000#0001"]}
        gt = ds.collect_gt_annos()
        preds = {"pred_boxes": np.stack([np.pad(a["gt_boxes_lidar"], ((0, 2), (0, 0)))
                                         for a in gt[:2]]).astype(np.float32),
                 "pred_scores": np.linspace(0.9, 0.2, 16, dtype=np.float32).reshape(2, 8),
                 "pred_labels": np.tile(np.array([1, 2, 3, 1, 2, 3, 1, 1]), (2, 1)),
                 "pred_valid": np.tile(np.arange(8) < 6, (2, 1))}
        dets = ds.generate_prediction_dicts(batch, preds, CLASSES)
        return gt, dets, ds.evaluation(dets, CLASSES, gt_annos=gt[:2])
    port, ref = run(WaymoUnsupervisedDataset), run(JWaymo)
    assert_same(port[0], ref[0])
    assert_same(port[1], ref[1])
    assert port[2][0] == ref[2][0]
    assert_same(port[2][1], ref[2][1])


def test_written_sequence_layout(sequence):
    seq_dir = sequence / "waymo_processed_data" / "segment-0000"
    disk = np.load(seq_dir / "0000.npy")
    assert disk.shape == (6000, 6) and (disk[:, 5] == -1).all() and (disk[:, 4] == 0).all()
    with open(seq_dir / "segment-0000_outline_C_PROTO.pkl", "rb") as f:
        labels = pickle.load(f)
    assert sorted(labels) == [0, 1, 2, 3] and labels[0]["outline_box"].shape == (6, 7)


@pytest.mark.parametrize("n,c", [(1, 5), (2, 4), (1000, 5), (200_000, 5)])
def test_shuffled_order_equals_generator_shuffle_of_the_rows(n, c):
    """``dataset.shuffled_order`` gives the rows of ``Generator.shuffle`` on
    the (n, C) array itself and leaves the generator in the same state."""
    pts = np.random.default_rng(1).normal(size=(n, c)).astype(np.float32)
    rows, idx = np.random.default_rng([2, n]), np.random.default_rng([2, n])
    shuffled = pts.copy()
    rows.shuffle(shuffled)
    np.testing.assert_array_equal(pts[dataset.shuffled_order(idx, n)], shuffled)
    assert rows.bit_generator.state == idx.bit_generator.state
    assert rows.random() == idx.random()
