"""The port's outline toolbox, ground removal, tracker and CSS
(``cpd_tpu_torch.unsupervised.{outline,ground,tracker,cproto}``) against the
JAX package's, on seeded scenes. The port's code is a copy of JAX's NumPy,
so every result is held bit-equal: ground masks and heights, clusters (the
port's DBSCAN is kernel R2's plain version, JAX's sklearn), rectangles under
both criteria, fitted and refined boxes, voxel sampling (the port's scalar
voxel key against JAX's row-wise ``np.unique``), smoothing, the scores and
size classes, and the track ids and boxes of ``Tracker3D`` and
``TrackSmooth`` over a seeded sequence of moving and parked boxes.
"""
import numpy as np
import pytest

from cpd_tpu.unsupervised import cproto as jcproto
from cpd_tpu.unsupervised import ground as jground
from cpd_tpu.unsupervised import outline as jo
from cpd_tpu.unsupervised import tracker as jtracker
from cpd_tpu_torch.unsupervised import cproto as pcproto
from cpd_tpu_torch.unsupervised import ground as pground
from cpd_tpu_torch.unsupervised import outline as po
from cpd_tpu_torch.unsupervised import tracker as ptracker
from tests.test_unsupervised import PED, VEH, box_surface_points, make_scene
from tests.test_torch_port_ppscore import one_torch_thread  # noqa: F401

SEEDS = [0, 1, 2]


def _boxes(seed):
    rng = np.random.default_rng(seed)
    veh = VEH.copy()
    veh[:2] += rng.uniform(-3, 3, 2)
    veh[6] = rng.uniform(-np.pi, np.pi)
    ped = PED.copy()
    ped[:2] += rng.uniform(-2, 2, 2)
    cyc = np.array([3.0, -12.0, 0.85, 1.8, 0.8, 1.7, rng.uniform(-np.pi, np.pi)])
    return [veh, ped, cyc]


def _scene(seed):
    return make_scene(_boxes(seed), n_ground=3000, rng=np.random.default_rng(seed))


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("seed", SEEDS)
def test_ground_segmenter_and_banded_removal_bit_equal(seed):
    scene = _scene(seed)
    pm, pz = pground.GroundSegmenter()(scene)
    jm, jz = jground.GroundSegmenter()(scene)
    _eq(pm, jm)
    _eq(pz, jz)
    _eq(pground.remove_ground_banded(scene), jground.remove_ground_banded(scene))
    _eq(pground.remove_ground(scene), jground.remove_ground(scene))


@pytest.mark.parametrize("seed", SEEDS)
def test_clustering_bit_equal(seed):
    ng = jground.remove_ground_banded(_scene(seed))
    got = po.clustering(ng, 0.7, 10, min_points=5, device="cpu")
    want = jo.clustering(ng, 0.7, 10, min_points=5)
    assert len(got) == len(want) >= 2
    for g, w in zip(got, want):
        _eq(g, w)


@pytest.mark.parametrize("criterion", ["area", "distance"])
@pytest.mark.parametrize("seed", SEEDS)
def test_minimum_bounding_rectangle_bit_equal(seed, criterion):
    rng = np.random.default_rng(seed)
    for n in (1, 2, 3, 40, 400):
        xy = rng.normal(0, 1.5, (n, 2)) * [2.0, 0.6]
        c1, d1, a1 = po.minimum_bounding_rectangle(xy, criterion)
        c2, d2, a2 = jo.minimum_bounding_rectangle(xy, criterion)
        _eq(c1, c2)
        assert d1 == d2 and a1 == a2
    line = np.stack([np.linspace(0, 3, 10), np.linspace(0, 1, 10)], 1)  # collinear: PCA path
    for x, y in zip(po.minimum_bounding_rectangle(line, criterion),
                    jo.minimum_bounding_rectangle(line, criterion)):
        _eq(x, y)


@pytest.mark.parametrize("seed", SEEDS)
def test_box_fits_and_refinements_bit_equal(seed):
    for box in _boxes(seed):
        pts = box_surface_points(box, n=400, rng=np.random.default_rng(seed))
        _eq(po.box_fit(pts), jo.box_fit(pts))
        _eq(po.box_fit(pts, "area"), jo.box_fit(pts, "area"))
        got, want = po.fit_gated_box(pts), jo.fit_gated_box(pts)
        assert (got is None) == (want is None)
        if got is not None:
            _eq(got[0], want[0])
            _eq(got[1], want[1])
        got, want = po.box_fit_DGD(pts), jo.box_fit_DGD(pts)
        assert (got is None) == (want is None)
        if got is not None:
            _eq(got, want)
        _eq(po.density_guided_drift(box, pts, (5.0, 2.2)), jo.density_guided_drift(box, pts, (5.0, 2.2)))
        _eq(po.correct_orientation(box, pts), jo.correct_orientation(box, pts))
        _eq(po.correct_heading(box, pts), jo.correct_heading(box, pts))
        _eq(po.corner_align(box, 5.0, 2.2), jo.corner_align(box, 5.0, 2.2))


@pytest.mark.parametrize("seed", SEEDS)
def test_voxel_sampling_and_smoothing_bit_equal(seed):
    rng = np.random.default_rng(seed)
    pts = np.concatenate([_scene(seed), _scene(seed)[::3] + rng.normal(0, 0.01, (1, 3))])
    for voxel in (0.05, 0.1, 0.5):
        _eq(po.voxel_sampling(pts, voxel), jo.voxel_sampling(pts, voxel))
    far = np.array([[0.0, 0.0, 0.0], [1e17, 1e17, 1e17], [0.05, 0.0, 0.0]])  # row-wise fallback
    _eq(po.voxel_sampling(far, 0.1), jo.voxel_sampling(far, 0.1))
    _eq(po.voxel_sampling(pts[:0], 0.1), jo.voxel_sampling(pts[:0], 0.1))
    _eq(po.smooth_points(pts, 0.2), jo.smooth_points(pts, 0.2))


@pytest.mark.parametrize("seed", SEEDS)
def test_scores_and_classes_bit_equal(seed):
    rng = np.random.default_rng(seed)
    for box in _boxes(seed):
        pts = box_surface_points(box, n=300, rng=rng)
        assert po.hierarchical_occupancy_score(pts, box) == jo.hierarchical_occupancy_score(pts, box)
        assert po.compute_occupancy(pts, box, 9) == jo.compute_occupancy(pts, box, 9)
        assert po.distance_score(box) == jo.distance_score(box)
        size = box[3:6] / box[3:6].sum()
        prior = np.array([4.7, 2.1, 1.7]) / 8.5
        assert po.KL_entropy_score(size, prior) == jo.KL_entropy_score(size, prior)
        for cls in ("Vehicle", "Pedestrian", "Cyclist", "Dis_Small"):
            assert pcproto.CSS()(pts, box, cls) == jcproto.CSS()(pts, box, cls)
    sizes = rng.uniform(0.1, 14.0, (200, 7))
    assert [po.get_box_cls(b) for b in sizes] == [jo.get_box_cls(b) for b in sizes]
    pose = np.eye(4)
    pose[:3, 3] = rng.normal(0, 5, 3)
    pose[:2, :2] = [[np.cos(0.3), -np.sin(0.3)], [np.sin(0.3), np.cos(0.3)]]
    _eq(po.box_rigid_transform(sizes, pose), jo.box_rigid_transform(sizes, pose))


def _track_sequence(seed, n_frames=14):
    """Per frame the sensor-frame boxes of a mover, a parked car and a walker
    (with dropouts and a false box), the ego moving 1 m a frame."""
    rng = np.random.default_rng(seed)
    boxes, scores, poses = [], [], []
    for f in range(n_frames):
        pose = np.eye(4)
        pose[0, 3] = f * 1.0
        world = [np.array([5.0 + 1.5 * f, 3.0, 0.8, 4.5, 2.0, 1.6, 0.02]),
                 np.array([20.0, -6.0, 0.8, 4.4, 1.9, 1.5, 1.2]),
                 np.array([-4.0 + 0.2 * f, 8.0, 0.9, 0.8, 0.7, 1.7, 0.5])]
        keep = [w + rng.normal(0, 0.05, 7) for i, w in enumerate(world) if rng.random() > 0.15]
        if f == 6:
            keep.append(np.array([40.0, 40.0, 0.5, 1.0, 1.0, 1.0, 0.0]))
        b = np.asarray(keep).reshape(-1, 7)
        b[:, 0] -= pose[0, 3]
        boxes.append(b)
        scores.append(rng.uniform(0.3, 1.0, len(b)))
        poses.append(pose)
    return boxes, scores, poses


@pytest.mark.parametrize("seed", SEEDS)
def test_tracker_and_track_smooth_same_ids_and_boxes(seed):
    boxes, scores, poses = _track_sequence(seed)
    pt, jt = ptracker.Tracker3D(match_dist=4.0), jtracker.Tracker3D(match_dist=4.0)
    for f, (b, s) in enumerate(zip(boxes, scores)):
        _eq(pt.step(f, b, s), jt.step(f, b, s))
    ptr, jtr = pt.post_processing(3), jt.post_processing(3)
    assert sorted(ptr) == sorted(jtr) and len(ptr) >= 2
    for tid in ptr:
        assert sorted(ptr[tid].boxes) == sorted(jtr[tid].boxes)
        for f in ptr[tid].boxes:
            _eq(ptr[tid].boxes[f], jtr[tid].boxes[f])
        assert ptr[tid].motion_statistics() == jtr[tid].motion_statistics()
    ps, js = ptracker.TrackSmooth(min_track_len=3), jtracker.TrackSmooth(min_track_len=3)
    ps.tracking(boxes, scores, poses)
    js.tracking(boxes, scores, poses)
    for f in range(len(boxes)):
        for x, y in zip(ps.get_current_frame_objects_and_cls(f),
                        js.get_current_frame_objects_and_cls(f)):
            _eq(x, y)
