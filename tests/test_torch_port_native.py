"""The port's native host library (cpd_tpu_torch.native) on the CPU.

Each of its five entry points is held bit-equal to the JAX package's
library (``cpd_tpu.native``: the same C++ source, radius_neighbor_count
aside, built with the same flags), also on points exactly on box faces; and
equal to its NumPy plain version off the faces (``decode_waymo_points``'
intensity within 2 f32 ulp: libm's ``tanhf`` against the f64 ``tanh``
rounded once, the error glibc documents for ``tanhf``).
A missing compiler raises instead of falling back."""
import numpy as np
import pytest

from cpd_tpu import native as jnative
from cpd_tpu_torch import native
from cpd_tpu_torch.datasets import box_np

if not jnative.available():
    pytest.skip("the JAX package's C++ library does not build here", allow_module_level=True)


def _boxes(rng, n, spread=25.0):
    b = np.zeros((n, 7), np.float32)
    b[:, :2] = rng.uniform(-spread, spread, (n, 2))
    b[:, 2] = rng.uniform(-1, 1, n)
    b[:, 3:6] = rng.uniform(0.5, 6.0, (n, 3))
    b[:, 6] = rng.uniform(-np.pi, np.pi, n)
    return b


def _on_faces(boxes):
    """Points exactly on each box's six face centres (and corners of its
    axis-aligned faces), in f32."""
    out = []
    for x, y, z, dx, dy, dz, yaw in boxes.astype(np.float64):
        c, s = np.cos(yaw), np.sin(yaw)
        for lx, ly, lz in ((dx / 2, 0, 0), (-dx / 2, 0, 0), (0, dy / 2, 0), (0, -dy / 2, 0),
                           (0, 0, dz / 2), (0, 0, -dz / 2), (dx / 2, dy / 2, dz / 2)):
            out.append([x + lx * c - ly * s, y + lx * s + ly * c, z + lz])
    return np.asarray(out, np.float32)


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(0)
    pts = rng.uniform(-30, 30, (40_000, 5)).astype(np.float32)
    pts[:, 2] = rng.uniform(-2, 3, len(pts))
    boxes = _boxes(rng, 48)
    faces = np.concatenate([_on_faces(boxes), np.zeros((len(boxes) * 7, 2), np.float32)], 1)
    return pts, boxes, faces


@pytest.mark.parametrize("fn", ["points_in_boxes_first", "points_in_boxes_mask"])
def test_points_in_boxes_equal_jax_and_numpy(scene, fn):
    pts, boxes, faces = scene
    both = np.concatenate([pts, faces])
    got = getattr(native, fn)(both, boxes)
    np.testing.assert_array_equal(got, getattr(jnative, fn)(both, boxes))
    assert got.dtype == getattr(jnative, fn)(both, boxes).dtype
    # off the faces: the NumPy plain version
    np.testing.assert_array_equal(getattr(native, fn)(pts, boxes),
                                  getattr(native, f"{fn}_np")(pts, boxes))
    hits = (got >= 0) if fn == "points_in_boxes_first" else got.any(0)
    assert hits[:len(pts)].sum() > 1000 and hits[len(pts):].any()
    # no boxes, a column stride of 3
    assert getattr(native, fn)(pts[:, :3], boxes[:0]).shape == getattr(jnative, fn)(
        pts[:, :3], boxes[:0]).shape


def test_fast_mask_is_the_native_route(scene):
    pts, boxes, faces = scene
    both = np.concatenate([pts, faces])[:, :3]
    np.testing.assert_array_equal(box_np.points_in_boxes_mask_fast(both, boxes),
                                  jnative.points_in_boxes_mask(both, boxes))


def test_rigid_transform_equals_jax_and_numpy():
    rng = np.random.default_rng(1)
    pts = rng.normal(0, 20, (30_000, 5)).astype(np.float32)
    th = 0.7
    pose = np.eye(4)
    pose[:2, :2] = [[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]]
    pose[:3, 3] = [10.5, -2.25, 1.75]
    got = native.rigid_transform(pts, pose)
    np.testing.assert_array_equal(got, jnative.rigid_transform(pts, pose))
    np.testing.assert_array_equal(got, native.rigid_transform_np(pts, pose))
    np.testing.assert_array_equal(got[:, 3:], pts[:, 3:])
    assert native.rigid_transform(pts[:0], pose).shape == (0, 5)


def test_decode_waymo_points_equals_jax_and_numpy():
    rng = np.random.default_rng(2)
    raw = (rng.normal(size=(50_000, 6)) * 3).astype(np.float32)
    raw[:, 5] = np.where(rng.random(len(raw)) < 0.8, -1, 1)
    got = native.decode_waymo_points(raw)
    np.testing.assert_array_equal(got, jnative.decode_waymo_points(raw))
    plain = native.decode_waymo_points_np(raw)
    assert got.shape == plain.shape == ((raw[:, 5] == -1).sum(), 5)
    np.testing.assert_array_equal(np.delete(got, 3, 1), np.delete(plain, 3, 1))
    np.testing.assert_array_max_ulp(got[:, 3], plain[:, 3], maxulp=2)


def test_voxel_downsample_equals_jax_and_numpy():
    rng = np.random.default_rng(3)
    pts = rng.uniform(-20, 20, (60_000, 4)).astype(np.float32)
    pts[::7, :3] = np.round(pts[::7, :3], 1)  # on voxel edges
    for voxel in (0.1, 0.5):
        got = native.voxel_downsample(pts, voxel)
        np.testing.assert_array_equal(got, jnative.voxel_downsample(pts, voxel))
        np.testing.assert_array_equal(got, native.voxel_downsample_np(pts, voxel))
        assert 0 < len(got) < len(pts)
    assert native.voxel_downsample(pts[:0]).shape == (0, 4)


def test_a_missing_compiler_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.points_in_boxes_mask(np.zeros((4, 3), np.float32), np.ones((1, 7), np.float32))
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        box_np.points_in_boxes_mask_fast(np.zeros((4, 3), np.float32), np.ones((1, 7), np.float32))
    assert not (tmp_path / "_build").exists() or not list((tmp_path / "_build").glob("*.so"))


def test_a_failed_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "pointcloud.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.load()
    assert not list((tmp_path / "_build").glob("*.so"))


def test_build_is_keyed_by_source_and_flags(monkeypatch):
    path = native.library_path()
    assert path.parent == native.BUILD_DIR and path.name.startswith("libcpd_native_")
    monkeypatch.setattr(native, "CXX_FLAGS", native.CXX_FLAGS + ["-g"])
    assert native.library_path() != path


def test_malformed_inputs_raise_before_the_cpp():
    box = np.ones((1, 7), np.float32)
    with pytest.raises(ValueError, match="points must be"):
        native.points_in_boxes_mask(np.zeros((4, 2), np.float32), box)
    with pytest.raises(ValueError, match="boxes must be"):
        native.points_in_boxes_first(np.zeros((4, 3), np.float32), np.ones((1, 6), np.float32))
    with pytest.raises(ValueError, match="raw must be"):
        native.decode_waymo_points(np.zeros((4, 5), np.float32))
    with pytest.raises(ValueError, match="pose must be"):
        native.rigid_transform(np.zeros((4, 3), np.float32), np.eye(3))
    with pytest.raises(ValueError, match="points must be"):
        native.voxel_downsample(np.zeros(12, np.float32))
