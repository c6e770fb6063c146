"""The port's DBSCAN (``cpd_tpu_torch.ops.dbscan``, kernel R2's plain version
on the CPU) against sklearn's and the JAX package's, on seeded clouds.

Kernel R2 computes sklearn's labels in closed form (core points by count,
clusters as connected components of the core points numbered by their
smallest core index, border points to the smallest cluster among their core
neighbours). The clouds hold blobs close enough to share border points, so
the rule for those points is exercised. Labels must equal on every point:
``sklearn.cluster.DBSCAN``, JAX's ``outline.dbscan_cluster`` (sklearn where
it is installed, as on the machines that run these tests) and JAX's fallback
``outline._dbscan_bfs``.
"""
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree
from sklearn.cluster import DBSCAN

from cpd_tpu.unsupervised import outline as joutline
from cpd_tpu_torch.ops.dbscan import dbscan_labels, dbscan_reference, neighbour_pairs
from cpd_tpu_torch.unsupervised import outline as poutline
from tests.test_torch_port_ppscore import one_torch_thread  # noqa: F401


def _cloud(seed, n_centers=60, per=50, noise=500, spread=10.0):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-spread, spread, (n_centers, 3))
    pts = np.concatenate([c + rng.normal(0, 0.5, (per, 3)) for c in centers]
                         + [rng.uniform(-spread - 2, spread + 2, (noise, 3))])
    return pts[rng.permutation(len(pts))]


def _shared_border_points(pts, labels, eps, min_samples):
    """Points that are not core but lie within eps of core points of two or
    more clusters."""
    tree = cKDTree(pts)
    neigh = tree.query_ball_point(pts, eps)
    core = np.array([len(n) >= min_samples for n in neigh])
    return sum(1 for i in range(len(pts)) if not core[i]
               and len({labels[j] for j in neigh[i] if core[j]}) >= 2)


@pytest.mark.parametrize("seed,eps,min_samples", [(0, 0.4, 5), (1, 0.4, 5), (2, 0.5, 8),
                                                  (3, 0.35, 6)])
def test_dbscan_labels_equal_sklearn_and_bfs(seed, eps, min_samples):
    pts = _cloud(seed)
    got = dbscan_labels(torch.from_numpy(pts), eps, min_samples).numpy()
    want = DBSCAN(eps=eps, min_samples=min_samples).fit(pts).labels_
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, joutline._dbscan_bfs(pts, eps, min_samples))
    shared = _shared_border_points(pts, want, eps, min_samples)
    print(f"{want.max() + 1} clusters, {(want == -1).sum()} noise, {shared} shared border points")
    assert want.max() >= 10 and shared > 0


@pytest.mark.parametrize("min_samples", [10, 5])
def test_dbscan_cluster_matches_jax(min_samples):
    """``outline.dbscan_cluster`` of both packages on a scene's points."""
    pts = _cloud(5, n_centers=30, per=80, noise=300)
    got = poutline.dbscan_cluster(pts, 0.7, min_samples, device="cpu")
    want = joutline.dbscan_cluster(pts, 0.7, min_samples)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [0, 1, 4])
def test_dbscan_tiny_clouds(n):
    """The empty cloud, and clouds with too few points for a core: no
    cluster, every point noise, as sklearn."""
    pts = np.random.default_rng(n).uniform(0, 0.1, (n, 3))
    got = dbscan_labels(torch.from_numpy(pts), 0.5, 5).numpy()
    assert got.shape == (n,) and got.dtype == np.int32
    if n:
        np.testing.assert_array_equal(got, DBSCAN(eps=0.5, min_samples=5).fit(pts).labels_)
    assert poutline.dbscan_cluster(pts, 0.5, 5, device="cpu").shape == (n,)


def test_neighbour_pairs_are_every_pair_within_eps():
    pts = _cloud(9, n_centers=5, per=30, noise=50)
    src, dst = neighbour_pairs(torch.from_numpy(pts), 0.4)
    want = cKDTree(pts).query_pairs(0.4, output_type="ndarray")
    got = {(int(i), int(j)) for i, j in zip(src, dst) if i < j}
    assert got == {(int(i), int(j)) for i, j in want}
    assert (src == dst).sum() == len(pts)


def test_dbscan_wrapper_checks_its_operands():
    with pytest.raises(TypeError):
        dbscan_labels(torch.zeros((4, 3), dtype=torch.float32), 0.5, 5)
    with pytest.raises(ValueError):
        dbscan_labels(torch.zeros((4, 2), dtype=torch.float64), 0.5, 5)
    assert dbscan_reference(torch.zeros((3, 3), dtype=torch.float64), 0.5, 3).tolist() == [0] * 3
