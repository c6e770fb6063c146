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

The segmented entry (``dbscan_labels_batched``, its plain version a loop of
``dbscan_reference``) equals each segment alone, and so does kernel R2's
walk restated on the CPU from the wrapper's own segmented operands (each
segment's own grid, its columns after the previous segment's):
``outline.clustering_batched`` equals ``clustering`` cloud by cloud.
"""
from unittest import mock

import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree
from sklearn.cluster import DBSCAN

from cpd_tpu.unsupervised import outline as joutline
from cpd_tpu_torch.ops import dbscan as r2
from cpd_tpu_torch.ops import radius as r1
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


def _bounds_on_cpu(cells, offsets, longest):
    """``r2.segment_bounds`` (a kernel on the card) on CPU tensors:
    ``scatter_reduce`` over each segment, (0, 0) for an empty one."""
    n_seg = len(offsets) - 1
    seg = torch.repeat_interleave(torch.arange(n_seg), offsets[1:] - offsets[:-1])
    index = seg[:, None].expand(-1, 3)
    zeros = torch.zeros((n_seg, 3), dtype=torch.int64)
    return (zeros.scatter_reduce(0, index, cells, "amin", include_self=False),
            zeros.scatter_reduce(0, index, cells, "amax", include_self=False))


def _operands_on_cpu(points, offsets, eps):
    """``r2.dbscan_operands`` on CPU tensors, its segment bounds by
    ``_bounds_on_cpu``."""
    with mock.patch.object(r2, "segment_bounds", _bounds_on_cpu):
        return r2.dbscan_operands(points, eps, None if offsets is None
                                  else r2.segment_offsets_of(offsets, len(points)))


def _restated_labels(points, offsets, eps, min_samples):
    """Kernel R2 restated on the CPU from the wrapper's operands: the pairs of
    the walk (``radius.walk_pairs``) tested in the kernel's f64 order, core
    points by count, components with their smallest original index as root,
    border points to the smallest root among their core neighbours, each
    segment numbered from the rank of its first point."""
    ops = _operands_on_cpu(points, offsets, eps)
    t, _, u = r1.walk_pairs(ops.plan, r1.cell_runs_reference(ops.plan))
    e = ops.pts[t, :3] - ops.pts[u, :3]
    hit = (e[:, 0] * e[:, 0] + e[:, 1] * e[:, 1]) + e[:, 2] * e[:, 2] <= ops.eps2
    t, u = t[hit], u[hit]
    n = len(points)
    core = torch.bincount(t, minlength=n) >= min_samples
    perm = ops.perm.long()
    both = core[t] & core[u]
    i, j = perm[t[both]], perm[u[both]]
    root = torch.arange(n)
    while True:
        new = root.scatter_reduce(0, i, root[j], reduce="amin")
        new = new[new]
        if torch.equal(new, root):
            break
        root = new
    core_orig = torch.zeros(n, dtype=torch.bool)
    core_orig[perm] = core
    is_root = (core_orig & (root == torch.arange(n))).long()
    rank = torch.cumsum(is_root, 0) - is_root
    best = torch.full((n,), n)
    border = ~core[t] & core[u]
    best.scatter_reduce_(0, t[border], root[perm[u[border]]], reduce="amin")
    base = 0 if ops.seg_first is None else rank[ops.seg_first.long()]
    by_sorted = torch.where(core, rank[root[perm]] - base,
                            torch.where(best < n, rank[best.clamp(max=n - 1)] - base, -1))
    out = torch.empty(n, dtype=torch.int64)
    out[perm] = by_sorted
    return out.int()


def _segments(case, rng):
    """Clouds a few meters wide spread over +-50 m, with the case's
    segments among them."""
    clouds = []
    for k in range(12):
        centers = rng.uniform(-1.5, 1.5, (3, 3)) + rng.uniform(-50, 50, 3)
        clouds.append(np.concatenate([c + rng.normal(0, 0.3, (int(rng.integers(5, 60)), 3))
                                      for c in centers]))
    extra = {"empty": [np.zeros((0, 3))] * 3,
             "one_point": [np.array([[1.0, 2.0, 3.0]]), np.array([[-4.0, 0.5, 1.0]])],
             "all_noise": [rng.uniform(-20, 20, (40, 3))],
             "identical": [clouds[3].copy(), clouds[3].copy()]}[case]
    clouds[2:2] = extra[: len(extra) // 2]
    clouds += extra[len(extra) // 2:]
    return clouds


@pytest.mark.parametrize("case", ["empty", "one_point", "all_noise", "identical"])
def test_dbscan_batched_equals_each_segment_alone(case):
    """The segmented plain version (the CPU route of ``dbscan_labels_batched``)
    equals ``dbscan_reference`` on each segment alone, and sklearn where the
    segment has points; the kernel's walk restated from the segmented
    operands gives the same labels: empty and one-point segments, a segment
    of noise alone, two segments with the same coordinates that must not
    link."""
    rng = np.random.default_rng(len(case))
    clouds = _segments(case, rng)
    pts = torch.from_numpy(np.concatenate(clouds))
    offsets = np.concatenate([[0], np.cumsum([len(c) for c in clouds])])
    got = r2.dbscan_labels_batched(pts, offsets, 0.5, 5)
    assert got.dtype == torch.int32 and got.shape == (len(pts),)
    for c, a, b in zip(clouds, offsets[:-1], offsets[1:]):
        want = dbscan_reference(torch.from_numpy(c), 0.5, 5)
        assert torch.equal(got[a:b], want)
        if len(c):
            np.testing.assert_array_equal(want.numpy(), DBSCAN(eps=0.5, min_samples=5).fit(c).labels_)
    assert torch.equal(_restated_labels(pts, offsets, 0.5, 5), got)
    assert int(got.max()) >= 1 and int((got < 0).sum()) > 0
    if case == "identical":  # segments 2 and the last hold the same points
        assert torch.equal(got[offsets[2]:offsets[3]], got[offsets[-2]:])
        assert int(got[offsets[-2]:].max()) >= 0
    if case == "all_noise":
        assert bool((got[offsets[-2]:] == -1).all())


def test_dbscan_restated_walk_equals_plain_on_one_cloud():
    """One cloud (no segments): the kernel's walk restated equals the plain
    version on blobs that share border points."""
    pts = torch.from_numpy(_cloud(4, n_centers=20, per=40, noise=200, spread=6.0))
    want = dbscan_reference(pts, 0.4, 5)
    assert torch.equal(_restated_labels(pts, None, 0.4, 5), want) and int(want.max()) >= 5


def test_dbscan_one_cloud_grid_is_grid_cells():
    """One cloud is one segment whose grid is ``radius.grid_cells``': the
    same sorted cell keys, column table and rows, and no segment starts;
    ``segment_bounds`` refuses CPU tensors."""
    pts = torch.from_numpy(_cloud(5, n_centers=6, per=30, noise=60, spread=5.0))
    ops = _operands_on_cpu(pts, None, 0.4)
    (cells,), dims = r1.grid_cells((pts,), 0.4 * r1.CELL_MARGIN)
    keys = torch.sort(r1.cell_keys(cells, dims)).values
    assert torch.equal(ops.plan.keys, keys) and ops.plan.NZ == dims[2]
    assert torch.equal(ops.plan.start, r1.column_table(keys // dims[2], dims[0] * dims[1]))
    assert bool((ops.plan.gny == dims[1]).all()) and ops.seg_first is None
    with pytest.raises(ValueError):
        r2.segment_bounds(cells, torch.tensor([0, len(pts)]), len(pts))


def test_clustering_batched_equals_clustering():
    """``outline.clustering_batched`` gives, cloud by cloud, the clusters of
    ``outline.clustering``, empty clouds included."""
    rng = np.random.default_rng(11)
    clouds = _segments("empty", rng) + _segments("one_point", rng)
    got = poutline.clustering_batched(clouds, 0.5, 10, min_points=5, device="cpu")
    assert len(got) == len(clouds) and sum(len(g) for g in got) > 0
    for c, g in zip(clouds, got):
        want = poutline.clustering(c, 0.5, 10, min_points=5, device="cpu")
        assert len(g) == len(want)
        for x, y in zip(g, want):
            np.testing.assert_array_equal(x, y)
    assert poutline.clustering_batched([np.zeros((0, 3))], device="cpu") == [[]]


def test_dbscan_batched_checks_its_offsets():
    pts = torch.zeros((4, 3), dtype=torch.float64)
    for bad in ([0, 3], [1, 4], [0, 3, 2, 4], [4]):
        with pytest.raises(ValueError):
            r2.dbscan_labels_batched(pts, bad, 0.5, 2)
