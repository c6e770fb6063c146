"""The port's PPScore (``cpd_tpu_torch.unsupervised.ppscore``, kernel R1's
plain version on the CPU) against the JAX package's, on seeded inputs.

* ``compute_ephe_score`` is a NumPy copy: bit-equal, the single-window NaN
  and inf of JAX's division by log(1) included.
* ``ppscore_windows`` against ``ppscore_jax``: counts exactly equal, ``h``
  within 1e-6 (f32 logs in two frameworks).
* ``ppscore_for_frame`` and ``driver.save_ppscore`` against JAX's on small
  written sequences. JAX counts with its native library, whose cell lookup
  is wrong near cell edges (ROADMAP section 3): scores are compared bit for
  bit on every point whose native counts equal scipy's ``cKDTree`` in every
  window; the port's counts equal ``cKDTree``'s on every point.
* A query at a cell edge where the native count is wrong and the port's is
  right documents that fault.
* Kernel R1's host side on the CPU: the column table that the wrapper builds
  equals ``torch.searchsorted`` over the sorted keys, and the kernel's walk,
  restated from the same runs and pieces (``radius.walk_pairs``), counts what
  the plain version counts.
"""
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from cpd_tpu import native
from cpd_tpu.unsupervised import driver as jdriver
from cpd_tpu.unsupervised import ppscore as jpp
from cpd_tpu_torch.ops import radius as r1
from cpd_tpu_torch.ops.radius import radius_count
from cpd_tpu_torch.unsupervised import driver as pdriver
from cpd_tpu_torch.unsupervised import ppscore as ppp
from cpd_tpu_torch.utils.synthetic import make_lidar_sequence, write_waymo_sequence


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread for the factory's test files: their plain kernels
    are many small torch operations, which with the default thread count
    wait for threads that other test workers keep busy (the files that
    import this fixture use it too)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("case", ["random", "zeros", "one_window", "one_hot"])
def test_compute_ephe_score_bit_equal(case):
    rng = np.random.default_rng(7)
    counts = {"random": rng.integers(0, 40, (500, 6)),
              "zeros": np.zeros((20, 4), np.int64),
              "one_window": rng.integers(0, 5, (50, 1)),
              "one_hot": np.eye(5, dtype=np.int32)[rng.integers(0, 5, 30)] * 17}[case]
    with np.errstate(divide="ignore", invalid="ignore"):
        want = jpp.compute_ephe_score(counts)
        got = ppp.compute_ephe_score(counts)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)  # NaN and inf in the same places
    if case == "one_window":
        assert not np.isfinite(got).any()


@pytest.mark.parametrize("seed,windows", [(0, 3), (1, 5), (2, 12)])
def test_ppscore_windows_matches_ppscore_jax(seed, windows):
    rng = np.random.default_rng(seed)
    cur = rng.uniform(-2, 2, (300, 3)).astype(np.float32)
    others = rng.uniform(-2, 2, (windows, 400, 3)).astype(np.float32)
    others[:, :100] = cur[None, :100] + rng.normal(0, 0.1, (windows, 100, 3)).astype(np.float32)
    valid = rng.random((windows, 400)) < 0.8
    valid[-1] = False  # a window with no point
    want_c, want_h = jpp.ppscore_jax(jnp.asarray(cur), jnp.asarray(others), jnp.asarray(valid))
    got_c, got_h = ppp.ppscore_windows(torch.from_numpy(cur), torch.from_numpy(others),
                                       torch.from_numpy(valid))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    assert got_c.numpy().sum() > 0
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), rtol=0, atol=1e-6)


def _native_faults(cur, pose, frames, poses, window, radius):
    """Rows of the current frame where JAX's native count differs from
    cKDTree's in some window, and whether the port's counts equal cKDTree's."""
    world = jpp.points_rigid_transform(cur, pose)[:, :3].astype(np.float32)
    n_windows = max(len(frames) // window, 1)
    bad = np.zeros(len(cur), bool)
    port = ppp.ppscore_counts_for_frame(cur, pose, frames, poses, radius, window, device="cpu")
    for w in range(n_windows):
        support = np.concatenate([jpp.points_rigid_transform(f, p)[:, :3] for f, p in zip(
            frames[w * window:(w + 1) * window], poses[w * window:(w + 1) * window])])
        support = support.astype(np.float32)
        kd = cKDTree(support.astype(np.float64)).query_ball_point(
            world.astype(np.float64), r=radius, return_length=True)
        bad |= native.radius_neighbor_count(world, support, radius) != kd
        np.testing.assert_array_equal(port[:, w], kd)
    return bad


def _small_sequence(n_frames, seed=3):
    return make_lidar_sequence(seed, n_frames=n_frames, n_points=1500, r_max=12.0, n_parked=3,
                               n_moving=2, n_walls=1)


@pytest.mark.parametrize("cur,window", [(4, 3), (7, 5)])
def test_ppscore_for_frame_matches_jax(cur, window):
    frames, poses = _small_sequence(12)
    want = jpp.ppscore_for_frame(frames[cur], poses[cur], frames, poses, radius=0.3,
                                 window=window)
    got = ppp.ppscore_for_frame(frames[cur], poses[cur], frames, poses, radius=0.3,
                                window=window, device="cpu")
    bad = _native_faults(frames[cur], poses[cur], frames, poses, window, 0.3)
    print(f"frame {cur}: {bad.sum()} of {len(bad)} points left out (native count != cKDTree)")
    assert bad.mean() < 0.01
    np.testing.assert_array_equal(got[~bad], want[~bad])
    assert np.isfinite(got).all() and 0.0 < got.mean() < 1.0


def test_save_ppscore_matches_jax(tmp_path):
    """Both builders' per-frame f16 files on one written sequence of 10
    frames (two windows of 5), bit-equal where the native count is right."""
    frames, poses = _small_sequence(10, seed=4)
    seq = write_waymo_sequence(tmp_path / "jax", "seq", frames, poses=poses, labels=False)
    shutil.copytree(tmp_path / "jax", tmp_path / "port")
    jdriver.save_ppscore(seq)
    pdriver.save_ppscore(tmp_path / "port" / "waymo_processed_data" / "seq", device="cpu")
    loaded = jdriver.load_sequence(seq)
    pts = [f["points"] for f in loaded]
    left_out = 0
    for i in range(len(frames)):
        want = np.load(seq / "ppscore" / f"{i:04d}.npy")
        got = np.load(tmp_path / "port" / "waymo_processed_data" / "seq" / "ppscore" / f"{i:04d}.npy")
        assert got.dtype == np.float16 and got.shape == want.shape
        bad = _native_faults(pts[i], poses[i], pts, poses, 5, 0.3)
        left_out += bad.sum()
        np.testing.assert_array_equal(got[~bad], want[~bad])
    print(f"{left_out} points left out (native count != cKDTree)")


def test_native_cell_lookup_fault_at_a_cell_edge():
    """Queries 1e-7 below a multiple of the cell: JAX's native library walks
    a shifted float coordinate's cell and miscounts many of them; kernel R1's
    plain version walks integer offsets and equals cKDTree on every one."""
    rng = np.random.default_rng(0)
    support = rng.uniform(-3, 3, (20000, 3)).astype(np.float32)
    q = rng.uniform(-3, 3, (500, 3))
    q = (np.round(q / np.float32(0.3)) * np.float32(0.3) - 1e-7).astype(np.float32)
    kd = cKDTree(support.astype(np.float64)).query_ball_point(q.astype(np.float64), 0.3,
                                                              return_length=True)
    port = radius_count(torch.from_numpy(q), torch.from_numpy(support),
                        torch.zeros(len(support), dtype=torch.int32), 1, 0.3)[:, 0].numpy()
    np.testing.assert_array_equal(port, kd)
    nat = native.radius_neighbor_count(q, support, 0.3)
    if not native.available():
        pytest.skip("the native library did not build: JAX falls back to cKDTree")
    assert (nat != kd).sum() > 0


def test_ppscore_needs_a_card_unless_the_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    frames, poses = _small_sequence(2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ppp.ppscore_for_frame(frames[0], poses[0], frames, poses)


def _r1_case(case):
    """(query, support, window, n_windows) of a table case: points on cell
    faces, a window with no point, every support point in one cell."""
    rng = np.random.default_rng(len(case))
    n, m, windows = 600, 6000, 4
    query = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    support = rng.uniform(-2, 2, (m, 3)).astype(np.float32)
    window = rng.integers(0, windows - 1, m).astype(np.int32)  # the last window empty
    if case == "faces":
        cell = np.float32(0.3 * r1.CELL_MARGIN)
        query[: n // 2] = np.round(query[: n // 2] / cell) * cell
        support[: m // 2] = np.round(support[: m // 2] / cell) * cell
    elif case == "one_cell":
        support = (np.float32(0.05) + rng.uniform(0, 0.2, (m, 3))).astype(np.float32)
        query[: n // 2] = support[: n // 2]
    return (torch.from_numpy(query), torch.from_numpy(support), torch.from_numpy(window),
            windows)


@pytest.mark.parametrize("case", ["faces", "empty_window", "one_cell"])
def test_r1_column_table_and_restated_walk(case):
    """The column table of ``radius_operands`` (built on the CPU by the
    wrapper's own code) equals ``torch.searchsorted`` over the sorted keys
    on every column: the occupied ones, the padded border (empty), the last
    window's (no point). The kernel's walk restated from the runs and pieces
    covers each item's candidates once and counts exactly the plain
    version's counts."""
    query, support, window, windows = _r1_case(case)
    ops = r1.radius_operands(query, support, window, windows, 0.3)
    plan = ops.plan
    nx, ny, nz = ops.dims
    cols = plan.keys // nz
    start = plan.start.long()
    assert torch.equal(start, torch.searchsorted(cols, torch.arange(nx * ny * windows + 1)))
    occupied = torch.unique(cols)
    assert torch.equal(start[occupied + 1] - start[occupied],
                       torch.unique_consecutive(cols, return_counts=True)[1])
    gx, gy = (occupied % (nx * ny)) // ny, occupied % ny
    assert bool(((gx > 0) & (gx < nx - 1) & (gy > 0) & (gy < ny - 1)).all())
    last = (windows - 1) * nx * ny
    assert int(start[last]) == int(start[-1]) == len(support)
    assert int((plan.gstart[1:] - plan.gstart[:-1]).max()) <= r1.GROUP
    runs = r1.cell_runs_reference(plan)
    qpos, win, cand = r1.walk_pairs(plan, runs)
    items = (len(plan.gstart) - 1) * windows
    per_item = runs[:, 1].reshape(items, 9).long().sum(1)
    want = (per_item * (plan.gstart[1:] - plan.gstart[:-1]).long().repeat_interleave(windows))
    assert len(qpos) == int(want.sum())
    e = ops.q[qpos, :3] - ops.pts[cand, :3]
    hit = (e[:, 0] * e[:, 0] + e[:, 1] * e[:, 1]) + e[:, 2] * e[:, 2] <= torch.tensor(
        ops.r2, dtype=torch.float32)
    assert torch.equal(plan.keys[cand] // nz // (nx * ny), win)  # a window's own candidates
    counts = torch.zeros((len(query), windows), dtype=torch.int64)
    counts.index_put_((qpos[hit], win[hit]), torch.ones(int(hit.sum()), dtype=torch.int64),
                      accumulate=True)
    got = torch.zeros_like(counts)
    got[ops.qorder] = counts
    want = r1.radius_count_reference(query, support, window, windows, 0.3)
    assert torch.equal(got.int(), want) and int(want.sum()) > 0
    assert int(want[:, -1].abs().sum()) == 0
