"""Integer cells from a quotient by a constant, held to the jitted JAX package.

Every JAX caller reaches these under ``jit``, where XLA rewrites ``x / c`` for
a constant ``c`` as ``x * (1 / c)`` with the reciprocal rounded to f32 once.
The two differ in the last bit for some ``x``, and ``floor`` turns that bit
into another cell. The port computes the product, so its cells are those of
the jitted program:

* the voxel keys (``ops.voxelizer.compute_voxel_keys``): on the bench frame
  (``bench.py``'s range and 0.1 x 0.1 x 0.15 m voxels, 200,000 points) and
  on a second seed, key for key, and ``voxelize`` there;
* the RoI voxel query's cells (``ops.pool.query_cells``, read by
  ``voxel_query``, ``voxel_query_fast`` and ``voxel_query_multi``) at
  downsample 1, 4 and 8, and the queries themselves on points at cell faces;
* the CenterHead's target pixels (``ops.gaussian.assign_center_targets``).

Each input holds values whose exact quotient floors to another integer: the
tests assert that, so they keep seeing the fault they guard against.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpd_tpu.ops import gaussian as jgauss
from cpd_tpu.ops import pool as jpool
from cpd_tpu.ops import sparse as jsparse
from cpd_tpu.ops import voxelizer as jvox
from cpd_tpu_torch.ops import gaussian, pool, sparse, voxelizer
from cpd_tpu_torch.utils.synthetic import make_lidar_frame
from tests.torch_port_refs import one_torch_thread  # noqa: F401

BENCH_RANGE = (-75.2, -75.2, -2.0, 75.2, 75.2, 4.0)
BENCH_VOXEL = (0.1, 0.1, 0.15)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _at_faces(rng, origin, cell, n_cells, n, ulps=3):
    """f32 values within ``ulps`` of ``n`` faces ``origin + k * cell`` (the
    faces computed in f64), drawn at random from ``n_cells`` faces."""
    k = rng.integers(1, n_cells, n)
    face = np.float32(origin + k * np.float64(cell))
    steps = rng.integers(-ulps, ulps + 1, n)
    out = face.copy()
    for _ in range(ulps):
        out = np.where(steps > 0, np.nextafter(out, np.float32(np.inf)), out)
        out = np.where(steps < 0, np.nextafter(out, np.float32(-np.inf)), out)
        steps = steps - np.sign(steps)
    return out.astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_voxel_keys_equal_jitted_jax_on_the_bench_frame(seed):
    pts, valid = make_lidar_frame(np.random.default_rng(seed), 200_000)
    jspec = jvox.VoxelizerSpec.create(BENCH_RANGE, BENCH_VOXEL, 90_000)
    spec = voxelizer.VoxelizerSpec.create(BENCH_RANGE, BENCH_VOXEL, 90_000)
    ref = np.asarray(jax.jit(lambda p, v: jvox.compute_voxel_keys(p, jspec, v))(pts, valid))
    eager = np.asarray(jvox.compute_voxel_keys(jnp.asarray(pts), jspec, jnp.asarray(valid)))
    assert (eager != ref).sum() > 0  # the frame holds points on voxel faces
    out = voxelizer.compute_voxel_keys(_t(pts), spec, _t(valid)).numpy()
    bad = np.nonzero(out != ref)[0]
    assert not len(bad), f"{len(bad)} keys differ, first at point {bad[:5]}: {out[bad[:5]]} " \
                         f"against {ref[bad[:5]]}"
    if seed == 0:  # the voxel table that predict reads
        jframe = jvox.voxelize(jnp.asarray(pts), jspec, jnp.asarray(valid))
        frame = voxelizer.voxelize(_t(pts), spec, _t(valid))
        for name in ("coords", "num_points", "valid"):
            np.testing.assert_array_equal(getattr(frame, name).numpy(),
                                          np.asarray(getattr(jframe, name)), err_msg=name)
        np.testing.assert_allclose(frame.features.numpy(), np.asarray(jframe.features),
                                   rtol=1e-5, atol=1e-5)


@partial(jax.jit, static_argnames=("voxel_size", "pcr", "downsample"))
def _jax_cells(q, voxel_size, pcr, downsample):
    """The JAX voxel query's cell expression (``cpd_tpu/ops/pool.py``), jitted."""
    vs = jnp.asarray(voxel_size, jnp.float32) * downsample
    return jnp.floor((q - jnp.asarray(pcr[:3], jnp.float32)) / vs).astype(jnp.int32)


@pytest.mark.parametrize("downsample", [1, 4, 8])
def test_query_cells_equal_jitted_jax(downsample):
    rng = np.random.default_rng(downsample)
    lo, hi = np.float32(BENCH_RANGE[:3]), np.float32(BENCH_RANGE[3:])
    q = rng.uniform(lo, hi, (2_000_000, 3)).astype(np.float32)
    cell = np.float32(BENCH_VOXEL) * np.float32(downsample)
    for axis in range(3):  # and 30,000 queries within 3 ulps of a cell face on each axis
        n_cells = int((hi[axis] - lo[axis]) / cell[axis])
        q[axis::3][:30_000, axis] = _at_faces(rng, BENCH_RANGE[axis], cell[axis], n_cells,
                                              30_000)
    ref = np.asarray(_jax_cells(q, BENCH_VOXEL, BENCH_RANGE, downsample))
    qt = _t(q)
    vs = torch.tensor(BENCH_VOXEL, dtype=torch.float32) * downsample
    pcr = torch.tensor(BENCH_RANGE[:3], dtype=torch.float32)
    assert (torch.floor((qt - pcr) / vs).numpy() != ref).any()  # faces the division misplaces
    out = pool.query_cells(qt, pcr, vs).to(torch.int32).numpy()
    bad = np.nonzero((out != ref).any(-1))[0]
    assert not len(bad), f"{len(bad)} of {len(q)} cells differ, first at query {bad[:5]}"


def test_voxel_queries_at_cell_faces_match_jitted_jax():
    """The three queries on points at cell faces, against the JAX functions
    jitted with their sizes constant, as the JAX detector's jitted forward
    calls them (called alone, ``voxel_query`` traces its voxel size and
    divides). ``voxel_query_multi`` (the RoI head's, taps in a fixed order):
    the same indices and validity, centres within 1e-5. The nearest-first
    ``voxel_query`` and ``voxel_query_fast``, with ``nsample`` the whole
    window: the same voxels found a query. A query on a face is equidistant
    from two voxel centres, and XLA computes the centres with a fused
    multiply-add, so the order of such ties is not theirs to hold."""
    rng = np.random.default_rng(21)
    grid = jsparse.GridSpec(32, 32, 20)  # 0.2 x 0.2 x 0.3 m cells: BENCH_VOXEL at downsample 2
    pcr, vs, ds = (-3.2, -3.2, -2.0, 3.2, 3.2, 4.0), BENCH_VOXEL, 2
    n = 4000
    keys = np.unique(rng.integers(0, grid.nx * grid.ny * grid.nz, 3000)).astype(np.int32)
    keys = np.concatenate([keys, np.full(3000 - len(keys), jsparse.INVALID_KEY, np.int32)])
    q = rng.uniform(np.float32(pcr[:3]), np.float32(pcr[3:]), (n, 3)).astype(np.float32)
    for axis in range(3):
        cell = np.float32(vs[axis]) * np.float32(ds)
        q[:, axis] = np.where(rng.random(n) < 0.7, _at_faces(rng, pcr[axis], cell, grid[axis], n),
                              q[:, axis])
    qt, kt = _t(q), _t(keys)
    cells = torch.tensor(vs, dtype=torch.float32) * ds
    origin = torch.tensor(pcr[:3], dtype=torch.float32)
    assert (torch.floor((qt - origin) / cells) != pool.query_cells(qt, origin, cells)).any()
    pgrid = sparse.GridSpec(*grid)
    # radii that no sum of squared face distances (0.1, 0.3, 0.5; 0.15, 0.45 m) meets
    multi = (grid, vs, pcr, ds, (1, 1, 1), (0.43, 0.77), 8)
    ref = jax.jit(lambda a, b: jpool.voxel_query_multi(a, b, *multi))(q, keys)
    for r, ((idx, valid, centers), (ridx, rvalid, rcenters)) in enumerate(zip(
            pool.voxel_query_multi(qt, kt, pgrid, *multi[1:]), ref)):
        np.testing.assert_array_equal(valid.numpy(), np.asarray(rvalid), err_msg=f"radius {r}")
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ridx), err_msg=f"radius {r}")
        np.testing.assert_allclose(centers.numpy(), np.asarray(rcenters), rtol=1e-5, atol=1e-5)
        assert 0 < int(valid.sum()) < valid.numel()
    single = (grid, vs, pcr, ds, (1, 1, 1), 0.47, 27)
    for name, port_fn, jax_fn in (("voxel_query", pool.voxel_query, jpool.voxel_query),
                                  ("voxel_query_fast", pool.voxel_query_fast,
                                   jpool.voxel_query_fast)):
        idx, valid, _ = port_fn(qt, kt, pgrid, *single[1:])
        ridx, rvalid, _ = map(np.asarray, jax.jit(lambda a, b: jax_fn(a, b, *single))(q, keys))
        found = np.sort(np.where(valid.numpy(), idx.numpy(), -1), axis=1)
        np.testing.assert_array_equal(found, np.sort(np.where(rvalid, ridx, -1), axis=1),
                                      err_msg=name)
        assert 0 < int(valid.sum()) < valid.numel(), name


def test_center_target_pixels_equal_jitted_jax():
    """Box centres at pixel edges of the 0.8 m CenterHead map: the same
    pixels, masks and heatmaps as ``assign_center_targets`` jitted with its
    sizes constant, as the JAX CenterHead's loss runs it under the trainer's
    jit (called alone, it traces them and divides)."""
    rng = np.random.default_rng(7)
    pcr, vs, fm, n = BENCH_RANGE, BENCH_VOXEL, (24, 24), 256
    gt = np.zeros((n, 8), np.float32)
    for axis in (0, 1):
        gt[:, axis] = _at_faces(rng, pcr[axis], np.float32(vs[axis] * 8), fm[1 - axis], n)
    gt[:, 2] = rng.uniform(-1, 1, n)
    gt[:, 3:6] = rng.uniform(0.5, 5.0, (n, 3))
    gt[:, 6] = rng.uniform(-np.pi, np.pi, n)
    gt[:, 7] = rng.integers(1, 4, n)
    valid = np.ones(n, bool)
    ref = jax.jit(lambda g, v: jgauss.assign_center_targets(g, v, 3, fm, vs, pcr, 8, 0.1, 2))(
        gt, valid)
    divided = jgauss.assign_center_targets(jnp.asarray(gt), jnp.asarray(valid), 3, fm, vs, pcr,
                                           8, 0.1, 2)
    assert (np.asarray(divided["inds"]) != np.asarray(ref["inds"])).any()
    out = gaussian.assign_center_targets(_t(gt), _t(valid), 3, fm, vs, pcr, 8, 0.1, 2)
    np.testing.assert_array_equal(out["mask"].numpy(), np.asarray(ref["mask"]))
    np.testing.assert_array_equal(out["inds"].numpy(), np.asarray(ref["inds"]))
    np.testing.assert_allclose(out["heatmap"].numpy(), np.asarray(ref["heatmap"]), atol=1e-6)
    np.testing.assert_allclose(out["target_boxes"].numpy(), np.asarray(ref["target_boxes"]),
                               rtol=1e-5, atol=1e-5)
    assert int(out["mask"].sum()) > n // 2
