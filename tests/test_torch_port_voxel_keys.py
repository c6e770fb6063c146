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
* the CenterHead's target pixels (``ops.gaussian.assign_center_targets``);
* the nearest-first voxel query's centres (``ops.pool.voxel_centers``): XLA
  contracts ``(c + 0.5) * vs + pcr`` into a fused multiply-add, and the order
  of two equidistant voxels follows the centres' last bit.

Each input holds values whose exact quotient floors to another integer: the
tests assert that, so they keep seeing the fault they guard against.
"""
import hashlib
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
from tests import torch_port_refs as refs
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
    window: the same voxels found a query (their order on 2,000,000 queries:
    ``test_nearest_voxel_query_orders_ties_as_jitted_jax``)."""
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


AUDIT_QUERIES = 2_000_000
AUDIT_CHUNK = 20_000  # queries a call: the port's (Q, 27, 3) temporaries stay in cache
AUDIT_BLOCK = 1_000   # queries a digest
AUDIT_REF = "voxel_query_order"
AUDIT_QUERY = (jsparse.GridSpec(32, 32, 20), BENCH_VOXEL, (-3.2, -3.2, -2.0, 3.2, 3.2, 4.0), 2,
               (1, 1, 1), 0.47, 27)


def _audit_queries():
    """The seeded queries and voxel keys of the audit: half the queries on
    cell faces in each axis, where two voxel centres lie at the same distance."""
    rng = np.random.default_rng(22)
    grid, vs, pcr, ds = AUDIT_QUERY[:4]
    keys = np.unique(rng.integers(0, grid.nx * grid.ny * grid.nz, 12000)).astype(np.int32)
    q = rng.uniform(np.float32(pcr[:3]), np.float32(pcr[3:]),
                    (AUDIT_QUERIES, 3)).astype(np.float32)
    for axis in range(3):
        cell = np.float32(vs[axis]) * np.float32(ds)
        on_face = rng.random(AUDIT_QUERIES) < 0.5
        q[:, axis] = np.where(on_face, _at_faces(rng, pcr[axis], cell, grid[axis], AUDIT_QUERIES,
                                                 ulps=0), q[:, axis])
    return q, keys


def _block_digests(idx):
    """A 64-bit digest of each ``AUDIT_BLOCK`` queries' (Q, 27) int32 indices."""
    flat = np.ascontiguousarray(idx, dtype="<i4")
    return np.array([np.frombuffer(hashlib.blake2b(flat[s:s + AUDIT_BLOCK].tobytes(),
                                                   digest_size=8).digest(), "<u8")[0]
                     for s in range(0, len(flat), AUDIT_BLOCK)], np.uint64)


def test_nearest_voxel_query_orders_ties_as_jitted_jax():
    """``voxel_query`` (nearest first, ``nsample`` the whole 27-voxel window)
    on 2,000,000 seeded queries (``_audit_queries``): the same indices in the
    same order as the jitted JAX query, whose order is committed as one digest
    a block of 1,000 queries (``tests/torch_port_refs/voxel_query_order.npz``).
    The centres' fused multiply-add decides the ties; rounding the product
    first (the port before the repair) gives another centre in 44 of the 102
    cell coordinates below and ordered 81,336 of the first 250,000 queries
    otherwise, the first at query 6."""
    q, keys = _audit_queries()
    grid, vs, pcr, ds = AUDIT_QUERY[:4]
    cells = torch.arange(-1, 33)[:, None].expand(-1, 3)
    cell_size = torch.tensor(vs, dtype=torch.float32) * ds
    origin = torch.tensor(pcr[:3], dtype=torch.float32)
    assert ((cells.float() + 0.5) * cell_size + origin != pool.voxel_centers(
        cells, cell_size, origin)).any()  # the product rounded first misplaces centres
    kt, pgrid = _t(keys), sparse.GridSpec(*grid)
    found, digests = 0, []
    for start in range(0, AUDIT_QUERIES, AUDIT_CHUNK):
        idx, valid, _ = pool.voxel_query(_t(q[start:start + AUDIT_CHUNK]), kt, pgrid,
                                         *AUDIT_QUERY[1:])
        digests.append(_block_digests(idx.numpy()))
        found += int(valid.sum())
    bad = np.nonzero(np.concatenate(digests) != refs.load(AUDIT_REF)["digests"])[0]
    assert not len(bad), (f"{len(bad)} of {AUDIT_QUERIES // AUDIT_BLOCK} blocks of "
                          f"{AUDIT_BLOCK} queries ordered otherwise, the first from query "
                          f"{bad[0] * AUDIT_BLOCK}")
    assert 0 < found < AUDIT_QUERIES * 27


@pytest.mark.slow
def test_voxel_query_order_reference_is_regenerated():
    q, keys = _audit_queries()
    jax_query = jax.jit(lambda a, b: jpool.voxel_query(a, b, *AUDIT_QUERY)[0])
    refs.assert_regenerated(AUDIT_REF, {"digests": np.concatenate([
        _block_digests(np.asarray(jax_query(q[s:s + AUDIT_CHUNK], keys)))
        for s in range(0, AUDIT_QUERIES, AUDIT_CHUNK)])})


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
