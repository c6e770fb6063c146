"""Parity of the PyTorch port's ops (cpd_tpu_torch.ops) with the JAX package.

The same numpy inputs, made from a seed, go through the JAX function and its
port. Tolerances: integer outputs (voxel keys, coords, counts, rulebooks
where ``found`` holds, voxel-query indices, NMS keep indices) match exactly;
f32 outputs match to 1e-4 (sums are taken in another order, so last-digit
differences are expected)."""
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpd_tpu.ops import box_coders as jbox
from cpd_tpu.ops import gaussian as jgauss
from cpd_tpu.ops import geometry as jgeo
from cpd_tpu.ops import iou3d as jiou
from cpd_tpu.ops import nms as jnms
from cpd_tpu.ops import pallas_conv
from cpd_tpu.ops import pool as jpool
from cpd_tpu.ops import sparse as jsparse
from cpd_tpu.ops import voxelizer as jvox
from cpd_tpu_torch.ops import box_coders, gaussian, geometry, iou3d, nms, pool, sparse, voxelizer
from cpd_tpu_torch.ops.gather_gemm import gather_gemm, gather_gemm_reference
from tests.torch_port_refs import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
F32 = dict(rtol=1e-4, atol=1e-4)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(port, ref, **tol):
    if isinstance(port, torch.Tensor):
        port = port.detach().float().numpy()
    np.testing.assert_allclose(np.asarray(port, np.float32), np.asarray(ref, np.float32),
                               **(tol or F32))


def _random_boxes(rng, n, spread=6.0):
    b = np.zeros((n, 7), np.float32)
    b[:, 0:2] = rng.uniform(-spread, spread, (n, 2))
    b[:, 2] = rng.uniform(-1, 1, n)
    b[:, 3:6] = rng.uniform(0.5, 4.0, (n, 3))
    b[:, 6] = rng.uniform(-np.pi, np.pi, n)
    return b


def test_port_imports_no_jax():
    """Every cpd_tpu_torch module and chip_smoke import without jax, flax,
    yaml, sklearn, matplotlib or anything of cpd_tpu."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import cpd_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(cpd_tpu_torch.__path__, 'cpd_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'flax', 'yaml', 'sklearn', 'matplotlib',\n"
        "                              'cpd_tpu')]\n"
        "assert not bad, bad\n"
        "assert len(names) >= 77, names\n"
        "assert {'cpd_tpu_torch.utils.loss', 'cpd_tpu_torch.parallel.trainer',\n"
        "        'cpd_tpu_torch.ops.cuda_build', 'cpd_tpu_torch.ops.gather_probes',\n"
        "        'cpd_tpu_torch.probes.gather', 'cpd_tpu_torch.config',\n"
        "        'cpd_tpu_torch.utils.yaml_subset', 'cpd_tpu_torch.datasets.waymo_unsupervised',\n"
        "        'cpd_tpu_torch.evaluation.ap', 'cpd_tpu_torch.tools.test',\n"
        "        'cpd_tpu_torch.tools.train', 'cpd_tpu_torch.tools.strip_checkpoint',\n"
        "        'cpd_tpu_torch.tools.merge_detections', 'cpd_tpu_torch.utils.common',\n"
        "        'cpd_tpu_torch.unsupervised.driver', 'cpd_tpu_torch.unsupervised.generators',\n"
        "        'cpd_tpu_torch.unsupervised.outline', 'cpd_tpu_torch.unsupervised.tracker',\n"
        "        'cpd_tpu_torch.unsupervised.ground', 'cpd_tpu_torch.ops.radius',\n"
        "        'cpd_tpu_torch.ops.dbscan', 'cpd_tpu_torch.native',\n"
        "        'cpd_tpu_torch.datasets.kitti', 'cpd_tpu_torch.utils.torch_import',\n"
        "        'cpd_tpu_torch.parallel.comm', 'cpd_tpu_torch.utils.collective',\n"
        "        'cpd_tpu_torch.models.centerpoint', 'cpd_tpu_torch.models.temporal',\n"
        "        'cpd_tpu_torch.models.pfe', 'cpd_tpu_torch.models.part_wraper',\n"
        "        'cpd_tpu_torch.ops.fps', 'cpd_tpu_torch.ops.roipool',\n"
        "        'cpd_tpu_torch.ops.dcn', 'cpd_tpu_torch.models.atss',\n"
        "        'cpd_tpu_torch.models.transformer', 'cpd_tpu_torch.models.vector_pool',\n"
        "        'cpd_tpu_torch.tools.visual_utils'} <= set(names)\n"
        "print(len(names))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_chip_smoke_defines_each_name_once():
    """No function, class or constant of chip_smoke.py is defined twice at
    its top level (Python would keep the later one, silently)."""
    import ast
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    names = []
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.append(node.name)
        elif isinstance(node, ast.Assign):
            names += [t.id for t in node.targets if isinstance(t, ast.Name)]
    assert len(names) > 100
    assert sorted({n for n in names if names.count(n) > 1}) == []


def test_synthetic_frame_copy_identical():
    from cpd_tpu.utils.synthetic import make_lidar_frame as jax_side
    from cpd_tpu_torch.utils.synthetic import make_lidar_frame as port_side
    a_pts, a_valid = jax_side(np.random.default_rng(3), 20_000)
    b_pts, b_valid = port_side(np.random.default_rng(3), 20_000)
    np.testing.assert_array_equal(a_pts, b_pts)
    np.testing.assert_array_equal(a_valid, b_valid)


def test_geometry_and_box_coder():
    rng = np.random.default_rng(0)
    val = rng.uniform(-10, 10, 64).astype(np.float32)
    _close(geometry.limit_period(_t(val)), jgeo.limit_period(jnp.asarray(val)))
    pts = rng.normal(size=(4, 9, 5)).astype(np.float32)
    ang = rng.uniform(-3, 3, 4).astype(np.float32)
    _close(geometry.rotate_points_along_z(_t(pts), _t(ang)),
           jgeo.rotate_points_along_z(jnp.asarray(pts), jnp.asarray(ang)))
    boxes = _random_boxes(rng, 32)
    _close(geometry.boxes_to_corners_bev(_t(boxes)), jgeo.boxes_to_corners_bev(jnp.asarray(boxes)))
    enc = rng.normal(size=(32, 7)).astype(np.float32)
    enc[0, 3] = 50.0  # clamped before exp
    _close(box_coders.ResidualCoder().decode(_t(enc), _t(boxes)),
           jbox.ResidualCoder().decode(jnp.asarray(enc), jnp.asarray(boxes)))


@pytest.mark.parametrize("max_points", [None, 5])
def test_voxelize_matches(max_points):
    rng = np.random.default_rng(1)
    pts = np.concatenate([rng.uniform(-9, 9, (2, 3000, 2)), rng.uniform(-2.5, 4.5, (2, 3000, 1)),
                          rng.uniform(0, 1, (2, 3000, 2))], -1).astype(np.float32)
    pts[:, :1500] = pts[:, :1] + rng.normal(0, 0.05, (2, 1500, 5)).astype(np.float32)  # crowd
    valid = rng.random((2, 3000)) < 0.9
    # a cap below the occupancy exercises the overflow bucket
    args = ((-8.0, -8.0, -2.0, 8.0, 8.0, 4.0), (0.5, 0.5, 0.15), 600)
    ref = jvox.voxelize_batch(jnp.asarray(pts), jvox.VoxelizerSpec.create(
        *args, max_points_per_voxel=max_points), jnp.asarray(valid))
    out = voxelizer.voxelize_batch(_t(pts), voxelizer.VoxelizerSpec.create(
        *args, max_points_per_voxel=max_points), _t(valid))
    assert int(np.asarray(ref.valid).sum(1).min()) == 600  # saturated
    for name in ("coords", "num_points", "valid"):
        np.testing.assert_array_equal(getattr(out, name).numpy(), np.asarray(getattr(ref, name)))
    _close(out.features, ref.features, rtol=1e-5, atol=1e-5)


GRID = jsparse.GridSpec(13, 11, 9)


def _random_keys(rng, n, cap, grid=GRID):
    keys = np.full(cap, jsparse.INVALID_KEY, np.int32)
    keys[:n] = np.sort(rng.choice(grid.num_cells, n, replace=False))
    return keys


def _assert_rulebook(port, ref):
    found = np.asarray(ref.found)
    np.testing.assert_array_equal(port.found.numpy(), found)
    np.testing.assert_array_equal(port.idx.numpy()[found], np.asarray(ref.idx)[found])
    np.testing.assert_array_equal(port.out_keys.numpy(), np.asarray(ref.out_keys))
    np.testing.assert_array_equal(port.out_valid.numpy(), np.asarray(ref.out_valid))


def test_subm_rulebook_matches():
    rng = np.random.default_rng(2)
    keys = np.stack([_random_keys(rng, 300, 400), _random_keys(rng, 250, 400)])
    ref = jsparse.build_subm_rulebook_batched(jnp.asarray(keys), GRID)
    out = sparse.build_subm_rulebook_batched(_t(keys), sparse.GridSpec(*GRID))
    _assert_rulebook(out, ref)


@pytest.mark.parametrize("kernel,stride,padding,cap", [
    ((3, 3, 3), (2, 2, 2), (1, 1, 1), 400),
    ((3, 3, 3), (2, 2, 2), (1, 1, 0), 90),   # cap below occupancy: highest keys dropped
    ((1, 1, 3), (1, 1, 2), (0, 0, 0), 400),  # conv_out: K = 3
])
def test_conv_rulebook_matches(kernel, stride, padding, cap):
    rng = np.random.default_rng(3)
    keys = np.stack([_random_keys(rng, 300, 400), _random_keys(rng, 120, 400)])
    ref, ref_grid = jsparse.build_conv_rulebook_batched(jnp.asarray(keys), GRID, kernel,
                                                        stride, padding, cap)
    out, out_grid = sparse.build_conv_rulebook_batched(_t(keys), sparse.GridSpec(*GRID),
                                                       kernel, stride, padding, cap)
    assert tuple(out_grid) == tuple(ref_grid)
    _assert_rulebook(out, ref)
    if cap == 90:
        assert bool(np.asarray(ref.out_valid).all(axis=1).any())


def test_to_dense_matches():
    rng = np.random.default_rng(4)
    keys = _random_keys(rng, 200, 256)
    feats = rng.normal(size=(256, 6)).astype(np.float32)
    ref = jsparse.to_dense(jnp.asarray(feats), jnp.asarray(keys), GRID, 6)
    out = sparse.to_dense(_t(feats), _t(keys), sparse.GridSpec(*GRID))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("n,k,cin,cout", [(700, 27, 16, 32), (130, 27, 5, 16), (300, 3, 64, 128)])
def test_gather_gemm_reference_matches_pallas(n, k, cin, cout):
    """A1's plain version against the Pallas kernel in interpret mode; junk
    (out-of-range) idx where found is False must not matter."""
    rng = np.random.default_rng(5)
    b, v = 2, 500
    table = rng.normal(size=(b, v, cin)).astype(np.float32)
    idx = rng.integers(0, v, (b, n, k)).astype(np.int32)
    found = rng.random((b, n, k)) < 0.4
    w = (rng.normal(size=(k * cin, cout)) * 0.1).astype(np.float32)
    ref = pallas_conv.gather_gemm(jnp.asarray(table), jnp.asarray(idx), jnp.asarray(found),
                                  jnp.asarray(w), compute_dtype=jnp.float32)
    idx_junk = np.where(found, idx, 10**6).astype(np.int32)
    out = gather_gemm_reference(_t(table), _t(idx_junk), _t(found), _t(w))
    _close(out, ref, rtol=1e-5, atol=1e-5)
    # the CPU wrapper takes the plain version and launches nothing
    launches = gather_gemm.launches
    _close(gather_gemm(_t(table), _t(idx_junk), _t(found), _t(w)), ref, rtol=1e-5, atol=1e-5)
    assert gather_gemm.launches == launches


def test_gather_gemm_rejects_bad_operands():
    t = torch.zeros(1, 4, 3)
    idx = torch.zeros(1, 2, 3, dtype=torch.int32)
    found = torch.zeros(1, 2, 3, dtype=torch.bool)
    w = torch.zeros(9, 8)
    with pytest.raises(TypeError):
        gather_gemm(t, idx.long(), found, w)
    with pytest.raises(TypeError):
        gather_gemm(t, idx, found, w.double())
    with pytest.raises(ValueError):
        gather_gemm(t, idx, found, torch.zeros(8, 8))


def test_sparse_conv_apply_matches():
    rng = np.random.default_rng(6)
    keys = np.stack([_random_keys(rng, 300, 400), _random_keys(rng, 200, 400)])
    feats = rng.normal(size=(2, 400, 8)).astype(np.float32)
    w = (rng.normal(size=(27, 8, 12)) * 0.2).astype(np.float32)
    jrb, _ = jsparse.build_conv_rulebook_batched(jnp.asarray(keys), GRID, (3, 3, 3),
                                                 (2, 2, 2), (1, 1, 1), 300)
    ref = jsparse.sparse_conv_apply_batched(jnp.asarray(feats), jrb, jnp.asarray(w))
    rb, _ = sparse.build_conv_rulebook_batched(_t(keys), sparse.GridSpec(*GRID), (3, 3, 3),
                                               (2, 2, 2), (1, 1, 1), 300)
    _close(sparse.sparse_conv_apply_batched(_t(feats), rb, _t(w)), ref)


@pytest.mark.parametrize("kernel,stride,padding", [
    ((3, 3, 3), (1, 1, 1), (1, 1, 1)),
    ((3, 3, 3), (2, 2, 2), (1, 1, 0)),
    ((1, 1, 3), (1, 1, 2), (0, 0, 0)),
])
def test_sparse_conv_equals_conv3d_on_full_grid(kernel, stride, padding):
    """On a fully occupied grid the sparse conv is a dense conv3d (a
    correlation, taps in (dz, dy, dx) order): checks the tap convention."""
    grid = sparse.GridSpec(6, 5, 7)
    rng = np.random.default_rng(7)
    keys = torch.arange(grid.num_cells, dtype=torch.int32)
    feats = torch.from_numpy(rng.normal(size=(1, grid.num_cells, 3)).astype(np.float32))
    kx, ky, kz = kernel
    w = torch.from_numpy(rng.normal(size=(kx * ky * kz, 3, 4)).astype(np.float32))
    if stride == (1, 1, 1):
        rb = sparse.build_subm_rulebook_batched(keys[None], grid, kernel)
    else:
        rb, _ = sparse.build_conv_rulebook_batched(keys[None], grid, kernel, stride,
                                                   padding, grid.num_cells)
    out = sparse.sparse_conv_apply_batched(feats, rb, w)[0]
    dense = feats[0].reshape(grid.nz, grid.ny, grid.nx, 3).permute(3, 0, 1, 2)[None]
    w5 = w.reshape(kz, ky, kx, 3, 4).permute(4, 3, 0, 1, 2)  # (Cout, Cin, kz, ky, kx)
    ref = torch.nn.functional.conv3d(dense, w5, stride=stride[::-1], padding=padding[::-1])
    ref = ref[0].permute(1, 2, 3, 0).reshape(-1, 4)  # (cells, Cout) in key order
    n = int(rb.out_valid.sum())
    assert n == ref.shape[0]
    _close(out[:n], ref)


def test_boxes_iou_bev_matches():
    rng = np.random.default_rng(8)
    a = _random_boxes(rng, 40, spread=3.0)
    b = _random_boxes(rng, 30, spread=3.0)
    b[:5] = a[:5]  # identical boxes: IoU 1
    ref = jiou.boxes_iou_bev(jnp.asarray(a), jnp.asarray(b))
    out = iou3d.boxes_iou_bev(_t(a), _t(b))
    _close(out, ref)
    assert (np.asarray(ref) > 0).sum() > 40


@pytest.mark.parametrize("width", [3e-8, 1e-10])
def test_boxes_iou3d_of_a_box_narrower_than_the_f32_spacing(width):
    """A proposal narrower than the f32 spacing at its place (its corners
    coincide) against a label box 76 m away: the port's 3D IoU is about 0,
    its BEV overlap bounded by the smaller footprint. The JAX package's reads
    in the millions; at random weights such proposals were sampled as
    foreground RoIs and their regression targets, divided by a diagonal of
    1e-8 m, made the RoI losses reach 1e6-1e10."""
    needle = np.array([[-69.11, 20.03, 2.72, width, width * 0.8, 37.7, -1.43]], np.float32)
    label = np.array([[6.85, 7.57, 0.80, 1.82, 0.81, 1.65, 4.46]], np.float32)
    assert float(iou3d.boxes_iou3d(_t(needle), _t(label)).max()) < 1e-12
    assert float(iou3d.boxes_overlap_bev(_t(needle), _t(label)).max()) <= width * width
    assert float(np.asarray(jiou.boxes_iou3d(jnp.asarray(needle), jnp.asarray(label))).max()) > 1e6


@pytest.mark.parametrize("fast", [True, False])
def test_nms_bev_keep_indices_match(fast):
    rng = np.random.default_rng(9)
    boxes = _random_boxes(rng, 120, spread=5.0)
    scores = rng.random(120).astype(np.float32)
    scores[10:20] = scores[0]  # ties go lowest index first
    valid = rng.random(120) < 0.9
    kw = dict(thresh=0.3, pre_max_size=100, post_max_size=60)
    ref_idx, ref_mask = jnms.nms_bev(jnp.asarray(boxes), jnp.asarray(scores),
                                     valid=jnp.asarray(valid), fast=fast, **kw)
    idx, mask = nms.nms_bev(_t(boxes), _t(scores), valid=_t(valid), fast=fast, **kw)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(ref_mask))
    assert 0 < int(mask.sum()) < 60


def test_decode_bbox_from_heatmap_matches():
    rng = np.random.default_rng(10)
    h, w = 12, 10
    hm = rng.random((3, h, w)).astype(np.float32)
    hm[1, 2, 3] = hm[0, 0, 0]  # a tie
    maps = [rng.normal(size=(d, h, w)).astype(np.float32) for d in (2, 1, 3, 2)]
    args = ((0.5, 0.5, 0.15), (-8.0, -8.0, -2.0, 8.0, 8.0, 4.0))
    ref = jgauss.decode_bbox_from_heatmap(jnp.asarray(hm), *map(jnp.asarray, maps), *args,
                                          8, k=100, score_thresh=0.3,
                                          post_center_limit_range=jnp.asarray(args[1]))
    out = gaussian.decode_bbox_from_heatmap(_t(hm), *map(_t, maps), *args, 8, k=100,
                                            score_thresh=0.3, post_center_limit_range=args[1])
    _close(out[0], ref[0])
    _close(out[1], ref[1])
    for o, r in zip(out[2:], ref[2:]):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))


def test_voxel_query_multi_matches():
    rng = np.random.default_rng(11)
    grid = jsparse.GridSpec(16, 16, 10)
    keys = _random_keys(rng, 500, 600, grid)
    q = np.concatenate([rng.uniform(-8.5, 8.5, (300, 2)), rng.uniform(-2.5, 4.5, (300, 1))],
                       -1).astype(np.float32)
    args = (grid, (0.25, 0.25, 0.15), (-8.0, -8.0, -2.0, 8.0, 8.0, 4.0), 4, (4, 4, 4),
            (0.8, 1.6), 16)
    ref = jpool.voxel_query_multi(jnp.asarray(q), jnp.asarray(keys), *args)
    out = pool.voxel_query_multi(_t(q), _t(keys), sparse.GridSpec(*grid), *args[1:])
    for (i, v, c), (ri, rv, rc) in zip(out, ref):
        np.testing.assert_array_equal(v.numpy(), np.asarray(rv))
        np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
        _close(c, rc, rtol=1e-5, atol=1e-5)
        assert 0 < int(v.sum()) < v.numel()


def test_roi_grid_points_matches():
    boxes = _random_boxes(np.random.default_rng(12), 5)
    _close(pool.roi_grid_points(_t(boxes), 6), jpool.roi_grid_points(jnp.asarray(boxes), 6))


def test_group_and_pool_matches():
    rng = np.random.default_rng(13)
    feats = rng.normal(size=(50, 6)).astype(np.float32)
    idx = rng.integers(0, 50, (40, 16)).astype(np.int32)
    valid = rng.random((40, 16)) < 0.5
    valid[:3] = False  # rows with no neighbour pool to zero
    rel = rng.normal(size=(40, 16, 3)).astype(np.float32)
    w = rng.normal(size=(9, 5)).astype(np.float32)
    ref = jpool.group_and_pool(jnp.asarray(feats), jnp.asarray(idx), jnp.asarray(valid),
                               jnp.asarray(rel), lambda g: jnp.maximum(g @ jnp.asarray(w), 0))
    out = pool.group_and_pool(_t(feats), _t(idx), _t(valid), _t(rel),
                              lambda g: torch.relu(g @ _t(w)))
    _close(out, ref)
