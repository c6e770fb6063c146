"""The last ops of the JAX package against the port, on the CPU: the
geometry helpers, the box coders, the axis-aligned and the class-wise NMS,
``weighted_l1_loss`` and ``odiou_3d`` (loss and gradient), RoI-aware pooling
(max and avg) and RoI-point pooling, the one-sample sparse conv, masked
batch statistics, ``native.available`` and the ``ops`` package's modules.

Seeded numpy inputs go through both packages; integers and masks must be
equal, floats agree to 1e-4 of their scale at f32. Where an integer result
turns on a threshold (a box face, a pooling cell's edge, an NMS IoU), the
test first asserts that its inputs keep a margin from it. The JAX functions
run eagerly where they are not jitted themselves.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cpd_tpu.ops as jops
from cpd_tpu import native as jnative
from cpd_tpu.ops import box_coders as jcoders
from cpd_tpu.ops import geometry as jgeo
from cpd_tpu.ops import nms as jnms
from cpd_tpu.ops import roipool as jroipool
from cpd_tpu.ops import sparse as jsparse
from cpd_tpu.utils import loss as jloss
import cpd_tpu_torch.ops as pops
from cpd_tpu_torch import native
from cpd_tpu_torch.ops import box_coders, geometry, iou3d, nms, roipool, sparse
from cpd_tpu_torch.utils import loss
from tests.torch_port_refs import one_torch_thread  # noqa: F401

TOL = 1e-4


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(port, ref, what):
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape, (what, port.shape, ref.shape)
    scale = max(float(np.abs(ref).max()) if ref.size else 0.0, 1e-6)
    err = float(np.abs(port - ref).max()) if ref.size else 0.0
    assert err <= TOL * scale, f"{what}: max err {err} at scale {scale}"


def _equal(port, ref, what):
    np.testing.assert_array_equal(np.asarray(port), np.asarray(ref), err_msg=what)


def _boxes(rng, n, extra=0, spread=6.0):
    cols = [rng.uniform(-spread, spread, (n, 2)), rng.uniform(-1, 1, (n, 1)),
            rng.uniform(0.8, 4.0, (n, 3)), rng.uniform(-np.pi, np.pi, (n, 1)),
            rng.normal(size=(n, extra))]
    return np.concatenate(cols, -1).astype(np.float32)


def _local64(points, boxes):
    """(M, N, 3) box-local coords in f64, for the margin checks."""
    shifted = points[None, :, :3].astype(np.float64) - boxes[:, None, :3]
    c, s = np.cos(-boxes[:, 6:7].astype(np.float64)), np.sin(-boxes[:, 6:7].astype(np.float64))
    return np.stack([shifted[..., 0] * c - shifted[..., 1] * s,
                     shifted[..., 0] * s + shifted[..., 1] * c, shifted[..., 2]], -1)


def _assert_off_faces(points, boxes, margin=1e-5):
    gap = np.abs(np.abs(_local64(points, boxes)) - boxes[:, None, 3:6].astype(np.float64) / 2)
    assert gap.min() > margin, f"a point lies {gap.min()} from a box face"


# ---- geometry --------------------------------------------------------------


def test_geometry_names_match():
    rng = np.random.default_rng(0)
    pts = np.concatenate([rng.uniform(-8, 8, (300, 2)), rng.uniform(-2, 2, (300, 1)),
                          rng.normal(size=(300, 1))], -1).astype(np.float32)
    boxes = _boxes(rng, 9, extra=1)
    _assert_off_faces(pts, boxes)
    mask = geometry.points_in_boxes_mask(_t(pts), _t(boxes))
    _equal(mask, jgeo.points_in_boxes_mask(jnp.asarray(pts), jnp.asarray(boxes)), "mask")
    assert mask.any(dim=1).sum() >= 5
    _equal(geometry.points_in_box(_t(pts), _t(boxes[3])),
           jgeo.points_in_box(jnp.asarray(pts), jnp.asarray(boxes[3])), "points_in_box")
    bv = np.arange(9) % 3 != 1
    for valid in (None, bv):
        ref = jgeo.points_in_boxes_index(jnp.asarray(pts), jnp.asarray(boxes),
                                         None if valid is None else jnp.asarray(valid))
        got = geometry.points_in_boxes_index(_t(pts), _t(boxes),
                                             None if valid is None else _t(valid))
        assert got.dtype == torch.int32
        _equal(got, ref, f"points_in_boxes_index valid={valid is not None}")
    _close(geometry.enlarge_box3d(_t(boxes), (0.2, 0.3, 0.4)),
           jgeo.enlarge_box3d(jnp.asarray(boxes), (0.2, 0.3, 0.4)), "enlarge_box3d")
    coords = rng.integers(0, 40, (50, 3)).astype(np.int32)
    pcr, vox = (-8.0, -8.0, -2.0, 8.0, 8.0, 4.0), (0.4, 0.4, 0.15)
    _close(geometry.get_voxel_centers(_t(coords), 2, vox, pcr),
           jgeo.get_voxel_centers(jnp.asarray(coords), 2, vox, pcr), "get_voxel_centers")
    cut = (-6.0, -5.0, -1.0, 6.5, 5.5, 1.5)
    _equal(geometry.mask_points_outside_range(_t(pts), cut),
           jgeo.mask_points_outside_range(jnp.asarray(pts), cut), "mask_points_outside_range")
    far = _boxes(rng, 40, spread=9.0)
    for corners in (1, 2, 4):
        _equal(geometry.mask_boxes_outside_range(_t(far), cut, corners),
               jgeo.mask_boxes_outside_range(jnp.asarray(far), cut, corners),
               f"mask_boxes_outside_range {corners}")


# ---- box coders ------------------------------------------------------------


@pytest.mark.parametrize("sincos", [False, True])
@pytest.mark.parametrize("name", ["ResidualCoder", "ResidualCoderV2"])
def test_residual_coders_match(name, sincos):
    """encode and decode on boxes with two extra columns (plain deltas)."""
    rng = np.random.default_rng(1)
    boxes, anchors = _boxes(rng, 20, extra=2), _boxes(rng, 20, extra=2)
    jc = getattr(jcoders, name)(encode_angle_by_sincos=sincos)
    pc = getattr(box_coders, name)(encode_angle_by_sincos=sincos)
    assert pc.code_size == jc.code_size == 7 + sincos
    enc = pc.encode(_t(boxes), _t(anchors))
    _close(enc, jc.encode(jnp.asarray(boxes), jnp.asarray(anchors)), f"{name} encode")
    assert enc.shape[-1] == jc.code_size + 2
    codes = rng.normal(size=(20, jc.code_size + 2)).astype(np.float32) * 0.5
    _close(pc.decode(_t(codes), _t(anchors)), jc.decode(jnp.asarray(codes), jnp.asarray(anchors)),
           f"{name} decode")


@pytest.mark.parametrize("mean_size", [True, False])
def test_point_residual_coder_matches(mean_size):
    rng = np.random.default_rng(2)
    sizes = [[3.9, 1.6, 1.56], [0.8, 0.6, 1.73], [1.76, 0.6, 1.73]]
    gt, pts = _boxes(rng, 30), rng.normal(size=(30, 3)).astype(np.float32)
    cls = rng.integers(1, 4, 30).astype(np.int32)
    jc = jcoders.PointResidualCoder(use_mean_size=mean_size, mean_size=sizes)
    pc = box_coders.PointResidualCoder(use_mean_size=mean_size, mean_size=sizes)
    _close(pc.encode(_t(gt), _t(pts), _t(cls)),
           jc.encode(jnp.asarray(gt), jnp.asarray(pts), jnp.asarray(cls)), "encode")
    codes = rng.normal(size=(30, 8)).astype(np.float32) * 0.5
    _close(pc.decode(_t(codes), _t(pts), _t(cls)),
           jc.decode(jnp.asarray(codes), jnp.asarray(pts), jnp.asarray(cls)), "decode")


@pytest.mark.parametrize("name", ["PreviousResidualDecoder", "PreviousResidualRoIDecoder"])
def test_previous_residual_decoders_match(name):
    rng = np.random.default_rng(3)
    prev, codes = _boxes(rng, 25), rng.normal(size=(25, 7)).astype(np.float32) * 0.5
    assert getattr(box_coders, name)().code_size == 7
    _close(getattr(box_coders, name).decode(_t(codes), _t(prev)),
           getattr(jcoders, name).decode(jnp.asarray(codes), jnp.asarray(prev)), name)


# ---- NMS -------------------------------------------------------------------


def _nms_scene(rng, n=60):
    boxes = _boxes(rng, n, spread=5.0)
    boxes[n // 2:, :3] = boxes[:n // 2, :3] + rng.normal(0, 0.3, (n - n // 2, 3))
    scores = rng.random(n).astype(np.float32)
    return boxes, scores


def _assert_iou_margin(iou, thresh, margin=1e-4):
    gap = np.abs(iou - thresh)
    np.fill_diagonal(gap, 1.0)
    assert gap.min() > margin, f"an IoU lies {gap.min()} from the threshold {thresh}"


def test_nms_normal_bev_matches():
    rng = np.random.default_rng(4)
    boxes, scores = _nms_scene(rng)
    valid = rng.random(60) < 0.9
    iou = iou3d.boxes_aligned_iou_bev(_t(boxes), _t(boxes)).numpy()
    _assert_iou_margin(iou, 0.1)
    ref = jnms.nms_normal_bev(jnp.asarray(boxes), jnp.asarray(scores), 0.1, pre_max_size=48,
                              post_max_size=20, valid=jnp.asarray(valid))
    got = nms.nms_normal_bev(_t(boxes), _t(scores), 0.1, pre_max_size=48, post_max_size=20,
                             valid=_t(valid))
    _equal(got[1], ref[1], "keep")
    _equal(got[0][got[1]], np.asarray(ref[0])[np.asarray(ref[1])], "kept indices")
    assert 3 < int(got[1].sum()) < 20


@pytest.mark.parametrize("fast", [False, True])
def test_class_agnostic_and_multi_classes_nms_match(fast):
    rng = np.random.default_rng(5)
    boxes, _ = _nms_scene(rng)
    cls = rng.random((60, 3)).astype(np.float32)
    cfg = {"NMS_THRESH": 0.3, "NMS_PRE_MAXSIZE": 50, "NMS_POST_MAXSIZE": 24,
           "USE_FAST_NMS": fast}
    with torch.no_grad():
        iou = iou3d.boxes_iou_bev(_t(boxes), _t(boxes)).numpy()
    _assert_iou_margin(iou, 0.3)
    assert np.abs(cls - 0.2).min() > 1e-4
    ref = jnms.class_agnostic_nms(jnp.asarray(cls[:, 0]), jnp.asarray(boxes), cfg, 0.2)
    got = nms.class_agnostic_nms(_t(cls[:, 0]), _t(boxes), cfg, 0.2)
    _equal(got[1], ref[1], "keep")
    _equal(got[0][got[1]], np.asarray(ref[0])[np.asarray(ref[1])], "kept indices")
    _close(got[2], ref[2], "scores")
    ref = jnms.multi_classes_nms(jnp.asarray(cls), jnp.asarray(boxes), cfg, 0.2)
    got = nms.multi_classes_nms(_t(cls), _t(boxes), cfg, 0.2)
    _equal(got[1], ref[1], "multi keep")
    _equal(torch.where(got[1], got[0], -1), np.where(ref[1], ref[0], -1), "multi indices")
    _close(got[2], ref[2], "multi scores")
    assert got[1].shape == (3, 24) and int(got[1].sum()) > 10


# ---- losses ----------------------------------------------------------------


def test_weighted_l1_loss_matches():
    rng = np.random.default_rng(6)
    p, t = rng.normal(size=(2, 30, 7)).astype(np.float32), rng.normal(size=(2, 30, 7))
    w, cw = rng.random((2, 30)).astype(np.float32), [1.0, 1.0, 2.0, 1.0, 1.0, 1.0, 0.5]
    t = t.astype(np.float32)
    for code_weights in (None, cw):
        _close(loss.weighted_l1_loss(_t(p), _t(t), _t(w), code_weights),
               jloss.weighted_l1_loss(jnp.asarray(p), jnp.asarray(t), jnp.asarray(w),
                                      code_weights), f"weighted_l1_loss {code_weights}")


@pytest.mark.parametrize("weighted", [False, True])
def test_odiou_3d_loss_and_gradient_match(weighted):
    """Predictions near their labels (rotated, shifted, resized): the loss
    and its gradient with respect to every predicted box value."""
    rng = np.random.default_rng(7)
    gt = _boxes(rng, 12)
    pred = gt + np.concatenate([rng.normal(0, 0.3, (12, 3)), rng.normal(0, 0.2, (12, 3)),
                                rng.normal(0, 0.3, (12, 1))], -1).astype(np.float32)
    pred[:, 3:6] = np.abs(pred[:, 3:6]) + 0.3
    w = rng.random(12).astype(np.float32) if weighted else None
    jw = None if w is None else jnp.asarray(w)
    jl, jg = jax.jit(jax.value_and_grad(lambda p: jloss.odiou_3d(p, jnp.asarray(gt), jw)))(
        jnp.asarray(pred))
    p = _t(pred).requires_grad_()
    got = loss.odiou_3d(p, _t(gt), None if w is None else _t(w))
    got.backward()
    assert 0.1 < float(jl) < 0.95
    assert abs(float(got.detach()) - float(jl)) <= TOL * float(jl)
    _close(p.grad, jg, "d loss / d pred")


# ---- RoI pooling -----------------------------------------------------------


def _roi_scene(seed):
    rng = np.random.default_rng(seed)
    boxes = _boxes(rng, 8, spread=4.0)
    boxes[-1, 3:6] = 0.3  # a small RoI
    pts = np.concatenate([rng.uniform(-6, 6, (2000, 2)), rng.uniform(-2, 2, (2000, 1))],
                         -1).astype(np.float32)
    feats = rng.normal(size=(2000, 4)).astype(np.float32)
    return pts, feats, boxes, rng.random(2000) < 0.9, np.arange(8) != 2


@pytest.mark.parametrize("pool_method", ["max", "avg"])
def test_roiaware_pool3d_matches(pool_method):
    """out_size 4 on 8 RoIs (one invalid, one empty) over 2000 points;
    every point keeps 1e-5 m (20 f32 ulps at 6 m) from each box face and
    pooling-cell edge."""
    pts, feats, boxes, pv, bv = _roi_scene(8)
    g = 4
    _assert_off_faces(pts, boxes)
    local = _local64(pts, boxes)
    dims = boxes[:, None, 3:6].astype(np.float64)
    inside = (np.abs(local) <= dims / 2).all(-1)
    edge = ((local + dims / 2) / (dims / g))[inside]
    assert np.abs(edge - np.round(edge)).min() * (boxes[:, 3:6].min() / g) > 1e-5
    ref = jroipool.roiaware_pool3d(jnp.asarray(pts), jnp.asarray(feats), jnp.asarray(boxes),
                                   out_size=g, pool_method=pool_method,
                                   points_valid=jnp.asarray(pv), boxes_valid=jnp.asarray(bv))
    got = roipool.roiaware_pool3d(_t(pts), _t(feats), _t(boxes), out_size=g,
                                  pool_method=pool_method, points_valid=_t(pv),
                                  boxes_valid=_t(bv))
    assert got.shape == (8, g, g, g, 4)
    _equal(got == 0, np.asarray(ref) == 0, "empty cells")
    _close(got, ref, f"roiaware_pool3d {pool_method}")
    assert (got[:2] != 0).any(dim=-1).sum() > 10 and not got[2].any()


def test_roipoint_pool3d_matches():
    pts, feats, boxes, pv, bv = _roi_scene(9)
    _assert_off_faces(pts, boxes)
    for k in (16, 256):
        ref = jroipool.roipoint_pool3d(jnp.asarray(pts), jnp.asarray(feats), jnp.asarray(boxes),
                                       num_sampled=k, points_valid=jnp.asarray(pv),
                                       boxes_valid=jnp.asarray(bv))
        got = roipool.roipoint_pool3d(_t(pts), _t(feats), _t(boxes), num_sampled=k,
                                      points_valid=_t(pv), boxes_valid=_t(bv))
        _equal(got[1], ref[1], f"pooled_valid {k}")
        _equal(got[2], ref[2], f"empty {k}")
        _close(got[0], ref[0], f"pooled {k}")
        assert bool(got[2][2]) and int(got[1].sum()) > 20


# ---- the one-sample sparse conv and masked statistics ----------------------


@pytest.mark.parametrize("with_bias", [False, True])
def test_sparse_conv_apply_matches(with_bias):
    """One sample's submanifold conv (3 x 3 x 3) on 150 of 6 x 5 x 8 cells;
    the port's rulebook, handed to JAX as its own."""
    rng = np.random.default_rng(10)
    grid = sparse.GridSpec(6, 5, 8)
    keys = np.full(180, sparse.INVALID_KEY, np.int32)
    keys[:150] = np.sort(rng.choice(grid.num_cells, 150, replace=False))
    book = sparse.build_subm_rulebook(_t(keys), grid)
    feats = rng.normal(size=(180, 8)).astype(np.float32)
    w = rng.normal(size=(27, 8, 16)).astype(np.float32) * 0.2
    bias = rng.normal(size=16).astype(np.float32) if with_bias else None
    jbook = jsparse.Rulebook(*(jnp.asarray(f.numpy()) for f in book))
    ref = jsparse.sparse_conv_apply(jnp.asarray(feats), jbook, jnp.asarray(w),
                                    None if bias is None else jnp.asarray(bias))
    got = sparse.sparse_conv_apply(_t(feats), book, _t(w), None if bias is None else _t(bias))
    assert got.dtype == torch.float32
    _close(got, ref, "sparse_conv_apply")
    assert not got[150:].any()


def test_masked_batch_stats_match():
    rng = np.random.default_rng(11)
    x = rng.normal(1.0, 2.0, (2, 40, 6)).astype(np.float32)
    valid = rng.random((2, 40)) < 0.6
    for got, ref in zip(sparse.masked_batch_stats(_t(x), _t(valid)),
                        jsparse.masked_batch_stats(jnp.asarray(x), jnp.asarray(valid))):
        _close(got, ref, "masked_batch_stats")


def test_native_available_and_ops_exports_match():
    assert native.available() is True and jnative.available() is True
    for name in ("geometry", "iou3d", "nms", "box_coders", "roipool"):
        assert hasattr(jops, name) and hasattr(pops, name), name
