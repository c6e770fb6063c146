"""Losses, targets and RoI sampling of the PyTorch port against the JAX package.

The same numpy inputs go through each JAX function and its port, f32 on the
CPU. Values and gradients match to 1e-5 (elementwise maths; a sum in another
order costs the last digit) unless a test says otherwise; masks, labels and
selected indices match exactly.

``jax.random`` cannot be reproduced by torch, so the RoI sampling is fed the
same numpy-drawn uniforms on both sides: the port takes them as an argument,
and ``injected_sampling_uniforms`` patches, inside the test process only, the
``jax`` name that ``cpd_tpu.models.roi_head`` looks its random functions up
through. No file of the JAX package changes.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpd_tpu.models import center_head as jch
from cpd_tpu.models import roi_head as jroi
from cpd_tpu.ops import gaussian as jgauss
from cpd_tpu.ops.box_coders import ResidualCoder as JCoder
from cpd_tpu.utils import loss as jloss
from cpd_tpu_torch.models import center_head, roi_head
from cpd_tpu_torch.ops import gaussian
from cpd_tpu_torch.ops.box_coders import ResidualCoder
from cpd_tpu_torch.utils import loss as ploss
from tests.torch_port_refs import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class _InjectedRandom:
    """Stands in for ``jax.random`` inside cpd_tpu.models.roi_head: the head's
    per-sample split hands out rows of the (B, 6, R) table, the per-use split
    of ``sample_rois_for_rcnn`` its 6 rows, and ``uniform`` reads a row."""

    def __init__(self, table):
        self.table = jnp.asarray(table)

    def split(self, key, num):
        if jnp.issubdtype(jnp.asarray(key).dtype, jnp.floating):
            return key  # one sample's (6, R) rows: unpacked into the 6 uses
        return self.table

    @staticmethod
    def uniform(key, shape):
        return key[:shape[0]]


class _JaxShim:
    def __init__(self, table):
        self.random = _InjectedRandom(table)

    def __getattr__(self, name):
        return getattr(jax, name)


@contextlib.contextmanager
def injected_sampling_uniforms(table):
    """Make the JAX RoI sampling read its uniforms from ``table`` (B, 6, R),
    rows in the order of ``roi_head.SAMPLING_UNIFORMS``."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jroi, "jax", _JaxShim(table))
        yield


def port_uniforms(table):
    """The same table as the port's {name: (B, R)} argument."""
    return {name: _t(np.asarray(table)[:, i]) for i, name in
            enumerate(roi_head.SAMPLING_UNIFORMS)}


def _random_boxes(rng, shape, spread=6.0):
    b = np.zeros(shape + (7,), np.float32)
    b[..., 0:2] = rng.uniform(-spread, spread, shape + (2,))
    b[..., 2] = rng.uniform(-1, 1, shape)
    b[..., 3:6] = rng.uniform(0.8, 4.0, shape + (3,))
    b[..., 6] = rng.uniform(-np.pi, np.pi, shape)
    return b


def _value_and_grads(jfn, pfn, *arrays):
    """Values and gradients (w.r.t. every array) of a scalar-valued function,
    JAX side and port side."""
    jval, jgrads = jax.value_and_grad(jfn, argnums=tuple(range(len(arrays))))(
        *(jnp.asarray(a) for a in arrays))
    tensors = [_t(a).requires_grad_() for a in arrays]
    pval = pfn(*tensors)
    pval.backward()
    np.testing.assert_allclose(float(pval.detach()), float(jval), **TOL)
    for t, g in zip(tensors, jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), **TOL)
    return float(jval)


def test_elementwise_losses_match():
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (3, 9, 7)).astype(np.float32)
    y = rng.normal(0, 1, (3, 9, 7)).astype(np.float32)
    w = (rng.uniform(0.2, 1.0, (3, 9)) * (rng.random((3, 9)) < 0.6)).astype(np.float32)
    for beta in (1.0 / 9.0, 1.0):
        np.testing.assert_allclose(_np(ploss.smooth_l1(_t(x), beta)),
                                   np.asarray(jloss.smooth_l1(jnp.asarray(x), beta)), **TOL)
    _value_and_grads(lambda a, b: jnp.sum(jloss.weighted_smooth_l1_loss(a, b, jnp.asarray(w))),
                     lambda a, b: ploss.weighted_smooth_l1_loss(a, b, _t(w)).sum(), x, y)
    cw = (1.0, 2.0, 0.5, 1.0, 1.0, 1.0, 3.0)
    np.testing.assert_allclose(
        _np(ploss.weighted_smooth_l1_loss(_t(x), _t(y), _t(w), cw)),
        np.asarray(jloss.weighted_smooth_l1_loss(jnp.asarray(x), jnp.asarray(y), jnp.asarray(w),
                                                 cw)), **TOL)
    tgt = rng.uniform(0, 1, x.shape).astype(np.float32)
    _value_and_grads(
        lambda a: jnp.sum(jloss.binary_cross_entropy_with_logits(a * 4, jnp.asarray(tgt))),
        lambda a: ploss.binary_cross_entropy_with_logits(a * 4, _t(tgt)).sum(), x)
    _value_and_grads(lambda a: jnp.sum(jloss.safe_norm(a)), lambda a: ploss.safe_norm(a).sum(),
                     np.concatenate([x, np.zeros_like(x[:1])]))  # zero rows: finite gradient


def test_centernet_losses_match():
    rng = np.random.default_rng(1)
    pred = rng.uniform(0.0, 1.0, (2, 3, 6, 5)).astype(np.float32)
    pred[0, 0, 0, 0], pred[0, 0, 0, 1] = 0.0, 1.0  # the clip's edges
    gt = rng.uniform(0.0, 0.9, pred.shape).astype(np.float32)
    gt[0, 1, 2, 3] = gt[1, 2, 4, 1] = 1.0
    _value_and_grads(lambda p: jloss.focal_loss_centernet(p, jnp.asarray(gt)),
                     lambda p: ploss.focal_loss_centernet(p, _t(gt)), pred)
    # no positive at all: normalised by 1
    _value_and_grads(lambda p: jloss.focal_loss_centernet(p, jnp.asarray(gt * 0.5)),
                     lambda p: ploss.focal_loss_centernet(p, _t(gt * 0.5)), pred)
    maps = rng.normal(size=(2, 8, 6, 5)).astype(np.float32)
    targets = rng.normal(size=(2, 7, 8)).astype(np.float32)
    inds = rng.integers(0, 30, (2, 7)).astype(np.int32)
    mask = rng.random((2, 7)) < 0.6
    weights = np.arange(1, 9, dtype=np.float32)
    _value_and_grads(
        lambda m: jnp.sum(jloss.reg_loss_centernet(m, jnp.asarray(targets), jnp.asarray(inds),
                                                   jnp.asarray(mask)) * weights),
        lambda m: (ploss.reg_loss_centernet(m, _t(targets), _t(inds), _t(mask))
                   * _t(weights)).sum(), maps)


def test_box_losses_match_with_masked_rows():
    rng = np.random.default_rng(2)
    pred = _random_boxes(rng, (12,))
    gt = pred + rng.normal(0, 0.3, pred.shape).astype(np.float32)
    w = (rng.uniform(0.3, 1.0, 12) * (rng.random(12) < 0.6)).astype(np.float32)
    assert 0 < (w > 0).sum() < 12
    np.testing.assert_array_equal(_np(ploss.sanitize_boxes(_t(pred), _t(w))),
                                  np.asarray(jloss.sanitize_boxes(jnp.asarray(pred),
                                                                  jnp.asarray(w))))
    _value_and_grads(lambda p, g: jnp.sum(jloss.corner_loss_lidar(p, g, jnp.asarray(w))),
                     lambda p, g: ploss.corner_loss_lidar(p, g, _t(w)).sum(), pred, gt)
    _value_and_grads(lambda p, g: jnp.sum(jloss.bb_loss(p, g) * w),
                     lambda p, g: (ploss.bb_loss(p, g) * _t(w)).sum(), pred, gt)
    # batched leading dims, boxes far apart (no overlap), wrapped headings
    far = _random_boxes(rng, (2, 5), spread=30.0)
    far[..., 6] += 5.0
    np.testing.assert_allclose(_np(ploss.bb_loss(_t(far), _t(far[::-1].copy()))),
                               np.asarray(jloss.bb_loss(jnp.asarray(far),
                                                        jnp.asarray(far[::-1].copy()))), **TOL)
    fa = rng.normal(size=(2, 6, 16)).astype(np.float32)
    fb = rng.normal(size=(2, 6, 16)).astype(np.float32)
    m = (rng.uniform(0.3, 1, (2, 6)) * (rng.random((2, 6)) < 0.7)).astype(np.float32)
    _value_and_grads(lambda a: jloss.cosine_consistency_loss(a, jnp.asarray(fb), jnp.asarray(m)),
                     lambda a: ploss.cosine_consistency_loss(a, _t(fb), _t(m)), fa)
    _value_and_grads(lambda a: jloss.cosine_consistency_loss(a, jnp.asarray(fb)),
                     lambda a: ploss.cosine_consistency_loss(a, _t(fb)), fa)
    # nothing flows into the second argument
    b_t = _t(fb).requires_grad_()
    ploss.cosine_consistency_loss(_t(fa).requires_grad_(), b_t, _t(m)).backward()
    assert b_t.grad is None


def test_masked_garbage_rows_keep_loss_and_grads_finite():
    """The inf-in-masked-row case of the JAX package's proto-loss tests: a
    masked row's inf or NaN must reach neither the loss nor the gradient."""
    inf, nan = np.float32(np.inf), np.float32(np.nan)
    pred = np.array([[1.0, 2.0, 0.5, 4.0, 2.0, 1.5, 0.3], [0, 0, 0, inf, inf, inf, 0],
                     [nan, 0, 0, 1, 1, 1, 0]], np.float32)
    gt = np.array([[1.2, 2.1, 0.4, 4.1, 2.0, 1.5, 0.25], [0, 0, 0, -inf, 1, 1, 0],
                   [0, nan, 0, 1, 1, 1, 0]], np.float32)
    w = np.array([1.0, 0.0, 0.0], np.float32)
    want = _value_and_grads(lambda p: jnp.sum(jloss.corner_loss_lidar(p, jnp.asarray(gt),
                                                                      jnp.asarray(w))),
                            lambda p: ploss.corner_loss_lidar(p, _t(gt), _t(w)).sum(), pred)
    assert np.isfinite(want)

    def jbb(p):
        ps, gs = jloss.sanitize_boxes(p, jnp.asarray(w)), jloss.sanitize_boxes(jnp.asarray(gt), w)
        return jnp.sum(jnp.where(w > 0, jloss.bb_loss(ps, gs) * w, 0.0))

    def pbb(p):
        ps, gs = ploss.sanitize_boxes(p, _t(w)), ploss.sanitize_boxes(_t(gt), _t(w))
        return torch.where(_t(w) > 0, ploss.bb_loss(ps, gs) * _t(w), 0.0).sum()

    assert np.isfinite(_value_and_grads(jbb, pbb, pred))
    # the canary: masking the output alone is NOT backward-safe in torch either
    p = _t(pred).requires_grad_()
    torch.where(_t(w) > 0, ploss.bb_loss(p, _t(gt)) * _t(w), 0.0).sum().backward()
    assert not bool(torch.isfinite(p.grad).all())


def _gt_batch(rng, b, n, n_valid, spread=6.0):
    gt = np.zeros((b, n, 8), np.float32)
    gt[..., :7] = _random_boxes(rng, (b, n), spread)
    gt[..., 7] = rng.integers(1, 4, (b, n))
    valid = np.zeros((b, n), bool)
    valid[:, :n_valid] = True
    return gt, valid


PCR, VS = (-8.0, -8.0, -2.0, 8.0, 8.0, 4.0), (0.25, 0.25, 0.15)


def test_assign_center_targets_match():
    rng = np.random.default_rng(3)
    gt, valid = _gt_batch(rng, 2, 9, 7, spread=9.0)  # some centres off the map
    gt[0, 0, 0:2] = gt[0, 1, 0:2]  # two objects on one pixel
    gt[0, 2, 3] = 0.0  # a degenerate box
    fm = (8, 8)
    for b in range(2):
        ref = jgauss.assign_center_targets(jnp.asarray(gt[b]), jnp.asarray(valid[b]), 3, fm,
                                           VS, PCR, 8, 0.1, 2)
        out = gaussian.assign_center_targets(_t(gt[b]), _t(valid[b]), 3, fm, VS, PCR, 8, 0.1, 2)
        np.testing.assert_array_equal(_np(out["mask"]), np.asarray(ref["mask"]))
        np.testing.assert_array_equal(_np(out["inds"]), np.asarray(ref["inds"]))
        np.testing.assert_allclose(_np(out["heatmap"]), np.asarray(ref["heatmap"]), atol=1e-6)
        np.testing.assert_allclose(_np(out["target_boxes"]), np.asarray(ref["target_boxes"]),
                                   **TOL)
        assert 0 < int(out["mask"].sum()) < 9 and float(out["heatmap"].max()) == 1.0
    h = np.array([3.0, 10.5, 0.7], np.float32)
    np.testing.assert_allclose(_np(gaussian.gaussian_radius(_t(h), _t(h[::-1].copy()), 0.1)),
                               np.asarray(jgauss.gaussian_radius(jnp.asarray(h),
                                                                 jnp.asarray(h[::-1].copy()),
                                                                 0.1)), **TOL)


def test_center_head_get_loss_matches():
    rng = np.random.default_rng(4)
    gt, valid = _gt_batch(rng, 2, 6, 5)
    preds = {"hm": rng.normal(-2, 1, (2, 8, 8, 3)), "center": rng.normal(size=(2, 8, 8, 2)),
             "center_z": rng.normal(size=(2, 8, 8, 1)), "dim": rng.normal(size=(2, 8, 8, 3)),
             "rot": rng.normal(size=(2, 8, 8, 2))}
    preds = {k: v.astype(np.float32) for k, v in preds.items()}
    jm = jch.CenterHead(num_classes=3, voxel_size=VS, point_cloud_range=PCR)
    pm = center_head.CenterHead(16, 3, voxel_size=VS, point_cloud_range=PCR)
    jtargets = jm.assign_targets(jnp.asarray(gt), jnp.asarray(valid), (8, 8))
    ptargets = pm.assign_targets(_t(gt), _t(valid), (8, 8))
    for k in jtargets:
        np.testing.assert_allclose(_np(ptargets[k]).astype(np.float32),
                                   np.asarray(jtargets[k], np.float32), atol=1e-5, err_msg=k)

    def jfn(p):
        total, tb = jm.get_loss(p, jtargets)
        return total, tb
    (jtotal, jtb), jgrads = jax.value_and_grad(jfn, has_aux=True)(
        {k: jnp.asarray(v) for k, v in preds.items()})
    pp = {k: _t(v).requires_grad_() for k, v in preds.items()}
    ptotal, ptb = pm.get_loss(pp, ptargets)
    ptotal.backward()
    np.testing.assert_allclose(float(ptotal.detach()), float(jtotal), **TOL)
    assert set(ptb) == set(jtb) == {"hm_loss", "loc_loss"}
    for k in jtb:
        np.testing.assert_allclose(float(ptb[k]), float(jtb[k]), **TOL)
    for k in preds:
        np.testing.assert_allclose(pp[k].grad.numpy(), np.asarray(jgrads[k]), **TOL, err_msg=k)


def _sampling_case(rng, r=48, n=10):
    """Proposals around the gts (fg, hard and easy bg all present), some invalid."""
    gt, gt_valid = _gt_batch(rng, 1, n, n - 2)
    gt, gt_valid = gt[0], gt_valid[0]
    src = rng.integers(0, n, r)
    rois = gt[src, :7].copy()
    noise = rng.choice([0.05, 0.6, 3.0], size=r)[:, None]
    rois[:, :3] += rng.normal(0, 1, (r, 3)).astype(np.float32) * noise
    rois[:, 6] += rng.normal(0, 0.2, r).astype(np.float32)
    labels = gt[src, 7].astype(np.int32)
    labels[rng.random(r) < 0.15] = 2
    return dict(rois=rois.astype(np.float32), roi_scores=rng.random(r).astype(np.float32),
                roi_labels=labels, roi_valid=rng.random(r) < 0.85, gt_boxes=gt,
                gt_valid=gt_valid, css_score=rng.uniform(0.3, 1, n).astype(np.float32))


SAMPLING_CFGS = [
    dict(),
    dict(roi_per_image=40),  # more than the valid rois: fillers and padding
    dict(cls_score_type="cls", fg_ratio=0.25, hard_bg_ratio=0.5),
    dict(cls_score_type="roi_ioud_x", reg_fg_thresh=(0.3, 0.4, 0.35),
         cls_fg_thresh=(0.6, 0.5, 0.55), cls_bg_thresh=(0.02, 0.05, 0.03),
         enable_hard_sampling=True, hard_sampling_thresh=(0.05, 0.1, 0.1),
         hard_sampling_ratio=(0.5, 0.5, 0.5)),
]


@pytest.mark.parametrize("cfg", SAMPLING_CFGS, ids=["default", "overfull", "cls", "ioud_x"])
def test_sample_rois_for_rcnn_matches(cfg):
    """Same injected uniforms: the selected set, labels and masks exactly,
    IoUs, soft labels and CSS to 1e-6."""
    rng = np.random.default_rng(5)
    case = _sampling_case(rng)
    cfg = dict(dict(roi_per_image=16), **cfg)
    table = rng.random((1, 6, 48)).astype(np.float32)
    with injected_sampling_uniforms(table):
        ref = jroi.sample_rois_for_rcnn(jnp.asarray(table[0]),
                                        *(jnp.asarray(v) for v in case.values()), **cfg)
    out = roi_head.sample_rois_for_rcnn({k: u[0] for k, u in port_uniforms(table).items()},
                                        *(_t(v) for v in case.values()), **cfg)
    assert set(out) == set(ref)
    for k in ("valid", "reg_valid_mask", "roi_labels"):
        np.testing.assert_array_equal(_np(out[k]), np.asarray(ref[k]), err_msg=k)
    for k in ("rois", "gt_of_rois", "roi_ious", "roi_scores", "cls_labels", "css"):
        np.testing.assert_allclose(_np(out[k]), np.asarray(ref[k]), atol=1e-6, err_msg=k)
    n_valid = int(out["valid"].sum())
    assert n_valid == min(cfg["roi_per_image"], int(case["roi_valid"].sum()))
    if cfg.get("cls_score_type") != "cls":
        assert 0 < int(out["reg_valid_mask"].sum()) < n_valid


def test_draw_sampling_uniforms_and_rank():
    g = torch.Generator().manual_seed(0)
    u = roi_head.draw_sampling_uniforms(2, 9, g)
    assert set(u) == set(roi_head.SAMPLING_UNIFORMS)
    assert all(tuple(v.shape) == (2, 9) and 0 <= float(v.min()) and float(v.max()) < 1
               for v in u.values())
    mask = torch.tensor([True, False, True, True, False])
    r = torch.tensor([0.9, 0.1, 0.2, 0.5, 0.0])
    assert roi_head._rank_by_random(mask, r).tolist() == [2, 5, 0, 1, 5]


def test_encode_roi_targets_match():
    rng = np.random.default_rng(6)
    rois = _random_boxes(rng, (2, 11))
    gt = np.concatenate([rois + rng.normal(0, 0.4, rois.shape), np.ones((2, 11, 1))],
                        -1).astype(np.float32)
    gt[..., 6] += rng.choice([0.0, np.pi, -np.pi, 2.5], size=(2, 11)).astype(np.float32)
    jt, jlocal = jax.vmap(lambda r, g: jroi.encode_roi_targets(r, g, JCoder()))(
        jnp.asarray(rois), jnp.asarray(gt))
    pt, plocal = roi_head.encode_roi_targets(_t(rois), _t(gt), ResidualCoder())
    np.testing.assert_allclose(_np(pt), np.asarray(jt), **TOL)
    np.testing.assert_allclose(_np(plocal), np.asarray(jlocal), **TOL)
    assert float(np.abs(_np(plocal)[..., 6]).max()) <= np.pi / 2 + 1e-5


def _head_outputs(rng, b=2, r=9, feat=16):
    rois = _random_boxes(rng, (b, r))
    gt = np.concatenate([rois + rng.normal(0, 0.2, rois.shape), np.ones((b, r, 1))],
                        -1).astype(np.float32)
    labels = rng.uniform(0, 1, (b, r)).astype(np.float32)
    labels[0, :2] = -1.0  # the ignore band of the 'cls' label type
    outs = {"rcnn_cls": rng.normal(0, 1, (b, r)), "rcnn_reg": rng.normal(0, 0.1, (b, r, 7)),
            "rcnn_cls_proto": rng.normal(0, 1, (b, r)),
            "rcnn_reg_proto": rng.normal(0, 0.1, (b, r, 7)),
            "shared_features0": rng.normal(0, 1, (b, r, feat)),
            "shared_features1": rng.normal(0, 1, (b, r, feat))}
    outs = {k: v.astype(np.float32) for k, v in outs.items()}
    outs["rcnn_reg"][1, 3, 3:6] = 200.0  # a masked row whose decoded size overflows
    reg_valid = rng.random((b, r)) < 0.6
    reg_valid[1, 3] = False
    targets = {"rois": rois, "gt_of_rois": gt,
               "css": rng.uniform(0.3, 1.0, (b, r)).astype(np.float32),
               "valid": rng.random((b, r)) < 0.85, "reg_valid_mask": reg_valid,
               "cls_labels": labels}
    return outs, rois, targets


@pytest.mark.parametrize("cur_it,forensics", [(0.0, False), (1200.0, False), (None, False),
                                               (1200.0, True)],
                         ids=["0.0", "1200.0", "None", "forensics"])
def test_proto_head_get_loss_matches(cur_it, forensics):
    """Every entry of tb and the gradients w.r.t. the head outputs, with and
    without the proto block's ramp. With ``debug_forensics`` and one NaN in
    the regression prediction of a foreground row, the ``nonfinite_*``
    counts equal JAX's and the losses are NaN where JAX's are."""
    outs, rois, targets = _head_outputs(np.random.default_rng(7))
    if forensics:
        live = np.argwhere(targets["reg_valid_mask"] & targets["valid"])[0]
        outs["rcnn_reg"][live[0], live[1], 2] = np.nan
    jm = jroi.VoxelRCNNProtoHead(num_rois=9, roi_per_image=9, debug_forensics=forensics)
    pm = roi_head.VoxelRCNNProtoHead({}, {"x_conv3": 8, "x_conv4": 8}, num_rois=9,
                                     roi_per_image=9, mm=True, debug_forensics=forensics)
    jbatch = {} if cur_it is None else {"cur_it": jnp.asarray(cur_it, jnp.float32)}
    pbatch = {} if cur_it is None else {"cur_it": cur_it}
    jtargets = {k: jnp.asarray(v) for k, v in targets.items()}

    def jfn(o):
        full = dict(o, rois=jnp.asarray(rois), roi_targets=jtargets)
        return jm.apply({}, full, jbatch, method=jroi.VoxelRCNNProtoHead.get_loss)
    (jtotal, jtb), jgrads = jax.value_and_grad(jfn, has_aux=True)(
        {k: jnp.asarray(v) for k, v in outs.items()})
    po = {k: _t(v).requires_grad_() for k, v in outs.items()}
    ptotal, ptb = pm.get_loss(dict(po, rois=_t(rois),
                                   roi_targets={k: _t(v) for k, v in targets.items()}), pbatch)
    assert set(ptb) == set(jtb) and "proto_loss" in ptb
    if forensics:
        counts = sorted(k for k in jtb if k.startswith("nonfinite_"))
        assert len(counts) == 10 and int(jtb["nonfinite_reg_pred"]) == 1
        for k in counts:
            assert int(ptb[k]) == int(jtb[k]), k
        for k in jtb:
            np.testing.assert_allclose(float(ptb[k]), float(jtb[k]), **TOL, err_msg=k)
        assert np.isnan(float(ptb["rcnn_reg0"])) and np.isnan(float(ptotal.detach()))
        return
    ptotal.backward()
    np.testing.assert_allclose(float(ptotal.detach()), float(jtotal), **TOL)
    for k in jtb:
        np.testing.assert_allclose(float(ptb[k]), float(jtb[k]), **TOL, err_msg=k)
        assert np.isfinite(float(ptb[k]))
    for k in outs:
        if k == "shared_features1":
            assert po[k].grad is None and float(np.abs(np.asarray(jgrads[k])).max()) == 0.0
            continue
        np.testing.assert_allclose(po[k].grad.numpy(), np.asarray(jgrads[k]), **TOL, err_msg=k)
        assert float(po[k].grad.abs().max()) > 0
    # without the proto outputs the block is left out
    single = {k: v for k, v in po.items() if "proto" not in k and k != "shared_features1"}
    _, tb0 = pm.get_loss(dict(single, rois=_t(rois),
                              roi_targets={k: _t(v) for k, v in targets.items()}), pbatch)
    assert set(tb0) == {"rcnn_cls0", "rcnn_reg0"}


def test_fc_tower_dropout_rate_and_scaling():
    """Dropout after every non-final hidden layer, in training mode only:
    kept units are scaled by 1 / (1 - p), about p of them are dropped, and
    the masks come from the generator handed in."""
    tower = roi_head.FCTower(32, hidden=(64, 64), out_dim=None, dropout=0.3, compute_dtype=None)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in tower.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.2 + (1.0 if p.dim() == 1 else 0.0))
    x = torch.randn(4, 500, 32, generator=gen)
    valid = torch.ones(4, 500, dtype=torch.bool)
    seen = []
    tower.fc1.register_forward_pre_hook(lambda m, args: seen.append(args[0].detach().clone()))
    tower.train()
    out_a = tower(x, valid, torch.Generator().manual_seed(2))
    out_b = tower(x, valid, torch.Generator().manual_seed(2))
    out_c = tower(x, valid, torch.Generator().manual_seed(3))
    assert torch.equal(out_a, out_b) and not torch.equal(out_a, out_c)
    before = torch.relu(tower.bn0(tower.fc0(x), valid)).detach()  # same batch statistics
    live = before > 0
    dropped = (seen[0] == 0) & live
    assert 0.27 < float(dropped.float().sum() / live.float().sum()) < 0.33
    kept = live & ~dropped
    torch.testing.assert_close(seen[0][kept], before[kept] / 0.7, rtol=1e-5, atol=1e-6)
    # nothing is dropped after the last hidden layer, nor in eval mode
    torch.testing.assert_close(out_a, torch.relu(tower.bn1(tower.fc1(seen[0]), valid)))
    tower.eval()
    seen.clear()
    tower(x, valid)
    torch.testing.assert_close(seen[0], torch.relu(tower.bn0(tower.fc0(x), valid)))
