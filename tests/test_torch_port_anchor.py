"""The anchor heads of the port (cpd_tpu_torch/models/anchor_head.py) and the
ops they use, against the JAX package on the CPU, at f32.

* ``sigmoid_focal_loss`` and ``boxes_aligned_iou_bev`` within 1e-6;
* ``generate_anchors`` within 1e-6; ``assign_anchor_targets`` labels and
  gt_idx exactly equal, with exact IoU ties (labels placed on the anchor
  grid), rows with ``gt_valid`` false and headings on the pi/4 boundaries;
* ``point_density_anchor_mask`` bit-equal, on the DBSCAN yaml's 188 x 188
  map and on cut maps;
* ``AnchorHeadSingle`` and ``AnchorHeadSingleV2`` with the same seeded
  weights through ``state_dict_from_jax``: forward within 1e-4 in eval and
  training mode (V2's running statistics within 1e-5), ``get_loss`` terms
  within 1e-4 relative (the V2 mask's ignore labels included), and
  ``generate_predicted_boxes`` within 1e-4 of the scale.

``jax_anchors_eager`` makes the JAX side compute its anchors op by op
inside ``jit``: under ``jit`` XLA:CPU fuses ``generate_anchors``' arithmetic
and moves anchor coordinates by one ulp, which breaks the exact IoU ties of
the force-match (the same labels then come out of eager JAX and the port).
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpd_tpu.models import anchor_head as jah
from cpd_tpu.ops import iou3d as jiou
from cpd_tpu.utils import loss as jloss
from cpd_tpu_torch.models import anchor_head as pah
from cpd_tpu_torch.ops import iou3d
from cpd_tpu_torch.utils import loss as ploss
from cpd_tpu_torch.utils.weights import state_dict_from_jax
from tests.test_torch_port_models import seeded_jax_variables

PCR = (-12.0, -12.0, -2.0, 12.0, 12.0, 4.0)
SIZES = ((4.7, 2.1, 1.7), (0.91, 0.86, 1.73), (1.78, 0.84, 1.78))
HEAD_CFG = dict(num_classes=3, point_cloud_range=PCR, anchor_sizes=SIZES,
                anchor_rotations=(0, 1.57), matched_thresholds=(0.55, 0.55, 0.55),
                unmatched_thresholds=(0.5, 0.4, 0.4))


def _t(x):
    return torch.from_numpy(np.array(x))


@contextlib.contextmanager
def jax_anchors_eager():
    """The JAX package's ``generate_anchors`` evaluated op by op even inside
    ``jit`` (its inputs are static), as its eager mode and the port compute
    them."""
    orig = jah.generate_anchors

    def eager(*args, **kwargs):
        with jax.ensure_compile_time_eval():
            return orig(*args, **kwargs)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jah, "generate_anchors", eager)
        yield


def test_jitted_jax_anchors_move_by_an_ulp():
    """The fact ``jax_anchors_eager`` works around: eager JAX and the port
    give the same anchors; under ``jit`` some differ by one f32 ulp."""
    args = ((30, 30), PCR, SIZES, (0, 1.57))
    eager = np.asarray(jah.generate_anchors(*args))
    jitted = np.asarray(jax.jit(lambda: jah.generate_anchors(*args))())
    np.testing.assert_array_equal(pah.generate_anchors(*args).numpy(), eager)
    assert 0 < np.abs(jitted - eager).max() <= 1e-6


def test_sigmoid_focal_loss_matches():
    rng = np.random.default_rng(0)
    logits = rng.normal(0, 3, (2, 50, 3)).astype(np.float32)
    targets = (rng.random((2, 50, 3)) < 0.2).astype(np.float32)
    weights = rng.random((2, 50)).astype(np.float32)
    ref = jloss.sigmoid_focal_loss(jnp.asarray(logits), jnp.asarray(targets), jnp.asarray(weights))
    out = ploss.sigmoid_focal_loss(_t(logits), _t(targets), _t(weights))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)


def _boxes(rng, n, spread=8.0):
    b = np.zeros((n, 7), np.float32)
    b[:, :2] = rng.uniform(-spread, spread, (n, 2))
    b[:, 2] = rng.uniform(-1, 1, n)
    b[:, 3:6] = rng.uniform(0.5, 5.0, (n, 3))
    b[:, 6] = rng.uniform(-2 * np.pi, 2 * np.pi, n)
    return b


def test_boxes_aligned_iou_bev_matches():
    rng = np.random.default_rng(1)
    a, b = _boxes(rng, 40), _boxes(rng, 30)
    # headings on and beside the pi/4 boundaries of the dx/dy swap
    a[:8, 6] = np.float32([0, np.pi / 4, np.pi / 2, 3 * np.pi / 4, np.pi, -np.pi / 4, 1.57, 1.5708])
    b[:5] = a[:5]  # identical boxes: IoU 1
    ref = jiou.boxes_aligned_iou_bev(jnp.asarray(a), jnp.asarray(b))
    out = iou3d.boxes_aligned_iou_bev(_t(a), _t(b))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
    assert float(np.asarray(ref).max()) > 0.99


@pytest.mark.parametrize("grid,pcr", [((30, 30), PCR), ((188, 188), (-75.2, -75.2, -2, 75.2, 75.2, 4)),
                                      ((236, 236), (-75.52, -75.52, -2, 75.52, 75.52, 4)),
                                      ((20, 12), (0.0, -8.0, -3.0, 40.0, 8.0, 1.0))])
def test_generate_anchors_match(grid, pcr):
    ref = np.asarray(jah.generate_anchors(grid, pcr, SIZES, (0, 1.57)))
    out = pah.generate_anchors(grid, pcr, SIZES, (0, 1.57)).numpy()
    assert out.shape == ref.shape == (grid[1], grid[0], 6, 7)
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)
    # z = -1 + dz / 2: the yamls' anchor_bottom_heights are not read
    np.testing.assert_allclose(out[0, 0, ::2, 2], -1.0 + np.float32(SIZES)[:, 2] / 2, rtol=1e-6)


def _assign_inputs(case, seed):
    """Anchors, classes, thresholds of the 30 x 30 map and labels (G, 8)."""
    rng = np.random.default_rng(seed)
    anchors = pah.generate_anchors((30, 30), PCR, SIZES, (0, 1.57)).reshape(-1, 7).numpy()
    acls = np.tile(np.repeat(np.arange(1, 4, dtype=np.int32), 2), 900)
    m_thr = np.tile(np.repeat(np.float32([0.55, 0.55, 0.55]), 2), 900)
    u_thr = np.tile(np.repeat(np.float32([0.5, 0.4, 0.4]), 2), 900)
    g = 12
    gt = np.zeros((g, 8), np.float32)
    gt[:, 7] = rng.integers(1, 4, g)
    gt[:, :7] = _boxes(rng, g, spread=11.0)
    gt[:, 3:6] = np.float32(SIZES)[gt[:, 7].astype(int) - 1] * rng.uniform(0.8, 1.2, (g, 3))
    valid = np.ones(g, bool)
    if case == "ties":
        # on cell corners and cell centres, anchor-sized, axis-aligned:
        # several anchors tie exactly at a label's best IoU
        cells = rng.integers(2, 28, (g, 2))
        gt[:, :2] = -12.0 + cells * 0.8 + np.where(np.arange(g) % 2, 0.4, 0.0)[:, None]
        gt[:, 3:6] = np.float32(SIZES)[gt[:, 7].astype(int) - 1]
        gt[:, 6] = np.where(np.arange(g) % 3 == 0, np.float32(np.pi / 2), 0.0)
        gt[1] = gt[0]  # two labels on one box: the first takes the anchors
    elif case == "invalid_rows":
        valid[::3] = False  # boxes that would match, but are not valid
    return anchors, acls, gt, valid, m_thr, u_thr


@pytest.mark.parametrize("case,seed", [("random", 0), ("random", 1), ("ties", 2), ("ties", 3),
                                       ("invalid_rows", 4)])
def test_assign_anchor_targets_exact(case, seed):
    """Against the JAX function op by op. Under ``jit`` XLA:CPU fuses the
    IoU's arithmetic and may move an IoU by an ulp, which decides exact ties
    differently (2 of 5400 labels in the ``ties-3`` case); away from exact
    ties the jitted labels are the same."""
    anchors, acls, gt, valid, m_thr, u_thr = _assign_inputs(case, seed)
    args = (anchors, acls, gt, valid, m_thr, u_thr)
    with jax.disable_jit():
        ref = jah.assign_anchor_targets(*(jnp.asarray(x) for x in args))
    out = pah.assign_anchor_targets(*(_t(x) for x in args))
    np.testing.assert_array_equal(out["labels"].numpy(), np.asarray(ref["labels"]))
    np.testing.assert_array_equal(out["gt_idx"].numpy(), np.asarray(ref["gt_idx"]))
    if case != "ties":
        jitted = jah.assign_anchor_targets(*(jnp.asarray(x) for x in args))
        np.testing.assert_array_equal(out["labels"].numpy(), np.asarray(jitted["labels"]))
        np.testing.assert_array_equal(out["gt_idx"].numpy(), np.asarray(jitted["gt_idx"]))
    labels = out["labels"].numpy()
    assert (labels > 0).sum() >= valid.sum() and (labels == 0).any()
    if case != "ties":
        assert (labels == -1).any()
    else:
        # force-matched ties: a label claims more anchors than it has best ones
        assert (labels > 0).sum() > valid.sum()
    if case == "invalid_rows":
        assert not np.isin(out["gt_idx"].numpy()[labels > 0], np.nonzero(~valid)[0]).any()


def _mask_points(rng, n, pcr):
    pts = np.zeros((2, n, 5), np.float32)
    lo, hi = np.float32(pcr[:2]), np.float32(pcr[3:5])
    # clustered, plus points just outside the range on every side
    centres = rng.uniform(lo, hi, (6, 2))
    pts[..., :2] = centres[rng.integers(0, 6, (2, n))] + rng.normal(0, 3.0, (2, n, 2))
    pts[0, :4, :2] = [[lo[0] - 0.5, 0], [hi[0] + 0.5, 0], [0, lo[1] - 0.2], [0, hi[1] + 3]]
    valid = rng.random((2, n)) < 0.9
    return pts, valid


@pytest.mark.parametrize("shape,pcr,nx", [((188, 188), (-75.2, -75.2, -2, 75.2, 75.2, 4), 1504),
                                          ((30, 30), PCR, 240), ((47, 63), (0, -40, -2, 50.4, 40, 4), 504)])
def test_point_density_anchor_mask_bit_equal(shape, pcr, nx):
    pts, valid = _mask_points(np.random.default_rng(5), 3000, pcr)
    ref = np.asarray(jah.point_density_anchor_mask(jnp.asarray(pts), jnp.asarray(valid), shape,
                                                   pcr, nx))
    out = pah.point_density_anchor_mask(_t(pts), _t(valid), shape, pcr, nx).numpy()
    np.testing.assert_array_equal(out, ref)
    assert out.any()
    if shape[0] > 100:  # the 8 m coarse grid: marked and unmarked blocks
        assert not out.all()


def _head_pair(v2, seed=0):
    """JAX head, its seeded variables (numpy), the port head loaded from them."""
    jm = (jah.AnchorHeadSingleV2 if v2 else jah.AnchorHeadSingle)(**HEAD_CFG)
    pm = (pah.AnchorHeadSingleV2 if v2 else pah.AnchorHeadSingle)(48, **HEAD_CFG)
    x = jnp.zeros((2, 30, 30, 48), jnp.float32)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), x, False))
    variables = seeded_jax_variables(shapes, seed)
    pm.load_state_dict(state_dict_from_jax(variables, pm), strict=True)
    return jm, variables, pm


def _head_inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (2, 30, 30, 48)).astype(np.float32)
    pts, valid = _mask_points(rng, 2000, PCR)
    anchors, _, gt0, valid0, _, _ = _assign_inputs("ties", seed)
    _, _, gt1, valid1, _, _ = _assign_inputs("invalid_rows", seed + 1)
    return x, pts, valid, np.stack([gt0, gt1]), np.stack([valid0, valid1])


def _scaled(port, ref, tol, what):
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref, np.float32)
    scale = max(float(np.abs(ref).max()), 1e-3)
    err = float(np.abs(port - ref).max())
    assert err <= tol * scale, f"{what}: max err {err} at scale {scale}"


@pytest.mark.parametrize("v2", [False, True], ids=["AnchorHeadSingle", "AnchorHeadSingleV2"])
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_anchor_head_matches(v2, train):
    """Forward, get_loss and decode of one head in one mode."""
    jm, variables, pm = _head_pair(v2)
    x, pts, valid, gt, gv = _head_inputs()
    mask = jah.point_density_anchor_mask(jnp.asarray(pts), jnp.asarray(valid), (30, 30), PCR, 240)
    jargs = (jnp.asarray(x), train) + ((mask,) if v2 else ())
    jv = jax.tree_util.tree_map(jnp.asarray, variables)
    with jax_anchors_eager():
        def run(v):
            preds, stats = jm.apply(v, *jargs, mutable=["batch_stats"])
            loss = jm.apply(v, preds, jnp.asarray(gt), jnp.asarray(gv), method=jm.get_loss)
            boxes = jm.apply(v, preds, method=jm.generate_predicted_boxes)
            return preds, stats, loss, boxes
        jpreds, jstats, (jtotal, jtb), (jboxes, jscores) = jax.jit(run)(jv)
    pm.train(train)
    pmask = pah.point_density_anchor_mask(_t(pts), _t(valid), (30, 30), PCR, 240) if v2 else None
    ppreds = pm(_t(x), pmask)
    for k in ("cls_preds", "box_preds", "dir_preds"):
        _scaled(ppreds[k], jpreds[k], 1e-4, k)
    ptotal, ptb = pm.get_loss(ppreds, _t(gt), _t(gv))
    for k, ref in dict(jtb, total=jtotal).items():
        port = float((ptotal if k == "total" else ptb[k]).detach())
        assert abs(port - float(ref)) <= 1e-4 * abs(float(ref)), (k, port, float(ref))
    assert float(jtb["rpn_reg"]) > 0 and float(jtb["rpn_dir"]) > 0
    with torch.no_grad():
        pboxes, pscores = pm.generate_predicted_boxes(ppreds)
    _scaled(pboxes, jboxes, 1e-4, "boxes")
    _scaled(pscores, jscores, 1e-4, "scores")
    if v2:
        assert float((pscores == 0).float().mean()) > 0  # zero outside the mask
    if v2 and train:
        sd = pm.state_dict()
        for name in ("shared_bn", "conv_cls/BatchNorm2d_0", "conv_dim/BatchNorm2d_0"):
            node = jstats["batch_stats"]
            for part in name.split("/"):
                node = node[part]
            key = name.replace("/BatchNorm2d_0", ".bn")
            np.testing.assert_allclose(sd[f"{key}.running_mean"].numpy(), np.asarray(node["mean"]),
                                       rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(sd[f"{key}.running_var"].numpy(), np.asarray(node["var"]),
                                       rtol=1e-5, atol=1e-5)


def test_get_loss_ignores_anchors_outside_the_mask():
    """With an all-False mask every anchor is ignored: the focal loss is 0,
    and so are the regression and direction terms (no positive anchor)."""
    _, _, pm = _head_pair(True)
    x, _, _, gt, gv = _head_inputs()
    pm.eval()
    with torch.no_grad():
        preds = pm(_t(x), torch.zeros((30, 30), dtype=torch.bool))
        _, tb = pm.get_loss(preds, _t(gt), _t(gv))
    assert float(tb["rpn_cls"]) == 0.0 and float(tb["rpn_reg"]) == 0.0
    assert float(tb["rpn_dir"]) == 0.0
