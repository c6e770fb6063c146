"""Kernels B4a-c's plain versions held to the JAX package on seeded inputs.

* ``ops.iou3d.pairwise_overlap_bev_reference`` (kernel B4a's plain version,
  the clip formulation with the port's footprint cap) against JAX's
  ``boxes_overlap_bev(method="clip")`` and against the port's candidate-hull
  twin, within 1e-5 of each pair's smaller footprint: identical, nested and
  edge-sharing boxes, headings 0, +-pi/2 and pi, boxes far apart; with a box
  narrower than the f32 spacing at 70 m every value is rounding residue, and
  the cap bounds both sides by the footprint.
* ``ops.nms.nms_bev`` and ``nms_bev_batched`` (B4b's and B4c's plain
  versions) against JAX's ``nms_bev`` with its IoU on the clip method (under
  ``jit`` XLA:CPU scores identical boxes wrongly with the candidate hull):
  greedy and fast, BEV and 3D IoU (``use_bev_iou``), K in {1, 63, 64, 65,
  200, 500}, all rows invalid, score ties, a batch of 3 with different valid
  counts; indices and masks exactly, the batched call equal to the looped
  one. ``multi_classes_nms`` and ``weighted_box_fusion`` at a larger size.

The JAX side is the committed ``tests/torch_port_refs/nms_kernel.npz``; the
``slow`` test recomputes it from live JAX. Every input keeps its IoUs more
than 1e-5 from the threshold, so that an ulp of difference decides nothing.
"""
import contextlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpd_tpu.ops import iou3d as jiou
from cpd_tpu.ops import nms as jnms
from cpd_tpu_torch.ops import iou3d, nms
from tests import torch_port_refs as refs
from tests.torch_port_refs import one_torch_thread  # noqa: F401

REF = "nms_kernel"
NMS_KS = (1, 63, 64, 65, 200, 500)
THRESH = 0.2
PRE, POST = 512, 128
MARGIN = 1e-5
BATCH_VALID = (150, 97, 13)
MULTI_CFG = {"NMS_THRESH": 0.3, "NMS_PRE_MAXSIZE": 256, "NMS_POST_MAXSIZE": 64}


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _random_boxes(rng, n, spread):
    b = np.zeros((n, 7), np.float32)
    b[:, :2] = rng.uniform(-spread, spread, (n, 2))
    b[:, 2] = rng.uniform(-1.0, 1.0, n)
    b[:, 3:6] = rng.uniform(0.5, 4.0, (n, 3))
    b[:, 6] = rng.uniform(-np.pi, np.pi, n)
    return b


def overlap_boxes():
    """Special boxes, then random ones around them; every pair is a case."""
    special = np.array([
        (10.0, 5.0, 0.2, 4.0, 2.0, 1.5, 0.3),    # 0
        (10.0, 5.0, 0.2, 4.0, 2.0, 1.5, 0.3),    # 1: identical to 0
        (10.0, 5.0, 0.0, 2.0, 1.0, 1.0, 0.3),    # 2: nested in 0
        (0.0, 0.0, 0.0, 4.0, 2.0, 1.5, 0.0),     # 3: heading 0
        (4.0, 0.0, 0.0, 4.0, 2.0, 1.5, 0.0),     # 4: shares the edge x = 2 with 3
        (0.0, 2.0, 0.0, 4.0, 2.0, 1.5, 0.0),     # 5: shares the edge y = 1 with 3
        (0.0, 0.0, 0.0, 4.0, 2.0, 1.5, np.pi / 2),
        (0.0, 0.0, 0.0, 4.0, 2.0, 1.5, -np.pi / 2),
        (0.0, 0.0, 0.0, 4.0, 2.0, 1.5, np.pi),
        (0.5, 0.3, 0.0, 3.0, 3.0, 1.0, np.pi / 2),
        (70.0, 3.0, 0.0, 1e-6, 4.0, 1.5, 0.0),   # 10: narrower than the f32 spacing at 70 m
        (70.0, 3.0, 0.0, 4.0, 2.0, 1.5, 0.3),    # 11: around it
        (70.0, 3.0, 0.0, 1e-6, 3.0, 1.5, 0.2),   # 12: another sliver, rotated
        (-40.0, -40.0, 0.0, 2.0, 2.0, 1.0, 0.7),  # 13: far from all
    ], np.float32)
    return np.concatenate([special, _random_boxes(np.random.default_rng(1), 34, 4.0)])


def nms_scene(seed, k, spread=None, ties=False):
    """``k`` boxes, a third of them jittered copies of others and a few exact
    duplicates, their scores (from 5 values where ``ties``) and a valid mask."""
    rng = np.random.default_rng(seed)
    boxes = _random_boxes(rng, k, spread or max(2.0, 1.2 * math.sqrt(k)))
    n_copy = k // 3
    if n_copy:
        src = rng.integers(0, k, n_copy)
        boxes[-n_copy:] = boxes[src] + np.concatenate(
            [rng.normal(0, 0.3, (n_copy, 6)), rng.normal(0, 0.2, (n_copy, 1))], 1)
        boxes[-n_copy:, 3:6] = np.abs(boxes[-n_copy:, 3:6]) + 0.3
        boxes[-(n_copy // 4 + 1):] = boxes[src[:n_copy // 4 + 1]]
    scores = (rng.integers(1, 6, k) / 5.0 if ties else rng.uniform(0, 1, k)).astype(np.float32)
    valid = rng.random(k) < 0.9
    return boxes.astype(np.float32), scores, valid


def nms_cases():
    """name -> (boxes, scores, valid, fast, use_bev_iou)."""
    cases = {}
    for k in NMS_KS:
        boxes, scores, valid = nms_scene(k, k)
        for fast in (False, True):
            for bev in (True, False):
                cases[f"k{k}_{'fast' if fast else 'greedy'}_{'bev' if bev else '3d'}"] = (
                    boxes, scores, valid, fast, bev)
    boxes, scores, _ = nms_scene(7, 40)
    for fast in (False, True):
        cases[f"invalid_{'fast' if fast else 'greedy'}"] = (boxes, scores, np.zeros(40, bool),
                                                           fast, True)
    boxes, scores, valid = nms_scene(8, 120, ties=True)
    for fast in (False, True):
        cases[f"ties_{'fast' if fast else 'greedy'}"] = (boxes, scores, valid, fast, True)
    return cases


def batch_scene():
    """3 samples of 150 boxes whose first 150, 97 and 13 rows are valid."""
    scenes = [nms_scene(20 + i, 150) for i in range(3)]
    boxes = np.stack([s[0] for s in scenes])
    scores = np.stack([s[1] for s in scenes])
    valid = np.arange(150)[None, :] < np.asarray(BATCH_VALID)[:, None]
    return boxes, scores, valid


def multi_scene():
    boxes, _, valid = nms_scene(30, 300)
    cls = np.random.default_rng(31).random((300, 3)).astype(np.float32)
    return boxes, cls, valid


def _clip_iou_bev(a, b):
    ov = jiou.boxes_overlap_bev(a, b, method="clip")
    return ov / jnp.clip((a[:, 3] * a[:, 4])[:, None] + (b[:, 3] * b[:, 4])[None, :] - ov,
                         min=1e-6)


def _clip_iou3d(a, b):
    ov = jiou.boxes_overlap_bev(a, b, method="clip")
    a_zmin, a_zmax = (a[:, 2] - a[:, 5] / 2.0)[:, None], (a[:, 2] + a[:, 5] / 2.0)[:, None]
    b_zmin, b_zmax = (b[:, 2] - b[:, 5] / 2.0)[None, :], (b[:, 2] + b[:, 5] / 2.0)[None, :]
    h = jnp.clip(jnp.minimum(a_zmax, b_zmax) - jnp.maximum(a_zmin, b_zmin), min=0.0)
    ov3 = ov * h
    vol_a = (a[:, 3] * a[:, 4] * a[:, 5])[:, None]
    vol_b = (b[:, 3] * b[:, 4] * b[:, 5])[None, :]
    return ov3 / jnp.clip(vol_a + vol_b - ov3, min=1e-6)


@contextlib.contextmanager
def jax_nms_on_clip_iou():
    """JAX's NMS and box fusion with both IoU kinds on the clip method."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnms, "boxes_iou_bev", _clip_iou_bev)
        mp.setattr(jnms, "boxes_iou3d", _clip_iou3d)
        jax.clear_caches()
        try:
            yield
        finally:
            jax.clear_caches()


def jax_reference():
    """The JAX side of every test of this file, from live JAX."""
    tree = {"overlap": np.asarray(jax.jit(lambda a: jiou.boxes_overlap_bev(a, a, method="clip"))(
        overlap_boxes()))}
    with jax_nms_on_clip_iou():
        tree["nms"] = {}
        for name, (boxes, scores, valid, fast, bev) in nms_cases().items():
            idx, mask = jnms.nms_bev(boxes, scores, THRESH, pre_max_size=PRE, post_max_size=POST,
                                     valid=valid, use_bev_iou=bev, fast=fast)
            tree["nms"][name] = {"idx": np.asarray(idx), "mask": np.asarray(mask)}
        boxes, scores, valid = batch_scene()
        tree["batch"] = [{"idx": np.asarray(i), "mask": np.asarray(m)} for i, m in (
            jnms.nms_bev(b, s, THRESH, pre_max_size=PRE, post_max_size=POST, valid=v)
            for b, s, v in zip(boxes, scores, valid))]
        boxes, cls, valid = multi_scene()
        tree["multi"] = [np.asarray(x) for x in jnms.multi_classes_nms(
            jnp.asarray(cls), jnp.asarray(boxes), MULTI_CFG, 0.2, jnp.asarray(valid))]
        labels = np.random.default_rng(32).integers(0, 3, 300).astype(np.int32)
        tree["wbf"] = [np.asarray(x) for x in jnms.weighted_box_fusion(
            jnp.asarray(boxes), jnp.asarray(cls[:, 0]), jnp.asarray(labels), 0.3,
            jnp.asarray(valid))]
    return tree


@pytest.fixture(scope="module")
def ref():
    return refs.load(REF)


def _footprints(boxes):
    area = boxes[:, 3] * boxes[:, 4]
    return np.minimum(area[:, None], area[None, :])


SLIVERS = [10, 12]


def test_clip_overlap_holds_jax_and_the_candidate_hull(ref):
    """Within 1e-5 of the smaller footprint, except a pair with a sliver:
    there both formulations give rounding residue (JAX's clip 7.6e-6 for a
    footprint of 3e-6 m^2, the port's 0), and the cap bounds each by the
    footprint."""
    boxes = overlap_boxes()
    bt = _t(boxes)
    out = iou3d.pairwise_overlap_bev_reference(bt[None], bt[None])[0].numpy()
    foot = _footprints(boxes)
    cand = iou3d.boxes_overlap_bev(bt, bt, method="candidates").numpy()
    # the JAX package does not cap; the port caps at the smaller footprint
    want = np.minimum(ref["overlap"], foot)
    solid = np.ones_like(foot, bool)
    solid[SLIVERS, :] = solid[:, SLIVERS] = False
    for what, other in (("JAX's clip method", want), ("the candidate hull", cand)):
        err = np.where(solid, np.abs(out - other) / foot, 0.0)
        assert err.max() <= 1e-5, (f"against {what}, worst pair "
                                   f"{np.unravel_index(err.argmax(), err.shape)}: {err.max()}")
        assert ((0 <= other) & (other <= foot))[~solid].all() and (out <= foot)[~solid].all()
    np.testing.assert_array_equal(iou3d.boxes_overlap_bev(bt, bt, method="clip").numpy(), out)
    # the cases are what they say
    area = boxes[:, 3] * boxes[:, 4]
    assert out[0, 1] == pytest.approx(area[0], rel=1e-6)            # identical
    assert out[0, 2] == pytest.approx(area[2], rel=1e-6)            # nested
    assert out[3, 4] <= 1e-5 and out[3, 5] <= 1e-5                  # shared edges
    for j in (6, 7):                                                  # +-pi/2: a 2 x 2 square
        assert out[3, j] == pytest.approx(4.0, rel=1e-5)
    assert out[3, 8] == pytest.approx(area[3], rel=1e-5)             # pi
    assert (out[13, :13] == 0).all() and (out[:13, 13] == 0).all()   # far apart
    # the slivers' corners coincide in f32 at 70 m, and the cap decides JAX's
    assert np.float32(70.0) + np.float32(5e-7) == np.float32(70.0)
    assert ref["overlap"][11, 12] > foot[11, 12]


def test_nms_bev_holds_jax(ref):
    kept, overlaps = 0, {}
    for name, (boxes, scores, valid, fast, bev) in nms_cases().items():
        bt = _t(boxes)
        if id(boxes) not in overlaps:  # the cases of one scene share its boxes
            overlaps[id(boxes)] = iou3d.pairwise_overlap_bev_reference(bt[None], bt[None])
        iou_fn = iou3d.iou_bev_from_overlap if bev else iou3d.iou3d_from_overlap
        iou = iou_fn(overlaps[id(boxes)], bt[None], bt[None])[0].numpy()
        gap = np.abs(iou - THRESH)
        assert gap.min() > MARGIN, f"{name}: an IoU lies {gap.min()} from the threshold"
        idx, mask = nms.nms_bev(bt, _t(scores), THRESH, PRE, POST, _t(valid), use_bev_iou=bev,
                                fast=fast)
        want = ref["nms"][name]
        np.testing.assert_array_equal(mask.numpy(), want["mask"], err_msg=name)
        np.testing.assert_array_equal(idx.numpy(), want["idx"], err_msg=name)
        kept += int(mask.sum())
        if name.startswith("invalid"):
            assert not mask.any()
        elif name.startswith("k1_"):
            assert mask.numpy().tolist() == [bool(valid[0])]
    assert kept > 500


def test_nms_sees_score_ties_and_duplicates():
    boxes, scores, valid = nms_scene(8, 120, ties=True)
    assert len(np.unique(scores)) == 5
    boxes, _, _ = nms_scene(500, 500)
    assert (np.abs(boxes[:, None] - boxes[None]).max(-1) == 0).sum() > 500  # exact duplicates


def test_nms_bev_batched_equals_jax_and_the_loop(ref):
    boxes, scores, valid = batch_scene()
    for fast in (False, True):
        for bev in (True, False):
            idx, mask = nms.nms_bev_batched(_t(boxes), _t(scores), THRESH, PRE, POST, _t(valid),
                                            use_bev_iou=bev, fast=fast)
            for b in range(3):
                one = nms.nms_bev(_t(boxes[b]), _t(scores[b]), THRESH, PRE, POST, _t(valid[b]),
                                  use_bev_iou=bev, fast=fast)
                assert torch.equal(idx[b], one[0]) and torch.equal(mask[b], one[1]), (b, fast, bev)
                if not fast and bev:
                    np.testing.assert_array_equal(mask[b].numpy(), ref["batch"][b]["mask"])
                    np.testing.assert_array_equal(idx[b].numpy(), ref["batch"][b]["idx"])
            counts = mask.sum(1).tolist()
            assert counts[0] > counts[1] > counts[2] > 0


def test_multi_classes_nms_and_box_fusion_hold_jax(ref):
    boxes, cls, valid = multi_scene()
    bt = _t(boxes)
    idx, mask, scores = nms.multi_classes_nms(_t(cls), bt, MULTI_CFG, 0.2, _t(valid))
    r_idx, r_mask, r_scores = ref["multi"]
    np.testing.assert_array_equal(mask.numpy(), r_mask)
    np.testing.assert_array_equal(torch.where(mask, idx, -1).numpy(), np.where(r_mask, r_idx, -1))
    np.testing.assert_allclose(scores.numpy(), r_scores, rtol=1e-5, atol=1e-5)
    for c in range(3):  # the classes' batch equals one call a class
        one = nms.class_agnostic_nms(_t(cls[:, c]), bt, MULTI_CFG, 0.2, _t(valid))
        assert all(torch.equal(a[c], b) for a, b in zip((idx, mask, scores), one))
    labels = np.random.default_rng(32).integers(0, 3, 300).astype(np.int32)
    out = nms.weighted_box_fusion(bt, _t(cls[:, 0]), _t(labels), 0.3, _t(valid))
    fused, f_scores, f_labels, keep = (o.numpy() for o in out)
    np.testing.assert_array_equal(keep, ref["wbf"][3])
    np.testing.assert_array_equal(f_labels, ref["wbf"][2])
    np.testing.assert_allclose(fused, ref["wbf"][0], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(f_scores, ref["wbf"][1], rtol=1e-5, atol=1e-5)
    assert 10 < int(keep.sum()) < int(valid.sum())


def test_mask_words_and_suppression_restate_the_jax_loops():
    """B4b's words unpack to the upper triangle of ``iou > thresh`` over
    valid pairs, and B4c's plain version equals JAX's ``_greedy_suppress`` /
    ``_fast_suppress`` on the full matrix."""
    boxes, scores, valid = nms_scene(65, 65)
    order = np.argsort(-scores, kind="stable")
    bt = _t(boxes[order])[None]
    vt = _t(valid[order])[None]
    words = nms.nms_mask_bev_reference(bt, vt, THRESH)
    assert words.shape == (1, 65, 2) and words.dtype == torch.int64
    iou = iou3d.iou_bev_from_overlap(iou3d.pairwise_overlap_bev_reference(bt, bt), bt, bt)[0]
    bits = nms.unpack_mask_bits(words, 65)[0]
    upper = torch.triu(torch.ones(65, 65, dtype=torch.bool), 1)
    assert torch.equal(bits, (iou > THRESH) & upper & vt[0][:, None] & vt[0][None, :])
    assert torch.equal(nms.pack_mask_bits(bits[None]), words)
    assert (words < 0).any() or not bits[:, 63::64].any()  # bit 63 is the sign bit
    for fast, jfn in ((False, jnms._greedy_suppress), (True, jnms._fast_suppress)):
        got = nms.nms_suppress(words, vt, fast)[0].numpy()
        want = np.asarray(jfn(jnp.asarray(iou.numpy()), jnp.asarray(valid[order]), THRESH))
        np.testing.assert_array_equal(got, want)


def test_wrappers_reject_wrong_operands():
    boxes = torch.zeros(2, 10, 7)
    with pytest.raises(ValueError):
        nms.nms_mask_bev(boxes, torch.ones(2, 9, dtype=torch.bool), THRESH)
    with pytest.raises(ValueError):
        nms.nms_suppress(torch.zeros(2, 10, 2, dtype=torch.int64), torch.ones(2, 10, dtype=torch.bool))
    with pytest.raises(ValueError):
        iou3d.pairwise_overlap_bev(boxes, torch.zeros(3, 4, 7))
    with pytest.raises(ValueError):
        iou3d.boxes_overlap_bev(boxes[0], boxes[0], method="hull")
    empty = nms.nms_bev(torch.zeros(0, 7), torch.zeros(0), THRESH)
    assert empty[0].shape == (0,) and empty[1].shape == (0,)


@pytest.mark.slow
def test_nms_kernel_reference_regenerated():
    refs.assert_regenerated(REF, jax_reference())
