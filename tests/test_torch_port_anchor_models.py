"""The DBSCAN and OYSTER VoxelRCNN models (AnchorHeadSingleV2 with its
point-density anchor mask, then VoxelRCNNHead: the proto head with the MM
branch off) of the port against the JAX package, on the CPU at f32.

Both yamls go through ``build_network`` in both packages with the scale
overrides ``ANCHOR_SETS`` (``SCALE_SETS``' range, voxel and stage caps, plus
RPN NMS over the top 512 anchors, 128 training RoIs sampled to 32, dropout
off; every width the yaml's) and the same seeded weights; JAX computes in
f32 under ``jax_f32`` with its NMS on the clip-method IoU.

* ``predict``: the proposals within 1e-4 of their scale, labels and validity
  exact; the port's RoI head and final NMS on the JAX proposals within 1e-4;
  whole predict at the tier of tests/test_torch_port_build_network.py
  (detections paired by box: 95% within 1e-4 of the scale, all within 0.1 m
  and 0.01).
* ``loss_step`` (batch 2, labels moved onto the port's own training
  proposals, the same sampling uniforms, the JAX proposals handed to the
  port's RoI head as in tests/test_torch_port_train.py): every tb term and
  the total within 1e-4 relative, and the tb keys those of the JAX step.

The two yamls build equal JAX models (the OYSTER yaml differs only in its
dataset), so the JAX side runs once for both (``_jax_once``): the OYSTER
cases hold a port model built from their own yaml to the same reference.
"""
import copy
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpd_tpu.models import roi_head as jroi
from tests.test_torch_port_anchor import jax_anchors_eager
from tests.test_torch_port_build_network import (SCALE_SETS, _np, _scaled_close, frames_batch,
                                                 jax_f32, load_pair, pair_detections, seeded_pair)
from tests.test_torch_port_losses import injected_sampling_uniforms, port_uniforms
from tests.test_torch_port_models import jax_nms_with_clip_iou
from tests.test_torch_port_train import _clip_iou3d

YAMLS = ["tools/cfgs/models/voxel_rcnn_dbscan_single_train.yaml",
         "tools/cfgs/models/voxel_rcnn_oyster_single_train.yaml"]
ANCHOR_SETS = SCALE_SETS + [
    "MODEL.DENSE_HEAD.POST_PROCESSING.NMS_CONFIG", "{'NMS_THRESH': 0.8, 'NMS_PRE_MAXSIZE': 512}",
    "MODEL.ROI_HEAD.NMS_CONFIG.TRAIN.NMS_POST_MAXSIZE", "128",
    "MODEL.ROI_HEAD.TARGET_CONFIG.ROI_PER_IMAGE", "32",
    "MODEL.ROI_HEAD.DP_RATIO", "0.0",
]
PROPOSAL_KEYS = ("rois", "roi_scores", "roi_labels", "roi_valid")
_JAX_RUNS = []  # (what, JAX model, digest of the inputs, outputs)


def _jax_once(what, jm, arrays, run):
    """``run()``'s outputs, computed once for an equal JAX model (flax
    modules compare by their fields) and the same input bytes."""
    digest = hashlib.sha1(b"".join(np.ascontiguousarray(a).tobytes() for a in arrays)).digest()
    for w, m, d, out in _JAX_RUNS:
        if w == what and m == jm and d == digest:
            return out
    out = run()
    _JAX_RUNS.append((what, jm, digest, out))
    return out


def _leaves(variables):
    return jax.tree_util.tree_leaves(variables)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module", params=YAMLS, ids=["dbscan", "oyster"])
def anchor_pair(request):
    port_cfg, jax_cfg = load_pair(request.param, ANCHOR_SETS)
    with jax_f32():
        jm, variables, pm = seeded_pair(port_cfg, jax_cfg)
    assert pm.dense_head_name == "AnchorHeadSingleV2" and not pm.mm and not pm.roi_head.mm
    return jm, variables, pm


def test_anchor_model_predict_matches(anchor_pair):
    jm, variables, pm = anchor_pair
    pts, valid = frames_batch(2)
    def run():
        jv = jax.tree_util.tree_map(jnp.asarray, variables)
        jbatch = {"points": jnp.asarray(pts), "points_valid": jnp.asarray(valid)}
        with jax_f32(), jax_nms_with_clip_iou():
            jout = jax.jit(lambda v, b: jm.apply(v, b, False))(jv, jbatch)
            keep = ("batch_box_preds", "batch_cls_preds", "roi_labels", "roi_valid")
            jpred = jax.jit(lambda v, o: jm.apply(v, o, method=type(jm).post_processing))(
                jv, {k: jout[k] for k in keep})
            jout = {k: v for k, v in jout.items() if k not in ("head_preds", "backbone_out")}
        return jax.device_get((jout, jpred))

    jout, jpred = _jax_once("predict", jm, [pts, valid] + _leaves(variables), run)
    with torch.no_grad():
        pout = pm({"points": _t(pts), "points_valid": _t(valid)})
        ppred = pm.post_processing(pout)
        handed = pm.post_processing(pm.roi_head({k: _t(jout[k]) for k in PROPOSAL_KEYS},
                                                pout["backbone_out"]))
    p = _np({k: pout[k] for k in PROPOSAL_KEYS})
    for k in ("roi_valid", "roi_labels"):
        np.testing.assert_array_equal(p[k], np.asarray(jout[k], np.float32))
    for k in ("rois", "roi_scores"):
        _scaled_close(p[k], np.asarray(jout[k], np.float32), k)
    port, ref = _np(handed), _np(jpred)
    np.testing.assert_array_equal(port["pred_valid"], ref["pred_valid"])
    np.testing.assert_array_equal(port["pred_labels"], ref["pred_labels"])
    for k in ("pred_boxes", "pred_scores"):
        _scaled_close(port[k], ref[k], k)
    port = _np(ppred)
    n = 0
    for b in range(2):
        pb = {k: v[b] for k, v in port.items()}
        rb = {k: v[b] for k, v in ref.items()}
        pi, ri, _ = pair_detections(pb, rb)
        np.testing.assert_array_equal(pb["pred_labels"][pi], rb["pred_labels"][ri])
        score_err = np.abs(pb["pred_scores"][pi] - rb["pred_scores"][ri])
        box_err = np.abs(pb["pred_boxes"][pi] - rb["pred_boxes"][ri]).max(-1)
        tight = ((box_err <= 1e-4 * np.abs(rb["pred_boxes"]).max())
                 & (score_err <= 1e-4 * np.abs(rb["pred_scores"]).max()))
        assert tight.mean() >= 0.95, (tight.mean(), box_err.max(), score_err.max())
        assert box_err.max() <= 0.1 and score_err.max() <= 0.01, (box_err.max(), score_err.max())
        n += len(pi)
    assert n > 40


def _labels_on_proposals(pm, points, valid, rng, n_gt=16):
    """Labels that proposals match: every fifth of the port's own
    training-mode proposals (a copy of the model, so that the running
    statistics stay), shifted by 3% of its size, as a label of a drawn
    class; then one row that is not valid."""
    probe = copy.deepcopy(pm).train()
    empty = {"gt_boxes": torch.zeros(2, 1, 8), "gt_valid": torch.zeros(2, 1, dtype=torch.bool)}
    with torch.no_grad():
        out = probe(dict(empty, points=_t(points), points_valid=_t(valid)),
                    sampling_uniforms=port_uniforms(np.zeros((2, 6, pm.num_rois), np.float32)))
    gt = np.zeros((2, n_gt, 8), np.float32)
    gv = np.zeros((2, n_gt), bool)
    for b in range(2):
        keep = np.nonzero(out["roi_valid"][b].numpy())[0][::5][:n_gt - 2]
        n = len(keep)
        gt[b, :n, :7] = out["rois"][b].numpy()[keep]
        gt[b, :n, 3:6] = np.clip(gt[b, :n, 3:6], 0.5, 6.0)
        gt[b, :n, 0:3] += 0.03 * gt[b, :n, 3:6] * rng.choice([-1.0, 1.0], (n, 3))
        gt[b, :n, 7] = rng.integers(1, 4, n)
        gv[b, :n] = True
        gt[b, n] = [1.0, 1.0, 0.0, 4.0, 2.0, 1.6, 0.3, 1.0]
    return gt, gv


def test_anchor_model_loss_step_matches(anchor_pair):
    jm, variables, pm = anchor_pair
    pm = copy.deepcopy(pm)  # the step moves the running statistics
    pts, valid = frames_batch(2, seed=1)
    rng = np.random.default_rng(0)
    gt, gv = _labels_on_proposals(pm, pts, valid, rng)
    batch = {"points": pts, "points_valid": valid, "gt_boxes": gt, "gt_valid": gv,
             "css_score": rng.uniform(0.5, 1.0, gv.shape).astype(np.float32)}
    table = rng.random((2, 6, pm.num_rois)).astype(np.float32)
    def jstep(m, b):
        out = m(b, train=True)
        nms = dict(m.rpn_nms, NMS_POST_MAXSIZE=m.num_rois)
        return m.compute_loss(out, b), m._anchor_proposals(out["head_preds"], m.num_rois, nms)

    def run():
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        jbatch["cur_it"] = jnp.asarray(1500.0, jnp.float32)
        jv = jax.tree_util.tree_map(jnp.asarray, variables)
        with jax_f32(), jax_nms_with_clip_iou(), jax_anchors_eager(), \
                injected_sampling_uniforms(table), pytest.MonkeyPatch.context() as mp:
            mp.setattr(jroi, "boxes_iou3d", _clip_iou3d)
            return jax.device_get(jax.jit(lambda v, b: jm.apply(
                v, b, method=jstep, mutable=["batch_stats"],
                rngs={"sampling": jax.random.PRNGKey(3), "dropout": jax.random.PRNGKey(4)})[0])(
                jv, jbatch))

    (jtotal, jtb), jprop = _jax_once("loss_step", jm, list(batch.values()) + [table]
                                     + _leaves(variables), run)
    proposals = {k: _t(v) for k, v in jprop.items()}
    pbatch = {k: _t(v) for k, v in batch.items()}
    pbatch["cur_it"] = 1500.0
    pm.train()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pm, "_anchor_proposals", lambda *a, **kw: proposals)
        ptotal, ptb = pm.loss_step(pbatch, sampling_uniforms=port_uniforms(table))
    assert set(ptb) == set(jtb)
    assert {"rpn_cls", "rpn_reg", "rpn_dir", "rpn_loss", "total_loss"} <= set(ptb)
    for k in jtb:
        ref, port = float(jtb[k]), float(ptb[k].detach())
        assert abs(port - ref) <= 1e-4 * max(abs(ref), 1e-6), (k, port, ref)
    assert float(jtb["rpn_reg"]) > 0 and float(jtb["rcnn_reg0"]) > 0
    assert abs(float(ptotal.detach()) - float(jtotal)) <= 1e-4 * abs(float(jtotal))
