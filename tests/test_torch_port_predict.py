"""The whole slice: ``VoxelRCNN.predict`` of the port against the JAX package
at ``__graft_entry__._TINY`` with a batch of 2, same seeded weights.

The JAX model has no dtype switch and always runs bf16, so the port runs at
its bf16 default too. Tiers:

* integer stages (voxel keys, coords, counts, all 8 stage rulebooks) match
  exactly;
* backbone features and head maps are within the bf16 tier of
  ``bf16_close`` (3% of the output scale);
* proposals and detections are compared as sets: bf16 noise reorders
  near-equal scores, so each valid port slot is paired with the valid JAX
  slot holding the same box. Proposal boxes agree to 3% of the scene scale
  and scores to 2e-3. The RoI grid-point voxel queries are discontinuous in
  the RoI position: a ~1 cm proposal shift moves some of the 6^3 grid points
  into other voxels, so the refined boxes agree to 0.5 m and their scores
  to 0.05, with labels exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _TINY, _make_batch
from cpd_tpu.models import backbone3d as jbb
from cpd_tpu.models.detector import VoxelRCNN as JVoxelRCNN
from cpd_tpu.models.detector import keys_from_frame as jkeys_from_frame
from cpd_tpu.ops import voxelizer as jvox
from cpd_tpu_torch.models import backbone3d
from cpd_tpu_torch.models.detector import VoxelRCNN, keys_from_frame
from cpd_tpu_torch.ops import voxelizer
from cpd_tpu_torch.utils.weights import state_dict_from_jax
from tests.test_torch_port_models import bf16_close, jax_nms_with_clip_iou, seeded_jax_variables


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().float()
    return np.asarray(x, np.float32)


@pytest.fixture(scope="module")
def slice_pair():
    batch = _make_batch(b=2, with_proto=False)
    points = np.array(batch["points"])
    jm = JVoxelRCNN(**_TINY, mm=False)
    jbatch = {"points": batch["points"], "points_valid": batch["points_valid"]}
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jbatch, False))
    variables = seeded_jax_variables(shapes, 0)
    jv = jax.tree_util.tree_map(jnp.asarray, variables)
    with jax_nms_with_clip_iou():
        jout = jax.jit(lambda v, x: jm.apply(v, x, False))(jv, jbatch)
        keep = ("batch_box_preds", "batch_cls_preds", "roi_labels", "roi_valid")
        jpred = jax.jit(lambda v, o: jm.apply(v, o, method=JVoxelRCNN.post_processing))(
            jv, {k: jout[k] for k in keep})
    pm = VoxelRCNN(**{k: v for k, v in _TINY.items() if k != "remat"}, mm=False)
    pm.load_state_dict(state_dict_from_jax(variables, pm), strict=True)
    pm.eval()
    pbatch = {"points": torch.from_numpy(points),
              "points_valid": torch.ones(points.shape[:2], dtype=torch.bool)}
    with torch.no_grad():
        pout = pm(pbatch)
        ppred = pm.post_processing(pout)
    return points, pm, pout, ppred, jm, jout, jpred


def _pairs(port_boxes, port_valid, ref_boxes, ref_valid, tol):
    """(port slots, ref slots): each valid port slot paired with the valid
    ref slot whose box (x, y, z, dx, dy, dz) agrees within ``tol``."""
    p_idx = list(np.nonzero(port_valid)[0])
    r_idx = list(np.nonzero(ref_valid)[0])
    assert len(p_idx) == len(r_idx), (len(p_idx), len(r_idx))
    r_out = []
    for i in p_idx:
        d = [float(np.abs(port_boxes[i, :6] - ref_boxes[j, :6]).max()) for j in r_idx]
        k = int(np.argmin(d))
        assert d[k] <= tol, f"slot {i}: nearest box {d[k]} m away"
        r_out.append(r_idx.pop(k))
    return p_idx, r_out


def test_predict_integer_stages_exact(slice_pair):
    points, pm, *_ = slice_pair
    jm = JVoxelRCNN(**_TINY, mm=False)
    jspec = jvox.VoxelizerSpec.create(jm.point_cloud_range, jm.voxel_size, jm.max_voxels)
    jframe = jvox.voxelize_batch(jnp.asarray(points), jspec)
    pframe = voxelizer.voxelize_batch(torch.from_numpy(points), pm.vox_spec)
    for name in ("coords", "num_points", "valid"):
        np.testing.assert_array_equal(getattr(pframe, name).numpy(),
                                      np.asarray(getattr(jframe, name)), err_msg=name)
    np.testing.assert_allclose(pframe.features.numpy(), np.asarray(jframe.features),
                               rtol=1e-5, atol=1e-5)
    jkeys = jkeys_from_frame(jframe, pm.grid)
    pkeys = keys_from_frame(pframe, pm.grid)
    np.testing.assert_array_equal(pkeys.numpy(), np.asarray(jkeys))
    ref = jbb.build_branch_rulebooks(jkeys, pm.grid, jm.backbone_caps)
    out = backbone3d.build_branch_rulebooks(pkeys, pm.grid, pm.backbone.caps)
    assert set(out) == set(ref)
    for name in ref:
        found = np.asarray(ref[name].found)
        np.testing.assert_array_equal(out[name].found.numpy(), found, err_msg=name)
        np.testing.assert_array_equal(out[name].idx.numpy()[found],
                                      np.asarray(ref[name].idx)[found], err_msg=name)
        np.testing.assert_array_equal(out[name].out_keys.numpy(),
                                      np.asarray(ref[name].out_keys), err_msg=name)


@pytest.mark.parametrize("stage", ["x_conv1", "x_conv2", "x_conv3", "x_conv4", "encoded"])
def test_predict_backbone_bf16(slice_pair, stage):
    _, _, pout, _, _, jout, _ = slice_pair
    pf, pk, _ = pout["backbone_out"][stage]
    jf, jk, _ = jout["backbone_out"][stage]
    assert pf.dtype == torch.bfloat16 and jf.dtype == jnp.bfloat16
    np.testing.assert_array_equal(pk.numpy(), np.asarray(jk))
    bf16_close(_np(pf), _np(jf), stage)


@pytest.mark.parametrize("head", ["hm", "center", "center_z", "dim", "rot"])
def test_predict_head_maps_bf16(slice_pair, head):
    _, _, pout, _, _, jout, _ = slice_pair
    bf16_close(_np(pout["head_preds"][head]), _np(jout["head_preds"][head]), head)


def test_predict_proposals_match(slice_pair):
    _, _, pout, _, _, jout, _ = slice_pair
    n_valid = 0
    for b in range(2):
        pb, jb = _np(pout["rois"])[b], _np(jout["rois"])[b]
        scale = float(np.abs(jb).max())
        p, r = _pairs(pb, _np(pout["roi_valid"])[b] > 0, jb, _np(jout["roi_valid"])[b] > 0,
                      0.03 * scale)
        n_valid += len(p)
        np.testing.assert_array_equal(_np(pout["roi_labels"])[b][p], _np(jout["roi_labels"])[b][r])
        np.testing.assert_allclose(_np(pout["roi_scores"])[b][p], _np(jout["roi_scores"])[b][r],
                                   atol=2e-3)
    assert n_valid > 4


def test_predict_detections_match(slice_pair):
    _, _, _, ppred, _, _, jpred = slice_pair
    assert set(ppred) == set(jpred)
    for k in ppred:
        assert tuple(ppred[k].shape) == tuple(jpred[k].shape), k
        assert np.isfinite(_np(ppred[k])).all(), k
    n_valid = 0
    for b in range(2):
        p, r = _pairs(_np(ppred["pred_boxes"])[b], _np(ppred["pred_valid"])[b] > 0,
                      _np(jpred["pred_boxes"])[b], _np(jpred["pred_valid"])[b] > 0, 0.5)
        n_valid += len(p)
        np.testing.assert_array_equal(_np(ppred["pred_labels"])[b][p],
                                      _np(jpred["pred_labels"])[b][r])
        np.testing.assert_allclose(_np(ppred["pred_scores"])[b][p],
                                   _np(jpred["pred_scores"])[b][r], atol=0.05)
        np.testing.assert_allclose(_np(ppred["pred_boxes"])[b][p],
                                   _np(jpred["pred_boxes"])[b][r], atol=0.5)
    assert n_valid > 4
