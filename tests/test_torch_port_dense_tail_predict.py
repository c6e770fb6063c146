"""``VoxelRCNN.predict`` with the dense backbone tail in both packages at
``__graft_entry__._TINY`` (bf16), batch 2, the same seeded weights: backbone
stages, head maps and detections, at the tiers of
``test_torch_port_predict.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _TINY, _make_batch
from cpd_tpu.models.detector import VoxelRCNN as JVoxelRCNN
from cpd_tpu_torch.models.detector import VoxelRCNN
from cpd_tpu_torch.utils.weights import state_dict_from_jax
from tests.test_torch_port_dense_tail import _np
from tests.test_torch_port_models import bf16_close, jax_nms_with_clip_iou, seeded_jax_variables


@pytest.fixture(scope="module")
def predict_pair():
    """``VoxelRCNN.predict`` with ``dense_tail=True`` in both packages at
    ``_TINY`` (bf16, the JAX model's only dtype), batch 2, same weights."""
    batch = _make_batch(b=2, with_proto=False)
    points = np.array(batch["points"])
    jm = JVoxelRCNN(**_TINY, mm=False, dense_tail=True)
    jbatch = {"points": batch["points"], "points_valid": batch["points_valid"]}
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jbatch, False))
    variables = seeded_jax_variables(shapes, 0)
    jv = jax.tree_util.tree_map(jnp.asarray, variables)
    with jax_nms_with_clip_iou():
        jout = jax.jit(lambda v, x: jm.apply(v, x, False))(jv, jbatch)
        keep = ("batch_box_preds", "batch_cls_preds", "roi_labels", "roi_valid")
        jpred = jax.jit(lambda v, o: jm.apply(v, o, method=JVoxelRCNN.post_processing))(
            jv, {k: jout[k] for k in keep})
    pm = VoxelRCNN(**{k: v for k, v in _TINY.items() if k != "remat"}, mm=False, dense_tail=True)
    pm.load_state_dict(state_dict_from_jax(variables, pm), strict=True)
    pm.eval()
    pbatch = {"points": torch.from_numpy(points),
              "points_valid": torch.ones(points.shape[:2], dtype=torch.bool)}
    with torch.no_grad():
        pout = pm(pbatch)
        ppred = pm.predict(pbatch)
    return pout, ppred, jout, jpred


@pytest.mark.parametrize("stage", ["x_conv3", "x_conv4", "encoded"])
def test_predict_dense_tail_backbone_bf16(predict_pair, stage):
    pout, _, jout, _ = predict_pair
    (pf, pk, _), (jf, jk, _) = pout["backbone_out"][stage], jout["backbone_out"][stage]
    assert pf.dtype == torch.bfloat16
    np.testing.assert_array_equal(pk.numpy(), np.asarray(jk))
    bf16_close(_np(pf), _np(jf), stage)
    assert "encoded_bev" not in pout["backbone_out"]  # consumed as the BEV map


@pytest.mark.parametrize("head", ["hm", "center", "center_z", "dim", "rot"])
def test_predict_dense_tail_head_maps_bf16(predict_pair, head):
    pout, _, jout, _ = predict_pair
    bf16_close(_np(pout["head_preds"][head]), _np(jout["head_preds"][head]), head)


def test_predict_dense_tail_detections_match(predict_pair):
    """Detections as sets, at the tiers of tests/test_torch_port_predict.py:
    boxes within 0.5 m, scores within 0.05, labels exact."""
    _, ppred, _, jpred = predict_pair
    n_valid = 0
    for b in range(2):
        pb, jb = _np(ppred["pred_boxes"])[b], _np(jpred["pred_boxes"])[b]
        p_idx = list(np.nonzero(_np(ppred["pred_valid"])[b] > 0)[0])
        r_idx = list(np.nonzero(_np(jpred["pred_valid"])[b] > 0)[0])
        assert len(p_idx) == len(r_idx)
        for i in p_idx:
            d = [float(np.abs(pb[i, :6] - jb[j, :6]).max()) for j in r_idx]
            j = r_idx.pop(int(np.argmin(d)))
            assert min(d) <= 0.5, f"slot {i}: nearest box {min(d)} m away"
            assert _np(ppred["pred_labels"])[b][i] == _np(jpred["pred_labels"])[b][j]
            assert abs(_np(ppred["pred_scores"])[b][i] - _np(jpred["pred_scores"])[b][j]) <= 0.05
            n_valid += 1
    assert n_valid > 4
