"""CenterPoint of the port against the JAX package's, on the CPU, at
``__graft_entry__._TINY``'s scale, f32 on both sides (``jax_slice_f32``):
the same seeded weights through one ``predict`` (the head maps within 1e-4
of their scale, the detections' validity and labels exact, boxes and
scores within 1e-4) and one ``loss_step`` at the tiers of
tests/test_torch_port_registry.py (the loss and tb, every gradient leaf,
each module's summed gradient, the batch statistics after the step). A file
of its own so that its JAX compile runs beside the registry file's.
"""
import copy

import numpy as np
import pytest
import torch

from __graft_entry__ import _TINY
from cpd_tpu.models import centerpoint as jcp
from cpd_tpu_torch.models.centerpoint import CenterPoint
from tests import torch_port_refs as refs
from tests.test_torch_port_build_network import _np, _scaled_close
from tests.test_torch_port_registry import (_t, check_loss_step, jax_forward, jax_loss_step,
                                            jax_slice_f32, one_thread,  # noqa: F401
                                            port_loss_step, slice_batch, slice_pair)

CENTERPOINT_KW = {k: _TINY[k] for k in ("num_classes", "point_cloud_range", "voxel_size",
                                        "max_voxels", "backbone_caps")}
PRED_KEYS = ("pred_boxes", "pred_scores", "pred_labels", "pred_valid")


@pytest.fixture(scope="module")
def centerpoint_slice():
    """JAX's CenterPoint and the port's, the same seeded weights, f32, and
    the JAX side's eval forward and training step, once."""
    batch = slice_batch(history=False, seed=2)
    jout = refs.load("centerpoint_forward")
    with jax_slice_f32():
        jm, variables, pm = slice_pair(jcp.CenterPoint, CenterPoint, CENTERPOINT_KW, batch)
        step = jax_loss_step(jm, variables, batch)
    return variables, pm, batch, jout, step


@pytest.mark.slow
def test_centerpoint_forward_reference_is_regenerated():
    """The committed ``centerpoint_forward``: JAX's jitted eval forward."""
    batch = slice_batch(history=False, seed=2)
    with jax_slice_f32():
        jm, variables, _ = slice_pair(jcp.CenterPoint, CenterPoint, CENTERPOINT_KW, batch)
        live = jax_forward(jm, variables, batch, ("head_preds",) + PRED_KEYS)
    refs.assert_regenerated("centerpoint_forward", live)


def test_centerpoint_predict_matches(centerpoint_slice):
    """CenterPoint's eval forward against JAX's: the head maps within 1e-4
    of their scale; ``predict``'s detections (top 500, score 0.1, NMS 0.7)
    with validity and labels exact, boxes and scores within 1e-4."""
    _, pm, batch, jout, _ = centerpoint_slice
    pbatch = {k: _t(v) for k, v in batch.items()}
    with torch.no_grad():
        maps = pm.eval()(pbatch)["head_preds"]
        pred = pm.predict(pbatch)
    assert set(maps) == set(jout["head_preds"])
    for k, v in maps.items():
        _scaled_close(v.numpy(), np.asarray(jout["head_preds"][k]), k)
    port = _np(pred)
    for k in ("pred_valid", "pred_labels"):
        np.testing.assert_array_equal(port[k], np.asarray(jout[k], np.float32))
    assert port["pred_valid"].sum() >= 5
    for k in ("pred_boxes", "pred_scores"):
        _scaled_close(port[k], np.asarray(jout[k]), k)


def test_centerpoint_loss_step_matches(centerpoint_slice):
    """CenterPoint's ``loss_step`` against JAX's: the CenterHead's loss and
    its tb keys, every gradient and the batch statistics after the step."""
    variables, pm, batch, _, (jgrads, jtb, jstats, _) = centerpoint_slice
    pm = copy.deepcopy(pm)
    ptotal, ptb, no_grad = port_loss_step(pm, batch, None)
    assert not no_grad
    assert set(ptb) == {"hm_loss", "loc_loss", "total_loss"}
    check_loss_step(pm, variables, ptotal, ptb, jgrads, jtb, jstats)
