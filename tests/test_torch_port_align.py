"""The X_TRAIN stage-align path and the detector tail's registry hooks of the
port against the JAX package, on the CPU, and the optimizer's repair.

* The slice: a VoxelRCNN with ``align_stages=2`` (mean fusion) at
  ``__graft_entry__._TINY``'s scale, f32 on both sides, on two stage clones
  of each sample made by the port's ``XTransform``: ``predict`` with the
  clones packed into the batch axis against JAX's (proposals and final
  detections within 1e-4 of their scale, validity and labels exact), the
  port's sequential routing equal to its packed one, and ``loss_step`` (two
  sequential shared-backbone passes, each batch norm updated twice in
  order) at the tiers of tests/test_torch_port_registry.py.
* The optimizer: two steps of each of the port's optimizers against optax's
  on the same arrays, where one parameter has a gradient in the first step
  and none in the second (no loss term reads it). It takes a zero gradient,
  as JAX's is: its moments decay and AdamW's decoupled decay moves it, to
  optax's within 1e-6; the gradient norm counts the gradients there are.
  The PFE after one step of a whole model: tests/test_torch_port_pfe.py.
* A temporal model whose history ends early: ``num_frames=3`` with only
  ``points_prev1`` fuses the two frames there are, equal to ``num_frames=2``.
"""
import copy

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from __graft_entry__ import _TINY
from cpd_tpu.models import detector as jdet
from cpd_tpu.parallel import trainer as jtrainer
from cpd_tpu_torch.datasets.augmentor import XTransform
from cpd_tpu_torch.models.detector import VoxelRCNN
from cpd_tpu_torch.parallel import trainer
from cpd_tpu_torch.utils.synthetic import make_tiny_train_batch
from cpd_tpu_torch.utils.weights import seeded_state_dict
from tests import torch_port_refs as refs
from tests.test_torch_port_build_network import _np, _scaled_close
from tests.test_torch_port_registry import (PROPOSAL_KEYS, _t, check_loss_step,
                                            jax_loss_step, jax_predict, jax_slice_f32,
                                            port_loss_step, slice_batch, slice_pair)

ALIGN_KW = dict(_TINY, mm=False, with_roi_head=False, align_stages=2, align_method="mean",
                bev_layer_nums=(1, 1))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread, as in tests/test_torch_port_cli_train.py: beside
    the other test workers, torch's threads wait on busy cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def align_batch(seed=5):
    """Two samples, each replaced by ``XTransform``'s stage 0 clone, with
    its stage 1 clone as ``points_stage1`` and the (S, 3) parameter rows."""
    batch = make_tiny_train_batch(b=2, seed=seed, with_proto=False)
    rng = np.random.default_rng(seed)
    xt = XTransform(stages=2)
    clones = [xt.input_transform({"points": p}, rng) for p in batch["points"]]
    batch["points"] = np.stack([c["points"] for c in clones])
    batch["points_stage1"] = np.stack([c["points_stage1"] for c in clones])
    batch["points_stage1_valid"] = batch["points_valid"].copy()
    batch["transform_param"] = np.stack([c["transform_param"] for c in clones])
    return batch


@pytest.fixture(scope="module")
def align_slice():
    """The port's slice; the JAX eval forward and post-processing are the
    committed reference ``align_slice``, the JAX training step runs here."""
    batch = align_batch()
    ref = refs.load("align_slice")
    with jax_slice_f32():
        jm, variables, pm = slice_pair(jdet.VoxelRCNN, VoxelRCNN, ALIGN_KW, batch)
        step = jax_loss_step(jm, variables, batch)
    return variables, pm, batch, ref["out"], ref["pred"], step


@pytest.mark.slow
def test_align_slice_reference_is_regenerated():
    batch = align_batch()
    with jax_slice_f32():
        jm, variables, _ = slice_pair(jdet.VoxelRCNN, VoxelRCNN, ALIGN_KW, batch)
        live = jax_predict(jm, variables, batch, PROPOSAL_KEYS)
    refs.assert_regenerated("align_slice", live)


def test_align_slice_predict_packed_and_sequential_match(align_slice):
    _, pm, batch, jout, jpred, _ = align_slice
    pbatch = {k: _t(v) for k, v in batch.items()}
    assert pm.pack_align_stages
    with torch.no_grad():
        pout = pm(pbatch)
        pred = pm.post_processing(pout)
        seq = copy.deepcopy(pm)
        seq.pack_align_stages = False
        seq_pred = seq.predict(pbatch)
    p = _np({k: pout[k] for k in PROPOSAL_KEYS})
    for k in ("roi_valid", "roi_labels"):
        np.testing.assert_array_equal(p[k], np.asarray(jout[k], np.float32))
    for k in ("rois", "roi_scores"):
        _scaled_close(p[k], np.asarray(jout[k], np.float32), k)
    port, ref = _np(pred), _np(jpred)
    for k in ("pred_valid", "pred_labels"):
        np.testing.assert_array_equal(port[k], ref[k])
    assert port["pred_valid"].sum() >= 4
    for k in ("pred_boxes", "pred_scores"):
        _scaled_close(port[k], ref[k], k)
    sequential = _np(seq_pred)
    for k in port:
        _scaled_close(sequential[k], port[k], f"sequential {k}")


def test_align_slice_loss_step_matches(align_slice):
    variables, pm, batch, _, _, (jgrads, jtb, jstats, jprops) = align_slice
    pm = copy.deepcopy(pm)
    ptotal, ptb, no_grad = port_loss_step(pm, batch, jprops)
    assert not no_grad
    check_loss_step(pm, variables, ptotal, ptb, jgrads, jtb, jstats)


@pytest.mark.parametrize("name", ["adam_onecycle", "adam", "sgd"])
def test_optimizer_updates_parameters_without_a_gradient_as_optax_does(name):
    rng = np.random.default_rng(7)
    init = {"w": rng.normal(size=(6, 4)), "b": rng.normal(size=(5,))}
    init = {k: v.astype(np.float32) for k, v in init.items()}
    steps = [{"w": rng.normal(size=(6, 4)) * 3.0, "b": rng.normal(size=(5,))},
             {"w": rng.normal(size=(6, 4)) * 3.0, "b": None}]  # no gradient reaches b
    cfg = {"OPTIMIZER": name, "LR": 0.003, "WEIGHT_DECAY": 0.1, "GRAD_NORM_CLIP": 10.0}
    params = torch.nn.ParameterDict({k: torch.nn.Parameter(_t(v)) for k, v in init.items()})
    opt = trainer.build_optimizer(params.values(), cfg, 100)
    tx = jtrainer.build_optimizer(cfg, 100)
    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    jstate = tx.init(jparams)
    for grads in steps:
        for k, p in params.items():
            p.grad = None if grads[k] is None else _t(grads[k].astype(np.float32))
        jgrads = {k: jnp.zeros_like(jparams[k]) if g is None else jnp.asarray(g, jnp.float32)
                  for k, g in grads.items()}
        norm = float(opt.step())
        assert abs(norm - float(optax.global_norm(jgrads))) <= 1e-5 * norm
        updates, jstate = tx.update(jgrads, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
    for k, p in params.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[k]), rtol=1e-6,
                                   atol=1e-7, err_msg=k)
    assert params["b"].grad is None  # the second step gave it none
    assert np.abs(params["b"].detach().numpy() - init["b"]).max() > 1e-4


def test_temporal_history_that_ends_early_shortens_the_window():
    """ConvGRU with ``num_frames=3`` given only ``points_prev1`` fuses two
    frames: the same outputs as ``num_frames=2`` with the same weights."""
    batch = {k: _t(v) for k, v in slice_batch().items()}
    kw = dict(_TINY, mm=False, with_roi_head=False, temporal_name="ConvGRU")
    short = VoxelRCNN(**kw, num_frames=2).eval()
    short.load_state_dict(seeded_state_dict(short, 0), strict=True)
    long = VoxelRCNN(**kw, num_frames=3).eval()
    long.load_state_dict(short.state_dict(), strict=True)
    with torch.no_grad():
        a, b = short.predict(batch), long.predict(batch)
        one = short.predict({k: v for k, v in batch.items() if not k.startswith("points_prev")})
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    assert not torch.equal(a["pred_scores"], one["pred_scores"])  # the history is read
