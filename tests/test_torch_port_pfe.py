"""The PFE of the port against the JAX package, on the CPU: the pooling
primitives it reads (voxel queries, ball query, farthest point sampling,
3-NN interpolation), kernel F1's plain version, VoxelSetAbstraction alone
and a VoxelRCNN with a PFE through ``predict`` and ``loss_step``.

* Farthest point sampling (``ops.fps.farthest_point_sample_reference``, what
  F1 computes): indices equal to the JAX loop's, on spread points, on
  integer points full of ties, with padding, with fewer valid points than
  samples and with none. The distance is ``jnp.linalg.norm``'s on the CPU,
  sqrt(fma(z, z, fma(y, y, x*x))), bit for bit
  (``test_jax_norm_of_three_values_is_a_chain_of_fused_multiply_adds``).
* ``voxel_query``: idx and valid equal to JAX's, unfilled slots included;
  ``voxel_query_fast`` (nearest): valid equal and idx equal where valid;
  ``ball_query`` exact; centres and interpolations within 1e-6 of scale.
* VoxelSetAbstraction alone on random sparse scales and a BEV map, f32:
  keypoints equal, features within 1e-4 of their scale.
* The slice: a VoxelRCNN with VoxelSetAbstraction (256 keypoints) at
  ``_TINY``'s scale, f32 on both sides: the eval forward's keypoints (exact)
  and keypoint features, ``predict``, and ``loss_step`` at the tiers of
  tests/test_torch_port_registry.py. Neither ``predict`` nor ``loss_step``
  reads the keypoint features, and neither computes them (JAX's jit drops
  them there); the PFE's gradients are zero in JAX and None in the port; after one
  adam_onecycle step (decay 0.1, so that the decay shows in f32) the PFE's
  weights equal optax's, which decays them alone, within 1e-6.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from __graft_entry__ import _TINY
from cpd_tpu.models import detector as jdet
from cpd_tpu.models import pfe as jpfe
from cpd_tpu.ops import pool as jpool
from cpd_tpu.ops.sparse import INVALID_KEY, GridSpec as JGridSpec
from cpd_tpu.parallel import trainer as jtrainer
from cpd_tpu_torch.models import pfe
from cpd_tpu_torch.models.detector import VoxelRCNN
from cpd_tpu_torch.ops import fps, pool
from cpd_tpu_torch.ops.sparse import GridSpec
from cpd_tpu_torch.parallel import trainer
from cpd_tpu_torch.utils.weights import state_dict_from_jax
from tests import torch_port_refs as refs
from tests.test_torch_port_build_network import _np, _scaled_close
from tests.test_torch_port_models import seeded_jax_variables
from tests.test_torch_port_registry import (PROPOSAL_KEYS, _t, check_loss_step, jax_loss_step,
                                            jax_predict, jax_slice_f32, port_loss_step,
                                            slice_batch, slice_pair)

PCR = (-16.0, -16.0, -2.0, 16.0, 16.0, 4.0)
VOXEL = (0.5, 0.5, 0.15)
GRID = (64, 64, 41)
PFE_KW = dict(_TINY, mm=False, with_roi_head=False, bev_layer_nums=(1, 1),
              pfe_name="VoxelSetAbstraction", pfe_cfg={"num_keypoints": 256, "nsample": 8})


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread, as in tests/test_torch_port_cli_train.py: beside
    the other test workers, torch's threads wait on busy cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cloud(case, rng, n=3000):
    pts = rng.normal(0.0, 6.0, (n, 3)).astype(np.float32)
    valid = rng.random(n) > 0.3
    if case == "ties":
        pts = np.round(pts / 2.0).astype(np.float32)  # integer grid: many equal distances
    elif case == "few_valid":
        valid = np.zeros(n, bool)
        valid[[17, 400, 401, 2999]] = True
    elif case == "none_valid":
        valid = np.zeros(n, bool)
    return pts, valid


def test_jax_norm_of_three_values_is_a_chain_of_fused_multiply_adds():
    """``jnp.linalg.norm(d, axis=-1)`` of (N, 3), jitted as in
    ``farthest_point_sample``, is sqrt(fma(z, z, fma(y, y, x*x))) in f32 bit
    for bit on the CPU (XLA contracts the sum of squares), and neither
    unfused order is: the port's ``fused_norm`` computes the fused chain."""
    d = np.random.default_rng(0).normal(0.0, 7.0, (20000, 3)).astype(np.float32)
    ref = np.asarray(jax.jit(lambda x: jnp.linalg.norm(x, axis=-1))(jnp.asarray(d)))
    x, y, z = d[:, 0], d[:, 1], d[:, 2]
    np.testing.assert_array_equal(fps.fused_norm(_t(d)).numpy(), ref)
    np.testing.assert_array_equal(
        fps._distance(_t(d)[None], torch.zeros(1, 3))[0].numpy(), ref)
    assert (np.sqrt((x * x + y * y) + z * z) != ref).any()
    assert (np.sqrt(x * x + (y * y + z * z)) != ref).any()


@pytest.mark.parametrize("case", ["spread", "ties", "few_valid", "none_valid"])
def test_farthest_point_sample_plain_matches_jax_exactly(case):
    rng = np.random.default_rng(["spread", "ties", "few_valid", "none_valid"].index(case))
    pts, valid = _cloud(case, rng)
    ref = np.asarray(jax.jit(jpool.farthest_point_sample, static_argnums=2)(
        jnp.asarray(pts), jnp.asarray(valid), 256))
    got = fps.farthest_point_sample_reference(_t(pts)[None], _t(valid)[None], 256)[0].numpy()
    np.testing.assert_array_equal(got, ref)
    single = pool.farthest_point_sample(_t(pts), _t(valid), 256).numpy()  # the pool entry
    np.testing.assert_array_equal(single, ref)
    if valid.any():
        assert valid[got].all()  # a padded point is never chosen
        if valid.sum() < 256:  # the first valid point repeats once all are taken
            assert set(got.tolist()) == set(np.nonzero(valid)[0].tolist())
    else:
        assert not got.any()


def _sparse_scale(rng, grid, n):
    keys = np.sort(rng.choice(grid[0] * grid[1] * grid[2], n, replace=False)).astype(np.int32)
    keys[-n // 8:] = INVALID_KEY
    return keys


def test_voxel_queries_match_jax():
    rng = np.random.default_rng(1)
    keys = _sparse_scale(rng, GRID, 4000)
    q = np.stack([rng.uniform(-17, 17, 300), rng.uniform(-17, 17, 300),
                  rng.uniform(-2.5, 4.5, 300)], 1).astype(np.float32)
    args = (VOXEL, PCR, 2, (2, 2, 2), 1.6, 16)
    ji, jv, jc = jpool.voxel_query(jnp.asarray(q), jnp.asarray(keys), JGridSpec(*GRID), *args[:2],
                                   downsample=2, query_range=(2, 2, 2), radius=1.6, nsample=16)
    pi, pv, pc = pool.voxel_query(_t(q), _t(keys), GridSpec(*GRID), *args)
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    assert 0.02 < float(pv.float().mean()) < 1.0
    _scaled_close(pc.numpy(), np.asarray(jc), "voxel_query centres")
    for radius in (0.8, 1.6):
        ji, jv, jc = jpool.voxel_query_fast(jnp.asarray(q), jnp.asarray(keys), JGridSpec(*GRID),
                                            VOXEL, PCR, 2, (2, 2, 2), radius, 16)
        pi, pv, pc = pool.voxel_query_fast(_t(q), _t(keys), GridSpec(*GRID), VOXEL, PCR, 2,
                                           (2, 2, 2), radius, 16)
        jv = np.asarray(jv)
        np.testing.assert_array_equal(pv.numpy(), jv)
        np.testing.assert_array_equal(pi.numpy()[jv], np.asarray(ji)[jv])
        _scaled_close(pc.numpy()[jv], np.asarray(jc)[jv], "voxel_query_fast centres")


def test_ball_query_and_three_nn_interpolate_match_jax():
    rng = np.random.default_rng(2)
    q = rng.normal(0, 3, (60, 3)).astype(np.float32)
    support = rng.normal(0, 3, (400, 3)).astype(np.float32)
    valid = rng.random(400) > 0.2
    feats = rng.normal(size=(400, 6)).astype(np.float32)
    ji, jv = jpool.ball_query(jnp.asarray(q), jnp.asarray(support), jnp.asarray(valid), 1.5, 8)
    pi, pv = pool.ball_query(_t(q), _t(support), _t(valid), 1.5, 8)
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    ref = jpool.three_nn_interpolate(jnp.asarray(q), jnp.asarray(support), jnp.asarray(valid),
                                     jnp.asarray(feats))
    got = pool.three_nn_interpolate(_t(q), _t(support), _t(valid), _t(feats))
    _scaled_close(got.numpy(), np.asarray(ref), "three_nn_interpolate")


def test_voxel_set_abstraction_alone_matches_jax():
    """VSA on 2 clouds of 2,000 points (some padding) over random x_conv3 /
    x_conv4 scales and a 8 x 8 x 24 BEV map, 128 keypoints, f32."""
    rng = np.random.default_rng(3)
    pts = np.concatenate([rng.uniform(-15, 15, (2, 2000, 2)), rng.uniform(-2, 4, (2, 2000, 1)),
                          rng.uniform(0, 1, (2, 2000, 2))], -1).astype(np.float32)
    valid = rng.random((2, 2000)) > 0.1
    grids = {"x_conv3": (16, 16, 11), "x_conv4": (8, 8, 5)}
    widths = {"x_conv3": 12, "x_conv4": 20}
    jout, pout = {}, {}
    for name, g in grids.items():
        n = 400 if name == "x_conv3" else 200
        keys = np.stack([_sparse_scale(rng, g, n) for _ in range(2)])
        feats = rng.normal(size=(2, n, widths[name])).astype(np.float32)
        jout[name] = (jnp.asarray(feats), jnp.asarray(keys), JGridSpec(*g))
        pout[name] = (_t(feats), _t(keys), GridSpec(*g))
    bev_map = rng.normal(size=(2, 8, 8, 24)).astype(np.float32)
    kw = dict(num_keypoints=128, voxel_size=VOXEL, point_cloud_range=PCR, nsample=8)
    jm = jpfe.VoxelSetAbstraction(**kw)
    args = (jnp.asarray(pts), jnp.asarray(valid), jout, jnp.asarray(bev_map))
    # the scales' GridSpecs are static: close over the arguments, apply eagerly
    variables = seeded_jax_variables(jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                                                    *args)), 0)
    pm = pfe.VoxelSetAbstraction(widths, 24, **kw)
    holder = torch.nn.Module()  # the bridge maps the PFE by its path in the detector
    holder.pfe = pm
    holder.load_state_dict(state_dict_from_jax({"params": {"pfe": variables["params"]}}, holder),
                           strict=True)
    jkp, jfeat, jvalid = jm.apply(jax.tree_util.tree_map(jnp.asarray, variables), *args)
    with torch.no_grad():
        kp, feat, kvalid = pm(_t(pts), _t(valid), pout, _t(bev_map))
    np.testing.assert_array_equal(kp.numpy(), np.asarray(jkp))
    np.testing.assert_array_equal(kvalid.numpy(), np.asarray(jvalid))
    assert feat.shape == (2, 128, pm.out_channels) == jfeat.shape
    _scaled_close(feat.numpy(), np.asarray(jfeat), "keypoint features")
    assert float((feat[..., :64] != 0).float().mean()) > 0.3  # the scales found voxels


@pytest.fixture(scope="module")
def pfe_slice():
    batch = slice_batch(history=False, seed=4)
    ref = refs.load("pfe_slice")
    with jax_slice_f32():
        jm, variables, pm = slice_pair(jdet.VoxelRCNN, VoxelRCNN, PFE_KW, batch)
        step = jax_loss_step(jm, variables, batch)
    return variables, pm, batch, ref["out"], ref["pred"], step


@pytest.mark.slow
def test_pfe_slice_reference_is_regenerated():
    """The committed ``pfe_slice``: JAX's eval forward and post-processing."""
    batch = slice_batch(history=False, seed=4)
    with jax_slice_f32():
        jm, variables, _ = slice_pair(jdet.VoxelRCNN, VoxelRCNN, PFE_KW, batch)
        live = jax_predict(jm, variables, batch, PROPOSAL_KEYS + (
            "point_coords", "point_features", "point_valid"))
    refs.assert_regenerated("pfe_slice", live)


def test_pfe_slice_predict_matches(pfe_slice):
    """The eval forward's keypoints (exact) and their features (1e-4 of
    scale), the proposals and the final detections."""
    _, pm, batch, jout, jpred, _ = pfe_slice
    with torch.no_grad():
        pout = pm({k: _t(v) for k, v in batch.items()})
        pred = pm.post_processing(pout)
    np.testing.assert_array_equal(pout["point_coords"].numpy(), jout["point_coords"])
    np.testing.assert_array_equal(pout["point_valid"].numpy(), jout["point_valid"])
    _scaled_close(pout["point_features"].numpy(), np.asarray(jout["point_features"]),
                  "point_features")
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


def test_pfe_slice_loss_step_matches(pfe_slice):
    """loss_step: the PFE's parameters take no gradient in the port (None)
    and zeros in JAX; everything else at the registry file's tiers."""
    variables, pm, batch, _, _, (jgrads, jtb, jstats, jprops) = pfe_slice
    assert not any(np.abs(np.asarray(v)).max() for v in jax.tree_util.tree_leaves(jgrads["pfe"]))
    ptotal, ptb, no_grad = port_loss_step(pm, batch, jprops)
    assert no_grad == sorted(k for k, _ in pm.named_parameters() if k.startswith("pfe."))
    check_loss_step(pm, variables, ptotal, ptb, jgrads, jtb, jstats)


def test_predict_and_loss_step_compute_no_keypoints(pfe_slice):
    """The PFE (and so kernel F1) runs only in the forward that returns its
    keypoint features: ``predict`` and ``loss_step`` never call it."""
    _, pm, batch, _, _, _ = pfe_slice
    pm = copy.deepcopy(pm)
    pbatch = {k: _t(v) for k, v in batch.items()}

    def refuse(*args, **kwargs):
        raise AssertionError("the PFE ran")

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pm.pfe, "forward", refuse)
        assert pm.eval().predict(pbatch)["pred_valid"].any()
        total, _ = pm.train().loss_step(dict(pbatch, cur_it=1500.0))
        assert torch.isfinite(total)
        with pytest.raises(AssertionError, match="the PFE ran"), torch.no_grad():
            pm.eval()(pbatch)


def test_pfe_weights_after_one_step_are_jax_decayed_weights(pfe_slice):
    """One adam_onecycle step from the slice's gradients: no gradient reaches
    the PFE, and its weights move by AdamW's decoupled decay alone, as
    optax's step on JAX's zero gradients moves them (clipping scales a zero
    gradient to zero, so optax runs on the PFE's subtree alone)."""
    variables, pm, batch, _, _, (jgrads, _, _, jprops) = pfe_slice
    pm = copy.deepcopy(pm).train()
    pm.zero_grad(set_to_none=True)
    with pytest.MonkeyPatch.context() as mp:
        props = {k: _t(v) for k, v in jprops.items()}
        mp.setattr(pm.dense_head, "generate_predicted_boxes", lambda *a, **kw: props)
        total, _ = pm.loss_step(dict({k: _t(v) for k, v in batch.items()}, cur_it=1500.0))
    total.backward()
    pfe_keys = sorted(k for k, p in pm.named_parameters() if p.grad is None)
    assert pfe_keys and all(k.startswith("pfe.") for k in pfe_keys)
    cfg = {"OPTIMIZER": "adam_onecycle", "LR": 0.003, "WEIGHT_DECAY": 0.1, "GRAD_NORM_CLIP": 10.0}
    trainer.build_optimizer(pm.parameters(), cfg, 100).step()
    tx = jtrainer.build_optimizer(cfg, 100)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"]["pfe"])
    updates, _ = tx.update(jax.tree_util.tree_map(jnp.asarray, jgrads["pfe"]), tx.init(params),
                           params)
    holder = torch.nn.Module()
    holder.pfe = pm.pfe
    want = state_dict_from_jax({"params": {"pfe": jax.device_get(
        optax.apply_updates(params, updates))}}, holder)
    start = state_dict_from_jax({"params": {"pfe": variables["params"]["pfe"]}}, holder)
    for key, p in holder.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[key].numpy(), rtol=1e-6, atol=1e-7,
                                   err_msg=key)
        assert not torch.equal(p.detach(), start[key]), key
