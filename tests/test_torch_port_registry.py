"""The rest of the detector registry in the port against the JAX package, on
the CPU: VoxelBackBone8x, the PartWraper wrap head, the BEV pooling and
X_TRAIN alignment functions, the temporal models and CenterPoint, and
``build_network`` over every registry name.

* Modules alone, f32, numpy-seeded inputs and ``state_dict_from_jax``
  weights: outputs within 1e-4 of their scale; for PartWraper and the
  temporal models also the gradients of a random linear functional of the
  outputs with respect to every parameter (1e-4 of the leaf's scale).
* ``build_network`` builds each name of JAX's registries from the shipped
  yaml cut to ``SCALE_SETS``, a JAX tree of the same build loads with no
  unmapped key, and ``grads_to_jax_tree`` maps it back leaf for leaf.
* The slice as a whole at ``__graft_entry__._TINY``'s scale, f32 on both
  sides (``jax_slice_f32``): a VoxelRCNN with VoxelBackBone8x, ConvGRU over
  the current frame and one history frame ``points_prev1`` (through
  ``_bev_single``; a history that ends early: tests/test_torch_port_align.py)
  and PartWraper through one ``predict`` and one ``loss_step`` against JAX
  (CenterPoint's: tests/test_torch_port_centerpoint.py). The port's
  proposals are the JAX forward's own (constants to the second stage in
  both packages), so the continuous parts are held tightly: the loss and
  every tb entry within 1e-4 relative, every gradient leaf within 1e-3 of
  its scale plus 1e-6 of the largest leaf's (the train_modules tier: the
  backward of a batch norm subtracts large sums), the gradients summed over
  each module within 1e-4 relative, the batch statistics after the step
  within 1e-4.
"""
import contextlib
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _TINY
from cpd_tpu.models import backbone3d as jbb
from cpd_tpu.models import bev as jbev
from cpd_tpu.models import centerpoint as jcp
from cpd_tpu.models import detector as jdet
from cpd_tpu.models import part_wraper as jpw
from cpd_tpu.models import roi_head as jroi
from cpd_tpu.models import temporal as jtemp
from cpd_tpu.ops.sparse import INVALID_KEY, GridSpec as JGridSpec
from cpd_tpu_torch.models import bev, build_network, part_wraper, temporal
from cpd_tpu_torch.models.detector import VoxelRCNN, set_compute_dtype
from cpd_tpu_torch.ops.sparse import GridSpec
from cpd_tpu_torch.utils.synthetic import make_tiny_train_batch
from cpd_tpu_torch.utils.weights import grads_to_jax_tree, state_dict_from_jax
from tests import torch_port_refs as refs
from tests.test_torch_port_build_network import (SCALE_SETS, SHIPPED, _F32BEV, _F32Backbone,
                                                 _F32CenterHead, _np, _scaled_close, jax_f32,
                                                 load_pair)
from tests.test_torch_port_models import jax_nms_with_clip_iou, seeded_jax_variables
from tests.test_torch_port_train import _clip_iou3d

TOL = 1e-4
PCR = (-8.0, -8.0, -2.0, 8.0, 8.0, 4.0)
# one conv a BEV block (the yamls' five are tested elsewhere): the JAX side's
# compile is most of this file's time
SLICE_KW = dict(_TINY, mm=False, backbone3d_name="VoxelBackBone8x", temporal_name="ConvGRU",
                num_frames=2, wrap_head_name="PartWraper", with_roi_head=False,
                bev_layer_nums=(1, 1))
PROPOSAL_KEYS = ("rois", "roi_scores", "roi_labels", "roi_valid")
RNGS = ("params", "sampling", "dropout")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread, as in tests/test_torch_port_cli_train.py: beside
    the other test workers, torch's threads wait on busy cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(x):
    return torch.from_numpy(np.array(x))


class _F32Plain(jbb.PlainBranch):
    compute_dtype: Any = None


@contextlib.contextmanager
def jax_slice_f32():
    """The JAX detectors of the slice computing in f32 (``jax_f32`` plus the
    plain branch and CenterPoint's own modules), with the clip-method IoU in
    the NMS, the RoI head and the wrap head's targets (under ``jit`` on
    XLA:CPU the default overlap is wrong for near-identical boxes)."""
    with jax_f32(), jax_nms_with_clip_iou(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(jbb, "PlainBranch", _F32Plain)
        mp.setattr(jcp, "VoxelResBackBone8x", _F32Backbone)
        mp.setattr(jcp, "BaseBEVBackbone", _F32BEV)
        mp.setattr(jcp, "CenterHead", _F32CenterHead)
        mp.setattr(jpw, "boxes_iou3d", _clip_iou3d)
        mp.setattr(jroi, "boxes_iou3d", _clip_iou3d)
        yield


def slice_batch(b=2, history=True, seed=0):
    """``make_tiny_train_batch`` (no proto view) and, with ``history``, one
    earlier frame ``points_prev1`` drawn from the next seed."""
    batch = make_tiny_train_batch(b=b, seed=seed, with_proto=False)
    if history:
        prev = make_tiny_train_batch(b=b, seed=seed + 1, with_proto=False)
        batch["points_prev1"], batch["points_prev1_valid"] = prev["points"], prev["points_valid"]
    return batch


def slice_pair(jcls, pcls, kw, batch, port_kw=None, seed=0):
    """(JAX model, seeded JAX variables as numpy, port model with the same
    weights at f32) for constructor kwargs ``kw``; build and run the JAX
    model under ``jax_slice_f32``."""
    jm = jcls(**kw)
    rngs = {k: jax.random.PRNGKey(i) for i, k in enumerate(RNGS)}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    shapes = jax.eval_shape(lambda: jm.init(rngs, jbatch, True))
    variables = seeded_jax_variables(shapes, seed)
    pm = pcls(**dict(kw, **(port_kw or {})))
    pm.load_state_dict(state_dict_from_jax(variables, pm), strict=True)
    return jm, variables, set_compute_dtype(pm.eval(), None)


def jax_forward(jm, variables, batch, keep):
    """The JAX model's eval forward (jitted), the entries ``keep`` of it."""
    jv = jax.tree_util.tree_map(jnp.asarray, variables)
    out = jax.jit(lambda v, b: jm.apply(v, b, False))(
        jv, {k: jnp.asarray(v) for k, v in batch.items()})
    return jax.device_get({k: out[k] for k in keep})


def jax_loss_step(jm, variables, batch, cur_it=1500.0):
    """One JAX training step's loss, tb, parameter gradients, new batch
    statistics and (VoxelRCNN) the forward's proposals, jitted."""
    jv = jax.tree_util.tree_map(jnp.asarray, variables)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jbatch["cur_it"] = jnp.asarray(cur_it, jnp.float32)

    def jstep(m, b):
        if isinstance(m, jcp.CenterPoint):
            return m.loss_step(b), {}
        out = m(b, train=True)
        props = {k: out[k] for k in PROPOSAL_KEYS}
        return m.compute_loss(out, b), props

    def loss_fn(params):
        ((loss, tb), props), mut = jm.apply(
            {"params": params, "batch_stats": jv["batch_stats"]}, jbatch, method=jstep,
            mutable=["batch_stats"],
            rngs={"sampling": jax.random.PRNGKey(3), "dropout": jax.random.PRNGKey(4)})
        return loss, (tb, mut["batch_stats"], props)

    grads, (tb, stats, props) = jax.jit(jax.grad(loss_fn, has_aux=True))(jv["params"])
    return jax.device_get((grads, tb, stats, props))


def port_loss_step(pm, batch, proposals, cur_it=1500.0):
    """The port's loss_step and backward on ``batch`` with the dense head's
    proposals replaced by ``proposals`` (none for CenterPoint). A parameter
    that no loss term reads gets a zero gradient, as JAX's is; their names
    come back as the third value."""
    pbatch = {k: _t(v) for k, v in batch.items()}
    pbatch["cur_it"] = cur_it
    pm.train()
    with pytest.MonkeyPatch.context() as mp:
        if proposals:
            props = {k: _t(v) for k, v in proposals.items()}
            mp.setattr(pm.dense_head, "generate_predicted_boxes", lambda *a, **kw: props)
        total, tb = pm.loss_step(pbatch)
    total.backward()
    no_grad = sorted(k for k, p in pm.named_parameters() if p.grad is None)
    for p in pm.parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    return total, tb, no_grad


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _leaves(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v, np.float32)


def check_loss_step(pm, variables, ptotal, ptb, jgrads, jtb, jstats):
    """The loss and tb (1e-4 relative), every gradient leaf (1e-3 of its scale
    plus 1e-6 of the largest leaf's), each module's summed gradient (1e-4
    relative to the sum of its absolute values) and the batch statistics
    after the step (1e-4 of each leaf's scale) against the JAX step."""
    assert set(ptb) == set(jtb)
    for k in jtb:
        ref, port = float(jtb[k]), float(ptb[k].detach())
        assert np.isfinite(port) and abs(port - ref) <= TOL * max(abs(ref), 1e-6), (k, port, ref)
    assert abs(float(ptotal.detach()) - float(jtb["total_loss"])) <= TOL * abs(float(
        jtb["total_loss"]))
    pgrads = dict(_leaves(grads_to_jax_tree(pm, variables["params"])))
    jleaves = dict(_leaves(jgrads))
    assert set(pgrads) == set(jleaves)
    floor = 1e-6 * max(float(np.abs(j).max()) for j in jleaves.values())
    bad = []
    for name, j in jleaves.items():
        err = float(np.abs(pgrads[name] - j).max())
        if err > 1e-3 * float(np.abs(j).max()) + floor:
            bad.append(f"{name}: err {err} at scale {float(np.abs(j).max())}")
    assert not bad, "\n".join(bad)
    for module in {n.split("/")[0] for n in jleaves}:
        names = [n for n in jleaves if n.startswith(module + "/")]
        p = sum(float(pgrads[n].astype(np.float64).sum()) for n in names)
        j = sum(float(jleaves[n].astype(np.float64).sum()) for n in names)
        size = sum(float(np.abs(jleaves[n]).astype(np.float64).sum()) for n in names)
        assert abs(p - j) <= TOL * max(size, 1e-12), (module, p, j, size)
    moved = state_dict_from_jax({"params": variables["params"],
                                 "batch_stats": jax.tree_util.tree_map(np.asarray, jstats)}, pm)
    state = pm.state_dict()
    stats = [k for k in moved if k.endswith(("running_mean", "running_var"))]
    assert stats
    for key in stats:
        scale = max(float(moved[key].abs().max()), 1e-3)
        assert float((state[key] - moved[key]).abs().max()) <= TOL * scale, key


# ---- modules alone ---------------------------------------------------------


def test_box_part_points_and_bilinear_sample_match():
    """The 4 x 7 part grid of rotated boxes, and bilinear reads of a map at
    points inside it and off its edges (clamped corners)."""
    rng = np.random.default_rng(0)
    boxes = np.concatenate([rng.uniform(-6, 6, (2, 5, 3)), rng.uniform(0.5, 4, (2, 5, 3)),
                            rng.uniform(-np.pi, np.pi, (2, 5, 1))], -1).astype(np.float32)
    jpts = np.stack([np.asarray(jpw.box_part_points(jnp.asarray(b))) for b in boxes])
    ppts = part_wraper.box_part_points(_t(boxes)).numpy()
    np.testing.assert_allclose(ppts, jpts, rtol=TOL, atol=TOL * 8)
    fmap = rng.normal(size=(2, 6, 7, 3)).astype(np.float32)
    xy = rng.uniform(-12, 12, (2, 40, 2)).astype(np.float32)  # some off the +-8 m map
    ref = np.stack([np.asarray(jpw.bilinear_sample_bev(jnp.asarray(f), jnp.asarray(p), PCR, 2.4))
                    for f, p in zip(fmap, xy)])
    got = part_wraper.bilinear_sample_bev(_t(fmap), _t(xy), PCR, 2.4).numpy()
    _scaled_close(got, ref, "bilinear_sample_bev")


def _random_boxes(rng, b, n):
    return np.concatenate([rng.uniform(-6, 6, (b, n, 2)), rng.uniform(-1, 1, (b, n, 1)),
                           rng.uniform(1.0, 4.0, (b, n, 3)),
                           rng.uniform(-np.pi, np.pi, (b, n, 1))], -1).astype(np.float32)


def test_part_wraper_forward_loss_and_gradients_match():
    """PartWraper on (2, 4, 4, 16) features and 12 boxes a sample: the part
    confidences and the confidence map, the focal loss against labels of
    which some sit on boxes (IoU > 0.7) and its gradients with respect to
    the conv's weight and bias, the features and the boxes."""
    rng = np.random.default_rng(1)
    feats = rng.normal(size=(2, 4, 4, 16)).astype(np.float32)
    boxes = _random_boxes(rng, 2, 12)
    valid = rng.random((2, 12)) < 0.8
    gt = np.zeros((2, 6, 8), np.float32)
    gt[:, :4, :7] = boxes[:, :4] * np.float32(1.02)
    gt[:, 4:, :7] = _random_boxes(rng, 2, 2)
    gv = np.ones((2, 6), bool)
    gv[1, 5] = False
    jm = jpw.PartWraper(point_cloud_range=PCR, voxel_size=(0.5, 0.5, 0.15))
    variables = seeded_jax_variables(jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.asarray(feats), jnp.asarray(boxes), jnp.asarray(valid))), 0)
    pm = part_wraper.PartWraper(16, PCR, voxel_size=(0.5, 0.5, 0.15))
    pm.load_state_dict(state_dict_from_jax(variables, pm), strict=True)

    def jfn(params, f, bx):
        conf, cmap = jm.apply({"params": params}, f, bx, jnp.asarray(valid))
        loss = jm.get_loss(conf, bx, jnp.asarray(valid), jnp.asarray(gt), jnp.asarray(gv))
        return loss, (conf, cmap)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpw, "boxes_iou3d", _clip_iou3d)
        (jloss, (jconf, jmap)), jg = jax.jit(jax.value_and_grad(jfn, argnums=(0, 1, 2),
                                                                has_aux=True))(
            jax.tree_util.tree_map(jnp.asarray, variables["params"]), jnp.asarray(feats),
            jnp.asarray(boxes))
    f, bx = _t(feats).requires_grad_(), _t(boxes).requires_grad_()
    conf, cmap = pm(f, bx, _t(valid))
    loss = pm.get_loss(conf, bx, _t(valid), _t(gt), _t(gv))
    loss.backward()
    _scaled_close(conf.detach().numpy(), np.asarray(jconf), "part confidences")
    _scaled_close(cmap.detach().numpy(), np.asarray(jmap), "confidence map")
    assert abs(float(loss.detach()) - float(jloss)) <= TOL * float(jloss)
    assert not np.asarray(conf.detach())[~valid].any()
    pgrads = dict(_leaves(grads_to_jax_tree(pm, variables["params"])))
    for name, j in _leaves(jax.device_get(jg[0])):
        _scaled_close(pgrads[name], j, name)
    _scaled_close(f.grad.numpy(), np.asarray(jg[1]), "d loss / d features")
    _scaled_close(bx.grad.numpy(), np.asarray(jg[2]), "d loss / d boxes")


def _sparse_bev_input(rng):
    grid = (6, 5, 4)  # nx, ny, nz
    keys = np.full((2, 40), INVALID_KEY, np.int32)
    for b in range(2):
        n = 30 + 5 * b
        keys[b, :n] = np.sort(rng.choice(6 * 5 * 4, n, replace=False))
    feats = rng.normal(size=(2, 40, 3)).astype(np.float32)
    feats[keys == INVALID_KEY] = 0.0
    return grid, feats, keys


@pytest.mark.parametrize("pool", ["max", "mean"])
def test_bev_pool_matches(pool):
    grid, feats, keys = _sparse_bev_input(np.random.default_rng(2))
    ref = jbev.bev_pool(jnp.asarray(feats), jnp.asarray(keys), JGridSpec(*grid), pool)
    got = bev.bev_pool(_t(feats), _t(keys), GridSpec(*grid), pool)
    _scaled_close(got.numpy(), np.asarray(ref), f"bev_pool {pool}")


class _Param:
    def __init__(self, rot, scale, flip_x, flip_y):
        self.rot, self.scale, self.flip_x, self.flip_y = rot, scale, flip_x, flip_y


@pytest.mark.parametrize("fusion", ["first", "max", "mean"])
def test_bev_align_matches(fusion):
    """``bev_align`` on three stages (one untransformed), host-side params."""
    rng = np.random.default_rng(3)
    maps = [rng.normal(size=(2, 5, 5, 4)).astype(np.float32) for _ in range(3)]
    params = [None, _Param(0.3, 1.04, True, False), _Param(-0.5, 0.96, False, True)]
    ref = jbev.bev_align([jnp.asarray(m) for m in maps], params, PCR, 3.2, fusion)
    got = bev.bev_align([_t(m) for m in maps], params, PCR, 3.2, fusion)
    _scaled_close(got.numpy(), np.asarray(ref), f"bev_align {fusion}")


@pytest.mark.parametrize("fusion", ["first", "max", "mean"])
def test_bev_align_params_matches(fusion):
    """``bev_align_params`` on three stages with per-sample rows: forward
    through stage i's rotation, flip and scaling, backward through stage
    0's; stage 0's bf16 map is kept as it is."""
    rng = np.random.default_rng(4)
    maps = [rng.normal(size=(2, 5, 5, 4)).astype(np.float32) for _ in range(3)]
    rows = np.stack([rng.uniform(-0.7, 0.7, (2, 3)), rng.integers(0, 2, (2, 3)),
                     rng.uniform(0.95, 1.05, (2, 3))], -1).astype(np.float32)
    ref = jbev.bev_align_params([jnp.asarray(m) for m in maps], jnp.asarray(rows), PCR, 3.2,
                                fusion=fusion)
    got = bev.bev_align_params([_t(m) for m in maps], _t(rows), PCR, 3.2, fusion=fusion)
    _scaled_close(got.numpy(), np.asarray(ref), f"bev_align_params {fusion}")


@pytest.mark.parametrize("name,channels", [("TemporalConcatenation", 12), ("ConvGRU", 12),
                                           ("ConvGRU", 8), ("ConvLSTM", 12), ("ConvLSTM", 8)])
def test_temporal_model_matches(name, channels):
    """Each temporal model on a (2, 3, 5, 6, C) history, C = 12 (an
    ``in_proj`` to the hidden width 8) or 8 (none): the fused map and the
    gradients of a random linear functional of it, f32."""
    rng = np.random.default_rng(5)
    seq = rng.normal(size=(2, 3, 5, 6, channels)).astype(np.float32)
    jm = (jtemp.TemporalConcatenation(out_channels=8) if name == "TemporalConcatenation"
          else getattr(jtemp, name)(hidden=8))
    pm = (temporal.TemporalConcatenation(channels, 3, 8) if name == "TemporalConcatenation"
          else getattr(temporal, name)(channels, 8))
    variables = seeded_jax_variables(jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.asarray(seq))), 0)
    # the bridge maps the temporal models by their path in the detector
    holder = torch.nn.Module()
    holder.temporal = pm
    held = {"params": {"temporal": variables["params"]}}
    holder.load_state_dict(state_dict_from_jax(held, holder), strict=True)
    assert hasattr(pm, "in_proj") == (name != "TemporalConcatenation" and channels != 8)
    cot = rng.normal(size=(2, 5, 6, 8)).astype(np.float32)
    jout = jm.apply(jax.tree_util.tree_map(jnp.asarray, variables), jnp.asarray(seq))
    jg = jax.grad(lambda p: jnp.sum(jm.apply({"params": p}, jnp.asarray(seq)) * cot))(
        jax.tree_util.tree_map(jnp.asarray, variables["params"]))
    out = pm(_t(seq))
    (out * _t(cot)).sum().backward()
    _scaled_close(out.detach().numpy(), np.asarray(jout), name)
    pgrads = dict(_leaves(grads_to_jax_tree(holder, held["params"])))
    for leaf, j in _leaves({"temporal": jax.device_get(jg)}):
        _scaled_close(pgrads[leaf], j, leaf)


# ---- build_network over the registry ---------------------------------------

# the build cases leave out the RoI head and the MM branch (their trees are
# held in tests/test_torch_port_build_network.py), but VoxelBackBone8x's case
# keeps MM, whose second branch has its own conv_out
LEAN_SETS = ["MODEL.ROI_HEAD", "None", "MODEL.BACKBONE_3D.MM", "False"]
# per case: the --set lines over SHIPPED + SCALE_SETS (+ LEAN_SETS), and what the port model holds
REGISTRY_CASES = {
    "VoxelBackBone8x": (["MODEL.BACKBONE_3D.NAME", "VoxelBackBone8x"],
                        ("backbone.branch1.conv_out.weight", (3, 128, 128))),
    "CenterPoint": (["MODEL.NAME", "CenterPoint"], ("dense_head.shared_conv.weight",
                                                    (64, 512, 3, 3))),
    "ConvGRU": (["MODEL.TEMPORAL_MODEL", "{'NAME': 'ConvGRU'}"],
                ("temporal.cell.gates.weight", (512, 512, 3, 3))),
    "ConvLSTM": (["MODEL.TEMPORAL_MODEL", "{'NAME': 'ConvLSTM', 'NUM_TEMPORAL_FEATURES': 128}",
                  "DATA_CONFIG.NUM_FRAMES", "2"],
                 ("temporal.cell.gates.weight", (512, 256, 3, 3))),
    "TemporalConcatenation": (["MODEL.TEMPORAL_MODEL", "{'NAME': 'TemporalConcatenation'}",
                               "DATA_CONFIG.NUM_FRAMES", "2"],
                              ("temporal.fuse.weight", (256, 512, 1, 1))),
    "VoxelSetAbstraction": (["MODEL.PFE", "{'NAME': 'VoxelSetAbstraction', "
                                          "'NUM_KEYPOINTS': 256, 'NSAMPLE': 8}"],
                            ("pfe.mlp_x_conv4.0.weight", (32, 35))),
    "PartWraper": (["MODEL.WRAP_HEAD", "{'NAME': 'PartWraper'}"],
                   ("wrap_head.conf_conv.weight", (1, 512, 3, 3))),
}


def _shapes_with_history(jm, num_frames):
    """``jax_shapes`` with the history frames that ``num_frames`` asks for in
    the init batch (TemporalConcatenation's fuse conv takes its width from
    the frames it is initialised on)."""
    rng = np.random.default_rng(0)
    batch = {}
    for i in range(num_frames):
        pts = np.concatenate([rng.uniform(-8, 8, (1, 256, 2)), rng.uniform(-2, 4, (1, 256, 1)),
                              rng.uniform(0, 1, (1, 256, 2))], -1).astype(np.float32)
        key = "points" if i == 0 else f"points_prev{i}"
        batch[key], batch[key + "_valid"] = jnp.asarray(pts), jnp.ones((1, 256), bool)
    gt = np.zeros((1, 2, 8), np.float32)
    gt[..., 3:6], gt[..., 7] = 2.0, 1.0
    batch.update(gt_boxes=jnp.asarray(gt), gt_valid=jnp.ones((1, 2), bool))
    rngs = {k: jax.random.PRNGKey(i) for i, k in enumerate(RNGS)}
    return jax.eval_shape(lambda: jm.init(rngs, batch, True))


@pytest.mark.parametrize("name", sorted(REGISTRY_CASES))
def test_build_network_builds_the_registry_name_and_loads_its_jax_tree(name):
    """Both packages' ``build_network`` build the name; the JAX tree of a
    training init loads into the port key for key (every leaf used, every
    shape equal), and ``grads_to_jax_tree`` gives back that very tree from
    gradients set to it."""
    sets, (key, shape) = REGISTRY_CASES[name]
    lean = [] if name == "VoxelBackBone8x" else LEAN_SETS
    port_cfg, jax_cfg = load_pair(SHIPPED, SCALE_SETS + lean + sets)
    jm = jdet.build_network(jax_cfg.MODEL, len(jax_cfg.CLASS_NAMES), jax_cfg.DATA_CONFIG)
    pm = build_network(port_cfg.MODEL, len(port_cfg.CLASS_NAMES), port_cfg.DATA_CONFIG)
    assert type(pm).__name__ == type(jm).__name__
    variables = seeded_jax_variables(_shapes_with_history(jm, int(jax_cfg.DATA_CONFIG.get(
        "NUM_FRAMES", 1))), 0)
    sd = state_dict_from_jax(variables, pm)  # raises on any unmapped or missing key
    pm.load_state_dict(sd, strict=True)
    assert tuple(sd[key].shape) == shape
    named = dict(pm.named_parameters())
    for k, p in named.items():
        p.grad = sd[k].clone()
    back = dict(_leaves(grads_to_jax_tree(pm, variables["params"])))
    want = dict(_leaves(variables["params"]))
    assert set(back) == set(want) and len(back) == len(named)
    for leaf, arr in want.items():
        np.testing.assert_array_equal(back[leaf], arr, err_msg=leaf)


def test_unknown_registry_names_raise_as_in_jax():
    with pytest.raises(KeyError, match="unknown TEMPORAL_MODEL.NAME 'ConvRNN'"):
        VoxelRCNN(temporal_name="ConvRNN")
    port_cfg, _ = load_pair(SHIPPED)
    port_cfg.MODEL.NAME = "PVRCNN"
    with pytest.raises(KeyError, match="unknown MODEL.NAME 'PVRCNN'"):
        build_network(port_cfg.MODEL, 3, port_cfg.DATA_CONFIG)


# ---- the slice as a whole --------------------------------------------------


def jax_predict(jm, variables, batch, keep):
    """The JAX model's eval forward (the entries ``keep``) and its
    post-processing of that forward, both jitted: a slice's reference."""
    jout = jax_forward(jm, variables, batch, keep)
    jv = jax.tree_util.tree_map(jnp.asarray, variables)
    jpred = jax.device_get(jax.jit(lambda v, o: jm.apply(
        v, o, method=type(jm).post_processing))(jv, jout))
    return {"out": jout, "pred": dict(jpred)}


VOXEL_SLICE_KEEP = PROPOSAL_KEYS + ("wrap_conf", "wrap_boxes")


@pytest.fixture(scope="module")
def voxel_slice():
    """VoxelBackBone8x + ConvGRU over one history frame + PartWraper, f32:
    the JAX side's eval forward is the committed reference
    ``registry_voxel_slice``; its training step runs here, once."""
    batch = slice_batch()
    ref = refs.load("registry_voxel_slice")
    with jax_slice_f32():
        jm, variables, pm = slice_pair(jdet.VoxelRCNN, VoxelRCNN, SLICE_KW, batch)
        step = jax_loss_step(jm, variables, batch)
    return jm, variables, pm, batch, ref["out"], ref["pred"], step


@pytest.mark.slow
def test_registry_voxel_slice_reference_is_regenerated():
    batch = slice_batch()
    with jax_slice_f32():
        jm, variables, _ = slice_pair(jdet.VoxelRCNN, VoxelRCNN, SLICE_KW, batch)
        live = jax_predict(jm, variables, batch, VOXEL_SLICE_KEEP)
    refs.assert_regenerated("registry_voxel_slice", live)


def test_voxel_slice_predict_matches(voxel_slice):
    """predict: the proposals (validity and labels exact, boxes and scores
    within 1e-4 of their scale); on those proposals the wrap head's part
    confidences, which replace the scores, and the final NMS."""
    _, _, pm, batch, jout, jpred, _ = voxel_slice
    assert isinstance(pm.backbone.branch0.conv_out.weight, torch.nn.Parameter)
    pbatch = {k: _t(v) for k, v in batch.items()}
    with torch.no_grad():
        pout = pm(pbatch)
    p = _np({k: pout[k] for k in PROPOSAL_KEYS})
    for k in ("roi_valid", "roi_labels"):
        np.testing.assert_array_equal(p[k], np.asarray(jout[k], np.float32))
    assert p["roi_valid"].sum() >= 6
    for k in ("rois", "roi_scores"):
        _scaled_close(p[k], np.asarray(jout[k], np.float32), k)
    props = {k: _t(jout[k]) for k in PROPOSAL_KEYS}
    with pytest.MonkeyPatch.context() as mp, torch.no_grad():
        mp.setattr(pm.dense_head, "generate_predicted_boxes", lambda *a, **kw: props)
        pred = pm.predict(pbatch)
        handed = pm(pbatch)
    _scaled_close(handed["wrap_conf"].numpy(), np.asarray(jout["wrap_conf"]), "wrap_conf")
    port, ref = _np(pred), _np(jpred)
    for k in ("pred_valid", "pred_labels"):
        np.testing.assert_array_equal(port[k], ref[k])
    assert port["pred_valid"].sum() > 5
    for k in ("pred_boxes", "pred_scores"):
        _scaled_close(port[k], ref[k], k)


def test_voxel_slice_loss_step_matches(voxel_slice):
    """loss_step on the JAX forward's proposals: the dense-head and wrap
    losses, the gradients (VoxelBackBone8x over both frames, ConvGRU's cell,
    the BEV stack, the heads) and the batch statistics, which the history
    frame's pass updates first, as in JAX."""
    jm, variables, pm, batch, _, _, (jgrads, jtb, jstats, jprops) = voxel_slice
    assert float(jtb["wrap_loss"]) > 0
    ptotal, ptb, no_grad = port_loss_step(pm, batch, jprops)
    assert not no_grad
    check_loss_step(pm, variables, ptotal, ptb, jgrads, jtb, jstats)
