"""The training step of the PyTorch port against the JAX package, the slice
as a whole: ``VoxelRCNN.loss_step`` of both packages at
  ``__graft_entry__._TINY`` with ``mm=True``, batch 2, the same seeded
  weights through the bridge, the same injected sampling uniforms, dropout
  off. The JAX model has no dtype switch and runs bf16, so the port runs its
  bf16 default too, and the comparison is in a bf16 tier that the tests
  state where they apply it. The RoI head is discontinuous in its
  proposals (IoU thresholds in the sampling, voxel queries at the RoI grid
  points), and at the tiny configuration's 4 m BEV pixels bf16 noise moves
  a proposal by decimetres. So the port's second stage is fed the JAX
  side's own proposals (constants to the second stage in both packages);
  everything else, the RoI sampling included, is the port's.

Every test here reads the one JAX training step of ``step_pair``. The
trainer's parts (optimizer, schedules, the non-finite guard) are in
``test_torch_port_trainer.py``; the detector's wiring, which needs the port
model and batch but no JAX step, in ``test_torch_port_train_wiring.py``.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _TINY
from cpd_tpu.models import roi_head as jroi
from cpd_tpu.models.detector import VoxelRCNN as JVoxelRCNN
from cpd_tpu.ops import iou3d as jiou
from cpd_tpu_torch.models.detector import VoxelRCNN
from cpd_tpu_torch.utils.synthetic import make_tiny_train_batch
from cpd_tpu_torch.utils.weights import grads_to_jax_tree, state_dict_from_jax
from tests.test_torch_port_losses import injected_sampling_uniforms, port_uniforms
from tests.test_torch_port_models import jax_nms_with_clip_iou, seeded_jax_variables

CUR_IT = 1500.0
KW = dict(_TINY, mm=True, roi_head_cfg={"dp_ratio": 0.0})


def _t(x):
    return torch.from_numpy(np.array(x))


def _clip_iou3d(boxes_a, boxes_b):
    """``iou3d.boxes_iou3d`` on the JAX package's clip-method BEV overlap: under
    ``jit`` on XLA:CPU the default candidate-hull overlap is wrong for
    near-identical boxes (see ``jax_nms_with_clip_iou``)."""
    overlap_bev = jiou.boxes_overlap_bev(boxes_a, boxes_b, method="clip")
    zmax = jnp.minimum((boxes_a[:, 2] + boxes_a[:, 5] / 2)[:, None],
                       (boxes_b[:, 2] + boxes_b[:, 5] / 2)[None, :])
    zmin = jnp.maximum((boxes_a[:, 2] - boxes_a[:, 5] / 2)[:, None],
                       (boxes_b[:, 2] - boxes_b[:, 5] / 2)[None, :])
    overlap = overlap_bev * jnp.clip(zmax - zmin, min=0.0)
    vol_a = (boxes_a[:, 3] * boxes_a[:, 4] * boxes_a[:, 5])[:, None]
    vol_b = (boxes_b[:, 3] * boxes_b[:, 4] * boxes_b[:, 5])[None, :]
    return overlap / jnp.clip(vol_a + vol_b - overlap, min=1e-6)


def _labels_on_proposals(pm, batch, rng):
    """Labels that some proposals match: the port's own training-mode
    proposals, every second one shifted by 3% of its size and made 5% larger
    or smaller, as gt boxes of the proposal's class. No label is left
    exactly on its proposal: the dense head's L1 terms would sit on their
    kink, where the sign of the gradient is rounding noise."""
    pm.train()
    with torch.no_grad():
        out = pm({k: _t(v) for k, v in batch.items()},
                 sampling_uniforms=port_uniforms(np.zeros((2, 6, KW["num_rois"]), np.float32)))
    n_gt = batch["gt_boxes"].shape[1]
    gt = np.zeros_like(batch["gt_boxes"])
    valid = np.zeros_like(batch["gt_valid"])
    for b in range(gt.shape[0]):
        keep = np.nonzero(out["roi_valid"][b].numpy())[0][::2][:n_gt]
        rois = out["rois"][b].numpy()[keep]
        gt[b, :len(keep), :7] = rois
        gt[b, :len(keep), 0:3] += 0.03 * rois[:, 3:6] * rng.choice([-1.0, 1.0], (len(keep), 3))
        gt[b, :len(keep), 3:6] *= 1.0 + 0.05 * np.where(np.arange(len(keep) * 3) % 2, 1.0, -1.0
                                                        ).reshape(-1, 3)
        gt[b, :len(keep), 7] = out["roi_labels"][b].numpy()[keep]
        valid[b, :len(keep)] = True
    return gt, valid


def _well_conditioned(variables):
    """Seeded weights whose proposals the two frameworks agree on closely
    enough for IoU matching. A BEV pixel of the tiny configuration is 4 m
    wide, so the bf16 noise of a pixel-unit centre offset is tens of
    centimetres, on boxes half a metre long: RoI-to-label IoUs (and with them
    every RoI target) would differ at random. The centre head's output layer
    is scaled by 0.1 (offsets and their noise shrink alike) and the size
    head's bias raised by 1 (boxes of 1.5 to 4 m)."""
    heads = variables["params"]["dense_head"]
    heads["head_center"]["out"]["kernel"] *= 0.1
    heads["head_center"]["out"]["bias"] *= 0.1
    heads["head_dim"]["out"]["bias"] += 1.0
    return variables


@pytest.fixture(scope="module")
def step_pair():
    return run_step_pair()


def port_setup():
    """What both packages' step starts from, with no JAX step run: the JAX
    model, its seeded (well-conditioned) tree, the port model loaded from it
    through the bridge, the batch with labels placed on the port's own
    proposals (numpy and as port tensors, ``cur_it`` set) and the table of
    sampling uniforms."""
    rng = np.random.default_rng(0)
    batch = make_tiny_train_batch(b=2, with_proto=True)
    jm = JVoxelRCNN(**KW)
    rngs = {"params": jax.random.PRNGKey(0), "sampling": jax.random.PRNGKey(1),
            "dropout": jax.random.PRNGKey(2)}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    shapes = jax.eval_shape(lambda: jm.init(rngs, jbatch, True))
    variables = _well_conditioned(seeded_jax_variables(shapes, 0))
    pm = VoxelRCNN(**KW)
    state_dict = state_dict_from_jax(variables, pm)
    pm.load_state_dict(state_dict, strict=True)
    batch["gt_boxes"], batch["gt_valid"] = _labels_on_proposals(pm, batch, rng)
    pm.load_state_dict(state_dict, strict=True)  # the running statistics moved
    table = rng.random((2, 6, KW["num_rois"])).astype(np.float32)
    pbatch = {k: _t(v) for k, v in batch.items()}
    pbatch["cur_it"] = CUR_IT
    return jm, variables, pm, batch, pbatch, table


def run_step_pair():
    """One training step's loss, tb and gradients from both packages."""
    jm, variables, pm, batch, pbatch, table = port_setup()

    # the JAX package: loss_step's two lines (forward, compute_loss) under jit,
    # with the proposals of that very forward handed out beside the loss
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jbatch["cur_it"] = jnp.asarray(CUR_IT, jnp.float32)
    jv = jax.tree_util.tree_map(jnp.asarray, variables)

    def jstep(m, b):
        out = m(b, train=True)
        proposals = m.dense_head.generate_predicted_boxes(
            out["head_preds"], k=500, score_thresh=0.0,
            nms_cfg=dict(m.rpn_nms, NMS_POST_MAXSIZE=m.num_rois), post_max_size=m.num_rois)
        heads = {k: v for k, v in out.items() if k != "backbone_out"}
        return m.compute_loss(out, b), dict(proposals, forward=heads)

    def loss_fn(params):
        ((loss, tb), proposals), mut = jm.apply(
            {"params": params, "batch_stats": jv["batch_stats"]}, jbatch, method=jstep,
            mutable=["batch_stats"],
            rngs={"sampling": jax.random.PRNGKey(3), "dropout": jax.random.PRNGKey(4)})
        return loss, (tb, mut["batch_stats"], proposals)

    with jax_nms_with_clip_iou(), injected_sampling_uniforms(table), \
            pytest.MonkeyPatch.context() as mp:
        mp.setattr(jroi, "boxes_iou3d", _clip_iou3d)
        jgrads, (jtb, jstats, jproposals) = jax.jit(jax.grad(loss_fn, has_aux=True))(
            jv["params"])
    jgrads = jax.tree_util.tree_map(np.asarray, jgrads)
    jforward = jax.tree_util.tree_map(np.asarray, jproposals.pop("forward"))

    # the port: one loss_step and backward, on the JAX side's proposals
    proposals = {k: _t(v) for k, v in jproposals.items()}
    pm.train()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pm.dense_head, "generate_predicted_boxes", lambda *a, **kw: proposals)
        ptotal, ptb = pm.loss_step(pbatch, sampling_uniforms=port_uniforms(table))
    ptotal.backward()
    return pm, ptb, variables, jtb, jgrads, jstats, (jm, jv, jbatch, jforward, pbatch)


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _leaves(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v, np.float32)


# Parameters whose gradient comes through the BEV stack alone. At the tiny
# configuration the BEV maps are 4 x 4 (2 x 2 after the stride): a dozen batch
# norms in a row take their statistics from 32 or 8 values a channel, and
# that chain amplifies the bf16 noise of its input many times over, in the
# values (head maps differ by 10-20% of their scale between the frameworks
# in training mode, against 3% in eval mode) and more so in the gradients.
# These modules' training mode is held to the JAX package at f32 in
# tests/test_torch_port_train_modules.py; here they get the loose tier.
BEV_ONLY = ("bev_backbone/", "dense_head/", "backbone/branch0/conv_out/")
# per gradient leaf: (least cosine, least norm ratio; its inverse is the most)
GRADIENT_TIERS = ((BEV_ONLY, (0.3, 0.5)), (("backbone/branch0/",), (0.7, 0.67)),
                  (("",), (0.85, 0.8)))


def test_loss_step_tb_matches_bf16(step_pair):
    """Every entry of tb. bf16 tier: a loss is a mean over maps or rois of
    values computed from bf16 activations; the RoI-head terms and the total
    agree to 3% of their value, the dense-head terms (behind the
    ill-conditioned BEV stack, see ``BEV_ONLY``) to 10%."""
    _, ptb, _, jtb, _, _, _ = step_pair
    assert set(ptb) == set(jtb)
    assert {"hm_loss", "loc_loss", "rcnn_cls0", "rcnn_reg0", "rcnn_cls1", "rcnn_reg1",
            "proto_loss", "rpn_loss", "total_loss"} == set(ptb)
    for k in jtb:
        p, j = float(ptb[k].detach()), float(jtb[k])
        assert math.isfinite(p) and math.isfinite(j), k
        tier = 0.10 if k in ("hm_loss", "loc_loss", "rpn_loss") else 0.03
        assert abs(p - j) <= tier * abs(j) + 2e-3, f"{k}: port {p} vs jax {j}"
    # the labels sit on proposals, so the regression and proto terms are live
    assert float(jtb["rcnn_reg0"]) > 1e-2 and abs(float(jtb["proto_loss"])) > 1e-3


def test_loss_step_gradients_match_leaf_by_leaf_bf16(step_pair):
    """Every gradient leaf through ``grads_to_jax_tree``: finite, of the JAX
    leaf's shape, pointing the JAX leaf's way and of its size. bf16 tier
    (``GRADIENT_TIERS``), by the cosine between the two leaves and the ratio
    of their norms: at least 0.85 and within 0.8 to 1.25 for the RoI head and
    the MM branch; 0.7 and within 0.67 to 1.5 for branch 0 (its gradient is
    the sum of the RoI path's and the BEV path's); 0.3 and within 0.5 to 2
    for each ``BEV_ONLY`` leaf, 0.4 and within 0.8 to 1.25 for all of them
    as one vector. There the head maps of the two
    frameworks differ by more than the labels' distance from the
    predictions they were placed on, so some signs of the L1 terms differ
    too, and the batch norms amplify that on the way down (the leaves next
    to the loss read 0.55 to 0.99, the BEV blocks 0.38 to 0.55, all as one
    vector 0.47);
    a wrong gradient would read a cosine near 0. The tight checks of these
    modules are the f32 ones named above and
    ``test_compute_loss_wiring_matches_on_jax_forward_f32``. The dense
    head's conv biases sit in front of a batch norm: their gradient is zero
    in exact arithmetic and rounding noise here, so it is only held finite
    and small. Both branches and both tower sets carry gradients."""
    pm, _, variables, _, jgrads, _, _ = step_pair
    pgrads = dict(_leaves(grads_to_jax_tree(pm, variables["params"])))
    jleaves = dict(_leaves(jgrads))
    assert set(pgrads) == set(jleaves) and len(pgrads) == len(list(pm.parameters()))
    live, bad = [], []
    for name, j in jleaves.items():
        p = pgrads[name]
        assert p.shape == j.shape, name
        assert np.isfinite(p).all() and np.isfinite(j).all(), name
        if name == "dense_head/shared_conv/bias" or name.endswith("/conv0/bias"):
            assert float(np.abs(p).max()) < 0.05 and float(np.abs(j).max()) < 0.05, name
            continue
        if j.size < 4:  # an L1 term's bias gradient is a sum of a few signs: no direction
            continue
        live.append(name)
        cos = float((p * j).sum() / (np.linalg.norm(p) * np.linalg.norm(j)))
        ratio = float(np.linalg.norm(p) / np.linalg.norm(j))
        tier = next(t for prefixes, t in GRADIENT_TIERS if name.startswith(prefixes))
        if not (cos >= tier[0] and tier[1] <= ratio <= 1.0 / tier[1]):
            bad.append(f"{name}: cosine {cos:.4f} (at least {tier[0]}), norm ratio {ratio:.3f} "
                       f"(within {tier[1]} and its inverse)")
    assert not bad, "\n".join(bad)
    # all BEV_ONLY leaves as one vector (7.7 million values, so the cosine of
    # unrelated gradients would be 0 to three places)
    names = [n for n in live if n.startswith(BEV_ONLY)]
    p_all = np.concatenate([pgrads[n].ravel() for n in names]).astype(np.float64)
    j_all = np.concatenate([jleaves[n].ravel() for n in names]).astype(np.float64)
    cos = float(p_all @ j_all / (np.linalg.norm(p_all) * np.linalg.norm(j_all)))
    ratio = float(np.linalg.norm(p_all) / np.linalg.norm(j_all))
    assert cos >= 0.4 and 0.8 <= ratio <= 1.25, f"BEV_ONLY leaves together: {cos}, {ratio}"
    for part in ("backbone/branch0/conv_input", "backbone/branch0/conv_out",
                 "backbone/branch1/conv_input", "backbone/branch1/res4a", "bev_backbone",
                 "dense_head", "roi_head/pool_branch/", "roi_head/pool_branch_mm/",
                 "roi_head/shared0", "roi_head/shared1", "roi_head/cls_tower0",
                 "roi_head/cls_tower1", "roi_head/reg_tower0", "roi_head/reg_tower1"):
        assert [n for n in live if n.startswith(part) and n.endswith("kernel")], \
            f"no live kernel gradient under {part}"


def test_loss_step_running_statistics_match(step_pair):
    """The batch-norm statistics the forward moved, against the JAX step's
    new ``batch_stats`` (bf16 tier: 3% of each leaf's scale; 10% behind the
    BEV stack, see ``BEV_ONLY``)."""
    pm, _, variables, _, _, jstats, _ = step_pair
    moved = state_dict_from_jax({"params": variables["params"],
                                 "batch_stats": jax.tree_util.tree_map(np.asarray, jstats)}, pm)
    state = pm.state_dict()
    old = state_dict_from_jax(variables, pm)
    n = 0
    for key, want in moved.items():
        if not key.endswith(("running_mean", "running_var")):
            continue
        n += 1
        scale = max(float(want.abs().max()), 1e-3)
        tier = 0.10 if key.replace(".", "/").startswith(BEV_ONLY) else 0.03
        assert float((state[key] - want).abs().max()) <= tier * scale, key
        assert not torch.equal(want, old[key]), key
    assert n > 100


LOSS_INPUTS = ("rcnn_cls", "rcnn_reg", "rcnn_cls_proto", "rcnn_reg_proto", "shared_features0")


def _f32_tree(tree, leaf):
    """``tree`` (nested dicts of numpy arrays) with floating leaves as f32
    (the JAX forward hands out bf16 ones), every leaf through ``leaf``."""
    if hasattr(tree, "items"):
        return {k: _f32_tree(v, leaf) for k, v in tree.items()}
    tree = np.asarray(tree)
    return leaf(tree if tree.dtype.kind in "biu" else tree.astype(np.float32))


def test_compute_loss_wiring_matches_on_jax_forward_f32(step_pair):
    """``VoxelRCNN.compute_loss`` of both packages on the SAME forward outputs
    (the JAX step's own head maps, RoI targets and tower outputs), which
    takes the forward's bf16 noise out of the comparison and holds the
    detector-level wiring tightly: the centre targets assigned from the
    batch, the heads' loss weights, the ramp read from ``cur_it``, the sum of
    the two losses. f32 on both sides: the total and every tb entry to 1e-4,
    the gradient with respect to every head map and tower output to 1e-4 of
    its scale."""
    pm, _, _, _, _, _, (jm, jv, jbatch, jforward, pbatch) = step_pair
    jout = _f32_tree(jforward, jnp.asarray)
    pout = _f32_tree(jforward, _t)
    inputs = ("head_preds",) + LOSS_INPUTS

    def jfn(diff):
        return jm.apply(jv, dict(jout, **diff), jbatch, method=JVoxelRCNN.compute_loss)
    (jtotal, jtb), jgrads = jax.value_and_grad(jfn, has_aux=True)({k: jout[k] for k in inputs})

    pleaves = {"head_preds": {k: v.requires_grad_() for k, v in pout["head_preds"].items()}}
    pleaves.update({k: pout[k].requires_grad_() for k in LOSS_INPUTS})
    ptotal, ptb = pm.compute_loss(dict(pout, **pleaves), pbatch)
    ptotal.backward()
    np.testing.assert_allclose(float(ptotal.detach()), float(jtotal), rtol=1e-4)
    assert set(ptb) == set(jtb)
    for k in jtb:
        np.testing.assert_allclose(float(ptb[k].detach()), float(jtb[k]), rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    pairs = [(f"head_preds/{k}", pleaves["head_preds"][k], jgrads["head_preds"][k])
             for k in jgrads["head_preds"]]
    pairs += [(k, pleaves[k], jgrads[k]) for k in LOSS_INPUTS]
    for name, leaf, j in pairs:
        j = np.asarray(j)
        scale = float(np.abs(j).max())
        assert scale > 0, f"{name}: the JAX gradient is zero"
        np.testing.assert_allclose(leaf.grad.numpy(), j, rtol=1e-4, atol=1e-4 * scale,
                                   err_msg=name)
