"""Parity of the PyTorch port's modules (cpd_tpu_torch.models) with the JAX
package, and the weight bridge.

Weights are drawn once, as a JAX variable tree from a numpy seed, and carried
to the port by ``state_dict_from_jax``. The JAX modules run at
``compute_dtype=None`` (f32), where outputs must match to 1e-4, except
GridPoolBranch, whose Dense layers are bf16 in JAX with no switch: it is held
to the bf16 tier below."""
import contextlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpd_tpu.models import backbone3d as jbb
from cpd_tpu.models import bev as jbev
from cpd_tpu.models import center_head as jch
from cpd_tpu.models import norm as jnorm
from cpd_tpu.models import roi_head as jroi
from cpd_tpu.ops.sparse import INVALID_KEY, GridSpec
from cpd_tpu_torch.models import backbone3d, bev, center_head, norm, roi_head
from cpd_tpu_torch.ops import sparse
from cpd_tpu_torch.utils.weights import seeded_state_dict, state_dict_from_jax
from tests.torch_port_refs import one_torch_thread  # noqa: F401

F32 = dict(rtol=1e-4, atol=1e-4)


def bf16_close(port, ref, what=""):
    """bf16 tier: the two frameworks round to bf16 at the same points but sum
    in another order, so an element may differ by a few bf16 ulps (2^-8
    relative each) that later layers carry on: within 3% of the output scale."""
    port = np.asarray(port, np.float32)
    ref = np.asarray(ref, np.float32)
    scale = max(float(np.abs(ref).max()), 1e-3)
    err = float(np.abs(port - ref).max())
    assert err <= 0.03 * scale, f"{what}: max err {err} vs scale {scale}"


def seeded_jax_variables(shapes, seed):
    """A JAX {"params", "batch_stats"} tree of numpy arrays with the spread of
    utils.weights.seeded_state_dict: He-scaled kernels, BN scales in
    [0.9, 1.3], running variances in [0.5, 2], spread biases, and the
    heatmap bias at -2.19 spread by [-0.5, 0.5]."""
    rng = np.random.default_rng(seed)

    def fill(node, path):
        out = {}
        is_bn = "scale" in node or "mean" in node
        for k, v in node.items():
            if hasattr(v, "items"):
                out[k] = fill(v, path + (k,))
                continue
            shape = tuple(v.shape)
            if is_bn:
                lo, hi = {"scale": (0.9, 1.3), "var": (0.5, 2.0)}.get(k, (-0.1, 0.1))
                arr = rng.uniform(lo, hi, shape)
            elif k == "bias":
                arr = rng.uniform(-0.1, 0.1, shape)
                if path[-2:] == ("head_hm", "out"):
                    arr = -2.19 + rng.uniform(-0.5, 0.5, shape)
            elif len(shape) == 3:
                arr = rng.normal(0.0, np.sqrt(2.0 / (shape[0] * shape[1])), shape)
            elif len(shape) == 4:
                transposed = bool(re.fullmatch(r"deblock\d+", path[-1])) and shape[0] > 1
                fan_in = shape[2] if transposed else shape[0] * shape[1] * shape[2]
                arr = rng.normal(0.0, np.sqrt(2.0 / fan_in), shape)
            else:
                arr = rng.normal(0.0, np.sqrt(2.0 / shape[0]), shape)
            out[k] = arr.astype(np.float32)
        return out

    return {col: fill(shapes[col], ()) for col in ("params", "batch_stats") if col in shapes}


def _clip_iou_bev(boxes_a, boxes_b):
    """The JAX package's Sutherland-Hodgman IoU (iou3d method="clip")."""
    from cpd_tpu.ops import iou3d as jiou
    overlap = jiou.boxes_overlap_bev(boxes_a, boxes_b, method="clip")
    union = ((boxes_a[:, 3] * boxes_a[:, 4])[:, None]
             + (boxes_b[:, 3] * boxes_b[:, 4])[None, :] - overlap)
    return overlap / jnp.clip(union, min=1e-6)


@contextlib.contextmanager
def jax_nms_with_clip_iou():
    """Run the JAX NMS on the JAX package's clip-method IoU.

    Under ``jit`` on XLA:CPU the default candidate-hull ``boxes_iou_bev``
    returns 0 for identical boxes (its ``gap == min(gap)`` successor test
    fails on the fused recomputation; eager mode gives 1), so the jitted
    reference keeps the same-pixel duplicates that the heatmap decode emits
    once per class. The clip method gives the eager result under jit."""
    from cpd_tpu.ops import nms as jnms
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnms, "boxes_iou_bev", _clip_iou_bev)
        jax.clear_caches()
        try:
            yield
        finally:
            jax.clear_caches()


def init_pair(jax_module, port_module, *args, seed=0, **kwargs):
    """Seeded JAX variables for ``jax_module`` and the same weights loaded
    into ``port_module`` (strict). Returns the jnp variables."""
    shapes = jax.eval_shape(lambda: jax_module.init(jax.random.PRNGKey(0), *args, **kwargs))
    variables = seeded_jax_variables(shapes, seed)
    port_module.load_state_dict(state_dict_from_jax(variables, port_module), strict=True)
    port_module.eval()
    return jax.tree_util.tree_map(jnp.asarray, variables)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(port, ref, **tol):
    if isinstance(port, torch.Tensor):
        port = port.detach().float().numpy()
    np.testing.assert_allclose(np.asarray(port, np.float32), np.asarray(ref, np.float32),
                               **(tol or F32))


def test_norms_match():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 30, 8)).astype(np.float32)
    valid = rng.random((2, 30)) < 0.7
    jm, pm = jnorm.MaskedBatchNorm(), norm.MaskedBatchNorm(8)
    v = init_pair(jm, pm, jnp.asarray(x), jnp.asarray(valid), False)
    _close(pm(_t(x), _t(valid)), jm.apply(v, jnp.asarray(x), jnp.asarray(valid), False))
    xb = x.reshape(2, 5, 6, 8)
    jm, pm = jnorm.BatchNorm2d(), norm.BatchNorm2d(8)
    v = init_pair(jm, pm, jnp.asarray(xb), False)
    _close(pm(_t(xb).permute(0, 3, 1, 2)).permute(0, 2, 3, 1), jm.apply(v, jnp.asarray(xb), False))


GRID = GridSpec(32, 32, 26)
CAPS = (512, 256, 160, 160)
FILTERS = (4, 8, 16, 32)


def _random_sparse(rng, batch, n, grid=GRID, channels=5):
    keys = np.stack([np.sort(rng.choice(grid.num_cells, n, replace=False)).astype(np.int32)
                     for _ in range(batch)])
    keys[:, -n // 8:] = INVALID_KEY
    feats = rng.standard_normal((batch, n, channels)).astype(np.float32)
    feats[keys == INVALID_KEY] = 0.0
    return feats, keys


@pytest.fixture(scope="module")
def backbone_pair():
    rng = np.random.default_rng(1)
    feats, keys = _random_sparse(rng, 2, 300)
    jm = jbb.VoxelResBackBone8x(grid=GRID, num_filters=FILTERS, caps=CAPS, mm=False,
                                compute_dtype=None)
    pm = backbone3d.VoxelResBackBone8x(sparse.GridSpec(*GRID), 5, FILTERS, CAPS,
                                       compute_dtype=None)
    v = init_pair(jm, pm, jnp.asarray(feats), jnp.asarray(keys), False)
    ref = jm.apply(v, jnp.asarray(feats), jnp.asarray(keys), False)
    with torch.no_grad():
        out = pm(_t(feats), _t(keys))
    return feats, keys, out, ref


def test_branch_rulebooks_match(backbone_pair):
    _, keys, _, _ = backbone_pair
    ref = jbb.build_branch_rulebooks(jnp.asarray(keys), GRID, CAPS)
    out = backbone3d.build_branch_rulebooks(_t(keys), sparse.GridSpec(*GRID), CAPS)
    assert set(out) == set(ref)
    for name in ref:
        found = np.asarray(ref[name].found)
        np.testing.assert_array_equal(out[name].found.numpy(), found, err_msg=name)
        np.testing.assert_array_equal(out[name].idx.numpy()[found],
                                      np.asarray(ref[name].idx)[found], err_msg=name)
        np.testing.assert_array_equal(out[name].out_keys.numpy(),
                                      np.asarray(ref[name].out_keys), err_msg=name)


@pytest.mark.parametrize("stage", ["x_conv1", "x_conv2", "x_conv3", "x_conv4", "encoded"])
def test_backbone_f32_matches(backbone_pair, stage):
    _, _, out, ref = backbone_pair
    f, k, g = out[stage]
    rf, rk, rg = ref[stage]
    assert tuple(g) == tuple(rg)
    np.testing.assert_array_equal(k.numpy(), np.asarray(rk))
    _close(f, rf)
    assert float(np.abs(np.asarray(rf)).max()) > 0.1  # not a trivially zero stage


def test_bev_f32_matches_incl_deconv_flip():
    """The stride-2 deblock is a flax ConvTranspose; the bridge flips its taps
    for torch's conv_transpose2d. A missing flip fails this comparison."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 8, 8, 12)).astype(np.float32)
    kw = dict(layer_nums=(1, 1), layer_strides=(1, 2), num_filters=(8, 16),
              upsample_strides=(1, 2), num_upsample_filters=(16, 16))
    jm = jbev.BaseBEVBackbone(**kw, compute_dtype=None)
    pm = bev.BaseBEVBackbone(12, **kw, compute_dtype=None)
    v = init_pair(jm, pm, jnp.asarray(x), False)
    with torch.no_grad():
        _close(pm(_t(x)), jm.apply(v, jnp.asarray(x), False))


def test_height_compression_matches(backbone_pair):
    _, _, out, ref = backbone_pair
    f, k, g = out["encoded"]
    rf, rk, rg = ref["encoded"]
    _close(bev.height_compression(f, k, g), jbev.height_compression(rf, rk, rg))


def test_center_head_f32_matches():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 8, 8, 32)).astype(np.float32)
    pcr, vs = (-8.0, -8.0, -2.0, 8.0, 8.0, 4.0), (0.25, 0.25, 0.15)
    jm = jch.CenterHead(num_classes=3, voxel_size=vs, point_cloud_range=pcr, compute_dtype=None)
    pm = center_head.CenterHead(32, 3, voxel_size=vs, point_cloud_range=pcr, compute_dtype=None)
    v = init_pair(jm, pm, jnp.asarray(x), False)
    ref = jm.apply(v, jnp.asarray(x), False)
    with torch.no_grad():
        out = pm(_t(x))
    for name in ref:
        _close(out[name], ref[name])
    cfg = {"NMS_THRESH": 0.8, "NMS_PRE_MAXSIZE": 100, "NMS_POST_MAXSIZE": 100}
    with jax_nms_with_clip_iou():
        jp = jm.apply(v, ref, k=120, score_thresh=0.1, nms_cfg=cfg, post_max_size=100,
                      method=jch.CenterHead.generate_predicted_boxes)
    pp = pm.generate_predicted_boxes(out, k=120, score_thresh=0.1, nms_cfg=cfg,
                                     post_max_size=100)
    for name in ("roi_labels", "roi_valid"):
        np.testing.assert_array_equal(pp[name].numpy(), np.asarray(jp[name]))
    _close(pp["rois"], jp["rois"])
    _close(pp["roi_scores"], jp["roi_scores"])
    assert 0 < int(pp["roi_valid"].sum()) < pp["roi_valid"].numel()


def test_fc_tower_and_roi_decode_f32_match():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 10, 48)).astype(np.float32)
    valid = rng.random((2, 10)) < 0.7
    jm = jroi.FCTower(hidden=(32, 32), out_dim=7, compute_dtype=None)
    pm = roi_head.FCTower(48, hidden=(32, 32), out_dim=7, compute_dtype=None)
    v = init_pair(jm, pm, jnp.asarray(x), jnp.asarray(valid), False)
    ref = jm.apply(v, jnp.asarray(x), jnp.asarray(valid), False)
    with torch.no_grad():
        out = pm(_t(x), _t(valid))
    _close(out, ref)
    rois = np.concatenate([rng.uniform(-5, 5, (2, 10, 3)), rng.uniform(0.5, 4, (2, 10, 3)),
                           rng.uniform(-3, 3, (2, 10, 1))], -1).astype(np.float32)
    from cpd_tpu.ops.box_coders import ResidualCoder as JCoder
    from cpd_tpu_torch.ops.box_coders import ResidualCoder
    _close(roi_head.decode_roi_boxes(_t(rois), out, ResidualCoder()),
           jroi.decode_roi_boxes(jnp.asarray(rois), ref, JCoder()))


def test_grid_pool_branch_matches_bf16(backbone_pair):
    """Queries match exactly; pooled features at the JAX module's bf16."""
    _, _, out, ref = backbone_pair
    rng = np.random.default_rng(5)
    vs, pcr = (0.5, 0.5, 0.25), (-8.0, -8.0, -2.0, 8.0, 8.0, 4.5)
    rois = np.concatenate([rng.uniform(-6, 6, (2, 6, 2)), rng.uniform(-1, 3, (2, 6, 1)),
                           rng.uniform(1, 4, (2, 6, 3)), rng.uniform(-3, 3, (2, 6, 1))],
                          -1).astype(np.float32)
    jgrids = jbb.stage_grids(GRID)
    pgrids = backbone3d.stage_grids(sparse.GridSpec(*GRID))
    names = ("x_conv3", "x_conv4")
    jfeat = {n: (ref[n][0].astype(jnp.bfloat16), ref[n][1]) for n in names}
    pfeat = {n: (out[n][0].bfloat16(), out[n][1]) for n in names}
    jq = jroi.compute_pool_queries(jnp.asarray(rois), jfeat, jgrids, jroi.GridPoolBranch.scale_specs,
                                   vs, pcr, 3, 16)
    pq = roi_head.compute_pool_queries(_t(rois), pfeat, pgrids, roi_head.SCALE_SPECS, vs, pcr, 3,
                                       16)
    assert set(pq) == set(jq)
    for key in jq:
        np.testing.assert_array_equal(pq[key][1].numpy(), np.asarray(jq[key][1]))
        np.testing.assert_array_equal(pq[key][0].numpy(), np.asarray(jq[key][0]))
        _close(pq[key][2], jq[key][2], rtol=1e-5, atol=1e-5)
    assert any(int(pq[key][1].sum()) > 0 for key in pq)
    jm = jroi.GridPoolBranch(vs, pcr, grid_size=3, scale_grids=jgrids)
    pm = roi_head.GridPoolBranch({n: out[n][0].shape[-1] for n in names}, grid_size=3)
    v = init_pair(jm, pm, jnp.asarray(rois), jfeat, jq)
    with torch.no_grad():
        pooled = pm(_t(rois), pfeat, pq)
    bf16_close(pooled.float(), jm.apply(v, jnp.asarray(rois), jfeat, jq), "GridPoolBranch")


def test_weight_bridge_strict_both_ways():
    """Every port key is filled and every JAX leaf used, for the whole model;
    a missing or an extra leaf raises."""
    from __graft_entry__ import _TINY
    from cpd_tpu.models.detector import VoxelRCNN as JVoxelRCNN
    from cpd_tpu_torch.models.detector import VoxelRCNN
    jm = JVoxelRCNN(**_TINY, mm=False)
    batch = {"points": jnp.zeros((1, 64, 5)), "points_valid": jnp.ones((1, 64), bool)}
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), batch, False))
    variables = seeded_jax_variables(shapes, 0)
    pm = VoxelRCNN(**_TINY, mm=False)
    sd = state_dict_from_jax(variables, pm)
    n_leaves = len(jax.tree_util.tree_leaves(variables))
    assert len(sd) == n_leaves == len(pm.state_dict())
    pm.load_state_dict(sd, strict=True)
    # the same weights round-trip through the GridPoolBranch direct mapping
    np.testing.assert_array_equal(
        pm.roi_head.pool_branch.mlp_x_conv4_1[2].weight.detach().numpy(),
        variables["params"]["roi_head"]["pool_branch"]["Dense_7"]["kernel"].T)
    del variables["params"]["roi_head"]["shared0"]["fc1"]
    with pytest.raises(KeyError, match="missing"):
        state_dict_from_jax(variables, pm)
    variables["params"]["roi_head"]["shared0"]["fc1"] = {"kernel": np.zeros((256, 256))}
    variables["params"]["roi_head"]["extra"] = {"kernel": np.zeros((3, 3))}
    with pytest.raises(KeyError, match="unmapped"):
        state_dict_from_jax(variables, pm)
    # seeded weights for the card fill every key with the model's shapes
    seeded = seeded_state_dict(pm, 0)
    assert {k: tuple(v.shape) for k, v in seeded.items()} == {
        k: tuple(v.shape) for k, v in pm.state_dict().items()}
