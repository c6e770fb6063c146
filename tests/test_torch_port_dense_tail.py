"""The dense backbone tail of the port against the JAX package's
(``ResBranch._dense_tail``) and against the port's own sparse path, after
``tests/test_dense_tail.py`` (CPU).

Same seeded inputs and weights (through ``state_dict_from_jax``) on both
sides. Integer outputs (masks, key sets) match exactly. At f32
(``compute_dtype=None``) features match within 1e-4 of the output's scale; at
bf16 within the tier of ``tests/test_dense_tail.py`` (JAX asks its conv for a
bf16 result, torch's accumulates in f32 and rounds once). Gradients at f32:
dense against sparse in the port within 2e-5 of each gradient's scale, and
against ``jax.grad`` within 1e-3 of it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _TINY, _make_batch
from cpd_tpu.models import backbone3d as jbb
from cpd_tpu.models.detector import VoxelRCNN as JVoxelRCNN
from cpd_tpu.ops import sparse as jsparse
from cpd_tpu.ops.sparse import INVALID_KEY, GridSpec
from cpd_tpu_torch.models import backbone3d, bev
from cpd_tpu_torch.models.detector import VoxelRCNN
from cpd_tpu_torch.ops import sparse
from cpd_tpu_torch.ops.gather_gemm import gather_gemm
from cpd_tpu_torch.utils.weights import grads_to_jax_tree, state_dict_from_jax
from tests.test_torch_port_models import (_random_sparse, bf16_close, init_pair,
                                          jax_nms_with_clip_iou, seeded_jax_variables)

GRID = GridSpec(32, 32, 26)
PGRID = sparse.GridSpec(*GRID)
CAPS = (512, 256, 160, 160)
FILTERS = (4, 8, 16, 32)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().float()
    return np.asarray(x, np.float32)


def _f32_close(port, ref, what):
    port, ref = _np(port), _np(ref)
    scale = max(float(np.abs(ref).max()), 1e-3)
    np.testing.assert_allclose(port, ref, rtol=1e-4, atol=1e-4 * scale, err_msg=what)
    assert scale > 0.05, f"{what}: a trivially zero output"


def _dense_tail_tier(a, b, what):
    """The bf16 tier of tests/test_dense_tail.py::_assert_close."""
    a, b = _np(a), _np(b)
    np.testing.assert_allclose(a, b, rtol=0.15, atol=0.15, err_msg=what)
    scale = max(np.abs(a).max(), 1e-3)
    assert np.abs(a - b).max() <= 0.05 * scale + 0.05, what


def _keys(rng, batch, n, grid=GRID):
    _, keys = _random_sparse(rng, batch, n, grid)
    return keys


# ---- the three sparse functions, exact ----

def test_dense_mask_from_keys_matches_jax():
    keys = _keys(np.random.default_rng(0), 2, 300)
    ref = jax.vmap(lambda k: jsparse.dense_mask_from_keys(k, GRID))(jnp.asarray(keys))
    out = sparse.dense_mask_from_keys(_t(keys), PGRID)
    assert out.dtype == torch.bool and tuple(out.shape) == (2, GRID.nz, GRID.ny, GRID.nx)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(sparse.dense_mask_from_keys(_t(keys[0]), PGRID).numpy(),
                                  np.asarray(ref[0]))
    assert int(out.sum()) == int((keys != INVALID_KEY).sum())


@pytest.mark.parametrize("cap", [128, 70, 400], ids=["fits", "overflows", "roomy"])
def test_keys_from_dense_mask_matches_jax(cap):
    """Sorted keys with INVALID_KEY padding; above the cap the highest keys
    go, as the capped rulebook drops them."""
    rng = np.random.default_rng(3)
    mask = rng.random((2, 400)) < 0.2
    assert mask.sum(-1).min() > 70
    ref_k, ref_v = jax.vmap(lambda m: jsparse.keys_from_dense_mask(m, cap))(jnp.asarray(mask))
    keys, valid = sparse.keys_from_dense_mask(_t(mask), cap)
    assert keys.dtype == torch.int32 and keys.is_contiguous()
    np.testing.assert_array_equal(keys.numpy(), np.asarray(ref_k))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(ref_v))
    for b in range(2):
        np.testing.assert_array_equal(keys[b][valid[b]].numpy(),
                                      np.nonzero(mask[b])[0].astype(np.int32)[:cap])
    one, _ = sparse.keys_from_dense_mask(_t(mask[0]), cap)
    np.testing.assert_array_equal(one.numpy(), keys[0].numpy())


def test_rows_from_dense_matches_jax():
    rng = np.random.default_rng(4)
    dense = rng.normal(size=(2, 400, 6)).astype(np.float32)
    keys = np.full((2, 50), INVALID_KEY, np.int32)
    for b in range(2):
        keys[b, :40] = np.sort(rng.choice(400, 40, replace=False))
    ref = jax.vmap(jsparse.rows_from_dense)(jnp.asarray(dense), jnp.asarray(keys))
    out = sparse.rows_from_dense(_t(dense), _t(keys))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert float(out[:, 40:].abs().max()) == 0.0


def test_mask_key_roundtrip_equals_capped_rulebook_keys():
    """keys -> mask -> downsampled mask -> keys gives the strided rulebook's
    own output keys, below and above the cap."""
    keys = _t(_keys(np.random.default_rng(5), 2, 300))
    mask = sparse.dense_mask_from_keys(keys, PGRID)
    down = backbone3d._downsample_mask(mask, (3, 3, 3), (2, 2, 2), (1, 1, 0))
    jdown = jbb._downsample_mask(jnp.asarray(mask.numpy()), (3, 3, 3), (2, 2, 2), (1, 1, 0))
    np.testing.assert_array_equal(down.numpy(), np.asarray(jdown))
    for cap in (2000, 500):
        rb, _ = sparse.build_conv_rulebook_batched(keys, PGRID, (3, 3, 3), (2, 2, 2), (1, 1, 0),
                                                   cap)
        got, _ = sparse.keys_from_dense_mask(down.reshape(2, -1), cap)
        assert torch.equal(got, rb.out_keys)
    assert int((rb.out_keys != INVALID_KEY).sum(-1).min()) == 500  # the cap did bind


def test_branch_rulebooks_stop_after_stage_3():
    """With the transposes (training), which hold the inference set too."""
    keys = _keys(np.random.default_rng(6), 2, 300)
    ref = jax.jit(lambda k: jbb.build_branch_rulebooks(k, GRID, CAPS, with_transpose=True,
                                                       dense_tail=True))(jnp.asarray(keys))
    out = backbone3d.build_branch_rulebooks(_t(keys), PGRID, CAPS, with_transpose=True,
                                            dense_tail=True)
    # a submanifold conv's transpose is implicit in the JAX package ("mirror")
    assert {k for k in out if not k.startswith("subm") or not k.endswith("_T")} == set(ref)
    assert set(ref) == {"subm1", "subm2", "subm3", "down2", "down3", "down2_T", "down3_T"}
    assert set(backbone3d.build_branch_rulebooks(_t(keys), PGRID, CAPS, dense_tail=True)) == {
        "subm1", "subm2", "subm3", "down2", "down3"}
    for name in ref:
        found = np.asarray(ref[name].found)
        np.testing.assert_array_equal(out[name].found.numpy(), found, err_msg=name)
        np.testing.assert_array_equal(out[name].idx.numpy()[found],
                                      np.asarray(ref[name].idx)[found], err_msg=name)


# ---- the backbone ----

@pytest.fixture(scope="module", params=[None, "bf16"], ids=["f32", "bf16"])
def dense_pair(request):
    """JAX dense tail, port dense tail and port sparse tail on one input,
    one set of weights."""
    jcd, pcd = (None, None) if request.param is None else (jnp.bfloat16, torch.bfloat16)
    rng = np.random.default_rng(1)
    feats, keys = _random_sparse(rng, 2, 300)
    jm = jbb.VoxelResBackBone8x(grid=GRID, num_filters=FILTERS, caps=CAPS, mm=False,
                                dense_tail=True, compute_dtype=jcd)
    pd = backbone3d.VoxelResBackBone8x(PGRID, 5, FILTERS, CAPS, compute_dtype=pcd,
                                       dense_tail=True)
    v = init_pair(jm, pd, jnp.asarray(feats), jnp.asarray(keys), False)
    ps = backbone3d.VoxelResBackBone8x(PGRID, 5, FILTERS, CAPS, compute_dtype=pcd)
    ps.load_state_dict(pd.state_dict(), strict=True)  # one state dict, both settings
    ps.eval()
    ref = jm.apply(v, jnp.asarray(feats), jnp.asarray(keys), False)
    launches = gather_gemm.launches
    with torch.no_grad():
        out_d = pd(_t(feats), _t(keys))
        out_s = ps(_t(feats), _t(keys))
    assert gather_gemm.launches == launches  # CPU tensors: the plain version, no launch
    return request.param, out_d, out_s, ref


@pytest.mark.parametrize("stage", ["x_conv3", "x_conv4", "encoded", "encoded_bev"])
def test_dense_tail_matches_jax(dense_pair, stage):
    tier, out, _, ref = dense_pair
    close = _f32_close if tier is None else _dense_tail_tier
    if stage == "encoded_bev":
        assert tuple(out[stage].shape) == tuple(ref[stage].shape)
        close(out[stage], ref[stage], stage)
        return
    (f, k, g), (rf, rk, rg) = out[stage], ref[stage]
    assert tuple(g) == tuple(rg)
    np.testing.assert_array_equal(k.numpy(), np.asarray(rk), err_msg=stage)
    close(f, rf, stage)


@pytest.mark.parametrize("stage", ["x_conv4", "encoded", "encoded_bev"])
def test_dense_tail_matches_sparse_path_below_caps(dense_pair, stage):
    tier, out_d, out_s, _ = dense_pair
    close = _f32_close if tier is None else _dense_tail_tier
    if stage == "encoded_bev":
        # the BEV map comes out in height_compression's layout (z-major channels)
        close(out_d[stage], bev.height_compression(*out_s["encoded"]), stage)
        assert "encoded_bev" not in out_s
        return
    (fd, kd, _), (fs, ks, _) = out_d[stage], out_s[stage]
    assert torch.equal(kd, ks)
    assert int((ks != INVALID_KEY).sum(-1).max()) < CAPS[2]  # below the caps
    close(fd, fs, stage)


def test_dense_tail_keeps_the_parameter_tree():
    """Same keys and shapes with and without the dense tail, and the JAX
    tree maps onto both (``state_dict_from_jax`` is strict)."""
    models = [backbone3d.VoxelResBackBone8x(PGRID, 5, FILTERS, CAPS, mm=True, dense_tail=d)
              for d in (False, True)]
    shapes = [{k: tuple(v.shape) for k, v in m.state_dict().items()} for m in models]
    assert shapes[0] == shapes[1]
    feats, keys = _random_sparse(np.random.default_rng(0), 1, 100)
    jm = jbb.VoxelResBackBone8x(grid=GRID, num_filters=FILTERS, caps=CAPS, mm=True,
                                dense_tail=True)
    args = (jnp.asarray(feats), jnp.asarray(keys), True, jnp.asarray(feats), jnp.asarray(keys))
    variables = seeded_jax_variables(
        jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), *args)), 0)
    for m in models:
        m.load_state_dict(state_dict_from_jax(variables, m), strict=True)


@pytest.fixture(scope="module")
def train_pair():
    """f32 training mode (batch statistics): loss = sum(encoded^2) and its
    gradients in JAX (dense tail) and in the port (dense and sparse tail)."""
    rng = np.random.default_rng(1)
    feats, keys = _random_sparse(rng, 2, 300)
    jm = jbb.VoxelResBackBone8x(grid=GRID, num_filters=FILTERS, caps=CAPS, mm=False,
                                dense_tail=True, compute_dtype=None, remat=False)
    models = {d: backbone3d.VoxelResBackBone8x(PGRID, 5, FILTERS, CAPS, compute_dtype=None,
                                               dense_tail=d) for d in (True, False)}
    v = init_pair(jm, models[True], jnp.asarray(feats), jnp.asarray(keys), True)
    models[False].load_state_dict(models[True].state_dict(), strict=True)

    def loss_fn(params):
        out, upd = jm.apply({"params": params, "batch_stats": v["batch_stats"]},
                            jnp.asarray(feats), jnp.asarray(keys), True, mutable=["batch_stats"])
        return jnp.sum(out["encoded"][0].astype(jnp.float32) ** 2), upd

    (jloss, jupd), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(v["params"])
    runs = {}
    for dense, m in models.items():
        m.train()
        loss = (m(_t(feats), _t(keys))["encoded"][0].float() ** 2).sum()
        loss.backward()
        runs[dense] = (float(loss.detach()), m)
    return runs, float(jloss), jupd, jgrads, v


def test_dense_tail_train_loss_and_batch_stats(train_pair):
    runs, jloss, jupd, _, _ = train_pair
    (ld, md), (ls, ms) = runs[True], runs[False]
    np.testing.assert_allclose(ld, ls, rtol=1e-4)
    np.testing.assert_allclose(ld, jloss, rtol=1e-4)
    # masked moments over the same occupied sites, and the same running update
    for name in ("down4", "conv_out"):
        jst = jupd["batch_stats"]["branch0"][name]["MaskedBatchNorm_0"]
        for m in (md, ms):
            bn = getattr(m.branch0, name).bn
            np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(jst["mean"]),
                                       rtol=1e-4, atol=1e-5)
            np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(jst["var"]),
                                       rtol=1e-4, atol=1e-5)


GRAD_LEAVES = ["conv_input.weight", "down3.weight", "res3b.conv2.weight", "down4.weight",
               "res4a.conv1.weight", "res4b.conv2.bn.weight", "conv_out.weight",
               "conv_out.bn.bias"]


@pytest.mark.parametrize("leaf", GRAD_LEAVES)
def test_dense_tail_gradients_match_sparse_path(train_pair, leaf):
    """Stage-4 parameters and what lies upstream (through kernels A1 and A2's
    plain versions): 2e-5 of the gradient's scale, as tests/test_dense_tail.py."""
    runs, *_ = train_pair
    gd = dict(runs[True][1].branch0.named_parameters())[leaf].grad.numpy()
    gs = dict(runs[False][1].branch0.named_parameters())[leaf].grad.numpy()
    scale = max(float(np.abs(gs).max()), 1e-6)
    assert scale > 1e-4
    np.testing.assert_allclose(gd / scale, gs / scale, atol=2e-5, err_msg=leaf)


def test_dense_tail_gradients_match_jax_grad(train_pair):
    """Every parameter gradient of the port's dense tail against jax.grad of
    the JAX dense tail, 1e-3 of each leaf's scale."""
    runs, _, _, jgrads, v = train_pair
    tree = grads_to_jax_tree(runs[True][1], v["params"])
    flat_p = jax.tree_util.tree_leaves_with_path(tree)
    flat_j = dict(jax.tree_util.tree_leaves_with_path(jax.tree_util.tree_map(np.asarray, jgrads)))
    assert len(flat_p) == len(flat_j) > 60
    for path, g in flat_p:
        ref = flat_j[path]
        scale = max(float(np.abs(ref).max()), 1e-6)
        np.testing.assert_allclose(g / scale, ref / scale, atol=1e-3,
                                   err_msg=jax.tree_util.keystr(path))


def test_dense_tail_light_branch_mm():
    """The light MM branch with the dense tail (one block at stage 4, no
    conv_out) against JAX and against the port's sparse path."""
    rng = np.random.default_rng(2)
    feats, keys = _random_sparse(rng, 1, 250)
    feats1, keys1 = _random_sparse(rng, 1, 200)
    kw = dict(grid=GRID, num_filters=FILTERS, caps=CAPS, mm=True, compute_dtype=None)
    jm = jbb.VoxelResBackBone8x(**kw, dense_tail=True)
    pd = backbone3d.VoxelResBackBone8x(PGRID, 5, FILTERS, CAPS, compute_dtype=None, mm=True,
                                       dense_tail=True)
    args = tuple(jnp.asarray(a) for a in (feats, keys))
    args1 = tuple(jnp.asarray(a) for a in (feats1, keys1))
    v = init_pair(jm, pd, *args, True, *args1)
    ps = backbone3d.VoxelResBackBone8x(PGRID, 5, FILTERS, CAPS, compute_dtype=None, mm=True)
    ps.load_state_dict(pd.state_dict(), strict=True)
    ref, _ = jax.jit(lambda v: jm.apply(v, *args, True, *args1, mutable=["batch_stats"]))(v)
    outs = []
    for m in (pd, ps):
        m.train()
        with torch.no_grad():
            outs.append(m(_t(feats), _t(keys), _t(feats1), _t(keys1)))
    out_d, out_s = outs
    assert "encoded_bev" in out_d and "encoded_mm" not in out_d
    for name in ("x_conv4", "x_conv4_mm"):
        (fd, kd, _), (fs, ks, _), (rf, rk, _) = out_d[name], out_s[name], ref[name]
        np.testing.assert_array_equal(kd.numpy(), np.asarray(rk), err_msg=name)
        assert torch.equal(kd, ks)
        _f32_close(fd, rf, name)
        _f32_close(fd, fs, name)


# ---- the whole slice ----

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
    pm = VoxelRCNN(**{k: v for k, v in _TINY.items() if k != "remat"}, dense_tail=True)
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
