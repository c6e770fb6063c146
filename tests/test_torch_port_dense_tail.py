"""The dense backbone tail of the port against the JAX package's
(``ResBranch._dense_tail``) and against the port's own sparse path, after
``tests/test_dense_tail.py`` (CPU).

Same seeded inputs and weights (through ``state_dict_from_jax``) on both
sides. Integer outputs (masks, key sets) match exactly. At f32
(``compute_dtype=None``) features match within 1e-4 of the output's scale; at
bf16 within the tier of ``tests/test_dense_tail.py`` (JAX asks its conv for a
bf16 result, torch's accumulates in f32 and rounds once). Gradients at f32:
dense against sparse in the port within 2e-5 of each gradient's scale, and
against ``jax.grad`` within 1e-3 of it. This file: the sparse functions of the
tail and the backbone in eval mode; training mode is in
``test_torch_port_dense_tail_train.py``, the whole predict in
``test_torch_port_dense_tail_predict.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpd_tpu.models import backbone3d as jbb
from cpd_tpu.ops import sparse as jsparse
from cpd_tpu.ops.sparse import INVALID_KEY, GridSpec
from cpd_tpu_torch.models import backbone3d, bev
from cpd_tpu_torch.ops import sparse
from cpd_tpu_torch.ops.gather_gemm import gather_gemm
from cpd_tpu_torch.utils.weights import state_dict_from_jax
from tests.test_torch_port_models import _random_sparse, init_pair, seeded_jax_variables
from tests.torch_port_refs import one_torch_thread  # noqa: F401

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
