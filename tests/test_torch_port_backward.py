"""The sparse conv's backward in the PyTorch port against the JAX package.

On the CPU the port's wrappers compute the plain versions of kernels A1 and
A2, so these tests hold the plain versions, the autograd Function around
them and the transpose rulebooks to the JAX package:

* ``gather_gemm_dw_reference`` against the Pallas kernel
  ``pallas_conv.gather_gemm_dw`` in interpret mode, f32, 1e-4 (a sum over
  rows taken in another order);
* the Function's dX and dW against ``jax.grad`` through
  ``sparse_conv_apply_batched(..., transpose=...)``, f32, 1e-4 of the
  gradient's scale, and against torch's own autograd through the plain
  forward (which scatters where the Function gathers);
* the inverse and mirror rulebooks exactly;
* training-mode batch norms: outputs, running statistics, input gradients
  (f32, 1e-4; running statistics 1e-6).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpd_tpu.models import backbone3d as jbb
from cpd_tpu.models import norm as jnorm
from cpd_tpu.ops import pallas_conv
from cpd_tpu.ops import sparse as jsparse
from cpd_tpu_torch.models import backbone3d, norm
from cpd_tpu_torch.ops import sparse
from cpd_tpu_torch.ops.gather_gemm import (gather_gemm_dw, gather_gemm_dw_reference,
                                           gather_gemm_reference)
from tests.torch_port_refs import one_torch_thread  # noqa: F401

GRID = sparse.GridSpec(20, 18, 11)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _scaled_close(port, ref, tol=1e-4, what=""):
    """Within ``tol`` of the reference's scale (its largest magnitude)."""
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref, np.float32)
    scale = max(float(np.abs(ref).max()), 1e-6)
    err = float(np.abs(port.astype(np.float32) - ref).max())
    assert err <= tol * scale, f"{what}: max err {err} vs scale {scale}"
    assert scale > 1e-3, f"{what}: reference is trivially zero"


@pytest.mark.parametrize("b,v,n,k,cin,cout", [(2, 90, 131, 27, 16, 32), (2, 50, 77, 3, 5, 8),
                                              (1, 40, 300, 27, 5, 16)])
def test_dw_reference_matches_pallas_interpret(b, v, n, k, cin, cout):
    """Junk idx under found=False never counts; K = 3, Cin = 5, N no multiple
    of any tile, B = 2."""
    rng = np.random.default_rng(n)
    table = rng.normal(size=(b, v, cin)).astype(np.float32)
    found = rng.random((b, n, k)) < 0.4
    idx = rng.integers(0, v, (b, n, k)).astype(np.int32)
    g_out = rng.normal(size=(b, n, cout)).astype(np.float32)
    junk = np.where(found, idx, 10**8).astype(np.int32)
    out = gather_gemm_dw(_t(table), _t(junk), _t(found), _t(g_out))
    assert out.dtype == torch.float32 and tuple(out.shape) == (k * cin, cout)
    ref = pallas_conv.gather_gemm_dw(jnp.asarray(table), jnp.asarray(np.where(found, idx, 0)),
                                     jnp.asarray(found), jnp.asarray(g_out),
                                     compute_dtype=jnp.float32)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)
    # bf16 operands (the main path's): still an f32 sum of the rounded operands
    tb, gb = _t(table).bfloat16(), _t(g_out).bfloat16()
    out_b = gather_gemm_dw(tb, _t(junk), _t(found), gb)
    assert out_b.dtype == torch.float32
    torch.testing.assert_close(out_b, gather_gemm_dw_reference(tb.float(), _t(idx), _t(found),
                                                               gb.float()), rtol=1e-5, atol=1e-5)


def test_dw_wrapper_rejects_bad_operands():
    table = torch.zeros(1, 8, 4)
    idx = torch.zeros(1, 3, 2, dtype=torch.int32)
    found = torch.ones(1, 3, 2, dtype=torch.bool)
    with pytest.raises(ValueError):
        gather_gemm_dw(table, idx, found, torch.zeros(1, 4, 6))  # N mismatch
    with pytest.raises(TypeError):
        gather_gemm_dw(table, idx, found, torch.zeros(1, 3, 6, dtype=torch.bfloat16))
    with pytest.raises(TypeError):
        gather_gemm_dw(table, idx.long(), found, torch.zeros(1, 3, 6))


def _sparse_inputs(seed, batch=2, n=260, cin=6):
    rng = np.random.default_rng(seed)
    keys = np.stack([np.sort(rng.choice(GRID.num_cells, n, replace=False)).astype(np.int32)
                     for _ in range(batch)])
    keys[:, -n // 8:] = sparse.INVALID_KEY
    feats = rng.standard_normal((batch, n, cin)).astype(np.float32)
    feats[keys == sparse.INVALID_KEY] = 0.0
    return rng, feats, keys


STRIDED = ((3, 3, 3), (2, 2, 2), (1, 1, 1))


def _rulebooks(keys, kind):
    """(port rulebook, port transpose, jax rulebook, jax transpose)."""
    jgrid = jsparse.GridSpec(*GRID)
    if kind == "mirror":
        rb = sparse.build_subm_rulebook_batched(_t(keys), GRID)
        return (rb, sparse.mirror_rulebook(rb),
                jsparse.build_subm_rulebook_batched(jnp.asarray(keys), jgrid), "mirror")
    kernel, stride, padding = STRIDED
    rb, out_grid = sparse.build_conv_rulebook_batched(_t(keys), GRID, kernel, stride, padding, 200)
    rb_t = sparse.build_inverse_rulebook_batched(_t(keys), rb.out_keys, GRID, out_grid, kernel,
                                                 stride, padding)
    jrb, jout_grid = jsparse.build_conv_rulebook_batched(jnp.asarray(keys), jgrid, kernel, stride,
                                                         padding, 200)
    jrb_t = jsparse.build_inverse_rulebook_batched(jnp.asarray(keys), jrb.out_keys, jgrid,
                                                   jout_grid, kernel, stride, padding)
    return rb, rb_t, jrb, jrb_t


@pytest.mark.parametrize("kind", ["mirror", "strided"])
def test_conv_function_grads_match_jax_and_autograd(kind):
    rng, feats, keys = _sparse_inputs(7)
    cin, cout = feats.shape[-1], 10
    rb, rb_t, jrb, jrb_t = _rulebooks(keys, kind)
    w = (rng.standard_normal((27, cin, cout)) * 0.2).astype(np.float32)
    cot = rng.standard_normal((2, rb.idx.shape[1], cout)).astype(np.float32)

    x_t, w_t = _t(feats).requires_grad_(), _t(w).requires_grad_()
    out = sparse.sparse_conv_apply_batched(x_t, rb, w_t, transpose=rb_t)
    (out * _t(cot)).sum().backward()

    def jloss(x, wj):
        o = jsparse.sparse_conv_apply_batched(x, jrb, wj, transpose=jrb_t)
        return jnp.sum(o * jnp.asarray(cot)), o
    (jdx, jdw), jout = jax.grad(jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(feats),
                                                                   jnp.asarray(w))
    _scaled_close(out, jout, what="forward")
    _scaled_close(x_t.grad, jdx, what="dX vs jax.grad")
    _scaled_close(w_t.grad, jdw, what="dW vs jax.grad")

    # torch's own autograd through the plain forward (index/scatter backward)
    x_a, w_a = _t(feats).requires_grad_(), _t(w).requires_grad_()
    plain = gather_gemm_reference(x_a, rb.idx, rb.found, w_a.reshape(27 * cin, cout))
    plain = torch.where(rb.out_valid[..., None], plain, 0.0)
    (plain * _t(cot)).sum().backward()
    _scaled_close(x_t.grad, x_a.grad.numpy(), what="dX vs autograd")
    _scaled_close(w_t.grad, w_a.grad.numpy(), what="dW vs autograd")


def test_conv_function_skips_dx_and_keeps_dtypes():
    """No dX where the input needs none (voxel features are data); bf16
    compute gives dW in the weight's dtype and dX in the activation's."""
    rng, feats, keys = _sparse_inputs(8)
    rb = sparse.build_subm_rulebook_batched(_t(keys), GRID)
    w = torch.randn(27, feats.shape[-1], 8, generator=torch.Generator().manual_seed(0)) * 0.2
    w.requires_grad_()
    out = sparse.sparse_conv_apply_batched(_t(feats), rb, w, compute_dtype=torch.bfloat16,
                                           transpose=sparse.mirror_rulebook(rb),
                                           out_dtype=torch.bfloat16)
    assert out.dtype == torch.bfloat16
    out.float().sum().backward()
    assert w.grad.dtype == torch.float32 and float(w.grad.abs().max()) > 0
    x = _t(feats).bfloat16().requires_grad_()
    out = sparse.sparse_conv_apply_batched(x, rb, w, compute_dtype=torch.bfloat16,
                                           transpose=sparse.mirror_rulebook(rb),
                                           out_dtype=torch.bfloat16)
    out.float().sum().backward()
    assert x.grad.dtype == torch.bfloat16 and float(x.grad.float().abs().max()) > 0
    # the forward-only path records no gradient
    assert not sparse.sparse_conv_apply_batched(
        x, rb, w, compute_dtype=torch.bfloat16).requires_grad
    # the transpose is a rulebook, never the JAX function's 'mirror' string
    with pytest.raises(TypeError, match="mirror_rulebook"):
        sparse.sparse_conv_apply_batched(x, rb, w, transpose="mirror")


def test_mirror_needs_odd_kernel_volume():
    rb = sparse.Rulebook(torch.zeros(1, 4, 8, dtype=torch.int32),
                         torch.zeros(1, 4, 8, dtype=torch.bool),
                         torch.zeros(1, 4, dtype=torch.int32), torch.ones(1, 4, dtype=torch.bool))
    with pytest.raises(ValueError, match="all-odd"):
        sparse.mirror_rulebook(rb)


@pytest.mark.parametrize("kernel,stride,padding", [STRIDED, ((3, 3, 3), (2, 2, 2), (1, 1, 0)),
                                                   ((1, 1, 3), (1, 1, 2), (0, 0, 0))])
def test_inverse_rulebook_exact(kernel, stride, padding):
    _, _, keys = _sparse_inputs(9)
    jgrid = jsparse.GridSpec(*GRID)
    rb, out_grid = sparse.build_conv_rulebook_batched(_t(keys), GRID, kernel, stride, padding, 220)
    inv = sparse.build_inverse_rulebook_batched(_t(keys), rb.out_keys, GRID, out_grid, kernel,
                                                stride, padding)
    jrb, jout_grid = jsparse.build_conv_rulebook_batched(jnp.asarray(keys), jgrid, kernel, stride,
                                                         padding, 220)
    ref = jsparse.build_inverse_rulebook_batched(jnp.asarray(keys), jrb.out_keys, jgrid,
                                                 jout_grid, kernel, stride, padding)
    found = np.asarray(ref.found)
    assert found.any()
    np.testing.assert_array_equal(inv.found.numpy(), found)
    np.testing.assert_array_equal(inv.idx.numpy()[found], np.asarray(ref.idx)[found])
    np.testing.assert_array_equal(inv.out_valid.numpy(), np.asarray(ref.out_valid))
    # the transpose property itself: fwd.idx[inv.idx[u, k], k] == u wherever found
    b_i, u_i, k_i = np.nonzero(found)
    v_i = inv.idx.numpy()[b_i, u_i, k_i]
    assert rb.found.numpy()[b_i, v_i, k_i].all()
    np.testing.assert_array_equal(rb.idx.numpy()[b_i, v_i, k_i], u_i)
    assert int(rb.found.sum()) == int(found.sum())


def test_train_branch_rulebooks_match():
    """Training rulebooks: the JAX package's ``*_T`` set, exactly; the port
    adds one flipped copy per stage for its submanifold convs."""
    grid = sparse.GridSpec(24, 24, 26)  # deep enough in z for the whole conv ladder
    rng = np.random.default_rng(10)
    keys = np.stack([np.sort(rng.choice(grid.num_cells, 300, replace=False)).astype(np.int32)
                     for _ in range(2)])
    keys[:, -40:] = sparse.INVALID_KEY
    caps = (256, 200, 160, 160)
    for with_conv_out in (True, False):
        ref = jbb.build_branch_rulebooks(jnp.asarray(keys), jsparse.GridSpec(*grid), caps,
                                         with_transpose=True, with_conv_out=with_conv_out)
        out = backbone3d.build_branch_rulebooks(_t(keys), grid, caps, with_transpose=True,
                                                with_conv_out=with_conv_out)
        mirrors = {f"subm{i}_T" for i in range(1, 5)}
        assert set(out) - mirrors == set(ref)
        for name in ref:
            found = np.asarray(ref[name].found)
            np.testing.assert_array_equal(out[name].found.numpy(), found, err_msg=name)
            np.testing.assert_array_equal(out[name].idx.numpy()[found],
                                          np.asarray(ref[name].idx)[found], err_msg=name)
        for i in range(1, 5):
            assert torch.equal(out[f"subm{i}_T"].idx, out[f"subm{i}"].idx.flip(-1))
            assert out[f"subm{i}_T"].idx.is_contiguous()


def _bn_stats(module):
    return module.running_mean.numpy().copy(), module.running_var.numpy().copy()


def test_masked_batch_norm_training_matches():
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(2, 40, 8)) * 2 + 1).astype(np.float32)
    valid = rng.random((2, 40)) < 0.7
    cot = rng.normal(size=x.shape).astype(np.float32)
    for momentum, eps in ((0.01, 1e-3), (0.1, 1e-5)):
        jm = jnorm.MaskedBatchNorm(momentum=momentum, epsilon=eps)
        pm = norm.MaskedBatchNorm(8, eps=eps, momentum=momentum).train()
        v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(valid), True)
        v = jax.tree_util.tree_map(lambda a: a + 0.25, v)  # off the init values
        pm.load_state_dict({"weight": _t(v["params"]["scale"]), "bias": _t(v["params"]["bias"]),
                            "running_mean": _t(v["batch_stats"]["mean"]),
                            "running_var": _t(v["batch_stats"]["var"])})

        def jloss(xx):
            y, mut = jm.apply(v, xx, jnp.asarray(valid), True, mutable=["batch_stats"])
            return jnp.sum(y * jnp.asarray(cot)), (y, mut)
        jdx, (jy, mut) = jax.grad(jloss, has_aux=True)(jnp.asarray(x))
        xt = _t(x).requires_grad_()
        y = pm(xt, _t(valid))
        (y * _t(cot)).sum().backward()
        np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jdx), rtol=1e-4, atol=1e-4)
        mean, var = _bn_stats(pm)
        np.testing.assert_allclose(mean, np.asarray(mut["batch_stats"]["mean"]), atol=1e-6)
        np.testing.assert_allclose(var, np.asarray(mut["batch_stats"]["var"]), atol=1e-6)
        assert float(np.abs(y.detach().numpy()[~valid]).max()) == 0.0


def test_batch_norm_2d_training_matches_and_uses_biased_variance():
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(2, 5, 6, 8)) * 3 - 1).astype(np.float32)  # NHWC
    cot = rng.normal(size=x.shape).astype(np.float32)
    jm = jnorm.BatchNorm2d(momentum=0.01, epsilon=1e-3)
    pm = norm.BatchNorm2d(8, eps=1e-3, momentum=0.01).train()
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), True)

    def jloss(xx):
        y, mut = jm.apply(v, xx, True, mutable=["batch_stats"])
        return jnp.sum(y * jnp.asarray(cot)), (y, mut)
    jdx, (jy, mut) = jax.grad(jloss, has_aux=True)(jnp.asarray(x))
    xt = _t(x).requires_grad_()
    y = pm(xt.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    (y * _t(cot)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jdx), rtol=1e-4, atol=1e-4)
    mean, var = _bn_stats(pm)
    np.testing.assert_allclose(mean, np.asarray(mut["batch_stats"]["mean"]), atol=1e-6)
    np.testing.assert_allclose(var, np.asarray(mut["batch_stats"]["var"]), atol=1e-6)
    biased = x.reshape(-1, 8).var(0)
    np.testing.assert_allclose(var, 0.99 * 1.0 + 0.01 * biased, atol=1e-6)
    # eval mode after the update normalises with the moved statistics
    pm.eval()
    y_eval = pm(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    ref = jm.apply({"params": v["params"], **mut}, jnp.asarray(x), False)
    np.testing.assert_allclose(y_eval.detach().numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)
