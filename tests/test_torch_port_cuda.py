"""Tests of the port that need a CUDA card (marker ``cuda``): kernels A1 and
A2 have no CPU or interpret mode. They skip without a card. This file imports no JAX, so
it also runs where JAX is not installed:

    python -m pytest tests/test_torch_port_cuda.py --noconftest -m cuda
"""
import numpy as np
import pytest
import torch

from cpd_tpu_torch.ops import sparse
from cpd_tpu_torch.ops.gather_gemm import (gather_gemm, gather_gemm_dw,
                                           gather_gemm_dw_reference, gather_gemm_reference)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: kernels A1 and A2 have no CPU or interpret mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n,k,cin,cout", [(1000, 27, 5, 16), (777, 27, 32, 64),
                                          (300, 3, 128, 128), (64, 27, 16, 200)])
def test_gather_gemm_kernel_matches_plain(cuda, n, k, cin, cout):
    """Kernel A1 against its plain version: f32 to 1e-4 (TF32 off); bf16
    operands and output within rtol 1e-2 + 1e-2 of the output scale. Junk
    idx where found is False is never read."""
    rng = np.random.default_rng(n)
    table = torch.from_numpy(rng.normal(size=(2, 600, cin)).astype(np.float32)).to(cuda)
    found = torch.from_numpy(rng.random((2, n, k)) < 0.5).to(cuda)
    idx = torch.from_numpy(rng.integers(0, 600, (2, n, k)).astype(np.int32)).to(cuda)
    idx = torch.where(found, idx, 10**8).to(torch.int32)
    w = torch.from_numpy(rng.normal(size=(k * cin, cout)).astype(np.float32)).to(cuda)
    launches = gather_gemm.launches
    out = gather_gemm(table, idx, found, w)
    torch.testing.assert_close(out, gather_gemm_reference(table, idx, found, w),
                               rtol=1e-4, atol=1e-4)
    tb, wb = table.bfloat16(), w.bfloat16()
    out = gather_gemm(tb, idx, found, wb, out_dtype=torch.bfloat16).float()
    ref = gather_gemm_reference(tb, idx, found, wb)
    assert float((out - ref).abs().max()) <= 1e-2 * float(ref.abs().max())
    assert gather_gemm.launches == launches + 2


@pytest.mark.cuda
def test_gather_gemm_rejects_non_contiguous(cuda):
    table = torch.zeros(1, 8, 4, device=cuda)
    idx = torch.zeros(1, 3, 2, dtype=torch.int32, device=cuda)
    found = torch.ones(1, 3, 2, dtype=torch.bool, device=cuda)
    w = torch.zeros(4, 8, device=cuda).T  # (8, 4) view, not contiguous
    with pytest.raises(ValueError):
        gather_gemm(table, idx, found, w)


@pytest.mark.cuda
def test_sparse_conv_on_card_matches_cpu(cuda):
    """A strided sparse conv built and run on the card equals the CPU path."""
    rng = np.random.default_rng(0)
    grid = sparse.GridSpec(40, 36, 21)
    keys = np.full((1, 3000), sparse.INVALID_KEY, np.int32)
    keys[0, :2500] = np.sort(rng.choice(grid.num_cells, 2500, replace=False))
    feats = torch.from_numpy(rng.normal(size=(1, 3000, 16)).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(27, 16, 32)) * 0.1).astype(np.float32))
    outs = []
    for dev in ("cpu", cuda):
        rb, _ = sparse.build_conv_rulebook_batched(torch.from_numpy(keys).to(dev), grid,
                                                   (3, 3, 3), (2, 2, 2), (1, 1, 1), 2500)
        outs.append((rb, sparse.sparse_conv_apply_batched(feats.to(dev), rb, w.to(dev))))
    (rb_c, out_c), (rb_g, out_g) = outs
    assert torch.equal(rb_c.out_keys, rb_g.out_keys.cpu())
    assert torch.equal(rb_c.found, rb_g.found.cpu())
    torch.testing.assert_close(out_g.cpu(), out_c, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("n,k,cin,cout", [(1000, 27, 5, 16), (5000, 27, 32, 64),
                                          (300, 3, 128, 128), (2049, 27, 16, 200),
                                          (77, 27, 130, 70)])
def test_gather_gemm_dw_kernel_matches_plain(cuda, n, k, cin, cout):
    """Kernel A2 against its plain version: f32 to 1e-4 of the output's scale
    (a sum over the rows in another order, TF32 off), bf16 operands to 1e-3
    of it (the same rounded operands, f32 sums). Junk idx where found is
    False is never read; rows are not a multiple of the chunk; Cin and Cout
    are not multiples of the tile. The result is the same bits twice."""
    rng = np.random.default_rng(n)
    table = torch.from_numpy(rng.normal(size=(2, 600, cin)).astype(np.float32)).to(cuda)
    found = torch.from_numpy(rng.random((2, n, k)) < 0.3).to(cuda)
    idx = torch.from_numpy(rng.integers(0, 600, (2, n, k)).astype(np.int32)).to(cuda)
    idx = torch.where(found, idx, 10**8).to(torch.int32)
    g = torch.from_numpy(rng.normal(size=(2, n, cout)).astype(np.float32)).to(cuda)
    launches = gather_gemm_dw.launches
    out = gather_gemm_dw(table, idx, found, g)
    ref = gather_gemm_dw_reference(table, idx, found, g)
    torch.cuda.synchronize()
    assert float((out - ref).abs().max()) <= 1e-4 * float(ref.abs().max())
    assert torch.equal(out, gather_gemm_dw(table, idx, found, g))
    tb, gb = table.bfloat16(), g.bfloat16()
    out = gather_gemm_dw(tb, idx, found, gb)
    ref = gather_gemm_dw_reference(tb, idx, found, gb)
    assert out.dtype == torch.float32
    assert float((out - ref).abs().max()) <= 1e-3 * float(ref.abs().max())
    assert gather_gemm_dw.launches == launches + 3


@pytest.mark.cuda
def test_gather_gemm_dw_rejects_non_contiguous(cuda):
    table = torch.zeros(1, 8, 4, device=cuda)
    idx = torch.zeros(1, 3, 2, dtype=torch.int32, device=cuda)
    found = torch.ones(1, 3, 2, dtype=torch.bool, device=cuda)
    g = torch.zeros(1, 6, 3, device=cuda).transpose(1, 2)  # (1, 3, 6) view
    with pytest.raises(ValueError):
        gather_gemm_dw(table, idx, found, g)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["mirror", "strided"])
def test_sparse_conv_backward_on_card_matches_cpu(cuda, kind):
    """The autograd Function on the card (A1 for dX, A2 for dW) against the
    CPU path (the plain versions), f32, 1e-4 of each gradient's scale."""
    rng = np.random.default_rng(1)
    grid = sparse.GridSpec(40, 36, 21)
    keys = np.full((2, 3000), sparse.INVALID_KEY, np.int32)
    for b in range(2):
        keys[b, :2500] = np.sort(rng.choice(grid.num_cells, 2500, replace=False))
    feats = torch.from_numpy(rng.normal(size=(2, 3000, 16)).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(27, 16, 32)) * 0.1).astype(np.float32))
    grads = []
    for dev in ("cpu", cuda):
        k = torch.from_numpy(keys).to(dev)
        if kind == "mirror":
            rb = sparse.build_subm_rulebook_batched(k, grid)
            rb_t = sparse.mirror_rulebook(rb)
        else:
            geom = ((3, 3, 3), (2, 2, 2), (1, 1, 1))
            rb, out_grid = sparse.build_conv_rulebook_batched(k, grid, *geom, 2600)
            rb_t = sparse.build_inverse_rulebook_batched(k, rb.out_keys, grid, out_grid, *geom)
        cot = torch.from_numpy(np.random.default_rng(2).normal(
            size=(2, rb.idx.shape[1], 32)).astype(np.float32)).to(dev)
        x, wd = feats.clone().to(dev).requires_grad_(), w.clone().to(dev).requires_grad_()
        a1, a2 = gather_gemm.launches, gather_gemm_dw.launches
        out = sparse.sparse_conv_apply_batched(x, rb, wd, transpose=rb_t)
        (out * cot).sum().backward()
        if dev != "cpu":
            assert (gather_gemm.launches - a1, gather_gemm_dw.launches - a2) == (2, 1)
        grads.append((x.grad.cpu(), wd.grad.cpu()))
    for got, want in zip(grads[1], grads[0]):
        assert float(want.abs().max()) > 1e-3
        assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())
