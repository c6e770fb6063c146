"""Tests of the port that need a CUDA card (marker ``cuda``): kernels A1, A2,
G1-G4, R1 and R2 have no CPU or interpret mode. They skip without a card. This file
imports no JAX, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_port_cuda.py --noconftest -m cuda
"""
import numpy as np
import pytest
import torch

from cpd_tpu_torch.models import backbone3d
from cpd_tpu_torch.ops import gather_probes as gp
from cpd_tpu_torch.ops import sparse
from cpd_tpu_torch.ops import gather_gemm as gg
from cpd_tpu_torch.ops.gather_gemm import (gather_gemm, gather_gemm_dw,
                                           gather_gemm_dw_reference, gather_gemm_reference)
from cpd_tpu_torch.ops.voxelizer import VoxelizerSpec, voxelize_batch
from cpd_tpu_torch.utils.synthetic import make_lidar_frame
from cpd_tpu_torch.utils.weights import seeded_state_dict


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU or interpret mode")
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


def _rulebook(rng, b, n, k, v, case):
    """(idx, found, plain idx, plain found) on the CPU for one trap: the
    kernels get junk under unfound taps and found taps outside the table; the
    plain versions get the same rulebook with those taps unfound."""
    found = rng.random((b, n, k)) < 0.3
    idx = rng.integers(0, v, (b, n, k))
    if case == "empty_tile":      # no found tap in the first 300 rows
        found[:, :300] = False
    elif case == "all_found":
        found[:] = True
    elif case == "same_row":      # every hit reads one of three table rows
        idx = rng.integers(0, 3, (b, n, k))
    elif case == "outside":       # found taps pointing outside the table: dropped
        idx[rng.random((b, n, k)) < 0.1] = v + 5
        idx[rng.random((b, n, k)) < 0.1] = -1
    inside = (idx >= 0) & (idx < v)
    junk = np.where(found, idx, 10**8).astype(np.int32)
    return (torch.from_numpy(junk), torch.from_numpy(found),
            torch.from_numpy(np.where(found & inside, idx, 0).astype(np.int32)),
            torch.from_numpy(found & inside))


# b, n, k, cin, cout: ragged rows, K = 3, 5-channel rows, wide -> narrow (the
# dX of a strided conv), more channels than one tile or staged depth holds
TRAP_SHAPES = [(2, 1000, 27, 5, 16), (1, 1237, 27, 16, 16), (2, 777, 27, 64, 32),
               (2, 531, 27, 128, 64), (1, 300, 3, 128, 128), (2, 333, 27, 16, 32),
               (1, 600, 27, 32, 32), (1, 450, 27, 64, 128), (1, 90, 27, 130, 70),
               (1, 129, 40, 24, 136)]
TRAP_CASES = ["plain", "empty_tile", "all_found", "same_row", "outside"]


def _close(out, ref, rel, what):
    assert out.shape == ref.shape, what
    scale = max(float(ref.abs().max()), 1e-3)
    err = float((out.float() - ref).abs().max())
    assert err <= rel * scale, f"{what}: max err {err} at scale {scale}"


@pytest.mark.cuda
@pytest.mark.parametrize("case", TRAP_CASES)
@pytest.mark.parametrize("b,n,k,cin,cout", TRAP_SHAPES)
def test_gather_gemm_kernel_traps(cuda, b, n, k, cin, cout, case):
    """Kernel A1 on every trap of its inputs, f32 and bf16 operands, f32 and
    bf16 outputs, at every tile size: f32 within 1e-4 of the output's scale;
    bf16 operands with the f32 output within 1e-4 too (the same rounded
    operands, f32 sums), with the bf16 output within 1e-2 (its rounding); a
    second launch gives the same bits."""
    rng = np.random.default_rng(n + k + cin)
    v = 400
    idx, found, p_idx, p_found = (t.to(cuda) for t in _rulebook(rng, b, n, k, v, case))
    table = torch.from_numpy(rng.normal(size=(b, v, cin)).astype(np.float32)).to(cuda)
    w = torch.from_numpy((rng.normal(size=(k * cin, cout)) * 0.1).astype(np.float32)).to(cuda)
    for dtype in (torch.float32, torch.bfloat16):
        t, ww = table.to(dtype), w.to(dtype)
        ref = gather_gemm_reference(t, p_idx, p_found, ww)
        for tile_rows in (None, 64, 128, 256):
            if tile_rows and gg.a1_smem_bytes(tile_rows, k, cin, cout,
                                              t.element_size()) > gg.MAX_SMEM:
                continue
            what = f"{case} {dtype} tile {tile_rows}"
            out = gather_gemm(t, idx, found, ww, tile_rows=tile_rows)
            _close(out, ref, 1e-4, what)
            assert torch.equal(out, gather_gemm(t, idx, found, ww, tile_rows=tile_rows)), what
            out16 = gather_gemm(t, idx, found, ww, out_dtype=torch.bfloat16, tile_rows=tile_rows)
            assert out16.dtype == torch.bfloat16
            assert torch.equal(out16, out.bfloat16()), what  # the same sums, rounded once
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("case", TRAP_CASES)
@pytest.mark.parametrize("b,n,k,cin,cout", TRAP_SHAPES)
def test_gather_gemm_dw_kernel_traps(cuda, b, n, k, cin, cout, case):
    """Kernel A2 on the same traps, f32 and bf16 operands, with its own plan
    and with forced ones (one tap a block over long chunks, all taps over
    short ones): 1e-4 of the output's scale, the same bits twice."""
    rng = np.random.default_rng(n + k + cout)
    v = 400
    idx, found, p_idx, p_found = (t.to(cuda) for t in _rulebook(rng, b, n, k, v, case))
    table = torch.from_numpy(rng.normal(size=(b, v, cin)).astype(np.float32)).to(cuda)
    g = torch.from_numpy(rng.normal(size=(b, n, cout)).astype(np.float32)).to(cuda)
    for dtype in (torch.float32, torch.bfloat16):
        t, gd = table.to(dtype), g.to(dtype)
        ref = gather_gemm_dw_reference(t, p_idx, p_found, gd)
        for plan in (None, (512, 1), (32, min(k, 32)), (160, 9)):
            what = f"{case} {dtype} plan {plan}"
            out = gather_gemm_dw(t, idx, found, gd, plan=plan)
            assert out.dtype == torch.float32
            _close(out, ref, 1e-4, what)
            assert torch.equal(out, gather_gemm_dw(t, idx, found, gd, plan=plan)), what
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_kernels_ask_for_the_shared_memory_the_wrapper_counts(cuda):
    """``a1_smem_bytes`` / ``a2_smem_bytes`` (which choose the tile and are
    tested on the CPU) equal what the built kernels compute for a launch."""
    for code, itemsize in ((0, 4), (1, 2)):
        for k, cin, cout in [(27, 5, 16), (27, 16, 32), (27, 64, 64), (27, 128, 128),
                             (3, 128, 128), (40, 24, 136)]:
            for tm in (64, 128, 256):
                assert (gg.kernel_smem_bytes("gather_gemm", k, cin, cout, code, tm)
                        == gg.a1_smem_bytes(tm, k, cin, cout, itemsize))
            for chunk_rows, taps in [(288, 27), (896, 9), (4096, 1)]:
                assert (gg.kernel_smem_bytes("gather_gemm_dw", cin, cout, chunk_rows, taps, code)
                        == gg.a2_smem_bytes(chunk_rows, taps, cin, cout, itemsize))


@pytest.mark.cuda
def test_a_refused_launch_raises(cuda):
    """More shared memory than a block may have: the launch is refused and
    the wrapper raises (it never falls back to the plain version)."""
    table = torch.zeros(1, 8, 128, device=cuda)
    idx = torch.zeros(1, 64, 27, dtype=torch.int32, device=cuda)
    found = torch.ones(1, 64, 27, dtype=torch.bool, device=cuda)
    w = torch.zeros(27 * 128, 128, device=cuda)
    with pytest.raises(RuntimeError, match="CUDA error"):
        gather_gemm(table, idx, found, w, tile_rows=1024)
    with pytest.raises(RuntimeError, match="CUDA error"):
        gather_gemm_dw(table, idx, found, torch.zeros(1, 64, 128, device=cuda), plan=(8192, 27))
    torch.cuda.synchronize()
    out = gather_gemm(table, idx, found, w)  # the card is still usable
    assert float(out.abs().max()) == 0.0


def _probe_operands(cuda, n, k, cin, cout, seed, v=600, density=0.4):
    """f32 operands with junk idx under every unfound tap and a few found
    taps pointing outside the table (which the kernels must drop)."""
    rng = np.random.default_rng(seed)
    table = torch.from_numpy(rng.normal(size=(v, cin)).astype(np.float32)).to(cuda)
    found = torch.from_numpy(rng.random((n, k)) < density).to(cuda)
    idx = rng.integers(0, v, (n, k)).astype(np.int32)
    idx[rng.random((n, k)) < 0.02] = v + 7
    idx[rng.random((n, k)) < 0.02] = -3
    idx = torch.where(found, torch.from_numpy(idx).to(cuda), 10**8).to(torch.int32)
    w = torch.from_numpy((rng.normal(size=(k * cin, cout)) * 0.1).astype(np.float32)).to(cuda)
    return table, idx, found, w


def _close_to_plain(out, ref, rel):
    assert out.shape == ref.shape and out.dtype == torch.float32
    scale = float(ref.abs().max())
    assert scale > 1e-3
    assert float((out - ref).abs().max()) <= rel * scale


PROBE_SHAPES = [(1000, 27, 5, 16), (777, 27, 32, 64), (300, 3, 128, 128), (65, 27, 16, 200),
                (2049, 27, 64, 32), (513, 27, 48, 16)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,k,cin,cout", PROBE_SHAPES)
def test_gather_gemm_flat_kernel_matches_plain(cuda, n, k, cin, cout):
    """Kernel G1 against its plain version on ragged sizes, K = 3, 5-channel
    rows (no 16-byte loads), junk idx under unfound taps, idx outside the
    table, at both tile heights: f32 (exact FMAs) to 1e-4 of the output's
    scale; f32 rounded to bf16 in the kernel and bf16 operands (tensor cores)
    to 1e-4 too (the plain version rounds the same operands and both sum in
    f32); with and without ``found``; a second launch gives the same bits."""
    table, idx, found, w = _probe_operands(cuda, n, k, cin, cout, n)
    tb, wb = table.bfloat16(), w.bfloat16()
    inside = idx.clamp(0, table.shape[0] - 1)  # without found every idx is read
    launches = gp.gather_gemm_flat.launches
    for tile_rows in (None, 64, 128):
        for t, i, f, ww, rb in ((table, idx, found, w, False), (table, idx, found, w, True),
                                (tb, idx, found, wb, False), (table, inside, None, w, False),
                                (tb, inside, None, wb, False)):
            out = gp.gather_gemm_flat(t, i, f, ww, rb, tile_rows=tile_rows)
            _close_to_plain(out, gp.gather_gemm_flat_reference(t, i, f, ww, rb), 1e-4)
            assert torch.equal(out, gp.gather_gemm_flat(t, i, f, ww, rb, tile_rows=tile_rows))
    torch.cuda.synchronize()
    assert gp.gather_gemm_flat.launches == launches + 30


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,round_bf16", [(torch.float32, False), (torch.float32, True),
                                              (torch.bfloat16, False)])
@pytest.mark.parametrize("tile_rows", [64, 128])
def test_gather_gemm_flat_kernel_skips_tiles_that_find_nothing(cuda, tile_rows, dtype,
                                                               round_bf16):
    """A rulebook padded to its cap: rows from 300 on find nothing, so the
    tiles past it are written as zeros and never multiplied (with NaN
    weights the live tiles turn NaN and the skipped ones stay exactly 0);
    with finite weights all of it equals the plain version and the CPU
    restatement of the kernel's tiles."""
    n, k, cin, cout = 1000, 27, 16, 32
    table, idx, found, w = _probe_operands(cuda, n, k, cin, cout, 5)
    found[300:] = False
    idx = torch.where(found, idx, 10**8).to(torch.int32)
    t, ww = table.to(dtype), w.to(dtype)
    out = gp.gather_gemm_flat(t, idx, found, torch.full_like(ww, float("nan")), round_bf16,
                              tile_rows=tile_rows)
    first_dead = -(-300 // tile_rows) * tile_rows
    assert torch.equal(out[first_dead:], torch.zeros_like(out[first_dead:]))
    assert bool(out[:300].isnan().all())
    out = gp.gather_gemm_flat(t, idx, found, ww, round_bf16, tile_rows=tile_rows)
    _close_to_plain(out, gp.gather_gemm_flat_reference(t, idx, found, ww, round_bf16), 1e-4)
    tiled = gp.gather_gemm_flat_tiled(t.cpu(), idx.cpu(), found.cpu(), ww.cpu(), round_bf16,
                                      tile_rows)
    _close_to_plain(out.cpu(), tiled, 1e-4)  # the CPU restatement of the kernel's order


@pytest.mark.cuda
def test_gather_gemm_flat_kernel_asks_for_the_shared_memory_the_wrapper_counts(cuda):
    """``g1_smem_bytes`` (which chooses the tile, tested on the CPU) equals what
    the built kernel computes for a launch."""
    for code, round_bf16, itemsize in ((0, 0, 4), (0, 1, 2), (1, 0, 2)):
        for k, cout in [(27, 16), (27, 32), (27, 64), (27, 128), (3, 128), (27, 200), (256, 7)]:
            for tm in (64, 128):
                assert (gg.kernel_smem_bytes("gather_gemm_flat", k, cout, code, round_bf16, tm)
                        == gp.g1_smem_bytes(tm, k, cout, itemsize))
    table, idx, found, w = _probe_operands(cuda, 64, 3, 8, 16, 0)
    with pytest.raises(RuntimeError, match="CUDA error"):  # no instance of 96 rows
        gp.gather_gemm_flat(table, idx, found, w, tile_rows=96)


@pytest.mark.cuda
@pytest.mark.parametrize("n,k,cin,cout", PROBE_SHAPES)
def test_gather_gemm_per_tap_kernel_matches_plain(cuda, n, k, cin, cout):
    """Kernel G2 (A1's entry point for f32 operands and Cout 200, its own
    kernel for bf16 up to Cout 128) against its plain version, f32 and bf16
    operands, 1e-4 of the output's scale; the same bits twice."""
    table, idx, found, w = _probe_operands(cuda, n, k, cin, cout, n + 1)
    w = w.reshape(k, cin, cout)
    launches = gp.gather_gemm_per_tap.launches
    out = gp.gather_gemm_per_tap(table, idx, found, w)
    _close_to_plain(out, gp.gather_gemm_per_tap_reference(table, idx, found, w), 1e-4)
    assert torch.equal(out, gp.gather_gemm_per_tap(table, idx, found, w))
    tb, wb = table.bfloat16(), w.bfloat16()
    out = gp.gather_gemm_per_tap(tb, idx, found, wb)
    _close_to_plain(out, gp.gather_gemm_per_tap_reference(tb, idx, found, wb), 1e-4)
    torch.cuda.synchronize()
    assert gp.gather_gemm_per_tap.launches == launches + 3


def _g2_edge_k(cin, cout):
    """The largest K at which G2's own kernel takes bf16 cin -> cout."""
    return max(k for k in range(1, 64) if gp.g2_route(k, cin, cout, torch.bfloat16) == "own")


# (n, k, cin, cout): P3's widths, 5-channel rows (scalar loads), K = 3, ragged
# last tiles, Cin past one MMA depth, Cout not a multiple of 4 (scalar
# stores), the widest W of K = 3, 32 -> 64, and 64 -> 64 just inside and
# just outside the shared-memory budget
G2_TRAP_SHAPES = [(2049, 27, 16, 16), (1000, 27, 5, 16), (131, 3, 16, 32), (97, 27, 48, 16),
                  (65, 27, 12, 7), (300, 3, 128, 128), (777, 27, 32, 64),
                  (333, "edge", 64, 64), (333, "past edge", 64, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("n,k,cin,cout", G2_TRAP_SHAPES)
def test_gather_gemm_per_tap_routes_and_traps(cuda, n, k, cin, cout, dtype):
    """Kernel G2 on both routes (its own kernel for bf16 W that fits, A1's
    entry point for f32 and wider W): junk idx under unfound taps, NaN in
    every table row no found tap reads, idx outside the table, rows 32-95
    finding nothing; equal to the plain version and to the CPU restatement
    within rtol 1e-4 + 1e-4 of the output's scale, the same bits twice (and
    at one warp a block), one launch counted per call by G2 and none by A1."""
    if isinstance(k, str):
        k = _g2_edge_k(cin, cout) + (k == "past edge")
    table, idx, found, w = _probe_operands(cuda, n, k, cin, cout, n + k + cin)
    found[32:96] = False
    idx = torch.where(found, idx, 10**8).to(torch.int32)
    table = _unread_rows_nan(table, idx, found)
    t, ww = table.to(dtype), w.reshape(k, cin, cout).to(dtype)
    route = gp.g2_route(k, cin, cout, dtype)
    assert route == ("own" if dtype == torch.bfloat16 and k != _g2_edge_k(cin, cout) + 1
                     else "A1")
    launches, a1 = gp.gather_gemm_per_tap.launches, gather_gemm.launches
    out = gp.gather_gemm_per_tap(t, idx, found, ww)
    again = gp.gather_gemm_per_tap(t, idx, found, ww)
    torch.cuda.synchronize()
    assert (gp.gather_gemm_per_tap.launches, gather_gemm.launches) == (launches + 2, a1)
    assert bool(torch.isfinite(out).all())
    assert torch.equal(out, again)
    if route == "own":  # a tile's sum does not depend on how many warps share the tiles
        assert torch.equal(out, gp.gather_gemm_per_tap(t, idx, found, ww, warps=1))
    assert torch.equal(out[32:96], torch.zeros_like(out[32:96]))
    ref = gp.gather_gemm_per_tap_reference(t, idx, found, ww)
    tiled = gp.gather_gemm_per_tap_tiled(t.cpu(), idx.cpu(), found.cpu(), ww.cpu())
    for want in (ref.cpu(), tiled):
        scale = float(want.abs().max())
        assert float(((out.cpu() - want).abs() - 1e-4 * want.abs()).max()) <= 1e-4 * scale


@pytest.mark.cuda
def test_gather_gemm_per_tap_kernel_asks_for_the_shared_memory_the_wrapper_counts(cuda):
    """``g2_smem_bytes`` (which sizes the warps of a block, tested on the CPU)
    equals what the built kernel computes for a launch; the entry point
    refuses f32 operands (they go to A1), no warps, more warps than its
    width's cap."""
    from cpd_tpu_torch.ops.cuda_build import load
    for n, k, cin, cout in [(150_016, 27, 16, 16), (90_000, 27, 5, 16), (80_000, 27, 16, 32),
                            (80_000, 27, 32, 32), (48_000, 27, 32, 64), (20_000, 3, 128, 128),
                            (100, 4, 48, 7), (1000, _g2_edge_k(64, 64), 64, 64)]:
        for warps in (gp.g2_warps(n, k, cin, cout), gp.g2_max_warps(k, cin, cout)):
            assert (gg.kernel_smem_bytes("gather_gemm_per_tap", k, cin, cout, warps)
                    == gp.g2_smem_bytes(k, cin, cout, warps))
    table, idx, found, w = _probe_operands(cuda, 64, 3, 8, 16, 0)
    fn = load("gather_gemm_per_tap", gp._ARGTYPES["gather_gemm_per_tap"])
    out = torch.empty(64, 16, device=cuda)
    tb, wb = table.bfloat16(), w.bfloat16()
    stream = torch.cuda.current_stream().cuda_stream
    for t, ww, code, warps in ((table, w, 0, 4), (tb, wb, 1, 0), (tb, wb, 1, 33)):
        err = fn(t.data_ptr(), idx.data_ptr(), found.data_ptr(), ww.data_ptr(), out.data_ptr(),
                 table.shape[0], 64, 3, 8, 16, code, warps, stream)
        assert err != 0
    out = gp.gather_gemm_per_tap(tb, idx, found, wb.reshape(3, 8, 16))  # the card is still usable
    torch.cuda.synchronize()
    _close_to_plain(out, gp.gather_gemm_per_tap_reference(tb, idx, found, wb.reshape(3, 8, 16)),
                    1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("n,k,cin,cout", PROBE_SHAPES)
def test_lane_gather_gemm_kernel_matches_plain(cuda, n, k, cin, cout):
    """Kernel G3 on the transposed table against its plain version and
    against kernel G1 on the row-major table, with and without ``found``."""
    table, idx, found, w = _probe_operands(cuda, n, k, cin, cout, n + 2)
    table_t = table.T.contiguous()
    launches = gp.lane_gather_gemm.launches
    out = gp.lane_gather_gemm(table_t, idx, w, found)
    _close_to_plain(out, gp.lane_gather_gemm_reference(table_t, idx, w, found), 1e-4)
    _close_to_plain(out, gp.gather_gemm_flat(table, idx, found, w), 1e-4)
    assert torch.equal(out, gp.lane_gather_gemm(table_t, idx, w, found))
    inside = idx.clamp(0, table.shape[0] - 1)
    out = gp.lane_gather_gemm(table_t.bfloat16(), inside, w.bfloat16())
    _close_to_plain(out, gp.lane_gather_gemm_reference(table_t.bfloat16(), inside, w.bfloat16()),
                    1e-4)
    torch.cuda.synchronize()
    assert gp.lane_gather_gemm.launches == launches + 3


@pytest.mark.cuda
@pytest.mark.parametrize("n,k,c,tile", [(1000, 27, 5, 256), (777, 27, 64, 64), (300, 3, 128, 7)])
def test_lane_gather_kernel_equals_plain(cuda, n, k, c, tile):
    """Kernel G4 equals its plain version and ``index_select`` bit for bit;
    rows past the last whole tile are not covered; an idx outside the table
    gives zeros."""
    table, idx, _, _ = _probe_operands(cuda, n, k, c, 1, n + 3)
    table_t = table.T.contiguous()
    inside = idx.clamp(0, table.shape[0] - 1)
    launches = gp.lane_gather.launches
    out = gp.lane_gather(table_t, inside, tile)
    tiles = n // tile
    assert out.shape == (tiles, c, tile * k)
    assert torch.equal(out, gp.lane_gather_reference(table_t, inside, tile))
    lib = torch.index_select(table_t, 1, inside.reshape(-1)[:tiles * tile * k])
    assert torch.equal(out, lib.reshape(c, tiles, tile * k).permute(1, 0, 2))
    assert torch.equal(gp.lane_gather(table_t, idx, tile),
                       gp.lane_gather_reference(table_t, idx, tile))
    out = gp.lane_gather(table_t.bfloat16(), inside, tile)
    assert torch.equal(out, gp.lane_gather_reference(table_t.bfloat16(), inside, tile))
    torch.cuda.synchronize()
    assert gp.lane_gather.launches == launches + 3


def _same_bits(a, b):
    """Bit-equal, NaN included (``torch.equal`` calls NaN unequal to itself)."""
    return a.dtype == b.dtype and torch.equal(a.reshape(-1).view(torch.uint8),
                                              b.reshape(-1).view(torch.uint8))


def _unread_rows_nan(table, idx, found):
    """The table with NaN in every row that no found tap with an idx inside
    the table reads: a kernel that reads one of them shows it."""
    v = table.shape[0]
    ok = (idx >= 0) & (idx < v)
    if found is not None:
        ok = ok & found
    read = torch.zeros(v, dtype=torch.bool, device=table.device)
    read[idx[ok].long()] = True
    return torch.where(read[:, None], table, float("nan"))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("n,k,cin,cout", [(1000, 27, 5, 16), (300, 3, 16, 32), (777, 27, 64, 64),
                                          (129, 27, 32, 128), (65, 27, 16, 200)])
def test_lane_gather_gemm_kernel_traps(cuda, n, k, cin, cout, dtype):
    """Kernel G3 after the transpose: junk idx under unfound taps and NaN in
    every table row no found tap reads, idx outside the table, K = 3,
    5-channel rows, ragged tiles, Cout 16 to 200: equal to the plain version
    and to the CPU restatement within 1e-4 of the output's scale (f32: its
    own exact product; bf16: G1's, which does not count a launch of its
    own); ``table_t`` left as it was; the same bits twice."""
    table, idx, found, w = _probe_operands(cuda, n, k, cin, cout, n + 4)
    table = _unread_rows_nan(table, idx, found)
    table_t, ww = table.T.contiguous().to(dtype), w.to(dtype)
    before = table_t.clone()
    launches, g1 = gp.lane_gather_gemm.launches, gp.gather_gemm_flat.launches
    out = gp.lane_gather_gemm(table_t, idx, ww, found)
    assert bool(torch.isfinite(out).all())
    _close_to_plain(out, gp.lane_gather_gemm_reference(table_t, idx, ww, found), 1e-4)
    tiled = gp.lane_gather_gemm_tiled(table_t.cpu(), idx.cpu(), ww.cpu(), found.cpu())
    _close_to_plain(out.cpu(), tiled, 1e-4)
    assert torch.equal(out, gp.lane_gather_gemm(table_t, idx, ww, found))
    torch.cuda.synchronize()
    assert _same_bits(table_t, before)
    assert gp.lane_gather_gemm.launches == launches + 2
    assert gp.gather_gemm_flat.launches == g1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("n,k,c,tile", [(1000, 27, 5, 256), (777, 27, 64, 64), (300, 3, 128, 7),
                                        (300, 27, 72, 10), (256, 27, 16, 256)])
def test_lane_gather_kernel_traps(cuda, n, k, c, tile, dtype):
    """Kernel G4 after the transpose: NaN in every table row that no
    gathered position reads, idx outside the table (zeros), ragged runs of
    positions and tile lengths not a multiple of 4 (scalar stores), two
    passes at 72 channels: bit-equal to the plain version and the CPU
    restatement; ``table_t`` left as it was; the same bits twice."""
    table, idx, _, _ = _probe_operands(cuda, n, k, c, 1, n + 5)
    tiles = n // tile
    covered = idx.reshape(-1)[:tiles * tile * k].reshape(-1, 1)
    table = _unread_rows_nan(table, covered, None)
    table_t = table.T.contiguous().to(dtype)
    before = table_t.clone()
    launches = gp.lane_gather.launches
    out = gp.lane_gather(table_t, idx, tile)
    assert bool(torch.isfinite(out).all())
    assert torch.equal(out, gp.lane_gather_reference(table_t, idx, tile))
    assert torch.equal(out.cpu(), gp.lane_gather_tiled(table_t.cpu(), idx.cpu(), tile))
    assert torch.equal(out, gp.lane_gather(table_t, idx, tile))
    torch.cuda.synchronize()
    assert _same_bits(table_t, before)
    assert gp.lane_gather.launches == launches + 2


@pytest.mark.cuda
def test_lane_transpose_is_exact(cuda):
    """The transpose that G3 and G4 start with: the row-major copy equals
    ``table_t.T`` bit for bit, f32 and bf16, at widths below, at and above
    its tile of 32 and at the probes' 64 x 48,000."""
    rng = np.random.default_rng(9)
    for c, v in [(5, 37), (32, 64), (33, 1000), (64, 48_000), (128, 24_001)]:
        table_t = torch.from_numpy(rng.normal(size=(c, v)).astype(np.float32)).to(cuda)
        for t in (table_t, table_t.bfloat16()):
            rows = gp.lane_rows(t)
            assert rows.shape == (v, c) and rows.dtype == t.dtype
            assert torch.equal(rows, t.T)


@pytest.mark.cuda
def test_lane_gather_gemm_kernel_asks_for_the_shared_memory_the_wrapper_counts(cuda):
    """``g3_smem_bytes`` equals what the built f32 product computes for a
    launch, and its bf16 operands never reach it (the entry point refuses
    them: they go to G1)."""
    import ctypes
    from cpd_tpu_torch.ops.cuda_build import load
    smem = load("lane_gather_gemm", [ctypes.c_int] * 2, symbol="cpd_lane_gather_gemm_smem")
    for k, cout in [(27, 16), (27, 32), (27, 64), (27, 128), (3, 128), (27, 200), (256, 7)]:
        assert smem(k, cout) == gp.g3_smem_bytes(k, cout)
    table, idx, found, w = _probe_operands(cuda, 64, 3, 8, 16, 0)
    fn = load("lane_gather_gemm", gp._ARGTYPES["lane_gather_gemm"])
    out = torch.empty(64, 16, device=cuda)
    tb, wb = table.bfloat16(), w.bfloat16()
    err = fn(tb.data_ptr(), idx.data_ptr(), found.data_ptr(), wb.data_ptr(), out.data_ptr(),
             table.shape[0], 64, 3, 8, 16, 1, torch.cuda.current_stream().cuda_stream)
    assert err != 0


@pytest.mark.cuda
def test_probe_kernels_reject_non_contiguous(cuda):
    table, idx, found, w = _probe_operands(cuda, 64, 3, 8, 16, 0)
    with pytest.raises(ValueError):
        gp.gather_gemm_flat(table, idx, found, w.T.contiguous().T)
    with pytest.raises(ValueError):
        gp.lane_gather(table.T, idx, 8)  # (C, V) view of a (V, C) table


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [None, torch.bfloat16], ids=["f32", "bf16"])
def test_dense_tail_on_card_matches_sparse(cuda, dtype):
    """The backbone with the dense tail (cuDNN conv3d on stage 4 and conv_out,
    TF32 off) against the sparse tail (kernel A1) on the card, same weights,
    below the caps: equal key sets; features within 1e-4 of scale at f32 and
    3% at bf16; the BEV map equals the height-compressed sparse output."""
    from cpd_tpu_torch.models.bev import height_compression
    rng = np.random.default_rng(5)
    grid = sparse.GridSpec(48, 40, 26)
    keys = np.full((2, 1500), sparse.INVALID_KEY, np.int32)
    for b in range(2):
        keys[b, :1300] = np.sort(rng.choice(grid.num_cells, 1300, replace=False))
    feats = rng.normal(size=(2, 1500, 5)).astype(np.float32)
    feats[keys == sparse.INVALID_KEY] = 0.0
    outs = {}
    for dense in (False, True):
        model = backbone3d.VoxelResBackBone8x(grid, 5, (8, 16, 32, 64), (1400, 1400, 1400, 1400),
                                              compute_dtype=dtype, dense_tail=dense)
        model.load_state_dict(seeded_state_dict(model, 1))
        model = model.eval().to(cuda)
        with torch.no_grad():
            outs[dense] = model(torch.from_numpy(feats).to(cuda), torch.from_numpy(keys).to(cuda))
    tol = 1e-4 if dtype is None else 0.03
    for name in ("x_conv3", "x_conv4", "encoded"):
        (fs, ks, _), (fd, kd, _) = outs[False][name], outs[True][name]
        assert torch.equal(ks, kd), name
        scale = float(fs.float().abs().max())
        assert scale > 1e-2
        assert float((fs.float() - fd.float()).abs().max()) <= tol * scale, name
    bev_s = height_compression(*outs[False]["encoded"]).float()
    bev_d = outs[True]["encoded_bev"].float()
    assert float((bev_s - bev_d).abs().max()) <= tol * float(bev_s.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("max_points", [None, 5])
def test_voxelizer_gives_the_same_bits_twice(cuda, max_points):
    """The voxelizer on a 200k-point frame at the bench configuration (90k
    voxel cap): two calls give the same bits (the segment sum runs in point
    order, no atomics), and the card agrees with the CPU: integers exactly,
    means within 1e-6 of their scale (the same sums; division rounding)."""
    pts, valid = make_lidar_frame(np.random.default_rng(0), 200_000)
    spec = VoxelizerSpec.create((-75.2, -75.2, -2.0, 75.2, 75.2, 4.0), (0.1, 0.1, 0.15), 90_000,
                                max_points_per_voxel=max_points)
    points, mask = torch.from_numpy(pts)[None], torch.from_numpy(valid)[None]
    first = voxelize_batch(points.to(cuda), spec, mask.to(cuda))
    second = voxelize_batch(points.to(cuda), spec, mask.to(cuda))
    cpu = voxelize_batch(points, spec, mask)
    for name, a, b, c in zip(first._fields, first, second, cpu):
        assert torch.equal(a, b), f"{name}: two calls gave different bits"
        if name == "features":
            scale = float(c.abs().max())
            assert float((a.cpu() - c).abs().max()) <= 1e-6 * scale, name
        else:
            assert torch.equal(a.cpu(), c), name
    assert int(first.valid.sum()) > 10_000


@pytest.mark.cuda
def test_eval_cli_runs_on_the_card_by_default(cuda, tmp_path):
    """``cpd_tpu_torch.tools.test.main`` without ``--device`` runs on the card:
    the shipped yaml cut to a 24 m square and 2 frames of 20k points, its
    weights from a checkpoint; 21 A1 launches a batch, one finite detection
    record a frame, and the CPU run of the same checkpoint finds the same
    frames."""
    import pickle

    from cpd_tpu_torch.config import ConfigDict, cfg_from_list, cfg_from_yaml_file
    from cpd_tpu_torch.models import build_network
    from cpd_tpu_torch.tools import test as eval_cli
    from cpd_tpu_torch.utils.checkpoint import save_checkpoint
    from cpd_tpu_torch.utils.synthetic import write_waymo_sequence

    yaml_file = "tools/cfgs/models/voxel_rcnn_cproto_center.yaml"
    sets = ["DATA_CONFIG.DATA_PATH", str(tmp_path), "DATA_CONFIG.SAMPLED_INTERVAL.test", "1",
            "DATA_CONFIG.POINT_CLOUD_RANGE", "[-12.0,-12.0,-2.0,12.0,12.0,4.0]",
            "DATA_CONFIG.POINT_CAP", "20000"]
    frames = []
    for i in range(2):
        pts, _ = make_lidar_frame(np.random.default_rng(i), 60_000)
        frames.append(pts[(np.abs(pts[:, 0]) < 12) & (np.abs(pts[:, 1]) < 12)])
    write_waymo_sequence(tmp_path, "segment-0000", frames, n_boxes=4, r_max=11.0)
    cfg = cfg_from_list(sets, cfg_from_yaml_file(yaml_file, ConfigDict()))
    model = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), cfg.DATA_CONFIG)
    model.load_state_dict(seeded_state_dict(model, 0), strict=True)
    ckpt = save_checkpoint(tmp_path / "ckpt", model, 0)
    runs = {}
    for device in ("cuda", "cpu"):
        out = tmp_path / device
        argv = ["--cfg_file", yaml_file, "--ckpt", str(ckpt), "--batch_size", "2",
                "--output_dir", str(out)] + (["--device", "cpu"] if device == "cpu" else [])
        gg.gather_gemm.launches = 0
        result = eval_cli.main(argv + ["--set", *sets])
        if device == "cuda":
            torch.cuda.synchronize()
            assert gg.gather_gemm.launches == 21
        with open(out / "result.pkl", "rb") as f:
            runs[device] = pickle.load(f)
        assert result["gt_count"] == 8
    for a, b in zip(runs["cuda"], runs["cpu"]):
        assert a["frame_id"] == b["frame_id"]
        assert np.isfinite(a["boxes_lidar"]).all() and np.isfinite(a["score"]).all()
        assert len(a["score"]) > 0


@pytest.mark.cuda
def test_train_cli_runs_on_the_card_by_default(cuda, tmp_path):
    """``cpd_tpu_torch.tools.train.main`` without ``--device`` trains on the
    card: the shipped yaml cut to a 24 m square and 2 frames of 20k points
    with prototype banks, batch 1, one epoch of 2 steps; every step launches
    A1 35 + 33 times and A2 35 times, its losses are finite with
    ``proto_loss``, and the epoch's checkpoint is written."""
    import json

    from cpd_tpu_torch.tools import train as train_cli
    from cpd_tpu_torch.utils.synthetic import write_waymo_sequence

    yaml_file = "tools/cfgs/models/voxel_rcnn_cproto_center.yaml"
    sets = ["DATA_CONFIG.DATA_PATH", str(tmp_path), "DATA_CONFIG.SAMPLED_INTERVAL.train", "1",
            "DATA_CONFIG.POINT_CLOUD_RANGE", "[-12.0,-12.0,-2.0,12.0,12.0,4.0]",
            "DATA_CONFIG.POINT_CAP", "20000"]
    frames = []
    for i in range(2):
        pts, _ = make_lidar_frame(np.random.default_rng(i), 60_000)
        frames.append(pts[(np.abs(pts[:, 0]) < 12) & (np.abs(pts[:, 1]) < 12)])
    write_waymo_sequence(tmp_path, "segment-0000", frames, n_boxes=4, r_max=11.0, protos=True)
    gg.gather_gemm.launches = gg.gather_gemm_dw.launches = 0
    state = train_cli.main(["--cfg_file", yaml_file, "--batch_size", "1", "--epochs", "1",
                            "--log_every", "1", "--output_dir", str(tmp_path / "out"),
                            "--set", *sets])
    torch.cuda.synchronize()
    assert state.step == 2 and next(state.model.parameters()).device.type == "cuda"
    assert (gg.gather_gemm.launches, gg.gather_gemm_dw.launches) == (2 * (35 + 33), 2 * 35)
    with open(tmp_path / "out" / "metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    assert [r["step"] for r in recs] == [1, 2]
    for r in recs:
        assert "proto_loss" in r and all(np.isfinite(v) for v in r.values())
        assert r["skipped_nonfinite"] == 0.0
    assert (tmp_path / "out" / "ckpt" / "checkpoint_epoch_0.pth").exists()


def _clusters_with_shared_borders(seed, n_centers=40, per=60, noise=400, spread=8.0):
    """f64 blobs close enough to share border points, plus uniform noise."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-spread, spread, (n_centers, 3))
    pts = np.concatenate([c + rng.normal(0, 0.45, (per, 3)) for c in centers]
                         + [rng.uniform(-spread - 2, spread + 2, (noise, 3))])
    return pts[rng.permutation(len(pts))]


@pytest.mark.cuda
@pytest.mark.parametrize("n,m,windows", [(20_000, 100_000, 4), (3_000, 40_000, 12), (5, 0, 3)])
def test_radius_count_kernel_matches_plain(cuda, n, m, windows):
    """Kernel R1 against its plain version: the counts equal exactly (the
    same f32 arithmetic, no FMA contraction), also for queries placed on
    cell edges and for windows with no support point; a second launch gives
    the same counts."""
    from cpd_tpu_torch.ops.radius import radius_count, radius_count_reference

    rng = np.random.default_rng(n)
    query = rng.uniform(-6, 6, (n, 3)).astype(np.float32)
    query[: n // 2] = (np.round(query[: n // 2] / 0.3) * 0.3).astype(np.float32)
    support = rng.uniform(-6, 6, (m, 3)).astype(np.float32)
    window = rng.integers(0, max(windows - 1, 1), m).astype(np.int32)  # the last window empty
    q, s, w = (torch.from_numpy(a).to(cuda) for a in (query, support, window))
    before = radius_count.launches
    out = radius_count(q, s, w, windows, 0.3)
    again = radius_count(q, s, w, windows, 0.3)
    ref = radius_count_reference(q, s, w, windows, 0.3)
    torch.cuda.synchronize()
    assert out.shape == (n, windows) and out.dtype == torch.int32
    assert torch.equal(out, ref) and torch.equal(out, again)
    assert radius_count.launches - before == (2 if n and m else 0)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dbscan_kernel_matches_plain(cuda, seed):
    """Kernel R2 against its plain version on blobs that share border points:
    labels equal on every point, twice (roots are minimum indices, so the
    labels do not depend on thread order); an empty cloud gives no label."""
    from cpd_tpu_torch.ops.dbscan import dbscan_labels, dbscan_reference

    pts = torch.from_numpy(_clusters_with_shared_borders(seed)).to(cuda)
    out = dbscan_labels(pts, 0.4, 5)
    again = dbscan_labels(pts, 0.4, 5)
    ref = dbscan_reference(pts, 0.4, 5)
    torch.cuda.synchronize()
    assert out.dtype == torch.int32 and torch.equal(out, ref) and torch.equal(out, again)
    assert int(out.max()) >= 10
    assert dbscan_labels(torch.zeros((0, 3), dtype=torch.float64, device=cuda), 0.4, 5).numel() == 0


@pytest.mark.cuda
def test_factory_kernels_raise_on_wrong_operands(cuda):
    """The wrappers reject what the kernels do not take, on the card too."""
    from cpd_tpu_torch.ops.dbscan import dbscan_labels
    from cpd_tpu_torch.ops.radius import radius_count

    q = torch.zeros((4, 3), device=cuda)
    with pytest.raises(TypeError):
        radius_count(q, q.double(), torch.zeros(4, dtype=torch.int32, device=cuda), 1, 0.3)
    with pytest.raises(ValueError):
        radius_count(q, q, torch.zeros(4, dtype=torch.int32), 1, 0.3)
    with pytest.raises(TypeError):
        dbscan_labels(q, 0.4, 5)


@pytest.mark.cuda
def test_factory_on_the_card_equals_the_cpu(cuda, tmp_path):
    """The pseudo-label factory (PPScore, MFCF + C_PROTO) on a written
    drive of 12 small frames: on the card (kernels R1 and R2) and on the CPU
    (their plain versions) the same PPScore files, labels and prototype
    banks, bit for bit; both kernels launched."""
    import pickle
    import shutil

    from cpd_tpu_torch.ops.dbscan import dbscan_labels
    from cpd_tpu_torch.ops.radius import radius_count
    from cpd_tpu_torch.unsupervised import driver
    from cpd_tpu_torch.utils.synthetic import make_lidar_sequence, write_waymo_sequence
    from cpd_tpu_torch.utils.yaml_subset import load_file

    frames, poses = make_lidar_sequence(1, n_frames=12, n_points=4000, r_max=14.0, n_parked=3,
                                        n_moving=2, n_walls=1)
    write_waymo_sequence(tmp_path / "card", "seq", frames, poses=poses, labels=False)
    shutil.copytree(tmp_path / "card", tmp_path / "cpu")
    cfg = load_file("tools/cfgs/dataset_configs/waymo_unsupervised_cproto.yaml")
    launches = radius_count.launches, dbscan_labels.launches
    out = {}
    for side, dev in (("card", cuda), ("cpu", "cpu")):
        root = tmp_path / side / "waymo_processed_data"
        driver.save_ppscore(root / "seq", device=dev)
        out[side] = driver.compute_outline_box("seq", root, cfg, device=dev)
    assert radius_count.launches - launches[0] == 12 and dbscan_labels.launches > launches[1]
    for i in range(12):
        name = f"ppscore/{i:04d}.npy"
        np.testing.assert_array_equal(
            np.load(tmp_path / "card" / "waymo_processed_data" / "seq" / name),
            np.load(tmp_path / "cpu" / "waymo_processed_data" / "seq" / name))
    for f in out["cpu"]:
        for k in out["cpu"][f]:
            np.testing.assert_array_equal(out["card"][f][k], out["cpu"][f][k])
    assert sum(len(r["outline_box"]) for r in out["cpu"].values()) > 0
    banks = [pickle.load(open(tmp_path / side / "waymo_processed_data" / "seq"
                              / "seq_outline_MFCF_CSS_proto.pkl", "rb"))["proto_points_set"]
             for side in ("card", "cpu")]
    assert banks[0].keys() == banks[1].keys()
    for c in banks[1]:
        assert banks[0][c].keys() == banks[1][c].keys()
        for t in banks[1][c]:
            np.testing.assert_array_equal(banks[0][c][t]["points"], banks[1][c][t]["points"])
