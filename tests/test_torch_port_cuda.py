"""Tests of the port that need a CUDA card (marker ``cuda``): kernels A1, A2,
G1-G4, R1, R2, F1, B4a-c, B1a, B1b and B2 have no CPU or interpret mode.
They skip without a card. This file imports no JAX, so it also runs where JAX
is not installed:

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
@pytest.mark.parametrize("n,k,cin,cout", [(1000, 27, 5, 16), (1000, 27, 4, 16), (777, 27, 32, 64),
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
@pytest.mark.parametrize("n,k,cin,cout", [(1000, 27, 5, 16), (1000, 27, 4, 16),
                                          (5000, 27, 32, 64), (300, 3, 128, 128),
                                          (2049, 27, 16, 200), (77, 27, 130, 70)])
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


# b, n, k, cin, cout: ragged rows, K = 3, 5-channel rows, 4-channel rows (the
# KITTI yaml's input: one 16-byte f32 row), wide -> narrow (the dX of a
# strided conv), more channels than one tile or staged depth holds
TRAP_SHAPES = [(2, 1000, 27, 5, 16), (2, 1000, 27, 4, 16), (1, 1237, 27, 16, 16), (2, 777, 27, 64, 32),
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
def test_dense_tail_train_step_on_the_card(cuda):
    """A training step with the dense tail and the MM branch on the card, at
    the bench configuration's range and voxels (so BEV maps of 188 x 188:
    batch norms over few values a channel would amplify rounding) on frames
    of 40,000 points: 26 A1 launches in the forward (branch 0 15, the light
    branch 1 11), 24 as dX (all but the two input convs) and 26 of A2. At
    f32 (the heads' output layers scaled by 0.05, so that the heatmap stays
    off the focal loss's clamp) on the sparse tail's proposals: the loss
    within rtol 1e-4 of the sparse tail's, and the gradients' worst leaf,
    cosine and norm ratio within 4 times what the sparse tail moves by in
    another order of summation (on the plain versions of A1 and A2)."""
    from cpd_tpu_torch.models.detector import VoxelRCNN, set_compute_dtype
    from cpd_tpu_torch.utils import parity
    from cpd_tpu_torch.utils.synthetic import make_train_batch

    cfg = dict(num_classes=3, point_cloud_range=(-75.2, -75.2, -2.0, 75.2, 75.2, 4.0),
               voxel_size=(0.1, 0.1, 0.15), max_voxels=40_000,
               backbone_caps=(40_000, 30_000, 20_000, 20_000), mm=True, num_rois=128,
               roi_per_image=64, num_rois_test=32)
    raw = make_train_batch(0, 2, 40_000)
    batch = {k: torch.from_numpy(v).to(cuda) for k, v in raw.items()}
    models = {}
    for dense in (False, True):
        model = VoxelRCNN(**dict(cfg, dense_tail=dense))
        sd = seeded_state_dict(model, 0)
        model.load_state_dict({k: v * 0.05 if k.endswith(".out.weight") else v
                               for k, v in sd.items()}, strict=True)
        models[dense] = model.to(cuda)
    gg.gather_gemm.launches = gg.gather_gemm_dw.launches = 0
    models[True].train()
    loss, _ = models[True].loss_step(batch, generator=torch.Generator(cuda).manual_seed(0))
    forward = gg.gather_gemm.launches
    loss.backward()
    torch.cuda.synchronize()
    assert (forward, gg.gather_gemm.launches - forward, gg.gather_gemm_dw.launches) == (26, 24, 26)
    assert np.isfinite(float(loss.detach()))
    for m in models.values():
        set_compute_dtype(m, None)
    loss_s, _, grads_s, props = parity.loss_and_gradients(models[False], batch, 0)
    loss_d, _, grads_d, _ = parity.loss_and_gradients(models[True], batch, 0, props)
    with parity.plain_sparse_convs():
        _, _, grads_p, _ = parity.loss_and_gradients(models[False], batch, 0, props)
    assert abs(loss_d - loss_s) <= 1e-4 * abs(loss_s)
    lines, misses = parity.compare_gradients(grads_d, grads_s,
                                             parity.gradient_errors(grads_p, grads_s), 4.0)
    assert not misses, lines


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
@pytest.mark.parametrize("n,m,windows,layout", [(20_000, 100_000, 4, "uniform"),
                                                (3_000, 40_000, 12, "uniform"),
                                                (5, 0, 3, "uniform"),
                                                (2_000, 30_000, 3, "one_cell")])
def test_radius_count_kernel_matches_plain(cuda, n, m, windows, layout):
    """Kernel R1 against its plain version: the counts equal exactly (the
    same f32 arithmetic, no FMA contraction), also for queries placed on
    cell edges, for windows with no support point and for one cell holding
    every support point (its queries' items cut into many pieces); a second
    launch gives the same counts."""
    from cpd_tpu_torch.ops.radius import radius_count, radius_count_reference

    rng = np.random.default_rng(n)
    query = rng.uniform(-6, 6, (n, 3)).astype(np.float32)
    query[: n // 2] = (np.round(query[: n // 2] / 0.3) * 0.3).astype(np.float32)
    support = rng.uniform(-6, 6, (m, 3)).astype(np.float32)
    if layout == "one_cell":
        support = rng.uniform(0.01, 0.29, (m, 3)).astype(np.float32)
        query[: n // 2] = support[: n // 2]
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


def _dbscan_case(case, rng):
    """(points, segment offsets or None) of a card case: blobs that share
    border points (the list route); a dense ball of about 104M neighbour
    pairs (the walk route where the card has only ``WALK_SPARE`` bytes to
    give);
    120 segments with empty, one-point, all-noise and identical ones (the
    segmented launch)."""
    if case.startswith("blobs"):
        return _clusters_with_shared_borders(int(case[-1])), None
    if case == "walk":
        n = 2 ** 13 + 2_000
        ball = rng.normal(0, 1, (n, 3))
        ball *= (0.18 * rng.uniform(0, 1, (n, 1)) ** (1 / 3)) / np.linalg.norm(ball, axis=1,
                                                                                keepdims=True)
        return np.concatenate([ball, _clusters_with_shared_borders(5)]), None
    clouds = [c + rng.normal(0, 0.3, (int(rng.integers(1, 400)), 3))
              for c in rng.uniform(-60, 60, (112, 3))]
    clouds += [np.zeros((0, 3))] * 3 + [np.array([[1.0, 2.0, 3.0]])] * 2
    clouds += [rng.uniform(-20, 20, (40, 3)), clouds[7].copy(), clouds[7].copy()]
    rng.shuffle(clouds)
    return np.concatenate(clouds), np.concatenate([[0], np.cumsum([len(c) for c in clouds])])


# what the card has left to give while the walk case runs: less than the
# ball's list (8 bytes a pair, ``dbscan.pair_list``) needs
WALK_SPARE = 2 ** 28


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["blobs0", "blobs1", "blobs2", "walk", "segments"])
def test_dbscan_kernel_matches_plain(cuda, case):
    """Kernel R2 against its plain version: labels equal on every point,
    twice (roots are minimum indices, so the labels do not depend on thread
    order), by the list route (blobs that share border points), by the walk
    route (a dense ball whose list does not fit the ``WALK_SPARE`` bytes
    that a block of memory leaves the card: the route follows the operands'
    size and the memory alone; each launch's route is recorded) and in one
    segmented launch of 120 clouds, each equal to its plain version alone
    (one launch counted, on both counters); an empty cloud gives no
    label."""
    from unittest import mock

    from cpd_tpu_torch.ops import dbscan as r2
    from cpd_tpu_torch.ops.dbscan import (dbscan_batched_reference, dbscan_labels,
                                          dbscan_labels_batched, dbscan_reference)

    pts, offsets = _dbscan_case(case, np.random.default_rng(7))
    pts = torch.from_numpy(pts).to(cuda)
    hog = None
    if offsets is None:
        run = lambda: dbscan_labels(pts, 0.4, 5)
        ref = dbscan_reference(pts, 0.4, 5)
        if case == "walk":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            hog = torch.empty(torch.cuda.mem_get_info(cuda)[0] - WALK_SPARE, dtype=torch.uint8,
                              device=cuda)
    else:
        run = lambda: dbscan_labels_batched(pts, offsets, 0.4, 5)
        ref = dbscan_batched_reference(pts, offsets, 0.4, 5)
    listed, pair_list = [], r2.pair_list

    def recording(pairs, device):
        got = pair_list(pairs, device)
        listed.append(got is not None)
        return got

    before = dbscan_labels.launches, dbscan_labels_batched.launches
    with mock.patch.object(r2, "pair_list", recording):
        out, again = run(), run()
    torch.cuda.synchronize()
    del hog
    torch.cuda.empty_cache()  # give the card back: later tests start processes on it
    assert listed == [case != "walk"] * 2
    assert dbscan_labels.launches - before[0] == 2
    assert dbscan_labels_batched.launches - before[1] == (2 if case == "segments" else 0)
    assert out.dtype == torch.int32 and torch.equal(out, ref) and torch.equal(out, again)
    assert int(out.max()) >= (1 if case == "segments" else 10)
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


@pytest.mark.cuda
def test_norm_collectives_on_ranks_sharing_the_card(cuda, tmp_path):
    """``all_reduce_sum`` and MaskedBatchNorm (rank 1 with no valid row) on 2
    gloo ranks whose tensors live on the one card, against one process on
    the concatenated batch on the card: within 1e-5 of the scale, running
    statistics bit-equal over the ranks."""
    from tests.torch_dist_ranks import card_norms, make_norm, norm_inputs, norm_step, run_ranks
    outs = run_ranks(card_norms, 2, tmp_path / "ranks")
    for out in outs:
        np.testing.assert_array_equal(out["reduce_y"], [1.0, 3.0, 5.0, 7.0])
        np.testing.assert_array_equal(out["reduce_grad"], [3.0] * 4)
    parts = [norm_inputs(r, "masked") for r in range(2)]
    ref = norm_step(make_norm("masked"), *(np.concatenate([p[i] for p in parts])
                                           for i in range(3)), device=cuda)
    got = {k: np.concatenate([o["masked"][k] for o in outs]) for k in ("y", "x_grad")}
    got.update({k: sum(o["masked"][k] for o in outs) for k in ("weight_grad", "bias_grad")})
    for key in ("running_mean", "running_var"):
        np.testing.assert_array_equal(outs[0]["masked"][key], outs[1]["masked"][key])
        got[key] = outs[0]["masked"][key]
    for key, v in got.items():
        scale = max(float(np.abs(ref[key]).max()), 1e-3)
        assert float(np.abs(v - ref[key]).max()) <= 1e-5 * scale, key


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["spread", "ties", "padded", "few_valid", "none_valid",
                                  "one_point"])
def test_farthest_point_sample_kernel_equals_plain(cuda, case):
    """Kernel F1 against its plain version, indices exactly equal: a batch of
    3 clouds of 20,000 points (one point for ``one_point``), 512 samples;
    spread points, integer points full of ties, padding, 5 valid points
    (the first valid one repeats), none valid (all 0)."""
    from cpd_tpu_torch.ops.fps import farthest_point_sample, farthest_point_sample_reference
    rng = np.random.default_rng(["spread", "ties", "padded", "few_valid", "none_valid",
                                 "one_point"].index(case))
    n = 1 if case == "one_point" else 20_000
    pts = rng.normal(0.0, 20.0, (3, n, 5)).astype(np.float32)
    valid = np.ones((3, n), bool)
    if case == "ties":
        pts = np.round(pts / 4.0)
    elif case == "padded":
        valid = rng.random((3, n)) > 0.4
    elif case == "few_valid":
        valid[:] = False
        valid[:, [3, 70, 71, 5000, n - 1]] = True
    elif case == "none_valid":
        valid[:] = False
    p, v = torch.from_numpy(pts).to(cuda), torch.from_numpy(valid).to(cuda)
    before = farthest_point_sample.launches
    got = farthest_point_sample(p, v, 512)
    again = farthest_point_sample(p, v, 512)
    assert farthest_point_sample.launches - before == 2
    ref = farthest_point_sample_reference(p, v, 512)
    assert got.dtype == torch.int32 and got.shape == (3, 512)
    assert torch.equal(got, ref) and torch.equal(got, again)
    if case == "none_valid":
        assert not got.any()
    elif case != "one_point":
        assert bool(v.gather(1, got.long()).all())


@pytest.mark.cuda
def test_farthest_point_sample_kernel_rejects_wrong_operands(cuda):
    from cpd_tpu_torch.ops.fps import farthest_point_sample
    p = torch.zeros(1, 8, 3, device=cuda)
    with pytest.raises(ValueError):
        farthest_point_sample(p, torch.ones(1, 8, device=cuda), 4)  # not bool
    with pytest.raises(ValueError):
        farthest_point_sample(p, torch.ones(1, 8, dtype=torch.bool), 4)  # on the CPU


def _nms_boxes(rng, b, k, spread=None, slivers=0):
    """(b, k, 7) boxes, a third jittered copies and a few exact duplicates;
    ``slivers`` rows narrower than the f32 spacing at 70 m."""
    spread = spread or max(2.0, 1.2 * np.sqrt(k))
    boxes = np.zeros((b, k, 7), np.float32)
    boxes[..., :2] = rng.uniform(-spread, spread, (b, k, 2))
    boxes[..., 2] = rng.uniform(-1, 1, (b, k))
    boxes[..., 3:6] = rng.uniform(0.5, 4.0, (b, k, 3))
    boxes[..., 6] = rng.uniform(-np.pi, np.pi, (b, k))
    n_copy = k // 3
    if n_copy:
        src = rng.integers(0, k, n_copy)
        boxes[:, -n_copy:] = boxes[:, src] + rng.normal(0, 0.2, (b, n_copy, 7))
        boxes[:, -n_copy:, 3:6] = np.abs(boxes[:, -n_copy:, 3:6]) + 0.3
        boxes[:, -(n_copy // 4 + 1):] = boxes[:, src[:n_copy // 4 + 1]]
    if slivers:
        boxes[:, :slivers, :2] = (70.0, 3.0)
        boxes[:, :slivers, 3] = 1e-6
    return boxes


def _nms_scene(rng, b, k, scene):
    """(b, k, 7) boxes: ``"mixed"`` as ``_nms_boxes`` (a few slivers at 70 m);
    ``"disjoint"`` on a 6 m grid, every pair taken by the reject
    (``iou3d.clip_reject``); ``"slivers"`` boxes around (70, 3) m and, in
    every other row, a sliver narrower than the f32 spacing whose long axis
    passes through the box of the row before it, 5-40 m away (its clip keeps
    a residue, and the reject must pass it)."""
    if scene == "mixed":
        return _nms_boxes(rng, b, k, slivers=min(4, k // 8))
    boxes = _nms_boxes(rng, b, k, spread=30.0)
    side = int(np.ceil(np.sqrt(max(k, 1))))
    if scene == "disjoint":
        cell = np.arange(k)
        boxes[..., 0] = 6.0 * (cell % side - side / 2)
        boxes[..., 1] = 6.0 * (cell // side - side / 2)
        boxes[..., 3:5] = rng.uniform(0.5, 4.0, (b, k, 2))
        return boxes
    boxes[..., :2] += (70.0, 3.0)
    sl = boxes[:, 1::2]
    along = rng.uniform(5.0, 40.0, sl.shape[:2]) * rng.choice([-1.0, 1.0], sl.shape[:2])
    src = boxes[:, 0:2 * sl.shape[1]:2]
    sl[..., 3] = rng.uniform(1e-7, 4e-6, sl.shape[:2])
    sl[..., 0] = src[..., 0] + along * np.sin(sl[..., 6])
    sl[..., 1] = src[..., 1] - along * np.cos(sl[..., 6])
    boxes[:, 1::2] = sl
    return boxes


def _within_ulps(got, ref, ulps=2):
    """|got - ref| within ``ulps`` f32 spacings of ``ref``."""
    spacing = torch.nextafter(ref.abs(), torch.full_like(ref, np.inf)) - ref.abs()
    return bool(((got - ref).abs() <= ulps * spacing).all())


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,m,slivers", [(1, 1, 1, 0), (1, 63, 65, 0), (3, 200, 130, 4),
                                           (2, 1000, 64, 0), (1, 4096, 300, 8)])
def test_pairwise_overlap_bev_kernel_matches_plain(cuda, b, n, m, slivers):
    """Kernel B4a against its plain version on the card, within 2 ulp (the
    two repeat each other's operations without fused multiply-adds: equal
    bits are expected)."""
    from cpd_tpu_torch.ops import iou3d
    rng = np.random.default_rng(n + m)
    a = torch.from_numpy(_nms_boxes(rng, b, n, slivers=slivers)).to(cuda)
    c = torch.from_numpy(_nms_boxes(rng, b, m, spread=max(2.0, 1.2 * np.sqrt(n)))).to(cuda)
    before = iou3d.pairwise_overlap_bev.launches
    got = iou3d.pairwise_overlap_bev(a, c)
    assert iou3d.pairwise_overlap_bev.launches - before == 1
    ref = iou3d.pairwise_overlap_bev_reference(a, c)
    torch.cuda.synchronize()
    assert got.shape == (b, n, m) and _within_ulps(got, ref)
    assert torch.equal(got, iou3d.pairwise_overlap_bev(a, c))
    if n > 1:
        assert bool((got > 0).any())
    # on a CUDA tensor boxes_overlap_bev runs the kernel whatever method says
    assert torch.equal(iou3d.boxes_overlap_bev(a[0], c[0]), got[0])


@pytest.mark.cuda
@pytest.mark.parametrize("b,k,scene", [
    (1, 1, "mixed"), (1, 63, "mixed"), (2, 64, "mixed"), (3, 65, "mixed"), (1, 200, "mixed"),
    (1, 500, "mixed"), (2, 500, "mixed"), (1, 4096, "mixed"), (2, 4096, "mixed"),
    (3, 1000, "mixed"), (1, 0, "mixed"), (2, 500, "disjoint"), (2, 4096, "disjoint"),
    (2, 500, "slivers")])
@pytest.mark.parametrize("bev", [True, False])
def test_nms_mask_and_suppress_kernels_equal_plain(cuda, b, k, scene, bev):
    """Kernels B4b and B4c against their plain versions on the card: the
    words and both suppressions exactly, a sample with every row invalid,
    samples with their valid rows cut at different counts; B4a on the same
    pairs bit for bit (``_nms_scene``: the disjoint-pair reject alone, and
    slivers across the other boxes' lines)."""
    from cpd_tpu_torch.ops import iou3d, nms
    rng = np.random.default_rng(k)
    boxes = torch.from_numpy(_nms_scene(rng, b, k, scene)).to(cuda)
    valid = torch.from_numpy(rng.random((b, k)) < 0.9).to(cuda)
    if b > 1:
        valid[-1] = False
        valid[0, (2 * k) // 3:] = False
    before = (nms.nms_mask_bev.launches, nms.nms_suppress.launches)
    words = nms.nms_mask_bev(boxes, valid, 0.2, use_bev_iou=bev)
    ref = nms.nms_mask_bev_reference(boxes, valid, 0.2, use_bev_iou=bev)
    torch.cuda.synchronize()
    assert words.shape == (b, k, (k + 63) // 64) and torch.equal(words, ref)
    for fast in (False, True):
        keep = nms.nms_suppress(words, valid, fast)
        assert torch.equal(keep, nms.nms_suppress_reference(words, valid, fast)), fast
        if b > 1:
            assert not keep[-1].any()
    assert (nms.nms_mask_bev.launches - before[0], nms.nms_suppress.launches - before[1]) == (
        (1, 2) if k else (0, 0))
    got = iou3d.pairwise_overlap_bev(boxes, boxes)
    want = iou3d.pairwise_overlap_bev_reference(boxes, boxes)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    rejected = iou3d.clip_reject(boxes[:, :, None], boxes[:, None])
    apart = ~torch.eye(k, dtype=torch.bool, device=cuda)
    if scene == "disjoint":
        assert bool(rejected[:, apart].all()) and not bool(words.ne(0).any())
    elif scene == "slivers":
        assert not bool(rejected[:, 1::2].any()) and bool((want[:, 0::2, 1::2] > 0).any())
    elif k > 64:
        assert bool((words != 0).any()) and bool(rejected.any()) and not bool(rejected.all())


@pytest.mark.cuda
def test_batched_nms_on_the_card_equals_the_loop_and_the_plain_versions(cuda):
    """``nms_bev_batched`` launches B4b and B4c once for the whole batch and
    equals ``nms_bev`` a sample; ``multi_classes_nms`` launches them once for
    its classes; ``nms_normal_bev`` sweeps on B4c."""
    from cpd_tpu_torch.ops import nms
    rng = np.random.default_rng(5)
    boxes = torch.from_numpy(_nms_boxes(rng, 3, 700)).to(cuda)
    scores = torch.from_numpy(rng.random((3, 700)).astype(np.float32)).to(cuda)
    valid = scores > 0.05
    for fast in (False, True):
        before = (nms.nms_mask_bev.launches, nms.nms_suppress.launches)
        idx, mask = nms.nms_bev_batched(boxes, scores, 0.3, 512, 200, valid, fast=fast)
        assert (nms.nms_mask_bev.launches - before[0], nms.nms_suppress.launches - before[1]) \
            == (1, 1)
        for i in range(3):
            one = nms.nms_bev(boxes[i], scores[i], 0.3, 512, 200, valid[i], fast=fast)
            assert torch.equal(idx[i], one[0]) and torch.equal(mask[i], one[1])
    before = nms.nms_mask_bev.launches
    cfg = {"NMS_THRESH": 0.3, "NMS_PRE_MAXSIZE": 512, "NMS_POST_MAXSIZE": 100}
    out = nms.multi_classes_nms(scores.T.contiguous(), boxes[0], cfg, 0.1)
    assert nms.nms_mask_bev.launches - before == 1
    for c in range(3):
        one = nms.class_agnostic_nms(scores[c], boxes[0], cfg, 0.1)
        assert all(torch.equal(a[c], o) for a, o in zip(out, one))
    before = nms.nms_suppress.launches
    idx, mask = nms.nms_normal_bev(boxes[0], scores[0], 0.1, 512, 100)
    assert nms.nms_suppress.launches - before == 1 and bool(mask.any())


@pytest.mark.cuda
def test_nms_kernels_reject_wrong_operands(cuda):
    from cpd_tpu_torch.ops import iou3d, nms
    boxes = torch.zeros(1, 8, 7, device=cuda)
    with pytest.raises(ValueError):
        nms.nms_mask_bev(boxes, torch.ones(1, 8, dtype=torch.bool), 0.1)  # on the CPU
    with pytest.raises(ValueError):
        nms.nms_suppress(torch.zeros(1, 8, 1, dtype=torch.int32, device=cuda),
                         torch.ones(1, 8, dtype=torch.bool, device=cuda))
    with pytest.raises(ValueError):
        iou3d.pairwise_overlap_bev(boxes, torch.zeros(1, 8, 7))


RULEBOOK_GEOMETRIES = (((3, 3, 3), (2, 2, 2), (1, 1, 1)), ((3, 3, 3), (2, 2, 2), (1, 1, 0)),
                       ((1, 1, 3), (1, 1, 2), (0, 0, 0)))
BENCH_CAPS = (80_000, 48_000, 24_000, 20_000)


def _rulebook_keys(grid, counts, cap, seed):
    """(B, cap) sorted unique int32 keys, the grid's 8 corners among them,
    INVALID_KEY padding; ``counts`` a sample (0: an empty one)."""
    rng = np.random.default_rng(seed)
    corners = np.unique([(z * grid.ny + y) * grid.nx + x for z in (0, grid.nz - 1)
                         for y in (0, grid.ny - 1) for x in (0, grid.nx - 1)])
    rest = np.setdiff1d(np.arange(grid.num_cells), corners)
    out = np.full((len(counts), cap), sparse.INVALID_KEY, np.int32)
    for b, n in enumerate(counts):
        if n:
            out[b, :n] = np.sort(np.concatenate([corners, rng.choice(rest, n - 8, replace=False)]))
    return torch.from_numpy(out)


def _assert_same_book(got, want, what):
    """Integers exactly: found, idx where found, out_keys, out_valid."""
    assert torch.equal(got.found.cpu(), want.found.cpu()), f"{what}: found"
    assert torch.equal(got.idx.cpu()[got.found.cpu()], want.idx.cpu()[want.found.cpu()]), \
        f"{what}: idx"
    assert torch.equal(got.out_keys.cpu(), want.out_keys.cpu()), f"{what}: out_keys"
    assert torch.equal(got.out_valid.cpu(), want.out_valid.cpu()), f"{what}: out_valid"


@pytest.mark.cuda
@pytest.mark.parametrize("nx,counts", [(13, (320, 0, 160)), (32, (283,)), (33, (320, 0, 160)),
                                       (70, (320, 200, 0, 17)), (1504, (40_000, 25_000))])
def test_rulebook_kernels_equal_plain(cuda, nx, counts):
    """B1a, B1b (subm, strided, inverse) and B2 against their plain versions
    on the same operands, and the books against the plain twins of
    ``ops/sparse.py``: x extents with and without padding bits, empty
    samples and one without a padding slot, caps above and below the
    occupancy (the truncated output table as B1a builds it from the output
    keys), down4's padding (1, 1, 0) and conv_out's K = 3; each wrapper
    counts its calls."""
    from cpd_tpu_torch.ops import rulebook
    grid = sparse.GridSpec(nx, 41 if nx > 100 else 9, 41 if nx > 100 else 7)
    keys = _rulebook_keys(grid, counts, max(counts), nx).to(cuda)
    before = (rulebook.stage_table.launches, rulebook.lookup_taps.launches,
              rulebook.downsample.launches)
    table = rulebook.stage_table(keys, grid)
    plain = rulebook.stage_table_reference(keys, grid)
    assert torch.equal(table.words, plain.words) and torch.equal(table.prefix, plain.prefix)
    _assert_same_book(rulebook.subm_rulebook(keys, table),
                      sparse.subm_rulebook_reference(keys, grid), "subm")
    for geom in RULEBOOK_GEOMETRIES:
        for cap in (4 * max(counts), max(counts) // 5):
            book, out_table = rulebook.conv_rulebook(table, *geom, cap)
            twin, out_grid = sparse.conv_rulebook_reference(keys, grid, *geom, cap)
            _assert_same_book(book, twin, f"{geom} cap {cap}")
            plain_table, plain_keys, plain_valid = rulebook.downsample_reference(table, *geom, cap)
            assert torch.equal(out_table.words, plain_table.words)
            assert torch.equal(out_table.prefix, plain_table.prefix)
            assert torch.equal(book.out_keys, plain_keys) and torch.equal(book.out_valid,
                                                                          plain_valid)
            again = rulebook.stage_table(book.out_keys, out_grid)
            assert torch.equal(again.words, out_table.words)
            assert torch.equal(again.prefix, out_table.prefix)
            for mode, rows, row_grid, tab in ((rulebook.STRIDED, book.out_keys, out_grid, table),
                                              (rulebook.INVERSE, keys, grid, out_table)):
                got = rulebook.lookup_taps(rows, row_grid, tab, mode, *geom)
                want = rulebook.lookup_taps_reference(rows, row_grid, tab, mode, *geom)
                assert all(torch.equal(a, b) for a, b in zip(got, want)), (geom, cap, mode)
            _assert_same_book(rulebook.inverse_rulebook(keys, grid, out_table, *geom),
                              sparse.inverse_rulebook_reference(keys, twin.out_keys, grid,
                                                                out_grid, *geom),
                              f"{geom} cap {cap}, inverse")
    convs = 2 * len(RULEBOOK_GEOMETRIES)  # a table, 4 lookups and an output set a conv
    assert (rulebook.stage_table.launches - before[0], rulebook.lookup_taps.launches - before[1],
            rulebook.downsample.launches - before[2]) == (1 + convs, 1 + 4 * convs, convs)


def _bench_keys(cuda, samples=1):
    """The voxel keys of the bench frame(s) (200k points, the bench
    configuration's voxelizer and grid)."""
    from cpd_tpu_torch.models.detector import keys_from_frame
    spec = VoxelizerSpec.create((-75.2, -75.2, -2.0, 75.2, 75.2, 4.0), (0.1, 0.1, 0.15), 90_000)
    frames = [make_lidar_frame(np.random.default_rng(s), 200_000) for s in range(samples)]
    points = torch.from_numpy(np.stack([p for p, _ in frames])).to(cuda)
    valid = torch.from_numpy(np.stack([v for _, v in frames])).to(cuda)
    nx, ny, nz = spec.grid_size
    grid = sparse.GridSpec(nx, ny, nz + 1)
    return keys_from_frame(voxelize_batch(points, spec, valid), grid), grid


@pytest.mark.cuda
@pytest.mark.parametrize("samples,kw", [(1, {"dense_tail": True}), (1, {}),
                                        (2, {"with_transpose": True}),
                                        (2, {"with_transpose": True, "with_conv_out": False})])
def test_branch_rulebooks_on_the_bench_frame_equal_the_plain_twins(cuda, samples, kw):
    """Every book of the bench frame's branch (both tails, the train step's
    transposes, the light branch) on the card (one B1a, a B2 a strided conv,
    a B1b a book) equals the plain twins on the CPU."""
    from cpd_tpu_torch.ops import rulebook
    keys, grid = _bench_keys(cuda, samples)
    before = rulebook.lookup_taps.launches
    got = backbone3d.build_branch_rulebooks(keys, grid, BENCH_CAPS, **kw)
    want = backbone3d.build_branch_rulebooks(keys.cpu(), grid, BENCH_CAPS, **kw)
    assert set(got) == set(want)
    for name in want:
        _assert_same_book(got[name], want[name], name)
    assert rulebook.lookup_taps.launches - before == sum(not n.startswith("subm") or
                                                         not n.endswith("_T") for n in got)


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [{"dense_tail": True}, {}, {"with_transpose": True}])
def test_branch_rulebooks_do_not_synchronise(cuda, kw):
    """After one warm-up call (the kernels' build and load), the card's
    books take no host sync: no read, no ``unique``, no blocking copy."""
    keys, grid = _bench_keys(cuda, 2 if kw.get("with_transpose") else 1)
    backbone3d.build_branch_rulebooks(keys, grid, BENCH_CAPS, **kw)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        books = backbone3d.build_branch_rulebooks(keys, grid, BENCH_CAPS, **kw)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert int(books["subm1"].found.sum()) > 0


@pytest.mark.cuda
def test_rulebook_kernels_reject_wrong_operands(cuda):
    from cpd_tpu_torch.ops import rulebook
    grid = sparse.GridSpec(40, 8, 8)
    keys = _rulebook_keys(grid, (30,), 32, 0).to(cuda)
    table = rulebook.stage_table(keys, grid)
    with pytest.raises(ValueError):  # mixed devices
        rulebook.lookup_taps(keys.cpu(), grid, table, rulebook.SUBM, (3, 3, 3))
    with pytest.raises(ValueError):  # not contiguous
        rulebook.stage_table(torch.cat([keys, keys]).T.contiguous().T, grid)
    with pytest.raises(TypeError):
        rulebook.stage_table(keys.long(), grid)
