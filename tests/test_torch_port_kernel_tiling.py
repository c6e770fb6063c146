"""The host side of kernels A1, A2 and G1, on the CPU.

The CUDA kernels run on a card only (``tests/test_torch_port_cuda.py``). What
can be held here: ``gather_gemm_tiled`` / ``gather_gemm_dw_tiled``, which
restate the kernels' order of arithmetic in plain PyTorch (per tile, per tap in
tap order, hit lists in row order padded to 16, the operands as they are, f32
sums; for A2 per chunk, then chunks in order), against the plain versions and
against the Pallas kernels of ``cpd_tpu.ops.pallas_conv`` in interpret mode
(f32, 1e-4 of the output's scale: the same products summed in another order);
and every choice the wrappers make for a launch: tile rows, chunk rows and
taps, shared memory, scratch, and the placement of a model on a device.
For G1 (``ops/gather_probes.py``): ``gather_gemm_flat_tiled``, which restates
its tiles, the skip of a tile where no row finds a tap, the zero fill of
unfound taps and the flattened columns padded to 16, against the plain
version; its tile rows and shared memory.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from cpd_tpu.ops import pallas_conv
from cpd_tpu_torch.ops import gather_gemm as gg
from cpd_tpu_torch.ops import gather_probes as gp
from cpd_tpu_torch.parallel import init_state
from cpd_tpu_torch.utils.device import place, resolve_device

# b, v, n, k, cin, cout: ragged rows, K = 3, 5-channel rows, wide -> narrow
# (the dX of a strided conv), more input channels than one staged depth
SHAPES = [(2, 90, 131, 27, 16, 32), (2, 50, 77, 3, 5, 8), (1, 40, 300, 27, 5, 16),
          (2, 60, 150, 27, 64, 32), (1, 70, 97, 27, 80, 24), (1, 30, 65, 3, 128, 128)]


def _operands(b, v, n, k, cin, cout, share=0.35):
    rng = np.random.default_rng(n + k)
    table = rng.normal(size=(b, v, cin)).astype(np.float32)
    found = rng.random((b, n, k)) < share
    found[:, 20:52] = False  # rows that find no tap at all
    idx = rng.integers(0, v, (b, n, k)).astype(np.int32)
    w = (rng.normal(size=(k * cin, cout)) * 0.1).astype(np.float32)
    g = rng.normal(size=(b, n, cout)).astype(np.float32)
    return table, idx, found, w, g


def _close(out, ref, what, rel=1e-4):
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    assert out.shape == ref.shape, what
    scale = float(np.abs(ref).max())
    assert scale > 1e-3, f"{what}: reference is trivially zero"
    err = float(np.abs(out - ref).max())
    assert err <= rel * scale, f"{what}: max err {err} at scale {scale}"


@pytest.mark.parametrize("tile_rows", [None, 64, 256])
@pytest.mark.parametrize("b,v,n,k,cin,cout", SHAPES)
def test_a1_tiled_order_matches_plain_and_pallas(b, v, n, k, cin, cout, tile_rows):
    table, idx, found, w, _ = _operands(b, v, n, k, cin, cout)
    junk = np.where(found, idx, 10**8).astype(np.int32)  # never read under an unfound tap
    t = torch.from_numpy
    out = gg.gather_gemm_tiled(t(table), t(junk), t(found), t(w), tile_rows=tile_rows)
    _close(out, gg.gather_gemm_reference(t(table), t(idx), t(found), t(w)), "tiled vs plain")
    ref = pallas_conv.gather_gemm(jnp.asarray(table), jnp.asarray(idx), jnp.asarray(found),
                                  jnp.asarray(w), compute_dtype=jnp.float32)
    _close(out, ref, "tiled vs Pallas (interpret)")


@pytest.mark.parametrize("plan", [None, (32, 1), (64, 27), (160, 3)])
@pytest.mark.parametrize("b,v,n,k,cin,cout", SHAPES)
def test_a2_tiled_order_matches_plain_and_pallas(b, v, n, k, cin, cout, plan):
    table, idx, found, _, g = _operands(b, v, n, k, cin, cout)
    junk = np.where(found, idx, 10**8).astype(np.int32)
    t = torch.from_numpy
    out = gg.gather_gemm_dw_tiled(t(table), t(junk), t(found), t(g), plan=plan)
    _close(out, gg.gather_gemm_dw_reference(t(table), t(idx), t(found), t(g)), "tiled vs plain")
    ref = pallas_conv.gather_gemm_dw(jnp.asarray(table), jnp.asarray(idx), jnp.asarray(found),
                                     jnp.asarray(g), compute_dtype=jnp.float32)
    _close(out, ref, "tiled vs Pallas (interpret)")


@pytest.mark.parametrize("b,v,n,k,cin,cout", SHAPES[:4])
def test_tiled_order_on_bf16_operands(b, v, n, k, cin, cout):
    """bf16 operands stay bf16 and are summed in f32 (the tensor-core route):
    equal to the plain versions on the same rounded operands to 1e-4 of the
    scale; the bf16 output is the f32 one rounded once."""
    table, idx, found, w, g = (torch.from_numpy(x) for x in _operands(b, v, n, k, cin, cout))
    tb, wb, gb = table.bfloat16(), w.bfloat16(), g.bfloat16()
    out = gg.gather_gemm_tiled(tb, idx, found, wb)
    _close(out, gg.gather_gemm_reference(tb, idx, found, wb), "A1 bf16")
    assert torch.equal(gg.gather_gemm_tiled(tb, idx, found, wb, torch.bfloat16), out.bfloat16())
    _close(gg.gather_gemm_dw_tiled(tb, idx, found, gb),
           gg.gather_gemm_dw_reference(tb, idx, found, gb), "A2 bf16")


def test_tiled_order_drops_idx_outside_the_table():
    """A found tap whose idx is outside [0, V) adds nothing, as in the kernels."""
    table, idx, found, w, g = _operands(1, 40, 90, 27, 16, 16)
    bad = np.random.default_rng(0).random(idx.shape) < 0.2
    outside = np.where(bad, np.where(idx % 2 == 0, -3, 47), idx).astype(np.int32)
    t = torch.from_numpy
    kept = t(found & ~bad)
    _close(gg.gather_gemm_tiled(t(table), t(outside), t(found), t(w)),
           gg.gather_gemm_reference(t(table), t(idx), kept, t(w)), "A1")
    _close(gg.gather_gemm_dw_tiled(t(table), t(outside), t(found), t(g)),
           gg.gather_gemm_dw_reference(t(table), t(idx), kept, t(g)), "A2")


# the layer shapes of the bench configuration: batch, rows, taps, cin, cout
LAYERS = [(1, 90000, 27, 5, 16), (1, 90000, 27, 16, 16), (1, 80000, 27, 16, 32),
          (1, 80000, 27, 32, 32), (1, 48000, 27, 32, 64), (1, 48000, 27, 64, 64),
          (1, 24000, 27, 64, 128), (1, 24000, 27, 128, 128), (1, 20000, 3, 128, 128),
          (2, 90000, 27, 32, 16), (2, 48000, 27, 128, 64), (2, 24000, 27, 128, 128)]


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("b,n,k,cin,cout", LAYERS)
def test_a1_tile_rows_fits_shared_memory_and_fills_the_card(b, n, k, cin, cout, itemsize):
    tm = gg.a1_tile_rows(b, n, k, cin, cout, itemsize)
    assert tm == 128  # every layer of the bench configuration has rows for 132 SMs
    assert gg.a1_smem_bytes(tm, k, cin, cout, itemsize) <= gg.MAX_SMEM


def test_a1_tile_rows_small_launches_and_many_taps():
    assert gg.a1_tile_rows(1, 100, 27, 16, 16, 2) == 64     # too few rows to fill the card
    assert gg.a1_tile_rows(1, 132 * 128, 27, 16, 16, 2) == 128
    assert gg.a1_tile_rows(1, 131 * 128, 27, 16, 16, 2) == 64
    assert gg.a1_tile_rows(2, 66 * 128, 27, 16, 16, 2) == 128  # the batch counts
    # the lists hold at most MAX_TAPS taps at once, so many taps still fit
    assert gg.a1_tile_rows(1, 10**5, 125, 16, 16, 2) == 128
    assert gg.a1_smem_bytes(128, 125, 16, 16, 2) == gg.a1_smem_bytes(128, gg.MAX_TAPS, 16, 16, 2)


def test_a1_tile_rows_falls_back_to_64_rows_and_refuses_what_never_fits(monkeypatch):
    gg.a1_tile_rows.cache_clear()
    try:
        monkeypatch.setattr(gg, "MAX_SMEM", 120_000)  # a card with less shared memory
        assert (gg.a1_smem_bytes(128, 27, 128, 128, 2) > 120_000
                > gg.a1_smem_bytes(64, 27, 128, 128, 2))
        assert gg.a1_tile_rows(1, 24000, 27, 128, 128, 2) == 64
        monkeypatch.setattr(gg, "MAX_SMEM", 50_000)
        with pytest.raises(ValueError, match="no tile"):
            gg.a1_tile_rows(1, 24001, 27, 128, 128, 2)
    finally:
        gg.a1_tile_rows.cache_clear()


@pytest.mark.parametrize("cin,itemsize,depth", [(5, 2, 16), (16, 2, 16), (17, 2, 32), (64, 2, 64),
                                                (128, 2, 64), (130, 2, 64), (5, 4, 16),
                                                (32, 4, 32), (128, 4, 32)])
def test_a1_staged_depth(cin, itemsize, depth):
    assert gg.a1_staged_depth(cin, itemsize) == depth


def test_a1_smem_bytes_counts_lists_accumulator_and_stages():
    # 27 taps x 128 rows of (int32, uint16) + 32 counts; 128 x (128 + 8) f32;
    # 2 x (128 x (64 + 8) + 64 x (128 + 8)) bf16
    assert gg.a1_smem_bytes(128, 27, 128, 128, 2) == (
        27 * 128 * 6 + 128 + 128 * 136 * 4 + 2 * (128 * 72 + 64 * 136) * 2)
    assert gg.a1_smem_bytes(64, 3, 5, 16, 4) == (
        3 * 64 * 6 + 128 + 64 * 24 * 4 + 2 * (64 * 20 + 16 * 20) * 4)


@pytest.mark.parametrize("b,n,k,cin,cout", LAYERS + [(1, 77, 27, 130, 70), (1, 129, 40, 24, 136),
                                                     (2, 5000, 27, 32, 64), (1, 1, 1, 1, 1)])
def test_a2_plan_bounds(b, n, k, cin, cout):
    rows = b * n
    chunk_rows, taps = gg.a2_plan(rows, k, cin, cout)
    assert chunk_rows % 32 == 0 and 32 <= chunk_rows <= 65536
    assert 1 <= taps <= min(k, gg.MAX_TAPS)
    assert chunk_rows * taps <= gg.DW_LIST_ENTRIES
    for itemsize in (2, 4):
        assert gg.a2_smem_bytes(chunk_rows, taps, cin, cout, itemsize) <= gg.MAX_SMEM // 2
    chunks, kk, cout_ = gg.dw_scratch_shape(rows, k, cin, cout, chunk_rows)
    assert (chunks, kk, cout_) == (-(-rows // chunk_rows), k * cin, cout)
    assert chunks * kk * cout_ * 4 <= gg.DW_SCRATCH_BYTES
    if rows * k >= 2 * gg.SMS * gg.DW_LIST_ENTRIES // 4:
        assert chunks * -(-k // taps) >= 2 * gg.SMS  # two blocks for every SM


def test_a2_plan_trades_taps_for_scratch():
    # narrow layers: a ninth of the taps; the widest: one tap over long chunks
    assert gg.a2_plan(180000, 27, 16, 16) == (1344, 3)
    assert gg.a2_plan(48000, 27, 128, 128) == (4096, 1)
    assert gg.a2_plan(40000, 3, 128, 128) == (1024, 1)


@pytest.mark.parametrize("cin,cout,itemsize,hits", [(16, 16, 2, 128), (64, 64, 2, 128),
                                                    (64, 128, 2, 64), (5, 16, 4, 64),
                                                    (128, 128, 4, 32), (130, 70, 2, 64)])
def test_a2_hits_per_step(cin, cout, itemsize, hits):
    assert gg.a2_hits_per_step(cin, cout, itemsize) == hits


def test_a2_smem_bytes_counts_lists_table_and_stages():
    # 4096 entries of (int32, uint16), 32 counts, 36 step starts; 2 x 64 hits
    # x (128 + 8 + 128 + 8) bf16
    assert gg.a2_smem_bytes(4096, 1, 128, 128, 2) == (
        4096 * 6 + 128 + 144 + 2 * 64 * 272 * 2)


def test_wrappers_take_the_overrides_on_the_cpu():
    """``tile_rows`` and ``plan`` only shape a launch: CPU tensors compute the
    plain versions whatever they say."""
    table, idx, found, w, g = (torch.from_numpy(x) for x in _operands(1, 30, 40, 3, 8, 8))
    assert torch.equal(gg.gather_gemm(table, idx, found, w, tile_rows=64),
                       gg.gather_gemm_reference(table, idx, found, w))
    assert torch.equal(gg.gather_gemm_dw(table, idx, found, g, plan=(32, 1)),
                       gg.gather_gemm_dw_reference(table, idx, found, g))


def test_place_needs_a_card_or_an_explicit_device():
    """One rule for inference and training: the card by default, an error
    without one, the CPU on request."""
    model = torch.nn.Linear(3, 2)
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA card"):
            place(model)
        with pytest.raises(RuntimeError, match="no CUDA card"):
            init_state(model, {"OPTIMIZER": "adam_onecycle", "LR": 0.003}, 10)
    placed = place(model, "cpu")
    assert placed is model and next(placed.parameters()).device.type == "cpu"
    state = init_state(model, {"OPTIMIZER": "adam_onecycle", "LR": 0.003}, 10, device="cpu")
    assert state.model is model and model.training


# n, k, cin, cout: 5-channel rows (135 columns padded to 144), K = 3, ragged
# tiles, more output channels than one column tile, odd widths
G1_SHAPES = [(300, 27, 5, 16), (200, 3, 128, 128), (65, 27, 16, 200), (513, 27, 48, 16),
             (130, 27, 12, 7)]


def _g1_operands(n, k, cin, cout, v=50, padded_from=None):
    """f32 operands; junk idx under unfound taps and a few found taps outside
    the table; rows from ``padded_from`` on find nothing (a padded rulebook)."""
    rng = np.random.default_rng(n + k + cin)
    table = torch.from_numpy(rng.normal(size=(v, cin)).astype(np.float32))
    found = rng.random((n, k)) < 0.3
    if padded_from is not None:
        found[padded_from:] = False
    idx = rng.integers(0, v, (n, k))
    idx[rng.random((n, k)) < 0.05] = v + 3
    idx[rng.random((n, k)) < 0.05] = -2
    idx = np.where(found, idx, 10**8).astype(np.int32)
    w = torch.from_numpy((rng.normal(size=(k * cin, cout)) * 0.1).astype(np.float32))
    return table, torch.from_numpy(idx), torch.from_numpy(found), w


@pytest.mark.parametrize("tile_rows", [None, 64, 128])
@pytest.mark.parametrize("n,k,cin,cout", G1_SHAPES)
def test_g1_tiled_order_matches_plain(n, k, cin, cout, tile_rows):
    """f32, f32 rounded to bf16, bf16, and without ``found``: the tiles, the
    zero fill and the padded flattened columns sum to the plain version
    within 1e-4 of the output's scale (the same rounded operands, f32 sums)."""
    table, idx, found, w = _g1_operands(n, k, cin, cout)
    inside = idx.clamp(0, table.shape[0] - 1)
    for t, ww, i, f, rb in ((table, w, idx, found, False), (table, w, idx, found, True),
                            (table.bfloat16(), w.bfloat16(), idx, found, False),
                            (table, w, inside, None, False)):
        _close(gp.gather_gemm_flat_tiled(t, i, f, ww, rb, tile_rows),
               gp.gather_gemm_flat_reference(t, i, f, ww, rb), f"{t.dtype} round {rb}")


@pytest.mark.parametrize("tile_rows", [64, 128])
def test_g1_tiled_skips_tiles_that_find_nothing(tile_rows):
    """A padded tail that fills whole tiles is zeros and is never multiplied:
    with NaN weights the live tiles turn NaN and the skipped ones stay 0."""
    n, cout = 700, 16
    table, idx, found, w = _g1_operands(n, 27, 16, cout, padded_from=300)
    nan_w = torch.full_like(w, float("nan"))
    out = gp.gather_gemm_flat_tiled(table, idx, found, nan_w, tile_rows=tile_rows)
    first_dead = -(-300 // tile_rows) * tile_rows  # the first tile with no found row
    assert torch.equal(out[first_dead:], torch.zeros(n - first_dead, cout))
    assert bool(out[:300].isnan().all())
    _close(gp.gather_gemm_flat_tiled(table, idx, found, w, tile_rows=tile_rows),
           gp.gather_gemm_flat_reference(table, idx, found, w), "padded rulebook")


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("b,n,k,cin,cout", LAYERS[:9])
def test_g1_tile_rows_on_the_layer_shapes(b, n, k, cin, cout, itemsize):
    tm = gp.g1_tile_rows(n, k, cout, itemsize)
    assert tm == 128  # every layer of the bench frame has rows for 132 SMs
    assert gp.g1_smem_bytes(tm, k, cout, itemsize) <= gg.MAX_SMEM // 2  # two blocks an SM


def test_g1_tile_rows_small_launches_column_tiles_and_many_taps():
    assert gp.g1_tile_rows(100, 27, 16, 2) == 64
    assert gp.g1_tile_rows(132 * 128, 27, 16, 2) == 128
    assert gp.g1_tile_rows(131 * 128, 27, 16, 2) == 64
    assert gp.g1_tile_rows(66 * 128, 27, 200, 2) == 128  # two column tiles of 128
    for itemsize in (2, 4):  # the slab of the most taps a rulebook may have still fits
        assert gp.g1_smem_bytes(128, gp.MAX_TAPS, 128, itemsize) <= gg.MAX_SMEM


def test_g1_smem_bytes_counts_slab_and_stages():
    # a 128 x 27 slab of int32; 2 x (128 x (64 + 8) + 64 x (128 + 8)) bf16
    assert gp.g1_smem_bytes(128, 27, 128, 2) == 128 * 27 * 4 + 2 * (128 * 72 + 64 * 136) * 2
    # a 64 x 3 slab; 2 x (64 x (32 + 4) + 32 x (16 + 4)) f32
    assert gp.g1_smem_bytes(64, 3, 10, 4) == 64 * 3 * 4 + 2 * (64 * 36 + 32 * 20) * 4
    assert gp.g1_staged_itemsize(torch.float32, True) == gp.g1_staged_itemsize(torch.bfloat16,
                                                                              False) == 2
    assert gp.g1_staged_itemsize(torch.float32, False) == 4
    assert (gp.g1_staged_depth(2), gp.g1_staged_depth(4)) == (64, 32)


def test_g1_tile_rows_override_only_shapes_a_launch_on_the_cpu():
    table, idx, found, w = _g1_operands(90, 3, 8, 8)
    assert torch.equal(gp.gather_gemm_flat(table, idx, found, w, tile_rows=64),
                       gp.gather_gemm_flat_reference(table, idx, found, w))
