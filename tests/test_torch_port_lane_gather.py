"""Kernels G3 (lane gather-GEMM) and G4 (lane gather) as the card runs them:
the table transposed once into a row-major scratch, then whole rows gathered.
CPU tests, no card.

``gather_probes.lane_gather_gemm_tiled`` and ``lane_gather_tiled`` restate
that formulation (transpose, row gather, then the product in G3's steps or
G1's, or G4's channel-major write) in plain PyTorch. They are held to the
plain versions (G3 within 1e-4 of the output's scale, G4 bit-equal) and to
the Pallas bodies of ``scripts/exp_r2i_lane_gather.py`` (P6 ``:68-86``, P7
``:90-107``) in interpret mode at small sizes. The Pallas bodies have no
``found`` and read every idx: a tap that is unfound or whose idx lies
outside the table goes to them as an idx of an extra zero column, which is
what the kernels' rule gives. Then the host helpers the wrappers and tests
size the kernels by.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from cpd_tpu_torch.ops import gather_probes as gp
from cpd_tpu_torch.ops.gather_gemm import MAX_SMEM


def _operands(n, k, c, cout, v, seed, found=True, outside=True):
    """f32 operands: a (C, V) table, idx with junk under unfound taps and,
    with ``outside``, a few found taps pointing outside the table."""
    rng = np.random.default_rng(seed)
    table_t = torch.from_numpy(rng.normal(size=(c, v)).astype(np.float32))
    idx = rng.integers(0, v, (n, k)).astype(np.int32)
    if outside:
        idx[rng.random((n, k)) < 0.03] = v + 7
        idx[rng.random((n, k)) < 0.03] = -3
    f = torch.from_numpy(rng.random((n, k)) < 0.4) if found else None
    idx = torch.from_numpy(idx)
    if found:
        idx = torch.where(f, idx, 10**8).to(torch.int32)
    w = torch.from_numpy((rng.normal(size=(k * c, cout)) * 0.1).astype(np.float32))
    return table_t, idx, f, w


def _close(out, ref, rel):
    assert out.shape == ref.shape and out.dtype == torch.float32
    scale = float(ref.abs().max())
    assert scale > 1e-3
    assert float((out - ref).abs().max()) <= rel * scale


# (n, k, c, cout): ragged last tiles of 128 rows, K = 3, 5-channel rows (no
# 16-byte pieces), Cout 16 to 200 (two column tiles)
SHAPES = [(300, 3, 5, 16), (777, 27, 16, 64), (129, 27, 32, 32), (65, 27, 16, 200),
          (300, 3, 128, 128)]


@pytest.mark.parametrize("found", [True, False], ids=["found", "no-found"])
@pytest.mark.parametrize("n,k,c,cout", SHAPES)
def test_g3_restatement_equals_plain(n, k, c, cout, found):
    table_t, idx, f, w = _operands(n, k, c, cout, 600, n + k, found=found)
    if not found:
        idx = idx.clamp(0, 599)
    launches = gp.lane_gather_gemm.launches
    ref = gp.lane_gather_gemm_reference(table_t, idx, w, f)
    assert torch.equal(gp.lane_gather_gemm(table_t, idx, w, f), ref)  # CPU: the plain version
    assert gp.lane_gather_gemm.launches == launches
    _close(gp.lane_gather_gemm_tiled(table_t, idx, w, f), ref, 1e-4)
    # bf16 operands: G1's order on the row-major copy, both sums in f32
    tb, wb = table_t.bfloat16(), w.bfloat16()
    _close(gp.lane_gather_gemm_tiled(tb, idx, wb, f),
           gp.lane_gather_gemm_reference(tb, idx, wb, f), 1e-4)


def test_g3_restatement_skips_tiles_that_find_nothing():
    """A rulebook padded to its cap: the tiles past row 300 find nothing and
    are zeros, never multiplied (NaN weights do not reach them)."""
    table_t, idx, f, w = _operands(1000, 27, 16, 32, 600, 5)
    f[300:] = False
    out = gp.lane_gather_gemm_tiled(table_t, idx, torch.full_like(w, float("nan")), f)
    first_dead = -(-300 // gp.G3_TILE_ROWS) * gp.G3_TILE_ROWS
    assert torch.equal(out[first_dead:], torch.zeros_like(out[first_dead:]))
    assert bool(out[:300].isnan().all())


@pytest.mark.parametrize("n,k,c,tile", [(1000, 27, 5, 256), (777, 27, 64, 64), (300, 3, 128, 7),
                                        (300, 27, 72, 10)])
def test_g4_restatement_equals_plain(n, k, c, tile):
    """Bit-equal, f32 and bf16; rows past the last whole tile are not covered;
    an idx outside the table gives zeros; 72 channels take two passes."""
    table_t, idx, _, _ = _operands(n, k, c, 1, 600, n + c, found=False)
    launches = gp.lane_gather.launches
    for t in (table_t, table_t.bfloat16()):
        ref = gp.lane_gather_reference(t, idx, tile)
        assert ref.shape == (n // tile, c, tile * k)
        assert torch.equal(gp.lane_gather(t, idx, tile), ref)
        assert torch.equal(gp.lane_gather_tiled(t, idx, tile), ref)
    assert gp.lane_gather.launches == launches


def _vmem(shape, index_map):
    return pl.BlockSpec(shape, index_map, memory_space=pltpu.VMEM)


def pallas_p6(idx, table_t, w, tile):
    """scripts/exp_r2i_lane_gather.py:68-86 (lane gather + product), tile
    rows a grid step."""
    n, K = idx.shape
    C = table_t.shape[0]

    def k_g1(idx_ref, t_ref, w_ref, o_ref):
        flat = idx_ref[...].reshape(1, tile * K)
        i2d = jnp.broadcast_to(flat, (C, tile * K))
        g = jnp.take_along_axis(t_ref[...], i2d, axis=-1)
        g = g.reshape(C, tile, K).transpose(1, 2, 0).reshape(tile, K * C)
        o_ref[...] = jnp.dot(g, w_ref[...], preferred_element_type=jnp.float32)

    return pl.pallas_call(
        k_g1, grid=(n // tile,),
        in_specs=[_vmem((tile, K), lambda i: (i, 0)), _vmem(table_t.shape, lambda i: (0, 0)),
                  _vmem(w.shape, lambda i: (0, 0))],
        out_specs=_vmem((tile, w.shape[1]), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((n, w.shape[1]), jnp.float32),
        interpret=True)(idx, table_t, w)


def pallas_p7(idx, table_t, tile):
    """scripts/exp_r2i_lane_gather.py:90-107 (the lane gather alone)."""
    n, K = idx.shape
    C = table_t.shape[0]

    def k_g2(idx_ref, t_ref, o_ref):
        flat = idx_ref[...].reshape(1, tile * K)
        i2d = jnp.broadcast_to(flat, (C, tile * K))
        o_ref[0] = jnp.take_along_axis(t_ref[...], i2d, axis=-1)

    return pl.pallas_call(
        k_g2, grid=(n // tile,),
        in_specs=[_vmem((tile, K), lambda i: (i, 0)), _vmem(table_t.shape, lambda i: (0, 0))],
        out_specs=_vmem((1, C, tile * K), lambda i: (i, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((n // tile, C, tile * K), jnp.float32),
        interpret=True)(idx, table_t)


def _for_pallas(table_t, idx, f):
    """The Pallas bodies read every idx: an extra zero column at V takes the
    taps that the kernels drop (unfound, or idx outside the table)."""
    c, v = table_t.shape
    ok = (idx >= 0) & (idx < v)
    if f is not None:
        ok = ok & f
    padded = np.concatenate([table_t.numpy(), np.zeros((c, 1), np.float32)], axis=1)
    return jnp.asarray(np.where(ok.numpy(), idx.numpy(), v).astype(np.int32)), jnp.asarray(padded)


@pytest.mark.parametrize("n,k,c,cout,found", [(300, 3, 5, 16, True), (256, 27, 16, 64, False),
                                              (260, 27, 32, 32, True)])
def test_g3_restatement_matches_pallas_p6(n, k, c, cout, found):
    """At 4 rows a Pallas grid step, so that the kernel's tiles of 128 rows
    end ragged (300 and 260 rows)."""
    table_t, idx, f, w = _operands(n, k, c, cout, 200, n + 1, found=found)
    j_idx, j_table = _for_pallas(table_t, idx, f)
    ref = np.asarray(jax.jit(lambda i, t, ww: pallas_p6(i, t, ww, 4))(j_idx, j_table,
                                                                       jnp.asarray(w.numpy())))
    scale = float(np.abs(ref).max())
    assert scale > 0.1
    np.testing.assert_allclose(gp.lane_gather_gemm_tiled(table_t, idx, w, f).numpy(), ref,
                               rtol=1e-4, atol=1e-4 * scale)


@pytest.mark.parametrize("n,k,c,tile", [(300, 3, 5, 7), (256, 27, 64, 64)])
def test_g4_restatement_equals_pallas_p7(n, k, c, tile):
    """Bit-equal; idx outside the table give zeros (the zero column)."""
    table_t, idx, _, _ = _operands(n, k, c, 1, 200, n + 2, found=False)
    j_idx, j_table = _for_pallas(table_t, idx, None)
    ref = np.asarray(jax.jit(lambda i, t: pallas_p7(i, t, tile))(j_idx, j_table))
    np.testing.assert_array_equal(gp.lane_gather_tiled(table_t, idx, tile).numpy(), ref)


def test_lane_rows_on_the_cpu_is_the_exact_transpose():
    table_t, *_ = _operands(4, 3, 5, 1, 37, 0)
    for t in (table_t, table_t.bfloat16()):
        rows = gp.lane_rows(t)
        assert rows.shape == gp.lane_scratch_shape(t) == (37, 5)
        assert rows.dtype == t.dtype and rows.is_contiguous()
        assert torch.equal(rows, t.T)
    with pytest.raises(ValueError):
        gp.lane_rows(table_t[0])


@pytest.mark.parametrize("cout,tile,threads", [(1, 16, 64), (16, 16, 64), (17, 32, 128),
                                               (32, 32, 128), (64, 64, 256), (65, 128, 256),
                                               (128, 128, 256), (200, 128, 256)])
def test_g3_tile_and_threads(cout, tile, threads):
    """A thread owns 8 rows x 4 columns (x 8 columns at 128): the narrow
    column tiles run fewer threads, not smaller register tiles."""
    assert gp.g3_column_tile(cout) == tile
    assert gp.g3_threads(cout) == threads
    per_thread = gp.G3_TILE_ROWS * tile // threads
    assert per_thread == gp.G3_THREAD_ROWS * (8 if tile == 128 else 4)


def test_g3_shared_memory():
    """The slab of table rows and two stages of (128 x 36) rows and (32 x
    (NT + 4)) W, in f32: every K up to the taps a rulebook may have fits a
    block at every width; at the probe's K = 27, Cout = 64 three blocks fit
    an SM (228 KB)."""
    assert gp.g3_smem_bytes(27, 64) == 128 * 27 * 4 + 2 * (128 * 36 + 32 * 68) * 4 == 68096
    assert gp.g3_smem_bytes(3, 16) == 1536 + 2 * (128 * 36 + 32 * 20) * 4
    assert 3 * gp.g3_smem_bytes(27, 64) <= 228 * 1024
    for cout in (16, 32, 64, 128, 200):
        assert gp.g3_smem_bytes(gp.MAX_TAPS, cout) <= MAX_SMEM


@pytest.mark.parametrize("n,k,tile,grid", [(48_000, 27, 256, (187, 54)), (300, 3, 7, (42, 1)),
                                           (255, 27, 256, (0, 54)), (1000, 27, 10, (100, 3))])
def test_g4_grid_and_shared_memory(n, k, tile, grid):
    """One block a tile and run of 128 positions (P7: 187 x 54); shared
    memory is static and under the 48 KB a block gets without asking."""
    assert gp.g4_grid(n, k, tile) == grid
    assert gp.g4_smem_bytes() == (64 + 1) * 128 * 4 <= 48 * 1024
