"""Kernel G2 (per-tap gather-GEMM) as the card runs it, on the CPU.

``gather_probes.gather_gemm_per_tap_tiled`` restates the kernel's order of
arithmetic: per warp tile of 32 output rows, taps in order, each tap's hit
rows (found, idx inside the table) staged at their own rows, each half of 16
rows with a hit multiplied in bf16 16 channels at a time and summed in f32
into the tile's accumulator; f32 operands and W too wide for shared memory
take kernel A1's order at batch 1. It is held to the plain version and to the
Pallas body of ``scripts/exp_tal_gather.py`` (``:74-97``, restated as
``test_torch_port_probes.pallas_p3``) in interpret mode, within rtol 1e-4 and
1e-4 of the output's scale. The Pallas body reads every idx: a tap that is
unfound or whose idx lies outside the table goes to it as the idx of an extra
zero row, which is what the kernel's rule gives. Then the host helpers the
wrapper routes and sizes the kernel by.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpd_tpu_torch.ops import gather_gemm as gg
from cpd_tpu_torch.ops import gather_probes as gp
from cpd_tpu_torch.ops.gather_gemm import MAX_SMEM

from .test_torch_port_probes import pallas_p3


def _operands(n, k, cin, cout, v, seed, share=0.4, outside=True):
    """f32 operands: junk idx under every unfound tap and, with ``outside``,
    a few found taps whose idx lies outside the table."""
    rng = np.random.default_rng(seed)
    table = torch.from_numpy(rng.normal(size=(v, cin)).astype(np.float32))
    found = torch.from_numpy(rng.random((n, k)) < share)
    idx = rng.integers(0, v, (n, k)).astype(np.int32)
    if outside:
        idx[rng.random((n, k)) < 0.03] = v + 7
        idx[rng.random((n, k)) < 0.03] = -3
    idx = torch.where(found, torch.from_numpy(idx), 10**8).to(torch.int32)
    w = torch.from_numpy((rng.normal(size=(k, cin, cout)) * 0.1).astype(np.float32))
    return table, idx, found, w


def _close(out, ref):
    """rtol 1e-4 plus 1e-4 of the output's scale."""
    assert out.shape == ref.shape and out.dtype == torch.float32
    scale = float(ref.abs().max())
    assert scale > 1e-3
    assert bool(((out - ref).abs() <= 1e-4 * ref.abs() + 1e-4 * scale).all())


# (n, k, cin, cout): 5-channel rows, K = 3, ragged last tiles, Cin past one
# MMA depth (48 of 64), Cout not a multiple of 8, the widest W of K = 3
SHAPES = [(300, 27, 5, 16), (131, 3, 16, 32), (97, 27, 48, 16), (65, 27, 32, 7),
          (70, 3, 128, 128), (200, 27, 16, 64)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("n,k,cin,cout", SHAPES)
def test_g2_restatement_equals_plain(n, k, cin, cout, dtype):
    table, idx, found, w = _operands(n, k, cin, cout, 90, n + k)
    t, ww = table.to(dtype), w.to(dtype)
    launches, a1 = gp.gather_gemm_per_tap.launches, gg.gather_gemm.launches
    ref = gp.gather_gemm_per_tap_reference(t, idx, found, ww)
    assert torch.equal(gp.gather_gemm_per_tap(t, idx, found, ww), ref)  # CPU: the plain version
    assert (gp.gather_gemm_per_tap.launches, gg.gather_gemm.launches) == (launches, a1)
    _close(gp.gather_gemm_per_tap_tiled(t, idx, found, ww), ref)


@pytest.mark.parametrize("n,k,cin,cout", [(96, 27, 16, 16), (64, 3, 5, 16), (75, 27, 32, 32)])
def test_g2_restatement_equals_pallas_p3(n, k, cin, cout):
    """The Pallas P3 body (no grid, every array resident, one gather and one
    product per tap) in interpret mode on bf16 operands, against the
    restatement and the plain version."""
    v = n - 1  # the body gathers as many rows as it outputs: the table gets one zero row more
    table, idx, found, w = _operands(n, k, cin, cout, v, n + cin)
    tb, wb = table.bfloat16(), w.bfloat16()
    ok = found & (idx >= 0) & (idx < v)
    zero_row = torch.cat([tb, torch.zeros((1, cin), dtype=torch.bfloat16)])
    as_jax = [jnp.asarray(torch.where(ok, idx, v).numpy()), jnp.asarray(ok.numpy()),
              jnp.asarray(zero_row.float().numpy(), jnp.bfloat16),
              jnp.asarray(wb.float().numpy(), jnp.bfloat16)]
    pallas = torch.from_numpy(np.array(pallas_p3(*as_jax), np.float32))
    tiled = gp.gather_gemm_per_tap_tiled(tb, idx, found, wb)
    _close(tiled, pallas)
    _close(gp.gather_gemm_per_tap_reference(tb, idx, found, wb), pallas)


def test_g2_restatement_leaves_what_finds_nothing_untouched():
    """Rows 32-95 find no tap: those two warp tiles are never multiplied, so
    NaN weights leave them exactly 0, while every row of a half with a hit
    turns NaN (its misses are zero rows times NaN); a tap nobody finds is
    skipped the same way."""
    table, idx, found, w = _operands(160, 27, 16, 32, 90, 3, outside=False)
    found[32:96] = False
    found[:, 5] = False
    tb = table.bfloat16()
    out = gp.gather_gemm_per_tap_tiled(tb, idx, found, torch.full_like(w, float("nan")).bfloat16())
    assert torch.equal(out[32:96], torch.zeros_like(out[32:96]))
    assert bool(out[:32].isnan().all()) and bool(out[96:].isnan().all())
    nan_at_5 = w.clone()
    nan_at_5[5] = float("nan")
    out = gp.gather_gemm_per_tap_tiled(tb, idx, found, nan_at_5.bfloat16())
    assert bool(torch.isfinite(out).all())
    _close(out, gp.gather_gemm_per_tap_tiled(tb, idx, found, w.bfloat16()))


# P3 and the 9 layer shapes of a lidar frame's forward (K, Cin, Cout) with
# the route each takes for bf16 operands: W of all 27 taps fits beside the
# warps up to 32 -> 64; 64 -> 64 and wider go to A1; 128 -> 128 at K = 3 fits
ROUTES = [((27, 16, 16), "own"), ((27, 5, 16), "own"), ((27, 16, 32), "own"),
          ((27, 32, 32), "own"), ((27, 32, 64), "own"), ((27, 64, 64), "A1"),
          ((27, 64, 128), "A1"), ((27, 128, 128), "A1"), ((3, 128, 128), "own")]


@pytest.mark.parametrize("shape,route", ROUTES)
def test_g2_route(shape, route):
    k, cin, cout = shape
    assert gp.g2_route(k, cin, cout, torch.bfloat16) == route
    assert gp.g2_route(k, cin, cout, torch.float32) == "A1"
    most = gp.g2_max_warps(k, cin, cout)
    assert (most >= gp.G2_MIN_WARPS) == (route == "own")
    if route == "own":
        assert most <= gp.G2_MAX_WARPS[gp.g2_widths(cin, cout)[1]]
        assert gp.g2_smem_bytes(k, cin, cout, most) <= MAX_SMEM


def test_g2_shared_memory():
    """The bytes a block asks for: W of all taps (rows padded to 16 bytes)
    plus per warp a slab of 32 x K ints and the ring; the most warps that
    fits beside W, up to the register cap of the width."""
    assert gp.g2_smem_bytes(27, 16, 16, 32) == 27 * 16 * 24 * 2 + 32 * (32 * 27 * 4
                                                                         + 2 * 32 * 24 * 2)
    assert gp.g2_smem_bytes(3, 128, 128, 7) == 3 * 128 * 136 * 2 + 7 * (32 * 3 * 4
                                                                        + 2 * 32 * 136 * 2)
    per_warp = gp.g2_smem_bytes(4, 16, 16, 1) - gp.g2_smem_bytes(4, 16, 16, 0)
    assert per_warp == 32 * 4 * 4 + 2 * 32 * 24 * 2
    # the found bytes of a slab land in the ring first: a ring shorter than them grows
    assert gp.g2_smem_bytes(200, 16, 16, 1) - gp.g2_smem_bytes(200, 16, 16, 0) == 32 * 200 * 5
    assert [gp.g2_max_warps(27, 16, 16), gp.g2_max_warps(27, 16, 32), gp.g2_max_warps(27, 32, 32),
            gp.g2_max_warps(27, 32, 64), gp.g2_max_warps(3, 128, 128)] == [32, 24, 19, 12, 7]
    assert gp.g2_max_warps(27, 16, 200) == 0 and gp.g2_max_warps(27, 200, 16) == 0


# (rows, K, Cin, Cout) -> warps a block: P3's 4,688 warp tiles in two full
# rounds of 18 warps an SM; the layer shapes in one round each
WARPS = [((150_016, 27, 16, 16), 18), ((90_000, 27, 16, 16), 22), ((80_000, 27, 16, 32), 19),
         ((80_000, 27, 32, 32), 19), ((48_000, 27, 32, 64), 12), ((20_000, 3, 128, 128), 5),
         ((65, 27, 16, 16), 1), ((0, 27, 16, 16), 0)]


@pytest.mark.parametrize("sizes,warps", WARPS)
def test_g2_warps(sizes, warps):
    n, k, cin, cout = sizes
    assert gp.g2_warps(n, k, cin, cout) == warps
    assert gp.g2_smem_bytes(k, cin, cout, warps) <= MAX_SMEM
    if n == 0:  # an empty rulebook launches nothing
        return
    rounds = -(-gp.g2_warp_tiles(n) // (gg.SMS * warps))
    assert rounds == -(-gp.g2_warp_tiles(n) // (gg.SMS * gp.g2_max_warps(k, cin, cout)))
    assert gp.g2_warp_tiles(n) > gg.SMS * (warps - 1) * rounds  # one warp fewer needs a round more


def test_g2_budget_edge():
    """The largest K at which 64 -> 64 still runs on G2's own kernel: one tap
    more leaves fewer than ``G2_MIN_WARPS`` warps beside W, and A1 takes it."""
    edge = max(k for k in range(1, 28) if gp.g2_route(k, 64, 64, torch.bfloat16) == "own")
    assert gp.g2_max_warps(edge, 64, 64) >= gp.G2_MIN_WARPS
    assert gp.g2_route(edge + 1, 64, 64, torch.bfloat16) == "A1"
    assert all(gp.g2_route(k, 64, 64, torch.bfloat16) == "own" for k in range(1, edge))


@pytest.mark.parametrize("n,tiles", [(1, 1), (32, 1), (33, 2), (150_016, 4688)])
def test_g2_warp_tiles(n, tiles):
    assert gp.g2_warp_tiles(n) == tiles
