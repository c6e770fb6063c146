"""The gather-formulation probes: the JAX package's Pallas probe kernels
against the port's plain versions of kernels G1-G4 (CPU, no card).

The probes' kernel bodies are closures inside each script's ``main()``, so
each body is restated here as the script writes it (P1-P7, both bodies of P5)
and run through ``pl.pallas_call(..., interpret=True)`` at a small size
(V = 512, the script's K and channel widths, TILE 256). The same operands,
drawn by ``cpd_tpu_torch.probes.gather.make_operands`` from a numpy seed, go
through the port's wrappers, which compute the plain versions on CPU tensors.
Products agree within 1e-4 of the output's scale plus rtol 1e-4 (f32 sums in
another order); the gather alone (P7) agrees exactly.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from cpd_tpu_torch.ops import gather_probes as gp
from cpd_tpu_torch.probes import gather as probes

REPO = Path(__file__).resolve().parents[1]
V, TILE = 512, 256


def _vmem(shape=None, index_map=None):
    if shape is None:
        return pl.BlockSpec(memory_space=pltpu.VMEM)
    return pl.BlockSpec(shape, index_map, memory_space=pltpu.VMEM)


def _tiled_call(kernel, n, k, table_shape, w_shape, cout, with_found):
    """The probes' common grid: (TILE, K) blocks of idx (and found), the
    table and W whole, (TILE, Cout) blocks of the f32 output."""
    rows = [_vmem((TILE, k), lambda i: (i, 0))] * (2 if with_found else 1)
    return pl.pallas_call(
        kernel, grid=(n // TILE,),
        in_specs=rows + [_vmem(table_shape, lambda i: (0, 0)), _vmem(w_shape, lambda i: (0, 0))],
        out_specs=_vmem((TILE, cout), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((n, cout), jnp.float32), interpret=True)


def pallas_p1(idx, found, table, w):
    """scripts/exp_pallas_gather.py:68-93."""
    n, K = idx.shape
    CIN, COUT = table.shape[1], w.shape[1]

    def kernel(idx_ref, found_ref, table_ref, w_ref, out_ref):
        idxs = idx_ref[:]
        g = table_ref[idxs.reshape(-1), :]
        g = g.reshape(TILE, K, CIN)
        g = jnp.where(found_ref[:][..., None], g, 0.0)
        out_ref[:] = jnp.dot(
            g.reshape(TILE, K * CIN).astype(jnp.bfloat16),
            w_ref[:].astype(jnp.bfloat16),
            preferred_element_type=jnp.float32,
        )

    return _tiled_call(kernel, n, K, table.shape, w.shape, COUT, True)(idx, found, table, w)


def pallas_p2(idx, found, table, w):
    """scripts/exp_gather_variants.py:99-119."""
    n, K = idx.shape
    CIN, COUT = table.shape[1], w.shape[1]

    def kernel(idx_ref, found_ref, table_ref, w_ref, out_ref):
        idxs = idx_ref[:]
        g = jnp.take(table_ref[:], idxs.reshape(-1), axis=0)
        g = g.reshape(TILE, K, CIN)
        g = jnp.where(found_ref[:][..., None], g, 0.0)
        out_ref[:] = jnp.dot(g.reshape(TILE, K * CIN), w_ref[:],
                             preferred_element_type=jnp.float32)

    return _tiled_call(kernel, n, K, table.shape, w.shape, COUT, True)(idx, found, table, w)


def pallas_p3(idx, found, table, w):
    """scripts/exp_tal_gather.py:74-97: no grid, whole arrays resident."""
    n, K = idx.shape
    CIN, COUT = table.shape[1], w.shape[2]
    rows = table.shape[0]

    def kernel(idx_ref, found_ref, table_ref, w_ref, out_ref):
        acc = jnp.zeros((rows, COUT), jnp.float32)
        t = table_ref[:]
        for k in range(K):
            ik = jax.lax.broadcast_in_dim(idx_ref[:, k], (rows, CIN), (0,))
            g = jnp.take_along_axis(t, ik, axis=0)
            g = jnp.where(found_ref[:, k][:, None], g, 0)
            acc = acc + jnp.dot(g, w_ref[k], preferred_element_type=jnp.float32)
        out_ref[:] = acc

    return pl.pallas_call(
        kernel, in_specs=[_vmem()] * 4, out_specs=_vmem(),
        out_shape=jax.ShapeDtypeStruct((n, COUT), jnp.float32), interpret=True)(
            idx, found, table, w)


def pallas_p4(idx, found, table, w):
    """scripts/exp_r2_lowering.py:203-225 (section E)."""
    n, K = idx.shape
    CIN, COUT = table.shape[1], w.shape[1]

    def kernel(idx_ref, found_ref, table_ref, w_ref, out_ref):
        idxs = idx_ref[:].reshape(TILE * K)
        bidx = jnp.broadcast_to(idxs[:, None], (TILE * K, CIN))
        g = jnp.take_along_axis(table_ref[:], bidx, axis=0)
        g = g.reshape(TILE, K, CIN)
        g = jnp.where(found_ref[:][..., None], g, 0)
        out_ref[:] = jnp.dot(g.reshape(TILE, K * CIN), w_ref[:],
                             preferred_element_type=jnp.float32)

    return _tiled_call(kernel, n, K, table.shape, w.shape, COUT, True)(idx, found, table, w)


def pallas_p5(body):
    """scripts/exp_r2h_gather2.py:98-127: ``k_fancy`` or ``k_tala0``, no found."""
    def run(idx, found, table, w):
        n, K = idx.shape
        C = table.shape[1]

        def k_fancy(idx_ref, t_ref, w_ref, o_ref):
            g = t_ref[idx_ref[...].reshape(-1), :]
            o_ref[...] = jnp.dot(g.reshape(TILE, K * C), w_ref[...],
                                 preferred_element_type=jnp.float32)

        def k_tala0(idx_ref, t_ref, w_ref, o_ref):
            i2d = jnp.broadcast_to(idx_ref[...].reshape(-1)[:, None], (TILE * K, C))
            g = jnp.take_along_axis(t_ref[...], i2d, axis=0)
            o_ref[...] = jnp.dot(g.reshape(TILE, K * C), w_ref[...],
                                 preferred_element_type=jnp.float32)

        kernel = {"fancy": k_fancy, "tala0": k_tala0}[body]
        return _tiled_call(kernel, n, K, table.shape, w.shape, w.shape[1], False)(idx, table, w)
    return run


def pallas_p6(idx, found, table_t, w):
    """scripts/exp_r2i_lane_gather.py:68-86: lane gather + product."""
    n, K = idx.shape
    C = table_t.shape[0]

    def k_g1(idx_ref, t_ref, w_ref, o_ref):
        flat = idx_ref[...].reshape(1, TILE * K)
        i2d = jnp.broadcast_to(flat, (C, TILE * K))
        g = jnp.take_along_axis(t_ref[...], i2d, axis=-1)
        g = g.reshape(C, TILE, K).transpose(1, 2, 0).reshape(TILE, K * C)
        o_ref[...] = jnp.dot(g, w_ref[...], preferred_element_type=jnp.float32)

    return _tiled_call(k_g1, n, K, table_t.shape, w.shape, w.shape[1], False)(idx, table_t, w)


def pallas_p7(idx, found, table_t, w):
    """scripts/exp_r2i_lane_gather.py:90-107: the lane gather alone."""
    n, K = idx.shape
    C = table_t.shape[0]

    def k_g2(idx_ref, t_ref, o_ref):
        flat = idx_ref[...].reshape(1, TILE * K)
        i2d = jnp.broadcast_to(flat, (C, TILE * K))
        o_ref[0] = jnp.take_along_axis(t_ref[...], i2d, axis=-1)

    return pl.pallas_call(
        k_g2, grid=(n // TILE,),
        in_specs=[_vmem((TILE, K), lambda i: (i, 0)), _vmem(table_t.shape, lambda i: (0, 0))],
        out_specs=_vmem((1, C, TILE * K), lambda i: (i, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((n // TILE, C, TILE * K), jnp.float32),
        interpret=True)(idx, table_t)


CASES = {"P1": ("P1", pallas_p1), "P2": ("P2", pallas_p2), "P3": ("P3", pallas_p3),
         "P4": ("P4", pallas_p4), "P5-fancy": ("P5", pallas_p5("fancy")),
         "P5-tala0": ("P5", pallas_p5("tala0")), "P6": ("P6", pallas_p6),
         "P7": ("P7", pallas_p7)}


def _to_jax(t):
    if t is None:
        return None
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)  # exact: already bf16 values
    return jnp.asarray(t.numpy())


@pytest.mark.parametrize("case", list(CASES))
def test_probe_pallas_body_matches_port(case):
    name, pallas_fn = CASES[case]
    ops = probes.make_operands(name, "cpu", v=V, tile=TILE)
    assert ops.idx.shape[0] == V  # a multiple of TILE: pad and cut leave it alone
    launches = getattr(gp, ops.probe.kernel).launches
    out = probes.kernel_call(ops)()  # the wrapper: CPU tensors take the plain version
    assert getattr(gp, ops.probe.kernel).launches == launches  # no kernel launch on the CPU
    ref = np.asarray(jax.jit(pallas_fn)(_to_jax(ops.idx), _to_jax(ops.found), _to_jax(ops.table),
                                        _to_jax(ops.w)))
    assert out.dtype == torch.float32 and tuple(out.shape) == ref.shape
    assert torch.equal(out, probes.plain_call(ops)())
    if name == "P7":
        np.testing.assert_array_equal(out.numpy(), ref)
        return
    scale = float(np.abs(ref).max())
    assert scale > 0.1
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-4 * scale)
    # kernel A1's plain version computes the same function on the same operands
    np.testing.assert_allclose(probes.a1_call(ops)().numpy(), ref, rtol=1e-4, atol=1e-4 * scale)


@pytest.mark.parametrize("name,table,rows,w,found", [
    ("P1", (150_016, 16), 150_016, (432, 16), True),
    ("P2", (150_016, 16), 150_016, (432, 16), True),
    ("P3", (150_016, 16), 150_016, (27, 16, 16), True),
    ("P4", (80_128, 32), 80_128, (864, 32), True),
    ("P5", (48_000, 32), 48_000, (864, 32), False),
    ("P6", (64, 48_000), 48_000, (1728, 64), False),
    ("P7", (64, 48_000), 48_000, None, False)])
def test_probe_default_operands_are_the_scripts(name, table, rows, w, found):
    """Shapes and types of each probe's operands at the script's defaults."""
    ops = probes.make_operands(name, "cpu")
    bf16 = name in ("P2", "P3", "P4")
    assert tuple(ops.table.shape) == table
    assert ops.table.dtype == (torch.bfloat16 if bf16 else torch.float32)
    assert tuple(ops.idx.shape) == (rows, 27) and ops.idx.dtype == torch.int32
    assert int(ops.idx.max()) < ops.probe.v and int(ops.idx.min()) >= 0
    assert (ops.found is not None) == found
    if found:
        assert ops.found.dtype == torch.bool
        assert abs(float(ops.found.float().mean()) - 0.4) < 0.01
    assert (ops.w is None) == (w is None)
    if w is not None:
        assert tuple(ops.w.shape) == w and ops.w.dtype == ops.table.dtype
    assert ops.probe.round_bf16 == (name == "P1")


def test_first_draws_follow_the_scripts_order():
    """The table is the generator's first draw and idx its second, as in
    every script."""
    rng = np.random.default_rng(0)
    table = rng.normal(size=(V, 16)).astype(np.float32)
    idx = rng.integers(0, V, (V, 27)).astype(np.int32)
    found = rng.random((V, 27)) < 0.4
    w = rng.normal(size=(27 * 16, 16)).astype(np.float32) * 0.1
    ops = probes.make_operands("P1", "cpu", v=V)
    for got, want in ((ops.table, table), (ops.idx, idx), (ops.found, found), (ops.w, w)):
        np.testing.assert_array_equal(got.numpy(), want)


def _small():
    rng = np.random.default_rng(0)
    table = torch.from_numpy(rng.normal(size=(40, 8)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, 40, (16, 3)).astype(np.int32))
    found = torch.from_numpy(rng.random((16, 3)) < 0.5)
    w = torch.from_numpy(rng.normal(size=(24, 4)).astype(np.float32))
    return table, idx, found, w


BAD_CALLS = {
    "flat: idx not int32": (TypeError, lambda t, i, f, w: gp.gather_gemm_flat(t, i.long(), f, w)),
    "flat: found not bool": (TypeError, lambda t, i, f, w: gp.gather_gemm_flat(t, i, f.int(), w)),
    "flat: w rows": (ValueError, lambda t, i, f, w: gp.gather_gemm_flat(t, i, f, w[:-1])),
    "flat: dtypes differ": (TypeError,
                            lambda t, i, f, w: gp.gather_gemm_flat(t, i, f, w.bfloat16())),
    "flat: f64": (TypeError, lambda t, i, f, w: gp.gather_gemm_flat(t.double(), i, f, w.double())),
    "flat: round_bf16 on bf16": (TypeError, lambda t, i, f, w: gp.gather_gemm_flat(
        t.bfloat16(), i, f, w.bfloat16(), round_bf16=True)),
    "flat: batched table": (ValueError, lambda t, i, f, w: gp.gather_gemm_flat(t[None], i, f, w)),
    "flat: too many taps": (ValueError, lambda t, i, f, w: gp.gather_gemm_flat(
        t, i[:, :1].expand(-1, 300).contiguous(), None, w)),
    "per_tap: no found": (TypeError,
                          lambda t, i, f, w: gp.gather_gemm_per_tap(t, i, None, w.reshape(3, 8, 4))),
    "per_tap: flat w": (ValueError, lambda t, i, f, w: gp.gather_gemm_per_tap(t, i, f, w)),
    "lane_gemm: row-major table": (ValueError,
                                   lambda t, i, f, w: gp.lane_gather_gemm(t, i, w[:, :3])),
    "lane: tile 0": (ValueError, lambda t, i, f, w: gp.lane_gather(t.T.contiguous(), i, 0)),
    "lane: idx 1-d": (ValueError, lambda t, i, f, w: gp.lane_gather(t.T.contiguous(), i[0], 4)),
}


@pytest.mark.parametrize("case", list(BAD_CALLS))
def test_probe_wrappers_refuse_bad_operands(case):
    error, call = BAD_CALLS[case]
    with pytest.raises(error):
        call(*_small())


def test_plain_versions_drop_unfound_and_outside_idx():
    """Junk under an unfound tap is never read; an idx outside the table adds
    nothing; all four plain versions agree with one another."""
    table, idx, found, w = _small()
    junk = torch.where(found, idx, 10**8).to(torch.int32)
    ref = gp.gather_gemm_flat(table, idx, found, w)
    assert torch.equal(gp.gather_gemm_flat(table, junk, found, w), ref)
    torch.testing.assert_close(gp.gather_gemm_per_tap(table, junk, found, w.reshape(3, 8, 4)), ref,
                               rtol=1e-5, atol=1e-5)
    table_t = table.T.contiguous()
    torch.testing.assert_close(gp.lane_gather_gemm(table_t, junk, w, found), ref,
                               rtol=1e-5, atol=1e-5)
    outside = idx.clone()
    outside[0, 0], outside[1, 1] = 40, -1
    dropped = found.clone()
    dropped[0, 0] = dropped[1, 1] = False
    always = torch.ones_like(found)
    assert torch.equal(gp.gather_gemm_flat(table, outside, always, w),
                       gp.gather_gemm_flat(table, idx, always & ~(outside != idx), w))
    g = gp.lane_gather(table_t, outside, 4)
    assert g.shape == (4, 8, 12) and float(g[0, :, 0].abs().max()) == 0.0
    assert torch.equal(g[0, :, 1], table[idx[0, 1].item()])
    assert dropped.sum() <= found.sum()


def _run_cli(*args):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    return subprocess.run([sys.executable, "-m", "cpd_tpu_torch.probes.gather", *args], cwd=REPO,
                          env=env, capture_output=True, text=True, timeout=300)


def test_probe_cli_runs_on_the_cpu():
    proc = _run_cli("--cpu", "--v", "512", "--iters", "1")
    assert proc.returncode == 0, proc.stderr
    for name in probes.PROBES:
        assert f"== {name} " in proc.stdout
    lines = [ln for ln in proc.stdout.splitlines() if "maxdiff=" in ln]
    assert len(lines) == 6 * 4 + 2  # two baselines, the probe's version and A1; P7 has two lines
    assert all("CPU" in ln for ln in lines)  # no CPU time under a device metric's name


def test_probe_cli_needs_a_card_without_cpu_flag():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the entry point runs there")
    proc = _run_cli("--only", "P7", "--v", "512")
    assert proc.returncode != 0
    assert "CUDA card" in proc.stderr
