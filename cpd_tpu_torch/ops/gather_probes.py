"""Kernels G1-G4: the gather formulations of the sparse convolution, side by
side with kernel A1 (``ops/gather_gemm.py``).

The JAX package's probe scripts asked one question of the TPU in seven
spellings: how should the gathered rows reach the matrix unit? On Hopper they
reduce to four kernels, each a design of its own:

* G1 ``gather_gemm_flat`` (``csrc/gather_gemm_flat.cu``): one dense product
  over the flattened ``K*Cin`` reduction, gathered rows zero-filled where a
  tap is unfound, on bf16 tensor cores (exact f32 FMAs for f32 operands);
  tiles where no row finds a tap are written as zeros and skipped.
  Replaces ``scripts/exp_pallas_gather.py:82``,
  ``scripts/exp_gather_variants.py:107``, ``scripts/exp_r2_lowering.py:213``
  and ``scripts/exp_r2h_gather2.py:99``.
* G2 ``gather_gemm_per_tap`` (``csrc/gather_gemm_per_tap.cu``): one product
  per tap over the rows that found it, summed in tap order, with all K taps
  of W resident in a block's shared memory and one warp per 32 output rows.
  It takes bf16 operands whose W fits (``g2_route``); f32 operands and wider
  W go to kernel A1, which computes the same function at batch 1. Replaces
  ``scripts/exp_tal_gather.py:86``.
* G3 ``lane_gather_gemm`` (``csrc/lane_gather_gemm.cu``): the same product
  from a table stored transposed ``(C, V)``. Replaces
  ``scripts/exp_r2i_lane_gather.py:75``.
* G4 ``lane_gather`` (``csrc/lane_gather.cu``): the transposed gather alone.
  Replaces ``scripts/exp_r2i_lane_gather.py:96``.

G3 and G4 start with one hand-written transpose (``csrc/lane_common.cuh``)
of the ``(C, V)`` table into a row-major ``(V, C)`` scratch (``lane_rows``),
then gather whole rows: bf16 G3 is G1's kernel on the scratch, f32 G3 an
exact-f32 product of its own, G4 a gather with a channel-major write.

Tables and rulebooks are unbatched here, as in the probes: table ``(V, Cin)``
(``(C, V)`` for G3 and G4), idx and found ``(N, K)``. Every output is f32.
Each wrapper launches its kernel for CUDA tensors and raises on anything the
kernel does not take; for CPU tensors it computes the plain PyTorch version
beside it (``*_reference``). ``<wrapper>.launches`` counts kernel launches.
No model path calls these kernels: they are run by
``python -m cpd_tpu_torch.probes.gather`` and by ``chip_smoke.py``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .cuda_build import DTYPE_CODES, load, on_cuda
from .gather_gemm import (_ARGTYPES as _A1_ARGTYPES, MAX_SMEM, SMS, STAGES, _padded,
                          _round_up, a1_tile_rows, gather_gemm_tiled)

_PTR, _INT = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    "gather_gemm_flat": [_PTR] * 5 + [_INT] * 8 + [_PTR],
    "gather_gemm_per_tap": [_PTR] * 5 + [_INT] * 7 + [_PTR],
    "lane_gather_gemm": [_PTR] * 5 + [_INT] * 6 + [_PTR],
    "lane_gather": [_PTR] * 3 + [_INT] * 5 + [_PTR],
}
_TRANSPOSE_ARGTYPES = [_PTR] * 2 + [_INT] * 3 + [_PTR]
# taps a rulebook may have: kernel G1 keeps a tile's (TM, K) rows in shared memory
MAX_TAPS = 256
G1_TILE_ROWS = (128, 64)
# kernel G3's f32 product: output rows a block, flattened columns a step,
# output rows a thread (``csrc/lane_gather_gemm.cu``)
G3_TILE_ROWS, G3_DEPTH, G3_THREAD_ROWS = 128, 32, 8
# kernel G4: positions a block, channels staged a pass (``csrc/lane_gather.cu``)
G4_POSITIONS, G4_CHANNELS = 128, 64
# kernel G2 (``csrc/gather_gemm_per_tap.cu``): output rows a warp owns; the
# stages of a warp's ring; the most warps a block runs by padded Cout (the
# registers of the accumulator); the fewest warps a block must keep beside W
# for the kernel to take a shape (else A1 does)
G2_TILE_ROWS = 32
G2_DEPTH = 2
G2_MAX_WARPS = {16: 32, 32: 24, 64: 16, 128: 8}
G2_MIN_WARPS = 4


def g1_staged_itemsize(dtype, round_bf16: bool) -> int:
    """Bytes of an operand element as kernel G1 stages it: bf16 for bf16
    operands and for f32 ones rounded in the kernel, else f32."""
    return 2 if round_bf16 or dtype == torch.bfloat16 else 4


def g1_staged_depth(itemsize: int) -> int:
    """Flattened columns G1 stages per step: 64 bf16 (four MMA depths of
    16), 32 f32."""
    return 64 if itemsize == 2 else 32


def g1_smem_bytes(tile_rows: int, k: int, cout: int, itemsize: int) -> int:
    """Dynamic shared memory of one block of G1, as ``csrc/gather_gemm_flat.cu``
    lays it out: the (TM, K) slab of table rows, then the stage buffers (TM
    gathered rows and the W slab, rows padded by 16 bytes)."""
    per, kc = 16 // itemsize, g1_staged_depth(itemsize)
    nt = _padded(cout, (16, 32, 64, 128))
    stage = (tile_rows * (kc + per) + kc * (nt + per)) * itemsize
    return _round_up(tile_rows * k * 4, 16) + STAGES * stage


@functools.lru_cache(maxsize=None)
def g1_tile_rows(n: int, k: int, cout: int, itemsize: int) -> int:
    """Output rows per block of G1, by the rule of ``a1_tile_rows``: 128
    where that fits shared memory and gives every SM a block (counting the
    column tiles above 128 output channels), else 64."""
    fits = [tm for tm in G1_TILE_ROWS if g1_smem_bytes(tm, k, cout, itemsize) <= MAX_SMEM]
    if not fits:
        raise ValueError(f"no tile of kernel G1 fits K={k}, Cout={cout}")
    col_tiles = -(-cout // _padded(cout, (16, 32, 64, 128)))
    return next((tm for tm in fits if -(-n // tm) * col_tiles >= SMS), fits[-1])


def g3_column_tile(cout: int) -> int:
    """Output columns a block of G3's f32 product owns: Cout padded to 16,
    32, 64 or 128 (column tiles of 128 above that)."""
    return _padded(cout, (16, 32, 64, 128))


def g3_threads(cout: int) -> int:
    """Threads a block of G3's f32 product runs: one per 8 rows x 4 columns
    of the tile (8 x 8 at 128 columns), so 64, 128, 256 or 256."""
    nt = g3_column_tile(cout)
    per_thread = G3_THREAD_ROWS * (8 if nt >= 128 else 4)
    return G3_TILE_ROWS * nt // per_thread


def g3_smem_bytes(k: int, cout: int) -> int:
    """Dynamic shared memory of one block of G3's f32 product, as
    ``csrc/lane_gather_gemm.cu`` lays it out: the (TM, K) slab of table rows,
    then the stage buffers (TM gathered rows and the W slab, rows padded by
    16 bytes)."""
    nt = g3_column_tile(cout)
    stage = (G3_TILE_ROWS * (G3_DEPTH + 4) + G3_DEPTH * (nt + 4)) * 4
    return _round_up(G3_TILE_ROWS * k * 4, 16) + STAGES * stage


def g4_grid(n: int, k: int, tile: int):
    """G4's blocks: (tiles, runs of ``G4_POSITIONS`` positions of a tile)."""
    return n // tile, -(-tile * k // G4_POSITIONS)


def g4_smem_bytes() -> int:
    """Shared memory of one block of G4: a pass of ``G4_CHANNELS`` channels x
    ``G4_POSITIONS`` positions in f32, and the positions' table rows."""
    return (G4_CHANNELS + 1) * G4_POSITIONS * 4


def g2_widths(cin: int, cout: int):
    """(Cin, Cout) padded to the kernel's instance widths 16, 32, 64 or 128."""
    widths = (16, 32, 64, 128)
    return _padded(cin, widths), _padded(cout, widths)


def g2_smem_bytes(k: int, cin: int, cout: int, warps: int) -> int:
    """Dynamic shared memory of one block of G2, as
    ``csrc/gather_gemm_per_tap.cu`` lays it out: all K taps of W in bf16
    (rows padded by 16 bytes), then per warp its rulebook slab (32 x K ints)
    and its ring of ``G2_DEPTH`` stages (32 rows of Cin padded, plus 16
    bytes; at least the slab's 32 x K found bytes, which land there first)."""
    kp, nt = g2_widths(cin, cout)
    w = _round_up(k * kp * (nt + 8) * 2, 16)
    ring = max(G2_DEPTH * G2_TILE_ROWS * (kp + 8) * 2, _round_up(G2_TILE_ROWS * k, 16))
    return w + warps * (_round_up(G2_TILE_ROWS * k * 4, 16) + ring)


def g2_max_warps(k: int, cin: int, cout: int) -> int:
    """The most warps a block of G2 can run: the registers' cap for the
    width (``G2_MAX_WARPS``) or as many as fit beside W in shared memory; 0
    for Cin or Cout above 128."""
    if cin > 128 or cout > 128:
        return 0
    cap = G2_MAX_WARPS[g2_widths(cin, cout)[1]]
    return next((w for w in range(cap, 0, -1)
                 if g2_smem_bytes(k, cin, cout, w) <= MAX_SMEM), 0)


def g2_route(k: int, cin: int, cout: int, dtype) -> str:
    """Which kernel ``gather_gemm_per_tap`` launches: "own" (G2's kernel)
    for bf16 operands whose W leaves room beside it for ``G2_MIN_WARPS``
    warps, "A1" for f32 operands and wider W."""
    own = dtype == torch.bfloat16 and g2_max_warps(k, cin, cout) >= G2_MIN_WARPS
    return "own" if own else "A1"


@functools.lru_cache(maxsize=None)
def g2_warps(n: int, k: int, cin: int, cout: int) -> int:
    """Warps a block of G2's own kernel runs for ``n`` output rows. Each
    warp runs its tiles in rounds, and a last round that few warps run costs
    about as long as a full one (one warp's taps, one after the other), so
    the warps are as few as keep the rounds at their least (``SMS`` blocks,
    one an SM)."""
    rounds = max(1, -(-g2_warp_tiles(n) // (SMS * g2_max_warps(k, cin, cout))))
    return -(-g2_warp_tiles(n) // (SMS * rounds))


def g2_warp_tiles(n: int) -> int:
    """Tiles of ``G2_TILE_ROWS`` output rows, one warp's work each."""
    return -(-n // G2_TILE_ROWS)


def lane_scratch_shape(table_t):
    """The shape of the row-major scratch that G3 and G4 transpose the
    ``(C, V)`` table into (of the table's dtype): ``(V, C)``."""
    c, v = table_t.shape
    return v, c


def _gathered(table, idx, found):
    """(N, K, Cin) f32: table rows at idx, zero where not found or where idx
    lies outside the table."""
    ok = (idx >= 0) & (idx < table.shape[0])
    if found is not None:
        ok = ok & found
    g = table.float()[torch.where(ok, idx.long(), 0)]
    return torch.where(ok[..., None], g, 0.0)


def _rounded(t, round_bf16: bool):
    return t.bfloat16().float() if round_bf16 else t.float()


def gather_gemm_flat_reference(table, idx, found, w_flat, round_bf16=False):
    """Plain PyTorch version of kernel G1: gather, where, einsum, in f32 (the
    operands rounded to bf16 first with ``round_bf16``).

    table (V, Cin); idx (N, K); found (N, K) or None; w_flat (K*Cin, Cout)
    -> (N, Cout) f32."""
    k = idx.shape[-1]
    w = _rounded(w_flat, round_bf16).reshape(k, table.shape[-1], -1)
    return torch.einsum("nkc,kcd->nd", _gathered(_rounded(table, round_bf16), idx, found), w)


def gather_gemm_flat_tiled(table, idx, found, w_flat, round_bf16=False, tile_rows=None):
    """Kernel G1's order of arithmetic in plain PyTorch (for tests; small
    sizes only): per tile of ``tile_rows`` output rows the rulebook slab as
    table rows or -1; a tile where no row finds a tap is zeros and nothing
    else (never multiplied: a NaN in W does not reach it); otherwise the
    flattened operand, zero where a tap is unfound or its idx outside the
    table, in the staged type, its ``K*Cin`` columns padded to a multiple of
    16, multiplied a staged depth at a time and summed in f32."""
    (v, cin), (n, k), cout = table.shape, idx.shape, w_flat.shape[1]
    itemsize = g1_staged_itemsize(table.dtype, round_bf16)
    staged = torch.bfloat16 if itemsize == 2 else torch.float32
    tm = tile_rows or g1_tile_rows(n, k, cout, itemsize)
    q, kc = k * cin, g1_staged_depth(itemsize)
    qp = _round_up(q, 16)
    w = torch.zeros((qp, cout), dtype=staged)
    w[:q] = w_flat.to(staged)
    ok = (idx >= 0) & (idx < v)
    if found is not None:
        ok = ok & found
    out = torch.zeros((n, cout), dtype=torch.float32)
    for n0 in range(0, n, tm):
        rows = torch.where(ok[n0:n0 + tm], idx[n0:n0 + tm].long(), -1)
        if not bool((rows >= 0).any()):
            continue  # the skip: zeros, no gather, no product
        a = torch.zeros((rows.shape[0], qp), dtype=staged)
        g = table.to(staged)[rows.clamp(min=0)]
        a[:, :q] = torch.where((rows >= 0)[..., None], g, 0).reshape(rows.shape[0], q)
        for q0 in range(0, qp, kc):
            out[n0:n0 + tm] += a[:, q0:q0 + kc].float() @ w[q0:q0 + kc].float()
    return out


def gather_gemm_per_tap_reference(table, idx, found, w):
    """Plain PyTorch version of kernel G2: per tap a gather, a where and a
    product, summed in tap order in f32.

    table (V, Cin); idx/found (N, K); w (K, Cin, Cout) -> (N, Cout) f32."""
    out = torch.zeros((idx.shape[0], w.shape[-1]), dtype=torch.float32, device=table.device)
    for k in range(idx.shape[-1]):
        out = out + _gathered(table, idx[:, k:k + 1], found[:, k:k + 1])[:, 0] @ w[k].float()
    return out


def gather_gemm_per_tap_tiled(table, idx, found, w):
    """Kernel G2's order of arithmetic in plain PyTorch (for tests; small
    sizes only). Where G2's own kernel runs (``g2_route``): per warp tile of
    ``G2_TILE_ROWS`` output rows an f32 accumulator; per tap in tap order the
    tile's hit rows (found, idx inside the table) staged at their own rows,
    every other row zero; each half of 16 rows that has a hit multiplied,
    16 input channels at a time, in bf16 summed in f32, and added into the
    accumulator; a half without a hit, and a tap without one, untouched (a
    NaN in W does not reach them). Where A1 runs: A1's order
    (``gather_gemm_tiled``) at batch 1."""
    (v, cin), (n, k), cout = table.shape, idx.shape, w.shape[-1]
    if g2_route(k, cin, cout, table.dtype) == "A1":
        return gather_gemm_tiled(table[None], idx[None], found[None],
                                 w.reshape(k * cin, cout))[0]
    ok = found & (idx >= 0) & (idx < v)
    out = torch.zeros((n, cout), dtype=torch.float32)
    for n0 in range(0, n, G2_TILE_ROWS):
        acc = out[n0:n0 + G2_TILE_ROWS]
        for kk in range(k):
            hit = ok[n0:n0 + G2_TILE_ROWS, kk]
            rows = torch.where(hit, idx[n0:n0 + G2_TILE_ROWS, kk].long(), 0)
            a = torch.where(hit[:, None], table[rows], 0)
            for h0 in range(0, len(hit), 16):
                if not bool(hit[h0:h0 + 16].any()):
                    continue  # the half is neither staged nor multiplied
                for c0 in range(0, cin, 16):
                    acc[h0:h0 + 16] += (a[h0:h0 + 16, c0:c0 + 16].float()
                                        @ w[kk, c0:c0 + 16].float())
    return out


def lane_gather_gemm_reference(table_t, idx, w_flat, found=None):
    """Plain PyTorch version of kernel G3: gather along the voxel axis of the
    transposed table, reorder to (N, K*C), one product, in f32.

    table_t (C, V); idx (N, K); w_flat (K*C, Cout); found (N, K) or None
    -> (N, Cout) f32."""
    c, v = table_t.shape
    n, k = idx.shape
    ok = (idx >= 0) & (idx < v)
    if found is not None:
        ok = ok & found
    g = table_t.float()[:, torch.where(ok, idx.long(), 0).reshape(-1)]  # (C, N*K)
    g = torch.where(ok.reshape(1, -1), g, 0.0)
    return g.reshape(c, n, k).permute(1, 2, 0).reshape(n, k * c) @ w_flat.float()


def lane_gather_reference(table_t, idx, tile: int):
    """Plain PyTorch version of kernel G4: out[i, c, q] = table_t[c,
    idx_flat[i * tile*K + q]] (0 for an idx outside the table).

    table_t (C, V); idx (N, K) -> (N // tile, C, tile*K) f32; rows past the
    last whole tile are not covered."""
    c, v = table_t.shape
    tiles, tq = idx.shape[0] // tile, tile * idx.shape[1]
    flat = idx.reshape(-1)[:tiles * tq].long()
    ok = (flat >= 0) & (flat < v)
    g = torch.where(ok[None], table_t.float()[:, torch.where(ok, flat, 0)], 0.0)
    return g.reshape(c, tiles, tq).permute(1, 0, 2).contiguous()


def lane_gather_gemm_tiled(table_t, idx, w_flat, found=None):
    """Kernel G3's formulation in plain PyTorch (for tests; small sizes
    only): the transpose (``lane_rows``), then on the row-major copy G1's
    order of arithmetic for bf16 operands (``gather_gemm_flat_tiled``); for
    f32 ones which rows are read and which are skipped, not the kernel's
    order of arithmetic: per tile of ``G3_TILE_ROWS`` output rows the slab as
    table rows or -1, a tile where no row finds a tap as zeros and nothing
    else, otherwise the flattened operand (zero where a tap is unfound or its
    idx outside the table) times W, ``G3_DEPTH`` columns at a time, in f32.
    The kernel sums each output's ``K*C`` columns in order in one fused
    accumulator, so it agrees with this to rounding (1e-4 of scale), not bit
    for bit."""
    rows = lane_rows(table_t)
    if table_t.dtype == torch.bfloat16:
        return gather_gemm_flat_tiled(rows, idx, found, w_flat)
    (v, c), (n, k), cout = rows.shape, idx.shape, w_flat.shape[1]
    ok = (idx >= 0) & (idx < v)
    if found is not None:
        ok = ok & found
    w = w_flat.float()
    out = torch.zeros((n, cout), dtype=torch.float32)
    for n0 in range(0, n, G3_TILE_ROWS):
        r = torch.where(ok[n0:n0 + G3_TILE_ROWS], idx[n0:n0 + G3_TILE_ROWS].long(), -1)
        if not bool((r >= 0).any()):
            continue  # the skip: zeros, no gather, no product
        a = torch.where((r >= 0)[..., None], rows[r.clamp(min=0)], 0.0).reshape(r.shape[0], -1)
        for q0 in range(0, k * c, G3_DEPTH):
            out[n0:n0 + G3_TILE_ROWS] += a[:, q0:q0 + G3_DEPTH] @ w[q0:q0 + G3_DEPTH]
    return out


def lane_gather_tiled(table_t, idx, tile: int):
    """Kernel G4's formulation in plain PyTorch (for tests; small sizes
    only): the transpose (``lane_rows``), then per run of ``G4_POSITIONS``
    positions of a tile the positions' table rows (-1 for an idx outside the
    table), each position's whole row (zeros for -1), written channel-major,
    ``G4_CHANNELS`` channels a pass."""
    rows = lane_rows(table_t).float()
    (v, c), k = rows.shape, idx.shape[1]
    (tiles, runs), tq = g4_grid(idx.shape[0], k, tile), tile * k
    flat = idx.reshape(-1).long()
    out = torch.empty((tiles, c, tq), dtype=torch.float32)
    for i in range(tiles):
        for q0 in range(0, runs * G4_POSITIONS, G4_POSITIONS):
            q1 = min(tq, q0 + G4_POSITIONS)
            src = flat[i * tq + q0:i * tq + q1]
            src = torch.where((src >= 0) & (src < v), src, -1)
            got = torch.where((src >= 0)[:, None], rows[src.clamp(min=0)], 0.0)
            for c0 in range(0, c, G4_CHANNELS):
                out[i, c0:c0 + G4_CHANNELS, q0:q1] = got[:, c0:c0 + G4_CHANNELS].T
    return out


def _check_table(name, table, idx, found, cin_axis: int):
    if table.dim() != 2 or idx.dim() != 2:
        raise ValueError(f"want {name} 2-d and idx (N, K); got {tuple(table.shape)}, "
                         f"{tuple(idx.shape)}")
    if idx.dtype != torch.int32:
        raise TypeError(f"idx must be int32, got {idx.dtype}")
    if found is not None and (found.shape != idx.shape or found.dtype != torch.bool):
        raise TypeError(f"found must be bool of idx's shape {tuple(idx.shape)}, got "
                        f"{found.dtype} {tuple(found.shape)}")
    if table.dtype not in DTYPE_CODES:
        raise TypeError(f"{name} must be float32 or bfloat16, got {table.dtype}")
    if idx.shape[1] > MAX_TAPS:
        raise ValueError(f"at most {MAX_TAPS} taps, got {idx.shape[1]}")
    v, cin = table.shape[1 - cin_axis], table.shape[cin_axis]
    if max(v * cin, idx.numel() * max(cin, 1)) >= 2**31:
        raise ValueError("tensor too large for the kernels' 32-bit row indices")


def _check_weights(table, idx, w, cin: int):
    k = idx.shape[1]
    if w.dtype != table.dtype:
        raise TypeError(f"table/w must share float32 or bfloat16, got {table.dtype}/{w.dtype}")
    if w.numel() == 0 or w.shape[:-1].numel() != k * cin:
        raise ValueError(f"shape mismatch: table {tuple(table.shape)}, idx {tuple(idx.shape)}, "
                         f"w {tuple(w.shape)}")
    if idx.shape[0] * w.shape[-1] >= 2**31:
        raise ValueError("tensor too large for the kernels' 32-bit row indices")


def _named(**tensors):
    return tuple((k, v) for k, v in tensors.items() if v is not None)


def _launch(name, fn, table, *args):
    with torch.cuda.device(table.device):  # launch on the operands' card
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def gather_gemm_flat(table, idx, found, w_flat, round_bf16=False, *, tile_rows=None):
    """out[n] = concat_k(found[n, k] ? table[idx[n, k]] : 0) @ w_flat in f32;
    ``found=None`` reads every tap; ``round_bf16`` (f32 operands only) rounds
    table and weights to bf16 inside the kernel. CUDA tensors run kernel G1;
    CPU tensors the plain version. ``tile_rows`` (64 or 128) overrides the
    output rows per block (``g1_tile_rows``)."""
    _check_table("table", table, idx, found, cin_axis=1)
    if w_flat.dim() != 2:
        raise ValueError(f"w_flat must be (K*Cin, Cout), got {tuple(w_flat.shape)}")
    _check_weights(table, idx, w_flat, table.shape[1])
    if round_bf16 and table.dtype != torch.float32:
        raise TypeError("round_bf16 applies to float32 operands")
    if not on_cuda(_named(table=table, idx=idx, found=found, w_flat=w_flat)):
        return gather_gemm_flat_reference(table, idx, found, w_flat, round_bf16)
    fn = load("gather_gemm_flat", _ARGTYPES["gather_gemm_flat"])
    (v, cin), (n, k), cout = table.shape, idx.shape, w_flat.shape[1]
    if tile_rows is None:
        tile_rows = g1_tile_rows(n, k, cout, g1_staged_itemsize(table.dtype, round_bf16))
    out = torch.empty((n, cout), dtype=torch.float32, device=table.device)
    _launch("gather_gemm_flat", fn, table, table.data_ptr(), idx.data_ptr(),
            None if found is None else found.data_ptr(), w_flat.data_ptr(), out.data_ptr(),
            v, n, k, cin, cout, DTYPE_CODES[table.dtype], int(round_bf16), tile_rows)
    gather_gemm_flat.launches += 1
    return out


gather_gemm_flat.launches = 0


def gather_gemm_per_tap(table, idx, found, w, *, warps=None):
    """out[n] = sum_k (found[n, k] ? table[idx[n, k]] @ w[k] : 0), the taps
    summed in order in f32; w is (K, Cin, Cout). CUDA tensors run kernel G2:
    its own kernel for bf16 operands whose W fits its shared memory, kernel
    A1's entry point at batch 1 for f32 operands and wider W (``g2_route``;
    either launch counts here, not in ``gather_gemm.launches``). CPU tensors
    compute the plain version. ``warps`` overrides the warps a block of the
    own kernel runs (``g2_warps``); the result's bits do not depend on it."""
    _check_table("table", table, idx, found, cin_axis=1)
    if found is None:
        raise TypeError("gather_gemm_per_tap needs found")
    if w.dim() != 3 or w.shape[1] != table.shape[1]:
        raise ValueError(f"w must be (K, Cin, Cout) with Cin {table.shape[1]}, got "
                         f"{tuple(w.shape)}")
    _check_weights(table, idx, w, table.shape[1])
    if not on_cuda(_named(table=table, idx=idx, found=found, w=w)):
        return gather_gemm_per_tap_reference(table, idx, found, w)
    (v, cin), (n, k), cout = table.shape, idx.shape, w.shape[2]
    out = torch.empty((n, cout), dtype=torch.float32, device=table.device)
    args = (table.data_ptr(), idx.data_ptr(), found.data_ptr(), w.data_ptr(), out.data_ptr())
    if g2_route(k, cin, cout, table.dtype) == "own":
        fn = load("gather_gemm_per_tap", _ARGTYPES["gather_gemm_per_tap"])
        _launch("gather_gemm_per_tap", fn, table, *args, v, n, k, cin, cout,
                DTYPE_CODES[torch.bfloat16], warps or g2_warps(n, k, cin, cout))
    else:  # w (K, Cin, Cout) is A1's (K*Cin, Cout) in the same memory
        fn = load("gather_gemm", _A1_ARGTYPES["gather_gemm"])
        _launch("gather_gemm_per_tap (A1's kernel)", fn, table, *args, 1, v, n, k, cin, cout,
                DTYPE_CODES[table.dtype], DTYPE_CODES[torch.float32],
                a1_tile_rows(1, n, k, cin, cout, table.element_size()))
    gather_gemm_per_tap.launches += 1
    return out


gather_gemm_per_tap.launches = 0


def lane_rows(table_t):
    """The row-major ``(V, C)`` copy of a transposed table that G3 and G4
    start with. CUDA tensors: the hand-written transpose of
    ``csrc/lane_common.cuh`` (exported by G4's library), launched on the
    current stream into a scratch from ``torch.empty``; CPU tensors:
    ``table_t.T.contiguous()``. Exact either way."""
    if table_t.dim() != 2 or table_t.dtype not in DTYPE_CODES:
        raise ValueError(f"want a 2-d float32 or bfloat16 table_t, got {table_t.dtype} "
                         f"{tuple(table_t.shape)}")
    if not on_cuda(_named(table_t=table_t)):
        return table_t.T.contiguous()
    fn = load("lane_gather", _TRANSPOSE_ARGTYPES, symbol="cpd_lane_gather_transpose")
    c, v = table_t.shape
    rows = torch.empty(lane_scratch_shape(table_t), dtype=table_t.dtype, device=table_t.device)
    _launch("lane transpose", fn, table_t, table_t.data_ptr(), rows.data_ptr(), c, v,
            DTYPE_CODES[table_t.dtype])
    return rows


def lane_gather_gemm(table_t, idx, w_flat, found=None):
    """out[n] = concat_k(table_t[:, idx[n, k]]) @ w_flat in f32, the table
    stored transposed (C, V); with ``found``, unfound taps contribute zero.
    CUDA tensors run kernel G3: the transpose (``lane_rows``), then on the
    row-major scratch kernel G1's product for bf16 operands or G3's exact
    f32 product for f32 ones; CPU tensors the plain version."""
    _check_table("table_t", table_t, idx, found, cin_axis=0)
    if w_flat.dim() != 2:
        raise ValueError(f"w_flat must be (K*C, Cout), got {tuple(w_flat.shape)}")
    _check_weights(table_t, idx, w_flat, table_t.shape[0])
    if not on_cuda(_named(table_t=table_t, idx=idx, found=found, w_flat=w_flat)):
        return lane_gather_gemm_reference(table_t, idx, w_flat, found)
    (c, v), (n, k), cout = table_t.shape, idx.shape, w_flat.shape[1]
    rows = lane_rows(table_t)
    out = torch.empty((n, cout), dtype=torch.float32, device=table_t.device)
    found_ptr = None if found is None else found.data_ptr()
    if table_t.dtype == torch.bfloat16:
        fn = load("gather_gemm_flat", _ARGTYPES["gather_gemm_flat"])
        _launch("lane_gather_gemm (G1's product)", fn, table_t, rows.data_ptr(), idx.data_ptr(),
                found_ptr, w_flat.data_ptr(), out.data_ptr(), v, n, k, c, cout,
                DTYPE_CODES[torch.bfloat16], 0, g1_tile_rows(n, k, cout, 2))
    else:
        fn = load("lane_gather_gemm", _ARGTYPES["lane_gather_gemm"])
        _launch("lane_gather_gemm", fn, table_t, rows.data_ptr(), idx.data_ptr(), found_ptr,
                w_flat.data_ptr(), out.data_ptr(), v, n, k, c, cout, DTYPE_CODES[torch.float32])
    lane_gather_gemm.launches += 1
    return out


lane_gather_gemm.launches = 0


def lane_gather(table_t, idx, tile: int):
    """out[i, c, q] = table_t[c, idx_flat[i * tile*K + q]] as (N // tile, C,
    tile*K) f32; rows past the last whole tile are not covered. CUDA tensors
    run kernel G4 (the transpose, ``lane_rows``, then the gather of whole
    rows); CPU tensors the plain version."""
    _check_table("table_t", table_t, idx, None, cin_axis=0)
    if tile <= 0:
        raise ValueError(f"tile must be positive, got {tile}")
    if not on_cuda(_named(table_t=table_t, idx=idx)):
        return lane_gather_reference(table_t, idx, tile)
    fn = load("lane_gather", _ARGTYPES["lane_gather"])
    (c, v), (n, k) = table_t.shape, idx.shape
    rows = lane_rows(table_t)
    out = torch.empty((n // tile, c, tile * k), dtype=torch.float32, device=table_t.device)
    _launch("lane_gather", fn, table_t, rows.data_ptr(), idx.data_ptr(), out.data_ptr(),
            v, c, n // tile, tile * k, DTYPE_CODES[table_t.dtype])
    lane_gather.launches += 1
    return out


lane_gather.launches = 0
