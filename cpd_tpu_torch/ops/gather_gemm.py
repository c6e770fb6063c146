"""Kernels A1 and A2: the fused gather-GEMM of the sparse convolution.

* A1, ``gather_gemm``: masked im2col gather + GEMM. It is the forward of
  every sparse conv and, launched on other operands (dY as the table, the
  transpose rulebook, ``W^T`` per tap as ``(K*Cout, Cin)``), also its input
  gradient dX. Replaces the TPU kernel
  ``cpd_tpu/ops/pallas_conv.py::gather_gemm``; source ``csrc/gather_gemm.cu``.
* A2, ``gather_gemm_dw``: the weight gradient
  ``dW[k] = sum_rows found ? X[idx]^T dY : 0``. Replaces the TPU kernel
  ``cpd_tpu/ops/pallas_conv.py::gather_gemm_dw``; source
  ``csrc/gather_gemm_dw.cu``. The TPU kernel adds every row tile into one
  resident output block across a sequential grid; blocks on a GPU run in no
  order, so A2 writes per-chunk partial sums into scratch that this wrapper
  allocates and reduces them in a second, fixed-order pass: no float atomics,
  the same bits from run to run.

Both kernels read a block's slab of the rulebook once, compact every tap's
found rows into a hit list up front, and multiply only those: bf16 operands
on the tensor cores (``mma.sync``), f32 operands in exact f32 on the CUDA
cores (chosen by the operands' dtype). Each source's header says what bounds
its kernel on an H100 and what the design does about it. Both are built and
bound by ``ops/cuda_build.py`` (``nvcc`` for ``sm_90a`` at first use, plain C
entry points through ``ctypes``) and launched on PyTorch's current stream.

What the kernels leave to the host is here and runs on the CPU too: the tile
of output rows a block of A1 owns (``a1_tile_rows``), the rows and taps a
block of A2 owns (``a2_plan``), and the shared memory each choice asks for.
``gather_gemm_tiled`` and ``gather_gemm_dw_tiled`` restate the kernels' order
of arithmetic in plain PyTorch for the CPU tests.

A wrapper launches its kernel for CUDA tensors and raises on anything the
kernel does not take; for CPU tensors it computes the plain version
(``gather_gemm_reference``, ``gather_gemm_dw_reference``).
``gather_gemm.launches`` and ``gather_gemm_dw.launches`` count kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .cuda_build import DTYPE_CODES as _DTYPE_CODES, load, on_cuda as _on_cuda

SMS = 132                # streaming multiprocessors of an H100
MAX_SMEM = 232448        # dynamic shared memory a block may ask for on sm_90
MAX_TAPS = 32            # taps whose hit lists a block holds at once
A1_TILE_ROWS = (128, 64)
STAGES = 2               # stage buffers a block rings through (csrc/gather_common.cuh)
# A2: the most hit-list entries (taps x rows) a block holds, and the most
# scratch the two-pass sum may take
DW_LIST_ENTRIES = 4096
DW_SCRATCH_BYTES = 48 * 2**20
_ARGTYPES = {
    "gather_gemm": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [ctypes.c_void_p],
    "gather_gemm_dw": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [ctypes.c_void_p],
}


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def _padded(c: int, widths) -> int:
    """The narrowest of the kernels' template widths that holds ``c`` channels."""
    return next((w for w in widths if c <= w), widths[-1])


def a1_staged_depth(cin: int, itemsize: int) -> int:
    """Input channels A1 stages per step: Cin rounded up to 16, at most 64
    for bf16 and 32 for f32 (wider rows run as several steps per tap)."""
    return _padded(cin, (16, 32, 64) if itemsize == 2 else (16, 32))


def a1_smem_bytes(tile_rows: int, k: int, cin: int, cout: int, itemsize: int) -> int:
    """Dynamic shared memory of one block of A1, as ``csrc/gather_gemm.cu``
    lays it out: the hit lists, the f32 accumulator, the stage buffers."""
    per = 16 // itemsize
    kc, nt = a1_staged_depth(cin, itemsize), _padded(cout, (16, 32, 64, 128))
    taps = min(k, MAX_TAPS)
    lists = taps * tile_rows * 4 + MAX_TAPS * 4 + _round_up(taps * tile_rows * 2, 16)
    acc = tile_rows * (nt + 8) * 4
    stage = (tile_rows * (kc + per) + kc * (nt + per)) * itemsize
    return lists + acc + STAGES * stage


@functools.lru_cache(maxsize=None)
def a1_tile_rows(b: int, n: int, k: int, cin: int, cout: int, itemsize: int) -> int:
    """Output rows per block of A1: 128 where that fits shared memory and
    gives every SM a block, else 64. A larger tile finds each tap more often
    (its 16-row fragments pad less, W[k] is re-read by fewer blocks); too few
    blocks leave SMs idle. 192 and 256 rows run too (``tile_rows=``) and win
    where every row of the rulebook is live, but a stage's rulebook is padded
    to its cap and only half to two thirds of its rows find anything: on a
    lidar frame's real rulebooks 128 rows measured fastest or level on every
    layer shape."""
    fits = [tm for tm in A1_TILE_ROWS if a1_smem_bytes(tm, k, cin, cout, itemsize) <= MAX_SMEM]
    if not fits:
        raise ValueError(f"no tile of kernel A1 fits K={k}, Cin={cin}, Cout={cout}")
    return next((tm for tm in fits if b * -(-n // tm) >= SMS), fits[-1])


@functools.lru_cache(maxsize=None)
def a2_plan(rows: int, k: int, cin: int, cout: int):
    """(chunk_rows, taps) one block of A2 owns. Their product, the hit-list
    entries a block holds, is the rulebook's share of one of two blocks per
    SM, between ``DW_LIST_ENTRIES`` / 4 and ``DW_LIST_ENTRIES``. A block
    takes a ninth of the taps (3 of 27: more blocks for the same lists, and
    measured fastest on every layer shape) unless the scratch, one (K, Cin,
    Cout) f32 partial per chunk, would pass ``DW_SCRATCH_BYTES``; then one
    tap over longer chunks."""
    tile_bytes = k * cin * cout * 4
    entries = min(max(rows * k // (2 * SMS), DW_LIST_ENTRIES // 4), DW_LIST_ENTRIES)
    for taps in (min(-(-k // 9), MAX_TAPS), 1):
        chunk_rows = max(32, min(entries // taps // 32 * 32, _round_up(rows, 32)))
        if -(-rows // chunk_rows) * tile_bytes <= DW_SCRATCH_BYTES or taps == 1:
            return chunk_rows, taps


def a2_hits_per_step(cin: int, cout: int, itemsize: int) -> int:
    """Hits of a tap's list that A2 multiplies per step."""
    widths = (16, 32, 64, 128)
    wide = _padded(cin, widths) + _padded(cout, widths) > 128
    return (64 if wide else 128) * 2 // itemsize


def a2_smem_bytes(chunk_rows: int, taps: int, cin: int, cout: int, itemsize: int) -> int:
    """Dynamic shared memory of one block of A2, as ``csrc/gather_gemm_dw.cu``
    lays it out: the hit lists, the step table, the stage buffers."""
    per, widths = 16 // itemsize, (16, 32, 64, 128)
    lists = (taps * chunk_rows * 4 + MAX_TAPS * 4 + (MAX_TAPS + 4) * 4
             + _round_up(taps * chunk_rows * 2, 16))
    stage = (a2_hits_per_step(cin, cout, itemsize)
             * (_padded(cin, widths) + _padded(cout, widths) + 2 * per) * itemsize)
    return lists + STAGES * stage


def _gather_rows(table, idx, found):
    """(B, N, K, Cin) f32 im2col: table rows at idx, zero where not found."""
    b, n, k = idx.shape
    cin = table.shape[-1]
    safe = torch.where(found, idx.long(), 0)
    g = torch.gather(table.float(), 1,
                     safe.reshape(b, n * k, 1).expand(-1, -1, cin)).reshape(b, n, k, cin)
    return torch.where(found[..., None], g, 0.0)


def gather_gemm_reference(table, idx, found, w_flat, out_dtype=torch.float32):
    """Plain PyTorch version of kernel A1: gather, where, einsum, in f32.

    table (B, V, Cin); idx/found (B, N, K); w_flat (K*Cin, Cout)
    -> (B, N, Cout) in ``out_dtype``."""
    k = idx.shape[-1]
    w = w_flat.float().reshape(k, table.shape[-1], -1)
    return torch.einsum("bnkc,kcd->bnd", _gather_rows(table, idx, found), w).to(out_dtype)


def gather_gemm_dw_reference(table, idx, found, g_out):
    """Plain PyTorch version of kernel A2: gather, where, einsum, in f32.

    table (B, V, Cin); idx/found (B, N, K); g_out (B, N, Cout)
    -> (K*Cin, Cout) f32."""
    k = idx.shape[-1]
    dw = torch.einsum("bnkc,bnd->kcd", _gather_rows(table, idx, found), g_out.float())
    return dw.reshape(k * table.shape[-1], -1)


def _check_rulebook(table, idx, found):
    if table.dim() != 3 or idx.dim() != 3 or found.shape != idx.shape:
        raise ValueError(f"want table (B,V,Cin), idx/found (B,N,K); got "
                         f"{tuple(table.shape)}, {tuple(idx.shape)}, {tuple(found.shape)}")
    if idx.shape[0] != table.shape[0]:
        raise ValueError(f"batch mismatch: table {tuple(table.shape)}, idx {tuple(idx.shape)}")
    if idx.dtype != torch.int32 or found.dtype != torch.bool:
        raise TypeError(f"idx must be int32 and found bool, got {idx.dtype}/{found.dtype}")


def _check(table, idx, found, w_flat, out_dtype):
    _check_rulebook(table, idx, found)
    b, v, cin = table.shape
    k = idx.shape[-1]
    if w_flat.dim() != 2 or w_flat.shape[0] != k * cin:
        raise ValueError(f"shape mismatch: table {tuple(table.shape)}, idx "
                         f"{tuple(idx.shape)}, w_flat {tuple(w_flat.shape)}")
    if table.dtype not in _DTYPE_CODES or w_flat.dtype != table.dtype:
        raise TypeError(f"table/w must share float32 or bfloat16, got "
                        f"{table.dtype}/{w_flat.dtype}")
    if out_dtype not in _DTYPE_CODES:
        raise TypeError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    if max(b * v * cin, b * idx.shape[1] * max(k, w_flat.shape[1])) >= 2**31:
        raise ValueError("tensor too large for the kernel's 32-bit row indices")


def gather_gemm(table, idx, found, w_flat, out_dtype=torch.float32, *, tile_rows=None):
    """out[b, n] = sum_k found[b, n, k] * table[b, idx[b, n, k]] @ W[k], with
    W = w_flat.reshape(K, Cin, Cout); f32 accumulation, rounded once to
    ``out_dtype``. CUDA tensors run kernel A1; CPU tensors the plain version.
    ``tile_rows`` overrides the output rows per block (``a1_tile_rows``)."""
    _check(table, idx, found, w_flat, out_dtype)
    if not _on_cuda((("table", table), ("idx", idx), ("found", found), ("w_flat", w_flat))):
        return gather_gemm_reference(table, idx, found, w_flat, out_dtype)
    fn = load("gather_gemm", _ARGTYPES["gather_gemm"])
    b, v, cin = table.shape
    n, k = idx.shape[1:]
    cout = w_flat.shape[1]
    if tile_rows is None:
        tile_rows = a1_tile_rows(b, n, k, cin, cout, table.element_size())
    out = torch.empty((b, n, cout), dtype=out_dtype, device=table.device)
    with torch.cuda.device(table.device):  # launch on the operands' card
        err = fn(table.data_ptr(), idx.data_ptr(), found.data_ptr(), w_flat.data_ptr(),
                 out.data_ptr(), b, v, n, k, cin, cout, _DTYPE_CODES[table.dtype],
                 _DTYPE_CODES[out_dtype], tile_rows, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"gather_gemm kernel launch failed: CUDA error {err}")
    gather_gemm.launches += 1
    return out


gather_gemm.launches = 0


def gather_gemm_dw(table, idx, found, g_out, *, plan=None):
    """dW[k*Cin + c, d] = sum_{b, n} found[b, n, k] * table[b, idx[b, n, k], c]
    * g_out[b, n, d], accumulated and returned in f32 as (K*Cin, Cout). The
    sum over rows runs in a fixed order (deterministic). CUDA tensors run
    kernel A2; CPU tensors the plain version. ``plan`` overrides the
    (chunk_rows, taps) a block owns (``a2_plan``)."""
    _check_rulebook(table, idx, found)
    b, v, cin = table.shape
    n, k = idx.shape[1:]
    if g_out.dim() != 3 or tuple(g_out.shape[:2]) != (b, n):
        raise ValueError(f"g_out must be (B, N, Cout) = ({b}, {n}, *), got "
                         f"{tuple(g_out.shape)}")
    if table.dtype not in _DTYPE_CODES or g_out.dtype != table.dtype:
        raise TypeError(f"table/g_out must share float32 or bfloat16, got "
                        f"{table.dtype}/{g_out.dtype}")
    cout = g_out.shape[-1]
    if max(b * v * cin, b * n * max(k, cout)) >= 2**31:
        raise ValueError("tensor too large for the kernel's 32-bit row indices")
    if not _on_cuda((("table", table), ("idx", idx), ("found", found), ("g_out", g_out))):
        return gather_gemm_dw_reference(table, idx, found, g_out)
    out = torch.empty((k * cin, cout), dtype=torch.float32, device=table.device)
    if b * n == 0 or out.numel() == 0:
        return out.zero_()
    fn = load("gather_gemm_dw", _ARGTYPES["gather_gemm_dw"])
    chunk_rows, taps = plan or a2_plan(b * n, k, cin, cout)
    partial = torch.empty(dw_scratch_shape(b * n, k, cin, cout, chunk_rows),
                          dtype=torch.float32, device=table.device)
    with torch.cuda.device(table.device):
        err = fn(table.data_ptr(), idx.data_ptr(), found.data_ptr(), g_out.data_ptr(),
                 partial.data_ptr(), out.data_ptr(), b, v, n, k, cin, cout,
                 chunk_rows, taps, _DTYPE_CODES[table.dtype],
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"gather_gemm_dw kernel launch failed: CUDA error {err}")
    gather_gemm_dw.launches += 1
    return out


gather_gemm_dw.launches = 0


def dw_scratch_shape(rows: int, k: int, cin: int, cout: int, chunk_rows: int):
    """Shape of A2's f32 scratch: one (K*Cin, Cout) partial per chunk of rows."""
    return (-(-rows // chunk_rows), k * cin, cout)


def kernel_smem_bytes(kernel: str, *sizes) -> int:
    """What the built library itself says a launch asks for, in bytes of
    dynamic shared memory: ``("gather_gemm", K, Cin, Cout, dtype code,
    tile_rows)``, ``("gather_gemm_dw", Cin, Cout, chunk_rows, taps, dtype
    code)``, ``("gather_gemm_flat", K, Cout, dtype code, round_bf16,
    tile_rows)`` or ``("gather_gemm_per_tap", K, Cin, Cout, warps)``. Needs
    the built library (a card's machine)."""
    return load(kernel, [ctypes.c_int] * len(sizes), symbol=f"cpd_{kernel}_smem")(*sizes)


def _hits(idx, found, v):
    """Per tap the (rows, table rows) of the found taps with idx inside [0, v),
    in row order: the hit lists the kernels compact."""
    ok = found & (idx >= 0) & (idx < v)
    for kk in range(idx.shape[-1]):
        rows = torch.nonzero(ok[:, kk])[:, 0]
        yield kk, rows, idx[rows, kk].long()


def _pad16(x):
    """Rows of ``x`` padded with zero rows to a multiple of 16 (an MMA fragment)."""
    return torch.cat([x, x.new_zeros((-x.shape[0] % 16,) + x.shape[1:])])


def gather_gemm_tiled(table, idx, found, w_flat, out_dtype=torch.float32, tile_rows=None):
    """Kernel A1's order of arithmetic in plain PyTorch (for tests; loops in
    Python, small sizes only): per tile of ``tile_rows`` output rows an f32
    accumulator; per tap in tap order the rows that found it, in row order,
    padded to 16; per staged depth of input channels one product of the
    operands as they are (bf16 stays bf16) summed in f32 and added into the
    accumulator at the hit rows; rounded once to ``out_dtype``."""
    _check(table, idx, found, w_flat, out_dtype)
    b, v, cin = table.shape
    n, k = idx.shape[1:]
    cout = w_flat.shape[1]
    tm = tile_rows or a1_tile_rows(b, n, k, cin, cout, table.element_size())
    kc = a1_staged_depth(cin, table.element_size())
    w = w_flat.reshape(k, cin, cout)
    out = torch.zeros((b, n, cout), dtype=torch.float32)
    for bi in range(b):
        for n0 in range(0, n, tm):
            acc = out[bi, n0:n0 + tm]
            for kk, rows, src in _hits(idx[bi, n0:n0 + tm], found[bi, n0:n0 + tm], v):
                a = _pad16(table[bi, src])
                for c0 in range(0, cin, kc):
                    prod = a[:, c0:c0 + kc].float() @ w[kk, c0:c0 + kc].float()
                    acc[rows] += prod[:len(rows)]
    return out.to(out_dtype)


def gather_gemm_dw_tiled(table, idx, found, g_out, plan=None):
    """Kernel A2's order of arithmetic in plain PyTorch (for tests; small
    sizes only): per chunk of rows and per tap the hit list in row order, cut
    into steps of ``a2_hits_per_step`` hits padded to 16 with zero rows; per
    step X_hits^T @ dY_hits of the operands as they are, summed in f32 into
    the tap's tile; then the chunks' partial tiles added in chunk order."""
    b, v, cin = table.shape
    n, k = idx.shape[1:]
    cout = g_out.shape[-1]
    chunk_rows, _ = plan or a2_plan(b * n, k, cin, cout)
    step = a2_hits_per_step(cin, cout, table.element_size())
    flat_idx = (idx.long() + torch.arange(b)[:, None, None] * v).reshape(b * n, k)
    in_table = ((idx >= 0) & (idx < v) & found).reshape(b * n, k)
    x, g = table.reshape(b * v, cin), g_out.reshape(b * n, cout)
    partial = torch.zeros(dw_scratch_shape(b * n, k, cin, cout, chunk_rows))
    for ci, r0 in enumerate(range(0, b * n, chunk_rows)):
        sl = slice(r0, r0 + chunk_rows)
        for kk, rows, src in _hits(flat_idx[sl], in_table[sl], b * v):
            tile = partial[ci, kk * cin:(kk + 1) * cin]
            for h0 in range(0, len(rows), step):
                xs, gs = _pad16(x[src[h0:h0 + step]]), _pad16(g[r0 + rows[h0:h0 + step]])
                tile += xs.float().T @ gs.float()
    out = torch.zeros((k * cin, cout))
    for ci in range(partial.shape[0]):
        out += partial[ci]
    return out
