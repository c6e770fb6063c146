"""Kernels B1a, B1b and B2: the rulebook builders on one occupancy bitmap a
backbone stage (source ``csrc/rulebook.cu``).

They replace the JAX op chains that ``cpd_tpu/ops/sparse.py`` runs on the TPU
as XLA bitmap passes: ``build_bitmap_lut`` / ``build_padded_bitmap`` and
``_bitmap_rank``, the tap lookups ``lookup_bitmap_packed_taps``,
``lookup_packed_taps`` and ``lookup_bitmap_runs_dynamic``, and the strided
output set ``_bitmap_downsample`` + ``_keys_from_padded_bitmap``.

* B1a ``stage_table``: (B, V) sorted int32 keys (``INVALID_KEY`` padding) ->
  a ``StageTable``: the occupancy as (B, nz * ny * wr) 32-bit words in JAX's
  row-padded layout (``wr = ceil(nx / 32)`` words a (z, y) row, bit ``x & 31``
  of word ``(z * ny + y) * wr + (x >> 5)``; padding bits never set), and the
  INCLUSIVE per-sample prefix count of set bits up to each word. Rows are
  word-aligned, so the words run in key order and a set cell's row in the
  sorted keys is ``prefix[w] - popcount(word >> bit)``.
* B1b ``lookup_taps``: for each row key of a (B, V) key array and each tap of
  the kernel, the row of the tap's cell in a table: ``idx`` (B, V, K) int32,
  0 where not found, ``found`` (B, V, K) bool, and the rows' valid mask. Three
  modes: ``SUBM`` (the row's own cell plus the centred offset), ``STRIDED``
  (``o * s - p + tap`` on the input table), ``INVERSE`` (``(u + p - tap) /
  s`` where every dimension divides, on the output table). Bounds are checked
  per dimension, so no tap wraps across a grid row.
* B2 ``downsample``: a strided conv's output table from its input table. An
  output cell is set where any input cell of its receptive field ``[o * s -
  p, o * s - p + k - 1]`` is set; then rank compaction under ``cap`` gives the
  sorted output keys (``INVALID_KEY`` past ``min(total, cap)``), and the bits
  of rank >= cap are cleared from the output table, whose prefix is clamped
  to the cap: the next stage's table is the truncated set.

``subm_rulebook``, ``conv_rulebook`` and ``inverse_rulebook`` build
``Rulebook``\\ s from tables; ``models/backbone3d.py::build_branch_rulebooks``
threads one table a stage through them on CUDA keys. ``*_rulebook_from_keys``
build one book from keys, a table each (the builders of ``ops/sparse.py``
call them): the kernels for CUDA keys, the plain twins of ``ops/sparse.py``
for CPU keys. A wrapper launches its kernel for CUDA tensors
(``.launches`` counts its calls: B1a one kernel, B2 two, each with a
``torch.cumsum`` of the words' counts; no host sync, no host-to-device copy)
and raises on what the kernel does not take; for CPU tensors it computes
its plain version (``*_reference``), a restatement of the kernel's
formulation in PyTorch: row-padded words, prefix and popcount rank, the
receptive-field OR, rank compaction with truncation of the table.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from .cuda_build import load, on_cuda
from .sparse import (INVALID_KEY, GridSpec, Rulebook, conv_rulebook_reference, coords_from_keys,
                     inverse_rulebook_reference, keys_from_dense_mask, subm_rulebook_reference)

SUBM, STRIDED, INVERSE = 0, 1, 2
MAX_SAMPLES = 65535  # the launches' second grid axis
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    "cpd_rulebook_table": [_P] + [_I] * 5 + [_P] * 3,
    "cpd_rulebook_lookup": [_P] + [_I] * 5 + [_P] * 2 + [_I] * 13 + [_P] * 4,
    "cpd_rulebook_dilate": [_P] + [_I] * 16 + [_P] * 3,
    "cpd_rulebook_compact": [_P] * 2 + [_I] * 5 + [_P] * 3,
}


class StageTable(NamedTuple):
    """One stage's occupancy: ``words`` (B, nz * ny * wr) int32 holding the
    32-bit occupancy words, ``prefix`` (B, nz * ny * wr) int32 inclusive
    per-sample counts of set bits, on ``grid``."""

    words: torch.Tensor
    prefix: torch.Tensor
    grid: GridSpec


def row_words(grid: GridSpec) -> int:
    """Words a (z, y) row of the grid owns."""
    return -(-grid.nx // 32)


def table_words(grid: GridSpec) -> int:
    """Words a sample's table holds."""
    return grid.nz * grid.ny * row_words(grid)


def popcount(x):
    """Set bits of each 32-bit word of an integer tensor (int32 or the
    low 32 bits of a wider one) -> int32."""
    x = x.long() & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (((x * 0x01010101) & 0xFFFFFFFF) >> 24).to(torch.int32)


def _unsigned(words):
    return words.long() & 0xFFFFFFFF


def _as_int32(words64):
    """Words held in int64 (0 .. 2^32 - 1) -> the same bits as int32."""
    return torch.where(words64 >= 2**31, words64 - 2**32, words64).to(torch.int32)


def _table_from_words(words, grid):
    return StageTable(words, torch.cumsum(popcount(words), -1, dtype=torch.int32), grid)


def _check_grid(grid: GridSpec):
    if min(grid) < 1 or grid.num_cells >= INVALID_KEY:
        raise ValueError(f"want a grid of 1 .. 2^31 - 2 cells, got {tuple(grid)}")


def _check_keys(name, keys):
    if keys.dim() != 2 or keys.dtype != torch.int32:
        raise TypeError(f"{name} must be (B, V) int32, got {keys.dtype} {tuple(keys.shape)}")
    if keys.shape[0] > MAX_SAMPLES:
        raise ValueError(f"the rulebook kernels take at most {MAX_SAMPLES} samples, got "
                         f"{keys.shape[0]}")


def _check_table(table: StageTable):
    _check_grid(table.grid)
    want = (table.words.shape[0], table_words(table.grid))
    for name, t in (("words", table.words), ("prefix", table.prefix)):
        if t.dtype != torch.int32 or tuple(t.shape) != want:
            raise ValueError(f"table {name} must be {want} int32 for grid {tuple(table.grid)}, "
                             f"got {t.dtype} {tuple(t.shape)}")


def _check_geometry(kernel, stride, padding):
    if min(kernel) < 1 or min(stride) < 1 or min(padding) < 0:
        raise ValueError(f"want kernel and stride >= 1 and padding >= 0, got {kernel}, "
                         f"{stride}, {padding}")


def _sample_prefix(counts):
    """(B, n) int32 counts -> their inclusive cumsum along each sample: one
    1-D scan over the flattened batch (PyTorch's device-wide scan, for rows
    of millions of words) less each earlier sample's total."""
    prefix = torch.cumsum(counts.view(-1), 0, dtype=torch.int32).view(counts.shape)
    if counts.shape[0] > 1:
        ends = prefix[:, -1:].clone()
        prefix[1:] -= ends[:-1]
    return prefix


def _launch(symbol, *args):
    """One C entry point of ``csrc/rulebook.cu`` on the current stream:
    tensors go as pointers, the rest as ints."""
    fn = load("rulebook", _ARGTYPES[symbol], symbol)
    device = next(a.device for a in args if isinstance(a, torch.Tensor))
    with torch.cuda.device(device):
        err = fn(*(a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args),
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{symbol} failed: CUDA error {err}")


# B1a: the stage table


def stage_table_reference(keys, grid: GridSpec) -> StageTable:
    """Plain version of B1a: each valid key's bit summed into its word
    (keys are unique, so the sum is the OR), then the cumsum of the words'
    popcounts."""
    b, n = keys.shape[0], table_words(grid)
    valid = keys != INVALID_KEY
    k = torch.where(valid, keys, 0).long()
    x = k % grid.nx
    w = torch.where(valid, (k // grid.nx) * row_words(grid) + (x >> 5), n)  # n: drop slot
    bits = torch.where(valid, torch.ones_like(k) << (x & 31), 0)
    words = torch.zeros((b, n + 1), dtype=torch.int64, device=keys.device).scatter_add_(1, w, bits)
    return _table_from_words(_as_int32(words[:, :n]), grid)


def stage_table(keys, grid: GridSpec) -> StageTable:
    """B1a: (B, V) sorted unique int32 keys on ``grid`` -> their
    ``StageTable``. CUDA tensors run the kernel (``stage_table.launches``
    counts), CPU tensors the plain version."""
    _check_keys("keys", keys)
    _check_grid(grid)
    if not on_cuda((("keys", keys),)):
        return stage_table_reference(keys, grid)
    b, v = keys.shape
    words = torch.empty((b, table_words(grid)), dtype=torch.int32, device=keys.device)
    counts = torch.empty_like(words)
    _launch("cpd_rulebook_table", keys, b, v, *grid, words, counts)
    stage_table.launches += 1
    return StageTable(words, _sample_prefix(counts), grid)


stage_table.launches = 0


# B1b: the tap lookups


def _tap_offsets(kernel, device):
    """(dz, dy, dx) of each tap from the kernel origin, (K,) each, taps dz
    outer, dy, dx inner (``sparse._kernel_offsets``' order)."""
    kx, ky, kz = kernel
    t = torch.arange(kx * ky * kz, device=device)
    return t // (kx * ky), (t // kx) % ky, t % kx


def tap_words(row_keys, row_grid: GridSpec, table_grid: GridSpec, mode: int, kernel,
              stride=(1, 1, 1), padding=(0, 0, 0)):
    """Where each (row, tap) of B1b looks: (word (B, V, K) int64, 0 where
    not ok; bit (B, V, K); ok (B, V, K) bool: the row is valid and the tap's
    cell lies in ``table_grid`` (and, inverse, divides); valid (B, V))."""
    valid = row_keys != INVALID_KEY
    c = coords_from_keys(torch.where(valid, row_keys, 0).long(), row_grid)[..., None, :]
    taps = _tap_offsets(kernel, row_keys.device)
    ok = valid[..., None]
    cell = []
    for d, (t, s, p, k) in enumerate(zip(taps, stride[::-1], padding[::-1], kernel[::-1])):
        u = c[..., d]
        if mode == SUBM:
            cell.append(u + t - k // 2)
        elif mode == STRIDED:
            cell.append(u * s - p + t)
        else:
            num = u + p - t
            ok = ok & (num >= 0) & (num % s == 0)
            cell.append(num // s)
    cz, cy, cx = cell
    g = table_grid
    ok = ok & (cx >= 0) & (cx < g.nx) & (cy >= 0) & (cy < g.ny) & (cz >= 0) & (cz < g.nz)
    return torch.where(ok, (cz * g.ny + cy) * row_words(g) + (cx >> 5), 0), cx & 31, ok, valid


def lookup_taps_reference(row_keys, row_grid: GridSpec, table: StageTable, mode: int,
                          kernel, stride=(1, 1, 1), padding=(0, 0, 0)):
    """Plain version of B1b -> (idx (B, V, K) int32, found (B, V, K) bool,
    valid (B, V) bool)."""
    w, bit, ok, valid = tap_words(row_keys, row_grid, table.grid, mode, kernel, stride, padding)
    b = w.shape[0]
    word = _unsigned(torch.gather(table.words, 1, w.reshape(b, -1)).reshape(w.shape)) >> bit
    prefix = torch.gather(table.prefix, 1, w.reshape(b, -1)).reshape(w.shape)
    found = ok & ((word & 1) == 1)
    return torch.where(found, prefix - popcount(word), 0).to(torch.int32), found, valid


def lookup_taps(row_keys, row_grid: GridSpec, table: StageTable, mode: int, kernel,
                stride=(1, 1, 1), padding=(0, 0, 0)):
    """B1b: each (row, tap)'s row in ``table`` (see the module docstring) ->
    (idx (B, V, K) int32, found (B, V, K) bool, valid (B, V) bool).
    ``row_keys`` (B, V) sorted on ``row_grid``; kernel, stride and padding
    (x, y, z). CUDA tensors run the kernel (``lookup_taps.launches``
    counts), CPU tensors the plain version."""
    _check_keys("row_keys", row_keys)
    _check_grid(row_grid)
    _check_table(table)
    _check_geometry(kernel, stride, padding)
    if mode not in (SUBM, STRIDED, INVERSE):
        raise ValueError(f"unknown lookup mode {mode}")
    if mode == SUBM and tuple(row_grid) != tuple(table.grid):
        raise ValueError("a submanifold lookup reads the rows' own grid")
    if row_keys.shape[0] != table.words.shape[0]:
        raise ValueError(f"{row_keys.shape[0]} samples of keys against "
                         f"{table.words.shape[0]} of the table")
    operands = (("row_keys", row_keys), ("words", table.words), ("prefix", table.prefix))
    if not on_cuda(operands):
        return lookup_taps_reference(row_keys, row_grid, table, mode, kernel, stride, padding)
    b, v = row_keys.shape
    k = math.prod(kernel)
    if v * k >= 2**31:
        raise ValueError(f"kernel B1b takes fewer than 2^31 (row, tap) pairs a sample, got {v * k}")
    idx = torch.empty((b, v, k), dtype=torch.int32, device=row_keys.device)
    found = torch.empty((b, v, k), dtype=torch.bool, device=row_keys.device)
    valid = torch.empty((b, v), dtype=torch.bool, device=row_keys.device)
    _launch("cpd_rulebook_lookup", row_keys, b, v, *row_grid, table.words, table.prefix,
            *table.grid, *kernel, *stride, *padding, mode, idx, found, valid)
    lookup_taps.launches += 1
    return idx, found, valid


lookup_taps.launches = 0


# B2: the strided output set


def _receptive_or(occ, out_grid: GridSpec, kernel, stride, padding):
    """(B, nz, ny, nx) bool -> (B, onz, ony, onx) bool: an output cell is set
    where any input cell of its receptive field is."""
    pads = []
    for n, on, k, s, p in zip(occ.shape[:0:-1], out_grid, kernel, stride, padding):
        pads += [p, max(0, (on - 1) * s + k - p - n)]
    src = F.pad(occ.to(torch.uint8), pads)
    (kx, ky, kz), (sx, sy, sz) = kernel, stride
    out = torch.zeros((occ.shape[0], out_grid.nz, out_grid.ny, out_grid.nx), dtype=torch.uint8,
                      device=occ.device)
    for dz in range(kz):
        for dy in range(ky):
            for dx in range(kx):
                out |= src[:, dz:dz + (out_grid.nz - 1) * sz + 1:sz,
                           dy:dy + (out_grid.ny - 1) * sy + 1:sy,
                           dx:dx + (out_grid.nx - 1) * sx + 1:sx]
    return out.bool()


def _occupancy(table: StageTable):
    """A table's words -> (B, nz, ny, nx) bool."""
    g, b = table.grid, table.words.shape[0]
    bits = (_unsigned(table.words)[..., None] >> torch.arange(32, device=table.words.device)) & 1
    return bits.reshape(b, g.nz, g.ny, -1)[..., :g.nx].bool()


def _pack_words(occ, grid: GridSpec):
    """(B, nz, ny, nx) bool -> (B, nz * ny * wr) int32 row-padded words."""
    wr = row_words(grid)
    bits = F.pad(occ.long(), (0, wr * 32 - grid.nx)).reshape(*occ.shape[:3], wr, 32)
    words = (bits << torch.arange(32, device=occ.device)).sum(-1)
    return _as_int32(words.reshape(occ.shape[0], -1))


def downsample_reference(table: StageTable, kernel, stride, padding, cap: int):
    """Plain version of B2 -> (output StageTable truncated to ``cap``, out_keys
    (B, cap) int32, out_valid (B, cap) bool)."""
    out_grid = table.grid.downsample(stride, padding, kernel)
    occ = _receptive_or(_occupancy(table), out_grid, kernel, stride, padding)
    flat = occ.reshape(occ.shape[0], -1)
    m = flat.long()
    kept = flat & (torch.cumsum(m, -1) - m < cap)
    out_keys, out_valid = keys_from_dense_mask(kept, cap)
    return (_table_from_words(_pack_words(kept.reshape(occ.shape), out_grid), out_grid),
            out_keys, out_valid)


def downsample(table: StageTable, kernel, stride, padding, cap: int):
    """B2: a strided conv's output set from its input ``table`` (kernel,
    stride, padding (x, y, z)) -> (the output ``StageTable`` truncated to
    ``cap``, out_keys (B, cap) int32 sorted, out_valid (B, cap) bool). CUDA
    tensors run the kernels (``downsample.launches`` counts the calls), CPU
    tensors the plain version."""
    _check_table(table)
    _check_geometry(kernel, stride, padding)
    if kernel[0] > 32:  # an x range spans at most two words (csrc)
        raise ValueError(f"kernel B2 takes kx <= 32, got kx={kernel[0]}")
    out_grid = table.grid.downsample(stride, padding, kernel)
    _check_grid(out_grid)
    if cap < 0:
        raise ValueError(f"cap must be >= 0, got {cap}")
    if not on_cuda((("words", table.words), ("prefix", table.prefix))):
        return downsample_reference(table, kernel, stride, padding, cap)
    b, dev = table.words.shape[0], table.words.device
    words = torch.empty((b, table_words(out_grid)), dtype=torch.int32, device=dev)
    counts = torch.empty_like(words)
    _launch("cpd_rulebook_dilate", table.words, b, *table.grid, *out_grid, *kernel, *stride,
            *padding, words, counts)
    prefix = _sample_prefix(counts)
    out_keys = torch.empty((b, cap), dtype=torch.int32, device=dev)
    out_valid = torch.empty((b, cap), dtype=torch.bool, device=dev)
    _launch("cpd_rulebook_compact", words, prefix, b, *out_grid, cap, out_keys, out_valid)
    downsample.launches += 1
    return StageTable(words, prefix, out_grid), out_keys, out_valid


downsample.launches = 0


# rulebooks from tables


def subm_rulebook(keys, table: StageTable, kernel=(3, 3, 3)) -> Rulebook:
    """Submanifold rulebook of (B, V) ``keys``, whose table is ``table``."""
    idx, found, valid = lookup_taps(keys, table.grid, table, SUBM, kernel)
    return Rulebook(idx, found, keys, valid)


def conv_rulebook(table: StageTable, kernel, stride, padding, out_cap: int):
    """Strided rulebook (SparseConv3d semantics) from the input ``table`` ->
    (Rulebook, the output StageTable, truncated to ``out_cap``)."""
    out_table, out_keys, out_valid = downsample(table, kernel, stride, padding, out_cap)
    idx, found, _ = lookup_taps(out_keys, out_table.grid, table, STRIDED, kernel, stride, padding)
    return Rulebook(idx, found, out_keys, out_valid), out_table


def inverse_rulebook(in_keys, in_grid: GridSpec, out_table: StageTable, kernel, stride,
                     padding) -> Rulebook:
    """Transpose of a strided rulebook (``sparse.build_inverse_rulebook``'s
    layout) for the (B, V) ``in_keys`` on ``in_grid``, looked up in the
    conv's output table."""
    idx, found, valid = lookup_taps(in_keys, in_grid, out_table, INVERSE, kernel, stride, padding)
    return Rulebook(idx, found, in_keys, valid)


# rulebooks from keys: the dispatch of ``ops/sparse.py``'s builders


def subm_rulebook_from_keys(keys, grid: GridSpec, kernel=(3, 3, 3)) -> Rulebook:
    """Submanifold rulebook of (B, V) sorted keys: B1a and B1b for CUDA
    keys, the plain twin ``sparse.subm_rulebook_reference`` for CPU keys."""
    if not on_cuda((("keys", keys),), contiguous=False):
        return subm_rulebook_reference(keys, grid, kernel)
    keys = keys.contiguous()
    return subm_rulebook(keys, stage_table(keys, grid), kernel)


def conv_rulebook_from_keys(keys, grid: GridSpec, kernel, stride, padding, out_cap: int):
    """Strided rulebook of (B, V) sorted keys -> (Rulebook, out_grid): B1a,
    B2 and B1b for CUDA keys, the plain twin for CPU keys."""
    if not on_cuda((("keys", keys),), contiguous=False):
        return conv_rulebook_reference(keys, grid, kernel, stride, padding, out_cap)
    book, out_table = conv_rulebook(stage_table(keys.contiguous(), grid), kernel, stride, padding,
                                    out_cap)
    return book, out_table.grid


def inverse_rulebook_from_keys(in_keys, out_keys, grid: GridSpec, out_grid: GridSpec, kernel,
                               stride, padding) -> Rulebook:
    """Transpose of a strided rulebook from both key arrays: B1a (the output
    keys' table) and B1b for CUDA keys, the plain twin for CPU keys."""
    if not on_cuda((("in_keys", in_keys), ("out_keys", out_keys)), contiguous=False):
        return inverse_rulebook_reference(in_keys, out_keys, grid, out_grid, kernel, stride,
                                          padding)
    out_table = stage_table(out_keys.contiguous(), out_grid)
    return inverse_rulebook(in_keys.contiguous(), grid, out_table, kernel, stride, padding)
