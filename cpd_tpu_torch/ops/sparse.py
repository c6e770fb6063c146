"""Sparse 3D convolution substrate: rulebooks + the gather-GEMM conv (port of
cpd_tpu/ops/sparse.py).

A sparse tensor is (features (V_cap, C), keys (V_cap,)) with int32
linearized zyx keys ((z * ny) + y) * nx + x, SORTED ascending, padding slots
set to INT32_MAX at the end. A row's index is its key's rank. On the card
the rulebook builders run kernels B1a, B1b and B2 (``ops/rulebook.py``: one
occupancy bitmap a stage, popcount-rank lookups, the strided output set by
receptive-field OR and rank compaction; no host sync). On the CPU they run
their plain versions, the oracle of those kernels: every neighbour lookup
one ``torch.searchsorted`` over the sorted keys, a strided output set one
sorted ``torch.unique``, one sample at a time (the JAX package's rank-joins
and gather-mode variants are TPU lowering workarounds).

A ``Rulebook`` holds, per output row and kernel tap, the input row to gather
(``idx``) and whether it exists (``found``); ``idx`` is 0 where ``found`` is
False. The conv's forward is kernel A1 (``ops/gather_gemm.py``). With a
transpose rulebook the conv is a ``torch.autograd.Function`` whose backward
runs kernel A1 once more for dX (over the transpose rulebook, against
``W^T`` per tap) and kernel A2 for dW: gathers and GEMMs only, no scatter.

``dense_mask_from_keys``, ``keys_from_dense_mask`` and ``rows_from_dense`` take
a sparse tensor to a dense occupancy grid and back for the backbone's dense
tail; all three accept leading batch axes.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .gather_gemm import gather_gemm, gather_gemm_dw

INVALID_KEY = 2**31 - 1  # padding sentinel for key arrays


class GridSpec(NamedTuple):
    """Static spatial grid (nx, ny, nz). Keys are ((z * ny) + y) * nx + x."""

    nx: int
    ny: int
    nz: int

    @property
    def num_cells(self) -> int:
        return self.nx * self.ny * self.nz

    def downsample(self, stride, padding, kernel) -> "GridSpec":
        """Conv output grid: floor((n + 2p - k) / s) + 1 per dim, (x, y, z) order."""
        return GridSpec(*((n + 2 * p - k) // s + 1 for n, s, p, k in
                          zip(self, stride, padding, kernel)))


class Rulebook(NamedTuple):
    """out[v] = sum_k found[v, k] * in[idx[v, k]] @ W[k]."""

    idx: torch.Tensor  # (..., V_out_cap, K) int32 rows of the input table
    found: torch.Tensor  # (..., V_out_cap, K) bool
    out_keys: torch.Tensor  # (..., V_out_cap) int32 sorted output keys
    out_valid: torch.Tensor  # (..., V_out_cap) bool


def keys_from_coords(coords_zyx, grid: GridSpec, valid=None):
    """(..., 3) int zyx -> (...,) int32 keys; out-of-bounds/invalid -> INVALID_KEY."""
    z, y, x = coords_zyx[..., 0], coords_zyx[..., 1], coords_zyx[..., 2]
    ok = _in_grid(z, y, x, grid)
    if valid is not None:
        ok = ok & valid
    key = (z.long() * grid.ny + y) * grid.nx + x
    return torch.where(ok, key, INVALID_KEY).to(torch.int32)


def coords_from_keys(keys, grid: GridSpec):
    """(V,) keys -> (V, 3) zyx (junk rows for INVALID_KEY slots)."""
    return torch.stack([keys // (grid.nx * grid.ny), (keys // grid.nx) % grid.ny,
                        keys % grid.nx], dim=-1)


def _in_grid(z, y, x, grid: GridSpec):
    """Per-dimension bounds check, so a neighbour never wraps across a grid row."""
    return ((x >= 0) & (x < grid.nx) & (y >= 0) & (y < grid.ny)
            & (z >= 0) & (z < grid.nz))


def lookup(sorted_keys, z, y, x, grid: GridSpec, ok):
    """Rows of the cells (z, y, x) (any equal shapes) in ``sorted_keys``.

    Returns (idx int32, found bool): ``found`` needs the cell in bounds, ``ok``
    and present; ``idx`` is 0 where not found."""
    ok = ok & _in_grid(z, y, x, grid)
    q = torch.where(ok, (z.long() * grid.ny + y) * grid.nx + x, -1)
    keys64 = sorted_keys.long()
    idx = torch.searchsorted(keys64, q.reshape(-1)).reshape(q.shape)
    idx = torch.clamp(idx, max=sorted_keys.shape[0] - 1)
    found = ok & (keys64[idx] == q)
    return torch.where(found, idx, 0).to(torch.int32), found


def _kernel_offsets(kernel: Tuple[int, int, int]):
    """(dz, dy, dx) tap offsets from the kernel origin; kernel is (kx, ky, kz)."""
    kx, ky, kz = kernel
    return [(dz, dy, dx) for dz in range(kz) for dy in range(ky) for dx in range(kx)]


def _subm_rulebook_plain(keys, grid: GridSpec, kernel=(3, 3, 3)) -> Rulebook:
    """One sample's submanifold rulebook, plain: output sites == input
    sites. keys: (V,) sorted."""
    kx, ky, kz = kernel
    valid = keys != INVALID_KEY
    coords = coords_from_keys(keys.long(), grid)
    offs = torch.tensor([(dz - kz // 2, dy - ky // 2, dx - kx // 2)
                         for dz, dy, dx in _kernel_offsets(kernel)], device=keys.device)
    nc = coords[:, None, :] + offs[None, :, :]  # (V, K, 3) zyx
    idx, found = lookup(keys, nc[..., 0], nc[..., 1], nc[..., 2], grid,
                        valid[:, None].expand(-1, offs.shape[0]))
    return Rulebook(idx, found, keys, valid)


def _strided_out_keys(keys, grid: GridSpec, out_grid: GridSpec, kernel, stride,
                      padding, out_cap: int):
    """SparseConv3d output set: every output site whose receptive field
    touches an input voxel, sorted ascending and truncated to ``out_cap`` by
    dropping the highest keys. Enumerates the ceil(k/s) candidate output
    coords per dim of each input voxel, then one sorted unique."""
    valid = keys != INVALID_KEY
    coords = coords_from_keys(keys.long(), grid)

    def dim_candidates(i, k, s, p, out_n):
        cands = []
        base = torch.div(i + p, s, rounding_mode="floor")
        for q in range(-(-k // s)):
            o = base - q
            koff = i + p - o * s
            cands.append((o, (koff >= 0) & (koff < k) & (o >= 0) & (o < out_n)))
        return cands

    z, y, x = coords[:, 0], coords[:, 1], coords[:, 2]
    cand = []
    for oz, okz in dim_candidates(z, kernel[2], stride[2], padding[2], out_grid.nz):
        for oy, oky in dim_candidates(y, kernel[1], stride[1], padding[1], out_grid.ny):
            for ox, okx in dim_candidates(x, kernel[0], stride[0], padding[0], out_grid.nx):
                key = (oz * out_grid.ny + oy) * out_grid.nx + ox
                cand.append(torch.where(okz & oky & okx & valid, key, INVALID_KEY))
    uniq = torch.unique(torch.cat(cand))  # sorted ascending; INVALID_KEY last
    out_keys = torch.full((out_cap,), INVALID_KEY, dtype=torch.int64, device=keys.device)
    n = min(out_cap, uniq.shape[0])
    out_keys[:n] = uniq[:n]
    return out_keys.to(torch.int32), out_keys != INVALID_KEY


def _conv_rulebook_plain(keys, grid: GridSpec, out_grid: GridSpec, kernel, stride, padding,
                         out_cap: int) -> Rulebook:
    """One sample's strided rulebook, plain."""
    out_keys, out_valid = _strided_out_keys(keys, grid, out_grid, kernel, stride,
                                            padding, out_cap)
    oc = coords_from_keys(out_keys.long(), out_grid)  # (Vo, 3) zyx
    origin = torch.stack([oc[:, 0] * stride[2] - padding[2],
                          oc[:, 1] * stride[1] - padding[1],
                          oc[:, 2] * stride[0] - padding[0]], dim=-1)
    offs = torch.tensor(_kernel_offsets(kernel), device=keys.device)
    ic = origin[:, None, :] + offs[None, :, :]  # (Vo, K, 3) input zyx
    idx, found = lookup(keys, ic[..., 0], ic[..., 1], ic[..., 2], grid,
                        out_valid[:, None].expand(-1, offs.shape[0]))
    return Rulebook(idx, found, out_keys, out_valid)


def _inverse_rulebook_plain(in_keys, out_keys, grid: GridSpec, out_grid: GridSpec,
                            kernel, stride, padding) -> Rulebook:
    """One sample's transpose of a strided rulebook, plain."""
    valid = in_keys != INVALID_KEY
    coords = coords_from_keys(in_keys.long(), grid)  # (V, 3) zyx
    dev = in_keys.device
    offs = torch.tensor(_kernel_offsets(kernel), device=dev)  # (K, 3) zyx taps
    pad = torch.tensor(padding[::-1], device=dev)
    s = torch.tensor(stride[::-1], device=dev)
    num = coords[:, None, :] + pad - offs[None, :, :]  # (V, K, 3)
    ok = torch.all(num % s == 0, dim=-1) & valid[:, None]
    oc = torch.div(num, s, rounding_mode="floor")
    idx, found = lookup(out_keys, oc[..., 0], oc[..., 1], oc[..., 2], out_grid, ok)
    return Rulebook(idx, found, in_keys, valid)


def _stack_books(books) -> Rulebook:
    return Rulebook(*(torch.stack(f) for f in zip(*books)))


def subm_rulebook_reference(keys, grid: GridSpec, kernel=(3, 3, 3)) -> Rulebook:
    """Plain version of ``build_subm_rulebook_batched`` on any device: one
    ``searchsorted`` lookup a sample."""
    return _stack_books([_subm_rulebook_plain(k, grid, kernel) for k in keys])


def conv_rulebook_reference(keys, grid: GridSpec, kernel, stride, padding, out_cap):
    """Plain version of ``build_conv_rulebook_batched`` on any device: a
    sorted ``unique`` and a ``searchsorted`` lookup a sample."""
    out_grid = grid.downsample(stride, padding, kernel)
    return _stack_books([_conv_rulebook_plain(k, grid, out_grid, kernel, stride, padding,
                                              out_cap) for k in keys]), out_grid


def inverse_rulebook_reference(in_keys, out_keys, grid: GridSpec, out_grid: GridSpec,
                               kernel, stride, padding) -> Rulebook:
    """Plain version of ``build_inverse_rulebook_batched`` on any device."""
    return _stack_books([_inverse_rulebook_plain(i, o, grid, out_grid, kernel, stride, padding)
                         for i, o in zip(in_keys, out_keys)])


def build_subm_rulebook_batched(keys, grid: GridSpec, kernel=(3, 3, 3)) -> Rulebook:
    """Submanifold rulebook (SubMConv3d semantics: output sites == input
    sites) of (B, V) sorted keys: kernels B1a and B1b for CUDA keys, the
    plain version for CPU keys (``ops/rulebook.py`` dispatches)."""
    return stage_tables.subm_rulebook_from_keys(keys, grid, kernel)


def build_conv_rulebook_batched(keys, grid: GridSpec, kernel, stride, padding, out_cap):
    """Strided (non-submanifold) rulebook, SparseConv3d semantics, of (B, V)
    sorted keys -> (Rulebook, out_grid); kernel/stride/padding are (x, y, z)
    tuples. Kernels B1a, B2 and B1b for CUDA keys, the plain version for CPU
    keys (``ops/rulebook.py`` dispatches)."""
    return stage_tables.conv_rulebook_from_keys(keys, grid, kernel, stride, padding, out_cap)


def build_inverse_rulebook_batched(in_keys, out_keys, grid: GridSpec, out_grid: GridSpec,
                                   kernel, stride, padding) -> Rulebook:
    """Transpose of a strided-conv rulebook, tap-aligned, over a leading
    batch axis: for input row u and tap k, ``idx[u, k]`` is the OUTPUT row v
    whose forward rulebook has ``idx[v, k] == u`` (output site (u + p -
    tap_k) / s where that divides), so dX[u] = sum_k found[u, k] *
    dY[idx[u, k]] @ W[k]^T is a gather-GEMM. in_keys (B, V_in), out_keys
    (B, V_out), both sorted; kernel/stride/padding are (x, y, z) tuples.
    Kernels B1a and B1b for CUDA keys, the plain version for CPU keys
    (``ops/rulebook.py`` dispatches)."""
    return stage_tables.inverse_rulebook_from_keys(in_keys, out_keys, grid, out_grid, kernel,
                                                   stride, padding)


def _first(book: Rulebook) -> Rulebook:
    return Rulebook(*(f[0] for f in book))


def build_subm_rulebook(keys, grid: GridSpec, kernel=(3, 3, 3)) -> Rulebook:
    """One sample's ``build_subm_rulebook_batched``: keys (V,) sorted."""
    return _first(build_subm_rulebook_batched(keys[None], grid, kernel))


def build_conv_rulebook(keys, grid: GridSpec, kernel, stride, padding,
                        out_cap: int) -> Tuple[Rulebook, GridSpec]:
    """One sample's ``build_conv_rulebook_batched``: keys (V,) sorted ->
    (Rulebook, out_grid)."""
    book, out_grid = build_conv_rulebook_batched(keys[None], grid, kernel, stride, padding,
                                                 out_cap)
    return _first(book), out_grid


def build_inverse_rulebook(in_keys, out_keys, grid: GridSpec, out_grid: GridSpec,
                           kernel, stride, padding) -> Rulebook:
    """One sample's ``build_inverse_rulebook_batched``: in_keys (V_in,),
    out_keys (V_out,)."""
    return _first(build_inverse_rulebook_batched(in_keys[None], out_keys[None], grid, out_grid,
                                                 kernel, stride, padding))


def mirror_rulebook(rulebook: Rulebook) -> Rulebook:
    """Transpose of a SUBMANIFOLD rulebook: the same table with the tap
    columns reversed, as a contiguous copy (kernel A1 reads its rulebook
    row-major). Tap reversal negates the centre-relative offsets only when
    every kernel dim is odd, i.e. when the kernel volume is odd. Build it
    once per stage: the four convs of a stage share it."""
    k = rulebook.idx.shape[-1]
    if k % 2 != 1:
        raise ValueError(f"mirror transpose requires an all-odd kernel (volume {k} is "
                         "even); build an explicit inverse rulebook instead")
    return Rulebook(rulebook.idx.flip(-1).contiguous(), rulebook.found.flip(-1).contiguous(),
                    rulebook.out_keys, rulebook.out_valid)


def to_dense(features, keys, grid: GridSpec):
    """Scatter (V, C) sparse rows into a dense (nz, ny, nx, C) grid."""
    c = features.shape[-1]
    valid = keys != INVALID_KEY
    target = torch.where(valid, keys.long(), grid.num_cells)  # last row: drop slot
    dense = torch.zeros((grid.num_cells + 1, c), dtype=features.dtype,
                        device=features.device)
    dense[target] = features
    return dense[:grid.num_cells].reshape(grid.nz, grid.ny, grid.nx, c)


def dense_mask_from_keys(keys, grid: GridSpec):
    """(..., V) sorted keys -> (..., nz, ny, nx) bool occupancy grid."""
    lead = keys.shape[:-1]
    valid = keys != INVALID_KEY
    target = torch.where(valid, keys.long(), grid.num_cells)  # last cell: drop slot
    mask = torch.zeros(lead + (grid.num_cells + 1,), dtype=torch.bool, device=keys.device)
    mask.scatter_(-1, target, valid)
    return mask[..., :grid.num_cells].reshape(lead + (grid.nz, grid.ny, grid.nx))


def keys_from_dense_mask(mask_flat, cap: int):
    """(..., num_cells) bool occupancy -> ((..., cap) sorted int32 keys with
    INVALID_KEY padding, (..., cap) bool valid).

    Rank compaction: the exclusive cumsum of the mask is each occupied cell's
    output slot, ascending in cell order, so the result is sorted without a
    sort, the capacity is fixed and nothing synchronises with the host.
    Occupancy beyond ``cap`` drops the highest keys (the tail the capped
    rulebook drops)."""
    lead, cells = mask_flat.shape[:-1], mask_flat.shape[-1]
    m = mask_flat.long()
    rank = torch.cumsum(m, -1) - m  # exclusive prefix count
    target = torch.where(mask_flat & (rank < cap), rank, cap)  # slot ``cap``: drop slot
    keys = torch.full(lead + (cap + 1,), INVALID_KEY, dtype=torch.int32, device=mask_flat.device)
    keys.scatter_(-1, target, torch.arange(cells, dtype=torch.int32,
                                           device=mask_flat.device).expand(lead + (cells,)))
    keys = keys[..., :cap].contiguous()
    return keys, keys != INVALID_KEY


def masked_batch_stats(features, valid):
    """Mean and (biased) variance over the valid rows of (..., V, C)
    features -> (mean (C,), var (C,))."""
    mask = valid[..., None].to(features.dtype)
    count = torch.clamp(mask.sum(), min=1.0)
    axes = tuple(range(features.dim() - 1))
    mean = (features * mask).sum(dim=axes) / count
    var = (mask * (features - mean) ** 2).sum(dim=axes) / count
    return mean, var


def rows_from_dense(dense_flat, keys):
    """Gather (..., V, C) sparse rows out of a (..., num_cells, C) dense grid;
    padding rows (INVALID_KEY) come back zero."""
    valid = keys != INVALID_KEY
    safe = torch.where(valid, keys.long(), 0)
    rows = torch.gather(dense_flat, -2, safe[..., None].expand(safe.shape + dense_flat.shape[-1:]))
    return rows * valid[..., None].to(rows.dtype)


class _SparseConv(torch.autograd.Function):
    """Sparse conv with a gather-only backward: forward kernel A1; backward
    kernel A1 over the transpose rulebook for dX and kernel A2 for dW."""

    @staticmethod
    def forward(ctx, features, weights, rulebook, transpose, compute_dtype, out_dtype):
        k, cin, cout = weights.shape
        cd = compute_dtype or features.dtype
        x = features.to(cd).contiguous()
        w = weights.to(cd)
        out = gather_gemm(x, rulebook.idx, rulebook.found,
                          w.reshape(k * cin, cout).contiguous(), out_dtype=out_dtype)
        ctx.save_for_backward(x, w, rulebook.idx, rulebook.found, rulebook.out_valid,
                              transpose.idx, transpose.found)
        ctx.dtypes = (features.dtype, weights.dtype)
        return torch.where(rulebook.out_valid[..., None], out, 0.0)

    @staticmethod
    def backward(ctx, g):
        x, w, idx, found, out_valid, t_idx, t_found = ctx.saved_tensors
        k, cin, cout = w.shape
        # dY masked by out_valid and rounded to the compute dtype, as X was
        g = torch.where(out_valid[..., None], g, 0.0).to(x.dtype).contiguous()
        dx = None
        if ctx.needs_input_grad[0]:
            w_t = w.transpose(1, 2).reshape(k * cout, cin).contiguous()
            dx = gather_gemm(g, t_idx, t_found, w_t, out_dtype=ctx.dtypes[0])
        dw = gather_gemm_dw(x, idx, found, g).reshape(k, cin, cout).to(ctx.dtypes[1])
        return dx, dw, None, None, None, None


def sparse_conv_apply_batched(features, rulebook: Rulebook, weights,
                              compute_dtype=None, transpose=None, out_dtype=torch.float32):
    """Batched sparse conv: features (B, V_in, Cin), rulebook with a leading
    batch axis, weights (K, Cin, Cout) -> (B, V_out, Cout).

    Operands are cast to ``compute_dtype``; the kernel accumulates in f32 and
    rounds once to ``out_dtype``. Rows outside ``out_valid`` come back zero.

    ``transpose`` selects the differentiable path (kernels A1 and A2 in the
    backward, no scatter): the transpose ``Rulebook``, from
    ``mirror_rulebook(rulebook)`` for a submanifold conv (one flipped copy
    serves all convs of a stage) or from ``build_inverse_rulebook_batched``
    for a strided conv. ``None`` is the forward-only path: it records no
    gradient."""
    if transpose is not None:
        if not isinstance(transpose, Rulebook):
            raise TypeError("transpose must be a Rulebook (mirror_rulebook(rulebook) for a "
                            f"submanifold conv), got {type(transpose).__name__}")
        if features.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"features must be float32 or bfloat16, got {features.dtype}")
        return _SparseConv.apply(features, weights, rulebook, transpose, compute_dtype,
                                 out_dtype)
    k, cin, cout = weights.shape
    if compute_dtype is not None:
        features = features.to(compute_dtype)
        weights = weights.to(compute_dtype)
    with torch.no_grad():
        out = gather_gemm(features.contiguous(), rulebook.idx, rulebook.found,
                          weights.reshape(k * cin, cout).contiguous(), out_dtype=out_dtype)
    return torch.where(rulebook.out_valid[..., None], out, 0.0)


def sparse_conv_apply(features, rulebook: Rulebook, weights, bias=None, compute_dtype=None):
    """One sample's sparse conv: features (V_in, Cin), a rulebook without a
    batch axis, weights (K, Cin, Cout) -> (V_out, Cout) f32, plus ``bias``,
    0 outside ``out_valid``: ``sparse_conv_apply_batched`` (kernel A1) at
    batch 1, forward only."""
    out = sparse_conv_apply_batched(features[None], Rulebook(*(f[None] for f in rulebook)),
                                    weights, compute_dtype=compute_dtype)[0]
    if bias is not None:
        out = out + bias
    return torch.where(rulebook.out_valid[:, None], out, 0.0)


# last: ops/rulebook.py imports this module's names above
from . import rulebook as stage_tables  # noqa: E402
