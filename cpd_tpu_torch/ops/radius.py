"""Kernel R1: radius neighbour count over windows of support points, the
inner loop of the pseudo-label factory's PPScore.

``radius_count(query, support, window, n_windows, radius)`` counts for each
query the support points of each window whose f32 squared distance
``(dx*dx + dy*dy) + dz*dz`` is at most ``float32(radius**2)``. It stands in
for the JAX op chain ``cpd_tpu/unsupervised/ppscore.py::ppscore_jax`` and the
JAX factory's host library (``cpd_tpu/native/src/pointcloud.cpp::
radius_neighbor_count``); no Pallas kernel computes it. Source
``csrc/radius_count.cu``, built and bound by ``ops/cuda_build.py``.

The grid that the kernel walks is built here in PyTorch: integer cell
coordinates ``floor(x / cell)`` from one origin (``grid_cells``, shared with
kernel R2), the support sorted by (window, cell) with ``torch.sort`` and the
column table over (window, gx, gy) from the sorted keys (``column_table``),
the queries sorted by cell and cut into groups of at most 32 of one cell
(``cell_groups``). The cell is the radius times ``CELL_MARGIN``: a cell
exactly as wide as the radius would let rounding put a neighbour two cells
away; with the margin the 27 cells around a query's own always hold every
support point within the radius. A first launch finds each (group, window)
item's 9 column runs (``cell_runs``); the items are cut into pieces of at most
``PIECE`` candidates (``walk_pieces``), one warp each in the count launch.

A CUDA tensor launches the kernel (``radius_count.launches`` counts the
launches); a CPU tensor computes the plain version, ``radius_count_reference``:
the brute force of ``ppscore_jax`` in chunks, the same f32 arithmetic, so the
counts are equal bit for bit.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from .cuda_build import load, on_cuda

CELL_MARGIN = 1.0 + 2.0 ** -10
# pairs a chunk of the plain versions (R1, R2) holds: cache-sized on the CPU,
# 0.5 GB a f32 temporary on the card
PAIRS_PER_CHUNK = {"cpu": 2 ** 20, "cuda": 2 ** 27}
# queries a group (a warp's lanes) and candidates a piece (one warp's walk),
# csrc/cell_walk.cuh's kWarp and kPiece
GROUP = 32
PIECE = 1024
# entries of a column table (4 bytes each): a grid whose columns (windows or
# segments times x times y cells) exceed it is refused
MAX_COLUMNS = 2 ** 28
_RUNS_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                                          ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int] + [
    ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p,
                            ctypes.c_void_p]


def grid_cells(coords, cell: float):
    """Integer cell coordinates of the (K_i, 3) float tensors ``coords``,
    ``floor(x / cell)`` computed in f64, shifted to one origin that leaves an
    empty cell on every side: (list of (K_i, 3) int64 tensors, (NX, NY, NZ))."""
    cells = [torch.floor(c.double() / cell).long() for c in coords]
    live = [c for c in cells if len(c)]
    lo = torch.stack([c.min(0).values for c in live]).min(0).values - 1
    cells = [c - lo for c in cells]
    dims = (torch.stack([c.max(0).values for c in cells if len(c)]).max(0).values + 2).tolist()
    return cells, tuple(int(d) for d in dims)


def cell_keys(cells, dims, group=None):
    """The sort key ``((group * NX + gx) * NY + gy) * NZ + gz`` (int64)."""
    nx, ny, nz = dims
    g = cells[:, 0] if group is None else group.long() * nx + cells[:, 0]
    return (g * ny + cells[:, 1]) * nz + cells[:, 2]


def _check(query, support, window, n_windows):
    if query.dim() != 2 or query.shape[1] != 3 or support.dim() != 2 or support.shape[1] != 3:
        raise ValueError(f"want query (N, 3) and support (M, 3), got {tuple(query.shape)}, "
                         f"{tuple(support.shape)}")
    if window.shape != (support.shape[0],):
        raise ValueError(f"window must be (M,), got {tuple(window.shape)}")
    if query.dtype != torch.float32 or support.dtype != torch.float32 or window.dtype != torch.int32:
        raise TypeError(f"want f32 query and support and int32 window, got {query.dtype}, "
                        f"{support.dtype}, {window.dtype}")
    if n_windows < 1:
        raise ValueError(f"n_windows must be at least 1, got {n_windows}")
    if max(query.shape[0], support.shape[0]) >= 2 ** 31:
        raise ValueError("too many points for the kernel's 32-bit query index")


def _r2(radius: float) -> float:
    return float(np.float32(radius * radius))


def radius_count_reference(query, support, window, n_windows: int, radius: float):
    """Plain PyTorch version of kernel R1: for each window the brute force
    over every (query, support) pair in chunks, (dx*dx + dy*dy) + dz*dz in
    f32 against float32(radius**2). -> (N, n_windows) int32."""
    n = query.shape[0]
    out = torch.zeros((n, n_windows), dtype=torch.int32, device=query.device)
    r2 = torch.tensor(_r2(radius), dtype=torch.float32, device=query.device)
    for w in range(n_windows):
        s = support[window == w]
        if not len(s):
            continue
        rows = max(1, PAIRS_PER_CHUNK[query.device.type] // len(s))
        for q0 in range(0, n, rows):
            q = query[q0:q0 + rows]
            d2 = torch.sub(q[:, None, 0], s[None, :, 0]).square_()
            d2 += torch.sub(q[:, None, 1], s[None, :, 1]).square_()
            d2 += torch.sub(q[:, None, 2], s[None, :, 2]).square_()
            out[q0:q0 + rows, w] = (d2 <= r2).sum(1, dtype=torch.int32)
    return out


def column_table(cols, n_cols: int):
    """Run offsets of the sorted (M,) int64 column numbers ``cols``: (n_cols +
    1,) int32 ``start``, the points of column c at sorted positions start[c]
    .. start[c + 1]. Each position whose column differs from its
    predecessor's writes its run's length at its column; an exclusive scan
    of the lengths gives the starts. On the cols' device, no host loop."""
    m = len(cols)
    dev = cols.device
    first = torch.ones(m, dtype=torch.bool, device=dev)
    first[1:] = cols[1:] != cols[:-1]
    at = torch.nonzero(first).squeeze(1)
    length = torch.diff(at, append=torch.tensor([m], device=dev))
    per = torch.zeros(n_cols, dtype=torch.int64, device=dev)
    per[cols[at]] = length
    start = torch.zeros(n_cols + 1, dtype=torch.int64, device=dev)
    start[1:] = torch.cumsum(per, 0)
    return start.int()


def cell_groups(keys, nz: int):
    """The sorted (N,) int64 cell keys ``keys`` (column * nz + gz) cut into
    groups of at most ``GROUP`` points of one cell: (gstart (G + 1,) int32,
    the first position of each group and N; gcol (G,) int32, each group's
    column; gz (G,) int32, its z cell). Each run's first position is written
    at the run's number, so one read of G from the device is the only wait."""
    n = len(keys)
    dev = keys.device
    pos = torch.arange(n, device=dev)
    first = torch.ones(n, dtype=torch.bool, device=dev)
    first[1:] = keys[1:] != keys[:-1]
    run = torch.cumsum(first, 0) - 1
    starts = torch.empty(n + 1, dtype=torch.int64, device=dev)
    starts[torch.where(first, run, n)] = pos  # slot n takes the rest, unread
    gfirst = torch.nonzero((pos - starts[run]) % GROUP == 0).squeeze(1)
    gkeys = keys[gfirst]
    gstart = torch.cat([gfirst, torch.tensor([n], device=dev)]).int()
    return gstart, (gkeys // nz).int(), (gkeys % nz).int()


def walk_pieces(runs, n_items: int):
    """Items cut into pieces of at most ``PIECE`` candidates, from the (9 *
    n_items, 2) int32 ``runs``: (piece_item (P,) int32, each piece's item;
    piece_k (P,) int32, its index among the item's pieces). Reads P from the
    card (one synchronisation)."""
    total = runs[:, 1].reshape(n_items, 9).sum(1)
    per = (total + PIECE - 1) // PIECE
    n_pieces = int(per.sum())
    item = torch.repeat_interleave(torch.arange(n_items, device=runs.device), per,
                                   output_size=n_pieces)
    k = torch.arange(n_pieces, device=runs.device) - (torch.cumsum(per, 0) - per)[item]
    return item.int(), k.int()


class CellPlan(NamedTuple):
    """What the walk of kernels R1 and R2 reads besides the points: the
    candidates' sorted ``keys`` (column * NZ + gz) and column table
    ``start``, the query groups (``gstart``, ``gcol``, ``gz`` and ``gny``, the
    columns of an x row of the group's grid), ``plane`` columns a window,
    ``W`` windows and ``NZ``."""
    keys: torch.Tensor
    start: torch.Tensor
    gstart: torch.Tensor
    gcol: torch.Tensor
    gz: torch.Tensor
    gny: torch.Tensor
    plane: int
    W: int
    NZ: int

    @property
    def n_items(self) -> int:
        return (len(self.gstart) - 1) * self.W

    def pointers(self):
        return (self.keys.data_ptr(), self.start.data_ptr(), self.gstart.data_ptr(),
                self.gcol.data_ptr(), self.gz.data_ptr(), self.gny.data_ptr())


def check_grid(n_cols: int, nz: int):
    """Raises where a grid of ``n_cols`` columns of ``nz`` cells exceeds the
    column table (``MAX_COLUMNS``) or the 32-bit z cells and 64-bit keys."""
    if n_cols > MAX_COLUMNS or nz >= 2 ** 31 or n_cols * nz >= 2 ** 62:
        raise ValueError(f"{n_cols} columns of {nz} cells: more than the column table's "
                         f"{MAX_COLUMNS} columns, 32-bit z cells or 64-bit cell keys")


def cell_runs(plan: CellPlan, lib: str):
    """The runs launch of kernel library ``lib`` (``cpd_<lib>_runs``, the
    runs kernel of ``csrc/cell_walk.cuh``): (9 * items, 2) int32 runs (first
    sorted position, count) of each item's 9 columns."""
    fn = load(lib, _RUNS_ARGTYPES, f"cpd_{lib}_runs")
    runs = torch.empty((9 * plan.n_items, 2), dtype=torch.int32, device=plan.keys.device)
    with torch.cuda.device(plan.keys.device):
        err = fn(*plan.pointers(), len(plan.gstart) - 1, plan.plane, plan.W, plan.NZ,
                 runs.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"cell runs kernel launch failed: CUDA error {err}")
    return runs


def cell_runs_reference(plan: CellPlan):
    """Plain version of ``cell_runs``: each item's 9 runs by
    ``torch.searchsorted`` over all keys, held inside the column's table
    entries as the kernel searches inside the column."""
    dev = plan.keys.device
    item = torch.arange(plan.n_items, device=dev)
    g, w = item // plan.W, item % plan.W
    j = torch.arange(9, device=dev)
    col = ((w * plan.plane + plan.gcol[g].long())[:, None]
           + (j // 3 - 1)[None, :] * plan.gny[g].long()[:, None] + (j % 3 - 1)[None, :])
    start = plan.start.long()
    cs, ce = start[col], start[col + 1]
    key = col * plan.NZ + plan.gz[g].long()[:, None] - 1
    lo = torch.minimum(torch.maximum(torch.searchsorted(plan.keys, key), cs), ce)
    hi = torch.minimum(torch.searchsorted(plan.keys, key + 3), ce)
    return torch.stack([lo, hi - lo], -1).reshape(-1, 2).int()


def walk_pairs(plan: CellPlan, runs):
    """The (query, candidate) pairs that the walk of kernels R1 and R2 tests,
    restated in PyTorch from the same pieces: (query sorted position, window,
    candidate sorted position), three int64 tensors, piece by piece, every
    query of the item's group against the piece's candidates, a lane's
    candidate found from the runs' prefix sums as the kernel finds it."""
    dev = runs.device
    n_items = plan.n_items
    piece_item, piece_k = walk_pieces(runs, n_items)
    counts = runs[:, 1].reshape(n_items, 9).long()
    first = runs[:, 0].reshape(n_items, 9).long()
    pre = torch.cat([torch.zeros((n_items, 1), dtype=torch.int64, device=dev),
                     torch.cumsum(counts, 1)], 1)
    item = piece_item.long()
    k0 = piece_k.long() * PIECE
    nk = torch.minimum(pre[item, 9], k0 + PIECE) - k0

    def spread(values, sizes):  # each value repeated, with its index among the repeats
        rep = torch.repeat_interleave(values, sizes)
        within = torch.arange(len(rep), device=dev) - torch.repeat_interleave(
            torch.cumsum(sizes, 0) - sizes, sizes)
        return rep, within

    pit, k = spread(item, nk)
    k = k + torch.repeat_interleave(k0, nk)
    r = (k[:, None] >= pre[pit, 1:]).sum(1)
    cand = first[pit, r] + k - pre[pit, r]
    g = pit // plan.W
    gstart = plan.gstart.long()
    nq = gstart[g + 1] - gstart[g]
    pair_of, q = spread(torch.arange(len(pit), device=dev), nq)
    return gstart[g][pair_of] + q, (pit % plan.W)[pair_of], cand[pair_of]


def padded(points):
    """(N, 3) points as (N, 4), the fourth column 0: one aligned load a point."""
    return torch.nn.functional.pad(points, (0, 1)).contiguous()


class RadiusOperands(NamedTuple):
    """Kernel R1's operands on the card: queries sorted by cell (``q``, (N,
    4), and the order ``qorder``), the support sorted by (window, cell)
    (``pts``, (M, 4)) under ``plan``, the grid's ``dims`` and the f32
    ``r2``."""
    q: torch.Tensor
    qorder: torch.Tensor
    pts: torch.Tensor
    plan: CellPlan
    n_windows: int
    dims: tuple
    r2: float


def radius_operands(query, support, window, n_windows: int, radius: float) -> RadiusOperands:
    """The cell grid of kernel R1, built in PyTorch (``torch.sort``)."""
    (qcell, scell), dims = grid_cells((query, support), radius * CELL_MARGIN)
    nx, ny, nz = dims
    check_grid(nx * ny * n_windows, nz)
    keys, order = torch.sort(cell_keys(scell, dims, window))
    qkeys, qorder = torch.sort(cell_keys(qcell, dims))
    gstart, gcol, gz = cell_groups(qkeys, nz)
    plan = CellPlan(keys, column_table(keys // nz, nx * ny * n_windows), gstart, gcol, gz,
                    torch.full_like(gcol, ny), nx * ny, n_windows, nz)
    return RadiusOperands(padded(query[qorder]), qorder, padded(support[order]), plan,
                          n_windows, dims, _r2(radius))


def radius_launch(ops: RadiusOperands):
    """Kernel R1's two launches, the runs and the count (counted once in
    ``radius_count.launches``) -> (N, n_windows) int32 counts in the order
    of ``ops.q``."""
    plan = ops.plan
    runs = cell_runs(plan, "radius_count")
    piece_item, piece_k = walk_pieces(runs, plan.n_items)
    fn = load("radius_count", _ARGTYPES)
    counts = torch.zeros((ops.q.shape[0], ops.n_windows), dtype=torch.int32,
                         device=ops.q.device)
    with torch.cuda.device(ops.q.device):
        err = fn(ops.q.data_ptr(), *plan.pointers(), plan.plane, plan.W, plan.NZ,
                 runs.data_ptr(), piece_item.data_ptr(), piece_k.data_ptr(), len(piece_item),
                 ops.pts.data_ptr(), ops.r2, counts.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"radius_count kernel launch failed: CUDA error {err}")
    radius_count.launches += 1
    return counts


def radius_count(query, support, window, n_windows: int, radius: float):
    """(N, 3) f32 queries, (M, 3) f32 support points with their window ids
    (M,) int32 in [0, n_windows) -> (N, n_windows) int32 neighbour counts
    within ``radius``. CUDA tensors run kernel R1; CPU tensors the plain
    version."""
    _check(query, support, window, n_windows)
    if not on_cuda((("query", query), ("support", support), ("window", window))):
        return radius_count_reference(query, support, window, n_windows, radius)
    out = torch.zeros((query.shape[0], n_windows), dtype=torch.int32, device=query.device)
    if query.shape[0] == 0 or support.shape[0] == 0:
        return out
    ops = radius_operands(query, support, window, n_windows, radius)
    out[ops.qorder] = radius_launch(ops)
    return out


radius_count.launches = 0
