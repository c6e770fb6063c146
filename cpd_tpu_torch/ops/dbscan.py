"""Kernel R2: DBSCAN labels, the clustering of the pseudo-label factory.

``dbscan_labels(points, eps, min_samples)`` gives the labels of
``sklearn.cluster.DBSCAN(eps, min_samples).fit(points).labels_`` (and of the
JAX package's fallback ``cpd_tpu/unsupervised/outline.py::_dbscan_bfs``) in
closed form:

* a core point has at least ``min_samples`` points within ``eps``, itself
  included, by ``(dx*dx + dy*dy) + dz*dz <= eps**2`` in f64;
* clusters are the connected components of the core points, numbered in the
  order of each component's smallest core index;
* a point that is not core takes the smallest cluster number among its core
  neighbours, and -1 if it has none.

It stands in for a host library (sklearn, which the card's machine does not
have); no Pallas kernel computes it. Source ``csrc/dbscan.cu``, built and
bound by ``ops/cuda_build.py``; the cell grid, the column table and the walk
are kernel R1's (``radius.grid_cells``' cells at ``eps`` times
``radius.CELL_MARGIN``, ``csrc/cell_walk.cuh``).

``dbscan_labels_batched(points, segment_offsets, eps, min_samples)``
clusters many clouds in one call, each alone: the labels of segment s equal
``dbscan_labels(points[offsets[s]:offsets[s + 1]], ...)``. Each segment gets
its own grid origin and dims, its columns numbered after the previous
segment's, so points of two segments never neighbour. ``dbscan_labels``
builds the same grid over one segment, the whole cloud: its cells are
``radius.grid_cells``'.

A CUDA tensor launches the kernel (``dbscan_labels.launches`` counts the
launches of either entry, ``dbscan_labels_batched.launches`` those of the
segmented one); a CPU tensor computes the plain versions,
``dbscan_reference`` (pairwise distances in chunks, then min-label
propagation over the core points until nothing changes) and
``dbscan_batched_reference`` (it, a segment at a time). On the card the
neighbour pairs are listed once where the card can hold the list
(``pair_list``); where it cannot, the union and the border labels walk
the cells again.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .cuda_build import load, on_cuda
from .radius import (CELL_MARGIN, PAIRS_PER_CHUNK, CellPlan, cell_groups, cell_runs, check_grid,
                     column_table, padded, walk_pieces)

_INT_MAX = 2 ** 31 - 1
# (keys, start, gstart, gcol, gz, gny), NZ, (runs, piece_item, piece_k), P, pts, eps2
_PLAN_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] + [ctypes.c_void_p] * 3 + [
    ctypes.c_int, ctypes.c_void_p, ctypes.c_double]
_COUNT_ARGTYPES = _PLAN_ARGTYPES + [ctypes.c_void_p] * 2
_LINK_ARGTYPES = _PLAN_ARGTYPES + [ctypes.c_void_p] * 5 + [ctypes.c_longlong] + [
    ctypes.c_void_p] * 2
_LABELS_ARGTYPES = _PLAN_ARGTYPES + [ctypes.c_int] + [ctypes.c_void_p] * 12
_BOUNDS_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3
# indices a block of the rank's scan (csrc/dbscan.cu kRankChunk), points a
# block of the segment bounds
RANK_CHUNK = 2048
BOUNDS_SHARE = 8192


def _check(points):
    if points.dim() != 2 or points.shape[1] != 3:
        raise ValueError(f"want points (N, 3), got {tuple(points.shape)}")
    if points.dtype != torch.float64:
        raise TypeError(f"want f64 points, got {points.dtype}")
    if points.shape[0] >= 2 ** 31:
        raise ValueError("too many points for the kernel's 32-bit indices")


def neighbour_pairs(points, eps: float):
    """Every ordered pair (i, j) with ``(dx*dx + dy*dy) + dz*dz <= eps**2``
    in f64, i == j included: two int64 tensors, rows in order."""
    n = points.shape[0]
    eps2 = eps * eps
    rows = max(1, PAIRS_PER_CHUNK[points.device.type] // 2 // max(n, 1))
    src, dst = [], []
    for r0 in range(0, n, rows):
        p = points[r0:r0 + rows]
        ex = p[:, None, 0] - points[None, :, 0]
        ey = p[:, None, 1] - points[None, :, 1]
        ez = p[:, None, 2] - points[None, :, 2]
        i, j = torch.nonzero(ex * ex + ey * ey + ez * ez <= eps2, as_tuple=True)
        src.append(i + r0)
        dst.append(j)
    return torch.cat(src), torch.cat(dst)


def dbscan_reference(points, eps: float, min_samples: int):
    """Plain PyTorch version of kernel R2 -> (N,) int32 labels."""
    n = points.shape[0]
    dev = points.device
    if n == 0:
        return torch.zeros(0, dtype=torch.int32, device=dev)
    src, dst = neighbour_pairs(points, eps)
    core = torch.bincount(src, minlength=n) >= min_samples
    # min-label propagation with pointer jumping: every core point ends at the
    # smallest index of its component
    both = core[src] & core[dst]
    a, b = src[both], dst[both]
    lab = torch.arange(n, device=dev)
    while True:
        new = lab.scatter_reduce(0, a, lab[b], reduce="amin")
        new = new[new]
        if torch.equal(new, lab):
            break
        lab = new
    roots = core & (lab == torch.arange(n, device=dev))
    rank = torch.cumsum(roots.long(), 0) - 1
    labels = torch.full((n,), -1, dtype=torch.long, device=dev)
    labels[core] = rank[lab[core]]
    # a border point: the smallest root among its core neighbours
    border = ~core[src] & core[dst]
    best = torch.full((n,), n, dtype=torch.long, device=dev)
    best.scatter_reduce_(0, src[border], lab[dst[border]], reduce="amin")
    hit = ~core & (best < n)
    labels[hit] = rank[best[hit]]
    return labels.int()


def segment_offsets_of(segment_offsets, n: int):
    """``segment_offsets`` (S + 1 nondecreasing ints from 0 to ``n``) as a
    CPU int64 tensor; raises on anything else."""
    offs = torch.as_tensor(segment_offsets, dtype=torch.int64).cpu()
    if offs.dim() != 1 or len(offs) < 2 or int(offs[0]) != 0 or int(offs[-1]) != n \
            or bool((offs[1:] < offs[:-1]).any()):
        raise ValueError(f"segment offsets must rise from 0 to {n}, got {offs.tolist()[:8]}...")
    return offs


def dbscan_batched_reference(points, segment_offsets, eps: float, min_samples: int):
    """Plain PyTorch version of the segmented launch: ``dbscan_reference``
    on each segment alone -> (N,) int32 labels, each segment's from 0."""
    offs = segment_offsets_of(segment_offsets, points.shape[0]).tolist()
    return torch.cat([dbscan_reference(points[a:b], eps, min_samples)
                      for a, b in zip(offs[:-1], offs[1:])])


class DbscanOperands(NamedTuple):
    """Kernel R2's operands on the card: the points sorted by (segment,
    cell) (``pts``, (N, 4) f64; ``perm`` the original index of each) under
    ``plan``, each sorted point's segment start (``seg_first``; None for one
    segment) and ``eps2``."""
    pts: torch.Tensor
    perm: torch.Tensor
    plan: CellPlan
    seg_first: torch.Tensor | None
    eps2: float


def pair_list(pairs: int, device):
    """Kernel R2's list of ``pairs`` pairs on ``device``: (entries filled
    with -1, their row indices), two (pairs,) int32 tensors, or None where
    the card cannot hold them (the allocation runs out of memory). No
    memory is read ahead: a read of the card's free memory or of PyTorch's
    allocator statistics is a host call that the card waits for."""
    try:
        entries = torch.full((pairs,), -1, dtype=torch.int32, device=device)
        return entries, torch.empty_like(entries)
    except torch.OutOfMemoryError:
        return None


def segment_bounds(cells, offsets, longest: int):
    """(lo, hi): (S, 3) int64, the smallest and largest of the (N, 3) int64
    ``cells`` on the card in each segment of ``offsets`` ((S + 1,) int64 on
    the card; ``longest`` its longest segment); an empty segment gets (0,
    0). Blocks of ``BOUNDS_SHARE`` points (``cpd_segment_bounds``)."""
    n_seg, dev = len(offsets) - 1, cells.device
    if dev.type != "cuda":
        raise ValueError(f"segment bounds run on the card, got {dev}")
    live = (offsets[1:] > offsets[:-1])[:, None]
    info = torch.iinfo(torch.int64)
    lo = torch.full((n_seg, 3), info.max, dtype=torch.int64, device=dev)
    hi = torch.full((n_seg, 3), info.min, dtype=torch.int64, device=dev)
    blocks = min(max(-(-longest // BOUNDS_SHARE), 1), 64)
    with torch.cuda.device(dev):
        _raise_on(load("dbscan", _BOUNDS_ARGTYPES, "cpd_segment_bounds")(
            cells.data_ptr(), offsets.data_ptr(), n_seg, blocks, lo.data_ptr(), hi.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream), "segment bounds")
    return torch.where(live, lo, 0), torch.where(live, hi, 0)


def dbscan_operands(points, eps: float, segment_offsets=None) -> DbscanOperands:
    """The cell grid of kernel R2, built in PyTorch (``torch.sort``): each
    segment of ``segment_offsets`` (a CPU int64 tensor; None: the whole
    cloud, one segment that needs no segment starts) its own origin one
    cell below its lowest point and its own dims, its columns (gx, gy)
    numbered after the previous segment's. A segment's cells are those of
    ``radius.grid_cells`` on its points alone."""
    n, dev = points.shape[0], points.device
    offs = torch.tensor([0, n]) if segment_offsets is None else segment_offsets
    longest = int((offs[1:] - offs[:-1]).max())
    offs = offs.to(dev)
    lengths = offs[1:] - offs[:-1]
    seg = torch.repeat_interleave(torch.arange(len(lengths), device=dev), lengths,
                                  output_size=n)
    cells = torch.floor(points / (eps * CELL_MARGIN)).long()
    lo, hi = segment_bounds(cells, offs, longest)
    lo -= 1
    dims = hi - lo + 2
    live = lengths > 0
    cols = torch.where(live, dims[:, 0] * dims[:, 1], 0)
    nz, n_cols = torch.stack([dims[:, 2][live].max(), cols.sum()]).tolist()
    check_grid(n_cols, nz)
    rel = cells - lo[seg]
    col = (torch.cumsum(cols, 0) - cols)[seg] + rel[:, 0] * dims[seg, 1] + rel[:, 1]
    keys, order = torch.sort(col * nz + rel[:, 2])
    seg_first = None if segment_offsets is None else offs[seg[order]].int()
    gstart, gcol, gz = cell_groups(keys, nz)
    gny = dims[seg[order[gstart[:-1].long()]], 1].int()
    plan = CellPlan(keys, column_table(keys // nz, n_cols), gstart, gcol, gz, gny, 0, 1, nz)
    return DbscanOperands(padded(points[order]), order.int(), plan, seg_first, eps * eps)


def dbscan_launch(ops: DbscanOperands, min_samples: int):
    """One call of kernel R2 (counted once in ``dbscan_labels.launches``,
    and in ``dbscan_labels_batched.launches`` where ``ops`` has segment
    starts): the runs, the count, the link (the list and its union, or the
    union walk) and the labels -> (N,) int32 labels by original index.
    Reads the number of pieces and of listed pairs from the card."""
    plan, dev = ops.plan, ops.pts.device
    n = ops.pts.shape[0]
    runs = cell_runs(plan, "dbscan")
    piece_item, piece_k = walk_pieces(runs, plan.n_items)
    stream = torch.cuda.current_stream(dev).cuda_stream
    head = (*plan.pointers(), plan.NZ, runs.data_ptr(), piece_item.data_ptr(),
            piece_k.data_ptr(), len(piece_item), ops.pts.data_ptr(), ops.eps2)
    counts = torch.zeros(n, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        _raise_on(load("dbscan", _COUNT_ARGTYPES, "cpd_dbscan_count")(
            *head, counts.data_ptr(), stream), "count")
        core = (counts >= min_samples).to(torch.uint8)
        off = torch.zeros(n + 1, dtype=torch.int64, device=dev)
        off[1:] = torch.cumsum(counts - 1, 0)
        n_edges = int(off[-1])
        # what both routes need, before the list takes what memory is left
        parent = torch.arange(n, dtype=torch.int32, device=dev)
        core_orig = torch.empty_like(core)
        core_orig[ops.perm.long()] = core
        rank = torch.empty(n, dtype=torch.int32, device=dev)
        chunk_sums = torch.empty(-(-n // RANK_CHUNK), dtype=torch.int32, device=dev)
        labels = torch.empty(n, dtype=torch.int32, device=dev)
        cursor = off[:-1].clone()
        listed = pair_list(n_edges, dev)
        entries, src = listed if listed else (None, None)
        _raise_on(load("dbscan", _LINK_ARGTYPES, "cpd_dbscan_link")(
            *head, core.data_ptr(), ops.perm.data_ptr(), _ptr(cursor), _ptr(entries), _ptr(src),
            n_edges if listed else 0, parent.data_ptr(), stream), "link")
        best = None if listed else torch.full((n,), _INT_MAX, dtype=torch.int32, device=dev)
        _raise_on(load("dbscan", _LABELS_ARGTYPES, "cpd_dbscan_labels")(
            *head, n, core.data_ptr(), core_orig.data_ptr(), ops.perm.data_ptr(),
            parent.data_ptr(), rank.data_ptr(), chunk_sums.data_ptr(), off.data_ptr(),
            _ptr(entries), _ptr(best), _ptr(ops.seg_first), labels.data_ptr(), stream), "labels")
    dbscan_labels.launches += 1
    if ops.seg_first is not None:
        dbscan_labels_batched.launches += 1
    return labels


def _ptr(t):
    return None if t is None else t.data_ptr()


def _raise_on(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"dbscan {what} kernel launch failed: CUDA error {err}")


def dbscan_labels(points, eps: float, min_samples: int):
    """(N, 3) f64 points -> (N,) int32 DBSCAN labels (-1: noise). CUDA
    tensors run kernel R2; CPU tensors the plain version."""
    _check(points)
    if not on_cuda((("points", points),)):
        return dbscan_reference(points, eps, min_samples)
    if points.shape[0] == 0:
        return torch.empty(0, dtype=torch.int32, device=points.device)
    return dbscan_launch(dbscan_operands(points, eps), min_samples)


def dbscan_labels_batched(points, segment_offsets, eps: float, min_samples: int):
    """(N, 3) f64 points in S segments (``segment_offsets``: S + 1 ints from 0
    to N) -> (N,) int32 DBSCAN labels of each segment alone, its clusters
    numbered from 0 (-1: noise). CUDA tensors run kernel R2 once for all
    segments; CPU tensors the plain version."""
    _check(points)
    offs = segment_offsets_of(segment_offsets, points.shape[0])
    if not on_cuda((("points", points),)):
        return dbscan_batched_reference(points, offs, eps, min_samples)
    if points.shape[0] == 0:
        return torch.empty(0, dtype=torch.int32, device=points.device)
    return dbscan_launch(dbscan_operands(points, eps, offs), min_samples)


dbscan_labels.launches = 0
dbscan_labels_batched.launches = 0
