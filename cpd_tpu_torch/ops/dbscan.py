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
bound by ``ops/cuda_build.py``; the cell grid is kernel R1's
(``radius.grid_cells`` at ``eps`` times ``radius.CELL_MARGIN``).

A CUDA tensor launches the kernel (``dbscan_labels.launches`` counts the
launches); a CPU tensor computes the plain version, ``dbscan_reference``:
pairwise distances in chunks, then min-label propagation over the core
points until nothing changes.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .cuda_build import load, on_cuda
from .radius import CELL_MARGIN, PAIRS_PER_CHUNK, cell_keys, grid_cells

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_double, ctypes.c_int] + [
    ctypes.c_void_p] * 6


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


class DbscanOperands(NamedTuple):
    """Kernel R2's operands on the card: the points sorted by cell (``pts``,
    their cells ``cell`` under ``keys``, ``perm`` the original index of each),
    the grid's ``dims`` and ``eps2``."""
    pts: torch.Tensor
    cell: torch.Tensor
    keys: torch.Tensor
    perm: torch.Tensor
    dims: tuple
    eps2: float


def dbscan_operands(points, eps: float) -> DbscanOperands:
    """The cell grid of kernel R2, built in PyTorch (``torch.sort``)."""
    (cells,), dims = grid_cells((points,), eps * CELL_MARGIN)
    if dims[0] * dims[1] * dims[2] >= 2 ** 62:
        raise ValueError(f"grid {dims} too large for 64-bit cell keys")
    keys, order = torch.sort(cell_keys(cells, dims))
    return DbscanOperands(points[order].contiguous(), cells[order].int().contiguous(), keys,
                          order.int().contiguous(), dims, eps * eps)


def dbscan_launch(ops: DbscanOperands, min_samples: int):
    """One call of kernel R2's five launches (counted once in
    ``dbscan_labels.launches``) -> (N,) int32 labels by original index."""
    fn = load("dbscan", _ARGTYPES)
    n, dev = ops.pts.shape[0], ops.pts.device
    labels = torch.empty(n, dtype=torch.int32, device=dev)
    core_sorted = torch.empty(n, dtype=torch.uint8, device=dev)
    core = torch.empty_like(core_sorted)
    parent = torch.empty(n, dtype=torch.int32, device=dev)
    rank = torch.empty_like(parent)
    with torch.cuda.device(dev):
        err = fn(ops.pts.data_ptr(), ops.cell.data_ptr(), ops.keys.data_ptr(),
                 ops.perm.data_ptr(), n, *ops.dims, ops.eps2, min_samples,
                 core_sorted.data_ptr(), core.data_ptr(), parent.data_ptr(), rank.data_ptr(),
                 labels.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"dbscan kernel launch failed: CUDA error {err}")
    dbscan_labels.launches += 1
    return labels


def dbscan_labels(points, eps: float, min_samples: int):
    """(N, 3) f64 points -> (N,) int32 DBSCAN labels (-1: noise). CUDA
    tensors run kernel R2; CPU tensors the plain version."""
    _check(points)
    if not on_cuda((("points", points),)):
        return dbscan_reference(points, eps, min_samples)
    if points.shape[0] == 0:
        return torch.empty(0, dtype=torch.int32, device=points.device)
    return dbscan_launch(dbscan_operands(points, eps), min_samples)


dbscan_labels.launches = 0
