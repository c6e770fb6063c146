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
kernel R2), the support sorted by (window, cell) with ``torch.sort``, the
queries sorted by cell. The cell is the radius times ``CELL_MARGIN``: a cell
exactly as wide as the radius would let rounding put a neighbour two cells
away; with the margin the 27 cells around a query's own always hold every
support point within the radius.

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
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_longlong] + [ctypes.c_int] * 4 + [
    ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p]


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


class RadiusOperands(NamedTuple):
    """Kernel R1's operands on the card: queries sorted by cell (``q``, their
    cells ``qc`` and the order ``qorder``), support sorted by (window, cell)
    (``pts`` under ``keys``), the grid's ``dims`` and the f32 ``r2``."""
    q: torch.Tensor
    qc: torch.Tensor
    qorder: torch.Tensor
    keys: torch.Tensor
    pts: torch.Tensor
    n_windows: int
    dims: tuple
    r2: float


def radius_operands(query, support, window, n_windows: int, radius: float) -> RadiusOperands:
    """The cell grid of kernel R1, built in PyTorch (``torch.sort``)."""
    (qcell, scell), dims = grid_cells((query, support), radius * CELL_MARGIN)
    if dims[0] * dims[1] * dims[2] * n_windows >= 2 ** 62:
        raise ValueError(f"grid {dims} x {n_windows} windows too large for 64-bit cell keys")
    keys, order = torch.sort(cell_keys(scell, dims, window))
    qorder = torch.argsort(cell_keys(qcell, dims))
    return RadiusOperands(query[qorder].contiguous(), qcell[qorder].int().contiguous(), qorder,
                          keys, support[order].contiguous(), n_windows, dims, _r2(radius))


def radius_launch(ops: RadiusOperands):
    """One launch of kernel R1 (counted in ``radius_count.launches``) ->
    (N, n_windows) int32 counts in the order of ``ops.q``."""
    fn = load("radius_count", _ARGTYPES)
    n, m = ops.q.shape[0], ops.pts.shape[0]
    counts = torch.empty((n, ops.n_windows), dtype=torch.int32, device=ops.q.device)
    with torch.cuda.device(ops.q.device):
        err = fn(ops.q.data_ptr(), ops.qc.data_ptr(), ops.keys.data_ptr(), ops.pts.data_ptr(), n,
                 m, ops.n_windows, *ops.dims, ops.r2, counts.data_ptr(),
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
