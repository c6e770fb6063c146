"""Kernel F1: farthest point sampling, the keypoint sampler of the PFE
(``models/pfe.py::VoxelSetAbstraction``).

``farthest_point_sample(points, valid, num_samples)`` picks ``num_samples``
indices per sample of a (B, N, 3+) batch: the first valid point, then each
time the point whose distance to the nearest point already picked is the
largest. It stands in for the JAX op chain
``cpd_tpu/ops/pool.py::farthest_point_sample`` (a ``lax.fori_loop`` of one
norm, minimum and argmax over all points a sample); no Pallas kernel
computes it. Source ``csrc/farthest_point_sample.cu``, built and bound by
``ops/cuda_build.py``: one block a sample, the whole batch in one launch.

Both versions reproduce the JAX loop exactly: a padded point is never
chosen while a valid one exists, ties go to the lower index, with fewer
valid points than samples the first valid point repeats, with none every
index is 0, and the distance is ``jnp.linalg.norm``'s on the CPU:
``sqrt(fma(dz, dz, fma(dy, dy, dx*dx)))`` in f32 (``fused_norm``; XLA contracts
the sum of squares into fused multiply-adds).

A CUDA tensor launches the kernel (``farthest_point_sample.launches``
counts the launches) or raises; a CPU tensor computes the plain version,
``farthest_point_sample_reference``, the JAX loop restated.
"""
from __future__ import annotations

import ctypes

import torch

from .cuda_build import load, on_cuda

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2


def _check(points, valid, num_samples):
    if points.dim() != 3 or points.shape[2] < 3:
        raise ValueError(f"want points (B, N, 3+), got {tuple(points.shape)}")
    if valid.shape != points.shape[:2] or valid.dtype != torch.bool:
        raise ValueError(f"want a bool valid mask of {tuple(points.shape[:2])}, got "
                         f"{valid.dtype} {tuple(valid.shape)}")
    if points.shape[1] < 1 or num_samples < 1:
        raise ValueError(f"need at least one point and one sample, got N={points.shape[1]}, "
                         f"num_samples={num_samples}")
    if points.shape[1] >= 2 ** 31:
        raise ValueError("too many points for the kernel's 32-bit index")


def fused_norm(d):
    """|d| over the last axis as ``jnp.linalg.norm`` computes it on the CPU
    under ``jit``: sqrt(fma(d2, d2, fma(d1, d1, d0*d0))) in f32 (for 3
    components; fewer or more chain the same way), each fused multiply-add
    and the square root rounded once (emulated in f64, where the f32 products
    are exact and the f64 square root rounds to the f32 one; torch's f32
    ``sqrt`` on the CPU is not always correctly rounded)."""
    x = d[..., 0].double()
    s = (x * x).float().double()
    for i in range(1, d.shape[-1]):
        x = d[..., i].double()
        s = (x * x + s).float().double()
    return torch.sqrt(s).float()


def _distance(points, centre):
    """(B, N) f32 distances of (B, N, 3) ``points`` to (B, 3) ``centre``."""
    return fused_norm(points - centre[:, None, :])


def farthest_point_sample_reference(points, valid, num_samples: int):
    """Plain PyTorch version of kernel F1 (the JAX loop restated): (B, N, 3+)
    points, (B, N) bool valid -> (B, num_samples) int32 indices."""
    _check(points, valid, num_samples)
    xyz = points[..., :3].float()
    b = xyz.shape[0]
    rows = torch.arange(b, device=xyz.device)
    neg_inf = torch.tensor(float("-inf"), device=xyz.device)
    sel = torch.zeros((b, num_samples), dtype=torch.int64, device=xyz.device)
    far = valid.to(torch.uint8).argmax(dim=1)  # the first valid point, 0 when none
    sel[:, 0] = far
    dists = torch.where(valid, float("inf"), neg_inf)
    for i in range(1, num_samples):
        dists = torch.minimum(dists, _distance(xyz, xyz[rows, far]))
        far = torch.where(valid, dists, neg_inf).argmax(dim=1)
        sel[:, i] = far
    return sel.to(torch.int32)


def fps_operands(points, valid):
    """Kernel F1's operands: the coordinates as (B, 3, N) f32
    structure-of-arrays, the mask as (B, N) uint8 and the (B, N) f32 buffer
    of running minimum distances (the kernel initialises it)."""
    b, n = valid.shape
    xyz = points[..., :3].float().transpose(1, 2).contiguous()
    ok = valid.to(torch.uint8).contiguous()
    return xyz, ok, torch.empty((b, n), dtype=torch.float32, device=points.device)


def fps_launch(xyz, ok, mind, num_samples: int):
    """One launch of kernel F1 on ``fps_operands``' tensors (counted in
    ``farthest_point_sample.launches``) -> (B, num_samples) int32."""
    b, n = ok.shape
    sel = torch.empty((b, num_samples), dtype=torch.int32, device=xyz.device)
    fn = load("farthest_point_sample", _ARGTYPES)
    with torch.cuda.device(xyz.device):
        err = fn(xyz.data_ptr(), ok.data_ptr(), mind.data_ptr(), b, n, num_samples,
                 sel.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"farthest_point_sample kernel launch failed: CUDA error {err}")
    farthest_point_sample.launches += 1
    return sel


def farthest_point_sample(points, valid, num_samples: int):
    """(B, N, 3+) points (the first three columns are read), (B, N) bool
    valid -> (B, num_samples) int32 indices. CUDA tensors run kernel F1;
    CPU tensors the plain version."""
    _check(points, valid, num_samples)
    if not on_cuda((("points", points), ("valid", valid))):
        return farthest_point_sample_reference(points, valid, num_samples)
    return fps_launch(*fps_operands(points, valid), num_samples)


farthest_point_sample.launches = 0
