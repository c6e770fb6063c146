"""Persistence Point Score (PPScore): per-point ephemerality over traversals
(port of cpd_tpu/unsupervised/ppscore.py).

Parity with cpd/unsupervised_core/precompute_ppscore.py:8-101: for each point
of the current frame, count neighbours (within a radius) in several temporal
windows of pose-registered past/future frames; the normalised entropy of the
window counts is the score -- near 1 where the neighbourhood is seen alike in
every window (persistent structure), near 0 where it shows up in one window
only (a mover). The reference walks +-30 frames in windows of 5.

The counts run through kernel R1 (``ops.radius.radius_count``) on the CUDA
card, on the CPU through its plain version when ``device="cpu"`` is asked
for. The JAX package counts with its host library, whose cell lookup skips a
neighbour cell near cell edges (ROADMAP section 3); the port counts every
point within the radius. The entropy stays numpy f64 then f32, as in JAX.
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from ..ops.radius import radius_count
from ..utils.device import resolve_device


def compute_ephe_score(counts: np.ndarray) -> np.ndarray:
    """(N, W) neighbour counts per window -> (N,) normalised entropy.

    H = -sum_w p_w log(p_w + 1e-8) / log(W) with p_w = c_w / (sum c + 1e-8).
    With one window log(W) is 0 and the score NaN or inf, as in JAX.
    """
    counts = np.asarray(counts, np.float64)
    n, w = counts.shape
    # exact reference formula (precompute_ppscore.py:16): all-zero counts
    # (never observed anywhere) -> P = 0 -> H = 0 (fully ephemeral)
    p = counts / (counts.sum(axis=1, keepdims=True) + 1e-8)
    h = -np.sum(p * np.log(p + 1e-8), axis=1) / np.log(w)
    return h.astype(np.float32)


def points_rigid_transform(points: np.ndarray, pose: np.ndarray) -> np.ndarray:
    """Apply a 4x4 pose to (N, 3+) points (xyz transformed, extras kept)."""
    if len(points) == 0:
        return points
    out = points.copy()
    xyz1 = np.concatenate([points[:, :3], np.ones((len(points), 1))], axis=1)
    out[:, :3] = (xyz1 @ pose.T)[:, :3]
    return out


def ppscore_windows(cur_points, other_points, other_valid, radius: float = 0.3):
    """The counterpart of JAX's ``ppscore_jax``: cur_points (N, 3) f32,
    other_points (W, M, 3) f32, one row per window, with validity masks
    other_valid (W, M) -> (counts (N, W) f32, h (N,) f32), the counts
    through kernel R1 (its plain version for CPU tensors)."""
    w, m = other_valid.shape
    valid = other_valid.reshape(-1)
    window = torch.arange(w, dtype=torch.int32, device=cur_points.device).repeat_interleave(m)
    support = other_points.reshape(-1, 3)[valid].contiguous()
    counts = radius_count(cur_points.contiguous(), support, window[valid].contiguous(), w,
                          radius).float()
    p = counts / (counts.sum(1, keepdim=True) + 1e-8)
    h = -(p * torch.log(p + 1e-8)).sum(1) / torch.tensor(math.log(w), dtype=torch.float32)
    return counts, h


def frame_windows(
    cur_points: np.ndarray,
    cur_pose: np.ndarray,
    frames: Sequence[np.ndarray],
    poses: Sequence[np.ndarray],
    window: int = 5,
    subsample: int = 1,
):
    """Kernel R1's operands for one frame: (query (N, 3) f32 world points,
    support (M, 3) f32 world points of ``frames``, their window ids (M,)
    int32, W), the W = max(len(frames) // window, 1) windows of ``window``
    frames (frames past the last whole window are left out, as in JAX)."""
    world_cur = points_rigid_transform(cur_points, cur_pose)[:, :3]
    n_windows = max(len(frames) // window, 1)
    chunks, ids = [], []
    for w in range(n_windows):
        for f, p in zip(frames[w * window : (w + 1) * window], poses[w * window : (w + 1) * window]):
            if f is None or len(f) == 0:
                continue
            pts = f[::subsample] if subsample > 1 else f
            chunks.append(points_rigid_transform(pts, p)[:, :3])
            ids.append(np.full(len(pts), w, np.int32))
    support = np.concatenate(chunks, axis=0) if chunks else np.zeros((0, 3))
    ids = np.concatenate(ids) if ids else np.zeros(0, np.int32)
    return (np.ascontiguousarray(world_cur, np.float32), np.ascontiguousarray(support, np.float32),
            ids, n_windows)


def ppscore_counts_for_frame(
    cur_points: np.ndarray,
    cur_pose: np.ndarray,
    frames: Sequence[np.ndarray],
    poses: Sequence[np.ndarray],
    radius: float = 0.3,
    window: int = 5,
    subsample: int = 1,
    device=None,
) -> np.ndarray:
    """(N, W) int32 neighbour counts of the points of one frame in the
    windows of ``frames`` (``frame_windows``), all windows in one launch of
    kernel R1 on ``device`` (default: the CUDA card)."""
    device = resolve_device(device)
    query, support, ids, n_windows = frame_windows(cur_points, cur_pose, frames, poses, window,
                                                   subsample)
    counts = radius_count(*(torch.from_numpy(a).to(device) for a in (query, support, ids)),
                          n_windows, radius)
    return counts.cpu().numpy()


def ppscore_for_frame(
    cur_points: np.ndarray,
    cur_pose: np.ndarray,
    frames: Sequence[np.ndarray],
    poses: Sequence[np.ndarray],
    radius: float = 0.3,
    window: int = 5,
    max_range: int = 30,
    subsample: int = 1,
    device=None,
) -> np.ndarray:
    """Compute the PPScore of every point of one frame.

    cur_points: (N, 3+) in sensor frame; frames/poses: the +-max_range
    neighbourhood of the sequence (sensor-frame points + 4x4 world poses).
    Returns (N,) float16-representable scores in [0, 1]. The counts run on
    ``device`` (default: the CUDA card; ``"cpu"`` for the plain version).
    """
    counts = ppscore_counts_for_frame(cur_points, cur_pose, frames, poses, radius, window,
                                      subsample, device)
    return compute_ephe_score(counts)
