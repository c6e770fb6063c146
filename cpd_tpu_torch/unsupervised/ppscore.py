"""``points_rigid_transform`` (port of cpd_tpu/unsupervised/ppscore.py:32),
the one piece of the PPScore module that the Waymo reader needs: it
registers past frames into the current one. PPScore itself is not ported
yet."""
from __future__ import annotations

import numpy as np


def points_rigid_transform(points: np.ndarray, pose: np.ndarray) -> np.ndarray:
    """Apply a 4x4 pose to (N, 3+) points (xyz transformed, extras kept)."""
    if len(points) == 0:
        return points
    out = points.copy()
    xyz1 = np.concatenate([points[:, :3], np.ones((len(points), 1))], axis=1)
    out[:, :3] = (xyz1 @ pose.T)[:, :3]
    return out
