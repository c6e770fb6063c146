"""``box_frame_inverse`` (port of cpd_tpu/unsupervised/cproto.py:50), the
one piece of the C-PROTO refiner that the Waymo reader needs: it re-poses a
prototype bank into a box. The refiner itself is not ported yet."""
from __future__ import annotations

import numpy as np


def box_frame_inverse(points: np.ndarray, box: np.ndarray) -> np.ndarray:
    """Box-canonical points -> the frame of ``box``."""
    c, s = np.cos(box[6]), np.sin(box[6])
    out = points.copy()
    out[:, 0] = points[:, 0] * c - points[:, 1] * s + box[0]
    out[:, 1] = points[:, 0] * s + points[:, 1] * c + box[1]
    out[:, 2] = points[:, 2] + box[2]
    return out
