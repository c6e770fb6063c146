"""Host-side NumPy box geometry for the data pipeline (port of
cpd_tpu/datasets/box_np.py).

``points_in_boxes_mask_fast`` runs the threaded C++ library
``cpd_tpu_torch.native``, as the JAX package's runs ``cpd_tpu.native``; it
raises where the library does not build. ``points_in_boxes_mask_np`` is its
plain version: the two masks differ only on points within an f32 rounding
of a box face (tests/test_torch_port_native.py).
"""
from __future__ import annotations

import numpy as np


def points_in_box_np(points, box):
    shifted = points[:, :3] - box[:3]
    c, s = np.cos(-box[6]), np.sin(-box[6])
    lx = shifted[:, 0] * c - shifted[:, 1] * s
    ly = shifted[:, 0] * s + shifted[:, 1] * c
    return (
        (np.abs(lx) <= box[3] / 2)
        & (np.abs(ly) <= box[4] / 2)
        & (np.abs(shifted[:, 2]) <= box[5] / 2)
    )


def points_in_boxes_mask_np(points, boxes):
    """(N, 3), (M, 7) -> (M, N) bool."""
    return np.stack([points_in_box_np(points, b) for b in boxes]) if len(boxes) else np.zeros((0, len(points)), bool)


def points_in_boxes_mask_fast(points, boxes):
    """The same mask from the native library."""
    from .. import native

    return native.points_in_boxes_mask(points, boxes)


def mask_points_by_range_np(points, pcr):
    return (
        (points[:, 0] >= pcr[0]) & (points[:, 0] <= pcr[3])
        & (points[:, 1] >= pcr[1]) & (points[:, 1] <= pcr[4])
        & (points[:, 2] >= pcr[2]) & (points[:, 2] <= pcr[5])
    )


def boxes_to_corners_3d_np(boxes):
    template = (
        np.array(
            [
                [1, 1, -1], [1, -1, -1], [-1, -1, -1], [-1, 1, -1],
                [1, 1, 1], [1, -1, 1], [-1, -1, 1], [-1, 1, 1],
            ],
            dtype=np.float32,
        )
        / 2.0
    )
    corners = boxes[:, None, 3:6] * template[None]
    c, s = np.cos(boxes[:, 6]), np.sin(boxes[:, 6])
    zeros, ones = np.zeros_like(c), np.ones_like(c)
    rot = np.stack(
        [c, s, zeros, -s, c, zeros, zeros, zeros, ones], axis=-1
    ).reshape(-1, 3, 3)
    corners = np.einsum("nij,njk->nik", corners, rot)
    return corners + boxes[:, None, 0:3]
