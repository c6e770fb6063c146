"""Point-cloud surgery ops used by the refiner and domain-adaptation sampler
(port of cpd_tpu/datasets/point_ops.py, NumPy as there).

Parity with cpd/unsupervised_core/ob_op.py (box_cut :51, la_sampling :17,
random_drop_out :90, remove_past :110) and the radius_sampling thinning of
the DADataBaseSampler (database_sampler.py:543). Fresh NumPy.
"""
from __future__ import annotations

import numpy as np

from .box_np import points_in_boxes_mask_fast


def box_cut(points, boxes, enlarge=(0.0, 0.0, 0.0)):
    """Split points into (inside_any_box, outside_all) (ob_op.box_cut)."""
    if len(boxes) == 0:
        return points[:0], points
    b = np.asarray(boxes, np.float32).copy()
    b[:, 3:6] += np.asarray(enlarge, np.float32)
    mask = points_in_boxes_mask_fast(points[:, :3], b).any(axis=0)
    return points[mask], points[~mask]


def la_sampling(points, v_res_deg: float = 0.4, h_res_deg: float = 0.2,
                keep_every: int = 2, rng=None):
    """Spherical-grid LiDAR re-sampling (ob_op.la_sampling): quantize points
    into (elevation, azimuth) beams and keep every ``keep_every``-th beam --
    simulates a lower-resolution sensor for domain adaptation."""
    r = np.linalg.norm(points[:, :3], axis=1)
    az = np.arctan2(points[:, 1], points[:, 0])
    el = np.arcsin(np.clip(points[:, 2] / np.clip(r, 1e-6, None), -1, 1))
    beam = np.floor(np.degrees(el) / v_res_deg).astype(int)
    keep = beam % keep_every == 0
    return points[keep]


def random_drop_out(points, max_drop: float = 0.5, rng=None):
    """Random global sparsification (ob_op.random_drop_out)."""
    rng = rng or np.random.default_rng(0)
    frac = rng.uniform(0.0, max_drop)
    keep = rng.random(len(points)) >= frac
    return points[keep]


def radius_sampling(points, dis=(5.0, 5.0, 5.0, 5.0), intev=(7, 5, 4, 2)):
    """Distance-banded subsampling (waymo_unsupervised_dataset.radius_sampling):
    near points are thinned aggressively, far points kept."""
    r = np.linalg.norm(points[:, :2], axis=1)
    kept = [points[r >= float(np.sum(dis))]]
    lo = 0.0
    for band, step in zip(dis, intev):
        m = (r >= lo) & (r < lo + band)
        kept.append(points[m][::max(int(step), 1)])
        lo += band
    return np.concatenate(kept, axis=0)


def remove_past(points, boxes, names, region_radius: float = 75.0, rng=None):
    """Swap far-region objects with sampled near objects (ob_op.remove_past
    capability): drop object points outside the kept region along with their
    boxes."""
    r = np.linalg.norm(boxes[:, :2], axis=1) if len(boxes) else np.zeros(0)
    keep_boxes = r < region_radius
    dropped = boxes[~keep_boxes]
    if len(dropped):
        inside = points_in_boxes_mask_fast(points[:, :3], dropped).any(axis=0)
        points = points[~inside]
    return points, boxes[keep_boxes], np.asarray(names)[keep_boxes] if len(names) else names
