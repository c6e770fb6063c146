"""Ground segmentation: polar-grid piecewise line fitting (Himmelsbach-style)
(port of cpd_tpu/unsupervised/ground.py, the same NumPy).

Parity with cpd/unsupervised_core/ground_removal.py (Processor/Segmentation:
per-angular-segment range bins, incremental least-squares ground lines) and
OutlineFitter.remove_ground's distance-banded height gating
(outline_utils.py:542). ``_bin_minima`` keeps the JAX loop's result (the last
write in the same ``argsort`` order wins each bin) without its Python loop
over every point.
"""
from __future__ import annotations

import numpy as np


class GroundSegmenter:
    """Fit piecewise ground lines in (range, z) per angular segment."""

    def __init__(self, n_segments: int = 48, n_bins: int = 80, max_range: float = 80.0,
                 sensor_height: float = 0.0, max_slope: float = 0.15,
                 max_line_error: float = 0.15, max_start_height: float = 0.5,
                 ground_margin: float = 0.3):
        self.n_segments = n_segments
        self.n_bins = n_bins
        self.max_range = max_range
        self.sensor_height = sensor_height
        self.max_slope = max_slope
        self.max_line_error = max_line_error
        self.max_start_height = max_start_height
        self.ground_margin = ground_margin

    def _bin_minima(self, points):
        """Per (segment, bin) lowest point -> (S, B) z and (S, B) range, NaN if empty."""
        r = np.linalg.norm(points[:, :2], axis=1)
        ang = np.arctan2(points[:, 1], points[:, 0])
        seg = np.clip(((ang + np.pi) / (2 * np.pi) * self.n_segments).astype(int), 0, self.n_segments - 1)
        bins = np.clip((r / self.max_range * self.n_bins).astype(int), 0, self.n_bins - 1)
        z = np.full((self.n_segments, self.n_bins), np.nan)
        rr = np.full((self.n_segments, self.n_bins), np.nan)
        order = np.argsort(-points[:, 2])  # ascending later writes win -> keep min z
        # the JAX loop writes points[i] for i in order: each bin keeps its last
        # write, the first occurrence in the reversed order
        flat = (seg * self.n_bins + bins)[order[::-1]]
        cells, first = np.unique(flat, return_index=True)
        last = order[::-1][first]
        z.reshape(-1)[cells] = points[last, 2]
        rr.reshape(-1)[cells] = r[last]
        return z, rr, seg, bins, r

    def ground_height(self, points):
        """Per-point estimated ground z via the fitted segment lines."""
        z, rr, seg, bins, r = self._bin_minima(points)
        ground_z = np.full(len(points), -self.sensor_height, np.float64)
        for s in range(self.n_segments):
            valid = ~np.isnan(z[s])
            if valid.sum() < 2:
                continue
            xs, ys = rr[s][valid], z[s][valid]
            # robust piecewise fit: iterate a single line, drop outliers
            a, b = np.polyfit(xs, ys, 1)
            for _ in range(3):
                res = np.abs(a * xs + b - ys)
                keep = res < max(self.max_line_error, np.percentile(res, 70))
                if keep.sum() < 2:
                    break
                a2, b2 = np.polyfit(xs[keep], ys[keep], 1)
                a, b = a2, b2
            a = np.clip(a, -self.max_slope, self.max_slope)
            m = seg == s
            ground_z[m] = a * r[m] + b
        return ground_z

    def __call__(self, points):
        """(N, 3+) -> (non_ground_mask (N,), ground_z (N,))."""
        gz = self.ground_height(points)
        non_ground = points[:, 2] > gz + self.ground_margin
        return non_ground, gz


def remove_ground(points, ground_margin: float = 0.3, **kw):
    """Convenience: return the non-ground subset (OutlineFitter.remove_ground)."""
    seg = GroundSegmenter(ground_margin=ground_margin, **kw)
    mask, _ = seg(points)
    return points[mask]


def remove_ground_banded(points, segmenter=None, max_threshold: float = 1.0,
                         min_threshold=(0.2, -0.5, -0.5),
                         min_distance=(0.0, 20.0, 40.0, 100.0)):
    """The reference's full remove_ground composition
    (outline_utils.py:542-577): points at z >= ``max_threshold`` always
    survive; the rest go through the line-fit segmenter; the union is then
    gated per sensor-distance band -- band i keeps only z >
    ``min_threshold[i]`` (bands: d < min_distance[1]; strictly-between
    interior bands; d > min_distance[-2] for the last). Returns (M, 3) xyz
    in band order, matching the reference's output layout."""
    pts = np.asarray(points)
    high = pts[pts[:, 2] >= max_threshold]
    low = pts[pts[:, 2] < max_threshold]
    segmenter = segmenter or GroundSegmenter()
    mask, _ = segmenter(low)
    ng = np.concatenate([high[:, :3], low[mask][:, :3]], 0)
    d = np.linalg.norm(ng[:, :3], axis=1)
    bands = []
    n = len(min_threshold)
    for i in range(n):
        if i == 0:
            m = d < min_distance[1]
        elif i == n - 1:
            m = d > min_distance[i]
        else:
            m = (d > min_distance[i]) & (d < min_distance[i + 1])
        sel = ng[m]
        bands.append(sel[sel[:, 2] > min_threshold[i]])
    return np.concatenate(bands, 0)
