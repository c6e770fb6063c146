"""Initial pseudo-label generators: DBSCAN / MFCF / OYSTER (port of
cpd_tpu/unsupervised/generators.py).

Parity with cpd/unsupervised_core/{dbscan.py, mfcf.py, oyster.py}:
  - DBSCANGenerator: per-frame remove_ground -> cluster -> box_fit ->
    size-classify -> drop Dis_* (dbscan.py:6-66, the weakest baseline).
  - MFCFGenerator (Multi-Frame Clustering & Fitting, CPD's init generator,
    mfcf.py:6-101): per frame, concatenate +-window frames in world pose,
    keep PPScore-dynamic points + the current frame, voxel-downsample,
    remove ground, cluster, box_fit_DGD, then whole-sequence TrackSmooth.
  - OYSTERGenerator (oyster.py:7-158): per-frame boxes, track, per-track
    corner-aligned size from the top-5% nearest observations, drop short
    tracks.

Sequence protocol: a list of frame dicts {"points" (N, 3+) sensor frame,
"pose" (4, 4) sensor->world, optional "ppscore" (N,)}.

Every generator clusters on ``device`` (default: the CUDA card, kernel R2;
``"cpu"`` for its plain version). With a ``timer`` (a
``utils.common.PhaseTimer``) each stage adds its host seconds to it.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from .ground import GroundSegmenter, remove_ground_banded
from .outline import (
    box_fit, box_fit_DGD, clustering, corner_align, drop_cls, fit_gated_box,
    get_box_cls, voxel_sampling, box_rigid_transform, points_rigid_transform,
)
from .tracker import TrackSmooth
from ..utils.common import timed


def _world_points(frame):
    return points_rigid_transform(np.asarray(frame["points"], np.float64), frame["pose"])


def _frame_result(boxes, names, ids=None, scores=None):
    n = len(boxes)
    return {
        "outline_box": np.asarray(boxes, np.float32).reshape(n, 7),
        "outline_cls": np.asarray(names).reshape(n),
        "outline_ids": (np.asarray(ids, np.int64).reshape(n) if ids is not None
                        else np.arange(n, dtype=np.int64)),
        "outline_score": (np.asarray(scores, np.float32).reshape(n) if scores is not None
                          else np.ones(n, np.float32)),
    }


class DBSCANGenerator:
    """Single-frame clustering baseline (dbscan.py)."""

    def __init__(self, eps: float = 0.7, min_samples: int = 10, device=None, timer=None, **kw):
        self.eps = eps
        self.min_samples = min_samples
        self.ground = GroundSegmenter()
        self.device = device
        self.timer = timer

    def __call__(self, frames: List[dict]) -> Dict[int, dict]:
        out = {}
        for f, frame in enumerate(frames):
            pts = np.asarray(frame["points"], np.float64)
            with timed(self.timer, "ground"):
                non_ground = remove_ground_banded(pts, self.ground)
            # DBSCAN core size fixed at 10 (outline_utils.py:532);
            # cluster_min_points filters clusters afterwards
            with timed(self.timer, "cluster"):
                clusters = clustering(non_ground, self.eps, 10,
                                      min_points=self.min_samples, device=self.device)
            boxes, names = [], []
            with timed(self.timer, "fit"):
                for c in clusters:
                    fitted = fit_gated_box(c)  # reference box_fit gates (dbscan.py)
                    if fitted is None:
                        continue
                    b, _ = fitted
                    boxes.append(b)
                    names.append(get_box_cls(b, len(c)))
            boxes = np.asarray(boxes, np.float32).reshape(-1, 7)
            names = np.asarray(names)
            keep = drop_cls(names)
            out[f] = _frame_result(boxes[keep], names[keep])
        return out


class MFCFGenerator:
    """Multi-frame clustering & fitting + whole-sequence track smoothing (mfcf.py)."""

    def __init__(self, window: int = 5, ppscore_thresh: float = 0.7,
                 eps: float = 0.7, min_samples: int = 10, voxel: float = 0.1,
                 tracker_kw: Optional[dict] = None, min_track_len: int = 2,
                 interval: int = 1, min_points: Optional[int] = None,
                 gate_kw: Optional[dict] = None, device=None, timer=None):
        self.window = window
        self.ppscore_thresh = ppscore_thresh
        self.eps = eps
        # DBSCAN core size (the reference fixes 10 regardless of config;
        # outline_utils.py:532); cluster_min_points filters AFTER clustering
        self.min_samples = min_samples
        self.min_points = min_samples if min_points is None else min_points
        self.voxel = voxel
        self.tracker_kw = tracker_kw or {}
        self.min_track_len = min_track_len
        self.interval = interval
        self.gate_kw = gate_kw or {}
        self.ground = GroundSegmenter()
        # distance-banded min-height gating params (remove_ground_banded);
        # defaults = OutlineFitter's (threaded from GeneratorConfig)
        self.ground_kw = {}
        self.device = device
        self.timer = timer

    def _gather_points(self, frames, f):
        """Multi-frame concat registered into the CURRENT sensor frame: keep
        the PERSISTENT (PPScore > thresh) points of the window -- these
        densify static structure without smearing movers -- plus ALL raw
        points of the current frame (mfcf.py:47-73; the reference window is
        range(i - win, i + win, interval), EXCLUSIVE of i + win)."""
        inv_pose = np.linalg.inv(np.asarray(frames[f]["pose"], np.float64))
        chunks = []
        for g in range(f - self.window, f + self.window, self.interval):
            if g < 0 or g >= len(frames):
                continue
            world = _world_points(frames[g])[:, :3]
            local = points_rigid_transform(world, inv_pose)
            pp = frames[g].get("ppscore")
            if pp is not None:
                local = local[np.asarray(pp) > self.ppscore_thresh]
            chunks.append(local)
        chunks.append(np.asarray(frames[f]["points"], np.float64)[:, :3])
        return np.concatenate(chunks, axis=0)

    def __call__(self, frames: List[dict]) -> Dict[int, dict]:
        frame_boxes, frame_scores = [], []
        for f in range(len(frames)):
            with timed(self.timer, "gather"):
                pts = self._gather_points(frames, f)
            with timed(self.timer, "voxel_sampling"):
                pts = voxel_sampling(pts, self.voxel)
            with timed(self.timer, "ground"):
                non_ground = remove_ground_banded(pts, self.ground, **self.ground_kw)
            with timed(self.timer, "cluster"):
                clusters = clustering(non_ground, self.eps, self.min_samples,
                                      min_points=self.min_points, device=self.device)
            with timed(self.timer, "fit"):
                fits = [(box_fit_DGD(c, **self.gate_kw), c) for c in clusters]
            fits = [(b, c) for b, c in fits if b is not None]
            boxes = np.asarray([b for b, _ in fits], np.float32).reshape(-1, 7)
            scores = np.asarray([min(len(c) / 100.0, 1.0) for _, c in fits],
                                np.float32)
            frame_boxes.append(boxes)
            frame_scores.append(scores)
        with timed(self.timer, "track"):
            smoother = TrackSmooth(self.tracker_kw, self.min_track_len)
            smoother.tracking(frame_boxes, frame_scores, [fr["pose"] for fr in frames])
        out = {}
        for f in range(len(frames)):
            boxes, names, ids, scores = smoother.get_current_frame_objects_and_cls(f)
            keep = drop_cls(names)
            out[f] = _frame_result(boxes[keep], names[keep], ids[keep], scores[keep])
        return out


class OYSTERGenerator:
    """OYSTER-style init labels: track + corner-aligned near-observation sizes
    (oyster.py): per track, take the sizes of the nearest 5% observations and
    re-align every frame's box to its sensor-nearest corner; drop short tracks."""

    def __init__(self, eps: float = 0.7, min_samples: int = 10,
                 min_track_len: int = 6, tracker_kw: Optional[dict] = None, device=None,
                 timer=None):
        self.eps = eps
        self.min_samples = min_samples
        self.min_track_len = min_track_len
        self.tracker_kw = tracker_kw or {}
        self.ground = GroundSegmenter()
        self.device = device
        self.timer = timer

    def __call__(self, frames: List[dict], init_labels: Optional[Dict[int, dict]] = None):
        frame_boxes, frame_scores = [], []
        if init_labels is not None:  # reuse MFCF output (oyster.py:29-45)
            for f in range(len(frames)):
                r = init_labels[f]
                frame_boxes.append(r["outline_box"].astype(np.float64))
                frame_scores.append(r["outline_score"])
        else:
            for f, frame in enumerate(frames):
                pts = np.asarray(frame["points"], np.float64)
                with timed(self.timer, "ground"):
                    non_ground = remove_ground_banded(pts, self.ground)
                with timed(self.timer, "cluster"):
                    clusters = clustering(non_ground, self.eps, 10,
                                          min_points=self.min_samples, device=self.device)
                with timed(self.timer, "fit"):
                    fits = [(fit_gated_box(c), c) for c in clusters]
                fits = [(b[0], c) for b, c in fits if b is not None]
                boxes = np.asarray([b for b, _ in fits], np.float32).reshape(-1, 7)
                frame_boxes.append(boxes.astype(np.float64))
                frame_scores.append(np.asarray(
                    [min(len(c) / 100.0, 1.0) for _, c in fits]))
        with timed(self.timer, "track"):
            smoother = TrackSmooth(self.tracker_kw, self.min_track_len)
            smoother.tracking(frame_boxes, frame_scores, [fr["pose"] for fr in frames])
        # per-track size: mean of the closest-5%-to-sensor observations,
        # corner-aligned back into every frame
        for tid, t in smoother.tracks.items():
            obs_frames = [f for f in t.boxes if t.observed.get(f, False)]
            if not obs_frames:
                continue
            world_boxes = {f: t.boxes[f] for f in obs_frames}
            # distance to sensor measured in the frame's sensor coords
            dists = {}
            for f in obs_frames:
                inv = np.linalg.inv(frames[f]["pose"])
                local = box_rigid_transform(world_boxes[f][None, :7], inv)[0]
                dists[f] = np.hypot(local[0], local[1])
            order = sorted(obs_frames, key=lambda f: dists[f])
            top = order[: max(len(order) // 20, 1)]
            lwh = np.mean([world_boxes[f][3:6] for f in top], axis=0)
            for f in t.boxes:
                inv = np.linalg.inv(frames[f]["pose"])
                local = box_rigid_transform(t.boxes[f][None, :7], inv)[0]
                aligned = corner_align(local, lwh[0], lwh[1])
                aligned[5] = lwh[2]
                t.boxes[f] = box_rigid_transform(aligned[None], frames[f]["pose"])[0]
        out = {}
        for f in range(len(frames)):
            boxes, names, ids, scores = smoother.get_current_frame_objects_and_cls(f)
            keep = drop_cls(names)
            out[f] = _frame_result(boxes[keep], names[keep], ids[keep], scores[keep])
        return out
