"""3D Kalman multi-object tracker for label smoothing (port of
cpd_tpu/unsupervised/tracker.py, the same NumPy).

Parity with cpd/unsupervised_core/tracker/ (Tracker3D tracker.py:5, Trajectory
trajectory.py:4, greedy association :170, cost map :100, filtering :384):
per-object constant-acceleration Kalman filter over
state [x y z vx vy vz ax ay az l w h yaw], greedy nearest-cost association
(center distance + size + angle terms, weighted by prediction confidence),
death after ``max_prediction_num`` missed frames, and a global smoothing pass
(gap interpolation, distance-softmax size averaging, yaw residual smoothing).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np


class KalmanBox:
    """CA Kalman filter on [x y z vx vy vz ax ay az]; sizes/yaw kept separately."""

    DIM = 9

    def __init__(self, box, score: float, dt: float = 1.0,
                 state_cov: float = 100.0, measure_cov: float = 0.001):
        self.x = np.zeros(self.DIM)
        self.x[:3] = box[:3]
        f = np.eye(self.DIM)
        for i in range(3):
            f[i, i + 3] = dt
            f[i, i + 6] = 0.5 * dt * dt
            f[i + 3, i + 6] = dt
        self.F = f
        self.H = np.zeros((3, self.DIM))
        self.H[:3, :3] = np.eye(3)
        self.P = np.eye(self.DIM) * state_cov
        self.Q = np.eye(self.DIM) * 0.01
        self.R = np.eye(3) * measure_cov

    def predict(self):
        self.x = self.F @ self.x
        self.P = self.F @ self.P @ self.F.T + self.Q
        return self.x[:3]

    def update(self, z):
        y = z - self.H @ self.x
        s = self.H @ self.P @ self.H.T + self.R
        k = self.P @ self.H.T @ np.linalg.inv(s)
        self.x = self.x + k @ y
        self.P = (np.eye(self.DIM) - k @ self.H) @ self.P


class Trajectory:
    """One track: KF + per-frame box/score records + smoothing."""

    def __init__(self, track_id: int, frame: int, box, score: float,
                 score_decay: float = 0.15, **kf_kw):
        self.id = track_id
        self.kf = KalmanBox(box, score, **kf_kw)
        self.boxes: Dict[int, np.ndarray] = {frame: np.asarray(box, np.float64).copy()}
        self.scores: Dict[int, float] = {frame: float(score)}
        self.observed: Dict[int, bool] = {frame: True}
        self.last_frame = frame
        self.first_frame = frame
        self.prediction_score = float(score)
        self.score_decay = score_decay
        self.misses = 0

    def predict(self, frame: int):
        center = self.kf.predict()
        last = self.boxes[self.last_frame]
        pred = last.copy()
        pred[:3] = center
        self.prediction_score *= 1.0 - self.score_decay
        return pred

    def update(self, frame: int, box, score: float):
        self.kf.update(np.asarray(box[:3], np.float64))
        stored = np.asarray(box, np.float64).copy()
        # labels carry the KF POSTERIOR center, not the raw measurement
        # (outline_utils.py:1057 emits ob.updated_state) -- for movers the
        # posterior lags the measurement until the velocity state converges
        stored[:3] = self.kf.x[:3]
        self.boxes[frame] = stored
        self.scores[frame] = float(score)
        self.observed[frame] = True
        self.last_frame = frame
        self.prediction_score = max(self.prediction_score, float(score))
        self.misses = 0

    def mark_missed(self, frame: int, pred_box):
        self.boxes[frame] = np.asarray(pred_box, np.float64).copy()
        self.scores[frame] = self.prediction_score
        self.observed[frame] = False
        self.misses += 1

    # -- smoothing (trajectory.py:384 'filtering') -----------------------
    def filtering(self, size_window: int = 10):
        frames = sorted(f for f in self.boxes if self.observed.get(f, False))
        if not frames:
            return
        # 1. gap interpolation between observed frames
        for a, b in zip(frames[:-1], frames[1:]):
            if b - a > 1:
                for f in range(a + 1, b):
                    t = (f - a) / (b - a)
                    box = (1 - t) * self.boxes[a] + t * self.boxes[b]
                    # yaw: shortest-path interpolation
                    dyaw = np.arctan2(np.sin(self.boxes[b][6] - self.boxes[a][6]),
                                      np.cos(self.boxes[b][6] - self.boxes[a][6]))
                    box[6] = self.boxes[a][6] + t * dyaw
                    self.boxes[f] = box
                    self.observed[f] = False
        # 2. size smoothing: distance-softmax weighted mean of observed sizes
        obs = np.array([self.boxes[f] for f in frames])
        dists = np.linalg.norm(obs[:, :2], axis=1)
        w = np.exp(-dists / 20.0)
        w = w / w.sum()
        lwh = (obs[:, 3:6] * w[:, None]).sum(0)
        # 3. yaw smoothing: remove high-frequency residuals around the median
        yaws = obs[:, 6]
        ref = np.arctan2(np.median(np.sin(yaws)), np.median(np.cos(yaws)))
        res = np.arctan2(np.sin(yaws - ref), np.cos(yaws - ref))
        keep_res = np.clip(res, -np.deg2rad(20), np.deg2rad(20))
        smooth_yaw = ref + keep_res
        for i, f in enumerate(frames):
            self.boxes[f][3:6] = lwh
            self.boxes[f][6] = smooth_yaw[i]
        for f in self.boxes:
            if f not in frames:
                self.boxes[f][3:6] = lwh

    def motion_statistics(self):
        """(std of centers, mean speed) over observed frames -- static/dynamic."""
        frames = sorted(f for f in self.boxes if self.observed.get(f, False))
        if len(frames) < 2:
            return 0.0, 0.0
        centers = np.array([self.boxes[f][:3] for f in frames])
        std = float(np.linalg.norm(centers.std(axis=0)[:2]))
        steps = np.diff(centers[:, :2], axis=0)
        dt = np.diff(frames)
        speed = float(np.mean(np.linalg.norm(steps, axis=1) / np.maximum(dt, 1)))
        return std, speed


class Tracker3D:
    """Greedy-association KF tracker (tracker.py:5)."""

    def __init__(self, score_decay: float = 0.15, max_misses: int = 12,
                 match_dist: float = 3.0, size_weight: float = 0.1,
                 angle_weight: float = 1.0, **kf_kw):
        self.tracks: List[Trajectory] = []
        self.next_id = 0
        self.score_decay = score_decay
        self.max_misses = max_misses
        self.match_dist = match_dist
        self.size_weight = size_weight
        self.angle_weight = angle_weight
        self.kf_kw = kf_kw
        self.dead: List[Trajectory] = []

    def _cost(self, preds, track_scores, boxes):
        """(T, N) association cost (tracker.py:100)."""
        c = np.linalg.norm(preds[:, None, :2] - boxes[None, :, :2], axis=-1)
        size = np.abs(preds[:, None, 3:6] - boxes[None, :, 3:6]).sum(-1)
        dyaw = preds[:, None, 6] - boxes[None, :, 6]
        ang = np.abs(np.arctan2(np.sin(dyaw), np.cos(dyaw)))
        cost = c + self.size_weight * size + self.angle_weight * ang
        return cost / np.clip(track_scores[:, None], 0.1, None)

    def step(self, frame: int, boxes: np.ndarray, scores: np.ndarray) -> np.ndarray:
        """Associate one frame; returns (N,) track ids (new tracks spawned)."""
        boxes = np.asarray(boxes, np.float64).reshape(-1, 7)
        ids = np.full(len(boxes), -1, np.int64)
        preds = np.array([t.predict(frame) for t in self.tracks]).reshape(-1, 7)
        if len(self.tracks) and len(boxes):
            tscores = np.array([t.prediction_score for t in self.tracks])
            cost = self._cost(preds, tscores, boxes)
            # greedy: repeatedly take the global min (tracker.py:170)
            cost = cost.copy()
            while True:
                ti, bi = np.unravel_index(np.argmin(cost), cost.shape)
                if not np.isfinite(cost[ti, bi]) or cost[ti, bi] > self.match_dist:
                    break
                self.tracks[ti].update(frame, boxes[bi], float(scores[bi]))
                ids[bi] = self.tracks[ti].id
                cost[ti, :] = np.inf
                cost[:, bi] = np.inf
        # unmatched tracks: miss
        survivors = []
        for ti, t in enumerate(self.tracks):
            if t.last_frame != frame:
                t.mark_missed(frame, preds[ti])
                if t.misses > self.max_misses:
                    self.dead.append(t)
                    continue
            survivors.append(t)
        self.tracks = survivors
        # unmatched boxes: new tracks
        for bi in np.where(ids < 0)[0]:
            t = Trajectory(self.next_id, frame, boxes[bi], float(scores[bi]),
                           self.score_decay, **self.kf_kw)
            self.tracks.append(t)
            ids[bi] = t.id
            self.next_id += 1
        return ids

    def all_tracks(self) -> List[Trajectory]:
        return self.dead + self.tracks

    def post_processing(self, min_length: int = 2) -> Dict[int, Trajectory]:
        """Smooth every track; drop too-short ones (tracker.py:246)."""
        out = {}
        for t in self.all_tracks():
            n_obs = sum(t.observed.values())
            if n_obs < min_length:
                continue
            t.filtering()
            out[t.id] = t
        return out


class TrackSmooth:
    """Whole-sequence tracking + per-frame re-emission (outline_utils.py:968).

    Feed per-frame WORLD-frame boxes; after tracking, query the smoothed,
    track-consistent boxes + size classification per frame.
    """

    def __init__(self, tracker_kw: Optional[dict] = None, min_track_len: int = 2):
        self.tracker = Tracker3D(**(tracker_kw or {}))
        self.min_track_len = min_track_len
        self.frame_ids: Dict[int, np.ndarray] = {}
        self.poses: List[Optional[np.ndarray]] = []

    def tracking(self, frame_boxes: List[np.ndarray], frame_scores: List[np.ndarray],
                 poses: Optional[List[np.ndarray]] = None):
        """Boxes are SENSOR-frame when ``poses`` (sensor->world 4x4) are given
        (the reference protocol, tracker registers into world via box_op.register_bbs)."""
        from .outline import box_rigid_transform

        self.poses = poses if poses is not None else [None] * len(frame_boxes)
        for f, (b, s) in enumerate(zip(frame_boxes, frame_scores)):
            b = np.asarray(b, np.float64).reshape(-1, 7)
            if self.poses[f] is not None and len(b):
                b = box_rigid_transform(b, self.poses[f])
            self.frame_ids[f] = self.tracker.step(f, b, s)
        self.tracks = self.tracker.post_processing(self.min_track_len)

    def get_current_frame_objects_and_cls(self, frame: int):
        """(boxes (N, 7) SENSOR frame, names, ids, scores) for one frame
        (outline_utils.py:1030: re-registers world tracks into the frame pose)."""
        from .outline import box_rigid_transform, get_box_cls

        boxes, names, ids, scores = [], [], [], []
        inv = (np.linalg.inv(self.poses[frame])
               if frame < len(self.poses) and self.poses[frame] is not None else None)
        for tid, t in self.tracks.items():
            # only frames inside the OBSERVED span are emitted: the reference
            # fills updated_state solely for first<=f<=last gap frames
            # (trajectory.py:446-448); head/tail KF predictions stay None and
            # never become labels
            obs = [f for f in t.boxes if t.observed.get(f, False)]
            if not obs or not (min(obs) <= frame <= max(obs)):
                continue
            if frame in t.boxes:
                b = t.boxes[frame]
                if inv is not None:
                    b = box_rigid_transform(b[None, :7], inv)[0]
                boxes.append(b)
                names.append(get_box_cls(b))
                ids.append(tid)
                scores.append(t.scores.get(frame, 0.1))
        if not boxes:
            return (np.zeros((0, 7)), np.zeros((0,), dtype="U16"),
                    np.zeros((0,), np.int64), np.zeros((0,)))
        return (np.stack(boxes), np.asarray(names), np.asarray(ids),
                np.asarray(scores))
