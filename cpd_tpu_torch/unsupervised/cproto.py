"""CSS scoring + Commonsense Prototype (CProto) label refinement (port of
cpd_tpu/unsupervised/cproto.py, the same NumPy).

Parity with cpd/unsupervised_core/c_proto_refine.py:
  - CSS (:13): per-box confidence = mean(distance score, hierarchical
    occupancy (MLO parts 9/7/5), KL size score vs the class prior).
  - C_PROTO (:46), four sequential passes over a sequence:
      1. compute_css_score_and_raw_proto (:65): re-estimate box z/h from the
         smoothed low points, CSS per box, per-track registered point banks
         above BasicProtoScoreThresh.
      2. construct_prototypes (:207): static tracks (center std <= StaticThresh)
         -> multi-frame registered bank + mean size w/ circular-mean yaw;
         dynamic -> best-CSS frame bank; keep the top-K per class as
         high-quality (HQ) prototypes.
      3. refine_box_size (:332): Vehicle sizes from the own-track prototype,
         else the nearest-height HQ prototype, else the class prior;
         orientation + density-guided drift re-fit when CSS > OrienThresh.
      4. refine_box_pos (:477): static tracks snap every frame to the
         best-CSS box (world-frame constant); dynamic tracks take the best
         size and a motion-direction yaw from +-K-frame displacement.

Output per frame: outline_box / outline_cls / outline_ids / outline_score /
outline_proto_id, plus the prototype point banks ({proto_id: (N, 3)}), the
exact fields the dataset's ``sample_prototype_cpu`` consumes
(waymo_unsupervised_dataset.py:205-331).

Pass 3 re-clusters on ``device`` (default: the CUDA card, kernel R2; ``"cpu"``
for its plain version). With a ``timer`` (a ``utils.common.PhaseTimer``) each
pass adds its host seconds to it.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from .outline import (
    PREDEFINED_SIZE, KL_entropy_score, box_rigid_transform, correct_orientation,
    density_guided_drift, distance_score, hierarchical_occupancy_score, smooth_points,
    voxel_sampling,
)
from ..datasets.box_np import points_in_box_np
from ..utils.common import timed


def box_frame_transform(points: np.ndarray, box: np.ndarray) -> np.ndarray:
    """World/sensor points -> box-canonical frame (center origin, yaw 0)."""
    rel = points[:, :3] - box[:3]
    c, s = np.cos(-box[6]), np.sin(-box[6])
    out = rel.copy()
    out[:, 0] = rel[:, 0] * c - rel[:, 1] * s
    out[:, 1] = rel[:, 0] * s + rel[:, 1] * c
    return out


def box_frame_inverse(points: np.ndarray, box: np.ndarray) -> np.ndarray:
    """Box-canonical points -> the frame of ``box``."""
    c, s = np.cos(box[6]), np.sin(box[6])
    out = points.copy()
    out[:, 0] = points[:, 0] * c - points[:, 1] * s + box[0]
    out[:, 1] = points[:, 0] * s + points[:, 1] * c + box[1]
    out[:, 2] = points[:, 2] + box[2]
    return out


class CSS:
    """Commonsense confidence score (c_proto_refine.py:13-41)."""

    def __init__(self, mlo_parts=(9, 7, 5), max_dist: float = 80.0,
                 predefined_size: Optional[dict] = None,
                 weights=(1.0, 1.0, 1.0)):
        self.mlo_parts = tuple(mlo_parts)
        self.max_dist = max_dist
        self.sizes = predefined_size or PREDEFINED_SIZE
        self.weights = np.asarray(weights, np.float64)

    def __call__(self, points: np.ndarray, box: np.ndarray, cls: str) -> float:
        """Reference formula (c_proto_refine.py:20-41): CSS_weight-weighted
        mean of 3D-distance score, MLO occupancy, and the KL size score of
        the NORMALIZED (l, w, h) against the normalized class prior."""
        d = distance_score(box, self.max_dist)
        occ = hierarchical_occupancy_score(points, box, self.mlo_parts)
        prior = self.sizes.get(cls)
        if prior is not None:
            size_n = np.asarray(box[3:6], np.float64)
            size_n = size_n / size_n.sum()
            prior_n = np.asarray(prior, np.float64)
            prior_n = prior_n / prior_n.sum()
            kl = KL_entropy_score(size_n, prior_n)
        else:
            kl = 0.5
        w = self.weights / self.weights.sum()
        return float(d * w[0] + occ * w[1] + kl * w[2])


class CProtoRefiner:
    """The 4-pass CProto refiner (c_proto_refine.py:46-682)."""

    def __init__(self, css: Optional[CSS] = None,
                 basic_proto_thresh=0.5,
                 high_quality_num=40,
                 static_thresh: float = 0.5,
                 orien_thresh: float = 0.6,
                 motion_window: int = 10,
                 min_proto_points: int = 50,
                 apply_dynamic_pos: bool = False,
                 cluster_eps: float = 0.5,
                 cluster_min_points: int = 5,
                 ground_min_threshold=(-0.5, -1.0, -1.5),
                 ground_min_distance=(0.0, 20.0, 40.0, 100.0),
                 ground_max_threshold: float = 1.0, device=None, timer=None):
        self.css = css or CSS()
        self.device = device
        self.timer = timer
        # per-class dicts accepted (reference cfg BasicProtoScoreThresh /
        # HighQualityProtoNum are {'Vehicle':..,'Pedestrian':..,'Cyclist':..})
        self.basic_proto_thresh = basic_proto_thresh
        self.high_quality_num = high_quality_num
        self.static_thresh = static_thresh
        self.orien_thresh = orien_thresh
        self.motion_window = motion_window
        self.min_proto_points = min_proto_points
        self.apply_dynamic_pos = apply_dynamic_pos
        # refine_box_size re-clusters with the reference C_PROTO's own
        # OutlineFitter params (c_proto_refine.py:52-61: GroundMin as the
        # banded min-thresholds + the GeneratorConfig clustering values)
        self.cluster_eps = cluster_eps
        self.cluster_min_points = cluster_min_points
        self.ground_min_threshold = tuple(ground_min_threshold)
        self.ground_min_distance = tuple(ground_min_distance)
        self.ground_max_threshold = float(ground_max_threshold)

    def _cls_param(self, param, cls, default):
        if isinstance(param, dict):
            return param.get(cls, default)
        return param

    # -- pass 1 ----------------------------------------------------------
    def compute_css_and_banks(self, frames, labels):
        """Per frame/box: refreshed z/h, CSS, per-track canonical point banks."""
        track_banks: Dict[int, list] = {}
        track_entries: Dict[int, list] = {}  # (frame, idx, css, box(world), cls)
        for f, frame in enumerate(frames):
            pts = np.asarray(frame["points"], np.float64)
            lab = labels[f]
            boxes = lab["outline_box"].astype(np.float64)
            css_scores = np.zeros(len(boxes), np.float32)
            for i, box in enumerate(boxes):
                grab = box.copy()
                grab[3:6] += 0.4  # slightly enlarged collection region
                inb = points_in_box_np(pts, grab)
                obj = pts[inb]
                if len(obj) >= 5:
                    low = np.percentile(obj[:, 2], 2)
                    high = np.percentile(obj[:, 2], 98)
                    box[5] = max(high - low, 0.3)
                    box[2] = (high + low) / 2.0
                    boxes[i] = box
                css_scores[i] = self.css(obj, box, str(lab["outline_cls"][i]))
                tid = int(lab["outline_ids"][i])
                world_box = box_rigid_transform(box[None], frame["pose"])[0]
                track_entries.setdefault(tid, []).append(
                    (f, i, float(css_scores[i]), world_box, str(lab["outline_cls"][i]))
                )
                thr = self._cls_param(self.basic_proto_thresh, str(lab["outline_cls"][i]), 0.5)
                if css_scores[i] > thr and len(obj) >= 10:
                    canon = box_frame_transform(obj, box)
                    track_banks.setdefault(tid, []).append((f, float(css_scores[i]), canon))
            lab["outline_box"] = boxes.astype(np.float32)
            lab["outline_score"] = css_scores
        return track_entries, track_banks

    # -- pass 2 ----------------------------------------------------------
    def construct_prototypes(self, track_entries, track_banks):
        """Per-track prototype (point bank + size); HQ top-K per class."""
        protos: Dict[int, dict] = {}
        for tid, entries in track_entries.items():
            boxes = np.stack([e[3] for e in entries])
            css = np.array([e[2] for e in entries])
            cls = entries[int(np.argmax(css))][4]
            centers = boxes[:, :2]
            static = float(np.linalg.norm(centers.std(axis=0))) <= self.static_thresh
            banks = track_banks.get(tid, [])
            if banks:
                if static and len(banks) > 1:
                    bank = np.concatenate([b[2] for b in banks], axis=0)
                else:
                    best = max(banks, key=lambda b: b[1])
                    bank = best[2]
                bank = voxel_sampling(smooth_points(bank), 0.05)
            else:
                bank = np.zeros((0, 3))
            # mean size; circular-mean yaw of observed boxes
            lwh = boxes[:, 3:6].mean(axis=0)
            yaw = np.arctan2(np.sin(boxes[:, 6]).mean(), np.cos(boxes[:, 6]).mean())
            protos[tid] = {
                "cls": cls,
                "static": static,
                "size": lwh,
                "yaw": float(yaw),
                "points": bank,
                "css": float(css.max()),
                "n_obs": len(entries),
            }
        # HQ selection per class
        hq: Dict[str, list] = {}
        for tid, p in protos.items():
            if len(p["points"]) >= self.min_proto_points:
                hq.setdefault(p["cls"], []).append((p["css"], tid))
        hq_ids = {
            c: [tid for _, tid in sorted(v, reverse=True)[: self._cls_param(self.high_quality_num, c, 40)]]
            for c, v in hq.items()
        }
        return protos, hq_ids

    # -- pass 3 ----------------------------------------------------------
    def refine_box_size(self, frames, labels, protos, hq_ids):
        """Pass 3, the reference's exact algorithm (c_proto_refine.py:332-477):
        per box, gather raw frame points within a CYLINDER of radius
        max(l, w), smooth them, recompute z/h from the smoothed floor
        (h >= 1.3); Vehicles take the track prototype's l/w (else the
        nearest-height high-quality prototype's, else the predefined size) --
        other classes keep their own l/w; then the floor-trimmed, ground-
        removed largest cluster re-scores CSS and, for Vehicles, re-orients
        (when CSS > OrienThresh) and ALWAYS density-drifts the center. A
        frame's boxes go in three passes: every box's ground-removed cloud,
        one DBSCAN call for all of them (``clustering_batched``), then each
        box's scoring and corrections; a box's result depends on its own
        cloud alone, as in the reference's one loop."""
        from .ground import GroundSegmenter, remove_ground_banded
        from .outline import clustering_batched, smooth_points

        segmenter = GroundSegmenter()
        for f, frame in enumerate(frames):
            pts = np.asarray(frame["points"], np.float64)[:, :3]
            lab = labels[f]
            boxes = lab["outline_box"].astype(np.float64)
            scores = np.asarray(lab["outline_score"], np.float32).copy()
            todo = []  # (row, class, the box so far, its ground-removed cloud or None)
            for i, box in enumerate(boxes):
                cls = str(lab["outline_cls"][i])
                tid = int(lab["outline_ids"][i])
                if cls not in ("Vehicle", "Pedestrian", "Cyclist"):
                    continue
                dis = np.linalg.norm(pts[:, :2] - box[:2], axis=1)
                low = pts[dis < max(box[3], box[4])]
                if len(low):
                    low = smooth_points(low)
                z_min = low[:, 2].min() if len(low) else box[2] - box[5] / 2.0
                z_max = box[2] + box[5] / 2.0
                h = max(z_max - z_min, 1.3)
                z = h / 2.0 + z_min
                p = protos.get(tid)
                if p is not None and len(p["points"]) >= self.min_proto_points:
                    size_lw = p["size"][:2]
                elif cls in hq_ids and hq_ids[cls]:
                    cands = [protos[t] for t in hq_ids[cls]]
                    best = min(cands, key=lambda q: abs(q["size"][2] - h))
                    size_lw = best["size"][:2]
                else:
                    size_lw = PREDEFINED_SIZE.get(cls, (box[3], box[4]))[:2]
                if cls == "Vehicle":
                    new_box = np.array([box[0], box[1], z, size_lw[0],
                                        size_lw[1], h, box[6]])
                else:
                    new_box = np.array([box[0], box[1], z, box[3], box[4], h,
                                        box[6]])
                ng = None
                if len(low):
                    m = (low[:, 2] > z_min + 0.2) & (low[:, 2] < z_max)
                    trimmed = low[m]
                    ng = (remove_ground_banded(
                        trimmed, segmenter,
                        max_threshold=self.ground_max_threshold,
                        min_threshold=self.ground_min_threshold,
                        min_distance=self.ground_min_distance)
                        if len(trimmed) else trimmed)
                todo.append((i, cls, new_box, ng if ng is not None and len(ng) > 10 else None))
            clustered = [t for t in todo if t[3] is not None]
            found = clustering_batched([t[3] for t in clustered], self.cluster_eps, 10,
                                       min_points=self.cluster_min_points, device=self.device)
            clusters_of = {t[0]: c for t, c in zip(clustered, found)}
            for i, cls, new_box, _ in todo:
                clusters = clusters_of.get(i)
                if clusters:
                    mc = max(clusters, key=len)
                    scores[i] = self.css(mc, new_box, cls)
                    if cls == "Vehicle":
                        if scores[i] > self.orien_thresh:
                            new_box = correct_orientation(new_box, mc)
                        new_box = density_guided_drift(new_box, mc)
                boxes[i] = new_box
            lab["outline_box"] = boxes.astype(np.float32)
            lab["outline_score"] = scores
        return labels

    # -- pass 4 ----------------------------------------------------------
    def refine_box_pos(self, frames, labels, track_entries, protos):
        # index: track -> {frame: row}
        by_track: Dict[int, Dict[int, int]] = {}
        for tid, entries in track_entries.items():
            by_track[tid] = {f: i for (f, i, _, _, _) in entries}
        for tid, frame_rows in by_track.items():
            p = protos.get(tid)
            if p is None:
                continue
            entries = track_entries[tid]
            css = np.array([e[2] for e in entries])
            best_i = int(np.argmax(css))
            if p["static"]:
                # snap every frame to the best box, constant in world frame
                best_f, best_row, _, best_world, _ = entries[best_i]
                best_local = labels[best_f]["outline_box"][best_row].astype(np.float64)
                best_world = box_rigid_transform(best_local[None], frames[best_f]["pose"])[0]
                for f, row in frame_rows.items():
                    inv = np.linalg.inv(np.asarray(frames[f]["pose"], np.float64))
                    labels[f]["outline_box"][row] = box_rigid_transform(
                        best_world[None], inv
                    )[0].astype(np.float32)
            elif self.apply_dynamic_pos:
                # dynamic: best size everywhere + motion-direction yaw.
                # The reference COMPUTES this (c_proto_refine.py:597-645,
                # new_pos_proto_dynamic) but its write-back loop (:645-672)
                # checks only new_pos_proto_static -- the dynamic refinement
                # is built and then dropped, so dynamic tracks keep their
                # refine_box_size boxes. Default False for parity; set True
                # to apply the (likely intended) dynamic branch.
                best_f, best_row, _, _, _ = entries[best_i]
                best_size = labels[best_f]["outline_box"][best_row][3:6]
                world_centers = {f: e[3][:3] for e, f in zip(entries, frame_rows)}
                frames_sorted = sorted(frame_rows)
                for f in frames_sorted:
                    row = frame_rows[f]
                    lo = max(f - self.motion_window, frames_sorted[0])
                    hi = min(f + self.motion_window, frames_sorted[-1])
                    fa = max((g for g in frames_sorted if g <= lo), default=f)
                    fb = min((g for g in frames_sorted if g >= hi), default=f)
                    box = labels[f]["outline_box"][row].astype(np.float64)
                    if fb > fa:
                        d = np.asarray(world_centers.get(fb)) - np.asarray(world_centers.get(fa))
                        if np.linalg.norm(d[:2]) > 1.0:
                            yaw_w = np.arctan2(d[1], d[0])
                            from .outline import get_registration_angle

                            yaw_local = yaw_w - get_registration_angle(
                                np.asarray(frames[f]["pose"], np.float64)
                            )
                            box[6] = yaw_local
                    box[3:6] = best_size
                    labels[f]["outline_box"][row] = box.astype(np.float32)
        return labels

    # -- driver ------------------------------------------------------------
    def __call__(self, frames: List[dict], labels: Dict[int, dict]):
        with timed(self.timer, "css_and_banks"):
            track_entries, track_banks = self.compute_css_and_banks(frames, labels)
        with timed(self.timer, "prototypes"):
            protos, hq_ids = self.construct_prototypes(track_entries, track_banks)
        with timed(self.timer, "refine_size"):
            labels = self.refine_box_size(frames, labels, protos, hq_ids)
        with timed(self.timer, "refine_pos"):
            labels = self.refine_box_pos(frames, labels, track_entries, protos)
        # attach proto ids (track id when a bank exists, else -1)
        for f in labels:
            ids = labels[f]["outline_ids"]
            proto_id = np.array(
                [tid if (tid in protos and len(protos[tid]["points"]) >= self.min_proto_points)
                 else -1 for tid in ids],
                np.int64,
            )
            labels[f]["outline_proto_id"] = proto_id
        proto_points = {
            tid: p["points"] for tid, p in protos.items()
            if len(p["points"]) >= self.min_proto_points
        }
        return labels, proto_points
