"""Waymo unsupervised dataset (port of the WaymoUnsupervisedDataset class of
cpd_tpu/datasets/waymo_unsupervised.py, the same NumPy).

Parity with cpd/datasets/waymo_unsupervised/waymo_unsupervised_dataset.py:
  - processed-sequence layout: <root>/<seq>/NNNN.npy (N, 6) [x y z intensity
    elongation NLZ], <seq>.pkl infos, <seq>_outline_<Refiner>.pkl labels,
    <seq>_outline_<Init>_CSS_proto.pkl banks
  - get_lidar (:137): drop NLZ-flagged points, tanh intensity
  - get_frame (:333): NUM_FRAMES pose-registered concat with time channel
  - sample_prototype (:205-331): per-box score gating
    (DiscardThreshMin/Max, r < 75, proto_id >= 0), CSS normalization, the
    good-object view (random 20%-keep scene dropout half the time) and the
    proto-completed view (prototype banks re-posed into each box + clean
    background)
  - generate_prediction_dicts (:504): LABEL_OFFSET z-shift for Vehicle, TTA
    backward
The dataset-building functions of the JAX module (create_waymo_infos, create_ppscore,
create_outline_boxes, create_track_groundtruth_database) run the pseudo-label
factory, which is not ported yet; neither is the official Waymo metric
(``evaluation.official_available`` is False), so ``evaluation`` scores with
``evaluation.waymo_style_eval``.
"""
from __future__ import annotations

import pickle
from pathlib import Path
from typing import Dict, List

import numpy as np

from .box_np import points_in_boxes_mask_fast
from .dataset import DatasetTemplate
from .registry import register_dataset
from ..unsupervised.cproto import box_frame_inverse
from ..unsupervised.ppscore import points_rigid_transform


@register_dataset("WaymoUnsupervisedDataset")
class WaymoUnsupervisedDataset(DatasetTemplate):
    def __init__(self, dataset_cfg=None, class_names=None, training=True,
                 root_path=None, logger=None, **kw):
        super().__init__(dataset_cfg=dataset_cfg, class_names=class_names,
                         training=training, root_path=root_path, logger=logger, **kw)
        cfg = self.dataset_cfg
        self.data_path = Path(root_path or cfg.get("DATA_PATH", ".")) / cfg.get(
            "PROCESSED_DATA_TAG", "waymo_processed_data")
        self.mode = "train" if training else "test"
        split_cfg = cfg.get("DATA_SPLIT", {"train": "train", "test": "val"})
        self.split = split_cfg[self.mode]
        self.num_frames = int(cfg.get("NUM_FRAMES", 1))
        self.label_offset = float(cfg.get("LABEL_OFFSET", 0.0))
        self.init_label_generator = cfg.get("InitLabelGenerator", "MFCF")
        self.label_refiner = cfg.get("LabelRefiner", "C_PROTO")
        interval_cfg = cfg.get("SAMPLED_INTERVAL", {"train": 1, "test": 1})
        self.sampled_interval = int(interval_cfg.get(self.mode, 1))
        self.infos: List[dict] = []
        self._proto_cache: Dict[str, dict] = {}
        self._label_cache: Dict[str, dict] = {}
        if self.data_path.exists():
            self.load_infos()

    # ------------------------------------------------------------------
    def sequence_list(self) -> List[str]:
        split_file = Path(self.root_path or ".") / "ImageSets" / f"{self.split}.txt"
        if split_file.exists():
            seqs = [x.strip().replace(".tfrecord", "") for x in split_file.read_text().splitlines() if x.strip()]
        else:
            seqs = sorted(p.name for p in self.data_path.iterdir() if p.is_dir())
        return seqs

    def load_infos(self):
        self.infos = []
        tag = self.label_refiner or self.init_label_generator
        for seq in self.sequence_list():
            seq_dir = self.data_path / seq
            pkl = seq_dir / f"{seq}.pkl"
            if not pkl.exists():
                continue
            with open(pkl, "rb") as f:
                seq_infos = pickle.load(f)
            labels = None
            lab_pkl = seq_dir / f"{seq}_outline_{tag}.pkl"
            if lab_pkl.exists():
                with open(lab_pkl, "rb") as f:
                    labels = pickle.load(f)
                self._label_cache[seq] = labels
            for i, info in enumerate(seq_infos):
                self.infos.append({"sequence_name": seq, "sample_idx": i, "info": info})
        self.infos = self.infos[:: self.sampled_interval]

    def __len__(self):
        return len(self.infos)

    # ------------------------------------------------------------------
    def get_lidar(self, sequence_name: str, sample_idx: int) -> np.ndarray:
        """(N, 5) [x y z tanh(intensity) elongation]; NLZ points dropped."""
        f = self.data_path / sequence_name / f"{sample_idx:04d}.npy"
        pts = np.load(f).astype(np.float32)
        if pts.shape[1] >= 6:
            pts = pts[pts[:, 5] == -1][:, :5]
        else:
            pts = pts[:, :5] if pts.shape[1] >= 5 else np.pad(pts, ((0, 0), (0, 5 - pts.shape[1])))
        pts[:, 3] = np.tanh(pts[:, 3])
        return pts

    def _get_labels(self, seq: str):
        if seq not in self._label_cache:
            tag = self.label_refiner or self.init_label_generator
            pkl = self.data_path / seq / f"{seq}_outline_{tag}.pkl"
            with open(pkl, "rb") as f:
                self._label_cache[seq] = pickle.load(f)
        return self._label_cache[seq]

    def _get_protos(self, seq: str):
        if seq not in self._proto_cache:
            pkl = self.data_path / seq / f"{seq}_outline_{self.init_label_generator}_CSS_proto.pkl"
            with open(pkl, "rb") as f:
                self._proto_cache[seq] = pickle.load(f)["proto_points_set"]
        return self._proto_cache[seq]

    def get_points_multiframe(self, seq: str, idx: int, poses: List[np.ndarray]):
        """NUM_FRAMES pose-registered concat with a time channel (get_frame :344)."""
        cur = self.get_lidar(seq, idx)
        cur = np.concatenate([cur[:, :4], np.zeros((len(cur), 1), np.float32)], axis=1)
        if self.num_frames <= 1:
            return cur
        chunks = [cur]
        cur_pose_inv = np.linalg.inv(poses[idx])
        for k in range(1, self.num_frames):
            j = idx - k
            if j < 0:
                break
            pts = self.get_lidar(seq, j)
            world = points_rigid_transform(pts, poses[j])
            local = points_rigid_transform(world, cur_pose_inv)
            t = np.full((len(local), 1), -0.1 * k, np.float32)
            chunks.append(np.concatenate([local[:, :4], t], axis=1))
        return np.concatenate(chunks, axis=0)

    # ------------------------------------------------------------------
    def sample_prototype(self, seq: str, points: np.ndarray, label: dict, rng):
        """Build (good-object view, proto-completed view, kept boxes/cls/css/pid).

        Mirrors sample_prototype_cpu (waymo_unsupervised_dataset.py:205-331).
        """
        ref_cfg = self.dataset_cfg.get("RefinerConfig", {})
        tmin = dict(ref_cfg.get("DiscardThreshMin", {"Vehicle": 0.5, "Pedestrian": 0.5, "Cyclist": 0.5}))
        tmax = dict(ref_cfg.get("DiscardThreshMax", {"Vehicle": 0.7, "Pedestrian": 0.55, "Cyclist": 0.55}))
        protos = self._get_protos(seq)
        boxes = np.asarray(label["outline_box"], np.float32).reshape(-1, 7)
        names = np.asarray(label["outline_cls"]).reshape(-1)
        scores = np.asarray(label["outline_score"], np.float32).reshape(-1)
        pids = np.asarray(label.get("outline_proto_id", np.full(len(boxes), -1)), np.int64).reshape(-1)

        in_box = points_in_boxes_mask_fast(points[:, :3], boxes)  # (M, N)
        keep_no_obj = ~in_box.any(axis=0) if len(boxes) else np.ones(len(points), bool)
        keep_good = np.ones(len(points), bool)
        new_boxes, new_names, new_scores, new_pids, proto_clouds = [], [], [], [], []
        for i, (box, name, score, pid) in enumerate(zip(boxes, names, scores, pids)):
            name = str(name)
            if name not in ("Vehicle", "Pedestrian", "Cyclist"):
                keep_good &= ~in_box[i]
                continue
            lo, hi = tmin.get(name, 0.5), tmax.get(name, 0.7)
            ok = (score > min(lo, hi)) and (np.hypot(box[0], box[1]) < 75) and pid >= 0
            bank = protos.get(name, {}).get(int(pid)) if ok else None
            if not ok or bank is None or len(bank["points"]) == 0:
                keep_good &= ~in_box[i]
                continue
            new_boxes.append(box)
            new_names.append(name)
            css = (np.clip(score, lo, hi) - lo) / max(hi - lo, 1e-6)
            new_scores.append(css)
            new_pids.append(pid)
            # re-pose the canonical prototype bank into this box
            cloud = box_frame_inverse(np.asarray(bank["points"], np.float32), box)
            full = np.zeros((len(cloud), points.shape[1]), np.float32)
            full[:, :3] = cloud[:, :3]
            proto_clouds.append(full)

        points_good = points[keep_good]
        points_proto = np.concatenate(proto_clouds + [points[keep_no_obj]], axis=0) \
            if proto_clouds else points[keep_no_obj]
        if rng.integers(2):  # random aggressive sparsification of the raw view
            sel = rng.permutation(len(points_good))[: int(len(points_good) * 0.2)]
            points_good = points_good[sel]
        return (points_good, points_proto,
                np.asarray(new_boxes, np.float32).reshape(-1, 7),
                np.asarray(new_names), np.asarray(new_scores, np.float32),
                np.asarray(new_pids, np.int64))

    # ------------------------------------------------------------------
    def __getitem__(self, index):
        rec = self.infos[index]
        seq, idx = rec["sequence_name"], rec["sample_idx"]
        info = rec["info"]
        labels = self._get_labels(seq)
        label = labels[idx]
        pts = self.get_points_multiframe(seq, idx, self._seq_poses(seq))
        rng = np.random.default_rng(np.random.SeedSequence((self.seed, self.epoch, index)))

        data = {"frame_id": f"{seq}#{idx:04d}", "sequence_name": seq, "sample_idx": index}
        if self.training and self.label_refiner in ("C_PROTO", "C_PROTO_SI"):
            good, proto, boxes, names, css, pids = self.sample_prototype(seq, pts, label, rng)
            data.update({
                "points": good, "points1": proto, "gt_boxes": boxes,
                "gt_names": names, "css_score": css, "proto_group_id": pids,
            })
        else:
            boxes = np.asarray(label["outline_box"], np.float32).reshape(-1, 7)
            names = np.asarray(label["outline_cls"]).reshape(-1)
            keep = np.array([str(n) in self.class_names for n in names], bool)
            data.update({
                "points": pts, "gt_boxes": boxes[keep], "gt_names": names[keep],
            })
        return self.prepare_data(data)

    def _seq_poses(self, seq: str) -> List[np.ndarray]:
        if not hasattr(self, "_pose_cache"):
            self._pose_cache = {}
        if seq not in self._pose_cache:
            with open(self.data_path / seq / f"{seq}.pkl", "rb") as f:
                infos = pickle.load(f)
            self._pose_cache[seq] = [np.asarray(i["pose"]) for i in infos]
        return self._pose_cache[seq]

    # ------------------------------------------------------------------
    def generate_prediction_dicts(self, batch, pred_dicts, class_names, output_path=None):
        """Device outputs -> per-frame annotation dicts (reference :504)."""
        out = []
        b = batch["batch_size"]
        boxes = np.asarray(pred_dicts["pred_boxes"])
        scores = np.asarray(pred_dicts["pred_scores"])
        labels = np.asarray(pred_dicts["pred_labels"])
        valid = np.asarray(pred_dicts["pred_valid"])
        for i in range(b):
            m = valid[i]
            bx = boxes[i][m].copy()
            lb = labels[i][m]
            names = np.asarray(class_names)[np.clip(lb - 1, 0, len(class_names) - 1)]
            # Vehicle z offset correction (reference :535-539)
            if self.label_offset:
                bx[names == "Vehicle", 2] += self.label_offset
            if self.test_augmentor is not None and len(bx):
                bx = self.test_augmentor.backward(bx)
            out.append({
                "frame_id": batch["frame_id"][i],
                "boxes_lidar": bx,
                "score": scores[i][m],
                "name": names,
                "pred_labels": lb,
            })
        return out

    def evaluation(self, det_annos, class_names, eval_metric="waymo", **kwargs):
        from ..evaluation import waymo_style_eval

        gt_annos = kwargs.get("gt_annos")
        if gt_annos is None:
            gt_annos = self.collect_gt_annos()
        # the JAX package switches to the official TF estimator where
        # waymo_open_dataset is installed; its adapter is not ported, so the
        # NumPy TYPE_HUNGARIAN implementation scores here
        return waymo_style_eval(det_annos, gt_annos, class_names)

    def collect_gt_annos(self):
        annos = []
        for rec in self.infos:
            info = rec["info"]
            ann = info.get("annos", {})
            annos.append({
                "frame_id": f"{rec['sequence_name']}#{rec['sample_idx']:04d}",
                "gt_boxes_lidar": np.asarray(ann.get("gt_boxes_lidar", np.zeros((0, 7)))),
                "name": np.asarray(ann.get("name", [])),
                "num_points_in_gt": np.asarray(ann.get("num_points_in_gt", [])),
                "difficulty": np.asarray(ann.get("difficulty", [])),
            })
        return annos
