"""DatasetTemplate: the universal sample-dict protocol (port of
cpd_tpu/datasets/dataset.py, the same NumPy).

Parity with the reference (cpd/datasets/dataset.py:15-292): prepare_data runs
augmentors -> class filtering + class-id append -> point feature encoding ->
processors; collate_batch pads a list of samples into one batch dict. As in
the JAX package, ragged arrays + batch-idx columns are replaced by
fixed-capacity padded arrays + validity masks (the static shapes the model
takes), and voxelization runs on the device inside the model's forward.

Batch protocol (everything float32/int32/bool, static shapes):
  points (B, P_cap, C), points_valid (B, P_cap)
  [stage 1] points1, points1_valid        -- proto-completed view
  gt_boxes (B, G_cap, 8) [x y z dx dy dz yaw cls], gt_valid (B, G_cap)
  css_score (B, G_cap), proto_group_id (B, G_cap) int32 (-1 pad)
  frame_id / metadata stay host-side (list), never moved to the device.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from .augmentor import DataAugmentor, TestAugmentor
from .box_np import mask_points_by_range_np


class PointFeatureEncoder:
    """Column selection (processor/point_feature_encoder.py:4-69)."""

    def __init__(self, cfg):
        self.used = list(cfg.get("used_feature_list", ["x", "y", "z", "intensity"]))
        self.src = list(cfg.get("src_feature_list", ["x", "y", "z", "intensity"]))
        self.num_point_features = len(self.used)

    def __call__(self, points):
        idx = [self.src.index(f) for f in self.used]
        return points[:, idx]


class DatasetTemplate:
    """Base dataset: wires augmentor/encoder/processors, owns prepare_data."""

    def __init__(self, dataset_cfg=None, class_names=None, training=True,
                 root_path=None, logger=None, point_cap=200_000, gt_cap=256,
                 test_iter=0, db_sampler=None):
        self.dataset_cfg = dataset_cfg or {}
        self.class_names = list(class_names or [])
        self.training = training
        self.root_path = root_path
        self.logger = logger
        self.point_cap = int(self.dataset_cfg.get("POINT_CAP", point_cap))
        self.gt_cap = int(self.dataset_cfg.get("GT_CAP", gt_cap))
        self.point_cloud_range = np.asarray(
            self.dataset_cfg.get("POINT_CLOUD_RANGE", [-75.2, -75.2, -2, 75.2, 75.2, 4]),
            dtype=np.float32,
        )
        self.stages = int(self.dataset_cfg.get("STAGES", 2))
        pfe_cfg = self.dataset_cfg.get("POINT_FEATURE_ENCODING", {})
        self.point_feature_encoder = PointFeatureEncoder(pfe_cfg)
        aug_cfg = self.dataset_cfg.get("DATA_AUGMENTOR", {})
        self.data_augmentor = (
            DataAugmentor(
                aug_cfg.get("AUG_CONFIG_LIST", []), self.class_names, root_path,
                db_sampler=db_sampler,
            )
            if training
            else None
        )
        tta_cfg = self.dataset_cfg.get("TEST_AUGMENTOR")
        self.test_augmentor = (
            TestAugmentor(tta_cfg, test_iter) if (tta_cfg and not training) else None
        )
        self.seed = int(self.dataset_cfg.get("SEED", 666))
        self.epoch = 0
        self.rng = np.random.default_rng(self.seed)

    def set_epoch(self, epoch: int):
        self.epoch = int(epoch)

    # -- to be provided by concrete datasets --
    def __len__(self):
        raise NotImplementedError

    def __getitem__(self, index):
        raise NotImplementedError

    # ------------------------------------------------------------------
    def _pad_points(self, points, rng):
        p = np.zeros((self.point_cap, points.shape[1]), np.float32)
        v = np.zeros((self.point_cap,), bool)
        n = min(len(points), self.point_cap)
        if len(points) > self.point_cap:
            sel = rng.choice(len(points), self.point_cap, replace=False)
            points = points[sel]
        p[:n] = points[:n]
        v[:n] = True
        return p, v

    def prepare_data(self, data_dict: Dict) -> Dict:
        """augment -> filter classes -> encode -> range mask -> pad to caps.

        Deterministic & thread-safe: all randomness comes from a per-sample rng
        seeded by (seed, epoch, sample index).
        """
        idx = int(data_dict.get("sample_idx", 0))
        rng = np.random.default_rng(np.random.SeedSequence((self.seed, self.epoch, idx)))
        if self.training and self.data_augmentor is not None:
            data_dict = self.data_augmentor.forward(data_dict, rng)
        if self.test_augmentor is not None:
            data_dict = self.test_augmentor.forward(data_dict)

        gt_boxes = np.asarray(data_dict.get("gt_boxes", np.zeros((0, 7))), np.float32)
        gt_names = np.asarray(data_dict.get("gt_names", np.zeros((0,), dtype="U16")))
        if len(gt_boxes):
            keep = np.array([n in self.class_names for n in gt_names], bool)
            gt_boxes, gt_names = gt_boxes[keep], gt_names[keep]
            for extra in ("css_score", "proto_group_id"):
                if extra in data_dict and data_dict[extra] is not None and len(data_dict[extra]):
                    data_dict[extra] = np.asarray(data_dict[extra])[keep]
        cls_ids = np.array(
            [self.class_names.index(n) + 1 for n in gt_names], np.float32
        ) if len(gt_names) else np.zeros((0,), np.float32)

        out = {}
        for suffix in [""] + (["1"] if (self.training and self.stages > 1) else []):
            pts = data_dict.get(f"points{suffix}")
            if pts is None:
                pts = data_dict["points"]
            pts = self.point_feature_encoder(np.asarray(pts, np.float32))
            pts = pts[mask_points_by_range_np(pts, self.point_cloud_range)]
            if self.training and self.dataset_cfg.get("SHUFFLE_POINTS", True):
                rng.shuffle(pts)
            p, v = self._pad_points(pts, rng)
            out[f"points{suffix}"] = p
            out[f"points{suffix}_valid"] = v

        g = np.zeros((self.gt_cap, 8), np.float32)
        gv = np.zeros((self.gt_cap,), bool)
        css = np.zeros((self.gt_cap,), np.float32)
        pid = np.full((self.gt_cap,), -1, np.int32)
        n = min(len(gt_boxes), self.gt_cap)
        if n:
            g[:n, :7] = gt_boxes[:n, :7]
            g[:n, 7] = cls_ids[:n]
            gv[:n] = True
            if "css_score" in data_dict and data_dict["css_score"] is not None and len(data_dict["css_score"]):
                css[:n] = np.asarray(data_dict["css_score"], np.float32)[:n]
            else:
                css[:n] = 1.0
            if "proto_group_id" in data_dict and data_dict["proto_group_id"] is not None and len(data_dict["proto_group_id"]):
                pid[:n] = np.asarray(data_dict["proto_group_id"], np.int32)[:n]
        out.update({
            "gt_boxes": g, "gt_valid": gv, "css_score": css, "proto_group_id": pid,
        })
        for meta in ("frame_id", "sequence_name", "metadata", "pose"):
            if meta in data_dict:
                out[meta] = data_dict[meta]
        return out


def _template_generate_prediction_dicts(self, batch, pred_dicts, class_names, output_path=None):
    """Generic device-output -> annotation dicts (overridden by datasets
    needing coordinate/TTA handling, e.g. WaymoUnsupervisedDataset)."""
    out = []
    boxes = np.asarray(pred_dicts["pred_boxes"])
    scores = np.asarray(pred_dicts["pred_scores"])
    labels = np.asarray(pred_dicts["pred_labels"])
    valid = np.asarray(pred_dicts["pred_valid"])
    for i in range(batch["batch_size"]):
        m = valid[i]
        lb = labels[i][m]
        names = np.asarray(class_names)[np.clip(lb - 1, 0, len(class_names) - 1)]
        out.append({
            "frame_id": batch.get("frame_id", list(range(batch["batch_size"])))[i],
            "boxes_lidar": boxes[i][m], "score": scores[i][m], "name": names,
            "pred_labels": lb,
        })
    return out


def _template_collect_gt_annos(self):
    """Generic gt collection from prepared eval samples."""
    annos = []
    for i in range(len(self)):
        s = self[i]
        v = s["gt_valid"]
        cls_ids = s["gt_boxes"][v, 7].astype(int)
        names = np.asarray(self.class_names)[np.clip(cls_ids - 1, 0, len(self.class_names) - 1)]
        annos.append({
            "frame_id": s.get("frame_id", i),
            "gt_boxes_lidar": s["gt_boxes"][v, :7],
            "name": names,
            "num_points_in_gt": np.full(int(v.sum()), 100),
            "difficulty": np.zeros(int(v.sum())),
        })
    return annos


def _template_evaluation(self, det_annos, class_names, eval_metric="waymo", **kwargs):
    from ..evaluation import waymo_style_eval

    gt_annos = kwargs.get("gt_annos") or self.collect_gt_annos()
    return waymo_style_eval(det_annos, gt_annos, class_names)


DatasetTemplate.generate_prediction_dicts = _template_generate_prediction_dicts
DatasetTemplate.collect_gt_annos = _template_collect_gt_annos
DatasetTemplate.evaluation = _template_evaluation


def collate_batch(samples: List[Dict]) -> Dict:
    """Stack fixed-shape sample dicts into one batch (dataset.py:229 parity;
    no ragged padding needed -- prepare_data already produced static shapes)."""
    batch = {}
    array_keys = [k for k, v in samples[0].items() if isinstance(v, np.ndarray)]
    for k in array_keys:
        batch[k] = np.stack([s[k] for s in samples])
    meta_keys = [k for k in samples[0] if k not in array_keys]
    for k in meta_keys:
        batch[k] = [s[k] for s in samples]
    batch["batch_size"] = len(samples)
    return batch
