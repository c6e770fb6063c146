"""DataProcessor: the config-driven per-sample processing queue (port of
cpd_tpu/datasets/processor.py, NumPy as there).

Parity with cpd/datasets/processor/data_processor.py:61-233 -- named ops
selected from cfg DATA_PROCESSOR (the reference resolves ``cur_cfg.NAME``
with getattr, :73-75): mask_points_and_boxes_outside_range, shuffle_points,
sample_points. ``transform_points_to_voxels`` is a no-op here that only
records the voxel spec: voxelization runs on the device (ops.voxelizer)
inside the model's forward instead of on CPU workers.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from .box_np import mask_points_by_range_np


class DataProcessor:
    def __init__(self, processor_cfgs: List[dict], point_cloud_range, training: bool):
        self.point_cloud_range = np.asarray(point_cloud_range, np.float32)
        self.training = training
        self.mode = "train" if training else "test"
        self.queue = []
        self.voxel_cfg: Optional[dict] = None
        for cfg in processor_cfgs or []:
            fn = getattr(self, cfg["NAME"], None)
            if fn is None:
                raise KeyError(f"unknown processor {cfg['NAME']}")
            self.queue.append((fn, cfg))

    def __call__(self, data: Dict, rng) -> Dict:
        for fn, cfg in self.queue:
            data = fn(data, cfg, rng)
        return data

    # -- ops ----------------------------------------------------------------
    def mask_points_and_boxes_outside_range(self, data, cfg, rng):
        for suffix in ("", "1"):
            pk = f"points{suffix}"
            if pk in data and data[pk] is not None:
                data[pk] = data[pk][mask_points_by_range_np(data[pk], self.point_cloud_range)]
        if cfg.get("REMOVE_OUTSIDE_BOXES", False) and self.training and len(data.get("gt_boxes", [])):
            boxes = data["gt_boxes"]
            keep = (
                (boxes[:, 0] >= self.point_cloud_range[0]) & (boxes[:, 0] <= self.point_cloud_range[3])
                & (boxes[:, 1] >= self.point_cloud_range[1]) & (boxes[:, 1] <= self.point_cloud_range[4])
            )
            data["gt_boxes"] = boxes[keep]
            if "gt_names" in data:
                data["gt_names"] = np.asarray(data["gt_names"])[keep]
            for extra in ("css_score", "proto_group_id"):
                if extra in data and data[extra] is not None and len(data[extra]) == len(keep):
                    data[extra] = np.asarray(data[extra])[keep]
        return data

    def shuffle_points(self, data, cfg, rng):
        if not cfg.get("SHUFFLE_ENABLED", {}).get(self.mode, self.training):
            return data
        for suffix in ("", "1"):
            pk = f"points{suffix}"
            if pk in data and data[pk] is not None:
                perm = rng.permutation(len(data[pk]))
                data[pk] = data[pk][perm]
        return data

    def sample_points(self, data, cfg, rng):
        n = int(cfg.get("NUM_POINTS", {}).get(self.mode, 0)) or int(cfg.get("NUM_POINTS", 0))
        if n <= 0:
            return data
        for suffix in ("", "1"):
            pk = f"points{suffix}"
            if pk not in data or data[pk] is None:
                continue
            pts = data[pk]
            if len(pts) > n:
                # far points kept preferentially when subsampling (reference :185)
                sel = rng.choice(len(pts), n, replace=False)
                data[pk] = pts[sel]
            elif len(pts) < n and len(pts) > 0:
                extra = rng.choice(len(pts), n - len(pts), replace=True)
                data[pk] = np.concatenate([pts, pts[extra]], axis=0)
        return data

    def transform_points_to_voxels(self, data, cfg, rng):
        # voxelization happens on device; keep the spec for the model factory
        self.voxel_cfg = cfg
        return data
