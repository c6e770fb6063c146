"""CenterPoint: the single-stage detector of the registry (port of
cpd_tpu/models/centerpoint.py).

voxelize -> VoxelResBackBone8x (MM off) -> HeightCompression ->
BaseBEVBackbone -> CenterHead, no RoI head: the decoded, NMS'd heatmap boxes
are the detections. As in the JAX package the 2D backbone and the head are
built at their defaults, whatever the yaml's BACKBONE_2D says.
``loss_step`` and ``predict`` take the VoxelRCNN's signatures, so the
trainer and both CLIs drive either model.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from ..ops.sparse import GridSpec, keys_from_coords
from ..ops.voxelizer import VoxelizerSpec, voxelize_batch
from .backbone3d import VoxelResBackBone8x, stage_grids
from .bev import BaseBEVBackbone, height_compression
from .center_head import CenterHead


class CenterPoint(nn.Module):
    def __init__(self, num_classes: int = 3,
                 point_cloud_range: Tuple[float, ...] = (-75.2, -75.2, -2.0, 75.2, 75.2, 4.0),
                 voxel_size: Tuple[float, float, float] = (0.1, 0.1, 0.15),
                 max_voxels: int = 150000, num_point_features: int = 5,
                 backbone_filters: Tuple[int, ...] = (16, 32, 64, 128),
                 backbone_caps: Tuple[int, ...] = (80000, 60000, 40000, 40000),
                 num_dets: int = 500, post_nms=None):
        """The JAX module's fields and ``num_point_features``, the input
        width (JAX infers it from the batch it initialises on)."""
        super().__init__()
        self.num_dets = num_dets
        self.post_nms = post_nms
        self.vox_spec = VoxelizerSpec.create(point_cloud_range, voxel_size, max_voxels)
        nx, ny, nz = self.vox_spec.grid_size
        self.grid = GridSpec(nx, ny, nz + 1)  # spconv convention: +1 on z
        self.backbone = VoxelResBackBone8x(self.grid, num_point_features, backbone_filters,
                                           backbone_caps, mm=False)
        self.bev_backbone = BaseBEVBackbone(
            stage_grids(self.grid)["encoded"].nz * backbone_filters[3])
        # the default BaseBEVBackbone concatenates 256 + 256 channels
        self.dense_head = CenterHead(512, num_classes, voxel_size=voxel_size,
                                     point_cloud_range=point_cloud_range)

    def forward(self, batch: Dict[str, torch.Tensor], sampling_uniforms=None, generator=None):
        """batch: points (B, P, C), optional points_valid. -> {"head_preds"}
        and, in eval mode, the fixed-size (B, num_dets) detections.
        ``sampling_uniforms`` and ``generator`` are taken for the VoxelRCNN's
        signature: nothing here samples."""
        frame = voxelize_batch(batch["points"], self.vox_spec, batch.get("points_valid"))
        keys = keys_from_coords(frame.coords.long(), self.grid, frame.valid)
        backbone_out = self.backbone(frame.features, keys)
        head_preds = self.dense_head(self.bev_backbone(height_compression(
            *backbone_out["encoded"])))
        out = {"head_preds": head_preds}
        if not self.training:
            nms_cfg = self.post_nms or {"NMS_THRESH": 0.7, "NMS_PRE_MAXSIZE": 4096,
                                        "NMS_POST_MAXSIZE": self.num_dets}
            dets = self.dense_head.generate_predicted_boxes(
                head_preds, k=500, score_thresh=0.1, nms_cfg=nms_cfg,
                post_max_size=self.num_dets)
            out.update(pred_boxes=dets["rois"], pred_scores=dets["roi_scores"],
                       pred_labels=dets["roi_labels"], pred_valid=dets["roi_valid"])
        return out

    def loss_step(self, batch, sampling_uniforms=None, generator=None):
        """Training forward + the CenterHead's loss (call after ``.train()``):
        (total, tb)."""
        if not self.training:
            raise RuntimeError("loss_step needs training mode: call .train() first")
        out = self(batch)
        h, w = out["head_preds"]["hm"].shape[1:3]
        targets = self.dense_head.assign_targets(batch["gt_boxes"], batch["gt_valid"], (h, w))
        loss, tb = self.dense_head.get_loss(out["head_preds"], targets)
        tb["total_loss"] = loss
        return loss, tb

    @torch.no_grad()
    def predict(self, batch):
        """Forward in eval mode -> fixed-size (B, num_dets) pred_boxes /
        pred_scores / pred_labels / pred_valid."""
        out = self(batch)
        return {k: out[k] for k in ("pred_boxes", "pred_scores", "pred_labels", "pred_valid")}
