"""The CPD detector (port of cpd_tpu/models/detector.py::VoxelRCNN).

voxelize (MeanVFE fused) -> VoxelResBackBone8x (sparse convs through kernel
A1; with ``dense_tail=True`` stage 4 and conv_out as dense conv3d) ->
HeightCompression -> BaseBEVBackbone -> CenterHead proposals ->
VoxelRCNNProtoHead -> final NMS (``predict``, eval mode), or in training
mode -> dense-head and RoI-head losses (``loss_step``), with the MM siamese
branch encoding the proto-completed view when ``mm=True``. The constructor
keeps the JAX module's field names, so the JAX package's model kwargs carry
over. The YAML-driven ``build_network`` is not ported.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from ..ops import nms as nms_ops
from ..ops.sparse import GridSpec, keys_from_coords
from ..ops.voxelizer import VoxelizerSpec, voxelize_batch
from .backbone3d import VoxelResBackBone8x, stage_grids
from .bev import BaseBEVBackbone, height_compression
from .center_head import CenterHead
from .roi_head import VoxelRCNNProtoHead


def keys_from_frame(frame, grid: GridSpec):
    """VoxelizedFrame coords -> sorted int32 keys with INVALID_KEY padding."""
    return keys_from_coords(frame.coords.long(), grid, frame.valid)


class VoxelRCNN(nn.Module):
    """The CPD detector: VoxelResBackBone8x -> BEV -> CenterHead -> ProtoHead.
    ``predict`` (after ``.eval()``) and ``loss_step`` (after ``.train()``) are
    the entry points."""

    def __init__(self, num_classes: int = 3,
                 point_cloud_range: Tuple[float, ...] = (-75.2, -75.2, -2.0, 75.2, 75.2, 4.0),
                 voxel_size: Tuple[float, float, float] = (0.1, 0.1, 0.15),
                 max_voxels: int = 150000, num_point_features: int = 5,
                 max_points_per_voxel=None,
                 backbone_filters: Tuple[int, ...] = (16, 32, 64, 128),
                 backbone_caps: Tuple[int, ...] = (80000, 60000, 40000, 40000),
                 mm: bool = True, dense_tail: bool = False,
                 num_rois: int = 500, num_rois_test: int = 200, roi_grid_size: int = 6,
                 roi_per_image: int = 130, rpn_nms=None,
                 bev_layer_nums=(5, 5), bev_layer_strides=(1, 2),
                 bev_num_filters=(128, 256), bev_upsample_strides=(1, 2),
                 bev_num_upsample_filters=(256, 256), roi_head_cfg=None):
        super().__init__()
        self.mm = mm
        self.num_rois = num_rois
        self.num_rois_test = num_rois_test
        self.rpn_nms = dict(rpn_nms or {"NMS_THRESH": 0.8, "NMS_PRE_MAXSIZE": 4096})
        self.point_cloud_range = tuple(point_cloud_range)
        self.voxel_size = tuple(voxel_size)
        self.vox_spec = VoxelizerSpec.create(point_cloud_range, voxel_size, max_voxels,
                                             max_points_per_voxel=max_points_per_voxel)
        nx, ny, nz = self.vox_spec.grid_size
        self.grid = GridSpec(nx, ny, nz + 1)  # spconv convention: +1 on z
        self.backbone = VoxelResBackBone8x(self.grid, num_point_features,
                                           backbone_filters, backbone_caps, mm=mm,
                                           dense_tail=dense_tail)
        grids = stage_grids(self.grid)
        c3 = backbone_filters[3]
        self.bev_backbone = BaseBEVBackbone(
            grids["encoded"].nz * c3, bev_layer_nums, bev_layer_strides, bev_num_filters,
            bev_upsample_strides, bev_num_upsample_filters)
        self.dense_head = CenterHead(sum(bev_num_upsample_filters), num_classes,
                                     voxel_size=voxel_size,
                                     point_cloud_range=point_cloud_range)
        self.roi_head = VoxelRCNNProtoHead(
            {k: grids[k] for k in ("x_conv3", "x_conv4")},
            {"x_conv3": backbone_filters[2], "x_conv4": backbone_filters[3]},
            num_rois=num_rois, roi_per_image=roi_per_image, grid_size=roi_grid_size,
            voxel_size=voxel_size, point_cloud_range=point_cloud_range, mm=mm,
            **dict(roi_head_cfg or {}))

    def forward(self, batch: Dict[str, torch.Tensor], sampling_uniforms=None, generator=None):
        """batch: points (B, P, C), optional points_valid (B, P); in training
        mode also gt_boxes (B, N, 8), gt_valid, optionally css_score and, with
        ``mm``, the proto-completed view points1 / points1_valid (falling back
        to the raw points). ``sampling_uniforms`` and ``generator`` feed the
        RoI sampling and the dropout (see ``VoxelRCNNProtoHead.forward``)."""
        frame = voxelize_batch(batch["points"], self.vox_spec, batch.get("points_valid"))
        keys = keys_from_frame(frame, self.grid)
        feats_mm = keys_mm = None
        if self.mm and self.training:
            frame_mm = voxelize_batch(batch.get("points1", batch["points"]), self.vox_spec,
                                      batch.get("points1_valid", batch.get("points_valid")))
            feats_mm = frame_mm.features
            keys_mm = keys_from_frame(frame_mm, self.grid)
        backbone_out = self.backbone(frame.features, keys, feats_mm, keys_mm)
        if "encoded_bev" in backbone_out:
            # the dense tail already made the BEV map (no sparse round trip)
            bev = backbone_out.pop("encoded_bev")
        else:
            bev = height_compression(*backbone_out["encoded"])
        return self._bev_to_heads(bev, backbone_out, batch, sampling_uniforms, generator)

    def _bev_to_heads(self, bev, backbone_out, batch, sampling_uniforms, generator):
        train = self.training
        st_features_2d = self.bev_backbone(bev)
        head_preds = self.dense_head(st_features_2d)
        n_rois = self.num_rois if train else self.num_rois_test
        rpn_nms = dict(self.rpn_nms, NMS_POST_MAXSIZE=n_rois)
        # proposals are constants to the second stage: the RPN learns from
        # its own loss
        with torch.no_grad():
            proposals = self.dense_head.generate_predicted_boxes(
                head_preds, k=500, score_thresh=0.0 if train else 0.1, nms_cfg=rpn_nms,
                post_max_size=n_rois)
        out = {"head_preds": head_preds, "backbone_out": backbone_out}
        out.update(proposals)
        out.update(self.roi_head(proposals, backbone_out, batch, sampling_uniforms, generator))
        return out

    def compute_loss(self, out, batch):
        """Total training loss = dense-head loss + RoI-head loss, and the
        dict of its named parts."""
        h, w = out["head_preds"]["hm"].shape[1:3]
        targets = self.dense_head.assign_targets(batch["gt_boxes"], batch["gt_valid"], (h, w))
        rpn_loss, tb = self.dense_head.get_loss(out["head_preds"], targets)
        rcnn_loss, tb2 = self.roi_head.get_loss(out, batch)
        tb.update(tb2)
        total = rpn_loss + rcnn_loss
        tb["rpn_loss"] = rpn_loss
        tb["total_loss"] = total
        return total, tb

    def loss_step(self, batch, sampling_uniforms=None, generator=None):
        """Training forward + loss (call after ``.train()``): (total, tb)."""
        if not self.training:
            raise RuntimeError("loss_step needs training mode: call .train() first")
        return self.compute_loss(self(batch, sampling_uniforms, generator), batch)

    @torch.no_grad()
    def predict(self, batch):
        """Forward + final NMS -> fixed-size (B, post) pred_boxes /
        pred_scores / pred_labels / pred_valid."""
        return self.post_processing(self(batch))

    def post_processing(self, out, score_thresh=0.01, nms_cfg=None, post_max=500):
        """Final NMS over the refined boxes."""
        nms_cfg = nms_cfg or {"NMS_THRESH": 0.3, "NMS_PRE_MAXSIZE": 4096,
                              "NMS_POST_MAXSIZE": post_max}
        boxes = out["batch_box_preds"]
        scores = torch.sigmoid(out["batch_cls_preds"][..., 0])
        labels = out["roi_labels"]
        valid = out["roi_valid"] & (scores > score_thresh)
        res = []
        for b, s, l, v in zip(boxes, scores, labels, valid):
            idx, mask = nms_ops.nms_bev(
                b, s, thresh=nms_cfg["NMS_THRESH"],
                pre_max_size=min(int(nms_cfg["NMS_PRE_MAXSIZE"]), b.shape[0]),
                post_max_size=min(int(nms_cfg["NMS_POST_MAXSIZE"]), post_max),
                valid=v, fast=bool(nms_cfg.get("USE_FAST_NMS", True)))
            res.append((b[idx], s[idx], l[idx], mask))
        fb, fs, fl, fv = (torch.stack(t) for t in zip(*res))
        return {"pred_boxes": fb, "pred_scores": fs, "pred_labels": fl, "pred_valid": fv}
