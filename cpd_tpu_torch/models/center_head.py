"""CenterHead RPN (port of cpd_tpu/models/center_head.py): shared conv,
separate prediction heads, top-K decode + proposal NMS, and for training the
gaussian target assignment and the focal + L1 losses."""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from ..ops import gaussian, nms
from ..utils import loss as loss_utils
from .bev import conv2d
from .norm import BatchNorm2d


class _Conv(nn.Module):
    """Holder of a 3x3 conv's weight (Cout, Cin, 3, 3) and bias."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(out_channels, in_channels, 3, 3))
        self.bias = nn.Parameter(torch.zeros(out_channels))


class SeparateHead(nn.Module):
    """(num_conv - 1) x [3x3 conv + BN + ReLU] in compute_dtype, then an f32
    3x3 output conv. NCHW in, NCHW f32 out."""

    def __init__(self, head_channels: int, out_channels: int, num_conv: int = 2,
                 compute_dtype=torch.bfloat16):
        super().__init__()
        self.num_conv = num_conv
        self.compute_dtype = compute_dtype
        for i in range(num_conv - 1):
            self.add_module(f"conv{i}", _Conv(head_channels, head_channels))
            self.add_module(f"bn{i}", BatchNorm2d(head_channels))
        self.out = _Conv(head_channels, out_channels)

    def forward(self, x):
        for i in range(self.num_conv - 1):
            conv = getattr(self, f"conv{i}")
            x = conv2d(x, conv.weight, conv.bias, 1, 1, self.compute_dtype)
            x = torch.relu(getattr(self, f"bn{i}")(x))
        return conv2d(x.float(), self.out.weight, self.out.bias, 1, 1)


class CenterHead(nn.Module):
    def __init__(self, in_channels: int, num_classes: int, shared_conv_channel: int = 64,
                 num_hm_conv: int = 2,
                 head_order: Tuple[str, ...] = ("center", "center_z", "dim", "rot"),
                 head_dims: Tuple[int, ...] = (2, 1, 3, 2),
                 voxel_size=(0.1, 0.1, 0.15),
                 point_cloud_range=(-75.2, -75.2, -2.0, 75.2, 75.2, 4.0),
                 feature_map_stride: int = 8, gaussian_overlap: float = 0.1,
                 min_radius: int = 2, cls_weight: float = 1.0, loc_weight: float = 2.0,
                 code_weights: Tuple[float, ...] = (1.0,) * 8, compute_dtype=torch.bfloat16):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.num_classes = num_classes
        self.gaussian_overlap = gaussian_overlap
        self.min_radius = min_radius
        self.cls_weight = cls_weight
        self.loc_weight = loc_weight
        self.code_weights = tuple(code_weights)
        self.head_order = tuple(head_order)
        self.voxel_size = tuple(voxel_size)
        self.point_cloud_range = tuple(point_cloud_range)
        self.feature_map_stride = feature_map_stride
        self.shared_conv = _Conv(in_channels, shared_conv_channel)
        self.shared_bn = BatchNorm2d(shared_conv_channel)
        self.head_hm = SeparateHead(shared_conv_channel, num_classes, num_hm_conv,
                                    compute_dtype)
        for name, dim in zip(head_order, head_dims):
            self.add_module(f"head_{name}",
                            SeparateHead(shared_conv_channel, dim, 2, compute_dtype))

    def forward(self, bev_features):
        """(B, H, W, C) NHWC -> dict of NHWC f32 prediction maps."""
        x = bev_features.permute(0, 3, 1, 2)
        x = conv2d(x, self.shared_conv.weight, self.shared_conv.bias, 1, 1,
                   self.compute_dtype)
        x = torch.relu(self.shared_bn(x))
        names = ("hm",) + self.head_order
        return {n: getattr(self, f"head_{n}")(x).permute(0, 2, 3, 1) for n in names}

    def assign_targets(self, gt_boxes, gt_valid, feature_map_size):
        """Batched target assignment. gt_boxes (B, N, 8), gt_valid (B, N) ->
        heatmap (B, C, H, W), target_boxes (B, N, 8), inds (B, N), mask (B, N)."""
        per_sample = [gaussian.assign_center_targets(
            b, v, self.num_classes, feature_map_size, self.voxel_size,
            self.point_cloud_range, self.feature_map_stride, self.gaussian_overlap,
            self.min_radius) for b, v in zip(gt_boxes, gt_valid)]
        return {k: torch.stack([t[k] for t in per_sample]) for k in per_sample[0]}

    def get_loss(self, preds, targets):
        """Focal heatmap loss + L1 regression loss at the peak pixels."""
        hm_pred = torch.sigmoid(preds["hm"].permute(0, 3, 1, 2))
        hm_loss = loss_utils.focal_loss_centernet(hm_pred, targets["heatmap"])
        reg_maps = torch.cat([preds[k] for k in self.head_order], dim=-1).permute(0, 3, 1, 2)
        reg_loss = loss_utils.reg_loss_centernet(reg_maps, targets["target_boxes"],
                                                 targets["inds"], targets["mask"])
        loc_loss = torch.sum(reg_loss * reg_loss.new_tensor(self.code_weights))
        total = self.cls_weight * hm_loss + self.loc_weight * loc_loss
        return total, {"hm_loss": hm_loss, "loc_loss": loc_loss}

    def generate_predicted_boxes(self, preds, k=500, score_thresh=0.1, nms_cfg=None,
                                 post_max_size=500):
        """Decode top-K + class-agnostic NMS -> fixed-size rois per sample:
        rois (B, post, 7), roi_scores, roi_labels (1-based int32), roi_valid."""
        hm = torch.sigmoid(preds["hm"].permute(0, 3, 1, 2))
        maps = [preds[n].permute(0, 3, 1, 2) for n in ("center", "center_z", "dim", "rot")]
        rois, roi_scores, labels, roi_valid = gaussian.decode_bbox_from_heatmap(
            hm, *maps, self.voxel_size, self.point_cloud_range, self.feature_map_stride, k=k,
            score_thresh=score_thresh, post_center_limit_range=self.point_cloud_range)
        if nms_cfg is not None:
            idx, roi_valid = nms.nms_bev_batched(
                rois, roi_scores, thresh=nms_cfg["NMS_THRESH"],
                pre_max_size=min(int(nms_cfg["NMS_PRE_MAXSIZE"]), k),
                post_max_size=min(int(nms_cfg["NMS_POST_MAXSIZE"]), post_max_size),
                valid=roi_valid, fast=bool(nms_cfg.get("USE_FAST_NMS", True)))
            rois, roi_scores, labels = (nms.gather_rows(t, idx) for t in (rois, roi_scores, labels))
        roi_labels = (labels + 1).to(torch.int32)
        return {"rois": rois, "roi_scores": roi_scores, "roi_labels": roi_labels,
                "roi_valid": roi_valid}
