"""The CPD detector (port of cpd_tpu/models/detector.py::VoxelRCNN) and the
detector registry.

voxelize (MeanVFE fused) -> VoxelResBackBone8x (sparse convs through kernel
A1; with ``dense_tail=True`` stage 4 and conv_out as dense conv3d) or the
plain VoxelBackBone8x -> HeightCompression -> (temporal fusion) ->
BaseBEVBackbone -> CenterHead proposals -> (PFE keypoints) ->
VoxelRCNNProtoHead -> (PartWraper re-scoring) -> final NMS (``predict``,
eval mode), or in training mode -> dense-head, RoI-head and wrap-head
losses (``loss_step``), with the MM siamese branch encoding the
proto-completed view when ``mm=True``. With ``align_stages`` > 1 and a
batch from the X_TRAIN protocol (``points_stage{i}``, ``transform_param``)
the stage clones run through the shared backbone, packed into the batch
axis at eval and one after another in training, and their BEV maps are
de-augmented into stage 0's frame and fused (``bev_align_params``). The
anchor heads
(``AnchorHeadSingle``, ``AnchorHeadSingleV2`` with its point-density anchor
mask) take the CenterHead's place with their own proposal layer, and
``VoxelRCNNHead`` is the proto head with the MM branch off. The PointPillars
topology (``PillarVFE`` -> ``PointPillarScatter``) has no 3D backbone and no
RoI head: its final NMS runs on the proposals. The constructor keeps the JAX
module's field names, so the JAX package's model kwargs carry over; fields
that only steer the TPU's compilation are taken and have no effect.
``build_network`` builds the model (VoxelRCNN or CenterPoint) from a yaml
config's MODEL section, as the JAX package's does.
"""
from __future__ import annotations

import inspect
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..ops import nms as nms_ops
from ..ops.sparse import GridSpec, keys_from_coords
from ..ops.voxelizer import VoxelizerSpec, voxelize_batch
from .anchor_head import AnchorHeadSingle, AnchorHeadSingleV2, point_density_anchor_mask
from .backbone3d import PLAIN_OUT_CHANNELS, VoxelBackBone8x, VoxelResBackBone8x, stage_grids
from .bev import BaseBEVBackbone, bev_align_params, height_compression
from .center_head import CenterHead
from .centerpoint import CenterPoint
from .part_wraper import PartWraper
from .pfe import VoxelSetAbstraction
from .pillars import PillarVFE, pointpillar_scatter
from .roi_head import VoxelRCNNProtoHead
from .temporal import TEMPORAL_MODELS, TemporalConcatenation


# the module of each slot is chosen by its config NAME, as in the JAX package
# (cpd_tpu/models/detector.py:38-62,545); None is an empty slot
# no BACKBONE_3D (None): the PointPillars topology
_BACKBONES_3D = ("VoxelResBackBone8x", "VoxelBackBone8x", None)
_DENSE_HEADS = {"CenterHead": CenterHead, "AnchorHeadSingle": AnchorHeadSingle,
                "AnchorHeadSingleV2": AnchorHeadSingleV2}
# VoxelRCNNHead is the proto head with the MM branch off
_ROI_HEADS = {"VoxelRCNNProtoHead": True, "VoxelRCNNHead": False}
_VFES = ("MeanVFE", "PillarVFE")
_MAP_TO_BEV = ("HeightCompression", "PointPillarScatter")
_TEMPORAL = {**TEMPORAL_MODELS, None: None}
_PFES = {"VoxelSetAbstraction": VoxelSetAbstraction, None: None}
_WRAP_HEADS = {"PartWraper": PartWraper, None: None}
# ROI_GRID_POOL keys that tune the TPU's pooling lookup table
_TPU_ONLY_ROI_KEYS = ("pool_use_lut", "pool_lut_max_cells")


def check_known(slot: str, name, known) -> None:
    """Raise a KeyError naming ``name`` when no module of ``slot`` has it."""
    if name not in known:
        raise KeyError(f"unknown {slot} {name!r}; known: "
                       f"{sorted(n for n in known if n is not None)}")


def keys_from_frame(frame, grid: GridSpec):
    """VoxelizedFrame coords -> sorted int32 keys with INVALID_KEY padding."""
    return keys_from_coords(frame.coords.long(), grid, frame.valid)


class VoxelRCNN(nn.Module):
    """The CPD detector: VoxelResBackBone8x, VoxelBackBone8x or PillarVFE ->
    BEV (-> temporal fusion) -> CenterHead or an anchor head (-> PFE) ->
    ProtoHead or none (-> PartWraper).
    ``predict`` (after ``.eval()``) and ``loss_step`` (after ``.train()``) are
    the entry points."""

    def __init__(self, num_classes: int = 3,
                 point_cloud_range: Tuple[float, ...] = (-75.2, -75.2, -2.0, 75.2, 75.2, 4.0),
                 voxel_size: Tuple[float, float, float] = (0.1, 0.1, 0.15),
                 max_voxels: int = 150000, num_point_features: int = 5,
                 max_points_per_voxel=None,
                 backbone_filters: Tuple[int, ...] = (16, 32, 64, 128),
                 backbone_caps: Tuple[int, ...] = (80000, 60000, 40000, 40000),
                 mm: bool = True, remat: bool = True, remat_backbone=None, remat_roi=None,
                 with_roi_head: bool = True,
                 num_rois: int = 500, num_rois_test: int = 200, roi_grid_size: int = 6,
                 roi_per_image: int = 130, bn_axis_name: Optional[str] = None, rpn_nms=None,
                 post_nms=None, backbone3d_name: str = "VoxelResBackBone8x",
                 backbone_lut_max_cells=None, dense_tail: bool = False,
                 dense_head_name: str = "CenterHead", roi_head_name: str = "VoxelRCNNProtoHead",
                 dense_head_cfg=None, roi_head_cfg=None, align_stages: int = 1,
                 align_method: str = "mean", pack_align_stages: bool = True,
                 vfe_name: str = "MeanVFE", vfe_filters: Tuple[int, ...] = (64,),
                 map_to_bev_name: str = "HeightCompression", temporal_name=None,
                 temporal_features: int = 256, num_frames: int = 1, pfe_name=None,
                 pfe_cfg=None, wrap_head_name=None,
                 bev_layer_nums=(5, 5), bev_layer_strides=(1, 2),
                 bev_num_filters=(128, 256), bev_upsample_strides=(1, 2),
                 bev_num_upsample_filters=(256, 256)):
        """The JAX module's fields, all of them. ``remat``, ``remat_backbone``,
        ``remat_roi``, ``bn_axis_name`` and ``backbone_lut_max_cells`` (and
        ``pool_use_lut`` / ``pool_lut_max_cells`` in ``roi_head_cfg``) steer
        the TPU's compilation and have no effect here. ``post_nms`` is
        stored: ``predict`` does not read it (neither does the JAX module's).
        ``dense_head_cfg`` configures the anchor heads (the CenterHead
        ignores it). ``temporal_name`` fuses the BEV maps of the current
        frame and up to ``num_frames`` - 1 history frames (``temporal_features``
        wide); ``pfe_name`` adds keypoint features (``pfe_cfg``: num_keypoints,
        nsample, ...) to the forward's outputs; ``wrap_head_name`` re-scores
        the boxes. ``align_stages`` > 1 fuses the X_TRAIN stage clones'
        maps by ``align_method``, packed into the batch axis at eval when
        ``pack_align_stages``. A name that selects no module raises a
        KeyError; PillarVFE asks for PointPillarScatter and no RoI head, and
        every other VFE for a 3D backbone (ValueError), as in the JAX
        package."""
        super().__init__()
        check_known("BACKBONE_3D.NAME", backbone3d_name, _BACKBONES_3D)
        check_known("DENSE_HEAD.NAME", dense_head_name, _DENSE_HEADS)
        check_known("ROI_HEAD.NAME", roi_head_name, _ROI_HEADS)
        check_known("VFE.NAME", vfe_name, _VFES)
        check_known("MAP_TO_BEV.NAME", map_to_bev_name, _MAP_TO_BEV)
        check_known("TEMPORAL_MODEL.NAME", temporal_name, _TEMPORAL)
        check_known("PFE.NAME", pfe_name, _PFES)
        check_known("WRAP_HEAD.NAME", wrap_head_name, _WRAP_HEADS)
        self.align_stages = align_stages
        self.align_method = align_method
        self.pack_align_stages = pack_align_stages
        self.temporal_name = temporal_name
        self.num_frames = num_frames
        self.pfe_name = pfe_name
        self.wrap_head_name = wrap_head_name
        self.pillars = vfe_name == "PillarVFE"
        if self.pillars:
            if map_to_bev_name != "PointPillarScatter":
                raise ValueError("PillarVFE requires MAP_TO_BEV PointPillarScatter")
            if with_roi_head:
                raise ValueError("the RoI head pools multi-scale sparse voxel features; it "
                                 "needs a 3D backbone (not PillarVFE)")
        elif backbone3d_name is None:
            raise ValueError("the HeightCompression path needs a BACKBONE_3D (only "
                             "PillarVFE+PointPillarScatter runs without one)")
        self.with_roi_head = with_roi_head
        self.post_nms = post_nms
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
        grids = stage_grids(self.grid)
        if self.pillars:
            self.vfe = PillarVFE(num_point_features, vfe_filters)
            bev_channels = self.vfe.num_filters[-1]
        elif backbone3d_name == "VoxelBackBone8x":  # no dense tail, as in JAX
            self.backbone = VoxelBackBone8x(self.grid, num_point_features, backbone_filters,
                                            backbone_caps, mm=mm)
            bev_channels = grids["encoded"].nz * PLAIN_OUT_CHANNELS
        else:
            self.backbone = VoxelResBackBone8x(self.grid, num_point_features,
                                               backbone_filters, backbone_caps, mm=mm,
                                               dense_tail=dense_tail)
            bev_channels = grids["encoded"].nz * backbone_filters[3]
        if temporal_name is not None:
            t_cls = _TEMPORAL[temporal_name]
            self.temporal = (t_cls(bev_channels, num_frames, temporal_features)
                             if t_cls is TemporalConcatenation
                             else t_cls(bev_channels, temporal_features))
            bev_channels = temporal_features
        if pfe_name is not None and not self.pillars:  # JAX runs it on voxel features only
            self.pfe = _PFES[pfe_name](
                {"x_conv3": backbone_filters[2], "x_conv4": backbone_filters[3]}, bev_channels,
                voxel_size=voxel_size, point_cloud_range=point_cloud_range,
                **dict(pfe_cfg or {}))
        self.bev_backbone = BaseBEVBackbone(
            bev_channels, bev_layer_nums, bev_layer_strides, bev_num_filters,
            bev_upsample_strides, bev_num_upsample_filters)
        self.dense_head_name = dense_head_name
        head_channels = sum(bev_num_upsample_filters)
        if dense_head_name == "CenterHead":
            self.dense_head = CenterHead(head_channels, num_classes, voxel_size=voxel_size,
                                         point_cloud_range=point_cloud_range)
        else:
            self.dense_head = _DENSE_HEADS[dense_head_name](
                head_channels, num_classes, point_cloud_range, **dict(dense_head_cfg or {}))
        if with_roi_head:
            roi_cfg = {k: v for k, v in dict(roi_head_cfg or {}).items()
                       if k not in _TPU_ONLY_ROI_KEYS}
            self.roi_head = VoxelRCNNProtoHead(
                {k: grids[k] for k in ("x_conv3", "x_conv4")},
                {"x_conv3": backbone_filters[2], "x_conv4": backbone_filters[3]},
                num_rois=num_rois, roi_per_image=roi_per_image, grid_size=roi_grid_size,
                voxel_size=voxel_size, point_cloud_range=point_cloud_range,
                mm=mm and _ROI_HEADS[roi_head_name], **roi_cfg)
        if wrap_head_name is not None:
            self.wrap_head = _WRAP_HEADS[wrap_head_name](
                head_channels, point_cloud_range, voxel_size=voxel_size)

    @property
    def _anchor_head(self) -> bool:
        return self.dense_head_name != "CenterHead"

    def forward(self, batch: Dict[str, torch.Tensor], sampling_uniforms=None, generator=None,
                keypoints: bool = True):
        """batch: points (B, P, C), optional points_valid (B, P); in training
        mode also gt_boxes (B, N, 8), gt_valid, optionally css_score and, with
        ``mm``, the proto-completed view points1 / points1_valid (falling back
        to the raw points); with ``align_stages`` > 1 the clones
        points_stage{i} (/ _valid) and transform_param (B, S, n_cfg); with a
        temporal model the history points_prev{i} (/ _valid), where a
        missing key ends the window. ``sampling_uniforms`` and ``generator``
        feed the RoI sampling and the dropout (see
        ``VoxelRCNNProtoHead.forward``). With a PFE and ``keypoints`` the
        outputs hold its keypoint features; ``predict`` and ``loss_step``
        read none and ask for none, as JAX's jit drops them there."""
        if self.pillars:
            bev = self._pillar_bev(batch["points"], batch.get("points_valid"))
            return self._bev_to_heads(bev, {}, batch, sampling_uniforms, generator, keypoints)
        b, stages = batch["points"].shape[0], self.align_stages
        aligning = stages > 1 and "transform_param" in batch and "points_stage1" in batch
        # packed at eval only, as in JAX: in training each stage's batch norm
        # takes its own batch statistics, one pass after another
        packing = aligning and self.pack_align_stages and not self.training
        if packing:
            ones = torch.ones(batch["points"].shape[:2], dtype=torch.bool,
                              device=batch["points"].device)
            pts = torch.cat([batch["points"]] + [batch[f"points_stage{i}"]
                                                 for i in range(1, stages)])
            pv = torch.cat([batch.get("points_valid", ones)]
                           + [batch.get(f"points_stage{i}_valid", ones) for i in range(1, stages)])
            frame = voxelize_batch(pts, self.vox_spec, pv)
        else:
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
        if aligning:
            if packing:
                maps = list(bev.split(b))
                # only stage 0's rows feed the RoI head and the PFE
                backbone_out = {k: (f[:b], ky[:b], g) for k, (f, ky, g) in backbone_out.items()}
            else:
                maps = [bev] + [self._bev_single(batch[f"points_stage{i}"],
                                                 batch.get(f"points_stage{i}_valid"))
                                for i in range(1, stages)]
            bev = bev_align_params(maps, batch["transform_param"], self.point_cloud_range,
                                   self.voxel_size[0] * 8, fusion=self.align_method)
        return self._bev_to_heads(bev, backbone_out, batch, sampling_uniforms, generator,
                                  keypoints)

    def _bev_single(self, points, valid):
        """The BEV map of one set of frames through the shared encoders (the
        X_TRAIN clones, the temporal history)."""
        if self.pillars:
            return self._pillar_bev(points, valid)
        frame = voxelize_batch(points, self.vox_spec, valid)
        bo = self.backbone(frame.features, keys_from_frame(frame, self.grid))
        if "encoded_bev" in bo:
            return bo["encoded_bev"]
        return height_compression(*bo["encoded"])

    def _bev_to_heads(self, bev, backbone_out, batch, sampling_uniforms, generator, keypoints):
        train = self.training
        if self.temporal_name is not None:
            maps = [bev]
            for i in range(1, self.num_frames):
                k = f"points_prev{i}"
                if k not in batch:
                    break
                maps.append(self._bev_single(batch[k], batch.get(k + "_valid")))
            # f32, as JAX stacks a fused f32 map with bf16 history maps
            bev = self.temporal(torch.stack([m.float() for m in maps], dim=1))
        st_features_2d = self.bev_backbone(bev)
        n_rois = self.num_rois if train else self.num_rois_test
        rpn_nms = dict(self.rpn_nms, NMS_POST_MAXSIZE=n_rois)
        if self.dense_head_name == "AnchorHeadSingleV2":
            # the point-density anchor mask: one (H, W) mask for the batch
            amask = point_density_anchor_mask(
                batch["points"], batch.get("points_valid"), tuple(st_features_2d.shape[1:3]),
                self.point_cloud_range, self.grid.nx)
            head_preds = self.dense_head(st_features_2d, amask)
        else:
            head_preds = self.dense_head(st_features_2d)
        # proposals are constants to the second stage: the RPN learns from
        # its own loss
        with torch.no_grad():
            if self._anchor_head:
                proposals = self._anchor_proposals(head_preds, n_rois, rpn_nms)
            else:
                proposals = self.dense_head.generate_predicted_boxes(
                    head_preds, k=500, score_thresh=0.0 if train else 0.1, nms_cfg=rpn_nms,
                    post_max_size=n_rois)
        out = {"head_preds": head_preds, "backbone_out": backbone_out}
        out.update(proposals)
        if keypoints and self.pfe_name is not None and backbone_out:
            # keypoint features, exposed for downstream consumers: no loss reads them
            valid = batch.get("points_valid")
            if valid is None:
                valid = torch.ones(batch["points"].shape[:2], dtype=torch.bool,
                                   device=batch["points"].device)
            out["point_coords"], out["point_features"], out["point_valid"] = self.pfe(
                batch["points"], valid, backbone_out, bev)
        if self.with_roi_head:
            out.update(self.roi_head(proposals, backbone_out, batch, sampling_uniforms,
                                     generator))
        if self.wrap_head_name is not None:
            # the part confidences replace the box scores in post-processing
            out["wrap_boxes"] = out.get("batch_box_preds", out["rois"])[..., :7]
            out["wrap_conf"], _ = self.wrap_head(st_features_2d, out["wrap_boxes"],
                                                 out["roi_valid"])
        return out

    def _pillar_bev(self, points, valid):
        """PillarVFE over the dynamic voxelizer's pillars -> BEV scatter. The
        samples' pillar tables are offset into one (B*V) table, so that the
        pillar net and its batch norm run once over the batch."""
        b, p, c = points.shape
        if valid is None:
            valid = torch.ones((b, p), dtype=torch.bool, device=points.device)
        frame = voxelize_batch(points, self.vox_spec, valid, with_point_voxel_id=True)
        v = frame.features.shape[1]
        off = torch.arange(b, dtype=torch.int32, device=points.device)[:, None] * v
        pid = torch.where(frame.point_voxel_id >= 0, frame.point_voxel_id + off, -1)
        centers_xy = torch.stack([
            (frame.coords[..., 2].float() + 0.5) * self.voxel_size[0] + self.point_cloud_range[0],
            (frame.coords[..., 1].float() + 0.5) * self.voxel_size[1] + self.point_cloud_range[1],
        ], dim=-1)
        pooled = self.vfe(points.reshape(b * p, c), pid.reshape(b * p),
                          frame.features[..., :3].reshape(b * v, 3),
                          centers_xy.reshape(b * v, 2), b * v).reshape(b, v, -1)
        keys = keys_from_frame(frame, self.grid)
        return torch.stack([pointpillar_scatter(f, k, self.grid) for f, k in zip(pooled, keys)])

    def _anchor_proposals(self, preds, n_rois, nms_cfg):
        """Anchor-head proposal layer: decode every anchor, keep the top
        ``NMS_PRE_MAXSIZE`` by best class score (ties lowest index first),
        class-agnostic NMS -> fixed-size rois per sample."""
        boxes, scores = self.dense_head.generate_predicted_boxes(preds)
        best = scores.amax(dim=-1)
        labels = (scores.argmax(dim=-1) + 1).to(torch.int32)
        pre = min(int(nms_cfg.get("NMS_PRE_MAXSIZE", 4096)), boxes.shape[1])
        ts, ti = nms_ops.top_k(best, pre)
        bb, ll = nms_ops.gather_rows(boxes, ti), nms_ops.gather_rows(labels, ti)
        idx, mask = nms_ops.nms_bev_batched(
            bb, ts, thresh=nms_cfg["NMS_THRESH"], pre_max_size=pre, post_max_size=n_rois,
            valid=ts > 0.0, fast=bool(nms_cfg.get("USE_FAST_NMS", True)))
        return {"rois": nms_ops.gather_rows(bb, idx), "roi_scores": nms_ops.gather_rows(ts, idx),
                "roi_labels": nms_ops.gather_rows(ll, idx), "roi_valid": mask}

    def compute_loss(self, out, batch):
        """Total training loss = dense-head loss (+ RoI-head loss), and the
        dict of its named parts."""
        if self._anchor_head:
            rpn_loss, tb = self.dense_head.get_loss(out["head_preds"], batch["gt_boxes"],
                                                    batch["gt_valid"])
        else:
            h, w = out["head_preds"]["hm"].shape[1:3]
            targets = self.dense_head.assign_targets(batch["gt_boxes"], batch["gt_valid"],
                                                     (h, w))
            rpn_loss, tb = self.dense_head.get_loss(out["head_preds"], targets)
        total = rpn_loss
        if self.with_roi_head and "rcnn_cls" in out:
            rcnn_loss, tb2 = self.roi_head.get_loss(out, batch)
            tb.update(tb2)
            total = total + rcnn_loss
        if "wrap_conf" in out:
            tb["wrap_loss"] = self.wrap_head.get_loss(out["wrap_conf"], out["wrap_boxes"],
                                                      out["roi_valid"], batch["gt_boxes"],
                                                      batch["gt_valid"])
            total = total + tb["wrap_loss"]
        tb["rpn_loss"] = rpn_loss
        tb["total_loss"] = total
        return total, tb

    def loss_step(self, batch, sampling_uniforms=None, generator=None):
        """Training forward + loss (call after ``.train()``): (total, tb)."""
        if not self.training:
            raise RuntimeError("loss_step needs training mode: call .train() first")
        return self.compute_loss(self(batch, sampling_uniforms, generator, keypoints=False),
                                 batch)

    @torch.no_grad()
    def predict(self, batch):
        """Forward + final NMS -> fixed-size (B, post) pred_boxes /
        pred_scores / pred_labels / pred_valid."""
        return self.post_processing(self(batch, keypoints=False))

    def post_processing(self, out, score_thresh=0.01, nms_cfg=None, post_max=500):
        """Final NMS over the refined boxes (scored by the wrap head where
        there is one), or over the proposals of a model without a RoI head."""
        nms_cfg = nms_cfg or {"NMS_THRESH": 0.3, "NMS_PRE_MAXSIZE": 4096,
                              "NMS_POST_MAXSIZE": post_max}
        if "wrap_conf" in out:
            boxes, scores = out["wrap_boxes"], out["wrap_conf"]
        elif "batch_box_preds" in out:  # refined by the RoI head
            boxes = out["batch_box_preds"]
            scores = torch.sigmoid(out["batch_cls_preds"][..., 0])
        else:
            boxes, scores = out["rois"], out["roi_scores"]
        labels = out["roi_labels"]
        valid = out["roi_valid"] & (scores > score_thresh)
        idx, mask = nms_ops.nms_bev_batched(
            boxes, scores, thresh=nms_cfg["NMS_THRESH"],
            pre_max_size=min(int(nms_cfg["NMS_PRE_MAXSIZE"]), boxes.shape[1]),
            post_max_size=min(int(nms_cfg["NMS_POST_MAXSIZE"]), post_max),
            valid=valid, fast=bool(nms_cfg.get("USE_FAST_NMS", True)))
        return {"pred_boxes": nms_ops.gather_rows(boxes, idx),
                "pred_scores": nms_ops.gather_rows(scores, idx),
                "pred_labels": nms_ops.gather_rows(labels, idx), "pred_valid": mask}


_DETECTORS = {"VoxelRCNN": VoxelRCNN, "CenterPoint": CenterPoint}


def set_compute_dtype(model: nn.Module, dtype) -> nn.Module:
    """Every module of ``model`` that computes in a ``compute_dtype`` (sparse
    convs, BEV and head convs, the RoI MLPs and towers) to ``dtype``; None
    computes in the dtype of the features, f32."""
    for m in model.modules():
        if hasattr(m, "compute_dtype"):
            m.compute_dtype = dtype
    return model


def _anchor_head_cfg(dh):
    """DENSE_HEAD yaml -> AnchorHeadSingle(V2) kwargs (cpd_tpu/models/detector.py:548).
    As there, the generator's anchor_bottom_heights, align_center and
    feature_map_stride are not read: anchors sit at z = -1 + dz / 2 and
    follow the head map's own shape."""
    gen = dh.get("ANCHOR_GENERATOR_CONFIG", None)
    cfg = {}
    if gen:
        cfg["anchor_sizes"] = tuple(tuple(g["anchor_sizes"][0]) for g in gen)
        cfg["anchor_rotations"] = tuple(gen[0].get("anchor_rotations", (0, 1.57)))
        cfg["matched_thresholds"] = tuple(float(g["matched_threshold"]) for g in gen)
        cfg["unmatched_thresholds"] = tuple(float(g["unmatched_threshold"]) for g in gen)
    if "DIR_OFFSET" in dh:
        cfg["dir_offset"] = float(dh["DIR_OFFSET"])
    if "DIR_LIMIT_OFFSET" in dh:
        cfg["dir_limit_offset"] = float(dh["DIR_LIMIT_OFFSET"])
    if "NUM_DIR_BINS" in dh:
        cfg["num_dir_bins"] = int(dh["NUM_DIR_BINS"])
    lw = dh.get("LOSS_CONFIG", {}).get("LOSS_WEIGHTS", {})
    for k in ("cls_weight", "loc_weight", "dir_weight"):
        if k in lw:
            cfg[k] = float(lw[k])
    if "code_weights" in lw:
        cfg["code_weights"] = tuple(float(x) for x in lw["code_weights"])
    return cfg


def _roi_head_cfg(roi):
    """ROI_HEAD yaml TARGET_CONFIG/LOSS_CONFIG -> VoxelRCNNProtoHead kwargs
    (cpd_tpu/models/detector.py:574)."""
    cfg = {}
    t = roi.get("TARGET_CONFIG", {})
    for yk, k in (("FG_RATIO", "fg_ratio"), ("REG_FG_THRESH", "reg_fg_thresh"),
                  ("CLS_FG_THRESH", "cls_fg_thresh"), ("CLS_BG_THRESH", "cls_bg_thresh"),
                  ("CLS_BG_THRESH_LO", "cls_bg_thresh_lo"),
                  ("HARD_BG_RATIO", "hard_bg_ratio"),
                  ("HARD_SAMPLING_THRESH", "hard_sampling_thresh"),
                  ("HARD_SAMPLING_RATIO", "hard_sampling_ratio"),
                  ("DIRECTION_MIN", "direction_min"),
                  ("DIRECTION_MAX", "direction_max")):
        if yk in t:
            v = t[yk]
            cfg[k] = tuple(float(x) for x in v) if isinstance(v, (list, tuple)) else float(v)
    if "CLS_SCORE_TYPE" in t:
        cfg["cls_score_type"] = str(t["CLS_SCORE_TYPE"])
    if "ENABLE_HARD_SAMPLING" in t:
        cfg["enable_hard_sampling"] = bool(t["ENABLE_HARD_SAMPLING"])
    lw = roi.get("LOSS_CONFIG", {}).get("LOSS_WEIGHTS", {})
    if "rcnn_proto_weight" in lw:
        cfg["rcnn_proto_weight"] = float(lw["rcnn_proto_weight"])
    gp = roi.get("ROI_GRID_POOL", {})
    if "USE_LUT" in gp:
        cfg["pool_use_lut"] = bool(gp["USE_LUT"])
    if "LUT_MAX_CELLS" in gp:
        cfg["pool_lut_max_cells"] = int(gp["LUT_MAX_CELLS"])
    if "DP_RATIO" in roi:
        cfg["dp_ratio"] = float(roi["DP_RATIO"])
    if "SHARED_FC" in roi:
        cfg["shared_fc"] = tuple(int(x) for x in roi["SHARED_FC"])
    return cfg


def build_network(model_cfg, num_class: int, data_cfg) -> nn.Module:
    """Config-driven detector factory (port of cpd_tpu/models/detector.py:608).

    MODEL.NAME picks VoxelRCNN or CenterPoint, and the module of each slot
    is chosen by its yaml NAME; an unknown name raises a KeyError that names
    it. CenterPoint takes the fields it declares and ignores the rest, as in
    JAX. ``model_cfg`` / ``data_cfg``: the MODEL and DATA_CONFIG sections
    (dicts or ConfigDicts). The model comes back on the CPU with zero
    weights: load a state dict, then place it (``utils.device.place``).
    """
    name = model_cfg.get("NAME", "VoxelRCNN")
    check_known("MODEL.NAME", name, _DETECTORS)
    pcr = tuple(data_cfg["POINT_CLOUD_RANGE"])
    vox_cfg = None
    for proc in data_cfg["DATA_PROCESSOR"]:
        if proc["NAME"] == "transform_points_to_voxels":
            vox_cfg = proc
    voxel_size = tuple(vox_cfg["VOXEL_SIZE"]) if vox_cfg else (0.1, 0.1, 0.15)
    max_voxels = int(vox_cfg["MAX_NUMBER_OF_VOXELS"]["train"]) if vox_cfg else 150000
    b3d = model_cfg.get("BACKBONE_3D", None)
    dh = model_cfg.get("DENSE_HEAD", {})
    roi = model_cfg.get("ROI_HEAD", None)
    dense_name = dh.get("NAME", "CenterHead")
    check_known("DENSE_HEAD.NAME", dense_name, _DENSE_HEADS)
    # BACKBONE_3D is optional: a PointPillars config has none
    b3d_name = b3d.get("NAME", "VoxelResBackBone8x") if b3d is not None else None
    check_known("BACKBONE_3D.NAME", b3d_name, _BACKBONES_3D)
    b3d = b3d or {}
    roi_name = roi.get("NAME", "VoxelRCNNProtoHead") if roi else "VoxelRCNNProtoHead"
    check_known("ROI_HEAD.NAME", roi_name, _ROI_HEADS)
    dense_post = dh.get("POST_PROCESSING", {})
    default_caps = (max(max_voxels // 2, 1024),) + tuple(
        max(max_voxels // d, 512) for d in (4, 8, 8))
    vfe = model_cfg.get("VFE", {}) or {}
    m2b = model_cfg.get("MAP_TO_BEV", {}) or {}
    tm = model_cfg.get("TEMPORAL_MODEL", None)
    pfe_c = model_cfg.get("PFE", None)
    wrap = model_cfg.get("WRAP_HEAD", None)
    pfe_kwargs = {}
    if pfe_c:
        if "NUM_KEYPOINTS" in pfe_c:
            pfe_kwargs["num_keypoints"] = int(pfe_c["NUM_KEYPOINTS"])
        if "NSAMPLE" in pfe_c:
            pfe_kwargs["nsample"] = int(pfe_c["NSAMPLE"])
    # the model's input width is the point encoder's (datasets.dataset.
    # PointFeatureEncoder): KITTI's [x, y, z, intensity] gives 4 columns; JAX
    # infers the first conv's Cin from the batch it initialises on
    pfe_enc = data_cfg.get("POINT_FEATURE_ENCODING", None)
    kwargs = dict(
        num_classes=num_class,
        point_cloud_range=pcr,
        voxel_size=voxel_size,
        max_voxels=max_voxels,
        num_point_features=len(pfe_enc.get("used_feature_list", ("x", "y", "z", "intensity")))
        if pfe_enc else 5,
        backbone_filters=tuple(b3d.get("NUM_FILTERS", (16, 32, 64, 128))),
        backbone_caps=tuple(b3d.get("VOXEL_CAPS", default_caps)),
        mm=bool(b3d.get("MM", False)),
        # VFE.SPCONV_PARITY opts into the reference's first-5-points-per-voxel mean
        max_points_per_voxel=(
            int(vox_cfg.get("MAX_POINTS_PER_VOXEL", 5))
            if vox_cfg and vfe.get("SPCONV_PARITY", False) else None),
        backbone3d_name=b3d_name,
        backbone_lut_max_cells=int(b3d["LUT_MAX_CELLS"]) if "LUT_MAX_CELLS" in b3d else None,
        dense_tail=bool(b3d.get("DENSE_TAIL", False)),
        dense_head_name=dense_name,
        dense_head_cfg=_anchor_head_cfg(dh) if dense_name != "CenterHead" else None,
        roi_head_name=roi_name,
        roi_head_cfg=_roi_head_cfg(roi) if roi else None,
        with_roi_head=roi is not None,
        num_rois=int(roi.get("NMS_CONFIG", {}).get("TRAIN", {}).get("NMS_POST_MAXSIZE", 500))
        if roi else 500,
        num_rois_test=int(roi.get("NMS_CONFIG", {}).get("TEST", {}).get("NMS_POST_MAXSIZE", 200))
        if roi else 200,
        roi_per_image=int(roi["TARGET_CONFIG"]["ROI_PER_IMAGE"]) if roi else 130,
        roi_grid_size=int(roi.get("ROI_GRID_POOL", {}).get("GRID_SIZE", 6)) if roi else 6,
        rpn_nms=dict(dense_post.get("NMS_CONFIG", {})) or None,
        post_nms=dict(model_cfg.get("POST_PROCESSING", {}).get("NMS_CONFIG", {})) or None,
        vfe_name=vfe.get("NAME", "MeanVFE"),
        vfe_filters=tuple(vfe.get("NUM_FILTERS", (64,))),
        map_to_bev_name=m2b.get("NAME", "HeightCompression"),
        temporal_name=tm.get("NAME") if tm else None,
        temporal_features=int(tm.get("NUM_TEMPORAL_FEATURES", 256)) if tm else 256,
        num_frames=int(data_cfg.get("NUM_FRAMES", 1) or 1),
        pfe_name=pfe_c.get("NAME") if pfe_c else None,
        pfe_cfg=pfe_kwargs or None,
        wrap_head_name=wrap.get("NAME") if wrap else None,
    )
    b2d = model_cfg.get("BACKBONE_2D", {}) or {}
    if "LAYER_NUMS" in b2d:
        kwargs.update(
            bev_layer_nums=tuple(b2d["LAYER_NUMS"]),
            bev_layer_strides=tuple(b2d.get("LAYER_STRIDES", (1, 2))),
            bev_num_filters=tuple(b2d.get("NUM_FILTERS", (128, 256))),
            bev_upsample_strides=tuple(b2d.get("UPSAMPLE_STRIDES", (1, 2))),
            bev_num_upsample_filters=tuple(b2d.get("NUM_UPSAMPLE_FILTERS", (256, 256))),
        )
    cls = _DETECTORS[name]
    known = set(inspect.signature(cls.__init__).parameters)
    return cls(**{k: v for k, v in kwargs.items() if k in known})
