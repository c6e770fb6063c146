"""VoxelRCNN RoI head with the CPD prototype-distillation branch (port of
cpd_tpu/models/roi_head.py): RoI grid points + voxel queries, multi-scale
grid pooling, FC towers and the box decode; for training the fg/bg proposal
sampling, the canonical-frame targets, the raw/proto tower pair and the
CSS-weighted losses with the proto block.

Random numbers are explicit: ``sample_rois_for_rcnn`` takes its uniforms as
an argument (``draw_sampling_uniforms`` draws them from a
``torch.Generator``), and the towers' dropout masks come from the generator
handed to the head, so a test can feed both frameworks the same numbers."""
from __future__ import annotations

from typing import Tuple

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import pool
from ..ops.box_coders import ResidualCoder
from ..ops.geometry import limit_period, rotate_points_along_z
from ..ops.iou3d import boxes_iou3d
from ..ops.nms import top_k
from ..utils import loss as loss_utils
from .norm import MaskedBatchNorm

SCALE_SPECS = (
    ("x_conv3", 4, ((2, 2, 2), 0.4), ((4, 4, 4), 0.8)),
    ("x_conv4", 8, ((2, 2, 2), 0.8), ((4, 4, 4), 1.6)),
)


SAMPLING_UNIFORMS = ("fg", "hard", "easy", "fill", "prio", "hs")


def draw_sampling_uniforms(batch: int, num_rois: int, generator=None, device=None):
    """The uniforms one call of ``sample_rois_for_rcnn`` per sample consumes:
    {name: (batch, num_rois)} for the fg / hard-bg / easy-bg / filler ranks,
    the selection priority and the hard-sampling picks."""
    return {name: torch.rand((batch, num_rois), generator=generator, device=device)
            for name in SAMPLING_UNIFORMS}


def _rank_by_random(mask, r):
    """Ranks 0..n-1 of the True entries of ``mask`` in the order of their
    uniforms ``r``; False entries get n."""
    n = mask.shape[0]
    order = torch.argsort(torch.where(mask, r, math.inf), stable=True)
    ranks = torch.empty(n, dtype=torch.int64, device=mask.device)
    ranks[order] = torch.arange(n, device=mask.device)
    return torch.where(mask, ranks, n)


def _ang_similarity(a, b):
    """1 - wrapped |a - b| / pi, in [0, 1]."""
    d = torch.remainder(torch.abs(a - b), 2 * math.pi)
    d = torch.minimum(d, 2 * math.pi - d)
    return 1.0 - d / math.pi


def _per_class(value, gt_cls):
    """Scalar or per-class tuple -> per-roi values keyed by gt class (1-based)."""
    if isinstance(value, (tuple, list)):
        table = torch.tensor(value, dtype=torch.float32, device=gt_cls.device)
        return table[torch.clamp(gt_cls - 1, 0, len(value) - 1)]
    return torch.full(gt_cls.shape, float(value), device=gt_cls.device)


def _minval(v):
    return min(v) if isinstance(v, (tuple, list)) else v


@torch.no_grad()
def sample_rois_for_rcnn(uniforms, rois, roi_scores, roi_labels, roi_valid, gt_boxes,
                         gt_valid, css_score, roi_per_image: int = 130,
                         fg_ratio: float = 0.5, reg_fg_thresh=0.3, cls_fg_thresh=0.6,
                         cls_bg_thresh=0.02, cls_bg_thresh_lo: float = 0.01,
                         hard_bg_ratio: float = 0.1, cls_score_type: str = "roi_iou",
                         direction_min: float = 0.4, direction_max: float = 0.8,
                         enable_hard_sampling: bool = False, hard_sampling_thresh=0.3,
                         hard_sampling_ratio=0.3):
    """Static-shape fg / hard-bg / easy-bg RoI sampling with per-class IoU
    matching, for ONE sample.

    uniforms: {name: (R,)} of ``SAMPLING_UNIFORMS`` (``hs`` only with hard
    sampling, its first roi_per_image entries); rois (R, 7); roi_scores,
    roi_labels (1-based), roi_valid (R,); gt_boxes (N, 8) with the class in
    column 7; gt_valid, css_score (N,). Category ranks come from the uniforms
    and quotas are rank comparisons; one top-k picks the rois. Returns
    (roi_per_image,)-shaped rois, gt_of_rois (8), roi_ious, roi_labels,
    roi_scores, reg_valid_mask, cls_labels, css, valid."""
    iou = boxes_iou3d(rois[:, :7], gt_boxes[:, :7])  # (R, N)
    same_cls = roi_labels[:, None] == gt_boxes[None, :, 7].to(torch.int32)
    iou = torch.where(same_cls & gt_valid[None, :] & roi_valid[:, None], iou, -1.0)
    gt_idx = torch.argmax(iou, dim=1)  # ties go to the first gt
    max_iou = torch.clamp(torch.amax(iou, dim=1), min=0.0)

    fg_thresh = min(_minval(reg_fg_thresh), _minval(cls_fg_thresh))
    fg = roi_valid & (max_iou >= fg_thresh)
    easy_bg = roi_valid & (max_iou < cls_bg_thresh_lo)
    hard_bg = roi_valid & (max_iou >= cls_bg_thresh_lo) & (max_iou < fg_thresh)
    fg_rank = _rank_by_random(fg, uniforms["fg"])
    hard_rank = _rank_by_random(hard_bg, uniforms["hard"])
    easy_rank = _rank_by_random(easy_bg, uniforms["easy"])

    fg_quota = int(round(roi_per_image * fg_ratio))
    n_fg = torch.clamp(fg.sum(), max=fg_quota)
    sel_fg = fg & (fg_rank < fg_quota)
    bg_quota = roi_per_image - n_fg
    hard_quota = torch.ceil(bg_quota.to(torch.float32) * hard_bg_ratio).long()
    sel_hard = hard_bg & (hard_rank < hard_quota)
    sel_easy = easy_bg & (easy_rank < bg_quota - sel_hard.sum())
    # backfill: if not enough easy bg, take more hard bg; then any valid roi
    sel_hard = sel_hard | (hard_bg & (hard_rank < bg_quota - sel_easy.sum()))
    selected = sel_fg | sel_hard | sel_easy
    filler_rank = _rank_by_random(roi_valid & ~selected, uniforms["fill"])
    filler = roi_valid & ~selected & (filler_rank < roi_per_image - selected.sum())
    selected = selected | filler

    priority = (torch.where(sel_fg, 3e6, 0.0) + torch.where(sel_hard, 2e6, 0.0)
                + torch.where(sel_easy, 1e6, 0.0) + torch.where(filler, 5e5, 0.0)
                + uniforms["prio"])
    priority = torch.where(selected, priority, -math.inf)
    top_priority, sel_idx = top_k(priority, roi_per_image)
    sel_valid = torch.isfinite(top_priority)

    s_rois = rois[sel_idx]
    s_iou = max_iou[sel_idx]
    s_gt_idx = gt_idx[sel_idx]
    s_gt = gt_boxes[s_gt_idx]
    gt_cls = s_gt[:, 7].long()
    reg_thr = _per_class(reg_fg_thresh, gt_cls)
    reg_valid = (s_iou >= reg_thr) & sel_valid
    if enable_hard_sampling:
        hard = (s_iou < reg_thr) & (s_iou > _per_class(hard_sampling_thresh, gt_cls))
        pick = uniforms["hs"][:roi_per_image] < _per_class(hard_sampling_ratio, gt_cls)
        reg_valid = reg_valid | (hard & pick & sel_valid)
    fg_t = _per_class(cls_fg_thresh, gt_cls)
    bg_t = _per_class(cls_bg_thresh, gt_cls)
    if cls_score_type == "cls":
        cls_labels = torch.where(s_iou > fg_t, 1.0, 0.0)
        cls_labels = torch.where((s_iou <= fg_t) & (s_iou > bg_t), -1.0, cls_labels)
    else:
        soft = (s_iou - bg_t) / (fg_t - bg_t)
        cls_labels = torch.where(s_iou > fg_t, 1.0, torch.where(s_iou < bg_t, 0.0, soft))
        if cls_score_type in ("roi_ioud", "roi_ioud_x"):
            ang = _ang_similarity(s_rois[:, 6], s_gt[:, 6])
            ang = ((torch.clamp(ang, direction_min, direction_max) - direction_min)
                   / (direction_max - direction_min))
            cls_labels = cls_labels * ang
    return {
        "rois": s_rois,
        "gt_of_rois": s_gt,
        "roi_ious": s_iou,
        "roi_labels": roi_labels[sel_idx],
        "roi_scores": roi_scores[sel_idx],
        "reg_valid_mask": reg_valid,
        "cls_labels": torch.where(sel_valid, cls_labels, 0.0),
        "css": torch.where(sel_valid, css_score[s_gt_idx], 0.0),
        "valid": sel_valid,
    }


def encode_roi_targets(rois, gt_of_rois, coder: ResidualCoder):
    """Canonical-frame regression targets: gt moved into each roi's frame
    (centre subtracted, rotated by -yaw, heading difference wrapped and
    flipped into (-pi/2, pi/2]), then encoded against the size-only local
    anchor. rois (..., 7), gt_of_rois (..., 7+) -> (targets, gt_local)."""
    roi_yaw = rois[..., 6]
    xyz = rotate_points_along_z((gt_of_rois[..., 0:3] - rois[..., 0:3])[..., None, :],
                                -roi_yaw)[..., 0, :]
    heading = limit_period(gt_of_rois[..., 6] - roi_yaw, offset=0.5, period=math.pi * 2)
    flip = (heading > math.pi / 2) | (heading < -math.pi / 2)
    heading = torch.where(flip, heading - torch.sign(heading) * math.pi, heading)
    gt_local = torch.cat([xyz, gt_of_rois[..., 3:6], heading[..., None]], dim=-1)
    return coder.encode(gt_local, _local_anchor(rois)), gt_local


def _local_anchor(rois):
    """The size-only anchor at the origin of each roi's canonical frame."""
    zeros = torch.zeros_like(rois[..., 0:3])
    return torch.cat([zeros, rois[..., 3:6], zeros[..., 0:1]], dim=-1)


def decode_roi_boxes(rois, rcnn_reg, coder: ResidualCoder):
    """Residuals in the RoI's canonical frame -> world boxes."""
    local = coder.decode(rcnn_reg, _local_anchor(rois))
    xyz = rotate_points_along_z(local[..., None, 0:3], rois[..., 6])[..., 0, :]
    return torch.cat([xyz + rois[..., 0:3], local[..., 3:6], local[..., 6:7] + rois[..., 6:7]],
                     dim=-1)


@torch.no_grad()
def compute_pool_queries(rois, scale_features, scale_grids, scale_specs, voxel_size,
                         point_cloud_range, grid_size, nsample, suffix: str = ""):
    """RoI grid points + the voxel queries of every (scale, radius group).
    Returns {f"{name}_{gi}": (idx, valid, rel)} with rel the (B, Q, nsample, 3)
    query-to-voxel-center offsets, Q = R * grid_size^3."""
    b, r = rois.shape[:2]
    queries = torch.stack([pool.roi_grid_points(rb, grid_size) for rb in rois])
    queries = queries.reshape(b, r * grid_size ** 3, 3)
    out = {}
    for name, ds, *groups in scale_specs:
        _, keys = scale_features[name + suffix]
        radii = tuple(float(rr) for _, rr in groups)
        qrange = tuple(max(g[0][d] for g in groups) for d in range(3))
        per_sample = [pool.voxel_query_multi(q, k, scale_grids[name], tuple(voxel_size),
                                             point_cloud_range, ds, qrange, radii, nsample)
                      for q, k in zip(queries, keys)]
        for gi in range(len(groups)):
            idx, valid, centers = (torch.stack(t) for t in zip(*(s[gi] for s in per_sample)))
            out[f"{name}_{gi}"] = (idx, valid, centers - queries[:, :, None, :])
    return out


class _Dense(nn.Module):
    """x @ W^T + b in ``compute_dtype`` (flax Dense semantics: the bias is
    added after the matmul, in the same dtype)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 compute_dtype=None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.weight = nn.Parameter(torch.zeros(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None

    def forward(self, x):
        cd = self.compute_dtype or x.dtype
        y = F.linear(x.to(cd), self.weight.to(cd))
        return y if self.bias is None else y + self.bias.to(cd)


class GridPoolBranch(nn.Module):
    """Pool multi-scale sparse features at the RoI grid points: a pre-MLP per
    scale, then per radius group a 2-layer MLP on (rel_pos, feature) and a
    masked max over the nsample neighbours. Its Dense layers are bf16, as
    the JAX module hard-codes them."""

    def __init__(self, scale_channels, grid_size: int = 6, nsample: int = 16,
                 mlp_channels: int = 32, scale_specs=SCALE_SPECS):
        super().__init__()
        self.grid_size = grid_size
        self.nsample = nsample
        self.scale_specs = scale_specs
        bf16 = torch.bfloat16
        for name, _, *groups in scale_specs:
            self.add_module(f"pre_{name}", _Dense(scale_channels[name], mlp_channels,
                                                  compute_dtype=bf16))
            for gi in range(len(groups)):
                self.add_module(f"mlp_{name}_{gi}", nn.Sequential(
                    _Dense(mlp_channels + 3, mlp_channels, compute_dtype=bf16), nn.ReLU(),
                    _Dense(mlp_channels, mlp_channels, compute_dtype=bf16), nn.ReLU()))

    def forward(self, rois, scale_features, query_results, suffix: str = ""):
        """-> (B, R, grid^3 * C_total) pooled features."""
        b, r = rois.shape[:2]
        per_scale = []
        for name, _, *groups in self.scale_specs:
            feats, _ = scale_features[name + suffix]
            pre = torch.relu(getattr(self, f"pre_{name}")(feats))
            for gi in range(len(groups)):
                idx, valid, rel = query_results[f"{name}_{gi}"]
                mlp = getattr(self, f"mlp_{name}_{gi}")
                per_scale.append(torch.stack([
                    pool.group_and_pool(p, i, v, rp, mlp)
                    for p, i, v, rp in zip(pre, idx, valid, rel)]))
        cat = torch.cat(per_scale, dim=-1)
        return cat.reshape(b, r, self.grid_size ** 3 * cat.shape[-1])


class FCTower(nn.Module):
    """Per hidden layer: Linear(no bias) in compute_dtype + masked BN (eps
    1e-5, momentum 0.1) + ReLU, and in training mode dropout after every
    non-final hidden layer; then an optional f32 output Linear with bias
    (``out_dim=None``: the shared tower)."""

    def __init__(self, in_features: int, hidden=(256, 256), out_dim=1, dropout: float = 0.3,
                 compute_dtype=torch.bfloat16):
        super().__init__()
        self.hidden = tuple(hidden)
        self.out_dim = out_dim
        self.dropout = dropout
        c = in_features
        for i, h in enumerate(self.hidden):
            self.add_module(f"fc{i}", _Dense(c, h, bias=False, compute_dtype=compute_dtype))
            self.add_module(f"bn{i}", MaskedBatchNorm(h, eps=1e-5, momentum=0.1))
            c = h
        if out_dim is not None:
            self.out = _Dense(c, out_dim)

    def forward(self, x, valid, generator=None):
        for i in range(len(self.hidden)):
            x = torch.relu(getattr(self, f"bn{i}")(getattr(self, f"fc{i}")(x), valid))
            if self.training and self.dropout > 0 and i < len(self.hidden) - 1:
                keep = torch.rand(x.shape, generator=generator, device=x.device) >= self.dropout
                x = torch.where(keep, x / (1.0 - self.dropout), 0.0)
        return x if self.out_dim is None else self.out(x.float())


class VoxelRCNNProtoHead(nn.Module):
    """Dual-branch RoI head with prototype distillation. Eval: pool, shared
    tower, cls/reg towers and decoded boxes on the proposals. Training: the
    proposals are sampled down to ``roi_per_image`` with targets, and with
    ``mm=True`` the same rois are pooled from the MM branch's features through
    a second pool branch and tower set (the proto outputs)."""

    def __init__(self, scale_grids, scale_channels, num_rois: int = 500,
                 roi_per_image: int = 130, grid_size: int = 6,
                 voxel_size=(0.1, 0.1, 0.15),
                 point_cloud_range=(-75.2, -75.2, -2.0, 75.2, 75.2, 4.0), mm: bool = True,
                 shared_fc: Tuple[int, ...] = (256, 256), dp_ratio: float = 0.3,
                 proto_ramp_steps: int = 5000, proto_weight: float = 0.2,
                 rcnn_proto_weight: float = 1.0, fg_ratio: float = 0.5, reg_fg_thresh=0.3,
                 cls_fg_thresh=0.6, cls_bg_thresh=0.02, cls_bg_thresh_lo: float = 0.01,
                 hard_bg_ratio: float = 0.1, cls_score_type: str = "roi_iou",
                 direction_min: float = 0.4, direction_max: float = 0.8,
                 enable_hard_sampling: bool = False, hard_sampling_thresh=0.3,
                 hard_sampling_ratio=0.3, mlp_channels: int = 32):
        super().__init__()
        self.scale_grids = scale_grids
        self.num_rois = num_rois
        self.roi_per_image = roi_per_image
        self.grid_size = grid_size
        self.voxel_size = tuple(voxel_size)
        self.point_cloud_range = tuple(point_cloud_range)
        self.mm = mm
        self.proto_ramp_steps = proto_ramp_steps
        self.proto_weight = proto_weight
        self.rcnn_proto_weight = rcnn_proto_weight
        self.target_cfg = dict(
            roi_per_image=roi_per_image, fg_ratio=fg_ratio, reg_fg_thresh=reg_fg_thresh,
            cls_fg_thresh=cls_fg_thresh, cls_bg_thresh=cls_bg_thresh,
            cls_bg_thresh_lo=cls_bg_thresh_lo, hard_bg_ratio=hard_bg_ratio,
            cls_score_type=cls_score_type, direction_min=direction_min,
            direction_max=direction_max, enable_hard_sampling=enable_hard_sampling,
            hard_sampling_thresh=hard_sampling_thresh,
            hard_sampling_ratio=hard_sampling_ratio)
        self.coder = ResidualCoder()
        pooled = grid_size ** 3 * mlp_channels * sum(len(g) for _, _, *g in SCALE_SPECS)
        for i in (0, 1) if mm else (0,):
            self.add_module("pool_branch" + ("_mm" if i else ""), GridPoolBranch(
                scale_channels, grid_size, mlp_channels=mlp_channels))
            self.add_module(f"shared{i}", FCTower(pooled, hidden=tuple(shared_fc), out_dim=None,
                                                  dropout=dp_ratio))
            self.add_module(f"cls_tower{i}", FCTower(shared_fc[-1], out_dim=1, dropout=dp_ratio))
            self.add_module(f"reg_tower{i}", FCTower(shared_fc[-1], out_dim=7, dropout=dp_ratio))

    def _branch(self, i, rois, roi_valid, scale_features, generator):
        """Pool + towers of branch ``i`` -> (shared, cls logits, reg)."""
        suffix = "_mm" if i else ""
        pool_branch = getattr(self, "pool_branch" + suffix)
        queries = compute_pool_queries(rois, scale_features, self.scale_grids,
                                       pool_branch.scale_specs, self.voxel_size,
                                       self.point_cloud_range, self.grid_size,
                                       pool_branch.nsample, suffix)
        pooled = pool_branch(rois, scale_features, queries, suffix)
        shared = getattr(self, f"shared{i}")(pooled, roi_valid, generator)
        cls = getattr(self, f"cls_tower{i}")(shared, roi_valid, generator)[..., 0]
        return shared, cls, getattr(self, f"reg_tower{i}")(shared, roi_valid, generator)

    def forward(self, proposals, backbone_out, batch=None, sampling_uniforms=None,
                generator=None):
        """In training mode ``batch`` supplies gt_boxes (B, N, 8), gt_valid and
        optionally css_score; ``sampling_uniforms`` ({name: (B, R)}, see
        ``draw_sampling_uniforms``) are drawn from ``generator`` when not
        given, as are the dropout masks."""
        train = self.training
        rois, roi_labels, roi_valid = (proposals[k] for k in ("rois", "roi_labels", "roi_valid"))
        targets = None
        if train:
            b, r = rois.shape[:2]
            if sampling_uniforms is None:
                sampling_uniforms = draw_sampling_uniforms(b, r, generator, rois.device)
            css = batch.get("css_score")
            if css is None:
                css = torch.ones_like(batch["gt_boxes"][..., 0])
            per_sample = [sample_rois_for_rcnn(
                {k: u[i] for k, u in sampling_uniforms.items()}, rois[i],
                proposals["roi_scores"][i], roi_labels[i], roi_valid[i], batch["gt_boxes"][i],
                batch["gt_valid"][i], css[i], **self.target_cfg) for i in range(b)]
            targets = {k: torch.stack([t[k] for t in per_sample]) for k in per_sample[0]}
            rois, roi_labels, roi_valid = (targets[k] for k in ("rois", "roi_labels", "valid"))
        scale_features = {k: (v[0], v[1]) for k, v in backbone_out.items()
                          if k.startswith(("x_conv3", "x_conv4"))}
        shared0, rcnn_cls, rcnn_reg = self._branch(0, rois, roi_valid, scale_features, generator)
        out = {"rcnn_cls": rcnn_cls, "rcnn_reg": rcnn_reg, "shared_features0": shared0,
               "rois": rois, "roi_labels": roi_labels, "roi_valid": roi_valid}
        if train:
            out["roi_targets"] = targets
            if self.mm and "x_conv3_mm" in backbone_out:
                shared1, cls1, reg1 = self._branch(1, rois, roi_valid, scale_features,
                                                   generator)
                out.update(rcnn_cls_proto=cls1, rcnn_reg_proto=reg1, shared_features1=shared1)
        else:
            out["batch_box_preds"] = decode_roi_boxes(rois, rcnn_reg, self.coder)
            out["batch_cls_preds"] = rcnn_cls[..., None]
        return out

    def get_loss(self, out, batch):
        """CSS-weighted rcnn losses + the proto block. ``batch["cur_it"]`` (a
        number or a 0-d tensor; default: the end of the ramp) drives the
        proto weight's ramp from 1e-5 to ``proto_weight``."""
        t = out["roi_targets"]
        rois = out["rois"]
        reg_targets, gt_local = encode_roi_targets(rois, t["gt_of_rois"], self.coder)
        css = t["css"]
        valid = t["valid"].float()
        reg_mask = t["reg_valid_mask"].float() * css
        reg_denom = torch.clamp(reg_mask.sum(), min=1.0)
        # cls: BCE on soft IoU labels, CSS-weighted for positives; -1 labels
        # (the interval band of the 'cls' label type) are ignored
        labelled = (t["cls_labels"] >= 0.0).float()
        cls_w = torch.where(t["reg_valid_mask"], css, 1.0) * valid * labelled
        cls_tgt = torch.clamp(t["cls_labels"], 0.0, 1.0)

        def cls_loss_fn(logits):
            bce = loss_utils.binary_cross_entropy_with_logits(logits, cls_tgt)
            return torch.sum(bce * cls_w) / torch.clamp(cls_w.sum(), min=1.0)

        def reg_loss_fn(reg_pred):
            l1 = loss_utils.weighted_smooth_l1_loss(reg_pred, reg_targets, reg_mask)
            decoded = decode_roi_boxes(rois, reg_pred, self.coder)
            corner = loss_utils.corner_loss_lidar(
                decoded.flatten(0, 1), t["gt_of_rois"][..., :7].flatten(0, 1),
                reg_mask.flatten())
            return l1.sum() / reg_denom + corner.sum() / reg_denom

        cls0 = cls_loss_fn(out["rcnn_cls"])
        reg0 = reg_loss_fn(out["rcnn_reg"])
        total = cls0 + reg0
        tb = {"rcnn_cls0": cls0, "rcnn_reg0": reg0}
        if "rcnn_cls_proto" in out:
            cls1 = cls_loss_fn(out["rcnn_cls_proto"])
            reg1 = reg_loss_fn(out["rcnn_reg_proto"])
            tb.update(rcnn_cls1=cls1, rcnn_reg1=reg1)
            # proto block: boxes decoded in the CANONICAL roi frame;
            #   b_loss0 = sum(bb(pred0, gt) * css * fg) / (fg.sum() + 1), unramped;
            #   b_loss1 = the same against the detached proto prediction,
            #             ramped TWICE (w * w);
            #   the cosine consistency, masked by (cls_label >= 0) * css, ramped once.
            anchor = _local_anchor(rois)
            fgf = t["reg_valid_mask"].float() * valid
            denom = fgf.sum() + 1.0
            # sanitize the INPUTS of masked rows (their decoded sizes can
            # overflow), then mask the output: see loss.sanitize_boxes
            p0 = loss_utils.sanitize_boxes(self.coder.decode(out["rcnn_reg"], anchor), fgf)
            p1 = loss_utils.sanitize_boxes(self.coder.decode(out["rcnn_reg_proto"], anchor), fgf)
            g0 = loss_utils.sanitize_boxes(gt_local, fgf)
            b_loss0 = torch.where(fgf > 0, loss_utils.bb_loss(p0, g0) * css * fgf,
                                  0.0).sum() / denom
            b_loss1 = torch.where(fgf > 0, loss_utils.bb_loss(p0, p1.detach()) * css * fgf,
                                  0.0).sum() / denom
            feat_cons = loss_utils.cosine_consistency_loss(
                out["shared_features0"], out["shared_features1"], mask=valid * labelled * css)
            it = batch.get("cur_it", float(self.proto_ramp_steps))
            ramp = torch.clamp(torch.as_tensor(it, dtype=torch.float32, device=rois.device)
                               / self.proto_ramp_steps, 0.0, 1.0)
            w = 1e-5 + ramp * (self.proto_weight - 1e-5)
            proto = b_loss0 + w * w * b_loss1 + w * feat_cons
            total = total + self.rcnn_proto_weight * (0.5 * (cls1 + reg1) + proto)
            tb["proto_loss"] = proto
        return total, tb
