"""Detection metrics: Waymo-style 3D AP/APH (L1/L2) and KITTI-style AP (port
of cpd_tpu/evaluation/ap.py, the same NumPy).

Replaces the reference's metric backends:
  - cpd/datasets/waymo_unsupervised/waymo_eval.py (official WOD TF graph,
    IoU 0.7/0.5/0.5, L2 = <=5 points or hard, Hungarian matching)
  - cpd/datasets/kitti/kitti_object_eval_python (numba 11/40-point AP)

This is an independent NumPy implementation of the same protocols (the
waymo-open-dataset package and numba are not available in this image):
rotated 3D IoU from the host-side polygon clipping oracle, per-frame
score-greedy matching (the standard AP matching; the official WOD Hungarian
matcher differs only in rare tie cases), 40-point interpolated AP, and APH
(precision weighted by heading accuracy 1 - |dyaw|/pi).
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


# ---------------------------------------------------------------------------
# rotated IoU (host NumPy; same construction as tests/oracles.py)
# ---------------------------------------------------------------------------

def _corners_bev(box):
    x, y, _, dx, dy, _, yaw = box[:7]
    local = np.array([[dx, dy], [-dx, dy], [-dx, -dy], [dx, -dy]]) / 2.0
    c, s = np.cos(yaw), np.sin(yaw)
    rot = np.array([[c, -s], [s, c]])
    return local @ rot.T + np.array([x, y])


def _clip(subject, clipper):
    def inside(p, a, b):
        return (b[0] - a[0]) * (p[1] - a[1]) - (b[1] - a[1]) * (p[0] - a[0]) >= -1e-12

    def inter(p1, p2, a, b):
        d1 = np.asarray(p2) - np.asarray(p1)
        d2 = np.asarray(b) - np.asarray(a)
        den = d1[0] * d2[1] - d1[1] * d2[0]
        if abs(den) < 1e-12:  # parallel/collinear edges: zero-area sliver
            return (np.asarray(p1) + np.asarray(p2)) / 2.0
        t = ((a[0] - p1[0]) * d2[1] - (a[1] - p1[1]) * d2[0]) / den
        return np.asarray(p1) + t * d1

    out = list(subject)
    for i in range(len(clipper)):
        a, b = clipper[i], clipper[(i + 1) % len(clipper)]
        inp, out = out, []
        if not inp:
            break
        s = inp[-1]
        for p in inp:
            if inside(p, a, b):
                if not inside(s, a, b):
                    out.append(inter(s, p, a, b))
                out.append(p)
            elif inside(s, a, b):
                out.append(inter(s, p, a, b))
            s = p
    return out


def _area(poly):
    if len(poly) < 3:
        return 0.0
    poly = np.asarray(poly)
    x, y = poly[:, 0], poly[:, 1]
    return 0.5 * abs(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))


def iou3d_pair(a, b):
    # cheap reject first
    if np.hypot(a[0] - b[0], a[1] - b[1]) > (np.hypot(a[3], a[4]) + np.hypot(b[3], b[4])) / 2:
        return 0.0
    o = _area(_clip(_corners_bev(a), _corners_bev(b)))
    if o <= 0:
        return 0.0
    zo = max(0.0, min(a[2] + a[5] / 2, b[2] + b[5] / 2) - max(a[2] - a[5] / 2, b[2] - b[5] / 2))
    inter = o * zo
    va, vb = a[3] * a[4] * a[5], b[3] * b[4] * b[5]
    return inter / max(va + vb - inter, 1e-6)


def iou_bev_pair(a, b):
    """Rotated BEV IoU (area overlap / area union) -- the official WOD
    TYPE_2D box type (waymo_eval2d.py:101 ``box_type: TYPE_2D``)."""
    if np.hypot(a[0] - b[0], a[1] - b[1]) > (np.hypot(a[3], a[4]) + np.hypot(b[3], b[4])) / 2:
        return 0.0
    o = _area(_clip(_corners_bev(a), _corners_bev(b)))
    if o <= 0:
        return 0.0
    aa, ab = a[3] * a[4], b[3] * b[4]
    return o / max(aa + ab - o, 1e-6)


def iou2d_pair(a, b):
    """Axis-aligned image-box IoU; boxes (x1, y1, x2, y2) (KITTI bbox AP)."""
    ix = max(0.0, min(a[2], b[2]) - max(a[0], b[0]))
    iy = max(0.0, min(a[3], b[3]) - max(a[1], b[1]))
    inter = ix * iy
    ua = (a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]) - inter
    return inter / max(ua, 1e-6)


_PAIR_FNS = {"3d": iou3d_pair, "bev": iou_bev_pair, "2d": iou2d_pair}


def iou_matrix(dets, gts, metric: str = "3d"):
    pair = _PAIR_FNS[metric]
    out = np.zeros((len(dets), len(gts)))
    for i, d in enumerate(dets):
        for j, g in enumerate(gts):
            out[i, j] = pair(d, g)
    return out


# ---------------------------------------------------------------------------
# matching + AP
# ---------------------------------------------------------------------------

def match_frame(det_boxes, det_scores, gt_boxes, iou_thresh, ignore_mask=None,
                matcher: str = "greedy", metric: str = "3d"):
    """One-to-one det/gt matching for one frame.

    ``matcher``:
      * ``"greedy"`` -- score-descending greedy (the standard AP matcher).
      * ``"hungarian"`` -- total-IoU-maximizing assignment over pairs with
        IoU >= thresh (the official WOD estimator's TYPE_HUNGARIAN,
        waymo_eval.py:178 / waymo_eval2d.py:95).
    ignore_mask: gts to exclude from the positive pool; a det matched to an
    ignored gt is neither TP nor FP. Returns (tp (D,), fp (D,), matched_gt (D,)).
    """
    d = len(det_boxes)
    g = len(gt_boxes)
    tp = np.zeros(d, bool)
    fp = np.zeros(d, bool)
    matched_gt = np.full(d, -1, np.int64)
    if g == 0:
        fp[:] = True
        return tp, fp, matched_gt
    iou = iou_matrix(det_boxes, gt_boxes, metric)
    ignore_mask = ignore_mask if ignore_mask is not None else np.zeros(g, bool)
    if matcher == "hungarian":
        from scipy.optimize import linear_sum_assignment

        gain = np.where(iou >= iou_thresh, iou, 0.0)
        if d and g:
            ri, cj = linear_sum_assignment(-gain)
            for i, j in zip(ri, cj):
                if iou[i, j] >= iou_thresh:
                    matched_gt[i] = j
                    if not ignore_mask[j]:
                        tp[i] = True
        fp[:] = (matched_gt < 0)
        return tp, fp, matched_gt
    taken = np.zeros(g, bool)
    order = np.argsort(-np.asarray(det_scores))
    for i in order:
        cand = np.where((iou[i] >= iou_thresh) & ~taken)[0]
        if len(cand) == 0:
            fp[i] = True
            continue
        j = cand[np.argmax(iou[i][cand])]
        taken[j] = True
        matched_gt[i] = j
        if ignore_mask[j]:
            pass  # neither TP nor FP
        else:
            tp[i] = True
    return tp, fp, matched_gt


def average_precision(scores, tp, fp, num_gt, weights=None, n_points: int = 40):
    """Interpolated AP over ``n_points`` recall positions.

    Recall-position protocols (kitti_object_eval_python/eval.py:561-572): the
    R40 grid EXCLUDES recall 0 (``get_mAP_R40`` sums sample points 1..40 of
    the 41-point grid -> linspace(1/40, 1, 40)); the legacy R11 grid INCLUDES
    it (``get_mAP`` sums points 0, 4, ..., 40 -> linspace(0, 1, 11), where
    the recall-0 term is the maximum precision overall).

    weights: per-det TP weight in [0,1] (APH heading accuracy); None = 1.
    """
    if num_gt == 0:
        return 0.0
    order = np.argsort(-np.asarray(scores))
    tp = np.asarray(tp, float)[order]
    fp = np.asarray(fp, float)[order]
    w = np.ones_like(tp) if weights is None else np.asarray(weights, float)[order]
    ctp = np.cumsum(tp * w)
    cfp = np.cumsum(fp)
    craw = np.cumsum(tp)
    recall = craw / num_gt
    precision = ctp / np.maximum(craw + cfp, 1e-9)
    start = 0.0 if n_points == 11 else 1.0 / n_points
    ap = 0.0
    for r in np.linspace(start, 1.0, n_points):
        mask = recall >= r
        ap += (precision[mask].max() if mask.any() else 0.0) / n_points
    return float(ap)


# ---------------------------------------------------------------------------
# Waymo-style evaluation
# ---------------------------------------------------------------------------

WAYMO_IOU = {"Vehicle": 0.7, "Pedestrian": 0.5, "Cyclist": 0.5}
# the official 2D (BEV) estimator's thresholds (waymo_eval2d.py:95-101)
WAYMO_IOU_BEV = {"Vehicle": 0.5, "Pedestrian": 0.3, "Cyclist": 0.3}


def waymo_style_eval(det_annos: List[dict], gt_annos: List[dict],
                     class_names: Sequence[str], matcher: str = "hungarian",
                     metric: str = "3d", iou_overrides: Dict = None,
                     key_suffix: str = ""):
    """AP/APH at L1/L2 per class (protocol of waymo_eval.py:86-108).

    ``matcher="hungarian"`` (default) matches the official WOD estimator's
    TYPE_HUNGARIAN; ``metric="bev"`` with WAYMO_IOU_BEV thresholds gives the
    waymo_eval2d protocol (see :func:`waymo_bev_eval`).

    det_annos[i]: {boxes_lidar (D, 7), score (D,), name (D,)}
    gt_annos[i]: {gt_boxes_lidar (G, 7[+]), name (G,), num_points_in_gt (G,),
                  difficulty (G,)}  (difficulty 2 or <=5 points -> L2-only)
    Returns (result_str, result_dict).
    """
    results = {}
    iou_table = iou_overrides or WAYMO_IOU
    for cls in class_names:
        iou_t = iou_table.get(cls, 0.5)
        all_scores, all_tp, all_fp, all_hacc = [], [], [], []
        # L1 pass: L2-only gts are "ignore"; L2 pass: all gts count
        l1_records = {"scores": [], "tp": [], "fp": [], "h": [], "ngt": 0}
        l2_records = {"scores": [], "tp": [], "fp": [], "h": [], "ngt": 0}
        for det, gt in zip(det_annos, gt_annos):
            dm = np.asarray(det["name"]) == cls
            dboxes = np.asarray(det["boxes_lidar"]).reshape(-1, 7)[dm]
            dscores = np.asarray(det["score"]).reshape(-1)[dm]
            gm = np.asarray(gt["name"]) == cls
            gboxes = np.asarray(gt["gt_boxes_lidar"]).reshape(-1, gt["gt_boxes_lidar"].shape[-1] if len(np.asarray(gt["gt_boxes_lidar"]).shape) > 1 else 7)[gm][:, :7]
            npts = np.asarray(gt.get("num_points_in_gt", np.full(gm.sum(), 100)))
            npts = npts[gm] if len(npts) == len(gm) else np.full(int(gm.sum()), 100)
            dif = np.asarray(gt.get("difficulty", np.zeros(int(gm.sum()))))
            dif = dif[gm] if len(dif) == len(gm) else np.zeros(int(gm.sum()))
            is_l2_only = (npts <= 5) | (dif == 2)
            for rec, ignore in ((l1_records, is_l2_only), (l2_records, np.zeros(len(gboxes), bool))):
                tp, fp, mg = match_frame(dboxes, dscores, gboxes, iou_t, ignore,
                                         matcher=matcher, metric=metric)
                # heading accuracy for APH
                h = np.ones(len(dboxes))
                for i in range(len(dboxes)):
                    if mg[i] >= 0 and tp[i]:
                        dy = abs(dboxes[i][6] - gboxes[mg[i]][6]) % (2 * np.pi)
                        dy = min(dy, 2 * np.pi - dy)
                        h[i] = max(0.0, 1.0 - dy / np.pi)
                rec["scores"].append(dscores)
                rec["tp"].append(tp)
                rec["fp"].append(fp)
                rec["h"].append(h)
                rec["ngt"] += int((~ignore).sum())
        for level, rec in (("L1", l1_records), ("L2", l2_records)):
            scores = np.concatenate(rec["scores"]) if rec["scores"] else np.zeros(0)
            tp = np.concatenate(rec["tp"]) if rec["tp"] else np.zeros(0, bool)
            fp = np.concatenate(rec["fp"]) if rec["fp"] else np.zeros(0, bool)
            h = np.concatenate(rec["h"]) if rec["h"] else np.zeros(0)
            ap = average_precision(scores, tp, fp, rec["ngt"])
            aph = average_precision(scores, tp, fp, rec["ngt"], weights=h)
            results[f"{cls}_{level}/AP{key_suffix}"] = ap * 100
            results[f"{cls}_{level}/APH{key_suffix}"] = aph * 100
    lines = [f"{k}: {v:.4f}" for k, v in sorted(results.items())]
    return "\n".join(lines), results


def waymo_bev_eval(det_annos, gt_annos, class_names, matcher: str = "hungarian"):
    """The waymo_eval2d protocol: BEV (TYPE_2D) boxes, Hungarian matching,
    IoU 0.5/0.3/0.3 (waymo_eval2d.py:87-111). Keys carry an ``_2D`` suffix."""
    return waymo_style_eval(det_annos, gt_annos, class_names, matcher=matcher,
                            metric="bev", iou_overrides=WAYMO_IOU_BEV,
                            key_suffix="_2D")


# ---------------------------------------------------------------------------
# KITTI-style evaluation
# ---------------------------------------------------------------------------

KITTI_IOU = {"Car": 0.7, "Vehicle": 0.7, "Pedestrian": 0.5, "Cyclist": 0.5}
# difficulty gates: (max truncation, max occlusion, min bbox height px)
KITTI_DIFFICULTY = {0: (0.15, 0, 40), 1: (0.3, 1, 25), 2: (0.5, 2, 25)}


# official clean_data similar-class rules (kitti_object_eval_python/eval.py:87)
KITTI_SIMILAR = {"Car": ("Van",), "Pedestrian": ("Person_sitting",)}
KITTI_IOU_BBOX = {"Car": 0.7, "Vehicle": 0.7, "Pedestrian": 0.5, "Cyclist": 0.5}

_CAMERA_KEYS = ("location", "dimensions", "rotation_y")


def camera_boxes_to_pseudo_lidar(loc, dims, ry):
    """Camera-rect boxes -> 7-dof boxes in a pseudo-lidar frame whose 3D/BEV
    IoU EQUALS the official camera-frame IoU (eval.py d3_box_overlap /
    bev_box_overlap: rotated overlap in the camera x-z plane, height overlap
    along y with the location at the box BOTTOM).

    The rigid map (x_l, y_l, z_l) = (z_c, -x_c, -y_c) sends the camera x-z
    plane to the lidar x-y plane and camera -y (up) to lidar +z; a rotation
    ``ry`` around +y_c becomes heading ``-ry - pi/2`` around +z_l (the box
    length axis x_c maps to -y_l). IoU is invariant under the rigid map, so
    :func:`iou3d_pair` / :func:`iou_bev_pair` on these boxes reproduce the
    official camera-frame overlaps exactly.

    loc (N, 3) camera rect, bottom center; dims (N, 3) = (l, w, h); ry (N,).
    """
    loc = np.asarray(loc, np.float64).reshape(-1, 3)
    dims = np.asarray(dims, np.float64).reshape(-1, 3)
    ry = np.asarray(ry, np.float64).reshape(-1)
    l, w, h = dims[:, 0], dims[:, 1], dims[:, 2]
    return np.stack([loc[:, 2], -loc[:, 0], -loc[:, 1] + h / 2.0,
                     l, w, h, -ry - np.pi / 2.0], axis=-1)


def _has_camera_fields(anno) -> bool:
    return all(k in anno for k in _CAMERA_KEYS)


def _anno_camera_boxes(anno, sel):
    loc = np.asarray(anno["location"]).reshape(-1, 3)[sel]
    dims = np.asarray(anno["dimensions"]).reshape(-1, 3)[sel]
    ry = np.asarray(anno["rotation_y"]).reshape(-1)[sel]
    return camera_boxes_to_pseudo_lidar(loc, dims, ry)


def _kitti_gt_ignore(gt, gm, dlevel, cls):
    """Per-gt ignore mask for one difficulty level, the official clean_data
    rules (eval.py:58-110): truncation/occlusion/bbox-height gates when the
    camera-protocol fields are present, else the precomputed 'difficulty'."""
    n = int(gm.sum())
    max_trunc, max_occ, min_h = KITTI_DIFFICULTY[dlevel]
    if "bbox" in gt and len(np.asarray(gt["bbox"]).reshape(-1, 4)) == len(gm):
        bbox = np.asarray(gt["bbox"]).reshape(-1, 4)[gm]
        trunc = np.asarray(gt.get("truncated", np.zeros(len(gm))))[gm]
        occ = np.asarray(gt.get("occluded", np.zeros(len(gm))))[gm]
        h = bbox[:, 3] - bbox[:, 1]
        return (trunc > max_trunc) | (occ > max_occ) | (h < min_h)
    dif = np.asarray(gt.get("difficulty", np.zeros(n)))
    dif = dif[gm] if len(dif) == len(gm) else np.zeros(n)
    return dif > dlevel


def kitti_style_eval(det_annos: List[dict], gt_annos: List[dict],
                     class_names: Sequence[str], n_points=40,
                     camera_frame_iou: bool = None):
    """AP per class x difficulty (protocol of kitti_object_eval_python
    eval.py:650 ``do_eval``): 3D and BEV AP, plus 2D bbox AP and AOS
    (orientation similarity over the 2D matching) when the camera-protocol
    fields (bbox (N, 4), alpha (N,)) are present in both the det and gt
    annotations. Similar classes (Van for Car, Person_sitting for
    Pedestrian) and sub-threshold gts are ignored, not counted.

    ``n_points``: recall-position protocol(s) -- 40 (R40), 11 (legacy R11,
    includes recall 0), or a sequence of both; matching runs once and each
    protocol's AP is reported under ``_R{n}`` keys (eval.py emits both).

    ``camera_frame_iou``: compute the 3D/BEV overlaps from the camera-frame
    fields (location/dimensions/rotation_y) exactly as the official eval's
    d3_box_overlap/bev_box_overlap do, instead of from the lidar-frame
    boxes. Default (None) auto-enables when both det and gt annos carry the
    camera fields (the real KITTI dataset path does).
    """
    results = {}
    names = ["easy", "moderate", "hard"]
    protocols = (n_points,) if isinstance(n_points, int) else tuple(n_points)
    have_bbox = (det_annos and gt_annos
                 and "bbox" in det_annos[0] and "bbox" in gt_annos[0])
    if camera_frame_iou is None:
        camera_frame_iou = (det_annos and gt_annos
                            and _has_camera_fields(det_annos[0])
                            and _has_camera_fields(gt_annos[0]))
    for cls in class_names:
        iou_t = KITTI_IOU.get(cls, 0.5)
        for dlevel in (0, 1, 2):
            recs = {m: {"s": [], "tp": [], "fp": [], "w": []}
                    for m in ("3d", "bev", "2d", "aos")}
            ngt = 0
            for det, gt in zip(det_annos, gt_annos):
                dm = np.asarray(det["name"]) == cls
                dscores = np.asarray(det["score"]).reshape(-1)[dm]
                gname = np.asarray(gt["name"])
                gm = gname == cls
                similar = np.isin(gname, KITTI_SIMILAR.get(cls, ()))
                gall = gm | similar
                if camera_frame_iou:
                    dboxes = _anno_camera_boxes(det, dm)
                    gboxes = (_anno_camera_boxes(gt, gall) if gall.any()
                              else np.zeros((0, 7)))
                else:
                    dboxes = np.asarray(det["boxes_lidar"]).reshape(-1, 7)[dm]
                    gboxes = (np.asarray(gt["gt_boxes_lidar"]).reshape(-1, 7)[gall]
                              if gall.any() else np.zeros((0, 7)))
                ignore = _kitti_gt_ignore(gt, gall, dlevel, cls)
                # similar-class gts are always ignore-matched
                ignore = ignore | similar[gall]
                ngt += int((~ignore).sum())
                for m in ("3d", "bev"):
                    tp, fp, _ = match_frame(dboxes, dscores, gboxes, iou_t,
                                            ignore, metric=m)
                    recs[m]["s"].append(dscores)
                    recs[m]["tp"].append(tp)
                    recs[m]["fp"].append(fp)
                if have_bbox:
                    d2 = np.asarray(det["bbox"]).reshape(-1, 4)[dm]
                    g2 = (np.asarray(gt["bbox"]).reshape(-1, 4)[gall]
                          if gall.any() else np.zeros((0, 4)))
                    t2 = KITTI_IOU_BBOX.get(cls, 0.5)
                    tp, fp, mg = match_frame(d2, dscores, g2, t2, ignore,
                                             metric="2d")
                    recs["2d"]["s"].append(dscores)
                    recs["2d"]["tp"].append(tp)
                    recs["2d"]["fp"].append(fp)
                    # AOS: (1 + cos(d_alpha)) / 2 on the 2D TPs (eval.py:325)
                    da = np.asarray(det.get("alpha", np.zeros(len(dm))))[dm]
                    ga = (np.asarray(gt.get("alpha", np.zeros(len(gname))))[gall]
                          if gall.any() else np.zeros(0))
                    w = np.zeros(len(dboxes))
                    for i in range(len(dboxes)):
                        if tp[i] and mg[i] >= 0:
                            w[i] = (1.0 + np.cos(da[i] - ga[mg[i]])) / 2.0
                    recs["aos"]["s"].append(dscores)
                    recs["aos"]["tp"].append(tp)
                    recs["aos"]["fp"].append(fp)
                    recs["aos"]["w"].append(w)
            for m, tag in (("3d", "3d"), ("bev", "bev"), ("2d", "bbox"),
                           ("aos", "aos")):
                if m in ("2d", "aos") and not have_bbox:
                    continue
                s = np.concatenate(recs[m]["s"]) if recs[m]["s"] else np.zeros(0)
                tp = np.concatenate(recs[m]["tp"]) if recs[m]["tp"] else np.zeros(0, bool)
                fp = np.concatenate(recs[m]["fp"]) if recs[m]["fp"] else np.zeros(0, bool)
                w = (np.concatenate(recs[m]["w"])
                     if m == "aos" and recs[m]["w"] else None)
                for np_ in protocols:
                    results[f"{cls}_{tag}/{names[dlevel]}_R{np_}"] = (
                        average_precision(s, tp, fp, ngt, weights=w,
                                          n_points=np_) * 100
                    )
    lines = [f"{k}: {v:.4f}" for k, v in sorted(results.items())]
    return "\n".join(lines), results


def recall_stats(det_annos, gt_annos, thresh_list=(0.3, 0.5, 0.7)):
    """Recall of detections vs gt at several IoU thresholds
    (detector3d_template.py:344-386 recall counters, eval_utils.py:94-101).

    Class-agnostic, score-ignoring: measures whether any detection covers
    each gt. Returns {'recall_0.3': ..., 'gt_count': N}.
    """
    hits = {t: 0 for t in thresh_list}
    total_gt = 0
    for det, gt in zip(det_annos, gt_annos):
        gboxes = np.asarray(gt["gt_boxes_lidar"]).reshape(-1, 7)
        dboxes = np.asarray(det["boxes_lidar"]).reshape(-1, 7)
        total_gt += len(gboxes)
        if len(gboxes) == 0 or len(dboxes) == 0:
            continue
        iou = iou_matrix(dboxes, gboxes)
        best = iou.max(axis=0)
        for t in thresh_list:
            hits[t] += int((best >= t).sum())
    out = {f"recall_{t}": (hits[t] / total_gt if total_gt else 0.0) for t in thresh_list}
    out["gt_count"] = total_gt
    return out
