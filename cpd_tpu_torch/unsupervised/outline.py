"""Outline fitting toolbox: clustering, min-area boxes, refinement primitives
(port of cpd_tpu/unsupervised/outline.py, the same NumPy/SciPy).

Parity with cpd/unsupervised_core/outline_utils.py (1.2k LoC): DBSCAN
clustering (:789), minimum bounding rectangle via rotating calipers
(:609,:703), density_guided_drift (:41), corner_align (:94),
correct_orientation (:127), correct_heading (:444), voxel_sampling (:368),
smooth_points (:391), hierarchical occupancy score (:438 MLO),
KL_entropy_score (:25), size-prior classification get_box_cls (:891),
box_fit / box_fit_DGD (:809,:848).

DBSCAN runs through kernel R2 (``ops.dbscan.dbscan_labels``) on the CUDA
card, on the CPU through its plain version when ``device="cpu"`` is asked
for: both give sklearn's labels, which the JAX package takes from sklearn
where it is installed. ``clustering_batched`` clusters many clouds in one
call of the kernel (``dbscan_labels_batched``), each alone. ``voxel_sampling`` keeps the same points as JAX's
row-wise ``np.unique`` through one scalar key per voxel.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch
from scipy.spatial import ConvexHull, cKDTree

from ..ops.dbscan import dbscan_labels, dbscan_labels_batched
from ..utils.device import resolve_device

# size priors (meters, l/w/h) per class -- the commonsense sizes CPD uses
PREDEFINED_SIZE = {
    "Vehicle": (4.7, 2.1, 1.7),
    "Pedestrian": (0.91, 0.86, 1.73),
    "Cyclist": (1.78, 0.84, 1.78),
}
CLASS_IDS = {"Vehicle": 1, "Pedestrian": 2, "Cyclist": 3}


# ---------------------------------------------------------------------------
# clustering
# ---------------------------------------------------------------------------

def dbscan_cluster(points: np.ndarray, eps: float = 0.7, min_samples: int = 10, device=None):
    """Density clustering on xyz: returns labels (N,), -1 = noise: sklearn's
    labels (the reference uses sklearn, outline_utils.py:789), from kernel R2
    on ``device`` (default: the CUDA card)."""
    if len(points) == 0:
        return np.zeros((0,), np.int32)
    xyz = torch.from_numpy(np.ascontiguousarray(points[:, :3], np.float64))
    return dbscan_labels(xyz.to(resolve_device(device)), eps, min_samples).cpu().numpy()


def clustering(points: np.ndarray, eps: float = 0.7, min_samples: int = 10,
               min_points: int = 10, max_height: float = 4.0, device=None) -> List[np.ndarray]:
    """Cluster non-ground points into object candidates
    (OutlineFitter.clustering, outline_utils.py:789): DBSCAN core size is
    ``min_samples`` (the reference fixes it at 10 regardless of config);
    clusters are kept when STRICTLY more than ``min_points``
    (clutter_min_points) points AND the cluster's ABSOLUTE max z is below
    ``max_height`` (discard_max_height gates z, not vertical extent). DBSCAN
    runs on ``device`` (default: the CUDA card)."""
    return _kept_clusters(points, dbscan_cluster(points, eps, min_samples, device), min_points,
                          max_height)


def clustering_batched(clouds: List[np.ndarray], eps: float = 0.7, min_samples: int = 10,
                       min_points: int = 10, max_height: float = 4.0,
                       device=None) -> List[List[np.ndarray]]:
    """``[clustering(c, eps, min_samples, min_points, max_height, device) for
    c in clouds]`` with one DBSCAN call for all the clouds
    (``dbscan_labels_batched``: each cloud is clustered alone)."""
    lengths = [len(c) for c in clouds]
    if not sum(lengths):
        return [[] for _ in clouds]
    xyz = torch.from_numpy(np.concatenate(
        [np.asarray(c, np.float64)[:, :3].reshape(-1, 3) for c in clouds]))
    offsets = np.concatenate([[0], np.cumsum(lengths)])
    labels = dbscan_labels_batched(xyz.to(resolve_device(device)), offsets, eps,
                                   min_samples).cpu().numpy()
    return [_kept_clusters(c, labels[a:b], min_points, max_height)
            for c, a, b in zip(clouds, offsets[:-1], offsets[1:])]


def _kept_clusters(points, labels, min_points, max_height):
    out = []
    for cid in range(labels.max() + 1 if len(labels) else 0):
        m = labels == cid
        if m.sum() <= min_points:
            continue
        pts = points[m]
        if pts[:, 2].max() >= max_height:
            continue
        out.append(pts)
    return out


# ---------------------------------------------------------------------------
# minimum-area rectangle (rotating calipers on the convex hull)
# ---------------------------------------------------------------------------

def minimum_bounding_rectangle(xy: np.ndarray, criterion: str = "area"):
    """Min bounding rect of 2D points.

    criterion 'area' = classic min-area; 'distance' = the reference's
    edge-distance objective (minimum_bounding_rectangle_distance,
    outline_utils.py:703) preferring rectangles whose edges hug the points
    (better for L-shaped vehicle observations).
    Returns (center (2,), (l, w), yaw).
    """
    xy = np.asarray(xy, np.float64)
    if len(xy) == 1:
        return xy[0], (0.1, 0.1), 0.0
    if len(xy) == 2:
        d = xy[1] - xy[0]
        return xy.mean(0), (max(np.linalg.norm(d), 0.1), 0.1), float(np.arctan2(d[1], d[0]))
    try:
        hull = ConvexHull(xy)
        hp = xy[hull.vertices]
    except Exception:
        # degenerate (collinear): PCA direction
        c = xy.mean(0)
        u, s, vt = np.linalg.svd(xy - c)
        yaw = float(np.arctan2(vt[0, 1], vt[0, 0]))
        proj = (xy - c) @ vt.T
        return c, (max(np.ptp(proj[:, 0]), 0.1), max(np.ptp(proj[:, 1]), 0.1)), yaw

    # consecutive hull edges only -- the reference's candidate-angle set
    # EXCLUDES the closing edge (outline_utils.py:663,713 hull[1:]-hull[:-1])
    edges = hp[1:] - hp[:-1]
    angles = np.unique(np.mod(np.arctan2(edges[:, 1], edges[:, 0]), np.pi / 2))
    cands = []
    areas, dists = [], []
    for ang in angles:
        c, s = np.cos(-ang), np.sin(-ang)
        rot = np.array([[c, -s], [s, c]])
        r = hp @ rot.T
        mins, maxs = r.min(0), r.max(0)
        dims = maxs - mins
        area = dims[0] * dims[1]
        d_edges = np.stack([
            r[:, 0] - mins[0], maxs[0] - r[:, 0],
            r[:, 1] - mins[1], maxs[1] - r[:, 1],
        ], axis=1)
        edge_dist = np.mean(np.min(d_edges, axis=1))
        center = ((mins + maxs) / 2) @ rot  # rotate back
        cands.append((center, dims, ang))
        areas.append(area)
        dists.append(edge_dist)
    areas = np.asarray(areas)
    dists = np.asarray(dists)
    if criterion == "area":
        cost = areas
    else:
        # min-max normalize both objectives across candidate angles, then sum
        # (the reference's edge-hugging objective, outline_utils.py:663-686)
        a = (areas - areas.min()) / (np.ptp(areas) + 1e-4)
        d = (dists - dists.min()) / (np.ptp(dists) + 1e-4)
        cost = a + d
    center, dims, ang = cands[int(np.argmin(cost))]
    if dims[0] < dims[1]:  # force l >= w, rotate 90 deg
        dims = dims[::-1]
        ang = ang + np.pi / 2
    return center, (float(max(dims[0], 0.05)), float(max(dims[1], 0.05))), float(ang)


# ---------------------------------------------------------------------------
# box fitting + refinement primitives
# ---------------------------------------------------------------------------

def box_fit(cluster: np.ndarray, criterion: str = "distance") -> np.ndarray:
    """Fit a 7-dof box to a cluster (OutlineFitter.get_obj, outline_utils.py:761).

    The reference fits the rectangle on (y, x)-SWAPPED coordinates
    (get_obj:763-766). The swap mirrors the convex hull, which REVERSES the
    hull traversal order -- and since the candidate-angle set excludes the
    closing edge, the mirrored hull excludes a DIFFERENT physical edge.
    Replicating the swap keeps the candidate sets (and near-tie argmins of
    the fit objective) bit-identical with the reference."""
    center_sw, (l, w), yaw_sw = minimum_bounding_rectangle(
        cluster[:, [1, 0]], criterion)
    center_xy = (center_sw[1], center_sw[0])
    yaw = np.pi / 2.0 - yaw_sw  # mirror across y=x maps angle t -> pi/2 - t
    zmin, zmax = cluster[:, 2].min(), cluster[:, 2].max()
    h = max(zmax - zmin, 0.1)
    return np.array([center_xy[0], center_xy[1], (zmin + zmax) / 2, l, w, h, yaw], np.float32)


def fit_gated_box(cluster: np.ndarray, criterion: str = "distance",
                  offset: float = 0.2,
                  ground_adjust: Tuple[float, float] = (0.2, 20.0),
                  min_box_volume: float = 0.1, min_box_height: float = 0.3,
                  max_box_volume: float = 200.0, max_box_len: float = 10.0
                  ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """The reference's per-cluster fit preamble, shared by box_fit and
    box_fit_DGD (outline_utils.py:809-889): drop points within ``offset`` of
    the cluster floor, fit, stretch the box back down by ``offset``; boxes
    closer than ``ground_adjust[1]`` to the sensor get a further
    ``ground_adjust[0]`` downward stretch (the near-field ground band that
    remove_ground carved off); gate on volume / height / length; force
    l >= w (yaw += pi/2). Returns None when the hull fails (the reference's
    try/except skip) or a gate rejects the box."""
    pts = cluster[cluster[:, 2] > cluster[:, 2].min() + offset]
    if len(pts) < 3:
        return None
    try:
        ConvexHull(pts[:, :2])
    except Exception:
        return None
    box = np.asarray(box_fit(pts, criterion), np.float64)
    box[2] -= offset / 2.0
    box[5] += offset
    if np.linalg.norm(box[0:3]) < ground_adjust[1]:
        box[2] -= ground_adjust[0] / 2.0
        box[5] += ground_adjust[0]
    volume = box[3] * box[4] * box[5]
    if not (min_box_volume < volume < max_box_volume
            and box[5] > min_box_height and max(box[3], box[4]) < max_box_len):
        return None
    if box[3] < box[4]:  # force l >= w (outline_utils.py:875-879)
        box[3], box[4] = box[4], box[3]
        box[6] += np.pi / 2.0
    return box, pts


def density_guided_drift(box: np.ndarray, cluster: np.ndarray,
                         size_prior: Optional[Tuple[float, float]] = None) -> np.ndarray:
    """Shift the box center along its axes so the far (occluded) side extends
    away from the densely observed side (outline_utils.py:41).

    LiDAR sees the near faces; when a size prior enlarges the box, the extra
    extent should grow AWAY from the sensor-facing observed surface.
    """
    box = np.asarray(box, np.float64).copy()
    if size_prior is not None:
        # the reference applies the prototype size BEFORE drifting
        # (c_proto_refine.py:465 passes the size-updated new_box)
        box[3], box[4] = size_prior
    l, w = box[3], box[4]
    c, s = np.cos(box[6]), np.sin(box[6])
    rel = cluster[:, :2] - box[:2]
    local_x = rel[:, 0] * c + rel[:, 1] * s
    local_y = -rel[:, 0] * s + rel[:, 1] * c
    # majority-sign anchoring (outline_utils.py:73-86): if more than half the
    # points sit on an axis's positive side, that face is the observed one --
    # pin it at the max point coordinate; otherwise pin the negative face at
    # the min. Center-only shift; dims stay as set above.
    shift = np.zeros(2)
    for axis, vals, dim in ((0, local_x, l), (1, local_y, w)):
        if (vals > 0).sum() / max(vals.shape[0], 1) > 0.5:
            shift[axis] = vals.max() - dim / 2
        else:
            shift[axis] = vals.min() + dim / 2
    box[0] += shift[0] * c - shift[1] * s
    box[1] += shift[0] * s + shift[1] * c
    return box.astype(np.float32)


def corner_align(box: np.ndarray, new_l: float, new_w: float) -> np.ndarray:
    """Resize the box keeping its nearest-to-sensor corner fixed
    (outline_utils.py:94 / oyster.py:89)."""
    box = box.copy()
    c, s = np.cos(box[6]), np.sin(box[6])
    # corners in local frame
    sx = np.array([1, 1, -1, -1]) * box[3] / 2
    sy = np.array([1, -1, 1, -1]) * box[4] / 2
    cx = box[0] + sx * c - sy * s
    cy = box[1] + sx * s + sy * c
    d = np.hypot(cx, cy)
    k = int(np.argmin(d))
    # keep corner k fixed while changing dims
    new_sx = np.sign(sx[k]) * new_l / 2
    new_sy = np.sign(sy[k]) * new_w / 2
    new_cx = cx[k] - (new_sx * c - new_sy * s)
    new_cy = cy[k] - (new_sx * s + new_sy * c)
    box[0], box[1], box[3], box[4] = new_cx, new_cy, new_l, new_w
    return box


def _slice_extreme_mean(pts, axis: int, lo: float, delta: float, parts: int,
                        other_axis: int, take_max: bool):
    """Mean of each non-empty slice's extreme-other-axis point
    (outline_utils.py:168-193 inner loops): slice ``axis`` into ``parts``
    bins of width ``delta`` starting at ``lo`` (bin i = (lo+i*d, lo+(i+1)*d]),
    pick the arg-max (or arg-min) point along ``other_axis`` per bin."""
    picks = []
    for i in range(parts):
        m = (pts[:, axis] > lo + i * delta) & (pts[:, axis] <= lo + (i + 1) * delta)
        sel = pts[m]
        if len(sel):
            j = np.argmax(sel[:, other_axis]) if take_max else np.argmin(sel[:, other_axis])
            picks.append(sel[j])
    if not picks:
        return None
    return np.mean(np.asarray(picks), 0)


def correct_orientation(box: np.ndarray, cluster: np.ndarray) -> np.ndarray:
    """Refine yaw from the observed long edge (outline_utils.py:127, exact):
    in the box's local frame, split the dominant-spread axis at its midpoint;
    per half, slice into 7 bins and collect each bin's extreme point toward
    the side most points sit on; the yaw correction is the arctan slope
    between the two halves' mean extreme points."""
    box = np.asarray(box, np.float64).copy()
    rel = cluster[:, :2] - box[:2]
    c, s = np.cos(box[6]), np.sin(box[6])
    pts = np.stack([rel[:, 0] * c + rel[:, 1] * s,
                    -rel[:, 0] * s + rel[:, 1] * c], axis=1)
    min_x, max_x = pts[:, 0].min(), pts[:, 0].max()
    min_y, max_y = pts[:, 1].min(), pts[:, 1].max()
    parts = 7
    if ((max_x - min_x) / box[3]) * 2 > (max_y - min_y) / box[4]:
        mid = (max_x - min_x) / 2.0 + min_x
        top, bot = pts[pts[:, 0] > mid], pts[pts[:, 0] < mid]
        delta = (max_x - mid) / parts
        take_max = (pts[:, 1] > 0).sum() / len(pts) > 0.5
        t = _slice_extreme_mean(top, 0, mid, delta, parts, 1, take_max)
        b = _slice_extreme_mean(bot, 0, min_x, delta, parts, 1, take_max)
        if t is not None and b is not None:
            box[6] += np.arctan((t[1] - b[1]) / (t[0] - b[0]))
    else:
        mid = (max_y - min_y) / 2.0 + min_y
        top, bot = pts[pts[:, 1] > mid], pts[pts[:, 1] < mid]
        delta = (max_y - mid) / parts
        take_max = (pts[:, 0] > 0).sum() / len(pts) > 0.5
        t = _slice_extreme_mean(top, 1, mid, delta, parts, 0, take_max)
        b = _slice_extreme_mean(bot, 1, min_y, delta, parts, 0, take_max)
        if t is not None and b is not None:
            box[6] += np.arctan((t[0] - b[0]) / (t[1] - b[1]))
    return box


def correct_heading(box: np.ndarray, cluster: np.ndarray, parts: int = 10) -> np.ndarray:
    """Resolve the front/back 180-deg ambiguity from the per-slice z profile
    (outline_utils.py:444): split the box into ``parts`` longitudinal slices;
    collect each non-empty slice's max z into the rear set (slice lower bound
    < 0) and front set (upper bound > 0); flip when the rear mean is lower
    (vehicle fronts/hoods are lower than rears)."""
    box = box.copy()
    rel = cluster[:, :3] - box[:3]
    c, s = np.cos(box[6]), np.sin(box[6])
    lx = rel[:, 0] * c + rel[:, 1] * s
    lz = rel[:, 2]
    l = box[3]
    delta = l / parts
    z_rear, z_front = [], []
    for i in range(parts):
        lo = -l / 2 + i * delta
        hi = lo + delta
        m = (lx >= lo) & (lx < hi)
        if m.any():
            zmax = float(lz[m].max())
            if lo < 0:
                z_rear.append(zmax)
            if hi > 0:
                z_front.append(zmax)
    if not z_front:
        z_front.append(0.0)
    if not z_rear:
        z_rear.append(0.0)
    if np.mean(z_rear) < np.mean(z_front):
        box[6] += np.pi
    return box


def box_fit_DGD(cluster: np.ndarray, **gate_kw) -> Optional[np.ndarray]:
    """MFCF's fit (outline_utils.py:848): gated min-rect (distance
    criterion), then density-guided drift -> orientation -> heading
    correction, each on the floor-filtered points (that exact order).
    Returns None when the fit preamble rejects the cluster."""
    fitted = fit_gated_box(cluster, criterion="distance", **gate_kw)
    if fitted is None:
        return None
    box, pts = fitted
    box = density_guided_drift(box, pts)
    box = correct_orientation(box, pts)
    box = correct_heading(box, pts)
    return box


# ---------------------------------------------------------------------------
# sampling / smoothing / scoring
# ---------------------------------------------------------------------------

def voxel_sampling(points: np.ndarray, voxel: float = 0.1) -> np.ndarray:
    """Deduplicate points on a voxel grid, keeping the LAST point of each
    voxel in input order (outline_utils.py:368 dict-overwrite semantics);
    grid origin at the cloud minimum. One int64 key a voxel stands for JAX's
    ``np.unique(..., axis=0)`` of the rows: the same first occurrences of the
    reversed cloud, so the same points in the same order."""
    if len(points) == 0:
        return points
    keys = np.floor((points[:, :3] - points[:, :3].min(0)) / voxel).astype(np.int64)
    n = len(points)
    dims = keys.max(0) + 1
    if float(dims[0]) * float(dims[1]) * float(dims[2]) < 2.0 ** 62:
        flat = (keys[:, 0] * dims[1] + keys[:, 1]) * dims[2] + keys[:, 2]
        _, idx = np.unique(flat[::-1], return_index=True)
    else:
        _, idx = np.unique(keys[::-1], axis=0, return_index=True)
    return points[np.sort(n - 1 - idx)]


def smooth_points(points: np.ndarray, rad: float = 0.2) -> np.ndarray:
    """Radius density outlier removal (outline_utils.py:391): keep points
    with more than 3 neighbors (self included) within ``rad``."""
    if len(points) == 0:
        return points
    tree = cKDTree(points[:, :3])
    num = tree.query_ball_point(points[:, :3], r=rad, return_length=True)
    return points[num > 3]


def compute_occupancy(points: np.ndarray, box: np.ndarray, parts: int) -> float:
    """Fraction of BEV cells over the box holding >= 2 points
    (outline_utils.py:398 compute_confidence: ``len(this_pts) > 1``)."""
    if len(points) == 0:
        return 0.0
    rel = points[:, :2] - box[:2]
    c, s = np.cos(box[6]), np.sin(box[6])
    lx = rel[:, 0] * c + rel[:, 1] * s
    ly = -rel[:, 0] * s + rel[:, 1] * c
    gx = np.floor((lx / max(box[3], 1e-3) + 0.5) * parts).astype(int)
    gy = np.floor((ly / max(box[4], 1e-3) + 0.5) * parts).astype(int)
    ok = (gx >= 0) & (gx < parts) & (gy >= 0) & (gy < parts)
    cell = gx[ok] * parts + gy[ok]
    _, counts = np.unique(cell, return_counts=True)
    return int((counts > 1).sum()) / (parts * parts)


def hierarchical_occupancy_score(points: np.ndarray, box: np.ndarray,
                                 parts=(7, 5, 3)) -> float:
    """Multi-Level Occupancy (MLO) score (outline_utils.py:438): mean
    occupancy over several grid resolutions (CSS passes MLOParts (9, 7, 5))."""
    return float(np.mean([compute_occupancy(points, box, p) for p in parts]))


def KL_entropy_score(x: np.ndarray, y: np.ndarray, max_dif: float = 0.05) -> float:
    """Size-prior agreement score (outline_utils.py:25): KL(x || y) of the
    NORMALIZED size vectors, capped at ``max_dif`` and mapped to [0, 1]."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    kl = float(np.sum(x * np.log(x / y)))
    kl = min(kl, max_dif)
    return (max_dif - kl) / max_dif


def distance_score(box: np.ndarray, max_dist: float = 80.0) -> float:
    """Nearer objects are observed better (c_proto_refine.py:23-27: 3D center
    norm against CSSConfig.MaxDis)."""
    d = float(np.linalg.norm(box[0:3]))
    return 1.0 - min(d, max_dist) / max_dist


# per-class (low, high] size bands -- the reference's shipped tables
# (waymo_unsupervised_cproto.yaml GeneratorConfig.cls_L/W/H)
CLS_L = {"Dis_Small": (0.0, 12.0), "Vehicle": (0.5, 8.0),
         "Pedestrian": (0.2, 1.0), "Cyclist": (1.3, 2.5),
         "Dis_Large": (0.0, 12.0)}
CLS_W = {"Dis_Small": (0.0, 12.0), "Vehicle": (0.5, 3.0),
         "Pedestrian": (0.2, 1.0), "Cyclist": (0.5, 1.0),
         "Dis_Large": (0.0, 12.0)}
CLS_H = {"Dis_Small": (0.0, 0.8), "Vehicle": (1.0, 3.0),
         "Pedestrian": (0.8, 2.3), "Cyclist": (1.4, 2.0),
         "Dis_Large": (3.0, 12.0)}


def get_box_cls(box: np.ndarray, n_points: int = 100,
                max_top_z: float = 3.0, max_width: float = 3.0,
                max_len: float = 12.0) -> str:
    """Size-band classification, the reference's exact tables and CHECK
    ORDER (outline_utils.py:891-957 / :1066-1121): the top-z/width/length
    Dis_Large gate first, then Dis_Small -> Pedestrian -> Cyclist -> Vehicle
    -> Dis_Large bands ((low, high] on each of l/h/w), else Dis_Small.
    ``n_points`` is accepted for caller compatibility and unused (the
    reference classifies by size only)."""
    l, w, h = float(box[3]), float(box[4]), float(box[5])
    top_z = float(box[2]) + h / 2.0

    def in_band(cls):
        return (CLS_L[cls][0] < l <= CLS_L[cls][1]
                and CLS_H[cls][0] < h <= CLS_H[cls][1]
                and CLS_W[cls][0] < w <= CLS_W[cls][1])

    if top_z > max_top_z or w > max_width or l > max_len:
        return "Dis_Large"
    for cls in ("Dis_Small", "Pedestrian", "Cyclist", "Vehicle", "Dis_Large"):
        if in_band(cls):
            return cls
    return "Dis_Small"


def drop_cls(names: np.ndarray, keep=("Vehicle", "Pedestrian", "Cyclist")):
    return np.array([n in keep for n in names], bool)


# rigid transforms shared with the tracker/refiner
def points_rigid_transform(points, pose):
    from .ppscore import points_rigid_transform as f

    return f(points, pose)


def get_registration_angle(pose: np.ndarray) -> float:
    """Yaw of a 4x4 pose (outline_utils.py:340)."""
    return float(np.arctan2(pose[1, 0], pose[0, 0]))


def box_rigid_transform(boxes: np.ndarray, pose: np.ndarray) -> np.ndarray:
    """Apply a 4x4 pose to (N, 7+) boxes (centers + yaw; sizes invariant)."""
    if len(boxes) == 0:
        return boxes
    out = boxes.copy()
    out[:, :3] = points_rigid_transform(boxes[:, :3], pose)[:, :3]
    out[:, 6] += get_registration_angle(pose)
    return out
