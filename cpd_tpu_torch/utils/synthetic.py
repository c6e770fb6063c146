"""Lidar-realistic synthetic frames for benchmarks and cap audits.

A spinning lidar samples the world on a (beam elevation) x (azimuth step)
grid: ~64 beams, ~2650 azimuth steps/rev. Two consequences matter for
sparse-voxel occupancy statistics:

* Ground returns form RINGS (one per downward beam, radius h/tan(-elev))
  of azimuth-contiguous points -- at 0.1 m voxels, consecutive samples land
  in the same or adjacent voxels, so downsampling DILATES the active set
  far less than independently-scattered points would (a strided 3^3/s2
  sparse conv maps an isolated voxel to up to 8 output cells, but a
  contiguous arc only to ~arc/2 + 1 cells per level).
* Surfaces (object faces, walls) are sampled on contiguous az x elev
  patches, not salt-and-pepper.

An earlier version of this generator drew ground azimuth i.i.d. uniform;
that inflated the measured down2 occupancy ABOVE the stage-0 count
(>160k from 126k occupied), which no real frame does (reference Waymo
profiles have x_conv2 ~= 0.8x x_conv1). Benchmarks and cap audits built on
that model would force oversized caps. Beam-structured sampling restores
realistic dilation; the cap audit in bench.py is calibrated against it.

Geometry is Waymo-flavored: range +-75 m, sensor at z ~= 2 m, ground at
z ~= 0, objects are car/pedestrian/cyclist-sized boxes with points on
their lidar-visible faces.
"""
from __future__ import annotations

import numpy as np

SENSOR_H = 2.0          # Waymo roof lidar height (m)
AZ_STEPS = 2650         # azimuth samples per revolution (~0.136 deg)


def _ground_rings(rng, n_ground, r_min, r_max):
    """Beam-structured ground returns: one ring per downward beam.

    Beam elevations are spaced uniformly in angle (real top lidars are
    denser near the horizon -- approximated by uniform + the natural
    1/tan radius crowding at far range). Each ring carries a full
    azimuth-contiguous revolution; the beam count is chosen so the total
    matches the budget.
    """
    # rings out to r_max: elevation from steep (-35 deg) to graze
    graze = np.arctan(SENSOR_H / r_max)
    n_beams = max(4, int(np.ceil(n_ground / AZ_STEPS)))
    elev = np.linspace(np.deg2rad(35.0), graze, n_beams)  # downward angles
    radii = SENSOR_H / np.tan(elev)
    radii = np.clip(radii, r_min, r_max)
    az = (np.arange(AZ_STEPS) + 0.5) / AZ_STEPS * 2 * np.pi
    pts = []
    budget = n_ground
    for r0 in radii:
        c = min(AZ_STEPS, budget)
        if c <= 0:
            break
        budget -= c
        a = az[:c] + rng.uniform(0, 2 * np.pi)  # random ring phase
        rr = r0 + rng.normal(0, 0.03, c)        # range noise
        gx = rr * np.cos(a)
        gy = rr * np.sin(a)
        gz = (0.01 * gx + 0.02 * np.sin(gy * 0.05)
              + rng.normal(0, 0.03, c))
        pts.append(np.stack([gx, gy, gz], axis=1))
    out = np.concatenate(pts, axis=0) if pts else np.zeros((0, 3))
    if out.shape[0] < n_ground:  # pad by resampling (budget overrun guard)
        extra = out[rng.integers(0, max(out.shape[0], 1), n_ground - out.shape[0])]
        out = np.concatenate([out, extra], axis=0)
    return out[:n_ground]


def _surface_patch(rng, origin_xy, normal_az, width, height, r, count,
                   z0=0.0):
    """Points on a vertical surface patch sampled on the az x elev scan grid.

    Horizontal sample spacing at range r is r * (2pi / AZ_STEPS); vertical
    spacing is r * beam spacing (~0.33 deg). The patch is filled in
    contiguous scan order and truncated to ``count``.
    """
    haz = r * (2 * np.pi / AZ_STEPS)            # horizontal step (m)
    hel = r * np.deg2rad(0.33)                  # vertical step (m)
    nu = max(2, int(width / max(haz, 1e-3)))
    nv = max(2, int(height / max(hel, 1e-3)))
    u = (np.arange(nu) - nu / 2) * haz
    v = z0 + (np.arange(nv) + 0.5) * hel
    uu, vv = np.meshgrid(u, v, indexing="ij")
    uu = uu.ravel()[:count]
    vv = vv.ravel()[:count]
    c = uu.shape[0]
    tx, ty = -np.sin(normal_az), np.cos(normal_az)  # tangent of the surface
    wx = origin_xy[0] + tx * uu + rng.normal(0, 0.02, c)
    wy = origin_xy[1] + ty * uu + rng.normal(0, 0.02, c)
    wz = vv + rng.normal(0, 0.02, c)
    return np.stack([wx, wy, wz], axis=1)


def make_lidar_frame(rng: np.random.Generator, n_points: int = 200_000,
                     r_max: float = 74.0, n_objects: int = 80,
                     n_walls: int = 24, extra_feats: int = 2):
    """Returns (points (n_points, 3 + extra_feats) float32, valid (n_points,) bool).

    Split: ~55% ground rings (beam-structured), ~30% object surfaces
    (az x elev patches, count ~ 1/r^2 per object), ~15% vertical clutter
    (walls and poles on the scan grid).
    """
    n_ground = int(n_points * 0.55)
    n_obj = int(n_points * 0.30)
    n_clutter = n_points - n_ground - n_obj
    r_min = 2.5
    pts = [_ground_rings(rng, n_ground, r_min, r_max)]

    # objects: boxes on the ground; visible faces get ~1/r^2 of the budget
    sizes = np.array([
        [4.6, 2.0, 1.7],   # vehicle
        [0.8, 0.8, 1.8],   # pedestrian
        [1.8, 0.8, 1.7],   # cyclist
    ])
    cls = rng.integers(0, 3, n_objects)
    obj_r = r_min + (r_max - 8.0) * rng.random(n_objects) ** 1.5
    obj_az = rng.uniform(0, 2 * np.pi, n_objects)
    ox = obj_r * np.cos(obj_az)
    oy = obj_r * np.sin(obj_az)
    heading = rng.uniform(0, 2 * np.pi, n_objects)
    w_obj = 1.0 / np.maximum(obj_r, 5.0) ** 2
    counts = np.maximum((w_obj / w_obj.sum() * n_obj).astype(int), 8)
    counts[0] += n_obj - counts.sum()
    for i in range(n_objects):
        c = max(int(counts[i]), 4)
        dx, dy, dz = sizes[cls[i]] * rng.uniform(0.9, 1.15, 3)
        # two visible vertical faces, sampled as scan-grid patches
        c1 = c // 2
        face1 = _surface_patch(rng, (ox[i], oy[i]), heading[i], dx, dz,
                               max(obj_r[i], r_min), c1)
        face2 = _surface_patch(rng, (ox[i], oy[i]), heading[i] + np.pi / 2,
                               dy, dz, max(obj_r[i], r_min), c - c1)
        pts.append(face1)
        pts.append(face2)

    # clutter: vertical wall segments and poles (buildings, signs, trees)
    per_wall = n_clutter // n_walls if n_walls else 0
    for i in range(n_walls):
        c = per_wall if i < n_walls - 1 else n_clutter - per_wall * (n_walls - 1)
        wr = r_min + (r_max - 5.0) * rng.random() ** 1.2
        waz = rng.uniform(0, 2 * np.pi)
        cx, cy = wr * np.cos(waz), wr * np.sin(waz)
        if rng.random() < 0.3:  # pole: a thin tall patch
            pts.append(_surface_patch(rng, (cx, cy), waz, 0.25,
                                      rng.uniform(2.0, 3.9), wr, c))
        else:  # wall segment
            length = rng.uniform(4.0, 20.0)
            pts.append(_surface_patch(rng, (cx, cy), rng.uniform(0, 2 * np.pi),
                                      length, rng.uniform(2.5, 3.9), wr, c))

    xyz = np.concatenate(pts, axis=0)[:n_points].astype(np.float32)
    if xyz.shape[0] < n_points:  # patch truncation underrun: repeat samples
        extra = xyz[rng.integers(0, xyz.shape[0], n_points - xyz.shape[0])]
        xyz = np.concatenate([xyz, extra], axis=0)
    feats = rng.uniform(0, 1, (xyz.shape[0], extra_feats)).astype(np.float32)
    out = np.concatenate([xyz, feats], axis=1)
    perm = rng.permutation(out.shape[0])
    return out[perm], np.ones(out.shape[0], bool)


def make_tiny_train_batch(b: int = 2, p: int = 1024, n_gt: int = 8, seed: int = 0,
                          with_proto: bool = True):
    """A small training batch of numpy arrays for the tiny test configuration
    (range +-8 m): uniform points, ``n_gt`` random labelled boxes per sample,
    CSS scores in [0.3, 1] and, with ``with_proto``, the second view
    ``points1`` (the points shifted by 1 cm)."""
    rng = np.random.default_rng(seed)
    pts = np.concatenate([rng.uniform(-8, 8, (b, p, 2)), rng.uniform(-2, 4, (b, p, 1)),
                          rng.uniform(0, 1, (b, p, 2))], axis=-1).astype(np.float32)
    gt = np.zeros((b, n_gt, 8), np.float32)
    gt[..., 0:2] = rng.uniform(-6, 6, (b, n_gt, 2))
    gt[..., 2] = rng.uniform(-1, 1, (b, n_gt))
    gt[..., 3:6] = rng.uniform(1.0, 4.0, (b, n_gt, 3))
    gt[..., 6] = rng.uniform(-np.pi, np.pi, (b, n_gt))
    gt[..., 7] = rng.integers(1, 4, (b, n_gt))
    batch = {"points": pts, "points_valid": np.ones((b, p), bool), "gt_boxes": gt,
             "gt_valid": np.ones((b, n_gt), bool),
             "css_score": rng.uniform(0.3, 1.0, (b, n_gt)).astype(np.float32)}
    if with_proto:
        batch["points1"] = pts + 0.01
        batch["points1_valid"] = np.ones((b, p), bool)
    return batch


def make_train_batch(seed: int, batch: int = 2, n_points: int = 200_000, n_gt: int = 64,
                     n_labelled: int = 40, r_max: float = 70.0):
    """A bench-scale training batch of numpy arrays: ``batch`` lidar frames
    from different seeds (``make_lidar_frame``), ``n_gt`` label slots per
    sample of which the first ``n_labelled`` hold class-sized boxes standing
    on the ground at random places (class in column 7, 1-based), CSS scores
    in [0.3, 1], and the second view ``points1``: the frame with 5% of its
    points replaced by jittered copies of others (a stand-in for the
    proto-completed cloud)."""
    sizes = np.array([[4.6, 2.0, 1.7], [0.8, 0.8, 1.8], [1.8, 0.8, 1.7]], np.float32)
    out = {k: [] for k in ("points", "points_valid", "points1", "points1_valid", "gt_boxes",
                           "gt_valid", "css_score")}
    for i in range(batch):
        rng = np.random.default_rng([seed, i])
        pts, valid = make_lidar_frame(rng, n_points)
        pts1 = pts.copy()
        n_new = n_points // 20
        src = rng.integers(0, n_points, n_new)
        pts1[rng.choice(n_points, n_new, replace=False), :3] = (
            pts[src, :3] + rng.normal(0, 0.05, (n_new, 3)).astype(np.float32))
        cls = rng.integers(0, 3, n_gt)
        r = 5.0 + (r_max - 5.0) * rng.random(n_gt)
        az = rng.uniform(0, 2 * np.pi, n_gt)
        dims = sizes[cls] * rng.uniform(0.9, 1.15, (n_gt, 3)).astype(np.float32)
        gt = np.concatenate([(r * np.cos(az))[:, None], (r * np.sin(az))[:, None],
                             dims[:, 2:3] / 2, dims,
                             rng.uniform(-np.pi, np.pi, (n_gt, 1)), cls[:, None] + 1.0],
                            axis=1).astype(np.float32)
        gt_valid = np.arange(n_gt) < n_labelled
        gt[~gt_valid] = 0.0
        for k, v in (("points", pts), ("points_valid", valid), ("points1", pts1),
                     ("points1_valid", valid.copy()), ("gt_boxes", gt), ("gt_valid", gt_valid),
                     ("css_score", rng.uniform(0.3, 1.0, n_gt).astype(np.float32))):
            out[k].append(v)
    return {k: np.stack(v) for k, v in out.items()}


CLASS_SIZES = {"Vehicle": (4.6, 2.0, 1.7), "Pedestrian": (0.8, 0.8, 1.8),
               "Cyclist": (1.8, 0.8, 1.7)}


def _class_boxes(rng, n, r_max):
    """``n`` class-sized boxes standing on the ground at random places within
    ``r_max`` m: (boxes (n, 7) float32, names (n,))."""
    names = np.asarray(list(CLASS_SIZES))[rng.integers(0, len(CLASS_SIZES), n)]
    dims = np.asarray([CLASS_SIZES[c] for c in names], np.float32).reshape(n, 3)
    dims = dims * rng.uniform(0.9, 1.15, (n, 3))
    r = 5.0 + (r_max - 5.0) * rng.random(n)
    az = rng.uniform(0, 2 * np.pi, n)
    boxes = np.concatenate([(r * np.cos(az))[:, None], (r * np.sin(az))[:, None],
                            dims[:, 2:3] / 2, dims, rng.uniform(-np.pi, np.pi, (n, 1))], axis=1)
    return boxes.astype(np.float32), names


def write_waymo_sequence(data_root, seq: str, frames, seed: int = 0, n_boxes: int = 8,
                         r_max: float = 70.0, protos: bool = False):
    """Write ``frames`` (point arrays (N, >= 4): x y z intensity ...) as one
    sequence of the processed Waymo layout that
    ``datasets.waymo_unsupervised.WaymoUnsupervisedDataset`` reads, under
    ``data_root/waymo_processed_data/seq`` (the yamls' PROCESSED_DATA_TAG):

    * ``NNNN.npy``: (N, 6) [x y z intensity elongation NLZ], elongation 0 and
      NLZ -1 (every point kept);
    * ``<seq>.pkl``: per frame an identity pose and ``n_boxes`` gt boxes
      (``annos``: boxes, names, points counted in each, difficulty 0);
    * ``<seq>_outline_C_PROTO.pkl``: per frame ``n_boxes`` pseudo-label boxes
      drawn the same way, scores in [0.3, 1] and prototype ids 0-2 (the
      pseudo-label factory that makes these is not ported);
    * with ``protos``, ``<seq>_outline_MFCF_CSS_proto.pkl``: three prototype
      banks a class of 64 box-canonical points each (training mode reads them).

    Every draw comes from ``numpy.random.default_rng([seed, frame])``.
    Returns the sequence directory."""
    import pickle
    from pathlib import Path

    from ..datasets.box_np import points_in_boxes_mask_np

    seq_dir = Path(data_root) / "waymo_processed_data" / seq
    seq_dir.mkdir(parents=True, exist_ok=True)
    infos, labels = [], {}
    for i, pts in enumerate(frames):
        rng = np.random.default_rng([seed, i])
        disk = np.zeros((len(pts), 6), np.float32)
        disk[:, :4] = pts[:, :4]
        disk[:, 5] = -1
        np.save(seq_dir / f"{i:04d}.npy", disk)
        boxes, names = _class_boxes(rng, n_boxes, r_max)
        n_in = points_in_boxes_mask_np(disk[:, :3], boxes).sum(axis=1)
        infos.append({"pose": np.eye(4), "frame_id": f"{seq}_{i:03d}",
                      "point_cloud": {"lidar_sequence": seq, "sample_idx": i},
                      "annos": {"gt_boxes_lidar": boxes, "name": names,
                                "num_points_in_gt": n_in, "difficulty": np.zeros(n_boxes)}})
        oboxes, onames = _class_boxes(rng, n_boxes, r_max)
        labels[i] = {"outline_box": oboxes, "outline_cls": onames,
                     "outline_score": rng.uniform(0.3, 1.0, n_boxes).astype(np.float32),
                     "outline_proto_id": rng.integers(0, 3, n_boxes)}
    with open(seq_dir / f"{seq}.pkl", "wb") as f:
        pickle.dump(infos, f)
    with open(seq_dir / f"{seq}_outline_C_PROTO.pkl", "wb") as f:
        pickle.dump(labels, f)
    if protos:
        rng = np.random.default_rng([seed, len(frames)])
        banks = {c: {pid: {"points": (rng.uniform(-0.5, 0.5, (64, 3)) * size).astype(np.float32)}
                     for pid in range(3)} for c, size in CLASS_SIZES.items()}
        with open(seq_dir / f"{seq}_outline_MFCF_CSS_proto.pkl", "wb") as f:
            pickle.dump({"proto_points_set": banks}, f)
    return seq_dir
