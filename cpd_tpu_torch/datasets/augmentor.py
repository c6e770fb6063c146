"""Train-time augmentation (host-side NumPy) + gt-database sampling (port of
cpd_tpu/datasets/augmentor.py, the same NumPy).

Parity with the reference augmentor stack:
  - random world flip / rotation / scaling / translation and their exact
    multi-stage "with_param" variants (cpd/datasets/augmentor/
    data_augmentor.py:59-152,255, augmentor_utils.py:8-125)
  - gt sampling: paste tracked objects from a database into the scene with
    BEV collision tests (augmentor/database_sampler.py:12-466)
  - TestAugmentor TTA forward/backward (augmentor/test_augmentor.py)

Implementation is fresh NumPy written from the documented behavior; the CPD
multi-branch protocol (suffix "1" arrays share the SAME world transform) is
honored by applying one parameter draw to every stage of a sample.
"""
from __future__ import annotations

import pickle
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np


# ---------------------------------------------------------------------------
# parameterized world transforms (exactly invertible)
# ---------------------------------------------------------------------------

def rot_z(points, angle):
    c, s = np.cos(angle), np.sin(angle)
    rot = np.array([[c, s, 0.0], [-s, c, 0.0], [0.0, 0.0, 1.0]], dtype=points.dtype)
    out = points.copy()
    out[:, :3] = points[:, :3] @ rot
    return out


def flip_along_x(points, boxes):
    points = points.copy()
    points[:, 1] = -points[:, 1]
    if boxes is not None:
        boxes = boxes.copy()
        boxes[:, 1] = -boxes[:, 1]
        boxes[:, 6] = -boxes[:, 6]
    return points, boxes


def flip_along_y(points, boxes):
    points = points.copy()
    points[:, 0] = -points[:, 0]
    if boxes is not None:
        boxes = boxes.copy()
        boxes[:, 0] = -boxes[:, 0]
        boxes[:, 6] = -(boxes[:, 6] + np.pi)
    return points, boxes


def global_rotation(points, boxes, angle):
    points = rot_z(points, angle)
    if boxes is not None:
        boxes = boxes.copy()
        boxes[:, :3] = rot_z(boxes[:, :3], angle)[:, :3]
        boxes[:, 6] += angle
    return points, boxes


def global_scaling(points, boxes, scale):
    points = points.copy()
    points[:, :3] *= scale
    if boxes is not None:
        boxes = boxes.copy()
        boxes[:, :6] *= scale
    return points, boxes


def global_translation(points, boxes, offset):
    points = points.copy()
    points[:, :3] += offset
    if boxes is not None:
        boxes = boxes.copy()
        boxes[:, :3] += offset
    return points, boxes


class WorldTransformParam:
    """One draw of (flip_x, flip_y, rot, scale, trans), applied identically to
    every stage of a sample; exactly invertible (TTA backward / X_transform)."""

    def __init__(self, flip_x=False, flip_y=False, rot=0.0, scale=1.0, trans=(0.0, 0.0, 0.0)):
        self.flip_x = flip_x
        self.flip_y = flip_y
        self.rot = float(rot)
        self.scale = float(scale)
        self.trans = np.asarray(trans, dtype=np.float32)

    def apply(self, points, boxes=None):
        if self.flip_x:
            points, boxes = flip_along_x(points, boxes)
        if self.flip_y:
            points, boxes = flip_along_y(points, boxes)
        points, boxes = global_rotation(points, boxes, self.rot)
        points, boxes = global_scaling(points, boxes, self.scale)
        points, boxes = global_translation(points, boxes, self.trans)
        return points, boxes

    def inverse_boxes(self, boxes):
        """Undo the transform on predicted boxes (TestAugmentor.backward)."""
        boxes = boxes.copy()
        boxes[:, :3] -= self.trans
        boxes[:, :6] /= self.scale
        boxes[:, :3] = rot_z(boxes[:, :3], -self.rot)[:, :3]
        boxes[:, 6] -= self.rot
        if self.flip_y:
            boxes[:, 0] = -boxes[:, 0]
            boxes[:, 6] = -(boxes[:, 6] + np.pi)
        if self.flip_x:
            boxes[:, 1] = -boxes[:, 1]
            boxes[:, 6] = -boxes[:, 6]
        return boxes


# ---------------------------------------------------------------------------
# BEV collision test for gt sampling
# ---------------------------------------------------------------------------

def boxes_bev_corners(boxes):
    half = boxes[:, 3:5] / 2.0
    local = np.stack(
        [
            np.stack([half[:, 0], half[:, 1]], -1),
            np.stack([-half[:, 0], half[:, 1]], -1),
            np.stack([-half[:, 0], -half[:, 1]], -1),
            np.stack([half[:, 0], -half[:, 1]], -1),
        ],
        axis=1,
    )
    c, s = np.cos(boxes[:, 6]), np.sin(boxes[:, 6])
    rot = np.stack([np.stack([c, s], -1), np.stack([-s, c], -1)], axis=1)  # (N,2,2)
    return np.einsum("nij,njk->nik", local, rot) + boxes[:, None, :2]


def box_collision_test(boxes_a, boxes_b):
    """(N, 7), (M, 7) -> (N, M) bool BEV overlap via SAT on both corner sets
    (augmentor_utils.py:448 equivalent, different algorithm)."""
    if len(boxes_a) == 0 or len(boxes_b) == 0:
        return np.zeros((len(boxes_a), len(boxes_b)), dtype=bool)
    ca = boxes_bev_corners(boxes_a)  # (N,4,2)
    cb = boxes_bev_corners(boxes_b)

    def axes_of(corners):
        e = np.roll(corners, -1, axis=1) - corners  # (K,4,2)
        n = np.stack([-e[..., 1], e[..., 0]], axis=-1)
        return n  # (K,4,2)

    out = np.zeros((len(boxes_a), len(boxes_b)), dtype=bool)
    for i in range(len(boxes_a)):
        for j in range(len(boxes_b)):
            sep = False
            for ax in np.concatenate([axes_of(ca[i : i + 1])[0], axes_of(cb[j : j + 1])[0]]):
                pa = ca[i] @ ax
                pb = cb[j] @ ax
                if pa.max() < pb.min() or pb.max() < pa.min():
                    sep = True
                    break
            out[i, j] = not sep
    return out


# ---------------------------------------------------------------------------
# gt database sampler
# ---------------------------------------------------------------------------

class DataBaseSampler:
    """Copy-paste gt augmentation from a tracked-object database.

    Database pkl format (mirrors the reference's
    ``pcdet_waymo_track_dbinfos_train_cp.pkl`` content): {class_name: [info]},
    info = {"name", "box3d_lidar" (7,), "points" (N, C) object points in the
    box frame OR absolute + "offset", "num_points_in_gt", "difficulty"}.
    """

    def __init__(self, db_info_path, class_names, sample_groups: Dict[str, int],
                 min_points: int = 5, rng: Optional[np.random.Generator] = None,
                 db: Optional[dict] = None):
        self.class_names = list(class_names)
        self.rng = rng or np.random.default_rng(0)
        if db is None:
            with open(db_info_path, "rb") as f:
                db = pickle.load(f)
        self.db = {
            k: [x for x in v if x.get("num_points_in_gt", len(x.get("points", []))) >= min_points]
            for k, v in db.items()
        }
        self.sample_groups = dict(sample_groups)
        self._cursors = {k: 0 for k in self.db}

    def _draw(self, cls, num, rng):
        infos = self.db.get(cls, [])
        if not infos or num <= 0:
            return []
        sel = rng.choice(len(infos), size=min(num, len(infos)), replace=num > len(infos))
        return [infos[i] for i in np.atleast_1d(sel)]

    def __call__(self, points, gt_boxes, gt_names, rng=None):
        """Paste sampled objects; returns (points, gt_boxes, gt_names, css_pad)."""
        sampled_boxes, sampled_names, sampled_points = [], [], []
        existing = gt_boxes.copy() if len(gt_boxes) else np.zeros((0, 7), np.float32)
        rng = rng if rng is not None else self.rng
        for cls, target in self.sample_groups.items():
            have = int(np.sum(gt_names == cls)) if len(gt_names) else 0
            need = max(int(target) - have, 0)
            for info in self._draw(cls, need, rng):
                box = np.asarray(info["box3d_lidar"], np.float32)[:7]
                cand = box[None]
                coll = box_collision_test(cand, existing[:, :7])
                if coll.any():
                    continue
                if sampled_boxes:
                    coll2 = box_collision_test(cand, np.asarray(sampled_boxes))
                    if coll2.any():
                        continue
                obj_pts = np.asarray(info["points"], np.float32)
                if obj_pts.ndim != 2 or len(obj_pts) == 0:
                    continue
                if obj_pts.shape[1] < points.shape[1]:
                    pad = np.zeros((len(obj_pts), points.shape[1] - obj_pts.shape[1]), np.float32)
                    obj_pts = np.concatenate([obj_pts, pad], axis=1)
                obj_pts = obj_pts[:, : points.shape[1]]
                sampled_boxes.append(box)
                sampled_names.append(cls)
                sampled_points.append(obj_pts)
        if not sampled_boxes:
            return points, gt_boxes, gt_names
        sampled_boxes = np.asarray(sampled_boxes, np.float32)
        # carve out the paste regions from the background, then add points
        from .box_np import points_in_boxes_mask_np

        hit = points_in_boxes_mask_np(points[:, :3], sampled_boxes)
        points = points[~hit.any(axis=0)]
        points = np.concatenate([np.concatenate(sampled_points, axis=0), points], axis=0)
        gt_boxes = np.concatenate([gt_boxes, sampled_boxes], axis=0) if len(gt_boxes) else sampled_boxes
        gt_names = np.concatenate([gt_names, np.asarray(sampled_names)]) if len(gt_names) else np.asarray(sampled_names)
        return points, gt_boxes, gt_names


# ---------------------------------------------------------------------------
# the augmentor queues
# ---------------------------------------------------------------------------

class DataAugmentor:
    """Config-driven queue (data_augmentor.py:9-343). Operates on a sample
    dict with keys points/gt_boxes/gt_names (+ optional points1 sharing the
    same world transform, the CPD two-branch protocol)."""

    def __init__(self, aug_cfg_list: List[dict], class_names, root_path=None,
                 rng: Optional[np.random.Generator] = None, db_sampler=None):
        self.rng = rng or np.random.default_rng(0)
        self.class_names = class_names
        self.queue = []
        for cfg in aug_cfg_list or []:
            name = cfg["NAME"]
            if name == "gt_sampling":
                sampler = db_sampler
                if sampler is None and cfg.get("DB_INFO_PATH"):
                    path = Path(root_path or ".") / cfg["DB_INFO_PATH"][0]
                    if path.exists():
                        groups = {}
                        for g in cfg.get("SAMPLE_GROUPS", []):
                            k, v = g.split(":")
                            groups[k] = int(v)
                        sampler = DataBaseSampler(
                            path, class_names, groups,
                            min_points=int(str(cfg.get("PREPARE", {}).get(
                                "filter_by_min_points", ["Vehicle:5"])[0]).split(":")[1]),
                            rng=self.rng,
                        )
                if sampler is not None:
                    self.queue.append(("gt_sampling", sampler))
            else:
                self.queue.append((name, cfg))

    def forward(self, data: dict, rng=None) -> dict:
        rng = rng if rng is not None else self.rng
        for name, cfg in self.queue:
            if name == "gt_sampling":
                n_before = len(data["gt_boxes"])
                pts, boxes, names = cfg(data["points"], data["gt_boxes"], data["gt_names"], rng)
                data["points"], data["gt_boxes"], data["gt_names"] = pts, boxes, names
                # the pasted boxes get the weight and group of a plain label
                # (CSS 1, no prototype), so that css_score and proto_group_id
                # stay row for row with gt_boxes; the JAX package leaves them
                # short, and its prepare_data then raises an IndexError
                for extra, fill in (("css_score", 1.0), ("proto_group_id", -1)):
                    if data.get(extra) is not None and len(data[extra]) == n_before:
                        old = np.asarray(data[extra])
                        data[extra] = np.concatenate(
                            [old, np.full(len(boxes) - n_before, fill, old.dtype)])
                continue
            if _augmentor_forward_local(self, data, name, cfg, rng):
                continue
            param = self._draw_param(name, cfg, rng)
            if param is None:
                continue
            for suffix in ("", "1"):
                pk, bk = f"points{suffix}", f"gt_boxes{suffix}"
                if pk in data and data[pk] is not None:
                    boxes = data.get(bk)
                    data[pk], boxes = param.apply(data[pk], boxes)
                    if boxes is not None:
                        data[bk] = boxes
            data.setdefault("transform_params", []).append(param)
        return data

    def _draw_param(self, name, cfg, rng) -> Optional[WorldTransformParam]:
        if name == "random_world_flip":
            fx = fy = False
            for ax in cfg.get("ALONG_AXIS_LIST", ["x"]):
                if ax == "x" and rng.random() < 0.5:
                    fx = True
                if ax == "y" and rng.random() < 0.5:
                    fy = True
            return WorldTransformParam(flip_x=fx, flip_y=fy)
        if name == "random_world_rotation":
            lo, hi = cfg.get("WORLD_ROT_ANGLE", [-0.78539816, 0.78539816])
            return WorldTransformParam(rot=rng.uniform(lo, hi))
        if name == "random_world_scaling":
            lo, hi = cfg.get("WORLD_SCALE_RANGE", [0.95, 1.05])
            return WorldTransformParam(scale=rng.uniform(lo, hi))
        if name == "random_world_trans":
            std = cfg.get("NOISE_TRANSLATE_STD", [0.2, 0.2, 0.2])
            return WorldTransformParam(trans=rng.normal(0, std, 3))
        return None


class TestAugmentor:
    """TTA: apply a fixed world transform forward, invert predictions
    (test_augmentor.py:9-181). Select a transform by ``test_iter``."""

    def __init__(self, tta_cfg, test_iter: int = 0):
        params = []
        if isinstance(tta_cfg, (list, tuple)):
            # reference schema (waymo_unsupervised_dbscan.yaml TEST_AUGMENTOR):
            # a LIST of variants, each AUG_CONFIG_LIST composing ONE transform
            # from scalar WORLD_ROT / ALONG_AXIS / WORLD_SCALE entries
            for variant in tta_cfg:
                rot, scale = 0.0, 1.0
                flip_x = flip_y = False
                for cfg in variant.get("AUG_CONFIG_LIST", []):
                    name = cfg["NAME"]
                    if name == "world_rotation":
                        rot = float(cfg.get("WORLD_ROT", 0.0) or 0.0)
                    elif name == "world_flip":
                        ax = str(cfg.get("ALONG_AXIS", "None"))
                        flip_x, flip_y = ax == "x", ax == "y"
                    elif name == "world_scaling":
                        scale = float(cfg.get("WORLD_SCALE", 1.0) or 1.0)
                params.append(WorldTransformParam(rot=rot, scale=scale,
                                                  flip_x=flip_x, flip_y=flip_y))
        else:
            for cfg in tta_cfg.get("AUG_CONFIG_LIST", []):
                name = cfg["NAME"]
                if name == "world_flip":
                    for ax in cfg.get("ALONG_AXIS_LIST", []):
                        params.append(WorldTransformParam(flip_x=(ax == "x"), flip_y=(ax == "y")))
                elif name == "world_rotation":
                    for ang in cfg.get("WORLD_ROT_ANGLE", []):
                        params.append(WorldTransformParam(rot=ang))
                elif name == "world_scaling":
                    for s in cfg.get("WORLD_SCALE_RANGE", []):
                        params.append(WorldTransformParam(scale=s))
        self.params = params or [WorldTransformParam()]
        self.param = self.params[test_iter % len(self.params)]

    def forward(self, data: dict) -> dict:
        for suffix in ("", "1"):
            pk, bk = f"points{suffix}", f"gt_boxes{suffix}"
            if pk in data and data[pk] is not None:
                boxes = data.get(bk)
                data[pk], boxes = self.param.apply(data[pk], boxes)
                if boxes is not None:
                    data[bk] = boxes
        return data

    def backward(self, pred_boxes: np.ndarray) -> np.ndarray:
        return self.param.inverse_boxes(pred_boxes)


_XT_DEFAULT_CFGS = [
    {"NAME": "world_rotation", "WORLD_ROT_ANGLE": [-0.78539816, 0.78539816]},
    {"NAME": "world_flip", "ALONG_AXIS_LIST": ["x"]},
    {"NAME": "world_scaling", "WORLD_SCALE_RANGE": [0.95, 1.05]},
]


class XTransform:
    """X_TRAIN / X_TEST per-stage clone protocol (X_transform.py:9-255).

    Draws one world-transform parameter row per stage (columns follow the
    config list order: rotation angle / flip indicator / scale factor),
    produces ``points``/``points{i}`` (+ ``gt_boxes{i}``) clones transformed
    per stage, and threads the numeric ``transform_param`` (S, n_cfg) array
    into the batch for the model's BEV de-augmentation
    (height_compression.py:81 bev_align). ``backward_row`` undoes one stage's
    transform on predicted boxes (X_TEST backward_with_param).
    """

    def __init__(self, aug_config_list=None, stages: int = 1, fixed: bool = False):
        self.cfgs = list(aug_config_list) if aug_config_list else list(_XT_DEFAULT_CFGS)
        self.names = [c["NAME"] for c in self.cfgs]
        self.stages = int(stages)
        self.fixed = bool(fixed)

    def get_params(self, rng=None) -> np.ndarray:
        rng = rng or np.random.default_rng()
        out = np.zeros((self.stages, len(self.cfgs)), np.float64)
        for s in range(self.stages):
            for i, cfg in enumerate(self.cfgs):
                if cfg["NAME"] == "world_rotation":
                    lo, hi = cfg.get("WORLD_ROT_ANGLE", [-0.7853981634, 0.7853981634])
                    out[s, i] = rng.uniform(lo, hi)
                elif cfg["NAME"] == "world_flip":
                    out[s, i] = rng.choice([0.0, 1.0])
                elif cfg["NAME"] == "world_scaling":
                    lo, hi = cfg.get("WORLD_SCALE_RANGE", [0.95, 1.05])
                    out[s, i] = rng.uniform(lo, hi)
            if self.fixed:
                break
        if self.fixed:
            out[1:] = out[0]
        return out

    def apply_row(self, points, boxes, row, backward: bool = False):
        """Apply (or exactly invert) one stage's parameter row.

        Forward runs the config queue in order; backward runs it REVERSED
        with each op inverted (the reference's test_back_queue,
        X_transform.py:27-32)."""
        points = None if points is None else points.copy()
        boxes = None if boxes is None else boxes.copy()
        order = list(enumerate(self.names))
        if backward:
            order = order[::-1]
        for i, name in order:
            v = float(row[i])
            if name == "world_rotation":
                ang = -v if backward else v
                if points is not None:
                    points[:, :3] = rot_z(points[:, :3], ang)[:, :3]
                if boxes is not None:
                    boxes[:, :3] = rot_z(boxes[:, :3], ang)[:, :3]
                    boxes[:, 6] += ang
            elif name == "world_flip":
                if v > 0.5:  # flip along x: y negated (augmentor_utils ax=1)
                    if points is not None:
                        points[:, 1] = -points[:, 1]
                    if boxes is not None:
                        boxes[:, 1] = -boxes[:, 1]
                        boxes[:, 6] = -boxes[:, 6]
            elif name == "world_scaling":
                s = (1.0 / v) if backward else v
                if points is not None:
                    points[:, :3] *= s
                if boxes is not None:
                    boxes[:, :6] *= s
        return points, boxes

    def input_transform(self, data: dict, rng=None) -> dict:
        """X_TRAIN.input_transform: per-stage transformed clones of the source
        points/boxes under stage-specific params; stage 0 REPLACES the main
        view (X_transform.py:161-194)."""
        params = self.get_params(rng)
        src_points = data["points"]
        src_boxes = data.get("gt_boxes")
        for i in range(self.stages):
            # stage 0 replaces the main view; extra stages ride
            # ``points_stage{i}`` ("points1" is the MM proto view here)
            pk = "points" if i == 0 else f"points_stage{i}"
            bk = "gt_boxes" if i == 0 else f"gt_boxes_stage{i}"
            pts, boxes = self.apply_row(src_points, src_boxes, params[i])
            data[pk] = pts
            if boxes is not None:
                data[bk] = boxes
        data["transform_param"] = params.astype(np.float32)
        return data

    def backward_row(self, pred_boxes: np.ndarray, row) -> np.ndarray:
        _, boxes = self.apply_row(None, pred_boxes, row, backward=True)
        return boxes


# ---------------------------------------------------------------------------
# local (per-object) augmentations
# ---------------------------------------------------------------------------

def noise_per_object(points, boxes, rng, rot_range=(-0.3925, 0.3925),
                     trans_std=(1.0, 1.0, 0.5), collision_check=True):
    """Per-box local rotation + translation with collision revert
    (augmentor_utils.noise_per_object_v3_ capability, numba in the reference).

    Points inside each box move rigidly with it; a perturbation is reverted
    when the moved box would collide with any other (current) box.
    """
    from .box_np import points_in_boxes_mask_fast

    if len(boxes) == 0:
        return points, boxes
    boxes = boxes.copy()
    points = points.copy()
    masks = points_in_boxes_mask_fast(points[:, :3], boxes)
    for i in range(len(boxes)):
        rot = rng.uniform(*rot_range)
        trans = rng.normal(0, trans_std, 3)
        new_box = boxes[i].copy()
        c, s = np.cos(rot), np.sin(rot)
        new_box[6] += rot
        new_box[:3] += trans
        if collision_check:
            others = np.delete(boxes, i, axis=0)
            if len(others) and box_collision_test(new_box[None, :7], others[:, :7]).any():
                continue
        m = masks[i]
        if m.any():
            local = points[m, :3] - boxes[i, :3]
            rotm = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
            points[m, :3] = local @ rotm.T + new_box[:3]
        boxes[i] = new_box
    return points, boxes


def _pyramid_masks(points, box):
    """Assign each in-box point to one of the 6 face pyramids of the box."""
    rel = points[:, :3] - box[:3]
    c, s = np.cos(-box[6]), np.sin(-box[6])
    lx = rel[:, 0] * c - rel[:, 1] * s
    ly = rel[:, 0] * s + rel[:, 1] * c
    lz = rel[:, 2]
    u = np.stack([lx / max(box[3], 1e-6), ly / max(box[4], 1e-6), lz / max(box[5], 1e-6)], 1)
    dom = np.argmax(np.abs(u), axis=1)
    sign = np.take_along_axis(np.sign(u), dom[:, None], axis=1)[:, 0]
    return dom * 2 + (sign > 0)  # face id 0..5


def local_pyramid_dropout(points, boxes, rng, prob: float = 0.25):
    """Drop one random face-pyramid of points per selected box
    (augmentor_utils.local_pyramid_* capability)."""
    from .box_np import points_in_boxes_mask_fast

    if len(boxes) == 0:
        return points
    masks = points_in_boxes_mask_fast(points[:, :3], boxes)
    drop = np.zeros(len(points), bool)
    for i, box in enumerate(boxes):
        if rng.random() > prob or not masks[i].any():
            continue
        ids = _pyramid_masks(points[masks[i]], box)
        face = rng.integers(6)
        sub = np.where(masks[i])[0][ids == face]
        drop[sub] = True
    return points[~drop]


def local_pyramid_sparsify(points, boxes, rng, prob: float = 0.25, keep: float = 0.5):
    """Sparsify one face-pyramid per selected box."""
    from .box_np import points_in_boxes_mask_fast

    if len(boxes) == 0:
        return points
    masks = points_in_boxes_mask_fast(points[:, :3], boxes)
    drop = np.zeros(len(points), bool)
    for i, box in enumerate(boxes):
        if rng.random() > prob or not masks[i].any():
            continue
        ids = _pyramid_masks(points[masks[i]], box)
        face = rng.integers(6)
        sub = np.where(masks[i])[0][ids == face]
        if len(sub):
            drop[rng.choice(sub, int(len(sub) * (1 - keep)), replace=False)] = True
    return points[~drop]


def random_local_flip(points, boxes, rng, prob: float = 0.5):
    """Flip each object's points across its own long axis (random_local_flip)."""
    from .box_np import points_in_boxes_mask_fast

    if len(boxes) == 0:
        return points
    points = points.copy()
    masks = points_in_boxes_mask_fast(points[:, :3], boxes)
    for i, box in enumerate(boxes):
        if rng.random() > prob or not masks[i].any():
            continue
        m = masks[i]
        rel = points[m, :3] - box[:3]
        c, s = np.cos(-box[6]), np.sin(-box[6])
        ly = rel[:, 0] * s + rel[:, 1] * c
        # reflect local y
        lx = rel[:, 0] * c - rel[:, 1] * s
        ly = -ly
        c2, s2 = np.cos(box[6]), np.sin(box[6])
        points[m, 0] = lx * c2 - ly * s2 + box[0]
        points[m, 1] = lx * s2 + ly * c2 + box[1]
    return points


class DADataBaseSampler(DataBaseSampler):
    """Domain-adaptation gt sampler (database_sampler.py:468): sampled object
    points are thinned with spherical-grid la_sampling + random dropout to
    match a sparser target sensor."""

    def __init__(self, *a, keep_every: int = 2, max_drop: float = 0.5, **kw):
        super().__init__(*a, **kw)
        self.keep_every = keep_every
        self.max_drop = max_drop

    def _draw(self, cls, num, rng):
        from .point_ops import la_sampling, random_drop_out

        infos = super()._draw(cls, num, rng)
        out = []
        for info in infos:
            info = dict(info)
            pts = np.asarray(info["points"], np.float32)
            pts = la_sampling(pts, keep_every=self.keep_every)
            pts = random_drop_out(pts, self.max_drop, rng)
            info["points"] = pts
            out.append(info)
        return out


# register local augs in the DataAugmentor queue
def _augmentor_forward_local(self, data, name, cfg, rng):
    if name == "random_local_noise":
        data["points"], data["gt_boxes"] = noise_per_object(
            data["points"], data["gt_boxes"], rng,
            rot_range=tuple(cfg.get("LOCAL_ROT_RANGE", (-0.3925, 0.3925))),
            trans_std=tuple(cfg.get("TRANSLATION_STD", (1.0, 1.0, 0.5))),
        )
        return True
    if name == "random_local_pyramid_aug":
        data["points"] = local_pyramid_dropout(data["points"], data["gt_boxes"], rng,
                                               float(cfg.get("DROP_PROB", 0.25)))
        data["points"] = local_pyramid_sparsify(data["points"], data["gt_boxes"], rng,
                                                float(cfg.get("SPARSIFY_PROB", 0.25)))
        return True
    if name == "random_local_flip":
        data["points"] = random_local_flip(data["points"], data["gt_boxes"], rng)
        return True
    return False
