"""KITTI support in Waymo value conventions: Kitti2WaymoDataset (port of
cpd_tpu/datasets/kitti.py, the same NumPy).

Parity with cpd/datasets/kitti/kitti2waymo_dataset.py:12-510 and the calib /
label parsers (cpd/utils/calibration_kitti.py, object3d_kitti.py): reads
velodyne .bin scans, camera-frame labels + calib, converts boxes into the
lidar frame, FOV-filters points, and evaluates with the KITTI-style AP
backend.

Class names (``kitti_name``): a label keeps its KITTI name when the
dataset's ``class_names`` hold it, and takes Waymo's (``KITTI2WAYMO_NAME``:
Car -> Vehicle) otherwise. With Waymo's class names this is the JAX
package's renaming, bit for bit; with the shipped KITTI yaml's
``[Car, Pedestrian, Cyclist]`` the cars stay cars, where the JAX reader
renames every car to Vehicle and ``prepare_data`` then drops it.
"""
from __future__ import annotations

import pickle
from pathlib import Path
from typing import List

import numpy as np

from .dataset import DatasetTemplate
from .registry import register_dataset

KITTI2WAYMO_NAME = {"Car": "Vehicle", "Pedestrian": "Pedestrian", "Cyclist": "Cyclist"}


def kitti_name(cls_type: str, class_names) -> str:
    """A KITTI label's class name: its own where ``class_names`` holds it,
    Waymo's otherwise."""
    return cls_type if cls_type in class_names else KITTI2WAYMO_NAME[cls_type]


class Calibration:
    """KITTI calib file: P2 (3,4), R0_rect (3,3), Tr_velo_to_cam (3,4)."""

    def __init__(self, calib_file):
        data = {}
        for line in Path(calib_file).read_text().splitlines():
            if ":" not in line:
                continue
            k, v = line.split(":", 1)
            data[k.strip()] = np.asarray([float(x) for x in v.split()], np.float64)
        self.P2 = data["P2"].reshape(3, 4)
        self.R0 = data.get("R0_rect", data.get("R_rect", np.eye(3).ravel())).reshape(3, 3)
        self.V2C = data.get("Tr_velo_to_cam", data.get("Tr_velo_cam")).reshape(3, 4)

    def rect_to_lidar(self, pts_rect):
        """(N, 3) rect-camera -> lidar frame."""
        r0_inv = np.linalg.inv(self.R0)
        pts_ref = pts_rect @ r0_inv.T
        v2c = np.vstack([self.V2C, [0, 0, 0, 1]])
        c2v = np.linalg.inv(v2c)
        pts = np.hstack([pts_ref, np.ones((len(pts_ref), 1))])
        return (pts @ c2v.T)[:, :3]

    def lidar_to_rect(self, pts_lidar):
        pts = np.hstack([pts_lidar[:, :3], np.ones((len(pts_lidar), 1))])
        pts_ref = pts @ self.V2C.T
        return pts_ref @ self.R0.T

    def rect_to_img(self, pts_rect):
        pts = np.hstack([pts_rect, np.ones((len(pts_rect), 1))])
        uvw = pts @ self.P2.T
        uv = uvw[:, :2] / np.clip(uvw[:, 2:3], 1e-6, None)
        return uv, uvw[:, 2]


class Object3d:
    """One KITTI label line."""

    def __init__(self, line: str):
        parts = line.split()
        self.cls_type = parts[0]
        self.truncation = float(parts[1])
        self.occlusion = float(parts[2])
        self.alpha = float(parts[3])
        self.box2d = np.asarray([float(x) for x in parts[4:8]])
        self.h, self.w, self.l = (float(parts[8]), float(parts[9]), float(parts[10]))
        self.loc = np.asarray([float(x) for x in parts[11:14]])
        self.ry = float(parts[14])
        self.score = float(parts[15]) if len(parts) > 15 else -1.0

    @property
    def difficulty(self) -> int:
        height = self.box2d[3] - self.box2d[1]
        if height >= 40 and self.truncation <= 0.15 and self.occlusion <= 0:
            return 0
        if height >= 25 and self.truncation <= 0.3 and self.occlusion <= 1:
            return 1
        if height >= 25 and self.truncation <= 0.5 and self.occlusion <= 2:
            return 2
        return 3


def boxes_camera_to_lidar(objs: List[Object3d], calib: Calibration) -> np.ndarray:
    """(N, 7) lidar-frame boxes [x y z dx dy dz heading] from camera labels."""
    if not objs:
        return np.zeros((0, 7), np.float32)
    loc = np.stack([o.loc for o in objs])  # camera rect frame, box bottom
    lwh = np.asarray([[o.l, o.w, o.h] for o in objs])
    ry = np.asarray([o.ry for o in objs])
    xyz = calib.rect_to_lidar(loc)
    xyz[:, 2] += lwh[:, 2] / 2.0  # bottom -> center
    heading = -(np.pi / 2 + ry)
    return np.concatenate([xyz, lwh, heading[:, None]], axis=1).astype(np.float32)


def boxes_lidar_to_camera(boxes, calib: Calibration):
    """(N, 7) lidar boxes -> (loc_rect (N,3 bottom), lwh (N,3), ry (N,))."""
    xyz = boxes[:, :3].copy()
    xyz[:, 2] -= boxes[:, 5] / 2.0
    loc = calib.lidar_to_rect(xyz)
    ry = -boxes[:, 6] - np.pi / 2
    return loc, boxes[:, 3:6], ry


def camera_boxes_to_image_bboxes(loc, lwh, ry, calib: Calibration,
                                 image_shape=(375, 1242)):
    """Camera-frame boxes -> (N, 4) image bboxes: the 8 projected corners'
    min/max, clipped to the image (parity: boxes3d_kitti_camera_to_imageboxes
    used by kitti2waymo_dataset.py:280-282)."""
    n = len(loc)
    if n == 0:
        return np.zeros((0, 4), np.float32)
    l, w, h = lwh[:, 0], lwh[:, 1], lwh[:, 2]
    # camera rect frame: x right, y DOWN, z forward; loc = box bottom center;
    # l along x (pre-rotation), h along -y, w along z
    xc = np.asarray([0.5, 0.5, -0.5, -0.5, 0.5, 0.5, -0.5, -0.5])
    yc = np.asarray([0.0, 0.0, 0.0, 0.0, -1.0, -1.0, -1.0, -1.0])
    zc = np.asarray([0.5, -0.5, -0.5, 0.5, 0.5, -0.5, -0.5, 0.5])
    cx = xc[None] * l[:, None]
    cy = yc[None] * h[:, None]
    cz = zc[None] * w[:, None]
    c, s = np.cos(ry)[:, None], np.sin(ry)[:, None]
    corners = np.stack([c * cx + s * cz, cy, -s * cx + c * cz], axis=-1)
    corners = corners + loc[:, None, :]
    uv, _ = calib.rect_to_img(corners.reshape(-1, 3))
    uv = uv.reshape(n, 8, 2)
    bbox = np.stack([uv[..., 0].min(1), uv[..., 1].min(1),
                     uv[..., 0].max(1), uv[..., 1].max(1)], axis=-1)
    bbox[:, 0] = np.clip(bbox[:, 0], 0, image_shape[1] - 1)
    bbox[:, 1] = np.clip(bbox[:, 1], 0, image_shape[0] - 1)
    bbox[:, 2] = np.clip(bbox[:, 2], 0, image_shape[1] - 1)
    bbox[:, 3] = np.clip(bbox[:, 3], 0, image_shape[0] - 1)
    return bbox.astype(np.float32)


@register_dataset("Kitti2WaymoDataset")
class Kitti2WaymoDataset(DatasetTemplate):
    def __init__(self, dataset_cfg=None, class_names=None, training=True,
                 root_path=None, logger=None, **kw):
        super().__init__(dataset_cfg=dataset_cfg, class_names=class_names,
                         training=training, root_path=root_path, logger=logger, **kw)
        cfg = self.dataset_cfg
        self.root = Path(root_path or cfg.get("DATA_PATH", "."))
        split_cfg = cfg.get("DATA_SPLIT", {"train": "train", "test": "val"})
        self.split = split_cfg["train" if training else "test"]
        self.fov_only = bool(cfg.get("FOV_POINTS_ONLY", True))
        split_file = self.root / "ImageSets" / f"{self.split}.txt"
        if split_file.exists():
            self.sample_ids = [x.strip() for x in split_file.read_text().splitlines() if x.strip()]
        else:
            velo = self.root / "training" / "velodyne"
            self.sample_ids = sorted(p.stem for p in velo.glob("*.bin")) if velo.exists() else []

    def __len__(self):
        return len(self.sample_ids)

    def _dir(self, sub):
        return self.root / ("training" if self.split != "test" else "testing") / sub

    def get_lidar(self, sid: str) -> np.ndarray:
        pts = np.fromfile(self._dir("velodyne") / f"{sid}.bin", dtype=np.float32).reshape(-1, 4)
        return pts

    def get_calib(self, sid: str) -> Calibration:
        return Calibration(self._dir("calib") / f"{sid}.txt")

    def get_label(self, sid: str) -> List[Object3d]:
        f = self._dir("label_2") / f"{sid}.txt"
        if not f.exists():
            return []
        return [Object3d(l) for l in f.read_text().splitlines() if l.strip()]

    def fov_mask(self, points, calib, img_shape=(375, 1242)):
        rect = calib.lidar_to_rect(points[:, :3])
        uv, depth = calib.rect_to_img(rect)
        return (
            (uv[:, 0] >= 0) & (uv[:, 0] < img_shape[1])
            & (uv[:, 1] >= 0) & (uv[:, 1] < img_shape[0]) & (depth > 0)
        )

    def __getitem__(self, index):
        sid = self.sample_ids[index]
        pts = self.get_lidar(sid)
        calib = self.get_calib(sid)
        if self.fov_only:
            pts = pts[self.fov_mask(pts, calib)]
        # pad a time channel so the waymo 5-feature encoding applies unchanged
        pts = np.concatenate([pts, np.zeros((len(pts), 1), np.float32)], axis=1)
        objs = [o for o in self.get_label(sid) if o.cls_type in KITTI2WAYMO_NAME]
        boxes = boxes_camera_to_lidar(objs, calib)
        names = np.asarray([kitti_name(o.cls_type, self.class_names) for o in objs])
        data = {
            "points": pts, "gt_boxes": boxes, "gt_names": names,
            "frame_id": sid, "sample_idx": index,
            "difficulty": np.asarray([o.difficulty for o in objs]),
        }
        if self.training and self.stages > 1:
            data["points1"] = pts.copy()
        return self.prepare_data(data)

    def generate_prediction_dicts(self, batch, pred_dicts, class_names, output_path=None):
        """Prediction dicts with the KITTI camera-protocol fields.

        Parity: kitti2waymo_dataset.py:247-307 -- predictions are projected
        to the camera frame (location/dimensions/rotation_y), given an
        observation angle ``alpha`` and an image-plane ``bbox`` (projected
        corners clipped to the image), so the bbox-AP/AOS eval dimensions
        run off the real dataset path.
        """
        out = []
        boxes = np.asarray(pred_dicts["pred_boxes"])
        scores = np.asarray(pred_dicts["pred_scores"])
        labels = np.asarray(pred_dicts["pred_labels"])
        valid = np.asarray(pred_dicts["pred_valid"])
        for i in range(batch["batch_size"]):
            m = valid[i]
            lb = labels[i][m]
            names = np.asarray(class_names)[np.clip(lb - 1, 0, len(class_names) - 1)]
            bx = boxes[i][m]
            if self.test_augmentor is not None and len(bx):
                bx = self.test_augmentor.backward(bx.copy())
            rec = {
                "frame_id": batch["frame_id"][i],
                "boxes_lidar": bx, "score": scores[i][m], "name": names,
                "pred_labels": lb,
            }
            try:
                calib = self.get_calib(str(batch["frame_id"][i]))
            except (OSError, KeyError):
                calib = None
            if calib is not None:
                img_shape = tuple(np.asarray(batch["image_shape"][i]).tolist()) \
                    if "image_shape" in batch else (375, 1242)
                loc, lwh, ry = boxes_lidar_to_camera(bx.reshape(-1, 7), calib)
                rec["location"] = loc.astype(np.float32)
                rec["dimensions"] = lwh.astype(np.float32)
                rec["rotation_y"] = ry.astype(np.float32)
                # alpha = -atan2(-y, x) + ry (kitti2waymo_dataset.py:347)
                rec["alpha"] = (-np.arctan2(-bx[:, 1], bx[:, 0]) + ry).astype(np.float32)
                rec["bbox"] = camera_boxes_to_image_bboxes(loc, lwh, ry, calib,
                                                           img_shape)
            out.append(rec)
        return out

    def evaluation(self, det_annos, class_names, **kwargs):
        from ..evaluation import kitti_style_eval

        gt_annos = kwargs.get("gt_annos") or self.collect_gt_annos()
        # both recall-position protocols, like the official eval (R40 is the
        # headline; R11 is the legacy number papers still quote)
        return kitti_style_eval(det_annos, gt_annos, class_names,
                                n_points=(40, 11))

    def collect_gt_annos(self):
        annos = []
        for sid in self.sample_ids:
            calib = self.get_calib(sid)
            objs = [o for o in self.get_label(sid) if o.cls_type in KITTI2WAYMO_NAME]
            annos.append({
                "frame_id": sid,
                "gt_boxes_lidar": boxes_camera_to_lidar(objs, calib),
                "name": np.asarray([kitti_name(o.cls_type, self.class_names) for o in objs]),
                "difficulty": np.asarray([min(o.difficulty, 2) for o in objs]),
                # camera-protocol fields: the official clean_data difficulty
                # gates (eval.py:58-110) key on truncation/occlusion/bbox
                # height, and AOS needs the label alpha
                "truncated": np.asarray([o.truncation for o in objs]),
                "occluded": np.asarray([o.occlusion for o in objs]),
                "alpha": np.asarray([o.alpha for o in objs]),
                "bbox": (np.stack([o.box2d for o in objs])
                         if objs else np.zeros((0, 4))),
                # camera-frame box fields: kitti_style_eval computes the
                # official camera-frame 3D/BEV IoU from these (eval.py
                # d3_box_overlap semantics); dims ordered (l, w, h)
                "location": (np.stack([o.loc for o in objs])
                             if objs else np.zeros((0, 3))),
                "dimensions": (np.asarray([[o.l, o.w, o.h] for o in objs])
                               if objs else np.zeros((0, 3))),
                "rotation_y": np.asarray([o.ry for o in objs]),
            })
        return annos


def create_kitti_infos(dataset: "Kitti2WaymoDataset", out_path):
    """Info pkl creation (kitti2waymo_dataset.py:457 capability)."""
    infos = []
    for sid in dataset.sample_ids:
        objs = [o for o in dataset.get_label(sid) if o.cls_type in KITTI2WAYMO_NAME]
        calib = dataset.get_calib(sid)
        infos.append({
            "sample_idx": sid,
            "annos": {
                "gt_boxes_lidar": boxes_camera_to_lidar(objs, calib),
                "name": np.asarray([kitti_name(o.cls_type, dataset.class_names)
                                    for o in objs]),
                "difficulty": np.asarray([o.difficulty for o in objs]),
                "truncated": np.asarray([o.truncation for o in objs]),
                "occluded": np.asarray([o.occlusion for o in objs]),
            },
        })
    with open(out_path, "wb") as f:
        pickle.dump(infos, f)
    return infos


def create_kitti_groundtruth_database(dataset: "Kitti2WaymoDataset", out_path,
                                      min_points: int = 5):
    """gt-sampling database from KITTI labels (kitti2waymo_dataset.py:194)."""
    from .box_np import points_in_boxes_mask_fast

    db = {}
    for sid in dataset.sample_ids:
        pts = dataset.get_lidar(sid)
        calib = dataset.get_calib(sid)
        objs = [o for o in dataset.get_label(sid) if o.cls_type in KITTI2WAYMO_NAME]
        boxes = boxes_camera_to_lidar(objs, calib)
        if not len(boxes):
            continue
        masks = points_in_boxes_mask_fast(pts[:, :3], boxes)
        for i, o in enumerate(objs):
            obj_pts = pts[masks[i]]
            if len(obj_pts) < min_points:
                continue
            name = kitti_name(o.cls_type, dataset.class_names)
            db.setdefault(name, []).append({
                "name": name, "box3d_lidar": boxes[i].astype(np.float32),
                "points": obj_pts.astype(np.float32),
                "num_points_in_gt": len(obj_pts), "sample_idx": sid,
                "difficulty": o.difficulty,
            })
    with open(out_path, "wb") as f:
        pickle.dump(db, f)
    return {k: len(v) for k, v in db.items()}
