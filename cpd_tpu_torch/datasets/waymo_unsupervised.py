"""Waymo unsupervised dataset (port of the WaymoUnsupervisedDataset class of
cpd_tpu/datasets/waymo_unsupervised.py, the same NumPy).

Parity with cpd/datasets/waymo_unsupervised/waymo_unsupervised_dataset.py:
  - processed-sequence layout: <root>/<seq>/NNNN.npy (N, 6) [x y z intensity
    elongation NLZ], <seq>.pkl infos, <seq>_outline_<Refiner>.pkl labels,
    <seq>_outline_<Init>_CSS_proto.pkl banks
  - get_lidar (:137): drop NLZ-flagged points, tanh intensity
  - get_frame (:333): NUM_FRAMES pose-registered concat with time channel
  - sample_prototype (:205-331): per-box score gating
    (DiscardThreshMin/Max, r < 75, proto_id >= 0), CSS normalization, the
    good-object view (random 20%-keep scene dropout half the time) and the
    proto-completed view (prototype banks re-posed into each box + clean
    background)
  - generate_prediction_dicts (:504): LABEL_OFFSET z-shift for Vehicle, TTA
    backward
The official Waymo metric is not ported (``evaluation.official_available``
is False), so ``evaluation`` scores with ``evaluation.waymo_style_eval``.

The dataset builder (reference :653-898) runs the pseudo-label factory
(``cpd_tpu_torch.unsupervised``) over processed sequences: ``create_ppscore``,
``create_outline_boxes``, ``create_track_groundtruth_database`` and
``create_waymo_infos``, and the command line

    python -m cpd_tpu_torch.datasets.waymo_unsupervised --func create_ppscore \
        --cfg_file tools/cfgs/dataset_configs/waymo_unsupervised_cproto.yaml \
        --processed_data_path <dir of sequences> [--device cpu] [--workers N]

(``--func create_outline_boxes`` next; the yaml is read by
``utils.yaml_subset``). The factory's two neighbour searches run on the CUDA
card unless ``--device cpu`` / ``device="cpu"`` is asked for; on the card the
sequences run one after another in this process (a forked worker cannot use
the parent's CUDA context), on the CPU in a pool of ``spawn`` workers.
"""
from __future__ import annotations

import pickle
from functools import partial
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from .box_np import points_in_boxes_mask_fast
from .dataset import DatasetTemplate
from .registry import register_dataset
from ..unsupervised.cproto import box_frame_inverse
from ..unsupervised.ppscore import points_rigid_transform


@register_dataset("WaymoUnsupervisedDataset")
class WaymoUnsupervisedDataset(DatasetTemplate):
    def __init__(self, dataset_cfg=None, class_names=None, training=True,
                 root_path=None, logger=None, **kw):
        super().__init__(dataset_cfg=dataset_cfg, class_names=class_names,
                         training=training, root_path=root_path, logger=logger, **kw)
        cfg = self.dataset_cfg
        self.data_path = Path(root_path or cfg.get("DATA_PATH", ".")) / cfg.get(
            "PROCESSED_DATA_TAG", "waymo_processed_data")
        self.mode = "train" if training else "test"
        split_cfg = cfg.get("DATA_SPLIT", {"train": "train", "test": "val"})
        self.split = split_cfg[self.mode]
        self.num_frames = int(cfg.get("NUM_FRAMES", 1))
        self.label_offset = float(cfg.get("LABEL_OFFSET", 0.0))
        self.init_label_generator = cfg.get("InitLabelGenerator", "MFCF")
        self.label_refiner = cfg.get("LabelRefiner", "C_PROTO")
        interval_cfg = cfg.get("SAMPLED_INTERVAL", {"train": 1, "test": 1})
        self.sampled_interval = int(interval_cfg.get(self.mode, 1))
        self.infos: List[dict] = []
        self._proto_cache: Dict[str, dict] = {}
        self._label_cache: Dict[str, dict] = {}
        if self.data_path.exists():
            self.load_infos()

    # ------------------------------------------------------------------
    def sequence_list(self) -> List[str]:
        split_file = Path(self.root_path or ".") / "ImageSets" / f"{self.split}.txt"
        if split_file.exists():
            seqs = [x.strip().replace(".tfrecord", "") for x in split_file.read_text().splitlines() if x.strip()]
        else:
            seqs = sorted(p.name for p in self.data_path.iterdir() if p.is_dir())
        return seqs

    def load_infos(self):
        self.infos = []
        tag = self.label_refiner or self.init_label_generator
        for seq in self.sequence_list():
            seq_dir = self.data_path / seq
            pkl = seq_dir / f"{seq}.pkl"
            if not pkl.exists():
                continue
            with open(pkl, "rb") as f:
                seq_infos = pickle.load(f)
            labels = None
            lab_pkl = seq_dir / f"{seq}_outline_{tag}.pkl"
            if lab_pkl.exists():
                with open(lab_pkl, "rb") as f:
                    labels = pickle.load(f)
                self._label_cache[seq] = labels
            for i, info in enumerate(seq_infos):
                self.infos.append({"sequence_name": seq, "sample_idx": i, "info": info})
        self.infos = self.infos[:: self.sampled_interval]

    def __len__(self):
        return len(self.infos)

    # ------------------------------------------------------------------
    def get_lidar(self, sequence_name: str, sample_idx: int) -> np.ndarray:
        """(N, 5) [x y z tanh(intensity) elongation]; NLZ points dropped."""
        f = self.data_path / sequence_name / f"{sample_idx:04d}.npy"
        pts = np.load(f).astype(np.float32)
        if pts.shape[1] >= 6:
            pts = pts[pts[:, 5] == -1][:, :5]
        else:
            pts = pts[:, :5] if pts.shape[1] >= 5 else np.pad(pts, ((0, 0), (0, 5 - pts.shape[1])))
        pts[:, 3] = np.tanh(pts[:, 3])
        return pts

    def _get_labels(self, seq: str):
        if seq not in self._label_cache:
            tag = self.label_refiner or self.init_label_generator
            pkl = self.data_path / seq / f"{seq}_outline_{tag}.pkl"
            with open(pkl, "rb") as f:
                self._label_cache[seq] = pickle.load(f)
        return self._label_cache[seq]

    def _get_protos(self, seq: str):
        if seq not in self._proto_cache:
            pkl = self.data_path / seq / f"{seq}_outline_{self.init_label_generator}_CSS_proto.pkl"
            with open(pkl, "rb") as f:
                self._proto_cache[seq] = pickle.load(f)["proto_points_set"]
        return self._proto_cache[seq]

    def get_points_multiframe(self, seq: str, idx: int, poses: List[np.ndarray]):
        """NUM_FRAMES pose-registered concat with a time channel (get_frame :344)."""
        cur = self.get_lidar(seq, idx)
        cur = np.concatenate([cur[:, :4], np.zeros((len(cur), 1), np.float32)], axis=1)
        if self.num_frames <= 1:
            return cur
        chunks = [cur]
        cur_pose_inv = np.linalg.inv(poses[idx])
        for k in range(1, self.num_frames):
            j = idx - k
            if j < 0:
                break
            pts = self.get_lidar(seq, j)
            world = points_rigid_transform(pts, poses[j])
            local = points_rigid_transform(world, cur_pose_inv)
            t = np.full((len(local), 1), -0.1 * k, np.float32)
            chunks.append(np.concatenate([local[:, :4], t], axis=1))
        return np.concatenate(chunks, axis=0)

    # ------------------------------------------------------------------
    def sample_prototype(self, seq: str, points: np.ndarray, label: dict, rng):
        """Build (good-object view, proto-completed view, kept boxes/cls/css/pid).

        Mirrors sample_prototype_cpu (waymo_unsupervised_dataset.py:205-331).
        """
        ref_cfg = self.dataset_cfg.get("RefinerConfig", {})
        tmin = dict(ref_cfg.get("DiscardThreshMin", {"Vehicle": 0.5, "Pedestrian": 0.5, "Cyclist": 0.5}))
        tmax = dict(ref_cfg.get("DiscardThreshMax", {"Vehicle": 0.7, "Pedestrian": 0.55, "Cyclist": 0.55}))
        protos = self._get_protos(seq)
        boxes = np.asarray(label["outline_box"], np.float32).reshape(-1, 7)
        names = np.asarray(label["outline_cls"]).reshape(-1)
        scores = np.asarray(label["outline_score"], np.float32).reshape(-1)
        pids = np.asarray(label.get("outline_proto_id", np.full(len(boxes), -1)), np.int64).reshape(-1)

        in_box = points_in_boxes_mask_fast(points[:, :3], boxes)  # (M, N)
        keep_no_obj = ~in_box.any(axis=0) if len(boxes) else np.ones(len(points), bool)
        keep_good = np.ones(len(points), bool)
        new_boxes, new_names, new_scores, new_pids, proto_clouds = [], [], [], [], []
        for i, (box, name, score, pid) in enumerate(zip(boxes, names, scores, pids)):
            name = str(name)
            if name not in ("Vehicle", "Pedestrian", "Cyclist"):
                keep_good &= ~in_box[i]
                continue
            lo, hi = tmin.get(name, 0.5), tmax.get(name, 0.7)
            ok = (score > min(lo, hi)) and (np.hypot(box[0], box[1]) < 75) and pid >= 0
            bank = protos.get(name, {}).get(int(pid)) if ok else None
            if not ok or bank is None or len(bank["points"]) == 0:
                keep_good &= ~in_box[i]
                continue
            new_boxes.append(box)
            new_names.append(name)
            css = (np.clip(score, lo, hi) - lo) / max(hi - lo, 1e-6)
            new_scores.append(css)
            new_pids.append(pid)
            # re-pose the canonical prototype bank into this box
            cloud = box_frame_inverse(np.asarray(bank["points"], np.float32), box)
            full = np.zeros((len(cloud), points.shape[1]), np.float32)
            full[:, :3] = cloud[:, :3]
            proto_clouds.append(full)

        points_good = points[keep_good]
        points_proto = np.concatenate(proto_clouds + [points[keep_no_obj]], axis=0) \
            if proto_clouds else points[keep_no_obj]
        if rng.integers(2):  # random aggressive sparsification of the raw view
            sel = rng.permutation(len(points_good))[: int(len(points_good) * 0.2)]
            points_good = points_good[sel]
        return (points_good, points_proto,
                np.asarray(new_boxes, np.float32).reshape(-1, 7),
                np.asarray(new_names), np.asarray(new_scores, np.float32),
                np.asarray(new_pids, np.int64))

    # ------------------------------------------------------------------
    def __getitem__(self, index):
        rec = self.infos[index]
        seq, idx = rec["sequence_name"], rec["sample_idx"]
        info = rec["info"]
        labels = self._get_labels(seq)
        label = labels[idx]
        pts = self.get_points_multiframe(seq, idx, self._seq_poses(seq))
        rng = np.random.default_rng(np.random.SeedSequence((self.seed, self.epoch, index)))

        data = {"frame_id": f"{seq}#{idx:04d}", "sequence_name": seq, "sample_idx": index}
        if self.training and self.label_refiner in ("C_PROTO", "C_PROTO_SI"):
            good, proto, boxes, names, css, pids = self.sample_prototype(seq, pts, label, rng)
            data.update({
                "points": good, "points1": proto, "gt_boxes": boxes,
                "gt_names": names, "css_score": css, "proto_group_id": pids,
            })
        else:
            boxes = np.asarray(label["outline_box"], np.float32).reshape(-1, 7)
            names = np.asarray(label["outline_cls"]).reshape(-1)
            keep = np.array([str(n) in self.class_names for n in names], bool)
            data.update({
                "points": pts, "gt_boxes": boxes[keep], "gt_names": names[keep],
            })
        return self.prepare_data(data)

    def _seq_poses(self, seq: str) -> List[np.ndarray]:
        if not hasattr(self, "_pose_cache"):
            self._pose_cache = {}
        if seq not in self._pose_cache:
            with open(self.data_path / seq / f"{seq}.pkl", "rb") as f:
                infos = pickle.load(f)
            self._pose_cache[seq] = [np.asarray(i["pose"]) for i in infos]
        return self._pose_cache[seq]

    # ------------------------------------------------------------------
    def generate_prediction_dicts(self, batch, pred_dicts, class_names, output_path=None):
        """Device outputs -> per-frame annotation dicts (reference :504)."""
        out = []
        b = batch["batch_size"]
        boxes = np.asarray(pred_dicts["pred_boxes"])
        scores = np.asarray(pred_dicts["pred_scores"])
        labels = np.asarray(pred_dicts["pred_labels"])
        valid = np.asarray(pred_dicts["pred_valid"])
        for i in range(b):
            m = valid[i]
            bx = boxes[i][m].copy()
            lb = labels[i][m]
            names = np.asarray(class_names)[np.clip(lb - 1, 0, len(class_names) - 1)]
            # Vehicle z offset correction (reference :535-539)
            if self.label_offset:
                bx[names == "Vehicle", 2] += self.label_offset
            if self.test_augmentor is not None and len(bx):
                bx = self.test_augmentor.backward(bx)
            out.append({
                "frame_id": batch["frame_id"][i],
                "boxes_lidar": bx,
                "score": scores[i][m],
                "name": names,
                "pred_labels": lb,
            })
        return out

    def evaluation(self, det_annos, class_names, eval_metric="waymo", **kwargs):
        from ..evaluation import waymo_style_eval

        gt_annos = kwargs.get("gt_annos")
        if gt_annos is None:
            gt_annos = self.collect_gt_annos()
        # the JAX package switches to the official TF estimator where
        # waymo_open_dataset is installed; its adapter is not ported, so the
        # NumPy TYPE_HUNGARIAN implementation scores here
        return waymo_style_eval(det_annos, gt_annos, class_names)

    def collect_gt_annos(self):
        annos = []
        for rec in self.infos:
            info = rec["info"]
            ann = info.get("annos", {})
            annos.append({
                "frame_id": f"{rec['sequence_name']}#{rec['sample_idx']:04d}",
                "gt_boxes_lidar": np.asarray(ann.get("gt_boxes_lidar", np.zeros((0, 7)))),
                "name": np.asarray(ann.get("name", [])),
                "num_points_in_gt": np.asarray(ann.get("num_points_in_gt", [])),
                "difficulty": np.asarray(ann.get("difficulty", [])),
            })
        return annos


# ---------------------------------------------------------------------------
# builder CLI (create_waymo_infos pipeline, reference :653-898)
# ---------------------------------------------------------------------------

def _each_sequence(fn, items, workers: int, device):
    """``fn(item, device=...)`` for every item: in this process on the card
    (or with one worker), else in a pool of ``spawn`` workers on the CPU."""
    from ..utils.device import resolve_device

    device = resolve_device(device)
    if device.type == "cuda" or workers <= 1:
        return [fn(item, device=device) for item in items]
    import multiprocessing as mp
    import os

    threads = max(1, (os.cpu_count() or 1) // workers)  # no oversubscribed torch threads
    with mp.get_context("spawn").Pool(workers, torch.set_num_threads, (threads,)) as pool:
        return pool.map(partial(fn, device=str(device)), items)


def create_ppscore(data_path: Path, seqs: List[str], workers: int = 16, device=None,
                   timer=None):
    """PPScore of every frame of every sequence (``ppscore/NNNN.npy``),
    counted by kernel R1 on ``device`` (default: the CUDA card)."""
    from ..unsupervised.driver import save_ppscore

    _each_sequence(partial(save_ppscore, timer=timer), [Path(data_path) / s for s in seqs],
                   workers, device)


def create_outline_boxes(data_path: Path, seqs: List[str], config: dict, workers: int = 16,
                         device=None, timer=None):
    """Pseudo-labels and prototype banks of every sequence
    (``<seq>_outline_<Refiner|Init>.pkl``, ``<seq>_outline_<Init>_CSS_proto.pkl``),
    clustered by kernel R2 on ``device`` (default: the CUDA card)."""
    fn = partial(_outline_one, data_path=data_path, config=config, timer=timer)
    _each_sequence(fn, seqs, workers, device)


def _outline_one(seq, data_path, config, device=None, timer=None):
    from ..unsupervised.driver import compute_outline_box

    return compute_outline_box(seq, data_path, config, device=device, timer=timer)


def create_track_groundtruth_database(dataset: WaymoUnsupervisedDataset, out_path: Path,
                                      min_points: int = 5):
    """Tracked-object db for gt sampling (reference :653; the pkl schema is
    documented in augmentor.DataBaseSampler)."""
    db: Dict[str, list] = {}
    for rec in dataset.infos:
        seq, idx = rec["sequence_name"], rec["sample_idx"]
        label = dataset._get_labels(seq)[idx]
        pts = dataset.get_lidar(seq, idx)
        boxes = np.asarray(label["outline_box"]).reshape(-1, 7)
        names = np.asarray(label["outline_cls"]).reshape(-1)
        masks = points_in_boxes_mask_fast(pts[:, :3], boxes)
        for i, (b, n) in enumerate(zip(boxes, names)):
            obj = pts[masks[i]]
            if len(obj) < min_points or str(n) not in dataset.class_names:
                continue
            db.setdefault(str(n), []).append({
                "name": str(n), "box3d_lidar": b.astype(np.float32),
                "points": obj.astype(np.float32), "num_points_in_gt": len(obj),
                "sequence_name": seq, "sample_idx": idx,
            })
    with open(out_path, "wb") as f:
        pickle.dump(db, f)
    return {k: len(v) for k, v in db.items()}


def create_waymo_infos(raw_data_path, processed_path, seqs=None, config=None,
                       workers: int = 16, dataset: WaymoUnsupervisedDataset = None,
                       device=None, timer=None):
    """Full builder pipeline (reference :792 create_waymo_infos): raw
    TFRecords -> processed npy/pkl -> PPScore -> outline labels -> gt db.
    The port has no TFRecord reader (``waymo_open_dataset`` is installed on
    neither machine), so, as the JAX function does without that package, it
    converts nothing and starts from the processed sequences ``seqs``
    (default: the names of the TFRecords under ``raw_data_path``)."""
    processed_path = Path(processed_path)
    if seqs is None:
        seqs = sorted(p.name.replace(".tfrecord", "")
                      for p in Path(raw_data_path).glob("*.tfrecord"))
    create_ppscore(processed_path, seqs, workers, device, timer)
    create_outline_boxes(processed_path, seqs, config or {}, workers, device, timer)
    if dataset is not None:
        create_track_groundtruth_database(
            dataset, processed_path / "track_dbinfos_train.pkl")


def main(argv=None):
    import argparse
    import time

    from ..utils.common import PhaseTimer
    from ..utils.yaml_subset import load_file

    p = argparse.ArgumentParser(description="Waymo pseudo-label dataset builder "
                                "(reference CLI: python -m cpd.datasets...)")
    p.add_argument("--func", default="create_waymo_infos",
                   choices=["create_waymo_infos", "create_ppscore", "create_outline_boxes"])
    p.add_argument("--cfg_file", required=True)
    p.add_argument("--raw_data_path", default=None)
    p.add_argument("--processed_data_path", required=True)
    p.add_argument("--workers", type=int, default=16)
    p.add_argument("--device", default="cuda",
                   help="torch device of the factory's kernels (default: the CUDA card)")
    args = p.parse_args(argv)
    cfg = load_file(args.cfg_file)
    timer = PhaseTimer()
    t0 = time.perf_counter()
    if args.func == "create_waymo_infos":
        create_waymo_infos(args.raw_data_path, args.processed_data_path,
                           config=cfg, workers=args.workers, device=args.device, timer=timer)
    else:
        seqs = sorted(q.name for q in Path(args.processed_data_path).iterdir() if q.is_dir())
        if args.func == "create_ppscore":
            create_ppscore(Path(args.processed_data_path), seqs, args.workers, args.device, timer)
        else:
            create_outline_boxes(Path(args.processed_data_path), seqs, cfg, args.workers,
                                 args.device, timer)
    print(f"{args.func}: {time.perf_counter() - t0:.1f} s; stages (s, this process): "
          + ", ".join(f"{k} {v:.2f}" for k, v in timer.totals.items()))
    return timer.totals


if __name__ == "__main__":
    main()
