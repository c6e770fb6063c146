"""Offline detection ensembling through Weighted Box Fusion, and checkpoint
averaging (port of tools/merge_detections.py; parity:
cpd/datasets/kitti/kitti_object_eval_python/merge_detections.py, WBF over
several result.pkl dumps such as TTA passes or model ensembles).

    python -m cpd_tpu_torch.tools.merge_detections out.pkl a/result.pkl b/result.pkl ... \
        [--device cpu]

The fusion runs on the CUDA card; ``--device cpu`` asks for the CPU, and
without a card and without it the tool raises. ``merge_detections_tracking``
smooths one result.pkl over its sequence with the pseudo-label factory's
Kalman tracker (``unsupervised.tracker.TrackSmooth``, NumPy on the host).
"""
from __future__ import annotations

import argparse
import pickle
from pathlib import Path

import numpy as np
import torch


def merge_result_files(paths, iou_thresh: float = 0.7, device=None):
    """Fuse the detections of each frame over the result.pkl files ``paths``
    (frames paired by position, as many as the shortest file has). Returns
    the merged list of detection records."""
    from ..ops import nms
    from ..utils.device import resolve_device

    device = resolve_device(device)
    all_results = []
    for p in paths:
        with open(p, "rb") as f:
            all_results.append(pickle.load(f))
    n = min(len(r) for r in all_results)
    merged = []
    for i in range(n):
        frames = [r[i] for r in all_results]
        boxes = np.concatenate([np.asarray(f["boxes_lidar"]).reshape(-1, 7) for f in frames])
        scores = np.concatenate([np.asarray(f["score"]).reshape(-1) for f in frames])
        names = np.concatenate([np.asarray(f["name"]).reshape(-1) for f in frames])
        if len(boxes) == 0:
            merged.append(frames[0])
            continue
        uniq = {n_: k for k, n_ in enumerate(sorted(set(names.tolist())))}
        labels = np.asarray([uniq[x] for x in names], np.int32)
        fused, fscores, flabels, mask = nms.weighted_box_fusion(
            torch.from_numpy(boxes.astype(np.float32)).to(device),
            torch.from_numpy(scores.astype(np.float32)).to(device),
            torch.from_numpy(labels).to(device), iou_thresh)
        m = mask.cpu().numpy()
        inv = {v: k for k, v in uniq.items()}
        merged.append({
            "frame_id": frames[0]["frame_id"],
            "boxes_lidar": fused.cpu().numpy()[m],
            "score": fscores.cpu().numpy()[m],
            "name": np.asarray([inv[int(l)] for l in flabels.cpu().numpy()[m]]),
        })
    return merged


def merge_detections_tracking(result_pkl, out_pkl, match_dist: float = 3.0,
                              min_track_len: int = 2):
    """Sequence-level detection smoothing via the Kalman tracker
    (merge_detections_tracking.py capability): track per-frame detections,
    re-emit smoothed track boxes with track-max scores."""
    from ..unsupervised.tracker import TrackSmooth

    with open(result_pkl, "rb") as f:
        dets = pickle.load(f)
    boxes = [np.asarray(d["boxes_lidar"]).reshape(-1, 7) for d in dets]
    scores = [np.asarray(d["score"]).reshape(-1) for d in dets]
    sm = TrackSmooth({"match_dist": match_dist}, min_track_len)
    sm.tracking(boxes, scores)
    out = []
    for f_i, d in enumerate(dets):
        b, names, ids, s = sm.get_current_frame_objects_and_cls(f_i)
        out.append({**d, "boxes_lidar": b.astype(np.float32), "score": np.asarray(s, np.float32),
                    "name": names, "track_ids": ids})
    with open(out_pkl, "wb") as f:
        pickle.dump(out, f)
    return out


def average_checkpoints(ckpt_paths, out_path):
    """Model-soup checkpoint averaging (merge_model.py capability): the mean
    of every floating-point tensor of the ``model_state`` of the ``.pth``
    files ``ckpt_paths`` (parameters and batch-norm statistics; integer
    tensors are the first file's), written with the first file's other
    fields to ``out_path``."""
    payloads = [torch.load(Path(p), map_location="cpu", weights_only=True) for p in ckpt_paths]
    states = [p["model_state"] for p in payloads]
    avg = {k: torch.stack([s[k] for s in states]).mean(0) if v.is_floating_point() else v
           for k, v in states[0].items()}
    out = dict(payloads[0], model_state=avg)
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(out, out_path)
    return out_path


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("out", help="the merged result.pkl to write")
    ap.add_argument("inputs", nargs="+", help="result.pkl files to fuse")
    ap.add_argument("--device", default=None,
                    help="torch device to fuse on (default: the CUDA card)")
    args = ap.parse_args(argv)
    merged = merge_result_files(args.inputs, device=args.device)
    with open(args.out, "wb") as f:
        pickle.dump(merged, f)
    print(f"merged {len(args.inputs)} result files -> {args.out} ({len(merged)} frames)")
    return merged


if __name__ == "__main__":
    main()
