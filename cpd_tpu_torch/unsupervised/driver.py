"""Pseudo-label pipeline driver with idempotent pkl caching (port of
cpd_tpu/unsupervised/driver.py).

Parity with cpd/unsupervised_core/__init__.py:16 ``compute_outline_box``:
registry {DBSCAN, OYSTER, MFCF} x {C_PROTO}, per-sequence dispatch, cached
outputs (every stage checks for its pkl and returns it if present --
the reference's recovery mechanism, SURVEY.md section 4).

``save_ppscore`` counts through kernel R1 and ``compute_outline_box``
clusters through kernel R2, on ``device`` (default: the CUDA card; ``"cpu"``
for the plain versions). With a ``timer`` (a ``utils.common.PhaseTimer``)
every stage adds its host seconds to it.
"""
from __future__ import annotations

import pickle
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from .cproto import CProtoRefiner, CSS
from .generators import DBSCANGenerator, MFCFGenerator, OYSTERGenerator
from .ppscore import ppscore_for_frame
from ..utils.common import timed
from ..utils.device import resolve_device

ALL_INIT = {
    "DBSCAN": DBSCANGenerator,
    "OYSTER": OYSTERGenerator,
    "MFCF": MFCFGenerator,
}
ALL_REFINE = {
    "C_PROTO": CProtoRefiner,
}


def load_sequence(seq_dir: Path) -> List[dict]:
    """Load a processed sequence: NNNN.npy point frames + <seq>.pkl infos
    (+ ppscore/NNNN.npy when precomputed). Mirrors the reference layout."""
    seq_dir = Path(seq_dir)
    with open(seq_dir / (seq_dir.name + ".pkl"), "rb") as f:
        infos = pickle.load(f)
    frames = []
    for i, info in enumerate(infos):
        pts = np.load(seq_dir / f"{i:04d}.npy")
        pp_path = seq_dir / "ppscore" / f"{i:04d}.npy"
        pp = np.load(pp_path).astype(np.float32) if pp_path.exists() else None
        frames.append({"points": pts, "pose": np.asarray(info["pose"]), "ppscore": pp,
                       "info": info})
    return frames


def save_ppscore(seq_dir: Path, window: int = 5, max_range: int = 30,
                 radius: float = 0.3, device=None, timer=None) -> None:
    """Precompute + cache per-frame PPScore arrays (precompute_ppscore.py:48),
    counted by kernel R1 on ``device`` (default: the CUDA card)."""
    device = resolve_device(device)
    seq_dir = Path(seq_dir)
    out_dir = seq_dir / "ppscore"
    out_dir.mkdir(exist_ok=True)
    with timed(timer, "load"):
        frames = load_sequence(seq_dir)
    pts = [f["points"] for f in frames]
    poses = [f["pose"] for f in frames]
    for i in range(len(frames)):
        out = out_dir / f"{i:04d}.npy"
        if out.exists():
            continue
        lo, hi = max(i - max_range, 0), min(i + max_range, len(frames))
        with timed(timer, "ppscore"):
            score = ppscore_for_frame(
                pts[i], poses[i], pts[lo:hi], poses[lo:hi],
                radius=radius, window=window, device=device,
            )
        np.save(out, score.astype(np.float16))


def compute_outline_box(seq_name: str, root_path, config: dict,
                        frames: Optional[List[dict]] = None, device=None, timer=None):
    """Run init generator + refiner for one sequence, with pkl caching.

    config keys (reference GeneratorConfig/RefinerConfig schema):
      InitLabelGenerator in {DBSCAN, OYSTER, MFCF}; LabelRefiner in {C_PROTO, None}.
    Returns the per-frame label dict {frame: {outline_box, outline_cls,
    outline_ids, outline_score, outline_proto_id}} and writes
    <seq>_outline_<Refiner|Init>.pkl + <seq>_CSS_proto.pkl. Clusters on
    ``device`` (default: the CUDA card).
    """
    device = resolve_device(device)
    init_name = config.get("InitLabelGenerator", "MFCF")
    refine_name = config.get("LabelRefiner", "C_PROTO")
    root = Path(root_path) if root_path is not None else None
    seq_dir = root / seq_name if root is not None else None
    tag = refine_name or init_name
    out_path = seq_dir / f"{seq_name}_outline_{tag}.pkl" if seq_dir else None
    if out_path is not None and out_path.exists():
        with open(out_path, "rb") as f:
            return pickle.load(f)

    if frames is None:
        with timed(timer, "load"):
            frames = load_sequence(seq_dir)

    gen_cfg = config.get("GeneratorConfig", {})
    gen_kw = {}
    if "cluster_dis" in gen_cfg:
        gen_kw["eps"] = float(gen_cfg["cluster_dis"])
    if "cluster_min_points" in gen_cfg:
        # clutter_min_points is a strictly-greater CLUSTER filter; the DBSCAN
        # core size stays at the reference's fixed 10 (outline_utils.py:532)
        gen_kw["min_samples"] = int(gen_cfg["cluster_min_points"])
    if init_name == "MFCF":
        gen_kw.pop("min_samples", None)
        if "cluster_min_points" in gen_cfg:
            gen_kw["min_points"] = int(gen_cfg["cluster_min_points"])
        if "ppscore_thresh" in gen_cfg:
            gen_kw["ppscore_thresh"] = float(gen_cfg["ppscore_thresh"])
        if "frame_num" in gen_cfg:
            gen_kw["window"] = int(gen_cfg["frame_num"])
        if "frame_interval" in gen_cfg:
            gen_kw["interval"] = int(gen_cfg["frame_interval"])
        if "remove_short_track" in gen_cfg:
            gen_kw["min_track_len"] = int(gen_cfg["remove_short_track"])
        gates = {}
        if "min_box_volume" in gen_cfg:
            gates["min_box_volume"] = float(gen_cfg["min_box_volume"])
        if "min_box_height" in gen_cfg:
            gates["min_box_height"] = float(gen_cfg["min_box_height"])
        if "max_box_volume" in gen_cfg:
            gates["max_box_volume"] = float(gen_cfg["max_box_volume"])
        if "max_box_len" in gen_cfg:
            gates["max_box_len"] = float(gen_cfg["max_box_len"])
        if "ground_min_threshold" in gen_cfg and "ground_min_distance" in gen_cfg:
            gates["ground_adjust"] = (
                float(np.asarray(gen_cfg["ground_min_threshold"]).reshape(-1)[0]),
                float(np.asarray(gen_cfg["ground_min_distance"]).reshape(-1)[1]),
            )
        if gates:
            gen_kw["gate_kw"] = gates
    generator = ALL_INIT[init_name](device=device, timer=timer, **gen_kw)
    if init_name == "MFCF":
        ground_kw = {}
        if "ground_max_threshold" in gen_cfg:
            ground_kw["max_threshold"] = float(gen_cfg["ground_max_threshold"])
        if "ground_min_threshold" in gen_cfg:
            ground_kw["min_threshold"] = tuple(gen_cfg["ground_min_threshold"])
        if "ground_min_distance" in gen_cfg:
            ground_kw["min_distance"] = tuple(gen_cfg["ground_min_distance"])
        generator.ground_kw = ground_kw
    labels = generator(frames)

    proto_points = {}
    if refine_name == "C_PROTO":
        ref_cfg = config.get("RefinerConfig", {})
        css_cfg = ref_cfg.get("CSSConfig", {})
        sizes = css_cfg.get("PredifinedSize")  # reference cfg key (sic)
        if sizes is not None:
            sizes = {k: tuple(v) for k, v in sizes.items()}
        refine_kw = {}
        if "GroundMin" in ref_cfg:
            refine_kw["ground_min_threshold"] = tuple(ref_cfg["GroundMin"])
        if "cluster_dis" in gen_cfg:
            refine_kw["cluster_eps"] = float(gen_cfg["cluster_dis"])
        if "cluster_min_points" in gen_cfg:
            refine_kw["cluster_min_points"] = int(gen_cfg["cluster_min_points"])
        if "ground_min_distance" in gen_cfg:
            refine_kw["ground_min_distance"] = tuple(gen_cfg["ground_min_distance"])
        if "ground_max_threshold" in gen_cfg:
            refine_kw["ground_max_threshold"] = float(gen_cfg["ground_max_threshold"])
        refiner = CProtoRefiner(
            css=CSS(mlo_parts=tuple(css_cfg.get("MLOParts", (9, 7, 5))),
                    predefined_size=sizes),
            basic_proto_thresh=ref_cfg.get("BasicProtoScoreThresh", 0.5),
            high_quality_num=ref_cfg.get("HighQualityProtoNum", 40),
            static_thresh=float(ref_cfg.get("HighQualityMotionThresh", 0.5)),
            orien_thresh=float(ref_cfg.get("OrienThresh", 0.6)),
            device=device, timer=timer,
            **refine_kw,
        )
        labels, proto_points = refiner(frames, labels)

    if out_path is not None:
        with open(out_path, "wb") as f:
            pickle.dump(labels, f)
        # per-class proto bank layout consumed by sample_prototype
        # (reference: <seq>_outline_<Init>_CSS_proto.pkl, 'proto_points_set')
        by_cls: Dict[str, dict] = {}
        for f_id, lab in labels.items():
            for tid, cls in zip(lab["outline_ids"], lab["outline_cls"]):
                tid = int(tid)
                if tid in proto_points:
                    by_cls.setdefault(str(cls), {})[tid] = {"points": proto_points[tid]}
        with open(seq_dir / f"{seq_name}_outline_{init_name}_CSS_proto.pkl", "wb") as f:
            pickle.dump({"proto_points_set": by_cls}, f)
    return labels
