"""A detector's f32 predict held to a stored reference of the same predict.

The reference is a ``.npz`` of a predict at the bench configuration (written
by the tests from the JAX package; see ``tests/test_torch_port_bench_parity.py``):
the weights that differ from ``seeded_state_dict``, and of the predict what
locates a fault: each backbone stage's valid count and keys (sorted, stored
as deltas), a sample of its feature rows, the heatmap whole and a sample of
the other head maps' cells, the proposals and the detections. Numpy and
torch only, so that the card's smoke run reads the same file.

Tiers: keys, counts, RoI validity and labels exact; features, head maps and
RoIs within ``FLOAT_TIER`` of the reference's scale (its largest magnitude),
RoIs paired by box (two whose scores tie within the tier may swap rows);
detections paired by box, the same count and labels, every pair's box within
``FLOAT_TIER`` of the scale and its score within ``SCORE_TIER``.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..ops import gather_gemm, sparse
from .weights import seeded_state_dict

STAGES = ("x_conv1", "x_conv2", "x_conv3", "x_conv4", "encoded")
HEAD_MAPS = ("hm", "center", "center_z", "dim", "rot")
ROI_KEYS = ("rois", "roi_scores", "roi_labels", "roi_valid")
PRED_KEYS = ("pred_boxes", "pred_scores", "pred_labels", "pred_valid")
FLOAT_TIER = 1e-4
SCORE_TIER = 1e-3
SEP = "::"  # the path separator of tests/torch_port_refs
INVALID_KEY = 2**31 - 1


def load_reference(path):
    """The reference ``.npz`` as nested dicts of arrays."""
    root = {}
    with np.load(path, allow_pickle=False) as data:
        for key in data.files:
            *parents, leaf = key.split(SEP)
            node = root
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = data[key]
    return root


def reference_state_dict(model, ref):
    """``seeded_state_dict(model, seed)`` with the reference's own tensors
    (scaled output layers, calibrated norm statistics) put over it."""
    sd = seeded_state_dict(model, int(ref["meta"]["weight_seed"]))
    for key, arr in ref["weights"].items():
        if key not in sd or tuple(sd[key].shape) != arr.shape:
            raise KeyError(f"reference tensor {key} {arr.shape} fits no tensor of the model")
        sd[key] = torch.from_numpy(np.array(arr, np.float32))
    return sd


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.is_floating_point() else x).cpu().numpy()
    return np.asarray(x)


def record(out, pred, b=0):
    """Sample ``b`` of a forward's outputs and its post-processing, from
    either package (torch tensors or numpy arrays), as numpy: per stage (the
    valid keys, the feature table), the head maps (H, W, C), the proposals
    and the detections."""
    stages = {}
    for name in STAGES:
        feats, keys = out["backbone_out"][name][:2]
        keys = _np(keys[b]).astype(np.int64)
        n = int((keys != INVALID_KEY).sum())  # sorted, padded at the end
        stages[name] = (keys[:n], _np(feats[b]).astype(np.float32))
    return {"stages": stages,
            "head": {k: _np(out["head_preds"][k][b]).astype(np.float32) for k in HEAD_MAPS},
            "rois": {k: _np(out[k][b]) for k in ROI_KEYS},
            "pred": {k: _np(pred[k][b]) for k in PRED_KEYS}}


def decode_keys(deltas):
    return np.cumsum(np.asarray(deltas, np.int64))


def _scaled(what, got, want, tier, lines, misses):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    scale = max(float(np.abs(want).max()) if want.size else 0.0, 1e-3)
    err = float(np.abs(got - want).max()) if want.size else 0.0
    worst = int(np.abs(got - want).reshape(len(want), -1).max(-1).argmax()) if want.size else 0
    lines.append(f"{what}: max err {err:.3e} at scale {scale:.3e} ({err / scale:.2e} of it)")
    if not err <= tier * scale:
        misses.append(f"{what}: max err {err:.3e} > {tier:g} of scale {scale:.3e}; worst row "
                      f"{worst}: got {got[worst].ravel()[:8].tolist()} want "
                      f"{want[worst].ravel()[:8].tolist()}")


def _exact(what, got, want, misses):
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape:
        misses.append(f"{what}: shape {got.shape} against {want.shape}")
        return False
    bad = np.nonzero(got.ravel() != want.ravel())[0]
    if len(bad):
        misses.append(f"{what}: {len(bad)} of {got.size} differ, first at {bad[0]}: got "
                      f"{got.ravel()[bad[0]]} want {want.ravel()[bad[0]]}")
        return False
    return True


def compare(rec, ref):
    """(report lines, misses) of a ``record`` against the reference."""
    lines, misses = [], []
    for name in STAGES:
        want = ref["stages"][name]
        keys, feats = rec["stages"][name]
        want_keys = decode_keys(want["key_deltas"])
        if len(keys) != int(want["count"]):
            misses.append(f"{name}: {len(keys)} valid keys, the reference {int(want['count'])}")
        n = min(len(keys), len(want_keys))
        bad = np.nonzero(keys[:n] != want_keys[:n])[0]
        if len(bad):
            i = int(bad[0])
            misses.append(f"{name}: first differing key at row {i}: {keys[i]} against "
                          f"{want_keys[i]} ({len(bad)} rows differ)")
            continue
        if len(keys) != len(want_keys):
            continue
        lines.append(f"{name}: {len(keys)} keys equal")
        _scaled(f"{name} features ({len(want['rows'])} rows)", feats[want["rows"]],
                want["features"], FLOAT_TIER, lines, misses)
    for name in HEAD_MAPS:
        want = ref["head"][name]
        got = rec["head"][name]
        if isinstance(want, dict):
            _scaled(f"head {name} ({len(want['cells'])} cells)", got.ravel()[want["cells"]],
                    want["values"], FLOAT_TIER, lines, misses)
        else:
            _scaled(f"head {name}", got.reshape(-1, got.shape[-1]),
                    want.reshape(-1, want.shape[-1]), FLOAT_TIER, lines, misses)
    _rois(rec["rois"], ref["rois"], lines, misses)
    _detections(rec["pred"], ref["pred"], lines, misses)
    return lines, misses


def _pair_boxes(boxes, want_boxes):
    """Row of ``want_boxes`` nearest to each row of ``boxes`` (centre and
    size); None where two rows pair with one."""
    d = np.abs(boxes[:, None, :6] - want_boxes[None, :, :6]).max(-1)
    nearest = d.argmin(1)
    return nearest if len(set(nearest.tolist())) == len(boxes) else None


def _rois(rois, want, lines, misses):
    """The proposals come sorted by score: two whose scores tie within
    rounding may come in either order, so each RoI is paired with the
    reference's nearest by box, and a pair may sit at another row only where
    the two rows' reference scores are within the tier."""
    if not _exact("roi_valid", rois["roi_valid"], want["roi_valid"], misses):
        return
    v = np.asarray(want["roi_valid"], bool)
    rows = np.nonzero(v)[0]
    boxes, want_boxes = (np.asarray(r["rois"], np.float32)[rows] for r in (rois, want))
    pair = _pair_boxes(boxes, want_boxes)
    if pair is None:
        misses.append("rois: two paired with one reference RoI")
        return
    scores = np.asarray(want["roi_scores"], np.float32)[rows]
    scale = max(float(np.abs(scores).max()), 1e-3)
    moved = np.nonzero(pair != np.arange(len(rows)))[0]
    if (np.abs(scores[pair[moved]] - scores[moved]) > FLOAT_TIER * scale).any():
        misses.append(f"rois: order differs beyond score ties at rows {rows[moved][:8].tolist()}")
    lines.append(f"rois: {len(rows)} valid, {len(moved)} at another row (score ties)")
    _exact("roi_labels", np.asarray(rois["roi_labels"])[rows],
           np.asarray(want["roi_labels"])[rows][pair], misses)
    _scaled(f"rois ({len(rows)} valid)", boxes, want_boxes[pair], FLOAT_TIER, lines, misses)
    _scaled("roi_scores", np.asarray(rois["roi_scores"], np.float32)[rows][:, None],
            scores[pair][:, None], FLOAT_TIER, lines, misses)


def _detections(pred, want, lines, misses):
    p_idx = np.nonzero(np.asarray(pred["pred_valid"], bool))[0]
    r_idx = np.nonzero(np.asarray(want["pred_valid"], bool))[0]
    if len(p_idx) != len(r_idx):
        misses.append(f"detections: {len(p_idx)} against the reference's {len(r_idx)}")
        return
    pb = np.asarray(pred["pred_boxes"], np.float32)[p_idx]
    nearest = _pair_boxes(pb, np.asarray(want["pred_boxes"], np.float32)[r_idx])
    if nearest is None:
        misses.append("detections: two paired with one reference box")
        return
    r_idx = r_idx[nearest]
    _exact("detection labels", np.asarray(pred["pred_labels"])[p_idx],
           np.asarray(want["pred_labels"])[r_idx], misses)
    _scaled(f"detection boxes ({len(p_idx)} pairs)", pb, np.asarray(want["pred_boxes"],
                                                                    np.float32)[r_idx],
            FLOAT_TIER, lines, misses)
    score_err = np.abs(np.asarray(pred["pred_scores"], np.float32)[p_idx]
                       - np.asarray(want["pred_scores"], np.float32)[r_idx])
    err = float(score_err.max()) if len(score_err) else 0.0
    lines.append(f"detection scores: max err {err:.3e}")
    if not err <= SCORE_TIER:
        misses.append(f"detection scores: max err {err:.3e} > {SCORE_TIER:g} (pair "
                      f"{int(score_err.argmax())})")


@contextlib.contextmanager
def plain_sparse_convs():
    """Inside the scope the sparse convs compute with the plain versions of
    A1 and A2, whatever the device: the same sums in another order."""
    saved = (sparse.gather_gemm, sparse.gather_gemm_dw)
    sparse.gather_gemm = lambda table, idx, found, w, out_dtype=torch.float32: \
        gather_gemm.gather_gemm_reference(table, idx, found, w, out_dtype)
    sparse.gather_gemm_dw = gather_gemm.gather_gemm_dw_reference
    try:
        yield
    finally:
        sparse.gather_gemm, sparse.gather_gemm_dw = saved


def loss_and_gradients(model, batch, seed, proposals=None):
    """One training step's forward and backward of ``model`` (put in
    training mode; its gradients are set anew): the RoI sampling and dropout
    drawn from a generator seeded ``seed`` on the batch's device, and, given
    ``proposals`` (the dict of ``rois``, ``roi_scores``, ``roi_labels``,
    ``roi_valid``), those in place of its RPN's: the RoI head is
    discontinuous in its proposals, so two runs that differ by rounding are
    compared on the same ones. Returns (loss, tb, {parameter: gradient},
    the proposals used)."""
    model.train()
    model.zero_grad(set_to_none=True)
    head = model.dense_head
    made = {}

    def proposals_of(*args, **kwargs):
        made.update(proposals if proposals is not None
                    else type(head).generate_predicted_boxes(head, *args, **kwargs))
        return dict(made)

    head.generate_predicted_boxes = proposals_of
    try:
        generator = torch.Generator(device=batch["points"].device).manual_seed(seed)
        loss, tb = model.loss_step(batch, generator=generator)
        loss.backward()
    finally:
        del head.generate_predicted_boxes
    grads = {n: p.grad.detach().float().clone() for n, p in model.named_parameters()
             if p.grad is not None}
    tb = {k: float(v.detach()) if isinstance(v, torch.Tensor) else float(v)
          for k, v in tb.items()}
    return float(loss.detach()), tb, grads, made


def gradient_errors(got, want):
    """How far ``got``'s gradients lie from ``want``'s (both {parameter:
    gradient} of the same leaves): each leaf's largest difference over the
    largest magnitude of ``want``'s gradients in the leaf's module (a conv's
    bias that feeds a norm in training mode has an exact gradient of 0, and
    rounding is all there is of it), the whole gradient's cosine and its
    norm ratio."""
    if set(got) != set(want):
        raise KeyError(f"gradient leaves differ: {sorted(set(got) ^ set(want))[:8]}")
    scales = {}
    for name, w in want.items():
        module = name.rsplit(".", 1)[0]
        scales[module] = max(scales.get(module, 1e-30), float(w.abs().max()))
    leaves = {n: float((got[n] - w).abs().max()) / scales[n.rsplit(".", 1)[0]]
              for n, w in want.items()}
    a = torch.cat([got[n].flatten().double() for n in want])
    b = torch.cat([want[n].flatten().double() for n in want])
    return {"leaves": leaves, "cosine": float(a @ b / (a.norm() * b.norm())),
            "norm_ratio": float(a.norm() / b.norm())}


def _distances(errors):
    worst = max(errors["leaves"], key=errors["leaves"].get)
    return {"worst leaf": errors["leaves"][worst], "1 - cosine": 1.0 - errors["cosine"],
            "|1 - norm ratio|": abs(1.0 - errors["norm_ratio"])}, worst


# the least each distance of ``compare_gradients`` is allowed, whatever the noise
GRADIENT_FLOORS = {"worst leaf": 2e-5, "1 - cosine": 1e-9, "|1 - norm ratio|": 1e-6}


def compare_gradients(got, want, noise, factor):
    """(report lines, misses): ``gradient_errors(got, want)`` against
    ``noise``, the errors of a run that differs from ``want`` only in the
    order of its sums: the worst leaf, 1 - cosine and the norm ratio's
    distance from 1 each within ``factor`` times the noise's (and never
    held below ``GRADIENT_FLOORS``). On a whole detector's step a leaf moves
    by up to about 1e-2 of its module's scale under reordering alone (batch
    norms in training mode cancel most of their input gradient), so no fixed
    tier holds every leaf."""
    got_d, got_worst = _distances(gradient_errors(got, want))
    noise_d, noise_worst = _distances(noise)
    misses = [f"gradients: {k} {v:.3e} > {factor:g} x the reordering's {noise_d[k]:.3e}"
              for k, v in got_d.items()
              if not v <= max(factor * noise_d[k], GRADIENT_FLOORS[k])]
    lines = [f"{len(want)} gradient leaves: " + ", ".join(
        f"{k} {v:.3e} (reordering alone {noise_d[k]:.3e})" for k, v in got_d.items())
        + f"; worst leaf {got_worst} (reordering: {noise_worst})"]
    return lines, misses
