"""Rotated BEV NMS with fixed-size outputs, the axis-aligned NMS, the
class-agnostic and per-class NMS of the model's post-processing, and weighted
box fusion (port of cpd_tpu/ops/nms.py).

The suppression runs on two kernels (``csrc/nms_bev.cu``), batched over
samples (or classes) in one launch each:

* B4b ``nms_mask_bev``: of score-sorted boxes (B, K, 7), the words (B, K,
  ceil(K/64)) whose bit j of row i is set when j > i, both rows are valid and
  their rotated IoU (BEV or 3D; the clip formulation of ``ops/iou3d.py``,
  skipped for the pairs ``iou3d.clip_reject`` finds disjoint) exceeds the
  threshold. The float IoU never exists. One block a strip of 4 rows of a
  64 x 64 tile on or above the diagonal; the pairs the reject lets through
  are clipped from a list, 32 a warp.
* B4c ``nms_suppress``: keep (B, K) from those words, greedy (a kept row
  removes the rows its words name; one block a sample, the next 64 rows'
  words prefetched into shared memory, so K is at most 14,400) or fast (a
  row survives when no valid row above it names it: suppressed rows still
  suppress; a block owns 4 words of a sample).

A CUDA tensor launches the kernel (``.launches`` counts) or raises; a CPU
tensor runs the plain version (``nms_mask_bev_reference``,
``nms_suppress_reference``).

Ties in the top-k selections go lowest index first, as ``jax.lax.top_k``
orders them: every top-k here is a stable descending sort, sliced."""
from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from .cuda_build import load, on_cuda
from .iou3d import (boxes_aligned_iou_bev, boxes_iou_bev, iou3d_from_overlap,
                    iou_bev_from_overlap, overlap_operands, pairwise_overlap_bev_reference)

_WORD = 64
_MASK_STRIP = 4  # rows a block of B4b takes of its 64 x 64 tile
_MASK_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_float, ctypes.c_int,
                                                               ctypes.c_void_p, ctypes.c_void_p]
_SUPPRESS_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
# the shared memory a block may hold on an H100; B4c's greedy walk keeps a
# word, ceil(K/64) words and two 64-row slabs of them there: K <= 14,400
_MAX_SMEM = 232_448
_GREEDY_MAX_WORDS = (_MAX_SMEM // 8 - 1) // (1 + 2 * _WORD)
# B4c's fast sweep: a block owns 4 words, the grid's second axis (<= 65535)
_FAST_MAX_WORDS = 4 * 65535


def top_k(values, k: int):
    """(values, indices) of the k largest along the last axis, ties lowest
    index first."""
    v, i = torch.sort(values, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def gather_rows(x, idx):
    """(B, N, ...) rows picked by (B, P) indices -> (B, P, ...)."""
    return torch.gather(x, 1, idx.reshape(*idx.shape, *([1] * (x.dim() - 2))).expand(
        *idx.shape, *x.shape[2:]))


def mask_words(k: int) -> int:
    """64-bit words a row of a K-row suppression mask holds."""
    return (k + _WORD - 1) // _WORD


def pack_mask_bits(bits):
    """(B, K, K) bool -> (B, K, ceil(K/64)) int64 words, bit j % 64 of word
    j // 64 (the words are the kernels' unsigned 64-bit ones)."""
    b, k, _ = bits.shape
    w = mask_words(k)
    padded = F.pad(bits, (0, w * _WORD - k)).reshape(b, k, w, _WORD).to(torch.int64)
    shifts = torch.arange(_WORD, dtype=torch.int64, device=bits.device)
    return (padded << shifts).sum(-1)


def unpack_mask_bits(mask, k: int):
    """(B, K, ceil(K/64)) words -> (B, K, K) bool."""
    shifts = torch.arange(_WORD, dtype=torch.int64, device=mask.device)
    return ((mask[..., None] >> shifts) & 1).flatten(-2)[..., :k].bool()


def _check_sorted_boxes(boxes, valid):
    if boxes.dim() != 3 or boxes.shape[2] < 7:
        raise ValueError(f"want boxes (B, K, 7+), got {tuple(boxes.shape)}")
    if valid.shape != boxes.shape[:2] or valid.dtype != torch.bool:
        raise ValueError(f"want a bool valid mask of {tuple(boxes.shape[:2])}, got "
                         f"{valid.dtype} {tuple(valid.shape)}")


def nms_mask_bev_reference(boxes, valid, thresh, use_bev_iou=True):
    """Plain PyTorch version of kernel B4b: (B, K, 7+) score-sorted boxes,
    (B, K) valid -> (B, K, ceil(K/64)) int64 words; bit j of row i is set
    when j > i, rows i and j are valid and IoU(i, j) > ``thresh``."""
    _check_sorted_boxes(boxes, valid)
    b7 = boxes[..., :7].float()
    k = b7.shape[1]
    overlap = pairwise_overlap_bev_reference(b7, b7)
    iou = (iou_bev_from_overlap if use_bev_iou else iou3d_from_overlap)(overlap, b7, b7)
    upper = torch.triu(torch.ones((k, k), dtype=torch.bool, device=b7.device), diagonal=1)
    return pack_mask_bits((iou > thresh) & upper & valid[:, :, None] & valid[:, None, :])


def mask_launch(corners, boxes, ok, thresh, use_bev_iou=True):
    """One launch of kernel B4b on ``overlap_operands``' corners and boxes
    and the (B, K) uint8 valid mask (counted in ``nms_mask_bev.launches``) ->
    (B, K, ceil(K/64)) int64 words."""
    bsz, k = ok.shape
    w = mask_words(k)
    if bsz > 65535 or w * (w + 1) // 2 * (_WORD // _MASK_STRIP) > 2 ** 31 - 1:
        raise ValueError(f"kernel B4b takes at most 65535 samples and 16383 words, got B={bsz}, "
                         f"K={k}")
    if corners.data_ptr() % 16:
        raise ValueError("kernel B4b reads the corners in 16-byte loads: they must be aligned")
    mask = torch.empty((bsz, k, w), dtype=torch.int64, device=ok.device)
    if mask.numel() == 0:
        return mask
    fn = load("nms_bev", _MASK_ARGTYPES, "cpd_nms_mask_bev")
    with torch.cuda.device(mask.device):
        err = fn(corners.data_ptr(), boxes.data_ptr(), ok.data_ptr(), bsz, k, float(thresh),
                 int(bool(use_bev_iou)), mask.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"nms_mask_bev kernel launch failed: CUDA error {err}")
    nms_mask_bev.launches += 1
    return mask


def nms_mask_bev(boxes, valid, thresh, use_bev_iou=True):
    """(B, K, 7+) score-sorted boxes, (B, K) bool valid -> (B, K,
    ceil(K/64)) int64 suppression words (see ``nms_mask_bev_reference``).
    CUDA tensors run kernel B4b (``nms_mask_bev.launches`` counts); CPU
    tensors the plain version."""
    _check_sorted_boxes(boxes, valid)
    if not on_cuda((("boxes", boxes), ("valid", valid)), contiguous=False):
        return nms_mask_bev_reference(boxes, valid, thresh, use_bev_iou)
    return mask_launch(*overlap_operands(boxes), valid.to(torch.uint8).contiguous(), thresh,
                       use_bev_iou)


nms_mask_bev.launches = 0


def nms_suppress_reference(mask, valid, fast=False):
    """Plain PyTorch version of kernel B4c: (B, K, ceil(K/64)) words, (B, K)
    valid -> keep (B, K) bool. Greedy: row by row, a valid row that no kept
    row removed is kept and removes the rows its bits name (the JAX
    ``_greedy_suppress`` loop, every sample at once). ``fast``: a valid row
    survives when no valid row above it names it (``_fast_suppress``)."""
    k = valid.shape[1]
    bits = unpack_mask_bits(mask, k)
    if fast:
        return valid & ~torch.any(bits & valid[:, :, None], dim=1)
    keep = torch.zeros_like(valid)
    removed = torch.zeros_like(valid)
    for i in range(k):
        kept = valid[:, i] & ~removed[:, i]
        keep[:, i] = kept
        removed = removed | (bits[:, i] & kept[:, None])
    return keep


def suppress_launch(words, ok, fast=False):
    """One launch of kernel B4c on contiguous int64 words and a (B, K) uint8
    valid mask (counted in ``nms_suppress.launches``) -> keep (B, K) bool."""
    bsz, k = ok.shape
    if mask_words(k) > (_FAST_MAX_WORDS if fast else _GREEDY_MAX_WORDS) or bsz > 2 ** 31 - 1:
        raise ValueError(f"kernel B4c takes K up to {64 * _GREEDY_MAX_WORDS} greedy (its shared "
                         f"memory) and {64 * _FAST_MAX_WORDS} fast, got K={k}")
    keep = torch.empty((bsz, k), dtype=torch.uint8, device=ok.device)
    if keep.numel() == 0:
        return keep.bool()
    fn = load("nms_bev", _SUPPRESS_ARGTYPES, "cpd_nms_suppress")
    with torch.cuda.device(keep.device):
        err = fn(words.data_ptr(), ok.data_ptr(), bsz, k, int(bool(fast)), keep.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"nms_suppress kernel launch failed: CUDA error {err}")
    nms_suppress.launches += 1
    return keep.bool()


def nms_suppress(mask, valid, fast=False):
    """(B, K, ceil(K/64)) int64 suppression words, (B, K) bool valid -> keep
    (B, K) bool (see ``nms_suppress_reference``). CUDA tensors run kernel B4c,
    the batch in one launch (``nms_suppress.launches`` counts); CPU tensors
    the plain version."""
    bsz, k = valid.shape
    if mask.shape != (bsz, k, mask_words(k)) or mask.dtype != torch.int64:
        raise ValueError(f"want int64 words of {(bsz, k, mask_words(k))}, got {mask.dtype} "
                         f"{tuple(mask.shape)}")
    if not on_cuda((("mask", mask), ("valid", valid)), contiguous=False):
        return nms_suppress_reference(mask, valid, fast)
    return suppress_launch(mask.contiguous(), valid.to(torch.uint8).contiguous(), fast)


nms_suppress.launches = 0


def _select_kept(keep, top_scores, order, post_max_size):
    """The kept rows first in score order, ``post_max_size`` of them ->
    (indices into the unsorted boxes, mask)."""
    sel_scores, sel = top_k(torch.where(keep, top_scores, -math.inf),
                            min(post_max_size, keep.shape[-1]))
    return torch.gather(order, -1, sel), torch.isfinite(sel_scores)


def nms_bev_batched(boxes, scores, thresh, pre_max_size=1024, post_max_size=256, valid=None,
                    use_bev_iou=True, fast=False):
    """Rotated NMS of every sample at once: boxes (B, N, 7+), scores (B, N),
    valid (B, N) -> (indices (B, post), keep_mask (B, post)); indices point
    into each sample's ``boxes``. Each sample's result equals ``nms_bev`` on
    it: the top ``pre_max_size`` by score (ties lowest index first), the
    suppression words (B4b; 3D IoU where ``use_bev_iou`` is False), greedy or
    ``fast`` suppression (B4c), the kept rows in score order."""
    bsz, n = scores.shape
    if valid is None:
        valid = torch.ones((bsz, n), dtype=torch.bool, device=scores.device)
    scores = torch.where(valid, scores, -math.inf)
    k = min(pre_max_size, n)
    top_scores, order = top_k(scores, k)
    top_valid = torch.isfinite(top_scores)
    top_boxes = gather_rows(boxes[..., :7], order)
    keep = nms_suppress(nms_mask_bev(top_boxes, top_valid, thresh, use_bev_iou), top_valid, fast)
    return _select_kept(keep, top_scores, order, post_max_size)


def nms_bev(boxes, scores, thresh, pre_max_size=1024, post_max_size=256, valid=None,
            use_bev_iou=True, fast=False):
    """Rotated-BEV NMS (3D IoU where ``use_bev_iou`` is False). boxes (N,
    7+), scores (N,) -> (indices (post,), keep_mask (post,)); indices point
    into ``boxes``. ``nms_bev_batched`` of one sample."""
    idx, mask = nms_bev_batched(boxes[None], scores[None], thresh, pre_max_size, post_max_size,
                                None if valid is None else valid[None], use_bev_iou, fast)
    return idx[0], mask[0]


def nms_normal_bev(boxes, scores, thresh, pre_max_size=1024, post_max_size=256, valid=None):
    """NMS on the axis-aligned BEV footprints (``boxes_aligned_iou_bev``):
    the suppression words built with torch, the greedy sweep on B4c."""
    n = boxes.shape[0]
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=boxes.device)
    scores = torch.where(valid, scores, -math.inf)
    k = min(pre_max_size, n)
    top_scores, order = top_k(scores, k)
    top_valid = torch.isfinite(top_scores)
    top_boxes = boxes[order][:, :7]
    upper = torch.triu(torch.ones((k, k), dtype=torch.bool, device=boxes.device), diagonal=1)
    bits = ((boxes_aligned_iou_bev(top_boxes, top_boxes) > thresh) & upper
            & top_valid[:, None] & top_valid[None, :])
    keep = nms_suppress(pack_mask_bits(bits[None]), top_valid[None])[0]
    return _select_kept(keep, top_scores, order, post_max_size)


def class_agnostic_nms(box_scores, box_preds, nms_config, score_thresh=None, valid=None):
    """NMS over all classes at once under ``nms_config`` (NMS_THRESH,
    NMS_PRE_MAXSIZE, NMS_POST_MAXSIZE, USE_FAST_NMS) -> (indices, keep mask,
    scores of the kept boxes, 0 elsewhere)."""
    n = box_scores.shape[0]
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=box_scores.device)
    if score_thresh is not None:
        valid = valid & (box_scores >= score_thresh)
    idx, mask = nms_bev(box_preds, box_scores, thresh=nms_config["NMS_THRESH"],
                        pre_max_size=int(nms_config["NMS_PRE_MAXSIZE"]),
                        post_max_size=int(nms_config["NMS_POST_MAXSIZE"]), valid=valid,
                        fast=bool(nms_config.get("USE_FAST_NMS", False)))
    return idx, mask, torch.where(mask, box_scores[idx], 0.0)


def multi_classes_nms(cls_scores, box_preds, nms_config, score_thresh=None, valid=None):
    """Per-class NMS of (N, num_classes) scores -> (indices, masks, scores),
    each (num_classes, post_max): the class axis stays fixed. The classes are
    the batch axis of one ``nms_bev_batched`` call."""
    n, c = cls_scores.shape
    scores = cls_scores.T
    keep_in = torch.ones((c, n), dtype=torch.bool, device=cls_scores.device)
    if valid is not None:
        keep_in = keep_in & valid[None, :]
    if score_thresh is not None:
        keep_in = keep_in & (scores >= score_thresh)
    idx, mask = nms_bev_batched(
        box_preds[None].expand(c, -1, -1), scores, thresh=nms_config["NMS_THRESH"],
        pre_max_size=int(nms_config["NMS_PRE_MAXSIZE"]),
        post_max_size=int(nms_config["NMS_POST_MAXSIZE"]), valid=keep_in,
        fast=bool(nms_config.get("USE_FAST_NMS", False)))
    return idx, mask, torch.where(mask, torch.gather(scores, 1, idx), 0.0)


def weighted_box_fusion(boxes, scores, labels, iou_thresh=0.7, valid=None):
    """Weighted Box Fusion with a circular-mean yaw (port of
    cpd_tpu/ops/nms.py::weighted_box_fusion; parity: model_nms_utils.py:14
    ``compute_WBF``). Greedy rotated NMS at ``iou_thresh`` picks the
    survivors; every valid box of a survivor's label whose rotated IoU with
    it is at least ``iou_thresh`` joins its cluster, and the survivor becomes
    the score-weighted mean of its cluster (yaw through the mean of sin and
    cos). Static shapes: boxes (N, 7+), scores (N,), labels (N,) ->
    (fused (N, 7), scores (N,), labels (N,), keep_mask (N,)), the survivors
    first in score order, zeros where ``keep_mask`` is False."""
    n = boxes.shape[0]
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=boxes.device)
    keep_idx, keep_mask = nms_bev(boxes, scores, thresh=iou_thresh, pre_max_size=n,
                                  post_max_size=n, valid=valid)
    iou = boxes_iou_bev(boxes[keep_idx][:, :7], boxes[:, :7])  # (K, N)
    same_label = labels[keep_idx][:, None] == labels[None, :]
    member = (iou >= iou_thresh) & valid[None, :] & keep_mask[:, None] & same_label
    w = torch.where(member, scores[None, :], 0.0)
    wn = w / torch.clamp(w.sum(dim=1, keepdim=True), min=1e-6)
    fused_xyzdim = wn @ boxes[:, :6]
    fused_yaw = torch.atan2(wn @ torch.sin(boxes[:, 6]), wn @ torch.cos(boxes[:, 6]))
    fused = torch.cat([fused_xyzdim, fused_yaw[:, None]], dim=-1)
    fused = torch.where(keep_mask[:, None], fused, 0.0)
    fused_scores = torch.where(keep_mask, scores[keep_idx], 0.0)
    fused_labels = torch.where(keep_mask, labels[keep_idx], 0)
    return fused, fused_scores, fused_labels, keep_mask
