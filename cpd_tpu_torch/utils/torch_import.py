"""Reference .pth -> the port's state dict (port of
cpd_tpu/utils/torch_import.py, without JAX or flax).

Imports published reference checkpoints (e.g. ``cpd_pretrained``) into the
port's ``VoxelRCNN``. The reference layout (module names from
cpd/models/backbones_3d/spconv_backbone.py:153-225, dense_heads/
center_head.py:73-94, backbones_2d/base_bev_backbone.py:29-60,
roi_heads/voxel_rcnn_head.py:78-163) is translated by the JAX package's rule
table into paths of its flax tree, and each converted leaf then through the
weight bridge's key and layout (``utils/weights.py``, as
``state_dict_from_jax`` maps a flax tree). Weight tensors are re-laid-out:

  * spconv 2.x SubM/SparseConv3d weight (Cout, kz, ky, kx, Cin) or 1.x
    (kz, ky, kx, Cin, Cout) -> (K=kz*ky*kx, Cin, Cout). The layout is
    detected by shape, mirroring the reference's own 1.x<->2.x adaptation
    (detector3d_template.py:394-408); Cin and Cout come from the port's own
    parameter, so the KITTI yaml's 4-channel input lands.
  * torch Conv2d (Cout, Cin, kh, kw) -> flax (kh, kw, Cin, Cout)
  * torch Linear (Cout, Cin) -> flax Dense (Cin, Cout)
  * BN weight/bias/running_mean/running_var -> scale/bias + batch_stats

and then flax -> torch by the bridge. Unmatched keys are reported, not fatal
(the reference loads non-strict for --pretrained_model,
detector3d_template.py:421).
"""
from __future__ import annotations

import re
from typing import Dict, List, Tuple

import numpy as np
import torch

from .weights import _key_and_layout, _to_jax, _to_torch


def convert_spconv_weight(w: np.ndarray, cin: int, cout: int) -> np.ndarray:
    """Any spconv kernel layout -> (K, Cin, Cout) by shape detection."""
    w = np.asarray(w)
    if w.ndim == 5:
        if w.shape[0] == cout and w.shape[-1] == cin:  # spconv 2.x (Cout, kz, ky, kx, Cin)
            k = int(np.prod(w.shape[1:4]))
            return np.transpose(w.reshape(cout, k, cin), (1, 2, 0))
        if w.shape[-1] == cout and w.shape[-2] == cin:  # spconv 1.x (kz, ky, kx, Cin, Cout)
            k = int(np.prod(w.shape[:3]))
            return w.reshape(k, cin, cout)
    raise ValueError(f"unrecognized spconv weight shape {w.shape} for cin={cin} cout={cout}")


def convert_conv2d_weight(w: np.ndarray) -> np.ndarray:
    """(Cout, Cin, kh, kw) -> (kh, kw, Cin, Cout)."""
    return np.transpose(np.asarray(w), (2, 3, 1, 0))


def convert_convtranspose2d_weight(w: np.ndarray) -> np.ndarray:
    """torch ConvTranspose2d (Cin, Cout, kh, kw) -> flax ConvTranspose
    (kh, kw, Cin, Cout) with the spatial taps FLIPPED: torch computes the
    conv adjoint (correlation with the flipped kernel) while flax's
    ConvTranspose applies the kernel unflipped. Verified exact against
    torch in tests/test_torch_import_reference.py. Also correct for the
    reference's stride-1 deblock (ConvTranspose2d kernel 1,
    base_bev_backbone.py:52-60) grafted onto our 1x1 nn.Conv: at k=1 the
    flip is a no-op and both reduce to x @ w[cin, cout]."""
    return np.ascontiguousarray(
        np.transpose(np.asarray(w), (2, 3, 0, 1))[::-1, ::-1])


def convert_linear_weight(w: np.ndarray) -> np.ndarray:
    return np.transpose(np.asarray(w), (1, 0))


# rule table: (reference regex) -> (our params path template, our batch_stats
# path template or None). {b} = siamese branch (branch0/branch1), {s} = stage.
# reference Sequential block index -> our a/b suffix. Stage 1 has no strided
# entry (blocks at 0,1); stages 2-4 lead with the strided post_act_block, so
# their SparseBasicBlocks sit at indices 1,2 (spconv_backbone.py:421-446).
_BLOCK_S1 = {"0": "a", "1": "b"}
_BLOCK_SN = {"1": "a", "2": "b"}


def _bn_paths(base: Tuple[str, ...]):
    return base + ("MaskedBatchNorm_0",)


def reference_key_rules() -> List[Tuple[str, callable]]:
    """Returns [(regex, fn(match) -> (kind, params_path))]; kind in
    {spconv, bn1d, conv2d, bn2d, linear}."""

    def backbone(m, branch, tail):
        return ("backbone", branch) + tail

    rules: List[Tuple[str, callable]] = []

    def add(pattern, fn):
        rules.append((pattern, fn))

    # --- sparse backbone ---------------------------------------------------
    def conv_input(m):
        b = "branch1" if m.group("mm") else "branch0"
        return [("spconv", ("backbone", b, "conv_input", "kernel"))] if m.group("t") == "0" \
            else _bn1d(("backbone", b, "conv_input"), m.group("p"))

    add(r"backbone_3d\.conv_input(?P<mm>_2)?\.(?P<t>\d)\.(?P<p>.+)", conv_input)

    def conv_stage(m):
        b = "branch1" if m.group("mm") else "branch0"
        stage = int(m.group("stage"))
        table = _BLOCK_S1 if stage == 1 else _BLOCK_SN
        blk = table.get(m.group("blk"), m.group("blk"))
        which = m.group("which")  # conv1/bn1/conv2/bn2 inside SparseBasicBlock
        base = ("backbone", b, f"res{stage}{blk}")
        sub = "SubMConvBN_0" if which in ("conv1", "bn1") else "SubMConvBN_1"
        if which.startswith("conv"):
            return [("spconv", base + (sub, "kernel"))]
        return _bn1d(base + (sub,), m.group("p"))

    add(r"backbone_3d\.conv(?P<stage>[1-4])(?P<mm>_2)?\.(?P<blk>\d)\."
        r"(?P<which>conv1|bn1|conv2|bn2)\.(?P<p>.+)", conv_stage)

    def conv_down(m):
        # stage-entry strided conv: conv{2,3,4}.0.{0: conv, 1: bn}
        b = "branch1" if m.group("mm") else "branch0"
        stage = int(m.group("stage"))
        base = ("backbone", b, f"down{stage}")
        if m.group("t") == "0":
            return [("spconv", base + ("kernel",))]
        return _bn1d(base, m.group("p"))

    add(r"backbone_3d\.conv(?P<stage>[2-4])(?P<mm>_2)?\.0\.(?P<t>\d)\.(?P<p>.+)", conv_down)

    def conv_out(m):
        b = "branch1" if m.group("mm") else "branch0"
        base = ("backbone", b, "conv_out")
        if m.group("t") == "0":
            return [("spconv", base + ("kernel",))]
        return _bn1d(base, m.group("p"))

    add(r"backbone_3d\.conv_out(?P<mm>_2)?\.(?P<t>\d)\.(?P<p>.+)", conv_out)

    # --- BEV backbone --------------------------------------------------------
    def bev_block(m):
        blk = int(m.group("blk"))
        layer = int(m.group("layer"))
        # reference Sequential (base_bev_backbone.py:32-47):
        # [ZeroPad(0), Conv(1), BN(2), ReLU(3)] then per inner layer i:
        # Conv at 4+3i, BN at 5+3i, ReLU at 6+3i. (Validated against the
        # reference module's own state dict in
        # tests/test_torch_import_reference.py.)
        if layer == 1:
            name = f"block{blk}_in"
            kind = "conv2d"
        elif layer == 2:
            name = f"block{blk}_in"
            kind = "bn2d"
        elif (layer - 4) % 3 == 0:
            kind = "conv2d"
            name = f"block{blk}_conv{(layer - 4) // 3}"
        else:
            kind = "bn2d"
            name = f"block{blk}_conv{(layer - 5) // 3}"
        base = ("bev_backbone", name)
        if kind == "conv2d":
            return [("conv2d", base + ("Conv_0", "kernel"))]
        return _bn2d(base + ("BatchNorm2d_0",), m.group("p"))

    add(r"backbone_2d\.blocks\.(?P<blk>\d)\.(?P<layer>\d+)\.(?P<p>.+)", bev_block)

    def bev_deblock(m):
        blk = int(m.group("blk"))
        layer = int(m.group("layer"))
        base = ("bev_backbone", f"deblock{blk}")
        if layer == 0:
            # the reference deblocks are ConvTranspose2d for every
            # UPSAMPLE_STRIDE >= 1 (base_bev_backbone.py:50-60) -- weight
            # layout (Cin, Cout, kh, kw), NOT Conv2d's (Cout, Cin, kh, kw)
            return [("convt2d", base + ("kernel",))]
        return _bn2d(("bev_backbone", f"deblock{blk}_bn"), m.group("p"))

    add(r"backbone_2d\.deblocks\.(?P<blk>\d)\.(?P<layer>\d+)\.(?P<p>.+)", bev_deblock)

    # --- center head ---------------------------------------------------------
    def ch_shared(m):
        if m.group("t") == "0":
            if m.group("p") == "weight":
                return [("conv2d", ("dense_head", "shared_conv", "kernel"))]
            if m.group("p") == "bias":
                return [("conv2d_bias", ("dense_head", "shared_conv", "bias"))]
            return []
        return _bn2d(("dense_head", "shared_bn"), m.group("p"))

    add(r"dense_head\.shared_conv\.(?P<t>\d)\.(?P<p>.+)", ch_shared)

    def ch_head(m):
        head = m.group("head")
        blk = int(m.group("blk"))
        sub = m.group("sub")
        base = ("dense_head", f"head_{head}")
        # SeparateHead branch (center_head.py:20-28): fc_list of NESTED
        # Sequential(Conv, BN, ReLU) blocks at indices 0..num_conv-2, then
        # the final Conv (UNnested) at index num_conv-1 -- so final-conv
        # keys have NO sub-index. (Validated against the reference module's
        # own state dict in tests/test_torch_import_reference.py.)
        p = m.group("p")
        if sub is None:
            name = "out"
        elif sub == "0":
            name = f"conv{blk}"
        else:
            return _bn2d(base + (f"bn{blk}",), p)
        if p == "weight":
            return [("conv2d", base + (name, "kernel"))]
        if p == "bias":
            return [("conv2d_bias", base + (name, "bias"))]
        return []

    add(r"dense_head\.heads_list\.\d\.(?P<head>hm|center|center_z|dim|rot)\."
        r"(?P<blk>\d+)(?:\.(?P<sub>\d+))?\.(?P<p>[a-z_]+)", ch_head)

    # --- RoI FC towers -------------------------------------------------------
    # Reference Sequential layout (voxel_rcnn_head.py:68-163, DP_RATIO > 0 --
    # the shipped CPD config family): each hidden layer occupies 4 indices
    # [Linear(bias=False), BatchNorm1d, ReLU, Dropout] except the LAST hidden
    # layer (3: no dropout), so the trailing biased Linear of the cls/reg
    # towers lands at index 4*(K-1)+3, i.e. i % 4 == 3. Hidden Linears are
    # bias-free, so every parameter key is classified by (i % 4, leaf name).
    _ROI_TOWERS = {
        "shared_fc_layers": "shared0", "shared_fc_layers_mm": "shared1",
        "cls_layers": "cls_tower0", "cls_layers_P": "cls_tower1",
        "reg_layers": "reg_tower0", "reg_layers_P": "reg_tower1",
    }

    def roi_tower(m):
        base = ("roi_head", _ROI_TOWERS[m.group("seq")])
        i = int(m.group("i"))
        p = m.group("p")
        r = i % 4
        if r == 0 and p == "weight":
            return [("linear", base + (f"fc{i // 4}", "kernel"))]
        if r == 1:
            return _bn_generic(base + (f"bn{i // 4}",), p)
        if r == 3 and p == "weight":
            return [("linear", base + ("out", "kernel"))]
        if r == 3 and p == "bias":
            return [("raw", base + ("out", "bias"))]
        return []

    add(r"roi_head\.(?P<seq>shared_fc_layers(?:_mm)?|cls_layers(?:_P)?|"
        r"reg_layers(?:_P)?)\.(?P<i>\d+)\.(?P<p>.+)", roi_tower)

    return rules


def _bn1d(base: Tuple[str, ...], p: str):
    bn = base + ("MaskedBatchNorm_0",)
    return _bn_generic(bn, p)


def _bn2d(base: Tuple[str, ...], p: str):
    return _bn_generic(base, p)


def _bn_generic(bn: Tuple[str, ...], p: str):
    if p == "weight":
        return [("raw", bn + ("scale",))]
    if p == "bias":
        return [("raw", bn + ("bias",))]
    if p == "running_mean":
        return [("stats", bn + ("mean",))]
    if p == "running_var":
        return [("stats", bn + ("var",))]
    return []


def _bridge_key(path):
    """The port's state-dict key of the flax leaf at ``path``."""
    return _key_and_layout(path, np.empty((1, 1, 1)))[0]


def _bridge_layout(path, torch_shape):
    """The bridge's layout of the flax leaf at ``path`` whose port tensor has
    ``torch_shape``: by the kernel's rank and, for a 4-D kernel, its taps
    (``kh``, axis 2 of a torch Conv2d / ConvTranspose2d weight)."""
    rank = len(torch_shape)
    probe = np.empty((torch_shape[2], 1, 1, 1) if rank == 4 else (1,) * rank)
    return _key_and_layout(path, probe)[1]


def convert_reference_state_dict(state_dict: Dict[str, np.ndarray], model):
    """Graft a reference state_dict onto a copy of ``model``'s state dict.

    Returns (state dict, report dict with matched / missed / shape_errors /
    ignored keys): the JAX package's ``convert_reference_state_dict`` on the
    model's own tree followed by ``state_dict_from_jax``, with the same
    report (shapes in the flax layout)."""
    own = model.state_dict()
    out = {k: v.detach().clone() for k, v in own.items()}
    rules = reference_key_rules()
    matched, missed, shape_errors = [], [], []

    def target(path):
        """(torch key, layout, flax-layout shape) of the leaf at ``path``,
        or None where the model has no such leaf."""
        key = _bridge_key(path)
        if key not in own:
            return None
        torch_shape = tuple(own[key].shape)
        layout = _bridge_layout(path, torch_shape)
        return key, layout, _to_jax(np.empty(torch_shape, np.uint8), layout).shape

    def set_path(path, value):
        found = target(path)
        if found is None:
            return False
        key, layout, shape = found
        if tuple(shape) != tuple(value.shape):
            shape_errors.append((path, shape, value.shape))
            return False
        arr = np.ascontiguousarray(_to_torch(value.astype(np.float32), layout))
        out[key] = torch.from_numpy(arr).to(own[key].dtype)
        return True

    ignored = []
    for key, val in state_dict.items():
        if key.endswith("num_batches_tracked"):
            # torch BN step counters; the port's norms keep none (fixed
            # momentum, matching the reference's momentum=0.01/0.1 configs)
            ignored.append(key)
            continue
        val = np.asarray(val)
        hit = False
        for pattern, fn in rules:
            m = re.fullmatch(pattern, key)
            if not m:
                continue
            for kind, path in fn(m):
                if kind == "spconv":
                    # the target's (K, Cin, Cout) gives cin/cout
                    found = target(path)
                    if found is None:
                        continue
                    try:
                        v = convert_spconv_weight(val, found[2][1], found[2][2])
                    except (ValueError, IndexError):
                        continue
                    hit |= set_path(path, v)
                elif kind == "conv2d":
                    hit |= set_path(path, convert_conv2d_weight(val))
                elif kind == "convt2d":
                    hit |= set_path(path, convert_convtranspose2d_weight(val))
                elif kind == "conv2d_bias" and key.endswith("bias"):
                    hit |= set_path(path, val)
                elif kind == "linear":
                    hit |= set_path(path, convert_linear_weight(val))
                elif kind in ("raw", "stats"):
                    hit |= set_path(path, val)
            if hit:
                break
        (matched if hit else missed).append(key)
    report = {"matched": matched, "missed": missed,
              "shape_errors": shape_errors, "ignored": ignored}
    return out, report
