"""Weights for the port: the JAX parameter tree bridge and seeded weights.

``state_dict_from_jax`` maps the JAX package's ``{"params", "batch_stats"}``
tree (numpy leaves) to this package's state dict. Module names follow the
flax tree, with flax's auto-names renamed (``SubMConvBN_0/1`` -> ``conv1/2``,
``MaskedBatchNorm_0``/``BatchNorm2d_0`` -> ``bn``, ``Conv_0`` -> ``conv``) and
the GridPoolBranch MLP layers (``Dense_0..7``, flax's creation order) mapped
to ``mlp_{scale}_{group}.{0,2}``; the anchor head V2's branches keep their
names with ``Conv_0`` / ``BatchNorm2d_0`` / ``Conv_1`` -> ``conv`` / ``bn`` /
``out``, and PillarVFE's ``MaskedBatchNorm_{i}`` beside ``pfn{i}`` becomes
``bn{i}``. Leaves change layout:

* sparse conv kernels (K, Cin, Cout) pass through unchanged;
* flax Conv (kh, kw, Cin, Cout) -> torch (Cout, Cin, kh, kw);
* the stride-2 flax ConvTranspose deblock (kh, kw, Cin, Cout) -> torch
  ConvTranspose2d (Cin, Cout, kh, kw) with the spatial taps flipped (flax
  applies the kernel unflipped; torch computes the conv adjoint);
* Dense (Cin, Cout) -> Linear (Cout, Cin);
* BN scale/bias/mean/var -> weight/bias/running_mean/running_var.

The MM modules (``branch1``, ``pool_branch_mm``, ``shared1``, ``cls_tower1``,
``reg_tower1``) follow the same rules. ``grads_to_jax_tree`` is the bridge's
inverse for gradients: the port's parameter gradients in the layout of the
flax ``params`` tree (transposes and the ConvTranspose flip undone), so that
tests compare gradients leaf by leaf.

``seeded_state_dict`` fills every parameter and buffer of a model from
``numpy.random.default_rng(seed)`` with spread (running variances in
[0.5, 2], spread head biases), so scores do not sit on the thresholds.
"""
from __future__ import annotations

import re

import numpy as np
import torch

from ..models.norm import _RunningNorm
from ..models.roi_head import SCALE_SPECS

_SEGMENTS = {"SubMConvBN_0": "conv1", "SubMConvBN_1": "conv2", "MaskedBatchNorm_0": "bn",
             "BatchNorm2d_0": "bn", "Conv_0": "conv", "Conv_1": "out"}
_LEAVES = {"scale": "weight", "bias": "bias", "mean": "running_mean",
           "var": "running_var"}
# flax creation order of GridPoolBranch's MLP Dense layers
_MLP_GROUPS = [(name, gi) for name, _, *groups in SCALE_SPECS for gi in range(len(groups))]


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _key_and_layout(path, leaf):
    """One JAX leaf -> (torch key, layout): how the leaf's axes map, one of
    "same", "dense", "conv", "deconv"."""
    *mods, name = path
    if mods and re.fullmatch(r"Dense_\d+", mods[-1]):  # GridPoolBranch MLPs
        i = int(mods[-1].split("_")[1])
        scale, gi = _MLP_GROUPS[i // 2]
        mods = mods[:-1] + [f"mlp_{scale}_{gi}", str(2 * (i % 2))]
    if mods[:1] == ["vfe"]:  # PillarVFE: pfn{i} and its MaskedBatchNorm_{i}
        mods = [re.sub(r"^MaskedBatchNorm_(\d+)$", r"bn\1", m) for m in mods]
    mods = [_SEGMENTS.get(m, m) for m in mods]
    layout = "same"
    if name == "kernel":
        if leaf.ndim == 2:
            layout = "dense"
        elif leaf.ndim == 4 and re.fullmatch(r"deblock\d+", mods[-1]) and leaf.shape[0] > 1:
            layout = "deconv"
        elif leaf.ndim == 4:
            layout = "conv"
        elif leaf.ndim != 3:  # sparse conv kernels pass through
            raise ValueError(f"unexpected kernel rank at {'/'.join(path)}: {leaf.shape}")
        key = "weight"
    elif name in _LEAVES:
        key = _LEAVES[name]
    else:
        raise KeyError(f"unmapped JAX leaf {'/'.join(path)}")
    return ".".join(mods + [key]), layout


def _to_torch(leaf, layout):
    if layout == "dense":  # (Cin, Cout) -> (Cout, Cin)
        return leaf.T
    if layout == "conv":  # (kh, kw, Cin, Cout) -> (Cout, Cin, kh, kw)
        return np.transpose(leaf, (3, 2, 0, 1))
    if layout == "deconv":  # (kh, kw, Cin, Cout) -> (Cin, Cout, kh, kw), taps flipped
        return np.transpose(leaf[::-1, ::-1], (2, 3, 0, 1))
    return leaf


def _to_jax(arr, layout):
    if layout == "dense":
        return arr.T
    if layout == "conv":
        return np.transpose(arr, (2, 3, 1, 0))
    if layout == "deconv":
        return np.transpose(arr, (2, 3, 0, 1))[::-1, ::-1]
    return arr


def _convert(path, leaf):
    """One JAX leaf -> (torch key, array)."""
    key, layout = _key_and_layout(path, leaf)
    return key, np.ascontiguousarray(_to_torch(leaf, layout))


def grads_to_jax_tree(model, params):
    """The gradients of ``model``'s parameters (``.grad``) as a nested dict
    of numpy arrays in the layout of ``params``, the JAX ``params`` tree the
    model's weights came from. Raises on a leaf without a counterpart or a
    parameter without a gradient."""
    named = dict(model.named_parameters())
    out = {}
    for path, leaf in _flatten(params):
        key, layout = _key_and_layout(path, leaf)
        if key not in named:
            raise KeyError(f"JAX leaf {'/'.join(path)} has no parameter {key}")
        if named[key].grad is None:
            raise ValueError(f"parameter {key} has no gradient")
        grad = _to_jax(named.pop(key).grad.detach().float().cpu().numpy(), layout)
        node = out
        for m in path[:-1]:
            node = node.setdefault(m, {})
        node[path[-1]] = np.ascontiguousarray(grad)
    if named:
        raise KeyError(f"parameters without a JAX leaf: {sorted(named)}")
    return out


def state_dict_from_jax(variables, model):
    """JAX ``{"params", "batch_stats"}`` tree -> ``model``'s state dict.

    Checks that every model key is filled, every JAX leaf is used and every
    shape matches; raises on any mismatch."""
    out = {}
    for col in ("params", "batch_stats"):
        for path, leaf in _flatten(variables.get(col, {})):
            key, arr = _convert(path, leaf)
            if key in out:
                raise KeyError(f"two JAX leaves map to {key}")
            out[key] = torch.from_numpy(arr.astype(np.float32))
    unknown = set(variables) - {"params", "batch_stats"}
    if unknown:
        raise KeyError(f"unmapped JAX collections {sorted(unknown)}")
    want = model.state_dict()
    missing = sorted(set(want) - set(out))
    extra = sorted(set(out) - set(want))
    if missing or extra:
        raise KeyError(f"weight bridge mismatch: missing {missing}, unmapped {extra}")
    bad = [(k, tuple(out[k].shape), tuple(v.shape)) for k, v in want.items()
           if out[k].shape != v.shape]
    if bad:
        raise ValueError(f"shape mismatch (key, jax, torch): {bad}")
    return out


def seeded_state_dict(model, seed: int):
    """Every parameter and buffer of ``model`` drawn from
    ``numpy.random.default_rng(seed)``: He-scaled conv/linear weights, BN
    scales in [0.9, 1.3], shifts and running means in [-0.1, 0.1], running
    variances in [0.5, 2], biases in [-0.1, 0.1]; the heatmap output bias is
    -2.19 (the CenterHead prior) spread by [-0.5, 0.5]."""
    rng = np.random.default_rng(seed)
    norms = {name for name, m in model.named_modules() if isinstance(m, _RunningNorm)}
    out = {}
    for key, t in model.state_dict().items():
        owner, _, leaf = key.rpartition(".")
        shape = tuple(t.shape)
        if owner in norms:
            lo, hi = {"weight": (0.9, 1.3), "running_var": (0.5, 2.0)}.get(leaf, (-0.1, 0.1))
            arr = rng.uniform(lo, hi, shape)
        elif leaf == "bias":
            arr = rng.uniform(-0.1, 0.1, shape)
            if owner.endswith("head_hm.out"):
                arr = -2.19 + rng.uniform(-0.5, 0.5, shape)
        elif len(shape) == 3:  # sparse conv (K, Cin, Cout)
            arr = rng.normal(0.0, np.sqrt(2.0 / (shape[0] * shape[1])), shape)
        elif len(shape) == 4:
            transposed = bool(re.search(r"deblock\d+$", owner)) and shape[2] > 1
            fan_in = shape[0] if transposed else shape[1] * shape[2] * shape[3]
            arr = rng.normal(0.0, np.sqrt(2.0 / fan_in), shape)
        elif len(shape) == 2:  # Linear (Cout, Cin)
            arr = rng.normal(0.0, np.sqrt(2.0 / shape[1]), shape)
        else:
            raise KeyError(f"no seeding rule for {key} {shape}")
        out[key] = torch.from_numpy(arr.astype(np.float32))
    return out
