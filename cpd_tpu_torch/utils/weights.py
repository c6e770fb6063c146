"""Weights for the port: the JAX parameter tree bridge and seeded weights.

``state_dict_from_jax`` maps the JAX package's ``{"params", "batch_stats"}``
tree (numpy leaves) to this package's state dict. Module names follow the
flax tree, with flax's auto-names renamed (``SubMConvBN_0/1`` -> ``conv1/2``,
``MaskedBatchNorm_0``/``BatchNorm2d_0`` -> ``bn``, ``Conv_0`` -> ``conv``) and
the RoI head's GridPoolBranch MLP layers (``Dense_0..7``, flax's creation
order) mapped to ``mlp_{scale}_{group}.{0,2}``. The registry modules map by
their own paths: the PFE's MLP layers, which flax binds directly under
``pfe`` (``Dense_0..3``), to ``mlp_{scale}.{0,2}``; the temporal cells'
``ConvGRUCell_0`` / ``ConvLSTMCell_0`` to ``cell`` with ``Conv_0`` / ``Conv_1``
-> ``gates`` / ``cand``, and TemporalConcatenation's ``Conv_0`` to ``fuse``;
the wrap head's ``conf_conv`` keeps its name. The anchor head V2's branches keep their
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

The toolbox modules: DeformConv2d's ``offset_conv`` and ``kernel`` (K, Cin,
Cout) -> ``offset_conv`` and ``weight``; VectorPool's ``layer_{k}``,
``sep_kernel``, ``sep_bn``, ``post_{i}``, ``post_bn_{i}``, ``msg_post_{i}``
and ``msg_post_bn_{i}`` keep their names. In a transformer model (the
model handed in is one) ``enc{i}`` / ``self{i}`` / ``cross{i}`` -> ``blocks``
/ ``self_blocks`` / ``cross_blocks.{i}``, the root ``Dense_0`` /
``LayerNorm_0`` -> ``proj`` / ``norm``, and in a block ``LayerNorm_0/1`` ->
``norm0/1``, ``MultiHeadDotProductAttention_0`` -> ``attn``, ``Dense_0/1``
-> ``mlp0/1``; the attention's (dim, heads, head_dim) query/key/value
kernels and (heads, head_dim, dim) output kernel become Linear weights,
their (heads, head_dim) biases flat.

The MM modules (``branch1``, ``pool_branch_mm``, ``shared1``, ``cls_tower1``,
``reg_tower1``) follow the same rules. ``grads_to_jax_tree`` is the bridge's
inverse for gradients: the port's parameter gradients in the layout of the
flax ``params`` tree (transposes and the ConvTranspose flip undone), so that
tests compare gradients leaf by leaf; ``jax_variables_from_state_dict`` is
its inverse for the whole state dict.

``seeded_state_dict`` fills every parameter and buffer of a model from
``numpy.random.default_rng(seed)`` with spread (running variances in
[0.5, 2], spread head biases), so scores do not sit on the thresholds.
"""
from __future__ import annotations

import re

import numpy as np
import torch

from ..models import transformer
from ..models.norm import _RunningNorm
from ..models.pfe import SCALE_SPECS as PFE_SCALE_SPECS
from ..models.roi_head import SCALE_SPECS

_SEGMENTS = {"SubMConvBN_0": "conv1", "SubMConvBN_1": "conv2", "MaskedBatchNorm_0": "bn",
             "BatchNorm2d_0": "bn", "Conv_0": "conv", "Conv_1": "out"}
_LEAVES = {"scale": "weight", "bias": "bias", "mean": "running_mean",
           "var": "running_var"}
# flax creation order of GridPoolBranch's MLP Dense layers
_MLP_GROUPS = [(name, gi) for name, _, *groups in SCALE_SPECS for gi in range(len(groups))]
_TEMPORAL_SEGMENTS = {"ConvGRUCell_0": "cell", "ConvLSTMCell_0": "cell"}
_CELL_CONVS = {"Conv_0": "gates", "Conv_1": "cand"}


def _own_path(mods):
    """The port's module path of a leaf under ``pfe`` or ``temporal``, or
    None for every other module."""
    if mods[0] == "pfe" and len(mods) == 2 and re.fullmatch(r"Dense_\d+", mods[1]):
        i = int(mods[1].split("_")[1])
        return ["pfe", f"mlp_{PFE_SCALE_SPECS[i // 2][0]}", str(2 * (i % 2))]
    if mods[0] == "temporal":
        if len(mods) == 3 and mods[1] in _TEMPORAL_SEGMENTS and mods[2] in _CELL_CONVS:
            return ["temporal", "cell", _CELL_CONVS[mods[2]]]
        if mods[1:] == ["Conv_0"]:  # TemporalConcatenation's 1x1 fuse
            return ["temporal", "fuse"]
        if mods[1:] == ["in_proj"]:
            return mods
        raise KeyError(f"unmapped temporal module {'/'.join(mods)}")
    return None


_BLOCK_SEGMENTS = {"LayerNorm_0": "norm0", "LayerNorm_1": "norm1", "ctx_norm": "ctx_norm",
                   "MultiHeadDotProductAttention_0": "attn", "Dense_0": "mlp0",
                   "Dense_1": "mlp1"}
_STACKS = {"enc": "blocks", "self": "self_blocks", "cross": "cross_blocks"}


def _block_path(mods, name, leaf):
    """(port module path, layout) of a leaf inside a TransformerBlock."""
    if not mods or mods[0] not in _BLOCK_SEGMENTS:
        raise KeyError(f"unmapped transformer block module {'/'.join(mods)}")
    out = [_BLOCK_SEGMENTS[mods[0]]] + mods[1:]
    layout = None
    if out[0] == "attn" and len(out) == 2:
        if name == "kernel":
            layout = "heads_out" if out[1] == "out" else "heads_in"
        elif leaf.ndim == 2:  # a (heads, head_dim) bias
            layout = "flat"
    return out, layout


def _renamer(model):
    """For a transformer model, the renaming of its flax paths: (mods, leaf
    name, leaf) -> (port module path, layout or None for the default);
    None for every other model."""
    if isinstance(model, transformer.TransformerBlock):
        return _block_path
    if not isinstance(model, (transformer.TransformerEncoder, transformer.TransformerDecoder)):
        return None

    def rename(mods, name, leaf):
        stack = re.fullmatch(r"(enc|self|cross)(\d+)", mods[0]) if mods else None
        if stack:
            inner, layout = _block_path(mods[1:], name, leaf)
            return [_STACKS[stack.group(1)], stack.group(2)] + inner, layout
        if mods == ["Dense_0"]:
            return ["proj"], None
        if mods == ["LayerNorm_0"]:
            return ["norm"], None
        raise KeyError(f"unmapped transformer module {'/'.join(mods)}/{name}")
    return rename


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _flatten(tree):
    for path, v in _leaves(tree):
        yield path, np.asarray(v)


def _key_and_layout(path, leaf, rename=None):
    """One JAX leaf -> (torch key, layout): how the leaf's axes map, one of
    "same", "dense", "conv", "deconv", "heads_in", "heads_out", "flat".
    ``rename`` (``_renamer``) maps the paths of a model of its own."""
    *mods, name = path
    own = _own_path(mods) if mods and rename is None else None
    forced = None
    if rename is not None:
        if path == ("queries",):  # the decoder's learned queries
            return "queries", "same"
        mods, forced = rename(list(mods), name, leaf)
    elif own is not None:
        mods = own
    else:
        if mods and re.fullmatch(r"Dense_\d+", mods[-1]) and (
                len(mods) == 1 or mods[-2].startswith("pool_branch")):
            i = int(mods[-1].split("_")[1])  # GridPoolBranch MLPs (or a bare GridPoolBranch)
            scale, gi = _MLP_GROUPS[i // 2]
            mods = mods[:-1] + [f"mlp_{scale}_{gi}", str(2 * (i % 2))]
        if mods[:1] == ["vfe"]:  # PillarVFE: pfn{i} and its MaskedBatchNorm_{i}
            mods = [re.sub(r"^MaskedBatchNorm_(\d+)$", r"bn\1", m) for m in mods]
        mods = [_SEGMENTS.get(m, m) for m in mods]
    layout = "same"
    if name == "sep_kernel":  # VectorPool's per-cell (G, Cin, Cout) linear
        return ".".join(mods + [name]), layout
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
    return ".".join(mods + [key]), forced or layout


def _to_torch(leaf, layout):
    if layout == "dense":  # (Cin, Cout) -> (Cout, Cin)
        return leaf.T
    if layout == "conv":  # (kh, kw, Cin, Cout) -> (Cout, Cin, kh, kw)
        return np.transpose(leaf, (3, 2, 0, 1))
    if layout == "deconv":  # (kh, kw, Cin, Cout) -> (Cin, Cout, kh, kw), taps flipped
        return np.transpose(leaf[::-1, ::-1], (2, 3, 0, 1))
    if layout == "heads_in":  # (dim, heads, head_dim) -> (heads * head_dim, dim)
        return leaf.reshape(leaf.shape[0], -1).T
    if layout == "heads_out":  # (heads, head_dim, dim) -> (dim, heads * head_dim)
        return leaf.reshape(-1, leaf.shape[-1]).T
    if layout == "flat":
        return leaf.reshape(-1)
    return leaf


def _to_jax(arr, layout, shape=None):
    """``_to_torch``'s inverse; ``shape``, the JAX leaf's, undoes the
    attention layouts."""
    if layout == "dense":
        return arr.T
    if layout == "conv":
        return np.transpose(arr, (2, 3, 1, 0))
    if layout == "deconv":
        return np.transpose(arr, (2, 3, 0, 1))[::-1, ::-1]
    if layout in ("heads_in", "heads_out"):
        return arr.T.reshape(shape)
    if layout == "flat":
        return arr.reshape(shape)
    return arr


def _convert(path, leaf, rename=None):
    """One JAX leaf -> (torch key, array)."""
    key, layout = _key_and_layout(path, leaf, rename)
    return key, np.ascontiguousarray(_to_torch(leaf, layout))


def grads_to_jax_tree(model, params):
    """The gradients of ``model``'s parameters (``.grad``) as a nested dict
    of numpy arrays in the layout of ``params``, the JAX ``params`` tree the
    model's weights came from. Raises on a leaf without a counterpart or a
    parameter without a gradient."""
    named = dict(model.named_parameters())
    rename = _renamer(model)
    out = {}
    for path, leaf in _flatten(params):
        key, layout = _key_and_layout(path, leaf, rename)
        if key not in named:
            raise KeyError(f"JAX leaf {'/'.join(path)} has no parameter {key}")
        if named[key].grad is None:
            raise ValueError(f"parameter {key} has no gradient")
        grad = _to_jax(named.pop(key).grad.detach().float().cpu().numpy(), layout, leaf.shape)
        node = out
        for m in path[:-1]:
            node = node.setdefault(m, {})
        node[path[-1]] = np.ascontiguousarray(grad)
    if named:
        raise KeyError(f"parameters without a JAX leaf: {sorted(named)}")
    return out


def jax_variables_from_state_dict(state_dict, model, like):
    """``state_dict_from_jax``'s inverse: ``model``'s state dict -> a JAX
    ``{"params", "batch_stats"}`` tree of numpy arrays in the layout of
    ``like``, a tree of the same structure whose leaves have ``shape`` and
    ``dtype`` (arrays, or the shapes ``jax.eval_shape`` gives). Raises on a
    leaf without a key, a key without a leaf and a shape that differs."""
    rename = _renamer(model)
    unused = set(state_dict)
    out = {}
    for col in ("params", "batch_stats"):
        if col not in like:
            continue
        for path, leaf in _leaves(like[col]):
            key, layout = _key_and_layout(path, leaf, rename)
            if key not in state_dict:
                raise KeyError(f"JAX leaf {col}/{'/'.join(path)} has no state-dict key {key}")
            if key not in unused:
                raise KeyError(f"two JAX leaves map to {key}")
            unused.discard(key)
            t = state_dict[key]
            arr = t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
            arr = np.ascontiguousarray(_to_jax(arr, layout, tuple(leaf.shape)),
                                       dtype=np.dtype(leaf.dtype))
            if arr.shape != tuple(leaf.shape):
                raise ValueError(f"shape mismatch at {key}: {arr.shape} against JAX "
                                 f"{tuple(leaf.shape)}")
            node = out.setdefault(col, {})
            for m in path[:-1]:
                node = node.setdefault(m, {})
            node[path[-1]] = arr
    unknown = set(like) - {"params", "batch_stats"}
    if unknown:
        raise KeyError(f"unmapped JAX collections {sorted(unknown)}")
    if unused:
        raise KeyError(f"state-dict keys without a JAX leaf: {sorted(unused)}")
    return out


def state_dict_from_jax(variables, model):
    """JAX ``{"params", "batch_stats"}`` tree -> ``model``'s state dict.

    Checks that every model key is filled, every JAX leaf is used and every
    shape matches; raises on any mismatch."""
    out = {}
    rename = _renamer(model)
    for col in ("params", "batch_stats"):
        for path, leaf in _flatten(variables.get(col, {})):
            key, arr = _convert(path, leaf, rename)
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
