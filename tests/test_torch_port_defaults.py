"""The port's constructors against the JAX modules' fields, on the CPU.

Every field that a JAX module and its port share must have the same default,
so that a model built at the defaults in one package is the same model in the
other; and a JAX tree built at the defaults must load into a port model built
at the defaults through the weight bridge.
"""
import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _TINY
from cpd_tpu.models import backbone3d as jbb
from cpd_tpu.models import center_head as jch
from cpd_tpu.models import detector as jdet
from cpd_tpu.models import roi_head as jroi
from cpd_tpu_torch.models import backbone3d, center_head, detector, roi_head
from cpd_tpu_torch.utils.synthetic import make_tiny_train_batch
from cpd_tpu_torch.utils.weights import state_dict_from_jax

PAIRS = {
    "VoxelRCNN": (jdet.VoxelRCNN, detector.VoxelRCNN),
    "VoxelRCNNProtoHead": (jroi.VoxelRCNNProtoHead, roi_head.VoxelRCNNProtoHead),
    "VoxelResBackBone8x": (jbb.VoxelResBackBone8x, backbone3d.VoxelResBackBone8x),
    "CenterHead": (jch.CenterHead, center_head.CenterHead),
}


def _comparable(value):
    """A default as both packages can state it: sequences as tuples, dtypes
    by name (``jnp.bfloat16`` and ``torch.bfloat16`` are the same choice)."""
    if isinstance(value, torch.dtype):
        return str(value).split(".")[-1]
    if isinstance(value, type):
        return np.dtype(value).name
    if isinstance(value, list):
        return tuple(value)
    return value


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_shared_fields_have_the_same_defaults(name):
    """Each field of the JAX dataclass that the port's constructor also takes
    with a default: the two defaults are equal. A field the port requires
    (no default) is a port decision, not a default that differs."""
    jax_cls, port_cls = PAIRS[name]
    fields = {f.name: f for f in dataclasses.fields(jax_cls)}
    params = inspect.signature(port_cls.__init__).parameters
    shared = [n for n, p in params.items()
              if n in fields and p.default is not inspect.Parameter.empty]
    assert shared, f"{name}: no shared field with a default"
    differ = {}
    for n in shared:
        f = fields[n]
        if f.default is not dataclasses.MISSING:
            want = f.default
        elif f.default_factory is not dataclasses.MISSING:
            want = f.default_factory()
        else:
            continue  # required in JAX: no default to match
        if _comparable(want) != _comparable(params[n].default):
            differ[n] = (want, params[n].default)
    assert not differ, f"{name}: defaults differ (JAX, port): {differ}"


def test_jax_tree_at_the_defaults_loads_into_the_port_at_the_defaults():
    """``_TINY`` sets the geometry only; every structural field (``mm``
    among them) stays at its default on both sides, and the JAX tree of a
    training forward (which builds the MM branch where ``mm`` is on) fills
    the port's state dict key for key."""
    jm = jdet.VoxelRCNN(**_TINY)
    batch = {k: jnp.asarray(v)
             for k, v in make_tiny_train_batch(b=2, with_proto=True).items()}
    rngs = {name: jax.random.PRNGKey(i) for i, name in enumerate(("params", "sampling",
                                                                  "dropout"))}
    shapes = jax.eval_shape(lambda: jm.init(rngs, batch, True))
    variables = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    pm = detector.VoxelRCNN(**{k: v for k, v in _TINY.items() if k != "remat"})
    assert pm.mm and jm.mm
    sd = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, variables), pm)
    pm.load_state_dict(sd, strict=True)
    assert any(k.startswith("backbone.branch1.") for k in sd)  # the MM branch is there
