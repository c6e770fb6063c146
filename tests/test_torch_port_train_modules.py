"""Training mode of the PyTorch port's modules against the JAX package, at f32.

Each JAX module that has a ``compute_dtype`` runs at ``compute_dtype=None``
(f32) in training mode (batch statistics) on numpy inputs; the port's module
gets the same seeded weights through the bridge. Compared: the outputs
(1e-4), the gradients of a random linear functional of the outputs with
respect to every parameter, leaf by leaf through ``grads_to_jax_tree`` (1e-3
of the leaf's scale, plus 1e-6 of the largest leaf's: the backward of a batch
norm subtracts large sums), and
the updated running statistics (1e-5).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpd_tpu.models import backbone3d as jbb
from cpd_tpu.models import bev as jbev
from cpd_tpu.models import center_head as jch
from cpd_tpu.models import roi_head as jroi
from cpd_tpu.ops.sparse import GridSpec
from cpd_tpu_torch.models import backbone3d, bev, center_head, roi_head
from cpd_tpu_torch.ops import sparse
from cpd_tpu_torch.utils.weights import grads_to_jax_tree, state_dict_from_jax
from tests.test_torch_port_models import _random_sparse, seeded_jax_variables
from tests.torch_port_refs import one_torch_thread  # noqa: F401

GRID = GridSpec(32, 32, 26)
CAPS = (512, 256, 160, 160)
FILTERS = (4, 8, 16, 32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _leaves(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v, np.float32)


def _flat_outputs(out):
    """The float arrays of a module's output, by name."""
    if isinstance(out, dict):
        flat = {}
        for k, v in out.items():
            flat[k] = v[0] if isinstance(v, tuple) else v
        return flat
    return {"out": out}


def check_training_parity(jm, pm, jargs, pargs, seed=0, grad_tol=1e-3):
    """Run both modules in training mode on the same weights and inputs and
    compare outputs, parameter gradients and running statistics."""
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), *jargs, True))
    variables = seeded_jax_variables(shapes, seed)
    pm.load_state_dict(state_dict_from_jax(variables, pm), strict=True)
    pm.train()
    pout = _flat_outputs(pm(*pargs))
    rng = np.random.default_rng(seed + 100)
    cots = {k: rng.normal(size=tuple(v.shape)).astype(np.float32) for k, v in pout.items()}
    sum((v.float() * _t(cots[k])).sum() for k, v in pout.items()).backward()

    jv = jax.tree_util.tree_map(jnp.asarray, variables)

    def loss_fn(params):
        out, mut = jm.apply({"params": params, "batch_stats": jv["batch_stats"]}, *jargs, True,
                            mutable=["batch_stats"])
        flat = _flat_outputs(out)
        return sum(jnp.sum(flat[k] * cots[k]) for k in cots), (flat, mut["batch_stats"])

    jgrads, (jout, jstats) = jax.grad(loss_fn, has_aux=True)(jv["params"])
    assert set(jout) >= set(pout)
    for k, v in pout.items():
        ref = np.asarray(jout[k], np.float32)
        np.testing.assert_allclose(v.detach().numpy(), ref, rtol=1e-4, atol=1e-4, err_msg=k)
        assert float(np.abs(ref).max()) > 0.05, f"{k} is trivially zero"
    pgrads = dict(_leaves(grads_to_jax_tree(pm, variables["params"])))
    jleaves = dict(_leaves(jax.tree_util.tree_map(np.asarray, jgrads)))
    assert set(pgrads) == set(jleaves)
    # a bias in front of a batch norm has no gradient but rounding noise:
    # allow 1e-6 of the largest leaf's scale on top
    floor = 1e-6 * max(float(np.abs(j).max()) for j in jleaves.values())
    for name, j in jleaves.items():
        scale = float(np.abs(j).max())
        assert scale > 0, f"{name}: the reference gradient is zero"
        err = float(np.abs(pgrads[name] - j).max())
        assert err <= grad_tol * scale + floor, f"{name}: grad err {err} vs scale {scale}"
    moved = state_dict_from_jax({"params": variables["params"],
                                 "batch_stats": jax.tree_util.tree_map(np.asarray, jstats)}, pm)
    state = pm.state_dict()
    stats = [k for k in moved if k.endswith(("running_mean", "running_var"))]
    assert stats
    for key in stats:
        np.testing.assert_allclose(state[key].numpy(), moved[key].numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=key)
    return len(jleaves)


def test_backbone_training_f32_matches_with_mm_branch():
    """Both siamese branches in training mode: 35 sparse convs forward, their
    backward through the port's autograd Function (dX over the transpose
    rulebooks, dW), masked batch statistics."""
    rng = np.random.default_rng(1)
    feats, keys = _random_sparse(rng, 2, 300)
    feats_mm, keys_mm = _random_sparse(rng, 2, 300)
    jm = jbb.VoxelResBackBone8x(grid=GRID, num_filters=FILTERS, caps=CAPS, mm=True,
                                compute_dtype=None, remat=False)
    pm = backbone3d.VoxelResBackBone8x(sparse.GridSpec(*GRID), 5, FILTERS, CAPS,
                                       compute_dtype=None, mm=True)

    class JWrap:
        """The JAX backbone with the MM view bound, ``train`` third."""

        def init(self, key, f, k, train):
            return jm.init(key, f, k, train, jnp.asarray(feats_mm), jnp.asarray(keys_mm))

        def apply(self, variables, f, k, train, mutable):
            out, mut = jm.apply(variables, f, k, train, jnp.asarray(feats_mm),
                                jnp.asarray(keys_mm), mutable=mutable)
            out.pop("stage_luts", None)
            return out, mut

    n = check_training_parity(JWrap(), pm, (jnp.asarray(feats), jnp.asarray(keys)),
                              (_t(feats), _t(keys), _t(feats_mm), _t(keys_mm)), seed=1)
    assert n == len(list(pm.parameters())) == 3 * 35


def test_bev_backbone_training_f32_matches():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 8, 8, 12)).astype(np.float32)
    kw = dict(layer_nums=(1, 1), layer_strides=(1, 2), num_filters=(8, 16),
              upsample_strides=(1, 2), num_upsample_filters=(16, 16))
    check_training_parity(jbev.BaseBEVBackbone(**kw, compute_dtype=None),
                          bev.BaseBEVBackbone(12, **kw, compute_dtype=None),
                          (jnp.asarray(x),), (_t(x),), seed=2)


def test_center_head_training_f32_matches():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 8, 8, 32)).astype(np.float32)
    pcr, vs = (-8.0, -8.0, -2.0, 8.0, 8.0, 4.0), (0.25, 0.25, 0.15)
    check_training_parity(
        jch.CenterHead(num_classes=3, voxel_size=vs, point_cloud_range=pcr, compute_dtype=None),
        center_head.CenterHead(32, 3, voxel_size=vs, point_cloud_range=pcr, compute_dtype=None),
        (jnp.asarray(x),), (_t(x),), seed=3)


@pytest.mark.parametrize("out_dim", [7, None])
def test_fc_tower_training_f32_matches(out_dim):
    """Masked batch statistics over the valid rois; dropout off (its masks
    cannot be shared between the frameworks)."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 12, 48)).astype(np.float32)
    valid = rng.random((2, 12)) < 0.7

    class JWrap:
        jm = jroi.FCTower(hidden=(32, 32), out_dim=out_dim, dropout=0.0, compute_dtype=None)

        def init(self, key, xx, train):
            return self.jm.init(key, xx, jnp.asarray(valid), train)

        def apply(self, variables, xx, train, mutable):
            return self.jm.apply(variables, xx, jnp.asarray(valid), train, mutable=mutable)

    pm = roi_head.FCTower(48, hidden=(32, 32), out_dim=out_dim, dropout=0.0, compute_dtype=None)
    check_training_parity(JWrap(), pm, (jnp.asarray(x),), (_t(x), _t(valid)), seed=4)
