"""The port's dense backbone tail in training mode against the JAX
package's and against the port's own sparse path (f32, batch statistics):
loss, running statistics and every gradient. Tiers as in
``test_torch_port_dense_tail.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cpd_tpu.models import backbone3d as jbb
from cpd_tpu_torch.models import backbone3d
from cpd_tpu_torch.utils.weights import grads_to_jax_tree
from tests.test_torch_port_dense_tail import CAPS, FILTERS, GRID, PGRID, _t
from tests.test_torch_port_models import _random_sparse, init_pair
from tests.torch_port_refs import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def train_pair():
    """f32 training mode (batch statistics): loss = sum(encoded^2) and its
    gradients in JAX (dense tail) and in the port (dense and sparse tail)."""
    rng = np.random.default_rng(1)
    feats, keys = _random_sparse(rng, 2, 300)
    jm = jbb.VoxelResBackBone8x(grid=GRID, num_filters=FILTERS, caps=CAPS, mm=False,
                                dense_tail=True, compute_dtype=None, remat=False)
    models = {d: backbone3d.VoxelResBackBone8x(PGRID, 5, FILTERS, CAPS, compute_dtype=None,
                                               dense_tail=d) for d in (True, False)}
    v = init_pair(jm, models[True], jnp.asarray(feats), jnp.asarray(keys), True)
    models[False].load_state_dict(models[True].state_dict(), strict=True)

    def loss_fn(params):
        out, upd = jm.apply({"params": params, "batch_stats": v["batch_stats"]},
                            jnp.asarray(feats), jnp.asarray(keys), True, mutable=["batch_stats"])
        return jnp.sum(out["encoded"][0].astype(jnp.float32) ** 2), upd

    (jloss, jupd), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(v["params"])
    runs = {}
    for dense, m in models.items():
        m.train()
        loss = (m(_t(feats), _t(keys))["encoded"][0].float() ** 2).sum()
        loss.backward()
        runs[dense] = (float(loss.detach()), m)
    return runs, float(jloss), jupd, jgrads, v


def test_dense_tail_train_loss_and_batch_stats(train_pair):
    runs, jloss, jupd, _, _ = train_pair
    (ld, md), (ls, ms) = runs[True], runs[False]
    np.testing.assert_allclose(ld, ls, rtol=1e-4)
    np.testing.assert_allclose(ld, jloss, rtol=1e-4)
    # masked moments over the same occupied sites, and the same running update
    for name in ("down4", "conv_out"):
        jst = jupd["batch_stats"]["branch0"][name]["MaskedBatchNorm_0"]
        for m in (md, ms):
            bn = getattr(m.branch0, name).bn
            np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(jst["mean"]),
                                       rtol=1e-4, atol=1e-5)
            np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(jst["var"]),
                                       rtol=1e-4, atol=1e-5)


GRAD_LEAVES = ["conv_input.weight", "down3.weight", "res3b.conv2.weight", "down4.weight",
               "res4a.conv1.weight", "res4b.conv2.bn.weight", "conv_out.weight",
               "conv_out.bn.bias"]


@pytest.mark.parametrize("leaf", GRAD_LEAVES)
def test_dense_tail_gradients_match_sparse_path(train_pair, leaf):
    """Stage-4 parameters and what lies upstream (through kernels A1 and A2's
    plain versions): 2e-5 of the gradient's scale, as tests/test_dense_tail.py."""
    runs, *_ = train_pair
    gd = dict(runs[True][1].branch0.named_parameters())[leaf].grad.numpy()
    gs = dict(runs[False][1].branch0.named_parameters())[leaf].grad.numpy()
    scale = max(float(np.abs(gs).max()), 1e-6)
    assert scale > 1e-4
    np.testing.assert_allclose(gd / scale, gs / scale, atol=2e-5, err_msg=leaf)


def test_dense_tail_gradients_match_jax_grad(train_pair):
    """Every parameter gradient of the port's dense tail against jax.grad of
    the JAX dense tail, 1e-3 of each leaf's scale."""
    runs, _, _, jgrads, v = train_pair
    tree = grads_to_jax_tree(runs[True][1], v["params"])
    flat_p = jax.tree_util.tree_leaves_with_path(tree)
    flat_j = dict(jax.tree_util.tree_leaves_with_path(jax.tree_util.tree_map(np.asarray, jgrads)))
    assert len(flat_p) == len(flat_j) > 60
    for path, g in flat_p:
        ref = flat_j[path]
        scale = max(float(np.abs(ref).max()), 1e-6)
        np.testing.assert_allclose(g / scale, ref / scale, atol=1e-3,
                                   err_msg=jax.tree_util.keystr(path))
