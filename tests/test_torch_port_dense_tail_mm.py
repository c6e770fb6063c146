"""The light MM branch of the port's backbone with the dense tail (one block
at stage 4, no ``conv_out``) in training mode, f32, against the JAX package's
and against the port's own sparse path. Tiers as in
``test_torch_port_dense_tail.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from cpd_tpu.models import backbone3d as jbb
from cpd_tpu_torch.models import backbone3d
from tests.test_torch_port_dense_tail import CAPS, FILTERS, GRID, PGRID, _f32_close, _t
from tests.test_torch_port_models import _random_sparse, init_pair
from tests.torch_port_refs import one_torch_thread  # noqa: F401


def test_dense_tail_light_branch_mm():
    """The light MM branch with the dense tail (one block at stage 4, no
    conv_out) against JAX and against the port's sparse path."""
    rng = np.random.default_rng(2)
    feats, keys = _random_sparse(rng, 1, 250)
    feats1, keys1 = _random_sparse(rng, 1, 200)
    kw = dict(grid=GRID, num_filters=FILTERS, caps=CAPS, mm=True, compute_dtype=None)
    jm = jbb.VoxelResBackBone8x(**kw, dense_tail=True)
    pd = backbone3d.VoxelResBackBone8x(PGRID, 5, FILTERS, CAPS, compute_dtype=None, mm=True,
                                       dense_tail=True)
    args = tuple(jnp.asarray(a) for a in (feats, keys))
    args1 = tuple(jnp.asarray(a) for a in (feats1, keys1))
    v = init_pair(jm, pd, *args, True, *args1)
    ps = backbone3d.VoxelResBackBone8x(PGRID, 5, FILTERS, CAPS, compute_dtype=None, mm=True)
    ps.load_state_dict(pd.state_dict(), strict=True)
    ref, _ = jax.jit(lambda v: jm.apply(v, *args, True, *args1, mutable=["batch_stats"]))(v)
    outs = []
    for m in (pd, ps):
        m.train()
        with torch.no_grad():
            outs.append(m(_t(feats), _t(keys), _t(feats1), _t(keys1)))
    out_d, out_s = outs
    assert "encoded_bev" in out_d and "encoded_mm" not in out_d
    for name in ("x_conv4", "x_conv4_mm"):
        (fd, kd, _), (fs, ks, _), (rf, rk, _) = out_d[name], out_s[name], ref[name]
        np.testing.assert_array_equal(kd.numpy(), np.asarray(rk), err_msg=name)
        assert torch.equal(kd, ks)
        _f32_close(fd, rf, name)
        _f32_close(fd, fs, name)
