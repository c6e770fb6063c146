"""The last models of the JAX package against the port, on the CPU: the ATSS
assigner, deformable convolution (with and without modulation, the layer
through ``state_dict_from_jax``), the transformer toolbox (a block, the
encoder and the decoder, with masks), VectorPool (the grid offsets, the
3-NN and voxel pools, the three aggregation types and the MSG module,
forward and batch statistics in training mode) and the two model helpers.

Seeded numpy inputs and the same weights go through both packages; integers
are equal, floats agree to 1e-4 of their scale at f32. The JAX side runs
under ``jit``, as the package runs it: its distances are then the fused
chain that ``ops.fps.fused_norm`` restates (held exactly here), and a
flax module's first eager call costs 5-13 s of primitive compiles against
1-1.5 s for one jitted program. The DCN and transformer functions run
eagerly where they are cheap. Where an integer result turns on a
threshold, the test asserts a margin first.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpd_tpu import models as jmodels
from cpd_tpu.models import atss as jatss
from cpd_tpu.models import transformer as jtr
from cpd_tpu.models import vector_pool as jvp
from cpd_tpu.ops import dcn as jdcn
from cpd_tpu_torch import models
from cpd_tpu_torch.models import atss, transformer, vector_pool
from cpd_tpu_torch.ops import dcn, fps
from cpd_tpu_torch.ops.iou3d import boxes_aligned_iou_bev
from cpd_tpu_torch.utils.weights import grads_to_jax_tree, state_dict_from_jax
from tests.test_torch_port_models import seeded_jax_variables
from tests.torch_port_refs import one_torch_thread  # noqa: F401

TOL = 1e-4


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(port, ref, what, floor=0.0):
    """Within 1e-4 of the reference's scale (plus ``floor``)."""
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape, (what, port.shape, ref.shape)
    scale = max(float(np.abs(ref).max()), 1e-6)
    err = float(np.abs(port - ref).max())
    assert err <= TOL * scale + floor, f"{what}: max err {err} at scale {scale}"


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _leaves(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v, np.float32)


def _pair(jmodule, pmodule, *args, seed=0, **kwargs):
    """Seeded JAX variables of ``jmodule`` on ``args``, loaded into
    ``pmodule`` (every key mapped, none left over)."""
    shapes = jax.eval_shape(lambda: jmodule.init(jax.random.PRNGKey(0), *args, **kwargs))
    variables = seeded_jax_variables(shapes, seed)
    pmodule.load_state_dict(state_dict_from_jax(variables, pmodule), strict=True)
    return variables, jax.tree_util.tree_map(jnp.asarray, variables)


# ---- ATSS ------------------------------------------------------------------


def test_fused_norm_of_two_values_is_jax_jitted_norm():
    d = np.random.default_rng(0).normal(0, 20, (4000, 2)).astype(np.float32)
    ref = np.asarray(jax.jit(lambda x: jnp.linalg.norm(x, axis=-1))(jnp.asarray(d)))
    np.testing.assert_array_equal(fps.fused_norm(_t(d)).numpy(), ref)


def test_atss_assign_matches():
    """A 12 x 12 grid of anchors of 2 sizes and 2 headings, 10 gt slots (3
    invalid, their z still in the mean): labels exact, IoUs 1e-4. Margins:
    no two of a gt's distances tie at its top-k boundary, no IoU sits at its
    gt's threshold, no anchor centre on a gt face."""
    rng = np.random.default_rng(1)
    xs = np.linspace(-7.5, 7.5, 12)
    gx, gy = np.meshgrid(xs, xs, indexing="ij")
    anchors = []
    for size in ((3.9, 1.6, 1.56), (0.8, 0.6, 1.73)):
        for rot in (0.0, np.pi / 2):
            a = np.zeros((144, 7), np.float32)
            a[:, 0], a[:, 1], a[:, 2] = gx.ravel(), gy.ravel(), -1.0
            a[:, 3:6], a[:, 6] = size, rot
            anchors.append(a)
    anchors = np.concatenate(anchors)
    gt = np.zeros((10, 8), np.float32)
    gt[:, :2] = rng.uniform(-6, 6, (10, 2))
    gt[:, 2] = rng.uniform(-1.5, -0.5, 10)
    gt[:, 3:6] = rng.uniform([2.0, 1.2, 1.0], [5.0, 2.5, 2.0], (10, 3))
    gt[:, 6] = rng.uniform(-np.pi, np.pi, 10)
    gt[:, 7] = rng.integers(1, 4, 10)
    valid = np.arange(10) < 7
    ref = jatss.atss_assign(jnp.asarray(anchors), jnp.asarray(gt), jnp.asarray(valid))
    got = atss.atss_assign(_t(anchors), _t(gt), _t(valid))
    # margins, on the port's own numbers; the 4 anchors of a centre tie
    # exactly and go in index order in both packages
    dist = fps.fused_norm(_t(anchors)[:, None, :2] - _t(gt)[None, :, :2]).numpy()[:, valid]
    centres = np.sort(dist[:144], axis=0)
    assert np.diff(centres[:5], axis=0).min() > 1e-4
    iou = boxes_aligned_iou_bev(_t(anchors), _t(gt)).numpy()[:, valid]
    cand = np.take_along_axis(iou, np.argsort(dist, axis=0, kind="stable")[:9], 0)
    thr = cand.mean(0) + cand.std(0)
    assert np.abs(iou - thr[None]).min() > 1e-5
    zc = gt[:, 2].mean()
    loc = np.abs(np.stack([anchors[:, 0], anchors[:, 1], np.full(len(anchors), zc)], -1)[:, None]
                 - gt[None, :, :3])
    assert np.abs(loc[..., 2] - gt[None, :, 5] / 2).min() > 1e-4
    assert got["labels"].dtype == torch.int32
    np.testing.assert_array_equal(got["labels"].numpy(), np.asarray(ref["labels"]))
    _close(got["max_iou"], ref["max_iou"], "max_iou")
    assert 5 < int((got["labels"] >= 0).sum()) < 200


# ---- DCN -------------------------------------------------------------------


@pytest.mark.parametrize("modulated", [True, False])
def test_deform_conv_layer_matches(modulated):
    """DeformConv2d on (2, 9, 7, 5) -> 6 channels through the bridge, with
    the offset conv's weights seeded (at zero offsets it is a plain conv):
    offsets of a few pixels, some taps off the image."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 9, 7, 5)).astype(np.float32)
    jm = jdcn.DeformConv2d(features=6, modulated=modulated)
    pm = dcn.DeformConv2d(5, 6, modulated=modulated)
    variables, jv = _pair(jm, pm, jnp.asarray(x))
    assert np.abs(variables["params"]["offset_conv"]["kernel"]).max() > 0.1
    ref = jax.jit(jm.apply)(jv, jnp.asarray(x))
    with torch.no_grad():
        got = pm(_t(x))
        off = pm.offset_conv(_t(x).permute(0, 3, 1, 2))
    assert float(off[:, :18].abs().max()) > 1.0
    _close(got, ref, f"DeformConv2d modulated={modulated}")


def test_deform_conv2d_one_image_matches():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(8, 6, 4)).astype(np.float32)
    off = rng.normal(0, 1.5, (8, 6, 18)).astype(np.float32)
    mask = rng.random((8, 6, 9)).astype(np.float32)
    w = rng.normal(size=(9, 4, 3)).astype(np.float32)
    for m in (None, mask):
        ref = jdcn.deform_conv2d(jnp.asarray(x), jnp.asarray(off), jnp.asarray(w),
                                 None if m is None else jnp.asarray(m))
        got = dcn.deform_conv2d(_t(x), _t(off), _t(w), None if m is None else _t(m))
        _close(got, ref, f"deform_conv2d mask={m is not None}")


# ---- transformer -----------------------------------------------------------


def test_transformer_block_with_context_matches():
    rng = np.random.default_rng(4)
    x, ctx = rng.normal(size=(2, 5, 16)), rng.normal(size=(2, 7, 16))
    x, ctx = x.astype(np.float32), ctx.astype(np.float32)
    mask = rng.random((2, 1, 5, 7)) < 0.7
    mask[..., 0] = True
    jm = jtr.TransformerBlock(dim=16, heads=4)
    pm = transformer.TransformerBlock(16, heads=4, with_context=True).eval()
    _, jv = _pair(jm, pm, jnp.asarray(x), jnp.asarray(ctx))
    ref = jax.jit(jm.apply)(jv, jnp.asarray(x), jnp.asarray(ctx), jnp.asarray(mask))
    with torch.no_grad():
        got = pm(_t(x), _t(ctx), _t(mask))
    _close(got, ref, "block")


def test_transformer_encoder_with_mask_matches():
    """Tokens of 12 channels (the projection to 16), a padding mask."""
    rng = np.random.default_rng(5)
    tokens = rng.normal(size=(2, 9, 12)).astype(np.float32)
    keep = np.arange(9)[None] < np.array([[9], [6]])
    mask = keep[:, None, None, :]
    jm = jtr.TransformerEncoder(dim=16, depth=2, heads=4)
    pm = transformer.TransformerEncoder(dim=16, depth=2, heads=4, in_channels=12).eval()
    _, jv = _pair(jm, pm, jnp.asarray(tokens))
    ref = jax.jit(jm.apply)(jv, jnp.asarray(tokens), jnp.asarray(mask))
    with torch.no_grad():
        got = pm(_t(tokens), _t(mask))
    _close(got, ref, "encoder")


def test_transformer_decoder_with_mask_matches_and_its_gradients():
    """Queries over a padded memory; the output and the gradients of a
    random functional of it, every parameter leaf through
    ``grads_to_jax_tree`` (plus 1e-6 of the largest leaf's scale: the key
    biases' gradients are 0 but for rounding, the softmax being blind to
    them)."""
    rng = np.random.default_rng(6)
    memory = rng.normal(size=(2, 8, 16)).astype(np.float32)
    mask = (np.arange(8)[None] < np.array([[8], [5]]))[:, None, None, :]
    jm = jtr.TransformerDecoder(dim=16, depth=1, heads=4, num_queries=6)
    pm = transformer.TransformerDecoder(dim=16, depth=1, heads=4, num_queries=6).eval()
    variables, jv = _pair(jm, pm, jnp.asarray(memory))
    cot = rng.normal(size=(2, 6, 16)).astype(np.float32)
    ref = jax.jit(jm.apply)(jv, jnp.asarray(memory), jnp.asarray(mask))
    jg = jax.jit(jax.grad(lambda p: jnp.sum(jm.apply({"params": p}, jnp.asarray(memory),
                                                     jnp.asarray(mask)) * cot)))(jv["params"])
    got = pm(_t(memory), _t(mask))
    (got * _t(cot)).sum().backward()
    _close(got, ref, "decoder")
    pgrads = dict(_leaves(grads_to_jax_tree(pm, variables["params"])))
    jleaves = dict(_leaves(jax.device_get(jg)))
    floor = 1e-6 * max(float(np.abs(j).max()) for j in jleaves.values())
    assert set(pgrads) == set(jleaves)
    for name, j in jleaves.items():
        _close(pgrads[name], j, name, floor)


# ---- VectorPool ------------------------------------------------------------


def _scene(seed, n=300, m=7):
    rng = np.random.default_rng(seed)
    sx = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    sv = rng.random(n) < 0.9
    sf = rng.normal(size=(n, 6)).astype(np.float32)
    cx = rng.uniform(-4, 4, (m, 3)).astype(np.float32)
    cv = np.ones(m, bool)
    cv[-1] = False
    return sx, sv, sf, cx, cv


def _assert_three_nn_margin(centers, sx, sv, max_d, ball=False):
    """The distances (the port's fused f32 chain against JAX's eager sum
    of squares, which differ by an ulp or two: 2.4e-7 m at 3.2 m) keep 2e-6 m
    between the four nearest of a centre and, for the ball, from its cutoff;
    the cube's cutoff compares the same f32 values in both packages."""
    diff = centers.reshape(-1, 1, 3).astype(np.float64) - sx[None]
    d = np.linalg.norm(diff, axis=-1)
    if ball:
        assert np.abs(d - max_d).min() > 2e-6
    inside = d <= max_d if ball else np.abs(diff).max(-1) <= max_d
    d = np.where(sv[None] & inside, d, np.inf)
    gaps = np.diff(np.sort(d, axis=1)[:, :4], axis=1)
    assert np.nan_to_num(gaps, nan=1.0, posinf=1.0).min() > 2e-6


def test_local_grid_offsets_and_three_nn_vector_pool_match():
    sx, sv, sf, cx, cv = _scene(7)
    offs = vector_pool.local_grid_offsets((3, 3, 3), 1.6)
    np.testing.assert_array_equal(offs, jvp.local_grid_offsets((3, 3, 3), 1.6))
    centers = cx[:, None, :] + offs[None]
    for neighbor_type in (0, 1):
        _assert_three_nn_margin(centers, sx, sv, 3.2, ball=neighbor_type == 1)
        ref = jax.jit(lambda *a: jvp.three_nn_vector_pool(*a, 3.2, neighbor_type))(
            *(jnp.asarray(a) for a in (centers, cv, sx, sv, sf)))
        got = vector_pool.three_nn_vector_pool(*(_t(a) for a in (centers, cv, sx, sv, sf)), 3.2,
                                               neighbor_type)
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
        _close(got[0], ref[0], f"feats {neighbor_type}")
        _close(got[1], ref[1], f"local xyz {neighbor_type}")


@pytest.mark.parametrize("mode", ["avg", "choice"])
def test_voxel_pool_matches(mode):
    sx, sv, sf, cx, cv = _scene(8)
    loc = sx[None].astype(np.float64) - cx[:, None]
    edge = (loc + 1.5) / 3.0 * 2
    assert np.abs(edge - np.round(edge)).min() > 1e-5
    ref = jax.jit(lambda *a: jvp.voxel_pool(*a, (2, 2, 2), 1.5, mode))(
        *(jnp.asarray(a) for a in (cx, cv, sx, sv, sf)))
    got = vector_pool.voxel_pool(*(_t(a) for a in (cx, cv, sx, sv, sf)), (2, 2, 2), 1.5, mode)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
    _close(got[0], ref[0], f"{mode} feats")
    _close(got[1], ref[1], f"{mode} local xyz")


def _check_stats(pm, variables, jmut):
    moved = state_dict_from_jax({"params": variables["params"],
                                 "batch_stats": jax.device_get(jmut["batch_stats"])}, pm)
    state = pm.state_dict()
    stats = [k for k in moved if k.endswith(("running_mean", "running_var"))]
    assert stats
    for key in stats:
        _close(state[key], moved[key].numpy(), key)


@pytest.mark.parametrize("agg", ["local_interpolation", "voxel_avg_pool", "voxel_random_choice"])
def test_vector_pool_aggregation_matches_in_training(agg):
    """One group at train=True: the output and the batch statistics."""
    sx, sv, sf, cx, cv = _scene(9)
    args = tuple(a[None] for a in (sx, sv, sf, cx, cv))
    kw = dict(num_local_voxel=(2, 2, 2), num_reduced_channels=3, local_aggregation_type=agg,
              post_mlps=(16, 8), max_neighbor_distance=1.6, num_channels_of_local_aggregation=4)
    jm = jvp.VectorPoolAggregation(input_channels=6, **kw)
    pm = vector_pool.VectorPoolAggregation(6, **kw).train()
    variables, jv = _pair(jm, pm, *(jnp.asarray(a) for a in args), True)
    ref, jmut = jax.jit(lambda v, *a: jm.apply(v, *a, True, mutable=["batch_stats"]))(
        jv, *(jnp.asarray(a) for a in args))
    got = pm(*(_t(a) for a in args))
    _close(got, ref, agg)
    _check_stats(pm, variables, jmut)
    assert not got[0, ~cv].any()


def test_vector_pool_msg_matches_in_training():
    sx, sv, sf, cx, cv = _scene(10)
    args = tuple(a[None] for a in (sx, sv, sf, cx, cv))
    groups = ({"num_local_voxel": (2, 2, 2), "post_mlps": (16,), "max_neighbor_distance": 0.8},
              {"num_local_voxel": (3, 3, 3), "post_mlps": (16,), "max_neighbor_distance": 1.6})
    kw = dict(num_reduced_channels=3, groups=groups, num_channels_of_local_aggregation=4,
              msg_post_mlps=(24, 12))
    for g in groups:
        offs = vector_pool.local_grid_offsets(g["num_local_voxel"], g["max_neighbor_distance"])
        _assert_three_nn_margin(cx[:, None] + offs[None], sx, sv, 2 * g["max_neighbor_distance"])
    jm = jvp.VectorPoolAggregationMSG(input_channels=6, **kw)
    pm = vector_pool.VectorPoolAggregationMSG(6, **kw).train()
    variables, jv = _pair(jm, pm, *(jnp.asarray(a) for a in args), True)
    ref, jmut = jax.jit(lambda v, *a: jm.apply(v, *a, True, mutable=["batch_stats"]))(
        jv, *(jnp.asarray(a) for a in args))
    got = pm(*(_t(a) for a in args))
    _close(got, ref, "MSG train")
    _check_stats(pm, variables, jmut)


# ---- the model helpers -----------------------------------------------------


def test_load_data_to_device_keeps_what_jax_keeps():
    batch = {"points": np.zeros((1, 4, 5), np.float32), "points_valid": np.ones((1, 4), bool),
             "gt_labels": np.arange(3, dtype=np.int32), "frame_id": ["a"], "batch_size": 1,
             "metadata": [{"k": 1}]}
    ref = jmodels.load_data_to_device(batch)
    got = models.load_data_to_device(batch, torch.device("cpu"))
    assert set(got) == set(ref) == {"points", "points_valid", "gt_labels"}
    for k, v in got.items():
        assert isinstance(v, torch.Tensor) and v.device.type == "cpu"
        np.testing.assert_array_equal(v.numpy(), np.asarray(ref[k]))


def test_model_fn_decorator_runs_the_loss_step():
    """On the tiny detector: finite loss, the tb keys as floats, and the
    same loss twice (the default generator is seeded)."""
    from __graft_entry__ import _TINY
    from cpd_tpu_torch.models.detector import VoxelRCNN
    from cpd_tpu_torch.utils.synthetic import make_tiny_train_batch
    from cpd_tpu_torch.utils.weights import seeded_state_dict

    model = VoxelRCNN(**dict(_TINY, mm=False))
    model.load_state_dict(seeded_state_dict(model, 0))
    state = {k: v.clone() for k, v in model.state_dict().items()}
    fn = models.model_fn_decorator(model)
    batch = make_tiny_train_batch(b=1, with_proto=True)
    loss, tb, disp = fn(batch)
    model.load_state_dict(state)
    again, _, _ = fn(batch)
    assert torch.isfinite(loss) and set(disp) == set(tb) and "total_loss" in disp
    assert all(isinstance(v, float) for v in disp.values())
    assert float(again.detach()) == float(loss.detach())
