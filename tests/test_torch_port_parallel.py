"""The port's data-parallel slice on the CPU: ``parallel.comm``, the global
moments of both batch norms, the global loss normalisers and the summed
gradient of ``make_train_step``, on 2 gloo ranks (spawned processes, a
``file://`` store, one torch thread each; ``tests/torch_dist_ranks.py``).

JAX's data-parallel step (``make_train_step(model, make_mesh(2))``) is the
one-device step on the global batch. The strict tier holds the port's two
ranks to it on the rpn-only ``_TINY`` model (MM branch off) at f32
(``jax_f32``), 8 samples of 2048 points, 4 a rank and 4 a JAX device, the
same seeded weights through the bridge: the loss and the gradient norm
within rtol 1e-4, every summed gradient within 1e-4 of its scale (plus 1e-6
of the largest leaf's scale), and the parameters after the step within the
atol 8e-3 of tests/test_parallel.py. At 512 points a sample the deepest
sparse layers hold a handful of voxels and this step's f32 gradient is
ill-conditioned (a 1e-7 nudge of the weights moves a leaf by 2e-2 of its
scale), so no comparison at 1e-4 could hold there;
``test_rpn_gradients_are_well_conditioned_at_the_strict_input`` checks that
at 2048 points rounding moves the gradient by well under the tier. The
loose tier (the full model: proposal top-k, NMS and RoI sampling amplify
rounding into another RoI set, and each rank samples from its own
generator) holds the two ranks' step to one process's on the same 8
samples of 512 points as tests/test_parallel.py:85-99 does. The JAX step
runs once for the file, the ranks once.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import __graft_entry__ as ge
from cpd_tpu.models.detector import VoxelRCNN as JVoxelRCNN
from cpd_tpu.parallel import build_optimizer, make_mesh, make_train_step as jax_train_step
from cpd_tpu.parallel.trainer import TrainState
from cpd_tpu_torch.datasets.loader import DataLoader, EvalDistributedSampler
from cpd_tpu_torch.models.detector import VoxelRCNN, set_compute_dtype
from cpd_tpu_torch.parallel import comm, init_state, make_train_step, step_generator
from cpd_tpu_torch.utils.weights import grads_to_jax_tree, seeded_state_dict, state_dict_from_jax
from tests.test_torch_port_build_network import jax_f32
from tests.test_torch_port_models import seeded_jax_variables
from tests.torch_dist_ranks import (comm_norms_and_steps, make_norm, norm_inputs, norm_step,
                                    start_ranks)

OPT = {"OPTIMIZER": "adam_onecycle", "LR": 0.003}
# rpn-only, MM branch off: it would feed no loss without the RoI head
RPN_KW = dict(ge._TINY, with_roi_head=False, mm=False)
N_SAMPLES = 8
STRICT_POINTS = 2048  # a sample's points in the strict tier (see the docstring)


@pytest.fixture(scope="module", autouse=True)
def restored_thread_count():
    """The one-process steps here run torch on one thread; the file gives
    its worker back the count it found, so that the files after it run as
    they would alone (tests/test_torch_port_train.py's bf16 tiers do not
    hold at one thread)."""
    threads = torch.get_num_threads()
    yield
    torch.set_num_threads(threads)


def _global_batch(points=STRICT_POINTS):
    return {k: np.array(v) for k, v in ge._make_batch(b=N_SAMPLES, p=points, seed=1).items()}


def _stash_grads():
    """An optax link that keeps the gradients it is handed as its state."""
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates))


@pytest.fixture(scope="module")
def jax_variables():
    """The rpn-only model's seeded variables, as JAX lays them out."""
    batch = _global_batch()
    with jax_f32():
        model = JVoxelRCNN(**RPN_KW)
        rngs = {k: jax.random.PRNGKey(i) for i, k in enumerate(("params", "sampling", "dropout"))}
        shapes = jax.eval_shape(lambda: model.init(rngs, {k: jnp.asarray(v[:1])
                                                          for k, v in batch.items()}, True))
        return seeded_jax_variables(shapes, 3)


@pytest.fixture(scope="module")
def steps(tmp_path_factory, jax_variables):
    """Everything the two ranks compute, in one launch that runs while JAX
    compiles its step: the comm names and the norms, then one train step of
    the rpn-only model (the JAX weights, f32) on their shards of the strict
    tier's 8 samples and one of the full model (seeded weights) on their
    shards of the loose tier's. And JAX's sharded step of the rpn-only model
    at f32 over a 2-device mesh on the strict tier's samples: its tb, its
    raw gradients (kept by a link ahead of the optimizer) and the parameters
    after it. -> (ranks, JAX step)."""
    batch = _global_batch()
    rpn_sd = state_dict_from_jax(jax_variables, VoxelRCNN(**RPN_KW))
    full_sd = seeded_state_dict(VoxelRCNN(**ge._TINY), 5)
    cases = {"rpn": (RPN_KW, rpn_sd, batch, True),
             "full": (ge._TINY, full_sd, _global_batch(512), True)}
    join = start_ranks(comm_norms_and_steps, 2, tmp_path_factory.mktemp("ranks"), cases)
    with jax_f32():
        model = JVoxelRCNN(**RPN_KW)
        tx = optax.chain(_stash_grads(), build_optimizer(OPT, 100))
        params = jax.tree_util.tree_map(jnp.asarray, jax_variables["params"])
        state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                           batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                                              jax_variables["batch_stats"]),
                           opt_state=tx.init(params), tx=tx, apply_fn=model.apply)
        mesh = make_mesh(2)
        with mesh:
            new, tb = jax_train_step(model, mesh, donate=False)(
                state, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0))
        jax_step = {"tb": {k: float(v) for k, v in tb.items()},
                    "grads": jax.tree_util.tree_map(np.asarray, new.opt_state[0]),
                    "params": jax.tree_util.tree_map(np.asarray, new.params)}
    return join(), jax_step


@pytest.fixture(scope="module")
def ranks(steps):
    return steps[0]


@pytest.fixture(scope="module")
def jax_step(steps):
    return steps[1]


def test_comm_single_process_paths(tmp_path):
    """Outside a process group: tests/test_comm.py's expectations."""
    assert comm.get_world_size() == 1 and comm.get_rank() == 0 and comm.backend() == "none"
    comm.synchronize()
    out = comm.all_gather_arrays(np.arange(4))
    assert len(out) == 1
    np.testing.assert_array_equal(out[0], np.arange(4))
    assert comm.average_reduce_value(3.5) == 3.5
    assert comm.reduce_dict({"a": 1.0, "b": 2.0}) == {"a": 1.0, "b": 2.0}
    assert comm.merge_results_dist([1, 2, 3, 4], size=3, tmpdir=tmp_path) == [1, 2, 3]
    t = torch.ones(3, requires_grad=True)
    assert comm.all_reduce_sum(t) is t and comm.global_sum(t) is t
    assert comm.broadcast_object({"x": 1}) == {"x": 1}
    assert comm.init_distributed("cpu") == (0, 1, torch.device("cpu"))


def test_placement_follows_the_cards():
    """nccl on a card a rank; gloo where ranks share cards or on the CPU;
    without a card and without the CPU asked for, it raises."""
    assert comm.placement("cpu", 1, 2, 0) == ("gloo", torch.device("cpu"))
    assert comm.placement(None, 1, 4, 4) == ("nccl", torch.device("cuda", 1))
    assert comm.placement("cuda:0", 0, 1, 1) == ("nccl", torch.device("cuda", 0))
    assert comm.placement(None, 1, 2, 1) == ("gloo", torch.device("cuda", 0))
    assert comm.placement(None, 5, 8, 4) == ("gloo", torch.device("cuda", 1))
    with pytest.raises(RuntimeError, match="no CUDA card"):
        comm.placement(None, 0, 2, 0)


def test_comm_on_two_ranks(ranks):
    """Gather in rank order, mean and sum of a dict, the mean of a value,
    rank 0's merge in dataset order with the pad dropped, a broadcast."""
    for r, out in enumerate(ranks):
        assert (out["rank"], out["world"], out["backend"]) == (r, 2, "gloo")
        np.testing.assert_array_equal(np.stack(out["gather"]), [[0, 1, 2], [10, 11, 12]])
        assert out["average"] == 1.5
        assert out["mean"] == {"a": 0.5, "b": 2.5} and out["sum"] == {"a": 1.0, "b": 5.0}
        assert out["broadcast"] == {"from": 0}
        assert out["global_sum"] == 3.0
    assert ranks[0]["merged"] == [f"frame{i}" for i in range(5)] and ranks[1]["merged"] == []


def test_all_reduce_sum_gradient(ranks):
    """y = x_0 + x_1 on both ranks; rank r's loss is (r + 1) * sum(y). The
    gradient of each x_r is that of the summed loss in one process."""
    x = [torch.arange(4, dtype=torch.float64).add(r).requires_grad_() for r in range(2)]
    y = x[0] + x[1]
    sum((r + 1.0) * y.sum() for r in range(2)).backward()
    for r, out in enumerate(ranks):
        np.testing.assert_array_equal(out["reduce_y"], y.detach().numpy())
        np.testing.assert_array_equal(out["reduce_grad"], x[r].grad.numpy())
    # the norms' 2 calls forward and 2 backward, the value sum once
    assert ranks[0]["collective_calls"] == {"norm": 6, "loss": 1, "grad": 0}


@pytest.mark.parametrize("kind", ["masked", "2d"])
def test_norm_on_two_ranks_equals_one_process(ranks, kind):
    """MaskedBatchNorm (rank 1 has no valid row) and BatchNorm2d on 2 ranks
    against one process on the concatenated batch: outputs, running
    statistics (bit-equal over the ranks) and input gradients within 1e-5 of
    their scale; the ranks' weight and bias gradients summed, likewise."""
    parts = [norm_inputs(r, kind) for r in range(2)]
    cat = lambda i: None if parts[0][i] is None else np.concatenate([p[i] for p in parts])  # noqa: E731
    ref = norm_step(make_norm(kind), cat(0), cat(1), cat(2))

    def close(got, want, what):
        scale = max(float(np.abs(want).max()), 1e-3)
        assert float(np.abs(got - want).max()) <= 1e-5 * scale, what

    for key in ("running_mean", "running_var"):
        np.testing.assert_array_equal(ranks[0][kind][key], ranks[1][kind][key])
        close(ranks[0][kind][key], ref[key], key)
    for key in ("y", "x_grad"):
        close(np.concatenate([o[kind][key] for o in ranks]), ref[key], key)
    for key in ("weight_grad", "bias_grad"):
        close(sum(o[kind][key] for o in ranks), ref[key], key)
    if kind == "masked":
        assert not ranks[1][kind]["y"].any()


def _grads_as_jax(grads, like):
    """A port gradient dict in the layout of JAX's gradient tree ``like``,
    flattened by path; a parameter without a gradient (off the rpn-only
    path: JAX gives it zeros) counts as zeros."""
    model = VoxelRCNN(**RPN_KW)
    for k, p in model.named_parameters():
        p.grad = torch.from_numpy(grads.get(k, np.zeros(tuple(p.shape), np.float32)))
    return dict(jax.tree_util.tree_leaves_with_path(grads_to_jax_tree(model, like)))


def _rpn_step(sd):
    """The port's one-process step of the rpn-only model on all 8 samples
    from the state dict ``sd``, f32: its tb and gradients."""
    model = VoxelRCNN(**RPN_KW)
    model.load_state_dict(sd, strict=True)
    set_compute_dtype(model, None)
    torch.set_num_threads(1)
    state = init_state(model, OPT, 100, device="cpu")
    _, tb = make_train_step()(state, {k: torch.from_numpy(v) for k, v in _global_batch().items()},
                              step_generator(0, 0, "cpu"))
    return {"tb": {k: float(v) for k, v in tb.items()},
            "grads": {k: p.grad.numpy().copy() for k, p in model.named_parameters()
                      if p.grad is not None}}


@pytest.fixture(scope="module")
def rpn_one_process(jax_variables):
    """The port's one-process step on the JAX weights."""
    return _rpn_step(state_dict_from_jax(jax_variables, VoxelRCNN(**RPN_KW)))


def test_rpn_gradients_are_well_conditioned_at_the_strict_input(jax_variables,
                                                                 rpn_one_process):
    """At the strict tier's input, moving every weight by 1e-7 of itself
    (rounding-sized) moves each leaf of this step's gradient by less than
    half the strict tier's tolerance: the comparison with JAX measures the
    port, not the conditioning. (At 512 points a sample the same nudge moves
    a leaf by about 2e-2 of its scale.)"""
    rng = np.random.default_rng(0)
    sd = state_dict_from_jax(jax_variables, VoxelRCNN(**RPN_KW))
    nudged = _rpn_step({k: v * (1.0 + 1e-7 * torch.from_numpy(
        rng.standard_normal(tuple(v.shape)).astype(np.float32))) for k, v in sd.items()})
    base = rpn_one_process["grads"]
    floor = 1e-6 * max(float(np.abs(g).max()) for g in base.values())
    for k, g in base.items():
        moved = float(np.abs(nudged["grads"][k] - g).max())
        assert moved <= 0.5 * (1e-4 * float(np.abs(g).max()) + floor), (k, moved)


def test_strict_tier_against_jax_sharded_step(ranks, jax_step, jax_variables,
                                              rpn_one_process):
    """The rpn-only step at f32 on 2 ranks against JAX's step over a
    2-device mesh on the same 8 samples: the ranks' losses sum to JAX's
    loss and their (equal) gradient norm is JAX's, within rtol 1e-4; every
    summed gradient is JAX's within 1e-4 of the leaf's scale plus 1e-6 of
    the largest leaf's scale (as tests/test_torch_port_train_modules.py
    allows: a bias in front of a batch norm has an exact gradient of zero,
    and its computed one is rounding); the ranks hold the same gradients,
    within that tolerance of the port's one process on all 8 samples. The
    parameters after the step are JAX's within tests/test_parallel.py's
    atol: one adam step moves a parameter by about the learning rate
    whatever its gradient's size, so that check catches a missing or
    wrong-signed update, not a gradient's size."""
    a, b = (o["rpn"] for o in ranks)
    jtb = jax_step["tb"]
    np.testing.assert_allclose(a["tb"]["total_loss"] + b["tb"]["total_loss"],
                               jtb["total_loss"], rtol=1e-4)
    assert a["tb"]["skipped_nonfinite"] == jtb["skipped_nonfinite"] == 0.0
    assert b["tb"]["grad_norm"] == a["tb"]["grad_norm"]
    np.testing.assert_allclose(a["tb"]["grad_norm"], jtb["grad_norm"], rtol=1e-4)

    assert set(a["grads"]) == set(b["grads"]) == set(rpn_one_process["grads"])
    for k, g in a["grads"].items():
        np.testing.assert_array_equal(g, b["grads"][k], err_msg=k)
    two = _grads_as_jax(a["grads"], jax_step["grads"])
    single = _grads_as_jax(rpn_one_process["grads"], jax_step["grads"])
    ref = dict(jax.tree_util.tree_leaves_with_path(jax_step["grads"]))
    assert set(two) == set(ref) and len(ref) > 50
    floor = 1e-6 * max(float(np.abs(want).max()) for want in ref.values())
    for path, want in ref.items():
        tol = 1e-4 * float(np.abs(want).max()) + floor
        name = jax.tree_util.keystr(path)
        assert float(np.abs(two[path] - want).max()) <= tol, name
        assert float(np.abs(two[path] - single[path]).max()) <= tol, name

    model = VoxelRCNN(**RPN_KW)
    for k, v in a["state"].items():
        np.testing.assert_array_equal(v, b["state"][k], err_msg=k)
    after = state_dict_from_jax({"params": jax_step["params"],
                                 "batch_stats": jax_variables["batch_stats"]}, model)
    for k, _ in model.named_parameters():
        np.testing.assert_allclose(a["state"][k], after[k].numpy(), atol=8e-3, err_msg=k)


def test_loose_tier_full_model(ranks):
    """The full model (RoI head, MM branch): 2 ranks against one process on
    the same 8 samples, finite, no step skipped, ranks in the same state,
    losses within a relative 0.5."""
    batch = _global_batch(512)
    model = VoxelRCNN(**ge._TINY)
    model.load_state_dict(seeded_state_dict(model, 5), strict=True)
    set_compute_dtype(model, None)
    torch.set_num_threads(1)
    state = init_state(model, OPT, 100, device="cpu")
    _, tb = make_train_step()(state, {k: torch.from_numpy(v) for k, v in batch.items()},
                              step_generator(0, 0, "cpu"))
    one = float(tb["total_loss"])
    two = sum(o["full"]["tb"]["total_loss"] for o in ranks)
    a, b = (o["full"] for o in ranks)
    assert np.isfinite(one) and np.isfinite(two)
    assert a["tb"]["skipped_nonfinite"] == b["tb"]["skipped_nonfinite"] == 0.0
    assert float(tb["skipped_nonfinite"]) == 0.0
    for k, v in a["state"].items():
        np.testing.assert_array_equal(v, b["state"][k], err_msg=k)
    assert abs(one - two) / max(abs(one), abs(two)) < 0.5


class _Indices:
    """A dataset of its own indices."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"idx": np.asarray([i])}


@pytest.mark.parametrize("n", [16, 19])
def test_strided_split_gives_each_global_batch(n):
    """Training: batch i of rank 0 and of rank 1 (2 samples each) together
    hold batch i of one process at 4, every epoch, and both ranks have as
    many batches. Evaluation: the padded shards hold every frame."""
    def batches(world, rank, size, epoch, training=True):
        loader = DataLoader(_Indices(n), size, shuffle=training, seed=3, drop_last=training,
                            world_size=world, rank=rank, num_threads=1)
        loader.set_epoch(epoch)
        out = [sorted(b["idx"].ravel().tolist()) for b in loader]
        assert len(out) == len(loader)
        return out

    for epoch in (0, 1):
        whole = batches(1, 0, 4, epoch)
        parts = [batches(2, r, 2, epoch) for r in range(2)]
        assert len(parts[0]) == len(parts[1]) == len(whole) == n // 4
        for i, b in enumerate(whole):
            assert sorted(parts[0][i] + parts[1][i]) == b
    shards = [sum(batches(2, r, 2, 0, training=False), []) for r in range(2)]
    assert len(shards[0]) == len(shards[1])
    assert set(shards[0]) | set(shards[1]) == set(range(n))
    assert EvalDistributedSampler(1, 4, 3).shard == [0]
