"""The trainer of the PyTorch port against the JAX package's:

* the optimizers (adam_onecycle, adam, sgd) and both schedules against
  optax, step by step, on the same numpy gradients, over enough steps to
  pass the schedules' turning point and their end (f32: 1e-6);
* ``MetricsLogger`` and ``PhaseTimer`` against the JAX package's;
* the non-finite guard: a step with a NaN gradient leaves parameters,
  moments and batch-norm statistics as they were and advances the counter;
* the trainer's device rule, and the port's copy of the tiny training batch.
"""
import math

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from __graft_entry__ import _make_batch
from cpd_tpu.parallel import trainer as jtrainer
from cpd_tpu_torch.models import norm
from cpd_tpu_torch.parallel import trainer
from cpd_tpu_torch.utils.synthetic import make_tiny_train_batch

TOTAL_STEPS = 20


def _t(x):
    return torch.from_numpy(np.array(x))


def test_schedules_match_optax():
    lr = trainer.cosine_onecycle_schedule(TOTAL_STEPS, 0.003, 0.4, 10.0, 1000.0)
    ref = optax.cosine_onecycle_schedule(transition_steps=TOTAL_STEPS, peak_value=0.003,
                                         pct_start=0.4, div_factor=10.0, final_div_factor=1000.0)
    mom = trainer.onecycle_momentum_schedule(TOTAL_STEPS, (0.95, 0.85), 0.4)
    jmom = jtrainer.onecycle_momentum_schedule(TOTAL_STEPS, (0.95, 0.85), 0.4)
    for step in range(TOTAL_STEPS + 5):
        np.testing.assert_allclose(lr(step), float(ref(step)), rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(mom(step), float(jmom(step)), rtol=1e-6)
    assert lr(0) == pytest.approx(0.0003) and lr(8) == pytest.approx(0.003)
    assert lr(TOTAL_STEPS) == pytest.approx(0.0003 / 1000.0) == lr(TOTAL_STEPS + 3)
    assert mom(0) == pytest.approx(0.95) and mom(8) == pytest.approx(0.85)
    # one step of warm-up (the floor of max(int(T * pct), 1))
    assert trainer.onecycle_momentum_schedule(2, (0.95, 0.85), 0.4)(1) == pytest.approx(
        float(jtrainer.onecycle_momentum_schedule(2, (0.95, 0.85), 0.4)(1)))


def test_optimizer_matches_optax_step_by_step():
    """Clip 32, AdamW with the scheduled rate and b1, decoupled decay 1e-5:
    parameters after every one of 25 steps (the turning point is step 8, the
    schedule ends at 20), on gradients whose norm is above the clip in some
    steps and below it in others."""
    rng = np.random.default_rng(0)
    shapes = {"a": (7, 5), "b": (5,), "c": (3, 4, 2)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    cfg = {"OPTIMIZER": "adam_onecycle", "LR": 0.003, "WEIGHT_DECAY": 1e-5}
    tx = jtrainer.build_optimizer(cfg, TOTAL_STEPS)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    opt_state = tx.init(jparams)
    tparams = {k: nn.Parameter(_t(v)) for k, v in params.items()}
    opt = trainer.build_optimizer(list(tparams.values()), cfg, TOTAL_STEPS)
    clipped = 0
    for step in range(25):
        scale = 30.0 if step % 3 == 0 else 0.5
        grads = {k: (rng.normal(size=s) * scale).astype(np.float32) for k, s in shapes.items()}
        updates, opt_state = tx.update({k: jnp.asarray(g) for k, g in grads.items()}, opt_state,
                                       jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, p in tparams.items():
            p.grad = _t(grads[k])
        gnorm = opt.step()
        want_norm = math.sqrt(sum(float((g.astype(np.float64) ** 2).sum())
                                  for g in grads.values()))
        np.testing.assert_allclose(float(gnorm), want_norm, rtol=1e-5)
        clipped += want_norm > 32
        for k in shapes:
            np.testing.assert_allclose(tparams[k].detach().numpy(), np.asarray(jparams[k]),
                                       rtol=1e-6, atol=1e-6, err_msg=f"step {step} {k}")
    assert 0 < clipped < 25 and opt.count == 25
    moved = max(float(np.abs(tparams[k].detach().numpy() - params[k]).max()) for k in shapes)
    assert moved > 1e-2
    with pytest.raises(KeyError):
        trainer.build_optimizer(list(tparams.values()), {"OPTIMIZER": "rmsprop"}, 10)


@pytest.mark.parametrize("name", ["adam", "sgd"])
def test_adam_and_sgd_match_optax_step_by_step(name):
    """``adam`` (AdamW at a constant rate, decay 1e-5) and ``sgd`` (momentum
    0.9, no decay), each after the clip to 32, against the JAX package's
    ``build_optimizer`` over 5 steps: step 1 is clipped, step 3 has a NaN
    gradient. The JAX trainer reverts its whole state on a non-finite
    gradient norm (cpd_tpu/parallel/trainer.py:164-172), so the optax side
    skips that update; the port's optimizer must leave parameters, moments
    and count as they were. f32, 1e-6."""
    rng = np.random.default_rng(1)
    shapes = {"a": (7, 5), "b": (5,), "c": (3, 4, 2)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    cfg = {"OPTIMIZER": name, "LR": 0.01, "WEIGHT_DECAY": 1e-5, "MOMENTUM": 0.9,
           "GRAD_NORM_CLIP": 32}
    tx = jtrainer.build_optimizer(cfg, TOTAL_STEPS)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    opt_state = tx.init(jparams)
    tparams = {k: nn.Parameter(_t(v)) for k, v in params.items()}
    opt = trainer.build_optimizer(list(tparams.values()), cfg, TOTAL_STEPS)
    assert isinstance(opt, trainer.ClippedAdamW if name == "adam" else trainer.ClippedSGD)
    for step in range(5):
        grads = {k: (rng.normal(size=s) * (30.0 if step == 1 else 0.5)).astype(np.float32)
                 for k, s in shapes.items()}
        if step == 3:
            grads["b"][2] = np.nan
        jgrads = {k: jnp.asarray(g) for k, g in grads.items()}
        if np.isfinite(float(optax.global_norm(jgrads))):
            updates, opt_state = tx.update(jgrads, opt_state, jparams)
            jparams = optax.apply_updates(jparams, updates)
        before = ([p.detach().clone() for p in tparams.values()],
                  [v.clone() for st in opt.state.values() for v in st.values()], opt.count)
        for k, p in tparams.items():
            p.grad = _t(grads[k])
        gnorm = float(opt.step())
        if step == 1:
            assert gnorm > 32
        if step == 3:
            assert not math.isfinite(gnorm) and opt.count == before[2] == 3
            assert all(torch.equal(a, p.detach()) for a, p in zip(before[0], tparams.values()))
            assert all(torch.equal(a, b) for a, b in zip(
                before[1], [v for st in opt.state.values() for v in st.values()]))
        for k in shapes:
            np.testing.assert_allclose(tparams[k].detach().numpy(), np.asarray(jparams[k]),
                                       rtol=1e-6, atol=1e-6, err_msg=f"{name} step {step} {k}")
    assert opt.count == 4
    # the count travels with the state dict
    fresh = trainer.build_optimizer(list(tparams.values()), cfg, TOTAL_STEPS)
    fresh.load_state_dict(opt.state_dict())
    assert fresh.count == 4


def test_unknown_optimizer_raises_a_key_error():
    for name in ("rmsprop", "adamw", "Adam"):
        with pytest.raises(KeyError):
            jtrainer.build_optimizer({"OPTIMIZER": name}, 10)
        with pytest.raises(KeyError, match=name):
            trainer.build_optimizer([nn.Parameter(torch.zeros(2))], {"OPTIMIZER": name}, 10)


def test_metrics_logger_jsonl_matches_the_jax_package(tmp_path):
    """The same calls give the same records (every key but ``time``) in
    ``metrics.jsonl``, TensorBoard off on both sides; a second logger on the
    same directory appends."""
    from cpd_tpu.utils.common import MetricsLogger as JaxMetricsLogger
    from cpd_tpu_torch.utils.common import MetricsLogger
    calls = [(1, {"total_loss": np.float32(2.5), "grad_norm": 40.25}),
             (20, {"total_loss": 1.125, "skipped_nonfinite": 0.0, "hm_loss": np.float64(0.3)}),
             (40, {"nonfinite_rois": 3})]
    for cls, side, wrap in ((JaxMetricsLogger, "jax", jnp.asarray),
                            (MetricsLogger, "port", torch.tensor)):
        for half in (calls[:2], calls[2:]):
            logger = cls(tmp_path / side, enable_tb=False)
            assert logger.tb is None
            for step, m in half:
                logger.log(step, {k: wrap(v) for k, v in m.items()})
            logger.close()
    import json
    recs = {side: [json.loads(line) for line in (tmp_path / side / "metrics.jsonl").open()]
            for side in ("jax", "port")}
    assert len(recs["port"]) == len(calls) == len(recs["jax"])
    for a, b in zip(recs["port"], recs["jax"]):
        assert isinstance(a.pop("time"), float) and isinstance(b.pop("time"), float)
        assert list(a) == list(b)
        np.testing.assert_allclose(list(a.values()), list(b.values()), rtol=1e-7)
    assert [r["step"] for r in recs["port"]] == [1, 20, 40]


def test_phase_timer_summary_matches_the_jax_package(monkeypatch):
    """The same phases on the same clock give the same mean seconds per
    phase; a phase left by an exception is counted."""
    import types
    from cpd_tpu.utils import common as jcommon
    from cpd_tpu_torch.utils import common as pcommon
    summaries = []
    for module in (jcommon, pcommon):
        ticks = iter([0.0, 1.5, 2.0, 2.25, 3.0, 6.0, 10.0, 10.5, 11.0, 11.0])
        monkeypatch.setattr(module, "time", types.SimpleNamespace(perf_counter=lambda: next(ticks)))
        timer = module.PhaseTimer()
        for name in ("data", "step", "data", "h2d"):
            with timer.phase(name):
                pass
        with pytest.raises(ValueError):
            with timer.phase("step"):
                raise ValueError
        summaries.append(timer.summary())
        monkeypatch.undo()
    assert summaries[0] == summaries[1] == {"data": 2.25, "step": 0.125, "h2d": 0.5}


class _ToyDetector(nn.Module):
    """A stand-in with the detector's training interface: a parameter, a
    batch norm (statistics that the forward moves) and ``loss_step``."""

    def __init__(self):
        super().__init__()
        self.weight = nn.Parameter(torch.tensor([[0.5, -1.0], [2.0, 0.25]]))
        self.bn = norm.MaskedBatchNorm(2, momentum=0.1)

    def loss_step(self, batch, sampling_uniforms=None, generator=None):
        y = self.bn(batch["x"] @ self.weight, batch["valid"])
        loss = (y ** 2).mean() + (self.weight ** 2).sum() * batch["poison"]
        return loss, {"total_loss": loss, "cur_it": torch.tensor(batch["cur_it"])}


def _toy_snapshot(state):
    model, opt = state.model, state.optimizer
    return ([p.detach().clone() for p in model.parameters()]
            + [b.clone() for b in model.buffers()]
            + [v.clone() for s in opt.state.values() for v in s.values()])


def test_nonfinite_guard_skips_the_update():
    model = _ToyDetector()
    state = trainer.init_state(model, {"LR": 0.01}, 10, device="cpu")
    step = trainer.make_train_step()
    x = torch.randn(6, 2, generator=torch.Generator().manual_seed(0)) * 3 + 1
    batch = {"x": x, "valid": torch.tensor([True] * 5 + [False]), "poison": torch.tensor(0.0)}
    state, tb = step(state, batch)
    assert float(tb["skipped_nonfinite"]) == 0.0 and float(tb["cur_it"]) == 0.0
    assert state.step == 1 and state.optimizer.count == 1
    before = _toy_snapshot(state)
    state, tb = step(state, dict(batch, poison=torch.tensor(float("nan"))))
    assert float(tb["skipped_nonfinite"]) == 1.0 and not math.isfinite(float(tb["grad_norm"]))
    after = _toy_snapshot(state)
    assert len(before) == len(after) == 3 + 2 + 6
    for a, b in zip(before, after):
        assert torch.equal(a, b)
    # the step counter advances all the same; the optimizer's own count does not
    assert state.step == 2 and state.optimizer.count == 1
    assert all(float(p.grad.abs().max()) == 0.0 for p in model.parameters())
    state, tb = step(state, batch)
    assert float(tb["skipped_nonfinite"]) == 0.0 and float(tb["cur_it"]) == 2.0
    assert state.step == 3 and state.optimizer.count == 2
    assert not torch.equal(before[0], model.weight.detach())
    assert math.isfinite(float(tb["grad_norm"])) and float(tb["grad_norm"]) > 0


class _FlagRecorder(_ToyDetector):
    """The toy detector, recording cuDNN's two flags where its loss is taken
    and where the backward reaches the loss; ``batch["fail"]`` makes it
    raise."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def _flags(self, where):
        cudnn = torch.backends.cudnn
        self.seen.append((where, cudnn.benchmark, cudnn.deterministic))

    def loss_step(self, batch, sampling_uniforms=None, generator=None):
        self._flags("forward")
        if batch.get("fail"):
            raise RuntimeError("toy failure")
        loss, tb = super().loss_step(batch, sampling_uniforms, generator)
        loss.register_hook(lambda grad: self._flags("backward"))
        return loss, tb


def test_train_step_runs_under_deterministic_cudnn_and_restores_the_callers_flags():
    """On the card a step from the same state gives the same bits twice only
    with cuDNN's deterministic algorithms (a convolution's weight gradient
    may otherwise sum with atomics): the step's forward and backward see
    benchmark off and deterministic on, and the caller's flags come back
    after the step, also when the step raises."""
    cudnn = torch.backends.cudnn
    model = _FlagRecorder()
    state = trainer.init_state(model, {"LR": 0.01}, 10, device="cpu")
    step = trainer.make_train_step()
    batch = {"x": torch.randn(6, 2, generator=torch.Generator().manual_seed(0)),
             "valid": torch.tensor([True] * 6), "poison": torch.tensor(0.0)}
    saved = cudnn.benchmark, cudnn.deterministic
    try:
        for flags in ((True, False), (False, False), (True, True)):
            cudnn.benchmark, cudnn.deterministic = flags
            model.seen.clear()
            state, tb = step(state, batch)
            assert model.seen == [("forward", False, True), ("backward", False, True)]
            assert (cudnn.benchmark, cudnn.deterministic) == flags
            with pytest.raises(RuntimeError, match="toy failure"):
                step(state, dict(batch, fail=True))
            assert (cudnn.benchmark, cudnn.deterministic) == flags
    finally:
        cudnn.benchmark, cudnn.deterministic = saved
    assert float(tb["skipped_nonfinite"]) == 0.0 and state.step == 3


def test_trainer_entry_points_need_a_card_or_an_explicit_cpu():
    if torch.cuda.is_available():
        assert trainer.resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA card"):
            trainer.init_state(_ToyDetector(), {}, 10)
    assert trainer.resolve_device("cpu").type == "cpu"


def test_tiny_train_batch_copy_identical():
    ref = _make_batch(b=2, with_proto=True)
    out = make_tiny_train_batch(b=2, with_proto=True)
    assert set(out) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(out[k], np.asarray(ref[k]), err_msg=k)
    assert "points1" not in make_tiny_train_batch(with_proto=False)
