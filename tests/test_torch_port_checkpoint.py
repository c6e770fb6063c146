"""The port's checkpoints (cpd_tpu_torch.utils.checkpoint), on the CPU:
the reference's ``.pth`` format, rotation beyond ``max_keep`` as the JAX
package rotates, ``list_checkpoints``, strict loading, ``auto_resume`` (the
next epoch, weights, optimizer moments and update count, step counter) and
the non-strict ``load_params_from_file``."""
import logging

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from cpd_tpu.parallel import trainer as jtrainer
from cpd_tpu.utils import checkpoint as jckpt
from cpd_tpu_torch.parallel import init_state
from cpd_tpu_torch.utils import checkpoint

OPT = {"LR": 0.01, "WEIGHT_DECAY": 1e-5}


def _model(seed=0, width=3):
    torch.manual_seed(seed)
    return nn.Sequential(nn.Linear(4, width), nn.BatchNorm1d(width), nn.Linear(width, 2))


def _trained(seed=0, steps=2):
    state = init_state(_model(seed), OPT, 10, device="cpu")
    for i in range(steps):
        state.optimizer.zero_grad()
        state.model(torch.randn(6, 4, generator=torch.Generator().manual_seed(i))).sum().backward()
        state.optimizer.step()
        state.step += 1
    return state


def test_format_is_the_reference_pth(tmp_path):
    state = _trained()
    path = checkpoint.save_checkpoint(tmp_path, state, 7)
    assert path.name == "checkpoint_epoch_7.pth"
    payload = torch.load(path, map_location="cpu", weights_only=True)
    assert set(payload) == {"model_state", "optimizer_state", "epoch", "it", "version"}
    assert payload["epoch"] == 7 and payload["it"] == 2
    assert payload["optimizer_state"]["count"] == 2
    assert all(torch.equal(payload["model_state"][k], v)
               for k, v in state.model.state_dict().items())


def test_rotation_and_listing_keep_what_the_jax_package_keeps(tmp_path):
    port_root, jax_root = tmp_path / "port", tmp_path / "jax"
    state = _trained(steps=1)
    tx = optax.sgd(0.1)
    params = {"w": jnp.ones((2, 2))}
    jstate = jtrainer.TrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats={},
                                 opt_state=tx.init(params), tx=tx, apply_fn=None)
    for epoch in (1, 2, 5, 3, 4):
        checkpoint.save_checkpoint(port_root, state, epoch, max_keep=3)
        jckpt.save_checkpoint(jax_root, jstate, epoch, max_keep=3)
    port = [e for e, _ in checkpoint.list_checkpoints(port_root)]
    ref = [e for e, _ in jckpt.list_checkpoints(jax_root)]
    assert port == ref == [3, 4, 5]
    assert checkpoint.list_checkpoints(tmp_path / "missing") == []


def test_strict_load_and_bare_model(tmp_path):
    model = _model(1)
    path = checkpoint.save_checkpoint(tmp_path, model, 1)
    payload = torch.load(path, map_location="cpu", weights_only=True)
    assert payload["optimizer_state"] is None and payload["it"] == 0
    fresh = _model(2)
    checkpoint.load_checkpoint(path, fresh)
    assert all(torch.equal(a, b) for a, b in zip(model.state_dict().values(),
                                                 fresh.state_dict().values()))
    with pytest.raises(RuntimeError):
        checkpoint.load_checkpoint(path, _model(3, width=5))


def test_auto_resume_restores_epoch_weights_and_optimizer(tmp_path):
    state = _trained(steps=3)
    for epoch in (1, 2):
        checkpoint.save_checkpoint(tmp_path, state, epoch)
    fresh = init_state(_model(9), OPT, 10, device="cpu")
    fresh, start = checkpoint.auto_resume(tmp_path, fresh)
    assert start == 3 and fresh.step == 3 and fresh.optimizer.count == 3
    for p, q in zip(state.model.parameters(), fresh.model.parameters()):
        assert torch.equal(p, q)
        for k in ("mu", "nu"):
            assert torch.equal(state.optimizer.state[p][k], fresh.optimizer.state[q][k])
    empty = init_state(_model(9), OPT, 10, device="cpu")
    assert checkpoint.auto_resume(tmp_path / "none", empty) == (empty, 0)


def test_load_params_from_file_is_not_strict(tmp_path, caplog):
    src = _model(4, width=3)
    path = checkpoint.save_checkpoint(tmp_path, src, 1)
    dst = nn.Sequential(nn.Linear(4, 3), nn.BatchNorm1d(3), nn.Linear(3, 5), nn.Linear(5, 1))
    before = {k: v.clone() for k, v in dst.state_dict().items()}
    logger = logging.getLogger("test_ckpt")
    with caplog.at_level(logging.INFO, logger="test_ckpt"):
        checkpoint.load_params_from_file(dst, path, logger)
    after = dst.state_dict()
    for k in ("0.weight", "0.bias", "1.running_mean"):
        assert torch.equal(after[k], src.state_dict()[k])
    for k in ("2.weight", "2.bias", "3.weight"):  # other shape, or not in the file
        assert torch.equal(after[k], before[k])
    text = caplog.text
    assert "skipped from the file" in text and "2.weight" in text and "3.weight" in text
    np.testing.assert_array_equal(after["0.weight"].numpy(), src.state_dict()["0.weight"].numpy())
