"""The detector's training wiring in the port, on the JAX package's seeded
tree: which parameters each of the two losses reaches, and the weight bridge
over the MM modules and its inverse for gradients. These need the port model
and batch of ``test_torch_port_train.py`` but not its JAX step."""
import copy

import numpy as np
import pytest
import torch

from cpd_tpu_torch.utils.weights import grads_to_jax_tree, state_dict_from_jax
from tests.test_torch_port_losses import port_uniforms
from tests.test_torch_port_train import KW, _leaves, port_setup
from tests.torch_port_refs import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def port_pair():
    _, variables, pm, _, pbatch, _ = port_setup()
    return pm, variables, pbatch


def test_proposals_are_constants_to_the_second_stage(port_pair):
    """The detector's wiring of the two losses, with the port's own
    proposals (not the JAX side's, as in the step above): proposals carry no
    gradient (the JAX detector's ``stop_gradient``), so the RoI-head loss
    reaches neither the dense head, the BEV backbone nor ``conv_out``, and
    the dense-head loss reaches neither the RoI head nor the MM branch; each
    loss reaches every other parameter."""
    pm, _, pbatch = port_pair
    model = copy.deepcopy(pm).train()
    uniforms = port_uniforms(np.random.default_rng(5).random((2, 6, KW["num_rois"]))
                             .astype(np.float32))
    total, tb = model.loss_step(pbatch, sampling_uniforms=uniforms)
    names, params = zip(*model.named_parameters())
    behind_bev = ("bev_backbone.", "dense_head.", "backbone.branch0.conv_out.")
    second_stage = ("roi_head.", "backbone.branch1.")
    for what, scalar, unreached in (("RoI-head", total - tb["rpn_loss"], behind_bev),
                                    ("dense-head", tb["rpn_loss"], second_stage)):
        grads = torch.autograd.grad(scalar, params, retain_graph=True, allow_unused=True)
        for name, g in zip(names, grads):
            if name.startswith(unreached):
                assert g is None or not bool(g.any()), f"the {what} loss reaches {name}"
            else:
                assert g is not None and bool(torch.isfinite(g).all()), f"{what}: {name}"


def test_weight_bridge_covers_mm_modules_and_inverts_for_gradients(port_pair):
    """The bridge fills the MM modules (branch1, pool_branch_mm, shared1, the
    second towers) and still fails on an unmapped key; ``grads_to_jax_tree``
    undoes its layout changes exactly: parameters pushed through it as if
    they were gradients come back as the JAX leaves they were loaded from."""
    pm, variables, _ = port_pair
    model = copy.deepcopy(pm)
    state = state_dict_from_jax(variables, model)
    for part in ("backbone.branch1.", "roi_head.pool_branch_mm.", "roi_head.shared1.",
                 "roi_head.cls_tower1.", "roi_head.reg_tower1."):
        assert any(k.startswith(part) for k in state), part
    assert not any(k.startswith("backbone.branch1.conv_out") for k in state)
    model.load_state_dict(state, strict=True)
    for p in model.parameters():
        p.grad = p.detach().clone()
    back = dict(_leaves(grads_to_jax_tree(model, variables["params"])))
    want = dict(_leaves(variables["params"]))
    assert set(back) == set(want)
    for name, leaf in want.items():
        np.testing.assert_array_equal(back[name], leaf, err_msg=name)
    extra = copy.deepcopy(variables)
    extra["params"]["roi_head"]["shared1"]["fc9"] = {"kernel": np.zeros((4, 4), np.float32)}
    with pytest.raises(KeyError, match="unmapped"):
        state_dict_from_jax(extra, model)
    with pytest.raises(KeyError, match="no parameter"):
        grads_to_jax_tree(model, extra["params"])
    next(model.parameters()).grad = None
    with pytest.raises(ValueError, match="no gradient"):
        grads_to_jax_tree(model, variables["params"])
