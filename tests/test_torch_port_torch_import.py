"""The port's reference-checkpoint loader (cpd_tpu_torch.utils.torch_import)
against the JAX package's, on the CPU.

A synthetic state dict in the reference's layout (at least one key for each
pattern of ``reference_key_rules``, spconv 2.x and 1.x kernels, BN step
counters, a key of the wrong shape, a kernel no layout fits and an unknown
key) goes through the JAX package's ``convert_reference_state_dict`` and
then ``state_dict_from_jax``, and through the port's direct map onto a port
model holding the same weights: the two state dicts are equal tensor for
tensor and the reports are equal. Models: ``_TINY`` with MM on 5 point
columns, and with the KITTI yaml's 4 (the reference's ``conv_input`` of
``(16, 3, 3, 3, 4)`` lands). In a subprocess the port reads the ``.pth``
and converts it with ``jax``, ``flax`` and ``yaml`` absent from
``sys.modules``."""
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _TINY
from cpd_tpu.models.detector import VoxelRCNN as JVoxelRCNN
from cpd_tpu.utils import torch_import as jti
from cpd_tpu.utils.checkpoint import load_torch_checkpoint as jax_load_torch_checkpoint
from cpd_tpu_torch.models.detector import VoxelRCNN
from cpd_tpu_torch.utils import torch_import as pti
from cpd_tpu_torch.utils.checkpoint import load_torch_checkpoint
from cpd_tpu_torch.utils.weights import state_dict_from_jax
from tests.test_torch_port_models import seeded_jax_variables
from tests.torch_port_refs import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]


@functools.lru_cache(maxsize=None)
def jax_variables(n_cols, seed=0):
    """A training init's tree of ``_TINY`` with MM, on ``n_cols`` point
    columns (JAX takes the first conv's Cin from the batch), seeded."""
    jm = JVoxelRCNN(**_TINY, mm=True)
    pts = np.zeros((1, 128, n_cols), np.float32)
    gt = np.zeros((1, 2, 8), np.float32)
    gt[..., 3:6], gt[..., 7] = 2.0, 1.0
    batch = {"points": jnp.asarray(pts), "points_valid": jnp.ones((1, 128), bool),
             "gt_boxes": jnp.asarray(gt), "gt_valid": jnp.ones((1, 2), bool)}
    rngs = {k: jax.random.PRNGKey(i) for i, k in enumerate(("params", "sampling", "dropout"))}
    return seeded_jax_variables(jax.eval_shape(lambda: jm.init(rngs, batch, True)), seed)


def reference_state_dict(params, rng):
    """Reference-layout keys for every rule of ``reference_key_rules``, with
    the shapes of the JAX tree ``params`` and values drawn from ``rng``."""
    def draw(*shape):
        return rng.normal(0, 0.5, shape).astype(np.float32)

    def spconv(w, v1=False, taps=(3, 3, 3)):  # JAX (K, Cin, Cout) -> reference
        _, cin, cout = w.shape
        return draw(*taps, cin, cout) if v1 else draw(cout, *taps, cin)

    def bn(prefix, c, stats=True):
        out = {f"{prefix}.weight": draw(c), f"{prefix}.bias": draw(c)}
        if stats:
            out.update({f"{prefix}.running_mean": draw(c),
                        f"{prefix}.running_var": rng.uniform(0.5, 2, c).astype(np.float32),
                        f"{prefix}.num_batches_tracked": np.asarray(7)})
        return out

    def conv2d(w):  # flax (kh, kw, Cin, Cout) -> torch (Cout, Cin, kh, kw)
        return draw(w.shape[3], w.shape[2], w.shape[0], w.shape[1])

    b0, b1 = params["backbone"]["branch0"], params["backbone"]["branch1"]
    bev, head, roi = params["bev_backbone"], params["dense_head"], params["roi_head"]
    cin = b0["conv_input"]["kernel"].shape[1]
    sd = {"backbone_3d.conv_input.0.weight": spconv(b0["conv_input"]["kernel"]),
          **bn("backbone_3d.conv_input.1", 16),
          "backbone_3d.conv_input_2.0.weight": spconv(b1["conv_input"]["kernel"], v1=True),
          **bn("backbone_3d.conv_input_2.1", 16, stats=False),
          "backbone_3d.conv1.0.conv1.weight": spconv(b0["res1a"]["SubMConvBN_0"]["kernel"]),
          **bn("backbone_3d.conv1.0.bn1", 16),
          "backbone_3d.conv1.1.conv2.weight": spconv(b0["res1b"]["SubMConvBN_1"]["kernel"]),
          **bn("backbone_3d.conv1_2.1.bn2", 16),
          "backbone_3d.conv2.0.0.weight": spconv(b0["down2"]["kernel"]),
          **bn("backbone_3d.conv2.0.1", 32),
          "backbone_3d.conv2_2.1.conv1.weight": spconv(b1["res2a"]["SubMConvBN_0"]["kernel"]),
          # the light MM branch has no second block in stage 3: no target
          "backbone_3d.conv3_2.2.conv1.weight": spconv(b0["res3b"]["SubMConvBN_0"]["kernel"]),
          "backbone_3d.conv4.0.0.weight": spconv(b0["down4"]["kernel"]),
          "backbone_3d.conv_out.0.weight": spconv(b0["conv_out"]["kernel"], taps=(3, 1, 1)),
          **bn("backbone_3d.conv_out.1", b0["conv_out"]["kernel"].shape[2]),
          "backbone_2d.blocks.0.1.weight": conv2d(bev["block0_in"]["Conv_0"]["kernel"]),
          **bn("backbone_2d.blocks.0.2", bev["block0_in"]["Conv_0"]["kernel"].shape[3]),
          "backbone_2d.blocks.1.4.weight": conv2d(bev["block1_conv0"]["Conv_0"]["kernel"]),
          **bn("backbone_2d.blocks.1.5", bev["block1_conv0"]["Conv_0"]["kernel"].shape[3]),
          "dense_head.shared_conv.0.weight": conv2d(head["shared_conv"]["kernel"]),
          "dense_head.shared_conv.0.bias": draw(head["shared_conv"]["kernel"].shape[3]),
          **bn("dense_head.shared_conv.1", head["shared_conv"]["kernel"].shape[3]),
          "dense_head.heads_list.0.hm.0.0.weight": conv2d(head["head_hm"]["conv0"]["kernel"]),
          **bn("dense_head.heads_list.0.hm.0.1", head["head_hm"]["conv0"]["kernel"].shape[3]),
          "dense_head.heads_list.0.hm.1.weight": conv2d(head["head_hm"]["out"]["kernel"]),
          "dense_head.heads_list.0.hm.1.bias": draw(head["head_hm"]["out"]["kernel"].shape[3]),
          "dense_head.heads_list.0.rot.1.bias": draw(head["head_rot"]["out"]["kernel"].shape[3]),
          "roi_head.shared_fc_layers.0.weight": draw(*roi["shared0"]["fc0"]["kernel"].shape[::-1]),
          **bn("roi_head.shared_fc_layers.1", roi["shared0"]["fc0"]["kernel"].shape[1]),
          "roi_head.shared_fc_layers_mm.4.weight":
              draw(*roi["shared1"]["fc1"]["kernel"].shape[::-1]),
          "roi_head.cls_layers.7.weight": draw(*roi["cls_tower0"]["out"]["kernel"].shape[::-1]),
          "roi_head.cls_layers.7.bias": draw(roi["cls_tower0"]["out"]["kernel"].shape[1]),
          "roi_head.reg_layers_P.0.weight": draw(*roi["reg_tower1"]["fc0"]["kernel"].shape[::-1]),
          # a shape error, a kernel no layout fits, an unknown key
          "backbone_3d.conv2.0.1.running_var": draw(33),
          "backbone_3d.conv3.0.0.weight": draw(5, 5),
          "some.unknown.key": draw(3)}
    for blk in (0, 1):
        deblock = bev[f"deblock{blk}"]["kernel"]  # flax (kh, kw, Cin, Cout)
        sd[f"backbone_2d.deblocks.{blk}.0.weight"] = draw(deblock.shape[2], deblock.shape[3],
                                                          deblock.shape[0], deblock.shape[1])
        sd.update(bn(f"backbone_2d.deblocks.{blk}.1", deblock.shape[3]))
    return sd


@functools.lru_cache(maxsize=None)
def _both(n_cols):
    variables = jax_variables(n_cols)
    pm = VoxelRCNN(**_TINY, mm=True, num_point_features=n_cols)
    pm.load_state_dict(state_dict_from_jax(variables, pm), strict=True)
    sd = reference_state_dict(variables["params"], np.random.default_rng(n_cols))
    params, stats, report = jti.convert_reference_state_dict(
        sd, variables["params"], variables["batch_stats"])
    want = state_dict_from_jax({"params": params, "batch_stats": stats}, pm)
    return sd, pm, want, report


@pytest.mark.parametrize("n_cols", [5, 4])
def test_direct_map_equals_jax_convert_then_bridge(n_cols):
    sd, pm, want, want_report = _both(n_cols)
    got, report = pti.convert_reference_state_dict(sd, pm)
    assert report == want_report
    assert set(got) == set(want) == set(pm.state_dict())
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
    assert sorted(report["missed"]) == ["backbone_3d.conv2.0.1.running_var",
                                        "backbone_3d.conv3.0.0.weight",
                                        "backbone_3d.conv3_2.2.conv1.weight", "some.unknown.key"]
    assert [p for p, *_ in report["shape_errors"]] == [
        ("backbone", "branch0", "down2", "MaskedBatchNorm_0", "var")]
    assert len(report["matched"]) == len(sd) - 4 - len(report["ignored"])
    assert all(k.endswith("num_batches_tracked") for k in report["ignored"])
    # the first conv landed, in the port's (K, Cin, Cout)
    np.testing.assert_array_equal(
        got["backbone.branch0.conv_input.weight"].numpy(),
        jti.convert_spconv_weight(sd["backbone_3d.conv_input.0.weight"], n_cols, 16))
    assert got["backbone.branch0.conv_input.weight"].shape == (27, n_cols, 16)
    # the model's own weights stay where the file has no key
    assert torch.equal(got["roi_head.cls_tower1.out.weight"],
                       pm.state_dict()["roi_head.cls_tower1.out.weight"])


def test_five_channel_reference_input_does_not_fit_the_kitti_model():
    """The reference ``conv_input`` of a 5-column model fits no layout of a
    4-column model: missed, as in the JAX package (which cannot learn a
    layout either)."""
    variables = jax_variables(4)
    pm = VoxelRCNN(**_TINY, mm=True, num_point_features=4)
    sd = {"backbone_3d.conv_input.0.weight": np.zeros((16, 3, 3, 3, 5), np.float32)}
    _, report = pti.convert_reference_state_dict(sd, pm)
    assert report == jti.convert_reference_state_dict(
        sd, variables["params"], variables["batch_stats"])[2]
    assert report["missed"] == list(sd)


def test_pth_loads_and_converts_without_jax(tmp_path):
    """``load_torch_checkpoint`` equals the JAX package's, and a subprocess
    that imports no JAX converts the file to the same state dict."""
    sd, pm, want, want_report = _both(4)
    path = tmp_path / "reference.pth"
    torch.save({"model_state": {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()},
                "epoch": 3, "version": "pcdet+0.5.2"}, path)
    got, ref = load_torch_checkpoint(path), jax_load_torch_checkpoint(path)
    assert set(got) == set(ref) == set(sd)
    for k in sd:
        np.testing.assert_array_equal(got[k], ref[k])
    torch.save(pm.state_dict(), tmp_path / "model.pt")
    code = (
        "import json, sys, torch\n"
        "from __graft_entry__ import _TINY\n"
        "from cpd_tpu_torch.models.detector import VoxelRCNN\n"
        "from cpd_tpu_torch.utils.checkpoint import load_torch_checkpoint\n"
        "from cpd_tpu_torch.utils.torch_import import convert_reference_state_dict\n"
        "pm = VoxelRCNN(**_TINY, mm=True, num_point_features=4)\n"
        f"pm.load_state_dict(torch.load({str(tmp_path / 'model.pt')!r}))\n"
        f"sd, report = convert_reference_state_dict(load_torch_checkpoint("
        f"{str(path)!r}), pm)\n"
        f"torch.save(sd, {str(tmp_path / 'out.pt')!r})\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'yaml', 'cpd_tpu')]\n"
        "assert not bad, bad\n"
        "print(json.dumps({k: report[k] for k in ('matched', 'missed', 'ignored')}))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report["matched"] == want_report["matched"]
    assert report["missed"] == want_report["missed"]
    out = torch.load(tmp_path / "out.pt")
    assert set(out) == set(want)
    for k in want:
        assert torch.equal(out[k], want[k]), k
