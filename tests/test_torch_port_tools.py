"""The port's checkpoint and result tools against the JAX package's, on the CPU.

* ``ops.nms.weighted_box_fusion`` against ``cpd_tpu.ops.nms.weighted_box_fusion``
  on seeded boxes with exact and jittered duplicates, overlapping boxes of
  other labels and invalid rows; the JAX side runs eagerly under
  ``jax_nms_with_clip_iou`` (its jitted NMS otherwise scores identical boxes
  with IoU 0, ROADMAP section 3), so both use the clip-method IoU. Keep mask
  and labels exact, boxes and scores within 1e-5.
* ``tools.merge_detections.merge_result_files`` against the JAX tool's on
  two written result.pkl files (an empty frame included); names and frame
  ids exact, boxes and scores within 1e-5. ``average_checkpoints`` writes
  the mean of the inputs.
* ``tools.strip_checkpoint`` drops the optimizer state and the rest loads
  back into a fresh model bit-equal.
"""
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from cpd_tpu.ops import nms as jnms
from cpd_tpu_torch.ops import nms
from cpd_tpu_torch.parallel import init_state
from cpd_tpu_torch.tools import merge_detections, strip_checkpoint
from cpd_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from tests.test_torch_port_models import jax_nms_with_clip_iou
from tests.torch_port_refs import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)
NAMES = np.array(["Vehicle", "Pedestrian", "Cyclist"])


def _boxes(rng, n, spread=10.0):
    b = np.zeros((n, 7), np.float32)
    b[:, 0:2] = rng.uniform(-spread, spread, (n, 2))
    b[:, 2] = rng.uniform(-1, 1, n)
    b[:, 3:6] = rng.uniform(1.0, 4.5, (n, 3))
    b[:, 6] = rng.uniform(-np.pi, np.pi, n)
    return b


def _wbf_case(seed):
    """24 base boxes; 8 exact duplicates, 10 jittered copies (a few cm, a few
    degrees), 6 copies under another label; 5 rows invalid."""
    rng = np.random.default_rng(seed)
    base = _boxes(rng, 24)
    labels = rng.integers(0, 3, 24)
    dup = rng.choice(24, 8, replace=False)
    jit = rng.choice(24, 10, replace=False)
    other = rng.choice(24, 6, replace=False)
    jittered = base[jit] + np.concatenate(
        [rng.normal(0, 0.05, (10, 6)), rng.normal(0, 0.05, (10, 1))], 1).astype(np.float32)
    boxes = np.concatenate([base, base[dup], jittered, base[other]]).astype(np.float32)
    labels = np.concatenate([labels, labels[dup], labels[jit], (labels[other] + 1) % 3])
    scores = rng.uniform(0.05, 1.0, len(boxes)).astype(np.float32)
    valid = np.ones(len(boxes), bool)
    valid[rng.choice(len(boxes), 5, replace=False)] = False
    return boxes, scores, labels.astype(np.int32), valid


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("iou_thresh", [0.7, 0.3])
def test_weighted_box_fusion_matches_jax(seed, iou_thresh):
    boxes, scores, labels, valid = _wbf_case(seed)
    with jax_nms_with_clip_iou():
        ref = jnms.weighted_box_fusion(jnp.asarray(boxes), jnp.asarray(scores),
                                       jnp.asarray(labels), iou_thresh, jnp.asarray(valid))
        ref = [np.asarray(r) for r in ref]
    out = nms.weighted_box_fusion(torch.from_numpy(boxes), torch.from_numpy(scores),
                                  torch.from_numpy(labels), iou_thresh, torch.from_numpy(valid))
    out = [o.numpy() for o in out]
    assert [o.shape for o in out] == [r.shape for r in ref] == [(48, 7), (48,), (48,), (48,)]
    np.testing.assert_array_equal(out[3], ref[3])
    np.testing.assert_array_equal(out[2], ref[2])
    np.testing.assert_allclose(out[0], ref[0], **TOL)
    np.testing.assert_allclose(out[1], ref[1], **TOL)
    # duplicates were fused: fewer survivors than valid rows
    assert 0 < int(out[3].sum()) < int(valid.sum())


def _write_results(path, rng, n_frames=3, empty=1):
    annos = []
    for i in range(n_frames):
        n = 0 if i == empty else int(rng.integers(4, 12))
        boxes = _boxes(rng, n, spread=12.0)
        annos.append({"frame_id": f"segment-0000#{i:04d}", "boxes_lidar": boxes,
                      "score": rng.uniform(0.1, 1.0, n).astype(np.float32),
                      "name": NAMES[rng.integers(0, 3, n)],
                      "pred_labels": rng.integers(1, 4, n)})
    with open(path, "wb") as f:
        pickle.dump(annos, f)
    return annos


def test_merge_result_files_matches_the_jax_tool(tmp_path):
    from tools import merge_detections as jax_tool
    rng = np.random.default_rng(3)
    a = _write_results(tmp_path / "a.pkl", rng)
    b = _write_results(tmp_path / "b.pkl", rng)
    # the second file repeats some of the first's boxes, a few cm off
    for fa, fb in zip(a, b):
        k = min(len(fa["score"]), 3)
        fb["boxes_lidar"] = np.concatenate([fb["boxes_lidar"], fa["boxes_lidar"][:k] + 0.02])
        fb["score"] = np.concatenate([fb["score"], fa["score"][:k] * 0.9])
        fb["name"] = np.concatenate([fb["name"], fa["name"][:k]])
    with open(tmp_path / "b.pkl", "wb") as f:
        pickle.dump(b, f)
    paths = [tmp_path / "a.pkl", tmp_path / "b.pkl"]
    with jax_nms_with_clip_iou():
        ref = jax_tool.merge_result_files(paths)
    out = merge_detections.merge_result_files(paths, device="cpu")
    assert len(out) == len(ref) == 3
    for o, r in zip(out, ref):
        assert o["frame_id"] == r["frame_id"]
        np.testing.assert_array_equal(o["name"], r["name"])
        np.testing.assert_allclose(o["boxes_lidar"], r["boxes_lidar"], **TOL)
        np.testing.assert_allclose(o["score"], r["score"], **TOL)
    assert sum(len(o["score"]) for o in out) > 0
    assert out[1] is not None and len(out[1]["score"]) == len(b[1]["score"])
    # the CLI writes the same list; without a card it needs --device cpu
    merged = merge_detections.main([str(tmp_path / "m.pkl"), *map(str, paths), "--device", "cpu"])
    with open(tmp_path / "m.pkl", "rb") as f:
        written = pickle.load(f)
    for w, o in zip(written, merged):
        np.testing.assert_array_equal(w["boxes_lidar"], o["boxes_lidar"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            merge_detections.main([str(tmp_path / "n.pkl"), *map(str, paths)])


class _Small(nn.Module):
    def __init__(self):
        super().__init__()
        self.fc = nn.Linear(4, 3)
        self.bn = nn.BatchNorm1d(3)

    def forward(self, x):
        return self.bn(self.fc(x))


def _trained_state(seed):
    torch.manual_seed(seed)
    state = init_state(_Small(), {"OPTIMIZER": "adam"}, 10, device="cpu")
    x = torch.randn(8, 4)
    for _ in range(2):
        state.optimizer.zero_grad()
        state.model(x).square().mean().backward()
        state.optimizer.step()
        state.step += 1
    return state


def test_average_checkpoints_is_the_mean(tmp_path):
    states = [_trained_state(s) for s in range(3)]
    paths = [save_checkpoint(tmp_path / f"run{i}", s, epoch=i) for i, s in enumerate(states)]
    out = merge_detections.average_checkpoints(paths, tmp_path / "avg.pth")
    avg = torch.load(out, weights_only=True)
    first = torch.load(paths[0], weights_only=True)
    sds = [s.model.state_dict() for s in states]
    assert set(avg["model_state"]) == set(sds[0])
    for k, v in avg["model_state"].items():
        if v.is_floating_point():
            torch.testing.assert_close(v, sum(sd[k] for sd in sds) / 3, rtol=1e-6, atol=1e-7)
        else:  # num_batches_tracked: the first file's
            assert torch.equal(v, first["model_state"][k])
    assert avg["epoch"] == 0 and avg["it"] == first["it"] == 2
    assert avg["optimizer_state"]["count"] == first["optimizer_state"]["count"]


def test_strip_checkpoint_drops_the_optimizer_and_loads_back_bit_equal(tmp_path):
    state = _trained_state(0)
    path = save_checkpoint(tmp_path / "ckpt", state, epoch=3)
    out = strip_checkpoint.strip_checkpoint(path)
    assert out == tmp_path / "ckpt" / "checkpoint_epoch_3_deploy.pth"
    payload = torch.load(out, weights_only=True)
    assert set(payload) == {"model_state", "optimizer_state", "epoch", "it", "version"}
    assert payload["optimizer_state"] is None and payload["epoch"] == 3 and payload["it"] == 2
    assert out.stat().st_size < path.stat().st_size
    fresh = _Small()
    load_checkpoint(out, fresh)
    for k, v in state.model.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k
    # into a TrainState: the weights load, the optimizer stays fresh
    other = init_state(_Small(), {"OPTIMIZER": "adam"}, 10, device="cpu")
    load_checkpoint(out, other)
    assert other.optimizer.count == 0 and not other.optimizer.state
    out = strip_checkpoint.main([str(path), "--out", str(tmp_path / "d.pth")])
    assert out == tmp_path / "d.pth"
    assert torch.load(tmp_path / "d.pth", weights_only=True)["optimizer_state"] is None


def test_tool_flags_match_the_jax_tools(monkeypatch):
    """strip_checkpoint takes the JAX tool's arguments; merge_detections
    takes the JAX tool's positional output and inputs (plus ``--device``)."""
    from tools import strip_checkpoint as jax_strip
    seen = {}
    monkeypatch.setattr(jax_strip, "strip_checkpoint", lambda d, o: seen.setdefault("jax", (d, o)))
    monkeypatch.setattr(strip_checkpoint, "strip_checkpoint",
                        lambda d, o: seen.setdefault("port", (d, o)))
    for side, tool in (("jax", jax_strip), ("port", strip_checkpoint)):
        tool.main(["some/ckpt", "--out", "x"])
    assert seen["jax"] == seen["port"] == ("some/ckpt", "x")
    with pytest.raises(SystemExit):  # an output and at least one input
        merge_detections.main(["only_out.pkl"])
