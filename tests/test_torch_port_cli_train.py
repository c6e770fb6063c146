"""The port's training CLI (``python -m cpd_tpu_torch.tools.train``) on the CPU.

The shipped voxel_rcnn_cproto_center.yaml cut through ``--set`` the way
tests/test_tools_cli.py::_shrink_cfg cuts it (a 16 m square of 0.25 m
voxels, 2048 points and voxels, stage caps 1024 to 256, 16 RoIs an image,
grid 4; every channel width stays the yaml's), on a written Waymo sequence
of 4 frames with prototype banks (the ``points1`` view), batch 2: two steps
an epoch. No JAX detector runs here: the step is held to JAX by
tests/test_torch_port_train.py; the JAX CLI is read only for its flags and
its batch, step and schedule arithmetic.

Three runs, as a user makes them: A (a) ``--epochs 2 --debug_steps 2``
stops after epoch 0, (b) ``--epochs 2 --eval_after 1`` auto-resumes it and
evaluates the last checkpoint; B ``--epochs 2`` trains without a break. The
stop is ``--debug_steps`` and not ``--epochs 1``, because ``--epochs`` sets
the length of the one-cycle schedule (steps an epoch x epochs, as in the
JAX CLI): a 1-epoch run follows another learning-rate curve. A's and B's
last checkpoints must be equal bit for bit.

TensorBoard is hidden from the CLI (``torch.utils.tensorboard`` set to None
in ``sys.modules``): where it is installed it imports TensorFlow, which
imports JAX, and the port must run where neither is installed.
"""
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from cpd_tpu_torch.tools import test as eval_cli
from cpd_tpu_torch.tools import train as cli
from cpd_tpu_torch.tools.strip_checkpoint import strip_checkpoint
from cpd_tpu_torch.utils.synthetic import make_lidar_frame, write_waymo_sequence

REPO = Path(__file__).resolve().parents[1]
SHIPPED = "tools/cfgs/models/voxel_rcnn_cproto_center.yaml"
SEQ = "segment-0000"
N_FRAMES = 4
HALF = 8.0
# _shrink_cfg's cuts, as --set overrides of the shipped yaml
SHRINK_SETS = [
    "DATA_CONFIG.SAMPLED_INTERVAL.train", "1", "DATA_CONFIG.SAMPLED_INTERVAL.test", "1",
    "DATA_CONFIG.POINT_CLOUD_RANGE", f"[-{HALF},-{HALF},-2.0,{HALF},{HALF},4.0]",
    "DATA_CONFIG.POINT_CAP", "2048", "DATA_CONFIG.GT_CAP", "16",
    "DATA_CONFIG.DATA_PROCESSOR",
    "[{'NAME': 'mask_points_and_boxes_outside_range', 'REMOVE_OUTSIDE_BOXES': True}, "
    "{'NAME': 'shuffle_points', 'SHUFFLE_ENABLED': {'train': True, 'test': False}}, "
    "{'NAME': 'transform_points_to_voxels', 'VOXEL_SIZE': [0.25, 0.25, 0.15], "
    "'MAX_POINTS_PER_VOXEL': 5, 'MAX_NUMBER_OF_VOXELS': {'train': 2048, 'test': 2048}}]",
    "MODEL.BACKBONE_3D.VOXEL_CAPS", "[1024,512,256,256]",
    "MODEL.DENSE_HEAD.POST_PROCESSING.NMS_CONFIG",
    "{'NMS_THRESH': 0.8, 'NMS_PRE_MAXSIZE': 512, 'NMS_POST_MAXSIZE': 64}",
    "MODEL.ROI_HEAD.TARGET_CONFIG.ROI_PER_IMAGE", "16",
    "MODEL.ROI_HEAD.ROI_GRID_POOL.GRID_SIZE", "4",
    "MODEL.POST_PROCESSING.NMS_CONFIG",
    "{'NMS_THRESH': 0.3, 'NMS_PRE_MAXSIZE': 512, 'NMS_POST_MAXSIZE': 64}",
]


def _sets(root):
    return ["DATA_CONFIG.DATA_PATH", str(root), *SHRINK_SETS]


def _argv(root, out, *extra):
    return ["--cfg_file", SHIPPED, "--batch_size", "2", "--workers", "2", "--device", "cpu",
            "--output_dir", str(out), *extra, "--set", *_sets(root)]


def _write_sequence(root):
    frames = []
    for i in range(N_FRAMES):
        pts, _ = make_lidar_frame(np.random.default_rng([5, i]), 20_000)
        frames.append(pts[(np.abs(pts[:, 0]) < HALF) & (np.abs(pts[:, 1]) < HALF)])
    write_waymo_sequence(root, SEQ, frames, seed=2, n_boxes=6, r_max=HALF - 1.0, protos=True)


@pytest.fixture
def no_tensorboard(monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


@pytest.fixture(scope="module")
def sequence(tmp_path_factory):
    root = tmp_path_factory.mktemp("waymo_train")
    _write_sequence(root)
    return root


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread for this file: on a CPU that other test workers keep
    busy, the default thread count makes each of the CLI's many small
    operations wait for threads that are not running (the three CLI runs
    took 683 s beside five busy workers on 8 cores, 13 s alone)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def runs(sequence):
    """A (a) + A (b) and B, as the module docstring says; returns the root
    and the final states {"a", "b", "c"}."""
    root = sequence
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "torch.utils.tensorboard", None)
        states = {
            "a": cli.main(_argv(root, root / "A", "--epochs", "2", "--debug_steps", "2",
                                "--fix_random_seed", "--log_every", "1")),
            "b": cli.main(_argv(root, root / "A", "--epochs", "2", "--eval_after", "1")),
            "c": cli.main(_argv(root, root / "B", "--epochs", "2", "--log_every", "2")),
        }
    return root, states


def _records(path):
    import json
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_debug_steps_log_finite_losses_and_metrics(runs):
    """(a): two steps, each logged (``--debug_steps`` logs every step) with
    finite losses, ``proto_loss`` among them, and no skipped step; one
    metrics.jsonl record a logged step; epoch 0's checkpoint written and
    the phase means logged."""
    root, states = runs
    assert states["a"].step == 2
    recs = _records(root / "A" / "metrics.jsonl")
    assert [r["step"] for r in recs] == [1, 2]
    for r in recs:
        assert {"proto_loss", "total_loss", "rcnn_cls1", "hm_loss", "grad_norm"} <= set(r)
        assert all(np.isfinite(v) for v in r.values()), r
        assert r["skipped_nonfinite"] == 0.0
    log = (root / "A" / "log_train.txt").read_text()
    assert log.count(" it 1 ") == 1 and log.count(" it 2 ") == 1
    assert "phase means: {'data'" in log and "'h2d'" in log and "'step'" in log
    assert "auto-resumed from epoch 0" in log
    assert sorted(p.name for p in (root / "A" / "ckpt").iterdir()) == [
        "checkpoint_epoch_0.pth", "checkpoint_epoch_1.pth"]
    # B logs every second step
    assert [r["step"] for r in _records(root / "B" / "metrics.jsonl")] == [2, 4]


def _equal_payloads(a, b):
    assert a["epoch"] == b["epoch"] and a["it"] == b["it"]
    assert set(a["model_state"]) == set(b["model_state"])
    for k, v in a["model_state"].items():
        assert torch.equal(v, b["model_state"][k]), k
    oa, ob = a["optimizer_state"], b["optimizer_state"]
    assert oa["count"] == ob["count"] and oa["param_groups"] == ob["param_groups"]
    assert set(oa["state"]) == set(ob["state"])
    for k, st in oa["state"].items():
        for name, v in st.items():
            assert torch.equal(v, ob["state"][k][name]), (k, name)


def test_resumed_run_equals_an_unbroken_one_bit_for_bit(runs):
    """(b) resumed at epoch 1 from A's epoch-0 checkpoint; its epoch-1
    checkpoint equals B's in every model tensor, every optimizer tensor,
    the update count and the step."""
    root, states = runs
    assert states["b"].step == states["c"].step == 4
    assert states["b"].optimizer.count == states["c"].optimizer.count == 4
    load = lambda side: torch.load(root / side / "ckpt" / "checkpoint_epoch_1.pth",  # noqa: E731
                                   weights_only=True)
    a, b = load("A"), load("B")
    assert a["it"] == 4 and a["optimizer_state"]["count"] == 4
    _equal_payloads(a, b)
    first = torch.load(root / "A" / "ckpt" / "checkpoint_epoch_0.pth", weights_only=True)
    assert first["it"] == 2
    assert not all(torch.equal(v, a["model_state"][k]) for k, v in first["model_state"].items())


class _Stop(Exception):
    pass


def _first_step_view(monkeypatch, root, out, *extra):
    """Run the CLI up to its first train step and return what that step
    would start from: the model state, the optimizer state, the step and
    the dataset's epoch."""
    from cpd_tpu_torch import parallel
    from cpd_tpu_torch.config import ConfigDict, cfg_from_list, cfg_from_yaml_file
    from cpd_tpu_torch.datasets.registry import build_dataset
    cfg = cfg_from_list(_sets(root), cfg_from_yaml_file(SHIPPED, ConfigDict()))
    dataset = build_dataset(cfg.DATA_CONFIG, cfg.CLASS_NAMES, True, str(root))
    seen = {}

    def make_train_step():
        def step(state, batch, generator=None):
            seen.update(model={k: v.clone() for k, v in state.model.state_dict().items()},
                        optimizer=state.optimizer.state_dict(), step=state.step,
                        epoch=dataset.epoch, points=tuple(batch["points"].shape))
            raise _Stop
        return step
    monkeypatch.setattr(parallel, "make_train_step", make_train_step)
    with pytest.raises(_Stop):
        cli.main(_argv(root, out, "--epochs", "2", *extra), dataset=dataset)
    return seen


def test_ckpt_and_pretrained_model_load_what_they_should(runs, monkeypatch, no_tensorboard):
    """``--ckpt``: weights, optimizer state and step of the file, training
    goes on at the next epoch. ``--pretrained_model``: the weights only; the
    optimizer and the step start fresh at epoch 0."""
    root, _ = runs
    ckpt = root / "A" / "ckpt" / "checkpoint_epoch_0.pth"
    payload = torch.load(ckpt, weights_only=True)
    seen = _first_step_view(monkeypatch, root, root / "C", "--ckpt", str(ckpt))
    assert seen["step"] == 2 and seen["epoch"] == 1 and seen["points"] == (2, 2048, 5)
    for k, v in payload["model_state"].items():
        assert torch.equal(seen["model"][k], v), k
    assert seen["optimizer"]["count"] == 2
    for k, st in payload["optimizer_state"]["state"].items():
        for name, v in st.items():
            assert torch.equal(seen["optimizer"]["state"][k][name], v)

    seen = _first_step_view(monkeypatch, root, root / "D", "--pretrained_model", str(ckpt))
    assert seen["step"] == 0 and seen["epoch"] == 0
    assert seen["optimizer"]["count"] == 0 and not seen["optimizer"]["state"]
    for k, v in payload["model_state"].items():
        assert torch.equal(seen["model"][k], v), k
    assert not (root / "C" / "ckpt").exists() and not (root / "D" / "ckpt").exists()


def test_eval_after_writes_result_pkl_and_takes_a_stripped_checkpoint(runs, no_tensorboard):
    """(b)'s ``--eval_after 1`` evaluated checkpoint_epoch_1 through the port's
    eval CLI: one finite record a frame in result.pkl. The same checkpoint
    stripped of its optimizer gives the same result.pkl, bit for bit."""
    root, _ = runs
    with open(root / "A" / "eval_epoch_1" / "result.pkl", "rb") as f:
        full = pickle.load(f)
    assert [a["frame_id"] for a in full] == [f"{SEQ}#{i:04d}" for i in range(N_FRAMES)]
    for a in full:
        assert np.isfinite(a["boxes_lidar"]).all() and np.isfinite(a["score"]).all()
    assert "post-train eval of epoch 1" in (root / "A" / "log_train.txt").read_text()
    stripped = strip_checkpoint(root / "B" / "ckpt" / "checkpoint_epoch_1.pth")
    out = root / "stripped_eval"
    eval_cli.main(["--cfg_file", SHIPPED, "--ckpt", str(stripped), "--device", "cpu",
                   "--workers", "2", "--output_dir", str(out), "--set", *_sets(root)])
    with open(out / "result.pkl", "rb") as f:
        again = pickle.load(f)
    assert len(again) == len(full)
    for a, b in zip(again, full):
        assert set(a) == set(b) and a["frame_id"] == b["frame_id"]
        for k in ("boxes_lidar", "score", "name", "pred_labels"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_flags_equal_the_jax_cli_plus_device():
    from tools import train as jax_cli
    argv = ["--cfg_file", SHIPPED]
    ref, port = vars(jax_cli.parse_args(argv)), vars(cli.parse_args(argv))
    assert port.pop("device") is None
    assert port == ref
    argv += ["--epochs", "3", "--debug_steps", "2", "--fix_random_seed", "--eval_after", "1"]
    ref = vars(jax_cli.parse_args(argv + ["--set", "A.B", "1"]))
    port = vars(cli.parse_args(argv + ["--device", "cpu", "--set", "A.B", "1"]))
    assert port.pop("device") == "cpu"
    assert port == ref


@pytest.mark.parametrize("extra", [[], ["--batch_size", "1", "--epochs", "3"]],
                         ids=["yaml", "flags"])
def test_batch_steps_and_total_steps_equal_the_jax_cli(sequence, monkeypatch, tmp_path, extra,
                                                       no_tensorboard):
    """On one device the JAX CLI's global batch is BATCH_SIZE_PER_GPU (or
    ``--batch_size``); both CLIs then read the same steps an epoch and build
    their optimizer for the same total steps. Each is stopped where it
    builds the optimizer: no model is initialised."""
    import jax

    import cpd_tpu.datasets
    import cpd_tpu.parallel
    from cpd_tpu import config as jconfig
    from cpd_tpu_torch import datasets, parallel
    from tools import train as jax_cli
    seen = {"jax": {}, "port": {}}

    def recording_loader(side, build):
        def build_dataloader(dataset_cfg, class_names, batch_size, **kw):
            out = build(dataset_cfg, class_names, batch_size, **kw)
            seen[side].update(batch=batch_size, steps=len(out[1]), samples=len(out[0]))
            return out
        return build_dataloader

    def stop_at_optimizer(side):
        def build(*args):
            seen[side]["total_steps"] = args[-1]
            raise _Stop
        return build

    one_device = jax.devices()[:1]
    monkeypatch.setattr(jax, "devices", lambda *a: one_device)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "jax_cache"))
    monkeypatch.setattr(cpd_tpu.datasets, "build_dataloader",
                        recording_loader("jax", cpd_tpu.datasets.build_dataloader))
    monkeypatch.setattr(cpd_tpu.parallel, "build_optimizer", stop_at_optimizer("jax"))
    monkeypatch.setattr(datasets, "build_dataloader",
                        recording_loader("port", datasets.build_dataloader))
    monkeypatch.setattr(parallel, "init_state",
                        lambda model, opt_cfg, total_steps, device=None:
                        stop_at_optimizer("port")(total_steps))
    argv = ["--cfg_file", SHIPPED, "--workers", "1", *extra, "--set", *_sets(sequence)]
    # the JAX CLI turns on JAX's persistent compilation cache: put it back after
    cache = {k: getattr(jax.config, k) for k in ("jax_compilation_cache_dir",
                                                 "jax_persistent_cache_min_compile_time_secs")}
    jconfig.cfg.clear()
    try:
        with pytest.raises(_Stop):
            jax_cli.main(["--output_dir", str(tmp_path / "jax"), *argv])
    finally:
        jconfig.cfg.clear()
        jconfig.cfg["LOCAL_RANK"] = 0
        for k, v in cache.items():
            jax.config.update(k, v)
    with pytest.raises(_Stop):
        cli.main(["--output_dir", str(tmp_path / "port"), "--device", "cpu", *argv])
    assert seen["port"] == seen["jax"]
    want_batch = 1 if extra else 4
    assert seen["port"] == {"batch": want_batch, "samples": N_FRAMES,
                            "steps": N_FRAMES // want_batch,
                            "total_steps": N_FRAMES // want_batch * (3 if extra else 20)}


def test_without_a_card_the_cli_raises_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CLI runs on it")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        cli.main(["--cfg_file", SHIPPED, "--output_dir", str(tmp_path)])
    assert not (tmp_path / "log_train.txt").exists()


def test_module_entry_point_runs_without_jax_yaml_or_cpd_tpu(sequence, tmp_path):
    argv = ["cpd_tpu_torch.tools.train"] + _argv(sequence, tmp_path / "out", "--debug_steps", "1")
    argv[argv.index("--batch_size") + 1] = "1"
    code = ("import runpy, sys, torch\n"
            "torch.set_num_threads(1)\n"
            "sys.modules['torch.utils.tensorboard'] = None\n"
            f"sys.argv = {argv!r}\n"
            "runpy.run_module('cpd_tpu_torch.tools.train', run_name='__main__')\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'yaml', 'cpd_tpu')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert (tmp_path / "out" / "ckpt" / "checkpoint_epoch_0.pth").exists()
    assert " it 1 " in (tmp_path / "out" / "log_train.txt").read_text()
