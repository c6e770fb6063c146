"""The port's training and evaluation CLIs on 2 gloo ranks on the CPU.

The cut of tests/test_torch_port_cli_train.py (the shipped yaml through
``--set``, 4 written frames with prototype banks), with ``--batch_size 2``
now the GLOBAL batch: one sample a rank, two steps an epoch. The ranks are
spawned processes in a gloo group over a ``file://`` store
(``tests/torch_dist_ranks.py``), each CLI call joining that group as it
would join ``torchrun``'s. In the ranks, one after the other: A (a)
``--epochs 2 --debug_steps 2``, A (b) ``--epochs 2 --eval_after 1``
(auto-resumed, then the eval CLI on both ranks), B ``--epochs 2``, the eval
CLI with seeded weights, and ``--batch_size 3``, which two ranks cannot
share. Gates: rank 0 alone writes; the ranks end with the same weights; A's
checkpoint_epoch_1 equals B's bit for bit; the merged result.pkl is in
dataset order and equals one process's within the tier of
tests/test_torch_port_cli_eval.py; a batch of 3 raises on every rank.
"""
import json
import pickle

import numpy as np
import pytest
import torch

from cpd_tpu_torch.config import ConfigDict, cfg_from_list, cfg_from_yaml_file
from cpd_tpu_torch.datasets import build_dataloader
from cpd_tpu_torch.datasets.registry import build_dataset
from cpd_tpu_torch.tools import test as eval_cli
from tests.test_torch_port_build_network import pair_detections
from tests.test_torch_port_cli_train import (N_FRAMES, SEQ, SHIPPED, _argv, _equal_payloads,
                                             _sets, _write_sequence)
from tests.torch_dist_ranks import cli_runs, run_ranks

CALLS = ("A (a)", "A (b)", "B", "eval", "batch 3")


@pytest.fixture(scope="module")
def sequence(tmp_path_factory):
    root = tmp_path_factory.mktemp("waymo_dist")
    _write_sequence(root)
    return root


@pytest.fixture(scope="module")
def dist_runs(sequence):
    """The five calls of the module docstring on 2 ranks; -> (root, each
    rank's outcome of each call)."""
    root = sequence
    argvs = [
        ("train", _argv(root, root / "A", "--epochs", "2", "--debug_steps", "2",
                        "--fix_random_seed", "--log_every", "1")),
        ("train", _argv(root, root / "A", "--epochs", "2", "--eval_after", "1")),
        ("train", _argv(root, root / "B", "--epochs", "2", "--log_every", "2")),
        ("test", _argv(root, root / "E2")),
        ("train", _argv(root, root / "C", "--epochs", "2")[:2] + ["--batch_size", "3"]
         + _argv(root, root / "C", "--epochs", "2")[4:]),
    ]
    outs = run_ranks(cli_runs, 2, root / "ranks", argvs)
    return root, [dict(zip(CALLS, o)) for o in outs]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_rank_zero_alone_writes(dist_runs):
    """One log line, one metrics record and one checkpoint file per event:
    rank 1 wrote none of them (no tensorboard: it is hidden). The steps and
    the ranks' weights agree."""
    root, outs = dist_runs
    assert [r["step"] for r in _records(root / "A" / "metrics.jsonl")] == [1, 2]
    assert [r["step"] for r in _records(root / "B" / "metrics.jsonl")] == [2, 4]
    log = (root / "A" / "log_train.txt").read_text()
    assert log.count(" it 1 ") == 1 and log.count(" it 2 ") == 1
    assert log.count("auto-resumed from epoch 0") == 1 and "ranks: 2  backend: gloo" in log
    assert sorted(p.name for p in (root / "A").iterdir()) == [
        "ckpt", "eval_epoch_1", "log_train.txt", "metrics.jsonl"]
    assert sorted(p.name for p in (root / "A" / "ckpt").iterdir()) == [
        "checkpoint_epoch_0.pth", "checkpoint_epoch_1.pth"]
    for run, step in (("A (a)", 2), ("A (b)", 4), ("B", 4)):
        a, b = (o[run] for o in outs)
        assert a["step"] == b["step"] == a["count"] == step
        assert a["checksum"] == b["checksum"], run
    for r in _records(root / "A" / "metrics.jsonl"):
        assert all(np.isfinite(v) for v in r.values()) and r["skipped_nonfinite"] == 0.0


def test_resume_on_two_ranks_is_bit_equal(dist_runs):
    root, _ = dist_runs
    load = lambda side: torch.load(root / side / "ckpt" / "checkpoint_epoch_1.pth",  # noqa: E731
                                   weights_only=True)
    a, b = load("A"), load("B")
    assert a["it"] == 4 and a["optimizer_state"]["count"] == 4
    _equal_payloads(a, b)


def test_batch_that_the_ranks_cannot_share_raises(dist_runs):
    _, outs = dist_runs
    for o in outs:
        assert o["batch 3"] == {"error": "ValueError: the global batch 3 does not divide over 2 "
                                         "ranks"}


def test_merged_eval_equals_one_process(dist_runs):
    """The eval CLI on 2 ranks (seeded weights): rank 0's result.pkl holds
    every frame once, in dataset order; its detections are one process's
    (batch 2) within 1e-4 of the scale for 95% and 0.1 m / 0.01 for all.
    ``--eval_after`` on 2 ranks wrote its own."""
    root, outs = dist_runs
    assert outs[1]["eval"] == {"result": {}} and "recall_0.7" in outs[0]["eval"]["result"]
    one = eval_cli.main(_argv(root, root / "E1"))
    assert set(one) == set(outs[0]["eval"]["result"])
    ids = [f"{SEQ}#{i:04d}" for i in range(N_FRAMES)]
    res = {}
    for side in ("E1", "E2", "A/eval_epoch_1"):
        with open(root / side / "result.pkl", "rb") as f:
            res[side] = pickle.load(f)
        assert [a["frame_id"] for a in res[side]] == ids, side
    assert sorted(p.name for p in (root / "E2" / "tmpdir").iterdir()) == [
        "result_part_0.pkl", "result_part_1.pkl"]
    box_scale = max(max(np.abs(a["boxes_lidar"]).max(initial=0.0) for a in res["E1"]), 1e-3)
    score_scale = max(max(np.abs(a["score"]).max(initial=0.0) for a in res["E1"]), 1e-3)
    n = tight = 0
    for a, b in zip(res["E2"], res["E1"]):
        valid = lambda x: {"pred_boxes": x["boxes_lidar"].reshape(-1, 7),  # noqa: E731
                           "pred_valid": np.ones(len(x["score"]), bool)}
        p, r, _ = pair_detections(valid(a), valid(b))
        np.testing.assert_array_equal(a["name"][p], b["name"][r])
        box_err = np.abs(a["boxes_lidar"][p] - b["boxes_lidar"][r]).max(-1, initial=0.0)
        score_err = np.abs(a["score"][p] - b["score"][r])
        assert box_err.max(initial=0.0) <= 0.1 and score_err.max(initial=0.0) <= 0.01
        tight += int(((box_err <= 1e-4 * box_scale) & (score_err <= 1e-4 * score_scale)).sum())
        n += len(p)
    assert n > 0 and tight >= 0.95 * n, (tight, n)


def test_rank_shards_are_one_process_batches(sequence):
    """The written dataset through the training loader: at every step the
    ranks' samples (1 each) are the samples of one process's batch of 2,
    augmented alike, in epochs 0 and 1."""
    root = sequence
    cfg = cfg_from_list(_sets(root), cfg_from_yaml_file(SHIPPED, ConfigDict()))
    dataset = build_dataset(cfg.DATA_CONFIG, cfg.CLASS_NAMES, True, str(root))

    def batches(world, rank, size, epoch):
        _, loader, _ = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, size, workers=1,
                                        training=True, seed=666, world_size=world, rank=rank,
                                        dataset=dataset)
        loader.set_epoch(epoch)
        dataset.set_epoch(epoch)
        return list(loader)

    for epoch in (0, 1):
        whole = batches(1, 0, 2, epoch)
        parts = [batches(2, r, 1, epoch) for r in range(2)]
        assert len(whole) == len(parts[0]) == len(parts[1]) == N_FRAMES // 2
        for i, b in enumerate(whole):
            ids = list(b["frame_id"])
            for r in range(2):
                one = parts[r][i]
                j = ids.index(one["frame_id"][0])
                for k in ("points", "points1", "gt_boxes", "css_score"):
                    np.testing.assert_array_equal(one[k][0], b[k][j], err_msg=k)
            assert sorted(parts[0][i]["frame_id"] + parts[1][i]["frame_id"]) == sorted(ids)
