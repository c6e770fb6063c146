"""The port's AP code (cpd_tpu_torch.evaluation) against the JAX package's,
on the CPU, on the annotations of tests/test_eval_and_waymo_ds.py: the same
NumPy, so every value is equal (1e-6 for floats), keys exact."""
import numpy as np
import pytest

from cpd_tpu import evaluation as jeval
from cpd_tpu.evaluation import ap as jap
from cpd_tpu_torch import evaluation
from cpd_tpu_torch.evaluation import ap
from tests.test_eval_and_waymo_ds import _mk_annos


def _annos(kind):
    if kind == "perfect":
        return _mk_annos(perfect=True)
    if kind == "half":
        return _mk_annos(perfect=False)
    dets, gts = _mk_annos(n_frames=5, n_obj=6, perfect=True, seed=3)
    rng = np.random.default_rng(4)
    for d, g in zip(dets, gts):
        d["boxes_lidar"] = d["boxes_lidar"] + rng.normal(0, 0.3, d["boxes_lidar"].shape).astype(
            np.float32)
        d["score"] = rng.uniform(0.1, 1.0, len(d["score"]))
        g["num_points_in_gt"] = rng.integers(1, 20, len(g["name"]))
        g["difficulty"] = rng.integers(0, 3, len(g["name"]))
        g["name"] = np.asarray(["Vehicle", "Pedestrian", "Cyclist"])[rng.integers(0, 3, 6)]
        d["name"] = g["name"].copy()
    return dets, gts


KINDS = ["perfect", "half", "noisy"]
CLASSES = ["Vehicle", "Pedestrian", "Cyclist"]


def _same_results(port, ref):
    assert port[0] == ref[0]
    assert list(port[1]) == list(ref[1])
    np.testing.assert_allclose([port[1][k] for k in ref[1]], [ref[1][k] for k in ref[1]],
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("matcher", ["hungarian", "greedy"])
def test_waymo_style_eval_equals_jax(kind, matcher):
    dets, gts = _annos(kind)
    _same_results(ap.waymo_style_eval(dets, gts, CLASSES, matcher=matcher),
                  jap.waymo_style_eval(dets, gts, CLASSES, matcher=matcher))


@pytest.mark.parametrize("kind", KINDS)
def test_waymo_bev_eval_equals_jax(kind):
    dets, gts = _annos(kind)
    _same_results(ap.waymo_bev_eval(dets, gts, CLASSES), jap.waymo_bev_eval(dets, gts, CLASSES))


@pytest.mark.parametrize("kind", KINDS)
def test_kitti_style_eval_equals_jax(kind):
    dets, gts = _annos(kind)
    _same_results(ap.kitti_style_eval(dets, gts, CLASSES, n_points=(40, 11)),
                  jap.kitti_style_eval(dets, gts, CLASSES, n_points=(40, 11)))


@pytest.mark.parametrize("kind", KINDS)
def test_recall_stats_equal_jax(kind):
    dets, gts = _annos(kind)
    port, ref = ap.recall_stats(dets, gts), jap.recall_stats(dets, gts)
    assert port == ref and port["gt_count"] > 0


def test_package_exports_and_official_metric():
    assert evaluation.waymo_style_eval is ap.waymo_style_eval
    assert evaluation.recall_stats is ap.recall_stats
    assert evaluation.official_available() is False
    assert jeval.official_available() is False  # the same NumPy path scores on both sides
