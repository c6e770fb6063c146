"""The port's scene plotter (``cpd_tpu_torch.tools.visual_utils``) against
the JAX package's tool (``tools/visual_utils.py``): the same points and
boxes give PNGs of equal pixels, for the BEV plot and the 3-D render. Skips
only where matplotlib cannot be imported."""
import numpy as np
import pytest

pytest.importorskip("matplotlib")

from cpd_tpu_torch.tools import visual_utils  # noqa: E402
from tools import visual_utils as jax_visual_utils  # noqa: E402


def _scene():
    rng = np.random.default_rng(0)
    pts = np.concatenate([rng.uniform(-30, 30, (3000, 2)), rng.uniform(-2, 3, (3000, 1)),
                          rng.random((3000, 1))], -1).astype(np.float32)
    boxes = np.concatenate([rng.uniform(-25, 25, (6, 2)), rng.uniform(-1, 0, (6, 1)),
                            rng.uniform(1, 5, (6, 3)), rng.uniform(-np.pi, np.pi, (6, 1))],
                           -1).astype(np.float32)
    return pts, boxes[:3], boxes[3:], rng.random(3).astype(np.float32), np.array([1, 2, 3])


def _pixels(path):
    import matplotlib.image

    return matplotlib.image.imread(str(path))


@pytest.mark.parametrize("name", ["draw_scenes", "draw_scenes_3d"])
def test_plot_pixels_equal_the_jax_tool(name, tmp_path):
    pts, gt, pred, scores, labels = _scene()
    kwargs = dict(gt_boxes=gt, ref_boxes=pred, bound=32.0)
    if name == "draw_scenes_3d":
        kwargs.update(ref_scores=scores, ref_labels=labels)
    port = getattr(visual_utils, name)(pts, out_path=str(tmp_path / "port.png"), **kwargs)
    ref = getattr(jax_visual_utils, name)(pts, out_path=str(tmp_path / "jax.png"), **kwargs)
    got, want = _pixels(port), _pixels(ref)
    assert got.shape == want.shape and got.shape[0] > 500
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got.reshape(-1, got.shape[-1]), axis=0)) > 10
