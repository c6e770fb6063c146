"""Detection metrics (port of cpd_tpu/evaluation): the NumPy AP of ``ap``."""
from .ap import (average_precision, kitti_style_eval, match_frame,  # noqa: F401
                 recall_stats, waymo_style_eval)


def official_available() -> bool:
    """False: the adapter to the official Waymo metric (the JAX package's
    waymo_official.py) needs tensorflow and waymo_open_dataset, which the
    card's machine does not have; it is not ported yet (ROADMAP)."""
    return False
