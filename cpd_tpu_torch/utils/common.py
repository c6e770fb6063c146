"""Logging and seeding (port of cpd_tpu/utils/common.py; parity:
cpd/utils/common_utils.py). The JAX package's compile-cache switch has no
counterpart here: it turns on JAX's persistent compilation cache."""
from __future__ import annotations

import logging
import random
from pathlib import Path

import numpy as np
import torch


def create_logger(log_file=None, rank: int = 0, name: str = "cpd_tpu_torch"):
    """File+console logger, rank-0 only to console (common_utils.py:85)."""
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO if rank == 0 else logging.WARNING)
    logger.propagate = False
    fmt = logging.Formatter("%(asctime)s  %(levelname)5s  %(message)s")
    if not logger.handlers:
        console = logging.StreamHandler()
        console.setFormatter(fmt)
        logger.addHandler(console)
    if log_file is not None:
        # one log file at a time: a later call (another run in the same
        # process) moves the logger to its own file
        path = str(Path(log_file).absolute())
        for h in [h for h in logger.handlers if isinstance(h, logging.FileHandler)]:
            if h.baseFilename != path:
                logger.removeHandler(h)
                h.close()
        if not any(isinstance(h, logging.FileHandler) for h in logger.handlers):
            fh = logging.FileHandler(path)
            fh.setFormatter(fmt)
            logger.addHandler(fh)
    return logger


def set_random_seed(seed: int = 666):
    """Seed the host RNGs (common_utils.py:101) and torch's (every device)."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return seed
