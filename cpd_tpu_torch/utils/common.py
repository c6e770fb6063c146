"""Logging, seeding, metrics and phase timing (port of
cpd_tpu/utils/common.py; parity: cpd/utils/common_utils.py). The JAX
package's compile-cache switch has no counterpart here: it turns on JAX's
persistent compilation cache."""
from __future__ import annotations

import contextlib
import json
import logging
import random
import time
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


class MetricsLogger:
    """Structured metrics: ``metrics.jsonl`` in ``out_dir`` always, one
    record ``{"step", "time", <metrics>}`` a call; TensorBoard events under
    ``out_dir/tensorboard`` too where ``torch.utils.tensorboard`` imports
    (the JAX package writes them through ``tf.summary`` where TensorFlow
    imports)."""

    def __init__(self, out_dir, enable_tb: bool = True):
        self.out_dir = Path(out_dir)
        self.out_dir.mkdir(parents=True, exist_ok=True)
        self.jsonl = open(self.out_dir / "metrics.jsonl", "a")
        self.tb = None
        if enable_tb:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                pass
            else:
                self.tb = SummaryWriter(str(self.out_dir / "tensorboard"))

    def log(self, step: int, metrics: dict):
        rec = {"step": int(step), "time": time.time()}
        rec.update({k: float(v) for k, v in metrics.items()})
        self.jsonl.write(json.dumps(rec) + "\n")
        self.jsonl.flush()
        if self.tb is not None:
            for k, v in metrics.items():
                self.tb.add_scalar(k, float(v), int(step))

    def close(self):
        self.jsonl.close()
        if self.tb is not None:
            self.tb.close()


class PhaseTimer:
    """Host seconds per named phase: ``with timer.phase("data"): ...``;
    ``summary()`` gives the mean seconds of each phase, ``last`` the seconds
    of each phase's latest run. Work the card has not finished when a phase
    ends is not in it."""

    def __init__(self):
        self.totals = {}
        self.counts = {}
        self.last = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.last[name] = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + self.last[name]
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self):
        return {k: self.totals[k] / max(self.counts[k], 1) for k in self.totals}


def timed(timer, name: str):
    """``timer.phase(name)`` of a ``PhaseTimer``, or no timing when
    ``timer`` is None."""
    return timer.phase(name) if timer is not None else contextlib.nullcontext()
