"""The port's builder CLI (``python -m cpd_tpu_torch.datasets.waymo_unsupervised``)
in a subprocess, ``--device cpu`` (kernels R1 and R2 through their plain
versions), on two tiny written sequences: PPScore in a pool of two ``spawn``
workers, the labels in one process. Its files equal those of the builder's
functions called in this process (which ``test_torch_port_factory.py`` holds
to the JAX package's).
"""
import os
import pickle
import subprocess
import sys

import numpy as np

from cpd_tpu_torch.datasets import waymo_unsupervised as pwu
from cpd_tpu_torch.utils.synthetic import write_waymo_sequence
from cpd_tpu_torch.utils.yaml_subset import load_file
from tests.test_torch_port_factory import REPO, YAML, _assert_pickles_equal, _sequence
from tests.test_torch_port_ppscore import one_torch_thread  # noqa: F401


def _run_cli(args, timeout=240):
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-m", "cpd_tpu_torch.datasets.waymo_unsupervised",
                           *args], cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def test_builder_cli_in_a_subprocess(tmp_path):
    """``--func create_ppscore --workers 2`` (a spawn pool) then ``--func
    create_outline_boxes --workers 1``, both ``--device cpu``, on two
    sequences of 10 tiny frames: the same files as the functions called in
    this process."""
    for k, name in enumerate(("segment-a", "segment-b")):
        frames, poses = _sequence(seed=10 + k, n_frames=10, n_points=1500)
        for side in ("cli", "here"):
            write_waymo_sequence(tmp_path / side, name, frames, poses=poses, labels=False)
    cli_root = tmp_path / "cli" / "waymo_processed_data"
    here_root = tmp_path / "here" / "waymo_processed_data"
    base = ["--cfg_file", str(YAML), "--processed_data_path", str(cli_root), "--device", "cpu"]
    out = _run_cli(["--func", "create_ppscore", *base, "--workers", "2"])
    assert "create_ppscore" in out
    out = _run_cli(["--func", "create_outline_boxes", *base, "--workers", "1"])
    assert "cluster" in out and "refine_size" in out  # the stages' seconds
    cfg = load_file(YAML)
    pwu.create_ppscore(here_root, ["segment-a", "segment-b"], workers=1, device="cpu")
    pwu.create_outline_boxes(here_root, ["segment-a", "segment-b"], cfg, workers=1,
                             device="cpu")
    for name in ("segment-a", "segment-b"):
        for i in range(10):
            np.testing.assert_array_equal(np.load(cli_root / name / "ppscore" / f"{i:04d}.npy"),
                                          np.load(here_root / name / "ppscore" / f"{i:04d}.npy"))
        for tag in ("C_PROTO", "MFCF_CSS_proto"):
            with open(cli_root / name / f"{name}_outline_{tag}.pkl", "rb") as f:
                got = pickle.load(f)
            with open(here_root / name / f"{name}_outline_{tag}.pkl", "rb") as f:
                want = pickle.load(f)
            _assert_pickles_equal(got, want)
