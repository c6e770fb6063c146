"""Committed JAX references of the port's heaviest parity tests.

The JAX package is frozen and each reference is a fixed function of seeded
numpy inputs, so the tier-1 tests read what the JAX side computed from a
compressed ``<name>.npz`` beside this file and compute only the port live.
Each file has a test marked ``slow`` that recomputes it from live JAX and
holds it to the committed file: integers, booleans and strings exactly,
floats within 1e-6 of each array's scale (XLA:CPU on another host may differ
by an ulp). To rewrite the files after a change to the reference side:

    CPD_WRITE_TORCH_PORT_REFS=1 JAX_PLATFORMS=cpu python -m pytest tests/ -m slow -k regenerated

A tree is nested dicts (string keys) and lists of arrays, numbers and
strings; it is stored flat, one array per leaf, under its path (a bfloat16
leaf as its bits, under its path and ``BF16``).
"""
import os
from pathlib import Path

import numpy as np
import pytest
import torch

REF_DIR = Path(__file__).resolve().parent
WRITE_ENV = "CPD_WRITE_TORCH_PORT_REFS"
SEP = "::"
BF16 = "%bf16"
FLOAT_TOL = 1e-6


def _bf16():
    import ml_dtypes
    return np.dtype(ml_dtypes.bfloat16)


def flatten(tree, prefix=""):
    """{path: array} of ``tree``; list items are ``#i`` path parts."""
    if isinstance(tree, dict):
        items = [(str(k), v) for k, v in tree.items()]
        assert all(isinstance(k, str) and SEP not in k and not k.startswith("#")
                   for k in tree), list(tree)
    elif isinstance(tree, (list, tuple)):
        items = [(f"#{i}", v) for i, v in enumerate(tree)]
    else:
        arr = np.asarray(tree)
        if arr.dtype == _bf16():
            return {prefix + BF16: arr.view(np.uint16)}
        assert arr.dtype.kind in "biufU", (prefix, arr.dtype)
        return {prefix: arr}
    assert items, f"an empty container at {prefix!r} cannot be stored"
    out = {}
    for k, v in items:
        out.update(flatten(v, f"{prefix}{SEP}{k}" if prefix else k))
    return out


def unflatten(flat):
    root = {}
    for path, arr in flat.items():
        if path.endswith(BF16):
            path, arr = path[:-len(BF16)], arr.view(_bf16())
        parts = path.split(SEP)
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr[()] if arr.ndim == 0 else arr
    return _lists(root)


def _lists(node):
    if not isinstance(node, dict):
        return node
    if all(k.startswith("#") for k in node):
        return [_lists(node[f"#{i}"]) for i in range(len(node))]
    return {k: _lists(v) for k, v in node.items()}


def path(name):
    return REF_DIR / f"{name}.npz"


def load(name):
    """The committed reference ``name`` as a tree."""
    with np.load(path(name), allow_pickle=False) as data:
        return unflatten({k: data[k] for k in data.files})


def save(name, tree):
    np.savez_compressed(path(name), **flatten(tree))


def assert_regenerated(name, tree):
    """``tree``, recomputed from live JAX, equals the committed reference
    (or replaces it where ``CPD_WRITE_TORCH_PORT_REFS=1``)."""
    if os.environ.get(WRITE_ENV) == "1":
        save(name, tree)
    live = flatten(tree)
    with np.load(path(name), allow_pickle=False) as data:
        stored = {k: data[k] for k in data.files}
    assert set(live) == set(stored), sorted(set(live) ^ set(stored))
    bad = []
    for key, want in stored.items():
        got = live[key]
        if key.endswith(BF16):
            got, want = (a.view(_bf16()).astype(np.float32) for a in (got, want))
        if got.shape != want.shape or got.dtype != want.dtype:
            bad.append(f"{key}: {got.dtype}{got.shape} against {want.dtype}{want.shape}")
        elif want.dtype.kind == "f":
            nan = np.isnan(want)
            scale = float(np.abs(want[~nan]).max()) if (~nan).any() else 0.0
            err = float(np.abs(got[~nan] - want[~nan]).max()) if (~nan).any() else 0.0
            if not np.array_equal(np.isnan(got), nan) or err > FLOAT_TOL * max(scale, 1e-30):
                bad.append(f"{key}: max error {err} at scale {scale}")
        elif not np.array_equal(got, want):
            bad.append(f"{key}: differs")
    assert not bad, "\n".join(bad)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread in each test module that imports this fixture:
    beside the other test workers, torch's threads wait on busy cores
    (tests/test_torch_port_cli_train.py's default thread count once cost it
    751 worker seconds against 60 alone)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
