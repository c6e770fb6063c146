"""The native host library: ctypes bindings of ``src/pointcloud.cpp``.

The data layer's host functions in threaded C++ (port of cpd_tpu/native,
the same source without ``radius_neighbor_count``: PPScore's radius count
runs on the card as kernel R1, ``ops/radius.py``, or through ``cKDTree``).
The library is compiled with ``g++`` and the JAX package's flags at first
use into ``cpd_tpu_torch/_build/``, keyed by a hash of the source and the
flags, as ``ops/cuda_build.py`` keys the CUDA kernels. A failed build or
load raises: no entry point falls back to NumPy. The NumPy versions
(``*_np``) are the plain versions the tests hold the library to, for a
caller that asks for them by name. A ctypes call releases the interpreter
lock while the C++ runs, so the loader's threads and the training step do
not wait on each other there.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "src" / "pointcloud.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-pthread"]
_F32P = ctypes.POINTER(ctypes.c_float)
_I32P = ctypes.POINTER(ctypes.c_int32)
_SIGNATURES = {  # entry point: (argtypes, restype)
    "points_in_boxes_first": ([_F32P, ctypes.c_int64, ctypes.c_int64, _F32P, ctypes.c_int64,
                               _I32P], None),
    "points_in_boxes_mask": ([_F32P, ctypes.c_int64, ctypes.c_int64, _F32P, ctypes.c_int64,
                              ctypes.POINTER(ctypes.c_uint8)], None),
    "rigid_transform": ([_F32P, ctypes.c_int64, ctypes.c_int64, _F32P, _F32P, ctypes.c_int64],
                        None),
    "decode_waymo_points": ([_F32P, ctypes.c_int64, _F32P], ctypes.c_int64),
    "voxel_downsample": ([_F32P, ctypes.c_int64, ctypes.c_int64, ctypes.c_float, _I32P],
                         ctypes.c_int64),
}
_lib = None
_load_lock = threading.Lock()  # the loader's threads may ask for it at once


def library_path() -> Path:
    """The built library's path, keyed by a hash of the source and the flags."""
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libcpd_native_{digest[:12]}.so"


def _compiler() -> str:
    found = shutil.which("g++")
    if not found:
        raise RuntimeError("g++ not found: the native host library needs a C++ compiler")
    return found


def build() -> Path:
    """Compile the library unless its build exists; returns its path. The
    build goes to a temporary name and is renamed into place, so processes
    that build at once never load a partial library. Raises on failure."""
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        tmp_out = Path(tmp) / path.name
        proc = subprocess.run([_compiler(), *CXX_FLAGS, str(SOURCE), "-o", str(tmp_out)],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on {SOURCE.name} ({proc.returncode}):\n{proc.stderr}")
        os.replace(tmp_out, path)
    return path


def load():
    """The loaded library with every entry point's signature set, built
    first where it is missing."""
    global _lib
    with _load_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, (argtypes, restype) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = argtypes, restype
            _lib = lib
    return _lib


def available() -> bool:
    """Whether the library builds (where it is missing) and loads here; the
    entry points raise where it does not."""
    try:
        load()
    except (OSError, RuntimeError, subprocess.SubprocessError):
        return False
    return True


def _f32(a):
    return np.ascontiguousarray(a, dtype=np.float32)


def _rows(a, what, cols, exact=False):
    """``a`` as contiguous f32 rows of at least (``exact``: just) ``cols``
    columns; raises on another shape before a pointer reaches the C++."""
    a = _f32(a)
    if a.ndim != 2 or (a.shape[1] != cols if exact else a.shape[1] < cols):
        raise ValueError(f"{what} must be (N, {'' if exact else '>= '}{cols}), got {a.shape}")
    return a


def _ptr(a, kind=_F32P):
    return a.ctypes.data_as(kind)


def _boxes7(boxes):
    return _rows(boxes, "boxes", 7)[:, :7].copy() if len(boxes) else np.zeros((0, 7), np.float32)


def points_in_boxes_first(points: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    """(N, 3+), (M, 7) -> (N,) int32 index of the first box holding each
    point, or -1."""
    lib = load()
    points, boxes = _rows(points, "points", 3), _boxes7(boxes)
    n, m = len(points), len(boxes)
    out = np.full(n, -1, np.int32)
    if m and n:
        lib.points_in_boxes_first(_ptr(points), n, points.shape[1], _ptr(boxes), m,
                                  _ptr(out, _I32P))
    return out


def points_in_boxes_mask(points: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    """(N, 3+), (M, 7) -> (M, N) bool."""
    lib = load()
    points, boxes = _rows(points, "points", 3), _boxes7(boxes)
    n, m = len(points), len(boxes)
    out = np.zeros((m, n), np.uint8)
    if m and n:
        lib.points_in_boxes_mask(_ptr(points), n, points.shape[1], _ptr(boxes), m,
                                 _ptr(out, ctypes.POINTER(ctypes.c_uint8)))
    return out.astype(bool)


def rigid_transform(points: np.ndarray, pose: np.ndarray) -> np.ndarray:
    """(N, 3+) x (4, 4) -> (N, 3+) f32 with xyz transformed, extras copied."""
    lib = load()
    points = _rows(points, "points", 3)
    out = points.copy()
    if len(points):
        pose = _f32(pose).ravel()
        if pose.size != 16:
            raise ValueError(f"pose must be 4 x 4, got {np.shape(pose)}")
        lib.rigid_transform(_ptr(points), len(points), points.shape[1], _ptr(pose), _ptr(out),
                            out.shape[1])
    return out


def decode_waymo_points(raw: np.ndarray) -> np.ndarray:
    """(N, 6) raw [x y z intensity elongation nlz] -> (K, 5): the rows whose
    NLZ flag is -1, intensity through tanh."""
    lib = load()
    raw = _rows(raw, "raw", 6, exact=True)
    out = np.empty((len(raw), 5), np.float32)
    k = lib.decode_waymo_points(_ptr(raw), len(raw), _ptr(out)) if len(raw) else 0
    return out[:k]


def voxel_downsample(points: np.ndarray, voxel: float = 0.1) -> np.ndarray:
    """The first point of each voxel of a grid anchored at the origin, in
    input order (f32 rows)."""
    lib = load()
    points = _rows(points, "points", 3)
    idx = np.empty(len(points), np.int32)
    k = (lib.voxel_downsample(_ptr(points), len(points), points.shape[1], voxel,
                              _ptr(idx, _I32P)) if len(points) else 0)
    return points[idx[:k]]


# ---- the plain versions: NumPy, the same function, for tests and by name ----

def points_in_boxes_mask_np(points, boxes):
    """NumPy (M, N) mask (``datasets.box_np.points_in_boxes_mask_np``)."""
    from ..datasets.box_np import points_in_boxes_mask_np as mask_np

    return mask_np(_f32(points), _boxes7(boxes))


def points_in_boxes_first_np(points, boxes):
    mask = points_in_boxes_mask_np(points, boxes)
    if not len(mask):
        return np.full(len(points), -1, np.int32)
    return np.where(mask.any(axis=0), mask.argmax(axis=0), -1).astype(np.int32)


def rigid_transform_np(points, pose):
    """xyz through the pose in f32, each coordinate summed in the C++ order."""
    points = _f32(points)
    pose = _f32(pose)
    out = points.copy()
    x, y, z = points[:, 0], points[:, 1], points[:, 2]
    for r in range(3):
        out[:, r] = pose[r, 0] * x + pose[r, 1] * y + pose[r, 2] * z + pose[r, 3]
    return out


def decode_waymo_points_np(raw):
    """The intensity's tanh in f64, rounded once (libm's ``tanhf`` is within
    2 f32 ulp of it)."""
    raw = _f32(raw)
    pts = raw[raw[:, 5] == -1][:, :5].copy()
    pts[:, 3] = np.tanh(pts[:, 3].astype(np.float64))
    return pts


def voxel_downsample_np(points, voxel: float = 0.1):
    points = _f32(points)
    inv = 1.0 / float(np.float32(voxel))
    g = np.floor(points[:, :3].astype(np.float64) * inv).astype(np.int64) + (1 << 20)
    keys = (g[:, 0] << 42) | (g[:, 1] << 21) | g[:, 2]
    _, first = np.unique(keys, return_index=True)
    return points[np.sort(first)]
