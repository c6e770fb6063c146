"""Build and binding of the package's CUDA kernels.

Every kernel is one source under ``csrc/`` with a plain C entry point
``cpd_<name>``. ``build`` compiles the sources with ``nvcc`` for ``sm_90a``
into shared libraries (one ``nvcc`` process per source, all started
together), keyed by a hash of the source and the flags, into the
``cpd_tpu_torch/_build/`` directory; ``load`` builds what is missing at first
use and returns the entry point as a ``ctypes`` function. A build or load
that fails raises: no caller falls back to another version.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[1]
KERNELS = ("gather_gemm", "gather_gemm_dw", "gather_gemm_flat", "gather_gemm_per_tap",
           "lane_gather_gemm", "lane_gather", "radius_count", "dbscan")
SOURCES = {name: _PKG / "csrc" / f"{name}.cu" for name in KERNELS}
# headers that the sources include (part of every library's key)
HEADERS = (_PKG / "csrc" / "gather_common.cuh", _PKG / "csrc" / "lane_common.cuh")
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]
# dtype codes of the C entry points
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_libs = {}
build_log = {}  # per source, what nvcc printed in this process's build


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return str(path)


def library_path(name: str) -> Path:
    """The built library's path, keyed by a hash of the source, the headers
    and the flags."""
    digest = hashlib.sha256(SOURCES[name].read_bytes() + " ".join(NVCC_FLAGS).encode())
    for header in HEADERS:
        digest.update(header.read_bytes())
    return BUILD_DIR / f"libcpd_{name}_{digest.hexdigest()[:12]}.so"


def build(verbose: bool = False) -> float:
    """Compile every kernel library whose build does not exist yet, one nvcc
    process per source, all started together. Returns the seconds spent
    compiling (0.0 when every build was reused). With ``verbose`` ptxas
    reports every kernel's resources (``-Xptxas -v``) into ``build_log``,
    which ``kernel_resources`` reads."""
    todo = [name for name in SOURCES if not library_path(name).exists()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for name in todo:
            tmp_out = Path(tmp) / library_path(name).name
            cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
                   "-o", str(tmp_out), str(SOURCES[name])]
            procs.append((name, tmp_out, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        failures = []
        for name, tmp_out, proc in procs:
            _, err = proc.communicate()
            if proc.returncode != 0:
                failures.append(f"nvcc failed on {SOURCES[name].name} ({proc.returncode}):\n{err}")
                continue
            build_log[name] = err
            os.replace(tmp_out, library_path(name))  # atomic: never a partial library
        if failures:
            raise RuntimeError("\n".join(failures))
    return time.perf_counter() - t0


def kernel_resources(name: str):
    """[(mangled kernel name, registers a thread, bytes spilled, static
    shared memory bytes)] of source ``name``, from the ptxas report of a
    ``build(verbose=True)`` made by this process."""
    pattern = re.compile(
        r"Function properties for (\S+)\n\s*\d+ bytes stack frame, (\d+) bytes spill stores"
        r"[^\n]*\nptxas info\s*: Used (\d+) registers(?:[^\n]*?, (\d+) bytes smem)?")
    return [(m[1], int(m[3]), int(m[2]), int(m[4] or 0))
            for m in pattern.finditer(build_log.get(name, ""))]


def load(name: str, argtypes, symbol: str | None = None):
    """The C entry point ``symbol`` (default ``cpd_<name>``) of kernel
    library ``name`` with ``argtypes`` set, building every missing library
    first."""
    symbol = symbol or f"cpd_{name}"
    if symbol not in _libs:
        build()
        fn = getattr(ctypes.CDLL(str(library_path(name))), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _libs[symbol] = fn
    return _libs[symbol]


def on_cuda(named_tensors) -> bool:
    """False for CPU operands, True for CUDA ones (which must be contiguous
    and on one card); raises on mixed or other devices."""
    devices = {t.device for _, t in named_tensors}
    if len(devices) != 1:
        raise ValueError(f"all operands must be on one device, got {devices}")
    device = devices.pop()
    if device.type == "cpu":
        return False
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    for name, t in named_tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return True
