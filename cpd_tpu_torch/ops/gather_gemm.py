"""Kernel A1: fused masked im2col gather + GEMM (the sparse-conv forward).

Replaces the TPU kernel ``cpd_tpu/ops/pallas_conv.py::gather_gemm``. The CUDA
source is ``csrc/gather_gemm.cu`` (its header says what bounds the kernel on
an H100 and what the design does about it). It is compiled with ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface at first use, into
``cpd_tpu_torch/_build/``, and called through ``ctypes`` on PyTorch's current
stream.

``gather_gemm`` launches the kernel for CUDA tensors and raises on anything
the kernel does not take; for CPU tensors it computes the plain version,
``gather_gemm_reference``. ``gather_gemm.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "gather_gemm.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the gather-GEMM kernel needs the CUDA toolkit")
    return str(path)


def library_path() -> Path:
    """The built library's path, keyed by a hash of the source and flags."""
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libcpd_gather_gemm_{digest.hexdigest()[:12]}.so"


def build(verbose: bool = False) -> float:
    """Compile the kernel library unless this source's build exists.
    Returns the seconds spent compiling (0.0 when the build was reused)."""
    out = library_path()
    if out.exists():
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        tmp_out = Path(tmp) / out.name
        cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", str(tmp_out), str(SOURCE)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
        if verbose:
            print(proc.stderr, end="")
        os.replace(tmp_out, out)  # atomic: a reader never sees a partial library
    return time.perf_counter() - t0


def _load():
    global _lib
    if _lib is None:
        build()
        lib = ctypes.CDLL(str(library_path()))
        fn = lib.cpd_gather_gemm
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def gather_gemm_reference(table, idx, found, w_flat, out_dtype=torch.float32):
    """Plain PyTorch version of the kernel: gather, where, einsum, in f32.

    table (B, V, Cin); idx/found (B, N, K); w_flat (K*Cin, Cout)
    -> (B, N, Cout) in ``out_dtype``."""
    b, n, k = idx.shape
    cin = table.shape[-1]
    safe = torch.where(found, idx.long(), 0)
    g = torch.gather(table.float(), 1,
                     safe.reshape(b, n * k, 1).expand(-1, -1, cin)).reshape(b, n, k, cin)
    g = torch.where(found[..., None], g, 0.0)
    w = w_flat.float().reshape(k, cin, -1)
    return torch.einsum("bnkc,kcd->bnd", g, w).to(out_dtype)


def _check(table, idx, found, w_flat, out_dtype):
    if table.dim() != 3 or idx.dim() != 3 or found.shape != idx.shape:
        raise ValueError(f"want table (B,V,Cin), idx/found (B,N,K); got "
                         f"{tuple(table.shape)}, {tuple(idx.shape)}, {tuple(found.shape)}")
    b, v, cin = table.shape
    k = idx.shape[-1]
    if idx.shape[0] != b or w_flat.dim() != 2 or w_flat.shape[0] != k * cin:
        raise ValueError(f"shape mismatch: table {tuple(table.shape)}, idx "
                         f"{tuple(idx.shape)}, w_flat {tuple(w_flat.shape)}")
    if table.dtype not in _DTYPE_CODES or w_flat.dtype != table.dtype:
        raise TypeError(f"table/w must share float32 or bfloat16, got "
                        f"{table.dtype}/{w_flat.dtype}")
    if out_dtype not in _DTYPE_CODES:
        raise TypeError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    if idx.dtype != torch.int32 or found.dtype != torch.bool:
        raise TypeError(f"idx must be int32 and found bool, got {idx.dtype}/{found.dtype}")
    if max(b * v * cin, b * idx.shape[1] * max(k, w_flat.shape[1])) >= 2**31:
        raise ValueError("tensor too large for the kernel's 32-bit row indices")


def gather_gemm(table, idx, found, w_flat, out_dtype=torch.float32):
    """out[b, n] = sum_k found[b, n, k] * table[b, idx[b, n, k]] @ W[k], with
    W = w_flat.reshape(K, Cin, Cout); f32 accumulation, rounded once to
    ``out_dtype``. CUDA tensors run kernel A1; CPU tensors the plain version."""
    _check(table, idx, found, w_flat, out_dtype)
    devices = {t.device for t in (table, idx, found, w_flat)}
    if len(devices) != 1:
        raise ValueError(f"all operands must be on one device, got {devices}")
    if table.device.type == "cpu":
        return gather_gemm_reference(table, idx, found, w_flat, out_dtype)
    if table.device.type != "cuda":
        raise ValueError(f"unsupported device {table.device}")
    for name, t in (("table", table), ("idx", idx), ("found", found), ("w_flat", w_flat)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    lib = _load()
    b, v, cin = table.shape
    n, k = idx.shape[1:]
    cout = w_flat.shape[1]
    out = torch.empty((b, n, cout), dtype=out_dtype, device=table.device)
    with torch.cuda.device(table.device):  # launch on the operands' card
        err = lib.cpd_gather_gemm(
            table.data_ptr(), idx.data_ptr(), found.data_ptr(), w_flat.data_ptr(),
            out.data_ptr(), b, v, n, k, cin, cout, _DTYPE_CODES[table.dtype],
            _DTYPE_CODES[out_dtype], torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"gather_gemm kernel launch failed: CUDA error {err}")
    gather_gemm.launches += 1
    return out


gather_gemm.launches = 0
