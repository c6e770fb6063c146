"""Kernels A1 and A2: the fused gather-GEMM of the sparse convolution.

* A1, ``gather_gemm``: masked im2col gather + GEMM. It is the forward of
  every sparse conv and, launched on other operands (dY as the table, the
  transpose rulebook, ``W^T`` per tap as ``(K*Cout, Cin)``), also its input
  gradient dX. Replaces the TPU kernel
  ``cpd_tpu/ops/pallas_conv.py::gather_gemm``; source ``csrc/gather_gemm.cu``.
* A2, ``gather_gemm_dw``: the weight gradient
  ``dW[k] = sum_rows found ? X[idx]^T dY : 0``. Replaces the TPU kernel
  ``cpd_tpu/ops/pallas_conv.py::gather_gemm_dw``; source
  ``csrc/gather_gemm_dw.cu``. The TPU kernel adds every row tile into one
  resident output block across a sequential grid; blocks on a GPU run in no
  order, so A2 writes per-chunk partial sums into scratch that this wrapper
  allocates and reduces them in a second, fixed-order pass: no float atomics,
  the same bits from run to run.

Each source's header says what bounds its kernel on an H100 and what the
design does about it. Both are compiled with ``nvcc`` for ``sm_90a`` into
shared libraries with a plain C interface at first use (one ``nvcc`` process
per source, started together), into ``cpd_tpu_torch/_build/``, and called
through ``ctypes`` on PyTorch's current stream.

A wrapper launches its kernel for CUDA tensors and raises on anything the
kernel does not take; for CPU tensors it computes the plain version
(``gather_gemm_reference``, ``gather_gemm_dw_reference``).
``gather_gemm.launches`` and ``gather_gemm_dw.launches`` count kernel launches.
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
SOURCES = {"gather_gemm": _PKG / "csrc" / "gather_gemm.cu",
           "gather_gemm_dw": _PKG / "csrc" / "gather_gemm_dw.cu"}
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]
# rows of (B*N) that one block of A2 sums before it writes its partial tile
DW_ROWS_PER_CHUNK = 2048
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = {
    "gather_gemm": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p],
    "gather_gemm_dw": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p],
}
_libs = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the gather-GEMM kernel needs the CUDA toolkit")
    return str(path)


def library_path(name: str) -> Path:
    """The built library's path, keyed by a hash of the source and flags."""
    digest = hashlib.sha256(SOURCES[name].read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libcpd_{name}_{digest.hexdigest()[:12]}.so"


def build(verbose: bool = False) -> float:
    """Compile every kernel library whose build does not exist yet, one nvcc
    process per source, all started together. Returns the seconds spent
    compiling (0.0 when every build was reused)."""
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
            if verbose:
                print(err, end="")
            os.replace(tmp_out, library_path(name))  # atomic: never a partial library
        if failures:
            raise RuntimeError("\n".join(failures))
    return time.perf_counter() - t0


def _load(name: str):
    if name not in _libs:
        build()
        fn = getattr(ctypes.CDLL(str(library_path(name))), f"cpd_{name}")
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        _libs[name] = fn
    return _libs[name]


def _gather_rows(table, idx, found):
    """(B, N, K, Cin) f32 im2col: table rows at idx, zero where not found."""
    b, n, k = idx.shape
    cin = table.shape[-1]
    safe = torch.where(found, idx.long(), 0)
    g = torch.gather(table.float(), 1,
                     safe.reshape(b, n * k, 1).expand(-1, -1, cin)).reshape(b, n, k, cin)
    return torch.where(found[..., None], g, 0.0)


def gather_gemm_reference(table, idx, found, w_flat, out_dtype=torch.float32):
    """Plain PyTorch version of kernel A1: gather, where, einsum, in f32.

    table (B, V, Cin); idx/found (B, N, K); w_flat (K*Cin, Cout)
    -> (B, N, Cout) in ``out_dtype``."""
    k = idx.shape[-1]
    w = w_flat.float().reshape(k, table.shape[-1], -1)
    return torch.einsum("bnkc,kcd->bnd", _gather_rows(table, idx, found), w).to(out_dtype)


def gather_gemm_dw_reference(table, idx, found, g_out):
    """Plain PyTorch version of kernel A2: gather, where, einsum, in f32.

    table (B, V, Cin); idx/found (B, N, K); g_out (B, N, Cout)
    -> (K*Cin, Cout) f32."""
    k = idx.shape[-1]
    dw = torch.einsum("bnkc,bnd->kcd", _gather_rows(table, idx, found), g_out.float())
    return dw.reshape(k * table.shape[-1], -1)


def _check_rulebook(table, idx, found):
    if table.dim() != 3 or idx.dim() != 3 or found.shape != idx.shape:
        raise ValueError(f"want table (B,V,Cin), idx/found (B,N,K); got "
                         f"{tuple(table.shape)}, {tuple(idx.shape)}, {tuple(found.shape)}")
    if idx.shape[0] != table.shape[0]:
        raise ValueError(f"batch mismatch: table {tuple(table.shape)}, idx {tuple(idx.shape)}")
    if idx.dtype != torch.int32 or found.dtype != torch.bool:
        raise TypeError(f"idx must be int32 and found bool, got {idx.dtype}/{found.dtype}")


def _on_cuda(named_tensors) -> bool:
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


def _check(table, idx, found, w_flat, out_dtype):
    _check_rulebook(table, idx, found)
    b, v, cin = table.shape
    k = idx.shape[-1]
    if w_flat.dim() != 2 or w_flat.shape[0] != k * cin:
        raise ValueError(f"shape mismatch: table {tuple(table.shape)}, idx "
                         f"{tuple(idx.shape)}, w_flat {tuple(w_flat.shape)}")
    if table.dtype not in _DTYPE_CODES or w_flat.dtype != table.dtype:
        raise TypeError(f"table/w must share float32 or bfloat16, got "
                        f"{table.dtype}/{w_flat.dtype}")
    if out_dtype not in _DTYPE_CODES:
        raise TypeError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    if max(b * v * cin, b * idx.shape[1] * max(k, w_flat.shape[1])) >= 2**31:
        raise ValueError("tensor too large for the kernel's 32-bit row indices")


def gather_gemm(table, idx, found, w_flat, out_dtype=torch.float32):
    """out[b, n] = sum_k found[b, n, k] * table[b, idx[b, n, k]] @ W[k], with
    W = w_flat.reshape(K, Cin, Cout); f32 accumulation, rounded once to
    ``out_dtype``. CUDA tensors run kernel A1; CPU tensors the plain version."""
    _check(table, idx, found, w_flat, out_dtype)
    if not _on_cuda((("table", table), ("idx", idx), ("found", found), ("w_flat", w_flat))):
        return gather_gemm_reference(table, idx, found, w_flat, out_dtype)
    fn = _load("gather_gemm")
    b, v, cin = table.shape
    n, k = idx.shape[1:]
    cout = w_flat.shape[1]
    out = torch.empty((b, n, cout), dtype=out_dtype, device=table.device)
    with torch.cuda.device(table.device):  # launch on the operands' card
        err = fn(table.data_ptr(), idx.data_ptr(), found.data_ptr(), w_flat.data_ptr(),
                 out.data_ptr(), b, v, n, k, cin, cout, _DTYPE_CODES[table.dtype],
                 _DTYPE_CODES[out_dtype], torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"gather_gemm kernel launch failed: CUDA error {err}")
    gather_gemm.launches += 1
    return out


gather_gemm.launches = 0


def gather_gemm_dw(table, idx, found, g_out):
    """dW[k*Cin + c, d] = sum_{b, n} found[b, n, k] * table[b, idx[b, n, k], c]
    * g_out[b, n, d], accumulated and returned in f32 as (K*Cin, Cout). The
    sum over rows runs in a fixed order (deterministic). CUDA tensors run
    kernel A2; CPU tensors the plain version."""
    _check_rulebook(table, idx, found)
    b, v, cin = table.shape
    n, k = idx.shape[1:]
    if g_out.dim() != 3 or tuple(g_out.shape[:2]) != (b, n):
        raise ValueError(f"g_out must be (B, N, Cout) = ({b}, {n}, *), got "
                         f"{tuple(g_out.shape)}")
    if table.dtype not in _DTYPE_CODES or g_out.dtype != table.dtype:
        raise TypeError(f"table/g_out must share float32 or bfloat16, got "
                        f"{table.dtype}/{g_out.dtype}")
    cout = g_out.shape[-1]
    if max(b * v * cin, b * n * max(k, cout)) >= 2**31:
        raise ValueError("tensor too large for the kernel's 32-bit row indices")
    if not _on_cuda((("table", table), ("idx", idx), ("found", found), ("g_out", g_out))):
        return gather_gemm_dw_reference(table, idx, found, g_out)
    out = torch.empty((k * cin, cout), dtype=torch.float32, device=table.device)
    if b * n == 0 or out.numel() == 0:
        return out.zero_()
    fn = _load("gather_gemm_dw")
    chunks = -(-(b * n) // DW_ROWS_PER_CHUNK)
    partial = torch.empty((chunks, k * cin, cout), dtype=torch.float32, device=table.device)
    with torch.cuda.device(table.device):
        err = fn(table.data_ptr(), idx.data_ptr(), found.data_ptr(), g_out.data_ptr(),
                 partial.data_ptr(), out.data_ptr(), b, v, n, k, cin, cout,
                 DW_ROWS_PER_CHUNK, _DTYPE_CODES[table.dtype],
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"gather_gemm_dw kernel launch failed: CUDA error {err}")
    gather_gemm_dw.launches += 1
    return out


gather_gemm_dw.launches = 0
