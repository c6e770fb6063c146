"""The gather-formulation probes on one CUDA card (port of the Pallas probes
of ``scripts/exp_pallas_gather.py``, ``exp_gather_variants.py``,
``exp_tal_gather.py``, ``exp_r2_lowering.py`` section E, ``exp_r2h_gather2.py``
and ``exp_r2i_lane_gather.py``).

    python -m cpd_tpu_torch.probes.gather [--only P1,P6] [--v N --cin C --cout C --k K
                                           --tile T --iters I] [--cpu]

For each probe P1-P7 it draws the script's operands from
``np.random.default_rng(0)`` in the script's order (table, idx, found, W, at
the script's default sizes unless a flag overrides them), and runs, on the
same operands: the baselines the scripts compare against (a plain gather and
one ``matmul``, in f32 and in bf16), the probe's kernel (G1-G4 of
``ops/gather_probes.py``) and kernel A1 (``ops/gather_gemm.py``). It prints
one line each: name, median ms of ``--iters`` single calls between CUDA
events, and the largest difference from the exact result (the plain version
of the probe's function in f32 on the operands as the kernel reads them). P7
is a gather with no product: its line stands beside ``torch.index_select``.

It needs a CUDA card and fails without one; ``--cpu`` (the scripts' own flag)
runs the plain versions on the CPU instead, with host-clock times that say
nothing about the card.

Sections A-D of ``exp_r2_lowering.py``, the packed-int32 variant of
``exp_gather_variants.py`` and the row-cost section of ``exp_tal_gather.py``
hold no kernel and ask about XLA's lowering; they are not carried over.
"""
from __future__ import annotations

import argparse
import statistics
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops import gather_gemm as a1
from ..ops import gather_probes as gp


class Probe(NamedTuple):
    """One probe: what it replaces, its kernel, and the script's defaults."""

    replaces: str
    kernel: str  # gather_gemm_flat | gather_gemm_per_tap | lane_gather_gemm | lane_gather
    v: int
    cin: int
    cout: int
    k: int = 27
    tile: int = 256
    found: Optional[float] = 0.4  # density of found taps; None: the probe has no found
    bf16: bool = False  # operands cast to bf16 before the call
    round_bf16: bool = False  # f32 operands rounded to bf16 inside the kernel
    rows: str = "all"  # "pad": V padded up to a tile multiple; "cut": rows cut down to one
    scale_in_f64: bool = False  # W scaled by 0.1 before (not after) the cast to f32


PROBES = {
    "P1": Probe("scripts/exp_pallas_gather.py:82", "gather_gemm_flat", 150_000, 16, 16,
                round_bf16=True, rows="pad"),
    "P2": Probe("scripts/exp_gather_variants.py:107", "gather_gemm_flat", 150_016, 16, 16,
                bf16=True, rows="cut"),
    "P3": Probe("scripts/exp_tal_gather.py:86", "gather_gemm_per_tap", 150_016, 16, 16,
                bf16=True),
    "P4": Probe("scripts/exp_r2_lowering.py:213", "gather_gemm_flat", 80_000, 32, 32,
                bf16=True, rows="pad", scale_in_f64=True),
    "P5": Probe("scripts/exp_r2h_gather2.py:99", "gather_gemm_flat", 48_000, 32, 32, found=None),
    "P6": Probe("scripts/exp_r2i_lane_gather.py:75", "lane_gather_gemm", 48_000, 64, 64,
                found=None),
    "P7": Probe("scripts/exp_r2i_lane_gather.py:96", "lane_gather", 48_000, 64, 64, found=None),
}


class Operands(NamedTuple):
    """A probe's operands on one device. ``table`` is (V, Cin), or (C, V) for
    the two lane-gather probes; ``w`` is (K*Cin, Cout), (K, Cin, Cout) for P3,
    None for P7."""

    probe: Probe
    table: torch.Tensor
    idx: torch.Tensor
    found: Optional[torch.Tensor]
    w: Optional[torch.Tensor]


def make_operands(name: str, device, **overrides) -> Operands:
    """The probe's operands as its script draws them from
    ``np.random.default_rng(0)``; ``overrides`` (v, cin, cout, k, tile)
    replace the script's defaults."""
    probe = PROBES[name]._replace(**{k: v for k, v in overrides.items() if v is not None})
    rng = np.random.default_rng(0)
    v, k, cin, cout, tile = probe.v, probe.k, probe.cin, probe.cout, probe.tile
    n = -(-v // tile) * tile if probe.rows == "pad" else v
    transposed = probe.kernel.startswith("lane_gather")
    table = rng.normal(size=(cin, n) if transposed else (n, cin)).astype(np.float32)
    idx = rng.integers(0, v, (n, k)).astype(np.int32)
    found = None if probe.found is None else rng.random((n, k)) < probe.found
    w = rng.normal(size=(k * cin, cout))
    w = (w * 0.1).astype(np.float32) if probe.scale_in_f64 else w.astype(np.float32) * 0.1
    if probe.kernel == "gather_gemm_per_tap":
        w = w.reshape(k, cin, cout)
    if probe.rows == "cut":
        n = v // tile * tile
        idx, found = idx[:n], found[:n]
    dtype = torch.bfloat16 if probe.bf16 else torch.float32
    return Operands(
        probe, torch.from_numpy(table).to(device).to(dtype),
        torch.from_numpy(idx).to(device),
        None if found is None else torch.from_numpy(found).to(device),
        None if probe.kernel == "lane_gather" else torch.from_numpy(w).to(device).to(dtype))


def kernel_call(ops: Operands):
    """The probe's kernel on its operands, as a function of no arguments."""
    p = ops.probe
    if p.kernel == "gather_gemm_flat":
        return lambda: gp.gather_gemm_flat(ops.table, ops.idx, ops.found, ops.w, p.round_bf16)
    if p.kernel == "gather_gemm_per_tap":
        return lambda: gp.gather_gemm_per_tap(ops.table, ops.idx, ops.found, ops.w)
    if p.kernel == "lane_gather_gemm":
        return lambda: gp.lane_gather_gemm(ops.table, ops.idx, ops.w, ops.found)
    return lambda: gp.lane_gather(ops.table, ops.idx, p.tile)


def plain_call(ops: Operands):
    """The plain PyTorch version of the probe's kernel on the same operands."""
    p = ops.probe
    if p.kernel == "gather_gemm_flat":
        return lambda: gp.gather_gemm_flat_reference(ops.table, ops.idx, ops.found, ops.w,
                                                     p.round_bf16)
    if p.kernel == "gather_gemm_per_tap":
        return lambda: gp.gather_gemm_per_tap_reference(ops.table, ops.idx, ops.found, ops.w)
    if p.kernel == "lane_gather_gemm":
        return lambda: gp.lane_gather_gemm_reference(ops.table, ops.idx, ops.w, ops.found)
    return lambda: gp.lane_gather_reference(ops.table, ops.idx, p.tile)


def row_major(ops: Operands):
    """(table (V, Cin), idx, found, w_flat (K*Cin, Cout)) as kernel A1 and the
    baselines read them: the table row-major, operands rounded where the
    probe's kernel rounds them, ``found`` all true where the probe has none."""
    p = ops.probe
    table = ops.table.T.contiguous() if p.kernel.startswith("lane_gather") else ops.table
    w = None if ops.w is None else ops.w.reshape(-1, ops.w.shape[-1])
    if p.round_bf16:
        table, w = table.bfloat16(), w.bfloat16()
    found = torch.ones_like(ops.idx, dtype=torch.bool) if ops.found is None else ops.found
    return table, ops.idx, found, w


def a1_call(ops: Operands):
    """Kernel A1 on the probe's operands (None for P7, which has no product)."""
    if ops.w is None:
        return None
    table, idx, found, w = row_major(ops)
    table, idx, found = table[None], idx[None], found[None]
    return lambda: a1.gather_gemm(table, idx, found, w, torch.float32)[0]


def baseline_calls(ops: Operands):
    """The scripts' baselines: a plain row gather, a where and one matmul, in
    f32 and in bf16 (the bf16 product's result cast to f32). For P7: the one
    PyTorch call that computes it, ``torch.index_select``."""
    p = ops.probe
    if ops.w is None:
        tiles, tq = ops.idx.shape[0] // p.tile, p.tile * p.k
        flat = ops.idx.reshape(-1)[:tiles * tq]
        return {"index_select": lambda: torch.index_select(ops.table, 1, flat).reshape(
            p.cin, tiles, tq).permute(1, 0, 2).contiguous()}
    table, idx, found, w = row_major(ops)
    n, k = idx.shape

    def conv(dtype):
        t, ww = table.to(dtype), w.to(dtype)

        def run():
            g = torch.where(found[..., None], t[idx.reshape(-1).long()].reshape(n, k, -1), 0)
            return (g.reshape(n, -1) @ ww).float()
        return run

    return {"plain gather + matmul f32": conv(torch.float32),
            "plain gather + matmul bf16": conv(torch.bfloat16)}


def median_ms(fn, iters: int, device) -> float:
    """Median time of ``iters`` single calls after one warm-up: between CUDA
    events on a card, by the host clock on the CPU."""
    fn()
    times = []
    for _ in range(iters):
        if device.type == "cuda":
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def run_probe(name: str, device, iters: int, **overrides):
    """Run one probe and print its lines. Returns {line name: (ms, max diff)}."""
    ops = make_operands(name, device, **overrides)
    p = ops.probe
    clock = "ms" if device.type == "cuda" else "ms on the CPU's host clock"
    shape = (f"V={p.v} K={p.k} C={p.cin}->{p.cout} tile={p.tile} rows={ops.idx.shape[0]} "
             f"{str(ops.table.dtype).split('.')[-1]}"
             + (" rounded to bf16 in the kernel" if p.round_bf16 else "")
             + (f" found={p.found}" if ops.found is not None else " no found"))
    print(f"== {name} ({p.replaces}): {p.kernel}, {shape}")
    exact = plain_call(ops)()
    calls = dict(baseline_calls(ops))
    calls[f"kernel {p.kernel}" if device.type == "cuda" else f"plain {p.kernel}"] = kernel_call(ops)
    if a1_call(ops) is not None:
        calls["kernel A1 gather_gemm" if device.type == "cuda" else "plain A1"] = a1_call(ops)
    results = {}
    for label, fn in calls.items():
        diff = float((fn() - exact).abs().max()) if exact.numel() else 0.0
        ms = median_ms(fn, iters, device)
        results[label] = (ms, diff)
        print(f"{name} {label:32s} {ms:9.4f} {clock}   maxdiff={diff:.3e}", flush=True)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain versions on the CPU (no card needed)")
    ap.add_argument("--only", default=",".join(PROBES), help="probes to run, e.g. P1,P6")
    ap.add_argument("--v", type=int)
    ap.add_argument("--cin", type=int)
    ap.add_argument("--cout", type=int)
    ap.add_argument("--k", type=int)
    ap.add_argument("--tile", type=int)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    names = [n.strip() for n in args.only.split(",") if n.strip()]
    unknown = [n for n in names if n not in PROBES]
    if unknown:
        ap.error(f"unknown probes {unknown}; choose from {list(PROBES)}")
    if args.cpu:
        device = torch.device("cpu")
    elif torch.cuda.is_available():
        device = torch.device("cuda")
        torch.backends.cuda.matmul.allow_tf32 = False
        print(f"card: {torch.cuda.get_device_name(0)}")
    else:
        raise SystemExit("the probes need a CUDA card; none is available (--cpu runs the "
                         "plain versions on the CPU)")
    for name in names:
        run_probe(name, device, args.iters, v=args.v, cin=args.cin, cout=args.cout, k=args.k,
                  tile=args.tile)


if __name__ == "__main__":
    main()
