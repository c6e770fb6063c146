"""Sweep of the host-side choices of kernels A1, A2 and G2 on one CUDA card.

    python -m cpd_tpu_torch.probes.tiling [--batch 2] [--reps 7] [--live 0.6]

For each sparse-conv layer shape of the bench configuration (rows, taps,
channels, share of found taps) it draws a synthetic rulebook (each tap's idx
rising with the row, as sorted keys give it; found drawn at the layer's
share, all of it within the first ``--live`` share of the rows: a stage's
rulebook is padded to its cap, and on a 200k-point frame 52 to 67% of the
rows are live), and times, in bf16, kernel A1 at every tile size and kernel
A2 at a list of (chunk rows, taps) plans, marking the wrapper's own choice
(``a1_tile_rows``, ``a2_plan``). Where G2's own kernel takes the shape
(``g2_route``), it times G2 on the first sample's rulebook at a range of
warps a block, marking ``g2_warps``; last G2 the same way at probe P3's
operands. Times are device times: each reading queues a spin kernel first,
so that the host has enqueued the launch before the card reaches it.
"""
from __future__ import annotations

import argparse
import statistics

import numpy as np
import torch

from ..ops import gather_gemm as gg
from ..ops import gather_probes as gp
from . import gather as probes

# rows, taps, cin, cout, found share: the 9 forward shapes of a bench frame,
# then the wide -> narrow shapes that the strided convs' dX adds
LAYER_SHAPES = [(90000, 27, 5, 16, 0.19), (90000, 27, 16, 16, 0.19), (80000, 27, 16, 32, 0.10),
                (80000, 27, 32, 32, 0.31), (48000, 27, 32, 64, 0.14), (48000, 27, 64, 64, 0.29),
                (24000, 27, 64, 128, 0.14), (24000, 27, 128, 128, 0.28),
                (20000, 3, 128, 128, 0.28), (90000, 27, 32, 16, 0.10), (80000, 27, 64, 32, 0.14),
                (48000, 27, 128, 64, 0.14)]
SPIN_CYCLES = 600_000  # about 0.3 ms of a spin kernel ahead of each reading


def device_ms(fn, reps: int) -> float:
    """Median device time of one call of ``fn`` between CUDA events, the
    host kept ahead of the card by a spin kernel."""
    fn()
    times = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def synthetic_rulebook(rng, b, n, k, v, share, live, device):
    """idx (B, N, K) int32 rising with the row in every tap; found (B, N, K)
    at ``share`` over all rows, none beyond the first ``live`` share of them."""
    base = np.arange(n)[None, :, None] * (v / n) + rng.integers(-40, 40, (b, 1, k))
    idx = np.clip(base + rng.integers(-3, 4, (b, n, k)), 0, v - 1).astype(np.int32)
    found = rng.random((b, n, k)) < share / live
    found[:, int(live * n):] = False
    return torch.from_numpy(idx).to(device), torch.from_numpy(found).to(device)


def g2_line(label, table, idx, found, w, reps):
    """G2's own kernel at a range of warps a block (``g2_warps``'s choice
    marked), on unbatched bf16 operands."""
    n, (k, cin, cout) = idx.shape[0], w.shape
    most, chosen = gp.g2_max_warps(k, cin, cout), gp.g2_warps(n, k, cin, cout)
    counts = sorted({c for c in (4, 8, 12, 16, 20, 24, 28, 32, chosen - 2, chosen + 2, chosen, most)
                     if 1 <= c <= most})
    cells = [f"{c}{'*' if c == chosen else ''}: "
             f"{device_ms(lambda: gp.gather_gemm_per_tap(table, idx, found, w, warps=c), reps):.4f}"
             for c in counts]
    print(f"G2 {label}: ms by warps a block " + ", ".join(cells))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--live", type=float, default=0.6)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("the tiling sweep needs a CUDA card")
    dev, b = torch.device("cuda"), args.batch
    rng = np.random.default_rng(0)
    print(f"card: {torch.cuda.get_device_name(0)}; batch {b}, bf16, live rows {args.live}, "
          f"medians of {args.reps}")
    for n, k, cin, cout, share in LAYER_SHAPES:
        v = n
        idx, found = synthetic_rulebook(rng, b, n, k, v, share, args.live, dev)
        table = torch.randn(b, v, cin, device=dev).bfloat16()
        w = (torch.randn(k * cin, cout, device=dev) * 0.1).bfloat16()
        g = torch.randn(b, n, cout, device=dev).bfloat16()
        chosen = gg.a1_tile_rows(b, n, k, cin, cout, 2)
        cells = []
        for tm in (320, 256, 192, 128, 64):
            if gg.a1_smem_bytes(tm, k, cin, cout, 2) > gg.MAX_SMEM:
                continue
            ms = device_ms(lambda: gg.gather_gemm(table, idx, found, w, torch.bfloat16,
                                                  tile_rows=tm), args.reps)
            cells.append(f"{tm}{'*' if tm == chosen else ''}: {ms:.4f}")
        print(f"A1 {n} x {k} x {cin} -> {cout} (found {share}): ms by tile rows "
              + ", ".join(cells))
        chosen = gg.a2_plan(b * n, k, cin, cout)
        plans = {chosen}
        for taps in sorted({min(k, 27), min(k, 9), min(k, 3), 1}):
            for entries in (2048, 4096, 8192):
                plans.add((max(32, entries // taps // 32 * 32), taps))
        cells = []
        for plan in sorted(plans, key=lambda p: (-p[1], p[0])):
            chunks = -(-b * n // plan[0])
            if (chunks * k * cin * cout * 4 > 4 * gg.DW_SCRATCH_BYTES
                    or gg.a2_smem_bytes(*plan, cin, cout, 2) > gg.MAX_SMEM):
                continue
            ms = device_ms(lambda: gg.gather_gemm_dw(table, idx, found, g, plan=plan), args.reps)
            cells.append(f"{plan}{'*' if plan == chosen else ''}: {ms:.4f}")
        print(f"A2 {n} x {k} x {cin} -> {cout}: ms by (chunk rows, taps) " + ", ".join(cells))
        if gp.g2_route(k, cin, cout, torch.bfloat16) == "own":
            g2_line(f"{n} x {k} x {cin} -> {cout} (found {share})", table[0], idx[0], found[0],
                    w.reshape(k, cin, cout), args.reps)
        del idx, found, table, w, g
        torch.cuda.empty_cache()
    ops = probes.make_operands("P3", dev)
    g2_line("P3", ops.table, ops.idx, ops.found, ops.w, args.reps)


if __name__ == "__main__":
    main()
