"""Time the bf16 matmul kernels against each other at the shapes the serve
runs give them, on one CUDA card:

    PYTHONPATH=src python -m repro_torch.kernels.matmul_sweep [--out sweep.json]

For every weight shape of llama3.2-1b (at M = 1, 8, 16, 64, 128, 256, 512
and 1024) and mamba2-780m (at M = 3, 5, 8, 37, 45 and 600) it times the
weight-streaming kernel (where M fits it) and the tile kernel at each of
its block shapes, each at every K split of 1, 2, 3, 4, 6, 8, 16 and
32 that leaves no split empty, and prints the fastest configuration beside :func:`matmul.plan`'s
choice and its time.  The A/B boundary (``STREAM_MAX_M``) and the plan's
cost model are read from this table.  Device time from CUDA events over
``iters`` launches behind a spin kernel, cycling through input sets that
exceed the 50 MB L2, as ``chip_smoke.py`` times its rows.  Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
from pathlib import Path

import torch

from repro_torch.kernels import matmul as mm

L2_BYTES = 50 * 2**20
LLAMA = [(M, K, N) for M in (1, 8, 16, 64, 128, 256, 512, 1024)
         for K, N in ((2048, 2048), (2048, 512), (2048, 8192), (8192, 2048))]
MAMBA = [(M, K, N) for M in (3, 5, 8, 37, 45, 600) for K, N in ((1536, 6448), (3072, 1536))]


def candidates(M: int, N: int, K: int) -> list[mm.Plan]:
    """Every configuration the C side takes for this shape, at splits 1, 2,
    3, 4, 6, 8, 16 and 32 where none is empty."""
    kt = math.ceil(K / mm.BK)
    splits = [s for s in (1, 2, 3, 4, 6, 8, 16, 32) if s <= kt and math.ceil(kt / math.ceil(kt / s)) == s]
    out = []
    if M <= max(mm.STREAM_ROWS):
        rows = next(r for r in mm.STREAM_ROWS if r >= M)
        tiles = math.ceil(N / mm.STREAM_BN)
        out += [mm.Plan("stream", rows, mm.STREAM_BN, s, math.ceil(kt / s), tiles) for s in splits]
    for bm, bn in mm.TILE_SHAPES:
        tiles = math.ceil(M / bm) * math.ceil(N / bn)
        out += [mm.Plan("tile", bm, bn, s, math.ceil(kt / s), tiles) for s in splits]
    return out


def time_us(fn, sets, iters: int = 20) -> float:
    for i in range(2):
        fn(*sets[i % len(sets)])
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    start.record()
    for i in range(iters):
        fn(*sets[i % len(sets)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) * 1e3 / iters


def sweep(shapes, seed: int = 0) -> list[dict]:
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    rows = []
    for M, K, N in shapes:
        n_sets = max(1, min(16, math.ceil(2 * L2_BYTES / (2 * (M * K + K * N)))))
        sets = [((torch.randn((M, K), generator=gen, device=dev)).to(torch.bfloat16),
                 (torch.randn((K, N), generator=gen, device=dev) * K ** -0.5).to(torch.bfloat16))
                for _ in range(n_sets)]
        x, w = sets[0]
        want = mm.plain_matmul(x, w).float()
        timed = []
        for p in candidates(M, N, K):
            got = mm.matmul_planned(x, w, p).float()
            err = float((got - want).abs().max())
            if err > 2e-2 * (1 + float(want.abs().max())):
                raise AssertionError(f"{p} at {(M, K, N)}: max error {err}")
            timed.append((time_us(lambda a, b, p=p: mm.matmul_planned(a, b, p), sets), p))
        best_us, best = min(timed, key=lambda t: t[0])
        chosen = mm.plan(M, N, K)
        chosen_us = time_us(lambda a, b: mm.matmul(a, b), sets)
        lib_us = time_us(torch.matmul, sets)
        row = {"shape": [M, K, N], "plan": chosen.__dict__, "plan_us": chosen_us,
               "best": best.__dict__, "best_us": best_us, "torch_matmul_us": lib_us,
               "all": [{"us": us, **p.__dict__} for us, p in timed]}
        rows.append(row)
        print(f"[{M},{K}]x[{K},{N}] plan {chosen.kernel} {chosen.block_m}x{chosen.block_n} "
              f"s{chosen.splits} {chosen_us:.2f} us | best {best.kernel} {best.block_m}x"
              f"{best.block_n} s{best.splits} {best_us:.2f} us | torch.matmul {lib_us:.2f} us | "
              + " ".join(f"{p.kernel[0]}{p.block_m}x{p.block_n}s{p.splits}:{us:.1f}"
                         for us, p in timed), flush=True)
        del sets, x, w
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("matmul_sweep: needs a CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"{torch.cuda.get_device_name(0)} ({smi})")
    rows = sweep(LLAMA + MAMBA)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"card": torch.cuda.get_device_name(0), "nvidia_smi": smi,
                                        "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
