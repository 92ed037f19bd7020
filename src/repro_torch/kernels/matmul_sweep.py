"""Time the bf16 matmul kernels against each other at the shapes the serve
runs give them, on one CUDA card:

    PYTHONPATH=src python -m repro_torch.kernels.matmul_sweep [--out sweep.json]
        [--tables bf16,edge,f32]

For every weight shape of llama3.2-1b (at M = 1, 8, 16, 64, 128, 256, 512
and 1024) and mamba2-780m (at M = 3, 5, 8, 37, 45 and 600) it times the
weight-streaming kernel (where M fits it) and the tile kernel at each of
its block shapes, each at every K split of 1, 2, 3, 4, 6, 8, 16 and
32 that leaves no split empty, each block summing its own K run, and
prints the fastest configuration beside :func:`matmul.plan`'s choice and
its time; then every configuration that sums a row's K in
:func:`matmul.groups`' order (:func:`matmul.alternatives`: one group a
block, or a running total), the plan's candidates, and the fastest of
those: what the row invariance costs at each shape.  The A/B boundary
(``STREAM_MAX_M``) and the plan's cost model are read from this table.  Device time from CUDA events over
``iters`` launches behind a spin kernel, cycling through input sets that
exceed the 50 MB L2, as ``chip_smoke.py`` times its rows.

The ``edge`` table times the bf16 edge kernels at the untied unembeds'
shapes (granite-3-8b, hymba-1.5b, whisper large-v3) at M = 1, 8 and 16,
bf16 in and f32 out: the kernel :func:`matmul.edge_plan` picks at K splits
1, 2, 3 and 4 beside its choice, the edge kernel's cp.async copy at
:func:`matmul.edge_splits`'s split, the edge tile kernel (128 x 128),
``torch.matmul``, and the aligned streaming kernel on the same bytes (N
rounded up to 8); the split rule is read from it.  Above M = 16 it times
the edge tile kernel (128 x 128 and 128 x 64 tiles, one
:func:`matmul.groups` group a block) at hymba's in_proj ``[M,1600]x[1600,6482]`` (M = 17 .. 1400), the
unembeds at M = 17 and 64, and a K of 4099 over N = 131 (13 groups),
beside ``torch.matmul`` and the bound: :func:`matmul.edge_plan`'s rule
above M = 16 is read from it.  The ``f32`` table times
the f32 kernel at square shapes and the unembeds' in f32: each tile (64,
128) at K splits 1, 2, 4 and 8, and at M <= 16 also the streaming kernel
at splits 1-4, beside :func:`matmul.f32_plan`'s choice and ``torch.matmul``
(TF32 off); :func:`matmul.f32_plan` is read from it.  Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
from pathlib import Path

import torch

from repro_torch.hw import DEFAULT_CHIP as CHIP
from repro_torch.kernels import matmul as mm

L2_BYTES = 50 * 2**20
LLAMA = [(M, K, N) for M in (1, 8, 16, 64, 128, 256, 512, 1024)
         for K, N in ((2048, 2048), (2048, 512), (2048, 8192), (8192, 2048))]
MAMBA = [(M, K, N) for M in (3, 5, 8, 37, 45, 600) for K, N in ((1536, 6448), (3072, 1536))]
UNEMBEDS = [(M, K, N) for K, N in ((4096, 49155), (1600, 32001), (1280, 51866))
            for M in (1, 8, 16)]
EDGE_TILES = ([(M, 1600, 6482) for M in (17, 127, 129, 200, 500, 800, 1000, 1400)]
              + [(M, K, N) for K, N in ((4096, 49155), (1600, 32001), (1280, 51866))
                 for M in (17, 64)]
              + [(M, 4099, 131) for M in (17, 200)])
F32_SHAPES = [(S, S, S) for S in (256, 512, 1024, 2048)] + [
    (M, K, N) for K, N in ((4096, 49155), (1280, 51866)) for M in (8, 16)]


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
        group = mm.groups(N, K)[1]
        grouped = [(time_us(lambda a, b, p=p: mm.matmul_planned(a, b, p, group=group), sets), p)
                   for p in mm.alternatives(M, N, K)]
        inv_us, inv = min(grouped, key=lambda t: t[0])
        chosen = mm.plan(M, N, K)
        chosen_us = time_us(lambda a, b: mm.matmul(a, b), sets)
        lib_us = time_us(torch.matmul, sets)
        row = {"shape": [M, K, N], "plan": chosen.__dict__, "plan_us": chosen_us,
               "best": best.__dict__, "best_us": best_us, "torch_matmul_us": lib_us,
               "groups": mm.groups(N, K), "best_grouped": inv.__dict__, "best_grouped_us": inv_us,
               "all": [{"us": us, **p.__dict__} for us, p in timed],
               "grouped": [{"us": us, **p.__dict__} for us, p in grouped]}
        rows.append(row)
        print(f"[{M},{K}]x[{K},{N}] plan {chosen.kernel} {chosen.block_m}x{chosen.block_n} "
              f"s{chosen.splits} {chosen_us:.2f} us | best {best.kernel} {best.block_m}x"
              f"{best.block_n} s{best.splits} {best_us:.2f} us | best in group order "
              f"{inv.kernel} {inv.block_m}x{inv.block_n} s{inv.splits} {inv_us:.2f} us | "
              f"torch.matmul {lib_us:.2f} us | "
              + " ".join(f"{p.kernel[0]}{p.block_m}x{p.block_n}s{p.splits}:{us:.1f}"
                         for us, p in timed), flush=True)
        del sets, x, w
    return rows


def sweep_edge(shapes, seed: int = 0) -> list[dict]:
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    f32 = torch.float32
    rows = []
    for M, K, N in shapes:
        sets = [((torch.randn((M, K), generator=gen, device=dev)).to(torch.bfloat16),
                 (torch.randn((K, N), generator=gen, device=dev) * K ** -0.5).to(torch.bfloat16))]
        x, w = sets[0]
        want = mm.plain_matmul(x, w, out_dtype=f32)
        kt = math.ceil(K / mm.BK)
        kernel, splits = mm.edge_plan(M, N, K, w.data_ptr() % 16 == 0)
        timed = {}
        for s in (1, 2, 3, 4):
            if math.ceil(kt / math.ceil(kt / s)) != s:
                continue
            got = mm.matmul_edge(x, w, kernel=kernel, splits=s, out_dtype=f32)
            err = float((got - want).abs().max())
            if err > 1e-3 * (1 + float(want.abs().max())):
                raise AssertionError(f"edge kernel {kernel} splits {s} at {(M, K, N)}: "
                                     f"max error {err}")
            timed[s] = time_us(lambda a, b, s=s: mm.matmul_edge(a, b, kernel=kernel, splits=s,
                                                               out_dtype=f32), sets)
        realign_s = mm.edge_splits(M, N, K)
        row = {"shape": [M, K, N], "kernel": kernel, "splits": splits, "split_us": timed,
               "chosen_us": time_us(lambda a, b: mm.matmul(a, b, out_dtype=f32), sets),
               "realigning_us": time_us(lambda a, b: mm.matmul_edge(
                   a, b, kernel=1, splits=realign_s, out_dtype=f32), sets),
               "tile_us": time_us(lambda a, b: mm.matmul_edge(
                   a, b, kernel=0, splits=mm.groups(N, K)[0], out_dtype=f32), sets),
               "torch_matmul_us": time_us(torch.matmul, sets),
               "bound_us": 2 * (M * K + K * N + 2 * M * N) / CHIP.hbm_bw * 1e6}
        del sets, x, w
        na = -(-N // 8) * 8
        aligned = [((torch.randn((M, K), generator=gen, device=dev)).to(torch.bfloat16),
                    (torch.randn((K, na), generator=gen, device=dev) * K ** -0.5)
                    .to(torch.bfloat16))]
        row["aligned_stream_us"] = time_us(lambda a, b: mm.matmul(a, b, out_dtype=f32), aligned)
        rows.append(row)
        print(f"edge [{M},{K}]x[{K},{N}] kernel {kernel} s{splits} {row['chosen_us']:.2f} us | "
              + " ".join(f"s{s}:{us:.1f}" for s, us in timed.items())
              + f" | cp.async copy s{realign_s} {row['realigning_us']:.1f} | tile "
              f"{row['tile_us']:.1f} | torch.matmul {row['torch_matmul_us']:.1f} | aligned "
              f"N {na} {row['aligned_stream_us']:.1f} | bound {row['bound_us']:.1f}", flush=True)
        del aligned
    return rows


def sweep_edge_tiles(shapes, seed: int = 0) -> list[dict]:
    """The edge tile kernel at M above 16, bf16 out: each of its tiles (128 x
    128, 128 x 64) at :func:`matmul.edge_plan`'s split (one group a block),
    beside the plan's pick, ``torch.matmul`` and the bound."""
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
        kernel, splits = mm.edge_plan(M, N, K, w.data_ptr() % 16 == 0)
        timed = {}
        for kern, bn in mm.EDGE_TILE_BN.items():
            got = mm.matmul_edge(x, w, kernel=kern, splits=splits).float()
            err = float((got - want).abs().max())
            if err > 2e-2 * (1 + float(want.abs().max())):
                raise AssertionError(f"edge tile kernel {kern} at {(M, K, N)}: max error {err}")
            timed[bn] = time_us(lambda a, b, kern=kern: mm.matmul_edge(a, b, kernel=kern,
                                                                      splits=splits), sets)
        row = {"shape": [M, K, N], "groups": mm.groups(N, K), "kernel": kernel,
               "block_n": mm.EDGE_TILE_BN[kernel], "splits": splits, "timed_us": timed,
               "tiles": {bn: math.ceil(M / mm.EDGE_TILE_BM) * math.ceil(N / bn) for bn in timed},
               "chosen_us": time_us(mm.matmul, sets),
               "torch_matmul_us": time_us(torch.matmul, sets),
               "bound_us": max(2 * (M * K + K * N + M * N) / CHIP.hbm_bw,
                               2 * M * N * K / CHIP.peak_bf16_flops)
               * 1e6}
        rows.append(row)
        print(f"edge tile [{M},{K}]x[{K},{N}] plan 128x{row['block_n']} s{splits} "
              f"{row['chosen_us']:.2f} us | " + " ".join(
                  f"128x{bn} ({row['tiles'][bn]} tiles) {us:.2f}" for bn, us in timed.items())
              + f" | torch.matmul {row['torch_matmul_us']:.2f} | bound {row['bound_us']:.2f}",
              flush=True)
        del sets, x, w
    return rows


def sweep_f32(shapes, seed: int = 0) -> list[dict]:
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    torch.backends.cuda.matmul.allow_tf32 = False
    rows = []
    for M, K, N in shapes:
        n_sets = max(1, min(8, math.ceil(2 * L2_BYTES / (4 * (M * K + K * N)))))
        sets = [(torch.randn((M, K), generator=gen, device=dev),
                 torch.randn((K, N), generator=gen, device=dev)) for _ in range(n_sets)]
        want = mm.plain_matmul(*sets[0])
        blocks = ((0,) if M <= mm.STREAM_MAX_M else ()) + mm.F32_BLOCKS
        timed = {}
        for block in blocks:
            kt = math.ceil(K / (mm.BK if block == 0 else mm.F32_BK))
            for s in ((1, 2, 3, 4) if block == 0 else (1, 2, 4, 8)):
                if s > kt or math.ceil(kt / math.ceil(kt / s)) != s:
                    continue
                plan = (block, s)
                run = lambda a, b, plan=plan: mm.matmul_f32_planned(a, b, plan)
                err = float((run(*sets[0]) - want).abs().max())
                if err > 2e-4 * (1 + float(want.abs().max())):
                    raise AssertionError(f"f32 plan {plan} at {(M, K, N)}: max error {err}")
                timed[f"{block}s{s}"] = time_us(run, sets)
        row = {"shape": [M, K, N], "plan": mm.f32_plan(M, N, K), "timed_us": timed,
               "chosen_us": time_us(mm.matmul, sets), "torch_matmul_us": time_us(torch.matmul, sets)}
        rows.append(row)
        print(f"f32 [{M},{K}]x[{K},{N}] plan {row['plan']} {row['chosen_us']:.2f} us | "
              + " ".join(f"b{k}:{us:.1f}" for k, us in timed.items())
              + f" | torch.matmul {row['torch_matmul_us']:.1f}", flush=True)
        del sets
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--tables", default="bf16,edge,f32", help="tables: bf16, edge, f32")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("matmul_sweep: needs a CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"{torch.cuda.get_device_name(0)} ({smi})")
    tables = args.tables.split(",")
    rows = sweep(LLAMA + MAMBA) if "bf16" in tables else []
    edge = (sweep_edge(UNEMBEDS) + sweep_edge_tiles(EDGE_TILES)) if "edge" in tables else []
    f32 = sweep_f32(F32_SHAPES) if "f32" in tables else []
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"card": torch.cuda.get_device_name(0), "nvidia_smi": smi,
                                        "rows": rows, "edge": edge, "f32": f32}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
