"""Time the decode attention kernel, dense and paged, at every key-range split,
at the shapes the serve runs give it, on one CUDA card:

    PYTHONPATH=src python -m repro_torch.kernels.decode_sweep [--out sweep.json]

Each row is one call shape with 32 query heads: the 8-slot decode step
against 1024 cache rows (llama, D 64 with 8 kv heads; yi, D 128 with 4), the
16-slot step (the chunked run), granite's 8-slot step against 512 rows (D
128, 8 kv heads), and the first-token fixups (one sequence against its
prompt's n rows); the paged kernel at the decode steps through a shuffled
table of 16-row pages.  The lengths are ``chip_smoke.py``'s.  Every split of
1 to ``MAX_SPLITS`` (and the cache's tiles) is held to the plain version and
timed beside :func:`decode_attention.split_kv`'s choice and the fastest
count; the split rule is read from this table.  Device time from CUDA
events over ``iters`` launches behind a spin kernel, cycling through input
sets that exceed the 50 MB L2, as ``chip_smoke.py`` times its rows.
Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
from pathlib import Path

import torch

from repro_torch.kernels import decode_attention as dec
from repro_torch.kernels import paged_decode_attention as paged
from repro_torch.kernels.flash_sweep import time_us

L2_BYTES = 50 * 2**20
SLOTS = (1, 1024, 5, 600, 37, 256, 900, 64)
GRANITE = (6, 46, 131, 261, 301, 401, 471, 501)
PAGE_ROWS = 16
#: (kind, head_dim, kv heads, cache rows, lengths)
SHAPES = (
    [("dense", 64, 8, 1024, SLOTS), ("dense", 64, 8, 1024, SLOTS * 2),
     ("dense", 128, 4, 1024, SLOTS), ("dense", 128, 8, 512, GRANITE)]
    + [("dense", 64, 8, n, (n,)) for n in (45, 300, 600)]
    + [("dense", 128, 4, 600, (600,)), ("dense", 128, 8, 500, (500,))]
    + [("paged", 64, 8, 1024, SLOTS), ("paged", 64, 8, 1024, SLOTS * 2),
       ("paged", 128, 4, 1024, SLOTS), ("paged", 128, 8, 512, GRANITE)])


def sweep(seed: int = 0) -> list[dict]:
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def randn(shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    rows = []
    for kind, D, hkv, T, lens in SHAPES:
        B = len(lens)
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        sets = []
        for _ in range(max(1, min(16, math.ceil(2 * L2_BYTES / (4 * B * hkv * T * D))))):
            q = randn((B, 32, D))
            if kind == "dense":
                sets.append((q, randn((B, hkv, T, D)), randn((B, hkv, T, D))))
            else:
                NP = T // PAGE_ROWS
                P = B * NP + 1
                table = torch.randperm(P - 1, generator=gen, device=dev)[: B * NP] + 1
                sets.append((q, randn((P, hkv, PAGE_ROWS, D)), randn((P, hkv, PAGE_ROWS, D)),
                             table.reshape(B, NP).to(torch.int32)))
        if kind == "dense":
            call = lambda q, k, v, s=None: dec.decode_attention(q, k, v, lengths, splits=s)  # noqa: E731
            plain = lambda q, k, v: dec.plain_decode_attention(q, k, v, lengths)  # noqa: E731
        else:
            call = lambda q, k, v, t, s=None: paged.paged_decode_attention(  # noqa: E731
                q, k, v, t, lengths, splits=s)
            plain = lambda q, k, v, t: paged.plain_paged_decode_attention(  # noqa: E731
                q, k, v, t, lengths)
        want = plain(*sets[0]).float()
        timed = {}
        for splits in range(1, min(dec.MAX_SPLITS, -(-T // dec.TILE)) + 1):
            got = call(*sets[0], s=splits).float()
            rel = float(((got - want).norm(dim=-1) / want.norm(dim=-1).clamp_min(1e-30)).max())
            if rel > 1e-2:
                raise AssertionError(f"splits {splits} at {(kind, D, hkv, T, B)}: row rel L2 "
                                     f"{rel}")
            timed[splits] = time_us(lambda *a, s=splits: call(*a, s=s), sets)
        chosen = dec.split_kv(T)
        best = min(timed, key=timed.get)
        row = {"kind": kind, "D": D, "hkv": hkv, "T": T, "B": B, "lengths": list(lens),
               "splits_us": timed, "split_kv": chosen, "fastest": best,
               "split_kv_over_fastest": timed[chosen] / timed[best]}
        rows.append(row)
        print(f"{kind} D={D} hkv={hkv} B={B} T={T} split_kv={chosen} fastest={best} "
              f"({timed[chosen] / timed[best]:.3f}x) | "
              + " ".join(f"s{s}:{us:.2f}" for s, us in timed.items()), flush=True)
        del sets
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("decode_sweep: needs a CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"{torch.cuda.get_device_name(0)} ({smi})")
    print("blocks an SM: " + " ".join(f"D{D}:{dec.blocks_per_sm(D)}" for D in range(16, 129, 16)))
    out = {"card": torch.cuda.get_device_name(0), "nvidia_smi": smi,
           "blocks_per_sm": {D: dec.blocks_per_sm(D) for D in range(16, 129, 16)},
           "rows": sweep()}
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
