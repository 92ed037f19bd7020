"""Time the flash attention kernel at every key-range split, at the shapes the
serve runs give it, on one CUDA card:

    PYTHONPATH=src python -m repro_torch.kernels.flash_sweep [--out sweep.json]

Two tables, at head_dim 64 and 128 with 32 query and 8 kv heads:

- ``serve``: the prompt buckets 8 .. 1024 (causal; 512 also non-causal) and
  the 128-row chunks against 256 .. 1024 keys, each at every split of 1 to
  ``MAX_SPLITS`` beside :func:`flash_attention.split_kv`'s choice and
  ``scaled_dot_product_attention``;
- ``walk``: one 64-row q tile a head (32 blocks, one an SM) against 64 ..
  2048 keys, non-causal: unsplit, the time against the number of key tiles
  a block walks, whose slope is what one tile costs a block alone on its SM
  and whose intercept is the launch's fixed cost; split, what the merge
  costs against what it saves.

The split rule is read from the first table; every split must give the
unsplit launch's bits (the kernel's key groups).  Device time from CUDA events
over ``iters`` launches behind a spin kernel, cycling through input sets
that exceed the 50 MB L2, as ``chip_smoke.py`` times its rows.  Imports no
JAX.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F
from torch.nn.attention.bias import causal_lower_right

from repro_torch.kernels import flash_attention as fa

L2_BYTES = 50 * 2**20
SERVE = ([(S, S, True) for S in (8, 64, 128, 256, 512, 1024)] + [(512, 512, False)]
         + [(128, T, True) for T in range(256, 1025, 128)])
WALK = [(64, T, False) for T in (64, 128, 256, 512, 1024, 2048)]


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


def sweep(shapes, D: int, all_splits: bool, seed: int = 0) -> list[dict]:
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    rows = []
    for S, T, causal in shapes:
        per_set = 2 * (2 * 32 * S * D + 2 * 8 * T * D)
        sets = []
        for _ in range(max(1, min(16, math.ceil(2 * L2_BYTES / per_set)))):
            q, k, v = (torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
                       for shape in ((1, 32, S, D), (1, 8, T, D), (1, 8, T, D)))
            sets.append((q, k, v, k.repeat_interleave(4, 1), v.repeat_interleave(4, 1)))
        q, k, v = sets[0][:3]
        want = fa.plain_flash_attention(q, k, v, causal=causal).float()
        timed, unsplit = {}, fa.flash_attention(q, k, v, causal=causal, splits=1)
        for splits in range(1, fa.MAX_SPLITS + 1 if all_splits else 2):
            got = fa.flash_attention(q, k, v, causal=causal, splits=splits)
            if not torch.equal(got, unsplit):     # key groups: a split moves no bit
                raise AssertionError(f"splits {splits} at {(S, T, causal, D)}: not bitwise "
                                     f"the unsplit launch")
            got = got.float()
            rel = float(((got - want).norm(dim=-1) / want.norm(dim=-1)).max())
            if rel > 1e-2:
                raise AssertionError(f"splits {splits} at {(S, T, causal, D)}: row rel L2 {rel}")
            timed[splits] = time_us(
                lambda q, k, v, ke, ve, s=splits: fa.flash_attention(q, k, v, causal=causal,
                                                                     splits=s), sets)
        chosen = fa.split_kv(1, 32, S, T, causal, head_dim=D)
        # SDPA's own causal masks (is_causal aligns the queries to the first
        # keys, so a chunk, S < T, takes the lower-right bias), as
        # chip_smoke.py times it, and beside it an explicit boolean mask (the
        # yardstick of earlier PRs' PERF.md rows)
        mask = (torch.arange(T, device=dev)[None, :]
                <= torch.arange(S, device=dev)[:, None] + T - S) if causal else None
        bias = causal_lower_right(S, T) if causal and S < T else None
        sdpa = time_us(lambda q, k, v, ke, ve: F.scaled_dot_product_attention(
            q, ke, ve, attn_mask=bias, is_causal=causal and S == T), sets)
        sdpa_mask = time_us(lambda q, k, v, ke, ve: F.scaled_dot_product_attention(
            q, ke, ve, attn_mask=mask), sets) if causal else None
        row = {"S": S, "T": T, "causal": causal, "D": D, "splits_us": timed,
               "split_kv": chosen, "sdpa_us": sdpa, "sdpa_mask_us": sdpa_mask}
        rows.append(row)
        print(f"D={D} S={S} T={T} causal={causal} split_kv={chosen} | "
              + " ".join(f"s{s}:{us:.2f}" for s, us in timed.items())
              + (f" | SDPA {sdpa:.2f} us" if sdpa is not None else "")
              + (f" | SDPA, mask {sdpa_mask:.2f} us" if sdpa_mask is not None else ""),
              flush=True)
        del sets, q, k, v
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--tables", default="serve,walk", help="which tables: serve, walk or both")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_sweep: needs a CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"{torch.cuda.get_device_name(0)} ({smi})")
    out = {"card": torch.cuda.get_device_name(0), "nvidia_smi": smi}
    tables = args.tables.split(",")
    for D in fa.BLOCK_K:  # one head dim each instance
        if "serve" in tables:
            out[f"serve_d{D}"] = sweep(SERVE, D, all_splits=True)
        if "walk" in tables:
            out[f"walk_d{D}"] = sweep(WALK, D, all_splits=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
