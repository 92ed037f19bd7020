"""Time the rmsnorm kernel at every warps-a-row count, at the widths and row
counts the served configs give it, on one CUDA card:

    PYTHONPATH=src python -m repro_torch.kernels.rmsnorm_sweep [--out sweep.json]

Each row is one call shape: llama's 2048 at a decode step of 8 slots and
the 512 and 1024 prefill buckets, mamba2's 1536 and 3072 at 8 and 600 rows,
hymba's 1600, granite's and yi's 4096, deepseek's 7168 and internvl2's 8192
at 8 rows, and f32 and f16 at 8 x 2048.  Every count of 1, 2, 4 and 8 warps
a row that the kernel takes (at most 16 chunks a thread, or 8 warps) is held
to the plain version and timed beside :func:`rmsnorm.rule_warps`' pick,
``F.rms_norm`` and the per-launch floor (``torch.cuda._sleep(0)``); the
rule is read from this table.  Device time from CUDA events over ``iters``
launches behind a spin kernel, cycling through input sets that exceed the
50 MB L2, as ``chip_smoke.py`` times its rows.  Imports no JAX.
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

from repro_torch.kernels import rmsnorm as rms
from repro_torch.kernels.flash_sweep import time_us

L2_BYTES = 50 * 2**20
#: (rows, D, dtype)
SHAPES = ([(R, 2048, torch.bfloat16) for R in (8, 512, 1024)]
          + [(R, D, torch.bfloat16) for D in (1536, 3072) for R in (8, 600)]
          + [(8, D, torch.bfloat16) for D in (1600, 4096, 7168, 8192)]
          + [(512, 4096, torch.bfloat16), (8, 2048, torch.float32), (8, 2048, torch.float16)])


def sweep(seed: int = 0) -> list[dict]:
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    rows = []
    for R, D, dt in SHAPES:
        per_set = 2 * R * D * torch.empty((), dtype=dt).element_size()
        sets = [(torch.randn((R, D), generator=gen, device=dev).to(dt),
                 torch.randn((D,), generator=gen, device=dev).to(dt))
                for _ in range(max(1, min(64, math.ceil(2 * L2_BYTES / per_set))))]
        want = rms.plain_rmsnorm(*sets[0]).float()
        chunks = -(-D * sets[0][0].element_size() // 16)
        timed = {}
        for warps in rms.WARPS:
            if warps != max(rms.WARPS) and -(-chunks // (32 * warps)) > 16:
                continue                                   # the row does not fit its registers
            got = rms.rmsnorm(*sets[0], warps=warps).float()
            if not torch.allclose(got, want, atol=2e-2, rtol=2e-2):
                raise AssertionError(f"warps {warps} at {(R, D, dt)}: max |diff| "
                                     f"{float((got - want).abs().max())}")
            timed[warps] = time_us(lambda x, w, n=warps: rms.rmsnorm(x, w, warps=n), sets)
        chosen = rms.rule_warps(D, dt)
        best = min(timed, key=timed.get)
        library = time_us(lambda x, w: F.rms_norm(x, (D,), w, 1e-6), sets)
        row = {"rows": R, "D": D, "dtype": str(dt)[6:], "warps_us": timed, "rule": chosen,
               "fastest": best, "rule_over_fastest": timed[chosen] / timed[best],
               "F.rms_norm_us": library}
        rows.append(row)
        print(f"[{R},{D}] {str(dt)[6:]} rule={chosen} fastest={best} "
              f"({timed[chosen] / timed[best]:.3f}x) F.rms_norm {library:.2f} | "
              + " ".join(f"w{n}:{us:.2f}" for n, us in timed.items()), flush=True)
        del sets
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("rmsnorm_sweep: needs a CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"{torch.cuda.get_device_name(0)} ({smi})")
    floor = time_us(lambda: torch.cuda._sleep(0), [()], iters=200)
    print(f"per-launch floor (torch.cuda._sleep(0), back to back): {floor:.3f} us")
    out = {"card": torch.cuda.get_device_name(0), "nvidia_smi": smi, "launch_floor_us": floor,
           "rows": sweep()}
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
