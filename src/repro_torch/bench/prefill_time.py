"""Device time of one prompt's prefill at full width and depth, on one CUDA
card, under ``cuda-strict`` (every op on the hand-written kernels):

    PYTHONPATH=src python -m repro_torch.bench.prefill_time [--arch hymba-1.5b]
        [--tokens 1400] [--cache-len 2048] [--repeats 5] [--out prefill.json]

Weights and the prompt's tokens come from ``--seed``.  After a warm-up
prefill, each of ``--repeats`` prefills is timed by CUDA events (device
time) and the host clock around it and a synchronise (what a request's
first token waits for, the sampler aside); it prints both, the kernels'
launches a prefill by module, and the matmul edge kernels' device time a
prefill from a profiler trace.  It takes another checkout's package as well
(``PYTHONPATH=<checkout>/src``), so two versions are timed in one call, in
turns.  Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="hymba-1.5b")
    ap.add_argument("--tokens", type=int, default=1400)
    ap.add_argument("--cache-len", type=int, default=2048)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("prefill_time: needs a CUDA device", file=sys.stderr)
        return 2
    from repro_torch import kernels as kernel_pkg
    from repro_torch.configs import get_arch
    from repro_torch.core import dispatch
    from repro_torch.kernels import matmul as mm_k
    from repro_torch.kernels import native
    from repro_torch.models import build_model, init_params

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    native.build_all()
    model = build_model(get_arch(args.arch))
    params = init_params(model.param_specs(), args.seed)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed + 1)
    tokens = torch.randint(0, model.cfg.vocab_size, (1, args.tokens), generator=gen,
                           device="cuda")

    def prefill():
        return model.prefill(params, {"tokens": tokens}, cache_len=args.cache_len)

    with dispatch.use(prefer=dispatch.policy_from_flag("cuda-strict")), torch.no_grad():
        prefill()
        torch.cuda.synchronize()
        counts = {m.__name__.rsplit(".", 1)[1]: m.launches for m in kernel_pkg.modules()}
        edge = mm_k.edge_launches
        device_ms, host_ms = [], []
        for _ in range(args.repeats):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start.record()
            prefill()
            end.record()
            end.synchronize()
            host_ms.append((time.perf_counter() - t0) * 1e3)
            device_ms.append(start.elapsed_time(end))
        launches = {name: (m.launches - counts[name]) // args.repeats
                    for name, m in ((m.__name__.rsplit(".", 1)[1], m)
                                    for m in kernel_pkg.modules())}
        launches["matmul_edge"] = (mm_k.edge_launches - edge) // args.repeats
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            prefill()
            torch.cuda.synchronize()
    by_kernel: dict[str, float] = {}
    for ev in prof.key_averages():
        t = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0)
        if t and "mm_edge" in ev.key:
            by_kernel[ev.key] = by_kernel.get(ev.key, 0.0) + t / 1e3
    res = {"card": torch.cuda.get_device_name(0), "nvidia_smi": smi, "arch": args.arch,
           "tokens": args.tokens, "device_ms": device_ms, "host_ms": host_ms,
           "device_ms_median": statistics.median(device_ms),
           "host_ms_median": statistics.median(host_ms), "launches": launches,
           "edge_kernel_ms_traced": by_kernel, "package": str(Path(kernel_pkg.__file__).parents[1])}
    print(json.dumps(res))
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
