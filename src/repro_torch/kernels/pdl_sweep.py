"""What programmatic dependent launch is worth on the served decode step, on
one CUDA card:

    PYTHONPATH=src python -m repro_torch.kernels.pdl_sweep [--out pdl.json]

The kernels that launch through ``launch_overlapped`` (``csrc/hopper.cuh``:
the matmul, rmsnorm, flash attention and conv2d libraries) ask for
programmatic dependent launch, so that a kernel sets up while the one ahead
finishes.  This script builds a second copy of those libraries with the
request taken out (the header's launch attribute set to 0, in a copy of the
sources under ``build/``), and serves llama3.2-1b at full width and depth
(random weights from ``--seed``, ``cuda-strict``) through a dense engine of
8 slots at T = 0.7 and 8 graphed decode steps a launch, with each copy in
turns (on, off, on, off).  Each arm's engine captures its own decode graph;
the device time of ``--launches`` launches (CUDA events around them, the
uploads and read-backs between launches included) and their wall time are
read a step.  The streams must be equal in every arm.  Imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import torch

from repro_torch.kernels import native

#: the launch attribute that asks for programmatic dependent launch
PDL_REQUEST = "attr[0].val.programmaticStreamSerializationAllowed = 1;"


def overlapped_libraries() -> list[str]:
    """The sources whose kernels launch through ``launch_overlapped``."""
    return [name for name in native.SOURCES
            if "launch_overlapped(" in (native.CSRC / f"{name}.cu").read_text()]


def start_build_without_pdl(libs: list[str]) -> dict[str, tuple[subprocess.Popen, Path]]:
    """Start one ``nvcc`` for each of ``libs`` on a copy of the sources whose
    header asks for no programmatic dependent launch; the processes and
    their libraries."""
    root = native.BUILD_DIR.parent / "pdl_off"
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(native.CSRC, root / "csrc")
    header = root / "csrc" / "hopper.cuh"
    text = header.read_text()
    if text.count(PDL_REQUEST) != 1:
        raise RuntimeError(f"hopper.cuh no longer holds {PDL_REQUEST!r} once")
    header.write_text(text.replace(PDL_REQUEST, PDL_REQUEST.replace("= 1", "= 0")))
    return {name: (subprocess.Popen([native._nvcc(), *native.NVCC_FLAGS, "-o",
                                     str(root / f"lib{name}.so"),
                                     str(root / "csrc" / f"{name}.cu")],
                                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
                   root / f"lib{name}.so")
            for name in libs}


def finish_build(procs: dict[str, tuple[subprocess.Popen, Path]]) -> dict[str, ctypes.CDLL]:
    out = {}
    for name, (proc, path) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}.cu without PDL:\n{log}")
        out[name] = ctypes.CDLL(str(path))
    return out


def use(libs: dict[str, ctypes.CDLL]) -> None:
    """Point the kernel wrappers of these libraries at ``libs``: the
    measurement's own switch, from outside the code it measures."""
    with native._lock:
        native._libs.update(libs)
        for key in [k for k in native._fns if k.split(":")[0] in libs]:
            del native._fns[key]


def serve_arm(model, params, seed: int, launches: int) -> dict:
    """8 prompts through a fresh dense engine (8 slots, T = 0.7, K = 8): the
    prefills and the graph's capture first, then ``launches`` timed launches
    of 8 graphed steps; the times a step and the streams."""
    from repro_torch.core import dispatch
    from repro_torch.serve.engine import ServeEngine

    rng = torch.Generator().manual_seed(seed + 3)
    with dispatch.use(prefer=dispatch.policy_from_flag("cuda-strict")):
        eng = ServeEngine(model, params, batch_slots=8, max_len=1024, device=model.device,
                          temperature=0.7, seed=3, decode_fusion=8)
        for n in (40, 90, 130, 200, 260, 300, 400, 500):
            eng.submit(torch.randint(0, model.cfg.vocab_size, (n,), generator=rng).tolist(),
                       max_new_tokens=1 + 8 * (launches + 1))
        eng.step()                    # the prefills and the capture, outside the timing
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        done = []
        start.record()
        t0 = time.perf_counter()
        for _ in range(launches):
            done += eng.step()
        end.record()
        end.synchronize()
        wall = time.perf_counter() - t0
        done += eng.run_to_completion()
    steps = 8 * launches
    return {"device_ms_a_step": start.elapsed_time(end) / steps,
            "wall_ms_a_step": wall * 1e3 / steps, "captures": eng._graph.captures,
            "streams": [r.generated for r in sorted(done, key=lambda r: r.uid)]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--launches", type=int, default=3)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("pdl_sweep: needs a CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model, init_params

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"{torch.cuda.get_device_name(0)} ({smi})")
    libs = overlapped_libraries()
    procs = start_build_without_pdl(libs)
    arms = {"on": {name: ctypes.CDLL(str(path))
                   for name, path in native.build_all().items() if name in libs},
            "off": finish_build(procs)}
    model = build_model(get_arch("llama3.2-1b"))
    params = init_params(model.param_specs(), args.seed)
    out: dict = {"on": [], "off": []}
    streams = []
    try:
        for arm in ("on", "off", "on", "off"):
            use(arms[arm])
            res = serve_arm(model, params, args.seed, args.launches)
            streams.append(res.pop("streams"))
            out[arm].append(res)
            print(f"{arm}: " + json.dumps(res), flush=True)
    finally:
        use(arms["on"])
    if any(s != streams[0] for s in streams) or len(streams[0]) != 8:
        raise AssertionError("streams differ with programmatic dependent launch on and off")
    res = {"card": torch.cuda.get_device_name(0), "nvidia_smi": smi, "libraries": libs,
           "in_turns": "on, off, on, off", "streams_equal": True, **out}
    print(json.dumps(res))
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
