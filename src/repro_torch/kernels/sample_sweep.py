"""Time the sampler kernel at every split count and chain count near its
rule's, at the shapes the served configs give it, on one CUDA card:

    PYTHONPATH=src python -m repro_torch.kernels.sample_sweep [--rule-only] [--out sweep.json]
    PYTHONPATH=src python -m repro_torch.kernels.sample_sweep --against OTHER/src
    PYTHONPATH=src python -m repro_torch.kernels.sample_sweep --ablate

Each row is one ``[B, V]`` of :data:`sample.SHAPES` (a decode step of 8 or
16 slots and a first token over llama's, mamba2's, granite's, yi's,
llama4's, deepseek's and hymba's vocabularies), N(0, 2^2) logits at T =
0.7.  Each configuration is held to the plain version (the tokens wherever
:func:`sample.scores_apart`) and timed beside :func:`sample.splits_for`'s
pick and the per-launch floor; the rule is read from this table.
``--rule-only`` times the wrapper's default alone.  ``--against`` times the
wrapper's default of another checkout's ``src`` and of this one, each in a
process of its own, in the order other, this, this, other (two versions
compared only within one command).  ``--ablate`` times the kernel with
one of its parts taken out (:data:`ABLATIONS`, each an edit of a copy of
``csrc/sample.cu``) between two runs of the kernel as built, at
:data:`ABLATE_SHAPES`.  Device time from CUDA events over 30
launches behind a spin kernel (``flash_sweep.time_us``), cycling through
input sets that exceed the 50 MB L2.  Imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import torch

from repro_torch.kernels import sample as sample_k
from repro_torch.kernels.flash_sweep import time_us
from repro_torch.serve import sampling

L2_BYTES = 50 * 2**20
T = 0.7
ITERS = 30
#: the kernel's parts, each taken out by one edit of its source: the
#: pre-test (every element takes the exact path; the tokens stay the plain
#: version's), and, timed only (the tokens no longer are), the merge (each
#: block writes its own best) and the Threefry hash (the bits the counter)
ABLATIONS = {
    "no_pretest": ("if (ok[e / 4] && !(ub[e] < thr))", "if (ok[e / 4])"),
    "no_merge": ("if (splits == 1) {", "if (true) {"),
    "no_hash": ("    threefry<N>(sk, x0, x1);\n", ""),
}
ABLATE_SHAPES = ((8, 128256), (16, 128256), (1, 128256), (1, 32001), (8, 32001))


def input_sets(B: int, V: int, gen: torch.Generator) -> list[tuple]:
    """Enough (logits, keys, counts, live, tok) sets at ``[B, V]`` to exceed
    twice the L2."""
    dev = gen.device
    return [(torch.randn((B, V), generator=gen, device=dev) * 2,
             torch.randint(-2**31, 2**31 - 1, (B, 2), generator=gen, device=dev,
                           dtype=torch.int32),
             torch.randint(0, 1000, (B,), generator=gen, device=dev, dtype=torch.int32),
             torch.ones(B, dtype=torch.int32, device=dev),
             torch.zeros(B, dtype=torch.int32, device=dev))
            for _ in range(max(1, min(64, math.ceil(2 * L2_BYTES / (4 * B * V)))))]


def time_rule(shapes, seed: int = 0) -> list[dict]:
    """µs of the wrapper's default call at each ``[B, V]``, unchecked (it
    runs the sampler of whichever checkout is on ``PYTHONPATH``)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [{"B": B, "V": V, "rule_us": time_us(lambda *a: sample_k.sample(*a, T),
                                                input_sets(B, V, gen), ITERS)}
            for B, V in shapes]


def sweep(rule_only: bool, seed: int = 0) -> list[dict]:
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rows = []
    for B, V in sample_k.SHAPES:
        sets = input_sets(B, V, gen)
        logits, keys, counts, live, _ = sets[0]
        scores = sampling.scores(keys, counts, logits, T)
        want, apart = torch.argmax(scores, dim=-1).to(torch.int32), sample_k.scores_apart(scores)
        rule = sample_k.splits_for(B, V)
        configs = {"rule": {}}
        if not rule_only:
            cap = sample_k.MAX_SPLITS
            configs = {(c, s): {"chains": c, "splits": s} for c in sample_k.CHAINS
                       for s in sorted({max(1, rule // 2), rule, min(cap, 2 * rule),
                                        min(cap, 4 * rule)})}
        timed = {}
        for name, kw in configs.items():
            tok = torch.zeros(B, dtype=torch.int32, device="cuda")
            sample_k.sample(logits, keys, counts, live, tok, T, **kw)
            if not torch.equal(tok[apart], want[apart]):
                raise AssertionError(f"{name} at [{B},{V}]: tokens {tok.tolist()}, the plain "
                                     f"version's {want.tolist()}")
            timed[name] = time_us(lambda *a, kw=kw: sample_k.sample(*a, T, **kw), sets, ITERS)
        row = {"B": B, "V": V, "rule_splits": rule}
        if rule_only:
            row["rule_us"] = timed["rule"]
        else:
            chosen = (sample_k.chains_for(V, rule), rule)
            best = min(timed, key=timed.get)
            row.update({"rule_chains": chosen[0],
                        "us": {f"chains{c} splits{s}": us for (c, s), us in timed.items()},
                        "rule_us": timed[chosen], "fastest": f"chains{best[0]} splits{best[1]}",
                        "rule_over_fastest": timed[chosen] / timed[best]})
        rows.append(row)
        print(json.dumps(row), flush=True)
        del sets
    return rows


def build_ablations() -> dict:
    """One library of the sampler for each of :data:`ABLATIONS`, built from
    an edited copy of the sources (one ``nvcc`` each, all at once)."""
    import shutil

    from repro_torch.kernels import native

    procs = {}
    for name, (old, new) in ABLATIONS.items():
        root = native.BUILD_DIR.parent / f"sample_{name}"
        shutil.rmtree(root, ignore_errors=True)
        shutil.copytree(native.CSRC, root / "csrc")
        src = root / "csrc" / "sample.cu"
        text = src.read_text()
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: sample.cu no longer holds {old!r} once")
        src.write_text(text.replace(old, new))
        procs[name] = (subprocess.Popen([native._nvcc(), *native.NVCC_FLAGS, "-o",
                                         str(root / "libsample.so"), str(src)],
                                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), root / "libsample.so")
    libs = {}
    for name, (proc, path) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on sample.cu {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(path))
    return libs


def ablate(seed: int = 0) -> list[dict]:
    """µs of the sampler's default call at :data:`ABLATE_SHAPES`, built as
    is (``base``, before and after the rest) and with each of
    :data:`ABLATIONS` taken out; ``no_pretest`` is held to the plain
    version too."""
    from repro_torch.kernels import native
    from repro_torch.kernels.pdl_sweep import use

    base = ctypes.CDLL(str(native.build_all()["sample"]))
    libs = build_ablations()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rows = []
    for B, V in ABLATE_SHAPES:
        sets = input_sets(B, V, gen)
        logits, keys, counts, live, _ = sets[0]
        scores = sampling.scores(keys, counts, logits, T)
        want, apart = torch.argmax(scores, dim=-1).to(torch.int32), sample_k.scores_apart(scores)
        us = {}
        for name, lib in (("base", base), *libs.items(), ("base2", base)):
            use({"sample": lib})
            tok = torch.zeros(B, dtype=torch.int32, device="cuda")
            sample_k.sample(logits, keys, counts, live, tok, T)
            if name in ("base", "base2", "no_pretest") and not torch.equal(tok[apart],
                                                                            want[apart]):
                raise AssertionError(f"{name} at [{B},{V}]: tokens {tok.tolist()}, the plain "
                                     f"version's {want.tolist()}")
            us[name] = time_us(lambda *a: sample_k.sample(*a, T), sets, ITERS)
        use({"sample": base})
        row = {"B": B, "V": V, "us": us}
        rows.append(row)
        print(json.dumps(row), flush=True)
        del sets
    return rows


def against(other: Path) -> list[dict]:
    """:func:`time_rule` at :data:`sample.SHAPES` for ``other`` (a
    checkout's ``src``) and this checkout, in processes of their own in the
    order other, this, this, other; a row a shape with both runs of each
    and their ratio (other over this, the mean of each pair)."""
    this = Path(__file__).resolve().parents[2]
    runs = []
    for name, src in (("other", other), ("this", this), ("this", this), ("other", other)):
        out = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--time-only",
             json.dumps(sample_k.SHAPES)],
            env={**os.environ, "PYTHONPATH": str(src)}, capture_output=True, text=True,
            check=True, timeout=600).stdout
        runs.append((name, json.loads(out.strip().splitlines()[-1])))
    rows = []
    for i, (B, V) in enumerate(sample_k.SHAPES):
        us = {"other": [], "this": []}
        for name, got in runs:
            us[name].append(got[i]["rule_us"])
        row = {"B": B, "V": V, "other_us": us["other"], "this_us": us["this"],
               "other_over_this": sum(us["other"]) / sum(us["this"])}
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rule-only", action="store_true",
                    help="time the wrapper's default call alone")
    ap.add_argument("--against", type=Path, default=None,
                    help="another checkout's src: time its sampler and this one's, alternately")
    ap.add_argument("--ablate", action="store_true",
                    help="time the kernel with each of its parts taken out")
    ap.add_argument("--time-only", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("sample_sweep: needs a CUDA device", file=sys.stderr)
        return 2
    if args.time_only is not None:      # a child of --against
        print(json.dumps(time_rule([tuple(s) for s in json.loads(args.time_only)])))
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"{torch.cuda.get_device_name(0)} ({smi}); sampler from {sample_k.__file__}")
    floor = time_us(lambda: torch.cuda._sleep(0), [()], iters=200)
    print(f"per-launch floor (torch.cuda._sleep(0), back to back): {floor:.3f} us")
    out = {"card": torch.cuda.get_device_name(0), "nvidia_smi": smi, "launch_floor_us": floor,
           "sampler": sample_k.__file__,
           "rows": (against(args.against.resolve()) if args.against is not None
                    else ablate() if args.ablate else sweep(args.rule_only))}
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
