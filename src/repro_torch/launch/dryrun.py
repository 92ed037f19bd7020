"""The dry run: every (arch x shape x mesh) cell's step counted on meta
tensors, one rank of the production mesh; the counterpart of
``repro/launch/dryrun.py``.

JAX lowers and compiles each cell over 512 placeholder host devices and
reads the compiled program's memory and cost analyses.  The port runs one
rank's step itself: rank 0 of a 16x16 (or 2x16x16) mesh under torch's
``fake`` process-group backend (collectives issue nothing and return at
once), on ``meta`` parameters, optimizer state, batch and cache of the
rank's local shapes, through the same step functions the card runs
(``make_train_step`` with ``auto_microbatches``, ``make_prefill_step``,
``make_decode_step``), serving rules for inference cells as JAX's.  The
:class:`~repro_torch.roofline.analysis.CostCounter` counts the step's
FLOPs, bytes, collectives and peak of live bytes.  The record has JAX's
keys: ``memory.argument_bytes`` are the local leaves' bytes exactly (and
the inputs'), ``output_bytes`` the step's outputs', ``alias_bytes`` those
of outputs that are inputs updated in place (the decode cache),
``temp_bytes`` the counter's peak above the arguments, and ``code_bytes``
0 (the kernels are built once for every step, not per program as XLA's);
``lower_s`` is the set-up's seconds and ``compile_s`` the meta run's.

Usage (the CPU; no card, no network):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-9b --shape decode_32k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--both-meshes] [--out f.json]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback
from typing import Any, Iterator

import torch
import torch.distributed as dist

from repro_torch.configs import ARCHS, SHAPES, cell_supported, get_arch, get_shape
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.dist.sharding import ShardingRules
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.launch.specs import abstract_opt_state, batch_specs, decode_specs, pick_opt
from repro_torch.models import build_model
from repro_torch.models.params import (abstract_params, refresh_derived, trainable,
                                       tree_leaves)
from repro_torch.roofline.analysis import CostCounter, roofline_terms


@contextlib.contextmanager
def fake_group(world_size: int, rank: int = 0) -> Iterator[None]:
    """This process as ``rank`` of a ``world_size``-rank job under the
    ``fake`` backend, destroyed again on the way out, whatever happens."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group exists: the dry run needs its own")
    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def mesh_name(mesh) -> str:
    return "x".join(str(n) for n in mesh.dims)


def _tensors(tree: Any) -> list[torch.Tensor]:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _bytes(tree: Any) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


def count_step(cfg: ArchConfig, shape: ShapeConfig, rules: ShardingRules, *,
               microbatches: int = 1, opt_cfg=None) -> dict:
    """Run the cell's step once on meta tensors under a
    :class:`CostCounter`; return the counter and the arguments' and
    outputs' bytes.  ``rules`` are on a live mesh (``fake_group``); a
    train step's optimizer is ``opt_cfg``, ``pick_opt(cfg)`` by default."""
    from repro_torch.serve.engine import make_decode_step, make_prefill_step
    from repro_torch.train.step import make_train_step

    model = build_model(cfg, device="cpu")
    specs = model.param_specs()
    p_shard = rules.sharding_tree(specs)
    params = abstract_params(specs, p_shard)
    args: dict[str, Any] = {}
    if shape.kind == "train":
        opt_cfg = opt_cfg or pick_opt(cfg)
        step, _, _, _ = make_train_step(model, opt_cfg, rules, global_batch=shape.global_batch,
                                        microbatches=microbatches)
        params = trainable(params)
        state = abstract_opt_state(opt_cfg, params, p_shard)
        batch = batch_specs(cfg, shape)
        args = {"params": params, "opt_state": state, "inputs": batch}
        run = lambda: step(params, state, batch)              # noqa: E731
    elif shape.kind == "prefill":
        step, _, _ = make_prefill_step(model, rules, global_batch=shape.global_batch)
        params = refresh_derived(params)
        batch = batch_specs(cfg, shape)
        args = {"params": params, "opt_state": {}, "inputs": batch}
        run = lambda: step(params, batch)                     # noqa: E731
    else:
        step, _, c_shard, _ = make_decode_step(model, rules, global_batch=shape.global_batch,
                                               cache_len=shape.seq_len)
        params = refresh_derived(params)
        tokens, cache = decode_specs(cfg, shape, model, c_shard)
        args = {"params": params, "opt_state": {}, "inputs": {"tokens": tokens, **cache}}
        run = lambda: step(params, tokens, cache)             # noqa: E731
    t0 = time.perf_counter()
    with CostCounter() as counter:
        out = run()
    seconds = time.perf_counter() - t0
    ins = {id(t) for t in _tensors(args)}
    outs = _tensors(out)
    return {"counter": counter, "seconds": seconds,
            "param_bytes": _bytes(args["params"]), "opt_state_bytes": _bytes(args["opt_state"]),
            "input_bytes": _bytes(args["inputs"]),
            "output_bytes": _bytes(outs), "alias_bytes": _bytes([t for t in outs if id(t) in ins])}


def cell_record(arch_name: str, cfg: ArchConfig, shape: ShapeConfig, rules: ShardingRules,
                mesh_label: str, *, lower_s: float, with_cost: bool, microbatches: int) -> dict:
    """One counted cell's record (JAX's keys) on a live mesh."""
    res = count_step(cfg, shape, rules, microbatches=microbatches)
    c = res["counter"]
    direct = {"flops": c.flops, "bytes": c.bytes, "coll": c.collective_bytes}
    extrap = None
    if with_cost:
        from repro_torch.roofline.extrapolate import extrapolated_costs

        extrap = extrapolated_costs(cfg, shape, rules, microbatches=microbatches)
    chips = rules.mesh.size
    arguments = res["param_bytes"] + res["opt_state_bytes"] + res["input_bytes"]
    return {
        "arch": arch_name,
        "shape": shape.name,
        "mesh": mesh_label,
        "status": "ok",
        "chips": chips,
        "kind": shape.kind,
        "lower_s": round(lower_s, 1),
        "compile_s": round(res["seconds"], 1),
        "microbatches": microbatches,
        "flops_per_device": c.flops,
        "bytes_per_device": c.bytes,
        "collective_bytes_per_device": c.collective_bytes,
        "nic_bytes_per_device": c.nic_bytes,
        # no scan: the direct count is what JAX's scanned module would read
        "scan_measured": direct,
        "extrapolation": extrap,
        "collectives": {k: v for k, v in c.collectives.items() if v},
        "collective_counts": {k: v for k, v in c.collective_counts.items() if v},
        "memory": {
            "argument_bytes": arguments,
            "param_bytes": res["param_bytes"],
            "opt_state_bytes": res["opt_state_bytes"],
            "input_bytes": res["input_bytes"],
            "output_bytes": res["output_bytes"],
            "temp_bytes": c.peak_bytes,
            "alias_bytes": res["alias_bytes"],
            "code_bytes": 0,
        },
        "roofline": roofline_terms(
            flops_per_device=c.flops, bytes_per_device=c.bytes,
            collective_bytes_per_device=c.collective_bytes, cfg=cfg, shape=shape, chips=chips,
            nic_bytes_per_device=c.nic_bytes),
    }


def lower_cell(arch_name: str, shape_name: str, *, multi_pod: bool,
               verbose: bool = True, with_cost: bool = True) -> dict:
    """Count rank 0 of the production mesh running the cell's step; a
    ``skip`` record where ``cell_supported`` says so.  The fake group is
    made and destroyed here."""
    from repro_torch.train.step import auto_microbatches

    cfg = get_arch(arch_name)
    shape = get_shape(shape_name)
    shape_mesh = make_production_mesh(multi_pod=multi_pod)
    label = mesh_name(shape_mesh)
    ok, why = cell_supported(cfg, shape)
    if not ok:
        return {"arch": arch_name, "shape": shape_name, "mesh": label, "status": "skip",
                "reason": why}
    t0 = time.perf_counter()
    with fake_group(shape_mesh.size):
        mesh = make_mesh(shape_mesh.dims, shape_mesh.axis_names, device="cpu")
        # inference cells deploy with serving rules: TP-resident weights, no FSDP
        rules = ShardingRules.for_arch(cfg, mesh, serving=shape.kind != "train")
        mb = (auto_microbatches(shape.global_batch, shape.seq_len, rules, cfg=cfg)
              if shape.kind == "train" else 1)
        record = cell_record(arch_name, cfg, shape, rules, label,
                             lower_s=time.perf_counter() - t0,
                             with_cost=with_cost and not multi_pod, microbatches=mb)
    if verbose:
        r, m = record["roofline"], record["memory"]
        print(f"[dryrun] {arch_name} x {shape_name} x {label}: meta run "
              f"{record['compile_s']:.1f}s, compute {r['compute_s'] * 1e3:.2f}ms mem "
              f"{r['memory_s'] * 1e3:.2f}ms coll {r['collective_s'] * 1e3:.2f}ms -> "
              f"{r['bottleneck']} (args {m['argument_bytes'] / 2**30:.2f} GiB/dev, temp "
              f"{m['temp_bytes'] / 2**30:.2f} GiB/dev)", flush=True)
    return record


def count_on_one_rank(cfg: ArchConfig, shape: ShapeConfig, *, microbatches: int = 1) -> dict:
    """A cell counted at a 1x1 mesh (one card's step; ``chip_smoke.py``'s
    dry-run phase): its record, under a fake group of one made here."""
    with fake_group(1):
        mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
        rules = ShardingRules.for_arch(cfg, mesh, serving=shape.kind != "train")
        return cell_record(cfg.name, cfg, shape, rules, "1x1", lower_s=0.0, with_cost=False,
                           microbatches=microbatches)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    cells: list[tuple[str, str, bool]] = []
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    if args.all:
        for arch in sorted(ARCHS):
            for shape in SHAPES:
                for mp in meshes:
                    cells.append((arch, shape, mp))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        for mp in meshes:
            cells.append((args.arch, args.shape, mp))

    results = []
    out_path = args.out
    if out_path and os.path.exists(out_path):
        with open(out_path) as f:
            results = json.load(f)
    done = {(r["arch"], r["shape"], r["mesh"]) for r in results}

    failures = 0
    t0 = time.perf_counter()
    for arch, shape, mp in cells:
        key = (arch, shape, "2x16x16" if mp else "16x16")
        if key in done:
            continue
        try:
            rec = lower_cell(arch, shape, multi_pod=mp)
        except Exception as e:  # a failure here is a bug in the system
            traceback.print_exc()
            rec = {"arch": arch, "shape": shape, "mesh": key[2], "status": "fail",
                   "error": str(e)[-2000:]}
            failures += 1
        results.append(rec)
        if out_path:
            tmp = out_path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(results, f, indent=1)
            os.replace(tmp, out_path)

    n_ok = sum(1 for r in results if r["status"] == "ok")
    n_skip = sum(1 for r in results if r["status"] == "skip")
    print(f"[dryrun] ok={n_ok} skip={n_skip} fail={failures} in "
          f"{time.perf_counter() - t0:.1f} s")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
