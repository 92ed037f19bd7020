"""Training launcher: picks the mesh, builds the model and its sharded
training step, and runs the fault-tolerant loop.

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
      --steps 100 --global-batch 8 --seq 256 [--reduced] [--device cpu]

  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
      --arch llama3.2-1b --mesh 2x2 --reduced --device cpu

``--reduced`` swaps in the smoke-scale config of the same family;
``--device cpu`` runs the plain PyTorch versions on the CPU over gloo (the
default is the card, over NCCL, a card a process).  ``--mesh`` (``2x2``:
data x model; ``2x16x16``: pod x data x model) must hold as many devices as
the job has processes: ``torchrun`` starts them and sets ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK`` and the rendezvous; one process alone runs
``1x1``.  Rank 0 prints and writes the checkpoints.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import os
import sys

import torch.distributed as dist

from repro_torch.configs import ARCHS, get_arch, reduced
from repro_torch.data.pipeline import DataConfig, SyntheticTokens, to_device
from repro_torch.dist.sharding import ShardingRules
from repro_torch.launch.mesh import MeshShape, make_mesh, mesh_shape
from repro_torch.launch.specs import pick_opt
from repro_torch.models import build_model
from repro_torch.models.params import tree_flatten_as, tree_leaves
from repro_torch.train.loop import LoopConfig, TrainLoop
from repro_torch.train.step import auto_microbatches, init_train_state, make_train_step


def parse_mesh(spec: str) -> MeshShape:
    """``"2x2"`` -> (data, model); ``"2x16x16"`` -> (pod, data, model)."""
    dims = tuple(int(x) for x in spec.split("x"))
    if len(dims) == 3:
        return mesh_shape(dims, ("pod", "data", "model"))
    return mesh_shape(dims, ("data", "model"))


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True, choices=sorted(ARCHS))
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--mesh", default="1x1")
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-scale config of the same family (CPU runs)")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--microbatches", type=int, default=0,
                    help="0 = auto (activation-budget heuristic)")
    ap.add_argument("--lr", type=float, default=3e-4)
    args = ap.parse_args(argv)
    shape = parse_mesh(args.mesh)
    world = int(os.environ.get("WORLD_SIZE", 1))
    if world != shape.size:
        ap.error(f"--mesh {args.mesh} holds {shape.size} devices and this job has {world} "
                 f"process(es): start it with torchrun --nproc-per-node {shape.size}")

    owns_group = not dist.is_initialized()
    mesh = make_mesh(shape.dims, shape.axis_names, device=args.device)
    try:
        return _train(args, mesh, shape)
    finally:
        if owns_group:
            dist.destroy_process_group()


def _train(args, mesh, shape) -> int:
    log = print if dist.get_rank() == 0 else (lambda *a, **k: None)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    rules = ShardingRules.for_arch(cfg, mesh)
    model = build_model(cfg, device=mesh.device)
    opt = dataclasses.replace(pick_opt(cfg), lr=args.lr, decay_steps=max(args.steps, 10))
    mb = args.microbatches or auto_microbatches(args.global_batch, args.seq, rules, cfg=cfg)
    data = SyntheticTokens(DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                                      global_batch=args.global_batch))
    step, p_shard, o_shard, _ = make_train_step(model, opt, rules,
                                                global_batch=args.global_batch, microbatches=mb)
    params, opt_state = init_train_state(model, opt, rules, seed=0)
    n = sum(math.prod(sh.global_shape(x.shape)) for x, sh in
            zip(tree_leaves(params), tree_flatten_as(params, p_shard)))
    log(f"[train] {cfg.name}: {n / 1e6:.1f}M params, mesh={args.mesh}, device={model.device}, "
        f"microbatches={mb}, opt={opt.kind}")

    loop = TrainLoop(step, lambda s: to_device(data.batch_at(s), model.device), LoopConfig(
        total_steps=args.steps, ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
        log_every=10), log=log, shardings=(p_shard, o_shard), mesh_shape=shape.dims)
    _, _, report = loop.run(params, opt_state)
    log(f"[train] done: {report.steps_run} steps from step {report.resumed_from}, "
        f"loss={report.last_metrics.get('loss', float('nan')):.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
