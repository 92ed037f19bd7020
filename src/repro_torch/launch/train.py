"""Training launcher: builds the model and its training step and runs the
fault-tolerant loop on one device.

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
      --steps 100 --global-batch 8 --seq 256 [--reduced] [--device cpu]

``--reduced`` swaps in the smoke-scale config of the same family;
``--device cpu`` runs the plain PyTorch versions on the CPU (the default is
the card).  A ``--mesh`` other than ``1x1`` is refused: sharded training
waits for the port's distribution (ROADMAP §1, item 5).
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

from repro_torch.configs import ARCHS, get_arch, reduced
from repro_torch.data.pipeline import DataConfig, SyntheticTokens, to_device
from repro_torch.launch.specs import pick_opt
from repro_torch.models import build_model
from repro_torch.models.params import tree_leaves
from repro_torch.train.loop import LoopConfig, TrainLoop
from repro_torch.train.step import auto_microbatches, init_train_state, make_train_step


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
    if args.mesh != "1x1":
        ap.error(f"--mesh {args.mesh}: the port trains on one device; sharded training waits "
                 f"for its distribution (ROADMAP §1, item 5)")

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    model = build_model(cfg, device=args.device)
    opt = dataclasses.replace(pick_opt(cfg), lr=args.lr, decay_steps=max(args.steps, 10))
    mb = args.microbatches or auto_microbatches(args.global_batch, args.seq, cfg=cfg)
    data = SyntheticTokens(DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                                      global_batch=args.global_batch))
    step = make_train_step(model, opt, microbatches=mb)
    params, opt_state = init_train_state(model, opt)
    n = sum(x.numel() for x in tree_leaves(params))
    print(f"[train] {cfg.name}: {n / 1e6:.1f}M params, device={model.device}, "
          f"microbatches={mb}, opt={opt.kind}")

    loop = TrainLoop(step, lambda s: to_device(data.batch_at(s), model.device), LoopConfig(
        total_steps=args.steps, ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
        log_every=10))
    _, _, report = loop.run(params, opt_state)
    print(f"[train] done: {report.steps_run} steps from step {report.resumed_from}, "
          f"loss={report.last_metrics.get('loss', float('nan')):.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
