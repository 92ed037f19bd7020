"""End-to-end training driver: a small llama-family LM on synthetic data,
through the fault-tolerant loop (checkpoint and restart, straggler
watchdog), the training step and the deterministic data pipeline.  The
defaults train a ~25M-parameter model for 200 steps; ``--params 100m
--steps 300`` scales it up.

  PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps N] [--device cpu]

Checkpoints go to ``--ckpt-dir`` (``runs/train_lm`` under the working
directory); a rerun resumes from the newest.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

from repro_torch.configs import ARCHS
from repro_torch.configs.base import ArchConfig
from repro_torch.data.pipeline import DataConfig, SyntheticTokens, to_device
from repro_torch.models import build_model
from repro_torch.models.params import tree_leaves
from repro_torch.optim.adamw import OptConfig
from repro_torch.train.loop import LoopConfig, TrainLoop
from repro_torch.train.step import init_train_state, make_train_step


def small_config(size: str) -> ArchConfig:
    base = ARCHS["llama3.2-1b"]
    if size == "100m":
        return dataclasses.replace(
            base, name="llama-100m", num_layers=8, d_model=768, num_heads=12,
            num_kv_heads=4, d_ff=2048, vocab_size=8192, head_dim=64, remat="none")
    return dataclasses.replace(
        base, name="llama-25m", num_layers=4, d_model=384, num_heads=6,
        num_kv_heads=2, d_ff=1024, vocab_size=4096, head_dim=64, remat="none")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--params", default="25m", choices=["25m", "100m"])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--ckpt-dir", default="runs/train_lm")
    ap.add_argument("--no-ckpt", action="store_true")
    args = ap.parse_args(argv)

    cfg = small_config(args.params)
    model = build_model(cfg, device=args.device)
    opt = OptConfig(kind="adamw", lr=6e-4, warmup_steps=20, decay_steps=args.steps)
    data = SyntheticTokens(DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                                      global_batch=args.batch))
    step = make_train_step(model, opt)
    params, opt_state = init_train_state(model, opt, seed=0)
    n = sum(x.numel() for x in tree_leaves(params))
    print(f"model {cfg.name}: {n / 1e6:.1f}M params on {model.device}")

    loop = TrainLoop(step, lambda s: to_device(data.batch_at(s), model.device), LoopConfig(
        total_steps=args.steps, ckpt_dir=None if args.no_ckpt else args.ckpt_dir,
        ckpt_every=50, log_every=10))
    params, opt_state, report = loop.run(params, opt_state)
    print(f"done: {report.steps_run} steps, final loss "
          f"{report.last_metrics.get('loss', float('nan')):.4f}, "
          f"resumed_from={report.resumed_from}, stragglers={report.stragglers}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
