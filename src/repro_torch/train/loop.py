"""The fault-tolerant training loop: the counterpart of
``repro/train/loop.py``.

- **Checkpoint and restart**: atomic checkpoints every ``ckpt_every``
  steps; on start, resume from the newest valid checkpoint (the data
  pipeline regenerates its stream from the step counter: no loader state).
- **Preemption**: SIGTERM or SIGINT checkpoint the state after the step in
  flight, then the loop returns (a scheduler's eviction notice).
- **Straggler watchdog**: each step's wall time against an EWMA of the
  steps before; a step slower than ``straggler_factor`` times it is logged
  and listed in the report.
- **NaN guard**: a non-finite loss raises with the last good checkpoint
  intact (a poisoned state is never checkpointed).

A step's time is read after its loss is on the host, so it spans the
device's work.
"""

from __future__ import annotations

import dataclasses
import math
import signal
import time
from typing import Any, Callable

from repro_torch.checkpoint.checkpoint import latest_checkpoint, restore_checkpoint, save_checkpoint


@dataclasses.dataclass
class LoopConfig:
    total_steps: int
    ckpt_dir: str | None = None
    ckpt_every: int = 100
    keep: int = 3
    log_every: int = 10
    straggler_factor: float = 3.0
    ewma_alpha: float = 0.2


@dataclasses.dataclass
class LoopReport:
    steps_run: int = 0
    resumed_from: int = 0
    stragglers: list[int] = dataclasses.field(default_factory=list)
    last_metrics: dict = dataclasses.field(default_factory=dict)
    step_times_s: list[float] = dataclasses.field(default_factory=list)
    preempted: bool = False


class TrainLoop:
    def __init__(self, step_fn: Callable[..., tuple[Any, Any, dict]],
                 batch_at: Callable[[int], dict], cfg: LoopConfig, *,
                 log: Callable[[str], None] = print, shardings: Any = None,
                 mesh_shape: tuple[int, ...] = ()):
        """``shardings``: the (params, opt_state) placements of a sharded
        step, whose checkpoints are then written whole by rank 0 and
        restored into each rank's slices; ``mesh_shape`` goes in their
        manifests."""
        self.step_fn = step_fn
        self.batch_at = batch_at
        self.cfg = cfg
        self.log = log
        self.shardings = shardings
        self.mesh_shape = tuple(mesh_shape)
        self._preempt = False

    def _install_handlers(self) -> dict:
        def handler(signum, frame):
            self._preempt = True
        prev = {}
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                prev[sig] = signal.signal(sig, handler)
            except ValueError:          # not the main thread (tests)
                pass
        return prev

    def _restore_handlers(self, prev: dict) -> None:
        for sig, h in prev.items():
            signal.signal(sig, h)

    def run(self, params, opt_state) -> tuple[Any, Any, LoopReport]:
        cfg = self.cfg
        report = LoopReport()
        start_step = 0

        if cfg.ckpt_dir:
            path = latest_checkpoint(cfg.ckpt_dir)
            if path is not None:
                (params, opt_state), manifest = restore_checkpoint(path, (params, opt_state),
                                                                   shardings=self.shardings)
                start_step = int(manifest["step"])
                report.resumed_from = start_step
                self.log(f"[loop] resumed from {path} at step {start_step}")

        prev_handlers = self._install_handlers()
        ewma = None
        try:
            for step in range(start_step, cfg.total_steps):
                t0 = time.perf_counter()
                batch = self.batch_at(step)
                params, opt_state, metrics = self.step_fn(params, opt_state, batch)
                loss = float(metrics["loss"])
                dt = time.perf_counter() - t0
                report.step_times_s.append(dt)
                report.steps_run += 1
                report.last_metrics = {k: float(v.float().mean()) if hasattr(v, "float")
                                       else float(v) for k, v in metrics.items()}

                if not math.isfinite(loss):
                    raise FloatingPointError(
                        f"non-finite loss at step {step}; last checkpoint intact")

                # straggler watchdog
                if ewma is None:
                    ewma = dt
                elif dt > cfg.straggler_factor * ewma and step > start_step + 2:
                    report.stragglers.append(step)
                    self.log(f"[loop] straggler suspected: step {step} took {dt:.3f}s vs "
                             f"EWMA {ewma:.3f}s")
                ewma = cfg.ewma_alpha * dt + (1 - cfg.ewma_alpha) * ewma

                if cfg.log_every and step % cfg.log_every == 0:
                    self.log(f"[loop] step {step} loss {loss:.4f} ({dt * 1e3:.0f} ms)")

                done = step + 1
                if cfg.ckpt_dir and (done % cfg.ckpt_every == 0 or done == cfg.total_steps
                                     or self._preempt):
                    save_checkpoint(cfg.ckpt_dir, done, (params, opt_state), keep=cfg.keep,
                                    mesh_shape=self.mesh_shape, shardings=self.shardings)
                if self._preempt:
                    report.preempted = True
                    self.log(f"[loop] preemption: checkpointed at step {done}")
                    break
        finally:
            self._restore_handlers(prev_handlers)
        return params, opt_state, report
