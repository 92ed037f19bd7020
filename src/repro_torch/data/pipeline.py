"""Deterministic synthetic token pipeline, stateless and resumable: the
counterpart of ``repro/data/pipeline.py``, whose numpy stream it copies.

Every batch is a pure function of (seed, step), so a restarted job
regenerates exactly the token stream it would have seen: no data-loader
state in checkpoints.  The stream mixes Zipfian unigrams with
shifted-repeat structure, so models have something to learn (copy and
induction patterns).  :func:`make_batch_iterator` puts each batch on a
torch device from pinned host memory, one step ahead of the consumer.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Iterator

import numpy as np
import torch

from repro_torch.models.params import resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2
    repeat_period: int = 64           # induction structure
    repeat_prob: float = 0.5


class SyntheticTokens:
    """Batch factory: ``batch_at(step)`` is pure and O(batch) to compute."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        # the Zipf CDF, once (a vocabulary may be 200k)
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        probs = 1.0 / ranks ** cfg.zipf_a
        self._cdf = np.cumsum(probs / probs.sum())

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, step, 0xDA7A]))
        u = rng.random((cfg.global_batch, cfg.seq_len))
        tokens = np.searchsorted(self._cdf, u).astype(np.int32)
        # the second half repeats the first at period offsets, giving
        # induction heads something to learn
        rep = rng.random((cfg.global_batch, 1)) < cfg.repeat_prob
        p = cfg.repeat_period
        if cfg.seq_len >= 2 * p:
            src = tokens[:, :p]
            reps = np.tile(src, (1, cfg.seq_len // p + 1))[:, : cfg.seq_len]
            tokens = np.where(rep, reps, tokens)
        tokens = np.clip(tokens, 0, cfg.vocab_size - 1)
        return {"tokens": tokens}

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def to_device(batch: dict[str, np.ndarray], device: "str | torch.device") -> dict:
    """A host batch as tensors on ``device``: through pinned memory, copied
    without blocking the host, where the device is a card."""
    device = torch.device(device)
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t.to(device)
    return out


def make_batch_iterator(cfg: DataConfig, *, start_step: int = 0,
                        device: "str | torch.device" = "cuda",
                        prefetch: int = 1) -> Iterator[dict[str, torch.Tensor]]:
    """Iterator of device batches from ``start_step`` on, ``prefetch``
    steps ahead: a batch's host generation and its copy overlap the
    device's work on the one before."""
    src = SyntheticTokens(cfg)
    device = resolve_device(device)

    def gen():
        queue: collections.deque = collections.deque()
        step = start_step
        for _ in range(max(1, prefetch)):
            queue.append(to_device(src.batch_at(step), device))
            step += 1
        while True:
            yield queue.popleft()
            queue.append(to_device(src.batch_at(step), device))
            step += 1

    return gen()
