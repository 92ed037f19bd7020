"""Serving: the batched dense engine, the dense slice of ``repro/serve/engine.py``.

The :class:`ServeEngine` implements continuous-batching-lite over fixed
slots: requests join free slots, each prompt is prefilled on its own, all
live slots decode in lock-step, and finished slots are recycled.

**Prompt bucketing**: prompts are end-padded to power-of-two lengths (as the
JAX engine does to hit its jit trace cache), and one decode step of the last
prompt token at its true position re-derives the first token's logits.

**Fused multi-token decode** (``decode_fusion=K``): one launch runs K decode
steps with on-device greedy sampling and per-slot masks, and the host reads
the tokens back once per launch.  A slot whose budget runs out mid-launch
freezes its position and token; its cache rows keep absorbing dummy writes
at the frozen position, harmless because the next prefill into that slot
replaces its whole ``max_len`` row range.

Greedy decoding only: temperature sampling needs the JAX engine's
position-indexed threefry stream to match it token for token (ROADMAP
item 8b).  Launches run directly, not through an HSA queue (ROADMAP item 6).
"""

from __future__ import annotations

import dataclasses
import threading

import numpy as np
import torch

from repro_torch.core.hsa.clock import WallClock
from repro_torch.models.params import resolve_device


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray                 # [S] int32
    max_new_tokens: int
    generated: list[int] = dataclasses.field(default_factory=list)
    done: bool = False
    # engine-clock timestamps (None until the event happens): arrival at
    # submit, first generated token, completion — the TTFT/TPOT feed
    arrival_t: float | None = None
    first_token_t: float | None = None
    finish_t: float | None = None


class ServeTruncated(RuntimeError):
    """``run_to_completion`` exhausted ``max_steps`` with work still pending.

    Carries the partial result — ``done`` and ``pending`` (active slots and
    queued requests) — so callers can't mistake truncation for completion.
    """

    def __init__(self, done: list[Request], pending: list[Request]) -> None:
        self.done = done
        self.pending = pending
        super().__init__(
            f"serving truncated at max_steps: {len(done)} requests done, "
            f"{len(pending)} pending"
        )


class ServeEngine:
    """Fixed-slot batched greedy decoder with slot recycling.

    The dense KV cache ``[L, slots, Hkv, max_len, hd]`` lives on ``device``
    and is updated in place: prefill copies a request's cache into its slot,
    decode writes each new token's k/v at its slot's position.
    """

    #: the smallest prompt bucket (buckets are powers of two up to max_len)
    MIN_BUCKET = 8

    def __init__(self, model, params, *, batch_slots: int = 4, max_len: int = 256,
                 temperature: float = 0.0, decode_fusion: int = 1,
                 device: "str | torch.device" = "cuda"):
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model is on {model.device}, engine on {self.device}")
        if temperature > 0:
            raise NotImplementedError(
                "temperature sampling is ROADMAP item 8b (position-indexed "
                "threefry sampling to match the JAX engine); serve greedily"
            )
        if not isinstance(decode_fusion, int) or decode_fusion < 1:
            raise ValueError(f"decode_fusion must be an int >= 1, got {decode_fusion!r}")
        self.model = model
        self.params = params
        self.slots = batch_slots
        self.max_len = max_len
        self.decode_fusion = decode_fusion
        self._queue: list[Request] = []
        self._active: dict[int, Request] = {}      # slot -> request
        self._uid = 0
        self._cache: dict | None = None
        self._pos = np.zeros(batch_slots, np.int64)
        self._slot_tok = np.zeros(batch_slots, np.int32)
        self.clock = WallClock()
        # model calls by kind: the launch counts of a run follow from these
        self.prefill_calls = 0
        self.fixup_calls = 0
        self.decode_calls = 0
        self.decode_tokens = 0         # tokens committed by decode launches
        # submit() may run on feeder threads while step() is mid-flight
        self._lock = threading.RLock()

    def submit(self, prompt: list[int], max_new_tokens: int = 32) -> int:
        """Queue a request; its uid."""
        with self._lock:
            if len(prompt) == 0 or len(prompt) + max_new_tokens > self.max_len:
                raise ValueError(
                    f"prompt ({len(prompt)}) + max_new_tokens ({max_new_tokens}) must "
                    f"fit max_len={self.max_len}, with a non-empty prompt"
                )
            self._uid += 1
            req = Request(self._uid, np.asarray(prompt, np.int32), max_new_tokens)
            req.arrival_t = self.clock.now()
            self._queue.append(req)
            return self._uid

    @classmethod
    def bucket_len(cls, n: int, max_len: int) -> int:
        """The prefill length of an ``n``-token prompt: the next power of two
        at least ``MIN_BUCKET``, capped at ``max_len``."""
        b = cls.MIN_BUCKET
        while b < n:
            b *= 2
        return min(b, max_len)

    # -- internals ------------------------------------------------------------

    def _prefill_slot(self, slot: int, req: Request) -> None:
        n = len(req.prompt)
        pad = max(0, self.bucket_len(n, self.max_len) - n)
        tokens = np.pad(req.prompt, (0, pad)) if pad else req.prompt
        logits, cache = self.model.prefill(
            self.params, {"tokens": torch.as_tensor(tokens[None, :], device=self.device)},
            cache_len=self.max_len,
        )
        self.prefill_calls += 1
        if pad:
            # end-padding is causally inert for the cached prompt positions
            # (decode masks by pos), but prefill's logits sit at a pad
            # position.  Re-derive the first token's logits with one decode
            # step of the last prompt token at its true position, and keep
            # the *prefill* cache verbatim: decode writes row n-1 in place, so
            # it runs on a copy of rows [0, n) that is then dropped.
            fix_cache = {
                "pos": torch.tensor([n - 1], dtype=torch.int32, device=self.device),
                "k": cache["k"][:, :, :, :n].clone(),
                "v": cache["v"][:, :, :, :n].clone(),
            }
            logits, _ = self.model.decode_step(
                self.params, torch.as_tensor(req.prompt[-1:][None, :], device=self.device),
                fix_cache,
            )
            self.fixup_calls += 1
        tok = int(torch.argmax(logits[0]))
        req.generated.append(tok)
        self._slot_tok[slot] = tok
        if self._cache is None:
            specs = self.model.cache_specs(self.slots, self.max_len)
            self._cache = {key: torch.zeros(specs[key].shape, dtype=specs[key].dtype,
                                            device=self.device) for key in ("k", "v")}
        # the slot's whole max_len row range: it also erases the dummy writes
        # a masked slot absorbed during fused decode
        for key in ("k", "v"):
            self._cache[key][:, slot] = cache[key][:, 0]
        self._pos[slot] = n

    def _choose_fusion(self) -> int:
        remaining = [r.max_new_tokens - len(r.generated) for r in self._active.values()]
        # never run past every live slot's budget: those steps are all-masked
        return max(1, min(self.decode_fusion, max(remaining, default=1)))

    def _fused_decode(self, k: int, active: np.ndarray, remaining: np.ndarray):
        """``k`` masked decode steps over all slots with on-device greedy
        sampling; the tokens [k, slots] and their validity mask, read back
        once."""
        dev = self.device
        pos = torch.as_tensor(self._pos.astype(np.int32), device=dev)
        tok = torch.as_tensor(self._slot_tok, device=dev)
        live = torch.as_tensor(active, device=dev)
        left = torch.as_tensor(remaining, device=dev)
        toks, valid = [], []
        for _ in range(k):
            cache = {"pos": pos, "k": self._cache["k"], "v": self._cache["v"]}
            logits, _ = self.model.decode_step(self.params, tok[:, None], cache)
            self.decode_calls += 1
            tok = torch.where(live, torch.argmax(logits, dim=-1).to(torch.int32), tok)
            toks.append(tok)
            valid.append(live)
            pos = torch.where(live, pos + 1, pos)
            left = torch.where(live, left - 1, left)
            live = live & (left > 0)
        self._pos = pos.cpu().numpy().astype(np.int64)
        self._slot_tok = tok.cpu().numpy()
        return torch.stack(toks).cpu().numpy(), torch.stack(valid).cpu().numpy()

    def _decode_locked(self) -> list[Request]:
        k = self._choose_fusion()
        remaining = np.zeros(self.slots, np.int32)
        active = np.zeros(self.slots, bool)
        for slot, req in self._active.items():
            self._slot_tok[slot] = req.generated[-1]
            remaining[slot] = req.max_new_tokens - len(req.generated)
            active[slot] = remaining[slot] > 0
        toks, valid = self._fused_decode(k, active, remaining)
        self.decode_tokens += int(valid.sum())
        finished = []
        for slot, req in list(self._active.items()):
            req.generated.extend(int(t) for t in toks[valid[:, slot], slot])
            if len(req.generated) >= req.max_new_tokens:
                req.done = True
                finished.append(req)
                del self._active[slot]
        return finished

    # -- public loop ------------------------------------------------------------

    def step(self) -> list[Request]:
        """Admit queued requests into free slots (one prefill each), then
        decode up to ``decode_fusion`` tokens for all live slots.

        Returns requests completed this step.
        """
        with self._lock:
            first: list[Request] = []
            for slot in range(self.slots):
                if slot in self._active:
                    continue
                if not self._queue:
                    break
                req = self._queue.pop(0)
                self._prefill_slot(slot, req)
                self._active[slot] = req
                first.append(req)
            finished = self._decode_locked() if self._active else []
            now = self.clock.now()
            for req in first:
                req.first_token_t = now
            for req in finished:
                req.finish_t = now
            return finished

    def run_to_completion(self, max_steps: int = 10_000) -> list[Request]:
        """Step until every submitted request finishes; the completed requests.

        Raises :class:`ServeTruncated` if ``max_steps`` steps were not enough
        — truncation is never silently returned as success.
        """
        done: list[Request] = []
        for _ in range(max_steps):
            done += self.step()
            with self._lock:
                if not self._active and not self._queue:
                    return done
        with self._lock:
            raise ServeTruncated(done, list(self._active.values()) + list(self._queue))
