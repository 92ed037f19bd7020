"""Serving: the batched engine — the dense, paged and chunked slices of
``repro/serve/engine.py``.

The :class:`ServeEngine` implements continuous-batching-lite over fixed
slots: requests join free slots, each prompt is prefilled on its own, all
live slots decode in lock-step, and finished slots are recycled.

**Prompt bucketing**: prompts are end-padded to power-of-two lengths (as the
JAX engine does to hit its jit trace cache), and one decode step of the last
prompt token at its true position re-derives the first token's logits.
Only where every cache leaf is position-indexed: a recurrent cache (Mamba-2's
``ssm_state`` and ``conv_tail``) would fold the pads into its state, so for
those models prompts prefill at their exact length and no fixup runs.

**Fused multi-token decode** (``decode_fusion=K``, or a
:class:`FusionPolicy` choosing K a launch): one launch runs K decode steps
with on-device sampling and per-slot masks, and the host reads the tokens
back once per launch.  A step is a function over static device buffers
(positions, tokens, budgets, token counts, keys, the block table, and the
tokens out): the host copies its state into them before a launch and reads
them back after it.  On the card the step is captured once as a CUDA graph
(:mod:`repro_torch.serve.graph`) and replayed K times, the counterpart of
the JAX engine's jitted ``lax.scan``; on the CPU it is called K times.  A
slot whose budget runs out mid-launch freezes its position and token; its
cache rows keep absorbing dummy writes at the frozen position (a recurrent
state keeps absorbing dummy updates), harmless because the next prefill
into that slot replaces its whole cache slice (dense) or its table row
points at the scratch page (paged).

**Sampling** is greedy at ``temperature=0``, else position-indexed as the
JAX engine's: token t of request uid is
``categorical(fold_in(fold_in(PRNGKey(seed), uid), t), logits / T)``
(:mod:`repro_torch.serve.sampling`; on the card the ``sample`` kernel), so
a request's stream depends only on (seed, uid, logits), never on admission
order or fusion depth, and equals the JAX engine's.

**Paged KV cache** (``paged=True``): KV lives in a global page pool
(:mod:`repro_torch.serve.paged`) addressed through per-slot block tables.
Prefill scatters into freshly mapped pages, a decode launch maps each slot's
next page before it crosses a page boundary, and a finished request's pages
return to the pool at once.  Admission moves from "free slot?" to an
:class:`AdmissionPolicy` over free pages and the projected growth of the
requests already running.  Greedy streams equal the dense engine's.

**Chunked prefill** (``prefill_chunk=``, an int or a :class:`ChunkPolicy`):
prompts are prefilled in chunks, one chunk per prefilling slot per step,
interleaved with the fused decode.  A request's chunk is fixed when its
prefill starts: the policy's pick from the live decode slots and the last
launch's fusion depth.  The kernels sum a prompt row in an order that does
not depend on the rows a launch carries, so chunked streams equal
whole-prompt streams bit for bit, on the card too.
Dense, each prefilling slot fills a staging cache that is then spliced into
the batch cache; paged, each chunk writes into and attends through the
slot's pages directly, so the pool is all the KV memory the engine holds
(the JAX engine keeps a staging cache per slot there too).

**HSA routing** (``hsa_queue=``, ``hsa_scheduler=``): every model call —
prefill, prefill chunk, first-token fixup, fused decode launch — becomes an
AQL call packet on a shared queue, so serving shares the card with other
producers under the async scheduler (the paper's multi-tenancy).  The packet
carries the producer's dispatch context, so a ``cuda-strict`` policy holds
on the scheduler's worker thread too.

**Engine clock**: arrival, first-token and completion timestamps ride on
``clock`` (a ``WallClock`` unless one is given).  A ``VirtualClock`` with a
``step_time_model(prefill_tokens, decode_tokens)`` advances by the model's
seconds after every step, so TTFT and TPOT are exact properties of the
schedule; ``submit(arrival_t=)`` backdates an arrival a trace replayer
delivers at a step boundary.

Preemption (8f) is not ported: the default full-reserve admission never
needs it, and an overcommitting policy is refused.
"""

from __future__ import annotations

import contextvars
import dataclasses
import threading
import time

import numpy as np
import torch

from repro_torch.core import ledger as ledger_mod
from repro_torch.core.hsa.clock import WallClock
from repro_torch.core.policy import AdmissionPolicy, ChunkPolicy, FusionPolicy
from repro_torch.kernels import sample as sample_k
from repro_torch.models.params import resolve_device
from repro_torch.serve import graph as graph_mod
from repro_torch.serve import paged as paged_mod
from repro_torch.serve import sampling


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


@dataclasses.dataclass
class _Prefilling:
    """A request mid chunked-prefill: holds a slot (and, dense, a staging
    cache).

    ``tokens`` is the prompt padded to its bucket length — chunking runs
    over the same padded token array the whole-prompt path prefills, so the
    cache rows and the first-token fixup are those of the whole prompt.
    """

    req: Request
    tokens: np.ndarray                 # [b] prompt padded to bucket length
    n: int                             # real prompt length
    chunk: int                         # rows a chunk, fixed at the prefill's start
    staging: dict | None               # dense: the slot's staging {"k", "v"}
    filled: int = 0                    # rows prefilled so far


def _prompt_rows(cache: dict, n: int) -> dict:
    """A copy of a one-slot dense cache's rows [0, n): the first-token
    fixup's cache, which its decode step may write."""
    return {key: cache[key][:, :, :, :n].clone() for key in ("k", "v")}


class _DecodeBuffers:
    """The decode step's static device buffers, which keep their addresses
    for the engine's life (a CUDA graph captures them).

    ``state`` holds, [slots] each, the position, the last token, the budget
    left, the token count (the sampler's t) and the live flag, then the
    slots' keys [slots, 2] (uint32 bits in int32): one host-to-device copy a
    launch.  ``out`` [2, max K, slots] holds each step's token and validity,
    written at row ``step``; ``table`` [slots, NP] the block table (paged).
    """

    ROWS = 7                           # pos, tok, left, count, live, keys (2)

    def __init__(self, slots: int, max_k: int, table_pages: int | None,
                 device: torch.device):
        self.slots = slots
        self.state = torch.zeros(self.ROWS * slots, dtype=torch.int32, device=device)
        self.pos, self.tok, self.left, self.count, self.live = self.state[:5 * slots].view(5, slots)
        self.keys = self.state[5 * slots:].view(slots, 2)
        self.out = torch.zeros((2, max_k, slots), dtype=torch.int32, device=device)
        self.step = torch.zeros(1, dtype=torch.int64, device=device)
        self.table = (torch.zeros((slots, table_pages), dtype=torch.int32, device=device)
                      if table_pages is not None else None)
        pin = device.type == "cuda"
        # host staging: pinned on the card, so each upload is one async copy
        self.host_state = torch.zeros(self.state.shape, dtype=torch.int32, pin_memory=pin)
        self.host_table = (torch.zeros(self.table.shape, dtype=torch.int32, pin_memory=pin)
                           if self.table is not None else None)

    def tensors(self) -> list[torch.Tensor]:
        return [t for t in (self.state, self.out, self.step, self.table) if t is not None]

    def upload(self, pos, tok, left, count, live, keys, table) -> None:
        """The host's numpy state into the buffers: one copy (two, paged)."""
        h = self.host_state.numpy()
        S = self.slots
        for i, v in enumerate((pos, tok, left, count, live)):
            h[i * S:(i + 1) * S] = v
        h[5 * S:] = np.ascontiguousarray(keys, np.uint32).view(np.int32).reshape(-1)
        self.state.copy_(self.host_state, non_blocking=True)
        if table is not None:
            self.host_table.copy_(table)
            self.table.copy_(self.host_table, non_blocking=True)
        self.step.zero_()

    def read(self, k: int) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """(tokens [k, slots], validity [k, slots] bool, positions, tokens):
        one device-to-host copy."""
        S = self.slots
        flat = torch.cat((self.out[:, :k].reshape(-1), self.pos, self.tok)).cpu().numpy()
        toks, valid = flat[:2 * k * S].reshape(2, k, S)
        return toks, valid.astype(bool), flat[2 * k * S:2 * k * S + S], flat[-S:]


class ServeTruncated(RuntimeError):
    """``run_to_completion`` exhausted ``max_steps`` with work still pending.

    Carries the partial result — ``done`` and ``pending`` (active and
    prefilling slots, then queued requests) — so callers can't mistake
    truncation for completion.
    """

    def __init__(self, done: list[Request], pending: list[Request]) -> None:
        self.done = done
        self.pending = pending
        super().__init__(
            f"serving truncated at max_steps: {len(done)} requests done, "
            f"{len(pending)} pending"
        )


_PREEMPTION = ("preemption is ROADMAP item 8f, not ported: only it makes an "
               "overcommitting admission (growth_reserve < 1) safe")


class ServeEngine:
    """Fixed-slot batched decoder with slot recycling: greedy, or seeded
    temperature sampling.

    The dense KV cache ``[L, slots, Hkv, max_len, hd]`` — or, paged, the
    pool ``[L, pool_pages, Hkv, page_size, hd]``; for an SSM model the
    recurrent state ``[L, slots, ...]`` — lives on ``device`` and is updated
    in place: prefill copies or scatters a request's cache in, decode writes
    each new token's k/v at its slot's position (or updates its state).
    """

    #: cache leaves with no position mask: end-padding would fold into them
    _RECURRENT_CACHE_KEYS = frozenset({"ssm_state", "conv_tail"})

    #: the smallest prompt bucket (buckets are powers of two up to max_len)
    MIN_BUCKET = 8

    def __init__(self, model, params, *, batch_slots: int = 4, max_len: int = 256,
                 temperature: float = 0.0, seed: int = 0,
                 decode_fusion: "int | FusionPolicy" = 1,
                 paged: bool = False, page_size: int = 16, pool_pages: int | None = None,
                 admission: AdmissionPolicy | None = None,
                 prefill_chunk: "int | ChunkPolicy | None" = None,
                 hsa_queue=None, hsa_scheduler=None, producer: str = "tf-serving",
                 ledger: "ledger_mod.OverheadLedger | None" = None,
                 clock=None, step_time_model=None,
                 device: "str | torch.device" = "cuda"):
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model is on {model.device}, engine on {self.device}")
        if not isinstance(decode_fusion, FusionPolicy) and (
                not isinstance(decode_fusion, int) or decode_fusion < 1):
            raise ValueError(f"decode_fusion must be an int >= 1 or a FusionPolicy, "
                             f"got {decode_fusion!r}")
        if not 0 <= seed <= sampling.MASK:
            raise ValueError(f"seed must be in [0, 2^32), got {seed}")
        self.model = model
        self.params = params
        self.slots = batch_slots
        self.max_len = max_len
        self.temperature = temperature
        self.seed = seed
        # fused multi-token decode: K tokens a launch (int) or a FusionPolicy
        # choosing K a launch from contention and the remaining lengths
        self.decode_fusion = decode_fusion
        # token t of request uid is drawn with fold_in(key_of(seed, uid), t):
        # each slot keeps its request's key
        self._slot_key = np.zeros((batch_slots, 2), np.uint32)
        # feedback FusionPolicy: per foreign producer, (sample count, launches stale)
        self._wait_freshness: dict[str, tuple[int, int]] = {}
        self._cache_keys = set(model.cache_specs(1, 8)) - {"pos"}
        self.bucket_prompts = self._bucketing_safe()
        self._queue: list[Request] = []
        self._active: dict[int, Request] = {}      # slot -> request
        self._uid = 0
        self._cache: dict | None = None
        self._pos = np.zeros(batch_slots, np.int64)
        self._slot_tok = np.zeros(batch_slots, np.int32)
        # engine clock: arrival/first-token/completion timestamps ride on it;
        # a VirtualClock plus step_time_model makes latency deterministic
        # (step_time_model(prefill_tokens, decode_tokens) -> seconds, applied
        # after every step when the clock is virtual)
        self.clock = clock if clock is not None else WallClock()
        self.step_time_model = step_time_model
        self._decode_tokens_last = 0   # k x live slots of the last launch
        # optional HSA routing: model calls become queue packets so serving
        # shares the agent with other producers (paper multi-tenancy)
        if (hsa_queue is None) != (hsa_scheduler is None):
            raise ValueError("hsa_queue and hsa_scheduler must be given together")
        self._hsa_queue = hsa_queue
        self._hsa_scheduler = hsa_scheduler
        self._producer = producer
        # explicit ledger for memory accounting (falls back to the queue's)
        self.ledger = ledger if ledger is not None else (
            hsa_queue.ledger if hsa_queue is not None else None
        )
        self._token_bytes = 0          # KV bytes a position, set at cache build
        # model calls by kind: the launch counts of a run follow from these
        self.prefill_calls = 0
        self.chunk_calls = 0
        self.fixup_calls = 0
        self.decode_calls = 0
        self.decode_tokens = 0         # tokens committed by decode launches
        self.sample_calls = 0          # sampler calls (first tokens, decode steps) at T > 0
        # -- paged KV cache state ---------------------------------------------
        self.paged = paged
        self.page_size = page_size
        self.admission = admission if admission is not None else AdmissionPolicy()
        if paged:
            if not self._cache_keys <= {"k", "v"}:
                raise ValueError(
                    "paged=True requires plain position-indexed GQA KV caches "
                    "(no MLA latent, recurrent, windowed, or cross-attn leaves)"
                )
            if page_size < 1 or max_len % page_size:
                raise ValueError(
                    f"max_len={max_len} must be a multiple of page_size={page_size}"
                )
            if self.admission.overcommitted:
                raise NotImplementedError(_PREEMPTION)
            if pool_pages is None:
                # match the dense engine's footprint (+ the scratch page)
                pool_pages = batch_slots * (max_len // page_size) + 1
            self.allocator = paged_mod.PageAllocator(pool_pages)
            self.pool_pages = pool_pages
            self.table_pages = max_len // page_size          # table width NP
            # per-slot block tables on the host; unmapped entries point at the
            # scratch page so masked dummy writes never touch a live page
            self._table = np.full((batch_slots, self.table_pages),
                                  paged_mod.TRASH_PAGE, np.int32)
            self._mapped = np.zeros(batch_slots, np.int64)   # pages mapped/slot
            self._projected: dict[int, int] = {}             # slot -> pages
        else:
            self.allocator = None
        # concurrency trace: sustained (mean over decode launches) and peak
        self._concurrency_sum = 0
        self._concurrency_n = 0
        self.peak_concurrency = 0
        # -- chunked prefill: a request's rows per chunk, the policy's pick at
        # its prefill's start (powers of two, so over pow2-bucketed prompts
        # every chunk boundary is aligned) ----------------------------------------
        if prefill_chunk is not None and not isinstance(prefill_chunk, (int, ChunkPolicy)):
            raise ValueError(f"prefill_chunk must be a power of two >= 1 or a ChunkPolicy, "
                             f"got {prefill_chunk!r}")
        self.chunk_policy = ChunkPolicy.of(prefill_chunk)
        if self.chunk_policy is not None and self._cache_keys != {"k", "v"}:
            raise ValueError(
                "prefill_chunk requires plain dense-attention layers with "
                "GQA k/v caches (MoE routing and recurrent state are not "
                "row-local across chunk boundaries)"
            )
        self._last_fusion_k = 1        # feeds ChunkPolicy.choose_chunk
        self._prefilling: dict[int, _Prefilling] = {}
        self._staging: dict[int, dict] = {}   # dense: slot -> reusable staging k/v
        self._first_this_step: list[Request] = []
        # submit() may run on feeder threads while step() is mid-flight
        self._lock = threading.RLock()
        # -- the decode step's static buffers; on the card, its CUDA graph ----
        self._dec = _DecodeBuffers(batch_slots, FusionPolicy.of(decode_fusion).max_fusion,
                                   self.table_pages if paged else None, self.device)
        # the step runs as a replayed graph wherever there is a card; the
        # eager calls of the step are the CPU's (and a comparison's)
        self._graphed = self.device.type == "cuda"
        self._graph: graph_mod.StepGraph | None = None

    def _launch(self, name: str, fn, *args, **kwargs):
        """Run a model call directly, or as an AQL call packet named ``name``
        through the HSA queue.  The packet runs ``fn`` in a copy of this
        thread's context (the dispatch policy), on whichever thread consumes
        the queue: with the scheduler's worker running this waits for the
        packet's completion, else it drains only this engine's queue.  The
        blocked time is recorded as ``DISPATCH_WAIT``; a packet's error is
        re-raised here."""
        if self._hsa_queue is None:
            return fn(*args, **kwargs)
        ctx = contextvars.copy_context()

        def call(*a):
            return ctx.run(fn, *a, **kwargs)

        call.__name__ = name
        pkt = self._hsa_queue.call(call, *args, producer=self._producer)
        t0 = time.perf_counter_ns()
        sched = self._hsa_scheduler
        if getattr(sched, "running", False):
            # the worker thread owns the consume side: never run the
            # cooperative loop concurrently, just wait for completion (and
            # give up if the worker itself dies)
            while not pkt.completion.wait_eq(0, timeout=0.5):
                if sched.worker_error is not None:
                    raise RuntimeError("the HSA scheduler's worker thread died "
                                       "under a serving launch") from sched.worker_error
        else:
            # drain only our queue: another tenant's dep-blocked packet must
            # not wedge (or deadlock) a decode step
            sched.drain(self._hsa_queue)
        if self._hsa_queue.ledger is not None:
            # the producer-blocked leg of the packet round trip (overlaps the
            # device execution it waits on; subtract EXEC for pure overhead)
            self._hsa_queue.ledger.record(
                ledger_mod.DISPATCH_WAIT, (time.perf_counter_ns() - t0) * 1e-9,
                queue=self._hsa_queue.name, producer=self._producer, what=name,
            )
        if pkt.out.error is not None:
            raise pkt.out.error
        return pkt.out.value

    def _record_memory(self) -> None:
        """Reserved and used KV bytes into the ledger (dense: every live
        slot's ``max_len`` rows; paged: its mapped pages), as the JAX engine
        records them; none for a recurrent cache.  The host arena's half
        waits for its slice (8f)."""
        if self._token_bytes == 0 and self._cache is not None and self._cache_keys == {"k", "v"}:
            self._token_bytes = paged_mod.pool_token_bytes(self._cache)
        if self.ledger is None or self._token_bytes == 0:
            return
        used = sum(int(self._pos[s]) for s in self._active) * self._token_bytes
        if self.paged:
            reserved = int(self._mapped.sum()) * self.page_size * self._token_bytes
        else:
            reserved = len(self._active) * self.max_len * self._token_bytes
        self.ledger.record_memory(reserved_bytes=reserved, used_bytes=used)

    def submit(self, prompt: list[int], max_new_tokens: int = 32, *,
               arrival_t: float | None = None) -> int:
        """Queue a request; its uid.  ``arrival_t`` backdates the arrival
        timestamp (a trace replayer delivers arrivals at step boundaries,
        but the request arrived, and its TTFT clock started, earlier)."""
        with self._lock:
            if len(prompt) == 0 or len(prompt) + max_new_tokens > self.max_len:
                # paged: the block table maps exactly max_len rows
                raise ValueError(
                    f"prompt ({len(prompt)}) + max_new_tokens ({max_new_tokens}) must "
                    f"fit max_len={self.max_len}, with a non-empty prompt"
                )
            self._uid += 1
            req = Request(self._uid, np.asarray(prompt, np.int32), max_new_tokens)
            if self.paged and self._never_fits(req):
                # permanent rejection happens here: a request whose worst-case
                # footprint exceeds the pool can never complete
                worst = self.admission.worst_case_pages(
                    len(req.prompt), max_new_tokens, self.page_size)
                cap = self.allocator.total_pages - self.admission.watermark_pages
                raise ValueError(
                    f"request needs up to {worst} pages but the pool can ever "
                    f"admit at most {cap} — it would block the queue forever"
                )
            req.arrival_t = arrival_t if arrival_t is not None else self.clock.now()
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

    def _bucketing_safe(self) -> bool:
        """True iff every cache leaf is position-indexed (decode masks by
        ``pos``, so end-padding is causally inert).  Recurrent leaves have
        no such mask."""
        return not (self._cache_keys & self._RECURRENT_CACHE_KEYS)

    def concurrency_stats(self) -> dict[str, float]:
        """Sustained (mean over decode launches) and peak concurrency."""
        sustained = (self._concurrency_sum / self._concurrency_n
                     if self._concurrency_n else 0.0)
        return {"sustained": sustained, "peak": float(self.peak_concurrency)}

    # -- paged KV cache internals -------------------------------------------------

    def _projected_pages(self, req: Request) -> int:
        return self.admission.projected_pages(
            len(req.prompt), req.max_new_tokens, self.page_size)

    def _never_fits(self, req: Request) -> bool:
        """Permanently inadmissible: the request's worst-case footprint
        exceeds what the pool can ever fund under the admission policy."""
        worst = self.admission.worst_case_pages(
            len(req.prompt), req.max_new_tokens, self.page_size)
        return worst > self.allocator.total_pages - self.admission.watermark_pages

    def _projected_growth(self) -> int:
        """Pages the already-admitted requests are still projected to map;
        chunk-prefilling slots' remaining prompt rows count too."""
        live = list(self._active) + list(self._prefilling)
        return sum(max(0, self._projected[slot] - int(self._mapped[slot])) for slot in live)

    def _admit_paged(self, req: Request) -> bool:
        return self.admission.admit(
            free_pages=self.allocator.free_pages,
            projected_growth_pages=self._projected_growth(),
            request_pages=self._projected_pages(req),
        )

    def _launch_pages(self, slot: int, req: Request, k: int) -> int:
        """Mapped-page target for ``slot`` to absorb a depth-``k`` launch
        (through the last position the launch can write) — the one formula
        behind both growth funding (:meth:`_fund_growth`) and mapping
        (:meth:`_grow_to`)."""
        rem = req.max_new_tokens - len(req.generated)
        if rem <= 0:
            return int(self._mapped[slot])
        last_write = int(self._pos[slot]) + min(k, rem) - 1
        return min(last_write // self.page_size + 1, self.table_pages)

    def _grow_to(self, slot: int, need: int) -> None:
        """Map pages up to the ``need`` target: a sequence gets its next page
        exactly when a launch will carry it across a page boundary."""
        have = int(self._mapped[slot])
        if need <= have:
            return
        pages = self.allocator.allocate(self._active[slot].uid, need - have)
        self._table[slot, have:need] = pages
        self._mapped[slot] = need

    def _release_slot(self, slot: int, req: Request) -> None:
        """Finished or aborted request: its pages return to the pool."""
        pages = [int(p) for p in self._table[slot, : int(self._mapped[slot])]]
        if pages:
            self.allocator.free(req.uid, pages)
        self._table[slot] = paged_mod.TRASH_PAGE
        self._mapped[slot] = 0
        self._projected.pop(slot, None)

    def _fund_growth(self, k: int) -> int:
        """Make this launch's page growth allocatable; the funded depth.

        On a shortfall the launch shrinks (k halves): a shallower launch
        needs fewer pages ahead.  Where even k = 1 cannot be funded the JAX
        engine preempts victims; that is ROADMAP 8f here, unreachable under
        the full-reserve admission this engine accepts."""
        while True:
            needed = sum(max(0, self._launch_pages(slot, req, k) - int(self._mapped[slot]))
                         for slot, req in self._active.items())
            if needed <= self.allocator.free_pages:
                return k
            if k > 1:
                k = (k + 1) // 2
                continue
            raise NotImplementedError(_PREEMPTION)

    def _ensure_pool(self) -> None:
        if self._cache is None:
            # the cache layout with pages for rows: [L, pool_pages, Hkv, page_size, hd]
            self._cache = self._zero_cache(self.allocator.num_pages, self.page_size)

    def _zero_cache(self, batch: int, rows: int) -> dict:
        """Every cache leaf but ``pos``, zeroed, for ``batch`` slots (or
        pages) of ``rows`` rows on the device.  Zeros, not ``torch.empty``:
        attention multiplies masked rows' values by a zero probability, and
        0 * NaN would poison the product."""
        specs = self.model.cache_specs(batch, rows)
        return {key: torch.zeros(specs[key].shape, dtype=specs[key].dtype, device=self.device)
                for key in self._cache_keys}

    def _splice_dense(self, slot: int, slot_cache: dict) -> None:
        """Copy a slot's cache into the batch cache: every leaf's whole slot
        slice (the ``max_len`` row range of k/v, a recurrent state), which
        also erases the dummy writes a masked slot absorbed during fused
        decode."""
        if self._cache is None:
            self._cache = self._zero_cache(self.slots, self.max_len)
        for key in self._cache_keys:
            self._cache[key][:, slot] = slot_cache[key][:, 0]

    # -- prefill ----------------------------------------------------------------------

    def _first_token(self, slot: int, req: Request, logits: torch.Tensor,
                     rows: dict | None) -> None:
        """Sample token 0 from the prefill's logits, with the sampler the
        decode steps use (t = 0 under the request's key).  With end-padding they
        sit at a pad position: one decode step of the last prompt token at
        its true position re-derives them, against ``rows``, a copy of the
        prompt's cache rows [0, n) (None when unpadded).  Decode writes row
        n-1 in place, so it writes the copy, which is then dropped, and the
        slot keeps the prefill's cache verbatim."""
        n = len(req.prompt)
        if rows is not None:
            fix_cache = {"pos": torch.tensor([n - 1], dtype=torch.int32, device=self.device),
                         **rows}
            logits, _ = self._launch(
                "prefill_fixup", self.model.decode_step, self.params,
                torch.as_tensor(req.prompt[-1:][None, :], device=self.device), fix_cache,
            )
            self.fixup_calls += 1
        key = sampling.key_of(self.seed, req.uid)
        self._slot_key[slot] = key
        if self.temperature > 0:
            dev = logits.device
            tok_t = torch.zeros(1, dtype=torch.int32, device=dev)
            sample_k.sample(logits[:1].float().contiguous(),
                            torch.from_numpy(key.view(np.int32)[None].copy()).to(dev),
                            torch.zeros(1, dtype=torch.int32, device=dev),
                            torch.ones(1, dtype=torch.int32, device=dev), tok_t,
                            self.temperature)
            self.sample_calls += 1
            tok = int(tok_t[0])
        else:
            tok = int(torch.argmax(logits[0]))
        req.generated.append(tok)
        self._slot_tok[slot] = tok

    def _prefill_slot(self, slot: int, req: Request) -> None:
        n = len(req.prompt)
        pad = max(0, self.bucket_len(n, self.max_len) - n) if self.bucket_prompts else 0
        tokens = np.pad(req.prompt, (0, pad)) if pad else req.prompt
        logits, cache = self._launch(
            "prefill", self.model.prefill, self.params,
            {"tokens": torch.as_tensor(tokens[None, :], device=self.device)},
            cache_len=self.max_len,
        )
        self.prefill_calls += 1
        self._first_token(slot, req, logits, _prompt_rows(cache, n) if pad else None)
        self._pos[slot] = n
        if not self.paged:
            self._splice_dense(slot, cache)
            return
        # map pages covering the prompt and scatter the prefill KV in; the
        # page for the first decode write arrives via _grow_to
        self._ensure_pool()
        n_store = paged_mod.pages_for(n, self.page_size)
        pages = self.allocator.allocate(req.uid, n_store)
        self._table[slot] = paged_mod.TRASH_PAGE
        self._table[slot, :n_store] = pages
        self._mapped[slot] = n_store
        self._projected[slot] = self._projected_pages(req)
        paged_mod.scatter_prefill(self._cache, cache, pages, self.page_size)

    # -- chunked prefill (continuous batching) ------------------------------------------

    def _chunk_for_new(self, req: Request) -> int:
        """Chunk size a newly admitted request will prefill at (fixed for the
        request's whole prefill), from the live decode slots and the last
        launch's depth."""
        return self.chunk_policy.choose_chunk(
            live_decode=len(self._active), fusion_k=self._last_fusion_k)

    def _admit_chunked(self, req: Request) -> bool:
        """Paged admission for a chunked prefill: charge the *first chunk's*
        pages; the rest of the prompt is projected growth."""
        first = paged_mod.pages_for(min(len(req.prompt), self._chunk_for_new(req)),
                                    self.page_size)
        return self.admission.admit(
            free_pages=self.allocator.free_pages,
            projected_growth_pages=self._projected_growth(),
            request_pages=first,
        )

    def _start_chunked(self, slot: int, req: Request) -> None:
        """Admit ``req`` into ``slot`` as a chunked prefill."""
        n = len(req.prompt)
        b = self.bucket_len(n, self.max_len)
        tokens = np.pad(req.prompt, (0, b - n)) if b > n else req.prompt
        staging = None
        if self.paged:
            self._ensure_pool()
            self._table[slot] = paged_mod.TRASH_PAGE
            self._mapped[slot] = 0
            self._projected[slot] = self._projected_pages(req)
        else:
            # allocated once per slot and reused across occupants without
            # re-zeroing: chunk c attends only rows [0, end) written by chunks
            # before it, and decode masks rows >= pos, so stale rows are never
            # read with nonzero weight
            if slot not in self._staging:
                self._staging[slot] = self._zero_cache(1, self.max_len)
            staging = self._staging[slot]
        self._prefilling[slot] = _Prefilling(req=req, tokens=tokens, n=n,
                                             chunk=self._chunk_for_new(req), staging=staging)

    def _chunk_step(self, slot: int, entry: _Prefilling) -> int:
        """Run one prefill chunk for ``slot``; rows processed (0 = stalled)."""
        req = entry.req
        b = len(entry.tokens)
        start = entry.filled
        size = min(entry.chunk, b - start)
        if self.paged:
            # fund this chunk's pages: only rows < n need their own page (pad
            # rows past them land on the scratch page).  A shortfall stalls
            # the chunk — decode keeps running and frees pages
            need = paged_mod.pages_for(min(start + size, entry.n), self.page_size)
            have = int(self._mapped[slot])
            if need > have:
                if self.allocator.free_pages < need - have:
                    return 0
                self._table[slot, have:need] = self.allocator.allocate(req.uid, need - have)
                self._mapped[slot] = need
            cache = {**self._cache,
                     "block_table": torch.as_tensor(self._table[slot:slot + 1], device=self.device)}
        else:
            cache = entry.staging
        toks = torch.as_tensor(entry.tokens[None, start:start + size], device=self.device)
        logits, _ = self._launch("prefill_chunk", self.model.prefill_chunk, self.params, toks,
                                 cache, start=start)
        self.chunk_calls += 1
        entry.filled += size
        if entry.filled >= b:
            self._finish_chunked(slot, entry, logits)
        return size

    def _finish_chunked(self, slot: int, entry: _Prefilling, logits: torch.Tensor) -> None:
        """Prompt fully prefilled: derive token 0 as the whole-prompt path
        does (the fixup runs on a copy of the prompt's rows, so a dense
        splice below copies the prefill's row n-1, not the fixup's), then
        move the request into the decode batch."""
        req, n = entry.req, entry.n
        rows = None
        if len(entry.tokens) > n:
            rows = (paged_mod.gather_rows(self._cache, self._table[slot], n, self.page_size)
                    if self.paged else _prompt_rows(entry.staging, n))
        self._first_token(slot, req, logits, rows)
        if not self.paged:
            self._splice_dense(slot, entry.staging)
        self._pos[slot] = n
        del self._prefilling[slot]
        self._active[slot] = req
        self._first_this_step.append(req)

    # -- decode ---------------------------------------------------------------------

    #: launches without a new foreign sample before that producer's stale
    #: p99 stops throttling K (a tenant that left must not pin fusion low)
    FEEDBACK_STALE_LAUNCHES = 8

    def _contention_ledger(self):
        """Where foreign ``dispatch_wait`` samples land: the shared queue's
        ledger when routed through HSA (an explicit ``ledger=`` only carries
        this engine's memory accounting), else the explicit one."""
        if self._hsa_queue is not None and self._hsa_queue.ledger is not None:
            return self._hsa_queue.ledger
        return self.ledger

    def _observed_foreign_wait(self) -> float | None:
        """Worst recent p99 ``dispatch_wait`` among other producers on the
        shared ledger: the feedback FusionPolicy's contention signal.  A
        producer whose sample count has not moved for
        ``FEEDBACK_STALE_LAUNCHES`` launches in a row is ignored (the
        quantile window is count-bounded, so a tenant that burst and went
        silent would otherwise hold K down forever)."""
        led = self._contention_ledger()
        if led is None:
            return None
        worst = None
        for prod, cats in led.producer_breakdown().items():
            if prod == self._producer:
                continue
            stat = cats.get(ledger_mod.DISPATCH_WAIT)
            if stat is None or stat.count == 0:
                continue
            last, stale = self._wait_freshness.get(prod, (-1, 0))
            stale = stale + 1 if stat.count == last else 0
            self._wait_freshness[prod] = (stat.count, stale)
            if stale >= self.FEEDBACK_STALE_LAUNCHES:
                continue
            q = led.quantile(ledger_mod.DISPATCH_WAIT, 0.99, producer=prod)
            if q is not None and (worst is None or q > worst):
                worst = q
        return worst

    def _choose_fusion(self) -> int:
        """This launch's depth: the fixed K, or the policy's pick from the
        foreign packets pending on the shared scheduler (or, in feedback
        mode, the observed foreign p99 ``dispatch_wait``) and the mean
        remaining budget of the live slots."""
        remaining = [r.max_new_tokens - len(r.generated) for r in self._active.values()]
        if isinstance(self.decode_fusion, FusionPolicy):
            depth = 0
            if self._hsa_scheduler is not None:
                depth = sum(q.pending() for q in self._hsa_scheduler.queues
                            if q is not self._hsa_queue)
            observed = self._observed_foreign_wait() if self.decode_fusion.feedback else None
            k = self.decode_fusion.choose_k(
                queue_depth=depth,
                mean_request_len=sum(remaining) / max(1, len(remaining)),
                observed_wait_s=observed)
        else:
            k = self.decode_fusion
        # never run past every live slot's budget: those steps are all-masked
        return max(1, min(k, max(remaining, default=1)))

    def _decode_step(self) -> None:
        """One decode step over the static buffers (the function a CUDA graph
        captures): every slot decodes its token at its position; live slots
        take the sampled token, advance, and stop when their budget is
        spent, and row ``step`` of ``out`` records each slot's token and
        whether it was live.  A paged step carries the table unchanged: page
        growth happens on the host between launches."""
        b = self._dec
        cache = {"pos": b.pos, **self._cache}
        if self.paged:
            cache["block_table"] = b.table
        logits, _ = self.model.decode_step(self.params, b.tok[:, None], cache)
        live = b.live != 0
        if self.temperature > 0:
            sample_k.sample(logits, b.keys, b.count, b.live, b.tok, self.temperature)
        else:
            b.tok.copy_(torch.where(live, torch.argmax(logits, dim=-1).to(torch.int32), b.tok))
        b.out[0].index_copy_(0, b.step, b.tok[None])
        b.out[1].index_copy_(0, b.step, b.live[None])
        inc = live.to(torch.int32)
        b.pos.add_(inc)
        b.count.add_(inc)
        b.left.sub_(inc)
        b.live.copy_(live & (b.left > 0))
        b.step.add_(1)

    def _graph_tensors(self) -> list[torch.Tensor]:
        """Every tensor a decode step reads or writes by address: the cache
        or pool, the weights, the static buffers."""
        leaves, todo = [], [self.params]
        while todo:
            node = todo.pop()
            if isinstance(node, torch.Tensor):
                leaves.append(node)
            elif isinstance(node, dict):
                todo.extend(node.values())
            elif isinstance(node, (list, tuple)):
                todo.extend(node)
        return [*self._cache.values(), *leaves, *self._dec.tensors()]

    def _fused_decode(self, k: int, active: np.ndarray, remaining: np.ndarray,
                      table: torch.Tensor | None):
        """``k`` masked decode steps over all slots with on-device sampling:
        the host state into the static buffers (each live request's token
        count is its sampler's t), the steps (a graph's replays on the
        card), and the tokens [k, slots] and their validity mask read back
        once."""
        b = self._dec
        counts = np.zeros(self.slots, np.int32)
        for slot, req in self._active.items():
            counts[slot] = len(req.generated)
        b.upload(self._pos.astype(np.int32), self._slot_tok, remaining, counts,
                 active.astype(np.int32), self._slot_key, table)
        if self._graphed:
            if self._graph is None:
                self._graph = graph_mod.StepGraph(self._decode_step, self.device,
                                                  self._graph_tensors)
            self._graph.run(k)
        else:
            for _ in range(k):
                self._decode_step()
        self.decode_calls += k
        if self.temperature > 0:
            self.sample_calls += k
        toks, valid, pos, tok = b.read(k)
        self._pos = pos.astype(np.int64)
        self._slot_tok = tok.astype(np.int32)
        return toks, valid

    def _decode_locked(self) -> list[Request]:
        k = self._choose_fusion()
        if self.paged:
            k = self._fund_growth(k)
        n_live = len(self._active)
        # the depth launched, after every cap: ChunkPolicy's fusion taper and
        # the step time model's decode half read it
        self._last_fusion_k = k
        self._decode_tokens_last = k * n_live
        self._concurrency_sum += n_live
        self._concurrency_n += 1
        self.peak_concurrency = max(self.peak_concurrency, n_live)
        remaining = np.zeros(self.slots, np.int32)
        active = np.zeros(self.slots, bool)
        for slot, req in self._active.items():
            self._slot_tok[slot] = req.generated[-1]
            remaining[slot] = req.max_new_tokens - len(req.generated)
            active[slot] = remaining[slot] > 0
            if self.paged and remaining[slot] > 0:
                # map through the last position this launch can write (funded above)
                self._grow_to(slot, self._launch_pages(slot, req, k))
        table = None
        if self.paged:
            table = self._table
            if self._prefilling:
                # a mid-prefill slot has real pages mapped but is masked in this
                # launch: its dummy writes at its stale position must land on the
                # scratch page, not on the chunk rows already scattered
                table = table.copy()
                table[list(self._prefilling)] = paged_mod.TRASH_PAGE
            table = torch.from_numpy(table)     # on the host: the launch uploads it
        # one packet a fused launch, named as the JAX engine names it
        name = f"decode_fused_k{k}" + ("_paged" if self.paged else "")
        toks, valid = self._launch(name, self._fused_decode, k, active, remaining, table)
        self.decode_tokens += int(valid.sum())
        finished = []
        for slot, req in list(self._active.items()):
            req.generated.extend(int(t) for t in toks[valid[:, slot], slot])
            if len(req.generated) >= req.max_new_tokens:
                req.done = True
                finished.append(req)
                if self.paged:
                    self._release_slot(slot, req)
                del self._active[slot]
        return finished

    # -- public loop ------------------------------------------------------------

    def step(self) -> list[Request]:
        """Admit queued requests into free slots (a whole-prompt prefill
        each, or a chunked prefill's start), run one prefill chunk per
        chunk-prefilling slot, then decode up to ``decode_fusion`` tokens
        for all live slots.

        Returns requests completed this step.
        """
        with self._lock:
            self._first_this_step = []
            chunked = self.chunk_policy is not None
            # the step's work for the step time model: a whole prompt's
            # bucket rows, a chunk's rows (pad rows included)
            prefill_tokens = 0
            for slot in range(self.slots):
                if slot in self._active or slot in self._prefilling:
                    continue
                if not self._queue:
                    break
                if self.paged:
                    head = self._queue[0]
                    if not (self._admit_chunked(head) if chunked else self._admit_paged(head)):
                        # head-of-line blocking is deliberate: skipping ahead to
                        # smaller requests would starve large ones forever
                        break
                req = self._queue.pop(0)
                if chunked:
                    self._start_chunked(slot, req)
                else:
                    self._prefill_slot(slot, req)
                    prefill_tokens += (self.bucket_len(len(req.prompt), self.max_len)
                                       if self.bucket_prompts else len(req.prompt))
                    self._active[slot] = req
                    self._first_this_step.append(req)
            if self._prefilling:
                prefill_tokens += self._chunk_phase()
            finished = self._decode_locked() if self._active else []
            # the clock: advance virtual time by the step's modeled cost,
            # then stamp this step's latency events at the new now
            decode_tokens, self._decode_tokens_last = self._decode_tokens_last, 0
            if self.step_time_model is not None and getattr(self.clock, "virtual", False):
                self.clock.advance(self.step_time_model(prefill_tokens, decode_tokens))
            now = self.clock.now()
            for req in self._first_this_step:
                req.first_token_t = now
                if self.ledger is not None:
                    self.ledger.record(ledger_mod.TTFT, now - req.arrival_t,
                                       producer=self._producer, uid=req.uid)
            for req in finished:
                req.finish_t = now
                if self.ledger is not None:
                    self.ledger.record(
                        ledger_mod.TPOT,
                        (req.finish_t - req.first_token_t) / max(1, len(req.generated) - 1),
                        producer=self._producer, uid=req.uid)
            self._record_memory()
            return finished

    def _chunk_phase(self) -> int:
        """One prefill chunk per prefilling slot, oldest first (uid order),
        so under page pressure the senior prefill funds before junior ones;
        the rows prefilled."""
        order = sorted(self._prefilling, key=lambda s: self._prefilling[s].req.uid)
        rows = sum(self._chunk_step(slot, self._prefilling[slot]) for slot in order)
        if self.paged and self._prefilling and rows == 0 and not self._active:
            # every prefill stalled and nothing is decoding: no pages will free
            # on their own.  Abort the youngest prefill back into the queue (uid
            # order kept); its pages fund the senior ones
            slot = max(self._prefilling, key=lambda s: self._prefilling[s].req.uid)
            entry = self._prefilling.pop(slot)
            self._release_slot(slot, entry.req)
            idx = next((i for i, r in enumerate(self._queue) if r.uid > entry.req.uid),
                       len(self._queue))
            self._queue.insert(idx, entry.req)
        return rows

    def run_to_completion(self, max_steps: int = 10_000) -> list[Request]:
        """Step until every submitted request finishes; the completed requests.

        Raises :class:`ServeTruncated` if ``max_steps`` steps were not enough
        — truncation is never silently returned as success.
        """
        done: list[Request] = []
        for _ in range(max_steps):
            done += self.step()
            with self._lock:
                if not self._active and not self._prefilling and not self._queue:
                    return done
        with self._lock:
            pending = (list(self._active.values())
                       + [e.req for e in self._prefilling.values()] + list(self._queue))
            raise ServeTruncated(done, pending)
