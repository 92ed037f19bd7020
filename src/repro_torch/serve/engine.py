"""Serving: the batched engine — the dense, paged and chunked slices of
``repro/serve/engine.py``.

The :class:`ServeEngine` implements continuous-batching-lite over fixed
slots: requests join free slots, each prompt is prefilled on its own, all
live slots decode in lock-step, and finished slots are recycled.

**Prompt bucketing**: prompts are end-padded to power-of-two lengths (as the
JAX engine does to hit its jit trace cache), and one decode step of the last
prompt token at its true position re-derives the first token's logits.
Only where every cache leaf is position-indexed: a recurrent cache (Mamba-2's
``ssm_state`` and ``conv_tail``) would fold the pads into its state, and a
sliding window's ring cache (Hymba's) would keep the pads' rows, so for
those models prompts prefill at their exact length and no fixup runs.  A
hybrid model's decode step updates its ring and its SSM state in place, in
the same captured graph.  An encoder-decoder model is refused: its prefill
needs frames the engine does not pass.

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

**Preemption** (``admission=AdmissionPolicy(growth_reserve < 1)``,
``preemption=``): an overcommitted paged engine parks victims when its pool
runs dry mid-decode (or on an external :meth:`ServeEngine.preempt`): their
pages return to the pool, their progress stays on the host, and they resume
before anything still queued, either by re-prefill and replay (the prompt
prefilled again and the committed tokens regenerated through the normal
decode path, checked token by token against what was committed) or by
restoring a snapshot of their pages.  Streams equal an unpreempted run's.

**Host tier** (``host_budget_bytes=``, ``spill=``): snapshots are copied
off the card into a budgeted :class:`~repro_torch.serve.paged.HostArena`
before the victim's pages are freed, and restored into the pool in place
(the decode graph holds the pool's address).  Past the budget a
:class:`SpillPolicy` demotes parked snapshots to replay.  Refills are issued
ahead of need: on the :class:`TransferEngine`, a timeline priced at
``transfer_bandwidth_bytes_s`` on the engine clock (the ledger's exposed and
hidden refill time), and on the card as a real copy up on a side stream
(:class:`~repro_torch.serve.paged.StagedRefill`) that the resume waits on.
``copy_stats`` holds the real copies' bytes and seconds.

**Fault recovery** (``retry=``, ``faults=``): with an engine
:class:`RetryPolicy`, a launch that dies to a ``FaultError`` (after the HSA
scheduler's own retries) parks its requests for re-prefill and replay
instead of raising: a decode fault parks every live slot, a prefill fault
puts its request back at the queue's head, a chunk's fault sends its
request back to the queue; a request past ``max_request_recoveries`` fails
and lands in ``ServeTruncated.failed``.  A faulted launch commits nothing:
the scheduler draws a fault before the packet runs, and the packet is
where the static decode buffers and the pool are written.  ``faults=`` (a
``FaultPlan``) also draws the transfer engine's faults and the
corruptions below.

**Integrity** (``integrity=``, an :class:`IntegrityPolicy`): content
digests stamped on every page a write seals (prefill, chunk, decode commit,
snapshot restore) and checked where the bytes are trusted again: every
sealed page a decode launch read, before its tokens commit (a mismatch
quarantines the page and re-prefills each reader), spills and refills,
and a budgeted scrubber over device pages and arena blocks.  Digests are
computed on the host after one copy of the pages due off the card
(:func:`~repro_torch.serve.paged.page_digests`); ``verify_stats`` holds
their pages, bytes and seconds.  ``FaultPlan``'s corruption draws flip a
pool byte in place, a parked snapshot's byte, or a transfer's payload; with
verification off the engine counts the escapes.

**Prefix sharing** (``prefix=``, a :class:`PrefixPolicy`): a request whose
prompt's full pages are already resident attaches to them at +1 refcount
and prefills only its suffix, one chunk from the first unshared page's
row, reading the shared rows in place through the block table (the JAX
engine copies them into a staging cache); admission charges only the
unshared pages, a park's snapshot leaves the shared pages out, and a
resume whose prefix has gone demotes to replay (a copy-on-write copy).
"""

from __future__ import annotations

import bisect
import contextvars
import dataclasses
import threading
import time

import numpy as np
import torch

from repro_torch.core import ledger as ledger_mod
from repro_torch.core.hsa.clock import WallClock
from repro_torch.core.hsa.faults import CorruptPayload, FaultError, SilentCorruption
from repro_torch.core.policy import (
    RESUME_REPREFILL,
    RESUME_SNAPSHOT,
    AdmissionPolicy,
    ChunkPolicy,
    FusionPolicy,
    IntegrityPolicy,
    PreemptionCandidate,
    PreemptionPolicy,
    PrefixPolicy,
    RetryPolicy,
    SpillCandidate,
    SpillPolicy,
)
from repro_torch.core.reconfig import TransferEngine
from repro_torch.dist import act, collectives
from repro_torch.dist.sharding import P, Sharding, ShardingRules
from repro_torch.kernels import sample as sample_k
from repro_torch.models.model import TIME_KEYS
from repro_torch.models.params import ParamSpec, resolve_device
from repro_torch.serve import graph as graph_mod
from repro_torch.serve import paged as paged_mod
from repro_torch.serve import sampling
from repro_torch.train.step import batch_shardings, moe_mesh_info


# ---------------------------------------------------------------------------
# cache sharding
# ---------------------------------------------------------------------------

#: the cache leaves ``cache_pspecs`` places; the rest are whole
SHARDED_CACHE_KEYS = ("k", "v", "mem_k", "mem_v", "ssm_state", "ckv", "krope", "conv_tail")


def cache_pspecs(cfg, rules: ShardingRules, cache_tree: dict, global_batch: int) -> dict:
    """Each cache leaf's placement, by name and divisibility (JAX's rule).

    Layout [L, B, H, T, hd] (kv), [L, B, T, r] (latent), [L, B, H, P, N]
    (ssm), [L, B, K-1, C] (conv).  B splits over the data axes where it
    divides.  On the model axis the **first** non-batch dimension it
    divides is split: the heads where they divide, otherwise the cache's
    time axis (sequence-parallel KV: a kv=8 GQA cache at TP=16 must split
    over T or a 32k cache is held 16 times); the softmax statistics over a
    time-split cache then reduce with small [B, H] collectives."""
    model_size = rules.mesh.shape.get("model", 1)
    dp = rules.batch_pspec(global_batch, 0)[0]

    def spec_for(key, leaf):
        shape = tuple(leaf.shape)
        if key not in SHARDED_CACHE_KEYS:
            return P(*([None] * len(shape)))
        parts: list = [None, dp] + [None] * (len(shape) - 2)
        if model_size > 1:
            for i in range(2, len(shape)):
                if shape[i] % model_size == 0 and shape[i] >= model_size:
                    parts[i] = "model"
                    break
        return P(*parts)

    return {key: spec_for(key, leaf) for key, leaf in cache_tree.items()}


def cache_shardings(cfg, rules: ShardingRules, cache_tree: dict, global_batch: int) -> dict:
    return {key: Sharding(rules.mesh, ps)
            for key, ps in cache_pspecs(cfg, rules, cache_tree, global_batch).items()}


# ---------------------------------------------------------------------------
# sharded steps
# ---------------------------------------------------------------------------


def _global_cache_shapes(cfg, cache: dict, global_batch: int) -> dict:
    """A sharded prefill's cache leaves' global shapes, as specs (no tensor
    is made): the batch whole, and the k/v heads all of them (attention may
    hold this rank's)."""
    out = {}
    for key, t in cache.items():
        shape = list(t.shape)
        if shape:
            shape[1] = global_batch
        if key in ("k", "v", "mem_k", "mem_v"):
            shape[2] = cfg.num_kv_heads
        out[key] = ParamSpec(tuple(shape), dtype=t.dtype)
    return out


def make_prefill_step(model, rules: ShardingRules, *, global_batch: int,
                      cache_len: int | None = None):
    """``(prefill, param shardings, batch shardings)``: ``prefill(params,
    batch)`` takes this rank's slices of the parameters (the shardings'
    leaves, then ``models.params.refresh_derived`` for the f32 copies
    serving reads) and the global
    batch of ``global_batch`` rows and returns the global last-token logits
    [B, V] f32 and this rank's slice of the cache in
    :func:`cache_pspecs`' layout (what :func:`make_decode_step`'s step
    takes; JAX leaves the prefill's cache layout to propagation)."""
    cfg = model.cfg
    p_shard = rules.sharding_tree(model.param_specs())
    b_shard = batch_shardings(cfg, rules, global_batch)
    minfo = moe_mesh_info(cfg, rules)
    layout = act.StepLayout(batch_axes=rules.batch_axes(global_batch))
    batch_group = rules.mesh.group(layout.batch_axes)

    @torch.no_grad()
    def prefill(params, batch):
        local = {k: b_shard[k].local(v) for k, v in batch.items()}
        with act.use_rules(rules), act.use_layout(layout):
            logits, cache = model.prefill(params, local, cache_len=cache_len, moe_info=minfo)
        logits = collectives.gather(logits, 0, batch_group)
        shapes = _global_cache_shapes(cfg, cache, global_batch)
        for key, ps in cache_pspecs(cfg, rules, shapes, global_batch).items():
            t = cache[key]
            for dim, entry in enumerate(ps):
                n = rules.mesh.size_of(entry) if dim >= 2 and entry is not None else 1
                if n > 1 and t.shape[dim] == shapes[key].shape[dim]:
                    t = t.chunk(n, dim)[rules.mesh.index(entry)].contiguous()
            cache[key] = t
        return logits, cache

    return prefill, p_shard, b_shard


def make_decode_step(model, rules: ShardingRules, *, global_batch: int, cache_len: int):
    """``(decode, param shardings, cache shardings, cache specs)``:
    ``decode(params, tokens, cache)`` takes this rank's slices of the
    parameters and the cache (:func:`cache_shardings`) and the global
    tokens [B, 1]; returns the global logits [B, V] f32 and the cache,
    updated in place (JAX donates it)."""
    cfg = model.cfg
    p_shard = rules.sharding_tree(model.param_specs())
    cache_tree = model.cache_specs(global_batch, cache_len)
    c_shard = cache_shardings(cfg, rules, cache_tree, global_batch)
    tok_shard = Sharding(rules.mesh, rules.batch_pspec(global_batch, 1))
    minfo = moe_mesh_info(cfg, rules, for_decode=True)
    layout = act.StepLayout(batch_axes=rules.batch_axes(global_batch),
                            cache={key: sh.entries for key, sh in c_shard.items()})
    batch_group = rules.mesh.group(layout.batch_axes)

    @torch.no_grad()
    def decode(params, tokens, cache):
        with act.use_rules(rules), act.use_layout(layout):
            logits, cache = model.decode_step(params, tok_shard.local(tokens), cache,
                                              moe_info=minfo)
        return collectives.gather(logits, 0, batch_group), cache

    return decode, p_shard, c_shard, cache_tree


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray                 # [S] int32
    max_new_tokens: int
    generated: list[int] = dataclasses.field(default_factory=list)
    done: bool = False
    parked: bool = False               # preempted, awaiting resume
    preemptions: int = 0               # times this request was parked
    fault_recoveries: int = 0          # fault-triggered park/requeue cycles
    # the fault that permanently killed this request (recovery budget spent)
    failed: BaseException | None = None
    # committed tokens a re-prefill resume is replaying; the engine checks
    # the regenerated tokens against this prefix bit for bit, then drops it
    replay: list[int] | None = None
    # engine-clock timestamps (None until the event happens): arrival at
    # submit, first generated token, completion — the TTFT/TPOT feed
    arrival_t: float | None = None
    first_token_t: float | None = None
    finish_t: float | None = None


@dataclasses.dataclass
class _Parked:
    """A preempted request's host-side state between park and resume.  A
    snapshot-mode request's KV lives in the engine's host arena, keyed by
    uid."""

    req: Request
    pos: int                           # cache rows at park (prompt + gen - 1)
    mode: str                          # RESUME_SNAPSHOT | RESUME_REPREFILL
    # the refill (a reconfig.Transfer) the ahead-of-need pump issued; the
    # resume waits on it instead of issuing one cold
    refill: object | None = None
    # on the card, the refill's real copy in flight (a paged.StagedRefill)
    staged: object | None = None
    # engine-clock time the fault that parked this request fired (None for
    # a pool-pressure park); resume - fault_t is its repair time (MTTR)
    fault_t: float | None = None
    # shared-prefix pages the slot held at park: the snapshot leaves them
    # out (they stay resident under other readers' refcounts) and the resume
    # attaches them again, or demotes to replay if the prefix has gone
    shared_pages: int = 0


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
    """A copy of a one-slot dense cache's rows [0, n) (k/v, or MLA's
    latents; time is each leaf's second to last axis): the first-token
    fixup's cache, which its decode step may write."""
    return {key: cache[key].narrow(-2, 0, n).clone() for key in cache if key != "pos"}


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

    Carries the partial result so callers can't mistake truncation for
    completion, split by why each unfinished request is unfinished:

    - ``pending``: active and prefilling slots and admissible queued
      requests; more steps would finish them;
    - ``parked``: preempted mid-flight by pool pressure, their tokens so far
      intact; they resume when pages free up;
    - ``rejected``: queued or parked requests whose worst-case page
      footprint can never fit the pool under the current admission policy
      (``submit`` refuses these up front: they appear here only if the
      policy was tightened after submission);
    - ``failed``: requests killed by a hardware fault after the engine's
      recovery budget (``RetryPolicy.max_request_recoveries``) was spent:
      permanent, and raised as soon as everything else drains.  Each
      carries the fatal error on ``req.failed``.
    """

    def __init__(self, done: list[Request], pending: list[Request], *,
                 parked: list[Request] | tuple = (),
                 rejected: list[Request] | tuple = (),
                 failed: list[Request] | tuple = ()) -> None:
        self.done = done
        self.pending = pending
        self.parked = list(parked)
        self.rejected = list(rejected)
        self.failed = list(failed)
        super().__init__(
            f"serving truncated at max_steps: {len(done)} requests done, "
            f"{len(pending)} pending, {len(self.parked)} parked, "
            f"{len(self.rejected)} permanently rejected, "
            f"{len(self.failed)} failed to faults"
        )


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
                 preemption: PreemptionPolicy | None = None,
                 prefill_chunk: "int | ChunkPolicy | None" = None,
                 hsa_queue=None, hsa_scheduler=None, producer: str = "tf-serving",
                 ledger: "ledger_mod.OverheadLedger | None" = None,
                 clock=None, step_time_model=None,
                 host_budget_bytes: int | None = None,
                 spill: SpillPolicy | None = None,
                 transfer_bandwidth_bytes_s: float = 8e9,
                 retry: "RetryPolicy | int | None" = None,
                 faults=None,
                 integrity: "IntegrityPolicy | bool | None" = None,
                 prefix: "PrefixPolicy | bool | None" = None,
                 device: "str | torch.device" = "cuda"):
        self.device = resolve_device(device)
        if model.cfg.family == "audio":
            # the JAX engine takes such a model and its prefill then raises
            # KeyError: 'frames' (it passes tokens alone)
            raise ValueError(
                f"{model.cfg.name}: ServeEngine serves decoder-only models; an encoder-decoder "
                f"prefill also needs batch['frames'], which the engine does not pass: call "
                f"EncDecLM.prefill and decode_step directly")
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
        # called with each eager decode step's logits [slots, V] before they are
        # sampled (a graphed step calls it only while it is captured); None: no call
        self.decode_logits_tap = None
        # -- paged KV cache state ---------------------------------------------
        self.paged = paged
        if paged and not self._paged_safe():
            raise ValueError(
                "paged=True requires plain position-indexed GQA KV caches "
                "(no MLA latent, recurrent, windowed, or cross-attn leaves)"
            )
        self.page_size = page_size
        self.admission = admission if admission is not None else AdmissionPolicy()
        self.preemption = preemption if preemption is not None else PreemptionPolicy()
        # preempted requests awaiting resume, oldest uid first: they were
        # admitted before anything still queued, so they resume first too
        self._parked: list[_Parked] = []
        # fault recovery: with a RetryPolicy, a launch dying to a FaultError
        # parks its requests for re-prefill replay instead of raising; a
        # request whose recovery budget is spent lands in _failed.  Any other
        # error still propagates: bugs are not retried
        self.retry = RetryPolicy.of(retry)
        self._failed: list[Request] = []
        self.faults = faults
        # overcommit counters (mirrored into the ledger when one is attached)
        self.preemptions = 0
        self.resumes = 0
        self.pages_reclaimed = 0
        self.recompute_tokens = 0
        # host-tier counters
        self.spills = 0
        self.refills = 0
        self.demotions = 0
        self.replay_fallback_tokens = 0
        self.transfer_faults = 0
        # the real copies behind the priced timeline (see copy_stats)
        self._copies = {"d2h_bytes": 0, "d2h_s": 0.0, "d2h_alloc_s": 0.0,
                        "h2d_bytes": 0, "h2d_s": 0.0, "h2d_waited_s": 0.0,
                        "h2d_cancelled": 0}
        self._landed: list[paged_mod.StagedRefill] = []   # timings not read yet
        self.spill = SpillPolicy.of(spill)
        self.host_budget_bytes = host_budget_bytes
        # -- integrity: digests stamped at write boundaries, verified at read
        # and transfer boundaries, scrubbed on a budget; None keeps the path
        # free of hashing ------------------------------------------------------
        self.integrity = IntegrityPolicy.of(integrity)
        if self.integrity is not None and not paged:
            raise ValueError("integrity requires paged=True (digests are page-granular)")
        self._page_digests: dict[int, bytes] = {}   # sealed page -> digest
        # the scrubber's rotation cursor: the last target scanned, keyed
        # (tier, id) with tier 0 a device page and tier 1 an arena uid
        self._scrub_cursor: tuple[int, int] = (-1, -1)
        # injected but undetected corruption, the escape accounting's ground
        # truth: device pages (page -> owner uid), tainted arena entries, and
        # slots restored from tainted or corrupted payloads
        self._live_corrupt_pages: dict[int, int] = {}
        self._tainted_uids: set[int] = set()
        self._tainted_slots: set[int] = set()
        self.corruptions_injected = 0
        self.corruptions_detected = 0
        self.pages_quarantined = 0
        self.escaped_corruptions = 0
        self.scrubbed_targets = 0
        # the read verification's cost: decode launches checked, the pages
        # and bytes hashed, and the seconds (the copy off the card included)
        self.verify_stats = {"launches": 0, "pages": 0, "bytes": 0, "s": 0.0}
        # -- prefix sharing: refcounted pages and the prefix index -----------
        self.prefix = PrefixPolicy.of(prefix)
        if self.prefix is not None:
            if not paged:
                raise ValueError("prefix sharing requires paged=True "
                                 "(shared pages live in the page pool)")
            if not self._chunk_safe():
                raise ValueError(
                    "prefix sharing requires chunk-exact models (plain "
                    "dense-attention GQA layers): the unshared suffix is "
                    "prefilled as one chunk over the resident prefix rows")
        self._prefix_index = paged_mod.PrefixIndex() if self.prefix is not None else None
        self._slot_shared = np.zeros(batch_slots, np.int64)  # shared pages/slot
        self.prefix_lookups = 0
        self.prefix_hits = 0
        self.prefix_pages_saved = 0
        self.cow_copies = 0
        if paged:
            if page_size < 1 or max_len % page_size:
                raise ValueError(
                    f"max_len={max_len} must be a multiple of page_size={page_size}"
                )
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
            # the host tier: parked snapshots spill into a budgeted arena and
            # refill ahead of need on the transfer engine's priced timeline
            self.arena = paged_mod.HostArena(host_budget_bytes)
            self._xfer = TransferEngine(
                bandwidth_bytes_s=transfer_bandwidth_bytes_s, clock=self.clock,
                ledger=self.ledger if self.ledger is not None else ledger_mod.GLOBAL_LEDGER,
                faults=faults, integrity=self.integrity)
            # on the card, refills copy up on their own stream
            self._copy_stream = (torch.cuda.Stream(self.device)
                                 if self.device.type == "cuda" else None)
            if hsa_scheduler is not None:
                # refills ride the scheduler's prefetch pass too (never
                # blocking: the engine also pumps at the end of every step)
                hsa_scheduler.register_refill_source(self._pump_refills_external)
        else:
            if host_budget_bytes is not None:
                raise ValueError("host_budget_bytes requires paged=True")
            self.allocator = None
            self.arena = None
            self._xfer = None
            self._copy_stream = None
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
        if self.chunk_policy is not None and not self._chunk_safe():
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

    def _paged_safe(self) -> bool:
        """True iff every cache leaf is a plain GQA k/v tensor that pages
        (JAX's ``_paged_safe``): no MLA latent, recurrent state or ring."""
        return not self.model.cfg.attn_window and self._cache_keys <= {"k", "v"}

    def _chunk_safe(self) -> bool:
        """True iff chunked prefill is exact for this model (JAX's
        ``_chunk_safe``): every layer a plain dense-attention block over GQA
        k/v caches.  MoE capacity routing and recurrent scans are not
        row-local, MLA's latents have no chunk path, and a ring cache clips
        by position."""
        return (self._paged_safe() and self._cache_keys == {"k", "v"}
                and all(kind == "dense" for kind in self.model.kinds))

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
        slot's ``max_len`` rows; paged: its mapped pages, and the host
        arena's bytes against its budget), as the JAX engine records them;
        none for a recurrent cache."""
        if (self._token_bytes == 0 and self._cache is not None
                and self._cache_keys <= TIME_KEYS):
            self._token_bytes = paged_mod.pool_token_bytes(self._cache)
        if self.ledger is None or self._token_bytes == 0:
            return
        used = sum(int(self._pos[s]) for s in self._active) * self._token_bytes
        if self.paged:
            reserved = int(self._mapped.sum()) * self.page_size * self._token_bytes
        else:
            reserved = len(self._active) * self.max_len * self._token_bytes
        self.ledger.record_memory(reserved_bytes=reserved, used_bytes=used)
        if self.arena is not None:
            self.ledger.record_host_memory(used_bytes=self.arena.used_bytes,
                                           budget_bytes=self.arena.budget_bytes)

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
        no such mask, and a sliding window's ring keeps the *last* window
        rows of a prefill, which would be the pads."""
        return (not self.model.cfg.attn_window
                and not (self._cache_keys & self._RECURRENT_CACHE_KEYS))

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
        # admission charges only the unshared pages: a resident prefix
        # costs nothing to attach
        shared = len(self._lookup_prefix(req.prompt, req.uid)) if self.prefix is not None else 0
        return self.admission.admit(
            free_pages=self.allocator.free_pages,
            projected_growth_pages=self._projected_growth(),
            request_pages=max(0, self._projected_pages(req) - shared),
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
        """Finished, parked or aborted request: its page references drop
        now.  A page returns to the pool only when its last reader lets go,
        so its digest, its live-corruption record and its prefix-index
        entry are dropped only for the pages the allocator released."""
        pages = [int(p) for p in self._table[slot, : int(self._mapped[slot])]]
        rehome = False
        if pages:
            for p in self.allocator.free(req.uid, pages):
                # a freed page's digest dies with its contents (the next
                # owner stamps it again); an undetected corruption on it
                # never reached a token: latent, not escaped
                self._page_digests.pop(p, None)
                self._live_corrupt_pages.pop(p, None)
                if self._prefix_index is not None:
                    rehome = rehome or p in self._prefix_index.pages()
                    self._prefix_index.drop_page(p)
        self._tainted_slots.discard(slot)
        self._table[slot] = paged_mod.TRASH_PAGE
        self._mapped[slot] = 0
        self._projected.pop(slot, None)
        if self.prefix is not None:
            self._slot_shared[slot] = 0
            self._record_prefix_gauge()
            if rehome:
                # the released pages backed index entries, but other slots
                # may hold bitwise-equal private copies (first-wins losers):
                # publish their keys again, so a prefix stays discoverable
                # while any reader lives
                for s, r in self._active.items():
                    if s != slot:
                        self._publish_prefix(s, r)

    # -- prefix sharing: lookup / attach / publish ----------------------------------

    def _lookup_prefix(self, prompt: np.ndarray, uid: int) -> list[int]:
        """The longest resident, attachable page run covering a prefix of
        ``prompt``.  Capped at ``(len(prompt) - 1) // page_size`` pages so
        the suffix prefill always computes the last real row (whose logits
        sample token 0); the walk stops at the first miss, a page at its
        reader cap, or a page ``uid`` already holds."""
        if self._prefix_index is None or self._cache is None:
            return []
        cap = (len(prompt) - 1) // self.page_size
        if cap < 1:
            return []
        pages: list[int] = []
        for key in paged_mod.prefix_page_keys(prompt, self.page_size, max_pages=cap):
            p = self._prefix_index.get(key)
            if p is None:
                break
            refs = self.allocator.refcount(p)
            if refs == 0:                     # stale entry (page released)
                self._prefix_index.drop_page(p)
                break
            if refs >= self.prefix.max_refs or uid in self.allocator.owners_of(p):
                break
            pages.append(p)
        if len(pages) < self.prefix.min_prefix_pages:
            return []
        return pages

    def _count_prefix_lookup(self, shared: list[int]) -> None:
        self.prefix_lookups += 1
        if shared:
            self.prefix_hits += 1
            self.prefix_pages_saved += len(shared)
        if self.ledger is not None:
            self.ledger.record_prefix_lookup(hit=bool(shared), pages_saved=len(shared))

    def _share_prefix(self, slot: int, uid: int, pages: list[int]) -> None:
        """Map ``pages`` (a resident shared prefix) into ``slot``'s block
        table at +1 refcount each; the caller has reset the row."""
        for p in pages:
            self.allocator.share(p, uid)
        s = len(pages)
        self._table[slot, :s] = pages
        self._mapped[slot] = s
        self._slot_shared[slot] = s

    def _attach_prefix(self, slot: int, uid: int, pages: list[int]) -> None:
        self._share_prefix(slot, uid, pages)
        self._record_prefix_gauge()

    def _publish_prefix(self, slot: int, req: Request) -> None:
        """Register ``slot``'s full prompt pages in the prefix index, so
        later requests with the same prefix attach instead of prefilling.
        First wins: a key already published keeps its page."""
        if self._prefix_index is None:
            return
        full = len(req.prompt) // self.page_size
        if full < 1:
            return
        keys = paged_mod.prefix_page_keys(req.prompt, self.page_size, max_pages=full)
        for i, key in enumerate(keys):
            self._prefix_index.publish(key, int(self._table[slot, i]))

    def _record_prefix_gauge(self) -> None:
        if self.ledger is not None and self.prefix is not None:
            self.ledger.record_prefix_sharing(shared_pages=self.allocator.shared_pages)

    # -- integrity: digests, scrubbing, corruption injection ---------------------------

    def _sealed_pages(self, slot: int, rows: int) -> list[int]:
        """Pages of ``slot`` whose every row is final at ``rows`` written
        rows.  The trailing partial page is still being appended to by
        decode: never digested, never an injection target."""
        return [int(p) for p in self._table[slot, : rows // self.page_size]]

    def _seal_slot_pages(self, slot: int, rows: int) -> None:
        """Stamp digests on ``slot``'s sealed pages not stamped yet (at each
        write boundary: prefill, chunk, decode commit, snapshot restore).
        A stamped page's rows are final until it is freed, so an existing
        stamp stands: hashing again would launder an injected flip."""
        if self.integrity is None:
            return
        new = [p for p in self._sealed_pages(slot, rows) if p not in self._page_digests]
        self._page_digests.update(zip(new, paged_mod.page_digests(self._cache, new)))

    def _inject_corruption(self) -> None:
        """Seeded bit flips on cold state, drawn once a step: sealed pages
        of live and prefilling slots (flipped in the pool, in place) and
        parked snapshots in the arena.  Each is recorded, so the engine
        itself can count an escape if undetected bytes reach a sampled
        token.  Runs whether or not ``integrity`` is on (that is how a
        verification-off run shows escapes happen)."""
        if self.faults is None or not self.paged or self._cache is None:
            return
        # pages already corrupt are left out: a second flip would restore
        # the bytes and leave the accounting pointing at clean state
        targets: list[int] = []
        for slot in self._active:
            targets += [p for p in self._sealed_pages(slot, int(self._pos[slot]))
                        if p not in self._live_corrupt_pages]
        for slot, entry in self._prefilling.items():
            targets += [p for p in self._sealed_pages(slot, min(entry.filled, entry.n))
                        if p not in self._live_corrupt_pages]
        if targets:
            i = self.faults.draw_corruption("flip_page", [f"page[{p}]" for p in targets])
            if i is not None:
                page = targets[i]
                paged_mod.flip_page(self._cache, page)
                uid = self.allocator.owner_of(page)
                self._live_corrupt_pages[page] = uid if uid is not None else -1
                self.corruptions_injected += 1
                if self.ledger is not None:
                    self.ledger.record_corruption(kind="flip_page")
        uids = [u for u in self.arena.entries()
                if self.arena.load(u) is not None and u not in self._tainted_uids]
        if uids:
            i = self.faults.draw_corruption("flip_block", [f"block[uid={u}]" for u in uids])
            if i is not None:
                self.arena.corrupt(uids[i])
                self._tainted_uids.add(uids[i])
                self.corruptions_injected += 1
                if self.ledger is not None:
                    self.ledger.record_corruption(kind="flip_block")

    def _scrub_step(self) -> None:
        """Budgeted background audit: re-hash up to ``scrub_pages_per_step``
        stamped targets (device pages, then arena blocks) against their
        stamps, resuming at the first target after the last one scanned and
        wrapping, so every stamped target is audited within ceil(targets /
        budget) steps however the membership churns.  A bad page is
        quarantined and its readers re-prefilled; a bad arena block demotes
        its parked request to replay."""
        if self.integrity is None or self.integrity.scrub_pages_per_step <= 0:
            return
        budget = self.integrity.scrub_pages_per_step
        t0 = self.clock.now()
        targets: list[tuple[int, int]] = []
        if self._cache is not None:
            targets += [(0, p) for p in sorted(self._page_digests)]
        targets += [(1, u) for u in sorted(self.arena.entries())
                    if self.arena.digest_of(u) is not None]
        scanned_pages = scanned_blocks = 0
        bad: list[int] = []
        bad_uids: list[int] = []
        if targets:
            k = min(budget, len(targets))
            idx = bisect.bisect_right(targets, self._scrub_cursor)
            scan = [targets[(idx + j) % len(targets)] for j in range(k)]
            self._scrub_cursor = scan[-1]
            for tier, tid in scan:
                if tier == 0:
                    scanned_pages += 1
                    if paged_mod.page_digest(self._cache, tid) != self._page_digests[tid]:
                        bad.append(tid)
                else:
                    scanned_blocks += 1
                    if not self.arena.verify(tid):
                        bad_uids.append(tid)
        self.scrubbed_targets += scanned_pages + scanned_blocks
        if self.ledger is not None:
            self.ledger.record_scrub(pages=scanned_pages, blocks=scanned_blocks,
                                     targets=len(targets))
            self.ledger.record("scrub", max(0.0, self.clock.now() - t0))
        if bad:
            self._handle_corrupt_pages(bad, via="scrub")
        for uid in bad_uids:
            self.corruptions_detected += 1
            self._tainted_uids.discard(uid)
            if self.ledger is not None:
                self.ledger.record_integrity_detection(via="scrub", recovered=True)
            entry = next((e for e in self._parked if e.req.uid == uid), None)
            if entry is not None:
                self._demote_entry(entry)
            elif self.arena.holds(uid):
                self.arena.discard(uid)

    def _handle_corrupt_pages(self, pages: list[int], *, via: str) -> None:
        """Quarantine ``pages`` and re-prefill every reader from its prompt:
        every active reader parks through ``RESUME_REPREFILL`` (the fault
        lane) and every mid-prefill reader goes back to the queue.  The
        parks drop every reference first; then the free pages leave
        circulation.  Readers past the first of a shared page are the
        copy-on-write cost of sharing, counted as CoW copies."""
        err = SilentCorruption(f"digest mismatch on page(s) {pages} (via {via})")
        if self.prefix is not None:
            extra = sum(max(0, self.allocator.refcount(p) - 1) for p in pages)
            if extra:
                self.cow_copies += extra
                if self.ledger is not None:
                    self.ledger.record_prefix_cow(extra)
        for p in pages:
            self._live_corrupt_pages.pop(p, None)
            self._page_digests.pop(p, None)
        bad = set(pages)

        def reads_bad(slot: int) -> bool:
            return bool(bad & {int(q) for q in self._table[slot, : int(self._mapped[slot])]})

        for slot in sorted(s for s in self._active if reads_bad(s)):
            req = self._active[slot]
            req.fault_recoveries += 1
            if self.retry is not None and req.fault_recoveries > self.retry.max_request_recoveries:
                self._active.pop(slot)
                self._release_slot(slot, req)
                self._fail_request(req, err)
            else:
                self._park_slot(slot, mode=RESUME_REPREFILL, fault_t=self.clock.now())
        for slot in sorted(s for s in self._prefilling if reads_bad(s)):
            if self.retry is not None:
                self._abort_prefill_to_queue(slot, err)
            else:
                entry = self._prefilling.pop(slot)
                self._release_slot(slot, entry.req)
                entry.req.fault_recoveries += 1
                self._requeue(entry.req)
        if self.prefix is not None:
            # after the parks: a release publishes index entries again onto
            # surviving copies, which may put a bad page back; drop them last
            for p in pages:
                self._prefix_index.drop_page(p)
        for p in pages:
            self.corruptions_detected += 1
            if self.ledger is not None:
                self.ledger.record_integrity_detection(via=via, recovered=True)
            try:
                self.allocator.quarantine(p)
            except ValueError:
                continue                  # a freed page already allocated again
            self.pages_quarantined += 1
            if self.ledger is not None:
                self.ledger.record_page_quarantine()

    def _record_escape(self, n: int = 1) -> None:
        self.escaped_corruptions += n
        if self.ledger is not None:
            for _ in range(n):
                self.ledger.record_escape()

    def _requeue(self, req: Request) -> None:
        """Put ``req`` back in the queue in uid order."""
        idx = next((i for i, r in enumerate(self._queue) if r.uid > req.uid), len(self._queue))
        self._queue.insert(idx, req)

    # -- fault recovery ----------------------------------------------------------------

    @property
    def failed_requests(self) -> list[Request]:
        """Requests permanently killed by faults (recovery budget spent)."""
        return list(self._failed)

    def _fail_request(self, req: Request, err: BaseException) -> None:
        """Recovery budget spent: the request is dead, moved to the failed
        bucket (``ServeTruncated.failed``) instead of retried forever."""
        req.failed = err
        req.parked = False
        self._failed.append(req)
        if self.ledger is not None:
            self.ledger.record_recovery(failed=True)

    def _repark_faulted(self, entry: _Parked, err: FaultError) -> None:
        """A resume whose re-prefill faulted goes back to the parked list
        (budget permitting), its fault time kept, so the resume that
        succeeds reports the whole outage as its repair time."""
        req = entry.req
        req.fault_recoveries += 1
        if req.fault_recoveries > self.retry.max_request_recoveries:
            self._fail_request(req, err)
            return
        if entry.fault_t is None:
            entry.fault_t = self.clock.now()
        self._parked.append(entry)
        self._parked.sort(key=lambda e: e.req.uid)

    def _recover_decode_fault(self, err: FaultError) -> None:
        """A decode launch died to a fault after the scheduler's retries:
        park every live slot for re-prefill replay.  The launch committed
        nothing (the fault was drawn before its packet ran), but the KV
        behind a faulted launch is not trusted, so recovery recomputes the
        prompt's cache and replays the committed tokens.  Requests whose
        budget is spent fail instead.  Without an engine RetryPolicy (or
        unpaged) the fault propagates."""
        if self.retry is None or not self.paged:
            raise err
        now = self.clock.now()
        for slot in sorted(self._active):
            req = self._active[slot]
            req.fault_recoveries += 1
            if req.fault_recoveries > self.retry.max_request_recoveries:
                self._active.pop(slot)
                self._release_slot(slot, req)
                self._fail_request(req, err)
                continue
            self._park_slot(slot, mode=RESUME_REPREFILL, fault_t=now)

    def _abort_prefill_to_queue(self, slot: int, err: FaultError) -> None:
        """A chunked prefill's launch faulted: its partial rows are dropped
        and the request goes back to the queue in uid order (budget
        permitting); its prefill starts again from row 0."""
        entry = self._prefilling.pop(slot)
        req = entry.req
        if self.paged:
            self._release_slot(slot, req)
        req.fault_recoveries += 1
        if req.fault_recoveries > self.retry.max_request_recoveries:
            self._fail_request(req, err)
            return
        self._requeue(req)

    def _fund_growth(self, k: int) -> int:
        """Make this launch's page growth allocatable; the funded depth.

        On a shortfall the cheap lever comes first: the launch shrinks (k
        halves), since a shallower launch needs fewer pages ahead.  Only
        where even k = 1 cannot be funded does the engine park
        policy-chosen victims, one at a time with a re-plan between (a
        parked victim both frees its pages and drops its own need).  A lone
        request can always fund itself (``submit`` rejected anything whose
        worst case exceeds the pool), so the loop ends funded."""
        while True:
            needed = sum(max(0, self._launch_pages(slot, req, k) - int(self._mapped[slot]))
                         for slot, req in self._active.items())
            shortfall = needed - self.allocator.free_pages
            if shortfall <= 0:
                return k
            if k > 1:
                k = (k + 1) // 2
                continue
            victims = self.preemption.victims(self._candidates(), shortfall)
            if not victims:
                return k
            self._park_slot(next(s for s, r in self._active.items() if r.uid == victims[0]))

    def _ensure_pool(self) -> None:
        if self._cache is None:
            # the cache layout with pages for rows: [L, pool_pages, Hkv, page_size, hd]
            self._cache = self._zero_cache(self.allocator.num_pages, self.page_size)
            self._token_bytes = paged_mod.pool_token_bytes(self._cache)

    # -- preemption: park / resume ----------------------------------------------------

    @property
    def parked_requests(self) -> list[Request]:
        return [e.req for e in self._parked]

    def preempt(self, uid: int | None = None) -> int:
        """Park one active request, returning its pages to the pool now; its
        uid.  With ``uid=None`` the :class:`PreemptionPolicy` picks the
        victim.  This is how another tenant takes serving's memory back
        mid-flight: the request keeps its tokens so far and resumes by
        itself once pages free up."""
        if not self.paged:
            raise RuntimeError("preemption requires paged=True")
        with self._lock:
            if uid is None:
                victims = self.preemption.victims(self._candidates(), 1)
                if not victims:
                    raise ValueError("no active request to preempt")
                uid = victims[0]
            slot = next((s for s, r in self._active.items() if r.uid == uid), None)
            if slot is None:
                raise ValueError(f"request {uid} is not active")
            self._park_slot(slot)
            return uid

    def resume(self, uid: int) -> bool:
        """Try to resume a parked request now.  False when the pool (or a
        free slot) cannot take it yet: it stays parked.  Raises
        ``ValueError`` if ``uid`` is not parked (a double resume is a
        caller's bug)."""
        with self._lock:
            entry = next((e for e in self._parked if e.req.uid == uid), None)
            if entry is None:
                raise ValueError(f"request {uid} is not parked (double resume?)")
            slot = next((s for s in range(self.slots)
                         if s not in self._active and s not in self._prefilling), None)
            if slot is None:
                return False
            return self._try_resume(entry, slot)

    def _candidates(self) -> list[PreemptionCandidate]:
        return [PreemptionCandidate(uid=req.uid, mapped_pages=int(self._mapped[slot]),
                                    tokens_done=int(self._pos[slot]))
                for slot, req in self._active.items()]

    def _park_slot(self, slot: int, *, mode: str | None = None,
                   fault_t: float | None = None) -> None:
        """Reclaim one active request's pages; keep its progress on the
        host.  A snapshot is copied off the card (into the arena) before
        the pages are freed, so a later launch may overwrite them; it
        leaves out the slot's shared-prefix pages, which stay resident
        under other readers' refcounts.  ``mode`` overrides the policy's
        resume mode (fault recovery forces re-prefill: nothing is trusted
        after a faulted launch); ``fault_t`` marks a fault's park for the
        repair time at resume."""
        req = self._active.pop(slot)
        t0 = time.perf_counter_ns()
        pos = int(self._pos[slot])
        if mode is None:
            mode = self.preemption.resume_mode(tokens_done=pos)
        snap_bytes = 0
        reclaimed = int(self._mapped[slot])
        shared = int(self._slot_shared[slot]) if self.prefix is not None else 0
        if mode == RESUME_SNAPSHOT:
            # only the pages holding written rows (0 .. pos-1) matter: pages
            # mapped ahead for a launch that never ran hold nothing
            keep = paged_mod.pages_for(pos, self.page_size)
            snap_bytes = (keep - shared) * self.page_size * self._token_bytes
            if not self._spill_snapshot(req.uid, self._table[slot, shared:keep].copy(),
                                        snap_bytes, pos):
                mode, snap_bytes = RESUME_REPREFILL, 0
        if mode == RESUME_REPREFILL:
            shared = 0                      # replay looks its prefix up afresh
        self._release_slot(slot, req)
        req.parked = True
        req.preemptions += 1
        self._parked.append(_Parked(req=req, pos=pos, mode=mode, fault_t=fault_t,
                                    shared_pages=shared))
        self._parked.sort(key=lambda e: e.req.uid)
        self.preemptions += 1
        self.pages_reclaimed += reclaimed
        if self.ledger is not None:
            self.ledger.record(ledger_mod.PREEMPT_PARK, (time.perf_counter_ns() - t0) * 1e-9,
                               producer=self._producer, what=mode, uid=req.uid)
            self.ledger.record_preemption(pages_reclaimed=reclaimed, snapshot_bytes=snap_bytes)

    def _try_resume(self, entry: _Parked, slot: int) -> bool:
        """Bring a parked request back into ``slot`` if the pool can fund
        it: the test of a fresh admission (projected lifetime pages against
        free pages less the growth in flight), floored by what the resume
        maps at once (a snapshot restore maps every written row's page),
        less the shared prefix it attaches."""
        req = entry.req
        attach: list[int] = []
        if self.prefix is not None:
            attach = self._lookup_prefix(req.prompt, req.uid)
        if entry.mode == RESUME_SNAPSHOT and entry.shared_pages > len(attach):
            # the shared prefix this snapshot leaned on has gone while it
            # was parked: the snapshot lacks those rows, so this is the
            # copy-on-write moment: replay, which rebuilds the prefix
            self.cow_copies += 1
            if self.ledger is not None:
                self.ledger.record_prefix_cow()
            self._demote_entry(entry)
        if entry.mode == RESUME_SNAPSHOT:
            attach = attach[: entry.shared_pages]
            need_now = paged_mod.pages_for(entry.pos, self.page_size) - len(attach)
        else:
            need_now = max(0, paged_mod.pages_for(len(req.prompt), self.page_size) - len(attach))
        if not self.admission.admit(
                free_pages=self.allocator.free_pages,
                projected_growth_pages=self._projected_growth(),
                request_pages=max(need_now, self._projected_pages(req) - len(attach))):
            return False
        t0 = time.perf_counter_ns()
        self._parked.remove(entry)
        recompute = 0
        if entry.mode == RESUME_SNAPSHOT:
            # wait on the ahead-of-need refill (only its exposed residue
            # stalls the resume); a cold resume issues it now.  A faulted or
            # corrupted refill demotes the entry to replay
            x = entry.refill
            if x is None:
                x = self._issue_refill(entry)
                if x.error is None:
                    self._stage(entry, x)
            if x.error is not None:
                self.transfer_faults += 1
                self._demote_entry(entry)
            else:
                try:
                    self._xfer.wait(x)
                except CorruptPayload:
                    # the refill delivered wrong bytes (arena rot or a
                    # corrupted copy, caught by the payload digest)
                    self.transfer_faults += 1
                    self.corruptions_detected += 1
                    self._tainted_uids.discard(req.uid)
                    self._demote_entry(entry)
                else:
                    self._restore(entry, slot, x, attach)
        if entry.mode == RESUME_REPREFILL:
            # re-prefill and replay: the prompt's cache again (the same
            # function of the same tokens), the request rewound, and the
            # normal decode path regenerating the committed tokens, checked
            # against ``req.replay`` launch by launch
            committed = req.replay if req.replay is not None else req.generated
            recompute = len(req.prompt) + len(committed) - 1
            req.replay = committed
            req.generated = []
            try:
                self._prefill_slot(slot, req)
            except FaultError as e:
                # the recovery prefill itself faulted: park again (the
                # committed tokens live on in req.replay) or fail on budget
                if self.retry is None:
                    raise
                self._repark_faulted(entry, e)
                return False
            if req.generated[0] != committed[0]:
                raise RuntimeError(
                    f"preemption replay diverged at request {req.uid} token 0: re-prefill "
                    f"sampled {req.generated[0]}, committed {committed[0]}")
        req.parked = False
        self._active[slot] = req
        self.resumes += 1
        self.recompute_tokens += recompute
        if self.ledger is not None:
            self.ledger.record(ledger_mod.PREEMPT_RESUME, (time.perf_counter_ns() - t0) * 1e-9,
                               producer=self._producer, what=entry.mode, uid=req.uid)
            self.ledger.record_resume(mode=entry.mode, recompute_tokens=recompute)
        if entry.fault_t is not None:
            # a fault's park healed: park to resume on the engine clock is
            # the request's repair time, and its replay recovery recompute
            mttr = max(0.0, self.clock.now() - entry.fault_t)
            if self.ledger is not None:
                self.ledger.record(ledger_mod.RECOVER, mttr, producer=self._producer,
                                   what=entry.mode, uid=req.uid)
                self.ledger.record_recovery(mttr_s=mttr, recompute_tokens=recompute)
        return True

    def _restore(self, entry: _Parked, slot: int, x, attach: list[int]) -> None:
        """Land a waited refill: attach the shared prefix again, map the
        private pages and write the snapshot into them in place (from the
        copy up in flight on the card), then stamp the restored pages."""
        req = entry.req
        entry.refill = None
        # what the copy delivered is what lands: a corrupted transfer's
        # bytes (verification off), or the arena entry as it is now.  A
        # payload the refill read before the entry rotted is clean, and the
        # rotted copy is dropped unread (the JAX engine counts an escape
        # there)
        stored = self.arena.load(req.uid)
        tainted = x.corrupted or (req.uid in self._tainted_uids
                                  and (x.payload is None or x.payload is stored))
        if x.payload is not None:
            snapshot = x.payload
            self.arena.discard(req.uid)
        else:
            snapshot = self.arena.take(req.uid)
        self.refills += 1
        n = paged_mod.pages_for(entry.pos, self.page_size)
        s = len(attach)
        self._table[slot] = paged_mod.TRASH_PAGE
        if s:
            # the prefix rows never left the card: attach them again
            self._attach_prefix(slot, req.uid, attach)
        pages = self.allocator.allocate(req.uid, n - s)
        self._table[slot, s:n] = pages
        self._mapped[slot] = n
        if entry.staged is not None and x.payload is None and req.uid in self._tainted_uids:
            # the arena entry rotted after its copy up started, and no
            # payload rode the transfer: what lands is what it holds now
            entry.staged = None
            self._copies["h2d_cancelled"] += 1
        if entry.staged is not None:
            # the serving stream waits for the copy up, then scatters
            entry.staged.land(self._cache, pages)
            self._landed.append(entry.staged)
            entry.staged = None
            self._fold_copies(wait=False)
        else:
            ts = time.perf_counter()
            paged_mod.restore_pages(self._cache, snapshot, pages)
            self._copies["h2d_s"] += time.perf_counter() - ts
            self._copies["h2d_bytes"] += paged_mod.snapshot_bytes(snapshot)
        self._pos[slot] = entry.pos
        self._projected[slot] = self._projected_pages(req)
        self._slot_key[slot] = sampling.key_of(self.seed, req.uid)
        self._seal_slot_pages(slot, entry.pos)
        self._tainted_uids.discard(req.uid)
        if tainted:
            # verification off: wrong bytes were restored; the commit path
            # counts the escape
            self._tainted_slots.add(slot)

    # -- the host tier: spill / refill / demotion ---------------------------------------

    def _gather(self, pages: np.ndarray) -> dict:
        """A snapshot of ``pages`` copied off the card, timed."""
        ts = time.perf_counter()
        snapshot = paged_mod.snapshot_buffers(self._cache, len(pages),
                                              pin=self.device.type == "cuda")
        tc = time.perf_counter()
        paged_mod.gather_pages(self._cache, pages, snapshot)
        self._copies["d2h_alloc_s"] += tc - ts
        self._copies["d2h_s"] += time.perf_counter() - tc
        self._copies["d2h_bytes"] += paged_mod.snapshot_bytes(snapshot)
        return snapshot

    def _spill_snapshot(self, uid: int, pages: np.ndarray, nbytes: int, pos: int) -> bool:
        """Spill a fresh park's snapshot of ``pages`` into the host arena.
        False when the park must degrade to re-prefill replay instead: the
        snapshot can never fit the budget, its transfer faulted, or every
        demotable snapshot was demoted and it still does not fit (with
        ``SpillPolicy.allow_replay`` off, these raise).  The pages are
        copied once the store is funded, or, with integrity on, at once:
        their digest rides the transfer."""
        arena = self.arena
        arena.configure(self.page_size * self._token_bytes)
        if not arena.can_ever_fit(nbytes):
            if not self.spill.allow_replay:
                raise paged_mod.HostArenaExhausted(
                    f"snapshot of {nbytes} B cannot ever fit host budget "
                    f"{arena.budget_bytes} B and replay is disabled")
            self._count_demotion(bytes_freed=0, replay_tokens=pos)
            return False
        snapshot = digest = None
        if self.integrity is not None:
            # the digest is stamped at the write boundary, before the copy,
            # so corruption in the transfer or in the arena is caught later
            snapshot = self._gather(pages)
            digest = paged_mod.tree_digest(snapshot)
        x = self._xfer.issue("d2h", f"kv[uid={uid}]", nbytes, payload=snapshot, digest=digest)
        if x.error is not None:
            self.transfer_faults += 1
            if isinstance(x.error, CorruptPayload):
                self.corruptions_detected += 1
            if not self.spill.allow_replay:
                raise x.error
            self._count_demotion(bytes_freed=0, replay_tokens=pos)
            return False
        while not arena.fits(nbytes):
            if not self.spill.allow_replay:
                raise paged_mod.HostArenaExhausted(
                    f"store of {nbytes} B over host budget {arena.budget_bytes} B "
                    f"({arena.used_bytes} B used) and replay is disabled")
            cands = [SpillCandidate(uid=e.req.uid, arena_bytes=arena.bytes_of(e.req.uid),
                                    tokens_done=e.pos)
                     for e in self._parked
                     if e.mode == RESUME_SNAPSHOT and arena.holds(e.req.uid)]
            if not cands:
                # nothing left to demote: the incoming snapshot degrades
                self._count_demotion(bytes_freed=0, replay_tokens=pos)
                return False
            short = arena.blocks_for(nbytes) - arena.free_blocks
            for v_uid in self.spill.victims(cands, short * arena.block_bytes):
                self._demote_entry(next(e for e in self._parked if e.req.uid == v_uid))
        if snapshot is None:
            snapshot = self._gather(pages)
        # store what the transfer delivered (a corrupted copy, with
        # verification off) under the pre-transfer digest
        arena.store(uid, x.payload if x.payload is not None else snapshot, nbytes,
                    digest=digest)
        if x.corrupted:
            self._tainted_uids.add(uid)
        self.spills += 1
        return True

    def _issue_refill(self, entry: _Parked):
        """Issue the refill of ``entry``'s arena snapshot on the transfer
        timeline, its stored payload and store-time digest riding along
        (integrity on) so the wait can verify what it delivered."""
        uid = entry.req.uid
        payload = digest = None
        if self.integrity is not None:
            payload, digest = self.arena.load(uid), self.arena.digest_of(uid)
        return self._xfer.issue("h2d", f"kv[uid={uid}]", self.arena.bytes_of(uid),
                                payload=payload, digest=digest)

    def _stage(self, entry: _Parked, x) -> None:
        """On the card, start the refill's real copy up on the side stream:
        of the bytes the transfer delivers."""
        if self._copy_stream is not None:
            saved = x.payload if x.payload is not None else self.arena.load(entry.req.uid)
            entry.staged = paged_mod.StagedRefill(saved, self.device, self._copy_stream)

    @property
    def copy_stats(self) -> dict:
        """The real copies behind the priced timeline: bytes and seconds of
        the snapshot gathers (device to host; their pinned buffers'
        allocation apart) and of the refills (host to device: on the card,
        the side stream's copy time by its events, ``h2d_waited_s`` the time
        the serving stream waited past the resume's need of it, and
        ``h2d_cancelled`` copies dropped by a demotion).  Reading it waits
        for refills still in flight, never the serving step."""
        self._fold_copies(wait=True)
        return dict(self._copies)

    def _fold_copies(self, *, wait: bool) -> None:
        """Add landed refills' event timings into the copy counters: every
        one (``wait``), or only those the card has finished."""
        pending = []
        for staged in self._landed:
            if wait or staged.finished():
                copy_s, waited_s = staged.seconds()
                self._copies["h2d_s"] += copy_s
                self._copies["h2d_waited_s"] += waited_s
                self._copies["h2d_bytes"] += staged.nbytes
            else:
                pending.append(staged)
        self._landed = pending

    def _demote_entry(self, entry: _Parked) -> None:
        """Demote one parked snapshot to re-prefill replay: its arena bytes
        go back to the budget, its refill in flight (if any) is cancelled,
        and the resume recomputes ``entry.pos`` rows instead."""
        uid = entry.req.uid
        freed = self.arena.discard(uid) if self.arena.holds(uid) else 0
        # a tainted entry demoted to replay never restores its bytes
        self._tainted_uids.discard(uid)
        if entry.refill is not None:
            self._xfer.cancel(entry.refill)
            entry.refill = None
        if entry.staged is not None:
            # its device tensors were only written on the side stream
            entry.staged = None
            self._copies["h2d_cancelled"] += 1
        entry.mode = RESUME_REPREFILL
        self._count_demotion(bytes_freed=freed, replay_tokens=entry.pos)

    def _count_demotion(self, *, bytes_freed: int, replay_tokens: int) -> None:
        self.demotions += 1
        self.replay_fallback_tokens += replay_tokens
        if self.ledger is not None:
            self.ledger.record_demotion(bytes_freed=bytes_freed, replay_tokens=replay_tokens)

    def _pump_refills(self) -> None:
        """Issue refills for the parked snapshots nearest resume: the first
        ``SpillPolicy.refill_lookahead`` parked entries (the order the step
        resumes them).  Entries with a refill in flight are skipped; a
        refill that faults demotes its entry to replay at once."""
        if not self.paged:
            return
        for entry in list(self._parked[: self.spill.refill_lookahead]):
            if entry.mode != RESUME_SNAPSHOT or entry.refill is not None:
                continue
            if not self.arena.holds(entry.req.uid):
                continue
            x = self._issue_refill(entry)
            if x.error is not None:
                self.transfer_faults += 1
                self._demote_entry(entry)
                continue
            entry.refill = x
            self._stage(entry, x)

    def _pump_refills_external(self) -> None:
        """The scheduler's pump (``register_refill_source``): never blocks;
        if a step holds the engine's lock it skips (the step pumps itself)."""
        if not self._lock.acquire(blocking=False):
            return
        try:
            self._pump_refills()
        finally:
            self._lock.release()

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
        if self.prefix is not None:
            shared = self._lookup_prefix(req.prompt, req.uid)
            self._count_prefix_lookup(shared)
            if shared:
                self._prefill_shared(slot, req, shared)
                return
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
        # every launch is done: a fault above left the engine's state as it was
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
        self._seal_slot_pages(slot, n)
        if self.prefix is not None:
            self._publish_prefix(slot, req)

    def _prefill_shared(self, slot: int, req: Request, shared: list[int]) -> None:
        """Prefill only the unshared suffix of ``req.prompt``: one chunk of
        the padded prompt's rows from ``srows`` (the shared pages' rows),
        written into the slot's private pages and attending the shared rows
        in place through the block table.  The shared pages hold the rows a
        private prefill would compute (a KV row depends only on the tokens
        up to it, and the page keys chain over the whole prefix), and a
        chunk's rows are the whole prompt's bit for bit, so this is a
        private prefill's cache.  The suffix starts on a page boundary, so
        no row of it, pad rows included, lands in a shared page.  The pages
        are mapped before the launch (the chunk writes through them); a
        fault gives them back, the private ones onto the free list in the
        order they left it."""
        n = len(req.prompt)
        s = len(shared)
        srows = s * self.page_size
        b = self.bucket_len(n, self.max_len) if self.bucket_prompts else n
        tokens = np.pad(req.prompt, (0, b - n)) if b > n else req.prompt
        n_store = paged_mod.pages_for(n, self.page_size)
        self._table[slot] = paged_mod.TRASH_PAGE
        self._share_prefix(slot, req.uid, shared)
        priv = self.allocator.allocate(req.uid, n_store - s)
        self._table[slot, s:n_store] = priv
        self._mapped[slot] = n_store
        try:
            cache = {**self._cache, "block_table": torch.as_tensor(self._table[slot:slot + 1],
                                                                   device=self.device)}
            logits, _ = self._launch(
                "prefill_chunk", self.model.prefill_chunk, self.params,
                torch.as_tensor(tokens[None, srows:b], device=self.device), cache, start=srows)
            self.chunk_calls += 1
            rows = (paged_mod.gather_rows(self._cache, self._table[slot], n, self.page_size)
                    if b > n else None)
            self._first_token(slot, req, logits, rows)
        except FaultError:
            self.allocator.free(req.uid, priv[::-1] + shared)
            self._table[slot] = paged_mod.TRASH_PAGE
            self._mapped[slot] = 0
            self._slot_shared[slot] = 0
            raise
        self._record_prefix_gauge()
        self._projected[slot] = self._projected_pages(req)
        self._pos[slot] = n
        self._seal_slot_pages(slot, n)
        self._publish_prefix(slot, req)

    # -- chunked prefill (continuous batching) ------------------------------------------

    def _chunk_for_new(self, req: Request) -> int:
        """Chunk size a newly admitted request will prefill at (fixed for the
        request's whole prefill), from the live decode slots and the last
        launch's depth."""
        return self.chunk_policy.choose_chunk(
            live_decode=len(self._active), fusion_k=self._last_fusion_k)

    def _admit_chunked(self, req: Request) -> bool:
        """Paged admission for a chunked prefill: charge the *first chunk's*
        pages (past a shared prefix, which costs nothing); the rest of the
        prompt is projected growth."""
        chunk = self._chunk_for_new(req)
        shared = len(self._lookup_prefix(req.prompt, req.uid)) if self.prefix is not None else 0
        first = max(0, paged_mod.pages_for(min(len(req.prompt), shared * self.page_size + chunk),
                                           self.page_size) - shared)
        return self.admission.admit(
            free_pages=self.allocator.free_pages,
            projected_growth_pages=self._projected_growth(),
            request_pages=first,
        )

    def _start_chunked(self, slot: int, req: Request) -> None:
        """Admit ``req`` into ``slot`` as a chunked prefill; with a shared
        prefix resident, its chunks start at the first unshared page."""
        n = len(req.prompt)
        b = self.bucket_len(n, self.max_len)
        tokens = np.pad(req.prompt, (0, b - n)) if b > n else req.prompt
        staging = None
        shared: list[int] = []
        if self.paged:
            self._ensure_pool()
            if self.prefix is not None:
                shared = self._lookup_prefix(req.prompt, req.uid)
                self._count_prefix_lookup(shared)
            self._table[slot] = paged_mod.TRASH_PAGE
            self._mapped[slot] = 0
            if shared:
                self._attach_prefix(slot, req.uid, shared)
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
                                             chunk=self._chunk_for_new(req), staging=staging,
                                             filled=len(shared) * self.page_size)

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
        if self.paged and start < entry.n:
            self._seal_slot_pages(slot, min(start + size, entry.n))
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
        if self.prefix is not None:
            self._publish_prefix(slot, req)
        del self._prefilling[slot]
        self._active[slot] = req
        if req.first_token_t is None:
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
        if self.decode_logits_tap is not None:
            self.decode_logits_tap(logits)
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
        once, with the slots' positions and last tokens."""
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
            # fund this launch's growth: a shallower launch first, then
            # preemption (under overcommit the pool can run dry mid-decode)
            k = self._fund_growth(k)
            if not self._active:
                return []                   # every live slot became a victim
            # re-cap to the survivors' budgets (growth was funded for the larger k)
            k = max(1, min(k, max(r.max_new_tokens - len(r.generated)
                                  for r in self._active.values())))
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
        # the sealed pages this launch reads, at the positions before it:
        # decode writes only past them, so a digest mismatch after the
        # launch is silent corruption
        sealed_before: dict[int, list[int]] = {}
        if self.paged:
            sealed_before = {slot: self._sealed_pages(slot, int(self._pos[slot]))
                             for slot in self._active}
            table = self._table
            if self._prefilling:
                # a mid-prefill slot has real pages mapped but is masked in this
                # launch: its dummy writes at its stale position must land on the
                # scratch page, not on the chunk rows already written
                table = table.copy()
                table[list(self._prefilling)] = paged_mod.TRASH_PAGE
            table = torch.from_numpy(table)     # on the host: the launch uploads it
        # one packet a fused launch, named as the JAX engine names it
        name = f"decode_fused_k{k}" + ("_paged" if self.paged else "")
        try:
            toks, valid = self._launch(name, self._fused_decode, k, active, remaining, table)
        except FaultError as e:
            # the packet never ran: nothing of the launch was written
            self._recover_decode_fault(e)
            return []
        self.decode_tokens += int(valid.sum())
        if self.paged:
            # before any token commits (a slot parked here keeps none)
            self._verify_reads(sealed_before)
        finished = []
        for slot, req in list(self._active.items()):
            if slot in self._tainted_slots:
                # restored from a corrupted payload with verification off:
                # the stream parts from its first commit after the restore
                self._tainted_slots.discard(slot)
                self._record_escape()
            req.generated.extend(int(t) for t in toks[valid[:, slot], slot])
            if req.replay is not None:
                # a re-prefill resume in flight: the regenerated tokens must
                # be the committed ones bit for bit, checked every launch
                n = min(len(req.generated), len(req.replay))
                if req.generated[:n] != req.replay[:n]:
                    raise RuntimeError(
                        f"preemption replay diverged at request {req.uid}: regenerated "
                        f"{req.generated[:n]} != committed {req.replay[:n]}")
                if len(req.generated) >= len(req.replay):
                    req.replay = None          # fully replayed: normal decode
            if len(req.generated) >= req.max_new_tokens:
                req.done = True
                finished.append(req)
                if self.paged:
                    self._release_slot(slot, req)
                del self._active[slot]
        # stamp the pages this launch filled (the decode commit's write
        # boundary): the survivors'; finished slots were released
        if self.paged and self.integrity is not None:
            for slot in self._active:
                self._seal_slot_pages(slot, int(self._pos[slot]))
        return finished

    def _verify_reads(self, sealed_before: dict[int, list[int]]) -> None:
        """The check before a launch's tokens commit: hash the sealed pages
        it read (one gather and one copy off the card for all of them) and
        compare each with its stamp; a mismatch parks every reader at its
        state before the launch, so corrupt bytes never reach a committed
        token.  With verification off, a launch that read a known-corrupt
        page counts an escape."""
        verify = self.integrity is not None and self.integrity.verify_reads
        fresh: dict[int, bytes] = {}
        if verify:
            due = sorted({p for slot in self._active for p in sealed_before.get(slot, ())
                          if p in self._page_digests})
            t0 = time.perf_counter()
            fresh = dict(zip(due, paged_mod.page_digests(self._cache, due)))
            st = self.verify_stats
            st["s"] += time.perf_counter() - t0
            st["launches"] += 1
            st["pages"] += len(due)
            st["bytes"] += len(due) * self.page_size * self._token_bytes
        corrupt: set[int] = set()
        for slot in list(self._active):
            for p in sealed_before.get(slot, ()):
                if verify and p in self._page_digests:
                    if fresh[p] != self._page_digests[p]:
                        corrupt.add(p)
                elif p in self._live_corrupt_pages:
                    # verification off: this launch read known-bad bytes,
                    # and the token about to commit parts from the stream
                    self._live_corrupt_pages.pop(p)
                    self._record_escape()
        if corrupt:
            self._handle_corrupt_pages(sorted(corrupt), via="read")

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
            # integrity: this step's corruption draws on the state before it,
            # then the scrub budget: a detection parks its readers before
            # any launch can read the bad bytes
            self._inject_corruption()
            self._scrub_step()
            chunked = self.chunk_policy is not None
            # the step's work for the step time model: a whole prompt's
            # bucket rows, a chunk's rows (pad rows included)
            prefill_tokens = 0
            for slot in range(self.slots):
                if slot in self._active or slot in self._prefilling:
                    continue
                if self.paged and self._parked:
                    # parked requests were admitted before anything queued,
                    # so they resume first, and an unresumable head blocks
                    # younger work as the queue's head does
                    if not self._try_resume(self._parked[0], slot):
                        break
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
                    continue
                try:
                    self._prefill_slot(slot, req)
                except FaultError as e:
                    if self.retry is None:
                        raise
                    # the launch faulted before any of the engine's state
                    # moved: the request goes back to the queue's head
                    # (FIFO kept) for the next free slot, or fails on budget
                    req.fault_recoveries += 1
                    if req.fault_recoveries > self.retry.max_request_recoveries:
                        self._fail_request(req, e)
                    else:
                        self._queue.insert(0, req)
                    continue
                prefill_tokens += (self.bucket_len(len(req.prompt), self.max_len)
                                   if self.bucket_prompts else len(req.prompt))
                self._active[slot] = req
                if req.first_token_t is None:
                    self._first_this_step.append(req)
            if self._prefilling:
                prefill_tokens += self._chunk_phase()
            finished = self._decode_locked() if self._active else []
            # refills for the parked snapshots nearing resume, issued before
            # the clock advances so that the step's modeled time hides them
            self._pump_refills()
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
        the rows prefilled.  A chunk's fault sends its request back to the
        queue."""
        rows = 0
        for slot in sorted(self._prefilling, key=lambda s: self._prefilling[s].req.uid):
            try:
                rows += self._chunk_step(slot, self._prefilling[slot])
            except FaultError as e:
                if self.retry is None:
                    raise
                self._abort_prefill_to_queue(slot, e)
        if self.paged and self._prefilling and rows == 0 and not self._active:
            # every prefill stalled and nothing is decoding: no pages will free
            # on their own.  Abort the youngest prefill back into the queue (uid
            # order kept); its pages fund the senior ones
            slot = max(self._prefilling, key=lambda s: self._prefilling[s].req.uid)
            entry = self._prefilling.pop(slot)
            self._release_slot(slot, entry.req)
            self._requeue(entry.req)
        return rows

    def run_to_completion(self, max_steps: int = 10_000) -> list[Request]:
        """Step until every submitted request finishes; the completed requests.

        Raises :class:`ServeTruncated` if ``max_steps`` steps were not enough
        (truncation is never returned as success), its requests split into
        pending, parked, rejected and failed; it raises at once when nothing
        runs and the seniority head can never fit, or when only requests
        killed by faults are left.  Pool exhaustion itself never raises:
        the engine preempts and resumes through it, and with an engine
        :class:`RetryPolicy` a transient fault does not raise either.
        """
        done: list[Request] = []
        for _ in range(max_steps):
            done += self.step()
            with self._lock:
                if (not self._active and not self._prefilling and not self._queue
                        and not self._parked):
                    if self._failed:
                        break                  # fault-killed requests are permanent
                    return done
                if not self._active and not self._prefilling and self.paged:
                    # nothing runs, so nothing will free pages: a seniority
                    # head (parked before queued) that can never fit makes
                    # every further step a no-op
                    head = (self._parked[0].req if self._parked
                            else self._queue[0] if self._queue else None)
                    if head is not None and self._never_fits(head):
                        break
        with self._lock:
            if not (self._active or self._prefilling or self._queue or self._parked
                    or self._failed):
                return done
            pending = list(self._active.values()) + [e.req for e in self._prefilling.values()]
            parked: list[Request] = []
            rejected: list[Request] = []
            for req in self._queue:
                (rejected if self.paged and self._never_fits(req) else pending).append(req)
            for entry in self._parked:
                (rejected if self._never_fits(entry.req) else parked).append(entry.req)
            raise ServeTruncated(done, pending, parked=parked, rejected=rejected,
                                 failed=list(self._failed))
