"""Shared model building blocks: ``repro/models/layers.py``.

Every compute hot spot goes through ``dispatch.op`` — matmuls, norms,
attention — so the model is transparently retargetable between the
reference, torch and cuda sources (the paper's property).  Functions are
plain functions on tensors; parameters are dicts from
:mod:`repro_torch.models.params`.  Layouts follow the JAX package's: rows
are ``[B, S, d]``, per-head tensors ``[B, S, H, hd]``, caches
``[B, Hkv, T, hd]``.

**Under sharding rules** (:func:`repro_torch.dist.act.use_rules` with a
live mesh) each leaf holds this rank's slice of its placement, and the
layers issue the collectives GSPMD inserts in JAX
(:mod:`repro_torch.dist.collectives`): a vocab-split table embeds by a
masked lookup and a sum over the model axis, and unembeds to local logits
gathered along the vocabulary; the MLP is column- then row-parallel, one
sum after ``wd``; attention runs on this rank's heads where they divide
the model axis (q's heads beside the k/v heads they read, one sum after
``wo``); a leaf whose activation the rules would leave whole (k/v heads
that do not divide, the SSM's and MLA's inner widths) is gathered whole
first (:func:`whole`), as GSPMD reshards it.  Serving decode with k/v
heads that do not divide the model axis and a time-split cache runs
sequence-parallel (:func:`_sp_decode_attention`, JAX's
``_sp_decode_body``).  Outside rules every collective is the identity.
"""

from __future__ import annotations

import contextlib
import math
from typing import Any, Iterator

import torch

from repro_torch import kernels  # noqa: F401  (registry population)
from repro_torch.configs.base import ArchConfig
from repro_torch.core import dispatch
from repro_torch.dist import act, collectives
from repro_torch.dist.sharding import entry_axes
from repro_torch.models.params import ParamSpec

Params = Any
COMPUTE_DTYPE = torch.bfloat16


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------


def rope_table(positions: torch.Tensor, dim: int,
               theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for given positions: [..., dim/2], f32."""
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=positions.device) / dim
    freqs = 1.0 / (theta ** exps)
    angles = positions.to(torch.float32)[..., None] * freqs
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: [..., S, H, D]; cos/sin: [S, D/2] (or broadcastable)."""
    d2 = x.shape[-1] // 2
    xf1, xf2 = x[..., :d2].float(), x[..., d2:].float()
    c = cos[..., :, None, :]            # broadcast over the head axis
    s = sin[..., :, None, :]
    return torch.cat([xf1 * c - xf2 * s, xf2 * c + xf1 * s], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# placements under the active rules
# ---------------------------------------------------------------------------


def split_group(name: str, dim: int):
    """The process group a dimension of ``dim`` named ``name`` is split
    over under the active rules (None: whole, or no rules)."""
    rules = act.current()
    if rules is None:
        return None
    entry = rules.act_pspec((dim,), (name,))[0]
    return None if entry is None else act.group(entry_axes(entry))


def whole(w: torch.Tensor, logical, shape) -> torch.Tensor:
    """The leaf ``w`` of global ``shape`` in full: gathered along each
    dimension the active rules split (``w`` itself outside rules)."""
    rules = act.current()
    if rules is None:
        return w
    for dim, entry in enumerate(rules.act_pspec(shape, logical)):
        if entry is not None:
            w = collectives.gather(w, dim, act.group(entry_axes(entry)))
    return w


def whole_tree(p: Params, specs: Params) -> Params:
    """Every leaf of ``p`` in full (:func:`whole`, by ``specs``); a derived
    f32 copy (``wo_f32``) by its source leaf's spec."""
    if act.current() is None:
        return p
    out = {}
    for key, v in p.items():
        spec = specs[key.removesuffix("_f32")]
        out[key] = whole_tree(v, spec) if isinstance(v, dict) else whole(v, spec.logical,
                                                                            spec.shape)
    return out


# ---------------------------------------------------------------------------
# elementary modules
# ---------------------------------------------------------------------------


def linear_spec(d_in: int, d_out: int, logical: tuple[str | None, str | None]) -> ParamSpec:
    return ParamSpec(shape=(d_in, d_out), logical=logical, scale=1.0 / math.sqrt(d_in))


def norm_spec(d: int) -> ParamSpec:
    return ParamSpec(shape=(d,), logical=(None,), init="ones")


def apply_norm(p: torch.Tensor, x: torch.Tensor, eps: float) -> torch.Tensor:
    return dispatch.op("rmsnorm", x, p, eps=eps)


def embed_specs(cfg: ArchConfig) -> Params:
    p: dict[str, ParamSpec] = {"tok": ParamSpec(shape=(cfg.vocab_size, cfg.d_model),
                                                logical=("vocab", "embed"), scale=0.02)}
    if not cfg.tie_embeddings:
        p["unembed"] = linear_spec(cfg.d_model, cfg.vocab_size, ("embed", "vocab"))
    return p


def embed_tokens(p: Params, tokens: torch.Tensor, vocab: int | None = None) -> torch.Tensor:
    """The rows of ``tokens``.  With ``vocab`` (the global vocabulary) and
    a table the rules split over the model axis: each rank looks up the
    tokens its rows hold, zeros elsewhere, and one sum joins them (exact:
    one term of the sum is not zero)."""
    tok = p["tok"]
    group = split_group("vocab", vocab) if vocab else None
    if group is None:
        return torch.nn.functional.embedding(tokens, tok).to(COMPUTE_DTYPE)
    n = tok.shape[0]
    ids = tokens - torch.distributed.get_rank(group) * n
    inside = (ids >= 0) & (ids < n)
    rows = torch.nn.functional.embedding(torch.where(inside, ids, 0), tok)
    rows = rows * inside[..., None].to(rows.dtype)
    return collectives.reduce_sum(rows, group).to(COMPUTE_DTYPE)


@contextlib.contextmanager
def exact_f32() -> Iterator[None]:
    """Clears ``torch.backends.cuda.matmul.allow_tf32`` for the products in
    the block: TF32 would round f32 inputs to 10 bits."""
    flags = torch.backends.cuda.matmul
    allow, flags.allow_tf32 = flags.allow_tf32, False
    try:
        yield
    finally:
        flags.allow_tf32 = allow


class _ExactF32Product(torch.autograd.Function):
    """``x @ w`` of f32 operands with TF32 off in the forward product and in
    both backward products.  The flag is process-wide and the backward runs
    later, under whatever it is then, so each product clears it for itself."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(x, w)
        with exact_f32():
            return torch.matmul(x, w)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        x, w = ctx.saved_tensors
        gx = gw = None
        with exact_f32():
            if ctx.needs_input_grad[0]:
                gx = torch.matmul(g, w.t())
            if ctx.needs_input_grad[1]:
                gw = torch.matmul(x.reshape(-1, x.shape[-1]).t(), g.reshape(-1, g.shape[-1]))
        return gx, gw


def f32_product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x [..., K] @ w [K, N]`` in exact f32, forward and backward, as the
    JAX package's f32 ``jnp.einsum`` / ``jnp.dot``; the casts to f32
    differentiate back into each operand's dtype."""
    return _ExactF32Product.apply(x.float(), w.float())


def unembed(p: Params, h: torch.Tensor, vocab: int | None = None) -> torch.Tensor:
    """Logits in f32.  Tied embeddings run an exact f32 product against the
    table, as the JAX package's f32 einsum outside any kernel: serving
    reads the table's resident f32 copy ``tok_f32``
    (:func:`repro_torch.models.params.refresh_derived`), training
    differentiates into ``tok`` through its cast (the training tree has no
    copy, :func:`repro_torch.models.params.trainable`; a table that
    requires grad is read through its cast even beside one).  ``h`` may be
    a strided view (a batch's last rows): the kernel reads its rows
    contiguous.  With ``vocab`` and a table the rules split over the model
    axis, each rank computes its vocabulary's logits and they are gathered
    whole."""
    group = split_group("vocab", vocab) if vocab else None
    h = collectives.copy_to(h, group)
    if "unembed" in p:
        out = dispatch.op("matmul", h.contiguous(), p["unembed"], out_dtype=torch.float32)
    else:
        table = p.get("tok_f32")
        if table is None or (p["tok"].requires_grad and torch.is_grad_enabled()):
            table = p["tok"]
        out = f32_product(h, table.t())
    return collectives.gather(out, -1, group)


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------


def attention_specs(cfg: ArchConfig) -> Params:
    d, hd = cfg.d_model, cfg.head_dim
    return {
        "wq": linear_spec(d, cfg.num_heads * hd, ("embed", "heads")),
        "wk": linear_spec(d, cfg.num_kv_heads * hd, ("embed", "kv_heads")),
        "wv": linear_spec(d, cfg.num_kv_heads * hd, ("embed", "kv_heads")),
        "wo": linear_spec(cfg.num_heads * hd, d, ("heads", "embed")),
    }


class HeadPlan:
    """Which attention heads this rank computes under the active rules.

    ``q_local``: wq's columns are split and whole heads divide the model
    axis, so this rank computes heads ``[q_lo, q_lo + Hq)`` and ``wo``'s
    matching rows (one sum after).  ``kv_local``: the same for k/v.  Where
    q is local and k/v whole, the rank's q heads read k/v heads ``[kv_lo,
    kv_lo + Hkv)``, which must group as the kernel groups them (``Hq /
    Hkv`` q heads a k/v head); where they do not on some rank, q is whole
    too.  Whole leaves are gathered (:func:`whole`)."""

    def __init__(self, cfg: ArchConfig, group, rank: int, size: int):
        H, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        self.group = group
        self.q_local = split_group("heads", H * hd) is not None and H % size == 0
        self.kv_local = (self.q_local and split_group("kv_heads", Hkv * hd) is not None
                         and Hkv % size == 0)
        if self.q_local and not self.kv_local and not all(
                self._kv_range(cfg, r, size) for r in range(size)):
            self.q_local = False
        self.q_lo, self.Hq = (rank * (H // size), H // size) if self.q_local else (0, H)
        if self.kv_local:
            self.kv_lo, self.Hkv = rank * (Hkv // size), Hkv // size
        else:
            self.kv_lo, self.Hkv = self._kv_range(cfg, rank, size) or (0, Hkv)

    @staticmethod
    def _kv_range(cfg: ArchConfig, rank: int, size: int):
        """(first, count) of the k/v heads rank's q heads read, if they
        group as the kernel groups them; else None."""
        g = cfg.num_heads // cfg.num_kv_heads
        n = cfg.num_heads // size
        lo = rank * n
        first, last = lo // g, (lo + n - 1) // g + 1
        if n % (last - first):
            return None
        per = n // (last - first)
        if any((lo + i) // g - first != i // per for i in range(n)):
            return None
        return first, last - first


def head_plan(cfg: ArchConfig) -> HeadPlan | None:
    """The active rules' :class:`HeadPlan`, or None outside rules."""
    group = act.group("model")
    if group is None:
        return None
    return HeadPlan(cfg, group, torch.distributed.get_rank(group), act.size("model"))


def _qkv(p: Params, x: torch.Tensor, cfg: ArchConfig):
    """q [B, S, H, hd], k and v [B, S, Hkv, hd]; under rules, this rank's
    heads of each where its plan holds them local, else all of them."""
    B, S, d = x.shape
    H, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    plan = head_plan(cfg)
    if plan is None:
        q = dispatch.op("matmul", x, p["wq"]).reshape(B, S, H, hd)
        k = dispatch.op("matmul", x, p["wk"]).reshape(B, S, Hkv, hd)
        v = dispatch.op("matmul", x, p["wv"]).reshape(B, S, Hkv, hd)
        return q, k, v
    xm = collectives.copy_to(x, plan.group) if plan.q_local else x
    wq = p["wq"] if plan.q_local else whole(p["wq"], ("embed", "heads"), (d, H * hd))
    q = dispatch.op("matmul", xm if plan.q_local else x, wq).reshape(B, S, -1, hd)
    kv_in = xm if plan.kv_local else x
    kv = []
    for key in ("wk", "wv"):
        w = p[key] if plan.kv_local else whole(p[key], ("embed", "kv_heads"), (d, Hkv * hd))
        kv.append(dispatch.op("matmul", kv_in, w).reshape(B, S, -1, hd))
    return q, kv[0], kv[1]


def _kv_for_heads(t: torch.Tensor, plan: HeadPlan | None) -> torch.Tensor:
    """k or v [B, Hkv, T, hd] as this rank's q heads read it: the plan's
    k/v heads of a whole tensor (entering a computation that differs by
    rank: its gradient sums over them), else ``t``."""
    if plan is None or plan.kv_local or not plan.q_local:
        return t
    t = collectives.copy_to(t, plan.group)
    return t[:, plan.kv_lo:plan.kv_lo + plan.Hkv].contiguous()


def _attn_out(p: Params, out: torch.Tensor, cfg: ArchConfig, plan: HeadPlan | None,
              local: bool) -> torch.Tensor:
    """The output projection of the attention's rows [..., heads * hd]:
    this rank's heads' rows of ``wo`` and a sum over the model axis where
    ``local``, else all of ``wo``."""
    if plan is None:
        return dispatch.op("matmul", out, p["wo"])
    if local:
        return collectives.reduce_sum(dispatch.op("matmul", out, p["wo"]), plan.group)
    H, hd = cfg.num_heads, cfg.head_dim
    return dispatch.op("matmul", out, whole(p["wo"], ("heads", "embed"), (H * hd, cfg.d_model)))


def attention_full(
    p: Params,
    x: torch.Tensor,                   # [B, S, d]
    cfg: ArchConfig,
    *,
    positions: torch.Tensor,           # [S]
    window: int | None = None,
    causal: bool = True,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full-sequence attention (prefill; causal unless ``causal=False``, as
    whisper's encoder runs it), over the last ``window`` keys of each row
    where given.  Returns (y, k, v), the caches post-rope as contiguous
    [B, Hkv, S, hd]."""
    plan = head_plan(cfg)
    q, k, v = _qkv(p, x, cfg)
    cos, sin = rope_table(positions, cfg.head_dim, cfg.rope_theta)
    q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    q, k, v = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    out = dispatch.op("flash_attention", q, _kv_for_heads(k, plan), _kv_for_heads(v, plan),
                      causal=causal, window=window)
    B, S = x.shape[:2]
    y = _attn_out(p, out.transpose(1, 2).reshape(B, S, -1), cfg, plan,
                  plan is not None and plan.q_local)
    return y, k, v


def _chunk_qkv(p: Params, x: torch.Tensor, start: int, cfg: ArchConfig):
    """q, k [B, Sc, H, hd] roped at the chunk's absolute positions, and v."""
    q, k, v = _qkv(p, x, cfg)
    positions = start + torch.arange(x.shape[1], device=x.device)
    cos, sin = rope_table(positions, cfg.head_dim, cfg.rope_theta)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def _chunk_out(p: Params, q: torch.Tensor, keys: torch.Tensor,
               values: torch.Tensor) -> torch.Tensor:
    """The chunk's queries q [B, Sc, H, hd] against contiguous keys/values
    [B, Hkv, T, hd] (rows [0, T), T >= Sc), then the output projection."""
    B, Sc = q.shape[:2]
    out = dispatch.op("flash_attention", q.transpose(1, 2).contiguous(), keys, values,
                      causal=True)
    return dispatch.op("matmul", out.transpose(1, 2).reshape(B, Sc, -1), p["wo"])


def attention_prefill_chunk(
    p: Params,
    x: torch.Tensor,                   # [B, Sc, d]: prompt rows [start, start+Sc)
    cache_k: torch.Tensor,             # [B, Hkv, Tc, hd] staging cache, written in place
    cache_v: torch.Tensor,
    start: int,                        # the chunk's absolute first position
    cfg: ArchConfig,
) -> torch.Tensor:
    """One chunk of a split prefill against the partially filled staging
    cache.  Writes the chunk's k/v into rows ``[start, start+Sc)`` in place
    (JAX returned new caches) and returns y [B, Sc, d].

    Row for row the same function as :func:`attention_full` over the whole
    prompt, bit for bit on the card too, with no new kernel: rope at
    absolute positions is row-local; the norms are row-invariant (a row's
    reduction is one block's, whatever the launch's rows); the matmul sums
    a row's K in an order fixed by (N, K) alone (``kernels/matmul.py``
    ``groups``), whatever M, tile, split or kernel a chunk's launch takes;
    and ``flash_attention`` aligns a short query block to the *end* of its
    keys (``kv_offset = T - S``), so the chunk's queries against rows
    ``[0, start+Sc)`` see exactly the causal mask the whole prefill gave
    those rows, and folds a row's keys in groups fixed by the key index
    alone (``GROUP_KEYS``), whatever S, the q tile's start or the split.
    The cache slice is copied contiguous for the kernel."""
    q, k, v = _chunk_qkv(p, x, start, cfg)
    end = start + x.shape[1]
    cache_k[:, :, start:end] = k.transpose(1, 2).to(cache_k.dtype)
    cache_v[:, :, start:end] = v.transpose(1, 2).to(cache_v.dtype)
    return _chunk_out(p, q, cache_k[:, :, :end].contiguous(), cache_v[:, :, :end].contiguous())


def attention_prefill_chunk_paged(
    p: Params,
    x: torch.Tensor,                   # [1, Sc, d]: prompt rows [start, start+Sc)
    k_pages: torch.Tensor,             # [P, Hkv, ps, hd] global pool, written in place
    v_pages: torch.Tensor,
    page: torch.Tensor,                # [start+Sc] long: pool page of rows [0, start+Sc)
    offset: torch.Tensor,              # [start+Sc] long: their row within the page
    start: int,
    cfg: ArchConfig,
) -> torch.Tensor:
    """:func:`attention_prefill_chunk` with the pool as the cache: the
    chunk's k/v go straight into the pages its rows map to, and the rows
    ``[0, start+Sc)`` are gathered back, contiguous, for the kernel.  Over
    the same rows the same function as the staging version, with no
    staging cache held; rows the table leaves at the scratch page (pad
    rows past the prompt's pages) land there.  The JAX engine prefills
    into staging and scatters; this path needs no staging copy."""
    q, k, v = _chunk_qkv(p, x, start, cfg)
    paged_write_kv(k_pages, k[0], page[start:], offset[start:])
    paged_write_kv(v_pages, v[0], page[start:], offset[start:])
    keys = k_pages[page, :, offset].transpose(0, 1)[None].contiguous()   # [1, Hkv, T, hd]
    values = v_pages[page, :, offset].transpose(0, 1)[None].contiguous()
    return _chunk_out(p, q, keys, values)


def decode_positions(pos: torch.Tensor) -> torch.Tensor:
    """Rope positions for one decode step: pos scalar -> [1], [B] -> [B, 1]."""
    return pos[None] if pos.dim() == 0 else pos[:, None]


def write_kv(cache: torch.Tensor, new: torch.Tensor, slot: torch.Tensor) -> None:
    """Write one token's KV [B, H, hd] into cache [B, H, Tc, hd] at ``slot``
    (scalar, or [B] per-sequence positions) — in place, where JAX rebuilt the
    cache.  A scalar slot is an index on the device (indexing with a 0-d
    tensor would read it back to the host, a sync a layer)."""
    slot = slot.long()
    if slot.dim() == 0:
        cache.index_copy_(2, slot.reshape(1), new[:, :, None].to(cache.dtype))
    else:
        B = cache.shape[0]
        cache[torch.arange(B, device=cache.device), :, slot] = new.to(cache.dtype)


def attention_decode(
    p: Params,
    x: torch.Tensor,                   # [B, 1, d]
    cache_k: torch.Tensor,             # [B, Hkv, Tc, hd], written in place
    cache_v: torch.Tensor,
    pos: torch.Tensor,                 # scalar or [B]: tokens already cached
    cfg: ArchConfig,
) -> torch.Tensor:
    """Single-token decode against the dense KV cache.  Writes this token's
    k/v into the caches in place and returns y [B, 1, d].

    Under rules the caches hold this rank's k/v heads where its plan does
    (:class:`HeadPlan`), else all of them; sequence-parallel decode
    (:func:`sp_decode_applies`) takes this rank's rows of a time-split
    cache instead."""
    B = x.shape[0]
    hd = cfg.head_dim
    Tc = cache_k.shape[2]
    plan = head_plan(cfg)
    q, k, v = _qkv(p, x, cfg)
    cos, sin = rope_table(decode_positions(pos), hd, cfg.rope_theta)
    q = apply_rope(q, cos, sin)[:, 0]                     # [B, H, hd]
    k = apply_rope(k, cos, sin)[:, 0]                     # [B, Hkv, hd]
    v = v[:, 0]
    if sp_decode_applies(cfg, pos):
        if plan.q_local:
            q = collectives.gather(q, 1, plan.group)
        out = _sp_decode_attention(q, k, v, cache_k, cache_v, pos, cfg, plan.group)
        return _attn_out(p, out.reshape(B, -1), cfg, plan, False)[:, None, :]
    slot = pos % Tc
    write_kv(cache_k, k, slot)
    write_kv(cache_v, v, slot)
    length = torch.clamp(pos + 1, max=Tc)
    out = dispatch.op("decode_attention", q, _kv_for_heads(cache_k, plan),
                      _kv_for_heads(cache_v, plan), length)
    y = _attn_out(p, out.reshape(B, -1), cfg, plan, plan is not None and plan.q_local)
    return y[:, None, :]


def sp_decode_applies(cfg: ArchConfig, pos: torch.Tensor) -> bool:
    """JAX's condition for sequence-parallel decode: serving rules, a model
    axis of more than one rank that the k/v heads do not divide, a cache
    split along its time axis (the decode step's cache layout,
    :func:`repro_torch.dist.act.cache_layout`), no window, one position
    for the batch."""
    rules = act.current()
    if rules is None or not rules.serving or act.group("model") is None:
        return False
    layout = act.cache_layout()
    return (cfg.num_kv_heads % act.size("model") != 0 and cfg.attn_window is None
            and pos.dim() == 0 and layout is not None
            and layout.get("k", (None,) * 5)[3] == "model")


def _sp_decode_attention(q, k_new, v_new, ck, cv, pos, cfg: ArchConfig, group):
    """Sequence-parallel decode attention (JAX's ``_sp_decode_body``): q
    [B, Hq, hd] and the new k/v [B, Hkv, hd] whole on every rank, the
    caches [B, Hkv, T/M, hd] this rank's rows of the time axis.  The new
    row lands on its one owner (a masked write on every rank), each rank
    attends over its rows, and the softmax's max and sum and the weighted
    values combine over the model axis (a max and two sums of [B, Hkv, g]
    and [B, Hkv, g, hd] values, where gathering the cache would move all
    of it)."""
    B, Hq, hd = q.shape
    Hkv, T_loc = ck.shape[1], ck.shape[2]
    g = Hq // Hkv
    my = torch.distributed.get_rank(group)
    owner = pos // T_loc
    slot = (pos % T_loc).long().reshape(1)
    for cache, new in ((ck, k_new), (cv, v_new)):
        cur = cache.index_select(2, slot)
        cache.index_copy_(2, slot, torch.where(owner == my, new[:, :, None].to(cache.dtype), cur))
    scale = 1.0 / math.sqrt(cfg.head_dim)
    qg = q.reshape(B, Hkv, g, hd)
    logits = torch.einsum("bkgd,bktd->bkgt", qg.float(), ck.float()) * scale
    rows = my * T_loc + torch.arange(T_loc, device=ck.device)
    logits = torch.where(rows[None, None, None, :] <= pos, logits, -1e30)
    m = collectives.reduce_max(torch.amax(logits, dim=-1), group)          # [B, Hkv, g]
    probs = torch.exp(logits - m[..., None])
    denom = collectives.reduce_sum(torch.sum(probs, dim=-1), group)
    o_part = torch.einsum("bkgt,bktd->bkgd", probs.to(cv.dtype).float(), cv.float())
    o = collectives.reduce_sum(o_part, group) / denom[..., None]
    return o.reshape(B, Hq, hd).to(q.dtype)


def paged_write_kv(pool: torch.Tensor, new: torch.Tensor, page: torch.Tensor,
                   offset: torch.Tensor) -> None:
    """Write rows of KV [N, H, hd] into the pool [P, H, ps, hd] at each
    row's long ``(page[n], offset[n])`` — in place, where JAX rebuilt the
    pool.  The advanced indices split by a slice give an [N, H, hd] target.
    Live slots own disjoint pages, so their writes never collide; masked
    slots are steered to the scratch page by their cleared table rows,
    where colliding writes are harmless."""
    pool[page, :, offset] = new.to(pool.dtype)


def page_address(block_table: torch.Tensor, pos: torch.Tensor,
                 page_size: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Where each sequence's row ``pos[b]`` lives in the pool: long
    ``(page, offset)`` [B] through the block table [B, NP]."""
    page = torch.gather(block_table, 1, (pos // page_size)[:, None].long())[:, 0]
    return page.long(), (pos % page_size).long()


def attention_decode_paged(
    p: Params,
    x: torch.Tensor,                   # [B, 1, d]
    k_pages: torch.Tensor,             # [P, Hkv, ps, hd] global pool, written in place
    v_pages: torch.Tensor,
    block_table: torch.Tensor,         # [B, NP] int32: page index -> pool page
    pos: torch.Tensor,                 # [B]: tokens already cached
    page: torch.Tensor,                # [B] long: pool page of row pos (page_address)
    offset: torch.Tensor,              # [B] long: its row within the page
    lengths: torch.Tensor,             # [B] int32: pos + 1, the rows attended
    cfg: ArchConfig,
) -> torch.Tensor:
    """Single-token decode against a paged KV cache.  The q/k/v/rope math
    of :func:`attention_decode`; the new token's k/v go into the pool at
    ``(page, offset)``, and attention runs through the
    ``paged_decode_attention`` op over ``lengths`` rows.  Address and
    lengths are the same for every layer of a step, so the caller derives
    them once (JAX derived them in each layer).  Returns y [B, 1, d]."""
    B = x.shape[0]
    q, k, v = _qkv(p, x, cfg)
    cos, sin = rope_table(decode_positions(pos), cfg.head_dim, cfg.rope_theta)
    q = apply_rope(q, cos, sin)[:, 0]                     # [B, H, hd]
    k = apply_rope(k, cos, sin)[:, 0]                     # [B, Hkv, hd]
    paged_write_kv(k_pages, k, page, offset)
    paged_write_kv(v_pages, v[:, 0], page, offset)
    out = dispatch.op("paged_decode_attention", q, k_pages, v_pages, block_table, lengths)
    y = dispatch.op("matmul", out.reshape(B, -1), p["wo"])
    return y[:, None, :]


# ---------------------------------------------------------------------------
# cross-attention (the encoder-decoder's)
# ---------------------------------------------------------------------------


def cross_attention_specs(cfg: ArchConfig) -> Params:
    return attention_specs(cfg)


def cross_attention(
    p: Params,
    x: torch.Tensor,                   # [B, S, d] decoder side
    mem_k: torch.Tensor,               # [B, Hkv, T_enc, hd] precomputed
    mem_v: torch.Tensor,
    cfg: ArchConfig,
) -> torch.Tensor:
    """The decoder's rows attending over the encoder memory, unroped and
    unmasked: at S = 1 one-token ``decode_attention`` over all T_enc rows,
    else non-causal ``flash_attention``.  Returns y [B, S, d]."""
    B, S, _ = x.shape
    p = whole_tree(p, attention_specs(cfg))
    q = dispatch.op("matmul", x, p["wq"]).reshape(B, S, cfg.num_heads, cfg.head_dim)
    if S == 1:
        out = dispatch.op("decode_attention", q[:, 0], mem_k, mem_v, mem_k.shape[2])[:, None]
    else:
        out = dispatch.op("flash_attention", q.transpose(1, 2).contiguous(), mem_k, mem_v,
                          causal=False).transpose(1, 2)
    return dispatch.op("matmul", out.reshape(B, S, -1), p["wo"])


def encode_memory(p: Params, memory: torch.Tensor,
                  cfg: ArchConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """Cross-attention K/V of the encoder output [B, T, d], computed once:
    contiguous [B, Hkv, T, hd] each."""
    B, T, _ = memory.shape
    hd = cfg.head_dim
    p = whole_tree(p, attention_specs(cfg))
    k = dispatch.op("matmul", memory, p["wk"]).reshape(B, T, cfg.num_kv_heads, hd)
    v = dispatch.op("matmul", memory, p["wv"]).reshape(B, T, cfg.num_kv_heads, hd)
    return k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------


def mlp_specs(cfg: ArchConfig, d_ff: int | None = None) -> Params:
    """The SwiGLU MLP's weights, ``d_ff`` wide (the config's unless given:
    MoE's shared experts are ``d_ff_expert`` times their count)."""
    d, f = cfg.d_model, d_ff or cfg.d_ff
    return {
        "wg": linear_spec(d, f, ("embed", "mlp")),
        "wu": linear_spec(d, f, ("embed", "mlp")),
        "wd": linear_spec(f, d, ("mlp", "embed")),
    }


def apply_mlp(p: Params, x: torch.Tensor, d_ff: int | None = None) -> torch.Tensor:
    """SwiGLU.  Under rules that split the MLP's ``d_ff`` (its global
    width, which sharded callers pass) over the model axis: column-parallel
    ``wg``/``wu``, row-parallel ``wd``, one sum."""
    group = split_group("mlp", d_ff) if d_ff else None
    if group is None and d_ff is None and act.group("model") is not None:
        raise ValueError("apply_mlp under sharding rules needs the MLP's global d_ff")
    x = collectives.copy_to(x, group)
    g = dispatch.op("matmul", x, p["wg"], activation="silu")
    u = dispatch.op("matmul", x, p["wu"])
    return collectives.reduce_sum(dispatch.op("matmul", g * u, p["wd"]), group)
