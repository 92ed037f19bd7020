"""Shared model building blocks: ``repro/models/layers.py`` but its
sequence-parallel decode (which waits for ``dist``).

Every compute hot spot goes through ``dispatch.op`` — matmuls, norms,
attention — so the model is transparently retargetable between the
reference, torch and cuda sources (the paper's property).  Functions are
plain functions on tensors; parameters are dicts from
:mod:`repro_torch.models.params`.  Layouts follow the JAX package's: rows
are ``[B, S, d]``, per-head tensors ``[B, S, H, hd]``, caches
``[B, Hkv, T, hd]``.
"""

from __future__ import annotations

import contextlib
import math
from typing import Any, Iterator

import torch

from repro_torch import kernels  # noqa: F401  (registry population)
from repro_torch.configs.base import ArchConfig
from repro_torch.core import dispatch
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
# elementary modules
# ---------------------------------------------------------------------------


def linear_spec(d_in: int, d_out: int) -> ParamSpec:
    return ParamSpec(shape=(d_in, d_out), scale=1.0 / math.sqrt(d_in))


def norm_spec(d: int) -> ParamSpec:
    return ParamSpec(shape=(d,), init="ones")


def apply_norm(p: torch.Tensor, x: torch.Tensor, eps: float) -> torch.Tensor:
    return dispatch.op("rmsnorm", x, p, eps=eps)


def embed_specs(cfg: ArchConfig) -> Params:
    p: dict[str, ParamSpec] = {"tok": ParamSpec(shape=(cfg.vocab_size, cfg.d_model), scale=0.02)}
    if not cfg.tie_embeddings:
        p["unembed"] = linear_spec(cfg.d_model, cfg.vocab_size)
    return p


def embed_tokens(p: Params, tokens: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.embedding(tokens, p["tok"]).to(COMPUTE_DTYPE)


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


def unembed(p: Params, h: torch.Tensor) -> torch.Tensor:
    """Logits in f32.  Tied embeddings run an exact f32 product against the
    table, as the JAX package's f32 einsum outside any kernel: serving
    reads the table's resident f32 copy ``tok_f32``
    (:func:`repro_torch.models.params.refresh_derived`), training
    differentiates into ``tok`` through its cast (the training tree has no
    copy, :func:`repro_torch.models.params.trainable`; a table that
    requires grad is read through its cast even beside one).  ``h`` may be
    a strided view (a batch's last rows): the kernel reads its rows
    contiguous."""
    if "unembed" in p:
        return dispatch.op("matmul", h.contiguous(), p["unembed"], out_dtype=torch.float32)
    table = p.get("tok_f32")
    if table is None or (p["tok"].requires_grad and torch.is_grad_enabled()):
        table = p["tok"]
    return f32_product(h, table.t())


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------


def attention_specs(cfg: ArchConfig) -> Params:
    d, hd = cfg.d_model, cfg.head_dim
    return {
        "wq": linear_spec(d, cfg.num_heads * hd),
        "wk": linear_spec(d, cfg.num_kv_heads * hd),
        "wv": linear_spec(d, cfg.num_kv_heads * hd),
        "wo": linear_spec(cfg.num_heads * hd, d),
    }


def _qkv(p: Params, x: torch.Tensor, cfg: ArchConfig):
    B, S, _ = x.shape
    hd = cfg.head_dim
    q = dispatch.op("matmul", x, p["wq"]).reshape(B, S, cfg.num_heads, hd)
    k = dispatch.op("matmul", x, p["wk"]).reshape(B, S, cfg.num_kv_heads, hd)
    v = dispatch.op("matmul", x, p["wv"]).reshape(B, S, cfg.num_kv_heads, hd)
    return q, k, v


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
    q, k, v = _qkv(p, x, cfg)
    cos, sin = rope_table(positions, cfg.head_dim, cfg.rope_theta)
    q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    q, k, v = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    out = dispatch.op("flash_attention", q, k, v, causal=causal, window=window)
    B, S = x.shape[:2]
    y = dispatch.op("matmul", out.transpose(1, 2).reshape(B, S, -1), p["wo"])
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
    k/v into the caches in place and returns y [B, 1, d]."""
    B = x.shape[0]
    hd = cfg.head_dim
    Tc = cache_k.shape[2]
    q, k, v = _qkv(p, x, cfg)
    cos, sin = rope_table(decode_positions(pos), hd, cfg.rope_theta)
    q = apply_rope(q, cos, sin)[:, 0]                     # [B, H, hd]
    k = apply_rope(k, cos, sin)[:, 0]                     # [B, Hkv, hd]
    v = v[:, 0]
    slot = pos % Tc
    write_kv(cache_k, k, slot)
    write_kv(cache_v, v, slot)
    length = torch.clamp(pos + 1, max=Tc)
    out = dispatch.op("decode_attention", q, cache_k, cache_v, length)
    y = dispatch.op("matmul", out.reshape(B, -1), p["wo"])
    return y[:, None, :]


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
        "wg": linear_spec(d, f),
        "wu": linear_spec(d, f),
        "wd": linear_spec(f, d),
    }


def apply_mlp(p: Params, x: torch.Tensor) -> torch.Tensor:
    g = dispatch.op("matmul", x, p["wg"], activation="silu")
    u = dispatch.op("matmul", x, p["wu"])
    return dispatch.op("matmul", g * u, p["wd"])
