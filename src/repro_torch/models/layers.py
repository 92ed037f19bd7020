"""Shared model building blocks: the GQA half of ``repro/models/layers.py``.

Every compute hot spot goes through ``dispatch.op`` — matmuls, norms,
attention — so the model is transparently retargetable between the
reference, torch and cuda sources (the paper's property).  Functions are
plain functions on tensors; parameters are dicts from
:mod:`repro_torch.models.params`.  Layouts follow the JAX package's: rows
are ``[B, S, d]``, per-head tensors ``[B, S, H, hd]``, caches
``[B, Hkv, T, hd]``.
"""

from __future__ import annotations

import math
from typing import Any

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


def unembed(p: Params, h: torch.Tensor) -> torch.Tensor:
    """Logits in f32.  Tied embeddings run a plain f32 product against the
    table's f32 copy, as the JAX package's f32 einsum outside any kernel."""
    if "unembed" in p:
        return dispatch.op("matmul", h, p["unembed"], out_dtype=torch.float32)
    # the JAX einsum is exact f32: TF32 would round its inputs to 10 bits.
    # The flag is process-wide, so it is set for this product only.
    flags = torch.backends.cuda.matmul
    allow_tf32, flags.allow_tf32 = flags.allow_tf32, False
    try:
        return torch.matmul(h.float(), p["tok_f32"].t())
    finally:
        flags.allow_tf32 = allow_tf32


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
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full-sequence causal attention (prefill).  Returns (y, k, v), the
    caches post-rope as contiguous [B, Hkv, S, hd]."""
    q, k, v = _qkv(p, x, cfg)
    cos, sin = rope_table(positions, cfg.head_dim, cfg.rope_theta)
    q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    q, k, v = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    out = dispatch.op("flash_attention", q, k, v, causal=True)
    B, S = x.shape[:2]
    y = dispatch.op("matmul", out.transpose(1, 2).reshape(B, S, -1), p["wo"])
    return y, k, v


def decode_positions(pos: torch.Tensor) -> torch.Tensor:
    """Rope positions for one decode step: pos scalar -> [1], [B] -> [B, 1]."""
    return pos[None] if pos.dim() == 0 else pos[:, None]


def write_kv(cache: torch.Tensor, new: torch.Tensor, slot: torch.Tensor) -> None:
    """Write one token's KV [B, H, hd] into cache [B, H, Tc, hd] at ``slot``
    (scalar, or [B] per-sequence positions) — in place, where JAX rebuilt the
    cache."""
    slot = slot.long()
    if slot.dim() == 0:
        cache[:, :, slot] = new.to(cache.dtype)
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


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------


def mlp_specs(cfg: ArchConfig) -> Params:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "wg": linear_spec(d, f),
        "wu": linear_spec(d, f),
        "wd": linear_spec(f, d),
    }


def apply_mlp(p: Params, x: torch.Tensor) -> torch.Tensor:
    g = dispatch.op("matmul", x, p["wg"], activation="silu")
    u = dispatch.op("matmul", x, p["wu"])
    return dispatch.op("matmul", g * u, p["wd"])
