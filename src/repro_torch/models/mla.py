"""Multi-head Latent Attention (DeepSeek-V3): ``repro/models/mla.py``.

KV is compressed to a per-token latent ``c_kv`` of ``kv_lora_rank`` values
plus one shared rotary key of ``qk_rope_dim``.  Prefill expands the latents
to full keys and values and runs flash attention with q and k of
``qk_nope_dim + qk_rope_dim`` (192 at full width) over values of
``v_head_dim`` (128); decode uses the absorbed-weight formulation (W_UK
folded into the query, W_UV applied to the attended latent), never
materialising per-head keys.

``mla_decode_attention`` is a plain function in the JAX package too (its
``reference`` and ``xla`` sources, no Pallas kernel), so it is registered
here as the ``torch`` and ``reference`` sources: under the ``cuda`` policy
it is the one op of an MLA model that runs outside the hand-written
kernels, and ``cuda-strict`` cannot run an MLA model (as JAX's
``pallas-strict`` cannot).

Decode feeds its f32 context into ``wo``, which is bf16: JAX's ``jnp.dot``
promotes it to an f32 product.  The port keeps a resident f32 copy of
``wo`` (``wo_f32``, made by :func:`repro_torch.models.params.init_params`
and ``params_from_jax``, as the tied unembed keeps one), so the product is
f32 by f32: the f32 kernel on the card, an f32 product on the CPU.

Under sharding rules the head-split leaves are gathered whole and the
layer runs as on one device.
"""

from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import dispatch
from repro_torch.core.registry import GLOBAL_REGISTRY, KernelImpl
from repro_torch.models import layers
from repro_torch.models.params import ParamSpec

Params = Any


def mla_specs(cfg: ArchConfig) -> Params:
    m = cfg.mla
    assert m is not None
    d, H = cfg.d_model, cfg.num_heads
    qk = m.qk_nope_dim + m.qk_rope_dim
    s = 1.0 / math.sqrt(d)
    return {
        "wq_a": ParamSpec((d, m.q_lora_rank), ("embed", "q_lora"), scale=s),
        "q_norm": layers.norm_spec(m.q_lora_rank),
        "wq_b": ParamSpec((m.q_lora_rank, H * qk), ("q_lora", "heads"),
                          scale=1.0 / math.sqrt(m.q_lora_rank)),
        "wkv_a": ParamSpec((d, m.kv_lora_rank + m.qk_rope_dim), ("embed", None), scale=s),
        "kv_norm": layers.norm_spec(m.kv_lora_rank),
        "wkv_b": ParamSpec((m.kv_lora_rank, H * (m.qk_nope_dim + m.v_head_dim)),
                           ("q_lora", "heads"), scale=1.0 / math.sqrt(m.kv_lora_rank)),
        "wo": ParamSpec((H * m.v_head_dim, d), ("heads", "embed"),
                        scale=1.0 / math.sqrt(H * m.v_head_dim)),
    }


def _scale(cfg: ArchConfig) -> float:
    m = cfg.mla
    return 1.0 / math.sqrt(m.qk_nope_dim + m.qk_rope_dim)


def _queries(p: Params, x: torch.Tensor, cfg: ArchConfig):
    """x [B,S,d] -> q_nope [B,S,H,nope], q_rope [B,S,H,rope] (pre-rotation)."""
    m, H = cfg.mla, cfg.num_heads
    B, S, _ = x.shape
    cq = layers.apply_norm(p["q_norm"], dispatch.op("matmul", x, p["wq_a"]), cfg.norm_eps)
    q = dispatch.op("matmul", cq, p["wq_b"]).reshape(B, S, H, m.qk_nope_dim + m.qk_rope_dim)
    return q[..., :m.qk_nope_dim], q[..., m.qk_nope_dim:]


def _latents(p: Params, x: torch.Tensor, cfg: ArchConfig):
    """x -> (c_kv [B,S,r] normalised, k_rope [B,S,rope] pre-rotation)."""
    m = cfg.mla
    ckv = dispatch.op("matmul", x, p["wkv_a"])
    c_kv, k_rope = ckv[..., :m.kv_lora_rank], ckv[..., m.kv_lora_rank:]
    return layers.apply_norm(p["kv_norm"], c_kv.contiguous(), cfg.norm_eps), k_rope


def mla_full(p: Params, x: torch.Tensor, cfg: ArchConfig, *,
             positions: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Prefill.  Returns (y [B,S,d], c_kv [B,S,r], k_rope [B,S,rope]
    rotated) for the cache."""
    m, H = cfg.mla, cfg.num_heads
    B, S, _ = x.shape
    p = layers.whole_tree(p, mla_specs(cfg))        # under rules: the heads whole
    q_nope, q_rope = _queries(p, x, cfg)
    c_kv, k_rope = _latents(p, x, cfg)

    cos, sin = layers.rope_table(positions, m.qk_rope_dim, cfg.rope_theta)
    q_rope = layers.apply_rope(q_rope, cos, sin)
    k_rope = layers.apply_rope(k_rope[:, :, None, :], cos, sin)     # [B,S,1,rope]

    kv = dispatch.op("matmul", c_kv, p["wkv_b"]).reshape(B, S, H, m.qk_nope_dim + m.v_head_dim)
    k_nope, v = kv[..., :m.qk_nope_dim], kv[..., m.qk_nope_dim:]
    k = torch.cat([k_nope, k_rope.expand(B, S, H, m.qk_rope_dim)], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    out = dispatch.op("flash_attention", q.transpose(1, 2).contiguous(),
                      k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous(),
                      causal=True, scale=_scale(cfg)).transpose(1, 2)
    y = dispatch.op("matmul", out.reshape(B, S, -1), p["wo"])
    return y, c_kv, k_rope[:, :, 0, :]


def mla_decode_attention(q_nope: torch.Tensor,     # [B, H, nope]
                         q_rope: torch.Tensor,     # [B, H, rope] (rotated)
                         c_kv: torch.Tensor,       # [B, T, r] latent cache
                         k_rope: torch.Tensor,     # [B, T, rope] rotated shared keys
                         w_uk: torch.Tensor,       # [r, H, nope]
                         w_uv: torch.Tensor,       # [r, H, v]
                         length: torch.Tensor,     # scalar or [B]
                         *, scale: float) -> torch.Tensor:
    """Absorbed MLA decode: [B, H, v] f32.  Each product takes its operands
    in their stored (bf16) values and accumulates in f32, as JAX's einsums
    with ``preferred_element_type=float32``; the query and the context are
    rounded to the cache's dtype where JAX rounds them."""
    q_abs = torch.einsum("bhn,rhn->bhr", q_nope.float(), w_uk.float())
    logits = torch.einsum("bhr,btr->bht", q_abs.to(c_kv.dtype).float(), c_kv.float())
    logits = logits + torch.einsum("bhp,btp->bht", q_rope.to(k_rope.dtype).float(),
                                   k_rope.float())
    logits = logits * scale
    T = c_kv.shape[1]
    length = torch.as_tensor(length, device=c_kv.device)
    if length.dim() == 1:                           # per-sequence lengths [B]
        length = length[:, None, None]
    valid = torch.arange(T, device=c_kv.device)[None, None, :] < length
    logits = torch.where(valid, logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    ctx = torch.einsum("bht,btr->bhr", probs.to(c_kv.dtype).float(), c_kv.float())
    return torch.einsum("bhr,rhv->bhv", ctx.to(w_uv.dtype).float(), w_uv.float())


def write_latent(cache: torch.Tensor, new: torch.Tensor, pos: torch.Tensor) -> None:
    """Write one token's latent rows [B, r] into cache [B, T, r] at ``pos``
    (scalar, or [B] per-sequence positions) in place, where JAX rebuilt the
    cache; at ``pos % T``, as the dense cache's write, so a slot frozen past
    the end writes its own rows.  A scalar slot is an index on the device
    (indexing with a 0-d tensor would read it back to the host, a sync a
    layer), as :func:`repro_torch.models.layers.write_kv`'s."""
    slot = (pos % cache.shape[1]).long()
    if slot.dim() == 0:
        cache.index_copy_(1, slot.reshape(1), new[:, None].to(cache.dtype))
    else:
        cache[torch.arange(cache.shape[0], device=cache.device), slot] = new.to(cache.dtype)


def mla_decode(p: Params, x: torch.Tensor, cache_ckv: torch.Tensor,
               cache_krope: torch.Tensor, pos: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """One token x [B, 1, d] against the latent caches [B, T, r] and [B, T,
    rope], which take this token's rows in place.  Returns y [B, 1, d]."""
    m, H = cfg.mla, cfg.num_heads
    B = x.shape[0]
    p = layers.whole_tree(p, mla_specs(cfg))
    q_nope, q_rope = _queries(p, x, cfg)
    c_kv, k_rope = _latents(p, x, cfg)

    cos, sin = layers.rope_table(layers.decode_positions(pos), m.qk_rope_dim, cfg.rope_theta)
    q_rope = layers.apply_rope(q_rope, cos, sin)[:, 0]                     # [B,H,rope]
    k_rope = layers.apply_rope(k_rope[:, :, None, :], cos, sin)[:, 0, 0]   # [B,rope]
    write_latent(cache_ckv, c_kv[:, 0], pos)
    write_latent(cache_krope, k_rope, pos)

    wkv_b = p["wkv_b"].reshape(m.kv_lora_rank, H, m.qk_nope_dim + m.v_head_dim)
    w_uk, w_uv = wkv_b[..., :m.qk_nope_dim], wkv_b[..., m.qk_nope_dim:]
    out = dispatch.op("mla_decode_attention", q_nope[:, 0], q_rope, cache_ckv, cache_krope,
                      w_uk, w_uv, pos + 1, scale=_scale(cfg))
    y = dispatch.op("matmul", out.reshape(B, -1), p["wo_f32"])
    return y[:, None, :].to(x.dtype)


def mla_decode_attention_cost(out, q_nope, q_rope, c_kv, k_rope, w_uk, w_uv, length, **_):
    """The absorbed decode's products (W_UK into the query, the latent and
    rotary logits, the context, W_UV out) over every cached row, and each
    operand read once and the output written once: no kernel runs it on
    the card (the ``torch`` source does, under ``cuda``), so this is the
    least work the function takes."""
    B, H, nope = q_nope.shape
    T, r = c_kv.shape[1], c_kv.shape[2]
    rope, v = k_rope.shape[2], w_uv.shape[2]
    flops = 2 * B * H * (nope * r + T * (r + rope) + T * r + r * v)
    operands = (q_nope, q_rope, c_kv, k_rope, w_uk, w_uv, out)
    return flops, sum(t.numel() * t.element_size() for t in operands)


# the absorbed decode as a dispatchable op: the torch eager source and the
# oracle are the same function (JAX registers it as reference and xla)
for _src in ("reference", "torch"):
    GLOBAL_REGISTRY.register(
        KernelImpl(op="mla_decode_attention", device_kind="any", source=_src,
                   fn=mla_decode_attention),
        allow_override=True,
    )
dispatch.register_cost("mla_decode_attention", mla_decode_attention_cost)
