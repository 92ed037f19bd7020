"""Torch oracles for the kernels on the port's path.

These are the "reference" source in the registry: always correct, never
hand-optimized — the counterparts of ``repro/kernels/ref.py``, with the
same f32 arithmetic and -inf masks.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def matmul(x: torch.Tensor, w: torch.Tensor, *, out_dtype: torch.dtype | None = None,
           activation: str | None = None) -> torch.Tensor:
    """[M, K] @ [K, N] with f32 accumulation."""
    return epilogue(torch.matmul(x.float(), w.float()), activation).to(out_dtype or x.dtype)


def epilogue(acc: torch.Tensor, activation: str | None) -> torch.Tensor:
    """The matmul's f32 epilogue: none, silu or tanh-gelu."""
    if activation == "silu":
        return acc * torch.sigmoid(acc)
    if activation == "gelu":
        return F.gelu(acc, approximate="tanh")   # jax.nn.gelu's default
    if activation is not None:
        raise ValueError(f"unknown activation {activation!r}")
    return acc


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    """RMS norm over the last axis, f32 statistics."""
    xf = x.float()
    rms = torch.sqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return ((xf / rms) * weight.float()).to(x.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
                    window: int | None = None, scale: float | None = None) -> torch.Tensor:
    """Exact attention oracle with GQA head grouping: q [B,Hq,S,D] over
    k, v [B,Hkv,T,D], queries at the end of the kv axis."""
    B, Hq, S, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    if Hq % Hkv:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    group = Hq // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    kg = k.float().repeat_interleave(group, dim=1)
    vg = v.float().repeat_interleave(group, dim=1)
    logits = torch.einsum("bhsd,bhtd->bhst", q.float(), kg) * scale
    qpos = torch.arange(S, device=q.device)[:, None] + (T - S)
    kpos = torch.arange(T, device=q.device)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    logits = logits.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhst,bhtd->bhsd", probs, vg).to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor, length, *,
                     scale: float | None = None) -> torch.Tensor:
    """One-token attention over a (possibly padded) KV cache: q [B,Hq,D],
    cache [B,Hkv,T,D], ``length`` scalar or [B]."""
    B, Hq, D = q.shape
    Hkv, T = k_cache.shape[1], k_cache.shape[2]
    group = Hq // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    kg = k_cache.float().repeat_interleave(group, dim=1)
    vg = v_cache.float().repeat_interleave(group, dim=1)
    logits = torch.einsum("bhd,bhtd->bht", q.float(), kg) * scale
    lengths = torch.as_tensor(length, device=q.device)
    if lengths.dim() == 0:
        lengths = lengths.expand(B)
    valid = torch.arange(T, device=q.device)[None, :] < lengths[:, None]
    logits = logits.masked_fill(~valid[:, None, :], float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bht,bhtd->bhd", probs, vg).to(q.dtype)


def gather_kv_pages(pages: torch.Tensor, block_table: torch.Tensor) -> torch.Tensor:
    """Reassemble a per-sequence dense KV view from a paged pool.

    ``pages`` [P, Hkv, ps, D] is the global block pool; ``block_table``
    [B, NP] maps each sequence's page index to a pool page.  The result
    [B, Hkv, NP*ps, D] holds position ``t`` of sequence ``b`` at
    ``[b, :, t]`` — exactly the dense cache layout, so any dense decode
    attention runs unchanged (and bitwise-identically) on the gather.
    """
    B, NP = block_table.shape
    _, Hkv, ps, D = pages.shape
    out = pages[block_table.long()]                      # [B, NP, Hkv, ps, D]
    return out.transpose(1, 2).reshape(B, Hkv, NP * ps, D)


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                           block_table: torch.Tensor, length, *,
                           scale: float | None = None) -> torch.Tensor:
    """One-token attention over a paged KV cache: gather, then the dense
    oracle.  Positions ``>= length`` (page tails, unmapped entries pointing
    at the scratch page) are masked before the softmax."""
    kg = gather_kv_pages(k_pages, block_table)
    vg = gather_kv_pages(v_pages, block_table)
    return decode_attention(q, kg, vg, length, scale=scale)


def ssd(x: torch.Tensor, a_log: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
        dt: torch.Tensor, *, chunk: int | None = None,
        initial_state: torch.Tensor | None = None, return_state: bool = False):
    """Mamba-2 SSD oracle: the sequential state-space recurrence, in f32.

    h_t = exp(dt_t * a) * h_{t-1} + dt_t * x_t ⊗ b_t ;  y_t = h_t · c_t

    x [B,S,H,P], a_log [H] (the negative per-head decay a), b, c [B,S,G,N],
    dt [B,S,H]; heads share b/c by group (``G`` divides ``H``).  y has x's
    dtype; the final state [B,H,P,N] is f32.  ``chunk`` is the op's keyword
    (the Mamba-2 block passes it) and has no meaning for the recurrence;
    the JAX oracle refuses it, see ROADMAP §3.
    """
    del chunk
    B, S, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    if H % G:
        raise ValueError(f"H={H} is not a multiple of G={G}")
    rep = H // G
    xf = x.float()
    bf = b.float().repeat_interleave(rep, dim=2)                 # [B,S,H,N]
    cf = c.float().repeat_interleave(rep, dim=2)
    dtf = dt.float()
    decay = torch.exp(dtf * a_log.float()[None, None, :])        # [B,S,H]
    h = (torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device)
         if initial_state is None else initial_state.float())
    ys = []
    for t in range(S):
        h = (h * decay[:, t, :, None, None]
             + (dtf[:, t, :, None] * xf[:, t])[..., None] * bf[:, t, :, None, :])
        ys.append(torch.einsum("bhpn,bhn->bhp", h, cf[:, t]))
    y = torch.stack(ys, dim=1).to(x.dtype)
    return (y, h) if return_state else y


def conv2d(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """VALID conv, stride 1, NHWC x HWIO (paper roles 3/4).  Integer inputs
    give int32, wrapping past 2^31 as XLA's int32 convolution does (summed
    exactly in float64, then reduced mod 2^32); floats accumulate in f32."""
    xn, wn = x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1)      # NCHW, OIHW
    if x.dtype.is_floating_point:
        return F.conv2d(xn.float(), wn.float()).permute(0, 2, 3, 1).contiguous()
    exact = F.conv2d(xn.double(), wn.double()).round().to(torch.int64)
    wrapped = torch.remainder(exact + 2**31, 2**32) - 2**31
    return wrapped.to(torch.int32).permute(0, 2, 3, 1).contiguous()
