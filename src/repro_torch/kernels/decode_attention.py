"""Decode attention written by hand for Hopper (``csrc/decode_attention.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/decode_attention.py``
``decode_attention`` (``_dec_kernel``): one query token per sequence,
q [B, Hq, D], against a dense cache [B, Hkv, T, D], masked past each
sequence's ``length`` (scalar or [B]), with an online softmax over KV tiles
and an l == 0 guard.

What bounds it on the H100: bytes — each cached key and value is read once
for a handful of flops.  The design gives one block to each (kv head,
sequence), carries the kv head's whole query group as the rows of one
tensor-core tile so the cache is read once for all of them, splits the
sequence's tiles over four warps whose softmax states merge at the end, and
skips every tile at or past the sequence's length, so a short sequence reads
only its own rows.  D = 64 or 128 (yi's and granite's heads), Hq / Hkv <= 16;
any other D is refused (MLA's 192 will need an instance of its own).
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import native

ROUTE = "cuda"
SOURCE = "src/repro_torch/csrc/decode_attention.cu"
REPLACES = "src/repro/kernels/decode_attention.py:69"

#: launches of the CUDA kernel
launches = 0

NEG_INF = -1e30
HEAD_DIMS = (64, 128)
_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
             + [ctypes.c_float, ctypes.c_void_p])


def lengths_vector(length, batch: int, device: torch.device) -> torch.Tensor:
    """``length`` (int, 0-d or [B] tensor) as an int32 [B] tensor on ``device``."""
    lengths = torch.as_tensor(length, device=device)
    if lengths.dim() == 0:
        lengths = lengths.expand(batch)
    if lengths.shape != (batch,):
        raise ValueError(f"length must be a scalar or [{batch}], got {tuple(lengths.shape)}")
    return lengths.to(torch.int32).contiguous()


def plain_decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                           length, *, scale: float | None = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch: f32 logits masked at -1e30
    past ``length``, f32 softmax and product, l == 0 guarded."""
    B, Hq, D = q.shape
    Hkv, T = k_cache.shape[1], k_cache.shape[2]
    group = Hq // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    lengths = lengths_vector(length, B, q.device)
    qg = q.float().reshape(B, Hkv, group, D)
    s = torch.einsum("bkgd,bktd->bkgt", qg, k_cache.float()) * scale
    valid = torch.arange(T, device=q.device)[None, :] < lengths[:, None]     # [B, T]
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    l = torch.where(l == 0.0, 1.0, l)
    out = torch.einsum("bkgt,bktd->bkgd", p, v_cache.float()) / l
    return out.reshape(B, Hq, D).to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor, length, *,
                     scale: float | None = None) -> torch.Tensor:
    """One-token attention over a dense cache: the plain version for CPU
    tensors, else the CUDA kernel (bf16, D = 64 or 128, Hq / Hkv <= 16)."""
    if native.on_cpu(q, k_cache, v_cache):
        return plain_decode_attention(q, k_cache, v_cache, length, scale=scale)
    global launches
    native.check("decode_attention", {"q": q, "k_cache": k_cache, "v_cache": v_cache},
                 torch.bfloat16)
    B, Hq, D = q.shape
    if (k_cache.shape != v_cache.shape or k_cache.dim() != 4 or k_cache.shape[0] != B
            or k_cache.shape[3] != D):
        raise ValueError(f"decode_attention: q {tuple(q.shape)} vs cache "
                         f"{tuple(k_cache.shape)}/{tuple(v_cache.shape)}")
    Hkv, T = k_cache.shape[1], k_cache.shape[2]
    if D not in HEAD_DIMS or Hq % Hkv or Hq // Hkv > 16:
        raise ValueError(f"decode_attention: needs D in {HEAD_DIMS} and Hq / Hkv a whole "
                         f"number <= 16; got D={D} Hq={Hq} Hkv={Hkv}")
    lengths = lengths_vector(length, B, q.device)
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    out = torch.empty_like(q)
    fn = native.function("decode_attention", "repro_decode_attention", _ARGTYPES)
    err = fn(native.ptr(q), native.ptr(k_cache), native.ptr(v_cache), native.ptr(lengths),
             native.ptr(out), B, Hq, Hkv, T, D, float(scale), native.stream(q.device))
    native.raise_on_error("decode_attention", err)
    launches += 1
    return out
