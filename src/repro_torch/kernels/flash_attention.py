"""Flash attention written by hand for Hopper (``csrc/flash_attention.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py``
``flash_attention`` (``_fa_kernel``): online-softmax attention of
q [B, Hq, S, D] over k, v [B, Hkv, T, D], GQA head h reading kv head
h // (Hq // Hkv), causal and sliding-window masks at -1e30 with the queries
aligned to the end of the keys (``kv_offset = T - S``), a non-causal mode and
an l == 0 guard.

What bounds it on the H100: operations at prefill lengths — a causal
512 x 512 head does about 90 flops per byte it must move — so the design
keeps both products on the tensor cores (``mma.sync`` bf16, f32 accumulate)
and the softmax state in registers: one block of four warps owns 64 query
rows, loops over 64-key tiles staged in shared memory, and skips tiles the
masks hide.  P is rounded to bf16 for the P V product; that rounding is why
the kernel is held to its plain version within a bf16 tolerance.  D = 64.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import native

ROUTE = "cuda"
SOURCE = "src/repro_torch/csrc/flash_attention.cu"
REPLACES = "src/repro/kernels/flash_attention.py:101"

#: launches of the CUDA kernel
launches = 0

NEG_INF = -1e30
HEAD_DIM = 64
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
             + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])


def plain_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          causal: bool = True, window: int | None = None,
                          scale: float | None = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch: f32 logits, masks at -1e30,
    f32 softmax and product, l == 0 guarded."""
    B, Hq, S, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    group = Hq // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    kg = k.float().repeat_interleave(group, dim=1)
    vg = v.float().repeat_interleave(group, dim=1)
    s = torch.einsum("bhsd,bhtd->bhst", q.float(), kg) * scale
    qpos = torch.arange(S, device=q.device)[:, None] + (T - S)
    kpos = torch.arange(T, device=q.device)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    s = torch.where(mask, s, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    l = torch.where(l == 0.0, 1.0, l)
    return (torch.einsum("bhst,bhtd->bhsd", p, vg) / l).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
                    window: int | None = None, scale: float | None = None) -> torch.Tensor:
    """Attention of q [B,Hq,S,D] over k, v [B,Hkv,T,D]: the plain version for
    CPU tensors, else the CUDA kernel (bf16, D = 64, S <= T)."""
    if native.on_cpu(q, k, v):
        return plain_flash_attention(q, k, v, causal=causal, window=window, scale=scale)
    global launches
    native.check("flash_attention", {"q": q, "k": k, "v": v}, torch.bfloat16)
    B, Hq, S, D = q.shape
    if k.shape != v.shape or k.dim() != 4 or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not match")
    Hkv, T = k.shape[1], k.shape[2]
    if D != HEAD_DIM or Hq % Hkv or not 0 < S <= T:
        raise ValueError(f"flash_attention: needs D == {HEAD_DIM}, Hq % Hkv == 0 and "
                         f"0 < S <= T; got D={D} Hq={Hq} Hkv={Hkv} S={S} T={T}")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window must be >= 1, got {window}")
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    out = torch.empty_like(q)
    fn = native.function("flash_attention", "repro_flash_attention", _ARGTYPES)
    err = fn(native.ptr(q), native.ptr(k), native.ptr(v), native.ptr(out), B, Hq, Hkv, S, T, D,
             float(scale), int(causal), int(window or 0), native.stream(q.device))
    native.raise_on_error("flash_attention", err)
    launches += 1
    return out
