"""Blocked bf16 matmul written by hand for Hopper (``csrc/matmul.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/matmul.py`` ``matmul``
(``_mm_kernel``, entered through ``repro/kernels/ops.py`` ``pallas_matmul``):
[M, K] x [K, N] with an f32 accumulator, an optional silu or tanh-gelu
epilogue in f32, and a bf16 or f32 output.

What bounds it on the H100: at decode, M is the number of batch slots (8), so
every weight byte is read once for 16 flops — far below the ~295 flops per
byte where the tensor cores become the limit — and the kernel is bound by
bytes.  At prefill (M = the prompt bucket, up to 1024) it is bound by
operations.  The design answers both with one kernel: 64x64 output tiles on
the tensor cores (WMMA bf16, f32 accumulate) with a two-stage ``cp.async``
ring over K, and, where the output has too few tiles to fill 132 SMs (decode,
or small N), K is split across blocks and a second pass sums the f32
partials in a fixed order.  The wrapper flattens leading dimensions as
``pallas_matmul`` did, but needs no dividing block sizes: the kernel masks
ragged M, N and K itself.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import native, ref

ROUTE = "cuda"
SOURCE = "src/repro_torch/csrc/matmul.cu"
REPLACES = "src/repro/kernels/matmul.py:59"

#: launches of the CUDA kernel (split-K's reduce pass is part of one launch)
launches = 0

_ACTIVATIONS = {None: 0, "silu": 1, "gelu": 2}
_BM, _BN, _BK, _SMS = 64, 64, 32, 132
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


#: the kernel's function in plain PyTorch (f32 product, f32 epilogue, cast):
#: the oracle itself
plain_matmul = ref.matmul


def split_k(M: int, N: int, K: int) -> int:
    """K splits for an [M,K]x[K,N] launch: enough blocks for two per SM when
    the output tiles alone are fewer than the SMs, at least four K tiles per
    split.  Returned so that every split is non-empty (the C side checks)."""
    tiles = math.ceil(M / _BM) * math.ceil(N / _BN)
    kt = math.ceil(K / _BK)
    if tiles >= _SMS:
        return 1
    splits = max(1, min(math.ceil(2 * _SMS / tiles), kt // 4))
    per = math.ceil(kt / splits)
    return math.ceil(kt / per)


def matmul(x: torch.Tensor, w: torch.Tensor, *, out_dtype: torch.dtype | None = None,
           activation: str | None = None) -> torch.Tensor:
    """``x [..., K] @ w [K, N]``: the plain version for CPU tensors, else the
    CUDA kernel (bf16 inputs, bf16 or f32 output)."""
    if activation not in _ACTIVATIONS:
        raise ValueError(f"unknown activation {activation!r}")
    if native.on_cpu(x, w):
        return plain_matmul(x, w, out_dtype=out_dtype, activation=activation)
    global launches
    out_dtype = out_dtype or x.dtype
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"matmul: out_dtype must be bf16 or f32, got {out_dtype}")
    native.check("matmul", {"x": x, "w": w}, torch.bfloat16)
    *lead, K = x.shape
    if w.dim() != 2 or w.shape[0] != K:
        raise ValueError(f"matmul: shapes {tuple(x.shape)} x {tuple(w.shape)} do not chain")
    M, N = math.prod(lead), w.shape[1]
    if M == 0:
        return torch.empty((*lead, N), dtype=out_dtype, device=x.device)
    if K % 8 or N % 8:
        raise ValueError(f"matmul: K={K} and N={N} must be multiples of 8")
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    splits = split_k(M, N, K)
    ws = (torch.empty((splits, M, N), dtype=torch.float32, device=x.device)
          if splits > 1 else None)
    fn = native.function("matmul", "repro_matmul", _ARGTYPES)
    err = fn(native.ptr(x), native.ptr(w), native.ptr(out), native.ptr(ws), M, N, K,
             _ACTIVATIONS[activation], int(out_dtype == torch.float32), splits,
             native.stream(x.device))
    native.raise_on_error("matmul", err)
    launches += 1
    return out.reshape(*lead, N)
