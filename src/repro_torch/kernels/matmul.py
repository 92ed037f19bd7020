"""Blocked matmul written by hand for Hopper (``csrc/matmul.cu``), bf16 and
f32, and its fixed-weight role.

Replaces the Pallas TPU kernel ``repro/kernels/matmul.py`` ``matmul``
(``_mm_kernel``, entered through ``repro/kernels/ops.py`` ``pallas_matmul``):
[M, K] x [K, N] with an f32 accumulator, an optional silu or tanh-gelu
epilogue in f32, and a bf16 or f32 output.  f32 inputs take the f32 kernel
(full f32 FMAs on the CUDA cores, not TF32), as the Pallas kernel computes
f32 inputs in f32; it serves the paper's fully connected roles.
:func:`matmul_fixed_weight` replaces ``matmul_fixed_weight``
(``repro/kernels/matmul.py:98``), the weight-specialised role of paper §IV:
the same kernel with its weight held on the card from load to unload, as
the Pallas role is the same ``pallas_call`` closed over its weight.

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

from repro_torch.core.registry import ResourceFootprint

ROUTE = "cuda"
SOURCE = "src/repro_torch/csrc/matmul.cu"
REPLACES = "src/repro/kernels/matmul.py:59"
REPLACES_FIXED = "src/repro/kernels/matmul.py:98"

#: launches of the bf16 kernel (split-K's reduce pass is part of one launch)
launches = 0
#: launches of the f32 kernel, through :func:`matmul` or a fixed-weight role
f32_launches = 0
#: launches made through a fixed-weight role (:func:`matmul_fixed_weight`)
fixed_launches = 0

_ACTIVATIONS = {None: 0, "silu": 1, "gelu": 2}
_BM, _BN, _BK, _SMS = 64, 64, 32, 132
_F32_BK = 16
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_F32_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


#: the kernel's function in plain PyTorch (f32 product, f32 epilogue, cast):
#: the oracle itself
plain_matmul = ref.matmul


def split_k(M: int, N: int, K: int, bk: int = _BK) -> int:
    """K splits for an [M,K]x[K,N] launch of ``bk``-deep K tiles (32 bf16,
    16 f32): enough blocks for two per SM when the output tiles alone are
    fewer than the SMs, at least four K tiles per split.  Returned so that
    every split is non-empty (the C side checks)."""
    tiles = math.ceil(M / _BM) * math.ceil(N / _BN)
    kt = math.ceil(K / bk)
    if tiles >= _SMS:
        return 1
    splits = max(1, min(math.ceil(2 * _SMS / tiles), kt // 4))
    per = math.ceil(kt / splits)
    return math.ceil(kt / per)


def matmul(x: torch.Tensor, w: torch.Tensor, *, out_dtype: torch.dtype | None = None,
           activation: str | None = None) -> torch.Tensor:
    """``x [..., K] @ w [K, N]``: the plain version for CPU tensors, else the
    CUDA kernel: bf16 inputs give a bf16 or f32 output, f32 inputs an f32
    output."""
    return _matmul(x, w, out_dtype, activation, fixed=False)


def _matmul(x: torch.Tensor, w: torch.Tensor, out_dtype: torch.dtype | None,
            activation: str | None, fixed: bool) -> torch.Tensor:
    """:func:`matmul`; ``fixed`` counts a launch in :data:`fixed_launches`
    as well (a call of a fixed-weight role)."""
    if activation not in _ACTIVATIONS:
        raise ValueError(f"unknown activation {activation!r}")
    if native.on_cpu(x, w):
        return plain_matmul(x, w, out_dtype=out_dtype, activation=activation)
    out_dtype = out_dtype or x.dtype
    f32 = x.dtype == torch.float32
    if f32 and out_dtype != torch.float32:
        raise TypeError(f"matmul: f32 inputs give an f32 output, not {out_dtype}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"matmul: out_dtype must be bf16 or f32, got {out_dtype}")
    native.check("matmul", {"x": x, "w": w}, torch.float32 if f32 else torch.bfloat16)
    *lead, K = x.shape
    if w.dim() != 2 or w.shape[0] != K:
        raise ValueError(f"matmul: shapes {tuple(x.shape)} x {tuple(w.shape)} do not chain")
    M, N = math.prod(lead), w.shape[1]
    if M == 0:
        return torch.empty((*lead, N), dtype=out_dtype, device=x.device)
    align = 4 if f32 else 8            # 16-byte rows
    if K % align or N % align:
        raise ValueError(f"matmul: K={K} and N={N} must be multiples of {align}")
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    splits = split_k(M, N, K, _F32_BK if f32 else _BK)
    ws = (torch.empty((splits, M, N), dtype=torch.float32, device=x.device)
          if splits > 1 else None)
    if f32:
        global f32_launches
        fn = native.function("matmul", "repro_matmul_f32", _F32_ARGTYPES)
        err = fn(native.ptr(x), native.ptr(w), native.ptr(out), native.ptr(ws), M, N, K,
                 _ACTIVATIONS[activation], splits, native.stream(x.device))
        native.raise_on_error("matmul", err)
        f32_launches += 1
    else:
        global launches
        fn = native.function("matmul", "repro_matmul", _ARGTYPES)
        err = fn(native.ptr(x), native.ptr(w), native.ptr(out), native.ptr(ws), M, N, K,
                 _ACTIVATIONS[activation], int(out_dtype == torch.float32), splits,
                 native.stream(x.device))
        native.raise_on_error("matmul", err)
        launches += 1
    if fixed:
        global fixed_launches
        fixed_launches += 1
    return out.reshape(*lead, N)


class FixedWeightMatmul:
    """A matmul role with its weight fixed: a callable of ``x`` alone.

    :meth:`bind` returns the role with the weight on a device (uploaded once,
    held until the bound role is dropped); a call runs :func:`matmul` on the
    held weight, so it is bitwise equal to ``matmul(x, w)``."""

    def __init__(self, w: torch.Tensor, out_dtype: torch.dtype | None = None,
                 activation: str | None = None) -> None:
        self.weight = w
        self.out_dtype, self.activation = out_dtype, activation
        self.__name__ = f"matmul_fixed_{w.shape[0]}x{w.shape[1]}"

    def bind(self, device: "str | torch.device") -> "FixedWeightMatmul":
        return FixedWeightMatmul(self.weight.to(device), self.out_dtype, self.activation)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return _matmul(x, self.weight, self.out_dtype, self.activation, fixed=True)


def matmul_fixed_weight(w: torch.Tensor, *, out_dtype: torch.dtype | None = None,
                        activation: str | None = None) -> FixedWeightMatmul:
    """Fixed-weight role factory (paper §IV): one role per layer, its weight
    resident with the role.  The role planner decides when this pays off."""
    return FixedWeightMatmul(w, out_dtype, activation)


def footprint(f32: bool = False) -> ResourceFootprint:
    """Shared memory and threads of one block: the bf16 kernel's two-stage
    64x32 and 32x64 tiles (their f32 epilogue staging reuses them), or the
    f32 kernel's 64x16 and 16x64 tiles."""
    if f32:
        return ResourceFootprint(smem_bytes=4 * 2 * (64 * 20 + 16 * 68), threads=256)
    return ResourceFootprint(smem_bytes=max(2 * 2 * (64 * 40 + 32 * 72), 64 * 68 * 4),
                             threads=128)
