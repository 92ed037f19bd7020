"""Fused RMSNorm written by hand for Hopper (``csrc/rmsnorm.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/rmsnorm.py`` ``rmsnorm``
(``_rmsnorm_kernel``): ``x * rsqrt(mean(x^2) + eps) * w`` with f32
statistics and one write.  It is written in CUDA like the other three
kernels, so the port builds one way.

What bounds it on the H100: bytes — a row reduction and an elementwise
scale, a few flops per element and no tensor-core work.  The design reads
each row with 16-byte loads in one block per row, reduces in registers and
shared memory, and writes the result once; the second read of the row comes
from L1.  f32 rows (the weight in x's dtype, as the Pallas kernel computes
any dtype) take a kernel of their own of the same design.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import native, ref

ROUTE = "cuda"
SOURCE = "src/repro_torch/csrc/rmsnorm.cu"
REPLACES = "src/repro/kernels/rmsnorm.py:27"

#: launches of the CUDA kernel
launches = 0

_SYMBOLS = {torch.bfloat16: "repro_rmsnorm", torch.float32: "repro_rmsnorm_f32"}
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_float, ctypes.c_void_p]


#: the kernel's function in plain PyTorch (f32 statistics, one cast): the oracle
plain_rmsnorm = ref.rmsnorm


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    """RMS norm over the last axis: the plain version for CPU tensors, else
    the CUDA kernel (bf16 or f32; the weight in x's dtype)."""
    if native.on_cpu(x, weight):
        return plain_rmsnorm(x, weight, eps=eps)
    global launches
    if x.dtype not in _SYMBOLS:
        raise TypeError(f"rmsnorm: x must be bf16 or f32, got {x.dtype}")
    native.check("rmsnorm", {"x": x, "weight": weight}, x.dtype)
    D = x.shape[-1]
    if weight.shape != (D,) or D % 8:
        raise ValueError(f"rmsnorm: weight {tuple(weight.shape)} vs x {tuple(x.shape)}; "
                         "D must be a multiple of 8")
    rows = math.prod(x.shape[:-1])
    out = torch.empty_like(x)
    if rows == 0:
        return out
    fn = native.function("rmsnorm", _SYMBOLS[x.dtype], _ARGTYPES)
    err = fn(native.ptr(x), native.ptr(weight), native.ptr(out), rows, D, float(eps),
             native.stream(x.device))
    native.raise_on_error("rmsnorm", err)
    launches += 1
    return out
