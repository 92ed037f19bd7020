"""Fused RMSNorm written by hand for Hopper (``csrc/rmsnorm.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/rmsnorm.py`` ``rmsnorm``
(``_rmsnorm_kernel``): ``x * rsqrt(mean(x^2) + eps) * w`` with f32
statistics and one rounding to x's dtype, for any D and for bf16, f16, f32
and f64 (the weight in x's dtype; an f64 element is rounded to f32 as it is
read, as the plain version's statistics are f32).  The Pallas kernel takes
any float dtype: the wrapper runs any other (the fp8 types) through the f32
instance and casts the result to x's dtype, as the Pallas kernel's
``astype`` does.

What bounds it on the H100: bytes — a row reduction and an elementwise
scale, a few flops per element and no tensor-core work — and, at decode
rows, the latency of one memory trip.  The design holds a row in the
registers of one block (1, 2, 4 or 8 warps, the fewest that hold it at one
16-byte chunk a thread), starts the loads of x and w together and reduces
with warp shuffles, so a row costs one trip.  A row's sum is taken in an
order fixed by D alone, so its output is bitwise the same whatever launch
it comes in.
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

#: the dtypes the kernel takes, by the code its C entry reads
_DTYPES = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2, torch.float64: 3}
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_float] + [ctypes.c_int] * 2 + [
    ctypes.c_void_p]
#: warps a row the kernel takes (``warps=``); None is its rule's count
WARPS = (1, 2, 4, 8)


#: the kernel's function in plain PyTorch (f32 statistics, one cast): the oracle
plain_rmsnorm = ref.rmsnorm


def rule_warps(D: int, dtype: torch.dtype) -> int:
    """The warps a row the kernel's rule gives a row of D (read from the
    built kernel: needs the card)."""
    fn = native.function("rmsnorm", "repro_rmsnorm_warps", [ctypes.c_int] * 2)
    return fn(D, _DTYPES[dtype])


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, *, eps: float = 1e-6,
            warps: int | None = None) -> torch.Tensor:
    """RMS norm over the last axis: the plain version for CPU tensors, else
    the CUDA kernel (bf16, f16, f32 or f64, the weight in x's dtype; any
    other float type through the f32 instance; any D).  ``warps`` overrides
    the rule's warps a row (``kernels/rmsnorm_sweep.py``); a row's output
    then depends on it."""
    if native.on_cpu(x, weight):
        return plain_rmsnorm(x, weight, eps=eps)
    if x.dtype not in _DTYPES:
        if not x.dtype.is_floating_point or weight.dtype != x.dtype:
            raise TypeError(f"rmsnorm: x must be a float type, the weight in x's, got "
                            f"{x.dtype} and {weight.dtype}")
        return rmsnorm(x.float(), weight.float(), eps=eps, warps=warps).to(x.dtype)
    native.check("rmsnorm", {"x": x, "weight": weight}, x.dtype, aligned=False)
    D = x.shape[-1]
    if weight.shape != (D,):
        raise ValueError(f"rmsnorm: weight {tuple(weight.shape)} vs x {tuple(x.shape)}")
    if warps not in (None, *WARPS):
        raise ValueError(f"rmsnorm: warps must be one of {WARPS}, got {warps}")
    rows = math.prod(x.shape[:-1])
    out = torch.empty_like(x)
    if rows == 0 or D == 0:
        return out
    fn = native.function("rmsnorm", "repro_rmsnorm", _ARGTYPES)
    err = fn(native.ptr(x), native.ptr(weight), native.ptr(out), rows, D, float(eps),
             _DTYPES[x.dtype], warps or 0, native.stream(x.device))
    native.raise_on_error("rmsnorm", err)
    native.count_launch(__name__)
    return out
