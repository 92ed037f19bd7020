"""Paged decode attention written by hand for Hopper (``csrc/decode_attention.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/decode_attention.py``
``paged_decode_attention`` (``_paged_kernel``): one query token per
sequence, q [B, Hq, D], against a global page pool [P, Hkv, ps, D] read
through an int32 block table [B, NP] (key row t of sequence b lives in pool
page ``table[b, t // ps]`` at offset ``t % ps``), masked past each
sequence's ``length`` (scalar or [B]), with an online softmax and an l == 0
guard.

What bounds it on the H100: bytes — ``sum(lengths) · Hkv · D · 2`` bytes of
keys and as many of values, read once, for a handful of flops each.  The
design is the dense kernel's (``kernels/decode_attention.py``) with another
row address: the same key-range splits (picked from T = table width × page
size), 32-key tiles round-robin over four warps with two in flight each,
the same masks and both merges, so over equal KV rows it is bitwise equal
to the dense kernel on the gathered cache, for any page size.  Each block
stages its slice of the table row in shared memory before its key loop, so
no row's copy waits on a table read.  It reads no row at or past
a sequence's length, so table entries past it (the scratch page) are never
dereferenced, and it makes no dense copy of the pages.  A table entry inside
the length that lies outside the pool is a corrupt table: the kernel masks
that page's rows out of the softmax (it cannot raise without a sync; the
plain version's gather raises for an index past the pool).  D a multiple of
16 from 16 to 128, Hq / Hkv <= 16.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import native
from repro_torch.kernels.decode_attention import (check_splits, lengths_vector,
                                                  plain_decode_attention,
                                                  plain_split_decode_attention, split_buffers)
from repro_torch.kernels.flash_attention import check_head_dim
from repro_torch.kernels.ref import gather_kv_pages

ROUTE = "cuda"
SOURCE = "src/repro_torch/csrc/decode_attention.cu"
REPLACES = "src/repro/kernels/decode_attention.py:165"

#: launches of the CUDA kernel
launches = 0
#: the key-range splits of the kernel's last launch
last_splits = 0

_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
             + [ctypes.c_float, ctypes.c_void_p])


def plain_paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                                 v_pages: torch.Tensor, block_table: torch.Tensor, length, *,
                                 scale: float | None = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch: gather the pages into the
    dense layout, then the dense kernel's plain version."""
    return plain_decode_attention(q, gather_kv_pages(k_pages, block_table),
                                  gather_kv_pages(v_pages, block_table), length, scale=scale)


def plain_split_paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                                       v_pages: torch.Tensor, block_table: torch.Tensor,
                                       length, splits: int, *,
                                       scale: float | None = None) -> torch.Tensor:
    """The kernel's split-and-merge in plain PyTorch: gather the pages into
    the dense layout, then the dense kernel's split plain version."""
    return plain_split_decode_attention(q, gather_kv_pages(k_pages, block_table),
                                        gather_kv_pages(v_pages, block_table), length, splits,
                                        scale=scale)


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                           block_table: torch.Tensor, length, *, scale: float | None = None,
                           splits: int | None = None) -> torch.Tensor:
    """One-token attention over a paged pool: the plain version for CPU
    tensors, else the CUDA kernel (bf16, D a multiple of 16 up to 128, Hq / Hkv
    <= 16, an int32 block table on the card) with ``splits`` key-range
    splits, ``split_kv(NP · ps)``'s choice unless given: the dense
    kernel's on the gathered cache."""
    if native.on_cpu(q, k_pages, v_pages, block_table):
        return plain_paged_decode_attention(q, k_pages, v_pages, block_table, length,
                                            scale=scale)
    global last_splits
    native.check("paged_decode_attention", {"q": q, "k_pages": k_pages, "v_pages": v_pages},
                 torch.bfloat16)
    native.check("paged_decode_attention", {"q": q, "block_table": block_table})
    if block_table.dtype != torch.int32:
        raise TypeError(f"paged_decode_attention: block_table must be torch.int32, "
                        f"got {block_table.dtype}")
    B, Hq, D = q.shape
    if (k_pages.shape != v_pages.shape or k_pages.dim() != 4 or k_pages.shape[3] != D
            or block_table.dim() != 2 or block_table.shape[0] != B):
        raise ValueError(f"paged_decode_attention: q {tuple(q.shape)}, pools "
                         f"{tuple(k_pages.shape)}/{tuple(v_pages.shape)}, table "
                         f"{tuple(block_table.shape)} do not match")
    P, Hkv, ps = k_pages.shape[:3]
    NP = block_table.shape[1]
    check_head_dim("paged_decode_attention", D)
    if Hq % Hkv or Hq // Hkv > 16:
        raise ValueError(f"paged_decode_attention: needs Hq / Hkv a whole number <= 16; "
                         f"got Hq={Hq} Hkv={Hkv}")
    splits = check_splits("paged_decode_attention", splits, NP * ps)
    lengths = lengths_vector(length, B, q.device)
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    out = torch.empty_like(q)
    ws, counters, stream = split_buffers(q, splits, Hkv)
    fn = native.function("decode_attention", "repro_paged_decode_attention", _ARGTYPES)
    err = fn(native.ptr(q), native.ptr(k_pages), native.ptr(v_pages), native.ptr(block_table),
             native.ptr(lengths), native.ptr(out), native.ptr(ws), native.ptr(counters),
             B, Hq, Hkv, P, ps, NP, D, splits, float(scale), stream)
    native.raise_on_error("paged_decode_attention", err)
    native.count_launch(__name__)
    last_splits = splits
    return out
