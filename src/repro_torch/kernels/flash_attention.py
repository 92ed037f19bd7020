"""Flash attention written by hand for Hopper (``csrc/flash_attention.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py``
``flash_attention`` (``_fa_kernel``): online-softmax attention of
q [B, Hq, S, D] over k, v [B, Hkv, T, D], GQA head h reading kv head
h // (Hq // Hkv), causal and sliding-window masks at -1e30 with the queries
aligned to the end of the keys (``kv_offset = T - S``), a non-causal mode and
an l == 0 guard.  D = 64 or 128.

What bounds it on the H100: operations at prefill lengths in principle — a
causal 512 x 512 head does about 90 flops per byte it must move — but at
the serve runs' sizes (1.1 GFLOP at S = T = 512, about 1 µs at the bf16
rate) the time goes to each block's serial walk over its key tiles and to
SMs left idle.  The design: a block of one consumer warpgroup and one
producer warp owns 64 query rows of a head; the producer keeps TMA loads of
K and V tiles in flight in a 2-3 stage ring; both products run on ``wgmma``
(S = Q Kᵀ from shared memory, O += P V with P from registers); tiles the
masks hide from every row are never loaded; causal tiles that see the most
keys start first.  A key tile is 128 keys at D = 64 and 64 at D = 128 (its
registers).  P is rounded to bf16 for the P V product; that rounding
is why the kernel is held to its plain version within a bf16 tolerance.

Split-KV (:func:`split_kv`): where the (q tile, head) blocks alone would
leave SMs idle and each walks many key tiles — a 128-row chunk against
1024 keys is 64 blocks for 132 SMs, 16 tiles each — each block's key tiles
are split over up to four blocks; each writes
its partial softmax state to an f32 workspace this wrapper allocates, and
the last block of a tile (an atomic counter: one buffer per CUDA stream,
left zeroed) merges the splits in split order, in the same launch, so the
result depends on the shape alone.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import native

ROUTE = "cuda"
SOURCE = "src/repro_torch/csrc/flash_attention.cu"
REPLACES = "src/repro/kernels/flash_attention.py:101"

#: launches of the CUDA kernel (a split shape is one launch)
launches = 0

NEG_INF = -1e30
HEAD_DIMS = (64, 128)
#: query rows a tile of the kernel, and keys a tile at each head dim
BLOCK_Q = 64
BLOCK_K = {64: 128, 128: 64}
MAX_SPLITS = 4
_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
             + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])


def split_kv(B: int, Hq: int, S: int, T: int, causal: bool = True,
             window: int | None = None, head_dim: int = 64) -> int:
    """Key-range splits a (q tile, head) for one launch: 1 when the tiles
    ``B · Hq · ceil(S / 64)`` fill the card's SMs (132 on the H100); else
    at most one block an SM and :data:`MAX_SPLITS`, and one split for every
    384 keys the q tile that sees the most keys (the last one) walks.  A block walks
    its key tiles one after another (about 0.01 µs a key at D = 64) and the
    merge costs 3-4 µs, so a split pays only where it takes some 350 keys
    off the walk (``kernels/flash_sweep.py``: a 128-row chunk splits in two
    from 768 keys)."""
    tiles, sms = B * Hq * math.ceil(S / BLOCK_Q), native.sm_count()
    if tiles >= sms:
        return 1
    bk = BLOCK_K[head_dim]
    q_first = (math.ceil(S / BLOCK_Q) - 1) * BLOCK_Q + T - S   # the last q tile's first row
    lo = max(0, q_first - window + 1) // bk if window else 0
    visible = (math.ceil(T / bk) - lo) * bk
    return max(1, min(MAX_SPLITS, sms // tiles, visible // 384))


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
                    window: int | None = None, scale: float | None = None,
                    splits: int | None = None) -> torch.Tensor:
    """Attention of q [B,Hq,S,D] over k, v [B,Hkv,T,D]: the plain version for
    CPU tensors, else the CUDA kernel (bf16, D = 64 or 128, S <= T) with
    ``splits`` key-range splits, :func:`split_kv`'s choice unless given
    (``kernels/flash_sweep.py`` times the others)."""
    if native.on_cpu(q, k, v):
        return plain_flash_attention(q, k, v, causal=causal, window=window, scale=scale)
    native.check("flash_attention", {"q": q, "k": k, "v": v}, torch.bfloat16)
    B, Hq, S, D = q.shape
    if k.shape != v.shape or k.dim() != 4 or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not match")
    Hkv, T = k.shape[1], k.shape[2]
    if D not in HEAD_DIMS or Hq % Hkv or not 0 < S <= T:
        raise ValueError(f"flash_attention: needs D in {HEAD_DIMS}, Hq % Hkv == 0 and "
                         f"0 < S <= T; got D={D} Hq={Hq} Hkv={Hkv} S={S} T={T}")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window must be >= 1, got {window}")
    if splits is None:
        splits = split_kv(B, Hq, S, T, causal, window, D)
    elif not 1 <= splits <= MAX_SPLITS:
        raise ValueError(f"flash_attention: splits must be 1 .. {MAX_SPLITS}, got {splits}")
    return _launch(q, k, v, splits, causal, window, scale)


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, splits: int, causal: bool,
            window: int | None, scale: float | None) -> torch.Tensor:
    """One launch of the kernel on checked inputs; the output."""
    global launches
    B, Hq, S, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    out = torch.empty_like(q)
    ws = counters = None
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if splits > 1:
        q_tiles = math.ceil(S / BLOCK_Q)
        ws = torch.empty(splits * B * Hq * q_tiles * BLOCK_Q * (D + 2), dtype=torch.float32,
                         device=q.device)
        counters = native.tile_counters("flash_attention", q.device, stream, B * Hq * q_tiles)
    fn = native.function("flash_attention", "repro_flash_attention", _ARGTYPES)
    err = fn(native.ptr(q), native.ptr(k), native.ptr(v), native.ptr(out), native.ptr(ws),
             native.ptr(counters), B, Hq, Hkv, S, T, D, float(scale), int(causal),
             int(window or 0), splits, ctypes.c_void_p(stream))
    native.raise_on_error("flash_attention", err)
    launches += 1
    return out
