"""Decode attention written by hand for Hopper (``csrc/decode_attention.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/decode_attention.py``
``decode_attention`` (``_dec_kernel``): one query token per sequence,
q [B, Hq, D], against a dense cache [B, Hkv, T, D], masked past each
sequence's ``length`` (scalar or [B]), with an online softmax over KV tiles
and an l == 0 guard.

What bounds it on the H100: bytes — each cached key and value is read once
for a handful of flops.  The design splits each (sequence, kv head)'s keys
over :func:`split_kv` blocks (flash-decoding), a count that follows the
cache's rows alone: never the lengths, so the grid stays fixed for a CUDA
graph, and never the batch, so a row's result is the same whatever number
of sequences shares its launch (a decode step of 8 slots, of 16, or a
first-token fixup of one); each block carries the kv
head's whole query group as the rows of one tensor-core tile so the cache
is read once for all of them, deals its 32-key tiles to four warps that
keep two tiles each in flight by ``cp.async`` and merge their softmax
states at the end, and skips every tile at or past the sequence's length.
With more than one split, the last block of a (sequence, kv head) merges
the partials in split order in the same launch (an atomic counter, one
buffer per CUDA stream, left zeroed), so a call is one launch and repeats
bit for bit.  The kernel takes D a multiple of 16 from 16 to 128 (an
instance each) and Hq / Hkv <= 16, the rows of one tensor-core tile.  The
wrapper takes the rest of what the Pallas kernel takes up to D = 128: a D
off a multiple of 16 is zero-padded to the next one (q and the cache: zero
columns add exact zeros to every score, the scale stays 1/sqrt of the true
D, and the padded output columns are sliced off; the cache's copy makes it
slow, and no config runs it), and a query group above 16 runs as sub-groups
of at most 16 heads a kv head, a launch each (rows are independent, so this
is exact).  A D above 128 raises (MLA's 192 runs its own plain function).

:func:`plain_split_decode_attention` is the split-and-merge in plain
PyTorch (per split (m, l, acc), merged in the kernel's order); the wrapper's
CPU path runs the unsplit :func:`plain_decode_attention`, the same function
up to f32 rounding.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import native
from repro_torch.kernels.flash_attention import check_head_dim, pad_width

ROUTE = "cuda"
SOURCE = "src/repro_torch/csrc/decode_attention.cu"
REPLACES = "src/repro/kernels/decode_attention.py:69"

#: launches of the CUDA kernel (a split call is one launch)
launches = 0
#: the key-range splits of the kernel's last launch
last_splits = 0

NEG_INF = -1e30
#: keys a warp tile of the kernel; splits are whole tiles
TILE = 32
#: key-range splits a (sequence, kv head), at most (the kernel's cap too:
#: no shape of ``kernels/decode_sweep.py`` ran fastest above 8)
MAX_SPLITS = 8
#: 32-key tiles a split takes, two a warp (256 keys), up to MAX_SPLITS
#: splits: fixed, so the split, and with it the rounding, depends on the
#: cache's rows alone
SPLIT_TILES = 8
_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
             + [ctypes.c_float, ctypes.c_void_p])


def blocks_per_sm(head_dim: int) -> int:
    """Blocks of the instance for ``head_dim`` resident on an SM at once, as
    the CUDA runtime's occupancy calculator reads the built kernel (the
    dense instance: the paged one differs by its table slice only, and both
    must split alike).  Needs the card."""
    fn = native.function("decode_attention", "repro_decode_blocks_per_sm", [ctypes.c_int])
    n = fn(head_dim)
    if n <= 0:
        native.raise_on_error("decode_attention", -n)
        raise RuntimeError(f"decode_attention: no block of head_dim {head_dim} fits an SM")
    return n


def split_kv(T: int) -> int:
    """Key-range splits a (sequence, kv head) for a cache of T rows (dense
    rows, or table width times page size): one for every
    :data:`SPLIT_TILES` 32-key tiles, at most :data:`MAX_SPLITS`.  A
    function of T alone: the lengths would need a host sync and change the
    grid under a CUDA graph, and the batch would change a row's rounding
    with the number of slots (an 8-slot and a 16-slot engine must give a
    sequence the same tokens).  At llama's 1024 rows it is 4, what
    ``kernels/decode_sweep.py`` timed fastest at 8 slots."""
    return max(1, min(MAX_SPLITS, math.ceil(math.ceil(T / TILE) / SPLIT_TILES)))


def split_ranges(T: int, splits: int) -> list[tuple[int, int]]:
    """The key rows [lo, hi) of each split: whole 32-key tiles, ``per`` a
    split, as the kernel deals them."""
    tiles = -(-T // TILE)
    per = -(-tiles // splits)
    return [(min(T, sp * per * TILE), min(T, (sp + 1) * per * TILE)) for sp in range(splits)]


def lengths_vector(length, batch: int, device: torch.device) -> torch.Tensor:
    """``length`` (int, 0-d or [B] tensor) as an int32 [B] tensor on ``device``
    (an int is filled there: no copy from the host, so a graph may capture
    it)."""
    if isinstance(length, int):
        return torch.full((batch,), length, dtype=torch.int32, device=device)
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


def plain_split_decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                                 v_cache: torch.Tensor, length, splits: int, *,
                                 scale: float | None = None) -> torch.Tensor:
    """The kernel's split-and-merge in plain PyTorch: each split of
    :func:`split_ranges` gives (m, l, acc) over its valid keys (an empty
    split m = -1e30, l = 0, acc = 0), merged in split order as the kernel's
    last block merges them: ``o = Σ acc_s e^{m_s - M} / Σ l_s e^{m_s - M}``,
    l == 0 guarded.  f32 throughout; the unsplit plain version's function."""
    B, Hq, D = q.shape
    Hkv, T = k_cache.shape[1], k_cache.shape[2]
    group = Hq // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    lengths = lengths_vector(length, B, q.device)
    qg = q.float().reshape(B, Hkv, group, D)
    s = torch.einsum("bkgd,bktd->bkgt", qg, k_cache.float()) * scale
    valid = torch.arange(T, device=q.device)[None, :] < lengths[:, None]      # [B, T]
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    ms, ls, accs = [], [], []
    for lo, hi in split_ranges(T, splits):
        sv, ok = s[..., lo:hi], valid[:, None, None, lo:hi]
        m = sv.amax(dim=-1, keepdim=True) if hi > lo else torch.full_like(s[..., :1], NEG_INF)
        p = torch.where(ok, torch.exp(sv - m), 0.0)
        ms.append(m)
        ls.append(p.sum(dim=-1, keepdim=True))
        accs.append(torch.einsum("bkgt,bktd->bkgd", p, v_cache[:, :, lo:hi].float()))
    mm = torch.stack(ms).amax(dim=0)
    l = torch.zeros_like(mm)
    acc = torch.zeros((B, Hkv, group, D), dtype=torch.float32, device=q.device)
    for m, li, ai in zip(ms, ls, accs):
        f = torch.exp(m - mm)
        l = l + li * f
        acc = acc + ai * f
    out = acc / torch.where(l == 0.0, 1.0, l)
    return out.reshape(B, Hq, D).to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor, length, *,
                     scale: float | None = None, splits: int | None = None) -> torch.Tensor:
    """One-token attention over a dense cache: the plain version for CPU
    tensors, else the CUDA kernel (bf16, D up to 128, any whole query group)
    with ``splits`` key-range splits, :func:`split_kv`'s choice unless given
    (``kernels/decode_sweep.py`` times each count)."""
    if native.on_cpu(q, k_cache, v_cache):
        return plain_decode_attention(q, k_cache, v_cache, length, scale=scale)
    global last_splits
    native.check("decode_attention", {"q": q, "k_cache": k_cache, "v_cache": v_cache},
                 torch.bfloat16)
    B, Hq, D = q.shape
    if (k_cache.shape != v_cache.shape or k_cache.dim() != 4 or k_cache.shape[0] != B
            or k_cache.shape[3] != D):
        raise ValueError(f"decode_attention: q {tuple(q.shape)} vs cache "
                         f"{tuple(k_cache.shape)}/{tuple(v_cache.shape)}")
    Hkv, T = k_cache.shape[1], k_cache.shape[2]
    check_head_dim("decode_attention", D)
    check_group("decode_attention", Hq, Hkv)
    splits = check_splits("decode_attention", splits, T)
    lengths = lengths_vector(length, B, q.device)
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    q, k_cache, v_cache = pad_width(q), pad_width(k_cache), pad_width(v_cache)
    fn = native.function("decode_attention", "repro_decode_attention", _ARGTYPES)

    def launch(qs: torch.Tensor) -> torch.Tensor:
        out = torch.empty_like(qs)
        ws, counters, stream = split_buffers(qs, splits, Hkv)
        err = fn(native.ptr(qs), native.ptr(k_cache), native.ptr(v_cache), native.ptr(lengths),
                 native.ptr(out), native.ptr(ws), native.ptr(counters), B, qs.shape[1], Hkv, T,
                 qs.shape[2], splits, float(scale), stream)
        native.raise_on_error("decode_attention", err)
        native.count_launch(__name__)
        return out

    out = by_subgroups(launch, q, Hkv)
    last_splits = splits
    return out if out.shape[2] == D else out[..., :D].contiguous()


#: query heads a kv head that one launch of the decode kernels takes: the
#: rows of one tensor-core tile
MAX_GROUP = 16


def check_group(op: str, Hq: int, Hkv: int) -> None:
    """Raise unless ``Hq`` query heads share ``Hkv`` kv heads evenly."""
    if Hq % Hkv:
        raise ValueError(f"{op}: needs Hq / Hkv a whole number; got Hq={Hq} Hkv={Hkv}")


def subgroups(group: int) -> list[tuple[int, int]]:
    """The query sub-groups [lo, hi) of a kv head's ``group`` heads that the
    decode kernels run a launch each: one where the group fits a tile, else
    runs of :data:`MAX_GROUP` and the rest."""
    return [(lo, min(group, lo + MAX_GROUP)) for lo in range(0, group, MAX_GROUP)]


def by_subgroups(launch, q: torch.Tensor, Hkv: int) -> torch.Tensor:
    """``launch(q_sub)`` over each query sub-group of q [B, Hq, D]
    (:func:`subgroups`; the sub-group of every kv head, contiguous), the
    outputs put back in q's head order: q itself where the group fits one
    launch."""
    B, Hq, D = q.shape
    group = Hq // Hkv
    if group <= MAX_GROUP:
        return launch(q)
    qg = q.view(B, Hkv, group, D)
    out = torch.empty_like(qg)
    for lo, hi in subgroups(group):
        # a copy: with one kv head the reshape would be a strided view
        sub = qg[:, :, lo:hi].reshape(B, Hkv * (hi - lo), D).contiguous()
        out[:, :, lo:hi] = launch(sub).view(B, Hkv, hi - lo, D)
    return out.view(B, Hq, D)


def check_splits(op: str, splits: int | None, T: int) -> int:
    """``splits``, or :func:`split_kv`'s pick where it is None; raises unless
    it is 1 .. min(:data:`MAX_SPLITS`, ceil(T / 32))."""
    if splits is None:
        return split_kv(T)
    most = min(MAX_SPLITS, -(-T // TILE))
    if not 1 <= splits <= most:
        raise ValueError(f"{op}: splits must be 1 .. {most} for T={T}, got {splits}")
    return splits


def split_buffers(q: torch.Tensor, splits: int, Hkv: int):
    """(workspace, counters, stream) of a launch with ``splits`` splits: the
    f32 partials and (m, l) of every split, and B·Hkv zeroed counters of this
    stream (None, None where there is one split)."""
    handle = torch.cuda.current_stream(q.device).cuda_stream
    if splits == 1:
        return None, None, ctypes.c_void_p(handle)
    B, _, D = q.shape
    ws = torch.empty(splits * B * Hkv * 16 * (D + 2), dtype=torch.float32, device=q.device)
    counters = native.tile_counters("decode_attention", q.device, handle, B * Hkv)
    return ws, counters, ctypes.c_void_p(handle)
