"""Temperature sampling written by hand for Hopper (``csrc/sample.cu``).

Replaces ``jax.random.categorical`` in the JAX engine's fused decode scan
(``repro/serve/engine.py`` ``_fused_decode_fn``): each live slot's token is
``argmax(gumbel + logits / T)`` under JAX's position-indexed Threefry stream
(``repro_torch/serve/sampling.py`` holds the stream and the plain version).
Not a TPU kernel: the JAX package leaves this to XLA.

What bounds it on the H100: operations — twenty Threefry rounds for each
4-byte logit, their shifts and xors on the 64-lane integer ALU pipe.  The
kernel hashes 4 or 8 logits a thread as independent chains, takes the two
logs and the division only for the elements a cheap pre-test cannot rule
out, and spreads a slot's vocabulary over :func:`splits_for` blocks so that
any batch fills the card, merging the blocks' bests in the same launch (one
64-bit atomic maximum a block; the last block of a slot to arrive at its
counter writes the token; one counter and one key buffer per CUDA stream,
left zeroed).

Beside the wrapper, plain models of the design that no path runs: the
pre-test (:func:`gumbel_bounds`, :func:`score_bounds`, :func:`pretest`) and
the split and merge (:func:`split_ranges`, :func:`plain_split_merge`), which
the CPU tests hold to :func:`~repro_torch.serve.sampling.plain_sample`.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import native
from repro_torch.serve.sampling import MASK, TINY, fold_in, plain_sample, random_bits_32

ROUTE = "cuda"
SOURCE = "src/repro_torch/csrc/sample.cu"
REPLACES = "src/repro/serve/engine.py:2027"

#: launches of the CUDA kernel
launches = 0

#: threads a block, and the most blocks a slot (the kernel's caps)
THREADS = 256
MAX_SPLITS = 1024
#: blocks an SM the split rule aims for at any batch (two fit an SM)
WAVES = 2
#: the fewest logits a split takes
MIN_SPLIT = 128
#: logits a thread hashes at once where each thread has at least
#: :data:`WIDE_WORK` logits (8 independent Threefry chains), else 4
CHAINS = (4, 8)
WIDE_WORK = 13
_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [ctypes.c_float]
             + [ctypes.c_int] * 2 + [ctypes.c_void_p])

#: the pre-test's buckets (``csrc/sample.cu``): d = 1 - f, f the uniform
#: before its tiny offset, by its float bits >> BUCKET_SHIFT; bucket 0 holds
#: d = 2^-23, the last d = 1
BUCKET_SHIFT = 19
FIRST_BUCKET = (127 - 23) << 4
BUCKETS = (127 << 4) - FIRST_BUCKET + 1
#: widens each bucket's bounds of the Gumbel term both ways
MARGIN = 2.0 ** -16

#: the shapes the sampled serve runs give the sampler: a decode step of 8
#: slots (dense, paged) and of 16 (chunked) over llama's vocabulary,
#: Mamba-2's step of 8, and the first token of each, one slot; then yi's and
#: granite's vocabularies (granite's not a multiple of the block's) at a first
#: token and decode steps of 8 and of 16 slots; llama4-maverick's and
#: deepseek-v3's, and hymba's (32001), a first token and a step of 8
SHAPES = ((8, 128256), (1, 128256), (16, 128256), (8, 50280), (1, 50280), (8, 49155),
          (1, 49155), (16, 49155), (1, 64000), (8, 64000), (16, 64000),
          (1, 202048), (8, 202048), (1, 129280), (8, 129280), (1, 32001), (8, 32001))
#: the kernel against its plain version: tokens equal wherever the two best
#: scores lie more than this many ulps apart (the kernel's logf and
#: PyTorch's may part by an ulp)
TIE_ULPS = 4


def splits_for(B: int, V: int) -> int:
    """Blocks a slot: as many as fit :data:`WAVES` blocks an SM over the
    batch (one wave: a block past it would run alone after the rest), but no
    more than the SMs (more blocks merging into one slot's key cost more
    than their work saves), at least :data:`MIN_SPLIT` logits a block, at
    most :data:`MAX_SPLITS`."""
    sms = native.sm_count()
    return max(1, min(MAX_SPLITS, sms, WAVES * sms // B, -(-V // MIN_SPLIT)))


def chains_for(V: int, splits: int) -> int:
    """Threefry chains a thread: 8 where a thread has :data:`WIDE_WORK`
    logits or more (fewer loop trips), else 4 (fewer registers: more
    blocks resident, shorter chains of latency)."""
    return CHAINS[1] if V / (splits * THREADS) >= WIDE_WORK else CHAINS[0]


def sample(logits: torch.Tensor, keys: torch.Tensor, counts: torch.Tensor, live: torch.Tensor,
           tok: torch.Tensor, temperature: float, *, bits: torch.Tensor | None = None,
           splits: int | None = None, chains: int | None = None,
           margin: bool = True) -> torch.Tensor:
    """Draw each live slot's token into ``tok`` in place: the plain version
    for CPU tensors, else the CUDA kernel.  ``logits`` f32 ``[B, V]``,
    ``keys`` int32 ``[B, 2]`` (each slot's uint32 key), ``counts`` (the token
    index t), ``live`` (nonzero: draw) and ``tok`` int32 ``[B]``;
    ``temperature`` > 0.  ``bits``, an int32 ``[B, V]``, receives each live
    slot's random bits (the check of the stream); ``splits`` overrides
    :func:`splits_for` and ``chains`` (4 or 8) :func:`chains_for`; ``margin``
    False runs the kernel's planted fault (each element's upper bound taken
    at its bucket's lower end: an element at the top of its bucket can be
    dropped), for the checks."""
    if temperature <= 0:
        raise ValueError(f"sample: temperature must be > 0, got {temperature}")
    B, V = logits.shape
    if native.on_cpu(logits, keys, counts, live, tok):
        if bits is not None:
            drawn = random_bits_32(fold_in(keys, counts), V).to(torch.int32)
            bits.copy_(torch.where(live[:, None] != 0, drawn, bits))
        return plain_sample(logits, keys, counts, live, tok, temperature)
    native.check("sample", {"logits": logits}, torch.float32, aligned=False)
    native.check("sample", {"keys": keys, "counts": counts, "live": live, "tok": tok},
                 torch.int32, aligned=False)
    if keys.shape != (B, 2) or any(t.shape != (B,) for t in (counts, live, tok)):
        raise ValueError(f"sample: logits {tuple(logits.shape)}, keys {tuple(keys.shape)}, "
                         f"counts/live/tok {tuple(counts.shape)}/{tuple(live.shape)}/"
                         f"{tuple(tok.shape)} do not match")
    if bits is not None:
        native.check("sample", {"bits": bits, "logits": logits}, aligned=False)
        if bits.shape != (B, V) or bits.dtype != torch.int32:
            raise ValueError(f"sample: bits must be int32 {(B, V)}")
    splits = splits_for(B, V) if splits is None else splits
    if not 1 <= splits <= MAX_SPLITS:
        raise ValueError(f"sample: splits must be 1 .. {MAX_SPLITS}, got {splits}")
    chains = chains_for(V, splits) if chains is None else chains
    if chains not in CHAINS:
        raise ValueError(f"sample: chains must be 4 or 8, got {chains}")
    stream = torch.cuda.current_stream(logits.device).cuda_stream
    merged = counters = None
    if splits > 1:
        merged = native.tile_counters("sample_keys", logits.device, stream, 2 * B)
        counters = native.tile_counters("sample", logits.device, stream, B)
    fn = native.function("sample", "repro_sample", _ARGTYPES)
    err = fn(native.ptr(logits), native.ptr(keys), native.ptr(counts), native.ptr(live),
             native.ptr(tok), native.ptr(bits), native.ptr(merged), native.ptr(counters), B, V,
             splits, float(temperature), chains, int(margin), ctypes.c_void_p(stream))
    native.raise_on_error("sample", err)
    native.count_launch(__name__)
    return tok


def scores_apart(scores: torch.Tensor, ulps: int = TIE_ULPS) -> torch.Tensor:
    """Rows of ``scores`` ``[B, V]`` whose two best scores lie more than
    ``ulps`` ulps of the best apart (bool ``[B]``): where the kernel's logf
    and PyTorch's cannot swap the draw."""
    top = scores.topk(2, dim=-1).values
    best = top[:, 0].abs()
    return (top[:, 0] - top[:, 1]) / (torch.nextafter(best, best + 1) - best) > ulps


# ---------------------------------------------------------------------------
# plain models of the kernel's design (the CPU tests'; no path runs them)
# ---------------------------------------------------------------------------


def _gumbel_f32(f: torch.Tensor) -> torch.Tensor:
    """The Gumbel term as the kernel computes it from f32 ``f``, the uniform
    before its tiny offset: ``-log(-log(max(f + tiny, tiny)))``, in f32."""
    return -torch.log(-torch.log(torch.clamp_min(f + TINY, TINY)))


def bucket_of(bits: torch.Tensor) -> torch.Tensor:
    """Each element's pre-test bucket from its random bits (uint32 values in
    any int tensor): d = 2 - (1 + f) = 1 - f, exactly, by its float bits."""
    v = (((bits.to(torch.int64) & MASK) >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return ((2.0 - v).view(torch.int32) >> BUCKET_SHIFT) - FIRST_BUCKET


def gumbel_bounds() -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's table, f32 ``[BUCKETS]`` each: the Gumbel term at each
    bucket's smallest d plus :data:`MARGIN` (an upper bound of the term over
    the bucket) and at the next bucket's minus it (a lower bound)."""
    j = torch.arange(BUCKETS + 1, dtype=torch.int32)
    d = ((j + FIRST_BUCKET) << BUCKET_SHIFT).view(torch.float32)
    g = _gumbel_f32(1.0 - d)
    return g[:-1] + MARGIN, g[1:] - MARGIN


def scale_bounds(temperature: float) -> tuple[np.float32, np.float32]:
    """1/T rounded to nearest in f32, then one ulp up and down: ``(c_up,
    c_dn)`` with c_dn <= 1/T <= c_up exactly (the kernel's launcher)."""
    rt = np.float32(1.0) / np.float32(temperature)
    return np.nextafter(rt, np.float32(np.inf)), np.nextafter(rt, np.float32(0.0))


def score_bounds(logits: torch.Tensor, bits: torch.Tensor, temperature: float,
                 margin: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's bounds ``(lb, ub)`` of each element's exact score:
    l * c_dn and l * c_up, each rounded once, bracket l / T (rounded), and a
    bucket's bounds bracket the Gumbel term; f32 additions, rounded once,
    keep the order.  ``margin`` False: the planted fault's ub (the bucket's
    lower bound)."""
    c_up, c_dn = (torch.tensor(c, dtype=torch.float32, device=logits.device)
                  for c in scale_bounds(temperature))
    a, c = logits.float() * c_up, logits.float() * c_dn
    upper, lower = (t.to(logits.device) for t in gumbel_bounds())
    k = bucket_of(bits).long()
    return torch.minimum(a, c) + lower[k], torch.maximum(a, c) + (upper if margin else lower)[k]


def pretest(logits: torch.Tensor, bits: torch.Tensor, temperature: float,
            margin: bool = True) -> torch.Tensor:
    """The elements that take the exact path (bool, the shape of
    ``logits``): those whose ub does not lie below the row's largest lb (NaN
    bounds ignored, as fmaxf does).  The kernel's thresholds are maxima of
    lb over parts of the row, never above this one, so its survivors
    include these."""
    lb, ub = score_bounds(logits, bits, temperature, margin)
    thr = torch.where(lb.isnan(), -float("inf"), lb).amax(dim=-1, keepdim=True)
    return ~(ub < thr)


def merge_keys(scores: torch.Tensor) -> np.ndarray:
    """The kernel's 64-bit key of each element (uint64, the shape of
    ``scores``): the score's order (NaN above all, -0 as +0) above the
    complement of the index, so the largest key is the draw."""
    s = (scores.detach().float().cpu() + 0.0).numpy()
    u = s.view(np.uint32).astype(np.uint64)
    order = np.where(u & 0x80000000, ~u & 0xFFFFFFFF, u | 0x80000000)
    order = np.where(np.isnan(s), np.uint64(0xFFFFFFFF), order)
    index = np.arange(s.shape[-1], dtype=np.uint64)
    return (order << np.uint64(32)) | (np.uint64(0xFFFFFFFF) - index)


def split_ranges(V: int, splits: int, phase: int = 0) -> list[tuple[int, int]]:
    """The logits ``[lo, hi)`` of each split of a row whose first logit lies
    ``phase`` floats past a 16-byte boundary, as the kernel cuts it: the
    head up to the boundary (quad -1), whole quads, the tail (quad nq); a
    split takes the next ceil(quads / splits) of those quads."""
    h = min(V, (4 - phase) % 4)
    nq = (V - h) // 4
    qmin, qmax = (-1 if h else 0), nq + (1 if V - h - 4 * nq else 0)
    total = qmax - qmin
    per = -(-total // splits)
    out = []
    for s in range(splits):
        qlo, qhi = qmin + min(total, s * per), qmin + min(total, (s + 1) * per)
        lo, hi = max(0, h + 4 * qlo), min(V, h + 4 * qhi)
        out.append((lo, max(lo, hi)))
    return out


def plain_split_merge(scores: torch.Tensor, splits: int, phase: int = 0,
                      keep: torch.Tensor | None = None) -> torch.Tensor:
    """The draw as the split and merge take it from exact ``scores`` ``[B,
    V]``: each split's largest key, then the largest of those; int64 ``[B]``.
    ``phase`` as :func:`split_ranges` (row b's is ``(phase + b V) % 4``);
    ``keep`` (bool ``[B, V]``, e.g. :func:`pretest`'s survivors): the
    elements that take part, the others as if never scored (key 0)."""
    keys = merge_keys(scores)
    if keep is not None:
        keys = np.where(keep.cpu().numpy(), keys, np.uint64(0))
    B, V = scores.shape
    toks = []
    for b in range(B):
        parts = [keys[b, lo:hi].max() for lo, hi in split_ranges(V, splits, (phase + b * V) % 4)
                 if hi > lo]
        toks.append(int(np.uint64(0xFFFFFFFF) - (max(parts) & np.uint64(0xFFFFFFFF))))
    return torch.tensor(toks, dtype=torch.int64)
