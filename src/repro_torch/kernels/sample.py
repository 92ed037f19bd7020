"""Temperature sampling written by hand for Hopper (``csrc/sample.cu``).

Replaces ``jax.random.categorical`` in the JAX engine's fused decode scan
(``repro/serve/engine.py`` ``_fused_decode_fn``): each live slot's token is
``argmax(gumbel + logits / T)`` under JAX's position-indexed Threefry stream
(``repro_torch/serve/sampling.py`` holds the stream and the plain version).
Not a TPU kernel: the JAX package leaves this to XLA.

What bounds it on the H100: operations — twenty Threefry rounds and two
logs for each 4-byte logit.  The design spreads a slot's vocabulary over
:func:`splits_for` blocks, so that a decode batch of 8 slots fills the card,
and merges the blocks' partial maxima in the same launch (the last block of
a slot to arrive at its counter, one buffer per CUDA stream, left zeroed).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import native
from repro_torch.serve.sampling import fold_in, plain_sample, random_bits_32

ROUTE = "cuda"
SOURCE = "src/repro_torch/csrc/sample.cu"
REPLACES = "src/repro/serve/engine.py:2027"

#: launches of the CUDA kernel
launches = 0

#: threads a block, and the most blocks a slot (the kernel's caps)
THREADS = 256
MAX_SPLITS = 64
_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p]


def splits_for(B: int, V: int) -> int:
    """Blocks a slot: enough for two blocks an SM over the batch, at least
    four logits a thread, at most :data:`MAX_SPLITS`."""
    return max(1, min(MAX_SPLITS, -(-2 * native.sm_count() // B), -(-V // (4 * THREADS))))


def sample(logits: torch.Tensor, keys: torch.Tensor, counts: torch.Tensor, live: torch.Tensor,
           tok: torch.Tensor, temperature: float, *, bits: torch.Tensor | None = None,
           splits: int | None = None) -> torch.Tensor:
    """Draw each live slot's token into ``tok`` in place: the plain version
    for CPU tensors, else the CUDA kernel.  ``logits`` f32 ``[B, V]``,
    ``keys`` int32 ``[B, 2]`` (each slot's uint32 key), ``counts`` (the token
    index t), ``live`` (nonzero: draw) and ``tok`` int32 ``[B]``;
    ``temperature`` > 0.  ``bits``, an int32 ``[B, V]``, receives each live
    slot's random bits (the check of the stream); ``splits`` overrides
    :func:`splits_for`."""
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
    stream = torch.cuda.current_stream(logits.device).cuda_stream
    ws = counters = None
    if splits > 1:
        ws = torch.empty(B * splits, dtype=torch.int64, device=logits.device)
        counters = native.tile_counters("sample", logits.device, stream, B)
    fn = native.function("sample", "repro_sample", _ARGTYPES)
    err = fn(native.ptr(logits), native.ptr(keys), native.ptr(counts), native.ptr(live),
             native.ptr(tok), native.ptr(bits), native.ptr(ws), native.ptr(counters), B, V,
             splits, float(temperature), ctypes.c_void_p(stream))
    native.raise_on_error("sample", err)
    native.count_launch(__name__)
    return tok
