"""JAX's position-indexed sampling stream, in PyTorch.

The JAX engine draws token ``t`` of request ``uid`` as
``categorical(fold_in(fold_in(PRNGKey(seed), uid), t), logits / T)``
(``repro/serve/engine.py`` ``_sample_token`` and ``_fused_decode_fn``), so a
request's stream depends only on (seed, uid, logits): never on admission
order or fusion depth.  This module computes the same stream with torch
tensors, as ``jax.random`` computes it with ``jax_threefry_partitionable``
on (JAX 0.9's default):

- :func:`threefry2x32`: the Threefry-2x32 hash, 20 rounds
  (``jax/_src/prng.py`` ``_threefry2x32_lowering``);
- :func:`fold_in`: ``threefry2x32(key, (0, data))``, the data as uint32;
- :func:`random_bits_32`: element ``i`` of a ``[n]`` draw is ``y0 ^ y1`` of
  ``threefry2x32(key, (0, i))`` (the 2x32 iota of the shape, high word 0);
- :func:`uniform`: the bits' top 23 as the mantissa of a float in [1, 2),
  less 1, scaled to ``[tiny, 1)``;
- :func:`gumbel`: ``-log(-log(u))`` (mode "low");
- :func:`categorical`: ``argmax(gumbel + logits / T)``, the first index on
  ties, as ``jnp.argmax``.

The uint32 arithmetic runs in int64 masked to 32 bits, so it gives JAX's
bits exactly on any device and inside a CUDA graph; only ``log`` may differ
from XLA's by an ulp.  :func:`plain_sample` is the function of the
``sample`` kernel (``csrc/sample.cu``, ``kernels/sample.py``) in plain
PyTorch: the CPU runs it, and the card holds the kernel against it.
"""

from __future__ import annotations

import numpy as np
import torch

MASK = 0xFFFFFFFF
#: the key schedule's parity constant
_PARITY = 0x1BD11BDA
#: rotations of the even and odd groups of four rounds
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
#: the smallest normal float32, the uniform's lower end
TINY = float(np.finfo(np.float32).tiny)


def _u32(x) -> torch.Tensor:
    """``x`` (an int, an int tensor or a uint32 numpy array) as int64 holding
    its uint32 value."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(x.astype(np.int64))
    t = torch.as_tensor(x)
    return t.to(torch.int64) & MASK


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k0, k1, x0, x1) -> tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 of the counts (x0, x1) under the key (k0, k1), every
    argument uint32 values in int64 tensors (broadcast together); the two
    output words, int64 in [0, 2^32)."""
    k0, k1, x0, x1 = (_u32(v) for v in (k0, k1, x0, x1))
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK
    return x0, x1


def prng_key(seed: int) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for ``0 <= seed < 2^32``: the words (0, seed)."""
    if not 0 <= seed <= MASK:
        raise ValueError(f"seed must be in [0, 2^32), got {seed}")
    return torch.tensor([0, seed], dtype=torch.int64)


def fold_in(key, data) -> torch.Tensor:
    """``jax.random.fold_in``: keys ``[..., 2]`` and data ``[...]`` (uint32
    values) -> keys ``[..., 2]``, int64."""
    key = _u32(key)
    data = _u32(data).to(key.device)
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data), data)
    return torch.stack((y0, y1), dim=-1)


def key_of(seed: int, uid: int) -> np.ndarray:
    """A request's key, ``fold_in(PRNGKey(seed), uid)``, as the engine keeps
    it: uint32 ``[2]`` on the host."""
    return fold_in(prng_key(seed), uid).numpy().astype(np.uint32)


def random_bits_32(keys, n: int) -> torch.Tensor:
    """``jax.random.bits(key, (n,), uint32)`` for each key of ``[..., 2]``:
    ``[..., n]`` int64 in [0, 2^32)."""
    keys = _u32(keys)
    i = torch.arange(n, dtype=torch.int64, device=keys.device)
    y0, y1 = threefry2x32(keys[..., 0, None], keys[..., 1, None], torch.zeros_like(i), i)
    return y0 ^ y1


def uniform(bits: torch.Tensor) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval=tiny, maxval=1)``
    from its 32 random bits: f32 in [tiny, 1)."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    # floats * (maxval - minval) + minval, then max(minval, .): maxval -
    # minval rounds to 1 in f32, so this is f + tiny, tiny at f == 0
    return torch.clamp_min(f * 1.0 + TINY, TINY)


def gumbel(keys, n: int) -> torch.Tensor:
    """``jax.random.gumbel(key, (n,))`` (mode "low") for each key: f32 ``[..., n]``."""
    return -torch.log(-torch.log(uniform(random_bits_32(keys, n))))


def scores(keys, counts, logits: torch.Tensor, temperature: float) -> torch.Tensor:
    """The Gumbel-perturbed scores the draw takes the argmax of: keys
    ``[B, 2]`` folded with ``counts`` ``[B]``, logits ``[B, V]`` f32 divided
    by ``temperature`` in f32 (a true division, as XLA's)."""
    sub = fold_in(_u32(keys).to(logits.device), _u32(counts).to(logits.device))
    temp = torch.tensor(temperature, dtype=torch.float32, device=logits.device)
    return gumbel(sub, logits.shape[-1]) + logits.float() / temp


def categorical(keys, counts, logits: torch.Tensor, temperature: float) -> torch.Tensor:
    """``jax.random.categorical(fold_in(key, count), logits / T)`` row by
    row: int64 ``[B]``, the first maximal index."""
    return torch.argmax(scores(keys, counts, logits, temperature), dim=-1)


def plain_sample(logits: torch.Tensor, keys: torch.Tensor, counts: torch.Tensor,
                 live: torch.Tensor, tok: torch.Tensor, temperature: float) -> torch.Tensor:
    """The ``sample`` kernel's function: ``tok[b]`` (int32, in place) becomes
    row b's draw where ``live[b]`` is nonzero, and stays where it is 0.
    ``keys`` int32 ``[B, 2]`` (uint32 bits), ``counts`` int32 ``[B]``."""
    drawn = categorical(keys, counts, logits, temperature).to(torch.int32)
    tok.copy_(torch.where(live != 0, drawn, tok))
    return tok
