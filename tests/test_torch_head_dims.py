"""The attention kernels' head dims: every multiple of 16 up to 128, on the CPU.

The plain versions (what the wrappers run for CPU tensors) at head_dim 32
and 96 against the JAX package's Pallas kernels in interpret mode, as
``tests/test_torch_kernels.py`` holds them at 64 and 128; the rule the CUDA
wrappers apply to a head dim (taken, or refused with its value named); and
the flash kernel's instance and split for a head dim between the two
instances.  Tolerances as in ``tests/test_torch_kernels.py``: 2e-2 for bf16
data.  The JAX package is only the reference here.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels  # noqa: F401  (registration)
from repro.kernels.decode_attention import decode_attention as pallas_decode_attention
from repro.kernels.decode_attention import paged_decode_attention as pallas_paged_decode_attention
from repro.kernels.flash_attention import flash_attention as pallas_flash_attention
from repro_torch.kernels import decode_attention as dec_k
from repro_torch.kernels import flash_attention as fa_k
from repro_torch.kernels import paged_decode_attention as paged_k
from repro_torch.kernels import ref as tref

TOL = dict(rtol=2e-2, atol=2e-2)


def _pair(rng, shape):
    """The same bf16 values as a JAX array and a CPU torch tensor."""
    a = rng.normal(size=shape).astype(np.float32)
    return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).to(torch.bfloat16)


def _check(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **TOL)


@pytest.mark.parametrize("d", [32, 96])
@pytest.mark.parametrize("hq,hkv,s,t,causal,window", [
    (4, 2, 64, 64, True, None),
    (4, 2, 64, 64, False, None),       # non-causal
    (2, 1, 128, 128, True, 48),        # sliding window
    (4, 1, 32, 128, True, None),       # S < T: queries at the kv tail
])
def test_flash_attention_plain_matches_pallas_at_head_dims_32_and_96(hq, hkv, s, t, causal,
                                                                     window, d):
    rng = np.random.default_rng(d + s + t)
    qj, qt = _pair(rng, (1, hq, s, d))
    (kj, kt), (vj, vt) = _pair(rng, (1, hkv, t, d)), _pair(rng, (1, hkv, t, d))
    got = fa_k.flash_attention(qt, kt, vt, causal=causal, window=window)
    _check(got, pallas_flash_attention(qj, kj, vj, causal=causal, window=window,
                                       block_q=32, block_k=32, interpret=True))


@pytest.mark.parametrize("d", [32, 96])
@pytest.mark.parametrize("length", [37, [1, 64, 17]])
def test_decode_attention_plain_matches_pallas_at_head_dims_32_and_96(length, d):
    rng = np.random.default_rng(d)
    qj, qt = _pair(rng, (3, 8, d))
    (kj, kt), (vj, vt) = _pair(rng, (3, 2, 64, d)), _pair(rng, (3, 2, 64, d))
    got = dec_k.decode_attention(qt, kt, vt, torch.tensor(length, dtype=torch.int32))
    _check(got, pallas_decode_attention(qj, kj, vj, jnp.asarray(length, jnp.int32), block_k=16,
                                        interpret=True))


@pytest.mark.parametrize("d", [32, 96])
@pytest.mark.parametrize("ps,n_pages", [(16, 4), (8, 8)])
def test_paged_attention_plain_matches_pallas_and_dense_at_head_dims_32_and_96(ps, n_pages, d):
    """Over a shuffled table, against the Pallas kernel, and bit for bit the
    plain dense version on the gathered cache."""
    rng = np.random.default_rng(d + ps)
    B, hkv, pool = 3, 2, 3 * n_pages + 3
    qj, qt = _pair(rng, (B, 8, d))
    (kj, kt), (vj, vt) = _pair(rng, (pool, hkv, ps, d)), _pair(rng, (pool, hkv, ps, d))
    table = rng.permutation(np.arange(1, pool))[: B * n_pages].reshape(B, n_pages)
    table = table.astype(np.int32)
    lengths = rng.integers(1, n_pages * ps + 1, size=B).astype(np.int32)
    tt, lt = torch.from_numpy(table), torch.from_numpy(lengths)
    got = paged_k.paged_decode_attention(qt, kt, vt, tt, lt)
    _check(got, pallas_paged_decode_attention(qj, kj, vj, jnp.asarray(table),
                                              jnp.asarray(lengths), interpret=True))
    dense = dec_k.plain_decode_attention(qt, tref.gather_kv_pages(kt, tt),
                                         tref.gather_kv_pages(vt, tt), lt)
    assert torch.equal(got, dense)


@pytest.mark.parametrize("d", list(range(8, 257, 8)))
def test_head_dim_rule_takes_multiples_of_16_to_128_and_names_the_rest(d):
    """check_head_dim, which all three CUDA wrappers apply: multiples of 16
    from 16 to 128 pass; any other head dim raises with its value named."""
    if d % 16 == 0 and d <= 128:
        fa_k.check_head_dim("flash_attention", d)
        assert d in fa_k.HEAD_DIMS
    else:
        with pytest.raises(ValueError, match=f"head_dim {d} "):
            fa_k.check_head_dim("decode_attention", d)


@pytest.mark.parametrize("d", fa_k.HEAD_DIMS)
def test_flash_instance_and_split_for_every_head_dim(d):
    """A head dim runs on the instance at or above it (64 or 128), and the
    split rule reads that instance's key tile."""
    inst = fa_k.instance(d)
    assert inst == (64 if d <= 64 else 128) and inst >= d
    for S, T in ((128, 1024), (512, 512), (64, 2048)):
        assert fa_k.split_kv(1, 32, S, T, True, head_dim=d) == fa_k.split_kv(
            1, 32, S, T, True, head_dim=inst)
