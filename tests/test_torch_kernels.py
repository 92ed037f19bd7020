"""The port's kernel modules against the JAX package's Pallas kernels, on the CPU.

Each plain PyTorch version beside a hand-written Hopper kernel (the version a
wrapper runs for CPU tensors) takes the same inputs, made with numpy from a
seed, as the Pallas kernel run in interpret mode (as ``tests/test_kernels.py``
runs it).  The torch eager sources are held to the JAX ``xla`` sources the
same way.

Tolerances: 2e-2 absolute and relative for bf16 data (about two bf16
rounding steps of the O(1) values used: the two sides round intermediate
results at different places); 1e-4 for f32 data, where only the order of f32
sums differs.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels  # noqa: F401  (registration)
from repro.kernels import ops as jops
from repro.kernels.decode_attention import decode_attention as pallas_decode_attention
from repro.kernels import ref as jref
from repro.kernels.decode_attention import paged_decode_attention as pallas_paged_decode_attention
from repro.kernels.flash_attention import flash_attention as pallas_flash_attention
from repro.kernels.rmsnorm import rmsnorm as pallas_rmsnorm
from repro_torch.kernels import decode_attention as dec_k
from repro_torch.kernels import flash_attention as fa_k
from repro_torch.kernels import matmul as mm_k
from repro_torch.kernels import ops as tops
from repro_torch.kernels import paged_decode_attention as paged_k
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rmsnorm as rms_k

RNG = np.random.default_rng(2024)
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _tol(dtype: str) -> dict:
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bf16" else dict(rtol=1e-4, atol=1e-4)


def _pair(shape, dtype: str, scale: float = 1.0):
    """The same values as a JAX array and a CPU torch tensor."""
    a = (RNG.normal(size=shape) * scale).astype(np.float32)
    jd, td = DTYPES[dtype]
    return jnp.asarray(a, jd), torch.from_numpy(a).to(td)


def _check(got: torch.Tensor, want, dtype: str) -> None:
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **_tol(dtype))


# ---------------------------------------------------------------------------
# matmul
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("out", [None, "f32"])
@pytest.mark.parametrize("activation", [None, "silu", "gelu"])
@pytest.mark.parametrize("lead,k,n", [((8,), 64, 32), ((6,), 64, 48), ((2, 3), 32, 16)])
def test_matmul_plain_matches_pallas(dtype, out, activation, lead, k, n):
    """Ragged M (6 rows, 2x3 leading dims), silu/gelu epilogues, f32 and
    input-dtype outputs."""
    (xj, xt), (wj, wt) = _pair((*lead, k), dtype), _pair((k, n), dtype, scale=k ** -0.5)
    got = mm_k.matmul(xt, wt, activation=activation,
                      out_dtype=torch.float32 if out else None)
    want = jops.pallas_matmul(xj, wj, activation=activation,
                              out_dtype=jnp.float32 if out else None, interpret=True)
    assert got.dtype == (torch.float32 if out else DTYPES[dtype][1])
    _check(got, want, "bf16" if dtype == "bf16" and not out else "f32")


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("out", [None, "f32"])
@pytest.mark.parametrize("activation", [None, "silu"])
@pytest.mark.parametrize("m,k,n", [(8, 36, 49), (6, 100, 131), (3, 64, 517)])
def test_matmul_plain_matches_pallas_at_any_k_and_n(dtype, out, activation, m, k, n):
    """K and N not multiples of 8 (the edge kernel's shapes on the card):
    ``pallas_matmul`` falls back to a single block there, and the plain
    version takes them as they are."""
    (xj, xt), (wj, wt) = _pair((m, k), dtype), _pair((k, n), dtype, scale=k ** -0.5)
    got = mm_k.matmul(xt, wt, activation=activation,
                      out_dtype=torch.float32 if out else None)
    want = jops.pallas_matmul(xj, wj, activation=activation,
                              out_dtype=jnp.float32 if out else None, interpret=True)
    assert got.shape == (m, n)
    _check(got, want, "bf16" if dtype == "bf16" and not out else "f32")


@pytest.mark.parametrize("activation", [None, "silu"])
def test_matmul_torch_source_matches_xla(activation):
    (xj, xt), (wj, wt) = _pair((8, 64), "bf16"), _pair((64, 32), "bf16", scale=0.125)
    _check(tops.torch_matmul(xt, wt, activation=activation),
           jops.xla_matmul(xj, wj, activation=activation), "bf16")


# ---------------------------------------------------------------------------
# rmsnorm
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", [(8, 128), (3, 5, 64)])
def test_rmsnorm_plain_matches_pallas(dtype, shape):
    (xj, xt), (wj, wt) = _pair(shape, dtype), _pair(shape[-1:], dtype)
    _check(rms_k.rmsnorm(xt, wt), pallas_rmsnorm(xj, wj, block_rows=8, interpret=True), dtype)


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("hq,hkv,s,t,causal,window", [
    (4, 4, 64, 64, True, None),
    (4, 2, 64, 64, False, None),       # non-causal, GQA
    (8, 1, 64, 64, True, None),        # GQA, one kv head
    (2, 2, 128, 128, True, 48),        # sliding window
    (4, 2, 32, 128, True, None),       # S < T: queries at the kv tail
])
def test_flash_attention_plain_matches_pallas(dtype, hq, hkv, s, t, causal, window):
    (qj, qt) = _pair((2, hq, s, 32), dtype)
    (kj, kt), (vj, vt) = _pair((2, hkv, t, 32), dtype), _pair((2, hkv, t, 32), dtype)
    got = fa_k.flash_attention(qt, kt, vt, causal=causal, window=window)
    want = pallas_flash_attention(qj, kj, vj, causal=causal, window=window,
                                  block_q=32, block_k=32, interpret=True)
    _check(got, want, dtype)


@pytest.mark.parametrize("hq,hkv,s,t,causal,window", [
    (4, 2, 64, 64, True, None),
    (4, 2, 64, 64, False, None),       # non-causal
    (2, 1, 128, 128, True, 48),        # sliding window
    (4, 1, 32, 128, True, None),       # S < T: queries at the kv tail
])
def test_flash_attention_plain_matches_pallas_at_head_dim_128(hq, hkv, s, t, causal, window):
    """head_dim 128, the width of yi's, granite's and internvl2's heads."""
    (qj, qt) = _pair((1, hq, s, 128), "bf16")
    (kj, kt), (vj, vt) = _pair((1, hkv, t, 128), "bf16"), _pair((1, hkv, t, 128), "bf16")
    got = fa_k.flash_attention(qt, kt, vt, causal=causal, window=window)
    want = pallas_flash_attention(qj, kj, vj, causal=causal, window=window,
                                  block_q=32, block_k=32, interpret=True)
    _check(got, want, "bf16")


@pytest.mark.parametrize("kw", [dict(causal=True), dict(causal=False),
                                dict(causal=True, window=24)])
def test_flash_attention_torch_source_matches_xla(kw):
    (qj, qt) = _pair((1, 4, 64, 16), "bf16")
    (kj, kt), (vj, vt) = _pair((1, 2, 64, 16), "bf16"), _pair((1, 2, 64, 16), "bf16")
    _check(tops.torch_flash_attention(qt, kt, vt, block_q=32, **kw),
           jops.xla_flash_attention(qj, kj, vj, block_q=32, **kw), "bf16")


# ---------------------------------------------------------------------------
# decode attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("length", [37, [1, 64, 17]])
def test_decode_attention_plain_matches_pallas(dtype, length):
    """Scalar and per-slot lengths (1 and the full cache included), GQA 8/2."""
    (qj, qt) = _pair((3, 8, 32), dtype)
    (kj, kt), (vj, vt) = _pair((3, 2, 64, 32), dtype), _pair((3, 2, 64, 32), dtype)
    lj = jnp.asarray(length, jnp.int32)
    lt = torch.tensor(length, dtype=torch.int32)
    got = dec_k.decode_attention(qt, kt, vt, lt)
    want = pallas_decode_attention(qj, kj, vj, lj, block_k=16, interpret=True)
    _check(got, want, dtype)


@pytest.mark.parametrize("length", [37, [1, 64, 17]])
def test_decode_attention_plain_matches_pallas_at_head_dim_128(length):
    """head_dim 128 with yi's group of 8 query heads a kv head."""
    (qj, qt) = _pair((3, 16, 128), "bf16")
    (kj, kt), (vj, vt) = _pair((3, 2, 64, 128), "bf16"), _pair((3, 2, 64, 128), "bf16")
    got = dec_k.decode_attention(qt, kt, vt, torch.tensor(length, dtype=torch.int32))
    want = pallas_decode_attention(qj, kj, vj, jnp.asarray(length, jnp.int32), block_k=16,
                                   interpret=True)
    _check(got, want, "bf16")


@pytest.mark.parametrize("length", [37, [1, 64, 17]])
def test_decode_attention_torch_source_matches_xla(length):
    (qj, qt) = _pair((3, 8, 32), "bf16")
    (kj, kt), (vj, vt) = _pair((3, 2, 64, 32), "bf16"), _pair((3, 2, 64, 32), "bf16")
    _check(tops.torch_decode_attention(qt, kt, vt, torch.tensor(length, dtype=torch.int32)),
           jops.xla_decode_attention(qj, kj, vj, jnp.asarray(length, jnp.int32)), "bf16")


# ---------------------------------------------------------------------------
# paged decode attention
# ---------------------------------------------------------------------------


def _paged_case(B, hq, hkv, ps, n_pages, dtype, length, seed=0, hd=32):
    """q, a random pool with page 0 left as scratch, disjoint shuffled
    per-sequence tables and lengths (scalar, or per slot from 1 to the whole
    table) — each as a JAX array and a CPU torch tensor."""
    rng = np.random.default_rng(seed)
    pool_pages = B * n_pages + 3
    q = _pair((B, hq, hd), dtype)
    kp = _pair((pool_pages, hkv, ps, hd), dtype)
    vp = _pair((pool_pages, hkv, ps, hd), dtype)
    table = rng.permutation(np.arange(1, pool_pages))[: B * n_pages].reshape(B, n_pages)
    table = table.astype(np.int32)
    if length == "per_slot":
        lengths = rng.integers(1, n_pages * ps + 1, size=B).astype(np.int32)
        lengths[0] = n_pages * ps
    else:
        lengths = np.int32(n_pages * ps // 2 + 3)
    return (q, kp, vp, (jnp.asarray(table), torch.from_numpy(table)),
            (jnp.asarray(lengths), torch.tensor(lengths)))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("length", ["scalar", "per_slot"])
@pytest.mark.parametrize("hq,hkv,ps,n_pages", [(8, 2, 16, 4), (8, 1, 8, 8), (4, 4, 16, 2)])
def test_paged_decode_attention_plain_matches_pallas(dtype, length, hq, hkv, ps, n_pages):
    """Page sizes 8 and 16 over shuffled tables, against the Pallas kernel
    run in interpret mode as ``tests/test_kernels.py`` runs it."""
    (qj, qt), (kj, kt), (vj, vt), (tj, tt), (lj, lt) = _paged_case(
        3, hq, hkv, ps, n_pages, dtype, length)
    got = paged_k.paged_decode_attention(qt, kt, vt, tt, lt)
    want = pallas_paged_decode_attention(qj, kj, vj, tj, lj, interpret=True)
    _check(got, want, dtype)


@pytest.mark.parametrize("length", ["scalar", "per_slot"])
@pytest.mark.parametrize("ps,n_pages", [(16, 4), (64, 1), (8, 8)])
def test_paged_decode_attention_plain_matches_pallas_at_head_dim_128(length, ps, n_pages):
    """head_dim 128 over page sizes 8, 16 and 64, and bit for bit the plain
    dense version over the gathered cache."""
    (qj, qt), (kj, kt), (vj, vt), (tj, tt), (lj, lt) = _paged_case(
        3, 8, 1, ps, n_pages, "bf16", length, seed=3, hd=128)
    got = paged_k.paged_decode_attention(qt, kt, vt, tt, lt)
    _check(got, pallas_paged_decode_attention(qj, kj, vj, tj, lj, interpret=True), "bf16")
    dense = dec_k.plain_decode_attention(qt, tref.gather_kv_pages(kt, tt),
                                         tref.gather_kv_pages(vt, tt), lt)
    assert torch.equal(got, dense)


@pytest.mark.parametrize("ps", [8, 16])
def test_paged_plain_equals_dense_plain_on_gathered_cache(ps):
    """The plain paged version is the plain dense version on the gathered
    cache, bit for bit; the gather is the JAX gather, element for element."""
    (qj, qt), (kj, kt), (vj, vt), (tj, tt), (lj, lt) = _paged_case(
        3, 8, 2, ps, 64 // ps, "bf16", "per_slot", seed=1)
    kg = tref.gather_kv_pages(kt, tt)
    np.testing.assert_array_equal(kg.float().numpy(),
                                  np.asarray(jref.gather_kv_pages(kj, tj), np.float32))
    got = paged_k.plain_paged_decode_attention(qt, kt, vt, tt, lt)
    want = dec_k.plain_decode_attention(qt, kg, tref.gather_kv_pages(vt, tt), lt)
    assert torch.equal(got, want)


@pytest.mark.parametrize("length", ["scalar", "per_slot"])
def test_paged_torch_source_matches_xla_and_equals_dense(length):
    """The torch eager source against ``xla_paged_decode_attention``, and
    bit for bit the dense torch source over the gathered cache — the
    property the paged engine's equality with the dense one rests on."""
    (qj, qt), (kj, kt), (vj, vt), (tj, tt), (lj, lt) = _paged_case(
        3, 8, 2, 16, 4, "bf16", length, seed=2)
    got = tops.torch_paged_decode_attention(qt, kt, vt, tt, lt)
    _check(got, jops.xla_paged_decode_attention(qj, kj, vj, tj, lj), "bf16")
    dense = tops.torch_decode_attention(qt, tref.gather_kv_pages(kt, tt),
                                        tref.gather_kv_pages(vt, tt), lt)
    assert torch.equal(got, dense)
    _check(tref.paged_decode_attention(qt, kt, vt, tt, lt),
           jref.paged_decode_attention(qj, kj, vj, tj, lj), "bf16")


# ---------------------------------------------------------------------------
# wrappers: the plain version only for CPU tensors, never a fallback
# ---------------------------------------------------------------------------


def test_wrappers_use_plain_version_on_cpu_without_counting():
    mods = (mm_k, rms_k, fa_k, dec_k, paged_k)
    counts = [m.launches for m in mods]
    x = torch.ones(4, 64, dtype=torch.bfloat16)
    mm_k.matmul(x, torch.ones(64, 64, dtype=torch.bfloat16))
    rms_k.rmsnorm(x, torch.ones(64, dtype=torch.bfloat16))
    q = torch.ones(1, 2, 8, 64, dtype=torch.bfloat16)
    fa_k.flash_attention(q, q, q)
    dec_k.decode_attention(q[:, :, 0], q, q, 3)
    paged_k.paged_decode_attention(q[:, :, 0], q, q, torch.zeros(1, 1, dtype=torch.int32), 3)
    assert [m.launches for m in mods] == counts


def test_paged_plain_refuses_a_page_outside_the_pool():
    """A table entry inside the length that names no pool page is a corrupt
    table: the plain version's gather raises (the kernel masks the page's
    rows, ``tests/test_torch_cuda.py``); it never reads it as zeros."""
    q = torch.ones(1, 2, 64, dtype=torch.bfloat16)
    pool = torch.ones(3, 2, 8, 64, dtype=torch.bfloat16)
    table = torch.tensor([[1, 7]], dtype=torch.int32)               # page 7 of 3
    with pytest.raises(IndexError):
        paged_k.paged_decode_attention(q, pool, pool, table, 12)


@pytest.mark.parametrize("call", [
    lambda t: mm_k.matmul(t((4, 64)), t((64, 64))),
    lambda t: rms_k.rmsnorm(t((4, 64)), t((64,))),
    lambda t: fa_k.flash_attention(t((1, 2, 8, 64)), t((1, 2, 8, 64)), t((1, 2, 8, 64))),
    lambda t: dec_k.decode_attention(t((1, 2, 64)), t((1, 2, 8, 64)), t((1, 2, 8, 64)), 3),
    lambda t: paged_k.paged_decode_attention(t((1, 2, 64)), t((3, 2, 8, 64)), t((3, 2, 8, 64)),
                                             torch.ones(1, 2, dtype=torch.int32, device="meta"),
                                             3),
])
def test_wrappers_raise_off_cpu_without_cuda(call):
    """A tensor that is not on the CPU goes to the kernel path, which takes
    only CUDA tensors: it raises, it never falls back to the plain version."""
    with pytest.raises(ValueError, match="CUDA"):
        call(lambda shape: torch.empty(shape, dtype=torch.bfloat16, device="meta"))
    with pytest.raises(ValueError, match="mixed devices"):
        mm_k.matmul(torch.ones(4, 64, dtype=torch.bfloat16),
                    torch.empty(64, 64, dtype=torch.bfloat16, device="meta"))
