"""The port's kernel modules against the JAX package's Pallas kernels, on the CPU.

Each plain PyTorch version beside a hand-written Hopper kernel (the version a
wrapper runs for CPU tensors) takes the same inputs, made with numpy from a
seed, as the Pallas kernel run in interpret mode (as ``tests/test_kernels.py``
runs it).  The torch eager sources are held to the JAX ``xla`` sources the
same way.

Tolerances: 2e-2 absolute and relative for bf16 data (about two bf16
rounding steps of the O(1) values used: the two sides round intermediate
results at different places), and for f16 data (finer steps, the same
limit); 1e-4 for f32 data, where only the order of f32 sums differs.
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
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16),
          "f16": (jnp.float16, torch.float16)}


def _tol(dtype: str) -> dict:
    return dict(rtol=1e-4, atol=1e-4) if dtype == "f32" else dict(rtol=2e-2, atol=2e-2)


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


@pytest.mark.parametrize("activation", ["silu", "gelu"])
@pytest.mark.parametrize("m", [17, 129, 200])
def test_matmul_plain_matches_jax_at_the_edge_tile_shapes(m, activation):
    """The edge tile kernel's shapes (M above 16: ragged against its 128-row
    tiles, K = 1601 and N = 131 not multiples of 8): the plain version, bf16
    in and out, against the JAX reference in both epilogues."""
    k, n = 1601, 131
    (xj, xt), (wj, wt) = _pair((m, k), "bf16"), _pair((k, n), "bf16", scale=k ** -0.5)
    got = mm_k.matmul(xt, wt, activation=activation)
    assert got.shape == (m, n) and got.dtype == torch.bfloat16
    _check(got, jref.matmul(xj, wj, activation=activation), "bf16")


@pytest.mark.parametrize("activation", [None, "silu"])
def test_matmul_torch_source_matches_xla(activation):
    (xj, xt), (wj, wt) = _pair((8, 64), "bf16"), _pair((64, 32), "bf16", scale=0.125)
    _check(tops.torch_matmul(xt, wt, activation=activation),
           jops.xla_matmul(xj, wj, activation=activation), "bf16")


# ---------------------------------------------------------------------------
# rmsnorm
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["f32", "bf16", "f16"])
@pytest.mark.parametrize("shape", [(8, 128), (3, 5, 64), (4, 100), (3, 5, 36), (2, 1000)])
def test_rmsnorm_plain_matches_pallas(dtype, shape):
    """Any D, as the Pallas kernel takes (the CUDA kernel's ragged last
    chunk: D not a multiple of 8), and every float dtype the kernel takes."""
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


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("chunk", [16, 64, 128])
def test_flash_key_groups_of_a_row_are_the_same_in_every_launch(chunk, d):
    """A query row at position p folds the key groups that hold keys 0..p,
    in key order: the groups of a chunk's launch (keys up to the chunk's
    end) cut to p are the whole 1024-row prompt's cut to p, for every row of
    every chunk; no key tile straddles two groups."""
    def seen(groups, p):
        return [(k0, min(k1, p + 1)) for k0, k1 in groups if k0 <= p]

    whole = fa_k.key_groups(1024, d)
    assert whole == ((0, 512), (512, 1024))
    for start in range(0, 1024, chunk):
        groups = fa_k.key_groups(start + chunk, d)
        for p in range(start, start + chunk):
            assert seen(groups, p) == seen(whole, p), (start, p)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("s,t,causal", [(1024, 1024, True), (128, 1024, True), (16, 528, True),
                                        (64, 2048, False), (100, 1200, True)])
def test_flash_splits_deal_each_group_to_one_block_in_order(s, t, causal, d):
    """At every split count, each q tile's key groups are dealt whole, in
    order, each to exactly one split block: the merge folds the same groups
    an unsplit block folds on its walk."""
    unsplit = fa_k.split_groups(s, t, 1, causal, head_dim=d)
    for splits in range(1, fa_k.MAX_SPLITS + 1):
        for tile, blocks in zip(unsplit, fa_k.split_groups(s, t, splits, causal, head_dim=d)):
            assert [g for block in blocks for g in block] == tile[0]
            assert len(blocks) == splits


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


def _split_lengths(T: int, splits: int) -> list[int]:
    """Lengths 1 and T, and on, before and after each inner split boundary."""
    bounds = [lo for lo, _ in dec_k.split_ranges(T, splits)[1:]]
    return [1, T] + [n for lo in bounds for n in (lo, lo - 1, lo + 1)]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("splits", [1, 2, 3, 8])
def test_split_decode_plain_matches_unsplit_and_pallas(splits, dtype):
    """The kernel's split-and-merge in plain PyTorch over a 256-row cache (8
    tiles), lengths on and off the split boundaries: the unsplit plain
    version's function (1e-4 in f32: the merge reorders f32 sums; bf16
    outputs as above) and the Pallas kernel's in interpret mode."""
    T = 256
    lengths = _split_lengths(T, splits)
    B = len(lengths)
    (qj, qt) = _pair((B, 8, 32), dtype)
    (kj, kt), (vj, vt) = _pair((B, 2, T, 32), dtype), _pair((B, 2, T, 32), dtype)
    lt = torch.tensor(lengths, dtype=torch.int32)
    got = dec_k.plain_split_decode_attention(qt, kt, vt, lt, splits)
    _check(got, dec_k.plain_decode_attention(qt, kt, vt, lt).float().numpy(), dtype)
    want = pallas_decode_attention(qj, kj, vj, jnp.asarray(lengths, jnp.int32), block_k=32,
                                   interpret=True)
    _check(got, want, dtype)


def test_split_ranges_deal_whole_tiles_and_cover_the_cache():
    """Each split a run of whole 32-key tiles, in order, covering [0, T);
    the split rule picks from the cache's rows alone (never the batch, so
    a row rounds alike in an 8-slot and a 16-slot launch) and never leaves
    a split empty of the cache."""
    for T in (1, 31, 32, 45, 600, 608, 1024, 4096):
        for splits in range(1, -(-T // 32) + 1):
            ranges = dec_k.split_ranges(T, splits)
            assert ranges[0][0] == 0 and ranges[-1][1] == T
            assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
            assert all(lo % 32 == 0 for lo, hi in ranges if hi > lo)
    for T in (1, 48, 256, 300, 512, 600, 608, 1024, 4096):
        splits = dec_k.split_kv(T)
        assert 1 <= splits <= dec_k.MAX_SPLITS
        assert all(hi > lo for lo, hi in dec_k.split_ranges(T, splits))
    # eight tiles a split (two a warp) up to MAX_SPLITS: llama's 1024-row
    # steps four, granite's 512 two, a 600-row fixup three
    assert dec_k.split_kv(1024) == 4 and dec_k.split_kv(512) == 2 and dec_k.split_kv(600) == 3
    assert dec_k.split_kv(48) == dec_k.split_kv(256) == 1 and dec_k.split_kv(300) == 2
    assert dec_k.split_kv(4096) == dec_k.MAX_SPLITS


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


@pytest.mark.parametrize("splits", [1, 2, 3, 8])
@pytest.mark.parametrize("ps", [8, 16])
def test_paged_split_plain_matches_pallas_and_equals_dense_split(splits, ps):
    """The paged split plain version against the Pallas paged kernel in
    interpret mode, and bit for bit the dense split plain version on the
    gathered cache at the same splits (8 tiles of 32 keys)."""
    (qj, qt), (kj, kt), (vj, vt), (tj, tt), (lj, lt) = _paged_case(
        3, 8, 2, ps, 256 // ps, "bf16", "per_slot", seed=4)
    got = paged_k.plain_split_paged_decode_attention(qt, kt, vt, tt, lt, splits)
    _check(got, pallas_paged_decode_attention(qj, kj, vj, tj, lj, interpret=True), "bf16")
    dense = dec_k.plain_split_decode_attention(qt, tref.gather_kv_pages(kt, tt),
                                               tref.gather_kv_pages(vt, tt), lt, splits)
    assert torch.equal(got, dense)


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


def test_rmsnorm_wrapper_runs_f64_through_its_plain_version_on_the_cpu():
    """float64 is an instance of the CUDA kernel's element template (C code
    3); on CPU tensors the wrapper runs the plain version, which keeps x's
    dtype and takes f32 statistics, as the kernel reads f64 elements as
    f32.  Counted nowhere."""
    assert rms_k._DTYPES[torch.float64] == 3
    g = torch.Generator().manual_seed(3)
    x = torch.randn((5, 300), generator=g, dtype=torch.float64)
    w = torch.randn((300,), generator=g, dtype=torch.float64)
    before = rms_k.launches
    got = rms_k.rmsnorm(x, w)
    assert got.dtype == torch.float64 and rms_k.launches == before
    assert torch.equal(got, rms_k.plain_rmsnorm(x, w))
    xn, wn = x.numpy(), w.numpy()
    want = xn / np.sqrt(np.mean(xn * xn, axis=-1, keepdims=True) + 1e-6) * wn
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-6, atol=2e-6)


def test_conv2d_stages_a_filter_past_one_slab_in_row_chunks_on_the_rule():
    """The wrapper's shared-memory rule, as the kernel computes it: a
    filter whose one-channel slab would pass 227 KB beside the input ring
    is staged in slabs of the rows that fit (68x68 of eight f32 filters:
    two slabs of 66 and 2 rows); the roles keep one slab; a filter whose
    input tile and one filter row pass 227 KB stages its input rows with
    each slab (200x200 f32: two slabs of 116 and 84 rows, one 231 KB slot);
    only a filter whose 16 output rows' input and one filter row pass 227 KB
    is refused.  On CPU tensors the wrapper runs the plain version, here at
    a 68x68 filter against a float64 ``F.conv2d``."""
    from repro_torch.kernels import conv2d as conv_k

    assert conv_k.filter_rows(68, 68, 8, 4) == 66 and conv_k.slab_rows(68, 68, 8, 4) == 0
    cc, nbytes = conv_k._smem(1, 68, 68, 8, 4)
    assert cc == 1 and nbytes <= 227 * 1024
    assert conv_k.filter_rows(5, 5, 1, 2) == 5 and conv_k._smem(1, 5, 5, 1, 2)[0] == 1
    assert conv_k.filter_rows(200, 200, 1, 4) == 0 and conv_k.slab_rows(200, 200, 1, 4) == 116
    cc, slab_bytes = conv_k._smem(1, 200, 200, 1, 4)
    assert cc == 1 and slab_bytes == (16 + 115) * 1056 + 116 * 200 * 4 <= 227 * 1024
    assert conv_k.slab_rows(240, 240, 2, 2) == 88
    assert conv_k._smem(1, 1, 4000, 1, 4)[0] == 0 and conv_k.slab_rows(1, 4000, 1, 4) == 0
    assert conv_k.footprint(1, 68, 68, 8, 4).smem_bytes == nbytes
    g = torch.Generator().manual_seed(4)
    x = torch.randn((1, 70, 71, 1), generator=g)
    w = torch.randn((68, 68, 1, 8), generator=g)
    got = conv_k.conv2d(x, w)
    want = torch.nn.functional.conv2d(x.double().permute(0, 3, 1, 2),
                                      w.double().permute(3, 2, 0, 1)).permute(0, 2, 3, 1)
    assert got.shape == (1, 3, 4, 8) and got.dtype == torch.float32
    torch.testing.assert_close(got.double(), want, atol=2e-3, rtol=2e-4)


@pytest.mark.parametrize("itemsize", [2, 4])
def test_conv2d_rule_routes_every_filter_to_a_mode_that_fits(itemsize):
    """Over filters of 1..400 rows and 1..1200 columns and 1..9 filters,
    the wrapper's rule picks, as the kernel does, the ring with the whole
    filter, the ring with filter slabs (:func:`filter_rows` rows a slab), or
    one slot of input rows with each slab (:func:`slab_rows`), each within
    227 KB of shared memory; it refuses only a filter whose 16 output
    rows' input and one filter row pass that."""
    from repro_torch.kernels import conv2d as conv_k

    modes = set()
    for kh in (1, 3, 30, 68, 120, 200, 260, 400):
        for kw in (1, 5, 68, 200, 600, 1200):
            for f in (1, 2, 5, 9):
                cc, nbytes = conv_k._smem(1, kh, kw, f, itemsize)
                rows, slabs = conv_k.filter_rows(kh, kw, f, itemsize), conv_k.slab_rows(
                    kh, kw, f, itemsize)
                if cc == 0:
                    assert rows == slabs == 0
                    assert conv_k._slab_bytes(1, kw, f, itemsize) > 227 * 1024
                    continue
                assert nbytes <= 227 * 1024
                mode = "whole" if rows == kh else "filter slabs" if rows else "input slabs"
                assert (slabs > 0) == (mode == "input slabs")
                modes.add(mode)
    assert modes == {"whole", "filter slabs", "input slabs"}
