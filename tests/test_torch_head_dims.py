"""The attention kernels' head dims and query groups, on the CPU.

The plain versions (what the wrappers run for CPU tensors) at head_dim 32
and 96 against the JAX package's Pallas kernels in interpret mode, as
``tests/test_torch_kernels.py`` holds them at 64 and 128; the rule the CUDA
wrappers apply to a head dim (taken, or refused with its value named); and
the flash kernel's instance and split for a head dim between the two
instances; and the wrappers' routing of what the kernels alone do not take
(widths off a multiple of 16, values past 128, query groups past 16,
rmsnorm in other float types), each launch's shapes checked and the result
held to one call and to the Pallas kernels.  Tolerances as in
``tests/test_torch_kernels.py``: 2e-2 for bf16 data.  The JAX package is
only the reference here.
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
    """check_head_dim, which the decode wrappers apply: every head dim up to
    128 passes, run at its width padded to a multiple of 16 (one of the
    kernel's instances, :data:`HEAD_DIMS`); any larger one raises with its
    value named.  Flash attention's rule takes query and key widths up to
    256 and any value width."""
    if d <= 128:
        fa_k.check_head_dim("decode_attention", d)
        assert fa_k.padded_width(d) in fa_k.HEAD_DIMS and fa_k.padded_width(d) - d in (0, 8)
    else:
        with pytest.raises(ValueError, match=f"head_dim {d} "):
            fa_k.check_head_dim("decode_attention", d)
    fa_k.check_head_dims("flash_attention", d, d)
    assert fa_k.padded_width(d) in fa_k.QK_DIMS


@pytest.mark.parametrize("d", fa_k.HEAD_DIMS)
def test_flash_instance_and_split_for_every_head_dim(d):
    """A head dim runs on the instance at or above it (64 or 128), and the
    split rule reads that instance's key tile."""
    inst = fa_k.instance(d)
    assert inst == (64 if d <= 64 else 128) and inst >= d
    for S, T in ((128, 1024), (512, 512), (64, 2048)):
        assert fa_k.split_kv(1, 32, S, T, True, head_dim=d) == fa_k.split_kv(
            1, 32, S, T, True, head_dim=inst)


# ---------------------------------------------------------------------------
# the widths and groups the kernels alone do not take, routed by the wrappers
# ---------------------------------------------------------------------------


def _recording(launch, seen):
    """``launch`` that first records each call's widths and contiguity."""
    def call(*args):
        seen.append(tuple((tuple(a.shape), a.is_contiguous()) for a in args))
        return launch(*args)
    return call


@pytest.mark.parametrize("dqk,dv", [(40, 40), (100, 100), (72, 136), (208, 128), (256, 256),
                                    (64, 200), (200, 200), (192, 320)])
def test_flash_by_width_runs_launch_widths_and_equals_one_call(dqk, dv):
    """``flash_attention.by_width`` (what the CUDA wrapper launches through):
    every launch at widths a kernel instance takes (multiples of 16, queries
    and keys to 256, values to 128, contiguous), one a 128-wide value block,
    and the joined, sliced output equal to one call at the true widths
    within f32 rounding (zero columns add exact zeros; the scale stays
    1/sqrt of the true Dqk)."""
    rng = np.random.default_rng(dqk + dv)
    q = torch.from_numpy(rng.normal(size=(1, 4, 24, dqk)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(1, 2, 40, dqk)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(1, 2, 40, dv)).astype(np.float32))
    seen: list = []
    scale = dqk ** -0.5
    got = fa_k.by_width(_recording(lambda q, k, v: tref.flash_attention(
        q, k, v, causal=True, window=16, scale=scale), seen), q, k, v)
    assert len(seen) == -(-fa_k.padded_width(dv) // fa_k.MAX_DV)
    for (qs, qc), (ks, kc), (vs, vc) in seen:
        assert qc and kc and vc
        assert qs[3] == ks[3] == fa_k.padded_width(dqk) <= 256 and vs[3] <= fa_k.MAX_DV
        assert qs[3] % 16 == 0 and vs[3] % 16 == 0
        fa_k.kernel_instance(qs[3], vs[3])
    want = tref.flash_attention(q, k, v, causal=True, window=16)
    assert got.shape == want.shape and got.is_contiguous()
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("d", [40, 200])
def test_flash_by_width_matches_pallas_interpret_off_the_kernel_widths(d):
    """At head dims the CUDA kernel's instances do not take as they are (40:
    not a multiple of 16; 200: queries and keys on <256,128>, values in two
    blocks), the routed plain version against the Pallas kernel in
    interpret mode, which takes any width, within the bf16 tolerance."""
    rng = np.random.default_rng(d)
    (qj, qt), (kj, kt), (vj, vt) = (_pair(rng, (1, 2, 64, d)) for _ in range(3))
    got = fa_k.by_width(lambda q, k, v: tref.flash_attention(q, k, v, causal=True,
                                                             scale=d ** -0.5), qt, kt, vt)
    _check(got, pallas_flash_attention(qj, kj, vj, causal=True, interpret=True))


@pytest.mark.parametrize("hq,hkv,d", [(34, 1, 64), (40, 2, 40), (96, 3, 24), (17, 1, 16),
                                      (16, 1, 100)])
def test_decode_subgroups_and_padding_route_any_group_and_width(hq, hkv, d):
    """``decode_attention.by_subgroups`` (what the dense and paged CUDA
    wrappers launch through) runs query groups past 16 as contiguous
    sub-groups of at most 16 a kv head, equal to one call (rows are
    independent; on the CPU the plain version's f32 products may block the
    sum otherwise, so within 1e-6); a width off a multiple of 16
    zero-padded, with the scale of the true width, too."""
    rng = np.random.default_rng(hq + d)
    q = torch.from_numpy(rng.normal(size=(4, hq, d)).astype(np.float32))
    kc, vc = (torch.from_numpy(rng.normal(size=(4, hkv, 96, d)).astype(np.float32))
              for _ in range(2))
    lengths = torch.tensor([1, 50, 96, 7], dtype=torch.int32)
    seen: list = []
    pad = dec_k.pad_width
    got = dec_k.by_subgroups(_recording(lambda qs: dec_k.plain_decode_attention(
        qs, pad(kc), pad(vc), lengths, scale=d ** -0.5), seen), pad(q), hkv)[..., :d]
    assert len(seen) == len(dec_k.subgroups(hq // hkv))
    for ((shape, contiguous),) in seen:
        assert contiguous and shape[1] // hkv <= dec_k.MAX_GROUP and shape[2] % 16 == 0
    want = dec_k.plain_decode_attention(q, kc, vc, lengths)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)
    unpadded = dec_k.by_subgroups(lambda qs: dec_k.plain_decode_attention(qs, kc, vc, lengths),
                                  q, hkv)
    torch.testing.assert_close(unpadded, want, atol=1e-6, rtol=1e-6)


def test_decode_subgroups_match_pallas_interpret_at_a_group_of_20():
    """A query group of 20 (past the tile's 16 rows) at head dim 40, the
    routed plain version against the Pallas decode kernel in interpret mode
    (which takes any whole group), within the bf16 tolerance."""
    rng = np.random.default_rng(20)
    (qj, qt), (kj, kt), (vj, vt) = (_pair(rng, s) for s in ((2, 40, 40), (2, 2, 64, 40),
                                                            (2, 2, 64, 40)))
    lengths = np.array([33, 64], np.int32)
    lt = torch.from_numpy(lengths)
    pad = dec_k.pad_width
    got = dec_k.by_subgroups(lambda qs: dec_k.plain_decode_attention(
        qs, pad(kt), pad(vt), lt, scale=40 ** -0.5), pad(qt), 2)[..., :40]
    _check(got, pallas_decode_attention(qj, kj, vj, jnp.asarray(lengths), interpret=True))


@pytest.mark.parametrize("dtype", [torch.float8_e4m3fn, torch.float8_e5m2],
                         ids=["e4m3", "e5m2"])
def test_rmsnorm_in_other_float_types_is_the_f32_route_bitwise(dtype):
    """The CUDA wrapper runs x of a float type outside bf16, f16, f32 and
    f64 through the f32 instance and casts to x's type: on the same values
    that is the plain version's function bit for bit (f32 statistics, one
    rounding to x's type)."""
    from repro_torch.kernels import rmsnorm as rms_k

    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.normal(size=(8, 300)).astype(np.float32)).to(dtype)
    w = torch.from_numpy(1 + rng.random(300).astype(np.float32)).to(dtype)
    got = rms_k.rmsnorm(x, w)
    assert got.dtype == dtype
    assert torch.equal(got.float(), rms_k.plain_rmsnorm(x.float(), w.float()).to(dtype).float())
