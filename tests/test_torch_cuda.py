"""Hand-written Hopper kernels against their plain PyTorch versions, on the card.

Run on a machine with an NVIDIA GPU (sm_90a: H100/H200):

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py

Everywhere else every test here skips.  Whether a card is present is decided
inside the ``cuda`` fixture, never at import: pytest-xdist workers must all
collect the same tests.  This file imports no JAX.

Tolerances: matmul and rmsnorm bf16 outputs are held to 2e-2 (absolute and
relative), a bit more than one bf16 rounding step of the O(1) values used
here — the kernels sum in another order than the plain versions.  f32 matmul
outputs are held to 1e-3: both sides accumulate exact bf16 products in f32.
Attention outputs are held row by row (one query head of one token): the L2
norm of the difference is at most 1e-2 of the plain row's.  A row over n
random keys has |o| of about n^-1/2, so an absolute 2e-2 would pass a kernel
that drops a key tile; the kernels' own rounding (P to bf16 for P V, the bf16
output) reads a few 1e-3.  The ssd kernel is held the same way: each y row
(one head of one token) within 1e-2 relative L2 of the plain row, and each
head's final f32 state within 1e-3 (both sides run the same f32 algebra and
differ in summation order; y is rounded to bf16).  conv2d is held exactly
for int16 inputs (int32 sums, wrapping past 2^31 on both sides) and within
2e-4 for f32; the f32 matmul within 2e-4 (full f32 FMAs against torch's f32
product with TF32 off: reordering only).  Fixed-weight roles are held
bitwise to their generic kernels: they launch the same kernel.
"""

from __future__ import annotations

import pytest
import torch

from repro_torch.core import dispatch
from repro_torch.kernels import conv2d as conv_k
from repro_torch.kernels import decode_attention as dec_k
from repro_torch.kernels import flash_attention as fa_k
from repro_torch.kernels import matmul as mm_k
from repro_torch.kernels import paged_decode_attention as paged_k
from repro_torch.kernels import rmsnorm as rms_k
from repro_torch.kernels import ssd as ssd_k
from repro_torch.kernels.ref import gather_kv_pages

pytestmark = pytest.mark.gpu

BF16_TOL = dict(atol=2e-2, rtol=2e-2)
ATTN_REL_L2_TOL = 1e-2
SSD_STATE_REL_L2_TOL = 1e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(gen, shape, device, scale=1.0):
    return (torch.randn(shape, generator=gen, device=device) * scale).to(torch.bfloat16)


def _gen(device, seed=0):
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def _close(got, want, **tol):
    torch.testing.assert_close(got.float(), want.float(), **tol)


def _attn_close(got, want):
    """Every output row within ATTN_REL_L2_TOL of the plain row, relatively."""
    g, w = got.float(), want.float()
    assert torch.isfinite(g).all()
    rel = (g - w).norm(dim=-1) / w.norm(dim=-1).clamp_min(1e-12)
    assert float(rel.max()) <= ATTN_REL_L2_TOL, f"row rel L2 {float(rel.max())}"


@pytest.mark.parametrize("m,k,n", [(8, 2048, 2048), (8, 2048, 512), (8, 8192, 2048),
                                   (512, 2048, 8192), (100, 256, 136), (1, 64, 8),
                                   (1, 2048, 8192), (1, 8192, 2048),      # first-token fixup
                                   (1024, 2048, 8192), (1024, 8192, 2048),   # 1024 bucket
                                   (16, 2048, 8192), (128, 8192, 2048),      # 16 slots, chunk
                                   (600, 1536, 6448), (600, 3072, 1536),     # mamba2 prefill
                                   (8, 1536, 6448), (37, 3072, 1536),        # mamba2 decode, prompt
                                   (64, 2048, 8192), (256, 8192, 2048)])     # chunk, bucket
@pytest.mark.parametrize("activation", [None, "silu", "gelu"])
def test_matmul_matches_plain(cuda, m, k, n, activation):
    g = _gen(cuda)
    x, w = _randn(g, (m, k), cuda), _randn(g, (k, n), cuda, scale=k ** -0.5)
    _close(mm_k.matmul(x, w, activation=activation),
           mm_k.plain_matmul(x, w, activation=activation), **BF16_TOL)
    _close(mm_k.matmul(x, w, activation=activation, out_dtype=torch.float32),
           mm_k.plain_matmul(x, w, activation=activation, out_dtype=torch.float32),
           atol=1e-3, rtol=1e-3)


def test_matmul_batched_leading_dims(cuda):
    g = _gen(cuda, 1)
    x, w = _randn(g, (2, 3, 256), cuda), _randn(g, (256, 64), cuda, scale=1 / 16)
    got = mm_k.matmul(x, w)
    assert got.shape == (2, 3, 64)
    _close(got, mm_k.plain_matmul(x, w), **BF16_TOL)


# shapes whose plan splits K: the split partials are summed in the same launch
SPLIT_SHAPES = [(8, 8192, 2048), (1, 2048, 512), (37, 3072, 1536), (128, 8192, 2048)]


@pytest.mark.parametrize("m,k,n", SPLIT_SHAPES)
def test_matmul_split_is_one_launch_and_bitwise_repeatable(cuda, m, k, n):
    """A split shape is summed in split order by the last block to finish,
    so two calls agree bit for bit; and it is one launch: the launch count
    moves by one a call, and a profiler trace of a call holds one kernel."""
    from torch.profiler import ProfilerActivity, profile

    assert mm_k.plan(m, n, k).splits > 1
    g = _gen(cuda, 7)
    x, w = _randn(g, (m, k), cuda), _randn(g, (k, n), cuda, scale=k ** -0.5)
    before = mm_k.launches
    first = mm_k.matmul(x, w, activation="silu")
    assert mm_k.launches == before + 1
    second = mm_k.matmul(x, w, activation="silu")
    assert mm_k.launches == before + 2
    assert torch.equal(first, second)
    _close(first, mm_k.plain_matmul(x, w, activation="silu"), **BF16_TOL)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        mm_k.matmul(x, w)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and "memcpy" not in e.name.lower() and "memset" not in e.name.lower()]
    assert len(kernels) == 1, [e.name for e in kernels]
    assert "mm_" in kernels[0].name


def test_matmul_refuses_a_misaligned_input_before_any_launch(cuda):
    """An operand TMA cannot take (here x 2 bytes off a 16-byte boundary) is
    no longer refused: it goes to the edge kernel, one launch, and matches
    the plain version; the TMA kernels launch nothing."""
    m, k, n = 8, 2048, 512
    g = _gen(cuda, 8)
    x = torch.empty(m * k + 1, dtype=torch.bfloat16, device=cuda)[1:].view(m, k)
    x.copy_(_randn(g, (m, k), cuda))
    w = _randn(g, (k, n), cuda, scale=k ** -0.5)
    assert x.is_contiguous() and x.data_ptr() % 16 == 2
    before = (mm_k.launches, mm_k.edge_launches)
    got = mm_k.matmul(x, w)
    assert (mm_k.launches, mm_k.edge_launches) == (before[0], before[1] + 1)
    _close(got, mm_k.plain_matmul(x, w), **BF16_TOL)


# the untied unembeds of granite-3-8b, hymba and whisper at a decode step (N
# odd or not a multiple of 8), and small shapes with K, N or both ragged
EDGE_SHAPES = [(8, 4096, 49155), (8, 1600, 32001), (8, 1280, 51866), (1, 4096, 49155),
               (8, 36, 49), (6, 100, 131), (70, 130, 200), (33, 2048, 517)]


@pytest.mark.parametrize("m,k,n", EDGE_SHAPES)
@pytest.mark.parametrize("activation", [None, "silu", "gelu"])
def test_matmul_edge_matches_plain(cuda, m, k, n, activation):
    """K or N not a multiple of 8: the edge kernel (guarded loads,
    mma.sync), bf16 and f32 outputs, every epilogue, one launch each."""
    g = _gen(cuda, m + k + n)
    x, w = _randn(g, (m, k), cuda), _randn(g, (k, n), cuda, scale=k ** -0.5)
    before = (mm_k.launches, mm_k.edge_launches)
    got = mm_k.matmul(x, w, activation=activation)
    got32 = mm_k.matmul(x, w, activation=activation, out_dtype=torch.float32)
    assert (mm_k.launches, mm_k.edge_launches) == (before[0], before[1] + 2)
    assert got.shape == (m, n) and got32.dtype == torch.float32
    _close(got, mm_k.plain_matmul(x, w, activation=activation), **BF16_TOL)
    _close(got32, mm_k.plain_matmul(x, w, activation=activation, out_dtype=torch.float32),
           atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("m,k,n", [(8, 4096, 49155), (8, 36, 49), (6, 100, 131), (5, 18, 7)])
def test_f32_matmul_edge_matches_plain(cuda, m, k, n):
    """f32 with K or N not a multiple of 4: the f32 kernel's edge instance."""
    g = _gen(cuda, m + k + n)
    x = torch.randn((m, k), generator=g, device=cuda)
    w = torch.randn((k, n), generator=g, device=cuda) * k ** -0.5
    before = (mm_k.f32_launches, mm_k.edge_launches)
    got = mm_k.matmul(x, w, activation="silu")
    assert (mm_k.f32_launches, mm_k.edge_launches) == (before[0], before[1] + 1)
    torch.testing.assert_close(got, mm_k.plain_matmul(x, w, activation="silu"), **F32_TOL)


@pytest.mark.parametrize("shape", [(8, 2048), (512, 2048), (3, 5, 64)])
def test_rmsnorm_f32_matches_plain(cuda, shape):
    """The f32 instantiation: f32 x and weight, f32 statistics, within the
    f32 tolerance of tests/test_kernels.py (2e-4)."""
    g = _gen(cuda, 9)
    x = torch.randn(shape, generator=g, device=cuda)
    w = torch.randn(shape[-1:], generator=g, device=cuda)
    before = rms_k.launches
    got = rms_k.rmsnorm(x, w)
    assert got.dtype == torch.float32 and rms_k.launches == before + 1
    _close(got, rms_k.plain_rmsnorm(x, w), atol=2e-4, rtol=2e-4)
    with dispatch.use(prefer=dispatch.policy_from_flag("cuda-strict")):
        assert torch.equal(dispatch.op("rmsnorm", x, w), got)


@pytest.mark.parametrize("shape", [(8, 2048), (512, 2048), (3, 5, 64)])
def test_rmsnorm_matches_plain(cuda, shape):
    g = _gen(cuda, 2)
    x, w = _randn(g, shape, cuda), _randn(g, shape[-1:], cuda)
    _close(rms_k.rmsnorm(x, w), rms_k.plain_rmsnorm(x, w), **BF16_TOL)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("b,hq,hkv,s,t,causal,window", [
    (1, 32, 8, 512, 512, True, None),
    (1, 32, 8, 512, 512, False, None),
    (1, 32, 8, 128, 512, True, None),      # S < T: queries at the kv tail
    (2, 4, 2, 200, 200, True, None),       # ragged S and T
    (1, 4, 1, 256, 256, True, 48),         # sliding window
    (1, 32, 8, 8, 8, True, None),          # the smallest prompt bucket
    (1, 32, 8, 1024, 1024, True, None),    # the largest prompt bucket
    (1, 32, 8, 128, 1024, True, None),     # a chunk of chunked prefill, 1024 keys
    (1, 32, 8, 128, 384, True, None),      # a chunk against keys no power of two
    (1, 8, 2, 100, 300, False, 70),        # window without the causal mask, S < T
])
def test_flash_attention_matches_plain(cuda, b, hq, hkv, s, t, causal, window, d):
    g = _gen(cuda, 3)
    q = _randn(g, (b, hq, s, d), cuda)
    k, v = _randn(g, (b, hkv, t, d), cuda), _randn(g, (b, hkv, t, d), cuda)
    got = fa_k.flash_attention(q, k, v, causal=causal, window=window)
    want = fa_k.plain_flash_attention(q, k, v, causal=causal, window=window)
    _attn_close(got, want)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("s,t,causal", [(128, 1024, True), (128, 768, True), (64, 2048, False),
                                        (100, 1200, True)])
def test_flash_attention_split_is_one_launch_and_bitwise_repeatable(cuda, s, t, causal, d):
    """A shape whose q tiles and heads leave SMs idle splits its key range:
    the splits are merged in split order by the last block of a tile, so two
    calls agree bit for bit; it is one launch (the count moves by one a call,
    and a profiler trace of a call holds one kernel); and it matches the
    plain version."""
    from torch.profiler import ProfilerActivity, profile

    assert fa_k.split_kv(1, 32, s, t, causal, head_dim=d) > 1
    g = _gen(cuda, 17)
    q = _randn(g, (1, 32, s, d), cuda)
    k, v = _randn(g, (1, 8, t, d), cuda), _randn(g, (1, 8, t, d), cuda)
    before = fa_k.launches
    first = fa_k.flash_attention(q, k, v, causal=causal)
    second = fa_k.flash_attention(q, k, v, causal=causal)
    assert fa_k.launches == before + 2
    assert torch.equal(first, second)
    _attn_close(first, fa_k.plain_flash_attention(q, k, v, causal=causal))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fa_k.flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and "memcpy" not in e.name.lower() and "memset" not in e.name.lower()]
    assert len(kernels) == 1 and "fa_kernel" in kernels[0].name, [e.name for e in kernels]


def test_flash_attention_ignores_rows_past_t_and_other_heads(cuda):
    """Keys of one kv head never reach another's output: NaN planted in kv
    head 1 leaves the rows of the query heads reading kv head 0 bit for bit
    (the tensor maps read zeros past T, not the next head's rows)."""
    g = _gen(cuda, 18)
    q = _randn(g, (1, 4, 100, 128), cuda)
    k, v = _randn(g, (1, 2, 100, 128), cuda), _randn(g, (1, 2, 100, 128), cuda)
    clean = fa_k.flash_attention(q, k, v)
    k[:, 1], v[:, 1] = float("nan"), float("nan")
    got = fa_k.flash_attention(q, k, v)
    assert torch.equal(got[:, :2], clean[:, :2]) and torch.isnan(got[:, 2:]).all()


@pytest.mark.parametrize("d,hkv", [(64, 8), (128, 4), (128, 8)])
@pytest.mark.parametrize("lengths", [[1, 1024, 5, 600, 33, 64, 1000, 2], 77])
def test_decode_attention_matches_plain(cuda, lengths, d, hkv):
    g = _gen(cuda, 4)
    q = _randn(g, (8, 32, d), cuda)
    kc, vc = _randn(g, (8, hkv, 1024, d), cuda), _randn(g, (8, hkv, 1024, d), cuda)
    length = (torch.tensor(lengths, dtype=torch.int32, device=cuda)
              if isinstance(lengths, list) else lengths)
    got = dec_k.decode_attention(q, kc, vc, length)
    _attn_close(got, dec_k.plain_decode_attention(q, kc, vc, length))


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("n", [5, 45, 600])
def test_decode_attention_fixup_cache_matches_plain(cuda, n, d):
    """The first-token fixup: one sequence against its cache cut to the
    prompt's n rows, a length that is not a multiple of the 32-key tile."""
    g = _gen(cuda, 8)
    q = _randn(g, (1, 32, d), cuda)
    kc, vc = _randn(g, (1, 8, n, d), cuda), _randn(g, (1, 8, n, d), cuda)
    length = torch.tensor([n], dtype=torch.int32, device=cuda)
    _attn_close(dec_k.decode_attention(q, kc, vc, length),
                dec_k.plain_decode_attention(q, kc, vc, length))


@pytest.mark.parametrize("d", [64, 128])
def test_decode_attention_ignores_rows_past_length(cuda, d):
    """Rows at or past a sequence's length never reach the output, even NaN."""
    g = _gen(cuda, 5)
    q = _randn(g, (2, 8, d), cuda)
    kc, vc = _randn(g, (2, 2, 256, d), cuda), _randn(g, (2, 2, 256, d), cuda)
    lengths = torch.tensor([100, 129], dtype=torch.int32, device=cuda)
    clean = dec_k.decode_attention(q, kc, vc, lengths)
    for b, n in enumerate((100, 129)):
        start = -(-n // 32) * 32          # first whole tile past the length
        kc[b, :, start:] = float("nan")
        vc[b, :, start:] = float("nan")
    torch.testing.assert_close(dec_k.decode_attention(q, kc, vc, lengths), clean,
                               atol=0, rtol=0)


def test_wrappers_count_launches_and_refuse_bad_input(cuda):
    g = _gen(cuda, 6)
    x, w = _randn(g, (4, 64), cuda), _randn(g, (64, 64), cuda)
    before = mm_k.launches
    mm_k.matmul(x, w)
    assert mm_k.launches == before + 1
    with pytest.raises(TypeError):
        mm_k.matmul(x.float(), w)                    # f32 with bf16: no kernel takes the mix
    with pytest.raises(ValueError):
        mm_k.matmul(x.t(), w)                        # not contiguous
    with pytest.raises(ValueError):
        fa_k.flash_attention(*(_randn(g, (1, 2, 8, 32), cuda) for _ in range(3)))  # D = 32
    with pytest.raises(ValueError, match=r"\(64, 128\)"):
        dec_k.decode_attention(_randn(g, (1, 2, 96), cuda), *(_randn(g, (1, 2, 8, 96), cuda)
                                                              for _ in range(2)), 3)
    assert mm_k.launches == before + 1


def test_small_model_cuda_matches_torch_source(cuda):
    """Prefill and decode of a small llama-shaped model (head_dim 64) under
    ``cuda-strict`` against the torch eager source on the same weights.  The
    tolerance is loose: the two sources round differently (the eager source
    applies silu in bf16, the kernel in f32) and the error compounds over
    layers."""
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.models import build_model, init_params

    cfg = reduced(ARCHS["llama3.2-1b"], layers=2, d_model=256, vocab=512)
    model = build_model(cfg, device=cuda)
    params = init_params(model.param_specs(), 0, device=cuda)
    tokens = torch.randint(0, cfg.vocab_size, (1, 40), generator=_gen(cuda, 7), device=cuda)
    out = {}
    for policy in ("torch", "cuda-strict"):
        with dispatch.use(prefer=dispatch.policy_from_flag(policy)):
            logits, cache = model.prefill(params, {"tokens": tokens}, cache_len=64)
            cache["pos"] = torch.tensor([40], dtype=torch.int32, device=cuda)
            step, _ = model.decode_step(params, tokens[:, -1:], cache)
        out[policy] = (logits, step)
    for a, b in zip(out["torch"], out["cuda-strict"]):
        assert torch.isfinite(b).all()
        torch.testing.assert_close(b, a, atol=5e-2, rtol=5e-2)


def test_small_head_dim_128_model_cuda_matches_torch_source(cuda):
    """A small granite-shaped model (head_dim 128, an untied unembed over an
    odd vocabulary, so the edge matmul) under ``cuda-strict`` against the
    torch source: prefill, a batched decode step and a paged one (bitwise
    the dense one), at the tolerance of the head_dim 64 model above."""
    import dataclasses

    from repro_torch.configs import ARCHS, reduced
    from repro_torch.models import build_model, init_params

    cfg = dataclasses.replace(reduced(ARCHS["granite-3-8b"], layers=2, d_model=256, vocab=517),
                              head_dim=128)
    model = build_model(cfg, device=cuda)
    params = init_params(model.param_specs(), 0, device=cuda)
    tokens = torch.randint(0, cfg.vocab_size, (2, 40), generator=_gen(cuda, 19), device=cuda)
    out = {}
    for policy in ("torch", "cuda-strict"):
        with dispatch.use(prefer=dispatch.policy_from_flag(policy)):
            before = (fa_k.launches, dec_k.launches, paged_k.launches, mm_k.edge_launches)
            logits = [model.prefill(params, {"tokens": tokens[i:i + 1]}, cache_len=64)
                      for i in range(2)]
            cache = {key: torch.cat([c[key] for _, c in logits], dim=1) for key in ("k", "v")}
            pos = torch.tensor([40, 40], dtype=torch.int32, device=cuda)
            table = torch.tensor([[3, 1, 4, 2], [6, 8, 5, 7]], dtype=torch.int32, device=cuda)
            pool = {}
            for key in ("k", "v"):
                L, B, H, T, hd = cache[key].shape
                pool[key] = torch.zeros(L, 9, H, 16, hd, dtype=cache[key].dtype, device=cuda)
                pool[key][:, table.reshape(-1).long()] = cache[key].reshape(
                    L, B, H, 4, 16, hd).transpose(2, 3).reshape(L, B * 4, H, 16, hd)
            paged, _ = model.decode_step(params, tokens[:, -1:],
                                         {**pool, "pos": pos, "block_table": table})
            step, _ = model.decode_step(params, tokens[:, -1:], {**cache, "pos": pos})
            counts = (fa_k.launches, dec_k.launches, paged_k.launches, mm_k.edge_launches)
        out[policy] = (torch.cat([lg for lg, _ in logits]), step, paged)
        if policy == "cuda-strict":
            assert torch.equal(paged, step)
            assert [a - b for a, b in zip(counts, before)] == [4, 2, 2, 4]
    for a, b in zip(out["torch"], out["cuda-strict"]):
        assert torch.isfinite(b).all() and b.shape[-1] == 517
        torch.testing.assert_close(b, a, atol=5e-2, rtol=5e-2)


def _paged_pool(g, device, B, ps, T=1024, spare=1, d=64, hkv=8):
    """A random pool [P, hkv, ps, d] (page 0 the scratch page) and a shuffled
    table [B, T/ps] mapping every page but the scratch and ``spare`` ones."""
    NP = T // ps
    P = B * NP + 1 + spare
    kp, vp = _randn(g, (P, hkv, ps, d), device), _randn(g, (P, hkv, ps, d), device)
    perm = torch.randperm(P - 1, generator=g, device=device)[: B * NP] + 1
    return kp, vp, perm.reshape(B, NP).to(torch.int32)


@pytest.mark.parametrize("d,hkv", [(64, 8), (128, 4)])
@pytest.mark.parametrize("ps", [8, 16, 64])
@pytest.mark.parametrize("lengths", [[1, 1024, 5, 600, 37, 256, 900, 64],
                                     [3, 1000, 17, 16, 1024, 512, 9, 129] * 2, 77])
def test_paged_decode_attention_matches_plain_and_dense_bitwise(cuda, ps, lengths, d, hkv):
    """Against its plain version row by row, and bit for bit against the
    dense kernel on the gathered cache: the design's promise, for page
    sizes below, at and above the 32-key tile."""
    g = _gen(cuda, 9)
    B = len(lengths) if isinstance(lengths, list) else 8
    q = _randn(g, (B, 32, d), cuda)
    kp, vp, table = _paged_pool(g, cuda, B, ps, d=d, hkv=hkv)
    length = (torch.tensor(lengths, dtype=torch.int32, device=cuda)
              if isinstance(lengths, list) else lengths)
    got = paged_k.paged_decode_attention(q, kp, vp, table, length)
    _attn_close(got, paged_k.plain_paged_decode_attention(q, kp, vp, table, length))
    dense = dec_k.decode_attention(q, gather_kv_pages(kp, table), gather_kv_pages(vp, table),
                                   length)
    assert torch.equal(got, dense)


@pytest.mark.parametrize("d", [64, 128])
def test_paged_decode_attention_reads_nothing_past_length(cuda, d):
    """Rows at or past a sequence's length never reach the output: NaN in
    every pool row past it — the page tail, and the scratch page that the
    table entries past it point at — leaves the result bit for bit."""
    g = _gen(cuda, 10)
    q = _randn(g, (2, 32, d), cuda)
    kp, vp, table = _paged_pool(g, cuda, 2, 16, T=256, d=d)
    lengths = torch.tensor([100, 37], dtype=torch.int32, device=cuda)
    clean = paged_k.paged_decode_attention(q, kp, vp, table, lengths)
    for b, n in enumerate((100, 37)):
        table[b, -(-n // 16):] = 0                    # unmapped: the scratch page
        for pool in (kp, vp):
            pool[table[b, n // 16].long(), :, n % 16:] = float("nan")
    kp[0], vp[0] = float("nan"), float("nan")
    torch.testing.assert_close(paged_k.paged_decode_attention(q, kp, vp, table, lengths),
                               clean, atol=0, rtol=0)


@pytest.mark.parametrize("bad", [-1, 10_000])
def test_paged_decode_attention_masks_pages_outside_the_pool(cuda, bad):
    """A corrupt table entry inside the length (a page index outside the
    pool) drops that page's rows from the softmax: the output is attention
    over the other rows, not over zero rows standing in for them."""
    g = _gen(cuda, 13)
    q = _randn(g, (2, 32, 64), cuda)
    kp, vp, table = _paged_pool(g, cuda, 2, 16, T=256)
    lengths = torch.tensor([100, 200], dtype=torch.int32, device=cuda)
    corrupt = table.clone()
    corrupt[1, 3] = bad                                   # rows 48..63 of sequence 1
    got = paged_k.paged_decode_attention(q, kp, vp, corrupt, lengths)
    keys = torch.arange(256, device=cuda)[None, :]
    mask = keys < lengths[:, None]
    mask[1, 48:64] = False
    k, v = gather_kv_pages(kp, table), gather_kv_pages(vp, table)
    want = torch.softmax(
        torch.where(mask[:, None], torch.einsum("bhd,bhtd->bht", q.float(),
                                                k.float().repeat_interleave(4, 1)) / 8.0,
                    float("-inf")), dim=-1)
    want = torch.einsum("bht,bhtd->bhd", want, v.float().repeat_interleave(4, 1))
    _attn_close(got, want.to(torch.bfloat16))
    torch.testing.assert_close(got[0], paged_k.paged_decode_attention(q, kp, vp, table,
                                                                      lengths)[0],
                               atol=0, rtol=0)             # sequence 0 untouched


def test_paged_prefill_chunk_equals_staging_under_cuda_strict(cuda):
    """The paged engine's chunked prefill (chunks written into and read
    from the pool) against the staging form, on the card's kernels: the
    logits of each chunk of prompt rows only, the prompt's rows and the
    first-token fixup's logits, bit for bit."""
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.models import build_model, init_params
    from repro_torch.serve.paged import gather_rows

    cfg = reduced(ARCHS["llama3.2-1b"], layers=2, d_model=256, vocab=512)
    model = build_model(cfg, device=cuda)
    params = init_params(model.param_specs(), 0, device=cuda)
    g = _gen(cuda, 14)
    tokens = torch.randint(0, cfg.vocab_size, (1, 128), generator=g, device=cuda)
    specs, pool_specs = model.cache_specs(1, 128), model.cache_specs(9, 16)
    staging = {key: torch.zeros(specs[key].shape, dtype=specs[key].dtype, device=cuda)
               for key in ("k", "v")}
    pool = {key: torch.zeros(pool_specs[key].shape, dtype=pool_specs[key].dtype, device=cuda)
            for key in ("k", "v")}
    table = (torch.randperm(8, generator=g, device=cuda) + 1)[None].int()
    table[0, 7] = 0                                       # 100 real rows: 7 pages
    with dispatch.use(prefer=dispatch.policy_from_flag("cuda-strict")):
        for start in range(0, 128, 32):
            piece = tokens[:, start:start + 32]
            want, _ = model.prefill_chunk(params, piece, staging, start=start)
            got, _ = model.prefill_chunk(params, piece, {**pool, "block_table": table},
                                         start=start)
            assert torch.isfinite(got).all()
            if start + 32 <= 100:
                assert torch.equal(got, want), start
        rows = gather_rows(pool, table[0].tolist(), 100, 16)
        pos = torch.tensor([99], dtype=torch.int32, device=cuda)
        for key in ("k", "v"):
            assert torch.equal(rows[key], staging[key][:, :, :, :100])
        # the fixup writes row 99 of the copies it is given
        fix = [model.decode_step(params, tokens[:, 99:100], {"pos": pos, **kv})[0]
               for kv in (rows, {key: staging[key][:, :, :, :100].clone() for key in ("k", "v")})]
    assert torch.equal(*fix)


def test_paged_wrapper_counts_launches_and_refuses_bad_input(cuda):
    g = _gen(cuda, 11)
    q = _randn(g, (2, 32, 64), cuda)
    kp, vp, table = _paged_pool(g, cuda, 2, 16, T=64)
    before = paged_k.launches
    paged_k.paged_decode_attention(q, kp, vp, table, 40)
    assert paged_k.launches == before + 1
    with pytest.raises(TypeError):
        paged_k.paged_decode_attention(q, kp, vp, table.long(), 40)
    with pytest.raises(ValueError, match="mixed devices"):
        paged_k.paged_decode_attention(q, kp, vp, table.cpu(), 40)
    with pytest.raises(ValueError):
        paged_k.paged_decode_attention(q, kp, vp, table[:1], 40)      # B mismatch
    assert paged_k.launches == before + 1


def test_small_model_paged_decode_equals_dense_under_cuda_strict(cuda):
    """A decode step over a pool with a shuffled table gives the dense
    cache's logits bit for bit on the card's kernels."""
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.models import build_model, init_params

    cfg = reduced(ARCHS["llama3.2-1b"], layers=2, d_model=256, vocab=512)
    model = build_model(cfg, device=cuda)
    params = init_params(model.param_specs(), 0, device=cuda)
    g = _gen(cuda, 12)
    tokens = torch.randint(0, cfg.vocab_size, (4, 40), generator=g, device=cuda)
    with dispatch.use(prefer=dispatch.policy_from_flag("cuda-strict")):
        _, cache = model.prefill(params, {"tokens": tokens}, cache_len=64)
        ps, NP = 16, 4
        table = (torch.randperm(16, generator=g, device=cuda) + 1).reshape(4, NP).int()
        pool = {}
        for key in ("k", "v"):
            L, B, H, T, hd = cache[key].shape
            pool[key] = torch.zeros(L, 17, H, ps, hd, dtype=cache[key].dtype, device=cuda)
            pool[key][:, table.reshape(-1).long()] = cache[key].reshape(
                L, B, H, NP, ps, hd).transpose(2, 3).reshape(L, B * NP, H, ps, hd)
        pos = torch.tensor([40, 33, 12, 40], dtype=torch.int32, device=cuda)
        step = tokens[:, -1:]
        want, _ = model.decode_step(params, step, {**cache, "pos": pos})
        got, _ = model.decode_step(params, step, {**pool, "pos": pos, "block_table": table})
    assert torch.isfinite(got).all()
    assert torch.equal(got, want)


def _ssd_args(g, device, B, S, H, P, G, N, strided=True):
    """SSD inputs with Mamba-2's laws (a = -uniform(1, 16), dt log-uniform in
    [1e-3, 1e-1]); x, b, c as views of one conv output when ``strided``."""
    conv = _randn(g, (B, S, H * P + 2 * G * N), device)
    x = conv[..., :H * P].reshape(B, S, H, P)
    b = conv[..., H * P:H * P + G * N].reshape(B, S, G, N)
    c = conv[..., H * P + G * N:].reshape(B, S, G, N)
    if not strided:
        x, b, c = x.contiguous(), b.contiguous(), c.contiguous()
    a = -(1.0 + 15.0 * torch.rand(H, generator=g, device=device))
    dt = torch.exp(-6.9078 + 4.6052 * torch.rand((B, S, H), generator=g, device=device))
    return x, a, b, c, dt


@pytest.mark.parametrize("B,S,H,P,G,N,strided", [
    (1, 1, 48, 64, 1, 128, True), (1, 5, 48, 64, 1, 128, True), (1, 16, 48, 64, 1, 128, True),
    (1, 17, 48, 64, 1, 128, True), (1, 256, 48, 64, 1, 128, True),
    (1, 600, 48, 64, 1, 128, True), (1, 600, 48, 64, 1, 128, False),
    (2, 64, 4, 16, 2, 32, False), (3, 37, 8, 16, 1, 16, True)])
def test_ssd_matches_plain(cuda, B, S, H, P, G, N, strided):
    g = _gen(cuda, S)
    args = _ssd_args(g, cuda, B, S, H, P, G, N, strided)
    y, state = ssd_k.ssd(*args, return_state=True)
    want_y, want_state = ssd_k.plain_ssd(*args, return_state=True)
    torch.cuda.synchronize()
    assert y.shape == (B, S, H, P) and y.dtype == torch.bfloat16
    assert state.shape == (B, H, P, N) and state.dtype == torch.float32
    _attn_close(y, want_y)
    rel = (state - want_state).flatten(2).norm(dim=-1) / want_state.flatten(2).norm(dim=-1)
    assert float(rel.max()) <= SSD_STATE_REL_L2_TOL, f"state rel L2 {float(rel.max())}"


def test_ssd_wrapper_counts_launches_and_refuses_bad_input(cuda):
    g = _gen(cuda, 3)
    x, a, b, c, dt = _ssd_args(g, cuda, 1, 40, 8, 16, 1, 16)
    before = ssd_k.launches
    assert ssd_k.ssd(x, a, b, c, dt).shape == x.shape
    assert ssd_k.launches == before + 1
    with pytest.raises(TypeError):
        ssd_k.ssd(x.float(), a, b, c, dt)
    with pytest.raises(TypeError):
        ssd_k.ssd(x, a, b, c, dt.to(torch.bfloat16))
    with pytest.raises(ValueError, match="mixed devices"):
        ssd_k.ssd(x, a.cpu(), b, c, dt)
    with pytest.raises(ValueError):
        ssd_k.ssd(x.transpose(2, 3), a, b, c, dt)                 # [B,S,H,P] not packed
    with pytest.raises(ValueError):
        big = _randn(g, (1, 40, 1, 144), cuda)                     # N > 128
        ssd_k.ssd(x, a, big, big, dt)
    assert ssd_k.launches == before + 1


def test_small_mamba_cuda_strict_matches_the_torch_source(cuda):
    """A small Mamba-2 on the card's kernels against the torch source:
    prefill at a ragged length and two decode steps, logits and state."""
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.models import build_model, init_params

    cfg = reduced(ARCHS["mamba2-780m"], layers=2, d_model=256, vocab=512)
    model = build_model(cfg, device=cuda)
    params = init_params(model.param_specs(), 0, device=cuda)
    g = _gen(cuda, 15)
    tokens = torch.randint(0, cfg.vocab_size, (2, 45), generator=g, device=cuda)
    steps = torch.randint(0, cfg.vocab_size, (2, 2, 1), generator=g, device=cuda)
    out = {}
    for policy in ("torch", "cuda-strict"):
        with dispatch.use(prefer=dispatch.policy_from_flag(policy)):
            logits, cache = model.prefill(params, {"tokens": tokens})
            got = [logits]
            cache["pos"] = torch.tensor([45, 45], dtype=torch.int32, device=cuda)
            for tok in steps:
                logits, cache = model.decode_step(params, tok, cache)
                got.append(logits)
        out[policy] = (got, cache["ssm_state"])
    for want, got in zip(*(out[p][0] for p in ("torch", "cuda-strict"))):
        assert torch.isfinite(got).all()
        assert float((got - want).norm() / want.norm()) < 5e-2
    want, got = out["torch"][1], out["cuda-strict"][1]
    assert float((got - want).norm() / want.norm()) < 5e-2


# ---------------------------------------------------------------------------
# conv2d (paper roles 3 and 4) and the f32 matmul (the FC roles)
# ---------------------------------------------------------------------------

F32_TOL = dict(atol=2e-4, rtol=2e-4)


def _conv_inputs(gen, device, B, H, W, Cin, kh, kw, F, dtype, hi=100):
    if dtype == torch.int16:
        whi = 8 if hi <= 100 else hi          # the paper's small filter taps, or extremes
        x = torch.randint(-hi, hi, (B, H, W, Cin), generator=gen, device=device)
        w = torch.randint(-whi, whi, (kh, kw, Cin, F), generator=gen, device=device)
        return x.to(torch.int16), w.to(torch.int16)
    return (torch.randn((B, H, W, Cin), generator=gen, device=device),
            torch.randn((kh, kw, Cin, F), generator=gen, device=device))


@pytest.mark.parametrize("B,H,W,Cin,kh,kw,F,dtype", [
    (1, 64, 64, 1, 5, 5, 1, torch.int16), (1, 64, 64, 1, 3, 3, 2, torch.int16),
    (256, 64, 64, 1, 3, 3, 2, torch.int16), (2, 20, 20, 4, 3, 3, 8, torch.float32),
    (1, 32, 32, 1, 5, 5, 1, torch.float32), (3, 17, 45, 3, 2, 4, 11, torch.int16),
    (2, 40, 70, 70, 3, 3, 9, torch.float32), (1, 9, 9, 2, 7, 7, 1, torch.float32),
])
def test_conv2d_matches_plain(cuda, B, H, W, Cin, kh, kw, F, dtype):
    x, w = _conv_inputs(_gen(cuda), cuda, B, H, W, Cin, kh, kw, F, dtype)
    got, want = conv_k.conv2d(x, w), conv_k.plain_conv2d(x, w)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and got.shape == want.shape
    if dtype == torch.int16:
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, **F32_TOL)


def test_conv2d_int32_sums_wrap(cuda):
    x, w = _conv_inputs(_gen(cuda, 1), cuda, 1, 16, 16, 1, 5, 5, 2, torch.int16, hi=32767)
    exact = conv_k.plain_conv2d(x.long(), w.long())
    assert exact.abs().max() > 2**31
    assert torch.equal(conv_k.conv2d(x, w), conv_k.plain_conv2d(x, w))


@pytest.mark.parametrize("kh,F", [(5, 1), (3, 2)])
def test_conv2d_fixed_weight_is_bitwise_generic(cuda, kh, F):
    x, w = _conv_inputs(_gen(cuda, 2), cuda, 4, 64, 64, 1, kh, kh, F, torch.int16)
    fixed = conv_k.conv2d_fixed_weight(w.cpu()).bind(cuda)
    assert fixed.weight.device.type == "cuda"
    assert torch.equal(fixed(x), conv_k.conv2d(x, w))


def test_conv2d_wrapper_counts_launches_and_refuses_bad_input(cuda):
    x, w = _conv_inputs(_gen(cuda), cuda, 1, 16, 16, 1, 3, 3, 2, torch.int16)
    before = conv_k.launches
    conv_k.conv2d(x, w)
    assert conv_k.launches == before + 1
    with pytest.raises(TypeError):
        conv_k.conv2d(x.to(torch.int32), w.to(torch.int32))
    with pytest.raises(TypeError):
        conv_k.conv2d(x, w.float())
    with pytest.raises(ValueError):
        conv_k.conv2d(x[:, :2], w)
    assert conv_k.launches == before + 1


@pytest.mark.parametrize("m,k,n", [(256, 256, 256), (2048, 2048, 2048), (100, 260, 132),
                                   (1, 64, 8), (8, 4096, 12), (300, 20, 4)])
@pytest.mark.parametrize("activation", [None, "silu", "gelu"])
def test_f32_matmul_matches_plain(cuda, m, k, n, activation):
    g = _gen(cuda, m + k + n)
    x = torch.randn((m, k), generator=g, device=cuda)
    w = torch.randn((k, n), generator=g, device=cuda) * k ** -0.5
    before = mm_k.f32_launches
    got = mm_k.matmul(x, w, activation=activation)
    want = mm_k.plain_matmul(x, w, activation=activation)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and mm_k.f32_launches == before + 1
    torch.testing.assert_close(got, want, **F32_TOL)


def test_matmul_fixed_weight_is_bitwise_matmul(cuda):
    g = _gen(cuda, 9)
    x = torch.randn((256, 256), generator=g, device=cuda)
    w = torch.randn((256, 256), generator=g, device=cuda)
    fixed = mm_k.matmul_fixed_weight(w.cpu()).bind(cuda)
    before = (mm_k.fixed_launches, mm_k.f32_launches)
    assert torch.equal(fixed(x), mm_k.matmul(x, w))
    assert (mm_k.fixed_launches, mm_k.f32_launches) == (before[0] + 1, before[1] + 2)
    xb, wb = x.to(torch.bfloat16), w.to(torch.bfloat16)
    assert torch.equal(mm_k.matmul_fixed_weight(wb.cpu()).bind(cuda)(xb), mm_k.matmul(xb, wb))
    with pytest.raises(TypeError):
        mm_k.matmul(x, w, out_dtype=torch.bfloat16)


def test_matmul_fixed_weight_counts_no_launch_for_empty_rows(cuda):
    """M == 0 launches nothing, so no launch counter moves, the fixed role's
    included."""
    w = torch.randn((256, 128), generator=_gen(cuda, 10), device=cuda)
    fixed = mm_k.matmul_fixed_weight(w.cpu()).bind(cuda)
    before = (mm_k.fixed_launches, mm_k.f32_launches)
    out = fixed(torch.empty((0, 256), device=cuda))
    assert out.shape == (0, 128) and out.dtype == torch.float32
    assert (mm_k.fixed_launches, mm_k.f32_launches) == before


def test_paper_roles_on_the_card_through_the_hsa_queue(cuda):
    """hsa_init on the card (its default), the four paper roles through two
    regions with the worker thread running: outputs equal their plain
    versions and the launch counters equal the packets plus the loads'
    warm-up launches."""
    from repro_torch import paper_roles
    from repro_torch.core import hsa
    from repro_torch.core.ledger import OverheadLedger

    hsa.hsa_shut_down()
    sys_ = hsa.hsa_init(num_regions=2, ledger=OverheadLedger())
    try:
        agent = sys_.default_agent
        assert agent.kind == "gpu" and agent.regions[0].size_bytes > 0
        roles = paper_roles.make_paper_roles(sys_.library, seed=0)
        sys_.library.synthesize_all()
        sched = sys_.scheduler_of(agent)
        q = sys_.queue_of(agent)
        sched.start()
        before = (conv_k.launches, mm_k.f32_launches)
        order = ["role1_fc", "role3_conv5x5", "role4_conv3x3", "role2_fc_barrier",
                 "role3_conv5x5", "role1_fc"]
        pkts = [(n, q.dispatch(roles[n][0].key, *roles[n][1], producer="opencl")) for n in order]
        for n, pkt in pkts:
            assert pkt.completion.wait_eq(0, timeout=60) and pkt.out.error is None, n
        sched.stop()
        for n, pkt in pkts:
            role, args = roles[n]
            if n.startswith("role3") or n.startswith("role4"):
                assert torch.equal(pkt.out.value, conv_k.plain_conv2d(args[0], role.impl.fn.weight.to(cuda)))
            else:
                torch.testing.assert_close(pkt.out.value, mm_k.plain_matmul(*args), **F32_TOL)
        loads = {n: roles[n][0].load_count for n in roles}
        conv_pkts = sum(n.startswith("role3") or n.startswith("role4") for n in order)
        assert conv_k.launches - before[0] == conv_pkts + loads["role3_conv5x5"] + loads["role4_conv3x3"]
        assert mm_k.f32_launches - before[1] == len(order) - conv_pkts + loads["role1_fc"] \
            + loads["role2_fc_barrier"]
    finally:
        hsa.hsa_shut_down()
