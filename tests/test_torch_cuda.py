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
2e-4 for f32; the f32 matmul within 2e-4 (3xTF32 on the tensor cores
against torch's f32 product with TF32 off: each operand is split into two
TF32 parts, so a product misses f32's by below 2^-20 of its terms, and the
sums are reordered).  Fixed-weight roles are held bitwise to their generic
kernels: they launch the same kernel.
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


def _profiled_kernels(call) -> list[str]:
    """The names of the CUDA kernels a torch.profiler trace of ``call()``
    lists (copies and fills left out).  A trace that lists no kernel at all
    is taken once more: on the card the profiler has now and then come back
    empty; a trace with the wrong kernels is returned as it is."""
    from torch.profiler import ProfilerActivity, profile

    names: list[str] = []
    for _ in range(2):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                 and "memcpy" not in e.name.lower() and "memset" not in e.name.lower()]
        if names:
            break
    return names


def _graph_replays(fn):
    """(eager result, the result of the same call captured in a CUDA graph
    and replayed twice), each a tuple of tensors; the replays must agree bit
    for bit with each other."""
    as_tuple = lambda r: tuple(r) if isinstance(r, (tuple, list)) else (r,)  # noqa: E731
    eager = tuple(t.clone() for t in as_tuple(fn()))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        as_tuple(fn())                    # warm-up on the capture's stream
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = as_tuple(fn())
    graph.replay()
    torch.cuda.synchronize()
    first = tuple(t.clone() for t in out)
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, out))
    return eager, first


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
    kernels = _profiled_kernels(lambda: mm_k.matmul(x, w))
    assert len(kernels) == 1, kernels
    assert "mm_" in kernels[0]


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


# the widths the served configs give rmsnorm (llama 2048, mamba2 1536 and
# 3072, hymba 1600, granite and yi 4096, deepseek 7168, internvl2 8192),
# odd widths (the ragged last chunk), and rows past the register-resident
# instances (40000: segmented)
RMS_WIDTHS = [1536, 1600, 2048, 3072, 4096, 7168, 8192, 100, 1000, 4100, 40000]
RMS_DTYPES = [torch.bfloat16, torch.float16, torch.float32]


def _rms_inputs(g, device, rows, d, dtype, offset=0):
    """x [rows, d] and w [d] of ``dtype``, each a contiguous view that
    starts ``offset`` elements into its storage (offset 1: rows off a
    16-byte boundary)."""
    xs = torch.randn(rows * d + offset, generator=g, device=device).to(dtype)
    ws = torch.randn(d + offset, generator=g, device=device).to(dtype)
    return xs[offset:].view(rows, d), ws[offset:]


def _rms_tol(dtype):
    """bf16 and f16 within BF16_TOL, f32 within the JAX package's 2e-4."""
    return dict(atol=2e-4, rtol=2e-4) if dtype == torch.float32 else BF16_TOL


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("dtype", RMS_DTYPES, ids=lambda t: str(t)[6:])
@pytest.mark.parametrize("d", RMS_WIDTHS)
def test_rmsnorm_every_width_and_dtype_matches_plain(cuda, d, dtype, offset):
    x, w = _rms_inputs(_gen(cuda, d), cuda, 7, d, dtype, offset)
    assert x.is_contiguous() and (x.data_ptr() % 16 != 0) == bool(offset)
    before = rms_k.launches
    got = rms_k.rmsnorm(x, w)
    torch.cuda.synchronize()
    assert got.dtype == dtype and rms_k.launches == before + 1
    _close(got, rms_k.plain_rmsnorm(x, w), **_rms_tol(dtype))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=lambda t: str(t)[6:])
@pytest.mark.parametrize("d", [2048, 1600, 100, 8192, 40000])
def test_rmsnorm_is_row_invariant(cuda, d, dtype):
    """A row's output is bitwise the same in a launch of 1, 3, 8, 128 or 600
    rows, and wherever the row sits: a permutation of the rows permutes the
    output bit for bit (at D = 100 rows alternate their 16-byte alignment)."""
    g = _gen(cuda, 11)
    x, w = _rms_inputs(g, cuda, 600, d, dtype)
    full = rms_k.rmsnorm(x, w)
    for k in (1, 3, 8, 128):
        assert torch.equal(rms_k.rmsnorm(x[:k], w), full[:k]), k
    perm = torch.randperm(600, generator=g, device=cuda)
    assert torch.equal(rms_k.rmsnorm(x[perm], w), full[perm])


def test_rmsnorm_counts_launches_and_refuses_bad_input(cuda):
    g = _gen(cuda, 12)
    x, w = _randn(g, (4, 100), cuda), _randn(g, (100,), cuda)
    before = rms_k.launches
    rms_k.rmsnorm(x, w)
    assert rms_k.launches == before + 1
    with pytest.raises(TypeError):
        rms_k.rmsnorm(x.double(), w.double())        # no f64 instance
    with pytest.raises(TypeError):
        rms_k.rmsnorm(x, w.float())                  # the weight in x's dtype
    with pytest.raises(ValueError):
        rms_k.rmsnorm(x, w[:99])
    with pytest.raises(ValueError):
        rms_k.rmsnorm(x.t(), _randn(g, (4,), cuda))  # not contiguous
    assert rms_k.launches == before + 1


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
    kernels = _profiled_kernels(lambda: fa_k.flash_attention(q, k, v, causal=causal))
    assert len(kernels) == 1 and "fa_kernel" in kernels[0], kernels


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
    with pytest.raises(ValueError, match="head_dim 144"):
        fa_k.flash_attention(*(_randn(g, (1, 2, 8, 144), cuda) for _ in range(3)))
    with pytest.raises(ValueError, match="head_dim 40"):
        dec_k.decode_attention(_randn(g, (1, 2, 40), cuda), *(_randn(g, (1, 2, 8, 40), cuda)
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


def _boundary_lengths(T: int, splits: int, B: int = 8) -> list[int]:
    """B lengths at and across the split boundaries of a T-row cache: T, 1,
    and each inner boundary, one row before and one after it, in turn."""
    bounds = [lo for lo, _ in dec_k.split_ranges(T, splits)[1:]]
    near = [n for lo in bounds for n in (lo, lo - 1, lo + 1)] or [T // 2, T // 2 + 1]
    return ([T, 1] + [near[i % len(near)] for i in range(max(0, B - 2))])[:B]


@pytest.mark.parametrize("d,hkv", [(64, 8), (128, 4)])
@pytest.mark.parametrize("splits", range(1, dec_k.MAX_SPLITS + 1))
def test_decode_and_paged_every_split_count(cuda, splits, d, hkv):
    """Each split count on a 1024-row cache, lengths at and across the
    split boundaries: against the plain versions, split and unsplit, and
    paged bitwise the dense kernel with the same splits."""
    g = _gen(cuda, 50 + splits)
    T = 1024
    lengths = torch.tensor(_boundary_lengths(T, splits), dtype=torch.int32, device=cuda)
    q = _randn(g, (8, 32, d), cuda)
    kc, vc = _randn(g, (8, hkv, T, d), cuda), _randn(g, (8, hkv, T, d), cuda)
    got = dec_k.decode_attention(q, kc, vc, lengths, splits=splits)
    _attn_close(got, dec_k.plain_decode_attention(q, kc, vc, lengths))
    _attn_close(got, dec_k.plain_split_decode_attention(q, kc, vc, lengths, splits))
    kp, vp, table = _paged_pool(g, cuda, 8, 16, T=T, d=d, hkv=hkv)
    paged = paged_k.paged_decode_attention(q, kp, vp, table, lengths, splits=splits)
    _attn_close(paged, paged_k.plain_paged_decode_attention(q, kp, vp, table, lengths))
    dense = dec_k.decode_attention(q, gather_kv_pages(kp, table), gather_kv_pages(vp, table),
                                   lengths, splits=splits)
    assert torch.equal(paged, dense)


@pytest.mark.parametrize("B,hkv,T,ps", [(8, 8, 1024, 16), (8, 4, 1024, 64), (16, 8, 1024, 16),
                                        (1, 8, 608, 16), (8, 8, 512, 16), (1, 8, 48, 16)])
def test_decode_and_paged_at_the_split_rule_pick(cuda, B, hkv, T, ps):
    """The served shapes at split_kv's own pick (no splits given), lengths at
    and across its boundaries, paged bitwise dense."""
    splits = dec_k.split_kv(T)
    g = _gen(cuda, 60 + B + T)
    lengths = torch.tensor(_boundary_lengths(T, splits, B), dtype=torch.int32, device=cuda)
    q = _randn(g, (B, 32, 64), cuda)
    kp, vp, table = _paged_pool(g, cuda, B, ps, T=T, hkv=hkv)
    kc, vc = gather_kv_pages(kp, table), gather_kv_pages(vp, table)
    dense = dec_k.decode_attention(q, kc, vc, lengths)
    assert dec_k.last_splits == splits
    _attn_close(dense, dec_k.plain_decode_attention(q, kc, vc, lengths))
    assert torch.equal(dense, dec_k.decode_attention(q, kc, vc, lengths, splits=splits))
    assert torch.equal(paged_k.paged_decode_attention(q, kp, vp, table, lengths), dense)


def test_decode_blocks_per_sm_reads_the_built_kernel(cuda):
    """The occupancy the split rule reads, from the built kernel: at least
    one block an SM, fewer as the ring grows with D, one where the ring
    takes more than half of the SM's shared memory (D = 112 and 128); and
    the kernel refuses more splits than the rule's cap."""
    got = [dec_k.blocks_per_sm(d) for d in range(16, 129, 16)]
    assert all(n >= 1 for n in got) and got == sorted(got, reverse=True), got
    assert got[-2:] == [1, 1], got
    g = _gen(cuda, 49)
    q, kc = _randn(g, (1, 32, 64), cuda), _randn(g, (1, 8, 1024, 64), cuda)
    with pytest.raises(ValueError, match="splits must be"):
        dec_k.decode_attention(q, kc, kc, 1024, splits=dec_k.MAX_SPLITS + 1)


@pytest.mark.parametrize("paged", [False, True])
def test_decode_split_is_one_launch_and_bitwise_repeatable(cuda, paged):
    """A split call is one launch (the count moves by one, a trace holds one
    kernel) and repeats bit for bit: the last block merges in split order."""
    g = _gen(cuda, 70)
    lengths = torch.tensor([1, 1024, 5, 600, 37, 256, 900, 64], dtype=torch.int32, device=cuda)
    q = _randn(g, (8, 32, 64), cuda)
    kp, vp, table = _paged_pool(g, cuda, 8, 16)
    kc, vc = gather_kv_pages(kp, table), gather_kv_pages(vp, table)
    assert dec_k.split_kv(1024) > 1
    mod = paged_k if paged else dec_k
    call = ((lambda: paged_k.paged_decode_attention(q, kp, vp, table, lengths)) if paged
            else (lambda: dec_k.decode_attention(q, kc, vc, lengths)))
    before = mod.launches
    first, second = call(), call()
    assert mod.launches == before + 2
    assert torch.equal(first, second)
    kernels = _profiled_kernels(call)
    assert len(kernels) == 1 and "dec_kernel" in kernels[0], kernels


@pytest.mark.parametrize("paged", [False, True])
def test_decode_in_a_cuda_graph_equals_the_eager_call(cuda, paged):
    g = _gen(cuda, 71)
    lengths = torch.tensor([1, 1024, 5, 600, 37, 256, 900, 64], dtype=torch.int32, device=cuda)
    q = _randn(g, (8, 32, 64), cuda)
    kp, vp, table = _paged_pool(g, cuda, 8, 16)
    kc, vc = gather_kv_pages(kp, table), gather_kv_pages(vp, table)
    call = ((lambda: paged_k.paged_decode_attention(q, kp, vp, table, lengths)) if paged
            else (lambda: dec_k.decode_attention(q, kc, vc, lengths)))
    eager, replayed = _graph_replays(call)
    assert torch.equal(eager[0], replayed[0])


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


def _ssd_close(got, want):
    """y row by row within ATTN_REL_L2_TOL, each head's state within
    SSD_STATE_REL_L2_TOL, relatively."""
    (y, state), (want_y, want_state) = got, want
    _attn_close(y, want_y)
    rel = (state - want_state).flatten(2).norm(dim=-1) / want_state.flatten(2).norm(dim=-1)
    assert float(rel.max()) <= SSD_STATE_REL_L2_TOL, f"state rel L2 {float(rel.max())}"


@pytest.mark.parametrize("B,S,G", [(1, ssd_k.CHUNK - 1, 1), (1, ssd_k.CHUNK, 1),
                                   (1, ssd_k.CHUNK + 1, 1), (2, 2 * ssd_k.CHUNK + 3, 2),
                                   (2, 600, 1), (1, 1024, 1), (2, 600, 2), (2, 1024, 2)])
def test_ssd_chunk_parallel_matches_plain(cuda, B, S, G):
    """The chunk-parallel kernel at the serving widths (H 48, P 64, N 128) on
    strided views of one conv output: one chunk less a row, one chunk, one
    row over, several chunks, the serve run's longest prompt and max_len,
    two sequences and two groups."""
    g = _gen(cuda, 100 + S + G)
    args = _ssd_args(g, cuda, B, S, 48, 64, G, 128)
    got = ssd_k.ssd(*args, return_state=True)
    torch.cuda.synchronize()
    _ssd_close(got, ssd_k.plain_ssd(*args, return_state=True))


@pytest.mark.parametrize("P", [80, 128])
def test_ssd_takes_a_head_wider_than_a_block(cuda, P):
    """Heads of more than 64 columns run as several slices, each with its
    own carry."""
    g = _gen(cuda, 30 + P)
    args = _ssd_args(g, cuda, 2, 2 * ssd_k.CHUNK + 5, 4, P, 2, 64)
    _ssd_close(ssd_k.ssd(*args, return_state=True), ssd_k.plain_ssd(*args, return_state=True))


@pytest.mark.parametrize("S", [ssd_k.CHUNK + 1, 600])
def test_ssd_is_one_launch_and_bitwise_repeatable(cuda, S):
    """One launch a call (the count moves by one, a trace holds one kernel),
    and the carry's chained scan gives the same bits every call."""
    g = _gen(cuda, 40 + S)
    args = _ssd_args(g, cuda, 1, S, 48, 64, 1, 128)
    before = ssd_k.launches
    first = ssd_k.ssd(*args, return_state=True)
    second = ssd_k.ssd(*args, return_state=True)
    assert ssd_k.launches == before + 2
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])
    kernels = _profiled_kernels(lambda: ssd_k.ssd(*args, return_state=True))
    assert len(kernels) == 1 and "ssd_kernel" in kernels[0], kernels


def test_ssd_in_a_cuda_graph_equals_the_eager_call(cuda):
    g = _gen(cuda, 41)
    args = _ssd_args(g, cuda, 2, 300, 48, 64, 1, 128)
    eager, replayed = _graph_replays(lambda: ssd_k.ssd(*args, return_state=True))
    assert all(torch.equal(a, b) for a, b in zip(eager, replayed))


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


@pytest.mark.parametrize("dtype", [torch.int16, torch.float32], ids=lambda t: str(t)[6:])
@pytest.mark.parametrize("kh,F", [(5, 1), (3, 2)])
def test_conv2d_frame_does_not_depend_on_the_batch(cuda, kh, F, dtype):
    """Frame b of a 256-frame call is bitwise the 1-frame call on that
    frame (as a view into the batch and as a copy of its own)."""
    x, w = _conv_inputs(_gen(cuda, 4), cuda, 256, 64, 64, 1, kh, kh, F, dtype)
    full = conv_k.conv2d(x, w)
    for b in (0, 1, 137, 255):
        assert torch.equal(conv_k.conv2d(x[b:b + 1], w), full[b:b + 1]), b
        assert torch.equal(conv_k.conv2d(x[b:b + 1].clone(), w), full[b:b + 1]), b


def test_conv2d_takes_any_number_of_frames(cuda):
    """70000 frames: more than a grid's 65535 in y or z, one launch."""
    x, w = _conv_inputs(_gen(cuda, 5), cuda, 70000, 8, 8, 1, 3, 3, 2, torch.int16)
    before = conv_k.launches
    got = conv_k.conv2d(x, w)
    assert conv_k.launches == before + 1
    assert torch.equal(got, conv_k.plain_conv2d(x, w))


@pytest.mark.parametrize("dtype", [torch.int16, torch.float32], ids=lambda t: str(t)[6:])
@pytest.mark.parametrize("B,H,W,Cin,kh,kw", [(2, 19, 37, 1, 3, 3), (1, 23, 45, 1, 5, 5),
                                             (2, 11, 29, 3, 3, 3)])
@pytest.mark.parametrize("F", range(1, 12))
def test_conv2d_every_filter_count_and_odd_widths(cuda, F, B, H, W, Cin, kh, kw, dtype):
    """F = 1..11 (every filter chunk, and F above 8 in chunks) at widths
    whose output rows are not a multiple of the 4-pixel strip."""
    x, w = _conv_inputs(_gen(cuda, F), cuda, B, H, W, Cin, kh, kw, F, dtype)
    got, want = conv_k.conv2d(x, w), conv_k.plain_conv2d(x, w)
    if dtype == torch.int16:
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, **F32_TOL)


@pytest.mark.parametrize("offset", [1, 2, 4, 8])
def test_conv2d_takes_an_input_off_a_16_byte_boundary(cuda, offset):
    """x a view that starts `offset` int16 elements into its storage: the
    kernel stages it with 2-, 4-, 8- or 16-byte copies, the same outputs."""
    g = _gen(cuda, 6)
    xs = torch.randint(-100, 100, (2 * 64 * 64 + offset,), generator=g, device=cuda)
    x = xs.to(torch.int16)[offset:].view(2, 64, 64, 1)
    w = torch.randint(-8, 8, (3, 3, 1, 2), generator=g, device=cuda).to(torch.int16)
    assert torch.equal(conv_k.conv2d(x, w), conv_k.plain_conv2d(x, w))


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
    big = torch.zeros((68, 68, 1, 8), dtype=torch.float32, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):   # one channel's tile: 235616 bytes
        conv_k.conv2d(torch.zeros((1, 70, 70, 1), device=cuda), big)
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


# ---------------------------------------------------------------------------
# the bf16 edge kernels, the 3xTF32 f32 kernel, head dims 16..128
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("x_offset", [0, 1])
@pytest.mark.parametrize("k", [1280, 1600, 4096, 4099])
@pytest.mark.parametrize("m", [1, 5, 8, 16, 17, 64])
def test_matmul_edge_every_row_offset_matches_plain(cuda, m, k, x_offset):
    """N = 1..7 (mod 8), so a row of w starts at every offset from its
    16-byte boundary; x 0 or 2 bytes off one; every epilogue, bf16 and f32
    out, against the plain version.  M up to 16 takes the streaming edge
    kernel, above it the mma.sync one: one edge launch a call either way."""
    g = _gen(cuda, m * k + x_offset)
    for n in range(257, 264):
        x = torch.empty(m * k + x_offset, dtype=torch.bfloat16, device=cuda)[x_offset:]
        x = x.view(m, k)
        x.copy_(_randn(g, (m, k), cuda))
        w = _randn(g, (k, n), cuda, scale=k ** -0.5)
        for activation in (None, "silu", "gelu"):
            before = (mm_k.launches, mm_k.edge_launches)
            got = mm_k.matmul(x, w, activation=activation)
            got32 = mm_k.matmul(x, w, activation=activation, out_dtype=torch.float32)
            assert (mm_k.launches, mm_k.edge_launches) == (before[0], before[1] + 2)
            _close(got, mm_k.plain_matmul(x, w, activation=activation), **BF16_TOL)
            _close(got32, mm_k.plain_matmul(x, w, activation=activation,
                                            out_dtype=torch.float32), atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("m,k,n", [(8, 4099, 131), (1, 4096, 517), (16, 1600, 1001),
                                   (5, 8192, 2049)])
def test_matmul_edge_split_is_one_launch_and_bitwise_repeatable(cuda, m, k, n):
    """An edge shape with few strips splits K: the last block of a strip sums
    the splits in split order, so two calls agree bit for bit, one launch
    each; and every edge kernel that takes the shape (the streaming one with
    TMA or cp.async copies, split and unsplit, the mma.sync one) agrees with
    the plain version."""
    g = _gen(cuda, 21)
    x, w = _randn(g, (m, k), cuda), _randn(g, (k, n), cuda, scale=k ** -0.5)
    kernel, splits = mm_k.edge_plan(m, n, k, w.data_ptr() % 16 == 0)
    assert splits > 1 and kernel == (1 if k % 8 else 2)
    before = mm_k.edge_launches
    first = mm_k.matmul(x, w, out_dtype=torch.float32)
    second = mm_k.matmul(x, w, out_dtype=torch.float32)
    assert mm_k.edge_launches == before + 2 and torch.equal(first, second)
    want = mm_k.plain_matmul(x, w, out_dtype=torch.float32)
    _close(first, want, atol=1e-3, rtol=1e-3)
    runs = [(1, 1), (1, splits), (0, 1)] + ([] if k % 8 else [(2, 1)])
    for kern, s in runs:
        _close(mm_k.matmul_edge(x, w, kernel=kern, splits=s, out_dtype=torch.float32), want,
               atol=1e-3, rtol=1e-3)


def test_matmul_edge_ignores_values_past_k_and_n(cuda):
    """The edge kernel's cp.async copy reads each row's aligned superset, so
    bytes just past w's end, and its TMA copy boxes past the strip's
    columns: NaN planted past x's and w's ends leaves the output finite and
    bit for bit the same, K split here, so rows past each split's end are
    dropped too; and the cp.async copy likewise."""
    g = _gen(cuda, 22)
    m, k, n = 8, 1000, 333
    assert mm_k.edge_plan(m, n, k, True)[1] > 1
    xbuf = _randn(g, (m * k + 8,), cuda)
    wbuf = _randn(g, ((k + 3) * n,), cuda, scale=k ** -0.5)
    x, w = xbuf[: m * k].view(m, k), wbuf[: k * n].view(k, n)
    clean = mm_k.matmul(x, w, out_dtype=torch.float32)
    xbuf[m * k:], wbuf[k * n:] = float("nan"), float("nan")
    got = mm_k.matmul(x, w, out_dtype=torch.float32)
    assert torch.isfinite(got).all() and torch.equal(got, clean)
    _close(got, mm_k.plain_matmul(x, w, out_dtype=torch.float32), atol=1e-3, rtol=1e-3)
    realigned = mm_k.matmul_edge(x, w, kernel=1, splits=mm_k.edge_splits(m, n, k),
                                 out_dtype=torch.float32)
    assert torch.isfinite(realigned).all()
    _close(realigned, got, atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("m,k,n", [(256, 256, 256), (2048, 2048, 2048), (130, 2048, 250),
                                   (129, 256, 131), (1000, 2047, 1000), (8, 4096, 3000),
                                   (37, 255, 129), (8, 4099, 131), (5, 4096, 517),
                                   (16, 1280, 51866), (1, 4096, 49155)])
def test_f32_matmul_3xtf32_matches_plain_and_is_repeatable(cuda, m, k, n):
    """The f32 kernels (3xTF32) at ragged M, N and K, K 256 and 2048, split
    and unsplit, their edge instances (K or N not a multiple of 4), and the
    streaming kernel at M <= 16 with its TMA and cp.async copies: within
    2e-4 of the full f32 product, two calls bit for bit, one launch a call
    on the counter its instance implies."""
    g = _gen(cuda, m + 3 * k + n)
    x = torch.randn((m, k), generator=g, device=cuda)
    w = torch.randn((k, n), generator=g, device=cuda)
    edge = not mm_k.tma_ready(x, w)
    before = (mm_k.f32_launches, mm_k.edge_launches, mm_k.launches)
    first, second = mm_k.matmul(x, w), mm_k.matmul(x, w)
    after = (mm_k.f32_launches, mm_k.edge_launches, mm_k.launches)
    assert after == (before[0] + 2 * (not edge), before[1] + 2 * edge, before[2])
    assert torch.equal(first, second)
    torch.testing.assert_close(first, mm_k.plain_matmul(x, w), **F32_TOL)


@pytest.mark.parametrize("m,k,n", [(256, 256, 256), (2048, 2048, 2048), (100, 260, 132)])
def test_f32_fixed_weight_is_bitwise_the_generic_kernel(cuda, m, k, n):
    g = _gen(cuda, 23)
    x = torch.randn((m, k), generator=g, device=cuda)
    w = torch.randn((k, n), generator=g, device=cuda)
    fixed = mm_k.matmul_fixed_weight(w.cpu(), activation="gelu").bind(cuda)
    before = (mm_k.fixed_launches, mm_k.f32_launches)
    assert torch.equal(fixed(x), mm_k.matmul(x, w, activation="gelu"))
    assert (mm_k.fixed_launches, mm_k.f32_launches) == (before[0] + 1, before[1] + 2)


@pytest.mark.parametrize("d", [16, 32, 48, 80, 96, 112])
@pytest.mark.parametrize("s,t,causal,window", [(512, 512, True, None), (200, 200, False, None),
                                               (128, 1024, True, None), (256, 256, True, 48)])
def test_flash_attention_takes_every_head_dim_to_128(cuda, s, t, causal, window, d):
    """Head dims other than 64 and 128 (multiples of 16) under cuda-strict,
    split (the 128 x 1024 chunk) and not, against the plain version; two
    calls bit for bit."""
    g = _gen(cuda, 24 + d)
    q = _randn(g, (1, 32, s, d), cuda)
    k, v = _randn(g, (1, 8, t, d), cuda), _randn(g, (1, 8, t, d), cuda)
    with dispatch.use(prefer=dispatch.policy_from_flag("cuda-strict")):
        before = fa_k.launches
        got = dispatch.op("flash_attention", q, k, v, causal=causal, window=window)
        assert fa_k.launches == before + 1
    _attn_close(got, fa_k.plain_flash_attention(q, k, v, causal=causal, window=window))
    assert torch.equal(got, fa_k.flash_attention(q, k, v, causal=causal, window=window))


@pytest.mark.parametrize("d", [16, 32, 48, 80, 96, 112])
def test_decode_and_paged_attention_take_every_head_dim_to_128(cuda, d):
    """Decode attention at 8 slots against 1024 rows and a fixup cache, and
    paged attention bitwise the dense kernel on the gathered cache, under
    cuda-strict, at head dims other than 64 and 128."""
    g = _gen(cuda, 25 + d)
    lengths = torch.tensor([1, 1024, 5, 600, 33, 64, 1000, 2], dtype=torch.int32, device=cuda)
    q = _randn(g, (8, 32, d), cuda)
    kc, vc = _randn(g, (8, 8, 1024, d), cuda), _randn(g, (8, 8, 1024, d), cuda)
    kp, vp, table = _paged_pool(g, cuda, 8, 16, d=d)
    with dispatch.use(prefer=dispatch.policy_from_flag("cuda-strict")):
        before = (dec_k.launches, paged_k.launches)
        got = dispatch.op("decode_attention", q, kc, vc, lengths)
        paged = dispatch.op("paged_decode_attention", q, kp, vp, table, lengths)
        assert (dec_k.launches, paged_k.launches) == (before[0] + 1, before[1] + 1)
    _attn_close(got, dec_k.plain_decode_attention(q, kc, vc, lengths))
    _attn_close(paged, paged_k.plain_paged_decode_attention(q, kp, vp, table, lengths))
    dense = dec_k.decode_attention(q, gather_kv_pages(kp, table), gather_kv_pages(vp, table),
                                   lengths)
    assert torch.equal(paged, dense)
    fix = torch.tensor([45], dtype=torch.int32, device=cuda)
    _attn_close(dec_k.decode_attention(q[:1], kc[:1, :, :45].contiguous(),
                                       vc[:1, :, :45].contiguous(), fix),
                dec_k.plain_decode_attention(q[:1], kc[:1, :, :45], vc[:1, :, :45], fix))


@pytest.mark.parametrize("d", [8, 24, 136, 192])
def test_attention_refuses_a_head_dim_it_does_not_take_naming_it(cuda, d):
    g = _gen(cuda, 26)
    q4, kv4 = _randn(g, (1, 4, 16, d), cuda), _randn(g, (1, 2, 16, d), cuda)
    q3 = _randn(g, (1, 4, d), cuda)
    kp, vp, table = _paged_pool(g, cuda, 1, 16, T=32, d=d, hkv=2)
    for call in (lambda: fa_k.flash_attention(q4, kv4, kv4),
                 lambda: dec_k.decode_attention(q3, kv4, kv4, 8),
                 lambda: paged_k.paged_decode_attention(q3, kp, vp, table, 8)):
        with pytest.raises(ValueError, match=f"head_dim {d} "):
            call()


# ---------------------------------------------------------------------------
# the sampler, and the fused decode as a replayed CUDA graph
# ---------------------------------------------------------------------------


def _np_threefry(k0, k1, x0, x1):
    """Threefry-2x32 in numpy uint32 (wrapping), written apart from the port."""
    import numpy as np

    def rotl(v, r):
        return (v << np.uint32(r)) | (v >> np.uint32(32 - r))

    k0, k1, x0, x1 = (np.asarray(v, dtype=np.uint32) for v in (k0, k1, x0, x1))
    ks = [k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA)]
    x0, x1 = x0 + ks[0], x1 + ks[1]
    for g in range(5):
        for r in ((13, 15, 26, 6), (17, 29, 16, 24))[g % 2]:
            x0 = x0 + x1
            x1 = rotl(x1, r) ^ x0
        x0 = x0 + ks[(g + 1) % 3]
        x1 = x1 + ks[(g + 2) % 3] + np.uint32(g + 1)
    return x0, x1


def _sample_inputs(cuda, B, V, seed=0):
    g = _gen(cuda, seed)
    logits = torch.randn((B, V), generator=g, device=cuda) * 3
    keys = torch.randint(-2**31, 2**31 - 1, (B, 2), generator=g, device=cuda, dtype=torch.int32)
    counts = torch.randint(0, 1000, (B,), generator=g, device=cuda, dtype=torch.int32)
    return logits, keys, counts


def _ulp_gap(scores):
    """The gap between each row's two best scores, in ulps of the best."""
    top = scores.topk(2, dim=-1).values
    best = top[:, 0].abs()
    return (top[:, 0] - top[:, 1]) / (torch.nextafter(best, best + 1) - best)


@pytest.mark.parametrize("B,V", [(8, 128256), (8, 49155), (1, 50280), (3, 1000)])
def test_sample_matches_plain_and_numpy_threefry(cuda, B, V):
    """The kernel's random bits are the plain version's and a numpy Threefry's
    exactly; its tokens equal the plain version's wherever the top two
    scores lie more than 4 ulps apart; a flipped key word changes the bits."""
    import numpy as np

    from repro_torch.kernels import sample as sample_k
    from repro_torch.serve import sampling

    logits, keys, counts = _sample_inputs(cuda, B, V)
    live = torch.ones(B, dtype=torch.int32, device=cuda)
    tok = torch.full((B,), -1, dtype=torch.int32, device=cuda)
    bits = torch.zeros((B, V), dtype=torch.int32, device=cuda)
    sample_k.sample(logits, keys, counts, live, tok, 0.7, bits=bits)
    torch.cuda.synchronize()
    sub = sampling.fold_in(keys, counts)
    want_bits = sampling.random_bits_32(sub, V)
    assert torch.equal(bits.long() & sampling.MASK, want_bits)
    k = keys.cpu().numpy().view(np.uint32)
    s0, s1 = _np_threefry(k[:, 0], k[:, 1], np.zeros(B, np.uint32),
                          counts.cpu().numpy().astype(np.uint32))
    i = np.arange(V, dtype=np.uint32)
    y0, y1 = _np_threefry(s0[:, None], s1[:, None], np.zeros_like(i), i)
    assert np.array_equal(bits.cpu().numpy().view(np.uint32), y0 ^ y1)
    scores = sampling.scores(keys, counts, logits, 0.7)
    want = torch.argmax(scores, dim=-1).to(torch.int32)
    clear = _ulp_gap(scores) > 4
    assert torch.equal(tok[clear], want[clear]) and bool(clear.any())
    flipped = keys.clone()
    flipped[:, 1] ^= 1
    fault_bits = torch.zeros_like(bits)
    sample_k.sample(logits, flipped, counts, live, tok.clone(), 0.7, bits=fault_bits)
    assert bool((fault_bits != bits).any(dim=-1).all())


def test_sample_splits_agree_and_dead_slots_keep_their_token(cuda):
    """Any split of the vocabulary gives the same tokens (the merge takes the
    maximum and the smaller index on ties); a slot whose live flag is 0
    keeps its token; one launch a call."""
    from repro_torch.kernels import sample as sample_k

    logits, keys, counts = _sample_inputs(cuda, 8, 128256, seed=1)
    logits[3, 100:200] = 50.0                      # a slot whose draw lies in one split
    live = torch.tensor([1, 0, 1, 1, 0, 1, 1, 1], dtype=torch.int32, device=cuda)
    outs = []
    for splits in (1, 2, 7, 33, 64):
        tok = torch.full((8,), -5, dtype=torch.int32, device=cuda)
        before = sample_k.launches
        sample_k.sample(logits, keys, counts, live, tok, 0.7, splits=splits)
        assert sample_k.launches == before + 1
        outs.append(tok)
    assert all(torch.equal(o, outs[0]) for o in outs)
    assert outs[0][1] == -5 and outs[0][4] == -5
    with pytest.raises(ValueError):
        sample_k.sample(logits, keys, counts, live, outs[0], 0.0)
    with pytest.raises(ValueError):
        sample_k.sample(logits, keys[:4], counts, live, outs[0], 0.7)
    with pytest.raises(TypeError):
        sample_k.sample(logits, keys, counts.long(), live, outs[0], 0.7)


def _small(kind, cuda):
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.models import build_model, init_params

    arch = "mamba2-780m" if kind == "ssm" else "llama3.2-1b"
    model = build_model(reduced(ARCHS[arch], layers=2, d_model=256, vocab=512), device=cuda)
    return model, init_params(model.param_specs(), 0, device=cuda)


def _serve(model, params, prompts, *, graphed=True, max_len=128, **kw):
    from repro_torch.serve.engine import ServeEngine

    with dispatch.use(prefer=dispatch.policy_from_flag("cuda-strict")):
        eng = ServeEngine(model, params, batch_slots=4, max_len=max_len, device=model.device,
                          **kw)
        # the eager loop, on the card for this comparison only
        eng._graphed = graphed
        for p in prompts:
            eng.submit(p, max_new_tokens=9)
        done = sorted(eng.run_to_completion(), key=lambda r: r.uid)
    return [r.generated for r in done], eng


_PROMPTS = [[3, 14, 15, 92, 65], [7, 8], list(range(1, 40)), [42], [5] * 17, [9, 9, 9]]


@pytest.mark.parametrize("temperature", [0.0, 0.7])
@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("kind", ["dense", "paged", "ssm"])
def test_graph_replays_equal_the_eager_loop_bitwise(cuda, kind, k, temperature):
    """The decode step as a replayed CUDA graph gives the eager loop's
    streams token for token (the same kernels on the same buffers), and its
    replays count as launches: each kernel's count equals the loop's."""
    from repro_torch.kernels import launch_counters

    model, params = _small(kind, cuda)
    kw = dict(decode_fusion=k, temperature=temperature, seed=3,
              paged=kind == "paged", page_size=16)
    counts = {}
    for graphed in (True, False):
        before = launch_counters()
        streams, eng = _serve(model, params, _PROMPTS, graphed=graphed, **kw)
        after = launch_counters()
        counts[graphed] = {key: after[key] - v for key, v in before.items()}
        if graphed:
            graphed_streams = streams
            assert eng._graph.captures == 1 and eng._graph.replays == eng.decode_calls - 1
        else:
            assert eng._graph is None
    assert graphed_streams == streams
    assert counts[True] == counts[False]
    assert all(len(s) == 9 for s in streams)


def test_graph_is_captured_on_the_hsa_worker_thread(cuda):
    """Routed through an HSA queue whose scheduler's worker thread runs the
    packets, the decode graph is captured and replayed there (thread-local
    capture), while this thread keeps launching a counted kernel of its
    own; the streams equal the direct run's, and the counters hold the
    other thread's launches and the engine's own, no more and no fewer."""
    import threading

    from repro_torch.core import hsa
    from repro_torch.core import ledger as L
    from repro_torch.core.reconfig import RegionManager
    from repro_torch.core.roles import RoleLibrary
    from repro_torch.kernels import matmul as mm

    model, params = _small("dense", cuda)
    # 512 cache rows: decode attention splits its keys, and keeps counters
    kw = dict(decode_fusion=4, temperature=0.7, max_len=512)
    want, direct = _serve(model, params, _PROMPTS, **kw)
    ledger = L.OverheadLedger()
    sched = hsa.Scheduler(RegionManager(1, ledger=ledger), RoleLibrary(ledger=ledger),
                          ledger=ledger)
    q = sched.add_queue(hsa.Queue(None, 64, name="tf-serving"))
    sched.start()
    stop, other = threading.Event(), []
    g = _gen(cuda, 12)
    x, w = _randn(g, (8, 512), cuda), _randn(g, (512, 512), cuda, 512 ** -0.5)

    def other_tenant():
        while not stop.is_set():
            other.append(float(mm.matmul(x, w).float().sum()))

    before = mm.launches
    t = threading.Thread(target=other_tenant)
    t.start()
    try:
        got, eng = _serve(model, params, _PROMPTS, hsa_queue=q, hsa_scheduler=sched, **kw)
    finally:
        stop.set()
        t.join()
        sched.stop()
    assert got == want and other
    assert eng._graph.captures == 1 and eng._graph.replays > 0
    assert eng._graph.captured_on != threading.main_thread().name
    calls = eng.prefill_calls + eng.chunk_calls + eng.fixup_calls + eng.decode_calls
    assert mm.launches - before == len(other) + 14 * calls
    # the two engines' graphs keep counter buffers of their own
    ours = {b.data_ptr() for b in eng._graph._tile_counters.values()}
    theirs = {b.data_ptr() for b in direct._graph._tile_counters.values()}
    assert ours and theirs and not ours & theirs


def test_a_fresh_thread_s_first_cuda_work_can_be_a_tensor_map_kernel(cuda):
    """A thread whose first CUDA work is a kernel that encodes tensor maps
    (the bf16 matmul on operands it has not seen) launches it: the encoder
    needs a current context, which no runtime call has bound there yet."""
    import threading

    from repro_torch.kernels import matmul as mm

    g = _gen(cuda, 11)
    pairs = [(_randn(g, (8, 512), cuda), _randn(g, (512, 512), cuda, 512 ** -0.5))
             for _ in range(2)]
    got, errors = [], []

    def first_work(x, w):
        try:
            got.append(mm.matmul(x, w))
        except Exception as e:  # noqa: BLE001  (reported below)
            errors.append(repr(e))

    for x, w in pairs:
        t = threading.Thread(target=first_work, args=(x, w))
        t.start()
        t.join()
    assert not errors
    for out, (x, w) in zip(got, pairs):
        _close(out, mm.plain_matmul(x, w), **BF16_TOL)


def test_engine_refuses_a_reallocated_captured_buffer(cuda):
    """Once the decode graph is captured, a cache replaced under it (as a
    re-zeroed cache for a new batch would be) makes the next launch raise
    instead of replaying into freed memory."""
    from repro_torch.serve.engine import ServeEngine

    model, params = _small("dense", cuda)
    with dispatch.use(prefer=dispatch.policy_from_flag("cuda-strict")):
        eng = ServeEngine(model, params, batch_slots=2, max_len=64, decode_fusion=2,
                          device=cuda)
        eng.submit([1, 2, 3], max_new_tokens=8)
        eng.step()
        eng.step()
        assert eng._graph.captures == 1
        eng._cache = {key: t.clone() for key, t in eng._cache.items()}
        with pytest.raises(RuntimeError, match="reallocated"):
            eng.step()


def test_graph_counts_each_kernel_once_a_replay(cuda):
    """A replay adds the capture's launches to every kernel counter: a
    dense step of a 2-layer model is 14 matmuls, 5 norms, 2 decode
    attentions and, sampling, one sample launch."""
    from repro_torch.kernels import launch_counters

    model, params = _small("dense", cuda)
    streams, eng = _serve(model, params, [[1, 2, 3]], decode_fusion=8, temperature=0.7)
    g = eng._graph
    assert g._counts == {("repro_torch.kernels.matmul", "launches"): 14,
                         ("repro_torch.kernels.rmsnorm", "launches"): 5,
                         ("repro_torch.kernels.decode_attention", "launches"): 2,
                         ("repro_torch.kernels.sample", "launches"): 1}
    eng._dec.step.zero_()              # the launch's first output row, as an upload sets it
    before = launch_counters()
    with dispatch.use(prefer=dispatch.policy_from_flag("cuda-strict")):
        g.run(3)                       # three replays: every slot is done, all masked
    after = launch_counters()
    assert g.captures == 1
    assert after[("matmul", "launches")] - before[("matmul", "launches")] == 42
    assert after[("sample", "launches")] - before[("sample", "launches")] == 3
    assert {k: after[k] - v for k, v in before.items() if after[k] != v} == {
        ("matmul", "launches"): 42, ("rmsnorm", "launches"): 15,
        ("decode_attention", "launches"): 6, ("sample", "launches"): 3}


# ---------------------------------------------------------------------------
# row invariance: a prompt row's result does not depend on how it was chunked
# ---------------------------------------------------------------------------

#: the (K, N) pairs the served models' prefills run: llama3.2-1b's four
#: weights, mamba2-780m's two
SERVED_KN = [(2048, 2048), (2048, 512), (2048, 8192), (8192, 2048), (1536, 6448), (3072, 1536)]


@pytest.mark.parametrize("k,n", SERVED_KN)
@pytest.mark.parametrize("activation", [None, "silu"])
def test_matmul_rows_bitwise_across_launch_rows(cuda, k, n, activation):
    """A row of x gives the same output bits in a launch of 1, 8, 16, 17,
    128 or 1024 rows, and under a permutation of the rows: the streaming
    kernel (M <= 16) and the tile kernel at every block and split sum a row's
    K in groups(N, K)'s one order."""
    g = _gen(cuda, 23)
    x, w = _randn(g, (1024, k), cuda), _randn(g, (k, n), cuda, scale=k ** -0.5)
    full = mm_k.matmul(x, w, activation=activation)
    kernels = set()
    for m in (1, 8, 16, 17, 128):
        kernels.add(mm_k.kernel_instance(x[:m], w))
        assert torch.equal(mm_k.matmul(x[:m], w, activation=activation), full[:m]), m
    perm = torch.randperm(1024, generator=g, device=cuda)
    assert torch.equal(mm_k.matmul(x[perm], w, activation=activation), full[perm])
    assert any("stream" in s for s in kernels) and any("tile" in s for s in kernels)


@pytest.mark.parametrize("d", [64, 128])
def test_flash_rows_bitwise_chunk_against_whole(cuda, d):
    """A chunk's queries (16 or 128 rows, starting at 0, 16, 128 or 512)
    against the keys up to its end give the whole prompt's rows bit for bit,
    whatever key split the launch takes."""
    g = _gen(cuda, 29)
    q = _randn(g, (1, 32, 1024, d), cuda)
    k, v = _randn(g, (1, 8, 1024, d), cuda), _randn(g, (1, 8, 1024, d), cuda)
    whole = fa_k.flash_attention(q, k, v, causal=True)
    for start in (0, 16, 128, 512):
        for size in (16, 128):
            end = start + size
            qc = q[:, :, start:end].contiguous()
            kc, vc = k[:, :, :end].contiguous(), v[:, :, :end].contiguous()
            for splits in (None, *range(1, fa_k.MAX_SPLITS + 1)):
                got = fa_k.flash_attention(qc, kc, vc, causal=True, splits=splits)
                assert torch.equal(got, whole[:, :, start:end]), (start, size, splits)


def test_chunked_prefill_rows_bitwise_at_full_width(cuda):
    """llama3.2-1b at full width and 2 layers: a 600-token prompt (the 1024
    bucket) prefilled whole and in 128-, 64- and 16-row chunks writes the
    same k/v cache rows and gives the same last-row logits, bit for bit."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models import build_model, init_params

    model = build_model(dataclasses.replace(get_arch("llama3.2-1b"), num_layers=2), device=cuda)
    params = init_params(model.param_specs(), 0, device=cuda)
    tokens = torch.zeros((1, 1024), dtype=torch.long, device=cuda)
    tokens[0, :600] = torch.randint(0, model.cfg.vocab_size, (600,), generator=_gen(cuda, 31),
                                    device=cuda)
    specs = model.cache_specs(1, 1024)
    with dispatch.use(prefer=dispatch.policy_from_flag("cuda-strict")):
        want, cache = model.prefill(params, {"tokens": tokens}, cache_len=1024)
        for chunk in (128, 64, 16):
            staging = {key: torch.zeros(specs[key].shape, dtype=specs[key].dtype, device=cuda)
                       for key in ("k", "v")}
            for start in range(0, 1024, chunk):
                got, _ = model.prefill_chunk(params, tokens[:, start:start + chunk], staging,
                                             start=start)
            for key in ("k", "v"):
                assert torch.equal(staging[key][:, :, :, :600], cache[key][:, :, :, :600]), chunk
            assert torch.equal(got, want), chunk


@pytest.mark.parametrize("T", [1024, 608])
def test_decode_rows_bitwise_across_the_batch(cuda, T):
    """A sequence's decode attention gives the same bits in a launch of 16
    sequences, of 8 and alone, dense and paged: the split count follows the
    cache's rows, never the batch (an 8-slot and a 16-slot engine give a
    request the same tokens)."""
    g = _gen(cuda, 37)
    B = 16
    lengths = torch.tensor([1 + (67 * i) % T for i in range(B)], dtype=torch.int32, device=cuda)
    q = _randn(g, (B, 32, 64), cuda)
    kp, vp, table = _paged_pool(g, cuda, B, 16, T=T)
    kc, vc = gather_kv_pages(kp, table), gather_kv_pages(vp, table)
    full = dec_k.decode_attention(q, kc, vc, lengths)
    assert torch.equal(paged_k.paged_decode_attention(q, kp, vp, table, lengths), full)
    for n in (8, 1):
        assert torch.equal(dec_k.decode_attention(q[:n], kc[:n], vc[:n], lengths[:n]), full[:n])
        assert torch.equal(paged_k.paged_decode_attention(q[:n], kp, vp, table[:n], lengths[:n]),
                           full[:n])


def _paged_engine(model, params, **kw):
    from repro_torch.core.policy import PreemptionPolicy
    from repro_torch.serve.engine import ServeEngine

    kw.setdefault("preemption", PreemptionPolicy(snapshot_threshold_tokens=0))
    return ServeEngine(model, params, batch_slots=4, max_len=128, paged=True, page_size=16,
                       decode_fusion=2, device=model.device, **kw)


def _finish(eng):
    return [r.generated for r in sorted(eng.run_to_completion(), key=lambda r: r.uid)]


def test_snapshot_round_trips_bitwise_into_a_pool_a_decode_graph_holds(cuda):
    """``gather_pages`` copies a victim's pages off the card bit for bit,
    ``restore_pages`` writes them back into other pages of the pool in
    place (the captured decode graph keeps its pool: no second capture),
    and the streams after the restore equal the unparked run's."""
    from repro_torch.serve import paged

    model, params = _small("dense", cuda)
    with dispatch.use(prefer=dispatch.policy_from_flag("cuda-strict")):
        want = _finish(_submit(_paged_engine(model, params)))
        eng = _submit(_paged_engine(model, params))
        for _ in range(3):
            eng.step()
        assert eng._graph is not None and eng._graph.captures == 1
        pool_ptrs = [t.data_ptr() for t in eng._cache.values()]
        slot, req = next(iter(eng._active.items()))
        keep = paged.pages_for(int(eng._pos[slot]), 16)
        pages = eng._table[slot, :keep].copy()
        before = {k: v[:, torch.as_tensor(pages, device=cuda).long()].clone()
                  for k, v in eng._cache.items()}
        eng.preempt(req.uid)
        snap = eng.arena.load(req.uid)
        for key in ("k", "v"):
            assert snap[key].device.type == "cpu" and snap[key].is_pinned()
            assert torch.equal(snap[key], before[key].cpu())
        # a round trip of its own into free pages of the same pool
        free = [p for p in range(1, eng.pool_pages) if eng.allocator.owner_of(p) is None]
        dest = free[:keep]
        paged.restore_pages(eng._cache, snap, dest)
        for key in ("k", "v"):
            assert torch.equal(eng._cache[key][:, torch.as_tensor(dest, device=cuda).long()],
                               before[key])
        got = _finish(eng)
        assert eng._graph.captures == 1
        assert [t.data_ptr() for t in eng._cache.values()] == pool_ptrs
    assert got == want
    assert eng.resumes == eng.preemptions == 1 and eng.refills == 1


def _submit(eng, prompts=None):
    for p in prompts or _PROMPTS:
        eng.submit(p, max_new_tokens=9)
    return eng


def test_parked_pages_overwritten_by_another_prefill_resume_unchanged(cuda):
    """A victim's freed pages are written over by another prompt's prefill
    (scattered into exactly those pages) before it resumes from its
    snapshot: the snapshot left the card before the pages were freed, so
    its stream is unchanged."""
    from repro_torch.serve import paged

    model, params = _small("dense", cuda)
    with dispatch.use(prefer=dispatch.policy_from_flag("cuda-strict")):
        want = _finish(_submit(_paged_engine(model, params)))
        eng = _submit(_paged_engine(model, params))
        for _ in range(3):
            eng.step()
        slot, req = next(iter(eng._active.items()))
        freed = [int(p) for p in eng._table[slot, :int(eng._mapped[slot])]]
        eng.preempt(req.uid)
        other = torch.arange(1, 16 * len(freed) + 1, device=cuda)[None] % 500
        _, cache = model.prefill(params, {"tokens": other}, cache_len=16 * len(freed))
        paged.scatter_prefill(eng._cache, cache, freed, 16)
        got = _finish(eng)
    assert got == want
    assert eng.refills == 1


def test_refill_copied_up_ahead_lands_bitwise_and_a_demotion_cancels_it(cuda):
    """The pump copies a parked snapshot up to the card on the side stream
    ahead of its resume (the staged tensors hold the snapshot's bits); the
    resume lands them and the streams equal the unparked run's, with the
    copy's bytes and seconds read off its events.  With room for one
    snapshot, a second park demotes the first: its copy up is dropped."""
    model, params = _small("dense", cuda)
    with dispatch.use(prefer=dispatch.policy_from_flag("cuda-strict")):
        want = _finish(_submit(_paged_engine(model, params)))

        def parked_two(budget=None):
            eng = _submit(_paged_engine(model, params, host_budget_bytes=budget))
            for _ in range(3):
                eng.step()
            a, b = [r.uid for r in eng._active.values()][:2]
            eng.preempt(a)
            with eng._lock:
                eng._pump_refills()
            entry = eng._parked[0]
            sizes = [eng.arena.bytes_of(a)]
            return eng, entry, b, sizes

        eng, entry, _, _ = parked_two()
        assert entry.staged is not None and entry.refill is not None
        entry.staged.done.synchronize()
        snap = eng.arena.load(entry.req.uid)
        for key in ("k", "v"):
            assert entry.staged.tensors[key].device.type == "cuda"
            assert torch.equal(entry.staged.tensors[key].cpu(), snap[key])
        got = _finish(eng)
        stats = eng.copy_stats
        assert got == want
        assert stats["h2d_bytes"] == stats["d2h_bytes"] > 0 and stats["h2d_s"] > 0
        assert stats["h2d_cancelled"] == 0 and eng.refills == 1

        probe, _, b, sizes = parked_two()
        probe.preempt(b)
        sizes.append(probe.arena.bytes_of(b))
        eng, entry, b, _ = parked_two(budget=max(sizes))
        staged = entry.staged
        assert staged is not None
        eng.preempt(b)                  # b's spill evicts a's snapshot and its copy up
        assert entry.staged is None and entry.refill is None
        assert eng.demotions == 1 and eng._xfer.cancelled == 1
        got = _finish(eng)
        assert got == want
        assert eng.copy_stats["h2d_cancelled"] == 1
        del probe, staged


def test_granite_unembed_rows_are_bitwise_across_m(cuda):
    """granite's unembed on the edge kernel (N = 49155), f32 out: a row's
    bits are the same alone, in the 8 rows of a decode step and in 16."""
    g = _gen(cuda, 21)
    x, w = _randn(g, (16, 4096), cuda), _randn(g, (4096, 49155), cuda, 4096 ** -0.5)
    full = mm_k.matmul(x, w, out_dtype=torch.float32)
    assert not mm_k.tma_ready(x, w)
    for m in (1, 8):
        assert torch.equal(mm_k.matmul(x[:m], w, out_dtype=torch.float32), full[:m])
    for i in range(16):
        assert torch.equal(mm_k.matmul(x[i:i + 1], w, out_dtype=torch.float32), full[i:i + 1])


def test_reprefill_replay_at_yi_9b_width(cuda):
    """yi-9b at full width and 2 layers, chunked (128-row chunks), K = 4,
    as graphs: every request is parked once mid-decode for re-prefill (a
    whole-prompt prefill, then its committed tokens regenerated in another
    batch and checked token by token by the engine), and the streams equal
    the unparked run's."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.core.policy import AdmissionPolicy, PreemptionPolicy
    from repro_torch.models import build_model, init_params
    from repro_torch.serve.engine import ServeEngine

    model = build_model(dataclasses.replace(get_arch("yi-9b"), num_layers=2), device=cuda)
    params = init_params(model.param_specs(), 0, device=cuda)
    gen = torch.Generator().manual_seed(4)
    prompts = [torch.randint(0, 64000, (n,), generator=gen).tolist()
               for n in (5, 37, 130, 300, 260, 9)]

    def serve(parked: bool):
        eng = ServeEngine(model, params, batch_slots=4, max_len=512, paged=True, page_size=16,
                          prefill_chunk=128, decode_fusion=4, device=cuda,
                          admission=AdmissionPolicy(growth_reserve=0.5),
                          preemption=PreemptionPolicy(allow_snapshot=False))
        for p in prompts:
            eng.submit(p, max_new_tokens=12)
        done, seen = [], set()
        while len(done) < len(prompts):
            done += eng.step()
            if parked:
                for r in list(eng._active.values()):
                    if r.uid not in seen and len(r.generated) >= 5:
                        seen.add(r.uid)
                        eng.preempt(r.uid)
        return [r.generated for r in sorted(done, key=lambda r: r.uid)], eng

    with dispatch.use(prefer=dispatch.policy_from_flag("cuda-strict")):
        want, _ = serve(False)
        got, eng = serve(True)
    assert got == want
    assert eng.preemptions >= len(prompts) and eng.recompute_tokens > 0
    assert eng._graph is not None and eng._graph.captures == 1
