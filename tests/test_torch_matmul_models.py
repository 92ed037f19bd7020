"""Models of the matmul kernels' arithmetic and addressing, on the CPU.

The f32 kernel computes an f32 product on the tensor cores by error-
compensated TF32 ("3xTF32"): each operand split into a TF32 part and a TF32
remainder by clearing the low 13 mantissa bits, three TF32 products summed
in f32.  ``matmul.matmul_3xtf32`` is that arithmetic in plain PyTorch; here
it is held to the JAX package's Pallas matmul (interpret mode, as
``tests/test_kernels.py`` runs it) and to the f32 oracle within 2e-4, the
tolerance the JAX package holds its f32 matmul to.

The bf16 edge kernels read a weight whose rows are not 16-byte aligned (an
odd N).  Where K is a multiple of 8, TMA reads it as [K/8, 8N] "superrows"
(16N bytes apart), which gives each 64-row slice's rows permuted;
``_superrow_stage`` models those boxes, and the stages' products, x's tile
permuted to match, must sum to x w.  Otherwise the kernel fetches each row
as the aligned superset of its bytes, in 16-byte words that stop at the last
one starting inside the tensor, and shifts it by the row's byte offset;
``_edge_rows`` models that copy and shift with numpy on the tensor's bytes
laid out as in memory, and the strip it rebuilds must equal the weight's,
exactly, for every strip (the right edge included) at the untied unembeds'
N.  The same for x's rows.  This file's JAX import is only the Pallas
reference.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels  # noqa: F401  (registration)
from repro.kernels import ops as jops
from repro_torch.kernels import matmul as mm_k
from repro_torch.kernels import native, ref

TOL_F32 = dict(rtol=2e-4, atol=2e-4)


# ---------------------------------------------------------------------------
# 3xTF32
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scale", [1e-3, 1.0, 1e3])
def test_split_tf32_parts_are_tf32_and_sum_to_the_value(scale):
    """big and small keep no bit of the low 13 mantissa bits, big + small is
    the value to within 2^-21 of it, and big is the value with those bits
    cleared."""
    a = torch.from_numpy(np.random.default_rng(0).normal(size=4096).astype(np.float32) * scale)
    big, small = mm_k.split_tf32(a)
    low = (1 << 13) - 1
    assert not (big.view(torch.int32) & low).any() and not (small.view(torch.int32) & low).any()
    assert torch.equal(big.view(torch.int32), a.view(torch.int32) & ~low)
    rest = (a.double() - big.double() - small.double()).abs()
    assert bool((rest <= 2.0 ** -21 * a.double().abs()).all())


@pytest.mark.parametrize("activation", [None, "silu", "gelu"])
@pytest.mark.parametrize("m,k,n", [(64, 256, 64), (64, 2048, 64), (256, 256, 256)])
def test_3xtf32_model_matches_pallas_and_the_oracle(m, k, n, activation):
    """The f32 kernel's arithmetic against JAX's pallas_matmul (interpret)
    and the f32 oracle at K = 256 and 2048, unscaled normal inputs (outputs
    up to about 4 sqrt(K)), within 2e-4; plain TF32 misses by far."""
    rng = np.random.default_rng(m + k + n)
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = rng.normal(size=(k, n)).astype(np.float32)
    got = mm_k.matmul_3xtf32(torch.from_numpy(x), torch.from_numpy(w), activation=activation)
    want = np.asarray(jops.pallas_matmul(jnp.asarray(x), jnp.asarray(w), activation=activation,
                                         interpret=True))
    np.testing.assert_allclose(got.numpy(), want, **TOL_F32)
    oracle = ref.matmul(torch.from_numpy(x), torch.from_numpy(w), activation=activation)
    torch.testing.assert_close(got, oracle, **TOL_F32)
    tf32 = [mm_k.split_tf32(torch.from_numpy(a))[0] for a in (x, w)]
    plain_tf32 = ref.epilogue(torch.matmul(*tf32), activation)
    assert float((plain_tf32 - oracle).abs().max()) > 100 * TOL_F32["atol"]


def test_f32_plan_picks_a_tile_and_leaves_no_split_empty():
    """f32_plan: the streaming kernel (block 0) at M up to 16, with the
    edge kernel's split rule over 64-column strips; else a 128 tile where
    there are 32 such tiles, else 64, the choices the card's timings
    favoured at the square shapes.  Every split of the slices (64-deep when
    streaming, else 32) is non-empty (the C side refuses others), one where
    the tiles fill the card."""
    assert [mm_k.f32_plan(s, s, s) for s in (256, 512, 1024, 2048)] == [
        (64, 4), (64, 2), (128, 2), (128, 1)]
    assert [mm_k.f32_plan(8, n, k) for k, n in ((4096, 49155), (1600, 32001),
                                                (1280, 51866))] == [(0, 1)] * 3
    assert mm_k.f32_plan(8, 3000, 4096) == (0, mm_k.edge_splits(8, 3000, 4096, 64))
    for m, k, n in [(256, 256, 256), (2048, 2048, 2048), (8, 4096, 49155), (100, 260, 132),
                    (1, 64, 8), (1000, 2047, 1000), (129, 33, 17), (512, 512, 512),
                    (16, 4096, 3000), (17, 300, 40)]:
        block, s = mm_k.f32_plan(m, n, k)
        kt = -(-k // (mm_k.BK if block == 0 else mm_k.F32_BK))
        per = -(-kt // s)
        assert (block == 0) == (m <= mm_k.STREAM_MAX_M)
        assert block in (0, *mm_k.F32_BLOCKS) and 1 <= s <= kt and -(-kt // per) == s
        tiles = -(-n // mm_k.F32_STREAM_BN) if block == 0 else -(-m // block) * -(-n // block)
        assert s == 1 or tiles < 2 * native.sm_count()


# ---------------------------------------------------------------------------
# the bf16 edge kernel's copy and realign
# ---------------------------------------------------------------------------


def _memory(values: np.ndarray, base: int) -> tuple[np.ndarray, int]:
    """``values`` (uint16) as bytes at byte offset ``base`` of a buffer that
    runs to the 16-byte chunk holding its last byte (an allocation's whole
    chunk), the bytes around it a pattern no value takes here."""
    size = base + 2 * values.size
    buf = np.full(-(-size // 16) * 16, 0xFF, dtype=np.uint8)
    buf[base:size] = values.view(np.uint8)
    return buf, size


def _edge_rows(buf: np.ndarray, base: int, end: int, row_start: np.ndarray, words: int,
               width: int) -> tuple[np.ndarray, np.ndarray]:
    """The kernel's copy and realign of rows whose first value is element
    ``row_start`` (a vector) of a bf16 tensor at byte ``base`` of ``buf``
    ending at byte ``end``: ``words`` 16-byte words from the 16-byte aligned
    address at or below each row's first byte, a word that starts at or past
    ``end`` landing as zeros, then ``width`` values from the row's offset.
    Returns the rows [len(row_start), width] (uint16) and the byte ranges of
    the words read."""
    addr = base + 2 * row_start
    a0 = addr & ~15
    starts = a0[:, None] + 16 * np.arange(words)[None, :]               # word starts
    read = starts < end
    idx = starts[:, :, None] + np.arange(16)[None, None, :]
    raw = np.where(read[:, :, None], buf[np.minimum(idx, buf.size - 1)], 0).astype(np.uint8)
    raw = raw.reshape(len(row_start), 16 * words)
    sh = (addr & 15)[:, None] + np.arange(2 * width)[None, :]
    rows = np.take_along_axis(raw, sh, axis=1).copy().view(np.uint16)
    return rows, starts[read]


@pytest.mark.parametrize("base", [0, 2, 14])
@pytest.mark.parametrize("n", [49155, 32001, 51866, 131])
def test_edge_copy_rebuilds_every_strip_of_w_exactly(n, base):
    """Every 128-column strip of w [K, N] (the last one ragged) rebuilt from
    the flat buffer by the kernel's aligned supersets equals w's strip in
    its columns below N, for rows at every offset 0..7 and w itself 0, 2 or
    14 bytes past a 16-byte boundary; and every word read starts inside the
    buffer's chunks, none at or past the tensor's end."""
    K, bn = 21, mm_k.EDGE_BN
    words = bn // 8 + 1
    w = np.random.default_rng(n + base).integers(0, 0x7F00, size=(K, n), dtype=np.uint16)
    buf, end = _memory(w.ravel(), base)
    for n0 in range(0, n, bn):
        rows, starts = _edge_rows(buf, base, end, np.arange(K) * n + n0, words, bn)
        cols = min(bn, n - n0)
        np.testing.assert_array_equal(rows[:, :cols], w[:, n0:n0 + cols])
        assert starts.min() >= base & ~15 and starts.max() < end


@pytest.mark.parametrize("base", [0, 2])
@pytest.mark.parametrize("m,k", [(8, 4096), (16, 1600), (1, 1280), (5, 4099), (3, 37)])
def test_edge_copy_rebuilds_x_and_the_kernel_masks_past_k(m, k, base):
    """x [M, K]'s 64-value slices rebuilt the same way (nine words a row)
    equal x's where k < K; past K the kernel zeroes what was read."""
    x = np.random.default_rng(m * k + base).integers(0, 0x7F00, size=(m, k), dtype=np.uint16)
    buf, end = _memory(x.ravel(), base)
    for k0 in range(0, k, mm_k.BK):
        rows, starts = _edge_rows(buf, base, end, np.arange(m) * k + k0, mm_k.BK // 8 + 1,
                                  mm_k.BK)
        valid = min(mm_k.BK, k - k0)
        np.testing.assert_array_equal(rows[:, :valid], x[:, k0:k0 + valid])
        assert starts.min() >= base & ~15 and starts.max() < end


def _superrow_stage(w: np.ndarray, k0: int, n0: int, bn: int) -> np.ndarray:
    """The TMA edge kernel's w tile of the 64-row stage at k0, strip n0: w
    viewed as [K/8][8N] superrows, box r (8 superrows from k0 / 8, columns
    r N + n0 ..) as tile rows 8r .. 8r + 7, zeros past the view."""
    K, N = w.shape
    view = w.reshape(K // 8, 8 * N)
    tile = np.zeros((64, bn), dtype=w.dtype)
    for r in range(8):
        for i in range(8):
            q, c0 = k0 // 8 + i, r * N + n0
            if q < K // 8:
                cols = view[q, c0:c0 + bn]
                tile[8 * r + i, :cols.size] = cols
    return tile


@pytest.mark.parametrize("n", [49155, 32001, 51866, 131])
def test_superrow_view_gives_the_strip_with_rows_permuted(n):
    """The TMA edge kernel's stage tiles, from the [K/8, 8N] view of w, hold
    row 8i + r of each 64-row slice at tile row 8r + i, exactly, in the
    strip's columns below N; x's tile takes the same permutation, so the
    stages' products sum to x w.  K = 200: a last slice of 8 rows past the
    view's end reads zeros."""
    K, bn = 200, mm_k.STREAM_BN
    rng = np.random.default_rng(n)
    w = rng.integers(-8, 8, size=(K, n)).astype(np.int64)
    x = rng.integers(-8, 8, size=(3, K)).astype(np.int64)
    perm = np.array([8 * (t % 8) + t // 8 for t in range(64)])     # tile row t -> slice row
    strips = list(range(0, n, bn))
    for n0 in strips[:3] + strips[-2:]:
        cols = min(bn, n - n0)
        acc = np.zeros((3, bn), dtype=np.int64)
        for k0 in range(0, K, 64):
            tile = _superrow_stage(w, k0, n0, bn)
            rows = k0 + perm
            valid = rows < K
            np.testing.assert_array_equal(tile[valid, :cols], w[rows[valid], n0:n0 + cols])
            assert not tile[~valid].any()
            xt = np.where(valid, x[:, np.minimum(rows, K - 1)], 0)   # x's tile, same order
            acc += xt @ tile
        np.testing.assert_array_equal(acc[:, :cols], x @ w[:, n0:n0 + cols])


def test_edge_plan_picks_the_tma_kernel_for_the_unembeds():
    """K a multiple of 8 and w aligned: the edge kernel's TMA copy; K = 4099
    or w misaligned: its cp.async copy; both with edge_splits' split; M > 16:
    the mma.sync kernel."""
    for k, n in ((4096, 49155), (1600, 32001), (1280, 51866)):
        assert mm_k.edge_plan(8, n, k, True) == (2, mm_k.edge_splits(8, n, k))
        assert mm_k.edge_plan(8, n, k, False) == (1, mm_k.edge_splits(8, n, k))
    assert mm_k.edge_plan(8, 131, 4099, True)[0] == 1
    assert mm_k.edge_plan(17, 49155, 4096, True) == (0, 1)


def test_edge_split_rule_at_the_unembeds():
    """Two splits for granite's 385 strips (2.9 waves of half strips instead
    of 1.5 of whole ones), one for hymba's 251 and whisper's 406; many where
    the strips are few; never an empty split; 1 above M = 16 (the mma.sync
    edge kernel)."""
    assert [mm_k.edge_splits(8, n, k) for k, n in ((4096, 49155), (1600, 32001),
                                                    (1280, 51866))] == [2, 1, 1]
    assert mm_k.edge_splits(17, 49155, 4096) == 1
    for m, k, n in [(8, 4099, 131), (1, 4096, 517), (16, 1600, 1001), (5, 8192, 2049),
                    (8, 36, 49), (1, 64, 8)]:
        s = mm_k.edge_splits(m, n, k)
        kt = -(-k // mm_k.BK)
        assert 1 <= s <= kt and -(-kt // -(-kt // s)) == s
    assert mm_k.edge_splits(8, 131, 4099) > 1


@pytest.mark.parametrize("dtype,m,k,n,x_off,w_off,instance", [
    (torch.bfloat16, 8, 2048, 8192, 0, 0, "mm_stream_kernel<8>"),
    (torch.bfloat16, 16, 2048, 8192, 0, 0, "mm_stream_kernel<16>"),
    (torch.bfloat16, 8, 4096, 49155, 0, 0, "mm_edge_stream_kernel<8,1>"),
    (torch.bfloat16, 16, 1600, 32001, 0, 0, "mm_edge_stream_kernel<16,1>"),
    (torch.bfloat16, 8, 2048, 512, 1, 0, "mm_edge_stream_kernel<8,1>"),
    (torch.bfloat16, 8, 4096, 49155, 0, 1, "mm_edge_stream_kernel<8,0>"),
    (torch.bfloat16, 16, 1280, 51866, 0, 1, "mm_edge_stream_kernel<16,0>"),
    (torch.bfloat16, 5, 1599, 32001, 0, 0, "mm_edge_stream_kernel<8,0>"),
    (torch.bfloat16, 17, 4096, 49155, 0, 0, "mm_edge_kernel"),
    (torch.bfloat16, 64, 1280, 51866, 0, 0, "mm_edge_kernel"),
    (torch.float32, 256, 256, 256, 0, 0, "mm_f32_kernel<1,64,64>"),
    (torch.float32, 2048, 2048, 2048, 0, 0, "mm_f32_kernel<1,128,128>"),
    (torch.float32, 8, 4096, 49155, 0, 0, "mm_f32_stream_kernel<8,1>"),
    (torch.float32, 16, 1280, 51866, 0, 0, "mm_f32_stream_kernel<16,1>"),
    (torch.float32, 8, 1600, 32001, 0, 1, "mm_f32_stream_kernel<8,0>"),
    (torch.float32, 16, 1599, 32001, 0, 0, "mm_f32_stream_kernel<16,0>"),
    (torch.float32, 64, 4096, 49155, 0, 0, "mm_f32_kernel<0,128,128>"),
    (torch.float32, 255, 257, 255, 0, 0, "mm_f32_kernel<0,64,64>"),
])
def test_kernel_instance_names_what_the_c_entries_launch(dtype, m, k, n, x_off, w_off, instance):
    """The instance ``kernel_instance`` names for the kernel phase's shapes
    and operands (offsets in elements past a 16-byte boundary), by the C
    entries' rules: bf16 TMA-ready operands take ``plan``'s kernel; the edge
    kernels' TMA instances need K a multiple of 8 (f32: 4) and w aligned,
    x's alignment aside; M above 16 takes the mma.sync edge kernel, or in
    f32 the tile kernel's edge instance at ``f32_plan``'s tile."""
    buf = torch.empty(64, dtype=dtype)
    x = buf.as_strided((m, k), (0, 0), x_off)
    w = buf.as_strided((k, n), (0, 0), w_off)
    assert mm_k.kernel_instance(x, w) == instance
