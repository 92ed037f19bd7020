"""``kernels/matmul.py`` ``plan(M, N, K)``: which bf16 kernel, block and K
split each shape takes.  A pure function of the shape, so it is tested here
on the CPU, at every shape ``chip_smoke.py`` times and at ragged ones; the
card tests (``tests/test_torch_cuda.py``) hold the kernels it picks to the
plain version.  This file imports no JAX.
"""

from __future__ import annotations

import math

import pytest

from repro_torch.kernels import matmul as mm
from repro_torch.kernels import native

# (M, K, N): llama3.2-1b's four weights at the serve runs' row counts, and
# mamba2-780m's two at its own; then ragged shapes
SERVE = [(M, K, N) for M in (1, 8, 16, 64, 128, 256, 512, 1024)
         for K, N in ((2048, 2048), (2048, 512), (2048, 8192), (8192, 2048))]
SERVE += [(M, K, N) for M in (3, 5, 8, 37, 45, 600) for K, N in ((1536, 6448), (3072, 1536))]
SHAPES = SERVE + [(100, 136, 256), (1, 8, 64)]


def _alternatives(M: int, N: int, K: int) -> list[mm.Plan]:
    """Every plan the C side takes for this shape, written out apart from
    ``plan``'s own search."""
    kt = math.ceil(K / mm.BK)
    if M <= mm.STREAM_MAX_M:
        rows = min(r for r in mm.STREAM_ROWS if r >= M)
        blocks = [("stream", rows, mm.STREAM_BN, math.ceil(N / mm.STREAM_BN))]
    else:
        blocks = [("tile", bm, bn, math.ceil(M / bm) * math.ceil(N / bn))
                  for bm, bn in mm.TILE_SHAPES]
    return [mm.Plan(kernel, bm, bn, s, math.ceil(kt / s), tiles)
            for kernel, bm, bn, tiles in blocks
            for s in range(1, kt + 1) if math.ceil(kt / math.ceil(kt / s)) == s]


@pytest.mark.parametrize("M,K,N", SHAPES)
def test_plan_picks_a_kernel_and_block_the_c_side_takes(M, K, N):
    p = mm.plan(M, N, K)
    if M <= mm.STREAM_MAX_M:
        assert p.kernel == "stream" and p.block_n == mm.STREAM_BN
        assert p.block_m == min(r for r in mm.STREAM_ROWS if r >= M)
        assert p.tiles == math.ceil(N / mm.STREAM_BN)
    else:
        assert p.kernel == "tile" and (p.block_m, p.block_n) in mm.TILE_SHAPES
        assert p.tiles == math.ceil(M / p.block_m) * math.ceil(N / p.block_n)
    assert p.blocks == p.tiles * p.splits
    fp = mm.footprint(p=p)
    assert 0 < fp.smem_bytes <= 232448 and fp.threads in (160, 256, 384)


@pytest.mark.parametrize("M,K,N", SHAPES)
def test_plan_splits_are_all_non_empty(M, K, N):
    p = mm.plan(M, N, K)
    kt = math.ceil(K / mm.BK)
    assert 1 <= p.splits <= kt
    assert p.per_split == math.ceil(kt / p.splits)       # what the C side computes
    assert (p.splits - 1) * p.per_split < kt <= p.splits * p.per_split


@pytest.mark.parametrize("M,K,N", SHAPES)
def test_plan_is_least_cost_and_fills_the_card_where_k_allows(M, K, N):
    """The plan is the cheapest alternative by the cost model fitted to the
    card's timings; where it leaves more than half the SMs without a block,
    every alternative with more blocks (a wider split, a smaller block) is
    estimated slower: the split's workspace traffic outweighs what the
    blocks would add."""
    p = mm.plan(M, N, K)
    alts = _alternatives(M, N, K)
    assert p in alts
    assert all(mm.cost(M, N, K, p) <= mm.cost(M, N, K, a) * (1 + 1e-9) for a in alts)
    if p.blocks < native.sm_count() // 2:
        more = [a for a in alts if a.blocks > p.blocks]
        assert all(mm.cost(M, N, K, a) > mm.cost(M, N, K, p) for a in more)


@pytest.mark.parametrize("M,K,N", SHAPES)
def test_plan_gives_the_same_answer_on_every_call(M, K, N):
    first = mm.plan(M, N, K)
    mm.plan.cache_clear()
    assert mm.plan(M, N, K) == first and mm.plan(M, N, K) is mm.plan(M, N, K)


# measured on the card (PERF.md, the sweep of matmul_sweep.py): what the
# serve runs' headline shapes take
@pytest.mark.parametrize("M,K,N,want", [
    (8, 2048, 8192, ("stream", 8, 128, 1)),          # decode gate/up: streams, no split
    (8, 8192, 2048, ("stream", 8, 128, 4)),          # decode down: K split in four
    (1, 2048, 512, ("stream", 8, 128, 8)),           # fixup k/v: eight splits, one launch
    (1024, 2048, 8192, ("tile", 128, 256, 1)),       # prefill gate/up
    (1024, 8192, 2048, ("tile", 128, 128, 1)),       # prefill down
    (600, 1536, 6448, ("tile", 128, 256, 1)),        # mamba2 in_proj
    (600, 3072, 1536, ("tile", 128, 64, 1)),         # mamba2 out_proj
    (37, 3072, 1536, ("tile", 64, 64, 4)),           # past the A/B boundary
])
def test_plan_at_the_headline_shapes(M, K, N, want):
    p = mm.plan(M, N, K)
    assert (p.kernel, p.block_m, p.block_n, p.splits) == want


@pytest.mark.parametrize("M,K,N", [(8, 2044, 512), (8, 2048, 500), (1, 4, 64), (3, 12, 12)])
def test_plan_refuses_k_or_n_not_a_multiple_of_8(M, K, N):
    with pytest.raises(ValueError, match="multiples of 8"):
        mm.plan(M, N, K)
