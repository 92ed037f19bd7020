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
    """Every plan the C side takes for this shape in ``groups(N, K)``'s sum
    order, written out apart from ``plan``'s own search: one K group a
    block (the streaming kernel; the tile kernel at any block), or the
    tile kernel unsplit with a running total (not at 128 x 256, unless K is
    one group)."""
    kt = math.ceil(K / mm.BK)
    g, per = mm.groups(N, K)
    if M <= mm.STREAM_MAX_M:
        rows = min(r for r in mm.STREAM_ROWS if r >= M)
        return [mm.Plan("stream", rows, mm.STREAM_BN, g, per, math.ceil(N / mm.STREAM_BN))]
    out = [mm.Plan("tile", bm, bn, g, per, math.ceil(M / bm) * math.ceil(N / bn))
           for bm, bn in mm.TILE_SHAPES]
    out += [mm.Plan("tile", bm, bn, 1, kt, math.ceil(M / bm) * math.ceil(N / bn))
            for bm, bn in mm.TILE_SHAPES if g == 1 or bn < 256]
    return out


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
    (37, 3072, 1536, ("tile", 64, 64, 5)),           # past the A/B boundary: a block a K group
])
def test_plan_at_the_headline_shapes(M, K, N, want):
    p = mm.plan(M, N, K)
    assert (p.kernel, p.block_m, p.block_n, p.splits) == want


@pytest.mark.parametrize("M,K,N", [(8, 2044, 512), (8, 2048, 500), (1, 4, 64), (3, 12, 12)])
def test_plan_refuses_k_or_n_not_a_multiple_of_8(M, K, N):
    with pytest.raises(ValueError, match="multiples of 8"):
        mm.plan(M, N, K)


# the served (K, N) pairs: llama3.2-1b's four weights, mamba2-780m's two,
# granite-3-8b's four
SERVED_KN = [(2048, 2048), (2048, 512), (2048, 8192), (8192, 2048), (1536, 6448), (3072, 1536),
             (4096, 4096), (4096, 1024), (4096, 12800), (12800, 4096)]


@pytest.mark.parametrize("K,N", SERVED_KN)
def test_a_rows_k_order_is_the_same_for_every_m(K, N):
    """A row's K is summed in the same ranges, in the same order, whatever
    rows its launch carries: a decode step, a chunk of 16 to 128 rows and a
    whole 1024-row bucket give a prompt row the same bits."""
    orders = {M: mm.row_order(M, N, K) for M in (1, 3, 8, 16, 17, 37, 64, 128, 256, 600, 1024)}
    g, per = mm.groups(N, K)
    want = tuple((i * mm.BK, min(K, (i + per) * mm.BK)) for i in range(0, math.ceil(K / mm.BK),
                                                                       per))
    assert len(want) == g and want[-1][1] == K
    assert all(order == want for order in orders.values()), orders


@pytest.mark.parametrize("K,N", SERVED_KN)
def test_groups_are_the_decode_split_and_every_plan_keeps_them(K, N):
    """The groups are the weight-streaming kernel's least-cost split at 8
    rows (decode keeps its split), non-empty; every alternative the plan
    weighs runs one group a block or every group in one block."""
    g, per = mm.groups(N, K)
    kt = math.ceil(K / mm.BK)
    assert (g - 1) * per < kt <= g * per
    assert (mm.plan(8, N, K).splits, mm.plan(8, N, K).per_split) == (g, per)
    for M in (8, 17, 128, 1024):
        for p in mm.alternatives(M, N, K):
            assert (p.splits, p.per_split) in ((g, per), (1, kt))
            assert not (p.block_n == 256 and p.splits == 1 and g > 1)
