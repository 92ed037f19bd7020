"""Blocked matmul written by hand for Hopper (``csrc/matmul.cu``), bf16 and
f32, and its fixed-weight role.

Replaces the Pallas TPU kernel ``repro/kernels/matmul.py`` ``matmul``
(``_mm_kernel``, entered through ``repro/kernels/ops.py`` ``pallas_matmul``):
[M, K] x [K, N] with an f32 accumulator, an optional silu or tanh-gelu
epilogue in f32, and a bf16 or f32 output.  f32 inputs take the f32 kernel,
which computes the f32 product on the tensor cores by error-compensated
TF32 ("3xTF32", :func:`split_tf32`, :func:`matmul_3xtf32`): each operand is
split into a TF32 part and a TF32 remainder, and three TF32 products are
summed in f32, within the 2e-4 the JAX package holds its f32 matmul to; it
serves the paper's fully connected roles.
:func:`matmul_fixed_weight` replaces ``matmul_fixed_weight``
(``repro/kernels/matmul.py:98``), the weight-specialised role of paper §IV:
the same kernel with its weight held on the card from load to unload, as
the Pallas role is the same ``pallas_call`` closed over its weight.

What bounds it on the H100: at decode, M is the number of batch slots (8), so
every weight byte is read once for 16 flops — far below the ~295 flops per
byte where the tensor cores become the limit — and the kernel is bound by
the bytes of the weight.  At prefill (M = the prompt bucket, up to 1024) it
is bound by operations.  The bf16 path answers each with a kernel of its own
behind one entry, and :func:`plan` picks the kernel, its tile and its K
split from the shape alone:

- the tile kernel (M above :data:`STREAM_MAX_M`): output tiles of 128 x
  256, 128 x 128, 128 x 64 or 64 x 64, a producer warp keeping TMA loads of
  64-deep K slices in flight in a 4-8 stage ring, and a consumer warpgroup
  for each 64 rows on ``wgmma`` straight from shared memory;
- the weight-streaming kernel (M up to :data:`STREAM_MAX_M`): ``out^T = w^T
  x^T`` on ``wgmma``, so that M, padded to 8 or 16, is the instruction's
  narrow side, and each block streams a 128-column strip of the weight
  through a six-stage TMA ring.

A row's K is summed in one order for every M (:func:`groups`): K's 64-deep
slices fall into groups, a function of (N, K) alone, each group summed from
zero and the groups added in order.  So a prompt row's result does not
depend on how many rows its launch carries, on the tile or on the kernel:
chunked prefill gives the whole prompt's rows bit for bit.  Where the
output tiles alone cannot fill the card, both kernels split K across blocks
one group a block and add the groups in the same launch, in group order (the
last block of a tile to finish reduces); unsplit, a tile kernel block keeps
a running total of its groups.  The wrapper flattens leading dimensions as
``pallas_matmul`` did and allocates the split workspace and the tiles' counters (one buffer per CUDA stream,
which the kernel leaves zeroed); the kernels mask ragged M, N and K
themselves.  The f32 kernel has 128 x 128 tiles, or 64 x 64 for small
products (:func:`f32_plan`): a converter warpgroup splits and transposes
each 32-deep slice into shared memory for one wgmma warpgroup per 64 rows;
the same in-launch split-K.

Both TMA (the bf16 kernels) and 16-byte ``cp.async`` loads (the f32 kernel)
need 16-byte rows and bases.  Any other shape or operand — K or N not a
multiple of 8 in bf16 or of 4 in f32, or an operand not 16-byte aligned,
such as the untied unembeds of granite-3-8b ``[4096, 49155]``, hymba
``[1600, 32001]`` and whisper ``[1280, 51866]`` — takes the edge kernel
(:func:`tma_ready` decides), as :func:`edge_plan` picks.  In bf16 at M up to
:data:`STREAM_MAX_M` (every decode-step unembed), a weight-streaming kernel
fetches each 64-row slice of a 128-column strip of w, realigns its rows in
shared memory and multiplies on ``mma.sync``.  With K a multiple of 8 and w
16-byte aligned it fetches by TMA, reading w as [K/8, 8N] "superrows" (16N
bytes apart: a legal TMA source), eight boxes a slice whose rows each share
one offset, the slice's rows permuted and x's columns permuted to match;
otherwise each row's aligned superset by 16-byte ``cp.async`` copies.  At
larger M the edge tile kernel: 128 x 128 output tiles (128 x 64 where
those would fill no more than half the card), a copy warp fetching w the
same ways and one fetching x (one TMA box a slice where K is a multiple of
8 and x 16-byte aligned, else by ``cp.async``), six realigning warps
writing the 128-byte swizzled tiles that two multiplying warpgroups read
with ``wgmma`` as the tile kernel does, a row's K summed in :func:`groups`'
order, one group a block (:func:`edge_plan`).  In f32 at M up to
:data:`STREAM_MAX_M`, aligned or not, a streaming kernel (w as [K/4, 4N]
superrows by TMA, or rows' aligned supersets by ``cp.async``; 3xTF32 on
``mma.sync`` with fragments read at each row's offset); at larger M the
f32 kernel's instance that copies rows' aligned supersets.  The same
epilogues, one
launch, no padded copy of the weight.  So the wrapper takes every shape
``pallas_matmul`` takes, as it falls back to a single block.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

from repro_torch import hw
from repro_torch.kernels import native, ref

from repro_torch.core.registry import ResourceFootprint

ROUTE = "cuda"
SOURCE = "src/repro_torch/csrc/matmul.cu"
REPLACES = "src/repro/kernels/matmul.py:59"
REPLACES_FIXED = "src/repro/kernels/matmul.py:98"

#: launches of the bf16 kernels (a split shape is one launch)
launches = 0
#: launches of the f32 kernel, through :func:`matmul` or a fixed-weight role
f32_launches = 0
#: launches made through a fixed-weight role (:func:`matmul_fixed_weight`)
fixed_launches = 0
#: launches of the edge kernel (bf16 or f32; shapes and operands TMA cannot take)
edge_launches = 0

_ACTIVATIONS = {None: 0, "silu": 1, "gelu": 2}
#: the f32 kernel's square output tiles, largest first, and its K slice
F32_BLOCKS, F32_BK = (128, 64), 32
#: columns of w a block of the bf16 edge streaming kernel, and of the f32
#: streaming kernel (M up to STREAM_MAX_M)
EDGE_BN, F32_STREAM_BN = 128, 64
#: blocks of the edge streaming kernel an SM holds (its shared memory)
EDGE_BLOCKS_PER_SM = 2
#: the edge tile kernel (M above STREAM_MAX_M): its output rows a block, and
#: its columns by :func:`edge_plan`'s kernel number
EDGE_TILE_BM = 128
EDGE_TILE_BN = {0: 128, 3: 64}
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
_F32_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
_EDGE_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p]

#: the kernel's function in plain PyTorch (f32 product, f32 epilogue, cast):
#: the oracle itself
plain_matmul = ref.matmul

_TF32_MASK = -(1 << 13)   # 0xffffe000 as an int32: clears the low 13 mantissa bits


def split_tf32(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The f32 kernel's split of an f32 tensor into two TF32 parts: ``big``
    is ``a`` with the low 13 mantissa bits cleared, ``small`` is ``a - big``
    (exact) with them cleared too; ``a - big - small`` is below 2^-21 |a|."""
    big = (a.float().view(torch.int32) & _TF32_MASK).view(torch.float32)
    small = ((a.float() - big).view(torch.int32) & _TF32_MASK).view(torch.float32)
    return big, small


def matmul_3xtf32(x: torch.Tensor, w: torch.Tensor, *,
                  activation: str | None = None) -> torch.Tensor:
    """The f32 kernel's arithmetic in plain PyTorch: ``xs wb + xb ws + xb wb``
    of :func:`split_tf32`'s parts (each product of two TF32 values exact in
    f32), summed in f32, then the epilogue; the kernel sums in another
    order.  A model of the kernel for the CPU tests: the wrappers' plain
    version stays :func:`plain_matmul`, the full f32 product."""
    (xb, xs), (wb, wsm) = split_tf32(x), split_tf32(w)
    acc = torch.matmul(xs, wb) + torch.matmul(xb, wsm) + torch.matmul(xb, wb)
    return ref.epilogue(acc, activation)

#: K a stage of the bf16 kernels (one 128-byte row of bf16)
BK = 64
#: the tile kernel's blocks (rows x columns of the output), widest first
TILE_SHAPES = ((128, 256), (128, 128), (128, 64), (64, 64))
STREAM_BN = 128
#: the row counts the weight-streaming kernel is built for
STREAM_ROWS = (8, 16)
#: the A/B boundary: M up to this streams the weight, above it the tile
#: kernel runs (the card's timings at the serve runs' rows: PERF.md)
STREAM_MAX_M = 16

# plan()'s cost model, fitted to matmul_sweep's timings on an H100 (PERF.md):
# what one SM takes in from L2 or HBM, one SM's wgmma rate at these blocks,
# device memory (hw.py's planning rate); a split's workspace traffic, its
# fixed cost, and what the last block of a tile takes in of the other
# splits' tiles
_SM_BYTES_S = 60e9
_SM_FLOPS_S = 3e12
_SPLIT_BYTES_S = 1e12
_SPLIT_S = 0.5e-6
_SM_REDUCE_BYTES_S = 40e9


@dataclasses.dataclass(frozen=True)
class Plan:
    """How the bf16 path computes one [M,K]x[K,N] shape: ``kernel`` "tile"
    (block ``block_m`` x ``block_n`` of the output) or "stream" (M padded to
    ``block_m``, a ``block_n``-column strip of w a block), K split in
    ``splits`` non-empty runs of ``per_split`` 64-deep slices over ``tiles``
    output tiles."""
    kernel: str
    block_m: int
    block_n: int
    splits: int
    per_split: int
    tiles: int

    @property
    def blocks(self) -> int:
        return self.tiles * self.splits


def cost(M: int, N: int, K: int, p: Plan) -> float:
    """Estimated seconds of plan ``p``: the SMs' K loop (each SM's blocks in
    turn, a stage bound by its bytes or its products) or device memory,
    whichever is longer, plus the split: its workspace traffic and the last
    block's reads of the other splits' tiles.  Its constants are fitted to
    rank the alternatives of one shape as the card does (they are effective
    rates, not the card's peaks), not to predict a time."""
    rows, cols = p.block_m, p.block_n
    step = max(2 * BK * (rows + cols) / _SM_BYTES_S, 2 * BK * rows * cols / _SM_FLOPS_S)
    t = max(math.ceil(p.blocks / native.sm_count()) * p.per_split * step,
            2 * (M * K + K * N + M * N) / hw.MATMUL_PLAN_BYTES_S)
    if p.splits > 1:
        t += ((2 * p.splits - 1) * 4 * M * N / _SPLIT_BYTES_S + _SPLIT_S
              + (p.splits - 1) * 4 * rows * cols / _SM_REDUCE_BYTES_S)
    return t


def _check(M: int, N: int, K: int) -> None:
    if M <= 0 or N <= 0 or K <= 0:
        raise ValueError(f"matmul: empty shape M={M} N={N} K={K}")
    if K % 8 or N % 8:
        raise ValueError(f"matmul: K={K} and N={N} must be multiples of 8")


def _least_cost(M: int, N: int, K: int, plans) -> Plan:
    """The plan of least :func:`cost`, the first on a tie."""
    best, best_t = None, math.inf
    for p in plans:
        t = cost(M, N, K, p)
        if t < best_t * (1 - 1e-9):
            best, best_t = p, t
    return best


@functools.lru_cache(maxsize=1024)
def groups(N: int, K: int) -> tuple[int, int]:
    """The order in which the bf16 tile kernels sum a row's K for ``[*,K] x
    [K,N]``, whatever M: (groups, 64-deep slices a group), every group
    non-empty.  Each group is summed from zero and the groups are added in
    order, so a row's result is a function of its own x row and w alone.
    The count is the K split the weight-streaming kernel takes at 8 rows
    (a decode step) by :func:`cost`, so decode keeps its split; a
    prefill's tile kernel keeps a running total of the groups instead.  An
    edge shape (K or N not a multiple of 8) takes the same rule on its own
    (N, K), which the edge tile kernel sums by (M above
    :data:`STREAM_MAX_M`; the streaming edge kernels split by
    :func:`edge_splits`).  Raises ``ValueError`` for an empty shape."""
    if N <= 0 or K <= 0:
        raise ValueError(f"matmul: empty shape N={N} K={K}")
    kt, strips = math.ceil(K / BK), math.ceil(N / STREAM_BN)
    p = _least_cost(8, N, K, (Plan("stream", 8, STREAM_BN, s, math.ceil(kt / s), strips)
                              for s in range(1, kt + 1)
                              if math.ceil(kt / math.ceil(kt / s)) == s))
    return p.splits, p.per_split


def alternatives(M: int, N: int, K: int) -> list[Plan]:
    """Every plan that sums a row in :func:`groups`' order: M up to
    :data:`STREAM_MAX_M` streams the weight (M padded to 8 or 16) one group
    a block; above it, the tile kernel at one of :data:`TILE_SHAPES`, one
    group a block or unsplit (a running total; not at 128 x 256, whose
    registers hold none, unless K is one group)."""
    _check(M, N, K)
    g, per = groups(N, K)
    if M <= STREAM_MAX_M:
        rows = next(r for r in STREAM_ROWS if r >= M)
        return [Plan("stream", rows, STREAM_BN, g, per, math.ceil(N / STREAM_BN))]
    kt = math.ceil(K / BK)
    return [Plan("tile", bm, bn, s, per if s > 1 else kt, math.ceil(M / bm) * math.ceil(N / bn))
            for bm, bn in TILE_SHAPES for s in sorted({1, g})
            if not (s == 1 and g > 1 and bn == 256)]


@functools.lru_cache(maxsize=4096)
def plan(M: int, N: int, K: int) -> Plan:
    """The bf16 kernel, tile and K split for ``[M,K] x [K,N]``: a pure
    function of the shape, the least :func:`cost` of :func:`alternatives`
    (the fewest splits and largest block on a tie).  Raises ``ValueError``
    for K or N not a multiple of 8 (16-byte rows, as TMA needs):
    :func:`matmul` sends those shapes to the edge kernel and never asks."""
    return _least_cost(M, N, K, alternatives(M, N, K))


def row_order(M: int, N: int, K: int) -> tuple[tuple[int, int], ...]:
    """The K ranges [k0, k1) that :func:`matmul` sums from zero for one
    output row of ``[M,K] x [K,N]``, in the order it adds them, as
    :func:`plan`'s launch runs them: one a split block, or the groups of an
    unsplit block's running total."""
    p = plan(M, N, K)
    kt = math.ceil(K / BK)
    size = p.per_split if p.splits > 1 else groups(N, K)[1]
    return tuple((i * BK, min(K, (i + size) * BK)) for i in range(0, kt, size))


def _whole_splits(kt: int, splits: int) -> int:
    """``splits`` cut down so that every split of ``kt`` slices is non-empty
    (the C side checks)."""
    per = math.ceil(kt / max(1, splits))
    return math.ceil(kt / per)


def f32_plan(M: int, N: int, K: int) -> tuple[int, int]:
    """The f32 kernel's square output tile (128 or 64, or 0: the streaming
    kernel, for M up to :data:`STREAM_MAX_M`, 64-column strips in 64-deep
    slices, unsplit where the strips fill the card's block slots, as at the
    unembeds (a split measured slower at all three), else split as
    :func:`edge_splits` splits few strips) and K splits (32-deep slices):
    128 x 128 tiles where there are at least 32 of them, else 64 x
    64 (a 128 x 128 tile has a fixed cost: one SM stores 64 KB of f32, and
    a slice of three TF32 products takes about a microsecond); then, where
    the tiles are fewer than the SMs, enough splits for a block every two
    SMs, at least two slices a split.  Read from the sweep's f32 table
    (PERF.md)."""
    sms, kt = native.sm_count(), math.ceil(K / F32_BK)
    if M <= STREAM_MAX_M:
        strips = math.ceil(N / F32_STREAM_BN)
        return 0, (1 if strips >= EDGE_BLOCKS_PER_SM * sms
                   else edge_splits(M, N, K, F32_STREAM_BN))
    big = F32_BLOCKS[0]
    block = big if math.ceil(M / big) * math.ceil(N / big) >= 32 else F32_BLOCKS[1]
    tiles = math.ceil(M / block) * math.ceil(N / block)
    if tiles >= sms:
        return block, 1
    return block, _whole_splits(kt, min(kt // 2, math.ceil(sms / (2 * tiles))))


def edge_plan(M: int, N: int, K: int, w_aligned: bool) -> tuple[int, int]:
    """The bf16 edge kernel and its K splits for ``[M,K] x [K,N]``: at M up
    to :data:`STREAM_MAX_M` the streaming edge kernel with
    :func:`edge_splits`' split, copying w by TMA as [K/8, 8N] superrows
    (kernel 2) where K is a multiple of 8 and w 16-byte aligned, by
    ``cp.async`` otherwise (kernel 1).  Above it the edge tile kernel, K
    split one :func:`groups` group a block (its blocks hold no running
    total, so a row is summed in groups' order whatever M): on 128 x 64
    tiles (kernel 3) where 128 x 128 tiles' blocks would fill no more than
    half the card's SMs (hymba's in_proj at up to 128 rows: 51 tiles), else
    on 128 x 128 (kernel 0).  Every served edge shape has one group.  Read
    from the sweep's edge table (PERF.md)."""
    if M <= STREAM_MAX_M:
        return (2 if K % 8 == 0 and w_aligned else 1), edge_splits(M, N, K)
    g = groups(N, K)[0]
    tiles = math.ceil(M / EDGE_TILE_BM) * math.ceil(N / EDGE_TILE_BN[0]) * g
    return (3 if 2 * tiles <= native.sm_count() else 0), g


def edge_splits(M: int, N: int, K: int, strip: int = EDGE_BN) -> int:
    """K splits for the bf16 edge streaming kernel (M up to
    :data:`STREAM_MAX_M`, 128-column strips, or ``strip``, 64-row slices,
    two blocks an SM).  Where the strips are fewer than the blocks the card holds, up to
    that many blocks, at least four slices a split; else the split of 1 or
    2 whose waves of blocks, each wave's work shrinking with the split, end
    soonest (1 on a tie): granite's 385 strips take 2 (2.9 waves of half
    strips, not 1.5 of whole ones: the sweep's edge table, PERF.md),
    hymba's 251 and whisper's 406 take 1."""
    if M > STREAM_MAX_M:
        return 1
    strips, slots = math.ceil(N / strip), EDGE_BLOCKS_PER_SM * native.sm_count()
    kt = math.ceil(K / BK)
    if strips < slots:
        return _whole_splits(kt, min(slots // strips, kt // 4))
    best = min((1, 2), key=lambda s: (math.ceil(strips * s / slots) / s, s))
    return _whole_splits(kt, best)


def tma_ready(x: torch.Tensor, w: torch.Tensor) -> bool:
    """Whether x [.., K] and w [K, N] suit the TMA and ``cp.async`` kernels:
    16-byte rows (K and N multiples of 8 in bf16, of 4 in f32) and 16-byte
    aligned bases.  Otherwise the edge kernel takes them."""
    lanes = 16 // x.element_size()
    return (x.shape[-1] % lanes == 0 and w.shape[1] % lanes == 0
            and x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0)


def kernel_instance(x: torch.Tensor, w: torch.Tensor) -> str:
    """The CUDA kernel instance (its name as ``cuobjdump`` demangles it) that
    :func:`matmul` launches for x [M, K] and w [K, N] on the card, as the C
    entries dispatch: :func:`plan`, :func:`edge_plan` or :func:`f32_plan`,
    and whether TMA or 16-byte copies can take the operands."""
    (M, K), N = x.shape, w.shape[1]
    w_aligned = w.data_ptr() % 16 == 0
    if x.dtype == torch.float32:
        block, _ = f32_plan(M, N, K)
        if block == 0:
            return f"mm_f32_stream_kernel<{8 if M <= 8 else 16},{int(K % 4 == 0 and w_aligned)}>"
        return f"mm_f32_kernel<{int(tma_ready(x, w))},{block},{block}>"
    if tma_ready(x, w):
        p = plan(M, N, K)
        return (f"mm_stream_kernel<{p.block_m}>" if p.kernel == "stream"
                else f"mm_tile_kernel<{p.block_m},{p.block_n}>")
    kernel, _ = edge_plan(M, N, K, w_aligned)
    if kernel in EDGE_TILE_BN:
        return f"mm_edge_tile_kernel<{EDGE_TILE_BN[kernel]}>"
    return f"mm_edge_stream_kernel<{8 if M <= 8 else 16},{int(kernel == 2)}>"


def matmul(x: torch.Tensor, w: torch.Tensor, *, out_dtype: torch.dtype | None = None,
           activation: str | None = None) -> torch.Tensor:
    """``x [..., K] @ w [K, N]``: the plain version for CPU tensors, else the
    CUDA kernel: bf16 inputs give a bf16 or f32 output, f32 inputs an f32
    output."""
    return _matmul(x, w, out_dtype, activation, fixed=False)


def _matmul(x: torch.Tensor, w: torch.Tensor, out_dtype: torch.dtype | None,
            activation: str | None, fixed: bool) -> torch.Tensor:
    """:func:`matmul`; ``fixed`` counts a launch in :data:`fixed_launches`
    as well (a call of a fixed-weight role)."""
    if activation not in _ACTIVATIONS:
        raise ValueError(f"unknown activation {activation!r}")
    if native.on_cpu(x, w):
        return plain_matmul(x, w, out_dtype=out_dtype, activation=activation)
    out_dtype = out_dtype or x.dtype
    f32 = x.dtype == torch.float32
    if f32 and out_dtype != torch.float32:
        raise TypeError(f"matmul: f32 inputs give an f32 output, not {out_dtype}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"matmul: out_dtype must be bf16 or f32, got {out_dtype}")
    native.check("matmul", {"x": x, "w": w}, torch.float32 if f32 else torch.bfloat16,
                 aligned=False)
    *lead, K = x.shape
    if w.dim() != 2 or w.shape[0] != K:
        raise ValueError(f"matmul: shapes {tuple(x.shape)} x {tuple(w.shape)} do not chain")
    M, N = math.prod(lead), w.shape[1]
    if M == 0:
        return torch.empty((*lead, N), dtype=out_dtype, device=x.device)
    edge = not tma_ready(x, w)
    if f32:
        out = _launch_f32(x, w, f32_plan(M, N, K), edge, activation, M, N, K)
    elif edge:
        out = _launch_edge(x, w, *edge_plan(M, N, K, w.data_ptr() % 16 == 0), out_dtype,
                           activation, M, N, K)
    else:
        out = _launch_bf16(x, w, plan(M, N, K), groups(N, K)[1], out_dtype, activation, M, N, K)
    if fixed:
        native.count_launch(__name__, "fixed_launches")
    return out.reshape(*lead, N)


def _launch_split(x: torch.Tensor, w: torch.Tensor, symbol: str, argtypes: list, splits: int,
                  tiles: int, M: int, N: int, K: int, out_dtype: torch.dtype,
                  activation: str | None, flags: tuple) -> torch.Tensor:
    """One launch of the f32 or the edge entry (``symbol``), its arguments in
    the C side's order: x, w, out, the split workspace and the tiles'
    counters, M, N, K, the epilogue, ``flags``, ``splits``, the stream; the
    [M, N] output."""
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    ws = counters = None
    if splits > 1:
        ws = torch.empty((splits, M, N), dtype=torch.float32, device=x.device)
        counters = native.tile_counters("matmul", x.device, stream, tiles)
    fn = native.function("matmul", symbol, argtypes)
    err = fn(native.ptr(x), native.ptr(w), native.ptr(out), native.ptr(ws), native.ptr(counters),
             M, N, K, _ACTIVATIONS[activation], *flags, splits, ctypes.c_void_p(stream))
    native.raise_on_error("matmul", err)
    return out


def _launch_f32(x: torch.Tensor, w: torch.Tensor, plan_: tuple[int, int], edge: bool,
                activation: str | None, M: int, N: int, K: int) -> torch.Tensor:
    """One launch of the f32 kernel at :func:`f32_plan`'s (block, splits),
    counted as an edge launch where ``edge`` (TMA could not take the
    operands), else as an f32 launch."""
    block, splits = plan_
    tiles = (math.ceil(N / F32_STREAM_BN) if block == 0
             else math.ceil(M / block) * math.ceil(N / block))
    out = _launch_split(x, w, "repro_matmul_f32", _F32_ARGTYPES, splits, tiles, M, N, K,
                        torch.float32, activation, (int(edge), block))
    if edge:
        native.count_launch(__name__, "edge_launches")
    else:
        native.count_launch(__name__, "f32_launches")
    return out


def matmul_f32_planned(x: torch.Tensor, w: torch.Tensor, plan_: tuple[int, int]) -> torch.Tensor:
    """``x [M, K] @ w [K, N]`` in f32 at (block, splits) ``plan_`` (which need
    not be :func:`f32_plan`'s choice; the C side refuses one that does not
    fit the shape): for timing the alternatives."""
    native.check("matmul", {"x": x, "w": w}, torch.float32, aligned=False)
    (M, K), N = x.shape, w.shape[1]
    return _launch_f32(x, w, plan_, not tma_ready(x, w), None, M, N, K)


def _launch_edge(x: torch.Tensor, w: torch.Tensor, kernel: int, splits: int,
                 out_dtype: torch.dtype, activation: str | None, M: int, N: int,
                 K: int) -> torch.Tensor:
    """One launch of a bf16 edge kernel (:func:`edge_plan`'s numbering); the
    tile kernel sums K in :func:`groups`' groups, one a split."""
    if kernel in EDGE_TILE_BN:
        tiles = math.ceil(M / EDGE_TILE_BM) * math.ceil(N / EDGE_TILE_BN[kernel])
    else:
        tiles = math.ceil(N / EDGE_BN)
    out = _launch_split(x, w, "repro_matmul_edge", _EDGE_ARGTYPES, splits, tiles, M, N, K,
                        out_dtype, activation,
                        (int(out_dtype == torch.float32), kernel, groups(N, K)[1]))
    native.count_launch(__name__, "edge_launches")
    return out


def matmul_edge(x: torch.Tensor, w: torch.Tensor, *, kernel: int, splits: int = 1,
                out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """``x [M, K] @ w [K, N]`` in bf16 on the edge kernel ``kernel`` with
    ``splits`` K splits (:func:`edge_plan`'s numbering: 2 and 1 take M up to
    :data:`STREAM_MAX_M`, 2 also K a multiple of 8 and w 16-byte aligned; 0
    and 3, the tile kernel at 128 x 128 and 128 x 64 tiles, any M, split
    one :func:`groups` group a block), whatever :func:`edge_plan` would
    pick: for timing one beside another."""
    native.check("matmul", {"x": x, "w": w}, torch.bfloat16, aligned=False)
    (M, K), N = x.shape, w.shape[1]
    return _launch_edge(x, w, kernel, splits, out_dtype or torch.bfloat16, None, M, N, K)


def _launch_bf16(x: torch.Tensor, w: torch.Tensor, p: Plan, group: int, out_dtype: torch.dtype,
                 activation: str | None, M: int, N: int, K: int) -> torch.Tensor:
    """One launch of the bf16 kernel ``p`` names, summing K in groups of
    ``group`` slices, on checked inputs; the [M, N] output."""
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    ws = counters = None
    if p.splits > 1:
        ws = torch.empty((p.splits, M, N), dtype=torch.float32, device=x.device)
        counters = native.tile_counters("matmul", x.device, stream, p.tiles)
    fn = native.function("matmul", "repro_matmul", _ARGTYPES)
    err = fn(native.ptr(x), native.ptr(w), native.ptr(out), native.ptr(ws), native.ptr(counters),
             M, N, K, _ACTIVATIONS[activation], int(out_dtype == torch.float32),
             int(p.kernel == "stream"), p.block_m, p.block_n, p.splits, group,
             ctypes.c_void_p(stream))
    native.raise_on_error("matmul", err)
    native.count_launch(__name__)
    return out


def matmul_planned(x: torch.Tensor, w: torch.Tensor, p: Plan, *,
                   out_dtype: torch.dtype | None = None, group: int | None = None) -> torch.Tensor:
    """``x [M, K] @ w [K, N]`` in bf16 on the CUDA kernel that plan ``p``
    names, summing K in groups of ``group`` slices (each block's own run
    where not given; neither need be :func:`plan`'s choice or
    :func:`groups`' order; the C side refuses a plan that does not fit the
    shape): for timing the alternatives."""
    native.check("matmul", {"x": x, "w": w}, torch.bfloat16)
    (M, K), N = x.shape, w.shape[1]
    return _launch_bf16(x, w, p, group or p.per_split, out_dtype or torch.bfloat16, None,
                        M, N, K)


class FixedWeightMatmul:
    """A matmul role with its weight fixed: a callable of ``x`` alone.

    :meth:`bind` returns the role with the weight on a device (uploaded once,
    held until the bound role is dropped); a call runs :func:`matmul` on the
    held weight, so it is bitwise equal to ``matmul(x, w)``."""

    def __init__(self, w: torch.Tensor, out_dtype: torch.dtype | None = None,
                 activation: str | None = None) -> None:
        self.weight = w
        self.out_dtype, self.activation = out_dtype, activation
        self.__name__ = f"matmul_fixed_{w.shape[0]}x{w.shape[1]}"

    def bind(self, device: "str | torch.device") -> "FixedWeightMatmul":
        return FixedWeightMatmul(self.weight.to(device), self.out_dtype, self.activation)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return _matmul(x, self.weight, self.out_dtype, self.activation, fixed=True)


def matmul_fixed_weight(w: torch.Tensor, *, out_dtype: torch.dtype | None = None,
                        activation: str | None = None) -> FixedWeightMatmul:
    """Fixed-weight role factory (paper §IV): one role per layer, its weight
    resident with the role.  The role planner decides when this pays off."""
    return FixedWeightMatmul(w, out_dtype, activation)


def _smem(stages: int, stage_bytes: int, staging: int) -> int:
    # csrc/matmul.cu TileCfg / StreamCfg: 1 KB of alignment slack, the ring
    # (or the f32 tile it becomes), a full and an empty mbarrier a stage, a flag
    return 1024 + max(stages * stage_bytes, staging) + 16 * stages + 16


def footprint(f32: bool = False, p: Plan | None = None) -> ResourceFootprint:
    """Shared memory and threads of one block: the f32 kernel's (its largest
    tile's) two stages of split x and w^T slices and three raw ones; for
    bf16, the block of plan ``p``, or of the largest bf16 block (the 128 x
    256 tile kernel) when none is given."""
    if f32:
        # csrc/matmul.cu F32Cfg<1, 128, 128>::SMEM: four 16 KB parts a split
        # stage (two), two a raw one (three), an mbarrier a raw stage and two a
        # split one, a flag
        part = F32_BLOCKS[0] * F32_BK * 4
        return ResourceFootprint(smem_bytes=1024 + 2 * 4 * part + 3 * 2 * part + 7 * 8 + 16,
                                 threads=384)
    p = p or Plan("tile", 128, 256, 1, 1, 1)
    if p.kernel == "tile":
        stages = {64: 8, 128: 6, 256: 4}[p.block_n]
        smem = _smem(stages, 2 * BK * (p.block_m + p.block_n), 4 * p.block_m * (p.block_n + 8))
        return ResourceFootprint(smem_bytes=smem, threads=128 * (p.block_m // 64 + 1))
    stage = 2 * BK * (STREAM_BN + p.block_m)
    smem = _smem(6, stage, 4 * p.block_m * (STREAM_BN + 4))
    return ResourceFootprint(smem_bytes=smem, threads=160)
