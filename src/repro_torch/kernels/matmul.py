"""Blocked matmul written by hand for Hopper (``csrc/matmul.cu``), bf16 and
f32, and its fixed-weight role.

Replaces the Pallas TPU kernel ``repro/kernels/matmul.py`` ``matmul``
(``_mm_kernel``, entered through ``repro/kernels/ops.py`` ``pallas_matmul``):
[M, K] x [K, N] with an f32 accumulator, an optional silu or tanh-gelu
epilogue in f32, and a bf16 or f32 output.  f32 inputs take the f32 kernel
(full f32 FMAs on the CUDA cores, not TF32), as the Pallas kernel computes
f32 inputs in f32; it serves the paper's fully connected roles.
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

Where the output tiles alone cannot fill the card, both split K across
blocks and sum the splits in the same launch, in split order (the last block
of a tile to finish reduces), so a result depends on the shape alone.  The
wrapper flattens leading dimensions as ``pallas_matmul`` did and allocates
the split workspace and the tiles' counters (one buffer per CUDA stream,
which the kernel leaves zeroed); the kernels mask ragged M, N and K
themselves.  The f32 kernel keeps its 64x64 tiles and its two-pass split-K.

Both TMA (the bf16 kernels) and 16-byte ``cp.async`` loads (the f32 kernel)
need 16-byte rows and bases.  Any other shape or operand — K or N not a
multiple of 8 in bf16 or of 4 in f32, or an operand not 16-byte aligned,
such as the untied unembeds of granite-3-8b ``[4096, 49155]``, hymba
``[1600, 32001]`` and whisper ``[1280, 51866]`` — takes the edge kernel
(:func:`tma_ready` decides): guarded 2-byte loads and ``mma.sync`` in bf16,
the f32 kernel's guarded-load instance in f32, the same epilogues, one
launch, no padded copy of the weight.  So the wrapper takes every shape
``pallas_matmul`` takes, as it falls back to a single block.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

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
_F32_BM, _F32_BN, _F32_BK = 64, 64, 16
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
_F32_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_EDGE_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]

#: the kernel's function in plain PyTorch (f32 product, f32 epilogue, cast):
#: the oracle itself
plain_matmul = ref.matmul

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
# device memory; a split's workspace traffic, its fixed cost, and what the
# last block of a tile takes in of the other splits' tiles
_SM_BYTES_S = 60e9
_SM_FLOPS_S = 3e12
_HBM_BYTES_S = 3.0e12
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
            2 * (M * K + K * N + M * N) / _HBM_BYTES_S)
    if p.splits > 1:
        t += ((2 * p.splits - 1) * 4 * M * N / _SPLIT_BYTES_S + _SPLIT_S
              + (p.splits - 1) * 4 * rows * cols / _SM_REDUCE_BYTES_S)
    return t


@functools.lru_cache(maxsize=4096)
def plan(M: int, N: int, K: int) -> Plan:
    """The bf16 kernel, tile and K split for ``[M,K] x [K,N]``: a pure
    function of the shape.  M up to :data:`STREAM_MAX_M` streams the weight
    (M padded to 8 or 16); above it, the tile kernel at one of
    :data:`TILE_SHAPES`.  Of those, the block and the split (every split
    non-empty) of least :func:`cost`, the fewest splits and largest block on
    a tie.  Raises ``ValueError`` for K or N not a multiple of 8 (16-byte
    rows, as TMA needs): :func:`matmul` sends those shapes to the edge
    kernel and never asks."""
    if M <= 0 or N <= 0 or K <= 0:
        raise ValueError(f"matmul: empty shape M={M} N={N} K={K}")
    if K % 8 or N % 8:
        raise ValueError(f"matmul: K={K} and N={N} must be multiples of 8")
    kt = math.ceil(K / BK)
    if M <= STREAM_MAX_M:
        rows = next(r for r in STREAM_ROWS if r >= M)
        shapes = [("stream", rows, STREAM_BN, math.ceil(N / STREAM_BN))]
    else:
        shapes = [("tile", bm, bn, math.ceil(M / bm) * math.ceil(N / bn))
                  for bm, bn in TILE_SHAPES]
    best, best_t = None, math.inf
    for kernel, bm, bn, tiles in shapes:
        for splits in range(1, kt + 1):
            per = math.ceil(kt / splits)
            if math.ceil(kt / per) != splits:
                continue                  # a split would be empty
            p = Plan(kernel, bm, bn, splits, per, tiles)
            t = cost(M, N, K, p)
            if t < best_t * (1 - 1e-9):
                best, best_t = p, t
    return best


def split_k(M: int, N: int, K: int) -> int:
    """K splits for an f32 launch (64x64 tiles, 16-deep K tiles): enough
    blocks for two per SM when the output tiles alone are fewer than the
    SMs, at least four K tiles per split.  Returned so that every split is
    non-empty (the C side checks)."""
    tiles = math.ceil(M / _F32_BM) * math.ceil(N / _F32_BN)
    kt = math.ceil(K / _F32_BK)
    if tiles >= native.sm_count():
        return 1
    splits = max(1, min(math.ceil(2 * native.sm_count() / tiles), kt // 4))
    per = math.ceil(kt / splits)
    return math.ceil(kt / per)


def tma_ready(x: torch.Tensor, w: torch.Tensor) -> bool:
    """Whether x [.., K] and w [K, N] suit the TMA and ``cp.async`` kernels:
    16-byte rows (K and N multiples of 8 in bf16, of 4 in f32) and 16-byte
    aligned bases.  Otherwise the edge kernel takes them."""
    lanes = 16 // x.element_size()
    return (x.shape[-1] % lanes == 0 and w.shape[1] % lanes == 0
            and x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0)


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
    global edge_launches
    edge = not tma_ready(x, w)
    if f32:
        global f32_launches
        out = torch.empty((M, N), dtype=out_dtype, device=x.device)
        splits = split_k(M, N, K)
        ws = (torch.empty((splits, M, N), dtype=torch.float32, device=x.device)
              if splits > 1 else None)
        fn = native.function("matmul", "repro_matmul_f32", _F32_ARGTYPES)
        err = fn(native.ptr(x), native.ptr(w), native.ptr(out), native.ptr(ws), M, N, K,
                 _ACTIVATIONS[activation], splits, int(edge), native.stream(x.device))
        native.raise_on_error("matmul", err)
        if edge:
            edge_launches += 1
        else:
            f32_launches += 1
    elif edge:
        out = torch.empty((M, N), dtype=out_dtype, device=x.device)
        fn = native.function("matmul", "repro_matmul_edge", _EDGE_ARGTYPES)
        err = fn(native.ptr(x), native.ptr(w), native.ptr(out), M, N, K,
                 _ACTIVATIONS[activation], int(out_dtype == torch.float32),
                 native.stream(x.device))
        native.raise_on_error("matmul", err)
        edge_launches += 1
    else:
        out = _launch_bf16(x, w, plan(M, N, K), out_dtype, activation, M, N, K)
    if fixed:
        global fixed_launches
        fixed_launches += 1
    return out.reshape(*lead, N)


def _launch_bf16(x: torch.Tensor, w: torch.Tensor, p: Plan, out_dtype: torch.dtype,
                activation: str | None, M: int, N: int, K: int) -> torch.Tensor:
    """One launch of the bf16 kernel ``p`` names, on checked inputs; the
    [M, N] output."""
    global launches
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    ws = counters = None
    if p.splits > 1:
        ws = torch.empty((p.splits, M, N), dtype=torch.float32, device=x.device)
        counters = native.tile_counters("matmul", x.device, stream, p.tiles)
    fn = native.function("matmul", "repro_matmul", _ARGTYPES)
    err = fn(native.ptr(x), native.ptr(w), native.ptr(out), native.ptr(ws), native.ptr(counters),
             M, N, K, _ACTIVATIONS[activation], int(out_dtype == torch.float32),
             int(p.kernel == "stream"), p.block_m, p.block_n, p.splits,
             ctypes.c_void_p(stream))
    native.raise_on_error("matmul", err)
    launches += 1
    return out


def matmul_planned(x: torch.Tensor, w: torch.Tensor, p: Plan, *,
                   out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """``x [M, K] @ w [K, N]`` in bf16 on the CUDA kernel that plan ``p``
    names (which need not be :func:`plan`'s choice; the C side refuses a
    plan that does not fit the shape): for timing the alternatives."""
    native.check("matmul", {"x": x, "w": w}, torch.bfloat16)
    (M, K), N = x.shape, w.shape[1]
    return _launch_bf16(x, w, p, out_dtype or torch.bfloat16, None, M, N, K)


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
    """Shared memory and threads of one block: the f32 kernel's two-stage
    64x16 and 16x64 tiles; for bf16, the block of plan ``p``, or of the
    largest bf16 block (the 128 x 256 tile kernel) when none is given."""
    if f32:
        return ResourceFootprint(smem_bytes=4 * 2 * (64 * 20 + 16 * 68), threads=256)
    p = p or Plan("tile", 128, 256, 1, 1, 1)
    if p.kernel == "tile":
        stages = {64: 8, 128: 6, 256: 4}[p.block_n]
        smem = _smem(stages, 2 * BK * (p.block_m + p.block_n), 4 * p.block_m * (p.block_n + 8))
        return ResourceFootprint(smem_bytes=smem, threads=128 * (p.block_m // 64 + 1))
    stage = 2 * BK * (STREAM_BN + p.block_m)
    smem = _smem(6, stage, 4 * p.block_m * (STREAM_BN + 4))
    return ResourceFootprint(smem_bytes=smem, threads=160)
