"""Collectives: the explicit ones a sharded step issues, and compressed
gradient traffic (``repro/dist/collectives.py``).

The sharded layers hold local tensors and issue the collectives that
GSPMD inserts in the JAX package themselves, each through one function
here, so each kind has one call site.  They are autograd functions under
one convention: a tensor replicated over a group has the same gradient on
every rank of it.  So

  - :func:`reduce_sum` (the sum of partial results, after a row-parallel
    product) passes its gradient through unchanged;
  - :func:`copy_to` (a replicated tensor entering a computation that
    differs by rank: a column-parallel product, a rank's experts) is the
    identity forward and sums the partial gradients backward;
  - :func:`gather` (a dimension's slices joined) takes its slice of the
    gradient back, and :func:`split` (this rank's slice) gathers it;
  - :func:`all_to_all` is its own adjoint.

Over a group of None (one rank, or no mesh) each is the identity and
issues nothing.

``quantize_int8``, ``dequantize_int8`` and ``compression_ratio`` give the
JAX package's bytes (round half to even, as ``jnp.round``);
``compressed_psum`` is the mean over a group of the dequantized payload.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.distributed as dist


#: the roofline's counter (``repro_torch.roofline.analysis.CostCounter``):
#: ``fn(kind, out, group)`` for every collective issued, None when none runs
_counter = None


def _note(kind: str, out: torch.Tensor, group) -> None:
    if _counter is not None:
        _counter(kind, out, group)


def _size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def raw_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's ``x`` joined along ``dim`` (no autograd): the one
    all-gather of the port (:func:`gather`, ``Sharding.gather``)."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    out = torch.cat(parts, dim)
    _note("all-gather", out, group)
    return out


def _mine(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    return x.chunk(dist.get_world_size(group), dim)[dist.get_rank(group)].contiguous()


def raw_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """A copy of ``x`` reduced over ``group`` (no autograd): the one
    all-reduce of the port (these functions', the gradient sum over the
    batch, the optimizer's norms and statistics)."""
    x = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(x, op=op, group=group)
    _note("all-reduce", x, group)
    return x


class _ReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return raw_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return raw_reduce(g, ctx.group), None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return raw_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _mine(g, ctx.dim, ctx.group), None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _mine(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return raw_gather(g, ctx.dim, ctx.group), None, None


def _exchange(x: torch.Tensor, group) -> torch.Tensor:
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x.contiguous(), group=group)
    _note("all-to-all", out, group)
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _exchange(x, group)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.group), None


def reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``, on every rank (``psum``)."""
    return x if _size(group) == 1 else _ReduceSum.apply(x, group)


def reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max over ``group`` (``pmax``; no gradient)."""
    return x if _size(group) == 1 else raw_reduce(x.detach(), group, dist.ReduceOp.MAX)


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` itself; its gradient summed over ``group``."""
    return x if _size(group) == 1 else _CopyTo.apply(x, group)


def gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's ``x`` joined along ``dim``, in the group's rank order."""
    return x if _size(group) == 1 else _Gather.apply(x, dim, group)


def split(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's one of ``group``-size equal slices of ``x`` along ``dim``."""
    return x if _size(group) == 1 else _Split.apply(x, dim, group)


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` [P, ...]'s row i sent to the group's rank i; row j of the
    result came from rank j."""
    return x if _size(group) == 1 else _AllToAll.apply(x, group)


# ---------------------------------------------------------------------------
# compressed gradient traffic
# ---------------------------------------------------------------------------


def quantize_int8(x: torch.Tensor, block: int = 64):
    """Block-wise symmetric int8 quantization.

    Returns ``(q, scale, shape)``: int8 blocks [nb, block], per-block f32
    scales [nb, 1], and the original shape for :func:`dequantize_int8`.
    Per-element error is bounded by scale/2 = max|x_block| / 254.
    """
    shape = tuple(x.shape)
    flat = x.reshape(-1).float()
    pad = (-flat.numel()) % block
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    blocks = flat.reshape(-1, block)
    amax = torch.amax(torch.abs(blocks), dim=1, keepdim=True)
    # a divisor on the device: CUDA divides by a host scalar as a product with
    # its reciprocal, which rounds otherwise than JAX's division
    scale = torch.where(amax > 0, amax / amax.new_full((), 127.0), torch.ones_like(amax))
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale, shape


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    n = math.prod(shape)
    return (q.float() * scale).reshape(-1)[:n].reshape(shape)


def compression_ratio(shape: Sequence[int], block: int = 64) -> float:
    """f32 bytes against (int8 payload + f32 per-block scales)."""
    n = math.prod(shape)
    nb = -(-n // block)
    return (n * 4) / (n * 1 + nb * 4)


def compressed_psum(x: torch.Tensor, group, *, block: int = 64):
    """The mean of ``x`` over ``group`` through the int8 wire format.

    Returns ``(mean, residual)`` where residual = x - dequant(quant(x)) is
    the local error-feedback term (carried into the next step's gradients,
    it keeps the accumulated update unbiased).  The dequantized payload is
    summed with ``all_reduce`` (on every rank, one included) and divided by
    the group's size."""
    q, scale, shape = quantize_int8(x, block)
    sent = dequantize_int8(q, scale, shape)
    total = raw_reduce(sent, group)
    mean = total / total.new_full((), dist.get_world_size(group))
    return mean.to(x.dtype), (x.float() - sent).to(x.dtype)
