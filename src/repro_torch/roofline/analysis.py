"""Counting a step's work on meta tensors, and the roofline: the
counterpart of ``repro/roofline/analysis.py``.

JAX reads FLOPs and bytes off the compiled program (``cost_analysis``) and
collective traffic off its HLO.  The port has neither, so it counts what a
step does while it runs on ``meta`` tensors (shapes, no data, no device):
:class:`CostCounter` is a ``TorchDispatchMode`` that adds up

  - **a dispatched op** (``core/dispatch.py`` ``op``) by the cost registered
    beside it (``dispatch.COSTS``; ``kernels/ops.py``): the work of the
    hand-written kernel the op runs on the card under ``cuda-strict``, its
    operands' and result's bytes and its products' FLOPs, by the formula
    of that kernel's bound in ``chip_smoke.py``.  It does not descend into
    the source that computes the op on meta: a flash-attention call costs
    q, k, v and o, never the S x T scores the torch source materialises;
  - **every other aten op** by ``torch.utils.flop_counter``'s rules (the
    products), plus one FLOP a result element for elementwise ops and one
    an input element for reductions, as XLA counts them; its bytes are its
    operands and its result.  Views cost nothing; a gather or an indexed
    write moves the rows it touches, not the whole table;
  - **every collective** where the port issues it
    (``dist/collectives.py`` ``raw_gather``, ``raw_reduce`` and the
    all-to-all: every function of that module, ``Sharding.gather``, the
    train step's gradient sum, the optimizer's norms and statistics) by
    JAX's ring-cost model (:func:`collective_bytes`) on its output's bytes
    and its group's size, priced at NVLink's rate when the group lies in
    one 8-card node (ranks row-major over the mesh's axes) and at the NIC's
    when it does not: a TPU pod's ICI is uniform, the card's interconnect
    is not;

and the peak of live bytes: every tensor an op allocates (a dispatched op,
its result only), until it is freed.

:func:`model_flops` and :func:`roofline_terms` are JAX's, on
``hw.DEFAULT_CHIP``, with the same keys.
"""

from __future__ import annotations

import collections
import contextlib
import weakref
from typing import Any

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch import hw
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.core import dispatch
from repro_torch.dist import collectives

COLLECTIVE_OPS = (
    "all-gather",
    "all-reduce",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)


def collective_bytes(kind: str, out_bytes: float, group_size: int) -> float:
    """One rank's link traffic for a collective whose output is
    ``out_bytes`` over ``group_size`` ranks, the ring-cost model of JAX's
    ``collective_bytes_from_hlo``:

      all-gather          B·(M−1)/M      (receive all shards but your own)
      reduce-scatter      B·(M−1)        (input is M·B; send (M−1)/M of it)
      all-reduce          2·B·(M−1)/M    (ring = reduce-scatter + all-gather)
      all-to-all          B·(M−1)/M
      collective-permute  B
    """
    b, m = out_bytes, max(1, group_size)
    if kind == "all-gather":
        return b * (m - 1) / m
    if kind == "reduce-scatter":
        return b * (m - 1)
    if kind == "all-reduce":
        return 2 * b * (m - 1) / m
    if kind == "all-to-all":
        return b * (m - 1) / m
    if kind == "collective-permute":
        return b
    raise ValueError(f"unknown collective {kind!r}")


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree: Any) -> list[torch.Tensor]:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


_aten = torch.ops.aten
#: reductions: one FLOP an input element (XLA's count for a reduce)
_REDUCTIONS = {_aten.sum, _aten.mean, _aten.amax, _aten.amin, _aten.max, _aten.min,
               _aten.prod, _aten.var, _aten.var_mean, _aten.std, _aten.argmax,
               _aten.argmin, _aten.logsumexp, _aten.cumsum, _aten.norm,
               _aten.linalg_vector_norm, _aten.any, _aten.all}
#: softmax: a max, a subtraction, an exponential, a sum and a division an
#: element, as XLA's expansion of it
_SOFTMAX = {_aten._softmax, _aten._log_softmax, _aten._softmax_backward_data,
            _aten._log_softmax_backward_data}
#: reads of some rows of a table: the rows (the result's size) and the
#: indices move, not the table
_GATHERS = {_aten.embedding, _aten.index_select, _aten.gather, _aten.index,
            _aten.embedding_dense_backward}
#: writes of some rows into a tensor in place: the rows written (the
#: source's size, read and written) and the indices move
_SCATTERS = {_aten.index_copy_, _aten.index_put_, _aten.scatter_, _aten.index_add_,
             _aten.index_copy, _aten.index_put, _aten.scatter, _aten.index_add,
             _aten.masked_scatter_, _aten.scatter_add_, _aten.scatter_add}
#: copies: bytes, no FLOPs (XLA counts none for a copy)
_COPIES = {_aten.clone, _aten.copy_, _aten._to_copy, _aten.copy, _aten.fill_, _aten.zero_,
           _aten.fill, _aten.zeros_like, _aten.ones_like, _aten.full_like, _aten.contiguous}
#: views whose schema names no alias (a reshape of a contiguous tensor)
_VIEWS = {_aten._unsafe_view, _aten.lift_fresh_copy}
#: allocate and write nothing
_ALLOCATIONS = {_aten.empty, _aten.empty_like, _aten.empty_strided, _aten.new_empty,
                _aten.new_empty_strided}


class CostCounter(TorchDispatchMode):
    """FLOPs, bytes, collectives and the peak of live bytes of what runs
    inside it (see the module docstring).  ``with CostCounter() as c:
    step(...)`` then read ``c.flops``, ``c.bytes``, ``c.collective_bytes``,
    ``c.nic_bytes`` (the part of it over the NIC), ``c.collectives`` (bytes
    by kind), ``c.collective_counts``, ``c.peak_bytes`` and ``c.by_op``
    (``{name: [calls, flops, bytes]}``, dispatched ops by their own name,
    aten ops by theirs)."""

    def __init__(self, chip: hw.ChipSpec = hw.DEFAULT_CHIP):
        super().__init__()
        self.chip = chip
        self.flops = 0.0
        self.bytes = 0.0
        self.by_op: dict[str, list] = collections.defaultdict(lambda: [0, 0.0, 0.0])
        self.collectives = {k: 0.0 for k in COLLECTIVE_OPS}
        self.collective_counts = {k: 0 for k in COLLECTIVE_OPS}
        self.nic_bytes = 0.0
        self.live_bytes = 0
        self.peak_bytes = 0
        self._inside = 0
        self._stack: contextlib.ExitStack | None = None

    # -- entering and leaving -----------------------------------------------

    def __enter__(self):
        if collectives._counter is not None:
            raise RuntimeError("a CostCounter is already counting")
        stack = contextlib.ExitStack()
        stack.enter_context(dispatch.observe(self.dispatched))
        collectives._counter = self._collective
        stack.callback(setattr, collectives, "_counter", None)
        self._stack = stack
        try:
            return super().__enter__()
        except BaseException:
            stack.close()
            raise

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._stack.close()

    # -- what is counted ------------------------------------------------------

    @property
    def collective_bytes(self) -> float:
        return sum(self.collectives.values())

    def _add(self, name: str, flops: float, bytes_: float) -> None:
        self.flops += flops
        self.bytes += bytes_
        row = self.by_op[name]
        row[0] += 1
        row[1] += flops
        row[2] += bytes_

    def _free(self, n: int) -> None:
        self.live_bytes -= n

    def _alloc(self, t: torch.Tensor) -> None:
        n = _nbytes(t)
        if n == 0:
            return
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(t, self._free, n)

    def dispatched(self, name: str, impl, args: tuple, kwargs: dict) -> Any:
        """``dispatch.op``'s observer: run the op, count its registered
        cost, and its result as allocated."""
        if self._inside:
            return impl.fn(*args, **kwargs)
        cost = dispatch.COSTS.get(name)
        if cost is None:
            raise KeyError(f"{name}: no cost is registered beside the op "
                           f"(dispatch.register_cost)")
        self._inside += 1              # the source's ops and the cost's own are not counted
        try:
            out = impl.fn(*args, **kwargs)
            flops, bytes_ = cost(out, *args, **kwargs)
        finally:
            self._inside -= 1
        self._add(name, flops, bytes_)
        for t in _tensors(out):
            self._alloc(t)
        return out

    def _collective(self, kind: str, out: torch.Tensor, group) -> None:
        if self._inside:
            raise RuntimeError(f"a {kind} inside a dispatched op: no kernel issues one")
        ranks = dist.get_process_group_ranks(group)
        traffic = collective_bytes(kind, _nbytes(out), len(ranks))
        self.collectives[kind] += traffic
        self.collective_counts[kind] += 1
        if len({r // self.chip.node_size for r in ranks}) > 1:
            self.nic_bytes += traffic

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._inside or func.namespace != "aten":
            return out
        returns = func._schema.returns
        packet = func.overloadpacket
        if packet in _VIEWS or any(r.alias_info is not None and not r.alias_info.is_write
                                   for r in returns):
            return out                                   # a view: costs nothing
        outs = _tensors(out)
        ins = _tensors((args, kwargs))
        flops = 0.0
        if packet in flop_registry:
            flops = float(flop_registry[packet](*args, **kwargs, out_val=out))
        elif packet in _SOFTMAX:
            flops = 5.0 * sum(t.numel() for t in outs)
        elif packet in _REDUCTIONS:
            flops = float(sum(t.numel() for t in ins[:1]))
        elif torch.Tag.pointwise in func.tags and packet not in _COPIES:
            flops = float(sum(t.numel() for t in outs))
        index_bytes = sum(_nbytes(t) for t in ins
                          if not t.is_floating_point() and not t.is_complex())
        if packet in _GATHERS:
            bytes_ = 2 * sum(_nbytes(t) for t in outs) + index_bytes
        elif packet in _SCATTERS:
            bytes_ = 2 * _nbytes(ins[-1]) + index_bytes        # the source's rows
        elif packet in _ALLOCATIONS:
            bytes_ = 0
        else:
            bytes_ = sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
        self._add(str(packet).removeprefix("aten."), flops, bytes_)
        in_place = any(r.alias_info is not None and r.alias_info.is_write for r in returns)
        if not in_place:
            for t in outs:
                self._alloc(t)
        return out


def model_flops(cfg: ArchConfig, shape: ShapeConfig) -> float:
    """MODEL_FLOPS = 6·N·D (dense) or 6·N_active·D; D = tokens this step."""
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        mult = 6.0
    elif shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        mult = 2.0                      # forward only
    else:
        tokens = shape.global_batch     # one token per sequence
        mult = 2.0
    n = cfg.active_params()
    return mult * n * tokens


def roofline_terms(*, flops_per_device: float, bytes_per_device: float,
                   collective_bytes_per_device: float, cfg: ArchConfig,
                   shape: ShapeConfig, chips: int, nic_bytes_per_device: float = 0.0,
                   chip: hw.ChipSpec = hw.DEFAULT_CHIP) -> dict:
    """JAX's three terms on the card: compute at the dense bf16 rate,
    memory at HBM's, collectives at NVLink's (all links) for traffic inside
    a node and the NIC's for ``nic_bytes_per_device`` of it."""
    compute_s = flops_per_device / chip.peak_bf16_flops
    memory_s = bytes_per_device / chip.hbm_bw
    collective_s = ((collective_bytes_per_device - nic_bytes_per_device) / chip.nvlink_bw
                    + nic_bytes_per_device / chip.nic_bw)
    terms = {"compute": compute_s, "memory": memory_s, "collective": collective_s}
    bottleneck = max(terms, key=terms.get)
    mf = model_flops(cfg, shape)
    hlo_flops_global = flops_per_device * chips
    return {
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": collective_s,
        "bottleneck": bottleneck,
        "model_flops": mf,
        "hlo_flops_global": hlo_flops_global,
        "useful_flops_ratio": (mf / hlo_flops_global) if hlo_flops_global else 0.0,
        "step_bound_s": max(terms.values()),
        "roofline_fraction": (
            compute_s / max(terms.values()) if max(terms.values()) > 0 else 0.0
        ),
    }
