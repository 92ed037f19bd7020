"""Parameter descriptors and their initialisation.

Models declare their parameters as trees (nested dicts and lists) of
:class:`ParamSpec` — shape, *logical* axis names, dtype and init law.  The
logical names are the JAX package's (``("embed", "heads")`` on ``wq``) less
its leading ``"layers"`` entry, since the port keeps one leaf a layer where
JAX stacks them; :class:`repro_torch.dist.sharding.ShardingRules` maps them
to mesh axes.  :func:`init_params` makes
concrete tensors from one seeded ``torch.Generator`` with the JAX package's
laws (normal·scale drawn in f32 then cast, ones for norms); the draws differ
from ``jax.random``'s, so parity tests carry the JAX package's parameters
across with :func:`params_from_jax` instead.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    logical: tuple[str | None, ...] | None = None   # logical axis name per dim
    dtype: torch.dtype = torch.bfloat16
    init: str = "normal"                     # normal | zeros | ones | ssm_a
    scale: float = 0.02

    def __post_init__(self) -> None:
        # a cache spec names no axes (JAX's are ShapeDtypeStructs): all None
        if self.logical is None:
            object.__setattr__(self, "logical", (None,) * len(self.shape))
        if len(self.shape) != len(self.logical):
            raise ValueError(f"shape {self.shape} vs logical {self.logical}")


def is_spec(x: Any) -> bool:
    return isinstance(x, ParamSpec)


def resolve_device(device: "str | torch.device") -> torch.device:
    """The device an entry point runs on.  A CUDA device must exist: the
    port never carries on silently on the CPU — the CPU is only ever what a
    caller asked for."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels on the CPU"
        )
    return device


def _is_seq(x: Any) -> bool:
    """A list or a plain tuple is a tree node; a tuple subclass (a
    placement, ``repro_torch.dist.sharding.PartitionSpec``) is a leaf."""
    return type(x) in (list, tuple)


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    """Apply ``fn`` to every leaf of a tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if _is_seq(tree):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def tree_flatten_as(like: Any, tree: Any) -> list:
    """``tree``'s subtrees at the leaves of ``like`` (a prefix of its
    structure), in ``like``'s order: dicts in their keys' order, lists in
    theirs."""
    if isinstance(like, dict):
        return [x for k in like for x in tree_flatten_as(like[k], tree[k])]
    if _is_seq(like):
        if len(like) != len(tree):
            raise ValueError(f"a list of {len(tree)} where {len(like)} are expected")
        return [x for a, b in zip(like, tree) for x in tree_flatten_as(a, b)]
    return [tree]


def tree_leaves(tree: Any) -> list:
    """Every leaf of a tree, in :func:`tree_flatten_as`'s order."""
    return tree_flatten_as(tree, tree)


def tree_paths(tree: Any, prefix: str = "") -> list[str]:
    """Each leaf's path, in :func:`tree_leaves`' order, as JAX's
    ``keystr`` writes it: ``['embed']['tok']``, ``['layers'][0]['ln1']``."""
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in tree_paths(v, f"{prefix}[{k!r}]")]
    if _is_seq(tree):
        return [p for i, v in enumerate(tree) for p in tree_paths(v, f"{prefix}[{i}]")]
    return [prefix]


def tree_unflatten(like: Any, leaves: list) -> Any:
    """A tree of ``like``'s structure (tuples become lists) holding
    ``leaves`` in :func:`tree_leaves`' order."""
    it = iter(leaves)
    out = tree_map(lambda _: next(it), like)
    if next(it, it) is not it:
        raise ValueError("more leaves than the tree has")
    return out


#: a leaf of more elements than this is drawn in slices along its first
#: axis (an f32 draw of deepseek-v3's [256, 7168, 2048] expert stack whole
#: would hold 30 GB of temporaries); every smaller leaf is one draw
DRAW_SLICE_ELEMENTS = 1 << 28


def _normal(shape: tuple[int, ...], scale: float, dtype: torch.dtype, gen: torch.Generator,
            device: torch.device) -> torch.Tensor:
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (x * scale).to(dtype)


def _init_leaf(spec: ParamSpec, gen: torch.Generator, device: torch.device) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=spec.dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=spec.dtype, device=device)
    if spec.init == "normal":
        if math.prod(spec.shape) <= DRAW_SLICE_ELEMENTS:
            return _normal(spec.shape, spec.scale, spec.dtype, gen, device)
        out = torch.empty(spec.shape, dtype=spec.dtype, device=device)
        for i in range(spec.shape[0]):
            out[i] = _normal(spec.shape[1:], spec.scale, spec.dtype, gen, device)
        return out
    if spec.init == "ssm_a":
        # a_log of the SSD decay: -uniform(1, 16), stored negative
        u = torch.rand(spec.shape, generator=gen, dtype=torch.float32, device=device)
        return -(1.0 + 15.0 * u).to(spec.dtype)
    raise ValueError(f"unknown init {spec.init!r}")


#: the derived leaves: resident f32 copies of weights JAX multiplies in f32
#: (``embed["tok_f32"]``, each MLA layer's ``wo_f32``), made from the
#: trained leaves and never trained themselves
DERIVED = frozenset({"tok_f32", "wo_f32"})


def refresh_derived(params: dict) -> dict:
    """(Re)make the derived f32 copies from the weights, in place, and
    return ``params``: the tied embedding table's, for the f32 unembed
    product (instead of casting 128256 x 2048 values on every step), and
    each MLA layer's ``wo``, which decode multiplies by its f32 context
    (``models/mla.py``).  Run it after training or a restore, before
    serving the weights: serving reads the copies, and a stale one serves
    the old table."""
    embed = params["embed"]
    if "unembed" not in embed:
        embed["tok_f32"] = embed["tok"].detach().float()
    for layer in params.get("layers", ()):
        if "mla" in layer:
            layer["mla"]["wo_f32"] = layer["mla"]["wo"].detach().float()
    return params


def trainable(params: Any) -> Any:
    """The training tree: the same tensors as ``params`` in the same
    structure, less the derived copies (:data:`DERIVED`), so exactly the
    JAX package's leaves.  The optimizer, the global norm and the
    checkpoint see only these; the tied unembed then differentiates into
    ``tok`` (``models/layers.py`` ``unembed``)."""
    if isinstance(params, dict):
        return {k: trainable(v) for k, v in params.items() if k not in DERIVED}
    if isinstance(params, (list, tuple)):
        return [trainable(v) for v in params]
    return params


def count_params(tree: Any) -> int:
    """The elements of every spec in ``tree``."""
    return sum(math.prod(s.shape) for s in tree_leaves(tree) if is_spec(s))


def bytes_params(tree: Any) -> int:
    """The bytes of every spec in ``tree`` at its dtype."""
    return sum(math.prod(s.shape) * s.dtype.itemsize for s in tree_leaves(tree) if is_spec(s))


def abstract_params(tree: Any, shardings: Any = None) -> Any:
    """``meta`` tensors of each spec's shape and dtype: the dry run's
    parameters, which allocate nothing.  With ``shardings`` (a tree of each
    leaf's :class:`~repro_torch.dist.sharding.Sharding`), each is the
    rank's slice (``Sharding.local_shape``)."""
    if shardings is None:
        return tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype, device="meta"), tree)
    locals_ = [torch.empty(sh.local_shape(s.shape), dtype=s.dtype, device="meta")
               for s, sh in zip(tree_leaves(tree), tree_flatten_as(tree, shardings))]
    return tree_unflatten(tree, locals_)


def init_params(specs: Any, seed: int = 0, *, device: "str | torch.device" = "cuda") -> Any:
    """Concrete parameters for a spec tree, drawn in leaf order from one
    generator seeded with ``seed`` on ``device``."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return refresh_derived(tree_map(lambda s: _init_leaf(s, gen, device), specs))


def params_from_jax(tree: dict, *, device: "str | torch.device" = "cuda") -> dict:
    """The port's parameters from the JAX ``DecoderLM``'s or ``EncDecLM``'s,
    given as a tree of numpy arrays (``jax.tree.map(np.asarray, params)``).

    JAX stacks each segment's repeated unit as ``[count, ...]`` under
    ``tree["segments"][s][str(j)]`` (j the unit's j-th layer kind: llama4's
    unit is ``{"0": moe, "1": dense}``, deepseek's two segments are the
    dense head and the MoE rest); the port keeps one dict per layer, in
    :func:`repro_torch.models.model.layer_kinds`' order.  Expert stacks
    stay stacked ``[E, d, f]``.  Values travel through float32 (exact for
    bf16; ``torch.from_numpy`` rejects numpy's bf16) and are cast back to
    their dtype on the torch side, so the router and a Mamba-2 layer's
    ``a_log``, ``skip_d`` and ``dt_bias`` stay f32 and the rest bf16.

    The encoder-decoder's ``encoder`` and ``decoder`` stacks (``[L, ...]``
    each) become lists of per-layer dicts; ``enc_pos`` and ``ln_enc`` come
    across as they are.  Each layer's leaf is a copy of its slice of the
    stack, with storage of its own: trained in place, one layer's leaf
    never writes another's.
    """
    device = resolve_device(device)

    def leaf(a) -> torch.Tensor:
        dtype = getattr(torch, str(a.dtype))
        return torch.from_numpy(np.asarray(a, dtype=np.float32)).to(device=device, dtype=dtype)

    def unstack(stack: dict) -> list:
        stack = tree_map(leaf, stack)
        return [tree_map(lambda t, i=i: t[i].clone(), stack) for i in range(stack["ln1"].shape[0])]

    if "encoder" in tree:
        return refresh_derived({
            "embed": tree_map(leaf, tree["embed"]), "enc_pos": leaf(tree["enc_pos"]),
            "encoder": unstack(tree["encoder"]), "ln_enc": leaf(tree["ln_enc"]),
            "decoder": unstack(tree["decoder"]), "ln_f": leaf(tree["ln_f"])})
    layers = []
    for segment in tree["segments"]:
        units = [tree_map(leaf, segment[str(j)]) for j in range(len(segment))]
        count = units[0]["ln1"].shape[0]
        layers += [tree_map(lambda t, i=i: t[i].clone(), unit)
                   for i in range(count) for unit in units]
    return refresh_derived({
        "embed": tree_map(leaf, tree["embed"]),
        "layers": layers,
        "ln_f": leaf(tree["ln_f"]),
    })
