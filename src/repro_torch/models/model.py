"""The models: ``DecoderLM`` and ``EncDecLM`` of ``repro/models/model.py``.

``DecoderLM`` runs the ``dense`` and ``vlm`` families (llama3_2_1b, yi,
granite: GQA attention + SwiGLU), the ``moe`` family (llama4-maverick: GQA
with a (moe, dense) unit; deepseek-v3: MLA, 3 dense layers then MoE), the
``ssm`` family (mamba2: Mamba-2 blocks, no attention, no MLP) and the
``hybrid`` family (hymba: attention and Mamba-2 heads side by side in every
layer, their normed outputs averaged, under a sliding window).  A config
with ``attn_window`` keeps a ring-buffer KV cache of ``min(cache_len,
window)`` rows: prefill keeps the last ``window`` rows, rolled to their
slots (:func:`_window_clip`), and decode writes row ``pos`` at slot ``pos %
window``.

``EncDecLM`` runs the ``audio`` family (whisper): an encoder over frame
embeddings (the conv frontend is a stub, as in the JAX package), then a
decoder whose layers attend causally over their own rows and across to the
encoder's output.

Layers run in a Python loop (JAX scanned stacked segments); parameters are
one dict per layer, and :attr:`DecoderLM.kinds` names each layer's kind
(``dense``, ``moe``, ``ssm`` or ``hybrid``) in JAX's segment order
(:func:`plan_segments`).  The cache keeps JAX's stacked layout over all
layers, so no ``segments`` list: ``{"pos", "k": [L, B, Hkv, T, hd], "v":
...}`` for GQA models, ``{"pos", "ckv": [L, B, T, r], "krope": [L, B, T,
rope]}`` for MLA ones, ``{"pos", "ssm_state": [L, B, H, P, N] f32,
"conv_tail": [L, B, K-1, C]}`` for SSM ones, all four for hybrid ones, and
``{"pos", "k", "v", "mem_k", "mem_v"}`` (the cross-attention's memory
``[L, B, Hkv, T_enc, hd]``) for the encoder-decoder.  Decode updates it in
place where JAX returned a new one.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable

import torch
import torch.nn.functional as F
from torch.utils import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.core import dispatch
from repro_torch.dist import act, collectives
from repro_torch.models import layers, mla, moe, ssm
from repro_torch.models.params import ParamSpec, resolve_device

Params = Any

AUX_KEYS = ("load_balance", "router_z", "dropped_frac")


def _zero_aux(device: torch.device) -> dict[str, torch.Tensor]:
    return {k: torch.zeros((), dtype=torch.float32, device=device) for k in AUX_KEYS}


def _merge_aux(a: dict, b: dict) -> dict:
    return {k: a[k] + b[k] for k in a}


@dataclasses.dataclass(frozen=True)
class Segment:
    kinds: tuple[str, ...]           # layer kinds within one repeated unit
    count: int                       # repeats


def plan_segments(cfg: ArchConfig) -> list[Segment]:
    """JAX's segment plan: dense/vlm [dense x L]; moe [dense x first_k_dense,
    (moe, dense x (period - 1)) x the rest]; ssm [ssm x L]; hybrid [hybrid
    x L]."""
    if cfg.family == "ssm":
        return [Segment(("ssm",), cfg.num_layers)]
    if cfg.family == "hybrid":
        return [Segment(("hybrid",), cfg.num_layers)]
    if cfg.moe is not None:
        k1 = cfg.moe.first_k_dense
        period = cfg.moe.layer_period
        segs = []
        if k1:
            segs.append(Segment(("dense",), k1))
        unit = ("moe",) + ("dense",) * (period - 1)
        segs.append(Segment(unit, (cfg.num_layers - k1) // period))
        return segs
    return [Segment(("dense",), cfg.num_layers)]


def layer_kinds(cfg: ArchConfig) -> list[str]:
    """Each layer's kind, in order: the segments' units repeated."""
    return [kind for seg in plan_segments(cfg) for _ in range(seg.count) for kind in seg.kinds]


def layer_specs(cfg: ArchConfig, kind: str) -> Params:
    d = cfg.d_model
    if kind == "ssm":
        return {"ln1": layers.norm_spec(d), "mamba": ssm.ssm_specs(cfg)}
    if kind == "hybrid":
        return {"ln1": layers.norm_spec(d), "attn": layers.attention_specs(cfg),
                "mamba": ssm.ssm_specs(cfg), "attn_norm": layers.norm_spec(d),
                "ssm_norm": layers.norm_spec(d), "ln2": layers.norm_spec(d),
                "mlp": layers.mlp_specs(cfg)}
    if kind == "enc":
        return {"ln1": layers.norm_spec(d), "attn": layers.attention_specs(cfg),
                "ln2": layers.norm_spec(d), "mlp": layers.mlp_specs(cfg)}
    if kind == "dec":
        return {"ln1": layers.norm_spec(d), "attn": layers.attention_specs(cfg),
                "lnx": layers.norm_spec(d), "xattn": layers.cross_attention_specs(cfg),
                "ln2": layers.norm_spec(d), "mlp": layers.mlp_specs(cfg)}
    attn = ({"mla": mla.mla_specs(cfg)} if cfg.mla is not None
            else {"attn": layers.attention_specs(cfg)})
    ffn = {"moe": moe.moe_specs(cfg)} if kind == "moe" else {"mlp": layers.mlp_specs(cfg)}
    return {"ln1": layers.norm_spec(d), **attn, "ln2": layers.norm_spec(d), **ffn}


#: the cache leaves with a time axis (its second to last)
TIME_KEYS = frozenset({"k", "v", "ckv", "krope"})


def cache_rows(cfg: ArchConfig, cache_len: int) -> int:
    """The KV cache's rows for a serving length ``cache_len``: all of them,
    or under a sliding window a ring of ``min(cache_len, window)``."""
    return min(cache_len, cfg.attn_window) if cfg.attn_window else cache_len


def _pad_cache_time(cache: dict, rows: int) -> dict:
    """Zero-pad the prefill KV (or latent) caches along the time axis to
    ``rows`` (:func:`cache_rows`).  Zeros, not ``torch.empty``: decode
    attention multiplies masked rows' values by a zero probability, and 0 *
    NaN would poison the product."""
    out = dict(cache)
    for key in TIME_KEYS & set(cache):
        x = cache[key]
        cur = x.shape[-2]
        if cur < rows:
            padded = x.new_zeros((*x.shape[:-2], rows, x.shape[-1]))
            padded[..., :cur, :] = x
            out[key] = padded
    return out


def _window_clip(cfg: ArchConfig, kv: dict) -> dict:
    """Ring-buffer clip of prefill KV to the attention window: the last
    ``w`` rows of the time axis (its second to last), each at slot ``row %
    w`` — a roll of the tail by ``(S - w) % w``, as JAX's ``jnp.roll``."""
    if cfg.attn_window is None or "k" not in kv:
        return kv
    w = cfg.attn_window
    S = kv["k"].shape[-2]
    if S <= w:
        return kv
    shift = (S - w) % w
    return {**kv, **{key: torch.roll(kv[key][..., -w:, :], shifts=shift, dims=-2)
                     for key in ("k", "v")}}


def _merge_heads(cfg: ArchConfig, p: Params, a: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """A hybrid layer's merge of its attention and SSM heads' outputs:
    ``0.5 * (norm(a) + norm(s))``, rounded to bf16 where JAX rounds (the sum,
    then the half)."""
    return 0.5 * (layers.apply_norm(p["attn_norm"], a, cfg.norm_eps)
                  + layers.apply_norm(p["ssm_norm"], s, cfg.norm_eps))


# ---------------------------------------------------------------------------
# the training forward (JAX's ``full`` mode)
# ---------------------------------------------------------------------------


def _apply_attn_full(cfg: ArchConfig, p: Params, h: torch.Tensor, positions: torch.Tensor, *,
                     causal: bool = True) -> torch.Tensor:
    if cfg.mla is not None:
        return mla.mla_full(p["mla"], h, cfg, positions=positions)[0]
    return layers.attention_full(p["attn"], h, cfg, positions=positions,
                                 window=cfg.attn_window, causal=causal)[0]


def apply_layer_full(cfg: ArchConfig, kind: str, p: Params, x: torch.Tensor,
                     positions: torch.Tensor, memory: torch.Tensor | None = None,
                     moe_info=None) -> tuple[torch.Tensor, dict]:
    """One layer over the whole sequence, no cache: (x, aux).  MoE layers
    route with their capacity (``dropless=False``; ``moe_info`` their
    expert-parallel layout) and return their aux metrics; every other kind
    returns zeros."""
    aux = _zero_aux(x.device)
    if kind == "ssm":
        return x + ssm.ssm_full(p["mamba"], layers.apply_norm(p["ln1"], x, cfg.norm_eps),
                                cfg), aux
    h = layers.apply_norm(p["ln1"], x, cfg.norm_eps)
    if kind == "hybrid":
        a = _apply_attn_full(cfg, p, h, positions)
        x = x + _merge_heads(cfg, p, a, ssm.ssm_full(p["mamba"], h, cfg))
        return x + layers.apply_mlp(p["mlp"], layers.apply_norm(p["ln2"], x, cfg.norm_eps),
                                    cfg.d_ff), aux
    x = x + _apply_attn_full(cfg, p, h, positions, causal=kind != "enc")
    if kind == "dec":
        hx = layers.apply_norm(p["lnx"], x, cfg.norm_eps)
        mem_k, mem_v = layers.encode_memory(p["xattn"], memory, cfg)
        x = x + layers.cross_attention(p["xattn"], hx, mem_k, mem_v, cfg)
    h2 = layers.apply_norm(p["ln2"], x, cfg.norm_eps)
    if kind == "moe":
        y, moe_aux = moe.apply_moe(p["moe"], h2, cfg, mesh_info=moe_info)
        aux.update({k: v.float() for k, v in moe_aux.items()})
    else:
        y = layers.apply_mlp(p["mlp"], h2, cfg.d_ff)
    return x + y, aux


#: the ops whose outputs ``remat="dots"`` saves: products without batch
#: dimensions (JAX's ``dots_with_no_batch_dims_saveable``); attention's
#: batched products and every elementwise op are recomputed
_DOTS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.addmm.default})


def _save_dots(ctx, op, *args, **kwargs):
    return (checkpoint.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else checkpoint.CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(fn: Callable, mode: str) -> Callable:
    """JAX's ``_remat`` as ``torch.utils.checkpoint`` (non-reentrant):
    ``"none"`` saves what autograd saves, ``"full"`` keeps only the
    function's inputs and recomputes the rest in the backward pass,
    ``"dots"`` keeps the outputs of its matmuls too.  The recomputation runs
    under the dispatch context and the sharding rules of the forward (the
    backward may run on another thread, where the context variables are
    unset)."""
    if mode == "none":
        return fn
    ctx = dispatch.current()
    rules, step_layout = act.current(), act.layout()

    def run(*args):
        with dispatch.use(device_kind=ctx.device_kind, prefer=ctx.prefer,
                          registry=ctx.registry, trace=ctx.trace), \
                act.use_rules(rules), act.use_layout(step_layout):
            return fn(*args)

    kw = {}
    if mode == "dots":
        kw["context_fn"] = functools.partial(checkpoint.create_selective_checkpoint_contexts,
                                             _save_dots)
    elif mode != "full":
        raise ValueError(f"unknown remat mode {mode!r}")
    return lambda *args: checkpoint.checkpoint(run, *args, use_reentrant=False, **kw)


def chunked_ce(embed_params: Params, h: torch.Tensor, labels: torch.Tensor, *,
               chunk: int = 1024, vocab: int | None = None) -> torch.Tensor:
    """Next-token cross entropy without materialising [B, S, V] logits: the
    unembed product and the log-softmax run a ``chunk`` of rows at a time,
    each chunk recomputed in the backward pass, so the f32 logits of one
    chunk are all that is ever live.  The mean over the B·(S-1) predicted
    rows; ``S - 1`` rows are padded up to a multiple of the chunk and the
    padded tail is masked, as JAX's.  ``vocab``: the global vocabulary,
    which a sharded unembed needs (:func:`layers.unembed`)."""
    B, S, _ = h.shape
    h_in, tgt = h[:, :-1], labels[:, 1:].long()
    n = S - 1
    c = min(chunk, n)
    pad = (-n) % c
    if pad:
        h_in = F.pad(h_in, (0, 0, 0, pad))
        tgt = F.pad(tgt, (0, pad))

    def body(hc: torch.Tensor, tc: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        lp = torch.log_softmax(layers.unembed(embed_params, hc, vocab).float(), dim=-1)
        nll = -torch.gather(lp, -1, tc[..., None])[..., 0]
        return torch.sum(nll * valid[None, :])

    chunk_ce = _remat(body, "full")
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    rows = torch.arange(c, device=h.device)
    for i in range(0, n + pad, c):
        total = total + chunk_ce(h_in[:, i:i + c], tgt[:, i:i + c], (i + rows) < n)
    return total / (B * n)


def _loss_metrics(cfg: ArchConfig, nll: torch.Tensor, aux: dict) -> tuple[torch.Tensor, dict]:
    """The loss (the MoE router's weighted aux terms added) and its
    metrics, detached.  A sharded step's ``nll`` is its batch rows' mean:
    the mean over the ranks that split the batch makes it the global one
    (the aux terms are already, :class:`repro_torch.models.moe.MoeMeshInfo`)."""
    axes = act.batch_axes()
    if axes:
        nll = collectives.reduce_sum(nll, act.group(axes)) / act.size(axes)
    loss = nll
    if cfg.moe is not None:
        loss = loss + cfg.moe.router_aux_weight * aux["load_balance"]
        loss = loss + cfg.moe.router_z_weight * aux["router_z"]
    metrics = {"nll": nll, **aux, "loss": loss}
    return loss, {k: v.detach() for k, v in metrics.items()}


class _WholeCache:
    """A sharded decode step's per-layer cache views (the identity outside
    one).  The cache leaves hold this rank's slice of the step's cache
    layout (:func:`repro_torch.dist.act.cache_layout`); a leaf split along
    the model axis is gathered whole for its layer (:meth:`layer`) and
    this rank's slice of it written back after (:meth:`write_back`), but
    for k/v split by heads (attention reads its own heads) or by time under
    sequence-parallel decode (:func:`layers.sp_decode_applies`)."""

    def __init__(self, cfg: ArchConfig, cache: dict, pos: torch.Tensor):
        self.cache = cache
        layout = act.cache_layout() or {}
        self.group = act.group("model")
        self.split: dict[str, int] = {}
        sp = layers.sp_decode_applies(cfg, pos)
        for key, entries in layout.items():
            # the per-layer leaf's dimension split over the model axis
            dim = next((i - 1 for i, e in enumerate(entries) if i > 1 and e == "model"), None)
            if self.group is None or dim is None or key not in cache:
                continue
            if key in ("k", "v") and (dim == 1 or (dim == 2 and sp)):
                continue
            self.split[key] = dim

    def layer(self, i: int) -> dict:
        return {key: (collectives.gather(t[i], self.split[key], self.group)
                      if key in self.split else t[i])
                for key, t in self.cache.items() if key not in ("pos", "block_table")}

    def write_back(self, i: int, c: dict) -> None:
        for key, dim in self.split.items():
            n = torch.distributed.get_world_size(self.group)
            self.cache[key][i].copy_(c[key].chunk(n, dim)[torch.distributed.get_rank(self.group)])


class DecoderLM:
    """Decoder-only LM: dense, vlm, moe (with GQA or MLA attention), ssm and
    hybrid."""

    def __init__(self, cfg: ArchConfig, *, device: "str | torch.device" = "cuda"):
        if cfg.family == "audio":
            raise ValueError(f"{cfg.name}: an encoder-decoder config is EncDecLM's "
                             f"(build_model picks it)")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.kinds = layer_kinds(cfg)

    # -- parameters --------------------------------------------------------

    def param_specs(self) -> Params:
        cfg = self.cfg
        return {
            "embed": layers.embed_specs(cfg),
            "layers": [layer_specs(cfg, kind) for kind in self.kinds],
            "ln_f": layers.norm_spec(cfg.d_model),
        }

    # -- the refusals JAX's layers raise -------------------------------------

    def _refuse_chunked(self) -> None:
        """Only plain dense GQA layers are chunk-safe: MoE capacity routing
        depends on the other tokens of a call, recurrent state folds
        sequentially, MLA's latents have no chunk path, and a ring cache
        clips by position."""
        cfg = self.cfg
        # the first layer that refuses, as JAX's layer loop meets it
        kind = next((k for k in self.kinds if k != "dense" or cfg.mla is not None
                     or cfg.attn_window is not None), None)
        if kind is not None:
            raise ValueError(f"chunked prefill supports plain dense GQA layers only, not "
                             f"{kind!r} (mla={cfg.mla is not None}, window={cfg.attn_window})")

    def _refuse_paged(self) -> None:
        """Only plain position-indexed GQA caches page (dense and moe layers,
        no window)."""
        cfg = self.cfg
        if self.kinds[0] not in ("dense", "moe") or cfg.mla is not None or cfg.attn_window:
            raise ValueError(f"paged decode supports plain GQA KV caches only, not "
                             f"{self.kinds[0]!r} (mla={cfg.mla is not None}, "
                             f"window={cfg.attn_window})")

    def _ffn(self, kind: str, p: Params, x: torch.Tensor, *, dropless: bool,
             moe_info=None) -> torch.Tensor:
        """The layer's second half: x + MLP or MoE of its normed rows."""
        h2 = layers.apply_norm(p["ln2"], x, self.cfg.norm_eps)
        if kind == "moe":
            # decode routes only a handful of tokens: dropless is mandatory
            y, _ = moe.apply_moe(p["moe"], h2, self.cfg, mesh_info=moe_info, dropless=dropless)
        else:
            y = layers.apply_mlp(p["mlp"], h2, self.cfg.d_ff)
        return x + y

    # -- the full forward (training) ------------------------------------------

    def _embed_inputs(self, params: Params, batch: dict) -> torch.Tensor:
        """The token embeddings, a vlm config's ``patch_embeds`` [B, P, d]
        over the first P rows (out of place: the rows differentiate)."""
        h = layers.embed_tokens(params["embed"], batch["tokens"], self.cfg.vocab_size)
        if self.cfg.frontend == "vision_patches" and "patch_embeds" in batch:
            patches = batch["patch_embeds"].to(h.dtype)
            h = torch.cat([patches, h[:, patches.shape[1]:]], dim=1)
        return h

    def backbone(self, params: Params, batch: dict, *,
                 moe_info=None) -> tuple[torch.Tensor, dict]:
        """``batch["tokens"]`` [B, S] -> (the final norm's rows [B, S, d],
        aux summed over the layers).  Each layer runs under the config's
        ``remat`` (:func:`_remat`) and is cast back to the residual stream's
        dtype, as JAX's scanned body."""
        cfg = self.cfg
        h = self._embed_inputs(params, batch)
        positions = torch.arange(h.shape[1], device=h.device)
        aux = _zero_aux(h.device)
        for kind, p in zip(self.kinds, params["layers"]):
            layer = _remat(functools.partial(apply_layer_full, cfg, kind, moe_info=moe_info),
                           cfg.remat)
            x, aux_l = layer(p, h, positions)
            h = x.to(h.dtype)
            aux = _merge_aux(aux, aux_l)
        return layers.apply_norm(params["ln_f"], h, cfg.norm_eps), aux

    def forward(self, params: Params, batch: dict, *,
                moe_info=None) -> tuple[torch.Tensor, dict]:
        """(logits [B, S, V] f32, aux)."""
        h, aux = self.backbone(params, batch, moe_info=moe_info)
        return layers.unembed(params["embed"], h, self.cfg.vocab_size), aux

    def loss(self, params: Params, batch: dict, *, moe_info=None) -> tuple[torch.Tensor, dict]:
        """(loss, metrics): the next-token cross entropy of
        ``batch["labels"]`` (the tokens where absent), with MoE configs'
        router terms added; the metrics hold ``nll``, ``loss`` and the aux
        sums, detached."""
        h, aux = self.backbone(params, batch, moe_info=moe_info)
        nll = chunked_ce(params["embed"], h, batch.get("labels", batch["tokens"]),
                         vocab=self.cfg.vocab_size)
        return _loss_metrics(self.cfg, nll, aux)

    # -- prefill ------------------------------------------------------------

    def prefill(self, params: Params, batch: dict, *, cache_len: int | None = None,
                moe_info=None):
        """``batch["tokens"]`` [B, S] -> (last-token logits [B, V] f32, cache).
        ``cache_len`` pre-allocates the KV or latent caches to the serving
        max length (a windowed config's ring to ``min(cache_len, window)``
        rows); an SSM model's cache has no time axis and ignores it.  A vlm
        config's ``batch["patch_embeds"]`` [B, P, d] replaces the first P
        rows' embeddings."""
        cfg = self.cfg
        V = cfg.vocab_size
        tokens = batch["tokens"]
        x = layers.embed_tokens(params["embed"], tokens, V)
        if cfg.frontend == "vision_patches" and "patch_embeds" in batch:
            patches = batch["patch_embeds"]
            x[:, :patches.shape[1]] = patches.to(x.dtype)
        S = x.shape[1]
        pos = torch.tensor(S, dtype=torch.int32, device=x.device)
        if cfg.family == "ssm":
            states, tails = [], []
            for p in params["layers"]:
                h = layers.apply_norm(p["ln1"], x, cfg.norm_eps)
                y, state, tail = ssm.ssm_full(p["mamba"], h, cfg, return_state=True)
                x = x + y
                states.append(state)
                tails.append(tail)
            h = layers.apply_norm(params["ln_f"], x, cfg.norm_eps)
            logits = layers.unembed(params["embed"], h[:, -1:], V)
            return logits[:, 0], {"pos": pos, "ssm_state": torch.stack(states),
                                  "conv_tail": torch.stack(tails)}
        positions = torch.arange(S, device=x.device)
        first, second, states, tails = [], [], [], []
        for kind, p in zip(self.kinds, params["layers"]):
            h = layers.apply_norm(p["ln1"], x, cfg.norm_eps)
            if cfg.mla is not None:
                a, c1, c2 = mla.mla_full(p["mla"], h, cfg, positions=positions)
            else:
                a, c1, c2 = layers.attention_full(p["attn"], h, cfg, positions=positions,
                                                  window=cfg.attn_window)
            if kind == "hybrid":
                y, state, tail = ssm.ssm_full(p["mamba"], h, cfg, return_state=True)
                x = x + _merge_heads(cfg, p, a, y)
                x = self._ffn(kind, p, x, dropless=False, moe_info=moe_info)
                states.append(state)
                tails.append(tail)
            else:
                x = self._ffn(kind, p, x + a, dropless=False, moe_info=moe_info)
            first.append(c1)
            second.append(c2)
        h = layers.apply_norm(params["ln_f"], x, cfg.norm_eps)
        logits = layers.unembed(params["embed"], h[:, -1:], V)
        keys = ("ckv", "krope") if cfg.mla is not None else ("k", "v")
        cache = _window_clip(cfg, {keys[0]: torch.stack(first), keys[1]: torch.stack(second)})
        cache["pos"] = pos
        if states:
            cache.update(ssm_state=torch.stack(states), conv_tail=torch.stack(tails))
        if cache_len is not None:
            cache = _pad_cache_time(cache, cache_rows(cfg, cache_len))
        return logits[:, 0], cache

    # -- chunked prefill ------------------------------------------------------

    def prefill_chunk(self, params: Params, tokens: torch.Tensor, cache: dict, *, start: int):
        """One ``[B, Sc]`` prompt chunk at absolute positions ``[start,
        start + Sc)`` -> (logits of the chunk's last row [B, V] f32, cache).

        ``cache`` is a full-capacity staging cache (``k``/``v`` ``[L, B,
        Hkv, max_len, hd]``): rows ``[0, start)`` hold the previous chunks'
        KV, and this call writes rows ``[start, start + Sc)`` in place; the
        returned cache holds the same tensors with ``pos = start + Sc``.  Row
        for row the same function as :meth:`prefill` over the whole prompt,
        which is what lets the engine interleave chunks with decode.

        A ``cache["block_table"]`` ([1, NP] int32, one sequence) makes
        ``k``/``v`` page pools ``[L, P, Hkv, ps, hd]`` instead: the chunk's
        rows are written to, and rows ``[0, start + Sc)`` read from, the
        pages the table maps them to, so no staging cache is needed.

        Only plain dense GQA models chunk: SSM, MoE and MLA models raise
        ``ValueError`` (recurrent state and capacity routing are not
        row-local across chunk boundaries), as do hybrid and windowed ones
        (a ring cache clips by position)."""
        cfg = self.cfg
        self._refuse_chunked()
        x = layers.embed_tokens(params["embed"], tokens)
        end = start + tokens.shape[1]
        table = cache.get("block_table")
        if table is not None:
            # the pool address of rows [0, end), looked up once for every layer
            ps = cache["k"].shape[3]
            rows = torch.arange(end, device=x.device)
            page, offset = table[0, rows // ps].long(), rows % ps
        for i, p in enumerate(params["layers"]):
            h = layers.apply_norm(p["ln1"], x, cfg.norm_eps)
            if table is None:
                a = layers.attention_prefill_chunk(p["attn"], h, cache["k"][i], cache["v"][i],
                                                   start, cfg)
            else:
                a = layers.attention_prefill_chunk_paged(p["attn"], h, cache["k"][i],
                                                         cache["v"][i], page, offset, start, cfg)
            x = x + a
            x = x + layers.apply_mlp(p["mlp"], layers.apply_norm(p["ln2"], x, cfg.norm_eps))
        h = layers.apply_norm(params["ln_f"], x, cfg.norm_eps)
        logits = layers.unembed(params["embed"], h[:, -1:])
        return logits[:, 0], {"pos": torch.tensor(end, dtype=torch.int32, device=x.device),
                              "k": cache["k"], "v": cache["v"]}

    # -- decode ---------------------------------------------------------------

    def decode_step(self, params: Params, tokens: torch.Tensor, cache: dict, *,
                    moe_info=None):
        """tokens [B, 1] -> (logits [B, V] f32, cache).  ``cache["pos"]`` is a
        scalar or [B] (per-slot positions); this token's k/v (or latents)
        are written into the cache in place, and the returned cache holds
        the same tensors with ``pos + 1``.  MoE layers route dropless.

        A ``cache["block_table"]`` ([B, NP] int32) switches attention to the
        paged KV path: ``k``/``v`` are then page pools ``[L, P, Hkv, ps,
        hd]`` shared by the batch, written and read through the table.  The
        table is the engine's and is not part of the returned cache; an SSM,
        MLA, hybrid or windowed model refuses it (``ValueError``).

        An SSM model's ``ssm_state`` and ``conv_tail`` are updated in place
        the same way; its layers read no position.  A hybrid model updates
        both its ring KV cache (row ``pos`` at slot ``pos % window``) and its
        SSM state.

        Under a sharded decode step (``repro_torch.serve.engine.make_decode_step``)
        the cache leaves are this rank's slices: a layer's k/v heads stay
        local where attention reads them so, as does a time-split k/v cache
        under sequence-parallel decode; any other split leaf is gathered
        whole for its layer and its slice written back after
        (:class:`_WholeCache`)."""
        cfg = self.cfg
        V = cfg.vocab_size
        x = layers.embed_tokens(params["embed"], tokens, V)
        pos = cache["pos"]
        table = cache.get("block_table")
        if table is not None:
            self._refuse_paged()
        whole = _WholeCache(cfg, cache, pos)
        if cfg.family == "ssm":
            for i, p in enumerate(params["layers"]):
                c = whole.layer(i)
                h = layers.apply_norm(p["ln1"], x, cfg.norm_eps)
                y, state, tail = ssm.ssm_decode(p["mamba"], h, c["ssm_state"], c["conv_tail"], cfg)
                c["ssm_state"].copy_(state)
                c["conv_tail"].copy_(tail)
                whole.write_back(i, c)
                x = x + y
            h = layers.apply_norm(params["ln_f"], x, cfg.norm_eps)
            logits = layers.unembed(params["embed"], h, V)
            return logits[:, 0], {"pos": pos + 1, "ssm_state": cache["ssm_state"],
                                  "conv_tail": cache["conv_tail"]}
        if table is not None:
            # each slot's write address and length, looked up once for every layer
            posb = pos.expand(x.shape[0]) if pos.dim() == 0 else pos
            page, offset = layers.page_address(table, posb, cache["k"].shape[3])
            lengths = posb + 1
        for i, (kind, p) in enumerate(zip(self.kinds, params["layers"])):
            c = whole.layer(i)
            h = layers.apply_norm(p["ln1"], x, cfg.norm_eps)
            if cfg.mla is not None:
                a = mla.mla_decode(p["mla"], h, c["ckv"], c["krope"], pos, cfg)
            elif table is None:
                a = layers.attention_decode(p["attn"], h, c["k"], c["v"], pos, cfg)
            else:
                a = layers.attention_decode_paged(p["attn"], h, c["k"], c["v"],
                                                  table, posb, page, offset, lengths, cfg)
            if kind == "hybrid":
                y, state, tail = ssm.ssm_decode(p["mamba"], h, c["ssm_state"], c["conv_tail"],
                                                cfg)
                c["ssm_state"].copy_(state)
                c["conv_tail"].copy_(tail)
                x = self._ffn(kind, p, x + _merge_heads(cfg, p, a, y), dropless=True,
                              moe_info=moe_info)
            else:
                x = self._ffn(kind, p, x + a, dropless=True, moe_info=moe_info)
            whole.write_back(i, c)
        h = layers.apply_norm(params["ln_f"], x, cfg.norm_eps)
        logits = layers.unembed(params["embed"], h, V)
        return logits[:, 0], {"pos": pos + 1, **{key: cache[key] for key in cache
                                                 if key not in ("pos", "block_table")}}

    # -- cache specs -------------------------------------------------------------

    def cache_specs(self, batch: int, cache_len: int) -> dict:
        cfg = self.cfg
        L = cfg.num_layers
        pos = ParamSpec(shape=(), dtype=torch.int32, init="zeros")
        recurrent = ({key: ParamSpec((L, *spec.shape), dtype=spec.dtype, init="zeros")
                      for key, spec in ssm.init_ssm_cache_specs(cfg, batch).items()}
                     if cfg.family in ("ssm", "hybrid") else {})
        if cfg.family == "ssm":
            return {"pos": pos, **recurrent}
        if cfg.mla is not None:
            m = cfg.mla
            return {"pos": pos,
                    "ckv": ParamSpec((L, batch, cache_len, m.kv_lora_rank),
                                     dtype=layers.COMPUTE_DTYPE, init="zeros"),
                    "krope": ParamSpec((L, batch, cache_len, m.qk_rope_dim),
                                       dtype=layers.COMPUTE_DTYPE, init="zeros")}
        kv = ParamSpec(shape=(L, batch, cfg.num_kv_heads, cache_rows(cfg, cache_len),
                              cfg.head_dim), dtype=layers.COMPUTE_DTYPE, init="zeros")
        return {"pos": pos, "k": kv, "v": kv, **recurrent}


class EncDecLM:
    """Whisper-style encoder-decoder (the conv frontend stubbed: frame
    embeddings ``[B, frontend_seq, d_model]`` in, as in the JAX package).
    The encoder's layers attend over all frames (rope at the frame's
    position, no mask); the decoder's attend causally over their own rows,
    then across to the encoder's output, whose K/V each layer computes once
    at prefill and keeps in the cache (``mem_k``, ``mem_v``).  The cache's
    ``pos`` is one scalar for the batch, as JAX's.  Training runs
    :meth:`encode` and :meth:`_decode_full` under the config's ``remat``,
    then :func:`chunked_ce` (:meth:`loss`)."""

    def __init__(self, cfg: ArchConfig, *, device: "str | torch.device" = "cuda"):
        if cfg.family != "audio":
            raise ValueError(f"{cfg.name}: EncDecLM runs the audio family, not {cfg.family!r}")
        self.cfg = cfg
        self.device = resolve_device(device)

    def param_specs(self) -> Params:
        cfg = self.cfg
        return {
            "embed": layers.embed_specs(cfg),
            "enc_pos": ParamSpec((cfg.frontend_seq, cfg.d_model), (None, "embed"), scale=0.02),
            "encoder": [layer_specs(cfg, "enc") for _ in range(cfg.encoder_layers)],
            "ln_enc": layers.norm_spec(cfg.d_model),
            "decoder": [layer_specs(cfg, "dec") for _ in range(cfg.num_layers)],
            "ln_f": layers.norm_spec(cfg.d_model),
        }

    def _mlp(self, p: Params, x: torch.Tensor) -> torch.Tensor:
        return x + layers.apply_mlp(p["mlp"], layers.apply_norm(p["ln2"], x, self.cfg.norm_eps),
                                    self.cfg.d_ff)

    def encode(self, params: Params, frames: torch.Tensor, *,
               remat: str = "none") -> torch.Tensor:
        """Frame embeddings [B, T, d] (any float type) -> the encoder's
        normed output [B, T, d] bf16, each layer under ``remat``
        (:func:`_remat`; :meth:`loss` passes the config's)."""
        cfg = self.cfg
        h = frames.to(layers.COMPUTE_DTYPE) + params["enc_pos"].to(layers.COMPUTE_DTYPE)
        positions = torch.arange(h.shape[1], device=h.device)
        layer = _remat(functools.partial(apply_layer_full, cfg, "enc"), remat)
        for p in params["encoder"]:
            h = layer(p, h, positions)[0]
        return layers.apply_norm(params["ln_enc"], h, cfg.norm_eps)

    def _decode_full(self, params: Params, tokens: torch.Tensor,
                     memory: torch.Tensor) -> torch.Tensor:
        """The decoder over all of ``tokens`` [B, S] with no cache (JAX's
        ``"full"`` mode), each layer under the config's ``remat``: its last
        layer's rows [B, S, d], before the final norm."""
        cfg = self.cfg
        h = layers.embed_tokens(params["embed"], tokens, cfg.vocab_size)
        positions = torch.arange(h.shape[1], device=h.device)
        layer = _remat(functools.partial(apply_layer_full, cfg, "dec"), cfg.remat)
        for p in params["decoder"]:
            h = layer(p, h, positions, memory)[0]
        return h

    def loss(self, params: Params, batch: dict, *, moe_info=None) -> tuple[torch.Tensor, dict]:
        """(loss, metrics) over ``batch["frames"]`` and ``batch["tokens"]``
        (``labels`` where given), as :meth:`DecoderLM.loss`; the aux metrics
        are zeros."""
        memory = self.encode(params, batch["frames"], remat=self.cfg.remat)
        h = self._decode_full(params, batch["tokens"], memory)
        h = layers.apply_norm(params["ln_f"], h, self.cfg.norm_eps)
        nll = chunked_ce(params["embed"], h, batch.get("labels", batch["tokens"]),
                         vocab=self.cfg.vocab_size)
        return _loss_metrics(self.cfg, nll, _zero_aux(h.device))

    def prefill(self, params: Params, batch: dict, *, cache_len: int | None = None,
                moe_info=None):
        """``batch["tokens"]`` [B, S] and ``batch["frames"]`` [B, T_enc, d]
        -> (last-token logits [B, V] f32, cache).  ``cache_len`` pads the
        self-attention caches to the decoder's serving length; the memory's
        K/V keep the encoder's T_enc rows."""
        memory = self.encode(params, batch["frames"])
        return self.decoder_prefill(params, batch["tokens"], memory, cache_len=cache_len)

    def decoder_prefill(self, params: Params, tokens: torch.Tensor, memory: torch.Tensor, *,
                        cache_len: int | None = None):
        """:meth:`prefill`'s decoder half: ``tokens`` [B, S] over the
        encoder's output ``memory`` [B, T_enc, d] (:meth:`encode`)."""
        cfg = self.cfg
        x = layers.embed_tokens(params["embed"], tokens, cfg.vocab_size)
        S = x.shape[1]
        positions = torch.arange(S, device=x.device)
        caches: dict[str, list] = {"k": [], "v": [], "mem_k": [], "mem_v": []}
        for p in params["decoder"]:
            h = layers.apply_norm(p["ln1"], x, cfg.norm_eps)
            a, k, v = layers.attention_full(p["attn"], h, cfg, positions=positions)
            x = x + a
            mem_k, mem_v = layers.encode_memory(p["xattn"], memory, cfg)
            hx = layers.apply_norm(p["lnx"], x, cfg.norm_eps)
            x = self._mlp(p, x + layers.cross_attention(p["xattn"], hx, mem_k, mem_v, cfg))
            for key, t in zip(caches, (k, v, mem_k, mem_v)):
                caches[key].append(t)
        h = layers.apply_norm(params["ln_f"], x, cfg.norm_eps)
        logits = layers.unembed(params["embed"], h[:, -1:], cfg.vocab_size)
        cache = {key: torch.stack(ts) for key, ts in caches.items()}
        if cache_len is not None:
            # the memory's K/V are fixed-length: only self-attention pads
            cache.update(_pad_cache_time({"k": cache["k"], "v": cache["v"]}, cache_len))
        cache["pos"] = torch.tensor(S, dtype=torch.int32, device=x.device)
        return logits[:, 0], cache

    def decode_step(self, params: Params, tokens: torch.Tensor, cache: dict, *,
                    moe_info=None):
        """tokens [B, 1] -> (logits [B, V] f32, cache): this token's k/v are
        written at row ``pos`` (a scalar) in place, and the returned cache
        holds the same tensors with ``pos + 1``.  Sharded, as
        :meth:`DecoderLM.decode_step`."""
        cfg = self.cfg
        x = layers.embed_tokens(params["embed"], tokens, cfg.vocab_size)
        pos = cache["pos"]
        whole = _WholeCache(cfg, cache, pos)
        for i, p in enumerate(params["decoder"]):
            c = whole.layer(i)
            h = layers.apply_norm(p["ln1"], x, cfg.norm_eps)
            x = x + layers.attention_decode(p["attn"], h, c["k"], c["v"], pos, cfg)
            hx = layers.apply_norm(p["lnx"], x, cfg.norm_eps)
            x = self._mlp(p, x + layers.cross_attention(p["xattn"], hx, c["mem_k"], c["mem_v"],
                                                        cfg))
            whole.write_back(i, c)
        h = layers.apply_norm(params["ln_f"], x, cfg.norm_eps)
        logits = layers.unembed(params["embed"], h, cfg.vocab_size)
        return logits[:, 0], {**cache, "pos": pos + 1}

    def cache_specs(self, batch: int, cache_len: int) -> dict:
        cfg = self.cfg
        L, hkv, hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
        kv = ParamSpec((L, batch, hkv, cache_len, hd), dtype=layers.COMPUTE_DTYPE, init="zeros")
        mem = ParamSpec((L, batch, hkv, cfg.frontend_seq, hd), dtype=layers.COMPUTE_DTYPE,
                        init="zeros")
        return {"pos": ParamSpec(shape=(), dtype=torch.int32, init="zeros"), "k": kv, "v": kv,
                "mem_k": mem, "mem_v": mem}


def build_model(cfg: ArchConfig, *,
                device: "str | torch.device" = "cuda") -> "DecoderLM | EncDecLM":
    if cfg.family == "audio":
        return EncDecLM(cfg, device=device)
    return DecoderLM(cfg, device=device)
