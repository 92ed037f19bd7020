"""The decoder: ``DecoderLM`` of ``repro/models/model.py`` for the
``dense`` and ``vlm`` families (llama3_2_1b, yi, granite: GQA attention +
SwiGLU), the ``moe`` family (llama4-maverick: GQA with a (moe, dense)
unit; deepseek-v3: MLA, 3 dense layers then MoE) and the ``ssm`` family
(mamba2: Mamba-2 blocks, no attention, no MLP).

Layers run in a Python loop (JAX scanned stacked segments); parameters are
one dict per layer, and :attr:`DecoderLM.kinds` names each layer's kind
(``dense``, ``moe`` or ``ssm``) in JAX's segment order
(:func:`plan_segments`).  The cache keeps JAX's stacked layout over all
layers, so no ``segments`` list: ``{"pos", "k": [L, B, Hkv, T, hd], "v":
...}`` for GQA models, ``{"pos", "ckv": [L, B, T, r], "krope": [L, B, T,
rope]}`` for MLA ones, ``{"pos", "ssm_state": [L, B, H, P, N] f32,
"conv_tail": [L, B, K-1, C]}`` for SSM ones.  Decode updates it in place
where JAX returned a new one.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers, mla, moe, ssm
from repro_torch.models.params import ParamSpec, resolve_device

Params = Any


@dataclasses.dataclass(frozen=True)
class Segment:
    kinds: tuple[str, ...]           # layer kinds within one repeated unit
    count: int                       # repeats


def plan_segments(cfg: ArchConfig) -> list[Segment]:
    """JAX's segment plan: dense/vlm [dense x L]; moe [dense x first_k_dense,
    (moe, dense x (period - 1)) x the rest]; ssm [ssm x L]."""
    if cfg.family == "ssm":
        return [Segment(("ssm",), cfg.num_layers)]
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
    attn = ({"mla": mla.mla_specs(cfg)} if cfg.mla is not None
            else {"attn": layers.attention_specs(cfg)})
    ffn = {"moe": moe.moe_specs(cfg)} if kind == "moe" else {"mlp": layers.mlp_specs(cfg)}
    return {"ln1": layers.norm_spec(d), **attn, "ln2": layers.norm_spec(d), **ffn}


#: the cache leaves with a time axis (its second to last)
TIME_KEYS = frozenset({"k", "v", "ckv", "krope"})


def _pad_cache_time(cache: dict, cache_len: int) -> dict:
    """Zero-pad the prefill KV (or latent) caches along the time axis to
    ``cache_len``.  Zeros, not ``torch.empty``: decode attention multiplies
    masked rows' values by a zero probability, and 0 * NaN would poison the
    product."""
    out = dict(cache)
    for key in TIME_KEYS & set(cache):
        x = cache[key]
        cur = x.shape[-2]
        if cur < cache_len:
            padded = x.new_zeros((*x.shape[:-2], cache_len, x.shape[-1]))
            padded[..., :cur, :] = x
            out[key] = padded
    return out


class DecoderLM:
    """Decoder-only LM: dense, vlm, moe (with GQA or MLA attention) and ssm."""

    def __init__(self, cfg: ArchConfig, *, device: "str | torch.device" = "cuda"):
        if cfg.family in ("hybrid", "audio") or cfg.attn_window is not None:
            raise NotImplementedError(
                f"{cfg.name}: the port runs dense and MoE decoders (GQA or MLA) and Mamba-2 "
                "so far (ROADMAP: hybrid, windowed and audio models come in later slices)"
            )
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
        sequentially, and MLA's latents have no chunk path."""
        cfg = self.cfg
        # the first layer that refuses, as JAX's layer loop meets it
        kind = next((k for k in self.kinds if k != "dense" or cfg.mla is not None), None)
        if kind is not None:
            raise ValueError(f"chunked prefill supports plain dense GQA layers only, not "
                             f"{kind!r} (mla={cfg.mla is not None}, window={cfg.attn_window})")

    def _refuse_paged(self) -> None:
        """Only plain position-indexed GQA caches page (dense and moe layers)."""
        cfg = self.cfg
        if cfg.family == "ssm" or cfg.mla is not None:
            raise ValueError(f"paged decode supports plain GQA KV caches only, not "
                             f"{self.kinds[0]!r} (mla={cfg.mla is not None}, "
                             f"window={cfg.attn_window})")

    def _ffn(self, kind: str, p: Params, x: torch.Tensor, *, dropless: bool) -> torch.Tensor:
        """The layer's second half: x + MLP or MoE of its normed rows."""
        h2 = layers.apply_norm(p["ln2"], x, self.cfg.norm_eps)
        if kind == "moe":
            # decode routes only a handful of tokens: dropless is mandatory
            y, _ = moe.apply_moe(p["moe"], h2, self.cfg, dropless=dropless)
        else:
            y = layers.apply_mlp(p["mlp"], h2)
        return x + y

    # -- prefill ------------------------------------------------------------

    def prefill(self, params: Params, batch: dict, *, cache_len: int | None = None):
        """``batch["tokens"]`` [B, S] -> (last-token logits [B, V] f32, cache).
        ``cache_len`` pre-allocates the KV or latent caches to the serving
        max length; an SSM model's cache has no time axis and ignores it.
        A vlm config's ``batch["patch_embeds"]`` [B, P, d] replaces the
        first P rows' embeddings."""
        cfg = self.cfg
        tokens = batch["tokens"]
        x = layers.embed_tokens(params["embed"], tokens)
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
            logits = layers.unembed(params["embed"], h[:, -1:])
            return logits[:, 0], {"pos": pos, "ssm_state": torch.stack(states),
                                  "conv_tail": torch.stack(tails)}
        positions = torch.arange(S, device=x.device)
        first, second = [], []
        for kind, p in zip(self.kinds, params["layers"]):
            h = layers.apply_norm(p["ln1"], x, cfg.norm_eps)
            if cfg.mla is not None:
                a, c1, c2 = mla.mla_full(p["mla"], h, cfg, positions=positions)
            else:
                a, c1, c2 = layers.attention_full(p["attn"], h, cfg, positions=positions)
            x = self._ffn(kind, p, x + a, dropless=False)
            first.append(c1)
            second.append(c2)
        h = layers.apply_norm(params["ln_f"], x, cfg.norm_eps)
        logits = layers.unembed(params["embed"], h[:, -1:])
        keys = ("ckv", "krope") if cfg.mla is not None else ("k", "v")
        cache = {"pos": pos, keys[0]: torch.stack(first), keys[1]: torch.stack(second)}
        if cache_len is not None:
            cache = _pad_cache_time(cache, cache_len)
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
        row-local across chunk boundaries)."""
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

    def decode_step(self, params: Params, tokens: torch.Tensor, cache: dict):
        """tokens [B, 1] -> (logits [B, V] f32, cache).  ``cache["pos"]`` is a
        scalar or [B] (per-slot positions); this token's k/v (or latents)
        are written into the cache in place, and the returned cache holds
        the same tensors with ``pos + 1``.  MoE layers route dropless.

        A ``cache["block_table"]`` ([B, NP] int32) switches attention to the
        paged KV path: ``k``/``v`` are then page pools ``[L, P, Hkv, ps,
        hd]`` shared by the batch, written and read through the table.  The
        table is the engine's and is not part of the returned cache; an SSM
        or MLA model refuses it (``ValueError``).

        An SSM model's ``ssm_state`` and ``conv_tail`` are updated in place
        the same way; its layers read no position."""
        cfg = self.cfg
        x = layers.embed_tokens(params["embed"], tokens)
        pos = cache["pos"]
        table = cache.get("block_table")
        if table is not None:
            self._refuse_paged()
        if cfg.family == "ssm":
            for i, p in enumerate(params["layers"]):
                h = layers.apply_norm(p["ln1"], x, cfg.norm_eps)
                y, state, tail = ssm.ssm_decode(p["mamba"], h, cache["ssm_state"][i],
                                                cache["conv_tail"][i], cfg)
                cache["ssm_state"][i].copy_(state)
                cache["conv_tail"][i].copy_(tail)
                x = x + y
            h = layers.apply_norm(params["ln_f"], x, cfg.norm_eps)
            logits = layers.unembed(params["embed"], h)
            return logits[:, 0], {"pos": pos + 1, "ssm_state": cache["ssm_state"],
                                  "conv_tail": cache["conv_tail"]}
        if table is not None:
            # each slot's write address and length, looked up once for every layer
            posb = pos.expand(x.shape[0]) if pos.dim() == 0 else pos
            page, offset = layers.page_address(table, posb, cache["k"].shape[3])
            lengths = posb + 1
        for i, (kind, p) in enumerate(zip(self.kinds, params["layers"])):
            h = layers.apply_norm(p["ln1"], x, cfg.norm_eps)
            if cfg.mla is not None:
                a = mla.mla_decode(p["mla"], h, cache["ckv"][i], cache["krope"][i], pos, cfg)
            elif table is None:
                a = layers.attention_decode(p["attn"], h, cache["k"][i], cache["v"][i], pos, cfg)
            else:
                a = layers.attention_decode_paged(p["attn"], h, cache["k"][i], cache["v"][i],
                                                  table, posb, page, offset, lengths, cfg)
            x = self._ffn(kind, p, x + a, dropless=True)
        h = layers.apply_norm(params["ln_f"], x, cfg.norm_eps)
        logits = layers.unembed(params["embed"], h)
        return logits[:, 0], {"pos": pos + 1, **{key: cache[key] for key in TIME_KEYS
                                                 if key in cache}}

    # -- cache specs -------------------------------------------------------------

    def cache_specs(self, batch: int, cache_len: int) -> dict:
        cfg = self.cfg
        L = cfg.num_layers
        pos = ParamSpec(shape=(), dtype=torch.int32, init="zeros")
        if cfg.family == "ssm":
            return {"pos": pos, **{
                key: ParamSpec((L, *spec.shape), dtype=spec.dtype, init="zeros")
                for key, spec in ssm.init_ssm_cache_specs(cfg, batch).items()}}
        if cfg.mla is not None:
            m = cfg.mla
            return {"pos": pos,
                    "ckv": ParamSpec((L, batch, cache_len, m.kv_lora_rank),
                                     dtype=layers.COMPUTE_DTYPE, init="zeros"),
                    "krope": ParamSpec((L, batch, cache_len, m.qk_rope_dim),
                                       dtype=layers.COMPUTE_DTYPE, init="zeros")}
        kv = ParamSpec(shape=(L, batch, cfg.num_kv_heads, cache_len, cfg.head_dim),
                       dtype=layers.COMPUTE_DTYPE, init="zeros")
        return {"pos": pos, "k": kv, "v": kv}


def build_model(cfg: ArchConfig, *, device: "str | torch.device" = "cuda") -> DecoderLM:
    return DecoderLM(cfg, device=device)
