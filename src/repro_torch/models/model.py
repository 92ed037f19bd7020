"""The decoder: ``DecoderLM`` of ``repro/models/model.py`` for the ``dense``
family (llama3_2_1b, yi, granite: GQA attention + SwiGLU) and the ``ssm``
family (mamba2: Mamba-2 blocks, no attention, no MLP).

Layers run in a Python loop (JAX scanned a stacked segment); parameters are
one dict per layer.  The cache keeps JAX's stacked layout, one segment, so no
``segments`` list: ``{"pos", "k": [L, B, Hkv, T, hd], "v": ...}`` for dense
models, ``{"pos", "ssm_state": [L, B, H, P, N] f32, "conv_tail": [L, B,
K-1, C]}`` for SSM ones.  Decode updates it in place where JAX returned a
new one.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers, ssm
from repro_torch.models.params import ParamSpec, resolve_device

Params = Any


def layer_specs(cfg: ArchConfig) -> Params:
    d = cfg.d_model
    if cfg.family == "ssm":
        return {"ln1": layers.norm_spec(d), "mamba": ssm.ssm_specs(cfg)}
    return {
        "ln1": layers.norm_spec(d),
        "attn": layers.attention_specs(cfg),
        "ln2": layers.norm_spec(d),
        "mlp": layers.mlp_specs(cfg),
    }


def _pad_cache_time(cache: dict, cache_len: int) -> dict:
    """Zero-pad the prefill KV caches along the time axis to ``cache_len``.
    Zeros, not ``torch.empty``: decode attention multiplies masked rows' values
    by a zero probability, and 0 * NaN would poison the product."""
    out = dict(cache)
    for key in ("k", "v"):
        x = cache[key]
        cur = x.shape[-2]
        if cur < cache_len:
            padded = x.new_zeros((*x.shape[:-2], cache_len, x.shape[-1]))
            padded[..., :cur, :] = x
            out[key] = padded
    return out


def _refuse_recurrent(cfg: ArchConfig, what: str) -> None:
    """Chunked prefill and paged decode take plain GQA KV caches only."""
    if cfg.family != "dense":
        raise ValueError(f"{what} supports plain dense GQA layers only, not {cfg.family!r} "
                         f"(mla={cfg.mla is not None}, window={cfg.attn_window})")


class DecoderLM:
    """Decoder-only LM, dense and ssm families."""

    def __init__(self, cfg: ArchConfig, *, device: "str | torch.device" = "cuda"):
        if (cfg.family not in ("dense", "ssm") or cfg.moe is not None or cfg.mla is not None
                or cfg.attn_window is not None):
            raise NotImplementedError(
                f"{cfg.name}: the port runs plain dense GQA decoders and Mamba-2 so far "
                "(ROADMAP: MLA/MoE, hybrid and windowed models come in later slices)"
            )
        self.cfg = cfg
        self.device = resolve_device(device)

    # -- parameters --------------------------------------------------------

    def param_specs(self) -> Params:
        cfg = self.cfg
        return {
            "embed": layers.embed_specs(cfg),
            "layers": [layer_specs(cfg) for _ in range(cfg.num_layers)],
            "ln_f": layers.norm_spec(cfg.d_model),
        }

    # -- prefill ------------------------------------------------------------

    def prefill(self, params: Params, batch: dict, *, cache_len: int | None = None):
        """``batch["tokens"]`` [B, S] -> (last-token logits [B, V] f32, cache).
        ``cache_len`` pre-allocates the KV caches to the serving max length;
        an SSM model's cache has no time axis and ignores it."""
        cfg = self.cfg
        tokens = batch["tokens"]
        x = layers.embed_tokens(params["embed"], tokens)
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
        ks, vs = [], []
        for p in params["layers"]:
            h = layers.apply_norm(p["ln1"], x, cfg.norm_eps)
            a, k, v = layers.attention_full(p["attn"], h, cfg, positions=positions)
            x = x + a
            x = x + layers.apply_mlp(p["mlp"], layers.apply_norm(p["ln2"], x, cfg.norm_eps))
            ks.append(k)
            vs.append(v)
        h = layers.apply_norm(params["ln_f"], x, cfg.norm_eps)
        logits = layers.unembed(params["embed"], h[:, -1:])
        cache = {"pos": pos, "k": torch.stack(ks), "v": torch.stack(vs)}
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

        SSM models raise ``ValueError``: their recurrent state is not
        row-local across chunk boundaries."""
        cfg = self.cfg
        _refuse_recurrent(cfg, "chunked prefill")
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
        scalar or [B] (per-slot positions); this token's k/v are written into
        ``cache["k"]``/``cache["v"]`` in place, and the returned cache holds
        the same tensors with ``pos + 1``.

        A ``cache["block_table"]`` ([B, NP] int32) switches attention to the
        paged KV path: ``k``/``v`` are then page pools ``[L, P, Hkv, ps,
        hd]`` shared by the batch, written and read through the table.  The
        table is the engine's and is not part of the returned cache; an SSM
        model refuses it (``ValueError``).

        An SSM model's ``ssm_state`` and ``conv_tail`` are updated in place
        the same way; its layers read no position."""
        cfg = self.cfg
        x = layers.embed_tokens(params["embed"], tokens)
        pos = cache["pos"]
        table = cache.get("block_table")
        if cfg.family == "ssm":
            if table is not None:
                _refuse_recurrent(cfg, "paged decode")
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
        for i, p in enumerate(params["layers"]):
            h = layers.apply_norm(p["ln1"], x, cfg.norm_eps)
            if table is None:
                a = layers.attention_decode(p["attn"], h, cache["k"][i], cache["v"][i], pos, cfg)
            else:
                a = layers.attention_decode_paged(p["attn"], h, cache["k"][i], cache["v"][i],
                                                  table, posb, page, offset, lengths, cfg)
            x = x + a
            x = x + layers.apply_mlp(p["mlp"], layers.apply_norm(p["ln2"], x, cfg.norm_eps))
        h = layers.apply_norm(params["ln_f"], x, cfg.norm_eps)
        logits = layers.unembed(params["embed"], h)
        return logits[:, 0], {"pos": pos + 1, "k": cache["k"], "v": cache["v"]}

    # -- cache specs -------------------------------------------------------------

    def cache_specs(self, batch: int, cache_len: int) -> dict:
        cfg = self.cfg
        pos = ParamSpec(shape=(), dtype=torch.int32, init="zeros")
        if cfg.family == "ssm":
            return {"pos": pos, **{
                key: ParamSpec((cfg.num_layers, *spec.shape), dtype=spec.dtype, init="zeros")
                for key, spec in ssm.init_ssm_cache_specs(cfg, batch).items()}}
        kv = ParamSpec(shape=(cfg.num_layers, batch, cfg.num_kv_heads, cache_len, cfg.head_dim),
                       dtype=layers.COMPUTE_DTYPE, init="zeros")
        return {"pos": pos, "k": kv, "v": kv}


def build_model(cfg: ArchConfig, *, device: "str | torch.device" = "cuda") -> DecoderLM:
    return DecoderLM(cfg, device=device)
