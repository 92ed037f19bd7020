"""Mamba-2 block (SSD core + depthwise causal conv + gated norm): the port of
``repro/models/ssm.py``.

Layer structure (arXiv:2405.21060):

  u = in_proj(x)          -> [z | xBC | dt]
  xBC = silu(causal_conv1d(xBC))           (kernel 4, depthwise)
  y = SSD(x_heads, a_log, B, C, softplus(dt + dt_bias)) + D ⊙ x_heads
  out = out_proj(rmsnorm(y ⊙ silu(z)))

The projections, the norm and the prefill's SSD scan go through
``dispatch.op``; the causal conv, the gating and the decode step's
single-token update are eager torch, as they are ``jnp`` in JAX.  Decode
carries two state tensors: the SSD state [B, H, P, N] f32 and the conv tail
[B, K-1, conv_channels] (pre-activation).  Under sharding rules the leaves
the rules split (the inner widths, over the model axis) are gathered whole
and the block runs as on one device.
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.core import dispatch
from repro_torch.kernels.ops import ssd_step
from repro_torch.models import layers
from repro_torch.models.params import ParamSpec

Params = Any


def _dims(cfg: ArchConfig):
    s = cfg.ssm
    assert s is not None
    d_in = s.d_inner(cfg.d_model)
    H = s.num_heads(cfg.d_model)
    conv_ch = d_in + 2 * s.num_groups * s.state_dim
    return s, d_in, H, conv_ch


def ssm_specs(cfg: ArchConfig) -> Params:
    s, d_in, H, conv_ch = _dims(cfg)
    d = cfg.d_model
    proj_out = 2 * d_in + 2 * s.num_groups * s.state_dim + H
    return {
        "in_proj": ParamSpec((d, proj_out), ("embed", "ssm_inner"), scale=1.0 / math.sqrt(d)),
        "conv_w": ParamSpec((s.conv_kernel, conv_ch), (None, "ssm_inner"),
                            scale=1.0 / math.sqrt(s.conv_kernel)),
        "conv_b": ParamSpec((conv_ch,), ("ssm_inner",), init="zeros"),
        "a_log": ParamSpec((H,), (None,), dtype=torch.float32, init="ssm_a"),
        "skip_d": ParamSpec((H,), (None,), dtype=torch.float32, init="ones"),
        "dt_bias": ParamSpec((H,), (None,), dtype=torch.float32, init="zeros"),
        "norm": layers.norm_spec(d_in),
        "out_proj": ParamSpec((d_in, d), ("ssm_inner", "embed"), scale=1.0 / math.sqrt(d_in)),
    }


def _split_proj(u: torch.Tensor, cfg: ArchConfig):
    s, d_in, H, _ = _dims(cfg)
    gn = s.num_groups * s.state_dim
    z = u[..., :d_in]
    xbc = u[..., d_in: 2 * d_in + 2 * gn]
    dt = u[..., 2 * d_in + 2 * gn:]
    return z, xbc, dt


def _conv_full(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor, K: int) -> torch.Tensor:
    """Causal depthwise conv over [B, S, C] with small static kernel K."""
    pads = F.pad(xbc, (0, 0, K - 1, 0))
    S = xbc.shape[1]
    acc = torch.zeros(xbc.shape, dtype=torch.float32, device=xbc.device)
    for i in range(K):                       # static unroll, K = 4
        acc = acc + pads[:, i: i + S, :].float() * w[i].float()
    y = acc + b.float()
    return (y * torch.sigmoid(y)).to(xbc.dtype)                  # silu


def _post(p: Params, y_heads: torch.Tensor, z: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Skip, gated norm, output projection. y_heads [..., H, P]."""
    _, d_in, _, _ = _dims(cfg)
    y = y_heads.reshape(*y_heads.shape[:-2], d_in)
    zf = z.float()
    gated = y.float() * (zf * torch.sigmoid(zf))
    normed = layers.apply_norm(p["norm"], gated.to(y.dtype), cfg.norm_eps)
    return dispatch.op("matmul", normed, p["out_proj"])


def ssm_full(p: Params, x: torch.Tensor, cfg: ArchConfig, *, return_state: bool = False):
    """Prefill path via the chunked SSD op.  x [B, S, d]; with
    ``return_state`` also the final SSD state [B, H, P, N] f32 and the conv
    tail [B, K-1, C], the last K-1 pre-activation rows of the zero-padded
    sequence (JAX slices the unpadded rows, which for S < K-1 gives a tail
    of S rows: see ROADMAP §3)."""
    s, d_in, H, _ = _dims(cfg)
    B, S, _ = x.shape
    K = s.conv_kernel
    p = layers.whole_tree(p, ssm_specs(cfg))        # under rules: the inner widths whole
    u = dispatch.op("matmul", x, p["in_proj"])
    z, xbc, dt = _split_proj(u, cfg)
    conv_tail = F.pad(xbc[:, -(K - 1):], (0, 0, max(0, K - 1 - S), 0))
    xbc = _conv_full(xbc, p["conv_w"], p["conv_b"], K)
    gn = s.num_groups * s.state_dim
    xs, bc = xbc[..., :d_in], xbc[..., d_in:]
    # views of the conv output: the cuda source reads them through their strides
    bmat = bc[..., :gn].reshape(B, S, s.num_groups, s.state_dim)
    cmat = bc[..., gn:].reshape(B, S, s.num_groups, s.state_dim)
    x_heads = xs.reshape(B, S, H, s.head_dim)
    dt = F.softplus(dt.float() + p["dt_bias"])
    res = dispatch.op("ssd", x_heads, p["a_log"], bmat, cmat, dt,
                      chunk=s.chunk, return_state=return_state)
    y, state = res if return_state else (res, None)
    y = y + (p["skip_d"][:, None] * x_heads.float()).to(y.dtype)
    out = _post(p, y, z, cfg)
    if return_state:
        return out, state, conv_tail
    return out


def ssm_decode(p: Params, x: torch.Tensor, ssm_state: torch.Tensor, conv_tail: torch.Tensor,
               cfg: ArchConfig):
    """One token: x [B, 1, d], ssm_state [B, H, P, N] f32, conv_tail
    [B, K-1, C] pre-activation -> (out [B, 1, d], new state, new tail)."""
    s, d_in, H, _ = _dims(cfg)
    B = x.shape[0]
    p = layers.whole_tree(p, ssm_specs(cfg))
    u = dispatch.op("matmul", x[:, 0], p["in_proj"])             # [B, proj]
    z, xbc_t, dt = _split_proj(u, cfg)
    window = torch.cat([conv_tail, xbc_t[:, None, :]], dim=1)    # [B, K, C]
    yconv = (torch.einsum("bkc,kc->bc", window.float(), p["conv_w"].float())
             + p["conv_b"].float())
    yconv = (yconv * torch.sigmoid(yconv)).to(x.dtype)
    gn = s.num_groups * s.state_dim
    xs, bc = yconv[..., :d_in], yconv[..., d_in:]
    bvec = bc[..., :gn].reshape(B, s.num_groups, s.state_dim)
    cvec = bc[..., gn:].reshape(B, s.num_groups, s.state_dim)
    x_heads = xs.reshape(B, H, s.head_dim)
    dt = F.softplus(dt.float() + p["dt_bias"])
    new_state, y = ssd_step(ssm_state, x_heads, p["a_log"], bvec, cvec, dt)
    y = y + (p["skip_d"][:, None] * x_heads.float()).to(y.dtype)
    out = _post(p, y[:, None], z[:, None], cfg)
    new_tail = window[:, 1:, :].to(conv_tail.dtype)
    return out, new_state, new_tail


def init_ssm_cache_specs(cfg: ArchConfig, batch: int) -> dict:
    """One layer's SSM cache: the SSD state and the conv tail."""
    s, _, H, conv_ch = _dims(cfg)
    return {
        "ssm_state": ParamSpec((batch, H, s.head_dim, s.state_dim), dtype=torch.float32,
                               init="zeros"),
        "conv_tail": ParamSpec((batch, s.conv_kernel - 1, conv_ch), dtype=layers.COMPUTE_DTYPE,
                               init="zeros"),
    }
