"""Registered kernel implementations — the role catalogue.

Importing this module populates ``GLOBAL_REGISTRY`` with three sources per op:

  - ``reference``: the torch oracle (ref.py),
  - ``torch``: the eager formulation, the counterpart of the JAX package's
    ``xla`` source with the same casts (``repro/kernels/ops.py``),
  - ``cuda``: the kernel written by hand for Hopper (the presynthesized role).

Model code never imports these directly; it calls ``dispatch.op(name, ...)``.

Beside each op's sources stands its cost (``register_cost``): the work of
the hand-written kernel the op runs under ``cuda-strict``, each operand
read once and the result written once, and the FLOPs of its products, by
the formula ``chip_smoke.py``'s kernel rows take for their bound.  The
roofline's counter (:mod:`repro_torch.roofline.analysis`) reads it in place
of whatever the op's source computes.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core.dispatch import register_cost
from repro_torch.core.registry import GLOBAL_REGISTRY as REG
from repro_torch.core.registry import KernelImpl
from repro_torch.kernels import conv2d as conv2d_k
from repro_torch.kernels import decode_attention as dec_k
from repro_torch.kernels import flash_attention as fa_k
from repro_torch.kernels import matmul as matmul_k
from repro_torch.kernels import paged_decode_attention as paged_k
from repro_torch.kernels import ref
from repro_torch.kernels import rmsnorm as rmsnorm_k
from repro_torch.kernels import ssd as ssd_k

# --------------------------------------------------------------------------
# matmul
# --------------------------------------------------------------------------


def torch_matmul(x, w, *, out_dtype=None, activation=None):
    """Emits the input dtype directly for bf16 inputs (f32 accumulation
    inside the product either way), as ``xla_matmul`` does; silu then runs
    in that dtype with an f32 sigmoid."""
    target = out_dtype or x.dtype
    if target == torch.float32:
        acc = torch.matmul(x.float(), w.float())
    else:
        acc = torch.matmul(x, w)
    if activation == "silu":
        acc = acc * torch.sigmoid(acc.float()).to(acc.dtype)
    elif activation == "gelu":
        acc = torch.nn.functional.gelu(acc, approximate="tanh")
    elif activation is not None:
        raise ValueError(activation)
    return acc.to(target)


REG.register(KernelImpl(op="matmul", device_kind="any", source="reference", fn=ref.matmul))
REG.register(KernelImpl(op="matmul", device_kind="any", source="torch", fn=torch_matmul))
REG.register(KernelImpl(op="matmul", device_kind="cuda", source="cuda", fn=matmul_k.matmul,
                        footprint=matmul_k.footprint()))


def nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def matmul_cost(out, x, w, **_):
    """[M,K] x [K,N]: 2MNK FLOPs; x, w and the output's bytes."""
    K, N = w.shape
    M = x.numel() // K
    return 2 * M * N * K, nbytes(x) + nbytes(w) + nbytes(out)


register_cost("matmul", matmul_cost)

# --------------------------------------------------------------------------
# rmsnorm
# --------------------------------------------------------------------------

REG.register(KernelImpl(op="rmsnorm", device_kind="any", source="reference", fn=ref.rmsnorm))
REG.register(KernelImpl(op="rmsnorm", device_kind="any", source="torch", fn=ref.rmsnorm))
REG.register(KernelImpl(op="rmsnorm", device_kind="cuda", source="cuda", fn=rmsnorm_k.rmsnorm))


def rmsnorm_cost(out, x, weight, **_):
    """4 FLOPs an element (square, sum, scale, weight); x, w, out."""
    return 4 * x.numel(), nbytes(x) + nbytes(weight) + nbytes(out)


register_cost("rmsnorm", rmsnorm_cost)

# --------------------------------------------------------------------------
# flash attention
# --------------------------------------------------------------------------


def torch_flash_attention(q, k, v, *, causal: bool = True, window: int | None = None,
                          scale: float | None = None, block_q: int = 512):
    """Memory-efficient exact attention over query chunks, as
    ``xla_flash_attention``: f32 logits and softmax statistics, probabilities
    stored in the compute dtype for the P V product (f32 accumulation)."""
    B, Hq, S, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    group = Hq // Hkv
    scale_ = scale if scale is not None else 1.0 / math.sqrt(D)
    bq = min(block_q, S)
    while S % bq:
        bq //= 2
    kv_offset = T - S
    kg = k.repeat_interleave(group, dim=1).float()
    vg = v.repeat_interleave(group, dim=1).float()
    kpos = torch.arange(T, device=q.device)[None, :]
    outs = []
    for i in range(S // bq):
        qb = q[:, :, i * bq:(i + 1) * bq].float()
        logits = torch.einsum("bhsd,bhtd->bhst", qb, kg) * scale_
        qpos = (i * bq + torch.arange(bq, device=q.device) + kv_offset)[:, None]
        mask = torch.ones((bq, T), dtype=torch.bool, device=q.device)
        if causal:
            mask &= kpos <= qpos
        if window is not None:
            mask &= kpos > qpos - window
        logits = torch.where(mask, logits, -1e30)
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        outs.append(torch.einsum("bhst,bhtd->bhsd", probs.float(), vg))
    return torch.cat(outs, dim=2).to(q.dtype)


REG.register(KernelImpl(op="flash_attention", device_kind="any", source="reference",
                        fn=ref.flash_attention))
REG.register(KernelImpl(op="flash_attention", device_kind="any", source="torch",
                        fn=torch_flash_attention))
REG.register(KernelImpl(op="flash_attention", device_kind="cuda", source="cuda",
                        fn=fa_k.flash_attention))


def attended_pairs(S: int, T: int, causal: bool, window: int | None) -> int:
    """The (query, key) pairs the mask keeps: query i sits at position
    i + T - S (a chunk's queries are the last S of T), causal keeps keys at
    or before it, a window the last ``window`` of those."""
    pos = np.arange(S, dtype=np.int64) + (T - S)
    hi = np.minimum(pos, T - 1) if causal else np.full(S, T - 1)
    lo = np.maximum(pos - window + 1, 0) if window is not None else np.zeros(S, np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def flash_attention_cost(out, q, k, v, *, causal: bool = True, window: int | None = None, **_):
    """2·(Dqk + Dv) FLOPs a query head a kept pair (q·k and p·v); q, k, v
    and the output's bytes, never the S x T scores."""
    B, Hq, S, Dqk = q.shape
    T, Dv = k.shape[2], v.shape[3]
    flops = 2 * B * Hq * (Dqk + Dv) * attended_pairs(S, T, causal, window)
    return flops, nbytes(q) + nbytes(k) + nbytes(v) + nbytes(out)


register_cost("flash_attention", flash_attention_cost)

# --------------------------------------------------------------------------
# decode attention (single-token query over a padded KV cache)
# --------------------------------------------------------------------------


def torch_decode_attention(q, k_cache, v_cache, length, *, scale=None):
    """Grouped-GQA decode attention as ``xla_decode_attention``: no
    head-repeat materialization; f32 logits, probabilities in the cache dtype
    for the P V product, normalized after it."""
    B, Hq, D = q.shape
    Hkv, T = k_cache.shape[1], k_cache.shape[2]
    group = Hq // Hkv
    scale_ = scale if scale is not None else 1.0 / math.sqrt(D)
    qg = q.reshape(B, Hkv, group, D).float()
    logits = torch.einsum("bkgd,bktd->bkgt", qg, k_cache.float()) * scale_
    lengths = dec_k.lengths_vector(length, B, q.device)
    valid = torch.arange(T, device=q.device)[None, None, None, :] < lengths[:, None, None, None]
    logits = torch.where(valid, logits, -1e30)
    m = logits.amax(dim=-1, keepdim=True)
    probs = torch.exp(logits - m)
    denom = probs.sum(dim=-1, keepdim=True)
    out = torch.einsum("bkgt,bktd->bkgd", probs.to(v_cache.dtype).float(), v_cache.float())
    return (out / denom).reshape(B, Hq, D).to(q.dtype)


REG.register(KernelImpl(op="decode_attention", device_kind="any", source="reference",
                        fn=ref.decode_attention))
REG.register(KernelImpl(op="decode_attention", device_kind="any", source="torch",
                        fn=torch_decode_attention))
REG.register(KernelImpl(op="decode_attention", device_kind="cuda", source="cuda",
                        fn=dec_k.decode_attention))


def attended_keys(length, batch: int, T: int) -> int:
    """Keys a decode step reads over the batch: each sequence's length
    (clipped to the cache's T) where the lengths are data, all T on meta
    tensors (the dry run's, whose lengths no one knows)."""
    if isinstance(length, torch.Tensor):
        if length.device.type == "meta":
            return batch * T
        return int(torch.clamp(length.expand(batch) if length.dim() == 0 else length,
                               max=T).sum())
    return batch * min(int(length), T)


def decode_attention_cost(out, q, k_cache, v_cache, length, **_):
    """4·D FLOPs a query head a key read; q, the output, and the k and v
    rows each sequence attends over."""
    B, Hq, D = q.shape
    Hkv, T = k_cache.shape[1], k_cache.shape[2]
    n = attended_keys(length, B, T)
    return (4 * Hq * D * n, nbytes(q) + nbytes(out)
            + n * Hkv * (k_cache.shape[3] + v_cache.shape[3]) * k_cache.element_size())


register_cost("decode_attention", decode_attention_cost)

# --------------------------------------------------------------------------
# paged decode attention (block-table KV gather)
# --------------------------------------------------------------------------


def torch_paged_decode_attention(q, k_pages, v_pages, block_table, length, *, scale=None):
    """Gather-then-dense, as ``xla_paged_decode_attention``: the pages are
    reassembled into the dense [B, Hkv, T, hd] layout, then
    :func:`torch_decode_attention` runs unchanged — so the result is bitwise
    equal to it over an equivalent dense cache, the property the paged
    engine's equality with the dense engine rests on."""
    kg = ref.gather_kv_pages(k_pages, block_table)
    vg = ref.gather_kv_pages(v_pages, block_table)
    return torch_decode_attention(q, kg, vg, length, scale=scale)


REG.register(KernelImpl(op="paged_decode_attention", device_kind="any", source="reference",
                        fn=ref.paged_decode_attention))
REG.register(KernelImpl(op="paged_decode_attention", device_kind="any", source="torch",
                        fn=torch_paged_decode_attention))
REG.register(KernelImpl(op="paged_decode_attention", device_kind="cuda", source="cuda",
                        fn=paged_k.paged_decode_attention))


def paged_decode_attention_cost(out, q, k_pages, v_pages, block_table, length, **_):
    """The dense kernel's work over the rows the table maps, and the table
    and the lengths (int32)."""
    B, Hq, D = q.shape
    Hkv, ps = k_pages.shape[1], k_pages.shape[2]
    n = attended_keys(length, B, block_table.shape[1] * ps)
    return (4 * Hq * D * n, nbytes(q) + nbytes(out) + nbytes(block_table) + 4 * B
            + n * Hkv * (k_pages.shape[3] + v_pages.shape[3]) * k_pages.element_size())


register_cost("paged_decode_attention", paged_decode_attention_cost)

# --------------------------------------------------------------------------
# ssd (Mamba-2 state-space duality)
# --------------------------------------------------------------------------


def torch_ssd(x, a_log, b, c, dt, *, chunk: int = 256, initial_state=None,
              return_state: bool = False):
    """Chunked SSD in eager torch, as ``xla_ssd``: the chunk halves until it
    divides S (a 600-row prompt at chunk 256 runs 75 chunks of 8), then the
    chunked algebra in f32 with the state carried across chunks, y cast to
    x's dtype."""
    S = x.shape[1]
    q = min(chunk, S)
    while S % q:
        q //= 2
    return ssd_k.plain_ssd(x, a_log, b, c, dt, chunk=q, initial_state=initial_state,
                           return_state=return_state)


def ssd_step(h, x_t, a_log, b_t, c_t, dt_t):
    """Single-token SSD update (the decode path, eager as in the JAX
    package): h' = exp(dt·a)·h + dt·x ⊗ b; y = h'·c.  h [B,H,P,N] f32,
    x_t [B,H,P], b_t, c_t [B,G,N], dt_t [B,H]; returns (h', y in x_t's dtype)."""
    H, G = x_t.shape[1], b_t.shape[1]
    rep = H // G
    bf = b_t.float().repeat_interleave(rep, dim=1)
    cf = c_t.float().repeat_interleave(rep, dim=1)
    dtf = dt_t.float()
    decay = torch.exp(dtf * a_log.float()[None, :])                   # [B,H]
    h = h * decay[..., None, None] + (dtf[..., None] * x_t.float())[..., None] * bf[:, :, None, :]
    y = torch.einsum("bhpn,bhn->bhp", h, cf).to(x_t.dtype)
    return h, y


REG.register(KernelImpl(op="ssd", device_kind="any", source="reference", fn=ref.ssd))
REG.register(KernelImpl(op="ssd", device_kind="any", source="torch", fn=torch_ssd))
REG.register(KernelImpl(op="ssd", device_kind="cuda", source="cuda", fn=ssd_k.ssd))


def ssd_cost(out, x, a_log, b, c, dt, **_):
    """x, b, c, dt and a_log read once, y and the f32 state [B,H,P,N]
    written once; 2q²N (C·Bᵀ) + 2q²P (its product with dt·x) + 4qNP (C·hᵀ
    and the carry) a head a chunk of q = 16 rows."""
    B, S, H, P = x.shape
    N, q = b.shape[-1], 16
    y = out[0] if isinstance(out, tuple) else out
    flops = B * H * -(-S // q) * (2 * q * q * N + 2 * q * q * P + 4 * q * N * P)
    return flops, (nbytes(x) + nbytes(b) + nbytes(c) + nbytes(dt) + nbytes(a_log) + nbytes(y)
                   + B * H * P * N * 4)


register_cost("ssd", ssd_cost)

# --------------------------------------------------------------------------
# conv2d (paper Table I roles 3 and 4)
# --------------------------------------------------------------------------

REG.register(KernelImpl(op="conv2d", device_kind="any", source="reference", fn=ref.conv2d))
REG.register(KernelImpl(op="conv2d", device_kind="any", source="torch", fn=ref.conv2d))
REG.register(KernelImpl(op="conv2d", device_kind="cuda", source="cuda", fn=conv2d_k.conv2d,
                        footprint=conv2d_k.footprint()))


def conv2d_cost(out, x, w, **_):
    """A multiply and an add a tap, channel and filter of every output
    pixel; x, w and the output."""
    kh, kw, cin, F = w.shape
    return 2 * out.numel() * kh * kw * cin, nbytes(x) + nbytes(w) + nbytes(out)


register_cost("conv2d", conv2d_cost)
