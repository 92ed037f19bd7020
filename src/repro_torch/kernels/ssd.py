"""Mamba-2 SSD chunked scan written by hand for Hopper (``csrc/ssd.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/ssd.py`` ``ssd``
(``_ssd_kernel``): for each sequence b and head h, over chunks of rows,

  cum[i]   = Σ_{k≤i} dt_k·a                     (running log-decay in the chunk)
  y_intra  = (C·Bᵀ ⊙ exp(min(cum_i − cum_j, 0)) ⊙ [i≥j]) · (dt ⊙ x)
  y_inter  = exp(cum) ⊙ (C · h_prevᵀ)
  h        = exp(cum_last)·h_prev + ((dt ⊙ x) ⊙ exp(cum_last − cum))ᵀ · B

all in f32, with a bf16 y [B,S,H,P] and the final f32 state [B,H,P,N].  The
exponent clamp keeps the upper triangle from overflowing ``exp`` (0·inf is
NaN).  Heads share B/C by group (``h // (H/G)``).

What bounds it on the H100: at the serving shapes (H 48, P 64, N 128, G 1)
the inputs are a few MB, read once, and the products some 2.4 GFLOP at
S = 600, a few µs on the tensor cores; what is left is the carry from
chunk to chunk, the one sequential part.  The design (one launch):

- chunk-parallel: a block for each (chunk of :data:`CHUNK` rows, sequence,
  head, slice of up to 64 head-dim columns), 480 blocks for a 600-row
  prompt.  A block first computes what needs no earlier chunk (its chunk's
  own state contribution, C·Bᵀ and the intra-chunk output), then waits for
  the previous chunk's state, publishes its own for the next, and adds the
  inter-chunk output;
- the carry is a chained scan: the state passes through a slot in device
  memory beside a flag (release / acquire), and blocks take their chunk from
  an atomic ticket counter in chunk order, so no block waits on one that is
  not running.  The counter and flags are left zeroed: calls repeat bitwise
  and can be captured in a CUDA graph;
- every product on the tensor cores (``mma.sync``), each f32 operand split
  in two bf16 parts against the bf16-exact B, C and x (about 16 bits of
  mantissa; one bf16 pass would round the state by about 1e-3);
- any S: rows past S in the last chunk are dt = 0 rows, which neither decay
  the state nor add to it; the kernel never reads or writes past S (the
  Pallas kernel raises when its chunk does not divide S).

x, b and c may be views with any batch and row strides (the model passes
slices of one conv output): only the (H, P) and (G, N) dims must be packed.
``chunk=`` is accepted for the Pallas kernel's signature and not used.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import native

ROUTE = "cuda"
SOURCE = "src/repro_torch/csrc/ssd.cu"
REPLACES = "src/repro/kernels/ssd.py:82"

#: launches of the CUDA kernel
launches = 0

#: rows of the kernel's chunk
CHUNK = 64
#: head-dim columns of a block, at most: a head of more takes several blocks
P_SLICE = 64
MAX_STATE = 128

_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 6
             + [ctypes.c_void_p])


def plain_ssd(x: torch.Tensor, a_log: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
              dt: torch.Tensor, *, chunk: int = CHUNK,
              initial_state: torch.Tensor | None = None, return_state: bool = False):
    """The kernel's function in plain PyTorch: the chunked algebra in f32
    over ``chunk``-row chunks, vectorised over sequences, chunks and heads,
    with a Python loop carrying the state across chunks.  Rows past S in
    the last chunk are dt = 0 rows, as in the kernel."""
    B, S, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    if H % G:
        raise ValueError(f"H={H} is not a multiple of G={G}")
    rep = H // G
    n = -(-S // chunk)
    pad = n * chunk - S
    xf = F.pad(x.float(), (0, 0, 0, 0, 0, pad)).reshape(B, n, chunk, H, P)
    bf = F.pad(b.float(), (0, 0, 0, 0, 0, pad)).repeat_interleave(rep, dim=2)
    cf = F.pad(c.float(), (0, 0, 0, 0, 0, pad)).repeat_interleave(rep, dim=2)
    bf, cf = bf.reshape(B, n, chunk, H, N), cf.reshape(B, n, chunk, H, N)
    dtf = F.pad(dt.float(), (0, 0, 0, pad)).reshape(B, n, chunk, H)

    cum = torch.cumsum(dtf * a_log.float(), dim=2)                      # [B,n,q,H]
    dtx = xf * dtf[..., None]                                           # [B,n,q,H,P]
    # intra-chunk masked product; the exponent is clamped to <= 0 (valid
    # i >= j pairs always are; the upper triangle would overflow exp)
    g = torch.einsum("bnqhm,bnkhm->bnhqk", cf, bf)                      # [B,n,H,q,q]
    delta = torch.clamp(cum[:, :, :, None] - cum[:, :, None, :], max=0.0)
    decay = torch.exp(delta).permute(0, 1, 4, 2, 3)                     # [B,n,H,q,q]
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device))
    m = torch.where(tri, g * decay, 0.0)
    y_intra = torch.einsum("bnhqk,bnkhp->bnqhp", m, dtx)

    # per-chunk state contribution, carried across chunks
    w_end = torch.exp(cum[:, :, -1:, :] - cum)                          # [B,n,q,H]
    s_chunk = torch.einsum("bnqhp,bnqhs->bnhps", dtx * w_end[..., None], bf)
    chunk_decay = torch.exp(cum[:, :, -1])                              # [B,n,H]
    h = (torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device)
         if initial_state is None else initial_state.float())
    h_prevs = []
    for i in range(n):
        h_prevs.append(h)
        h = h * chunk_decay[:, i, :, None, None] + s_chunk[:, i]
    h_prev = torch.stack(h_prevs, dim=1)                                # [B,n,H,P,N]
    y_inter = torch.exp(cum)[..., None] * torch.einsum("bnqhs,bnhps->bnqhp", cf, h_prev)
    y = (y_intra + y_inter).reshape(B, n * chunk, H, P)[:, :S].to(x.dtype)
    return (y, h) if return_state else y


def _check_rows(name: str, t: torch.Tensor, inner: int) -> None:
    """A [B, S, X, inner] view whose last two dims are packed, with batch and
    row strides the kernel's 16-byte loads can follow."""
    if t.dim() != 4 or t.stride(3) != 1 or t.stride(2) != inner:
        raise ValueError(f"ssd: {name} must be [B, S, {t.shape[2]}, {inner}] with its last two "
                         f"dims packed, got shape {tuple(t.shape)} strides {t.stride()}")
    if t.data_ptr() % 16 or t.stride(0) % 8 or t.stride(1) % 8:
        raise ValueError(f"ssd: {name} must be 16-byte aligned with batch and row strides a "
                         f"multiple of 8 elements, got strides {t.stride()}")


def ssd(x: torch.Tensor, a_log: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
        dt: torch.Tensor, *, chunk: int = 256, return_state: bool = False):
    """The SSD scan: the plain version for CPU tensors, else the CUDA kernel,
    one launch (x, b, c bf16; a_log, dt f32; P a multiple of 16; N a
    multiple of 16 up to 128).  ``chunk`` is the Pallas kernel's and is not
    used."""
    del chunk
    if native.on_cpu(x, a_log, b, c, dt):
        return plain_ssd(x, a_log, b, c, dt, return_state=return_state)
    B, S, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    if (b.shape != c.shape or b.shape[:2] != (B, S) or dt.shape != (B, S, H)
            or a_log.shape != (H,) or H % G):
        raise ValueError(f"ssd: x {tuple(x.shape)}, a_log {tuple(a_log.shape)}, b "
                         f"{tuple(b.shape)}, c {tuple(c.shape)}, dt {tuple(dt.shape)} do not match")
    if P % 16 or N % 16 or N > MAX_STATE or S < 1:
        raise ValueError(f"ssd: needs P a multiple of 16, N a multiple of 16 up to "
                         f"{MAX_STATE} and S >= 1; got P={P} N={N} S={S}")
    native.check("ssd", {"a_log": a_log, "dt": dt}, torch.float32)
    if len({t.device for t in (x, a_log, b, c, dt)}) != 1:
        raise ValueError(f"ssd: the CUDA kernel needs all tensors on one CUDA device, got "
                         f"{sorted(str(t.device) for t in (x, a_log, b, c, dt))}")
    for name, t, inner in (("x", x, P), ("b", b, N), ("c", c, N)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"ssd: {name} must be torch.bfloat16, got {t.dtype}")
        _check_rows(name, t, inner)
    y = torch.empty((B, S, H, P), dtype=torch.bfloat16, device=x.device)
    state = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
    # the carry's slot (h of the chunk last published) and the ticket counter
    # with one flag a (sequence, head, slice)
    slot = torch.empty_like(state)
    handle = torch.cuda.current_stream(x.device).cuda_stream
    counters = native.tile_counters("ssd", x.device, handle, 1 + B * H * -(-P // P_SLICE))
    fn = native.function("ssd", "repro_ssd", _ARGTYPES)
    err = fn(native.ptr(x), native.ptr(a_log), native.ptr(b), native.ptr(c), native.ptr(dt),
             native.ptr(y), native.ptr(state), native.ptr(slot), native.ptr(counters),
             B, S, H, P, G, N,
             x.stride(0), x.stride(1), b.stride(0), b.stride(1), c.stride(0), c.stride(1),
             ctypes.c_void_p(handle))
    native.raise_on_error("ssd", err)
    native.count_launch(__name__)
    return (y, state) if return_state else y
