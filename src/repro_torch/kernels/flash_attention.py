"""Flash attention written by hand for Hopper (``csrc/flash_attention.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py``
``flash_attention`` (``_fa_kernel``): online-softmax attention of
q [B, Hq, S, D] over k, v [B, Hkv, T, D], GQA head h reading kv head
h // (Hq // Hkv), causal and sliding-window masks at -1e30 with the queries
aligned to the end of the keys (``kv_offset = T - S``), a non-causal mode and
an l == 0 guard.  Values may be narrower than queries and keys: q, k
[.., Dqk] and v [.., Dv], as MLA's prefill runs them (Dqk 192 = qk_nope 128 +
qk_rope 64, Dv 128; the Pallas kernel gives v q's width, JAX's ``xla``
source takes any).  The kernel takes Dqk a multiple of 16 from 16 to 256
and Dv one from 16 to 128: four instances <Dqk, Dv> = <64,64>, <128,128>,
<192,128> and <256,128>, each taking every pair up to its own (its tensor
maps read zeros in the columns past the true widths, and the softmax scale
is the true Dqk's unless given).  The wrapper takes the rest of what the
Pallas kernel takes: a width that is not a multiple of 16 is zero-padded to
the next one (zero columns add exact zeros to every score, the scale stays
1/sqrt of the true Dqk, and the output's padded columns are sliced off), and
values wider than 128 run as 128-wide column blocks of v, one launch each
(scores and their folds do not read v, so each column is what one launch
would give).  Query and key widths above 256 raise.

What bounds it on the H100: operations at prefill lengths in principle — a
causal 512 x 512 head does about 90 flops per byte it must move — but at
the serve runs' sizes (1.1 GFLOP at S = T = 512, about 1 µs at the bf16
rate) the time goes to each block's serial walk over its key tiles and to
SMs left idle.  The design: a block of one consumer warpgroup and one
producer warp owns 64 query rows of a head; the producer keeps TMA loads of
K and V tiles in flight in a 2-3 stage ring; both products run on ``wgmma``
(S = Q Kᵀ from shared memory, O += P V with P from registers); tiles the
masks hide from every row are never loaded; causal tiles that see the most
keys start first.  A key tile is 128 keys at Dqk = 64 and 64 at 128 and 192
(its registers).  P is rounded to bf16 for the P V product; that rounding
is why the kernel is held to its plain version within a bf16 tolerance.

Key groups (:data:`GROUP_KEYS`): a query row's keys are summed in an order
fixed by the key index alone.  The keys fall into groups of 512; a row's
online softmax runs over each group from fresh, and the groups' states are
folded in key order by one function.  A key tile or a group that a row
cannot see is an exact no-op for it, so a query row's result does not
depend on S, B, the grid or where its q tile starts: a chunk's rows (of any
size, at any start) are bitwise the whole prompt's.

Split-KV (:func:`split_kv`): where the (q tile, head) blocks alone would
leave SMs idle and each walks many key tiles — a 128-row chunk against
1024 keys is 64 blocks for 132 SMs, 16 tiles each — each q tile's key
groups are split over up to four blocks, whole groups a block; each writes
its groups' softmax states to an f32 workspace this wrapper allocates, and
the last block of a tile (an atomic counter: one buffer per CUDA stream,
left zeroed) folds them in key order, in the same launch, as an unsplit
block folds them on its walk.  So a split changes the time, never a bit.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import native

ROUTE = "cuda"
SOURCE = "src/repro_torch/csrc/flash_attention.cu"
REPLACES = "src/repro/kernels/flash_attention.py:101"

#: launches of the CUDA kernel (a split shape is one launch)
launches = 0

NEG_INF = -1e30
#: the head dims the decode kernels take, and flash attention's value widths:
#: multiples of 16 up to 128
HEAD_DIMS = tuple(range(16, 129, 16))
#: query rows a tile of the kernel, and keys a tile of each instance
BLOCK_Q = 64
BLOCK_K = {64: 128, 128: 64, 192: 64, 256: 64}
MAX_SPLITS = 4
#: keys a group: a row's softmax runs group by group, folded in key order
GROUP_KEYS = 512
_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
             + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
#: the query/key widths the kernel takes: multiples of 16 up to 256
QK_DIMS = tuple(range(16, 257, 16))
#: the instances (Dqk, Dv), smallest first
INSTANCES = ((64, 64), (128, 128), (192, 128), (256, 128))
#: the widest value block one launch takes
MAX_DV = 128
#: the head widths a kernel launch takes are multiples of this
WIDTH_STEP = 16


def kernel_instance(head_dim: int, value_dim: int | None = None) -> tuple[int, int]:
    """The instance (Dqk, Dv) that runs q, k ``head_dim`` wide over values
    ``value_dim`` wide (``head_dim`` unless given): the smallest that holds
    both."""
    value_dim = head_dim if value_dim is None else value_dim
    return next(inst for inst in INSTANCES if head_dim <= inst[0] and value_dim <= inst[1])


def instance(head_dim: int) -> int:
    """The query/key width of the instance that runs queries, keys and
    values ``head_dim`` wide (192 and 256: queries and keys that wide over
    values of at most 128)."""
    return kernel_instance(head_dim, min(head_dim, MAX_DV))[0]


def padded_width(D: int) -> int:
    """``D`` rounded up to the next multiple of :data:`WIDTH_STEP`: the width
    a kernel launch runs a head ``D`` wide at."""
    return -(-D // WIDTH_STEP) * WIDTH_STEP


def pad_width(x: torch.Tensor) -> torch.Tensor:
    """``x`` with its last axis zero-padded to :func:`padded_width` (a copy),
    or ``x`` itself where it is already a multiple of :data:`WIDTH_STEP`."""
    D = x.shape[-1]
    if D % WIDTH_STEP == 0:
        return x
    return torch.nn.functional.pad(x, (0, padded_width(D) - D))


def check_head_dim(op: str, D: int) -> None:
    """Raise, naming ``D``, unless the decode kernels take it, padded to a
    multiple of 16 (:data:`HEAD_DIMS`)."""
    if not 0 < D <= HEAD_DIMS[-1]:
        raise ValueError(f"{op}: head_dim {D} is not taken: the CUDA kernel takes head dims "
                         f"up to {HEAD_DIMS[-1]}")


def check_head_dims(op: str, Dqk: int, Dv: int) -> None:
    """Raise, naming the width, unless flash attention takes queries and keys
    ``Dqk`` wide (up to :data:`QK_DIMS`' last, padded to a multiple of 16)
    over values ``Dv`` wide (any: 128-wide blocks)."""
    if not 0 < Dqk <= QK_DIMS[-1]:
        raise ValueError(f"{op}: head_dim {Dqk} is not taken: the CUDA kernel takes query and "
                         f"key widths up to {QK_DIMS[-1]}")
    if Dv <= 0:
        raise ValueError(f"{op}: value width {Dv} is not taken")


def split_kv(B: int, Hq: int, S: int, T: int, causal: bool = True,
             window: int | None = None, head_dim: int = 64,
             value_dim: int | None = None) -> int:
    """Key-range splits a (q tile, head) for one launch: 1 when the tiles
    ``B · Hq · ceil(S / 64)`` fill the card's SMs (132 on the H100); else
    at most one block an SM, :data:`MAX_SPLITS` and the key groups the q
    tile that sees the most keys (the last one) walks, and one split for
    every 384 keys it walks.  A block walks its key tiles one after another
    (about 0.01 µs a key at D = 64) and the merge costs 3-4 µs, so a split
    pays only where it takes some 350 keys off the walk
    (``kernels/flash_sweep.py``: a 128-row chunk splits in two from 768
    keys).  The split never changes a result: only the time.  The key tile
    is that of :func:`kernel_instance` (``head_dim``, ``value_dim``)."""
    tiles, sms = B * Hq * math.ceil(S / BLOCK_Q), native.sm_count()
    if tiles >= sms:
        return 1
    bk = BLOCK_K[kernel_instance(head_dim, value_dim)[0]]
    q_first = (math.ceil(S / BLOCK_Q) - 1) * BLOCK_Q + T - S   # the last q tile's first row
    lo = max(0, q_first - window + 1) // bk if window else 0
    visible = (math.ceil(T / bk) - lo) * bk
    groups = math.ceil(T / GROUP_KEYS) - lo * bk // GROUP_KEYS
    return max(1, min(MAX_SPLITS, sms // tiles, visible // 384, groups))


def key_groups(T: int, head_dim: int = 64,
               value_dim: int | None = None) -> tuple[tuple[int, int], ...]:
    """The key ranges [k0, k1) of ``T`` keys whose softmax states the kernel
    folds, in the order it folds them, for every query row, launch and
    split: a function of T alone (a row that cannot see a range's keys
    folds it as a no-op).  The instance's key tile divides a group, so no
    tile straddles two."""
    if GROUP_KEYS % BLOCK_K[kernel_instance(head_dim, value_dim)[0]]:
        raise AssertionError("a key tile straddles two groups")
    return tuple((k, min(T, k + GROUP_KEYS)) for k in range(0, T, GROUP_KEYS))


def split_groups(S: int, T: int, splits: int, causal: bool = True, window: int | None = None,
                 head_dim: int = 64, value_dim: int | None = None) -> list[list[list[int]]]:
    """The key groups each split block of each q tile walks, as the kernel
    deals them: q tile qt's groups [g_lo, g_hi) (those holding a key some
    row of the tile sees) in runs of ceil((g_hi - g_lo) / splits), whole
    groups a block; ``[q tile][split] -> group indices``."""
    bk = BLOCK_K[kernel_instance(head_dim, value_dim)[0]]
    tpg, kt = GROUP_KEYS // bk, math.ceil(T / bk)
    out = []
    for qt in range(math.ceil(S / BLOCK_Q)):
        q_first = qt * BLOCK_Q + T - S
        q_last = min(qt * BLOCK_Q + BLOCK_Q, S) - 1 + T - S
        hi = min(kt, q_last // bk + 1) if causal else kt
        lo = max(0, q_first - window + 1) // bk if window else 0
        g_lo, g_hi = lo // tpg, math.ceil(hi / tpg)
        per = math.ceil((g_hi - g_lo) / splits)
        out.append([list(range(min(g_hi, g_lo + sp * per), min(g_hi, g_lo + (sp + 1) * per)))
                    for sp in range(splits)])
    return out


def plain_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          causal: bool = True, window: int | None = None,
                          scale: float | None = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch: f32 logits, masks at -1e30,
    f32 softmax and product, l == 0 guarded; values may be narrower than
    queries and keys (the output takes v's width)."""
    B, Hq, S, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    group = Hq // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    kg = k.float().repeat_interleave(group, dim=1)
    vg = v.float().repeat_interleave(group, dim=1)
    s = torch.einsum("bhsd,bhtd->bhst", q.float(), kg) * scale
    qpos = torch.arange(S, device=q.device)[:, None] + (T - S)
    kpos = torch.arange(T, device=q.device)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    s = torch.where(mask, s, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    l = torch.where(l == 0.0, 1.0, l)
    return (torch.einsum("bhst,bhtd->bhsd", p, vg) / l).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
                    window: int | None = None, scale: float | None = None,
                    splits: int | None = None) -> torch.Tensor:
    """Attention of q [B,Hq,S,Dqk] over k [B,Hkv,T,Dqk] and v [B,Hkv,T,Dv]:
    the plain version for CPU tensors, else the CUDA kernel (bf16, Dqk up to
    256, any Dv, S <= T; widths off a multiple of 16 zero-padded, values
    wider than 128 in 128-wide blocks, a launch each) with ``splits``
    key-range splits, :func:`split_kv`'s choice unless given
    (``kernels/flash_sweep.py`` times the others)."""
    if native.on_cpu(q, k, v):
        return plain_flash_attention(q, k, v, causal=causal, window=window, scale=scale)
    native.check("flash_attention", {"q": q, "k": k, "v": v}, torch.bfloat16)
    B, Hq, S, D = q.shape
    if (k.dim() != 4 or v.dim() != 4 or k.shape[0] != B or k.shape[3] != D
            or v.shape[:3] != k.shape[:3]):
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not match")
    Hkv, T, Dv = k.shape[1], k.shape[2], v.shape[3]
    check_head_dims("flash_attention", D, Dv)
    if Hq % Hkv or not 0 < S <= T:
        raise ValueError(f"flash_attention: needs Hq % Hkv == 0 and 0 < S <= T; got "
                         f"Hq={Hq} Hkv={Hkv} S={S} T={T}")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window must be >= 1, got {window}")
    if splits is not None and not 1 <= splits <= MAX_SPLITS:
        raise ValueError(f"flash_attention: splits must be 1 .. {MAX_SPLITS}, got {splits}")
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    if splits is None:
        splits = split_kv(B, Hq, S, T, causal, window, padded_width(D),
                          min(padded_width(Dv), MAX_DV))
    return by_width(lambda q, k, v: _launch(q, k, v, splits, causal, window, scale), q, k, v)


def by_width(launch, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``launch(q, k, v)`` on widths a launch takes: q, k and v zero-padded to
    multiples of 16 (:func:`pad_width`), v in :data:`MAX_DV`-wide column
    blocks, a launch each, their outputs joined and sliced to v's width.
    ``launch`` must keep the softmax scale of the true query width."""
    Dv = v.shape[-1]
    q, k, v = pad_width(q), pad_width(k), pad_width(v)
    Dp = v.shape[-1]
    if Dp <= MAX_DV:
        out = launch(q, k, v)
    else:
        out = torch.cat([launch(q, k, v[..., c:c + MAX_DV].contiguous())
                         for c in range(0, Dp, MAX_DV)], dim=-1)
    return out if Dp == Dv else out[..., :Dv].contiguous()


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, splits: int, causal: bool,
            window: int | None, scale: float) -> torch.Tensor:
    """One launch of the kernel on checked inputs of widths it takes; the
    output."""
    B, Hq, S, D = q.shape
    Hkv, T, Dv = k.shape[1], k.shape[2], v.shape[3]
    out = q.new_empty((B, Hq, S, Dv))
    ws = counters = None
    stream = torch.cuda.current_stream(q.device).cuda_stream
    q_tiles, groups = math.ceil(S / BLOCK_Q), math.ceil(T / GROUP_KEYS)
    if splits > 1 or groups > 1:
        # every key group's softmax state but an unsplit block's last
        ws = torch.empty(groups * B * Hq * q_tiles * BLOCK_Q * (kernel_instance(D, Dv)[1] + 2),
                         dtype=torch.float32, device=q.device)
    if splits > 1:
        counters = native.tile_counters("flash_attention", q.device, stream, B * Hq * q_tiles)
    fn = native.function("flash_attention", "repro_flash_attention", _ARGTYPES)
    err = fn(native.ptr(q), native.ptr(k), native.ptr(v), native.ptr(out), native.ptr(ws),
             native.ptr(counters), B, Hq, Hkv, S, T, D, Dv, float(scale), int(causal),
             int(window or 0), splits, ctypes.c_void_p(stream))
    native.raise_on_error("flash_attention", err)
    native.count_launch(__name__)
    return out
