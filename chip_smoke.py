#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--out results.json]

Serves ``llama3.2-1b`` and ``mamba2-780m`` at full width and depth, and
runs ``granite-3-8b`` (head_dim 128, an untied unembed over 49155 tokens) at
full width and GRANITE_DEPTH layers, with weights drawn from ``--seed`` on
the card, through the port's own entry points under the ``cuda-strict``
policy, so every op on the path runs a hand-written kernel, and runs the
paper's two tenants on the card through the port's HSA runtime.  Phases, in
order; any failure raises and the script exits non-zero:

1. device: the card's name and power limit; build the kernels from
   ``src/repro_torch/csrc`` (six sources, nine kernels) and print what
   ptxas reports for each, and the wgmma (HGMMA) and TMA (UTMALDG)
   instructions in each bf16 matmul kernel and each flash attention
   instance (``cuobjdump``; none fails).
2. kernels: each kernel against its plain PyTorch version at the shapes the
   serving paths and the paper's roles give it, the attention kernels at
   head_dim 64 and 128 (flash also split over 2-4 blocks a tile, under a
   window, ragged), within the tolerance stated below (attention row by
   row, ssd per row and per head's state, conv2d and the f32 matmul
   exactly or within 2e-4, the bf16 matmul within 2e-2, each beside what a
   planted fault reads by the same measure; rmsnorm in bf16 and f32; the
   matmul edge kernel at the untied unembeds' shapes, N not a multiple of
   8); timed with CUDA events beside its plain version and one PyTorch
   library call where there is one (for paged attention, which no one call
   computes, a gather and SDPA; for ssd and int16 conv2d none), and its
   bound (the larger of bytes / 3.35 TB/s and operations / peak rate).  The
   paged kernel must also equal the dense kernel on the gathered cache bit
   for bit, and the fixed-weight roles (``matmul_fixed_weight``,
   ``conv2d_fixed_weight``) their generic kernels.
3. model, llama3.2-1b: logits under ``cuda-strict`` against the ``torch``
   eager source on the same weights and prompts, for the calls the engine
   makes: bucketed prefill, the first-token fixup, a batched decode; and
   chunked prefill (128-row chunks) against whole-prompt prefill, through
   a staging cache and, bit for bit the same, through a page pool.
4. serve, llama3.2-1b: the same 16 greedy requests (prompts of 5 to 600
   tokens, 32 new tokens each, ``max_len`` 1024) through three engines:
   dense with 8 slots; paged (16-row pages) with 8 slots and the dense
   engine's memory, whose streams must equal the dense ones; paged with
   chunked prefill (128-row chunks) and 16 slots in that same KV memory
   (checked: the pool is all it holds), which must run more than 8
   requests at once.  Every kernel's launch count is read from each run
   alone (counts set to 0 just before it) and checked against the model
   calls the engine made.  Then the card's busy share over four dense
   decode steps, and over one step that prefills a 600-token prompt (the
   1024 bucket) with the bf16 matmul kernels' part, from torch.profiler
   traces.
5. tenants: ``hsa_init(num_regions=2)`` on the card and its async
   scheduler's worker thread; the "tf-serving" queue carries the 16
   requests through a dense 8-slot engine (streams must equal phase 4's
   dense run), the "opencl" queue the paper's four roles at §IV's shapes
   (fixed-weight int16 conv frames, the FC roles, one behind a barrier-AND,
   and the role the planner picks from FC costs measured on the card).
   Prints Table II from the ledger, the reconfiguration split, per-queue
   wait, exec and reconfiguration, residency, and TTFT and decode tokens/s
   routed beside direct; checks every role packet against its plain
   version and the launch counts against the packets.
6. model, granite-3-8b at full width and GRANITE_DEPTH layers: 8 prompts'
   bucketed prefills (8 .. 512), their first-token fixups, a batched
   decode over the dense cache and over a page pool (bitwise equal), and a
   512-token prompt in 128-row chunks through staging and a pool (bitwise
   equal), under ``cuda-strict`` against the ``torch`` source; launches
   counted from 0 and checked against the calls (flash, decode and paged
   attention at D = 128 and the edge matmul each run).
7. model, mamba2-780m: prefill logits and SSD state under ``cuda-strict``
   against the ``torch`` source for prompts of 5, 37 and 600 tokens (at
   their own length: an SSM prompt is not bucketed), then three decode
   steps of the three as a batch.
8. serve, mamba2-780m (the ``ssm`` run): the 16 prompt lengths, 8 slots,
   32 new tokens each, launches checked as in 4 (48 ssd a prefill, none a
   decode step, no fixups); then its busy share over four decode steps.

The last lines are the ``{"kernels": [...]}`` summary, the card's
``nvidia-smi`` name and power limit, and ``{"ok": true, "device": ...}``.
Needs one CUDA card; exits non-zero without one.  Imports no JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_S = 3.35e12          # H100 SXM device memory
BF16_TC_FLOPS = 989e12         # H100 SXM dense bf16 tensor cores
F32_FLOPS = 67e12              # H100 SXM f32 outside the tensor cores
# int32 multiply-adds on the CUDA cores: an SM has 64 INT32 lanes against 128
# FP32 lanes (NVIDIA's Hopper architecture white paper), so half the f32 rate
INT32_OPS = F32_FLOPS / 2
L2_BYTES = 50 * 2**20
SPIN_CYCLES = 100_000_000      # ~50 ms at the H100's 1.98 GHz boost clock
# matmul and rmsnorm vs their plain versions: bf16 outputs within about two
# bf16 rounding steps of the O(1) values used (the kernels sum in another
# order); f32 matmul outputs within f32 reordering of exact bf16 products.
TOL_BF16 = (2e-2, 2e-2)
TOL_F32 = (1e-3, 1e-3)
# the paper roles' f32 kernels (conv2d, the f32 matmul) vs their plain
# versions: both sum full-f32 products, in other orders; 2e-4 is the JAX
# package's own tolerance for its f32 matmul at K = 256.  int16 conv2d is exact.
TOL_ROLE_F32 = (2e-4, 2e-4)
# attention vs its plain version, per output row (one query head of one
# token): ||got - want|| / ||want|| over the head dim.  An absolute limit
# would be loose here: a row over n random keys has |o| of about n^-1/2, so
# 2e-2 is a fifth of a 1024-key row.  The kernels' own rounding (P to bf16
# for P V, the bf16 output) gives a few 1e-3; a kernel that drops one key
# tile moves a row by about sqrt(tile / n), 0.18 for a 32-key tile of 1024.
# Each check also reads such a planted fault and fails unless it lies beyond
# the limit in every row it touches.
ATTN_REL_L2_TOL = 1e-2
# ssd vs its plain version: y per (sequence, row, head), ||got - want|| /
# ||want|| over the head dim, and the final state per (sequence, head) over
# its [P, N].  Both run the same f32 algebra over 16-row chunks and sum in
# other orders (a few 1e-7 relative), and y is rounded to bf16 (one ulp,
# 2^-8, flipped in a few of a row's 64 values reads about 5e-4).  The
# planted fault is the plain version with the carried state zeroed at the
# last chunk boundary before S; each check fails unless the fault reads
# beyond both limits (in the rows after the boundary, and in the state).
SSD_Y_REL_L2_TOL = 1e-2
SSD_STATE_REL_L2_TOL = 1e-3
# full model, cuda-strict vs the torch eager source: the sources round
# differently (the eager source runs silu on bf16, the kernel on f32) and the
# difference compounds over the layers; a wrong kernel gives errors of O(1).
# Mamba-2's SSD state is the sum its logits are read from: held per layer to
# the same relative limit.  Over all 48 layers of random weights any two
# sources part by rounding alone (see ssm_model_phase), so Mamba-2's path is
# gated end to end at its first 8 layers, and each of the 48 layers' Mamba-2
# block (norm, projections, ssd) on the same input within 1e-2 of output
# and state: a few bf16 roundings (a wrong kernel reads O(1)).
MODEL_REL_L2_TOL = 0.1
SSM_STATE_REL_L2_TOL = 0.1
SSM_LAYER_REL_L2_TOL = 1e-2
SSM_GATED_DEPTH = 8
# the untied unembeds at a decode step of 8 slots, [M, K] x [K, N] with N not
# a multiple of 8: granite-3-8b, hymba-1.5b, whisper large-v3
UNEMBEDS = ((8, 4096, 49155), (8, 1600, 32001), (8, 1280, 51866))
# granite-3-8b at full width, cut to this many layers (about 1.6 GB of bf16
# weights from --seed): every head_dim 128 kernel and the edge matmul of its
# untied [4096, 49155] unembed on the path a server runs
GRANITE_DEPTH = 2
# the granite phase's 8 prompt lengths (buckets 8 .. 512); the kernel phase
# holds decode and paged attention against their plain versions at them too
GRANITE_LENGTHS = (5, 45, 130, 260, 300, 400, 470, 500)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, arg_sets, iters: int = 30, warmup: int = 3) -> tuple[float, float]:
    """(device ms, host ms) of one call: CUDA events around ``iters`` calls
    after a warm-up, cycling through ``arg_sets`` so the inputs come from
    device memory rather than L2.  A spin kernel keeps the card busy while
    the host queues the calls, so the events hold device time only; the
    host's own time per call is returned beside it (when it exceeds the
    spin, the device time includes host gaps and reads high)."""
    for i in range(warmup):
        fn(*arg_sets[i % len(arg_sets)])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    t0 = time.perf_counter()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    host = (time.perf_counter() - t0) * 1e3 / iters
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters, host


def n_sets(bytes_per_set: int) -> int:
    return max(1, min(64, math.ceil(2 * L2_BYTES / bytes_per_set)))


def bound(bytes_: float, flops: float, peak: float) -> tuple[float, str]:
    t_bytes, t_ops = bytes_ / HBM_BYTES_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def max_err(torch, got, want, tol) -> dict:
    """Largest |got - want|; raises if any element is outside atol + rtol·|want|."""
    atol, rtol = tol
    g, w = got.float(), want.float()
    if not torch.isfinite(g).all():
        raise AssertionError("kernel output has non-finite values")
    diff = (g - w).abs()
    if bool((diff > atol + rtol * w.abs()).any()):
        raise AssertionError(f"kernel disagrees with its plain version: max |diff| "
                             f"{float(diff.max())} beyond atol={atol}, rtol={rtol}")
    return {"max_abs_err": float(diff.max()), "tolerance": f"atol={atol} rtol={rtol}"}


def drop_last_k_tile(x, bk: int = 64):
    """x with its last ``bk``-deep K slice zeroed: fed to the bf16 matmul,
    its output is the kernel's with its last K tile dropped."""
    xf = x.clone()
    xf[..., (x.shape[-1] - 1) // bk * bk:] = 0
    return xf


def matmul_err(torch, got, want, fault, tol) -> dict:
    """``max_err`` of a bf16 matmul, beside its planted fault (the output
    with the last K tile dropped), which must lie beyond the limit in some
    element: 64 of K = 2048 terms move an O(1) output by about 0.18."""
    check = max_err(torch, got, want, tol)
    atol, rtol = tol
    diff = (fault.float() - want.float()).abs()
    if not bool((diff > atol + rtol * want.float().abs()).any()):
        raise AssertionError(f"a dropped last K tile reads {float(diff.max())}, within the "
                             "limit: the check cannot see it")
    check["planted_fault_min_max_abs_err"] = float(diff.max())
    return check


def row_rel_l2(torch, got, want):
    """Per row of the last axis, ||got - want|| / ||want||."""
    g, w = got.float(), want.float()
    return (g - w).norm(dim=-1) / w.norm(dim=-1).clamp_min(1e-12)


def masked_attention(torch, q, k, v, mask):
    """Attention of q [B,Hq,S,D] over k, v [B,Hkv,T,D] where ``mask``
    (broadcast to [B,1,S,T]) is true, in f32, cast to bf16; a row that sees
    no key is 0.  The plain versions' function with any mask, so a planted
    fault can drop keys the kernel would keep."""
    group = q.shape[1] // k.shape[1]
    kg = k.float().repeat_interleave(group, 1)
    vg = v.float().repeat_interleave(group, 1)
    s = torch.einsum("bhsd,bhtd->bhst", q.float(), kg) / math.sqrt(q.shape[-1])
    s = torch.where(mask, s, -1e30)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True)) * mask
    l = p.sum(dim=-1, keepdim=True)
    return (torch.einsum("bhst,bhtd->bhsd", p, vg) / torch.where(l == 0, 1.0, l)).to(q.dtype)


def flash_masks(torch, S: int, T: int, causal: bool, device, window: int | None = None):
    """The keys [S, T] each query row sees (queries at the end of the keys),
    and the planted fault's among them: keys 64..127, the kernel's second
    64-key tile."""
    kpos = torch.arange(T, device=device)[None, :]
    qpos = torch.arange(S, device=device)[:, None] + (T - S)
    sound = (kpos <= qpos) if causal else torch.ones((S, T), dtype=torch.bool, device=device)
    if window is not None:
        sound = sound & (kpos > qpos - window)
    return sound, sound & (kpos >= 64) & (kpos < 128)


def decode_masks(torch, lengths, T: int):
    """The valid keys [B, T] of each sequence, and the planted fault's among
    them: the sequence's last full 32-key tile, where it has more keys."""
    kpos = torch.arange(T, device=lengths.device)[None, :]
    valid = kpos < lengths[:, None]
    start = (lengths // 32 - 1)[:, None] * 32
    return valid, valid & (lengths[:, None] > 32) & (kpos >= start) & (kpos < start + 32)


def remap_one_page(table, lengths, ps: int):
    """A planted fault for paged attention: in each sequence with a whole
    page inside its length, the last such page remapped to another
    sequence's first page (to the scratch page 0 if there is one sequence).
    The faulted table [B, NP] and the sequences it touches [B]."""
    faulted, touched = table.clone(), lengths >= ps
    B = table.shape[0]
    for b in range(B):
        if touched[b]:
            faulted[b, int(lengths[b]) // ps - 1] = table[(b + 1) % B, 0] if B > 1 else 0
    return faulted, touched


def attention_err(torch, got, want, fault, touched) -> dict:
    """Hold an attention kernel's output to its plain version, row by row,
    within ATTN_REL_L2_TOL; ``fault`` is the output of the same function with
    one key tile dropped, read by the same measure in the rows ``touched``
    (those that lost the whole tile, broadcast to the rows' shape) to show
    the limit would catch it in every one of them (raises otherwise).  A
    shape where the fault touches no row reads None."""
    if not torch.isfinite(got.float()).all():
        raise AssertionError("kernel output has non-finite values")
    rel = row_rel_l2(torch, got, want)
    if float(rel.max()) > ATTN_REL_L2_TOL:
        raise AssertionError(f"kernel disagrees with its plain version: row rel L2 "
                             f"{float(rel.max())} beyond {ATTN_REL_L2_TOL}")
    touched = touched.expand(rel.shape)
    planted = float(row_rel_l2(torch, fault, want)[touched].min()) if touched.any() else None
    if planted is not None and planted <= ATTN_REL_L2_TOL:
        raise AssertionError(f"a dropped key tile reads {planted} in some row, within the "
                             f"limit {ATTN_REL_L2_TOL}: the check cannot see it")
    return {"max_abs_err": float((got.float() - want.float()).abs().max()),
            "max_rel_l2": float(rel.max()), "planted_fault_min_rel_l2": planted,
            "tolerance": f"row rel L2 <= {ATTN_REL_L2_TOL}"}


def ssd_inputs(torch, S: int, gen, device, B: int = 1, H: int = 48, P: int = 64, G: int = 1,
               N: int = 128):
    """SSD inputs (x, a_log, b, c, dt) in the serving path's layout: x, b and
    c are views of one [B, S, H*P + 2*G*N] bf16 tensor, as the Mamba-2 block
    slices its conv output.  a = -uniform(1, 16), the model's init; dt
    log-uniform in [1e-3, 1e-1], Mamba-2's dt range, so that some heads carry
    their state across many chunks and a fault in the carry shows."""
    conv = torch.randn((B, S, H * P + 2 * G * N), generator=gen, device=device)
    conv = conv.to(torch.bfloat16)
    x = conv[..., :H * P].reshape(B, S, H, P)
    b = conv[..., H * P:H * P + G * N].reshape(B, S, G, N)
    c = conv[..., H * P + G * N:].reshape(B, S, G, N)
    a = -(1.0 + 15.0 * torch.rand(H, generator=gen, device=device))
    u = torch.rand((B, S, H), generator=gen, device=device)
    dt = torch.exp(math.log(1e-3) + u * (math.log(1e-1) - math.log(1e-3)))
    return x, a, b, c, dt


def ssd_fault(torch, plain, x, a, b, c, dt, chunk: int):
    """A planted fault for ssd: the plain version with the carried state
    zeroed at s0, the last ``chunk`` boundary before S, as (y, final state,
    s0); None where S fits in one chunk."""
    s0 = (x.shape[1] - 1) // chunk * chunk
    if s0 == 0:
        return None
    y0 = plain(x[:, :s0], a, b[:, :s0], c[:, :s0], dt[:, :s0])
    y1, h1 = plain(x[:, s0:], a, b[:, s0:], c[:, s0:], dt[:, s0:], return_state=True)
    return torch.cat([y0, y1], dim=1), h1, s0


def ssd_err(torch, got, want, fault) -> dict:
    """Hold the ssd kernel's (y, state) to its plain version's: every y row
    (one head of one token) within SSD_Y_REL_L2_TOL, every head's final
    state within SSD_STATE_REL_L2_TOL, relatively.  ``fault`` (or None),
    the planted fault's (y, state, s0), must read beyond the y limit in
    every head's row s0, the first row without its carried state, and
    beyond the state limit in some head (a head whose decay forgets a chunk
    within the last one cannot show it); raises otherwise."""
    (gy, gs), (wy, ws) = got, want
    if not (torch.isfinite(gy.float()).all() and torch.isfinite(gs).all()):
        raise AssertionError("kernel output has non-finite values")
    rel_y = row_rel_l2(torch, gy, wy)
    rel_s = row_rel_l2(torch, gs.flatten(2), ws.flatten(2))
    if float(rel_y.max()) > SSD_Y_REL_L2_TOL or float(rel_s.max()) > SSD_STATE_REL_L2_TOL:
        raise AssertionError(f"kernel disagrees with its plain version: y row rel L2 "
                             f"{float(rel_y.max())} (limit {SSD_Y_REL_L2_TOL}), state rel L2 "
                             f"{float(rel_s.max())} (limit {SSD_STATE_REL_L2_TOL})")
    planted_y = planted_s = None
    if fault is not None:
        fy, fs, s0 = fault
        planted_y = float(row_rel_l2(torch, fy[:, s0], wy[:, s0]).min())
        planted_s = float(row_rel_l2(torch, fs.flatten(2), ws.flatten(2)).max())
        if planted_y <= SSD_Y_REL_L2_TOL or planted_s <= SSD_STATE_REL_L2_TOL:
            raise AssertionError(f"a state zeroed at a chunk boundary reads y {planted_y}, state "
                                 f"{planted_s}, within the limits: the check cannot see it")
    return {"max_abs_err": float((gy.float() - wy.float()).abs().max()),
            "max_rel_l2": float(rel_y.max()), "state_max_rel_l2": float(rel_s.max()),
            "planted_fault_min_rel_l2": planted_y, "planted_fault_state_rel_l2": planted_s,
            "tolerance": f"y row rel L2 <= {SSD_Y_REL_L2_TOL}, state rel L2 <= "
                         f"{SSD_STATE_REL_L2_TOL}"}


def ssd_work(S: int, B: int = 1, H: int = 48, P: int = 64, G: int = 1, N: int = 128,
             q: int = 16) -> tuple[int, int]:
    """(bytes, flops) of one ssd call: x, b, c, dt, a_log read once, y and
    the state written once; per chunk of q rows and head 2q²N (C·Bᵀ) + 2q²P
    (its product with dt x) + 4qNP (C·hᵀ and the carry), at the kernel's
    inner chunk q."""
    bytes_ = 2 * B * S * H * P * 2 + 2 * B * S * G * N * 2 + B * S * H * 4 + H * 4 \
        + B * H * P * N * 4
    flops = B * H * -(-S // q) * (2 * q * q * N + 2 * q * q * P + 4 * q * N * P)
    return bytes_, flops


def role_err(torch, got, want, fault, tol) -> dict:
    """Hold a paper-role kernel (conv2d, the f32 matmul) to its plain version:
    equal for integer outputs, within ``tol`` (atol, rtol) for f32.  ``fault``
    is the plain version with a planted fault (a filter tap, or a K tile,
    dropped); it must read beyond the same limit (raises otherwise)."""
    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"kernel gives {got.dtype} {tuple(got.shape)}, plain version "
                             f"{want.dtype} {tuple(want.shape)}")
    planted = float((fault.double() - want.double()).abs().max())
    if want.dtype.is_floating_point:
        check = max_err(torch, got, want, tol)
        atol, rtol = tol
        if not bool(((fault - want).abs() > atol + rtol * want.abs()).any()):
            raise AssertionError(f"a planted fault reads {planted}, within the limit: the "
                                 f"check cannot see it")
    else:
        if not torch.equal(got, want):
            raise AssertionError(f"kernel differs from its plain version: max |diff| "
                                 f"{float((got.double() - want.double()).abs().max())}")
        if planted == 0:
            raise AssertionError("a planted fault reads 0: the check cannot see it")
        check = {"max_abs_err": 0.0, "tolerance": "exact"}
    check["planted_fault_min_max_abs_err"] = planted
    return check


def conv_work(B: int, H: int, W: int, Cin: int, kh: int, kw: int, F: int,
              itemsize: int) -> tuple[int, int]:
    """(bytes, operations) of one conv2d call: x and w read once, the 4-byte
    output written once; a multiply and an add per tap, channel and filter
    of every output pixel."""
    oh, ow = H - kh + 1, W - kw + 1
    return ((B * H * W * Cin + kh * kw * Cin * F) * itemsize + B * oh * ow * F * 4,
            2 * B * oh * ow * F * kh * kw * Cin)


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def kernel_phase(torch, seed: int) -> tuple[list[dict], dict[str, dict]]:
    import torch.nn.functional as F
    from torch.nn.attention.bias import causal_lower_right

    from repro_torch.kernels import conv2d as conv_k
    from repro_torch.kernels import decode_attention as dec_k
    from repro_torch.kernels import flash_attention as fa_k
    from repro_torch.kernels import matmul as mm_k
    from repro_torch.kernels import paged_decode_attention as paged_k
    from repro_torch.kernels import rmsnorm as rms_k
    from repro_torch.kernels import ssd as ssd_k
    from repro_torch.kernels.ref import gather_kv_pages

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def randn(shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(torch.bfloat16)

    rows: list[dict] = []
    errs: dict[str, dict[str, dict]] = {}

    def record(name, shape, check, sets, kernel, plain, library, bytes_, flops, peak):
        # the worst errors of a kernel's rows, one group for each tolerance
        # (a kernel's types differ in tolerance: int16 conv exact, f32 not)
        tol = check["tolerance"]
        worst = errs.setdefault(name, {}).setdefault(tol, {"max_abs_err": 0.0, "tolerance": tol})
        for key in ("max_abs_err", "max_rel_l2", "state_max_rel_l2"):
            if key in check:
                worst[key] = max(worst.get(key, 0.0), check[key])
        for key in ("planted_fault_min_rel_l2", "planted_fault_state_rel_l2",
                    "planted_fault_min_max_abs_err"):
            if check.get(key) is not None:
                worst[key] = min(worst.get(key, math.inf), check[key])
        for key in ("bitwise_equal_dense_kernel", "bitwise_equal_generic_kernel"):
            if check.get(key):
                worst[key] = True
        row = {"name": name, "shape": shape, **check}
        if sets is not None:
            row["ms"], row["host_ms"] = time_ms(torch, kernel, sets)
            row["plain_ms"] = time_ms(torch, plain, sets)[0]
            row["library_ms"] = time_ms(torch, library, sets)[0] if library else None
            row["bound_ms"], row["bound_by"] = bound(bytes_, flops, peak)
            if name == "ssd":
                # its f32 work at the bf16 tensor-core rate, for comparison
                row["bound_bf16_tc_ms"] = bound(bytes_, flops, BF16_TC_FLOPS)[0]
        rows.append(row)
        print("  " + json.dumps(row))

    # matmul at the four weight shapes, at every row count the serve runs
    # give it: M = 1 (the first-token fixup), 8 (a decode step of 8 slots,
    # and the 8-row bucket), 16 (a decode step of 16 slots), 64 .. 1024 (the
    # prefill buckets; 64 and 128 are also the chunked run's chunks)
    rows_used = (1, 8, 16, 64, 128, 256, 512, 1024)
    for M in rows_used:
        for K, N in ((2048, 2048), (2048, 512), (2048, 8192), (8192, 2048)):
            k_sets = n_sets(2 * (M * K + K * N))
            sets = [(randn((M, K)), randn((K, N), K ** -0.5)) for _ in range(k_sets)]
            x, w = sets[0]
            fault = mm_k.matmul(drop_last_k_tile(x), w)
            for act in (None, "silu"):
                for out in (torch.bfloat16, torch.float32):
                    tol = TOL_F32 if out == torch.float32 else TOL_BF16
                    got = mm_k.matmul(x, w, activation=act, out_dtype=out)
                    want = mm_k.plain_matmul(x, w, activation=act, out_dtype=out)
                    check = (matmul_err(torch, got, want, fault, tol)
                             if act is None and out == torch.bfloat16 else
                             max_err(torch, got, want, tol))
                    timed = out == torch.bfloat16 and (act is None or N == 8192)
                    record(
                        "matmul", f"[{M},{K}]x[{K},{N}] act={act} out={str(out)[6:]}", check,
                        sets if timed else None,
                        lambda a, b, act=act: mm_k.matmul(a, b, activation=act),
                        lambda a, b, act=act: mm_k.plain_matmul(a, b, activation=act),
                        (lambda a, b: torch.matmul(a, b)) if act is None else None,
                        2 * (M * K + K * N + M * N), 2 * M * N * K, BF16_TC_FLOPS)
            del sets, x, w, fault

    # mamba2-780m's two weight shapes (in_proj [1536, 6448], out_proj
    # [3072, 1536]) at its row counts: 3 and 8 (decode steps of the model
    # phase and of 8 slots) and prompts of 5, 37, 45 and 600 rows (no
    # buckets: a Mamba-2 prompt prefills at its own length)
    for M in (3, 5, 8, 37, 45, 600):
        for K, N in ((1536, 6448), (3072, 1536)):
            k_sets = n_sets(2 * (M * K + K * N))
            sets = [(randn((M, K)), randn((K, N), K ** -0.5)) for _ in range(k_sets)]
            x, w = sets[0]
            check = matmul_err(torch, mm_k.matmul(x, w), mm_k.plain_matmul(x, w),
                               mm_k.matmul(drop_last_k_tile(x), w), TOL_BF16)
            record("matmul", f"[{M},{K}]x[{K},{N}] act=None out=bfloat16", check,
                   sets if M in (8, 600) else None, mm_k.matmul, mm_k.plain_matmul,
                   torch.matmul, 2 * (M * K + K * N + M * N), 2 * M * N * K, BF16_TC_FLOPS)
            del sets, x, w

    # rmsnorm: fixup, decode, chunk and prefill rows at llama's d_model 2048;
    # mamba2's ln1 and ln_f (1536) and gated norm (3072) at its row counts
    widths = [(R, 2048) for R in rows_used]
    widths += [(R, D) for D in (1536, 3072) for R in (3, 5, 8, 37, 600)]
    for R, D in widths:
        sets = [(randn((R, D)), randn((D,))) for _ in range(n_sets(4 * R * D))]
        check = max_err(torch, rms_k.rmsnorm(*sets[0]), rms_k.plain_rmsnorm(*sets[0]), TOL_BF16)
        record("rmsnorm", f"[{R},{D}]", check,
               sets if D == 2048 or R in (8, 600) else None, rms_k.rmsnorm, rms_k.plain_rmsnorm,
               lambda x, w: F.rms_norm(x, (x.shape[-1],), w, 1e-6),
               2 * (2 * R * D + D), 4 * R * D, F32_FLOPS)

    # rmsnorm in f32 (the kernel's f32 instantiation; the Pallas kernel takes
    # any dtype) at llama's decode rows, within the f32 tolerance of the JAX
    # package's own test
    R, D = 8, 2048
    sets = [(torch.randn((R, D), generator=gen, device=dev),
             torch.randn((D,), generator=gen, device=dev)) for _ in range(n_sets(8 * R * D))]
    check = max_err(torch, rms_k.rmsnorm(*sets[0]), rms_k.plain_rmsnorm(*sets[0]), TOL_ROLE_F32)
    record("rmsnorm", f"[{R},{D}] f32", check, sets, rms_k.rmsnorm, rms_k.plain_rmsnorm,
           lambda x, w: F.rms_norm(x, (x.shape[-1],), w, 1e-6),
           4 * (2 * R * D + D), 4 * R * D, F32_FLOPS)
    del sets

    # flash attention at D = 64 (llama's 32/8 heads) and D = 128 (granite's
    # and yi's heads of 128, 32/8): prefill of every bucket the serve runs
    # fill (8 .. 1024 rows; 512 also non-causal); S < T: the 128-row chunks
    # of chunked prefill against 256 .. 1024 keys, which split their key
    # range over 2-4 blocks a tile (split-KV); a sliding window of 48; a
    # ragged 200.  The planted fault is read in the rows that see all 64 of
    # its keys (none under the window).
    buckets = [(S, S, True, None) for S in (8, 64, 128, 256, 512, 1024)]
    buckets += [(512, 512, False, None)]
    chunks = [(128, T, True, None) for T in range(256, 1025, 128)]
    others = [(256, 256, True, 48), (200, 200, True, None)]
    for D in fa_k.HEAD_DIMS:
        for S, T, causal, window in buckets + chunks + others:
            per_set = 2 * (2 * 32 * S * D + 2 * 8 * T * D)
            sound, dropped = flash_masks(torch, S, T, causal, dev, window)
            # the library call: SDPA's own causal masks where they compute
            # the kernel's (top-left is_causal at S = T, the lower-right bias
            # for a chunk), an explicit mask under the window
            mask = (sound if window else causal_lower_right(S, T) if causal and S < T
                    else None)
            sets = []
            for _ in range(n_sets(per_set)):
                q, k, v = randn((1, 32, S, D)), randn((1, 8, T, D)), randn((1, 8, T, D))
                sets.append((q, k, v, k.repeat_interleave(4, 1), v.repeat_interleave(4, 1), mask))
            q, k, v = sets[0][:3]
            fault = masked_attention(torch, q, k, v, sound & ~dropped)
            kw = dict(causal=causal, window=window)
            check = attention_err(torch, fa_k.flash_attention(q, k, v, **kw),
                                  fa_k.plain_flash_attention(q, k, v, **kw), fault,
                                  dropped.sum(dim=-1) == 64)
            check["splits"] = fa_k.split_kv(1, 32, S, T, causal, window, D)
            timed = (S, T) in ((512, 512), (1024, 1024), (128, 1024)) and window is None
            record("flash_attention", f"q[1,32,{S},{D}] kv[1,8,{T},{D}] causal={causal}"
                   + (f" window={window}" if window else ""), check,
                   sets if timed else None,
                   lambda q, k, v, ke, ve, m, kw=kw: fa_k.flash_attention(q, k, v, **kw),
                   lambda q, k, v, ke, ve, m, kw=kw: fa_k.plain_flash_attention(q, k, v, **kw),
                   lambda q, k, v, ke, ve, m, c=causal and S == T and not window:
                       F.scaled_dot_product_attention(q, ke, ve, attn_mask=m, is_causal=c),
                   per_set, 4 * 32 * D * int(sound.sum()), BF16_TC_FLOPS)
            del sets, q, k, v, fault

    # decode attention: 8 slots against a 1024-row cache with lengths 1 ..
    # 1024 (a decode step), and one sequence against a cache cut to its
    # prompt length n (the first-token fixup: T = n, not a multiple of the
    # 32-key tile); at D = 64 with llama's 8 kv heads, at D = 128 with yi's
    # 4 (a group of 8 query heads) and with granite's 8 (a group of 4) at
    # the granite phase's shapes: its decode step of 8 slots against a
    # 512-row cache (each prompt's length plus the new token) and fixups.
    slots = torch.tensor([1, 1024, 5, 600, 37, 256, 900, 64], dtype=torch.int32, device=dev)
    granite = torch.tensor([n + 1 for n in GRANITE_LENGTHS], dtype=torch.int32, device=dev)
    cases = []
    for D, hkv, lengths, T, fixups in ((64, 8, slots, 1024, (5, 45, 600)),
                                       (128, 4, slots, 1024, (5, 45, 600)),
                                       (128, 8, granite, 512, (5, 45, 500))):
        cases += [(lengths, T, D, hkv, f"q[8,32,{D}] cache[8,{hkv},{T},{D}] lengths "
                   f"{int(lengths.min())}..{int(lengths.max())}")]
        cases += [(torch.tensor([n], dtype=torch.int32, device=dev), n, D, hkv,
                   f"q[1,32,{D}] cache[1,{hkv},{n},{D}] length {n}") for n in fixups]
    for lengths, T, D, hkv, shape in cases:
        B, group = lengths.numel(), 32 // hkv
        valid, dropped = decode_masks(torch, lengths, T)
        sets = []
        for _ in range(n_sets(2 * 2 * B * hkv * T * D)):
            q, kc, vc = randn((B, 32, D)), randn((B, hkv, T, D)), randn((B, hkv, T, D))
            sets.append((q, kc, vc, q[:, :, None], kc.repeat_interleave(group, 1),
                         vc.repeat_interleave(group, 1)))
        q, kc, vc = sets[0][:3]
        fault = masked_attention(torch, q[:, :, None], kc, vc, (valid & ~dropped)[:, None, None])
        check = attention_err(torch, dec_k.decode_attention(q, kc, vc, lengths),
                              dec_k.plain_decode_attention(q, kc, vc, lengths), fault[:, :, 0],
                              dropped.any(dim=-1)[:, None])
        n_keys = int(lengths.sum())
        record("decode_attention", shape, check, sets if T in (1024, 600) else None,
               lambda q, kc, vc, q4, ke, ve, n=lengths: dec_k.decode_attention(q, kc, vc, n),
               lambda q, kc, vc, q4, ke, ve, n=lengths: dec_k.plain_decode_attention(q, kc, vc, n),
               lambda q, kc, vc, q4, ke, ve, m=valid: F.scaled_dot_product_attention(
                   q4, ke, ve, attn_mask=m[:, None, None, :]),
               2 * (2 * B * 32 * D + 2 * hkv * n_keys * D), 4 * 32 * D * n_keys, BF16_TC_FLOPS)
        del sets, q, kc, vc, fault

    # paged decode attention: the 8-slot decode step against a pool of
    # 16-row pages through a shuffled table (table width 1024 / 16, the
    # dense engine's memory plus the scratch page), the same with 64-row
    # pages, the chunked run's 16 slots, and one sequence against a
    # 600-row cache; at D = 128 (yi's 4 kv heads) the 8 slots with 16- and
    # 64-row pages, and the granite phase's paged step (8 kv heads, a pool
    # of 16-row pages behind a table 512 / 16 wide).  The planted fault
    # remaps one whole page inside each sequence's length to another
    # sequence's page.
    paged_cases = [(slots, 16, 64, 64, 8), (slots, 64, 16, 64, 8),
                   (slots.repeat(2), 16, 64, 64, 8),
                   (torch.tensor([600], dtype=torch.int32, device=dev), 16, 38, 64, 8),
                   (slots, 16, 64, 128, 4), (slots, 64, 16, 128, 4),
                   (granite, 16, 32, 128, 8)]
    for lengths, ps, NP, D, hkv in paged_cases:
        B, group = lengths.numel(), 32 // hkv
        P = B * NP + 1
        shape = (f"q[{B},32,{D}] pool[{P},{hkv},{ps},{D}] table[{B},{NP}] "
                 f"lengths {lengths.tolist()}")
        n_keys = int(lengths.sum())
        sets = []
        for _ in range(n_sets(2 * 2 * hkv * n_keys * D)):
            q, kp, vp = randn((B, 32, D)), randn((P, hkv, ps, D)), randn((P, hkv, ps, D))
            table = (torch.randperm(P - 1, generator=gen, device=dev)[: B * NP] + 1)
            table = table.reshape(B, NP).to(torch.int32)
            # the yardstick's pool: heads expanded to 32 and rows before heads,
            # so one index gather yields SDPA's [B, 32, T, D] as a view
            kvp = torch.stack([kp, vp]).repeat_interleave(group, 2).transpose(2, 3).contiguous()
            sets.append((q, kp, vp, table, q[:, :, None], kvp, table.long()))
        q, kp, vp, table = sets[0][:4]
        valid = torch.arange(NP * ps, device=dev)[None, :] < lengths[:, None]
        faulted, touched = remap_one_page(table, lengths, ps)
        fault = paged_k.plain_paged_decode_attention(q, kp, vp, faulted, lengths)
        got = paged_k.paged_decode_attention(q, kp, vp, table, lengths)
        check = attention_err(torch, got,
                              paged_k.plain_paged_decode_attention(q, kp, vp, table, lengths),
                              fault, touched[:, None])
        dense = dec_k.decode_attention(q, gather_kv_pages(kp, table), gather_kv_pages(vp, table),
                                       lengths)
        if not torch.equal(got, dense):
            raise AssertionError(f"paged kernel differs from the dense kernel on the gathered "
                                 f"cache at {shape}: max |diff| "
                                 f"{float((got.float() - dense.float()).abs().max())}")
        check["bitwise_equal_dense_kernel"] = True

        def library(q, kp, vp, table, q4, kvp, tl, m=valid, B=B, T=NP * ps, D=D):
            kv = kvp[:, tl].view(2, B, T, 32, D).transpose(2, 3)
            return F.scaled_dot_product_attention(q4, kv[0], kv[1], attn_mask=m[:, None, None, :])

        record("paged_decode_attention", shape, check, sets if ps == 16 and NP == 64 else None,
               lambda q, kp, vp, t, q4, kvp, tl, n=lengths:
                   paged_k.paged_decode_attention(q, kp, vp, t, n),
               lambda q, kp, vp, t, q4, kvp, tl, n=lengths:
                   paged_k.plain_paged_decode_attention(q, kp, vp, t, n),
               library,
               2 * (2 * B * 32 * D + 2 * hkv * n_keys * D) + 4 * (B * NP + B),
               4 * 32 * D * n_keys, BF16_TC_FLOPS)
        del sets, q, kp, vp, table, fault, got, dense

    # ssd at the Mamba-2 serving shapes (H 48, P 64, N 128, G 1): a prompt
    # within one inner chunk, one chunk of the config (256), the longest
    # prompt of the serve run (600, ragged), and max_len (1024).  No one
    # PyTorch call computes it: no library time.
    for S in (5, 256, 600, 1024):
        bytes_, flops = ssd_work(S)
        sets = [ssd_inputs(torch, S, gen, dev) for _ in range(n_sets(bytes_))]
        args = sets[0]
        check = ssd_err(torch, ssd_k.ssd(*args, return_state=True),
                        ssd_k.plain_ssd(*args, return_state=True),
                        ssd_fault(torch, ssd_k.plain_ssd, *args, ssd_k.CHUNK))
        record("ssd", f"x[1,{S},48,64] b,c[1,{S},1,128]", check, sets,
               lambda *a: ssd_k.ssd(*a, return_state=True),
               lambda *a: ssd_k.plain_ssd(*a, return_state=True), None,
               bytes_, flops, F32_FLOPS)
        del sets, args

    # conv2d (paper roles 3 and 4, kernel 7): the opencl tenant's frames (one
    # 64x64 int16 frame through the 5x5 and the 3x3x2 filter), the f32 shapes
    # of examples/multi_tenant.py, and 256 frames with the card full.  int16
    # exactly, f32 within TOL_ROLE_F32, each beside a planted fault (one
    # nonzero filter tap dropped); the fixed-weight role bitwise equal to the
    # generic kernel.  Library time: F.conv2d for f32 (NCHW, TF32 off); no
    # PyTorch call convolves int16.
    conv_cases = [((1, 64, 64, 1), (5, 5, 1, 1), torch.int16),
                  ((1, 64, 64, 1), (3, 3, 1, 2), torch.int16),
                  ((1, 32, 32, 1), (5, 5, 1, 1), torch.float32),
                  ((1, 32, 32, 1), (3, 3, 1, 1), torch.float32),
                  ((256, 64, 64, 1), (3, 3, 1, 2), torch.int16)]
    for xs, wsh, dt in conv_cases:
        (B, H, W, Cin), (kh, kw, _, nf) = xs, wsh
        bytes_, ops = conv_work(B, H, W, Cin, kh, kw, nf, 2 if dt == torch.int16 else 4)
        sets = []
        for _ in range(n_sets(bytes_)):
            if dt == torch.int16:
                x = torch.randint(-100, 100, xs, generator=gen, device=dev).to(dt)
                w = torch.randint(-8, 8, wsh, generator=gen, device=dev).to(dt)
            else:
                x = torch.randn(xs, generator=gen, device=dev)
                w = torch.randn(wsh, generator=gen, device=dev)
            sets.append((x, w, x.permute(0, 3, 1, 2).contiguous(),
                         w.permute(3, 2, 0, 1).contiguous()))
        x, w = sets[0][:2]
        faulted = w.clone()
        tap = tuple(int(i) for i in (w != 0).nonzero()[0])
        faulted[tap] = 0
        got = conv_k.conv2d(x, w)
        check = role_err(torch, got, conv_k.plain_conv2d(x, w), conv_k.plain_conv2d(x, faulted),
                         TOL_ROLE_F32)
        if not torch.equal(conv_k.conv2d_fixed_weight(w.cpu()).bind(dev)(x), got):
            raise AssertionError(f"the fixed-weight conv role differs from the generic kernel "
                                 f"at x{list(xs)} w{list(wsh)}")
        check["bitwise_equal_generic_kernel"] = True
        record("conv2d", f"x[{B},{H},{W},{Cin}] w[{kh},{kw},{Cin},{nf}] {str(dt)[6:]}", check,
               sets, lambda x, w, xn, wn: conv_k.conv2d(x, w),
               lambda x, w, xn, wn: conv_k.plain_conv2d(x, w),
               (lambda x, w, xn, wn: F.conv2d(xn, wn)) if dt == torch.float32 else None,
               bytes_, ops, F32_FLOPS if dt == torch.float32 else INT32_OPS)
        del sets, x, w, got

    # the f32 matmul (the FC roles, kernel 1 in f32) at the paper's 256 x 256
    # and at 2048, with its epilogues at 256; the fixed-weight role (kernel
    # 1b) bitwise equal to it and timed on its resident weight.  Within
    # TOL_ROLE_F32, beside a planted fault (the K tile 16..31 dropped).
    # Library time: torch.matmul in f32 with TF32 off.
    for M in (256, 2048):
        per_set = 4 * 3 * M * M
        sets = [(torch.randn((M, M), generator=gen, device=dev),
                 torch.randn((M, M), generator=gen, device=dev)) for _ in range(n_sets(per_set))]
        x, w = sets[0]
        xf = x.clone()
        xf[:, 16:32] = 0
        for act in ((None, "silu", "gelu") if M == 256 else (None,)):
            check = role_err(torch, mm_k.matmul(x, w, activation=act),
                             mm_k.plain_matmul(x, w, activation=act),
                             mm_k.plain_matmul(xf, w, activation=act), TOL_ROLE_F32)
            record("matmul_f32", f"[{M},{M}]x[{M},{M}] act={act} f32", check,
                   sets if act is None else None,
                   lambda a, b, act=act: mm_k.matmul(a, b, activation=act),
                   lambda a, b, act=act: mm_k.plain_matmul(a, b, activation=act),
                   (lambda a, b: torch.matmul(a, b)) if act is None else None,
                   per_set, 2 * M ** 3, F32_FLOPS)
        fixed = mm_k.matmul_fixed_weight(w.cpu()).bind(dev)
        got = fixed(x)
        if not torch.equal(got, mm_k.matmul(x, w)):
            raise AssertionError(f"matmul_fixed_weight differs from matmul at {M}")
        check = role_err(torch, got, mm_k.plain_matmul(x, w), mm_k.plain_matmul(xf, w),
                         TOL_ROLE_F32)
        check["bitwise_equal_generic_kernel"] = True
        wf = fixed.weight
        record("matmul_fixed_weight", f"[{M},{M}]x[{M},{M}] fixed f32", check, sets,
               lambda a, b: fixed(a), lambda a, b: mm_k.plain_matmul(a, wf),
               lambda a, b: torch.matmul(a, wf), per_set, 2 * M ** 3, F32_FLOPS)
        del sets, x, w, xf, fixed, wf, got

    # the matmul edge kernel (shapes and operands TMA cannot take: guarded
    # loads, mma.sync; in f32 the f32 kernel's guarded-load instance) at the
    # untied unembeds' decode shapes: granite-3-8b, hymba-1.5b, whisper
    # large-v3.  bf16 in and f32 out, as the unembed runs it (timed), bf16
    # out, and f32 in; then x 2 bytes off a 16-byte boundary at an aligned
    # shape.  Each beside the planted fault of the bf16 rows (the last 64
    # of K dropped).  Library time: torch.matmul (bf16 out: the same weight
    # bytes), f32 with TF32 off.
    for M, K, N in UNEMBEDS:
        sets = [(randn((M, K)), randn((K, N), K ** -0.5)) for _ in range(n_sets(2 * K * N))]
        x, w = sets[0]
        f32 = torch.float32
        fault = mm_k.matmul(drop_last_k_tile(x), w, out_dtype=f32)
        check = matmul_err(torch, mm_k.matmul(x, w, out_dtype=f32),
                           mm_k.plain_matmul(x, w, out_dtype=f32), fault, TOL_F32)
        record("matmul_edge", f"[{M},{K}]x[{K},{N}] act=None out=float32", check, sets,
               lambda a, b: mm_k.matmul(a, b, out_dtype=f32),
               lambda a, b: mm_k.plain_matmul(a, b, out_dtype=f32),
               lambda a, b: torch.matmul(a, b),
               2 * (M * K + K * N) + 4 * M * N, 2 * M * N * K, BF16_TC_FLOPS)
        check = matmul_err(torch, mm_k.matmul(x, w, activation="silu"),
                           mm_k.plain_matmul(x, w, activation="silu"),
                           mm_k.matmul(drop_last_k_tile(x), w, activation="silu"), TOL_BF16)
        record("matmul_edge", f"[{M},{K}]x[{K},{N}] act=silu out=bfloat16", check, None,
               None, None, None, 0, 0, BF16_TC_FLOPS)
        del sets, x, w, fault
        x = torch.randn((M, K), generator=gen, device=dev)
        w = torch.randn((K, N), generator=gen, device=dev) * K ** -0.5
        xf = drop_last_k_tile(x)
        check = role_err(torch, mm_k.matmul(x, w), mm_k.plain_matmul(x, w),
                         mm_k.plain_matmul(xf, w), TOL_ROLE_F32)
        record("matmul_edge", f"[{M},{K}]x[{K},{N}] act=None f32", check, [(x, w)],
               mm_k.matmul, mm_k.plain_matmul, torch.matmul,
               4 * (M * K + K * N + M * N), 2 * M * N * K, F32_FLOPS)
        del x, w, xf
    M, K, N = 8, 2048, 512
    x = torch.empty(M * K + 1, dtype=torch.bfloat16, device=dev)[1:].view(M, K)
    x.copy_(randn((M, K)))
    w = randn((K, N), K ** -0.5)
    check = matmul_err(torch, mm_k.matmul(x, w), mm_k.plain_matmul(x, w),
                       mm_k.matmul(drop_last_k_tile(x), w), TOL_BF16)
    record("matmul_edge", f"[{M},{K}]x[{K},{N}] x 2 bytes off 16-byte alignment", check, None,
           None, None, None, 0, 0, BF16_TC_FLOPS)
    return rows, errs


# ---------------------------------------------------------------------------
# phases 3 and 4: the model and the server
# ---------------------------------------------------------------------------


def model_phase(torch, model, params, seed: int) -> dict:
    """The full model under cuda-strict against the torch eager source, on
    the calls the engine makes for four prompts: the prefill of each prompt
    padded to its bucket (S = T = 8 .. 1024), the first-token fixup decode
    step against the cache cut to the prompt (T = n), and one decode step of
    the four as a batch at their own positions.  Each source runs every call
    on its own caches; the compared logits come from the same tokens.  Then
    chunked prefill of the three longer prompts against their whole-prompt
    prefill (:func:`chunked_prefill_check`)."""
    from repro_torch.core import dispatch
    from repro_torch.serve.engine import ServeEngine

    dev, vocab = model.device, model.cfg.vocab_size
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 1)
    lengths = (5, 64, 300, 600)
    prompts = [torch.randint(0, vocab, (n,), generator=gen, device=dev) for n in lengths]
    next_tokens = torch.randint(0, vocab, (len(lengths), 1), generator=gen, device=dev)
    buckets = [ServeEngine.bucket_len(n, 1024) for n in lengths]
    out: dict[str, dict[str, list]] = {}
    for policy in ("torch", "cuda-strict"):
        got: dict[str, list] = {"prefill": [], "fixup": [], "decode": []}
        caches = []
        with dispatch.use(prefer=dispatch.policy_from_flag(policy)):
            for tokens, n, bucket in zip(prompts, lengths, buckets):
                padded = torch.nn.functional.pad(tokens, (0, bucket - n))[None]
                logits, cache = model.prefill(params, {"tokens": padded}, cache_len=1024)
                got["prefill"].append(logits[0])
                if bucket > n:
                    fix = {"pos": torch.tensor([n - 1], dtype=torch.int32, device=dev),
                           "k": cache["k"][:, :, :, :n].clone(),
                           "v": cache["v"][:, :, :, :n].clone()}
                    got["fixup"].append(model.decode_step(params, tokens[None, -1:], fix)[0][0])
                caches.append(cache)
            batch = {"pos": torch.tensor(lengths, dtype=torch.int32, device=dev),
                     "k": torch.cat([c["k"] for c in caches], dim=1),
                     "v": torch.cat([c["v"] for c in caches], dim=1)}
            del caches
            got["decode"] = list(model.decode_step(params, next_tokens, batch)[0])
            del batch
        out[policy] = got
    res = {"prompt_lengths": list(lengths), "buckets": buckets,
           "tolerance_rel_l2": MODEL_REL_L2_TOL}
    for kind in ("prefill", "fixup", "decode"):
        rel, agree = [], 0
        for ref, g in zip(out["torch"][kind], out["cuda-strict"][kind]):
            ref, g = ref.float(), g.float()
            if not torch.isfinite(g).all() or g.shape != (vocab,):
                raise AssertionError(f"{kind} logits of shape {tuple(g.shape)}, or not finite")
            rel.append(float((g - ref).norm() / ref.norm()))
            agree += int(g.argmax() == ref.argmax())
        res[kind] = {"rel_l2": rel, "top1_agree": f"{agree} of {len(rel)}"}
    res["chunked"] = chunked_prefill_check(torch, model, params, prompts[1:], buckets[1:],
                                           out["cuda-strict"]["prefill"][1:])
    print("  " + json.dumps(res))
    worst = max(max(res[kind]["rel_l2"]) for kind in ("prefill", "fixup", "decode", "chunked"))
    if worst > MODEL_REL_L2_TOL or len(res["fixup"]["rel_l2"]) != 3:
        raise AssertionError(f"cuda-strict logits differ from the torch source or from "
                             f"whole-prompt prefill: {res}")
    return res


def chunked_prefill_check(torch, model, params, prompts, buckets, whole, chunk: int = 128):
    """Chunked prefill under cuda-strict, as the engines run it: each
    bucketed prompt in ``chunk``-row pieces through a 1024-row staging cache
    (dense) and through a pool of 16-row pages behind a shuffled table
    (paged).  The last chunk's logits against whole-prompt prefill's
    (``whole``, same policy).  The paged form must equal the staging form
    bit for bit wherever the engine reads it (the same rows reach the same
    kernels): the logits of every chunk of prompt rows only, the prompt's
    cache rows, and the first-token fixup's logits over them.  (A chunk that
    ends on pad rows reads pad keys that differ: paged, those past the
    prompt's pages share the scratch page.)  Each chunk is a flash attention
    call with S = chunk < T = start + chunk."""
    from repro_torch.core import dispatch
    from repro_torch.serve.paged import gather_rows

    dev, rel, agree = model.device, [], 0
    ps, NP = 16, 1024 // 16
    specs = model.cache_specs(1, 1024)
    pool_specs = model.cache_specs(NP + 1, ps)
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    with dispatch.use(prefer=dispatch.policy_from_flag("cuda-strict")):
        for tokens, bucket, want in zip(prompts, buckets, whole):
            n = tokens.numel()
            padded = torch.nn.functional.pad(tokens, (0, bucket - n))[None]
            staging = {key: torch.zeros(specs[key].shape, dtype=specs[key].dtype, device=dev)
                       for key in ("k", "v")}
            pool = {key: torch.zeros(pool_specs[key].shape, dtype=pool_specs[key].dtype,
                                     device=dev) for key in ("k", "v")}
            table = torch.zeros(1, NP, dtype=torch.int32, device=dev)      # scratch page 0
            mapped = -(-n // ps)
            table[0, :mapped] = (torch.randperm(NP, generator=gen, device=dev)[:mapped] + 1).int()
            for start in range(0, bucket, chunk):
                piece = padded[:, start:start + chunk]
                logits, _ = model.prefill_chunk(params, piece, staging, start=start)
                paged, _ = model.prefill_chunk(params, piece, {**pool, "block_table": table},
                                               start=start)
                if start + chunk <= n and not torch.equal(paged, logits):
                    raise AssertionError(f"paged chunked prefill differs from staging at a "
                                         f"{n}-token prompt, chunk at {start}")
            rows = gather_rows(pool, table[0].tolist(), n, ps)
            for key in ("k", "v"):
                if not torch.equal(rows[key], staging[key][:, :, :, :n]):
                    raise AssertionError(f"paged chunked prefill wrote other {key} rows than "
                                         f"staging at a {n}-token prompt")
            if bucket > n:
                pos = torch.tensor([n - 1], dtype=torch.int32, device=dev)
                fix = [model.decode_step(params, tokens[None, -1:], {"pos": pos, **kv})[0]
                       for kv in (rows, {key: staging[key][:, :, :, :n].clone()
                                         for key in ("k", "v")})]
                if not torch.equal(*fix):
                    raise AssertionError(f"the first-token fixup differs between paged and "
                                         f"staging chunked prefill at a {n}-token prompt")
            del staging, pool, rows
            g, ref = logits[0].float(), want.float()
            if not torch.isfinite(g).all():
                raise AssertionError("chunked prefill logits are not finite")
            rel.append(float((g - ref).norm() / ref.norm()))
            agree += int(g.argmax() == ref.argmax())
    return {"prompt_lengths": [int(t.numel()) for t in prompts], "chunk": chunk,
            "rel_l2": rel, "top1_agree": f"{agree} of {len(rel)}",
            "paged_equal_staging_bitwise": True}


def pages_of(torch, kv, table, ps: int):
    """The page pool [L, P, Hkv, ps, hd] holding a dense cache kv [L, B, Hkv,
    T, hd] through ``table`` [B, T / ps] (page 0 and unmapped pages zero)."""
    L, B, H, T, hd = kv.shape
    NP = T // ps
    pool = kv.new_zeros((L, int(table.max()) + 1, H, ps, hd))
    pool[:, table.reshape(-1).long()] = kv.reshape(L, B, H, NP, ps, hd).transpose(2, 3).reshape(
        L, B * NP, H, ps, hd)
    return pool


def granite_phase(torch, model, params, kernels, seed: int) -> dict:
    """granite-3-8b at full width (d_model 4096, 32/8 heads of 128, d_ff
    12800, vocab 49155, an untied unembed) and its first GRANITE_DEPTH
    layers, weights from ``seed``, under cuda-strict against the torch eager
    source on the same weights, on the calls an engine of 8 slots and
    ``max_len`` 512 makes: each of 8 prompts prefilled at its bucket (8 ..
    512), its first-token fixup against the cache cut to the prompt, one
    decode step of the 8 as a batch — over the dense cache, and over a pool
    of 16-row pages behind a shuffled table, whose logits must equal the
    dense step's bit for bit — and a 512-token prompt in four 128-row
    chunks through a staging cache and through a page pool (bitwise equal;
    the last chunk is flash attention of S = 128 against T = 512).  Logits
    within MODEL_REL_L2_TOL of the torch source's.  The cuda-strict pass's
    launches are counted from 0 and must equal what its calls imply:
    flash, decode and paged attention at D = 128 and the edge matmul (the
    unembed, N = 49155) each run."""
    from repro_torch.core import dispatch
    from repro_torch.kernels import matmul as mm_k
    from repro_torch.serve.engine import ServeEngine

    dev, cfg = model.device, model.cfg
    vocab, L = cfg.vocab_size, cfg.num_layers
    max_len, ps, chunk = 512, 16, 128
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 5)
    lengths = GRANITE_LENGTHS
    prompts = [torch.randint(0, vocab, (n,), generator=gen, device=dev) for n in lengths]
    next_tokens = torch.randint(0, vocab, (len(lengths), 1), generator=gen, device=dev)
    long_prompt = torch.randint(0, vocab, (1, max_len), generator=gen, device=dev)
    buckets = [ServeEngine.bucket_len(n, max_len) for n in lengths]
    B, NP = len(lengths), max_len // ps
    table = (torch.randperm(B * NP, generator=gen, device=dev) + 1).reshape(B, NP).int()
    chunk_table = (torch.randperm(NP, generator=gen, device=dev) + 1)[None].int()
    specs, pool_specs = model.cache_specs(1, max_len), model.cache_specs(NP + 1, ps)
    out, launches = {}, {}
    for policy in ("torch", "cuda-strict"):
        for mod in kernels:
            mod.launches = 0
        mm_k.edge_launches = 0
        got: dict[str, list] = {k: [] for k in ("prefill", "fixup", "decode", "decode_paged",
                                                "chunk", "chunk_paged")}
        with dispatch.use(prefer=dispatch.policy_from_flag(policy)):
            caches = []
            for tokens, n, bucket in zip(prompts, lengths, buckets):
                padded = torch.nn.functional.pad(tokens, (0, bucket - n))[None]
                logits, cache = model.prefill(params, {"tokens": padded}, cache_len=max_len)
                got["prefill"].append(logits[0])
                if bucket > n:
                    fix = {"pos": torch.tensor([n - 1], dtype=torch.int32, device=dev),
                           "k": cache["k"][:, :, :, :n].clone(),
                           "v": cache["v"][:, :, :, :n].clone()}
                    got["fixup"].append(model.decode_step(params, tokens[None, -1:], fix)[0][0])
                caches.append(cache)
            kv = {key: torch.cat([c[key] for c in caches], dim=1) for key in ("k", "v")}
            del caches
            pos = torch.tensor(lengths, dtype=torch.int32, device=dev)
            pool = {key: pages_of(torch, kv[key], table, ps) for key in ("k", "v")}
            got["decode_paged"] = list(model.decode_step(
                params, next_tokens, {**pool, "pos": pos, "block_table": table})[0])
            got["decode"] = list(model.decode_step(params, next_tokens, {**kv, "pos": pos})[0])
            del kv, pool
            staging = {key: torch.zeros(specs[key].shape, dtype=specs[key].dtype, device=dev)
                       for key in ("k", "v")}
            paged = {key: torch.zeros(pool_specs[key].shape, dtype=pool_specs[key].dtype,
                                      device=dev) for key in ("k", "v")}
            for start in range(0, max_len, chunk):
                piece = long_prompt[:, start:start + chunk]
                last, _ = model.prefill_chunk(params, piece, staging, start=start)
                last_paged, _ = model.prefill_chunk(
                    params, piece, {**paged, "block_table": chunk_table}, start=start)
            got["chunk"], got["chunk_paged"] = [last[0]], [last_paged[0]]
            del staging, paged
        launches = {mod.__name__.rsplit(".", 1)[1]: mod.launches for mod in kernels}
        launches["matmul_edge"] = mm_k.edge_launches
        out[policy] = got
    strict = out["cuda-strict"]
    for a, b in (("decode_paged", "decode"), ("chunk_paged", "chunk")):
        if not all(torch.equal(x, y) for x, y in zip(strict[a], strict[b])):
            raise AssertionError(f"granite: {a} logits differ from {b} logits under cuda-strict")
    res = {"arch": cfg.name, "layers": L, "prompt_lengths": list(lengths), "buckets": buckets,
           "tolerance_rel_l2": MODEL_REL_L2_TOL, "paged_equal_dense_bitwise": True}
    for kind in got:
        rel, agree = [], 0
        for ref, g in zip(out["torch"][kind], strict[kind]):
            ref, g = ref.float(), g.float()
            if not torch.isfinite(g).all() or g.shape != (vocab,):
                raise AssertionError(f"granite {kind} logits of shape {tuple(g.shape)}, or "
                                     f"not finite")
            rel.append(float((g - ref).norm() / ref.norm()))
            agree += int(g.argmax() == ref.argmax())
        res[kind] = {"rel_l2": rel, "top1_agree": f"{agree} of {len(rel)}"}
    # one unembed a model call; 7 matmuls and 2 norms a layer, the final norm
    calls = len(lengths) + len(got["fixup"]) + 2 + 2 * max_len // chunk
    want = {"matmul": 7 * L * calls, "rmsnorm": (2 * L + 1) * calls,
            "flash_attention": L * (len(lengths) + 2 * max_len // chunk),
            "decode_attention": L * (len(got["fixup"]) + 1), "paged_decode_attention": L,
            "ssd": 0, "matmul_edge": calls}
    res["launches"] = launches
    print("  " + json.dumps(res))
    if launches != want:
        raise AssertionError(f"granite: kernel launches {launches}, expected {want}")
    worst = max(max(res[kind]["rel_l2"]) for kind in got)
    if worst > MODEL_REL_L2_TOL or len(got["fixup"]) != len(lengths):
        raise AssertionError(f"granite: cuda-strict logits differ from the torch source: {res}")
    return res


def ssm_end_to_end(torch, model, params, prompts, steps, policy: str) -> dict:
    """The engine's calls under ``policy``: each prompt's prefill at its own
    length, then ``steps`` decode steps of the prompts as a batch from the
    prefills' caches.  Logits (prefill rows, then decode rows) and the SSD
    state after the prefills and after the decode steps."""
    from repro_torch.core import dispatch

    dev = model.device
    with dispatch.use(prefer=dispatch.policy_from_flag(policy)):
        caches = [model.prefill(params, {"tokens": t[None]}) for t in prompts]
        got = {"prefill": [logits[0] for logits, _ in caches], "decode": []}
        batch = {"pos": torch.tensor([t.numel() for t in prompts], dtype=torch.int32,
                                     device=dev),
                 **{key: torch.cat([c[key] for _, c in caches], dim=1)
                    for key in ("ssm_state", "conv_tail")}}
        del caches
        got["state_prefill"] = batch["ssm_state"].clone()
        for tok in steps:
            logits, batch = model.decode_step(params, tok, batch)
            got["decode"] += list(logits)
        got["state_decode"] = batch["ssm_state"]
    return got


def compare_end_to_end(torch, got, want, vocab: int) -> dict:
    """Relative L2 and top-1 agreement of ``got``'s logits against
    ``want``'s, and the largest per-layer relative L2 of the SSD state."""
    res = {}
    for kind in ("prefill", "decode"):
        rel, agree = [], 0
        for ref, g in zip(want[kind], got[kind]):
            ref, g = ref.float(), g.float()
            if not torch.isfinite(g).all() or g.shape != (vocab,):
                raise AssertionError(f"{kind} logits of shape {tuple(g.shape)}, or not finite")
            rel.append(float((g - ref).norm() / ref.norm()))
            agree += int(g.argmax() == ref.argmax())
        res[kind] = {"rel_l2": rel, "top1_agree": f"{agree} of {len(rel)}"}
    for kind in ("state_prefill", "state_decode"):
        ref, g = want[kind], got[kind]
        if not torch.isfinite(g).all() or g.shape != ref.shape:
            raise AssertionError(f"{kind} of shape {tuple(g.shape)}, or not finite")
        per_layer = (g - ref).flatten(1).norm(dim=1) / ref.flatten(1).norm(dim=1)
        res[kind] = {"max_rel_l2_over_layers": float(per_layer.max()), "shape": list(g.shape)}
    return res


def ssm_model_phase(torch, model, params, seed: int) -> dict:
    """Mamba-2 under cuda-strict against the torch eager source on the same
    weights, on the calls the engine makes for three prompts of 5, 37 and
    600 tokens (their prefills at their own length: an SSM prompt is not
    bucketed, and 600 is ragged against any chunk) and three decode steps of
    the three as a batch.

    At full depth (48 layers) two sources part by rounding alone: each
    layer's bf16 roundings, flipped by another summation order, grow through
    the random-weight stack, and the torch and reference sources (no
    hand-written kernel in either) part as far as cuda-strict and torch do.
    So the kernels are held where they act, layer by layer
    (:func:`ssm_layer_walk`, each layer within SSM_LAYER_REL_L2_TOL), and the
    path end to end at the first SSM_GATED_DEPTH layers of the same weights
    (logits within MODEL_REL_L2_TOL, state within SSM_STATE_REL_L2_TOL); the
    full-depth logits are reported beside the torch-against-reference
    control."""
    from repro_torch.models import build_model

    dev, vocab = model.device, model.cfg.vocab_size
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 4)
    lengths = (5, 37, 600)
    prompts = [torch.randint(0, vocab, (n,), generator=gen, device=dev) for n in lengths]
    steps = torch.randint(0, vocab, (3, len(lengths), 1), generator=gen, device=dev)
    res = {"prompt_lengths": list(lengths), "decode_steps": len(steps),
           "tolerance_rel_l2": MODEL_REL_L2_TOL, "state_tolerance_rel_l2": SSM_STATE_REL_L2_TOL,
           "layer_tolerance_rel_l2": SSM_LAYER_REL_L2_TOL, "gated_depth": SSM_GATED_DEPTH}
    walk = ssm_layer_walk(torch, model, params, prompts[-1], steps[0, -1, 0])
    res["layers"] = {key: {"max": max(v), "by_layer": v} for key, v in walk.items()}
    forced = max(max(walk[k]) for k in ("prefill_y", "prefill_state", "decode_y",
                                        "decode_state"))
    full = {p: ssm_end_to_end(torch, model, params, prompts, steps, p)
            for p in ("torch", "cuda-strict", "reference")}
    res["full_depth"] = compare_end_to_end(torch, full["cuda-strict"], full["torch"], vocab)
    res["full_depth_control_torch_vs_reference"] = compare_end_to_end(
        torch, full["torch"], full["reference"], vocab)
    del full
    depth = min(SSM_GATED_DEPTH, model.cfg.num_layers)
    cut = build_model(dataclasses.replace(model.cfg, num_layers=depth), device=dev)
    cut_params = {**params, "layers": params["layers"][:depth]}
    short = {p: ssm_end_to_end(torch, cut, cut_params, prompts, steps, p)
             for p in ("torch", "cuda-strict")}
    res["gated_depth_end_to_end"] = compare_end_to_end(torch, short["cuda-strict"],
                                                       short["torch"], vocab)
    print("  " + json.dumps({k: v for k, v in res.items() if k != "layers"}))
    print("  " + json.dumps({"layer_walk_max": {k: v["max"] for k, v in res["layers"].items()}}))
    gated = res["gated_depth_end_to_end"]
    worst = max(max(gated[kind]["rel_l2"]) for kind in ("prefill", "decode"))
    state = max(gated[kind]["max_rel_l2_over_layers"] for kind in ("state_prefill",
                                                                    "state_decode"))
    if forced > SSM_LAYER_REL_L2_TOL or worst > MODEL_REL_L2_TOL or state > SSM_STATE_REL_L2_TOL:
        raise AssertionError(f"cuda-strict differs from the torch source: layer by layer "
                             f"{forced}, end to end at depth {SSM_GATED_DEPTH} {worst} (logits) "
                             f"and {state} (state)")
    return res


def ssm_layer_walk(torch, model, params, tokens, next_token) -> dict:
    """Mamba-2 layer by layer under the torch source and cuda-strict, on one
    prompt ``tokens`` [S] and one decode token.  Teacher-forced: each
    layer's input (the torch source's residual stream) goes through ln1 and
    the Mamba-2 block under both sources, so the per-layer relative L2 of
    the block's output and final state measures that layer's kernels alone;
    the decode token then runs one block step from the torch source's
    prefill state in every layer.  Free-running: each source's own residual
    stream, whose last row's relative L2 after each layer shows how the
    sources' rounding differences grow with depth."""
    from repro_torch.core import dispatch
    from repro_torch.models import layers, ssm

    cfg = model.cfg
    policies = {name: dispatch.policy_from_flag(name) for name in ("torch", "cuda-strict")}

    def rel(got, want) -> float:
        return float((got.float() - want.float()).norm() / want.float().norm())

    def block(policy, p, x, *state):
        with dispatch.use(prefer=policies[policy]):
            h = layers.apply_norm(p["ln1"], x, cfg.norm_eps)
            if state:
                return ssm.ssm_decode(p["mamba"], h, *state, cfg)
            return ssm.ssm_full(p["mamba"], h, cfg, return_state=True)

    x = layers.embed_tokens(params["embed"], tokens[None])
    xd = layers.embed_tokens(params["embed"], next_token[None, None])
    free = {name: x for name in policies}
    out = {"prefill_y": [], "prefill_state": [], "decode_y": [], "decode_state": [],
           "free_running_last_row": []}
    for p in params["layers"]:
        pre = {name: block(name, p, x) for name in policies}
        dec = {name: block(name, p, xd, pre["torch"][1], pre["torch"][2]) for name in policies}
        for kind, res in (("prefill", pre), ("decode", dec)):
            out[f"{kind}_y"].append(rel(res["cuda-strict"][0], res["torch"][0]))
            out[f"{kind}_state"].append(rel(res["cuda-strict"][1], res["torch"][1]))
        x, xd = x + pre["torch"][0], xd + dec["torch"][0]
        free = {name: free[name] + block(name, p, free[name])[0] for name in policies}
        out["free_running_last_row"].append(rel(free["cuda-strict"][:, -1], free["torch"][:, -1]))
    return out


#: the serve phase's three engines, on the same requests: dense; paged with
#: the dense engine's KV memory (its default pool); paged with chunked
#: prefill, twice the slots in that same KV memory (paged chunks write and
#: read the pool directly: no staging cache)
SERVE_RUNS = (
    ("dense", {"batch_slots": 8}),
    ("paged", {"batch_slots": 8, "paged": True, "page_size": 16}),
    ("paged_chunked", {"batch_slots": 16, "paged": True, "page_size": 16,
                       "prefill_chunk": 128, "pool_pages": 8 * 1024 // 16 + 1}),
)


def expected_launches(eng, cfg) -> dict[str, int]:
    """Each kernel's launches implied by the engine's model calls.  Dense:
    every call runs 7 matmuls and 2 norms a layer and the final norm;
    prefills and chunks run flash attention, the first-token fixups dense
    decode attention, and decode steps dense or paged decode attention.
    Mamba-2: every call runs 2 matmuls (in_proj, out_proj) and 2 norms (ln1,
    the gated norm) a layer and the final norm; prefills run ssd in every
    layer, decode steps none (their single-token update is eager).  The tied
    unembed is a plain f32 product, not a kernel."""
    L = cfg.num_layers
    calls = eng.prefill_calls + eng.chunk_calls + eng.fixup_calls + eng.decode_calls
    if cfg.family == "ssm":
        return {"matmul": 2 * L * calls, "rmsnorm": (2 * L + 1) * calls, "flash_attention": 0,
                "decode_attention": 0, "paged_decode_attention": 0,
                "ssd": L * eng.prefill_calls}
    return {"matmul": 7 * L * calls, "rmsnorm": (2 * L + 1) * calls,
            "flash_attention": L * (eng.prefill_calls + eng.chunk_calls),
            "decode_attention": L * (eng.fixup_calls + (0 if eng.paged else eng.decode_calls)),
            "paged_decode_attention": L * eng.decode_calls if eng.paged else 0, "ssd": 0}


def serve_run(torch, model, params, kernels, prompts, before_step=None, **engine_kw):
    """Serve ``prompts`` (32 new tokens each) through one engine under
    cuda-strict; the run's numbers and the token streams in submission order.  The kernels' launch
    counts are set to 0 just before the run and read just after it.
    ``before_step(i)``, if given, runs before the engine's step ``i`` (another
    tenant's submissions)."""
    from repro_torch.core import dispatch
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.paged import pool_token_bytes

    cuda = model.device.type == "cuda"
    with dispatch.use(prefer=dispatch.policy_from_flag("cuda-strict")):
        eng = ServeEngine(model, params, max_len=1024, device=model.device, **engine_kw)
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        for mod in kernels:
            mod.launches = 0
        for p in prompts:
            eng.submit(p, max_new_tokens=32)
        done, decode_s, decode_tok, t0 = [], 0.0, 0, time.perf_counter()
        for step in range(1000):
            if before_step is not None:
                before_step(step)
            calls = eng.prefill_calls + eng.chunk_calls
            toks, ts = eng.decode_tokens, time.perf_counter()
            done += eng.step()        # every step ends reading tokens back to the host
            if eng.prefill_calls + eng.chunk_calls == calls:
                decode_s += time.perf_counter() - ts
                decode_tok += eng.decode_tokens - toks
            if len(done) == len(prompts):
                break
        wall = time.perf_counter() - t0
        launches = {mod.__name__.rsplit(".", 1)[1]: mod.launches for mod in kernels}
    peak = torch.cuda.max_memory_allocated() if cuda else None
    vocab = model.cfg.vocab_size
    if len(done) != len(prompts):
        raise AssertionError(f"{len(done)} of {len(prompts)} requests completed")
    for r in done:
        if len(r.generated) != 32 or not all(0 <= t < vocab for t in r.generated):
            raise AssertionError(f"request {r.uid}: bad tokens {r.generated}")
    want = expected_launches(eng, model.cfg)
    if launches != want:
        raise AssertionError(f"kernel launches {launches}, expected {want} from the engine's "
                             f"{eng.prefill_calls} prefills, {eng.chunk_calls} chunks, "
                             f"{eng.fixup_calls} fixups and {eng.decode_calls} decode steps")
    if any(launches[n] == 0 for n, v in want.items() if v):
        raise AssertionError(f"a kernel of the path never launched while serving: {launches}")
    ttft = sorted(r.first_token_t - r.arrival_t for r in done)
    # every cache tensor the engine holds: the batch cache or pool, and
    # staging: KV for attention models, the recurrent state for Mamba-2
    cache_bytes = sum(t.numel() * t.element_size()
                      for c in (eng._cache, *eng._staging.values()) for t in c.values())
    res = {**{k: v for k, v in engine_kw.items() if isinstance(v, (bool, int, float, str))},
           "requests": len(done), "new_tokens_each": 32,
           "prefill_calls": eng.prefill_calls, "chunk_calls": eng.chunk_calls,
           "fixup_calls": eng.fixup_calls, "decode_calls": eng.decode_calls,
           "launches": launches,
           "ttft_mean_s": sum(ttft) / len(ttft),
           "ttft_p99_s": ttft[min(len(ttft) - 1, math.ceil(0.99 * len(ttft)) - 1)],
           "decode_tokens_per_s": decode_tok / decode_s if decode_s else None,
           "decode_tokens": decode_tok, "wall_s": wall, "max_memory_allocated_bytes": peak,
           ("state_bytes" if model.cfg.family == "ssm" else "kv_bytes"): cache_bytes,
           "peak_concurrency": eng.peak_concurrency,
           "sustained_concurrency": eng.concurrency_stats()["sustained"],
           # KV bytes the pool held mapped at its high-water mark (paged runs)
           "kv_high_water_bytes": (eng.allocator.stats().high_water * eng.page_size
                                   * pool_token_bytes(eng._cache)) if eng.paged else None}
    return res, [r.generated for r in sorted(done, key=lambda r: r.uid)]


def serve_prompts(torch, vocab: int, seed: int) -> tuple[list[int], list[list[int]]]:
    """The serve runs' 16 prompts: 5 to 600 tokens, evenly spaced, drawn
    from ``seed`` in the model's vocabulary."""
    rng = torch.Generator().manual_seed(seed + 2)
    lengths = [round(5 + i * (600 - 5) / 15) for i in range(16)]
    return lengths, [torch.randint(0, vocab, (n,), generator=rng).tolist() for n in lengths]


def ssm_serve_phase(torch, model, params, kernels, seed: int) -> dict:
    """The ``ssm`` run: the 16 prompts through one engine of 8 slots,
    unbucketed (no first-token fixup), its launches checked against its
    model calls by :func:`serve_run`; the engine's recurrent state is 8
    slots of every layer's [H, P, N] f32 state and conv tail."""
    lengths, prompts = serve_prompts(torch, model.cfg.vocab_size, seed)
    res, _ = serve_run(torch, model, params, kernels, prompts, batch_slots=8)
    if res["fixup_calls"] or res["prefill_calls"] != len(prompts):
        raise AssertionError(f"an SSM prompt was bucketed: {res['prefill_calls']} prefills, "
                             f"{res['fixup_calls']} fixups")
    print("  " + json.dumps({"run": "ssm", **res}))
    return {"prompt_lengths": lengths, "runs": {"ssm": res}}


def serve_phase(torch, model, params, kernels, seed: int) -> dict:
    """The three runs of ``SERVE_RUNS`` on the same 16 prompts.  Paged
    streams must equal dense streams token for token (the paged kernel is
    bitwise the dense one over equal rows); the chunked 16-slot run must
    complete everything with more than 8 requests live at once, holding no
    more KV memory than the dense run (plus the pool's scratch page).  How many
    of its streams equal the dense run's is printed, not gated: a chunk's
    matmuls may sum in another order than a whole prompt's."""
    lengths, prompts = serve_prompts(torch, model.cfg.vocab_size, seed)
    runs, streams = {}, {}
    for name, kw in SERVE_RUNS:
        runs[name], streams[name] = serve_run(torch, model, params, kernels, prompts, **kw)
        print("  " + json.dumps({"run": name, **runs[name]}))
    if streams["paged"] != streams["dense"]:
        differ = [i for i, (a, b) in enumerate(zip(streams["paged"], streams["dense"])) if a != b]
        raise AssertionError(f"paged streams differ from dense streams in requests {differ}")
    page_bytes = runs["dense"]["kv_bytes"] // (8 * 1024) * 16
    if runs["paged_chunked"]["kv_bytes"] > runs["dense"]["kv_bytes"] + page_bytes:
        raise AssertionError(f"the chunked 16-slot run holds {runs['paged_chunked']['kv_bytes']} "
                             f"bytes of KV, more than the dense run's "
                             f"{runs['dense']['kv_bytes']} and a scratch page")
    if runs["paged_chunked"]["peak_concurrency"] <= 8:
        raise AssertionError(f"the chunked 16-slot run peaked at "
                             f"{runs['paged_chunked']['peak_concurrency']} live requests")
    same = sum(a == b for a, b in zip(streams["paged_chunked"], streams["dense"]))
    return {"prompt_lengths": lengths, "runs": runs, "paged_streams_equal_dense": True,
            "dense_streams": streams["dense"],
            "chunked_streams_equal_dense": f"{same} of {len(prompts)}",
            "launches": {name: sum(r["launches"][name] for r in runs.values())
                         for name in runs["paged"]["launches"]}}


# ---------------------------------------------------------------------------
# phase 5: two tenants on one card through the HSA runtime
# ---------------------------------------------------------------------------


def calibrate_fc(torch, sched, q, roles: dict, reps: int = 20) -> dict:
    """The role planner's costs, measured on the card (the counterpart of the
    JAX package's ``benchmarks/common.py`` ``calibrate_costs``): each FC
    role's load (weight upload and warm-up launch) and exec (one launch to
    completion, the median of ``reps``), and the dispatch overhead of a queue
    round trip of the resident generic role less its exec.  ``roles`` maps
    "generic" and "fixed" to (role, args).  The worker thread must be
    running; every role is unloaded again."""
    out = {}
    for kind, (role, args) in roles.items():
        role.unload()
        t0 = time.perf_counter()
        role.load()
        load_s = time.perf_counter() - t0
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            role(*args)
            if role.device.type == "cuda":
                torch.cuda.synchronize(role.device)
            times.append(time.perf_counter() - t0)
        out[kind] = {"load_s": load_s, "exec_s": sorted(times)[reps // 2]}
    role, args = roles["generic"]
    sched.regions.ensure_resident(role)
    trips = []
    for _ in range(reps):
        t0 = time.perf_counter()
        pkt = q.dispatch(role.key, *args, producer="calibration")
        if not pkt.completion.wait_eq(0, timeout=60) or pkt.out.error is not None:
            raise AssertionError(f"a calibration packet failed: {pkt.out.error}")
        trips.append(time.perf_counter() - t0)
    out["round_trip_s"] = sorted(trips)[reps // 2]
    out["dispatch_s"] = max(0.0, out["round_trip_s"] - out["generic"]["exec_s"])
    for role, _ in roles.values():
        role.unload()
    sched.regions.flush()
    return out


def call_cost(torch, model, params, reps: int = 20) -> dict:
    """Where a routed model call's extra host time goes: the median ms of
    one 8-slot decode step (to a synchronise) run on this thread, on a plain
    thread of its own, and as a call packet through an HSA queue whose
    scheduler's worker thread runs it (submit to completion), under
    cuda-strict."""
    import contextvars
    import threading

    from repro_torch.core import dispatch, hsa
    from repro_torch.core import ledger as L
    from repro_torch.core.reconfig import RegionManager
    from repro_torch.core.roles import RoleLibrary

    dev = model.device
    specs = model.cache_specs(8, 1024)
    cache = {k: torch.zeros(v.shape, dtype=v.dtype, device=dev) for k, v in specs.items()
             if k != "pos"}
    cache["pos"] = torch.arange(8, dtype=torch.int32, device=dev) * 100 + 5
    tok = torch.zeros((8, 1), dtype=torch.int32, device=dev)

    def step():
        model.decode_step(params, tok, cache)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def timed(run) -> float:
        times = []
        for i in range(reps + 3):
            t0 = time.perf_counter()
            run()
            if i >= 3:
                times.append((time.perf_counter() - t0) * 1e3)
        return sorted(times)[reps // 2]

    out = {}
    with dispatch.use(prefer=dispatch.policy_from_flag("cuda-strict")):
        out["this_thread_ms"] = timed(step)
        ctx = contextvars.copy_context()
        box = {}
        worker = threading.Thread(target=lambda: box.update(ms=ctx.run(timed, step)))
        worker.start()
        worker.join()
        out["plain_thread_ms"] = box["ms"]
        ledger = L.OverheadLedger()
        sched = hsa.Scheduler(RegionManager(1, ledger=ledger), RoleLibrary(ledger=ledger),
                              ledger=ledger)
        q = sched.add_queue(hsa.Queue(None, 16, name="tf-serving"))
        sched.start()
        try:
            def routed():
                caller = contextvars.copy_context()      # the policy, for the worker thread
                pkt = q.call(lambda: caller.run(step))
                pkt.completion.wait_eq(0)
                if pkt.out.error is not None:
                    raise pkt.out.error
            out["hsa_queue_ms"] = timed(routed)
        finally:
            sched.stop()
        out["grant_mean_ms"] = ledger.stat(L.DISPATCH_GRANT).mean_us / 1e3
    return out


def tenants_phase(torch, model, params, kernels, seed: int, direct_streams: list) -> dict:
    """The paper's two tenants on one card: ``hsa_init(num_regions=2)`` on
    the card, its async scheduler (wall clock) with the worker thread
    running, and two queues.  "tf-serving": the 16 requests of the serve
    phase through a dense 8-slot ``ServeEngine`` under cuda-strict, every
    model call a call packet.  "opencl": the paper's four roles at §IV's
    shapes through the two regions — one fixed-weight int16 conv packet a
    serving step on a fresh 64x64 frame (role 3 and role 4 in turn), and
    every fourth step an FC packet: the role the planner chose for a 3-layer
    FC stack, or role 2 behind a barrier-AND on the step's conv packet.  The
    fixed-weight FC role (``matmul_fixed_weight``) runs at least once, bitwise
    equal to the generic role on the same input.  What the queue costs is
    read in turns, so that the host's drift does not pass for it: direct,
    through a queue of its own, shared with the opencl tenant, direct again.
    Checks: every run's streams equal the serve phase's dense run's; every
    role packet equals its plain version; the conv2d and f32 matmul launch
    counts equal the packets that reached them plus the loads' warm-up
    launches; the ledger holds dispatch and exec records for both queues and
    the engine's dispatch wait records for tf-serving; reconfigurations
    equal the region manager's misses; opencl packets executed between
    tf-serving packets."""
    from repro_torch import paper_roles
    from repro_torch.core import hsa, policy
    from repro_torch.core import ledger as L
    from repro_torch.core.reconfig import RegionManager
    from repro_torch.core.registry import FIXED_WEIGHT
    from repro_torch.kernels import conv2d as conv_k
    from repro_torch.kernels import matmul as mm_k

    dev = model.device
    hsa.hsa_shut_down()
    ledger = L.OverheadLedger()
    sys_ = hsa.hsa_init(num_regions=2, ledger=ledger, device=dev)
    try:
        agent = sys_.default_agent
        sched, rm = sys_.scheduler_of(agent), sys_.regions_of(agent)
        q_tf = sys_.create_queue(agent, name="tf-serving")
        q_cl = sys_.create_queue(agent, name="opencl")
        roles = paper_roles.make_paper_roles(sys_.library, seed=seed, device=dev)
        fc, (x_fc, w_fc) = roles["role1_fc"]
        fixed = paper_roles.fc_fixed_role(sys_.library, w_fc, device=dev)
        sys_.library.synthesize_all()
        synth_us = {r.name: r.synthesis_s * 1e6 for r in sys_.library}
        sched.start()

        costs = calibrate_fc(torch, sched, q_cl, {"generic": (fc, (x_fc, w_fc)),
                                                  "fixed": (fixed, (x_fc,))})
        cost = policy.CostModel(
            reconfig_s=(costs["generic"]["load_s"] + costs["fixed"]["load_s"]) / 2,
            dispatch_s=costs["dispatch_s"], exec_generic_s={"fc": costs["generic"]["exec_s"]},
            exec_fixed_s={"fc": costs["fixed"]["exec_s"]})
        plans = {}
        for n in (3, 8, 16):
            plan = policy.plan_roles([policy.Invocation("fc", i) for i in range(n)], budget=4,
                                     cost=cost)
            plans[n] = {"assignment": plan.assignment["fc"],
                        "predicted_step_s": plan.predicted.total_s,
                        "hit_rate": plan.predicted.hit_rate}
        planned = fixed if plans[3]["assignment"] == FIXED_WEIGHT else fc
        print("  " + json.dumps({"calibration": costs, "plans_budget_4": plans,
                                 "tenant_fc_role": planned.name}))

        frames = torch.Generator(device=dev)
        frames.manual_seed(seed + 4)
        conv_roles = [roles["role3_conv5x5"][0], roles["role4_conv3x3"][0]]
        opencl: list = []                  # (role, args, packet)
        waiting: list = []                 # packets the opencl producer has not waited on

        def submit(role, *args):
            pkt = q_cl.dispatch(role.key, *args, producer="opencl")
            opencl.append((role, args, pkt))
            waiting.append(pkt)
            return pkt

        def wait_opencl():
            for pkt in waiting:
                t0 = time.perf_counter()
                if not pkt.completion.wait_eq(0, timeout=120):
                    raise AssertionError(f"an opencl packet never completed: {pkt.what}")
                ledger.record(L.DISPATCH_WAIT, time.perf_counter() - t0, queue="opencl",
                              producer="opencl", what=pkt.what)
            waiting.clear()

        def before_step(step: int) -> None:
            wait_opencl()                  # last step's packets (done by now, mostly)
            if step == 0:                  # the planner's alternative runs at least once
                submit(fc, x_fc, w_fc)
                submit(fixed, x_fc)
            frame = torch.randint(-100, 100, (1, 64, 64, 1), generator=frames,
                                  device=dev).to(torch.int16)
            conv = submit(conv_roles[step % 2], frame)
            if step % 4 == 0:
                if (step // 4) % 2 == 0:
                    submit(planned, *((x_fc,) if planned is fixed else (x_fc, w_fc)))
                else:
                    q_cl.barrier([conv.completion])
                    submit(roles["role2_fc_barrier"][0], x_fc, w_fc)

        cost = call_cost(torch, model, params)
        print("  " + json.dumps({"decode_step_host_ms": cost}))
        _, prompts = serve_prompts(torch, model.cfg.vocab_size, seed)
        direct_a, direct_a_streams = serve_run(torch, model, params, kernels, prompts,
                                               batch_slots=8)
        # the queue's own cost: the same requests through a queue of their
        # own on a scheduler of their own (worker thread running), no tenant
        alone_ledger = L.OverheadLedger()
        alone_sched = hsa.Scheduler(RegionManager(2, ledger=alone_ledger), sys_.library,
                                    ledger=alone_ledger)
        q_alone = alone_sched.add_queue(hsa.Queue(agent, 256, name="tf-serving"))
        alone_sched.start()
        alone, alone_streams = serve_run(torch, model, params, kernels, prompts, batch_slots=8,
                                         hsa_queue=q_alone, hsa_scheduler=alone_sched)
        alone_sched.stop()
        print("  " + json.dumps({"run": "routed_alone", **alone,
                                 "dispatch_split": alone_ledger.dispatch_split()}))

        loads0 = {r.name: r.load_count for r in sys_.library}
        misses0, reconfig0 = rm.stats.misses, ledger.stat(L.RECONFIG).count
        conv_k.launches = mm_k.f32_launches = mm_k.fixed_launches = 0
        res, streams = serve_run(torch, model, params, kernels, prompts, before_step=before_step,
                                 batch_slots=8, hsa_queue=q_tf, hsa_scheduler=sched,
                                 ledger=ledger)
        wait_opencl()
        counts = {"conv2d": conv_k.launches, "matmul_f32": mm_k.f32_launches,
                  "matmul_fixed_weight": mm_k.fixed_launches}
        sched.stop()                       # re-raises an error that ended the worker
        direct_b, direct_b_streams = serve_run(torch, model, params, kernels, prompts,
                                               batch_slots=8)
    finally:
        hsa.hsa_shut_down()

    # -- checks ------------------------------------------------------------
    if not direct_streams == direct_a_streams == direct_b_streams == alone_streams:
        raise AssertionError("streams of the direct runs, or through a queue of their own, "
                             "differ from the serve phase's dense run")
    if streams != direct_streams:
        differ = [i for i, (a, b) in enumerate(zip(streams, direct_streams)) if a != b]
        raise AssertionError(f"streams through the HSA queue differ from the direct dense "
                             f"run in requests {differ}")
    conv_pkts = fc_pkts = fixed_pkts = 0
    outs = {}
    for role, args, pkt in opencl:
        if pkt.out.error is not None:
            raise AssertionError(f"opencl packet {pkt.what} failed") from pkt.out.error
        if role in conv_roles:
            want = conv_k.plain_conv2d(args[0], role.impl.fn.weight.to(dev))
            if not torch.equal(pkt.out.value, want):
                raise AssertionError(f"{role.name} differs from its plain version")
            conv_pkts += 1
        else:
            max_err(torch, pkt.out.value, mm_k.plain_matmul(x_fc, w_fc), TOL_ROLE_F32)
            fc_pkts += 1
            fixed_pkts += role is fixed
            outs.setdefault(role.name, pkt.out.value)
    if not torch.equal(outs[fixed.name], outs[fc.name]):
        raise AssertionError("the fixed-weight FC role differs from the generic role")
    loads = {r.name: r.load_count - loads0[r.name] for r in sys_.library}
    conv_loads = sum(loads[r.name] for r in conv_roles)
    fc_loads = sum(n for name, n in loads.items() if name not in {r.name for r in conv_roles})
    want_counts = {"conv2d": conv_pkts + conv_loads, "matmul_f32": fc_pkts + fc_loads,
                   "matmul_fixed_weight": fixed_pkts + loads[fixed.name]}
    if counts != want_counts or not all(counts.values()):
        raise AssertionError(f"paper-role launches {counts}, expected {want_counts} from "
                             f"{conv_pkts} conv and {fc_pkts} FC packets and loads {loads}")
    # the scheduler records dispatch and exec for both queues, the engine
    # dispatch_wait for its own (the opencl producer's waits are this
    # script's, recorded for the report and not checked)
    breakdown = ledger.queue_breakdown()
    for qname, cats in (("tf-serving", (L.DISPATCH, L.DISPATCH_WAIT, L.EXEC)),
                        ("opencl", (L.DISPATCH, L.EXEC))):
        have = {cat: breakdown.get(qname, {}).get(cat) for cat in cats}
        if any(st is None or st.count == 0 for st in have.values()):
            raise AssertionError(f"the ledger lacks some of {cats} records for {qname}: {have}")
    misses, reconfigs = rm.stats.misses - misses0, ledger.stat(L.RECONFIG).count - reconfig0
    if reconfigs != misses or misses == 0:
        raise AssertionError(f"{reconfigs} reconfigurations against {misses} region misses")
    log = sched.event_log()
    tf_ends = [i for i, e in enumerate(log) if e.queue == "tf-serving" and e.kind == "exec_end"]
    between = sum(1 for i, e in enumerate(log) if e.queue == "opencl" and e.kind == "exec_end"
                  and tf_ends and tf_ends[0] < i < tf_ends[-1])
    if between == 0:
        raise AssertionError("no opencl packet executed between tf-serving packets")

    report = sched.queue_report()
    per_queue = {q: {cat: {"count": st.count, "mean_us": st.mean_us}
                     for cat, st in cats.items() if st.count}
                 for q, cats in breakdown.items()}
    out = {"run": res, "routed_alone": alone, "direct_before": direct_a, "direct_after": direct_b,
           "decode_step_host_ms": cost,
           "routed_alone_dispatch_split": alone_ledger.dispatch_split(),
           "ledger_by_queue": per_queue, "plans_budget_4": plans, "calibration": costs,
           "tenant_fc_role": planned.name, "launches": counts,
           "opencl_packets": {"conv": conv_pkts, "fc": fc_pkts, "fixed_fc": fixed_pkts},
           "role_loads": loads, "opencl_exec_between_tf_packets": between,
           "queues": {q: {k: report[q][k] for k in ("wait_s", "exec_s", "reconfig_s",
                                                    "dispatched", "reconfigs")}
                      for q in ("tf-serving", "opencl")},
           "residency": dict(vars(rm.stats), hit_rate=rm.stats.hit_rate),
           "reconfig_split": ledger.reconfig_split(), "dispatch_split": ledger.dispatch_split(),
           "ledger_summary": ledger.summary(),
           "role_synthesis_us": synth_us,
           "role_load_us": {r.name: (r.load_s or 0.0) * 1e6 for r in sys_.library},
           # in the order run: direct, a queue of its own, shared, direct
           "routed_vs_direct": {
               key: (direct_a[key], alone[key], res[key], direct_b[key])
               for key in ("ttft_mean_s", "ttft_p99_s", "decode_tokens_per_s")}}
    print("  Table II on the card (ledger.table()):")
    for line in ledger.table().splitlines():
        print("    " + line)
    print("  " + json.dumps({k: out[k] for k in ("reconfig_split", "queues", "residency",
                                                 "routed_vs_direct", "role_synthesis_us",
                                                 "role_load_us", "launches", "opencl_packets",
                                                 "opencl_exec_between_tf_packets",
                                                 "ledger_by_queue")}))
    return out


def busy_phase(torch, model, params, seed: int) -> dict:
    """Where a decode step's time goes: the card's busy share over four
    decode steps of 8 live slots (device kernel time from a torch.profiler
    trace of CUDA activity, over the wall time of the steps) and the
    kernels that take it.  A trace without device events reads as not
    measured (None)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import dispatch
    from repro_torch.serve.engine import ServeEngine

    rng = torch.Generator().manual_seed(seed + 3)
    with dispatch.use(prefer=dispatch.policy_from_flag("cuda-strict")):
        eng = ServeEngine(model, params, batch_slots=8, max_len=1024, device=model.device)
        for n in (40, 90, 130, 200, 260, 300, 400, 500):
            eng.submit(torch.randint(0, model.cfg.vocab_size, (n,), generator=rng).tolist(),
                       max_new_tokens=16)
        eng.step()                    # the prefills, outside the window
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(4):
                eng.step()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    events = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in events)
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
    res = {"decode_steps": 4, "wall_us": wall_us,
           "device_busy_us": busy_us if events else None,
           "device_busy_share": busy_us / wall_us if events else None,
           "top_device_us": {e.key[:60]: e.self_device_time_total for e in top}}
    print("  " + json.dumps(res))
    return res


def prefill_busy(torch, model, params, seed: int) -> dict:
    """Where one prefill's time goes: a 600-token prompt (the 1024 bucket)
    into an idle 1-slot engine, after one such prefill as a warm-up; device
    kernel time from a torch.profiler trace of the step that prefills it
    (the prefill, its first-token fixup and one decode), the bf16 matmul
    kernels' share of it, and the step's wall time."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import dispatch
    from repro_torch.serve.engine import ServeEngine

    rng = torch.Generator().manual_seed(seed + 4)
    with dispatch.use(prefer=dispatch.policy_from_flag("cuda-strict")):
        eng = ServeEngine(model, params, batch_slots=1, max_len=1024, device=model.device)
        for rep in range(2):
            eng.submit(torch.randint(0, model.cfg.vocab_size, (600,), generator=rng).tolist(),
                       max_new_tokens=2)
            torch.cuda.synchronize()
            if rep == 0:
                while eng.step() == []:
                    pass
                continue
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                eng.step()
                torch.cuda.synchronize()
                wall_us = (time.perf_counter() - t0) * 1e6
    events = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in events)
    mm_us = sum(e.self_device_time_total for e in events
                if "mm_tile_kernel" in e.key or "mm_stream_kernel" in e.key)
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:6]
    res = {"prompt": 600, "bucket": 1024, "wall_us": wall_us,
           "device_busy_us": busy_us if events else None,
           "bf16_matmul_device_us": mm_us if events else None,
           "device_busy_share": busy_us / wall_us if events else None,
           "top_device_us": {e.key[:60]: e.self_device_time_total for e in top}}
    print("  " + json.dumps(res))
    return res


def sass_counts(native, lib: str, kernel_re: str) -> dict[str, dict[str, int]]:
    """The count of wgmma (HGMMA) and TMA load (UTMALDG) instructions in each
    instance of the kernels whose name matches ``kernel_re`` in the built
    library of ``csrc/<lib>.cu``, from ``cuobjdump --dump-sass`` (the one
    beside nvcc); raises unless every one has both."""
    path = native.build_all()[lib]
    cuobjdump = Path(native._nvcc()).parent / "cuobjdump"
    out = subprocess.run([str(cuobjdump), "--dump-sass", str(path)], capture_output=True,
                         text=True, timeout=120, check=True).stdout
    counts: dict[str, dict[str, int]] = {}
    fn = None
    for line in out.splitlines():
        if "Function :" in line:
            # _ZN..mm_tile_kernelILi128ELi256EEEv.. -> mm_tile_kernel<128,256>
            m = re.search(rf"({kernel_re})I((?:Li\d+E)+)", line)
            fn = None
            if m:
                fn = m.group(1) + "<" + ",".join(re.findall(r"Li(\d+)E", m.group(2))) + ">"
            if fn:
                counts[fn] = {"HGMMA": 0, "UTMALDG": 0}
        elif fn:
            for op in ("HGMMA", "UTMALDG"):
                counts[fn][op] += op in line
    if not counts or any(c["HGMMA"] == 0 or c["UTMALDG"] == 0 for c in counts.values()):
        raise AssertionError(f"{lib} kernels without wgmma or TMA loads: {counts}")
    return counts


def bf16_matmul_sass(native) -> dict[str, dict[str, int]]:
    """:func:`sass_counts` of the bf16 matmul's tile and streaming kernels."""
    return sass_counts(native, "matmul", r"mm_(?:tile|stream)_kernel")


def flash_sass(native) -> dict[str, dict[str, int]]:
    """:func:`sass_counts` of the flash attention kernel's instances (D = 64, 128)."""
    return sass_counts(native, "flash_attention", r"fa_kernel")


def print_runs(runs: dict, card: str, smi: str) -> None:
    for name, run in runs.items():
        held = (f"recurrent state held {run['state_bytes']} bytes" if "state_bytes" in run
                else f"KV held {run['kv_bytes']} bytes")
        print(f"  {name} on {card} ({smi}): TTFT mean {run['ttft_mean_s']} s, "
              f"p99 {run['ttft_p99_s']} s; decode {run['decode_tokens_per_s']} tokens/s; "
              f"peak memory {run['max_memory_allocated_bytes']} bytes; {held}; "
              f"peak concurrency {run['peak_concurrency']}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=Path, default=None, help="write every measurement here")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs one NVIDIA GPU", file=sys.stderr)
        return 2
    from repro_torch.configs import get_arch
    from repro_torch.kernels import conv2d as conv_k
    from repro_torch.kernels import decode_attention as dec_k
    from repro_torch.kernels import flash_attention as fa_k
    from repro_torch.kernels import matmul as mm_k
    from repro_torch.kernels import native
    from repro_torch.kernels import paged_decode_attention as paged_k
    from repro_torch.kernels import rmsnorm as rms_k
    from repro_torch.kernels import ssd as ssd_k
    from repro_torch.models import build_model, init_params

    kernels = (mm_k, rms_k, fa_k, dec_k, paged_k, ssd_k)
    t_start = time.perf_counter()
    smi = nvidia_smi()
    card = torch.cuda.get_device_name(0)
    print(f"[1/8] device: {smi} | torch.cuda.get_device_name(0) = {card} | "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t = time.perf_counter()
    native.build_all()
    print(f"  built {len(native.SOURCES)} sources ({len(kernels) + 3} kernels: the f32 matmul, "
          f"the matmul edge kernel and conv2d beside these six) in "
          f"{time.perf_counter() - t:.1f} s"
          + ("" if native.build_logs() else " (found built under build/: no ptxas report)"))
    for name, log in native.build_logs().items():
        for line in log.splitlines():
            if "Used" in line or "spill" in line or "Compiling entry" in line:
                print(f"  {name}: {line.strip()}")
    sass = {"matmul": bf16_matmul_sass(native), "flash_attention": flash_sass(native)}
    for lib, fns in sass.items():
        for fn, counts in fns.items():
            print(f"  {lib} SASS {fn}: {counts['HGMMA']} HGMMA, {counts['UTMALDG']} UTMALDG")

    print(f"[2/8] kernels against their plain versions, on {card} ({smi})")
    rows, errs = kernel_phase(torch, args.seed)

    print("[3/8] model: llama3.2-1b prefill, fixup and decode, cuda-strict vs the torch "
          "source; chunked vs whole-prompt prefill")
    model = build_model(get_arch("llama3.2-1b"))
    params = init_params(model.param_specs(), args.seed)
    model_res = model_phase(torch, model, params, args.seed)

    print("[4/8] serve: 16 greedy requests, max_len 1024, cuda-strict: dense 8 slots; "
          "paged 8 slots; paged + chunked prefill 16 slots in the same KV memory")
    serve_res = serve_phase(torch, model, params, kernels, args.seed)
    print_runs(serve_res["runs"], card, smi)
    print(f"  paged streams equal dense: 16 of 16; chunked streams equal dense: "
          f"{serve_res['chunked_streams_equal_dense']}")
    print("  where a decode step's time goes (torch.profiler, CUDA activity):")
    busy_res = busy_phase(torch, model, params, args.seed)
    print("  where a 1024-bucket prefill's time goes (torch.profiler, CUDA activity):")
    prefill_res = prefill_busy(torch, model, params, args.seed)

    print("[5/8] tenants: hsa_init(num_regions=2) on the card, the async scheduler's worker "
          "thread; tf-serving: the 16 requests through a dense 8-slot engine; opencl: the "
          "paper's four roles through two regions")
    tenants_res = tenants_phase(torch, model, params, kernels, args.seed,
                                serve_res.pop("dense_streams"))
    print_runs({"tenants_routed": tenants_res["run"]}, card, smi)
    del model, params
    torch.cuda.empty_cache()

    print(f"[6/8] model: granite-3-8b at full width, {GRANITE_DEPTH} layers (head_dim 128, "
          f"untied unembed N = 49155): prefill, fixup, decode dense and paged, chunked "
          f"staging and paged, cuda-strict vs the torch source")
    model = build_model(dataclasses.replace(get_arch("granite-3-8b"), num_layers=GRANITE_DEPTH))
    params = init_params(model.param_specs(), args.seed)
    granite_res = granite_phase(torch, model, params, kernels, args.seed)
    del model, params
    torch.cuda.empty_cache()

    print("[7/8] model: mamba2-780m prefill at the prompt's length and batched decode, "
          "cuda-strict vs the torch source")
    model = build_model(get_arch("mamba2-780m"))
    params = init_params(model.param_specs(), args.seed)
    ssm_model_res = ssm_model_phase(torch, model, params, args.seed)

    print("[8/8] serve: mamba2-780m, the same 16 prompt lengths, 8 slots, cuda-strict")
    ssm_res = ssm_serve_phase(torch, model, params, kernels, args.seed)
    print_runs(ssm_res["runs"], card, smi)
    print("  where a decode step's time goes (torch.profiler, CUDA activity):")
    ssm_busy_res = busy_phase(torch, model, params, args.seed)

    runs = {**serve_res["runs"], "tenants": tenants_res["run"], **ssm_res["runs"],
            "granite": {"launches": granite_res["launches"]}}
    headline = {"matmul": "[8,2048]x[2048,8192] act=None out=bfloat16",
                "rmsnorm": "[8,2048]",
                "flash_attention": "q[1,32,512,64] kv[1,8,512,64] causal=True",
                "decode_attention": "q[8,32,64] cache[8,8,1024,64] lengths 1..1024",
                "paged_decode_attention": "q[8,32,64] pool[513,8,16,64] table[8,64] lengths "
                                          "[1, 1024, 5, 600, 37, 256, 900, 64]",
                "ssd": "x[1,600,48,64] b,c[1,600,1,128]",
                "matmul_f32": "[256,256]x[256,256] act=None f32",
                "matmul_fixed_weight": "[256,256]x[256,256] fixed f32",
                "conv2d": "x[1,64,64,1] w[5,5,1,1] int16",
                "matmul_edge": "[8,4096]x[4096,49155] act=None out=float32"}
    # the rows beside each headline: the bf16 matmul's prefill, flash
    # attention's other timed rows at D = 64 and its D = 128 rows, the
    # decode kernels at D = 128, the other unembeds
    beside = {"matmul": ["[1024,2048]x[2048,8192] act=None out=bfloat16"],
              "flash_attention": [f"q[1,32,{S},{D}] kv[1,8,{T},{D}] causal={c}"
                                  for D in fa_k.HEAD_DIMS
                                  for S, T, c in ((512, 512, True), (512, 512, False),
                                                  (128, 1024, True), (1024, 1024, True))
                                  if (D, S, T, c) != (64, 512, 512, True)],
              "decode_attention": ["q[8,32,128] cache[8,4,1024,128] lengths 1..1024"],
              "paged_decode_attention": ["q[8,32,128] pool[513,4,16,128] table[8,64] lengths "
                                         "[1, 1024, 5, 600, 37, 256, 900, 64]"],
              "matmul_edge": [f"[{M},{K}]x[{K},{N}] act=None out=float32"
                              for M, K, N in UNEMBEDS[1:]]
                             + ["[8,4096]x[4096,49155] act=None f32"]}
    library = {"matmul": "torch.matmul", "rmsnorm": "F.rms_norm",
               "flash_attention": "F.scaled_dot_product_attention",
               "decode_attention": "F.scaled_dot_product_attention",
               "paged_decode_attention": "two calls: an index gather of the pages into a "
                                         "dense copy, then F.scaled_dot_product_attention",
               "ssd": "no single PyTorch call computes it",
               "matmul_f32": "torch.matmul, f32 with TF32 off",
               "matmul_fixed_weight": "torch.matmul, f32 with TF32 off",
               "conv2d": "none for int16 (F.conv2d, f32 and TF32 off, at the f32 shapes)",
               "matmul_edge": "torch.matmul (bf16 out; f32 with TF32 off at the f32 row)"}
    # the paper-role kernels run on the tenants phase's main path only, the
    # edge kernel on the granite phase's
    entries = [(mod.__name__.rsplit(".", 1)[1], mod, mod.REPLACES,
                {run: r["launches"][mod.__name__.rsplit(".", 1)[1]] for run, r in runs.items()})
               for mod in kernels]
    entries += [(name, mod, replaces, {"tenants": tenants_res["launches"][name]})
                for name, mod, replaces in (("matmul_f32", mm_k, mm_k.REPLACES),
                                            ("matmul_fixed_weight", mm_k, mm_k.REPLACES_FIXED),
                                            ("conv2d", conv_k, conv_k.REPLACES))]
    entries += [("matmul_edge", mm_k, mm_k.REPLACES,
                 {"granite": granite_res["launches"]["matmul_edge"]})]
    timing = ("shape", "ms", "host_ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    summary = []
    for name, mod, replaces, by_run in entries:
        row = next(r for r in rows if r["name"] == name and r["shape"] == headline[name])
        # the errors of the headline row's tolerance; those of the kernel's
        # other tolerances beside them
        others = [e for tol, e in errs[name].items() if tol != row["tolerance"]]
        more = [{k: r[k] for k in timing} for shape in beside.get(name, ())
                for r in rows if r["name"] == name and r["shape"] == shape]
        summary.append({
            "name": name, "route": mod.ROUTE, "source": mod.SOURCE, "replaces": replaces,
            "launches": sum(by_run.values()), "launches_by_run": by_run,
            **errs[name][row["tolerance"]],
            **({"errors_at_other_tolerances": others} if others else {}),
            "shape": row["shape"], "ms": row["ms"],
            "kernel_ms": row["ms"], "host_ms": row["host_ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"], "library": library[name],
            **({"other_rows": more} if more else {}),
            **({"sass": sass[name]} if name in sass else {}),
        })
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({
            "card": card, "nvidia_smi": smi, "torch": torch.__version__, "seed": args.seed,
            "kernel_rows": rows, "sass": sass, "model": model_res, "serve": serve_res,
            "busy": busy_res, "prefill_busy": prefill_res,
            "tenants": tenants_res, "granite": granite_res,
            "ssm_model": ssm_model_res, "ssm_serve": ssm_res, "ssm_busy": ssm_busy_res,
            "summary": summary,
            "total_s": time.perf_counter() - t_start}, indent=1))
    print(f"  total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": summary}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
