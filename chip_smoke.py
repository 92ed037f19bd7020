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
   ``src/repro_torch/csrc`` (seven sources, twelve kernels) and print what
   ptxas reports for each, and the wgmma (HGMMA) and TMA (UTMALDG)
   instructions in each bf16 matmul kernel and each flash attention
   instance, wgmma in the f32 (3xTF32) kernel, and mma.sync (HMMA) in the
   bf16 edge and f32 streaming kernels for M <= 16, with TMA loads in their
   TMA instances, and in every decode attention instance and the ssd
   kernel (``cuobjdump``; none fails).
2. kernels: first the per-launch floor (``torch.cuda._sleep(0)`` timed back
   to back, the least a launch takes), then each kernel against its plain
   PyTorch version at the shapes the
   serving paths and the paper's roles give it, the attention kernels at
   head_dim 64 and 128 (flash also split over 2-4 blocks a tile, under a
   window, ragged) and 96, within the tolerance stated below (attention
   row by row, ssd per row and per head's state, conv2d and the f32 matmul
   exactly or within 2e-4, the bf16 matmul within 2e-2, each beside what a
   planted fault reads by the same measure; rmsnorm in bf16, f16 and f32,
   at an odd D, and bitwise row-invariant (a row's output the same in a
   launch of 1, 3, 8, 128 or 600 rows and under a permutation); the bf16
   matmul bitwise row-invariant too, at every (K, N) a served prefill runs
   (a row's bits the same in a launch of 1, 3, 8, 16, 17, 128 or 1024
   rows, streaming kernel or tile, and under a permutation), and flash
   attention's chunked rows bitwise the whole prompt's (16- and 128-row
   chunks at 0, 16, 128 and 512 of a 1024-row prompt, at every split); the
   matmul edge kernels at the untied unembeds' shapes, N not a multiple of
   8, at M = 1, 8 and 16, and at M = 17 and 64, w off a 16-byte boundary
   and K not a multiple of 8, so that every instance of the matmul kernels
   built is held against the plain version: each row names the instance it
   ran, and a built instance that no row ran fails the phase, as does a
   built decode attention instance or the ssd kernel; the decode kernels
   also at every key-range split count their rule picks at the served
   shapes, and ssd at two sequences and two groups); timed with
   CUDA events beside its plain version and one PyTorch library call where
   there is one (for paged attention, which no one call computes, a gather
   and SDPA; for ssd and int16 conv2d none), the earlier kernel where it is
   still built (the mma.sync edge kernel that M <= 16 used before the
   streaming one), and its bound (the larger of bytes / 3.35 TB/s and
   operations / peak rate; the f32 kernels' (the f32 matmul's, ssd's)
   f32 products as three TF32 products at the TF32 rate, the f32 rate's
   beside it).  The
   paged kernel must also equal the dense kernel on the gathered cache bit
   for bit, and the fixed-weight roles (``matmul_fixed_weight``,
   ``conv2d_fixed_weight``) their generic kernels.  The sampler (``sample``,
   JAX's position-indexed categorical draw) at every [B, V] the sampled
   serve runs give it ([1, 128256], [8, 128256], [16, 128256], [1, 50280],
   [8, 50280]) and at granite's [8, 49155]: its random bits exactly the
   plain version's and a numpy Threefry's (a key word flipped moves them
   all), its tokens the plain version's wherever the two best scores lie
   more than 4 ulps apart; its bound its integer operations.  After the
   serve runs, every [B, V] a sampled run gave it, and every split count
   its rule picks there, must have run in one of these rows.
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
   requests at once and whose streams must equal the dense ones, all 16.  Every kernel's launch count is read from each run
   alone (counts set to 0 just before it) and checked against the model
   calls the engine made.  Decode steps run as replays of one captured CUDA
   graph; a replay counts the captured step's launches.  Then the card's
   busy share over four dense decode steps (with decode attention's device
   time a step), and over one step that prefills a 600-token prompt (the
   1024 bucket) with the bf16 matmul kernels' part, from torch.profiler
   traces.  Then graph against loop: the dense run again, as graph replays
   and as the eager loop in turns (graph, loop, graph, loop), streams equal
   to the first dense run's, with decode tokens/s, TTFT and the busy share
   of four decode steps at T = 0.7 for each arm (the trace must list every
   decode-path kernel, the sampler's too, as often as the counters moved);
   the paged and chunked runs as the loop, streams equal to the graphs'.
   Then temperature 0.7, seed 3: dense and paged at K 1 and 4, graph and
   loop, a ``FusionPolicy(max_fusion=8)`` run, and chunked at K 4, graph
   and loop: every stream equal.
5. tenants: ``hsa_init(num_regions=2)`` on the card and its async
   scheduler's worker thread; the "tf-serving" queue carries the 16
   requests through a dense 8-slot engine (streams must equal phase 4's
   dense run), the "opencl" queue the paper's four roles at §IV's shapes
   (fixed-weight int16 conv frames, the FC roles, one behind a barrier-AND,
   and the role the planner picks from FC costs measured on the card).
   Prints Table II from the ledger, the reconfiguration split, per-queue
   wait, exec and reconfiguration, residency, and TTFT and decode tokens/s
   routed beside direct; checks every role packet against its plain
   version and the launch counts against the packets, and that the routed
   engines' decode graphs were captured on the scheduler's worker thread.
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
   decode step, no fixups); then its busy share over four decode steps,
   and one 600-token prompt's prefill into an idle engine by kernel (the
   ssd kernel's part); graph against loop as for llama; and T = 0.7 at K 4,
   graph equal to loop.
9. traffic, llama3.2-1b again, from ``--seed`` (Table IX's trace arm,
   ``repro_torch.bench.table9_traffic``): the poisson, bursty and
   longtail traces through a 6-slot engine at K 4, chunked (16-row
   chunks) and whole, on a virtual
   clock: every row (TTFT and TPOT p50/p99, makespan, throughput,
   requests) must equal the JAX package's, and every chunked stream its
   whole stream; a tapered ``ChunkPolicy`` (16 to 64 rows) on the bursty
   trace, streams equal to whole; then the bursty trace on the wall clock,
   chunked and whole in turns, its TTFT, TPOT and tokens/s printed,
   and where its wall time went (steps that prefilled, steps that only
   decoded).

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
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_S = 3.35e12          # H100 SXM device memory
BF16_TC_FLOPS = 989e12         # H100 SXM dense bf16 tensor cores
TF32_TC_FLOPS = 495e12         # H100 SXM dense tf32 tensor cores
F32_FLOPS = 67e12              # H100 SXM f32 outside the tensor cores
# int32 multiply-adds on the CUDA cores: an SM has 64 INT32 lanes against 128
# FP32 lanes (NVIDIA's Hopper architecture white paper), so half the f32 rate
INT32_OPS = F32_FLOPS / 2
# int32 adds, xors and shifts: one a lane a clock, half the multiply-add count
INT32_LANE_OPS = INT32_OPS / 2
# the sampler's integer operations an element: Threefry-2x32's 20 rounds of
# an add, a rotate and a xor, its 2 + 5 x 2 key additions, and the uniform's
# xor, shift and or (the two logs and the division not counted)
SAMPLE_INT_OPS = 2 + 20 * 3 + 5 * 2 + 3
# the sampler's shapes: every shape the sampled serve runs give it (a decode
# step of 8 slots (dense, paged) and of 16 (chunked) over llama's
# vocabulary, Mamba-2's step of 8, and the first token of each, one slot);
# then granite's vocabulary, a width not a multiple of the block's (granite
# is never sampled)
SAMPLE_SHAPES = ((8, 128256), (1, 128256), (16, 128256), (8, 50280), (1, 50280), (8, 49155))
# the sampler against its plain version: the random bits exactly (and a
# numpy Threefry's), the token wherever the two best scores lie more than
# this many ulps apart (the kernel's logf and PyTorch's may part by an ulp)
SAMPLE_TIE_ULPS = 4
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
# a multiple of 8: granite-3-8b, hymba-1.5b, whisper large-v3; the kernel
# phase also runs them at the first-token fixup's M = 1 and 16 slots' M = 16
UNEMBEDS = ((8, 4096, 49155), (8, 1600, 32001), (8, 1280, 51866))
EDGE_ROWS = (1, 8, 16)
# the edge rows that reach the other edge instances: M above the streaming
# kernels' 16 (a 17-row and a 64-row batch), and a K that is not a multiple
# of 8 with 63 values in its last 64-deep slice (the planted fault drops them)
EDGE_TILE_ROWS = (17, 64)
EDGE_RAGGED_K = 1599
# granite-3-8b at full width, cut to this many layers (about 1.6 GB of bf16
# weights from --seed): every head_dim 128 kernel and the edge matmul of its
# untied [4096, 49155] unembed on the path a server runs
GRANITE_DEPTH = 2
# the granite phase's 8 prompt lengths (buckets 8 .. 512); the kernel phase
# holds decode and paged attention against their plain versions at them too
GRANITE_LENGTHS = (5, 45, 130, 260, 300, 400, 470, 500)
# the decode attention instances no served config runs (llama and granite
# take 64 and 128, and 96 has timed rows): held against the plain versions
# untimed, so that every instance built runs in some row
OTHER_HEAD_DIMS = (16, 32, 48, 80, 112)


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


def launch_floor_ms(torch, iters: int = 200) -> float:
    """Device ms of one launch of ``torch.cuda._sleep(0)`` (a kernel that
    does nothing), timed back to back like a kernel row: the least any
    launch takes on this card, which a decode-size row is read against."""
    return time_ms(torch, lambda: torch.cuda._sleep(0), [()], iters=iters)[0]


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


def ssd_kernel_work(S: int, B: int = 1, H: int = 48, P: int = 64, N: int = 128,
                    q: int = 64) -> int:
    """The tensor-core flops the chunk-parallel ssd kernel issues (bf16
    mma.sync, f32 sums), per head and chunk of q rows whose t 16-row tiles
    hold rows inside S: C·Bᵀ and its decayed product with x over the
    t(t + 1)/2 causal tile pairs, the product in two bf16 passes; the
    carry's xᵀ(wB) in two passes over 16t rows; C·hᵀ in two passes in every
    chunk after the first.  Heads share no product, so the group count does
    not enter."""
    flops = 0
    for s0 in range(0, S, q):
        t = -(-min(q, S - s0) // 16)
        flops += t * (t + 1) // 2 * 2 * 16 * 16 * (N + 2 * P) + 2 * 2 * 16 * t * N * P
        if s0 > 0:
            flops += 2 * 2 * 16 * t * N * P
    return B * H * flops


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


ROW_INVARIANCE_ROWS = (1, 3, 8, 128)
#: the bf16 matmul's launches held to a 1024-row launch: a fixup, a decode
#: step of 8 slots and of 16 (the streaming kernel), the tile kernel's
#: smallest launch, a 128-row chunk
MATMUL_INVARIANCE_ROWS = (1, 3, 8, 16, 17, 128)
#: the (K, N) pairs the served prefills run: llama3.2-1b's four weights,
#: mamba2-780m's two
MATMUL_SERVED_KN = ((2048, 2048), (2048, 512), (2048, 8192), (8192, 2048), (1536, 6448),
                    (3072, 1536))
#: where the chunks start, and their rows, that flash attention's rows are
#: held at against a 1024-row prompt's
FLASH_CHUNK_STARTS = (0, 16, 128, 512)
FLASH_CHUNK_ROWS = (16, 128)


def row_invariance(torch, fn, x, w, perm, rows=ROW_INVARIANCE_ROWS) -> dict:
    """Hold a row-wise kernel ``fn(x, w)`` to its own output on all of x's
    rows: the rows of a launch of x[:k] for k in ``rows``, and of a launch
    of x[perm], must be bitwise the full launch's rows (raises otherwise)."""
    full = fn(x, w)
    for k in rows:
        if not torch.equal(fn(x[:k], w), full[:k]):
            raise AssertionError(f"the rows of a {k}-row launch differ from the same rows of "
                                 f"a {x.shape[0]}-row launch")
    if not torch.equal(fn(x[perm], w), full[perm]):
        raise AssertionError("a permutation of the rows does not permute the output bitwise")
    return {"D": x.shape[-1], "rows": x.shape[0], "launch_rows": list(rows), "permuted": True}


def flash_chunk_invariance(torch, flash, q, k, v, splits) -> dict:
    """Hold flash attention's chunked rows to the whole prompt's: the
    queries of a chunk of each of FLASH_CHUNK_ROWS rows at each of
    FLASH_CHUNK_STARTS, against the keys up to the chunk's end, at the
    split rule's pick (None) and at each of ``splits``, must be bitwise the
    rows of one causal launch over all of q (raises otherwise)."""
    whole = flash(q, k, v, causal=True)
    for start in FLASH_CHUNK_STARTS:
        for size in FLASH_CHUNK_ROWS:
            end = start + size
            qc = q[:, :, start:end].contiguous()
            kc, vc = k[:, :, :end].contiguous(), v[:, :, :end].contiguous()
            for s in (None, *splits):
                if not torch.equal(flash(qc, kc, vc, causal=True, splits=s),
                                   whole[:, :, start:end]):
                    raise AssertionError(f"a {size}-row chunk at {start} (splits {s}) differs "
                                         f"from the whole prompt's rows")
    return {"D": q.shape[-1], "rows": q.shape[2], "chunk_starts": list(FLASH_CHUNK_STARTS),
            "chunk_rows": list(FLASH_CHUNK_ROWS), "splits": ["rule", *splits]}


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
    floor = launch_floor_ms(torch)
    rows.append({"name": "launch_floor", "shape": "torch.cuda._sleep(0)", "ms": floor})
    print(f"  per-launch floor: {floor} ms a launch of torch.cuda._sleep(0), back to back "
          f"(CUDA events)")

    def record(name, shape, check, sets, kernel, plain, library, bytes_, flops, peak,
               previous=None, f32_rate_flops=None, instance=None):
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
        # a matmul row names the CUDA kernel instance it ran
        row = {"name": name, "shape": shape, **({"instance": instance} if instance else {}),
               **check}
        if sets is not None:
            row["ms"], row["host_ms"] = time_ms(torch, kernel, sets)
            row["plain_ms"] = time_ms(torch, plain, sets)[0]
            row["library_ms"] = time_ms(torch, library, sets)[0] if library else None
            row["bound_ms"], row["bound_by"] = bound(bytes_, flops, peak)
            if previous is not None:  # the earlier kernel for these shapes, same inputs
                row["previous_ms"] = time_ms(torch, previous, sets)[0]
            if f32_rate_flops is not None:  # the f32 product at the CUDA cores' rate
                row["bound_f32_rate_ms"] = bound(bytes_, f32_rate_flops, F32_FLOPS)[0]
            if name == "ssd":  # the flops the kernel issues (its bf16 passes)
                row["bound_kernel_tc_ms"] = bound(bytes_, check["kernel_flops"],
                                                  BF16_TC_FLOPS)[0]
        rows.append(row)
        print("  " + json.dumps(row))

    # the bf16 matmul's row invariance first: a row of x gives the same bits
    # in a launch of 1, 3, 8, 16 or 17 rows (the streaming kernel, the tile
    # kernel's smallest launch) or 128 (a chunk), or moved by a permutation,
    # as in a 1024-row launch (the largest bucket), at every (K, N) a served
    # prefill runs, with and without the silu epilogue: each row's K is
    # summed in groups(N, K)'s order whatever the kernel, block or split, so
    # chunked and whole-prompt prefill cannot part here
    mm_invariance = []
    for K, N in MATMUL_SERVED_KN:
        x, w = randn((1024, K)), randn((K, N), K ** -0.5)
        perm = torch.randperm(1024, generator=gen, device=dev)
        for act in (None, "silu"):
            res = row_invariance(torch, lambda a, b, act=act: mm_k.matmul(a, b, activation=act),
                                 x, w, perm, rows=MATMUL_INVARIANCE_ROWS)
        mm_invariance.append({**res, "N": N, "groups": list(mm_k.groups(N, K)),
                              "activations": [None, "silu"]})
        del x, w
    print(f"  matmul row invariance holds: {mm_invariance}")

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
                    if (M, K, N, act, out) == (8, 2048, 8192, None, torch.bfloat16):
                        check["row_invariant"] = mm_invariance
                    timed = out == torch.bfloat16 and (act is None or N == 8192)
                    record(
                        "matmul", f"[{M},{K}]x[{K},{N}] act={act} out={str(out)[6:]}", check,
                        sets if timed else None,
                        lambda a, b, act=act: mm_k.matmul(a, b, activation=act),
                        lambda a, b, act=act: mm_k.plain_matmul(a, b, activation=act),
                        (lambda a, b: torch.matmul(a, b)) if act is None else None,
                        2 * (M * K + K * N + M * N), 2 * M * N * K, BF16_TC_FLOPS,
                        instance=mm_k.kernel_instance(x, w))
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
                   torch.matmul, 2 * (M * K + K * N + M * N), 2 * M * N * K, BF16_TC_FLOPS,
                   instance=mm_k.kernel_instance(x, w))
            del sets, x, w

    # rmsnorm's row invariance first: a row normalised in a launch of 1, 3, 8
    # or 128 rows, or moved by a permutation, is bitwise the row of a 600-row
    # launch (chunked and whole-prompt prefill must not part); at llama's
    # width, mamba2's and an odd one (rows off 16-byte boundaries)
    invariance = []
    for D in (2048, 1536, 1000):
        x, w = randn((600, D)), randn((D,))
        perm = torch.randperm(600, generator=gen, device=dev)
        invariance.append(row_invariance(torch, rms_k.rmsnorm, x, w, perm))
    print(f"  rmsnorm row invariance holds: {invariance}")

    # rmsnorm: fixup, decode, chunk and prefill rows at llama's d_model 2048;
    # mamba2's ln1 and ln_f (1536) and gated norm (3072) at its row counts;
    # granite's and yi's 4096 at a decode step and a prefill bucket; f16 and
    # an odd D (the ragged last chunk: 1000 is not a multiple of 8) at llama's
    # decode rows
    widths = [(R, 2048, torch.bfloat16) for R in rows_used]
    widths += [(R, D, torch.bfloat16) for D in (1536, 3072) for R in (3, 5, 8, 37, 600)]
    widths += [(8, 4096, torch.bfloat16), (512, 4096, torch.bfloat16),
               (8, 2048, torch.float16), (8, 1000, torch.bfloat16)]
    for R, D, dt in widths:
        sets = [(randn((R, D)).to(dt), randn((D,)).to(dt)) for _ in range(n_sets(4 * R * D))]
        check = max_err(torch, rms_k.rmsnorm(*sets[0]), rms_k.plain_rmsnorm(*sets[0]), TOL_BF16)
        if (R, D, dt) == (8, 2048, torch.bfloat16):
            check["row_invariant"] = invariance
        timed = D not in (1536, 3072) or R in (8, 600)
        record("rmsnorm", f"[{R},{D}]" + ("" if dt == torch.bfloat16 else f" {str(dt)[6:]}"),
               check, sets if timed else None, rms_k.rmsnorm, rms_k.plain_rmsnorm,
               lambda x, w: F.rms_norm(x, (x.shape[-1],), w, 1e-6),
               2 * (2 * R * D + D), 4 * R * D, F32_FLOPS)

    # rmsnorm in f32 (the Pallas kernel takes any dtype) at llama's decode
    # rows, within the f32 tolerance of the JAX package's own test
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
    # ragged 200.  And D = 96 (a head_dim the D = 128 instance takes, its
    # columns past 96 read as zeros) at causal 512, a chunk and ragged 200.
    # The planted fault is read in the rows that see all 64 of its keys
    # (none under the window).
    # flash attention's chunk invariance first: a chunk's queries (16 or
    # 128 rows at 0, 16, 128 and 512) against the keys up to its end give
    # the rows of one causal launch over the 1024-row prompt bitwise, at the
    # split rule's pick and at every split 1-4: a row's keys are folded in
    # key groups fixed by the key index alone
    fa_invariance = []
    for D in (64, 128):
        q, k, v = randn((1, 32, 1024, D)), randn((1, 8, 1024, D)), randn((1, 8, 1024, D))
        fa_invariance.append(flash_chunk_invariance(torch, fa_k.flash_attention, q, k, v,
                                                    tuple(range(1, fa_k.MAX_SPLITS + 1))))
        del q, k, v
    print(f"  flash attention chunk invariance holds: {fa_invariance}")

    buckets = [(S, S, True, None) for S in (8, 64, 128, 256, 512, 1024)]
    buckets += [(512, 512, False, None)]
    chunks = [(128, T, True, None) for T in range(256, 1025, 128)]
    chunks += [(16, 256, True, None), (64, 256, True, None)]  # the traffic phase's chunks
    others = [(256, 256, True, 48), (200, 200, True, None)]
    every = buckets + chunks + others
    d96 = [(512, 512, True, None), (128, 1024, True, None), (200, 200, True, None)]
    for D, flash_cases in ((64, every), (128, every), (96, d96)):
        for S, T, causal, window in flash_cases:
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
            if (S, T, causal, window, D) == (512, 512, True, None, 64):
                check["row_invariant"] = fa_invariance
            timed = ((S, T) in ((512, 512), (1024, 1024), (128, 1024)) and window is None
                     and (D != 96 or (S, T, causal) == (512, 512, True)))
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
    # 32-key tile; n = 300, 400 and 600 for the split counts 3, 4 and 5 that
    # the serve runs' fixups reach); at D = 64 with llama's 8 kv heads, at D =
    # 128 with yi's 4 (a group of 8 query heads) and with granite's 8 (a
    # group of 4) at the granite phase's shapes: its decode step of 8 slots
    # against a 512-row cache (each prompt's length plus the new token) and
    # fixups; at D = 96 with 8 kv heads; the traffic phase's decode step (6
    # slots against 256 rows); and every other instance (D = 16, 32, 48, 80,
    # 112) at the 8 slots, untimed.
    slots = torch.tensor([1, 1024, 5, 600, 37, 256, 900, 64], dtype=torch.int32, device=dev)
    traffic = torch.tensor([1, 256, 5, 100, 37, 232], dtype=torch.int32, device=dev)
    granite = torch.tensor([n + 1 for n in GRANITE_LENGTHS], dtype=torch.int32, device=dev)
    cases = []
    for D, hkv, lengths, T, fixups in ((64, 8, slots, 1024, (5, 45, 300, 400, 600)),
                                       (128, 4, slots, 1024, (5, 45, 600)),
                                       (128, 8, granite, 512, (5, 45, 500)),
                                       (96, 8, slots, 1024, (5, 45)),
                                       (64, 8, traffic, 256, ()),
                                       *((D, 8, slots, 1024, ()) for D in OTHER_HEAD_DIMS)):
        B = lengths.numel()
        cases += [(lengths, T, D, hkv, f"q[{B},32,{D}] cache[{B},{hkv},{T},{D}] lengths "
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
        check["splits"] = dec_k.last_splits
        n_keys = int(lengths.sum())
        record("decode_attention", shape, check,
               sets if T in (1024, 600) and D not in OTHER_HEAD_DIMS else None,
               lambda q, kc, vc, q4, ke, ve, n=lengths: dec_k.decode_attention(q, kc, vc, n),
               lambda q, kc, vc, q4, ke, ve, n=lengths: dec_k.plain_decode_attention(q, kc, vc, n),
               lambda q, kc, vc, q4, ke, ve, m=valid: F.scaled_dot_product_attention(
                   q4, ke, ve, attn_mask=m[:, None, None, :]),
               2 * (2 * B * 32 * D + 2 * hkv * n_keys * D), 4 * 32 * D * n_keys, BF16_TC_FLOPS,
               instance=f"dec_kernel<{D},DenseRows>")
        del sets, q, kc, vc, fault

    # decode attention's batch invariance: a sequence's output bits are the
    # same in a launch of 16 sequences (the chunked run's decode step), of 8
    # (the dense run's) and alone (a fixup's rows): the split follows the
    # cache's rows, never the batch
    q, kc, vc = randn((16, 32, 64)), randn((16, 8, 1024, 64)), randn((16, 8, 1024, 64))
    lengths = torch.tensor([1 + (67 * i) % 1024 for i in range(16)], dtype=torch.int32,
                           device=dev)
    full = dec_k.decode_attention(q, kc, vc, lengths)
    for n in (8, 1):
        if not torch.equal(dec_k.decode_attention(q[:n], kc[:n], vc[:n], lengths[:n]), full[:n]):
            raise AssertionError(f"decode attention: a {n}-sequence launch's rows differ from "
                                 f"a 16-sequence launch's")
    dec_invariance = {"D": 64, "T": 1024, "launch_sequences": [16, 8, 1],
                      "splits": dec_k.split_kv(1024)}
    print(f"  decode attention batch invariance holds: {dec_invariance}")
    next(r for r in rows if r["name"] == "decode_attention"
         and r["shape"] == "q[8,32,64] cache[8,8,1024,64] lengths 1..1024")[
             "row_invariant"] = dec_invariance
    del q, kc, vc, full

    # paged decode attention: the 8-slot decode step against a pool of
    # 16-row pages through a shuffled table (table width 1024 / 16, the
    # dense engine's memory plus the scratch page), the same with 64-row
    # pages, the chunked run's 16 slots, and one sequence against a
    # 600-row cache; at D = 128 (yi's 4 kv heads) the 8 slots with 16- and
    # 64-row pages, and the granite phase's paged step (8 kv heads, a pool
    # of 16-row pages behind a table 512 / 16 wide); at D = 96 the 8 slots
    # with 16-row pages, and every other instance untimed.  The planted fault
    # remaps one whole page inside each sequence's length to another
    # sequence's page.
    paged_cases = [(slots, 16, 64, 64, 8), (slots, 64, 16, 64, 8),
                   (slots.repeat(2), 16, 64, 64, 8),
                   (torch.tensor([600], dtype=torch.int32, device=dev), 16, 38, 64, 8),
                   (slots, 16, 64, 128, 4), (slots, 64, 16, 128, 4),
                   (granite, 16, 32, 128, 8), (slots, 16, 64, 96, 8),
                   *((slots, 16, 64, D, 8) for D in OTHER_HEAD_DIMS)]
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
        splits = paged_k.last_splits
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
        check["splits"] = splits

        def library(q, kp, vp, table, q4, kvp, tl, m=valid, B=B, T=NP * ps, D=D):
            kv = kvp[:, tl].view(2, B, T, 32, D).transpose(2, 3)
            return F.scaled_dot_product_attention(q4, kv[0], kv[1], attn_mask=m[:, None, None, :])

        record("paged_decode_attention", shape, check,
               sets if ps == 16 and NP == 64 and D not in OTHER_HEAD_DIMS else None,
               lambda q, kp, vp, t, q4, kvp, tl, n=lengths:
                   paged_k.paged_decode_attention(q, kp, vp, t, n),
               lambda q, kp, vp, t, q4, kvp, tl, n=lengths:
                   paged_k.plain_paged_decode_attention(q, kp, vp, t, n),
               library,
               2 * (2 * B * 32 * D + 2 * hkv * n_keys * D) + 4 * (B * NP + B),
               4 * 32 * D * n_keys, BF16_TC_FLOPS, instance=f"dec_kernel<{D},PagedRows>")
        del sets, q, kp, vp, table, fault, got, dense

    # ssd at the Mamba-2 serving shapes (H 48, P 64, N 128, G 1): a prompt
    # within one chunk, one row past the kernel's chunk, one chunk of the
    # config (256), the longest prompt of the serve run (600, ragged), and
    # max_len (1024); and two sequences of two groups.  The bound's flops
    # stay the f32 count at 16-row chunks (``ssd_work``), the yardstick
    # every earlier ssd row was read against, taken as f32 work is for the
    # f32 matmul: three TF32 products at the TF32 rate (the CUDA cores' f32
    # rate and the kernel's own bf16 passes beside it).  No one PyTorch
    # call computes it: no library time.
    for S, B, G in ((5, 1, 1), (ssd_k.CHUNK + 1, 1, 1), (256, 1, 1), (600, 1, 1), (1024, 1, 1),
                    (600, 2, 2)):
        bytes_, flops = ssd_work(S, B=B, G=G)
        sets = [ssd_inputs(torch, S, gen, dev, B=B, G=G) for _ in range(n_sets(bytes_))]
        args = sets[0]
        check = ssd_err(torch, ssd_k.ssd(*args, return_state=True),
                        ssd_k.plain_ssd(*args, return_state=True),
                        ssd_fault(torch, ssd_k.plain_ssd, *args, ssd_k.CHUNK))
        check["kernel_flops"] = ssd_kernel_work(S, B=B, q=ssd_k.CHUNK)
        record("ssd", f"x[{B},{S},48,64] b,c[{B},{S},{G},128]", check, sets,
               lambda *a: ssd_k.ssd(*a, return_state=True),
               lambda *a: ssd_k.plain_ssd(*a, return_state=True), None,
               bytes_, 3 * flops, TF32_TC_FLOPS, f32_rate_flops=flops, instance="ssd_kernel")
        del sets, args

    # conv2d (paper roles 3 and 4, kernel 7): the opencl tenant's frames (one
    # 64x64 int16 frame through the 5x5 and the 3x3x2 filter), the f32 shapes
    # of examples/multi_tenant.py, and 256 and 1024 frames with the card full.  int16
    # exactly, f32 within TOL_ROLE_F32, each beside a planted fault (one
    # nonzero filter tap dropped); the fixed-weight role bitwise equal to the
    # generic kernel.  Library time: F.conv2d for f32 (NCHW, TF32 off); no
    # PyTorch call convolves int16.
    conv_cases = [((1, 64, 64, 1), (5, 5, 1, 1), torch.int16),
                  ((1, 64, 64, 1), (3, 3, 1, 2), torch.int16),
                  ((1, 32, 32, 1), (5, 5, 1, 1), torch.float32),
                  ((1, 32, 32, 1), (3, 3, 1, 1), torch.float32),
                  ((256, 64, 64, 1), (3, 3, 1, 2), torch.int16),
                  ((1024, 64, 64, 1), (3, 3, 1, 2), torch.int16)]
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
        if dt == torch.float32:  # the F.conv2d yardstick's precision, as it ran
            check["cudnn_allow_tf32"] = torch.backends.cudnn.allow_tf32
        record("conv2d", f"x[{B},{H},{W},{Cin}] w[{kh},{kw},{Cin},{nf}] {str(dt)[6:]}", check,
               sets, lambda x, w, xn, wn: conv_k.conv2d(x, w),
               lambda x, w, xn, wn: conv_k.plain_conv2d(x, w),
               (lambda x, w, xn, wn: F.conv2d(xn, wn)) if dt == torch.float32 else None,
               bytes_, ops, F32_FLOPS if dt == torch.float32 else INT32_OPS)
        del sets, x, w, got

    # the f32 matmul (the FC roles, kernel 1 in f32: 3xTF32 on the tensor
    # cores) at the paper's 256 x 256 and at 2048, with its epilogues at 256;
    # the fixed-weight role (kernel 1b) bitwise equal to it and timed on its
    # resident weight.  Within TOL_ROLE_F32, beside a planted fault (the K
    # values 16..31 dropped).  Library time: torch.matmul in f32 with TF32
    # off.  Bound: three TF32 products at the TF32 rate, the f32 rate's
    # beside it.
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
                   per_set, 3 * 2 * M ** 3, TF32_TC_FLOPS, f32_rate_flops=2 * M ** 3,
                   instance=mm_k.kernel_instance(x, w))
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
               lambda a, b: torch.matmul(a, wf), per_set, 3 * 2 * M ** 3, TF32_TC_FLOPS,
               f32_rate_flops=2 * M ** 3, instance=mm_k.kernel_instance(x, wf))
        del sets, x, w, xf, fixed, wf, got

    # the matmul edge kernels (shapes and operands TMA cannot take) at the
    # untied unembeds' shapes: granite-3-8b, hymba-1.5b, whisper large-v3, at
    # M = 1 (the first-token fixup), 8 and 16 (decode steps): the streaming
    # edge kernel, bf16 in and f32 out as the unembed runs it, timed beside
    # the mma.sync edge kernel it replaced at these M (previous_ms); at M = 8
    # also bf16 out under silu, and f32 in (the f32 kernel's 4-byte-load
    # instance); then x 2 bytes off a 16-byte boundary at an aligned shape.
    # Each beside the planted fault of the bf16 rows (the last 64 of K
    # dropped).  Library time: torch.matmul (bf16 out: the same weight
    # bytes), f32 with TF32 off.
    f32 = torch.float32
    for _, K, N in UNEMBEDS:
        w = randn((K, N), K ** -0.5)
        for M in EDGE_ROWS:
            x = randn((M, K))
            fault = mm_k.matmul(drop_last_k_tile(x), w, out_dtype=f32)
            check = matmul_err(torch, mm_k.matmul(x, w, out_dtype=f32),
                               mm_k.plain_matmul(x, w, out_dtype=f32), fault, TOL_F32)
            check["splits"] = mm_k.edge_splits(M, N, K)
            record("matmul_edge", f"[{M},{K}]x[{K},{N}] act=None out=float32", check, [(x, w)],
                   lambda a, b: mm_k.matmul(a, b, out_dtype=f32),
                   lambda a, b: mm_k.plain_matmul(a, b, out_dtype=f32),
                   lambda a, b: torch.matmul(a, b),
                   2 * (M * K + K * N) + 4 * M * N, 2 * M * N * K, BF16_TC_FLOPS,
                   previous=lambda a, b: mm_k.matmul_edge(a, b, kernel=0, out_dtype=f32),
                   instance=mm_k.kernel_instance(x, w))
            if M == 8:
                check = matmul_err(torch, mm_k.matmul(x, w, activation="silu"),
                                   mm_k.plain_matmul(x, w, activation="silu"),
                                   mm_k.matmul(drop_last_k_tile(x), w, activation="silu"),
                                   TOL_BF16)
                record("matmul_edge", f"[{M},{K}]x[{K},{N}] act=silu out=bfloat16", check, None,
                       None, None, None, 0, 0, BF16_TC_FLOPS, instance=mm_k.kernel_instance(x, w))
            del x, fault
        del w
        M = 8
        x = torch.randn((M, K), generator=gen, device=dev)
        w = torch.randn((K, N), generator=gen, device=dev) * K ** -0.5
        xf = drop_last_k_tile(x)
        check = role_err(torch, mm_k.matmul(x, w), mm_k.plain_matmul(x, w),
                         mm_k.plain_matmul(xf, w), TOL_ROLE_F32)
        record("matmul_edge", f"[{M},{K}]x[{K},{N}] act=None f32", check, [(x, w)],
               mm_k.matmul, mm_k.plain_matmul, torch.matmul,
               4 * (M * K + K * N + M * N), 3 * 2 * M * N * K, TF32_TC_FLOPS,
               f32_rate_flops=2 * M * N * K, instance=mm_k.kernel_instance(x, w))
        del x, w, xf
    M, K, N = 8, 2048, 512
    x = torch.empty(M * K + 1, dtype=torch.bfloat16, device=dev)[1:].view(M, K)
    x.copy_(randn((M, K)))
    w = randn((K, N), K ** -0.5)
    check = matmul_err(torch, mm_k.matmul(x, w), mm_k.plain_matmul(x, w),
                       mm_k.matmul(drop_last_k_tile(x), w), TOL_BF16)
    record("matmul_edge", f"[{M},{K}]x[{K},{N}] x 2 bytes off 16-byte alignment", check, None,
           None, None, None, 0, 0, BF16_TC_FLOPS, instance=mm_k.kernel_instance(x, w))
    del x, w
    edge_instance_rows(torch, mm_k, gen, record)
    sample_rows(torch, gen, record)
    return rows, errs


def np_threefry(np, k0, k1, x0, x1):
    """Threefry-2x32 in numpy uint32 (wrapping), written apart from the port's:
    the yardstick of the sampler's random bits."""
    def rotl(v, r):
        return (v << np.uint32(r)) | (v >> np.uint32(32 - r))

    k0, k1, x0, x1 = (np.asarray(v, dtype=np.uint32) for v in (k0, k1, x0, x1))
    ks = [k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA)]
    x0, x1 = x0 + ks[0], x1 + ks[1]
    for g in range(5):
        for r in ((13, 15, 26, 6), (17, 29, 16, 24))[g % 2]:
            x0 = x0 + x1
            x1 = rotl(x1, r) ^ x0
        x0 = x0 + ks[(g + 1) % 3]
        x1 = x1 + ks[(g + 2) % 3] + np.uint32(g + 1)
    return x0, x1


def np_bits(np, keys, counts, V: int):
    """The random bits [B, V] of each slot's draw t = counts[b]: y0 ^ y1 of
    Threefry under fold_in(key, t), over the counts (0, i)."""
    s0, s1 = np_threefry(np, keys[:, 0], keys[:, 1], np.zeros(len(keys), np.uint32), counts)
    i = np.arange(V, dtype=np.uint32)
    y0, y1 = np_threefry(np, s0[:, None], s1[:, None], np.zeros_like(i), i)
    return y0 ^ y1


def sample_err(torch, tok, bits, want_scores, want_bits, np_want_bits, fault_bits) -> dict:
    """The sampler's check: its bits equal the plain version's and numpy's
    exactly, and a planted fault's bits (a key word flipped) differ in
    (nearly) every element; its tokens equal the plain version's wherever
    the two best scores lie more than SAMPLE_TIE_ULPS ulps apart (at least
    one row must)."""
    import numpy as np

    got = bits.long() & 0xFFFFFFFF
    if not torch.equal(got, want_bits):
        raise AssertionError(f"sample bits differ from the plain version's in "
                             f"{int((got != want_bits).sum())} elements")
    if not np.array_equal(bits.cpu().numpy().view(np.uint32), np_want_bits):
        raise AssertionError("sample bits differ from the numpy Threefry's")
    differ = float((fault_bits != bits).float().mean())
    if differ < 0.99:
        raise AssertionError(f"the planted fault (a key word flipped) moves only {differ} of "
                             f"the bits: the check cannot see it")
    top = want_scores.topk(2, dim=-1).values
    best = top[:, 0].abs()
    gap = (top[:, 0] - top[:, 1]) / (torch.nextafter(best, best + 1) - best)
    clear = gap > SAMPLE_TIE_ULPS
    want = torch.argmax(want_scores, dim=-1).to(torch.int32)
    if not bool(clear.any()):
        raise AssertionError("no row's two best scores lie apart: nothing checked")
    if not torch.equal(tok[clear], want[clear]):
        raise AssertionError(f"sample tokens {tok.tolist()} disagree with the plain version's "
                             f"{want.tolist()} where the best scores lie apart")
    return {"max_abs_err": 0.0, "tolerance": f"bits exact; tokens exact where the best two "
                                             f"scores lie > {SAMPLE_TIE_ULPS} ulps apart",
            "rows_compared": int(clear.sum()), "rows": len(tok),
            "bits_equal_numpy_threefry": True, "planted_fault_bits_differ_share": differ}


def sample_rows(torch, gen, record) -> None:
    """The sampler at its served shapes, against its plain version and a
    numpy Threefry, beside a planted fault (one key word flipped); timed
    beside its plain version (no single PyTorch call draws JAX's stream)."""
    import numpy as np

    from repro_torch.kernels import sample as sample_k
    from repro_torch.serve import sampling

    dev = torch.device("cuda")
    T = 0.7
    for B, V in SAMPLE_SHAPES:
        def inputs():
            logits = torch.randn((B, V), generator=gen, device=dev) * 2
            keys = torch.randint(-2**31, 2**31 - 1, (B, 2), generator=gen, device=dev,
                                 dtype=torch.int32)
            counts = torch.randint(0, 1000, (B,), generator=gen, device=dev, dtype=torch.int32)
            live = torch.ones(B, dtype=torch.int32, device=dev)
            return logits, keys, counts, live, torch.zeros(B, dtype=torch.int32, device=dev)

        sets = [inputs() for _ in range(n_sets(4 * B * V))]
        logits, keys, counts, live, tok = sets[0]
        bits = torch.zeros((B, V), dtype=torch.int32, device=dev)
        sample_k.sample(logits, keys, counts, live, tok, T, bits=bits)
        flipped = keys.clone()
        flipped[:, 0] ^= 1 << 7
        fault_bits = torch.zeros_like(bits)
        sample_k.sample(logits, flipped, counts, live, tok.clone(), T, bits=fault_bits)
        torch.cuda.synchronize()
        want_bits = sampling.random_bits_32(sampling.fold_in(keys, counts), V)
        np_want = np_bits(np, keys.cpu().numpy().view(np.uint32),
                          counts.cpu().numpy().astype(np.uint32), V)
        check = sample_err(torch, tok, bits, sampling.scores(keys, counts, logits, T), want_bits,
                           np_want, fault_bits)
        check["splits"] = sample_k.splits_for(B, V)
        record("sample", f"[{B},{V}]", check, sets,
               lambda *a: sample_k.sample(*a, T), lambda *a: sampling.plain_sample(*a, T), None,
               4 * B * V + 6 * 4 * B, SAMPLE_INT_OPS * B * V, INT32_LANE_OPS)
        del sets, logits, bits, fault_bits, want_bits


def offset_copy(torch, t):
    """A copy of ``t`` whose data starts one element (2 bytes in bf16, 4 in
    f32) past a 16-byte boundary."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = flat[1:].view(t.shape)
    out.copy_(t)
    return out


def edge_instance_rows(torch, mm_k, gen, record) -> None:
    """The edge kernels' instances that the unembed rows do not reach, each
    held to the plain version beside a planted fault (the last K slice
    dropped), at the unembeds' shapes, bf16 in and f32 out as the unembed
    runs it, and in f32: M = 17 and 64 (the bf16 ``mma.sync`` edge kernel;
    the f32 tile kernel's edge instance at 128² tiles); M = 8 and 16 with w
    2 bytes (f32: 4 bytes) off a 16-byte boundary (the instances that copy
    w by ``cp.async``; bf16 timed beside the ``mma.sync`` edge kernel on the
    same operands as previous_ms); f32 at M = 16 on the aligned w (the f32
    streaming kernel's 16-row TMA instance); then K not a multiple of 8
    (cp.async, ragged K) and the f32 edge instance at 64² tiles."""
    dev, f32 = torch.device("cuda"), torch.float32

    def randn(shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    def bf16_row(x, w, shape, timed=True):
        M, K, N = x.shape[0], x.shape[1], w.shape[1]
        check = matmul_err(torch, mm_k.matmul(x, w, out_dtype=f32),
                           mm_k.plain_matmul(x, w, out_dtype=f32),
                           mm_k.matmul(drop_last_k_tile(x), w, out_dtype=f32), TOL_F32)
        record("matmul_edge", shape, check, [(x, w)] if timed else None,
               lambda a, b: mm_k.matmul(a, b, out_dtype=f32),
               lambda a, b: mm_k.plain_matmul(a, b, out_dtype=f32),
               lambda a, b: torch.matmul(a, b),
               2 * (M * K + K * N) + 4 * M * N, 2 * M * N * K, BF16_TC_FLOPS,
               previous=((lambda a, b: mm_k.matmul_edge(a, b, kernel=0, out_dtype=f32))
                         if M <= mm_k.STREAM_MAX_M else None),
               instance=mm_k.kernel_instance(x, w))

    def f32_row(x, w, shape, timed=True):
        M, K, N = x.shape[0], x.shape[1], w.shape[1]
        check = role_err(torch, mm_k.matmul(x, w), mm_k.plain_matmul(x, w),
                         mm_k.plain_matmul(drop_last_k_tile(x), w), TOL_ROLE_F32)
        record("matmul_edge", shape, check, [(x, w)] if timed else None,
               mm_k.matmul, mm_k.plain_matmul, torch.matmul,
               4 * (M * K + K * N + M * N), 3 * 2 * M * N * K, TF32_TC_FLOPS,
               f32_rate_flops=2 * M * N * K, instance=mm_k.kernel_instance(x, w))

    off = "w {} bytes off 16-byte alignment"
    for _, K, N in UNEMBEDS:
        w = randn((K, N), K ** -0.5)
        w_off = offset_copy(torch, w)
        for M, wt, note in ([(M, w, "") for M in EDGE_TILE_ROWS]
                            + [(M, w_off, " " + off.format(2)) for M in (8, 16)]):
            bf16_row(randn((M, K)), wt, f"[{M},{K}]x[{K},{N}] act=None out=float32{note}")
        del w, w_off
        w = randn((K, N), K ** -0.5, f32)
        w_off = offset_copy(torch, w)
        for M, wt, note in ([(16, w, ""), (64, w, "")]
                            + [(M, w_off, " " + off.format(4)) for M in (8, 16)]):
            f32_row(randn((M, K), dtype=f32), wt, f"[{M},{K}]x[{K},{N}] act=None f32{note}")
        del w, w_off
    K, N = EDGE_RAGGED_K, UNEMBEDS[1][2]
    bf16_row(randn((5, K)), randn((K, N), K ** -0.5), f"[5,{K}]x[{K},{N}] act=None out=float32",
             timed=False)
    f32_row(randn((16, K), dtype=f32), randn((K, N), K ** -0.5, f32),
            f"[16,{K}]x[{K},{N}] act=None f32", timed=False)
    f32_row(randn((255, 257), dtype=f32), randn((257, 255), dtype=f32),
            "[255,257]x[257,255] act=None f32", timed=False)


def check_instances(rows: list[dict], sass: dict) -> set[str]:
    """Raise unless every instance built of the matmul, decode attention
    and ssd kernels (the ones ``cuobjdump`` lists, and the ``mma.sync`` edge
    kernel) ran in some kernel-phase row, held against the plain version;
    the instances run."""
    ran = {r["instance"] for r in rows if "instance" in r}
    built = {fn for lib in ("matmul", "matmul_edge", "matmul_f32", "decode_attention", "ssd")
             for fn in sass.get(lib, {})}
    missing = (built | {"mm_edge_kernel"}) - ran
    if missing:
        raise AssertionError(f"kernel instances never held against their plain version: "
                             f"{sorted(missing)}")
    return ran


def served_decode_splits(dec_k, prompt_lengths) -> dict[str, set[int]]:
    """The key-range split counts ``split_kv`` picks (a function of the
    cache's rows) at the shapes the serve, traffic and granite phases give
    the decode kernels: the dense kernel at decode steps over 1024 rows
    (llama's 8 and 16 slots), 512 (granite) and 256 (the traffic phase's 6
    slots) and every first-token fixup (one sequence against its prompt's n
    rows); the paged kernel at 1024 and 512 rows."""
    fixups = set(prompt_lengths) | set(GRANITE_LENGTHS)
    return {"decode_attention": {dec_k.split_kv(T) for T in (1024, 512, 256)}
            | {dec_k.split_kv(n) for n in fixups},
            "paged_decode_attention": {dec_k.split_kv(T) for T in (1024, 512)}}


def check_splits(rows: list[dict], served: dict[str, set[int]]) -> dict[str, list[int]]:
    """Raise unless every split count in ``served`` (kernel -> the counts its
    rule picks at served shapes) ran in some row of its kernel; the split
    counts each kernel's rows ran."""
    ran = {name: sorted({r["splits"] for r in rows if r["name"] == name and "splits" in r})
           for name in served}
    missing = {name: sorted(want - set(ran[name])) for name, want in served.items()
               if want - set(ran[name])}
    if missing:
        raise AssertionError(f"split counts the rule picks at served shapes that no row "
                             f"ran: {missing}")
    return ran


def check_sample_shapes(rows: list[dict], runs, sample_k) -> dict:
    """Raise unless every [B, V] a sampled serve run of ``runs`` gave the
    sampler has a ``sample`` row (held against the plain version) and every
    split count :func:`sample.splits_for` picks there ran in some row; the
    shapes and the split counts."""
    served = sorted({tuple(shape) for r in runs for shape in r["sample_shapes"]})
    ran = {r["shape"] for r in rows if r["name"] == "sample"}
    missing = [shape for shape in served if f"[{shape[0]},{shape[1]}]" not in ran]
    if not served or missing:
        raise AssertionError(f"sampler shapes the serve runs gave it that no row held against "
                             f"the plain version: {missing} (served: {served})")
    splits = check_splits(rows, {"sample": {sample_k.splits_for(*shape) for shape in served}})
    return {"served_shapes": served, "splits": splits["sample"]}


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
            "ssd": 0, "sample": 0, "matmul_edge": calls}
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
    unembed is a plain f32 product, not a kernel.  At a temperature above 0
    the sampler runs once for each first token and each decode step
    (``sample_calls``).  A decode step counts alike whether it ran eagerly or
    as a graph's replay: a replay adds the captured step's launches."""
    L = cfg.num_layers
    calls = eng.prefill_calls + eng.chunk_calls + eng.fixup_calls + eng.decode_calls
    if cfg.family == "ssm":
        return {"matmul": 2 * L * calls, "rmsnorm": (2 * L + 1) * calls, "flash_attention": 0,
                "decode_attention": 0, "paged_decode_attention": 0,
                "ssd": L * eng.prefill_calls, "sample": eng.sample_calls}
    return {"matmul": 7 * L * calls, "rmsnorm": (2 * L + 1) * calls,
            "flash_attention": L * (eng.prefill_calls + eng.chunk_calls),
            "decode_attention": L * (eng.fixup_calls + (0 if eng.paged else eng.decode_calls)),
            "paged_decode_attention": L * eng.decode_calls if eng.paged else 0, "ssd": 0,
            "sample": eng.sample_calls}


def serve_run(torch, model, params, kernels, prompts, before_step=None, graphed=True,
              **engine_kw):
    """Serve ``prompts`` (32 new tokens each) through one engine under
    cuda-strict; the run's numbers and the token streams in submission order.  The kernels' launch
    counts are set to 0 just before the run and read just after it.
    ``before_step(i)``, if given, runs before the engine's step ``i`` (another
    tenant's submissions).  ``graphed=False`` runs the decode steps as the
    eager loop (a comparison arm: the engine serves through graphs)."""
    from repro_torch.core import dispatch
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.paged import pool_token_bytes

    cuda = model.device.type == "cuda"
    with dispatch.use(prefer=dispatch.policy_from_flag("cuda-strict")):
        eng = ServeEngine(model, params, max_len=1024, device=model.device, **engine_kw)
        if not graphed:
            # the eager loop on the card, for the graph-against-loop
            # comparison only: no public knob turns graphs off
            eng._graphed = False
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
    graph = eng._graph
    if eng._graphed != (graph is not None) or (graph is not None and graph.captures != 1):
        raise AssertionError(f"graphed={eng._graphed}: {graph and graph.captures} captures")
    res = {**{k: v for k, v in engine_kw.items() if isinstance(v, (bool, int, float, str))},
           **({"decode_fusion": repr(engine_kw["decode_fusion"])}
              if not isinstance(engine_kw.get("decode_fusion", 1), int) else {}),
           "graphed": eng._graphed,
           "graph": ({"captures": graph.captures, "replays": graph.replays,
                      "captured_on_thread": graph.captured_on} if graph is not None else None),
           "sample_calls": eng.sample_calls,
           # the sampler's [B, V]: one slot's first token, the engine's slots
           # at a decode step
           "sample_shapes": sorted({(1, vocab), (eng.slots, vocab)}) if eng.sample_calls else [],
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
    res, streams = serve_run(torch, model, params, kernels, prompts, batch_slots=8)
    if res["fixup_calls"] or res["prefill_calls"] != len(prompts):
        raise AssertionError(f"an SSM prompt was bucketed: {res['prefill_calls']} prefills, "
                             f"{res['fixup_calls']} fixups")
    print("  " + json.dumps({"run": "ssm", **res}))
    return {"prompt_lengths": lengths, "runs": {"ssm": res}, "streams": streams}


def serve_phase(torch, model, params, kernels, seed: int) -> dict:
    """The three runs of ``SERVE_RUNS`` on the same 16 prompts.  Paged
    streams must equal dense streams token for token (the paged kernel is
    bitwise the dense one over equal rows); the chunked 16-slot run must
    complete everything with more than 8 requests live at once, holding no
    more KV memory than the dense run (plus the pool's scratch page), and
    its streams must equal the dense run's, all 16 (raises otherwise): the
    matmul sums a row's K, and flash attention a row's keys, in an order
    that does not depend on the rows a launch carries, so a chunk's rows
    are the whole prompt's bit for bit."""
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
    if streams["paged_chunked"] != streams["dense"]:
        differ = [i for i, (a, b) in enumerate(zip(streams["paged_chunked"], streams["dense"]))
                  if a != b]
        raise AssertionError(f"chunked streams differ from dense streams in requests {differ} "
                             f"(prompt lengths {[lengths[i] for i in differ]})")
    return {"prompt_lengths": lengths, "runs": runs, "paged_streams_equal_dense": True,
            "dense_streams": streams["dense"], "streams": streams,
            "chunked_streams_equal_dense": True,
            "launches": {name: sum(r["launches"][name] for r in runs.values())
                         for name in runs["paged"]["launches"]}}


# ---------------------------------------------------------------------------
# phase 9: live traffic (Table IX's trace arm)
# ---------------------------------------------------------------------------

#: the tapered ChunkPolicy of the traffic phase: 64-row chunks, halved for
#: every two live slots and every two fused steps, at least 16
TRAFFIC_TAPER = dict(max_chunk=64, min_chunk=16, decode_taper=2, fusion_taper=2)
#: the traffic phase's kernels: a dense engine's (greedy: no sampler)
TRAFFIC_KERNELS = ("matmul", "rmsnorm", "flash_attention", "decode_attention")


def traffic_phase(torch, model, params, kernels, n: int = 64) -> dict:
    """Table IX's trace arm (``repro_torch.bench.table9_traffic``) through
    the port's engine under cuda-strict, three arms:

    - virtual clock, gated: the three traces (poisson and longtail of ``n``
      requests, bursty of 128), chunked (16-row chunks) and whole; every
      chunked stream must equal its whole stream, and every row's TTFT and
      TPOT p50/p99, makespan, throughput and requests must equal the JAX
      package's (``table9_traffic.EXPECTED``, at n = 64): schedule
      properties, not the model's or the device's;
    - a tapered ``ChunkPolicy`` on the bursty trace, gated: its streams must
      equal the whole run's (its chunks, 16 to 64 rows, follow the traffic);
    - wall clock, printed, not gated: the bursty trace delivered at its
      real arrival times, chunked and whole in turns (chunked, whole,
      chunked, whole); TTFT p50/p99, TPOT p99 and tokens/s from the
      ledger's ``traffic_split()``; streams must equal the virtual runs'.

    The kernels' launch counts are set to 0 before the arms and read after
    them: every kernel of the dense path must have launched."""
    from repro_torch.bench import table9_traffic as t9
    from repro_torch.core import dispatch
    from repro_torch.core.policy import ChunkPolicy

    res: dict = {}
    with dispatch.use(prefer=dispatch.policy_from_flag("cuda-strict")):
        for mod in kernels:
            mod.launches = 0
        t = time.perf_counter()
        rows, results = t9.run(model, params, n)
        res["virtual_s"] = time.perf_counter() - t
        for row in rows:
            print(f"  {row}")
        res["virtual"] = {f"{name}_{mode}": t9.table_row(r) for (name, mode), r in results.items()}
        res["virtual_rows_equal_jax"] = n == 64
        res["chunked_streams_equal_whole"] = True
        bursty = t9.make_traces(n)["bursty"]
        t = time.perf_counter()
        tapered = t9.replay(model, params, bursty, chunk=ChunkPolicy(**TRAFFIC_TAPER))
        if tapered["streams"] != results[("bursty", "whole")]["streams"]:
            raise AssertionError("the tapered ChunkPolicy's streams differ from the whole run's")
        res["tapered"] = {"policy": TRAFFIC_TAPER, **t9.table_row(tapered),
                          "streams_equal_whole": True, "s": time.perf_counter() - t}
        print("  " + json.dumps({"arm": "tapered ChunkPolicy, bursty, virtual clock",
                                 **res["tapered"]}))
        wall = []
        for mode, chunk in (("chunked", t9.CHUNK), ("whole", None)) * 2:
            r = t9.replay_wall(model, params, bursty, chunk=chunk)
            if r["streams"] != results[("bursty", mode)]["streams"]:
                raise AssertionError(f"wall clock, {mode}: streams differ from the virtual run's")
            row = {"mode": mode, "requests": r["requests"],
                   "ttft_p50_ms": r["ttft_p50"] * 1e3, "ttft_p99_ms": r["ttft_p99"] * 1e3,
                   "tpot_p99_ms": r["tpot_p99"] * 1e3, "tokens_per_s": r["throughput"],
                   "makespan_s": r["makespan"], "steps": r["steps"], "calls": r["calls"]}
            wall.append(row)
            print("  " + json.dumps({"arm": "bursty, wall clock", **row}))
        res["wall"] = wall
        launches = {mod.__name__.rsplit(".", 1)[1]: mod.launches for mod in kernels}
    res["launches"] = launches
    if any(launches[name] == 0 for name in TRAFFIC_KERNELS):
        raise AssertionError(f"a kernel of the path never launched under traffic: {launches}")
    return res


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
    # routed with the worker thread running, the decode graph is captured
    # and replayed on the worker, beside this thread's own CUDA work
    for name, run in (("shared", res), ("alone", alone)):
        graph = run["graph"]
        if dev.type != "cuda":
            continue                       # no graphs on the CPU
        if graph is None or graph["captured_on_thread"] == threading.main_thread().name:
            raise AssertionError(f"routed {name}: the decode graph was not captured on the "
                                 f"scheduler's worker thread: {graph}")
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


#: the decode path's kernels in a profiler trace: a kernel counter's name ->
#: a test of the traced kernel's name
TRACE_KERNELS = {
    "matmul": lambda k: "mm_tile_kernel" in k or "mm_stream_kernel" in k,
    "rmsnorm": lambda k: "rmsnorm_kernel" in k,
    "decode_attention": lambda k: "dec_kernel" in k and "DenseRows" in k,
    "paged_decode_attention": lambda k: "dec_kernel" in k and "PagedRows" in k,
    "sample": lambda k: "sample_kernel" in k,
}


def device_kernels(prof) -> list:
    """The device events of a trace (kernels and copies), the marker kernel
    left out, by start time."""
    return sorted((e for e in prof.events() if str(e.device_type).endswith("CUDA")
                   and "spin_kernel" not in e.name), key=lambda e: e.time_range.start)


def union_us(events) -> float:
    """µs in which at least one of ``events`` (sorted by start) ran: kernels
    launched with programmatic dependent launch begin before the one ahead
    ends, so their spans overlap and their sum counts the overlap twice."""
    total, end = 0.0, -math.inf
    for e in events:
        start, stop = e.time_range.start, e.time_range.end
        if stop > end:
            total += stop - max(start, end)
            end = stop
    return total


def trace_steps(prof, kinds, steps: int) -> list[dict]:
    """Each kind's kernels in each of the last ``steps`` segments of a trace,
    a segment being what ran after one marker kernel (``spin_kernel``, a
    ``torch.cuda._sleep(0)`` launched before each step) and before the
    next."""
    events = sorted((e for e in prof.events() if str(e.device_type).endswith("CUDA")),
                    key=lambda e: e.time_range.start)
    segments: list[dict] = []
    for e in events:
        if "spin_kernel" in e.name:
            segments.append({k: 0 for k in kinds})
        elif segments:
            for kind, match in kinds.items():
                if match(e.name):
                    segments[-1][kind] += 1
    return segments[-steps:]


#: marker kernels that open a trace: a trace's first records have gone
#: missing (in traces of the Mamba-2 graph replays, after many earlier
#: traces in the process), and these absorb what a trace drops first
TRACE_OPENING_MARKERS = 8


def busy_phase(torch, model, params, seed: int, graphed: bool = True,
               temperature: float = 0.0) -> dict:
    """Where a decode step's time goes: the card's busy share over four
    decode steps of 8 live slots (device kernel time from a torch.profiler
    trace of CUDA activity, over the wall time of the steps) and the
    kernels that take it, the steps run as graph replays or (``graphed``
    False) as the eager loop.  The profiler costs host time of its own, so
    four steps just before the traced ones are also timed untraced, and the
    busy share is also read against their wall time.

    A marker kernel opens each traced step, so the trace splits into steps:
    each of the four must list every kernel exactly as often as its launch
    counter moved a step (a replay adds the captured step's launches), and
    every kernel the decode path runs.  A trace without device events reads
    as not measured (None)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import dispatch
    from repro_torch.kernels import launch_counters
    from repro_torch.serve.engine import ServeEngine

    path = {"matmul", "rmsnorm"} | ({"sample"} if temperature > 0 else set()) | (
        set() if model.cfg.family == "ssm" else {"decode_attention"})
    rng = torch.Generator().manual_seed(seed + 3)
    with dispatch.use(prefer=dispatch.policy_from_flag("cuda-strict")):
        eng = ServeEngine(model, params, batch_slots=8, max_len=1024, device=model.device,
                          temperature=temperature, seed=3)
        if not graphed:
            eng._graphed = False      # the comparison arm: the eager loop on the card
        for n in (40, 90, 130, 200, 260, 300, 400, 500):
            eng.submit(torch.randint(0, model.cfg.vocab_size, (n,), generator=rng).tolist(),
                       max_new_tokens=32)
        eng.step()                    # the prefills (and the graph's capture), outside the window
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(4):
            eng.step()
        torch.cuda.synchronize()
        untraced_us = (time.perf_counter() - t0) * 1e6
        before = launch_counters()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(TRACE_OPENING_MARKERS):
                torch.cuda._sleep(0)
            torch.cuda.synchronize()
            time.sleep(0.02)
            t0 = time.perf_counter()
            for _ in range(4):
                torch.cuda._sleep(0)      # the marker that opens a step
                eng.step()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        after = launch_counters()
    events = [e for e in prof.key_averages()
              if e.self_device_time_total > 0 and "spin_kernel" not in e.key]
    moved = {name: after[(name, attr)] - v for (name, attr), v in before.items()
             if attr == "launches" and after[(name, attr)] != v}
    per_step = {k: v // 4 for k, v in moved.items()}
    steps = [{k: v for k, v in st.items() if v} for st in trace_steps(prof, TRACE_KERNELS, 4)]
    if events:
        if any(v % 4 for v in moved.values()) or len(steps) != 4 or any(
                st != per_step for st in steps):
            raise AssertionError(f"the traced decode steps list other kernels than the launch "
                                 f"counters moved a step: steps {steps}, counted {moved} in "
                                 f"four steps")
        if not all(per_step.get(k) for k in path):
            raise AssertionError(f"a decode-path kernel is missing from the steps: {per_step}, "
                                 f"the path {sorted(path)}")
    busy_us = sum(e.self_device_time_total for e in events)
    union = union_us(device_kernels(prof))
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
    dec_us = sum(e.self_device_time_total for e in events if "dec_kernel" in e.key)
    smp_us = sum(e.self_device_time_total for e in events if "sample_kernel" in e.key)
    traced = {name: sum(e.count for e in events if match(e.key))
              for name, match in TRACE_KERNELS.items()}
    res = {"decode_steps": 4, "graphed": graphed, "temperature": temperature,
           "wall_us": wall_us, "untraced_wall_us": untraced_us,
           "device_busy_us": busy_us if events else None,
           "device_busy_share": busy_us / wall_us if events else None,
           "device_busy_share_of_untraced_wall": busy_us / untraced_us if events else None,
           # the time some kernel ran: overlapping spans counted once
           "device_union_us": union if events else None,
           "device_union_share_of_untraced_wall": union / untraced_us if events else None,
           "decode_attention_device_us_a_step": dec_us / 4 if events else None,
           "sample_device_us_a_step": smp_us / 4 if events else None,
           "kernel_launches_traced": traced if events else None, "launches_counted": moved,
           "launches_a_step": per_step,
           "top_device_us": {e.key[:60]: e.self_device_time_total for e in top}}
    print("  " + json.dumps(res))
    return res


def graph_against_loop(torch, model, params, kernels, seed: int, want: list,
                       temperature: float = 0.7) -> dict:
    """The decode steps as graph replays against the eager loop, read in
    turns (graph, loop, graph, loop): 8 slots serving the 16 prompts
    greedily (every stream must equal ``want``, the serve phase's), then the
    busy share of four decode steps at ``temperature`` (the trace lists the
    sampler).  Decode tokens/s and TTFT of each arm are printed beside the
    busy share."""
    lengths, prompts = serve_prompts(torch, model.cfg.vocab_size, seed)
    arms: dict = {"graph": [], "loop": []}
    busy: dict = {"graph": [], "loop": []}
    for graphed in (True, False, True, False):
        arm = "graph" if graphed else "loop"
        res, streams = serve_run(torch, model, params, kernels, prompts, graphed=graphed,
                                 batch_slots=8)
        if streams != want:
            differ = [i for i, (a, b) in enumerate(zip(streams, want)) if a != b]
            raise AssertionError(f"{arm} streams differ from the serve phase's graphed run "
                                 f"in requests {differ}")
        arms[arm].append(res)
    for graphed in (True, False, True, False):
        busy["graph" if graphed else "loop"].append(
            busy_phase(torch, model, params, seed, graphed=graphed, temperature=temperature))
    out = {"in_turns": "graph, loop, graph, loop", "streams_equal": True}
    for arm in ("graph", "loop"):
        out[arm] = {key: [r[key] for r in arms[arm]]
                    for key in ("decode_tokens_per_s", "ttft_mean_s", "ttft_p99_s", "wall_s")}
        out[arm]["busy_share"] = [b["device_busy_share"] for b in busy[arm]]
        out[arm]["busy_share_of_untraced_wall"] = [b["device_busy_share_of_untraced_wall"]
                                                   for b in busy[arm]]
        out[arm]["union_share_of_untraced_wall"] = [
            b["device_union_share_of_untraced_wall"] for b in busy[arm]]
        out[arm]["busy_device_us"] = [b["device_busy_us"] for b in busy[arm]]
        out[arm]["union_device_us"] = [b["device_union_us"] for b in busy[arm]]
        out[arm]["busy_wall_us"] = [b["wall_us"] for b in busy[arm]]
        out[arm]["untraced_wall_us"] = [b["untraced_wall_us"] for b in busy[arm]]
        print(f"  {model.cfg.name if hasattr(model.cfg, 'name') else ''} {arm}: " + json.dumps(
            out[arm]))
    out["busy"] = busy
    return out


def loop_streams_equal(torch, model, params, kernels, seed: int, graphed_streams: dict,
                       runs) -> dict:
    """Each of ``runs`` (name, engine keywords) served once more as the
    eager loop: its streams must equal the graphed run's bit for bit."""
    _, prompts = serve_prompts(torch, model.cfg.vocab_size, seed)
    out = {}
    for name, kw in runs:
        res, streams = serve_run(torch, model, params, kernels, prompts, graphed=False, **kw)
        if streams != graphed_streams[name]:
            differ = [i for i, (a, b) in enumerate(zip(streams, graphed_streams[name]))
                      if a != b]
            raise AssertionError(f"{name}: the loop's streams differ from the graph's in "
                                 f"requests {differ}")
        out[name] = res
        print("  " + json.dumps({"run": f"{name}_loop", **res}))
    return out


#: the temperature phase's runs (T = 0.7, seed 3): each graphed unless
#: named ``_loop``; every stream must equal ``dense_k1``'s
TEMPERATURE_RUNS = (
    ("dense_k1", {"batch_slots": 8, "decode_fusion": 1}),
    ("dense_k4", {"batch_slots": 8, "decode_fusion": 4}),
    ("dense_k4_loop", {"batch_slots": 8, "decode_fusion": 4}),
    ("paged_k1", {"batch_slots": 8, "decode_fusion": 1, "paged": True, "page_size": 16}),
    ("paged_k4", {"batch_slots": 8, "decode_fusion": 4, "paged": True, "page_size": 16}),
    ("paged_k4_loop", {"batch_slots": 8, "decode_fusion": 4, "paged": True, "page_size": 16}),
    ("paged_chunked_k4", {"batch_slots": 16, "decode_fusion": 4, "paged": True,
                          "page_size": 16, "prefill_chunk": 128,
                          "pool_pages": 8 * 1024 // 16 + 1}),
    ("paged_chunked_k4_loop", {"batch_slots": 16, "decode_fusion": 4, "paged": True,
                               "page_size": 16, "prefill_chunk": 128,
                               "pool_pages": 8 * 1024 // 16 + 1}),
    ("dense_policy", {"batch_slots": 8, "decode_fusion": "FusionPolicy(max_fusion=8)"}),
)


def temperature_phase(torch, model, params, kernels, seed: int, runs=TEMPERATURE_RUNS) -> dict:
    """Seeded temperature sampling (T = 0.7, seed 3) through ``runs``: the
    streams are equal across fusion depths and a FusionPolicy's, dense and
    paged, chunked and whole-prompt, graph against loop (a request's stream
    depends only on its key and its logits, and a chunk's rows are the
    whole prompt's bit for bit); raises otherwise."""
    from repro_torch.core.policy import FusionPolicy

    _, prompts = serve_prompts(torch, model.cfg.vocab_size, seed)
    out, streams = {}, {}
    for name, kw in runs:
        kw = dict(kw)
        if isinstance(kw.get("decode_fusion"), str):
            kw["decode_fusion"] = FusionPolicy(max_fusion=8)
        out[name], streams[name] = serve_run(torch, model, params, kernels, prompts,
                                             graphed=not name.endswith("_loop"),
                                             temperature=0.7, seed=3, **kw)
        print("  " + json.dumps({"run": f"t0.7_{name}", **out[name]}))
    base = streams[runs[0][0]]
    for name, _ in runs:
        if streams[name] != base:
            differ = [i for i, (a, b) in enumerate(zip(streams[name], base)) if a != b]
            raise AssertionError(f"T = 0.7: {name}'s streams differ from {runs[0][0]}'s in "
                                 f"requests {differ}")
    chunked = any(n.startswith("paged_chunked") for n, _ in runs)
    return {"runs": out, "streams_equal_across_k_and_graph_loop": True,
            "chunked_streams_equal_dense": True if chunked else None}


def prefill_busy(torch, model, params, seed: int) -> dict:
    """Where one prefill's time goes: a 600-token prompt (llama: the 1024
    bucket; Mamba-2: its own length) into an idle 1-slot engine, after one
    such prefill as a warm-up; device kernel time from a torch.profiler
    trace of the step that prefills it (the prefill, llama's first-token
    fixup, and one decode), by kernel, the bf16 matmul kernels' and the ssd
    kernel's parts of it, and the step's wall time."""
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
    ssd_us = sum(e.self_device_time_total for e in events if "ssd_kernel" in e.key)
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:6]
    res = {"prompt": 600, "bucket": None if model.cfg.family == "ssm" else 1024,
           "wall_us": wall_us,
           "device_busy_us": busy_us if events else None,
           "bf16_matmul_device_us": mm_us if events else None,
           "ssd_device_us": ssd_us if events else None,
           "ssd_share": ssd_us / busy_us if events else None,
           "device_busy_share": busy_us / wall_us if events else None,
           "top_device_us": {e.key[:60]: e.self_device_time_total for e in top}}
    print("  " + json.dumps(res))
    return res


def template_name(kernel_re: str):
    """The instance name of a ``Function :`` line of ``cuobjdump`` whose
    kernel matches ``kernel_re``, from its int template arguments
    (``_ZN..mm_tile_kernelILi128ELi256EEEv..`` -> ``mm_tile_kernel<128,256>``);
    None for any other function."""
    def name(line: str) -> str | None:
        m = re.search(rf"({kernel_re})I((?:L[ib]\d+E)+)", line)
        if m is None:
            return None
        return m.group(1) + "<" + ",".join(re.findall(r"L[ib](\d+)E", m.group(2))) + ">"
    return name


def sass_counts(native, lib: str, kernel_re: str,
                need: tuple[str, ...] = ("HGMMA", "UTMALDG"),
                name=None) -> dict[str, dict[str, int]]:
    """The count of wgmma (HGMMA) and TMA load (UTMALDG) instructions, and of
    any other opcode in ``need`` (HMMA: mma.sync), in each instance of the
    kernels whose name matches ``kernel_re`` in the built library of
    ``csrc/<lib>.cu``, from ``cuobjdump --dump-sass`` (the one beside nvcc);
    raises unless every one has those in ``need``.  ``name`` maps a
    function's line to its instance name (:func:`template_name` unless
    given)."""
    name = name or template_name(kernel_re)
    ops = tuple(dict.fromkeys(("HGMMA", "UTMALDG") + need))
    path = native.build_all()[lib]
    cuobjdump = Path(native._nvcc()).parent / "cuobjdump"
    out = subprocess.run([str(cuobjdump), "--dump-sass", str(path)], capture_output=True,
                         text=True, timeout=120, check=True).stdout
    counts: dict[str, dict[str, int]] = {}
    fn = None
    for line in out.splitlines():
        if "Function :" in line:
            fn = name(line)
            if fn:
                counts[fn] = dict.fromkeys(ops, 0)
        elif fn:
            for op in ops:
                counts[fn][op] += op in line
    if not counts or any(c[op] == 0 for c in counts.values() for op in need):
        what = " or ".join({"HGMMA": "wgmma", "UTMALDG": "TMA loads", "HMMA": "mma.sync"}[op]
                           for op in need)
        raise AssertionError(f"{lib} kernels without {what}: {counts}")
    return counts


def bf16_matmul_sass(native) -> dict[str, dict[str, int]]:
    """:func:`sass_counts` of the bf16 matmul's tile and streaming kernels."""
    return sass_counts(native, "matmul", r"mm_(?:tile|stream)_kernel")


def edge_sass(native) -> dict[str, dict[str, int]]:
    """:func:`sass_counts` of the bf16 edge kernel for M <= 16 (mma.sync on
    tiles its own threads realign, no wgmma; TMA copies in the instances
    with TMA = 1)."""
    counts = sass_counts(native, "matmul", r"mm_edge_stream_kernel", need=("HMMA",))
    if not all(c["UTMALDG"] for fn, c in counts.items() if fn.endswith(",1>")):
        raise AssertionError(f"the edge kernel's TMA instances without TMA loads: {counts}")
    return counts


def f32_matmul_sass(native) -> dict[str, dict[str, int]]:
    """:func:`sass_counts` of the f32 (3xTF32) kernels' instances: wgmma on
    tiles the converter warpgroup writes (no TMA); mma.sync in the streaming
    kernel for M <= 16 (TMA loads in its TMA instances)."""
    counts = {**sass_counts(native, "matmul", r"mm_f32_kernel", need=("HGMMA",)),
              **sass_counts(native, "matmul", r"mm_f32_stream_kernel", need=("HMMA",))}
    if not all(c["UTMALDG"] for fn, c in counts.items()
               if fn.startswith("mm_f32_stream") and fn.endswith(",1>")):
        raise AssertionError(f"the f32 streaming kernel's TMA instances without TMA loads: "
                             f"{counts}")
    return counts


def flash_sass(native) -> dict[str, dict[str, int]]:
    """:func:`sass_counts` of the flash attention kernel's instances (D = 64, 128)."""
    return sass_counts(native, "flash_attention", r"fa_kernel")


def decode_instance(line: str) -> str | None:
    """``dec_kernel<D,DenseRows>`` or ``dec_kernel<D,PagedRows>`` for a
    ``cuobjdump`` function line of the decode kernel (the row type is the
    second template argument, in the anonymous namespace)."""
    m = re.search(r"dec_kernelILi(\d+)E\w*?(Dense|Paged)Rows", line)
    return f"dec_kernel<{m.group(1)},{m.group(2)}Rows>" if m else None


def decode_sass(native) -> dict[str, dict[str, int]]:
    """:func:`sass_counts` of the decode attention kernel's instances (D =
    16 .. 128, dense and paged): mma.sync, no wgmma."""
    return sass_counts(native, "decode_attention", r"dec_kernel", need=("HMMA",),
                       name=decode_instance)


def ssd_sass(native) -> dict[str, dict[str, int]]:
    """:func:`sass_counts` of the ssd kernel: every product on the tensor
    cores (mma.sync)."""
    return sass_counts(native, "ssd", r"ssd_kernel", need=("HMMA",),
                       name=lambda line: "ssd_kernel" if re.search(r"\d+ssd_kernelE", line)
                       else None)


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
    from repro_torch import kernels as kernel_pkg
    from repro_torch.configs import get_arch
    from repro_torch.kernels import conv2d as conv_k
    from repro_torch.kernels import decode_attention as dec_k
    from repro_torch.kernels import matmul as mm_k
    from repro_torch.kernels import native
    from repro_torch.kernels import sample as sample_k
    from repro_torch.models import build_model, init_params

    # the kernels of the serve paths: every counted module but conv2d, which
    # only the tenants phase runs (and counts on its own)
    kernels = tuple(mod for mod in kernel_pkg.modules() if mod is not conv_k)
    t_start = time.perf_counter()
    smi = nvidia_smi()
    card = torch.cuda.get_device_name(0)
    print(f"[1/9] device: {smi} | torch.cuda.get_device_name(0) = {card} | "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t = time.perf_counter()
    native.build_all()
    print(f"  built {len(native.SOURCES)} sources ({len(kernels) + 5} kernels: the two f32 "
          f"matmul kernels, the two matmul edge kernels and conv2d beside these seven) in "
          f"{time.perf_counter() - t:.1f} s"
          + ("" if native.build_logs() else " (found built under build/: no ptxas report)"))
    for name, log in native.build_logs().items():
        for line in log.splitlines():
            if "Used" in line or "spill" in line or "Compiling entry" in line:
                print(f"  {name}: {line.strip()}")
    sass = {"matmul": bf16_matmul_sass(native), "flash_attention": flash_sass(native),
            "matmul_edge": edge_sass(native), "matmul_f32": f32_matmul_sass(native),
            "decode_attention": decode_sass(native), "ssd": ssd_sass(native)}
    for lib, fns in sass.items():
        for fn, counts in fns.items():
            print(f"  {lib} SASS {fn}: " + ", ".join(f"{n} {op}" for op, n in counts.items()))

    print(f"[2/9] kernels against their plain versions, on {card} ({smi})")
    rows, errs = kernel_phase(torch, args.seed)
    print(f"  every matmul, decode attention and ssd instance built was held against the "
          f"plain version: {sorted(check_instances(rows, sass))}")
    decode_splits = check_splits(
        rows, served_decode_splits(dec_k, serve_prompts(torch, 128, args.seed)[0]))
    print(f"  every split count the decode rule picks at the served shapes ran: {decode_splits}")

    print("[3/9] model: llama3.2-1b prefill, fixup and decode, cuda-strict vs the torch "
          "source; chunked vs whole-prompt prefill")
    model = build_model(get_arch("llama3.2-1b"))
    params = init_params(model.param_specs(), args.seed)
    model_res = model_phase(torch, model, params, args.seed)

    print("[4/9] serve: 16 greedy requests, max_len 1024, cuda-strict: dense 8 slots; "
          "paged 8 slots; paged + chunked prefill 16 slots in the same KV memory")
    serve_res = serve_phase(torch, model, params, kernels, args.seed)
    print_runs(serve_res["runs"], card, smi)
    print("  paged streams equal dense: 16 of 16; chunked streams equal dense: 16 of 16")
    print("  where a decode step's time goes (torch.profiler, CUDA activity):")
    busy_res = busy_phase(torch, model, params, args.seed)
    print("  where a 1024-bucket prefill's time goes (torch.profiler, CUDA activity):")
    prefill_res = prefill_busy(torch, model, params, args.seed)
    print(f"  decode steps as replayed CUDA graphs against the eager loop, in turns, on {card} "
          f"({smi}): dense 8 slots, then four decode steps' busy share at T = 0.7")
    graph_res = {"dense": graph_against_loop(torch, model, params, kernels, args.seed,
                                             serve_res["dense_streams"])}
    print("  the paged and chunked runs as the eager loop: streams equal the graphs'")
    graph_res["loop_runs"] = loop_streams_equal(torch, model, params, kernels, args.seed,
                                                serve_res.pop("streams"), SERVE_RUNS[1:])
    print("  temperature 0.7, seed 3: dense and paged at K 1 and 4, graph and loop, a "
          "FusionPolicy(max_fusion=8), chunked K 4")
    temp_res = temperature_phase(torch, model, params, kernels, args.seed)


    print("[5/9] tenants: hsa_init(num_regions=2) on the card, the async scheduler's worker "
          "thread; tf-serving: the 16 requests through a dense 8-slot engine; opencl: the "
          "paper's four roles through two regions")
    tenants_res = tenants_phase(torch, model, params, kernels, args.seed,
                                serve_res.pop("dense_streams"))
    print_runs({"tenants_routed": tenants_res["run"]}, card, smi)
    del model, params
    torch.cuda.empty_cache()

    print(f"[6/9] model: granite-3-8b at full width, {GRANITE_DEPTH} layers (head_dim 128, "
          f"untied unembed N = 49155): prefill, fixup, decode dense and paged, chunked "
          f"staging and paged, cuda-strict vs the torch source")
    model = build_model(dataclasses.replace(get_arch("granite-3-8b"), num_layers=GRANITE_DEPTH))
    params = init_params(model.param_specs(), args.seed)
    granite_res = granite_phase(torch, model, params, kernels, args.seed)
    del model, params
    torch.cuda.empty_cache()

    print("[7/9] model: mamba2-780m prefill at the prompt's length and batched decode, "
          "cuda-strict vs the torch source")
    model = build_model(get_arch("mamba2-780m"))
    params = init_params(model.param_specs(), args.seed)
    ssm_model_res = ssm_model_phase(torch, model, params, args.seed)

    print("[8/9] serve: mamba2-780m, the same 16 prompt lengths, 8 slots, cuda-strict")
    ssm_res = ssm_serve_phase(torch, model, params, kernels, args.seed)
    print_runs(ssm_res["runs"], card, smi)
    print(f"  decode steps as replayed CUDA graphs against the eager loop, in turns, on {card} "
          f"({smi})")
    graph_res["ssm"] = graph_against_loop(torch, model, params, kernels, args.seed,
                                          ssm_res.pop("streams"))
    print("  temperature 0.7, seed 3: K 4, graph and loop")
    ssm_temp_res = temperature_phase(
        torch, model, params, kernels, args.seed,
        runs=(("ssm_k4", {"batch_slots": 8, "decode_fusion": 4}),
              ("ssm_k4_loop", {"batch_slots": 8, "decode_fusion": 4})))
    print("  where a decode step's time goes (torch.profiler, CUDA activity):")
    ssm_busy_res = busy_phase(torch, model, params, args.seed)
    print("  where a 600-token prefill's time goes, by kernel (torch.profiler, CUDA activity):")
    ssm_prefill_res = prefill_busy(torch, model, params, args.seed)
    del model, params
    torch.cuda.empty_cache()

    print(f"[9/9] traffic: llama3.2-1b, Table IX's three traces through the engine, cuda-strict, "
          f"on {card} ({smi}): virtual clock, chunked and whole (rows must equal the JAX "
          f"package's, streams equal); a tapered ChunkPolicy; the bursty trace on the wall "
          f"clock, in turns")
    model = build_model(get_arch("llama3.2-1b"))
    params = init_params(model.param_specs(), args.seed)
    traffic_res = traffic_phase(torch, model, params, kernels)

    runs = {**serve_res["runs"], "traffic": {"launches": traffic_res["launches"]},
            "tenants": tenants_res["run"], **ssm_res["runs"],
            "granite": {"launches": granite_res["launches"]},
            **{f"t0.7_{n}": r for n, r in temp_res["runs"].items()},
            **{f"t0.7_{n}": r for n, r in ssm_temp_res["runs"].items()}}
    sample_shapes = check_sample_shapes(rows, [r for n, r in runs.items()
                                               if n not in ("granite", "traffic")],
                                        sample_k)
    print(f"  every [B, V] the sampled runs gave the sampler, and every split count there, was "
          f"held against the plain version: {sample_shapes}")
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
                "matmul_edge": "[8,4096]x[4096,49155] act=None out=float32",
                "sample": "[8,128256]"}
    # the rows beside each headline: the bf16 matmul's prefill, flash
    # attention's other timed rows at D = 64 and its D = 128 and 96 rows, the
    # decode kernels at D = 128 and 96, the other unembeds and row counts,
    # the f32 kernel at 2048
    lengths = "[1, 1024, 5, 600, 37, 256, 900, 64]"
    off2, off4 = "w 2 bytes off 16-byte alignment", "w 4 bytes off 16-byte alignment"
    beside = {"matmul": ["[1024,2048]x[2048,8192] act=None out=bfloat16"],
              "flash_attention": [f"q[1,32,{S},{D}] kv[1,8,{T},{D}] causal={c}"
                                  for D in (64, 128)
                                  for S, T, c in ((512, 512, True), (512, 512, False),
                                                  (128, 1024, True), (1024, 1024, True))
                                  if (D, S, T, c) != (64, 512, 512, True)]
                                 + ["q[1,32,512,96] kv[1,8,512,96] causal=True"],
              "decode_attention": ["q[8,32,128] cache[8,4,1024,128] lengths 1..1024",
                                   "q[8,32,96] cache[8,8,1024,96] lengths 1..1024",
                                   "q[1,32,64] cache[1,8,600,64] length 600"],
              "ssd": [f"x[{B},{S},48,64] b,c[{B},{S},{G},128]"
                      for S, B, G in ((5, 1, 1), (65, 1, 1), (256, 1, 1), (1024, 1, 1),
                                      (600, 2, 2))],
              "paged_decode_attention": [f"q[8,32,128] pool[513,4,16,128] table[8,64] lengths "
                                         f"{lengths}",
                                         f"q[16,32,64] pool[1025,8,16,64] table[16,64] lengths "
                                         f"{[1, 1024, 5, 600, 37, 256, 900, 64] * 2}",
                                         f"q[8,32,96] pool[513,8,16,96] table[8,64] lengths "
                                         f"{lengths}"],
              "matmul_edge": [f"[{M},{K}]x[{K},{N}] act=None out=float32{note}"
                              for _, K, N in UNEMBEDS
                              for M, note in ([(M, "") for M in EDGE_ROWS + EDGE_TILE_ROWS]
                                              + [(M, f" {off2}") for M in (8, 16)])
                              if (M, K, note) != (8, 4096, "")]
                             + [f"[{M},{K}]x[{K},{N}] act=None f32{note}" for _, K, N in UNEMBEDS
                                for M, note in ((8, ""), (16, ""), (64, ""), (8, f" {off4}"),
                                                (16, f" {off4}"))],
              "matmul_f32": ["[2048,2048]x[2048,2048] act=None f32"],
              "rmsnorm": ["[512,2048]", "[8,1536]", "[600,1536]", "[8,3072]", "[600,3072]",
                          "[8,4096]", "[512,4096]", "[8,2048] float16", "[8,1000]",
                          "[8,2048] f32"],
              "conv2d": ["x[1,64,64,1] w[3,3,1,2] int16", "x[1,32,32,1] w[5,5,1,1] float32",
                         "x[1,32,32,1] w[3,3,1,1] float32", "x[256,64,64,1] w[3,3,1,2] int16",
                         "x[1024,64,64,1] w[3,3,1,2] int16"],
              "matmul_fixed_weight": ["[2048,2048]x[2048,2048] fixed f32"],
              "sample": [f"[{B},{V}]" for B, V in SAMPLE_SHAPES[1:]]}
    # the CUDA functions behind each entry
    cuda_fn = {"matmul": "mm_tile_kernel<BM,BN>, mm_stream_kernel<MP>",
               "rmsnorm": "rmsnorm_kernel<E,WARPS,NC,RESIDENT> (a block of 1-8 warps a "
                          "row, NC 16-byte chunks a thread; E bf16, f16 or f32)",
               "flash_attention": "fa_kernel<64|128>",
               "decode_attention": "dec_kernel<D, DenseRows>",
               "paged_decode_attention": "dec_kernel<D, PagedRows>", "ssd": "ssd_kernel",
               "matmul_f32": "mm_f32_kernel<1,B,B> (3xTF32 on wgmma; M <= 16: "
                             "mm_f32_stream_kernel<8|16,TMA>, 3xTF32 on mma.sync)",
               "matmul_fixed_weight": "the f32 kernels on a resident weight",
               "conv2d": "conv_kernel<Tin,Acc,KH,KW,FCH,ONE_CH> (persistent, a cp.async "
                         "ring, a strip of 4 pixels a thread, FCH filters a chunk)",
               "sample": "sample_kernel (grid (splits, B): a slot's vocabulary over splits "
                         "blocks, merged by the last to arrive)",
               "matmul_edge": "mm_edge_stream_kernel<8|16,TMA> (M <= 16; TMA = 1 where K "
                              "% 8 == 0 and w is aligned, else cp.async copies), "
                              "mm_edge_kernel (M > 16); f32: mm_f32_stream_kernel<8|16,TMA> "
                              "(M <= 16), mm_f32_kernel<0,B,B> (M > 16)"}
    library = {"matmul": "torch.matmul", "rmsnorm": "F.rms_norm",
               "flash_attention": "F.scaled_dot_product_attention",
               "decode_attention": "F.scaled_dot_product_attention",
               "paged_decode_attention": "two calls: an index gather of the pages into a "
                                         "dense copy, then F.scaled_dot_product_attention",
               "ssd": "no single PyTorch call computes it",
               "matmul_f32": "torch.matmul, f32 with TF32 off",
               "matmul_fixed_weight": "torch.matmul, f32 with TF32 off",
               "conv2d": "none for int16 (F.conv2d, f32 and TF32 off, at the f32 shapes)",
               "matmul_edge": "torch.matmul (bf16 out; f32 with TF32 off at the f32 row)",
               "sample": "no single PyTorch call draws JAX's Threefry stream"}
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
    # the line holds what this run measured, and bound_ms: the other bounds
    # (bound_f32_rate_ms, ssd's bound_kernel_tc_ms) stay in the rows and --out
    timing = ("shape", "instance", "splits", "ms", "host_ms", "plain_ms", "bound_ms", "bound_by",
              "library_ms", "previous_ms")
    summary = []
    for name, mod, replaces, by_run in entries:
        row = next(r for r in rows if r["name"] == name and r["shape"] == headline[name])
        # the errors of the headline row's tolerance; those of the kernel's
        # other tolerances beside them
        others = [e for tol, e in errs[name].items() if tol != row["tolerance"]]
        more = [{k: r[k] for k in timing if k in r} for shape in beside.get(name, ())
                for r in rows if r["name"] == name and r["shape"] == shape]
        summary.append({
            "name": name, "kernel": cuda_fn[name], "route": mod.ROUTE, "source": mod.SOURCE,
            "replaces": replaces,
            "launches": sum(by_run.values()), "launches_by_run": by_run,
            **errs[name][row["tolerance"]],
            **({"errors_at_other_tolerances": others} if others else {}),
            "shape": row["shape"], "ms": row["ms"],
            "kernel_ms": row["ms"], "host_ms": row["host_ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"], "library": library[name],
            **{k: row[k] for k in ("splits", "previous_ms") if k in row},
            **({"other_rows": more} if more else {}),
            **({"sass": sass[name]} if name in sass else {}),
            **({"row_invariant": row["row_invariant"]} if "row_invariant" in row else {}),
        })
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({
            "card": card, "nvidia_smi": smi, "torch": torch.__version__, "seed": args.seed,
            "kernel_rows": rows, "sass": sass, "model": model_res, "serve": serve_res,
            "busy": busy_res, "prefill_busy": prefill_res,
            "tenants": tenants_res, "granite": granite_res,
            "ssm_model": ssm_model_res, "ssm_serve": ssm_res, "ssm_busy": ssm_busy_res,
            "ssm_prefill_busy": ssm_prefill_res, "decode_splits": decode_splits,
            "sample_shapes": sample_shapes,
            "graph_against_loop": graph_res, "temperature": temp_res, "traffic": traffic_res,
            "ssm_temperature": ssm_temp_res,
            "launch_floor_ms": next(r["ms"] for r in rows if r["name"] == "launch_floor"),
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
