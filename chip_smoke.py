#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--out results.json]

Serves ``llama3.2-1b``, ``mamba2-780m``, ``yi-6b``, ``granite-3-8b`` and
``yi-9b`` (heads of 128, untied unembeds; granite's over 49155 tokens) at
full width and depth, the Mixture-of-Experts ``llama4-maverick`` and
``deepseek-v3`` (MLA) at full width with their depth cut to fit one card,
and the hybrid ``hymba-1.5b`` (attention and Mamba-2 heads, a sliding
window) and the encoder-decoder ``whisper-large-v3`` at full width and
depth, with weights drawn from ``--seed`` on the card,
through the port's own entry points under the ``cuda-strict`` policy, so
every op on the path runs a hand-written kernel; serves llama3.2-1b
through faults, silent corruption and shared prompt prefixes, and yi-9b
under an overcommitted page pool (preemption, host spill and refill);
runs the paper's two tenants on the card through the port's HSA runtime;
and trains llama3.2-1b at full width and depth under the ``torch`` policy.
Phases, in order; any failure raises and the script exits non-zero:

1. device: the card's name and power limit; build the kernels from
   ``src/repro_torch/csrc`` (seven sources, twelve kernels; flash attention
   four instances, <64,64>, <128,128>, <192,128> and <256,128>) and print what
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
   window, ragged) and 96, flash's <192,128> instance at MLA's prefill
   shapes (128 heads, q and k 192 wide, values 128; 8 .. 1024 rows), within
   the tolerance stated below (attention
   row by row, ssd per row and per head's state, conv2d and the f32 matmul
   exactly or within 2e-4 (also filters too large for one shared-memory
   slab, staged in row slabs), the bf16 matmul within 2e-2, each beside what
   a planted fault reads by the same measure; rmsnorm in bf16, f16, f32 and
   f64,
   at an odd D, and bitwise row-invariant (a row's output the same in a
   launch of 1, 3, 8, 128 or 600 rows and under a permutation); the bf16
   matmul bitwise row-invariant too, at every (K, N) a served prefill runs
   (llama's, mamba2's, yi's and granite's weights; a row's bits the same
   in a launch of 1, 3, 8, 16, 17, 128, 512 or 1024 rows, streaming kernel or
   tile, and under a permutation), yi's and granite's unembeds (f32 out; a
   row's bits the same alone, in 8 rows and in 16), and flash
   attention's chunked rows bitwise the whole prompt's (16-, 128- and
   512-row chunks at 0, 16, 128 and 512 of a 1024-row prompt, at every
   split); the
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
   still built (beside the streaming edge kernel at M <= 16, the edge tile
   kernel on the same operands), and its bound (the larger of bytes / 3.35 TB/s and
   operations / peak rate; the f32 kernels' (the f32 matmul's, ssd's)
   f32 products as three TF32 products at the TF32 rate, the f32 rate's
   beside it).  The
   paged kernel must also equal the dense kernel on the gathered cache bit
   for bit, and the fixed-weight roles (``matmul_fixed_weight``,
   ``conv2d_fixed_weight``) their generic kernels.  Every shape the
   full-depth, overcommit, fault, integrity and prefix runs and model
   calls give a kernel (derived
   from each engine's slots, pages and chunk and the prompts' lengths:
   ``served_shapes``) must have a row here, checked at the summary.  The sampler (``sample``,
   JAX's position-indexed categorical draw) at every [B, V] the sampled
   serve runs give it ([1, 128256], [8, 128256], [16, 128256], [1, 50280],
   [8, 50280]) and at granite's [8, 49155]: its random bits exactly the
   plain version's and a numpy Threefry's (a key word flipped moves them
   all), its tokens the plain version's wherever the two best scores lie
   more than 4 ulps apart, with and without the bits asked for; its bound
   the operations an element's random bits take in the built kernel
   (counted in the SASS of its probe, ``sample_bits_ops``).  Then
   adversarial rows, in a batch of 8 at split counts 1, 7, the rule's and
   1024, and each alone at the rule's: the winner the
   element with the largest Gumbel draw, its l/T 15 below the row's
   maximum, a runner-up just below it in the same 16 bytes; NaN; +inf
   twice; all -inf; equal logits: each token the plain version's exactly,
   each beside a planted fault it reads (the pre-test without its margin
   must drop the winner; NaN ranked low, the last index on ties or no
   Gumbel term must pick another token).  After the serve runs, every [B,
   V] a sampled run gave it, and every split count its rule picks there,
   must have run in one of these rows; the temperature phase times it on
   the decode logits an untimed served run gave it too.
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
6. faults, llama3.2-1b: the 16 requests paged 8 slots, routed through a
   queue of an HSA scheduler on a virtual clock (Table X's cost model),
   greedy and at T = 0.7 (K = 4): fault-free; a forced exec fault on the
   first fused decode (every live request parked and re-prefilled) and on
   the first prefill (requeued) with an engine ``RetryPolicy``; the decode
   fault absorbed by the scheduler's retry; a permanent one with no
   recovery budget (the live requests in ``failed_requests`` and
   ``ServeTruncated.failed``); Table X's seeded plan at 0.05; chunked
   fault-free and with a forced fault on the first chunk.  Every stream
   equals the fault-free run's, 16 of 16 (the permanent arm's survivors).
7. integrity, llama3.2-1b: the 16 requests at the overcommit phase's
   settings (128 new tokens, 8 slots over 96 pages, snapshots from 384
   rows), greedy and at T = 0.7: clean, then a seeded corruption plan
   (pool pages flipped in place, parked snapshots and transfers
   corrupted) with every check on and a scrub of 4 a step (every
   corruption detected, none escaping, pages quarantined, streams the
   clean run's), and greedy with every check off (corruption escapes);
   the read check's hashed bytes and seconds a decode launch beside a
   clean step.
8. prefix, llama3.2-1b: 16 users of two personas' 512-token system
   prompts (suffixes of 8 to 200 tokens, 32 new tokens), 16 slots, greedy
   and at T = 0.7: sharing off and on, whole and chunked (128-row chunks;
   a shared request prefills its suffix from row 512); streams equal 16 of
   16; every indexed page's digest unchanged while shared; a byte flipped
   on a page several requests share (every reader parks and re-prefills).
   The counts of phases 6-8 (model calls, faults, corruptions, detections,
   prefix hits, CoW copies) must equal a run of the same phases on the
   card's host CPU with a tiny llama at the same lengths (``--twin``,
   started beside the card's phases).  Then Table XII's region arm and
   Table XIII's trace arm on the host, against the JAX package's rows.
9. full depth: yi-6b (32 layers), granite-3-8b (40) and yi-9b (48) in
   turn, each from ``--seed`` and freed before the next: 8 prompts'
   bucketed prefills (8 .. 512), their first-token fixups, a batched
   decode over the dense cache and over a page pool (bitwise equal), and a
   512-token prompt in 128-row chunks through staging and a pool (bitwise
   equal), under ``cuda-strict`` against the ``torch`` source, launches
   counted from 0 and checked against the calls (flash, decode and paged
   attention at D = 128, and the unembed: yi's on the bf16 kernel,
   granite's on the edge kernel); then the 16 requests dense 8 slots as a
   graph, paged 8 slots, paged chunked 16 slots, and at T = 0.7 (seed 3)
   dense and chunked at K = 4, streams equal 16 of 16; the weights' bytes,
   peak memory, TTFT and the dense graph run's decode tokens/s beside the
   weights' bound, and the card's name and power limit.
10. overcommit, yi-9b at 48 layers: the 16 requests at 128 new tokens
   through a paged engine of 8 slots over 97 pages: full reserve;
   overcommitted (``growth_reserve`` 0.5), preempting and resuming both by
   snapshot and by re-prefill; a host budget of one snapshot with two
   outside preempts while a refill is in flight, evicting a parked
   snapshot (arena bytes freed, its refill and copy up cancelled); and
   churn at T = 0.7 with external ``preempt``/``resume`` calls; each arm's
   streams equal an unconstrained dense run's, the allocator's and the
   arena's invariants held after every step; the real snapshot copies' GB/s
   (refills copied up on a side stream ahead of need, and how long the
   serving stream waited on them).  Then Table VIII's and XI's trace
   arms (``repro_torch.bench``), whose rows must equal the JAX package's.
11. model, mamba2-780m: prefill logits and SSD state under ``cuda-strict``
   against the ``torch`` source for prompts of 5, 37 and 600 tokens (at
   their own length: an SSM prompt is not bucketed), then three decode
   steps of the three as a batch.
12. serve, mamba2-780m (the ``ssm`` run): the 16 prompt lengths, 8 slots,
   32 new tokens each, launches checked as in 4 (48 ssd a prefill, none a
   decode step, no fixups); then its busy share over four decode steps,
   and one 600-token prompt's prefill into an idle engine by kernel (the
   ssd kernel's part); graph against loop as for llama; and T = 0.7 at K 4,
   graph equal to loop.
13. traffic, llama3.2-1b again, from ``--seed`` (Table IX's trace arm,
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
14. moe: llama4-maverick (d_model 5120, 40/8 heads of 128, 128 experts
   top-1 of d_ff 8192 and a shared one, vocab 202048) at 2 of 48 layers
   (one (moe, dense) unit, 37 GB) under ``cuda-strict``, then deepseek-v3
   (d_model 7168, 128 MLA heads, ranks 1536/512, 3 dense layers of d_ff
   18432 then MoE: 256 experts top-8 of d_ff 2048 and a shared one, vocab
   129280) at 5 of 61 layers (56 GB) under ``cuda`` (MLA's absorbed decode
   attention is plain PyTorch, as in the JAX package), each from ``--seed``
   and freed before the next.  8 prompts of 5 to 600 tokens: their
   prefills, fixups and 3 batched decode steps against the ``torch``
   source (launches counted, a dispatch trace: ``mla_decode_attention`` the
   only op off the kernels; a GQA step over a page pool bitwise the dense
   one), and the same calls with every kernel held against its plain
   version on the calls' data; then the 8 prompts (16 new tokens) dense 8
   slots as a graph and as the eager loop, K = 4, paged (llama4), T = 0.7 at
   K 1 and 4: streams equal 8 of 8, launches checked against the calls; the
   depth cut, weights' bytes, peak memory, TTFT and decode tokens/s beside
   the weights' bound.
15. families: hymba-1.5b (32 layers, d_model 1600, 25/5 heads of 64 under
   a 1024-token window beside 50 Mamba-2 heads of 64 with state 16, vocab
   32001) and whisper-large-v3 (32 encoder and 32 decoder layers, d_model
   1280, 20 heads of 64, vocab 51866) at full width and depth, each from
   ``--seed`` and freed before the next.  Hymba: 8 prompts of 5 to 1400
   tokens (three past the window, the ring engaged at prefill; 1000 crossing
   it in decode) into 2048-row slots (a 1024-row ring): prefills and 3
   batched decode steps under cuda-strict against the ``torch`` source
   (launches counted, every kernel held against its plain version on the
   calls' data, ssd's state too), paged and chunked serving refused, then
   the 8 prompts (32 new tokens) dense 8 slots as a graph and as the loop,
   K = 4, T = 0.7 at K 1 and 4, streams equal 8 of 8; weights, peak memory,
   TTFT, decode tokens/s beside the step's bound, a traced step.  Whisper: 8
   sets of 1500 frames and a 4-token prompt, prefill into a 448-row cache
   and 3 decode steps against the ``torch`` source as for hymba, the
   engine's refusal, then 64 greedy tokens twice (equal), the encoder's and
   the decoder's prefill seconds, decode tokens/s beside the step's bound, a
   traced step.  Every shape the phase gave a kernel must have a kernel-phase
   row (checked at the summary); the kernel phase holds the kernels at those
   shapes beside planted faults, and the inputs only the wrappers route
   (widths off a multiple of 16, values past 128, queries and keys to 256,
   query groups past 16, rmsnorm in fp8, conv2d's input in slabs).
16. train: llama3.2-1b (16 layers, d_model 2048, vocab 128256, tied) at full
   width and depth, weights from ``--seed``, under the ``torch`` policy (no
   hand-written kernel has a backward pass; ``dispatch.op`` refuses one
   where a gradient flows), AdamW from ``pick_opt`` with a 2-step warm-up,
   remat ``full``, 8 x 1024 tokens a step from the synthetic stream: the
   first step's gradient finite and nonzero on every leaf (``tok``
   among them), its loss and grad norm within 2e-2 of the same weights'
   in f32; a warm-up step and 10 timed steps through ``TrainLoop`` (step
   time, tokens/s, peak memory, loss and grad norm at each step, model
   FLOPs a step as a share of 989 TFLOP/s), no kernel launched, the loss
   falling, and where a step's device time goes (a traced step); greedy streams (8 x 16 tokens) under cuda-strict on the
   refreshed weights, every kernel call held against its plain version,
   equal to the torch source's on the training tree up to each stream's
   first near tie (best two scores within 4 ulps), and a planted stale
   ``tok_f32`` caught; then 2 of 16 layers trained 4 steps unbroken and 2 +
   2 across a checkpoint and a resume, parameters and optimizer state bit
   for bit.
17. dist: llama3.2-1b at full width and depth on a one-rank 1x1 ("data",
   "model") mesh over NCCL: ``make_prefill_step`` (8 prompts of 128 tokens)
   and 16 ``make_decode_step`` steps under cuda-strict, every logit bit for
   bit ``DecoderLM.prefill``'s and ``decode_step``'s and the greedy tokens
   equal; 2 ``make_train_step`` steps under the rules at 8 x 1024 tokens
   against the one-device step, the leaves that differ (none expected)
   listed with their largest gap; ``python -m repro_torch.launch.serve
   --arch llama3.2-1b --requests 6`` through its ``main``, 6 of 6 answered;
   ``compressed_psum`` through NCCL, ``quantize_int8`` bitwise the CPU's;
   matmul, rmsnorm, flash attention and decode attention each launched in
   the phase; its seconds.
18. internvl2: internvl2-76b at full width (d_model 8192, d_ff 28672,
   64/8 heads of 128, vocab 128256, untied), its depth cut 80 -> 8 layers,
   weights from ``--seed``: the vlm path (256 patch rows drawn on the card
   over the first rows of 320, 32 greedy decode steps) under cuda-strict
   against the torch source (logits within MODEL_REL_L2_TOL) and with
   every kernel held against its plain version, launches counted; 8 text
   prompts of 5 to 600 tokens at 8 slots as a graph and as the loop,
   streams equal; every shape it gave a kernel has a kernel-phase row
   (``internvl2_rows``); decode tokens/s against the weights' bound, TTFT,
   peak memory, a traced decode step.
19. examples and the dry run: ``repro_torch.examples.quickstart`` and
   ``serve_lm`` on the card with their own checks; hw.py's constants
   against ``torch.cuda.get_device_properties``; five steps the card ran
   above (llama3.2-1b's graphed decode at 8 slots, its 1024-bucket
   prefill, its train step at 8 x 1024; yi-9b's and internvl2's decode),
   counted on meta tensors at a 1x1 mesh by ``python3 chip_smoke.py
   --dryrun`` on the CPU while the card works: each measured device time
   at least the roofline's ``step_bound_s`` and each count's parameter
   (and optimizer-state) bytes equal to the live tensors'; the bound's
   share and the predicted peak beside ``max_memory_allocated`` printed.

The last lines are the ``{"kernels": [...]}`` summary, the card's
``nvidia-smi`` name and power limit, and ``{"ok": true, "device": ...}``.
Needs one CUDA card; exits non-zero without one.  Imports no JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import os
import re
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.hw import DEFAULT_CHIP as CHIP  # noqa: E402  (the card's constants)

HBM_BYTES_S = CHIP.hbm_bw               # H100 SXM device memory
BF16_TC_FLOPS = CHIP.peak_bf16_flops    # H100 SXM dense bf16 tensor cores
TF32_TC_FLOPS = CHIP.peak_tf32_flops    # H100 SXM dense tf32 tensor cores
F32_FLOPS = CHIP.peak_f32_flops         # H100 SXM f32 outside the tensor cores
# int32 multiply-adds on the CUDA cores: an SM has 64 INT32 lanes against 128
# FP32 lanes (NVIDIA's Hopper architecture white paper), so half the f32 rate
INT32_OPS = CHIP.peak_int32_ops
# int32 adds, xors and shifts: one a lane a clock, half the multiply-add count
INT32_LANE_OPS = INT32_OPS / 2
# the sampler's bound: the operations one element's random bits and uniform
# take (Threefry-2x32's 20 rounds, the key additions, the uniform's xor,
# shift and or; the two logs and the division, which only a candidate
# needs, not counted), read off the SASS of the probe the kernel's source
# compiles beside it (csrc/sample.cu ``sample_bits_ops``, never launched):
# shifts, logic and byte permutes run only on the ALU pipe, 64 lanes an SM
# (INT32_LANE_OPS); every operation issues at 128 an SM a clock (INT32_OPS:
# adds may go to the FMA pipe as IMAD).  Not counted: the probe's own
# thread index, parameters, address, moves, store and exit.
SAMPLE_ALU_ONLY = ("SHF", "SHL", "SHR", "LOP3", "LOP", "PRMT")
SAMPLE_NOT_OPS = ("S2R", "S2UR", "CS2R", "LDC", "STG", "EXIT", "BRA", "NOP", "MOV", "IMAD.MOV",
                  "IMAD.WIDE")
# the sampler against its plain version: the random bits exactly (and a
# numpy Threefry's), the token wherever the two best scores lie more than
# this many ulps apart (the kernel's logf and PyTorch's may part by an ulp;
# kernels/sample.py's TIE_ULPS, which its sweep uses); its shapes are
# kernels/sample.py's SHAPES, every shape the sampled serve runs give it
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
# the full-depth phase's configs, served in this order (the last one's
# weights stay for the overcommit phase): yi-6b (32 layers), granite-3-8b
# (40; an untied unembed over 49155 tokens, the edge matmul), yi-9b (48)
FULL_DEPTH_ARCHS = ("yi-6b", "granite-3-8b", "yi-9b")
# the model-call check's 8 prompt lengths (buckets 8 .. 512); the kernel phase
# holds decode and paged attention against their plain versions at them too
CALL_LENGTHS = (5, 45, 130, 260, 300, 400, 470, 500)
#: the serve runs' 16 prompt lengths: 5 to 600, evenly spaced
SERVE_LENGTHS = tuple(round(5 + i * (600 - 5) / 15) for i in range(16))
#: the prefix phase's prompts: a persona's 512-token system prompt (32
#: pages of 16) and a user's suffix of 8 to 200 tokens, evenly spaced
PREFIX_ROWS = 512
PREFIX_SUFFIXES = tuple(round(8 + i * (200 - 8) / 15) for i in range(16))
PREFIX_LENGTHS = tuple(PREFIX_ROWS + n for n in PREFIX_SUFFIXES)
#: the step the prefix phase's other 14 users arrive at, after the two
#: personas' first users
PREFIX_WAVE_STEP = 8
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


def exact_matmul(torch, x, w, activation=None):
    """The f32 matmul's function on f32 operands at f64 precision, cast to
    f32: the exact product that the kernel and torch's f32 product (the
    plain version) each approximate."""
    from repro_torch.kernels.ref import epilogue

    return epilogue(torch.matmul(x.double(), w.double()), activation).float()


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
#: smallest launch, a 128-row chunk, a 512-row suffix prefill after a shared
#: 512-row prefix
MATMUL_INVARIANCE_ROWS = (1, 3, 8, 16, 17, 128, 512)
#: yi's and granite's weights (4096 wide, heads of 128): wq and wo; yi's wk
#: and wv (4 kv heads), its MLP (11008); granite's wk and wv (8 kv heads),
#: its MLP (12800)
FULL_DEPTH_KN = ((4096, 4096), (4096, 512), (4096, 11008), (11008, 4096), (4096, 1024),
                 (4096, 12800), (12800, 4096))
#: the (K, N) pairs the served prefills run: llama3.2-1b's four weights,
#: mamba2-780m's two, then yi's and granite's
MATMUL_SERVED_KN = ((2048, 2048), (2048, 512), (2048, 8192), (8192, 2048), (1536, 6448),
                    (3072, 1536), *FULL_DEPTH_KN)
#: the untied unembeds the served runs give M of 1 (a prompt's last row, a
#: fixup), 8 and 16 (decode steps): yi's (the bf16 kernel, f32 out) and
#: granite's (N not a multiple of 8: the edge kernel)
SERVED_UNEMBEDS = ((4096, 64000), (4096, 49155))
# the moe phase's decode matmuls (K, N, out dtype): llama4-maverick's wq/wo,
# wk/wv, shared expert (gate/up, down), dense MLP (gate/up, down), unembed;
# deepseek-v3's wq_a, wq_b, wkv_a, dense MLP, shared expert, unembed
MOE_DECODE_KN = (
    (5120, 5120, "bf16"), (5120, 1024, "bf16"), (5120, 8192, "bf16"), (8192, 5120, "bf16"),
    (5120, 16384, "bf16"), (16384, 5120, "bf16"), (5120, 202048, "f32"),
    (7168, 1536, "bf16"), (1536, 24576, "bf16"), (7168, 576, "bf16"), (7168, 18432, "bf16"),
    (18432, 7168, "bf16"), (7168, 2048, "bf16"), (2048, 7168, "bf16"), (7168, 129280, "f32"))
#: where the chunks start, and their rows, that flash attention's rows are
#: held at against a 1024-row prompt's (512 rows at 512: the prefix phase's
#: suffix prefill)
FLASH_CHUNK_STARTS = (0, 16, 128, 512)
FLASH_CHUNK_ROWS = (16, 128, 512)


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
               previous=None, f32_rate_flops=None, instance=None, served_key=None):
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
               **({"served_key": list(served_key)} if served_key else {}), **check}
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
    # the untied unembeds' rows, f32 out: a row's bits the same alone, in the
    # 8 rows of a decode step and in 16 (the bf16 kernel for yi; for
    # granite the edge kernel, whose split follows (N, K) alone at M <= 16)
    unembed_invariance = []
    for K, N in SERVED_UNEMBEDS:
        x, w = randn((16, K)), randn((K, N), K ** -0.5)
        full = mm_k.matmul(x, w, out_dtype=torch.float32)
        for m in (1, 8):
            if not torch.equal(mm_k.matmul(x[:m], w, out_dtype=torch.float32), full[:m]):
                raise AssertionError(f"unembed [{K},{N}]: the rows of a {m}-row launch differ "
                                     f"from the same rows of a 16-row launch")
        for i in range(16):
            if not torch.equal(mm_k.matmul(x[i:i + 1], w, out_dtype=torch.float32),
                               full[i:i + 1]):
                raise AssertionError(f"unembed [{K},{N}]: row {i} alone differs from its row "
                                     f"in a 16-row launch")
        unembed_invariance.append({"K": K, "N": N, "launch_rows": [1, 8, 16],
                                   "instances": sorted({mm_k.kernel_instance(x[:m], w)
                                                        for m in (1, 8, 16)})})
        del x, w, full
    print(f"  unembed row invariance holds: {unembed_invariance}")

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

    # yi's and granite's weights at every row count their runs give them,
    # llama's rows_used (check_served_shapes holds the runs to it), the
    # MLP's gate also under its silu epilogue; timed at 8 and 1024.  Then
    # yi's unembed (f32 out) at 1, 8 and 16, timed at 8
    for K, N in FULL_DEPTH_KN:
        for M in rows_used:
            timed = M in (8, 1024)
            sets = [(randn((M, K)), randn((K, N), K ** -0.5))
                    for _ in range(n_sets(2 * (M * K + K * N)) if timed else 1)]
            x, w = sets[0]
            for act in ((None, "silu") if N in (11008, 12800) else (None,)):
                check = matmul_err(torch, mm_k.matmul(x, w, activation=act),
                                   mm_k.plain_matmul(x, w, activation=act),
                                   mm_k.matmul(drop_last_k_tile(x), w, activation=act), TOL_BF16)
                record("matmul", f"[{M},{K}]x[{K},{N}] act={act} out=bfloat16", check,
                       sets if timed else None,
                       lambda a, b, act=act: mm_k.matmul(a, b, activation=act),
                       lambda a, b, act=act: mm_k.plain_matmul(a, b, activation=act),
                       (lambda a, b: torch.matmul(a, b)) if act is None else None,
                       2 * (M * K + K * N + M * N), 2 * M * N * K, BF16_TC_FLOPS,
                       instance=mm_k.kernel_instance(x, w))
            del sets, x, w
    # the moe phase's decode matmuls at 8 slots, timed: llama4-maverick's
    # attention, shared expert and dense MLP, deepseek-v3's MLA projections,
    # dense MLP and shared expert (every shape and row count the phase runs
    # is also held against the plain version on the calls' data there), and
    # the two untied unembeds (f32 out)
    for K, N, out_name in MOE_DECODE_KN:
        M, out = 8, torch.float32 if out_name == "f32" else torch.bfloat16
        sets = [(randn((M, K)), randn((K, N), K ** -0.5))
                for _ in range(n_sets(2 * (M * K + K * N)))]
        x, w = sets[0]
        tol = TOL_F32 if out == torch.float32 else TOL_BF16
        check = matmul_err(torch, mm_k.matmul(x, w, out_dtype=out),
                           mm_k.plain_matmul(x, w, out_dtype=out),
                           mm_k.matmul(drop_last_k_tile(x), w, out_dtype=out), tol)
        record("matmul", f"[{M},{K}]x[{K},{N}] act=None out={str(out)[6:]}", check, sets,
               lambda a, b, out=out: mm_k.matmul(a, b, out_dtype=out),
               lambda a, b, out=out: mm_k.plain_matmul(a, b, out_dtype=out),
               lambda a, b: torch.matmul(a, b),
               2 * (M * K + K * N) + out.itemsize * M * N, 2 * M * N * K, BF16_TC_FLOPS,
               instance=mm_k.kernel_instance(x, w))
        del sets, x, w
    K, N = SERVED_UNEMBEDS[0]
    for M in (1, 8, 16):
        sets = [(randn((M, K)), randn((K, N), K ** -0.5))
                for _ in range(n_sets(2 * (M * K + K * N)) if M == 8 else 1)]
        x, w = sets[0]
        check = matmul_err(torch, mm_k.matmul(x, w, out_dtype=torch.float32),
                           mm_k.plain_matmul(x, w, out_dtype=torch.float32),
                           mm_k.matmul(drop_last_k_tile(x), w, out_dtype=torch.float32), TOL_F32)
        if M == 8:
            check["row_invariant"] = unembed_invariance
        record("matmul", f"[{M},{K}]x[{K},{N}] act=None out=float32", check,
               sets if M == 8 else None,
               lambda a, b: mm_k.matmul(a, b, out_dtype=torch.float32),
               lambda a, b: mm_k.plain_matmul(a, b, out_dtype=torch.float32),
               lambda a, b: torch.matmul(a, b),
               2 * (M * K + K * N) + 4 * M * N, 2 * M * N * K, BF16_TC_FLOPS,
               instance=mm_k.kernel_instance(x, w))
        del sets, x, w

    # rmsnorm's row invariance first: a row normalised in a launch of 1, 3, 8
    # or 128 rows, or moved by a permutation, is bitwise the row of a 600-row
    # launch (chunked and whole-prompt prefill must not part); at llama's
    # width, mamba2's and an odd one (rows off 16-byte boundaries)
    invariance = []
    for D in (2048, 1536, 1000, 4096):
        x, w = randn((600, D)), randn((D,))
        perm = torch.randperm(600, generator=gen, device=dev)
        invariance.append(row_invariance(torch, rms_k.rmsnorm, x, w, perm))
    print(f"  rmsnorm row invariance holds: {invariance}")

    # rmsnorm: fixup, decode, chunk and prefill rows at llama's d_model 2048;
    # mamba2's ln1 and ln_f (1536) and gated norm (3072) at its row counts;
    # granite's and yi's 4096 at every row count of llama's; f16 and
    # an odd D (the ragged last chunk: 1000 is not a multiple of 8) at llama's
    # decode rows
    widths = [(R, 2048, torch.bfloat16) for R in rows_used]
    widths += [(R, D, torch.bfloat16) for D in (1536, 3072) for R in (3, 5, 8, 37, 600)]
    widths += [(R, 4096, torch.bfloat16) for R in rows_used]
    widths += [(8, 2048, torch.float16), (8, 1000, torch.bfloat16)]
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
    # and in f64, the element template's fourth instance (each element read
    # as f32, as the plain version's statistics are f32), at the same rows
    sets = [(x.double(), w.double()) for x, w in sets]
    check = max_err(torch, rms_k.rmsnorm(*sets[0]), rms_k.plain_rmsnorm(*sets[0]), TOL_ROLE_F32)
    record("rmsnorm", f"[{R},{D}] f64", check, sets, rms_k.rmsnorm, rms_k.plain_rmsnorm,
           lambda x, w: F.rms_norm(x, (x.shape[-1],), w, 1e-6),
           8 * (2 * R * D + D), 4 * R * D, F32_FLOPS)
    del sets

    # flash attention at D = 64 (llama's 32/8 heads) and D = 128 (granite's
    # 32/8 heads of 128): prefill of every bucket the serve runs fill (8 ..
    # 1024 rows; 512 also non-causal); S < T: the 128-row chunks of chunked
    # prefill against 256 .. 1024 keys, which split their key range over 2-4
    # blocks a tile (split-KV); a sliding window of 48; a ragged 200.  At yi's
    # 32/4 heads of 128, the same.  And D = 96 (a head_dim the
    # D = 128 instance takes, its columns past 96 read as zeros) at causal
    # 512, a chunk and ragged 200.
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
    chunks += [(512, 1024, True, None)]    # a suffix prefill after a 512-row prefix
    others = [(256, 256, True, 48), (200, 200, True, None)]
    every = buckets + chunks + others
    d96 = [(512, 512, True, None), (128, 1024, True, None), (200, 200, True, None)]
    for D, hkv, flash_cases in ((64, 8, every), (128, 8, every), (128, 4, every), (96, 8, d96)):
        for S, T, causal, window in flash_cases:
            per_set = 2 * (2 * 32 * S * D + 2 * hkv * T * D)
            sound, dropped = flash_masks(torch, S, T, causal, dev, window)
            # the library call: SDPA's own causal masks where they compute
            # the kernel's (top-left is_causal at S = T, the lower-right bias
            # for a chunk), an explicit mask under the window
            mask = (sound if window else causal_lower_right(S, T) if causal and S < T
                    else None)
            sets = []
            for _ in range(n_sets(per_set)):
                q, k, v = randn((1, 32, S, D)), randn((1, hkv, T, D)), randn((1, hkv, T, D))
                sets.append((q, k, v, k.repeat_interleave(32 // hkv, 1),
                             v.repeat_interleave(32 // hkv, 1), mask))
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
            record("flash_attention", f"q[1,32,{S},{D}] kv[1,{hkv},{T},{D}] causal={causal}"
                   + (f" window={window}" if window else ""), check,
                   sets if timed else None,
                   lambda q, k, v, ke, ve, m, kw=kw: fa_k.flash_attention(q, k, v, **kw),
                   lambda q, k, v, ke, ve, m, kw=kw: fa_k.plain_flash_attention(q, k, v, **kw),
                   lambda q, k, v, ke, ve, m, c=causal and S == T and not window:
                       F.scaled_dot_product_attention(q, ke, ve, attn_mask=m, is_causal=c),
                   per_set, 4 * 32 * D * int(sound.sum()), BF16_TC_FLOPS)
            del sets, q, k, v, fault

    # flash attention's <192,128> instance: MLA's prefill (deepseek-v3: 128
    # heads, q and k of qk_nope 128 + qk_rope 64, values of 128, Hq = Hkv,
    # scale 1/sqrt(192)) at every bucket the moe phase's prompts fill (8 ..
    # 1024) and a ragged 200, beside the planted fault (keys 64..127
    # dropped); timed at 128, 512 and 1024 beside SDPA (its own causal mask)
    H, DQK, DV = 128, 192, 128
    for S in (8, 64, 128, 256, 512, 1024, 200):
        per_set = 2 * H * S * (2 * DQK + 2 * DV)
        sound, dropped = flash_masks(torch, S, S, True, dev)
        timed = S in (128, 512, 1024)
        sets = [(randn((1, H, S, DQK)), randn((1, H, S, DQK)), randn((1, H, S, DV)))
                for _ in range(n_sets(per_set) if timed else 1)]
        q, k, v = sets[0]
        kw = dict(causal=True, scale=DQK ** -0.5)
        check = attention_err(torch, fa_k.flash_attention(q, k, v, **kw),
                              fa_k.plain_flash_attention(q, k, v, **kw),
                              masked_attention(torch, q, k, v, sound & ~dropped),
                              dropped.sum(dim=-1) == 64)
        check["splits"] = fa_k.split_kv(1, H, S, S, True, None, DQK, DV)
        record("flash_attention_qk192",
               f"q[1,{H},{S},{DQK}] k[1,{H},{S},{DQK}] v[1,{H},{S},{DV}] causal=True", check,
               sets if timed else None,
               lambda q, k, v, kw=kw: fa_k.flash_attention(q, k, v, **kw),
               lambda q, k, v, kw=kw: fa_k.plain_flash_attention(q, k, v, **kw),
               lambda q, k, v: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                              scale=DQK ** -0.5),
               per_set, 2 * H * (DQK + DV) * int(sound.sum()), BF16_TC_FLOPS,
               instance="fa_kernel<192,128>")
        del sets, q, k, v

    # decode attention: 8 slots against a 1024-row cache with lengths 1 ..
    # 1024 (a decode step), and one sequence against a cache cut to its
    # prompt length n (the first-token fixup: T = n, not a multiple of the
    # 32-key tile; n = 300, 400 and 600 for the split counts 3, 4 and 5 that
    # the serve runs' fixups reach); at D = 64 with llama's 8 kv heads; at D
    # = 96 with 8 kv heads; the traffic phase's decode step (6 slots against
    # 256 rows); and every other instance (D = 16, 32, 48, 80, 112) at the 8
    # slots, untimed.  At D = 128 with yi's 4 kv heads (a group of 8 query
    # heads) and granite's 8 (a group of 4), every shape their runs give the
    # kernel: decode steps of 8 and 16 slots against 1024 rows, the model
    # calls' 8 against a 512-row cache (each prompt's length plus the new
    # token), and a fixup at each prompt length whose bucket pads it (timed:
    # the 8 slots at 1024 rows, and 600).
    slots = torch.tensor([1, 1024, 5, 600, 37, 256, 900, 64], dtype=torch.int32, device=dev)
    traffic = torch.tensor([1, 256, 5, 100, 37, 232], dtype=torch.int32, device=dev)
    granite = torch.tensor([n + 1 for n in CALL_LENGTHS], dtype=torch.int32, device=dev)
    padded = sorted(n for n in {*SERVE_LENGTHS, *CALL_LENGTHS} if n & (n - 1) or n < 8)
    # llama's fixups: the split counts 3-5 (300, 400, 600), then every
    # length the serve, fault, integrity and prefix phases pad
    padded64 = sorted({300, 400, 600} | {n for n in (*SERVE_LENGTHS, *PREFIX_LENGTHS)
                                         if n & (n - 1) or n < 8})
    cases = []
    for D, hkv, steps, fixups in (
            (64, 8, ((slots, 1024),), tuple(padded64)),
            *((128, h, ((slots, 1024), (slots.repeat(2), 1024), (granite, 512)), padded)
              for h in (4, 8)),
            (96, 8, ((slots, 1024),), (5, 45)),
            (64, 8, ((traffic, 256),), ()),
            *((D, 8, ((slots, 1024),), ()) for D in OTHER_HEAD_DIMS)):
        for lengths, T in steps:
            B = lengths.numel()
            cases += [(lengths, T, D, hkv, f"q[{B},32,{D}] cache[{B},{hkv},{T},{D}] lengths "
                       f"{int(lengths.min())}..{int(lengths.max())}",
                       (B, T) == (8, 1024) and D not in OTHER_HEAD_DIMS)]
        cases += [(torch.tensor([n], dtype=torch.int32, device=dev), n, D, hkv,
                   f"q[1,32,{D}] cache[1,{hkv},{n},{D}] length {n}", n == 600) for n in fixups]
    for lengths, T, D, hkv, shape, timed in cases:
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
        record("decode_attention", shape, check, sets if timed else None,
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
    # 600-row cache; at D = 128 with yi's 4 kv heads and granite's 8, every
    # paged step their runs give the kernel: 8 and 16 slots behind a table
    # 1024 / 16 wide, the model calls' 8 behind one 512 / 16 wide (and yi's 8
    # with 64-row pages); at D = 96 the 8 slots with 16-row pages, and every
    # other instance untimed.  The planted fault
    # remaps one whole page inside each sequence's length to another
    # sequence's page.
    paged_cases = [(slots, 16, 64, 64, 8), (slots, 64, 16, 64, 8),
                   (slots.repeat(2), 16, 64, 64, 8),
                   (torch.tensor([600], dtype=torch.int32, device=dev), 16, 38, 64, 8),
                   (slots, 64, 16, 128, 4),
                   *((lengths, 16, NP, 128, h) for h in (4, 8)
                     for lengths, NP in ((slots, 64), (slots.repeat(2), 64), (granite, 32))),
                   (slots, 16, 64, 96, 8),
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
                  ((1024, 64, 64, 1), (3, 3, 1, 2), torch.int16),
                  # filters whose one-channel slab passes 227 KB beside the
                  # input rows: staged through shared memory in row slabs
                  # (2 of 68x68x8 f32, 2 of 90x90x8 int16); untimed (the plain
                  # version walks 4624 and 8100 taps)
                  ((1, 80, 140, 1), (68, 68, 1, 8), torch.float32),
                  ((1, 100, 160, 1), (90, 90, 1, 8), torch.int16),
                  # filters so tall that the ring's input rows alone pass
                  # 227 KB (200x200 f32: 454 KB): the input rows staged with
                  # each filter slab (2 and 3 slabs), two tiles down and
                  # across
                  ((2, 220, 270, 1), (200, 200, 1, 1), torch.float32),
                  ((2, 260, 310, 1), (240, 240, 1, 2), torch.int16)]
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
        if kh * kw > 64:
            rows_a_slab = conv_k.filter_rows(kh, kw, nf, x.element_size())
            if rows_a_slab == 0:      # the input rows in slabs too
                rows_a_slab = conv_k.slab_rows(kh, kw, nf, x.element_size())
                check["input_slabs"] = True
            check["filter_slabs"] = -(-kh // rows_a_slab)
            sets = None
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
    # The yardstick is the exact product (f64, cast to f32): at K = 2048 on
    # these O(1) operands torch's f32 product, the plain version, misses it
    # by more than the kernel does, past the 2e-4 limit at outputs near zero
    # on some draws (each row reads the plain version's miss beside the
    # kernel's, ``plain_max_abs_err_vs_exact``)
    for M in (256, 2048):
        per_set = 4 * 3 * M * M
        sets = [(torch.randn((M, M), generator=gen, device=dev),
                 torch.randn((M, M), generator=gen, device=dev)) for _ in range(n_sets(per_set))]
        x, w = sets[0]
        xf = x.clone()
        xf[:, 16:32] = 0
        for act in ((None, "silu", "gelu") if M == 256 else (None,)):
            want = exact_matmul(torch, x, w, act)
            check = role_err(torch, mm_k.matmul(x, w, activation=act), want,
                             mm_k.plain_matmul(xf, w, activation=act), TOL_ROLE_F32)
            check["plain_max_abs_err_vs_exact"] = float(
                (mm_k.plain_matmul(x, w, activation=act) - want).abs().max())
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
        check = role_err(torch, got, exact_matmul(torch, x, w), mm_k.plain_matmul(xf, w),
                         TOL_ROLE_F32)
        check["bitwise_equal_generic_kernel"] = True
        wf = fixed.weight
        record("matmul_fixed_weight", f"[{M},{M}]x[{M},{M}] fixed f32", check, sets,
               lambda a, b: fixed(a), lambda a, b: mm_k.plain_matmul(a, wf),
               lambda a, b: torch.matmul(a, wf), per_set, 3 * 2 * M ** 3, TF32_TC_FLOPS,
               f32_rate_flops=2 * M ** 3, instance=mm_k.kernel_instance(x, wf))
        del sets, x, w, xf, fixed, wf, got
    # MLA's decode wo: the f32 context [M, 16384] by the resident f32 copy of
    # wo [16384, 7168], at a first-token fixup's M = 1 and 8 slots' M = 8
    K, N = 16384, 7168
    w = torch.randn((K, N), generator=gen, device=dev) * K ** -0.5
    for M in (1, 8):
        x = torch.randn((M, K), generator=gen, device=dev)
        xf = drop_last_k_tile(x)
        check = role_err(torch, mm_k.matmul(x, w), mm_k.plain_matmul(x, w),
                         mm_k.plain_matmul(xf, w), TOL_ROLE_F32)
        record("matmul_f32", f"[{M},{K}]x[{K},{N}] act=None f32", check, [(x, w)],
               mm_k.matmul, mm_k.plain_matmul, torch.matmul,
               4 * (M * K + K * N + M * N), 3 * 2 * M * N * K, TF32_TC_FLOPS,
               f32_rate_flops=2 * M * N * K, instance=mm_k.kernel_instance(x, w))
        del x, xf
    del w

    # the matmul edge kernels (shapes and operands TMA cannot take) at the
    # untied unembeds' shapes: granite-3-8b, hymba-1.5b, whisper large-v3, at
    # M = 1 (the first-token fixup), 8 and 16 (decode steps): the streaming
    # edge kernel, bf16 in and f32 out as the unembed runs it, timed beside
    # the edge tile kernel on the same operands (previous_ms); at M = 8
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
                   previous=lambda a, b: mm_k.matmul_edge(
                       a, b, kernel=0, splits=mm_k.groups(N, K)[0], out_dtype=f32),
                   instance=mm_k.kernel_instance(x, w),
                   served_key=call_key("matmul", (x, w), {"out_dtype": f32}))
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
    print(f"  edge tile row invariance holds: {edge_tile_rows(torch, mm_k, gen, record)}")
    sample_rows(torch, gen, record)
    family_rows(torch, gen, record)
    internvl2_rows(torch, gen, record)
    width_rows(torch, gen, record)
    return rows, errs


def family_rows(torch, gen, record) -> None:
    """The kernels at every shape the families phase gives them, each
    against its plain version beside its planted fault and keyed by the
    call's shape (``served_key``, :func:`call_key`) for the summary's check:
    hymba-1.5b at its 8 prompts' lengths (5 .. 1400 rows) and decode steps
    of 8 slots (the bf16 matmuls, its in_proj [*,1600]x[1600,6482] on the
    edge kernels, rmsnorm at 1600 and the SSM block's 3200, flash attention
    under the 1024-key window, 25/5 heads of 64, decode attention over the
    1024-row ring, ssd at 50 heads of 64 with state 16), and
    whisper-large-v3's encoder over 8 x 1500 frames (12000 rows), its
    4-token prompt over them (32 rows; flash attention causal over 4 rows,
    non-causal over 1500) and decode steps of 8 (decode attention over 448
    self-attention rows and across to the 1500 memory rows, group 1).
    Timed beside the plain version, the library call and the bound: the
    decode steps' rows and the longest prefill's, the edge kernel's
    prefill rows (M > 16) beside ``torch.matmul``."""
    import torch.nn.functional as F

    from repro_torch.configs import get_arch
    from repro_torch.kernels import decode_attention as dec_k
    from repro_torch.kernels import flash_attention as fa_k
    from repro_torch.kernels import matmul as mm_k
    from repro_torch.kernels import rmsnorm as rms_k
    from repro_torch.kernels import ssd as ssd_k
    from repro_torch.models.model import cache_rows

    dev = torch.device("cuda")

    def randn(shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(torch.bfloat16)

    hymba, whisper = get_arch("hymba-1.5b"), get_arch("whisper-large-v3")
    enc_rows = WHISPER_BATCH * whisper.frontend_seq
    # (config, weight (K, N) pairs, row counts, the row counts timed)
    mm_cases = ((hymba, hybrid_kn(hymba), (8, *HYMBA_LENGTHS), (8, HYMBA_LENGTHS[-1])),
                (whisper, weight_kn(whisper), (8, WHISPER_BATCH * WHISPER_PROMPT, enc_rows),
                 (8, enc_rows)))
    for cfg, kn, row_counts, timed_rows in mm_cases:
        for K, N in sorted(set(kn)):
            edge = bool(K % 8 or N % 8)
            for M in row_counts:
                timed = M in timed_rows or (edge and M > mm_k.STREAM_MAX_M)
                sets = [(randn((M, K)), randn((K, N), K ** -0.5))
                        for _ in range(n_sets(2 * (M * K + K * N)) if timed else 1)]
                x, w = sets[0]
                for act in ((None, "silu") if N == cfg.d_ff else (None,)):
                    check = matmul_err(torch, mm_k.matmul(x, w, activation=act),
                                       mm_k.plain_matmul(x, w, activation=act),
                                       mm_k.matmul(drop_last_k_tile(x), w, activation=act),
                                       TOL_BF16)
                    record("matmul_edge" if edge else "matmul",
                           f"[{M},{K}]x[{K},{N}] act={act} out=bfloat16", check,
                           sets if timed and act is None else None,
                           lambda a, b, act=act: mm_k.matmul(a, b, activation=act),
                           lambda a, b, act=act: mm_k.plain_matmul(a, b, activation=act),
                           lambda a, b: torch.matmul(a, b),
                           2 * (M * K + K * N + M * N), 2 * M * N * K, BF16_TC_FLOPS,
                           instance=mm_k.kernel_instance(x, w),
                           served_key=call_key("matmul", (x, w), {"activation": act}))
                del sets, x, w

    # rmsnorm: hymba's d_model and the SSM block's gated norm over d_inner at
    # its rows, whisper's d_model at its
    norm_cases = [(R, D) for D in (hymba.d_model, hymba.ssm.d_inner(hymba.d_model))
                  for R in (8, *HYMBA_LENGTHS)]
    norm_cases += [(R, whisper.d_model) for R in (8, WHISPER_BATCH * WHISPER_PROMPT, enc_rows)]
    for R, D in norm_cases:
        timed = R in (8, HYMBA_LENGTHS[-1], enc_rows)
        sets = [(randn((R, D)), randn((D,))) for _ in range(n_sets(4 * R * D) if timed else 1)]
        check = max_err(torch, rms_k.rmsnorm(*sets[0]), rms_k.plain_rmsnorm(*sets[0]), TOL_BF16)
        record("rmsnorm", f"[{R},{D}]", check, sets if timed else None, rms_k.rmsnorm,
               rms_k.plain_rmsnorm, lambda x, w: F.rms_norm(x, (x.shape[-1],), w, 1e-6),
               2 * (2 * R * D + D), 4 * R * D, F32_FLOPS,
               served_key=call_key("rmsnorm", sets[0], {}))
        del sets

    # flash attention: hymba's windowed prefill at every prompt length;
    # whisper's encoder (1500 x 1500, non-causal), its prompt's causal self-
    # attention (4 x 4) and its cross-attention (4 over 1500).  The planted
    # fault drops keys 64..127 in the rows that see them all.
    D, win = hymba.head_dim, hymba.attn_window
    flash_cases = [(1, hymba.num_heads, hymba.num_kv_heads, S, S, True, win,
                    S in (HYMBA_LENGTHS[-1], 1000)) for S in HYMBA_LENGTHS]
    Hw, B, S4, Tm = whisper.num_heads, WHISPER_BATCH, WHISPER_PROMPT, whisper.frontend_seq
    flash_cases += [(B, Hw, Hw, Tm, Tm, False, None, True), (B, Hw, Hw, S4, S4, True, None, True),
                    (B, Hw, Hw, S4, Tm, False, None, True)]
    for B_, Hq, Hkv, S, T, causal, window, timed in flash_cases:
        per_set = 2 * B_ * (2 * Hq * S * D + 2 * Hkv * T * D)
        sound, dropped = flash_masks(torch, S, T, causal, dev, window)
        mask = sound if window else None
        sets = []
        for _ in range(n_sets(per_set) if timed else 1):
            q, k, v = randn((B_, Hq, S, D)), randn((B_, Hkv, T, D)), randn((B_, Hkv, T, D))
            sets.append((q, k, v, k.repeat_interleave(Hq // Hkv, 1),
                         v.repeat_interleave(Hq // Hkv, 1), mask))
        q, k, v = sets[0][:3]
        kw = dict(causal=causal, window=window)
        check = attention_err(torch, fa_k.flash_attention(q, k, v, **kw),
                              fa_k.plain_flash_attention(q, k, v, **kw),
                              masked_attention(torch, q, k, v, sound & ~dropped),
                              dropped.sum(dim=-1) == 64)
        check["splits"] = fa_k.split_kv(B_, Hq, S, T, causal, window, D)
        record("flash_attention", f"q[{B_},{Hq},{S},{D}] kv[{B_},{Hkv},{T},{D}] causal={causal}"
               + (f" window={window}" if window else ""), check, sets if timed else None,
               lambda q, k, v, ke, ve, m, kw=kw: fa_k.flash_attention(q, k, v, **kw),
               lambda q, k, v, ke, ve, m, kw=kw: fa_k.plain_flash_attention(q, k, v, **kw),
               lambda q, k, v, ke, ve, m, c=causal and S == T and not window:
                   F.scaled_dot_product_attention(q, ke, ve, attn_mask=m, is_causal=c),
               per_set, 4 * B_ * Hq * D * int(sound.sum()), BF16_TC_FLOPS,
               instance=f"fa_kernel<{fa_k.instance(D)},{fa_k.instance(D)}>",
               served_key=call_key("flash_attention", (q, k, v), kw))
        del sets, q, k, v

    # decode attention: hymba's step over the ring (lengths of the run's
    # prompts a step in, those past the window at its 1024 rows), whisper's
    # self-attention (448 rows, all 8 sequences at the run's mean position)
    # and its cross-attention (group 1 over the 1500 memory rows, a scalar
    # length, as the model passes it)
    ring = cache_rows(hymba, HYMBA_MAX_LEN)
    mid = WHISPER_PROMPT + WHISPER_NEW_TOKENS // 2
    dec_cases = [(hymba.num_heads, hymba.num_kv_heads, ring,
                  [min(n + 1, ring) for n in HYMBA_LENGTHS]),
                 (Hw, Hw, WHISPER_CACHE_LEN, [mid] * WHISPER_BATCH),
                 (Hw, Hw, whisper.frontend_seq, whisper.frontend_seq)]
    for Hq, Hkv, T, length in dec_cases:
        lengths = torch.tensor(length if isinstance(length, list) else [length] * WHISPER_BATCH,
                               dtype=torch.int32, device=dev)
        B_ = lengths.numel()
        valid, dropped = decode_masks(torch, lengths, T)
        sets = []
        for _ in range(n_sets(2 * 2 * B_ * Hkv * T * D)):
            q, kc, vc = randn((B_, Hq, D)), randn((B_, Hkv, T, D)), randn((B_, Hkv, T, D))
            sets.append((q, kc, vc, q[:, :, None], kc.repeat_interleave(Hq // Hkv, 1),
                         vc.repeat_interleave(Hq // Hkv, 1)))
        q, kc, vc = sets[0][:3]
        fault = masked_attention(torch, q[:, :, None], kc, vc, (valid & ~dropped)[:, None, None])
        check = attention_err(torch, dec_k.decode_attention(q, kc, vc, length),
                              dec_k.plain_decode_attention(q, kc, vc, lengths), fault[:, :, 0],
                              dropped.any(dim=-1)[:, None])
        check["splits"] = dec_k.last_splits
        n_keys = int(lengths.sum())
        shape = (f"q[{B_},{Hq},{D}] cache[{B_},{Hkv},{T},{D}] " + (
            f"length {length}" if isinstance(length, int)
            else f"lengths {int(lengths.min())}..{int(lengths.max())}"))
        record("decode_attention", shape, check, sets,
               lambda q, kc, vc, q4, ke, ve, n=length if isinstance(length, int) else lengths:
                   dec_k.decode_attention(q, kc, vc, n),
               lambda q, kc, vc, q4, ke, ve, n=lengths: dec_k.plain_decode_attention(q, kc, vc, n),
               lambda q, kc, vc, q4, ke, ve, m=valid: F.scaled_dot_product_attention(
                   q4, ke, ve, attn_mask=m[:, None, None, :]),
               2 * (2 * B_ * Hq * D + 2 * Hkv * n_keys * D), 4 * Hq * D * n_keys, BF16_TC_FLOPS,
               instance=f"dec_kernel<{D},DenseRows>",
               served_key=call_key("decode_attention", (q, kc), {}))
        del sets, q, kc, vc, fault

    # ssd at hymba's SSM heads: 50 of 64, state 16, one group, every prompt
    # length; timed at 5, 500 and 1400
    s = hymba.ssm
    H, P, N = s.num_heads(hymba.d_model), s.head_dim, s.state_dim
    for S in HYMBA_LENGTHS:
        timed = S in (5, 500, HYMBA_LENGTHS[-1])
        bytes_, flops = ssd_work(S, H=H, P=P, N=N)
        sets = [ssd_inputs(torch, S, gen, dev, H=H, P=P, N=N)
                for _ in range(n_sets(bytes_) if timed else 1)]
        args = sets[0]
        check = ssd_err(torch, ssd_k.ssd(*args, return_state=True),
                        ssd_k.plain_ssd(*args, return_state=True),
                        ssd_fault(torch, ssd_k.plain_ssd, *args, ssd_k.CHUNK))
        check["kernel_flops"] = ssd_kernel_work(S, H=H, P=P, N=N, q=ssd_k.CHUNK)
        record("ssd", f"x[1,{S},{H},{P}] b,c[1,{S},1,{N}]", check, sets if timed else None,
               lambda *a: ssd_k.ssd(*a, return_state=True),
               lambda *a: ssd_k.plain_ssd(*a, return_state=True), None,
               bytes_, 3 * flops, TF32_TC_FLOPS, f32_rate_flops=flops, instance="ssd_kernel",
               served_key=call_key("ssd", args, {}))
        del sets, args


def width_rows(torch, gen, record) -> None:
    """The inputs the Pallas kernels take that the CUDA kernels alone do not,
    which the wrappers route (no served config reaches them), each against
    its plain version beside its planted fault: flash attention at head
    dims 40 and 100 (zero-padded to 48 and 112), queries and keys of 208
    and 256 (the <256,128> instance), values of 200 (two 128-wide column
    blocks, a launch each); decode and paged attention at head dim 40 and
    at a query group of 20 (sub-groups of 16 and 4, a launch each); rmsnorm
    in fp8 (the f32 instance, cast).  Timed: flash at <256,128> and decode
    at the group of 20, beside SDPA."""
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as dec_k
    from repro_torch.kernels import flash_attention as fa_k
    from repro_torch.kernels import paged_decode_attention as paged_k
    from repro_torch.kernels import rmsnorm as rms_k
    from repro_torch.kernels.ref import gather_kv_pages

    dev = torch.device("cuda")

    def randn(shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(torch.bfloat16)

    S = T = 512
    for dqk, dv, causal in ((40, 40, True), (100, 100, False), (208, 208, True),
                            (256, 128, True), (64, 200, True)):
        timed = (dqk, dv) == (256, 128)
        per_set = 2 * (8 * S * dqk + 2 * T * dqk + 2 * T * dv + 8 * S * dv)
        sound, dropped = flash_masks(torch, S, T, causal, dev)
        sets = []
        for _ in range(n_sets(per_set) if timed else 1):
            q, k, v = randn((1, 8, S, dqk)), randn((1, 2, T, dqk)), randn((1, 2, T, dv))
            sets.append((q, k, v, k.repeat_interleave(4, 1), v.repeat_interleave(4, 1)))
        q, k, v = sets[0][:3]
        before = fa_k.launches
        got = fa_k.flash_attention(q, k, v, causal=causal)
        check = attention_err(torch, got, fa_k.plain_flash_attention(q, k, v, causal=causal),
                              masked_attention(torch, q, k, v, sound & ~dropped),
                              dropped.sum(dim=-1) == 64)
        check["launches"] = fa_k.launches - before
        pd, pv = fa_k.padded_width(dqk), fa_k.padded_width(dv)
        record("flash_attention", f"q[1,8,{S},{dqk}] k[1,2,{T},{dqk}] v[1,2,{T},{dv}] "
               f"causal={causal}", check, sets if timed else None,
               lambda q, k, v, ke, ve, c=causal: fa_k.flash_attention(q, k, v, causal=c),
               lambda q, k, v, ke, ve, c=causal: fa_k.plain_flash_attention(q, k, v, causal=c),
               lambda q, k, v, ke, ve, c=causal: F.scaled_dot_product_attention(
                   q, ke, ve, is_causal=c),
               per_set, 2 * 8 * (dqk + dv) * int(sound.sum()), BF16_TC_FLOPS,
               instance="fa_kernel<{},{}>".format(*fa_k.kernel_instance(pd, min(pv, 128))))
        del sets, q, k, v, got
    lengths = torch.tensor([1, 1024, 5, 600, 37, 256, 900, 64], dtype=torch.int32, device=dev)
    for D, Hq, Hkv in ((40, 32, 8), (64, 40, 2)):
        timed = Hq // Hkv > dec_k.MAX_GROUP
        valid, dropped = decode_masks(torch, lengths, 1024)
        sets = []
        for _ in range(n_sets(2 * 2 * 8 * Hkv * 1024 * D) if timed else 1):
            q, kc, vc = randn((8, Hq, D)), randn((8, Hkv, 1024, D)), randn((8, Hkv, 1024, D))
            sets.append((q, kc, vc, q[:, :, None], kc.repeat_interleave(Hq // Hkv, 1),
                         vc.repeat_interleave(Hq // Hkv, 1)))
        q, kc, vc = sets[0][:3]
        fault = masked_attention(torch, q[:, :, None], kc, vc, (valid & ~dropped)[:, None, None])
        before = dec_k.launches
        got = dec_k.decode_attention(q, kc, vc, lengths)
        check = attention_err(torch, got, dec_k.plain_decode_attention(q, kc, vc, lengths),
                              fault[:, :, 0], dropped.any(dim=-1)[:, None])
        check["launches"] = dec_k.launches - before
        n_keys = int(lengths.sum())
        record("decode_attention", f"q[8,{Hq},{D}] cache[8,{Hkv},1024,{D}] lengths 1..1024", check,
               sets if timed else None,
               lambda q, kc, vc, q4, ke, ve: dec_k.decode_attention(q, kc, vc, lengths),
               lambda q, kc, vc, q4, ke, ve: dec_k.plain_decode_attention(q, kc, vc, lengths),
               lambda q, kc, vc, q4, ke, ve, m=valid: F.scaled_dot_product_attention(
                   q4, ke, ve, attn_mask=m[:, None, None, :]),
               2 * (2 * 8 * Hq * D + 2 * Hkv * n_keys * D), 4 * Hq * D * n_keys, BF16_TC_FLOPS,
               instance=f"dec_kernel<{fa_k.padded_width(D)},DenseRows>")
        # paged: the same rows through a shuffled table of 16-row pages,
        # bitwise the dense kernel on the gathered cache
        P = 8 * 64 + 1
        kp, vp = randn((P, Hkv, 16, D)), randn((P, Hkv, 16, D))
        table = (torch.randperm(P - 1, generator=gen, device=dev)[:8 * 64] + 1).reshape(8, 64)
        table = table.to(torch.int32)
        faulted, touched = remap_one_page(table, lengths, 16)
        got = paged_k.paged_decode_attention(q, kp, vp, table, lengths)
        check = attention_err(torch, got,
                              paged_k.plain_paged_decode_attention(q, kp, vp, table, lengths),
                              paged_k.plain_paged_decode_attention(q, kp, vp, faulted, lengths),
                              touched[:, None])
        if not torch.equal(got, dec_k.decode_attention(q, gather_kv_pages(kp, table),
                                                       gather_kv_pages(vp, table), lengths)):
            raise AssertionError(f"paged kernel differs from the dense kernel on the gathered "
                                 f"cache at D {D}, {Hq}/{Hkv} heads")
        check["bitwise_equal_dense_kernel"] = True
        record("paged_decode_attention", f"q[8,{Hq},{D}] pool[{P},{Hkv},16,{D}] table[8,64] "
               f"lengths {lengths.tolist()}", check, None, None, None, None, 0, 0, BF16_TC_FLOPS,
               instance=f"dec_kernel<{fa_k.padded_width(D)},PagedRows>")
        del sets, q, kc, vc, fault, kp, vp, got
    for dtype, step in ((torch.float8_e4m3fn, 2.0 ** -3), (torch.float8_e5m2, 2.0 ** -2)):
        x = torch.randn((8, 2048), generator=gen, device=dev).to(dtype)
        w = (1 + torch.rand((2048,), generator=gen, device=dev)).to(dtype)
        got, want = rms_k.rmsnorm(x, w).float(), rms_k.plain_rmsnorm(x, w).float()
        # one fp8 step: the f32 sums part by an ulp, which the rounding may carry
        check = max_err(torch, got, want, (1e-6, step))
        record("rmsnorm", f"[8,2048] {str(dtype)[6:]}", check, None, None, None, None, 0, 0,
               F32_FLOPS)
        del x, w, got, want


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

    from repro_torch.kernels import sample as sample_k

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
    clear = sample_k.scores_apart(want_scores, SAMPLE_TIE_ULPS)
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


def sample_element_ops(sass: str) -> dict[str, int]:
    """The operations one element takes in the SASS text of the sampler's
    probe kernel (``cuobjdump --dump-sass -fun``): ``alu_only`` (shifts,
    logic, byte permutes: :data:`SAMPLE_ALU_ONLY`) and ``issued`` (every
    instruction but :data:`SAMPLE_NOT_OPS` and the uniform datapath's), and
    ``slots``: the larger of twice the first (the ALU pipe has half the
    issue rate) and the second, in issue slots at INT32_OPS."""
    alu = issued = 0
    for line in sass.splitlines():
        m = re.match(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if m is None:
            continue
        op = m.group(1)
        if op.startswith("U") or any(op == n or op.startswith(n + ".") for n in SAMPLE_NOT_OPS):
            continue
        issued += 1
        alu += op.split(".")[0] in SAMPLE_ALU_ONLY
    if not alu:
        raise AssertionError(f"no ALU operations in the sampler's probe: {sass[:2000]}")
    return {"alu_only": alu, "issued": issued, "slots": max(2 * alu, issued)}


def sample_sass(native) -> dict:
    """:func:`sample_element_ops` of the built sampler's probe; raises
    unless the library holds the four ``sample_kernel`` instances too."""
    path = native.build_all()["sample"]
    cuobjdump = Path(native._nvcc()).parent / "cuobjdump"
    out = subprocess.run([str(cuobjdump), "--dump-sass", str(path)], capture_output=True,
                         text=True, timeout=120, check=True).stdout
    probe, fn, instances = [], None, 0
    for line in out.splitlines():
        if "Function :" in line:
            fn = "probe" if "sample_bits_ops" in line else None
            instances += "sample_kernel" in line
        elif fn:
            probe.append(line)
    if not probe or instances != 4:
        raise AssertionError(f"the sampler's library holds {instances} sample_kernel instances "
                             f"(want 4) and {'a' if probe else 'no'} probe")
    return {"sample_bits_ops": sample_element_ops("\n".join(probe))}


def sample_winner_row(torch, sampling, sample_k, V: int, T: float, key, phase: int):
    """A row whose draw the pre-test must keep at its edge: the winner w is
    the element with the largest Gumbel draw, its l/T 15 below the row's
    maximum (the element with the smallest draw); a runner-up r in w's 16
    bytes (so the kernel tests w against r's lower bound) scores just below
    w, by half of w's distance above its bucket's lower end; the rest lie 40
    below.  Counts from 0 up until the draws allow that; ``phase``: floats
    of the row's start past a 16-byte boundary.  (logits f32 [V], the count,
    w)."""
    upper, lower = (t.to(key.device) for t in sample_k.gumbel_bounds())
    top = 10.0
    for count in range(1000):
        c = torch.tensor([count], dtype=torch.int32, device=key.device)
        bits = sampling.random_bits_32(sampling.fold_in(key[None], c), V)[0]
        g = -torch.log(-torch.log(sampling.uniform(bits)))
        w, a = int(g.argmax()), int(g.argmin())
        if float(g[w] - g[a]) < 15.5:
            continue
        rise = g - lower[sample_k.bucket_of(bits).long()]
        quad = [j for j in range((phase + w) // 4 * 4 - phase, (phase + w) // 4 * 4 - phase + 4)
                if 0 <= j < V and j not in (w, a)]
        if not quad:
            continue
        r = min(quad, key=lambda j: float(rise[j]))
        eps = float(rise[w] - rise[r]) / 2
        if eps < 1e-3:
            continue
        logits = torch.full((V,), (top / T - 40) * T, dtype=torch.float32, device=key.device)
        logits[a] = top
        logits[w] = (top / T - 15) * T
        logits[r] = (top / T - 15 + float(g[w]) - eps - float(g[r])) * T
        scores = sampling.scores(key[None], c, logits[None], T)[0]
        best = scores.topk(2).values
        lb, ub = sample_k.score_bounds(logits, bits, T, margin=False)
        if (int(scores.argmax()) == w and float(best[0] - best[1]) > 1e-4
                and float(ub[w]) < float(lb[r]) and float(logits[r]) < top):
            return logits, count, w
    raise AssertionError(f"no count below 1000 gives a pre-test row at V = {V}")


#: the adversarial rows of the sampler's check, in batch order
SAMPLE_ADVERSARIAL = ("winner", "nan", "two_inf", "all_neg_inf", "equal")


def sample_adversarial(torch, sampling, sample_k, V: int, T: float, gen, dev):
    """A batch of 8 rows at [8, V]: :data:`SAMPLE_ADVERSARIAL` (the winner
    row of :func:`sample_winner_row`; N(0, 2^2) logits with NaN at two
    places; with +inf at two places; all -inf; all equal), then 3 rows of
    N(0, 2^2).  (logits, keys, counts)."""
    B = 8
    logits = torch.randn((B, V), generator=gen, device=dev) * 2
    keys = torch.randint(-2**31, 2**31 - 1, (B, 2), generator=gen, device=dev,
                         dtype=torch.int32)
    counts = torch.randint(0, 1000, (B,), generator=gen, device=dev, dtype=torch.int32)
    j = sorted(torch.randperm(V, generator=gen, device=dev)[:2].tolist())
    logits[0], counts[0], _ = sample_winner_row(torch, sampling, sample_k, V, T, keys[0], 0)
    logits[1, j] = float("nan")
    logits[2, j] = float("inf")
    logits[3] = -float("inf")
    logits[4] = 1.0
    while int(sampling.scores(keys[4:5], counts[4:5], logits[4:5], T).argmax()) == 0:
        counts[4] += 1               # so that the fault (no Gumbel term: index 0) shows
    return logits, keys, counts


def sample_faults(torch, scores, logits, kernel_fault_tok) -> list:
    """The token a planted fault gives each adversarial row: the pre-test
    without its margin (the kernel's, ``kernel_fault_tok``), NaN ranked
    below numbers, the last index among equal maxima (twice), the logits
    alone without the Gumbel term."""
    last = scores.shape[-1] - 1 - torch.argmax(scores.flip(-1), dim=-1)
    return [int(kernel_fault_tok[0]),
            int(torch.argmax(torch.where(scores[1].isnan(), -float("inf"), scores[1]))),
            int(last[2]), int(last[3]), int(torch.argmax(logits[4]))]


def sample_adversarial_err(torch, tok, want, faults) -> dict:
    """The adversarial rows' check: every token exactly the plain version's
    (ties and NaN decide these rows, not the logs' last ulp), and each
    planted fault's token another."""
    n = len(SAMPLE_ADVERSARIAL)
    got, exp = tok[:n].tolist(), want[:n].tolist()
    if got != exp:
        raise AssertionError(f"sample tokens {got} on the adversarial rows "
                             f"{list(SAMPLE_ADVERSARIAL)}, the plain version's {exp}")
    seen = [f != w for f, w in zip(faults, exp)]
    if not all(seen):
        raise AssertionError(f"planted faults the adversarial rows cannot see: "
                             f"{[r for r, s in zip(SAMPLE_ADVERSARIAL, seen) if not s]}")
    return {"max_abs_err": 0.0, "tolerance": "adversarial rows: tokens exact",
            "rows": list(SAMPLE_ADVERSARIAL), "tokens": got, "planted_fault_tokens": faults}


def sample_rows(torch, gen, record) -> None:
    """The sampler at its served shapes, against its plain version and a
    numpy Threefry, beside a planted fault (one key word flipped); timed
    beside its plain version (no single PyTorch call draws JAX's stream).
    Then the adversarial rows (:func:`sample_adversarial`) at V = 128256 and
    at hymba's 32001 (rows off 16 bytes), in a batch of 8 at split counts 1,
    7, the rule's and 1024, and each alone at the rule's."""
    import numpy as np

    from repro_torch.kernels import native
    from repro_torch.kernels import sample as sample_k
    from repro_torch.serve import sampling

    dev = torch.device("cuda")
    T = 0.7
    ops = sample_sass(native)["sample_bits_ops"]
    for B, V in sample_k.SHAPES:
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
        bare = torch.zeros_like(tok)
        sample_k.sample(logits, keys, counts, live, bare, T)
        flipped = keys.clone()
        flipped[:, 0] ^= 1 << 7
        fault_bits = torch.zeros_like(bits)
        sample_k.sample(logits, flipped, counts, live, tok.clone(), T, bits=fault_bits)
        torch.cuda.synchronize()
        if not torch.equal(bare, tok):
            raise AssertionError(f"sample [{B},{V}]: tokens {bare.tolist()} without the bits "
                                 f"asked for, {tok.tolist()} with them")
        want_bits = sampling.random_bits_32(sampling.fold_in(keys, counts), V)
        np_want = np_bits(np, keys.cpu().numpy().view(np.uint32),
                          counts.cpu().numpy().astype(np.uint32), V)
        check = sample_err(torch, tok, bits, sampling.scores(keys, counts, logits, T), want_bits,
                           np_want, fault_bits)
        check["splits"] = sample_k.splits_for(B, V)
        check["pretest_survivors"] = int(sample_k.pretest(logits, want_bits, T).sum())
        check["element_ops"] = ops
        record("sample", f"[{B},{V}]", check, sets,
               lambda *a: sample_k.sample(*a, T), lambda *a: sampling.plain_sample(*a, T), None,
               4 * B * V + 6 * 4 * B, ops["slots"] * B * V, INT32_OPS)
        del sets, logits, bits, fault_bits, want_bits
    n = len(SAMPLE_ADVERSARIAL)
    for V in (128256, 32001):
        logits, keys, counts = sample_adversarial(torch, sampling, sample_k, V, T, gen, dev)
        live = torch.ones(8, dtype=torch.int32, device=dev)
        scores = sampling.scores(keys, counts, logits, T)
        want = torch.argmax(scores, dim=-1).to(torch.int32)
        want_bits = sampling.random_bits_32(sampling.fold_in(keys, counts), V)
        fault = torch.full((8,), -1, dtype=torch.int32, device=dev)
        sample_k.sample(logits, keys, counts, live, fault, T, margin=False)
        faults = sample_faults(torch, scores, logits, fault)
        split_counts = sorted({1, 7, sample_k.splits_for(8, V), sample_k.MAX_SPLITS})
        for splits in split_counts:
            for bits in (torch.zeros((8, V), dtype=torch.int32, device=dev), None):
                tok = torch.full((8,), -1, dtype=torch.int32, device=dev)
                sample_k.sample(logits, keys, counts, live, tok, T, bits=bits, splits=splits)
                sample_adversarial_err(torch, tok, want, faults)
                rest = sample_k.scores_apart(scores[n:], SAMPLE_TIE_ULPS)
                if not torch.equal(tok[n:][rest], want[n:][rest]):
                    raise AssertionError(f"sample: the N(0, 4) rows beside the adversarial ones "
                                         f"differ at {splits} splits")
                if bits is not None and not torch.equal(bits.long() & sampling.MASK, want_bits):
                    raise AssertionError(f"sample bits differ on the adversarial rows, V {V}")
        alone = torch.full((n,), -1, dtype=torch.int32, device=dev)
        for r in range(n):
            sample_k.sample(logits[r:r + 1], keys[r:r + 1], counts[r:r + 1], live[:1],
                            alone[r:r + 1], T)
        check = sample_adversarial_err(torch, alone, want, faults)
        check.update(split_counts=split_counts, alone_splits=sample_k.splits_for(1, V),
                     pretest_survivors=sample_k.pretest(logits, want_bits, T)[:n].sum(-1).tolist())
        record("sample", f"[8,{V}] adversarial rows", check, None, None, None, None, 0, 0,
               INT32_OPS)
        del logits, scores, want_bits


def sample_served(torch, logits_sets: list, T: float) -> dict:
    """The sampler on the decode logits a served run gave it (``[B, V]``
    each): held to its plain version (tokens where the two best scores lie
    more than SAMPLE_TIE_ULPS apart), timed beside it, with the pre-test's
    survivors (the row-wide model) and the bound of the kernel-phase rows."""
    from repro_torch.kernels import native
    from repro_torch.kernels import sample as sample_k
    from repro_torch.serve import sampling

    if not logits_sets:
        raise AssertionError("the served run gave the sampler no decode logits to time")
    B, V = logits_sets[0].shape
    dev = logits_sets[0].device
    gen = torch.Generator(device=dev).manual_seed(5)
    sets = []
    for logits in logits_sets:
        keys = torch.randint(-2**31, 2**31 - 1, (B, 2), generator=gen, device=dev,
                             dtype=torch.int32)
        counts = torch.randint(0, 1000, (B,), generator=gen, device=dev, dtype=torch.int32)
        sets.append((logits, keys, counts, torch.ones(B, dtype=torch.int32, device=dev),
                     torch.zeros(B, dtype=torch.int32, device=dev)))
    agree = survivors = compared = 0
    for logits, keys, counts, live, tok in sets:
        sample_k.sample(logits, keys, counts, live, tok, T)
        scores = sampling.scores(keys, counts, logits, T)
        clear = sample_k.scores_apart(scores, SAMPLE_TIE_ULPS)
        want = torch.argmax(scores, dim=-1).to(torch.int32)
        if not torch.equal(tok[clear], want[clear]):
            raise AssertionError(f"sample on served logits: tokens {tok.tolist()}, the plain "
                                 f"version's {want.tolist()}")
        agree += int(clear.sum())
        compared += B
        bits = sampling.random_bits_32(sampling.fold_in(keys, counts), V)
        survivors += int(sample_k.pretest(logits, bits, T).sum())
    ops = sample_sass(native)["sample_bits_ops"]
    row = {"name": "sample", "shape": f"[{B},{V}] served logits", "max_abs_err": 0.0,
           "tolerance": f"tokens exact where the best two scores lie > {SAMPLE_TIE_ULPS} ulps "
                        f"apart", "rows_compared": agree, "rows": compared,
           "splits": sample_k.splits_for(B, V), "steps": len(sets),
           "pretest_survivors_a_step": survivors / len(sets),
           "logits_std": float(torch.stack(logits_sets).std()),
           "logits_max_minus_median": float(
               (torch.stack(logits_sets).amax(-1) - torch.stack(logits_sets).median(-1).values)
               .mean())}
    row["ms"], row["host_ms"] = time_ms(torch, lambda *a: sample_k.sample(*a, T), sets)
    row["plain_ms"] = time_ms(torch, lambda *a: sampling.plain_sample(*a, T), sets)[0]
    row["library_ms"] = None
    row["bound_ms"], row["bound_by"] = bound(4 * B * V + 6 * 4 * B, ops["slots"] * B * V,
                                             INT32_OPS)
    print("  " + json.dumps(row))
    return row


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
    runs it, and in f32: M = 17 and 64 (the bf16 edge tile kernel at its
    :func:`edge_plan` tile; the f32 tile kernel's edge instance at 128²
    tiles); M = 8 and 16 with w 2 bytes (f32: 4 bytes) off a 16-byte
    boundary (the instances that copy w by ``cp.async``; bf16 timed beside
    the edge tile kernel on the same operands as previous_ms); f32 at M =
    16 on the aligned w (the f32
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
               previous=((lambda a, b: mm_k.matmul_edge(
                   a, b, kernel=0, splits=mm_k.groups(N, K)[0], out_dtype=f32))
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


def edge_tile_rows(torch, mm_k, gen, record) -> dict:
    """The edge tile kernel (M above 16) at hymba's in_proj shape [M, 1600]
    x [1600, 6482] beyond the rows the families phase gives it, each held
    to the plain version beside the planted fault (the last K slice
    dropped) and timed beside ``torch.matmul`` and the bound: ragged M =
    17, 127 and 129 (bf16 out; at 129 also silu and gelu), M = 200 with f32
    out, and the copies by ``cp.async`` at M = 200: K = 1601, w 2 bytes off
    a 16-byte boundary, x 2 bytes off; then a K of 4099 over N = 131 (13
    groups: K split one group a block), held untimed.  Last, row
    invariance: a row's bits in launches of 17, 200 and 1400 rows, and
    under a permutation of 1400, at the in_proj shape.  Returns the
    invariance check's record."""
    dev, f32 = torch.device("cuda"), torch.float32

    def randn(shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(torch.bfloat16)

    def row(x, w, note="", act=None, out_dtype=None, timed=True):
        M, K, N = x.shape[0], x.shape[1], w.shape[1]
        out = out_dtype or torch.bfloat16
        tol = TOL_F32 if out == f32 else TOL_BF16
        check = matmul_err(torch, mm_k.matmul(x, w, activation=act, out_dtype=out),
                           mm_k.plain_matmul(x, w, activation=act, out_dtype=out),
                           mm_k.matmul(drop_last_k_tile(x), w, activation=act, out_dtype=out),
                           tol)
        check["plan"] = list(mm_k.edge_plan(M, N, K, w.data_ptr() % 16 == 0))
        record("matmul_edge", f"[{M},{K}]x[{K},{N}] act={act} out={str(out)[6:]}{note}", check,
               [(x, w)] if timed else None,
               lambda a, b: mm_k.matmul(a, b, activation=act, out_dtype=out),
               lambda a, b: mm_k.plain_matmul(a, b, activation=act, out_dtype=out),
               lambda a, b: torch.matmul(a, b),
               2 * (M * K + K * N) + (4 if out == f32 else 2) * M * N, 2 * M * N * K,
               BF16_TC_FLOPS, instance=mm_k.kernel_instance(x, w))

    K, N = 1600, 6482
    w = randn((K, N), K ** -0.5)
    for M in (17, 127, 129):
        x = randn((M, K))
        row(x, w)
        if M == 129:
            row(x, w, act="silu", timed=False)
            row(x, w, act="gelu", timed=False)
    x = randn((200, K))
    row(x, w, out_dtype=f32)
    row(offset_copy(torch, x), w, " x 2 bytes off 16-byte alignment")
    row(x, offset_copy(torch, w), " w 2 bytes off 16-byte alignment")
    row(randn((200, K + 1)), randn((K + 1, N), K ** -0.5))
    row(randn((200, 4099)), randn((4099, 131), 4099 ** -0.5), timed=False)
    x = randn((1400, K))
    perm = torch.randperm(1400, generator=gen, device=dev)
    res = row_invariance(torch, mm_k.matmul, x, w, perm, rows=(17, 200))
    return {**res, "N": N, "groups": list(mm_k.groups(N, K)),
            "instances": sorted({mm_k.kernel_instance(x[:m], w) for m in (17, 200, 1400)})}


#: the edge tile kernel's instances (M above 16), which every run must hold
EDGE_TILE_INSTANCES = ("mm_edge_tile_kernel<128>", "mm_edge_tile_kernel<64>")


def check_instances(rows: list[dict], sass: dict) -> set[str]:
    """Raise unless every instance built of the matmul, decode attention
    and ssd kernels (the ones ``cuobjdump`` lists, and the edge tile
    kernel's) ran in some kernel-phase row, held against the plain version;
    the instances run."""
    ran = {r["instance"] for r in rows if "instance" in r}
    built = {fn for lib in ("matmul", "matmul_edge", "matmul_f32", "decode_attention", "ssd")
             for fn in sass.get(lib, {})}
    missing = (built | set(EDGE_TILE_INSTANCES)) - ran
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
    fixups = set(prompt_lengths) | set(CALL_LENGTHS)
    # hymba's ring and whisper's self-attention and memory rows too
    return {"decode_attention": {dec_k.split_kv(T) for T in (1024, 512, 256, WHISPER_CACHE_LEN,
                                                             1500)}
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


def weight_kn(cfg) -> list[tuple[int, int]]:
    """The (K, N) of a dense GQA layer's seven matmuls (wq, wk, wv, wo, the
    MLP's gate, up and down)."""
    d, q, kv = cfg.d_model, cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    return [(d, q), (d, kv), (d, kv), (q, d), (d, cfg.d_ff), (d, cfg.d_ff), (cfg.d_ff, d)]


def served_shapes(cfg, lengths, *, slots: int, max_len: int, paged: bool = False,
                  page_size: int = 16, chunk: int | None = None,
                  shared_rows: int | None = None) -> set[tuple]:
    """The shapes a dense attention model's engine calls give its kernels,
    as keys (kernel, dims...) that :func:`row_shape_key` reads off the
    kernel phase's rows: each prompt of ``lengths`` prefilled at its bucket
    (whole, or in ``chunk``-row chunks against the keys up to each chunk's
    end), its first-token fixup (one sequence against its n rows) where the
    bucket pads it, and decode steps of ``slots`` sequences against
    ``max_len`` rows (dense) or a table of ``max_len / page_size`` pages.
    Every call normalises its rows (and one row before the unembed, which
    takes the last row of a prefill or chunk, a fixup's, or a decode
    step's ``slots``).  With ``shared_rows``, a prompt long enough to share
    that many rows of a resident prefix is also prefilled from there: its
    suffix whole (one chunk of the rest of its bucket) or in chunks."""
    from repro_torch.serve.engine import ServeEngine

    buckets = {ServeEngine.bucket_len(n, max_len) for n in lengths}
    fixups = {n for n in lengths if ServeEngine.bucket_len(n, max_len) > n}
    starts = {(b, 0) for b in buckets}
    if shared_rows:
        starts |= {(ServeEngine.bucket_len(n, max_len), shared_rows) for n in lengths
                   if (n - 1) // page_size * page_size >= shared_rows}
    rows, attn = {slots, 1}, set()
    for b, first in starts:
        step = chunk or b - first
        for start in range(first, b, step):
            size = min(step, b - start)
            rows.add(size)
            attn.add((size, start + size))
    hkv, hd = cfg.num_kv_heads, cfg.head_dim
    keys = {("matmul", M, K, N) for M in rows for K, N in weight_kn(cfg)}
    if not cfg.tie_embeddings:
        keys |= {("matmul", M, cfg.d_model, cfg.vocab_size) for M in (1, slots)}
    keys |= {("rmsnorm", R, cfg.d_model) for R in rows}
    keys |= {("flash_attention", S, T, hkv, hd) for S, T in attn}
    keys.add(("paged_decode_attention", slots, hkv, page_size, max_len // page_size, hd)
             if paged else ("decode_attention", slots, hkv, max_len, hd))
    keys |= {("decode_attention", 1, hkv, n, hd) for n in fixups}
    return keys


#: a kernel-phase row's shape string -> its key in :func:`served_shapes`
ROW_SHAPE_KEYS = {
    "matmul": re.compile(r"^\[(\d+),(\d+)\]x\[\d+,(\d+)\] act=None out=(?:bfloat16|float32)$"),
    "rmsnorm": re.compile(r"^\[(\d+),(\d+)\]$"),
    "flash_attention": re.compile(r"^q\[1,\d+,(\d+),(\d+)\] kv\[1,(\d+),(\d+),\d+\] "
                                  r"causal=True$"),
    "decode_attention": re.compile(r"^q\[(\d+),\d+,(\d+)\] cache\[\d+,(\d+),(\d+),\d+\] "),
    "paged_decode_attention": re.compile(r"^q\[(\d+),\d+,(\d+)\] pool\[\d+,(\d+),(\d+),\d+\] "
                                         r"table\[\d+,(\d+)\] "),
}


def row_shape_key(row: dict) -> tuple | None:
    """The :func:`served_shapes` key of a kernel-phase row (bf16 operands;
    flash attention causal and unwindowed), or None."""
    name = "matmul" if row["name"] == "matmul_edge" else row["name"]
    pattern = ROW_SHAPE_KEYS.get(name)
    m = pattern.match(row["shape"]) if pattern else None
    if m is None:
        return None
    v = [int(g) for g in m.groups()]
    if name == "flash_attention":          # q rows S, head_dim, kv heads, keys T
        return (name, v[0], v[3], v[2], v[1])
    if name == "decode_attention":         # B, head_dim, kv heads, T
        return (name, v[0], v[2], v[3], v[1])
    if name == "paged_decode_attention":   # B, head_dim, kv heads, page rows, pages
        return (name, v[0], v[2], v[3], v[4], v[1])
    return (name, *v)


def check_served_shapes(rows: list[dict], runs) -> dict:
    """Raise unless every shape a run of ``runs`` gave a kernel (their
    ``kernel_shapes``) has a kernel-phase row held against the plain
    version; the count of shapes by kernel."""
    served = {tuple(key) for r in runs for key in r["kernel_shapes"]}
    ran = {row_shape_key(r) for r in rows}
    missing = sorted(served - ran)
    if not served or missing:
        raise AssertionError(f"shapes the full-depth runs gave the kernels that no row held "
                             f"against the plain version: {missing}")
    counts: dict[str, int] = {}
    for key in served:
        counts[key[0]] = counts.get(key[0], 0) + 1
    return counts


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


def unembed_launches(cfg) -> tuple[int, int]:
    """(bf16 kernel, edge kernel) launches a model call's unembed makes: a
    tied table is a plain f32 product (none); an untied one the bf16
    kernel where TMA takes its N (a multiple of 8, yi's 64000), else the
    edge kernel (granite's 49155)."""
    if cfg.tie_embeddings:
        return 0, 0
    return (1, 0) if cfg.vocab_size % 8 == 0 else (0, 1)


def model_calls_phase(torch, model, params, kernels, seed: int) -> dict:
    """A dense model with heads of 128 and an untied unembed (yi's or
    granite's), weights from ``seed``, under cuda-strict against the torch
    eager source on the same weights, on the calls an engine of 8 slots and
    ``max_len`` 512 makes: each of 8 prompts prefilled at its bucket (8 ..
    512), its first-token fixup against the cache cut to the prompt, one
    decode step of the 8 as a batch (over the dense cache, and over a pool
    of 16-row pages behind a shuffled table, whose logits must equal the
    dense step's bit for bit) and a 512-token prompt in four 128-row chunks
    through a staging cache and through a page pool (bitwise equal; the last
    chunk is flash attention of S = 128 against T = 512).  Logits within
    MODEL_REL_L2_TOL of the torch source's.  The cuda-strict pass's
    launches are counted from 0 and must equal what its calls imply: flash,
    decode and paged attention at D = 128 each run, and the unembed's
    kernel once a call (:func:`unembed_launches`)."""
    from repro_torch.core import dispatch
    from repro_torch.kernels import matmul as mm_k
    from repro_torch.serve.engine import ServeEngine

    dev, cfg = model.device, model.cfg
    vocab, L = cfg.vocab_size, cfg.num_layers
    max_len, ps, chunk = 512, 16, 128
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 5)
    lengths = CALL_LENGTHS
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
            raise AssertionError(f"{cfg.name}: {a} logits differ from {b} logits under "
                                 f"cuda-strict")
    res = {"arch": cfg.name, "layers": L, "prompt_lengths": list(lengths), "buckets": buckets,
           "tolerance_rel_l2": MODEL_REL_L2_TOL, "paged_equal_dense_bitwise": True,
           "kernel_shapes": sorted(
               served_shapes(cfg, lengths, slots=B, max_len=max_len)
               | served_shapes(cfg, [max_len], slots=B, max_len=max_len, paged=True,
                               page_size=ps, chunk=chunk))}
    for kind in got:
        rel, agree = [], 0
        for ref, g in zip(out["torch"][kind], strict[kind]):
            ref, g = ref.float(), g.float()
            if not torch.isfinite(g).all() or g.shape != (vocab,):
                raise AssertionError(f"{cfg.name} {kind} logits of shape {tuple(g.shape)}, or "
                                     f"not finite")
            rel.append(float((g - ref).norm() / ref.norm()))
            agree += int(g.argmax() == ref.argmax())
        res[kind] = {"rel_l2": rel, "top1_agree": f"{agree} of {len(rel)}"}
    # one unembed a model call; 7 matmuls and 2 norms a layer, the final norm
    calls = len(lengths) + len(got["fixup"]) + 2 + 2 * max_len // chunk
    bf16_unembed, edge_unembed = unembed_launches(cfg)
    want = {"matmul": (7 * L + bf16_unembed) * calls, "rmsnorm": (2 * L + 1) * calls,
            "flash_attention": L * (len(lengths) + 2 * max_len // chunk),
            "decode_attention": L * (len(got["fixup"]) + 1), "paged_decode_attention": L,
            "ssd": 0, "sample": 0, "matmul_edge": edge_unembed * calls}
    res["launches"] = launches
    print("  " + json.dumps(res))
    if launches != want:
        raise AssertionError(f"{cfg.name}: kernel launches {launches}, expected {want}")
    worst = max(max(res[kind]["rel_l2"]) for kind in got)
    if worst > MODEL_REL_L2_TOL or len(got["fixup"]) != len(lengths):
        raise AssertionError(f"{cfg.name}: cuda-strict logits differ from the torch source: "
                             f"{res}")
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
    decode attention, and decode steps dense or paged decode attention; an
    untied unembed runs the bf16 or the edge matmul once a call
    (:func:`unembed_launches`).
    Mamba-2: every call runs 2 matmuls (in_proj, out_proj) and 2 norms (ln1,
    the gated norm) a layer and the final norm; prefills run ssd in every
    layer, decode steps none (their single-token update is eager).  A tied
    unembed is a plain f32 product, not a kernel.  At a temperature above 0
    the sampler runs once for each first token and each decode step
    (``sample_calls``).  A decode step counts alike whether it ran eagerly or
    as a graph's replay: a replay adds the captured step's launches."""
    L = cfg.num_layers
    calls = eng.prefill_calls + eng.chunk_calls + eng.fixup_calls + eng.decode_calls
    if cfg.family == "ssm":
        return {"matmul": 2 * L * calls, "rmsnorm": (2 * L + 1) * calls, "flash_attention": 0,
                "decode_attention": 0, "paged_decode_attention": 0,
                "ssd": L * eng.prefill_calls, "sample": eng.sample_calls, "matmul_edge": 0}
    if cfg.family == "hybrid":
        return hybrid_launches(cfg, prefills=eng.prefill_calls,
                               decodes=eng.fixup_calls + eng.decode_calls,
                               samples=eng.sample_calls)
    if cfg.moe is not None:
        return moe_launches(eng.model, prefills=eng.prefill_calls + eng.chunk_calls,
                            fixups=eng.fixup_calls, decodes=eng.decode_calls,
                            paged=eng.paged, samples=eng.sample_calls)
    bf16_unembed, edge_unembed = unembed_launches(cfg)
    return {"matmul": (7 * L + bf16_unembed) * calls, "rmsnorm": (2 * L + 1) * calls,
            "flash_attention": L * (eng.prefill_calls + eng.chunk_calls),
            "decode_attention": L * (eng.fixup_calls + (0 if eng.paged else eng.decode_calls)),
            "paged_decode_attention": L * eng.decode_calls if eng.paged else 0, "ssd": 0,
            "sample": eng.sample_calls, "matmul_edge": edge_unembed * calls}


def serve_run(torch, model, params, kernels, prompts, before_step=None, graphed=True,
              new_tokens: int = 32, after_step=None, allow_failed: bool = False,
              shared_rows: int | None = None, check_launches: bool = True, arrivals=None,
              policy: str = "cuda-strict", **engine_kw):
    """Serve ``prompts`` (``new_tokens`` each) through one engine under
    ``policy`` (cuda-strict unless given: an MLA model runs under cuda,
    its decode attention plain PyTorch); the run's numbers and the token
    streams in submission order.  The kernels' launch
    counts (and the edge matmul's) are set to 0 just before the run and read
    just after it.  ``before_step(i)``, if given, runs before the engine's
    step ``i`` (another tenant's submissions); ``after_step(eng)`` after each
    step (checks, and preemptions from outside).  ``graphed=False`` runs the
    decode steps as the eager loop (a comparison arm: the engine serves
    through graphs).  A paged run's numbers hold the engine's preemption
    and host-tier counters, and its fault, integrity and prefix counters.
    With ``allow_failed`` requests killed by faults may end the run (their
    streams are left out; the numbers name them); ``shared_rows`` adds the
    kernel shapes of suffix prefills after that many shared prompt rows.
    ``check_launches=False`` leaves out the launch check (a run on the CPU
    through the kernels' plain versions, which count nothing).
    ``arrivals`` (nondecreasing, one a prompt) is the step before which
    each prompt is submitted (all before the first, by default)."""
    from repro_torch.core import dispatch
    from repro_torch.core.policy import ChunkPolicy
    from repro_torch.kernels import matmul as mm_k
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.paged import pool_token_bytes

    cuda = model.device.type == "cuda"
    with dispatch.use(prefer=dispatch.policy_from_flag(policy)):
        engine_kw.setdefault("max_len", 1024)
        eng = ServeEngine(model, params, device=model.device, **engine_kw)
        if not graphed:
            # the eager loop on the card, for the graph-against-loop
            # comparison only: no public knob turns graphs off
            eng._graphed = False
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        for mod in kernels:
            mod.launches = 0
        mm_k.edge_launches = mm_k.f32_launches = 0
        arrivals = list(arrivals) if arrivals is not None else [0] * len(prompts)
        if arrivals != sorted(arrivals) or len(arrivals) != len(prompts):
            raise ValueError(f"arrivals {arrivals} must be one a prompt, nondecreasing")
        waiting = list(zip(arrivals, prompts))
        done, decode_s, decode_tok, decode_steps, t0 = [], 0.0, 0, 0, time.perf_counter()
        for step in range(4000):
            while waiting and waiting[0][0] <= step:
                eng.submit(waiting.pop(0)[1], max_new_tokens=new_tokens)
            if before_step is not None:
                before_step(step)
            calls = eng.prefill_calls + eng.chunk_calls
            toks, ts = eng.decode_tokens, time.perf_counter()
            done += eng.step()        # every step ends reading tokens back to the host
            if eng.prefill_calls + eng.chunk_calls == calls and eng.decode_tokens > toks:
                decode_s += time.perf_counter() - ts
                decode_tok += eng.decode_tokens - toks
                decode_steps += 1
            if after_step is not None:
                after_step(eng)
            if len(done) == len(prompts) or (
                    allow_failed and not (waiting or eng._active or eng._prefilling
                                          or eng._queue or eng._parked)):
                break
        wall = time.perf_counter() - t0
        launches = {mod.__name__.rsplit(".", 1)[1]: mod.launches for mod in kernels}
        launches["matmul_edge"] = mm_k.edge_launches
        if model.cfg.mla is not None:   # MLA's decode wo: the f32 kernel
            launches["matmul_f32"] = mm_k.f32_launches
    peak = torch.cuda.max_memory_allocated() if cuda else None
    vocab = model.cfg.vocab_size
    failed = sorted(r.uid for r in eng.failed_requests)
    if len(done) + len(failed) != len(prompts) or (failed and not allow_failed):
        raise AssertionError(f"{len(done)} of {len(prompts)} requests completed, "
                             f"{len(failed)} failed")
    for r in done:
        if len(r.generated) != new_tokens or not all(0 <= t < vocab for t in r.generated):
            raise AssertionError(f"request {r.uid}: bad tokens {r.generated}")
    want = expected_launches(eng, model.cfg)
    if check_launches and launches != want:
        raise AssertionError(f"kernel launches {launches}, expected {want} from the engine's "
                             f"{eng.prefill_calls} prefills, {eng.chunk_calls} chunks, "
                             f"{eng.fixup_calls} fixups and {eng.decode_calls} decode steps")
    if check_launches and any(launches[n] == 0 for n, v in want.items() if v):
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
           "requests": len(done), "new_tokens_each": new_tokens,
           "prefill_calls": eng.prefill_calls, "chunk_calls": eng.chunk_calls,
           "fixup_calls": eng.fixup_calls, "decode_calls": eng.decode_calls,
           "launches": launches,
           "ttft_mean_s": sum(ttft) / len(ttft),
           "ttft_p99_s": ttft[min(len(ttft) - 1, math.ceil(0.99 * len(ttft)) - 1)],
           "ttft_by_request_s": [r.first_token_t - r.arrival_t
                                 for r in sorted(done, key=lambda r: r.uid)],
           "decode_tokens_per_s": decode_tok / decode_s if decode_s else None,
           "decode_tokens": decode_tok, "decode_step_s": decode_s / decode_steps
           if decode_steps else None, "wall_s": wall, "max_memory_allocated_bytes": peak,
           ("state_bytes" if model.cfg.family == "ssm" else "kv_bytes"): cache_bytes,
           "peak_concurrency": eng.peak_concurrency,
           "sustained_concurrency": eng.concurrency_stats()["sustained"],
           # KV bytes the pool held mapped at its high-water mark (paged runs)
           "kv_high_water_bytes": (eng.allocator.stats().high_water * eng.page_size
                                   * pool_token_bytes(eng._cache)) if eng.paged else None}
    chunk = engine_kw.get("prefill_chunk")
    if (model.cfg.family not in ("ssm", "hybrid") and model.cfg.moe is None
            and not isinstance(chunk, ChunkPolicy)):
        res["kernel_shapes"] = sorted(served_shapes(
            model.cfg, [len(p) for p in prompts], slots=eng.slots, max_len=eng.max_len,
            paged=eng.paged, page_size=eng.page_size, chunk=chunk, shared_rows=shared_rows))
    if eng.paged:
        res["pool_pages"] = eng.pool_pages
        res["tier"] = {k: getattr(eng, k) for k in (
            "preemptions", "resumes", "recompute_tokens", "pages_reclaimed", "spills",
            "refills", "demotions", "replay_fallback_tokens")}
        res["tier"]["host_peak_bytes"] = eng.arena.peak_bytes
        res["tier"]["block_bytes"] = eng.arena.block_bytes
        res["tier"]["free_pages"] = eng.allocator.free_pages
        res["tier"]["total_pages"] = eng.allocator.total_pages
        res["tier"]["arena_entries"] = len(eng.arena.entries())
        res["tier"]["copies"] = eng.copy_stats
        res["tier"]["refill_cancels"] = eng._xfer.cancelled
        # the transfer engine's priced timeline: bytes over its bandwidth
        res["tier"]["priced_s"] = eng._xfer.bytes_moved / eng._xfer.bandwidth_bytes_s
        if eng.ledger is not None:
            split = eng.ledger.overcommit_split()
            res["tier"]["snapshot_resumes"] = split["snapshot_resumes"]
            res["tier"]["reprefill_resumes"] = split["reprefill_resumes"]
            res["tier"]["demoted_bytes"] = eng.ledger.spill_split()["demoted_bytes"]
        # fault recovery, integrity and prefix sharing: every count follows
        # from the schedule (the prompts' lengths and tokens), so a run of
        # the engine on the CPU at the same lengths gives the same
        res["recovery"] = {
            **{k: getattr(eng, k) for k in (
                "transfer_faults", "corruptions_injected", "corruptions_detected",
                "pages_quarantined", "escaped_corruptions", "scrubbed_targets",
                "prefix_lookups", "prefix_hits", "prefix_pages_saved", "cow_copies")},
            "failed": failed, "quarantined": eng.allocator.quarantined_pages,
            "fault_recoveries": [r.fault_recoveries for r in sorted(done, key=lambda r: r.uid)]}
        res["verify"] = dict(eng.verify_stats)
        if eng.ledger is not None:
            res["splits"] = {name: {k: v for k, v in getattr(eng.ledger, name)().items()
                                    if not k.endswith(("_s", "_frac"))}
                             for name in ("availability_split", "integrity_split",
                                          "prefix_split")}
    return res, [r.generated for r in sorted(done, key=lambda r: r.uid)]


def serve_prompts(torch, vocab: int, seed: int) -> tuple[list[int], list[list[int]]]:
    """The serve runs' 16 prompts: 5 to 600 tokens, evenly spaced, drawn
    from ``seed`` in the model's vocabulary."""
    rng = torch.Generator().manual_seed(seed + 2)
    lengths = list(SERVE_LENGTHS)
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
# phases 6 and 7: yi-6b, granite-3-8b and yi-9b at full depth; overcommit
# ---------------------------------------------------------------------------

#: the full-depth phase's runs of the 16 serve prompts: SERVE_RUNS' three
#: (streams equal to the dense graph's), then T = 0.7 (seed 3) at K = 4,
#: dense 8 slots and paged chunked 16 slots (streams equal to each other)
FULL_DEPTH_RUNS = SERVE_RUNS + (
    ("t0.7_dense_k4", {"batch_slots": 8, "temperature": 0.7, "seed": 3, "decode_fusion": 4}),
    ("t0.7_chunked_k4", {**dict(SERVE_RUNS)["paged_chunked"], "temperature": 0.7, "seed": 3,
                         "decode_fusion": 4}),
)
#: run -> the run whose streams it must equal
FULL_DEPTH_EQUAL = {"paged": "dense", "paged_chunked": "dense",
                    "t0.7_chunked_k4": "t0.7_dense_k4"}


def weight_bytes(params) -> int:
    """Bytes of every tensor in a parameter tree."""
    total, todo = 0, [params]
    while todo:
        node = todo.pop()
        if isinstance(node, dict):
            todo.extend(node.values())
        elif isinstance(node, (list, tuple)):
            todo.extend(node)
        else:
            total += node.numel() * node.element_size()
    return total


def full_depth_phase(torch, model, params, kernels, seed: int, card: str, smi: str, *,
                     prompts=None) -> dict:
    """One dense config at its full depth, weights from ``seed``: the model
    calls against the torch source (:func:`model_calls_phase`), then the 16
    serve prompts (or ``prompts``) through FULL_DEPTH_RUNS under cuda-strict, each run's
    launches checked against its model calls and its streams against
    FULL_DEPTH_EQUAL's (16 of 16).  Prints the weights' bytes, peak device
    memory, TTFT and the dense graph run's decode tokens/s beside the bound
    the weights set: a graphed step reads every weight once, so a step
    takes at least weights / 3.35 TB/s (and the embedding table's rows but
    B of them are never read: the bound without it beside)."""
    cfg = model.cfg
    wbytes = weight_bytes(params)
    table = params["embed"]["tok"]
    read_bytes = wbytes - table.numel() * table.element_size()
    calls = model_calls_phase(torch, model, params, kernels, seed)
    if prompts is None:
        prompts = serve_prompts(torch, cfg.vocab_size, seed)[1]
    lengths = [len(p) for p in prompts]
    runs, streams = {}, {}
    for name, kw in FULL_DEPTH_RUNS:
        runs[name], streams[name] = serve_run(torch, model, params, kernels, prompts, **kw)
        print("  " + json.dumps({"arch": cfg.name, "run": name, **runs[name]}))
    for name, want in FULL_DEPTH_EQUAL.items():
        differ = [i for i, (a, b) in enumerate(zip(streams[name], streams[want])) if a != b]
        if differ:
            raise AssertionError(f"{cfg.name}: {name} streams differ from {want} streams in "
                                 f"requests {differ} (prompt lengths "
                                 f"{[lengths[i] for i in differ]})")
    dense = runs["dense"]
    bound_s = wbytes / HBM_BYTES_S
    summary = {
        "arch": cfg.name, "layers": cfg.num_layers, "weights_bytes": wbytes,
        "weights_gb": wbytes / 1e9, "step_bound_ms": bound_s * 1e3,
        "step_bound_without_embedding_table_ms": read_bytes / HBM_BYTES_S * 1e3,
        "decode_tokens_per_s_bound_8_slots": 8 / bound_s,
        "decode_tokens_per_s": dense["decode_tokens_per_s"],
        "ttft_mean_s": dense["ttft_mean_s"], "ttft_p99_s": dense["ttft_p99_s"],
        "peak_memory_bytes": max(r["max_memory_allocated_bytes"] or 0 for r in runs.values()),
        "streams_equal": {name: f"16 of 16 equal {want}"
                          for name, want in FULL_DEPTH_EQUAL.items()},
        "card": card, "nvidia_smi": smi}
    print(f"  {cfg.name} at {cfg.num_layers} layers on {card} ({smi}): weights "
          f"{summary['weights_gb']} GB; peak device memory {summary['peak_memory_bytes']} bytes; "
          f"dense graph run: TTFT mean {dense['ttft_mean_s']} s, p99 {dense['ttft_p99_s']} s, "
          f"decode {dense['decode_tokens_per_s']} tokens/s against the weights' bound of "
          f"{summary['decode_tokens_per_s_bound_8_slots']} tokens/s at 8 slots "
          f"({summary['step_bound_ms']} ms a step)")
    return {"calls": calls, "runs": runs, "summary": summary, "prompt_lengths": lengths}


#: the overcommit phase: 128 new tokens a request (8 pages of growth), 8
#: slots of 16-row pages behind a pool of 96 pages and the scratch page, a
#: sixth of the dense footprint's 8 x 1024 / 16 + 1 = 513.  At half (257)
#: the 8 slots bind first and the pool never runs dry (no preemption, in a
#: run of the engine on the CPU: the schedule follows from the lengths alone)
OVERCOMMIT_NEW_TOKENS = 128
OVERCOMMIT_POOL_PAGES = 97
#: a victim with at least this many cached rows snapshots, a shorter one
#: replays: the pool's victims hold about 330 to 550 rows, so both come
OVERCOMMIT_SNAPSHOT_TOKENS = 384
#: the churn arm's external pressure, drawn after each of its first
#: CHURN_STEPS steps as tests/test_preemption.py draws it (then the run
#: drains, as that test's run_to_completion does): preempt a live request,
#: resume a parked one.  Drawn for the whole run, a request resumed by
#: re-prefill is preempted again before it regenerates 128 tokens: the run
#: never ends (so it went in a rehearsal on the CPU)
CHURN_PREEMPT_P, CHURN_RESUME_P, CHURN_STEPS = 0.25, 0.2, 40
#: the tight host arm's external preempts
EVICT_PREEMPTS = 2


def overcommit_phase(torch, model, params, kernels, seed: int, card: str, smi: str, *,
                     prompts=None, new_tokens: int = OVERCOMMIT_NEW_TOKENS,
                     pool_pages: int = OVERCOMMIT_POOL_PAGES,
                     snapshot_tokens: int = OVERCOMMIT_SNAPSHOT_TOKENS,
                     max_len: int = 1024) -> dict:
    """The 16 serve prompts (or ``prompts``), 128 new tokens each, through a
    paged engine of 8 slots over ``pool_pages`` pages under cuda-strict (the
    keywords scale it down for a rehearsal on the CPU), in four arms, each
    gated to 16 of 16 streams equal to an unconstrained dense run of the
    same requests (16 slots; greedy, or T = 0.7 for arm 4): (1) full reserve
    (the default admission); (2) overcommitted (``growth_reserve`` 0.5,
    snapshots from OVERCOMMIT_SNAPSHOT_TOKENS rows), an unbounded host
    arena: it must preempt and resume both ways; (3) arm 2 with a host
    budget of the largest snapshot a request can make, and EVICT_PREEMPTS
    external preempts, each of the live request with the most cached rows
    while a parked snapshot's refill is in flight: two snapshots never fit
    the budget together, so the new one's spill must evict the parked one
    (a demotion that frees arena bytes, and the cancel of its refill and of
    its copy up);
    (4) arm 2 at T = 0.7 (seed 3) with ``FusionPolicy(max_fusion=4)`` and
    seeded external ``preempt()`` and ``resume()`` calls over its first
    CHURN_STEPS steps.  After every step the allocator's
    and the arena's invariants are checked (and the budget); at the end every
    page is free and the arena empty.  Every re-prefill resume's replay is
    checked token by token by the engine itself.  Prints each arm's counters,
    sustained concurrency and the real snapshot copies' seconds and GB/s
    beside the transfer engine's priced time.  Then Table VIII's and XI's
    trace arms, on the host, against the JAX package's rows."""
    import numpy as np

    from repro_torch.bench import table8_overcommit, table11_spill
    from repro_torch.core.ledger import OverheadLedger
    from repro_torch.core.policy import AdmissionPolicy, FusionPolicy, PreemptionPolicy

    cfg = model.cfg
    cuda = model.device.type == "cuda"
    new = new_tokens
    if prompts is None:
        prompts = serve_prompts(torch, cfg.vocab_size, seed)[1]
    lengths = [len(p) for p in prompts]
    runs, streams = {}, {}
    for name, kw in (("dense_16", {}), ("dense_16_t0.7", {"temperature": 0.7, "seed": 3})):
        runs[name], streams[name] = serve_run(torch, model, params, kernels, prompts,
                                              new_tokens=new, batch_slots=16, max_len=max_len,
                                              **kw)
        print("  " + json.dumps({"arch": cfg.name, "run": name, **runs[name]}))

    def checked(eng):
        eng.allocator.check_invariants()
        eng.arena.check_invariants()
        if eng.host_budget_bytes is not None and eng.arena.used_bytes > eng.host_budget_bytes:
            raise AssertionError(f"host arena holds {eng.arena.used_bytes} bytes over its "
                                 f"budget of {eng.host_budget_bytes}")

    rng = np.random.default_rng(seed + 7)
    churned = [0]

    def churn(eng):
        checked(eng)
        churned[0] += 1
        if churned[0] > CHURN_STEPS:
            return
        if eng._active and rng.random() < CHURN_PREEMPT_P:
            eng.preempt(int(rng.choice([r.uid for r in eng._active.values()])))
        if eng.parked_requests and rng.random() < CHURN_RESUME_P:
            eng.resume(int(rng.choice([r.uid for r in eng.parked_requests])))

    pressed = [0]

    def evicting(eng):
        checked(eng)
        if pressed[0] >= EVICT_PREEMPTS or not any(e.refill is not None for e in eng._parked):
            return
        slot = max(eng._active, key=lambda s: int(eng._pos[s]), default=None)
        if slot is not None and eng._pos[slot] >= snapshot_tokens:
            pressed[0] += 1
            eng.preempt(eng._active[slot].uid)

    over = dict(admission=AdmissionPolicy(growth_reserve=0.5),
                preemption=PreemptionPolicy(snapshot_threshold_tokens=snapshot_tokens))
    arms = [("full_reserve", "dense_16", checked, {}),
            ("overcommit", "dense_16", checked, over),
            ("tight_host", "dense_16", evicting, over),
            ("churn_t0.7", "dense_16_t0.7", churn,
             {**over, "temperature": 0.7, "seed": 3,
              "decode_fusion": FusionPolicy(max_fusion=4)})]
    for name, want, after, kw in arms:
        if name == "tight_host":
            # room for the largest snapshot (a request's last row cached)
            # and never two: each holds at least snapshot_tokens rows
            blocks = -(-(max(lengths) + new - 1) // 16)
            if 2 * -(-snapshot_tokens // 16) <= blocks:
                raise ValueError(f"two snapshots of {snapshot_tokens} rows fit {blocks} blocks")
            kw = {**kw, "host_budget_bytes": blocks * runs["overcommit"]["tier"]["block_bytes"]}
        runs[name], streams[name] = serve_run(
            torch, model, params, kernels, prompts, new_tokens=new, after_step=after,
            batch_slots=8, paged=True, page_size=16, pool_pages=pool_pages, max_len=max_len,
            ledger=OverheadLedger(), **kw)
        tier = runs[name]["tier"]
        copies = tier["copies"]
        for way in ("d2h", "h2d"):
            tier[f"{way}_gb_per_s"] = (copies[f"{way}_bytes"] / copies[f"{way}_s"] / 1e9
                                       if copies[f"{way}_s"] else None)
        print("  " + json.dumps({"arch": cfg.name, "arm": name, **runs[name]}))
        differ = [i for i, (a, b) in enumerate(zip(streams[name], streams[want])) if a != b]
        if differ:
            raise AssertionError(f"overcommit arm {name}: streams differ from {want} in "
                                 f"requests {differ}")
        if tier["free_pages"] != tier["total_pages"] or tier["arena_entries"]:
            raise AssertionError(f"overcommit arm {name} ended holding pages or snapshots: "
                                 f"{tier}")
        print(f"  {name} on {card} ({smi}): {tier['preemptions']} preemptions, resumes "
              f"{tier['snapshot_resumes']} by snapshot and {tier['reprefill_resumes']} by "
              f"re-prefill, {tier['recompute_tokens']} recompute tokens, "
              f"{tier['pages_reclaimed']} pages reclaimed, {tier['spills']} spills, "
              f"{tier['refills']} refills, {tier['demotions']} demotions "
              f"({tier['demoted_bytes']} arena bytes freed, {tier['refill_cancels']} refills "
              f"cancelled), host peak {tier['host_peak_bytes']} bytes; copies: device to host "
              f"{copies['d2h_bytes']} bytes in {copies['d2h_s']} s ({tier['d2h_gb_per_s']} "
              f"GB/s; the pinned host buffers allocated in {copies['d2h_alloc_s']} s besides), "
              f"host to device {copies['h2d_bytes']} bytes in {copies['h2d_s']} s "
              f"({tier['h2d_gb_per_s']} GB/s, on a side stream ahead of need; the serving "
              f"stream waited {copies['h2d_waited_s']} s on them; "
              f"{copies['h2d_cancelled']} copies up cancelled), priced at "
              f"{tier['priced_s']} s on the transfer timeline; sustained "
              f"concurrency {runs[name]['sustained_concurrency']}, peak "
              f"{runs[name]['peak_concurrency']}")
    oc, th = runs["overcommit"]["tier"], runs["tight_host"]["tier"]
    if not (oc["preemptions"] > 0 and oc["snapshot_resumes"] > 0 and oc["reprefill_resumes"] > 0):
        raise AssertionError(f"the overcommitted arm did not preempt and resume both ways: {oc}")
    if not (th["spills"] > 0 and th["demoted_bytes"] > 0 and th["refill_cancels"] > 0
            and th["copies"]["h2d_cancelled"] == (th["refill_cancels"] if cuda else 0)):
        raise AssertionError(f"the tight host arm did not evict a parked snapshot (spills, "
                             f"a demotion that freed arena bytes, its refill and copy up "
                             f"cancelled): {th}")
    if runs["churn_t0.7"]["tier"]["preemptions"] == 0:
        raise AssertionError("the churn arm never preempted")
    print(f"  sustained concurrency: overcommitted {runs['overcommit']['sustained_concurrency']} "
          f"against full reserve {runs['full_reserve']['sustained_concurrency']}")
    traces = {}
    for table, mod in (("table8", table8_overcommit), ("table11", table11_spill)):
        rows = mod.rows(64)
        mod.check(rows)
        traces[table] = rows
        for metric, (value, derived) in rows.items():
            print(f"  {table},{metric},{value},{derived}")
    print("  Table VIII's and XI's trace rows equal the JAX package's (BENCH_results.json)")
    return {"prompt_lengths": lengths, "new_tokens": new, "pool_pages": pool_pages,
            "runs": runs, "traces": traces,
            "sustained_concurrency": {n: runs[n]["sustained_concurrency"]
                                      for n in ("full_reserve", "overcommit")}}


# ---------------------------------------------------------------------------
# phases 5b-5d: fault recovery, integrity and prefix sharing (llama3.2-1b)
# ---------------------------------------------------------------------------

#: every stream gate's two samplings: greedy (K = 1), and T = 0.7 (seed 3) at K = 4
GATE_SAMPLINGS = (("greedy", {}), ("t0.7", {"temperature": 0.7, "seed": 3, "decode_fusion": 4}))
#: the faults phase's scheduler: benchmarks/table10_faults.py's virtual cost
#: model (a launch 1 ms, a region load 5 ms) and its plan at the rate 0.05
#: (80 % exec faults, 20 % wedges, seed 7), with its "engine" policy
FAULT_EXEC_S, FAULT_RECONFIG_S = 1e-3, 5e-3
TABLE10_PLAN = {"seed": 7, "exec_rate": 0.04, "wedge_rate": 0.01}
#: the faults phase's arms: (name, forced exec fault's packet name or None,
#: permanent, the engine's RetryPolicy keywords, the scheduler's, chunked)
FAULT_ARMS = (
    ("clean", None, False, None, None, False),
    ("decode_fault", "decode_fused", False, {}, None, False),
    ("prefill_fault", "prefill", False, {}, None, False),
    ("sched_retry", "decode_fused", False, None, {"backoff_s": 1e-4, "max_backoff_s": 1e-2},
     False),
    ("permanent", "decode_fused", True, {"max_request_recoveries": 0}, None, False),
    ("table10", None, False, {"max_request_recoveries": 32}, None, False),
    ("chunked_clean", None, False, None, None, True),
    ("chunk_fault", "prefill_chunk", False, {}, None, True),
)
#: the integrity phase's corruption: FaultPlan's corruption draws at a seeded
#: rate an opportunity (a page flipped in the pool, a byte of a parked
#: snapshot, a transfer's payload), and the first arena block and the first
#: two transfers forced (a transfer is a rare opportunity: some 20 a run).
#: A detected page is quarantined for good, so the rate is kept where the
#: pool still fits the longest request
INTEGRITY_PLAN = {"seed": 8, "corrupt_rate": 0.002}
INTEGRITY_FORCED = (("flip_block", 1), ("corrupt_transfer", 2))
INTEGRITY_POOL_PAGES = 96
INTEGRITY_SCRUB = 4
#: the integrity phase's samplings: greedy and T = 0.7, both at K = 4.  The
#: read check hashes every sealed page a launch read (some 36 MB a launch
#: here, on the host), so at K = 1 the greedy arm's 762 launches spent 25 s
#: hashing; at K = 4 a launch costs the same and there are a quarter of them
INTEGRITY_SAMPLINGS = (("greedy", {"decode_fusion": 4}), GATE_SAMPLINGS[1])


# ---------------------------------------------------------------------------
# phase 14: Mixture-of-Experts and MLA at full width (llama4-maverick,
# deepseek-v3)
# ---------------------------------------------------------------------------

#: the moe phase's configs, served in this order, each at full width with
#: its depth the one cut (one 80 GB card: all 48 and 61 layers would be 0.8
#: and 1.3 TB of weights), and the policy its kernels run under:
#: llama4-maverick's one (moe, dense) unit under cuda-strict; deepseek-v3's 3
#: dense layers, then 2 MoE ones, under cuda (MLA's absorbed decode
#: attention is a plain function in the JAX package too, so it is plain
#: PyTorch here, the one op that leaves the hand-written kernels)
MOE_ARCHS = (("llama4-maverick-400b-a17b", 2, "cuda-strict"), ("deepseek-v3-671b", 5, "cuda"))
#: the phase's 8 prompts, 5 to 600 tokens evenly spaced, 16 new tokens each
MOE_LENGTHS = tuple(round(5 + i * (600 - 5) / 7) for i in range(8))
MOE_NEW_TOKENS = 16
MOE_DECODE_STEPS = 3
#: the runs of the 8 prompts, and run -> the run whose streams it must equal:
#: graph against loop, K = 4 against K = 1, paged against dense (GQA only:
#: MLA's latent cache does not page, as in the JAX engine), and T = 0.7 at
#: K = 4 against K = 1
MOE_RUNS = (("dense", {"batch_slots": 8}),
            ("dense_loop", {"batch_slots": 8, "graphed": False}),
            ("k4", {"batch_slots": 8, "decode_fusion": 4}),
            ("paged", {"batch_slots": 8, "paged": True, "page_size": 16}),
            ("t0.7_k1", {"batch_slots": 8, "temperature": 0.7, "seed": 3}),
            ("t0.7_k4", {"batch_slots": 8, "temperature": 0.7, "seed": 3, "decode_fusion": 4}))
MOE_EQUAL = {"dense_loop": "dense", "k4": "dense", "paged": "dense", "t0.7_k4": "t0.7_k1"}


def moe_launches(model, *, prefills: int, fixups: int, decodes: int, paged: bool = False,
                 samples: int = 0) -> dict[str, int]:
    """Each kernel's launches implied by an MoE model's calls.  A layer's
    attention runs 4 matmuls (GQA: wq, wk, wv, wo) or, MLA, 5 in a prefill
    (wq_a, wq_b, wkv_a, wkv_b, wo) and 3 bf16 ones and the f32 ``wo`` in a
    decode step (W_UK and W_UV are read by the absorbed attention, not
    multiplied); its FFN 3 (the dense MLP, or MoE's shared expert: the
    routed experts are batched PyTorch products, as JAX's einsums).  Norms:
    2 a layer (GQA), 4 (MLA: q_norm and kv_norm too), and the final one.
    Prefills run flash attention in every layer; GQA fixups and decode steps
    decode attention (dense or paged), MLA's none (plain PyTorch)."""
    cfg = model.cfg
    L = cfg.num_layers
    shared = cfg.moe.num_shared_experts > 0
    ffn = sum(3 for kind in model.kinds if kind == "dense" or shared)
    bf16_unembed, edge_unembed = unembed_launches(cfg)
    calls, steps = prefills + fixups + decodes, fixups + decodes
    base = {"ssd": 0, "sample": samples, "matmul_edge": edge_unembed * calls,
            "flash_attention": L * prefills}
    if cfg.mla is not None:
        return {**base, "matmul": (5 * L + ffn + bf16_unembed) * prefills
                + (3 * L + ffn + bf16_unembed) * steps, "matmul_f32": L * steps,
                "rmsnorm": (4 * L + 1) * calls, "decode_attention": 0,
                "paged_decode_attention": 0}
    return {**base, "matmul": (4 * L + ffn + bf16_unembed) * calls,
            "rmsnorm": (2 * L + 1) * calls,
            "decode_attention": L * (fixups + (0 if paged else decodes)),
            "paged_decode_attention": L * decodes if paged else 0}


class KernelChecks:
    """A registry whose hand-written kernels each run their plain version
    on the same inputs after every call and raise unless the two agree
    within the kernel phase's tolerances (the bf16 matmul 2e-2, f32 out
    1e-3, f32 in 2e-4; rmsnorm 2e-2; attention rows 1e-2 relative L2; ssd
    rows 1e-2 and its state 1e-3 relative L2): a model call under it holds
    every kernel at every shape, on the data, the call gives it.  The worst
    error at each (op, shape) is kept."""

    PLAIN = {"matmul": ("matmul", "plain_matmul"), "rmsnorm": ("rmsnorm", "plain_rmsnorm"),
             "flash_attention": ("flash_attention", "plain_flash_attention"),
             "decode_attention": ("decode_attention", "plain_decode_attention"),
             "paged_decode_attention": ("paged_decode_attention",
                                        "plain_paged_decode_attention"),
             "ssd": ("ssd", "plain_ssd")}

    def __init__(self, torch) -> None:
        self.torch = torch
        self.worst: dict[str, dict[str, float]] = {}

    def registry(self):
        import importlib

        from repro_torch.core.registry import GLOBAL_REGISTRY, KernelRegistry

        reg = KernelRegistry()
        reg.restore(GLOBAL_REGISTRY.snapshot())
        for op, (mod, fn_name) in self.PLAIN.items():
            plain = getattr(importlib.import_module(f"repro_torch.kernels.{mod}"), fn_name)
            impl = reg.resolve(op, "cuda", ("cuda",))

            def checked(*args, _kernel=impl.fn, _plain=plain, _op=op, **kwargs):
                got = _kernel(*args, **kwargs)
                # ssd's chunk is the Pallas kernel's, which the kernel ignores:
                # the plain version runs at the kernel's own chunk
                plain_kw = {k: v for k, v in kwargs.items() if k != "chunk"}
                self.check(_op, args, got, _plain(*args, **plain_kw))
                return got
            reg.register(dataclasses.replace(impl, fn=checked), allow_override=True)
        return reg

    def check(self, op: str, args, got, want) -> None:
        torch = self.torch
        shapes = "x".join(str(list(a.shape)) for a in args if isinstance(a, torch.Tensor))
        if op in ("matmul", "rmsnorm"):
            tol = (TOL_ROLE_F32 if args[0].dtype == torch.float32
                   else TOL_F32 if got.dtype == torch.float32 else TOL_BF16)
            err = max_err(torch, got, want, tol)["max_abs_err"]
            key = f"{shapes} {str(args[0].dtype)[6:]} out={str(got.dtype)[6:]}"
        elif op == "ssd":
            (gy, gs), (wy, ws) = ((got, want) if isinstance(got, tuple)
                                  else ((got, None), (want, None)))
            err = float(row_rel_l2(torch, gy, wy).max())
            state = float(row_rel_l2(torch, gs.flatten(2), ws.flatten(2)).max()) if gs is not None \
                else 0.0
            if (not torch.isfinite(gy.float()).all() or err > SSD_Y_REL_L2_TOL
                    or state > SSD_STATE_REL_L2_TOL):
                raise AssertionError(f"ssd at {shapes} disagrees with its plain version: y row "
                                     f"rel L2 {err}, state rel L2 {state}")
            key = shapes
        else:
            if not torch.isfinite(got.float()).all():
                raise AssertionError(f"{op} at {shapes}: non-finite output")
            err = float(row_rel_l2(torch, got, want).max())
            if err > ATTN_REL_L2_TOL:
                raise AssertionError(f"{op} at {shapes} disagrees with its plain version: row "
                                     f"rel L2 {err} beyond {ATTN_REL_L2_TOL}")
            key = shapes
        by_shape = self.worst.setdefault(op, {})
        by_shape[key] = max(by_shape.get(key, 0.0), err)


def moe_prompts(torch, vocab: int, seed: int) -> list[list[int]]:
    """The moe phase's 8 prompts (MOE_LENGTHS), drawn from ``seed``."""
    rng = torch.Generator().manual_seed(seed + 3)
    return [torch.randint(0, vocab, (n,), generator=rng).tolist() for n in MOE_LENGTHS]


def moe_model_calls(torch, model, params, kernels, prompts, policy: str, seed: int) -> dict:
    """The engine's calls for the 8 prompts (each prefilled at its bucket
    into a 1024-row cache, its first-token fixup where the bucket pads it),
    then MOE_DECODE_STEPS decode steps of the 8 as a batch at their own
    positions, under the ``torch`` source, under ``policy`` (launches
    counted from 0 and checked against the calls, and a dispatch trace of
    which source each op resolved to), and under ``policy`` with every
    kernel held against its plain version (:class:`KernelChecks`).  A GQA
    model's first batched step also runs over a page pool behind a shuffled
    table: bitwise the dense step under ``policy``.  Logits within
    MODEL_REL_L2_TOL of the torch source's, row by row."""
    from repro_torch.core import dispatch
    from repro_torch.kernels import matmul as mm_k
    from repro_torch.models.model import TIME_KEYS
    from repro_torch.serve.engine import ServeEngine

    dev, cfg = model.device, model.cfg
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 7)
    lengths = [len(p) for p in prompts]
    B, ps = len(prompts), 16
    buckets = [ServeEngine.bucket_len(n, 1024) for n in lengths]
    nexts = torch.randint(0, cfg.vocab_size, (B, MOE_DECODE_STEPS), generator=gen, device=dev)
    table = (torch.randperm(B * 1024 // ps, generator=gen, device=dev) + 1).reshape(B, -1).int()
    checks = KernelChecks(torch)
    out, launches, sources = {}, {}, {}
    for arm in ("torch", policy, "checked"):
        for mod in kernels:
            mod.launches = 0
        mm_k.edge_launches = mm_k.f32_launches = 0
        trace = dispatch.DispatchTrace() if arm == policy else None
        got: dict[str, list] = {"prefill": [], "fixup": [], "decode": []}
        with dispatch.use(prefer=dispatch.policy_from_flag("torch" if arm == "torch" else policy),
                          registry=checks.registry() if arm == "checked" else None, trace=trace):
            caches = []
            for tokens, n, bucket in zip(prompts, lengths, buckets):
                t = torch.tensor([tokens + [0] * (bucket - n)], device=dev)
                logits, cache = model.prefill(params, {"tokens": t}, cache_len=1024)
                got["prefill"].append(logits[0])
                if bucket > n:
                    fix = {"pos": torch.tensor([n - 1], dtype=torch.int32, device=dev),
                           **{k: v.narrow(-2, 0, n).clone() for k, v in cache.items()
                              if k in TIME_KEYS}}
                    got["fixup"].append(model.decode_step(params, t[:, n - 1:n], fix)[0][0])
                caches.append(cache)
            batch = {k: torch.cat([c[k] for c in caches], dim=1) for k in caches[0]
                     if k in TIME_KEYS}
            del caches
            pos = torch.tensor(lengths, dtype=torch.int32, device=dev)
            if cfg.mla is None and arm != "torch":
                pool = {k: pages_of(torch, batch[k], table, ps) for k in ("k", "v")}
                got["decode_paged"] = list(model.decode_step(
                    params, nexts[:, :1], {**pool, "pos": pos, "block_table": table})[0])
                del pool
            batch["pos"] = pos
            for step in range(MOE_DECODE_STEPS):
                logits, batch = model.decode_step(params, nexts[:, step:step + 1], batch)
                got["decode"] += list(logits)
            del batch
        if dev.type == "cuda":
            torch.cuda.synchronize()
        launches[arm] = {mod.__name__.rsplit(".", 1)[1]: mod.launches for mod in kernels}
        launches[arm].update(matmul_edge=mm_k.edge_launches, matmul_f32=mm_k.f32_launches)
        if trace is not None:
            for op, name in trace.events:
                sources.setdefault(op, set()).add(name.split(":")[1])
        out[arm] = got
    strict = out[policy]
    if cfg.mla is None and not all(torch.equal(a, b) for a, b in
                                   zip(strict["decode_paged"], strict["decode"][:B])):
        raise AssertionError(f"{cfg.name}: the paged decode step's logits differ from the dense "
                             f"step's under {policy}")
    fixups = len(strict["fixup"])
    want = moe_launches(model, prefills=B, fixups=fixups, decodes=MOE_DECODE_STEPS)
    if cfg.mla is None:
        paged = moe_launches(model, prefills=0, fixups=0, decodes=1, paged=True)
        want = {k: want[k] + paged[k] for k in want}
    if launches[policy] != {**want, "matmul_f32": want.get("matmul_f32", 0)}:
        raise AssertionError(f"{cfg.name}: kernel launches {launches[policy]} under {policy}, "
                             f"expected {want}")
    off_kernels = {op: sorted(src) for op, src in sources.items() if src != {"cuda"}}
    if off_kernels != ({"mla_decode_attention": ["torch"]} if cfg.mla is not None else {}):
        raise AssertionError(f"{cfg.name}: ops off the hand-written kernels under {policy}: "
                             f"{off_kernels}")
    res = {"arch": cfg.name, "layers": cfg.num_layers, "policy": policy,
           "prompt_lengths": lengths, "buckets": buckets, "tolerance_rel_l2": MODEL_REL_L2_TOL,
           "launches": launches[policy], "dispatch_sources": {op: sorted(src) for op, src
                                                             in sources.items()},
           "off_the_kernels": off_kernels,
           "kernels_held_against_plain": {op: len(v) for op, v in checks.worst.items()},
           "kernel_worst_errors": checks.worst}
    for kind in ("prefill", "fixup", "decode"):
        rel, agree = [], 0
        for ref, g in zip(out["torch"][kind], strict[kind]):
            ref, g = ref.float(), g.float()
            if not torch.isfinite(g).all() or g.shape != (cfg.vocab_size,):
                raise AssertionError(f"{cfg.name} {kind} logits of shape {tuple(g.shape)}, or "
                                     f"not finite")
            rel.append(float((g - ref).norm() / ref.norm()))
            agree += int(g.argmax() == ref.argmax())
        res[kind] = {"rel_l2": rel, "top1_agree": f"{agree} of {len(rel)}"}
    if cfg.mla is None:
        res["paged_equal_dense_bitwise"] = True
    print("  " + json.dumps(res))
    worst = max(max(res[kind]["rel_l2"]) for kind in ("prefill", "fixup", "decode"))
    if worst > MODEL_REL_L2_TOL:
        raise AssertionError(f"{cfg.name}: {policy} logits differ from the torch source's: {res}")
    return res


def moe_phase(torch, model, params, policy: str, kernels, seed: int, card: str, smi: str, *,
              full_layers: int, prompts=None) -> dict:
    """One MoE config at full width, cut to its ``model``'s depth, weights
    from ``seed``: its model calls (:func:`moe_model_calls`), then the 8
    prompts (or ``prompts``) through MOE_RUNS under ``policy``, each run's
    launches checked against its model calls, streams equal 8 of 8 per
    MOE_EQUAL.  Prints the depth cut (``full_layers`` to the model's), the
    weights' bytes, peak memory, TTFT and the dense graph run's decode
    tokens/s beside the weights' bound: a dropless decode step runs every
    expert (C = T k rows each), so it reads every weight but the embedding
    table (and, MLA, the bf16 ``wo``, which only prefill reads)."""
    cfg = model.cfg
    arch, layers = cfg.name, cfg.num_layers
    wbytes = weight_bytes(params)
    unread = params["embed"]["tok"].numel() * params["embed"]["tok"].element_size()
    if cfg.mla is not None:
        unread += sum(layer["mla"]["wo"].numel() * 2 for layer in params["layers"])
    print(f"  {arch}: full width (d_model {cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} "
          f"heads, {cfg.moe.num_experts} experts top-{cfg.moe.experts_per_token} of d_ff "
          f"{cfg.moe.d_ff_expert}, vocab {cfg.vocab_size}); depth cut {full_layers} -> "
          f"{layers} layers {model.kinds}; weights {wbytes / 1e9:.2f} GB; policy {policy}")
    if prompts is None:
        prompts = moe_prompts(torch, cfg.vocab_size, seed)
    calls = moe_model_calls(torch, model, params, kernels, prompts, policy, seed)
    runs, streams = {}, {}
    for name, kw in MOE_RUNS:
        if cfg.mla is not None and kw.get("paged"):
            continue
        runs[name], streams[name] = serve_run(torch, model, params, kernels, prompts,
                                              new_tokens=MOE_NEW_TOKENS, policy=policy, **kw)
        print("  " + json.dumps({"arch": arch, "run": name, **runs[name]}))
    equal = {}
    for name, want in MOE_EQUAL.items():
        if name not in streams:
            continue
        differ = [i for i, (a, b) in enumerate(zip(streams[name], streams[want])) if a != b]
        if differ:
            raise AssertionError(f"{arch}: {name} streams differ from {want} streams in "
                                 f"requests {differ} (prompt lengths "
                                 f"{[len(prompts[i]) for i in differ]})")
        equal[name] = f"{len(prompts)} of {len(prompts)} equal {want}"
    busy = None
    if model.device.type == "cuda":
        print(f"  where a {arch} decode step's time goes (torch.profiler, CUDA activity):")
        busy = busy_phase(torch, model, params, seed, policy=policy)
    dense = runs["dense"]
    bound_s = (wbytes - unread) / HBM_BYTES_S
    summary = {
        "arch": arch, "layers": layers, "full_layers": full_layers, "policy": policy,
        "weights_bytes": wbytes, "weights_gb": wbytes / 1e9,
        "step_bound_ms": bound_s * 1e3, "decode_tokens_per_s_bound_8_slots": 8 / bound_s,
        "decode_tokens_per_s": dense["decode_tokens_per_s"],
        "decode_step_ms": (dense["decode_step_s"] or 0) * 1e3,
        "ttft_mean_s": dense["ttft_mean_s"], "ttft_p99_s": dense["ttft_p99_s"],
        "peak_memory_bytes": max(r["max_memory_allocated_bytes"] or 0 for r in runs.values()),
        "streams_equal": equal, "card": card, "nvidia_smi": smi}
    print(f"  {arch} at {layers} of {full_layers} layers on {card} ({smi}): weights "
          f"{summary['weights_gb']:.2f} GB; peak device memory {summary['peak_memory_bytes']} "
          f"bytes; dense graph run: TTFT mean {dense['ttft_mean_s']} s, p99 "
          f"{dense['ttft_p99_s']} s, decode {dense['decode_tokens_per_s']} tokens/s against "
          f"the weights' bound of {summary['decode_tokens_per_s_bound_8_slots']} tokens/s at 8 "
          f"slots ({summary['step_bound_ms']} ms a step); streams {equal}")
    return {"calls": calls, "runs": runs, "summary": summary, "busy": busy}


# ---------------------------------------------------------------------------
# phase 15: the last two families at full width and depth: hymba-1.5b
# (attention and Mamba-2 heads in every layer, a 1024-token sliding window)
# and whisper-large-v3 (an encoder-decoder)
# ---------------------------------------------------------------------------

#: hymba's 8 prompts: 1100, 1250 and 1400 tokens pass its window of 1024 (the
#: ring engaged at prefill), 1000 crosses it in decode (32 new tokens), the
#: rest stay inside; each slot 2048 rows long, a ring of 1024
HYMBA_LENGTHS = (5, 200, 500, 800, 1000, 1100, 1250, 1400)
HYMBA_MAX_LEN = 2048
HYMBA_NEW_TOKENS = 32
#: the runs of the 8 prompts, and run -> the run whose streams it must equal:
#: graph against loop, K = 4 against K = 1, T = 0.7 at K = 4 against K = 1
#: (paged and chunked serving refuse a ring cache, as in the JAX engine)
HYMBA_RUNS = (("dense", {"batch_slots": 8}),
              ("dense_loop", {"batch_slots": 8, "graphed": False}),
              ("k4", {"batch_slots": 8, "decode_fusion": 4}),
              ("t0.7_k1", {"batch_slots": 8, "temperature": 0.7, "seed": 3}),
              ("t0.7_k4", {"batch_slots": 8, "temperature": 0.7, "seed": 3,
                           "decode_fusion": 4}))
HYMBA_EQUAL = {"dense_loop": "dense", "k4": "dense", "t0.7_k4": "t0.7_k1"}
#: whisper: 8 frame sets of the config's 1500 frames (the conv frontend is a
#: stub, as in the JAX package), a 4-token decoder prompt, the published
#: 448-row decoder context, 64 greedy tokens
WHISPER_BATCH, WHISPER_PROMPT, WHISPER_CACHE_LEN, WHISPER_NEW_TOKENS = 8, 4, 448, 64
FAMILY_DECODE_STEPS = 3


def hybrid_kn(cfg) -> list[tuple[int, int]]:
    """The (K, N) of a hybrid layer's nine matmuls: wq, wk, wv, wo and the
    MLP's three (:func:`weight_kn`), then the Mamba-2 block's in_proj (N =
    2 d_inner + 2 G N + H: 6482 at hymba, not a multiple of 8) and
    out_proj."""
    s, d = cfg.ssm, cfg.d_model
    d_in = s.d_inner(d)
    return [*weight_kn(cfg), (d, 2 * d_in + 2 * s.num_groups * s.state_dim + s.num_heads(d)),
            (d_in, d)]


def hybrid_launches(cfg, *, prefills: int, decodes: int, samples: int = 0) -> dict[str, int]:
    """Each kernel's launches implied by a hybrid model's calls (prefills
    and decode steps; no fixups: a ring cache is not bucketed): every call
    runs a layer's nine matmuls, those whose K or N is not a multiple of 8
    on the edge kernel (hymba's in_proj), five norms a layer (ln1, the
    attention and SSM heads' norms, ln2, the block's gated norm over
    d_inner) and the final one, and the untied unembed (:func:`unembed_launches`);
    a prefill runs flash attention and ssd in every layer, a decode step
    decode attention over the ring."""
    L, kn = cfg.num_layers, hybrid_kn(cfg)
    edge = sum(1 for K, N in kn if K % 8 or N % 8)
    bf16_unembed, edge_unembed = unembed_launches(cfg)
    calls = prefills + decodes
    return {"matmul": ((len(kn) - edge) * L + bf16_unembed) * calls,
            "rmsnorm": (5 * L + 1) * calls, "flash_attention": L * prefills,
            "decode_attention": L * decodes, "paged_decode_attention": 0, "ssd": L * prefills,
            "sample": samples, "matmul_edge": (edge * L + edge_unembed) * calls}


def encdec_launches(cfg, *, prefills: int, decodes: int) -> dict[str, int]:
    """Each kernel's launches implied by an encoder-decoder's calls: a
    prefill runs each encoder layer's 7 matmuls, 2 norms and a non-causal
    flash attention, the encoder's final norm, then each decoder layer's 11
    matmuls (its attention's 4, the cross-attention's wq, wo and the
    memory's wk, wv, the MLP's 3), 3 norms (ln1, lnx, ln2) and two flash
    attentions (causal over its rows, non-causal over the memory); a decode
    step each decoder layer's 9 matmuls (the memory's K/V are cached), 3
    norms and two decode attentions (its rows, the memory); every call the
    final norm and the unembed."""
    Le, Ld = cfg.encoder_layers, cfg.num_layers
    bf16_unembed, edge_unembed = unembed_launches(cfg)
    calls = prefills + decodes
    return {"matmul": (7 * Le + 11 * Ld) * prefills + 9 * Ld * decodes + bf16_unembed * calls,
            "rmsnorm": (2 * Le + 1 + 3 * Ld) * prefills + 3 * Ld * decodes + calls,
            "flash_attention": (Le + 2 * Ld) * prefills, "decode_attention": 2 * Ld * decodes,
            "paged_decode_attention": 0, "ssd": 0, "sample": 0,
            "matmul_edge": edge_unembed * calls}


def call_key(op: str, args, kwargs) -> tuple:
    """The shape key of one kernel call (what a served shape is): the
    matmul's rows M, K, N, types and epilogue; rmsnorm's rows, width and
    type; flash attention's batch, heads, rows, widths, keys, mask; decode
    attention's batch, heads, width and cache rows; ssd's (B, S, H, P, G,
    N)."""
    if op == "matmul":
        x, w = args[:2]
        out = kwargs.get("out_dtype") or x.dtype
        return (op, math.prod(x.shape[:-1]), x.shape[-1], w.shape[1], str(x.dtype)[6:],
                str(out)[6:], kwargs.get("activation"))
    if op == "rmsnorm":
        x = args[0]
        return (op, math.prod(x.shape[:-1]), x.shape[-1], str(x.dtype)[6:])
    if op == "flash_attention":
        q, k, v = args[:3]
        return (op, *q.shape, k.shape[1], k.shape[2], v.shape[3], kwargs.get("causal", True),
                kwargs.get("window"))
    if op == "decode_attention":
        q, k = args[:2]
        return (op, *q.shape, k.shape[1], k.shape[2])
    if op == "ssd":
        x, b = args[0], args[2]
        return (op, *x.shape, b.shape[2], b.shape[3])
    return (op,)


class ShapeLog:
    """A registry whose hand-written kernels record each call's
    :func:`call_key` before they launch: the shapes a run gives the
    kernels, which the kernel phase's rows must cover.  It wraps the active
    dispatch registry's kernels (the global one's, unless a caller set
    another)."""

    OPS = ("matmul", "rmsnorm", "flash_attention", "decode_attention",
           "paged_decode_attention", "ssd")

    def __init__(self) -> None:
        self.keys: set[tuple] = set()

    def registry(self):
        from repro_torch.core import dispatch
        from repro_torch.core.registry import KernelRegistry

        reg = KernelRegistry()
        reg.restore(dispatch.current().registry.snapshot())
        for op in self.OPS:
            impl = reg.resolve(op, "cuda", ("cuda",))

            def logged(*args, _kernel=impl.fn, _op=op, **kwargs):
                self.keys.add(call_key(_op, args, kwargs))
                return _kernel(*args, **kwargs)
            reg.register(dataclasses.replace(impl, fn=logged), allow_override=True)
        return reg


def check_family_shapes(rows: list[dict], keys) -> dict:
    """Raise unless every shape key the families phase's runs gave a kernel
    has a kernel-phase row held against the plain version at it (a row's
    ``served_key``); the count of shapes by kernel."""
    served = {tuple(k) for k in keys}
    ran = {tuple(r["served_key"]) for r in rows if "served_key" in r}
    missing = sorted(served - ran, key=str)
    if not served or missing:
        raise AssertionError(f"shapes the families phase gave the kernels that no row held "
                             f"against the plain version: {missing}")
    counts: dict[str, int] = {}
    for key in served:
        counts[key[0]] = counts.get(key[0], 0) + 1
    return counts


def family_prompts(torch, vocab: int, seed: int, lengths=HYMBA_LENGTHS) -> list[list[int]]:
    """Hymba's prompts (HYMBA_LENGTHS), drawn from ``seed``."""
    rng = torch.Generator().manual_seed(seed + 5)
    return [torch.randint(0, vocab, (n,), generator=rng).tolist() for n in lengths]


def compare_logits(torch, cfg, got: dict, want: dict) -> dict:
    """Each kind's logits rows against the torch source's: relative L2 and
    argmax agreement; raises on a row that is not finite or of the wrong
    width."""
    res = {}
    for kind in want:
        rel, agree = [], 0
        for ref, g in zip(want[kind], got[kind]):
            ref, g = ref.float(), g.float()
            if not torch.isfinite(g).all() or g.shape != (cfg.vocab_size,):
                raise AssertionError(f"{cfg.name} {kind} logits of shape {tuple(g.shape)}, or "
                                     f"not finite")
            rel.append(float((g - ref).norm() / ref.norm()))
            agree += int(g.argmax() == ref.argmax())
        res[kind] = {"rel_l2": rel, "top1_agree": f"{agree} of {len(rel)}"}
    return res


def family_calls(torch, model, params, kernels, run_calls, want_launches, *,
                 shape_log: ShapeLog) -> dict:
    """``run_calls()`` (a dict of logits rows by kind) under the ``torch``
    source, under cuda-strict (launches counted from 0, checked against
    ``want_launches``, shapes logged), and under cuda-strict with every
    kernel held against its plain version on the calls' data
    (:class:`KernelChecks`); the cuda-strict logits within MODEL_REL_L2_TOL
    of the torch source's, row by row."""
    from repro_torch.core import dispatch
    from repro_torch.kernels import matmul as mm_k

    cfg = model.cfg
    checks = KernelChecks(torch)
    out, launches = {}, {}
    logged = shape_log.registry()
    for arm in ("torch", "cuda-strict", "checked"):
        for mod in kernels:
            mod.launches = 0
        mm_k.edge_launches = mm_k.f32_launches = 0
        registry = (checks.registry() if arm == "checked" else
                    logged if arm == "cuda-strict" else None)
        with dispatch.use(prefer=dispatch.policy_from_flag(
                "torch" if arm == "torch" else "cuda-strict"), registry=registry):
            out[arm] = run_calls()
        if model.device.type == "cuda":
            torch.cuda.synchronize()
        launches[arm] = {mod.__name__.rsplit(".", 1)[1]: mod.launches for mod in kernels}
        launches[arm]["matmul_edge"] = mm_k.edge_launches
    if launches["cuda-strict"] != want_launches:
        raise AssertionError(f"{cfg.name}: kernel launches {launches['cuda-strict']} under "
                             f"cuda-strict, expected {want_launches}")
    res = {"arch": cfg.name, "layers": cfg.num_layers, "tolerance_rel_l2": MODEL_REL_L2_TOL,
           "launches": launches["cuda-strict"],
           "kernels_held_against_plain": {op: len(v) for op, v in checks.worst.items()},
           "kernel_worst_errors": checks.worst,
           **compare_logits(torch, cfg, out["cuda-strict"], out["torch"])}
    print("  " + json.dumps(res))
    worst = max(max(res[kind]["rel_l2"]) for kind in out["torch"])
    if worst > MODEL_REL_L2_TOL:
        raise AssertionError(f"{cfg.name}: cuda-strict logits differ from the torch source's: "
                             f"{res}")
    return res


def hymba_calls(torch, model, params, prompts, max_len: int, seed: int):
    """The engine's calls for hymba's prompts, as a function of no
    arguments: each prompt prefilled at its own length (no bucketing: a
    ring keeps a prefill's last window rows) into a ``max_len`` slot (a
    ring of min(max_len, window) rows), then FAMILY_DECODE_STEPS decode steps
    of them as a batch at their own positions (the ring rows past the
    window overwritten in place); the logits by kind."""
    dev, cfg = model.device, model.cfg
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 9)
    nexts = torch.randint(0, cfg.vocab_size, (len(prompts), FAMILY_DECODE_STEPS),
                          generator=gen, device=dev)
    lengths = torch.tensor([len(p) for p in prompts], dtype=torch.int32, device=dev)

    def run() -> dict:
        got: dict[str, list] = {"prefill": [], "decode": []}
        caches = []
        for tokens in prompts:
            logits, cache = model.prefill(params, {"tokens": torch.tensor([tokens], device=dev)},
                                          cache_len=max_len)
            got["prefill"].append(logits[0])
            caches.append(cache)
        batch = {k: torch.cat([c[k] for c in caches], dim=1) for k in caches[0] if k != "pos"}
        del caches
        batch["pos"] = lengths.clone()
        for step in range(FAMILY_DECODE_STEPS):
            logits, batch = model.decode_step(params, nexts[:, step:step + 1], batch)
            got["decode"] += list(logits)
        return got
    return run


def whisper_inputs(torch, cfg, seed: int, dev, batch: int = WHISPER_BATCH,
                   prompt: int = WHISPER_PROMPT):
    """(tokens [B, prompt], frames [B, frontend_seq, d_model] f32), drawn on
    ``dev`` from ``seed``: the frame embeddings stand for the conv
    frontend's output, as in the JAX package."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 11)
    tokens = torch.randint(0, cfg.vocab_size, (batch, prompt), generator=gen, device=dev)
    frames = torch.randn((batch, cfg.frontend_seq, cfg.d_model), generator=gen, device=dev)
    return tokens, frames


def whisper_calls(torch, model, params, tokens, frames, cache_len: int, seed: int):
    """Whisper's calls as a function of no arguments: the prefill of the
    decoder prompt over the frames into a ``cache_len`` cache, then
    FAMILY_DECODE_STEPS decode steps at the batch's one position; the
    logits by kind."""
    gen = torch.Generator(device=tokens.device)
    gen.manual_seed(seed + 13)
    nexts = torch.randint(0, model.cfg.vocab_size, (tokens.shape[0], FAMILY_DECODE_STEPS),
                          generator=gen, device=tokens.device)

    def run() -> dict:
        logits, cache = model.prefill(params, {"tokens": tokens, "frames": frames},
                                      cache_len=cache_len)
        got = {"prefill": list(logits), "decode": []}
        for step in range(FAMILY_DECODE_STEPS):
            logits, cache = model.decode_step(params, nexts[:, step:step + 1], cache)
            got["decode"] += list(logits)
        return got
    return run


def synced_s(torch, device, fn):
    """(fn()'s result, its wall seconds, the card drained before and after)."""
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def whisper_greedy(torch, model, params, tokens, frames, cache_len: int, new_tokens: int):
    """Greedy decoding under cuda-strict: the encoder, the decoder's
    prefill, then ``new_tokens`` decode steps of the batch, each feeding
    back its argmax; the tokens [B, new_tokens] and the seconds of the
    encoder, the decoder's prefill and the decode steps."""
    from repro_torch.core import dispatch

    dev = model.device
    with dispatch.use(prefer=dispatch.policy_from_flag("cuda-strict")):
        memory, enc_s = synced_s(torch, dev, lambda: model.encode(params, frames))
        (logits, cache), dec_s = synced_s(torch, dev, lambda: model.decoder_prefill(
            params, tokens, memory, cache_len=cache_len))
        del memory

        def loop():
            nonlocal logits, cache
            out = []
            for _ in range(new_tokens):
                tok = torch.argmax(logits, dim=-1)
                out.append(tok)
                logits, cache = model.decode_step(params, tok[:, None], cache)
            return torch.stack(out, dim=1)
        toks, loop_s = synced_s(torch, dev, loop)
    return toks, {"encoder_s": enc_s, "decoder_prefill_s": dec_s, "decode_s": loop_s}


def traced_call(torch, call, steps: int = 1) -> dict:
    """Where ``call()``'s device time goes: a torch.profiler trace of CUDA
    activity over ``steps`` calls, opened by marker kernels as busy_phase's
    traces are; the device busy share of their wall time and the kernels
    that take it (None where the trace holds no device events)."""
    from torch.profiler import ProfilerActivity, profile

    call()                                    # warm, outside the window
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(TRACE_OPENING_MARKERS):
            torch.cuda._sleep(0)
        torch.cuda.synchronize()
        time.sleep(TRACE_OPENING_PAUSE_S)
        t0 = time.perf_counter()
        for _ in range(steps):
            call()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = [e for e in prof.key_averages()
              if e.self_device_time_total > 0 and "spin_kernel" not in e.key]
    busy = sum(e.self_device_time_total for e in events)
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:10]
    res = {"calls": steps, "wall_us": wall_us,
           "device_busy_us": busy if events else None,
           "device_busy_share": busy / wall_us if events else None,
           "device_union_us": union_us(device_kernels(prof)) if events else None,
           "top_device_us": {e.key[:60]: [e.self_device_time_total, e.count] for e in top}}
    print("  " + json.dumps(res))
    return res


def hymba_phase(torch, model, params, kernels, seed: int, card: str, smi: str, *,
                shape_log: ShapeLog, lengths=HYMBA_LENGTHS, max_len: int = HYMBA_MAX_LEN,
                new_tokens: int = HYMBA_NEW_TOKENS) -> dict:
    """Hymba at full width and depth, weights from ``seed``: its model calls
    against the torch source (:func:`family_calls`), paged and chunked
    serving refused as the JAX engine refuses them, then the prompts
    through HYMBA_RUNS under cuda-strict, each run's launches checked
    against its calls, streams equal per HYMBA_EQUAL (8 of 8); the weights'
    bytes, peak memory, TTFT and the dense graph run's decode tokens/s
    beside the step's bound: the weights but the embedding table, the ring
    rows the step's attention reads (the run's mean) and the SSM state read
    and written, over 3.35 TB/s."""
    from repro_torch.core import dispatch
    from repro_torch.models.model import cache_rows
    from repro_torch.serve.engine import ServeEngine

    cfg = model.cfg
    prompts = family_prompts(torch, cfg.vocab_size, seed, lengths)
    window = cfg.attn_window
    if not (sum(n > window for n in lengths) >= 2 and any(
            n <= window < n + new_tokens for n in lengths)):
        raise AssertionError(f"hymba's prompts {lengths} must pass the window of {window} at "
                             f"prefill twice and cross it once in decode")
    calls = family_calls(torch, model, params, kernels,
                         hymba_calls(torch, model, params, prompts, max_len, seed),
                         hybrid_launches(cfg, prefills=len(prompts),
                                         decodes=FAMILY_DECODE_STEPS),
                         shape_log=shape_log)
    refusals = {}
    with dispatch.use(prefer=dispatch.policy_from_flag("cuda-strict")):
        for name, kw in (("paged", {"paged": True, "page_size": 16}),
                         ("prefill_chunk", {"prefill_chunk": 128})):
            try:
                ServeEngine(model, params, batch_slots=8, max_len=max_len, device=model.device,
                            **kw)
            except ValueError as e:
                refusals[name] = str(e)
            else:
                raise AssertionError(f"{cfg.name}: ServeEngine({name}) took a ring cache")
    runs, streams = {}, {}
    with dispatch.use(registry=shape_log.registry()):
        for name, kw in HYMBA_RUNS:
            runs[name], streams[name] = serve_run(torch, model, params, kernels, prompts,
                                                  new_tokens=new_tokens, max_len=max_len, **kw)
            print("  " + json.dumps({"arch": cfg.name, "run": name, **runs[name]}))
    equal = {}
    for name, want in HYMBA_EQUAL.items():
        differ = [i for i, (a, b) in enumerate(zip(streams[name], streams[want])) if a != b]
        if differ:
            raise AssertionError(f"{cfg.name}: {name} streams differ from {want} streams in "
                                 f"requests {differ} (prompt lengths "
                                 f"{[lengths[i] for i in differ]})")
        equal[name] = f"{len(prompts)} of {len(prompts)} equal {want}"
    wbytes = weight_bytes(params)
    table = params["embed"]["tok"]
    rows = cache_rows(cfg, max_len)
    hkv, hd, L = cfg.num_kv_heads, cfg.head_dim, cfg.num_layers
    # the ring rows a decode step's attention reads, k and v, over the run's
    # steps (each live prompt's positions; all 8 slots live throughout)
    ring_rows = sum(min(n + t + 1, rows) for n in lengths for t in range(new_tokens)) / new_tokens
    state = params["layers"][0]["mamba"]["a_log"].numel() * cfg.ssm.head_dim * cfg.ssm.state_dim
    step_bytes = (wbytes - table.numel() * table.element_size() + 2 * L * hkv * hd * 2 * ring_rows
                  + 2 * L * len(prompts) * state * 4)
    bound_s = step_bytes / HBM_BYTES_S
    dense = runs["dense"]
    summary = {
        "arch": cfg.name, "layers": L, "window": window, "cache_rows": rows,
        "prompt_lengths": list(lengths), "weights_bytes": wbytes, "weights_gb": wbytes / 1e9,
        "step_bytes_read": step_bytes, "step_bound_ms": bound_s * 1e3,
        "decode_tokens_per_s_bound_8_slots": len(prompts) / bound_s,
        "decode_tokens_per_s": dense["decode_tokens_per_s"],
        "decode_step_ms": (dense["decode_step_s"] or 0) * 1e3,
        "ttft_mean_s": dense["ttft_mean_s"], "ttft_p99_s": dense["ttft_p99_s"],
        "ttft_by_request_s": dense["ttft_by_request_s"],
        "peak_memory_bytes": max(r["max_memory_allocated_bytes"] or 0 for r in runs.values()),
        "streams_equal": equal, "refused": refusals, "card": card, "nvidia_smi": smi}
    print(f"  {cfg.name} at {L} layers on {card} ({smi}): weights {summary['weights_gb']} GB; "
          f"peak device memory {summary['peak_memory_bytes']} bytes; dense graph run: TTFT "
          f"mean {dense['ttft_mean_s']} s, p99 {dense['ttft_p99_s']} s, decode "
          f"{dense['decode_tokens_per_s']} tokens/s against the step's bound of "
          f"{summary['decode_tokens_per_s_bound_8_slots']} tokens/s at 8 slots "
          f"({summary['step_bound_ms']} ms a step); streams {equal}; refused {refusals}")
    busy = None
    if model.device.type == "cuda":
        print(f"  where a {cfg.name} decode step's time goes (torch.profiler, CUDA activity):")
        busy = busy_phase(torch, model, params, seed)
    return {"calls": calls, "runs": runs, "summary": summary, "busy": busy}


def whisper_phase(torch, model, params, kernels, seed: int, card: str, smi: str, *,
                  shape_log: ShapeLog, batch: int = WHISPER_BATCH,
                  cache_len: int = WHISPER_CACHE_LEN,
                  new_tokens: int = WHISPER_NEW_TOKENS) -> dict:
    """Whisper at full width and depth, weights from ``seed``: its model
    calls against the torch source (:func:`family_calls`), the engine's
    refusal, then greedy decoding of ``new_tokens`` tokens from the batch's
    prompt twice under cuda-strict (the tokens equal), with the encoder's,
    the decoder prefill's and the decode steps' seconds; decode tokens/s
    beside the step's bound: the decoder's weights a step reads (not the
    memory's wk and wv, nor the embedding table), the unembed, the memory's
    K/V and the self-attention rows up to each step's position, over 3.35
    TB/s; then a traced decode step."""
    from repro_torch.serve.engine import ServeEngine

    cfg = model.cfg
    tokens, frames = whisper_inputs(torch, cfg, seed, model.device, batch)
    calls = family_calls(torch, model, params, kernels,
                         whisper_calls(torch, model, params, tokens, frames, cache_len, seed),
                         encdec_launches(cfg, prefills=1, decodes=FAMILY_DECODE_STEPS),
                         shape_log=shape_log)
    try:
        ServeEngine(model, params, batch_slots=8, max_len=cache_len, device=model.device)
    except ValueError as e:
        refused = str(e)
    else:
        raise AssertionError(f"{cfg.name}: ServeEngine took an encoder-decoder model")
    from repro_torch.core import dispatch

    with dispatch.use(registry=shape_log.registry()):
        first, timing = whisper_greedy(torch, model, params, tokens, frames, cache_len,
                                       new_tokens)
    again, timing2 = whisper_greedy(torch, model, params, tokens, frames, cache_len, new_tokens)
    if not torch.equal(first, again):
        differ = (first != again).any(dim=1).nonzero().flatten().tolist()
        raise AssertionError(f"{cfg.name}: two greedy decodes differ in sequences {differ}")
    if not bool(((first >= 0) & (first < cfg.vocab_size)).all()):
        raise AssertionError(f"{cfg.name}: tokens out of the vocabulary")
    wbytes = weight_bytes(params)
    layer = params["decoder"][0]
    d, L, S = cfg.d_model, cfg.num_layers, tokens.shape[1]
    per_layer = sum(layer[key][w].numel() * 2 for key in ("attn", "mlp")
                    for w in layer[key]) + sum(layer["xattn"][w].numel() * 2
                                               for w in ("wq", "wo"))
    norms = 3 * d * 2
    kv = 2 * batch * cfg.num_kv_heads * cfg.head_dim * 2      # k and v of one row, bf16
    self_rows = sum(S + t + 1 for t in range(new_tokens)) / new_tokens
    step_bytes = (L * (per_layer + norms) + params["embed"]["unembed"].numel() * 2
                  + L * kv * (cfg.frontend_seq + self_rows))
    bound_s = step_bytes / HBM_BYTES_S
    decode_s = min(timing["decode_s"], timing2["decode_s"])
    summary = {
        "arch": cfg.name, "encoder_layers": cfg.encoder_layers, "decoder_layers": L,
        "batch": batch, "frames": cfg.frontend_seq, "prompt_tokens": S, "cache_len": cache_len,
        "new_tokens": new_tokens, "weights_bytes": wbytes, "weights_gb": wbytes / 1e9,
        "encoder_s": [timing["encoder_s"], timing2["encoder_s"]],
        "decoder_prefill_s": [timing["decoder_prefill_s"], timing2["decoder_prefill_s"]],
        "decode_s": [timing["decode_s"], timing2["decode_s"]],
        "decode_tokens_per_s": batch * new_tokens / decode_s,
        "decode_step_ms": decode_s / new_tokens * 1e3,
        "step_bytes_read": step_bytes, "step_bound_ms": bound_s * 1e3,
        "decode_tokens_per_s_bound": batch / bound_s,
        "greedy_decodes_equal": True, "refused": refused,
        "peak_memory_bytes": (torch.cuda.max_memory_allocated()
                              if model.device.type == "cuda" else None),
        "card": card, "nvidia_smi": smi}
    print(f"  {cfg.name} at {cfg.encoder_layers}+{L} layers on {card} ({smi}): weights "
          f"{summary['weights_gb']} GB; encoder {summary['encoder_s']} s and decoder prefill "
          f"{summary['decoder_prefill_s']} s for {batch} x {cfg.frontend_seq} frames and "
          f"{S} tokens; greedy decode {summary['decode_tokens_per_s']} tokens/s against the "
          f"step's bound of {summary['decode_tokens_per_s_bound']} tokens/s "
          f"({summary['step_bound_ms']} ms a step); the two decodes equal")
    trace = None
    if model.device.type == "cuda":
        print(f"  where a {cfg.name} decode step's time goes (torch.profiler, CUDA activity):")
        with dispatch.use(prefer=dispatch.policy_from_flag("cuda-strict")):
            logits, cache = model.prefill(params, {"tokens": tokens, "frames": frames},
                                          cache_len=cache_len)
            tok = torch.argmax(logits, dim=-1)[:, None]
            trace = traced_call(torch, lambda: model.decode_step(params, tok, dict(cache)))
        del cache
    return {"calls": calls, "summary": summary, "tokens_head": first[:, :8].tolist(),
            "launches": calls["launches"], "trace": trace}


def families_phase(torch, kernels, seed: int, card: str, smi: str, *, hymba=None,
                   whisper=None, hymba_kw=None, whisper_kw=None) -> dict:
    """Phase 15: hymba-1.5b, then whisper-large-v3, each at full width and
    depth with weights from ``seed`` (or the (model, params) given), freed
    before the next; the shapes their runs gave the kernels, for the
    summary's check against the kernel phase's rows."""
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model, init_params

    shape_log = ShapeLog()
    out = {}
    for arch, given, phase, kw in (("hymba-1.5b", hymba, hymba_phase, hymba_kw or {}),
                                   ("whisper-large-v3", whisper, whisper_phase,
                                    whisper_kw or {})):
        t = time.perf_counter()
        if given is None:
            model = build_model(get_arch(arch))
            params = init_params(model.param_specs(), seed)
        else:
            model, params = given
        if model.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        init_s = time.perf_counter() - t
        out[arch] = phase(torch, model, params, kernels, seed, card, smi, shape_log=shape_log,
                          **kw)
        out[arch]["summary"]["init_s"] = init_s
        del model, params
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    out["shape_keys"] = sorted(shape_log.keys, key=str)
    return out


# ---------------------------------------------------------------------------
# phase 18: internvl2-76b at full width, its depth cut to fit one card
# ---------------------------------------------------------------------------

INTERNVL_ARCH = "internvl2-76b"
#: 8 of its 80 layers: 13.7 GB of layers and 4.2 GB of embedding and
#: unembedding, where the whole model's 152 GB do not fit one card
INTERNVL_LAYERS = 8
#: the vlm path: 256 patch rows drawn on the card in front of 64 text
#: tokens, prefilled into a cache of the rows and the greedy steps
INTERNVL_PATCHES, INTERNVL_TEXT, INTERNVL_VLM_STEPS = 256, 64, 32
#: the engine's 8 text prompts (5 to 600 tokens; buckets 8, 64, 128, 256,
#: 512 and 1024, first-token fixups at 5, 200, 400 and 600) into 8 slots of
#: 1024 rows, 32 new tokens each, as a graph and as the eager loop
INTERNVL_LENGTHS = (5, 64, 128, 200, 256, 400, 512, 600)
INTERNVL_MAX_LEN, INTERNVL_NEW_TOKENS = 1024, 32
INTERNVL_RUNS = (("dense", {"batch_slots": 8}),
                 ("dense_loop", {"batch_slots": 8, "graphed": False}))


def dense_launches(cfg, *, prefills: int, decodes: int) -> dict[str, int]:
    """Each kernel's launches in a dense GQA model's direct calls: 7
    matmuls and 2 norms a layer, the final norm and an untied unembed a
    call; flash attention in every layer of a prefill, decode attention in
    every layer of a decode step."""
    L, calls = cfg.num_layers, prefills + decodes
    bf16_unembed, edge_unembed = unembed_launches(cfg)
    return {"matmul": (7 * L + bf16_unembed) * calls, "rmsnorm": (2 * L + 1) * calls,
            "flash_attention": L * prefills, "decode_attention": L * decodes,
            "paged_decode_attention": 0, "ssd": 0, "sample": 0,
            "matmul_edge": edge_unembed * calls}


def vlm_shapes(cfg, rows: int, steps: int) -> set[tuple]:
    """:func:`served_shapes`' keys of the vlm path: a prefill of ``rows``
    rows (patches and text) of one sequence, then ``steps`` decode steps of
    it over a cache of ``rows + steps`` rows."""
    hkv, hd = cfg.num_kv_heads, cfg.head_dim
    keys = {("matmul", M, K, N) for M in (rows, 1) for K, N in weight_kn(cfg)}
    if not cfg.tie_embeddings:
        keys.add(("matmul", 1, cfg.d_model, cfg.vocab_size))
    keys |= {("rmsnorm", R, cfg.d_model) for R in (rows, 1)}
    keys.add(("flash_attention", rows, rows, hkv, hd))
    keys.add(("decode_attention", 1, hkv, rows + steps, hd))
    return keys


def internvl2_rows(torch, gen, record, cfg=None) -> None:
    """The kernels at every shape the internvl2 phase gives them, each
    against its plain version beside its planted fault, timed beside the
    library call (``torch.matmul``, SDPA, ``F.rms_norm``) and the bound,
    keyed by the call's shape (``served_key``): the engine's (prefills at
    the prompts' buckets, fixups, decode steps of 8 slots over 1024 rows)
    and the vlm path's (a 320-row prefill, decode steps of one sequence
    over 352 rows); the SwiGLU gate's silu epilogue beside the plain
    product at the vlm path's rows."""
    import torch.nn.functional as F

    from repro_torch.configs import get_arch
    from repro_torch.kernels import decode_attention as dec_k
    from repro_torch.kernels import flash_attention as fa_k
    from repro_torch.kernels import matmul as mm_k
    from repro_torch.kernels import rmsnorm as rms_k

    cfg = cfg or get_arch(INTERNVL_ARCH)
    dev = torch.device("cuda")
    rows_vlm = INTERNVL_PATCHES + INTERNVL_TEXT

    def randn(shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(torch.bfloat16)

    keys = served_shapes(cfg, INTERNVL_LENGTHS, slots=8, max_len=INTERNVL_MAX_LEN)
    keys |= vlm_shapes(cfg, rows_vlm, INTERNVL_VLM_STEPS)
    hq, D = cfg.num_heads, cfg.head_dim
    for key in sorted(keys, key=str):
        op = key[0]
        if op == "matmul":
            _, M, K, N = key
            unembed = N == cfg.vocab_size
            out = torch.float32 if unembed else None
            sets = [(randn((M, K)), randn((K, N), K ** -0.5))
                    for _ in range(n_sets(2 * (M * K + K * N)))]
            x, w = sets[0]
            acts = (None, "silu") if N == cfg.d_ff and M in (1, rows_vlm) else (None,)
            for act in acts:
                kw = {"activation": act, **({"out_dtype": out} if out else {})}
                check = matmul_err(torch, mm_k.matmul(x, w, **kw), mm_k.plain_matmul(x, w, **kw),
                                   mm_k.matmul(drop_last_k_tile(x), w, **kw),
                                   TOL_F32 if out else TOL_BF16)
                record("matmul", f"[{M},{K}]x[{K},{N}] act={act} out="
                       f"{'float32' if out else 'bfloat16'}", check, sets if act is None else None,
                       lambda a, b, kw=kw: mm_k.matmul(a, b, **kw),
                       lambda a, b, kw=kw: mm_k.plain_matmul(a, b, **kw),
                       lambda a, b: torch.matmul(a, b),
                       2 * (M * K + K * N) + (4 if out else 2) * M * N, 2 * M * N * K,
                       BF16_TC_FLOPS, instance=mm_k.kernel_instance(x, w),
                       served_key=call_key("matmul", (x, w), kw))
            del sets, x, w
        elif op == "rmsnorm":
            _, R, Dm = key
            sets = [(randn((R, Dm)), randn((Dm,))) for _ in range(n_sets(4 * R * Dm))]
            check = max_err(torch, rms_k.rmsnorm(*sets[0]), rms_k.plain_rmsnorm(*sets[0]),
                            TOL_BF16)
            record("rmsnorm", f"[{R},{Dm}]", check, sets, rms_k.rmsnorm, rms_k.plain_rmsnorm,
                   lambda x, w: F.rms_norm(x, (x.shape[-1],), w, 1e-6),
                   2 * (2 * R * Dm + Dm), 4 * R * Dm, F32_FLOPS,
                   served_key=call_key("rmsnorm", sets[0], {}))
            del sets
        elif op == "flash_attention":
            _, S, T, hkv, _ = key
            per_set = 2 * (2 * hq * S * D + 2 * hkv * T * D)
            sound, dropped = flash_masks(torch, S, T, True, dev)
            sets = []
            for _ in range(n_sets(per_set)):
                q, k, v = randn((1, hq, S, D)), randn((1, hkv, T, D)), randn((1, hkv, T, D))
                sets.append((q, k, v, k.repeat_interleave(hq // hkv, 1),
                             v.repeat_interleave(hq // hkv, 1)))
            q, k, v = sets[0][:3]
            check = attention_err(torch, fa_k.flash_attention(q, k, v, causal=True),
                                  fa_k.plain_flash_attention(q, k, v, causal=True),
                                  masked_attention(torch, q, k, v, sound & ~dropped),
                                  dropped.sum(dim=-1) == 64)
            check["splits"] = fa_k.split_kv(1, hq, S, T, True, None, D)
            record("flash_attention", f"q[1,{hq},{S},{D}] kv[1,{hkv},{T},{D}] causal=True",
                   check, sets,
                   lambda q, k, v, ke, ve: fa_k.flash_attention(q, k, v, causal=True),
                   lambda q, k, v, ke, ve: fa_k.plain_flash_attention(q, k, v, causal=True),
                   lambda q, k, v, ke, ve: F.scaled_dot_product_attention(q, ke, ve,
                                                                          is_causal=True),
                   per_set, 4 * hq * D * int(sound.sum()), BF16_TC_FLOPS,
                   instance=f"fa_kernel<{fa_k.instance(D)},{fa_k.instance(D)}>",
                   served_key=call_key("flash_attention", (q, k, v), {"causal": True}))
            del sets, q, k, v
        else:                                           # decode attention
            _, B, hkv, T, _ = key
            # the engine's step: its prompts a few tokens in; a fixup or the
            # vlm path: the cache's every row
            lengths = torch.tensor([min(n + INTERNVL_NEW_TOKENS // 2, T) for n in
                                    INTERNVL_LENGTHS] if B == 8 else [T] * B,
                                   dtype=torch.int32, device=dev)
            valid, dropped = decode_masks(torch, lengths, T)
            sets = []
            for _ in range(n_sets(2 * 2 * B * hkv * T * D)):
                q, kc, vc = randn((B, hq, D)), randn((B, hkv, T, D)), randn((B, hkv, T, D))
                sets.append((q, kc, vc, q[:, :, None], kc.repeat_interleave(hq // hkv, 1),
                             vc.repeat_interleave(hq // hkv, 1)))
            q, kc, vc = sets[0][:3]
            fault = masked_attention(torch, q[:, :, None], kc, vc,
                                     (valid & ~dropped)[:, None, None])
            check = attention_err(torch, dec_k.decode_attention(q, kc, vc, lengths),
                                  dec_k.plain_decode_attention(q, kc, vc, lengths),
                                  fault[:, :, 0], dropped.any(dim=-1)[:, None])
            check["splits"] = dec_k.last_splits
            n_keys = int(lengths.sum())
            record("decode_attention", f"q[{B},{hq},{D}] cache[{B},{hkv},{T},{D}] lengths "
                   f"{int(lengths.min())}..{int(lengths.max())}", check, sets,
                   lambda q, kc, vc, q4, ke, ve, n=lengths: dec_k.decode_attention(q, kc, vc, n),
                   lambda q, kc, vc, q4, ke, ve, n=lengths:
                       dec_k.plain_decode_attention(q, kc, vc, n),
                   lambda q, kc, vc, q4, ke, ve, m=valid: F.scaled_dot_product_attention(
                       q4, ke, ve, attn_mask=m[:, None, None, :]),
                   2 * (2 * B * hq * D + 2 * hkv * n_keys * D), 4 * hq * D * n_keys,
                   BF16_TC_FLOPS, instance=f"dec_kernel<{D},DenseRows>",
                   served_key=call_key("decode_attention", (q, kc), {}))
            del sets, q, kc, vc, fault


def vlm_calls(torch, model, params, tokens, patches, greedy):
    """The vlm path's calls, as a function of no arguments: the prefill of
    ``tokens`` [1, S] with ``patches`` [1, P, d] over their first rows into
    a cache of S + len(greedy) rows, then a decode step for each of
    ``greedy``'s tokens (the cuda-strict run's greedy stream, fed to every
    source alike); the logits by kind."""
    S = tokens.shape[1]

    def run():
        logits, cache = model.prefill(params, {"tokens": tokens, "patch_embeds": patches},
                                      cache_len=S + len(greedy))
        out = {"prefill": [logits[0]], "decode": []}
        for tok in greedy:
            logits, cache = model.decode_step(params, tok.reshape(1, 1), cache)
            out["decode"].append(logits[0])
        return out
    return run


def internvl2_phase(torch, model, params, kernels, seed: int, card: str, smi: str, *,
                    shape_log: ShapeLog, full_layers: int, lengths=INTERNVL_LENGTHS,
                    max_len: int = INTERNVL_MAX_LEN, new_tokens: int = INTERNVL_NEW_TOKENS,
                    patches: int = INTERNVL_PATCHES, text: int = INTERNVL_TEXT,
                    vlm_steps: int = INTERNVL_VLM_STEPS) -> dict:
    """internvl2-76b at full width, its depth cut to the model's layers,
    weights from ``seed``.  The vlm path: ``patches`` patch rows drawn on
    the device in front of ``text`` tokens, prefilled, then ``vlm_steps``
    greedy decode steps under cuda-strict; the same calls under the torch
    source and with every kernel held against its plain version
    (:func:`family_calls`: logits within MODEL_REL_L2_TOL, launches
    counted).  The engine (which takes no patches, in either package):
    the text prompts through INTERNVL_RUNS, streams equal graph and loop.
    Reports the weights' bytes, peak memory, TTFT and the graph run's
    decode tokens/s beside the weights' bound (every weight but the
    embedding table, read once a step, over hw.py's HBM rate)."""
    from repro_torch.core import dispatch

    cfg, dev = model.cfg, model.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 9)
    S = patches + text
    tokens = torch.randint(0, cfg.vocab_size, (1, S), generator=gen, device=dev)
    pe = (torch.randn((1, patches, cfg.d_model), generator=gen, device=dev) * 0.02).to(
        torch.bfloat16)
    print(f"  {cfg.name}: full width (d_model {cfg.d_model}, d_ff {cfg.d_ff}, "
          f"{cfg.num_heads}/{cfg.num_kv_heads} heads of {cfg.head_dim}, vocab {cfg.vocab_size}, "
          f"untied); depth cut {full_layers} -> {cfg.num_layers} layers; weights "
          f"{weight_bytes(params) / 1e9:.2f} GB from --seed")
    # the vlm path's greedy stream under cuda-strict, then its calls on it
    with dispatch.use(prefer=dispatch.policy_from_flag("cuda-strict")), torch.no_grad():
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, {"tokens": tokens, "patch_embeds": pe},
                                      cache_len=S + vlm_steps)
        greedy = [logits.argmax(-1).int()]
        for _ in range(vlm_steps - 1):
            logits, cache = model.decode_step(params, greedy[-1].reshape(1, 1), cache)
            greedy.append(logits.argmax(-1).int())
        if dev.type == "cuda":
            torch.cuda.synchronize()
        vlm_s = time.perf_counter() - t0
        del cache
    greedy = torch.cat(greedy)
    with torch.no_grad():
        calls = family_calls(torch, model, params, kernels,
                             vlm_calls(torch, model, params, tokens, pe, greedy),
                             dense_launches(cfg, prefills=1, decodes=len(greedy)),
                             shape_log=shape_log)
    calls["vlm_rows"] = {"patches": patches, "text": text, "greedy_steps": vlm_steps,
                         "wall_s": vlm_s, "kernel_shapes": sorted(vlm_shapes(cfg, S,
                                                                             len(greedy)))}
    prompts = family_prompts(torch, cfg.vocab_size, seed, lengths)
    runs, streams = {}, {}
    for name, kw in INTERNVL_RUNS:
        runs[name], streams[name] = serve_run(torch, model, params, kernels, prompts,
                                              new_tokens=new_tokens, max_len=max_len, **kw)
        print("  " + json.dumps({"arch": cfg.name, "run": name, **runs[name]}))
    differ = [i for i, (a, b) in enumerate(zip(streams["dense_loop"], streams["dense"]))
              if a != b]
    if differ:
        raise AssertionError(f"{cfg.name}: the loop's streams differ from the graph's in "
                             f"requests {differ}")
    wbytes = weight_bytes(params)
    table = params["embed"]["tok"]
    bound_s = (wbytes - table.numel() * table.element_size()) / HBM_BYTES_S
    dense = runs["dense"]
    summary = {
        "arch": cfg.name, "layers": cfg.num_layers, "full_layers": full_layers,
        "reduced": {"num_layers": [full_layers, cfg.num_layers]},
        "prompt_lengths": list(lengths), "weights_bytes": wbytes, "weights_gb": wbytes / 1e9,
        "step_bound_ms": bound_s * 1e3, "decode_tokens_per_s_bound_8_slots": 8 / bound_s,
        "decode_tokens_per_s": dense["decode_tokens_per_s"],
        "decode_step_ms": (dense["decode_step_s"] or 0) * 1e3,
        "bound_share": (dense["decode_tokens_per_s"] or 0) * bound_s / 8,
        "ttft_mean_s": dense["ttft_mean_s"], "ttft_p99_s": dense["ttft_p99_s"],
        "peak_memory_bytes": max(r["max_memory_allocated_bytes"] or 0 for r in runs.values()),
        "streams_equal": f"{len(prompts)} of {len(prompts)} loop equal graph",
        "vlm_logits_worst_rel_l2": max(max(calls[k]["rel_l2"]) for k in ("prefill", "decode")),
        "card": card, "nvidia_smi": smi}
    print(f"  {cfg.name} at {cfg.num_layers} of {full_layers} layers on {card} ({smi}): "
          f"weights {summary['weights_gb']:.2f} GB; peak device memory "
          f"{summary['peak_memory_bytes']} bytes; vlm path ({patches} patch rows + {text} "
          f"tokens, {vlm_steps} greedy steps) logits within {summary['vlm_logits_worst_rel_l2']} "
          f"of the torch source's; dense graph run: TTFT mean {dense['ttft_mean_s']} s, p99 "
          f"{dense['ttft_p99_s']} s, decode {dense['decode_tokens_per_s']} tokens/s against "
          f"the weights' bound of {summary['decode_tokens_per_s_bound_8_slots']} tokens/s at 8 "
          f"slots ({summary['step_bound_ms']} ms a step); streams {summary['streams_equal']}")
    busy = None
    if dev.type == "cuda":
        print(f"  where a {cfg.name} decode step's time goes (torch.profiler, CUDA activity):")
        busy = busy_phase(torch, model, params, seed)
    return {"calls": calls, "runs": runs, "summary": summary, "busy": busy}


# ---------------------------------------------------------------------------
# phase 19: the examples and the dry run against the card
# ---------------------------------------------------------------------------


def examples_phase(torch) -> dict:
    """``repro_torch.examples.quickstart`` and ``serve_lm`` on the card: each
    holds its own checks (every policy within its tolerance of the oracle,
    the queued roles' product; fused equals unfused, paged, overcommitted
    and tiered equal dense, every conv frame equal to the plain conv2d) and
    raises where one fails."""
    from repro_torch.examples import quickstart, serve_lm

    t = time.perf_counter()
    q = quickstart.run("cuda", verbose=False)
    s = serve_lm.run("cuda", verbose=False)
    res = {"quickstart": {"max_err": q["max_err"], "tolerance": quickstart.TOL,
                          "residency": q["residency"]},
           "serve_lm": {"checks": s["checks"], "frames": s["frames"], "waves": s["waves"],
                        "preemptions": s["preemptions"], "spills": s["spills"]},
           "seconds": time.perf_counter() - t}
    print("  " + json.dumps(res))
    return res


#: the steps the dry-run phase counts on meta tensors at a 1x1 mesh, each
#: one the card runs in an earlier phase: (arch, depth or None, shape,
#: microbatches or None for the train phase's)
DRYRUN_CELLS = {
    "llama_decode": ("llama3.2-1b", None, ("decode_8x1024", 1024, 8, "decode")),
    "llama_prefill": ("llama3.2-1b", None, ("prefill_1x1024", 1024, 1, "prefill")),
    "llama_train": ("llama3.2-1b", None, ("train_8x1024", 1024, 8, "train")),
    "yi9b_decode": ("yi-9b", None, ("decode_8x1024", 1024, 8, "decode")),
    "internvl2_decode": (INTERNVL_ARCH, INTERNVL_LAYERS, ("decode_8x1024", 1024, 8, "decode")),
}


def dryrun_records(cells=None) -> dict:
    """Each of DRYRUN_CELLS counted on meta tensors at a 1x1 mesh under a
    fake process group of one (``launch.dryrun.count_on_one_rank``): its
    dry-run record.  The train cell takes the train phase's microbatches
    (``auto_microbatches``)."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.dryrun import count_on_one_rank
    from repro_torch.train.step import auto_microbatches

    out = {}
    for name, (arch, layers, shape) in (cells or DRYRUN_CELLS).items():
        cfg = get_arch(arch)
        if layers is not None:
            cfg = dataclasses.replace(cfg, num_layers=layers)
        shape = ShapeConfig(*shape)
        mb = (auto_microbatches(shape.global_batch, shape.seq_len, cfg=cfg)
              if shape.kind == "train" else 1)
        out[name] = count_on_one_rank(cfg, shape, microbatches=mb)
    return out


def check_chip_constants(torch) -> dict:
    """hw.py's constants that the card reports, against
    ``torch.cuda.get_device_properties(0)``: raises where one differs."""
    props = torch.cuda.get_device_properties(0)
    got = {"name": props.name, "hbm_bytes": props.total_memory,
           "sm_count": props.multi_processor_count,
           "vmem_bytes": props.shared_memory_per_block_optin,
           "smem_per_sm_bytes": props.shared_memory_per_multiprocessor}
    want = {k: getattr(CHIP, k) for k in got}
    if got != want:
        raise AssertionError(f"hw.py's constants differ from the card's: hw.py {want}, card {got}")
    return got


def dryrun_phase(torch, records: dict, measured: dict, live: dict, card: str, smi: str) -> dict:
    """Each counted step against the card: the roofline's ``step_bound_s``
    (hw.py's H100 constants) must not exceed the measured device time of
    the same step (a bound above a measured time means the count or a
    constant is wrong), and the record's parameter (and optimizer-state)
    bytes must equal the live tensors' the phase built.  Printed, not
    gated: the bound's share of the measured time, and the predicted peak
    (arguments and temporaries) beside ``torch.cuda.max_memory_allocated``."""
    out = {}
    for name, rec in records.items():
        m, mem = measured[name], rec["memory"]
        bound_s = rec["roofline"]["step_bound_s"]
        counted = mem["param_bytes"] + mem["opt_state_bytes"]
        row = {"step": name, "bound_s": bound_s, "bottleneck": rec["roofline"]["bottleneck"],
               "flops": rec["flops_per_device"], "bytes": rec["bytes_per_device"],
               "measured_s": m["s"], "measured_from": m["from"],
               "bound_share": bound_s / m["s"], "argument_bytes": mem["argument_bytes"],
               "param_and_state_bytes": counted, "live_bytes": live[name],
               "predicted_peak_bytes": mem["argument_bytes"] + mem["temp_bytes"],
               "max_memory_allocated_bytes": m.get("peak"), "meta_run_s": rec["compile_s"]}
        print("  " + json.dumps(row))
        if m["s"] < bound_s:
            raise AssertionError(f"{name}: the roofline's bound {bound_s} s is above the "
                                 f"measured {m['s']} s on {card} ({smi})")
        if counted != live[name]:
            raise AssertionError(f"{name}: the dry run counts {counted} bytes of parameters "
                                 f"and state, the card holds {live[name]}")
        out[name] = row
    return out


def busy_measured(res: dict, steps: int, wall_key: str = "untraced_wall_us") -> dict:
    """A traced step's device time over ``steps``: the span in which some
    kernel ran (``device_union_us``; kernels overlap under programmatic
    dependent launch, so their sum counts the overlap twice), else the
    kernels' sum, or the untraced wall time where the trace held no device
    events."""
    peak = res.get("max_memory_allocated_bytes")
    for key, source in (("device_union_us", "torch.profiler device time, union of kernels"),
                        ("device_busy_us", "torch.profiler device time, sum of kernels"),
                        (wall_key, "wall time (no device events traced)")):
        if res.get(key) is not None:
            return {"s": res[key] / steps * 1e-6, "from": source, "peak": peak}
    raise KeyError(f"no device or wall time in {sorted(res)}")


TRAIN_ARCH = "llama3.2-1b"
TRAIN_BATCH, TRAIN_SEQ = 8, 1024
#: steps after the warm-up step
TRAIN_STEPS = 10
TRAIN_WARMUP_STEPS = 2
TRAIN_F32_REL_TOL = 2e-2
#: the resume check: depth, steps before and after the checkpoint
RESUME_LAYERS, RESUME_STEPS = 2, 2
GREEDY_PROMPT, GREEDY_NEW = 16, 16


def train_flops(cfg, n_params: int, batch: int, seq: int) -> float:
    """A training step's model FLOPs: 6 N a token, and attention's two
    products over the causal half of each layer's [S, S] (2 B H S^2 hd
    forward), three times for the backward pass."""
    attention = 3 * cfg.num_layers * 2 * batch * cfg.num_heads * seq * seq * cfg.head_dim
    return 6.0 * n_params * batch * seq + attention


def greedy_streams(torch, model, params, prompts, new_tokens: int, policy: str,
                   registry=None):
    """Greedy decoding of ``prompts`` [B, P] under ``policy``: a batched
    prefill, then ``new_tokens - 1`` decode steps each feeding back the
    argmax; (tokens [B, new_tokens], the scores each token was chosen from
    [B, new_tokens, V])."""
    from repro_torch.core import dispatch

    toks, scores = [], []
    with dispatch.use(prefer=dispatch.policy_from_flag(policy), registry=registry), \
            torch.no_grad():
        logits, cache = model.prefill(params, {"tokens": prompts},
                                      cache_len=prompts.shape[1] + new_tokens)
        for i in range(new_tokens):
            scores.append(logits)
            toks.append(torch.argmax(logits, dim=-1))
            if i + 1 < new_tokens:
                logits, cache = model.decode_step(params, toks[-1][:, None].to(torch.int32),
                                                  cache)
    return torch.stack(toks, dim=1), torch.stack(scores, dim=1)


def streams_agree(torch, got, got_scores, want, want_scores) -> dict:
    """Each stream of ``got`` against ``want``'s, token by token, up to its
    first position where ``want``'s two best scores lie within
    SAMPLE_TIE_ULPS ulps (a near tie either side may break): the tokens
    compared, the first that differs where the scores lie apart, and the
    largest relative L2 of ``got``'s scores against ``want``'s over the
    compared positions (the same prefix fed to both)."""
    top = want_scores.topk(2, dim=-1).values
    best = top[..., 0].abs()
    clear = ((top[..., 0] - top[..., 1]) / (torch.nextafter(best, best + 1) - best)
             > SAMPLE_TIE_ULPS).cpu()
    rel = ((got_scores - want_scores).norm(dim=-1) / want_scores.norm(dim=-1)).cpu()
    got, want = got.cpu(), want.cpu()
    compared, differ, worst = 0, [], 0.0
    for b in range(want.shape[0]):
        for i in range(want.shape[1]):
            if not clear[b, i]:
                break
            compared += 1
            worst = max(worst, float(rel[b, i]))
            if got[b, i] != want[b, i]:
                differ.append([b, i])
                break
    return {"compared": compared, "of": want.numel(), "differ_at": differ,
            "max_scores_rel_l2": worst}


def train_phase(torch, seed: int, card: str, smi: str) -> dict:
    """Phase 16: llama3.2-1b trained at full width and depth under the
    ``torch`` policy (AdamW from ``pick_opt``, warm-up over
    TRAIN_WARMUP_STEPS steps, remat ``full``, TRAIN_BATCH x TRAIN_SEQ tokens
    from the synthetic stream): the first step's gradients finite and
    nonzero on every leaf (``tok`` among them), its loss and grad norm
    against the same weights in f32 on the card; a warm-up step and
    TRAIN_STEPS timed ones through ``TrainLoop`` (no hand-written kernel
    launched), the loss falling, and one more step traced; resume from a
    checkpoint at RESUME_LAYERS
    layers bitwise the unbroken run; then greedy streams under cuda-strict on
    the refreshed weights (every kernel held against its plain version on
    the calls' data) against the torch source's on the training tree, and
    a planted stale ``tok_f32`` caught."""
    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens, make_batch_iterator, \
        to_device
    from repro_torch.kernels import launch_counters
    from repro_torch.launch.specs import pick_opt
    from repro_torch.models import build_model, init_params, layers
    from repro_torch.models.params import trainable, tree_leaves, tree_map, tree_paths
    from repro_torch.optim.adamw import global_norm, opt_init
    from repro_torch.train.loop import LoopConfig, TrainLoop
    from repro_torch.train.step import auto_microbatches, make_train_step, value_and_grad

    cfg = get_arch(TRAIN_ARCH)
    model = build_model(cfg)
    dev = model.device
    served0 = init_params(model.param_specs(), seed)
    params = trainable(served0)
    n_params = sum(t.numel() for t in tree_leaves(params))
    opt = dataclasses.replace(pick_opt(cfg), warmup_steps=TRAIN_WARMUP_STEPS)
    mb = auto_microbatches(TRAIN_BATCH, TRAIN_SEQ, cfg=cfg)
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                          global_batch=TRAIN_BATCH, seed=seed)
    res = {"arch": cfg.name, "layers": cfg.num_layers, "d_model": cfg.d_model,
           "vocab": cfg.vocab_size, "params": n_params, "remat": cfg.remat,
           "optimizer": dataclasses.asdict(opt), "microbatches": mb,
           "batch": [TRAIN_BATCH, TRAIN_SEQ], "card": card, "nvidia_smi": smi}

    # the first step's gradients, and the same weights in f32
    batch0 = to_device(SyntheticTokens(data_cfg).batch_at(0), dev)
    loss, _, grads = value_and_grad(model, params, batch0)
    norms = {k: float(torch.linalg.vector_norm(g.float())) for k, g in
             zip(tree_paths(grads), tree_leaves(grads))}
    bad = {k: v for k, v in norms.items() if not math.isfinite(v) or v == 0.0}
    if bad:
        raise AssertionError(f"leaves with a non-finite or zero gradient: {bad}")
    gnorm = float(global_norm(grads))
    del grads
    params32 = tree_map(lambda t: t.float(), params)
    old = layers.COMPUTE_DTYPE
    layers.COMPUTE_DTYPE = torch.float32
    try:
        loss32, _, grads32 = value_and_grad(model, params32, batch0)
        gnorm32 = float(global_norm(grads32))
    finally:
        layers.COMPUTE_DTYPE = old
    del params32, grads32
    first = {"loss": float(loss), "loss_f32": float(loss32), "grad_norm": gnorm,
             "grad_norm_f32": gnorm32, "tok_grad_norm": norms["['embed']['tok']"],
             "leaves": len(norms), "tolerance_rel": TRAIN_F32_REL_TOL}
    first["loss_rel"] = abs(first["loss"] - first["loss_f32"]) / first["loss_f32"]
    first["grad_norm_rel"] = abs(gnorm - gnorm32) / gnorm32
    res["first_step"] = first
    print("  first step: " + json.dumps(first))
    if max(first["loss_rel"], first["grad_norm_rel"]) > TRAIN_F32_REL_TOL:
        raise AssertionError(f"the first step's loss or grad norm differs from f32's: {first}")
    gc.collect()
    torch.cuda.empty_cache()

    # a warm-up step, then TRAIN_STEPS timed ones through the loop
    step_fn = make_train_step(model, opt, microbatches=mb)
    per_step: list[dict] = []

    def recorded(p, o, b):
        p, o, m = step_fn(p, o, b)
        per_step.append(m)
        return p, o, m

    batches = make_batch_iterator(data_cfg)
    loop = TrainLoop(recorded, lambda s: next(batches),
                     LoopConfig(total_steps=1 + TRAIN_STEPS, log_every=0), log=print)
    before = launch_counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params, state, report = loop.run(params, opt_init(opt, params))
    peak = torch.cuda.max_memory_allocated()
    launched = {f"{mod}.{counter}": n - before[mod, counter]
                for (mod, counter), n in launch_counters().items()}
    if any(launched.values()):
        raise AssertionError(f"training launched hand-written kernels: {launched}")
    losses = [float(m["loss"]) for m in per_step]
    step_s = report.step_times_s[1:]
    mean_s = sum(step_s) / len(step_s)
    flops = train_flops(cfg, n_params, TRAIN_BATCH, TRAIN_SEQ)
    res["train"] = {
        "steps": len(step_s), "warmup_step_s": report.step_times_s[0], "step_s": step_s,
        "mean_step_s": mean_s, "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / mean_s,
        "peak_memory_bytes": peak, "model_flops_per_step": flops,
        "flop_share_of_989_tflops": flops / mean_s / BF16_TC_FLOPS,
        "loss": losses, "grad_norm": [float(m["grad_norm"]) for m in per_step],
        "lr": [float(m["lr"]) for m in per_step], "kernel_launches": launched,
        "param_bytes": weight_bytes(params), "opt_state_bytes": weight_bytes(state)}
    print("  " + json.dumps(res["train"]))
    print(f"  {cfg.name} training on {card} ({smi}): {mean_s * 1e3:.1f} ms a step, "
          f"{TRAIN_BATCH * TRAIN_SEQ / mean_s:.0f} tokens/s, peak memory {peak / 1e9:.2f} GB, "
          f"{flops / mean_s / 1e12:.1f} TFLOP/s of model FLOPs = "
          f"{flops / mean_s / BF16_TC_FLOPS:.4f} of 989")
    if not all(math.isfinite(x) for x in losses) or losses[-1] >= losses[0]:
        raise AssertionError(f"the loss did not fall: {losses}")
    print("  where a training step's time goes (torch.profiler, CUDA activity):")
    batch = to_device(SyntheticTokens(data_cfg).batch_at(1 + TRAIN_STEPS), dev)
    res["train"]["trace"] = traced_call(torch, lambda: step_fn(params, state, batch))
    del batch

    res["greedy"] = train_greedy_check(torch, model, params, served0["embed"]["tok_f32"],
                                       data_cfg)
    del params, state, served0, loop, per_step, batches
    gc.collect()
    torch.cuda.empty_cache()
    res["resume"] = train_resume_check(torch, cfg, opt, data_cfg, seed)
    return res


def train_greedy_check(torch, model, params, stale_tok_f32, data_cfg) -> dict:
    """Greedy streams after training: under cuda-strict on the refreshed
    serving weights, every kernel call held against its plain version
    (:class:`KernelChecks`), against the torch source's on the training
    tree (which reads ``tok`` itself): tokens equal up to each stream's
    first near tie, and the scores they were chosen from within
    MODEL_REL_L2_TOL relative L2, as the model phases hold cuda-strict
    logits.  The same with the initial table's f32 copy left in place must
    fail it.  (Ten steps teach the model the stream's commonest tokens:
    greedy streams repeat one token under either table, so the tokens alone
    cannot see a stale table; the scores can.)"""
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.models.params import refresh_derived, tree_map

    prompts = torch.from_numpy(SyntheticTokens(data_cfg).batch_at(10_000)["tokens"]
                               [:, :GREEDY_PROMPT]).to(model.device)
    want, want_scores = greedy_streams(torch, model, params, prompts, GREEDY_NEW, "torch")
    served = refresh_derived(tree_map(lambda t: t, params))
    checks = KernelChecks(torch)
    got, got_scores = greedy_streams(torch, model, served, prompts, GREEDY_NEW, "cuda-strict",
                                     registry=checks.registry())
    stale = {**served, "embed": {**served["embed"], "tok_f32": stale_tok_f32}}
    stale_toks, stale_scores = greedy_streams(torch, model, stale, prompts, GREEDY_NEW,
                                              "cuda-strict")
    out = {"refreshed": streams_agree(torch, got, got_scores, want, want_scores),
           "stale": streams_agree(torch, stale_toks, stale_scores, want, want_scores),
           "streams": [prompts.shape[0], GREEDY_NEW], "tie_ulps": SAMPLE_TIE_ULPS,
           "scores_tolerance_rel_l2": MODEL_REL_L2_TOL,
           "kernels_held_against_plain": {op: len(v) for op, v in checks.worst.items()},
           "kernel_worst_errors": checks.worst, "tokens": want.tolist()}
    print("  greedy after training: " + json.dumps({k: v for k, v in out.items()
                                                    if k not in ("tokens", "kernel_worst_errors")}))

    def passes(res: dict) -> bool:
        return (not res["differ_at"] and res["compared"] >= res["of"] // 2
                and res["max_scores_rel_l2"] <= MODEL_REL_L2_TOL)

    if not passes(out["refreshed"]):
        raise AssertionError(f"cuda-strict streams on the refreshed weights part from the "
                             f"torch source's: {out}")
    if passes(out["stale"]):
        raise AssertionError(f"a stale tok_f32 went unseen: {out}")
    return out


def train_resume_check(torch, cfg, opt, data_cfg, seed: int) -> dict:
    """RESUME_LAYERS layers at full width: 2 x RESUME_STEPS steps through
    one ``TrainLoop``, against RESUME_STEPS steps, a checkpoint, and a new
    loop that resumes from it for RESUME_STEPS more: parameters and
    optimizer state bit for bit."""
    import shutil

    from repro_torch.data.pipeline import SyntheticTokens, to_device
    from repro_torch.models import build_model
    from repro_torch.models.params import tree_leaves, tree_paths
    from repro_torch.train.loop import LoopConfig, TrainLoop
    from repro_torch.train.step import init_train_state, make_train_step

    model = build_model(dataclasses.replace(cfg, num_layers=RESUME_LAYERS))
    src = SyntheticTokens(data_cfg)
    step_fn = make_train_step(model, opt)
    ckpt = ROOT / "build" / "train_resume"
    shutil.rmtree(ckpt, ignore_errors=True)

    def run(total: int, ckpt_dir):
        loop = TrainLoop(step_fn, lambda s: to_device(src.batch_at(s), model.device),
                         LoopConfig(total_steps=total, ckpt_dir=ckpt_dir, keep=1, log_every=0),
                         log=print)
        return loop.run(*init_train_state(model, opt, seed=seed))

    try:
        whole_p, whole_o, _ = run(2 * RESUME_STEPS, None)
        t = time.perf_counter()
        run(RESUME_STEPS, str(ckpt))
        save_s = time.perf_counter() - t
        resumed_p, resumed_o, report = run(2 * RESUME_STEPS, str(ckpt))
        ckpt_bytes = sum(f.stat().st_size for f in ckpt.rglob("*") if f.is_file())
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    differ = [k for k, a, b in zip(tree_paths((whole_p, whole_o)), tree_leaves((whole_p, whole_o)),
                                   tree_leaves((resumed_p, resumed_o)))
              if not torch.equal(a, b)]
    out = {"layers": RESUME_LAYERS, "steps": [RESUME_STEPS, RESUME_STEPS],
           "resumed_from": report.resumed_from, "leaves": len(tree_leaves((whole_p, whole_o))),
           "leaves_differing": differ, "first_run_with_checkpoint_s": save_s,
           "checkpoint_bytes": ckpt_bytes}
    print("  resume: " + json.dumps(out))
    if report.resumed_from != RESUME_STEPS or differ:
        raise AssertionError(f"the resumed run differs from the unbroken one: {out}")
    return out


DIST_ARCH = "llama3.2-1b"
DIST_SLOTS, DIST_PROMPT, DIST_DECODE_STEPS = 8, 128, 16
DIST_TRAIN_STEPS = 2
DIST_SERVE_ARGV = ("--arch", "llama3.2-1b", "--requests", "6")
DIST_KERNELS = ("matmul", "rmsnorm", "flash_attention", "decode_attention")


def dist_phase(torch, kernels, seed: int, card: str, smi: str, *, cfg=None,
               device: str = "cuda", train_batch: tuple[int, int] = (TRAIN_BATCH, TRAIN_SEQ),
               serve_argv=DIST_SERVE_ARGV, check_launches: bool = True) -> dict:
    """Phase 17: the sharded entry points on a one-rank 1x1 ("data",
    "model") mesh (NCCL over one card), DIST_ARCH at full width and depth
    from ``seed``: ``make_prefill_step`` and DIST_DECODE_STEPS
    ``make_decode_step`` steps at DIST_SLOTS slots under cuda-strict, every
    logit bit for bit ``DecoderLM.prefill``'s and ``decode_step``'s on the
    same weights and the greedy tokens equal (a collective over one rank is
    the identity); DIST_TRAIN_STEPS ``make_train_step`` steps under the
    rules at ``train_batch`` tokens against the one-device step, every
    leaf compared bit for bit; ``launch.serve``'s ``main`` answering its
    requests; ``compressed_psum`` through NCCL, ``quantize_int8`` bitwise
    the CPU's.  The kernels' counts are set to 0 just before the sharded
    steps run and read after the launcher: each of DIST_KERNELS must have
    launched.  ``cfg``, ``device`` and
    the sizes rehearse it on the CPU (gloo; no kernel, so no count)."""
    import contextlib
    import io

    import torch.distributed as dist

    from repro_torch.configs import get_arch
    from repro_torch.core import dispatch
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens, to_device
    from repro_torch.dist.collectives import compressed_psum, dequantize_int8, quantize_int8
    from repro_torch.dist.sharding import ShardingRules
    from repro_torch.kernels import matmul as mm_k
    from repro_torch.launch import serve as launch_serve
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.specs import pick_opt
    from repro_torch.models import build_model, init_params
    from repro_torch.models.params import trainable, tree_leaves, tree_paths
    from repro_torch.optim.adamw import opt_init
    from repro_torch.serve.engine import make_decode_step, make_prefill_step
    from repro_torch.train.step import auto_microbatches, init_train_state, make_train_step

    t0 = time.perf_counter()
    cfg = cfg or get_arch(DIST_ARCH)
    mesh = make_mesh((1, 1), ("data", "model"), device=device)
    res: dict = {"arch": cfg.name, "layers": cfg.num_layers, "mesh": [1, 1],
                 "backend": dist.get_backend(), "card": card, "nvidia_smi": smi}
    try:
        model = build_model(cfg, device=mesh.device)
        params = init_params(model.param_specs(), seed, device=mesh.device)
        serving = ShardingRules.for_arch(cfg, mesh, serving=True)
        gen = torch.Generator(device=mesh.device)
        gen.manual_seed(seed)
        cache_len = DIST_PROMPT + DIST_DECODE_STEPS
        prompt = torch.randint(1, cfg.vocab_size, (DIST_SLOTS, DIST_PROMPT), generator=gen,
                               device=mesh.device)

        # serving: the sharded steps against the model's own calls
        with dispatch.use(prefer=dispatch.policy_from_flag("cuda-strict")):
            pre, p_sh, _ = make_prefill_step(model, serving, global_batch=DIST_SLOTS,
                                             cache_len=cache_len)
            dec, _, _, _ = make_decode_step(model, serving, global_batch=DIST_SLOTS,
                                            cache_len=cache_len)
            local = [sh.local(p) for p, sh in zip(tree_leaves(params), tree_leaves(p_sh))]
            if not all(a is b for a, b in zip(local, tree_leaves(params))):
                raise AssertionError("a 1x1 mesh's local slices are not the leaves themselves")
            runs = {}
            for name in ("model", "sharded"):
                if name == "sharded":
                    # the phase's counts: the sharded steps' launches and the launcher's
                    for mod in kernels:
                        mod.launches = 0
                    mm_k.edge_launches = mm_k.f32_launches = 0
                    logits, cache = pre(params, {"tokens": prompt})
                else:
                    logits, cache = model.prefill(params, {"tokens": prompt}, cache_len=cache_len)
                out, toks = [logits], []
                for _ in range(DIST_DECODE_STEPS):
                    tok = out[-1].argmax(-1)[:, None]
                    toks.append(tok)
                    if name == "sharded":
                        logits, cache = dec(params, tok, cache)
                    else:
                        logits, cache = model.decode_step(params, tok, cache)
                    out.append(logits)
                runs[name] = (out, torch.cat(toks, 1))
                del cache
        differ = [i for i, (a, b) in enumerate(zip(runs["sharded"][0], runs["model"][0]))
                  if not torch.equal(a, b)]
        res["serve_steps"] = {"prefill_rows": [DIST_SLOTS, DIST_PROMPT],
                              "decode_steps": DIST_DECODE_STEPS, "logits_differ_at": differ,
                              "tokens_equal": bool(torch.equal(runs["sharded"][1],
                                                               runs["model"][1]))}
        print("  sharded prefill and decode steps against the model's: "
              + json.dumps(res["serve_steps"]))
        if differ or not res["serve_steps"]["tokens_equal"]:
            raise AssertionError(f"the sharded steps' logits differ from the model's at "
                                 f"calls {differ}")
        del runs

        # the serving launcher through its main
        argv = [*serve_argv] + ([] if mesh.device.type == "cuda" else ["--device", "cpu"])
        buf = io.StringIO()
        with dispatch.use(prefer=dispatch.policy_from_flag("cuda-strict")), \
                contextlib.redirect_stdout(buf):
            launch_serve.main(argv)
        served = buf.getvalue().strip().splitlines()
        print("  python -m repro_torch.launch.serve " + " ".join(argv) + ": " + served[-1])
        want = int(argv[argv.index("--requests") + 1])
        res["serve_launcher"] = {"argv": argv, "last_line": served[-1],
                                 "requests": want, "lines": len(served)}
        if served[-1] != f"[serve] completed {want}/{want} requests" or len(served) != want + 1:
            raise AssertionError(f"launch.serve answered: {served}")

        counts = {name: getattr(mod, "launches") for mod in kernels
                  for name in [mod.__name__.rsplit(".", 1)[1]] if name in DIST_KERNELS}
        res["launches"] = counts
        print(f"  the phase's kernel launches: {json.dumps(counts)}")
        if check_launches and not all(counts.get(k, 0) > 0 for k in DIST_KERNELS):
            raise AssertionError(f"a kernel of the phase never launched: {counts}")

        # training: two steps under the rules against the one-device step
        B, S = train_batch
        rules = ShardingRules.for_arch(cfg, mesh)
        opt = pick_opt(cfg)
        mb = auto_microbatches(B, S, rules, cfg=cfg)
        data = SyntheticTokens(DataConfig(vocab_size=cfg.vocab_size, seq_len=S,
                                          global_batch=B, seed=seed))
        batches = [to_device(data.batch_at(s), mesh.device) for s in range(DIST_TRAIN_STEPS)]
        train = trainable(params)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        step_one = make_train_step(model, opt, microbatches=mb)
        step_sh, t_sh, _, _ = make_train_step(model, opt, rules, global_batch=B,
                                              microbatches=mb)
        start, _ = init_train_state(model, opt, rules, seed=seed)
        if not all(torch.equal(a, b) for a, b in zip(tree_leaves(start), tree_leaves(train))):
            raise AssertionError("init_train_state under the rules drew other weights")
        del start
        ends, losses = {}, {}
        for name, fn in (("one_device", step_one), ("sharded", step_sh)):
            p, o = train, opt_init(opt, train, **({"shardings": t_sh} if name == "sharded"
                                                  else {}))
            losses[name] = []
            for batch in batches:
                p, o, m = fn(p, o, batch)
                losses[name].append(float(m["loss"]))
            ends[name] = p
            del o
            gc.collect()
            torch.cuda.empty_cache()
        gaps = {}
        for key, a, b in zip(tree_paths(ends["sharded"]), tree_leaves(ends["sharded"]),
                             tree_leaves(ends["one_device"])):
            if not torch.equal(a, b):
                gaps[key] = float((a.float() - b.float()).abs().max())
        res["train_steps"] = {"batch": [B, S], "steps": DIST_TRAIN_STEPS, "microbatches": mb,
                              "optimizer": opt.kind, "loss": losses,
                              "leaves": len(tree_leaves(ends["sharded"])),
                              "leaves_differing": gaps}
        print("  two train steps under the rules against the one-device step: "
              + json.dumps(res["train_steps"]))
        del ends, train
        gc.collect()
        torch.cuda.empty_cache()

        # compressed psum over the one-rank group, through the backend
        x = torch.randn(4096 + 17, generator=gen, device=mesh.device) * 3
        mean, residual = compressed_psum(x, None)
        q, scale, shape = quantize_int8(x)
        q_cpu, scale_cpu, _ = quantize_int8(x.cpu())
        sent = dequantize_int8(q, scale, shape)
        res["compressed_psum"] = {
            "n": x.numel(), "quantize_bitwise_cpu": bool(torch.equal(q.cpu(), q_cpu)
                                                        and torch.equal(scale.cpu(), scale_cpu)),
            "mean_is_payload": bool(torch.equal(mean, sent)),
            "residual_exact": bool(torch.equal(residual, x - sent)),
            "max_abs_err": float((mean - x).abs().max()),
            "bound": float(x.abs().max()) / 64}
        print("  compressed_psum: " + json.dumps(res["compressed_psum"]))
        cp = res["compressed_psum"]
        if not (cp["quantize_bitwise_cpu"] and cp["mean_is_payload"] and cp["residual_exact"]
                and cp["max_abs_err"] < cp["bound"]):
            raise AssertionError(f"compressed_psum: {cp}")
    finally:
        dist.destroy_process_group()
    res["seconds"] = time.perf_counter() - t0
    print(f"  dist phase on {card} ({smi}): {res['seconds']:.1f} s")
    return res


def schedule_counts(res: dict) -> dict:
    """The numbers of a run that follow from its schedule alone (the
    prompts' lengths and tokens, not the model's values): model calls,
    concurrency, preemption and tier counters, fault, integrity and prefix
    counters and the ledger's splits less their timings.  A run of the
    engine on the CPU with a tiny model on prompts of the same lengths (and
    the same shared prefixes) gives the same."""
    out = {k: res[k] for k in ("requests", "prefill_calls", "chunk_calls", "fixup_calls",
                               "decode_calls", "sample_calls", "peak_concurrency",
                               "sustained_concurrency", "recovery", "splits")}
    out["tier"] = {k: res["tier"][k] for k in (
        "preemptions", "resumes", "recompute_tokens", "pages_reclaimed", "spills", "refills",
        "demotions", "replay_fallback_tokens", "free_pages", "total_pages")}
    out["verify"] = {k: res["verify"][k] for k in ("launches", "pages")}
    return out


def schedule_twin(torch, phases, seed: int) -> dict:
    """Each of ``phases`` (name -> a phase function) run again on the CPU
    with a tiny llama (2 layers, d_model 64, vocab 128) on prompts of the
    same lengths: its runs' :func:`schedule_counts` by arm.  The twin's
    streams are its own (a tiny model's) and are not gated; every count
    gate of the phases holds on it too."""
    from repro_torch import kernels as kernel_pkg
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.models import build_model, init_params

    model = build_model(reduced(ARCHS["llama3.2-1b"], layers=2, d_model=64, vocab=128),
                        device="cpu")
    params = init_params(model.param_specs(), seed, device="cpu")
    kernels = tuple(kernel_pkg.modules())
    return {name: fn(torch, model, params, kernels, seed, twin=True)["counts"]
            for name, fn in phases.items()}


def check_counts(card: dict, twin: dict) -> None:
    """Raise unless every arm's schedule counts on the card equal the CPU
    run's."""
    differ = {arm: {k: (card[arm].get(k), twin.get(arm, {}).get(k))
                    for k in card[arm] if card[arm].get(k) != twin.get(arm, {}).get(k)}
              for arm in card if card[arm] != twin.get(arm)}
    if differ or set(card) != set(twin):
        raise AssertionError(f"counts differ from the CPU run's at the same lengths: {differ}")


def _gate_streams(name: str, got: list, want: list, lengths) -> None:
    differ = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
    if differ or len(got) != len(want):
        raise AssertionError(f"{name}: streams differ from the clean run's in requests {differ} "
                             f"(prompt lengths {[lengths[i] for i in differ]})")


def faults_phase(torch, model, params, kernels, seed: int, *, prompts=None,
                 new_tokens: int = 32, max_len: int = 1024, twin: bool = False) -> dict:
    """The 16 serve prompts (32 new tokens), paged, 8 slots, the engine
    routed through a queue of an HSA scheduler on a ``VirtualClock`` (Table
    X's cost model), under cuda-strict, greedy and at T = 0.7 (K = 4), in
    the arms of FAULT_ARMS: fault-free; a forced exec fault on the first
    fused decode and on the first prefill with an engine ``RetryPolicy()``
    (every live request parked and re-prefilled, or requeued); the decode
    fault absorbed by the scheduler's retry (no parks); a permanent decode
    fault with ``max_request_recoveries=0`` (the live requests fail, in
    ``failed_requests`` and ``ServeTruncated.failed``; the rest complete);
    Table X's seeded plan at 0.05; and chunked (128-row chunks, 16 slots)
    fault-free and with a forced fault on the first chunk.  Every stream
    equals the fault-free run's, 16 of 16 (the permanent arm's survivors);
    the split shows the faults, recoveries and recompute.  ``twin``: the
    CPU run of :func:`schedule_twin` (quiet, no launch or stream gates)."""
    from repro_torch.core import hsa
    from repro_torch.core.ledger import OverheadLedger
    from repro_torch.core.policy import RetryPolicy
    from repro_torch.core.reconfig import RegionManager
    from repro_torch.core.roles import RoleLibrary
    from repro_torch.serve.engine import ServeTruncated

    if prompts is None:
        prompts = serve_prompts(torch, model.cfg.vocab_size, seed)[1]
    lengths = [len(p) for p in prompts]
    runs, streams, counts, t0 = {}, {}, {}, time.perf_counter()
    for sampling, skw in GATE_SAMPLINGS:
        for name, force, permanent, eng_retry, sched_retry, chunked in FAULT_ARMS:
            plan = None
            if force is not None:
                plan = hsa.FaultPlan()
                plan.force("exec", force, permanent=permanent)
            elif name == "table10":
                plan = hsa.FaultPlan(**TABLE10_PLAN)
            led, clock = OverheadLedger(), hsa.VirtualClock()
            sched = hsa.Scheduler(
                RegionManager(4, ledger=led), RoleLibrary(ledger=led), ledger=led, clock=clock,
                cost_model=lambda kind, what, measured: (FAULT_RECONFIG_S if kind == "reconfig"
                                                         else FAULT_EXEC_S),
                retry=None if sched_retry is None else RetryPolicy(**sched_retry), faults=plan,
                expected_exec_s=FAULT_EXEC_S)
            q = sched.add_queue(hsa.Queue(None, 512, name="serve"))
            kw = ({"batch_slots": 16, "prefill_chunk": 128, "pool_pages": 8 * max_len // 16 + 1}
                  if chunked else {"batch_slots": 8})
            held = []
            arm = f"{sampling}_{name}"
            runs[arm], streams[arm] = serve_run(
                torch, model, params, kernels, prompts, new_tokens=new_tokens, max_len=max_len,
                paged=True, page_size=16, hsa_queue=q, hsa_scheduler=sched, clock=clock,
                retry=None if eng_retry is None else RetryPolicy(**eng_retry),
                allow_failed=name == "permanent", check_launches=not twin,
                after_step=lambda eng: held.append(eng) if not held else None, **kw, **skw)
            res, rec = runs[arm], runs[arm]["recovery"]
            res["faults_injected"] = len(plan.trace) if plan is not None else 0
            counts[arm] = schedule_counts(res)
            counts[arm]["trace"] = ([(f.kind, f.what, f.permanent, f.forced) for f in plan.trace]
                                    if plan is not None else [])
            if not twin:
                print("  " + json.dumps({"arch": model.cfg.name, "arm": arm, **res}))
            avail = res["splits"]["availability_split"]
            clean = streams[f"{sampling}_clean"]
            if name == "permanent":
                failed = rec["failed"]
                try:
                    held[0].run_to_completion(max_steps=1)
                    raise AssertionError("the permanent arm's run_to_completion did not raise")
                except ServeTruncated as e:
                    truncated = sorted(r.uid for r in e.failed)
                if not failed or truncated != failed or len(failed) == len(prompts):
                    raise AssertionError(f"permanent arm: failed {failed}, ServeTruncated.failed "
                                         f"{truncated}")
                survivors = [i for i in range(len(prompts)) if i + 1 not in failed]
                if not twin:
                    _gate_streams(arm, streams[arm], [clean[i] for i in survivors],
                                  [lengths[i] for i in survivors])
                res["survivors"] = len(survivors)
                continue
            if not twin:
                _gate_streams(arm, streams[arm], clean, lengths)
            if rec["failed"]:
                raise AssertionError(f"{arm}: requests failed: {rec['failed']}")
            if name == "decode_fault" and not (
                    avail["faults"] >= 1 and avail["recoveries"] >= 1
                    and avail["recovery_recompute_tokens"] > 0):
                raise AssertionError(f"{arm}: the split shows no fault recovered: {avail}")
            if name == "table10" and not avail["faults"] >= 1:
                raise AssertionError(f"{arm}: the seeded plan injected no fault: {avail}")
            if name == "prefill_fault" and rec["fault_recoveries"][0] != 1:
                raise AssertionError(f"{arm}: the first request was not requeued once: "
                                     f"{rec['fault_recoveries']}")
            if name == "chunk_fault" and not any(rec["fault_recoveries"]):
                raise AssertionError(f"{arm}: no chunked prefill was aborted to the queue")
            if name == "sched_retry" and not (res["tier"]["preemptions"] == 0
                                              and avail["faults"] == 1 and avail["retries"] == 1):
                raise AssertionError(f"{arm}: the scheduler did not absorb the fault: {avail}")
    wall = time.perf_counter() - t0
    if not twin:
        for arm, res in runs.items():
            a = res["splits"]["availability_split"]
            print(f"  {arm}: faults {a['faults']:.0f} (wedges {a['wedges']:.0f}), retries "
                  f"{a['retries']:.0f}, recoveries {a['recoveries']:.0f}, recompute tokens "
                  f"{a['recovery_recompute_tokens']:.0f}, failed {res['recovery']['failed']}, "
                  f"preemptions {res['tier']['preemptions']}; TTFT mean {res['ttft_mean_s']} s")
        print(f"  every stream equals the fault-free run's, 16 of 16 (the permanent arm: its "
              f"survivors); the faults phase took {wall:.1f} s")
    return {"prompt_lengths": lengths, "runs": runs, "counts": counts, "wall_s": wall}


def integrity_phase(torch, model, params, kernels, seed: int, *, prompts=None,
                    new_tokens: int = OVERCOMMIT_NEW_TOKENS,
                    pool_pages: int = INTEGRITY_POOL_PAGES,
                    snapshot_tokens: int = OVERCOMMIT_SNAPSHOT_TOKENS, max_len: int = 1024,
                    twin: bool = False) -> dict:
    """The 16 serve prompts at the overcommit phase's settings (128 new
    tokens, 8 slots over INTEGRITY_POOL_PAGES pages, ``growth_reserve``
    0.5, snapshots from OVERCOMMIT_SNAPSHOT_TOKENS rows: parks, spills and
    refills), under cuda-strict, greedy and at T = 0.7 (both at K = 4,
    INTEGRITY_SAMPLINGS): clean (no
    integrity layer), then INTEGRITY_PLAN's seeded corruption with
    ``IntegrityPolicy(scrub_pages_per_step=4)`` (every corruption detected
    by a read, the scrubber or a transfer's check, none escaping, pages
    quarantined, every stream the clean run's), and greedy with every check
    off (the same corruption must escape).  The hashed bytes and seconds a
    decode launch against the clean run's step.  ``twin`` as in
    :func:`faults_phase`."""
    from repro_torch.core import hsa
    from repro_torch.core.ledger import OverheadLedger
    from repro_torch.core.policy import (
        AdmissionPolicy,
        IntegrityPolicy,
        PreemptionPolicy,
        RetryPolicy,
    )

    if prompts is None:
        prompts = serve_prompts(torch, model.cfg.vocab_size, seed)[1]
    lengths = [len(p) for p in prompts]
    off = IntegrityPolicy(scrub_pages_per_step=0, verify_reads=False, verify_transfers=False,
                          verify_regions=False)
    arms = [(sampling, skw, name, integrity)
            for sampling, skw in INTEGRITY_SAMPLINGS
            for name, integrity in (("clean", None),
                                    ("verified",
                                     IntegrityPolicy(scrub_pages_per_step=INTEGRITY_SCRUB)))]
    arms.append((*INTEGRITY_SAMPLINGS[0], "verify_off", off))
    runs, streams, counts, t0 = {}, {}, {}, time.perf_counter()
    for sampling, skw, name, integrity in arms:
        arm = f"{sampling}_{name}"
        plan = None
        if integrity is not None:
            plan = hsa.FaultPlan(**INTEGRITY_PLAN)
            for kind, n in INTEGRITY_FORCED:
                plan.force(kind, count=n)
        runs[arm], streams[arm] = serve_run(
            torch, model, params, kernels, prompts, new_tokens=new_tokens, max_len=max_len,
            batch_slots=8, paged=True, page_size=16, pool_pages=pool_pages,
            admission=AdmissionPolicy(growth_reserve=0.5),
            preemption=PreemptionPolicy(snapshot_threshold_tokens=snapshot_tokens),
            ledger=OverheadLedger(), retry=RetryPolicy(max_request_recoveries=64),
            faults=plan, integrity=integrity, check_launches=not twin, **skw)
        res = runs[arm]
        counts[arm] = schedule_counts(res)
        counts[arm]["trace"] = ([(f.kind, f.what, f.forced) for f in plan.trace]
                                if plan is not None else [])
        if not twin:
            print("  " + json.dumps({"arch": model.cfg.name, "arm": arm, **res}))
        if res["tier"]["free_pages"] != res["tier"]["total_pages"] or res["tier"]["arena_entries"]:
            raise AssertionError(f"{arm} ended holding pages or snapshots: {res['tier']}")
        if name == "clean":
            continue
        sp = res["splits"]["integrity_split"]
        rec = res["recovery"]
        if name == "verify_off":
            if not (sp["escaped"] > 0 and sp["detected"] == 0):
                raise AssertionError(f"{arm}: the corruption did not escape: {sp}")
            continue
        if not twin:
            _gate_streams(arm, streams[arm], streams[f"{sampling}_clean"], lengths)
        kinds = [k for k in ("corrupt_pages", "corrupt_blocks", "corrupt_transfers") if sp[k]]
        if not (sp["escaped"] == 0 and sp["detected"] == sp["corruptions"] > 0
                and rec["quarantined"] > 0 and len(kinds) == 3):
            raise AssertionError(f"{arm}: corruptions {sp}, engine {rec}")
    wall = time.perf_counter() - t0
    per_launch = {}
    for sampling, _ in INTEGRITY_SAMPLINGS:
        v, clean = runs[f"{sampling}_verified"]["verify"], runs[f"{sampling}_clean"]
        per_launch[sampling] = {
            "hashed_bytes": v["bytes"] / max(1, v["launches"]),
            "hashed_pages": v["pages"] / max(1, v["launches"]),
            "verify_s": v["s"] / max(1, v["launches"]),
            "verified_step_s": runs[f"{sampling}_verified"]["decode_step_s"],
            "clean_step_s": clean["decode_step_s"]}
    if not twin:
        for arm, res in runs.items():
            sp = res["splits"]["integrity_split"]
            print(f"  {arm}: corruptions {sp['corruptions']:.0f} (pages {sp['corrupt_pages']:.0f}"
                  f", blocks {sp['corrupt_blocks']:.0f}, transfers "
                  f"{sp['corrupt_transfers']:.0f}), detected {sp['detected']:.0f} (read "
                  f"{sp['detected_read']:.0f}, scrub {sp['detected_scrub']:.0f}, transfer "
                  f"{sp['detected_transfer']:.0f}), escaped {sp['escaped']:.0f}, quarantined "
                  f"{res['recovery']['quarantined']}, preemptions {res['tier']['preemptions']}, "
                  f"spills {res['tier']['spills']}, refills {res['tier']['refills']}")
        for sampling, d in per_launch.items():
            print(f"  {sampling}: the read check hashed {d['hashed_pages']:.1f} pages, "
                  f"{d['hashed_bytes']:.0f} bytes a decode launch (K = 4) in {d['verify_s']} s "
                  f"(one gather and copy off the card, hashed on the host); a decode launch "
                  f"took {d['verified_step_s']} s with it, {d['clean_step_s']} s in the clean "
                  f"run")
        print(f"  verified streams equal the clean run's, 16 of 16; nothing escaped; with the "
              f"checks off the corruption escaped; the integrity phase took {wall:.1f} s")
    return {"prompt_lengths": lengths, "runs": runs, "counts": counts, "per_launch": per_launch,
            "wall_s": wall}


def prefix_prompts(torch, vocab: int, seed: int) -> list[list[int]]:
    """The prefix phase's 16 prompts: two personas' PREFIX_ROWS-token system
    prompts in turn, each with a user's suffix of PREFIX_SUFFIXES tokens,
    drawn from ``seed`` in the model's vocabulary."""
    rng = torch.Generator().manual_seed(seed + 5)
    personas = [torch.randint(0, vocab, (PREFIX_ROWS,), generator=rng).tolist() for _ in range(2)]
    return [personas[i % 2] + torch.randint(0, vocab, (n,), generator=rng).tolist()
            for i, n in enumerate(PREFIX_SUFFIXES)]


def prefix_phase(torch, model, params, kernels, seed: int, *, prompts=None,
                 prefix_rows: int = PREFIX_ROWS, new_tokens: int = 32, max_len: int = 1024,
                 twin: bool = False) -> dict:
    """Table XIII's persona mix at full width: 16 requests over two personas'
    512-token system prompts (32 pages of 16), 32 new tokens, paged, 16
    slots, under cuda-strict, greedy and at T = 0.7 (K = 4): sharing off and
    on, whole-prompt prefill (the default pool) and chunked (128-row chunks,
    the dense 8-slot run's KV memory).  Every stream equals the unshared
    whole run's, 16 of 16: a shared request prefills its suffix alone, one
    chunk from row 512, reading the shared rows in place.  Then sharing on,
    whole, checked after every step: every page in the prefix index keeps
    its digest while indexed (no suffix prefill writes a shared page); and
    with ``IntegrityPolicy()`` and a byte flipped in the pool on a page
    several requests share: every reader parks and prefills again, the
    streams unchanged.  TTFT and concurrency, sharing on and off.  ``twin``
    as in :func:`faults_phase`."""
    from repro_torch.core.ledger import OverheadLedger
    from repro_torch.core.policy import IntegrityPolicy
    from repro_torch.serve.paged import page_digests

    if prompts is None:
        prompts = prefix_prompts(torch, model.cfg.vocab_size, seed)
    lengths = [len(p) for p in prompts]
    # the two personas' first users arrive first; the other 14 once those
    # have prefilled (8 chunks of 128 rows), while they still decode
    arrivals = [0, 0] + [PREFIX_WAVE_STEP] * (len(prompts) - 2)
    chunked = {"prefill_chunk": 128, "pool_pages": 8 * max_len // 16 + 1}
    seen: dict = {}
    checked = [0]

    def shared_unchanged(eng):
        entries = sorted(eng._prefix_index._by_page.items())
        for key in [k for k in seen if k not in entries]:
            del seen[key]
        for entry, digest in zip(entries, page_digests(eng._cache, [p for p, _ in entries])):
            if seen.setdefault(entry, digest) != digest:
                raise AssertionError(f"indexed page {entry[0]} changed while shared")
        checked[0] += len(entries)

    flipped: dict = {}

    def flip_shared(eng):
        if flipped:
            return
        shared = [p for p in eng._prefix_index.pages() if eng.allocator.refcount(p) >= 3]
        if shared:
            from repro_torch.serve.paged import flip_page
            page = min(shared)
            flipped.update(page=page, readers=sorted(eng.allocator.owners_of(page)))
            flip_page(eng._cache, page)

    runs, streams, counts, t0 = {}, {}, {}, time.perf_counter()
    for sampling, skw in GATE_SAMPLINGS:
        arms = (("off", {}, None), ("on", {"prefix": True}, None),
                ("off_chunked", chunked, None), ("on_chunked", {**chunked, "prefix": True}, None),
                ("on_checked", {"prefix": True}, shared_unchanged),
                ("on_flip", {"prefix": True, "integrity": IntegrityPolicy()}, flip_shared))
        for name, kw, hook in arms:
            arm = f"{sampling}_{name}"
            seen.clear()
            flipped.clear()
            runs[arm], streams[arm] = serve_run(
                torch, model, params, kernels, prompts, new_tokens=new_tokens, max_len=max_len,
                batch_slots=16, paged=True, page_size=16, ledger=OverheadLedger(),
                after_step=hook, shared_rows=prefix_rows if kw.get("prefix") else None,
                check_launches=not twin, arrivals=arrivals, **kw, **skw)
            res = runs[arm]
            counts[arm] = schedule_counts(res)
            if not twin:
                print("  " + json.dumps({"arch": model.cfg.name, "arm": arm, **res}))
            if not twin:
                _gate_streams(arm, streams[arm], streams[f"{sampling}_off"], lengths)
            rec = res["recovery"]
            if name.startswith("on") and not rec["prefix_hits"]:
                raise AssertionError(f"{arm}: no request attached to a shared prefix: {rec}")
            if name == "on_flip":
                readers = flipped.get("readers", [])
                counts[arm]["flipped"] = dict(flipped)
                recoveries = dict(zip(sorted(range(1, len(prompts) + 1)),
                                      rec["fault_recoveries"]))
                if len(readers) < 3 or any(recoveries[u] < 1 for u in readers) \
                        or rec["corruptions_detected"] < 1 or rec["quarantined"] != 1 \
                        or rec["cow_copies"] != len(readers) - 1:
                    raise AssertionError(f"{arm}: the flipped shared page {flipped} did not "
                                         f"park and re-prefill every reader: {rec}")
            elif rec["corruptions_detected"]:
                raise AssertionError(f"{arm}: a digest check failed with no corruption: {rec}")
    if not checked[0]:
        raise AssertionError("the shared pages' digests were never checked")
    wall = time.perf_counter() - t0
    if not twin:
        for arm, res in runs.items():
            sp = res["splits"]["prefix_split"]
            print(f"  {arm}: TTFT mean {res['ttft_mean_s']} s, p99 {res['ttft_p99_s']} s; "
                  f"sustained concurrency {res['sustained_concurrency']}, peak "
                  f"{res['peak_concurrency']}; prefix hits {sp['prefix_hits']:.0f} of "
                  f"{sp['prefix_lookups']:.0f} lookups, pages saved {sp['pages_saved']:.0f}, "
                  f"peak shared pages {sp['peak_shared_pages']:.0f}, CoW copies "
                  f"{sp['cow_copies']:.0f}; prefill calls {res['prefill_calls']}, chunk calls "
                  f"{res['chunk_calls']}")
        print(f"  streams equal across sharing on and off, whole and chunked, 16 of 16; shared "
              f"pages unchanged by suffix prefills ({checked[0]} page checks); the flipped "
              f"shared page parked every reader; the prefix phase took {wall:.1f} s")
    return {"prompt_lengths": lengths, "runs": runs, "counts": counts, "wall_s": wall}


#: the phases the CPU run of ``--twin`` replays
TWIN_PHASES = {"faults": faults_phase, "integrity": integrity_phase, "prefix": prefix_phase}


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


#: marker kernels that open a trace, and the pause after them: a trace's
#: first records have gone missing (in traces of the Mamba-2 graph replays,
#: after many earlier traces and graphs in the process: 8 markers and all
#: of the first step once), and these absorb what a trace drops first
TRACE_OPENING_MARKERS = 256
TRACE_OPENING_PAUSE_S = 0.25


def busy_phase(torch, model, params, seed: int, graphed: bool = True,
               temperature: float = 0.0, policy: str = "cuda-strict") -> dict:
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
    every kernel the decode path runs (an MLA model's, under ``policy``
    cuda, no decode attention kernel).  A trace without device events reads
    as not measured (None)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import dispatch
    from repro_torch.kernels import launch_counters
    from repro_torch.serve.engine import ServeEngine

    path = {"matmul", "rmsnorm"} | ({"sample"} if temperature > 0 else set()) | (
        set() if model.cfg.family == "ssm" or model.cfg.mla is not None
        else {"decode_attention"})
    rng = torch.Generator().manual_seed(seed + 3)
    with dispatch.use(prefer=dispatch.policy_from_flag(policy)):
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
        torch.cuda.reset_peak_memory_stats()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(TRACE_OPENING_MARKERS):
                torch.cuda._sleep(0)
            torch.cuda.synchronize()
            time.sleep(TRACE_OPENING_PAUSE_S)
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
           "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
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


def served_logits(torch, model, params, kernels, seed: int, steps: int = 16) -> list:
    """The decode logits ``[8, V]`` the sampler is given over the first
    ``steps`` decode steps of an untimed eager serve run of the first 8
    serve prompts (8 slots, T = 0.7, seed 3), through the engine's
    ``decode_logits_tap``."""
    _, prompts = serve_prompts(torch, model.cfg.vocab_size, seed)
    kept: list = []

    def tap(logits):
        if logits.shape[0] == 8 and len(kept) < steps:
            kept.append(logits.detach().float().clone())

    serve_run(torch, model, params, kernels, prompts[:8], graphed=False, temperature=0.7,
              seed=3, batch_slots=8, new_tokens=2 * steps,
              after_step=lambda eng: setattr(eng, "decode_logits_tap", tap))
    return kept


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
            torch.cuda.reset_peak_memory_stats()
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
           "device_union_us": union_us(device_kernels(prof)) if events else None,
           "bf16_matmul_device_us": mm_us if events else None,
           "ssd_device_us": ssd_us if events else None,
           "ssd_share": ssd_us / busy_us if events else None,
           "device_busy_share": busy_us / wall_us if events else None,
           "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
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
    """:func:`sass_counts` of the bf16 edge kernels: for M <= 16 mma.sync on
    tiles its own threads realign, no wgmma, TMA copies in the instances
    with TMA = 1; for larger M (the tile kernel) wgmma and TMA copies."""
    counts = sass_counts(native, "matmul", r"mm_edge_stream_kernel", need=("HMMA",))
    if not all(c["UTMALDG"] for fn, c in counts.items() if fn.endswith(",1>")):
        raise AssertionError(f"the edge kernel's TMA instances without TMA loads: {counts}")
    return {**counts, **sass_counts(native, "matmul", r"mm_edge_tile_kernel")}


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
    ap.add_argument("--twin", action="store_true",
                    help="print the fault, integrity and prefix phases' schedule counts from "
                         "a run on the CPU with a tiny model (what the card's must equal)")
    ap.add_argument("--dryrun", action="store_true",
                    help="print the dry-run records of the steps the dryrun phase holds "
                         "against the card, counted on meta tensors on the CPU")
    args = ap.parse_args()

    import torch

    if args.twin:
        torch.set_num_threads(2)
        print(json.dumps(schedule_twin(torch, TWIN_PHASES, args.seed)))
        return 0
    if args.dryrun:
        torch.set_num_threads(2)
        print(json.dumps(dryrun_records()))
        return 0
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs one NVIDIA GPU", file=sys.stderr)
        return 2
    from repro_torch import kernels as kernel_pkg
    from repro_torch.kernels import conv2d as conv_k

    # the kernels of the serve paths: every counted module but conv2d, which
    # only the tenants phase runs (and counts on its own)
    kernels = tuple(mod for mod in kernel_pkg.modules() if mod is not conv_k)
    t_start = time.perf_counter()
    phase_s: dict[str, float] = {}
    t_lap = [t_start]

    def lap() -> float:
        """Seconds since the last lap (a phase's)."""
        now = time.perf_counter()
        s, t_lap[0] = now - t_lap[0], now
        return s

    # the schedule counts the fault, integrity and prefix phases must give,
    # from a run of theirs on the CPU, while the card works
    twin = subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--twin",
                             "--seed", str(args.seed)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    # the dry run's counts of the steps the dryrun phase times, on meta
    # tensors on the CPU, while the card works
    dry = subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--dryrun"],
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                           env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    try:
        return run_phases(args, torch, (twin, dry), kernels, t_start, phase_s, lap)
    finally:
        for proc in (twin, dry):
            if proc.poll() is None:
                proc.kill()
                proc.communicate()


def run_phases(args, torch, helpers, kernels, t_start, phase_s, lap) -> int:
    """Every phase after the check for a card (see the module docstring);
    ``helpers``: the CPU twin's process and the dry run's."""
    twin, dry = helpers
    from repro_torch.bench import table12_integrity, table13_prefix
    from repro_torch.configs import get_arch
    from repro_torch.kernels import conv2d as conv_k
    from repro_torch.kernels import decode_attention as dec_k
    from repro_torch.kernels import flash_attention as fa_k
    from repro_torch.kernels import matmul as mm_k
    from repro_torch.kernels import native
    from repro_torch.kernels import sample as sample_k
    from repro_torch.models import build_model, init_params

    smi = nvidia_smi()
    card = torch.cuda.get_device_name(0)
    print(f"[1/20] device: {smi} | torch.cuda.get_device_name(0) = {card} | "
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
            "decode_attention": decode_sass(native), "ssd": ssd_sass(native),
            "sample": sample_sass(native)}
    for lib, fns in sass.items():
        for fn, counts in fns.items():
            print(f"  {lib} SASS {fn}: " + ", ".join(f"{n} {op}" for op, n in counts.items()))
    phase_s["device"] = lap()

    print(f"[2/20] kernels against their plain versions, on {card} ({smi})")
    rows, errs = kernel_phase(torch, args.seed)
    print(f"  every matmul, decode attention and ssd instance built was held against the "
          f"plain version: {sorted(check_instances(rows, sass))}")
    decode_splits = check_splits(
        rows, served_decode_splits(dec_k, [*serve_prompts(torch, 128, args.seed)[0],
                                           *PREFIX_LENGTHS]))
    print(f"  every split count the decode rule picks at the served shapes ran: {decode_splits}")
    phase_s["kernels"] = lap()

    print("[3/20] model: llama3.2-1b prefill, fixup and decode, cuda-strict vs the torch "
          "source; chunked vs whole-prompt prefill")
    model = build_model(get_arch("llama3.2-1b"))
    params = init_params(model.param_specs(), args.seed)
    # the live bytes of each step the dryrun phase holds its count against
    live = {"llama_decode": weight_bytes(params), "llama_prefill": weight_bytes(params)}
    model_res = model_phase(torch, model, params, args.seed)
    phase_s["model"] = lap()

    print("[4/20] serve: 16 greedy requests, max_len 1024, cuda-strict: dense 8 slots; "
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
    served_row = sample_served(torch, served_logits(torch, model, params, kernels, args.seed),
                               0.7)
    rows.append(served_row)
    phase_s["serve"] = lap()

    print("[5/20] tenants: hsa_init(num_regions=2) on the card, the async scheduler's worker "
          "thread; tf-serving: the 16 requests through a dense 8-slot engine; opencl: the "
          "paper's four roles through two regions")
    tenants_res = tenants_phase(torch, model, params, kernels, args.seed,
                                serve_res.pop("dense_streams"))
    print_runs({"tenants_routed": tenants_res["run"]}, card, smi)
    phase_s["tenants"] = lap()

    print(f"[6/20] faults: llama3.2-1b, the 16 requests paged 8 slots through an HSA queue on "
          f"a virtual-clock scheduler, cuda-strict, greedy and T = 0.7 (K = 4): forced exec "
          f"faults on decode, prefill and a chunk, the scheduler's retry, a permanent fault, "
          f"Table X's plan at 0.05, on {card} ({smi})")
    faults_res = faults_phase(torch, model, params, kernels, args.seed)
    phase_s["faults"] = lap()
    print(f"[7/20] integrity: llama3.2-1b, the 16 requests at {OVERCOMMIT_NEW_TOKENS} new tokens, "
          f"8 slots over {INTEGRITY_POOL_PAGES} pages, growth_reserve 0.5, snapshots from "
          f"{OVERCOMMIT_SNAPSHOT_TOKENS} rows; seeded corruption, verification on (scrub "
          f"{INTEGRITY_SCRUB} a step) and off, on {card} ({smi})")
    integrity_res = integrity_phase(torch, model, params, kernels, args.seed)
    phase_s["integrity"] = lap()
    print(f"[8/20] prefix: llama3.2-1b, 16 users of two personas' {PREFIX_ROWS}-token system "
          f"prompts, 16 slots, sharing on and off, whole and chunked; shared pages' digests; a "
          f"flipped shared page, on {card} ({smi})")
    prefix_res = prefix_phase(torch, model, params, kernels, args.seed)
    phase_s["prefix"] = lap()
    out, err = twin.communicate(timeout=900)
    if twin.returncode != 0:
        raise AssertionError(f"the CPU run of the fault, integrity and prefix phases failed: "
                             f"{err[-4000:]}")
    twin_counts = json.loads(out.strip().splitlines()[-1])
    for name, res in (("faults", faults_res), ("integrity", integrity_res),
                      ("prefix", prefix_res)):
        check_counts(json.loads(json.dumps(res["counts"])), twin_counts[name])
    print(f"  every arm's counts equal a CPU run's at the same lengths (a tiny llama): "
          f"{sum(len(c) for c in twin_counts.values())} arms; seconds: faults "
          f"{faults_res['wall_s']:.1f}, integrity {integrity_res['wall_s']:.1f}, prefix "
          f"{prefix_res['wall_s']:.1f}")
    for table, mod in (("table13", table13_prefix), ("table12", table12_integrity)):
        table_rows = mod.rows()
        mod.check(table_rows)
        for metric, (value, derived) in table_rows.items():
            print(f"  {table},{metric},{value},{derived}")
    print("  Table XIII's trace rows and Table XII's region row equal the JAX package's "
          "(BENCH_results.json)")
    del model, params
    torch.cuda.empty_cache()
    phase_s["twin_and_tables"] = lap()

    print(f"[9/20] full depth: {', '.join(FULL_DEPTH_ARCHS)} (heads of 128, untied unembeds), "
          f"weights from --seed: prefill, fixup, decode dense and paged, chunked staging and "
          f"paged, cuda-strict vs the torch source; then the 16 requests dense 8 slots, paged 8 "
          f"slots, paged chunked 16 slots, and T = 0.7 at K = 4 dense and chunked")
    full_res = {}
    for arch in FULL_DEPTH_ARCHS:
        model = build_model(get_arch(arch))
        params = init_params(model.param_specs(), args.seed)
        full_res[arch] = full_depth_phase(torch, model, params, kernels, args.seed, card, smi)
        if arch != FULL_DEPTH_ARCHS[-1]:
            del model, params
            gc.collect()
            torch.cuda.empty_cache()
    print(f"  where a {model.cfg.name} decode step's time goes (torch.profiler, CUDA activity):")
    full_res[model.cfg.name]["busy"] = busy_phase(torch, model, params, args.seed)
    live["yi9b_decode"] = weight_bytes(params)
    phase_s["full_depth"] = lap()

    print(f"[10/20] overcommit: {model.cfg.name} at {model.cfg.num_layers} layers, paged, 8 slots "
          f"over {OVERCOMMIT_POOL_PAGES} pages, the 16 requests at {OVERCOMMIT_NEW_TOKENS} new "
          f"tokens: full reserve, overcommitted, a tight host budget, churn at T = 0.7; Table "
          f"VIII's and XI's trace arms")
    overcommit_res = overcommit_phase(torch, model, params, kernels, args.seed, card, smi)
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    phase_s["overcommit"] = lap()

    print("[11/20] model: mamba2-780m prefill at the prompt's length and batched decode, "
          "cuda-strict vs the torch source")
    model = build_model(get_arch("mamba2-780m"))
    params = init_params(model.param_specs(), args.seed)
    ssm_model_res = ssm_model_phase(torch, model, params, args.seed)
    phase_s["ssm_model"] = lap()

    print("[12/20] serve: mamba2-780m, the same 16 prompt lengths, 8 slots, cuda-strict")
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
    phase_s["ssm_serve"] = lap()

    print(f"[13/20] traffic: llama3.2-1b, Table IX's three traces through the engine, cuda-strict, "
          f"on {card} ({smi}): virtual clock, chunked and whole (rows must equal the JAX "
          f"package's, streams equal); a tapered ChunkPolicy; the bursty trace on the wall "
          f"clock, in turns")
    model = build_model(get_arch("llama3.2-1b"))
    params = init_params(model.param_specs(), args.seed)
    traffic_res = traffic_phase(torch, model, params, kernels)
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    phase_s["traffic"] = lap()

    print(f"[14/20] moe: {', '.join(f'{a} at {n} layers ({p})' for a, n, p in MOE_ARCHS)}, full "
          f"width, weights from --seed, one after the other: the 8 prompts' prefills, fixups "
          f"and {MOE_DECODE_STEPS} batched decode steps against the torch source, every kernel "
          f"held against its plain version on the calls' data, a dispatch trace; then the 8 "
          f"prompts ({MOE_NEW_TOKENS} new tokens) dense 8 slots as a graph and as the loop, K = "
          f"4, paged (GQA), and T = 0.7 at K 1 and 4, streams equal 8 of 8, on {card} ({smi})")
    moe_res = {}
    for arch, layers, policy in MOE_ARCHS:
        full = get_arch(arch)
        model = build_model(dataclasses.replace(full, num_layers=layers))
        t = time.perf_counter()
        params = init_params(model.param_specs(), args.seed)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t
        moe_res[arch] = moe_phase(torch, model, params, policy, kernels, args.seed, card, smi,
                                  full_layers=full.num_layers)
        moe_res[arch]["summary"]["init_s"] = init_s
        del model, params
        gc.collect()
        torch.cuda.empty_cache()
    phase_s["moe"] = lap()

    print(f"[15/20] families: hymba-1.5b (32 layers, attention and Mamba-2 heads, a "
          f"{HYMBA_MAX_LEN}-row slot on a 1024-row ring) and whisper-large-v3 (32 + 32 layers), "
          f"full width and depth, weights from --seed, one after the other: model calls against "
          f"the torch source, every kernel held against its plain version on the calls' data; "
          f"hymba's 8 prompts of {HYMBA_LENGTHS[0]} to {HYMBA_LENGTHS[-1]} tokens as a graph and "
          f"as the loop, K = 4, T = 0.7 at K 1 and 4, streams equal 8 of 8; whisper's "
          f"{WHISPER_BATCH} x {WHISPER_PROMPT}-token prompts over 1500 frames, "
          f"{WHISPER_NEW_TOKENS} greedy tokens twice, on {card} ({smi})")
    families_res = families_phase(torch, kernels, args.seed, card, smi)
    phase_s["families"] = lap()

    print(f"[16/20] train: {TRAIN_ARCH} at full width and depth, the torch policy (no "
          f"hand-written kernel has a backward pass), AdamW from pick_opt, remat full, "
          f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens: the first step against f32, a warm-up step and "
          f"{TRAIN_STEPS} timed, greedy streams on the refreshed weights under cuda-strict, "
          f"resume at {RESUME_LAYERS} layers, on {card} ({smi})")
    train_res = train_phase(torch, args.seed, card, smi)
    phase_s["train"] = lap()

    print(f"[17/20] dist: {DIST_ARCH} at full width and depth on a one-rank 1x1 (data, model) "
          f"mesh over NCCL, weights from --seed: make_prefill_step and {DIST_DECODE_STEPS} "
          f"make_decode_step steps at {DIST_SLOTS} slots under cuda-strict against the model's "
          f"prefill and decode_step, bit for bit; {DIST_TRAIN_STEPS} make_train_step steps at "
          f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens against the one-device step; launch.serve "
          f"{' '.join(DIST_SERVE_ARGV)}; compressed_psum, on {card} ({smi})")
    dist_res = dist_phase(torch, kernels, args.seed, card, smi)
    phase_s["dist"] = lap()

    print(f"[18/20] internvl2: {INTERNVL_ARCH} at full width, its depth cut "
          f"{get_arch(INTERNVL_ARCH).num_layers} -> {INTERNVL_LAYERS} layers, weights from "
          f"--seed: {INTERNVL_PATCHES} patch rows drawn on the card and {INTERNVL_TEXT} text "
          f"tokens prefilled, {INTERNVL_VLM_STEPS} greedy decode steps, against the torch "
          f"source and every kernel against its plain version; then 8 text prompts of "
          f"{INTERNVL_LENGTHS[0]} to {INTERNVL_LENGTHS[-1]} tokens, {INTERNVL_NEW_TOKENS} new "
          f"each, 8 slots, as a graph and as the loop, on {card} ({smi})")
    full = get_arch(INTERNVL_ARCH)
    t = time.perf_counter()
    model = build_model(dataclasses.replace(full, num_layers=INTERNVL_LAYERS))
    params = init_params(model.param_specs(), args.seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    init_s = time.perf_counter() - t
    intern_shapes = ShapeLog()
    intern_res = internvl2_phase(torch, model, params, kernels, args.seed, card, smi,
                                 shape_log=intern_shapes, full_layers=full.num_layers)
    intern_res["summary"]["init_s"] = init_s
    intern_res["shape_keys"] = sorted(intern_shapes.keys, key=str)
    live["internvl2_decode"] = weight_bytes(params)
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    phase_s["internvl2"] = lap()

    print(f"[19/20] examples and the dry run, on {card} ({smi}): quickstart and serve_lm on the "
          f"card with their own checks; hw.py's constants against the card's properties; five "
          f"steps of the phases above counted on meta tensors at a 1x1 mesh (the dry run's "
          f"roofline on hw.py's H100 constants) against their measured device time and live "
          f"bytes")
    examples_res = examples_phase(torch)
    constants = check_chip_constants(torch)
    print(f"  hw.py's constants equal the card's properties: {json.dumps(constants)}")
    out, err = dry.communicate(timeout=900)
    if dry.returncode != 0:
        raise AssertionError(f"the dry run's counts failed: {err[-4000:]}")
    records = json.loads(out.strip().splitlines()[-1])
    trace = train_res["train"]["trace"]
    measured = {
        "llama_decode": busy_measured(busy_res, busy_res["decode_steps"]),
        "llama_prefill": busy_measured(prefill_res, 1, "wall_us"),
        "llama_train": {**busy_measured(trace, trace["calls"], "wall_us"),
                        "peak": train_res["train"]["peak_memory_bytes"]},
        "yi9b_decode": busy_measured(full_res["yi-9b"]["busy"], 4),
        "internvl2_decode": busy_measured(intern_res["busy"], 4)}
    live["llama_train"] = (train_res["train"]["param_bytes"]
                           + train_res["train"]["opt_state_bytes"])
    dryrun_res = dryrun_phase(torch, records, measured, live, card, smi)
    phase_s["examples_and_dryrun"] = lap()

    print("[20/20] the kernels' summary")
    served = {**serve_res["runs"], "tenants": tenants_res["run"], **ssm_res["runs"],
              **{f"t0.7_{n}": r for n, r in temp_res["runs"].items()},
              **{f"t0.7_{n}": r for n, r in ssm_temp_res["runs"].items()},
              **{f"{arch}_{n}": r for arch, res in full_res.items()
                 for n, r in res["runs"].items()},
              **{f"overcommit_{n}": r for n, r in overcommit_res["runs"].items()},
              **{f"{phase}_{n}": r for phase, res in (("faults", faults_res),
                                                      ("integrity", integrity_res),
                                                      ("prefix", prefix_res))
                 for n, r in res["runs"].items()},
              **{f"{arch}_{n}": r for arch, res in moe_res.items() for n, r in res["runs"].items()},
              **{f"hymba_{n}": r for n, r in families_res["hymba-1.5b"]["runs"].items()},
              **{f"internvl2_{n}": r for n, r in intern_res["runs"].items()}}
    runs = {**served, "traffic": {"launches": traffic_res["launches"]},
            **{f"{arch}_calls": {"launches": res["calls"]["launches"]}
               for arch, res in {**full_res, **moe_res}.items()},
            "hymba_calls": {"launches": families_res["hymba-1.5b"]["calls"]["launches"]},
            "internvl2_calls": {"launches": intern_res["calls"]["launches"]},
            "whisper_calls": {"launches": families_res["whisper-large-v3"]["calls"]["launches"]}}
    # MLA's runs: the <192,128> flash instance and the f32 matmul (decode's wo)
    mla_runs = {run for run in runs if run.startswith("deepseek")}
    sample_shapes = check_sample_shapes(rows, served.values(), sample_k)
    print(f"  every [B, V] the sampled runs gave the sampler, and every split count there, was "
          f"held against the plain version: {sample_shapes}")
    full_shapes = check_served_shapes(
        rows, [*(r for n, r in served.items() if n.startswith(FULL_DEPTH_ARCHS + ("overcommit",))),
               *(res["calls"] for res in full_res.values())])
    print(f"  every shape the full-depth and overcommit runs and model calls gave a kernel was "
          f"held against the plain version (shapes by kernel): {full_shapes}")
    recovery_shapes = check_served_shapes(
        rows, [r for n, r in served.items() if n.startswith(("faults", "integrity", "prefix"))])
    print(f"  every shape the fault, integrity and prefix runs gave a kernel (suffix prefills "
          f"after a 512-row prefix included) was held against the plain version (shapes by "
          f"kernel): {recovery_shapes}")
    family_shapes = check_family_shapes(rows, families_res["shape_keys"])
    intern_checked = {
        "engine_and_vlm": check_served_shapes(
            rows, [*(r for n, r in served.items() if n.startswith("internvl2")),
                   {"kernel_shapes": intern_res["calls"]["vlm_rows"]["kernel_shapes"]}]),
        "calls": check_family_shapes(rows, intern_res["shape_keys"])}
    print(f"  every shape the internvl2 phase's runs and vlm calls gave a kernel was held "
          f"against the plain version (shapes by kernel): {intern_checked}")
    print(f"  every shape the families phase's calls and runs gave a kernel (hymba's and "
          f"whisper's) was held against the plain version (shapes by kernel): {family_shapes}")
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
                "sample": "[8,128256]",
                "flash_attention_qk192": "q[1,128,1024,192] k[1,128,1024,192] v[1,128,1024,128] "
                                         "causal=True"}
    # the rows beside each headline: the bf16 matmul's prefill, flash
    # attention's other timed rows at D = 64 and its D = 128 and 96 rows, the
    # decode kernels at D = 128 and 96, the other unembeds and row counts,
    # the f32 kernel at 2048
    lengths = "[1, 1024, 5, 600, 37, 256, 900, 64]"
    off2, off4 = "w 2 bytes off 16-byte alignment", "w 4 bytes off 16-byte alignment"
    beside = {"matmul": ["[1024,2048]x[2048,8192] act=None out=bfloat16"]
                        + [f"[{M},{K}]x[{K},{N}] act=None out=bfloat16"
                           for K, N in FULL_DEPTH_KN for M in (8, 1024)]
                        + ["[8,4096]x[4096,64000] act=None out=float32"]
                        + [f"[8,{K}]x[{K},{N}] act=None out={'float32' if o == 'f32' else 'bfloat16'}"
                           for K, N, o in MOE_DECODE_KN]
                        + [f"[{M},{K}]x[{K},{N}] act=None out=bfloat16"
                           for K, N in ((1600, 1600), (1600, 320), (1600, 5504), (5504, 1600),
                                        (3200, 1600)) for M in (8, HYMBA_LENGTHS[-1])]
                        + [f"[{M},{K}]x[{K},{N}] act=None out=bfloat16"
                           for K, N in ((1280, 1280), (1280, 5120), (5120, 1280))
                           for M in (8, WHISPER_BATCH * 1500)],
              "flash_attention": [f"q[1,32,{S},{D}] kv[1,8,{T},{D}] causal={c}"
                                  for D in (64, 128)
                                  for S, T, c in ((512, 512, True), (512, 512, False),
                                                  (128, 1024, True), (1024, 1024, True))
                                  if (D, S, T, c) != (64, 512, 512, True)]
                                 + ["q[1,32,512,96] kv[1,8,512,96] causal=True"]
                                 + [f"q[1,32,{S},128] kv[1,4,{T},128] causal=True"
                                    for S, T in ((512, 512), (1024, 1024), (128, 1024))]
                                 + [f"q[1,25,{S},64] kv[1,5,{S},64] causal=True window=1024"
                                    for S in (1000, HYMBA_LENGTHS[-1])]
                                 + [f"q[8,20,{S},64] kv[8,20,{T},64] causal={c}" for S, T, c in
                                    ((1500, 1500, False), (4, 4, True), (4, 1500, False))]
                                 + ["q[1,8,512,256] k[1,2,512,256] v[1,2,512,128] causal=True"],
              "decode_attention": ["q[8,32,128] cache[8,4,1024,128] lengths 1..1024",
                                   "q[8,32,96] cache[8,8,1024,96] lengths 1..1024",
                                   "q[1,32,64] cache[1,8,600,64] length 600",
                                   "q[8,25,64] cache[8,5,1024,64] lengths 6..1024",
                                   f"q[8,20,64] cache[8,20,{WHISPER_CACHE_LEN},64] lengths "
                                   f"{WHISPER_PROMPT + WHISPER_NEW_TOKENS // 2}.."
                                   f"{WHISPER_PROMPT + WHISPER_NEW_TOKENS // 2}",
                                   "q[8,20,64] cache[8,20,1500,64] length 1500",
                                   "q[8,40,64] cache[8,2,1024,64] lengths 1..1024"],
              "ssd": [f"x[{B},{S},48,64] b,c[{B},{S},{G},128]"
                      for S, B, G in ((5, 1, 1), (65, 1, 1), (256, 1, 1), (1024, 1, 1),
                                      (600, 2, 2))]
                     + [f"x[1,{S},50,64] b,c[1,{S},1,16]" for S in (5, 500, HYMBA_LENGTHS[-1])],
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
                                                (16, f" {off4}"))]
                             + [f"[{M},1600]x[1600,6482] act=None out=bfloat16"
                                for M in (8, 17, 127, 129, 200, 500, 1000, 1400)]
                             + ["[200,1600]x[1600,6482] act=None out=float32",
                                "[200,1601]x[1601,6482] act=None out=bfloat16"]
                             + [f"[200,1600]x[1600,6482] act=None out=bfloat16 {o} 2 bytes off "
                                "16-byte alignment" for o in ("x", "w")],
              "matmul_f32": ["[2048,2048]x[2048,2048] act=None f32",
                             "[1,16384]x[16384,7168] act=None f32",
                             "[8,16384]x[16384,7168] act=None f32"],
              "rmsnorm": ["[512,2048]", "[8,1536]", "[600,1536]", "[8,3072]", "[600,3072]",
                          "[8,4096]", "[512,4096]", "[8,2048] float16", "[8,1000]",
                          "[8,2048] f32", "[8,2048] f64", "[8,1600]", "[1400,1600]",
                          "[8,3200]", "[1400,3200]", "[8,1280]", "[12000,1280]"],
              "conv2d": ["x[1,64,64,1] w[3,3,1,2] int16", "x[1,32,32,1] w[5,5,1,1] float32",
                         "x[1,32,32,1] w[3,3,1,1] float32", "x[256,64,64,1] w[3,3,1,2] int16",
                         "x[1024,64,64,1] w[3,3,1,2] int16", "x[1,80,140,1] w[68,68,1,8] float32",
                         "x[1,100,160,1] w[90,90,1,8] int16"],
              "matmul_fixed_weight": ["[2048,2048]x[2048,2048] fixed f32"],
              "flash_attention_qk192": [
                  f"q[1,128,{S},192] k[1,128,{S},192] v[1,128,{S},128] causal=True"
                  for S in (512, 128)],
              "sample": [f"[{B},{V}]" for B, V in sample_k.SHAPES[1:]]
                        + [served_row["shape"]]
                        + [f"[8,{V}] adversarial rows" for V in (128256, 32001)]}
    # the CUDA functions behind each entry
    cuda_fn = {"matmul": "mm_tile_kernel<BM,BN>, mm_stream_kernel<MP>",
               "rmsnorm": "rmsnorm_kernel<E,WARPS,NC,RESIDENT> (a block of 1-8 warps a "
                          "row, NC 16-byte chunks a thread; E bf16, f16 or f32)",
               "flash_attention": "fa_kernel<64,64>, fa_kernel<128,128> (every head_dim up "
                                  "to their own)",
               "flash_attention_qk192": "fa_kernel<192,128> (MLA's prefill: q and k 192 wide, "
                                        "v 128)",
               "decode_attention": "dec_kernel<D, DenseRows>",
               "paged_decode_attention": "dec_kernel<D, PagedRows>", "ssd": "ssd_kernel",
               "matmul_f32": "mm_f32_kernel<1,B,B> (3xTF32 on wgmma; M <= 16: "
                             "mm_f32_stream_kernel<8|16,TMA>, 3xTF32 on mma.sync)",
               "matmul_fixed_weight": "the f32 kernels on a resident weight",
               "conv2d": "conv_kernel<Tin,Acc,KH,KW,FCH,ONE_CH> (persistent, a cp.async "
                         "ring, a strip of 4 pixels a thread, FCH filters a chunk)",
               "sample": "sample_kernel<Q,NO_MARGIN> (grid (splits, B): 4 or 8 Threefry "
                         "chains a thread, the logs and division only for the pre-test's "
                         "candidates, blocks' bests merged by one 64-bit atomicMax each, the "
                         "last to arrive writes the token; programmatic dependent launch)",
               "matmul_edge": "mm_edge_stream_kernel<8|16,TMA> (M <= 16; TMA = 1 where K "
                              "% 8 == 0 and w is aligned, else cp.async copies), "
                              "mm_edge_tile_kernel<128|64> (M > 16: 128-row tiles, two copy warps, "
                              "six realigning warps writing the swizzled tiles, two wgmma "
                              "warpgroups); f32: mm_f32_stream_kernel<8|16,TMA> "
                              "(M <= 16), mm_f32_kernel<0,B,B> (M > 16)"}
    library = {"matmul": "torch.matmul", "rmsnorm": "F.rms_norm",
               "flash_attention": "F.scaled_dot_product_attention",
               "flash_attention_qk192": "F.scaled_dot_product_attention",
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
                {run: r["launches"][mod.__name__.rsplit(".", 1)[1]] for run, r in runs.items()
                 if not (mod is fa_k and run in mla_runs)})
               for mod in kernels]
    entries += [("flash_attention_qk192", fa_k, fa_k.REPLACES,
                 {run: runs[run]["launches"]["flash_attention"] for run in sorted(mla_runs)})]
    entries += [(name, mod, replaces, {"tenants": tenants_res["launches"][name]})
                for name, mod, replaces in (("matmul_f32", mm_k, mm_k.REPLACES),
                                            ("matmul_fixed_weight", mm_k, mm_k.REPLACES_FIXED),
                                            ("conv2d", conv_k, conv_k.REPLACES))]
    # the f32 matmul also runs MLA's decode wo (the resident f32 copy)
    entries[-3][3].update({run: runs[run]["launches"]["matmul_f32"] for run in sorted(mla_runs)})
    entries += [("matmul_edge", mm_k, mm_k.REPLACES,
                 {run: r["launches"]["matmul_edge"] for run, r in runs.items()
                  if r["launches"].get("matmul_edge")})]
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
            "tenants": tenants_res, "full_depth": full_res, "overcommit": overcommit_res,
            "faults": faults_res, "integrity": integrity_res, "prefix": prefix_res,
            "recovery_shapes": recovery_shapes,
            "phase_s": phase_s,
            "ssm_model": ssm_model_res, "ssm_serve": ssm_res, "ssm_busy": ssm_busy_res,
            "ssm_prefill_busy": ssm_prefill_res, "decode_splits": decode_splits,
            "sample_shapes": sample_shapes, "full_depth_shapes": full_shapes,
            "graph_against_loop": graph_res, "temperature": temp_res, "traffic": traffic_res,
            "ssm_temperature": ssm_temp_res, "moe": moe_res, "families": families_res,
            "family_shapes": family_shapes, "train": train_res, "dist": dist_res,
            "internvl2": intern_res, "internvl2_shapes": intern_checked,
            "examples": examples_res, "chip_constants": constants, "dryrun": dryrun_res,
            "dryrun_records": records,
            "launch_floor_ms": next(r["ms"] for r in rows if r["name"] == "launch_floor"),
            "summary": summary,
            "total_s": time.perf_counter() - t_start}, indent=1))
    phase_s["summary"] = lap()
    print(f"  seconds by phase: {json.dumps(phase_s)}")
    print(f"  total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": summary}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
