// bf16 matmul for Hopper: out[M,N] = epilogue(x[M,K] @ w[K,N]), its edge
// kernels and its f32 path.
//
// Replaces the Pallas TPU kernel repro/kernels/matmul.py::matmul (_mm_kernel).
// The TPU carried an f32 accumulator across a sequential K grid axis; here a
// block loops over K itself.  The bf16 path is two kernels behind the one
// entry point; the caller (kernels/matmul.py plan()) picks the kernel, its
// tile and its K split from the shape, and the entry checks what it is given.
//
// The tile kernel (prefill, chunks: the larger M) is bound by operations.
// A block owns a BM x BN output tile (128 x 256, 128 x 128, 128 x 64 or 64 x
// 64).  One producer warp keeps TMA loads of 64-deep K slices in flight in a
// ring of 4-8 stages (mbarrier full/empty pairs; x as one BM x 64 box, w as
// BN/64 boxes of 64 x 64, all 128-byte swizzled), and one consumer
// warpgroup for each 64 rows runs wgmma.mma_async m64nBNk16 straight from
// shared memory, x K-major and w [K,N] MN-major (transpose bit set for B).
// With two consumer warpgroups, setmaxnreg moves registers from the
// producer warpgroup (40) to the consumers (232), which hold a 64 x 256 f32
// accumulator at BN = 256.
//
// The weight-streaming kernel (decode, the first-token fixup: M <= 16) is
// bound by the bytes of w.  It swaps the operands, out^T = w^T x^T, so that
// 64 columns of w fill wgmma's 64-row side and M, padded only to MP = 8 or
// 16, is the instruction's N.  A block streams a 128-column strip of w over
// its share of K through a ring of six 16 KB stages (two blocks an SM: up to
// 192 KB in flight an SM), one producer warp and one consumer warpgroup.
//
// A row's K is summed in a fixed order that depends on (N, K) alone, never
// on M, the tile or the kernel: K's 64-deep slices fall into groups (the
// caller's `group` slices each, kernels/matmul.py groups()), each group is
// summed from zero on the tensor cores, and the groups' sums are added in
// order, ((0 + G0) + G1) + ...  So a prompt's row comes out bitwise the
// same whether the prompt is prefilled whole or in chunks of any size.
// Where the output tiles alone cannot fill the card, K is split across
// blocks one group a block: each writes its group's f32 tile to a
// workspace, and the block that arrives last at the tile's counter adds
// them in group order 0..s-1 (never in arrival order), applies the
// epilogue, stores, and resets the counter to 0 for the next launch on the
// stream.  Unsplit, a tile kernel block adds each group into a running
// total in registers as it ends (the 128 x 256 tile has no registers for
// one, so it runs only where K is one group).
//
// The epilogue runs from an f32 copy of the tile in shared memory (the
// ring's space, once every product has read it): silu or tanh-gelu in f32,
// then 16-byte stores of bf16 or f32, masked to M and N.  Both kernels are
// launched as programmatic dependent launches: a block sets up its barriers
// while the previous kernel on the stream finishes, and waits for it before
// it touches global memory.  Ragged shapes are
// handled here: TMA reads zeros past M, N and K, and stores are masked.  K
// and N must be multiples of 8 (16-byte rows, as TMA needs), x and w
// 16-byte aligned; the caller sends any other shape or operand to the edge
// kernels (repro_matmul_edge): for M <= 16 a weight-streaming kernel that
// copies w's rows by TMA (w viewed as [K/8][8N] "superrows") or by cp.async
// and realigns them in shared memory for mma.sync (mm_edge_stream_kernel);
// for larger M a tile kernel whose copy warpgroup fetches the same way (x
// by TMA where it can), whose realign warpgroup writes the 128-byte swizzled
// tiles wgmma reads, and whose two multiplying warpgroups run wgmma on them
// as the tile kernel does (mm_edge_tile_kernel: 128 x 128 or 128 x 256
// tiles, K summed in the same groups, split the same way).
//
// The f32 path (repro_matmul_f32: f32 x and w, f32 out) computes the f32
// product on the tensor cores by error-compensated TF32 ("3xTF32"): each
// operand split into two TF32 parts, three TF32 products summed in f32,
// close to a full f32 product: within the 2e-4 the JAX package's own test
// holds its f32 matmul to at K = 256.  Tiles on wgmma (mm_f32_kernel), or
// for M <= 16 a weight-streaming kernel on mma.sync (mm_f32_stream_kernel).
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

enum { ACT_NONE = 0, ACT_SILU = 1, ACT_GELU = 2 };

__device__ __forceinline__ float epilogue(float v, int act) {
  if (act == ACT_SILU) return v / (1.0f + expf(-v));
  if (act == ACT_GELU)  // jax.nn.gelu's default: the tanh approximation
    return 0.5f * v * (1.0f + tanhf(0.7978845608028654f * (v + 0.044715f * v * v * v)));
  return v;
}

__device__ __forceinline__ void store_out(void* out, size_t i, float v, int out_f32) {
  if (out_f32)
    static_cast<float*>(out)[i] = v;
  else
    static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16(v);
}

// The 16-byte aligned address at or below p.
__device__ __forceinline__ uintptr_t align_down16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) & ~static_cast<uintptr_t>(15);
}

// Arrive on `bar` once this thread's earlier cp.async copies have landed
// (the barrier's count includes the arrival: noinc).  A thread that copies
// this way and never fences keeps any number of copies in flight: a
// fence.proxy.async waits for the fencing thread's outstanding copies.
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// ---- bf16 path: TMA + wgmma -----------------------------------------------

constexpr int BK = 64;         // K a stage: one 128-byte swizzled row of bf16
constexpr int BOX = 64;        // columns of w a TMA box (128 bytes)
constexpr int BOX_BYTES = BOX * BK * 2;
constexpr int STREAM_BN = 128; // weight-streaming kernel: columns of w a block

template <int BM, int BN>
struct TileCfg {
  static constexpr int CONSUMERS = BM / 64;  // warpgroups, 64 rows each
  static constexpr int A_BYTES = BM * BK * 2;
  static constexpr int STAGE_BYTES = A_BYTES + BK * BN * 2;
  // 192 KB of ring at BM = 128 (deeper rings, to 224 KB, measured no faster)
  static constexpr int STAGES = BN == 256 ? 4 : (BN == 128 ? 6 : 8);
  static constexpr int LDC = BN + 8;  // f32 staging stride: conflict-free float2 writes
  static constexpr int RING = STAGES * STAGE_BYTES;
  static constexpr int STAGING = BM * LDC * 4;
  static constexpr int BODY = RING > STAGING ? RING : STAGING;
  static constexpr int SMEM = 1024 + BODY + 2 * STAGES * 8 + 16;
  static constexpr int THREADS = 128 * (CONSUMERS + 1);  // consumers, then the producer's
};

template <int MP>
struct StreamCfg {
  static constexpr int STAGES = 6;
  static constexpr int W_BYTES = 2 * BOX_BYTES;
  static constexpr int X_BYTES = MP * BK * 2;  // 1 or 2 KB: whole swizzle atoms
  static constexpr int STAGE_BYTES = W_BYTES + X_BYTES;
  static constexpr int LDC = STREAM_BN + 4;  // conflict-free transposed writes
  static constexpr int RING = STAGES * STAGE_BYTES;
  static constexpr int STAGING = MP * LDC * 4;
  static constexpr int BODY = RING > STAGING ? RING : STAGING;
  static constexpr int SMEM = 1024 + BODY + 2 * STAGES * 8 + 16;
  static constexpr int THREADS = 160;  // one consumer warpgroup, then the producer warp
};

__device__ __forceinline__ void store8(void* out, size_t i, const float (&v)[8], int out_f32) {
  if (out_f32) {
    float4* o = reinterpret_cast<float4*>(static_cast<float*>(out) + i);
    o[0] = make_float4(v[0], v[1], v[2], v[3]);
    o[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int j = 0; j < 4; ++j) h[j] = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
    *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(out) + i) = u;
  }
}

// The end of a block shared by both kernels: `stg` holds the block's f32
// tile [ROWS][COLS] (row stride LDC) at rows m0.., columns n0...  Without a
// split, apply the epilogue and store.  With one, write the partial to ws
// [splits, M, N]; the last block of the tile to arrive sums the splits in
// order 0..splits-1, applies the epilogue, stores and resets the counter.
// Run by the NT consumer threads (tid < NT) alone.  A thread reduces CB
// chunks of 8 columns at a time, loading SB splits of each before adding
// them in order, so that 2 CB SB 16-byte loads are in flight.
template <int ROWS, int COLS, int LDC, int NT, int CB, int SB>
__device__ __forceinline__ void finish_tile(const float* stg, void* out, float* ws, int* counters,
                                            volatile int* flag, int M, int N, int m0, int n0,
                                            int split, int splits, int tile, int act,
                                            int out_f32, int tid) {
  constexpr int CH = COLS / 8;  // 8-column chunks a row
  if (splits > 1) {
    for (int c = tid; c < ROWS * CH; c += NT) {
      const int r = c / CH, col = (c % CH) * 8, gr = m0 + r, gc = n0 + col;
      if (gr >= M || gc >= N) continue;
      float4* dst = reinterpret_cast<float4*>(ws + ((size_t)split * M + gr) * N + gc);
      const float4* src = reinterpret_cast<const float4*>(stg + r * LDC + col);
      __stcg(dst, src[0]);
      __stcg(dst + 1, src[1]);
    }
    // the barrier orders every thread's partial before thread 0's release;
    // its acquire orders the other partials before the reads below
    bar_sync_first<NT>();
    if (tid == 0) {
      int old;
      asm volatile("atom.add.acq_rel.gpu.global.s32 %0, [%1], 1;\n"
                   : "=r"(old)
                   : "l"(counters + tile)
                   : "memory");
      *flag = old == splits - 1;
    }
    bar_sync_first<NT>();
    if (!*flag) return;
  }
  const size_t MN = (size_t)M * N;
  for (int c0 = tid; c0 < ROWS * CH; c0 += NT * CB) {
    float v[CB][8];
    int soff[CB];
    size_t gi[CB];
    bool ok[CB];
#pragma unroll
    for (int b = 0; b < CB; ++b) {
      const int c = c0 + b * NT, r = c / CH, col = (c % CH) * 8, gr = m0 + r, gc = n0 + col;
      ok[b] = c < ROWS * CH && gr < M && gc < N;
      soff[b] = r * LDC + col;
      gi[b] = (size_t)gr * N + gc;
#pragma unroll
      for (int j = 0; j < 8; ++j) v[b][j] = 0.0f;
    }
    // without a split, the one "split" is this block's tile in shared memory
    for (int s0 = 0; s0 < splits; s0 += SB) {
      float4 lo[SB][CB], hi[SB][CB];
#pragma unroll
      for (int u = 0; u < SB; ++u)
#pragma unroll
        for (int b = 0; b < CB; ++b) {
          const int s = s0 + u;
          if (!ok[b] || s >= splits) continue;
          if (s == split) {
            const float4* src = reinterpret_cast<const float4*>(stg + soff[b]);
            lo[u][b] = src[0], hi[u][b] = src[1];
          } else {
            const float4* src = reinterpret_cast<const float4*>(ws + s * MN + gi[b]);
            lo[u][b] = __ldcg(src), hi[u][b] = __ldcg(src + 1);
          }
        }
#pragma unroll
      for (int u = 0; u < SB; ++u)
#pragma unroll
        for (int b = 0; b < CB; ++b) {
          if (!ok[b] || s0 + u >= splits) continue;
          v[b][0] += lo[u][b].x, v[b][1] += lo[u][b].y, v[b][2] += lo[u][b].z,
              v[b][3] += lo[u][b].w;
          v[b][4] += hi[u][b].x, v[b][5] += hi[u][b].y, v[b][6] += hi[u][b].z,
              v[b][7] += hi[u][b].w;
        }
    }
#pragma unroll
    for (int b = 0; b < CB; ++b) {
      if (!ok[b]) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) v[b][j] = epilogue(v[b][j], act);
      store8(out, gi[b], v[b], out_f32);
    }
  }
  if (splits > 1 && tid == 0) counters[tile] = 0;
}

// Tile kernel: grid (N tiles, M tiles, splits); block (n, m, s) owns rows
// BM m.., columns BN n.. and K slices [s per_split, (s+1) per_split): one
// group of `group` slices a block when split, else every group in turn.
template <int BM, int BN>
__global__ void __launch_bounds__(TileCfg<BM, BN>::THREADS, 1)
    mm_tile_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
                   void* __restrict__ out, float* __restrict__ ws, int* __restrict__ counters,
                   int M, int N, int K, int act, int out_f32, int per_split, int group) {
  using C = TileCfg<BM, BN>;
  // a running total of the groups beside the accumulator: up to 128 x 128
  // (64 + 64 registers a thread); the caller never gives 128 x 256 two groups
  constexpr bool TOTAL = BN <= 128;
  constexpr int NC = 128 * C::CONSUMERS;  // consumer threads
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::BODY);
  uint64_t* empty = full + C::STAGES;
  volatile int* flag = reinterpret_cast<volatile int*>(empty + C::STAGES);

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN, split = blockIdx.z;
  const int kt = (K + BK - 1) / BK;
  const int kt0 = split * per_split;
  const int nk = min(kt, kt0 + per_split) - kt0;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    prefetch_tensormap(&tx);
    prefetch_tensormap(&tw);
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 4 * C::CONSUMERS);  // lane 0 of each consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();
  grid_dependency_wait();  // the previous kernel on the stream is done with x, w, out
  launch_dependents();

  if (wg == C::CONSUMERS) {  // producer warpgroup: one thread issues every load
    if constexpr (C::CONSUMERS == 2) setmaxnreg_dec<40>();
    if (threadIdx.x == NC) {
      for (int i = 0; i < nk; ++i) {
        const int s = i % C::STAGES;
        if (i >= C::STAGES) mbar_wait(empty + s, (i / C::STAGES - 1) & 1);
        unsigned char* st = smem + s * C::STAGE_BYTES;
        const int k = (kt0 + i) * BK;
        mbar_expect_tx(full + s, C::STAGE_BYTES);
        tma_load_2d(st, &tx, full + s, k, m0);
#pragma unroll
        for (int b = 0; b < BN / BOX; ++b)
          tma_load_2d(st + C::A_BYTES + b * BOX_BYTES, &tw, full + s, n0 + b * BOX, k);
      }
    }
  } else {  // consumer warpgroup wg: rows 64 wg ..
    // (384 threads at the 168 registers ptxas gives them: 128 x 128 freed
    // by the producer pay for 256 x 64 more; one consumer needs no more)
    if constexpr (C::CONSUMERS == 2) setmaxnreg_inc<232>();
    float acc[BN / 2], tot[TOTAL ? BN / 2 : 1];
#pragma unroll
    for (int j = 0; j < BN / 2; ++j) acc[j] = 0.0f;
    if constexpr (TOTAL) {
#pragma unroll
      for (int j = 0; j < BN / 2; ++j) tot[j] = 0.0f;
    }
    // group by group: each summed from zero, then added to the total; the
    // accumulator is touched only between the groups' product loops, never
    // inside one, so ptxas keeps the products pipelined
    for (int g0 = 0; g0 < nk; g0 += group) {
      const int g1 = min(nk, g0 + group);
      if constexpr (TOTAL) {
        if (g0 > 0) {
#pragma unroll
          for (int j = 0; j < BN / 2; ++j) acc[j] = 0.0f;
        }
      }
      for (int i = g0; i < g1; ++i) {
        const int s = i % C::STAGES;
        mbar_wait(full + s, (i / C::STAGES) & 1);
        const unsigned char* st = smem + s * C::STAGE_BYTES;
        const uint64_t da = wgmma_desc(st + wg * 64 * 128, 0, 1024);
        const uint64_t db = wgmma_desc(st + C::A_BYTES, BOX_BYTES, 1024);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) wgmma<BN, 0, 1>(acc, da + 2 * kk, db + 128 * kk, 1);
        wgmma_commit();
        wgmma_wait<1>();  // the previous stage's products are done: release it
        fence_regs(acc);
        if (i > g0 && threadIdx.x % 32 == 0) mbar_arrive(empty + (i - 1) % C::STAGES);
      }
      wgmma_wait<0>();
      fence_regs(acc);
      if (threadIdx.x % 32 == 0) mbar_arrive(empty + (g1 - 1) % C::STAGES);
      if constexpr (TOTAL) {
#pragma unroll
        for (int j = 0; j < BN / 2; ++j) tot[j] += acc[j];
      }
    }
    if constexpr (TOTAL) {
#pragma unroll
      for (int j = 0; j < BN / 2; ++j) acc[j] = tot[j];
    }
    bar_sync_first<NC>();  // every product has read the ring: reuse it for the tile

    float* stg = reinterpret_cast<float*>(smem);
    const int t = threadIdx.x % 128, row = wg * 64 + (t / 32) * 16 + (t % 32) / 4;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = 8 * j + 2 * (t % 4);
      *reinterpret_cast<float2*>(stg + row * C::LDC + col) = make_float2(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<float2*>(stg + (row + 8) * C::LDC + col) =
          make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
    bar_sync_first<NC>();
    finish_tile<BM, BN, C::LDC, NC, 4, 2>(stg, out, ws, counters, flag, M, N, m0, n0, split,
                                         gridDim.z, blockIdx.y * gridDim.x + blockIdx.x, act,
                                         out_f32, threadIdx.x);
  }
}

// Weight-streaming kernel: grid (N strips of 128, splits); M <= MP.
template <int MP>
__global__ void __launch_bounds__(StreamCfg<MP>::THREADS)
    mm_stream_kernel(const __grid_constant__ CUtensorMap tx,
                     const __grid_constant__ CUtensorMap tw, void* __restrict__ out,
                     float* __restrict__ ws, int* __restrict__ counters, int M, int N, int K,
                     int act, int out_f32, int per_split) {
  using C = StreamCfg<MP>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::BODY);
  uint64_t* empty = full + C::STAGES;
  volatile int* flag = reinterpret_cast<volatile int*>(empty + C::STAGES);

  const int n0 = blockIdx.x * STREAM_BN, split = blockIdx.y;
  const int kt = (K + BK - 1) / BK;
  const int kt0 = split * per_split;
  const int nk = min(kt, kt0 + per_split) - kt0;

  if (threadIdx.x == 0) {
    prefetch_tensormap(&tx);
    prefetch_tensormap(&tw);
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 4);
    }
    mbar_fence_init();
  }
  __syncthreads();
  grid_dependency_wait();  // the previous kernel on the stream is done with x, w, out
  launch_dependents();

  if (threadIdx.x >= 128) {  // producer warp
    if (threadIdx.x == 128) {
      for (int i = 0; i < nk; ++i) {
        const int s = i % C::STAGES;
        if (i >= C::STAGES) mbar_wait(empty + s, (i / C::STAGES - 1) & 1);
        unsigned char* st = smem + s * C::STAGE_BYTES;
        const int k = (kt0 + i) * BK;
        mbar_expect_tx(full + s, C::W_BYTES + MP * BK * 2);
        tma_load_2d(st, &tw, full + s, n0, k);
        tma_load_2d(st + BOX_BYTES, &tw, full + s, n0 + BOX, k);
        tma_load_2d(st + C::W_BYTES, &tx, full + s, k, 0);
      }
    }
  } else {  // consumer warpgroup: out^T[128, MP] as two m64nMP products
    float acc0[MP / 2], acc1[MP / 2];
#pragma unroll
    for (int j = 0; j < MP / 2; ++j) acc0[j] = acc1[j] = 0.0f;
    for (int i = 0; i < nk; ++i) {
      const int s = i % C::STAGES;
      mbar_wait(full + s, (i / C::STAGES) & 1);
      const unsigned char* st = smem + s * C::STAGE_BYTES;
      const uint64_t dw0 = wgmma_desc(st, BOX_BYTES, 1024);
      const uint64_t dw1 = wgmma_desc(st + BOX_BYTES, BOX_BYTES, 1024);
      const uint64_t dx = wgmma_desc(st + C::W_BYTES, 0, 1024);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wgmma<MP, 1, 0>(acc0, dw0 + 128 * kk, dx + 2 * kk, 1);
        wgmma<MP, 1, 0>(acc1, dw1 + 128 * kk, dx + 2 * kk, 1);
      }
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(acc0);
      fence_regs(acc1);
      if (i > 0 && threadIdx.x % 32 == 0) mbar_arrive(empty + (i - 1) % C::STAGES);
    }
    wgmma_wait<0>();
    fence_regs(acc0);
    fence_regs(acc1);
    bar_sync_first<128>();

    // transpose into the tile [MP rows of out][128 columns]
    float* stg = reinterpret_cast<float*>(smem);
    const int t = threadIdx.x, n = (t / 32) * 16 + (t % 32) / 4;
#pragma unroll
    for (int j = 0; j < MP / 8; ++j) {
      const int m = 8 * j + 2 * (t % 4);
      stg[m * C::LDC + n] = acc0[4 * j];
      stg[(m + 1) * C::LDC + n] = acc0[4 * j + 1];
      stg[m * C::LDC + n + 8] = acc0[4 * j + 2];
      stg[(m + 1) * C::LDC + n + 8] = acc0[4 * j + 3];
      stg[m * C::LDC + 64 + n] = acc1[4 * j];
      stg[(m + 1) * C::LDC + 64 + n] = acc1[4 * j + 1];
      stg[m * C::LDC + 64 + n + 8] = acc1[4 * j + 2];
      stg[(m + 1) * C::LDC + 64 + n + 8] = acc1[4 * j + 3];
    }
    bar_sync_first<128>();
    finish_tile<MP, STREAM_BN, C::LDC, 128, 1, 8>(stg, out, ws, counters, flag, M, N, 0, n0, split,
                                            gridDim.y, blockIdx.x, act, out_f32, threadIdx.x);
  }
}

// The end of a block whose output rows are not 16-byte aligned, or whose
// tile is too small to need vector stores (the f32 kernel, the bf16 edge
// kernels): `stg` holds the block's f32 tile [ROWS][COLS] (row stride LDC)
// at rows m0.., columns n0...  The split protocol of finish_tile with scalar,
// masked loads and stores: with a split, each block writes its partial to ws
// [splits, M, N], and the last block of the tile to arrive sums the splits
// in order 0..splits-1, applies the epilogue, stores and resets the counter.
// Run by the NT threads tid < NT alone (barrier 1).
template <int ROWS, int COLS, int LDC, int NT>
__device__ __forceinline__ void finish_scalar(const float* stg, void* out, float* ws, int* counters,
                                              volatile int* flag, int M, int N, int m0, int n0,
                                              int split, int splits, int tile, int act,
                                              int out_f32, int tid) {
  const size_t MN = (size_t)M * N;
  if (splits > 1) {
    for (int e = tid; e < ROWS * COLS; e += NT) {
      const int r = e / COLS, c = e % COLS, gr = m0 + r, gc = n0 + c;
      if (gr < M && gc < N) __stcg(ws + split * MN + (size_t)gr * N + gc, stg[r * LDC + c]);
    }
    __threadfence();
    bar_sync_first<NT>();
    if (tid == 0) {
      int old;
      asm volatile("atom.add.acq_rel.gpu.global.s32 %0, [%1], 1;\n"
                   : "=r"(old)
                   : "l"(counters + tile)
                   : "memory");
      *flag = old == splits - 1;
    }
    bar_sync_first<NT>();
    if (!*flag) return;
  }
  for (int e = tid; e < ROWS * COLS; e += NT) {
    const int r = e / COLS, c = e % COLS, gr = m0 + r, gc = n0 + c;
    if (gr >= M || gc >= N) continue;
    const size_t gi = (size_t)gr * N + gc;
    float v = 0.0f;
    for (int s = 0; s < splits; ++s) v += s == split ? stg[r * LDC + c] : __ldcg(ws + s * MN + gi);
    store_out(out, gi, epilogue(v, act), out_f32);
  }
  if (splits > 1 && tid == 0) counters[tile] = 0;
}

// ---- f32 path: 3xTF32 on wgmma ------------------------------------------------
//
// Each f32 operand value a is split into two TF32 values, big = a with its
// low 13 mantissa bits cleared and small = (a - big) likewise (a - big is
// exact), so a = big + small + r with |r| < 2^-21 |a|; then x w =
// xs wb + xb ws + xb wb + (xs ws and the r terms, below f32's rounding of
// these sums at the paths' sizes), three TF32 products on wgmma.  The
// tensor cores' f32 sum truncates as it adds, by up to an ulp of the
// running sum a step and always toward zero, so over K = 2048 of O(1)
// products the error grows with K (5e-4 at |out| ~ 45: more than the 2e-4
// asked).  So the wgmma accumulator restarts at each 32-deep slice and is
// added into an f32 register sum (rounded to nearest): the tensor cores
// only ever hold a slice's partial, and the slices' errors, of either
// sign, add as a random walk.
//
// TF32 wgmma takes both operands K-major, so w [K,N] (MN-major) is
// transposed on its way into shared memory.  A block owns a BM x BN output
// tile, 128 x 128 or, for small products, 64 x 64 (the caller's f32_plan):
//   - copy: the consumer warpgroups fetch each 32-deep K slice of x and w
//     with cp.async into a raw ring of three stages, two slices ahead, right
//     after they issue a stage's products; each stage is signalled by the
//     copies' own arrival on an mbarrier;
//   - split: a converter warpgroup splits each slice and writes the four
//     parts (x big, x small, w^T big, w^T small) as 128-byte swizzled
//     K-major tiles into a ring of two stages, fenced for the async proxy;
//   - multiply: each consumer warpgroup (64 rows) runs 12 m64nBNk8 products
//     a stage and adds the stage's sum into its own.
// The copies and the fences are kept in different warps: a fence.proxy.async
// waits for its own thread's copies in flight, so a thread that did both
// would wait out a memory latency every slice (against 0.85 us of
// products a slice on an H100); and a single copy warp cannot keep enough in
// flight.  Ragged M, N and K load zeros.  With VEC (K and N multiples of 4,
// x and w 16-byte aligned) the copies are the tiles' own 16-byte words;
// otherwise (the edge instance) each row of x (32 values) and of w (BN
// values) is copied as the aligned superset of its bytes in 16-byte words,
// and the converter reads each value at its row's offset (4-byte copies
// measured 10x slower), so any shape and 4-byte alignment.  The tile leaves
// through shared memory: 16-byte stores (finish_tile) where N is a multiple
// of 8 and out 16-byte aligned, scalar ones otherwise (finish_scalar).
// Where the tiles are too few for the card, K is split across blocks and
// summed in the same launch.  What bounds it: at [2048]^3 shared memory's
// bandwidth (a stage moves 272 KB through it: 1.2 us at 128 bytes a clock
// against 0.85 of three TF32 passes at 495 TFLOP/s); at the paper's 256 x 256 x 256 a slice's
// latency through copy, split and products.  M <= 16 takes
// mm_f32_stream_kernel (below) instead: these tiles would pad M to 64 rows.

constexpr int FBK = 32;       // K a stage: a 128-byte row of f32
constexpr int F_STAGES = 2;   // split stages

// A BM x BN output tile (64 or 128 each): BM / 64 consumer warpgroups
// (which copy), then the converter warpgroup.  The raw ring: x [BM][32 k]
// then w [32 k][BN], as the tiles (VEC) or as rows' aligned supersets (the
// edge instance: a word more a row).
template <int VEC, int BM, int BN>
struct F32Cfg {
  static constexpr int CONS = BM / 64;
  static constexpr int NC = 128 * CONS;                       // consumer threads
  static constexpr int THREADS = NC + 128;
  static constexpr int PX = BM * FBK * 4, PW = BN * FBK * 4;  // a part of x, of w^T
  static constexpr int STAGE = 2 * PX + 2 * PW;               // x big, small; w^T big, small
  static constexpr int RING = F_STAGES * STAGE;
  static constexpr int XW = VEC ? 8 : 9, WW = VEC ? BN / 4 : BN / 4 + 1;  // raw words a row
  static constexpr int RX = BM * XW * 16;                     // raw bytes of x a stage
  static constexpr int RAW = RX + FBK * WW * 16;
  static constexpr int RAW_STAGES = VEC ? 3 : 2;
  static constexpr int LDC = BN + 8;                          // f32 staging stride
  static constexpr int SMEM =
      1024 + RING + RAW_STAGES * RAW + (2 * F_STAGES + RAW_STAGES) * 8 + 16;
  static_assert(BM * LDC * 4 <= RING, "the staged tile fits in the ring");
};

// big = a with its low 13 mantissa bits cleared; small = (a - big) likewise.
__device__ __forceinline__ void split_tf32(float a, uint32_t& big, uint32_t& small) {
  big = __float_as_uint(a) & 0xffffe000u;
  small = __float_as_uint(a - __uint_as_float(big)) & 0xffffe000u;
}

// grid (N tiles, M tiles, splits); block (n, m, s) owns rows BM m..,
// columns BN n.. and K slices [s per_split, (s+1) per_split).
template <int VEC, int BM, int BN>
__global__ void __launch_bounds__(F32Cfg<VEC, BM, BN>::THREADS, 1)
    mm_f32_kernel(const float* __restrict__ x, const float* __restrict__ w, float* __restrict__ out,
                  float* __restrict__ ws, int* __restrict__ counters, int M, int N, int K, int act,
                  int per_split, int vec_out) {
  using C = F32Cfg<VEC, BM, BN>;
  constexpr int NC = C::NC;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* raw = smem + C::RING;
  uint64_t* full = reinterpret_cast<uint64_t*>(raw + C::RAW_STAGES * C::RAW);
  uint64_t* empty = full + F_STAGES;
  uint64_t* raw_full = empty + F_STAGES;
  volatile int* flag = reinterpret_cast<volatile int*>(raw_full + C::RAW_STAGES);

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN, split = blockIdx.z;
  const int kt = (K + FBK - 1) / FBK;
  const int kt0 = split * per_split;
  const int nk = min(kt, kt0 + per_split) - kt0;
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < F_STAGES; ++s) {
      mbar_init(full + s, 128);          // every converter thread
      mbar_init(empty + s, 4 * C::CONS); // lane 0 of each consumer warp
    }
    for (int s = 0; s < C::RAW_STAGES; ++s)
      mbar_init(raw_full + s, NC);  // every consumer thread, as its copies land
    mbar_fence_init();
  }
  __syncthreads();
  grid_dependency_wait();  // the previous kernel on the stream is done with x, w, out
  launch_dependents();

  if (wg == C::CONS) {  // converter thread t: split and store the parts of stage i
    if constexpr (C::CONS == 2) setmaxnreg_dec<56>();
    for (int i = 0; i < nk; ++i) {
      const int rs = i % C::RAW_STAGES, s = i % F_STAGES;
      mbar_wait(raw_full + rs, (i / C::RAW_STAGES) & 1);
      if (i >= F_STAGES) mbar_wait(empty + s, (i / F_STAGES - 1) & 1);
      const unsigned char* rb = raw + rs * C::RAW;
      const float* rx = reinterpret_cast<const float*>(rb);
      const float* rw = reinterpret_cast<const float*>(rb + C::RX);
      const int k0 = (kt0 + i) * FBK;
      unsigned char* st = smem + s * C::STAGE;
#pragma unroll
      for (int it = 0; it < BM / 16; ++it) {  // x: row c / 8, chunk c % 8
        const int c = it * 128 + t, r = c / 8, q = c % 8;
        float4 v;
        if constexpr (VEC) {
          v = reinterpret_cast<const float4*>(rx)[c];
        } else {  // the row's values start sh words into its superset; zero past M and K
          const float* row = rx + r * 4 * C::XW +
                             ((reinterpret_cast<uintptr_t>(x + (size_t)(m0 + r) * K + k0) & 15) >>
                              2);
          const bool ok = m0 + r < M;
          const int k = k0 + 4 * q;
          v.x = ok && k < K ? row[4 * q] : 0.0f;
          v.y = ok && k + 1 < K ? row[4 * q + 1] : 0.0f;
          v.z = ok && k + 2 < K ? row[4 * q + 2] : 0.0f;
          v.w = ok && k + 3 < K ? row[4 * q + 3] : 0.0f;
        }
        uint4 big, small;
        split_tf32(v.x, big.x, small.x);
        split_tf32(v.y, big.y, small.y);
        split_tf32(v.z, big.z, small.z);
        split_tf32(v.w, big.w, small.w);
        const int off = r * 128 + ((q ^ (r & 7)) << 4);
        *reinterpret_cast<uint4*>(st + off) = big;
        *reinterpret_cast<uint4*>(st + C::PX + off) = small;
      }
#pragma unroll
      for (int it = 0; it < BN / 16; ++it) {  // w^T: row n = c % BN, chunk c / BN
        const int c = it * 128 + t, n = c % BN, q = c / BN;
        float v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int k = 4 * q + j;
          if constexpr (VEC) {
            v[j] = rw[k * BN + n];
          } else {  // row k's values start sh words into its superset; zero past K and N
            const uintptr_t a = reinterpret_cast<uintptr_t>(w + (size_t)(k0 + k) * N + n0);
            v[j] = k0 + k < K && n0 + n < N ? rw[k * 4 * C::WW + ((a & 15) >> 2) + n] : 0.0f;
          }
        }
        uint4 big, small;
        split_tf32(v[0], big.x, small.x);
        split_tf32(v[1], big.y, small.y);
        split_tf32(v[2], big.z, small.z);
        split_tf32(v[3], big.w, small.w);
        const int off = n * 128 + ((q ^ (n & 7)) << 4);
        *reinterpret_cast<uint4*>(st + 2 * C::PX + off) = big;
        *reinterpret_cast<uint4*>(st + 2 * C::PX + C::PW + off) = small;
      }
      fence_proxy_async();
      mbar_arrive(full + s);
    }
    return;
  }

  // (with two consumer warpgroups, 384 threads at the 168 registers ptxas
  // gives them: the converter's 128 x 112 freed pay for 256 x 56 more, so
  // the consumers hold both sums without spilling)
  if constexpr (C::CONS == 2) setmaxnreg_inc<224>();

  // consumer thread ct's share of stage i's raw words (the converter has
  // read the slot's previous stage, i - 3: a consumer issues stage i after
  // stage i - 2 was split and stored)
  const int ct = threadIdx.x;
  auto issue = [&](int i) {
    const int s = i % C::RAW_STAGES;
    float* rx = reinterpret_cast<float*>(raw + s * C::RAW);
    float* rw = reinterpret_cast<float*>(raw + s * C::RAW + C::RX);
    const int k0 = (kt0 + i) * FBK;
    if constexpr (VEC) {  // 16-byte words: 8 a row of x, BN / 4 a row of w
#pragma unroll
      for (int q = 0; q < BM * 8 / NC; ++q) {
        const int c = ct + NC * q, gr = m0 + c / 8, k = k0 + 4 * (c % 8);
        const bool ok = gr < M && k < K;
        cp_async16(rx + 4 * c, ok ? x + (size_t)gr * K + k : x, ok);
      }
#pragma unroll
      for (int q = 0; q < FBK * BN / 4 / NC; ++q) {
        const int c = ct + NC * q, k = k0 + c / (BN / 4), n = n0 + 4 * (c % (BN / 4));
        const bool ok = k < K && n < N;
        cp_async16(rw + 4 * c, ok ? w + (size_t)k * N + n : w, ok);
      }
    } else {  // rows' aligned supersets in 16-byte words, none wholly past the tensor
      const uintptr_t x_end = reinterpret_cast<uintptr_t>(x + (size_t)M * K);
      const uintptr_t w_end = reinterpret_cast<uintptr_t>(w + (size_t)K * N);
      for (int c = ct; c < BM * C::XW; c += NC) {
        const int r = c / C::XW, j = c % C::XW;
        if (m0 + r >= M) continue;
        const uintptr_t a0 = align_down16(x + (size_t)(m0 + r) * K + k0), a = a0 + 16 * j;
        cp_async16(rx + 4 * c, reinterpret_cast<const void*>(a < x_end ? a : a0), a < x_end);
      }
      for (int c = ct; c < FBK * C::WW; c += NC) {
        const int k = c / C::WW, j = c % C::WW;
        if (k0 + k >= K) continue;
        const uintptr_t a0 = align_down16(w + (size_t)(k0 + k) * N + n0), a = a0 + 16 * j;
        cp_async16(rw + 4 * c, reinterpret_cast<const void*>(a < w_end ? a : a0), a < w_end);
      }
    }
    cp_async_arrive(raw_full + s);
  };
  for (int i = 0; i < C::RAW_STAGES - 1 && i < nk; ++i) issue(i);

  // consumer warpgroup wg: rows 64 wg ..; acc the stage's products, sum the
  // stages'
  float acc[BN / 2], sum[BN / 2];
#pragma unroll
  for (int j = 0; j < BN / 2; ++j) acc[j] = sum[j] = 0.0f;
  for (int i = 0; i < nk; ++i) {
    const int s = i % F_STAGES;
    mbar_wait(full + s, (i / F_STAGES) & 1);
    const unsigned char* st = smem + s * C::STAGE;
    const uint64_t xb = wgmma_desc(st + wg * 64 * 128, 0, 1024);
    const uint64_t xs = wgmma_desc(st + C::PX + wg * 64 * 128, 0, 1024);
    const uint64_t wb = wgmma_desc(st + 2 * C::PX, 0, 1024);
    const uint64_t wsm = wgmma_desc(st + 2 * C::PX + C::PW, 0, 1024);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < FBK / 8; ++kk) {  // the small terms first, then big x big
      wgmma_tf32<BN>(acc, xs + 2 * kk, wb + 2 * kk, kk > 0);
      wgmma_tf32<BN>(acc, xb + 2 * kk, wsm + 2 * kk, 1);
      wgmma_tf32<BN>(acc, xb + 2 * kk, wb + 2 * kk, 1);
    }
    wgmma_commit();
    if (i + C::RAW_STAGES - 1 < nk) issue(i + C::RAW_STAGES - 1);  // while the products run
    wgmma_wait<0>();  // this stage's products are done: release it, add them up
    fence_regs(acc);
    if (threadIdx.x % 32 == 0) mbar_arrive(empty + s);
#pragma unroll
    for (int j = 0; j < BN / 2; ++j) sum[j] += acc[j];
  }
  bar_sync_first<NC>();  // every product has read the ring: reuse it for the tile

  float* stg = reinterpret_cast<float*>(smem);
  const int row = wg * 64 + (t / 32) * 16 + (t % 32) / 4;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = 8 * j + 2 * (t % 4);
    *reinterpret_cast<float2*>(stg + row * C::LDC + col) = make_float2(sum[4 * j], sum[4 * j + 1]);
    *reinterpret_cast<float2*>(stg + (row + 8) * C::LDC + col) =
        make_float2(sum[4 * j + 2], sum[4 * j + 3]);
  }
  bar_sync_first<NC>();
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  if (vec_out)
    finish_tile<BM, BN, C::LDC, NC, 4, 2>(stg, out, ws, counters, flag, M, N, m0, n0, split,
                                          gridDim.z, tile, act, 1, threadIdx.x);
  else
    finish_scalar<BM, BN, C::LDC, NC>(stg, out, ws, counters, flag, M, N, m0, n0, split,
                                      gridDim.z, tile, act, 1, threadIdx.x);
}

// ---- f32 for M <= 16: streaming w, 3xTF32 on mma.sync -------------------------
//
// At M <= 16 the tile kernel above pads M to 64 or 128 rows: wasted
// products, and a slice bound by shared memory, where the weight's bytes
// should bound it.  This kernel streams w as the bf16 edge kernel does: a
// block owns a 64-column strip (and its share of K) in 64-row stages, and
// computes out^T = w^T x^T on mma.sync m16n8k16's TF32 sibling m16n8k8,
// three products a fragment pair (the split of the kernel above), the
// accumulator restarted each stage into an f32 register sum.
//   - copy, TMA (K a multiple of 4, w 16-byte aligned): four f32 rows are
//     16N bytes, so w viewed as [K/4][4N] "superrows" is a legal TMA source;
//     a stage is four boxes of 16 superrows x 68 values, box r holding rows
//     4i + r at one offset, (r N + n0) mod 4 values past its start (the
//     16-byte boundary at or below r N + n0); tile row 16r + i holds the
//     stage's row 4i + r, and x's k are permuted to match;
//   - copy, otherwise: each row's aligned superset (17 16-byte words) by
//     cp.async, rows in order, each at its own offset;
//   - no realign: an f32 value is 4-byte aligned wherever the row starts,
//     so each thread loads its w^T fragment values from the raw rows at the
//     rows' offsets, and its x^T fragment values from x (plain loads, a
//     stage ahead);
//   - the tile [MP][64] leaves through finish_scalar.
// Bound by the bytes of w.

constexpr int FSN = 64;              // columns of w a block
constexpr int FS_ROW = FSN + 4;      // floats a raw row: the strip's aligned superset

template <int MP>
struct F32StreamCfg {
  static constexpr int RAW = BK * FS_ROW * 4;                  // 64 rows of 272 bytes
  static constexpr int RING = (112 * 1024 - 1024 - 16) / (RAW + 8);  // two blocks an SM
  static constexpr int LDC = FSN + 4;
  static constexpr int SMEM = 1024 + RING * (RAW + 8) + 16;
  static_assert(MP * LDC * 4 <= RING * RAW, "the staged tile fits in the raw ring");
};

__device__ __forceinline__ void mma_tf32_1688(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                              uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// grid (N strips of 64, splits); M <= MP.  Warp q multiplies columns 16 q ..
// of the strip.  TMA: tw is the superrow map (boxes of 16 x 68).
template <int MP, bool TMA>
__global__ void __launch_bounds__(128)
    mm_f32_stream_kernel(const __grid_constant__ CUtensorMap tw, const float* __restrict__ x,
                         const float* __restrict__ w, float* __restrict__ out,
                         float* __restrict__ ws, int* __restrict__ counters, int M, int N,
                         int K, int act, int per_split) {
  using C = F32StreamCfg<MP>;
  constexpr int RING = C::RING;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + RING * C::RAW);
  volatile int* flag = reinterpret_cast<volatile int*>(full + RING);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int n0 = blockIdx.x * FSN, split = blockIdx.y;
  const int kt = (K + BK - 1) / BK;
  const int kt0 = split * per_split;
  const int nk = min(kt, kt0 + per_split) - kt0;
  const int kend = min(K, (kt0 + nk) * BK);  // the split's rows end here
  // the stage's row in tile row tr
  auto row_of = [](int tr) { return TMA ? 4 * (tr % 16) + tr / 16 : tr; };

  if (TMA && tid == 0) {
    prefetch_tensormap(&tw);
    for (int s = 0; s < RING; ++s) mbar_init(full + s, 1);
    mbar_fence_init();
  }
  __syncthreads();
  grid_dependency_wait();  // the previous kernel on the stream is done with x, w, out
  launch_dependents();

  auto issue = [&](int i) {  // stage i's copies of w
    unsigned char* st = smem + (i % RING) * C::RAW;
    if constexpr (TMA) {  // thread 0: four boxes, residue r's at tile rows 16r ..
      mbar_expect_tx(full + i % RING, C::RAW);
#pragma unroll
      for (int r = 0; r < 4; ++r)
        tma_load_2d(st + r * 16 * FS_ROW * 4, &tw, full + i % RING, (r * N + n0) & ~3,
                    (kt0 + i) * (BK / 4));
    } else {
      const uintptr_t w_end = reinterpret_cast<uintptr_t>(w + (size_t)K * N);
      const int k0 = (kt0 + i) * BK;
      for (int c = tid; c < BK * (FS_ROW / 4); c += 128) {
        const int r = c / (FS_ROW / 4), j = c % (FS_ROW / 4);
        if (k0 + r >= kend) continue;
        const uintptr_t a0 = align_down16(w + (size_t)(k0 + r) * N + n0), a = a0 + 16 * j;
        cp_async16(st + c * 16, reinterpret_cast<const void*>(a < w_end ? a : a0), a < w_end);
      }
    }
  };
  // this thread's x^T fragment values of stage i: b[kk][mt][0 | 1] = x[8 mt + g]
  // at tile rows 8 kk + t and + 4
  float xv[BK / 8][MP / 8][2];
  auto load_x = [&](int i) {
    const int k0 = (kt0 + i) * BK;
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk)
#pragma unroll
      for (int mt = 0; mt < MP / 8; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = 8 * mt + g, k = k0 + row_of(8 * kk + t + 4 * h);
          xv[kk][mt][h] = m < M && k < kend ? __ldg(x + (size_t)m * K + k) : 0.0f;
        }
  };

  float sum[MP / 8][4];
#pragma unroll
  for (int mt = 0; mt < MP / 8; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e) sum[mt][e] = 0.0f;
  if (!TMA || tid == 0)
#pragma unroll
    for (int i = 0; i < RING - 1; ++i) {
      if (i < nk) issue(i);
      if (!TMA) cp_async_commit();
    }
  if (nk > 0) load_x(0);
  for (int i = 0; i < nk; ++i) {
    // every thread is done with stage i - 1's slot, which stage i + RING - 1 takes
    __syncthreads();
    if (TMA) {
      if (tid == 0 && i + RING - 1 < nk) issue(i + RING - 1);
      mbar_wait(full + i % RING, (i / RING) & 1);
    } else {
      if (i + RING - 1 < nk) issue(i + RING - 1);
      cp_async_commit();
      cp_async_wait<RING - 1>();  // this thread's words of stage i have landed
      __syncthreads();            // everyone's
    }
    const float* st = reinterpret_cast<const float*>(smem + (i % RING) * C::RAW);
    const int k0 = (kt0 + i) * BK;
    float acc[MP / 8][4];
#pragma unroll
    for (int mt = 0; mt < MP / 8; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
      // w^T [16 n][8 k] fragment: a0 = (n g, k t), a1 = (n g + 8, k t), a2 = (n g, k t + 4),
      // a3 = (n g + 8, k t + 4); tile rows 8 kk + t (+ 4), each at its row's offset
      float av[4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int tr = 8 * kk + t + 4 * h;
        int sh;
        if constexpr (TMA) {
          sh = ((tr / 16) * N + n0) & 3;
        } else {
          sh = static_cast<int>((reinterpret_cast<uintptr_t>(w + (size_t)(k0 + tr) * N + n0) &
                                 15) >> 2);
        }
        const float* row = st + tr * FS_ROW + sh + warp * 16 + g;
        const bool ok = TMA || k0 + tr < kend;
        av[2 * h] = ok ? row[0] : 0.0f;
        av[2 * h + 1] = ok ? row[8] : 0.0f;
      }
      uint32_t ab[4], as[4];
      split_tf32(av[0], ab[0], as[0]);  // a0
      split_tf32(av[1], ab[1], as[1]);  // a1
      split_tf32(av[2], ab[2], as[2]);  // a2
      split_tf32(av[3], ab[3], as[3]);  // a3
#pragma unroll
      for (int mt = 0; mt < MP / 8; ++mt) {
        uint32_t b0b, b0s, b1b, b1s;
        split_tf32(xv[kk][mt][0], b0b, b0s);
        split_tf32(xv[kk][mt][1], b1b, b1s);
        mma_tf32_1688(acc[mt], as, b0b, b1b);  // the small terms first, then big x big
        mma_tf32_1688(acc[mt], ab, b0s, b1s);
        mma_tf32_1688(acc[mt], ab, b0b, b1b);
      }
    }
#pragma unroll
    for (int mt = 0; mt < MP / 8; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sum[mt][e] += acc[mt][e];
    if (i + 1 < nk) load_x(i + 1);
  }
  if (!TMA) cp_async_wait<0>();
  __syncthreads();  // the raw ring is idle: stage the tile there

  // c0, c1 = out^T[n][m, m + 1], c2, c3 = out^T[n + 8][m, m + 1]
  float* stg = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int mt = 0; mt < MP / 8; ++mt) {
    const int n = warp * 16 + g, m = mt * 8 + 2 * t;
    stg[m * C::LDC + n] = sum[mt][0];
    stg[(m + 1) * C::LDC + n] = sum[mt][1];
    stg[m * C::LDC + n + 8] = sum[mt][2];
    stg[(m + 1) * C::LDC + n + 8] = sum[mt][3];
  }
  __syncthreads();
  finish_scalar<MP, FSN, C::LDC, 128>(stg, out, ws, counters, flag, M, N, 0, n0, split,
                                      gridDim.y, blockIdx.x, act, 1, tid);
}

// ---- bf16 edge kernel for M <= 16: streaming w from unaligned rows ----------
//
// The edge case lacks alignment, not bandwidth: row k of a [K, 49155] weight
// starts (k N + n0) mod 8 values past a 16-byte boundary, and that offset
// cycles through 0..7.  A block owns a 128-column strip of w (and its share
// of K, where K is split) and streams it in 64-row stages:
//   - copy, TMA: eight rows of w are 16 N bytes, a multiple of 16, so with
//     K a multiple of 8 and w 16-byte aligned, w viewed as [K/8][8N]
//     "superrows" is a legal TMA source, and rows 8i + r (i = 0..7) of a
//     stage are superrows k0/8 + i at columns r N + n0 ...: one box of 8
//     superrows x 136 columns (no swizzle) a residue r, started at the
//     16-byte boundary at or below r N + n0 (a box must start on one), so
//     its 8 rows share one offset, (r N + n0) mod 8 values.  One thread
//     issues the stage's eight boxes on an mbarrier; the tile's rows come
//     permuted (tile row 8r + i holds the stage's row 8i + r).  Past 8N
//     columns and K/8 superrows TMA reads zeros;
//   - copy, otherwise (K not a multiple of 8, or w unaligned): every thread
//     fetches rows' aligned supersets, 17 16-byte cp.async.cg words a row, a
//     word starting at or past the tensor's end landing as zeros, rows in
//     order;
//   - realign: each row is shifted by its offset (the two words a 16-byte
//     output straddles, a funnel shift per 32-bit lane) into an aligned,
//     padded tile w [64 k][128 n]; x's tile [MP m][64 k] is written from
//     plain loads made a stage ahead, its columns in the rows' order; rows
//     past the split's end and x values past it are zeros; columns past N
//     are left as read, and only the discarded outputs see them;
//   - multiply: out^T[128, MP] += w^T x^T on mma.sync m16n8k16 (M padded to
//     MP = 8 or 16), w^T's fragments by ldmatrix.trans, x^T's by ldmatrix;
//   - the end: the tile [MP][128] through finish_scalar (scalar stores: the
//     output's rows are as unaligned as w's).
// Why mma.sync and not wgmma: wgmma reads shared memory through the async
// proxy, so the realigned tiles would need a fence.proxy.async, and that
// fence waits for the fencing thread's own cp.async copies in flight (200
// us at granite's unembed on an H100, each stage waiting out a memory
// latency).  At
// M <= 16 the products are a few percent of a stage.  Bound by the bytes of
// w at the unembeds' decode shapes (the sweep's edge table times both
// copies, and the aligned streaming kernel on the same bytes: PERF.md).

constexpr int EBN_S = 128;                // columns of w a block
constexpr int EW_WORDS = EBN_S / 8 + 1;   // 16-byte words of a row's aligned superset
constexpr int EW_LD = EBN_S + 8;          // the w tile's padded row (bf16): conflict-free ldmatrix
constexpr int EX_LD = BK + 8;             // the x tile's padded row

template <int MP>
struct EdgeCfg {
  static constexpr int RAW = BK * EW_WORDS * 16;     // 64 rows of 272 bytes (8 boxes of 8 rows)
  static constexpr int W_TILE = BK * EW_LD * 2;
  static constexpr int TILE = W_TILE + MP * EX_LD * 2;
  static constexpr int RING = (112 * 1024 - 1024 - 16 - 2 * TILE) / (RAW + 8);  // 2 blocks an SM
  static constexpr int LDC = EBN_S + 4;
  static constexpr int SMEM = 1024 + 2 * TILE + RING * (RAW + 8) + 16;
  static_assert(RING >= 3, "at least two raw stages in flight");
  static_assert(RAW % 128 == 0 && TILE % 128 == 0, "TMA boxes land 128-byte aligned");
  static_assert(MP * LDC * 4 <= RING * RAW, "the staged tile fits in the raw ring");
};

// The 16 bytes that start `sh` bytes (even, < 16) into the 32 bytes lo, hi.
__device__ __forceinline__ uint4 shift16(const uint4& lo, const uint4& hi, unsigned sh) {
  const uint32_t u[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  uint32_t v[6], z[5];
#pragma unroll
  for (int j = 0; j < 6; ++j) v[j] = (sh & 8) ? u[j + 2] : u[j];
#pragma unroll
  for (int j = 0; j < 5; ++j) z[j] = (sh & 4) ? v[j + 1] : v[j];
  const unsigned b = (sh & 3) * 8;
  return make_uint4(__funnelshift_r(z[0], z[1], b), __funnelshift_r(z[1], z[2], b),
                    __funnelshift_r(z[2], z[3], b), __funnelshift_r(z[3], z[4], b));
}

// grid (N strips of 128, splits); M <= MP.  Warp q multiplies columns
// 32 q .. of the strip.  TMA: tw is the superrow map (boxes of 8 x 136).
template <int MP, bool TMA>
__global__ void __launch_bounds__(128)
    mm_edge_stream_kernel(const __grid_constant__ CUtensorMap tw,
                          const unsigned short* __restrict__ x,
                          const unsigned short* __restrict__ w, void* __restrict__ out,
                          float* __restrict__ ws, int* __restrict__ counters, int M, int N, int K,
                          int act, int out_f32, int per_split) {
  using C = EdgeCfg<MP>;
  constexpr int RING = C::RING, HW = EBN_S / 16;  // HW: words a thread realigns
  constexpr int NT = EBN_S / 64;                  // n16 tiles a warp
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* raw = smem + 2 * C::TILE;
  uint64_t* full = reinterpret_cast<uint64_t*>(raw + RING * C::RAW);
  volatile int* flag = reinterpret_cast<volatile int*>(full + RING);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n0 = blockIdx.x * EBN_S, split = blockIdx.y;
  const int kt = (K + BK - 1) / BK;
  const int kt0 = split * per_split;
  const int nk = min(kt, kt0 + per_split) - kt0;
  const int kend = min(K, (kt0 + nk) * BK);  // the split's rows end here
  // the stage's row in tile row t
  auto row_of = [](int t) { return TMA ? 8 * (t % 8) + t / 8 : t; };

  if (TMA && tid == 0) {
    prefetch_tensormap(&tw);
    for (int s = 0; s < RING; ++s) mbar_init(full + s, 1);
    mbar_fence_init();
  }
  __syncthreads();
  grid_dependency_wait();  // the previous kernel on the stream is done with x, w, out
  launch_dependents();

  auto issue = [&](int i) {  // stage i's copies of w
    unsigned char* st = raw + (i % RING) * C::RAW;
    if constexpr (TMA) {  // thread 0: eight boxes, residue r's at tile rows 8r ..
      mbar_expect_tx(full + i % RING, C::RAW);
#pragma unroll
      for (int r = 0; r < 8; ++r)
        tma_load_2d(st + r * 8 * EW_WORDS * 16, &tw, full + i % RING, (r * N + n0) & ~7,
                    (kt0 + i) * (BK / 8));
    } else {
      const uintptr_t w_end = reinterpret_cast<uintptr_t>(w + (size_t)K * N);
      const int k0 = (kt0 + i) * BK;
      for (int c = tid; c < BK * EW_WORDS; c += 128) {
        const int r = c / EW_WORDS, j = c % EW_WORDS;
        if (k0 + r >= kend) continue;
        const uintptr_t a0 = align_down16(w + (size_t)(k0 + r) * N + n0), a = a0 + 16 * j;
        cp_async16(st + c * 16, reinterpret_cast<const void*>(a < w_end ? a : a0), a < w_end);
      }
    }
  };
  // thread t's x values: tile column idx % 64 of row idx / 64, idx = t + 128 j
  unsigned short xv[MP / 2];
  auto load_x = [&](int i) {
    const int k0 = (kt0 + i) * BK;
#pragma unroll
    for (int j = 0; j < MP / 2; ++j) {
      const int idx = tid + 128 * j, m = idx / BK, k = k0 + row_of(idx % BK);
      xv[j] = m < M && k < kend ? x[(size_t)m * K + k] : 0;
    }
  };

  float acc[NT][MP / 8][4];
#pragma unroll
  for (int a = 0; a < NT; ++a)
#pragma unroll
    for (int b = 0; b < MP / 8; ++b)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[a][b][e] = 0.0f;
  if (!TMA || tid == 0)
#pragma unroll
    for (int i = 0; i < RING - 1; ++i) {
      if (i < nk) issue(i);
      if (!TMA) cp_async_commit();
    }
  if (nk > 0) load_x(0);
  for (int i = 0; i < nk; ++i) {
    // the slot of stage i + RING - 1 held stage i - 1, which every thread has realigned
    if (TMA) {
      if (tid == 0 && i + RING - 1 < nk) issue(i + RING - 1);
      mbar_wait(full + i % RING, (i / RING) & 1);
    } else {
      if (i + RING - 1 < nk) issue(i + RING - 1);
      cp_async_commit();
      cp_async_wait<RING - 1>();  // this thread's words of stage i have landed
      __syncthreads();            // everyone's
    }
    const unsigned char* st = raw + (i % RING) * C::RAW;
    unsigned short* wt = reinterpret_cast<unsigned short*>(smem + (i % 2) * C::TILE);
    unsigned short* xt = wt + BK * EW_LD;
    const int k0 = (kt0 + i) * BK;
    {  // w: thread t realigns tile row t / 2, output words HW (t % 2) .. + HW - 1
      const int r = tid >> 1, h = tid & 1;
      uint4 o[HW];
      if (TMA || k0 + r < kend) {
        const unsigned sh =
            TMA ? 2u * static_cast<unsigned>(((r / 8) * N + n0) & 7)
                : static_cast<unsigned>(reinterpret_cast<uintptr_t>(w + (size_t)(k0 + r) * N + n0) &
                                        15);
        const uint4* src = reinterpret_cast<const uint4*>(st + r * EW_WORDS * 16) + HW * h;
        uint4 v[HW + 1];
#pragma unroll
        for (int q = 0; q <= HW; ++q) v[q] = src[q];
#pragma unroll
        for (int q = 0; q < HW; ++q) o[q] = shift16(v[q], v[q + 1], sh);
      } else {
#pragma unroll
        for (int q = 0; q < HW; ++q) o[q] = make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int q = 0; q < HW; ++q)
        *reinterpret_cast<uint4*>(wt + r * EW_LD + 8 * (HW * h + q)) = o[q];
    }
#pragma unroll
    for (int j = 0; j < MP / 2; ++j) {  // x's tile, its columns in the tile rows' order
      const int idx = tid + 128 * j;
      xt[(idx / BK) * EX_LD + idx % BK] = xv[j];
    }
    if (i + 1 < nk) load_x(i + 1);  // in flight during this stage's products
    __syncthreads();  // the tiles are whole; stage i - 1's products have read the other pair
    // out^T[n][m] += sum_k w^T[n][k] x^T[k][m]: lane l addresses row l % 8 of
    // matrix l / 8
    const int q = lane / 8, i8 = lane % 8;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t b[4];  // x^T fragments: b[2 mt], b[2 mt + 1] for m rows 8 mt ..
      if constexpr (MP == 16) {
        ldsm_x4(b, xt + (i8 + 8 * (q / 2)) * EX_LD + kk * 16 + 8 * (q % 2));
      } else {
        ldsm_x4(b, xt + i8 * EX_LD + kk * 16 + 8 * (q % 2));  // matrices 2, 3 repeat 0, 1
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        uint32_t a[4];  // w^T [16 n][16 k]: matrices (n 0-7 | 8-15) x (k 0-7 | 8-15)
        ldsm_x4_trans(a, wt + (kk * 16 + i8 + 8 * (q / 2)) * EW_LD + warp * (EBN_S / 4) +
                             nt * 16 + 8 * (q % 2));
#pragma unroll
        for (int mt = 0; mt < MP / 8; ++mt)
          mma_bf16_16816(acc[nt][mt], a, b[2 * mt], b[2 * mt + 1]);
      }
    }
  }
  if (!TMA) cp_async_wait<0>();
  __syncthreads();  // the raw ring is idle: stage the tile there

  // transpose into the tile [MP rows of out][128 columns]: c0, c1 = out^T[n][m, m + 1],
  // c2, c3 = out^T[n + 8][m, m + 1]
  float* stg = reinterpret_cast<float*>(raw);
  const int g = lane / 4, t4 = lane % 4;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int mt = 0; mt < MP / 8; ++mt) {
      const int n = warp * (EBN_S / 4) + nt * 16 + g, m = mt * 8 + 2 * t4;
      stg[m * C::LDC + n] = acc[nt][mt][0];
      stg[(m + 1) * C::LDC + n] = acc[nt][mt][1];
      stg[m * C::LDC + n + 8] = acc[nt][mt][2];
      stg[(m + 1) * C::LDC + n + 8] = acc[nt][mt][3];
    }
  __syncthreads();
  finish_scalar<MP, EBN_S, C::LDC, 128>(stg, out, ws, counters, flag, M, N, 0, n0, split,
                                        gridDim.y, blockIdx.x, act, out_f32, tid);
}

// ---- bf16 edge kernel for M > 16: realigned tiles on wgmma --------------------
//
// At prefill sizes (hymba's in_proj [M,1600]x[1600,6482], an untied unembed
// over a whole sequence) the edge case is bound by operations, as the
// aligned tile kernel is, but TMA cannot read w as a [K, N] tensor (16N
// bytes need not be a multiple of 16) and its rows start at every 2-byte
// offset.  A block of 512 threads owns a 128 x BN output tile (BN = 128,
// or 64 where 128-column tiles would fill no more than half the card) and
// runs three roles over 64-deep K slices, in rings with mbarrier full /
// empty pairs:
//   - copy (warp 8: w; warp 9: x): w's rows land in a raw ring laid out as
//     the streaming edge kernel's TMA boxes: with K a multiple of 8 and w
//     16-byte aligned, one thread issues boxes over w viewed as [K/8][8N]
//     superrows (8 superrows x BN + 8 values, one a residue r: its rows
//     k = 8i + r share one offset); otherwise the warp copies each row's
//     aligned superset by 16-byte cp.async to the same places.  x, with K a
//     multiple of 8 and x 16-byte aligned, comes as one TMA box a slice
//     straight into a ring of 128-byte swizzled A tiles (as mm_tile_kernel's);
//     otherwise each row's aligned superset (9 words) by cp.async into the
//     raw stage;
//   - realign (warps 10-15): each row of w is shifted by its offset
//     (shift16) and written, in K order, into a ring of B tiles wgmma reads:
//     [64 k][BN n] MN-major in 64-column atoms, 128-byte swizzled, as TMA
//     writes mm_tile_kernel's; raw rows of x likewise into the A tile.  A
//     thread's outputs are the same places every slice, worked out once;
//     neighbouring threads make neighbouring 16-byte outputs of a row, so
//     shared memory is read and written without bank conflicts.  Rows past
//     K or M and x values past K are written as zeros (what lies past N
//     reaches only discarded outputs).  Then fence.proxy.async and an
//     arrival;
//   - multiply (warpgroups 0 and 1, rows 0-63 and 64-127): wgmma.mma_async
//     m64nBNk16 from shared memory, B's transpose bit set, as mm_tile_kernel.
// Why wgmma works here where the streaming edge kernel chose mma.sync: a
// fence.proxy.async waits for the fencing thread's own cp.async copies in
// flight, and the threads that fence here (the realigners) copy nothing.
// 512 threads leave 128 registers a thread (ptxas compiles no region past
// the launch bound, whatever setmaxnreg would grant): room for a 64 x 128
// accumulator but not a running total beside it, so a block sums one of
// groups(N, K)'s groups, and K with more than one is split one group a
// block, the tile's last block adding them in order: a row's bits do not
// depend on M.  (Every served edge shape has one group.)  Ring depths: four
// A and four B tiles (with two B tiles the realigners waited on every
// slice's products), the raw ring the rest (five w stages at BN = 128); where
// x comes raw, three of each.  The tile leaves through mm_tile_kernel's f32
// staging in the idle rings: 16-byte stores where the output's rows are
// 16-byte aligned (finish_tile), else each row's own aligned 16-byte chunks
// (finish_unaligned).  What bounds it: shared memory's traffic, about
// 130 KB a 128 x 128 slice (w written raw, read and rewritten realigned, x
// written, A and B read by both warpgroups: the realigning pass takes about
// as long as the products and the copies' arrival), then the tile's
// staging and stores, which overlap nothing (edge_tile_probe.py times each;
// PERF.md).

constexpr int ET_BM = 128;            // output rows a block
constexpr int ET_XW = BK / 8 + 1;     // 16-byte words of an x row's aligned superset
constexpr int ET_THREADS = 512;       // multiply 0-255, copy 256-319, realign 320-511
constexpr int ET_REALIGNERS = 192;

// BN: the tile's columns (128, or 64 where 128-column tiles leave SMs idle)
template <int BN>
struct EdgeTileCfg {
  static constexpr int ROW_WORDS = BN / 8 + 1;          // a w row's aligned superset
  static constexpr int ROW_BYTES = ROW_WORDS * 16;      // a TMA box row (BN + 8 values)
  static constexpr int WO = BK * BN / 8;                // w's 16-byte outputs a stage
  static constexpr int WPT = (WO + ET_REALIGNERS - 1) / ET_REALIGNERS;  // a realigner's
  static constexpr int A_BYTES = ET_BM * BK * 2;
  static constexpr int B_BYTES = BK * BN * 2;
  static constexpr int RAW_W = BK * ROW_BYTES;          // 8 residues' boxes of 8 rows
  static constexpr int RAW_X = ET_BM * ET_XW * 16;      // x's rows where x comes raw
  // the A and B rings: 4 stages each where x comes by TMA (the realigners
  // run up to three stages ahead of the products; with two B stages they
  // waited on every stage's products), 3 where x comes raw (so that the raw
  // ring, which then holds x's rows too, keeps three stages); the raw ring
  // takes the rest
  static constexpr int MAX_AB = 4, MAX_RS = 8;
  static constexpr int BARS = 2 * (2 * MAX_AB + MAX_RS) * 8 + 16;  // and a flag
  static constexpr int BODY = 232448 - 1024 - BARS;
  static constexpr int SMEM = 1024 + BODY + BARS;
  static constexpr int LDC = BN + 8;  // f32 staging stride: conflict-free float2 writes
  static_assert(ET_BM * LDC * 4 <= 3 * (A_BYTES + B_BYTES), "the staged tile fits in the rings");
  static_assert(RAW_W % 128 == 0 && RAW_X % 128 == 0, "TMA boxes land 128-byte aligned");
  static_assert(BODY - 3 * (A_BYTES + B_BYTES) >= 3 * (RAW_W + RAW_X), "three raw stages");
};

// The end of an unsplit edge tile whose output rows are not 16-byte aligned:
// `stg` holds the f32 tile [ROWS][COLS] (row stride LDC) at rows m0..,
// columns n0...  Each row leaves in the 16-byte chunks of its own alignment
// (a partial chunk at either end stored value by value), each value read at
// its column: one wide store where finish_scalar makes 8 (bf16) or 4 (f32).
template <int ROWS, int COLS, int LDC, int NT>
__device__ __forceinline__ void finish_unaligned(const float* stg, void* out, int M, int N, int m0,
                                                 int n0, int act, int out_f32, int tid) {
  const int esz = out_f32 ? 4 : 2, vec = 16 / esz;
  const int chunks = COLS / vec + 1;  // a row's chunks, the partial ones at its ends
  for (int c = tid; c < ROWS * chunks; c += NT) {
    const int r = c / chunks, q = c % chunks, gr = m0 + r;
    if (gr >= M) continue;
    const size_t row0 = (size_t)gr * N + n0;  // (gr, n0)'s index in out
    const int a = static_cast<int>(((reinterpret_cast<uintptr_t>(out) + row0 * esz) & 15) / esz);
    const int col0 = q * vec - a;  // the chunk's first column of the tile
    float v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int col = col0 + e;
      v[e] = e < vec && col >= 0 && col < COLS && n0 + col < N
                 ? epilogue(stg[r * LDC + col], act) : 0.0f;
    }
    if (col0 >= 0 && col0 + vec <= COLS && n0 + col0 + vec <= N) {
      if (out_f32)
        *reinterpret_cast<float4*>(static_cast<float*>(out) + row0 + col0) =
            make_float4(v[0], v[1], v[2], v[3]);
      else
        store8(out, row0 + col0, v, 0);
    } else {
      for (int e = 0; e < vec; ++e) {
        const int col = col0 + e;
        if (col >= 0 && col < COLS && n0 + col < N) store_out(out, row0 + col, v[e], out_f32);
      }
    }
  }
}

// grid (N tiles, M tiles, splits); block (n, m, s) owns rows 128 m..,
// columns BN n.. and K slices [s group, (s+1) group): one group a block
// where K has more than one.  tma_x: x by TMA (tx in 128-row boxes, tx64
// in 64-row ones, valid), else its rows by cp.async; tma_w: w by superrow
// boxes (tw valid), else by cp.async.  A block whose rows past M leave 64
// or fewer (a few rows of x) copies and multiplies only those: the second
// warpgroup skips its products, and x comes in 64-row boxes (shared
// memory's traffic, which bounds a stage, falls by a quarter).
template <int BN>
__global__ void __launch_bounds__(ET_THREADS, 1)
    mm_edge_tile_kernel(const __grid_constant__ CUtensorMap tx,
                        const __grid_constant__ CUtensorMap tx64,
                        const __grid_constant__ CUtensorMap tw,
                        const unsigned short* __restrict__ x, const unsigned short* __restrict__ w,
                        void* __restrict__ out, float* __restrict__ ws,
                        int* __restrict__ counters, int M, int N, int K, int act, int out_f32,
                        int group, int tma_x, int tma_w, int vec_out) {
  using C = EdgeTileCfg<BN>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const int AS = tma_x ? C::MAX_AB : 3, BS = AS;
  const int raw_bytes = tma_x ? C::RAW_W : C::RAW_W + C::RAW_X;
  const int RS = min(C::MAX_RS, (C::BODY - AS * C::A_BYTES - BS * C::B_BYTES) / raw_bytes);
  unsigned char* b_ring = smem + AS * C::A_BYTES;
  unsigned char* raw = b_ring + BS * C::B_BYTES;
  uint64_t* a_full = reinterpret_cast<uint64_t*>(smem + C::BODY);
  uint64_t* a_empty = a_full + C::MAX_AB;
  uint64_t* b_full = a_empty + C::MAX_AB;
  uint64_t* b_empty = b_full + C::MAX_AB;
  uint64_t* raw_full = b_empty + C::MAX_AB;
  uint64_t* raw_empty = raw_full + C::MAX_RS;
  volatile int* flag = reinterpret_cast<volatile int*>(raw_empty + C::MAX_RS);

  const int m0 = blockIdx.y * ET_BM, n0 = blockIdx.x * BN, split = blockIdx.z;
  const int kt = (K + BK - 1) / BK;
  const int kt0 = split * group;
  const int nk = min(kt, kt0 + group) - kt0;
  const bool half = M - m0 <= 64;  // the block's rows fit the first warpgroup

  if (threadIdx.x == 0) {
    if (tma_x) prefetch_tensormap(half ? &tx64 : &tx);
    if (tma_w) prefetch_tensormap(&tw);
    for (int s = 0; s < AS; ++s) {
      mbar_init(a_full + s, tma_x ? 1 : ET_REALIGNERS);  // x's TMA bytes, or its realigners
      mbar_init(a_empty + s, 8);                          // lane 0 of each multiplying warp
      mbar_init(b_full + s, ET_REALIGNERS);
      mbar_init(b_empty + s, 8);
    }
    for (int s = 0; s < RS; ++s) {
      // w's TMA bytes or the w warp's cp.async arrivals, and the x warp's
      mbar_init(raw_full + s, (tma_w ? 1 : 32) + (tma_x ? 0 : 32));
      mbar_init(raw_empty + s, ET_REALIGNERS);
    }
    mbar_fence_init();
  }
  __syncthreads();
  grid_dependency_wait();  // the previous kernel on the stream is done with x, w, out
  launch_dependents();

  if (threadIdx.x >= 256 && threadIdx.x < 288) {  // copy w (warp 8)
    const int t = threadIdx.x - 256;
    if (tma_w && t != 0) return;
    const uintptr_t w_end = reinterpret_cast<uintptr_t>(w + (size_t)K * N);
    for (int i = 0; i < nk; ++i) {
      const int rs = i % RS, k0 = (kt0 + i) * BK;
      if (i >= RS) mbar_wait(raw_empty + rs, (i / RS - 1) & 1);
      unsigned char* rw = raw + rs * raw_bytes;
      if (tma_w) {  // box r: rows k0 + 8i' + r
        mbar_expect_tx(raw_full + rs, C::RAW_W);
#pragma unroll
        for (int r = 0; r < 8; ++r)
          tma_load_2d(rw + r * 8 * C::ROW_BYTES, &tw, raw_full + rs, (r * N + n0) & ~7, k0 / 8);
        continue;
      }
      // row k0 + kr's aligned superset, where its TMA box would put it
      for (int c = t; c < BK * C::ROW_WORDS; c += 32) {
        const int kr = c / C::ROW_WORDS, q = c % C::ROW_WORDS;
        if (k0 + kr >= K) continue;
        const uintptr_t a0 = align_down16(w + (size_t)(k0 + kr) * N + n0), a = a0 + 16 * q;
        cp_async16(rw + ((kr % 8) * 8 + kr / 8) * C::ROW_BYTES + 16 * q,
                   reinterpret_cast<const void*>(a < w_end ? a : a0), a < w_end);
      }
      cp_async_arrive(raw_full + rs);
    }
    return;
  }

  if (threadIdx.x >= 288 && threadIdx.x < 320) {  // copy x (warp 9)
    const int t = threadIdx.x - 288;
    if (tma_x) {  // x's boxes into the A ring, as far ahead as the ring allows
      if (t != 0) return;
      for (int i = 0; i < nk; ++i) {
        const int as = i % AS;
        if (i >= AS) mbar_wait(a_empty + as, (i / AS - 1) & 1);
        mbar_expect_tx(a_full + as, half ? C::A_BYTES / 2 : C::A_BYTES);
        tma_load_2d(smem + as * C::A_BYTES, half ? &tx64 : &tx, a_full + as, (kt0 + i) * BK, m0);
      }
      return;
    }
    const uintptr_t x_end = reinterpret_cast<uintptr_t>(x + (size_t)M * K);
    for (int i = 0; i < nk; ++i) {  // row m0 + r of x: its slice's aligned superset
      const int rs = i % RS, k0 = (kt0 + i) * BK;
      if (i >= RS) mbar_wait(raw_empty + rs, (i / RS - 1) & 1);
      unsigned char* rx = raw + rs * raw_bytes + C::RAW_W;
      for (int c = t; c < (half ? 64 : ET_BM) * ET_XW; c += 32) {
        const int r = c / ET_XW, q = c % ET_XW;
        if (m0 + r >= M) continue;
        const uintptr_t a0 = align_down16(x + (size_t)(m0 + r) * K + k0), a = a0 + 16 * q;
        cp_async16(rx + 16 * c, reinterpret_cast<const void*>(a < x_end ? a : a0), a < x_end);
      }
      cp_async_arrive(raw_full + rs);
    }
    return;
  }

  if (threadIdx.x >= 320) {  // realign
    // a thread's outputs of w are at the same places every stage (a row's
    // offset depends on k mod 8 alone, and a slice starts at a multiple of
    // 64): their raw and tile offsets and shifts are worked out once
    const int t = threadIdx.x - 320;
    int src[C::WPT], dst[C::WPT], row_of[C::WPT];
    unsigned sh[C::WPT];
#pragma unroll
    for (int u = 0; u < C::WPT; ++u) {
      const int c = t + u * ET_REALIGNERS, row = c / (BN / 8), j = c % (BN / 8);
      src[u] = ((row % 8) * 8 + row / 8) * C::ROW_BYTES + 16 * j;
      dst[u] = (j / 8) * BOX_BYTES + row * 128 + (((j % 8) ^ (row % 8)) << 4);
      row_of[u] = c < C::WO ? row : K;  // past the outputs: never inside K
      sh[u] = static_cast<unsigned>(reinterpret_cast<uintptr_t>(w + (size_t)row * N + n0) & 15);
    }
    for (int i = 0; i < nk; ++i) {
      const int rs = i % RS, as = i % AS, bs = i % BS, k0 = (kt0 + i) * BK;
      mbar_wait(raw_full + rs, (i / RS) & 1);
      if (i >= BS) mbar_wait(b_empty + bs, (i / BS - 1) & 1);
      const unsigned char* rw = raw + rs * raw_bytes;
      unsigned char* b_tile = b_ring + bs * C::B_BYTES;
      uint4 lo[C::WPT], hi[C::WPT];
#pragma unroll
      for (int u = 0; u < C::WPT; ++u) {  // w: loads first, then shifts and stores
        if (k0 + row_of[u] < K) {
          const uint4* p = reinterpret_cast<const uint4*>(rw + src[u]);
          lo[u] = p[0], hi[u] = p[1];
        } else {
          lo[u] = hi[u] = make_uint4(0u, 0u, 0u, 0u);
        }
      }
#pragma unroll
      for (int u = 0; u < C::WPT; ++u)
        if (t + u * ET_REALIGNERS < C::WO)
          *reinterpret_cast<uint4*>(b_tile + dst[u]) = shift16(lo[u], hi[u], sh[u]);
      if (!tma_x) {  // x: tile row c / 8, chunk c % 8, into the A ring
        if (i >= AS) mbar_wait(a_empty + as, (i / AS - 1) & 1);
        unsigned char* a_tile = smem + as * C::A_BYTES;
        for (int c = t; c < (half ? 64 : ET_BM) * 8; c += ET_REALIGNERS) {
          const int r = c / 8, q = c % 8, kc = k0 + 8 * q;
          uint4 o = make_uint4(0u, 0u, 0u, 0u);
          if (m0 + r < M && kc < K) {
            const uint4* p = reinterpret_cast<const uint4*>(rw + C::RAW_W) + r * ET_XW + q;
            o = shift16(p[0], p[1], static_cast<unsigned>(
                reinterpret_cast<uintptr_t>(x + (size_t)(m0 + r) * K + k0) & 15));
            if (kc + 8 > K) {  // zero the values past K (two a 32-bit lane)
              uint32_t h[4] = {o.x, o.y, o.z, o.w};
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                if (kc + 2 * e >= K) h[e] = 0u;
                else if (kc + 2 * e + 1 >= K) h[e] &= 0xffffu;
              }
              o = make_uint4(h[0], h[1], h[2], h[3]);
            }
          }
          *reinterpret_cast<uint4*>(a_tile + r * 128 + ((q ^ (r % 8)) << 4)) = o;
        }
      }
      fence_proxy_async();          // the tiles' writes, before the products read them
      mbar_arrive(raw_empty + rs);  // this thread's reads of the raw stage are done
      mbar_arrive(b_full + bs);
      if (!tma_x) mbar_arrive(a_full + as);
    }
    return;
  }

  // multiply: warpgroup wg, rows 64 wg ..; a block sums one group
  const int wg = threadIdx.x / 128;
  float acc[BN / 2];
#pragma unroll
  for (int j = 0; j < BN / 2; ++j) acc[j] = 0.0f;
  const bool idle = half && wg == 1;  // no rows of M: waits and releases alone
  for (int i = 0; i < nk && idle; ++i) {
    mbar_wait(a_full + i % AS, (i / AS) & 1);
    mbar_wait(b_full + i % BS, (i / BS) & 1);
    if (threadIdx.x % 32 == 0) {
      mbar_arrive(a_empty + i % AS);
      mbar_arrive(b_empty + i % BS);
    }
  }
  for (int i = 0; i < nk && !idle; ++i) {
    mbar_wait(a_full + i % AS, (i / AS) & 1);
    mbar_wait(b_full + i % BS, (i / BS) & 1);
    const uint64_t da = wgmma_desc(smem + (i % AS) * C::A_BYTES + wg * 64 * 128, 0, 1024);
    const uint64_t db = wgmma_desc(b_ring + (i % BS) * C::B_BYTES, BOX_BYTES, 1024);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) wgmma<BN, 0, 1>(acc, da + 2 * kk, db + 128 * kk, 1);
    wgmma_commit();
    wgmma_wait<1>();  // the previous stage's products are done: release its A and B
    fence_regs(acc);
    if (i > 0 && threadIdx.x % 32 == 0) {
      mbar_arrive(a_empty + (i - 1) % AS);
      mbar_arrive(b_empty + (i - 1) % BS);
    }
  }
  wgmma_wait<0>();
  fence_regs(acc);
  bar_sync_first<256>();  // every product has read the rings: stage the tile there

  float* stg = reinterpret_cast<float*>(smem);
  const int t = threadIdx.x % 128, row = wg * 64 + (t / 32) * 16 + (t % 32) / 4;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {  // (an idle warpgroup's rows lie past M)
    const int col = 8 * j + 2 * (t % 4);
    *reinterpret_cast<float2*>(stg + row * C::LDC + col) = make_float2(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<float2*>(stg + (row + 8) * C::LDC + col) =
        make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
  bar_sync_first<256>();
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  if (vec_out)
    finish_tile<ET_BM, BN, C::LDC, 256, 2, 2>(stg, out, ws, counters, flag, M, N, m0, n0, split,
                                             gridDim.z, tile, act, out_f32, threadIdx.x);
  else if (gridDim.z == 1)
    finish_unaligned<ET_BM, BN, C::LDC, 256>(stg, out, M, N, m0, n0, act, out_f32, threadIdx.x);
  else
    finish_scalar<ET_BM, BN, C::LDC, 256>(stg, out, ws, counters, flag, M, N, m0, n0, split,
                                          gridDim.z, tile, act, out_f32, threadIdx.x);
}

// ---- host side of the bf16 path ----------------------------------------------

template <typename Kernel>
cudaError_t allow_smem(Kernel k, int bytes) {
  return cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int BM, int BN>
cudaError_t launch_tile(const CUtensorMap& tx, const CUtensorMap& tw, void* out, float* ws,
                        int* counters, int M, int N, int K, int act, int out_f32, int splits,
                        int per, int group, cudaStream_t st) {
  using C = TileCfg<BM, BN>;
  static const cudaError_t set = allow_smem(mm_tile_kernel<BM, BN>, C::SMEM);
  if (set != cudaSuccess) return set;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  return launch_overlapped(mm_tile_kernel<BM, BN>, grid, C::THREADS, C::SMEM, st, tx, tw, out,
                           ws, counters, M, N, K, act, out_f32, per, group);
}

template <int MP>
cudaError_t launch_stream(const CUtensorMap& tx, const CUtensorMap& tw, void* out, float* ws,
                          int* counters, int M, int N, int K, int act, int out_f32, int splits,
                          int per, cudaStream_t st) {
  using C = StreamCfg<MP>;
  static const cudaError_t set = allow_smem(mm_stream_kernel<MP>, C::SMEM);
  if (set != cudaSuccess) return set;
  dim3 grid((N + STREAM_BN - 1) / STREAM_BN, splits);
  return launch_overlapped(mm_stream_kernel<MP>, grid, C::THREADS, C::SMEM, st, tx, tw, out, ws,
                           counters, M, N, K, act, out_f32, per);
}

template <int MP, bool TMA>
cudaError_t launch_edge_stream(const CUtensorMap& tw, const void* x, const void* w, void* out,
                               float* ws, int* counters, int M, int N, int K, int act,
                               int out_f32, int splits, int per, cudaStream_t st) {
  using C = EdgeCfg<MP>;
  static const cudaError_t set = allow_smem(mm_edge_stream_kernel<MP, TMA>, C::SMEM);
  if (set != cudaSuccess) return set;
  dim3 grid((N + EBN_S - 1) / EBN_S, splits);
  return launch_overlapped(mm_edge_stream_kernel<MP, TMA>, grid, 128, C::SMEM, st, tw,
                           static_cast<const unsigned short*>(x),
                           static_cast<const unsigned short*>(w), out, ws, counters, M, N, K, act,
                           out_f32, per);
}

template <int BN>
cudaError_t launch_edge_tile(const CUtensorMap& tx, const CUtensorMap& tx64,
                             const CUtensorMap& tw, const void* x, const void* w, void* out,
                             float* ws, int* counters, int M, int N, int K, int act, int out_f32,
                             int splits, int group, int tma_x, int tma_w, cudaStream_t st) {
  using C = EdgeTileCfg<BN>;
  static const cudaError_t set = allow_smem(mm_edge_tile_kernel<BN>, C::SMEM);
  if (set != cudaSuccess) return set;
  dim3 grid((N + BN - 1) / BN, (M + ET_BM - 1) / ET_BM, splits);
  const int vec_out = N % 8 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  return launch_overlapped(mm_edge_tile_kernel<BN>, grid, ET_THREADS, C::SMEM, st, tx, tx64, tw,
                           static_cast<const unsigned short*>(x),
                           static_cast<const unsigned short*>(w), out, ws, counters, M, N, K, act,
                           out_f32, group, tma_x, tma_w, vec_out);
}

template <int VEC, int B>
cudaError_t launch_f32(const void* x, const void* w, void* out, float* ws, int* counters, int M,
                       int N, int K, int act, int splits, int per, cudaStream_t st) {
  using C = F32Cfg<VEC, B, B>;
  static const cudaError_t set = allow_smem(mm_f32_kernel<VEC, B, B>, C::SMEM);
  if (set != cudaSuccess) return set;
  dim3 grid((N + B - 1) / B, (M + B - 1) / B, splits);
  const int vec_out = N % 8 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  return launch_overlapped(mm_f32_kernel<VEC, B, B>, grid, C::THREADS, C::SMEM, st,
                           static_cast<const float*>(x), static_cast<const float*>(w),
                           static_cast<float*>(out), ws, counters, M, N, K, act, per, vec_out);
}

template <int MP, bool TMA>
cudaError_t launch_f32_stream(const CUtensorMap& tw, const void* x, const void* w, void* out,
                              float* ws, int* counters, int M, int N, int K, int act, int splits,
                              int per, cudaStream_t st) {
  using C = F32StreamCfg<MP>;
  static const cudaError_t set = allow_smem(mm_f32_stream_kernel<MP, TMA>, C::SMEM);
  if (set != cudaSuccess) return set;
  dim3 grid((N + FSN - 1) / FSN, splits);
  return launch_overlapped(mm_f32_stream_kernel<MP, TMA>, grid, 128, C::SMEM, st, tw,
                           static_cast<const float*>(x), static_cast<const float*>(w),
                           static_cast<float*>(out), ws, counters, M, N, K, act, per);
}

}  // namespace

// x [M,K] bf16, w [K,N] bf16, out [M,N] bf16 (out_f32 = 0) or f32, all
// 16-byte aligned, K and N multiples of 8.  kernel 0: the tile kernel, a
// block_m x block_n block of 128 x 256, 128 x 128, 128 x 64 or 64 x 64;
// kernel 1: weight streaming, M <= block_m (8 or 16), block_n 128.  group:
// K slices of 64 a group (the sum order, kt = ceil(K / 64) slices in
// ceil(kt / group) groups, none empty); splits: 1, or one group a block
// (splits == ceil(kt / group)).  The streaming kernel and the 128 x 256
// tile take one group a block.  With splits > 1, ws holds splits * M * N
// floats and counters one zeroed int an output tile, used by no other
// stream.  One launch.  Returns a cudaError_t (0 on success).
extern "C" int repro_matmul(const void* x, const void* w, void* out, void* ws, void* counters,
                            int M, int N, int K, int act, int out_f32, int kernel, int block_m,
                            int block_n, int splits, int group, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 8 || N % 8 || splits < 1 || group < 1 || act < 0 ||
      act > 2)
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
       reinterpret_cast<uintptr_t>(out)) % 16)
    return (int)cudaErrorMisalignedAddress;
  const int kt = (K + BK - 1) / BK;
  group = group < kt ? group : kt;
  const int groups = (kt + group - 1) / group;
  const int per = splits == 1 ? kt : group;
  if ((splits > 1 && splits != groups) || (splits > 1 && (ws == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  const bool tile = kernel == 0 && ((block_m == 128 && (block_n == 128 || block_n == 256)) ||
                                    ((block_m == 64 || block_m == 128) && block_n == 64));
  const bool strm =
      kernel == 1 && block_n == STREAM_BN && M <= block_m && (block_m == 8 || block_m == 16);
  if (!tile && !strm) return (int)cudaErrorInvalidValue;
  // no running total in these: a block holds one group
  if ((strm || block_n == 256) && per != group) return (int)cudaErrorInvalidValue;
  CUtensorMap tx, tw;
  // x [M][K] in boxes of block_m rows of 64, w [K][N] in boxes of 64 rows
  if (!tensor_map(&tx, 2, x, K, M, 1, BK, block_m, CU_TENSOR_MAP_L2_PROMOTION_L2_256B) ||
      !tensor_map(&tw, 2, w, N, K, 1, BOX, BK, CU_TENSOR_MAP_L2_PROMOTION_L2_256B))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* wsf = static_cast<float*>(ws);
  int* cnt = static_cast<int*>(counters);
  if (tile) {
    const auto run = [&](auto launch) {
      return (int)launch(tx, tw, out, wsf, cnt, M, N, K, act, out_f32, splits, per, group, st);
    };
    if (block_m == 64) return run(launch_tile<64, 64>);
    switch (block_n) {
      case 64: return run(launch_tile<128, 64>);
      case 128: return run(launch_tile<128, 128>);
      default: return run(launch_tile<128, 256>);
    }
  }
  return (int)(block_m == 8
                   ? launch_stream<8>(tx, tw, out, wsf, cnt, M, N, K, act, out_f32, splits, per, st)
                   : launch_stream<16>(tx, tw, out, wsf, cnt, M, N, K, act, out_f32, splits, per, st));
}

// x [M,K] f32, w [K,N] f32, out [M,N] f32 (3xTF32), in block x block
// output tiles (64 or 128) on wgmma, or (block 0, M <= 16) streaming w in
// 64-column strips on mma.sync (its split's kt and counters likewise: 64-row
// slices, one counter a strip).  splits: K slices of 32 split so that none
// is empty (ceil(kt / ceil(kt / splits)) == splits, kt = ceil(K / 32)); with
// splits > 1, ws holds splits * M * N floats and counters one zeroed int an
// output tile, used by no other stream.  edge 0: K and N multiples of 4, x
// and w 16-byte aligned (16-byte copies of the tiles); edge 1: any K, N and
// 4-byte alignment.  One launch.  Returns the cudaError_t (0 on success).
extern "C" int repro_matmul_f32(const void* x, const void* w, void* out, void* ws, void* counters,
                                int M, int N, int K, int act, int edge, int block, int splits,
                                void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || splits < 1 || act < 0 || act > 2 ||
      (block != 0 && block != 64 && block != 128))
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
       reinterpret_cast<uintptr_t>(out)) % 4 ||
      (!edge && (K % 4 || N % 4 ||
                 (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w)) % 16)))
    return (int)cudaErrorMisalignedAddress;
  const int slice = block ? FBK : BK;  // K a stage
  const int kt = (K + slice - 1) / slice;
  const int per = (kt + splits - 1) / splits;
  if ((kt + per - 1) / per != splits || (splits > 1 && (ws == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* wsf = static_cast<float*>(ws);
  int* cnt = static_cast<int*>(counters);
  if (block == 0) {  // the streaming kernel, M <= 16
    if (M > 16) return (int)cudaErrorInvalidValue;
    CUtensorMap tw = {};
    const bool tma = K % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
    // w as [K/4][4N] superrows, in boxes of 16 superrows by a 64-column strip's
    // aligned superset (68 values)
    if (tma && !tensor_map(&tw, 2, w, 4 * (uint64_t)N, K / 4, 1, FS_ROW, 16,
                           CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_SWIZZLE_NONE,
                           CU_TENSOR_MAP_DATA_TYPE_FLOAT32))
      return (int)cudaErrorInvalidValue;
    if (M <= 8)
      return (int)(tma ? launch_f32_stream<8, true>(tw, x, w, out, wsf, cnt, M, N, K, act, splits,
                                                    per, st)
                       : launch_f32_stream<8, false>(tw, x, w, out, wsf, cnt, M, N, K, act,
                                                     splits, per, st));
    return (int)(tma ? launch_f32_stream<16, true>(tw, x, w, out, wsf, cnt, M, N, K, act, splits,
                                                   per, st)
                     : launch_f32_stream<16, false>(tw, x, w, out, wsf, cnt, M, N, K, act, splits,
                                                    per, st));
  }
  if (block == 64)
    return (int)(edge ? launch_f32<0, 64>(x, w, out, wsf, cnt, M, N, K, act, splits, per, st)
                      : launch_f32<1, 64>(x, w, out, wsf, cnt, M, N, K, act, splits, per, st));
  return (int)(edge ? launch_f32<0, 128>(x, w, out, wsf, cnt, M, N, K, act, splits, per, st)
                    : launch_f32<1, 128>(x, w, out, wsf, cnt, M, N, K, act, splits, per, st));
}

// x [M,K] bf16, w [K,N] bf16, out [M,N] bf16 (out_f32 = 0) or f32: any K and
// N, x and w 2-byte aligned (the edge kernels).  Kernels 0 and 3: the tile
// kernel (any M) on 128 x 128 and 128 x 64 tiles, K summed in groups of
// `group` 64-deep slices as repro_matmul's tile kernel sums them, one group
// a block (splits == ceil(kt / group), kt = ceil(K / 64)), each of x and w
// by TMA where K is a multiple of 8 and it is 16-byte aligned, else by
// cp.async.  Kernels 1
// and 2: M <= 16 (padded to 8 or 16), on 128-column strips with `splits` K
// splits of 64-row slices (none empty; group unused): 2 the TMA streaming
// kernel (K a multiple of 8, w 16-byte aligned), 1 the cp.async one.  With
// splits > 1, ws holds splits * M * N floats and counters one zeroed int an
// output tile (a strip), used by no other stream.  One launch.  Returns the
// cudaError_t (0 on success).
extern "C" int repro_matmul_edge(const void* x, const void* w, void* out, void* ws, void* counters,
                                 int M, int N, int K, int act, int out_f32, int kernel,
                                 int group, int splits, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || act < 0 || act > 2 || splits < 1 || kernel < 0 ||
      kernel > 3 || ((kernel == 1 || kernel == 2) && M > 16) ||
      (kernel == 2 && (K % 8 || reinterpret_cast<uintptr_t>(w) % 16)))
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w)) % 2 ||
      reinterpret_cast<uintptr_t>(out) % (out_f32 ? 4 : 2))
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* wsf = static_cast<float*>(ws);
  int* cnt = static_cast<int*>(counters);
  const int kt = (K + BK - 1) / BK;
  if (splits > 1 && (ws == nullptr || counters == nullptr)) return (int)cudaErrorInvalidValue;
  CUtensorMap tx = {}, tw = {};
  if (kernel == 0 || kernel == 3) {
    if (group < 1) return (int)cudaErrorInvalidValue;
    group = group < kt ? group : kt;
    if (splits != (kt + group - 1) / group) return (int)cudaErrorInvalidValue;
    const int tma_x = K % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
    const int tma_w = K % 8 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
    const int bn = kernel == 0 ? 128 : 64;
    // x [M][K] in 128-row boxes of 64, swizzled; w as [K/8][8N] superrows in
    // boxes of 8 superrows by bn + 8 values, unswizzled
    CUtensorMap tx64 = {};
    if ((tma_x && !tensor_map(&tx, 2, x, K, M, 1, BK, ET_BM, CU_TENSOR_MAP_L2_PROMOTION_L2_256B)) ||
        (tma_x && !tensor_map(&tx64, 2, x, K, M, 1, BK, 64, CU_TENSOR_MAP_L2_PROMOTION_L2_256B)) ||
        (tma_w && !tensor_map(&tw, 2, w, 8 * (uint64_t)N, K / 8, 1, bn + 8, 8,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_SWIZZLE_NONE)))
      return (int)cudaErrorInvalidValue;
    return (int)(kernel == 0
                     ? launch_edge_tile<128>(tx, tx64, tw, x, w, out, wsf, cnt, M, N, K, act,
                                             out_f32, splits, group, tma_x, tma_w, st)
                     : launch_edge_tile<64>(tx, tx64, tw, x, w, out, wsf, cnt, M, N, K, act,
                                            out_f32, splits, group, tma_x, tma_w, st));
  }
  const int per = (kt + splits - 1) / splits;
  if ((kt + per - 1) / per != splits) return (int)cudaErrorInvalidValue;
  if (kernel == 2) {
    // w as [K/8][8N] superrows, in boxes of 8 superrows by a 128-column strip's
    // aligned superset (136 values)
    if (!tensor_map(&tw, 2, w, 8 * (uint64_t)N, K / 8, 1, 8 * EW_WORDS, 8,
                    CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_SWIZZLE_NONE))
      return (int)cudaErrorInvalidValue;
    return (int)(M <= 8 ? launch_edge_stream<8, true>(tw, x, w, out, wsf, cnt, M, N, K, act,
                                                      out_f32, splits, per, st)
                        : launch_edge_stream<16, true>(tw, x, w, out, wsf, cnt, M, N, K, act,
                                                       out_f32, splits, per, st));
  }
  return (int)(M <= 8 ? launch_edge_stream<8, false>(tw, x, w, out, wsf, cnt, M, N, K, act,
                                                     out_f32, splits, per, st)
                      : launch_edge_stream<16, false>(tw, x, w, out, wsf, cnt, M, N, K, act,
                                                      out_f32, splits, per, st));
}
