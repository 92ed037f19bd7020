// bf16 matmul for Hopper: out[M,N] = epilogue(x[M,K] @ w[K,N]), and its
// f32 path.
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
// Both kernels split K across blocks where the output tiles alone cannot
// fill the card.  The partials are summed in the same launch: each split
// writes its f32 tile to a workspace, and the block that arrives last at
// the tile's counter sums the splits in split order 0..s-1 (so the result
// depends on the shape alone, never on timing), applies the epilogue,
// stores, and resets the counter to 0 for the next launch on the stream.
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
// kernel (mm_edge_kernel, repro_matmul_edge: guarded loads, mma.sync).
//
// The f32 path (repro_matmul_f32: f32 x and w, f32 out) computes in full f32
// on the CUDA cores, as the Pallas kernel does for f32 inputs: not TF32, whose
// 10-bit mantissa misses the 2e-4 the JAX package's own test holds at K = 256.
// A block owns a 64x64 tile; 256 threads each accumulate a 4x4 register block
// with FMAs over a two-stage cp.async ring of 64x16 A and 16x64 B tiles in
// shared memory.  Ragged M, N and K are zero-filled on load (16-byte loads
// for K and N multiples of 4 and aligned operands, guarded 4-byte loads in
// the edge instance otherwise); where the tiles are too few for the card,
// K is split across blocks and a second kernel sums the splits in a fixed
// order.  What bounds it: operations at the f32 rate (67 TFLOP/s) once the
// tiles fill the card; at the paper's 256 x 256 x 256 the launch.
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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int n = valid ? 16 : 0;  // 0: fill the 16 bytes with zeros, read nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
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
// BM m.., columns BN n.. and K slices [s per_split, (s+1) per_split).
template <int BM, int BN>
__global__ void __launch_bounds__(TileCfg<BM, BN>::THREADS, 1)
    mm_tile_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
                   void* __restrict__ out, float* __restrict__ ws, int* __restrict__ counters,
                   int M, int N, int K, int act, int out_f32, int per_split) {
  using C = TileCfg<BM, BN>;
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
    float acc[BN / 2];
#pragma unroll
    for (int j = 0; j < BN / 2; ++j) acc[j] = 0.0f;
    for (int i = 0; i < nk; ++i) {
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
      if (i > 0 && threadIdx.x % 32 == 0) mbar_arrive(empty + (i - 1) % C::STAGES);
    }
    wgmma_wait<0>();
    fence_regs(acc);
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

__global__ void splitk_reduce(const float* __restrict__ ws, void* __restrict__ out, int M, int N,
                              int splits, int act, int out_f32) {
  size_t total = (size_t)M * N;
  size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float v = 0.0f;
  for (int s = 0; s < splits; ++s) v += ws[s * total + i];
  store_out(out, i, epilogue(v, act), out_f32);
}

// ---- f32 path -------------------------------------------------------------

constexpr int FBM = 64, FBN = 64, FBK = 16, FTHREADS = 256;
constexpr int FLDA = FBK + 4;  // smem row strides (floats), padded, rows 16-byte aligned
constexpr int FLDB = FBN + 4;
constexpr int FA_STAGE = FBM * FLDA;
constexpr int FB_STAGE = FBK * FLDB;

// Four floats at (gr, gc..gc+3) of the [R, C] tensor p into smem, zero
// past its edge: one 16-byte cp.async (kVec: C a multiple of 4 and p
// 16-byte aligned), else four guarded 4-byte loads (the edge kernel).
template <bool kVec>
__device__ __forceinline__ void load4_f32(float* dst, const float* p, int R, int C, int gr,
                                          int gc) {
  if constexpr (kVec) {
    const bool ok = gr < R && gc < C;
    cp_async16(dst, ok ? p + (size_t)gr * C + gc : p, ok);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      dst[j] = gr < R && gc + j < C ? p[(size_t)gr * C + gc + j] : 0.0f;
  }
}

template <bool kVec>
__device__ __forceinline__ void load_tile_f32(float* as, float* bs, const float* x, const float* w,
                                              int M, int N, int K, int m0, int n0, int k0) {
  {  // A: 64 rows x 16 k = 256 chunks of 4 floats, one a thread
    int c = threadIdx.x, r = c / (FBK / 4), col = (c % (FBK / 4)) * 4;
    load4_f32<kVec>(as + r * FLDA + col, x, M, K, m0 + r, k0 + col);
  }
  {  // B: 16 k x 64 cols = 256 chunks
    int c = threadIdx.x, r = c / (FBN / 4), col = (c % (FBN / 4)) * 4;
    load4_f32<kVec>(bs + r * FLDB + col, w, K, N, k0 + r, n0 + col);
  }
}

// kVec false: the edge instance, for K or N not a multiple of 4 or an
// operand not 16-byte aligned (guarded 4-byte loads; the rest unchanged)
template <bool kVec>
__global__ void __launch_bounds__(FTHREADS)
    mm_f32_kernel(const float* __restrict__ x, const float* __restrict__ w, float* __restrict__ out,
                  float* __restrict__ ws, int M, int N, int K, int act, int per_split) {
  __shared__ __align__(16) float as[2 * FA_STAGE];
  __shared__ __align__(16) float bs[2 * FB_STAGE];
  const int m0 = blockIdx.y * FBM, n0 = blockIdx.x * FBN, split = blockIdx.z;
  const int kt = (K + FBK - 1) / FBK;
  const int kt0 = split * per_split;
  const int nk = min(kt, kt0 + per_split) - kt0;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;  // 4x4 block at (ty*4, tx*4)

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  if (nk > 0) load_tile_f32<kVec>(as, bs, x, w, M, N, K, m0, n0, kt0 * FBK);
  cp_async_commit();
  for (int t = 0; t < nk; ++t) {
    const int cur = t & 1;
    if (t + 1 < nk)
      load_tile_f32<kVec>(as + (cur ^ 1) * FA_STAGE, bs + (cur ^ 1) * FB_STAGE, x, w, M, N, K,
                          m0, n0, (kt0 + t + 1) * FBK);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* a_t = as + cur * FA_STAGE + ty * 4 * FLDA;
    const float* b_t = bs + cur * FB_STAGE + tx * 4;
#pragma unroll
    for (int kk = 0; kk < FBK; ++kk) {
      const float4 b = *reinterpret_cast<const float4*>(b_t + kk * FLDB);
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float a = a_t[i * FLDA + kk];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a, bv[j], acc[i][j]);
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gr = m0 + ty * 4 + i;
    if (gr >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gc = n0 + tx * 4 + j;
      if (gc >= N) continue;
      if (ws != nullptr)
        ws[((size_t)split * M + gr) * N + gc] = acc[i][j];
      else
        out[(size_t)gr * N + gc] = epilogue(acc[i][j], act);
    }
  }
}


// ---- bf16 edge kernel: any K and N, any operand alignment --------------------
//
// TMA needs 16-byte global strides and bases, so a [4096, 49155] weight (a
// 98,310-byte row) cannot be its source as stored, and padding a copy each
// call would move the whole weight again.  This kernel loads with plain
// guarded 2-byte loads instead (a row of an odd width is 2-byte aligned
// only) and multiplies on mma.sync m16n8k16, bf16 in, f32 accumulate.  A
// block of four warps owns a 32 x 128 output tile and walks K in 32-deep
// slices: thread t loads column n0 + t of w (32 rows; a warp's loads of one
// row are 64 contiguous bytes) and 8 values of x into registers for the
// next slice while the warps multiply the current one from shared memory,
// where w is stored transposed ([n][k]) so that a B fragment is one 32-bit
// read.  Warp w computes all 32 rows x columns 32w..32w+31.  Bound at the
// untied unembeds' decode shapes by the bytes of w; simple first, with its
// times in PERF.md.

constexpr int EBM = 32, EBN = 128, EBK = 32, ETHREADS = 128;
constexpr int ELD = EBK + 8;  // smem row stride (bf16) of xs and wt: 80-byte rows

__global__ void __launch_bounds__(ETHREADS)
    mm_edge_kernel(const unsigned short* __restrict__ x, const unsigned short* __restrict__ w,
                   void* __restrict__ out, int M, int N, int K, int act, int out_f32) {
  __shared__ __align__(16) unsigned short xs[EBM * ELD];
  __shared__ __align__(16) unsigned short wt[EBN * ELD];
  const int m0 = blockIdx.y * EBM, n0 = blockIdx.x * EBN;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int gn = n0 + tid;

  uint32_t wr[EBK / 2];   // the next slice's w column, rows in pairs
  unsigned short xr[EBM * EBK / ETHREADS];
  auto load = [&](int k0) {
#pragma unroll
    for (int r = 0; r < EBK; r += 2) {
      unsigned short lo = 0, hi = 0;
      if (gn < N) {
        if (k0 + r < K) lo = w[(size_t)(k0 + r) * N + gn];
        if (k0 + r + 1 < K) hi = w[(size_t)(k0 + r + 1) * N + gn];
      }
      wr[r / 2] = pack_raw(lo, hi);
    }
#pragma unroll
    for (int i = 0; i < EBM * EBK / ETHREADS; ++i) {
      const int e = tid + i * ETHREADS, gr = m0 + e / EBK, gc = k0 + e % EBK;
      xr[i] = gr < M && gc < K ? x[(size_t)gr * K + gc] : 0;
    }
  };

  float acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;

  grid_dependency_wait();  // the previous kernel on the stream is done with x, w, out
  launch_dependents();
  const int nk = (K + EBK - 1) / EBK;
  load(0);
  for (int kt = 0; kt < nk; ++kt) {
    __syncthreads();  // the previous slice's products have read xs and wt
    uint4* wdst = reinterpret_cast<uint4*>(wt + tid * ELD);
#pragma unroll
    for (int q = 0; q < EBK / 8; ++q)
      wdst[q] = make_uint4(wr[4 * q], wr[4 * q + 1], wr[4 * q + 2], wr[4 * q + 3]);
#pragma unroll
    for (int i = 0; i < EBM * EBK / ETHREADS; ++i) {
      const int e = tid + i * ETHREADS;
      xs[(e / EBK) * ELD + e % EBK] = xr[i];
    }
    __syncthreads();
    if (kt + 1 < nk) load((kt + 1) * EBK);  // in flight during the products
#pragma unroll
    for (int kk = 0; kk < EBK / 16; ++kk) {
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const unsigned short* r0 = xs + (mt * 16 + g) * ELD + kk * 16 + 2 * t;
        a[mt][0] = *reinterpret_cast<const uint32_t*>(r0);
        a[mt][1] = *reinterpret_cast<const uint32_t*>(r0 + 8 * ELD);
        a[mt][2] = *reinterpret_cast<const uint32_t*>(r0 + 8);
        a[mt][3] = *reinterpret_cast<const uint32_t*>(r0 + 8 * ELD + 8);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const unsigned short* c0 = wt + (warp * 32 + nt * 8 + g) * ELD + kk * 16 + 2 * t;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(c0);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(c0 + 8);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) mma_bf16_16816(acc[mt][nt], a[mt], b0, b1);
      }
    }
  }

#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = m0 + mt * 16 + g + (e >> 1) * 8;
        const int col = n0 + warp * 32 + nt * 8 + 2 * t + (e & 1);
        if (row < M && col < N)
          store_out(out, (size_t)row * N + col, epilogue(acc[mt][nt][e], act), out_f32);
      }
}

// ---- host side of the bf16 path ----------------------------------------------

template <typename Kernel>
cudaError_t allow_smem(Kernel k, int bytes) {
  return cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int BM, int BN>
cudaError_t launch_tile(const CUtensorMap& tx, const CUtensorMap& tw, void* out, float* ws,
                        int* counters, int M, int N, int K, int act, int out_f32, int splits,
                        int per, cudaStream_t st) {
  using C = TileCfg<BM, BN>;
  static const cudaError_t set = allow_smem(mm_tile_kernel<BM, BN>, C::SMEM);
  if (set != cudaSuccess) return set;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  return launch_overlapped(mm_tile_kernel<BM, BN>, grid, C::THREADS, C::SMEM, st, tx, tw, out,
                           ws, counters, M, N, K, act, out_f32, per);
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

}  // namespace

// x [M,K] bf16, w [K,N] bf16, out [M,N] bf16 (out_f32 = 0) or f32, all
// 16-byte aligned, K and N multiples of 8.  kernel 0: the tile kernel, a
// block_m x block_n block of 128 x 256, 128 x 128, 128 x 64 or 64 x 64;
// kernel 1: weight streaming, M <= block_m (8 or 16), block_n 128.  splits:
// K slices of 64 split so that none is empty (ceil(kt / ceil(kt / splits))
// == splits, kt = ceil(K / 64)).  With splits > 1, ws holds splits * M * N
// floats and counters one zeroed int an output tile, used by no other
// stream.  One launch.  Returns a cudaError_t (0 on
// success).
extern "C" int repro_matmul(const void* x, const void* w, void* out, void* ws, void* counters,
                            int M, int N, int K, int act, int out_f32, int kernel, int block_m,
                            int block_n, int splits, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 8 || N % 8 || splits < 1 || act < 0 || act > 2)
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
       reinterpret_cast<uintptr_t>(out)) % 16)
    return (int)cudaErrorMisalignedAddress;
  const int kt = (K + BK - 1) / BK;
  const int per = (kt + splits - 1) / splits;
  if ((kt + per - 1) / per != splits || (splits > 1 && (ws == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  const bool tile = kernel == 0 && ((block_m == 128 && (block_n == 128 || block_n == 256)) ||
                                    ((block_m == 64 || block_m == 128) && block_n == 64));
  const bool strm =
      kernel == 1 && block_n == STREAM_BN && M <= block_m && (block_m == 8 || block_m == 16);
  if (!tile && !strm) return (int)cudaErrorInvalidValue;
  CUtensorMap tx, tw;
  // x [M][K] in boxes of block_m rows of 64, w [K][N] in boxes of 64 rows
  if (!tensor_map(&tx, 2, x, K, M, 1, BK, block_m, CU_TENSOR_MAP_L2_PROMOTION_L2_256B) ||
      !tensor_map(&tw, 2, w, N, K, 1, BOX, BK, CU_TENSOR_MAP_L2_PROMOTION_L2_256B))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* wsf = static_cast<float*>(ws);
  int* cnt = static_cast<int*>(counters);
  if (tile) {
    if (block_m == 64)
      return (int)launch_tile<64, 64>(tx, tw, out, wsf, cnt, M, N, K, act, out_f32, splits, per, st);
    switch (block_n) {
      case 64: return (int)launch_tile<128, 64>(tx, tw, out, wsf, cnt, M, N, K, act, out_f32, splits, per, st);
      case 128: return (int)launch_tile<128, 128>(tx, tw, out, wsf, cnt, M, N, K, act, out_f32, splits, per, st);
      default: return (int)launch_tile<128, 256>(tx, tw, out, wsf, cnt, M, N, K, act, out_f32, splits, per, st);
    }
  }
  return (int)(block_m == 8
                   ? launch_stream<8>(tx, tw, out, wsf, cnt, M, N, K, act, out_f32, splits, per, st)
                   : launch_stream<16>(tx, tw, out, wsf, cnt, M, N, K, act, out_f32, splits, per, st));
}

// x [M,K] f32, w [K,N] f32, out [M,N] f32; ws holds splits*M*N floats when
// splits > 1, with ceil(kt / ceil(kt / splits)) == splits for kt = ceil(K / 16).
// edge 0: K and N multiples of 4, x and w 16-byte aligned (16-byte cp.async
// loads); edge 1: any K, N and alignment (guarded 4-byte loads).  Returns
// the cudaError_t of the launches (0 on success).
extern "C" int repro_matmul_f32(const void* x, const void* w, void* out, void* ws, int M, int N,
                                int K, int act, int splits, int edge, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || splits < 1 || act < 0 || act > 2)
    return (int)cudaErrorInvalidValue;
  if (!edge && (K % 4 || N % 4 ||
                (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w)) % 16))
    return (int)cudaErrorInvalidValue;
  const int kt = (K + FBK - 1) / FBK;
  const int per = (kt + splits - 1) / splits;
  if ((kt + per - 1) / per != splits || (splits > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid((N + FBN - 1) / FBN, (M + FBM - 1) / FBM, splits);
  auto kernel = edge ? mm_f32_kernel<false> : mm_f32_kernel<true>;
  kernel<<<grid, FTHREADS, 0, st>>>(static_cast<const float*>(x), static_cast<const float*>(w),
                                    static_cast<float*>(out),
                                    splits > 1 ? static_cast<float*>(ws) : nullptr, M, N, K, act,
                                    per);
  if (splits > 1) {
    size_t total = (size_t)M * N;
    unsigned blocks = (unsigned)((total + 255) / 256);
    splitk_reduce<<<blocks, 256, 0, st>>>(static_cast<const float*>(ws), out, M, N, splits, act,
                                          1);
  }
  return (int)cudaGetLastError();
}

// x [M,K] bf16, w [K,N] bf16, out [M,N] bf16 (out_f32 = 0) or f32: any K and
// N, x and w 2-byte aligned (the edge kernel; out as the caller allocates
// it).  One launch.  Returns the cudaError_t (0 on success).
extern "C" int repro_matmul_edge(const void* x, const void* w, void* out, int M, int N, int K,
                                 int act, int out_f32, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || act < 0 || act > 2) return (int)cudaErrorInvalidValue;
  dim3 grid((N + EBN - 1) / EBN, (M + EBM - 1) / EBM);
  return (int)launch_overlapped(mm_edge_kernel, grid, ETHREADS, 0,
                                static_cast<cudaStream_t>(stream),
                                static_cast<const unsigned short*>(x),
                                static_cast<const unsigned short*>(w), out, M, N, K, act, out_f32);
}
