// Flash attention for Hopper: online-softmax attention of q [B,Hq,S,d] over
// k, v [B,Hkv,T,d] (bf16, d a multiple of 16 from 16 to 128), GQA head h
// reading kv head h / (Hq/Hkv).  Two instances, D = 64 and 128, take every
// d up to their own: the tensor maps span the true d, so a 64-wide TMA box
// reads zeros in columns d..D-1 of Q, K and V (their products add nothing,
// and the output's padded columns are never stored), and the wrapper passes
// the softmax scale of the true d.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py::
// flash_attention (_fa_kernel).  The TPU carried the running max,
// denominator and accumulator in VMEM across a sequential KV grid axis;
// here a block owns 64 query rows of one head and loops over key tiles
// itself (128 keys at D = 64, 64 at D = 128, as the registers of the S and
// O accumulators allow), keeping that state in registers.  A block is one
// consumer warpgroup (threads 0-127) and one producer warp (128-159):
//   - the producer issues TMA loads: Q's tile once, then K and V tiles into
//     a ring of 3 stages at D = 64 (2 at D = 128), K and V each tracked by
//     full/empty mbarriers, so the next tiles arrive while this one is
//     multiplied and K's slot frees as soon as S has read it.  The
//     tiles are 128-byte swizzled boxes of 64 values a row (D = 128: two
//     boxes side by side), read through 3-D tensor maps over [B*H, T, D], so
//     rows past T (or S) read zeros and never a neighbouring head's rows;
//   - S = Q K^T is wgmma m64nBKk16 from shared memory, Q and K both K-major
//     (SBO 1024; the k16 slice kk starts 32 (kk % 4) bytes into a row of box
//     kk / 4);
//   - O += P V is wgmma m64nDk16 with P from registers: the f32 S
//     accumulator of each k16 slice of keys re-packed as bf16 A fragments
//     (hopper.cuh), and V an MN-major B operand (transpose bit; SBO 1024,
//     LBO the 8 KB between the two 64-wide boxes at D = 128, k16 steps of
//     2 KB).  P is rounded to bf16 for that product (the one place the
//     arithmetic differs from the f32 Pallas kernel), while the denominator
//     sums the f32 probabilities;
//   - masks match the Pallas kernel: causal and window masks at -1e30 with
//     queries aligned to the end of the keys (kv_offset = T - S), and a
//     non-causal mode; tiles no row of the block sees are never loaded; the
//     softmax runs in base 2 on the special-function unit (the scale folded
//     with log2 e); l == 0 is guarded at the end.
// Key groups: a query row's keys are summed in a fixed order that depends on
// the key index alone, never on S, B or the grid.  The keys fall into groups
// of GROUP_KEYS; a row's online softmax runs over each group's tiles from
// fresh (m, l, O), and the groups' states are folded in key order into a
// running (M, L, A) by one function (`fold`, rounding pinned: no
// contraction).  A tile or a group that a row cannot see is an exact no-op
// for it (its probabilities are exp2(-1e30 - m) = 0, its correction 1), so a
// chunk's query rows, whatever their offset in a q tile, give the whole
// prompt's rows bit for bit.
// Split-KV: where the (q tile, head) blocks alone would leave SMs idle, the
// wrapper splits each q tile's groups over `splits` blocks (whole groups a
// block).  A split block writes each of its groups' (m, l, unnormalised O)
// in f32 to a workspace; the block that arrives last at the tile's counter
// (an acq_rel atomic; one counter buffer per CUDA stream, left zeroed) folds
// the groups in key order and stores, so the split changes the time, never
// a bit, and the work is one launch.  Unsplit, a block folds each group as it
// ends.  Blocks of causal q tiles that see the most keys start first (the q
// tile index runs backwards over the grid), and the kernel is a programmatic
// dependent launch.
// Bound on the H100: operations at the serve runs' lengths, but at these
// sizes (S = T = 512: 1.1 GFLOP, 1.1 us at the bf16 rate) a block's serial
// walk over its key tiles and the card's fill set the time, which is what
// the ring, the split and the heavy-first order are for.
#include <cuda_bf16.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int BQ = 64;               // query rows a block: one consumer warpgroup
constexpr int BOX = 64;              // head-dim values a TMA box (128 bytes)
constexpr int Q_BOX_BYTES = BQ * 128;
constexpr int THREADS = 160;         // the consumer warpgroup, then the producer warp
constexpr float LOG2E = 1.4426950408889634f;
constexpr int GROUP_KEYS = 512;      // keys a group: the fixed order of a row's sum

template <int D>
struct FaCfg {
  static constexpr int BK = D == 64 ? 128 : 64;   // keys a tile
  static constexpr int TPG = GROUP_KEYS / BK;     // key tiles a group
  static constexpr int BOXES = D / BOX;           // 1 or 2 boxes a row
  static constexpr int KV_BOX_BYTES = BK * 128;
  static constexpr int Q_BYTES = BOXES * Q_BOX_BYTES;
  static constexpr int TILE_BYTES = BOXES * KV_BOX_BYTES;  // K or V of one tile
  static constexpr int STAGE_BYTES = 2 * TILE_BYTES;       // K then V
  static constexpr int STAGES = D == 64 ? 3 : 2;
  static constexpr int BODY = Q_BYTES + STAGES * STAGE_BYTES;
  // 1 KB of alignment slack, Q and the ring, 4 mbarriers a stage (K and V
  // each full and empty) and Q's, a flag
  static constexpr int SMEM = 1024 + BODY + (4 * STAGES + 1) * 8 + 16;
  // 105 KB or 81 KB: two blocks an SM
  static constexpr int MIN_BLOCKS = 2;
};

// Fold one key group's softmax state (m, l) and unnormalised O of a
// thread's two rows into the running (M, L, A): M' = max(M, m), L' = L
// 2^(M-M') + l 2^(m-M'), and A likewise, element j of O read as o(j).  The
// one place groups meet, whichever memory holds them, with the roundings
// spelled out.  FRESH: A holds nothing yet and is taken as 0 (+0.0f, as a
// zeroed A holds), so A may be the very registers o reads.
template <int D, bool FRESH = false, typename O>
__device__ __forceinline__ void fold(float (&M)[2], float (&L)[2], float (&A)[D / 2],
                                     const float (&m)[2], const float (&l)[2], O o) {
  float fa[2], fb[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float mn = fmaxf(M[r], m[r]);
    fa[r] = ex2(M[r] - mn);
    fb[r] = ex2(m[r] - mn);
    M[r] = mn;
    L[r] = __fmaf_rn(L[r], fa[r], __fmul_rn(l[r], fb[r]));
  }
#pragma unroll
  for (int j = 0; j < D / 2; ++j) {
    const int r = (j % 4) / 2;  // registers 4i, 4i+1: row r0; 4i+2, 4i+3: row r0 + 8
    const float v = o(j);
    A[j] = __fmaf_rn(FRESH ? 0.0f : A[j], fa[r], __fmul_rn(v, fb[r]));
  }
}

// grid (Hq * splits, q tiles, B): block (h + Hq * split, y, b) owns query
// rows 64 qt.. of head h, qt = q tiles - 1 - y, and its split's share of the
// q tile's key groups.  With splits > 1, ws holds groups x [B*Hq, 64 q
// tiles, D] f32 partials, then groups x [B*Hq, 64 q tiles, 2] (m, l), groups
// = ceil(ceil(T / BK) / TPG); counters one zeroed int a (b, h, q tile).
template <int D>
__global__ void __launch_bounds__(THREADS, FaCfg<D>::MIN_BLOCKS)
    fa_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
              const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
              float* __restrict__ ws, int* __restrict__ counters, int Hq, int Hkv, int S, int T,
              int d, float scale_log2, int causal, int window, int splits) {
  using C = FaCfg<D>;
  constexpr int BK = C::BK;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* qs = smem;
  unsigned char* ring = smem + C::Q_BYTES;
  uint64_t* full_k = reinterpret_cast<uint64_t*>(smem + C::BODY);
  uint64_t* full_v = full_k + C::STAGES;
  uint64_t* empty_k = full_v + C::STAGES;
  uint64_t* empty_v = empty_k + C::STAGES;
  uint64_t* qbar = empty_v + C::STAGES;
  volatile int* flag = reinterpret_cast<volatile int*>(qbar + 1);

  const int h = blockIdx.x % Hq, split = blockIdx.x / Hq;
  const int n_qt = gridDim.y, qt = n_qt - 1 - blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int q0 = qt * BQ, kv_offset = T - S;
  const int q_first = q0 + kv_offset;                   // block's first query position
  const int q_last = min(q0 + BQ, S) - 1 + kv_offset;  // block's last real query position
  // the key tiles some row of the block sees, [lo, hi), their groups [g_lo,
  // g_hi), and this split's share: whole groups, their tiles [t0, t0 + n)
  constexpr int TPG = C::TPG;
  const int kt = (T + BK - 1) / BK;
  const int hi = causal ? min(kt, q_last / BK + 1) : kt;
  const int lo = window > 0 ? max(0, q_first - window + 1) / BK : 0;
  const int g_lo = lo / TPG, g_hi = (hi + TPG - 1) / TPG;
  const int per = (g_hi - g_lo + splits - 1) / splits;
  const int ga = min(g_hi, g_lo + split * per), gb = min(g_hi, ga + per);
  const int t0 = max(lo, ga * TPG), n = max(0, min(hi, gb * TPG) - t0);

  if (threadIdx.x == 0) {
    prefetch_tensormap(&tq);
    prefetch_tensormap(&tk);
    prefetch_tensormap(&tv);
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(full_k + s, 1);
      mbar_init(full_v + s, 1);
      mbar_init(empty_k + s, 4);  // lane 0 of each consumer warp
      mbar_init(empty_v + s, 4);
    }
    mbar_init(qbar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  grid_dependency_wait();  // the previous kernel on the stream is done with q, k, v, o, ws
  launch_dependents();

  if (threadIdx.x >= 128) {  // producer warp: one thread issues every load
    if (threadIdx.x == 128 && n > 0) {
      mbar_expect_tx(qbar, C::Q_BYTES);
#pragma unroll
      for (int x = 0; x < C::BOXES; ++x)
        tma_load_3d(qs + x * Q_BOX_BYTES, &tq, qbar, x * BOX, q0, b * Hq + h);
      // K's slot frees as soon as S has read it, V's after P V: each has its
      // own barriers, so the next K is not held up behind this tile's V
      for (int i = 0; i < n; ++i) {
        const int s = i % C::STAGES, k0 = (t0 + i) * BK;
        unsigned char* st = ring + s * C::STAGE_BYTES;
        if (i >= C::STAGES) mbar_wait(empty_k + s, (i / C::STAGES - 1) & 1);
        mbar_expect_tx(full_k + s, C::TILE_BYTES);
#pragma unroll
        for (int x = 0; x < C::BOXES; ++x)
          tma_load_3d(st + x * C::KV_BOX_BYTES, &tk, full_k + s, x * BOX, k0, b * Hkv + hk);
        if (i >= C::STAGES) mbar_wait(empty_v + s, (i / C::STAGES - 1) & 1);
        mbar_expect_tx(full_v + s, C::TILE_BYTES);
#pragma unroll
        for (int x = 0; x < C::BOXES; ++x)
          tma_load_3d(st + C::TILE_BYTES + x * C::KV_BOX_BYTES, &tv, full_v + s, x * BOX, k0,
                      b * Hkv + hk);
      }
    }
    return;
  }

  // consumer warpgroup: thread tid holds rows r0 and r0 + 8 of the tile
  const int tid = threadIdx.x, lane = tid % 32, t4 = lane % 4;
  const int r0 = (tid / 32) * 16 + lane / 4;
  const int qpos[2] = {q0 + r0 + kv_offset, q0 + r0 + 8 + kv_offset};
  // (m, l, acc): the current group's state; every group but an unsplit
  // block's last goes to the workspace when it ends, and at the end they are
  // folded in key order into (M, L, A), A in acc's registers
  float m[2] = {REPRO_NEG_INF, REPRO_NEG_INF}, M[2] = {REPRO_NEG_INF, REPRO_NEG_INF};
  float l[2] = {0.0f, 0.0f}, L[2] = {0.0f, 0.0f};
  float acc[D / 2], sc[BK / 2];
#pragma unroll
  for (int j = 0; j < D / 2; ++j) acc[j] = 0.0f;
#pragma unroll
  for (int j = 0; j < BK / 2; ++j) sc[j] = 0.0f;

  const size_t bh = (size_t)b * Hq + h;
  // the rows of ws, this thread's first row, where (m, l) begin
  const size_t rows = gridDim.z * (size_t)Hq * n_qt * BQ;
  const size_t row = bh * n_qt * BQ + q0 + r0;
  float* const mls = ws + (size_t)(kt + TPG - 1) / TPG * rows * D;
  // group g's state into the workspace, and the next group from fresh
  const auto store_group = [&](int g) {
    float* part = ws + (size_t)g * rows * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + 2 * t4;
      __stcg(reinterpret_cast<float2*>(part + row * D + col),
             make_float2(acc[4 * j], acc[4 * j + 1]));
      __stcg(reinterpret_cast<float2*>(part + (row + 8) * D + col),
             make_float2(acc[4 * j + 2], acc[4 * j + 3]));
    }
    if (t4 == 0) {
      __stcg(reinterpret_cast<float2*>(mls + (g * rows + row) * 2), make_float2(m[0], l[0]));
      __stcg(reinterpret_cast<float2*>(mls + (g * rows + row + 8) * 2), make_float2(m[1], l[1]));
    }
#pragma unroll
    for (int j = 0; j < D / 2; ++j) acc[j] = 0.0f;
    m[0] = m[1] = REPRO_NEG_INF;
    l[0] = l[1] = 0.0f;
  };
  // fold group g from the workspace (its m, l a row, then O streamed)
  const auto fold_stored = [&](int g) {
    const float* ps = ws + (size_t)g * rows * D;
    float mg[2], lg[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float2 v = __ldcg(reinterpret_cast<const float2*>(mls + (g * rows + row + 8 * r) * 2));
      mg[r] = v.x, lg[r] = v.y;
    }
    fold<D>(M, L, acc, mg, lg, [&](int j) {
      const int col = 8 * (j / 4) + 2 * t4 + (j % 2);
      return __ldcg(ps + (row + 8 * ((j % 4) / 2)) * D + col);
    });
  };

  if (n > 0) mbar_wait(qbar, 0);
  // group by group: a group that ends before the walk does goes to the
  // workspace between the groups' tile loops, never inside one
  for (int i = 0, g = t0 / TPG; i < n; ++g) {
    const int i_end = min(n, (g + 1) * TPG - t0);
    if (i > 0) store_group(g - 1);
    for (; i < i_end; ++i) {
      const int s = i % C::STAGES, phase = (i / C::STAGES) & 1, k0 = (t0 + i) * BK;
      const unsigned char* st = ring + s * C::STAGE_BYTES;
      mbar_wait(full_k + s, phase);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma<BK, 0, 0>(sc, wgmma_desc(qs + (kk / 4) * Q_BOX_BYTES, 0, 1024) + 2 * (kk % 4),
                        wgmma_desc(st + (kk / 4) * C::KV_BOX_BYTES, 0, 1024) + 2 * (kk % 4),
                        kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      if (lane == 0) mbar_arrive(empty_k + s);       // this warp is done with K

      // a mask can bite only in the tile holding T, the block's diagonal and
      // the window's edge: uniform over the block
      const bool masked = k0 + BK > T || (causal && k0 + BK - 1 > q_first) ||
                          (window > 0 && k0 <= q_last - window);
      float mx[2] = {REPRO_NEG_INF, REPRO_NEG_INF};
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float val = sc[4 * j + e] * scale_log2;
          if (masked) {
            const int kpos = k0 + 8 * j + 2 * t4 + (e & 1), qp = qpos[e >> 1];
            bool ok = kpos < T;
            if (causal) ok = ok && kpos <= qp;
            if (window > 0) ok = ok && kpos > qp - window;
            val = ok ? val : REPRO_NEG_INF;
          }
          sc[4 * j + e] = val;
          mx[e >> 1] = fmaxf(mx[e >> 1], val);
        }
      float corr[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(m[r], quad_max(mx[r]));
        corr[r] = ex2(m[r] - m_new);
        m[r] = m_new;
      }
      // P rounded to bf16 as the A fragments of P V: keys 16 (j/2) + 8 (j%2)
      // + 2 t4 of rows r0 and r0 + 8 are registers 2 (j%2) and 2 (j%2) + 1
      // of the k16 slice j / 2
      uint32_t pa[BK / 16][4];
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        const float p0 = ex2(sc[4 * j] - m[0]), p1 = ex2(sc[4 * j + 1] - m[0]);
        const float p2 = ex2(sc[4 * j + 2] - m[1]), p3 = ex2(sc[4 * j + 3] - m[1]);
        sum[0] += p0 + p1;
        sum[1] += p2 + p3;
        pa[j / 2][2 * (j % 2)] = pack_bf16(p0, p1);
        pa[j / 2][2 * (j % 2) + 1] = pack_bf16(p2, p3);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + quad_sum(sum[r]);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        acc[4 * j] *= corr[0];
        acc[4 * j + 1] *= corr[0];
        acc[4 * j + 2] *= corr[1];
        acc[4 * j + 3] *= corr[1];
      }

      mbar_wait(full_v + s, phase);
      const uint64_t dv = wgmma_desc(st + C::TILE_BYTES, C::KV_BOX_BYTES, 1024);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) wgmma_rs<D, 1>(acc, pa[kk], dv + 128 * kk);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(pa);                                 // live until the product has read them
      if (lane == 0) mbar_arrive(empty_v + s);       // and with V
    }
  }

  const int g_last = (t0 + n - 1) / TPG;  // the block's last group (n > 0)
  if (splits > 1) {
    if (n > 0) store_group(g_last);
    __threadfence();
    // the barrier orders every thread's partials before thread 0's release;
    // its acquire orders the other splits' partials before the reads below
    bar_sync_first<128>();
    int* counter = counters + bh * n_qt + qt;
    if (tid == 0) {
      int old;
      asm volatile("atom.add.acq_rel.gpu.global.s32 %0, [%1], 1;\n"
                   : "=r"(old)
                   : "l"(counter)
                   : "memory");
      *flag = old == splits - 1;
    }
    bar_sync_first<128>();
    if (!*flag) return;
    // the last block: fold the q tile's groups in key order from the
    // workspace (the same floats whichever block is last)
    for (int g = g_lo; g < g_hi; ++g) fold_stored(g);
    if (tid == 0) *counter = 0;  // for the next launch on this stream
  } else if (n > 0 && t0 / TPG == g_last) {
    // one group: fold it from its registers (the first fold, into zero)
    fold<D, true>(M, L, acc, m, l, [&](int j) { return acc[j]; });
  } else if (n > 0) {
    // the last group waits in the ring, free now (every tile is consumed),
    // each thread's values its own (element j of thread tid at j * 128 +
    // tid), while its registers fold the stored groups and then it
    float* last = reinterpret_cast<float*>(ring);
    bar_sync_first<128>();  // every warp's last product has read V from the ring
#pragma unroll
    for (int j = 0; j < D / 2; ++j) last[j * 128 + tid] = acc[j], acc[j] = 0.0f;
    const float ml[2] = {m[0], m[1]}, ll[2] = {l[0], l[1]};
    for (int g = t0 / TPG; g < g_last; ++g) fold_stored(g);
    fold<D>(M, L, acc, ml, ll, [&](int j) { return last[j * 128 + tid]; });
  }

  const float l0 = L[0] == 0.0f ? 1.0f : L[0];
  const float l1 = L[1] == 0.0f ? 1.0f : L[1];
  __nv_bfloat16* ob = o + bh * S * d;
  const int row0 = q0 + r0, row1 = row0 + 8;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + 2 * t4;  // even, and d a multiple of 16: both or neither stored
    if (col >= d) continue;
    if (row0 < S)
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)row0 * d + col) =
          __floats2bfloat162_rn(acc[4 * j] / l0, acc[4 * j + 1] / l0);
    if (row1 < S)
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)row1 * d + col) =
          __floats2bfloat162_rn(acc[4 * j + 2] / l1, acc[4 * j + 3] / l1);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, void* ws,
                   void* counters, int B, int Hq, int Hkv, int S, int T, int d, float scale,
                   int causal, int window, int splits, cudaStream_t st) {
  using C = FaCfg<D>;
  static const cudaError_t set =
      cudaFuncSetAttribute(fa_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (set != cudaSuccess) return set;
  CUtensorMap tq, tk, tv;
  // [B·H][rows][d] in boxes of one head's rows by 64 values: rows past S or T,
  // and columns past d, read zeros, never the next row's or head's
  constexpr CUtensorMapL2promotion L2 = CU_TENSOR_MAP_L2_PROMOTION_L2_128B;
  if (!tensor_map(&tq, 3, q, d, S, (uint64_t)B * Hq, BOX, BQ, L2) ||
      !tensor_map(&tk, 3, k, d, T, (uint64_t)B * Hkv, BOX, C::BK, L2) ||
      !tensor_map(&tv, 3, v, d, T, (uint64_t)B * Hkv, BOX, C::BK, L2))
    return cudaErrorInvalidValue;
  dim3 grid(Hq * splits, (S + BQ - 1) / BQ, B);
  return launch_overlapped(fa_kernel<D>, grid, THREADS, C::SMEM, st, tq, tk, tv,
                           static_cast<__nv_bfloat16*>(o), static_cast<float*>(ws),
                           static_cast<int*>(counters), Hq, Hkv, S, T, d, scale * LOG2E, causal,
                           window, splits);
}

}  // namespace

// q [B,Hq,S,D], k/v [B,Hkv,T,D], o [B,Hq,S,D], all bf16, contiguous and
// 16-byte aligned, D a multiple of 16 from 16 to 128, S <= T, Hq % Hkv ==
// 0.  window <= 0 means no window.  splits: key-range splits a (q tile,
// head), 1-4.  With splits > 1 or T > 512, ws holds groups * B * Hq * 64
// ceil(S / 64) * (Di + 2) floats (Di = 64 for D <= 64, else 128: the
// instance; groups = ceil(T / 512), the key groups); with splits > 1,
// counters B * Hq * ceil(S / 64) zeroed ints used by no other stream.  One
// launch.  Returns the cudaError_t.
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v, void* o,
                                     void* ws, void* counters, int B, int Hq, int Hkv, int S,
                                     int T, int D, float scale, int causal, int window,
                                     int splits, void* stream) {
  if (D < 16 || D > 128 || D % 16 || B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv || S <= 0 || S > T ||
      splits < 1 || splits > 4 || (splits > 1 && counters == nullptr) ||
      ((splits > 1 || T > GROUP_KEYS) && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) % 16)
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(D <= 64 ? launch<64>(q, k, v, o, ws, counters, B, Hq, Hkv, S, T, D, scale, causal,
                                    window, splits, st)
                       : launch<128>(q, k, v, o, ws, counters, B, Hq, Hkv, S, T, D, scale,
                                     causal, window, splits, st));
}
