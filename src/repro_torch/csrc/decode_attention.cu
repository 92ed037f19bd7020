// Decode attention for Hopper: one query token per sequence against its KV
// cache, dense or paged.  q [B,Hq,D] (bf16, D a multiple of 16 from 16 to
// 128), lengths int32 [B];
// positions >= lengths[b] are masked.  Two entry points share one kernel
// body, a template over where key row t of sequence b, kv head hk lives:
//   - dense, k/v [B,Hkv,T,D]:    base + ((b*Hkv + hk)*T + t)*D;
//   - paged, k/v [P,Hkv,ps,D] with an int32 block table [B,NP]:
//       pool + ((table[b, t/ps]*Hkv + hk)*ps + t%ps)*D.
//
// Replaces the Pallas TPU kernels repro/kernels/decode_attention.py::
// decode_attention (_dec_kernel) and ::paged_decode_attention
// (_paged_kernel).  Per token almost no arithmetic happens and the cache
// streams from device memory once, so the kernel is bound by bytes: 8
// slots of llama's 8 kv heads at D = 64 move about 6 MB, 1.8 us at 3.35
// TB/s.  One block a (kv head, sequence) (64 blocks for 132 SMs) whose
// warps load one 32-key tile at a time with synchronous loads, a paged row
// waiting on its table entry before its load, leaves that bandwidth idle.
// This design:
//   - split-KV (flash-decoding): grid (Hkv, B, splits), 1 to 8 splits.  The
//     host picks `splits` from the cache's T alone (dense rows, or table
//     width x page size: one split every 8 tiles, kernels/decode_attention.py
//     split_kv), never from the lengths (no host sync, and a grid fixed for
//     CUDA-graph capture) nor from B (a row's split, and so its rounding, is
//     the same in a launch of any number of sequences).  Split s owns key
//     tiles [s per, (s+1) per); a split that
//     starts at or past its sequence's length contributes an empty
//     partial (m = -1e30, l = 0);
//   - inside a block, the kv head's `group` query heads ride as the rows of
//     one 16-row tensor-core tile (rows past `group` are zero), so the cache
//     is read once for all of them; the block's four warps take its 32-key
//     tiles round-robin, each running an online softmax (mma.sync, f32
//     statistics, P rounded to bf16 for P V), merged in shared memory in
//     warp order at the end;
//   - bytes in flight: each warp keeps two tiles of K and V in a cp.async
//     ring (16-byte copies; rows past the length, or of a page outside the
//     pool, are zero-filled and not read);
//   - paged: the block's slice of the table row is staged in shared memory
//     once, before the key loop, and every row's address comes from there;
//   - the merge, in the launch and deterministic: with splits > 1 each block
//     writes its partial (m, l, unnormalised acc) to an f32 workspace and the
//     last block of a (sequence, kv head) to arrive at its counter (acq_rel;
//     one counter buffer per CUDA stream) merges the partials in split order
//     and resets the counter, so calls repeat bit for bit;
//   - rows at or past the length are masked at -1e30 and never read: a
//     paged sequence never dereferences a table entry past its length
//     (unmapped entries point at the scratch page); a row whose table entry
//     lies outside the pool is masked too (and not read), so a corrupt table
//     drops its rows from the softmax instead of reading out of bounds;
//   - l == 0 is guarded as in the Pallas kernels.
// The paged layout changes only the row address: split boundaries, tile
// order, masks and both merges are one code path that depends on (length,
// T, tile), so over equal KV rows the paged kernel is bitwise equal to the
// dense one on the gathered cache, for any page size (a 32-key tile may span
// pages; a row is 2D contiguous bytes, so the 16-byte copies stay aligned).
// The head dim D is a template parameter, every multiple of 16 from 16 to
// 128 (the mma.sync fragments step D in 16s): at 128 the ring takes 4 warps
// x 2 stages x 2 tiles x 32 x 136 x 2 = 139,264 bytes of shared memory and
// the merge buffer 32 KB of it, so the ring lives in dynamic shared memory,
// its limit raised once an instance.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kTile = 32;      // keys per warp tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kStages = 2;     // tiles in flight per warp
constexpr int kMaxSplits = 8;  // key-range splits a (sequence, kv head), at most
constexpr int kMaxSmem = 232448;

template <int D>
struct DecCfg {
  static constexpr int LD = D + 8;              // padded smem row (bf16 elements)
  static constexpr int TILE_ELEMS = kTile * LD;
  // per warp and stage a K and a V tile; reused as the f32 [kWarps][16][D]
  // merge buffer
  static constexpr int RING = kWarps * kStages * 2 * TILE_ELEMS * 2;
  static_assert(kWarps * 16 * D * 4 + 2 * kMaxSplits * 16 * 4 <= RING,
                "the merge buffers fit in the ring's space");
};

// Row addressing of a dense cache [B,Hkv,T,D]: the element offset of row t.
struct DenseRows {
  int Hkv, T;
  __device__ __forceinline__ int stage(int, int, int, int*) const { return 0; }
  template <int D>
  __device__ __forceinline__ bool offset(int b, int hk, int t, const int*, int,
                                         size_t& off) const {
    off = (((size_t)b * Hkv + hk) * T + t) * D;
    return true;
  }
};

// Row addressing of a paged pool [P,Hkv,ps,D] through the block table
// [B,NP].  stage() copies the table entries of keys [lo, hi) of sequence b
// to shared memory (block-wide, ending in a barrier) and returns the first
// page's index; offset() reads them there, false for a page outside [0, P),
// which the kernel masks.
struct PagedRows {
  const int* table;
  int Hkv, P, ps, NP, T;  // T = NP * ps, the rows the table can address
  __device__ __forceinline__ int stage(int b, int lo, int hi, int* pages) const {
    const int first = lo / ps;
    if (hi > lo) {
      const int n = (hi - 1) / ps - first + 1;
      for (int i = threadIdx.x; i < n; i += blockDim.x)
        pages[i] = table[(size_t)b * NP + first + i];
    }
    __syncthreads();
    return first;
  }
  template <int D>
  __device__ __forceinline__ bool offset(int, int hk, int t, const int* pages, int first,
                                         size_t& off) const {
    const int page = pages[t / ps - first];
    off = (((size_t)page * Hkv + hk) * ps + t % ps) * D;
    return page >= 0 && page < P;
  }
};

// grid (Hkv, B, splits); split s owns key tiles [s per, (s+1) per).  With
// splits > 1, ws holds splits x [B*Hkv, 16, D] f32 partials, then splits x
// [B*Hkv, 16, 2] (m, l); counters B*Hkv zeroed ints, left zeroed.
template <int D, class Rows>
__global__ void __launch_bounds__(kThreads)
    dec_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v, const Rows rows,
               const int* __restrict__ lengths, __nv_bfloat16* __restrict__ o,
               float* __restrict__ ws, int* __restrict__ counters, int Hq, int per,
               float scale) {
  using C = DecCfg<D>;
  constexpr int kD = D, kLd = C::LD, kTileElems = C::TILE_ELEMS;
  extern __shared__ __align__(16) unsigned char dec_smem[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(dec_smem);
  int* pages = reinterpret_cast<int*>(dec_smem + C::RING);
  __shared__ float m_s[kWarps][16], l_s[kWarps][16];
  // per warp and stage: which rows of the tile take part in the softmax
  __shared__ bool row_ok[kWarps][kStages][kTile];
  __shared__ float ll_s[16];
  __shared__ int merger;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int hk = blockIdx.x, b = blockIdx.y, split = blockIdx.z, splits = gridDim.z;
  const int group = Hq / rows.Hkv;
  const int len = min(max(lengths[b], 0), rows.T);
  const int t_lo = split * per, t_hi = min(t_lo + per, (len + kTile - 1) / kTile);
  const int first = rows.stage(b, t_lo * kTile, min(t_hi * kTile, len), pages);

  const __nv_bfloat16* qh = q + ((size_t)b * Hq + (size_t)hk * group) * kD;  // [group, D]
  uint32_t qa[kD / 16][4];
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    const int c = kk * 16 + 2 * t;
    qa[kk][0] = g < group ? *reinterpret_cast<const uint32_t*>(qh + g * kD + c) : 0u;
    qa[kk][1] = g + 8 < group ? *reinterpret_cast<const uint32_t*>(qh + (g + 8) * kD + c) : 0u;
    qa[kk][2] = g < group ? *reinterpret_cast<const uint32_t*>(qh + g * kD + c + 8) : 0u;
    qa[kk][3] = g + 8 < group ? *reinterpret_cast<const uint32_t*>(qh + (g + 8) * kD + c + 8) : 0u;
  }

  // copy tile j (if the block owns it) into this warp's stage st; one
  // commit group either way
  auto issue = [&](int j, int st) {
    if (j < t_hi) {
      const int k0 = j * kTile;
      __nv_bfloat16* ks = ring + (warp * kStages + st) * 2 * kTileElems;
      __nv_bfloat16* vs = ks + kTileElems;
      for (int c = lane; c < kTile * kD / 8; c += 32) {
        const int r = c / (kD / 8), col = (c % (kD / 8)) * 8;
        size_t off = 0;
        const bool ok = k0 + r < len && rows.template offset<D>(b, hk, k0 + r, pages, first, off);
        cp_async16(ks + r * kLd + col, ok ? k + off + col : k, ok);
        cp_async16(vs + r * kLd + col, ok ? v + off + col : v, ok);
        if (col == 0) row_ok[warp][st][r] = ok;
      }
    }
    cp_async_commit();
  };

  float m[2] = {REPRO_NEG_INF, REPRO_NEG_INF};
  float l[2] = {0.0f, 0.0f};
  float acc[kD / 8][4];
#pragma unroll
  for (int dn = 0; dn < kD / 8; ++dn) acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.0f;

  issue(t_lo + warp, 0);
  issue(t_lo + warp + kWarps, 1);
  int st = 0;
  for (int j = t_lo + warp; j < t_hi; j += kWarps, st ^= 1) {
    cp_async_wait<kStages - 1>();  // tile j has landed
    __syncwarp();
    const __nv_bfloat16* ks = ring + (warp * kStages + st) * 2 * kTileElems;
    const __nv_bfloat16* vs = ks + kTileElems;

    // S = q K^T: K's fragments by ldmatrix from its [key][d] rows
    float s[kTile / 8][4];
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < kTile / 16; ++np) {
        uint32_t kf[4];
        ldsm_x4(kf, ks + (16 * np + (lane % 8) + (lane / 16) * 8) * kLd + 16 * kk +
                        ((lane / 8) % 2) * 8);
        mma_bf16_16816(s[2 * np], qa[kk], kf[0], kf[1]);
        mma_bf16_16816(s[2 * np + 1], qa[kk], kf[2], kf[3]);
      }
    }

    float mx[2] = {REPRO_NEG_INF, REPRO_NEG_INF};
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float val = row_ok[warp][st][nt * 8 + 2 * t + (e & 1)] ? s[nt][e] * scale
                                                                     : REPRO_NEG_INF;
        s[nt][e] = val;
        mx[e >> 1] = fmaxf(mx[e >> 1], val);
      }
    float corr[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(mx[r]));
      corr[r] = expf(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[nt][e] - m[e >> 1]);
        s[nt][e] = p;
        sum[e >> 1] += p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + quad_sum(sum[r]);
#pragma unroll
    for (int dn = 0; dn < kD / 8; ++dn) {
      acc[dn][0] *= corr[0];
      acc[dn][1] *= corr[0];
      acc[dn][2] *= corr[1];
      acc[dn][3] *= corr[1];
    }
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      // V's fragments by ldmatrix.trans from its [key][d] rows
#pragma unroll
      for (int dp = 0; dp < kD / 16; ++dp) {
        uint32_t vf[4];
        ldsm_x4_trans(vf, vs + (16 * kk + (lane % 8) + ((lane / 8) % 2) * 8) * kLd + 16 * dp +
                              (lane / 16) * 8);
        mma_bf16_16816(acc[2 * dp], pa, vf[0], vf[1]);
        mma_bf16_16816(acc[2 * dp + 1], pa, vf[2], vf[3]);
      }
    }
    __syncwarp();  // this warp is done with stage st
    issue(j + kStages * kWarps, st);
  }
  cp_async_wait<0>();

  // merge the four warps' partial softmax states
  __syncthreads();  // every warp is done with its ring
  float* os = reinterpret_cast<float*>(dec_smem);  // [kWarps][16][kD]
  // the merger's (m -> scale, l) of every split and row, past the merge
  // buffer in the ring's space (static arrays would cost a block an SM)
  float(*mf_s)[16] = reinterpret_cast<float(*)[16]>(os + kWarps * 16 * kD);
  float(*ls_s)[16] = mf_s + kMaxSplits;
#pragma unroll
  for (int dn = 0; dn < kD / 8; ++dn) {
    const int col = dn * 8 + 2 * t;
    os[(warp * 16 + g) * kD + col] = acc[dn][0];
    os[(warp * 16 + g) * kD + col + 1] = acc[dn][1];
    os[(warp * 16 + g + 8) * kD + col] = acc[dn][2];
    os[(warp * 16 + g + 8) * kD + col + 1] = acc[dn][3];
  }
  if (t == 0) {
    m_s[warp][g] = m[0];
    m_s[warp][g + 8] = m[1];
    l_s[warp][g] = l[0];
    l_s[warp][g + 8] = l[1];
  }
  __syncthreads();
  const size_t bh = (size_t)b * rows.Hkv + hk;
  const size_t units = (size_t)gridDim.y * rows.Hkv;
  float* const mls = ws + splits * units * 16 * kD;  // (m, l) of split sp's row r at (sp units + bh) 16 + r
  for (int idx = tid; idx < group * kD; idx += kThreads) {
    const int r = idx / kD, d = idx % kD;
    float mm = REPRO_NEG_INF;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, m_s[w][r]);
    float ll = 0.0f, oo = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(m_s[w][r] - mm);
      ll += l_s[w][r] * f;
      oo += os[(w * 16 + r) * kD + d] * f;
    }
    if (splits == 1) {
      o[((size_t)b * Hq + (size_t)hk * group + r) * kD + d] =
          __float2bfloat16(oo / (ll == 0.0f ? 1.0f : ll));
    } else {
      __stcg(ws + ((split * units + bh) * 16 + r) * kD + d, oo);
      if (d == 0) __stcg(reinterpret_cast<float2*>(mls + ((split * units + bh) * 16 + r) * 2),
                         make_float2(mm, ll));
    }
  }
  if (splits == 1) return;

  // the barrier orders every thread's partial before thread 0's release (a
  // release after a CTA barrier is cumulative); its acquire orders the
  // other splits' partials before the reads below
  __syncthreads();
  int* counter = counters + bh;
  if (tid == 0) {
    int old;
    asm volatile("atom.add.acq_rel.gpu.global.s32 %0, [%1], 1;\n"
                 : "=r"(old)
                 : "l"(counter)
                 : "memory");
    merger = old == splits - 1;
  }
  __syncthreads();
  if (!merger) return;
  // the last block: merge the splits in split order 0..splits-1, its own
  // included, from the workspace (the same floats whichever block is last).
  // Its loads go out together: each thread's first two output vectors'
  // partials, and every split's (m, l); then each row's scales.
  const int nvec = group * kD / 4;  // the output's 4-float vectors
  const float4* part = reinterpret_cast<const float4*>(ws);
  const size_t split_vecs = units * 16 * kD / 4, bh_vec = bh * 16 * kD / 4;
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float4 pre[2][kMaxSplits];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int sp = 0; sp < kMaxSplits; ++sp) {
      const int e = tid + i * kThreads;
      pre[i][sp] = e < nvec && sp < splits ? __ldcg(part + sp * split_vecs + bh_vec + e) : zero;
    }
  for (int e = tid; e < splits * group; e += kThreads) {
    const int sp = e / group, r = e % group;
    const float2 ml =
        __ldcg(reinterpret_cast<const float2*>(mls + ((sp * units + bh) * 16 + r) * 2));
    mf_s[sp][r] = ml.x;
    ls_s[sp][r] = ml.y;
  }
  __syncthreads();
  if (tid < group) {
    float mm = REPRO_NEG_INF;
    for (int sp = 0; sp < splits; ++sp) mm = fmaxf(mm, mf_s[sp][tid]);
    float ll = 0.0f;
    for (int sp = 0; sp < splits; ++sp) {
      const float f = expf(mf_s[sp][tid] - mm);
      mf_s[sp][tid] = f;
      ll += ls_s[sp][tid] * f;
    }
    ll_s[tid] = ll == 0.0f ? 1.0f : ll;
  }
  __syncthreads();
  __nv_bfloat16* ob = o + ((size_t)b * Hq + (size_t)hk * group) * kD;  // [group, D]
  for (int e = tid, i = 0; e < nvec; e += kThreads, ++i) {
    const int r = e * 4 / kD;
    float4 pv[kMaxSplits];
#pragma unroll
    for (int sp = 0; sp < kMaxSplits; ++sp)
      pv[sp] = i == 0 ? pre[0][sp]
               : i == 1 ? pre[1][sp]
               : sp < splits ? __ldcg(part + sp * split_vecs + bh_vec + e) : zero;
    float4 oo = zero;
#pragma unroll
    for (int sp = 0; sp < kMaxSplits; ++sp) {
      if (sp >= splits) break;
      const float f = mf_s[sp][r];
      oo.x += pv[sp].x * f;
      oo.y += pv[sp].y * f;
      oo.z += pv[sp].z * f;
      oo.w += pv[sp].w * f;
    }
    const float ll = ll_s[r];
    const __nv_bfloat162 lo = __floats2bfloat162_rn(oo.x / ll, oo.y / ll);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(oo.z / ll, oo.w / ll);
    uint2 packed;
    packed.x = *reinterpret_cast<const uint32_t*>(&lo);
    packed.y = *reinterpret_cast<const uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(ob + e * 4) = packed;
  }
  if (tid == 0) *counter = 0;  // for the next launch on this stream
}

bool bad_heads(int B, int Hq, int Hkv, int D) {
  return D < 16 || D > 128 || D % 16 || B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv || Hq / Hkv > 16;
}

// The dynamic shared memory limit of an instance, raised on first use to
// what its static arrays leave of the SM's 227 KB; 0 if that failed.
template <int D, class Rows>
int dynamic_smem_max() {
  static const int most = [] {
    cudaFuncAttributes attr;
    if (cudaFuncGetAttributes(&attr, dec_kernel<D, Rows>) != cudaSuccess) return 0;
    const int m = kMaxSmem - (int)attr.sharedSizeBytes;
    return cudaFuncSetAttribute(dec_kernel<D, Rows>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                m) == cudaSuccess ? m : 0;
  }();
  return most;
}

// One launch of the instance for D: grid (Hkv, B, splits), the key tiles of
// T dealt out `per` a split.
template <int D, class Rows>
cudaError_t launch(const void* q, const void* k, const void* v, const Rows& rows,
                   const void* lengths, void* o, void* ws, void* counters, int B, int Hq,
                   int splits, int page_rows, float scale, void* stream) {
  const int dynamic_max = dynamic_smem_max<D, Rows>();
  if (dynamic_max == 0) return cudaErrorInvalidDeviceFunction;
  const int tiles = (rows.T + kTile - 1) / kTile;
  const int per = (tiles + splits - 1) / splits;
  // the table entries of a split's keys, at most
  const long long pages = page_rows > 0 ? ((long long)per * kTile - 1) / page_rows + 2 : 0;
  const long long smem = DecCfg<D>::RING + 4 * pages;
  if (smem > dynamic_max) return cudaErrorInvalidValue;
  dim3 grid(rows.Hkv, B, splits);
  dec_kernel<D, Rows><<<grid, kThreads, (size_t)smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), rows, static_cast<const int*>(lengths),
      static_cast<__nv_bfloat16*>(o), static_cast<float*>(ws), static_cast<int*>(counters), Hq,
      per, scale);
  return cudaGetLastError();
}

// f(std::integral_constant<int, D>{}) for the instance of head dim D
// (checked by bad_heads).
template <class F>
auto with_head_dim(int D, F&& f) {
  switch (D) {
    case 16: return f(std::integral_constant<int, 16>{});
    case 32: return f(std::integral_constant<int, 32>{});
    case 48: return f(std::integral_constant<int, 48>{});
    case 64: return f(std::integral_constant<int, 64>{});
    case 80: return f(std::integral_constant<int, 80>{});
    case 96: return f(std::integral_constant<int, 96>{});
    case 112: return f(std::integral_constant<int, 112>{});
    default: return f(std::integral_constant<int, 128>{});
  }
}

template <class Rows>
cudaError_t launch_d(int D, const void* q, const void* k, const void* v, const Rows& rows,
                     const void* lengths, void* o, void* ws, void* counters, int B, int Hq,
                     int splits, int page_rows, float scale, void* stream) {
  return with_head_dim(D, [&](auto d) {
    return launch<decltype(d)::value>(q, k, v, rows, lengths, o, ws, counters, B, Hq, splits,
                                      page_rows, scale, stream);
  });
}

bool bad_splits(int splits, int T, const void* ws, const void* counters) {
  return splits < 1 || splits > kMaxSplits || splits > (T + kTile - 1) / kTile ||
         (splits > 1 && (ws == nullptr || counters == nullptr));
}

}  // namespace

// q [B,Hq,D], k/v [B,Hkv,T,D], o [B,Hq,D] bf16 contiguous, lengths int32 [B]
// on the device, D a multiple of 16 from 16 to 128, Hq / Hkv <= 16.  splits:
// key-range splits a (sequence, kv head), 1 .. min(8, ceil(T / 32)); with splits > 1,
// ws holds splits * B * Hkv * 16 * (D + 2) floats and counters B * Hkv
// zeroed ints used by no other stream.  One launch.  Returns the cudaError_t.
extern "C" int repro_decode_attention(const void* q, const void* k, const void* v,
                                      const void* lengths, void* o, void* ws, void* counters,
                                      int B, int Hq, int Hkv, int T, int D, int splits,
                                      float scale, void* stream) {
  if (bad_heads(B, Hq, Hkv, D) || T <= 0 || bad_splits(splits, T, ws, counters))
    return (int)cudaErrorInvalidValue;
  const DenseRows rows{Hkv, T};
  return (int)launch_d(D, q, k, v, rows, lengths, o, ws, counters, B, Hq, splits, 0, scale,
                       stream);
}

// q [B,Hq,D], k/v pools [P,Hkv,ps,D], o [B,Hq,D] bf16 contiguous; block
// table int32 [B,NP] and lengths int32 [B] on the device; D a multiple of 16
// from 16 to 128, Hq / Hkv <= 16; splits, ws and counters as the dense
// entry's with T = NP * ps.  Returns the cudaError_t.
extern "C" int repro_paged_decode_attention(const void* q, const void* k_pool,
                                            const void* v_pool, const void* table,
                                            const void* lengths, void* o, void* ws,
                                            void* counters, int B, int Hq, int Hkv, int P, int ps,
                                            int NP, int D, int splits, float scale,
                                            void* stream) {
  if (bad_heads(B, Hq, Hkv, D) || P <= 0 || ps <= 0 || NP <= 0 ||
      (long long)NP * ps > 0x7fffffffLL || bad_splits(splits, NP * ps, ws, counters))
    return (int)cudaErrorInvalidValue;
  const PagedRows rows{static_cast<const int*>(table), Hkv, P, ps, NP, NP * ps};
  return (int)launch_d(D, q, k_pool, v_pool, rows, lengths, o, ws, counters, B, Hq, splits, ps,
                       scale, stream);
}

// Blocks of the dense instance for head dim D (a multiple of 16 from 16 to
// 128) resident on an SM at once, by the CUDA runtime's occupancy
// calculator on the built kernel at its ring's shared memory; the split
// rule reads it (for the paged instance too, so that both split alike).
// A negative cudaError_t on failure.
extern "C" int repro_decode_blocks_per_sm(int D) {
  if (bad_heads(1, 1, 1, D)) return -(int)cudaErrorInvalidValue;
  return with_head_dim(D, [](auto d) {
    constexpr int kD = decltype(d)::value;
    if (dynamic_smem_max<kD, DenseRows>() == 0) return -(int)cudaErrorInvalidDeviceFunction;
    int blocks = 0;
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, dec_kernel<kD, DenseRows>, kThreads, DecCfg<kD>::RING);
    return e == cudaSuccess ? blocks : -(int)e;
  });
}
