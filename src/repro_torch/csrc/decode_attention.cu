// Decode attention for Hopper: one query token per sequence against its KV
// cache, dense or paged.  q [B,Hq,D] (bf16, D = 64 or 128), lengths int32 [B];
// positions >= lengths[b] are masked.  Two entry points share one kernel
// body, a template over where key row t of sequence b, kv head hk lives:
//   - dense, k/v [B,Hkv,T,D]:    base + ((b*Hkv + hk)*T + t)*D;
//   - paged, k/v [P,Hkv,ps,D] with an int32 block table [B,NP]:
//       pool + ((table[b, t/ps]*Hkv + hk)*ps + t%ps)*D.
//
// Replaces the Pallas TPU kernels repro/kernels/decode_attention.py::
// decode_attention (_dec_kernel) and ::paged_decode_attention
// (_paged_kernel).  Per token almost no arithmetic happens and the cache
// streams from device memory once, so the kernel is bound by bytes.  Its
// design:
//   - one block per (kv head, sequence); the `group` query heads of that kv
//     head ride as the rows of one 16-row tensor-core tile (rows past `group`
//     are zero), so the cache is read once for all of them;
//   - the block's four warps split the cache into 32-key tiles round-robin,
//     each running the same online softmax as the flash kernel (mma.sync,
//     f32 statistics, P rounded to bf16 for P V), and the four partial
//     (max, denominator, accumulator) triples are merged in shared memory at
//     the end — the split takes the place of the TPU's sequential KV axis;
//   - tiles wholly at or past the sequence's length are skipped and rows at
//     or past it are zero-filled, not read: a short sequence reads only its
//     own rows, and a paged sequence never dereferences a table entry past
//     its length (unmapped entries point at the scratch page); those rows
//     are masked at -1e30, and so is a row whose table entry lies outside
//     the pool (it is not read either): a corrupt table drops its rows from
//     the softmax instead of reading out of bounds or passing off zeros as
//     keys;
//   - l == 0 is guarded as in the Pallas kernels.
// The paged layout changes only the row address: tile order, masking and the
// merge are one code path, so over equal KV rows the paged kernel is bitwise
// equal to the dense one, for any page size (a 32-key tile may span pages;
// a row is 128 or 256 contiguous bytes, so the 16-byte loads stay aligned).
// The head dim D is a template parameter, 64 or 128: at 128 the tiles and
// their padding take 4 x 2 x 32 x 136 x 2 = 69,632 bytes of shared memory
// and the merge buffer 32 KB of it, so the tiles live in dynamic shared
// memory (its limit raised once an instance).  The page table is read per
// row from global memory (cached); TMA, wgmma and a split of one sequence
// across SMs are later work.
#include "common.cuh"

namespace {

constexpr int kTile = 32;      // keys per warp tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

template <int D>
struct DecCfg {
  static constexpr int LD = D + 8;              // padded smem row (bf16 elements)
  static constexpr int TILE_ELEMS = kTile * LD;
  // per warp a K and a V tile; reused as the f32 [kWarps][16][D] merge buffer
  static constexpr int SMEM = kWarps * 2 * TILE_ELEMS * 2;
  static_assert(kWarps * 16 * D * 4 <= SMEM, "the merge buffer fits in the tiles' space");
};

// Row addressing of a dense cache [B,Hkv,T,D]: the element offset of row t.
struct DenseRows {
  int Hkv, T;
  template <int D>
  __device__ __forceinline__ bool offset(int b, int hk, int t, size_t& off) const {
    off = (((size_t)b * Hkv + hk) * T + t) * D;
    return true;
  }
};

// Row addressing of a paged pool [P,Hkv,ps,D] through the block table
// [B,NP]; false for a page index outside [0, P), which the kernel masks.
struct PagedRows {
  const int* table;
  int Hkv, P, ps, NP, T;  // T = NP * ps, the rows the table can address
  template <int D>
  __device__ __forceinline__ bool offset(int b, int hk, int t, size_t& off) const {
    const int page = table[(size_t)b * NP + t / ps];
    off = (((size_t)page * Hkv + hk) * ps + t % ps) * D;
    return page >= 0 && page < P;
  }
};

template <int D, class Rows>
__global__ void __launch_bounds__(kThreads)
    dec_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v, const Rows rows,
               const int* __restrict__ lengths, __nv_bfloat16* __restrict__ o, int Hq,
               float scale) {
  using C = DecCfg<D>;
  constexpr int kD = D, kLd = C::LD, kTileElems = C::TILE_ELEMS;
  extern __shared__ __align__(16) unsigned char dec_smem[];
  __nv_bfloat16* kv_smem = reinterpret_cast<__nv_bfloat16*>(dec_smem);
  __shared__ float m_s[kWarps][16], l_s[kWarps][16];
  // per warp: which rows of its current tile take part in the softmax
  __shared__ bool row_ok[kWarps][kTile];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int hk = blockIdx.x, b = blockIdx.y;
  const int group = Hq / rows.Hkv;
  const int len = min(max(lengths[b], 0), rows.T);

  const __nv_bfloat16* qh = q + ((size_t)b * Hq + (size_t)hk * group) * kD;  // [group, D]
  __nv_bfloat16* ks = kv_smem + warp * 2 * kTileElems;
  __nv_bfloat16* vs = ks + kTileElems;
  const unsigned short* vsu = reinterpret_cast<const unsigned short*>(vs);

  uint32_t qa[kD / 16][4];
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    const int c = kk * 16 + 2 * t;
    qa[kk][0] = g < group ? *reinterpret_cast<const uint32_t*>(qh + g * kD + c) : 0u;
    qa[kk][1] = g + 8 < group ? *reinterpret_cast<const uint32_t*>(qh + (g + 8) * kD + c) : 0u;
    qa[kk][2] = g < group ? *reinterpret_cast<const uint32_t*>(qh + g * kD + c + 8) : 0u;
    qa[kk][3] = g + 8 < group ? *reinterpret_cast<const uint32_t*>(qh + (g + 8) * kD + c + 8) : 0u;
  }

  float m[2] = {REPRO_NEG_INF, REPRO_NEG_INF};
  float l[2] = {0.0f, 0.0f};
  float acc[kD / 8][4];
#pragma unroll
  for (int dn = 0; dn < kD / 8; ++dn) acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.0f;

  const int n_tiles = (len + kTile - 1) / kTile;
  for (int j = warp; j < n_tiles; j += kWarps) {
    const int k0 = j * kTile;
    __syncwarp();  // this warp's previous tile is consumed
    for (int c = lane; c < kTile * kD / 8; c += 32) {
      int r = c / (kD / 8), col = (c % (kD / 8)) * 8;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = make_uint4(0u, 0u, 0u, 0u);
      size_t off;
      const bool ok = k0 + r < len && rows.template offset<D>(b, hk, k0 + r, off);
      if (ok) {
        kv = *reinterpret_cast<const uint4*>(k + off + col);
        vv = *reinterpret_cast<const uint4*>(v + off + col);
      }
      if (col == 0) row_ok[warp][r] = ok;
      *reinterpret_cast<uint4*>(ks + r * kLd + col) = kv;
      *reinterpret_cast<uint4*>(vs + r * kLd + col) = vv;
    }
    __syncwarp();

    float s[kTile / 8][4];
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        const __nv_bfloat16* kr = ks + (nt * 8 + g) * kLd + kk * 16 + 2 * t;
        mma_bf16_16816(s[nt], qa[kk], *reinterpret_cast<const uint32_t*>(kr),
                       *reinterpret_cast<const uint32_t*>(kr + 8));
      }
    }

    float mx[2] = {REPRO_NEG_INF, REPRO_NEG_INF};
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float val = row_ok[warp][nt * 8 + 2 * t + (e & 1)] ? s[nt][e] * scale
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
      const int r0 = kk * 16 + 2 * t;
#pragma unroll
      for (int dn = 0; dn < kD / 8; ++dn) {
        const int col = dn * 8 + g;
        const uint32_t b0 = pack_raw(vsu[r0 * kLd + col], vsu[(r0 + 1) * kLd + col]);
        const uint32_t b1 = pack_raw(vsu[(r0 + 8) * kLd + col], vsu[(r0 + 9) * kLd + col]);
        mma_bf16_16816(acc[dn], pa, b0, b1);
      }
    }
  }

  // merge the four warps' partial softmax states
  __syncthreads();  // every warp is done with its K/V tiles
  float* os = reinterpret_cast<float*>(kv_smem);  // [kWarps][16][kD]
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
    o[((size_t)b * Hq + (size_t)hk * group + r) * kD + d] =
        __float2bfloat16(oo / (ll == 0.0f ? 1.0f : ll));
  }
}

bool bad_heads(int B, int Hq, int Hkv, int D) {
  return (D != 64 && D != 128) || B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv || Hq / Hkv > 16;
}

// One launch of the instance for D: grid (Hkv, B), its shared memory limit
// raised on first use.
template <int D, class Rows>
cudaError_t launch(const void* q, const void* k, const void* v, const Rows& rows,
                   const void* lengths, void* o, int B, int Hq, float scale, void* stream) {
  static const cudaError_t set = cudaFuncSetAttribute(
      dec_kernel<D, Rows>, cudaFuncAttributeMaxDynamicSharedMemorySize, DecCfg<D>::SMEM);
  if (set != cudaSuccess) return set;
  dim3 grid(rows.Hkv, B);
  dec_kernel<D, Rows><<<grid, kThreads, DecCfg<D>::SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), rows, static_cast<const int*>(lengths),
      static_cast<__nv_bfloat16*>(o), Hq, scale);
  return cudaGetLastError();
}

}  // namespace

// q [B,Hq,D], k/v [B,Hkv,T,D], o [B,Hq,D] bf16 contiguous, lengths int32 [B]
// on the device, D = 64 or 128, Hq / Hkv <= 16.  Returns the cudaError_t.
extern "C" int repro_decode_attention(const void* q, const void* k, const void* v,
                                      const void* lengths, void* o, int B, int Hq, int Hkv,
                                      int T, int D, float scale, void* stream) {
  if (bad_heads(B, Hq, Hkv, D) || T <= 0) return (int)cudaErrorInvalidValue;
  const DenseRows rows{Hkv, T};
  return (int)(D == 64 ? launch<64>(q, k, v, rows, lengths, o, B, Hq, scale, stream)
                       : launch<128>(q, k, v, rows, lengths, o, B, Hq, scale, stream));
}

// q [B,Hq,D], k/v pools [P,Hkv,ps,D], o [B,Hq,D] bf16 contiguous; block
// table int32 [B,NP] and lengths int32 [B] on the device; D = 64 or 128,
// Hq / Hkv <= 16.  Returns the cudaError_t.
extern "C" int repro_paged_decode_attention(const void* q, const void* k_pool,
                                            const void* v_pool, const void* table,
                                            const void* lengths, void* o, int B, int Hq,
                                            int Hkv, int P, int ps, int NP, int D,
                                            float scale, void* stream) {
  if (bad_heads(B, Hq, Hkv, D) || P <= 0 || ps <= 0 || NP <= 0)
    return (int)cudaErrorInvalidValue;
  const PagedRows rows{static_cast<const int*>(table), Hkv, P, ps, NP, NP * ps};
  return (int)(D == 64 ? launch<64>(q, k_pool, v_pool, rows, lengths, o, B, Hq, scale, stream)
                       : launch<128>(q, k_pool, v_pool, rows, lengths, o, B, Hq, scale, stream));
}
