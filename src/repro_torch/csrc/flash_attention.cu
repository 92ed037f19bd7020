// Flash attention for Hopper: online-softmax attention of q [B,Hq,S,D] over
// k, v [B,Hkv,T,D] (bf16, D = 64), GQA head h reading kv head h / (Hq/Hkv).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py::
// flash_attention (_fa_kernel).  The TPU carried the running max, denominator
// and accumulator in VMEM across a sequential KV grid axis; here one block of
// four warps owns 64 query rows (16 per warp) and loops over 64-key tiles
// itself, keeping that state in registers:
//   - S = Q K^T and O += P V run on the tensor cores (mma.sync m16n8k16, bf16
//     in, f32 accumulate).  The S accumulator fragment has exactly the layout
//     of the A operand of P V, so P never leaves registers; it is rounded to
//     bf16 for that product (the one place the arithmetic differs from the
//     f32 Pallas kernel), while the denominator sums the f32 probabilities.
//   - Masks match the Pallas kernel: causal and window masks at -1e30 with
//     queries aligned to the end of the keys (kv_offset = T - S); tiles wholly
//     invisible to the block are skipped; l == 0 is guarded at the end.
//   - K and V tiles are staged in shared memory with 16-byte loads; rows are
//     padded by 8 bf16 so the fragment reads hit 32 distinct banks.
// Ragged S and T are masked here (zero-filled rows, keys past T masked).
// Bound on the H100: operations at prefill lengths (S = T = 512: ~90 flops
// per byte of q, k, v, o for causal), so the tensor cores set the pace.
#include "common.cuh"

namespace {

constexpr int kD = 64;         // head dim
constexpr int kBQ = 64;        // query rows per block, 16 per warp
constexpr int kBK = 64;        // keys per tile
constexpr int kLd = kD + 8;    // padded smem row (bf16 elements)
constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
    fa_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int Hq, int Hkv,
              int S, int T, float scale, int causal, int window) {
  __shared__ __align__(16) __nv_bfloat16 qs[kBQ * kLd];
  __shared__ __align__(16) __nv_bfloat16 ks[kBK * kLd];
  __shared__ __align__(16) __nv_bfloat16 vs[kBK * kLd];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int kv_offset = T - S;

  const __nv_bfloat16* qb = q + (size_t)(b * Hq + h) * S * kD;
  const __nv_bfloat16* kb = k + (size_t)(b * Hkv + hk) * T * kD;
  const __nv_bfloat16* vb = v + (size_t)(b * Hkv + hk) * T * kD;

  for (int c = tid; c < kBQ * kD / 8; c += kThreads) {
    int r = c / (kD / 8), col = (c % (kD / 8)) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + r < S) val = *reinterpret_cast<const uint4*>(qb + (size_t)(q0 + r) * kD + col);
    *reinterpret_cast<uint4*>(qs + r * kLd + col) = val;
  }
  __syncthreads();

  const int wr = warp * 16;
  uint32_t qa[kD / 16][4];
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    const __nv_bfloat16* r0 = qs + (wr + g) * kLd + kk * 16 + 2 * t;
    const __nv_bfloat16* r1 = r0 + 8 * kLd;
    qa[kk][0] = *reinterpret_cast<const uint32_t*>(r0);
    qa[kk][1] = *reinterpret_cast<const uint32_t*>(r1);
    qa[kk][2] = *reinterpret_cast<const uint32_t*>(r0 + 8);
    qa[kk][3] = *reinterpret_cast<const uint32_t*>(r1 + 8);
  }

  float m[2] = {REPRO_NEG_INF, REPRO_NEG_INF};
  float l[2] = {0.0f, 0.0f};
  float acc[kD / 8][4];
#pragma unroll
  for (int dn = 0; dn < kD / 8; ++dn) acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.0f;

  const int q_first = q0 + kv_offset;                   // block's first query position
  const int q_last = min(q0 + kBQ, S) - 1 + kv_offset;  // block's last real query position
  const int qpos[2] = {q0 + wr + g + kv_offset, q0 + wr + g + 8 + kv_offset};
  int n_tiles = (T + kBK - 1) / kBK;
  if (causal) n_tiles = min(n_tiles, q_last / kBK + 1);
  const unsigned short* vsu = reinterpret_cast<const unsigned short*>(vs);

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kBK;
    if (window > 0 && k0 + kBK - 1 <= q_first - window) continue;  // uniform over the block
    __syncthreads();  // the previous tile's reads of ks/vs are done
    for (int c = tid; c < kBK * kD / 8; c += kThreads) {
      int r = c / (kD / 8), col = (c % (kD / 8)) * 8;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + r < T) {
        kv = *reinterpret_cast<const uint4*>(kb + (size_t)(k0 + r) * kD + col);
        vv = *reinterpret_cast<const uint4*>(vb + (size_t)(k0 + r) * kD + col);
      }
      *reinterpret_cast<uint4*>(ks + r * kLd + col) = kv;
      *reinterpret_cast<uint4*>(vs + r * kLd + col) = vv;
    }
    __syncthreads();

    float s[kBK / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
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
    for (int nt = 0; nt < kBK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = k0 + nt * 8 + 2 * t + (e & 1);
        const int qp = qpos[e >> 1];
        bool ok = kpos < T;
        if (causal) ok = ok && kpos <= qp;
        if (window > 0) ok = ok && kpos > qp - window;
        const float val = ok ? s[nt][e] * scale : REPRO_NEG_INF;
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
    for (int nt = 0; nt < kBK / 8; ++nt)
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
    for (int kk = 0; kk < kBK / 16; ++kk) {
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

  const float l0 = l[0] == 0.0f ? 1.0f : l[0];
  const float l1 = l[1] == 0.0f ? 1.0f : l[1];
  __nv_bfloat16* ob = o + (size_t)(b * Hq + h) * S * kD;
  const int row0 = q0 + wr + g, row1 = row0 + 8;
#pragma unroll
  for (int dn = 0; dn < kD / 8; ++dn) {
    const int col = dn * 8 + 2 * t;
    if (row0 < S)
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)row0 * kD + col) =
          __floats2bfloat162_rn(acc[dn][0] / l0, acc[dn][1] / l0);
    if (row1 < S)
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)row1 * kD + col) =
          __floats2bfloat162_rn(acc[dn][2] / l1, acc[dn][3] / l1);
  }
}

}  // namespace

// q [B,Hq,S,D], k/v [B,Hkv,T,D], o [B,Hq,S,D], all bf16 and contiguous, D = 64,
// S <= T, Hq % Hkv == 0.  window <= 0 means no window.  Returns the cudaError_t.
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v, void* o, int B,
                                     int Hq, int Hkv, int S, int T, int D, float scale,
                                     int causal, int window, void* stream) {
  if (D != kD || B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv || S <= 0 || S > T)
    return (int)cudaErrorInvalidValue;
  dim3 grid((S + kBQ - 1) / kBQ, Hq, B);
  fa_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), Hq, Hkv, S, T, scale,
      causal, window);
  return (int)cudaGetLastError();
}
