// Mamba-2 SSD chunked scan for Hopper.  For each sequence b and head h, over
// chunks of kQ rows (cum = running sum of dt*a inside the chunk):
//   y_intra = (C B^T * exp(min(cum_i - cum_j, 0)) * [i >= j]) (dt x)
//   y_inter = exp(cum) * (C h_prev^T)
//   h       = exp(cum_last) h_prev + ((dt x) * exp(cum_last - cum))^T B
// in f32, with y bf16 [B,S,H,P] and the final state f32 [B,H,P,N].  Heads
// share B/C by group (g = h / (H/G)).
//
// Replaces the Pallas TPU kernel repro/kernels/ssd.py::ssd (_ssd_kernel).
// At the serving shapes (H 48, P 64, N 128, G 1) the inputs are a few MB
// and the body some 39 thousand f32 flops per (row, head): it is bound by
// operations, on the CUDA cores, since the Pallas kernel keeps f32 inside
// (a bf16 tensor-core product of the decayed, f32 terms would round them).
// Its design:
//   - the TPU's sequential chunk axis becomes a loop inside the block, and
//     its parallel (b, h) grid a grid of blocks, each also taking one slice
//     of kPs head-dim columns: the state's rows are independent (y[:, p]
//     needs only x[:, p] and h[p, :]), so a prompt gives 48 x 4 = 192 blocks
//     for 132 SMs, not 48.  Each slice recomputes the chunk's C B^T, so the
//     inner chunk is short (kQ = 16): that term grows with the chunk;
//   - B and C rows (bf16 read with 16-byte loads, stored as f32) and dt x in
//     shared memory, rows padded to kLd floats so float4 reads of 8 rows hit
//     distinct banks; the [kPs, N] state tile lives in registers (2 rows x
//     N/16 columns a thread) and is mirrored, double-buffered, to shared
//     memory for the next chunk's C h^T;
//   - any S: rows past S in the last chunk read as dt = 0 rows, which
//     neither decay the state nor add to it; nothing past S is read or
//     written (the Pallas kernel raises when its chunk does not divide S);
//   - x, B and C are read through batch and row strides, so the model
//     passes slices of its conv output without copies.
// Four barriers a chunk.  wgmma (with B and C exact in bf16 and the f32
// terms split in two bf16 halves), TMA and one C B^T per head are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kQ = 16;            // rows of the inner chunk
constexpr int kPs = 16;           // head-dim columns per block
constexpr int kThreads = 128;
constexpr int kMaxN = 128;
constexpr int kLd = kMaxN + 4;    // padded shared row of B, C and the state (floats)
constexpr int kNk = kMaxN / 16;   // state columns a thread owns, at most

struct Smem {
  float b[kQ][kLd];
  float c[kQ][kLd];
  float h[2][kPs][kLd];           // the state before a chunk, double-buffered
  float dtx[kQ][kPs];             // dt * x
  float u[kQ][kPs];               // dt * x * exp(cum_last - cum)
  float m[kQ][kQ + 1];            // C B^T, decayed and masked
  float cum[kQ];
};

__device__ __forceinline__ float dot4(float acc, const float4& a, const float4& b) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__global__ void __launch_bounds__(kThreads)
    ssd_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ a_log,
               const __nv_bfloat16* __restrict__ bm, const __nv_bfloat16* __restrict__ cm,
               const float* __restrict__ dt, __nv_bfloat16* __restrict__ y,
               float* __restrict__ state, int S, int H, int P, int G, int N,
               long long x_sb, long long x_ss, long long b_sb, long long b_ss, long long c_sb,
               long long c_ss) {
  __shared__ __align__(16) Smem s;
  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * kPs;
  const int h = blockIdx.y;
  const int bb = blockIdx.z;
  const int g = h / (H / G);
  const float a = a_log[h];
  const int nk = N / 16;
  const int vecs = N / 8;         // 16-byte vectors in a row of B or C

  const __nv_bfloat16* xb = x + bb * x_sb + (size_t)h * P + p0;      // row s at + s*x_ss
  const __nv_bfloat16* bbase = bm + bb * b_sb + (size_t)g * N;       // row s at + s*b_ss
  const __nv_bfloat16* cbase = cm + bb * c_sb + (size_t)g * N;
  const float* dtb = dt + (size_t)bb * S * H + h;                      // row s at + s*H
  __nv_bfloat16* yb = y + ((size_t)bb * S * H + h) * P + p0;         // row s at + s*H*P

  // the state tile in registers: rows sp, sp + 1; columns sn + 16k
  const int sp = 2 * (tid / 16), sn = tid % 16;
  float hr[2][kNk];
#pragma unroll
  for (int k = 0; k < kNk; ++k) hr[0][k] = hr[1][k] = 0.0f;
  for (int e = tid; e < kPs * kLd; e += kThreads) (&s.h[0][0][0])[e] = 0.0f;
  // C B^T entries (gi, gj) and (gi + 8, gj); outputs (yi, yp) and (yi, yp + 8)
  const int gi = tid / 16, gj = tid % 16;
  const int yi = tid / 8, yp = tid % 8;

  const int n_chunks = (S + kQ - 1) / kQ;
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int s0 = ch * kQ;
    const int buf = ch & 1;
    __syncthreads();  // the previous chunk's readers are done
    for (int e = tid; e < kQ * vecs; e += kThreads) {
      const int j = e / vecs, n = (e % vecs) * 8;
      float fb[8], fc[8];
      if (s0 + j < S) {
        const uint4 ub = *reinterpret_cast<const uint4*>(bbase + (s0 + j) * b_ss + n);
        const uint4 uc = *reinterpret_cast<const uint4*>(cbase + (s0 + j) * c_ss + n);
        const __nv_bfloat162* pb = reinterpret_cast<const __nv_bfloat162*>(&ub);
        const __nv_bfloat162* pc = reinterpret_cast<const __nv_bfloat162*>(&uc);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 vb = __bfloat1622float2(pb[i]);
          const float2 vc = __bfloat1622float2(pc[i]);
          fb[2 * i] = vb.x;
          fb[2 * i + 1] = vb.y;
          fc[2 * i] = vc.x;
          fc[2 * i + 1] = vc.y;
        }
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) fb[i] = fc[i] = 0.0f;
      }
      float4* db = reinterpret_cast<float4*>(&s.b[j][n]);
      float4* dc = reinterpret_cast<float4*>(&s.c[j][n]);
      db[0] = make_float4(fb[0], fb[1], fb[2], fb[3]);
      db[1] = make_float4(fb[4], fb[5], fb[6], fb[7]);
      dc[0] = make_float4(fc[0], fc[1], fc[2], fc[3]);
      dc[1] = make_float4(fc[4], fc[5], fc[6], fc[7]);
    }
    for (int e = tid; e < kQ * kPs; e += kThreads) {
      const int j = e / kPs, p = e % kPs;
      s.dtx[j][p] = s0 + j < S
                        ? dtb[(size_t)(s0 + j) * H] * __bfloat162float(xb[(s0 + j) * x_ss + p])
                        : 0.0f;
    }
    __syncthreads();

    // the running log-decay (warp 0: an inclusive scan over the chunk's rows)
    if (tid < 32) {
      float v = (tid < kQ && s0 + tid < S) ? dtb[(size_t)(s0 + tid) * H] * a : 0.0f;
#pragma unroll
      for (int off = 1; off < kQ; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, v, off);
        if (tid >= off) v += o;
      }
      if (tid < kQ) s.cum[tid] = v;
    }
    // C B^T, every thread two entries
    float g0 = 0.0f, g1 = 0.0f;
    for (int n = 0; n < N; n += 4) {
      const float4 bj = *reinterpret_cast<const float4*>(&s.b[gj][n]);
      g0 = dot4(g0, *reinterpret_cast<const float4*>(&s.c[gi][n]), bj);
      g1 = dot4(g1, *reinterpret_cast<const float4*>(&s.c[gi + 8][n]), bj);
    }
    __syncthreads();

    // decay and mask C B^T; the carry weights of dt x.  The exponent is
    // clamped to <= 0: valid pairs (i >= j) always are, and the upper
    // triangle would overflow exp, and 0 * inf is NaN.
    s.m[gi][gj] = gi >= gj ? g0 * expf(fminf(s.cum[gi] - s.cum[gj], 0.0f)) : 0.0f;
    s.m[gi + 8][gj] = gi + 8 >= gj ? g1 * expf(fminf(s.cum[gi + 8] - s.cum[gj], 0.0f)) : 0.0f;
    const float cl = s.cum[kQ - 1];
    for (int e = tid; e < kQ * kPs; e += kThreads) {
      const int j = e / kPs, p = e % kPs;
      s.u[j][p] = s.dtx[j][p] * expf(cl - s.cum[j]);
    }
    __syncthreads();

    // y = M (dt x) + exp(cum) (C h_prev^T), for rows inside S
    {
      float y0 = 0.0f, y1 = 0.0f;
      for (int j = 0; j <= yi; ++j) {
        const float mv = s.m[yi][j];
        y0 = fmaf(mv, s.dtx[j][yp], y0);
        y1 = fmaf(mv, s.dtx[j][yp + 8], y1);
      }
      float i0 = 0.0f, i1 = 0.0f;
      for (int n = 0; n < N; n += 4) {
        const float4 cv = *reinterpret_cast<const float4*>(&s.c[yi][n]);
        i0 = dot4(i0, cv, *reinterpret_cast<const float4*>(&s.h[buf][yp][n]));
        i1 = dot4(i1, cv, *reinterpret_cast<const float4*>(&s.h[buf][yp + 8][n]));
      }
      const float ec = expf(s.cum[yi]);
      if (s0 + yi < S) {
        __nv_bfloat16* row = yb + (size_t)(s0 + yi) * H * P;
        row[yp] = __float2bfloat16(fmaf(ec, i0, y0));
        row[yp + 8] = __float2bfloat16(fmaf(ec, i1, y1));
      }
    }
    // h = exp(cum_last) h + u^T B, mirrored for the next chunk's C h^T
    {
      const float el = expf(cl);
#pragma unroll
      for (int k = 0; k < kNk; ++k) {
        if (k < nk) {
          hr[0][k] *= el;
          hr[1][k] *= el;
        }
      }
      for (int j = 0; j < kQ; ++j) {
        const float u0 = s.u[j][sp], u1 = s.u[j][sp + 1];
#pragma unroll
        for (int k = 0; k < kNk; ++k) {
          if (k < nk) {
            const float bv = s.b[j][sn + 16 * k];
            hr[0][k] = fmaf(u0, bv, hr[0][k]);
            hr[1][k] = fmaf(u1, bv, hr[1][k]);
          }
        }
      }
#pragma unroll
      for (int k = 0; k < kNk; ++k) {
        if (k < nk) {
          s.h[buf ^ 1][sp][sn + 16 * k] = hr[0][k];
          s.h[buf ^ 1][sp + 1][sn + 16 * k] = hr[1][k];
        }
      }
    }
  }

  float* st = state + (((size_t)bb * H + h) * P + p0 + sp) * N + sn;
#pragma unroll
  for (int k = 0; k < kNk; ++k) {
    if (k < nk) {
      st[16 * k] = hr[0][k];
      st[N + 16 * k] = hr[1][k];
    }
  }
}

}  // namespace

// x [B,S,H,P] and b, c [B,S,G,N] bf16, read through their batch and row
// strides (elements; the last two dims packed, 16-byte aligned rows);
// a_log [H] and dt [B,S,H] f32, packed.  Writes y [B,S,H,P] bf16 and the
// final state [B,H,P,N] f32, packed.  Returns the cudaError_t of the launch.
extern "C" int repro_ssd(const void* x, const void* a_log, const void* b, const void* c,
                         const void* dt, void* y, void* state, int B, int S, int H, int P, int G,
                         int N, long long x_sb, long long x_ss, long long b_sb, long long b_ss,
                         long long c_sb, long long c_ss, void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || H <= 0 || H > 65535 || G <= 0 || H % G || P <= 0 ||
      P % kPs || N <= 0 || N % 16 || N > kMaxN)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(P / kPs, H, B);
  ssd_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(a_log),
      static_cast<const __nv_bfloat16*>(b), static_cast<const __nv_bfloat16*>(c),
      static_cast<const float*>(dt), static_cast<__nv_bfloat16*>(y), static_cast<float*>(state),
      S, H, P, G, N, x_sb, x_ss, b_sb, b_ss, c_sb, c_ss);
  return (int)cudaGetLastError();
}
