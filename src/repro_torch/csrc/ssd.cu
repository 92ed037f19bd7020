// Mamba-2 SSD chunked scan for Hopper.  For each sequence b and head h, over
// chunks of kQ rows (cum = running sum of dt*a inside the chunk):
//   y_intra = (C B^T * exp(min(cum_i - cum_j, 0)) * [i >= j]) (dt x)
//   y_inter = exp(cum) * (C h_prev^T)
//   h       = exp(cum_last) h_prev + ((dt x) * exp(cum_last - cum))^T B
// in f32, with y bf16 [B,S,H,P] and the final state f32 [B,H,P,N].  Heads
// share B/C by group (g = h / (H/G)).
//
// Replaces the Pallas TPU kernel repro/kernels/ssd.py::ssd (_ssd_kernel).
// At the serving shapes (H 48, P 64, N 128, G 1) the inputs are a few MB and
// the products about 2 GFLOP at S = 600: on the tensor cores the work is
// small, and what bounds a call is the carry, the one sequential part, and
// how many SMs the chunks keep busy.  A kernel that walks each head's chunks
// in order in one block (192 blocks, scalar f32 FMAs, four barriers a 16-row
// chunk) is bound by that walk.  This design:
//   - chunk-parallel: one block per (chunk of 64 rows, sequence, head, slice
//     of up to 64 head-dim columns), 480 blocks at S = 600.  A block computes
//     everything of its chunk that needs no earlier chunk first -- the
//     chunk's own state s_c = ((dt x) * exp(cum_last - cum))^T B, C B^T and
//     y_intra -- then waits for h_{c-1}, writes h_c = exp(cum_last) h_{c-1}
//     + s_c for the next chunk, and adds exp(cum) C h_{c-1}^T to y;
//   - the carry is a chained scan in one launch: h_c goes to a slot in
//     device memory (the final state's layout; the last chunk writes the
//     state itself) and a per-(sequence, head, slice) flag counts the chunks
//     published: a CTA barrier, then one thread's release store, and the
//     waiting block's one thread's acquire load, then a barrier (no
//     per-thread fences).  Blocks take tickets from an atomic counter in
//     chunk order, so a block only waits on a block that is already running
//     or done; the last ticket resets the counter and the last chunk its
//     flag, so calls repeat bitwise and can be captured in a CUDA graph;
//   - a link of the chain is short: s_c waits in shared memory, and the
//     carry is one coalesced pass of 16-byte loads of h_{c-1} (all issued
//     before the first store of h_c) and stores of h_c; h_{c-1}'s bf16 parts
//     for C h^T are written after the release;
//   - every product on the tensor cores (mma.sync m16n8k16, f32 sums) at
//     the precision the f32 limits need: B, C and x are exact in bf16, and
//     each product's f32 operand is split in two bf16 parts (hi = bf16(v),
//     lo = bf16(v - hi), 16 bits of mantissa): C B^T one pass; M' x two,
//     with M' = C B^T * decay * mask * dt_j folding dt into M's columns;
//     x^T (w B) two, w_j = dt_j exp(cum_last - cum_j); C h^T two.  One bf16
//     pass would round the state by about 1e-3 relative, the limit;
//   - C B^T is recomputed in each (head, slice) block: on the tensor cores it
//     is 1 MFLOP, about 0.3 us of one SM, where sharing it across heads would
//     take a second pass through device memory;
//   - causal tiles that the mask zeroes (j > i) are neither multiplied nor
//     read; rows past S are dt = 0 rows, which neither decay the state nor
//     add to it: the last chunk's 16-row tiles wholly past S are neither
//     loaded nor multiplied (a prompt of 5 rows does one tile's work), the
//     rest of its last tile is zero-filled, and nothing past S is read or
//     written (the Pallas kernel raises when its chunk does not divide S);
//     no block waits on the last chunk, so it publishes no flag;
//   - the chunk's B and C rows, then its x rows, arrive by cp.async in two
//     groups; the decay scan runs while they are in flight.  A block owns one
//     chunk, so there is no next chunk of its own to prefetch: two blocks an
//     SM (111 KB of shared memory each) overlap one's loads with the other's
//     products;
//   - x, B and C are read through batch and row strides, so the model passes
//     slices of its conv output without copies.
#include "common.cuh"

namespace {

constexpr int kQ = 64;            // rows of a chunk
constexpr int kPs = 64;           // head-dim columns of a block, at most
constexpr int kMaxN = 128;
constexpr int kThreads = 128;     // four warps, 16 chunk rows (or state rows) each
constexpr int kLdX = kPs + 8;     // padded smem rows (bf16): 16-byte aligned,
constexpr int kLdB = kMaxN + 8;   // conflict-free ldmatrix
constexpr int kLdS = kMaxN + 4;   // padded f32 row of s_c

struct Smem {
  __nv_bfloat16 x[kQ][kLdX];
  __nv_bfloat16 b[kQ][kLdB];
  __nv_bfloat16 c[kQ][kLdB];
  // w B split in two bf16 parts (for s_c), then h_{c-1} split (for C h^T)
  __nv_bfloat16 hi[kQ][kLdB];
  __nv_bfloat16 lo[kQ][kLdB];
  float sc[kPs][kLdS];            // s_c, for the carry's coalesced pass
  float cum[kQ];
  float dt[kQ];
  float w[kQ];
  int ticket;
};

__device__ __forceinline__ void split_bf16(float v, __nv_bfloat16& hi, __nv_bfloat16& lo) {
  hi = __float2bfloat16_rn(v);
  lo = __float2bfloat16_rn(v - __bfloat162float(hi));
}

// a = bf16 parts of (v0, v1) in one register each
__device__ __forceinline__ void split_pack(float v0, float v1, uint32_t& hi, uint32_t& lo) {
  __nv_bfloat16 h0, l0, h1, l1;
  split_bf16(v0, h0, l0);
  split_bf16(v1, h1, l1);
  hi = pack_raw(__bfloat16_as_ushort(h0), __bfloat16_as_ushort(h1));
  lo = pack_raw(__bfloat16_as_ushort(l0), __bfloat16_as_ushort(l1));
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

// counters: [0] the ticket counter, [1 + unit] the chunks of unit (b, h,
// slice) published; all zero between launches.  hslot [B,H,P,N] f32: h_c of
// the chunk last published.
__global__ void __launch_bounds__(kThreads, 2)
    ssd_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ a_log,
               const __nv_bfloat16* __restrict__ bm, const __nv_bfloat16* __restrict__ cm,
               const float* __restrict__ dt, __nv_bfloat16* __restrict__ y,
               float* __restrict__ state, float* __restrict__ hslot, int* __restrict__ counters,
               int B, int S, int H, int P, int G, int N, long long x_sb, long long x_ss,
               long long b_sb, long long b_ss, long long c_sb, long long c_ss) {
  extern __shared__ __align__(16) unsigned char ssd_smem[];
  Smem& s = *reinterpret_cast<Smem*>(ssd_smem);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g8 = lane / 4, t4 = lane % 4;

  // the block's work, in ticket order: every unit's chunk c before chunk c + 1
  if (tid == 0) {
    const int t = atomicAdd(counters, 1);
    if (t == (int)gridDim.x - 1) atomicExch(counters, 0);  // every ticket is taken
    s.ticket = t;
  }
  __syncthreads();
  const int n_ps = (P + kPs - 1) / kPs;
  const int units = B * H * n_ps;
  const int chunk = s.ticket / units, unit = s.ticket % units;
  const int slice = unit % n_ps, h = (unit / n_ps) % H, bb = unit / (n_ps * H);
  const int p0 = slice * kPs, Pb = min(kPs, P - p0);
  const int grp = h / (H / G);
  const int s0 = chunk * kQ;
  const bool last = s0 + kQ >= S;
  // the 16-row tiles of the chunk that hold rows inside S: the others are
  // dt = 0 rows, which add nothing, so they are neither read nor multiplied
  const int tiles = min(kQ, S - s0 + 15) / 16, rows = 16 * tiles;
  const float a = a_log[h];

  // B and C rows (group 0), then x rows (group 1); rows past S zero-filled
  {
    const __nv_bfloat16* bbase = bm + bb * b_sb + (size_t)grp * N;
    const __nv_bfloat16* cbase = cm + bb * c_sb + (size_t)grp * N;
    const int vecs = N / 8;
    for (int e = tid; e < rows * vecs; e += kThreads) {
      const int j = e / vecs, n = (e % vecs) * 8;
      const bool ok = s0 + j < S;
      cp_async16(&s.b[j][n], ok ? bbase + (s0 + j) * b_ss + n : bbase, ok);
      cp_async16(&s.c[j][n], ok ? cbase + (s0 + j) * c_ss + n : cbase, ok);
    }
    cp_async_commit();
    const __nv_bfloat16* xbase = x + bb * x_sb + (size_t)h * P + p0;
    const int xv = Pb / 8;
    for (int e = tid; e < rows * xv; e += kThreads) {
      const int j = e / xv, p = (e % xv) * 8;
      const bool ok = s0 + j < S;
      cp_async16(&s.x[j][p], ok ? xbase + (s0 + j) * x_ss + p : xbase, ok);
    }
    cp_async_commit();
  }

  // the running log-decay: an inclusive scan over the chunk's rows
  if (tid < kQ) {
    const float d = s0 + tid < S ? dt[((size_t)bb * S + s0 + tid) * H + h] : 0.0f;
    s.dt[tid] = d;
    float v = d * a;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float o = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += o;
    }
    s.cum[tid] = v;
  }
  __syncthreads();
  if (tid >= 32 && tid < kQ) s.cum[tid] += s.cum[31];
  __syncthreads();
  const float cl = s.cum[kQ - 1];
  if (tid < kQ) s.w[tid] = s.dt[tid] * expf(cl - s.cum[tid]);
  cp_async_wait<1>();  // this thread's B and C rows
  __syncthreads();

  // w B in two bf16 parts
  {
    const int vecs = N / 8;
    for (int e = tid; e < rows * vecs; e += kThreads) {
      const int j = e / vecs, n = (e % vecs) * 8;
      const float wj = s.w[j];
      const uint4 raw = *reinterpret_cast<const uint4*>(&s.b[j][n]);
      const __nv_bfloat16* v = reinterpret_cast<const __nv_bfloat16*>(&raw);
      __align__(16) __nv_bfloat16 hv[8], lv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) split_bf16(wj * __bfloat162float(v[i]), hv[i], lv[i]);
      *reinterpret_cast<uint4*>(&s.hi[j][n]) = *reinterpret_cast<const uint4*>(hv);
      *reinterpret_cast<uint4*>(&s.lo[j][n]) = *reinterpret_cast<const uint4*>(lv);
    }
  }
  cp_async_wait<0>();  // and x
  __syncthreads();

  // s_c = x^T (w B): warp w owns state rows 16w.. of the slice
  if (16 * warp < Pb) {
    float sacc[kMaxN / 8][4];
#pragma unroll
    for (int i = 0; i < kMaxN / 8; ++i) sacc[i][0] = sacc[i][1] = sacc[i][2] = sacc[i][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < kQ / 16; ++kk) {
      if (kk >= tiles) break;
      uint32_t af[4];
      ldsm_x4_trans(af, &s.x[16 * kk + (lane % 8) + (lane / 16) * 8][16 * warp + ((lane / 8) % 2) * 8]);
      const int kr = 16 * kk + (lane % 8) + ((lane / 8) % 2) * 8;
#pragma unroll
      for (int np = 0; np < kMaxN / 16; ++np) {
        if (16 * np >= N) break;
        const int kc = 16 * np + (lane / 16) * 8;
        uint32_t bh[4], bl[4];
        ldsm_x4_trans(bh, &s.hi[kr][kc]);
        ldsm_x4_trans(bl, &s.lo[kr][kc]);
        mma_bf16_16816(sacc[2 * np], af, bh[0], bh[1]);
        mma_bf16_16816(sacc[2 * np + 1], af, bh[2], bh[3]);
        mma_bf16_16816(sacc[2 * np], af, bl[0], bl[1]);
        mma_bf16_16816(sacc[2 * np + 1], af, bl[2], bl[3]);
      }
    }
#pragma unroll
    for (int nt = 0; nt < kMaxN / 8; ++nt) {
      if (8 * nt >= N) break;
      const int r = 16 * warp + g8, col = 8 * nt + 2 * t4;
      *reinterpret_cast<float2*>(&s.sc[r][col]) = make_float2(sacc[nt][0], sacc[nt][1]);
      *reinterpret_cast<float2*>(&s.sc[r + 8][col]) = make_float2(sacc[nt][2], sacc[nt][3]);
    }
  }

  // y_intra = M' x, M' = C B^T * exp(min(cum_i - cum_j, 0)) * [i >= j] * dt_j;
  // warp w owns chunk rows 16w.., and only key tiles j < 16(w + 1) are live
  float yacc[kPs / 8][4];
#pragma unroll
  for (int i = 0; i < kPs / 8; ++i) yacc[i][0] = yacc[i][1] = yacc[i][2] = yacc[i][3] = 0.0f;
  if (warp < tiles) {
    float gacc[kQ / 8][4];
#pragma unroll
    for (int i = 0; i < kQ / 8; ++i) gacc[i][0] = gacc[i][1] = gacc[i][2] = gacc[i][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < kMaxN / 16; ++kk) {
      if (16 * kk >= N) break;
      uint32_t af[4];
      ldsm_x4(af, &s.c[16 * warp + (lane % 16)][16 * kk + (lane / 16) * 8]);
#pragma unroll
      for (int np = 0; np < kQ / 16; ++np) {
        if (np > warp) break;
        uint32_t bf[4];
        ldsm_x4(bf, &s.b[16 * np + (lane % 8) + (lane / 16) * 8][16 * kk + ((lane / 8) % 2) * 8]);
        mma_bf16_16816(gacc[2 * np], af, bf[0], bf[1]);
        mma_bf16_16816(gacc[2 * np + 1], af, bf[2], bf[3]);
      }
    }
    const int i0 = 16 * warp + g8, i1 = i0 + 8;
    const float ci0 = s.cum[i0], ci1 = s.cum[i1];
#pragma unroll
    for (int kk = 0; kk < kQ / 16; ++kk) {
      if (kk > warp) break;
      float m[2][4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e < 2 ? i0 : i1;
          const int j = 16 * kk + 8 * half + 2 * t4 + (e & 1);
          const float ci = e < 2 ? ci0 : ci1;
          m[half][e] = j <= i ? gacc[2 * kk + half][e] * expf(fminf(ci - s.cum[j], 0.0f)) * s.dt[j]
                              : 0.0f;
        }
      }
      uint32_t ah[4], al[4];
      split_pack(m[0][0], m[0][1], ah[0], al[0]);
      split_pack(m[0][2], m[0][3], ah[1], al[1]);
      split_pack(m[1][0], m[1][1], ah[2], al[2]);
      split_pack(m[1][2], m[1][3], ah[3], al[3]);
      const int kr = 16 * kk + (lane % 8) + ((lane / 8) % 2) * 8;
#pragma unroll
      for (int np = 0; np < kPs / 16; ++np) {
        if (16 * np >= Pb) break;
        uint32_t xf[4];
        ldsm_x4_trans(xf, &s.x[kr][16 * np + (lane / 16) * 8]);
        mma_bf16_16816(yacc[2 * np], ah, xf[0], xf[1]);
        mma_bf16_16816(yacc[2 * np + 1], ah, xf[2], xf[3]);
        mma_bf16_16816(yacc[2 * np], al, xf[0], xf[1]);
        mma_bf16_16816(yacc[2 * np + 1], al, xf[2], xf[3]);
      }
    }
  }

  // the carry: wait for h_{c-1}, publish h_c = exp(cum_last) h_{c-1} + s_c
  int* flag = counters + 1 + unit;
  if (chunk > 0 && tid == 0) {
    // a chain that has not moved in seconds is a fault: stop the launch
    // with an error rather than hang the card
    for (long long spins = 0; ld_acquire(flag) < chunk; ++spins) {
      if (spins > (1LL << 27)) __trap();
      __nanosleep(32);
    }
  }
  // h_{c-1} is visible, s_c is in shared memory, and every warp is done
  // with w B (its space takes h_{c-1}'s parts below)
  __syncthreads();
  // one coalesced pass over the slice's [Pb, N] tile, every load of h_{c-1}
  // before the first store of h_c (the slot is updated in place)
  constexpr int kIt = kPs * kMaxN / 4 / kThreads;
  const int nv = N / 4, n_vec = Pb * nv;
  float4 hp[kIt];
  {
    const size_t base = (((size_t)bb * H + h) * P + p0) * N;
    const float4* src = reinterpret_cast<const float4*>(hslot + base);
    float4* dst = reinterpret_cast<float4*>((last ? state : hslot) + base);
    const float el = expf(cl);
#pragma unroll
    for (int i = 0; i < kIt; ++i) {
      const int e = tid + i * kThreads;
      hp[i] = chunk > 0 && e < n_vec ? __ldcg(src + e) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
#pragma unroll
    for (int i = 0; i < kIt; ++i) {
      const int e = tid + i * kThreads;
      if (e >= n_vec) break;
      const float4 sv = *reinterpret_cast<const float4*>(&s.sc[e / nv][(e % nv) * 4]);
      __stcg(dst + e, make_float4(fmaf(el, hp[i].x, sv.x), fmaf(el, hp[i].y, sv.y),
                                  fmaf(el, hp[i].z, sv.z), fmaf(el, hp[i].w, sv.w)));
    }
  }
  if (!last) {
    // the barrier orders every thread's h_c before thread 0's release (a
    // release after a CTA barrier is cumulative)
    __syncthreads();
    if (tid == 0) st_release(flag, chunk + 1);
  } else if (chunk > 0 && tid == 0) {
    *flag = 0;  // no block waits on the last chunk: leave the flag zeroed
  }

  // y = y_intra + exp(cum_i) C h_{c-1}^T, rows inside S
  const int i0 = 16 * warp + g8, i1 = i0 + 8;
  float iacc[kPs / 8][4];
#pragma unroll
  for (int i = 0; i < kPs / 8; ++i) iacc[i][0] = iacc[i][1] = iacc[i][2] = iacc[i][3] = 0.0f;
  if (chunk > 0) {
    // h_{c-1} in two bf16 parts, off the chain: h_c is out
#pragma unroll
    for (int i = 0; i < kIt; ++i) {
      const int e = tid + i * kThreads;
      if (e >= n_vec) break;
      const int r = e / nv, n = (e % nv) * 4;
      __align__(8) __nv_bfloat16 hv[4], lv[4];
      split_bf16(hp[i].x, hv[0], lv[0]);
      split_bf16(hp[i].y, hv[1], lv[1]);
      split_bf16(hp[i].z, hv[2], lv[2]);
      split_bf16(hp[i].w, hv[3], lv[3]);
      *reinterpret_cast<uint2*>(&s.hi[r][n]) = *reinterpret_cast<const uint2*>(hv);
      *reinterpret_cast<uint2*>(&s.lo[r][n]) = *reinterpret_cast<const uint2*>(lv);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kMaxN / 16; ++kk) {
      if (16 * kk >= N || warp >= tiles) break;
      uint32_t af[4];
      ldsm_x4(af, &s.c[16 * warp + (lane % 16)][16 * kk + (lane / 16) * 8]);
      const int kc = 16 * kk + ((lane / 8) % 2) * 8;
#pragma unroll
      for (int np = 0; np < kPs / 16; ++np) {
        if (16 * np >= Pb) break;
        const int r = 16 * np + (lane % 8) + (lane / 16) * 8;
        uint32_t hf[4], lf[4];
        ldsm_x4(hf, &s.hi[r][kc]);
        ldsm_x4(lf, &s.lo[r][kc]);
        mma_bf16_16816(iacc[2 * np], af, hf[0], hf[1]);
        mma_bf16_16816(iacc[2 * np + 1], af, hf[2], hf[3]);
        mma_bf16_16816(iacc[2 * np], af, lf[0], lf[1]);
        mma_bf16_16816(iacc[2 * np + 1], af, lf[2], lf[3]);
      }
    }
  }
  const float e0 = expf(s.cum[i0]), e1 = expf(s.cum[i1]);
  __nv_bfloat16* yb = y + (((size_t)bb * S + s0) * H + h) * P + p0;  // row i at + i*H*P
#pragma unroll
  for (int nt = 0; nt < kPs / 8; ++nt) {
    if (8 * nt >= Pb) break;
    const int col = 8 * nt + 2 * t4;
    if (s0 + i0 < S)
      *reinterpret_cast<__nv_bfloat162*>(yb + (size_t)i0 * H * P + col) = __floats2bfloat162_rn(
          fmaf(e0, iacc[nt][0], yacc[nt][0]), fmaf(e0, iacc[nt][1], yacc[nt][1]));
    if (s0 + i1 < S)
      *reinterpret_cast<__nv_bfloat162*>(yb + (size_t)i1 * H * P + col) = __floats2bfloat162_rn(
          fmaf(e1, iacc[nt][2], yacc[nt][2]), fmaf(e1, iacc[nt][3], yacc[nt][3]));
  }
}

}  // namespace

// x [B,S,H,P] and b, c [B,S,G,N] bf16, read through their batch and row
// strides (elements; the last two dims packed, 16-byte aligned rows);
// a_log [H] and dt [B,S,H] f32, packed.  Writes y [B,S,H,P] bf16 and the
// final state [B,H,P,N] f32, packed.  hslot: B*H*P*N f32 of scratch;
// counters: 1 + B*H*ceil(P/64) zeroed ints used by no other stream (left
// zeroed).  One launch.  Returns the cudaError_t of the launch.
extern "C" int repro_ssd(const void* x, const void* a_log, const void* b, const void* c,
                         const void* dt, void* y, void* state, void* hslot, void* counters, int B,
                         int S, int H, int P, int G, int N, long long x_sb, long long x_ss,
                         long long b_sb, long long b_ss, long long c_sb, long long c_ss,
                         void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || G <= 0 || H % G || P <= 0 || P % 16 || N <= 0 || N % 16 ||
      N > kMaxN || hslot == nullptr || counters == nullptr)
    return (int)cudaErrorInvalidValue;
  const long long blocks =
      (long long)((S + kQ - 1) / kQ) * B * H * ((P + kPs - 1) / kPs);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  static const cudaError_t set = cudaFuncSetAttribute(
      ssd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sizeof(Smem));
  if (set != cudaSuccess) return (int)set;
  ssd_kernel<<<(unsigned)blocks, kThreads, sizeof(Smem), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(a_log),
      static_cast<const __nv_bfloat16*>(b), static_cast<const __nv_bfloat16*>(c),
      static_cast<const float*>(dt), static_cast<__nv_bfloat16*>(y), static_cast<float*>(state),
      static_cast<float*>(hslot), static_cast<int*>(counters), B, S, H, P, G, N, x_sb, x_ss, b_sb,
      b_ss, c_sb, c_ss);
  return (int)cudaGetLastError();
}
