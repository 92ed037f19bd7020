// Temperature sampling for Hopper: JAX's position-indexed categorical draw, one token a slot.
//
// Replaces jax.random.categorical inside the JAX engine's fused decode scan
// (repro/serve/engine.py, _fused_decode_fn's sample): token t of a request is
//   argmax_i( -log(-log(u_i)) + logits_i / T ),  u = uniform(bits(fold_in(key, t)), tiny, 1)
// with JAX's Threefry-2x32 stream in its partitionable mode (jax/_src/prng.py):
//   fold_in(key, t)     = threefry2x32(key, (0, t))
//   bits_i              = y0 ^ y1 of threefry2x32(step key, (0, i))
//   u_i                 = float((bits_i >> 9) | 0x3F800000) - 1, plus tiny, at least tiny
// and the first index among equal maxima, as jnp.argmax (NaN above every number).  The
// integer parts give JAX's bits exactly; a score that can decide the token is computed with
// the accurate logf (not __logf) and a true division, so it equals the plain version's
// (repro_torch/serve/sampling.py) up to logf's last ulp.
//
// What bounds it: operations.  A logit is 4 bytes, but its random bits take 20 Threefry
// rounds (an add, a funnel shift and a xor each): about 41 shifts and logic operations an
// element, which only the integer ALU pipe runs (64 lanes an SM), against 4 bytes.  So:
// - Several elements in flight a thread.  A thread takes 4 or 8 consecutive logits (one or
//   two aligned float4 loads; a row's head and tail, off the 16-byte grid, one by one) and
//   hashes them as independent Threefry chains, which keeps the ALU pipe fed.
// - The exact score only for candidates.  Each element gets bounds lb <= score <= ub: the
//   Gumbel term's least and largest value over the element's bucket of u (by the exponent
//   and top 4 mantissa bits of d = 1 - u: fine where the term is steep, near u = 1), from a
//   table each block builds with the same logf, widened by kMargin; and l times 1/T rounded
//   down and up.  The largest lb the warp has seen is a threshold that some element's exact
//   score reaches, so an element whose ub lies below it cannot be the draw and skips the two
//   logs and the division.  Every element is hashed.
// - The whole card at every batch.  A slot's row is spread over enough blocks (grid
//   (splits, B)) that B x splits fills the SMs at B = 1 too.  A block's best becomes one
//   64-bit key (the score's order, NaN above all, then the complement of the index), merged
//   by atomicMax; the last block of the slot to arrive at its counter (acq_rel; one counter
//   and one key buffer per CUDA stream, reset by that block) reads the merged key and writes
//   the token.  The key orders as better() below, so the token does not depend on the split.
// It launches with programmatic dependent launch: a block builds its table while the kernel
// ahead on the stream finishes, and reads global memory only after it has.  A slot whose
// live flag is 0 is skipped and keeps its token.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSplits = 1024;
constexpr int kNone = 0x7fffffff;           // no element yet
constexpr float kTiny = 1.17549435e-38f;    // the smallest normal float32
// the pre-test's buckets: d = 1 - f (f the uniform before its tiny offset; d in [2^-23, 1])
// by its float bits >> 19, exponent and 4 mantissa bits: bucket 0 holds d = 2^-23 (the
// largest Gumbel term), bucket kBuckets - 1 holds d = 1 (u = tiny)
constexpr int kBucketShift = 19;
constexpr int kFirstBucket = (127 - 23) << 4;
constexpr int kBuckets = (127 << 4) - kFirstBucket + 1;
// added to each bucket's upper bound and taken from its lower: the computed Gumbel term
// strays from monotone by logf's last ulp (about 2e-6 at most; kernels/sample.py checks it)
constexpr float kMargin = 1.0f / 65536.0f;

__device__ __forceinline__ constexpr int rotation(int group, int j) {
  return (group & 1) ? (j == 0 ? 17 : j == 1 ? 29 : j == 2 ? 16 : 24)
                     : (j == 0 ? 13 : j == 1 ? 15 : j == 2 ? 26 : 6);
}

// Threefry-2x32's key schedule: the words (k0, k1, k0 ^ k1 ^ parity) and what each group of
// four rounds adds to x0 and x1 after it
struct Schedule {
  uint32_t k0, k1;
  uint32_t add0[5], add1[5];
};

__device__ __forceinline__ Schedule schedule(uint32_t k0, uint32_t k1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  Schedule s;
  s.k0 = k0;
  s.k1 = k1;
#pragma unroll
  for (int g = 0; g < 5; ++g) {
    s.add0[g] = ks[(g + 1) % 3];
    s.add1[g] = ks[(g + 2) % 3] + static_cast<uint32_t>(g + 1);
  }
  return s;
}

// Threefry-2x32, 20 rounds, over N independent counts (x0, x1), hashed in place
template <int N>
__device__ __forceinline__ void threefry(const Schedule& s, uint32_t (&x0)[N], uint32_t (&x1)[N]) {
#pragma unroll
  for (int e = 0; e < N; ++e) {
    x0[e] += s.k0;
    x1[e] += s.k1;
  }
#pragma unroll
  for (int g = 0; g < 5; ++g) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < N; ++e) {
        x0[e] += x1[e];
        x1[e] = __funnelshift_l(x1[e], x1[e], rotation(g, j));
        x1[e] ^= x0[e];
      }
    }
#pragma unroll
    for (int e = 0; e < N; ++e) {
      x0[e] += s.add0[g];
      x1[e] += s.add1[g];
    }
  }
}

// the uniform's float in [1, 2) from an element's bits: f = v - 1
__device__ __forceinline__ float one_plus_f(uint32_t r) {
  return __uint_as_float((r >> 9) | 0x3F800000u);
}

__device__ __forceinline__ float gumbel(float u) { return -logf(-logf(u)); }

// (a, ia) before (b, ib): the larger score, NaN above all, the smaller index on ties.
__device__ __forceinline__ bool better(float a, int ia, float b, int ib) {
  const bool na = a != a, nb = b != b;
  if (na || nb) return na && (!nb || ia < ib);
  return a > b || (a == b && ia < ib);
}

// a key whose unsigned order is better()'s: the score's order (NaN above all, -0 as +0),
// then the complement of the index
__device__ __forceinline__ uint32_t order(float s) {
  if (s != s) return 0xFFFFFFFFu;
  const uint32_t u = __float_as_uint(s + 0.0f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ unsigned long long merge_key(float s, int i) {
  return (static_cast<unsigned long long>(order(s)) << 32) |
         (0xFFFFFFFFu - static_cast<uint32_t>(i));
}

// Not launched: compiled so that cuobjdump shows the operations one element's random bits
// and uniform take in this build (chip_smoke.py counts them for the sampler's bound).
__global__ void sample_bits_ops(uint32_t* out, Schedule s) {
  uint32_t x0[1] = {0u}, x1[1] = {threadIdx.x};
  threefry<1>(s, x0, x1);
  out[threadIdx.x] = ((x0[0] ^ x1[0]) >> 9) | 0x3F800000u;
}

// One element's exact score, folded into the thread's best: the path every candidate takes.
__device__ __forceinline__ void consider(float v, float l, int i, float temperature,
                                         float& best, int& bi) {
  const float u = fmaxf((v - 1.0f) + kTiny, kTiny);
  const float score = gumbel(u) + __fdiv_rn(l, temperature);
  if (better(score, i, best, bi)) {
    best = score;
    bi = i;
  }
}

// grid (splits, B).  logits [B, V] f32; keys [B, 2] uint32; counts, live, tok [B] int32;
// bits [B, V] (the random bits, written where not null); merged [B] 64-bit keys and
// counters [B], zeroed, where splits > 1.  c_up and c_dn: 1/T rounded, one ulp up and down.
// Q: float4 groups a thread an iteration (4Q chains); kNoMargin: the planted fault, each
// upper bound taken at its bucket's lower end.
template <int Q, bool kNoMargin>
__global__ void __launch_bounds__(kThreads, 2)
    sample_kernel(const float* __restrict__ logits, const uint32_t* __restrict__ keys,
                  const int* __restrict__ counts, const int* __restrict__ live,
                  int* __restrict__ tok, uint32_t* __restrict__ bits,
                  unsigned long long* __restrict__ merged, int* __restrict__ counters, int V,
                  float temperature, float c_up, float c_dn) {
  constexpr int N = 4 * Q, kStep = Q * kThreads;
  __shared__ float2 s_bound[kBuckets];   // (upper, lower) bound of the Gumbel term
  __shared__ unsigned long long s_key[kWarps];
  const int b = blockIdx.y, split = blockIdx.x, splits = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // the term at each bucket's smallest d bounds the bucket from above, at the next
  // bucket's from below (the term falls as d grows; past d = 1, u = tiny); built while the
  // kernel ahead on the stream finishes
#pragma unroll
  for (int j = tid; j < ((kBuckets + kThreads) / kThreads) * kThreads; j += kThreads) {
    if (j <= kBuckets) {
      const float d = __uint_as_float(static_cast<uint32_t>(kFirstBucket + j) << kBucketShift);
      const float g = gumbel(fmaxf((1.0f - d) + kTiny, kTiny));
      if (j < kBuckets) s_bound[j].x = g + kMargin;
      if (j > 0) s_bound[j - 1].y = g - kMargin;
    }
  }
  grid_dependency_wait();
  launch_dependents();
  const int alive = live[b];
  const uint32_t key0 = keys[2 * b], key1 = keys[2 * b + 1];
  const uint32_t count = static_cast<uint32_t>(counts[b]);

  // the row as 16-byte quads: h head elements before the first 16-byte boundary (quad -1),
  // nq whole quads, the tail (quad nq); this block's share of them is [qlo, qhi), whole
  // quads [q0, q1) of it
  const float* row = logits + static_cast<size_t>(b) * V;
  const int h = min(V, static_cast<int>(
                           ((16u - (static_cast<uint32_t>(reinterpret_cast<uintptr_t>(row)) & 15u))
                            & 15u) >> 2));
  const int nq = (V - h) >> 2;
  const int qmin = h > 0 ? -1 : 0, total = nq + (V - h - 4 * nq > 0 ? 1 : 0) - qmin;
  const int per = (total + splits - 1) / splits;
  const int qlo = qmin + min(total, split * per), qhi = qmin + min(total, (split + 1) * per);
  const int q0 = max(qlo, 0), q1 = min(qhi, nq);
  const float4* quads = reinterpret_cast<const float4*>(row + h);
  float4 next[Q];
#pragma unroll
  for (int k = 0; k < Q; ++k) {
    const int q = q0 + k * kThreads + tid;
    next[k] = q < q1 ? __ldcs(quads + q) : make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
  }
  if (alive == 0) return;
  // this step's key: fold_in(the slot's key, its count)
  uint32_t s0[1] = {0u}, s1[1] = {count};
  threefry<1>(schedule(key0, key1), s0, s1);
  const Schedule sk = schedule(s0[0], s1[0]);
  uint32_t* brow = bits == nullptr ? nullptr : bits + static_cast<size_t>(b) * V;
  float thr = -INFINITY, best = -INFINITY;
  int bi = kNone;

  // the head's and the tail's logits (at most 3 each), one a thread, straight to the exact
  // path
  if (tid < 8) {
    const int q = tid < 4 ? -1 : nq, i = h + 4 * q + (tid & 3);
    if (q >= qlo && q < qhi && i >= 0 && i < V) {
      uint32_t x0[1] = {0u}, x1[1] = {static_cast<uint32_t>(i)};
      threefry<1>(sk, x0, x1);
      const uint32_t r = x0[0] ^ x1[0];
      if (brow != nullptr) brow[i] = r;
      consider(one_plus_f(r), __ldcs(row + i), i, temperature, best, bi);
    }
  }
  __syncthreads();

  for (int base = q0; base < q1; base += kStep) {
    float l[N];
    bool ok[Q];
#pragma unroll
    for (int k = 0; k < Q; ++k) {
      ok[k] = base + k * kThreads + tid < q1;
      l[4 * k] = next[k].x;
      l[4 * k + 1] = next[k].y;
      l[4 * k + 2] = next[k].z;
      l[4 * k + 3] = next[k].w;
    }
    if (base + kStep < q1) {   // the next group's logits, in flight while this one hashes
#pragma unroll
      for (int k = 0; k < Q; ++k) {
        const int q = base + kStep + k * kThreads + tid;
        next[k] = q < q1 ? __ldcs(quads + q)
                         : make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
      }
    }
    uint32_t x0[N], x1[N];
#pragma unroll
    for (int e = 0; e < N; ++e) {
      x0[e] = 0u;
      x1[e] = static_cast<uint32_t>(h + 4 * (base + (e / 4) * kThreads + tid) + e % 4);
    }
    threefry<N>(sk, x0, x1);
    // l / T between l * 1/T rounded down and up (each product rounded once, so the bounds
    // hold wherever the true quotient does, inf and NaN included)
    float v[N], ub[N], m = -INFINITY;
#pragma unroll
    for (int e = 0; e < N; ++e) {
      const uint32_t r = x0[e] ^ x1[e];
      if (brow != nullptr && ok[e / 4]) brow[h + 4 * (base + (e / 4) * kThreads + tid) + e % 4] = r;
      v[e] = one_plus_f(r);
      const float2 bd = s_bound[(__float_as_uint(2.0f - v[e]) >> kBucketShift) - kFirstBucket];
      const float a = __fmul_rn(l[e], c_up), c = __fmul_rn(l[e], c_dn);
      ub[e] = __fadd_rn(fmaxf(a, c), kNoMargin ? bd.y : bd.x);
      if (ok[e / 4]) m = fmaxf(m, __fadd_rn(fminf(a, c), bd.y));
    }
    thr = fmaxf(thr, m);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) thr = fmaxf(thr, __shfl_xor_sync(0xffffffffu, thr, off));
#pragma unroll
    for (int e = 0; e < N; ++e)
      if (ok[e / 4] && !(ub[e] < thr))
        consider(v[e], l[e], h + 4 * (base + (e / 4) * kThreads + tid) + e % 4, temperature,
                 best, bi);
  }

  unsigned long long key = bi == kNone ? 0ull : merge_key(best, bi);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long other = __shfl_xor_sync(0xffffffffu, key, off);
    key = other > key ? other : key;
  }
  if (lane == 0) s_key[warp] = key;
  __syncthreads();
  if (tid != 0) return;
  for (int w = 1; w < kWarps; ++w) key = s_key[w] > key ? s_key[w] : key;
  if (splits == 1) {
    tok[b] = static_cast<int>(0xFFFFFFFFu - static_cast<uint32_t>(key));
    return;
  }
  if (key != 0ull) atomicMax(merged + b, key);
  // the acq_rel count orders this block's merge before it, and the others' before the last
  int old;
  asm volatile("atom.add.acq_rel.gpu.global.s32 %0, [%1], 1;\n"
               : "=r"(old)
               : "l"(counters + b)
               : "memory");
  if (old != splits - 1) return;
  key = __ldcg(merged + b);
  tok[b] = static_cast<int>(0xFFFFFFFFu - static_cast<uint32_t>(key));
  merged[b] = 0ull;  // for the next launch on this stream
  counters[b] = 0;
}

template <int Q, bool kNoMargin>
cudaError_t launch(dim3 grid, cudaStream_t stream, const void* logits, const void* keys,
                   const void* counts, const void* live, void* tok, void* bits, void* merged,
                   void* counters, int V, float temperature, float c_up, float c_dn) {
  return launch_overlapped(
      sample_kernel<Q, kNoMargin>, grid, kThreads, 0, stream, static_cast<const float*>(logits),
      static_cast<const uint32_t*>(keys), static_cast<const int*>(counts),
      static_cast<const int*>(live), static_cast<int*>(tok), static_cast<uint32_t*>(bits),
      static_cast<unsigned long long*>(merged), static_cast<int*>(counters), V, temperature,
      c_up, c_dn);
}

}  // namespace

// logits [B, V] f32, keys [B, 2] uint32 (as int32), counts, live and tok [B] int32, all
// contiguous on one device; bits [B, V] uint32 or null; merged [B] 8-byte keys and counters
// [B] int32, zeroed, when splits > 1 (1 .. 1024); chains 4 or 8 (logits a thread an
// iteration); margin 0 runs the planted fault.  tok[b] becomes slot b's draw at temperature
// T > 0 where live[b] != 0.  Returns the cudaError_t of the launch.
extern "C" int repro_sample(const void* logits, const void* keys, const void* counts,
                            const void* live, void* tok, void* bits, void* merged,
                            void* counters, int B, int V, int splits, float temperature,
                            int chains, int margin, void* stream) {
  if (B <= 0 || B > 65535 || V <= 0 || splits < 1 || splits > kMaxSplits ||
      (chains != 4 && chains != 8) ||
      (splits > 1 && (merged == nullptr || counters == nullptr)) || !(temperature > 0.0f))
    return (int)cudaErrorInvalidValue;
  // 1/T rounded to nearest, then one ulp each way: c_dn <= 1/T <= c_up exactly
  const float rt = 1.0f / temperature;
  const float c_up = nextafterf(rt, INFINITY), c_dn = nextafterf(rt, 0.0f);
  (void)sample_bits_ops;  // kept in the build for cuobjdump
  const dim3 grid(splits, B);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* go = chains == 8 ? (margin ? launch<2, false> : launch<2, true>)
                         : (margin ? launch<1, false> : launch<1, true>);
  return (int)go(grid, s, logits, keys, counts, live, tok, bits, merged, counters, V,
                 temperature, c_up, c_dn);
}
