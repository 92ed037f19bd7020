// Temperature sampling for Hopper: JAX's position-indexed categorical draw, one token a slot.
//
// Replaces jax.random.categorical inside the JAX engine's fused decode scan
// (repro/serve/engine.py, _fused_decode_fn's sample): token t of a request is
//   argmax_i( -log(-log(u_i)) + logits_i / T ),  u = uniform(bits(fold_in(key, t)), tiny, 1)
// with JAX's Threefry-2x32 stream in its partitionable mode (jax/_src/prng.py):
//   fold_in(key, t)     = threefry2x32(key, (0, t))
//   bits_i              = y0 ^ y1 of threefry2x32(step key, (0, i))
//   u_i                 = float((bits_i >> 9) | 0x3F800000) - 1, plus tiny, at least tiny
// and the first index among equal maxima, as jnp.argmax.  The integer parts give JAX's bits
// exactly; logf is the accurate one (not __logf), the division a true division, so the
// scores equal the plain version's (repro_torch/serve/sampling.py) up to logf's last ulp.
//
// What bounds it: operations.  A logit is 4 bytes, but its random bits take 20 Threefry
// rounds (an add, a funnel shift and a xor each) and two logs: about 130 instructions an
// element against 4 bytes, far past the card's ratio of int32 rate to memory rate.  So the
// design spreads each slot's vocabulary over `splits` blocks (grid (splits, B)) to put every
// SM to work at decode batch sizes (8 slots alone would fill 8 SMs): each block walks a
// contiguous range with a block stride, keeps its best (score, index), and reduces its
// threads by warp shuffles and one shared-memory pass.  The last block of a slot to arrive
// at its counter (acq_rel; one counter buffer per CUDA stream, reset by that block) merges
// the slot's partials and writes its token, so a call is one launch.  The merge keeps the
// maximum with the smaller index on ties (NaN above every number, as jnp.argmax and
// torch.argmax take it): an order-free choice, so the token does not depend on the split.
// A slot whose live flag is 0 is skipped and keeps its token.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSplits = 64;
constexpr float kTiny = 1.17549435e-38f;  // the smallest normal float32

__device__ __forceinline__ constexpr int rotation(int group, int j) {
  return (group & 1) ? (j == 0 ? 17 : j == 1 ? 29 : j == 2 ? 16 : 24)
                     : (j == 0 ? 13 : j == 1 ? 15 : j == 2 ? 26 : 6);
}

// Threefry-2x32, 20 rounds: the counts (x0, x1) hashed in place under (k0, k1).
__device__ __forceinline__ void threefry(uint32_t k0, uint32_t k1, uint32_t& x0, uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  x0 += k0;
  x1 += k1;
#pragma unroll
  for (int g = 0; g < 5; ++g) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = __funnelshift_l(x1, x1, rotation(g, j));
      x1 ^= x0;
    }
    x0 += ks[(g + 1) % 3];
    x1 += ks[(g + 2) % 3] + static_cast<uint32_t>(g + 1);
  }
}

// (a, ia) before (b, ib): the larger score, NaN above all, the smaller index on ties.
__device__ __forceinline__ bool better(float a, int ia, float b, int ib) {
  const bool na = a != a, nb = b != b;
  if (na || nb) return na && (!nb || ia < ib);
  return a > b || (a == b && ia < ib);
}

__device__ __forceinline__ void warp_best(float& s, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float so = __shfl_xor_sync(0xffffffffu, s, off);
    const int io = __shfl_xor_sync(0xffffffffu, i, off);
    if (better(so, io, s, i)) {
      s = so;
      i = io;
    }
  }
}

// grid (splits, B).  logits [B, V] f32; keys [B, 2] uint32; counts, live, tok [B] int32;
// bits [B, V] (the random bits, written where not null); ws [B, splits] (score, index)
// partials and counters [B], zeroed, where splits > 1.
__global__ void __launch_bounds__(kThreads)
    sample_kernel(const float* __restrict__ logits, const uint32_t* __restrict__ keys,
                  const int* __restrict__ counts, const int* __restrict__ live,
                  int* __restrict__ tok, uint32_t* __restrict__ bits, uint2* __restrict__ ws,
                  int* __restrict__ counters, int V, float temperature) {
  __shared__ float s_score[kWarps];
  __shared__ int s_index[kWarps];
  __shared__ bool merger;
  const int b = blockIdx.y, split = blockIdx.x, splits = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (live[b] == 0) return;

  // this step's key: fold_in(the slot's key, its count)
  uint32_t s0 = 0u, s1 = static_cast<uint32_t>(counts[b]);
  threefry(keys[2 * b], keys[2 * b + 1], s0, s1);
  const int per = (V + splits - 1) / splits;
  const int lo = split * per, hi = min(V, lo + per);
  const float* row = logits + static_cast<size_t>(b) * V;
  float best = -INFINITY;
  int bi = 0x7fffffff;
  for (int i = lo + tid; i < hi; i += kThreads) {
    uint32_t x0 = 0u, x1 = static_cast<uint32_t>(i);
    threefry(s0, s1, x0, x1);
    const uint32_t r = x0 ^ x1;
    if (bits != nullptr) bits[static_cast<size_t>(b) * V + i] = r;
    const float f = __uint_as_float((r >> 9) | 0x3F800000u) - 1.0f;
    const float u = fmaxf(f + kTiny, kTiny);
    const float score = -logf(-logf(u)) + __fdiv_rn(__ldcs(row + i), temperature);
    if (better(score, i, best, bi)) {
      best = score;
      bi = i;
    }
  }
  warp_best(best, bi);
  if (lane == 0) {
    s_score[warp] = best;
    s_index[warp] = bi;
  }
  __syncthreads();
  if (tid != 0) {
    if (splits == 1) return;
  } else {
    for (int w = 1; w < kWarps; ++w)
      if (better(s_score[w], s_index[w], best, bi)) {
        best = s_score[w];
        bi = s_index[w];
      }
    if (splits == 1) {
      tok[b] = bi;
      return;
    }
    // this thread wrote the partial, so its release orders it before the count
    __stcg(ws + static_cast<size_t>(b) * splits + split, make_uint2(__float_as_uint(best), bi));
    int old;
    asm volatile("atom.add.acq_rel.gpu.global.s32 %0, [%1], 1;\n"
                 : "=r"(old)
                 : "l"(counters + b)
                 : "memory");
    merger = old == splits - 1;
  }
  __syncthreads();
  if (!merger || warp != 0) return;
  // the last block: the slot's partials, two a lane, then the warp's best
  best = -INFINITY;
  bi = 0x7fffffff;
  for (int p = lane; p < splits; p += 32) {
    const uint2 v = __ldcg(ws + static_cast<size_t>(b) * splits + p);
    const float s = __uint_as_float(v.x);
    const int i = static_cast<int>(v.y);
    if (better(s, i, best, bi)) {
      best = s;
      bi = i;
    }
  }
  warp_best(best, bi);
  if (lane == 0) {
    tok[b] = bi;
    counters[b] = 0;  // for the next launch on this stream
  }
}

}  // namespace

// logits [B, V] f32, keys [B, 2] uint32 (as int32), counts, live and tok [B] int32, all
// contiguous on one device; bits [B, V] uint32 or null; ws [B, splits] 8-byte partials and
// counters [B] int32, zeroed, when splits > 1 (1 .. 64).  tok[b] becomes slot b's draw at
// temperature T > 0 where live[b] != 0.  Returns the cudaError_t of the launch.
extern "C" int repro_sample(const void* logits, const void* keys, const void* counts,
                            const void* live, void* tok, void* bits, void* ws, void* counters,
                            int B, int V, int splits, float temperature, void* stream) {
  if (B <= 0 || B > 65535 || V <= 0 || splits < 1 || splits > kMaxSplits ||
      (splits > 1 && (ws == nullptr || counters == nullptr)) || !(temperature > 0.0f))
    return (int)cudaErrorInvalidValue;
  sample_kernel<<<dim3(splits, B), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logits), static_cast<const uint32_t*>(keys),
      static_cast<const int*>(counts), static_cast<const int*>(live), static_cast<int*>(tok),
      static_cast<uint32_t*>(bits), static_cast<uint2*>(ws), static_cast<int*>(counters), V,
      temperature);
  return (int)cudaGetLastError();
}
