// Fused RMSNorm for Hopper: y = x * rsqrt(mean(x^2) + eps) * w, f32 statistics and one
// rounding to x's type.  bf16, f16, f32 or f64 (x, w and y of one type; an f64 element is
// rounded to f32 as it is read, as the plain version's statistics are f32), any D >= 1.
//
// Replaces the Pallas TPU kernel repro/kernels/rmsnorm.py::rmsnorm (_rmsnorm_kernel).  It is
// a row reduction and an elementwise scale with no tensor-core work, so bytes bound it: each
// x read once, w once, y written once.  At the decode rows (8 x 2048, 4 KB a row) the bytes
// take nanoseconds, so the time is the launch, one memory trip and the row's serial work.
// The design makes one trip and keeps each thread's chain short:
//   - one block a row, the row held in registers: thread t takes the 16-byte chunks t,
//     t + 32 W, ... (NC of them), W warps a row.  W and NC are template parameters, so the
//     register arrays have compile-time sizes.  The rule gives a row the fewest warps (1, 2,
//     4 or 8) that hold it at one chunk a thread, then 2, 4, 8 or 16 chunks a thread on 8
//     warps (bf16: 1536 to 2048 one chunk, 3072 and 4096 two, internvl2's 8192 and
//     deepseek's 7168 four).  A warp a row holding the whole of a 2048 or 4096 row (8 or 16
//     chunks a lane) spends its time in its own serial chain at 8 rows
//     (kernels/rmsnorm_sweep.py times every count).  A chunk holds 8 bf16 or f16 elements,
//     4 f32 or 2 f64;
//   - w's chunks are loaded before the first row's x, both in flight together, and kept in
//     registers for every row the block takes; the sum of squares is reduced with warp
//     shuffles, then (W > 1) the W warp sums in shared memory, double-buffered by row
//     parity: one barrier a row, none for a warp a row;
//   - rows past 16 chunks a thread on 8 warps are walked in segments, summed in a first
//     pass and read again (from L2) in a second.
// Each grid is capped at the SMs times the blocks an SM holds, and blocks walk the rows with
// a grid stride.  Launched as the matmul kernels are (programmatic dependent launch): a launch
// may begin while the kernel before it on the stream finishes, and waits for it before its
// first read.  x is read and y written with evict-first accesses (__ldcs, __stcs); w
// through the read-only cache.
//
// Any D and any alignment: a chunk is 16 bytes of the row's elements counted from the row's
// first element.  A chunk is one 16-byte load where the row is 16-byte aligned and the chunk
// whole, else element by element (the ragged last chunk, rows of D not a multiple of 8 (4
// in f32), a view that starts off a 16-byte boundary).  Loading the same elements in another
// way does not change the arithmetic.
//
// Row invariance: a row's sum is taken in an order fixed by D alone (each thread's chunks
// in order, a fixed xor-shuffle tree, then the warps in order), never by how many rows the
// launch holds, where the row sits or how it is aligned.  So a row's output is bitwise the
// same in a launch of 1, 8 or 600 rows (chunked and whole-prompt prefill agree).
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int MAX_WARPS = 8;        // the most warps a row
constexpr int SEG_NC = 8;           // chunks a thread a segment, rows past 4096 chunks

// Element types: raw bits, and the conversions to and from f32.
struct Bf16 {
  using raw = unsigned short;
  static __device__ __forceinline__ float to_f(raw r) {
    return __uint_as_float(static_cast<uint32_t>(r) << 16);
  }
  static __device__ __forceinline__ raw from_f(float f) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(f));
  }
};
struct F16 {
  using raw = unsigned short;
  static __device__ __forceinline__ float to_f(raw r) { return __half2float(__ushort_as_half(r)); }
  static __device__ __forceinline__ raw from_f(float f) {
    return __half_as_ushort(__float2half_rn(f));
  }
};
struct F32 {
  using raw = float;
  static __device__ __forceinline__ float to_f(raw r) { return r; }
  static __device__ __forceinline__ raw from_f(float f) { return f; }
};
struct F64 {
  using raw = double;
  static __device__ __forceinline__ float to_f(raw r) { return __double2float_rn(r); }
  static __device__ __forceinline__ raw from_f(float f) { return static_cast<double>(f); }
};

// elements of a 16-byte chunk
template <class E>
constexpr int kVec = 16 / static_cast<int>(sizeof(typename E::raw));

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

__device__ __forceinline__ uint32_t word(const uint4& u, int k) {
  return k == 0 ? u.x : k == 1 ? u.y : k == 2 ? u.z : u.w;
}

// Element j of a chunk, as f32.
template <class E>
__device__ __forceinline__ float get(const uint4& u, int j) {
  if constexpr (sizeof(typename E::raw) == 2) {
    const uint32_t wd = word(u, j >> 1);
    return E::to_f(static_cast<unsigned short>((j & 1) ? (wd >> 16) : (wd & 0xffffu)));
  } else if constexpr (sizeof(typename E::raw) == 4) {
    return E::to_f(__uint_as_float(word(u, j)));
  } else {
    return E::to_f(__hiloint2double(static_cast<int>(word(u, 2 * j + 1)),
                                    static_cast<int>(word(u, 2 * j))));
  }
}

template <bool STREAM>
__device__ __forceinline__ uint4 ld16(const void* p) {
  return STREAM ? __ldcs(static_cast<const uint4*>(p)) : __ldg(static_cast<const uint4*>(p));
}
template <bool STREAM>
__device__ __forceinline__ uint32_t ld_elem(const unsigned short* p) {
  return STREAM ? __ldcs(p) : __ldg(p);
}
template <bool STREAM>
__device__ __forceinline__ uint32_t ld_elem(const float* p) {
  return __float_as_uint(STREAM ? __ldcs(p) : __ldg(p));
}
template <bool STREAM>
__device__ __forceinline__ unsigned long long ld_elem(const double* p) {
  return static_cast<unsigned long long>(__double_as_longlong(STREAM ? __ldcs(p) : __ldg(p)));
}

// The n (0..vec) elements of a chunk at p, zeros past them: one 16-byte load when p is
// 16-byte aligned and the chunk whole, else element by element.  STREAM: evict-first.
template <class E, bool STREAM>
__device__ __forceinline__ uint4 load_chunk(const typename E::raw* p, int n, bool aligned) {
  constexpr int N = kVec<E>;
  if (n == N && aligned) return ld16<STREAM>(p);
  uint32_t wd[4] = {0u, 0u, 0u, 0u};
  if (n > 0) {
    if constexpr (N == 8) {
#pragma unroll
      for (int j = 0; j < N; ++j)
        if (j < n) wd[j >> 1] |= ld_elem<STREAM>(p + j) << ((j & 1) * 16);
    } else if constexpr (N == 4) {
#pragma unroll
      for (int j = 0; j < N; ++j)
        if (j < n) wd[j] = ld_elem<STREAM>(p + j);
    } else {
#pragma unroll
      for (int j = 0; j < N; ++j)
        if (j < n) {
          const unsigned long long bits = ld_elem<STREAM>(p + j);
          wd[2 * j] = static_cast<uint32_t>(bits);
          wd[2 * j + 1] = static_cast<uint32_t>(bits >> 32);
        }
    }
  }
  return make_uint4(wd[0], wd[1], wd[2], wd[3]);
}

// y's chunk: the first n elements of o (rounded once to E), one 16-byte evict-first store
// when p is aligned and the chunk whole.
template <class E>
__device__ __forceinline__ void store_chunk(typename E::raw* p, const float (&o)[kVec<E>], int n,
                                            bool aligned) {
  constexpr int N = kVec<E>;
  if (n == N && aligned) {
    uint32_t wd[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if constexpr (N == 8) {
        wd[k] = static_cast<uint32_t>(E::from_f(o[2 * k])) |
                (static_cast<uint32_t>(E::from_f(o[2 * k + 1])) << 16);
      } else if constexpr (N == 4) {
        wd[k] = __float_as_uint(o[k]);
      } else {
        const long long bits = __double_as_longlong(E::from_f(o[k / 2]));
        wd[k] = static_cast<uint32_t>(k % 2 ? bits >> 32 : bits);
      }
    }
    __stcs(reinterpret_cast<uint4*>(p), make_uint4(wd[0], wd[1], wd[2], wd[3]));
    return;
  }
#pragma unroll
  for (int j = 0; j < N; ++j)
    if (j < n) __stcs(p + j, E::from_f(o[j]));
}

// Valid elements of chunk c of a row of D.
template <class E>
__device__ __forceinline__ int chunk_elems(long long c, int D) {
  const long long left = static_cast<long long>(D) - c * kVec<E>;
  return left <= 0 ? 0 : (left >= kVec<E> ? kVec<E> : static_cast<int>(left));
}

// Sum of squares of a chunk's elements, in element order, added to ss.
template <class E>
__device__ __forceinline__ float sum_sq(const uint4& u, float ss) {
#pragma unroll
  for (int j = 0; j < kVec<E>; ++j) {
    const float f = get<E>(u, j);
    ss = fmaf(f, f, ss);
  }
  return ss;
}

// y's chunk from x's and w's: (x * r) * w in f32, rounded once.
template <class E>
__device__ __forceinline__ void scale_store(typename E::raw* p, const uint4& xu, const uint4& wu,
                                            float r, int n, bool aligned) {
  float o[kVec<E>];
#pragma unroll
  for (int j = 0; j < kVec<E>; ++j) o[j] = get<E>(xu, j) * r * get<E>(wu, j);
  store_chunk<E>(p, o, n, aligned);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;  // the same tree in every lane: every lane holds the same bits
}

// One block of WARPS warps a row, the row in registers: thread t holds the chunks t,
// t + 32 WARPS, ... (NC of them).  RESIDENT: the row is one segment of 32 WARPS NC chunks;
// otherwise it is walked in such segments, summed in a first pass and read again (from L2)
// in a second.  One warp (WARPS = 1) reduces with shuffles alone; more meet in shared
// memory, double-buffered by row parity (one barrier a row).
template <class E, int WARPS, int NC, bool RESIDENT>
__global__ void __launch_bounds__(WARPS * 32)
    rmsnorm_kernel(const typename E::raw* __restrict__ x, const typename E::raw* __restrict__ w,
                   typename E::raw* __restrict__ y, int rows, int D, float eps) {
  using raw = typename E::raw;
  constexpr int N = kVec<E>, G = WARPS * 32, SEG = G * NC;
  __shared__ float part[2][WARPS];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int nseg = RESIDENT ? 1 : static_cast<int>((static_cast<long long>(D) + N * SEG - 1) /
                                                   (static_cast<long long>(N) * SEG));
  const bool wal = aligned16(w);
  grid_dependency_wait();  // the kernel before this one on the stream has written x and w
  launch_dependents();

  uint4 wc[NC];  // w's chunks, loaded before the first row's x and kept for every row
  if constexpr (RESIDENT) {
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      const int c = t + G * k;
      wc[k] = load_chunk<E, false>(w + c * N, chunk_elems<E>(c, D), wal);
    }
  }
  int parity = 0;
  for (int row = blockIdx.x; row < rows; row += gridDim.x, parity ^= 1) {
    const raw* xr = x + static_cast<size_t>(row) * D;
    raw* yr = y + static_cast<size_t>(row) * D;
    const bool xal = aligned16(xr), yal = aligned16(yr);
    uint4 xc[NC];
    float ss = 0.0f;
    for (int s = 0; s < nseg; ++s) {
#pragma unroll
      for (int k = 0; k < NC; ++k) {
        const long long c = static_cast<long long>(s) * SEG + t + G * k;
        xc[k] = load_chunk<E, true>(xr + c * N, chunk_elems<E>(c, D), xal);
      }
#pragma unroll
      for (int k = 0; k < NC; ++k) ss = sum_sq<E>(xc[k], ss);
    }
    ss = warp_sum(ss);
    float total = ss;
    if constexpr (WARPS > 1) {
      if (lane == 0) part[parity][warp] = ss;
      __syncthreads();
      total = 0.0f;
#pragma unroll
      for (int i = 0; i < WARPS; ++i) total += part[parity][i];
    }
    const float r = rsqrtf(total / static_cast<float>(D) + eps);
    for (int s = 0; s < nseg; ++s) {
#pragma unroll
      for (int k = 0; k < NC; ++k) {
        const long long c = static_cast<long long>(s) * SEG + t + G * k;
        const int n = chunk_elems<E>(c, D);
        if (n == 0) continue;
        uint4 xu = xc[k], wu;
        if constexpr (RESIDENT) {
          wu = wc[k];
        } else {
          xu = load_chunk<E, false>(xr + c * N, n, xal);  // the second read
          wu = load_chunk<E, false>(w + c * N, n, wal);
        }
        scale_store<E>(yr + c * N, xu, wu, r, n, yal);
      }
    }
  }
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

template <class E, int WARPS, int NC, bool RESIDENT = true>
int run(const void* x, const void* w, void* y, int rows, int D, float eps, cudaStream_t st) {
  using raw = typename E::raw;
  auto k = rmsnorm_kernel<E, WARPS, NC, RESIDENT>;
  static int per_sm = 0;  // blocks an SM holds, read once for this instance
  if (per_sm == 0) {
    int n = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, k, WARPS * 32, 0);
    per_sm = n > 0 ? n : 1;
  }
  const long long cap = static_cast<long long>(sm_count()) * per_sm;
  const int blocks = static_cast<int>(rows < cap ? rows : cap);
  return static_cast<int>(launch_overlapped(k, dim3(blocks), WARPS * 32, 0, st,
                                            static_cast<const raw*>(x),
                                            static_cast<const raw*>(w), static_cast<raw*>(y),
                                            rows, D, eps));
}

// The warps a row for D: the fewest of 1, 2, 4 or 8 that hold the row at one chunk a thread,
// else 8.  A function of D and the type alone, so a row is normalised the same way in every
// launch.
int rule_warps(long long chunks) {
  return chunks <= 32 ? 1 : chunks <= 64 ? 2 : chunks <= 128 ? 4 : MAX_WARPS;
}

template <class E, int W>
int run_nc(int nc, const void* x, const void* w, void* y, int rows, int D, float eps,
           cudaStream_t st) {
  switch (nc) {
    case 1: return run<E, W, 1>(x, w, y, rows, D, eps, st);
    case 2: return run<E, W, 2>(x, w, y, rows, D, eps, st);
    case 4: return run<E, W, 4>(x, w, y, rows, D, eps, st);
    case 8: return run<E, W, 8>(x, w, y, rows, D, eps, st);
    default: return run<E, W, 16>(x, w, y, rows, D, eps, st);
  }
}

// warps: 0 for the rule's count, else 1, 2, 4 or 8 (a sweep's override).  Chunks a thread:
// the least power of two up to 16 that holds the row; past 16 on 8 warps, segments.
template <class E>
int launch(const void* x, const void* w, void* y, int rows, int D, float eps, int warps,
           cudaStream_t st) {
  constexpr int N = kVec<E>;
  const long long chunks = (static_cast<long long>(D) + N - 1) / N;
  const int W = warps ? warps : rule_warps(chunks);
  const long long per = (chunks + 32LL * W - 1) / (32LL * W);
  int nc = 1;
  while (nc < per && nc <= 16) nc *= 2;
  if (nc > 16) {
    if (W != MAX_WARPS) return static_cast<int>(cudaErrorInvalidValue);
    return run<E, MAX_WARPS, SEG_NC, false>(x, w, y, rows, D, eps, st);
  }
  switch (W) {
    case 1: return run_nc<E, 1>(nc, x, w, y, rows, D, eps, st);
    case 2: return run_nc<E, 2>(nc, x, w, y, rows, D, eps, st);
    case 4: return run_nc<E, 4>(nc, x, w, y, rows, D, eps, st);
    case 8: return run_nc<E, 8>(nc, x, w, y, rows, D, eps, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x, y [rows, D] and w [D], contiguous, all of one type: dtype 0 bf16, 1 f16, 2 f32, 3 f64.  Any
// alignment of the element type.  warps: 0 for the rule, or 1, 2, 4, 8 warps a row.
// Returns the cudaError_t of the launch.
extern "C" int repro_rmsnorm(const void* x, const void* w, void* y, int rows, int D, float eps,
                             int dtype, int warps, void* stream) {
  if (rows <= 0 || D <= 0 || dtype < 0 || dtype > 3 ||
      !(warps == 0 || warps == 1 || warps == 2 || warps == 4 || warps == 8))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<Bf16>(x, w, y, rows, D, eps, warps, st);
  if (dtype == 1) return launch<F16>(x, w, y, rows, D, eps, warps, st);
  if (dtype == 2) return launch<F32>(x, w, y, rows, D, eps, warps, st);
  return launch<F64>(x, w, y, rows, D, eps, warps, st);
}

// The warps a row the rule gives D in dtype (as repro_rmsnorm reads it).
extern "C" int repro_rmsnorm_warps(int D, int dtype) {
  const int bytes = dtype == 3 ? 8 : dtype == 2 ? 4 : 2;
  return rule_warps((static_cast<long long>(D) * bytes + 15) / 16);
}
