// Blocked bf16 matmul for Hopper: out[M,N] = epilogue(x[M,K] @ w[K,N]).
//
// Replaces the Pallas TPU kernel repro/kernels/matmul.py::matmul (_mm_kernel).
// The TPU carried the f32 accumulator across a sequential K grid axis; here
// one thread block owns a 64x64 output tile and loops over K itself, with a
// two-stage cp.async ring (the copy of tile k+1 overlaps the products of tile
// k).  The products run on the tensor cores through WMMA 16x16x16 bf16
// fragments with f32 accumulation.  The epilogue (silu or tanh-gelu, in f32)
// is fused, then the tile is cast to bf16 or stored as f32.
//
// Ragged shapes are handled here, not by the caller: rows past M and columns
// past N or K are zero-filled on load and skipped on store (cp.async with a
// zero source size).  K and N must be multiples of 8 (16-byte rows).
//
// Skinny M (decode: M = batch slots) leaves too few output tiles to fill 132
// SMs, so the caller may split K across gridDim.z: each split writes its f32
// partial tile to a workspace and a second kernel sums the splits in a fixed
// order (deterministic) and applies the epilogue.
//
// The f32 path (repro_matmul_f32: f32 x and w, f32 out) computes in full f32
// on the CUDA cores, as the Pallas kernel does for f32 inputs: not TF32, whose
// 10-bit mantissa misses the 2e-4 the JAX package's own test holds at K = 256.
// A block owns a 64x64 tile; 256 threads each accumulate a 4x4 register block
// with FMAs over a two-stage cp.async ring of 64x16 A and 16x64 B tiles in
// shared memory.  Ragged M, N and K are zero-filled on load, as above (K and N
// multiples of 4: 16-byte rows); split-K and its fixed-order reduce are
// shared with the bf16 path.  What bounds it: operations at the f32 rate (67
// TFLOP/s) once the tiles fill the card; at the paper's 256 x 256 x 256 the
// launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

using namespace nvcuda;

namespace {

constexpr int BM = 64, BN = 64, BK = 32, THREADS = 128;
constexpr int LDA = BK + 8;  // smem row strides (elements), padded: 80 B, 144 B
constexpr int LDB = BN + 8;
constexpr int LDC = BN + 4;  // f32 staging for the epilogue
constexpr int A_STAGE = BM * LDA;
constexpr int B_STAGE = BK * LDB;
constexpr int SMEM_AB = 2 * (A_STAGE + B_STAGE) * 2;
constexpr int SMEM_C = BM * LDC * 4;
constexpr int SMEM = SMEM_AB > SMEM_C ? SMEM_AB : SMEM_C;

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

__device__ __forceinline__ void load_tile(__nv_bfloat16* as, __nv_bfloat16* bs,
                                          const __nv_bfloat16* x, const __nv_bfloat16* w,
                                          int M, int N, int K, int m0, int n0, int k0) {
  for (int c = threadIdx.x; c < BM * BK / 8; c += THREADS) {
    int r = c / (BK / 8), col = (c % (BK / 8)) * 8;
    int gr = m0 + r, gc = k0 + col;
    bool ok = gr < M && gc < K;
    cp_async16(as + r * LDA + col, ok ? x + (size_t)gr * K + gc : x, ok);
  }
  for (int c = threadIdx.x; c < BK * BN / 8; c += THREADS) {
    int r = c / (BN / 8), col = (c % (BN / 8)) * 8;
    int gr = k0 + r, gc = n0 + col;
    bool ok = gr < K && gc < N;
    cp_async16(bs + r * LDB + col, ok ? w + (size_t)gr * N + gc : w, ok);
  }
}

__global__ void __launch_bounds__(THREADS)
    mm_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
              void* __restrict__ out, float* __restrict__ ws, int M, int N, int K, int act,
              int out_f32, int per_split) {
  __shared__ __align__(128) unsigned char smem[SMEM];
  __nv_bfloat16* as = reinterpret_cast<__nv_bfloat16*>(smem);  // [2][A_STAGE]
  __nv_bfloat16* bs = as + 2 * A_STAGE;                          // [2][B_STAGE]
  float* cs = reinterpret_cast<float*>(smem);                    // after the loop

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN, split = blockIdx.z;
  const int kt = (K + BK - 1) / BK;
  const int kt0 = split * per_split;
  const int nk = min(kt, kt0 + per_split) - kt0;
  const int warp = threadIdx.x / 32;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;  // 2x2 warps, 32x32 each

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  if (nk > 0) load_tile(as, bs, x, w, M, N, K, m0, n0, kt0 * BK);
  cp_async_commit();
  for (int i = 0; i < nk; ++i) {
    const int cur = i & 1;
    if (i + 1 < nk)
      load_tile(as + (cur ^ 1) * A_STAGE, bs + (cur ^ 1) * B_STAGE, x, w, M, N, K, m0, n0,
                (kt0 + i + 1) * BK);
    cp_async_commit();  // possibly empty: keeps "all but the newest group" = tile i
    cp_async_wait<1>();
    __syncthreads();
    const __nv_bfloat16* a_t = as + cur * A_STAGE;
    const __nv_bfloat16* b_t = bs + cur * B_STAGE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        wmma::load_matrix_sync(fa[mi], a_t + (wm + mi * 16) * LDA + kk, LDA);
#pragma unroll
      for (int ni = 0; ni < 2; ++ni)
        wmma::load_matrix_sync(fb[ni], b_t + kk * LDB + wn + ni * 16, LDB);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 2; ++ni) wmma::mma_sync(acc[mi][ni], fa[mi], fb[ni], acc[mi][ni]);
    }
    __syncthreads();  // tile i's buffer is refilled by the next iteration
  }
  cp_async_wait<0>();
  __syncthreads();

#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 2; ++ni)
      wmma::store_matrix_sync(cs + (wm + mi * 16) * LDC + wn + ni * 16, acc[mi][ni], LDC,
                              wmma::mem_row_major);
  __syncthreads();

  for (int idx = threadIdx.x; idx < BM * BN; idx += THREADS) {
    int r = idx / BN, c = idx % BN;
    int gr = m0 + r, gc = n0 + c;
    if (gr >= M || gc >= N) continue;
    float v = cs[r * LDC + c];
    if (ws != nullptr)
      ws[((size_t)split * M + gr) * N + gc] = v;
    else
      store_out(out, (size_t)gr * N + gc, epilogue(v, act), out_f32);
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

__device__ __forceinline__ void load_tile_f32(float* as, float* bs, const float* x, const float* w,
                                              int M, int N, int K, int m0, int n0, int k0) {
  {  // A: 64 rows x 16 k = 256 chunks of 4 floats, one a thread
    int c = threadIdx.x, r = c / (FBK / 4), col = (c % (FBK / 4)) * 4;
    int gr = m0 + r, gc = k0 + col;
    bool ok = gr < M && gc < K;
    cp_async16(as + r * FLDA + col, ok ? x + (size_t)gr * K + gc : x, ok);
  }
  {  // B: 16 k x 64 cols = 256 chunks
    int c = threadIdx.x, r = c / (FBN / 4), col = (c % (FBN / 4)) * 4;
    int gr = k0 + r, gc = n0 + col;
    bool ok = gr < K && gc < N;
    cp_async16(bs + r * FLDB + col, ok ? w + (size_t)gr * N + gc : w, ok);
  }
}

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

  if (nk > 0) load_tile_f32(as, bs, x, w, M, N, K, m0, n0, kt0 * FBK);
  cp_async_commit();
  for (int t = 0; t < nk; ++t) {
    const int cur = t & 1;
    if (t + 1 < nk)
      load_tile_f32(as + (cur ^ 1) * FA_STAGE, bs + (cur ^ 1) * FB_STAGE, x, w, M, N, K, m0, n0,
                    (kt0 + t + 1) * FBK);
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

}  // namespace

// x [M,K] bf16, w [K,N] bf16, out [M,N] bf16 (out_f32 = 0) or f32; ws holds
// splits*M*N floats when splits > 1.  The caller picks splits so that
// ceil(kt / ceil(kt / splits)) == splits, kt = ceil(K / 32).  Returns the
// cudaError_t of the launches (0 on success).
extern "C" int repro_matmul(const void* x, const void* w, void* out, void* ws, int M, int N,
                            int K, int act, int out_f32, int splits, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 8 || N % 8 || splits < 1 || act < 0 || act > 2)
    return (int)cudaErrorInvalidValue;
  const int kt = (K + BK - 1) / BK;
  const int per = (kt + splits - 1) / splits;
  if ((kt + per - 1) / per != splits || (splits > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  mm_kernel<<<grid, THREADS, 0, st>>>(static_cast<const __nv_bfloat16*>(x),
                                      static_cast<const __nv_bfloat16*>(w), out,
                                      splits > 1 ? static_cast<float*>(ws) : nullptr, M, N, K,
                                      act, out_f32, per);
  if (splits > 1) {
    size_t total = (size_t)M * N;
    unsigned blocks = (unsigned)((total + 255) / 256);
    splitk_reduce<<<blocks, 256, 0, st>>>(static_cast<const float*>(ws), out, M, N, splits, act,
                                          out_f32);
  }
  return (int)cudaGetLastError();
}

// x [M,K] f32, w [K,N] f32, out [M,N] f32; ws holds splits*M*N floats when
// splits > 1, with ceil(kt / ceil(kt / splits)) == splits for kt = ceil(K / 16).
// Returns the cudaError_t of the launches (0 on success).
extern "C" int repro_matmul_f32(const void* x, const void* w, void* out, void* ws, int M, int N,
                                int K, int act, int splits, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 4 || N % 4 || splits < 1 || act < 0 || act > 2)
    return (int)cudaErrorInvalidValue;
  const int kt = (K + FBK - 1) / FBK;
  const int per = (kt + splits - 1) / splits;
  if ((kt + per - 1) / per != splits || (splits > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid((N + FBN - 1) / FBN, (M + FBM - 1) / FBM, splits);
  mm_f32_kernel<<<grid, FTHREADS, 0, st>>>(static_cast<const float*>(x),
                                           static_cast<const float*>(w), static_cast<float*>(out),
                                           splits > 1 ? static_cast<float*>(ws) : nullptr, M, N, K,
                                           act, per);
  if (splits > 1) {
    size_t total = (size_t)M * N;
    unsigned blocks = (unsigned)((total + 255) / 256);
    splitk_reduce<<<blocks, 256, 0, st>>>(static_cast<const float*>(ws), out, M, N, splits, act,
                                          1);
  }
  return (int)cudaGetLastError();
}
