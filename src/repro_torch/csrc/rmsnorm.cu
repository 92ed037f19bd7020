// Fused RMSNorm for Hopper: y = x * rsqrt(mean(x^2) + eps) * w, f32 statistics.
//
// Replaces the Pallas TPU kernel repro/kernels/rmsnorm.py::rmsnorm
// (_rmsnorm_kernel).  It is a row reduction plus an elementwise scale with no
// tensor-core work, so it is bound by bytes: one block per row reads the row
// with 16-byte loads, reduces the sum of squares in f32 (warp shuffles, then
// one word per warp in shared memory), and writes the scaled row once.  The
// second pass re-reads the row, which a 4 KB row (d_model 2048, bf16) finds
// in L1.  D must be a multiple of 8.  f32 rows (x, w and y f32) take a
// kernel of their own with the same shape: eight values a thread a step, as
// two 16-byte loads.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
    rmsnorm_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                   __nv_bfloat16* __restrict__ y, int D, float eps) {
  __shared__ float part[THREADS / 32];
  const __nv_bfloat16* xr = x + (size_t)blockIdx.x * D;
  __nv_bfloat16* yr = y + (size_t)blockIdx.x * D;

  float ss = 0.0f;
  for (int c = threadIdx.x * 8; c < D; c += THREADS * 8) {
    uint4 u = *reinterpret_cast<const uint4*>(xr + c);
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 f = __bfloat1622float2(p[i]);
      ss += f.x * f.x + f.y * f.y;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) part[warp] = ss;
  __syncthreads();
  float total = 0.0f;
#pragma unroll
  for (int i = 0; i < THREADS / 32; ++i) total += part[i];
  const float r = rsqrtf(total / (float)D + eps);

  for (int c = threadIdx.x * 8; c < D; c += THREADS * 8) {
    uint4 u = *reinterpret_cast<const uint4*>(xr + c);
    uint4 wu = *reinterpret_cast<const uint4*>(w + c);
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
    const __nv_bfloat162* pw = reinterpret_cast<const __nv_bfloat162*>(&wu);
    uint4 o;
    __nv_bfloat162* po = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 f = __bfloat1622float2(p[i]);
      float2 g = __bfloat1622float2(pw[i]);
      po[i] = __floats2bfloat162_rn(f.x * r * g.x, f.y * r * g.y);
    }
    *reinterpret_cast<uint4*>(yr + c) = o;
  }
}

__global__ void __launch_bounds__(THREADS)
    rmsnorm_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                       float* __restrict__ y, int D, float eps) {
  __shared__ float part[THREADS / 32];
  const float* xr = x + (size_t)blockIdx.x * D;
  float* yr = y + (size_t)blockIdx.x * D;

  float ss = 0.0f;
  for (int c = threadIdx.x * 8; c < D; c += THREADS * 8) {
    const float4 a = *reinterpret_cast<const float4*>(xr + c);
    const float4 b = *reinterpret_cast<const float4*>(xr + c + 4);
    ss += a.x * a.x + a.y * a.y + a.z * a.z + a.w * a.w;
    ss += b.x * b.x + b.y * b.y + b.z * b.z + b.w * b.w;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) part[warp] = ss;
  __syncthreads();
  float total = 0.0f;
#pragma unroll
  for (int i = 0; i < THREADS / 32; ++i) total += part[i];
  const float r = rsqrtf(total / (float)D + eps);

  for (int c = threadIdx.x * 8; c < D; c += THREADS * 8) {
#pragma unroll
    for (int h = 0; h < 8; h += 4) {
      const float4 a = *reinterpret_cast<const float4*>(xr + c + h);
      const float4 g = *reinterpret_cast<const float4*>(w + c + h);
      *reinterpret_cast<float4*>(yr + c + h) =
          make_float4(a.x * r * g.x, a.y * r * g.y, a.z * r * g.z, a.w * r * g.w);
    }
  }
}

}  // namespace

// x, y [rows, D] bf16, w [D] bf16.  Returns the cudaError_t of the launch.
extern "C" int repro_rmsnorm(const void* x, const void* w, void* y, int rows, int D, float eps,
                             void* stream) {
  if (rows <= 0 || D <= 0 || D % 8) return (int)cudaErrorInvalidValue;
  rmsnorm_kernel<<<rows, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<__nv_bfloat16*>(y), D, eps);
  return (int)cudaGetLastError();
}

// x, y [rows, D] f32, w [D] f32.  Returns the cudaError_t of the launch.
extern "C" int repro_rmsnorm_f32(const void* x, const void* w, void* y, int rows, int D,
                                 float eps, void* stream) {
  if (rows <= 0 || D <= 0 || D % 8) return (int)cudaErrorInvalidValue;
  rmsnorm_f32_kernel<<<rows, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), static_cast<float*>(y), D, eps);
  return (int)cudaGetLastError();
}
