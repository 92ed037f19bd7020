// VALID stride-1 2-D convolution for Hopper: out[B,oh,ow,F] = x[B,H,W,Cin] (*) w[kh,kw,Cin,F],
// NHWC x HWIO, oh = H-kh+1, ow = W-kw+1.  Two type paths:
//   int16 in, int32 accumulate, int32 out (exact; sums past 2^31 wrap as two's complement);
//   f32 in, f32 accumulate, f32 out.
//
// Replaces the Pallas TPU kernel repro/kernels/conv2d.py::conv2d (_conv_kernel), which
// unrolls the kh*kw taps as shifted MXU products over one VMEM-resident image.  Hopper's
// tensor cores have no int16 product, so this runs on the CUDA cores:
//   - a block owns an 8 x 32 tile of output pixels of one image (one pixel a thread, a
//     warp on 32 neighbouring pixels of a row), so a 64x64 image is 16 blocks and a batch
//     of frames fills the card;
//   - it stages the input rows and columns it reads (the tile plus the kh-1 / kw-1 halo)
//     and the filter in shared memory, in the accumulator's type, CC channels and 8
//     filters at a time;
//   - each thread accumulates its pixel for those 8 filters in registers, the taps
//     unrolled at compile time for the paper's 5x5 and 3x3 filters (template instances),
//     with a runtime-size path for any other filter.
// Integer sums are taken in uint32_t: signed overflow is undefined in C++, unsigned
// arithmetic wraps mod 2^32, which is what XLA's int32 convolution gives.
// Loads are scalar: Cin and F of 1 or 2 give rows too narrow for vector loads.
//
// What bounds it on the H100: few operations per byte (2*kh*kw*Cin*F per output pixel,
// 50 for the 5x5x1x1 role), so bytes at the paper's shapes; at 64x64 a single image is a
// few microseconds of launch.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TR = 8, TC = 32, THREADS = TR * TC, FC = 8;
constexpr int SMEM_BUDGET = 48 * 1024;  // static-launch limit: no opt-in attribute needed

template <typename Acc>
__device__ __forceinline__ Acc widen(int16_t v) {
  return static_cast<Acc>(static_cast<int32_t>(v));  // uint32_t: two's complement bits
}
template <typename Acc>
__device__ __forceinline__ Acc widen(float v) {
  return v;
}

__device__ __forceinline__ void mac(uint32_t& acc, uint32_t a, uint32_t b) { acc += a * b; }
__device__ __forceinline__ void mac(float& acc, float a, float b) { acc = fmaf(a, b, acc); }

__device__ __forceinline__ void store(int32_t* out, size_t i, uint32_t v) {
  out[i] = static_cast<int32_t>(v);
}
__device__ __forceinline__ void store(float* out, size_t i, float v) { out[i] = v; }

// KH = KW = 0: filter size from the runtime arguments.
template <typename Tin, typename Acc, typename Tout, int KH, int KW>
__global__ void __launch_bounds__(THREADS)
    conv_kernel(const Tin* __restrict__ x, const Tin* __restrict__ w, Tout* __restrict__ out,
                int H, int W, int Cin, int F, int kh_rt, int kw_rt, int cc) {
  const int kh = KH ? KH : kh_rt, kw = KW ? KW : kw_rt;
  const int oh = H - kh + 1, ow = W - kw + 1;
  const int rows = TR + kh - 1, cols = TC + kw - 1;
  extern __shared__ __align__(16) unsigned char smem[];
  Acc* xs = reinterpret_cast<Acc*>(smem);   // [rows][cols][cc]
  Acc* ws = xs + rows * cols * cc;          // [kh][kw][cc][FC]

  const int b = blockIdx.z, r0 = blockIdx.y * TR, c0 = blockIdx.x * TC;
  const int ty = threadIdx.x / TC, tx = threadIdx.x % TC;
  const int orow = r0 + ty, ocol = c0 + tx;
  const Tin* xb = x + (size_t)b * H * W * Cin;

  for (int f0 = 0; f0 < F; f0 += FC) {
    Acc acc[FC];
#pragma unroll
    for (int f = 0; f < FC; ++f) acc[f] = Acc(0);
    for (int ch0 = 0; ch0 < Cin; ch0 += cc) {
      const int nc = min(cc, Cin - ch0);
      __syncthreads();  // the previous chunk's reads are done before it is overwritten
      for (int i = threadIdx.x; i < rows * cols * cc; i += THREADS) {
        int c = i % cc, rc = i / cc, col = rc % cols, row = rc / cols;
        int gr = r0 + row, gc = c0 + col;
        xs[i] = (c < nc && gr < H && gc < W) ? widen<Acc>(xb[((size_t)gr * W + gc) * Cin + ch0 + c])
                                             : Acc(0);
      }
      for (int i = threadIdx.x; i < kh * kw * cc * FC; i += THREADS) {
        int f = i % FC, rest = i / FC, c = rest % cc, tap = rest / cc;
        ws[i] = (c < nc && f0 + f < F) ? widen<Acc>(w[((size_t)tap * Cin + ch0 + c) * F + f0 + f])
                                       : Acc(0);
      }
      __syncthreads();
      // kh, kw are compile-time constants in the 5x5 and 3x3 instances: the taps unroll
#pragma unroll
      for (int dy = 0; dy < kh; ++dy) {
#pragma unroll
        for (int dx = 0; dx < kw; ++dx) {
          const Acc* xp = xs + ((ty + dy) * cols + tx + dx) * cc;
          const Acc* wp = ws + (dy * kw + dx) * cc * FC;
          for (int c = 0; c < nc; ++c) {
            const Acc v = xp[c];
#pragma unroll
            for (int f = 0; f < FC; ++f) mac(acc[f], v, wp[c * FC + f]);
          }
        }
      }
    }
    if (orow < oh && ocol < ow) {
      const size_t base = (((size_t)b * oh + orow) * ow + ocol) * F;
#pragma unroll
      for (int f = 0; f < FC; ++f)
        if (f0 + f < F) store(out, base + f0 + f, acc[f]);
    }
  }
}

// Channels staged at once: the most that keep the input tile and the filter slab
// within SMEM_BUDGET; 0 when not even one channel fits.
int channels_per_chunk(int Cin, int kh, int kw, int acc_bytes) {
  const int per_channel = ((TR + kh - 1) * (TC + kw - 1) + kh * kw * FC) * acc_bytes;
  return per_channel > 0 ? (SMEM_BUDGET / per_channel < Cin ? SMEM_BUDGET / per_channel : Cin)
                         : 0;
}

template <typename Tin, typename Acc, typename Tout>
int launch(const void* x, const void* w, void* out, int B, int H, int W, int Cin, int kh, int kw,
           int F, cudaStream_t st) {
  const int cc = channels_per_chunk(Cin, kh, kw, (int)sizeof(Acc));
  if (cc < 1) return (int)cudaErrorInvalidValue;
  const int oh = H - kh + 1, ow = W - kw + 1;
  const size_t smem = (size_t)((TR + kh - 1) * (TC + kw - 1) + kh * kw * FC) * cc * sizeof(Acc);
  dim3 grid((ow + TC - 1) / TC, (oh + TR - 1) / TR, B);
  const Tin* xi = static_cast<const Tin*>(x);
  const Tin* wi = static_cast<const Tin*>(w);
  Tout* o = static_cast<Tout*>(out);
  if (kh == 5 && kw == 5)
    conv_kernel<Tin, Acc, Tout, 5, 5><<<grid, THREADS, smem, st>>>(xi, wi, o, H, W, Cin, F, kh, kw, cc);
  else if (kh == 3 && kw == 3)
    conv_kernel<Tin, Acc, Tout, 3, 3><<<grid, THREADS, smem, st>>>(xi, wi, o, H, W, Cin, F, kh, kw, cc);
  else
    conv_kernel<Tin, Acc, Tout, 0, 0><<<grid, THREADS, smem, st>>>(xi, wi, o, H, W, Cin, F, kh, kw, cc);
  return (int)cudaGetLastError();
}

}  // namespace

// x [B,H,W,Cin], w [kh,kw,Cin,F], both int16 (is_float = 0; out int32) or both f32
// (is_float = 1; out f32), contiguous.  Returns the cudaError_t of the launch.
extern "C" int repro_conv2d(const void* x, const void* w, void* out, int B, int H, int W, int Cin,
                            int kh, int kw, int F, int is_float, void* stream) {
  if (B < 1 || B > 65535 || Cin < 1 || F < 1 || kh < 1 || kw < 1 || H < kh || W < kw)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_float) return launch<float, float, float>(x, w, out, B, H, W, Cin, kh, kw, F, st);
  return launch<int16_t, uint32_t, int32_t>(x, w, out, B, H, W, Cin, kh, kw, F, st);
}
