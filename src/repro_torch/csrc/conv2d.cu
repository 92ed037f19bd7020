// VALID stride-1 2-D convolution for Hopper: out[B,oh,ow,F] = x[B,H,W,Cin] (*) w[kh,kw,Cin,F],
// NHWC x HWIO, oh = H-kh+1, ow = W-kw+1.  Two type paths:
//   int16 in, int32 accumulate, int32 out (exact; sums past 2^31 wrap as two's complement);
//   f32 in, f32 accumulate (fmaf), f32 out.
//
// Replaces the Pallas TPU kernel repro/kernels/conv2d.py::conv2d (_conv_kernel), which
// unrolls the kh*kw taps as shifted MXU products over one VMEM-resident image.  It runs on
// the CUDA cores: Hopper's integer tensor cores take int8 and int4 operands, not int16, and
// the paper's roles (Cin 1, F 1 or 2) give no product to tile.  What bounds it on the H100:
// few operations per byte (2*kh*kw*Cin*F per output pixel: 50 for the 5x5x1x1 role, 36
// for the 3x3x1x2 one), so bytes once the card is full; one 64x64 frame is a few
// microseconds of launch and one memory trip.  The design:
//   - filters sized to F: the filter chunk FCH is 1, 2, 4 or 8 (a template parameter picked
//     from F), so role 3 (F = 1) and role 4 (F = 2) do no padded multiply-adds; F above 8
//     takes chunks of 8, each a work item of its own;
//   - a strip of P = 4 consecutive output pixels of one row a thread, TX = 16 strips across
//     and TY = 16 rows a tile (64 x 16 output pixels, 256 threads).  For one input channel
//     and the 5x5 and 3x3 filters the thread slides the kw-wide window through registers, so
//     one shared-memory read feeds up to kw multiply-adds, and holds the filter's taps in
//     registers (25 or 18 values at the roles), loaded once a block; other shapes read their
//     taps from a shared-memory slab (a broadcast);
//   - persistent blocks: the grid is capped at the SMs times the blocks an SM holds, and a
//     block walks (frame, tile, filter chunk) work items with a grid stride, so any number
//     of frames B;
//   - a two-slot cp.async ring stages the input rows of the next work item (the tile's rows
//     plus the kh-1 halo, kw-1 halo columns) while the current one computes, in the input's
//     own type (widened on read); 16-, 8- or 4-byte copies, the widest that the rows'
//     alignment allows (odd int16 rows: plain 2-byte loads).  Channels that do not fit the
//     48 KB slot budget are staged in chunks (then the filter slab too);
//   - a filter whose one-channel slab would pass the 227 KB a block may hold with the ring
//     (a 68x68 filter of eight f32 filters: 148 KB of taps beside 88 KB of input rows) is
//     staged through the slab in chunks of its rows, KHC rows at a time, between barriers:
//     the taps are read in the same (dy, dx, c) order, so the sums are those of one slab;
//   - a filter so tall that the ring's input rows alone pass it (a 200x200 f32 filter:
//     two slots of 215 rows, 454 KB) stages the input in slabs too (in_slab): one slot,
//     and with each slab of KHC filter rows the TY + KHC - 1 input rows that slab reads,
//     copied between the same barriers.  The accumulators carry across the slabs, so each
//     output's sum is still taken in (dy, dx, c) order;
//   - each strip's P*F outputs are contiguous in NHWC: 16-byte evict-first stores where F
//     equals the filter chunk and the strip is aligned, scalar ones otherwise.
// Launched as the matmul kernels are (programmatic dependent launch): a launch may begin while
// the kernel before it on the stream finishes, and waits for it before its first read.
// Integer sums are taken in uint32_t: signed overflow is undefined in C++, unsigned arithmetic
// wraps mod 2^32, which is what XLA's int32 convolution gives.  f32 sums each output in
// (channel chunk, dy, dx, c) order, fixed by the shape alone, so a frame's output is bitwise
// the same at any B and any place in the batch, and the fixed-weight role (the same kernel
// on a resident filter) is bitwise the generic call.
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int P = 4;                     // output pixels a thread: a strip of one output row
constexpr int TX = 16;                   // strips across a tile
constexpr int TY = THREADS / TX;         // output rows a tile
constexpr int TC = TX * P;               // output columns a tile
constexpr int SMEM_SMALL = 48 * 1024;    // channels a chunk: the most that fit this budget
constexpr int SMEM_MAX = 227 * 1024;     // else one channel, up to the opt-in limit

// n / d for 0 <= n < 2^31 by a multiply and a shift (d = 1: n), the multiplier computed on
// the host (Granlund and Montgomery's method, as CUTLASS's FastDivmod): a work item's and a
// copy's indices are divided by per-launch constants in every stage.
struct FastDiv {
  uint32_t d, m, s;
};

FastDiv fast_div(uint32_t d) {
  FastDiv f{d, 0u, 0u};
  if (d > 1) {
    int l = 0;
    while ((1ull << l) < d) ++l;  // ceil(log2 d)
    const uint32_t p = 31 + l;
    f.m = static_cast<uint32_t>(((1ull << p) + d - 1) / d);
    f.s = p - 32;
  }
  return f;
}

__device__ __forceinline__ uint32_t fdiv(uint32_t n, const FastDiv& f) {
  return f.d == 1 ? n : __umulhi(n, f.m) >> f.s;
}

// A launch's geometry, computed on the host.
struct Geom {
  int H, W, Cin, F, kh, kw, oh, ow;
  int tiles_y, tiles_x, nfc;  // tiles down and across a frame; filter chunks
  int cc, ncc;                // channels a staged chunk; chunks
  int khc, nkc;               // filter rows a slab holds; slabs a channel chunk (1: whole)
  int in_slab;                // 1: the input rows are staged with each filter slab, one slot
  int ir, ic, pitch;          // staged input rows, pixels a row, bytes a row (16-byte multiple)
  int slot, ws_off;           // bytes a ring slot; offset of the filter slab
  int vbytes;                 // copy width: 16, 8 or 4 (cp.async), 2 (plain int16 loads)
  int runs, per_run, units;   // copy runs a staged row, copies a run, copies a stage
  FastDiv by_frame, by_row, by_fc, by_per_run, by_runs;
  long long items;            // B * tiles_y * tiles_x * nfc
};

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

__device__ __forceinline__ uint32_t bits(uint32_t v) { return v; }
__device__ __forceinline__ uint32_t bits(float v) { return __float_as_uint(v); }

// A copy of `bytes` (at most vbytes; zeros past them) from device to shared memory that the
// thread does not wait for.
__device__ __forceinline__ void cp_async(void* dst, const void* src, int bytes, int vbytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (vbytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(bytes));
  else if (vbytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s), "l"(src), "r"(bytes));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src), "r"(bytes));
}

struct Item {
  long long b;
  int ty, tx, fc;
};

// Work item -> (frame, tile down, tile across, filter chunk), items in that order.
__device__ __forceinline__ Item decode(long long item, const Geom& g) {
  Item it;
  if (g.items <= 0x7fffffffLL) {
    const uint32_t n = static_cast<uint32_t>(item);
    const uint32_t b = fdiv(n, g.by_frame), r = n - b * g.by_frame.d;
    const uint32_t ty = fdiv(r, g.by_row), c = r - ty * g.by_row.d;
    const uint32_t tx = fdiv(c, g.by_fc);
    it.b = b, it.ty = ty, it.tx = tx, it.fc = c - tx * g.by_fc.d;
  } else {
    const long long per_frame = g.by_frame.d, per_row = g.by_row.d;
    it.b = item / per_frame;
    const int r = static_cast<int>(item - it.b * per_frame);
    it.ty = r / static_cast<int>(per_row);
    const int c = r - it.ty * static_cast<int>(per_row);
    it.tx = c / g.nfc, it.fc = c - it.tx * g.nfc;
  }
  return it;
}

// Start the copies of one stage (a work item's channel chunk) into a ring slot: the tile's
// input rows that lie in the image, each the pixels [ox0, ox0 + ic) that lie in it, as
// `runs` runs of `per_run` copies (one run of whole pixels when a chunk holds every
// channel, else one a pixel).  Staged rows and columns past the image keep what they held:
// only outputs past oh or ow, which are never stored, read them.
template <typename Tin>
__device__ __forceinline__ void stage(unsigned char* slot, const Tin* __restrict__ x,
                                      const Geom& g, long long item, int chunk) {
  constexpr int SZ = sizeof(Tin);
  const Item it = decode(item, g);
  const int oy0 = it.ty * TY, ox0 = it.tx * TC, ch0 = chunk * g.cc;
  const int nc = min(g.cc, g.Cin - ch0);
  const int rows = min(g.ir, g.H - oy0), npx = min(g.ic, g.W - ox0);
  const bool flat = g.cc == g.Cin;
  const int run_bytes = flat ? npx * g.Cin * SZ : nc * SZ;
  const Tin* xb = x + static_cast<size_t>(it.b) * g.H * g.W * g.Cin;
  for (int i = threadIdx.x; i < g.units; i += THREADS) {
    const uint32_t q = fdiv(static_cast<uint32_t>(i), g.by_per_run);
    const uint32_t r = fdiv(q, g.by_runs);
    const int run = q - r * g.runs, off = (i - q * g.per_run) * g.vbytes;
    if (static_cast<int>(r) >= rows || run >= (flat ? 1 : npx) || off >= run_bytes) continue;
    const unsigned char* src = reinterpret_cast<const unsigned char*>(
        xb + (static_cast<size_t>(oy0 + r) * g.W + ox0 + run) * g.Cin + (flat ? 0 : ch0)) + off;
    unsigned char* dst = slot + r * g.pitch + run * g.cc * SZ + off;
    if (g.vbytes >= 4)
      cp_async(dst, src, min(g.vbytes, run_bytes - off), g.vbytes);
    else
      *reinterpret_cast<Tin*>(dst) = *reinterpret_cast<const Tin*>(src);
  }
}

// in_slab: the input rows [dy0, dy0 + TY + khc - 1) of work item `it`'s tile that lie in
// the image, channel `chunk` (one channel a chunk), the pixels [ox0, ox0 + ic) that lie in
// it, into the slot: plain loads, waited for at the barrier after them.
template <typename Tin>
__device__ __forceinline__ void load_rows(unsigned char* slot, const Tin* __restrict__ x,
                                          const Geom& g, const Item& it, int chunk, int dy0) {
  const int oy0 = it.ty * TY + dy0, ox0 = it.tx * TC;
  const int rows = min(TY + g.khc - 1, g.H - oy0), npx = min(g.ic, g.W - ox0);
  const int pe = g.pitch / static_cast<int>(sizeof(Tin));
  const Tin* xb = x + static_cast<size_t>(it.b) * g.H * g.W * g.Cin + chunk;
  Tin* xs = reinterpret_cast<Tin*>(slot);
  for (int i = threadIdx.x; i < rows * npx; i += THREADS) {
    const int r = i / npx, px = i - r * npx;
    xs[r * pe + px] = xb[(static_cast<size_t>(oy0 + r) * g.W + ox0 + px) * g.Cin];
  }
}

// The filter slab of filter chunk fc, channel chunk `chunk` and the filter rows [dy0, dy0 +
// khc): ws[tap][c][f], tap = (dy - dy0)*kw+dx, zeros past Cin and F.
template <typename Tin, typename Acc, int FCH>
__device__ __forceinline__ void load_filter(Acc* ws, const Tin* __restrict__ w, const Geom& g,
                                            int fc, int chunk, int dy0 = 0) {
  const int f0 = fc * FCH, ch0 = chunk * g.cc, nc = min(g.cc, g.Cin - ch0);
  const int n = min(g.khc, g.kh - dy0) * g.kw * g.cc * FCH;
  for (int i = threadIdx.x; i < n; i += THREADS) {
    const int f = i % FCH, rest = i / FCH, c = rest % g.cc, tap = dy0 * g.kw + rest / g.cc;
    ws[i] = (c < nc && f0 + f < g.F)
                ? widen<Acc>(w[(static_cast<size_t>(tap) * g.Cin + ch0 + c) * g.F + f0 + f])
                : Acc(0);
  }
}

// A strip's window of NW elements at xr, widened, read as 8-byte words: a strip starts
// tx * P elements into a 16-byte aligned staged row, so its window is 8-byte aligned, and the
// row's padding to 16 bytes holds the last word.
template <typename Tin, typename Acc, int NW>
__device__ __forceinline__ void load_window(Acc (&v)[NW], const Tin* xr) {
  constexpr int NB = (NW * static_cast<int>(sizeof(Tin)) + 7) / 8;
  uint2 u[NB];
#pragma unroll
  for (int i = 0; i < NB; ++i) u[i] = reinterpret_cast<const uint2*>(xr)[i];
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    if constexpr (sizeof(Tin) == 2) {
      const uint32_t wd = (j & 2) ? u[j >> 2].y : u[j >> 2].x;
      v[j] = widen<Acc>(static_cast<int16_t>(wd >> (16 * (j & 1))));
    } else {
      v[j] = widen<Acc>(__uint_as_float((j & 1) ? u[j >> 1].y : u[j >> 1].x));
    }
  }
}

// ONE_CH: one input channel and a compile-time filter (5x5, 3x3): the window slides through
// registers.  Otherwise KH = KW = 0 and the filter size is read from g.
template <typename Tin, typename Acc, int KH, int KW, int FCH, bool ONE_CH>
__global__ void __launch_bounds__(THREADS, ONE_CH && FCH <= 2 ? 4 : 1)
    conv_kernel(const Tin* __restrict__ x, const Tin* __restrict__ w, uint32_t* __restrict__ out,
                const Geom g) {
  constexpr bool REG_TAPS = ONE_CH && KH * KW * FCH <= 32;  // the roles: 25 and 18 taps
  constexpr int NTAPS = REG_TAPS ? KH * KW * FCH : 1;
  extern __shared__ __align__(16) unsigned char smem[];
  Acc* ws = reinterpret_cast<Acc*>(smem + g.ws_off);
  const int kh = KH ? KH : g.kh, kw = KW ? KW : g.kw;
  const int ty = threadIdx.x / TX, tx = threadIdx.x % TX;
  const int pe = g.pitch / static_cast<int>(sizeof(Tin));  // elements a staged row

  long long item = blockIdx.x;
  if (item >= g.items) return;
  grid_dependency_wait();  // the kernel before this one on the stream has written x and w
  launch_dependents();
  int chunk = 0, buf = 0, loaded = -1;
  if (!g.in_slab) stage<Tin>(smem, x, g, item, 0);
  cp_async_commit();

  Acc taps[NTAPS];
  Acc acc[P][FCH];
  for (;;) {
    long long next = item;
    int nchunk = chunk + 1;
    if (nchunk == g.ncc) {
      nchunk = 0;
      next += gridDim.x;
    }
    const bool more = next < g.items;
    if (more && !g.in_slab) stage<Tin>(smem + (buf ^ 1) * g.slot, x, g, next, nchunk);
    cp_async_commit();

    const Item it = decode(item, g);
    const int key = it.fc * g.ncc + chunk;
    // a filter staged in row slabs loads them as the rows come (below)
    const bool new_filter = key != loaded && g.nkc == 1 && !g.in_slab;
    if (new_filter) load_filter<Tin, Acc, FCH>(ws, w, g, it.fc, chunk);
    cp_async_wait<1>();  // this stage's copies have landed (the next stage's may not)
    __syncthreads();
    if (REG_TAPS && new_filter) {
#pragma unroll
      for (int i = 0; i < NTAPS; ++i) taps[i] = ws[i];
    }
    loaded = key;
    if (chunk == 0) {
#pragma unroll
      for (int p = 0; p < P; ++p)
#pragma unroll
        for (int f = 0; f < FCH; ++f) acc[p][f] = Acc(0);
    }

    const Tin* xs = reinterpret_cast<const Tin*>(smem + (g.in_slab ? 0 : buf * g.slot));
    if constexpr (ONE_CH) {
#pragma unroll
      for (int dy = 0; dy < KH; ++dy) {
        Acc v[P + KW - 1];
        load_window<Tin, Acc>(v, xs + (ty + dy) * pe + tx * P);
#pragma unroll
        for (int dx = 0; dx < KW; ++dx)
#pragma unroll
          for (int f = 0; f < FCH; ++f) {
            const Acc t = REG_TAPS ? taps[REG_TAPS ? (dy * KW + dx) * FCH + f : 0]
                                   : ws[(dy * KW + dx) * FCH + f];
#pragma unroll
            for (int p = 0; p < P; ++p) mac(acc[p][f], v[p + dx], t);
          }
      }
    } else {
      const int nc = min(g.cc, g.Cin - chunk * g.cc);
      for (int dy = 0; dy < kh; ++dy) {
        const int dy0 = dy - dy % g.khc;  // the slab holding row dy
        if ((g.nkc > 1 || g.in_slab) && dy == dy0) {
          __syncthreads();  // every thread is done with the previous slab
          load_filter<Tin, Acc, FCH>(ws, w, g, it.fc, chunk, dy0);
          if (g.in_slab) load_rows<Tin>(smem, x, g, it, chunk, dy0);
          __syncthreads();
        }
        // in_slab: the slot holds the input rows from the slab's first, dy0
        const int row = ty + dy - (g.in_slab ? dy0 : 0);
        for (int dx = 0; dx < kw; ++dx) {
          const Tin* xp = xs + row * pe + (tx * P + dx) * g.cc;
          const Acc* wp = ws + ((dy - dy0) * kw + dx) * g.cc * FCH;
          for (int c = 0; c < nc; ++c) {
            Acc wv[FCH];
#pragma unroll
            for (int f = 0; f < FCH; ++f) wv[f] = wp[c * FCH + f];
#pragma unroll
            for (int p = 0; p < P; ++p) {
              const Acc v = widen<Acc>(xp[p * g.cc + c]);
#pragma unroll
              for (int f = 0; f < FCH; ++f) mac(acc[p][f], v, wv[f]);
            }
          }
        }
      }
    }

    if (chunk == g.ncc - 1) {
      const int oy = it.ty * TY + ty, ox = it.tx * TC + tx * P, f0 = it.fc * FCH;
      if (oy < g.oh && ox < g.ow) {
        uint32_t* o = out + ((static_cast<size_t>(it.b) * g.oh + oy) * g.ow + ox) * g.F + f0;
        const int np = min(P, g.ow - ox);
        if (np == P && FCH == g.F && (reinterpret_cast<uintptr_t>(o) & 15) == 0) {
#pragma unroll
          for (int q = 0; q < P * FCH / 4; ++q)
            __stcs(reinterpret_cast<uint4*>(o) + q,
                   make_uint4(bits(acc[(4 * q) / FCH][(4 * q) % FCH]),
                              bits(acc[(4 * q + 1) / FCH][(4 * q + 1) % FCH]),
                              bits(acc[(4 * q + 2) / FCH][(4 * q + 2) % FCH]),
                              bits(acc[(4 * q + 3) / FCH][(4 * q + 3) % FCH])));
        } else {
#pragma unroll
          for (int p = 0; p < P; ++p)
#pragma unroll
            for (int f = 0; f < FCH; ++f)
              if (p < np && f0 + f < g.F) __stcs(o + p * g.F + f, bits(acc[p][f]));
        }
      }
    }
    __syncthreads();  // every thread is done with this slot and the slab before they change
    if (!more) break;
    item = next;
    chunk = nchunk;
    buf ^= 1;
  }
}

int round16(long long n) { return static_cast<int>((n + 15) / 16 * 16); }

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

template <typename Tin, typename Acc, int KH, int KW, int FCH, bool ONE_CH>
int run(const void* x, const void* w, void* out, const Geom& g, int smem, cudaStream_t st) {
  auto k = conv_kernel<Tin, Acc, KH, KW, FCH, ONE_CH>;
  if (smem > SMEM_SMALL) {
    cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, THREADS, smem);
  const long long cap = static_cast<long long>(sm_count()) * (per_sm > 0 ? per_sm : 1);
  const int blocks = static_cast<int>(g.items < cap ? g.items : cap);
  return static_cast<int>(launch_overlapped(k, dim3(blocks), THREADS, smem, st,
                                            static_cast<const Tin*>(x),
                                            static_cast<const Tin*>(w),
                                            static_cast<uint32_t*>(out), g));
}

template <typename Tin, typename Acc, int FCH>
int pick(const void* x, const void* w, void* out, const Geom& g, int smem, cudaStream_t st) {
  if (g.Cin == 1 && g.kh == 5 && g.kw == 5)
    return run<Tin, Acc, 5, 5, FCH, true>(x, w, out, g, smem, st);
  if (g.Cin == 1 && g.kh == 3 && g.kw == 3)
    return run<Tin, Acc, 3, 3, FCH, true>(x, w, out, g, smem, st);
  return run<Tin, Acc, 0, 0, FCH, false>(x, w, out, g, smem, st);
}

template <typename Tin, typename Acc>
int launch(const void* x, const void* w, void* out, long long B, int H, int W, int Cin, int kh,
           int kw, int F, cudaStream_t st) {
  constexpr int SZ = sizeof(Tin);
  Geom g{};
  g.H = H, g.W = W, g.Cin = Cin, g.F = F, g.kh = kh, g.kw = kw;
  g.oh = H - kh + 1, g.ow = W - kw + 1;
  g.tiles_y = (g.oh + TY - 1) / TY, g.tiles_x = (g.ow + TC - 1) / TC;
  const int fch = F <= 1 ? 1 : F <= 2 ? 2 : F <= 4 ? 4 : 8;
  g.nfc = (F + fch - 1) / fch;
  g.ir = TY + kh - 1, g.ic = TC + kw - 1;
  // bytes of a block at cc channels a chunk and a slab of khc filter rows: two ring slots
  // and the filter slab
  auto bytes = [&](int cc, int khc) {
    return 2LL * g.ir * round16(static_cast<long long>(g.ic) * cc * SZ) +
           round16(static_cast<long long>(khc) * kw * cc * fch * 4);
  };
  // in_slab: one slot of the TY + khc - 1 input rows a slab of khc filter rows reads, and
  // that slab
  auto slab_bytes = [&](int khc) {
    return static_cast<long long>(TY + khc - 1) * round16(static_cast<long long>(g.ic) * SZ) +
           round16(static_cast<long long>(khc) * kw * fch * 4);
  };
  const long long per_channel = bytes(1, kh);
  int cc = 1, khc = kh, in_slab = 0;
  if (per_channel > SMEM_MAX) {
    // one channel a chunk, the filter staged in slabs of the most rows that fit
    while (khc > 0 && bytes(1, khc) > SMEM_MAX) --khc;
    if (khc < 1) {
      // not even one filter row fits beside the ring: the input rows go in slabs too
      in_slab = 1;
      khc = kh;
      while (khc > 0 && slab_bytes(khc) > SMEM_MAX) --khc;
      if (khc < 1) return static_cast<int>(cudaErrorInvalidValue);
    }
  } else {
    cc = static_cast<int>(per_channel <= SMEM_SMALL ? SMEM_SMALL / per_channel : 1);
    cc = cc < Cin ? (cc < 1 ? 1 : cc) : Cin;
    while (cc > 1 && bytes(cc, kh) > SMEM_SMALL) --cc;
  }
  g.cc = cc, g.ncc = (Cin + cc - 1) / cc;
  g.khc = khc, g.nkc = (kh + khc - 1) / khc, g.in_slab = in_slab;
  g.pitch = round16(static_cast<long long>(g.ic) * cc * SZ);
  g.slot = in_slab ? (TY + khc - 1) * g.pitch : g.ir * g.pitch;
  g.ws_off = in_slab ? g.slot : 2 * g.slot;
  const int smem = static_cast<int>(in_slab ? slab_bytes(khc) : bytes(cc, khc));
  g.items = B * g.tiles_y * g.tiles_x * g.nfc;
  // the widest copy that every staged run's source and destination are aligned to
  const uintptr_t base = reinterpret_cast<uintptr_t>(x);
  auto fits = [&](int v) {
    if (base % v) return false;
    if (cc == Cin) return (static_cast<long long>(W) * Cin * SZ) % v == 0;
    return (Cin * SZ) % v == 0 && (cc * SZ) % v == 0;
  };
  g.vbytes = fits(16) ? 16 : fits(8) ? 8 : fits(4) ? 4 : SZ;
  g.runs = cc == Cin ? 1 : g.ic;
  g.per_run = static_cast<int>(((cc == Cin ? static_cast<long long>(g.ic) * Cin : cc) * SZ +
                                g.vbytes - 1) / g.vbytes);
  g.units = g.ir * g.runs * g.per_run;
  g.by_frame = fast_div(static_cast<uint32_t>(g.tiles_y * g.tiles_x * g.nfc));
  g.by_row = fast_div(static_cast<uint32_t>(g.tiles_x * g.nfc));
  g.by_fc = fast_div(static_cast<uint32_t>(g.nfc));
  g.by_per_run = fast_div(static_cast<uint32_t>(g.per_run));
  g.by_runs = fast_div(static_cast<uint32_t>(g.runs));
  if (fch == 1) return pick<Tin, Acc, 1>(x, w, out, g, smem, st);
  if (fch == 2) return pick<Tin, Acc, 2>(x, w, out, g, smem, st);
  if (fch == 4) return pick<Tin, Acc, 4>(x, w, out, g, smem, st);
  return pick<Tin, Acc, 8>(x, w, out, g, smem, st);
}

}  // namespace

// x [B,H,W,Cin], w [kh,kw,Cin,F], both int16 (is_float = 0; out int32) or both f32
// (is_float = 1; out f32), contiguous; any B.  Returns the cudaError_t of the launch
// (cudaErrorInvalidValue for a filter whose 16 output rows' input and one filter row pass
// the shared memory).
extern "C" int repro_conv2d(const void* x, const void* w, void* out, long long B, int H, int W,
                            int Cin, int kh, int kw, int F, int is_float, void* stream) {
  if (B < 1 || Cin < 1 || F < 1 || kh < 1 || kw < 1 || H < kh || W < kw)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_float) return launch<float, float>(x, w, out, B, H, W, Cin, kh, kw, F, st);
  return launch<int16_t, uint32_t>(x, w, out, B, H, W, Cin, kh, kw, F, st);
}
