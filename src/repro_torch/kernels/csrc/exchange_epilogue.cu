// The lossy exchange's fused epilogue and its int8 codec core, over the
// packed (G, N) float32 stream buffers of the local-SGD round (DESIGN.md
// §8, §11).
//
// Replaces the TPU Pallas kernels of src/repro/kernels/exchange_epilogue.py:
//   codec_mix  encode + decode + mix of one stream in one pass: the delta
//              x - x0 through int8 (per-chunk scale, stochastic rounding
//              with the noise passed in), bf16 or fp16, then the exact
//              G-mean (server) or `hops` hops of a (G, G) W (ring,
//              gossip: each hop re-encodes y - ref against the last
//              decoded payload); kind thresh is top-k's select + mean +
//              error-feedback residual once the per-row threshold is known
//   qdq_int8   per-row int8 quantize + dequantize of (rows, chunk) with
//              the noise passed in: the staged codec core (int8z,
//              async_stale, the downlink codec)
//
// Bound on an H100: HBM bytes. codec_mix reads x, x0 and (int8) one noise
// float per hop, writes the mix: 16 bytes per element for int8 on the
// mean, 12 for bf16/fp16, 20 for thresh (x, x0, residual in; mix and
// residual out). qdq_int8 reads x and u and writes the output: 12 bytes.
// A handful of flops per element, so G*N*bytes / 3.35 TB/s is the floor
// (2.38, 1.79 and 2.98 ms for codec_mix, 1.79 ms for qdq_int8 at G = 4
// on paper-lenet's N = 124,662,528).
//
// Layout of codec_mix: a block of 256 threads owns one 256-column chunk
// across all G rows (grid-stride over chunks); thread t holds column t
// of every row in registers (G <= 16, a template bound of 4, 8 or 16),
// so every hop's encode, decode and mix runs without touching memory,
// and one int8 scale per (row, chunk) is a block-wide max (warp
// shuffles, then one shared-memory stage); each hop's noise is loaded a
// hop ahead, so its latency overlaps that max. Every byte moves once;
// loads and stores are coalesced 4-byte accesses along each row (rows
// of a ragged N start at any alignment). A block reads all G values of its
// columns before it writes any, and no other block touches them, so the
// mix may be written over x in place (the wrapper does so), and the
// thresh residual over the residual. The (G, G) W comes by value in the
// kernel's parameters at a fixed row stride, so every index into it is
// known at compile time. The noise is the staged path's (hops, G*nchunks,
// 256) rows, so the result equals the staged codec's.
//
// Any other stream (G > 16, or an int8 chunk other than 256) takes
// codec_mix_wide: a block of 256 threads owns one window of columns (the
// int8 chunk, any width, else 256) across all G rows, and thread t the
// window's columns t, t + 256, ...; the rows are walked one at a time, so
// G has no limit. On the mean a row is added into a running column sum as
// soon as it is decoded (the sum runs over g = 0..G-1 in order, as on the
// fast path); with a W each column's y and ref of every row live in the
// block's slice of a global scratch (2 * G * window floats, L2-resident),
// where the W contraction reads them. int8 takes the row's window max in a
// first pass and reads the window again to quantize it. Only the max is
// shared between threads; every other value of a column is read and
// written by the thread that owns it, so the mix may again be written
// over x in place. W comes as a device pointer.
//
// Layout of qdq_int8: one warp per row; grid-stride over rows on
// gridDim.x, so there is no limit on the row count (paper-lenet's
// 1,947,852 rows). A row of 256 is two float4 per lane, held in registers
// between the row max (warp shuffles) and the write. Any other chunk
// takes the row's max in a first pass and reads it again (from L1) with
// its noise, float4 by float4 where the chunk is a multiple of 4 and the
// buffers are 16-byte aligned, else element by element, as
// csrc/quantize.cu does. Both kernels launch at most one wave of resident
// blocks.
//
// Rounding: each operation is one IEEE round-to-nearest step written as
// an intrinsic (__fdiv_rn for amax/127 and x/scale, never a reciprocal;
// __fadd_rn, __fmul_rn; floorf; the casts __float2bfloat16_rn and
// __float2half_rn, overflow to inf), the mean is a sequential sum over
// g = 0..G-1 then one division by G, and the W contraction a sequential
// sum over k: the plain versions (kernels/ref.py) repeat this order, so
// kernel and plain version agree bit for bit.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kChunk = 256;  // the int8 chunk, and codec_mix's block width
constexpr int kWarps = kChunk / 32;
constexpr int kMaxG = 16;

enum Kind { kInt8 = 0, kBf16 = 1, kFp16 = 2, kThresh = 3 };

struct MixArgs {
  const float* x;
  const float* x0;
  const float* u;    // (hops, g * nchunks, 256), int8 only
  const float* res;  // (g, n), thresh only
  const float* tau;  // (g,), thresh only
  float* out;        // may be x
  float* res_out;    // may be res
  int64_t n, nchunks;
  int g, hops;
  float w[kMaxG * kMaxG];  // w[i * kMaxG + k]; unused on the mean
};

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float qdq(float v, float u, float scale) {
  const float q = floorf(__fadd_rn(__fdiv_rn(v, scale), u));
  return __fmul_rn(fminf(fmaxf(q, -127.0f), 127.0f), scale);
}

// Loads hop h's int8 noise for column t of chunk c, every row.
template <int MAXG>
__device__ __forceinline__ void load_noise(const float* u, int64_t nchunks, int G, int h,
                                           int64_t c, int t, float* un) {
  const float* uh = u + (static_cast<int64_t>(h) * G * nchunks + c) * kChunk + t;
#pragma unroll
  for (int g = 0; g < MAXG; ++g) un[g] = g < G ? uh[g * nchunks * kChunk] : 0.0f;
}

// Max of one float a thread over the block; every thread gets it.
__device__ __forceinline__ float block_max(float m) {
  __shared__ float red[kWarps];
  m = warp_max(m);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = m;
  __syncthreads();
  m = red[0];
#pragma unroll
  for (int k = 1; k < kWarps; ++k) m = fmaxf(m, red[k]);
  __syncthreads();  // red is rewritten by the next call
  return m;
}

// One decoded delta of a width codec (int8 with its scale and noise).
template <int KIND>
__device__ __forceinline__ float decoded(float d, float u, float scale) {
  if (KIND == kInt8) return qdq(d, u, scale);
  if (KIND == kBf16) return __bfloat162float(__float2bfloat16_rn(d));
  return __half2float(__float2half_rn(d));
}

template <int MAXG, int KIND, bool MEAN>
__global__ void __launch_bounds__(kChunk) codec_mix_kernel(const MixArgs a) {
  __shared__ float red[kWarps][MAXG];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int G = a.g;
  const int hops = MEAN ? 1 : a.hops;
  for (int64_t c = blockIdx.x; c < a.nchunks; c += gridDim.x) {
    const int64_t col = c * kChunk + t;
    const bool valid = col < a.n;
    float y[MAXG], ref[MAXG];
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      const bool in = g < G && valid;
      y[g] = in ? a.x[g * a.n + col] : 0.0f;
      ref[g] = in ? a.x0[g * a.n + col] : 0.0f;
    }
    // int8 noise is loaded one hop ahead (hop 0's with x and x0), so
    // that its latency overlaps the block-wide max instead of following it
    float un[MAXG];
    if (KIND == kInt8) load_noise<MAXG>(a.u, a.nchunks, G, 0, c, t, un);
    if (KIND == kThresh) {
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        if (g < G) {
          const float r = valid ? a.res[g * a.n + col] : 0.0f;
          const float cg = __fadd_rn(__fsub_rn(y[g], ref[g]), r);
          const float ac = fabsf(cg);
          const float dh = (ac >= a.tau[g] && ac > 0.0f) ? cg : 0.0f;
          if (valid) a.res_out[g * a.n + col] = __fsub_rn(cg, dh);
          ref[g] = __fadd_rn(ref[g], dh);
        }
      }
    } else {
      for (int h = 0; h < hops; ++h) {
        float d[MAXG];
#pragma unroll
        for (int g = 0; g < MAXG; ++g) d[g] = __fsub_rn(y[g], ref[g]);
        if (KIND == kInt8) {
          float uh[MAXG];
#pragma unroll
          for (int g = 0; g < MAXG; ++g) uh[g] = un[g];
          if (h + 1 < hops) load_noise<MAXG>(a.u, a.nchunks, G, h + 1, c, t, un);
#pragma unroll
          for (int g = 0; g < MAXG; ++g) {
            if (g < G) {
              const float m = warp_max(fabsf(d[g]));
              if (lane == 0) red[warp][g] = m;
            }
          }
          __syncthreads();
#pragma unroll
          for (int g = 0; g < MAXG; ++g) {
            if (g < G) {
              float m = red[0][g];
#pragma unroll
              for (int k = 1; k < kWarps; ++k) m = fmaxf(m, red[k][g]);
              const float scale = m > 0.0f ? __fdiv_rn(m, 127.0f) : 1.0f;
              d[g] = qdq(d[g], uh[g], scale);
            }
          }
          __syncthreads();  // red is rewritten by the next hop or chunk
        } else if (KIND == kBf16) {
#pragma unroll
          for (int g = 0; g < MAXG; ++g) d[g] = __bfloat162float(__float2bfloat16_rn(d[g]));
        } else {
#pragma unroll
          for (int g = 0; g < MAXG; ++g) d[g] = __half2float(__float2half_rn(d[g]));
        }
#pragma unroll
        for (int g = 0; g < MAXG; ++g) ref[g] = __fadd_rn(ref[g], d[g]);
        if (!MEAN) {
#pragma unroll
          for (int i = 0; i < MAXG; ++i) {
            float acc = 0.0f;
            if (i < G) {
              acc = __fmul_rn(a.w[i * kMaxG], ref[0]);
#pragma unroll
              for (int k = 1; k < MAXG; ++k) {
                if (k < G) acc = __fadd_rn(acc, __fmul_rn(a.w[i * kMaxG + k], ref[k]));
              }
            }
            y[i] = acc;
          }
        }
      }
    }
    if (MEAN) {
      float s = ref[0];
#pragma unroll
      for (int g = 1; g < MAXG; ++g) {
        if (g < G) s = __fadd_rn(s, ref[g]);
      }
      s = __fdiv_rn(s, static_cast<float>(G));
#pragma unroll
      for (int g = 0; g < MAXG; ++g) y[g] = s;
    }
    if (valid) {
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        if (g < G) a.out[g * a.n + col] = y[g];
      }
    }
  }
}

struct WideArgs {
  const float* x;
  const float* x0;
  const float* u;    // (hops, g * nwin, win), int8 only
  const float* res;  // (g, n), thresh only
  const float* tau;  // (g,), thresh only
  const float* w;    // (g, g) on the device; unused on the mean
  float* out;        // may be x
  float* res_out;    // may be res
  float* ws;         // per block: win floats (mean) or 2 * g * win (W)
  int64_t n, win, nwin;
  int g, hops;
};

// The window's int8 scale of row g: the max of |y - ref| over the window
// (columns past n count as 0), from every thread's columns.
template <class Delta>
__device__ __forceinline__ float window_scale(int64_t win, Delta delta) {
  float m = 0.0f;
  for (int64_t j = threadIdx.x; j < win; j += kChunk) m = fmaxf(m, fabsf(delta(j)));
  m = block_max(m);
  return m > 0.0f ? __fdiv_rn(m, 127.0f) : 1.0f;
}

// The mean (server): every kind, top-k's thresh included.
template <int KIND>
__global__ void __launch_bounds__(kChunk) codec_mean_wide(const WideArgs a) {
  const int64_t win = a.win, n = a.n;
  float* acc = a.ws + static_cast<int64_t>(blockIdx.x) * win;  // the running column sums
  for (int64_t c = blockIdx.x; c < a.nwin; c += gridDim.x) {
    const int64_t col0 = c * win;
    for (int g = 0; g < a.g; ++g) {
      const float* xg = a.x + g * n + col0;
      const float* x0g = a.x0 + g * n + col0;
      const int64_t len = n - col0 < win ? n - col0 : win;  // valid columns
      float scale = 1.0f;
      if (KIND == kInt8) {
        scale = window_scale(win, [&](int64_t j) {
          return j < len ? __fsub_rn(xg[j], x0g[j]) : 0.0f;
        });
      }
      const float* ug = KIND == kInt8 ? a.u + (g * a.nwin + c) * win : nullptr;
      for (int64_t j = threadIdx.x; j < win; j += kChunk) {
        const bool valid = j < len;
        const float xv = valid ? xg[j] : 0.0f, x0v = valid ? x0g[j] : 0.0f;
        float r;
        if (KIND == kThresh) {
          const int64_t i = g * n + col0 + j;
          const float cg = __fadd_rn(__fsub_rn(xv, x0v), valid ? a.res[i] : 0.0f);
          const float ac = fabsf(cg);
          const float dh = (ac >= a.tau[g] && ac > 0.0f) ? cg : 0.0f;
          if (valid) a.res_out[i] = __fsub_rn(cg, dh);
          r = __fadd_rn(x0v, dh);
        } else {
          r = __fadd_rn(x0v, decoded<KIND>(__fsub_rn(xv, x0v),
                                            KIND == kInt8 ? ug[j] : 0.0f, scale));
        }
        acc[j] = g == 0 ? r : __fadd_rn(acc[j], r);
      }
    }
    for (int64_t j = threadIdx.x; j < win && col0 + j < n; j += kChunk) {
      const float s = __fdiv_rn(acc[j], static_cast<float>(a.g));
      for (int g = 0; g < a.g; ++g) a.out[g * n + col0 + j] = s;
    }
  }
}

// hops hops of W (ring, gossip): int8, bf16, fp16.
template <int KIND>
__global__ void __launch_bounds__(kChunk) codec_w_wide(const WideArgs a) {
  const int G = a.g;
  const int64_t win = a.win, n = a.n;
  float* ys = a.ws + static_cast<int64_t>(blockIdx.x) * 2 * G * win;  // y[g][j], then ref[g][j]
  float* rs = ys + G * win;
  for (int64_t c = blockIdx.x; c < a.nwin; c += gridDim.x) {
    const int64_t col0 = c * win;
    const int64_t len = n - col0 < win ? n - col0 : win;
    for (int g = 0; g < G; ++g) {
      for (int64_t j = threadIdx.x; j < win; j += kChunk) {
        const bool valid = j < len;
        ys[g * win + j] = valid ? a.x[g * n + col0 + j] : 0.0f;
        rs[g * win + j] = valid ? a.x0[g * n + col0 + j] : 0.0f;
      }
    }
    for (int h = 0; h < a.hops; ++h) {
      for (int g = 0; g < G; ++g) {
        float* yg = ys + g * win;
        float* rg = rs + g * win;
        float scale = 1.0f;
        if (KIND == kInt8) {
          scale = window_scale(win, [&](int64_t j) { return __fsub_rn(yg[j], rg[j]); });
        }
        const float* ug =
            KIND == kInt8 ? a.u + ((static_cast<int64_t>(h) * G + g) * a.nwin + c) * win : nullptr;
        for (int64_t j = threadIdx.x; j < win; j += kChunk) {
          rg[j] = __fadd_rn(rg[j], decoded<KIND>(__fsub_rn(yg[j], rg[j]),
                                                  KIND == kInt8 ? ug[j] : 0.0f, scale));
        }
      }
      for (int i = 0; i < G; ++i) {
        const float* wi = a.w + static_cast<int64_t>(i) * G;
        for (int64_t j = threadIdx.x; j < win; j += kChunk) {
          float acc = __fmul_rn(wi[0], rs[j]);
          for (int k = 1; k < G; ++k) acc = __fadd_rn(acc, __fmul_rn(wi[k], rs[k * win + j]));
          ys[i * win + j] = acc;
        }
      }
    }
    for (int g = 0; g < G; ++g) {
      for (int64_t j = threadIdx.x; j < len; j += kChunk) a.out[g * n + col0 + j] = ys[g * win + j];
    }
  }
}

// The grid of a grid-stride kernel: at most the blocks that fit on the
// card at once. More would run as a second, partial wave that leaves SMs
// idle at the end (the caller's count assumes 8 blocks per SM; a kernel
// with more than 32 registers a thread fits fewer).
template <class Kernel>
unsigned resident_grid(Kernel kernel, int threads, int64_t blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) == cudaSuccess &&
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) == cudaSuccess &&
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0) ==
          cudaSuccess &&
      per_sm > 0 && static_cast<int64_t>(per_sm) * sms < blocks) {
    blocks = static_cast<int64_t>(per_sm) * sms;
  }
  return static_cast<unsigned>(blocks);
}

template <int MAXG, int KIND, bool MEAN>
int launch_mix(const MixArgs& a, int64_t blocks, cudaStream_t s) {
  const unsigned grid = resident_grid(codec_mix_kernel<MAXG, KIND, MEAN>, kChunk, blocks);
  codec_mix_kernel<MAXG, KIND, MEAN><<<grid, kChunk, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int MAXG>
int launch_kind(const MixArgs& a, int kind, bool mean, int64_t blocks, cudaStream_t s) {
  switch (kind) {
    case kInt8:
      return mean ? launch_mix<MAXG, kInt8, true>(a, blocks, s)
                  : launch_mix<MAXG, kInt8, false>(a, blocks, s);
    case kBf16:
      return mean ? launch_mix<MAXG, kBf16, true>(a, blocks, s)
                  : launch_mix<MAXG, kBf16, false>(a, blocks, s);
    case kFp16:
      return mean ? launch_mix<MAXG, kFp16, true>(a, blocks, s)
                  : launch_mix<MAXG, kFp16, false>(a, blocks, s);
    case kThresh:
      return mean ? launch_mix<MAXG, kThresh, true>(a, blocks, s)
                  : static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <class Kernel>
int launch_wide(Kernel kernel, const WideArgs& a, int64_t blocks, cudaStream_t s) {
  kernel<<<resident_grid(kernel, kChunk, blocks), kChunk, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

__global__ void __launch_bounds__(256)
qdq_int8_rows(const float* __restrict__ x, const float* __restrict__ u,
              float* __restrict__ out, int64_t rows) {
  const int lane = threadIdx.x & 31;
  const int64_t per_block = blockDim.x >> 5;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * per_block;
  for (int64_t r = blockIdx.x * per_block + (threadIdx.x >> 5); r < rows; r += stride) {
    const float4* xr = reinterpret_cast<const float4*>(x + r * kChunk);
    const float4* ur = reinterpret_cast<const float4*>(u + r * kChunk);
    float4* orow = reinterpret_cast<float4*>(out + r * kChunk);
    float4 p = xr[lane], q = xr[lane + 32];
    float m = fmaxf(fmaxf(fmaxf(fabsf(p.x), fabsf(p.y)), fmaxf(fabsf(p.z), fabsf(p.w))),
                    fmaxf(fmaxf(fabsf(q.x), fabsf(q.y)), fmaxf(fabsf(q.z), fabsf(q.w))));
    m = warp_max(m);
    const float scale = m > 0.0f ? __fdiv_rn(m, 127.0f) : 1.0f;
    const float4 up = ur[lane], uq = ur[lane + 32];
    p.x = qdq(p.x, up.x, scale);
    p.y = qdq(p.y, up.y, scale);
    p.z = qdq(p.z, up.z, scale);
    p.w = qdq(p.w, up.w, scale);
    q.x = qdq(q.x, uq.x, scale);
    q.y = qdq(q.y, uq.y, scale);
    q.z = qdq(q.z, uq.z, scale);
    q.w = qdq(q.w, uq.w, scale);
    orow[lane] = p;
    orow[lane + 32] = q;
  }
}

// Any chunk: the row max in a first pass, then the row again with its
// noise. VEC: float4 steps (chunk % 4 == 0, 16-byte aligned buffers).
template <bool VEC>
__global__ void __launch_bounds__(256)
qdq_int8_any(const float* __restrict__ x, const float* __restrict__ u,
             float* __restrict__ out, int64_t rows, int64_t chunk) {
  const int lane = threadIdx.x & 31;
  const int64_t per_block = blockDim.x >> 5;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * per_block;
  for (int64_t r = blockIdx.x * per_block + (threadIdx.x >> 5); r < rows; r += stride) {
    const float* xr = x + r * chunk;
    const float* ur = u + r * chunk;
    float* orow = out + r * chunk;
    float m = 0.0f;
    if (VEC) {
      for (int64_t k = 4 * lane; k < chunk; k += 128) {
        const float4 a = *reinterpret_cast<const float4*>(xr + k);
        m = fmaxf(m, fmaxf(fmaxf(fabsf(a.x), fabsf(a.y)), fmaxf(fabsf(a.z), fabsf(a.w))));
      }
    } else {
      for (int64_t k = lane; k < chunk; k += 32) m = fmaxf(m, fabsf(xr[k]));
    }
    m = warp_max(m);
    const float scale = m > 0.0f ? __fdiv_rn(m, 127.0f) : 1.0f;
    if (VEC) {
      for (int64_t k = 4 * lane; k < chunk; k += 128) {
        float4 a = *reinterpret_cast<const float4*>(xr + k);
        const float4 b = *reinterpret_cast<const float4*>(ur + k);
        a.x = qdq(a.x, b.x, scale);
        a.y = qdq(a.y, b.y, scale);
        a.z = qdq(a.z, b.z, scale);
        a.w = qdq(a.w, b.w, scale);
        *reinterpret_cast<float4*>(orow + k) = a;
      }
    } else {
      for (int64_t k = lane; k < chunk; k += 32) orow[k] = qdq(xr[k], ur[k], scale);
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// w_host: (g, g) float32 in host memory, copied into the kernel's
// parameters; NULL for the mean. kind: 0 int8, 1 bf16, 2 fp16, 3 thresh.
extern "C" int repro_codec_mix(const float* x, const float* x0, const float* u,
                               const float* res, const float* tau, float* out,
                               float* res_out, const float* w_host, int64_t g,
                               int64_t n, int64_t hops, int64_t kind,
                               int64_t blocks, void* stream) {
  if (g < 1 || g > kMaxG || hops < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  MixArgs a;
  memset(&a, 0, sizeof(a));
  a.x = x;
  a.x0 = x0;
  a.u = u;
  a.res = res;
  a.tau = tau;
  a.out = out;
  a.res_out = res_out;
  a.n = n;
  a.nchunks = (n + kChunk - 1) / kChunk;
  a.g = static_cast<int>(g);
  a.hops = static_cast<int>(hops);
  const bool mean = w_host == nullptr;
  if (!mean) {
    for (int64_t i = 0; i < g; ++i) memcpy(a.w + i * kMaxG, w_host + i * g, sizeof(float) * g);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int k = static_cast<int>(kind);
  if (g <= 4) return launch_kind<4>(a, k, mean, blocks, s);
  if (g <= 8) return launch_kind<8>(a, k, mean, blocks, s);
  return launch_kind<16>(a, k, mean, blocks, s);
}

// Any g and int8 chunk (codec_mix_wide). w: (g, g) float32 on the device,
// NULL for the mean; ws: scratch of blocks * win floats (mean) or blocks *
// 2 * g * win (W), win = chunk for int8, else 256; u: (hops, g * nwin, win).
extern "C" int repro_codec_mix_wide(const float* x, const float* x0, const float* u,
                                    const float* res, const float* tau, float* out,
                                    float* res_out, const float* w, float* ws, int64_t g,
                                    int64_t n, int64_t chunk, int64_t hops, int64_t kind,
                                    int64_t blocks, void* stream) {
  const bool mean = w == nullptr;
  if (g < 1 || hops < 1 || (kind == kInt8 && chunk < 1) || (kind == kThresh && !mean)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n <= 0) return 0;
  WideArgs a;
  memset(&a, 0, sizeof(a));
  a.x = x;
  a.x0 = x0;
  a.u = u;
  a.res = res;
  a.tau = tau;
  a.w = w;
  a.out = out;
  a.res_out = res_out;
  a.ws = ws;
  a.n = n;
  a.win = kind == kInt8 ? chunk : kChunk;
  a.nwin = (n + a.win - 1) / a.win;
  a.g = static_cast<int>(g);
  a.hops = mean ? 1 : static_cast<int>(hops);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case kInt8:
      return mean ? launch_wide(codec_mean_wide<kInt8>, a, blocks, s)
                  : launch_wide(codec_w_wide<kInt8>, a, blocks, s);
    case kBf16:
      return mean ? launch_wide(codec_mean_wide<kBf16>, a, blocks, s)
                  : launch_wide(codec_w_wide<kBf16>, a, blocks, s);
    case kFp16:
      return mean ? launch_wide(codec_mean_wide<kFp16>, a, blocks, s)
                  : launch_wide(codec_w_wide<kFp16>, a, blocks, s);
    case kThresh:
      return launch_wide(codec_mean_wide<kThresh>, a, blocks, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// x, u, out: (rows, chunk) float32. blocks: the grid, 8 rows a block.
extern "C" int repro_qdq_int8(const float* x, const float* u, float* out,
                              int64_t rows, int64_t chunk, int64_t blocks,
                              void* stream) {
  if (rows <= 0 || chunk <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = aligned16(x) && aligned16(u) && aligned16(out);
  if (chunk == kChunk && vec) {
    qdq_int8_rows<<<resident_grid(qdq_int8_rows, 256, blocks), 256, 0, s>>>(x, u, out, rows);
  } else if (chunk % 4 == 0 && vec) {
    qdq_int8_any<true><<<resident_grid(qdq_int8_any<true>, 256, blocks), 256, 0, s>>>(
        x, u, out, rows, chunk);
  } else {
    qdq_int8_any<false><<<resident_grid(qdq_int8_any<false>, 256, blocks), 256, 0, s>>>(
        x, u, out, rows, chunk);
  }
  return static_cast<int>(cudaGetLastError());
}
