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
//   qdq_int8   per-row int8 quantize + dequantize of (rows, 256) with the
//              noise passed in: the staged codec core (int8z, async_stale,
//              the downlink codec)
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
// Layout of qdq_int8: one warp per row of 256, two float4 per lane, the
// row max by warp shuffles; grid-stride over rows on gridDim.x, so there
// is no limit on the row count (paper-lenet's 1,947,852 rows). Both
// kernels launch at most one wave of resident blocks.
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

// x, u, out: (rows, 256) float32, each 16-byte aligned.
extern "C" int repro_qdq_int8(const float* x, const float* u, float* out,
                              int64_t rows, int64_t blocks, void* stream) {
  if (rows <= 0) return 0;
  qdq_int8_rows<<<resident_grid(qdq_int8_rows, 256, blocks), 256, 0,
                  static_cast<cudaStream_t>(stream)>>>(x, u, out, rows);
  return static_cast<int>(cudaGetLastError());
}
