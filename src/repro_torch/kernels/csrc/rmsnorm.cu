// RMSNorm over the last axis: y = x * rsqrt(mean(x^2) + eps) * w, for x
// (rows, D) float32 or bfloat16 and w (D,) float32, float32 math, y in x's
// type.
//
// Replaces the TPU Pallas kernel src/repro/kernels/rmsnorm.py rmsnorm
// (grid over VMEM blocks of block_rows rows, each block's rows normalised
// in one pass).
//
// Bound on an H100: HBM bytes. x is read once and y written once (w is
// D floats, read from cache): 2 * rows * D * itemsize bytes against ~4
// flops per element, so the floor is the bytes over 3.35 TB/s (0.035 ms
// at (4096, 3584) float32, 0.080 ms at (262,144, 128)).
//
// Design: one warp per row, 8 rows per block of 256 threads, and a
// grid-stride loop over the rows, so the row count is not bounded by a
// grid dimension (qwen3-32b's qk-norm alone has 262,144 rows of 128). A
// lane sums the squares of its strided share of the row, the warp adds
// the partials with shuffles, and every lane then reads its share again
// (from L1/L2: a row is at most a few tens of KB) to write x * r * w.
// The body moves 16 bytes a lane (float4, or 8 bfloat16) where D is a
// multiple of the vector and every pointer is 16-byte aligned; otherwise
// the row runs element by element. The mean is a true division by D and
// r is __frsqrt_rn, the correctly rounded 1/sqrt; the two products are
// rounded one after the other, as the reference writes them. bfloat16 is
// read and written only through the conversion intrinsics.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

__device__ __forceinline__ float warp_sum(float s) {
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

// 16 bytes of x as floats: 4 float32 or 8 bfloat16.
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int kN = 4;
  __device__ __forceinline__ static void load(const float* p, float* v) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  }
  __device__ __forceinline__ static void save(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float* v) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  __device__ __forceinline__ static void save(__nv_bfloat16* p, const float* v) {
    uint4 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
};

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
rmsnorm_rows(const T* __restrict__ x, const float* __restrict__ w, T* __restrict__ out,
             int64_t rows, int64_t d, float eps) {
  constexpr int V = Vec<T>::kN;
  const int lane = threadIdx.x & 31;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kRowsPerBlock;
  const float fd = static_cast<float>(d);
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock + (threadIdx.x >> 5);
       r < rows; r += stride) {
    const T* xr = x + r * d;
    T* yr = out + r * d;
    float s = 0.0f;
    if (VEC) {
      for (int64_t k = lane * V; k < d; k += 32 * V) {
        float v[V];
        Vec<T>::load(xr + k, v);
#pragma unroll
        for (int i = 0; i < V; ++i) s += v[i] * v[i];
      }
    } else {
      for (int64_t k = lane; k < d; k += 32) {
        const float v = to_f(xr[k]);
        s += v * v;
      }
    }
    s = warp_sum(s);
    const float inv = __frsqrt_rn(__fadd_rn(__fdiv_rn(s, fd), eps));
    if (VEC) {
      for (int64_t k = lane * V; k < d; k += 32 * V) {
        float v[V];
        Vec<T>::load(xr + k, v);
        const float4* wv = reinterpret_cast<const float4*>(w + k);
#pragma unroll
        for (int i = 0; i < V / 4; ++i) {
          const float4 ww = wv[i];
          v[4 * i + 0] = __fmul_rn(__fmul_rn(v[4 * i + 0], inv), ww.x);
          v[4 * i + 1] = __fmul_rn(__fmul_rn(v[4 * i + 1], inv), ww.y);
          v[4 * i + 2] = __fmul_rn(__fmul_rn(v[4 * i + 2], inv), ww.z);
          v[4 * i + 3] = __fmul_rn(__fmul_rn(v[4 * i + 3], inv), ww.w);
        }
        Vec<T>::save(yr + k, v);
      }
    } else {
      for (int64_t k = lane; k < d; k += 32) {
        store(yr + k, __fmul_rn(__fmul_rn(to_f(xr[k]), inv), w[k]));
      }
    }
  }
}

template <typename T>
int launch(const void* x, const float* w, void* out, int64_t rows, int64_t d, float eps,
           int64_t blocks, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  const bool aligned = ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
                         reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  const unsigned grid = static_cast<unsigned>(blocks);
  if (aligned && d % Vec<T>::kN == 0) {
    rmsnorm_rows<T, true><<<grid, kThreads, 0, s>>>(xt, w, ot, rows, d, eps);
  } else {
    rmsnorm_rows<T, false><<<grid, kThreads, 0, s>>>(xt, w, ot, rows, d, eps);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, out: (rows, d) float32 (bf16 = 0) or bfloat16 (bf16 = 1), contiguous;
// w: (d,) float32. blocks: the grid (grid-stride over rows, 8 a block).
extern "C" int repro_rmsnorm(const void* x, const float* w, void* out, int64_t rows,
                             int64_t d, int64_t bf16, int64_t blocks, void* stream, float eps) {
  if (rows <= 0 || d <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(x, w, out, rows, d, eps, blocks, s)
              : launch<float>(x, w, out, rows, d, eps, blocks, s);
}
