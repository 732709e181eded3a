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
// Design: a row is read from HBM once and held in registers until it is
// written. A group of tpr threads takes one row; each thread issues all
// of its nv 16-byte loads (float4, or 8 bfloat16) before its first add,
// nv a compile-time count, so the whole row is in flight at once. The
// layout is chosen by D in Python (kernels/rmsnorm.py layout):
// - narrow rows (at most 256 vectors: D <= 1024 float32), a few lanes a
//   row and several rows a warp (qwen3-32b's qk-norm at D = 128: 8 lanes
//   of 4 float4, 4 rows a warp); the sum is a shuffle over the row's
//   lanes only;
// - wide rows, one block of 128-512 threads a row with at most 8
//   vectors a thread (zamba2-7b's 3584: 128 x 7 float4); the warps' sums
//   meet in shared memory and are added in warp order.
// The grid is clamped to the blocks that are resident at once, and each
// block loops over row groups, so more rows, not more waiting blocks,
// share an SM. w is read as float4 through the read-only cache.
// Where D is no multiple of the vector, a pointer is not 16-byte aligned,
// or a row would need more than 8 vectors a thread of 512 threads, the
// streaming kernel runs instead: one warp per row, the row read twice
// (the second time from L1/L2), 16-byte vectors where D and the pointers
// allow them, element by element otherwise.
//
// Arithmetic, on both paths: the mean is a true division by D and r is
// __frsqrt_rn, the correctly rounded 1/sqrt; the two products are rounded
// one after the other, as the reference writes them. bfloat16 is read and
// written only through the conversion intrinsics. Only the order of the
// sum of squares differs from the plain version's.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;
constexpr int kMaxThreads = 512;
constexpr int kMaxVecs = 8;

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
  __device__ __forceinline__ static void unpack(const uint4& raw, float* v) {
    v[0] = __uint_as_float(raw.x); v[1] = __uint_as_float(raw.y);
    v[2] = __uint_as_float(raw.z); v[3] = __uint_as_float(raw.w);
  }
  __device__ __forceinline__ static uint4 pack(const float* v) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                      __float_as_uint(v[3]));
  }
  __device__ __forceinline__ static void load(const float* p, float* v) {
    unpack(*reinterpret_cast<const uint4*>(p), v);
  }
  __device__ __forceinline__ static void save(float* p, const float* v) {
    *reinterpret_cast<uint4*>(p) = pack(v);
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ __forceinline__ static void unpack(const uint4& raw, float* v) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  __device__ __forceinline__ static uint4 pack(const float* v) {
    uint4 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    return raw;
  }
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float* v) {
    unpack(*reinterpret_cast<const uint4*>(p), v);
  }
  __device__ __forceinline__ static void save(__nv_bfloat16* p, const float* v) {
    *reinterpret_cast<uint4*>(p) = pack(v);
  }
};

// x * inv * w for the V elements of one vector whose first column is k.
template <typename T>
__device__ __forceinline__ void scale_vec(float* v, const float* __restrict__ w, int64_t k,
                                          float inv) {
  constexpr int V = Vec<T>::kN;
  const float4* wv = reinterpret_cast<const float4*>(w + k);
#pragma unroll
  for (int i = 0; i < V / 4; ++i) {
    const float4 ww = __ldg(wv + i);
    v[4 * i + 0] = __fmul_rn(__fmul_rn(v[4 * i + 0], inv), ww.x);
    v[4 * i + 1] = __fmul_rn(__fmul_rn(v[4 * i + 1], inv), ww.y);
    v[4 * i + 2] = __fmul_rn(__fmul_rn(v[4 * i + 2], inv), ww.z);
    v[4 * i + 3] = __fmul_rn(__fmul_rn(v[4 * i + 3], inv), ww.w);
  }
}

// The row in registers. blockDim.x / tpr rows a block (tpr <= 32), or one
// row a block (tpr == blockDim.x, a multiple of 32); lane l of a row holds
// its vectors l, l + tpr, ..., l + (NV - 1) * tpr below nvec.
template <typename T, int NV>
__global__ void __launch_bounds__(kMaxThreads)
rmsnorm_regs(const T* __restrict__ x, const float* __restrict__ w, T* __restrict__ out,
             int64_t rows, int64_t nvec, int tpr, float fd, float eps) {
  constexpr int V = Vec<T>::kN;
  __shared__ float part[kMaxThreads / 32];
  const int lane = threadIdx.x & (tpr - 1);
  const int per_block = blockDim.x / tpr;
  const int warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  // the lanes of this row within its warp, for the shuffles
  const unsigned row_mask =
      tpr >= 32 ? 0xffffffffu : ((1u << tpr) - 1u) << (threadIdx.x & 31 & ~(tpr - 1));
  const int64_t stride = static_cast<int64_t>(gridDim.x) * per_block;
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * per_block + threadIdx.x / tpr; r < rows;
       r += stride) {
    const uint4* xr = reinterpret_cast<const uint4*>(x + r * nvec * V);
    uint4 raw[NV];
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int64_t j = lane + static_cast<int64_t>(i) * tpr;
      raw[i] = j < nvec ? xr[j] : make_uint4(0u, 0u, 0u, 0u);
    }
    float s = 0.0f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      float v[V];
      Vec<T>::unpack(raw[i], v);
#pragma unroll
      for (int e = 0; e < V; ++e) s += v[e] * v[e];
    }
    for (int o = (tpr < 32 ? tpr : 32) >> 1; o > 0; o >>= 1) s += __shfl_xor_sync(row_mask, s, o);
    if (tpr > 32) {                      // one row a block: add the warps' sums in order
      if ((threadIdx.x & 31) == 0) part[warp] = s;
      __syncthreads();
      s = 0.0f;
      for (int i = 0; i < nwarps; ++i) s += part[i];
      __syncthreads();                   // part is free for the next row
    }
    const float inv = __frsqrt_rn(__fadd_rn(__fdiv_rn(s, fd), eps));
    uint4* yr = reinterpret_cast<uint4*>(out + r * nvec * V);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int64_t j = lane + static_cast<int64_t>(i) * tpr;
      if (j < nvec) {
        float v[V];
        Vec<T>::unpack(raw[i], v);
        scale_vec<T>(v, w, j * V, inv);
        yr[j] = Vec<T>::pack(v);
      }
    }
  }
}

// Streaming: one warp per row, the row read twice.
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
        scale_vec<T>(v, w, k, inv);
        Vec<T>::save(yr + k, v);
      }
    } else {
      for (int64_t k = lane; k < d; k += 32) {
        store(yr + k, __fmul_rn(__fmul_rn(to_f(xr[k]), inv), w[k]));
      }
    }
  }
}

// At most one wave: the blocks of `kernel` resident on all SMs at once.
template <typename Kernel>
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

template <typename T, int NV>
int launch_regs(const T* x, const float* w, T* out, int64_t rows, int64_t d, int tpr,
                int threads, float eps, cudaStream_t s) {
  const int per_block = threads / tpr;
  const unsigned grid = resident_grid(rmsnorm_regs<T, NV>, threads,
                                      (rows + per_block - 1) / per_block);
  rmsnorm_regs<T, NV><<<grid, threads, 0, s>>>(x, w, out, rows, d / Vec<T>::kN, tpr,
                                               static_cast<float>(d), eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* x, const float* w, void* out, int64_t rows, int64_t d, int64_t tpr,
           int64_t nv, int64_t threads, float eps, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  const bool aligned = ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
                         reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  const bool vec = aligned && d % Vec<T>::kN == 0;
  if (nv > 0) {
    // the layout must tile the row and the block, and hold the vectors
    const int64_t nvec = d / Vec<T>::kN;
    const bool ok = vec && tpr > 0 && (tpr & (tpr - 1)) == 0 && threads <= kMaxThreads &&
                    threads % 32 == 0 && (tpr <= 32 ? threads % tpr == 0 : tpr == threads) &&
                    nv <= kMaxVecs && tpr * nv >= nvec;
    if (!ok) return static_cast<int>(cudaErrorInvalidValue);
    const int t = static_cast<int>(tpr), n = static_cast<int>(threads);
    switch (nv) {
      case 1: return launch_regs<T, 1>(xt, w, ot, rows, d, t, n, eps, s);
      case 2: return launch_regs<T, 2>(xt, w, ot, rows, d, t, n, eps, s);
      case 3: return launch_regs<T, 3>(xt, w, ot, rows, d, t, n, eps, s);
      case 4: return launch_regs<T, 4>(xt, w, ot, rows, d, t, n, eps, s);
      case 5: return launch_regs<T, 5>(xt, w, ot, rows, d, t, n, eps, s);
      case 6: return launch_regs<T, 6>(xt, w, ot, rows, d, t, n, eps, s);
      case 7: return launch_regs<T, 7>(xt, w, ot, rows, d, t, n, eps, s);
      case 8: return launch_regs<T, 8>(xt, w, ot, rows, d, t, n, eps, s);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const int64_t blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  if (vec) {
    rmsnorm_rows<T, true><<<resident_grid(rmsnorm_rows<T, true>, kThreads, blocks), kThreads,
                            0, s>>>(xt, w, ot, rows, d, eps);
  } else {
    rmsnorm_rows<T, false><<<resident_grid(rmsnorm_rows<T, false>, kThreads, blocks),
                             kThreads, 0, s>>>(xt, w, ot, rows, d, eps);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, out: (rows, d) float32 (bf16 = 0) or bfloat16 (bf16 = 1), contiguous;
// w: (d,) float32. The layout (kernels/rmsnorm.py layout): nv 16-byte
// vectors a thread, tpr threads a row, threads a block; nv = 0 takes the
// streaming kernel (one warp per row, 256 threads a block).
extern "C" int repro_rmsnorm(const void* x, const float* w, void* out, int64_t rows,
                             int64_t d, int64_t bf16, int64_t tpr, int64_t nv,
                             int64_t threads, void* stream, float eps) {
  if (rows <= 0 || d <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(x, w, out, rows, d, tpr, nv, threads, eps, s)
              : launch<float>(x, w, out, rows, d, tpr, nv, threads, eps, s);
}
