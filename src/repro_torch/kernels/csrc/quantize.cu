// Per-row int8 quantize and dequantize of (rows, chunk) buffers: the
// staged halves of the int8 wire codec (DESIGN.md §8).
//
// Replaces the TPU Pallas kernels of src/repro/kernels/quantize.py:
//   quantize_int8    x, u (rows, chunk) float32 -> q int8 (rows, chunk) and
//                    scales float32 (rows, 1): scale = amax/127 per row (1
//                    for an all-zero row), q = clip(floor(x/scale + u),
//                    -127, 127), u being the stochastic-rounding noise
//   dequantize_int8  q, scales -> q * scale, float32
//
// Bound on an H100: HBM bytes. Quantize reads 8 bytes an element and
// writes 1 (and 4 a row), dequantize reads 1 and writes 4; a few flops an
// element. At paper-lenet's packed buffer in chunks of 256, (1,947,852,
// 256), that is 4.49 GB (1.34 ms) and 2.50 GB (0.75 ms) at 3.35 TB/s.
//
// Design: one warp per row, 8 rows per block of 256 threads, and a
// grid-stride loop over the rows (no bound on their count), any chunk
// width. Quantize takes the row's amax in a first pass (a warp max; a
// max is exact in any order), then reads the row again, from L1 (a 256
// row is 1 KB), with its noise. The arithmetic is that of qdq_int8
// (exchange_epilogue.cu): __fdiv_rn(amax, 127), floorf(__fadd_rn(
// __fdiv_rn(x, scale), u)), the clip, and for dequantize one __fmul_rn; no
// fast math. So quantize followed by dequantize equals qdq_int8 bit for
// bit. Where the chunk is a multiple of 4 and the pointers allow it, a
// lane moves 4 elements at a time (float4 of x and u, 4 bytes of q);
// otherwise element by element.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ signed char quant(float v, float u, float scale) {
  const float q = floorf(__fadd_rn(__fdiv_rn(v, scale), u));
  return static_cast<signed char>(fminf(fmaxf(q, -127.0f), 127.0f));
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
quantize_rows(const float* __restrict__ x, const float* __restrict__ u,
              signed char* __restrict__ q, float* __restrict__ scales, int64_t rows,
              int64_t chunk) {
  const int lane = threadIdx.x & 31;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kRowsPerBlock;
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock + (threadIdx.x >> 5);
       r < rows; r += stride) {
    const float* xr = x + r * chunk;
    const float* ur = u + r * chunk;
    signed char* qr = q + r * chunk;
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
        const float4 a = *reinterpret_cast<const float4*>(xr + k);
        const float4 b = *reinterpret_cast<const float4*>(ur + k);
        char4 c;
        c.x = quant(a.x, b.x, scale);
        c.y = quant(a.y, b.y, scale);
        c.z = quant(a.z, b.z, scale);
        c.w = quant(a.w, b.w, scale);
        *reinterpret_cast<char4*>(qr + k) = c;
      }
    } else {
      for (int64_t k = lane; k < chunk; k += 32) qr[k] = quant(xr[k], ur[k], scale);
    }
    if (lane == 0) scales[r] = scale;
  }
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
dequantize_rows(const signed char* __restrict__ q, const float* __restrict__ scales,
                float* __restrict__ out, int64_t rows, int64_t chunk) {
  const int lane = threadIdx.x & 31;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kRowsPerBlock;
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock + (threadIdx.x >> 5);
       r < rows; r += stride) {
    const signed char* qr = q + r * chunk;
    float* orow = out + r * chunk;
    const float scale = scales[r];
    if (VEC) {
      for (int64_t k = 4 * lane; k < chunk; k += 128) {
        const char4 c = *reinterpret_cast<const char4*>(qr + k);
        *reinterpret_cast<float4*>(orow + k) =
            make_float4(__fmul_rn(static_cast<float>(c.x), scale),
                        __fmul_rn(static_cast<float>(c.y), scale),
                        __fmul_rn(static_cast<float>(c.z), scale),
                        __fmul_rn(static_cast<float>(c.w), scale));
      }
    } else {
      for (int64_t k = lane; k < chunk; k += 32) {
        orow[k] = __fmul_rn(static_cast<float>(qr[k]), scale);
      }
    }
  }
}

bool aligned(const void* p, uintptr_t to) { return (reinterpret_cast<uintptr_t>(p) % to) == 0; }

}  // namespace

// x, u: (rows, chunk) float32; q: (rows, chunk) int8; scales: (rows,)
// float32 (the (rows, 1) column). blocks: the grid, 8 rows a block.
extern "C" int repro_quantize_int8(const float* x, const float* u, signed char* q,
                                   float* scales, int64_t rows, int64_t chunk,
                                   int64_t blocks, void* stream) {
  if (rows <= 0 || chunk <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>(blocks);
  if (chunk % 4 == 0 && aligned(x, 16) && aligned(u, 16) && aligned(q, 4)) {
    quantize_rows<true><<<grid, kThreads, 0, s>>>(x, u, q, scales, rows, chunk);
  } else {
    quantize_rows<false><<<grid, kThreads, 0, s>>>(x, u, q, scales, rows, chunk);
  }
  return static_cast<int>(cudaGetLastError());
}

// q: (rows, chunk) int8; scales: (rows,) float32; out: (rows, chunk)
// float32.
extern "C" int repro_dequantize_int8(const signed char* q, const float* scales, float* out,
                                     int64_t rows, int64_t chunk, int64_t blocks,
                                     void* stream) {
  if (rows <= 0 || chunk <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>(blocks);
  if (chunk % 4 == 0 && aligned(q, 4) && aligned(out, 16)) {
    dequantize_rows<true><<<grid, kThreads, 0, s>>>(q, scales, out, rows, chunk);
  } else {
    dequantize_rows<false><<<grid, kThreads, 0, s>>>(q, scales, out, rows, chunk);
  }
  return static_cast<int>(cudaGetLastError());
}
