// Per-row sum of squares of a (G, N) float32 buffer -> (G,) float32: the
// grad_sq metric of every local step (metrics="traj") and the consensus
// distance before and after each round's exchange (DESIGN.md §13).
//
// Replaces the TPU Pallas kernel src/repro/kernels/sq_norm.py
// sq_norm_groups (and sq_norm, its one-row case).
//
// Bound on an H100: HBM bytes. 4 bytes read per element against 2 flops,
// so G*N*4 / 3.35 TB/s is the floor (about 0.6 ms at G=4 on paper-lenet).
//
// Design: the TPU kernel carries its sum across a sequential grid; the
// blocks of a GPU grid run in no order, so the reduction is two passes
// with no float atomics, and two runs on one card give the same bits.
// Pass 1 runs (blocks x G) blocks; each sums a fixed strip of its row
// with float4 loads (four independent accumulators per thread), reduces
// across the block with warp shuffles and one shared-memory stage, and
// writes one partial to the (G, blocks) scratch. Pass 2 runs one block
// per row and reduces that row's partials in the same fixed tree.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ int64_t head_len(const float* row, int64_t n) {
  const int64_t mis = (reinterpret_cast<uintptr_t>(row) >> 2) & 3;
  const int64_t h = (4 - mis) & 3;
  return h < n ? h : n;
}

// Sum over the block; the result is valid in thread 0.
__device__ __forceinline__ float block_sum(float s) {
  __shared__ float warp_sums[kWarps];
  for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = s;
  __syncthreads();
  s = threadIdx.x < kWarps ? warp_sums[threadIdx.x] : 0.0f;
  if (warp == 0) {
    for (int o = kWarps / 2; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
  }
  return s;
}

__global__ void __launch_bounds__(kThreads)
sq_norm_partials(const float* __restrict__ x, float* __restrict__ partials,
                 int64_t n) {
  const int64_t r = blockIdx.y;
  const float* row = x + r * n;
  const int64_t head = head_len(row, n);
  const int64_t nvec = (n - head) >> 2;
  const float4* body = reinterpret_cast<const float4*>(row + head);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
  for (int64_t k = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       k < nvec; k += stride) {
    const float4 a = body[k];
    s0 += a.x * a.x;
    s1 += a.y * a.y;
    s2 += a.z * a.z;
    s3 += a.w * a.w;
  }
  if (blockIdx.x == 0 && threadIdx.x < 8) {
    const int64_t t = threadIdx.x;
    const int64_t j = t < 4 ? t : head + 4 * nvec + (t - 4);
    if (t < 4 ? t < head : j < n) s0 += row[j] * row[j];
  }
  const float s = block_sum((s0 + s1) + (s2 + s3));
  if (threadIdx.x == 0) partials[r * gridDim.x + blockIdx.x] = s;
}

__global__ void __launch_bounds__(kThreads)
sq_norm_finish(const float* __restrict__ partials, float* __restrict__ out,
               int64_t blocks) {
  const int64_t r = blockIdx.x;
  float s = 0.0f;
  for (int64_t k = threadIdx.x; k < blocks; k += kThreads) {
    s += partials[r * blocks + k];
  }
  s = block_sum(s);
  if (threadIdx.x == 0) out[r] = s;
}

}  // namespace

// partials: (rows, blocks) scratch the caller allocated; out: (rows,).
extern "C" int repro_sq_norm_groups(const float* x, float* partials, float* out,
                                    int64_t rows, int64_t n, int64_t blocks,
                                    void* stream) {
  if (rows <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(rows));
  sq_norm_partials<<<grid, kThreads, 0, s>>>(x, partials, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sq_norm_finish<<<static_cast<unsigned>(rows), kThreads, 0, s>>>(partials, out,
                                                                  blocks);
  return static_cast<int>(cudaGetLastError());
}
