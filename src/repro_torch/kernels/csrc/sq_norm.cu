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
// Design (redesigned for the H100): one launch. The TPU kernel carries
// its sum across a sequential grid; the blocks of a GPU grid run in no
// order, so each row gets bpr blocks (the blocks resident at once over
// the rows, from the occupancy API asked once per device) and the row's
// last block to finish sums the row's partials. Block x of a row sums the
// fixed strips x, x + bpr, ... of kStrip float4s (each thread issues its
// kU streaming loads of a strip before it adds; four accumulators, one per
// float4 lane), reduces across the block with warp shuffles and one
// shared-memory stage, writes its partial, and after a __threadfence takes
// an integer ticket of the row (atomicAdd on an unsigned, no float
// atomics). The block that draws the last ticket reads the row's bpr
// partials from L2 and sums them in the same fixed tree, whichever block
// that is, writes the row's sum, and resets the ticket to 0 for the next
// call. So two runs on one card give the same bits. The partials and the
// tickets are scratch the wrapper allocates once per (device, rows,
// stream) and reuses; tests/test_torch_kernel_layouts.py mirrors this split.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kU = 4;                                            // float4 loads a thread
constexpr int64_t kStrip = static_cast<int64_t>(kThreads) * kU;  // float4s a strip
constexpr int kMaxDevices = 64;

__device__ __forceinline__ int64_t head_len(const float* row, int64_t n) {
  const int64_t mis = (reinterpret_cast<uintptr_t>(row) >> 2) & 3;
  const int64_t h = (4 - mis) & 3;
  return h < n ? h : n;
}

// Sum over the block; the result is valid in thread 0. The caller
// separates two calls by a __syncthreads.
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

// grid (bpr, rows). partials: (rows, bpr); tickets: (rows,), 0 between calls.
__global__ void __launch_bounds__(kThreads)
sq_norm_rows(const float* __restrict__ x, float* __restrict__ partials,
             unsigned* __restrict__ tickets, float* __restrict__ out, int64_t n) {
  const int64_t r = blockIdx.y;
  const unsigned bpr = gridDim.x;
  const float* row = x + r * n;
  const int64_t head = head_len(row, n);
  const int64_t nvec = (n - head) >> 2;
  const float4* body = reinterpret_cast<const float4*>(row + head);
  float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
  for (int64_t k0 = static_cast<int64_t>(blockIdx.x) * kStrip + threadIdx.x; k0 < nvec;
       k0 += static_cast<int64_t>(bpr) * kStrip) {
    float4 a[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int64_t k = k0 + u * kThreads;
      a[u] = k < nvec ? __ldcs(body + k) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      s0 += a[u].x * a[u].x;
      s1 += a[u].y * a[u].y;
      s2 += a[u].z * a[u].z;
      s3 += a[u].w * a[u].w;
    }
  }
  // ragged edges: threads 0-3 of block 0 take the head, threads 4-7 the tail
  if (blockIdx.x == 0 && threadIdx.x < 8) {
    const int64_t t = threadIdx.x;
    const int64_t j = t < 4 ? t : head + 4 * nvec + (t - 4);
    if (t < 4 ? t < head : j < n) s0 += row[j] * row[j];
  }
  const float s = block_sum((s0 + s1) + (s2 + s3));
  __shared__ bool last;
  if (threadIdx.x == 0) {
    partials[r * bpr + blockIdx.x] = s;
    __threadfence();  // the partial is visible before the ticket is drawn
    last = atomicAdd(tickets + r, 1u) == bpr - 1;
  }
  __syncthreads();
  if (!last) return;
  float t = 0.0f;
  for (int64_t k = threadIdx.x; k < bpr; k += kThreads) t += __ldcg(partials + r * bpr + k);
  t = block_sum(t);
  if (threadIdx.x == 0) {
    out[r] = t;
    tickets[r] = 0;
  }
}

// The blocks of sq_norm_rows resident at once on the current device, asked
// of the occupancy API once per device.
int64_t resident_blocks() {
  static int cached[kMaxDevices];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 1;
  if (dev < kMaxDevices && cached[dev] > 0) return cached[dev];
  int sms = 0, per_sm = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, sq_norm_rows, kThreads, 0) !=
          cudaSuccess ||
      sms * per_sm < 1) {
    return 1;
  }
  if (dev < kMaxDevices) cached[dev] = sms * per_sm;
  return static_cast<int64_t>(sms) * per_sm;
}

// Blocks per row: the resident blocks shared over the rows, at least 1, at
// most one per strip of the row and at most capacity / rows.
int64_t blocks_per_row(int64_t rows, int64_t n, int64_t capacity) {
  int64_t bpr = resident_blocks() / rows;
  const int64_t strips = (n / 4 + kStrip - 1) / kStrip;
  if (bpr > strips) bpr = strips;
  if (bpr > capacity / rows) bpr = capacity / rows;
  return bpr > 0 ? bpr : 1;
}

}  // namespace

// partials: scratch of `capacity` >= rows floats; tickets: (rows,) unsigned,
// zero between calls (the kernel leaves them so); out: (rows,).
extern "C" int repro_sq_norm_groups(const float* x, float* partials, unsigned* tickets,
                                    float* out, int64_t rows, int64_t n, int64_t capacity,
                                    void* stream) {
  if (rows <= 0) return 0;
  const int64_t bpr = blocks_per_row(rows, n, capacity);
  const dim3 grid(static_cast<unsigned>(bpr), static_cast<unsigned>(rows));
  sq_norm_rows<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(x, partials, tickets,
                                                                        out, n);
  return static_cast<int>(cudaGetLastError());
}
