// One decode step's attention over the paged KV pool: for every batch slot
// b, its one-token query (H heads) against the K and V pages its page table
// lists, up to its length, with the GQA head grouping H = n_kv * g.
//
// Replaces the TPU Pallas kernel src/repro/kernels/decode_attention.py
// paged_decode_attention (grid (B, nblk), the page index a sequential axis
// carrying the online softmax in VMEM scratch, the page tables and lengths
// in scalar prefetch, pages past the length skipped with pl.when).
//
// Bound on an H100: HBM bytes. A step reads every live token's K and V of
// every KV head once (2 * len * n_kv * hd * 4 bytes per slot) against
// 4 * len * H * hd flops: about 0.5 flop per byte, far below the card's
// ratio. paper-lenet at B = 8 and ~800 live tokens moves ~39 MB per layer
// call, ~12 us at 3.35 TB/s.
//
// Design: one block of 8 warps per (KV head, slot) (per head split of it, below); the block reads its own
// page-table row into shared memory and its length (there is no scalar
// prefetch). The TPU walks the pages in order; here the warps split the
// slot's live tokens t < length round-robin (the reference's pl.when skip
// becomes the loop bound: no page or position past the length is read),
// and each warp runs its own online softmax over its tokens with m, l and
// acc in registers. A token's K (and V) slice for this KV head is hd
// contiguous floats of its page row (token-major (page_size, n_kv, hd)):
// lane i holds dims i, i + 32, ..., so a warp reads it in one coalesced
// sweep and a score is a warp-shuffle sum. A warp loads the K and V of U
// tokens before it computes any of them (U = 8, or 4 for wide head
// groups), so U loads are in flight per warp, and takes one max and one
// rescale per U tokens. At the end the 8 warps' (m, l, acc) are merged in
// shared memory: acc and l scaled by exp(m_w - max m), summed, divided
// (l clamped at 1e-30, as in the reference). Pool offsets are 64-bit
// (row * page_elems overflows int32 at the pool sizes of larger models).
// Inactive slots point at trash row 0 with length 1 and compute finite
// garbage that nothing reads. q and the output are float32 here; the
// wrapper converts a bfloat16 query and result.
//
// Geometries: any hd up to 128 and any g from 1 to 16, from 16
// instantiations. The head dim sets DPL = ceil(hd / 32) dims a lane (lanes
// past hd are masked at run time, as they always were below 32); the block
// takes GB = 1, 2, 4 or 8 query heads, and a KV head with more than 8 is
// split over ceil(g / 8) blocks of ceil(g / splits) heads each (masked at
// run time where that is fewer than GB: g 3 runs as 3 of 4, g 6 as 6 of 8,
// g 16 as two blocks of 8 over the same K and V). So qr and acc stay at
// most 8 x 4 registers a lane, as at hd 128 and g 8.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxHd = 128;
constexpr int kMaxG = 16;
constexpr int kMaxGB = 8;  // query heads a block
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// DPL: dims a lane (hd <= 32 * DPL); GB: query heads a block.
template <int DPL, int GB>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const float* __restrict__ q, const float* __restrict__ pool,
                    const int* __restrict__ rows_k, const int* __restrict__ rows_v,
                    const int* __restrict__ lengths, float* __restrict__ out,
                    int64_t n_kv, int g, int hd, int splits, int per, int64_t ps,
                    int64_t nblk, int64_t page_elems, float scale) {
  constexpr int U = GB * DPL <= 8 ? 8 : 4;     // tokens in flight per warp
  constexpr int PART = 2 + 32 * DPL;           // m, l, acc of one head
  extern __shared__ float sm[];
  int* tk = reinterpret_cast<int*>(sm);        // (nblk,) K page rows
  int* tv = tk + nblk;                         // (nblk,) V page rows
  float* part = sm + 2 * nblk;                 // (warps, GB, PART)

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t kh = blockIdx.x / splits, b = blockIdx.y;
  const int h0 = static_cast<int>(blockIdx.x % splits) * per;
  const int nh = per < g - h0 ? per : g - h0;  // this block's heads, <= GB
  for (int64_t i = threadIdx.x; i < nblk; i += kThreads) {
    tk[i] = rows_k[b * nblk + i];
    tv[i] = rows_v[b * nblk + i];
  }
  // heads kh*g + h0 .. kh*g + h0 + nh - 1
  const int64_t head0 = ((b * n_kv + kh) * g + h0) * hd;
  float qr[GB][DPL], acc[GB][DPL], m[GB], l[GB];
#pragma unroll
  for (int h = 0; h < GB; ++h) {
    m[h] = kNegInf;
    l[h] = 0.0f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      qr[h][i] = h < nh && d < hd ? q[head0 + h * hd + d] : 0.0f;
      acc[h][i] = 0.0f;
    }
  }
  __syncthreads();

  int64_t len = lengths[b];
  if (len > nblk * ps) len = nblk * ps;
  const int64_t tok_stride = n_kv * hd;
  for (int64_t t0 = warp; t0 < len; t0 += kWarps * U) {
    float kr[U][DPL], vr[U][DPL];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t t = t0 + static_cast<int64_t>(u) * kWarps;
      const int64_t page = t / ps;
      const int64_t off = (t - page * ps) * tok_stride + kh * hd;
      const bool live = t < len;
      const float* kp = pool + (live ? static_cast<int64_t>(tk[page]) * page_elems + off : 0);
      const float* vp = pool + (live ? static_cast<int64_t>(tv[page]) * page_elems + off : 0);
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int d = lane + 32 * i;
        kr[u][i] = live && d < hd ? kp[d] : 0.0f;
        vr[u][i] = live && d < hd ? vp[d] : 0.0f;
      }
    }
#pragma unroll
    for (int h = 0; h < GB; ++h) {
      if (h >= nh) break;
      float s[U];
      float mx = m[h];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float x = 0.0f;
#pragma unroll
        for (int i = 0; i < DPL; ++i) x += qr[h][i] * kr[u][i];
        x = warp_sum(x) * scale;
        s[u] = t0 + static_cast<int64_t>(u) * kWarps < len ? x : kNegInf;
        mx = fmaxf(mx, s[u]);
      }
      const float corr = expf(m[h] - mx);
      float psum = 0.0f;
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[h][i] *= corr;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float p = expf(s[u] - mx);
        psum += p;
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[h][i] += p * vr[u][i];
      }
      l[h] = l[h] * corr + psum;
      m[h] = mx;
    }
  }

  float* mine = part + warp * GB * PART;
#pragma unroll
  for (int h = 0; h < GB; ++h) {
    if (lane == 0) {
      mine[h * PART] = m[h];
      mine[h * PART + 1] = l[h];
    }
#pragma unroll
    for (int i = 0; i < DPL; ++i) mine[h * PART + 2 + lane + 32 * i] = acc[h][i];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < nh * hd; idx += kThreads) {
    const int h = idx / hd, d = idx % hd;
    float mx = kNegInf;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, part[(w * GB + h) * PART]);
    float lsum = 0.0f, a = 0.0f;
    for (int w = 0; w < kWarps; ++w) {
      const float* pw = part + (w * GB + h) * PART;
      const float c = expf(pw[0] - mx);
      lsum += pw[1] * c;
      a += pw[2 + d] * c;
    }
    out[head0 + idx] = a / fmaxf(lsum, 1e-30f);
  }
}

template <int DPL, int GB>
int launch(const float* q, const float* pool, const int* rows_k, const int* rows_v,
           const int* lengths, float* out, int64_t B, int64_t n_kv, int g, int hd,
           int splits, int per, int64_t ps, int64_t nblk, int64_t page_elems,
           cudaStream_t stream, float scale) {
  // the page tables and the warps' partial results; above the card's
  // 227 KB cudaFuncSetAttribute fails and its error is returned
  const int64_t smem = static_cast<int64_t>(sizeof(float)) *
                       (2 * nblk + static_cast<int64_t>(kWarps) * GB * (2 + 32 * DPL));
  cudaError_t err = cudaFuncSetAttribute(paged_decode_kernel<DPL, GB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(n_kv * splits), static_cast<unsigned>(B));
  paged_decode_kernel<DPL, GB><<<grid, kThreads, smem, stream>>>(
      q, pool, rows_k, rows_v, lengths, out, n_kv, g, hd, splits, per, ps, nblk, page_elems,
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <int DPL>
int launch_g(const float* q, const float* pool, const int* rows_k, const int* rows_v,
             const int* lengths, float* out, int64_t B, int64_t n_kv, int g, int hd,
             int64_t ps, int64_t nblk, int64_t page_elems, cudaStream_t s, float scale) {
  const int splits = (g + kMaxGB - 1) / kMaxGB;
  const int per = (g + splits - 1) / splits;
#define REPRO_GB(GB)                                                                     \
  if (per <= GB)                                                                         \
    return launch<DPL, GB>(q, pool, rows_k, rows_v, lengths, out, B, n_kv, g, hd, splits, \
                           per, ps, nblk, page_elems, s, scale);
  REPRO_GB(1)
  REPRO_GB(2)
  REPRO_GB(4)
  REPRO_GB(8)
#undef REPRO_GB
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q, out: (B, n_kv * g, hd) float32; pool: (n_pages, page_elems) float32;
// rows_k, rows_v: (B, nblk) int32; lengths: (B,) int32 >= 1;
// 1 <= hd <= 128, 1 <= g <= 16; scale: 1/sqrt(hd) as the caller rounded it.
extern "C" int repro_paged_decode_attention(const float* q, const float* pool,
                                            const int* rows_k, const int* rows_v,
                                            const int* lengths, float* out, int64_t B,
                                            int64_t n_kv, int64_t g, int64_t hd,
                                            int64_t ps, int64_t nblk, int64_t page_elems,
                                            void* stream, float scale) {
  if (B <= 0) return 0;
  if (hd < 1 || hd > kMaxHd || g < 1 || g > kMaxG) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int gi = static_cast<int>(g), hi = static_cast<int>(hd);
#define REPRO_DPL(DPL)                                                                \
  case DPL:                                                                           \
    return launch_g<DPL>(q, pool, rows_k, rows_v, lengths, out, B, n_kv, gi, hi, ps, nblk, \
                         page_elems, s, scale);
  switch ((hd + 31) / 32) {
    REPRO_DPL(1)
    REPRO_DPL(2)
    REPRO_DPL(3)
    REPRO_DPL(4)
  }
#undef REPRO_DPL
  return static_cast<int>(cudaErrorInvalidValue);
}
