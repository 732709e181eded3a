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
// Design: one block of 8 warps per (KV head, slot); the block reads its own
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
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int HD, int G>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const float* __restrict__ q, const float* __restrict__ pool,
                    const int* __restrict__ rows_k, const int* __restrict__ rows_v,
                    const int* __restrict__ lengths, float* __restrict__ out,
                    int64_t n_kv, int64_t ps, int64_t nblk, int64_t page_elems,
                    float scale) {
  constexpr int DPL = (HD + 31) / 32;          // dims per lane
  constexpr int U = G * DPL <= 8 ? 8 : 4;      // tokens in flight per warp
  constexpr int PART = 2 + HD;                 // m, l, acc of one head
  extern __shared__ float sm[];
  int* tk = reinterpret_cast<int*>(sm);        // (nblk,) K page rows
  int* tv = tk + nblk;                         // (nblk,) V page rows
  float* part = sm + 2 * nblk;                 // (warps, G, PART)

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t kh = blockIdx.x, b = blockIdx.y;
  for (int64_t i = threadIdx.x; i < nblk; i += kThreads) {
    tk[i] = rows_k[b * nblk + i];
    tv[i] = rows_v[b * nblk + i];
  }
  const int64_t head0 = (b * n_kv + kh) * G * HD;   // heads kh*G .. kh*G+G-1
  float qr[G][DPL], acc[G][DPL], m[G], l[G];
#pragma unroll
  for (int h = 0; h < G; ++h) {
    m[h] = kNegInf;
    l[h] = 0.0f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      qr[h][i] = d < HD ? q[head0 + h * HD + d] : 0.0f;
      acc[h][i] = 0.0f;
    }
  }
  __syncthreads();

  int64_t len = lengths[b];
  if (len > nblk * ps) len = nblk * ps;
  const int64_t tok_stride = n_kv * HD;
  for (int64_t t0 = warp; t0 < len; t0 += kWarps * U) {
    float kr[U][DPL], vr[U][DPL];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t t = t0 + static_cast<int64_t>(u) * kWarps;
      const int64_t page = t / ps;
      const int64_t off = (t - page * ps) * tok_stride + kh * HD;
      const bool live = t < len;
      const float* kp = pool + (live ? static_cast<int64_t>(tk[page]) * page_elems + off : 0);
      const float* vp = pool + (live ? static_cast<int64_t>(tv[page]) * page_elems + off : 0);
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int d = lane + 32 * i;
        kr[u][i] = live && d < HD ? kp[d] : 0.0f;
        vr[u][i] = live && d < HD ? vp[d] : 0.0f;
      }
    }
#pragma unroll
    for (int h = 0; h < G; ++h) {
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

  float* mine = part + warp * G * PART;
#pragma unroll
  for (int h = 0; h < G; ++h) {
    if (lane == 0) {
      mine[h * PART] = m[h];
      mine[h * PART + 1] = l[h];
    }
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      if (d < HD) mine[h * PART + 2 + d] = acc[h][i];
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < G * HD; idx += kThreads) {
    const int h = idx / HD, d = idx % HD;
    float mx = kNegInf;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, part[(w * G + h) * PART]);
    float lsum = 0.0f, a = 0.0f;
    for (int w = 0; w < kWarps; ++w) {
      const float* pw = part + (w * G + h) * PART;
      const float c = expf(pw[0] - mx);
      lsum += pw[1] * c;
      a += pw[2 + d] * c;
    }
    out[head0 + idx] = a / fmaxf(lsum, 1e-30f);
  }
}

template <int HD, int G>
int launch(const float* q, const float* pool, const int* rows_k, const int* rows_v,
           const int* lengths, float* out, int64_t B, int64_t n_kv, int64_t ps,
           int64_t nblk, int64_t page_elems, cudaStream_t stream, float scale) {
  // the page tables and the warps' partial results; above the card's
  // 227 KB cudaFuncSetAttribute fails and its error is returned
  const int64_t smem = static_cast<int64_t>(sizeof(float)) *
                       (2 * nblk + static_cast<int64_t>(kWarps) * G * (2 + HD));
  cudaError_t err = cudaFuncSetAttribute(paged_decode_kernel<HD, G>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(n_kv), static_cast<unsigned>(B));
  paged_decode_kernel<HD, G><<<grid, kThreads, smem, stream>>>(
      q, pool, rows_k, rows_v, lengths, out, n_kv, ps, nblk, page_elems, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_g(int64_t g, const float* q, const float* pool, const int* rows_k,
             const int* rows_v, const int* lengths, float* out, int64_t B,
             int64_t n_kv, int64_t ps, int64_t nblk, int64_t page_elems,
             cudaStream_t s, float scale) {
#define REPRO_G(G)                                                                 \
  case G:                                                                          \
    return launch<HD, G>(q, pool, rows_k, rows_v, lengths, out, B, n_kv, ps, nblk, \
                         page_elems, s, scale);
  switch (g) {
    REPRO_G(1)
    REPRO_G(2)
    REPRO_G(4)
    REPRO_G(8)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_G
}

}  // namespace

// q, out: (B, n_kv * g, hd) float32; pool: (n_pages, page_elems) float32;
// rows_k, rows_v: (B, nblk) int32; lengths: (B,) int32 >= 1;
// hd in {8, 16, 32, 64, 128}, g in {1, 2, 4, 8}; scale: 1/sqrt(hd) as the
// caller rounded it.
extern "C" int repro_paged_decode_attention(const float* q, const float* pool,
                                            const int* rows_k, const int* rows_v,
                                            const int* lengths, float* out, int64_t B,
                                            int64_t n_kv, int64_t g, int64_t hd,
                                            int64_t ps, int64_t nblk, int64_t page_elems,
                                            void* stream, float scale) {
  if (B <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_HD(HD)                                                                \
  case HD:                                                                          \
    return launch_g<HD>(g, q, pool, rows_k, rows_v, lengths, out, B, n_kv, ps, nblk, \
                        page_elems, s, scale);
  switch (hd) {
    REPRO_HD(8)
    REPRO_HD(16)
    REPRO_HD(32)
    REPRO_HD(64)
    REPRO_HD(128)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_HD
}
