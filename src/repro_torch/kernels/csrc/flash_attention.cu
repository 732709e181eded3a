// Causal self attention, forward only, with an online softmax over key
// tiles: out[b, h, i] = softmax_j<=i(q_i . k_j / sqrt(hd)) @ v, for q
// (B, H, S, hd) and k, v (B, KV, S, hd) with KV dividing H (GQA: query head
// h reads KV head h / (H / KV), so the KV heads are never repeated in
// memory). float32 or bfloat16 in, float32 math, the output in q's type.
//
// Replaces the TPU Pallas kernel src/repro/kernels/flash_attention.py
// flash_attention (grid (B*H, nq, nk) with the kv-block axis innermost and
// sequential, m, l and acc carried across it in VMEM scratch, blocks above
// the diagonal skipped with pl.when).
//
// Bound on an H100: operations. At paper-lenet's prefill (1, 12, 1024, 64)
// the causal half of QK^T and of P @ V is 4 * hd * S(S+1)/2 * H = 1.6 GFLOP
// against 12.6 MB of q, k, v and out: ~24 us at the 67 TFLOP/s of float32
// outside the tensor cores, ~4 us of bytes. Tensor cores (TF32 or bf16
// products) would move the numbers past the reference's float32 tolerance;
// they are a later design with its own stated tolerance.
//
// Design: one block of 8 warps per (64-query tile, b*h). Blocks run in no
// order, so the TPU's sequential kv axis becomes a loop inside the block
// over the 64-key tiles up to the diagonal (the causal skip: tiles above it
// are never visited), carrying each row's m and l and its slice of acc in
// registers. The heaviest query tiles (last on the diagonal) are launched
// first. Per key tile, K and V are staged in shared memory (K rows padded
// to hd + 4 floats, so the float4 reads of 8 neighbouring keys hit distinct
// banks). Each warp owns 8 query rows: a lane scores keys lane and lane+32
// for all 8 rows at once (one K float4 feeds 8 rows' products), the row's
// max and sum come from warp shuffles, the probabilities go to the warp's
// shared-memory strip, and a lane accumulates P @ V for the dims
// lane + 32 * i of its 8 rows. The mask is -1e30 and the final division
// clamps l at 1e-30, as in the reference. S need not be a tile multiple:
// rows and keys past S are zero-filled and masked. The reference's block
// sizes are its VMEM tiling; the wrapper keeps their S % block check.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 64;              // queries per block, keys per step
constexpr int kRows = kTile / kWarps;  // query rows per warp
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

template <int HD>
constexpr int smem_floats() {
  return kTile * HD + kTile * (HD + 4) + kTile * HD + kTile * kTile;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int64_t H, int64_t KV,
                 int64_t S, float scale) {
  constexpr int KS = HD + 4;                 // padded K row
  constexpr int DPL = (HD + 31) / 32;        // output dims per lane
  extern __shared__ __align__(16) float sm[];
  float* qs = sm;                            // (64, HD)
  float* ks = qs + kTile * HD;               // (64, HD + 4)
  float* vs = ks + kTile * KS;               // (64, HD)
  float* ps = vs + kTile * HD;               // (8 warps, 8 rows, 64 keys)

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t bh = blockIdx.y;
  const int64_t b = bh / H, h = bh % H, kvh = h / (H / KV);
  const int64_t q0 = (static_cast<int64_t>(gridDim.x) - 1 - blockIdx.x) * kTile;
  const T* qb = q + bh * S * HD;
  const T* kb = k + (b * KV + kvh) * S * HD;
  const T* vb = v + (b * KV + kvh) * S * HD;

  for (int i = threadIdx.x; i < kTile * HD; i += kThreads) {
    const int r = i / HD;
    qs[i] = q0 + r < S ? to_f(qb[(q0 + r) * HD + i % HD]) : 0.0f;
  }
  float m[kRows], l[kRows], acc[kRows][DPL];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.0f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[r][i] = 0.0f;
  }
  float* pw = ps + warp * kRows * kTile;
  const int64_t row0 = q0 + warp * kRows;     // this warp's first query
  const int64_t kend = S < q0 + kTile ? S : q0 + kTile;

  for (int64_t k0 = 0; k0 < kend; k0 += kTile) {
    __syncthreads();                         // the previous tile is consumed
    for (int i = threadIdx.x; i < kTile * HD; i += kThreads) {
      const int r = i / HD, d = i % HD;
      const bool in = k0 + r < S;
      ks[r * KS + d] = in ? to_f(kb[(k0 + r) * HD + d]) : 0.0f;
      vs[i] = in ? to_f(vb[(k0 + r) * HD + d]) : 0.0f;
    }
    __syncthreads();

    float s[kRows][2];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r][0] = s[r][1] = 0.0f;
    const float4* k0v = reinterpret_cast<const float4*>(ks + lane * KS);
    const float4* k1v = reinterpret_cast<const float4*>(ks + (lane + 32) * KS);
#pragma unroll
    for (int d4 = 0; d4 < HD / 4; ++d4) {
      const float4 b0 = k0v[d4], b1 = k1v[d4];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 a = reinterpret_cast<const float4*>(qs + (warp * kRows + r) * HD)[d4];
        s[r][0] += dot4(a, b0);
        s[r][1] += dot4(a, b1);
      }
    }
    const int64_t c0 = k0 + lane, c1 = k0 + lane + 32;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int64_t qi = row0 + r;
      const float x0 = (c0 <= qi && c0 < S) ? s[r][0] * scale : kNegInf;
      const float x1 = (c1 <= qi && c1 < S) ? s[r][1] * scale : kNegInf;
      const float m_new = fmaxf(m[r], warp_max(fmaxf(x0, x1)));
      const float corr = expf(m[r] - m_new);
      const float p0 = expf(x0 - m_new), p1 = expf(x1 - m_new);
      l[r] = l[r] * corr + warp_sum(p0 + p1);
      m[r] = m_new;
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[r][i] *= corr;
      pw[r * kTile + lane] = p0;
      pw[r * kTile + lane + 32] = p1;
    }
    __syncwarp();

#pragma unroll 2
    for (int c = 0; c < kTile; c += 4) {
      float vv[4][DPL];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int i = 0; i < DPL; ++i) {
          const int d = lane + 32 * i;
          vv[u][i] = d < HD ? vs[(c + u) * HD + d] : 0.0f;
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 p = *reinterpret_cast<const float4*>(pw + r * kTile + c);
#pragma unroll
        for (int i = 0; i < DPL; ++i) {
          acc[r][i] += p.x * vv[0][i] + p.y * vv[1][i] + p.z * vv[2][i] + p.w * vv[3][i];
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int64_t qi = row0 + r;
    if (qi >= S) continue;
    const float den = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      if (d < HD) store(out + (bh * S + qi) * HD + d, acc[r][i] / den);
    }
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out, int64_t B, int64_t H,
           int64_t KV, int64_t S, cudaStream_t stream, float scale) {
  constexpr int smem = smem_floats<HD>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((S + kTile - 1) / kTile),
                  static_cast<unsigned>(B * H));
  flash_fwd_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), H, KV, S, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_hd(const void* q, const void* k, const void* v, void* out, int64_t B,
              int64_t H, int64_t KV, int64_t S, int64_t hd, cudaStream_t s, float scale) {
  switch (hd) {
    case 8: return launch<T, 8>(q, k, v, out, B, H, KV, S, s, scale);
    case 16: return launch<T, 16>(q, k, v, out, B, H, KV, S, s, scale);
    case 32: return launch<T, 32>(q, k, v, out, B, H, KV, S, s, scale);
    case 64: return launch<T, 64>(q, k, v, out, B, H, KV, S, s, scale);
    case 128: return launch<T, 128>(q, k, v, out, B, H, KV, S, s, scale);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, out: (B, H, S, hd); k, v: (B, KV, S, hd); all contiguous, float32
// (bf16 = 0) or bfloat16 (bf16 = 1); hd in {8, 16, 32, 64, 128};
// B * H <= 65535; scale: 1/sqrt(hd) as the caller rounded it.
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v,
                                     void* out, int64_t B, int64_t H, int64_t KV,
                                     int64_t S, int64_t hd, int64_t bf16, void* stream,
                                     float scale) {
  if (B <= 0 || S <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_hd<__nv_bfloat16>(q, k, v, out, B, H, KV, S, hd, s, scale)
              : launch_hd<float>(q, k, v, out, B, H, KV, S, hd, s, scale);
}
