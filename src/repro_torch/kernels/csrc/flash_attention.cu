// Causal self attention, forward only, with an online softmax over key
// tiles: out[b, h, i] = softmax_j<=i(q_i . k_j / sqrt(hd)) @ v, for q
// (B, H, S, hd) and k, v (B, KV, S, hd) with KV dividing H (GQA: query head
// h reads KV head h / (H / KV), so the KV heads are never repeated in
// memory). float32 or bfloat16 in, float32 softmax, the output in q's type.
//
// Replaces the TPU Pallas kernel src/repro/kernels/flash_attention.py
// flash_attention (grid (B*H, nq, nk) with the kv-block axis innermost and
// sequential, m, l and acc carried across it in VMEM scratch, blocks above
// the diagonal skipped with pl.when).
//
// Bound on an H100: operations. At paper-lenet's prefill (1, 12, 1024, 64)
// the causal half of QK^T and of P @ V is 4 * hd * S(S+1)/2 * H = 1.6 GFLOP
// against 12.6 MB of q, k, v and out (~4 us of bytes). On float32 SIMT
// units (67 TFLOP/s) that is ~24 us; this kernel runs the products on the
// TF32 tensor cores (495 TFLOP/s) three times over (below): ~10 us.
//
// Products: mma.sync.m16n8k8 TF32 with the 3xTF32 split (the helpers are
// in csrc/tf32_mma.cuh, which mamba_scan.cu shares). A float32 x is
// hi = cvt.rna.tf32(x) plus lo = cvt.rna.tf32(x - hi), and a.b is taken as
// hi(a)lo(b) + lo(a)hi(b) + hi(a)hi(b), the small terms accumulated first;
// only lo(a)lo(b) (~2^-22 relative) is dropped. One TF32 product keeps ~3
// decimal digits and misses the reference's float32 tolerance (rtol 1e-5,
// atol 1e-6) on most outputs at the prefill shape; the split stays within
// it (a CPU emulation with this rounding: tests/test_torch_tf32_split.py).
// The tensor cores' own float32 sums truncate, so a long chain of steps
// into one accumulator drifts (to ~4e-6 at the prefill shape): every two
// 8-wide k steps start a fresh accumulator, which a round-to-nearest
// float32 add then folds into S or the output. Q is staged as float32 and
// split as its fragments are read (that halves its shared memory against
// holding hi and lo, and measured faster), K and V as their fragments are
// read, P in registers. bfloat16 inputs are exact in TF32 (lo = 0): Q K^T
// is then one product per step and P @ V two (P is float32). The
// independent products of a step are issued phase by phase (all small
// terms, then all hi.hi), so that a warp always has work between two
// dependent tensor-core instructions.
// Why mma.sync and not wgmma: wgmma's TF32 form takes both operands
// K-major, and V as P @ V's B operand is MN-major (only 16-bit types may be
// transposed), so V would have to be written transposed into shared memory;
// at these sizes the kernel is bound by latency and load balance, and
// mma.sync keeps S and P in registers with no transposition.
//
// Layout, as FlashAttention-2: a block of 4 warps takes a 64-query tile of
// one (b, h); each warp owns 16 query rows and keeps S (16 x 64 keys) and
// its output (16 x hd) in the accumulator fragments. The softmax runs on
// the fragments (row max and sum over the 4 threads of a quad), m, l and
// the rescale factor in float32. The accumulator of S for keys (2t, 2t+1)
// of an 8-key step is reused as the A operand of P @ V with the step's k
// index permuted (k = t <-> key 2t, k = t + 4 <-> key 2t + 1); V's B
// fragments are read from the same rows of V, so P never leaves the
// registers. Q K^T permutes the head dimension the same way, so Q's and
// K's fragments are 8-byte reads. Rows in shared memory are padded (Q and
// K by 8 floats, V by 4; bfloat16 rows by 8 elements) so that the
// fragment reads of a warp hit distinct banks.
//
// Pipeline: K and V tiles of 64 keys land by cp.async.cg 16-byte copies in
// two shared-memory stages; the next tile's copies are issued right after
// the barrier that makes the current tile visible, so they overlap its
// math, with one barrier a tile. Keys past S are zero-filled by the copy
// (source size 0) and masked; rows past S are zero and never written. Only
// the diagonal tile and the one holding S's end are masked (-1e30, as the
// reference); the final division clamps l at 1e-30.
//
// Head dims: the kernel is instantiated at hd 8, 16, 32, 64, 112 (zamba2-7b's
// 3584/32) and 128; kernels/flash_attention.py zero-pads every other hd up
// to 128 to the next of these widths (exact: zero columns of Q and K add
// nothing to Q K^T, V's zero columns are cut from the output, and the scale
// comes from the true hd). At 112 the P @ V loop takes 7 output blocks at
// once (a divisor of hd/8 = 14) and the shared-memory rows are padded to
// the bank pattern of the power-of-two widths.
//
// Schedule: block x of the grid's x axis takes query tiles nq - 1 - x and
// x, one after the other, so every block does nq + 1 key tiles (the middle
// tile alone where nq is odd); kernels/flash_attention.py tile_schedule
// mirrors it. Against one tile a block, heaviest first, it measured 17-20%
// faster at head dim 64 and level at 128 (PERF.md). No atomics and no split
// over keys: every sum runs in a fixed order, so a rerun gives the same
// bits. Offsets are 64-bit; B * H <= 65535 (the grid's y axis).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "smem.cuh"
#include "tf32_mma.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRowsQ = 16 * kWarps;    // queries per block, 16 a warp
constexpr int kTile = 64;              // keys per step
constexpr int kSteps = 2;              // k steps of 8 per fresh accumulator
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// two neighbouring elements as floats (an 8- or 4-byte read)
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// A row of hd elements padded by `pad`; a width that is no power of two is
// padded further, to the same remainder modulo `period` elements (32 banks
// of 4 bytes) as the power-of-two widths' rows.
__host__ __device__ constexpr int row_stride(int hd, int pad, int period) {
  return (hd & (hd - 1)) == 0 ? hd + pad : hd + ((pad - hd % period) % period + period) % period;
}

// The number of 8-wide output blocks P @ V takes at once: the largest
// divisor of hd/8 up to 8.
__host__ __device__ constexpr int pv_group(int blocks) {
  int g = blocks < 8 ? blocks : 8;
  while (blocks % g != 0) --g;
  return g;
}

// Shared memory of one block: Q (float), then two stages of K and of V
// in the input type. Rows are padded so that a warp's fragment reads hit
// distinct banks: K's 8-byte reads of 8 keys x 4 dim pairs, V's reads of
// keys 2t (t < 4) x 8 dims.
template <typename T, int HD>
struct Smem {
  static constexpr bool kExact = sizeof(T) == 2;         // bfloat16: lo = 0
  static constexpr int kPeriod = 128 / static_cast<int>(sizeof(T));  // 32 banks
  static constexpr int kQS = row_stride(HD, 8, 32);      // Q row, floats
  static constexpr int kKS = row_stride(HD, 8, kPeriod);  // K row, elements
  static constexpr int kVS = row_stride(HD, sizeof(T) == 4 ? 4 : 8, kPeriod);
  static constexpr int kQFloats = kRowsQ * kQS;
  static constexpr int kKElems = kTile * kKS, kVElems = kTile * kVS;
  static constexpr int kBytes =
      kQFloats * 4 + 2 * (kKElems + kVElems) * static_cast<int>(sizeof(T));
};

// One 64-key tile of K and V into stage buffers ks, vs (cp.async).
template <typename T, int HD>
__device__ __forceinline__ void load_kv(T* ks, T* vs, const T* kb, const T* vb, int64_t k0,
                                        int64_t S) {
  using L = Smem<T, HD>;
  constexpr int kPer = 16 / static_cast<int>(sizeof(T));  // elements a copy
  constexpr int kChunks = HD / kPer;                        // copies a row
  for (int i = threadIdx.x; i < kTile * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * kPer;
    const bool in = k0 + r < S;
    const int64_t off = in ? (k0 + r) * HD + c : 0;
    cp_async16(ks + r * L::kKS + c, kb + off, in);
    cp_async16(vs + r * L::kVS + c, vb + off, in);
  }
}

// One key tile for one warp: S = Q K^T on the tensor cores, the online
// softmax on the fragments, acc += P V. masked: the tile holds the
// diagonal or the end of the sequence.
template <typename T, int HD>
__device__ __forceinline__ void tile_step(const float* qs, const T* ks, const T* vs, int64_t k0,
                                          int64_t row_a, int64_t S, float scale, bool masked,
                                          float (&m)[2], float (&l)[2],
                                          float (&acc)[HD / 8][4]) {
  using L = Smem<T, HD>;
  constexpr int KS = HD / 8 < kSteps ? HD / 8 : kSteps;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float s[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;

  // S (16 x 64) = Q K^T: k steps over the head dimension, dims (2t, 2t+1)
  // as k (t, t + 4); 8 products (keys 8j..8j+7) a step
#pragma unroll 1
  for (int kk = 0; kk < HD / 8; kk += KS) {
    uint32_t ah[KS][4], al[KS][4];
    float b0[KS][8], b1[KS][8];
#pragma unroll
    for (int u = 0; u < KS; ++u) {
      const int d0 = (kk + u) * 8 + 2 * t;
      const float2 x0 = load2(qs + g * L::kQS + d0), x1 = load2(qs + (g + 8) * L::kQS + d0);
      if (L::kExact) {
        ah[u][0] = __float_as_uint(x0.x); ah[u][1] = __float_as_uint(x1.x);
        ah[u][2] = __float_as_uint(x0.y); ah[u][3] = __float_as_uint(x1.y);
      } else {
        split(x0.x, ah[u][0], al[u][0]); split(x1.x, ah[u][1], al[u][1]);
        split(x0.y, ah[u][2], al[u][2]); split(x1.y, ah[u][3], al[u][3]);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 b = load2(ks + (j * 8 + g) * L::kKS + d0);
        b0[u][j] = b.x;
        b1[u][j] = b.y;
      }
    }
    if (L::kExact) {
#pragma unroll
      for (int u = 0; u < KS; ++u) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          mma(s[j], ah[u], __float_as_uint(b0[u][j]), __float_as_uint(b1[u][j]));
      }
    } else {
      mma3_steps<KS, 8>(s, ah, al, b0, b1);
    }
  }

  // online softmax: this thread holds rows row_a (c0, c1) and row_a + 8
  // (c2, c3), keys k0 + 8j + 2t + e
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[j][e] * scale;
      if (masked) {
        const int64_t col = k0 + j * 8 + 2 * t + (e & 1);
        if (col > row_a + (e >> 1) * 8 || col >= S) x = kNegInf;
      }
      s[j][e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  }
  float corr[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    const float m_new = fmaxf(m[i], mx[i]);
    corr[i] = expf(m[i] - m_new);
    m[i] = m_new;
    l[i] *= corr[i];
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] = expf(s[j][e] - m[e >> 1]);
      l[e >> 1] += s[j][e];
    }
  }
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    acc[n][0] *= corr[0]; acc[n][1] *= corr[0];
    acc[n][2] *= corr[1]; acc[n][3] *= corr[1];
  }

  // acc (16 x hd) += P (16 x 64) V (64 x hd): k steps of 8 keys, keys
  // (2t, 2t+1) as k (t, t + 4) in both operands; G output blocks at once
  constexpr int G = pv_group(HD / 8);
  constexpr int KP = kSteps;
#pragma unroll
  for (int j = 0; j < 8; j += KP) {
    uint32_t ph[KP][4], pl[KP][4];
#pragma unroll
    for (int u = 0; u < KP; ++u) {
      split(s[j + u][0], ph[u][0], pl[u][0]);
      split(s[j + u][2], ph[u][1], pl[u][1]);
      split(s[j + u][1], ph[u][2], pl[u][2]);
      split(s[j + u][3], ph[u][3], pl[u][3]);
    }
#pragma unroll
    for (int n0 = 0; n0 < HD / 8; n0 += G) {
      float b0[KP][G], b1[KP][G];
#pragma unroll
      for (int u = 0; u < KP; ++u) {
        const T* vr = vs + ((j + u) * 8 + 2 * t) * L::kVS + g;
#pragma unroll
        for (int i = 0; i < G; ++i) {
          b0[u][i] = to_f(vr[(n0 + i) * 8]);
          b1[u][i] = to_f(vr[L::kVS + (n0 + i) * 8]);
        }
      }
      if (L::kExact) {
#pragma unroll
        for (int u = 0; u < KP; ++u) {
#pragma unroll
          for (int i = 0; i < G; ++i) {
            mma(acc[n0 + i], pl[u], __float_as_uint(b0[u][i]), __float_as_uint(b1[u][i]));
            mma(acc[n0 + i], ph[u], __float_as_uint(b0[u][i]), __float_as_uint(b1[u][i]));
          }
        }
      } else {
        float c[G][4];
#pragma unroll
        for (int i = 0; i < G; ++i) {
#pragma unroll
          for (int e = 0; e < 4; ++e) c[i][e] = acc[n0 + i][e];
        }
        mma3_steps<KP, G>(c, ph, pl, b0, b1);
#pragma unroll
        for (int i = 0; i < G; ++i) {
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[n0 + i][e] = c[i][e];
        }
      }
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ out, int64_t H, int64_t KV, int64_t S, float scale) {
  using L = Smem<T, HD>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);
  T* kst = reinterpret_cast<T*>(smem_raw + L::kQFloats * 4);
  T* vst = kst + 2 * L::kKElems;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int64_t bh = blockIdx.y;
  const int64_t b = bh / H, h = bh % H, kvh = h / (H / KV);
  const T* qb = q + bh * S * HD;
  const T* kb = k + (b * KV + kvh) * S * HD;
  const T* vb = v + (b * KV + kvh) * S * HD;
  const int nq = static_cast<int>((S + kRowsQ - 1) / kRowsQ);
  // the query tiles of this block (tile_schedule in kernels/flash_attention.py)
  const int first = nq - 1 - static_cast<int>(blockIdx.x);
  const int ntiles = first != static_cast<int>(blockIdx.x) ? 2 : 1;

  for (int n = 0; n < ntiles; ++n) {
    const int64_t q0 = static_cast<int64_t>(n == 0 ? first : blockIdx.x) * kRowsQ;
    __syncthreads();                       // the previous tile is done with shared memory
    for (int i = threadIdx.x; i < kRowsQ * HD; i += kThreads) {
      const int r = i / HD, d = i % HD;
      qs[r * L::kQS + d] = q0 + r < S ? to_f(qb[(q0 + r) * HD + d]) : 0.0f;
    }
    const int64_t kend = S < q0 + kRowsQ ? S : q0 + kRowsQ;
    const int nk = static_cast<int>((kend + kTile - 1) / kTile);  // up to the diagonal
    load_kv<T, HD>(kst, vst, kb, vb, 0, S);
    cp_async_commit();

    float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
    float acc[HD / 8][4];
#pragma unroll
    for (int i = 0; i < HD / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.0f;
    const int64_t row_a = q0 + warp * 16 + g;
    const float* wq = qs + warp * 16 * L::kQS;   // this warp's 16 rows

    for (int j = 0; j < nk; ++j) {
      cp_async_wait_all();
      __syncthreads();                     // tile j visible; tile j - 1's stage is free
      if (j + 1 < nk) {
        const int nx = (j + 1) & 1;
        load_kv<T, HD>(kst + nx * L::kKElems, vst + nx * L::kVElems, kb, vb,
                       static_cast<int64_t>(j + 1) * kTile, S);
        cp_async_commit();
      }
      const T* ks = kst + (j & 1) * L::kKElems;
      const T* vs = vst + (j & 1) * L::kVElems;
      const int64_t k0 = static_cast<int64_t>(j) * kTile;
      const bool masked = k0 + kTile > q0 || k0 + kTile > S;
      tile_step<T, HD>(wq, ks, vs, k0, row_a, S, scale, masked, m, l, acc);
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
      l[i] = fmaxf(l[i], 1e-30f);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int64_t row = row_a + 8 * i;
      if (row >= S) continue;
      T* orow = out + (bh * S + row) * HD + 2 * t;
#pragma unroll
      for (int nn = 0; nn < HD / 8; ++nn) {
        store2(orow + nn * 8, acc[nn][2 * i] / l[i], acc[nn][2 * i + 1] / l[i]);
      }
    }
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out, int64_t B, int64_t H,
           int64_t KV, int64_t S, cudaStream_t stream, float scale) {
  constexpr int smem = Smem<T, HD>::kBytes;
  static size_t high[kSmemDevices];
  const cudaError_t err = allow_smem(flash_fwd_kernel<T, HD>, smem, high);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t nq = (S + kRowsQ - 1) / kRowsQ;
  const dim3 grid(static_cast<unsigned>((nq + 1) / 2), static_cast<unsigned>(B * H));
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
    case 112: return launch<T, 112>(q, k, v, out, B, H, KV, S, s, scale);
    case 128: return launch<T, 128>(q, k, v, out, B, H, KV, S, s, scale);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, out: (B, H, S, hd); k, v: (B, KV, S, hd); all contiguous and 16-byte
// aligned, float32 (bf16 = 0) or bfloat16 (bf16 = 1); hd in {8, 16, 32,
// 64, 112, 128}; B * H <= 65535; scale: 1/sqrt of the true hd (before any
// zero padding) as the caller rounded it.
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v,
                                     void* out, int64_t B, int64_t H, int64_t KV,
                                     int64_t S, int64_t hd, int64_t bf16, void* stream,
                                     float scale) {
  if (B <= 0 || S <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_hd<__nv_bfloat16>(q, k, v, out, B, H, KV, S, hd, s, scale)
              : launch_hd<float>(q, k, v, out, B, H, KV, S, hd, s, scale);
}
