// Mamba2 SSD intra-chunk computation, forward only, for every (batch,
// chunk, head): for xh (B, c, L, H, P) float32 or bfloat16, bmat and cmat
// (B, c, L, N), dt (B, c, L, H) and a (H,) float32,
//   cum_i    = dt_0 a + ... + dt_i a          (inclusive, in sequence)
//   W[i, j]  = exp(cum_i - cum_j) dt_j  for i >= j, else 0
//   y        = ((C B^T) * W) x                 (L, P), in xh's type
//   state    = (B * (exp(cum_last - cum) dt))^T x   (N, P)
//   decay    = exp(cum_last)
// with float32 math; states, decay and cum are float32.
//
// Replaces the TPU Pallas kernel src/repro/kernels/mamba_scan.py
// mamba_chunk (grid (B*c, H), one (L, P) tile of one head in VMEM per
// program, C B^T recomputed for every head).
//
// Bound on an H100: operations. At zamba2-7b's full width (L 128, H 112,
// P 64, N 64, 32 chunks of a 4096-token sequence) the causal half of
// (C B^T * W) x and the state product are ~2.1 MFLOP per (chunk, head)
// and C B^T ~2.1 MFLOP per chunk: ~7.6 GFLOP, 0.11 ms at 67 TFLOP/s of
// float32, against ~0.30 GB of bytes (0.09 ms at 3.35 TB/s). The products
// stay in float32 outside the tensor cores: TF32 or bf16 operands would
// leave the reference's 1e-4 tolerance.
//
// Design: one block of 256 threads per (batch*chunk, head); consecutive
// blocks are the heads of one chunk, so B and C come from L2 after the
// first. Like the Pallas kernel, the block recomputes the causal half of
// C B^T for its head (~1 MFLOP more a head than the state product): a
// block per chunk that kept C B^T for all heads would leave 100 of the
// 132 SMs idle at B = 1. Shared memory holds B and C transposed to (N,
// L + 4) (padded rows, float4 reads), then x of the head (L, P) in C's
// place, and the weights M = C B^T * W only on and below the diagonal,
// as 32 x 32 tiles (10 tiles at L 128), each stored transposed so the 32
// rows of a tile column are contiguous: ~108 KB at full width, dynamic
// shared memory, two blocks an SM. Above the diagonal nothing is
// computed: exp(cum_i - cum_j) there may overflow (large |a| dt), and a
// mask multiplied in would turn it into inf * 0 = NaN. cum is summed by
// one thread in sequence (dt * a rounded, then added), the order of the
// plain version. The products are register micro-tiles over shared
// memory: C B^T 4 x 4 per thread; the state 4 n x 4 p; y 8 columns of
// one row in each of up to four 32-row tiles (rows r, r + 32, ...), so
// every thread walks the same share of the causal triangle. L, N and P
// are padded with zeros to 32, 4 and 8 in shared memory; global offsets
// are 64-bit (B*c*L*H*P is 29M at full width).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr size_t kMaxSmem = 232448;   // 227 KB, the most a block may have

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// Eight consecutive outputs, 16-byte aligned: two float4 or 8 bfloat16.
__device__ __forceinline__ void store8(float* p, const float* v) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* v) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}

__host__ __device__ inline int round_up(int x, int to) { return (x + to - 1) / to * to; }

struct Geometry {
  int Lpad, Npad, Ppad, LS, tr, tiles;
  __host__ __device__ Geometry(int L, int N, int P)
      : Lpad(round_up(L, 32)), Npad(round_up(N, 4)), Ppad(round_up(P, 8)),
        LS(round_up(L, 32) + 4), tr(round_up(L, 32) / 32),
        tiles(tr * (tr + 1) / 2) {}
  __host__ __device__ int union_floats() const {
    return Npad * LS > Lpad * Ppad ? Npad * LS : Lpad * Ppad;
  }
  __host__ __device__ size_t smem_bytes() const {
    return sizeof(float) * (static_cast<size_t>(Npad) * LS + union_floats() +
                            static_cast<size_t>(tiles) * 1024 + 3 * Lpad);
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
mamba_chunk_kernel(const T* __restrict__ xh, const float* __restrict__ bm,
                   const float* __restrict__ cm, const float* __restrict__ dt,
                   const float* __restrict__ a, T* __restrict__ y, float* __restrict__ st,
                   float* __restrict__ dec, float* __restrict__ cum, int64_t H, int L, int N,
                   int P, bool vec) {
  const Geometry g(L, N, P);
  extern __shared__ __align__(16) float sm[];
  float* bt = sm;                          // (Npad, LS): B transposed
  float* ct = bt + g.Npad * g.LS;          // (Npad, LS): C transposed
  float* xs = ct;                          // (Lpad, Ppad): x, once M is built
  float* mt = ct + g.union_floats();       // tiles of M, (jj, ii) each
  float* dts = mt + g.tiles * 1024;        // (Lpad,)
  float* cums = dts + g.Lpad;              // (Lpad,)
  float* wss = cums + g.Lpad;              // (Lpad,) exp(last - cum) dt
  const int64_t bc = blockIdx.x / H, h = blockIdx.x % H;
  const int tid = threadIdx.x;

  // 1. B and C of the chunk, transposed and zero-padded; dt of the head
  const float* bsrc = bm + bc * L * N;
  const float* csrc = cm + bc * L * N;
  for (int e = tid; e < g.Lpad * g.Npad; e += kThreads) {
    const int l = e / g.Npad, n = e % g.Npad;
    const bool in = l < L && n < N;
    bt[n * g.LS + l] = in ? bsrc[l * N + n] : 0.0f;
    ct[n * g.LS + l] = in ? csrc[l * N + n] : 0.0f;
  }
  for (int l = tid; l < g.Lpad; l += kThreads) {
    dts[l] = l < L ? dt[(bc * L + l) * H + h] : 0.0f;
  }
  __syncthreads();

  // 2. cum in sequence, then the state weights, cum and the decay out
  if (tid == 0) {
    const float ah = a[h];
    float run = 0.0f;
    for (int l = 0; l < L; ++l) {
      const float da = __fmul_rn(dts[l], ah);
      run = l == 0 ? da : __fadd_rn(run, da);
      cums[l] = run;
    }
  }
  __syncthreads();
  const float last = cums[L - 1];
  for (int l = tid; l < g.Lpad; l += kThreads) {
    float w = 0.0f;
    if (l < L) {
      w = __fmul_rn(expf(__fsub_rn(last, cums[l])), dts[l]);
      cum[(bc * L + l) * H + h] = cums[l];
    }
    wss[l] = w;
  }
  if (tid == 0) dec[bc * H + h] = expf(last);

  // 3. M = C B^T * W on the causal tiles, 4 x 4 entries per item
  for (int it = tid; it < g.tiles * 64; it += kThreads) {
    const int tile = it >> 6;
    int ti = 0;
    while ((ti + 1) * (ti + 2) / 2 <= tile) ++ti;
    const int tj = tile - ti * (ti + 1) / 2;
    const int mi = it & 7, mj = (it >> 3) & 7;
    const int i0 = 32 * ti + 4 * mi, j0 = 32 * tj + 4 * mj;
    const bool live = j0 <= i0 + 3 && i0 < L;
    float acc[4][4] = {};
    if (live) {
      for (int n = 0; n < g.Npad; ++n) {
        const float4 c = *reinterpret_cast<const float4*>(ct + n * g.LS + i0);
        const float4 b = *reinterpret_cast<const float4*>(bt + n * g.LS + j0);
        const float cv[4] = {c.x, c.y, c.z, c.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int p = 0; p < 4; ++p) {
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[p][q] += cv[p] * bv[q];
        }
      }
    }
    float* out = mt + tile * 1024;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = j0 + q;
      float v[4];
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const int i = i0 + p;
        v[p] = (live && i >= j && i < L)
                   ? __fmul_rn(acc[p][q], __fmul_rn(expf(__fsub_rn(cums[i], cums[j])), dts[j]))
                   : 0.0f;
      }
      *reinterpret_cast<float4*>(out + (4 * mj + q) * 32 + 4 * mi) =
          make_float4(v[0], v[1], v[2], v[3]);
    }
  }
  __syncthreads();

  // 4. x of the head, in C's place, float32, zero-padded
  const T* xsrc = xh + (bc * L * H + h) * P;
  for (int e = tid; e < g.Lpad * g.Ppad; e += kThreads) {
    const int l = e / g.Ppad, p = e % g.Ppad;
    xs[e] = (l < L && p < P) ? to_f(xsrc[static_cast<int64_t>(l) * H * P + p]) : 0.0f;
  }
  __syncthreads();

  // 5. the state, 4 n x 4 p per item
  float* sout = st + (bc * H + h) * N * P;
  const int pg4 = g.Ppad / 4;
  for (int it = tid; it < (g.Npad / 4) * pg4; it += kThreads) {
    const int p0 = 4 * (it % pg4), n0 = 4 * (it / pg4);
    float acc[4][4] = {};
    for (int l = 0; l < L; ++l) {
      const float w = wss[l];
      const float4 xv = *reinterpret_cast<const float4*>(xs + l * g.Ppad + p0);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float bw = __fmul_rn(bt[(n0 + k) * g.LS + l], w);
        acc[k][0] += bw * xv.x;
        acc[k][1] += bw * xv.y;
        acc[k][2] += bw * xv.z;
        acc[k][3] += bw * xv.w;
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (n0 + k >= N) continue;
      float* row = sout + static_cast<int64_t>(n0 + k) * P + p0;
      if (vec) {
        *reinterpret_cast<float4*>(row) = make_float4(acc[k][0], acc[k][1], acc[k][2], acc[k][3]);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (p0 + q < P) row[q] = acc[k][q];
        }
      }
    }
  }

  // 6. y: 8 columns of row r in each of up to four tile rows per item
  T* yout = y + (bc * L * H + h) * P;
  const int pg8 = g.Ppad / 8;
  for (int it = tid; it < 32 * pg8 * ((g.tr + 3) / 4); it += kThreads) {
    const int r = it & 31, p0 = 8 * ((it >> 5) % pg8), kg = 4 * ((it >> 5) / pg8);
    float acc[4][8] = {};
    for (int tj = 0; tj < g.tr && tj <= kg + 3; ++tj) {
      for (int jj = 0; jj < 32; ++jj) {
        const float* xr = xs + (32 * tj + jj) * g.Ppad + p0;
        const float4 xa = reinterpret_cast<const float4*>(xr)[0];
        const float4 xb = reinterpret_cast<const float4*>(xr)[1];
        const float xv[8] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int ti = kg + k;
          if (ti < g.tr && ti >= tj) {
            const float m = mt[(ti * (ti + 1) / 2 + tj) * 1024 + jj * 32 + r];
#pragma unroll
            for (int q = 0; q < 8; ++q) acc[k][q] += m * xv[q];
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = 32 * (kg + k) + r;
      if (kg + k >= g.tr || i >= L) continue;
      T* row = yout + static_cast<int64_t>(i) * H * P + p0;
      if (vec) {
        store8(row, acc[k]);
      } else {
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          if (p0 + q < P) store(row + q, acc[k][q]);
        }
      }
    }
  }
}

template <typename T>
int launch(const void* xh, const float* bm, const float* cm, const float* dt, const float* a,
           void* y, float* st, float* dec, float* cum, int64_t bc, int64_t L, int64_t H,
           int64_t N, int64_t P, cudaStream_t s) {
  const size_t smem = Geometry(static_cast<int>(L), static_cast<int>(N),
                               static_cast<int>(P)).smem_bytes();
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(
      mamba_chunk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec = P % 8 == 0 &&
                   ((reinterpret_cast<uintptr_t>(y) | reinterpret_cast<uintptr_t>(st)) & 15) == 0;
  mamba_chunk_kernel<T><<<static_cast<unsigned>(bc * H), kThreads, smem, s>>>(
      static_cast<const T*>(xh), bm, cm, dt, a, static_cast<T*>(y), st, dec, cum, H,
      static_cast<int>(L), static_cast<int>(N), static_cast<int>(P), vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// xh, y: (bc, L, H, P) float32 (bf16 = 0) or bfloat16 (bf16 = 1); bm, cm:
// (bc, L, N); dt, cum: (bc, L, H); a: (H,); st: (bc, H, N, P); dec: (bc, H);
// all contiguous, all but xh and y float32. bc = B * c.
extern "C" int repro_mamba_chunk(const void* xh, const float* bm, const float* cm,
                                 const float* dt, const float* a, void* y, float* st,
                                 float* dec, float* cum, int64_t bc, int64_t L, int64_t H,
                                 int64_t N, int64_t P, int64_t bf16, void* stream) {
  if (bc <= 0 || H <= 0 || L <= 0) return 0;   // N or P 0: zero-width loops
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(xh, bm, cm, dt, a, y, st, dec, cum, bc, L, H, N, P, s)
              : launch<float>(xh, bm, cm, dt, a, y, st, dec, cum, bc, L, H, N, P, s);
}
