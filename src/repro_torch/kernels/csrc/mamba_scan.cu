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
// Bound on an H100: at zamba2-7b's full width (L 128, H 112, P 64, N 64,
// 32 chunks of a 4096-token sequence) ~299 MB of bytes (0.089 ms at 3.35
// TB/s) against ~7.6 GFLOP: the causal half of C B^T once a chunk, the
// causal half of (C B^T * W) x and the state product a (chunk, head). That
// is 0.113 ms on the float32 SIMT units (67 TFLOP/s); this kernel runs the
// three products on the TF32 tensor cores three times over (the 3xTF32
// split, below; 0.046 ms at 495 TFLOP/s), so its design is bound by bytes.
//
// Products: mma.sync.m16n8k8 TF32 with the 3xTF32 split of
// csrc/tf32_mma.cuh (flash_attention.cu's scheme and the reasons for it:
// x = hi + lo, a.b as hi.lo + lo.hi + hi.hi with the small products first,
// a fresh accumulator every two k steps folded in by a round-to-nearest
// add). One TF32 product would leave the reference's 1e-4 tolerance; the
// split stays well inside it (a CPU emulation in the kernel's order and
// rounding: tests/test_torch_mamba_tf32.py). A bfloat16 x is exact in TF32
// (its lo is 0, and that product adds exact zeros).
//
// Layout: one block of 8 warps per (batch*chunk, group of up to 4 heads);
// consecutive blocks are the head groups of one chunk, so B and C come from
// L2 after the first. The chunk is cut into 16-row tiles (L <= 128: at most
// 8); the warps form 4 pairs, and pair w owns row tiles w and 7 - w, so
// every pair takes 9 of the 36 causal 16 x 16 blocks; the two warps of a
// pair take the output's columns in two halves. C B^T is computed once a
// block (a chunk and head group, not once a head) on the causal blocks
// only, by the pairs, and kept in shared memory in the layout of the mma
// accumulators (one float4 a lane and 8-column tile: conflict-free 16-byte
// reads). For a head, the accumulator of C B^T for keys (2t, 2t + 1) of an
// 8-key step is turned into the weights M = C B^T * W in registers
// (masked to j <= i < L before the exp: exp(cum_i - cum_j) above the
// diagonal may overflow, and a mask multiplied in would turn it into
// inf * 0 = NaN) and used as the A operand of M x with the step's k index
// permuted (k = t <-> key 2t, k = t + 4 <-> key 2t + 1); x's B fragments
// are read from the same rows. The state takes (B * w_state)^T as A, read
// from B in shared memory with the same permutation, and the same x
// fragments as B; pair w owns the state's 16-row tiles w, w + 4, ..., its
// two warps the two column halves. Row tile 7 - w and the first state row
// tile walk the chunk's 16-step key blocks together, so x's fragments of a
// block are split once for both; row tile w takes its w + 1 blocks after.
//
// Memory: B and C of the chunk and x of each head land in shared memory by
// 16-byte cp.async copies (scalar loads where a row is no multiple of 16
// bytes), rows padded to a stride of 4 floats past a multiple of 32 (8
// bfloat16 past one of 32 for x), so the fragment reads of a warp hit
// distinct banks; L, N and P are zero-padded to 16, 8 and 8. x takes C's
// place once C B^T is done. ~110 KB at full width: two blocks (16 warps)
// an SM, so one block's copies land under the other's products. The loops
// over the causal blocks and the chunk's steps stay loops (not unrolled):
// the kernel's code stays small. cum is summed in sequence (dt * a
// rounded, then added: the order of the plain version) by one thread a
// head, while the warps compute C B^T.
// Global offsets are 64-bit (B*c*L*H*P is 29M at full width).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "smem.cuh"
#include "tf32_mma.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kPairs = 4;            // warp pairs: two row tiles each
constexpr int kTiles = 2 * kPairs;   // 16-row tiles of a chunk
constexpr int kMaxL = 16 * kTiles;
constexpr int kSlots = kTiles + 1;   // causal 16 x 16 blocks a pair
constexpr int kHeads = 4;            // heads a block at most
constexpr int kPT = 4;               // 8-column output tiles a warp a pass
constexpr size_t kMaxSmem = 232448;  // 227 KB, the most a block may have

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store1(float* p, float a) { *p = a; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float a) { *p = __float2bfloat16_rn(a); }
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__host__ __device__ inline int round_up(int x, int to) { return (x + to - 1) / to * to; }

// Shared memory of a block, in bytes from its start: B (Lp, SN) float; C
// (Lp, SN) float, later x (Lp, SX) T; C B^T (kPairs, kSlots, 2, 32) float4;
// cum, dt and w_state of the block's heads (kHeads, Lp) float each; then
// the current head's factors of W (rows: 8 T (T - 1) float for T = Lp /
// 16 row tiles; columns: Lp float) and a flag a head (cum non-increasing).
struct Geometry {
  int Lp, SN, SX, item;
  __host__ __device__ Geometry(int L, int N, int P, int itemsize)
      : Lp(round_up(L, 16)), SN(round_up(N, 32) + 4),
        SX(round_up(P, 32) + (itemsize == 4 ? 4 : 8)), item(itemsize) {}
  __host__ __device__ size_t b_bytes() const { return static_cast<size_t>(4) * Lp * SN; }
  __host__ __device__ size_t x_bytes() const { return static_cast<size_t>(item) * Lp * SX; }
  __host__ __device__ size_t c_off() const { return b_bytes(); }
  __host__ __device__ size_t g_off() const {
    return c_off() + (b_bytes() > x_bytes() ? b_bytes() : x_bytes());
  }
  __host__ __device__ size_t vec_off() const {
    return g_off() + static_cast<size_t>(16) * kPairs * kSlots * 2 * 32;
  }
  __host__ __device__ size_t fac_off() const {
    return vec_off() + static_cast<size_t>(3) * 4 * kHeads * Lp;
  }
  __host__ __device__ int row_factors() const { return 8 * (Lp / 16) * (Lp / 16 - 1); }
  __host__ __device__ size_t bytes() const {
    return fac_off() + static_cast<size_t>(4) * (row_factors() + Lp + kHeads);
  }
};

// rows x cols of src (row stride ld elements) into dst (row stride sd):
// 16-byte cp.async copies where vec, else plain loads. Then zeros in rows
// rows .. rows_pad - 1 and, where pad_cols, in columns cols .. sd - 1 (a
// padded row or column that is a k index of a product must be 0, and a
// finite 0: it multiplies zero weights).
template <typename T>
__device__ void stage(T* dst, int sd, const T* src, int64_t ld, int rows, int cols,
                      int rows_pad, bool pad_cols, bool vec) {
  constexpr int kPer = 16 / static_cast<int>(sizeof(T));
  if (vec) {
    const int chunks = cols / kPer;
    for (int i = threadIdx.x; i < rows * chunks; i += kThreads) {
      const int r = i / chunks, c = (i % chunks) * kPer;
      cp_async16(dst + r * sd + c, src + r * ld + c, true);
    }
  } else {
    for (int i = threadIdx.x; i < rows * cols; i += kThreads) {
      const int r = i / cols, c = i % cols;
      dst[r * sd + c] = src[r * ld + c];
    }
  }
  const int extra = pad_cols ? sd - cols : 0;
  for (int i = threadIdx.x; i < rows * extra; i += kThreads) {
    dst[(i / extra) * sd + cols + i % extra] = T(0.0f);
  }
  for (int i = rows * sd + threadIdx.x; i < rows_pad * sd; i += kThreads) dst[i] = T(0.0f);
}

// the masked weight M[i, j] = cb * exp(cum_i - cum_j) * dt_j, rounded as
// the plain version; 0 above the diagonal and past L, before any exp
__device__ __forceinline__ float weight(float cb, int i, int j, int L, float ci, float cj,
                                        float dj) {
  return (j <= i && i < L) ? __fmul_rn(cb, __fmul_rn(expf(__fsub_rn(ci, cj)), dj)) : 0.0f;
}

// Where W's row factor exp(cum_i - cum_(16 J + 15)) of row i (in row tile
// I > J) lies among the row factors: the I rows of tile I after the
// 8 I (I - 1) entries of the tiles above.
__device__ __forceinline__ int row_factor(int i, int J) {
  const int I = i / 16;
  return 8 * I * (I - 1) + (i - 16 * I) * I + J;
}

// The row tile and key tile of a pair's causal block k: row tile `pair`
// for keys 0 .. pair, then row tile kTiles - 1 - pair for the rest.
__device__ __forceinline__ void block_of(int pair, int k, int& I, int& J) {
  const bool first = k <= pair;
  I = first ? pair : kTiles - 1 - pair;
  J = first ? k : k - pair - 1;
}

// x's B fragments of two 8-step k blocks at rows r0 + 2t (+1), 4 tiles of
// 8 columns from c0 (k index permuted as the A operands'), split into TF32
// hi and lo
template <typename T>
__device__ __forceinline__ void x_split(const T* xs, int SX, int r0, int c0,
                                        uint32_t (&bh)[2][kPT][2], uint32_t (&bl)[2][kPT][2]) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const T* xr = xs + (r0 + 8 * u + 2 * (lane & 3)) * SX + c0 + (lane >> 2);
#pragma unroll
    for (int n = 0; n < kPT; ++n) {
      split_int(to_f(xr[8 * n]), bh[u][n][0], bl[u][n][0]);
      split_int(to_f(xr[SX + 8 * n]), bh[u][n][1], bl[u][n][1]);
    }
  }
}

// The A fragments of M = C B^T * W on causal block (I, J) for two 8-key
// steps (keys 2t, 2t + 1 of each as k t, t + 4), from C B^T's accumulators
// gk (this lane's, 32 float4 apart a step), split into TF32 hi and lo.
// Off the diagonal, where cum does not increase (mono), W is the product
// of the row factor and the column factor; else exp(cum_i - cum_j) dt_j.
__device__ __forceinline__ void m_frags(const float4* gk, int I, int J, int L, bool mono,
                                        const float* ch, const float* dh, const float* rfs,
                                        const float* cds, uint32_t (&ah)[2][4],
                                        uint32_t (&al)[2][4]) {
  const int lane = threadIdx.x % 32, g4 = lane >> 2, t4 = lane & 3;
  const int ia = 16 * I + g4, ib = ia + 8;
  if (mono && J < I) {       // factored: rows past L have factor 0
    const float ra = rfs[row_factor(ia, J)], rb = rfs[row_factor(ib, J)];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const float4 gv = gk[32 * u];
      const float2 cd = *reinterpret_cast<const float2*>(cds + 16 * J + 8 * u + 2 * t4);
      split_int(__fmul_rn(gv.x, __fmul_rn(ra, cd.x)), ah[u][0], al[u][0]);
      split_int(__fmul_rn(gv.z, __fmul_rn(rb, cd.x)), ah[u][1], al[u][1]);
      split_int(__fmul_rn(gv.y, __fmul_rn(ra, cd.y)), ah[u][2], al[u][2]);
      split_int(__fmul_rn(gv.w, __fmul_rn(rb, cd.y)), ah[u][3], al[u][3]);
    }
  } else {
    const float cia = ch[ia], cib = ch[ib];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const float4 gv = gk[32 * u];
      const int j = 16 * J + 8 * u + 2 * t4;
      const float2 cj = *reinterpret_cast<const float2*>(ch + j);
      const float2 dj = *reinterpret_cast<const float2*>(dh + j);
      split_int(weight(gv.x, ia, j, L, cia, cj.x, dj.x), ah[u][0], al[u][0]);
      split_int(weight(gv.z, ib, j, L, cib, cj.x, dj.x), ah[u][1], al[u][1]);
      split_int(weight(gv.y, ia, j + 1, L, cia, cj.y, dj.y), ah[u][2], al[u][2]);
      split_int(weight(gv.w, ib, j + 1, L, cib, cj.y, dj.y), ah[u][3], al[u][3]);
    }
  }
}

// The A fragments of the state's (B * w_state)^T: rows n0 + g (+8), k over
// the chunk's steps l0 + 2t (+1) of two 8-step blocks, split.
__device__ __forceinline__ void state_frags(const float* bs, int SN, const float* wh, int l0,
                                            int n0, uint32_t (&ah)[2][4], uint32_t (&al)[2][4]) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int l = l0 + 8 * u + 2 * (lane & 3);
    const float2 w = *reinterpret_cast<const float2*>(wh + l);
    const float* b = bs + l * SN + n0 + (lane >> 2);
    split_int(__fmul_rn(b[0], w.x), ah[u][0], al[u][0]);
    split_int(__fmul_rn(b[8], w.x), ah[u][1], al[u][1]);
    split_int(__fmul_rn(b[SN], w.y), ah[u][2], al[u][2]);
    split_int(__fmul_rn(b[SN + 8], w.y), ah[u][3], al[u][3]);
  }
}

// two rows of a 16 x 32 accumulator tile out (rows i0 + g, i0 + g + 8 below
// `rows`, columns c0 + 8n + 2t (+1) below `cols`), row stride ld
template <typename T>
__device__ __forceinline__ void store_tile(T* out, int64_t ld, int i0, int rows, int c0, int cols,
                                           const float (&acc)[kPT][4]) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = i0 + (lane >> 2) + 8 * r;
    if (i >= rows) continue;
#pragma unroll
    for (int n = 0; n < kPT; ++n) {
      const int p = c0 + 8 * n + 2 * (lane & 3);
      T* o = out + i * ld + p;
      if (p + 1 < cols) {
        store2(o, acc[n][2 * r], acc[n][2 * r + 1]);
      } else if (p < cols) {
        store1(o, acc[n][2 * r]);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
mamba_chunk_kernel(const T* __restrict__ xh, const float* __restrict__ bm,
                   const float* __restrict__ cm, const float* __restrict__ dt,
                   const float* __restrict__ a, T* __restrict__ y, float* __restrict__ st,
                   float* __restrict__ dec, float* __restrict__ cum, int64_t H, int L, int N,
                   int P, bool vec_bc, bool vec_x) {
  const Geometry geo(L, N, P, static_cast<int>(sizeof(T)));
  extern __shared__ __align__(16) unsigned char smem[];
  float* bs = reinterpret_cast<float*>(smem);
  float* cs = reinterpret_cast<float*>(smem + geo.c_off());
  T* xs = reinterpret_cast<T*>(smem + geo.c_off());
  float4* gs = reinterpret_cast<float4*>(smem + geo.g_off());     // (kPairs, kSlots, 2, 32)
  float* cums = reinterpret_cast<float*>(smem + geo.vec_off());   // (kHeads, Lp)
  float* dts = cums + kHeads * geo.Lp;
  float* wss = dts + kHeads * geo.Lp;
  float* rfs = reinterpret_cast<float*>(smem + geo.fac_off());    // row factors
  float* cds = rfs + geo.row_factors();                           // (Lp,) column factors
  int* monos = reinterpret_cast<int*>(cds + geo.Lp);              // (kHeads,)
  const int Lp = geo.Lp, SN = geo.SN, SX = geo.SX, TR = Lp / 16;
  const int64_t groups = (H + kHeads - 1) / kHeads;
  const int64_t bc = blockIdx.x / groups;
  const int64_t h0 = (blockIdx.x % groups) * kHeads;
  const int nh = H - h0 < kHeads ? static_cast<int>(H - h0) : kHeads;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int pair = warp % kPairs, half = warp / kPairs;
  const int g4 = lane >> 2, t4 = lane & 3;
  const int64_t xrow = H * P;                       // x's and y's row stride
  const T* xsrc = xh + bc * L * xrow + h0 * P;      // x of head h0, row 0

  // 1. B and C of the chunk, dt of the block's heads
  stage(bs, SN, bm + bc * L * N, N, L, N, Lp, true, vec_bc);
  stage(cs, SN, cm + bc * L * N, N, L, N, Lp, true, vec_bc);
  cp_async_commit();
  for (int i = threadIdx.x; i < kHeads * Lp; i += kThreads) {
    const int h = i / Lp, l = i % Lp;
    dts[i] = h < nh && l < L ? dt[(bc * L + l) * H + h0 + h] : 0.0f;
  }
  cp_async_wait_all();
  __syncthreads();

  // 2. cum in sequence, one thread a head of the last warp; C B^T on the
  // pairs' causal blocks (blocks 0-4 of a pair by its first warp, 5-8 by
  // its second) into shared memory
  if (warp == kWarps - 1 && lane < nh) {
    const float ah = a[h0 + lane];
    float run = 0.0f;
    bool mono = true;
    float* c = cums + lane * Lp;
    const float* d = dts + lane * Lp;
    for (int l0 = 0; l0 < L; l0 += 8) {    // 8 loads in flight, then the adds
      float dv[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) dv[k] = d[l0 + k];   // within the padded Lp
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        if (l0 + k >= L) break;
        const float da = __fmul_rn(dv[k], ah);
        mono = mono && da <= 0.0f;
        run = l0 + k == 0 ? da : __fadd_rn(run, da);
        c[l0 + k] = run;
      }
    }
    for (int l = L; l < Lp; ++l) c[l] = 0.0f;
    monos[lane] = mono;
  }
  __syncwarp();
  const int ksteps = round_up(N, 8) / 8;
  const int mid = (kSlots + 1) / 2;
#pragma unroll 1
  for (int k = half == 0 ? 0 : mid; k < (half == 0 ? mid : kSlots); ++k) {
    int I, J;
    block_of(pair, k, I, J);
    if (I >= TR) continue;
    float G[2][4] = {};
    const float* ca = cs + (16 * I + g4) * SN + t4;
    const float* cb = cs + (16 * I + g4 + 8) * SN + t4;
    const float* br = bs + (16 * J + g4) * SN + t4;
    for (int kc = 0; kc < ksteps; kc += 2) {
      uint32_t ah[2][4], al[2][4];
      float b0[2][2], b1[2][2];
      const bool two = kc + 1 < ksteps;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int n0 = 8 * (two ? kc + u : kc);
        split_int(ca[n0], ah[u][0], al[u][0]);
        split_int(cb[n0], ah[u][1], al[u][1]);
        split_int(ca[n0 + 4], ah[u][2], al[u][2]);
        split_int(cb[n0 + 4], ah[u][3], al[u][3]);
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          b0[u][n] = br[8 * n * SN + n0];
          b1[u][n] = br[8 * n * SN + n0 + 4];
        }
      }
      if (two) {
        mma3_steps<2, 2, true>(G, ah, al, b0, b1);
      } else {   // an odd last k step
        const uint32_t h1[1][4] = {{ah[0][0], ah[0][1], ah[0][2], ah[0][3]}};
        const uint32_t l1[1][4] = {{al[0][0], al[0][1], al[0][2], al[0][3]}};
        const float c0[1][2] = {{b0[0][0], b0[0][1]}}, c1[1][2] = {{b1[0][0], b1[0][1]}};
        mma3_steps<1, 2, true>(G, h1, l1, c0, c1);
      }
    }
    float4* gk = gs + ((pair * kSlots + k) * 2) * 32 + lane;
    gk[0] = make_float4(G[0][0], G[0][1], G[0][2], G[0][3]);
    gk[32] = make_float4(G[1][0], G[1][1], G[1][2], G[1][3]);
  }
  __syncthreads();   // cum and C B^T are in; C's buffer is free for x

  // 3. cum and the decay out, the state weights
  for (int i = threadIdx.x; i < nh * L; i += kThreads) {
    const int l = i / nh, h = i % nh;
    cum[(bc * L + l) * H + h0 + h] = cums[h * Lp + l];
  }
  for (int i = threadIdx.x; i < kHeads * Lp; i += kThreads) {
    const int h = i / Lp, l = i % Lp;
    wss[i] = h < nh && l < L
                 ? __fmul_rn(expf(__fsub_rn(cums[h * Lp + L - 1], cums[i])), dts[i])
                 : 0.0f;
  }
  if (threadIdx.x < nh) dec[bc * H + h0 + threadIdx.x] = expf(cums[threadIdx.x * Lp + L - 1]);

  // 4. the heads: x in C's place, y = M x on the pair's row tiles, then
  // the state; each warp on its half of the columns. Where a head's cum
  // does not increase (dt a <= 0, as Mamba2's a < 0 and dt > 0 give), W
  // off the diagonal blocks is factored: W[i, j] = exp(cum_i - cum_r)
  // (exp(cum_r - cum_j) dt_j) with r = 16 J + 15 the last step of j's
  // tile, both exponents <= 0 (no overflow), 576 exps a head for 8,256.
  // The diagonal blocks, and every block of a head whose cum increases
  // somewhere, take exp(cum_i - cum_j) directly.
  const int Pp = round_up(P, 8);
  for (int hh = 0; hh < nh; ++hh) {
    if (hh > 0) __syncthreads();   // every warp is done with the last head's x
    stage(xs, SX, xsrc + hh * P, xrow, L, P, Lp, false, vec_x);
    cp_async_commit();
    const float* ch = cums + hh * Lp;
    const float* dh = dts + hh * Lp;
    const float* wh = wss + hh * Lp;
    for (int j = threadIdx.x; j < Lp; j += kThreads) {
      const int r = 16 * (j / 16) + 15 < L - 1 ? 16 * (j / 16) + 15 : L - 1;
      cds[j] = j < L ? __fmul_rn(expf(__fsub_rn(ch[r], ch[j])), dh[j]) : 0.0f;
    }
    for (int e = threadIdx.x; e < geo.row_factors(); e += kThreads) {
      int I = 1;
      while (8 * (I + 1) * I <= e) ++I;     // the row tile of entry e
      const int rest = e - 8 * I * (I - 1);
      const int i = 16 * I + rest / I, J = rest % I;
      rfs[e] = i < L ? expf(__fsub_rn(ch[i], ch[16 * J + 15])) : 0.0f;
    }
    const bool mono = monos[hh] != 0;
    cp_async_wait_all();
    __syncthreads();               // x and the factors visible
    T* yout = y + bc * L * xrow + (h0 + hh) * P;
    float* sout = st + ((bc * H + h0 + hh) * N) * static_cast<int64_t>(P);

    // row tile b (kTiles - 1 - pair) and the first state row tile take the
    // key blocks together, x's fragments of a block split once for both;
    // then row tile a (pair) on its blocks
    const int Ia = pair, Ib = kTiles - 1 - pair, n0 = 16 * pair;
    for (int c0 = 8 * kPT * half; c0 < Pp; c0 += 16 * kPT) {
      float acc[kPT][4] = {}, sa[kPT][4] = {};
#pragma unroll 1
      for (int J = 0; J < TR; ++J) {
        uint32_t bh[2][kPT][2], bl[2][kPT][2], ah[2][4], al[2][4];
        x_split(xs, SX, 16 * J, c0, bh, bl);
        if (J <= Ib && Ib < TR) {
          m_frags(gs + ((pair * kSlots + pair + 1 + J) * 2) * 32 + lane, Ib, J, L, mono, ch, dh,
                  rfs, cds, ah, al);
          mma3_split<2, kPT>(acc, ah, al, bh, bl);
        }
        if (n0 < N) {
          state_frags(bs, SN, wh, 16 * J, n0, ah, al);
          mma3_split<2, kPT>(sa, ah, al, bh, bl);
        }
      }
      if (Ib < TR) store_tile(yout, xrow, 16 * Ib, L, c0, P, acc);
      if (n0 < N) store_tile(sout, P, n0, N, c0, P, sa);
      if (Ia < TR) {
#pragma unroll
        for (int n = 0; n < kPT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
#pragma unroll 1
        for (int J = 0; J <= Ia; ++J) {
          uint32_t bh[2][kPT][2], bl[2][kPT][2], ah[2][4], al[2][4];
          x_split(xs, SX, 16 * J, c0, bh, bl);
          m_frags(gs + ((pair * kSlots + J) * 2) * 32 + lane, Ia, J, L, mono, ch, dh, rfs, cds,
                  ah, al);
          mma3_split<2, kPT>(acc, ah, al, bh, bl);
        }
        store_tile(yout, xrow, 16 * Ia, L, c0, P, acc);
      }

      // the state's further row tiles (N > 16 kPairs), k over the chunk's steps
      for (int n1 = n0 + 16 * kPairs; n1 < N; n1 += 16 * kPairs) {
#pragma unroll
        for (int n = 0; n < kPT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
#pragma unroll 1
        for (int J = 0; J < TR; ++J) {
          uint32_t bh[2][kPT][2], bl[2][kPT][2], ah[2][4], al[2][4];
          x_split(xs, SX, 16 * J, c0, bh, bl);
          state_frags(bs, SN, wh, 16 * J, n1, ah, al);
          mma3_split<2, kPT>(acc, ah, al, bh, bl);
        }
        store_tile(sout, P, n1, N, c0, P, acc);
      }
    }
  }
}

template <typename T>
int launch(const void* xh, const float* bm, const float* cm, const float* dt, const float* a,
           void* y, float* st, float* dec, float* cum, int64_t bc, int64_t L, int64_t H,
           int64_t N, int64_t P, cudaStream_t s) {
  if (L > kMaxL) return static_cast<int>(cudaErrorInvalidValue);
  const Geometry geo(static_cast<int>(L), static_cast<int>(N), static_cast<int>(P),
                     static_cast<int>(sizeof(T)));
  const size_t smem = geo.bytes();
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  static size_t high[kSmemDevices];
  const cudaError_t err = allow_smem(mamba_chunk_kernel<T>, smem, high);
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int kPer = 16 / static_cast<int>(sizeof(T));
  const bool vec_bc =
      N % 4 == 0 && ((reinterpret_cast<uintptr_t>(bm) | reinterpret_cast<uintptr_t>(cm)) & 15) == 0;
  const bool vec_x = P % kPer == 0 && (reinterpret_cast<uintptr_t>(xh) & 15) == 0;
  const int64_t groups = (H + kHeads - 1) / kHeads;
  mamba_chunk_kernel<T><<<static_cast<unsigned>(bc * groups), kThreads, smem, s>>>(
      static_cast<const T*>(xh), bm, cm, dt, a, static_cast<T*>(y), st, dec, cum, H,
      static_cast<int>(L), static_cast<int>(N), static_cast<int>(P), vec_bc, vec_x);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// xh, y: (bc, L, H, P) float32 (bf16 = 0) or bfloat16 (bf16 = 1); bm, cm:
// (bc, L, N); dt, cum: (bc, L, H); a: (H,); st: (bc, H, N, P); dec: (bc, H);
// all contiguous, all but xh and y float32. bc = B * c; L <= 128.
extern "C" int repro_mamba_chunk(const void* xh, const float* bm, const float* cm,
                                 const float* dt, const float* a, void* y, float* st,
                                 float* dec, float* cum, int64_t bc, int64_t L, int64_t H,
                                 int64_t N, int64_t P, int64_t bf16, void* stream) {
  if (bc <= 0 || H <= 0 || L <= 0) return 0;   // N or P 0: zero-width loops
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(xh, bm, cm, dt, a, y, st, dec, cum, bc, L, H, N, P, s)
              : launch<float>(xh, bm, cm, dt, a, y, st, dec, cum, bc, L, H, N, P, s);
}
