// Fused in-place optimizer updates over the packed (G, N) float32 buffers
// of the local-SGD round (DESIGN.md §6), one launch per local step.
//
// Replaces the TPU Pallas kernels
//   src/repro/kernels/fused_sgd.py       fused_sgd       p <- p - lr*g
//   src/repro/kernels/fused_momentum.py  fused_momentum  mu <- beta*mu + g;
//                                                        p <- p - lr*mu
//   src/repro/kernels/fused_adamw.py     fused_adamw     m, v moments,
//                                        bias-corrected step, decoupled wd
//
// Bound on an H100: HBM bytes. Per element sgd reads p, g and writes p
// (12 bytes), momentum moves 20 bytes and adamw 28 bytes, against 2-15
// flops, so G*N*bytes / 3.35 TB/s is the floor (about 1.8, 3.0 and
// 4.2 ms at G=4 on paper-lenet's N = 124,662,528).
//
// Design of fused_sgd (redesigned for the H100): flattened over the active
// rows only. Each row's float4 body is cut into strips of kStrip float4s
// (one a thread of a 128-thread block) and the strips of the active rows
// are numbered in row order; block b takes strips b, b + grid, ... and
// maps each through a prefix count of the active mask, which every block
// reads on the device (a count at the start, then a cursor that walks the
// rows once), so the host never reads the mask. The grid: with no mask,
// one block a strip of every row; with a mask (a step of the per-group
// T_i schedule), one row's strips, so block b takes strip b of each active
// row in turn, and one active row of four still spreads over every SM
// (the first grid left 3/4 of its blocks to exit at once, and took twice
// p.add_'s time on that row; an all-true mask costs 1% over no mask).
// The first strip of a row also takes its ragged head and tail.
// Measured on the H100 against the alternatives (PERF.md): a
// resident grid that walks the strips (with 1-4 float4 loads of p and g in
// flight a thread) was 6-8% slower than one strip a block, streaming
// (evict-first) loads and stores 2% slower than the default policy, and a
// TMA bulk-copy pipeline through shared memory 5% slower; two float4 a
// thread gained nothing over one. tests/test_torch_kernel_layouts.py mirrors
// this split.
//
// Design of momentum and adamw: each byte moves once. One block row per
// buffer row (blockIdx.y), a grid-stride loop over 16-byte float4 loads
// and stores on the row's aligned body, and at most 3 + 3 scalar elements
// at the row's ragged head and tail. The row picks its bias-correction
// pair bc[r] and its active flag: a row that is not active is left
// untouched, moments included (the per-group t_i mask), and its blocks
// exit before any load. Scalars come by value; bc stays on the device, so
// the step count never goes through the host.
//
// All three: offsets are 64-bit (G*N passes 2^31), and updates are written
// with explicit round-to-nearest intrinsics in the reference's order, so
// nvcc contracts nothing into an FMA and the result equals the plain
// PyTorch version bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// Elements before a row's first 16-byte boundary (0..3). The wrapper
// checks that every buffer of a launch shares one alignment, so the
// split is the same for p, g and the moments.
__device__ __forceinline__ int64_t head_len(const float* row, int64_t n) {
  const int64_t mis = (reinterpret_cast<uintptr_t>(row) >> 2) & 3;
  const int64_t h = (4 - mis) & 3;
  return h < n ? h : n;
}

__device__ __forceinline__ float4 ld4(const float* x, int64_t i) {
  return *reinterpret_cast<const float4*>(x + i);
}

__device__ __forceinline__ void st4(float* x, int64_t i, float4 v) {
  *reinterpret_cast<float4*>(x + i) = v;
}

__device__ __forceinline__ float sgd_upd(float p, float g, float lr) {
  return __fsub_rn(p, __fmul_rn(lr, g));
}

struct Momentum {
  float* p;
  const float* g;
  float* mu;
  float lr, beta;

  __device__ __forceinline__ void upd(float& p_, float g_, float& mu_) const {
    mu_ = __fadd_rn(__fmul_rn(beta, mu_), g_);
    p_ = __fsub_rn(p_, __fmul_rn(lr, mu_));
  }
  __device__ __forceinline__ void one(int64_t, int64_t i) const {
    float p_ = p[i], mu_ = mu[i];
    upd(p_, g[i], mu_);
    p[i] = p_;
    mu[i] = mu_;
  }
  __device__ __forceinline__ void four(int64_t, int64_t i) const {
    float4 a = ld4(p, i), c = ld4(mu, i);
    const float4 b = ld4(g, i);
    upd(a.x, b.x, c.x);
    upd(a.y, b.y, c.y);
    upd(a.z, b.z, c.z);
    upd(a.w, b.w, c.w);
    st4(p, i, a);
    st4(mu, i, c);
  }
};

struct AdamW {
  float* p;
  const float* g;
  float* m;
  float* v;
  const float* bc;  // (rows, 2): 1 - b1^count, 1 - b2^count per row
  float lr, b1, omb1, b2, omb2, eps, wd;

  // (m/bc1) / (sqrt(v/bc2) + eps), then p - lr*(upd + wd*p): the order of
  // src/repro/kernels/fused_adamw.py, each operation rounded on its own
  __device__ __forceinline__ void upd(float& p_, float g_, float& m_, float& v_,
                                      float bc1, float bc2) const {
    m_ = __fadd_rn(__fmul_rn(b1, m_), __fmul_rn(omb1, g_));
    v_ = __fadd_rn(__fmul_rn(b2, v_), __fmul_rn(__fmul_rn(omb2, g_), g_));
    const float u = __fdiv_rn(__fdiv_rn(m_, bc1),
                              __fadd_rn(__fsqrt_rn(__fdiv_rn(v_, bc2)), eps));
    p_ = __fsub_rn(p_, __fmul_rn(lr, __fadd_rn(u, __fmul_rn(wd, p_))));
  }
  __device__ __forceinline__ void one(int64_t r, int64_t i) const {
    float p_ = p[i], m_ = m[i], v_ = v[i];
    upd(p_, g[i], m_, v_, bc[2 * r], bc[2 * r + 1]);
    p[i] = p_;
    m[i] = m_;
    v[i] = v_;
  }
  __device__ __forceinline__ void four(int64_t r, int64_t i) const {
    const float bc1 = bc[2 * r], bc2 = bc[2 * r + 1];
    float4 a = ld4(p, i), c = ld4(m, i), d = ld4(v, i);
    const float4 b = ld4(g, i);
    upd(a.x, b.x, c.x, d.x, bc1, bc2);
    upd(a.y, b.y, c.y, d.y, bc1, bc2);
    upd(a.z, b.z, c.z, d.z, bc1, bc2);
    upd(a.w, b.w, c.w, d.w, bc1, bc2);
    st4(p, i, a);
    st4(m, i, c);
    st4(v, i, d);
  }
};

template <class Op>
__global__ void __launch_bounds__(kThreads)
update_rows(Op op, const uint8_t* __restrict__ active, int64_t n) {
  const int64_t r = blockIdx.y;
  if (active != nullptr && active[r] == 0) return;
  const int64_t base = r * n;
  const int64_t head = head_len(op.p + base, n);
  const int64_t nvec = (n - head) >> 2;
  const int64_t body = base + head;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t k = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       k < nvec; k += stride) {
    op.four(r, body + 4 * k);
  }
  // ragged edges: threads 0-3 take the head, threads 4-7 the tail
  if (blockIdx.x == 0 && threadIdx.x < 8) {
    const int64_t t = threadIdx.x;
    const int64_t j = t < 4 ? t : head + 4 * nvec + (t - 4);
    if (t < 4 ? t < head : j < n) op.one(r, base + j);
  }
}

constexpr int kSgdThreads = 128;                      // threads of an sgd block
constexpr int64_t kStrip = kSgdThreads;                // float4s a strip: one a thread
constexpr int64_t kMaxGrid = 0x7fffffff;               // gridDim.x

// Strips of one row: a row holds at most n / 4 float4s past its head; at
// least one strip, which takes the ragged head and tail.
__host__ __device__ __forceinline__ int64_t strips_per_row(int64_t n) {
  const int64_t s = (n / 4 + kStrip - 1) / kStrip;
  return s > 0 ? s : 1;
}

__global__ void __launch_bounds__(kSgdThreads)
sgd_strips(float* __restrict__ p, const float* __restrict__ g,
           const uint8_t* __restrict__ active, int64_t rows, int64_t n, float lr) {
  int64_t n_act = rows;
  if (active != nullptr) {
    n_act = 0;
    for (int64_t r0 = 0; r0 < rows; r0 += kSgdThreads) {
      const int64_t r = r0 + threadIdx.x;
      n_act += __syncthreads_count(r < rows && active[r] != 0);
    }
  }
  const int64_t per_row = strips_per_row(n);
  const int64_t total = n_act * per_row;
  int64_t j = -1, r = -1;  // the cursor: the j-th active row is row r
  for (int64_t s = blockIdx.x; s < total; s += gridDim.x) {
    const int64_t want = s / per_row;
    while (j < want) {
      ++r;
      if (active == nullptr || active[r] != 0) ++j;
    }
    const int64_t base = r * n;
    const int64_t head = head_len(p + base, n);
    const int64_t nvec = (n - head) >> 2;
    const int64_t c = s - want * per_row;
    const int64_t k = c * kStrip + threadIdx.x;  // this thread's float4 of the row's body
    if (k < nvec) {
      float4* pk = reinterpret_cast<float4*>(p + base + head) + k;
      float4 a = *pk;
      const float4 b = *(reinterpret_cast<const float4*>(g + base + head) + k);
      a.x = sgd_upd(a.x, b.x, lr);
      a.y = sgd_upd(a.y, b.y, lr);
      a.z = sgd_upd(a.z, b.z, lr);
      a.w = sgd_upd(a.w, b.w, lr);
      *pk = a;
    }
    // ragged edges: threads 0-3 take the head, threads 4-7 the tail
    if (c == 0 && threadIdx.x < 8) {
      const int64_t t = threadIdx.x;
      const int64_t e = t < 4 ? t : head + 4 * nvec + (t - 4);
      if (t < 4 ? t < head : e < n) p[base + e] = sgd_upd(p[base + e], g[base + e], lr);
    }
  }
}

template <class Op>
int launch(const Op& op, const uint8_t* active, int64_t rows, int64_t n,
           int64_t blocks, void* stream) {
  if (rows <= 0 || n <= 0) return 0;
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(rows));
  update_rows<Op><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      op, active, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// active: (rows,) bool or NULL (every row).
extern "C" int repro_fused_sgd(float* p, const float* g, const uint8_t* active,
                               int64_t rows, int64_t n, void* stream, float lr) {
  if (rows <= 0 || n <= 0) return 0;
  // no mask: one block a strip of every row; a mask: one row's strips,
  // each block walking the active rows
  const int64_t work = (active == nullptr ? rows : 1) * strips_per_row(n);
  sgd_strips<<<static_cast<unsigned>(work < kMaxGrid ? work : kMaxGrid), kSgdThreads, 0,
               static_cast<cudaStream_t>(stream)>>>(p, g, active, rows, n, lr);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_fused_momentum(float* p, const float* g, float* mu,
                                    const uint8_t* active, int64_t rows,
                                    int64_t n, int64_t blocks, void* stream,
                                    float lr, float beta) {
  return launch(Momentum{p, g, mu, lr, beta}, active, rows, n, blocks, stream);
}

extern "C" int repro_fused_adamw(float* p, const float* g, float* m, float* v,
                                 const float* bc, const uint8_t* active,
                                 int64_t rows, int64_t n, int64_t blocks,
                                 void* stream, float lr, float b1, float omb1,
                                 float b2, float omb2, float eps, float wd) {
  return launch(AdamW{p, g, m, v, bc, lr, b1, omb1, b2, omb2, eps, wd}, active,
                rows, n, blocks, stream);
}
