// TF32 tensor-core helpers shared by the kernels that run float32
// products on the tensor cores with the 3xTF32 split (flash_attention.cu,
// mamba_scan.cu): the rounding, the split, mma.sync.m16n8k8 with and
// without a fresh accumulator, the split product over a few k steps, and
// the cp.async 16-byte copy. Why the split and the fresh accumulators:
// flash_attention.cu's header; tests/test_torch_tf32_split.py emulates
// them on the CPU.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo, both TF32
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// The same rounding in integer arithmetic: half a TF32 step added to the
// magnitude's bits, the 13 low bits cleared (ties away from zero, as
// cvt.rna; the sign bit is apart). Two integer instructions at the full
// rate, where cvt is a conversion at a quarter of it.
__device__ __forceinline__ uint32_t tf32_int(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}
__device__ __forceinline__ void split_int(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_int(x);
  lo = tf32_int(x - __uint_as_float(hi));
}

// c += a (16 x 8, row) * b (8 x 8, col), TF32 in, float32 accumulate
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = a (16 x 8, row) * b (8 x 8, col), into a fresh accumulator
__device__ __forceinline__ void mma_fresh(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.0f));
}

// c[j] += sum over KS k steps of a_s b_sj, for N outputs j, with the
// 3xTF32 split of a (ah, al) and of b (bh, bl): every small product
// (hi.lo, lo.hi) first, then the hi.hi ones, into a fresh accumulator
// that is added to c by a round-to-nearest float32 add. (The tensor
// cores' own float32 sums truncate; over a long chain of steps into one
// accumulator that drifts past the tolerance.) Phase by phase, so that
// N independent products stand between two dependent ones.
template <int KS, int N>
__device__ __forceinline__ void mma3_split(float (&c)[N][4], const uint32_t (&ah)[KS][4],
                                           const uint32_t (&al)[KS][4],
                                           const uint32_t (&bh)[KS][N][2],
                                           const uint32_t (&bl)[KS][N][2]) {
  float t[N][4];
#pragma unroll
  for (int j = 0; j < N; ++j) mma_fresh(t[j], ah[0], bl[0][j][0], bl[0][j][1]);
#pragma unroll
  for (int s = 0; s < KS; ++s) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      if (s > 0) mma(t[j], ah[s], bl[s][j][0], bl[s][j][1]);
      mma(t[j], al[s], bh[s][j][0], bh[s][j][1]);
    }
  }
#pragma unroll
  for (int s = 0; s < KS; ++s) {
#pragma unroll
    for (int j = 0; j < N; ++j) mma(t[j], ah[s], bh[s][j][0], bh[s][j][1]);
  }
#pragma unroll
  for (int j = 0; j < N; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) c[j][i] += t[j][i];
  }
}

// mma3_split with b given as floats and split here (b0: k rows t, b1: k
// rows t + 4 of each step); kInt: by split_int (else by cvt.rna).
template <int KS, int N, bool kInt = false>
__device__ __forceinline__ void mma3_steps(float (&c)[N][4], const uint32_t (&ah)[KS][4],
                                           const uint32_t (&al)[KS][4], const float (&b0)[KS][N],
                                           const float (&b1)[KS][N]) {
  uint32_t bh[KS][N][2], bl[KS][N][2];
#pragma unroll
  for (int s = 0; s < KS; ++s) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      if (kInt) {
        split_int(b0[s][j], bh[s][j][0], bl[s][j][0]);
        split_int(b1[s][j], bh[s][j][1], bl[s][j][1]);
      } else {
        split(b0[s][j], bh[s][j][0], bl[s][j][0]);
        split(b1[s][j], bh[s][j][1], bl[s][j][1]);
      }
    }
  }
  mma3_split<KS, N>(c, ah, al, bh, bl);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

}  // namespace
