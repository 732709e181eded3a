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
// ratio. paper-lenet at B = 8 and ~860 live tokens a slot moves ~42 MB per
// layer call, ~13 us at 3.35 TB/s.
//
// Design (redesigned for the H100). The TPU walks a slot's pages in order
// on one core; here each slot's pages are cut into spans of `pps` pages
// (the wrapper picks pps from the page-table width and the grid, never
// from the lengths, so the host reads nothing of the device), and the grid
// is (n_kv * head splits, B, spans): a block takes one span of one slot for
// the query heads of one KV head (or of a part of one, below). It reads its
// span's page-table entries once into shared memory, together with its
// slot's length (one round trip, not two); a span wholly past the length
// reads no K or V and gives the empty partial (m = -1e30, l = 0, acc = 0).
// In a live span the 4 warps take its tokens t < length in turn (the
// reference's pl.when skip becomes the loop bound: no token at or past the
// length is read). A token's K (and V) slice for this KV head is hd
// contiguous floats of its page row (token-major (page_size, n_kv, hd));
// LPT lanes (hd / 4 rounded up to a power of two, at least 2) hold it as
// one float4 each, so a warp reads 32 / LPT tokens in one 16-byte load a
// lane. Each lane loads U tokens' K and V before it computes any of them,
// and each lane group runs its own online softmax (m, l, acc in registers,
// one max and one rescale per U tokens). Where the group has a lane for
// each of the chunk's GB * U (head, token) scores (paper-lenet's g 1 at hd
// 64, qwen3-32b's g 8 at hd 128), the scores are reduced transposed: each
// halving step a lane keeps half of its partial dots and adds its
// partner's other half, so a lane ends with one whole score, takes its
// exps alone, and the probabilities reach the group by one shuffle each
// (2 exps and about 2 GB U shuffles a lane, against GB U log2 LPT
// shuffles and GB (U + 1) exps when each score is a full shuffle sum,
// which the narrow groups keep). At the end of the span the lane groups of
// a warp are merged by shuffles, the warps in shared memory, in a fixed
// order: acc and l scaled by exp(m_w - max m) and summed. Spans are as
// long as keep about four blocks an SM in flight (one wave: 224 tokens at
// paper-lenet's step, 512 at qwen3-32b's, measured fastest; PERF.md).
//
// Merge, in the same launch: a block writes its span's (m, l, acc) to a
// scratch of partials and, after a __threadfence, takes an integer ticket
// of its (slot, head group); the block that draws the last ticket reads the
// S partials from L2 in span order, scales them by exp(m_s - max m), sums
// them, divides (l clamped at 1e-30, as in the reference) and resets the
// ticket for the next call (csrc/sq_norm.cu's pattern). A warp a head
// forms max m and the scaled sum of l (lane j over spans j, j + 32, ...,
// then a butterfly); a thread a (head, dim) sums acc in span order, its
// loads unrolled so that several are in flight. So the result does
// not depend on which block finishes last, and a rerun gives the same bits.
// An empty partial's m is the finite -1e30, so exp(m_s - max m) is 0 and
// never a NaN, even where every span but the first is empty. With one span
// (S = 1) the block writes the output itself. The wrapper allocates the
// partials and tickets once per (device, stream, size) and keeps them.
//
// Pool offsets are 64-bit (row * page_elems overflows int32 at the pool
// sizes of larger models). Inactive slots point at trash row 0 with length
// 1 and compute finite garbage that nothing reads. q and the output are
// float32 here; the wrapper converts a bfloat16 query and result.
//
// Geometries: any hd up to 128 and any g from 1 to 16. Where hd is a
// multiple of 4 and the pool rows are 16-byte aligned a lane holds a float4
// (dims 4 * l .. 4 * l + 3 of its group's token); otherwise 32 lanes a
// token hold dims l, l + 32, l + 64, l + 96 as scalars. Lanes past hd are
// masked. A block takes GB = 1, 2, 4 or 8 query heads; a KV head with more
// than 8 is split over ceil(g / 8) blocks of ceil(g / splits) heads each
// (masked at run time where that is fewer than GB: g 3 runs as 3 of 4, g 6
// as 6 of 8, g 16 as two blocks of 8 over the same K and V). Shared memory
// is static (at most ~18 KB), so no launch sets an attribute.
// tests/test_torch_kernel_layouts.py mirrors the token split and the merge.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxHd = 128;
constexpr int kMaxG = 16;
constexpr int kMaxGB = 8;           // query heads a block
constexpr int kMaxSpanPages = 128;  // page-table entries a span
constexpr int kElems = 4;           // elements of a token a lane holds
constexpr float kNegInf = -1e30f;

// The transposed reduction's halving steps over a group of LPT lanes, from
// C values a lane down to one: at offset o = LPT C / (2 NP) a lane keeps
// the half of its C values that its bit o selects and adds the other half
// of its partner's.
template <int C, int NP, int LPT>
__device__ __forceinline__ void halve(float (&v)[NP], int lane) {
  if constexpr (C > 1) {
    constexpr int half = C / 2, o = LPT * C / (2 * NP);
    const bool upper = (lane & o) != 0;
#pragma unroll
    for (int i = 0; i < half; ++i) {
      const float send = upper ? v[i] : v[i + half];
      const float keep = upper ? v[i + half] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
    }
    halve<half, NP, LPT>(v, lane);
  }
}

// LPT: lanes a token; VEC: a lane's elements are one float4 (dims 4s ..
// 4s + 3 of lane s of its group), else scalars at dims s, s + 32, s + 64,
// s + 96 (LPT 32); GB: query heads a block.
template <int LPT, bool VEC, int GB>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const float* __restrict__ q, const float* __restrict__ pool,
                    const int* __restrict__ rows_k, const int* __restrict__ rows_v,
                    const int* __restrict__ lengths, float* __restrict__ out,
                    float* __restrict__ part_ml, float* __restrict__ part_acc,
                    unsigned* __restrict__ tickets, int64_t n_kv, int g, int hd, int splits,
                    int per, int64_t ps, int64_t nblk, int64_t page_elems, int pps,
                    float scale) {
  constexpr int TPW = 32 / LPT;            // tokens a warp holds at once
  constexpr int U = GB <= 2 ? 8 : 4;       // tokens in flight a lane
  constexpr int W = kElems * LPT;          // dims a lane group covers
  constexpr int kStep = kWarps * TPW;      // tokens between a lane's tokens
  // where a lane group has a lane for each (head, token) pair of a chunk:
  // the transposed reduction (below)
  constexpr int NP = GB * U;               // (head, token) pairs of a chunk
  constexpr bool kT = NP <= LPT;
  constexpr int R = kT ? LPT / NP : 1;     // lanes that hold one pair's score
  __shared__ int tk[kMaxSpanPages], tv[kMaxSpanPages];
  __shared__ float wpart[kWarps][GB][2 + W];   // m, l, acc of each warp
  __shared__ bool last;
  __shared__ float mmax[GB], lden[GB];         // the merge's max m and sum of l

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int sub = lane % LPT, slot = lane / LPT;
  const int64_t grp = blockIdx.x, b = blockIdx.y;
  const int64_t kh = grp / splits;
  const int h0 = static_cast<int>(grp % splits) * per;
  const int nh = per < g - h0 ? per : g - h0;  // this block's heads, <= GB
  const int s = blockIdx.z, S = gridDim.z;
  const int64_t p0 = static_cast<int64_t>(s) * pps;   // the span's first page
  // the span's page-table entries and the slot's length, loaded together
  // (no token is read from a page past the length)
  const int64_t np = nblk - p0 < pps ? nblk - p0 : pps;
  for (int64_t i = threadIdx.x; i < np; i += kThreads) {
    tk[i] = rows_k[b * nblk + p0 + i];
    tv[i] = rows_v[b * nblk + p0 + i];
  }
  int64_t len = lengths[b];
  if (len > nblk * ps) len = nblk * ps;
  const int64_t t0 = p0 * ps;
  const int64_t t1 = len < t0 + pps * ps ? len : t0 + pps * ps;  // live [t0, t1)
  // heads kh*g + h0 .. kh*g + h0 + nh - 1 of slot b
  const int64_t head0 = ((b * n_kv + kh) * g + h0) * hd;

  float acc[GB][kElems], m[GB], l[GB], qr[GB][kElems];
#pragma unroll
  for (int h = 0; h < GB; ++h) {
    m[h] = kNegInf;
    l[h] = 0.0f;
#pragma unroll
    for (int e = 0; e < kElems; ++e) {
      const int d = VEC ? kElems * sub + e : sub + 32 * e;
      acc[h][e] = 0.0f;
      qr[h][e] = t0 < t1 && h < nh && d < hd ? q[head0 + h * hd + d] : 0.0f;
    }
  }
  float m_own = kNegInf, l_own = 0.0f;      // kT: of this lane's head
  __syncthreads();
  if (t0 < t1) {
    // live tokens lie below the int32 lengths: 32-bit token arithmetic
    const int it0 = static_cast<int>(t0), it1 = static_cast<int>(t1);
    const int ips = static_cast<int>(ps);
    const int64_t tok_stride = n_kv * hd;
    for (int tw = it0 + warp * TPW; tw < it1; tw += U * kStep) {
      float kr[U][kElems], vr[U][kElems];
      bool live[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int t = tw + slot + u * kStep;
        live[u] = t < it1;
        const int lp = live[u] ? (t - it0) / ips : 0;   // page within the span
        const int64_t off = static_cast<int64_t>(t - it0 - lp * ips) * tok_stride + kh * hd;
        const float* kp = pool + (live[u] ? static_cast<int64_t>(tk[lp]) * page_elems + off : 0);
        const float* vp = pool + (live[u] ? static_cast<int64_t>(tv[lp]) * page_elems + off : 0);
        if (VEC) {
          const bool in = live[u] && kElems * sub < hd;
          const float4 kv = in ? reinterpret_cast<const float4*>(kp)[sub]
                               : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          const float4 vv = in ? reinterpret_cast<const float4*>(vp)[sub]
                               : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          kr[u][0] = kv.x; kr[u][1] = kv.y; kr[u][2] = kv.z; kr[u][3] = kv.w;
          vr[u][0] = vv.x; vr[u][1] = vv.y; vr[u][2] = vv.z; vr[u][3] = vv.w;
        } else {
#pragma unroll
          for (int e = 0; e < kElems; ++e) {
            const int d = sub + 32 * e;
            kr[u][e] = live[u] && d < hd ? kp[d] : 0.0f;
            vr[u][e] = live[u] && d < hd ? vp[d] : 0.0f;
          }
        }
      }
      if constexpr (kT) {
        // each lane's partial dots of the NP (head, token) pairs, reduced
        // over its lane group by halving: at offset o a lane keeps the half
        // its bit o selects and adds its partner's, so after log2 NP steps
        // it holds one pair's score (pair = sub / R), the max and the sum
        // of a head run over the U lanes of its pairs, and the
        // probabilities reach every lane of the group by one shuffle a
        // pair: about 2 NP + GB shuffles and 2 exps a lane for a chunk,
        // where the loop below takes NP log2(LPT) shuffles and NP + GB
        // exps.
        float v[NP];
#pragma unroll
        for (int h = 0; h < GB; ++h) {
#pragma unroll
          for (int u = 0; u < U; ++u) {
            float x = 0.0f;
#pragma unroll
            for (int e = 0; e < kElems; ++e) x += qr[h][e] * kr[u][e];
            v[h * U + u] = x;
          }
        }
        halve<NP, NP, LPT>(v, lane);
#pragma unroll
        for (int o = R / 2; o > 0; o >>= 1) v[0] += __shfl_xor_sync(0xffffffffu, v[0], o);
        const bool lv = tw + slot + ((sub / R) % U) * kStep < it1;
        const float sc = lv ? v[0] * scale : kNegInf;
        float mx = sc;
#pragma unroll
        for (int o = R; o < R * U; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        mx = fmaxf(mx, m_own);
        const float corr = expf(m_own - mx);
        const float p = lv ? expf(sc - mx) : 0.0f;
        float psum = p;
#pragma unroll
        for (int o = R; o < R * U; o <<= 1) psum += __shfl_xor_sync(0xffffffffu, psum, o);
        l_own = l_own * corr + psum;
        m_own = mx;
#pragma unroll
        for (int h = 0; h < GB; ++h) {
          if (h >= nh) break;
          const float ch = __shfl_sync(0xffffffffu, corr, h * U * R, LPT);
#pragma unroll
          for (int e = 0; e < kElems; ++e) acc[h][e] *= ch;
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const float pu = __shfl_sync(0xffffffffu, p, (h * U + u) * R, LPT);
#pragma unroll
            for (int e = 0; e < kElems; ++e) acc[h][e] += pu * vr[u][e];
          }
        }
        continue;
      }
#pragma unroll
      for (int h = 0; h < GB; ++h) {
        if (h >= nh) break;
        float sc[U];
        float mx = m[h];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          float x = 0.0f;
#pragma unroll
          for (int e = 0; e < kElems; ++e) x += qr[h][e] * kr[u][e];
#pragma unroll
          for (int o = LPT / 2; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
          sc[u] = live[u] ? x * scale : kNegInf;
          mx = fmaxf(mx, sc[u]);
        }
        const float corr = expf(m[h] - mx);
        float psum = 0.0f;
#pragma unroll
        for (int e = 0; e < kElems; ++e) acc[h][e] *= corr;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const float p = live[u] ? expf(sc[u] - mx) : 0.0f;
          psum += p;
#pragma unroll
          for (int e = 0; e < kElems; ++e) acc[h][e] += p * vr[u][e];
        }
        l[h] = l[h] * corr + psum;
        m[h] = mx;
      }
    }

    if constexpr (kT) {                     // every lane takes each head's m, l
#pragma unroll
      for (int h = 0; h < GB; ++h) {
        m[h] = __shfl_sync(0xffffffffu, m_own, h * U * R, LPT);
        l[h] = __shfl_sync(0xffffffffu, l_own, h * U * R, LPT);
      }
    }
    // the lane groups of the warp (same sub, slots 0 .. TPW - 1), by shuffles
#pragma unroll
    for (int h = 0; h < GB; ++h) {
      if (h >= nh) break;
#pragma unroll
      for (int o = LPT; o < 32; o <<= 1) {
        const float mo = __shfl_xor_sync(0xffffffffu, m[h], o);
        const float lo = __shfl_xor_sync(0xffffffffu, l[h], o);
        const float mx = fmaxf(m[h], mo);
        const float ca = expf(m[h] - mx), cb = expf(mo - mx);
        l[h] = l[h] * ca + lo * cb;
#pragma unroll
        for (int e = 0; e < kElems; ++e) {
          const float ao = __shfl_xor_sync(0xffffffffu, acc[h][e], o);
          acc[h][e] = acc[h][e] * ca + ao * cb;
        }
        m[h] = mx;
      }
    }
  }

  // the warps, in shared memory, in warp order
  if (slot == 0) {
#pragma unroll
    for (int h = 0; h < GB; ++h) {
      if (h >= nh) break;
      if (sub == 0) {
        wpart[warp][h][0] = m[h];
        wpart[warp][h][1] = l[h];
      }
#pragma unroll
      for (int e = 0; e < kElems; ++e) {
        wpart[warp][h][2 + (VEC ? kElems * sub + e : sub + 32 * e)] = acc[h][e];
      }
    }
  }
  __syncthreads();
  const int64_t row0 = head0 / hd;          // (b * H + head) of head h0
  for (int idx = threadIdx.x; idx < nh * hd; idx += kThreads) {
    const int h = idx / hd, d = idx % hd;
    float mx = kNegInf;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, wpart[w][h][0]);
    float lsum = 0.0f, a = 0.0f;
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(wpart[w][h][0] - mx);
      lsum += wpart[w][h][1] * c;
      a += wpart[w][h][2 + d] * c;
    }
    if (S == 1) {
      out[head0 + idx] = a / fmaxf(lsum, 1e-30f);
    } else {
      const int64_t r = (row0 + h) * S + s;
      part_acc[r * hd + d] = a;
      if (d == 0) {
        part_ml[2 * r] = mx;
        part_ml[2 * r + 1] = lsum;
      }
    }
  }
  if (S == 1) return;

  // the last block of the (slot, head group) merges the S partials
  __threadfence();  // the partials are visible before the ticket is drawn
  __syncthreads();
  unsigned* ticket = tickets + b * gridDim.x + grp;
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == static_cast<unsigned>(S - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  // a warp a head: lane j takes spans j, j + 32, ... in order (their max,
  // then their l scaled to it and summed), then a butterfly over the lanes
  for (int h = warp; h < nh; h += kWarps) {
    const float* ml = part_ml + 2 * (row0 + h) * S;
    float mx = kNegInf;
    for (int k = lane; k < S; k += 32) mx = fmaxf(mx, __ldcg(ml + 2 * k));
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float ls = 0.0f;
    for (int k = lane; k < S; k += 32) ls += __ldcg(ml + 2 * k + 1) * expf(__ldcg(ml + 2 * k) - mx);
    for (int o = 16; o > 0; o >>= 1) ls += __shfl_xor_sync(0xffffffffu, ls, o);
    if (lane == 0) {
      mmax[h] = mx;
      lden[h] = ls;
    }
  }
  __syncthreads();
  // a thread a (head, dim): the spans' acc scaled and summed in span order
  for (int idx = threadIdx.x; idx < nh * hd; idx += kThreads) {
    const int h = idx / hd, d = idx % hd;
    const float* ml = part_ml + 2 * (row0 + h) * S;
    const float* pa = part_acc + (row0 + h) * S * hd + d;
    const float mx = mmax[h];
    float a = 0.0f;
#pragma unroll 8
    for (int k = 0; k < S; ++k) a += __ldcg(pa + k * hd) * expf(__ldcg(ml + 2 * k) - mx);
    out[head0 + idx] = a / fmaxf(lden[h], 1e-30f);
  }
  if (threadIdx.x == 0) *ticket = 0;
}

struct Args {
  const float* q;
  const float* pool;
  const int* rows_k;
  const int* rows_v;
  const int* lengths;
  float* out;
  float* part_ml;
  float* part_acc;
  unsigned* tickets;
  int64_t n_kv;
  int g, hd, splits, per;
  int64_t ps, nblk, page_elems;
  int pps;
  float scale;
};

template <int LPT, bool VEC, int GB>
int launch(const Args& a, dim3 grid, cudaStream_t stream) {
  paged_decode_kernel<LPT, VEC, GB><<<grid, kThreads, 0, stream>>>(
      a.q, a.pool, a.rows_k, a.rows_v, a.lengths, a.out, a.part_ml, a.part_acc, a.tickets,
      a.n_kv, a.g, a.hd, a.splits, a.per, a.ps, a.nblk, a.page_elems, a.pps, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <int LPT, bool VEC>
int launch_gb(const Args& a, dim3 grid, cudaStream_t s) {
#define REPRO_GB(GB) \
  if (a.per <= GB) return launch<LPT, VEC, GB>(a, grid, s);
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
// 1 <= hd <= 128, 1 <= g <= 16; pps: pages a span, 1 to 128, and S =
// max(1, ceil(nblk / pps)) spans; with S > 1, partials: B * n_kv * g * S * (hd + 2)
// floats of scratch and tickets: B * n_kv * ceil(g / 8) unsigned, zero
// between calls (the kernel leaves them so); with S = 1 neither is read.
// scale: 1/sqrt(hd) as the caller rounded it.
extern "C" int repro_paged_decode_attention(const float* q, const float* pool,
                                            const int* rows_k, const int* rows_v,
                                            const int* lengths, float* out, float* partials,
                                            unsigned* tickets, int64_t B, int64_t n_kv,
                                            int64_t g, int64_t hd, int64_t ps, int64_t nblk,
                                            int64_t page_elems, int64_t pps, void* stream,
                                            float scale) {
  if (B <= 0) return 0;
  if (hd < 1 || hd > kMaxHd || g < 1 || g > kMaxG || pps < 1 || pps > kMaxSpanPages ||
      nblk < 0 || ps < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t S = nblk > pps ? (nblk + pps - 1) / pps : 1;
  if (B > 65535 || S > 65535) return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.q = q;
  a.pool = pool;
  a.rows_k = rows_k;
  a.rows_v = rows_v;
  a.lengths = lengths;
  a.out = out;
  a.part_ml = partials;
  a.part_acc = partials + 2 * B * n_kv * g * S;
  a.tickets = tickets;
  a.n_kv = n_kv;
  a.g = static_cast<int>(g);
  a.hd = static_cast<int>(hd);
  a.splits = static_cast<int>((g + kMaxGB - 1) / kMaxGB);
  a.per = static_cast<int>((g + a.splits - 1) / a.splits);
  a.ps = ps;
  a.nblk = nblk;
  a.page_elems = page_elems;
  a.pps = static_cast<int>(pps);
  a.scale = scale;
  const dim3 grid(static_cast<unsigned>(n_kv * a.splits), static_cast<unsigned>(B),
                  static_cast<unsigned>(S));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = hd % 4 == 0 && page_elems % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(pool) & 15) == 0;
  if (!vec) return launch_gb<32, false>(a, grid, s);
  const int64_t nv = hd / 4;      // float4s a token
  if (nv <= 2) return launch_gb<2, true>(a, grid, s);
  if (nv <= 4) return launch_gb<4, true>(a, grid, s);
  if (nv <= 8) return launch_gb<8, true>(a, grid, s);
  if (nv <= 16) return launch_gb<16, true>(a, grid, s);
  return launch_gb<32, true>(a, grid, s);
}
