// Symmetric int8 coarse ASH scan kernels for Hopper (sm_90a): the first
// pass of the coarse -> refine plans.
//
// Replaces (src/repro/kernels/ash_score.py):
//   ash_coarse_kernel      <- ash_score_coarse_pallas      (integer scan +
//                                                           Eq. 20 epilogue
//                                                           + metric tail)
//   ash_coarse_topk_kernel <- ash_score_coarse_topk_pallas (same scan +
//                                                           running top-k~
//                                                           per span)
//
// What bounds it on the H100: bytes.  A row is 32 bytes of packed b = 2
// codes and 12 of headers, against 2*m*d_pad integer operations (2048 at
// m = 8, d_pad = 128); the materializing kernel also writes 4*m bytes of
// scores.  At the card's 1,979 TOP/s int8 rate the operations would take
// a fraction of the time the bytes take.  Without the tensor cores the
// scan runs on the integer pipes: dp4a does four int8 products per
// instruction, so the operations still stay below the bytes.
//
// What the design does about it:
//   * codes stay packed; each thread unpacks its own row in registers
//     and packs four grid values (2l - (2^b - 1), within int8 for
//     b <= 4) into one word for __dp4a against four int8 query values;
//     b = 8 (values up to +-255) takes plain int32 multiply-adds;
//   * the MT queries of a block sit in shared memory as packed int8
//     quadruples laid out [k/4][MT], read as two 16-byte broadcasts;
//   * the accumulation is integer and exact (every partial sum is below
//     2^24), so it equals the plain version's fp32 product of the same
//     integers in any order, and the epilogue keeps the reference's
//     order with unfused ops: dotc = acc * q_scale, biasq = bias +
//     q_corr, dotc * scale + biasq + offset, then the metric tail; the
//     kernel equals its plain version bit for bit;
//   * the fused kernel shares the dense kernel's selection
//     (ash_select.cuh): spans of 512-row tiles, a running top-L of 64-bit
//     (score desc, row asc) keys behind a bound, one warp per query, one
//     runtime int32 row-validity mask operand, and the key strip merged
//     on the card by ash_topk_merge_kernel (ash_select.cu).
//
// Each C entry point launches on the given stream and returns
// cudaGetLastError() so the wrapper can refuse a launch that failed.

#include "ash_select.cuh"

namespace {

constexpr int SCORE_THREADS = 256;  // rows per materializing block

struct CoarseQ {
  const int8_t* q_int8;  // (m, d_pad), zero beyond the projection width
  const float* q_scale;  // (m,)
  const float* q_corr;   // (m,)
};

// Query-chunk words in shared memory: for B <= 4 q_s[(k/4) * MT + i]
// packs q_int8[m0 + i, k..k+3] (byte c = dimension k + c); for B = 8
// q_s[k * MT + i] = q_int8[m0 + i, k].  Zero for queries past m.
template <int B>
__device__ __forceinline__ void load_coarse_chunk(const ScanArgs& a,
                                                  const CoarseQ& cq,
                                                  int d_pad, int m0,
                                                  int32_t* q_s) {
  if constexpr (B <= 4) {
    for (int t = threadIdx.x; t < (d_pad / 4) * MT; t += blockDim.x) {
      const int kg = t / MT, i = t % MT;
      uint32_t packed = 0u;
      if (m0 + i < a.m) {
        const int8_t* q = cq.q_int8 + (size_t)(m0 + i) * d_pad + 4 * kg;
#pragma unroll
        for (int c = 0; c < 4; ++c)
          packed |= (uint32_t)(uint8_t)q[c] << (8 * c);
      }
      q_s[t] = (int32_t)packed;
    }
  } else {
    for (int t = threadIdx.x; t < d_pad * MT; t += blockDim.x) {
      const int k = t / MT, i = t % MT;
      q_s[t] = (m0 + i < a.m) ? (int32_t)cq.q_int8[(size_t)(m0 + i) * d_pad + k]
                              : 0;
    }
  }
}

// Integer dot products of row j with the MT queries of the chunk, then
// the coarse epilogue and the metric tail.
template <int B, int METRIC>
__device__ __forceinline__ void coarse_row(const ScanArgs& a,
                                           const CoarseQ& cq, int j, int m0,
                                           const int32_t* __restrict__ q_s,
                                           float out[MT]) {
  constexpr int CPW = 32 / B;
  int acc[MT];
#pragma unroll
  for (int i = 0; i < MT; ++i) acc[i] = 0;
  const uint32_t* row = a.codes + (size_t)j * a.wd;
  for (int w = 0; w < a.wd; ++w) {
    const uint32_t word = __ldg(row + w);
    if constexpr (B <= 4) {
      constexpr int G = CPW / 4;  // quadruples of codes per word
#pragma unroll
      for (int g = 0; g < G; ++g) {
        uint32_t packed = 0u;
#pragma unroll
        for (int c = 0; c < 4; ++c)
          packed |= ((uint32_t)code_value<B>(word, 4 * g + c) & 0xffu)
                    << (8 * c);
        const int4* qw = reinterpret_cast<const int4*>(q_s + (w * G + g) * MT);
        const int4 lo = qw[0], hi = qw[1];
        const int v = (int)packed;
        acc[0] = __dp4a(v, lo.x, acc[0]);
        acc[1] = __dp4a(v, lo.y, acc[1]);
        acc[2] = __dp4a(v, lo.z, acc[2]);
        acc[3] = __dp4a(v, lo.w, acc[3]);
        acc[4] = __dp4a(v, hi.x, acc[4]);
        acc[5] = __dp4a(v, hi.y, acc[5]);
        acc[6] = __dp4a(v, hi.z, acc[6]);
        acc[7] = __dp4a(v, hi.w, acc[7]);
      }
    } else {
#pragma unroll
      for (int c = 0; c < CPW; ++c) {
        const int v = code_value<B>(word, c);
        const int4* qw = reinterpret_cast<const int4*>(q_s + (w * CPW + c) * MT);
        const int4 lo = qw[0], hi = qw[1];
        acc[0] += lo.x * v;
        acc[1] += lo.y * v;
        acc[2] += lo.z * v;
        acc[3] += lo.w * v;
        acc[4] += hi.x * v;
        acc[5] += hi.y * v;
        acc[6] += hi.z * v;
        acc[7] += hi.w * v;
      }
    }
  }
  const float sc = __ldg(a.scale + j);
  const float off = __ldg(a.offset + j);
  const int cl = __ldg(a.cluster + j);
  const float rt = (METRIC == METRIC_DOT) ? 0.f : __ldg(a.rowterm + j);
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int qi = min(m0 + i, a.m - 1);
    const float bias = __ldg(a.ipq + (size_t)qi * a.C + cl);
    const float qt = (METRIC == METRIC_DOT) ? 0.f : __ldg(a.qterm + qi);
    const float dotc = __fmul_rn((float)acc[i], __ldg(cq.q_scale + qi));
    const float biasq = __fadd_rn(bias, __ldg(cq.q_corr + qi));
    out[i] = metric_tail<METRIC>(eq20_base(dotc, sc, biasq, off), qt, rt);
  }
}

template <int B>
__host__ __device__ __forceinline__ size_t coarse_chunk_bytes(int d_pad) {
  return (B <= 4 ? (size_t)(d_pad / 4) : (size_t)d_pad) * MT * sizeof(int32_t);
}

template <int B, int METRIC>
__global__ void __launch_bounds__(SCORE_THREADS)
    ash_coarse_kernel(ScanArgs a, CoarseQ cq, int d_pad,
                      float* __restrict__ out) {
  extern __shared__ int4 smem_i4[];
  int32_t* q_s = reinterpret_cast<int32_t*>(smem_i4);
  const int m0 = blockIdx.y * MT;
  load_coarse_chunk<B>(a, cq, d_pad, m0, q_s);
  __syncthreads();
  const int j = blockIdx.x * SCORE_THREADS + threadIdx.x;
  if (j >= a.n) return;
  float s[MT];
  coarse_row<B, METRIC>(a, cq, j, m0, q_s, s);
#pragma unroll
  for (int i = 0; i < MT; ++i)
    if (m0 + i < a.m) out[(size_t)(m0 + i) * a.n + j] = s[i];
}

template <int B, int METRIC, int N>
__global__ void __launch_bounds__(TOPK_BLOCK_N, 2)
    ash_coarse_topk_kernel(ScanArgs a, CoarseQ cq, int d_pad,
                           const int32_t* __restrict__ mask, int L,
                           int tiles_per_span,
                           unsigned long long* __restrict__ strip) {
  extern __shared__ int4 smem_i4[];
  int32_t* q_s = reinterpret_cast<int32_t*>(smem_i4);
  const int m0 = blockIdx.y * MT;
  load_coarse_chunk<B>(a, cq, d_pad, m0, q_s);
  __syncthreads();
  // the selection state follows the query chunk, 16-byte aligned
  span_topk<N>(a, mask, L, tiles_per_span, gridDim.x,
            reinterpret_cast<char*>(smem_i4) + coarse_chunk_bytes<B>(d_pad),
            strip, [&](int j, float* s) {
              coarse_row<B, METRIC>(a, cq, j, m0, q_s, s);
            });
}

template <int B, int METRIC>
struct LaunchCoarse {
  static int run(ScanArgs a, CoarseQ cq, int d_pad, float* out,
                 cudaStream_t stream) {
    const size_t smem = coarse_chunk_bytes<B>(d_pad);
    int rc = set_smem(ash_coarse_kernel<B, METRIC>, smem);
    if (rc) return rc;
    dim3 grid((a.n + SCORE_THREADS - 1) / SCORE_THREADS, (a.m + MT - 1) / MT);
    ash_coarse_kernel<B, METRIC><<<grid, SCORE_THREADS, smem, stream>>>(
        a, cq, d_pad, out);
    return (int)cudaGetLastError();
  }
};

template <int B, int METRIC, int N>
int launch_coarse_topk(ScanArgs a, CoarseQ cq, int d_pad, const int32_t* mask,
                       int L, int tiles_per_span, int n_spans,
                       unsigned long long* strip, cudaStream_t stream) {
  const size_t smem = coarse_chunk_bytes<B>(d_pad) + span_select_bytes(L);
  static size_t smem_set = 48 * 1024;
  int rc = set_smem_once(ash_coarse_topk_kernel<B, METRIC, N>, smem,
                         &smem_set);
  if (rc) return rc;
  dim3 grid(n_spans, (a.m + MT - 1) / MT);
  ash_coarse_topk_kernel<B, METRIC, N><<<grid, TOPK_BLOCK_N, smem, stream>>>(
      a, cq, d_pad, mask, L, tiles_per_span, strip);
  return (int)cudaGetLastError();
}

template <int B, int METRIC>
struct LaunchCoarseTopk {
  static int run(ScanArgs a, CoarseQ cq, int d_pad, const int32_t* mask,
                 int L, int tiles_per_span, int n_spans,
                 unsigned long long* strip, cudaStream_t stream) {
    SELECT_BY_LANES(L, (launch_coarse_topk<B, METRIC, LANES>(
        a, cq, d_pad, mask, L, tiles_per_span, n_spans, strip, stream)));
  }
};

CoarseQ make_coarse_q(const void* q_int8, const void* q_scale,
                      const void* q_corr) {
  CoarseQ cq;
  cq.q_int8 = static_cast<const int8_t*>(q_int8);
  cq.q_scale = static_cast<const float*>(q_scale);
  cq.q_corr = static_cast<const float*>(q_corr);
  return cq;
}

}  // namespace

extern "C" {

// (m, n) f32 coarse scores into `out`.
int ash_coarse_launch(const void* codes, const void* q_int8,
                      const void* q_scale, const void* q_corr,
                      const void* scale, const void* offset,
                      const void* cluster, const void* ipq, const void* qterm,
                      const void* rowterm, void* out, int n, int m, int wd,
                      int C, int b, int metric, void* stream) {
  if (b < 1 || b > 8 || n <= 0 || m <= 0) return (int)cudaErrorInvalidValue;
  const int d_pad = wd * (32 / b);
  ScanArgs a = make_args(codes, nullptr, scale, offset, cluster, ipq, qterm,
                         rowterm, n, m, wd, C);
  return dispatch<LaunchCoarse>(b, metric, a,
                                make_coarse_q(q_int8, q_scale, q_corr), d_pad,
                                static_cast<float*>(out),
                                static_cast<cudaStream_t>(stream));
}

// (m, n_spans * L) strip of 64-bit keys into `strip`, as
// ash_score_topk_launch; mask may be null (every row < n valid).
int ash_coarse_topk_launch(const void* codes, const void* q_int8,
                           const void* q_scale, const void* q_corr,
                           const void* scale, const void* offset,
                           const void* cluster, const void* ipq,
                           const void* qterm, const void* rowterm,
                           const void* mask, void* strip, int n, int m,
                           int wd, int C, int b, int metric, int L,
                           int tiles_per_span, int n_spans, void* stream) {
  if (b < 1 || b > 8 || n <= 0 || m <= 0 || L < 1 || L > TOPK_BLOCK_N ||
      tiles_per_span < 1 || n_spans < 1 ||
      (long long)n_spans * tiles_per_span * TOPK_BLOCK_N < n)
    return (int)cudaErrorInvalidValue;
  const int d_pad = wd * (32 / b);
  ScanArgs a = make_args(codes, nullptr, scale, offset, cluster, ipq, qterm,
                         rowterm, n, m, wd, C);
  return dispatch<LaunchCoarseTopk>(
      b, metric, a, make_coarse_q(q_int8, q_scale, q_corr), d_pad,
      static_cast<const int32_t*>(mask), L, tiles_per_span, n_spans,
      static_cast<unsigned long long*>(strip),
      static_cast<cudaStream_t>(stream));
}

}  // extern "C"
