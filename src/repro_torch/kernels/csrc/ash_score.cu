// Dense ASH scan kernels for Hopper (sm_90a): the materializing scan and
// the scan with fused top-k selection.
//
// Replaces (src/repro/kernels/ash_score.py):
//   ash_score_kernel      <- ash_score_pallas       (Eq. 20 + metric tail)
//   ash_score_topk_kernel <- ash_score_topk_pallas  (same scan + running
//                                                    top-k~ per span; the
//                                                    merge in ash_select.cu)
//
// What bounds it on the H100: fp32 operations, at the main path's shapes.
// A row costs 2*m*d_pad FLOPs (2048 at m = 8 queries, d_pad = 128)
// against 44 bytes read (32 of packed b = 2 codes, 12 of headers), plus
// 4*m bytes of scores written by the materializing kernel: 27-46
// FLOP/byte, above the card's 20 FLOP/byte ridge for fp32 outside the
// tensor cores (67 TFLOP/s over 3.35 TB/s).  Below m ~ 4 it is bytes.
//
// What the design does about it:
//   * codes stay packed in device memory; each thread loads its own
//     row's words and unpacks them in registers (shift, mask, 2l-(2^b-1));
//   * the block's query chunk (MT queries) sits in shared memory laid out
//     [k][MT], so the MT query values of one code dimension are two
//     16-byte shared loads broadcast to the warp;
//   * accumulation is plain fp32 FMA in a fixed sequential order over k,
//     and the epilogue uses unfused round-to-nearest ops in the plain
//     version's order, so both kernels produce the same score for the
//     same (query, row) element for element;
//   * the fused kernel never writes the (m, n) score matrix: a block
//     walks a span of 512-row tiles (about two blocks per SM and query
//     chunk when k <= k~, one tile when k~ < k); each tile's 64-bit
//     (score desc, row asc) keys pass through shared memory to one warp
//     per query, which keeps a running top-L (L = min(k, k~)) behind a
//     bound (ash_select.cuh): a scored row costs one compare per query,
//     and only the keys that beat the bound are sorted (in registers)
//     and merged.  Each span emits its L keys to a key strip, which one
//     launch of ash_topk_merge_kernel (ash_select.cu) reduces to the
//     top-k on the card.
//
// Each C entry point launches on the given stream and returns
// cudaGetLastError() so the wrapper can refuse a launch that failed.

#include "ash_select.cuh"

namespace {

constexpr int SCORE_THREADS = 256;  // rows per materializing block

// q_s[k * MT + i] = q_proj[m0 + i, k], zero for queries past m.
__device__ __forceinline__ void load_query_chunk(const ScanArgs& a, int d_pad,
                                                 int m0, float* q_s) {
  for (int t = threadIdx.x; t < d_pad * MT; t += blockDim.x) {
    int k = t / MT, i = t % MT;
    q_s[t] = (m0 + i < a.m) ? a.q_proj[(size_t)(m0 + i) * d_pad + k] : 0.f;
  }
}

// The shared routine of both kernels: unpack row j, accumulate its dot
// products with the MT queries of the chunk, apply the Eq. 20 epilogue
// acc*SCALE + <q, mu_c> + OFFSET and the metric tail.
template <int B, int METRIC>
__device__ __forceinline__ void score_row(const ScanArgs& a, int j, int m0,
                                          const float* __restrict__ q_s,
                                          float out[MT]) {
  constexpr int CPW = 32 / B;
  float acc[MT];
#pragma unroll
  for (int i = 0; i < MT; ++i) acc[i] = 0.f;
  const uint32_t* row = a.codes + (size_t)j * a.wd;
  for (int w = 0; w < a.wd; ++w) {
    const uint32_t word = __ldg(row + w);
    const float4* qw = reinterpret_cast<const float4*>(q_s + w * CPW * MT);
#pragma unroll
    for (int c = 0; c < CPW; ++c) {
      const float v = (float)code_value<B>(word, c);
      const float4 lo = qw[2 * c], hi = qw[2 * c + 1];
      acc[0] = fmaf(lo.x, v, acc[0]);
      acc[1] = fmaf(lo.y, v, acc[1]);
      acc[2] = fmaf(lo.z, v, acc[2]);
      acc[3] = fmaf(lo.w, v, acc[3]);
      acc[4] = fmaf(hi.x, v, acc[4]);
      acc[5] = fmaf(hi.y, v, acc[5]);
      acc[6] = fmaf(hi.z, v, acc[6]);
      acc[7] = fmaf(hi.w, v, acc[7]);
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
    out[i] = metric_tail<METRIC>(eq20_base(acc[i], sc, bias, off), qt, rt);
  }
}

template <int B, int METRIC>
__global__ void __launch_bounds__(SCORE_THREADS)
    ash_score_kernel(ScanArgs a, int d_pad, float* __restrict__ out) {
  extern __shared__ float4 smem_f4[];
  float* q_s = reinterpret_cast<float*>(smem_f4);
  const int m0 = blockIdx.y * MT;
  load_query_chunk(a, d_pad, m0, q_s);
  __syncthreads();
  const int j = blockIdx.x * SCORE_THREADS + threadIdx.x;
  if (j >= a.n) return;
  float s[MT];
  score_row<B, METRIC>(a, j, m0, q_s, s);
#pragma unroll
  for (int i = 0; i < MT; ++i)
    if (m0 + i < a.m) out[(size_t)(m0 + i) * a.n + j] = s[i];
}

template <int B, int METRIC, int N>
__global__ void __launch_bounds__(TOPK_BLOCK_N, 2)
    ash_score_topk_kernel(ScanArgs a, int d_pad,
                          const int32_t* __restrict__ mask, int L,
                          int tiles_per_span,
                          unsigned long long* __restrict__ strip) {
  extern __shared__ float4 smem_f4[];
  float* q_s = reinterpret_cast<float*>(smem_f4);
  const int m0 = blockIdx.y * MT;
  load_query_chunk(a, d_pad, m0, q_s);
  __syncthreads();
  span_topk<N>(a, mask, L, tiles_per_span, gridDim.x, q_s + d_pad * MT,
               strip, [&](int j, float* s) {
                 score_row<B, METRIC>(a, j, m0, q_s, s);
               });
}

template <int B, int METRIC>
struct LaunchScore {
  static int run(ScanArgs a, int d_pad, float* out, cudaStream_t stream) {
    const size_t smem = (size_t)d_pad * MT * sizeof(float);
    int rc = set_smem(ash_score_kernel<B, METRIC>, smem);
    if (rc) return rc;
    dim3 grid((a.n + SCORE_THREADS - 1) / SCORE_THREADS, (a.m + MT - 1) / MT);
    ash_score_kernel<B, METRIC><<<grid, SCORE_THREADS, smem, stream>>>(a, d_pad, out);
    return (int)cudaGetLastError();
  }
};

template <int B, int METRIC, int N>
int launch_topk(ScanArgs a, int d_pad, const int32_t* mask, int L,
                int tiles_per_span, int n_spans, unsigned long long* strip,
                cudaStream_t stream) {
  const size_t smem = (size_t)d_pad * MT * sizeof(float) +
                      span_select_bytes(L);
  static size_t smem_set = 48 * 1024;
  int rc = set_smem_once(ash_score_topk_kernel<B, METRIC, N>, smem,
                         &smem_set);
  if (rc) return rc;
  dim3 grid(n_spans, (a.m + MT - 1) / MT);
  ash_score_topk_kernel<B, METRIC, N><<<grid, TOPK_BLOCK_N, smem, stream>>>(
      a, d_pad, mask, L, tiles_per_span, strip);
  return (int)cudaGetLastError();
}

template <int B, int METRIC>
struct LaunchTopk {
  static int run(ScanArgs a, int d_pad, const int32_t* mask, int L,
                 int tiles_per_span, int n_spans, unsigned long long* strip,
                 cudaStream_t stream) {
    SELECT_BY_LANES(L, (launch_topk<B, METRIC, LANES>(
        a, d_pad, mask, L, tiles_per_span, n_spans, strip, stream)));
  }
};

}  // namespace

extern "C" {

// (m, n) f32 scores into `out`.
int ash_score_launch(const void* codes, const void* q_proj, const void* scale,
                     const void* offset, const void* cluster, const void* ipq,
                     const void* qterm, const void* rowterm, void* out, int n,
                     int m, int wd, int C, int b, int metric, void* stream) {
  if (b < 1 || b > 8 || n <= 0 || m <= 0) return (int)cudaErrorInvalidValue;
  const int d_pad = wd * (32 / b);
  ScanArgs a = make_args(codes, q_proj, scale, offset, cluster, ipq, qterm,
                         rowterm, n, m, wd, C);
  return dispatch<LaunchScore>(b, metric, a, d_pad, static_cast<float*>(out),
                               static_cast<cudaStream_t>(stream));
}

// (m, n_spans * L) strip of 64-bit keys into `strip`: span s of
// tiles_per_span 512-row tiles gives its best L keys per query, sorted,
// INVALID past its valid rows; mask may be null (every row < n valid).
int ash_score_topk_launch(const void* codes, const void* q_proj,
                          const void* scale, const void* offset,
                          const void* cluster, const void* ipq,
                          const void* qterm, const void* rowterm,
                          const void* mask, void* strip, int n, int m, int wd,
                          int C, int b, int metric, int L, int tiles_per_span,
                          int n_spans, void* stream) {
  if (b < 1 || b > 8 || n <= 0 || m <= 0 || L < 1 || L > TOPK_BLOCK_N ||
      tiles_per_span < 1 || n_spans < 1 ||
      (long long)n_spans * tiles_per_span * TOPK_BLOCK_N < n)
    return (int)cudaErrorInvalidValue;
  const int d_pad = wd * (32 / b);
  ScanArgs a = make_args(codes, q_proj, scale, offset, cluster, ipq, qterm,
                         rowterm, n, m, wd, C);
  return dispatch<LaunchTopk>(b, metric, a, d_pad,
                              static_cast<const int32_t*>(mask), L,
                              tiles_per_span, n_spans,
                              static_cast<unsigned long long*>(strip),
                              static_cast<cudaStream_t>(stream));
}

}  // extern "C"
