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
// The FMAs are not the only instructions a code costs: its unpack, and
// the shared loads of the query values, issue from the same warp
// schedulers, and the shared loads' broadcasts take shared-memory
// bandwidth, so neither the FMA rate nor the bytes alone bound the scan
// (kernels/probe.py takes each part out in turn).  What the design does
// about it:
//   * codes stay packed in device memory; each thread loads its own
//     rows' words, as 16-byte loads where the rows allow it (ScanArgs
//     vec4), and unpacks them in registers with code_float
//     (ash_common.cuh): an and-or and an FADD a code build the exact float
//     of 2l - (2^b - 1), with no int-to-float conversion (which issues at
//     an eighth of the FMA rate);
//   * the block's query chunk (MT queries) sits in shared memory laid out
//     [k][MT], so the MT query values of one code dimension are two
//     16-byte shared loads broadcast to the warp; the materializing
//     kernel gives each thread SCORE_ROWS rows, which share those loads
//     (8 FMAs a row and code, about 3 other instructions);
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

constexpr int SCORE_THREADS = 256;  // threads per materializing block
constexpr int SCORE_ROWS = 3;       // rows per thread, sharing query loads
constexpr int SCORE_MIN_BLOCKS = 1; // __launch_bounds__ blocks an SM

// q_s[k * MT + i] = q_proj[m0 + i, k], zero for queries past m.
__device__ __forceinline__ void load_query_chunk(const ScanArgs& a, int d_pad,
                                                 int m0, float* q_s) {
  for (int t = threadIdx.x; t < d_pad * MT; t += blockDim.x) {
    int k = t / MT, i = t % MT;
    q_s[t] = (m0 + i < a.m) ? a.q_proj[(size_t)(m0 + i) * d_pad + k] : 0.f;
  }
}

// The shared routine of both kernels: unpack rows j[0..ROWS) (code_float,
// no conversion), accumulate each row's dot products with the MT queries
// of the chunk, then apply the Eq. 20 epilogue acc*SCALE + <q, mu_c> +
// OFFSET and the metric tail.  Each of a row's MT sums is one sequential
// fp32 FMA chain over k, whatever ROWS is; the ROWS rows share each pair
// of 16-byte shared loads of the MT query values of a code dimension.
template <int B, int METRIC, int ROWS>
__device__ __forceinline__ void score_rows(const ScanArgs& a,
                                           const int (&j)[ROWS], int m0,
                                           const float* __restrict__ q_s,
                                           float (&out)[ROWS][MT]) {
  constexpr int CPW = 32 / B;
  float sc[ROWS], off[ROWS], rt[ROWS];
  int cl[ROWS];
  float acc[ROWS][MT];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {  // headers in flight during the scan
    sc[r] = __ldg(a.scale + j[r]);
    off[r] = __ldg(a.offset + j[r]);
    cl[r] = __ldg(a.cluster + j[r]);
    rt[r] = (METRIC == METRIC_DOT) ? 0.f : __ldg(a.rowterm + j[r]);
#pragma unroll
    for (int i = 0; i < MT; ++i) acc[r][i] = 0.f;
  }
  const float4* q4 = reinterpret_cast<const float4*>(q_s);
  const uint32_t expo24 = a.expo24;
  auto word = [&](const uint32_t (&wv)[ROWS], int w) {
#pragma unroll
    for (int c = 0; c < CPW; ++c) {
      const float4 lo = q4[2 * (w * CPW + c)], hi = q4[2 * (w * CPW + c) + 1];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float v = code_float<B>(wv[r], c, expo24);
        acc[r][0] = fmaf(lo.x, v, acc[r][0]);
        acc[r][1] = fmaf(lo.y, v, acc[r][1]);
        acc[r][2] = fmaf(lo.z, v, acc[r][2]);
        acc[r][3] = fmaf(lo.w, v, acc[r][3]);
        acc[r][4] = fmaf(hi.x, v, acc[r][4]);
        acc[r][5] = fmaf(hi.y, v, acc[r][5]);
        acc[r][6] = fmaf(hi.z, v, acc[r][6]);
        acc[r][7] = fmaf(hi.w, v, acc[r][7]);
      }
    }
  };
  for_each_word<ROWS>(a, j, word);
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int qi = min(m0 + i, a.m - 1);
      const float bias = __ldg(a.ipq + (size_t)qi * a.C + cl[r]);
      const float qt = (METRIC == METRIC_DOT) ? 0.f : __ldg(a.qterm + qi);
      out[r][i] = metric_tail<METRIC>(eq20_base(acc[r][i], sc[r], bias,
                                                off[r]), qt, rt[r]);
    }
  }
}

// grid (ceil(n / (SCORE_THREADS * SCORE_ROWS)), ceil(m / MT)): thread x
// of a block scores rows x, x + SCORE_THREADS, .. of its block's span;
// a row past n repeats row n - 1 and is not stored.
template <int B, int METRIC>
__global__ void __launch_bounds__(SCORE_THREADS, SCORE_MIN_BLOCKS)
    ash_score_kernel(ScanArgs a, int d_pad, float* __restrict__ out) {
  extern __shared__ float4 smem_f4[];
  float* q_s = reinterpret_cast<float*>(smem_f4);
  const int m0 = blockIdx.y * MT;
  load_query_chunk(a, d_pad, m0, q_s);
  __syncthreads();
  const int j0 = blockIdx.x * (SCORE_THREADS * SCORE_ROWS) + threadIdx.x;
  if (j0 >= a.n) return;
  int j[SCORE_ROWS];
#pragma unroll
  for (int r = 0; r < SCORE_ROWS; ++r)
    j[r] = min(j0 + r * SCORE_THREADS, a.n - 1);
  float s[SCORE_ROWS][MT];
  score_rows<B, METRIC, SCORE_ROWS>(a, j, m0, q_s, s);
#pragma unroll
  for (int r = 0; r < SCORE_ROWS; ++r) {
    const int jr = j0 + r * SCORE_THREADS;
#pragma unroll
    for (int i = 0; i < MT; ++i)
      if (jr < a.n && m0 + i < a.m) out[(size_t)(m0 + i) * a.n + jr] = s[r][i];
  }
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
                 const int jj[1] = {j};
                 float o[1][MT];
                 score_rows<B, METRIC, 1>(a, jj, m0, q_s, o);
#pragma unroll
                 for (int i = 0; i < MT; ++i) s[i] = o[0][i];
               });
}

template <int B, int METRIC>
struct LaunchScore {
  static int run(ScanArgs a, int d_pad, float* out, cudaStream_t stream) {
    const size_t smem = (size_t)d_pad * MT * sizeof(float);
    int rc = set_smem(ash_score_kernel<B, METRIC>, smem);
    if (rc) return rc;
    constexpr int PER_BLOCK = SCORE_THREADS * SCORE_ROWS;
    dim3 grid((a.n + PER_BLOCK - 1) / PER_BLOCK, (a.m + MT - 1) / MT);
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
  static size_t smem_set[MAX_DEVICES] = {};
  int rc = set_smem_once(ash_score_topk_kernel<B, METRIC, N>, smem,
                         smem_set);
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
