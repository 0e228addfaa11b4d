// Dense ASH scan kernels for Hopper (sm_90a): the materializing scan and
// the scan with fused per-tile top-k selection.
//
// Replaces (src/repro/kernels/ash_score.py):
//   ash_score_kernel      <- ash_score_pallas       (Eq. 20 + metric tail)
//   ash_score_topk_kernel <- ash_score_topk_pallas  (same scan + partial
//                                                    top-k~ per tile)
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
//   * the fused kernel keeps a 512-row tile's scores in shared memory as
//     64-bit (score desc, column asc) keys, bitonic-sorts them and emits
//     only the first k~ per query: the (m, n) score matrix never reaches
//     device memory.
//
// Each C entry point launches on the given stream and returns
// cudaGetLastError() so the wrapper can refuse a launch that failed.

#include "ash_common.cuh"

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

template <int B, int METRIC>
__global__ void __launch_bounds__(TOPK_BLOCK_N)
    ash_score_topk_kernel(ScanArgs a, int d_pad,
                          const int32_t* __restrict__ mask, int k_tilde,
                          int strip, float* __restrict__ vals,
                          int32_t* __restrict__ ids) {
  extern __shared__ float4 smem_f4[];
  float* q_s = reinterpret_cast<float*>(smem_f4);
  unsigned long long* keys =
      reinterpret_cast<unsigned long long*>(q_s + d_pad * MT);
  const int m0 = blockIdx.y * MT;
  const int mc = min(MT, a.m - m0);
  load_query_chunk(a, d_pad, m0, q_s);
  __syncthreads();

  const int col = threadIdx.x;
  const int j = blockIdx.x * TOPK_BLOCK_N + col;
  const bool valid = j < a.n && (mask == nullptr || __ldg(mask + j) != 0);
  float s[MT] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (j < a.n) score_row<B, METRIC>(a, j, m0, q_s, s);
#pragma unroll
  for (int i = 0; i < MT; ++i)
    keys[i * TOPK_BLOCK_N + col] = valid ? make_key(s[i], col) : INVALID_KEY;
  __syncthreads();

  bitonic_sort_rows(keys, mc);
  emit_strip(keys, mc, m0, k_tilde, strip, blockIdx.x * TOPK_BLOCK_N, vals,
             ids);
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

template <int B, int METRIC>
struct LaunchTopk {
  static int run(ScanArgs a, int d_pad, const int32_t* mask, int k_tilde,
                 int n_blocks, float* vals, int32_t* ids, cudaStream_t stream) {
    const size_t smem = (size_t)d_pad * MT * sizeof(float) +
                        (size_t)MT * TOPK_BLOCK_N * sizeof(unsigned long long);
    int rc = set_smem(ash_score_topk_kernel<B, METRIC>, smem);
    if (rc) return rc;
    dim3 grid(n_blocks, (a.m + MT - 1) / MT);
    ash_score_topk_kernel<B, METRIC><<<grid, TOPK_BLOCK_N, smem, stream>>>(
        a, d_pad, mask, k_tilde, n_blocks * k_tilde, vals, ids);
    return (int)cudaGetLastError();
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

// (m, n_blocks * k_tilde) candidate strip of (score, id) into vals/ids;
// mask may be null (every row < n valid).
int ash_score_topk_launch(const void* codes, const void* q_proj,
                          const void* scale, const void* offset,
                          const void* cluster, const void* ipq,
                          const void* qterm, const void* rowterm,
                          const void* mask, void* vals, void* ids, int n,
                          int m, int wd, int C, int b, int metric, int k_tilde,
                          int n_blocks, void* stream) {
  if (b < 1 || b > 8 || n <= 0 || m <= 0 || k_tilde < 1 ||
      k_tilde > TOPK_BLOCK_N || n_blocks * TOPK_BLOCK_N < n)
    return (int)cudaErrorInvalidValue;
  const int d_pad = wd * (32 / b);
  ScanArgs a = make_args(codes, q_proj, scale, offset, cluster, ipq, qterm,
                         rowterm, n, m, wd, C);
  return dispatch<LaunchTopk>(b, metric, a, d_pad,
                              static_cast<const int32_t*>(mask), k_tilde,
                              n_blocks, static_cast<float*>(vals),
                              static_cast<int32_t*>(ids),
                              static_cast<cudaStream_t>(stream));
}

}  // extern "C"
