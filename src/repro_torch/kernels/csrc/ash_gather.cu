// Gathered ASH scan kernels for Hopper (sm_90a): query i scored against
// its own candidate rows rows[i] (IVF partial probes, coarse refine).
//
// Replaces (src/repro/kernels/ash_score.py):
//   ash_gather_kernel      <- ash_score_gather_pallas      (Eq. 20 + metric
//                                                           tail; pad id -1
//                                                           scores -inf)
//   ash_gather_topk_kernel <- ash_score_gather_topk_pallas (same scan +
//                                                           top-k over
//                                                           candidate
//                                                           positions)
//
// What bounds it on the H100: bytes.  Queries do not share candidate
// rows, so each live (query, candidate) pair reads its own packed row
// (32 bytes at b = 2, d = 128), its headers (scale, offset, cluster,
// 12 bytes), its row id (4 bytes) and, for the materializing kernel,
// writes a 4-byte score: about 52 bytes against 2*d_pad = 256 FLOPs,
// 5 FLOP/byte, under the card's 20 FLOP/byte fp32 ridge.  Measured
// (kernels/probe.py), the loads alone take about half of kernel 3's time
// and its unpack and FMAs the rest: they do not overlap the loads fully.
//
// What the design does about it:
//   * the TPU kernel's scalar-prefetched row table and per-candidate DMA
//     become threads that each own GATHER_POSITIONS candidate positions
//     (GATHER_THREADS apart, so a warp's loads stay coalesced): a thread
//     loads its row ids, then its candidates' headers and packed words
//     straight from device memory, the words as 16-byte loads when the
//     rows allow it (ScanArgs vec4), all before the arithmetic; inverted
//     lists are contiguous row ranges, so neighbouring threads read
//     neighbouring rows, and a list's padded end costs one divergent warp;
//   * a pad id (-1) loads nothing: its thread writes -inf (kernel 3) or
//     an invalid key that never enters a selection (kernel 4);
//   * a code costs one FMA, so its unpack must be cheap: code_float
//     (ash_common.cuh) builds its exact float with an and-or and an FADD,
//     no int-to-float conversion (which issues at an eighth of the FMA
//     rate and held the first version of kernel 3); the block's query
//     row sits in shared memory and is read as 16-byte broadcasts, 4
//     codes a load, shared by the thread's positions;
//   * the dot term is a sequential fp32 FMA over the code dimensions and
//     the epilogue uses unfused round-to-nearest ops, in the order of the
//     dense kernels' score_rows, so a gathered score is bit-equal to the
//     dense kernel's score of the same (query, row);
//   * the fused kernel (kernel 4) keys each score as 64 bits (score
//     desc, POSITION asc: ties go to the lowest candidate position, as
//     in the reference).  A block walks a span of 512-position tiles of
//     one query's table (about two blocks per SM over all queries,
//     ref.gather_span_geometry; one-tile spans when k~ < k, which keeps
//     the reference's per-tile strip).  Two 512-thread blocks are
//     resident on an SM only where an instance takes at most 64
//     registers.  With code_float's exponents held in registers, ptxas
//     gives the main path's instance (b = 2, lists of 128 keys) 92
//     registers and no spills, and the others up to 118, so the grid
//     runs as two waves of one block an SM.  Each warp scores its
//     positions of 8 tiles at a time, 8 a lane (score_one, so bit-equal
//     to kernel 3), and takes those beating the bound into its own
//     running top-L list (ash_select.cuh: the bound is shared by the
//     block's 16 warps), with no block barrier until the span ends; the
//     lists are then merged and the span's L keys written to a strip,
//     which ash_topk_merge_kernel (ash_select.cu) reduces to the top-k
//     and maps back through rows on the card: one scan launch and one
//     merge launch, nothing on the host.
//
// Each C entry point launches on the given stream and returns
// cudaGetLastError() so the wrapper can refuse a launch that failed.

#include "ash_select.cuh"

namespace {

constexpr int GATHER_THREADS = 128;  // threads per block
constexpr int GATHER_POSITIONS = 2;  // candidate positions per thread
constexpr int GATHER_MIN_BLOCKS = 1; // __launch_bounds__ blocks an SM

// q_s[k] = q_proj[qi, k].
__device__ __forceinline__ void load_query_row(const ScanArgs& a, int d_pad,
                                               int qi, float* q_s) {
  for (int k = threadIdx.x; k < d_pad; k += blockDim.x)
    q_s[k] = a.q_proj[(size_t)qi * d_pad + k];
}

// One-query form of score_rows (ash_score.cu), for rows j[0..P) of query
// qi: the same sequential FMA chain over the code dimensions
// (code_float, no conversion) and the same epilogue, so each score is
// bit-equal to the dense kernels'.  The P rows share each 16-byte
// broadcast load of 4 query values.
template <int B, int METRIC, int P>
__device__ __forceinline__ void score_ones(const ScanArgs& a,
                                           const int (&j)[P], int qi,
                                           const float* __restrict__ q_s,
                                           float (&out)[P]) {
  constexpr int CPW = 32 / B;
  float sc[P], off[P], rt[P], acc[P];
  int cl[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {  // headers in flight during the scan
    sc[p] = __ldg(a.scale + j[p]);
    off[p] = __ldg(a.offset + j[p]);
    cl[p] = __ldg(a.cluster + j[p]);
    rt[p] = (METRIC == METRIC_DOT) ? 0.f : __ldg(a.rowterm + j[p]);
    acc[p] = 0.f;
  }
  const float4* q4 = reinterpret_cast<const float4*>(q_s);
  const uint32_t expo24 = a.expo24;
  auto word = [&](const uint32_t (&wv)[P], int w) {
#pragma unroll
    for (int c4 = 0; c4 < CPW / 4; ++c4) {
      const float4 q4c = q4[w * (CPW / 4) + c4];
      const float qc[4] = {q4c.x, q4c.y, q4c.z, q4c.w};
#pragma unroll
      for (int p = 0; p < P; ++p)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[p] = fmaf(qc[e], code_float<B>(wv[p], 4 * c4 + e, expo24),
                        acc[p]);
    }
  };
  for_each_word<P>(a, j, word);
  const float qt = (METRIC == METRIC_DOT) ? 0.f : __ldg(a.qterm + qi);
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const float bias = __ldg(a.ipq + (size_t)qi * a.C + cl[p]);
    out[p] = metric_tail<METRIC>(eq20_base(acc[p], sc[p], bias, off[p]), qt,
                                 rt[p]);
  }
}

template <int B, int METRIC>
__device__ __forceinline__ float score_one(const ScanArgs& a, int j, int qi,
                                           const float* __restrict__ q_s) {
  const int jj[1] = {j};
  float o[1];
  score_ones<B, METRIC, 1>(a, jj, qi, q_s, o);
  return o[0];
}

// grid (ceil(R / (GATHER_THREADS * GATHER_POSITIONS)), m): one query per
// block row; thread x scores positions x, x + GATHER_THREADS, .. of its
// block's span.  A pad id (or a position past R) loads no row of its own:
// it repeats the thread's live row, unstored, and scores -inf; a thread
// with no live position loads no row at all.
template <int B, int METRIC>
__global__ void __launch_bounds__(GATHER_THREADS, GATHER_MIN_BLOCKS)
    ash_gather_kernel(ScanArgs a, const int32_t* __restrict__ rows, int R,
                      int d_pad, float* __restrict__ out) {
  constexpr int P = GATHER_POSITIONS;
  extern __shared__ float4 smem_f4[];
  float* q_s = reinterpret_cast<float*>(smem_f4);
  const int qi = blockIdx.y;
  load_query_row(a, d_pad, qi, q_s);
  __syncthreads();
  const int t0 = blockIdx.x * (GATHER_THREADS * P) + threadIdx.x;
  const int32_t* qrows = rows + (size_t)qi * R;
  int j[P], live = -1;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int t = t0 + p * GATHER_THREADS;
    j[p] = t < R ? __ldg(qrows + t) : -1;
    if (j[p] >= 0) live = j[p];
  }
  float s[P];
  if (live >= 0) {
    int js[P];
#pragma unroll
    for (int p = 0; p < P; ++p) js[p] = j[p] >= 0 ? j[p] : live;
    score_ones<B, METRIC, P>(a, js, qi, q_s, s);
  }
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int t = t0 + p * GATHER_THREADS;
    if (t < R)
      out[(size_t)qi * R + t] = j[p] >= 0 ? s[p] : -__int_as_float(0x7f800000);
  }
}

// grid (n_spans, m): block (x, qi) walks tiles [x * tiles_per_span, ...)
// of query qi's candidate table; thread c of the block scores position
// tile * TOPK_BLOCK_N + c of each, warp w keeps its list of LR = 32N keys,
// and the span's first L keys of the merged lists go to its strip slots.
template <int B, int METRIC, int N>
__global__ void __launch_bounds__(TOPK_BLOCK_N)
    ash_gather_topk_kernel(ScanArgs a, const int32_t* __restrict__ rows,
                           int R, int d_pad, int L,
                           int tiles_per_span, int n_spans,
                           unsigned long long* __restrict__ strip) {
  constexpr int LR = 32 * N;
  constexpr int WARPS = TOPK_BLOCK_N / 32;
  extern __shared__ float4 smem_f4[];
  float* q_s = reinterpret_cast<float*>(smem_f4);
  unsigned long long* lists =
      reinterpret_cast<unsigned long long*>(q_s + d_pad);  // [WARPS][LR]
  unsigned long long* bufs = lists + WARPS * LR;           // [WARPS][256]
  unsigned long long* bound = bufs + WARPS * WARP_KEYS;
  const int qi = blockIdx.y;
  load_query_row(a, d_pad, qi, q_s);
  for (int t = threadIdx.x; t < WARPS * LR; t += blockDim.x)
    lists[t] = INVALID_KEY;
  if (threadIdx.x == 0) *bound = INVALID_KEY;
  __syncthreads();

  const int w = threadIdx.x >> 5;
  const int n_tiles = (R + TOPK_BLOCK_N - 1) / TOPK_BLOCK_N;
  const int t0 = blockIdx.x * tiles_per_span;
  const int t1 = min(t0 + tiles_per_span, n_tiles);
  const int32_t* qrows = rows + (size_t)qi * R;
  for (int tile = t0; tile < t1; tile += 8) {
    // this lane's position in each of the next 8 tiles
    unsigned long long k8[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int pos = (tile + i) * TOPK_BLOCK_N + threadIdx.x;
      const int j = (tile + i < t1 && pos < R) ? __ldg(qrows + pos) : -1;
      k8[i] = j >= 0 ? make_key(score_one<B, METRIC>(a, j, qi, q_s), pos)
                     : INVALID_KEY;
    }
    warp_absorb<N>(k8, bufs + w * WARP_KEYS, lists + (size_t)w * LR, bound,
                   L);
  }
  merge_lists<N>(lists, WARPS);
  unsigned long long* out =
      strip + (size_t)qi * n_spans * L + (size_t)blockIdx.x * L;
  for (int i = threadIdx.x; i < L; i += blockDim.x) out[i] = lists[i];
}

template <int B, int METRIC>
struct LaunchGather {
  static int run(ScanArgs a, const int32_t* rows, int R, int d_pad,
                 float* out, cudaStream_t stream) {
    const size_t smem = (size_t)d_pad * sizeof(float);
    int rc = set_smem(ash_gather_kernel<B, METRIC>, smem);
    if (rc) return rc;
    constexpr int PER_BLOCK = GATHER_THREADS * GATHER_POSITIONS;
    dim3 grid((R + PER_BLOCK - 1) / PER_BLOCK, a.m);
    ash_gather_kernel<B, METRIC><<<grid, GATHER_THREADS, smem, stream>>>(
        a, rows, R, d_pad, out);
    return (int)cudaGetLastError();
  }
};

template <int B, int METRIC, int N>
int launch_gather_topk(ScanArgs a, const int32_t* rows, int R, int d_pad,
                       int L, int per, int n_spans,
                       unsigned long long* strip, cudaStream_t stream) {
  const size_t smem =
      (size_t)d_pad * sizeof(float) +
      sizeof(unsigned long long) *
          ((size_t)(TOPK_BLOCK_N / 32) * (32 * N + WARP_KEYS) + 1);
  static size_t smem_set[MAX_DEVICES] = {};
  int rc = set_smem_once(ash_gather_topk_kernel<B, METRIC, N>, smem,
                         smem_set);
  if (rc) return rc;
  dim3 grid(n_spans, a.m);
  ash_gather_topk_kernel<B, METRIC, N><<<grid, TOPK_BLOCK_N, smem, stream>>>(
      a, rows, R, d_pad, L, per, n_spans, strip);
  return (int)cudaGetLastError();
}

template <int B, int METRIC>
struct LaunchGatherTopk {
  static int run(ScanArgs a, const int32_t* rows, int R, int d_pad, int L,
                 int per, int n_spans, unsigned long long* strip,
                 cudaStream_t stream) {
    SELECT_BY_LANES(L, (launch_gather_topk<B, METRIC, LANES>(
                           a, rows, R, d_pad, L, per, n_spans, strip,
                           stream)));
  }
};

}  // namespace

extern "C" {

// (m, R) f32 scores of query i against rows[i] into `out`; rows holds
// payload rows in [0, n) or -1 (padding, scored -inf).
int ash_gather_launch(const void* codes, const void* rows, const void* q_proj,
                      const void* scale, const void* offset,
                      const void* cluster, const void* ipq, const void* qterm,
                      const void* rowterm, void* out, int n, int m, int R,
                      int wd, int C, int b, int metric, void* stream) {
  if (b < 1 || b > 8 || n <= 0 || m <= 0 || m > 65535 || R <= 0)
    return (int)cudaErrorInvalidValue;
  const int d_pad = wd * (32 / b);
  ScanArgs a = make_args(codes, q_proj, scale, offset, cluster, ipq, qterm,
                         rowterm, n, m, wd, C);
  return dispatch<LaunchGather>(b, metric, a, static_cast<const int32_t*>(rows),
                                R, d_pad, static_cast<float*>(out),
                                static_cast<cudaStream_t>(stream));
}

// (m, n_spans * L) strip of 64-bit selection keys (make_key of score and
// candidate POSITION; one sorted list of L per span of tiles_per_span
// 512-position tiles), for ash_topk_merge_launch; pad ids never enter.
int ash_gather_topk_launch(const void* codes, const void* rows,
                           const void* q_proj, const void* scale,
                           const void* offset, const void* cluster,
                           const void* ipq, const void* qterm,
                           const void* rowterm, void* strip, int n, int m,
                           int R, int wd, int C, int b, int metric, int L,
                           int tiles_per_span, int n_spans, void* stream) {
  if (b < 1 || b > 8 || n <= 0 || m <= 0 || m > 65535 || R <= 0 || L < 1 ||
      L > 512 || tiles_per_span < 1 || n_spans < 1 ||
      (long long)n_spans * tiles_per_span * TOPK_BLOCK_N < R)
    return (int)cudaErrorInvalidValue;
  const int d_pad = wd * (32 / b);
  ScanArgs a = make_args(codes, q_proj, scale, offset, cluster, ipq, qterm,
                         rowterm, n, m, wd, C);
  return dispatch<LaunchGatherTopk>(
      b, metric, a, static_cast<const int32_t*>(rows), R, d_pad, L,
      tiles_per_span, n_spans,
      static_cast<unsigned long long*>(strip),
      static_cast<cudaStream_t>(stream));
}

}  // extern "C"
