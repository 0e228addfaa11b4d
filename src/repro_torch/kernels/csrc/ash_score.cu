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
// A (query, row) pair costs 2*d_pad + 3 operations (259 at d_pad = 128),
// a row 44 bytes read (32 of packed b = 2 codes, 12 of headers), once for
// every query chunk that reads it.  At m = 1,024 queries over 10^7 rows
// that is 2.65e15 operations, 39.6 ms at 67 TFLOP/s, against 0.44 GB read
// once (0.13 ms at 3.35 TB/s): far above the card's 20 FLOP/byte ridge
// for fp32 outside the tensor cores.  Below m ~ 4 it is bytes.
//
// The FMAs are not the only instructions a code costs: its unpack, and
// the shared loads of the query values, issue from the same warp
// schedulers, so neither the FMA rate nor the bytes alone bound the scan
// (kernels/probe.py takes each part out in turn).  What the design does
// about it:
//   * codes stay packed in device memory; each thread loads its own
//     rows' words, as 16-byte loads where the rows allow it (ScanArgs
//     vec4), and unpacks them in registers with code_float
//     (ash_common.cuh): an and-or and an FADD a code build the exact float
//     of 2l - (2^b - 1), with no int-to-float conversion (which issues at
//     an eighth of the FMA rate); each code is unpacked once for the MT
//     queries of its thread;
//   * the block's query chunk sits in shared memory laid out [k][chunk],
//     so a thread's MT query values of one code dimension are two 16-byte
//     shared loads broadcast to its warp; the rows of a thread share
//     them: SCORE_ROWS in the materializing kernel, TOPK_ROWS in the
//     fused kernel's wide tile, one in its narrow tile (8 FMAs a row and
//     code, about 3 other instructions, and two shared loads a row in
//     the narrow tile, one in the wide);
//   * accumulation is plain fp32 FMA in a fixed sequential order over k,
//     and the epilogue uses unfused round-to-nearest ops in the plain
//     version's order, so both kernels produce the same score for the
//     same (query, row) element for element, whatever the tile;
//   * the fused kernel never writes the (m, n) score matrix: a block
//     walks a span of 512-row tiles (one tile when k~ < k) and keeps a
//     running top-L per query (L = min(k, k~)) behind a bound
//     (ash_select.cuh); each span emits its L keys a query to a key
//     strip, which one launch of ash_topk_merge_kernel (ash_select.cu)
//     reduces to the top-k on the card.  The tile follows m:
//       - narrow (m <= 8, and lists of more than 128 keys): a block of
//         512 threads takes MT queries, a thread one row; the tile's
//         64-bit (score desc, row asc) keys pass through shared memory to
//         one warp per query (span_topk), about two blocks per SM and
//         query chunk.  Four rows a thread (and the wide tile's
//         selection) measured slower at m = 8: the selection, not the
//         FMAs, bounds these calls;
//       - wide (m > 8): a block of 1,024 threads takes WIDE_QUERIES = 32
//         queries, so each row's words leave device memory once for 32
//         queries, not 8; a thread scores TOPK_ROWS = 2 rows against MT
//         queries; with no barrier between tiles, a warp compares its
//         scores with its queries' bounds and passes only the keys that
//         may beat them to a query's list, under the list's lock
//         (tiled_span_topk); one block an SM over all the query chunks.
//
// Each C entry point launches on the given stream and returns
// cudaGetLastError() so the wrapper can refuse a launch that failed.

#include "ash_select.cuh"

namespace {

constexpr int SCORE_THREADS = 256;  // threads per materializing block
constexpr int SCORE_ROWS = 3;       // rows per thread, sharing query loads
constexpr int SCORE_MIN_BLOCKS = 1; // __launch_bounds__ blocks an SM
// The fused scan's two tiles: narrow (a block of MT queries, a row a
// thread, span_topk) and wide (a block of WIDE_QUERIES queries, TOPK_ROWS
// rows x MT queries a thread, tiled_span_topk), for lists of at most
// 32 * WIDE_MAX_LANES keys.
constexpr int TOPK_ROWS = 2;
constexpr int WIDE_QUERIES = 32;
constexpr int WIDE_MAX_LANES = 4;

// q_s[k * QC + i] = q_proj[m0 + i, k], zero for queries past m.
template <int QC>
__device__ __forceinline__ void load_query_chunk(const ScanArgs& a, int d_pad,
                                                 int m0, float* q_s) {
  for (int t = threadIdx.x; t < d_pad * QC; t += blockDim.x) {
    int k = t / QC, i = t % QC;
    q_s[t] = (m0 + i < a.m) ? a.q_proj[(size_t)(m0 + i) * d_pad + k] : 0.f;
  }
}

// The shared routine of the kernels: unpack rows j[0..ROWS) (code_float,
// no conversion), accumulate each row's dot products with the MT queries
// m0 .. m0 + MT - 1, then apply the Eq. 20 epilogue acc*SCALE + <q, mu_c> +
// OFFSET and the metric tail.  Each of a row's MT sums is one sequential
// fp32 FMA chain over k, whatever ROWS is; the ROWS rows share each pair
// of 16-byte shared loads of the MT query values of a code dimension,
// which sit at q_s[k * QS .. k * QS + MT) (QS queries a code dimension in
// shared memory, MT of them this thread's).
template <int B, int METRIC, int ROWS, int QS = MT>
__device__ __forceinline__ void score_rows(const ScanArgs& a,
                                           const int (&j)[ROWS], int m0,
                                           const float* __restrict__ q_s,
                                           float (&out)[ROWS][MT]) {
  static_assert(QS % MT == 0, "whole 32-byte groups of query values");
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
      const float4 lo = q4[QS / 4 * (w * CPW + c)],
                   hi = q4[QS / 4 * (w * CPW + c) + 1];
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
  load_query_chunk<MT>(a, d_pad, m0, q_s);
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

// grid (n_spans, ceil(m / QC)): block (x, y) scores the tiles of span x
// against the QC queries of chunk y.  Narrow tile (QC = MT): a thread
// scores one row of a tile, and the tile's keys go through shared memory
// to a warp a query (span_topk).  Wide tile (QC = WIDE_QUERIES): a thread
// scores TOPK_ROWS rows against MT queries, and a warp passes only its
// candidates to a query's list, under the list's lock (tiled_span_topk,
// ash_select.cuh).
template <int QC>
struct Tile {
  static constexpr bool WIDE = QC != MT;
  static constexpr int THREADS =
      WIDE ? QC / MT * TOPK_BLOCK_N / TOPK_ROWS : TOPK_BLOCK_N;
  static constexpr int MIN_BLOCKS = WIDE ? 1 : 2;
  static_assert(QC % MT == 0 && THREADS <= 1024, "a block of whole groups");
};

template <int B, int METRIC, int N, int QC>
__global__ void __launch_bounds__(Tile<QC>::THREADS, Tile<QC>::MIN_BLOCKS)
    ash_score_topk_kernel(ScanArgs a, int d_pad,
                          const int32_t* __restrict__ mask, int L,
                          int tiles_per_span,
                          unsigned long long* __restrict__ strip) {
  extern __shared__ float4 smem_f4[];
  float* q_s = reinterpret_cast<float*>(smem_f4);
  const int m0 = blockIdx.y * QC;
  load_query_chunk<QC>(a, d_pad, m0, q_s);
  if constexpr (Tile<QC>::WIDE) {
    tiled_span_topk<N, QC / MT, TOPK_ROWS>(
        a, mask, L, tiles_per_span, gridDim.x, q_s + d_pad * QC, strip,
        [&](const int (&j)[TOPK_ROWS], int q0, float (&s)[TOPK_ROWS][MT]) {
          score_rows<B, METRIC, TOPK_ROWS, QC>(a, j, m0 + q0, q_s + q0, s);
        });
  } else {
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

// Shared bytes of the fused scan's block: the chunk's query values, then
// the selection's keys, lists, bounds (and the wide tile's locks).
template <int QC>
size_t topk_smem(int d_pad, int L) {
  if constexpr (Tile<QC>::WIDE)
    return (size_t)d_pad * QC * sizeof(float) + tiled_select_bytes<QC>(L);
  return (size_t)d_pad * MT * sizeof(float) + span_select_bytes(L);
}

template <int B, int METRIC, int N, int QC>
int launch_topk(ScanArgs a, int d_pad, const int32_t* mask, int L,
                int tiles_per_span, int n_spans, unsigned long long* strip,
                cudaStream_t stream) {
  const size_t smem = topk_smem<QC>(d_pad, L);
  static size_t smem_set[MAX_DEVICES] = {};
  int rc = set_smem_once(ash_score_topk_kernel<B, METRIC, N, QC>, smem,
                         smem_set);
  if (rc) return rc;
  dim3 grid(n_spans, (a.m + QC - 1) / QC);
  ash_score_topk_kernel<B, METRIC, N, QC>
      <<<grid, Tile<QC>::THREADS, smem, stream>>>(a, d_pad, mask, L,
                                                  tiles_per_span, strip);
  return (int)cudaGetLastError();
}

template <int QC>
struct TopkTile {
  template <int B, int METRIC>
  struct Launch {
    static int run(ScanArgs a, int d_pad, const int32_t* mask, int L,
                   int tiles_per_span, int n_spans, unsigned long long* strip,
                   cudaStream_t stream) {
      if constexpr (!Tile<QC>::WIDE) {
        SELECT_BY_LANES(L, (launch_topk<B, METRIC, LANES, QC>(
            a, d_pad, mask, L, tiles_per_span, n_spans, strip, stream)));
      } else {
        static_assert(WIDE_MAX_LANES == 4, "the wide tile's list lengths");
        switch (list_lanes(L)) {
          case 1: return launch_topk<B, METRIC, 1, QC>(
              a, d_pad, mask, L, tiles_per_span, n_spans, strip, stream);
          case 2: return launch_topk<B, METRIC, 2, QC>(
              a, d_pad, mask, L, tiles_per_span, n_spans, strip, stream);
          case 4: return launch_topk<B, METRIC, 4, QC>(
              a, d_pad, mask, L, tiles_per_span, n_spans, strip, stream);
          default: return (int)cudaErrorInvalidValue;
        }
      }
    }
  };
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
// A block takes `chunk` queries: MT (the narrow tile) or WIDE_QUERIES
// (the wide tile, L <= 32 * WIDE_MAX_LANES).
int ash_score_topk_launch(const void* codes, const void* q_proj,
                          const void* scale, const void* offset,
                          const void* cluster, const void* ipq,
                          const void* qterm, const void* rowterm,
                          const void* mask, void* strip, int n, int m, int wd,
                          int C, int b, int metric, int L, int tiles_per_span,
                          int n_spans, int chunk, void* stream) {
  if (b < 1 || b > 8 || n <= 0 || m <= 0 || L < 1 || L > TOPK_BLOCK_N ||
      tiles_per_span < 1 || n_spans < 1 ||
      (long long)n_spans * tiles_per_span * TOPK_BLOCK_N < n ||
      (chunk != MT && chunk != WIDE_QUERIES) ||
      (chunk == WIDE_QUERIES && list_lanes(L) > WIDE_MAX_LANES))
    return (int)cudaErrorInvalidValue;
  const int d_pad = wd * (32 / b);
  ScanArgs a = make_args(codes, q_proj, scale, offset, cluster, ipq, qterm,
                         rowterm, n, m, wd, C);
  const int32_t* mk = static_cast<const int32_t*>(mask);
  unsigned long long* st = static_cast<unsigned long long*>(strip);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (chunk == MT)
    return dispatch<TopkTile<MT>::Launch>(b, metric, a, d_pad, mk, L,
                                          tiles_per_span, n_spans, st, s);
  return dispatch<TopkTile<WIDE_QUERIES>::Launch>(b, metric, a, d_pad, mk, L,
                                                  tiles_per_span, n_spans, st,
                                                  s);
}

// Shared bytes a block of the fused scan takes at this d_pad, L and chunk.
size_t ash_score_topk_smem(int d_pad, int L, int chunk) {
  return chunk == MT ? topk_smem<MT>(d_pad, L)
                     : topk_smem<WIDE_QUERIES>(d_pad, L);
}

}  // extern "C"
