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
// 5 FLOP/byte, under the card's 20 FLOP/byte fp32 ridge.
//
// What the design does about it:
//   * the TPU kernel's scalar-prefetched row table and per-candidate DMA
//     become one thread per candidate position: it loads its row id and
//     reads the candidate's packed words straight from device memory,
//     as 16-byte loads when the row is a multiple of 16 bytes; inverted
//     lists are contiguous row ranges, so neighbouring threads read
//     neighbouring rows;
//   * a pad id (-1) loads nothing: its thread writes -inf (kernel 3) or
//     an invalid key that never enters a selection (kernel 4);
//   * the block's query row sits in shared memory and is read as a
//     broadcast; the dot term is a sequential fp32 FMA over the code
//     dimensions and the epilogue uses unfused round-to-nearest ops, in
//     the order of the dense kernels' score_row, so a gathered score is
//     bit-equal to the dense kernel's score of the same (query, row);
//   * the fused kernel (kernel 4) keys each score as 64 bits (score
//     desc, POSITION asc: ties go to the lowest candidate position, as
//     in the reference).  A block walks a span of 512-position tiles of
//     one query's table (about two blocks per SM over all queries,
//     ref.gather_span_geometry; one-tile spans when k~ < k, which keeps
//     the reference's per-tile strip).  Two 512-thread blocks are
//     resident on an SM only where an instance takes at most 64
//     registers.  ptxas gives 64 to the b <= 4 instances with lists of
//     up to 256 keys (the main path's, b = 2 with 128 keys, spills 60
//     bytes there), except b = 1 with 256 keys under l2 or cos (96); the
//     512-key and most b = 8 instances take 89-114 and fit one block, so
//     their grid runs as two waves.  Each warp scores its positions of
//     8 tiles at a time, 8 a lane (score_one, so bit-equal to kernel 3),
//     and takes those beating the bound into its own running top-L list
//     (ash_select.cuh: the bound is shared by the block's 16 warps), with
//     no block barrier until the span ends; the lists are then merged
//     and the span's L keys written to a strip, which
//     ash_topk_merge_kernel (ash_select.cu) reduces to the top-k and maps
//     back through rows on the card: one scan launch and one merge
//     launch, nothing on the host.
//
// Each C entry point launches on the given stream and returns
// cudaGetLastError() so the wrapper can refuse a launch that failed.

#include "ash_select.cuh"

namespace {

constexpr int GATHER_THREADS = 256;  // candidate positions per block

// q_s[k] = q_proj[qi, k].
__device__ __forceinline__ void load_query_row(const ScanArgs& a, int d_pad,
                                               int qi, float* q_s) {
  for (int k = threadIdx.x; k < d_pad; k += blockDim.x)
    q_s[k] = a.q_proj[(size_t)qi * d_pad + k];
}

template <int B>
__device__ __forceinline__ float accumulate_word(uint32_t word,
                                                 const float* __restrict__ qk,
                                                 float acc) {
  constexpr int CPW = 32 / B;
#pragma unroll
  for (int c = 0; c < CPW; ++c)
    acc = fmaf(qk[c], (float)code_value<B>(word, c), acc);
  return acc;
}

// One-query form of score_row (ash_score.cu): the same sequential FMA
// over the code dimensions and the same epilogue, for row j of query qi.
template <int B, int METRIC>
__device__ __forceinline__ float score_one(const ScanArgs& a, int j, int qi,
                                           const float* __restrict__ q_s,
                                           bool vec4) {
  constexpr int CPW = 32 / B;
  float acc = 0.f;
  const uint32_t* row = a.codes + (size_t)j * a.wd;
  if (vec4) {
    const uint4* row4 = reinterpret_cast<const uint4*>(row);
    for (int w4 = 0; w4 < a.wd / 4; ++w4) {
      const uint4 u = __ldg(row4 + w4);
      const float* qk = q_s + 4 * w4 * CPW;
      acc = accumulate_word<B>(u.x, qk, acc);
      acc = accumulate_word<B>(u.y, qk + CPW, acc);
      acc = accumulate_word<B>(u.z, qk + 2 * CPW, acc);
      acc = accumulate_word<B>(u.w, qk + 3 * CPW, acc);
    }
  } else {
    for (int w = 0; w < a.wd; ++w)
      acc = accumulate_word<B>(__ldg(row + w), q_s + w * CPW, acc);
  }
  const float sc = __ldg(a.scale + j);
  const float off = __ldg(a.offset + j);
  const int cl = __ldg(a.cluster + j);
  const float bias = __ldg(a.ipq + (size_t)qi * a.C + cl);
  const float rt = (METRIC == METRIC_DOT) ? 0.f : __ldg(a.rowterm + j);
  const float qt = (METRIC == METRIC_DOT) ? 0.f : __ldg(a.qterm + qi);
  return metric_tail<METRIC>(eq20_base(acc, sc, bias, off), qt, rt);
}

// grid (ceil(R / GATHER_THREADS), m): one query per block row.
template <int B, int METRIC>
__global__ void __launch_bounds__(GATHER_THREADS)
    ash_gather_kernel(ScanArgs a, const int32_t* __restrict__ rows, int R,
                      int d_pad, bool vec4, float* __restrict__ out) {
  extern __shared__ float4 smem_f4[];
  float* q_s = reinterpret_cast<float*>(smem_f4);
  const int qi = blockIdx.y;
  load_query_row(a, d_pad, qi, q_s);
  __syncthreads();
  const int t = blockIdx.x * GATHER_THREADS + threadIdx.x;
  if (t >= R) return;
  const size_t o = (size_t)qi * R + t;
  const int j = __ldg(rows + o);
  out[o] = (j >= 0) ? score_one<B, METRIC>(a, j, qi, q_s, vec4)
                    : -__int_as_float(0x7f800000);
}

// grid (n_spans, m): block (x, qi) walks tiles [x * tiles_per_span, ...)
// of query qi's candidate table; thread c of the block scores position
// tile * TOPK_BLOCK_N + c of each, warp w keeps its list of LR = 32N keys,
// and the span's first L keys of the merged lists go to its strip slots.
template <int B, int METRIC, int N>
__global__ void __launch_bounds__(TOPK_BLOCK_N)
    ash_gather_topk_kernel(ScanArgs a, const int32_t* __restrict__ rows,
                           int R, int d_pad, bool vec4, int L,
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
      k8[i] = j >= 0 ? make_key(score_one<B, METRIC>(a, j, qi, q_s, vec4), pos)
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
  static int run(ScanArgs a, const int32_t* rows, int R, int d_pad, bool vec4,
                 float* out, cudaStream_t stream) {
    const size_t smem = (size_t)d_pad * sizeof(float);
    int rc = set_smem(ash_gather_kernel<B, METRIC>, smem);
    if (rc) return rc;
    dim3 grid((R + GATHER_THREADS - 1) / GATHER_THREADS, a.m);
    ash_gather_kernel<B, METRIC><<<grid, GATHER_THREADS, smem, stream>>>(
        a, rows, R, d_pad, vec4, out);
    return (int)cudaGetLastError();
  }
};

template <int B, int METRIC, int N>
int launch_gather_topk(ScanArgs a, const int32_t* rows, int R, int d_pad,
                       bool vec4, int L, int per, int n_spans,
                       unsigned long long* strip, cudaStream_t stream) {
  const size_t smem =
      (size_t)d_pad * sizeof(float) +
      sizeof(unsigned long long) *
          ((size_t)(TOPK_BLOCK_N / 32) * (32 * N + WARP_KEYS) + 1);
  static size_t smem_set = 48 * 1024;
  int rc = set_smem_once(ash_gather_topk_kernel<B, METRIC, N>, smem,
                         &smem_set);
  if (rc) return rc;
  dim3 grid(n_spans, a.m);
  ash_gather_topk_kernel<B, METRIC, N><<<grid, TOPK_BLOCK_N, smem, stream>>>(
      a, rows, R, d_pad, vec4, L, per, n_spans, strip);
  return (int)cudaGetLastError();
}

template <int B, int METRIC>
struct LaunchGatherTopk {
  static int run(ScanArgs a, const int32_t* rows, int R, int d_pad, bool vec4,
                 int L, int per, int n_spans, unsigned long long* strip,
                 cudaStream_t stream) {
    SELECT_BY_LANES(L, (launch_gather_topk<B, METRIC, LANES>(
                           a, rows, R, d_pad, vec4, L, per, n_spans, strip,
                           stream)));
  }
};

// 16-byte row loads need 16-byte rows and a 16-byte aligned base.
bool rows_vec4(const void* codes, int wd) {
  return wd % 4 == 0 && (reinterpret_cast<uintptr_t>(codes) & 15u) == 0;
}

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
                                R, d_pad, rows_vec4(codes, wd),
                                static_cast<float*>(out),
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
      b, metric, a, static_cast<const int32_t*>(rows), R, d_pad,
      rows_vec4(codes, wd), L, tiles_per_span, n_spans,
      static_cast<unsigned long long*>(strip),
      static_cast<cudaStream_t>(stream));
}

}  // extern "C"
