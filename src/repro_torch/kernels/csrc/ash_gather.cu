// Gathered ASH scan kernels for Hopper (sm_90a): query i scored against
// its own candidate rows rows[i] (IVF partial probes, coarse refine).
//
// Replaces (src/repro/kernels/ash_score.py):
//   ash_gather_kernel      <- ash_score_gather_pallas      (Eq. 20 + metric
//                                                           tail; pad id -1
//                                                           scores -inf)
//   ash_gather_topk_kernel <- ash_score_gather_topk_pallas (same scan +
//                                                           partial top-k~
//                                                           per tile of
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
//     an invalid key (kernel 4), and a selection tile with no live
//     candidate skips its sort;
//   * the block's query row sits in shared memory and is read as a
//     broadcast; the dot term is a sequential fp32 FMA over the code
//     dimensions and the epilogue uses unfused round-to-nearest ops, in
//     the order of the dense kernels' score_row, so a gathered score is
//     bit-equal to the dense kernel's score of the same (query, row);
//   * the fused kernel sorts 64-bit (score desc, POSITION asc) keys of a
//     512-position tile and emits the first k~: ties go to the lowest
//     candidate position, as in the reference.  The wrapper merges the
//     strip and maps positions back through rows.
//
// Each C entry point launches on the given stream and returns
// cudaGetLastError() so the wrapper can refuse a launch that failed.

#include "ash_common.cuh"

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

// grid (n_blocks, m): one 512-position tile of one query per block.
template <int B, int METRIC>
__global__ void __launch_bounds__(TOPK_BLOCK_N)
    ash_gather_topk_kernel(ScanArgs a, const int32_t* __restrict__ rows,
                           int R, int d_pad, bool vec4, int k_tilde,
                           int strip, float* __restrict__ vals,
                           int32_t* __restrict__ ids) {
  extern __shared__ float4 smem_f4[];
  float* q_s = reinterpret_cast<float*>(smem_f4);
  unsigned long long* keys =
      reinterpret_cast<unsigned long long*>(q_s + d_pad);
  const int qi = blockIdx.y;
  load_query_row(a, d_pad, qi, q_s);
  __syncthreads();

  const int col = threadIdx.x;
  const int t = blockIdx.x * TOPK_BLOCK_N + col;
  const int j = (t < R) ? __ldg(rows + (size_t)qi * R + t) : -1;
  const bool valid = j >= 0;
  keys[col] = valid ? make_key(score_one<B, METRIC>(a, j, qi, q_s, vec4), col)
                    : INVALID_KEY;
  // a tile of padding only is already in order: every key is invalid
  if (__syncthreads_or(valid)) bitonic_sort_rows(keys, 1);
  emit_strip(keys, 1, qi, k_tilde, strip, blockIdx.x * TOPK_BLOCK_N, vals,
             ids);
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

template <int B, int METRIC>
struct LaunchGatherTopk {
  static int run(ScanArgs a, const int32_t* rows, int R, int d_pad, bool vec4,
                 int k_tilde, int n_blocks, float* vals, int32_t* ids,
                 cudaStream_t stream) {
    const size_t smem = (size_t)d_pad * sizeof(float) +
                        (size_t)TOPK_BLOCK_N * sizeof(unsigned long long);
    int rc = set_smem(ash_gather_topk_kernel<B, METRIC>, smem);
    if (rc) return rc;
    dim3 grid(n_blocks, a.m);
    ash_gather_topk_kernel<B, METRIC><<<grid, TOPK_BLOCK_N, smem, stream>>>(
        a, rows, R, d_pad, vec4, k_tilde, n_blocks * k_tilde, vals, ids);
    return (int)cudaGetLastError();
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

// (m, n_blocks * k_tilde) candidate strip of (score, position) into
// vals/ids; positions with a pad id never surface.
int ash_gather_topk_launch(const void* codes, const void* rows,
                           const void* q_proj, const void* scale,
                           const void* offset, const void* cluster,
                           const void* ipq, const void* qterm,
                           const void* rowterm, void* vals, void* ids, int n,
                           int m, int R, int wd, int C, int b, int metric,
                           int k_tilde, int n_blocks, void* stream) {
  if (b < 1 || b > 8 || n <= 0 || m <= 0 || m > 65535 || R <= 0 ||
      k_tilde < 1 || k_tilde > TOPK_BLOCK_N || n_blocks * TOPK_BLOCK_N < R)
    return (int)cudaErrorInvalidValue;
  const int d_pad = wd * (32 / b);
  ScanArgs a = make_args(codes, q_proj, scale, offset, cluster, ipq, qterm,
                         rowterm, n, m, wd, C);
  return dispatch<LaunchGatherTopk>(
      b, metric, a, static_cast<const int32_t*>(rows), R, d_pad,
      rows_vec4(codes, wd), k_tilde, n_blocks, static_cast<float*>(vals),
      static_cast<int32_t*>(ids), static_cast<cudaStream_t>(stream));
}

}  // extern "C"
