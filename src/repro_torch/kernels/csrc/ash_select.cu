// The strip merge of the fused dense, gathered and coarse scans for
// Hopper (sm_90a): the (m, width) strip of 64-bit selection keys that
// ash_score_topk_kernel, ash_gather_topk_kernel and ash_coarse_topk_kernel
// emit (one sorted list per span) reduced to each query's top-k on the
// card; for the gathered scan the selected candidate positions are also
// mapped back to payload rows through the candidate table.
//
// Replaces the host-side merge of the strip (two stable sorts, four
// gathers and a where, then positions_to_rows for the gathered scan)
// that followed the TPU kernels' per-tile partial top-k~
// (src/repro/kernels/ash_score.py: ash_score_topk_pallas,
// ash_score_gather_topk_pallas and ash_score_coarse_topk_pallas merge
// theirs with lax.sort); its plain version is ref.merge_strip
// (ref.merge_keys_ref, then ref.positions_to_rows).
//
// What bounds it on the H100: latency.  The strip is small (8 bytes a
// key: 24,500 keys a query at k = 100 over 245 spans) and one block
// reduces one query's row, so the time is the chain of loads, sorts and
// merges, not bytes or operations.
//
// What the design does about it: one block of 16 warps per query.  The
// strip is a row of sorted span lists: warp 0 first sorts the heads of
// the lists and takes a bound from them (k lists have a key at or
// below their k-th smallest head): at k = 100 over 245 lists only a few
// hundred keys beat it.  Each warp takes 256 keys of every 4096 (the
// next 256 loading while it works) into its own running top-k list under
// one shared bound (ash_select.cuh), with no block barrier; a pairwise
// tree merges the 16 lists at the end.  Keys are unique (the scans key
// each row or candidate position once), so the result is the exact
// (score desc, id asc) top-k of the strip; INVALID keys (exhausted span
// slots) never enter, and missing slots come back as (-inf, -1).  k is
// at most 512.
//
// The C entry point launches on the given stream and returns
// cudaGetLastError() so the wrapper can refuse a launch that failed.

#include "ash_select.cuh"

namespace {

constexpr int MERGE_THREADS = 512;
constexpr int MERGE_WARPS = MERGE_THREADS / 32;
constexpr int MERGE_MAX_K = 512;

template <int N>
__global__ void __launch_bounds__(MERGE_THREADS)
    ash_topk_merge_kernel(const unsigned long long* __restrict__ keys,
                          const int32_t* __restrict__ rows, int R,
                          int width, int k, int run,
                          float* __restrict__ vals,
                          int32_t* __restrict__ ids) {
  constexpr int LR = 32 * N;
  extern __shared__ unsigned long long smem_u64[];
  unsigned long long* lists = smem_u64;                  // [warps][LR]
  unsigned long long* bufs = lists + MERGE_WARPS * LR;   // [warps][256]
  unsigned long long* bound = bufs + MERGE_WARPS * WARP_KEYS;
  for (int t = threadIdx.x; t < MERGE_WARPS * LR; t += blockDim.x)
    lists[t] = INVALID_KEY;
  const int w = threadIdx.x >> 5, lane = lane_id();
  const unsigned long long* row = keys + (size_t)blockIdx.x * width;
  if (w == 0) {
    // a first bound from the heads of the strip's sorted runs (the
    // spans' lists): the q-th keys of the first <= 256 runs, each with q
    // keys at or below it, so the k'-th smallest of them, k' * q >= k,
    // has at least k keys at or below it
    unsigned long long b = INVALID_KEY;
    const int n_run = min(width / run, WARP_KEYS);
    const int q = (k + n_run - 1) / n_run;
    if (q <= run) {
      unsigned long long v[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int s = 8 * lane + i;
        v[i] = s < n_run ? __ldg(row + (size_t)s * run + q - 1) : INVALID_KEY;
      }
      warp_sort<8>(v);
      store_list<8>(v, bufs);
      __syncwarp();
      const unsigned long long head = bufs[(k + q - 1) / q - 1];  // k' <= n_run
      b = head == INVALID_KEY ? INVALID_KEY : head + 1;
    }
    if (lane == 0) *bound = b;
  }
  __syncthreads();
  // warp w takes keys [step + 256 w, step + 256 (w + 1)) of each step of
  // 4096, the next step's loads in flight while it absorbs this one's
  auto load = [&](int step, unsigned long long (&k8)[8]) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int idx = step + w * WARP_KEYS + i * 32 + lane;
      k8[i] = idx < width ? __ldg(row + idx) : INVALID_KEY;
    }
  };
  constexpr int STEP = MERGE_WARPS * WARP_KEYS;
  unsigned long long cur[8], nxt[8];
  load(0, cur);
  for (int step = 0; step < width; step += STEP) {
    load(step + STEP, nxt);
    warp_absorb<N>(cur, bufs + w * WARP_KEYS, lists + w * LR, bound, k);
#pragma unroll
    for (int i = 0; i < 8; ++i) cur[i] = nxt[i];
  }
  merge_lists<N>(lists, MERGE_WARPS);
  for (int t = threadIdx.x; t < k; t += blockDim.x) {
    const unsigned long long key = lists[t];
    const size_t o = (size_t)blockIdx.x * k + t;
    if (key == INVALID_KEY) {
      vals[o] = -__int_as_float(0x7f800000);  // -inf
      ids[o] = -1;
    } else {
      const int32_t id = (int32_t)(key & 0xffffffffu);
      vals[o] = key_score(key);
      ids[o] = rows ? __ldg(rows + (size_t)blockIdx.x * R + id) : id;
    }
  }
}

template <int N>
int launch_merge(const void* keys, const void* rows, void* vals, void* ids,
                 int m, int width, int k, int run, int R,
                 cudaStream_t stream) {
  const size_t smem = sizeof(unsigned long long) *
                      ((size_t)MERGE_WARPS * (32 * N + WARP_KEYS) + 1);
  static size_t smem_set[MAX_DEVICES] = {};
  int rc = set_smem_once(ash_topk_merge_kernel<N>, smem, smem_set);
  if (rc) return rc;
  ash_topk_merge_kernel<N><<<m, MERGE_THREADS, smem, stream>>>(
      static_cast<const unsigned long long*>(keys),
      static_cast<const int32_t*>(rows), R, width, k, run,
      static_cast<float*>(vals), static_cast<int32_t*>(ids));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// (m, k) f32 scores and int32 ids, (score desc, id asc), of the
// (m, width) key strip, each row width / run ascending runs of `run`
// keys (the spans' lists); -1 ids (and -inf) past the valid keys.  With
// `rows` (m, R) int32 (may be null) a selected id i of row q is written
// as rows[q, i]: the gathered scan keys candidate positions.
int ash_topk_merge_launch(const void* keys, const void* rows, void* vals,
                          void* ids, int m, int width, int k, int run, int R,
                          void* stream) {
  if (m <= 0 || width <= 0 || k < 1 || k > MERGE_MAX_K || run < 1 ||
      width % run != 0 || (rows != nullptr && R <= 0))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  SELECT_BY_LANES(k, (launch_merge<LANES>(keys, rows, vals, ids, m, width,
                                          k, run, R, st)));
}

}  // extern "C"
