// Running top-L selection behind a threshold, one list per warp, for the
// fused dense, gathered and coarse scans (ash_score.cu, ash_gather.cu,
// ash_coarse.cu) and the strip merge (ash_select.cu).
//
// Keys are 64-bit: make_key order (score descending, then id ascending;
// ids are unique, so the order is total), INVALID_KEY for a row that
// never enters.  A warp owns a sorted list of LR = 32N keys in shared
// memory (lane l reads and writes elements N*l .. N*l + N - 1) and a
// shared bound per query: the smallest L-th key of the lists that feed
// that query.  Every list holds at least L keys at or below its own L-th
// key, so a key of the final top-L not yet in a list is below the bound
// (keys are unique), and a key that is not never needs to be seen again.
//
// A warp takes 256 keys at a time (8 a lane): one compare each against
// the bound, then, if any pass, the survivors are compacted with warp
// ballots, sorted in registers (a bitonic network of 32, 64, 128 or 256
// keys, shuffles between lanes) and merged into the list: the smaller
// of list[i] and run[LR - 1 - i] are the LR smallest of both, in bitonic
// order, which log2(LR) half-cleaner stages sort.  No block barrier is
// involved.  For keys in random order the bound soon sits near the L-th
// key of everything seen, so only about L * (1 + ln(S / L)) of S keys
// survive and the scan pays for little more than the compare; keys in
// improving order all survive and only cost time.
#pragma once

#include "ash_common.cuh"

namespace {

constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int WARP_KEYS = 256;  // keys a warp takes at a time, 8 a lane

__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }

// One compare-exchange stage (block `size`, stride `st`) of an ascending
// bitonic network over the 32N keys a warp holds, lane l holding
// elements N*l .. N*l + N - 1: strides below N compare within a lane,
// the others exchange with lane ^ (st / N).
template <int N>
__device__ __forceinline__ void bitonic_stage(unsigned long long (&v)[N],
                                              int size, int st) {
  const int lane = lane_id();
  if (st >= N) {
    const int ls = st / N;
    const bool keep_min = ((lane & ls) == 0) == (((lane * N) & size) == 0);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const unsigned long long y = __shfl_xor_sync(FULL_MASK, v[i], ls);
      v[i] = keep_min ? min(v[i], y) : max(v[i], y);
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if (i & st) continue;
      const bool asc = (((lane * N) | i) & size) == 0;
      const unsigned long long x = v[i], y = v[i | st];
      v[i] = asc ? min(x, y) : max(x, y);
      v[i | st] = asc ? max(x, y) : min(x, y);
    }
  }
}

template <int N>
__device__ __forceinline__ void warp_sort(unsigned long long (&v)[N]) {
#pragma unroll
  for (int size = 2; size <= 32 * N; size <<= 1)
#pragma unroll
    for (int st = size >> 1; st > 0; st >>= 1) bitonic_stage<N>(v, size, st);
}

// a (32N keys, sorted) <- the 32N smallest of a and of the ascending
// run[0, len) in shared memory.
template <int N>
__device__ __forceinline__ void merge_run(unsigned long long (&a)[N],
                                          const unsigned long long* run,
                                          int len) {
  const int lane = lane_id();
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int e = 32 * N - 1 - (N * lane + i);
    if (e < len) a[i] = min(a[i], run[e]);
  }
#pragma unroll
  for (int st = 16 * N; st > 0; st >>= 1) bitonic_stage<N>(a, 32 * N, st);
}

template <int N>
__device__ __forceinline__ void load_list(unsigned long long (&a)[N],
                                          const unsigned long long* list) {
#pragma unroll
  for (int i = 0; i < N; ++i) a[i] = list[N * lane_id() + i];
}

template <int N>
__device__ __forceinline__ void store_list(const unsigned long long (&a)[N],
                                           unsigned long long* list) {
#pragma unroll
  for (int i = 0; i < N; ++i) list[N * lane_id() + i] = a[i];
}

// Sort the `len` keys at buf[0, len) (len <= 32M) into buf, ascending.
template <int M>
__device__ __forceinline__ void sort_run(unsigned long long* buf, int len) {
  const int lane = lane_id();
  unsigned long long v[M];
#pragma unroll
  for (int j = 0; j < M; ++j)
    v[j] = M * lane + j < len ? buf[M * lane + j] : INVALID_KEY;
  warp_sort<M>(v);
  __syncwarp();
#pragma unroll
  for (int j = 0; j < M; ++j) buf[M * lane + j] = v[j];
  __syncwarp();
}

// A warp takes k8[0..8) a lane (256 keys): keys below *bound are
// compacted into buf (256 slots this warp may overwrite), sorted and
// merged into the warp's list of 32N keys; the list's L-th key then
// lowers *bound.  Every lane of the warp calls it.
template <int N>
__device__ __forceinline__ void warp_absorb(const unsigned long long (&k8)[8],
                                            unsigned long long* buf,
                                            unsigned long long* list,
                                            unsigned long long* bound,
                                            int L) {
  const int lane = lane_id();
  const unsigned long long b = *bound;
  unsigned pass = 0u;
  int total = 0;
  unsigned ballots[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    ballots[i] = __ballot_sync(FULL_MASK, k8[i] < b);
    pass |= (k8[i] < b ? 1u : 0u) << i;
    total += __popc(ballots[i]);
  }
  if (total == 0) return;
  __syncwarp();  // buf may still be read by this warp's lanes
  int base = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if (pass & (1u << i))
      buf[base + __popc(ballots[i] & ((1u << lane) - 1u))] = k8[i];
    base += __popc(ballots[i]);
  }
  __syncwarp();
  if (total <= 32)
    sort_run<1>(buf, total);
  else if (total <= 64)
    sort_run<2>(buf, total);
  else if (total <= 128)
    sort_run<4>(buf, total);
  else
    sort_run<8>(buf, total);
  unsigned long long a[N];
  load_list<N>(a, list);
  merge_run<N>(a, buf, total);
  store_list<N>(a, list);
  __syncwarp();
  if (lane == 0) atomicMin(bound, list[L - 1]);
  __syncwarp();
}

// Pairwise tree over `n_lists` lists of 32N keys (list w at lists + w *
// 32N): list 0 ends as the 32N smallest of all.  Every thread of the
// block calls it; starts and ends on a barrier.
template <int N>
__device__ __forceinline__ void merge_lists(unsigned long long* lists,
                                            int n_lists) {
  const int w = threadIdx.x >> 5;
  __syncthreads();
  for (int h = 1; h < n_lists; h <<= 1) {
    if (w % (2 * h) == 0 && w + h < n_lists) {
      unsigned long long a[N];
      load_list<N>(a, lists + (size_t)w * 32 * N);
      merge_run<N>(a, lists + (size_t)(w + h) * 32 * N, 32 * N);
      store_list<N>(a, lists + (size_t)w * 32 * N);
    }
    __syncthreads();
  }
}

// Keys per lane of the lists for a top-L (L <= 512): the smallest power
// of two N with 32N >= L.
__host__ __device__ __forceinline__ int list_lanes(int L) {
  int n = 1;
  while (32 * n < L) n <<= 1;
  return n;
}

// `return CALL;` with the constant LANES = list_lanes(L) in scope.
#define SELECT_BY_LANES(L, CALL)                  \
  switch (list_lanes(L)) {                        \
    case 1: { constexpr int LANES = 1; return CALL; } \
    case 2: { constexpr int LANES = 2; return CALL; } \
    case 4: { constexpr int LANES = 4; return CALL; } \
    case 8: { constexpr int LANES = 8; return CALL; } \
    default: { constexpr int LANES = 16; return CALL; } \
  }

// -- the fused scan's span loop --------------------------------------------
// Block (x, y) walks tiles [x * tiles_per_span, ...) of TOPK_BLOCK_N rows
// for the MT queries of chunk y.  Each thread scores one row of a tile
// (`score(j, s)` fills s[MT]); the keys go through shared memory, and
// warp r takes query r's keys of the tile, 256 at a time, into the
// query's list.  Rows masked out never enter.  At the end the first L
// keys of each list go to the span's slots of the (m, n_spans * L) strip.
static_assert(TOPK_BLOCK_N == 2 * WARP_KEYS && TOPK_BLOCK_N / 32 >= MT,
              "a warp per query, a tile in two takes");

__host__ __device__ __forceinline__ size_t span_select_bytes(int L) {
  return sizeof(unsigned long long) *
         ((size_t)MT * TOPK_BLOCK_N +                 // the tile's keys
          (size_t)MT * 32 * list_lanes(L) + MT);      // lists, bounds
}

template <int N, typename ScoreRow>
__device__ __forceinline__ void span_topk(const ScanArgs& a,
                                          const int32_t* __restrict__ mask,
                                          int L, int tiles_per_span,
                                          int n_spans, void* sel_base,
                                          unsigned long long* __restrict__ strip,
                                          ScoreRow score) {
  constexpr int LR = 32 * N;
  const int m0 = blockIdx.y * MT;
  const int mc = min(MT, a.m - m0);
  unsigned long long* keys = static_cast<unsigned long long*>(sel_base);
  unsigned long long* lists = keys + MT * TOPK_BLOCK_N;  // [MT][LR]
  unsigned long long* bound = lists + MT * LR;            // [MT]
  for (int t = threadIdx.x; t < MT * LR; t += blockDim.x)
    lists[t] = INVALID_KEY;
  if (threadIdx.x < MT) bound[threadIdx.x] = INVALID_KEY;
  const int r = threadIdx.x >> 5;  // the query of warp r < MT
  const int n_tiles = (a.n + TOPK_BLOCK_N - 1) / TOPK_BLOCK_N;
  const int t0 = blockIdx.x * tiles_per_span;
  const int t1 = min(t0 + tiles_per_span, n_tiles);
  for (int tile = t0; tile < t1; ++tile) {
    const int j = tile * TOPK_BLOCK_N + threadIdx.x;
    const bool valid = j < a.n && (mask == nullptr || __ldg(mask + j) != 0);
    float sc[MT] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (j < a.n) score(j, sc);
    __syncthreads();  // the previous tile's keys are taken
#pragma unroll
    for (int i = 0; i < MT; ++i)
      keys[i * TOPK_BLOCK_N + threadIdx.x] =
          valid ? make_key(sc[i], j) : INVALID_KEY;
    __syncthreads();
    if (r < mc) {
#pragma unroll 1
      for (int h = 0; h < TOPK_BLOCK_N; h += WARP_KEYS) {
        unsigned long long* mine = keys + r * TOPK_BLOCK_N + h;
        unsigned long long k8[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) k8[i] = mine[i * 32 + lane_id()];
        warp_absorb<N>(k8, mine, lists + (size_t)r * LR, bound + r, L);
      }
    }
  }
  __syncwarp();
  if (r < mc) {
    const size_t width = (size_t)n_spans * L;
    unsigned long long* out =
        strip + (size_t)(m0 + r) * width + (size_t)blockIdx.x * L;
    for (int i = lane_id(); i < L; i += 32) out[i] = lists[(size_t)r * LR + i];
  }
}

// -- the register-tiled dense scan's span loop (ash_score.cu) ---------------
// Block (x, y) walks tiles [x * tiles_per_span, ...) of TOPK_BLOCK_N rows
// for the QC = G * MT queries of chunk y.  Thread (g, u), g = tid / T with
// T = TOPK_BLOCK_N / ROWS threads a group, scores rows u, u + T, ..,
// u + (ROWS - 1) T of a tile against the MT queries g*MT .. g*MT + MT - 1
// (`score(j, q0, s)` fills s[ROWS][MT] for clamped rows j and the
// group's first query q0), so every warp serves one query group.  Each
// query has one list in shared memory, fed by the warps of its group
// under a lock, and no block barrier stands between two tiles: a warp
// compares its 32 * ROWS scores of a query with the query's bound (a
// score below the bound's score cannot beat it; ties and NaN go on), and
// where any lane holds a candidate, the warp takes the query's lock and
// absorbs its candidates (warp_absorb: exact compares with the bound, a
// sort of at most 32 * ROWS keys in `take`, its own shared slots, and a
// merge).  The bound a warp reads outside the lock may be older than the
// list's, which only lets more keys through.  The warps of a group drift
// apart, so one warp's selection and loads overlap the others' FMAs.
template <int QC>
__host__ __device__ __forceinline__ size_t tiled_select_bytes(int L) {
  return sizeof(unsigned long long) *
             ((size_t)QC * 32 * list_lanes(L) + QC +  // lists, bounds
              (size_t)(QC / MT) * TOPK_BLOCK_N) +     // each warp's take
         sizeof(int) * QC;                            // locks
}

template <int N, int G, int ROWS, typename ScoreRows>
__device__ __forceinline__ void tiled_span_topk(
    const ScanArgs& a, const int32_t* __restrict__ mask, int L,
    int tiles_per_span, int n_spans, void* sel_base,
    unsigned long long* __restrict__ strip, ScoreRows score) {
  constexpr int LR = 32 * N;
  constexpr int QC = G * MT;
  constexpr int T = TOPK_BLOCK_N / ROWS;
  constexpr int WARPS = G * T / 32;
  static_assert(T % 32 == 0 && (ROWS & (ROWS - 1)) == 0 && ROWS <= 8,
                "whole warps a group, a power-of-two take of 8 keys a lane");
  const int m0 = blockIdx.y * QC;
  const int mc = min(QC, a.m - m0);
  unsigned long long* lists = static_cast<unsigned long long*>(sel_base);
  unsigned long long* bound = lists + QC * LR;                  // [QC]
  unsigned long long* takes = bound + QC;                        // [WARPS]
  int* lock = reinterpret_cast<int*>(takes + WARPS * 32 * ROWS);  // [QC]
  for (int t = threadIdx.x; t < QC * LR; t += blockDim.x)
    lists[t] = INVALID_KEY;
  if (threadIdx.x < QC) {
    bound[threadIdx.x] = INVALID_KEY;
    lock[threadIdx.x] = 0;
  }
  __syncthreads();
  const int lane = lane_id(), w = threadIdx.x >> 5;
  unsigned long long* take = takes + (size_t)w * 32 * ROWS;
  const int u = threadIdx.x % T, q0 = (threadIdx.x / T) * MT;
  const int nq = max(0, min(MT, mc - q0));  // the group's live queries
  const int n_tiles = (a.n + TOPK_BLOCK_N - 1) / TOPK_BLOCK_N;
  const int t0 = blockIdx.x * tiles_per_span;
  const int t1 = nq > 0 ? min(t0 + tiles_per_span, n_tiles) : t0;
  for (int tile = t0; tile < t1; ++tile) {
    int j[ROWS];
    unsigned ok = 0u;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int jr = tile * TOPK_BLOCK_N + u + r * T;
      if (jr < a.n && (mask == nullptr || __ldg(mask + jr) != 0))
        ok |= 1u << r;
      j[r] = min(jr, a.n - 1);
    }
    float s[ROWS][MT];
    score(j, q0, s);
    unsigned pend = 0u;  // the queries some lane holds a candidate of
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const float bs = key_score(bound[q0 + i]);
      bool any = false;
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
        any |= ((ok >> r) & 1u) && !(s[r][i] < bs);
      if (__any_sync(FULL_MASK, any && i < nq)) pend |= 1u << i;
    }
    while (pend) {  // one absorb site: the code stays one network long
      const int i = __ffs(pend) - 1;
      pend &= pend - 1u;
      float si[ROWS];
#pragma unroll
      for (int c = 0; c < MT; ++c)
#pragma unroll
        for (int r = 0; r < ROWS; ++r)
          if (c == i) si[r] = s[r][c];
      const float bs = key_score(bound[q0 + i]);
      unsigned long long k8[8];
#pragma unroll
      for (int r = 0; r < 8; ++r)
        k8[r] = r < ROWS && ((ok >> r) & 1u) && !(si[r] < bs)
                    ? make_key(si[r], tile * TOPK_BLOCK_N + u + r * T)
                    : INVALID_KEY;
      int* held = lock + q0 + i;
      if (lane == 0)
        while (atomicCAS(held, 0, 1) != 0) {
        }
      __syncwarp();
      __threadfence_block();  // the list as the last holder left it
      warp_absorb<N>(k8, take, lists + (size_t)(q0 + i) * LR, bound + q0 + i,
                     L);
      __threadfence_block();
      __syncwarp();
      if (lane == 0) atomicExch(held, 0);
    }
  }
  __syncthreads();
  const size_t width = (size_t)n_spans * L;
  for (int q = w; q < mc; q += WARPS) {
    unsigned long long* out =
        strip + (size_t)(m0 + q) * width + (size_t)blockIdx.x * L;
    for (int i = lane; i < L; i += 32) out[i] = lists[(size_t)q * LR + i];
  }
}

}  // namespace
