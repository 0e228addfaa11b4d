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
// codes and 12 of headers, and the materializing kernel writes 4*m bytes
// of scores a row (44 MB in, 32 MB out at n = 10^6, m = 8: 0.0227 ms at
// 3.35 TB/s), against 2*m*d_pad integer operations a row (2048 at m = 8,
// d_pad = 128: 0.0010 ms at the card's 1,979 TOP/s int8 tensor-core
// rate).  A scan on the integer pipes spends ~24 instructions a code
// quadruple on building grid values and dp4a, which held the first port
// of kernel 5 at twice its bound; the work left beside the loads has to
// be a few instructions a row.
//
// The arithmetic of both kernels: byte planes.  For b in {1, 2, 4, 8},
// plane s of a packed word, (word >> b*s) & M_b (M_b: b ones in each
// byte, 0x03030303 at b = 2), holds four of the word's codes as unsigned
// bytes with no per-code work: byte c holds the level l of code
// c*(8/b) + s.  The query's int8 values are laid out in the same
// permuted order, so the planes multiply them directly (u8 x s8), and
//   acc = 2 * sum_k q_k l_k - (2^b - 1) * sum_k q_k
// is the integer sum_k q_k (2 l_k - (2^b - 1)) over the grid values that
// the reference accumulates, bit for bit: sum_k q_k runs over all d_pad
// columns of q_int8 (zero past the projection width) and is taken once a
// block.  The int32 accumulation is exact (|acc| <= 127 (2^b - 1) d_pad
// stays below 2^31 for d_pad below 66,000) and rounded once to fp32, as
// the plain version's exact product of the same integers gives it in
// any order, and the epilogue keeps the reference's order with unfused
// ops: dotc = acc * q_scale, biasq = bias + q_corr, dotc * scale + biasq
// + offset, then the metric tail.  Both kernels equal their plain
// versions bit for bit.
//
// Kernel 5 (ash_coarse_kernel) multiplies on the tensor cores with
// mma.sync m16n8k32 (u8 codes x s8 queries, s32 accumulate): a warp
// scores 16 rows against the block's MT = 8 queries (n = 8) per product
// group.  A dot product does not depend on the order of its terms, so
// each lane's A registers are byte planes of its own words of the rows,
// as they come out of the mask, with no shuffle: lane (g, t) takes a
// quarter of the words of rows g and g + 8 of the group, and the B
// fragments, built once a block in shared memory, hold each query's int8
// values at the dimensions those planes carry.  The rows reach shared
// memory through a ring of stages a warp, filled with cp.async from their
// contiguous bytes (16 bytes a lane, whole sectors) a few stages ahead,
// so that the loads hold no registers; rows wider than COARSE_KC words
// pass through the ring in chunks of COARSE_KC words, so that a stage's
// size does not depend on wd.  Blocks are persistent (as many as stay
// resident); each stages biasq = ipq + q_corr of its queries in shared
// memory, transposed so that one 8-byte load gives a row's biasq for both
// queries of a lane, and issues its first tiles' copies before that
// prologue.  The stores are the accumulator's layout: per store
// instruction, 8 consecutive rows (32 bytes) of each of 4 queries.
//
// Kernel 6 (ash_coarse_topk_kernel) keeps the per-thread structure of
// the fused scans: one thread scores one row against the MT queries
// with dp4a.u32.s32 (mixed sign, so b = 8 levels up to 255 take the same
// route) over its byte planes and 16-byte row loads (ScanArgs vec4),
// the query quadruples in shared memory read as two 16-byte broadcasts
// a plane.  Its selection is the dense kernel's (ash_select.cuh): spans
// of 512-row tiles, a running top-L of 64-bit (score desc, row asc) keys
// behind a bound, one warp per query, one runtime int32 row-validity mask
// operand, and the key strip merged on the card by ash_topk_merge_kernel
// (ash_select.cu).
//
// Each C entry point launches on the given stream and returns
// cudaGetLastError() so the wrapper can refuse a launch that failed.

#include "ash_select.cuh"

namespace {

constexpr int COARSE_WARPS = 8;       // warps a block of kernel 5, at most
constexpr int COARSE_GROUPS = 2;      // 16-row mma groups a warp's tile
constexpr int COARSE_KC = 32;         // words of a row a stage, at most
constexpr int COARSE_STAGES = 4;      // ring stages a warp
constexpr int COARSE_MIN_BLOCKS = 3;  // __launch_bounds__ blocks an SM
constexpr int IPQ_SMEM_MAX = 49152;   // bytes of ipq staged in shared memory
constexpr size_t SMEM_BLOCK_MAX = 232448;  // shared memory a block, sm_90

struct CoarseQ {
  const int8_t* q_int8;  // (m, d_pad), zero beyond the projection width
  const float* q_scale;  // (m,)
  const float* q_corr;   // (m,)
};

// Plane s of a packed word: byte c holds the level of code c * (8/B) + s.
template <int B>
__device__ __forceinline__ uint32_t plane(uint32_t word, int s) {
  constexpr uint32_t M = ((1u << B) - 1u) * 0x01010101u;
  return (word >> (B * s)) & M;
}

// c + sum of the four byte products, a's bytes unsigned, b's signed.
__device__ __forceinline__ int dp4a_us(uint32_t a, uint32_t b, int c) {
  int d;
  asm("dp4a.u32.s32 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// c += A (16 x 32, u8, row) * B (32 x 8, s8, col), exact in int32.
__device__ __forceinline__ void mma_u8s8(int (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.u8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// ncorr[i] = -(2^B - 1) * sum_k q_int8[m0 + i, k] (0 from query m_end
// on), a warp a query.
template <int B>
__device__ __forceinline__ void load_ncorr(const CoarseQ& cq, int d_pad,
                                           int m0, int m_end,
                                           int32_t* ncorr) {
  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x >> 5; i < MT; i += blockDim.x >> 5) {
    int s = 0;
    if (m0 + i < m_end)
      for (int k = lane; k < d_pad; k += 32)
        s += cq.q_int8[(size_t)(m0 + i) * d_pad + k];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(FULL_MASK, s, o);
    if (lane == 0) ncorr[i] = -((1 << B) - 1) * s;
  }
}

// Query values meeting bytes 0..3 of plane s of word w, packed: byte c
// is dimension w * (32/B) + c * (8/B) + s of query qi (0 from m_end on).
template <int B>
__device__ __forceinline__ uint32_t query_quad(const CoarseQ& cq, int d_pad,
                                               int m_end, int qi, int w,
                                               int s) {
  if (qi >= m_end) return 0u;
  const int8_t* q = cq.q_int8 + (size_t)qi * d_pad + w * (32 / B) + s;
  uint32_t packed = 0u;
#pragma unroll
  for (int c = 0; c < 4; ++c)
    packed |= (uint32_t)(uint8_t)q[c * (8 / B)] << (8 * c);
  return packed;
}

// ---- kernel 6: one row a thread, dp4a over byte planes ---------------

// q_s[p * MT + i] = query_quad of query m0 + i and plane p = w * (8/B) +
// s (word w, plane s), then ncorr at q_s + (d_pad / 4) * MT.
template <int B>
__device__ __forceinline__ void load_coarse_chunk(const ScanArgs& a,
                                                  const CoarseQ& cq,
                                                  int d_pad, int m0,
                                                  int32_t* q_s) {
  constexpr int PPW = 8 / B;
  for (int t = threadIdx.x; t < (d_pad / 4) * MT; t += blockDim.x) {
    const int p = t / MT, i = t % MT;
    q_s[t] = (int32_t)query_quad<B>(cq, d_pad, a.m, m0 + i, p / PPW,
                                    p % PPW);
  }
  load_ncorr<B>(cq, d_pad, m0, a.m, q_s + (d_pad / 4) * MT);
}

__host__ __device__ __forceinline__ size_t coarse_chunk_bytes(int d_pad) {
  return (size_t)(d_pad / 4 + 1) * MT * sizeof(int32_t);
}

// Eq. 20 epilogue of an exact integer dot term, in the reference's order:
// dotc = acc * q_scale, then dotc * scale + biasq + offset with biasq =
// bias + q_corr, then the metric tail.
template <int METRIC>
__device__ __forceinline__ float coarse_tail(int acc, float qs, float biasq,
                                             float sc, float off, float qt,
                                             float rt) {
  const float dotc = __fmul_rn((float)acc, qs);
  return metric_tail<METRIC>(eq20_base(dotc, sc, biasq, off), qt, rt);
}

// Integer dot products of row j with the MT queries of the chunk, then
// the coarse epilogue and the metric tail.
template <int B, int METRIC>
__device__ __forceinline__ void coarse_row(const ScanArgs& a,
                                           const CoarseQ& cq, int j, int m0,
                                           const int32_t* __restrict__ q_s,
                                           float out[MT]) {
  constexpr int PPW = 8 / B;
  const float sc = __ldg(a.scale + j);
  const float off = __ldg(a.offset + j);
  const int cl = __ldg(a.cluster + j);
  const float rt = (METRIC == METRIC_DOT) ? 0.f : __ldg(a.rowterm + j);
  int acc[MT];
#pragma unroll
  for (int i = 0; i < MT; ++i) acc[i] = 0;
  const int jj[1] = {j};
  for_each_word<1>(a, jj, [&](const uint32_t (&wv)[1], int w) {
#pragma unroll
    for (int s = 0; s < PPW; ++s) {
      const uint32_t v = plane<B>(wv[0], s);
      const int4* qw = reinterpret_cast<const int4*>(q_s + (w * PPW + s) * MT);
      const int4 lo = qw[0], hi = qw[1];
      acc[0] = dp4a_us(v, lo.x, acc[0]);
      acc[1] = dp4a_us(v, lo.y, acc[1]);
      acc[2] = dp4a_us(v, lo.z, acc[2]);
      acc[3] = dp4a_us(v, lo.w, acc[3]);
      acc[4] = dp4a_us(v, hi.x, acc[4]);
      acc[5] = dp4a_us(v, hi.y, acc[5]);
      acc[6] = dp4a_us(v, hi.z, acc[6]);
      acc[7] = dp4a_us(v, hi.w, acc[7]);
    }
  });
  const int32_t* ncorr = q_s + a.wd * PPW * MT;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int qi = min(m0 + i, a.m - 1);
    const float qt = (METRIC == METRIC_DOT) ? 0.f : __ldg(a.qterm + qi);
    out[i] = coarse_tail<METRIC>(
        2 * acc[i] + ncorr[i], __ldg(cq.q_scale + qi),
        __fadd_rn(__ldg(a.ipq + (size_t)qi * a.C + cl), __ldg(cq.q_corr + qi)),
        sc, off, qt, rt);
  }
}

// ---- kernel 5: 16-row groups on the tensor cores ---------------------
//
// A warp scores WARP_ROWS consecutive rows at a time (a tile of the
// warp) in chunks of their words: one chunk of wd words where wd <=
// COARSE_KC, else ceil(wd / COARSE_KC) chunks of COARSE_KC words (the
// last zero-filled past wd), so that a stage's shared memory does not
// grow with wd.  Within a chunk of kw words, lane (g, t) = (lane / 4,
// lane % 4) owns the word pairs 8c + 2t, 8c + 2t + 1 (c = 0, 1, ..) of
// rows g and g + 8 of each group.  Its local planes p = 0, 1, .. (plane
// p % (8/B) of local word p / (8/B); local word 2c + e is word 8c + 2t +
// e) fill its k slots in order: plane 2*kk + h is slot h of the chunk's
// k-step kk, which the m16n8k32 fragment tables (PTX ISA, 8-bit A/B)
// place at k = 4t..4t+3 (h = 0: registers a0 row g, a1 row g + 8, b0) or
// k = 16+4t..16+4t+3 (h = 1: a2, a3, b1).  Slots of words past kw or wd
// are zero on both sides.  The accumulators run over a tile's chunks;
// the epilogue follows its last.
//
// A block takes MQ <= MT queries: MT, or fewer where the B fragments of
// all k-steps (8 bytes a lane of the MQ queries; lanes of the columns
// past MQ read a zero) would not fit in shared memory beside one warp's
// ring (d_pad above ~26,000).  The other columns of the product are
// zero and not stored.
//
// Each warp owns a ring of COARSE_STAGES stages in shared memory; a
// stage holds one chunk of the tile's rows and, with its last chunk,
// their headers (scale, offset, cluster and, for l2 and cos, rowterm).
// A single chunk is a copy of the rows' contiguous words; of several, the
// rows lie COARSE_KC + 8 words apart in the stage (the padding puts the
// 8-byte reads of a half-warp's 4 rows into distinct banks).  The warp's
// lanes fill a stage with cp.async (16-byte copies where every operand's
// base is 16-byte aligned, and wd % 4 == 0 for several chunks, else
// 4-byte ones) COARSE_STAGES - 1 stages ahead of the one they score, so
// that the loads stay in flight while the warp multiplies, with no
// registers held for them and no block barrier after the prologue.
// Bytes past row n or word wd are zero-filled with a source-size of 0,
// and their source address is kept inside the tile's first row all the
// same: a copy that reads nothing may still have its address translated,
// and one past the end of the allocation can fault.
//
// Rows of one chunk (wd <= COARSE_KC, the main path's wd = 8) and of
// several run in separate instances (SPLIT), so that the first keeps a
// chunk loop of one pass, constant strides and MQ = MT folded in.

constexpr int WARP_ROWS = 16 * COARSE_GROUPS;  // rows of a warp's tile
constexpr int COARSE_PAD = 8;  // words between the rows of a split stage

// How a row of wd words is cut into the chunks of kernel 5's stages.
struct CoarseChunks {
  int n;       // chunks a row
  int kw;      // words a chunk
  int stride;  // words between rows in a stage
  int ks;      // k-steps a chunk: word pairs a lane x 8/B
};

template <int B>
__host__ __device__ __forceinline__ CoarseChunks coarse_chunks(int wd) {
  CoarseChunks c;
  c.n = wd <= COARSE_KC ? 1 : (wd + COARSE_KC - 1) / COARSE_KC;
  c.kw = c.n == 1 ? wd : COARSE_KC;
  c.stride = c.n == 1 ? wd : COARSE_KC + COARSE_PAD;
  c.ks = (c.kw + 7) / 8 * (8 / B);
  return c;
}

// Offset of the rings in shared memory, past `bytes` of fragments,
// ncorr and biases: 128-byte aligned, so that every stage is (a base 16
// bytes off a 32-byte boundary made kernel 5 0.0369 ms against 0.0317
// at phase 7's shape, same probe call, H100 80GB HBM3, 700 W).
__host__ __device__ __forceinline__ size_t coarse_ring_offset(size_t bytes) {
  return (bytes + 127) / 128 * 128;
}

// Bytes of a ring stage: the rows' words, then scale, offset, cluster
// and (l2, cos) rowterm, WARP_ROWS values each.
__host__ __device__ __forceinline__ int coarse_stage_bytes(int stride,
                                                           bool rowterm) {
  return WARP_ROWS * 4 * (stride + (rowterm ? 4 : 3));
}

// bq[kk * lq + lane] = lane's B fragment (b0, b1) of k-step kk (chunk kk
// / ck.ks), lq = 4 * MQ lanes: query m0 + g's values at the dimensions of
// the slots above.
template <int B>
__device__ __forceinline__ void load_mma_queries(const ScanArgs& a,
                                                 const CoarseQ& cq,
                                                 int d_pad, int m0,
                                                 int m_end,
                                                 const CoarseChunks& ck,
                                                 int lq, uint32_t* bq) {
  constexpr int PPW = 8 / B;
  for (int e = threadIdx.x; e < ck.n * ck.ks * lq * 2; e += blockDim.x) {
    const int h = e & 1, lane = (e >> 1) % lq, kk = (e >> 1) / lq;
    const int p = 2 * (kk % ck.ks) + h, lw = p / PPW;
    const int x = 8 * (lw >> 1) + 2 * (lane & 3) + (lw & 1);  // chunk word
    const int w = kk / ck.ks * ck.kw + x;
    bq[e] = (x < ck.kw && w < a.wd)
                ? query_quad<B>(cq, d_pad, m_end, m0 + (lane >> 2), w,
                                p % PPW)
                : 0u;
  }
}

// One cp.async of CH bytes, `bytes` of them read and the rest zero-filled.
template <int CH>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src,
                                         int bytes) {
  if (CH == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 ::"r"(dst), "l"(src), "r"(bytes) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 ::"r"(dst), "l"(src), "r"(bytes) : "memory");
}

// Bytes [0, total) of src into shared memory at dst, in chunks of CH
// bytes a lane; bytes at or past `valid` are zero-filled (not read).
template <int CH>
__device__ __forceinline__ void warp_copy(uint32_t dst, const void* src,
                                          int total, int valid) {
  const char* s = static_cast<const char*>(src);
  for (int off = (threadIdx.x & 31) * CH; off < total; off += 32 * CH) {
    const int v = min(max(valid - off, 0), CH);
    cp_async<CH>(dst + off, v > 0 ? s + off : s, v);
  }
}

// Words [0, COARSE_KC) of WARP_ROWS rows wd words apart from src into a
// stage at dst, COARSE_KC + COARSE_PAD words apart; rows at or past
// `rows` and words at or past kv are zero-filled (not read).
template <int CH>
__device__ __forceinline__ void warp_copy_chunk(uint32_t dst,
                                                const uint32_t* src, int wd,
                                                int rows, int kv) {
  constexpr int WPU = CH / 4, UPR = COARSE_KC / WPU;  // words a copy, a row
  for (int u = threadIdx.x & 31; u < WARP_ROWS * UPR; u += 32) {
    const int r = u / UPR, x = u % UPR * WPU;
    const bool v = r < rows && x < kv;
    cp_async<CH>(dst + (r * (COARSE_KC + COARSE_PAD) + x) * 4,
                 v ? src + (size_t)r * wd + x : src, v ? CH : 0);
  }
}

template <int B, int METRIC, bool SPLIT>
__global__ void __launch_bounds__(COARSE_WARPS * 32, COARSE_MIN_BLOCKS)
    ash_coarse_kernel(ScanArgs a, CoarseQ cq, int d_pad, int mq,
                      int ipq_shared, int copy16, float* __restrict__ out) {
  constexpr int PPW = 8 / B, S = COARSE_STAGES;
  constexpr int R = 2 * COARSE_GROUPS;  // rows g, g + 8 of each group
  constexpr bool RT = METRIC != METRIC_DOT;
  // the chunk geometry, constants but for the count of a split row's chunks
  const CoarseChunks ck =
      SPLIT ? CoarseChunks{coarse_chunks<B>(a.wd).n, COARSE_KC,
                           COARSE_KC + COARSE_PAD, (COARSE_KC + 7) / 8 * PPW}
            : CoarseChunks{1, a.wd, a.wd, (a.wd + 7) / 8 * PPW};
  if (!SPLIT) mq = MT;
  const int lq = 4 * mq;  // lanes whose B column is a query of the block
  extern __shared__ int4 smem_i4[];
  uint32_t* bq = reinterpret_cast<uint32_t*>(smem_i4);  // [ks][lq][2]
  int32_t* ncorr = reinterpret_cast<int32_t*>(bq + ck.n * ck.ks * lq * 2);
  uint32_t* zero = reinterpret_cast<uint32_t*>(ncorr + MT);  // [4]
  float* ipq_s = reinterpret_cast<float*>(zero + 4);  // [C][MT]
  const int SB = coarse_stage_bytes(ck.stride, RT);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  char* ring = reinterpret_cast<char*>(smem_i4) +
               coarse_ring_offset(reinterpret_cast<char*>(ipq_s) -
                                  reinterpret_cast<char*>(smem_i4) +
                                  (ipq_shared ? a.C * MT * sizeof(float) : 0)) +
               warp * S * SB;
  const uint32_t ring_s = (uint32_t)__cvta_generic_to_shared(ring);
  const int tile_rows = (blockDim.x >> 5) * WARP_ROWS;
  const int n_tiles = (a.n + tile_rows - 1) / tile_rows;
  const int m0 = blockIdx.y * mq, m_end = min(a.m, m0 + mq);
  const int cb = WARP_ROWS * ck.stride * 4;  // bytes of a stage's words
  const bool pairs = ck.stride % 2 == 0;  // 8-byte word loads

  // the warp's stage i: chunk i % ck.n of its tile i / ck.n into ring
  // slot i % S (one commit group)
  auto issue = [&](int i) {
    const int ich = SPLIT ? i % ck.n : 0;
    const int tile = blockIdx.x + (SPLIT ? i / ck.n : i) * gridDim.x;
    if (tile < n_tiles) {
      const int j0 = tile * tile_rows + warp * WARP_ROWS;
      const int rows = max(0, min(WARP_ROWS, a.n - j0));
      const int jb = rows > 0 ? j0 : 0;
      const uint32_t d = ring_s + (i % S) * SB;
      const uint32_t* src = a.codes + (size_t)jb * a.wd + ich * COARSE_KC;
      auto copy = [&](uint32_t dst, const void* from, int total, int valid) {
        if (copy16) warp_copy<16>(dst, from, total, valid);
        else warp_copy<4>(dst, from, total, valid);
      };
      if (!SPLIT) {
        copy(d, src, cb, rows * a.wd * 4);
      } else {
        const int kv = min(COARSE_KC, a.wd - ich * COARSE_KC);
        if (copy16) warp_copy_chunk<16>(d, src, a.wd, rows, kv);
        else warp_copy_chunk<4>(d, src, a.wd, rows, kv);
      }
      if (ich == ck.n - 1) {
        copy(d + cb, a.scale + jb, WARP_ROWS * 4, rows * 4);
        copy(d + cb + WARP_ROWS * 4, a.offset + jb, WARP_ROWS * 4, rows * 4);
        copy(d + cb + WARP_ROWS * 8, a.cluster + jb, WARP_ROWS * 4, rows * 4);
        if (RT)
          copy(d + cb + WARP_ROWS * 12, a.rowterm + jb, WARP_ROWS * 4,
               rows * 4);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

#pragma unroll
  for (int i = 0; i < S - 1; ++i) issue(i);  // in flight during the prologue
  load_mma_queries<B>(a, cq, d_pad, m0, m_end, ck, lq, bq);
  load_ncorr<B>(cq, d_pad, m0, m_end, ncorr);
  if (threadIdx.x < 4) zero[threadIdx.x] = 0u;
  if (ipq_shared)  // biasq = bias + q_corr, [cluster][query]
    for (int e = threadIdx.x; e < MT * a.C; e += blockDim.x) {
      const int i = e / a.C, c = e % a.C;
      ipq_s[c * MT + i] =
          m0 + i < m_end
              ? __fadd_rn(__ldg(a.ipq + (size_t)(m0 + i) * a.C + c),
                          __ldg(cq.q_corr + m0 + i))
              : 0.f;
    }
  __syncthreads();
  // the lane's B fragments: k-step kk at bl[kk * bstep] (a zero past MQ)
  const uint2* bl = lane < lq ? reinterpret_cast<const uint2*>(bq) + lane
                              : reinterpret_cast<const uint2*>(zero);
  const int bstep = SPLIT ? (lane < lq ? lq : 0) : 32;
  // the lane's two queries: columns 2t, 2t + 1 of the accumulators
  int qi[2], nc[2];
  float qs[2], qc[2], qt[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    qi[h] = min(m0 + 2 * t + h, a.m - 1);
    qs[h] = __ldg(cq.q_scale + qi[h]);
    qc[h] = __ldg(cq.q_corr + qi[h]);
    qt[h] = RT ? __ldg(a.qterm + qi[h]) : 0.f;
    nc[h] = ncorr[2 * t + h];
  }
  float* out_a = out + (size_t)qi[0] * a.n;
  float* out_b = out + (size_t)qi[1] * a.n;
  const bool store_a = m0 + 2 * t < m_end, store_b = m0 + 2 * t + 1 < m_end;

  int acc[COARSE_GROUPS][4];
  for (int k = 0; (int)(blockIdx.x + k * gridDim.x) < n_tiles; ++k) {
    for (int ch = 0; ch < ck.n; ++ch) {
      const int i = k * ck.n + ch;  // the warp's stage
      issue(i + S - 1);
      asm volatile("cp.async.wait_group %0;\n" ::"n"(S - 1) : "memory");
      __syncwarp();
      const char* st = ring + (i % S) * SB;
      const uint32_t* words = reinterpret_cast<const uint32_t*>(st);
      if (ch == 0)
#pragma unroll
        for (int G = 0; G < COARSE_GROUPS; ++G)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[G][e] = 0;
      const uint2* bk = bl + ch * ck.ks * bstep;
      for (int c = 0; c < ck.ks / PPW; ++c) {
        // words x, x + 1 of the chunk in the lane's R rows
        const int x = 8 * c + 2 * t;
        uint32_t wv[R][2];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const uint32_t* p =
              words + (16 * (r >> 1) + g + 8 * (r & 1)) * ck.stride + x;
          if (pairs) {
            const uint2 u = x < ck.kw ? *reinterpret_cast<const uint2*>(p)
                                      : make_uint2(0u, 0u);
            wv[r][0] = u.x;
            wv[r][1] = u.y;
          } else {
            wv[r][0] = x < ck.kw ? p[0] : 0u;
            wv[r][1] = x + 1 < ck.kw ? p[1] : 0u;
          }
        }
#pragma unroll
        for (int u = 0; u < PPW; ++u) {  // k-steps of the pair
          const uint2 bb = bk[(c * PPW + u) * bstep];
          // slot h: local plane 2u + h of the pair's two words
          const int w0 = (2 * u) / PPW, s0 = (2 * u) % PPW;
          const int w1 = (2 * u + 1) / PPW, s1 = (2 * u + 1) % PPW;
#pragma unroll
          for (int G = 0; G < COARSE_GROUPS; ++G)
            mma_u8s8(acc[G], plane<B>(wv[2 * G][w0], s0),
                     plane<B>(wv[2 * G + 1][w0], s0),
                     plane<B>(wv[2 * G][w1], s1),
                     plane<B>(wv[2 * G + 1][w1], s1), bb.x, bb.y);
        }
      }
      if (ch == ck.n - 1) {  // the epilogue, with the stage's headers
        const float* s_sc = reinterpret_cast<const float*>(st + cb);
        const float* s_off = s_sc + WARP_ROWS;
        const int32_t* s_cl =
            reinterpret_cast<const int32_t*>(s_off + WARP_ROWS);
        const float* s_rt = reinterpret_cast<const float*>(s_cl + WARP_ROWS);
        const int j0 =
            (blockIdx.x + k * gridDim.x) * tile_rows + warp * WARP_ROWS;
        const bool whole = j0 + WARP_ROWS <= a.n;
        float* pa = out_a + j0 + g;
        float* pb = out_b + j0 + g;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int ro = 16 * (r >> 1) + 8 * (r & 1), row = ro + g;
          const int cl = s_cl[row];
          float2 bq2;  // biasq of the lane's two queries
          if (ipq_shared) {
            bq2 = *reinterpret_cast<const float2*>(ipq_s + cl * MT + 2 * t);
          } else {
            bq2.x = __fadd_rn(__ldg(a.ipq + (size_t)qi[0] * a.C + cl), qc[0]);
            bq2.y = __fadd_rn(__ldg(a.ipq + (size_t)qi[1] * a.C + cl), qc[1]);
          }
          const float sc = s_sc[row], off = s_off[row];
          const float rt = RT ? s_rt[row] : 0.f;
          // accumulators c0, c1 (row g) or c2, c3 (row g + 8) of the group
          const int e = 2 * (r & 1);
          const float s0 = coarse_tail<METRIC>(2 * acc[r >> 1][e] + nc[0],
                                               qs[0], bq2.x, sc, off, qt[0],
                                               rt);
          const float s1 = coarse_tail<METRIC>(2 * acc[r >> 1][e + 1] + nc[1],
                                               qs[1], bq2.y, sc, off, qt[1],
                                               rt);
          if (whole || j0 + row < a.n) {
            if (store_a) pa[ro] = s0;
            if (store_b) pb[ro] = s1;
          }
        }
      }
      __syncwarp();  // the stage is read before it is refilled
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
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
               reinterpret_cast<char*>(smem_i4) + coarse_chunk_bytes(d_pad),
               strip, [&](int j, float* s) {
                 coarse_row<B, METRIC>(a, cq, j, m0, q_s, s);
               });
}

// One launch of ash_coarse_kernel<B, METRIC, SPLIT>, persistent blocks
// as many as stay resident (cached per device and shape).
template <int B, int METRIC, bool SPLIT>
int launch_coarse(ScanArgs a, CoarseQ cq, int d_pad, int mq, int warps,
                  size_t smem, int ipq_shared, int copy16, float* out,
                  cudaStream_t stream) {
  int rc = set_smem(ash_coarse_kernel<B, METRIC, SPLIT>, smem);
  if (rc) return rc;
  struct Occupancy {
    size_t smem;
    int warps, blocks;
  };
  static Occupancy occ_of[MAX_DEVICES] = {};
  int slot = 0;
  if ((rc = device_slot(&slot))) return rc;
  Occupancy fresh = {0, 0, 0};
  Occupancy& occ = slot >= 0 ? occ_of[slot] : fresh;
  if (smem != occ.smem || warps != occ.warps) {
    int dev = 0, n_sm = 0, per_sm = 0;
    if ((rc = (int)cudaGetDevice(&dev)) ||
        (rc = (int)cudaDeviceGetAttribute(
             &n_sm, cudaDevAttrMultiProcessorCount, dev)) ||
        (rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, ash_coarse_kernel<B, METRIC, SPLIT>, warps * 32,
             smem)))
      return rc;
    occ = {smem, warps, per_sm * n_sm};
  }
  const int occ_blocks = occ.blocks;
  const int y = (a.m + mq - 1) / mq;
  const int tile_rows = warps * WARP_ROWS;
  const int n_tiles = (a.n + tile_rows - 1) / tile_rows;
  const int per_y = occ_blocks / y > 1 ? occ_blocks / y : 1;
  dim3 grid(n_tiles < per_y ? n_tiles : per_y, y);
  ash_coarse_kernel<B, METRIC, SPLIT><<<grid, warps * 32, smem, stream>>>(
      a, cq, d_pad, mq, ipq_shared, copy16, out);
  return (int)cudaGetLastError();
}

template <int B, int METRIC>
struct LaunchCoarse {
  static int run(ScanArgs a, CoarseQ cq, int d_pad, float* out,
                 cudaStream_t stream) {
    const CoarseChunks ck = coarse_chunks<B>(a.wd);
    const size_t ring = (size_t)COARSE_STAGES *
                        coarse_stage_bytes(ck.stride, METRIC != METRIC_DOT);
    const size_t ipq = (size_t)MT * a.C * sizeof(float);
    // B fragments of mq queries, ncorr and the zero fragment
    auto fixed = [&](int mq) {
      return (size_t)ck.n * ck.ks * 32 * mq + (MT + 4) * sizeof(int32_t);
    };
    int mq = MT;  // fewer queries a block where one warp's ring would not fit
    while (mq > 1 && coarse_ring_offset(fixed(mq)) + ring > SMEM_BLOCK_MAX)
      mq /= 2;
    // ipq staged where it leaves room for every warp's ring
    const int ipq_shared =
        ipq <= IPQ_SMEM_MAX &&
        coarse_ring_offset(fixed(mq) + ipq) + COARSE_WARPS * ring <=
            SMEM_BLOCK_MAX;
    const size_t base = coarse_ring_offset(fixed(mq) + (ipq_shared ? ipq : 0));
    int warps = COARSE_WARPS;  // fewer where the rings would not fit
    while (warps > 1 && base + warps * ring > SMEM_BLOCK_MAX) --warps;
    const size_t smem = base + warps * ring;
    if (smem > SMEM_BLOCK_MAX) return (int)cudaErrorInvalidValue;
    // 16-byte copies: every row operand's base 16-byte aligned, and the
    // chunks of a split row too
    const uintptr_t bases = reinterpret_cast<uintptr_t>(a.codes) |
                            reinterpret_cast<uintptr_t>(a.scale) |
                            reinterpret_cast<uintptr_t>(a.offset) |
                            reinterpret_cast<uintptr_t>(a.cluster) |
                            reinterpret_cast<uintptr_t>(a.rowterm);
    const int copy16 = (bases & 15u) == 0 && (ck.n == 1 || a.wd % 4 == 0);
    if (ck.n == 1)  // and mq == MT: one chunk's fragments are small
      return launch_coarse<B, METRIC, false>(a, cq, d_pad, mq, warps, smem,
                                             ipq_shared, copy16, out, stream);
    return launch_coarse<B, METRIC, true>(a, cq, d_pad, mq, warps, smem,
                                          ipq_shared, copy16, out, stream);
  }
};

template <int B, int METRIC, int N>
int launch_coarse_topk(ScanArgs a, CoarseQ cq, int d_pad, const int32_t* mask,
                       int L, int tiles_per_span, int n_spans,
                       unsigned long long* strip, cudaStream_t stream) {
  const size_t smem = coarse_chunk_bytes(d_pad) + span_select_bytes(L);
  static size_t smem_set[MAX_DEVICES] = {};
  int rc = set_smem_once(ash_coarse_topk_kernel<B, METRIC, N>, smem,
                         smem_set);
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
