// Decode attention over an ASH-compressed KV cache for Hopper (sm_90a),
// on the tensor cores.
//
// Replaces (src/repro/kernels/ash_kv_attn.py):
//   ash_kv_attn_kernel + ash_kv_combine_kernel <- ash_kv_attn_pallas
//
// For each KV stream n (one sequence x one KV head) and each of the G
// query heads that share it (GQA):
//
//   logit_i = k_scale_i * <q_k, unpack(k_codes_i)> + k_bias_i  (masked:
//             -1e30, as the TPU kernel, so a leading fully masked block
//             is wiped by the first valid one)
//   acc     = sum_i softmax(logit)_i * v_scale_i * unpack(v_codes_i)
//
// in the reduced (code) space; the caller applies W_v^T once per query.
// The result is acc / max(denom, 1e-30), as the Pallas wrapper returns.
//
// What bounds it on the H100: bytes.  A cached position costs its packed
// K and V rows (2 * d_code * b / 8 bytes: 128 at b = 4, d_code = 128) and
// two scales (4 bytes in bf16): 1.1 GB for one layer of the decode shape
// (256 streams x 32768 positions), 0.33 ms at 3.35 TB/s.  Done with fp32
// FMAs on the CUDA cores, one code at a time, the two products cost about
// 1,500 thread-instructions a position: instruction issue, not bytes,
// would then bound the kernel.
//
// What the design does about it: both products run on the tensor cores
// (mma.sync.m16n8k16, bf16 in, fp32 accumulate), so the CUDA cores only
// unpack codes, and each code is unpacked once, two at a time, straight
// into a fragment register.
//
//   * Orientation.  Logits: M = 16 positions, K = 16 code dimensions,
//     N = 8 query heads (G <= 8, padded with zero queries).  PV: M = 16
//     output code columns, K = 16 positions, N = 8 heads.  The heads sit
//     on N in both, so a stream's G heads share one pass over its codes.
//   * Exactness.  Every grid value 2*level - (2^b - 1) is an odd integer
//     of magnitude <= 255, exact in bf16.  Each fp32 operand that is not
//     a code (q, and p * v_scale in PV) is split into three bf16 parts,
//     x = x1 + x2 + x3 + r with x1 = bf16(x), x2 = bf16(x - x1),
//     x3 = bf16(x - x1 - x2): each part rounds to nearest, so the
//     residual is |r| <= 2^-27 |x|, below fp32's 2^-24.  A part times a
//     code is exact in fp32 (8 x 8 significant bits), and the tensor core
//     sums the products in fp32.  So each logit and each accumulation is
//     an fp32 sum of exact products, as in the plain version, with
//     three times the terms; the only differences from the plain version
//     are the summation order and the accumulator's roundings (fp32,
//     truncating inside one mma), a few units of 2^-23 of the sum of
//     |products| per mma.  At logits of a few units this is 1e-6-sized,
//     against chip_smoke.kv_close's rtol 1e-4 / atol 1e-5.  The
//     exponentials use ex2.approx (relative error about 2^-22).
//   * Unpacking into fragments.  A thread's A-fragment register holds
//     two bf16 values.  For b <= 4 one shift, one AND/OR (lop3) and one
//     bf16x2 FMA turn codes I and I + 16/b of a packed word into such a
//     pair: 2*level is OR-ed into the mantissa of bf16 128 (0x4300), and
//     128 + 2^b - 1 subtracted (exact).  Unpacking is most of the
//     kernel's instructions, so the lop3 is written out (left to the
//     compiler, its two constants became two instructions).  For b = 8
//     (2*level up to 510 does not fit that mantissa) the pair is made in
//     fp32 (the mantissa of 2^23) and packed by one cvt.  The logit
//     product's reduction dimension is permuted to match (thread t of a
//     quad takes words 4r + t of a row; the q fragments are built with
//     the same permutation), and so is the PV product's output dimension
//     (thread g of a column group takes words 8r + g; one byte_perm pairs
//     the same code of two positions), un-permuted once, when the result
//     is written.
//   * No block barriers in the loop.  Each warp owns its positions: it
//     copies 32-position chunks of K and V codes into its own two-stage
//     cp.async ring in shared memory (16 bytes at a time where rows are
//     16-byte aligned; rows padded to 4 words mod 8, so the fragment
//     reads are free of bank conflicts), loads scales, bias and mask two
//     chunks ahead into registers, and keeps its own online softmax
//     (running max per head, denominators, the accumulator fragments;
//     the rescale is skipped when no head's max moved).  The three
//     parts of the logit product accumulate apart (three short mma
//     chains instead of one long one) and are summed smallest first.
//     The logits' fragment layout (heads on the lanes of a quad)
//     differs from the layout PV wants for p (heads on the quads), so
//     p * v_scale passes through a small tile in the warp's own shared
//     memory, behind a __syncwarp.  The warps of a block combine once,
//     at the end of the split, in a fixed order; the splits of S are
//     combined by ash_kv_combine_kernel.
//   * Operands are read in place: two lead dimensions with strides (the
//     (B, S, KV, W) layer cache read as a view), scales in bf16 or fp32,
//     an optional bias, a broadcast mask; rows that are not a multiple
//     of 16 bytes are copied 4 bytes at a time.
//
// The C entry point launches both kernels on the given stream and
// returns cudaGetLastError() so the wrapper can refuse a failed launch.

#include <cuda_bf16.h>

#include "ash_common.cuh"

namespace {

constexpr int KV_WARPS_MAX = 8;   // warps per block (fewer for wide rows)
constexpr int KV_CHUNK = 32;      // positions a warp takes at a time
constexpr int KV_MT = KV_CHUNK / 16;  // m16 tiles (logits) = k16 steps (PV)
static_assert(KV_CHUNK == 32, "a lane stages one position's scalars");
constexpr int KV_STAGES = 2;      // cp.async ring depth per warp
constexpr int G_MAX = 8;          // query heads per KV stream (mma N)
constexpr int D_MAX = 256;        // code dimensions (padded to the word)
constexpr int P_STRIDE = KV_CHUNK + 8;  // floats per head row of a P tile
constexpr int COMBINE_THREADS = 128;
constexpr int SMEM_LIMIT = 227 * 1024;
constexpr float NEG = -1e30f;

// Element strides (lead dim 1, lead dim 2, position) of each operand.
struct KVStrides {
  long long kc[3], vc[3], ks[3], kb[3], vs[3], mk[3];
};

struct KVArgs {
  const float* q;          // (N, G, dk) contiguous
  const uint32_t* kc;      // packed K words, strided
  const uint32_t* vc;      // packed V words, strided
  const void* ks;          // K scales, bf16 or fp32
  const void* vs;          // V scales, same type
  const float* kb;         // K bias or null (zero)
  const uint8_t* mask;     // bool, or null (all valid)
  float* part_m;           // (N, splits, G)
  float* part_d;           // (N, splits, G)
  float* part_acc;         // (N, splits, G, dv)
  int N2, S, G, Wk, Wv, splits, rows_per_split;
  bool vec_k, vec_v;  // 16-byte aligned rows: copy 16 bytes at a time
  bool scale_bf16;
  KVStrides st;
};

// Shared-memory row stride (words) of a staged K row of W words: a
// multiple of 4 (16-byte copies) that is 4 mod 8, so the 8 rows a
// fragment load touches fall in 8 distinct groups of 4 banks.
__host__ __device__ __forceinline__ int row_stride(int W) {
  const int s = (W + 3) & ~3;
  return (s % 8 == 0) ? s + 4 : s;
}

// Geometry of one instance: V word rounds per thread (WV8, words 8r + g),
// PV m-tiles (NMV), and the shared-memory plan.
template <int BV, int NMV>
struct PVShape {
  static constexpr int CV = 32 / BV;
  static constexpr int MPW = CV / 2;     // m-tiles per V word round
  static constexpr int WV8 = NMV / MPW;  // word rounds
  static constexpr int VS = 8 * WV8 + 4;  // staged V row stride, 4 mod 8
  static_assert(NMV % MPW == 0, "whole word rounds");
};

__host__ __device__ __forceinline__ int stage_words(int KS, int VS) {
  return KV_CHUNK * (KS + VS) + 3 * KV_CHUNK;  // codes, then ks/kb/vs
}

// Words of one warp's region: its ring and P tile while it scans, then
// (m, denom, acc) for the block's combine.
__host__ __device__ __forceinline__ int warp_words(int KS, int VS, int G,
                                                   int dv) {
  const int scan = KV_STAGES * stage_words(KS, VS) + G_MAX * P_STRIDE;
  const int comb = 2 * G_MAX + G * dv;
  return ((scan > comb ? scan : comb) + 3) & ~3;
}

__host__ __device__ __forceinline__ int qfrag_words(int nks) {
  return nks * 3 * 32 * 2;  // [k-step][part][lane] uint2
}

__device__ __forceinline__ float load_scale(const void* p, long long i,
                                            bool bf16) {
  if (bf16)
    return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  return __ldg(static_cast<const float*>(p) + i);
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// x0 + x1 * 2^16-lanes split into three bf16x2 parts (lo = x0, hi = x1):
// x = p[0] + p[1] + p[2] + r, |r| <= 2^-27 |x| (each part rounds to
// nearest; the residual x - bf16(x) is exact in fp32).
__device__ __forceinline__ void split3(float x0, float x1, uint32_t (&p)[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    p[i] = pack_bf16x2(x0, x1);
    x0 -= __uint_as_float(p[i] << 16);
    x1 -= __uint_as_float(p[i] & 0xffff0000u);
  }
}

// bf16x2 of the grid values 2*level - (2^B - 1) of codes I (low half) and
// I + 16/B (high half) of the 32-bit word x (code c at bits [c*B, c*B+B)).
// I is a constant after unrolling.
template <int B>
__device__ __forceinline__ uint32_t grid_pair(uint32_t x, int I) {
  if constexpr (B == 8) {
    const uint32_t lo = (x >> (8 * I)) & 0xffu;
    const uint32_t hi = (x >> (16 + 8 * I)) & 0xffu;
    // 2^23 + 2*level - (2^23 + 255), exact in fp32; then exact in bf16
    const float flo = __uint_as_float(0x4B000000u | (lo << 1)) - 8388863.f;
    const float fhi = __uint_as_float(0x4B000000u | (hi << 1)) - 8388863.f;
    return pack_bf16x2(flo, fhi);
  } else {
    constexpr uint32_t M2 = ((1u << B) - 1u) << 1;
    constexpr uint32_t MASK = M2 | (M2 << 16);
    // bf16 -(128 + 2^B - 1) in both halves: sign, exponent of 2^7,
    // mantissa 2^B - 1
    constexpr uint32_t C = (0xC300u | ((1u << B) - 1u)) * 0x10001u;
    const uint32_t t = I == 0 ? (x << 1) : (x >> (I * B - 1));
    // bf16 128 + 2*level: (t & MASK) | magic in one lop3; the magic sits
    // in a register (as two immediates the compiler would need two ops)
    uint32_t magic = 0x43004300u, v;
    asm("" : "+r"(magic));
    asm("lop3.b32 %0, %1, %2, %3, 0xEA;\n"
        : "=r"(v)
        : "r"(t), "r"(MASK), "r"(magic));
    uint32_t d;
    asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
        : "=r"(d)
        : "r"(v), "r"(0x3F803F80u), "r"(C));
    return d;
  }
}

// d += A * B, m16n8k16, bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

// A lane's walk over the copies of a chunk's rows: copy i = lane + 32j
// is (row i / U, unit i % U) of U units a row; advanced without a
// division per copy.
struct CopyWalk {
  int r0, u0, dr, du, U;
  __device__ __forceinline__ void init(int units, int lane) {
    U = units;
    r0 = lane / units;
    u0 = lane - r0 * units;
    dr = 32 / units;
    du = 32 - dr * units;
  }
};

// Issue the copies of `rows` packed rows of W words (row stride rs words
// in device memory, RS in shared memory); 16 bytes at a time when `vec`.
__device__ __forceinline__ void stage_rows(uint32_t* dst, const uint32_t* src,
                                           long long rs, int rows, int RS,
                                           const CopyWalk& cw, bool vec) {
  int r = cw.r0, u = cw.u0;
  if (cw.du == 0 && vec) {  // units a row divide 32: the unit stays fixed
    uint32_t* d = dst + r * RS + 4 * u;
    const uint32_t* g = src + r * rs + 4 * u;
    const int dd = cw.dr * RS;
    const long long dg = cw.dr * rs;
    for (; r < rows; r += cw.dr, d += dd, g += dg) cp_async16(d, g);
    return;
  }
  while (r < rows) {
    if (vec)
      cp_async16(dst + r * RS + 4 * u, src + r * rs + 4 * u);
    else
      cp_async4(dst + r * RS + u, src + r * rs + u);
    r += cw.dr;
    u += cw.du;
    if (u >= cw.U) {
      u -= cw.U;
      ++r;
    }
  }
}

// One position's K scale, bias and V scale as the logit and PV use them:
// masked -> (0, -1e30, v_scale); past the split -> (0, -inf, 0), so it
// weighs nothing even while every position so far is masked.
struct RowData {
  float ks, kb, vs;
};

__device__ __forceinline__ RowData load_row(const KVArgs& a, long long ks0,
                                            long long kb0, long long vs0,
                                            long long mk0, int s, int s_end) {
  RowData d = {0.f, -__int_as_float(0x7f800000), 0.f};
  if (s < s_end) {
    const bool valid = a.mask == nullptr || a.mask[mk0 + s * a.st.mk[2]];
    d.vs = load_scale(a.vs, vs0 + s * a.st.vs[2], a.scale_bf16);
    if (valid) {
      d.ks = load_scale(a.ks, ks0 + s * a.st.ks[2], a.scale_bf16);
      d.kb = a.kb ? __ldg(a.kb + kb0 + s * a.st.kb[2]) : 0.f;
    } else {
      d.kb = NEG;
    }
  }
  return d;
}

__device__ __forceinline__ float quad_max(float v) {  // over lanes ^4,^8,^16
  v = fmaxf(v, __shfl_xor_sync(~0u, v, 4));
  v = fmaxf(v, __shfl_xor_sync(~0u, v, 8));
  return fmaxf(v, __shfl_xor_sync(~0u, v, 16));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(~0u, v, 4);
  v += __shfl_xor_sync(~0u, v, 8);
  return v + __shfl_xor_sync(~0u, v, 16);
}

// NMV: PV m-tiles of 16 output columns (8 or 16); it sizes the register
// accumulators.  Block: 32 * nw threads, nw = blockDim.x / 32 warps.
template <int BK, int BV, int NMV>
__global__ void __launch_bounds__(32 * KV_WARPS_MAX,
                                  (NMV == 8 ? 16 : 8) / KV_WARPS_MAX)
    ash_kv_attn_kernel(KVArgs a) {
  using PV = PVShape<BV, NMV>;
  constexpr int CK = 32 / BK, CV = PV::CV;
  constexpr int SPW = CK / 4;  // logit k-steps per K word
  constexpr int VS = PV::VS;
  const int G = a.G, Wk = a.Wk, Wv = a.Wv;
  const int dk = Wk * CK, dv = Wv * CV;
  const int wk4 = (Wk + 3) >> 2, nks = wk4 * SPW;
  const int KS = row_stride(Wk);
  const int nw = blockDim.x >> 5;
  const int SW = stage_words(KS, VS), WW = warp_words(KS, VS, G, dv);
  extern __shared__ uint4 smem_u4[];
  uint2* qf = reinterpret_cast<uint2*>(smem_u4);  // [nks][3][32]
  uint32_t* regions = reinterpret_cast<uint32_t*>(smem_u4) + qfrag_words(nks);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int split = blockIdx.x, n = blockIdx.y;
  const long long n1 = n / a.N2, n2 = n % a.N2;
  const KVStrides& st = a.st;
  const uint32_t* kc = a.kc + n1 * st.kc[0] + n2 * st.kc[1];
  const uint32_t* vc = a.vc + n1 * st.vc[0] + n2 * st.vc[1];
  const long long ks0 = n1 * st.ks[0] + n2 * st.ks[1];
  const long long vs0 = n1 * st.vs[0] + n2 * st.vs[1];
  const long long kb0 = n1 * st.kb[0] + n2 * st.kb[1];
  const long long mk0 = n1 * st.mk[0] + n2 * st.mk[1];

  // q's B fragments, three bf16 parts, in the permuted reduction order:
  // k-step (r, j), lane (hg, ht) holds codes (2j, 2j + CK/2) and
  // (2j + 1, 2j + 1 + CK/2) of word 4r + ht for head hg (zero past G
  // heads and Wk words)
  const float* q = a.q + (size_t)n * G * dk;
  for (int e = threadIdx.x; e < nks * 32; e += blockDim.x) {
    const int kstep = e >> 5, ln = e & 31, hg = ln >> 2, ht = ln & 3;
    const int word = 4 * (kstep / SPW) + ht, j = kstep % SPW;
    const int code[4] = {2 * j, 2 * j + CK / 2, 2 * j + 1, 2 * j + 1 + CK / 2};
    float v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      v[i] = (hg < G && word < Wk) ? q[hg * dk + word * CK + code[i]] : 0.f;
    uint32_t lo[3], hi[3];
    split3(v[0], v[1], lo);
    split3(v[2], v[3], hi);
#pragma unroll
    for (int p = 0; p < 3; ++p)
      qf[(kstep * 3 + p) * 32 + ln] = make_uint2(lo[p], hi[p]);
  }
  __syncthreads();

  uint32_t* region = regions + (size_t)warp * WW;
  float* ptile = reinterpret_cast<float*>(region + KV_STAGES * SW);
  CopyWalk cwk, cwv;
  cwk.init(a.vec_k ? Wk >> 2 : Wk, lane);
  cwv.init(a.vec_v ? Wv >> 2 : Wv, lane);

  const int s_begin = split * a.rows_per_split;
  const int s_end = min(a.S, s_begin + a.rows_per_split);
  const int n_chunks =
      s_end > s_begin ? (s_end - s_begin + KV_CHUNK - 1) / KV_CHUNK : 0;
  const int mine = n_chunks > warp ? (n_chunks - warp + nw - 1) / nw : 0;

  float acc[NMV][4];
#pragma unroll
  for (int mt = 0; mt < NMV; ++mt)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[mt][c] = 0.f;
  // heads 2t and 2t + 1: running max (equal on the 8 lanes of column t)
  // and this lane's share of the denominator
  float m_run[2] = {NEG, NEG}, d_run[2] = {0.f, 0.f};

  auto chunk_s0 = [&](int i) { return s_begin + (warp + i * nw) * KV_CHUNK; };
  auto row_of = [&](int i) { return chunk_s0(i) + lane; };  // lane's position
  auto issue = [&](int i) {
    const int s0 = chunk_s0(i), rows = min(KV_CHUNK, s_end - s0);
    uint32_t* stg = region + (i % KV_STAGES) * SW;
    stage_rows(stg, kc + (long long)s0 * st.kc[2], st.kc[2], rows, KS, cwk,
               a.vec_k);
    stage_rows(stg + KV_CHUNK * KS, vc + (long long)s0 * st.vc[2], st.vc[2],
               rows, VS, cwv, a.vec_v);
  };
  auto put_row = [&](int i, const RowData& d) {
    float* sc = reinterpret_cast<float*>(region + (i % KV_STAGES) * SW +
                                         KV_CHUNK * (KS + VS));
    sc[lane] = d.ks;
    sc[KV_CHUNK + lane] = d.kb;
    sc[2 * KV_CHUNK + lane] = d.vs;
  };

  // the first KV_STAGES - 1 chunks: copies in flight, scalars in place;
  // the next chunk's scalars in registers (loaded a chunk earlier than
  // they are stored, so their latency hides behind a chunk's work)
#pragma unroll
  for (int i = 0; i < KV_STAGES - 1; ++i) {
    if (i < mine) {
      issue(i);
      put_row(i, load_row(a, ks0, kb0, vs0, mk0, row_of(i), s_end));
    }
    asm volatile("cp.async.commit_group;\n" ::);
  }
  RowData pend = load_row(a, ks0, kb0, vs0, mk0,
                          KV_STAGES - 1 < mine ? row_of(KV_STAGES - 1) : s_end,
                          s_end);

  for (int i = 0; i < mine; ++i) {
    // chunk i + KV_STAGES - 1 into the stage chunk i - 1 used
    const int ahead = i + KV_STAGES - 1;
    if (ahead < mine) issue(ahead);
    const RowData nxt = load_row(a, ks0, kb0, vs0, mk0,
                                 ahead + 1 < mine ? row_of(ahead + 1) : s_end,
                                 s_end);
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group %0;\n" ::"n"(KV_STAGES - 1));
    __syncwarp();
    const uint32_t* kt = region + (i % KV_STAGES) * SW;
    const uint32_t* vt = kt + KV_CHUNK * KS;
    const float* sc = reinterpret_cast<const float*>(vt + KV_CHUNK * VS);

    // logits: s[mt] is the m16n8 tile of positions 16mt .. 16mt + 15
    float s[KV_MT][4], s1[KV_MT][4], s2[KV_MT][4];
#pragma unroll
    for (int mt = 0; mt < KV_MT; ++mt)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[mt][c] = s1[mt][c] = s2[mt][c] = 0.f;
    for (int r = 0; r < wk4; ++r) {
      uint32_t w[KV_MT][2];
#pragma unroll
      for (int mt = 0; mt < KV_MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          w[mt][h] = kt[(16 * mt + g + 8 * h) * KS + 4 * r + t];
#pragma unroll
      for (int j = 0; j < SPW; ++j) {
        const uint2* qk = qf + (size_t)((r * SPW + j) * 3) * 32 + lane;
        const uint2 q0 = qk[0], q1 = qk[32], q2 = qk[64];
#pragma unroll
        for (int mt = 0; mt < KV_MT; ++mt) {
          const uint32_t A[4] = {
              grid_pair<BK>(w[mt][0], 2 * j), grid_pair<BK>(w[mt][1], 2 * j),
              grid_pair<BK>(w[mt][0], 2 * j + 1),
              grid_pair<BK>(w[mt][1], 2 * j + 1)};
          mma16816(s2[mt], A, q2.x, q2.y);
          mma16816(s1[mt], A, q1.x, q1.y);
          mma16816(s[mt], A, q0.x, q0.y);
        }
      }
    }
#pragma unroll
    for (int mt = 0; mt < KV_MT; ++mt)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[mt][c] += s1[mt][c] + s2[mt][c];

    // online softmax of heads 2t, 2t + 1 over the chunk; lane (g, t) holds
    // positions 16mt + g + 8h, h = 0, 1, as s[mt][2h + e] for head 2t + e
    float mx[2] = {-__int_as_float(0x7f800000), -__int_as_float(0x7f800000)};
#pragma unroll
    for (int mt = 0; mt < KV_MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int pos = 16 * mt + g + 8 * h;
        const float ksv = sc[pos], kbv = sc[KV_CHUNK + pos];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          s[mt][2 * h + e] = fmaf(s[mt][2 * h + e], ksv, kbv);
          mx[e] = fmaxf(mx[e], s[mt][2 * h + e]);
        }
      }
    float corr[2], psum[2] = {0.f, 0.f};
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float m_new = fmaxf(m_run[e], quad_max(mx[e]));
      corr[e] = __expf(m_run[e] - m_new);
      m_run[e] = m_new;
    }
#pragma unroll
    for (int mt = 0; mt < KV_MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int pos = 16 * mt + g + 8 * h;
        const float vsv = sc[2 * KV_CHUNK + pos];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = __expf(s[mt][2 * h + e] - m_run[e]);
          psum[e] += p;
          ptile[(2 * t + e) * P_STRIDE + pos] = p * vsv;
        }
      }
#pragma unroll
    for (int e = 0; e < 2; ++e) d_run[e] = d_run[e] * corr[e] + psum[e];
    if (__any_sync(~0u, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
      for (int mt = 0; mt < NMV; ++mt) {
        acc[mt][0] *= corr[0];
        acc[mt][1] *= corr[1];
        acc[mt][2] *= corr[0];
        acc[mt][3] *= corr[1];
      }
    }
    __syncwarp();

    // acc += V^T (p * v_scale): k-steps of 16 positions; lane (g, t) takes
    // positions 2t, 2t + 1, 2t + 8, 2t + 9 and V words 8r + g
#pragma unroll
    for (int kk = 0; kk < KV_MT; ++kk) {
      const float* pr = ptile + g * P_STRIDE + 16 * kk + 2 * t;
      const float2 x01 = *reinterpret_cast<const float2*>(pr);
      const float2 x89 = *reinterpret_cast<const float2*>(pr + 8);
      uint32_t lo[3], hi[3];
      split3(x01.x, x01.y, lo);
      split3(x89.x, x89.y, hi);
      const uint32_t* v0 = vt + (16 * kk + 2 * t) * VS + g;
#pragma unroll
      for (int r = 0; r < PV::WV8; ++r) {
        const uint32_t a0 = v0[8 * r], a1 = v0[VS + 8 * r];
        const uint32_t a8 = v0[8 * VS + 8 * r], a9 = v0[9 * VS + 8 * r];
        // the same code of two positions side by side: low halves
        // (codes 0 .. CV/2 - 1) and high halves
        const uint32_t xl = __byte_perm(a0, a1, 0x5410);
        const uint32_t xh = __byte_perm(a0, a1, 0x7632);
        const uint32_t yl = __byte_perm(a8, a9, 0x5410);
        const uint32_t yh = __byte_perm(a8, a9, 0x7632);
#pragma unroll
        for (int c = 0; c < PV::MPW; ++c) {
          const uint32_t A[4] = {grid_pair<BV>(xl, c), grid_pair<BV>(xh, c),
                                 grid_pair<BV>(yl, c), grid_pair<BV>(yh, c)};
          float(&d)[4] = acc[r * PV::MPW + c];
          mma16816(d, A, lo[2], hi[2]);
          mma16816(d, A, lo[1], hi[1]);
          mma16816(d, A, lo[0], hi[0]);
        }
      }
    }
    if (ahead < mine) put_row(ahead, pend);
    pend = nxt;
    __syncwarp();  // this stage and the P tile are free again
  }
  asm volatile("cp.async.wait_group 0;\n" ::);

  // combine the warps (fixed order) and write this split's partials.
  // acc[r * MPW + c] holds (column, head): c0 (col0, 2t), c1 (col0,
  // 2t + 1), c2 (col1, 2t), c3 (col1, 2t + 1), col0 = (8r + g) CV + c,
  // col1 = col0 + CV / 2
#pragma unroll
  for (int e = 0; e < 2; ++e) d_run[e] = quad_sum(d_run[e]);
  __syncwarp();
  float* red = reinterpret_cast<float*>(region);
  if (g == 0) {
    red[2 * t] = m_run[0];
    red[2 * t + 1] = m_run[1];
    red[G_MAX + 2 * t] = d_run[0];
    red[G_MAX + 2 * t + 1] = d_run[1];
  }
  float* racc = red + 2 * G_MAX;  // [G][dv]
#pragma unroll
  for (int r = 0; r < PV::WV8; ++r)
#pragma unroll
    for (int c = 0; c < PV::MPW; ++c) {
      const int col0 = (8 * r + g) * CV + c, col1 = col0 + CV / 2;
      const float(&d)[4] = acc[r * PV::MPW + c];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int h = 2 * t + e;
        if (h >= G) continue;
        if (col0 < dv) racc[h * dv + col0] = d[e];
        if (col1 < dv) racc[h * dv + col1] = d[2 + e];
      }
    }
  __syncthreads();
  const size_t part = (size_t)n * a.splits + split;
  const float* red0 = reinterpret_cast<const float*>(regions);
  for (int e = threadIdx.x; e < G * dv; e += blockDim.x) {
    const int h = e / dv, col = e - h * dv;
    float M = NEG;
    for (int w = 0; w < nw; ++w) M = fmaxf(M, red0[(size_t)w * WW + h]);
    float sum = 0.f, den = 0.f;
    for (int w = 0; w < nw; ++w) {
      const float* rw = red0 + (size_t)w * WW;
      const float f = expf(rw[h] - M);
      sum += rw[2 * G_MAX + e] * f;
      den += rw[G_MAX + h] * f;
    }
    a.part_acc[(part * G + h) * dv + col] = sum;
    if (col == 0) {
      a.part_m[part * G + h] = M;
      a.part_d[part * G + h] = den;
    }
  }
}

// out[n, g, :] = sum_s acc_s e^(m_s - M) / max(sum_s d_s e^(m_s - M), 1e-30)
__global__ void __launch_bounds__(COMBINE_THREADS)
    ash_kv_combine_kernel(const float* __restrict__ part_m,
                          const float* __restrict__ part_d,
                          const float* __restrict__ part_acc, int splits,
                          int G, int dv, float* __restrict__ out) {
  const int n = blockIdx.x / G, g = blockIdx.x % G;
  float M = NEG;
  for (int s = 0; s < splits; ++s)
    M = fmaxf(M, part_m[((size_t)n * splits + s) * G + g]);
  float den = 0.f;
  for (int s = 0; s < splits; ++s) {
    const size_t i = ((size_t)n * splits + s) * G + g;
    den += part_d[i] * expf(part_m[i] - M);
  }
  den = fmaxf(den, 1e-30f);
  for (int col = threadIdx.x; col < dv; col += blockDim.x) {
    float acc = 0.f;
    for (int s = 0; s < splits; ++s) {
      const size_t i = ((size_t)n * splits + s) * G + g;
      acc += part_acc[i * dv + col] * expf(part_m[i] - M);
    }
    out[((size_t)n * G + g) * dv + col] = acc / den;
  }
}

template <int BK, int BV, int NMV>
int launch_kv(KVArgs a, int N, float* out, cudaStream_t stream) {
  using PV = PVShape<BV, NMV>;
  const int KS = row_stride(a.Wk);
  const int nks = ((a.Wk + 3) / 4) * (32 / BK / 4);
  const int ww = warp_words(KS, PV::VS, a.G, a.Wv * PV::CV);
  int nw = KV_WARPS_MAX;
  size_t smem = 0;
  for (; nw >= 1; nw >>= 1) {
    smem = sizeof(uint32_t) * ((size_t)qfrag_words(nks) + (size_t)nw * ww);
    if (smem <= (size_t)SMEM_LIMIT) break;
  }
  if (nw < 1) return (int)cudaErrorInvalidValue;
  // the attribute call is a CUDA runtime round trip: made once per
  // instance, device and size, not per launch (28 launches a decode step)
  static size_t smem_set[MAX_DEVICES] = {};
  int rc = set_smem_once(ash_kv_attn_kernel<BK, BV, NMV>, smem, smem_set);
  if (rc) return rc;
  dim3 grid(a.splits, N);
  ash_kv_attn_kernel<BK, BV, NMV><<<grid, 32 * nw, smem, stream>>>(a);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  ash_kv_combine_kernel<<<N * a.G, COMBINE_THREADS, 0, stream>>>(
      a.part_m, a.part_d, a.part_acc, a.splits, a.G, a.Wv * PV::CV, out);
  return (int)cudaGetLastError();
}

// PV m-tiles: 8 when the thread's V word rounds fit 8 tiles, else 16
// (dv <= 256 keeps it there); b_v = 1 packs 16 tiles into one round.
template <int BK, int BV>
int launch_nmv(KVArgs a, int N, float* out, cudaStream_t stream) {
  constexpr int MPW = 16 / BV;
  const int tiles = ((a.Wv + 7) / 8) * MPW;
  if constexpr (MPW <= 8) {
    if (tiles <= 8) return launch_kv<BK, BV, 8>(a, N, out, stream);
  }
  if (tiles > 16) return (int)cudaErrorInvalidValue;
  return launch_kv<BK, BV, 16>(a, N, out, stream);
}

template <int BK>
int launch_bv(int b_v, KVArgs a, int N, float* out, cudaStream_t stream) {
  switch (b_v) {
    case 1: return launch_nmv<BK, 1>(a, N, out, stream);
    case 2: return launch_nmv<BK, 2>(a, N, out, stream);
    case 4: return launch_nmv<BK, 4>(a, N, out, stream);
    case 8: return launch_nmv<BK, 8>(a, N, out, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// out (N, G, dv) f32; N = N1 * N2 streams, stream n = (n / N2, n % N2)
// in the two lead dims of `strides` (18 values: kc, vc, ks, kb, vs, mk,
// three each).  part_m/part_d (N, splits, G) and part_acc (N, splits, G,
// dv) are scratch.  k_bias and mask may be null.
int ash_kv_attn_launch(const void* q, const void* k_codes, const void* k_scale,
                       const void* k_bias, const void* v_codes,
                       const void* v_scale, const void* mask, void* part_m,
                       void* part_d, void* part_acc, void* out,
                       const long long* strides, int N, int N2, int S, int G,
                       int Wk, int Wv, int b_k, int b_v, int scale_bf16,
                       int splits, int rows_per_split, void* stream) {
  if (N <= 0 || N2 <= 0 || N % N2 || S <= 0 || G < 1 || G > G_MAX ||
      Wk <= 0 || Wv <= 0 || splits <= 0 || rows_per_split <= 0 ||
      (long long)splits * rows_per_split < S || b_k < 1 || b_k > 8 ||
      b_v < 1 || b_v > 8 || Wk * (32 / b_k) > D_MAX ||
      Wv * (32 / b_v) > D_MAX)
    return (int)cudaErrorInvalidValue;
  KVArgs a;
  a.q = static_cast<const float*>(q);
  a.kc = static_cast<const uint32_t*>(k_codes);
  a.vc = static_cast<const uint32_t*>(v_codes);
  a.ks = k_scale;
  a.vs = v_scale;
  a.kb = static_cast<const float*>(k_bias);
  a.mask = static_cast<const uint8_t*>(mask);
  a.part_m = static_cast<float*>(part_m);
  a.part_d = static_cast<float*>(part_d);
  a.part_acc = static_cast<float*>(part_acc);
  a.N2 = N2;
  a.S = S;
  a.G = G;
  a.Wk = Wk;
  a.Wv = Wv;
  a.splits = splits;
  a.rows_per_split = rows_per_split;
  a.scale_bf16 = scale_bf16 != 0;
  a.vec_k = Wk % 4 == 0 && (uintptr_t)k_codes % 16 == 0 &&
            strides[0] % 4 == 0 && strides[1] % 4 == 0 && strides[2] % 4 == 0;
  a.vec_v = Wv % 4 == 0 && (uintptr_t)v_codes % 16 == 0 &&
            strides[3] % 4 == 0 && strides[4] % 4 == 0 && strides[5] % 4 == 0;
  for (int i = 0; i < 3; ++i) {
    a.st.kc[i] = strides[i];
    a.st.vc[i] = strides[3 + i];
    a.st.ks[i] = strides[6 + i];
    a.st.kb[i] = strides[9 + i];
    a.st.vs[i] = strides[12 + i];
    a.st.mk[i] = strides[15 + i];
  }
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (b_k) {
    case 1: return launch_bv<1>(b_v, a, N, o, st);
    case 2: return launch_bv<2>(b_v, a, N, o, st);
    case 4: return launch_bv<4>(b_v, a, N, o, st);
    case 8: return launch_bv<8>(b_v, a, N, o, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
