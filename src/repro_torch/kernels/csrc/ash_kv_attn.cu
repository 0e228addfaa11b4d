// Decode attention over an ASH-compressed KV cache for Hopper (sm_90a).
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
// two scales (4 bytes in bf16), against 4 * G * d_code FLOPs (1536 at
// G = 3): 11.6 FLOP/byte, under the card's 20 FLOP/byte fp32 ridge.
//
// What the design does about it:
//   * the packed cache is read in place, once per stream for all G query
//     heads of the group: operands come with their own strides, so the
//     (B, S, KV, W) layer cache is read without a transpose or copy, the
//     mask may be broadcast (stride 0) and k_bias may be absent; scales
//     are read as bf16 or fp32, whichever the cache stores;
//   * codes are never unpacked into device memory: tiles of 128
//     positions are copied into shared memory as packed words with
//     cp.async (16 bytes at a time where rows are 16-byte aligned),
//     double-buffered so that tile t + 1 arrives while tile t is
//     computed, with the next tile's scales and mask prefetched into
//     registers; rows are padded to a 16-byte multiple that is 4 words
//     mod 8, so each thread's 16-byte row reads are free of bank
//     conflicts;
//   * codes are unpacked in registers with the bit layout of
//     core/quantization.py (code c of a word at bits [c*b, (c+1)*b),
//     value 2*level - (2^b - 1)) and turned into floats by placing
//     2*level in the mantissa of 2^23 (no int-to-float conversions,
//     which issue at an eighth of the FMA rate);
//   * one thread per position computes the G logits, reading the query
//     as 16-byte broadcasts; one warp per query head takes the tile's
//     max and sum and updates the running (max, denom) (flash-decoding
//     online softmax); for p*v_scale*V each thread owns 8 code columns
//     of a group of rows and accumulates them for the G heads in
//     registers, so a p value is read once per 8 columns; the row
//     groups are summed once, at the end, in a fixed order;
//   * the TPU kernel's sequential grid over S becomes a split of S over
//     `splits` blocks per stream (enough blocks to fill 132 SMs at small
//     batch), each writing its partial (max, denom, acc); a second small
//     kernel combines the splits.
//
// The C entry point launches both kernels on the given stream and
// returns cudaGetLastError() so the wrapper can refuse a failed launch.

#include <cuda_bf16.h>

#include "ash_common.cuh"

namespace {

constexpr int KV_THREADS = 128;  // threads per block
constexpr int KV_TILE = 128;     // positions per shared-memory tile
constexpr int G_MAX = 8;         // query heads per KV stream
constexpr int D_MAX = 256;       // code dimensions (padded to the word)
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
  KVStrides st;
};

template <typename T>
__device__ __forceinline__ float load_scale(const void* p, long long i);

template <>
__device__ __forceinline__ float load_scale<float>(const void* p,
                                                   long long i) {
  return __ldg(static_cast<const float*>(p) + i);
}

template <>
__device__ __forceinline__ float load_scale<__nv_bfloat16>(const void* p,
                                                           long long i) {
  return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(~0u, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(~0u, v, o);
  return v;
}

// Shared-memory row stride (words) of a staged packed row of W words: a
// multiple of 4 (16-byte vector reads) that is 4 mod 8, so the 16-byte
// reads of 8 consecutive rows fall in 8 distinct bank groups.
__host__ __device__ __forceinline__ int row_stride(int W) {
  const int s = (W + 3) & ~3;
  return (s % 8 == 0) ? s + 4 : s;
}

// Grid value 2*level - (2^B - 1) of the code at bit SHIFT of `word`, as a
// float, with no int-to-float conversion: 2*level is placed in the low
// mantissa bits of 2^23 and the sum 2^23 + 2^B - 1 subtracted (exact).
template <int B, int SHIFT>
__device__ __forceinline__ float grid_float(uint32_t word) {
  constexpr uint32_t M2 = ((1u << B) - 1u) << 1;
  uint32_t two_l;
  if constexpr (SHIFT >= 1)
    two_l = (word >> (SHIFT - 1)) & M2;
  else
    two_l = (word << 1) & M2;
  return __uint_as_float(two_l | 0x4B000000u) -
         (8388608.f + (float)((1 << B) - 1));
}

// v[c] = grid value of code c of `word`, c = C .. 32/B - 1.
template <int B, int C = 0>
__device__ __forceinline__ void unpack_word(uint32_t word, float* v) {
  if constexpr (C < 32 / B) {
    v[C] = grid_float<B, C * B>(word);
    unpack_word<B, C + 1>(word, v);
  }
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

// Issue the copies of `rows` packed rows of W words (row stride rs in
// device memory, KS in shared memory); 16 bytes at a time when `vec`.
__device__ __forceinline__ void stage_rows(uint32_t* dst, const uint32_t* src,
                                           long long rs, int rows, int W,
                                           int KS, bool vec) {
  if (vec) {
    const int W4 = W >> 2;
    for (int i = threadIdx.x; i < rows * W4; i += KV_THREADS) {
      const int r = i / W4, w = (i - r * W4) << 2;
      cp_async16(dst + r * KS + w, src + r * rs + w);
    }
  } else {
    for (int i = threadIdx.x; i < rows * W; i += KV_THREADS) {
      const int r = i / W, w = i - r * W;
      cp_async4(dst + r * KS + w, src + r * rs + w);
    }
  }
}

// Per-position operands of one row: K scale, K bias, V scale, mask.
struct RowData {
  float ks, kb, vs;
  bool valid;
};

template <typename ST>
__device__ __forceinline__ RowData load_row(const KVArgs& a, long long ks0,
                                            long long kb0, long long vs0,
                                            long long mk0, long long s) {
  RowData d;
  d.ks = load_scale<ST>(a.ks, ks0 + s * a.st.ks[2]);
  d.vs = load_scale<ST>(a.vs, vs0 + s * a.st.vs[2]);
  d.kb = a.kb ? __ldg(a.kb + kb0 + s * a.st.kb[2]) : 0.f;
  d.valid = a.mask == nullptr || a.mask[mk0 + s * a.st.mk[2]];
  return d;
}

// dot[g] += <q_g, codes of one packed word> over its 32/B codes; qw
// points at the word's first code in head 0's query row (stride dkp).
template <int B, int GM>
__device__ __forceinline__ void dot_word(uint32_t word, const float* qw,
                                         int dkp, int G, float dot[GM]) {
  constexpr int C = 32 / B;
  float v[C];
  unpack_word<B>(word, v);
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    if (g >= G) break;
    const float4* q4 = reinterpret_cast<const float4*>(qw + g * dkp);
#pragma unroll
    for (int c = 0; c < C; c += 4) {
      const float4 q = q4[c >> 2];
      dot[g] = fmaf(q.x, v[c], dot[g]);
      dot[g] = fmaf(q.y, v[c + 1], dot[g]);
      dot[g] = fmaf(q.z, v[c + 2], dot[g]);
      dot[g] = fmaf(q.w, v[c + 3], dot[g]);
    }
  }
}

// The 8 grid values of column group cg (codes 8cg .. 8cg+7) of a staged
// V row.
template <int B>
__device__ __forceinline__ void group_values(const uint32_t* row, int cg,
                                             float v[8]) {
  if constexpr (B == 8) {
    unpack_word<8>(row[2 * cg], v);
    unpack_word<8>(row[2 * cg + 1], v + 4);
  } else {
    constexpr int GPW = 32 / B / 8;  // column groups per word
    const uint32_t w = row[cg / GPW] >> ((cg % GPW) * 8 * B);
    float u[32 / B];
    unpack_word<B>(w, u);  // the compiler keeps the first 8
#pragma unroll
    for (int c = 0; c < 8; ++c) v[c] = u[c];
  }
}

// GM: the largest G the instance takes (4 or 8); it sizes the register
// accumulators, so the decode shape (G = 3) runs the 4-head instance.
template <int BK, int BV, typename ST, int GM>
__global__ void __launch_bounds__(KV_THREADS)
    ash_kv_attn_kernel(KVArgs a) {
  constexpr int CK = 32 / BK, CV = 32 / BV;
  const int G = a.G, Wk = a.Wk, Wv = a.Wv;
  const int dk = Wk * CK, dv = Wv * CV;
  const int nk4 = (Wk + 3) >> 2, dkp = nk4 * 4 * CK;
  const int KSk = row_stride(Wk), KSv = row_stride(Wv);
  extern __shared__ float4 smem_f4[];
  float* q_s = reinterpret_cast<float*>(smem_f4);              // G * dkp
  uint32_t* k_s = reinterpret_cast<uint32_t*>(q_s + G * dkp);  // 2 tiles
  uint32_t* v_s = k_s + 2 * KV_TILE * KSk;                     // 2 tiles
  float* p_s = reinterpret_cast<float*>(v_s + 2 * KV_TILE * KSv);  // G*TILE
  float* vsc_s = p_s + G * KV_TILE;                            // TILE
  float* m_s = vsc_s + KV_TILE;                                // G_MAX
  float* d_s = m_s + G_MAX;                                    // G_MAX
  float* c_s = d_s + G_MAX;                                    // G_MAX

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int split = blockIdx.x, n = blockIdx.y;
  const long long n1 = n / a.N2, n2 = n % a.N2;
  const KVStrides& st = a.st;
  const uint32_t* kc = a.kc + n1 * st.kc[0] + n2 * st.kc[1];
  const uint32_t* vc = a.vc + n1 * st.vc[0] + n2 * st.vc[1];
  const long long ks0 = n1 * st.ks[0] + n2 * st.ks[1];
  const long long vs0 = n1 * st.vs[0] + n2 * st.vs[1];
  const long long kb0 = n1 * st.kb[0] + n2 * st.kb[1];
  const long long mk0 = n1 * st.mk[0] + n2 * st.mk[1];

  const float* q = a.q + (size_t)n * G * dk;
  for (int t = tid; t < G * dkp; t += KV_THREADS) {
    const int g = t / dkp, k = t - g * dkp;
    q_s[t] = k < dk ? q[g * dk + k] : 0.f;
  }
  if (tid < G_MAX) {
    m_s[tid] = NEG;
    d_s[tid] = 0.f;
    c_s[tid] = 1.f;
  }
  // PV layout: thread = (column group cg of 8 codes, row group rg)
  const int ncg = (dv + 7) >> 3, nrg = KV_THREADS / ncg;
  const int cg = tid % ncg, rg = tid / ncg;
  const bool pv_active = rg < nrg;
  float acc[GM][8];
#pragma unroll
  for (int g = 0; g < GM; ++g)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[g][c] = 0.f;

  const int s_begin = split * a.rows_per_split;
  const int s_end = min(a.S, s_begin + a.rows_per_split);
  const int n_tiles = s_end > s_begin ? (s_end - s_begin + KV_TILE - 1) / KV_TILE
                                      : 0;
  RowData cur = {0.f, 0.f, 0.f, false};
  if (n_tiles > 0) {
    const int rows = min(KV_TILE, s_end - s_begin);
    stage_rows(k_s, kc + (long long)s_begin * st.kc[2], st.kc[2], rows, Wk,
               KSk, a.vec_k);
    stage_rows(v_s, vc + (long long)s_begin * st.vc[2], st.vc[2], rows, Wv,
               KSv, a.vec_v);
    if (tid < rows) cur = load_row<ST>(a, ks0, kb0, vs0, mk0, s_begin + tid);
  }
  asm volatile("cp.async.commit_group;\n" ::);

  for (int t = 0; t < n_tiles; ++t) {
    const int s0 = s_begin + t * KV_TILE;
    const int rows = min(KV_TILE, s_end - s0);
    const int buf = t & 1;
    // prefetch tile t + 1 (its copies and its row operands)
    RowData nxt = cur;
    if (t + 1 < n_tiles) {
      const int s1 = s0 + KV_TILE, rows1 = min(KV_TILE, s_end - s1);
      stage_rows(k_s + (buf ^ 1) * KV_TILE * KSk,
                 kc + (long long)s1 * st.kc[2], st.kc[2], rows1, Wk, KSk,
                 a.vec_k);
      stage_rows(v_s + (buf ^ 1) * KV_TILE * KSv,
                 vc + (long long)s1 * st.vc[2], st.vc[2], rows1, Wv, KSv,
                 a.vec_v);
      if (tid < rows1) nxt = load_row<ST>(a, ks0, kb0, vs0, mk0, s1 + tid);
    }
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 1;\n" ::);
    __syncthreads();

    // logits: one thread per position, all G heads
    const uint32_t* kt = k_s + buf * KV_TILE * KSk;
    const uint32_t* vt = v_s + buf * KV_TILE * KSv;
    if (tid < rows) {
      float dot[GM];
#pragma unroll
      for (int g = 0; g < GM; ++g) dot[g] = 0.f;
      const uint4* kr = reinterpret_cast<const uint4*>(kt + tid * KSk);
      for (int w4 = 0; w4 < nk4; ++w4) {
        const uint4 w = kr[w4];
        const float* qw = q_s + w4 * 4 * CK;
        dot_word<BK, GM>(w.x, qw, dkp, G, dot);
        dot_word<BK, GM>(w.y, qw + CK, dkp, G, dot);
        dot_word<BK, GM>(w.z, qw + 2 * CK, dkp, G, dot);
        dot_word<BK, GM>(w.w, qw + 3 * CK, dkp, G, dot);
      }
      vsc_s[tid] = cur.vs;
#pragma unroll
      for (int g = 0; g < GM; ++g)
        if (g < G)
          p_s[g * KV_TILE + tid] = cur.valid ? dot[g] * cur.ks + cur.kb : NEG;
    }
    __syncthreads();

    // online softmax: one warp per query head
    for (int g = warp; g < G; g += KV_THREADS / 32) {
      float* pg = p_s + g * KV_TILE;
      float mx = NEG;
      for (int r = lane; r < rows; r += 32) mx = fmaxf(mx, pg[r]);
      mx = warp_max(mx);
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int r = lane; r < rows; r += 32) {
        const float p = expf(pg[r] - m_new);
        sum += p;
        pg[r] = p * vsc_s[r];
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        d_s[g] = d_s[g] * corr + sum;
        m_s[g] = m_new;
        c_s[g] = corr;
      }
    }
    __syncthreads();

    // acc = acc * corr + sum_r (p * v_scale)_r * v_r over this thread's
    // rows and 8 columns
    if (pv_active) {
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        if (g >= G) break;
        const float corr = c_s[g];
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[g][c] *= corr;
      }
      for (int r = rg; r < rows; r += nrg) {
        float v[8];
        group_values<BV>(vt + r * KSv, cg, v);
#pragma unroll
        for (int g = 0; g < GM; ++g) {
          if (g >= G) break;
          const float p = p_s[g * KV_TILE + r];
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[g][c] = fmaf(p, v[c], acc[g][c]);
        }
      }
    }
    cur = nxt;
    __syncthreads();  // tile t's buffers are free for tile t + 2
  }
  asm volatile("cp.async.wait_group 0;\n" ::);

  // sum the row groups (fixed order, through the free K buffers) and
  // write this split's partials
  float* red_s = reinterpret_cast<float*>(k_s);  // nrg * ncg * 8 <= 1024
  const size_t part = (size_t)n * a.splits + split;
  if (tid < G) {
    a.part_m[part * G + tid] = m_s[tid];
    a.part_d[part * G + tid] = d_s[tid];
  }
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    if (g >= G) break;
    __syncthreads();
    if (pv_active)
#pragma unroll
      for (int c = 0; c < 8; ++c) red_s[rg * ncg * 8 + cg * 8 + c] = acc[g][c];
    __syncthreads();
    for (int col = tid; col < dv; col += KV_THREADS) {
      float sum = 0.f;
      for (int r = 0; r < nrg; ++r) sum += red_s[r * ncg * 8 + col];
      a.part_acc[(part * G + g) * dv + col] = sum;
    }
  }
}

// out[n, g, :] = sum_s acc_s e^(m_s - M) / max(sum_s d_s e^(m_s - M), 1e-30)
__global__ void __launch_bounds__(KV_THREADS)
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

template <int BK, int BV, typename ST, int GM>
int launch_kv(KVArgs a, int N, float* out, cudaStream_t stream) {
  const int dv = a.Wv * (32 / BV);
  const int dkp = ((a.Wk + 3) / 4) * 4 * (32 / BK);
  const size_t smem =
      sizeof(float) * ((size_t)a.G * dkp + 2 * (size_t)KV_TILE * row_stride(a.Wk) +
                       2 * (size_t)KV_TILE * row_stride(a.Wv) +
                       (size_t)a.G * KV_TILE + KV_TILE + 3 * G_MAX);
  // the attribute call is a CUDA runtime round trip: made once per instance
  // and size, not per launch (28 launches a decode step)
  static size_t smem_set = 48 * 1024;
  int rc = 0;
  if (smem > smem_set) {
    rc = set_smem(ash_kv_attn_kernel<BK, BV, ST, GM>, smem);
    if (rc) return rc;
    smem_set = smem;
  }
  dim3 grid(a.splits, N);
  ash_kv_attn_kernel<BK, BV, ST, GM><<<grid, KV_THREADS, smem, stream>>>(a);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  ash_kv_combine_kernel<<<N * a.G, KV_THREADS, 0, stream>>>(
      a.part_m, a.part_d, a.part_acc, a.splits, a.G, dv, out);
  return (int)cudaGetLastError();
}

template <int BK, int BV>
int launch_st(int scale_bf16, KVArgs a, int N, float* out,
              cudaStream_t stream) {
  if (a.G <= 4)
    return scale_bf16 ? launch_kv<BK, BV, __nv_bfloat16, 4>(a, N, out, stream)
                      : launch_kv<BK, BV, float, 4>(a, N, out, stream);
  return scale_bf16 ? launch_kv<BK, BV, __nv_bfloat16, 8>(a, N, out, stream)
                    : launch_kv<BK, BV, float, 8>(a, N, out, stream);
}

template <int BK>
int launch_bv(int b_v, int scale_bf16, KVArgs a, int N, float* out,
              cudaStream_t stream) {
  switch (b_v) {
    case 1: return launch_st<BK, 1>(scale_bf16, a, N, out, stream);
    case 2: return launch_st<BK, 2>(scale_bf16, a, N, out, stream);
    case 4: return launch_st<BK, 4>(scale_bf16, a, N, out, stream);
    case 8: return launch_st<BK, 8>(scale_bf16, a, N, out, stream);
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
    case 1: return launch_bv<1>(b_v, scale_bf16, a, N, o, st);
    case 2: return launch_bv<2>(b_v, scale_bf16, a, N, o, st);
    case 4: return launch_bv<4>(b_v, scale_bf16, a, N, o, st);
    case 8: return launch_bv<8>(b_v, scale_bf16, a, N, o, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
