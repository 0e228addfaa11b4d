// Routines shared by the ASH scan kernels (ash_score.cu, ash_gather.cu,
// ash_coarse.cu): the operand block, the code unpack to exact fp32
// without a conversion, the Eq. 20 epilogue and metric tail, the
// order-preserving selection keys, and the bitrate x metric dispatch of
// the C entry points.
//
// Every score is computed in one fixed order: the dot term
// accumulated sequentially over the code dimensions (fp32 FMA for the
// asymmetric kernels, exact integers for the coarse ones), then the
// epilogue with unfused round-to-nearest ops.  Kernels that score the
// same (query, row) element therefore agree bit for bit, whichever
// kernel and launch shape computed it.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MT = 8;               // queries per block (register tile)
constexpr int TOPK_BLOCK_N = 512;   // columns per selection tile == threads
constexpr unsigned long long INVALID_KEY = ~0ull;

enum { METRIC_DOT = 0, METRIC_L2 = 1, METRIC_COS = 2 };

struct ScanArgs {
  const uint32_t* codes;  // (n, wd) packed words
  const float* q_proj;    // (m, d_pad); null for the coarse kernels
  const float* scale;     // (n,)
  const float* offset;    // (n,)
  const int32_t* cluster; // (n,)
  const float* ipq;       // (m, C)
  const float* qterm;     // (m,)  null for dot
  const float* rowterm;   // (n,)  null for dot
  int n, m, wd, C;
  bool vec4;  // rows read as 16-byte loads: wd % 4 == 0, 16-byte base
  // 151 << 23, the exponent bits of 2^24, passed at run time: code_float's
  // exponents derive from it, so the compiler keeps them in registers and
  // each code's and-or is one LOP3 (with both constants as immediates it
  // splits into two, and the integer pipe runs at half the FMA rate)
  uint32_t expo24;
};

ScanArgs make_args(const void* codes, const void* q_proj, const void* scale,
                   const void* offset, const void* cluster, const void* ipq,
                   const void* qterm, const void* rowterm, int n, int m,
                   int wd, int C) {
  ScanArgs a;
  a.codes = static_cast<const uint32_t*>(codes);
  a.q_proj = static_cast<const float*>(q_proj);
  a.scale = static_cast<const float*>(scale);
  a.offset = static_cast<const float*>(offset);
  a.cluster = static_cast<const int32_t*>(cluster);
  a.ipq = static_cast<const float*>(ipq);
  a.qterm = static_cast<const float*>(qterm);
  a.rowterm = static_cast<const float*>(rowterm);
  a.n = n;
  a.m = m;
  a.wd = wd;
  a.C = C;
  a.vec4 = wd % 4 == 0 && (reinterpret_cast<uintptr_t>(codes) & 15u) == 0;
  a.expo24 = 151u << 23;
  return a;
}

// A code's grid value as an exact float, with no int-to-float conversion
// (I2F issues at an eighth of the fp32 FMA rate on sm_90).  The level's B
// bits go to mantissa position s of a float with exponent E = 24 - s,
// where they weigh 2 each: its value is 2^E + 2*level exactly, and one
// subtraction of 2^E + 2^B - 1 (an integer below 2^24, so exact) leaves
// 2*level - (2^B - 1) exactly, the code's grid value.  The codes of a
// word fall into segments of K = 23/B - 1 codes; segment g is read from
// one copy of the word shifted so that its codes sit at positions B, 2B,
// .., KB (all inside the 23-bit mantissa): one shift a segment, then an
// and-or (one LOP3, the exponent bits from expo24 = ScanArgs::expo24 in a
// register) and one FADD a code.  c must fold to a constant (an unrolled
// loop), so that the shifts, masks and subtrahends are immediates.
template <int B>
__device__ __forceinline__ float code_float(uint32_t word, int c,
                                            uint32_t expo24) {
  constexpr uint32_t LEVEL_MASK = (1u << B) - 1u;
  constexpr uint32_t GMAX = (1u << B) - 1u;
  constexpr int K = 23 / B - 1;  // codes a segment
  const int g = c / K, s = B * (1 + c % K);
  const uint32_t w = g == 0 ? word << B : word >> (B * (g * K - 1));
  const uint32_t expo = expo24 - ((uint32_t)s << 23);  // 2^E, E = 24 - s
  const uint32_t sub = ((uint32_t)(127 + 24 - s) << 23) | (GMAX << (s - 1));
  return __fsub_rn(__uint_as_float((w & (LEVEL_MASK << s)) | expo),
                   __uint_as_float(sub));
}

// Calls f(wv, w) for w = 0, 1, .., wd - 1 in order, wv[r] holding word w
// of row j[r]: the rows are read as 16-byte loads where a.vec4 allows
// it, else word by word.
template <int ROWS, typename F>
__device__ __forceinline__ void for_each_word(const ScanArgs& a,
                                              const int (&j)[ROWS], F&& f) {
  if (a.vec4) {
    for (int w4 = 0; w4 < a.wd / 4; ++w4) {
      uint4 u[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
        u[r] = __ldg(reinterpret_cast<const uint4*>(
                         a.codes + (size_t)j[r] * a.wd) + w4);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        uint32_t wv[ROWS];
#pragma unroll
        for (int r = 0; r < ROWS; ++r)
          wv[r] = e == 0 ? u[r].x : e == 1 ? u[r].y : e == 2 ? u[r].z : u[r].w;
        f(wv, 4 * w4 + e);
      }
    }
  } else {
    for (int w = 0; w < a.wd; ++w) {
      uint32_t wv[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
        wv[r] = __ldg(a.codes + (size_t)j[r] * a.wd + w);
      f(wv, w);
    }
  }
}

// Eq. 20: dot*SCALE + bias + OFFSET, unfused, in this order.
__device__ __forceinline__ float eq20_base(float dot, float sc, float bias,
                                           float off) {
  return __fadd_rn(__fadd_rn(__fmul_rn(dot, sc), bias), off);
}

// Metric tail, higher-is-better: l2 (2*base - qterm) - rowterm,
// cos (base * qterm) * rowterm.
template <int METRIC>
__device__ __forceinline__ float metric_tail(float base, float qt, float rt) {
  if (METRIC == METRIC_L2) return __fsub_rn(__fsub_rn(__fmul_rn(2.f, base), qt), rt);
  if (METRIC == METRIC_COS) return __fmul_rn(__fmul_rn(base, qt), rt);
  return base;
}

// Order-preserving key: ascending key == (score descending, column
// ascending).  Signed zeros are folded together, as float comparison
// treats them.
__device__ __forceinline__ unsigned long long make_key(float s, int col) {
  uint32_t u = __float_as_uint(s);
  if ((u & 0x7fffffffu) == 0u) u = 0u;
  const uint32_t ord = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)(~ord) << 32) | (uint32_t)col;
}

__device__ __forceinline__ float key_score(unsigned long long key) {
  const uint32_t ord = ~(uint32_t)(key >> 32);
  const uint32_t u = (ord & 0x80000000u) ? (ord & 0x7fffffffu) : ~ord;
  return __uint_as_float(u);
}

template <template <int, int> class Launch, typename... Args>
int dispatch(int b, int metric, Args... args) {
#define ASH_CASE(BB)                                              \
  case BB:                                                        \
    switch (metric) {                                             \
      case METRIC_DOT: return Launch<BB, METRIC_DOT>::run(args...); \
      case METRIC_L2: return Launch<BB, METRIC_L2>::run(args...);   \
      case METRIC_COS: return Launch<BB, METRIC_COS>::run(args...); \
      default: return (int)cudaErrorInvalidValue;                 \
    }
  switch (b) {
    ASH_CASE(1)
    ASH_CASE(2)
    ASH_CASE(4)
    ASH_CASE(8)
    default: return (int)cudaErrorInvalidValue;
  }
#undef ASH_CASE
}

template <typename Kernel>
int set_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// Per-device caches of the launch helpers (the attribute above, kernel 5's
// occupancy) are indexed by the CUDA current device, which the Python
// wrappers set to the operands' card; a device past the table is served
// uncached.
constexpr int MAX_DEVICES = 64;

// The current device, or -1 past MAX_DEVICES; a runtime error as rc.
inline int device_slot(int* slot) {
  int dev = 0;
  const int rc = (int)cudaGetDevice(&dev);
  *slot = (dev >= 0 && dev < MAX_DEVICES) ? dev : -1;
  return rc;
}

// The attribute is a property of the kernel on one device, and the call a
// runtime round trip: it is made once per kernel instance, device and
// size.  done[MAX_DEVICES] is the instance's table, zero-initialized.
template <typename Kernel>
int set_smem_once(Kernel kernel, size_t smem, size_t* done) {
  if (smem <= 48 * 1024) return 0;
  int slot = 0;
  int rc = device_slot(&slot);
  if (rc) return rc;
  if (slot >= 0 && smem <= done[slot]) return 0;
  rc = set_smem(kernel, smem);
  if (rc == 0 && slot >= 0) done[slot] = smem;
  return rc;
}

}  // namespace
