// Routines shared by the ASH scan kernels (ash_score.cu, ash_gather.cu,
// ash_coarse.cu): the operand block, the code unpack, the Eq. 20
// epilogue and metric tail, the order-preserving selection keys, and the
// bitrate x metric dispatch of the C entry points.
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
  return a;
}

// Grid value 2*level - (2^B - 1) of code c of a packed word.
template <int B>
__device__ __forceinline__ int code_value(uint32_t word, int c) {
  constexpr uint32_t LEVEL_MASK = (1u << B) - 1u;
  constexpr int GMAX = (1 << B) - 1;
  return 2 * (int)((word >> (c * B)) & LEVEL_MASK) - GMAX;
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

}  // namespace
