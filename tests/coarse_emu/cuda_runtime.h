// A CPU stand-in for the CUDA runtime, enough to run kernel 5
// (ash_coarse.cu::ash_coarse_kernel) and kernels 1 and 2
// (ash_score.cu) as programs: one std::thread per CUDA thread, barriers
// for __syncthreads and __syncwarp, mma.sync, shuffles, ballots and votes
// through a warp's exchange buffer, cp.async as an immediate copy whose
// source must lie inside an operand even when it reads nothing.
// tests/test_torch_coarse_emu.py and tests/test_torch_score_emu.py
// rewrite the kernels' asm statements and launches into calls of emu.cpp
// and score_emu.cpp (the definitions).
#pragma once
#include <stdint.h>
#include <stddef.h>
#include <string.h>
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <functional>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __shared__
#define __forceinline__ inline
#define __launch_bounds__(...)
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct uint3 { unsigned x, y, z; };
extern thread_local uint3 threadIdx, blockIdx;
extern dim3 blockDim, gridDim;
struct uint2 { uint32_t x, y; };
struct uint4 { uint32_t x, y, z, w; };
struct int4 { int x, y, z, w; };
struct float2 { float x, y; };
struct float4 { float x, y, z, w; };
inline uint2 make_uint2(uint32_t a, uint32_t b) { return {a, b}; }
template <class T> T __ldg(const T* p) { return *p; }
void __syncthreads();
void __syncwarp(unsigned mask = 0xffffffffu);
int emu_shfl_xor(int v, int o);
template <class T> T __shfl_xor_sync(unsigned, T v, int o);
template <> inline int __shfl_xor_sync<int>(unsigned, int v, int o) {
  return emu_shfl_xor(v, o);
}
inline uint32_t __float_as_uint(float f) { uint32_t u; memcpy(&u, &f, 4); return u; }
inline float __uint_as_float(uint32_t u) { float f; memcpy(&f, &u, 4); return f; }
inline float __int_as_float(int u) { float f; memcpy(&f, &u, 4); return f; }
// one rounding an op, as the device's _rn intrinsics
inline float __fmul_rn(float a, float b) { volatile float r = a * b; return r; }
inline float __fadd_rn(float a, float b) { volatile float r = a + b; return r; }
inline float __fsub_rn(float a, float b) { volatile float r = a - b; return r; }
// defined by the programs (emu.cpp, score_emu.cpp) whose kernels use them
unsigned __ballot_sync(unsigned, int);
int __any_sync(unsigned, int);
int __shfl_sync(unsigned, int v, int src);
int __syncthreads_or(int);
int __popc(unsigned);
int __ffs(int);
int atomicAdd(int*, int);
int atomicCAS(int*, int, int);
int atomicExch(int*, int);
void __threadfence_block();
unsigned long long atomicMin(unsigned long long*, unsigned long long);
using std::max;
using std::min;
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount };
// the current device cudaGetDevice reports, and the attribute calls made
extern int emu_device;
extern int emu_attribute_calls;
template <class K>
cudaError_t cudaFuncSetAttribute(K, cudaFuncAttribute, int) {
  ++emu_attribute_calls;
  return 0;
}
inline cudaError_t cudaGetLastError() { return 0; }
inline cudaError_t cudaGetDevice(int* d) { *d = emu_device; return 0; }
extern int emu_n_sm;
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) {
  *v = emu_n_sm;
  return 0;
}
template <class K>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* v, K, int,
                                                          size_t) {
  *v = 1;
  return 0;
}
size_t __cvta_generic_to_shared(const void* p);
void emu_cp_async(uint32_t dst, const void* src, int ch, int bytes);
void emu_mma(int (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
             uint32_t b0, uint32_t b1);
int4* emu_smem();
void emu_launch(dim3 grid, unsigned block, size_t smem,
                std::function<void()> fn);
