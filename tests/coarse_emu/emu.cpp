// Kernel 5 (ash_coarse_launch) run on the CPU by the stand-in of
// cuda_runtime.h, on one case given on the command line:
//
//   emu B D WD N M C METRIC OFFSET SMEM_MAX SEED
//
// (D of the d_pad = WD * 32 / B query dimensions non-zero; METRIC 0 dot,
// 1 l2, 2 cos; OFFSET 1 takes the codes from a base only 4-byte aligned;
// SMEM_MAX replaces the card's shared memory a block).  Every score is
// held bit for bit against a plain integer scan with the same epilogue.
// Prints "equal" or "MISMATCH", the launches, grid and block; exits 1 on
// a mismatch and aborts on a cp.async out of bounds or misaligned.
// The kernel source, rewritten by the test, is included as coarse.cu.
#include "coarse.cu"

#include <random>

thread_local uint3 threadIdx, blockIdx;
dim3 blockDim, gridDim;
int emu_n_sm = 3;  // a few persistent blocks, so that each loops
int emu_device = 0;
int emu_attribute_calls = 0;
static char* smem_base = nullptr;
static size_t smem_size = 0;
static std::unique_ptr<std::barrier<>> block_bar;
static std::vector<std::unique_ptr<std::barrier<>>> warp_bars;
static uint32_t xreg[32][32][6];  // [warp][lane][a0..a3, b0, b1]
static int xint[32][32];
struct Operand {
  const char* p;
  size_t n;
};
static std::vector<Operand> operands;
static std::mutex mu;
static long n_launch = 0, n_copies = 0, n_zero_copies = 0;
static dim3 last_grid;
static unsigned last_block = 0;

[[noreturn]] static void fail(const char* what) {
  fprintf(stderr, "%s\n", what);
  abort();
}
unsigned __ballot_sync(unsigned, int) { fail("not emulated: __ballot_sync"); }
int __popc(unsigned) { fail("not emulated: __popc"); }
unsigned long long atomicMin(unsigned long long*, unsigned long long) {
  fail("not emulated: atomicMin");
}
template <>
unsigned long long __shfl_xor_sync<unsigned long long>(unsigned,
                                                       unsigned long long,
                                                       int) {
  fail("not emulated: 64-bit shuffle");
}

int4* emu_smem() { return reinterpret_cast<int4*>(smem_base); }
size_t __cvta_generic_to_shared(const void* p) {
  const size_t o = static_cast<const char*>(p) - smem_base;
  if (o > smem_size) fail("shared address outside the block's memory");
  return o;
}
void __syncthreads() { block_bar->arrive_and_wait(); }
void __syncwarp(unsigned) { warp_bars[threadIdx.x / 32]->arrive_and_wait(); }
int emu_shfl_xor(int v, int o) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  xint[w][l] = v;
  __syncwarp();
  const int r = xint[w][l ^ o];
  __syncwarp();
  return r;
}
void emu_cp_async(uint32_t dst, const void* src, int ch, int bytes) {
  if (dst % ch || reinterpret_cast<uintptr_t>(src) % ch || bytes < 0 ||
      bytes > ch || dst + ch > smem_size)
    fail("cp.async misaligned or outside shared memory");
  const char* s = static_cast<const char*>(src);
  bool inside = false;
  for (const Operand& a : operands)
    inside |= s >= a.p && s + std::max(bytes, 1) <= a.p + a.n;
  if (!inside) fail("cp.async source outside every operand");
  memcpy(smem_base + dst, s, bytes);
  memset(smem_base + dst + bytes, 0, ch - bytes);
  std::lock_guard<std::mutex> g(mu);
  ++n_copies;
  n_zero_copies += bytes == 0;
}
static int byte_of(uint32_t x, int c, bool sgn) {
  const int v = (x >> (8 * c)) & 0xFF;
  return sgn && v > 127 ? v - 256 : v;
}
// mma.sync.aligned.m16n8k32.row.col.s32.u8.s8.s32 by the PTX ISA's
// fragment tables: A row r, column k in lane (r % 8) * 4 + (k % 16) / 4,
// register a0 (r < 8, k < 16), a1 (r >= 8, k < 16), a2, a3 (k >= 16);
// B row k, column j in lane j * 4 + (k % 16) / 4, b0 (k < 16) or b1;
// C row g, columns 2t, 2t + 1 in c0, c1, row g + 8 in c2, c3.
void emu_mma(int (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
             uint32_t b0, uint32_t b1) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  const uint32_t mine[6] = {a0, a1, a2, a3, b0, b1};
  memcpy(xreg[w][l], mine, sizeof(mine));
  __syncwarp();
  auto A = [&](int r, int k) {
    const int reg = (k < 16 ? 0 : 2) + (r >= 8 ? 1 : 0);
    return byte_of(xreg[w][(r % 8) * 4 + (k % 16) / 4][reg], k % 4, false);
  };
  auto B = [&](int k, int j) {
    return byte_of(xreg[w][j * 4 + (k % 16) / 4][k < 16 ? 4 : 5], k % 4,
                   true);
  };
  const int g = l / 4, t = l % 4;
  const int rows[4] = {g, g, g + 8, g + 8};
  const int cols[4] = {2 * t, 2 * t + 1, 2 * t, 2 * t + 1};
  int d[4];
  for (int e = 0; e < 4; ++e) {
    long s = 0;
    for (int k = 0; k < 32; ++k) s += (long)A(rows[e], k) * B(k, cols[e]);
    d[e] = (int)s;
  }
  __syncwarp();
  for (int e = 0; e < 4; ++e) c[e] += d[e];
}
void emu_launch(dim3 grid, unsigned block, size_t smem,
                std::function<void()> fn) {
  gridDim = grid;
  blockDim = dim3(block);
  ++n_launch;
  last_grid = grid;
  last_block = block;
  for (unsigned y = 0; y < grid.y; ++y)
    for (unsigned x = 0; x < grid.x; ++x) {
      smem_size = smem;
      smem_base = static_cast<char*>(malloc(smem));
      memset(smem_base, 0xA5, smem);  // stale bytes, never zero
      block_bar = std::make_unique<std::barrier<>>(block);
      warp_bars.clear();
      for (unsigned w = 0; w < block / 32; ++w)
        warp_bars.push_back(std::make_unique<std::barrier<>>(32));
      std::vector<std::thread> threads;
      for (unsigned i = 0; i < block; ++i)
        threads.emplace_back([&, i] {
          threadIdx = {i, 0, 0};
          blockIdx = {x, y, 0};
          fn();
        });
      for (auto& th : threads) th.join();
      free(smem_base);
      smem_base = nullptr;
    }
}

template <class T>
static T* operand(std::vector<T>& v) {
  operands.push_back({reinterpret_cast<const char*>(v.data()),
                      v.size() * sizeof(T)});
  return v.data();
}

int main(int argc, char** argv) {
  if (argc != 11) {
    fprintf(stderr, "usage: emu B D WD N M C METRIC OFFSET SMEM_MAX SEED\n");
    return 2;
  }
  const int b = atoi(argv[1]), d = atoi(argv[2]), wd = atoi(argv[3]);
  const int n = atoi(argv[4]), m = atoi(argv[5]), C = atoi(argv[6]);
  const int metric = atoi(argv[7]), offset = atoi(argv[8]);
  SMEM_BLOCK_MAX = (size_t)atol(argv[9]);
  std::mt19937 rng((unsigned)atol(argv[10]));
  const int d_pad = wd * (32 / b);
  // the codes at a base 4 bytes past 16-byte alignment with OFFSET
  std::vector<uint32_t> cbuf((size_t)n * wd + 4);
  uint32_t* codes = cbuf.data() + (offset ? 1 : 0);
  operands.push_back({reinterpret_cast<const char*>(codes),
                      (size_t)n * wd * 4});
  for (size_t i = 0; i < (size_t)n * wd; ++i) codes[i] = rng();
  std::vector<int8_t> qv((size_t)m * d_pad, 0);
  for (int i = 0; i < m; ++i)
    for (int k = 0; k < d; ++k)
      qv[(size_t)i * d_pad + k] = (int8_t)((int)(rng() % 255) - 127);
  std::uniform_real_distribution<float> U(0.5f, 2.f), N(-1.f, 1.f);
  std::vector<float> qs(m), qc(m), qt(m), sc(n), off(n), rt(n);
  std::vector<int32_t> cl(n);
  std::vector<float> ipq((size_t)m * C);
  for (int i = 0; i < m; ++i) {
    qs[i] = U(rng) * 1e-3f;
    qc[i] = N(rng);
    qt[i] = U(rng);
  }
  for (int j = 0; j < n; ++j) {
    sc[j] = U(rng);
    off[j] = N(rng);
    rt[j] = U(rng);
    cl[j] = rng() % C;
  }
  for (float& v : ipq) v = N(rng);
  std::vector<float> out((size_t)m * n, __uint_as_float(0x7fc01234u));
  const bool tail = metric != METRIC_DOT;
  const int rc = ash_coarse_launch(
      codes, operand(qv), operand(qs), operand(qc), operand(sc), operand(off),
      operand(cl), operand(ipq), tail ? operand(qt) : nullptr,
      tail ? operand(rt) : nullptr, out.data(), n, m, wd, C, b, metric,
      nullptr);
  if (rc) {
    printf("refused %d\n", rc);
    return 1;
  }
  const int G = (1 << b) - 1;
  long bad = 0;
  for (int i = 0; i < m; ++i)
    for (int j = 0; j < n; ++j) {
      long acc = 0;
      for (int k = 0; k < d_pad; ++k) {
        const uint32_t w = codes[(size_t)j * wd + k / (32 / b)];
        const int level = (w >> (b * (k % (32 / b)))) & G;
        acc += (long)qv[(size_t)i * d_pad + k] * (2 * level - G);
      }
      const float biasq = __fadd_rn(ipq[(size_t)i * C + cl[j]], qc[i]);
      float want;
      if (metric == METRIC_DOT)
        want = coarse_tail<METRIC_DOT>((int)acc, qs[i], biasq, sc[j], off[j],
                                       0.f, 0.f);
      else if (metric == METRIC_L2)
        want = coarse_tail<METRIC_L2>((int)acc, qs[i], biasq, sc[j], off[j],
                                      qt[i], rt[j]);
      else
        want = coarse_tail<METRIC_COS>((int)acc, qs[i], biasq, sc[j],
                                       off[j], qt[i], rt[j]);
      bad += __float_as_uint(out[(size_t)i * n + j]) != __float_as_uint(want);
    }
  printf("%s launches=%ld grid=%u,%u block=%u copies=%ld zero_copies=%ld "
         "mismatches=%ld\n", bad ? "MISMATCH" : "equal", n_launch,
         last_grid.x, last_grid.y, last_block, n_copies, n_zero_copies, bad);
  return bad ? 1 : 0;
}
