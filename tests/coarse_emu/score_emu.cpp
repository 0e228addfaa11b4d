// Kernels 1 and 2 (ash_score_launch, ash_score_topk_launch) run on the
// CPU by the stand-in of cuda_runtime.h, on one case given on the command
// line:
//
//   score_emu B WD N M C METRIC CHUNK L PER SPANS MASK ORDER SEED OUT
//
// (METRIC 0 dot, 1 l2, 2 cos; CHUNK the fused scan's queries a block;
// L, PER, SPANS its list length and span geometry; MASK 1 passes a
// mask with about a fifth of the rows out; ORDER 0 random rows, 1 rows
// whose scores rise with the row, 2 rows all tied).  Writes OUT/scores
// ((M, N) f32, kernel 1), OUT/mask ((N,) i32) and OUT/strip ((M, SPANS *
// L) u64, kernel 2) and prints the launches, grid and block of the last
// launch.  The kernel source, rewritten by the test, is included as
// score.cu.
#include "score.cu"

#include <atomic>
#include <random>
#include <string>

thread_local uint3 threadIdx, blockIdx;
dim3 blockDim, gridDim;
int emu_n_sm = 3;
int emu_device = 0;
int emu_attribute_calls = 0;
static char* smem_base = nullptr;
static std::unique_ptr<std::barrier<>> block_bar;
static std::vector<std::unique_ptr<std::barrier<>>> warp_bars;
static int xint[32][32];
static unsigned long long xu64[32][32];
static std::atomic<int> votes[3];  // __syncthreads_or, by call parity
thread_local int vote_calls = 0;
static long n_launch = 0;
static constexpr size_t GUARD = 1 << 16;
static dim3 last_grid;
static unsigned last_block = 0;

int4* emu_smem() { return reinterpret_cast<int4*>(smem_base); }
void __syncthreads() { block_bar->arrive_and_wait(); }
void __syncwarp(unsigned) { warp_bars[threadIdx.x / 32]->arrive_and_wait(); }

// a warp's lanes post v, then each reads the post of lane f(lane)
template <class T, class F>
static T exchange(T (&buf)[32][32], T v, F f) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  buf[w][l] = v;
  __syncwarp();
  const T r = buf[w][f(l)];
  __syncwarp();
  return r;
}
int emu_shfl_xor(int v, int o) {
  return exchange(xint, v, [o](int l) { return l ^ o; });
}
template <>
unsigned long long __shfl_xor_sync<unsigned long long>(unsigned,
                                                       unsigned long long v,
                                                       int o) {
  return exchange(xu64, v, [o](int l) { return l ^ o; });
}
int __shfl_sync(unsigned, int v, int src) {
  return exchange(xint, v, [src](int) { return src; });
}
unsigned __ballot_sync(unsigned, int p) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  xint[w][l] = p != 0;
  __syncwarp();
  unsigned r = 0;
  for (int i = 0; i < 32; ++i) r |= (unsigned)xint[w][i] << i;
  __syncwarp();
  return r;
}
int __any_sync(unsigned mask, int p) { return __ballot_sync(mask, p) != 0; }
int __syncthreads_or(int p) {
  // call c votes in slot c % 3 and clears slot (c + 2) % 3, which every
  // thread read before it reached this call's barrier
  const int c = vote_calls++;
  if (p) votes[c % 3].store(1);
  __syncthreads();
  const int r = votes[c % 3].load();
  if (threadIdx.x == 0) votes[(c + 2) % 3].store(0);
  return r;
}
int __popc(unsigned x) { return __builtin_popcount(x); }
int __ffs(int x) { return __builtin_ffs(x); }
int atomicAdd(int* p, int v) { return std::atomic_ref<int>(*p).fetch_add(v); }
int atomicCAS(int* p, int cmp, int v) {
  std::atomic_ref<int>(*p).compare_exchange_strong(cmp, v);
  if (cmp != v) std::this_thread::yield();  // a spin on a held lock
  return cmp;
}
int atomicExch(int* p, int v) { return std::atomic_ref<int>(*p).exchange(v); }
void __threadfence_block() { std::atomic_thread_fence(std::memory_order_seq_cst); }
unsigned long long atomicMin(unsigned long long* p, unsigned long long v) {
  std::atomic_ref<unsigned long long> a(*p);
  unsigned long long old = a.load();
  while (v < old && !a.compare_exchange_weak(old, v)) {
  }
  return old;
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
      // stale bytes, never zero, and a guard past the end that must
      // stay as it is
      smem_base = static_cast<char*>(malloc(smem + GUARD));
      memset(smem_base, 0xA5, smem + GUARD);
      for (auto& v : votes) v.store(0);
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
      for (size_t i = smem; i < smem + GUARD; ++i)
        if ((unsigned char)smem_base[i] != 0xA5) {
          fprintf(stderr, "write past the block's shared memory\n");
          abort();
        }
      free(smem_base);
      smem_base = nullptr;
    }
}

template <class T>
static void dump(const std::string& path, const std::vector<T>& v) {
  FILE* f = fopen(path.c_str(), "wb");
  if (!f || fwrite(v.data(), sizeof(T), v.size(), f) != v.size()) abort();
  fclose(f);
}

int main(int argc, char** argv) {
  if (argc != 15) {
    fprintf(stderr, "usage: score_emu B WD N M C METRIC CHUNK L PER SPANS "
                    "MASK ORDER SEED OUT\n");
    return 2;
  }
  const int b = atoi(argv[1]), wd = atoi(argv[2]), n = atoi(argv[3]);
  const int m = atoi(argv[4]), C = atoi(argv[5]), metric = atoi(argv[6]);
  const int chunk = atoi(argv[7]), L = atoi(argv[8]), per = atoi(argv[9]);
  const int spans = atoi(argv[10]), masked = atoi(argv[11]);
  const int order = atoi(argv[12]);
  std::mt19937 rng((unsigned)atol(argv[13]));
  const std::string out = argv[14];
  const int d_pad = wd * (32 / b);
  std::uniform_real_distribution<float> U(0.5f, 2.f), N(-1.f, 1.f);
  std::vector<uint32_t> codes((size_t)n * wd);
  std::vector<uint32_t> row0(wd);
  for (uint32_t& x : row0) x = rng();
  for (int j = 0; j < n; ++j)
    for (int w = 0; w < wd; ++w)
      codes[(size_t)j * wd + w] = order ? row0[w] : rng();
  std::vector<float> q((size_t)m * d_pad), qt(m), sc(n), off(n), rt(n);
  std::vector<float> ipq((size_t)m * C);
  std::vector<int32_t> cl(n), mask(n, 1);
  for (float& v : q) v = N(rng);
  for (float& v : qt) v = U(rng);
  for (float& v : ipq) v = N(rng);
  for (int j = 0; j < n; ++j) {
    sc[j] = order ? 1.f : U(rng);
    off[j] = order == 0 ? N(rng) : order == 1 ? (float)j : 0.f;
    rt[j] = order ? 1.f : U(rng);
    cl[j] = order ? 0 : (int)(rng() % C);
    if (masked) mask[j] = rng() % 5 != 0;
  }
  const bool tail = metric != METRIC_DOT;
  std::vector<float> scores((size_t)m * n);
  int rc = ash_score_launch(codes.data(), q.data(), sc.data(), off.data(),
                            cl.data(), ipq.data(), tail ? qt.data() : nullptr,
                            tail ? rt.data() : nullptr, scores.data(), n, m,
                            wd, C, b, metric, nullptr);
  std::vector<unsigned long long> strip((size_t)m * spans * L, 0x5A5A5A5Aull);
  if (rc == 0)
    rc = ash_score_topk_launch(
        codes.data(), q.data(), sc.data(), off.data(), cl.data(), ipq.data(),
        tail ? qt.data() : nullptr, tail ? rt.data() : nullptr,
        masked ? mask.data() : nullptr, strip.data(), n, m, wd, C, b, metric,
        L, per, spans, chunk, nullptr);
  if (rc) {
    printf("refused %d\n", rc);
    return 1;
  }
  dump(out + "/scores", scores);
  dump(out + "/mask", mask);
  dump(out + "/strip", strip);
  printf("done launches=%ld grid=%u,%u block=%u\n", n_launch, last_grid.x,
         last_grid.y, last_block);
  return 0;
}
