// The delayed temporal-coherence combine for Hopper (sm_90a), with a plain C
// interface, over the entries that one window of TD steps touched:
//   for each entry i with a pending count c > 0:
//     d = s / max(c, 1),  e2 = tc_e + s,  a2 = tc_a + as
//     rate = a2 > 0 ? |e2| / max(a2, 1e-30) : 1
//     table = table + (rate * alpha) * d,  tc_e = e2,  tc_a = a2
//     s = as = c = 0
// with s, as, c the pending sums, absolute sums and counts that the window's
// scatters accumulated (train/td.py's delayed TC, arXiv:1604.05085).
//
// Replaces no Pallas kernel: the JAX package's combine is XLA's own dense
// elementwise fusion over the whole table (gym2048_tpu/models/ntuple.py's
// _tc_combine, then three table-sized zeroings). It replaces the port's
// dense combine on that path: ~13 passes of PyTorch elementwise kernels over
// 805 MB arrays and three 805 MB fills, ~8.6 ms a window on an H100.
//
// Why sparse. An entry with a count of 0 has sums of 0 (a masked occurrence
// scatters zero into every channel), and there the dense combine is a no-op
// for any finite value: d = 0, e2 = tc_e, a2 = tc_a, table + x * 0 = table.
// (It turns a -0.0 into +0.0, which a learner's arrays never hold: they
// start at +0.0 or a positive value, and a sum that cancels rounds to +0.0.)
// A window of the flagship learner scatters 8192 boards x 32 features x 8
// steps = 2,097,152 occurrences into 201,326,592 entries, so at most ~1% of
// them are touched, and a fused dense pass (12 x 805 MB of traffic, ~2.9 ms
// at 3.35 TB/s) would still do ~100 times the work the result needs.
//
// Design: one thread an occurrence, over the window's own flat indices (the
// rows that the TD step's tail records, masked occurrences at index 0 with
// count 0). The thread takes the entry's count with an atomic exchange
// against 0: the one thread that gets c > 0 owns the entry and combines it;
// every other occurrence of the entry, and every masked one, gets 0 and
// does nothing. So each entry is combined once, its pending sums are left
// at zero, and no table-sized zeroing is needed. An entry's result depends
// only on its own values, never on which thread owns it: the kernel is
// deterministic. The arithmetic is the plain version's, one rounding an
// operation (__fdiv_rn, __fmul_rn, __fadd_rn: nvcc contracts no multiply
// and add into one FMA), so the kernel equals the dense combine bit for bit.
//
// What bounds it on an H100: random 32-byte sectors. The least traffic is,
// for each distinct sector the window touched, the read and write of the
// table, tc_e and tc_a (6 x 32 B) and of the three pending arrays (the
// exchange of the counts, the read and clearing of the sums: 6 x 32 B), and
// 4 B an index; the accesses are scattered, so the rate at which the card
// serves random sectors and atomics, not HBM's bandwidth, is the practical
// limit (PERF.md, kernel table row 7).

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

// What needs CUDA, each behind a helper that the host test
// (tests/test_torch_tc_combine.py) defines for g++: everything after
// these helpers compiles there as a host library with the same C interface.
__device__ __forceinline__ int load_index(const int* p) { return __ldcs(p); }
__device__ __forceinline__ float take_count(float* p) { return atomicExch(p, 0.0f); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }

// kernel<<<grid, threads, 0, s>>>(args...) -> the launch's error.
template <typename... Params, typename... Args>
cudaError_t launch(void (*kernel)(Params...), unsigned grid, unsigned threads, cudaStream_t s,
                   Args... args) {
  kernel<<<grid, threads, 0, s>>>(args...);
  return cudaGetLastError();
}

namespace {

constexpr int kThreads = 256;  // threads per block
constexpr int kBadArguments = -1;

// The combine of the entries at idx[0 .. n), one occurrence a thread.
template <int Threads>
__global__ void __launch_bounds__(Threads)
    tc_combine_kernel(const int* __restrict__ idx, long long n, float* __restrict__ table,
                      float* __restrict__ tc_e, float* __restrict__ tc_a,
                      float* __restrict__ sums, float* __restrict__ absums,
                      float* __restrict__ cnts, float alpha) {
  const long long o = static_cast<long long>(blockIdx.x) * Threads + threadIdx.x;
  if (o >= n) return;
  const long long i = load_index(idx + o);
  const float c = take_count(cnts + i);
  if (!(c > 0.0f)) return;  // another occurrence owns the entry, or it is masked
  const float s = sums[i];
  const float as = absums[i];
  sums[i] = 0.0f;
  absums[i] = 0.0f;
  const float d = div_rn(s, fmaxf(c, 1.0f));
  const float e2 = add_rn(tc_e[i], s);
  const float a2 = add_rn(tc_a[i], as);
  const float rate = a2 > 0.0f ? div_rn(fabsf(e2), fmaxf(a2, 1e-30f)) : 1.0f;
  table[i] = add_rn(table[i], mul_rn(mul_rn(rate, alpha), d));
  tc_e[i] = e2;
  tc_a[i] = a2;
}

}  // namespace

extern "C" {

// Enqueues the combine of the n occurrences at `idx` (int32 flat indices
// into the six float32 arrays) on `stream`; n == 0 launches nothing.
// Returns 0, the launch's CUDA error, or kBadArguments.
int gym_tc_combine(const void* idx, long long n, void* table, void* tc_e, void* tc_a,
                   void* sums, void* absums, void* cnts, float alpha, void* stream) {
  if (n < 0) return kBadArguments;
  if (n == 0) return 0;
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return kBadArguments;
  return static_cast<int>(launch(tc_combine_kernel<kThreads>, static_cast<unsigned>(blocks),
                                 kThreads, static_cast<cudaStream_t>(stream),
                                 static_cast<const int*>(idx), n, static_cast<float*>(table),
                                 static_cast<float*>(tc_e), static_cast<float*>(tc_a),
                                 static_cast<float*>(sums), static_cast<float*>(absums),
                                 static_cast<float*>(cnts), alpha));
}

const char* gym_tc_combine_error_string(int err) {
  if (err == kBadArguments) return "arguments the tc_combine kernel does not take";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
