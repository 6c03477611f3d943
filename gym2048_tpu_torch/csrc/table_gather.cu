// Exact table lookup for Hopper (sm_90a), with a plain C interface.
//
// Replaces the Pallas TPU kernel of gym2048_tpu/models/pallas_table.py:
//   gather4_kernel, gather1_kernel <- _gather_kernel (gather_values)
// out[i] = table[idx[i]] for a flat f32 table and int32 indices, exactly:
// a copy, no arithmetic on the values.
//
// The TPU kernel streams one 128-lane row per index into VMEM through a
// ring of DMAs and picks the lane with a one-hot contraction, because its
// scalar core cannot read single words of HBM. A Hopper thread can, so
// none of that is carried over: the ring, the lane select, and the
// N % chunk and S % 128 shape rules are gone.
//
// What bounds it on an H100, per stream. Every lookup is a 4-byte load at
// a random address: a warp's load instruction asks for ~26 distinct 32-byte
// sectors in as many cache lines, and sorting the lanes does not coalesce
// them. The stream and the output move 8 bytes per index.
// - The path streams (the agent's search leaves, the TD step's
//   afterstates, early and late in training) reuse their sectors across
//   the stream (0.015-0.16 distinct sectors per index), so L1 and L2
//   answer nearly every lookup, and the SM's L1 answers about one distinct
//   line per clock: about one lookup per SM and clock, 261e9 a second on
//   132 SMs at 1.98 GHz, which the agent's 8,388,608 lookups reach (32 us).
//   At the TD step's N = 1,048,576 (4 us at that rate) the launch adds
//   about 2 us. Design: loads through L1 (__ldg). Loads that skip it
//   (ld.global.nc.L1::no_allocate) go to L2 and take 1.5-2 times as long;
//   more loads in flight a thread do not raise the L1's rate.
// - A uniform stream misses L1 and mostly L2. It runs at ~29e9 lookups a
//   second from 1,048,576 indices to 67,108,864, whether its sectors
//   repeat (0.35 distinct per index at 67,108,864) or not (0.98 at
//   1,048,576): a limit of random requests, not of HBM bytes. Design: one
//   32-byte sector a request; fetching whole lines into L2 (.L2::128B)
//   makes it 1.35 times as slow.
// (An NVIDIA H100 80GB HBM3 at 700 W; measured by chip_smoke.py, whose
// --gather-ab option compares versions of this file in one process; see
// PERF.md.)
//
// Design. gather4_kernel: one thread per group of four indices, in blocks
// of 256: one 16-byte load of indices (coalesced across the warp), four
// independent table loads, one 16-byte store. The indices and the output
// are touched once, so they use the streaming hints (ld.cs, st.cs) and do
// not push table sectors out of the caches. Measured against it and no
// faster on the path streams (PERF.md): a persistent grid-stride kernel
// with 1, 2 or 4 groups a thread, the next indices loaded ahead, in blocks
// of 128, 256 or 512; the L1 carve-out set to its largest; the head and
// tail folded into the main launch (1-3% slower). Programmatic dependent
// launch overlaps the launch with the previous kernel only while that
// kernel drains, as in a graph replay, not when a caller launches the
// lookup on an idle card, so the launch is plain. Addresses are 64-bit (pointer plus a sign-extended index): the
// staged 4x6 table has 201,326,592 entries. Where the index and output
// pointers lie at the same offset modulo 16 bytes, gather4_kernel takes
// the groups of four from the first 16-byte boundary on and gather1_kernel
// (one index per thread) a scalar head and tail of at most three indices
// each, in launches of their own; pointers at different offsets take
// gather1_kernel over the whole stream. Indices must lie in [0, S); the
// kernels do not check them.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

// What needs CUDA, each behind a helper that the host test
// (tests/test_torch_table_gather_host.py) defines for g++.
__device__ __forceinline__ int load_index(const int* p) { return __ldcs(p); }
__device__ __forceinline__ int4 load_indices(const int4* p) { return __ldcs(p); }
__device__ __forceinline__ float load_value(const float* p) { return __ldg(p); }
__device__ __forceinline__ void store_value(float* p, float v) { __stcs(p, v); }
__device__ __forceinline__ void store_values(float4* p, float4 v) { __stcs(p, v); }

namespace {

constexpr int kThreads = 256;  // threads per block of both kernels

// Both kernels take their block size as a constant (it spares the read of
// blockDim); the launcher uses kThreads.

// out[g] = table[idx[g]] for n4 groups of four, one group per thread.
template <int Threads>
__global__ void gather4_kernel(const float* __restrict__ table, const int4* __restrict__ idx,
                               float4* __restrict__ out, long long n4) {
  const long long i = static_cast<long long>(blockIdx.x) * Threads + threadIdx.x;
  if (i >= n4) return;
  const int4 k = load_indices(idx + i);
  float4 v;
  v.x = load_value(table + k.x);
  v.y = load_value(table + k.y);
  v.z = load_value(table + k.z);
  v.w = load_value(table + k.w);
  store_values(out + i, v);
}

// out[i] = table[idx[i]] for i < n, one index per thread.
template <int Threads>
__global__ void gather1_kernel(const float* __restrict__ table, const int* __restrict__ idx,
                               float* __restrict__ out, long long n) {
  const long long i = static_cast<long long>(blockIdx.x) * Threads + threadIdx.x;
  if (i < n) store_value(out + i, load_value(table + load_index(idx + i)));
}

// One launch of a lookup: the `count` indices from `first` on, by
// gather4_kernel in groups of four or by gather1_kernel one a thread.
struct Launch {
  bool vector;
  long long first, count, blocks;
};

// The launches (at most three, into `launches`) of a lookup of n indices
// at these addresses, in blocks of `threads`; returns how many. Where idx
// and out lie at the same offset modulo 16 bytes, gather4_kernel takes the
// groups of four from the first 16-byte boundary on and gather1_kernel the
// scalar head before it and the tail after them, at most three indices
// each: aligned pointers and n % 4 == 0, as on every path, make one
// launch. Pointers at different offsets take gather1_kernel over all n.
int plan_launches(uintptr_t idx, uintptr_t out, long long n, int threads, Launch* launches) {
  const auto blocks = [threads](long long work) { return (work + threads - 1) / threads; };
  if ((idx & 15) != (out & 15)) {
    launches[0] = {false, 0, n, blocks(n)};
    return 1;
  }
  const long long head = std::min<long long>(n, ((16 - (idx & 15)) & 15) / 4);
  const long long n4 = (n - head) / 4;
  const long long done = head + 4 * n4;
  int k = 0;
  if (n4 > 0) launches[k++] = {true, head, 4 * n4, blocks(n4)};
  if (head > 0) launches[k++] = {false, 0, head, 1};
  if (n > done) launches[k++] = {false, done, n - done, 1};
  return k;
}

}  // namespace

extern "C" {

// Enqueues the lookup of n indices on `stream` (see plan_launches).
// Returns the CUDA error code of the first launch that fails, 0 if none.
int gym_gather_values(const void* table, const void* idx, void* out, long long n,
                      void* stream) {
  Launch launches[3];
  const int k = plan_launches(reinterpret_cast<uintptr_t>(idx), reinterpret_cast<uintptr_t>(out),
                              n, kThreads, launches);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* t = static_cast<const float*>(table);
  const auto* i = static_cast<const int*>(idx);
  auto* o = static_cast<float*>(out);
  for (int j = 0; j < k; ++j) {
    const Launch& l = launches[j];
    const auto blocks = static_cast<unsigned>(l.blocks);
    if (l.vector)
      gather4_kernel<kThreads><<<blocks, kThreads, 0, s>>>(
          t, reinterpret_cast<const int4*>(i + l.first), reinterpret_cast<float4*>(o + l.first),
          l.count / 4);
    else
      gather1_kernel<kThreads><<<blocks, kThreads, 0, s>>>(t, i + l.first, o + l.first, l.count);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

const char* gym_gather_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
