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
// Design. gather4_kernel: one thread per four indices, one 16-byte load of
// indices (coalesced across the warp), four independent table reads
// through the read-only path (__ldg) and one 16-byte store. The indices
// and the output are touched once, so they are loaded and stored with the
// streaming hints (__ldcs, __stcs) and do not push table sectors out of
// L2. Addresses are 64-bit (pointer plus a sign-extended index): the
// staged 4x6 table has 201,326,592 entries. gather1_kernel, one index per
// thread, takes the ragged tail and any index or output pointer that is
// not 16-byte aligned. Indices must lie in [0, S); the kernel does not
// check them.
//
// What bounds it on an H100. Each lookup reads one 32-byte sector of the
// table unless L2 (50 MB) holds it already; the staged 4x6 table is 805 MB,
// so a uniform index stream misses almost always and the kernel is bound by
// device memory: 8 bytes per index of stream plus 32 bytes per distinct
// sector touched. A search's index stream repeats most sectors, and L2
// serves those. The instructions per index are few (gym2048_tpu_torch/
// _sass.py counts them in the built library), so issue binds only when L2
// serves nearly everything. Making it faster (sorting or deduplicating the
// stream, fusing index computation, lookup and sum) is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void gather4_kernel(const float* __restrict__ table,
                               const int4* __restrict__ idx,
                               float4* __restrict__ out, long long n4) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n4) return;
  const int4 k = __ldcs(idx + i);
  float4 v;
  v.x = __ldg(table + k.x);
  v.y = __ldg(table + k.y);
  v.z = __ldg(table + k.z);
  v.w = __ldg(table + k.w);
  __stcs(out + i, v);
}

__global__ void gather1_kernel(const float* __restrict__ table,
                               const int* __restrict__ idx,
                               float* __restrict__ out, long long n) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  out[i] = __ldg(table + __ldcs(idx + i));
}

unsigned grid_for(long long work) {
  return static_cast<unsigned>((work + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// Enqueues the lookup of n >= 1 indices on `stream`: gather4_kernel over
// the first 4 * (n / 4) when both pointers are 16-byte aligned, and
// gather1_kernel over the rest. Returns the first cudaGetLastError() code
// that is not 0, else 0.
int gym_gather_values(const void* table, const void* idx, void* out,
                      long long n, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* t = static_cast<const float*>(table);
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(idx) | reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  const long long n4 = aligned ? n / 4 : 0;
  if (n4 > 0) {
    gather4_kernel<<<grid_for(n4), kThreads, 0, s>>>(
        t, static_cast<const int4*>(idx), static_cast<float4*>(out), n4);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long done = 4 * n4;
  if (n > done) {
    gather1_kernel<<<grid_for(n - done), kThreads, 0, s>>>(
        t, static_cast<const int*>(idx) + done, static_cast<float*>(out) + done,
        n - done);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* gym_gather_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
