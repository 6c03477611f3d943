// BatchNorm with the residual add and the ReLU, forward and backward, for
// Hopper (sm_90a), with a plain C interface:
//   y = relu(batch_norm(x) [+ residual])
// over channels-last activations: `rows` = N * H * W rows of C contiguous
// values, bfloat16 or float32, with float32 statistics, scale, bias,
// accumulation and parameter gradients.
//
// Replaces no Pallas kernel: flax's nn.BatchNorm, the residual add and the
// ReLU of gym2048_tpu/models/resnet.py were XLA's own fusions. It replaces
// torch's native BatchNorm kernels (statistics, transform, backward reduce
// and elementwise), the add, the ReLU, its backward and the five small
// kernels of flax's running-statistics rule in the port's ResNet.
//
// What bounds it on an H100: bytes. Every kernel does a few flops a value
// (far below the ~295 a byte where bf16 compute would limit), so each pass
// over an activation (33.6 MB at 16,384 x 64 x 4 x 4 bf16, 10 us at 3.35
// TB/s) is the cost. Design: as few passes as the dependencies allow.
// - Forward, train: one read of x for the statistics (gym_bn_stats_kernel:
//   per-block partial sums, merged by gym_bn_finalize_stats_kernel, which
//   also applies flax's running-statistics rule), then one read of x (and
//   the residual) and one write of y (gym_bn_apply_kernel), launched right
//   behind so that its read of x can hit the 50 MB L2. Eval: the apply alone,
//   its scale and shift from the running statistics.
// - Backward: one read of dy, y (the ReLU's mask) and x for the two
//   per-channel sums (gym_bn_backward_reduce_kernel, merged by
//   gym_bn_finalize_backward_kernel into the parameter gradients and dx's
//   coefficients), then one read of dy, y and x and one write of dx, and of
//   the residual's gradient (gym_bn_backward_elemt_kernel).
// Every row kernel walks a stripe of rows in 16-byte loads (8 bf16 or 4 f32
// channels a thread) where C times the element size is a multiple of 16 and
// the pointers are 16-byte aligned, one value a thread otherwise; a thread
// keeps one column group of the stripe, so its per-channel factors and sums
// stay in registers, and four to eight rows of loads are in flight a
// thread (past the last row they load it again, so no row waits alone). The
// variance is merged without cancellation: each thread sums x - K, with K
// the channel's value in row 0, and the per-block partial sums are merged in
// float64. No kernel allocates, synchronises the host or uses atomics: the
// sums are in a fixed order, the result is deterministic, and every launch
// can be captured in a CUDA graph.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

// What needs CUDA, each behind a helper that the host test
// (tests/test_torch_batch_norm_host.py) defines for g++: everything after
// these helpers compiles there as a host library with the same C interface.
__device__ __forceinline__ void block_sync() { __syncthreads(); }
__device__ __forceinline__ uint32_t bits_of(float v) { return __float_as_uint(v); }
__device__ __forceinline__ float float_of(uint32_t u) { return __uint_as_float(u); }
__device__ __forceinline__ uint4 load16(const void* p) { return *static_cast<const uint4*>(p); }
__device__ __forceinline__ void store16(void* p, uint4 v) { *static_cast<uint4*>(p) = v; }

// kernel<<<grid, threads, 0, s>>>(args...) -> the launch's error.
template <typename... Params, typename... Args>
cudaError_t launch(void (*kernel)(Params...), unsigned grid, unsigned threads, cudaStream_t s,
                   Args... args) {
  kernel<<<grid, threads, 0, s>>>(args...);
  return cudaGetLastError();
}

namespace {

constexpr int kThreads = 256;         // threads a block of the row kernels
constexpr int kFinalizeThreads = 1024;  // threads a block of the finalize kernels
// the row kernels' grids, in blocks an SM: the reductions' (whose partial
// sums the finalize kernels merge) and the elementwise kernels'
constexpr int kReduceBlocksPerSm = 2;
constexpr int kElementBlocksPerSm = 4;
// rows a thread of each row kernel loads before it uses them (its loads in
// flight; a row past the last loads the last again and counts for nothing,
// so the loads need no predicate and a thread's stripe takes ceil(passes /
// rows) round trips to memory): more for the kernel that reads one tensor a
// row
constexpr int kStatsRows = 8;
constexpr int kApplyRows = 4;
constexpr int kReduceRows = 4;
constexpr int kElemtRows = 4;

// The storage of a bfloat16.
struct Bf16 {
  uint16_t bits;
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(Bf16 v) {
  return float_of(static_cast<uint32_t>(v.bits) << 16);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
// Round to nearest even, NaN to the canonical quiet NaN, as torch rounds.
template <>
__device__ __forceinline__ Bf16 from_float<Bf16>(float v) {
  const uint32_t u = bits_of(v);
  if ((u & 0x7fffffffu) > 0x7f800000u) return Bf16{0x7fc0};
  return Bf16{static_cast<uint16_t>((u + 0x7fffu + ((u >> 16) & 1u)) >> 16)};
}

// V values of a row at p, as floats: one 16-byte load, or one value.
template <typename T, int V>
__device__ __forceinline__ void load_pack(const T* p, float (&out)[V]) {
  if constexpr (V == 1) {
    out[0] = to_float(*p);
  } else {
    static_assert(V * sizeof(T) == 16, "a pack is one value or 16 bytes");
    union {
      uint4 raw;
      T e[V];
    } u;
    u.raw = load16(p);
#pragma unroll
    for (int v = 0; v < V; ++v) out[v] = to_float(u.e[v]);
  }
}

template <typename T, int V>
__device__ __forceinline__ void store_pack(T* p, const float (&in)[V]) {
  if constexpr (V == 1) {
    *p = from_float<T>(in[0]);
  } else {
    union {
      uint4 raw;
      T e[V];
    } u;
#pragma unroll
    for (int v = 0; v < V; ++v) u.e[v] = from_float<T>(in[v]);
    store16(p, u.raw);
  }
}

// A row of a stripe's pass, or the last row for one past it.
__device__ __forceinline__ long long clamp_row(long long row, long long rows) {
  return row < rows ? row : rows - 1;
}

__device__ __forceinline__ float relu(float z) { return z < 0.0f ? 0.0f : z; }  // NaN stays
// The ReLU's gradient from its output, as torch's threshold_backward.
__device__ __forceinline__ float relu_grad(float dy, float y) { return y <= 0.0f ? 0.0f : dy; }

// How a block of Threads threads covers a (rows, C) matrix in column groups
// of V: thread t takes group t % groups of row t / groups of each pass of
// `per_pass` rows; threads past groups * per_pass take none. Pass k of
// block b starts at row (k * gridDim.x + b) * per_pass.
struct Stripe {
  int group, row, per_pass;
  __device__ __forceinline__ bool active() const { return row < per_pass; }
};

template <int V, int Threads>
__device__ __forceinline__ Stripe stripe_of(int C, unsigned thread) {
  const int groups = C / V;
  return Stripe{static_cast<int>(thread) % groups, static_cast<int>(thread) / groups,
                Threads / groups};
}

// Each channel's two sums over the block's threads, written to the block's
// row of `partial` ([block][2][C] floats): the threads' sums go to shared
// memory, a tree over the pass's rows adds them, and row 0's threads write.
template <int V, int Threads>
__device__ __forceinline__ void block_partials(float (&s1)[V], float (&s2)[V], int C,
                                               const Stripe& st, unsigned block,
                                               float* __restrict__ partial) {
  __shared__ float shared[2][Threads * V];
  const int at = st.row * C + st.group * V;
  if (st.active()) {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      shared[0][at + v] = s1[v];
      shared[1][at + v] = s2[v];
    }
  }
  block_sync();
  for (int width = st.per_pass; width > 1;) {
    const int half = (width + 1) / 2;
    if (st.row < width - half) {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        shared[0][at + v] += shared[0][at + half * C + v];
        shared[1][at + v] += shared[1][at + half * C + v];
      }
    }
    block_sync();
    width = half;
  }
  if (st.row == 0) {
    float* out = partial + 2LL * C * block + st.group * V;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      out[v] = shared[0][at + v];
      out[C + v] = shared[1][at + v];
    }
  }
}

// The merge in float64 of two partial sums of `blocks` blocks ([block][2][C]
// floats), for the channels of this block of the finalize grid: thread t
// takes channel block * per_block + t % per_block and every lanes-th row of
// partials from row t / per_block on, and a tree over the lanes in shared
// memory adds theirs. Returns on the thread of a channel's lane 0 true, its
// channel in `c` and the sums in s1 and s2.
template <int Threads>
__device__ __forceinline__ bool merge_partials(const float* __restrict__ partial, int blocks,
                                               int C, unsigned thread, unsigned block, int& c,
                                               double& s1, double& s2) {
  __shared__ double shared[2][Threads];
  const int per_block = C < Threads ? C : Threads;
  const int lanes = Threads / per_block;
  const int lane = static_cast<int>(thread) / per_block;
  c = static_cast<int>(block) * per_block + static_cast<int>(thread) % per_block;
  const bool active = lane < lanes && c < C;
  double a = 0.0, b = 0.0;
  if (active) {
#pragma unroll 8
    for (int k = lane; k < blocks; k += lanes) {
      a += partial[2LL * C * k + c];
      b += partial[2LL * C * k + C + c];
    }
  }
  shared[0][thread] = a;
  shared[1][thread] = b;
  block_sync();
  for (int width = lanes; width > 1;) {
    const int half = (width + 1) / 2;
    if (active && lane < width - half) {
      shared[0][thread] += shared[0][thread + half * per_block];
      shared[1][thread] += shared[1][thread + half * per_block];
    }
    block_sync();
    width = half;
  }
  s1 = shared[0][thread];
  s2 = shared[1][thread];
  return active && lane == 0;
}

// Per-block sums of x - K and (x - K)^2 for every channel, K the channel's
// value in row 0.
template <typename T, int V, int Threads>
__global__ void __launch_bounds__(Threads)
    gym_bn_stats_kernel(const T* __restrict__ x, long long rows, int C,
                        float* __restrict__ partial) {
  const Stripe st = stripe_of<V, Threads>(C, threadIdx.x);
  float s1[V] = {}, s2[V] = {};
  if (st.active()) {
    const int col = st.group * V;
    float shift[V];
    load_pack<T, V>(x + col, shift);
    const long long step = static_cast<long long>(gridDim.x) * st.per_pass;
    for (long long row = static_cast<long long>(blockIdx.x) * st.per_pass + st.row; row < rows;
         row += kStatsRows * step) {
      float a[kStatsRows][V];
#pragma unroll
      for (int u = 0; u < kStatsRows; ++u)
        load_pack<T, V>(x + clamp_row(row + u * step, rows) * C + col, a[u]);
#pragma unroll
      for (int u = 0; u < kStatsRows; ++u) {
        const bool in = row + u * step < rows;  // else a repeat of the last row: adds 0
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const float d = in ? a[u][v] - shift[v] : 0.0f;
          s1[v] += d;
          s2[v] += d * d;
        }
      }
    }
  }
  block_partials<V, Threads>(s1, s2, C, st, blockIdx.x, partial);
}

// The batch's mean and inverse deviation from the partial sums of `blocks`
// blocks (merge_partials), and flax's running-statistics rule: each moves by
// `momentum` towards the batch's mean and its biased variance, clipped at 0.
template <typename T, int Threads>
__global__ void __launch_bounds__(Threads)
    gym_bn_finalize_stats_kernel(const T* __restrict__ x, const float* __restrict__ partial,
                                 int blocks, int C, long long rows, double eps, float momentum,
                                 float* __restrict__ mean, float* __restrict__ invstd,
                                 float* __restrict__ running_mean,
                                 float* __restrict__ running_var) {
  int c;
  double s1, s2;
  if (!merge_partials<Threads>(partial, blocks, C, threadIdx.x, blockIdx.x, c, s1, s2)) return;
  const double n = static_cast<double>(rows);
  const double shifted = s1 / n;
  double var = s2 / n - shifted * shifted;
  if (var < 0.0) var = 0.0;
  const float m = static_cast<float>(to_float(x[c]) + shifted);
  mean[c] = m;
  invstd[c] = static_cast<float>(1.0 / sqrt(var + eps));
  running_mean[c] += momentum * (m - running_mean[c]);
  running_var[c] += momentum * (static_cast<float>(var) - running_var[c]);
}

// y = relu(x * scale + shift [+ residual]) with each channel's scale =
// weight * invstd and shift = bias - mean * scale; invstd is given (train) or
// 1 / sqrt(var + eps) of the running variance `var` (eval, invstd null).
template <typename T, int V, int Threads>
__global__ void __launch_bounds__(Threads)
    gym_bn_apply_kernel(const T* __restrict__ x, const T* __restrict__ residual,
                        T* __restrict__ y, long long rows, int C, const float* __restrict__ mean,
                        const float* __restrict__ invstd, const float* __restrict__ var,
                        double eps, const float* __restrict__ weight,
                        const float* __restrict__ bias) {
  const Stripe st = stripe_of<V, Threads>(C, threadIdx.x);
  if (!st.active()) return;
  const int col = st.group * V;
  float scale[V], shift[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int c = col + v;
    const float is = invstd != nullptr ? invstd[c]
                                       : static_cast<float>(1.0 / sqrt(var[c] + eps));
    scale[v] = weight[c] * is;
    shift[v] = bias[c] - mean[c] * scale[v];
  }
  const long long step = static_cast<long long>(gridDim.x) * st.per_pass;
  for (long long row = static_cast<long long>(blockIdx.x) * st.per_pass + st.row; row < rows;
       row += kApplyRows * step) {
    float a[kApplyRows][V], r[kApplyRows][V];
#pragma unroll
    for (int u = 0; u < kApplyRows; ++u) {
      const long long at = clamp_row(row + u * step, rows) * C + col;
      load_pack<T, V>(x + at, a[u]);
      if (residual != nullptr) load_pack<T, V>(residual + at, r[u]);
    }
#pragma unroll
    for (int u = 0; u < kApplyRows; ++u) {
      if (row + u * step >= rows) break;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float z = a[u][v] * scale[v] + shift[v];
        a[u][v] = relu(residual != nullptr ? z + r[u][v] : z);
      }
      store_pack<T, V>(y + (row + u * step) * C + col, a[u]);
    }
  }
}

// Per-block sums of g and g * (x - mean) for every channel, g = dy where
// y > 0, else 0.
template <typename T, int V, int Threads>
__global__ void __launch_bounds__(Threads)
    gym_bn_backward_reduce_kernel(const T* __restrict__ dy, const T* __restrict__ y,
                                  const T* __restrict__ x, long long rows, int C,
                                  const float* __restrict__ mean, float* __restrict__ partial) {
  const Stripe st = stripe_of<V, Threads>(C, threadIdx.x);
  float s1[V] = {}, s2[V] = {};
  if (st.active()) {
    const int col = st.group * V;
    float m[V];
#pragma unroll
    for (int v = 0; v < V; ++v) m[v] = mean[col + v];
    const long long step = static_cast<long long>(gridDim.x) * st.per_pass;
    for (long long row = static_cast<long long>(blockIdx.x) * st.per_pass + st.row; row < rows;
         row += kReduceRows * step) {
      float d[kReduceRows][V], o[kReduceRows][V], a[kReduceRows][V];
#pragma unroll
      for (int u = 0; u < kReduceRows; ++u) {
        const long long at = clamp_row(row + u * step, rows) * C + col;
        load_pack<T, V>(dy + at, d[u]);
        load_pack<T, V>(y + at, o[u]);
        load_pack<T, V>(x + at, a[u]);
      }
#pragma unroll
      for (int u = 0; u < kReduceRows; ++u) {
        const bool in = row + u * step < rows;  // else a repeat of the last row: g = 0
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const float g = in ? relu_grad(d[u][v], o[u][v]) : 0.0f;
          s1[v] += g;
          s2[v] += g * (a[u][v] - m[v]);
        }
      }
    }
  }
  block_partials<V, Threads>(s1, s2, C, st, blockIdx.x, partial);
}

// From the partial sums (merged in float64): dbias = sum g, dweight =
// invstd * sum g (x - mean), and dx's coefficients ([3][C] floats):
// dx = k (g - a - (x - mean) b) with k = weight * invstd and, in train mode,
// a = sum g / n and b = invstd^2 sum g (x - mean) / n (the batch statistics'
// own gradient); in eval mode the statistics are constants and a = b = 0.
template <int Threads>
__global__ void __launch_bounds__(Threads)
    gym_bn_finalize_backward_kernel(const float* __restrict__ partial, int blocks, int C,
                                    long long rows, const float* __restrict__ invstd,
                                    const float* __restrict__ weight, int train,
                                    float* __restrict__ dweight, float* __restrict__ dbias,
                                    float* __restrict__ coef) {
  int c;
  double sg, sgx;
  if (!merge_partials<Threads>(partial, blocks, C, threadIdx.x, blockIdx.x, c, sg, sgx)) return;
  const double is = invstd[c], n = static_cast<double>(rows);
  dbias[c] = static_cast<float>(sg);
  dweight[c] = static_cast<float>(sgx * is);
  coef[c] = weight[c] * invstd[c];
  coef[C + c] = train ? static_cast<float>(sg / n) : 0.0f;
  coef[2 * C + c] = train ? static_cast<float>(sgx * is * is / n) : 0.0f;
}

// dx = k (g - a - (x - mean) b) (see gym_bn_finalize_backward_kernel), and
// the residual's gradient g where `dresidual` is not null.
template <typename T, int V, int Threads>
__global__ void __launch_bounds__(Threads)
    gym_bn_backward_elemt_kernel(const T* __restrict__ dy, const T* __restrict__ y,
                                 const T* __restrict__ x, T* __restrict__ dx,
                                 T* __restrict__ dresidual, long long rows, int C,
                                 const float* __restrict__ mean, const float* __restrict__ coef) {
  const Stripe st = stripe_of<V, Threads>(C, threadIdx.x);
  if (!st.active()) return;
  const int col = st.group * V;
  float k[V], a[V], b[V], m[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    k[v] = coef[col + v];
    a[v] = coef[C + col + v];
    b[v] = coef[2 * C + col + v];
    m[v] = mean[col + v];
  }
  const long long step = static_cast<long long>(gridDim.x) * st.per_pass;
  for (long long row = static_cast<long long>(blockIdx.x) * st.per_pass + st.row; row < rows;
       row += kElemtRows * step) {
    float d[kElemtRows][V], o[kElemtRows][V], xs[kElemtRows][V];
#pragma unroll
    for (int u = 0; u < kElemtRows; ++u) {
      const long long at = clamp_row(row + u * step, rows) * C + col;
      load_pack<T, V>(dy + at, d[u]);
      load_pack<T, V>(y + at, o[u]);
      load_pack<T, V>(x + at, xs[u]);
    }
#pragma unroll
    for (int u = 0; u < kElemtRows; ++u) {
      if (row + u * step >= rows) break;
      const long long at = (row + u * step) * C + col;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float g = relu_grad(d[u][v], o[u][v]);
        d[u][v] = g;
        o[u][v] = k[v] * (g - a[v] - (xs[u][v] - m[v]) * b[v]);
      }
      store_pack<T, V>(dx + at, o[u]);
      if (dresidual != nullptr) store_pack<T, V>(dresidual + at, d[u]);
    }
  }
}

// The grid of a row kernel: one pass of `per_pass` rows a block, at most
// `max_blocks` blocks, at least one.
long long row_blocks(long long rows, int per_pass, long long max_blocks) {
  return std::max<long long>(std::min<long long>((rows + per_pass - 1) / per_pass, max_blocks),
                             1);
}

// The finalize kernels' grid: per_block channels a block (merge_partials).
long long channel_blocks(int C, int threads) {
  const int per_block = C < threads ? C : threads;
  return (C + per_block - 1) / per_block;
}

// The widest pack the row kernels take for C channels of `elem` bytes at
// 16-byte aligned pointers (`aligned`): 16 bytes where C * elem is a
// multiple of 16, else one value; 0 where a block cannot hold a row's
// column groups (C / V > kThreads).
int pack_width(int C, int elem, bool aligned, int threads) {
  const int v = (aligned && (C * elem) % 16 == 0) ? 16 / elem : 1;
  return (C > 0 && C / v <= threads) ? v : 0;
}


// The grids of a call: the reduction's (its partial sums at most `capacity`
// rows), the elementwise kernel's and the finalize kernel's.
struct Grids {
  unsigned reduce, element, finalize;
};

Grids grids_of(long long rows, int C, int V, int sms, int capacity) {
  const int per_pass = kThreads / (C / V);
  const long long reduce = std::min<long long>(static_cast<long long>(kReduceBlocksPerSm) * sms,
                                               capacity);
  return Grids{static_cast<unsigned>(row_blocks(rows, per_pass, reduce)),
               static_cast<unsigned>(row_blocks(
                   rows, per_pass, static_cast<long long>(kElementBlocksPerSm) * sms)),
               static_cast<unsigned>(channel_blocks(C, kFinalizeThreads))};
}

template <typename T, int V>
int forward(const T* x, const T* residual, T* y, long long rows, int C, const float* weight,
            const float* bias, float* running_mean, float* running_var, int train,
            float momentum, double eps, float* mean, float* invstd, float* scratch,
            int capacity, int sms, cudaStream_t s) {
  const Grids g = grids_of(rows, C, V, sms, capacity);
  if (!train)
    return static_cast<int>(launch(gym_bn_apply_kernel<T, V, kThreads>, g.element, kThreads, s, x,
                                   residual, y, rows, C, running_mean, nullptr, running_var, eps,
                                   weight, bias));
  cudaError_t err = launch(gym_bn_stats_kernel<T, V, kThreads>, g.reduce, kThreads, s, x, rows, C,
                           scratch);
  if (err == cudaSuccess)
    err = launch(gym_bn_finalize_stats_kernel<T, kFinalizeThreads>, g.finalize, kFinalizeThreads,
                 s, x, scratch, static_cast<int>(g.reduce), C, rows, eps, momentum, mean, invstd,
                 running_mean, running_var);
  if (err == cudaSuccess)
    err = launch(gym_bn_apply_kernel<T, V, kThreads>, g.element, kThreads, s, x, residual, y, rows,
                 C, mean, invstd, nullptr, eps, weight, bias);
  return static_cast<int>(err);
}

template <typename T, int V>
int backward(const T* dy, const T* y, const T* x, T* dx, T* dresidual, long long rows, int C,
             const float* weight, const float* mean, const float* invstd, int train,
             float* dweight, float* dbias, float* coef, float* scratch, int capacity, int sms,
             cudaStream_t s) {
  const Grids g = grids_of(rows, C, V, sms, capacity);
  cudaError_t err = launch(gym_bn_backward_reduce_kernel<T, V, kThreads>, g.reduce, kThreads, s,
                           dy, y, x, rows, C, mean, scratch);
  if (err == cudaSuccess)
    err = launch(gym_bn_finalize_backward_kernel<kFinalizeThreads>, g.finalize, kFinalizeThreads,
                 s, scratch, static_cast<int>(g.reduce), C, rows, invstd, weight, train, dweight,
                 dbias, coef);
  if (err == cudaSuccess)
    err = launch(gym_bn_backward_elemt_kernel<T, V, kThreads>, g.element, kThreads, s, dy, y, x,
                 dx, dresidual, rows, C, mean, coef);
  return static_cast<int>(err);
}

constexpr int kBadArguments = -1;  // a dtype, C or alignment the kernels do not take

}  // namespace

extern "C" {

// y = relu(batch_norm(x) [+ residual]) on `stream` for `rows` rows of C
// channels; dtype 0 is float32, 1 bfloat16 (x, residual, y), everything
// else float32. train: the batch's statistics into mean and invstd (C each),
// the running statistics updated by flax's rule, `scratch` holding
// 2 * C * capacity floats of partial sums; eval: the running statistics
// (mean, invstd and scratch unused). `aligned`: every row pointer is 16-byte
// aligned. Returns the CUDA error of the first launch that fails, 0 if none,
// or -1 for arguments the kernels do not take.
int gym_bn_forward(int dtype, int aligned, const void* x, const void* residual, void* y,
                   long long rows, int C, const void* weight, const void* bias,
                   void* running_mean, void* running_var, int train, float momentum,
                   double eps, void* mean, void* invstd, void* scratch, int capacity, int sms,
                   void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* w = static_cast<const float*>(weight);
  const auto* b = static_cast<const float*>(bias);
  auto* rm = static_cast<float*>(running_mean);
  auto* rv = static_cast<float*>(running_var);
  auto* m = static_cast<float*>(mean);
  auto* is = static_cast<float*>(invstd);
  auto* sc = static_cast<float*>(scratch);
  const int elem = dtype == 0 ? 4 : dtype == 1 ? 2 : 0;
  const int v = elem ? pack_width(C, elem, aligned != 0, kThreads) : 0;
  if (v == 0 || rows <= 0 || sms <= 0 || (train && capacity <= 0)) return kBadArguments;
  if (dtype == 0) {
    const auto* xi = static_cast<const float*>(x);
    const auto* ri = static_cast<const float*>(residual);
    auto* yo = static_cast<float*>(y);
    return v == 1 ? forward<float, 1>(xi, ri, yo, rows, C, w, b, rm, rv, train, momentum, eps, m,
                                      is, sc, capacity, sms, s)
                  : forward<float, 4>(xi, ri, yo, rows, C, w, b, rm, rv, train, momentum, eps, m,
                                      is, sc, capacity, sms, s);
  }
  const auto* xi = static_cast<const Bf16*>(x);
  const auto* ri = static_cast<const Bf16*>(residual);
  auto* yo = static_cast<Bf16*>(y);
  return v == 1 ? forward<Bf16, 1>(xi, ri, yo, rows, C, w, b, rm, rv, train, momentum, eps, m, is,
                                   sc, capacity, sms, s)
                : forward<Bf16, 8>(xi, ri, yo, rows, C, w, b, rm, rv, train, momentum, eps, m, is,
                                   sc, capacity, sms, s);
}

// The gradients of gym_bn_forward's y: dx, the residual's (where dresidual
// is not null), dweight and dbias (float32, C each), from dy, the saved y
// and x and the statistics the forward normalised with (train: the batch's;
// eval: the running mean and its inverse deviation). `coef` holds 3 * C
// floats and `scratch` 2 * C * capacity. Returns as gym_bn_forward.
int gym_bn_backward(int dtype, int aligned, const void* dy, const void* y, const void* x,
                    void* dx, void* dresidual, long long rows, int C, const void* weight,
                    const void* mean, const void* invstd, int train, void* dweight, void* dbias,
                    void* coef, void* scratch, int capacity, int sms, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* w = static_cast<const float*>(weight);
  const auto* m = static_cast<const float*>(mean);
  const auto* is = static_cast<const float*>(invstd);
  auto* dw = static_cast<float*>(dweight);
  auto* db = static_cast<float*>(dbias);
  auto* cf = static_cast<float*>(coef);
  auto* sc = static_cast<float*>(scratch);
  const int elem = dtype == 0 ? 4 : dtype == 1 ? 2 : 0;
  const int v = elem ? pack_width(C, elem, aligned != 0, kThreads) : 0;
  if (v == 0 || rows <= 0 || sms <= 0 || capacity <= 0) return kBadArguments;
  if (dtype == 0) {
    const auto* d = static_cast<const float*>(dy);
    const auto* yi = static_cast<const float*>(y);
    const auto* xi = static_cast<const float*>(x);
    auto* o = static_cast<float*>(dx);
    auto* r = static_cast<float*>(dresidual);
    return v == 1 ? backward<float, 1>(d, yi, xi, o, r, rows, C, w, m, is, train, dw, db, cf, sc,
                                       capacity, sms, s)
                  : backward<float, 4>(d, yi, xi, o, r, rows, C, w, m, is, train, dw, db, cf, sc,
                                       capacity, sms, s);
  }
  const auto* d = static_cast<const Bf16*>(dy);
  const auto* yi = static_cast<const Bf16*>(y);
  const auto* xi = static_cast<const Bf16*>(x);
  auto* o = static_cast<Bf16*>(dx);
  auto* r = static_cast<Bf16*>(dresidual);
  return v == 1 ? backward<Bf16, 1>(d, yi, xi, o, r, rows, C, w, m, is, train, dw, db, cf, sc,
                                    capacity, sms, s)
                : backward<Bf16, 8>(d, yi, xi, o, r, rows, C, w, m, is, train, dw, db, cf, sc,
                                    capacity, sms, s);
}

const char* gym_bn_error_string(int err) {
  if (err == kBadArguments) return "arguments the batch_norm kernels do not take";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
