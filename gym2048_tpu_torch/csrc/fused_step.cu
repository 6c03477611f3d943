// Fused 2048 step kernels for Hopper (sm_90a), with a plain C interface.
//
// Replaces the Pallas TPU kernels of gym2048_tpu/core/pallas_step.py:
//   fused_move_kernel          <- _move_kernel          (fused_move)
//   fused_step_uniform_kernel  <- _step_uniform_kernel  (fused_step_uniform)
//   fused_rollout_kernel       <- _rollout_kernel       (fused_rollout)
// and the statistics kernel of scripts/tpu_pallas_stats.py:
//   random_uniform_rows_kernel <- _uniform_kernel (pallas_step._random_uniform_rows)
// philox4x32_kernel exposes the generator itself, for its known-answer test.
//
// Design. One thread per board. The 16 cells of a board live in registers as
// int32 (exponents above 15 occur in real games, so cells are not packed into
// nibbles). Boards are cell-major [16, B] int32 as in the JAX module, so
// thread b reads board[c * B + b] and neighbouring threads touch neighbouring
// addresses. The TPU kernel's static row shuffles (_cell) and whole-tile
// selects (_select4) become compile-time register indexing after full
// unrolling; its prefix count over empty cells (a 16x16 triangular matmul on
// the MXU) becomes a 16-step running count. The rollout loops over its steps
// inside the thread and writes each board once, so a launch reads 64 bytes
// and writes 76 bytes per board whatever the number of steps.
//
// What bounds it on an H100. fused_rollout, fused_step_uniform and
// fused_move are integer ALU work: a step is well over a thousand SASS
// instructions per board (compact, merge and legality of 16 lines, action
// choice, spawn, ten Philox rounds; gym2048_tpu_torch/_sass.py counts them
// in the built library) against 140-152 bytes of memory traffic per board
// per launch. The rollout is therefore bound by the rate at which the card
// issues instructions; the single-step kernels by that rate or by their
// bytes, whichever is larger. random_uniform_rows is bound by the bytes it
// writes. A grid of
// ceil(B / 256) blocks of 256 threads; each kernel masks its ragged edge.
//
// Numbers: no fast math. The action index trunc(u * n_legal) and the spawn
// index floor(u * n_empty) are f32 products followed by truncation, as in
// the TPU kernel, and the 0.9 spawn threshold is the f32 constant 0.9f.
// Random numbers: Philox4x32-10 (Random123), key (seed, 0), counter
// (board, step, j, 0); j = 0 and 1 give the eight words of one step, and a
// word w becomes the uniform (w >> 8) * 2^-24 in [0, 1).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

struct Words {
  uint32_t x, y, z, w;
};

__device__ __forceinline__ Words philox4x32_10(Words c, uint32_t k0,
                                               uint32_t k1) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x);
    const uint32_t lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z);
    const uint32_t lo1 = 0xCD9E8D57u * c.z;
    c = Words{hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0};
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return c;
}

__device__ __forceinline__ float to_uniform(uint32_t w) {
  return static_cast<float>(w >> 8) * 5.9604644775390625e-8f;  // 2^-24
}

// Cell of (direction, line, position k in the line), so that every move is
// a leftward shift of the positions (pallas_step._cell).
__host__ __device__ constexpr int cell(int d, int l, int k) {
  return d == 0 ? 4 * k + l
       : d == 1 ? 4 * l + (3 - k)
       : d == 2 ? 4 * (3 - k) + l
                : 4 * l + k;
}

template <typename T>
__device__ __forceinline__ T select4(int v, T t0, T t1, T t2, T t3) {
  return v == 0 ? t0 : v == 1 ? t1 : v == 2 ? t2 : t3;
}

// Compact and merge one line leftward (rules._compact_merge_rows). Writes
// the line back in place, adds the merge score and returns whether the
// line changed.
__device__ __forceinline__ bool shift_line(int& a0, int& a1, int& a2, int& a3,
                                           int& score) {
  const int a[4] = {a0, a1, a2, a3};
  int pos[4];
  pos[0] = 0;
  pos[1] = a[0] != 0;
  pos[2] = pos[1] + (a[1] != 0);
  pos[3] = pos[2] + (a[2] != 0);
  int c[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    c[k] = 0;
#pragma unroll
    for (int j = k; j < 4; ++j) {
      if (a[j] != 0 && pos[j] == k) c[k] = a[j];
    }
  }
  const bool m01 = c[0] != 0 && c[0] == c[1];
  const bool m12 = c[1] != 0 && c[1] == c[2] && !m01;
  const bool m23 = c[2] != 0 && c[2] == c[3] && !m12;
  const int o0 = c[0] + m01;
  const int o1 = m01 ? c[2] + m23 : c[1] + m12;
  const int o2 = m01 ? (m23 ? 0 : c[3]) : (m12 ? c[3] : c[2] + m23);
  const int o3 = (m01 || m12 || m23) ? 0 : c[3];
  score += (m01 ? 1 << (c[0] + 1) : 0) + (m12 ? 1 << (c[1] + 1) : 0) +
           (m23 ? 1 << (c[2] + 1) : 0);
  const bool changed = o0 != a0 || o1 != a1 || o2 != a2 || o3 != a3;
  a0 = o0;
  a1 = o1;
  a2 = o2;
  a3 = o3;
  return changed;
}

// The four moves of board b: moved[d][cell], merge score and legality per
// direction (pallas_step._compute_moves).
__device__ __forceinline__ void compute_moves(const int (&b)[16],
                                              int (&moved)[4][16],
                                              int (&score)[4],
                                              bool (&legal)[4]) {
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    score[d] = 0;
    legal[d] = false;
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      int x0 = b[cell(d, l, 0)], x1 = b[cell(d, l, 1)];
      int x2 = b[cell(d, l, 2)], x3 = b[cell(d, l, 3)];
      legal[d] |= shift_line(x0, x1, x2, x3, score[d]);
      moved[d][cell(d, l, 0)] = x0;
      moved[d][cell(d, l, 1)] = x1;
      moved[d][cell(d, l, 2)] = x2;
      moved[d][cell(d, l, 3)] = x3;
    }
  }
}

// Spawn exponent 1 (u_val < 0.9f) or 2 at empty cell number
// min(floor(u_pos * n_empty), max(n_empty - 1, 0)) in row-major order; a
// full board is unchanged (pallas_step._spawn_cm: position first).
__device__ __forceinline__ void spawn(int (&b)[16], float u_pos, float u_val) {
  int n_empty = 0;
#pragma unroll
  for (int i = 0; i < 16; ++i) n_empty += b[i] == 0;
  const float nf = static_cast<float>(n_empty);
  const float kf = fminf(floorf(u_pos * nf), fmaxf(nf - 1.0f, 0.0f));
  const int target = static_cast<int>(kf) + 1;
  const int val = u_val < 0.9f ? 1 : 2;
  int seen = 0;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const bool empty = b[i] == 0;
    seen += empty;
    if (empty && seen == target) b[i] = val;
  }
}

// Random-legal move and spawn (the first half of pallas_step._step_cm):
// picks the r-th legal direction with r = trunc(u_act * n_legal), clamped,
// moves and spawns in place. Returns the action (0 for a dead board, which
// is left unchanged with move score 0) and sets finish for a dead board or,
// when max_tile_exp > 0, a board that holds that tile after the spawn.
__device__ __forceinline__ int move_and_spawn(int (&b)[16], float u_act,
                                              float u_pos, float u_val,
                                              int max_tile_exp,
                                              int& move_score, bool& finish) {
  int moved[4][16];
  int score[4];
  bool legal[4];
  compute_moves(b, moved, score, legal);
  const int n_legal = legal[0] + legal[1] + legal[2] + legal[3];
  int r = static_cast<int>(u_act * static_cast<float>(n_legal));
  r = min(r, max(n_legal - 1, 0));
  int action = 0, cum = 0;
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    if (legal[d] && cum == r) action = d;
    cum += legal[d];
  }
  move_score = select4(action, score[0], score[1], score[2], score[3]);
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    b[i] = select4(action, moved[0][i], moved[1][i], moved[2][i], moved[3][i]);
  }
  spawn(b, u_pos, u_val);
  bool won = false;
  if (max_tile_exp > 0) {
#pragma unroll
    for (int i = 0; i < 16; ++i) won |= b[i] == max_tile_exp;
  }
  finish = n_legal == 0 || won;
  return action;
}

// A reset board: two spawns on an empty board, from uniform rows 1-2 (the
// step's own spawn uniforms) and 3-4.
__device__ __forceinline__ void fresh_board(int (&b)[16], float u_pos,
                                            float u_val, float u_pos2,
                                            float u_val2) {
#pragma unroll
  for (int i = 0; i < 16; ++i) b[i] = 0;
  spawn(b, u_pos, u_val);
  spawn(b, u_pos2, u_val2);
}

__device__ __forceinline__ void load_board(int (&b)[16],
                                           const int* __restrict__ board,
                                           long long i, long long n) {
#pragma unroll
  for (int c = 0; c < 16; ++c) b[c] = board[c * n + i];
}

__device__ __forceinline__ void store_board(const int (&b)[16],
                                            int* __restrict__ board,
                                            long long i, long long n) {
#pragma unroll
  for (int c = 0; c < 16; ++c) board[c * n + i] = b[c];
}

__global__ void __launch_bounds__(kThreads)
fused_move_kernel(const int* __restrict__ board, const int* __restrict__ action,
                  int* __restrict__ out, int* __restrict__ score_out,
                  int* __restrict__ legal_out, long long n) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int b[16];
  load_board(b, board, i, n);
  int moved[4][16];
  int score[4];
  bool legal[4];
  compute_moves(b, moved, score, legal);
  const int a = action[i];
  const int ok = select4<int>(a, legal[0], legal[1], legal[2], legal[3]);
#pragma unroll
  for (int c = 0; c < 16; ++c) {
    const int m = select4(a, moved[0][c], moved[1][c], moved[2][c], moved[3][c]);
    out[c * n + i] = ok ? m : b[c];
  }
  score_out[i] = ok ? select4(a, score[0], score[1], score[2], score[3]) : 0;
  legal_out[i] = ok;
}

__global__ void __launch_bounds__(kThreads)
fused_step_uniform_kernel(const int* __restrict__ board,
                          const float* __restrict__ u, int* __restrict__ out,
                          float* __restrict__ score_out,
                          int* __restrict__ finished_out,
                          int* __restrict__ action_out, long long n,
                          int max_tile_exp) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int b[16];
  load_board(b, board, i, n);
  const float u_act = u[i], u_pos = u[n + i], u_val = u[2 * n + i];
  int move_score;
  bool finish;
  const int action =
      move_and_spawn(b, u_act, u_pos, u_val, max_tile_exp, move_score, finish);
  if (finish) fresh_board(b, u_pos, u_val, u[3 * n + i], u[4 * n + i]);
  store_board(b, out, i, n);
  score_out[i] = finish ? 0.0f : static_cast<float>(move_score);
  finished_out[i] = finish;
  action_out[i] = action;
}

__global__ void __launch_bounds__(kThreads)
fused_rollout_kernel(const int* __restrict__ board, uint32_t seed, int steps,
                     int max_tile_exp, int* __restrict__ out,
                     float* __restrict__ score_out,
                     int* __restrict__ episodes_out,
                     float* __restrict__ total_out, long long n) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int b[16];
  load_board(b, board, i, n);
  float score = 0.0f, total = 0.0f;
  int episodes = 0;
  const uint32_t idx = static_cast<uint32_t>(i);
  for (int t = 0; t < steps; ++t) {
    const Words w = philox4x32_10(Words{idx, static_cast<uint32_t>(t), 0u, 0u},
                                  seed, 0u);
    const float u_pos = to_uniform(w.y), u_val = to_uniform(w.z);
    int move_score;
    bool finish;
    move_and_spawn(b, to_uniform(w.x), u_pos, u_val, max_tile_exp, move_score,
                   finish);
    const float gained = static_cast<float>(move_score);
    if (finish) {
      // the second Philox block is drawn only where a reset needs row 4
      const Words w1 = philox4x32_10(
          Words{idx, static_cast<uint32_t>(t), 1u, 0u}, seed, 0u);
      fresh_board(b, u_pos, u_val, to_uniform(w.w), to_uniform(w1.x));
      score = 0.0f;
      episodes += 1;
    } else {
      score = score + gained;
    }
    total = total + gained;
  }
  store_board(b, out, i, n);
  score_out[i] = score;
  episodes_out[i] = episodes;
  total_out[i] = total;
}

// Thread (g, c) writes rows 4g..4g+3 of column c: the words of counter
// (c, g / 2, g % 2, 0), so that row r is uniform row r % 8 of step r / 8.
__global__ void __launch_bounds__(kThreads)
random_uniform_rows_kernel(uint32_t seed, float* __restrict__ out,
                           long long rows, long long cols) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long groups = (rows + 3) / 4;
  if (idx >= groups * cols) return;
  const long long c = idx % cols, g = idx / cols;
  const Words w = philox4x32_10(
      Words{static_cast<uint32_t>(c), static_cast<uint32_t>(g / 2),
            static_cast<uint32_t>(g % 2), 0u},
      seed, 0u);
  const uint32_t v[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const long long r = 4 * g + k;
    if (r < rows) out[r * cols + c] = to_uniform(v[k]);
  }
}

__global__ void __launch_bounds__(kThreads)
philox4x32_kernel(const uint32_t* __restrict__ counter,
                  const uint32_t* __restrict__ key, uint32_t* __restrict__ out,
                  long long n) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Words w = philox4x32_10(
      Words{counter[4 * i], counter[4 * i + 1], counter[4 * i + 2],
            counter[4 * i + 3]},
      key[2 * i], key[2 * i + 1]);
  out[4 * i] = w.x;
  out[4 * i + 1] = w.y;
  out[4 * i + 2] = w.z;
  out[4 * i + 3] = w.w;
}

unsigned grid_for(long long work) {
  return static_cast<unsigned>((work + kThreads - 1) / kThreads);
}

}  // namespace

// Launchers: each enqueues one kernel on `stream` and returns
// cudaGetLastError() (0 on success). Callers pass n >= 1.
extern "C" {

int gym_fused_move(const void* board, const void* action, void* out,
                   void* score, void* legal, long long n, void* stream) {
  fused_move_kernel<<<grid_for(n), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(board), static_cast<const int*>(action),
      static_cast<int*>(out), static_cast<int*>(score),
      static_cast<int*>(legal), n);
  return static_cast<int>(cudaGetLastError());
}

int gym_fused_step_uniform(const void* board, const void* u, void* out,
                           void* score, void* finished, void* action,
                           long long n, int max_tile_exp, void* stream) {
  fused_step_uniform_kernel<<<grid_for(n), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(board), static_cast<const float*>(u),
      static_cast<int*>(out), static_cast<float*>(score),
      static_cast<int*>(finished), static_cast<int*>(action), n,
      max_tile_exp);
  return static_cast<int>(cudaGetLastError());
}

int gym_fused_rollout(const void* board, uint32_t seed, int steps,
                      int max_tile_exp, void* out, void* score,
                      void* episodes, void* total, long long n, void* stream) {
  fused_rollout_kernel<<<grid_for(n), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(board), seed, steps, max_tile_exp,
      static_cast<int*>(out), static_cast<float*>(score),
      static_cast<int*>(episodes), static_cast<float*>(total), n);
  return static_cast<int>(cudaGetLastError());
}

int gym_random_uniform_rows(uint32_t seed, void* out, long long rows,
                            long long cols, void* stream) {
  random_uniform_rows_kernel<<<grid_for((rows + 3) / 4 * cols), kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      seed, static_cast<float*>(out), rows, cols);
  return static_cast<int>(cudaGetLastError());
}

int gym_philox4x32(const void* counter, const void* key, void* out,
                   long long n, void* stream) {
  philox4x32_kernel<<<grid_for(n), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(counter), static_cast<const uint32_t*>(key),
      static_cast<uint32_t*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

const char* gym_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
