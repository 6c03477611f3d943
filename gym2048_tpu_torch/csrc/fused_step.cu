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
// addresses.
//
// One step algorithm serves fused_step_uniform and fused_rollout (step_one),
// and fused_move moves with the same code. The legality of the four
// directions is read from the board's 24 adjacent pairs (legal_from_pairs)
// without moving it; the action is picked from them; the board is moved in
// that direction only: a conditional transpose and a conditional mirror
// (selects, no branch on the action, which differs across a warp) bring
// the direction into the frame where the move is a leftward shift of rows,
// its four rows are compacted and merged once (slide_line), and the frame
// is undone (move_one). Then one spawn: the TPU kernel's prefix count over
// empty cells (a 16x16 triangular matmul on the MXU) becomes a 16-step
// running count. fused_move moves in the direction it is given; its
// legality is whether that move changed the board.
//
// What bounds each kernel on an H100. The rollout loops over its steps
// inside the thread and writes each board once, so a launch reads 64 bytes
// and writes 76 bytes per board whatever the number of steps, against 563
// SASS instructions per board and step (the step and ten Philox rounds;
// gym2048_tpu_torch/_sass.py counts them in the built library): it is
// bound by the rate at which the card issues instructions, so its design
// cuts instructions (one move, not four) and keeps 32 warps per SM without
// a spill to hide their latency (kRolloutThreads). A reset runs in a
// branch: it takes a second Philox block and fresh_board, once in about
// 112 steps of a board but in 0.22 of the steps of a warp; computed on
// every step instead it made a step 695 instructions and the launch 1.2x
// as long (an H100 80GB HBM3 at 700 W). The single-step kernels move
// 140-152 bytes per board per launch; with one move per board their
// instructions take less time than those bytes, so they are bound by
// memory, and launch in blocks of kStepThreads. random_uniform_rows is
// bound by the bytes it writes; it and the Philox test kernel run in
// blocks of kThreads. Each kernel masks its ragged edge.
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
// The single-step kernels' blocks: B = 65,536 boards make 512 blocks of 4
// warps, one wave over 132 SMs at 3-4 blocks (12-16 warps, 3-4 per
// scheduler) each. That needs 4 blocks per SM, which the launch bounds ask
// for (at most 128 registers a thread). Under them ptxas gives fused_move
// 54 registers and fused_step_uniform 64; with no minimum it gives
// fused_move 38, and that code took 1.16x as long at 65,536 boards on an
// H100 80GB HBM3 (700 W).
constexpr int kStepThreads = 128;
constexpr int kStepMinBlocks = 4;
// The rollout's blocks. The launch bounds cap ptxas at 64 registers a
// thread, so that an SM holds 8 blocks of 4 warps: 32 warps, 8 per
// scheduler, to hide the dependent chains of Philox and the move. Tried in
// one call on an H100 80GB HBM3 (700 W), at B = 1,048,576 x 1024 steps:
// (256, 4) and (128, 8) give the same 62-register code, 32.25 and 31.71
// ms; both run 7.76 waves, but an SM gets at most 63 blocks of 128 (8,064
// boards) or 32 of 256 (8,192) against 7,944 on average, and that tail,
// at most one block per SM at any B, is the 1.7%. With no minimum (another
// call) ptxas gave 75 registers, 3 blocks of 256 (24 warps), and the time
// of (256, 4), which then spilled 8 B.
constexpr int kRolloutThreads = 128;
constexpr int kRolloutMinBlocks = 8;

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

// The spawn's rule: it fills empty cell number
// min(floor(u_pos * n_empty), max(n_empty - 1, 0)) (f32, as the TPU kernel)
// with exponent 1 (u_val < 0.9f) or 2.
__device__ __forceinline__ int spawn_rank(float u_pos, int n_empty) {
  const float nf = static_cast<float>(n_empty);
  return static_cast<int>(fminf(floorf(u_pos * nf), fmaxf(nf - 1.0f, 0.0f)));
}

__device__ __forceinline__ int spawn_value(float u_val) {
  return u_val < 0.9f ? 1 : 2;
}

// One spawn on board b, empty cells counted in row-major order; a full
// board is unchanged (pallas_step._spawn_cm: position first). A 16-bit
// empty mask with a popc search for the cell took more instructions (657
// a rollout step against 563).
__device__ __forceinline__ void spawn(int (&b)[16], float u_pos, float u_val) {
  int n_empty = 0;
#pragma unroll
  for (int i = 0; i < 16; ++i) n_empty += b[i] == 0;
  const int target = spawn_rank(u_pos, n_empty) + 1;
  const int val = spawn_value(u_val);
  int seen = 0;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const bool empty = b[i] == 0;
    seen += empty;
    if (empty && seen == target) b[i] = val;
  }
}

// A reset board: two spawns on an empty board, from uniform rows 1-2 (the
// step's own spawn uniforms) and 3-4. On an empty board empty cell number
// k is cell k, and once the first tile is at c1, cell k below c1 and cell
// k + 1 from c1 on, so no cell needs a count.
__device__ __forceinline__ void fresh_board(int (&b)[16], float u_pos,
                                            float u_val, float u_pos2,
                                            float u_val2) {
  const int c1 = spawn_rank(u_pos, 16);
  int c2 = spawn_rank(u_pos2, 15);
  c2 += c2 >= c1;
  const int v1 = spawn_value(u_val), v2 = spawn_value(u_val2);
#pragma unroll
  for (int i = 0; i < 16; ++i) b[i] = i == c1 ? v1 : i == c2 ? v2 : 0;
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

// ---- the single-step kernels: legality from pairs, one move per board ----

// Legality of the four directions (up, right, down, left) read from the
// board's 24 adjacent pairs, without moving it. A line moves toward its
// position 0 if and only if some adjacent pair, read in that order, is
// (empty, tile) or two equal tiles. Bit i of each mask is cell i.
__device__ __forceinline__ void legal_from_pairs(const int (&b)[16],
                                                 bool (&legal)[4]) {
  constexpr unsigned kRowPairs = 0x7777u;  // cells with a right neighbour
  constexpr unsigned kColPairs = 0x0FFFu;  // cells with a neighbour below
  unsigned tile = 0, same_right = 0, same_below = 0;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    tile |= static_cast<unsigned>(b[i] != 0) << i;
    if (i % 4 < 3) same_right |= static_cast<unsigned>(b[i] == b[i + 1]) << i;
    if (i < 12) same_below |= static_cast<unsigned>(b[i] == b[i + 4]) << i;
  }
  const unsigned empty = ~tile & 0xFFFFu;
  const unsigned merge_row = same_right & tile & kRowPairs;
  const unsigned merge_col = same_below & tile & kColPairs;
  legal[0] = ((empty & (tile >> 4) & kColPairs) | merge_col) != 0;
  legal[1] = ((tile & (empty >> 1) & kRowPairs) | merge_row) != 0;
  legal[2] = ((tile & (empty >> 4) & kColPairs) | merge_col) != 0;
  legal[3] = ((empty & (tile >> 1) & kRowPairs) | merge_row) != 0;
}

__device__ __forceinline__ void swap_if(bool p, int& x, int& y) {
  const int t = p ? y : x;
  y = p ? x : y;
  x = t;
}

// Brings direction d's lines into the rows of b, each read from its
// position 0, so that the move becomes a leftward shift of every row:
// row l of the result is line l of d (pallas_step._cell(d, l, k)). Up and
// down transpose, right and down mirror the rows. Each
// step is a select on the direction, never a branch.
__device__ __forceinline__ void to_line_frame(int (&b)[16], int d) {
  const bool transpose = (d & 1) == 0, mirror = d == 1 || d == 2;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int c = r + 1; c < 4; ++c) swap_if(transpose, b[4 * r + c], b[4 * c + r]);
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    swap_if(mirror, b[4 * r], b[4 * r + 3]);
    swap_if(mirror, b[4 * r + 1], b[4 * r + 2]);
  }
}

// The inverse of to_line_frame: the mirror first, then the transpose.
__device__ __forceinline__ void from_line_frame(int (&b)[16], int d) {
  const bool transpose = (d & 1) == 0, mirror = d == 1 || d == 2;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    swap_if(mirror, b[4 * r], b[4 * r + 3]);
    swap_if(mirror, b[4 * r + 1], b[4 * r + 2]);
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int c = r + 1; c < 4; ++c) swap_if(transpose, b[4 * r + c], b[4 * c + r]);
  }
}

// If x is empty, y moves into it.
__device__ __forceinline__ void pull(int& x, int& y) {
  const bool e = x == 0;
  x = e ? y : x;
  y = e ? 0 : y;
}

// Compact and merge one line leftward in place (rules._compact_merge_rows),
// add the merge score and return whether the line changed. The compaction
// bubbles the empty cells to the end in six conditional moves; the merge is
// the rule's single pass over the compacted line.
__device__ __forceinline__ bool slide_line(int& a0, int& a1, int& a2, int& a3,
                                           int& score) {
  int c0 = a0, c1 = a1, c2 = a2, c3 = a3;
  pull(c0, c1);
  pull(c1, c2);
  pull(c2, c3);
  pull(c0, c1);
  pull(c1, c2);
  pull(c0, c1);
  const bool m01 = c0 != 0 && c0 == c1;
  const bool m12 = c1 != 0 && c1 == c2 && !m01;
  const bool m23 = c2 != 0 && c2 == c3 && !m12;
  const int o0 = c0 + m01;
  const int o1 = m01 ? c2 + m23 : c1 + m12;
  const int o2 = m01 ? (m23 ? 0 : c3) : (m12 ? c3 : c2 + m23);
  const int o3 = (m01 || m12 || m23) ? 0 : c3;
  score += (m01 ? 1 << (c0 + 1) : 0) + (m12 ? 1 << (c1 + 1) : 0) +
           (m23 ? 1 << (c2 + 1) : 0);
  const bool changed = o0 != a0 || o1 != a1 || o2 != a2 || o3 != a3;
  a0 = o0;
  a1 = o1;
  a2 = o2;
  a3 = o3;
  return changed;
}

// Moves board b in direction d (0 up, 1 right, 2 down, 3 left) in place,
// adds the merge score and returns whether the board changed.
__device__ __forceinline__ bool move_one(int (&b)[16], int d, int& score) {
  to_line_frame(b, d);
  bool changed = false;
#pragma unroll
  for (int l = 0; l < 4; ++l) {
    changed |= slide_line(b[4 * l], b[4 * l + 1], b[4 * l + 2], b[4 * l + 3], score);
  }
  from_line_frame(b, d);
  return changed;
}

// One random-legal step (the first half of pallas_step._step_cm), one move
// per board: picks the r-th legal direction with r = trunc(u_act * n_legal),
// clamped, moves and spawns in place. Returns the action (0 for a dead
// board, which is left unchanged with move score 0) and sets finish for a
// dead board or, when max_tile_exp > 0, a board that holds that tile after
// the spawn (the whole board: an input board may already hold it).
__device__ __forceinline__ int step_one(int (&b)[16], float u_act, float u_pos,
                                        float u_val, int max_tile_exp,
                                        int& move_score, bool& finish) {
  bool legal[4];
  legal_from_pairs(b, legal);
  const int n_legal = legal[0] + legal[1] + legal[2] + legal[3];
  int r = static_cast<int>(u_act * static_cast<float>(n_legal));
  r = min(r, max(n_legal - 1, 0));
  int action = 0, cum = 0;
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    action = legal[d] && cum == r ? d : action;
    cum += legal[d];
  }
  move_score = 0;
  move_one(b, action, move_score);  // a dead board does not change
  spawn(b, u_pos, u_val);
  bool won = false;
  if (max_tile_exp > 0) {
#pragma unroll
    for (int i = 0; i < 16; ++i) won |= b[i] == max_tile_exp;
  }
  finish = n_legal == 0 || won;
  return action;
}

__global__ void __launch_bounds__(kStepThreads, kStepMinBlocks)
fused_move_kernel(const int* __restrict__ board, const int* __restrict__ action,
                  int* __restrict__ out, int* __restrict__ score_out,
                  int* __restrict__ legal_out, long long n) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int b[16];
  load_board(b, board, i, n);
  const int a = action[i];
  // any action outside 0..2 acts as 3 (pallas_step._select4); a move that
  // changes nothing scores nothing and leaves the board as it was
  const int d = static_cast<unsigned>(a) < 3u ? a : 3;
  int score = 0;
  const bool legal = move_one(b, d, score);
  store_board(b, out, i, n);
  score_out[i] = score;
  legal_out[i] = legal;
}

__global__ void __launch_bounds__(kStepThreads, kStepMinBlocks)
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
  const float u_pos = u[n + i], u_val = u[2 * n + i];
  int move_score;
  bool finish;
  const int action =
      step_one(b, u[i], u_pos, u_val, max_tile_exp, move_score, finish);
  if (finish) fresh_board(b, u_pos, u_val, u[3 * n + i], u[4 * n + i]);
  store_board(b, out, i, n);
  score_out[i] = finish ? 0.0f : static_cast<float>(move_score);
  finished_out[i] = finish;
  action_out[i] = action;
}

__global__ void __launch_bounds__(kRolloutThreads, kRolloutMinBlocks)
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
  // one step per iteration: _sass.py and chip_smoke.py count it so
#pragma unroll 1
  for (int t = 0; t < steps; ++t) {
    // Rounds 1-3 of Philox depend partly on the board index alone. Hoisted
    // out of the loop they held four registers, and under the 64-register
    // cap ptxas spilled two (8 B of stack, two local loads a step); the
    // empty asm hides that ctr == idx, so they are recomputed each step, at
    // no cost in instructions.
    uint32_t ctr = idx;
    asm volatile("" : "+r"(ctr));
    const Words w = philox4x32_10(Words{ctr, static_cast<uint32_t>(t), 0u, 0u},
                                  seed, 0u);
    const float u_pos = to_uniform(w.y), u_val = to_uniform(w.z);
    int move_score;
    bool finish;
    step_one(b, to_uniform(w.x), u_pos, u_val, max_tile_exp, move_score, finish);
    const float gained = static_cast<float>(move_score);
    if (finish) {
      // the second Philox block is drawn only where a reset needs row 4
      const Words w1 = philox4x32_10(
          Words{ctr, static_cast<uint32_t>(t), 1u, 0u}, seed, 0u);
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

unsigned grid_for(long long work, int threads = kThreads) {
  return static_cast<unsigned>((work + threads - 1) / threads);
}

}  // namespace

// Launchers: each enqueues one kernel on `stream` and returns
// cudaGetLastError() (0 on success). Callers pass n >= 1.
extern "C" {

int gym_fused_move(const void* board, const void* action, void* out,
                   void* score, void* legal, long long n, void* stream) {
  fused_move_kernel<<<grid_for(n, kStepThreads), kStepThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(board), static_cast<const int*>(action),
      static_cast<int*>(out), static_cast<int*>(score),
      static_cast<int*>(legal), n);
  return static_cast<int>(cudaGetLastError());
}

int gym_fused_step_uniform(const void* board, const void* u, void* out,
                           void* score, void* finished, void* action,
                           long long n, int max_tile_exp, void* stream) {
  fused_step_uniform_kernel<<<grid_for(n, kStepThreads), kStepThreads, 0,
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
  fused_rollout_kernel<<<grid_for(n, kRolloutThreads), kRolloutThreads, 0,
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
