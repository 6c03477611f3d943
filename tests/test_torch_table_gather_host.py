"""The table gather CUDA kernels' own code, compiled for the host with g++.

``gym2048_tpu_torch/csrc/table_gather.cu`` keeps what needs CUDA (its
loads and stores) behind five helpers outside its anonymous namespace, and everything inside that
namespace (both kernels and ``plan_launches``, which splits a lookup into
a scalar head, 16-byte groups and a scalar tail, each a launch, and sizes
their grids) free of other CUDA-only constructs. Here a small header
defines the helpers, the CUDA qualifiers and the built-in indices for g++;
the helpers check every address and count every write. A harness runs
each block and thread of each launch that ``plan_launches`` plans from a
loop, in blocks of 32 threads, and every output must equal the plain
version (``gather_values_reference``) bit for bit, written exactly once. This checks the kernels' index arithmetic on
the CPU, not what ``nvcc`` makes of it; chip_smoke.py holds the built
kernels against the same plain version on the card.
"""

import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from gym2048_tpu_torch.models import table_gather as tg

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402  (the repository's GPU check, importable without a GPU)

SOURCE = ROOT / "gym2048_tpu_torch/csrc/table_gather.cu"
THREADS = 32
LAUNCH_THREADS = int(re.search(r"constexpr int kThreads = (\d+);", SOURCE.read_text()).group(1))

STUB = """
#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <vector>
#define __device__
#define __global__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__
struct Dim { unsigned x; };
static Dim blockIdx, threadIdx;
struct alignas(16) int4 { int x, y, z, w; };
struct alignas(16) float4 { float x, y, z, w; };
static const int *g_idx_lo, *g_idx_hi;
static const float *g_table_lo, *g_table_hi;
static float *g_out_lo, *g_out_hi;
static std::vector<int> g_writes;
static void require(bool ok, const char* what) {
  if (!ok) { fprintf(stderr, "%s\\n", what); exit(3); }
}
inline int load_index(const int* p) {
  require(p >= g_idx_lo && p < g_idx_hi, "index read outside the stream");
  return *p;
}
inline int4 load_indices(const int4* p) {
  const int* q = reinterpret_cast<const int*>(p);
  require((reinterpret_cast<uintptr_t>(q) & 15) == 0, "unaligned 16-byte index load");
  require(q >= g_idx_lo && q + 4 <= g_idx_hi, "index group read outside the stream");
  return *p;
}
inline float load_value(const float* p) {
  require(p >= g_table_lo && p < g_table_hi, "table read outside the table");
  return *p;
}
inline void store_value(float* p, float v) {
  require(p >= g_out_lo && p < g_out_hi, "write outside the output");
  ++g_writes[p - g_out_lo];
  *p = v;
}
inline void store_values(float4* p, float4 v) {
  float* q = reinterpret_cast<float*>(p);
  require((reinterpret_cast<uintptr_t>(q) & 15) == 0, "unaligned 16-byte store");
  store_value(q, v.x); store_value(q + 1, v.y); store_value(q + 2, v.z); store_value(q + 3, v.w);
}
"""

# stdin: cases, then per case n, S, idx offset, out offset, plan only,
# threads (int64), and unless plan only the table (f32 x S) and the indices
# (int32 x n). stdout per case: the plan, three launches of vector, first,
# count, blocks (int64, unused ones 0), and unless plan only out (f32 x n)
# and the writes per output (int32 x n).
HARNESS = """
static void write_plan(const Launch* launches, int k) {
  long long plan[12] = {};
  for (int j = 0; j < k; ++j) {
    plan[4 * j] = launches[j].vector ? 1 : 0;
    plan[4 * j + 1] = launches[j].first;
    plan[4 * j + 2] = launches[j].count;
    plan[4 * j + 3] = launches[j].blocks;
  }
  fwrite(plan, 8, 12, stdout);
}

int main() {
  long long cases = 0;
  if (fread(&cases, 8, 1, stdin) != 1) return 2;
  for (long long c = 0; c < cases; ++c) {
    long long h[6];
    if (fread(h, 8, 6, stdin) != 6) return 2;
    const long long n = h[0], s = h[1], off_idx = h[2], off_out = h[3];
    const int threads = static_cast<int>(h[5]);
    Launch launches[3];
    if (!h[4] && threads != THREADS) return 2;  // the kernels are built for THREADS
    if (h[4]) {  // the plan alone, for addresses at these offsets
      write_plan(launches, plan_launches(4096 + 4 * off_idx, 8192 + 4 * off_out, n, threads,
                                         launches));
      continue;
    }
    std::vector<float> table(s);
    const size_t bytes = ((n + 8) * 4 + 15) / 16 * 16;
    int* ibuf = static_cast<int*>(aligned_alloc(16, bytes));
    float* obuf = static_cast<float*>(aligned_alloc(16, bytes));
    int* idx = ibuf + off_idx;
    float* out = obuf + off_out;
    if (fread(table.data(), 4, s, stdin) != static_cast<size_t>(s)) return 2;
    if (fread(idx, 4, n, stdin) != static_cast<size_t>(n)) return 2;
    std::fill(obuf, obuf + (n + 8), -1.0f);
    g_idx_lo = idx; g_idx_hi = idx + n;
    g_table_lo = table.data(); g_table_hi = table.data() + s;
    g_out_lo = out; g_out_hi = out + n;
    g_writes.assign(n, 0);
    const int k = plan_launches(reinterpret_cast<uintptr_t>(idx),
                                reinterpret_cast<uintptr_t>(out), n, threads, launches);
    for (int j = 0; j < k; ++j) {
      const Launch& l = launches[j];
      for (long long b = 0; b < l.blocks; ++b) {
        for (int t = 0; t < threads; ++t) {
          blockIdx.x = static_cast<unsigned>(b);
          threadIdx.x = static_cast<unsigned>(t);
          if (l.vector)
            gather4_kernel<THREADS>(table.data(), reinterpret_cast<const int4*>(idx + l.first),
                                    reinterpret_cast<float4*>(out + l.first), l.count / 4);
          else
            gather1_kernel<THREADS>(table.data(), idx + l.first, out + l.first, l.count);
        }
      }
    }
    write_plan(launches, k);
    fwrite(out, 4, n, stdout);
    fwrite(g_writes.data(), 4, n, stdout);
    free(ibuf);
    free(obuf);
  }
}
"""

# N from 0 past 40 blocks of 4 x THREADS indices, around each multiple of
# 4 and each block's edge
SIZES = sorted(set(range(0, 70))
               | {k * 4 * THREADS + d for k in range(1, 41) for d in (-5, -1, 0, 1, 3, 7)})


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    text = SOURCE.read_text()
    start, end = text.index("namespace {\n"), text.index("}  // namespace\n")
    cpp = tmp_path_factory.mktemp("table_gather_host") / "harness.cpp"
    cpp.write_text(STUB + text[start:end] + "}  // namespace\n"
                   + HARNESS.replace("THREADS", str(THREADS)))
    exe = cpp.with_suffix("")
    subprocess.run(["g++", "-std=c++17", "-O1", "-o", str(exe), str(cpp)],
                   check=True, capture_output=True, text=True)
    return exe


def run(exe, cases, plan_only: bool = False):
    """Each case ``(table, idx, idx offset, out offset)`` through the
    harness (with ``plan_only``, ``(n, idx offset, out offset, threads)``); returns
    ``(plan, out, writes)`` per case, or the plans."""
    data = [np.int64(len(cases)).tobytes()]
    for case in cases:
        if plan_only:
            n, off_idx, off_out, threads = case
            data.append(np.array([n, 0, off_idx, off_out, 1, threads], np.int64).tobytes())
            continue
        table, idx, off_idx, off_out = case
        data.append(np.array([idx.size, table.size, off_idx, off_out, 0, THREADS],
                             np.int64).tobytes())
        data += [table.astype(np.float32).tobytes(), idx.astype(np.int32).tobytes()]
    done = subprocess.run([str(exe)], input=b"".join(data), capture_output=True, check=True).stdout
    if plan_only:
        return [launches(row) for row in np.frombuffer(done, np.int64).reshape(len(cases), 12)]
    results, pos = [], 0
    for _, idx, *_ in cases:
        n = idx.size
        plan = launches(np.frombuffer(done, np.int64, 12, pos))
        out = np.frombuffer(done, np.float32, n, pos + 96)
        writes = np.frombuffer(done, np.int32, n, pos + 96 + 4 * n)
        results.append((plan, out, writes))
        pos += 96 + 8 * n
    assert pos == len(done)
    return results


def launches(row) -> list[tuple[int, ...]]:
    """The harness's three launch slots as (vector, first, count, blocks),
    the unused ones left out."""
    return [tuple(int(x) for x in row[j:j + 4]) for j in range(0, 12, 4) if row[j + 2]]


def expected_plan(n: int, off_idx: int, off_out: int,
                  threads: int = THREADS) -> list[tuple[int, ...]]:
    """The launches (vector, first, count, blocks) for a stream of ``n`` at
    element offsets ``off_idx`` and ``off_out`` from 16-byte boundaries:
    the 16-byte groups, then the scalar head, then the scalar tail."""
    if (off_idx - off_out) % 4:
        return [(0, 0, n, -(-n // threads))] if n else []
    head = min(n, (4 - off_idx) % 4)
    n4 = (n - head) // 4
    done = head + 4 * n4
    plan = [(1, head, 4 * n4, -(-n4 // threads))] if n4 else []
    plan += [(0, 0, head, 1)] if head else []
    return plan + ([(0, done, n - done, 1)] if n > done else [])


def check_case(case, result):
    table, idx, off_idx, off_out = case
    plan, out, writes = result
    assert plan == expected_plan(idx.size, off_idx, off_out)
    want = tg.gather_values_reference(torch.from_numpy(table), torch.from_numpy(idx)).numpy()
    np.testing.assert_array_equal(out.view(np.int32), want.view(np.int32))
    np.testing.assert_array_equal(writes, np.ones_like(writes))


@pytest.mark.parametrize("off_idx", range(4))
@pytest.mark.parametrize("off_out", range(4))
def test_every_size_and_offset(harness, off_idx, off_out):
    """Index and output pointers 0-3 elements past a 16-byte boundary, each
    on its own: equal offsets take the 16-byte path after a scalar head,
    different ones the scalar kernel."""
    rng = np.random.default_rng(16 * off_idx + off_out)
    table = rng.normal(size=1000).astype(np.float32)
    cases = []
    for n in SIZES:
        idx = rng.integers(0, table.size, n).astype(np.int32)
        idx[:1], idx[-1:] = 0, table.size - 1
        cases.append((table, idx, off_idx, off_out))
    for case, result in zip(cases, run(harness, cases)):
        check_case(case, result)


@pytest.mark.parametrize("kind", ["one index", "both ends", "one entry", "runs"])
def test_duplicate_indices(harness, kind):
    """Streams that repeat indices: one index throughout, alternating 0 and
    S-1, a table of one entry, and runs of equal indices."""
    rng = np.random.default_rng(7)
    table = rng.normal(size=1 if kind == "one entry" else 4099).astype(np.float32)
    cases = []
    for n in (1, 5, 17, 129, 515, 2053, 6151):
        if kind == "one index":
            idx = np.full(n, 2048)
        elif kind == "both ends":
            idx = np.where(np.arange(n) % 2 == 0, 0, table.size - 1)
        elif kind == "one entry":
            idx = np.zeros(n)
        else:
            idx = np.repeat(rng.integers(0, table.size, -(-n // 7)), 7)[:n]
        cases += [(table, idx.astype(np.int32), o, o) for o in (0, 1)]
    for case, result in zip(cases, run(harness, cases)):
        check_case(case, result)


@pytest.mark.parametrize("n", chip_smoke.GATHER_SIZES)
def test_plan_at_the_sizes_chip_smoke_times(harness, n):
    """The launch at the uniform stream's sizes (up to 67,108,864 indices,
    the agent's and TD step's among them), aligned, at a common offset and
    at different offsets, in blocks of the launcher's 256 threads; and
    chip_smoke's ``gather_launches``, which its bound and its waves read,
    gives the same launches."""
    assert chip_smoke.GATHER_THREADS == LAUNCH_THREADS
    cases = [(n, 0, 0, LAUNCH_THREADS), (n, 3, 3, LAUNCH_THREADS), (n, 0, 1, LAUNCH_THREADS),
             (n - 1, 2, 2, LAUNCH_THREADS)]
    plans = run(harness, cases, plan_only=True)
    assert plans == [expected_plan(*c) for c in cases]
    for (m, off_idx, off_out, _), plan in zip(cases, plans):
        # the harness plans for addresses 4096 + 4 * off_idx and 8192 + 4 * off_out
        got = chip_smoke.gather_launches(m, 4096 + 4 * off_idx, 8192 + 4 * off_out)
        assert got == [(bool(vector), count, blocks) for vector, _, count, blocks in plan]
