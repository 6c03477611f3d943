"""The delayed-TC combine over a window's touched entries
(``models/ntuple.py::tc_combine_at``): its plain version, and the CUDA
kernel's own code (``gym2048_tpu_torch/csrc/tc_combine.cu``) compiled for
the host with g++, both held bit for bit against the dense combine of the
whole arrays (``_tc_combine``, then the pending sums zeroed), which the
other tests hold against the JAX package.

The windows are real ones: ``NTupleNetwork.tc_accumulate`` scatters each
step into the pending sums and records its flat occurrence indices in the
window's row, as the TD step's tail does. They hold entries hit more than
once within a step and across steps, masked occurrences (index 0, count
0) with entry 0 also hit for real and without, entries never touched and
entries whose accumulated ``a2`` is 0, over windows of 1 and 8 steps.

The kernel's file keeps what needs CUDA (the streaming index load, the
atomic exchange of a count, the rounded division, multiply and add, and
``launch``) in helpers before its anonymous namespace; here a small header
defines them for g++ (``launch`` runs every thread of the grid in turn,
forward or backward, so that another occurrence owns each entry) and the
rest of the file builds into a host library with the C interface that the
wrapper loads on the card. This checks the kernel's arithmetic and
ownership on the CPU, not what ``nvcc`` makes of it; ``chip_smoke.py``
holds the built kernel against the dense combine on the card.

Last, the TD trainer with delayed TC (``TDTrainer._scan_steps``, which
writes the table, ``tc_e`` and ``tc_a`` in place): two chunks equal to the
same chunks with the dense combine, and the state given to a chunk left as
it was.
"""

import shutil
import subprocess
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from gym2048_tpu_torch import _build
from gym2048_tpu_torch.models import ntuple, ntuple_big
from gym2048_tpu_torch.train import td as ttd
from test_torch_td import BASE, assert_bits, boards
from test_torch_td_tail import CHUNK_CASES, crowded_state

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "gym2048_tpu_torch/csrc/tc_combine.cu"

STUB = r"""
#include <cmath>
#include <cstdint>
#define __device__
#define __global__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__
struct Dim { unsigned x; };
static Dim threadIdx, blockIdx;
typedef int cudaError_t;
typedef void* cudaStream_t;
inline const char* cudaGetErrorString(cudaError_t) { return "host error"; }
inline int load_index(const int* p) { return *p; }
inline float take_count(float* p) {
  const float c = *p;
  *p = 0.0f;
  return c;
}
inline float div_rn(float a, float b) { return a / b; }
inline float mul_rn(float a, float b) { return a * b; }
inline float add_rn(float a, float b) { return a + b; }
// Every thread of the grid in turn: forward, or with BACKWARD from the last.
template <typename... Params, typename... Args>
cudaError_t launch(void (*kernel)(Params...), unsigned grid, unsigned threads, cudaStream_t,
                   Args... args) {
  for (unsigned b = 0; b < grid; ++b)
    for (unsigned t = 0; t < threads; ++t) {
      blockIdx.x = BACKWARD ? grid - 1 - b : b;
      threadIdx.x = BACKWARD ? threads - 1 - t : t;
      kernel(args...);
    }
  return 0;
}
"""

ORDERS = {"forward": 0, "backward": 1}
B = 24  # boards a step
ALPHA = torch.tensor(0.3, dtype=torch.float32)  # no power of 2: each rounding shows


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the test workers share the CPU's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def host_libraries(tmp_path_factory):
    """The kernel's file built for the host, one library per thread order."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    text = SOURCE.read_text()
    out = tmp_path_factory.mktemp("tc_combine_host")
    cpp = out / "tc_combine_host.cpp"
    cpp.write_text(STUB + text[text.index("namespace {\n"):])
    libs = {}
    for order, backward in ORDERS.items():
        lib = out / f"tc_combine_{order}.so"
        done = subprocess.run(["g++", "-std=c++17", "-O2", "-ffp-contract=off", "-shared",
                               "-fPIC", f"-DBACKWARD={backward}", "-o", str(lib), str(cpp)],
                              capture_output=True, text=True)
        assert done.returncode == 0, done.stderr
        libs[order] = _build.load(lib, "tc_combine")
    return libs


@pytest.fixture
def kernel_on_host(host_libraries, monkeypatch):
    """``order -> combine``: the wrapper's card path (``_tc_combine_kernel``)
    on CPU tensors, through the host library of that thread order."""
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))

    def combine(order):
        def run(table, tc_e, tc_a, pending, idx, alpha):
            monkeypatch.setattr(_build, "library", lambda name: host_libraries[order])
            ntuple._check_combine(table, tc_e, tc_a, pending, idx)
            ntuple._tc_combine_kernel(table, tc_e, tc_a, pending, idx.contiguous(), alpha)
            return table, tc_e, tc_a
        return run
    return combine


def network():
    return ntuple_big.make_network(BASE["arch"], BASE["n_vals"], BASE["thresholds"])


def window(net, k: int, seed: int, entry0: bool):
    """``k`` steps of ``tc_accumulate`` into zero pending sums, each
    recording its row: ``(pending, rows, steps)``, ``steps`` each step's
    ``(boards, deltas, valid)``. Every step shares half of its boards with
    the step before and holds two copies of one board; a quarter of the
    boards are masked; one board has a delta of 0. With ``entry0`` an empty
    board (its first feature is entry 0) is among the valid ones; without,
    no board has an empty cell, so only the masked occurrences reach 0."""
    rng = np.random.default_rng(seed)
    size, n = net.table_size, B * net.n_features
    pending = tuple(torch.zeros(size) for _ in range(3))
    rows = torch.full((k, n), -1, dtype=torch.int32)
    step = torch.zeros(1, dtype=torch.int64)
    steps = []
    b = boards(B, seed, max_exp=3, p_zero=0.3 if entry0 else 0.0)
    for t in range(k):
        fresh = boards(B, seed + 100 * (t + 1), max_exp=3, p_zero=0.3 if entry0 else 0.0)
        b = np.concatenate([b[B // 2:], fresh[:B // 2]])
        b[1] = b[2]
        if entry0:
            b[3] = 0
        deltas = torch.from_numpy((rng.integers(-64, 64, B) / 8).astype(np.float32))
        deltas[4] = 0.0
        valid = torch.from_numpy(rng.random(B) >= 0.25)
        valid[1:5] = True
        bt = torch.from_numpy(b.copy())
        net.tc_accumulate((*pending, (rows, step)), bt, deltas, valid=valid)
        step += 1
        steps.append((bt, deltas, valid))
    return pending, rows, steps


def arrays(net, steps, seed: int):
    """Table, ``tc_e`` and ``tc_a`` to combine into: random values, ``tc_a``
    0 on half of the entries and on every entry of the zero-delta boards."""
    g = torch.Generator().manual_seed(seed)
    size = net.table_size
    table = torch.randn(size, generator=g) * 100
    tc_e = torch.randn(size, generator=g)
    tc_a = torch.rand(size, generator=g) * 4 * (torch.rand(size, generator=g) < 0.5)
    for bt, _, _ in steps:
        tc_a[net.indices_batch(bt[4:5]).reshape(-1).long()] = 0.0
    return table, tc_e, tc_a


CASES = [(k, entry0) for k in (1, 8) for entry0 in (False, True)]


@pytest.mark.parametrize("k, entry0", CASES)
def test_tc_accumulate_records_the_scattered_indices(k, entry0):
    """Row t of the record is step t's flat occurrence indices, a masked
    occurrence at 0, and the pending sums are those of ``tc_accumulate``
    without a record."""
    net = network()
    pending, rows, steps = window(net, k, 3 + k, entry0)
    plain = tuple(torch.zeros(net.table_size) for _ in range(3))
    for t, (bt, deltas, valid) in enumerate(steps):
        idx = net.indices_batch(bt)
        want = torch.where(valid[:, None], idx, 0).reshape(-1)
        assert torch.equal(rows[t], want)
        net.tc_accumulate(plain, bt, deltas, valid=valid)
    for got, want in zip(pending, plain):
        assert_bits(got, want.numpy())
    counted = torch.zeros(net.table_size, dtype=torch.bool)
    for bt, _, valid in steps:
        counted[net.indices_batch(bt[valid]).reshape(-1).long()] = True
    assert torch.equal(pending[2] > 0, counted)
    hit = torch.zeros(net.table_size, dtype=torch.bool)
    hit[rows.reshape(-1).long()] = True
    assert bool(hit[counted].all())  # every entry with a count has an occurrence
    assert bool(counted[0]) == entry0
    assert int((rows == 0).sum()) > 0  # the masked occurrences


@pytest.mark.parametrize("impl", ["plain", "kernel_forward", "kernel_backward"])
@pytest.mark.parametrize("k, entry0", CASES)
def test_combine_at_equals_the_dense_combine(impl, k, entry0, kernel_on_host):
    """The combine of the window's occurrences equals the dense combine of
    the whole arrays bit for bit on the table, ``tc_e`` and ``tc_a``;
    entries never touched keep their bits, and every pending sum and count
    is 0 afterwards."""
    net = network()
    pending, rows, steps = window(net, k, 11 + k, entry0)
    table, tc_e, tc_a = arrays(net, steps, 7 + k)
    sums, absums, cnts = pending
    a2 = tc_a + absums
    assert bool(((cnts > 0) & (a2 == 0)).any())  # entries whose rate is 1
    assert bool((cnts == 0).any())
    want = ntuple._tc_combine(table.clone(), tc_e.clone(), tc_a.clone(), *pending, ALPHA)
    if impl == "plain":
        combine = ntuple.tc_combine_at
    else:
        combine = kernel_on_host(impl.split("_")[1])
    launches = dict(ntuple.LAUNCHES)
    work = [t.clone() for t in (table, tc_e, tc_a)]
    work_pending = tuple(p.clone() for p in pending)
    got = combine(*work, work_pending, rows, ALPHA)
    assert all(g is w for g, w in zip(got, work))  # in place
    assert ntuple.LAUNCHES["tc_combine"] == launches["tc_combine"] + (impl != "plain")
    for name, g, w, before in zip(("table", "tc_e", "tc_a"), work, want, (table, tc_e, tc_a)):
        assert_bits(g, w.numpy(), name)
        assert_bits(g[cnts == 0], before[cnts == 0].numpy(), name)
    for p in work_pending:
        assert not bool(p.any())


def test_combine_at_checks_its_arguments():
    """Arrays that are not flat float32 of the table's size, indices that
    are not int32, a pending tuple of another length, and tensors on a
    device with no kernel raise, launching nothing."""
    size = 64
    arrays6 = [torch.zeros(size) for _ in range(6)]
    idx = torch.zeros(8, dtype=torch.int32)
    launches = dict(ntuple.LAUNCHES)
    bad = [
        (arrays6[0].double(), *arrays6[1:3], tuple(arrays6[3:]), idx),
        (*arrays6[:3], tuple(arrays6[3:5]), idx),
        (*arrays6[:3], (arrays6[3], arrays6[4], torch.zeros(size + 1)), idx),
        (*arrays6[:3], tuple(arrays6[3:]), idx.long()),
        (arrays6[0], torch.zeros(size, 2)[:, 0], arrays6[2], tuple(arrays6[3:]), idx),
    ]
    for args in bad:
        with pytest.raises(ValueError):
            ntuple.tc_combine_at(*args, 1.0)
    meta = [torch.zeros(size, device="meta") for _ in range(6)]
    with pytest.raises(ValueError, match="no kernel"):
        ntuple.tc_combine_at(*meta[:3], tuple(meta[3:]), idx.to("meta"), 1.0)
    assert ntuple.LAUNCHES == launches


def dense_combine(carry: dict, idx, alpha) -> None:
    """The trainer's combine before the window's record: ``_tc_combine`` of
    the whole arrays, then the pending sums zeroed."""
    carry["table"], carry["tc_e"], carry["tc_a"] = ntuple._tc_combine(
        carry["table"], carry["tc_e"], carry["tc_a"], *(carry[p] for p in ttd._PENDING), alpha)
    for p in ttd._PENDING:
        carry[p].zero_()


@pytest.mark.parametrize("case", ["deferred_carousel", "deferred"])
def test_delayed_tc_chunks_equal_the_dense_combine(case, monkeypatch):
    """Two ``train_chunk``s with the combine over the window's entries and
    with the dense combine: every leaf and metric equal bit for bit; the
    state given to each chunk keeps its table, ``tc_e`` and ``tc_a`` (the
    combine writes the scan's own copies in place)."""
    cfg = ttd.TDConfig(n_envs=16, chunk_steps=8, **CHUNK_CASES[case])
    want_tr, got_tr = ttd.TDTrainer(cfg, "cpu"), ttd.TDTrainer(cfg, "cpu")
    monkeypatch.setattr(want_tr, "_combine", dense_combine)
    state = crowded_state(got_tr, 9)
    want_state = dict(state, generator=torch.Generator().set_state(
        state["generator"].get_state()))
    for _ in range(2):
        given = {k: state[k].clone() for k in ("table", "tc_e", "tc_a")}
        before, (state, got_m) = state, got_tr.train_chunk(state, cfg.alpha)
        want_state, want_m = want_tr.train_chunk(want_state, cfg.alpha)
        for k, v in given.items():
            assert torch.equal(before[k], v), k
        for k in want_state:
            if k != "generator":
                assert_bits(state[k], want_state[k].numpy(), k)
        for k in want_m:
            assert_bits(got_m[k], want_m[k].numpy(), k)
    assert not torch.equal(state["tc_a"], torch.zeros_like(state["tc_a"]))


def test_delayed_tc_scan_leaves_its_input():
    """``_scan_steps`` with delayed TC returns new table, ``tc_e`` and
    ``tc_a`` tensors and leaves the given ones' values as they were, as
    ``ShardedChunk.local`` needs to merge ``new - state``."""
    cfg = ttd.TDConfig(n_envs=16, chunk_steps=8, **CHUNK_CASES["deferred_carousel"])
    tr = ttd.TDTrainer(cfg, "cpu")
    state = crowded_state(tr, 4)
    given = {k: state[k].clone() for k in ("table", "tc_e", "tc_a")}
    new, _ = tr._scan_steps(dict(state), torch.tensor(cfg.alpha), cfg.chunk_steps)
    for k, v in given.items():
        assert new[k] is not state[k]
        assert torch.equal(state[k], v), k
        assert not torch.equal(new[k], v), k
