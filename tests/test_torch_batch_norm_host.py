"""The BatchNorm + add + ReLU CUDA kernels' own code, compiled for the host
with g++, behind the port's own wrapper.

``gym2048_tpu_torch/csrc/batch_norm.cu`` keeps what needs CUDA (the barrier,
the bit casts, its 16-byte loads and stores, and ``launch``, the one place
that writes ``<<<...>>>``) in helpers before its anonymous namespace; the
rest of the file, kernels, grids and the C interface, is free of other
CUDA-only constructs. Here a small header defines those helpers for g++
(``launch`` runs the grid's blocks in turn, each block's threads as threads
of the host meeting at a barrier), and the file builds into a host library
with the very C interface that :mod:`gym2048_tpu_torch.models.batch_norm`
loads on the card. The wrapper's card path (:class:`BatchNormReLU` and the
forward alone) then runs on CPU tensors through it, and its outputs, the
running statistics and every gradient are held to float64 references
(chip_smoke's ``bn_want_forward``, ``bn_want_backward``, the ones phase 19h
holds the built kernels to on the card): float32 within 1e-5 of the
largest magnitude (the kernels sum in float32 and merge in float64),
bfloat16 within one rounding of each value (2^-8 of it) plus 2^-12 of the
largest magnitude (``bn_excess``). Cases: train and eval, with and
without a residual, C of 2, 3, 24 and 64 (16-byte packs where C times the
element size allows, one value a thread otherwise, and a pointer off the
16-byte grid), grids of one to several passes. This checks the kernels'
arithmetic and indexing on the CPU, not what ``nvcc`` makes of them;
chip_smoke.py holds the built kernels against the plain version on the card.
"""

import shutil
import subprocess
import sys
import types
from pathlib import Path

import pytest
import torch

from gym2048_tpu_torch import _build
from gym2048_tpu_torch.models import batch_norm as bn
from gym2048_tpu_torch.models import resnet

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402  (the repository's GPU check, importable without a GPU)

SOURCE = ROOT / "gym2048_tpu_torch/csrc/batch_norm.cu"

STUB = r"""
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>
#define __device__
#define __global__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__
#define __shared__ static
struct Dim { unsigned x; };
static thread_local Dim threadIdx, blockIdx;
static Dim gridDim;
struct alignas(16) uint4 { unsigned x, y, z, w; };
typedef int cudaError_t;
typedef void* cudaStream_t;
constexpr cudaError_t cudaSuccess = 0;
inline const char* cudaGetErrorString(cudaError_t) { return "host error"; }
static std::barrier<>* g_barrier;
inline void block_sync() { g_barrier->arrive_and_wait(); }
inline uint32_t bits_of(float v) { uint32_t u; std::memcpy(&u, &v, 4); return u; }
inline float float_of(uint32_t u) { float v; std::memcpy(&v, &u, 4); return v; }
inline void require_aligned(const void* p) {
  if (reinterpret_cast<uintptr_t>(p) & 15) {
    fprintf(stderr, "unaligned 16-byte access\n");
    abort();
  }
}
inline uint4 load16(const void* p) {
  require_aligned(p);
  uint4 v;
  std::memcpy(&v, p, 16);
  return v;
}
inline void store16(void* p, uint4 v) { require_aligned(p); std::memcpy(p, &v, 16); }
// The grid's blocks one after another (a block's shared memory is static
// here), each block's threads as host threads; a barrier ends each block.
template <typename... Params, typename... Args>
cudaError_t launch(void (*kernel)(Params...), unsigned grid, unsigned threads, cudaStream_t,
                   Args... args) {
  gridDim.x = grid;
  std::barrier<> barrier(threads);
  g_barrier = &barrier;
  std::vector<std::thread> pool;
  for (unsigned t = 0; t < threads; ++t)
    pool.emplace_back([&, t] {
      threadIdx.x = t;
      for (unsigned b = 0; b < grid; ++b) {
        blockIdx.x = b;
        kernel(args...);
        barrier.arrive_and_wait();
      }
    });
  for (auto& th : pool) th.join();
  return cudaSuccess;
}
"""

EPS, MOMENTUM = 1e-5, 0.01
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


@pytest.fixture(scope="module")
def host_library(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    text = SOURCE.read_text()
    cpp = tmp_path_factory.mktemp("batch_norm_host") / "batch_norm_host.cpp"
    cpp.write_text(STUB + text[text.index("namespace {\n"):])
    lib = cpp.with_suffix(".so")
    done = subprocess.run(["g++", "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", "-o",
                           str(lib), str(cpp)], capture_output=True, text=True)
    assert done.returncode == 0, done.stderr
    return _build.load(lib, "batch_norm")


@pytest.fixture
def on_host(host_library, monkeypatch):
    """The wrapper's card path on CPU tensors, through the host library, on
    a card of ``sms`` SMs (2 unless a test sets it)."""
    cfg = types.SimpleNamespace(sms=2)
    monkeypatch.setattr(_build, "library", lambda name: host_library)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(bn, "_sms", lambda device: cfg.sms)
    return cfg


def layer(c: int, seed: int):
    """Weight, bias and running statistics of a layer of ``c`` channels."""
    g = torch.Generator().manual_seed(seed)
    return (torch.rand(c, generator=g) + 0.5, torch.rand(c, generator=g) - 0.5,
            torch.randn(c, generator=g), torch.rand(c, generator=g) + 0.5)


def activations(n: int, c: int, dtype, seed: int, offset: bool = False) -> torch.Tensor:
    """``(n, c, 4, 4)`` channels-last activations of mean 1 and scale 3 (so
    the variance would cancel in E[x^2] - E[x]^2 without the shift); with
    ``offset`` their data starts one element past a 16-byte boundary."""
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn(n, 4, 4, c, generator=g) * 3 + 1).to(dtype)
    if offset:
        flat = torch.empty(x.numel() + 8, dtype=dtype)
        flat[1:1 + x.numel()] = x.reshape(-1)
        x = flat[1:1 + x.numel()].view(n, 4, 4, c)
    return x.permute(0, 3, 1, 2)


def assert_close(got, want, dtype, what):
    """Within chip_smoke's limits against float64 (``bn_excess``)."""
    excess = chip_smoke.bn_excess(got, want, dtype)
    assert excess <= 1.0, f"{what}: {excess} of the limit"


CASES = [(dtype, c, residual, training)
         for dtype in DTYPES for c in (2, 3, 24, 64)
         for residual in (False, True) for training in (False, True)]


@pytest.mark.parametrize("dtype, c, residual, training", CASES)
def test_forward_and_backward_against_float64(dtype, c, residual, training, on_host):
    """37 boards (592 rows), two SMs: several passes of each grid, and the
    tail of the four-row unroll."""
    dt = DTYPES[dtype]
    w, b, rm, rv = layer(c, c)
    x = activations(37, c, dt, 1).requires_grad_()
    res = activations(37, c, dt, 2).requires_grad_() if residual else None
    wp, bp = w.clone().requires_grad_(), b.clone().requires_grad_()
    rm_k, rv_k = rm.clone(), rv.clone()
    y = bn._kernels(x, wp, bp, rm_k, rv_k, res, training, MOMENTUM, EPS)
    assert y.dtype == dt and y.is_contiguous(memory_format=torch.channels_last)
    want_y, want_rm, want_rv = chip_smoke.bn_want_forward(x.detach(), w, b, rm, rv, res, training)
    assert_close(y.detach(), want_y, dt, "y")
    for got, want in ((rm_k, want_rm), (rv_k, want_rv)):
        assert (got.double() - want).abs().max() <= 1e-6 * max(1.0, want.abs().max())
    dy = activations(37, c, dt, 3)
    y.backward(dy)
    if training:
        var, mean = torch.var_mean(x.detach().double(), dim=(0, 2, 3), correction=0)
    else:
        mean, var = rm, rv
    dx, dw, db, dres = chip_smoke.bn_want_backward(x.detach(), y.detach(), dy, w, mean, var,
                                                   training)
    assert_close(x.grad, dx, dt, "dx")
    assert wp.grad.dtype == bp.grad.dtype == torch.float32
    assert_close(wp.grad, dw, torch.float32, "dweight")
    assert_close(bp.grad, db, torch.float32, "dbias")
    if residual:
        assert torch.equal(res.grad.double(), dres.to(dt).double())


@pytest.mark.parametrize("sms", [1, 3, 64])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_grids_and_the_scalar_path_of_an_unaligned_batch(sms, dtype, on_host):
    """C = 64 from a pointer off the 16-byte grid takes one value a thread;
    both paths agree with float64 on grids of 1, 3 and 64 SMs (the last
    more blocks than a pass needs)."""
    on_host.sms = sms
    dt = DTYPES[dtype]
    w, b, rm, rv = layer(64, 5)
    for offset in (False, True):
        x = activations(9, 64, dt, 6, offset=offset)
        assert (x.data_ptr() % 16 != 0) == offset
        rm_k, rv_k = rm.clone(), rv.clone()
        y = bn._kernels(x, w, b, rm_k, rv_k, None, True, MOMENTUM, EPS)
        want_y, want_rm, _ = chip_smoke.bn_want_forward(x, w, b, rm, rv, None, True)
        assert_close(y, want_y, dt, f"y (offset {offset})")
        assert (rm_k.double() - want_rm).abs().max() <= 1e-6 * max(1.0, want_rm.abs().max())


def test_the_kernels_are_deterministic_and_copy_other_layouts(on_host):
    """The same call twice gives the same bits; an NCHW-contiguous x and
    gradient are taken through a channels-last copy."""
    w, b, rm, rv = layer(64, 7)
    x = activations(16, 64, torch.bfloat16, 8)
    ys = [bn._kernels(x, w, b, rm.clone(), rv.clone(), None, True, MOMENTUM, EPS)
          for _ in range(2)]
    assert torch.equal(ys[0], ys[1])
    nchw = x.contiguous()
    assert not nchw.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(bn._kernels(nchw, w, b, rm.clone(), rv.clone(), None, True, MOMENTUM,
                                   EPS), ys[0])


def test_a_constant_channel_adds_a_variance_of_zero(on_host):
    """A channel with one value throughout: its batch variance is 0 exactly
    (the shift is that value), so the running variance moves to 0.99 of
    itself, never below."""
    w, b, rm, rv = layer(16, 9)
    rv.fill_(1.0)
    x = activations(32, 16, torch.float32, 10).clone()
    x[:, 3] = 0.7
    bn._kernels(x, w, b, rm, rv, None, True, MOMENTUM, EPS)
    assert rv[3].item() == pytest.approx(0.99, abs=1e-7) and (rv >= 0.99 - 1e-7).all()


def test_channels_past_a_block_are_refused(on_host):
    """257 channels of one value a thread do not fit a block's row of
    column groups: the library refuses the call, the wrapper raises."""
    w, b, rm, rv = layer(257, 11)
    x = torch.randn(2, 257, 4, 4).contiguous(memory_format=torch.channels_last)
    with pytest.raises(RuntimeError, match="do not take"):
        bn._kernels(x, w, b, rm, rv, None, True, MOMENTUM, EPS)


def model_step(dt, kernels: bool, monkeypatch) -> dict:
    """ActorCritic(8, 2) in train mode, one forward and backward of 24
    boards -> its outputs, state and gradients; with ``kernels`` through the
    wrapper's card path."""
    monkeypatch.setattr(resnet, "batch_norm_relu",
                        bn._kernels if kernels else bn.batch_norm_relu)
    boards = torch.randint(0, 12, (24, 4, 4), generator=torch.Generator().manual_seed(0))
    model = resnet.ActorCritic(8, 2, dtype=dt, device="cpu",
                               generator=torch.Generator().manual_seed(1)).train()
    logits, value = model(resnet.boards_to_model_input(boards, dt))
    (logits.square().sum() + value.sum()).backward()
    return {**{k: v.detach().double() for k, v in model.state_dict().items()},
            **{f"grad {k}": p.grad.double() for k, p in model.named_parameters()},
            "logits": logits.detach().double(), "value": value.detach().double()}


def worst(got: dict, want: dict) -> float:
    return max(((got[k] - w).abs().max() / max(1.0, w.abs().max().item())).item()
               for k, w in want.items())


def test_actor_critic_train_step_through_the_host_kernels(on_host, monkeypatch):
    """ActorCritic(8, 2), a train-mode forward and backward through the
    kernels (via the wrapper's card path): in float32 every output,
    statistic and gradient within 1e-4 of the plain version's largest
    magnitude; in bfloat16 no farther from the float32 model than the plain
    version's bfloat16 is (measured 0.16-0.19 of a gradient's largest
    magnitude for both at this batch of 24), within 1.25 times."""
    f32 = model_step(torch.float32, False, monkeypatch)
    assert worst(model_step(torch.float32, True, monkeypatch), f32) <= 1e-4
    plain = worst(model_step(torch.bfloat16, False, monkeypatch), f32)
    assert worst(model_step(torch.bfloat16, True, monkeypatch), f32) <= 1.25 * plain
