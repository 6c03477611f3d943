"""The port stands alone: no JAX, nothing of gym2048_tpu, no PyTorch headers.

The machine with the GPU has PyTorch and no JAX, so the port and
chip_smoke.py must import with ``jax`` and ``gym2048_tpu`` unavailable, and
importing them must not build or load the CUDA library.
"""

import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "gym2048_tpu_torch"
PORT_MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
    for p in PORT.rglob("*.py")
)

# The host side and the CLI shell; every one but GYMNASIUM_MODULES runs on
# the card's machine, which has no gymnasium, Orbax, ml_dtypes, pygame or
# matplotlib, and may lack PIL and TensorBoard.
HOST_SIDE = {
    "gym2048_tpu_torch.core.rules_np", "gym2048_tpu_torch.native",
    "gym2048_tpu_torch.data", "gym2048_tpu_torch.data.training_data",
    "gym2048_tpu_torch.env.parity", "gym2048_tpu_torch.env.adapter",
    "gym2048_tpu_torch.utils.render", "gym2048_tpu_torch.utils.metrics",
    "gym2048_tpu_torch.utils.video", "gym2048_tpu_torch.tools",
    *(f"gym2048_tpu_torch.tools.{name}" for name in (
        "selfplay", "pretrain_bc", "ppo", "evaluate", "train", "merge_data", "augment_data",
        "hflip_data", "distribute_data", "add_rewards", "convert_model", "gather")),
}
# data parallel and the debugging utilities
PARALLEL_AND_UTILS = {
    "gym2048_tpu_torch.parallel", "gym2048_tpu_torch.parallel.mesh",
    "gym2048_tpu_torch.utils.debug", "gym2048_tpu_torch.utils.profiler",
}
# the top-level entry points: the headline bench, the dry run, the scaling bench
ENTRY_POINTS = {"gym2048_tpu_torch.bench", "gym2048_tpu_torch.scaling_bench",
                       "gym2048_tpu_torch.entry"}
GYMNASIUM_MODULES = {"gym2048_tpu_torch.env.registration", "gym2048_tpu_torch.env.vector"}
OPTIONAL = ("gymnasium", "orbax", "ml_dtypes", "pygame", "matplotlib", "PIL", "tensorboard")

_IMPORT = re.compile(r"^\s*(?:import|from)\s+(jax|gym2048_tpu)(?![\w_])", re.M)


def test_port_modules_are_found():
    assert {"gym2048_tpu_torch", "gym2048_tpu_torch.core.rules",
            "gym2048_tpu_torch.core.fused_step", "gym2048_tpu_torch.env.batched",
            "gym2048_tpu_torch.interop", "gym2048_tpu_torch._build",
            "gym2048_tpu_torch._sass", "gym2048_tpu_torch.models.ntuple",
            "gym2048_tpu_torch.models.table_gather",
            "gym2048_tpu_torch.models.ntuple_big",
            "gym2048_tpu_torch.agents.expectimax",
            "gym2048_tpu_torch.utils.checkpoint", "gym2048_tpu_torch.train",
            "gym2048_tpu_torch.train.td", "gym2048_tpu_torch.ops",
            "gym2048_tpu_torch.ops.obs", "gym2048_tpu_torch.ops.augment",
            "gym2048_tpu_torch.ops.returns", "gym2048_tpu_torch.models.resnet",
            "gym2048_tpu_torch.entry", "gym2048_tpu_torch.train.ppo",
            "gym2048_tpu_torch.train.bc", "gym2048_tpu_torch.train.eval",
            "gym2048_tpu_torch.models", *HOST_SIDE, *GYMNASIUM_MODULES,
            *PARALLEL_AND_UTILS, *ENTRY_POINTS} <= set(PORT_MODULES)


def test_imports_without_jax_or_the_jax_package():
    code = "\n".join([
        "import sys",
        "sys.modules['jax'] = None",
        "sys.modules['gym2048_tpu'] = None",
        "import importlib",
        f"for name in {PORT_MODULES!r} + ['chip_smoke']:",
        "    importlib.import_module(name)",
        "from gym2048_tpu_torch import _build",
        "assert _build.library.cache_info().currsize == 0, 'library loaded at import'",
        "assert not any(m == 'triton' or m.startswith('triton.') for m in sys.modules)",
        "assert not any(m == 'jax' or m.startswith(('jax.', 'gym2048_tpu.'))",
        "               for m in sys.modules if sys.modules[m] is not None)",
        "print('ISOLATED')",
    ])
    done = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stderr
    assert "ISOLATED" in done.stdout


def test_card_path_imports_without_the_optional_packages():
    """Every module but the gymnasium ones, and chip_smoke.py, imports with
    gymnasium, Orbax, ml_dtypes, pygame, matplotlib, PIL and TensorBoard
    unavailable; the gymnasium ones then fail on gymnasium alone."""
    card = [m for m in PORT_MODULES if m not in GYMNASIUM_MODULES]
    code = "\n".join([
        "import sys",
        f"for name in {['jax', 'gym2048_tpu', *OPTIONAL]!r}:",
        "    sys.modules[name] = None",
        "import importlib",
        f"for name in {card!r} + ['chip_smoke']:",
        "    importlib.import_module(name)",
        f"for name in {sorted(GYMNASIUM_MODULES)!r}:",
        "    try:",
        "        importlib.import_module(name)",
        "    except ImportError as e:",
        "        assert 'gymnasium' in str(e), e",
        "    else:",
        "        raise AssertionError(name + ' imported without gymnasium')",
        "print('CARD PATH OK')",
    ])
    done = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert done.returncode == 0, done.stderr
    assert "CARD PATH OK" in done.stdout


def test_no_source_names_jax_or_the_jax_package_in_an_import():
    sources = [*PORT.rglob("*.py"), ROOT / "chip_smoke.py"]
    offenders = [str(p) for p in sources if _IMPORT.search(p.read_text())]
    assert not offenders


def test_cuda_sources_include_no_pytorch_header():
    cu = list((PORT / "csrc").glob("*.cu*"))
    assert cu
    for p in cu:
        assert "torch/extension.h" not in p.read_text()
        assert not re.search(r"#include\s*[<\"](torch|ATen|c10)/", p.read_text())
