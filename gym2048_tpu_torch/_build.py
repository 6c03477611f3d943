"""Build and load the CUDA libraries of the port's kernels.

Each source under ``csrc/`` has a plain C interface, includes no PyTorch
header, and builds with one ``nvcc`` command into a library of its own
(``LIBRARIES``) in seconds:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/libgym2048_fused.so csrc/fused_step.cu

The libraries go to ``build/`` at the repository root, each with a stamp
beside it, and a library is rebuilt only when the SHA-256 of its source and
the flags changes. :func:`library` builds one at its first use;
:func:`build_all` starts one ``nvcc`` per source, all at once, and waits for
them. A library is loaded with ``ctypes``; every pointer and the stream are
declared ``c_void_p`` so that ctypes passes them as 64-bit values. A missing
``nvcc`` or a failed build raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD = Path(__file__).resolve().parent.parent / "build"
# name -> (source, library); the name is the one library() takes
LIBRARIES = {
    "fused_step": (CSRC / "fused_step.cu", BUILD / "libgym2048_fused.so"),
    "table_gather": (CSRC / "table_gather.cu", BUILD / "libgym2048_gather.so"),
    "batch_norm": (CSRC / "batch_norm.cu", BUILD / "libgym2048_batch_norm.so"),
    "tc_combine": (CSRC / "tc_combine.cu", BUILD / "libgym2048_tc_combine.so"),
}
SOURCE, LIBRARY = LIBRARIES["fused_step"]
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_P, _I, _LL, _U32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_uint32
_F, _D = ctypes.c_float, ctypes.c_double
_STR = ([_I], ctypes.c_char_p)
# library name -> C function -> (argument types, result type)
_SIGNATURES = {
    "fused_step": {
        "gym_fused_move": ([_P, _P, _P, _P, _P, _LL, _P], _I),
        "gym_fused_step_uniform": ([_P, _P, _P, _P, _P, _P, _LL, _I, _P], _I),
        "gym_fused_rollout": ([_P, _U32, _I, _I, _P, _P, _P, _P, _LL, _P], _I),
        "gym_random_uniform_rows": ([_U32, _P, _LL, _LL, _P], _I),
        "gym_philox4x32": ([_P, _P, _P, _LL, _P], _I),
        "gym_error_string": _STR,
    },
    "table_gather": {
        "gym_gather_values": ([_P, _P, _P, _LL, _P], _I),
        "gym_gather_error_string": _STR,
    },
    "batch_norm": {
        "gym_bn_forward": ([_I, _I, _P, _P, _P, _LL, _I, _P, _P, _P, _P, _I, _F, _D, _P, _P,
                            _P, _I, _I, _P], _I),
        "gym_bn_backward": ([_I, _I, _P, _P, _P, _P, _P, _LL, _I, _P, _P, _P, _I, _P, _P, _P,
                             _P, _I, _I, _P], _I),
        "gym_bn_error_string": _STR,
    },
    "tc_combine": {
        "gym_tc_combine": ([_P, _LL, _P, _P, _P, _P, _P, _P, _F, _P], _I),
        "gym_tc_combine_error_string": _STR,
    },
}


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``/usr/local/cuda/bin``,
    then ``PATH``. Raises if there is none."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the port's "
                           "kernels cannot be built")
    return found


def _start(source: Path, library: Path, nvcc: str | None):
    """Start ``nvcc`` on ``source`` unless the stamp beside ``library``
    shows that this source was built with these flags already; returns the
    job for :func:`_finish`, or None."""
    digest = hashlib.sha256(source.read_bytes() + " ".join(NVCC_FLAGS).encode()
                            ).hexdigest()
    stamp = library.with_suffix(".sha256")
    if library.is_file() and stamp.is_file() and stamp.read_text() == digest:
        return None
    library.parent.mkdir(parents=True, exist_ok=True)
    tmp = library.with_name(f"{library.name}.{os.getpid()}.tmp")
    cmd = [nvcc or find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    return proc, cmd, tmp, library, stamp, digest


def _finish(job) -> None:
    """Wait for a job of :func:`_start`; install the library and its stamp,
    or raise with the compiler's output."""
    proc, cmd, tmp, library, stamp, digest = job
    out, err = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                           f"{out}{err}")
    os.replace(tmp, library)
    stamp.write_text(digest)


def build(source: Path = SOURCE, library: Path = LIBRARY,
          nvcc: str | None = None) -> Path:
    """Compile ``source`` into ``library`` unless it is up to date.
    Returns the path."""
    job = _start(source, library, nvcc)
    if job is not None:
        _finish(job)
    return library


def build_all(nvcc: str | None = None,
              libraries: dict[str, tuple[Path, Path]] | None = None) -> dict[str, Path]:
    """Build every library of ``libraries`` (name -> (source, library),
    by default ``LIBRARIES``) that is out of date, one ``nvcc`` per source,
    all started together. Returns name -> path."""
    nvcc = nvcc or find_nvcc()
    libraries = LIBRARIES if libraries is None else libraries
    jobs = [_start(src, lib, nvcc) for src, lib in libraries.values()]
    errors = []
    for job in jobs:
        if job is not None:
            try:
                _finish(job)
            except RuntimeError as e:  # wait for every job before raising
                errors.append(e)
    if errors:
        raise errors[0]
    return {name: lib for name, (_, lib) in libraries.items()}


def load(path: Path, name: str) -> ctypes.CDLL:
    """The built library at ``path`` with the C functions of the library
    ``name`` (a key of ``LIBRARIES``) declared."""
    lib = ctypes.CDLL(str(path))
    for fn_name, (argtypes, restype) in _SIGNATURES[name].items():
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


@functools.cache
def library(name: str = "fused_step") -> ctypes.CDLL:
    """The built library ``name`` (a key of ``LIBRARIES``) with every C
    function's types declared."""
    return load(build(*LIBRARIES[name]), name)
