"""Build and load the CUDA library of the fused step kernels.

``csrc/fused_step.cu`` has a plain C interface and includes no PyTorch
header, so one ``nvcc`` command builds it in seconds:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/libgym2048_fused.so csrc/fused_step.cu

The library goes to ``build/`` at the repository root and is rebuilt only
when the SHA-256 of the source and flags changes. It is loaded with
``ctypes``; every pointer and the stream are declared ``c_void_p`` so that
ctypes passes them as 64-bit values. A missing ``nvcc`` or a failed build
raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

SOURCE = Path(__file__).resolve().parent / "csrc" / "fused_step.cu"
LIBRARY = Path(__file__).resolve().parent.parent / "build" / "libgym2048_fused.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_P, _I, _LL, _U32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_uint32
_SIGNATURES = {
    "gym_fused_move": [_P, _P, _P, _P, _P, _LL, _P],
    "gym_fused_step_uniform": [_P, _P, _P, _P, _P, _P, _LL, _I, _P],
    "gym_fused_rollout": [_P, _U32, _I, _I, _P, _P, _P, _P, _LL, _P],
    "gym_random_uniform_rows": [_U32, _P, _LL, _LL, _P],
    "gym_philox4x32": [_P, _P, _P, _LL, _P],
}


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``/usr/local/cuda/bin``,
    then ``PATH``. Raises if there is none."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the fused step "
                           "kernels cannot be built")
    return found


def build(source: Path = SOURCE, library: Path = LIBRARY,
          nvcc: str | None = None) -> Path:
    """Compile ``source`` into ``library`` unless the stamp beside it shows
    that this source was built with these flags already. Returns the path."""
    digest = hashlib.sha256(source.read_bytes() + " ".join(NVCC_FLAGS).encode()
                            ).hexdigest()
    stamp = library.with_suffix(".sha256")
    if library.is_file() and stamp.is_file() and stamp.read_text() == digest:
        return library
    library.parent.mkdir(parents=True, exist_ok=True)
    tmp = library.with_name(f"{library.name}.{os.getpid()}.tmp")
    cmd = [nvcc or find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
    done = subprocess.run(cmd, capture_output=True, text=True)
    if done.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({done.returncode}): {' '.join(cmd)}\n"
                           f"{done.stdout}{done.stderr}")
    os.replace(tmp, library)
    stamp.write_text(digest)
    return library


@functools.cache
def library() -> ctypes.CDLL:
    """The built library with every launcher's argument types declared."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.gym_error_string.argtypes = [ctypes.c_int]
    lib.gym_error_string.restype = ctypes.c_char_p
    return lib
