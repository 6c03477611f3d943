"""ctypes bindings for the native engine and CSV library (counterpart of
``gym2048_tpu/native/__init__.py``).

``engine2048.cpp`` is a copy of the JAX package's source. It is built
lazily, with one ``g++`` command, into ``build/libgym2048_engine.so`` at the
repository root, with a stamp beside it; the library is rebuilt only when
the SHA-256 of the source and the flags changes. Nothing is written beside
either package's source. The flags leave out ``-march=native`` (the engine
is integer code), so a library built on one host runs on another.

Without a compiler everything degrades to the numpy paths, as in the JAX
package: :func:`available` reports which, and :func:`unavailable` forces the
numpy paths for a comparison.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "engine2048.cpp"
LIBRARY = Path(__file__).resolve().parent.parent.parent / "build" / "libgym2048_engine.so"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_lib: ctypes.CDLL | None = None
_build_error: str | None = None


def build(library: Path = LIBRARY, source: Path = SOURCE) -> Path:
    """Compile ``source`` into ``library`` with ``g++`` unless the stamp
    beside ``library`` shows this source built with these flags already.
    Raises ``OSError`` or ``subprocess.CalledProcessError`` on failure."""
    digest = hashlib.sha256(source.read_bytes() + " ".join(GXX_FLAGS).encode()).hexdigest()
    stamp = library.with_suffix(".sha256")
    if library.is_file() and stamp.is_file() and stamp.read_text() == digest:
        return library
    library.parent.mkdir(parents=True, exist_ok=True)
    tmp = library.with_name(f"{library.name}.{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *GXX_FLAGS, str(source), "-o", str(tmp)], check=True,
                       capture_output=True, text=True)
        os.replace(tmp, library)
    finally:
        tmp.unlink(missing_ok=True)
    stamp.write_text(digest)
    return library


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    i8, i32, f64, u8 = (np.ctypeslib.ndpointer(t, flags="C")
                        for t in (np.int8, np.int32, np.float64, np.uint8))
    lib.engine_init.restype = ctypes.c_int64
    lib.engine_shift_row.restype = ctypes.c_int64
    lib.engine_shift_row.argtypes = [i8, i8]
    lib.engine_move_batch.restype = None
    lib.engine_move_batch.argtypes = [i8, i32, ctypes.c_int64, i8, i32, u8]
    lib.csv_count_rows.restype = ctypes.c_int64
    lib.csv_count_rows.argtypes = [ctypes.c_char_p]
    lib.csv_read.restype = ctypes.c_int64
    lib.csv_read.argtypes = [ctypes.c_char_p, ctypes.c_int64, i32, i32, f64, i32, u8]
    lib.csv_write.restype = ctypes.c_int64
    lib.csv_write.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int64, i32, i32,
                              f64, i32, u8, ctypes.c_void_p]
    return lib


def get_lib() -> ctypes.CDLL | None:
    """Load (building if needed) the native library; None if unavailable."""
    global _lib, _build_error
    if _lib is not None:
        return _lib
    if _build_error is not None:
        return None
    try:
        _lib = _declare(ctypes.CDLL(str(build())))
    except (OSError, subprocess.CalledProcessError) as e:
        _build_error = str(e)
        return None
    return _lib


def available() -> bool:
    return get_lib() is not None


@contextlib.contextmanager
def unavailable():
    """Within this context :func:`available` is False, so ``TrainingData``
    takes its numpy CSV paths."""
    global _lib, _build_error
    saved = _lib, _build_error
    _lib, _build_error = None, "disabled by native.unavailable()"
    try:
        yield
    finally:
        _lib, _build_error = saved


# ------------------------------------------------------------------ engine
def _require() -> ctypes.CDLL:
    lib = get_lib()
    if lib is None:
        raise RuntimeError(f"the native engine is unavailable: {_build_error}")
    return lib


def shift_row(row_exp: np.ndarray) -> tuple[np.ndarray, int]:
    """Compact and merge one row of 4 exponents leftward -> ``(row, score)``."""
    lib = _require()
    row = np.ascontiguousarray(row_exp, dtype=np.int8)
    out = np.zeros(4, np.int8)
    score = lib.engine_shift_row(row, out)
    return out, int(score)


def move_batch(boards_exp: np.ndarray, actions: np.ndarray
               ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Apply per-board actions to exponent boards. Returns ``(moved,
    scores, legal)``; an illegal move leaves its board unchanged."""
    lib = _require()
    boards = np.ascontiguousarray(boards_exp.reshape(-1, 16), dtype=np.int8)
    acts = np.ascontiguousarray(actions, dtype=np.int32).reshape(-1)
    n = boards.shape[0]
    if acts.shape[0] != n:
        raise ValueError(f"{acts.shape[0]} actions for {n} boards")
    out = np.zeros_like(boards)
    scores = np.zeros(n, np.int32)
    legal = np.zeros(n, np.uint8)
    lib.engine_move_batch(boards, acts, n, out, scores, legal)
    return out.reshape(boards_exp.shape), scores, legal.astype(bool)


# --------------------------------------------------------------------- CSV
def csv_read(path: str):
    """Read the 35/36-column schema. Returns ``(boards, actions, rewards,
    next_boards, dones)``, or None when the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    n = lib.csv_count_rows(str(path).encode())
    if n < 0:
        raise FileNotFoundError(path)
    boards = np.zeros((n, 16), np.int32)
    actions = np.zeros(n, np.int32)
    rewards = np.zeros(n, np.float64)
    next_boards = np.zeros((n, 16), np.int32)
    dones = np.zeros(n, np.uint8)
    got = lib.csv_read(str(path).encode(), n, boards, actions, rewards, next_boards, dones)
    if got < 0:
        raise ValueError(f"malformed CSV: {path}")
    return (boards[:got].reshape(-1, 4, 4), actions[:got], rewards[:got],
            next_boards[:got].reshape(-1, 4, 4), dones[:got].astype(bool))


def csv_write(path: str, header: str, boards, actions, rewards, next_boards, dones,
              returns=None) -> int:
    """Write the rows in the reference's exact format; returns the rows
    written."""
    lib = _require()
    boards = np.ascontiguousarray(boards.reshape(-1, 16), np.int32)
    n = boards.shape[0]
    acts = np.ascontiguousarray(actions, np.int32).reshape(-1)
    rews = np.ascontiguousarray(rewards, np.float64).reshape(-1)
    nxt = np.ascontiguousarray(next_boards.reshape(-1, 16), np.int32)
    dn = np.ascontiguousarray(dones, np.uint8).reshape(-1)
    ret_ptr = None
    if returns is not None:
        returns = np.ascontiguousarray(returns, np.float64).reshape(-1)
        ret_ptr = returns.ctypes.data_as(ctypes.c_void_p)
    written = int(lib.csv_write(str(path).encode(), header.encode(), n, boards, acts, rews,
                                nxt, dn, ret_ptr))
    if written < 0:
        raise OSError(f"cannot write {path}")
    return written
