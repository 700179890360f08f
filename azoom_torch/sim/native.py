"""ctypes binding of the native (C++/OpenMP) image-source RIR engine
(counterpart of azoom.sim.native).

The host-side twin of ``sim.room``'s ISM for CPU-bound scene factories: the
same Allen-Berkley model and windowed-sinc injection, in double precision,
parallel over the image lattice with one partial buffer per OpenMP thread
(so its bits depend on the thread count). The source is the reference's
``cpp/rir_engine.cpp``, unchanged; the port builds it with ``cpp/Makefile``'s
flags and ``-fopenmp`` into ``azoom_torch/_build/librir-<hash>.so``
(``azoom_torch.utils.cxx`` says how). Where the compiler has no OpenMP
runtime, it builds without ``-fopenmp``: the source's pragmas and
``#if defined(_OPENMP)`` guards then give the same loop on one thread
(:func:`build_flags` says which).

Unlike the reference, which falls back to its JAX ISM when no toolchain is
there, a failed build or load raises with the compiler's output: the caller
asked for the engine (``sim.room`` is the device path).
"""

from __future__ import annotations

import ctypes
import subprocess
import threading

import numpy as np

from azoom_torch.utils import cxx

__all__ = ["native_available", "build_flags", "shoebox_rir_native", "rir_matrix_native"]

SOURCE = cxx.CPP_DIR / "rir_engine.cpp"
BUILD_DIR = cxx.BUILD_DIR
CXX_FLAGS = cxx.MAKEFILE_FLAGS + ("-fopenmp", "-shared")

_lock = threading.Lock()
_lib = None
_error: str | None = None


def build_flags() -> tuple:
    """The flags this host builds the engine with: ``CXX_FLAGS``, less
    ``-fopenmp`` where the compiler refuses it."""
    return cxx.accepted(CXX_FLAGS, ("-fopenmp",), BUILD_DIR)


def _load() -> ctypes.CDLL:
    global _lib, _error
    with _lock:
        if _lib is not None:
            return _lib
        if _error is not None:
            raise RuntimeError(_error)
        try:
            lib = cxx.load("rir", SOURCE, build_flags(), BUILD_DIR, "the RIR engine")
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            _error = f"native RIR engine unavailable: {e}"
            raise RuntimeError(_error) from e
        d3 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        f1 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        lib.azoom_shoebox_rir.argtypes = [
            d3, d3, d3, ctypes.c_double, ctypes.c_int, ctypes.c_int,
            ctypes.c_double, ctypes.c_int, f1, ctypes.c_int,
        ]
        lib.azoom_shoebox_rir.restype = ctypes.c_int
        lib.azoom_rir_matrix.argtypes = [
            d3, ctypes.c_int, d3, ctypes.c_int, d3, ctypes.c_double,
            ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_int,
            f1, ctypes.c_int,
        ]
        lib.azoom_rir_matrix.restype = ctypes.c_int
        _lib = lib
        return _lib


def native_available() -> bool:
    """Whether the engine builds and loads here (the build runs once per
    process; the entry points raise with the compiler's output when this is
    False)."""
    try:
        _load()
    except RuntimeError:
        return False
    return True


def _point(x) -> np.ndarray:
    p = np.ascontiguousarray(x, np.float64)
    if p.shape != (3,):
        raise ValueError(f"expected a (3,) position, got {p.shape}")
    return p


def shoebox_rir_native(source, mic, room_dim, absorption: float, max_order: int = 15,
                       fs: int = 16_000, rir_length: int = 8_000, n_taps: int = 16,
                       c: float = 343.0) -> np.ndarray:
    """The (rir_length,) float32 RIR from ``source`` to ``mic``, on host threads."""
    lib = _load()
    out = np.zeros(rir_length, np.float32)
    rc = lib.azoom_shoebox_rir(_point(source), _point(mic), _point(room_dim), float(absorption),
                               int(max_order), int(fs), float(c), int(n_taps), out,
                               int(rir_length))
    if rc != 0:
        raise RuntimeError(f"native RIR engine error {rc}")
    return out


def rir_matrix_native(sources, mics, room_dim, absorption: float, max_order: int = 15,
                      fs: int = 16_000, rir_length: int = 8_000, n_taps: int = 16,
                      c: float = 343.0) -> np.ndarray:
    """(S, M, rir_length) float32 RIR table, on host threads."""
    lib = _load()
    sources = np.ascontiguousarray(np.atleast_2d(sources), np.float64)
    mics = np.ascontiguousarray(np.atleast_2d(mics), np.float64)
    if sources.shape[1:] != (3,) or mics.shape[1:] != (3,):
        raise ValueError(f"expected (S, 3) and (M, 3) positions, got {sources.shape}, "
                         f"{mics.shape}")
    out = np.zeros((len(sources), len(mics), rir_length), np.float32)
    rc = lib.azoom_rir_matrix(sources, len(sources), mics, len(mics), _point(room_dim),
                              float(absorption), int(max_order), int(fs), float(c),
                              int(n_taps), out.reshape(-1), int(rir_length))
    if rc != 0:
        raise RuntimeError(f"native RIR engine error {rc}")
    return out
