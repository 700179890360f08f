"""ctypes binding of the native (C++) push-based stream engine (counterpart
of azoom.stream.native).

The runtime layer between an audio callback and the device's enhancement
graph: ``cpp/stream_engine.cpp`` owns the ring buffer, the window
extraction and the Hann 50 % overlap-add, so ``AudioZoom.push`` does no
per-block NumPy reallocation. The source is the reference's, unchanged.

The port builds it itself, on first use, with the compiler and flags of
``cpp/Makefile`` (``$CXX``, else ``g++``; ``-O3 -march=native -fPIC -Wall
-Wextra -shared``), into ``azoom_torch/_build/libstream-<hash>.so``
(``azoom_torch.utils.cxx`` says how).

Unlike the reference, a failed build or load raises (with the compiler's
output) instead of falling back: the caller asked for the engine. Callers
that want the NumPy buffer ask for it (``AudioZoom(native=False)``).
"""

from __future__ import annotations

import ctypes
import subprocess
import threading

import numpy as np

from azoom_torch.utils import cxx

__all__ = ["native_available", "NativeStream", "library_path"]

SOURCE = cxx.CPP_DIR / "stream_engine.cpp"
BUILD_DIR = cxx.BUILD_DIR
CXX_FLAGS = cxx.MAKEFILE_FLAGS + ("-shared",)

_lock = threading.Lock()
_lib = None
_error: str | None = None
_cxx = cxx.compiler


def library_path():
    """The library this host builds and loads."""
    return cxx.library_path("stream", SOURCE, CXX_FLAGS, BUILD_DIR)


def _load() -> ctypes.CDLL:
    global _lib, _error
    with _lock:
        if _lib is not None:
            return _lib
        if _error is not None:
            raise RuntimeError(_error)
        try:
            lib = cxx.load("stream", SOURCE, CXX_FLAGS, BUILD_DIR, "the stream engine")
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            _error = f"native stream engine unavailable: {e}"
            raise RuntimeError(_error) from e
        f1 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        lib.azoom_stream_create.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.azoom_stream_create.restype = ctypes.c_void_p
        lib.azoom_stream_destroy.argtypes = [ctypes.c_void_p]
        lib.azoom_stream_destroy.restype = None
        lib.azoom_stream_reset.argtypes = [ctypes.c_void_p]
        lib.azoom_stream_reset.restype = None
        lib.azoom_stream_push.argtypes = [ctypes.c_void_p, f1, ctypes.c_int]
        lib.azoom_stream_push.restype = ctypes.c_int
        lib.azoom_stream_windows_ready.argtypes = [ctypes.c_void_p]
        lib.azoom_stream_windows_ready.restype = ctypes.c_int
        lib.azoom_stream_next_window.argtypes = [ctypes.c_void_p, f1]
        lib.azoom_stream_next_window.restype = ctypes.c_int
        lib.azoom_stream_commit.argtypes = [ctypes.c_void_p, f1, f1]
        lib.azoom_stream_commit.restype = ctypes.c_int
        _lib = lib
        return _lib


def native_available() -> bool:
    """Whether the engine builds and loads here (the build runs once per
    process; :class:`NativeStream` raises with the compiler's output when
    this is False)."""
    try:
        _load()
    except RuntimeError:
        return False
    return True


class NativeStream:
    """Push-based stream buffer with native window extraction and OLA.

    Usage (one enhanced hop per analysis window)::

        s = NativeStream(n_mics=2, win=32_000)
        s.push(block)                      # any (M, k), k >= 0
        for window in s.windows():         # (M, win) views, hop apart
            finalized = s.commit(enhance(window))   # (hop,) or (0,)
    """

    def __init__(self, n_mics: int, win: int):
        lib = _load()
        self._lib = lib
        self.n_mics, self.win, self.hop = n_mics, win, win // 2
        self._h = lib.azoom_stream_create(n_mics, win, self.hop)
        if not self._h:
            raise ValueError(f"bad stream geometry ({n_mics=}, {win=})")
        self._wbuf = np.empty((n_mics, win), np.float32)
        self._obuf = np.empty(self.hop, np.float32)

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.azoom_stream_destroy(h)
            self._h = None

    def reset(self) -> None:
        self._lib.azoom_stream_reset(self._h)

    def push(self, samples) -> None:
        samples = np.ascontiguousarray(samples, np.float32)
        if samples.ndim != 2 or samples.shape[0] != self.n_mics:
            raise ValueError(f"expected ({self.n_mics}, k), got {samples.shape}")
        if samples.shape[1] == 0:
            return
        rc = self._lib.azoom_stream_push(self._h, samples, samples.shape[1])
        if rc != 0:
            raise RuntimeError(f"native stream push error {rc}")

    def windows_ready(self) -> int:
        return self._lib.azoom_stream_windows_ready(self._h)

    def windows(self):
        """Yield each ready (M, win) analysis window (a reused buffer: consume
        or copy it before the next iteration). Windows are PEEKED: each must be
        answered with :meth:`commit` to advance the stream (the transactional
        contract: an enhancement failure between peek and commit loses no
        audio); skipping the commit re-yields the same window forever."""
        while self._lib.azoom_stream_next_window(self._h, self._wbuf):
            yield self._wbuf

    def commit(self, enhanced) -> np.ndarray:
        """Consume the last peeked window and overlap-add its enhancement;
        returns the finalized samples ((hop,) once the stream is warm, (0,)
        for the first window)."""
        enhanced = np.ascontiguousarray(enhanced, np.float32)
        if enhanced.shape != (self.win,):
            raise ValueError(f"expected ({self.win},), got {enhanced.shape}")
        n = self._lib.azoom_stream_commit(self._h, enhanced, self._obuf)
        if n < 0:
            raise RuntimeError("commit with no pending window")
        return self._obuf[:n].copy()
