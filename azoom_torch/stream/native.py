"""ctypes binding of the native (C++) push-based stream engine (counterpart
of azoom.stream.native).

The runtime layer between an audio callback and the device's enhancement
graph: ``cpp/stream_engine.cpp`` owns the ring buffer, the window
extraction and the Hann 50 % overlap-add, so ``AudioZoom.push`` does no
per-block NumPy reallocation. The source is the reference's, unchanged.

The port builds it itself, on first use, with the compiler and flags of
``cpp/Makefile`` (``$CXX``, else ``g++``; ``-O3 -march=native -fPIC -Wall
-Wextra -shared``), into ``azoom_torch/_build/libstream-<hash>.so``: the hash
covers the source, the flags and what ``-march=native`` expands to on this
host, so a checkout shared by two kinds of CPU keeps one library for each.
The compiler writes a temporary file that is renamed into place, so processes
building at once never load a half-written library.

Unlike the reference, a failed build or load raises (with the compiler's
output) instead of falling back: the caller asked for the engine. Callers
that want the NumPy buffer ask for it (``AudioZoom(native=False)``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

__all__ = ["native_available", "NativeStream", "library_path"]

SOURCE = Path(__file__).resolve().parents[2] / "cpp" / "stream_engine.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-Wall", "-Wextra", "-shared")

_lock = threading.Lock()
_lib = None
_error: str | None = None


def _cxx() -> str:
    return os.environ.get("CXX", "g++")


def _native_arch() -> bytes:
    """What ``-march=native`` means on this host: the compiler's own command
    line for an empty C++ input (the target CPU and its feature flags)."""
    out = subprocess.run([_cxx(), "-march=native", "-x", "c++", "-E", "-v", "-"],
                         input=b"", capture_output=True, timeout=60)
    return b"\n".join(line for line in out.stderr.splitlines() if b"cc1" in line)


def library_path() -> Path:
    """The library this host builds and loads."""
    h = hashlib.sha256(" ".join((_cxx(),) + CXX_FLAGS).encode() + b"\0" + _native_arch())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libstream-{h.hexdigest()[:16]}.so"


def _build(target: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=target.stem + ".", suffix=".tmp", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([_cxx(), *CXX_FLAGS, str(SOURCE), "-o", tmp],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"building the stream engine failed (rc {proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, target)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load() -> ctypes.CDLL:
    global _lib, _error
    with _lock:
        if _lib is not None:
            return _lib
        if _error is not None:
            raise RuntimeError(_error)
        try:
            target = library_path()
            if not target.exists():
                _build(target)
            lib = ctypes.CDLL(str(target))
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
