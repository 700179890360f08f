"""ctypes binding of the native corpus prefetch engine (counterpart of
azoom.sim.corpus_native).

A C++ background thread (the reference's ``cpp/corpus_engine.cpp``,
unchanged) scans a directory tree for WAVs, decodes them (PCM 8/16/24/32 and
float32, mono downmix, windowed-sinc resample), and keeps a bounded ring of
pre-cropped source batches filled ahead of the consumer: ``next_batch()`` is
a copy, so host IO rides under device compute. The engine owns its
xorshift64* sampling stream, seeded at open, so a seed and a file set give
the reference engine's crops. The port builds it with ``cpp/Makefile``'s
flags and ``-pthread`` into ``azoom_torch/_build/libcorpus-<hash>.so``
(``azoom_torch.utils.cxx`` says how).

Unlike the reference, which leaves the caller to fall back to
``LocalCorpus``, a failed build or load raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import subprocess
import threading

import numpy as np

from azoom_torch.utils import cxx

__all__ = ["native_available", "NativeCorpus"]

SOURCE = cxx.CPP_DIR / "corpus_engine.cpp"
BUILD_DIR = cxx.BUILD_DIR
CXX_FLAGS = cxx.MAKEFILE_FLAGS + ("-shared", "-pthread")

_lock = threading.Lock()
_lib = None
_error: str | None = None


def _load() -> ctypes.CDLL:
    global _lib, _error
    with _lock:
        if _lib is not None:
            return _lib
        if _error is not None:
            raise RuntimeError(_error)
        try:
            lib = cxx.load("corpus", SOURCE, CXX_FLAGS, BUILD_DIR, "the corpus engine")
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            _error = f"native corpus engine unavailable: {e}"
            raise RuntimeError(_error) from e
        f1 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        lib.azoom_corpus_open.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_uint64, ctypes.c_int,
            ctypes.c_int, ctypes.c_int,
        ]
        lib.azoom_corpus_open.restype = ctypes.c_void_p
        lib.azoom_corpus_n_files.argtypes = [ctypes.c_void_p]
        lib.azoom_corpus_n_files.restype = ctypes.c_int
        lib.azoom_corpus_n_dropped.argtypes = [ctypes.c_void_p]
        lib.azoom_corpus_n_dropped.restype = ctypes.c_int
        lib.azoom_corpus_next.argtypes = [ctypes.c_void_p, f1]
        lib.azoom_corpus_next.restype = None
        lib.azoom_corpus_close.argtypes = [ctypes.c_void_p]
        lib.azoom_corpus_close.restype = None
        _lib = lib
        return _lib


def native_available() -> bool:
    """Whether the engine builds and loads here (:class:`NativeCorpus`
    raises with the compiler's output when this is False)."""
    try:
        _load()
    except RuntimeError:
        return False
    return True


class NativeCorpus:
    """Prefetching random-crop sampler over a directory tree of WAVs: the
    corpus contract of ``datasets.LocalCorpus``, with batches of
    ``n_signals`` crops of ``n_samples`` made by the C++ worker thread
    ``depth`` slots ahead. The sampling stream is the engine's (seeded at
    open), so ``next_batch()`` takes no generator."""

    def __init__(self, root, fs: int = 16_000, *, n_signals: int, n_samples: int,
                 seed: int = 0, depth: int = 2):
        if n_signals <= 0 or n_samples <= 0:
            raise ValueError(f"bad batch shape ({n_signals=}, {n_samples=})")
        self._lib = _load()
        self.n_signals, self.n_samples = n_signals, n_samples
        self._h = self._lib.azoom_corpus_open(str(root).encode(), fs,
                                              seed & 0xFFFFFFFFFFFFFFFF, n_signals,
                                              n_samples, depth)
        if not self._h:
            raise FileNotFoundError(f"no decodable wavs under {root}")
        dropped = self.n_dropped
        if dropped:
            print(f"[CORPUS] native loader dropped {dropped} undecodable "
                  f"wav(s) under {root} ({len(self)} usable)")

    def __len__(self) -> int:
        return int(self._lib.azoom_corpus_n_files(self._h))

    @property
    def n_dropped(self) -> int:
        """Files found but rejected by the open-time decode probe."""
        return int(self._lib.azoom_corpus_n_dropped(self._h))

    def next_batch(self) -> np.ndarray:
        """(n_signals, n_samples) float32; blocks only while the prefetch
        ring is empty (a cold start)."""
        if not self._h:
            raise ValueError("corpus is closed")
        out = np.empty(self.n_signals * self.n_samples, np.float32)
        self._lib.azoom_corpus_next(self._h, out)
        return out.reshape(self.n_signals, self.n_samples)

    def close(self) -> None:
        """Stop the worker thread and free the engine (idempotent)."""
        if self._h:
            self._lib.azoom_corpus_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        if getattr(self, "_h", None):
            self.close()
