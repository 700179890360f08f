"""WAV file I/O (counterpart of azoom.io.wav): a small layer over
``scipy.io.wavfile`` with soundfile's (samples, channels) float32
conventions."""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np
from scipy.io import wavfile

__all__ = ["diagnose", "read_wav", "write_wav"]

_INT_SCALE = {
    np.dtype(np.int16): 2.0**15,
    np.dtype(np.int32): 2.0**31,
}


def read_wav(path: str | os.PathLike) -> tuple[np.ndarray, int]:
    """Read a WAV file as float32 in [-1, 1]. Returns (audio, fs), audio
    (samples,) for mono or (samples, channels) for multichannel."""
    fs, data = wavfile.read(os.fspath(path))
    dt = data.dtype
    if dt == np.uint8:  # offset binary
        audio = (data.astype(np.float32) - 128.0) / 128.0
    elif dt in (np.int16, np.int32):
        audio = data.astype(np.float32) / _INT_SCALE[np.dtype(dt)]
    else:
        audio = data.astype(np.float32)
    return audio, int(fs)


def write_wav(path: str | os.PathLike, audio: np.ndarray, fs: int) -> None:
    """Write float audio (samples,) or (samples, channels) as 32-bit float WAV."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    wavfile.write(os.fspath(path), int(fs), np.asarray(audio, dtype=np.float32))


def diagnose(path: str | os.PathLike) -> dict:
    """WAV sanity check: shape, NaN, Inf and silence heuristics."""
    audio, fs = read_wav(path)
    issues: list[str] = []
    if np.isnan(audio).any():
        issues.append("contains NaN samples")
    if np.isinf(audio).any():
        issues.append("contains Inf samples")
    peak = float(np.max(np.abs(audio))) if audio.size else 0.0
    if peak == 0.0:
        issues.append("all-zero (silent) audio")
    elif peak < 1e-4:
        issues.append(f"suspiciously quiet (peak={peak:.2e})")
    if audio.ndim > 1 and audio.shape[0] < audio.shape[1]:
        issues.append(f"shape {audio.shape} looks transposed (expected (samples, channels))")
    return {
        "path": os.fspath(path),
        "fs": fs,
        "shape": tuple(audio.shape),
        "duration_s": audio.shape[0] / fs if audio.size else 0.0,
        "peak": peak,
        "rms": float(np.sqrt(np.mean(audio**2))) if audio.size else 0.0,
        "issues": issues,
        "ok": not issues,
    }
