"""Corpus providers: local-directory datasets with caching (counterpart of
azoom.sim.datasets).

Scan a local directory tree for WAVs once, hand out random crops at the
pipeline's sample rate, and fall back to synthesized speech-like utterances
when no corpus is there, so every pipeline runs without a download.
``AZOOM_DATA_DIR`` (or the ``root`` argument) names the corpus root; the
nesting is free (a recursive glob).
"""

from __future__ import annotations

import functools
import os
from pathlib import Path

import numpy as np
import torch

from azoom_torch.dsp.resample import resample_fft
from azoom_torch.io.wav import read_wav
from azoom_torch.sim.signals import speech_like_batch

__all__ = ["LocalCorpus", "get_sources"]


class LocalCorpus:
    """Random-crop sampler over a directory tree of WAV files (decoded files
    cached per corpus, the 256 most recent)."""

    def __init__(self, root: str | os.PathLike, fs: int = 16_000):
        self.root = Path(root)
        self.fs = fs
        self.files = sorted(self.root.rglob("*.wav")) if self.root.is_dir() else []
        self._load = functools.lru_cache(maxsize=256)(self._decode)

    def __len__(self) -> int:
        return len(self.files)

    def _decode(self, path: str) -> np.ndarray:
        """One file as mono float32 at the corpus rate (read-only: cached)."""
        audio, fs = read_wav(path)
        if audio.ndim > 1:
            audio = audio.mean(axis=1)
        if fs != self.fs:
            audio = resample_fft(audio, int(len(audio) * self.fs / fs), device="cpu").numpy()
        audio = audio.astype(np.float32)
        audio.setflags(write=False)
        return audio

    def sample(self, rng: np.random.Generator, n_samples: int) -> np.ndarray:
        """One random crop (n_samples,); a file shorter than that is looped."""
        if not self.files:
            raise FileNotFoundError(f"no wavs under {self.root}")
        audio = self._load(str(self.files[int(rng.integers(len(self.files)))]))
        if len(audio) < n_samples:
            audio = np.tile(audio, -(-n_samples // max(len(audio), 1)))
        start = int(rng.integers(0, len(audio) - n_samples + 1))
        return audio[start:start + n_samples].copy()

    def sample_batch(self, rng: np.random.Generator, n_signals: int,
                     n_samples: int) -> np.ndarray:
        return np.stack([self.sample(rng, n_samples) for _ in range(n_signals)])


def get_sources(n_signals: int, n_samples: int, fs: int = 16_000,
                root: str | os.PathLike | None = None, seed: int = 0,
                device=None) -> np.ndarray:
    """(n_signals, n_samples) float32 sources: crops of the corpus at
    ``root`` (or ``AZOOM_DATA_DIR``) when it holds WAVs, else
    ``speech_like_batch`` from ``torch.Generator().manual_seed(seed)``,
    rendered on ``device`` (CUDA unless it names another). The synthetic
    sources differ from the reference's for the same seed."""
    root = root or os.environ.get("AZOOM_DATA_DIR")
    if root:
        corpus = LocalCorpus(root, fs)
        if len(corpus):
            return corpus.sample_batch(np.random.default_rng(seed), n_signals, n_samples)
    gen = torch.Generator().manual_seed(seed)
    return speech_like_batch(gen, n_signals, n_samples, fs, device=device).cpu().numpy()
