"""The port's corpus providers (azoom_torch.sim.{datasets,corpus_native}) on
WAVs written here, against azoom.sim.datasets.

- LocalCorpus gives the reference's crops for the same NumPy generator
  (16 kHz files: equal; a resampled file within 1e-5 of its peak: the port
  resamples in float64, the reference in float32); get_sources falls back
  to speech-like sources from torch.Generator().manual_seed(seed), which
  differ from the reference's for the same seed.
- NativeCorpus runs the reference's cpp/corpus_engine.cpp, built by the
  port: the crops equal a Python replay of the engine's xorshift64* stream
  over the decoded files (so a seed and a file set give the reference
  engine's crops), plus the contract of tests/test_native_corpus.py:58-200
  (scan, decode parity, dropped files, PCM24, anti-aliased resampling,
  determinism, prefetch). The reference's own engine is not built here: its
  binding runs ``make -C cpp``, which the JAX tests use.
"""

import struct
import time
import wave

import numpy as np
import pytest
import torch

from azoom.sim.datasets import LocalCorpus as JaxCorpus
from azoom_torch.io.wav import read_wav, write_wav
from azoom_torch.sim import corpus_native
from azoom_torch.sim.corpus_native import NativeCorpus
from azoom_torch.sim.datasets import LocalCorpus, get_sources
from azoom_torch.sim.signals import speech_like_batch

FS = 16_000


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU work in one thread while this file runs (the suite's
    other workers share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write_wav(path, audio, fs=FS, fmt="pcm16", channels=1):
    audio = np.asarray(audio, np.float32)
    if channels > 1:
        audio = np.stack([audio] * channels, axis=1)
    if fmt == "pcm16":
        with wave.open(str(path), "wb") as w:
            w.setnchannels(channels)
            w.setsampwidth(2)
            w.setframerate(fs)
            w.writeframes((np.clip(audio, -1, 1) * 32767).astype("<i2").tobytes())
    else:  # float32 RIFF written by hand
        data = audio.astype("<f4").tobytes()
        hdr = b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVE"
        hdr += b"fmt " + struct.pack("<IHHIIHH", 16, 3, channels, fs, fs * 4 * channels,
                                     4 * channels, 32)
        hdr += b"data" + struct.pack("<I", len(data))
        path.write_bytes(hdr + data)


def _write_wav24(path, audio, fs=FS):
    x = (np.clip(np.asarray(audio, np.float64), -1, 1) * 8388607).astype(np.int64)
    data = b"".join(struct.pack("<i", int(v) << 8)[1:4] for v in x)
    hdr = b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVE"
    hdr += b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, fs, fs * 3, 3, 24)
    hdr += b"data" + struct.pack("<I", len(data))
    path.write_bytes(hdr + data)


@pytest.fixture(scope="module")
def corpus_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("sim_corpus")
    rng = np.random.default_rng(0)
    t = np.arange(8_000) / FS
    _write_wav(d / "a.wav", 0.5 * np.sin(2 * np.pi * 440 * t))
    _write_wav(d / "b.wav", 0.25 * rng.standard_normal(4_000), fmt="f32")
    (d / "sub").mkdir()
    _write_wav(d / "sub" / "c.wav", 0.1 * rng.standard_normal(2_000), channels=2)
    _write_wav(d / "sub" / "d_8k.wav", 0.2 * rng.standard_normal(4_000), fs=8_000)
    return d


# -- LocalCorpus and get_sources -----------------------------------------------


def test_local_corpus_gives_the_references_crops(tmp_path):
    rng = np.random.default_rng(0)
    for i in range(3):
        write_wav(tmp_path / f"a/{i}.wav", rng.standard_normal(12_000) * 0.1, FS)
    write_wav(tmp_path / "b/x8k.wav", rng.standard_normal(8_000) * 0.1, 8_000)
    got, ref = LocalCorpus(tmp_path), JaxCorpus(tmp_path)
    assert len(got) == len(ref) == 4
    crop = got.sample(np.random.default_rng(0), 8_000)
    assert crop.shape == (8_000,) and crop.dtype == np.float32
    for n, seed in ((8_000, 0), (20_000, 1), (4_000, 2), (3_000, 5)):  # 20k loops short files
        g = got.sample_batch(np.random.default_rng(seed), 6, n)
        r = ref.sample_batch(np.random.default_rng(seed), 6, n)
        assert g.shape == r.shape == (6, n)
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-5 * float(np.abs(r).max()))
    up = got._load(str(tmp_path / "b/x8k.wav"))
    assert up.shape == (16_000,)  # resampled to the corpus rate


def test_get_sources(tmp_path, monkeypatch):
    monkeypatch.delenv("AZOOM_DATA_DIR", raising=False)
    out = get_sources(2, 4_000, seed=3, device="cpu")
    assert out.shape == (2, 4_000) and out.dtype == np.float32 and np.isfinite(out).all()
    np.testing.assert_array_equal(out, speech_like_batch(torch.Generator().manual_seed(3), 2,
                                                         4_000, device="cpu").numpy())
    assert not np.array_equal(out, get_sources(2, 4_000, seed=4, device="cpu"))
    write_wav(tmp_path / "x.wav", np.random.default_rng(1).standard_normal(9_000) * 0.1, FS)
    monkeypatch.setenv("AZOOM_DATA_DIR", str(tmp_path))
    crops = get_sources(3, 2_000, seed=7)  # the corpus: no device needed
    np.testing.assert_array_equal(crops, LocalCorpus(tmp_path).sample_batch(
        np.random.default_rng(7), 3, 2_000))


# -- NativeCorpus ----------------------------------------------------------------


class _XorShift64Star:
    """cpp/corpus_engine.cpp's Rng."""

    M = (1 << 64) - 1

    def __init__(self, seed):
        self.s = seed if seed else 0x9E3779B97F4A7C15

    def below(self, n):
        s = self.s
        s ^= s >> 12
        s ^= (s << 25) & self.M
        s ^= s >> 27
        self.s = s
        return ((s * 0x2545F4914F6CDD1D) & self.M) % n if n else 0


def _decoded(path):
    audio, fs = read_wav(path)
    assert fs == FS
    return (audio.mean(axis=1) if audio.ndim > 1 else audio).astype(np.float32)


def test_crops_replay_the_engines_stream(tmp_path):
    rng = np.random.default_rng(5)
    _write_wav(tmp_path / "a.wav", 0.5 * np.sin(2 * np.pi * 440 * np.arange(8_000) / FS))
    _write_wav(tmp_path / "b.wav", 0.25 * rng.standard_normal(4_000), fmt="f32")
    _write_wav(tmp_path / "c.wav", 0.1 * rng.standard_normal(2_000), channels=2)
    _write_wav(tmp_path / "short.wav", 0.3 * rng.standard_normal(300))
    files = [_decoded(p) for p in sorted(str(p) for p in tmp_path.rglob("*.wav"))]
    n, batch, seed = 500, 8, 3
    with NativeCorpus(tmp_path, n_signals=batch, n_samples=n, seed=seed) as c:
        assert len(c) == 4 and c.n_dropped == 0
        got = [c.next_batch() for _ in range(3)]
    r = _XorShift64Star(seed)
    for b in got:
        assert b.shape == (batch, n) and b.dtype == np.float32
        for crop in b:
            audio = files[r.below(len(files))]
            if len(audio) >= n:
                start = r.below(len(audio) - n + 1)
                want = audio[start:start + n]
            else:
                start = r.below(len(audio))
                want = audio[(start + np.arange(n)) % len(audio)]
            np.testing.assert_array_equal(crop, want)


def test_scan_decode_and_resample(corpus_dir):
    with NativeCorpus(corpus_dir, n_signals=6, n_samples=1_000, seed=7) as c:
        assert len(c) == 4  # the recursive scan found the nested files
        b = c.next_batch()
        assert b.shape == (6, 1_000) and np.isfinite(b).all() and float(np.abs(b).max()) > 0.0


def test_undecodable_files_are_dropped_not_silenced(tmp_path, capsys):
    _write_wav(tmp_path / "good.wav", 0.5 * np.sin(2 * np.pi * 300 * np.arange(4_000) / FS))
    (tmp_path / "garbage.wav").write_bytes(b"not a riff file at all")
    hdr = b"RIFF" + struct.pack("<I", 36 + 64_000) + b"WAVE"
    hdr += b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, FS, 32_000, 2, 16)
    hdr += b"data" + struct.pack("<I", 64_000)
    (tmp_path / "truncated.wav").write_bytes(hdr)  # no data bytes
    with NativeCorpus(tmp_path, n_signals=4, n_samples=1_000, seed=2) as c:
        assert len(c) == 1 and c.n_dropped == 2
        assert float(np.min(np.max(np.abs(c.next_batch()), axis=1))) > 0.01
    assert "dropped 2 undecodable" in capsys.readouterr().out
    with pytest.raises(FileNotFoundError):
        NativeCorpus(tmp_path / "sub_that_is_not_there", n_signals=1, n_samples=10)


def test_pcm24_and_antialiased_resampling(tmp_path):
    audio = np.clip(0.4 * np.random.default_rng(9).standard_normal(3_000), -1, 1)
    _write_wav24(tmp_path / "x24.wav", audio.astype(np.float32))
    with NativeCorpus(tmp_path, n_signals=2, n_samples=2_000, seed=1) as c:
        crop = c.next_batch()[0]
    w = np.lib.stride_tricks.sliding_window_view(audio.astype(np.float32), 2_000)
    assert bool(np.any(np.all(np.abs(w - crop) < 2e-6, axis=1)))
    hi = tmp_path / "hi"
    hi.mkdir()
    t = np.arange(48_000) / 48_000
    _write_wav(hi / "hi.wav", 0.5 * np.sin(2 * np.pi * 20_000 * t), fs=48_000)
    with NativeCorpus(hi, fs=16_000, n_signals=1, n_samples=8_000, seed=4) as c:
        crop = c.next_batch()[0]
    assert float(np.sqrt(np.mean(crop**2))) < 0.02  # 20 kHz above the new Nyquist


def test_deterministic_stream_and_prefetch(corpus_dir):
    with NativeCorpus(corpus_dir, n_signals=3, n_samples=800, seed=11) as a:
        b1 = [a.next_batch() for _ in range(3)]
    with NativeCorpus(corpus_dir, n_signals=3, n_samples=800, seed=11) as b:
        b2 = [b.next_batch() for _ in range(3)]
    for x, y in zip(b1, b2):
        np.testing.assert_array_equal(x, y)
    with NativeCorpus(corpus_dir, n_signals=3, n_samples=800, seed=12) as c:
        assert not np.array_equal(c.next_batch(), b1[0])
    c = NativeCorpus(corpus_dir, n_signals=4, n_samples=2_000, seed=1, depth=3)
    c.next_batch()
    time.sleep(0.3)  # the worker fills the ring
    t0 = time.perf_counter()
    c.next_batch()
    assert time.perf_counter() - t0 < 0.05
    c.close()
    c.close()  # idempotent
    with pytest.raises(ValueError, match="closed"):
        c.next_batch()


def test_a_failed_corpus_engine_build_raises_with_the_compilers_output(monkeypatch, tmp_path,
                                                                       corpus_dir):
    monkeypatch.setattr(corpus_native, "_lib", None)
    monkeypatch.setattr(corpus_native, "_error", None)
    monkeypatch.setattr(corpus_native, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match=r"building the corpus engine failed \(rc 1\)"):
        NativeCorpus(corpus_dir, n_signals=1, n_samples=100)
    assert list(tmp_path.iterdir()) == []
    assert not corpus_native.native_available()
