"""The port's C++ stream engine binding (azoom_torch.stream.native) and the
facade's push on it, on the CPU, against azoom.stream.native and
azoom.AudioZoom.

The port builds cpp/stream_engine.cpp with the reference's compiler and
flags into azoom_torch/_build/, so on the deterministic stub enhancer of
tests/test_native_stream.py its output equals the reference engine's bit for
bit at every block pattern. Against the NumPy overlap-add (the facade's
native=False buffer) it is held to 1e-6, the reference's own bound: the
engine computes its Hann window in double and its multiply-add may contract
to an FMA, so the two differ by float32 roundings (measured 2.4e-7 through
the facade).

The learned case pushes a 4 s clip (three 2 s windows) through
AudioZoom(model="tpufpu_nano", int8=True) on both sides, both on their C++
engines, at the facade's waveform bound 2e-2 and SIR within 0.1 dB (ROADMAP.md
Queue C, "Server and facade": the reference's jitted learned path is 1.6e-2
from its own stages).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import azoom
from azoom.config import PipelineConfig as JaxConfig
from azoom.eval.projection import osinr_osir
from azoom.sim.farfield import make_scene
from azoom.sim.signals import speech_like_batch
from azoom.stream.native import NativeStream as RefStream
from azoom_torch import AudioZoom, PipelineConfig
from azoom_torch.stream import native
from azoom_torch.stream.native import NativeStream

WIN = 2_048
HOP = WIN // 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU work in one thread while this file runs (the suite's
    other workers share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _hann(win):
    return np.hanning(win + 1)[:-1].astype(np.float32)


def _numpy_reference(mixture, enhance, win=WIN):
    """The NumPy push-path semantics (the facade's native=False buffer)."""
    hop = win // 2
    w = _hann(win)
    norm = np.maximum(w[:hop] + w[hop:], 1e-6)
    out, tail, started = [], np.zeros(hop, np.float32), False
    for start in range(0, mixture.shape[1] - win + 1, hop):
        weighted = enhance(mixture[:, start:start + win]) * w
        if started:
            out.append((tail + weighted[:hop]) / norm)
        tail = weighted[hop:]
        started = True
    return np.concatenate(out) if out else np.zeros(0, np.float32)


def _drive(stream, mixture, enhance, block_sizes):
    out, pos, i = [], 0, 0
    n = mixture.shape[1]
    while pos < n:
        k = min(block_sizes[i % len(block_sizes)], n - pos)
        i += 1
        stream.push(mixture[:, pos:pos + k])
        pos += k
        for window in stream.windows():
            done = stream.commit(enhance(window))
            if done.size:
                out.append(done)
    return np.concatenate(out) if out else np.zeros(0, np.float32)


def _stub(w):
    return (w[0] - 0.25 * w[1]).astype(np.float32)


def test_library_is_built_into_the_ports_build_directory():
    assert native.native_available()
    path = native.library_path()
    assert path.parent == native.BUILD_DIR and path.name.startswith("libstream-")
    assert path.exists() and native.CXX_FLAGS == (
        "-O3", "-march=native", "-fPIC", "-Wall", "-Wextra", "-shared")


@pytest.mark.parametrize("blocks", [[160], [1, 7, 64, 1024, 3], [WIN], [5 * WIN]])
def test_engine_matches_the_reference_engine_and_numpy(blocks):
    rng = np.random.default_rng(0)
    mixture = rng.standard_normal((2, 11 * HOP + 123)).astype(np.float32)
    got = _drive(NativeStream(2, WIN), mixture, _stub, blocks)
    ref = _drive(RefStream(2, WIN), mixture, _stub, blocks)
    np.testing.assert_array_equal(got, ref)
    plain = _numpy_reference(mixture, _stub)
    assert got.shape == plain.shape
    np.testing.assert_allclose(got, plain, rtol=0, atol=1e-6)


def test_unit_gain_passthrough():
    rng = np.random.default_rng(1)
    mixture = rng.standard_normal((2, 8 * WIN)).astype(np.float32)
    got = _drive(NativeStream(2, WIN), mixture, lambda w: w[0], [997])
    # Output sample i is input sample i + hop (the one-hop latency).
    assert got.size > 4 * WIN
    np.testing.assert_allclose(got, mixture[0, HOP:HOP + got.size], rtol=0, atol=1e-5)


def test_reset_and_transactional_peek():
    rng = np.random.default_rng(2)
    s = NativeStream(2, WIN)
    s.push(rng.standard_normal((2, 3 * WIN)).astype(np.float32))
    assert s.windows_ready() > 0
    s.reset()
    assert s.windows_ready() == 0
    mixture = rng.standard_normal((2, WIN)).astype(np.float32)
    s.push(mixture)
    first = next(iter(s.windows())).copy()
    np.testing.assert_array_equal(next(iter(s.windows())), first)  # peeked, not consumed
    assert s.commit(first[0]).size == 0  # the first commit after reset warms up
    with pytest.raises(RuntimeError):
        s.commit(np.zeros(WIN, np.float32))  # no pending window


def test_geometry_and_shape_errors():
    with pytest.raises(ValueError):
        NativeStream(2, 2_047)  # win must be 2 * hop
    s = NativeStream(2, WIN)
    with pytest.raises(ValueError):
        s.push(np.zeros((3, 100), np.float32))
    with pytest.raises(ValueError):
        s.commit(np.zeros(WIN - 1, np.float32))


def test_a_failed_build_raises_with_the_compilers_output(monkeypatch, tmp_path):
    """No silent fallback: when the compiler fails, the engine, and so the
    facade's default native=True, raise with its exit code and output;
    native=False still buffers."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("CXX", "false")  # a compiler that fails
    with pytest.raises(RuntimeError, match=r"building the stream engine failed \(rc 1\)"):
        NativeStream(2, WIN)
    assert list(tmp_path.iterdir()) == []  # no half-written library left
    assert not native.native_available()
    with pytest.raises(RuntimeError, match="stream engine"):
        AudioZoom(enhance_fn=lambda w: w[0], device="cpu")
    assert AudioZoom(enhance_fn=lambda w: w[0], native=False, device="cpu")._native is None


def _push_all(z, mixture, block):
    return np.concatenate([z.push(mixture[:, s:s + block])
                           for s in range(0, mixture.shape[1], block)])


def test_facade_native_matches_numpy_buffer():
    cfg = PipelineConfig(mic_dist=0.04)
    rng = np.random.default_rng(3)
    mixture = rng.standard_normal((2, 3 * cfg.win_size)).astype(np.float32)

    def enhance(w):
        return w[0] * 0.5

    z_native = AudioZoom(cfg=cfg, enhance_fn=enhance, device="cpu")
    z_numpy = AudioZoom(cfg=cfg, enhance_fn=enhance, native=False, device="cpu")
    assert isinstance(z_native._native, NativeStream) and z_numpy._native is None
    got, ref = _push_all(z_native, mixture, 1_600), _push_all(z_numpy, mixture, 1_600)
    assert got.shape == ref.shape == (2 * cfg.win_size,)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    z_native.reset()  # the engine starts over: the same stream again
    np.testing.assert_array_equal(_push_all(z_native, mixture, 1_600), got)


def test_pipelined_pins_the_numpy_buffer():
    z = AudioZoom(enhance_fn=lambda w: w[0], pipelined=True, device="cpu")
    assert z._native is None


@pytest.mark.parametrize("fail_on", [2, 4])
def test_a_failing_enhancer_loses_no_audio(fail_on):
    """fail_on=4 fails a later window of a multi-window push: the hops that
    the earlier windows of that push finished come back with the retry."""
    cfg = PipelineConfig(mic_dist=0.04)
    rng = np.random.default_rng(7)
    mixture = rng.standard_normal((2, 4 * cfg.win_size)).astype(np.float32)
    block = 2 * cfg.win_size
    calls = {"n": 0}

    def flaky(w):
        calls["n"] += 1
        if calls["n"] == fail_on:
            raise RuntimeError("transient device error")
        return w[0] * 0.5

    z = AudioZoom(cfg=cfg, enhance_fn=flaky, device="cpu")
    assert z._native is not None
    parts = []
    for start in range(0, mixture.shape[1], block):
        try:
            parts.append(z.push(mixture[:, start:start + block]))
        except RuntimeError:
            parts.append(z.push(np.zeros((2, 0), np.float32)))  # retry
    got = np.concatenate(parts)
    ref = _push_all(AudioZoom(cfg=cfg, enhance_fn=lambda w: w[0] * 0.5, device="cpu"),
                    mixture, block)
    np.testing.assert_array_equal(got, ref)


def test_learned_push_matches_the_reference_facade():
    sigs = speech_like_batch(jax.random.PRNGKey(17), 3, 4 * 16000, 16000)
    sc = {k: np.asarray(v) for k, v in make_scene(
        sigs[0], sigs[1:], 60.0, jnp.asarray([20.0, 130.0]), 0.04, 16000).items()}
    kw = dict(direction_deg=70.0, fov_deg=60.0, zoom=0.4, model="tpufpu_nano", int8=True)
    ref_z = azoom.AudioZoom(cfg=JaxConfig(mic_dist=0.04), **kw)
    got_z = AudioZoom(cfg=PipelineConfig(mic_dist=0.04), device="cpu", **kw)
    assert ref_z._native is not None and got_z._native is not None
    ref = _push_all(ref_z, sc["mixture"], 16_000)
    got = _push_all(got_z, sc["mixture"], 16_000)
    assert got.dtype == np.float32 and got.shape == ref.shape == (2 * 16000,)
    rel = float(np.linalg.norm(got - ref) / np.linalg.norm(ref))
    seg = slice(16000, 16000 + got.shape[-1])  # output sample 0 is input sample hop
    t, i = jnp.asarray(sc["target_ref"][seg]), jnp.asarray(sc["interference_ref"][seg])
    d_sir = float(osinr_osir(jnp.asarray(got), t, i)[1] - osinr_osir(jnp.asarray(ref), t, i)[1])
    print(f"[parity] learned native push wave_rel_l2={rel:.3e} dsir_db={d_sir:+.4f}")
    assert rel <= 2e-2 and abs(d_sir) <= 0.1
