"""Parity of the PyTorch port's config, STFT, steering vectors and physics
features with the JAX package (CPU, plain paths).

Inputs are made with numpy from a seed and handed to both packages.
Tolerances: STFT/iSTFT atol 1e-5 (both are float32 transforms of O(0.1)
signals; the port takes its forward FFT in float64, JAX in float32), steering
vectors atol 1e-5 (float32 phases of at most ~6 rad), features atol 1e-5 and
rtol 1e-5 on the log-magnitude channel (log of magnitudes down to 1e-7).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from azoom.config import PipelineConfig as JaxConfig
from azoom.dsp.delays import steering_vector as jax_steering
from azoom.dsp.stft import istft as jax_istft
from azoom.dsp.stft import stft as jax_stft
from azoom.masks.features import physics_aware_features as jax_features
from azoom_torch.config import PipelineConfig
from azoom_torch.dsp.delays import steering_vector
from azoom_torch.dsp.stft import istft, rfft_freqs, stft, stft_frame_count
from azoom_torch.masks.features import physics_aware_features


def _signal(n, seed=0, shape=(2,)):
    return (np.random.default_rng(seed).standard_normal(shape + (n,)) * 0.1).astype(np.float32)


def test_config_defaults_match():
    jf = {f.name: f.default for f in dataclasses.fields(JaxConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(PipelineConfig)}
    assert tf == jf
    j, t = JaxConfig(), PipelineConfig()
    assert (t.n_freqs, t.frames_per_chunk) == (j.n_freqs, j.frames_per_chunk)
    assert t.frames_per_chunk == stft_frame_count(t.win_size, t.n_fft, t.hop)


def test_config_geometry_and_input():
    pos = [(-0.015, -0.01), (0.015, -0.01), (-0.015, 0.01), (0.015, 0.01)]
    t = PipelineConfig().with_geometry(pos)
    j = JaxConfig().with_geometry(pos)
    assert t.mic_positions == j.mic_positions and t.n_mics == j.n_mics == 4
    g = t.geometry()
    assert g.dtype == torch.float32
    np.testing.assert_array_equal(g.numpy(), np.asarray(j.geometry()))
    assert PipelineConfig().geometry() is None
    assert PipelineConfig().for_input(np.zeros((3, 100))).n_mics == 3
    with pytest.raises(ValueError, match="channels"):
        t.for_input(np.zeros((2, 100)))


@pytest.mark.parametrize("n,n_fft,hop", [(16000, 1024, 512), (16123, 1024, 512), (8000, 512, 256),
                                         (8000, 400, 160)])
def test_stft_istft_match_jax(n, n_fft, hop):
    x = _signal(n, seed=n)
    Yt = stft(torch.from_numpy(x), n_fft, hop)
    Yj = np.asarray(jax_stft(jnp.asarray(x), n_fft, hop))
    assert Yt.dtype == torch.complex64 and Yt.shape == Yj.shape
    assert Yt.shape[-1] == stft_frame_count(n, n_fft, hop)
    np.testing.assert_allclose(Yt.numpy(), Yj, atol=1e-5)

    xt = istft(Yt, n_fft, hop, length=n)
    xj = np.asarray(jax_istft(jnp.asarray(Yj), n_fft, hop, length=n))
    np.testing.assert_allclose(xt.numpy(), xj, atol=1e-5)
    assert float(np.max(np.abs(xt.numpy() - x))) < 1e-5  # round trip


def test_istft_pads_to_length_and_checks_precision():
    x = _signal(4000)
    Y = stft(torch.from_numpy(x))
    assert istft(Y, length=5000).shape[-1] == 5000
    with pytest.raises(ValueError, match="precision"):
        stft(torch.from_numpy(x), precision="bf16")
    with pytest.raises(ValueError, match="precision"):
        istft(Y, precision="bf16")


@pytest.mark.parametrize("angle", [90.0, 60.0])
@pytest.mark.parametrize("positions", [None, [(-0.02, 0.0), (0.02, 0.005)]])
@pytest.mark.parametrize("normalize", [False, True])
def test_steering_vector_matches_jax(angle, positions, normalize):
    cfg = PipelineConfig(mic_dist=0.04)
    freqs = rfft_freqs(cfg.n_fft, cfg.fs)
    pos_t = None if positions is None else torch.tensor(positions, dtype=torch.float32)
    pos_j = None if positions is None else jnp.asarray(positions, jnp.float32)
    dt = steering_vector(freqs, angle, cfg.mic_dist, normalize_phase=normalize, positions=pos_t)
    dj = jax_steering(jnp.asarray(freqs.numpy()), angle, cfg.mic_dist,
                      normalize_phase=normalize, positions=pos_j)
    assert dt.dtype == torch.complex64 and dt.shape == (cfg.n_freqs, 2)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), atol=1e-5)


@pytest.mark.parametrize("ipd_scale", [1.0, 4.0])
@pytest.mark.parametrize("pair_mode", ["mean", "first"])
def test_physics_features_match_jax(ipd_scale, pair_mode):
    Y = np.array(jax_stft(jnp.asarray(_signal(16000, seed=3))))
    ft = physics_aware_features(torch.from_numpy(Y), ipd_scale, pair_mode).numpy()
    fj = np.asarray(jax_features(jnp.asarray(Y), ipd_scale, pair_mode))
    assert ft.shape == fj.shape == Y.shape[1:] + (4,) and ft.dtype == np.float32
    np.testing.assert_allclose(ft[..., 0], fj[..., 0], rtol=1e-5)
    np.testing.assert_allclose(ft[..., 1:], fj[..., 1:], atol=1e-5)


def test_features_reject_unknown_pair_mode():
    Y = stft(torch.from_numpy(_signal(4000)))
    with pytest.raises(ValueError, match="pair_mode"):
        physics_aware_features(Y, pair_mode="all")
