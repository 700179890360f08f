"""Parity of the port's masked MVDR (the plain version of the fused CUDA MVDR
kernel) with azoom.beam.mvdr.masked_mvdr and with the Pallas kernel run in
interpret mode (CPU).

Tolerances are those of tests/test_pallas_mvdr.py: rtol 1e-3 / atol 2e-4 on
a single block, atol 5e-4 on the batched post-filtered output (float32
covariance sums over T taken in different orders, then a 2x2 solve).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from azoom.beam.covariance import masked_covariance as jax_covariance
from azoom.beam.linalg2x2 import solve_2x2_hermitian as jax_solve
from azoom.beam.mvdr import masked_mvdr as jax_masked_mvdr
from azoom.config import PipelineConfig
from azoom.dsp.delays import steering_vector
from azoom.dsp.stft import rfft_freqs, stft
from azoom.masks.oracle import ibm_noise_mask
from azoom.pallas.mvdr_kernel import masked_mvdr_pallas
from azoom.sim.farfield import make_scene
from azoom.sim.signals import speech_like_batch
from azoom_torch import kernels
from azoom_torch.beam.covariance import masked_covariance
from azoom_torch.beam.linalg2x2 import solve_2x2_hermitian
from azoom_torch.beam.mvdr import masked_mvdr, mvdr_weights
from azoom_torch.kernels.mvdr_kernel import masked_mvdr_fused

CFG = PipelineConfig(mic_dist=0.04)


def _scene(key=7, n=32_000):
    sigs = speech_like_batch(jax.random.PRNGKey(key), 3, n, CFG.fs)
    sc = make_scene(sigs[0], sigs[1:], 90.0, jnp.array([40.0, 130.0]), CFG.mic_dist, CFG.fs)
    Y = stft(sc["mixture"], CFG.n_fft, CFG.hop)
    mask = ibm_noise_mask(stft(sc["target_ref"], CFG.n_fft, CFG.hop),
                          stft(sc["interference_ref"], CFG.n_fft, CFG.hop))
    return np.asarray(Y), np.asarray(mask, np.float32)


def _steer():
    freqs = rfft_freqs(CFG.n_fft, CFG.fs)
    return np.asarray(freqs), np.asarray(steering_vector(freqs, 90.0, CFG.mic_dist))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_masked_mvdr_matches_jax_and_pallas():
    Y, mask = _scene()
    freqs, d = _steer()
    got = masked_mvdr(_t(Y), _t(mask), _t(d), _t(freqs), sigma=1e-7).numpy()
    for ref in (
        jax_masked_mvdr(Y, mask, d, freqs, sigma=1e-7),
        masked_mvdr_pallas(Y, mask, d, freqs, sigma=1e-7, interpret=True),
    ):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.real, ref.real, rtol=1e-3, atol=2e-4)
        np.testing.assert_allclose(got.imag, ref.imag, rtol=1e-3, atol=2e-4)


@pytest.mark.parametrize("per_bin_sigma", [False, True])
def test_batched_postfilter_matches(per_bin_sigma):
    Y, mask = _scene(11, 16_000)
    freqs, d = _steer()
    Yb, mb = np.stack([Y, Y]), np.stack([mask, 0.5 * mask])
    tm = 1.0 - mb
    sigma = (1e-6 * (1.0 + np.arange(len(freqs)) / len(freqs))).astype(np.float32) \
        if per_bin_sigma else 1e-6
    sig_t = _t(sigma) if per_bin_sigma else sigma
    got = masked_mvdr(_t(Yb), _t(mb), _t(d), _t(freqs), target_mask=_t(tm),
                      mask_floor=0.05, sigma=sig_t).numpy()
    refs = [masked_mvdr_pallas(Yb, mb, d, freqs, target_mask=tm, mask_floor=0.05,
                               sigma=jnp.asarray(sigma), interpret=True)]
    if not per_bin_sigma:  # the XLA path takes only a scalar loading
        refs.append(jax_masked_mvdr(Yb, mb, d, freqs, target_mask=tm, mask_floor=0.05,
                                    sigma=sigma))
    for ref in refs:
        assert got.shape == np.asarray(ref).shape == Yb.shape[:1] + Y.shape[1:]
        np.testing.assert_allclose(np.abs(got - np.asarray(ref)).max(), 0.0, atol=5e-4)


def test_fused_wrapper_on_cpu_is_the_plain_version():
    Y, mask = _scene(5, 8_000)
    freqs, d = _steer()
    before = dict(kernels.launches)
    args = (_t(Y[None]), _t(mask[None]), _t(d), _t(freqs))
    kw = dict(target_mask=_t(1.0 - mask[None]), sigma=1e-7, mask_floor=0.05)
    got = masked_mvdr_fused(*args, **kw)
    np.testing.assert_array_equal(got.numpy(), masked_mvdr(*args, **kw).numpy())
    assert kernels.launches == before


def test_covariance_and_solve_match_jax():
    Y, mask = _scene(5, 8_000)
    R = masked_covariance(_t(Y), _t(mask))
    Rj = np.asarray(jax_covariance(Y, mask))
    np.testing.assert_allclose(R.numpy(), Rj, rtol=1e-4, atol=1e-9)
    _, d = _steer()
    R = R + 1e-7 * torch.eye(2)
    x = solve_2x2_hermitian(R, _t(d))
    np.testing.assert_allclose(x.numpy(), np.asarray(jax_solve(jnp.asarray(R.numpy()), d)),
                               rtol=1e-3, atol=1e-3)


def test_more_than_two_mics_is_queued():
    R = torch.eye(3, dtype=torch.complex64).expand(5, 3, 3)
    with pytest.raises(NotImplementedError, match="linalgmm"):
        mvdr_weights(R, torch.ones(5, 3, dtype=torch.complex64))
