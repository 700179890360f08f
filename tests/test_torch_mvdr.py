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


# -- per-stream steering and loading (the server's form) ---------------------

def _streams(n=16_000):
    """Three scenes, each steered and zoomed its own way: (Y, noise mask, d,
    sigma) with d (3, F, 2) and sigma (3,)."""
    from azoom.beam.zoom import zoom_to_sigma

    Ys, ms, ds = [], [], []
    freqs = rfft_freqs(CFG.n_fft, CFG.fs)
    for k, steer in enumerate((60.0, 90.0, 125.0)):
        sigs = speech_like_batch(jax.random.PRNGKey(20 + k), 2, n, CFG.fs)
        sc = make_scene(sigs[0], sigs[1:], steer, jnp.array([steer - 45.0]), CFG.mic_dist, CFG.fs)
        Ys.append(np.asarray(stft(sc["mixture"], CFG.n_fft, CFG.hop)))
        ms.append(np.asarray(ibm_noise_mask(stft(sc["target_ref"], CFG.n_fft, CFG.hop),
                                            stft(sc["interference_ref"], CFG.n_fft, CFG.hop)),
                             np.float32))
        ds.append(np.asarray(steering_vector(freqs, jnp.float32(steer), CFG.mic_dist)))
    sigma = np.array([float(zoom_to_sigma(z)) for z in (0.2, 0.5, 0.9)], np.float32)
    return np.stack(Ys), np.stack(ms), np.stack(ds), sigma, np.asarray(freqs)


def test_per_stream_steering_and_loading_match_vmapped_pallas():
    """Per-stream d (S, F, 2) and sigma (S,) in the plain B1 against the
    reference server's form, jax.vmap of the Pallas kernel (interpret mode)
    over streams; rtol 1e-3 / atol 2e-4, as test_pallas_mvdr.py."""
    Y, m, d, sigma, freqs = _streams()
    tm = 1.0 - m

    def one(y, nm, t, dd, sg):
        return masked_mvdr_pallas(y, nm, dd, freqs, target_mask=t, mask_floor=0.05, sigma=sg,
                                  interpret=True)

    ref = np.asarray(jax.vmap(one)(Y, m, tm, d, sigma))
    got = masked_mvdr(_t(Y), _t(m), _t(d), _t(freqs), target_mask=_t(tm), mask_floor=0.05,
                      sigma=_t(sigma)).numpy()
    assert got.shape == ref.shape == (3, 513, Y.shape[-1])
    np.testing.assert_allclose(got.real, ref.real, rtol=1e-3, atol=2e-4)
    np.testing.assert_allclose(got.imag, ref.imag, rtol=1e-3, atol=2e-4)
    # each stream alone, with its own d and scalar sigma, is the same function
    for s in range(3):
        alone = masked_mvdr(_t(Y[s]), _t(m[s]), _t(d[s]), _t(freqs), target_mask=_t(tm[s]),
                            mask_floor=0.05, sigma=float(sigma[s])).numpy()
        np.testing.assert_allclose(got[s], alone, rtol=1e-6, atol=1e-9)


def test_per_stream_and_per_bin_loading_broadcast_alike():
    """sigma (S,) equals sigma (S, F) with each row constant; (F,) equals
    (S, F) with every row that vector."""
    Y, m, d, sigma, freqs = _streams(8_000)
    F = len(freqs)
    base = dict(target_mask=_t(1.0 - m), mask_floor=0.05)
    a = masked_mvdr(_t(Y), _t(m), _t(d), _t(freqs), sigma=_t(sigma), **base)
    b = masked_mvdr(_t(Y), _t(m), _t(d), _t(freqs),
                    sigma=_t(np.repeat(sigma[:, None], F, axis=1)), **base)
    assert torch.equal(a, b)
    per_bin = (1e-6 * (1.0 + np.arange(F) / F)).astype(np.float32)
    c = masked_mvdr(_t(Y), _t(m), _t(d), _t(freqs), sigma=_t(per_bin), **base)
    e = masked_mvdr(_t(Y), _t(m), _t(d), _t(freqs), sigma=_t(np.tile(per_bin, (3, 1))), **base)
    assert torch.equal(c, e)


@pytest.mark.parametrize("shape,lead,expect", [
    ((), (3,), (0, 0)), ((513,), (3,), (0, 1)), ((3,), (3,), (1, 0)), ((3, 513), (3,), (513, 1)),
    ((2, 3), (2, 3), (1, 0)), ((2, 3, 513), (2, 3), (513, 1)), ((513, 1), (513,), (1, 0)),
    ((3, 1), (3,), (1, 0)), ((513, 513), (513,), (513, 1))])
def test_loading_strides(shape, lead, expect):
    from azoom_torch.beam.mvdr import loading_strides

    assert loading_strides(shape, lead, 513) == expect


@pytest.mark.parametrize("shape", [(4,), (3, 512), (513, 3)])
def test_loading_strides_refuse_other_shapes(shape):
    from azoom_torch.beam.mvdr import loading_strides

    with pytest.raises(ValueError, match="sigma of shape"):
        loading_strides(shape, (3,), 513)


def test_loading_strides_refuse_a_bin_vector_when_streams_equal_bins():
    """With as many streams as bins, (F,) could mean per bin or per stream."""
    from azoom_torch.beam.mvdr import loading_strides

    with pytest.raises(ValueError, match="ambiguous"):
        loading_strides((513,), (513,), 513)


def test_fused_wrapper_on_cpu_takes_per_stream_inputs():
    Y, m, d, sigma, freqs = _streams(8_000)
    before = dict(kernels.launches)
    args = (_t(Y), _t(m), _t(d), _t(freqs))
    kw = dict(target_mask=_t(1.0 - m), sigma=_t(sigma), mask_floor=0.05)
    np.testing.assert_array_equal(masked_mvdr_fused(*args, **kw).numpy(),
                                  masked_mvdr(*args, **kw).numpy())
    assert kernels.launches == before
