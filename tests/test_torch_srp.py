"""Parity of the port's localization and zoom control surface with the JAX
package (CPU): dsp.delays.steering_matrix, beam.zoom, localize.srp and
masks.geometric.ipd_deviation_noise_mask.

Tolerances: steering vectors atol 1e-5 (float32 phases; the port rounds a
float64 phase once). DOA maps (SRP, GCC-PHAT, the IPD angle histogram)
rtol 1e-4 elementwise with equal argmax: the port takes angles and weights
in float64 and sums the votes in blocks and in another order; a map entry
below 1e-6 of its maximum, where float32 votes underflow, is held to an
absolute 1e-6 of the maximum. The IPD-deviation mask atol 1e-5 (a float32
phase against a float64 one, scaled by 1 / (width pi)).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from azoom.beam.zoom import beam_pattern as jax_beam_pattern
from azoom.beam.zoom import beamwidth_3db as jax_beamwidth
from azoom.beam.zoom import sigma_vs_beamwidth as jax_sigma_vs_beamwidth
from azoom.beam.zoom import zoom_to_sigma as jax_zoom_to_sigma
from azoom.dsp.delays import far_field_delays as jax_delays
from azoom.dsp.delays import steering_matrix as jax_steering_matrix
from azoom.dsp.stft import rfft_freqs as jax_freqs
from azoom.dsp.stft import stft as jax_stft
from azoom.localize import srp as jsrp
from azoom.masks.geometric import ipd_deviation_noise_mask as jax_ipd_dev
from azoom.sim.farfield import make_scene
from azoom.sim.signals import speech_like_batch
from azoom_torch.beam.zoom import beam_pattern, beamwidth_3db, sigma_vs_beamwidth, zoom_to_sigma
from azoom_torch.dsp.delays import steering_matrix
from azoom_torch.dsp.stft import rfft_freqs
from azoom_torch.localize import srp
from azoom_torch.masks.geometric import ipd_deviation_noise_mask

RECT = ((-0.015, -0.01), (0.015, -0.01), (-0.015, 0.01), (0.015, 0.01))


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def scenes():
    """Three 1 s two-mic scenes at 4 cm (targets 60, 90, 125 deg) as one
    (3, 2, F, T) STFT."""
    Ys = []
    for k, (tgt, itf) in enumerate([(60.0, [110.0, 20.0]), (90.0, [40.0, 130.0]),
                                    (125.0, [70.0])]):
        sigs = speech_like_batch(jax.random.PRNGKey(50 + k), 1 + len(itf), 16000, 16000)
        sc = make_scene(sigs[0], sigs[1:], tgt, jnp.asarray(itf), 0.04, 16000)
        Ys.append(np.asarray(jax_stft(sc["mixture"])))
    return np.stack(Ys)


def _close_map(got, ref):
    """rtol 1e-4 where the map is above 1e-6 of its maximum, atol 1e-6 of
    the maximum below; the same argmax."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    floor = 1e-6 * np.abs(ref).max(axis=-1, keepdims=True)
    big = np.abs(ref) > floor
    np.testing.assert_allclose(got[big], ref[big], rtol=1e-4)
    assert np.all(np.abs(got - ref)[~big] <= np.broadcast_to(floor, ref.shape)[~big])
    np.testing.assert_array_equal(np.argmax(got, -1), np.argmax(ref, -1))


@pytest.mark.parametrize("positions", [None, RECT])
def test_steering_matrix_matches_jax(positions):
    f = jax_freqs(1024, 16000)
    angles = np.linspace(0.0, 180.0, 37, dtype=np.float32)
    m = 2 if positions is None else 4
    ref = jax_steering_matrix(f, angles, 0.04, 343.0, m,
                              positions=None if positions is None else jnp.asarray(positions))
    got = steering_matrix(rfft_freqs(1024, 16000), angles, 0.04, 343.0, m,
                          positions=None if positions is None else torch.tensor(positions))
    assert got.shape == (37, 513, m) and got.dtype == torch.complex64
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("zoom", [0.0, 0.1, 0.3, 0.5, 0.8, 1.0, -0.5, 1.5])
def test_zoom_to_sigma_matches_jax(zoom):
    """rtol 1e-5: both compute in float32, and the reference's power (XLA on
    the CPU) is off by up to ~1e-6 relative (at zoom 0.5: 3.1622742e-06 for
    10^-5.5 = 3.16227766e-06; the port gives 3.1622776e-06)."""
    got = zoom_to_sigma(zoom)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(jax_zoom_to_sigma(zoom)), rtol=1e-5)


def test_beam_pattern_and_width_match_jax():
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((3, 513, 2)) + 1j * rng.standard_normal((3, 513, 2))).astype(np.complex64)
    f = np.asarray(jax_freqs(1024, 16000))
    angles = np.arange(0.0, 180.5, 1.0, dtype=np.float32)
    ref = np.asarray(jax_beam_pattern(w, f, angles, 0.04))
    got = beam_pattern(_t(w), _t(f), angles, 0.04).numpy()
    assert got.shape == (3, 181, 513)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-6 * ref.max())
    broadband = ref.mean(axis=-1)
    for tgt in (30.0, 90.0, 140.0):
        np.testing.assert_array_equal(beamwidth_3db(_t(broadband), angles, tgt).numpy(),
                                      np.asarray(jax_beamwidth(broadband, angles, tgt)))


def test_sigma_vs_beamwidth_matches_jax(scenes):
    Y = scenes[1]
    f = np.asarray(jax_freqs(1024, 16000))
    R = np.einsum("mft,nft->fmn", Y, np.conj(Y)) / Y.shape[-1]
    R = R.astype(np.complex64)
    d = np.asarray(jax_steering_matrix(f, np.float32(90.0), 0.04))
    sigmas = np.array([1e-9, 1e-6, 1e-4, 1e-2], np.float32)
    _, ref = jax_sigma_vs_beamwidth(R, d, f, sigmas, 0.04)
    _, got = sigma_vs_beamwidth(_t(R), _t(d), _t(f), sigmas, 0.04)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_ipd_angle_histogram_matches_jax(scenes):
    a_ref, h_ref = jsrp.ipd_angle_histogram(scenes, 0.04, 16000)
    a, h = srp.ipd_angle_histogram(_t(scenes), 0.04, 16000)
    np.testing.assert_array_equal(a.numpy(), np.asarray(a_ref))
    assert h.shape == (3, 181) and h.dtype == torch.float32
    _close_map(h.numpy(), h_ref)
    # unbatched, and another spacing, band and kernel
    kw = dict(band_hz=(300.0, 3000.0), kernel_deg=3.0)
    _close_map(srp.ipd_angle_histogram(_t(scenes[0]), 0.08, 16000, **kw)[1].numpy(),
               jsrp.ipd_angle_histogram(scenes[0], 0.08, 16000, **kw)[1])


def test_ipd_angle_histogram_blocks_sum_alike(scenes, monkeypatch):
    """One bin per block and all bins in one block give the same histogram
    up to the float32 order of the sums."""
    _, whole = srp.ipd_angle_histogram(_t(scenes), 0.04, 16000)
    monkeypatch.setattr(srp, "_VOTE_BLOCK", 1)
    _, one_bin = srp.ipd_angle_histogram(_t(scenes), 0.04, 16000)
    np.testing.assert_allclose(one_bin.numpy(), whole.numpy(), rtol=1e-5)


def test_ipd_histogram_with_no_bins_in_band_is_zero(scenes):
    _, h = srp.ipd_angle_histogram(_t(scenes), 0.04, 16000, band_hz=(9000.0, 9500.0))
    assert torch.equal(h, torch.zeros(3, 181))


@pytest.mark.parametrize("phat", [False, True])
def test_srp_map_matches_jax(scenes, phat):
    f = np.asarray(jax_freqs(1024, 16000))
    a_ref, p_ref = jsrp.srp_map(scenes, f, 0.04, phat=phat)
    a, p = srp.srp_map(_t(scenes), _t(f), 0.04, phat=phat)
    np.testing.assert_array_equal(a.numpy(), np.asarray(a_ref))
    _close_map(p.numpy(), p_ref)
    np.testing.assert_array_equal(srp.srp_localize(_t(scenes), _t(f), 0.04, phat=phat).numpy(),
                                  np.asarray(jsrp.srp_localize(scenes, f, 0.04, phat=phat)))


def test_srp_map_on_an_explicit_geometry_matches_jax():
    sigs = speech_like_batch(jax.random.PRNGKey(3), 2, 16000, 16000)
    pos = jnp.asarray(RECT, jnp.float32)
    sc = make_scene(sigs[0], sigs[1:], 70.0, jnp.asarray([130.0]), 0.0, 16000, n_mics=4,
                    positions=pos)
    Y = np.asarray(jax_stft(sc["mixture"]))
    f = np.asarray(jax_freqs(1024, 16000))
    _, p_ref = jsrp.srp_map(Y, f, 0.04, phat=True, positions=pos)
    _, p = srp.srp_map(_t(Y), _t(f), 0.04, phat=True, positions=torch.tensor(RECT))
    _close_map(p.numpy(), p_ref)


def test_gcc_phat_matches_jax(scenes):
    a_ref, g_ref = jsrp.gcc_phat_map(scenes, 0.04, 16000)
    _, g = srp.gcc_phat_map(_t(scenes), 0.04, 16000)
    g_ref = np.asarray(g_ref)
    np.testing.assert_allclose(g.numpy(), g_ref, rtol=1e-4, atol=1e-5 * np.abs(g_ref).max())
    np.testing.assert_array_equal(np.argmax(g.numpy(), -1), np.argmax(g_ref, -1))


@pytest.mark.parametrize("fov", [(None, 180.0), (60.0, 40.0), (125.0, 30.0)])
def test_localizers_match_jax(scenes, fov):
    center, width = fov
    kw = dict(fov_center_deg=center, fov_width_deg=width)
    np.testing.assert_array_equal(
        srp.ipd_histogram_localize(_t(scenes), 0.04, 16000, **kw).numpy(),
        np.asarray(jsrp.ipd_histogram_localize(scenes, 0.04, 16000, **kw)))
    np.testing.assert_array_equal(
        srp.gcc_phat_localize(_t(scenes), 0.04, 16000, **kw).numpy(),
        np.asarray(jsrp.gcc_phat_localize(scenes, 0.04, 16000, **kw)))


@pytest.mark.parametrize("theta,width", [(90.0, 0.5), (60.0, 0.5), (125.0, 0.25)])
def test_ipd_deviation_noise_mask_matches_jax(scenes, theta, width):
    f = np.asarray(jax_freqs(1024, 16000))
    tau = np.asarray(jax_delays(np.float32(theta), 0.04))
    expected = (-2.0 * np.pi * f * (tau[0] - tau[1])).astype(np.float32)
    ref = np.asarray(jax_ipd_dev(scenes, expected, width=width))
    got = ipd_deviation_noise_mask(_t(scenes), _t(expected), width=width)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)


def test_ipd_deviation_noise_mask_first_pair_matches_jax():
    rng = np.random.default_rng(8)
    Y = (rng.standard_normal((4, 513, 20)) + 1j * rng.standard_normal((4, 513, 20))).astype(np.complex64)
    expected = rng.uniform(-3, 3, 513).astype(np.float32)
    for mode in ("mean", "first"):
        ref = np.asarray(jax_ipd_dev(Y, expected, pair_mode=mode))
        got = ipd_deviation_noise_mask(_t(Y), _t(expected), pair_mode=mode).numpy()
        np.testing.assert_allclose(got, ref, atol=1e-5)
