"""Parity of the port's WPE dereverberation (azoom_torch.wpe), DUET masks
(azoom_torch.masks.duet.duet_masks) and floored post-filter
(azoom_torch.masks.postfilter.spectral_floor) with azoom's on the CPU.

Scene: the reference's own reverberant scene (azoom.sim.scene.generate_scene,
reverb=True, 2 s, two interferers, image sources to order 6; the scene of
tests/test_wpd.py), converted to numpy; the STFT is the reference's, so
both sides dereverberate the same spectrum. The reference runs jitted.

Bounds: WPE's output relative L2 <= 1e-3 and wpe_dereverb's waveform
<= 1e-3 (measured ``-s``: 3.4e-4 at the reference's taps 10, delay 3 and
three rounds, 7.4e-6 at taps 4 and one round; the waveform 1.5e-4): the
(C taps)^2 = 20 x 20 solves, loaded by only 1e-6 of their trace, round
differently by LU than by LAPACK's, and each round feeds the next. A
silent bin (R = 0, so no loading) is singular: both sides give non-finite
values in exactly that bin, the port without raising. WPD on the same scene with the oracle mask: relative
L2 <= 1e-3. duet_masks within 1e-5 (the port's bin_doa runs in float64 and
rounds once; the reference's in float32), spectral_floor bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from azoom.beam.wpd import masked_wpd as jax_masked_wpd
from azoom.config import PipelineConfig as JaxConfig
from azoom.dsp.delays import steering_vector as jax_steering_vector
from azoom.dsp.stft import rfft_freqs as jax_rfft_freqs
from azoom.dsp.stft import stft as jax_stft
from azoom.masks.duet import duet_masks as jax_duet_masks
from azoom.masks.oracle import irm_target_mask
from azoom.masks.postfilter import spectral_floor as jax_spectral_floor
from azoom.sim.farfield import make_scene
from azoom.sim.scene import SceneSpec, generate_scene
from azoom.sim.signals import speech_like_batch
from azoom.wpe.dereverb import wpe as jax_wpe
from azoom.wpe.dereverb import wpe_dereverb as jax_wpe_dereverb
from azoom_torch.beam.postfilter import harmonic_regeneration
from azoom_torch.beam.wpd import masked_wpd
from azoom_torch.config import PipelineConfig
from azoom_torch.masks import postfilter
from azoom_torch.masks.duet import duet_masks
from azoom_torch.masks.postfilter import spectral_floor
from azoom_torch.wpe import wpe, wpe_dereverb

BOUND = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU work in one thread while this file runs (the suite's
    other workers share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def reverb():
    """The reverberant scene (numpy) and the reference's STFT of it."""
    spec = SceneSpec(reverb=True, n_interferers=2, duration_s=2.0, snr_db=50.0)
    sc = generate_scene(jax.random.PRNGKey(4), spec, max_order=6)
    sc = {k: np.array(v) for k, v in sc.items()}
    sc["Y"] = np.array(jax_stft(sc["mixture"], 1024, 512))  # (C, F, T)
    return sc


def T(x):
    return torch.from_numpy(np.array(x))


def _rel(got, want) -> float:
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("taps,delay,iterations", [(10, 3, 3), (4, 2, 1)])
def test_wpe_matches_jax(reverb, taps, delay, iterations):
    Y = np.moveaxis(reverb["Y"], 0, 1).copy()  # (F, C, T)
    fn = jax.jit(jax_wpe, static_argnames=("taps", "delay", "iterations"))
    want = np.asarray(fn(Y, taps=taps, delay=delay, iterations=iterations))
    got = wpe(T(Y), taps=taps, delay=delay, iterations=iterations).numpy()
    assert got.shape == want.shape == Y.shape and got.dtype == np.complex64
    rel = _rel(got, want)
    print(f"[wpe] taps={taps} delay={delay} iterations={iterations} rel_l2={rel:.3e} "
          f"vs_input={_rel(got, Y):.3e}")  # shown with pytest -s
    assert rel <= BOUND


def test_wpe_silent_bin_is_non_finite_as_in_jax(reverb):
    """A bin that is zero in every channel and frame: R = 0, the loading
    eps tr(R) = 0, a singular solve. The reference gives non-finite values
    there; the port gives them in the same places without raising."""
    Y = np.moveaxis(reverb["Y"], 0, 1).copy()
    Y[200] = 0.0
    want = np.asarray(jax.jit(jax_wpe)(Y))
    got = wpe(T(Y)).numpy()
    bad = ~np.isfinite(want)
    print(f"[wpe] silent bin: reference non-finite at {int(bad.sum())} values, "
          f"bins {sorted(set(np.nonzero(bad)[0].tolist()))}")
    assert bad[200].all() and not bad[np.arange(513) != 200].any()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isfinite(got), ~bad)
    keep = np.arange(513) != 200
    assert _rel(got[keep], want[keep]) <= BOUND


@pytest.mark.parametrize("length", [32_000, 31_999])
def test_wpe_dereverb_matches_jax(reverb, length):
    x = reverb["mixture"][:, :length]
    want = np.asarray(jax_wpe_dereverb(x, JaxConfig()))
    got = wpe_dereverb(x, PipelineConfig(), device="cpu")
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    got = got.numpy()
    assert got.shape == want.shape == x.shape and got.dtype == np.float32
    rel = _rel(got, want)
    print(f"[wpe] wpe_dereverb n={length} wave_rel_l2={rel:.3e}")
    assert rel <= BOUND


def test_wpe_dereverb_default_device_needs_cuda(reverb):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        wpe_dereverb(reverb["mixture"], PipelineConfig())
    # a tensor stays where it is
    assert wpe_dereverb(T(reverb["mixture"][:, :8000]), PipelineConfig()).device.type == "cpu"


def test_masked_wpd_on_reverb_matches_jax(reverb):
    """WPD (taps 8, two rounds) with the oracle mask on the reverberant scene,
    the input it replaces the WPE -> MVDR cascade on."""
    Y = reverb["Y"]
    tgt = np.asarray(irm_target_mask(jax_stft(reverb["target_ref"], 1024, 512),
                                     jax_stft(reverb["interference_ref"], 1024, 512)))
    freqs = np.asarray(jax_rfft_freqs(1024, 16_000))
    d = np.asarray(jax_steering_vector(freqs, 90.0, 0.08, 343.0, 2))
    want = np.asarray(jax.jit(jax_masked_wpd, static_argnames=("iterations",))(
        Y, tgt, d, freqs, iterations=2))
    got = masked_wpd(T(Y), T(tgt), T(d), T(freqs), iterations=2).numpy()
    rel = _rel(got, want)
    print(f"[wpd] reverb scene masked_wpd iterations=2 rel_l2={rel:.3e}")
    assert rel <= BOUND


@pytest.fixture(scope="module")
def far_field():
    """{M: numpy STFT (M, 513, 64)} of a far-field scene (target 90 deg,
    interferers 40 and 130 deg, 4 cm)."""
    sigs = speech_like_batch(jax.random.PRNGKey(3), 3, 32_000, 16_000)
    out = {}
    for M in (2, 4):
        sc = make_scene(sigs[0], sigs[1:], 90.0, jnp.array([40.0, 130.0]), 0.04, 16_000,
                        n_mics=M)
        out[M] = np.array(jax_stft(sc["mixture"], 1024, 512))
    return out


@pytest.mark.parametrize("angles,width,invalid", [
    ((90.0, 40.0, 130.0), 15.0, 0.5),
    ((60.0, 120.0), 30.0, 0.0),
])
@pytest.mark.parametrize("M", [2, 4])
def test_duet_masks_match_jax(far_field, M, angles, width, invalid):
    Y = far_field[M]
    want = np.asarray(jax_duet_masks(Y, jnp.asarray(angles), 0.04, 16_000, width_deg=width,
                                     invalid_value=invalid))
    got = duet_masks(T(Y), angles, 0.04, 16_000, width_deg=width, invalid_value=invalid).numpy()
    assert got.shape == want.shape == (len(angles),) + Y.shape[1:] and got.dtype == np.float32
    err = float(np.abs(got - want).max())
    print(f"[duet] M={M} K={len(angles)} max_abs={err:.3e} "
          f"invalid_bins={int(np.all(want == invalid, axis=0).sum())}")
    assert err <= 1e-5
    # batched: leading dims broadcast
    both = duet_masks(T(np.stack([Y, Y])), angles, 0.04, 16_000, width_deg=width,
                      invalid_value=invalid)
    assert torch.equal(both[1], torch.from_numpy(got))


@pytest.mark.parametrize("floor", [0.05, 0.3])
def test_spectral_floor_matches_jax(floor):
    rng = np.random.default_rng(1)
    S = (rng.standard_normal((2, 513, 20)) + 1j * rng.standard_normal((2, 513, 20))).astype(
        np.complex64)
    mask = rng.random((2, 513, 20), dtype=np.float32)
    want = np.asarray(jax_spectral_floor(S, mask, floor))
    np.testing.assert_array_equal(spectral_floor(T(S), T(mask), floor).numpy(), want)


def test_postfilter_reexports_harmonic_regeneration():
    assert postfilter.harmonic_regeneration is harmonic_regeneration
    assert set(postfilter.__all__) == {"harmonic_regeneration", "spectral_floor"}
