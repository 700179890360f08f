"""Parity of the port's per-bin DOA and visual field-of-view covariance gate
(azoom_torch.masks.duet.bin_doa, masks.geometric) with azoom.masks.duet and
azoom.masks.geometric (CPU).

Scene: 1 s, seed 7, 4 cm pair, target at 60 deg, interferers at 40 and
130 deg; the FOV is 30 deg around 60. Bounds: gate and protect atol 1e-5
(the reference's float32 angles against the port's float64 ones, rounded
once); the valid flags and the hard IPD mask equal; theta atol 1e-3 deg
(arccos amplifies float32 rounding near endfire, where d theta = d cos /
sin theta).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from azoom.dsp.stft import stft
from azoom.masks.duet import bin_doa as jax_bin_doa
from azoom.masks.geometric import apply_fov_gate as jax_apply
from azoom.masks.geometric import fov_noise_gate as jax_gate
from azoom.masks.geometric import hard_geometric_noise_mask as jax_hard_mask
from azoom.sim.farfield import make_scene
from azoom.sim.signals import speech_like_batch
from azoom_torch.masks.duet import bin_doa
from azoom_torch.masks.geometric import apply_fov_gate, fov_noise_gate, hard_geometric_noise_mask

FS, MIC = 16_000, 0.04
GEOMETRIES = {  # name: explicit positions, or None for the linear pair
    "linear": None,
    "positions": np.array([[0.014, 0.014], [-0.014, -0.014]], np.float32),
}


@pytest.fixture(scope="module")
def Y():
    sigs = speech_like_batch(jax.random.PRNGKey(7), 3, FS, FS)
    sc = make_scene(sigs[0], sigs[1:], 60.0, jnp.array([40.0, 130.0]), MIC, FS)
    return np.array(stft(sc["mixture"], 1024, 512))


def test_bin_doa_matches_jax(Y):
    theta, valid = bin_doa(torch.from_numpy(Y), MIC, FS)
    jt, jv = jax_bin_doa(jnp.asarray(Y), MIC, FS)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jv))
    np.testing.assert_allclose(theta.numpy(), np.asarray(jt), atol=1e-3)


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_fov_noise_gate_matches_jax(Y, geometry):
    pos = GEOMETRIES[geometry]
    got = fov_noise_gate(torch.from_numpy(Y), 60.0, 30.0, MIC, FS,
                         positions=None if pos is None else torch.from_numpy(pos))
    ref = jax_gate(jnp.asarray(Y), 60.0, 30.0, MIC, FS,
                   positions=None if pos is None else jnp.asarray(pos))
    gate, protect, valid = (g.numpy() for g in got)
    assert gate.dtype == protect.dtype == np.float32
    np.testing.assert_array_equal(valid, np.asarray(ref[2]))
    for name, a, b in (("gate", gate, ref[0]), ("protect", protect, ref[1])):
        err = np.abs(a - np.asarray(b)).max()
        print(f"[fov] {geometry} {name}: max abs err {err:.2e}")
        assert err <= 1e-5, name
    noise = np.random.default_rng(3).random(gate.shape, dtype=np.float32)
    got_m = apply_fov_gate(torch.from_numpy(noise), *got).numpy()
    ref_m = np.asarray(jax_apply(jnp.asarray(noise), *ref))
    np.testing.assert_allclose(got_m, ref_m, atol=1e-5)


def test_hard_geometric_noise_mask_matches_jax(Y):
    got = hard_geometric_noise_mask(torch.from_numpy(Y)).numpy()
    ref = np.asarray(jax_hard_mask(jnp.asarray(Y)))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, ref)
