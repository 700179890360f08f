"""Parity of the port's M-mic linear algebra and beamformer stages with azoom
(CPU): beam.linalgmm (the unrolled Cholesky solve and the Jacobi EVD),
beam.covariance.recursive_covariance_update, beam.mvdr.mvdr_weights and the
norm-constrained LCMV of beam.nullsteer.hard_null_weights at M > 2.

Inputs are numpy arrays from a seed; the nullsteer scenes are the
reference's own (tests/test_mmic.py::_nullsteer_physical_study: three
speech-like interferers at 30, 135 and 60 deg around a 90 deg target, an
8 cm "separable" array and a 4 cm "congested" one), made by azoom's
simulator and covariance, so both sides weigh the same R_int.

Bounds: the linear algebra to <= 1e-5 of scale (max |x| of the solution,
the largest |eigenvalue|), the bound the reference's own EVD test holds
against numpy (measured: the solves <= 1.3e-6, the eigenvalues <= 1.8e-6);
the closed forms at M = 2 bit for bit.

The LCMV's three gates are thresholds. On the test scenes the
null-significance gate and the delay-and-sum fallback decide alike in every
bin (0 of 513 at every n_nulls, asserted). The per-bin loading bisection
(20 steps of log delta against the white-noise-gain cap) ends within float32
noise of its root, and there one ulp of ||w||^2 picks the other half of the
bracket: against the jitted reference 10 / 30 / 105 bins (separable,
n_nulls 1 / 2 / 3) and 17 / 38 / 102 (congested) of 513 take another step,
every first difference at step >= 9 of 20 (bracket <= 0.05 in log delta);
computing in float64 moved the counts to 3 / 22 / 84 and 16 / 34 / 84, not
to zero, so the port keeps the reference's complex64. The weights then
agree to <= 3e-4 of each bin's largest weight, held to 1e-3.

The reference's EVD and LCMV run eagerly here (op by op): jitted, its
unrolled Jacobi compiles for 38 s at M = 8 on one core.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from azoom.beam import linalgmm as jax_linalgmm
from azoom.beam.covariance import masked_covariance as jax_masked_covariance
from azoom.beam.covariance import recursive_covariance_update as jax_recursive_update
from azoom.beam.linalg2x2 import eigh_2x2_hermitian as jax_eigh_2x2
from azoom.beam.mvdr import mvdr_weights as jax_mvdr_weights
from azoom.beam.nullsteer import hard_null_weights as jax_hard_null_weights
from azoom.config import PipelineConfig
from azoom.dsp.delays import steering_vector as jax_steering_vector
from azoom.dsp.stft import rfft_freqs as jax_rfft_freqs
from azoom.dsp.stft import stft as jax_stft
from azoom.masks.oracle import ibm_noise_mask as jax_ibm_noise_mask
from azoom.sim.farfield import make_scene
from azoom.sim.signals import speech_like
from azoom_torch.beam.covariance import masked_covariance, recursive_covariance_update
from azoom_torch.beam.linalg2x2 import eigh_2x2_hermitian, solve_2x2_hermitian
from azoom_torch.beam.linalgmm import (
    cholesky_small,
    eigh_hermitian_small,
    solve_hermitian,
    solve_hermitian_small,
)
from azoom_torch.beam.mvdr import mvdr_weights
from azoom_torch.beam.nullsteer import hard_null_weights

SCALE_BOUND = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU work in one thread while this file runs (the suite's
    other workers share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _random_hpd(seed, batch, M, load):
    """Random complex Hermitian positive-definite (batch, M, M) complex64, as
    the reference's tests build them (A A^H / M + load I)."""
    rng = np.random.default_rng(seed)
    A = (rng.standard_normal((batch, M, M)) + 1j * rng.standard_normal((batch, M, M)))
    R = np.einsum("bij,bkj->bik", A, A.conj()) / M + load * np.eye(M)
    return R.astype(np.complex64)


def _random_vec(seed, batch, M):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((batch, M)) + 1j * rng.standard_normal((batch, M))).astype(
        np.complex64)


@pytest.mark.parametrize("M", [3, 4, 6, 8, 12, 16])
def test_solve_hermitian_small_matches_jax(M):
    R, d = _random_hpd(M, 64, M, 0.1), _random_vec(100 + M, 64, M)
    want = np.asarray(jax.jit(jax_linalgmm.solve_hermitian_small)(R, d))
    got = solve_hermitian_small(torch.from_numpy(R), torch.from_numpy(d)).numpy()
    scale = np.abs(want).max(axis=-1)
    err = float((np.abs(got - want).max(axis=-1) / scale).max())
    print(f"[linalgmm] solve M={M} err_of_scale={err:.3e}")  # shown with pytest -s
    assert err <= SCALE_BOUND
    # and the dispatch takes the same path above M = 2
    assert torch.equal(solve_hermitian(torch.from_numpy(R), torch.from_numpy(d)),
                       torch.from_numpy(got))


@pytest.mark.parametrize("M", [3, 4, 6, 8])
def test_solve_hermitian_semidefinite_stays_finite(M):
    """A rank-1 covariance (a coherent source, no loading): the relative
    pivot clamp keeps the solve finite, as the reference's."""
    v = _random_vec(7 + M, 1, M)
    R = np.einsum("bi,bj->bij", v, v.conj()).astype(np.complex64)
    d = np.ones((1, M), np.complex64)
    got = solve_hermitian_small(torch.from_numpy(R), torch.from_numpy(d))
    assert bool(torch.isfinite(torch.view_as_real(got)).all())
    want = np.asarray(jax_linalgmm.solve_hermitian_small(R, d))
    assert np.all(np.isfinite(want.view(np.float32)))


def test_solve_hermitian_at_two_mics_is_the_closed_form():
    R, d = torch.from_numpy(_random_hpd(0, 16, 2, 0.1)), torch.from_numpy(_random_vec(1, 16, 2))
    assert torch.equal(solve_hermitian(R, d), solve_2x2_hermitian(R, d))
    assert torch.equal(solve_hermitian(R, d, eps=1e-9), solve_2x2_hermitian(R, d, eps=1e-9))
    # the unrolled path agrees with the closed form at M = 2 too
    x = solve_hermitian_small(R, d)
    assert float((x - solve_2x2_hermitian(R, d)).abs().max() / x.abs().max()) <= SCALE_BOUND


def test_cholesky_small_factors():
    R = _random_hpd(5, 8, 5, 0.1)
    L = cholesky_small(torch.from_numpy(R))
    Lm = torch.zeros(8, 5, 5, dtype=torch.complex64)
    for i in range(5):
        for j in range(i + 1):
            Lm[:, i, j] = L[i][j]
        assert all(L[i][j] is None for j in range(i + 1, 5))
    rec = (Lm @ Lm.conj().transpose(-1, -2)).numpy()
    assert np.abs(rec - R).max() / np.abs(R).max() <= SCALE_BOUND


@pytest.mark.parametrize("M", [3, 4, 6, 8])
def test_eigh_hermitian_small_matches_jax_and_numpy(M):
    R = _random_hpd(20 + M, 32, M, 0.01)
    ev_j, U_j = (np.asarray(a) for a in jax_linalgmm.eigh_hermitian_small(jnp.asarray(R)))
    Rt = torch.from_numpy(R)
    ev, U = (a.numpy() for a in eigh_hermitian_small(Rt))
    assert torch.equal(Rt, torch.from_numpy(R))  # the input is left as it was
    scale = np.abs(np.linalg.eigvalsh(R.astype(np.complex128))).max(axis=-1, keepdims=True)
    err_jax = float(np.abs(ev - ev_j).max() / scale.max())
    err_np = float((np.abs(ev - np.linalg.eigvalsh(R.astype(np.complex128))) / scale).max())
    rec = np.einsum("bij,bj,bkj->bik", U, ev, U.conj())
    rec_err = float(np.abs(rec - R).max() / scale.max())
    unit_err = float(np.abs(np.einsum("bji,bjk->bik", U.conj(), U) - np.eye(M)).max())
    # the same vectors as the reference's, column by column (ascending, stable)
    vec_err = float(np.abs(U - U_j).max())
    print(f"[linalgmm] eigh M={M} ev_vs_jax={err_jax:.3e} ev_vs_numpy={err_np:.3e} "
          f"reconstruction={rec_err:.3e} unitarity={unit_err:.3e} vectors_vs_jax={vec_err:.3e}")
    assert np.all(np.diff(ev, axis=-1) >= 0)
    assert max(err_jax, err_np, rec_err, unit_err) <= SCALE_BOUND
    assert vec_err <= 1e-4


def test_eigh_hermitian_small_at_two_mics_is_the_closed_form():
    R = torch.from_numpy(_random_hpd(5, 8, 2, 0.1))
    for a, b in zip(eigh_hermitian_small(R), eigh_2x2_hermitian(R)):
        assert torch.equal(a, b)
    # and the reference's closed form agrees (its own M = 2 dispatch)
    ev_j, _ = jax_eigh_2x2(jnp.asarray(R.numpy()))
    np.testing.assert_allclose(eigh_hermitian_small(R)[0].numpy(), np.asarray(ev_j), rtol=1e-6)


def test_eigh_keeps_tied_columns_in_order():
    """An isotropic block ties eigenvalues: the stable sort keeps the
    columns in the order the sweeps left them, as jnp.argsort does."""
    R = np.tile(np.eye(4, dtype=np.complex64), (3, 1, 1))
    R[1, 0, 0] = 2.0
    ev, U = eigh_hermitian_small(torch.from_numpy(R))
    ev_j, U_j = jax_linalgmm.eigh_hermitian_small(jnp.asarray(R))
    np.testing.assert_array_equal(ev.numpy(), np.asarray(ev_j))
    np.testing.assert_array_equal(U.numpy(), np.asarray(U_j))


@pytest.mark.parametrize("M", [2, 4])
def test_recursive_covariance_update_matches_jax(M):
    rng = np.random.default_rng(M)
    F, T = 33, 6
    Y = (rng.standard_normal((M, F, T)) + 1j * rng.standard_normal((M, F, T))).astype(
        np.complex64)
    mask = rng.random((F, T), dtype=np.float32)
    R_t = torch.zeros(F, M, M, dtype=torch.complex64)
    w_t = torch.zeros(F)
    R_j, w_j = jnp.zeros((F, M, M), jnp.complex64), jnp.zeros((F,), jnp.float32)
    for t in range(T):
        R_t, w_t = recursive_covariance_update(R_t, torch.from_numpy(Y[..., t]),
                                               torch.from_numpy(mask[:, t]), w_t)
        R_j, w_j = jax_recursive_update(R_j, Y[..., t], mask[:, t], w_j)
    np.testing.assert_allclose(R_t.numpy(), np.asarray(R_j), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), rtol=1e-6)
    # R / (w + eps) is the batch estimate over the frames seen
    batch = masked_covariance(torch.from_numpy(Y), torch.from_numpy(mask))
    np.testing.assert_allclose((R_t / (w_t + 1e-6)[:, None, None]).numpy(), batch.numpy(),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("M", [3, 4])
def test_mvdr_weights_match_jax(M):
    cfg = PipelineConfig(n_mics=M, mic_dist=0.04)
    freqs = jax_rfft_freqs(cfg.n_fft, cfg.fs)
    d = np.array(jax_steering_vector(freqs, 70.0, cfg.mic_dist, cfg.c, M))
    R = _random_hpd(7, freqs.shape[0], M, 0.5)
    want = np.asarray(jax.jit(jax_mvdr_weights)(R, d, 1e-6))
    got = mvdr_weights(torch.from_numpy(R), torch.from_numpy(d), sigma=1e-6).numpy()
    err = float((np.abs(got - want).max(axis=-1) / np.abs(want).max(axis=-1)).max())
    print(f"[linalgmm] mvdr_weights M={M} err_of_scale={err:.3e}")
    assert err <= SCALE_BOUND
    gain = np.einsum("fm,fm->f", got.conj(), d)  # distortionless toward d
    np.testing.assert_allclose(np.abs(gain), 1.0, atol=1e-3)


SCENES = {  # name: (mic spacing, the four sources' f0s)
    "separable": (0.08, (300.0, 420.0, 360.0, 500.0)),
    "congested": (0.04, (150.0, 220.0, 120.0, 260.0)),
}


@pytest.fixture(scope="module", params=list(SCENES))
def null_scene(request):
    """(name, R_int (F, 4, 4), phase-normalised d (F, 4)) of a reference
    nullsteer scene, and the reference's weights at n_nulls 1, 2 and 3."""
    mic_dist, f0s = SCENES[request.param]
    n = 16_000
    keys = jax.random.split(jax.random.PRNGKey(11), 4)
    target = speech_like(keys[0], n, 16_000, f0s[0])
    ints = jnp.stack([speech_like(keys[i + 1], n, 16_000, f0s[i + 1]) for i in range(3)])
    sc = make_scene(target, ints, 90.0, jnp.asarray([30.0, 135.0, 60.0]), mic_dist, 16_000.0,
                    n_mics=4)
    cfg = PipelineConfig(n_mics=4, mic_dist=mic_dist)
    Y = jax_stft(sc["mixture"], cfg.n_fft, cfg.hop)
    nm = jax_ibm_noise_mask(jax_stft(sc["target_ref"], cfg.n_fft, cfg.hop),
                            jax_stft(sc["interference_ref"], cfg.n_fft, cfg.hop))
    freqs = jax_rfft_freqs(cfg.n_fft, cfg.fs)
    d = jax_steering_vector(freqs, 90.0, mic_dist, cfg.c, 4, normalize_phase=True)
    R = jax_masked_covariance(Y, nm)
    want = {J: np.asarray(jax_hard_null_weights(R, d, n_nulls=J)) for J in (1, 2, 3)}
    want["eigvals"] = np.asarray(jax_linalgmm.eigh_hermitian_small(R)[0])
    return request.param, np.array(R), np.array(d), want


def _significant(ev):
    """The null-significance gate of each direction j (..., F, M): its
    eigenvalue over 10 x the floor eigenvalue (azoom/beam/nullsteer.py)."""
    floor = ev[..., :1] + 1e-3 * ev.sum(-1, keepdims=True) / ev.shape[-1]
    return ev > 10.0 * floor


@pytest.mark.parametrize("n_nulls", [1, 2, 3])
def test_hard_null_weights_at_four_mics_match_jax(null_scene, n_nulls):
    name, R, d, want = null_scene
    got = hard_null_weights(torch.from_numpy(R), torch.from_numpy(d), n_nulls=n_nulls).numpy()
    sig_got = _significant(eigh_hermitian_small(torch.from_numpy(R))[0].numpy())
    assert np.array_equal(sig_got, _significant(want["eigvals"]))
    want = want[n_nulls]
    assert got.shape == want.shape == d.shape
    assert np.all(np.isfinite(got.view(np.float32)))
    das = d / 4
    fallback_got, fallback_want = np.all(got == das, -1), np.all(want == das, -1)
    err = float((np.abs(got - want).max(axis=-1) / np.abs(want).max(axis=-1)).max())
    print(f"[nullsteer] {name} n_nulls={n_nulls} fallback_bins={int(fallback_want.sum())} "
          f"fallback_differ={int((fallback_got != fallback_want).sum())} "
          f"max_rel_of_bin={err:.3e}")
    assert np.array_equal(fallback_got, fallback_want)
    assert err <= 1e-3
    # unit gain toward the target wherever the LCMV kept its weights
    gain = np.abs(np.einsum("fm,fm->f", got.conj(), d))
    np.testing.assert_allclose(gain[~fallback_got], 1.0, atol=1e-4)


def test_hard_null_weights_clamp_n_nulls_and_keep_two_mics():
    R, d = torch.from_numpy(_random_hpd(3, 9, 3, 0.01)), torch.from_numpy(_random_vec(4, 9, 3))
    d = d / d.abs()
    # J = min(n_nulls, M - 1): 2 and 5 nulls are the same construction at M = 3
    assert torch.equal(hard_null_weights(R, d, n_nulls=2), hard_null_weights(R, d, n_nulls=5))
    R2, d2 = torch.from_numpy(_random_hpd(5, 9, 2, 0.01)), torch.from_numpy(_random_vec(6, 9, 2))
    # n_nulls and wng_limit act at M > 2 only
    assert torch.equal(hard_null_weights(R2, d2), hard_null_weights(R2, d2, n_nulls=3,
                                                                    wng_limit=3.0))
