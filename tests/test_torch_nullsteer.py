"""Parity of the port's hybrid hard-null beamformer (beam.linalg2x2,
beam.nullsteer and the plain version of the fused CUDA kernel,
kernels.nullsteer_kernel.hard_null_plain) with azoom's XLA function
azoom.beam.nullsteer.hybrid_hard_null_beamform and its Pallas kernel in
interpret mode (CPU).

Scene (as tests/test_pallas_mvdr.py): seed 13, 4 cm, target at 90 deg,
interferers at 40 and 130 deg, IBM target mask, 2 s (F = 513, T = 64).

Bounds: per (bin) row relative error <= 1e-3 against the XLA function at
cond thresholds 1 + 1e-6, 10 and 1e6, except rows whose XLA cond lies
within a relative band of 1e-3 around the threshold, where float32 and
float64 may take the gate on different sides (the count is printed; 0 on
this scene). Against the Pallas kernel the same bound holds only where no
gate acts (thresholds 1 + 1e-6 and 1e6): at 10 the Pallas kernel falls back
to delay-and-sum on rows the XLA function keeps, and how many depends on the
input's scale (absolute epsilons at azoom/pallas/nullsteer_kernel.py:59, 62,
79). The port computes the XLA function and is scale-covariant;
test_pallas_gate_depends_on_scale records the difference.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from azoom.beam.covariance import masked_covariance as jax_covariance
from azoom.beam.linalg2x2 import cond_2x2 as jax_cond
from azoom.beam.linalg2x2 import eigh_2x2_hermitian as jax_eigh
from azoom.beam.linalg2x2 import solve_2x2_general as jax_solve_general
from azoom.beam.nullsteer import hybrid_hard_null_beamform as jax_hybrid
from azoom.config import PipelineConfig
from azoom.dsp.delays import steering_vector
from azoom.dsp.stft import rfft_freqs, stft
from azoom.masks.oracle import ibm_target_mask
from azoom.pallas.nullsteer_kernel import hybrid_hard_null_pallas
from azoom.sim.farfield import make_scene
from azoom.sim.signals import speech_like_batch
from azoom_torch import kernels
from azoom_torch.beam.linalg2x2 import cond_2x2, eigh_2x2_hermitian, solve_2x2_general
from azoom_torch.beam.nullsteer import hard_null_weights, hybrid_hard_null_beamform
from azoom_torch.kernels.nullsteer_kernel import hard_null_cond, hard_null_fused, hard_null_plain

CFG = PipelineConfig(mic_dist=0.04)
BAND = 1e-3  # relative band around the cond threshold where the gate may flip
THRESHOLDS = {"no_gate_low": 1 + 1e-6, "default": 10.0, "no_gate_high": 1e6}


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def scene():
    sigs = speech_like_batch(jax.random.PRNGKey(13), 3, 32_000, CFG.fs)
    sc = make_scene(sigs[0], sigs[1:], 90.0, jnp.array([40.0, 130.0]), CFG.mic_dist, CFG.fs)
    Y = stft(sc["mixture"], CFG.n_fft, CFG.hop)
    tm = ibm_target_mask(stft(sc["target_ref"], CFG.n_fft, CFG.hop),
                         stft(sc["interference_ref"], CFG.n_fft, CFG.hop))
    freqs = rfft_freqs(CFG.n_fft, CFG.fs)
    d = steering_vector(freqs, 90.0, CFG.mic_dist, normalize_phase=True)
    return {k: np.asarray(v) for k, v in dict(Y=Y, tm=tm, freqs=freqs, d=d).items()}


def _xla_cond(sc):
    """cond(C) per row as the XLA function builds C (float32)."""
    R = jax_covariance(sc["Y"], 1.0 - sc["tm"])
    _, vecs = jax_eigh(R)
    v = vecs[..., :, -1]
    v = v * jnp.conj(v[..., :1] / (jnp.abs(v[..., :1]) + 1e-10))
    return np.asarray(jax_cond(jnp.stack([jnp.asarray(sc["d"]), v], axis=-1)))


def _row_rel(got, ref):
    return np.linalg.norm(got - ref, axis=-1) / (np.linalg.norm(ref, axis=-1) + 1e-30)


def _hermitian_batch(rng, scale, n=400):
    a = rng.random(n) * scale
    c = rng.random(n) * scale
    b = (rng.standard_normal(n) + 1j * rng.standard_normal(n)) * 0.5 * np.sqrt(a * c)
    a[:40], c[:40], b[:40] = scale, scale, 0.0  # isotropic
    a[40:80], c[40:80], b[40:80] = scale, 0.0, 0.0  # rank one, axis-aligned
    R = np.empty((n, 2, 2), np.complex64)
    R[:, 0, 0], R[:, 1, 1], R[:, 0, 1], R[:, 1, 0] = a, c, b, np.conj(b)
    return R


@pytest.mark.parametrize("scale", [1e-8, 1e-4, 1.0, 1e2])
def test_linalg2x2_matches_jax(scale):
    rng = np.random.default_rng(int(-np.log10(scale)) + 20)
    R = _hermitian_batch(rng, scale)
    vals, vecs = eigh_2x2_hermitian(_t(R))
    jvals, jvecs = jax_eigh(jnp.asarray(R))
    np.testing.assert_allclose(vals.numpy(), np.asarray(jvals), rtol=1e-5, atol=1e-6 * scale)
    np.testing.assert_allclose(vecs.numpy(), np.asarray(jvecs), atol=1e-4)
    A = (rng.standard_normal((400, 2, 2)) + 1j * rng.standard_normal((400, 2, 2))).astype(np.complex64)
    A *= np.float32(scale)
    np.testing.assert_allclose(cond_2x2(_t(A)).numpy(), np.asarray(jax_cond(jnp.asarray(A))),
                               rtol=1e-3)
    rhs = np.broadcast_to(np.array([1, 0], np.complex64), (400, 2))
    x = solve_2x2_general(_t(A), _t(rhs), eps=1e-10).numpy()
    xj = np.asarray(jax_solve_general(jnp.asarray(A), jnp.asarray(rhs), eps=1e-10))
    np.testing.assert_allclose(x, xj, rtol=1e-4, atol=1e-6 * np.abs(xj).max())


@pytest.mark.parametrize("thr_name", list(THRESHOLDS))
def test_hybrid_matches_xla(scene, thr_name):
    thr = THRESHOLDS[thr_name]
    sc = scene
    ref = np.asarray(jax_hybrid(sc["Y"], sc["tm"], sc["d"], sc["freqs"], cond_threshold=thr))
    args = (_t(sc["Y"]), _t(sc["tm"]), _t(sc["d"]), _t(sc["freqs"]))
    in_band = np.abs(_xla_cond(sc) / thr - 1.0) < BAND
    print(f"[hard_null] threshold {thr}: {int(in_band.sum())} rows within {BAND} of it, left out")
    for name, got in (
        ("plain float64", hard_null_plain(*args, cond_threshold=thr)),
        ("complex64", hybrid_hard_null_beamform(*args, cond_threshold=thr)),
    ):
        err = _row_rel(got.numpy(), ref)[~in_band]
        print(f"[hard_null] {name} vs XLA, threshold {thr}: max row rel {err.max():.3e}")
        assert err.max() <= 1e-3, name


@pytest.mark.parametrize("thr_name", ["no_gate_low", "no_gate_high"])
def test_plain_matches_pallas_without_gate(scene, thr_name):
    thr = THRESHOLDS[thr_name]
    sc = scene
    ref = np.asarray(hybrid_hard_null_pallas(sc["Y"], sc["tm"], sc["d"], sc["freqs"],
                                             cond_threshold=thr, interpret=True))
    got = hard_null_plain(_t(sc["Y"]), _t(sc["tm"]), _t(sc["d"]), _t(sc["freqs"]),
                          cond_threshold=thr).numpy()
    err = _row_rel(got, ref)
    print(f"[hard_null] plain vs Pallas, threshold {thr}: max row rel {err.max():.3e}, "
          f"median {np.median(err):.3e}")
    assert err.max() <= 1e-3


def _das_rows(S, sc, Y):
    """Rows (above the 200 Hz bypass) whose output is delay-and-sum d/2."""
    das = np.einsum("fm,mft->ft", np.conj(sc["d"] / 2), Y)
    on = _row_rel(S, das) < 1e-4
    return int(np.sum(on & (sc["freqs"] >= 200.0)))


def test_pallas_gate_depends_on_scale(scene):
    sc = scene
    rows = {}
    for s in (1.0, 100.0):
        Y = (sc["Y"] * np.float32(s)).astype(np.complex64)
        pal = np.asarray(hybrid_hard_null_pallas(Y, sc["tm"], sc["d"], sc["freqs"], interpret=True))
        port = hard_null_plain(_t(Y), _t(sc["tm"]), _t(sc["d"]), _t(sc["freqs"])).numpy()
        rows[s] = (_das_rows(pal, sc, Y), _das_rows(port, sc, Y), port)
    cond = hard_null_cond(_t(sc["Y"]), _t(sc["tm"]), _t(sc["d"])).numpy()
    xla_das = int(np.sum((cond > 10.0) & (sc["freqs"] >= 200.0)))
    print(f"[hard_null] rows on delay-and-sum (of {len(sc['freqs'])}): Pallas x1 {rows[1.0][0]}, "
          f"x100 {rows[100.0][0]}; port x1 {rows[1.0][1]}, x100 {rows[100.0][1]}; XLA cond gate "
          f"{xla_das}")
    assert rows[1.0][0] > rows[1.0][1] + 300  # the Pallas kernel's absolute epsilons
    assert rows[100.0][0] < rows[1.0][0]      # ... whose effect depends on the scale
    assert rows[1.0][1] == rows[100.0][1] == xla_das
    err = _row_rel(rows[100.0][2], 100.0 * rows[1.0][2])
    assert err.max() <= 1e-5


def test_wrapper_on_cpu_is_the_plain_version(scene):
    sc = scene
    before = dict(kernels.launches)
    args = (_t(sc["Y"][None]), _t(sc["tm"][None]), _t(sc["d"]), _t(sc["freqs"]))
    post = _t(sc["tm"][None])
    got = hard_null_fused(*args, post_mask=post)
    np.testing.assert_array_equal(got.numpy(), hard_null_plain(*args, post_mask=post).numpy())
    assert kernels.launches == before


def test_plain_per_chunk_steering_is_a_loop_of_shared_calls(scene):
    """d (C, F, 2), one steering vector per chunk (the tracked pipeline's
    form), equals C calls with each chunk's (F, 2) vector, bit for bit; and
    the wrapper on CPU tensors takes the plain version."""
    from azoom_torch.dsp.delays import steering_vector as port_steering

    sc = scene
    Y = _t(sc["Y"])
    Yc = torch.stack([Y, 0.5 * Y.flip(-1), Y * 1j])  # (3, 2, F, T)
    tm = _t(sc["tm"])
    tmc = torch.stack([tm, tm.flip(-1), 1.0 - tm])
    f = _t(sc["freqs"])
    d = port_steering(f, torch.tensor([50.0, 90.0, 140.0]), CFG.mic_dist, normalize_phase=True)
    assert d.shape == (3, 513, 2)
    before = dict(kernels.launches)
    got = hard_null_fused(Yc, tmc, d, f, post_mask=tmc)
    assert kernels.launches == before
    for c in range(3):
        want = hard_null_plain(Yc[c], tmc[c], d[c], f, post_mask=tmc[c])
        assert torch.equal(got[c], want)
    # the same vector in every chunk is the shared call
    same = hard_null_plain(Yc, tmc, d[1].expand(3, 513, 2), f, post_mask=tmc)
    assert torch.equal(same, hard_null_plain(Yc, tmc, d[1], f, post_mask=tmc))


def test_more_than_two_mics_is_queued():
    R = torch.eye(3, dtype=torch.complex64).expand(5, 3, 3)
    with pytest.raises(NotImplementedError, match="linalgmm"):
        hard_null_weights(R, torch.ones(5, 3, dtype=torch.complex64))
