"""Parity of the port's GEV, RTF, RMVB and WPD beamformers (azoom_torch.beam
.{gev,rtf,rmvb,wpd}) with azoom's on the CPU, at M = 2 and M = 4.

Scenes: 2 s of speech-like sources (azoom.sim.signals.speech_like_batch),
the target at 90 deg and interferers at 40 and 130 deg on a 4 cm linear
array of 2 or 4 mics (azoom.sim.farfield.make_scene); the oracle ratio mask
(irm_target_mask) as the target mask, its complement as the noise mask; the
steering vector at 80 deg (a 10 deg pointing error, RMVB's case). Both sides
take the same numpy STFT, masks, steering and covariances, and the
reference runs jitted, as its pipelines run it.

Bounds. Weights are held per bin, relative to the bin's largest weight:
at most 1e-2 in every bin and 2e-3 in 99 % of them (WPD's 1e-2 and
5e-3), the median far below, and no further from a complex128 run of the
port than twice the reference's own distance from it (+ 1e-6). The worst
bins are where float32 loses digits whichever way it rounds: the low bins
(5-30), where a 4 cm array sees nearly coherent covariances, and bins
whose generalized eigengap is small (RTF's power iteration at M = 4).
Measured (``-s`` prints each): GEV <= 8.8e-4 (M = 2) and 1.7e-3 (M = 4), the
reference itself up to 6.2e-4 and 1.2e-3 from complex128; RTF 4.8e-4 and 7.8e-3
(the reference 3.6e-3 and 6.3e-3 from complex128, the port 2.3e-3);
RMVB 7.0e-5 and 5.2e-4; WPD's weights 3.8e-3 at M = 4 (median 2.2e-4:
its 36 x 36 loaded solves by LU round differently from LAPACK's); medians
1e-7 to 6e-6. Beamformed spectra are held to relative L2 1e-3 (measured
2.4e-5 to 7.6e-4), RTF's to 5e-3: its MVDR on a measured steering
amplifies the steering's float32 noise in near-singular bins (measured
2.5e-3 at M = 2 and 1.0e-3 at M = 4; the reference 1.1e-3 and 7.9e-4 from
complex128, the port 1.5e-3 and 5.8e-4).

Gates: every where() of gev, rtf and rmvb (the root and row choices and the
degeneracy test of eig_principal_2x2, the power iteration's collapse guard,
RTF's confidence gate, RMVB's 30 bisection steps and its has_root and
use_nominal guards) is recorded on both sides through the function itself
(the module's jnp / torch wrapped so where() keeps its condition) and the
bins that decide differently are counted, printed and held: none on the
reference's own covariances; from the port's own covariances (ulps apart)
RTF at M = 2 picks the other row in 3 bins (both rows give the
eigenvector, up to the phase the normalisation removes) and the other
steering in 1 of 513; RMVB's bisections agree for their first 14 (M = 2)
and 11 (M = 4) steps and then part where mid lands within float32 noise
of the root (339 and 439 of 513 bins by step 30), its guards never.
"""

import contextlib
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import azoom.beam.gev as jax_gev
import azoom.beam.rmvb as jax_rmvb
import azoom.beam.rtf as jax_rtf
import azoom.beam.wpd as jax_wpd
from azoom.beam.covariance import masked_covariance as jax_masked_covariance
from azoom.dsp.delays import steering_vector as jax_steering_vector
from azoom.dsp.stft import rfft_freqs as jax_rfft_freqs
from azoom.dsp.stft import stft as jax_stft
from azoom.masks.oracle import irm_target_mask
from azoom.sim.farfield import make_scene
from azoom.sim.signals import speech_like_batch
from azoom_torch.beam import gev, rmvb, rtf, wpd
from azoom_torch.beam.linalg2x2 import csqrt_cut
from azoom_torch.beam.mvdr import mvdr_weights

WEIGHT_BOUND, WEIGHT_P99 = 1e-2, 2e-3
SPECTRUM_BOUND = 1e-3
RTF_SPECTRUM_BOUND = 5e-3  # the MVDR on a measured steering: module docstring
MICS = [2, 4]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU work in one thread while this file runs (the suite's
    other workers share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scenes():
    """{M: dict of numpy Y (M, 513, T), tgt (513, T), noise, d (513, M) at
    80 deg, freqs, R_t and R_n (513, M, M) of the reference}."""
    sigs = speech_like_batch(jax.random.PRNGKey(11), 3, 32_000, 16_000)
    out = {}
    for M in MICS:
        sc = make_scene(sigs[0], sigs[1:], 90.0, jnp.array([40.0, 130.0]), 0.04, 16_000,
                        n_mics=M)
        Y = jax_stft(sc["mixture"], 1024, 512)
        tgt = irm_target_mask(jax_stft(sc["target_ref"], 1024, 512),
                              jax_stft(sc["interference_ref"], 1024, 512))
        freqs = jax_rfft_freqs(1024, 16_000)
        cov = jax.jit(jax_masked_covariance)
        out[M] = {k: np.array(v) for k, v in dict(
            Y=Y, tgt=tgt, noise=1.0 - tgt, freqs=freqs,
            d=jax_steering_vector(freqs, 80.0, 0.04, 343.0, M),
            R_t=cov(Y, tgt), R_n=cov(Y, 1.0 - tgt)).items()}
    return out


def T(x, dtype=None):
    t = torch.from_numpy(np.array(x))  # a writable copy (JAX's arrays are read-only)
    return t if dtype is None else t.to(dtype)


def _bin_errors(got, want):
    """max |got - want| over each bin's weights, relative to its largest."""
    return np.abs(got - want).max(-1) / np.maximum(np.abs(want).max(-1), 1e-30)


def _check_weights(tag, got, want, got64, bound=WEIGHT_BOUND, p99=WEIGHT_P99):
    """Per-bin weights against the reference's, and both against the port's
    complex128 run (module docstring)."""
    assert got.shape == want.shape and np.all(np.isfinite(got.view(np.float32)))
    err = _bin_errors(got, want)
    err_port, err_ref = _bin_errors(got, got64).max(), _bin_errors(want, got64).max()
    print(f"[beam] {tag} max_rel_of_bin={err.max():.3e} (bin {int(err.argmax())}) "
          f"p99={np.quantile(err, 0.99):.3e} median={np.median(err):.3e} "
          f"port_vs_c128={err_port:.3e} jax_vs_c128={err_ref:.3e}")  # shown with pytest -s
    assert err.max() <= bound and np.quantile(err, 0.99) <= p99
    assert err_port <= 2.0 * err_ref + 1e-6


def _rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _check_spectrum(tag, got, want, bound=SPECTRUM_BOUND, got64=None):
    """A beamformed spectrum against the reference's (relative L2), and, given
    the port's complex128 run, no further from it than twice the reference."""
    assert got.shape == want.shape and np.all(np.isfinite(got.view(np.float32)))
    rel = _rel(got, want)
    extra = "" if got64 is None else (f" port_vs_c128={_rel(got, got64):.3e} "
                                      f"jax_vs_c128={_rel(want, got64):.3e}")
    print(f"[beam] {tag} rel_l2={rel:.3e}{extra}")
    assert rel <= bound, f"{tag}: relative L2 {rel:.3e}"
    if got64 is not None:
        assert _rel(got, got64) <= 2.0 * _rel(want, got64) + 1e-6


class _WhereSpy:
    """Stands in for a module's jnp or torch: everything is the module's,
    but where() records its condition, so a function's gates can be read
    decision by decision."""

    def __init__(self, mod):
        self._mod, self.conds = mod, []

    def __getattr__(self, name):
        return getattr(self._mod, name)

    def where(self, cond, *args):
        self.conds.append(cond)
        return self._mod.where(cond, *args)


def jax_gates(fn, modules, *args, **kw):
    """(output, [condition of each where()]) of the jitted reference fn."""
    spy = _WhereSpy(jnp)

    def run(*a):
        spy.conds.clear()
        with contextlib.ExitStack() as stack:
            for m in modules:
                stack.enter_context(mock.patch.object(m, "jnp", spy))
            out = fn(*a, **kw)
        return out, list(spy.conds)

    out, conds = jax.jit(run)(*args)
    return jax.tree_util.tree_map(np.asarray, out), [np.asarray(c) for c in conds]


def port_gates(fn, modules, *args, **kw):
    spy = _WhereSpy(torch)
    with contextlib.ExitStack() as stack:
        for m in modules:
            stack.enter_context(mock.patch.object(m, "torch", spy))
        out = fn(*args, **kw)
    out = tuple(o.numpy() for o in out) if isinstance(out, tuple) else out.numpy()
    return out, [c.numpy() for c in spy.conds]


def _differ(a, b):
    """Bins (the leading F axis) where two gate conditions disagree."""
    return int(np.any((a != b).reshape(a.shape[0], -1), axis=-1).sum())


# --- GEV ---------------------------------------------------------------------------------


@pytest.mark.parametrize("normalization", ["ban", "distortionless", "none"])
@pytest.mark.parametrize("M", MICS)
def test_gev_weights_match_jax(scenes, M, normalization):
    s = scenes[M]
    want, wconds = jax_gates(jax_gev.gev_weights, [jax_gev], s["R_t"], s["R_n"], s["d"],
                             normalization=normalization)
    got, gconds = port_gates(gev.gev_weights, [gev], T(s["R_t"]), T(s["R_n"]), T(s["d"]),
                             normalization=normalization)
    got64 = gev.gev_weights(T(s["R_t"], torch.complex128), T(s["R_n"], torch.complex128),
                            T(s["d"], torch.complex128), normalization=normalization).numpy()
    _check_weights(f"gev_weights M={M} {normalization}", got, want, got64)
    # M = 2: eig_principal_2x2's root choice, row choice and degeneracy;
    # M = 4: the power iteration's collapse guard at each of its 12 steps
    names = ["root", "row", "degenerate"] if M == 2 else [f"step{i}" for i in range(12)]
    assert len(gconds) == len(wconds) == (4 if M == 2 else 12)
    flips = {n: _differ(g, w) for n, g, w in zip(names, gconds, wconds)}
    print(f"[gates] gev M={M} {normalization} bins deciding differently: {flips}")
    assert sum(flips.values()) == 0


@pytest.mark.parametrize("M", MICS)
def test_gev_beamform_matches_jax(scenes, M):
    s = scenes[M]
    want = np.asarray(jax.jit(jax_gev.gev_beamform)(s["Y"], s["tgt"]))
    got = gev.gev_beamform(T(s["Y"]), T(s["tgt"])).numpy()
    _check_spectrum(f"gev_beamform M={M}", got, want)


@pytest.mark.parametrize("fov", [3.0, 20.0])
@pytest.mark.parametrize("M", MICS)
def test_max_snr_fov_beamform_matches_jax(scenes, M, fov):
    s = scenes[M]
    fn = jax.jit(jax_gev.max_snr_fov_beamform, static_argnums=(3, 4, 5))
    want = np.asarray(fn(s["Y"], s["noise"], s["freqs"], 90.0, fov, 0.04))
    got = gev.max_snr_fov_beamform(T(s["Y"]), T(s["noise"]), T(s["freqs"]), 90.0, fov,
                                   0.04).numpy()
    _check_spectrum(f"max_snr_fov_beamform M={M} fov={fov}", got, want)
    R_want = np.asarray(jax_gev.fov_target_covariance(s["freqs"], 90.0, fov, 0.04, n_mics=M))
    R_got = gev.fov_target_covariance(T(s["freqs"]), 90.0, fov, 0.04, n_mics=M).numpy()
    assert float(np.abs(R_got - R_want).max()) <= 1e-5


def test_gev_rejects_unknown_normalization(scenes):
    s = scenes[2]
    with pytest.raises(ValueError, match="distortionless normalization needs d_tgt"):
        gev.gev_weights(T(s["R_t"]), T(s["R_n"]), normalization="distortionless")
    with pytest.raises(ValueError, match="unknown normalization"):
        gev.gev_weights(T(s["R_t"]), T(s["R_n"]), normalization="nope")


def _cut_matrices():
    """Real 2x2 matrices (complex64, imaginary parts +0 or -0) with entries
    in {-2, -1, 1, 3}: 4,096 in all, 1,344 with a negative discriminant,
    whose two eigenvalues are a conjugate pair of equal magnitude, so the
    root is picked by the sign of disc's imaginary part."""
    import itertools

    vals = np.array([-2.0, -1.0, 1.0, 3.0], np.float32)
    re = np.array(list(itertools.product(vals, repeat=4)), np.float32)
    sg = np.array(list(itertools.product([0.0, -0.0], repeat=4)), np.float32)
    A = np.empty((len(re) * len(sg), 4), np.complex64)
    A.real = np.repeat(re, len(sg), axis=0)
    A.imag = np.tile(sg, (len(re), 1))
    return A.reshape(-1, 2, 2)


def test_eig_principal_on_the_branch_cut_matches_jax():
    A = _cut_matrices()
    tr, det = A[:, 0, 0] + A[:, 1, 1], A[:, 0, 0] * A[:, 1, 1] - A[:, 0, 1] * A[:, 1, 0]
    on_cut = (tr * tr - 4 * det).real < 0
    assert on_cut.sum() == 1344
    want = np.asarray(jax.jit(jax_gev.eig_principal_2x2)(A))
    got = gev.eig_principal_2x2(T(A)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # the same root as the reference: +i sqrt|z| on the cut, whatever the
    # sign of the operand's imaginary zero (torch.sqrt alone takes -i sqrt|z|
    # for an imaginary -0, as C99 csqrt does)
    z = torch.complex(torch.tensor([-4.0, -4.0]), torch.tensor([0.0, -0.0]))
    assert torch.equal(csqrt_cut(z), torch.tensor([2j, 2j], dtype=torch.complex64))
    assert torch.sqrt(z)[1] == -2j
    np.testing.assert_array_equal(np.asarray(jnp.sqrt(jnp.asarray(z.numpy()) + 0j)), [2j, 2j])


# --- RTF ---------------------------------------------------------------------------------


@pytest.mark.parametrize("M", MICS)
def test_rtf_from_covariances_matches_jax(scenes, M):
    s = scenes[M]
    (a_want, c_want), _ = jax_gates(jax_rtf.rtf_from_covariances, [], s["R_t"], s["R_n"])
    a_got, c_got = (x.numpy() for x in rtf.rtf_from_covariances(T(s["R_t"]), T(s["R_n"])))
    a64, c64 = (x.numpy() for x in rtf.rtf_from_covariances(T(s["R_t"], torch.complex128),
                                                            T(s["R_n"], torch.complex128)))
    _check_weights(f"rtf_from_covariances M={M}", a_got, a_want, a64)
    c_err, c_port, c_ref = (float(np.abs(a - b).max()) for a, b in
                            ((c_got, c_want), (c_got, c64), (c_want, c64)))
    print(f"[beam] rtf conf M={M} max_abs={c_err:.3e} median={np.median(np.abs(c_got - c_want)):.3e} "
          f"port_vs_c128={c_port:.3e} jax_vs_c128={c_ref:.3e}")
    assert c_err <= 2e-2 and float(np.median(np.abs(c_got - c_want))) <= 1e-4
    assert c_port <= 2.0 * c_ref + 1e-6


@pytest.mark.parametrize("fallback", [True, False])
@pytest.mark.parametrize("M", MICS)
def test_rtf_mvdr_beamform_matches_jax(scenes, M, fallback):
    s = scenes[M]
    kw = dict(target_mask=s["tgt"], mask_floor=0.05)
    d = s["d"] if fallback else None
    want, wconds = jax_gates(jax_rtf.rtf_mvdr_beamform, [jax_rtf, jax_gev], s["Y"], s["noise"],
                             s["freqs"], d_fallback=d, **kw)
    got, gconds = port_gates(rtf.rtf_mvdr_beamform, [rtf, gev], T(s["Y"]), T(s["noise"]),
                             T(s["freqs"]), d_fallback=None if d is None else T(d),
                             **{k: T(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()})
    got64 = rtf.rtf_mvdr_beamform(
        T(s["Y"], torch.complex128), T(s["noise"], torch.float64), T(s["freqs"]),
        d_fallback=None if d is None else T(d, torch.complex128),
        target_mask=T(s["tgt"], torch.float64), mask_floor=0.05).numpy()
    _check_spectrum(f"rtf_mvdr_beamform M={M} fallback={fallback}", got, want,
                    RTF_SPECTRUM_BOUND, got64)
    # eig_principal_2x2's root and row choices and degeneracy (M = 2) or the
    # power iteration's 12 collapse guards (M = 4), the confidence gate that
    # picks the RTF or the geometric steering, the high-pass
    names = (["root", "row", "degenerate", "degenerate_v"] if M == 2
             else [f"step{i}" for i in range(12)]) + (["conf"] if fallback else []) + ["keep"]
    assert len(gconds) == len(wconds) == len(names)
    flips = {n: _differ(g, w) for n, g, w in zip(names, gconds, wconds)}
    if fallback:
        flips["rtf_bins"] = int(wconds[-2].all(-1).sum())
    print(f"[gates] rtf M={M} fallback={fallback}: {flips}")
    # the port's own covariances differ from the reference's by ulps: on this
    # scene 1 of 513 bins takes the other steering at M = 2, and eig's row
    # choice differs in 3 (both rows give the eigenvector, up to the phase
    # the reference-mic normalisation removes)
    assert flips.get("conf", 0) <= 1 and flips["keep"] == 0
    assert sum(v for k, v in flips.items() if k not in ("conf", "rtf_bins")) <= 3


def test_rtf_post_filter_options(scenes):
    """target_mask omitted: no post-filter; apply_post_filter=False keeps the
    covariance split and skips the multiply."""
    s = scenes[2]
    Y, n, f, t = T(s["Y"]), T(s["noise"]), T(s["freqs"]), T(s["tgt"])
    bare = rtf.rtf_mvdr_beamform(Y, n, f, target_mask=t, apply_post_filter=False)
    floored = rtf.rtf_mvdr_beamform(Y, n, f, target_mask=t, mask_floor=0.1)
    assert torch.allclose(floored, bare * torch.clamp(t, min=0.1))
    want = np.asarray(jax.jit(jax_rtf.rtf_mvdr_beamform)(s["Y"], s["noise"], s["freqs"]))
    got64 = rtf.rtf_mvdr_beamform(T(s["Y"], torch.complex128), T(s["noise"], torch.float64),
                                  f).numpy()
    _check_spectrum("rtf_mvdr_beamform no target_mask", rtf.rtf_mvdr_beamform(Y, n, f).numpy(),
                    want, RTF_SPECTRUM_BOUND, got64)


# --- RMVB --------------------------------------------------------------------------------


def _rmvb_flips(gconds, wconds):
    """The bins where the 30 bisection steps, has_root and use_nominal decide
    differently, and the first step at which any bisection differs."""
    differ = np.stack(gconds[0:60:2]) != np.stack(wconds[0:60:2])  # (30 steps, F)
    bins = differ.any(axis=0)
    return dict(bisection_bins=int(bins.sum()),
                first_step_min=int(differ.argmax(axis=0)[bins].min()) if bins.any() else None,
                steps_differing=differ.sum(axis=1).tolist(),
                has_root=_differ(gconds[60], wconds[60]),
                use_nominal=_differ(gconds[61], wconds[61]),
                no_root_bins=int((~wconds[60]).sum()))


@pytest.mark.parametrize("M", MICS)
def test_rmvb_weights_match_jax(scenes, M):
    s = scenes[M]
    want, wconds = jax_gates(jax_rmvb.rmvb_weights, [jax_rmvb], s["R_t"], s["d"],
                             R_solve=s["R_n"])
    got, gconds = port_gates(rmvb.rmvb_weights, [rmvb], T(s["R_t"]), T(s["d"]),
                             R_solve=T(s["R_n"]))
    got64 = rmvb.rmvb_weights(T(s["R_t"], torch.complex128), T(s["d"], torch.complex128),
                              R_solve=T(s["R_n"], torch.complex128)).numpy()
    _check_weights(f"rmvb_weights M={M}", got, want, got64)
    assert len(gconds) == len(wconds) == 62
    flips = _rmvb_flips(gconds, wconds)
    print(f"[gates] rmvb M={M}: {flips}")
    # the guards decide alike; the bisections agree for their first 10 steps
    # and part only where mid lands within float32 noise of the root
    assert flips["has_root"] == 0 and flips["use_nominal"] == 0
    assert flips["first_step_min"] is None or flips["first_step_min"] >= 10


@pytest.mark.parametrize("M", MICS)
def test_rmvb_beamform_matches_jax(scenes, M):
    s = scenes[M]
    want = np.asarray(jax.jit(jax_rmvb.rmvb_beamform)(s["Y"], s["noise"], s["d"], s["freqs"]))
    got = rmvb.rmvb_beamform(T(s["Y"]), T(s["noise"]), T(s["d"]), T(s["freqs"])).numpy()
    _check_spectrum(f"rmvb_beamform M={M}", got, want)


def test_rmvb_no_root_keeps_the_nominal_steering():
    """A rank-1 R (one coherent source, the nominal steering off it): the
    bracket has no root on either side, and the weights are the MVDR
    weights of the nominal steering on R_solve, as the reference's."""
    v = np.array([[1.0, 0.3 + 0.4j]], np.complex64)
    R = np.einsum("fi,fj->fij", v, v.conj()).astype(np.complex64)
    R_solve = np.array([[[1.0, 0.2 - 0.1j], [0.2 + 0.1j, 0.8]]], np.complex64)
    d = (np.array([[-(0.3 - 0.4j), 1.0]]) * np.sqrt(2 / 1.25)).astype(np.complex64)  # d _|_ v
    want, wconds = jax_gates(jax_rmvb.rmvb_weights, [jax_rmvb], R, d, R_solve=R_solve)
    got, gconds = port_gates(rmvb.rmvb_weights, [rmvb], T(R), T(d), R_solve=T(R_solve))
    assert not wconds[60].any() and not gconds[60].any()  # has_root
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got, mvdr_weights(T(R_solve), T(d)).numpy(), rtol=1e-6)


# --- WPD ---------------------------------------------------------------------------------


@pytest.mark.parametrize("taps,delay", [(0, 2), (2, 2), (8, 2), (3, 70)])
def test_stack_delayed_frames_matches_jax(scenes, taps, delay):
    Y = scenes[2]["Y"]
    want = np.asarray(jax_wpd.stack_delayed_frames(Y, taps, delay))
    got = wpd.stack_delayed_frames(T(Y), taps, delay).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("M", MICS)
def test_wpd_weights_match_jax(scenes, M):
    s = scenes[M]
    Ybar = np.asarray(jax_wpd.stack_delayed_frames(s["Y"], 8, 2))
    power = np.mean(np.abs(s["Y"]) ** 2, axis=0)
    w_t = (np.maximum(1.0 - s["tgt"], 0.05) / np.maximum(s["tgt"] * power, 1e-3 * power.mean()))
    w_t = w_t.astype(np.float32)
    want = np.asarray(jax.jit(jax_wpd.wpd_weights)(Ybar, w_t, s["d"]))
    got = wpd.wpd_weights(T(Ybar), T(w_t), T(s["d"])).numpy()
    got64 = wpd.wpd_weights(T(Ybar, torch.complex128), T(w_t, torch.float64),
                            T(s["d"], torch.complex128)).numpy()
    # the loaded (2 (taps + 1))^2 solves by LU: ~1e-3 of conditioning (module docstring)
    _check_weights(f"wpd_weights M={M}", got, want, got64, bound=1e-2, p99=5e-3)


@pytest.mark.parametrize("iterations", [1, 2])
@pytest.mark.parametrize("taps", [0, 8])
@pytest.mark.parametrize("M", MICS)
def test_wpd_beamform_matches_jax(scenes, M, taps, iterations):
    s = scenes[M]
    want = np.asarray(jax_wpd.wpd_beamform(s["Y"], s["tgt"], s["d"], s["freqs"], taps=taps,
                                           iterations=iterations))
    got = wpd.wpd_beamform(T(s["Y"]), T(s["tgt"]), T(s["d"]), T(s["freqs"]), taps=taps,
                           iterations=iterations).numpy()
    _check_spectrum(f"wpd_beamform M={M} taps={taps} iterations={iterations}", got, want)


@pytest.mark.parametrize("mask_floor", [0.05, 0.0])
@pytest.mark.parametrize("M", MICS)
def test_masked_wpd_matches_jax(scenes, M, mask_floor):
    s = scenes[M]
    fn = jax.jit(jax_wpd.masked_wpd, static_argnames=("mask_floor",))
    want = np.asarray(fn(s["Y"], s["tgt"], s["d"], s["freqs"], mask_floor=mask_floor))
    got = wpd.masked_wpd(T(s["Y"]), T(s["tgt"]), T(s["d"]), T(s["freqs"]),
                         mask_floor=mask_floor).numpy()
    _check_spectrum(f"masked_wpd M={M} mask_floor={mask_floor}", got, want)


def test_wpd_per_chunk_steering(scenes):
    """d of shape (C, F, M), one per chunk (the tracked path): chunk c equals
    the call with that chunk's d shared."""
    s = scenes[2]
    Y = np.stack([s["Y"], s["Y"][:, :, ::-1]])
    m = np.stack([s["tgt"], s["tgt"][:, ::-1]])
    d = np.stack([s["d"], np.asarray(jax_steering_vector(s["freqs"], 60.0, 0.04))])
    both = wpd.wpd_beamform(T(Y), T(m), T(d), T(s["freqs"]))
    for c in range(2):
        one = wpd.wpd_beamform(T(Y[c]), T(m[c]), T(d[c]), T(s["freqs"]))
        torch.testing.assert_close(both[c], one, rtol=1e-5, atol=1e-6)


# --- silence -----------------------------------------------------------------------------


def test_wpd_finite_on_silence():
    """tests/test_wpd.py::test_wpd_finite_on_silence as a parity case: an
    all-zero STFT and mask give a finite output, equal to the reference's."""
    freqs = jax_rfft_freqs(512, 16000)
    d = np.asarray(jax_steering_vector(freqs, 90.0, 0.08, 343.0, 2))
    Y, mask = np.zeros((2, 257, 60), np.complex64), np.zeros((257, 60), np.float32)
    want = np.asarray(jax_wpd.wpd_beamform(Y, mask, d, freqs))
    got = wpd.wpd_beamform(T(Y), T(mask), T(d), T(np.asarray(freqs))).numpy()
    assert np.all(np.isfinite(got.view(np.float32)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("M", MICS)
def test_silent_input_matches_jax(scenes, M):
    """An all-zero recording through each beamformer: finite or not in the
    same places as the reference, equal where finite."""
    s = scenes[M]
    Y = np.zeros_like(s["Y"])
    cases = {
        "gev": (jax.jit(jax_gev.gev_beamform), gev.gev_beamform, (Y, s["tgt"])),
        "rtf": (jax.jit(jax_rtf.rtf_mvdr_beamform), rtf.rtf_mvdr_beamform,
                (Y, s["noise"], s["freqs"])),
        "rmvb": (jax.jit(jax_rmvb.rmvb_beamform), rmvb.rmvb_beamform,
                 (Y, s["noise"], s["d"], s["freqs"])),
        "wpd": (jax_wpd.wpd_beamform, wpd.wpd_beamform, (Y, s["tgt"], s["d"], s["freqs"])),
    }
    for name, (ref_fn, fn, args) in cases.items():
        want = np.asarray(ref_fn(*args))
        got = fn(*(T(a) for a in args)).numpy()
        fin = np.isfinite(want)
        print(f"[beam] silent {name} M={M} finite={int(fin.sum())} of {fin.size}")
        np.testing.assert_array_equal(np.isfinite(got), fin)
        np.testing.assert_array_equal(got[fin], want[fin])
