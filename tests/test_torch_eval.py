"""The port's measurement layer on the CPU against the JAX package: STOI
(azoom_torch.eval.stoi), BSS-eval (eval.bss), resampling (dsp.resample) and
the STFT parameter search (dsp.params, dsp.windows' NOLA check).

Bounds (ROADMAP.md Queue C, "The measurement layer"):
- STOI: within 1e-5 of azoom.eval.stoi.stoi and of the independent NumPy
  STOI of tests/stoi_reference.py (the golden test's bound), on AWGN at 20, 0
  and -5 dB and on the pause scene of tests/test_stoi_golden.py. Measured:
  <= 1.2e-7 (no frame of these scenes lies near the 40 dB gate). A batch of
  clips equals the clips scored one by one.
- Resampling: relative max error 1e-5 against the reference on (2, n) noise
  (measured <= 3.6e-7; the port is float64 inside, the reference float32),
  with the reference's output lengths, including the right-pad regressions
  n = 137815, up = 20, down = 17 and integer upsampling up = 3, down = 1.
- BSS-eval: the (S L)^2 float32 solve of delayed speech-like sources is
  nearly singular, so SDR and SIR are held in dB to "no further from a
  float64 run of the port than twice the reference's own distance from it,
  plus 1e-4 dB" (measured: the port <= 1.2e-5 dB, the reference <= 9.5e-5),
  and to 1e-3 dB from the reference. SAR is held likewise only where the
  estimate carries independent noise: where it lies in the sources' span,
  SAR is the ratio to float32 rounding (101-124 dB here, 5-23 dB apart
  between runs) and only its size is checked.
- choose_best_stft_params: the same candidate pairs pass NOLA and the
  latency bound; every MSE is under the reference test's 1e-8; ``best`` is
  held only where the reference's margin between its best and second-best
  pair exceeds 1e-10 (every NOLA pair reconstructs to ~1e-14 in both, so
  the argmin is round-off otherwise).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stoi_reference import stoi_ref

from azoom.dsp.params import choose_best_stft_params as jax_choose
from azoom.dsp.resample import resample_fft as jax_resample_fft
from azoom.dsp.resample import resample_poly as jax_resample_poly
from azoom.dsp.windows import check_nola as jax_check_nola
from azoom.dsp.windows import hann_np as jax_hann_np
from azoom.eval.bss import bss_eval_sources as jax_bss
from azoom.eval.stoi import stoi as jax_stoi
from azoom.sim.signals import speech_like, speech_like_batch
from azoom_torch.dsp.params import choose_best_stft_params, stft_reconstruct_mse
from azoom_torch.dsp.resample import resample_fft, resample_poly
from azoom_torch.dsp.windows import check_nola, hann_np
from azoom_torch.eval import bss_eval_sources, stoi
from azoom_torch.eval.bss import _bss_eval

FS = 16_000
STOI_BOUND = 1e-5
RESAMPLE_BOUND = 1e-5
BSS_FLOOR_DB = 1e-4
BSS_VS_REFERENCE_DB = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU work in one thread while this file runs (the suite's
    other workers share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _awgn(snr_db):
    rng = np.random.default_rng(snr_db + 100)
    s = np.asarray(speech_like(jax.random.PRNGKey(0), 48_000, FS, 140.0))
    noise = rng.standard_normal(48_000).astype(np.float32)
    noise *= np.linalg.norm(s) / np.linalg.norm(noise) * 10 ** (-snr_db / 20)
    return s, s + noise


def _pauses():
    rng = np.random.default_rng(7)
    s = np.asarray(speech_like(jax.random.PRNGKey(1), 48_000, FS, 170.0)).copy()
    s[8_000:16_000] = 0.0
    s[30_000:40_000] = 0.0
    noise = rng.standard_normal(48_000).astype(np.float32)
    noise *= 0.05 * np.abs(s).max()
    return s, s + noise


STOI_SCENES = {"awgn20": lambda: _awgn(20), "awgn0": lambda: _awgn(0),
               "awgn-5": lambda: _awgn(-5), "pauses": _pauses}


@pytest.mark.parametrize("scene", list(STOI_SCENES))
def test_stoi_matches_jax_and_the_numpy_reference(scene):
    clean, degraded = STOI_SCENES[scene]()
    got = stoi(clean, degraded, FS, device="cpu")
    assert got.dtype == torch.float32 and got.shape == ()
    ref = float(jax_stoi(jnp.asarray(clean), jnp.asarray(degraded), FS))
    golden = stoi_ref(clean, degraded, FS)
    print(f"[parity] stoi {scene} port={float(got):.7f} jax={ref:.7f} numpy={golden:.7f}")
    assert abs(float(got) - ref) <= STOI_BOUND
    assert abs(float(got) - golden) <= STOI_BOUND
    assert 0.0 < float(got) < 1.0


def test_stoi_scores_a_batch_clip_by_clip():
    pairs = [STOI_SCENES[k]() for k in ("awgn20", "awgn-5", "pauses")]
    clean = np.stack([p[0] for p in pairs])[:, None].repeat(2, axis=1)  # (3, 2, n)
    degraded = np.stack([p[1] for p in pairs])[:, None].repeat(2, axis=1)
    degraded[:, 1] *= 0.5  # a scaled copy: STOI is scale-invariant
    got = stoi(torch.from_numpy(clean), torch.from_numpy(degraded), FS)
    assert got.shape == (3, 2)
    one = torch.stack([stoi(torch.from_numpy(c), torch.from_numpy(d), FS)
                       for c, d in pairs])
    np.testing.assert_allclose(got[:, 0].numpy(), one.numpy(), rtol=0, atol=1e-7)
    np.testing.assert_allclose(got[:, 1].numpy(), one.numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("n,up,down", [(137_815, 20, 17), (16_000, 3, 1), (48_000, 5, 8),
                                       (1_000, 10, 16), (4_000, 4, 4)])
def test_resample_poly_matches_jax(n, up, down):
    x = np.random.default_rng(n).standard_normal((2, n)).astype(np.float32)
    ref = np.asarray(jax_resample_poly(jnp.asarray(x), up, down))
    got = resample_poly(x, up, down, device="cpu")
    assert got.dtype == torch.float32 and got.shape == ref.shape == (2, -(-n * up // down))
    err = float(np.abs(got.numpy() - ref).max() / np.abs(ref).max())
    print(f"[parity] resample_poly n={n} {up}/{down} rel_max={err:.3e}")
    assert err <= RESAMPLE_BOUND


@pytest.mark.parametrize("n,n_out", [(48_000, 30_000), (16_000, 48_000), (1_001, 640),
                                     (1_000, 1_001)])
def test_resample_fft_matches_jax(n, n_out):
    x = np.random.default_rng(n_out).standard_normal((2, n)).astype(np.float32)
    ref = np.asarray(jax_resample_fft(jnp.asarray(x), n_out))
    got = resample_fft(torch.from_numpy(x), n_out)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    err = float(np.abs(got.numpy() - ref).max() / np.abs(ref).max())
    print(f"[parity] resample_fft {n}->{n_out} rel_max={err:.3e}")
    assert err <= RESAMPLE_BOUND


@pytest.fixture(scope="module")
def bss_scene():
    S = np.asarray(speech_like_batch(jax.random.PRNGKey(3), 3, 16_000, FS))
    rng = np.random.default_rng(0)
    h = np.array([0.0] * 7 + [0.9, 0.3, -0.1], np.float32)  # a delay and a colouring
    noise = rng.standard_normal(16_000).astype(np.float32)
    estimates = {  # name: (estimate, carries independent noise)
        "filtered": ((np.convolve(S[0], h)[:16_000] + 0.01 * noise).astype(np.float32), True),
        "mixture": ((S[0] + 0.3 * S[1] + 0.05 * noise).astype(np.float32), True),
        "in_span": ((S[0] + 0.1 * S[1]).astype(np.float32), False),
    }
    return S, estimates


@pytest.mark.parametrize("filter_len", [64, 512])
@pytest.mark.parametrize("target_index", [0, 1])
def test_bss_eval_matches_jax(bss_scene, target_index, filter_len):
    S, estimates = bss_scene
    for name, (e, noisy) in estimates.items():
        ref = {k: float(v) for k, v in jax_bss(jnp.asarray(S), jnp.asarray(e),
                                                target_index=target_index,
                                                filter_len=filter_len).items()}
        got = bss_eval_sources(S, e, target_index=target_index, filter_len=filter_len,
                               device="cpu")
        assert all(v.dtype == torch.float32 and v.shape == () for v in got.values())
        got = {k: float(v) for k, v in got.items()}
        exact = {k: float(v) for k, v in _bss_eval(
            torch.from_numpy(S).double(), torch.from_numpy(e).double(), target_index,
            filter_len, 1e-10).items()}
        for k in ("sdr", "sir", "sar") if noisy else ("sdr", "sir"):
            d_port, d_ref = abs(got[k] - exact[k]), abs(ref[k] - exact[k])
            print(f"[parity] bss {name} t{target_index} L{filter_len} {k}: port {got[k]:.5f} "
                  f"jax {ref[k]:.5f} float64 {exact[k]:.5f} |port-f64| {d_port:.2e} "
                  f"|jax-f64| {d_ref:.2e}")
            assert d_port <= 2 * d_ref + BSS_FLOOR_DB, (name, k)
            assert abs(got[k] - ref[k]) <= BSS_VS_REFERENCE_DB, (name, k)
        if not noisy:
            assert got["sar"] > 80.0 and ref["sar"] > 80.0  # float32 rounding, not artifacts
    # the target's own delayed, coloured copy scores high; the other source low
    clean = bss_eval_sources(torch.from_numpy(S), torch.from_numpy(estimates["filtered"][0]),
                             target_index=target_index, filter_len=filter_len)
    assert (float(clean["sdr"]) > 20.0) == (target_index == 0)


def test_windows_helpers_match_jax():
    for n in (256, 512, 1000):
        np.testing.assert_array_equal(hann_np(n), jax_hann_np(n))
    for n, hop in [(256, 128), (512, 384), (512, 512), (1024, 1100), (1000, 250)]:
        assert check_nola(hann_np(n), hop) == jax_check_nola(jax_hann_np(n), hop)


@pytest.mark.parametrize("max_latency", [None, 600])
def test_choose_best_stft_params_matches_jax(max_latency):
    x = np.random.default_rng(0).standard_normal(8_000).astype(np.float32)
    ref = jax_choose(jnp.asarray(x), max_latency_samples=max_latency)
    got = choose_best_stft_params(x, max_latency_samples=max_latency, device="cpu")
    assert list(got["results"]) == list(ref["results"])
    assert all(mse < 1e-8 for mse in got["results"].values())
    mses = sorted(ref["results"].values())
    margin = mses[1] - mses[0] if len(mses) > 1 else np.inf
    print(f"[parity] choose_best max_latency={max_latency} port {got['best']} "
          f"jax {ref['best']} reference margin {margin:.2e}")
    if margin > 1e-10:
        assert got["best"] == ref["best"]
    assert got["best"] in got["results"]
    assert stft_reconstruct_mse(torch.from_numpy(x), 1024, 512) < 1e-10
    with pytest.raises(ValueError, match="no valid"):
        choose_best_stft_params(x, candidates=((512, 600),), device="cpu")
