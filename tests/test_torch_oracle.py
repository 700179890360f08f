"""Parity of the port's oracle path (azoom_torch.masks.oracle,
eval.projection, pipelines.oracle) with azoom's (CPU).

Scenes: 2 s speech-like target at 90 deg and interferers at 40 and 130 deg,
4 cm, seeds 7 and 13, as one batch of two. Bounds: masks and metrics to
float32 rounding; the enhanced SIR within 0.01 dB of the JAX pipeline's
(ROADMAP Queue A item 4). The SIR level itself is printed, not asserted:
it depends on the scene (about 30 dB binary and 17 dB IRM here).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from azoom.config import PipelineConfig as JaxConfig
from azoom.dsp.stft import stft as jax_stft
from azoom.eval.projection import osinr_osir as jax_osinr_osir
from azoom.eval.projection import sdr_sir as jax_sdr_sir
from azoom.eval.projection import sir_improvement_db as jax_sir_improvement
from azoom.masks import oracle as jax_masks
from azoom.pipelines.oracle import heuristic_enhance as jax_heuristic
from azoom.pipelines.oracle import oracle_enhance as jax_oracle
from azoom.sim.farfield import make_scene
from azoom.sim.signals import speech_like_batch
from azoom_torch import kernels
from azoom_torch.config import PipelineConfig
from azoom_torch.eval.projection import osinr_osir, sdr_sir, sir_improvement_db
from azoom_torch.masks import oracle as masks
from azoom_torch.pipelines.oracle import heuristic_enhance, oracle_enhance

MIC = 0.04


@pytest.fixture(scope="module")
def scenes():
    out = []
    for seed in (7, 13):
        sigs = speech_like_batch(jax.random.PRNGKey(seed), 3, 32_000, 16_000)
        out.append(make_scene(sigs[0], sigs[1:], 90.0, jnp.array([40.0, 130.0]), MIC, 16_000))
    return {k: np.stack([np.asarray(s[k]) for s in out]) for k in out[0]}


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("name", ["ibm_noise_mask", "ibm_target_mask", "irm_target_mask",
                                  "wiener_target_mask"])
def test_masks_match_jax(scenes, name):
    S_t = np.asarray(jax_stft(scenes["target_ref"], 1024, 512))
    S_i = np.asarray(jax_stft(scenes["interference_ref"], 1024, 512))
    got = getattr(masks, name)(_t(S_t), _t(S_i)).numpy()
    ref = np.asarray(getattr(jax_masks, name)(S_t, S_i))
    assert got.dtype == np.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)


def test_metrics_match_jax(scenes):
    rng = np.random.default_rng(0)
    out = (scenes["target_ref"] + 0.1 * scenes["interference_ref"]
           + 0.01 * rng.standard_normal(scenes["target_ref"].shape)).astype(np.float32)
    args = (out, scenes["target_ref"], scenes["interference_ref"])
    for fn, jfn in ((osinr_osir, jax_osinr_osir), (sdr_sir, jax_sdr_sir)):
        for got, ref in zip(fn(*map(_t, args)), jfn(*args)):
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)
    imp = sir_improvement_db(_t(out), _t(scenes["mixture"][:, 0]), *map(_t, args[1:]))
    ref = jax_sir_improvement(out, scenes["mixture"][:, 0], *args[1:])
    np.testing.assert_allclose(imp.numpy(), np.asarray(ref), atol=1e-4)


def _sirs(out, sc):
    return np.asarray(jax_osinr_osir(jnp.asarray(out), sc["target_ref"], sc["interference_ref"])[1])


@pytest.mark.parametrize("post_filter", ["binary", "irm", "none", "heuristic"])
def test_pipeline_matches_jax(scenes, post_filter):
    sc = scenes
    if post_filter == "heuristic":
        ref = np.asarray(jax_heuristic(jnp.asarray(sc["mixture"]), JaxConfig(mic_dist=MIC)))
        got = heuristic_enhance(_t(sc["mixture"]), PipelineConfig(mic_dist=MIC)).numpy()
    else:
        ref = np.asarray(jax_oracle(jnp.asarray(sc["mixture"]), sc["target_ref"],
                                    sc["interference_ref"], JaxConfig(mic_dist=MIC),
                                    post_filter=post_filter))
        got = oracle_enhance(_t(sc["mixture"]), _t(sc["target_ref"]), _t(sc["interference_ref"]),
                             PipelineConfig(mic_dist=MIC), post_filter=post_filter).numpy()
    assert got.shape == ref.shape == sc["target_ref"].shape
    sir_got = osinr_osir(_t(got), _t(sc["target_ref"]), _t(sc["interference_ref"]))[1].numpy()
    sir_ref = _sirs(ref, sc)
    print(f"[oracle] {post_filter}: SIR port {np.round(sir_got, 3)} dB, JAX {np.round(sir_ref, 3)} "
          f"dB, waveform rel L2 {np.linalg.norm(got - ref) / np.linalg.norm(ref):.2e}")
    np.testing.assert_allclose(sir_got, sir_ref, atol=0.01)


def test_numpy_input_defaults_to_cuda(scenes):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        heuristic_enhance(scenes["mixture"], PipelineConfig(mic_dist=MIC))
    before = dict(kernels.launches)
    out = heuristic_enhance(scenes["mixture"][0, :, :8000], PipelineConfig(mic_dist=MIC),
                            device="cpu")
    assert out.shape == (8000,) and kernels.launches == before
