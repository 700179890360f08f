"""End-to-end parity of the port's learned serving path (bundled int8
tpufpu_nano + masked MVDR or hybrid hard-null, with and without the FOV
gate, whole-signal and chunked) with azoom.pipelines.learned (CPU), plus the
port's import and device guards.

Scene: 1 s, target at the steer angle, interferers at 40 and 130 deg. Each
MVDR case runs against JAX with use_pallas=False and with the Pallas MVDR
kernel in interpret mode; the hard-null and FOV-gated cases against
use_pallas=False, the XLA function the port's hard-null kernel computes
(tests/test_torch_nullsteer.py says why not the Pallas one). The streaming
cases run a 5 s clip through the 2 s / 50 % chunker of both packages.

Bounds: SIR (azoom.eval.projection.osinr_osir) within 0.05 dB of the JAX
SIR; waveform relative L2 <= 1e-2 at steer 90 and 60 deg, with hard-null
and with the FOV gate.

Bounds: SIR (azoom.eval.projection.osinr_osir) within 0.05 dB of the JAX
SIR; waveform relative L2 <= 1e-2 at steer 90 and 60 deg. Under geometry
adaptation (1 cm array, features rescaled by 4) the waveform bound is 3e-2:
the port's STFT and the reference's differ by float32 roundings (~2e-8), the
rescaled phase features amplify that in quiet bins, and the int8 net turns
it into a few flipped activation codes. That is the reference's own floor:
its output moves by more than 1e-2 when its input moves by one ulp
(test_reference_moves_more_than_1e_2_under_one_ulp below).

The 5 s streaming cases are held to 2e-2. Their 2 s chunks go through the
int8 net with T = 64 frames, and there the port and JAX part at the
bottleneck's last residual block even on identical features: the port's
BatchNorm multiplier takes the correctly rounded 1/sqrt(var + eps), XLA's
CPU rsqrt differs from it by an ulp in 358 of the net's 2,688 channels, and
the ulps flip int8 codes (measured on chunk 3 of the seed-11 clip: mask max
5.6e-2 on the same features, waveform 1.2e-2). The reference moves by as
much when its BatchNorm variances move by one ulp
(test_reference_moves_under_one_ulp_of_batchnorm below).
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from azoom.config import PipelineConfig as JaxConfig
from azoom.eval.projection import osinr_osir
from azoom.models.pretrained import load_bundled as jax_load_bundled
from azoom.pipelines.learned import learned_enhance as jax_learned_enhance
from azoom.pipelines.learned import learned_enhance_streaming as jax_learned_streaming
from azoom.sim.farfield import make_scene
from azoom.sim.signals import speech_like_batch
from azoom_torch import learned_enhance, learned_enhance_streaming, load_bundled
from azoom_torch.config import PipelineConfig
from azoom_torch.models.pretrained import bundled_train_mic_dist, geo_adapt_dist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = {  # name: (steer deg, mic spacing, train_mic_dist, waveform bound)
    "steer90": (90.0, 0.04, None, 1e-2),
    "steer60": (60.0, 0.04, None, 1e-2),
    "geo_adapt": (90.0, 0.01, 0.04, 3e-2),
}


@pytest.fixture(scope="module")
def models():
    jm, jv, _ = jax_load_bundled("tpufpu_nano", quant=True)
    tm, _ = load_bundled("tpufpu_nano", device="cpu")
    return jm, jv, tm


# name: (beamformer, steer deg, fov deg); 4 cm, waveform bound 1e-2
HARD_NULL_FOV_CASES = {
    "hard_null_steer90": ("hard_null", 90.0, None),
    "hard_null_steer60": ("hard_null", 60.0, None),
    "mvdr_fov30": ("mvdr", 60.0, 30.0),
    "hard_null_fov30": ("hard_null", 60.0, 30.0),
}


def _scene(steer, mic_dist, seed=7, n=16000):
    sigs = speech_like_batch(jax.random.PRNGKey(seed), 3, n, 16000)
    sc = make_scene(sigs[0], sigs[1:], steer, jnp.array([40.0, 130.0]), mic_dist, 16000)
    return {k: np.asarray(v) for k, v in sc.items()}


def _sir(out, sc):
    return float(osinr_osir(jnp.asarray(out), sc["target_ref"], sc["interference_ref"])[1])


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("case", list(CASES))
def test_learned_enhance_matches_jax(models, case, use_pallas):
    jm, jv, tm = models
    steer, mic_dist, train_dist, wave_bound = CASES[case]
    sc = _scene(steer, mic_dist)
    ref = np.asarray(jax_learned_enhance(
        jnp.asarray(sc["mixture"]), jm, jv, JaxConfig(mic_dist=mic_dist),
        feature_kind="physics", steer_deg=steer, train_mic_dist=train_dist,
        use_pallas=use_pallas))
    got = learned_enhance(torch.tensor(sc["mixture"]), tm, PipelineConfig(mic_dist=mic_dist),
                          feature_kind="physics", steer_deg=steer,
                          train_mic_dist=train_dist).numpy()
    assert got.shape == ref.shape == sc["mixture"].shape[-1:]
    rel = float(np.linalg.norm(got - ref) / np.linalg.norm(ref))
    d_sir = _sir(got, sc) - _sir(ref, sc)
    print(f"[parity] {case} use_pallas={use_pallas} wave_rel_l2={rel:.3e} "
          f"sir_jax={_sir(ref, sc):.4f} dsir_db={d_sir:+.4f}")  # shown with pytest -s
    assert rel <= wave_bound, f"waveform relative L2 {rel:.3e}"
    assert abs(d_sir) <= 0.05


def _check_parity(tag, got, ref, sc, wave_bound=1e-2):
    assert got.shape == ref.shape == sc["mixture"].shape[-1:]
    rel = float(np.linalg.norm(got - ref) / np.linalg.norm(ref))
    d_sir = _sir(got, sc) - _sir(ref, sc)
    print(f"[parity] {tag} wave_rel_l2={rel:.3e} sir_jax={_sir(ref, sc):.4f} "
          f"dsir_db={d_sir:+.4f}")  # shown with pytest -s
    assert rel <= wave_bound, f"waveform relative L2 {rel:.3e}"
    assert abs(d_sir) <= 0.05


@pytest.mark.parametrize("case", list(HARD_NULL_FOV_CASES))
def test_hard_null_and_fov_match_jax(models, case):
    jm, jv, tm = models
    beamformer, steer, fov = HARD_NULL_FOV_CASES[case]
    sc = _scene(steer, 0.04)
    kw = dict(beamformer=beamformer, steer_deg=steer, fov_deg=fov)
    ref = np.asarray(jax_learned_enhance(jnp.asarray(sc["mixture"]), jm, jv, JaxConfig(mic_dist=0.04),
                                         feature_kind="physics", use_pallas=False, **kw))
    got = learned_enhance(torch.tensor(sc["mixture"]), tm, PipelineConfig(mic_dist=0.04),
                          feature_kind="physics", **kw)
    _check_parity(case, got.numpy(), ref, sc)


@pytest.mark.parametrize("beamformer", ["mvdr", "hard_null"])
def test_streaming_matches_jax(models, beamformer):
    jm, jv, tm = models
    sc = _scene(90.0, 0.04, seed=11, n=5 * 16000)
    ref = np.asarray(jax_learned_streaming(jnp.asarray(sc["mixture"]), jm, jv,
                                           JaxConfig(mic_dist=0.04), beamformer,
                                           feature_kind="physics"))
    got = learned_enhance_streaming(torch.tensor(sc["mixture"]), tm, PipelineConfig(mic_dist=0.04),
                                    beamformer, feature_kind="physics")
    _check_parity(f"streaming {beamformer}", got.numpy(), ref, sc, wave_bound=2e-2)


def test_reference_moves_under_one_ulp_of_batchnorm(models):
    jm, jv, _ = models
    sc = _scene(90.0, 0.04, seed=7, n=5 * 16000)
    nudged = dict(jv)
    nudged["batch_stats"] = jax.tree_util.tree_map_with_path(
        lambda path, v: np.nextafter(np.asarray(v, np.float32), np.float32(np.inf))
        if "var" in str(path[-1]) else v, jv["batch_stats"])
    a, b = (np.asarray(jax_learned_streaming(jnp.asarray(sc["mixture"]), jm, v,
                                             JaxConfig(mic_dist=0.04), "mvdr",
                                             feature_kind="physics")) for v in (jv, nudged))
    rel = float(np.linalg.norm(a - b) / np.linalg.norm(a))
    print(f"[parity] reference vs itself, BatchNorm variances moved by one ulp: "
          f"wave_rel_l2={rel:.3e}")
    assert rel > 5e-3


def test_reference_moves_more_than_1e_2_under_one_ulp(models):
    jm, jv, _ = models
    sc = _scene(90.0, 0.01, seed=13)
    mix = sc["mixture"]
    nudged = np.nextafter(mix, np.where(mix >= 0, np.float32(np.inf), np.float32(-np.inf)))
    cfg = JaxConfig(mic_dist=0.01)
    a, b = (np.asarray(jax_learned_enhance(jnp.asarray(m), jm, jv, cfg, feature_kind="physics",
                                           train_mic_dist=0.04)) for m in (mix, nudged))
    rel = float(np.linalg.norm(a - b) / np.linalg.norm(a))
    print(f"[parity] reference vs itself, input moved by one ulp: wave_rel_l2={rel:.3e}")
    assert rel > 1e-2


def test_import_pulls_in_neither_jax_nor_azoom():
    code = "import sys, azoom_torch; print('jax' in sys.modules, 'azoom' in sys.modules)"
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120, check=True).stdout.split()
    assert out == ["False", "False"]


def test_sources_import_no_jax():
    import re

    pat = re.compile(r"^\s*(import|from)\s+(jax|flax|azoom)\b", re.M)
    for root, _, files in os.walk(os.path.join(REPO, "azoom_torch")):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(root, f)) as fh:
                    assert not pat.search(fh.read()), f
    with open(os.path.join(REPO, "chip_smoke.py")) as fh:
        assert not pat.search(fh.read())


def test_default_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        load_bundled("tpufpu_nano")


def test_load_bundled_scope():
    net, kind = load_bundled("crn_causal", device="cpu")  # the causal CRN of the low-latency path
    assert type(net).__name__ == "CRNMaskNet" and kind == "logmag_ipd"
    with pytest.raises(KeyError):
        load_bundled("nope", device="cpu")
    assert bundled_train_mic_dist("tpufpu_nano") == 0.04
    assert geo_adapt_dist("tpufpu_nano", 0.01) == 0.04
    assert geo_adapt_dist("tpufpu_nano", 0.08) is None


UNPORTED = {  # name: learned_enhance keywords
    "nope": {"beamformer": "nope"},
}


@pytest.mark.parametrize("option", list(UNPORTED))
def test_unported_options_raise(models, option):
    """Every beamformer of the reference is served (rmvb, rtf and wpd:
    tests/test_torch_learned_beamformers*.py); a name it does not know
    raises ValueError, as the reference's."""
    _, _, tm = models
    with pytest.raises(ValueError, match="unknown beamformer 'nope'"):
        learned_enhance(torch.zeros(2, 8000), tm, PipelineConfig(mic_dist=0.04), **UNPORTED[option])


THREE_MICS = {  # name: learned_enhance keywords; the bundled float fpu, 1 s, 3 mics at 4 cm
    "mvdr_three_mics": {"steer_deg": 60.0},
    "hard_null_three_mics": {"beamformer": "hard_null"},
}


@pytest.fixture(scope="module")
def fpu_three_mics():
    """The float fpu (the reference's M-mic facade net) on both sides and a
    1 s 3-mic scene: target at 60 deg, interferers at 40 and 130."""
    sigs = speech_like_batch(jax.random.PRNGKey(7), 3, 16000, 16000)
    sc = make_scene(sigs[0], sigs[1:], 60.0, jnp.array([40.0, 130.0]), 0.04, 16000, n_mics=3)
    jm, jv, _ = jax_load_bundled("fpu", quant=False)
    tm, _ = load_bundled("fpu", quant=False, device="cpu")
    return jm, jv, tm, {k: np.asarray(v) for k, v in sc.items()}


@pytest.mark.parametrize("option", list(THREE_MICS))
def test_three_mics_match_jax(fpu_three_mics, option):
    """Three mics: the conv net on the mean over pairs, the M-mic MVDR or
    hard-null (one null) of beam.mvdr / beam.nullsteer; at the 2-mic
    cases' bounds (waveform 1e-2, SIR 0.05 dB)."""
    jm, jv, tm, sc = fpu_three_mics
    kw = THREE_MICS[option]
    ref = np.asarray(jax_learned_enhance(jnp.asarray(sc["mixture"]), jm, jv,
                                         JaxConfig(mic_dist=0.04, n_mics=3), **kw))
    got = learned_enhance(torch.tensor(sc["mixture"]), tm,
                          PipelineConfig(mic_dist=0.04, n_mics=3), **kw).numpy()
    _check_parity(option, got, ref, sc)


def test_bad_arguments_raise(models):
    _, _, tm = models
    cfg = PipelineConfig(mic_dist=0.04)
    with pytest.raises(ValueError, match="unknown beamformer"):
        learned_enhance(torch.zeros(2, 8000), tm, cfg, beamformer="nope")
    with pytest.raises(ValueError, match="feature_kind"):
        learned_enhance(torch.zeros(2, 8000), tm, cfg, feature_kind="mfcc")
    with pytest.raises(ValueError, match="model is on"):
        learned_enhance(torch.zeros(2, 8000, device="meta"), tm, cfg)
