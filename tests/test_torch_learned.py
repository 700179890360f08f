"""End-to-end parity of the port's learned serving path (bundled int8
tpufpu_nano + masked MVDR) with azoom.pipelines.learned.learned_enhance
(CPU), plus the port's import and device guards.

Scene: 1 s, target at the steer angle, interferers at 40 and 130 deg. Each
case runs against JAX with use_pallas=False and with the Pallas MVDR kernel
in interpret mode.

Bounds: SIR (azoom.eval.projection.osinr_osir) within 0.05 dB of the JAX
SIR; waveform relative L2 <= 1e-2 at steer 90 and 60 deg. Under geometry
adaptation (1 cm array, features rescaled by 4) the waveform bound is 3e-2:
the port's STFT and the reference's differ by float32 roundings (~2e-8), the
rescaled phase features amplify that in quiet bins, and the int8 net turns
it into a few flipped activation codes. That is the reference's own floor:
its output moves by more than 1e-2 when its input moves by one ulp
(test_reference_moves_more_than_1e_2_under_one_ulp below).
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
from azoom.sim.farfield import make_scene
from azoom.sim.signals import speech_like_batch
from azoom_torch import load_bundled, learned_enhance
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


def _scene(steer, mic_dist, seed=7):
    sigs = speech_like_batch(jax.random.PRNGKey(seed), 3, 16000, 16000)
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
                          steer_deg=steer, train_mic_dist=train_dist).numpy()
    assert got.shape == ref.shape == sc["mixture"].shape[-1:]
    rel = float(np.linalg.norm(got - ref) / np.linalg.norm(ref))
    d_sir = _sir(got, sc) - _sir(ref, sc)
    print(f"[parity] {case} use_pallas={use_pallas} wave_rel_l2={rel:.3e} "
          f"sir_jax={_sir(ref, sc):.4f} dsir_db={d_sir:+.4f}")  # shown with pytest -s
    assert rel <= wave_bound, f"waveform relative L2 {rel:.3e}"
    assert abs(d_sir) <= 0.05


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
    with pytest.raises(NotImplementedError, match="not ported"):
        load_bundled("fpu", device="cpu")
    with pytest.raises(KeyError):
        load_bundled("nope", device="cpu")
    assert bundled_train_mic_dist("tpufpu_nano") == 0.04
    assert geo_adapt_dist("tpufpu_nano", 0.01) == 0.04
    assert geo_adapt_dist("tpufpu_nano", 0.08) is None


def test_unported_options_raise(models):
    _, _, tm = models
    mix = torch.zeros(2, 8000)
    cfg = PipelineConfig(mic_dist=0.04)
    for kw in ({"beamformer": "hard_null"}, {"fov_deg": 30.0}, {"harmonic_regen": True}):
        with pytest.raises(NotImplementedError):
            learned_enhance(mix, tm, cfg, **kw)
    with pytest.raises(ValueError, match="model is on"):
        learned_enhance(torch.zeros(2, 8000, device="meta"), tm, cfg)
