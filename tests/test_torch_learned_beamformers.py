"""learned_enhance with the RMVB, RTF and WPD beamformers and the bundled
int8 tpufpu_nano net, on the CPU against azoom with JAX on the CPU.

Scene: the 2 s window of tests/test_torch_postfilter.py (target at 60 deg,
interferers at 40 and 130 deg, 4 cm; speech_like_batch seed 29), steered to
60 deg with physics features: one 64-frame window, the serving shape.

Bounds: waveform relative L2 <= 2e-2 and SIR within 0.05 dB, ROADMAP.md
Queue C's bound for a 2 s window through the int8 net (the port's correctly
rounded BatchNorm multiplier and XLA's rsqrt flip int8 codes at 64 frames).
Measured (``-s``): rmvb 3.5e-3, rtf 3.4e-3, wpd 3.7e-3, the MVDR path on
the same window 3.6e-3: the net's code flips, not the beamformers (held to
1e-3 and below on one mask in tests/test_torch_beamformers.py and
tests/test_torch_learned_beamformers_float.py). The reference's int8 net
costs ~14 s a window on one core, so this file runs the plain branches
only; the FOV gate, HRNR, streaming, autosteer and tracked paths run the
float fpu net.
"""

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
from azoom_torch import learned_enhance, load_bundled
from azoom_torch.config import PipelineConfig

BEAMFORMERS = ["rmvb", "rtf", "wpd"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU work in one thread while this file runs (the suite's
    other workers share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene():
    sigs = speech_like_batch(jax.random.PRNGKey(29), 3, 2 * 16000, 16000)
    sc = make_scene(sigs[0], sigs[1:], 60.0, jnp.array([40.0, 130.0]), 0.04, 16000)
    return {k: np.array(v) for k, v in sc.items()}


@pytest.fixture(scope="module")
def nets():
    jm, jv, _ = jax_load_bundled("tpufpu_nano", quant=True)
    tm, kind = load_bundled("tpufpu_nano", device="cpu")
    assert kind == "physics"
    return jm, jv, tm


def _sir(out, sc):
    return float(osinr_osir(jnp.asarray(out), sc["target_ref"], sc["interference_ref"])[1])


@pytest.mark.parametrize("beamformer", BEAMFORMERS)
def test_int8_window_matches_jax(nets, scene, beamformer):
    jm, jv, tm = nets
    kw = dict(beamformer=beamformer, feature_kind="physics", steer_deg=60.0)
    ref = np.asarray(jax_learned_enhance(jnp.asarray(scene["mixture"]), jm, jv,
                                         JaxConfig(mic_dist=0.04), **kw))
    got = learned_enhance(torch.from_numpy(scene["mixture"]), tm, PipelineConfig(mic_dist=0.04),
                          **kw).numpy()
    assert got.shape == ref.shape == (32000,) and got.dtype == np.float32
    rel = float(np.linalg.norm(got - ref) / np.linalg.norm(ref))
    d_sir = _sir(got, scene) - _sir(ref, scene)
    print(f"[learned] int8 {beamformer} wave_rel_l2={rel:.3e} sir_jax={_sir(ref, scene):.3f} "
          f"dsir_db={d_sir:+.4f}")  # shown with pytest -s
    assert rel <= 2e-2 and abs(d_sir) <= 0.05
