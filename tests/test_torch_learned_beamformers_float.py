"""The RMVB, RTF and WPD branches of the learned path with the bundled float
fpu net at M = 2, on the CPU against azoom with JAX on the CPU: the FOV
gate, and the FOV gate with the HRNR post-filter, through learned_enhance
(learned_enhance_streaming, autosteer_enhance and tracked_autosteer_enhance
with these beamformers: tests/test_torch_learned_beamformers_paths.py).

Each branch takes its masks from a different place (the gated noise mask,
its complement, or the ungated net mask; the HRNR stage-1 gain from the
ungated mask for rmvb and rtf, from 1 - the gated noise mask for wpd), so
these cases run with the FOV gate on and the float net, whose masks agree
with the reference's to ~1e-7: a mask taken from the wrong place moves the
output by far more than the bounds.

Scene: the 2 s window of tests/test_torch_learned_beamformers.py (target at
60 deg, interferers at 40 and 130 deg, 4 cm), steered to 60 deg, FOV 30
deg.

Bounds: waveform relative L2 <= 1e-3 (rtf 5e-3) and SIR within 0.05 dB.
Measured (``-s``): rmvb <= 4.4e-6, wpd <= 5.3e-5, rtf 1.2e-3: its MVDR on
a measured steering amplifies float32 noise in the low bins, where the
reference itself is ~1e-3 from a complex128 evaluation (module docstring
of tests/test_torch_beamformers.py); SIR within 0.0012 dB.
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

BOUND = 1e-3
RTF_BOUND = 5e-3  # MVDR on a measured steering (tests/test_torch_beamformers.py)
CASES = {  # name: learned_enhance keywords beyond the beamformer
    "fov": dict(fov_deg=30.0),
    "fov_hrnr": dict(fov_deg=30.0, harmonic_regen=True),
}


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
def fpu():
    jm, jv, _ = jax_load_bundled("fpu", quant=False)
    tm, kind = load_bundled("fpu", quant=False, device="cpu")
    assert kind == "logmag_ipd"
    return jm, jv, tm


def _sir(out, sc):
    m = out.shape[-1]
    return float(osinr_osir(jnp.asarray(out), sc["target_ref"][..., :m],
                            sc["interference_ref"][..., :m])[1])


def _check(tag, got, ref, sc, bound=BOUND):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == np.float32 and np.all(np.isfinite(got))
    rel = float(np.linalg.norm(got - ref) / np.linalg.norm(ref))
    d_sir = _sir(got, sc) - _sir(ref, sc)
    print(f"[learned] {tag} wave_rel_l2={rel:.3e} sir_jax={_sir(ref, sc):.3f} "
          f"dsir_db={d_sir:+.4f}")  # shown with pytest -s
    assert rel <= bound, f"{tag}: waveform relative L2 {rel:.3e}"
    assert abs(d_sir) <= 0.05


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("beamformer", ["rmvb", "rtf", "wpd"])
def test_fov_and_hrnr_match_jax(fpu, scene, beamformer, case):
    """The FOV gate alone, and with HRNR (the stage-1 gain's routing; the
    ungated branches of tests/test_torch_learned_beamformers.py run without
    either)."""
    jm, jv, tm = fpu
    mix = scene["mixture"]
    kw = dict(beamformer=beamformer, steer_deg=60.0, **CASES[case])
    ref = jax_learned_enhance(jnp.asarray(mix), jm, jv, JaxConfig(mic_dist=0.04), **kw)
    got = learned_enhance(torch.from_numpy(mix), tm, PipelineConfig(mic_dist=0.04), **kw)
    _check(f"{beamformer} {case}", got.numpy(), ref, scene,
           RTF_BOUND if beamformer == "rtf" else BOUND)
