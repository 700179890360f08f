"""The RMVB, RTF and WPD branches of the learned path on a 4-mic linear
array (4 cm) with the bundled float fpu net, on the CPU against azoom with
JAX on the CPU: the M-mic branches (RMVB's Jacobi EVD, RTF's whitened power
iteration, WPD's 36 x 36 stacked solve).

Scene: the reference's M-mic scene of tests/test_torch_mmic.py (a 150 Hz
target at 90 deg, interferers at 30, 135 and 60 deg), its first 2 s.

Bounds: waveform relative L2 <= 1e-3 and SIR within 0.05 dB (measured
``-s``: <= 5e-4). The reference's RMVB at M = 4 compiles its unrolled
Jacobi EVD and 30 bisection steps (~20 s on one core).
"""

import jax.numpy as jnp
import pytest
import torch

from azoom.config import PipelineConfig as JaxConfig
from azoom.pipelines.learned import learned_enhance as jax_learned_enhance
from azoom_torch import learned_enhance
from azoom_torch.config import PipelineConfig
from test_torch_mmic import _check, _one_torch_thread, fpu, scene  # noqa: F401  (fixtures)

CASES = {  # name: learned_enhance keywords
    "rmvb": dict(beamformer="rmvb"),
    "rtf": dict(beamformer="rtf"),
    "wpd": dict(beamformer="wpd"),
    "wpd_fov_hrnr": dict(beamformer="wpd", fov_deg=30.0, harmonic_regen=True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_four_mics_match_jax(fpu, case):
    jm, jv, tm = fpu
    sc = scene(4)
    kw = dict(steer_deg=90.0, **CASES[case])
    ref = jax_learned_enhance(jnp.asarray(sc["mixture"]), jm, jv,
                              JaxConfig(mic_dist=0.04, n_mics=4), **kw)
    got = learned_enhance(torch.from_numpy(sc["mixture"]), tm,
                          PipelineConfig(mic_dist=0.04, n_mics=4), **kw)
    _check(f"learned {case} M=4", got.numpy(), ref, sc["target_ref"], sc["interference_ref"],
           1e-3)
