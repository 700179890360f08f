"""learned_enhance_streaming, autosteer_enhance and tracked_autosteer_enhance
with the new beamformers and the bundled float fpu net (M = 2), on the CPU
against azoom with JAX on the CPU: each reaches learned_enhance with its
own batch and steering (all chunks in one call; the DOA bearing; a bearing
per chunk, so a (C, F, M) steering), and serves the beamformer unchanged.

Scenes: 3 s of the sources of tests/test_torch_learned_beamformers.py
(target at 60 deg, interferers at 40 and 130 deg, 4 cm; 2 chunks of 2 s);
its first 2 s for autosteer (field of view 70 +- 30 deg, the FOV gate on);
2 s of a moving talker (60 -> 120 deg, interferers at 20 and 150 deg; the
reference's moving-source renderer) in 1 s windows (3 chunks) for the
tracked path.

Bounds: waveform relative L2 <= 1e-3, SIR within 0.05 dB, bearings equal.
Measured (``-s``): streaming wpd 4.0e-5, autosteer wpd 5.8e-5 (the same
bearing, 62 deg), tracked rmvb 4.8e-6 (bearings 83, 88, 96 deg).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from azoom.config import PipelineConfig as JaxConfig
from azoom.pipelines.autosteer import autosteer_enhance as jax_autosteer
from azoom.pipelines.learned import learned_enhance_streaming as jax_streaming
from azoom.pipelines.tracked import tracked_autosteer_enhance as jax_tracked
from azoom.sim.farfield import make_scene
from azoom.sim.motion import linear_trajectory, make_moving_scene, traj_block_count
from azoom.sim.signals import speech_like_batch
from azoom_torch import autosteer_enhance, learned_enhance_streaming
from azoom_torch.config import PipelineConfig
from azoom_torch.pipelines.tracked import tracked_autosteer_enhance
from test_torch_learned_beamformers_float import _check, _one_torch_thread, fpu  # noqa: F401


@pytest.fixture(scope="module")
def sources():
    return speech_like_batch(jax.random.PRNGKey(29), 3, 3 * 16000, 16000)


@pytest.fixture(scope="module")
def scene(sources):
    sc = make_scene(sources[0], sources[1:], 60.0, jnp.array([40.0, 130.0]), 0.04, 16000)
    return {k: np.array(v) for k, v in sc.items()}


def test_streaming_matches_jax(fpu, scene):
    jm, jv, tm = fpu
    ref = jax_streaming(jnp.asarray(scene["mixture"]), jm, jv, JaxConfig(mic_dist=0.04), "wpd")
    got = learned_enhance_streaming(torch.from_numpy(scene["mixture"]), tm,
                                    PipelineConfig(mic_dist=0.04), "wpd")
    assert got.shape == (48000,)
    _check("streaming wpd", got.numpy(), ref, scene)


def test_autosteer_matches_jax(fpu, scene):
    jm, jv, tm = fpu
    mix = scene["mixture"][..., :32000]
    kw = dict(fov_center_deg=70.0, fov_width_deg=60.0, beamformer="wpd", fov_gate=True)
    ref, th_ref = jax_autosteer(jnp.asarray(mix), JaxConfig(mic_dist=0.04), model=jm,
                                variables=jv, **kw)
    got, th = autosteer_enhance(mix, PipelineConfig(mic_dist=0.04), model=tm, device="cpu", **kw)
    assert float(th) == float(th_ref)
    print(f"[learned] autosteer wpd bearing={float(th)}")
    _check("autosteer wpd", got.numpy(), ref, scene)


def test_tracked_rmvb_matches_jax(fpu, sources):
    jm, jv, tm = fpu
    n = 2 * 16000
    B = traj_block_count(n, 2048)
    sc = make_moving_scene(sources[0, :n], sources[1:, :n], linear_trajectory(60.0, 120.0, B),
                           jnp.asarray([20.0, 150.0]), 0.04, 16000)
    sc = {k: np.array(v) for k, v in sc.items()}
    kw = dict(fov_center_deg=85.0, fov_width_deg=90.0, tracker="viterbi", beamformer="rmvb")
    ref, th_ref = jax_tracked(jnp.asarray(sc["mixture"]),
                              JaxConfig(mic_dist=0.04, win_size=16000), model=jm, variables=jv,
                              **kw)
    got, th = tracked_autosteer_enhance(sc["mixture"], PipelineConfig(mic_dist=0.04,
                                                                       win_size=16000),
                                        model=tm, device="cpu", **kw)
    assert th.shape == (3,)
    np.testing.assert_array_equal(th.numpy(), np.asarray(th_ref))
    print(f"[learned] tracked rmvb bearings={th.tolist()}")
    _check("tracked rmvb", got.numpy(), ref, sc)
