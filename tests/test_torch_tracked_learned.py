"""The learned tracked path on the CPU against azoom with JAX on the CPU:
tracked_autosteer_enhance with the bundled int8 tpufpu_nano net, MVDR and
hybrid hard-null (every chunk steered at its own bearing, all chunks in one
batched learned_enhance call), and AudioZoom(model="tpufpu_nano", int8=True,
track=True).enhance of a clip longer than a window.

Scene: 2 s of a moving talker (azoom.sim.motion; target 60 -> 120 deg,
interferers at 20 and 150 deg, 4 cm) cut into 1 s windows at 50 %: 3
chunks. The windows are 1 s, not the default 2 s, because the reference's
int8 net is the cost here: a vmapped call over three 2 s chunks took 48 s on
one CPU core, and the file has to stay near 90 s. Both sides take
feature_kind="physics" (the reference's own default there is logmag_ipd,
which the port does not serve).

The reference runs once per beamformer, in a module fixture. The MVDR run
takes exactly the arguments azoom.AudioZoom(track=True).enhance passes for
such a clip (azoom/zoom_api.py: the zoom's loading in cfg, the look
direction as the field of view's centre, the 'viterbi' tracker), so the
port's facade is held against it too.

Bounds: bearings EQUAL at every chunk; waveform relative L2 <= 2e-2 and SIR
within 0.1 dB, the bounds of the learned whole clips and streams
(ROADMAP.md Queue C: the reference's jitted int8 path flips codes that its
own stages do not).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from azoom.beam.zoom import zoom_to_sigma
from azoom.config import PipelineConfig as JaxConfig
from azoom.eval.projection import osinr_osir
from azoom.models.pretrained import load_bundled as jax_load_bundled
from azoom.pipelines.tracked import tracked_autosteer_enhance as jax_tracked
from azoom.sim.motion import linear_trajectory, make_moving_scene, traj_block_count
from azoom.sim.signals import speech_like_batch
from azoom_torch import AudioZoom, PipelineConfig, load_bundled
from azoom_torch.pipelines.tracked import tracked_autosteer_enhance

WIN = 16000
DIRECTION, FOV, ZOOM = 85.0, 90.0, 0.4
CASES = {  # beamformer: tracker
    "mvdr": "viterbi",
    "hard_null": "momentum",
}


@pytest.fixture(scope="module")
def scene():
    n = 2 * 16000
    sigs = speech_like_batch(jax.random.PRNGKey(23), 3, n, 16000)
    B = traj_block_count(n, 2048)
    sc = make_moving_scene(sigs[0], sigs[1:], linear_trajectory(60.0, 120.0, B),
                           jnp.asarray([20.0, 150.0]), 0.04, 16000)
    return {k: np.array(v) for k, v in sc.items()}


def _kwargs(beamformer):
    return dict(fov_center_deg=DIRECTION, fov_width_deg=FOV, tracker=CASES[beamformer],
                beamformer=beamformer, feature_kind="physics")


@pytest.fixture(scope="module")
def reference(scene):
    """{beamformer: (enhanced, bearings)} of the reference, one run each."""
    jm, jv, _ = jax_load_bundled("tpufpu_nano", quant=True)
    cfg = JaxConfig(mic_dist=0.04, win_size=WIN, sigma=float(zoom_to_sigma(ZOOM)),
                    angle_target_deg=DIRECTION)
    out = {}
    for beamformer in CASES:
        y, theta = jax_tracked(jnp.asarray(scene["mixture"]), cfg, model=jm, variables=jv,
                               **_kwargs(beamformer))
        out[beamformer] = (np.asarray(y), np.asarray(theta))
    return out


@pytest.fixture(scope="module")
def port_cfg():
    return PipelineConfig(mic_dist=0.04, win_size=WIN,
                          sigma=float(zoom_to_sigma(ZOOM)), angle_target_deg=DIRECTION)


def _sir(out, sc):
    return float(osinr_osir(jnp.asarray(out), sc["target_ref"], sc["interference_ref"])[1])


def _check(tag, got, ref, sc):
    assert got.shape == ref.shape == sc["mixture"].shape[-1:]
    rel = float(np.linalg.norm(got - ref) / np.linalg.norm(ref))
    d_sir = _sir(got, sc) - _sir(ref, sc)
    print(f"[parity] {tag} wave_rel_l2={rel:.3e} sir_jax={_sir(ref, sc):.4f} "
          f"dsir_db={d_sir:+.4f}")  # shown with pytest -s
    assert rel <= 2e-2, f"{tag}: waveform relative L2 {rel:.3e}"
    assert abs(d_sir) <= 0.1, f"{tag}: SIR differs by {d_sir:.4f} dB"


@pytest.mark.parametrize("beamformer", list(CASES))
def test_learned_tracked_matches_jax(scene, reference, port_cfg, beamformer):
    model, _ = load_bundled("tpufpu_nano", device="cpu")
    ref, theta_ref = reference[beamformer]
    got, theta = tracked_autosteer_enhance(torch.from_numpy(scene["mixture"]), port_cfg,
                                           model=model, **_kwargs(beamformer))
    assert theta.shape == (3,)
    np.testing.assert_array_equal(theta.numpy(), theta_ref)
    print(f"[parity] learned tracked {beamformer} bearings={theta.tolist()}")
    _check(f"learned tracked {beamformer}", got.numpy(), ref, scene)


def test_audiozoom_learned_tracked_enhance_matches_jax(scene, reference):
    zoom = AudioZoom(cfg=PipelineConfig(mic_dist=0.04, win_size=WIN), model="tpufpu_nano",
                     int8=True, track=True, direction_deg=DIRECTION, fov_deg=FOV, zoom=ZOOM,
                     device="cpu")
    got = zoom.enhance(scene["mixture"])
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    _check("AudioZoom learned tracked enhance", got, reference["mvdr"][0], scene)
