"""The learned paths with the base-32 nets on the CPU: learned_enhance with the
int8 ``fpu`` (logmag_ipd features, the port's default feature kind, as the
reference's) and the ``AudioZoom`` facade with the float ``fpu_multigeo`` at
its reference default ``int8=False`` on a 1 cm array, each against the JAX
package; and ``AudioZoomServer`` serving ``deepfpu`` int8 and float.

Pipeline scenes are 2 s: one window, the 64-frame net input the bundled nets
serve.
Bounds (ROADMAP.md Queue C): waveform relative L2 <= 2e-2 and SIR within
0.05 dB against the reference's jitted learned path, whose int8 codes XLA's
fused BatchNorm rsqrt moves (the 64-frame-window bound of the streaming and
HRNR cases); the float facade has no codes to flip and is held to 1e-3. The
server's rows equal the overlap-add of learned_enhance on their two windows
to 1e-5 (port against port).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import azoom
from azoom.config import PipelineConfig as JaxConfig
from azoom.eval.projection import osinr_osir
from azoom.models.pretrained import load_bundled as jax_load_bundled
from azoom.pipelines.learned import learned_enhance as jax_learned_enhance
from azoom.sim.farfield import make_scene
from azoom.sim.signals import speech_like_batch
from azoom_torch import AudioZoom, AudioZoomServer, PipelineConfig, learned_enhance, load_bundled
from azoom_torch.beam.zoom import zoom_to_sigma


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU work in one thread while this file runs: beside the
    suite's other workers, torch's intra-op threads oversubscribe the cores
    and slow these tests many-fold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene(mic_dist, seed, n=32000, target=60.0):
    sigs = speech_like_batch(jax.random.PRNGKey(seed), 3, n, 16000)
    sc = make_scene(sigs[0], sigs[1:], target, jnp.asarray([20.0, 130.0]), mic_dist, 16000)
    return {k: np.asarray(v) for k, v in sc.items()}


def _check(tag, got, ref, sc, bound, sir_bound=0.05):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape == sc["target_ref"].shape
    rel = float(np.linalg.norm(got - ref) / np.linalg.norm(ref))
    t, i = jnp.asarray(sc["target_ref"]), jnp.asarray(sc["interference_ref"])
    d_sir = float(osinr_osir(jnp.asarray(got), t, i)[1] - osinr_osir(jnp.asarray(ref), t, i)[1])
    print(f"[parity] {tag} wave_rel_l2={rel:.3e} dsir_db={d_sir:+.4f}")  # pytest -s
    assert rel <= bound, f"{tag}: waveform relative L2 {rel:.3e}"
    assert abs(d_sir) <= sir_bound, f"{tag}: SIR differs by {d_sir:.4f} dB"


def test_learned_enhance_fpu_int8_matches_jax():
    sc = _scene(0.04, seed=21)
    jm, jv, fk = jax_load_bundled("fpu", quant=True)
    assert fk == "logmag_ipd"
    ref = jax_learned_enhance(jnp.asarray(sc["mixture"]), jm, jv, JaxConfig(mic_dist=0.04),
                              steer_deg=60.0, use_pallas=False)
    tm, kind = load_bundled("fpu", device="cpu")
    got = learned_enhance(torch.from_numpy(sc["mixture"]), tm, PipelineConfig(mic_dist=0.04),
                          steer_deg=60.0)
    assert kind == "logmag_ipd"
    _check("learned fpu int8", got.numpy(), np.asarray(ref), sc, 2e-2)


def test_audiozoom_fpu_multigeo_float_at_1cm_matches_jax():
    sc = _scene(0.01, seed=23)
    kw = dict(model="fpu_multigeo", direction_deg=70.0, fov_deg=60.0, zoom=0.4)
    ref = azoom.AudioZoom(cfg=JaxConfig(mic_dist=0.01), native=False, **kw).enhance(sc["mixture"])
    zoom = AudioZoom(cfg=PipelineConfig(mic_dist=0.01), device="cpu", **kw)
    assert not zoom.int8 and zoom._train_mic_dist is None  # trained across spacings: raw cues
    _check("facade fpu_multigeo float 1 cm", zoom.enhance(sc["mixture"]), ref, sc, 1e-3)


@pytest.mark.parametrize("int8", [True, False])
def test_server_serves_deepfpu(int8):
    """A prime and one tick of a stream through deepfpu at 0.5 s windows
    (DeepFPU is the costliest net on the CPU: ~7 s a 1 s window in the plain
    int8 path): the row is the overlap-add of learned_enhance (physics
    features, the net's own) on its two windows."""
    win, hop = 8000, 4000
    mix = _scene(0.04, seed=30, n=win + hop)["mixture"]
    cfg = PipelineConfig(mic_dist=0.04, win_size=win)
    srv = AudioZoomServer(1, cfg=cfg, model="deepfpu", int8=int8, device="cpu")
    srv.set_zoom(0, direction_deg=60.0, zoom=0.3)
    out = srv.push(mix[None])
    assert out.shape == (1, hop) and np.isfinite(out).all()
    model, kind = load_bundled("deepfpu", quant=int8, device="cpu")
    assert kind == "physics"
    w = np.hanning(win + 1)[:-1].astype(np.float32)
    norm = np.maximum(w[:hop] + w[hop:], 1e-6)
    c = cfg.replace(sigma=float(zoom_to_sigma(0.3)))
    e1, e2 = (learned_enhance(torch.from_numpy(mix[:, o:o + win]), model, c, feature_kind=kind,
                              steer_deg=torch.tensor(60.0)).numpy() for o in (0, hop))
    expected = ((e1 * w)[hop:] + (e2 * w)[:hop]) / norm
    err = np.max(np.abs(out[0] - expected)) / np.max(np.abs(expected))
    assert err <= 1e-5, f"server vs learned_enhance rel err {err:.3e}"
