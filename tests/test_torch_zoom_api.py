"""The port's autosteer pipeline and AudioZoom facade on the CPU against the
JAX package: azoom.pipelines.autosteer.autosteer_enhance and
azoom.AudioZoom(native=False, int8=True) with model "tpufpu_nano" or none.

Scene: a target at 60 deg, interferers at 20 and 130 deg, 4 cm; the camera
looks at 70 deg with a 60 deg field of view, so autosteer has to find the
target 10 deg off the camera's center. Whole clips are 1 s; the streaming
cases use 1 s windows (win_size 16000, or 16384 for frame-aligned mask
reuse) to keep the reference's int8 net affordable on the CPU.

Bounds: the same bearing as JAX (autosteer's argmax, the trackers' bearing
after every push). Waveform relative L2 <= 1e-4 for the heuristic path (no
net: float32 roundings only); <= 1e-2 and SIR within 0.05 dB for the
streamed windows; <= 2e-2 and SIR within 0.1 dB for the learned whole clips
(measured 1.04e-2 to 1.34e-2 and up to 0.060 dB). That is ROADMAP.md Queue
C's floor: the reference's jitted learned_enhance differs by 1.6e-2 on this
clip from its own stages run one by one
(test_reference_jit_differs_from_its_stages; XLA's fused BatchNorm rsqrt
flips int8 codes inside jit), and the port's learned path agrees with those
stages to a waveform relative L2 of 2.4e-5 (test_port_matches_reference_stages).
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
from azoom.pipelines.autosteer import autosteer_enhance as jax_autosteer
from azoom.sim.farfield import make_scene
from azoom.sim.signals import speech_like_batch
from azoom_torch import AudioZoom, PipelineConfig, autosteer_enhance, learned_enhance, load_bundled

CENTER, FOV = 70.0, 60.0
TWO_MIC = ((0.02, 0.0), (-0.02, 0.0))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU work in one thread while this file runs (beside the
    suite's other workers torch's intra-op threads oversubscribe the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene():
    sigs = speech_like_batch(jax.random.PRNGKey(17), 3, 3 * 16000, 16000)
    sc = make_scene(sigs[0], sigs[1:], 60.0, jnp.asarray([20.0, 130.0]), 0.04, 16000)
    return {k: np.asarray(v) for k, v in sc.items()}


@pytest.fixture(scope="module")
def models():
    jm, jv, fk = jax_load_bundled("tpufpu_nano", quant=True)
    tm, _ = load_bundled("tpufpu_nano", device="cpu")
    return jm, jv, fk, tm


def _check(tag, got, ref, sc=None, offset=0, bound=1e-2, sir_bound=0.05):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and got.size > 0
    rel = float(np.linalg.norm(got - ref) / np.linalg.norm(ref))
    print(f"[parity] {tag} wave_rel_l2={rel:.3e}")  # shown with pytest -s
    assert rel <= bound, f"{tag}: waveform relative L2 {rel:.3e}"
    if sc is not None:
        seg = slice(offset, offset + got.shape[-1])
        t, i = jnp.asarray(sc["target_ref"][seg]), jnp.asarray(sc["interference_ref"][seg])
        d_sir = float(osinr_osir(jnp.asarray(got), t, i)[1] - osinr_osir(jnp.asarray(ref), t, i)[1])
        print(f"[parity] {tag} dsir_db={d_sir:+.4f}")
        assert abs(d_sir) <= sir_bound, f"{tag}: SIR differs by {d_sir:.4f} dB"


@pytest.mark.parametrize("case", ["learned", "heuristic", "heuristic_geometry"])
def test_autosteer_matches_jax(scene, models, case):
    jm, jv, fk, tm = models
    mix = scene["mixture"][:, :16000]
    jcfg, cfg = JaxConfig(mic_dist=0.04), PipelineConfig(mic_dist=0.04)
    if case == "heuristic_geometry":  # an explicit 2-mic geometry: SRP-PHAT bearing
        jcfg, cfg = jcfg.with_geometry(TWO_MIC), cfg.with_geometry(TWO_MIC)
    kw = dict(fov_center_deg=CENTER, fov_width_deg=FOV)
    jkw, tkw = dict(kw), dict(kw)
    if case == "learned":
        jkw.update(model=jm, variables=jv, feature_kind=fk, fov_gate=True)
        tkw.update(model=tm, feature_kind="physics", fov_gate=True)
    ref, theta_ref = jax_autosteer(jnp.asarray(mix), jcfg, **jkw)
    got, theta = autosteer_enhance(torch.from_numpy(mix), cfg, **tkw)
    assert theta.shape == () and float(theta) == float(theta_ref)
    print(f"[parity] autosteer {case} theta={float(theta)}")
    learned = case == "learned"
    _check(f"autosteer {case}", got.numpy(), ref, scene, bound=2e-2 if learned else 1e-4,
           sir_bound=0.1 if learned else 0.05)


@pytest.mark.parametrize("case", ["autosteer", "exact_steer", "no_model"])
def test_audiozoom_enhance_matches_jax(scene, case):
    mix = scene["mixture"][:, :16000]
    kw = dict(direction_deg=CENTER, fov_deg=FOV, zoom=0.4)
    if case != "no_model":
        kw.update(model="tpufpu_nano", int8=True, autosteer=case == "autosteer")
    ref = azoom.AudioZoom(native=False, **kw).enhance(mix)
    got = AudioZoom(device="cpu", **kw).enhance(mix)
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    learned = case != "no_model"
    _check(f"enhance {case}", got, ref, scene, bound=2e-2 if learned else 1e-4,
           sir_bound=0.1 if learned else 0.05)


STAGE_SIGMA = 1.5848926e-05  # zoom_to_sigma(0.4)


@pytest.fixture(scope="module")
def reference_stages(scene, models):
    """The reference's learned path on the first second, steered at 90 deg:
    jitted learned_enhance, and STFT, mask net, masked MVDR and iSTFT called
    one at a time (the eager mask and waveform)."""
    from azoom.beam.mvdr import masked_mvdr
    from azoom.dsp.delays import steering_vector
    from azoom.dsp.stft import istft, rfft_freqs, stft
    from azoom.pipelines.learned import learned_enhance as jax_learned_enhance
    from azoom.pipelines.learned import predict_mask

    jm, jv, fk, _ = models
    mix = jnp.asarray(scene["mixture"][:, :16000])
    cfg = JaxConfig(mic_dist=0.04, sigma=STAGE_SIGMA)
    jitted = np.asarray(jax_learned_enhance(mix, jm, jv, cfg, feature_kind=fk))
    Y = stft(mix)
    mask = predict_mask(jm, jv, Y, fk)
    f = rfft_freqs(1024, 16000)
    S = masked_mvdr(Y, 1.0 - mask, steering_vector(f, 90.0, 0.04), f, target_mask=mask,
                    mask_floor=0.05, sigma=cfg.sigma)
    return jitted, np.asarray(mask), np.asarray(istft(S, length=16000))


def test_reference_jit_differs_from_its_stages(reference_stages):
    """The reference's floor: jitted learned_enhance against its stages
    called one at a time on the same clip."""
    jitted, _, stages = reference_stages
    rel = float(np.linalg.norm(jitted - stages) / np.linalg.norm(stages))
    print(f"[parity] reference jitted vs its stages: wave_rel_l2={rel:.3e}")
    assert rel > 1e-2


def test_port_matches_reference_stages(scene, models, reference_stages):
    """The port's learned path against the reference's stages run one at a
    time: mask mean absolute error <= 1e-5 (measured 1.7e-6; a few int8
    codes flip, up to 8.5e-3 in single elements) and waveform relative L2
    <= 1e-4 (measured 2.4e-5). With test_reference_jit_differs_from_its_stages
    this is what the learned whole clips' 2e-2 bound against the jitted
    reference rests on."""
    from azoom_torch.dsp.stft import stft
    from azoom_torch.pipelines.learned import predict_mask

    tm = models[3]
    _, mask_ref, stages = reference_stages
    mix = torch.from_numpy(scene["mixture"][:, :16000])
    mask = predict_mask(tm, stft(mix, 1024, 512), "physics").numpy()
    assert mask.shape == mask_ref.shape
    mask_err = float(np.abs(mask - mask_ref).mean())
    out = learned_enhance(mix, tm, PipelineConfig(mic_dist=0.04, sigma=STAGE_SIGMA),
                          feature_kind="physics").numpy()
    rel = float(np.linalg.norm(out - stages) / np.linalg.norm(stages))
    print(f"[parity] port vs reference stages: mask_mean_abs={mask_err:.3e} wave_rel_l2={rel:.3e}")
    assert mask_err <= 1e-5
    assert rel <= 1e-4


def test_autosteer_numpy_input_runs_on_the_card_unless_asked(scene):
    """A NumPy mixture goes to CUDA (an error without a card) unless
    device="cpu" asks for the plain path."""
    mix = scene["mixture"][:, :16000]
    kw = dict(fov_center_deg=CENTER, fov_width_deg=FOV)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            autosteer_enhance(mix, PipelineConfig(mic_dist=0.04), **kw)
    out, theta = autosteer_enhance(mix, PipelineConfig(mic_dist=0.04), device="cpu", **kw)
    ref, theta_ref = autosteer_enhance(torch.from_numpy(mix), PipelineConfig(mic_dist=0.04), **kw)
    assert out.device.type == theta.device.type == "cpu"
    assert torch.equal(out, ref) and float(theta) == float(theta_ref)


def _stream(zoom, mix, pushes, set_zoom_at=None):
    """Push ``mix`` in ``pushes`` equal blocks; (output, bearing after each
    push). A flush ends a pipelined stream."""
    outs, bearings = [], []
    for k, block in enumerate(np.array_split(mix, pushes, axis=1)):
        if k == set_zoom_at:
            zoom.set_zoom(zoom=0.7)
        outs.append(zoom.push(block))
        theta = zoom._track_theta if zoom._srv is None else zoom._srv.bearings[0]
        bearings.append(None if theta is None else float(theta))
    outs.append(zoom.flush())
    return np.concatenate(outs), bearings


STREAM_CASES = {  # name: (AudioZoom keywords, win_size, seconds, pushes)
    "track_causal": (dict(track=True, tracker="causal"), 16000, 1.5, 3),
    "track_momentum": (dict(track=True, tracker="momentum"), 16000, 1.5, 3),
    "pipelined": (dict(pipelined=True), 16000, 1.5, 3),
    "mask_reuse_tracked": (dict(mask_reuse=True, track=True, tracker="momentum"), 16384, 2.5, 5),
}


@pytest.mark.parametrize("case", list(STREAM_CASES))
def test_audiozoom_push_matches_jax(scene, case):
    extra, win, seconds, pushes = STREAM_CASES[case]
    mix = scene["mixture"][:, :int(seconds * 16000)]
    kw = dict(direction_deg=CENTER, fov_deg=FOV, zoom=0.4, model="tpufpu_nano", int8=True,
              **extra)
    at = 3 if case == "mask_reuse_tracked" else None  # a zoom change mid-stream
    ref, ref_bearings = _stream(
        azoom.AudioZoom(cfg=JaxConfig(mic_dist=0.04, win_size=win), native=False, **kw),
        mix, pushes, at)
    got, bearings = _stream(AudioZoom(cfg=PipelineConfig(mic_dist=0.04, win_size=win),
                                      device="cpu", **kw), mix, pushes, at)
    assert got.dtype == np.float32
    assert bearings == ref_bearings
    print(f"[parity] push {case} bearings={bearings}")
    _check(f"push {case}", got, ref, scene, offset=win // 2)


def test_pipelined_push_is_the_plain_push_one_window_late(scene):
    mix = scene["mixture"][:, :24000]
    kw = dict(cfg=PipelineConfig(mic_dist=0.04, win_size=16000), device="cpu")
    # pipelined pushes buffer in NumPy; the plain push does too with
    # native=False (the C++ engine's overlap-add is within 1e-6 of NumPy's,
    # not bit-equal: tests/test_torch_native.py)
    plain, piped = AudioZoom(native=False, **kw), AudioZoom(pipelined=True, **kw)
    a = [plain.push(mix[:, :20000]), plain.push(mix[:, 20000:])]
    b = [piped.push(mix[:, :20000]), piped.push(mix[:, 20000:])]
    assert a[1].size == 8000 and b[0].size == 0 and b[1].size == 0
    np.testing.assert_array_equal(np.concatenate(a), np.concatenate(b + [piped.flush()]))
    assert piped.flush().size == 0


def test_low_latency_at_three_mics_matches_jax():
    """A 3-mic array at low latency (the online MVDR over beam.linalgmm's
    Cholesky): enhance() and a push against the JAX facade, at the
    low-latency cases' bound."""
    sigs = speech_like_batch(jax.random.PRNGKey(9), 3, 16_000, 16_000)
    sc = {k: np.asarray(v) for k, v in make_scene(
        sigs[0], sigs[1:], CENTER, jnp.asarray([40.0, 130.0]), 0.04, 16_000, n_mics=3).items()}
    kw = dict(LOW_KW, track=True)
    ref = azoom.AudioZoom(cfg=JaxConfig(mic_dist=0.04, n_mics=3), native=False, **LOW_KW)
    got = AudioZoom(cfg=PipelineConfig(mic_dist=0.04, n_mics=3), device="cpu", **LOW_KW)
    _check("low latency three mics enhance", got.enhance(sc["mixture"]),
           ref.enhance(sc["mixture"]), sc)
    ref = azoom.AudioZoom(cfg=JaxConfig(mic_dist=0.04, n_mics=3), native=False, **kw)
    got = AudioZoom(cfg=PipelineConfig(mic_dist=0.04, n_mics=3), device="cpu", **kw)
    _check("low latency three mics push", got.push(sc["mixture"]), ref.push(sc["mixture"]))
    assert got._track_theta == ref._track_theta


def test_bad_arguments_raise():
    with pytest.raises(ValueError, match="latency"):
        AudioZoom(latency="medium", device="cpu")
    with pytest.raises(ValueError, match="causal"):
        AudioZoom(latency="low", model="tpufpu_nano", device="cpu")
    with pytest.raises(ValueError, match="latency='high'"):
        AudioZoom(latency="low", mask_reuse=True, device="cpu")
    with pytest.raises(ValueError, match="per-frame"):
        AudioZoom(cfg=PipelineConfig(win_size=32768), model="crn_causal", mask_reuse=True,
                  device="cpu")
    with pytest.raises(ValueError, match="tracker"):
        AudioZoom(tracker="kalman", device="cpu")
    with pytest.raises(ValueError, match="mask net"):
        AudioZoom(mask_reuse=True, device="cpu")
    with pytest.raises(ValueError, match="pipelined"):
        AudioZoom(cfg=PipelineConfig(win_size=32768), model="tpufpu_nano", int8=True,
                  mask_reuse=True, pipelined=True, device="cpu")
    with pytest.raises(ValueError, match="precision"):
        AudioZoom(dsp_precision="bf16", device="cpu")
    with pytest.raises(ValueError, match="one"):
        autosteer_enhance(torch.zeros(3, 2, 16000), PipelineConfig())


def test_default_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        AudioZoom()


# -- latency="low": the causal CRN and the online MVDR, hop by hop -----------

LOW_KW = dict(direction_deg=CENTER, fov_deg=FOV, zoom=0.4, latency="low")


def test_low_latency_defaults_to_the_causal_crn():
    z = AudioZoom(device="cpu", **LOW_KW)
    assert z.model == "crn_causal" and type(z._mask_net).__name__ == "CRNMaskNet"
    assert z._online.latency_samples == 1024 and z._online.sigma == pytest.approx(z.sigma)
    z.set_zoom(direction_deg=80.0, zoom=0.9)  # pushed into the stream
    assert (z._online.steer_deg, z._online.sigma) == (80.0, pytest.approx(z.sigma))


@pytest.fixture(scope="module")
def low_latency_reference(scene):
    """JAX's low-latency facade on the 3 s scene: push in 2048-sample
    blocks with the causal and the momentum tracker (bearings after each
    push), then enhance() of the clip."""
    mix = scene["mixture"]
    out = {}
    for tracker in ("causal", "momentum"):
        kw = dict(LOW_KW, track=True, tracker=tracker)
        z = azoom.AudioZoom(native=False, **kw)
        outs, bearings = [], []
        for i in range(0, mix.shape[1], 2048):
            outs.append(z.push(mix[:, i:i + 2048]))
            bearings.append(z._track_theta)
        out[tracker] = (np.concatenate(outs), bearings)
    out["enhance"] = azoom.AudioZoom(native=False, **LOW_KW).enhance(mix)
    return out


@pytest.mark.parametrize("tracker", ["causal", "momentum"])
def test_low_latency_push_matches_jax(scene, low_latency_reference, tracker):
    mix = scene["mixture"]
    z = AudioZoom(device="cpu", track=True, tracker=tracker, **LOW_KW)
    outs, bearings = [], []
    for i in range(0, mix.shape[1], 2048):
        outs.append(z.push(mix[:, i:i + 2048]))
        bearings.append(z._track_theta)
    ref, ref_bearings = low_latency_reference[tracker]
    assert bearings == ref_bearings  # the same bearing after every push
    print(f"[parity] low-latency push {tracker}: bearings {bearings[-1]}")
    _check(f"low-latency push {tracker}", np.concatenate(outs), ref, scene)


def test_low_latency_enhance_matches_jax(scene, low_latency_reference):
    got = AudioZoom(device="cpu", **LOW_KW).enhance(scene["mixture"])
    _check("low-latency enhance", got, low_latency_reference["enhance"], scene)
