"""Arrays of three and four mics on the streaming paths, on the CPU against
azoom: learned_enhance_streaming (the 2 s / 50 % chunker, float fpu),
online_enhance, online_learned_enhance and OnlineEnhancer with the bundled
crn_causal, and AudioZoom at high (the float fpu, the reference's M-mic
facade call) and low latency. The batch paths are in
tests/test_torch_mmic.py, whose scenes and checks these tests share, the
server in tests/test_torch_mmic_server.py.

Bounds, those of each path's 2-mic counterpart (ROADMAP Queue C): waveform
relative L2 <= 2e-2 and SIR within 0.05 dB through the conv net (the
chunker, the facade); <= 1e-3 for the online MVDR and the causal CRN's
paths. Measured at M = 4 (``-s`` prints each, M = 3 beside them): the
chunker on 3 s 1.2e-4, online_enhance 5.5e-5, online_learned_enhance
1.8e-4, OnlineEnhancer pushed in 4096-sample blocks 1.7e-4, AudioZoom
1.5e-6 (high) and 6.6e-6 (low); every SIR within 0.002 dB.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import azoom
from azoom.dsp.stft import stft as jax_stft
from azoom.masks.oracle import ibm_noise_mask as jax_ibm_noise_mask
from azoom.models.pretrained import load_pretrained_crn_causal
from azoom.pipelines.learned import learned_enhance_streaming as jax_streaming
from azoom.pipelines.online_learned import online_learned_enhance as jax_online_learned
from azoom.stream.lowlat import OnlineEnhancer as JaxOnlineEnhancer
from azoom.stream.online import online_enhance as jax_online_enhance
from azoom_torch import AudioZoom, kernels, learned_enhance_streaming, load_bundled
from azoom_torch.pipelines.online_learned import online_learned_enhance
from azoom_torch.stream.lowlat import OnlineEnhancer
from azoom_torch.stream.online import online_enhance
from test_torch_mmic import (  # noqa: F401 (fpu: the shared net fixture)
    LEARNED_BOUND, PLAIN_BOUND, _check, configs, fpu, scene,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU work in one thread while this file runs (the suite's
    other workers share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def crn():
    jm, jv = load_pretrained_crn_causal()
    tm, _ = load_bundled("crn_causal", device="cpu")
    return jm, jv, tm


@pytest.mark.parametrize("M", [3, 4])
def test_online_enhance_matches_jax(M):
    sc, (jcfg, cfg) = scene(M, 16_000), configs(M)
    noise = np.array(jax_ibm_noise_mask(jax_stft(sc["target_ref"], jcfg.n_fft, jcfg.hop),
                                        jax_stft(sc["interference_ref"], jcfg.n_fft, jcfg.hop)))
    ref = jax_online_enhance(jnp.asarray(sc["mixture"]), jnp.asarray(noise), jcfg)
    got = online_enhance(sc["mixture"], noise, cfg, device="cpu").numpy()
    _check(f"online_enhance M={M}", got, ref, sc["target_ref"], sc["interference_ref"],
           PLAIN_BOUND)


@pytest.fixture(scope="module", params=[3, 4])
def online_reference(request, crn):
    """The reference's causal pipeline at M mics on 1 s, offline and pushed
    in 4096-sample blocks: (M, scene, offline, pushed)."""
    jm, jv, _ = crn
    M = request.param
    sc = scene(M, 16_000)
    cfg = configs(M, angle_target_deg=80.0)[0]
    offline = np.asarray(jax_online_learned(jnp.asarray(sc["mixture"]), jm, jv, cfg))
    oe = JaxOnlineEnhancer(cfg, jm, jv, steer_deg=80.0)
    mix = sc["mixture"]
    pushed = np.concatenate([oe.push(mix[:, i:i + 4096]) for i in range(0, mix.shape[1], 4096)])
    return M, sc, offline, pushed


def test_online_learned_matches_jax(crn, online_reference):
    M, sc, ref, _ = online_reference
    got = online_learned_enhance(torch.from_numpy(sc["mixture"]), crn[2],
                                 configs(M, angle_target_deg=80.0)[1]).numpy()
    _check(f"online_learned M={M}", got, ref, sc["target_ref"], sc["interference_ref"],
           PLAIN_BOUND)


def test_online_enhancer_matches_jax(crn, online_reference):
    M, sc, _, ref = online_reference
    oe = OnlineEnhancer(configs(M, angle_target_deg=80.0)[1], crn[2], steer_deg=80.0,
                        device="cpu")
    mix = sc["mixture"]
    before = dict(kernels.launches)
    got = np.concatenate([oe.push(mix[:, i:i + 4096]) for i in range(0, mix.shape[1], 4096)])
    assert kernels.launches == before
    _check(f"OnlineEnhancer M={M}", got, ref, sc["target_ref"], sc["interference_ref"],
           PLAIN_BOUND)


@pytest.mark.parametrize("M", [3, 4])
@pytest.mark.parametrize("latency", ["high", "low"])
def test_audiozoom_enhance_matches_jax(latency, M):
    """The reference's M-mic facade call (tests/test_mmic.py::test_facade_enhance_at_m4):
    AudioZoom(cfg=n_mics M, model="fpu"); at low latency the causal crn."""
    sc, (jcfg, cfg) = scene(M), configs(M)
    kw = dict(direction_deg=90.0, latency=latency)
    if latency == "high":
        kw["model"] = "fpu"
    ref = azoom.AudioZoom(cfg=jcfg, native=False, **kw).enhance(sc["mixture"])
    got = AudioZoom(cfg=cfg, device="cpu", **kw).enhance(sc["mixture"])
    assert got.shape == (32_000,)
    bound = LEARNED_BOUND if latency == "high" else PLAIN_BOUND
    _check(f"AudioZoom {latency} M={M}", got, ref, sc["target_ref"], sc["interference_ref"],
           bound)


@pytest.mark.parametrize("M", [3, 4])
def test_learned_streaming_matches_jax(fpu, M):
    jm, jv, tm = fpu
    sc, (jcfg, cfg) = scene(M, 48_000), configs(M)
    ref = np.asarray(jax_streaming(jnp.asarray(sc["mixture"]), jm, jv, jcfg,
                                   feature_kind="logmag_ipd"))
    got = learned_enhance_streaming(torch.from_numpy(sc["mixture"]), tm, cfg,
                                    feature_kind="logmag_ipd").numpy()
    _check(f"streaming 3 s M={M}", got, ref, sc["target_ref"], sc["interference_ref"],
           LEARNED_BOUND)
