"""The port's low-latency path on the CPU against the JAX package:
azoom.stream.online (online_masked_mvdr, online_enhance),
azoom.pipelines.online_learned.online_learned_enhance and
azoom.stream.lowlat.OnlineEnhancer with the bundled crn_causal net, and the
port's own stream against its offline pipeline.

Scene: 2 s, a target at 75 deg, interferers at 40 and 130 deg, 4 cm (the
reference's low-latency test scene, cut from 8 s to 2 s).

Bounds: the online MVDR against JAX: relative error <= 1e-4 of the output's
peak (float32 roundings through a recursion over 40 frames; measured
~1e-6). Whole pipelines against JAX: waveform relative L2 <= 1e-2 (the
port's standing bound) and SIR within 0.05 dB, measured ~1e-5 (printed with
``-s``). The port's stream against the port's offline pipeline on the
finalized samples: max abs <= 1e-5 (the reference holds its own to 1e-4):
one hop's frame goes through the same frame transforms and the CRN's
products give the same bits for one frame or many, so what remains is the
CPU kernels' elementwise tails (measured ~1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from azoom.config import PipelineConfig as JaxConfig
from azoom.dsp.delays import steering_vector as jax_steering
from azoom.eval.projection import osinr_osir
from azoom.models.pretrained import load_pretrained_crn_causal
from azoom.pipelines.online_learned import online_learned_enhance as jax_online_learned
from azoom.sim.farfield import make_scene
from azoom.sim.signals import speech_like_batch
from azoom.stream.lowlat import OnlineEnhancer as JaxOnlineEnhancer
from azoom.stream.online import online_enhance as jax_online_enhance
from azoom.stream.online import online_masked_mvdr as jax_online_mvdr
from azoom_torch import kernels
from azoom_torch.config import PipelineConfig
from azoom_torch.dsp.delays import steering_vector
from azoom_torch.kernels.online_mvdr_kernel import online_mvdr
from azoom_torch.models.pretrained import load_bundled
from azoom_torch.pipelines.online_learned import online_learned_enhance
from azoom_torch.stream.lowlat import OnlineEnhancer
from azoom_torch.stream.online import (
    initial_state, online_enhance, online_masked_mvdr, online_masked_mvdr_state,
)

STEER = 75.0
JCFG = JaxConfig(mic_dist=0.04, angle_target_deg=STEER)
CFG = PipelineConfig(mic_dist=0.04, angle_target_deg=STEER)


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
    sigs = speech_like_batch(jax.random.PRNGKey(2), 3, 32_000, 16_000)
    sc = make_scene(sigs[0], sigs[1:], STEER, jnp.asarray([40.0, 130.0]), 0.04, 16_000)
    return {k: np.asarray(v) for k, v in sc.items()}


@pytest.fixture(scope="module")
def nets():
    jm, jv = load_pretrained_crn_causal()
    tm, _ = load_bundled("crn_causal", device="cpu")
    return jm, jv, tm


@pytest.fixture(scope="module")
def offline(scene, nets):
    """The port's offline online_learned_enhance of the scene."""
    return online_learned_enhance(torch.from_numpy(scene["mixture"]), nets[2], CFG).numpy()


def _check(tag, got, ref, sc=None, bound=1e-2, sir_bound=0.05):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and got.size > 0
    rel = float(np.linalg.norm(got - ref) / np.linalg.norm(ref))
    print(f"[parity] {tag} wave_rel_l2={rel:.3e}")  # shown with pytest -s
    assert rel <= bound, f"{tag}: waveform relative L2 {rel:.3e}"
    if sc is not None:
        n = got.shape[-1]
        t, i = jnp.asarray(sc["target_ref"][:n]), jnp.asarray(sc["interference_ref"][:n])
        d_sir = float(osinr_osir(jnp.asarray(got), t, i)[1] - osinr_osir(jnp.asarray(ref), t, i)[1])
        print(f"[parity] {tag} dsir_db={d_sir:+.4f}")
        assert abs(d_sir) <= sir_bound, f"{tag}: SIR differs by {d_sir:.4f} dB"


def _mvdr_inputs(seed=0, F=65, T=40):
    rng = np.random.default_rng(seed)
    Y = (rng.standard_normal((2, F, T)) + 1j * rng.standard_normal((2, F, T))).astype(np.complex64)
    m = rng.random((F, T), dtype=np.float32)
    freqs = (np.arange(F) * 125.0).astype(np.float32)
    return Y, m, freqs


@pytest.mark.parametrize("forget", [0.98, 1.0])
def test_online_masked_mvdr_matches_jax(forget):
    Y, m, freqs = _mvdr_inputs()
    d_j = jax_steering(jnp.asarray(freqs), 60.0, 0.04)
    ref = np.asarray(jax_online_mvdr(jnp.asarray(Y), jnp.asarray(m), d_j, jnp.asarray(freqs),
                                     sigma=1e-3, forget=forget))
    d = steering_vector(torch.from_numpy(freqs), 60.0, 0.04)
    got = online_masked_mvdr(torch.from_numpy(Y), torch.from_numpy(m), d,
                             torch.from_numpy(freqs), sigma=1e-3, forget=forget).numpy()
    err = float(np.abs(got - ref).max() / np.abs(ref).max())
    print(f"[parity] online_masked_mvdr forget={forget}: rel={err:.3e}")
    assert got.shape == ref.shape and err <= 1e-4
    assert np.all(got[:1] == 0)  # bin 0 (0 Hz) is below the 100 Hz cutoff


def test_online_mvdr_state_carries_across_calls():
    """Two calls with the state carried equal one call over both blocks (the
    per-hop stream's contract), bit for bit on the CPU; the floored gain
    fused into the call is the reference's post-multiplication."""
    Y, m, freqs = (torch.from_numpy(a) for a in _mvdr_inputs(1))
    d = steering_vector(freqs, 100.0, 0.04)
    g = 1.0 - m
    kw = dict(target_mask=g, mask_floor=0.05, sigma=1e-4)
    whole, _ = online_masked_mvdr_state(Y, m, d, freqs, **kw)
    state = initial_state((), 65)
    a, state = online_masked_mvdr_state(Y[..., :17].contiguous(), m[:, :17].contiguous(), d, freqs,
                                        state, target_mask=g[:, :17].contiguous(), mask_floor=0.05,
                                        sigma=1e-4)
    b, _ = online_masked_mvdr_state(Y[..., 17:].contiguous(), m[:, 17:].contiguous(), d, freqs,
                                    state, target_mask=g[:, 17:].contiguous(), mask_floor=0.05,
                                    sigma=1e-4)
    assert torch.equal(torch.cat([a, b], dim=-1), whole)
    plain = online_masked_mvdr(Y, m, d, freqs, sigma=1e-4) * torch.clamp(g, min=0.05)
    assert torch.equal(plain, whole)


def test_online_mvdr_wrapper_on_the_cpu():
    """A CPU tensor takes the plain loop (no launch), at M = 2 and, through
    beam.linalgmm's Cholesky, at M = 3, there against JAX's scan at this
    file's online-MVDR bound."""
    Y, m, freqs = (torch.from_numpy(a) for a in _mvdr_inputs(2, T=3))
    d = steering_vector(freqs, 90.0, 0.04)
    before = dict(kernels.launches)
    R, w = initial_state((), 65)
    online_mvdr(Y, m, d, freqs, R, w)
    assert kernels.launches == before
    assert not torch.equal(w, torch.full_like(w, 1e-6))  # the state moved
    rng = np.random.default_rng(9)  # a third, independent channel
    Y3 = torch.cat([Y, torch.complex(*(torch.from_numpy(rng.standard_normal((1,) + m.shape))
                                         .float() for _ in range(2)))])
    d3 = steering_vector(freqs, 70.0, 0.04, n_mics=3)
    got = online_masked_mvdr(Y3, m, d3, freqs, sigma=1e-3)
    assert kernels.launches == before
    ref = np.asarray(jax_online_mvdr(jnp.asarray(Y3.numpy()), jnp.asarray(m.numpy()),
                                     jax_steering(jnp.asarray(freqs.numpy()), 70.0, 0.04, n_mics=3),
                                     jnp.asarray(freqs.numpy()), sigma=1e-3))
    err = float(np.abs(got.numpy() - ref).max() / np.abs(ref).max())
    print(f"[parity] online_masked_mvdr at three mics: rel={err:.3e}")
    assert err <= 1e-4


@pytest.mark.parametrize("forget", [0.98, 1.0])
def test_online_enhance_matches_jax(scene, forget):
    mix = scene["mixture"][:, :16_000]
    rng = np.random.default_rng(3)
    noise = rng.random((513, 33), dtype=np.float32)
    ref = np.asarray(jax_online_enhance(jnp.asarray(mix), jnp.asarray(noise), JCFG, forget))
    got = online_enhance(mix, noise, CFG, forget, device="cpu")
    assert got.device.type == "cpu"
    _check(f"online_enhance forget={forget}", got.numpy(), ref)


@pytest.mark.parametrize("steer_align", [True, False], ids=["aligned", "unaligned"])
def test_online_learned_enhance_matches_jax(scene, nets, offline, steer_align):
    jm, jv, tm = nets
    ref = np.asarray(jax_online_learned(jnp.asarray(scene["mixture"]), jm, jv, JCFG,
                                        steer_align=steer_align))
    got = offline if steer_align else online_learned_enhance(
        torch.from_numpy(scene["mixture"]), tm, CFG, steer_align=False).numpy()
    _check(f"online_learned_enhance steer_align={steer_align}", got, ref, scene)


def _stream(model, mix, block, **kw):
    oe = OnlineEnhancer(CFG, model, steer_deg=STEER, device="cpu", **kw)
    return np.concatenate([oe.push(mix[:, i:i + block]) for i in range(0, mix.shape[1], block)])


@pytest.mark.parametrize("block", [1000, 512, 2048, 7])
def test_stream_equals_the_port_offline(scene, nets, offline, block):
    mix = scene["mixture"]
    before = kernels.launches["online_mvdr"]
    out = _stream(nets[2], mix, block)
    assert kernels.launches["online_mvdr"] == before  # the CPU runs the plain loop
    n = out.shape[0]
    assert n >= mix.shape[1] - 2 * CFG.n_fft and n % CFG.hop == 0
    err = float(np.abs(out - offline[:n]).max())
    print(f"[parity] stream block={block} vs offline: max={err:.3e}")
    assert err <= 1e-5


def test_stream_flush_reset_and_latency(scene, nets, offline):
    tm = nets[2]
    oe = OnlineEnhancer(CFG, tm, device="cpu")
    assert oe.latency_samples == CFG.n_fft  # 64 ms at 16 kHz
    rng = np.random.default_rng(0)
    total_in = total_out = 0
    for _ in range(12):  # after k samples in, at least k - 2 hops are out
        block = (0.1 * rng.standard_normal((2, 800))).astype(np.float32)
        total_in += 800
        total_out += oe.push(block).shape[0]
        assert total_out >= total_in - 2 * CFG.hop
    mix = scene["mixture"][:, :10_000]
    oe = OnlineEnhancer(CFG, tm, steer_deg=STEER, device="cpu")
    out = oe.push(mix)
    out_f = oe.flush()
    assert out.shape[0] + out_f.shape[0] >= 10_000  # the whole clip finalized
    ref = online_learned_enhance(torch.from_numpy(mix), tm, CFG).numpy()
    both = np.concatenate([out, out_f])[:10_000]
    assert np.abs(both - ref).max() <= 1e-5  # the padded tail changes nothing before it
    oe.reset()
    assert np.array_equal(oe.push(mix), out)  # the state is fully cleared


def test_direction_and_sigma_mid_stream_match_jax(scene, nets):
    """set_direction and set_sigma between pushes, the same changes in JAX's
    OnlineEnhancer: the same stream."""
    jm, jv, tm = nets
    mix = scene["mixture"]
    changes = {8: ("dir", 60.0), 16: ("sigma", 1e-3), 24: ("dir", 90.0)}
    j = JaxOnlineEnhancer(JCFG, jm, jv, steer_deg=STEER)
    t = OnlineEnhancer(CFG, tm, steer_deg=STEER, device="cpu")
    outs_j, outs_t = [], []
    for k, i in enumerate(range(0, mix.shape[1], 1000)):
        if k in changes:
            what, val = changes[k]
            for oe in (j, t):
                oe.set_direction(val) if what == "dir" else oe.set_sigma(val)
        outs_j.append(j.push(mix[:, i:i + 1000]))
        outs_t.append(t.push(mix[:, i:i + 1000]))
    assert (t.steer_deg, t.sigma) == (90.0, 1e-3)
    _check("OnlineEnhancer with changes", np.concatenate(outs_t), np.concatenate(outs_j))


def test_online_enhancer_rejects():
    tm, _ = load_bundled("crn_causal", device="cpu")
    with pytest.raises(ValueError, match="50%"):
        OnlineEnhancer(PipelineConfig(n_fft=1024, hop=256), tm, device="cpu")
    # three mics stream (tests/test_torch_mmic_live.py holds M = 4 against JAX)
    oe = OnlineEnhancer(PipelineConfig(n_mics=3), tm, device="cpu")
    assert oe._R.shape == (513, 3, 3)
    with pytest.raises(ValueError, match="channels|shape|size"):
        oe.push(np.zeros((2, 512), np.float32))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            OnlineEnhancer(CFG, tm)
