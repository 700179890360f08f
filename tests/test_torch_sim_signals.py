"""The port's synthetic signals (azoom_torch.sim.signals) and fractional
delay on the CPU against azoom.sim.signals and azoom.dsp.delays.

The port takes a torch.Generator where the reference takes a JAX key, so a
seed gives other signals than the key with the same number. Parity is held
on the render step, fed the reference's own draws (made here from its key
split tree), and on the statistics the reference's tests check
(tests/test_interferer_kinds.py:44-80).

Bounds (ROADMAP.md Queue C, "Scene simulation"):
- render steps within 1e-3 relative L2 of the jitted reference at 2 s and
  4 s. The float32 phase of a long clip differs by ulps that the harmonics
  multiply, and XLA's fusion changes those ulps too: measured (speech,
  f0 200 Hz, key 3) 2.2e-4 at 2 s, 3.1e-4 at 4 s; music 2.5e-4 and 7.8e-4
  (the port takes the music phase's cumulative sum in float64 and rounds
  once, and the pitch contour and the scale on the host, so the card and
  the CPU agree);
- a 10 s clip no further from the jitted reference than twice the
  reference's jitted-against-eager distance plus 1e-4;
- coloured noise and fractional_delay within 1e-5 (measured ~4e-7).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from azoom.dsp.delays import fractional_delay as jax_fractional_delay
from azoom.sim import signals as J
from azoom_torch.dsp.delays import fractional_delay
from azoom_torch.dsp.stft import stft
from azoom_torch.sim import signals as T

FS = 16_000
RENDER_BOUND = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU work in one thread while this file runs (the suite's
    other workers share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


def _speech_draws(key, n):
    """azoom.sim.signals.speech_like's draws from its key."""
    k_f0, k_am1, k_am2, k_noise, _ = jax.random.split(key, 5)
    return (_t(jax.random.normal(k_f0, (64,))), _t(jax.random.uniform(k_am1)),
            _t(jax.random.uniform(k_am2)), _t(jax.random.normal(k_noise, (n,))))


def _stacked_speech_draws(keys, n):
    return [torch.stack(d) for d in zip(*(_speech_draws(k, n) for k in keys))]


def _reference_and_render(kind, key, n):
    """(the reference's signal, the port's render of the reference's draws)."""
    if kind == "speech":
        return (J.speech_like(key, n, FS, 200.0),
                T._speech_render(*_speech_draws(key, n), n, FS, 200.0))
    if kind == "speech_batch":
        keys = jax.random.split(key, 3)
        return (J.speech_like_batch(key, 3, n, FS),
                T._speech_render(*_stacked_speech_draws(keys, n), n, FS,
                                 T._batch_f0s(3, "cpu")))
    if kind == "music":
        k_notes, k_det, k_env, k_vib = jax.random.split(key, 4)
        steps = jax.random.randint(k_notes, (T._n_notes(n, FS),), 0, 6)
        u = [_t(jax.random.uniform(k)) for k in (k_det, k_env, k_vib)]
        return J.music_like(key, n, FS), T._music_render(_t(steps), *u, n, FS)
    if kind == "noise":
        k_slope, k_noise = jax.random.split(key)
        slope = 0.5 + 1.3 * jax.random.uniform(k_slope)
        return (J.colored_noise(key, n, FS),
                T._noise_render(_t(jax.random.normal(k_noise, (n,))), _t(slope), n, FS))
    if kind == "babble":
        kf, ks = jax.random.split(key)
        f0s = jax.random.uniform(kf, (6,), minval=95.0, maxval=300.0)
        draws = _stacked_speech_draws(jax.random.split(ks, 6), n)
        return J.babble_like(key, n, FS), T._babble_render(_t(f0s), *draws, n, FS)
    raise AssertionError(kind)


@pytest.mark.parametrize("seconds", [2, 4])
@pytest.mark.parametrize("kind", ["speech", "speech_batch", "music", "noise", "babble"])
def test_render_matches_the_reference_on_its_draws(kind, seconds):
    ref, got = _reference_and_render(kind, jax.random.PRNGKey(3), seconds * FS)
    rel = _rel(got, ref)
    print(f"[signals] {kind} {seconds} s: rel L2 {rel:.2e}")
    assert got.shape == ref.shape and got.dtype == torch.float32
    assert rel <= (1e-5 if kind == "noise" else RENDER_BOUND)


def test_long_speech_clip_stays_within_the_references_own_spread():
    n = 10 * FS
    key = jax.random.PRNGKey(3)
    ref, got = _reference_and_render("speech", key, n)
    with jax.disable_jit():
        eager = J.speech_like(key, n, FS, 200.0)
    spread, rel = _rel(eager, ref), _rel(got, ref)
    print(f"[signals] speech 10 s: port {rel:.2e}, reference jit vs eager {spread:.2e}")
    assert rel <= 2 * spread + 1e-4


@pytest.mark.parametrize("kind", ["speech", "babble", "music", "noise", "mixed"])
def test_generator_path(kind):
    """Same seed, same bits; another seed, another signal; peak 1; no
    global RNG (torch's global seed changes nothing)."""
    def draw(seed, global_seed):
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(global_seed)
            g = torch.Generator().manual_seed(seed)
            return T.interferer_signal(g, 8_000, FS, kind, device="cpu")

    a, b, c = draw(5, 0), draw(5, 1), draw(6, 0)
    assert a.shape == (8_000,) and a.dtype == torch.float32
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    assert bool(torch.isfinite(a).all()) and 0.999 < float(a.abs().max()) <= 1.0 + 1e-6
    assert float(a.std()) > 0.01


def test_mixed_draws_the_class_then_the_signal():
    for seed in range(4):
        g = torch.Generator().manual_seed(seed)
        twin = torch.Generator().manual_seed(seed)
        kind = T.INTERFERER_KINDS[int(torch.randint(0, 4, (), generator=twin))]
        got = T.interferer_signal(g, 4_000, FS, "mixed", f0=140.0, device="cpu")
        assert torch.equal(got, T.interferer_signal(twin, 4_000, FS, kind, f0=140.0,
                                                    device="cpu"))


def test_entry_points_take_the_generator_in_the_keys_place():
    g = torch.Generator().manual_seed(0)
    batch = T.speech_like_batch(g, 3, 4_000, FS, device="cpu")
    assert batch.shape == (3, 4_000)
    assert not torch.equal(batch[0], batch[1])
    assert T.speech_like(g, 4_000, FS, 150.0, device="cpu").shape == (4_000,)
    assert T.colored_noise(g, 4_000, FS, slope=1.0, device="cpu").shape == (4_000,)
    assert T.babble_like(g, 4_000, FS, n_talkers=3, device="cpu").shape == (4_000,)
    with pytest.raises(ValueError, match="unknown interferer kind"):
        T.interferer_signal(g, 4_000, FS, "whalesong", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            T.speech_like(g, 4_000)


# The reference's statistics (tests/test_interferer_kinds.py:44-80), on the
# generator path.

def test_noise_spectral_slope():
    x = T.colored_noise(torch.Generator().manual_seed(1), 4 * 32_000, FS, slope=2.0,
                        device="cpu").numpy()
    X = np.abs(np.fft.rfft(x)) ** 2
    f = np.fft.rfftfreq(x.size, 1.0 / FS)
    band = lambda lo, hi: X[(f >= lo) & (f < hi)].mean()  # noqa: E731
    assert 14.0 < 10 * np.log10(band(150, 250) / band(1500, 2500)) < 26.0


def _spec(x):
    return stft(x, 1024, 512).abs()


def test_music_is_less_sparse_than_speech_in_time():
    def duty(x):
        env = torch.sqrt(torch.mean(_spec(x) ** 2, dim=0))
        return float((env > 0.05 * env.max()).float().mean())

    sp = T.speech_like(torch.Generator().manual_seed(2), 32_000, FS, device="cpu")
    mu = T.music_like(torch.Generator().manual_seed(2), 32_000, FS, device="cpu")
    assert duty(mu) > duty(sp)


def test_babble_fills_tf_gaps():
    def gap_fraction(x):
        S = _spec(x)
        return float((S < 0.001 * S.max()).float().mean())

    one = T.speech_like(torch.Generator().manual_seed(3), 32_000, FS, device="cpu")
    bab = T.babble_like(torch.Generator().manual_seed(3), 32_000, FS, device="cpu")
    assert gap_fraction(bab) < 0.5 * gap_fraction(one)


@pytest.mark.parametrize("lead", [(), (3,), (2, 3)])
def test_fractional_delay_matches_the_reference(lead):
    rng = np.random.default_rng(len(lead))
    x = rng.standard_normal(lead + (2, 8_001)).astype(np.float32)
    tau = (3e-4 * rng.standard_normal(lead + (2,))).astype(np.float32)
    got = fractional_delay(x, tau, FS, device="cpu")
    ref = jax_fractional_delay(jnp.asarray(x), jnp.asarray(tau), FS)
    assert got.shape == ref.shape and got.dtype == torch.float32
    assert _rel(got, ref) <= 1e-5
    scalar = fractional_delay(torch.from_numpy(x), 1.25 / FS, FS)
    assert _rel(scalar, jax_fractional_delay(jnp.asarray(x), 1.25 / FS, FS)) <= 1e-5
