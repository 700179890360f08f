"""Synthetic speech-like test signals (counterpart of azoom.sim.signals).

A voiced harmonic series with a randomly walking pitch contour,
formant-shaped, under a syllabic amplitude envelope, plus an unvoiced noise
floor; and three non-speech interferer classes (coloured noise, harmonic
music, multi-talker babble). These have the spectro-temporal sparsity that
makes IBM masking meaningful, which the oracle path needs for its ~36 dB SIR.

Randomness. The reference's generators are pure functions of a JAX PRNG
key; here each takes a ``torch.Generator`` in the key's place, in the same
position, and none draws from a global RNG. Each is split into a private
*draw* step, which takes the random numbers from the generator in the
reference's shapes (on the generator's device), and a deterministic
*render* step, which computes the signal from them on the entry point's
device. A CPU generator with a given seed therefore gives the same signal on
the card and on the CPU, up to rendering. A seed gives other signals than
JAX's key with the same number: parity with the reference is held on the
render step, fed the reference's own draws.

Every entry point renders on CUDA unless ``device`` names another device.
"""

from __future__ import annotations

import math

import torch

from azoom_torch.config import resolve_device

__all__ = [
    "speech_like",
    "speech_like_batch",
    "colored_noise",
    "music_like",
    "babble_like",
    "interferer_signal",
    "INTERFERER_KINDS",
]

N_CTRL = 64  # pitch-contour control points


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _normal(g: torch.Generator, shape, device) -> torch.Tensor:
    return torch.randn(shape, generator=g, device=g.device).to(device)


def _uniform(g: torch.Generator, shape, device) -> torch.Tensor:
    return torch.rand(shape, generator=g, device=g.device).to(device)


def _div(x: torch.Tensor, d: float) -> torch.Tensor:
    """x / d with d as a device tensor: CUDA turns division by a host scalar
    into a product with its reciprocal, which rounds otherwise (a note grid
    that flips one sample shifts every later phase)."""
    return x / torch.tensor(d, dtype=x.dtype, device=x.device)


def _time_axis(n_samples: int, fs: int, device) -> torch.Tensor:
    return _div(torch.arange(n_samples, dtype=torch.float32, device=device), fs)


def _peak_normalize(x: torch.Tensor) -> torch.Tensor:
    return x / (x.abs().amax(dim=-1, keepdim=True) + 1e-9)


# -- speech ------------------------------------------------------------------


def _speech_draws(g: torch.Generator, n_samples: int, lead=(), device=None) -> tuple:
    """The reference's draws of one utterance, each with leading dims
    ``lead``: the pitch walk's (64,) normal, the two envelope uniforms and
    the (n,) noise. The reference draws the first envelope's rate and phase
    from the same key (so its phase is pi (r1 - 2)), the second's likewise:
    one uniform each, used twice."""
    lead = tuple(lead)
    walk = _normal(g, lead + (N_CTRL,), device)
    u1 = _uniform(g, lead, device)
    u2 = _uniform(g, lead, device)
    noise = _normal(g, lead + (n_samples,), device)
    return walk, u1, u2, noise


def _phase_ctrl(walk: torch.Tensor, f0_base: torch.Tensor, n_samples: int,
                fs: int) -> torch.Tensor:
    """The pitch contour's phase on the control grid (..., 64), float32 in
    the reference's order."""
    walk = torch.cumsum(walk * 0.06, dim=-1)
    walk = walk - walk.mean(dim=-1, keepdim=True)
    f0_ctrl = f0_base * torch.exp(walk.clamp(-0.35, 0.35))
    dt_ctrl = n_samples / fs / (N_CTRL - 1)
    steps = torch.cumsum(0.5 * (f0_ctrl[..., 1:] + f0_ctrl[..., :-1]), dim=-1)
    return 2.0 * math.pi * dt_ctrl * torch.cat([torch.zeros_like(steps[..., :1]), steps], -1)


def _speech_render(walk, u1, u2, noise, n_samples: int, fs: int, f0_base) -> torch.Tensor:
    """One utterance per leading index from its draws ((..., 64), (...,),
    (...,), (..., n)), in float32 in the reference's order. ``f0_base`` is a
    float or a (...,) tensor."""
    dev = walk.device
    f0_base = _f32(f0_base, dev)[..., None]  # (..., 1)
    t = _time_axis(n_samples, fs, dev)

    # Pitch contour: a smoothed random walk, +/- ~20 % around f0_base, its
    # trapezoid phase integral on the 64-point control grid (computed on the
    # host, so that every device integrates the same contour: the harmonics
    # multiply any ulp of it) linearly interpolated to the sample rate.
    phase_ctrl = _phase_ctrl(walk.cpu(), f0_base.cpu(), n_samples, fs).to(dev)
    pos = torch.arange(n_samples, dtype=torch.float32, device=dev) * (
        (N_CTRL - 1) / max(n_samples - 1, 1))
    idx = pos.to(torch.int32).clamp(0, N_CTRL - 2).long()
    frac = pos - idx
    phase0 = phase_ctrl[..., idx] * (1.0 - frac) + phase_ctrl[..., idx + 1] * frac  # (..., n)

    harmonics = torch.arange(1, 13, dtype=torch.float32, device=dev)
    f_h = harmonics * f0_base  # (..., 12): formant-ish envelope at ~500 and ~1500 Hz
    formant = (torch.exp(-(_div(f_h - 500.0, 350.0) ** 2))
               + 0.6 * torch.exp(-(_div(f_h - 1500.0, 500.0) ** 2)) + 0.15)
    amp_h = formant / harmonics
    voiced = torch.sum(amp_h[..., :, None] * torch.sin(harmonics[:, None] * phase0[..., None, :]),
                       dim=-2)

    # Syllabic AM: two raised sinusoids with random rate and phase.
    r1, r2 = (2.0 + 2.0 * u1)[..., None], (5.0 + 4.0 * u2)[..., None]
    p1, p2 = (2.0 * math.pi * u1)[..., None], (2.0 * math.pi * u2)[..., None]
    am = ((0.55 + 0.45 * torch.sin(2 * math.pi * r1 * t + p1))
          * (0.6 + 0.4 * torch.sin(2 * math.pi * r2 * t + p2)))
    am = am.clamp(min=0.0) ** 1.5

    # Unvoiced floor: first-differenced white noise.
    noise = torch.diff(noise, dim=-1, prepend=torch.zeros_like(noise[..., :1])) * 0.02
    x = voiced * am + noise * (0.3 + 0.7 * (1.0 - am))
    return _peak_normalize(x)


def speech_like(generator: torch.Generator, n_samples: int, fs: int = 16_000,
                f0_base: float = 160.0, device=None) -> torch.Tensor:
    """One synthetic utterance (n_samples,), float32, peak 1: 12 harmonics
    under a random-walk pitch around ``f0_base`` with a 1/h tilt and
    formant shaping, two syllable-rate (~3 Hz, ~7 Hz) envelopes with random
    phase, and a high-passed noise floor for unvoiced consonants."""
    dev = resolve_device(device)
    return _speech_render(*_speech_draws(generator, n_samples, (), dev), n_samples, fs, f0_base)


def _batch_f0s(n_signals: int, device) -> torch.Tensor:
    f0s = 110.0 * (1.35 ** torch.arange(n_signals, dtype=torch.float32, device=device))
    return f0s.clamp(90.0, 320.0)


def speech_like_batch(generator: torch.Generator, n_signals: int, n_samples: int,
                      fs: int = 16_000, device=None) -> torch.Tensor:
    """(n_signals, n_samples) utterances with distinct pitch registers
    (110 Hz x 1.35^i, clipped to [90, 320]), rendered as one batch."""
    dev = resolve_device(device)
    draws = _speech_draws(generator, n_samples, (n_signals,), dev)
    return _speech_render(*draws, n_samples, fs, _batch_f0s(n_signals, dev))


# -- non-speech interferers ----------------------------------------------------


def _noise_render(white: torch.Tensor, slope, n_samples: int, fs: int) -> torch.Tensor:
    dev = white.device
    X = torch.fft.rfft(white, dim=-1)
    f = _div(torch.arange(n_samples // 2 + 1, dtype=torch.float32, device=dev), 1.0 / fs * n_samples)
    slope = _f32(slope, dev)
    shape = torch.where(f > 0, f.clamp(min=1e-3) ** (-0.5 * slope), 0.0)
    # A 50 Hz high-pass knee, so that "brown" is not DC rumble.
    shape = shape * (1.0 - torch.exp(-(_div(f, 50.0) ** 2)))
    return _peak_normalize(torch.fft.irfft(X * shape, n=n_samples, dim=-1))


def colored_noise(generator: torch.Generator, n_samples: int, fs: int = 16_000,
                  slope=None, device=None) -> torch.Tensor:
    """Steady 1/f^slope noise (fan, traffic, crowd floor); ``slope`` 0 is
    white, 1 pink, 2 brown; by default a uniform draw in [0.5, 1.8]."""
    dev = resolve_device(device)
    if slope is None:
        slope = 0.5 + 1.3 * _uniform(generator, (), dev)
    return _noise_render(_normal(generator, (n_samples,), dev), slope, n_samples, fs)


def _n_notes(n_samples: int, fs: int) -> int:
    return max(int(n_samples / fs * 3), 2)  # ~3 notes a second


def _music_render(steps, u_det, u_env, u_vib, n_samples: int, fs: int,
                  base_hz: float = 220.0) -> torch.Tensor:
    """Two voices a fifth apart stepping through a pentatonic scale
    (``steps``: (N,) scale indices in [0, 6)), with note envelopes and
    vibrato. The phase is a cumulative sum over samples, taken in float64
    and rounded once (the same bits on every device)."""
    dev = steps.device
    t = _time_axis(n_samples, fs, dev)
    dur = n_samples / fs
    n_notes = _n_notes(n_samples, fs)
    # The scale's six pitches on the host: every device steps through the
    # same frequencies (the cumulative phase multiplies any ulp of them).
    scale = base_hz * 2.0 ** (torch.tensor([0.0, 2.0, 4.0, 7.0, 9.0, 12.0]) / 12.0)
    note_f0 = scale.to(dev)[steps.long()]
    grid = _div(t, dur) * n_notes
    pos = grid.to(torch.int32).clamp(0, n_notes - 1).long()
    f0_t = note_f0[pos]
    vib = 1.0 + 0.004 * torch.sin(2 * math.pi * 5.5 * t + 2 * math.pi * u_vib)
    phase = _div(2.0 * math.pi * torch.cumsum((f0_t * vib).double(), dim=-1).float(), fs)
    frac = grid - pos
    env = _div(frac, 0.08).clamp(max=1.0) * torch.exp(-2.2 * frac)
    harmonics = torch.arange(1, 9, dtype=torch.float32, device=dev)
    amp_h = 1.0 / harmonics**1.5
    voice1 = torch.sum(amp_h[:, None] * torch.sin(harmonics[:, None] * phase[None, :]), dim=0)
    det = 1.5 * (1.0 + 0.002 * (u_det - 0.5))
    voice2 = torch.sum(amp_h[:, None] * torch.sin(harmonics[:, None] * det * phase[None, :]), dim=0)
    bal = 0.4 + 0.3 * u_env
    return _peak_normalize(env * (voice1 + bal * voice2))


def music_like(generator: torch.Generator, n_samples: int, fs: int = 16_000,
               base_hz: float = 220.0, device=None) -> torch.Tensor:
    """Harmonic music texture: piecewise-stable pitch (notes, not glides), a
    richer unshaped harmonic stack and an envelope on the note grid."""
    dev = resolve_device(device)
    g = generator
    steps = torch.randint(0, 6, (_n_notes(n_samples, fs),), generator=g, device=g.device).to(dev)
    u_det, u_env, u_vib = (_uniform(g, (), dev) for _ in range(3))
    return _music_render(steps, u_det, u_env, u_vib, n_samples, fs, base_hz)


def _babble_render(f0s, walk, u1, u2, noise, n_samples: int, fs: int) -> torch.Tensor:
    """The sum of len(f0s) utterances (draws with a leading talker dim)."""
    return _peak_normalize(_speech_render(walk, u1, u2, noise, n_samples, fs, f0s).sum(dim=-2))


def babble_like(generator: torch.Generator, n_samples: int, fs: int = 16_000,
                n_talkers: int = 6, device=None) -> torch.Tensor:
    """Multi-talker babble: ``n_talkers`` independent utterances at pitches
    uniform in [95, 300] Hz, summed: speech's spectrum with its TF gaps
    filled, the hard class for mask estimation."""
    dev = resolve_device(device)
    f0s = 95.0 + 205.0 * _uniform(generator, (n_talkers,), dev)
    return _babble_render(f0s, *_speech_draws(generator, n_samples, (n_talkers,), dev),
                          n_samples, fs)


INTERFERER_KINDS = ("speech", "babble", "music", "noise")


def interferer_signal(generator: torch.Generator, n_samples: int, fs: int = 16_000,
                      kind: str = "speech", f0: float = 160.0, device=None) -> torch.Tensor:
    """One interferer of class ``kind`` (one of INTERFERER_KINDS, or
    ``"mixed"``: a class drawn uniformly from the generator per call; the
    draw is read on the host, where the reference switches on device)."""
    if kind == "mixed":
        idx = int(torch.randint(0, len(INTERFERER_KINDS), (), generator=generator,
                                device=generator.device))
        kind = INTERFERER_KINDS[idx]
    if kind == "speech":
        return speech_like(generator, n_samples, fs, f0, device=device)
    if kind == "babble":
        return babble_like(generator, n_samples, fs, device=device)
    if kind == "music":
        return music_like(generator, n_samples, fs, device=device)
    if kind == "noise":
        return colored_noise(generator, n_samples, fs, device=device)
    raise ValueError(
        f"unknown interferer kind {kind!r}; have {INTERFERER_KINDS + ('mixed',)}")
