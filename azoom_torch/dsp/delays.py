"""Far-field array geometry: TDOA delays, steering vectors, fractional delay.

Geometry convention (as azoom.dsp.delays): mic m of a uniform linear array
sits at ``x_m = ((M-1)/2 - m) * d`` on the array axis; a far-field plane
wave from azimuth theta arrives at mic m with delay ``tau_m = p_m . u / c``,
``u = (cos theta, sin theta)``. theta = 90 deg is broadside. ``positions``
gives explicit per-mic coordinates, shape (M,), (M, 2) or (M, 3) (z is
ignored by azimuth-only steering).
"""

from __future__ import annotations

import math

import torch

from azoom_torch.config import as_input

__all__ = [
    "mic_positions", "positions_2d", "far_field_delays", "steering_vector", "steering_matrix",
    "steer_rotate", "fractional_delay",
]


def mic_positions(n_mics: int, mic_dist: float, device=None) -> torch.Tensor:
    """1-D mic coordinates (meters) along the array axis, array-centered."""
    m = torch.arange(n_mics, device=device, dtype=torch.float32)
    return ((n_mics - 1) / 2.0 - m) * mic_dist


def positions_2d(
    n_mics: int, mic_dist: float, positions: torch.Tensor | None = None,
    device=None,
) -> torch.Tensor:
    """(M, 2) planar mic coordinates: explicit ``positions`` or the
    canonical uniform-linear layout on the x axis."""
    if positions is None:
        x = mic_positions(n_mics, mic_dist, device)
        return torch.stack([x, torch.zeros_like(x)], dim=-1)
    p = torch.as_tensor(positions, dtype=torch.float32, device=device)
    if p.ndim == 1:
        p = torch.stack([p, torch.zeros_like(p)], dim=-1)
    return p[..., :2]


def far_field_delays(
    angle_deg,
    mic_dist: float,
    c: float = 343.0,
    n_mics: int = 2,
    positions: torch.Tensor | None = None,
    device=None,
) -> torch.Tensor:
    """Per-mic arrival delays (seconds), shape (..., n_mics) broadcasting
    over the angle input."""
    return _delays64(angle_deg, mic_dist, c, n_mics, positions, device).to(torch.float32)


def _delays64(angle_deg, mic_dist, c, n_mics, positions, device) -> torch.Tensor:
    """far_field_delays in float64: its cos/sin give the same bits on every
    device, which the float32 ones of CPU and CUDA do not."""
    theta = torch.deg2rad(torch.as_tensor(angle_deg, dtype=torch.float32, device=device))
    theta = theta.to(torch.float64)
    p = positions_2d(n_mics, mic_dist, positions, theta.device).to(torch.float64)
    u = torch.stack([torch.cos(theta), torch.sin(theta)], dim=-1)  # (..., 2)
    return torch.sum(u[..., None, :] * p, dim=-1) / c  # (..., M)


def steering_vector(
    freqs_hz: torch.Tensor,
    angle_deg,
    mic_dist: float,
    c: float = 343.0,
    n_mics: int = 2,
    normalize_phase: bool = False,
    positions: torch.Tensor | None = None,
) -> torch.Tensor:
    """Far-field steering vectors for all bins, complex64 (..., F, M):
    ``d[..., f, m] = exp(-1j * 2 pi f * tau_m(theta))``, on the device of
    ``freqs_hz``. ``normalize_phase`` makes the mic-0 entry real-positive."""
    tau = _delays64(angle_deg, mic_dist, c, n_mics, positions, freqs_hz.device)  # (..., M)
    # The phase and its cos/sin in float64, rounded once: the same bits on
    # every device (the float32 cos/sin of CPU and CUDA differ by ulps).
    phase = -2.0 * math.pi * freqs_hz.to(torch.float64)[:, None] * tau[..., None, :]
    d = torch.complex(torch.cos(phase), torch.sin(phase))
    if normalize_phase:
        ref = d[..., :, :1]
        d = d * torch.conj(ref) / (torch.abs(ref) + 1e-10)
    return d.to(torch.complex64)


def steering_matrix(
    freqs_hz: torch.Tensor,
    angles_deg,
    mic_dist: float,
    c: float = 343.0,
    n_mics: int = 2,
    positions: torch.Tensor | None = None,
) -> torch.Tensor:
    """Steering vectors for a grid of angles, complex64 (A, F, n_mics): the
    SRP angle scan and beam-pattern analysis."""
    angles = torch.as_tensor(angles_deg, dtype=torch.float32, device=freqs_hz.device)
    return steering_vector(freqs_hz, angles, mic_dist, c, n_mics, positions=positions)


def steer_rotate(Y: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """The STFT Y (..., M, F, T) rotated by conj(d) of steering vectors d
    ((F, M) or (..., F, M)), so the look direction appears broadside to a
    mask net: in complex128, rounded once to complex64, the same bits on
    every device."""
    rot = torch.conj(d).transpose(-1, -2)[..., None].to(torch.complex128)
    return (Y.to(torch.complex128) * rot).to(torch.complex64)


def fractional_delay(x, delay_sec, fs: float, device=None) -> torch.Tensor:
    """Delay a real signal (..., n) by a (possibly fractional-sample) time
    through an rFFT phase ramp, the anechoic mixing primitive; ``delay_sec``
    is a scalar or broadcasts against ``x``'s leading dims. float32 in the
    reference's order: the bin frequencies as float32 (``k / (n / fs)``), the
    phase ``-2 pi f tau``, its cos and sin, the product with the spectrum,
    the inverse FFT. NumPy input goes to CUDA unless ``device`` says
    otherwise; a tensor stays where it is."""
    x = as_input(x, device).to(torch.float32)
    n = x.shape[-1]
    X = torch.fft.rfft(x, dim=-1)
    # A device tensor as the divisor: CUDA turns division by a host scalar
    # into a product with its reciprocal, which rounds otherwise.
    span = torch.tensor(1.0 / fs * n, dtype=torch.float32, device=x.device)
    freqs = torch.arange(n // 2 + 1, dtype=torch.float32, device=x.device) / span
    delay = torch.as_tensor(delay_sec, dtype=torch.float32, device=x.device)[..., None]
    phase = -2.0 * math.pi * freqs * delay
    Y = X * torch.complex(torch.cos(phase), torch.sin(phase))
    if n % 2 == 0:
        # The ramp turns the Nyquist bin; a real signal's is real: pocketfft's
        # C2R drops its imaginary part, some cuFFT plans fold it in.
        Y[..., -1] = Y[..., -1].real
    return torch.fft.irfft(Y, n=n, dim=-1)
