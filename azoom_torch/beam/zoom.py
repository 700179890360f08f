"""The audio-zoom control surface: beam patterns and sigma <-> beamwidth
(counterpart of azoom.beam.zoom).

The MVDR diagonal loading sigma is the zoom: a small sigma lets the
beamformer place aggressive nulls (a narrow acceptance beam, "zoom in"), a
large one regularises it toward delay-and-sum (a wide beam, "zoom out").
"""

from __future__ import annotations

import torch

from azoom_torch.beam.mvdr import mvdr_weights
from azoom_torch.dsp.delays import steering_matrix

__all__ = ["beam_pattern", "beamwidth_3db", "sigma_vs_beamwidth", "zoom_to_sigma"]


def beam_pattern(
    w: torch.Tensor, freqs_hz: torch.Tensor, angles_deg, mic_dist: float, c: float = 343.0
) -> torch.Tensor:
    """Spatial response power |w(f)^H d(f, theta)|^2 of weights w (..., F, M)
    at scan azimuths (A,): float32 (..., A, F)."""
    D = steering_matrix(freqs_hz, angles_deg, mic_dist, c, w.shape[-1])  # (A, F, M)
    resp = torch.einsum("...fm,afm->...af", torch.conj(w), D)
    return torch.abs(resp) ** 2


def beamwidth_3db(pattern: torch.Tensor, angles_deg, target_deg: float) -> torch.Tensor:
    """-3 dB main-lobe width (degrees) of an (..., A) broadband pattern: the
    angular measure of the contiguous region around the target where the
    response stays within 3 dB of the target's."""
    a = torch.as_tensor(angles_deg, dtype=torch.float32, device=pattern.device)
    i_tgt = int(torch.argmin(torch.abs(a - target_deg)))
    ref = pattern[..., i_tgt][..., None]
    above = pattern >= ref * (10.0 ** (-3.0 / 10.0))
    idx = torch.arange(a.shape[0], device=pattern.device)
    right, left = idx >= i_tgt, idx <= i_tgt
    # The first bin below -3 dB on either side of the target bounds the lobe.
    blocked_r = torch.cumsum((right & ~above).int(), dim=-1) > 0
    blocked_l = torch.flip(torch.cumsum(torch.flip((left & ~above).int(), [-1]), dim=-1) > 0, [-1])
    in_lobe = above & ~blocked_r & ~blocked_l
    return torch.sum(in_lobe, dim=-1) * torch.mean(torch.diff(a))


def sigma_vs_beamwidth(
    R_noise: torch.Tensor,
    d: torch.Tensor,
    freqs_hz: torch.Tensor,
    sigmas,
    mic_dist: float,
    target_deg: float = 90.0,
    c: float = 343.0,
    angles_deg=None,
    band_hz: tuple[float, float] = (500.0, 3500.0),
) -> tuple[torch.Tensor, torch.Tensor]:
    """The sigma -> beamwidth zoom curve: for each sigma, MVDR weights on the
    noise field R_noise (F, M, M), the band-averaged beam pattern and its
    -3 dB width. Returns (sigmas, widths_deg)."""
    if angles_deg is None:
        angles_deg = torch.arange(0.0, 180.5, 1.0)
    sigmas = torch.as_tensor(sigmas, dtype=torch.float32)
    band = ((freqs_hz >= band_hz[0]) & (freqs_hz <= band_hz[1])).to(torch.float32)
    widths = []
    for sigma in sigmas:
        w = mvdr_weights(R_noise, d, sigma=sigma)
        pat = beam_pattern(w, freqs_hz, angles_deg, mic_dist, c)  # (A, F)
        broadband = torch.sum(pat * band, dim=-1) / torch.sum(band)
        widths.append(beamwidth_3db(broadband, angles_deg, target_deg))
    return sigmas, torch.stack(widths)


def zoom_to_sigma(zoom, sigma_narrow: float = 1e-9, sigma_wide: float = 1e-2) -> torch.Tensor:
    """Map a UI zoom level in [0, 1] (0 = wide, 1 = narrow) to a diagonal
    loading, log-interpolated; float32, as the reference computes it."""
    z = torch.clamp(torch.as_tensor(zoom, dtype=torch.float32), 0.0, 1.0)
    lo = torch.log10(torch.tensor(sigma_wide, dtype=torch.float32))
    hi = torch.log10(torch.tensor(sigma_narrow, dtype=torch.float32))
    return 10.0 ** (lo + z * (hi - lo))
