"""Anechoic far-field scene synthesis (counterpart of azoom.sim.farfield).

Each source at azimuth theta is delayed to each mic by its far-field TDOA
through an rFFT phase ramp and summed: one batched ``fractional_delay`` over
(..., source, mic), so a batch of mixtures is one pass on the device.

NumPy input goes to CUDA unless ``device`` names another device; a tensor
stays where it is.
"""

from __future__ import annotations

import torch

from azoom_torch.config import as_input
from azoom_torch.dsp.delays import far_field_delays, fractional_delay

__all__ = ["mix_far_field", "make_scene"]


def mix_far_field(sources, angles_deg, mic_dist: float, fs: float, c: float = 343.0,
                  n_mics: int = 2, positions=None, device=None) -> torch.Tensor:
    """Mix S far-field sources (..., S, n) from azimuths ``angles_deg`` ((S,)
    or (..., S)) into an M-mic observation (..., M, n): a linear array of
    ``n_mics`` at ``mic_dist``, or the explicit ``positions`` ((M,), (M, 2)
    or (M, 3) meters)."""
    sources = as_input(sources, device)
    return _delayed_images(sources, angles_deg, mic_dist, c, n_mics, fs, positions).sum(dim=-3)


def _delayed_images(sources: torch.Tensor, angles_deg, mic_dist, c, n_mics, fs,
                    positions=None) -> torch.Tensor:
    """Per-source per-mic delayed copies (..., S, M, n)."""
    tau = far_field_delays(angles_deg, mic_dist, c, n_mics, positions,
                           device=sources.device)  # (..., S, M)
    return fractional_delay(sources[..., None, :], tau, fs)


def make_scene(target, interferers, target_angle_deg: float, interferer_angles_deg,
               mic_dist: float, fs: float, c: float = 343.0, n_mics: int = 2,
               normalize: bool = True, positions=None, device=None) -> dict:
    """A far-field scene with its answer key: ``target`` (..., n) and
    ``interferers`` (..., K, n) (K may be 0) at their azimuths
    (``interferer_angles_deg`` (K,), or (..., K): one set per scene). Returns
    ``mixture`` (..., M, n), ``target_ref`` (..., n) (the target as heard at
    mic 0) and ``interference_ref`` (..., n) (the interferers at mic 0), all
    three sharing the mixture's peak normalisation."""
    target = as_input(target, device).to(torch.float32)
    interferers = torch.as_tensor(interferers, dtype=torch.float32, device=target.device)
    sources = torch.cat([target[..., None, :], interferers], dim=-2)
    itf = torch.as_tensor(interferer_angles_deg, dtype=torch.float32, device=target.device)
    if itf.ndim < 2:
        itf = itf.reshape(-1)
    tgt = torch.full(itf.shape[:-1] + (1,), float(target_angle_deg), dtype=torch.float32,
                     device=target.device)
    angles = torch.cat([tgt, itf], dim=-1)
    imgs = _delayed_images(sources, angles, mic_dist, c, n_mics, fs, positions)  # (..., S, M, n)
    mixture = imgs.sum(dim=-3)
    target_ref = imgs[..., 0, 0, :]
    interference_ref = imgs[..., 1:, 0, :].sum(dim=-2)
    if normalize:
        peak = mixture.abs().amax(dim=(-2, -1), keepdim=True) + 1e-9
        mixture = mixture / peak
        target_ref = target_ref / peak[..., 0, :]
        interference_ref = interference_ref / peak[..., 0, :]
    return {"mixture": mixture, "target_ref": target_ref, "interference_ref": interference_ref}
