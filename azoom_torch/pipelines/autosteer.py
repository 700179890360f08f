"""Blind auto-steered zoom: DOA inside the camera's field of view, then
steered enhancement (counterpart of azoom.pipelines.autosteer).

The strongest source inside the field of view (the "visual zoom region"),
weighted by a Gaussian aiming prior around the camera's center, gives the
bearing; the IPD angle histogram measures it on a linear array, SRP-PHAT
over the true positions on an explicit geometry. With a mask net the
bearing steers the learned pipeline (steer-aligned features, optionally
the FOV covariance gate); without one, the IPD-deviation heuristic mask
steers the masked MVDR. The bearing stays a tensor on the mixture's device
from the histogram to the beamformer: nothing waits for the host.
"""

from __future__ import annotations

import torch

from azoom_torch.config import PipelineConfig, as_input
from azoom_torch.dsp.stft import _check_precision, istft, rfft_freqs, stft
from azoom_torch.localize.srp import ipd_angle_histogram, srp_map
from azoom_torch.pipelines.learned import learned_enhance
from azoom_torch.pipelines.tracked import steered_heuristic_spectrum

__all__ = ["autosteer_enhance"]


def _fov_bearing(angles: torch.Tensor, score: torch.Tensor, fov_center_deg: float,
                 fov_width_deg: float, center_prior_deg: float | None = None) -> torch.Tensor:
    """The argmax of a DOA score (..., A) inside the field of view, weighted
    by a Gaussian aiming prior of ``center_prior_deg`` (default: a fifth of
    the field of view) around its center: a 0-d (or (...,)) tensor."""
    sigma_p = fov_width_deg / 5.0 if center_prior_deg is None else center_prior_deg
    prior = torch.exp(-0.5 * ((angles - fov_center_deg) / sigma_p) ** 2)
    in_fov = torch.abs(angles - fov_center_deg) <= fov_width_deg / 2.0
    return angles[torch.argmax(torch.where(in_fov, score * prior, -torch.inf), dim=-1)]


def autosteer_enhance(
    mixture,
    cfg: PipelineConfig,
    fov_center_deg: float = 90.0,
    fov_width_deg: float = 60.0,
    center_prior_deg: float | None = None,
    mask_width: float = 0.5,
    length: int | None = None,
    model=None,
    feature_kind: str = "logmag_ipd",
    beamformer: str = "mvdr",
    fov_gate: bool = False,
    train_mic_dist: float | None = None,
    dsp_precision: str = "exact",
    harmonic_regen: bool = False,
    device=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Enhance a (M, n) mixture toward the dominant source inside the field
    of view. Returns (enhanced (n,), bearing in degrees, a 0-d tensor on the
    mixture's device).

    ``center_prior_deg``: the aiming prior's width (``inf``: the loudest
    source in the field of view). ``model``: a mask net on the mixture's
    device; the bearing then steers :func:`learned_enhance` (with
    ``beamformer``, ``feature_kind``, ``train_mic_dist``, and with the FOV
    covariance gate when ``fov_gate``); otherwise the IPD-deviation
    heuristic of ``mask_width``. ``dsp_precision`` is checked and selects
    nothing here (in the reference it picks the TPU's DFT precision).
    A mixture that is not a tensor goes to CUDA unless ``device`` says
    otherwise ("cpu": the plain path); ``device`` also moves a tensor.
    """
    _check_precision(dsp_precision)
    mixture = as_input(mixture, device)
    if mixture.ndim != 2:
        raise ValueError(f"autosteer_enhance takes one (M, n) mixture, got {tuple(mixture.shape)}")
    cfg = cfg.for_input(mixture)
    n = mixture.shape[-1]
    length = n if length is None else length
    dev = mixture.device
    with torch.inference_mode():
        Y = stft(mixture, cfg.n_fft, cfg.hop)
        if cfg.mic_positions is not None:
            angles, score = srp_map(Y, rfft_freqs(cfg.n_fft, cfg.fs, device=dev), cfg.mic_dist,
                                    c=cfg.c, phat=True, positions=cfg.geometry())
        else:
            angles, score = ipd_angle_histogram(Y, cfg.mic_dist, cfg.fs, c=cfg.c)
        theta = _fov_bearing(angles, score, fov_center_deg, fov_width_deg, center_prior_deg)
        if model is not None:
            out = learned_enhance(
                mixture, model, cfg, beamformer=beamformer, feature_kind=feature_kind,
                length=length, steer_deg=theta, fov_deg=fov_width_deg if fov_gate else None,
                train_mic_dist=train_mic_dist, harmonic_regen=harmonic_regen,
            )
            return out, theta
        S = steered_heuristic_spectrum(Y, cfg, theta, mask_width)
        return istft(S, cfg.n_fft, cfg.hop, length=length), theta
