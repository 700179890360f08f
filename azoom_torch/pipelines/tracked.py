"""Tracked zoom: follow a moving talker or a panning camera (counterpart of
azoom.pipelines.tracked).

``tracked_autosteer_enhance`` chunks the recording (the 2 s / 50 %
overlap-add runtime), measures each chunk's IPD angle histogram, turns the
noisy per-chunk spectra into a smooth bearing trajectory with a tracker
(localize.tracking), enhances every chunk steered at its own bearing and
overlap-adds. The reference vmaps the per-chunk enhancement; here all
chunks go through ONE batched call with a (C,) bearing: on CUDA one launch
of the MVDR or hard-null kernel for the whole clip (2-mic arrays), each
chunk reading its own steering vector through a batch stride. The bearings stay on the device
from the histograms to the beamformer.

``steered_heuristic_enhance``: the IPD-deviation noise mask around a given
bearing, then the masked MVDR with the mask's complement as post-filter (the
autosteer pipeline's body with the bearing supplied from outside).
"""

from __future__ import annotations

import math

import torch

from azoom_torch.config import PipelineConfig, as_input
from azoom_torch.dsp.delays import _delays64, steering_vector
from azoom_torch.dsp.stft import _check_precision, istft, rfft_freqs, stft
from azoom_torch.kernels.mvdr_kernel import masked_mvdr_any
from azoom_torch.localize import tracking
from azoom_torch.localize.srp import ipd_angle_histogram
from azoom_torch.masks.geometric import ipd_deviation_noise_mask
from azoom_torch.pipelines.learned import learned_enhance
from azoom_torch.stream.chunker import chunk_signal, overlap_add_chunks

__all__ = [
    "TRACKERS", "steered_heuristic_enhance", "steered_heuristic_spectrum", "track_bearings",
    "tracked_autosteer_enhance",
]

TRACKERS = ("viterbi", "causal", "momentum", "momentum_causal", "ema")


def steered_heuristic_spectrum(Y: torch.Tensor, cfg: PipelineConfig, theta_deg,
                               mask_width: float = 0.5) -> torch.Tensor:
    """STFT (..., M, F, T) -> beamformed STFT (..., F, T) toward
    ``theta_deg``: a float, a 0-d tensor, or one bearing per leading index
    (a (C,) tensor for C chunks). Tensors stay on the device."""
    dev = Y.device
    freqs = rfft_freqs(cfg.n_fft, cfg.fs, device=dev)
    geom = cfg.geometry()
    geom = None if geom is None else geom.to(dev)
    d = steering_vector(freqs, theta_deg, cfg.mic_dist, cfg.c, cfg.n_mics, positions=geom)
    # The first pair's expected IPD at the bearing; explicit non-uniform
    # geometries measure the same pair.
    tau = _delays64(theta_deg, cfg.mic_dist, cfg.c, cfg.n_mics, geom, dev)
    expected = -2.0 * math.pi * freqs.to(torch.float64) * (tau[..., 0:1] - tau[..., 1:2])
    pair = "first" if cfg.mic_positions is not None else "mean"
    noise_mask = ipd_deviation_noise_mask(Y, expected, width=mask_width, pair_mode=pair)
    return masked_mvdr_any(Y, noise_mask, d, freqs, target_mask=1.0 - noise_mask,
                           mask_floor=0.05, sigma=cfg.sigma, hp_cutoff_hz=cfg.hp_cutoff_hz)


def steered_heuristic_enhance(chunk: torch.Tensor, cfg: PipelineConfig, theta_deg,
                              mask_width: float = 0.5,
                              dsp_precision: str = "exact") -> torch.Tensor:
    """One chunk (M, n) -> (n,), heuristically masked and steered at
    ``theta_deg``. ``dsp_precision`` ('exact' or 'fast') is checked and
    selects nothing."""
    _check_precision(dsp_precision)
    cfg = cfg.for_input(chunk)
    with torch.inference_mode():
        Y = stft(chunk, cfg.n_fft, cfg.hop)
        S = steered_heuristic_spectrum(Y, cfg, theta_deg, mask_width)
        return istft(S, cfg.n_fft, cfg.hop, length=chunk.shape[-1])


def _fov_center(fov_center_deg, n_chunks: int, device) -> torch.Tensor:
    """The field of view's centre: a 0-d tensor, or (n_chunks,) for a
    panning camera."""
    center = torch.as_tensor(fov_center_deg, dtype=torch.float32, device=device)
    if center.ndim > 1 or (center.ndim == 1 and center.shape[0] != n_chunks):
        raise ValueError(
            f"fov_center_deg must be a scalar or one centre per chunk ({n_chunks},), got "
            f"shape {tuple(center.shape)}")
    return center


def track_bearings(tracker: str, angles: torch.Tensor, hists: torch.Tensor, fov_center,
                   fov_width_deg: float, trans_sigma_deg: float = 12.0, track_lag: int = 0,
                   init_prior_sigma_deg: float | None = None) -> torch.Tensor:
    """The (C,) bearing track of per-chunk histograms (C, A) under the
    reference pipeline's parameter maps: causal aiming prior fov / 5;
    momentum sigma max(0.4 s, 2), rate 0.7 s, switch 12, prior 8; ema rate
    2 s (s = ``trans_sigma_deg``, degrees per chunk hop)."""
    gate = dict(fov_center_deg=fov_center, fov_width_deg=fov_width_deg)
    if tracker == "viterbi":
        return tracking.viterbi_track(angles, hists, trans_sigma_deg=trans_sigma_deg, **gate)
    if tracker == "causal":
        prior = fov_width_deg / 5.0 if init_prior_sigma_deg is None else init_prior_sigma_deg
        return tracking.causal_track(angles, hists, trans_sigma_deg=trans_sigma_deg, lag=track_lag,
                                     init_prior_sigma_deg=prior, **gate)
    if tracker in ("momentum", "momentum_causal"):
        # The tuned regime of momentum_track: rate just under the admitted
        # walk per hop, sigma ~ rate / 2, sticky direction, and a tight
        # aiming prior (the camera is on the talker when the zoom starts).
        prior = 8.0 if init_prior_sigma_deg is None else init_prior_sigma_deg
        return tracking.momentum_track(
            angles, hists, trans_sigma_deg=max(0.4 * trans_sigma_deg, 2.0),
            rate_deg_per_chunk=0.7 * trans_sigma_deg, switch_penalty=12.0,
            causal=tracker == "momentum_causal", init_prior_sigma_deg=prior, **gate)
    if tracker == "ema":
        return tracking.ema_track(angles, hists, rate_deg_per_chunk=2.0 * trans_sigma_deg, **gate)
    raise ValueError(f"unknown tracker {tracker!r}; one of {TRACKERS}")


def tracked_autosteer_enhance(
    mixture,
    cfg: PipelineConfig,
    fov_center_deg=90.0,
    fov_width_deg: float = 60.0,
    tracker: str = "viterbi",
    trans_sigma_deg: float = 12.0,
    mask_width: float = 0.5,
    length: int | None = None,
    model=None,
    feature_kind: str = "logmag_ipd",
    beamformer: str = "mvdr",
    train_mic_dist: float | None = None,
    dsp_precision: str = "exact",
    track_lag: int = 0,
    init_prior_sigma_deg: float | None = None,
    device=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Blind enhancement of a moving target: track its bearing chunk by
    chunk and steer every chunk at its own estimate.

    ``mixture`` (M, n). ``fov_center_deg``: the camera's look direction, a
    scalar or an (n_chunks,) trajectory (n_chunks = ceil(max(n - win, 0) /
    hop) + 1, win = cfg.win_size, hop = win // 2); another length raises
    ValueError. ``tracker``: 'viterbi' (offline MAP path), 'causal'
    (forward filtering, with ``track_lag`` and ``init_prior_sigma_deg``,
    default fov_width_deg / 5), 'momentum' / 'momentum_causal' (direction
    state: keeps identity through a crossing talker) or 'ema'.
    ``trans_sigma_deg``: the motion-model scale, degrees per chunk hop.
    ``model``: a mask net on the mixture's device; every chunk then runs
    :func:`learned_enhance` (``beamformer``, ``feature_kind``,
    ``train_mic_dist``) at its bearing, all chunks in one batched call;
    without one, the IPD-deviation heuristic of ``mask_width``.
    ``dsp_precision`` is checked and selects nothing here. A mixture that
    is not a tensor goes to CUDA unless ``device`` says otherwise.

    Returns (enhanced (n,), bearing per chunk (n_chunks,) on the device).
    """
    _check_precision(dsp_precision)
    mixture = as_input(mixture, device)
    if mixture.ndim != 2:
        raise ValueError(f"tracked_autosteer_enhance takes one (M, n) mixture, got "
                         f"{tuple(mixture.shape)}")
    cfg = cfg.for_input(mixture)
    n = mixture.shape[-1]
    length = n if length is None else length
    win = cfg.win_size
    hop = win // 2
    with torch.inference_mode():
        chunks, _ = chunk_signal(mixture, win, hop)  # (C, M, win)
        center = _fov_center(fov_center_deg, chunks.shape[0], mixture.device)
        Yc = stft(chunks, cfg.n_fft, cfg.hop)
        angles, hists = ipd_angle_histogram(Yc, cfg.mic_dist, cfg.fs, c=cfg.c)
        theta = track_bearings(tracker, angles, hists, center, fov_width_deg, trans_sigma_deg,
                               track_lag, init_prior_sigma_deg)
        if model is not None:
            processed = learned_enhance(chunks, model, cfg, beamformer=beamformer,
                                        feature_kind=feature_kind, steer_deg=theta,
                                        train_mic_dist=train_mic_dist)
        else:
            S = steered_heuristic_spectrum(Yc, cfg, theta, mask_width)
            processed = istft(S, cfg.n_fft, cfg.hop, length=win)
        return overlap_add_chunks(processed, hop, n)[..., :length], theta
