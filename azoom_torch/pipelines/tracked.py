"""Heuristic enhancement steered at a given bearing (counterpart of
``steered_heuristic_enhance`` in azoom.pipelines.tracked; the whole-clip
Viterbi tracker ``tracked_autosteer_enhance`` is queued, ROADMAP.md Queue A
item 9.5).

The IPD-deviation noise mask around the bearing, then the masked MVDR with
the mask's complement as post-filter: the autosteer pipeline's body with the
bearing supplied from outside (a tracker or a camera). On CUDA the MVDR is
one launch of the fused MVDR kernel.
"""

from __future__ import annotations

import math

import torch

from azoom_torch.config import PipelineConfig
from azoom_torch.dsp.delays import _delays64, steering_vector
from azoom_torch.dsp.stft import istft, rfft_freqs, stft
from azoom_torch.kernels.mvdr_kernel import masked_mvdr_fused
from azoom_torch.masks.geometric import ipd_deviation_noise_mask

__all__ = ["steered_heuristic_enhance", "steered_heuristic_spectrum"]


def steered_heuristic_spectrum(Y: torch.Tensor, cfg: PipelineConfig, theta_deg,
                               mask_width: float = 0.5) -> torch.Tensor:
    """STFT (M, F, T) -> beamformed STFT (F, T) toward ``theta_deg`` (a
    float or a 0-d tensor, which stays on the device)."""
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
    return masked_mvdr_fused(Y, noise_mask, d, freqs, target_mask=1.0 - noise_mask,
                             mask_floor=0.05, sigma=cfg.sigma, hp_cutoff_hz=cfg.hp_cutoff_hz)


def steered_heuristic_enhance(chunk: torch.Tensor, cfg: PipelineConfig, theta_deg,
                              mask_width: float = 0.5) -> torch.Tensor:
    """One chunk (M, n) -> (n,), heuristically masked and steered at
    ``theta_deg``."""
    cfg = cfg.for_input(chunk)
    with torch.inference_mode():
        Y = stft(chunk, cfg.n_fft, cfg.hop)
        S = steered_heuristic_spectrum(Y, cfg, theta_deg, mask_width)
        return istft(S, cfg.n_fft, cfg.hop, length=chunk.shape[-1])
