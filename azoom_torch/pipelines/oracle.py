"""Oracle-mask and heuristic-mask MVDR pipelines, the end-to-end
correctness harness (counterpart of azoom.pipelines.oracle):

    STFT of the mixture and the stems -> ideal binary noise mask -> masked
    MVDR (+ post-filter, high-pass) -> iSTFT

With an oracle mask a correct engine reaches a very high SIR (the
reference reports 36.24 dB). Runs on the device of the mixture: on CUDA the
MVDR stage of a 2-mic array is one launch of the fused MVDR kernel for the
whole batch; M > 2 mics take the M-mic MVDR of beam.mvdr in torch.
Arrays that are not tensors go to CUDA unless ``device`` says otherwise.
"""

from __future__ import annotations

import torch

from azoom_torch.config import PipelineConfig, as_input
from azoom_torch.dsp.delays import steering_vector
from azoom_torch.dsp.stft import istft, rfft_freqs, stft
from azoom_torch.kernels.mvdr_kernel import masked_mvdr_any
from azoom_torch.masks.geometric import hard_geometric_noise_mask
from azoom_torch.masks.oracle import ibm_noise_mask, irm_target_mask

__all__ = ["oracle_enhance", "heuristic_enhance"]


def _steering(cfg: PipelineConfig, freqs: torch.Tensor) -> torch.Tensor:
    geom = cfg.geometry()
    return steering_vector(freqs, cfg.angle_target_deg, cfg.mic_dist, cfg.c, cfg.n_mics,
                           positions=None if geom is None else geom.to(freqs.device))


def oracle_enhance(
    mixture,
    target_ref,
    interference_ref,
    cfg: PipelineConfig,
    post_filter: str = "binary",
    length: int | None = None,
    device=None,
) -> torch.Tensor:
    """Enhance (..., M, n) with the oracle mask of the stems (..., n) as
    heard at mic 0 -> float32 (..., length). ``post_filter``: 'binary'
    (1 - the IBM noise mask), 'irm' (the ideal ratio mask) or 'none'."""
    if post_filter not in ("binary", "irm", "none"):
        raise ValueError(f"unknown post_filter {post_filter!r}")
    mixture = as_input(mixture, device)
    target_ref = as_input(target_ref, mixture.device)
    interference_ref = as_input(interference_ref, mixture.device)
    cfg = cfg.for_input(mixture)
    length = mixture.shape[-1] if length is None else length
    with torch.inference_mode():
        Y = stft(mixture, cfg.n_fft, cfg.hop)
        S_tgt = stft(target_ref, cfg.n_fft, cfg.hop)
        S_int = stft(interference_ref, cfg.n_fft, cfg.hop)
        noise_mask = ibm_noise_mask(S_tgt, S_int)
        tgt_mask = None
        if post_filter == "binary":
            tgt_mask = 1.0 - noise_mask
        elif post_filter == "irm":
            tgt_mask = irm_target_mask(S_tgt, S_int)
        freqs = rfft_freqs(cfg.n_fft, cfg.fs, device=Y.device)
        S = masked_mvdr_any(Y, noise_mask, _steering(cfg, freqs), freqs,
                            target_mask=tgt_mask, sigma=cfg.sigma,
                            hp_cutoff_hz=cfg.hp_cutoff_hz)
        return istft(S, cfg.n_fft, cfg.hop, length=length)


def heuristic_enhance(mixture, cfg: PipelineConfig, length: int | None = None,
                      device=None) -> torch.Tensor:
    """Blind enhancement with the hard geometric IPD mask (no ground truth),
    post-filtered by 1 - that mask floored at 0.05."""
    mixture = as_input(mixture, device)
    cfg = cfg.for_input(mixture)
    length = mixture.shape[-1] if length is None else length
    with torch.inference_mode():
        Y = stft(mixture, cfg.n_fft, cfg.hop)
        noise_mask = hard_geometric_noise_mask(Y)
        freqs = rfft_freqs(cfg.n_fft, cfg.fs, device=Y.device)
        S = masked_mvdr_any(Y, noise_mask, _steering(cfg, freqs), freqs,
                            target_mask=1.0 - noise_mask, mask_floor=0.05,
                            sigma=cfg.sigma, hp_cutoff_hz=cfg.hp_cutoff_hz)
        return istft(S, cfg.n_fft, cfg.hop, length=length)
