"""Frame-latency learned enhancement: the causal CRN mask net and the online
MVDR (counterpart of azoom.pipelines.online_learned).

    STFT -> steer-align -> logmag_ipd features -> CRN (causal) -> online
         MVDR with the floored target-mask gain and the high-pass -> iSTFT

The CRN is causal along time and the MVDR's covariance recursion uses frames
<= t only, so frame t's output depends on the input up to frame t: the
algorithmic latency lies between one STFT hop and one window (32-64 ms at
1024 / 512 at 16 kHz). Offline, one call runs the net over all frames and
the recursion in ONE ``online_mvdr`` launch; stream.lowlat runs the same
step one hop at a time with the same result. No geometry adaptation, as in
the reference.
"""

from __future__ import annotations

import torch

from azoom_torch.config import PipelineConfig
from azoom_torch.dsp.delays import steer_rotate, steering_vector
from azoom_torch.dsp.stft import istft, rfft_freqs, stft
from azoom_torch.masks.features import logmag_ipd_features
from azoom_torch.stream.online import online_masked_mvdr_state

__all__ = ["online_learned_enhance"]


def online_learned_enhance(
    mixture: torch.Tensor,
    model,
    cfg: PipelineConfig,
    forget: float = 0.98,
    mask_floor: float = 0.05,
    length: int | None = None,
    steer_deg=None,
    steer_align: bool = True,
) -> torch.Tensor:
    """Causally enhance (M, n) (or (..., M, n)) -> (n,) (or (..., n)) with a
    causal mask net (CRNMaskNet, unidirectional), on the device of the
    mixture, which must be the net's. ``steer_deg`` overrides
    ``cfg.angle_target_deg``; ``steer_align`` rotates the STFT by conj(d)
    before the features, so the look direction appears broadside to the net
    (the bundled causal net was trained at 90 deg)."""
    mixture = torch.as_tensor(mixture)
    net_dev = model.w_in.device
    if mixture.device != net_dev:
        raise ValueError(f"mixture is on {mixture.device} but the model is on {net_dev}")
    cfg = cfg.for_input(mixture)
    n = mixture.shape[-1]
    length = n if length is None else length
    steer = cfg.angle_target_deg if steer_deg is None else steer_deg
    geom = cfg.geometry()
    with torch.inference_mode():
        Y = stft(mixture, cfg.n_fft, cfg.hop)  # (..., M, F, T)
        freqs = rfft_freqs(cfg.n_fft, cfg.fs, device=Y.device)
        d = steering_vector(freqs, steer, cfg.mic_dist, cfg.c, cfg.n_mics,
                            positions=None if geom is None else geom.to(Y.device))
        feats = logmag_ipd_features(steer_rotate(Y, d) if steer_align else Y)
        lead = feats.shape[:-3]
        tgt = model(feats.reshape((-1,) + tuple(feats.shape[-3:])))
        tgt = tgt.reshape(lead + tuple(tgt.shape[-2:])).contiguous()
        S, _ = online_masked_mvdr_state(Y, 1.0 - tgt, d, freqs, target_mask=tgt,
                                        sigma=cfg.sigma, hp_cutoff_hz=cfg.hp_cutoff_hz,
                                        forget=forget, mask_floor=mask_floor)
        return istft(S, cfg.n_fft, cfg.hop, length=length)
