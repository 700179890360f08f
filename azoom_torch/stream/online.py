"""Frame-by-frame causal MVDR, the low-latency beamformer (counterpart of
azoom.stream.online).

Each STFT frame updates an exponentially forgotten, mask-weighted noise
covariance and applies the MVDR weights of the statistics so far to that
frame: frame t uses frames <= t only, so the beamformer adds no latency
beyond the STFT's hop. The recursion runs in the ``online_mvdr`` kernel
(kernels.online_mvdr_kernel), one launch for all frames of a block; on the
CPU it runs the kernel's plain version, the reference's scan as a Python
loop over frames. The state is a (F, 2, 2) covariance sum and an (F,)
weight sum per stream; :func:`online_masked_mvdr_state` takes it in and
gives it back, so a stream carries it from one hop to the next
(stream.lowlat). M = 2 only: M > 2 needs azoom/beam/linalgmm.py.
"""

from __future__ import annotations

import torch

from azoom_torch.config import PipelineConfig, as_input
from azoom_torch.dsp.delays import steering_vector
from azoom_torch.dsp.stft import istft, rfft_freqs, stft
from azoom_torch.kernels.online_mvdr_kernel import initial_state, online_mvdr

__all__ = ["online_masked_mvdr", "online_masked_mvdr_state", "online_enhance", "initial_state"]


def online_masked_mvdr_state(
    Y: torch.Tensor,
    noise_mask: torch.Tensor,
    d: torch.Tensor,
    freqs_hz: torch.Tensor,
    state=None,
    target_mask: torch.Tensor | None = None,
    sigma: float = 1e-7,
    hp_cutoff_hz: float = 100.0,
    forget: float = 0.98,
    mask_floor: float = 0.0,
    eps: float = 1e-6,
):
    """:func:`online_masked_mvdr` with its state: ``state`` is (R_sum,
    w_sum) from :func:`initial_state` or an earlier call (None: a fresh
    stream), updated in place and returned. ``target_mask`` and
    ``mask_floor`` fuse the floored post-filter gain into the same launch.
    Returns (S (..., F, T), state)."""
    if state is None:
        state = initial_state(Y.shape[:-3], Y.shape[-2], Y.shape[-3], Y.device, eps)
    S = online_mvdr(Y, noise_mask, d, freqs_hz, *state, target_mask=target_mask, sigma=sigma,
                    hp_cutoff_hz=hp_cutoff_hz, forget=forget, mask_floor=mask_floor, eps=eps)
    return S, state


def online_masked_mvdr(
    Y: torch.Tensor,
    noise_mask: torch.Tensor,
    d: torch.Tensor,
    freqs_hz: torch.Tensor,
    sigma: float = 1e-7,
    hp_cutoff_hz: float = 100.0,
    forget: float = 0.98,
    eps: float = 1e-6,
) -> torch.Tensor:
    """Causal MVDR over an STFT block: frame t uses only frames <= t.

    Y complex64 (M, F, T) (or (..., M, F, T)); noise_mask (F, T) noise
    weights; d (F, M) steering vectors; ``forget`` the exponential
    forgetting factor of the running covariance (1.0: a growing window,
    the batch estimate as T grows). Returns the (F, T) beamformed STFT,
    zero below ``hp_cutoff_hz``."""
    return online_masked_mvdr_state(Y, noise_mask, d, freqs_hz, sigma=sigma,
                                    hp_cutoff_hz=hp_cutoff_hz, forget=forget, eps=eps)[0]


def online_enhance(
    mixture,
    noise_mask_fn_output,
    cfg: PipelineConfig,
    forget: float = 0.98,
    length: int | None = None,
    device=None,
) -> torch.Tensor:
    """Causal streaming enhancement of a whole recording, (M, n) -> (n,):
    the online MVDR steered at ``cfg.angle_target_deg`` under a precomputed
    (F, T) noise mask, then the gain max(1 - noise_mask, 0.05) (fused into
    the same launch) and the iSTFT. Causality of the mask is the caller's
    concern. Tensors stay on their device; other inputs go to CUDA unless
    ``device`` says otherwise."""
    mixture = as_input(mixture, device)
    noise = as_input(noise_mask_fn_output, mixture.device).to(torch.float32).contiguous()
    length = mixture.shape[-1] if length is None else length
    geom = cfg.geometry()
    with torch.inference_mode():
        Y = stft(mixture, cfg.n_fft, cfg.hop)
        freqs = rfft_freqs(cfg.n_fft, cfg.fs, device=Y.device)
        d = steering_vector(freqs, cfg.angle_target_deg, cfg.mic_dist, cfg.c, cfg.n_mics,
                            positions=None if geom is None else geom.to(Y.device))
        S, _ = online_masked_mvdr_state(Y, noise, d, freqs, target_mask=1.0 - noise,
                                        sigma=cfg.sigma, hp_cutoff_hz=cfg.hp_cutoff_hz,
                                        forget=forget, mask_floor=0.05)
        return istft(S, cfg.n_fft, cfg.hop, length=length)
