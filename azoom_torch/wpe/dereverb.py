"""WPE (Weighted Prediction Error) dereverberation (counterpart of
azoom.wpe.dereverb; the reference's nara_wpe settings taps=10, delay=3,
iterations=3):

  per frequency bin f and iteration i:
    lambda(t)   = mean_c |X_c(f, t)|^2 + eps   (power of the current estimate)
    Ytil(t)     = [y(t-delay); ...; y(t-delay-taps+1)]  over the channels
    R           = sum_t Ytil Ytil^H / lambda(t)   ((C K) x (C K))
    P           = sum_t Ytil y(t)^H / lambda(t)   ((C K) x C)
    G           = (R + eps tr(R) I)^-1 P
    X(t)        = y(t) - G^H Ytil(t)             (late reverberation removed)

All bins run as one batch: R and P are batched products over F with T
contracted, the (C K)^2 systems (20 x 20 at C = 2, taps = 10) one batched
LU solve that never raises and never waits for the host. A silent bin
(R = 0, so no loading) gives non-finite values there, as the reference's
``jnp.linalg.solve`` does. complex64, as the reference.
"""

from __future__ import annotations

import torch

from azoom_torch.beam.wpd import batched_solve, stack_delayed_frames, weighted_outer
from azoom_torch.config import PipelineConfig, as_input
from azoom_torch.dsp.stft import istft, stft

__all__ = ["wpe", "wpe_dereverb"]


def wpe(
    Y: torch.Tensor,
    taps: int = 10,
    delay: int = 3,
    iterations: int = 3,
    eps: float = 1e-6,
) -> torch.Tensor:
    """Dereverberate a complex STFT block Y (F, C, T) -> (F, C, T), the
    nara_wpe axis convention."""
    y = Y.movedim(-2, -3)  # (C, F, T)
    Ytil_c = stack_delayed_frames(y, taps, delay)[Y.shape[-2]:]  # (CK, F, T): the taps only
    Ytil = Ytil_c.movedim(-3, -2)  # (F, CK, T)
    eye = torch.eye(Ytil.shape[-2], dtype=Y.dtype, device=Y.device)
    X = Y
    for _ in range(iterations):
        w = 1.0 / (torch.mean(torch.abs(X) ** 2, dim=-2) + eps)  # (F, T)
        R = weighted_outer(Ytil_c, w, Ytil_c)  # (F, CK, CK)
        P = weighted_outer(Ytil_c, w, y)  # (F, CK, C)
        tr = torch.diagonal(R, dim1=-2, dim2=-1).sum(-1).real[..., None, None]
        G = batched_solve(R + eps * tr * eye, P)
        X = Y - torch.matmul(torch.conj(G).transpose(-1, -2), Ytil)
    return X


def wpe_dereverb(
    audio,
    cfg: PipelineConfig,
    taps: int = 10,
    delay: int = 3,
    iterations: int = 3,
    device=None,
) -> torch.Tensor:
    """Time domain in and out, the reference's apply_wpe surface: STFT, WPE,
    iSTFT, length-matched. ``audio`` (C, n) -> (C, n) float32. Input that is
    not a tensor goes to CUDA unless ``device`` says otherwise ("cpu": the
    CPU); ``device`` also moves a tensor."""
    audio = as_input(audio, device)
    n = audio.shape[-1]
    with torch.inference_mode():
        Y = stft(audio, cfg.n_fft, cfg.hop)  # (C, F, T)
        X = wpe(Y.movedim(0, 1), taps, delay, iterations)  # (F, C, T)
        return istft(X.movedim(1, 0), cfg.n_fft, cfg.hop, length=n)
