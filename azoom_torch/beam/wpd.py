"""WPD convolutional beamformer: joint dereverberation and beamforming
(counterpart of azoom.beam.wpd; Nakatani & Kinoshita, IEEE SPL 2019).

One convolutional filter over the current frame and ``taps`` delayed
frames cancels late reverberation (the WPE part) and steers and nulls (the
MVDR part), minimising the output power weighted by the inverse target PSD
under a distortionless constraint on the current frame:

    ybar(t,f) = [y(t); y(t-delay); ...; y(t-delay-taps+1)]  in C^{M(taps+1)}
    Rbar(f)   = sum_t ybar ybar^H / lambda(t,f)
    bbar      = [d(f); 0; ...; 0]
    wbar(f)   = Rbar^{-1} bbar / (bbar^H Rbar^{-1} bbar)
    x(t,f)    = wbar^H ybar(t,f)

lambda is the target PSD, blind from the mask-weighted mixture power
(optionally re-estimated from the output, ``iterations``), and the
covariance weight is gated by the noise mask.

Rbar is one batched matrix product over (..., F) with T contracted, never a
(..., N, N, F, T) intermediate; the (N, N) solves (18 x 18 at M = 2,
taps = 8) are one batched LU solve over every bin that never raises and
never waits for the host (``torch.linalg.solve_ex`` without its error
check): a singular system gives non-finite values, as the reference's
``jnp.linalg.solve`` does. complex64, as the reference.
"""

from __future__ import annotations

import torch

__all__ = ["stack_delayed_frames", "weighted_outer", "batched_solve", "wpd_weights",
           "wpd_beamform", "masked_wpd"]


def stack_delayed_frames(Y: torch.Tensor, taps: int, delay: int) -> torch.Tensor:
    """The convolutional observation vector of a complex STFT Y (..., M, F, T):
    (..., M (taps + 1), F, T), rows 0..M-1 the current frame, then ``taps``
    blocks of Y delayed by delay, delay + 1, ... frames (zeros in front)."""
    T = Y.shape[-1]
    blocks = [Y]
    for k in range(taps):
        blocks.append(torch.nn.functional.pad(Y, (delay + k, 0))[..., :T])
    return torch.cat(blocks, dim=-3)


def weighted_outer(A: torch.Tensor, w: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """sum_t A[..., i, f, t] w[..., f, t] conj(B[..., j, f, t]) as (..., F, I, J):
    one batched product over (..., F) with T contracted."""
    Aw = (A * w[..., None, :, :].to(A.dtype)).movedim(-3, -2)  # (..., F, I, T)
    return torch.matmul(Aw, torch.conj(B).movedim(-3, -1))  # (..., F, T, J) -> (..., F, I, J)


def batched_solve(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """A^-1 B for square A (..., N, N) by LU with partial pivoting, batched;
    never raises and never synchronises with the host (a singular A gives
    non-finite values)."""
    return torch.linalg.solve_ex(A, B, check_errors=False)[0]


def wpd_weights(
    Ybar: torch.Tensor,
    w_t: torch.Tensor,
    d: torch.Tensor,
    sigma: float = 1e-4,
    eps: float = 1e-10,
) -> torch.Tensor:
    """WPD weights (..., F, N) from the stacked observations Ybar (..., N, F, T)
    (N = M (taps + 1)), the per-(bin, frame) covariance weights w_t
    (..., F, T) and the current frame's steering d ((F, M) or (..., F, M)).
    The loading is ``sigma`` x trace / N + eps (trace-relative)."""
    N = Ybar.shape[-3]
    M = d.shape[-1]
    Rbar = weighted_outer(Ybar, w_t, Ybar) / Ybar.shape[-1]
    tr = torch.diagonal(Rbar, dim1=-2, dim2=-1).sum(-1).real[..., None, None]
    eye = torch.eye(N, dtype=Rbar.dtype, device=Rbar.device)
    Rbar = Rbar + (sigma * tr / N + eps) * eye
    bbar = torch.cat([d, torch.zeros(d.shape[:-1] + (N - M,), dtype=d.dtype, device=d.device)],
                     dim=-1)
    bbar = torch.broadcast_to(bbar, Rbar.shape[:-1])
    R_inv_b = batched_solve(Rbar, bbar[..., None])[..., 0]
    denom = torch.sum(torch.conj(bbar) * R_inv_b, dim=-1, keepdim=True)
    return R_inv_b / (denom + eps)


def _apply(w: torch.Tensor, Ybar: torch.Tensor) -> torch.Tensor:
    """x[..., f, t] = w[..., f]^H Ybar[..., :, f, t]."""
    return torch.einsum("...fn,...nft->...ft", torch.conj(w), Ybar)


def wpd_beamform(
    Y: torch.Tensor,
    tgt_mask: torch.Tensor,
    d: torch.Tensor,
    freqs_hz: torch.Tensor,
    taps: int = 8,
    delay: int = 2,
    iterations: int = 1,
    sigma: float = 1e-4,
    hp_cutoff_hz: float = 100.0,
    floor_rel: float = 1e-2,
    mask_gate_floor: float = 0.05,
) -> torch.Tensor:
    """Joint dereverberation and beamforming of a complex STFT Y (..., M, F, T)
    -> (..., F, T), bins below ``hp_cutoff_hz`` zero.

    ``tgt_mask`` (..., F, T): 1 = target-dominated (it weights the PSD
    estimate; the opposite convention from the MVDR's noise mask). ``d``:
    (F, M) or (..., F, M). ``taps`` / ``delay``: the filter's geometry
    (taps = 0: a weighted MPDR). ``iterations``: lambda rounds (at least
    one; later rounds re-estimate lambda from |output|^2). ``floor_rel``:
    the per-bin lambda floor as a fraction of the bin's mean power.
    ``mask_gate_floor``: the least weight of a frame the mask calls pure
    target."""
    Ybar = stack_delayed_frames(Y, taps, delay)
    power = torch.mean(torch.abs(Y) ** 2, dim=-3)  # (..., F, T)
    floor = floor_rel * torch.mean(power, dim=-1, keepdim=True) + 1e-12
    lam = torch.maximum(tgt_mask * power, floor)
    gate = torch.clamp(1.0 - tgt_mask, min=mask_gate_floor)
    for i in range(max(1, iterations)):
        if i:  # re-estimate lambda from the previous round's output
            lam = torch.maximum(torch.abs(S) ** 2, floor)
        S = _apply(wpd_weights(Ybar, gate / lam, d, sigma=sigma), Ybar)
    keep = (freqs_hz >= hp_cutoff_hz)[:, None]
    return torch.where(keep, S, torch.zeros((), dtype=S.dtype, device=S.device))


def masked_wpd(
    Y: torch.Tensor,
    tgt_mask: torch.Tensor,
    d: torch.Tensor,
    freqs_hz: torch.Tensor,
    taps: int = 8,
    delay: int = 2,
    iterations: int = 1,
    sigma: float = 1e-4,
    hp_cutoff_hz: float = 100.0,
    mask_floor: float = 0.05,
) -> torch.Tensor:
    """:func:`wpd_beamform` and the floored spectral post-filter
    max(tgt_mask, mask_floor) (the raw mask when ``mask_floor`` is 0)."""
    S = wpd_beamform(Y, tgt_mask, d, freqs_hz, taps=taps, delay=delay, iterations=iterations,
                     sigma=sigma, hp_cutoff_hz=hp_cutoff_hz)
    gain = torch.clamp(tgt_mask, min=mask_floor) if mask_floor > 0 else tgt_mask
    return S * gain
