"""BSS-eval SDR / SIR / SAR with allowed distortion filters (counterpart of
azoom.eval.bss, mir_eval's ``bss_eval_sources`` for one estimate).

BSS-eval differs from plain projection by permitting a ``filter_len``-tap
distortion filter on each reference before projecting, so an estimate that
is a filtered or delayed copy of the target still scores a high SDR.

Math (Vincent et al. 2006): with references s_j and estimate e,
  s_target = P_{target taps}(e)     (projection onto L delayed copies of
                                     the target)
  P_all    = P_{all sources' taps}(e)
  e_interf = P_all - s_target
  e_artif  = e - P_all
  SDR = 10log10 |s_target|^2 / |e_interf + e_artif|^2
  SIR = 10log10 |s_target|^2 / |e_interf|^2
  SAR = 10log10 |s_target + e_interf|^2 / |e_artif|^2

The projections solve the Toeplitz-block Gram system G c = d built from FFT
cross-correlations, loaded by ``eps * trace / (S L)``: one (S L)^2 float32
solve (``torch.linalg.solve``), as the reference's. Delayed copies of
speech-like sources make G nearly singular, so the dB values carry float32
noise: SAR wherever the estimate lies in the sources' span (the projection
residual is then rounding), SDR and SIR at the level of the solve's
conditioning.
"""

from __future__ import annotations

import torch

from azoom_torch.config import as_input

__all__ = ["bss_eval_sources"]


def _correlations(sources: torch.Tensor, estimate: torch.Tensor, L: int):
    """G: (S, L, S, L) with G[j,l,k,m] = sum_t s_j(t-l) s_k(t-m), and
    d: (S, L) with d[j,l] = sum_t s_j(t-l) e(t), by FFT."""
    S, n = sources.shape
    nfft = 1 << (2 * n - 1).bit_length()
    SF = torch.fft.rfft(sources, n=nfft, dim=-1)  # (S, F)
    EF = torch.fft.rfft(estimate, n=nfft)
    # r_jk(tau) = sum_t s_j(t) s_k(t + tau); G[j,l,k,m] = r_jk(l - m).
    cross = torch.fft.irfft(SF.conj()[:, None] * SF[None, :], n=nfft)  # (S, S, nfft)
    ar = torch.arange(L, device=sources.device)
    lags = (ar[:, None] - ar[None, :]) % nfft  # (L, L)
    G = cross[:, :, lags].permute(0, 2, 1, 3)  # (S, L, S, L)
    de = torch.fft.irfft(SF.conj() * EF[None, :], n=nfft)  # (S, nfft)
    return G, de[:, :L]  # d[j, l] = sum_t s_j(t) e(t + l)


def _project(sources: torch.Tensor, estimate: torch.Tensor, L: int, eps: float):
    """Least-squares projection of the estimate onto the span of L delayed
    copies of each source; the projected signal, same length."""
    S, n = sources.shape
    G, d = _correlations(sources, estimate, L)
    G2 = G.reshape(S * L, S * L)
    G2 = G2 + eps * torch.trace(G2) / (S * L) * torch.eye(S * L, dtype=G2.dtype,
                                                           device=G2.device)
    c = torch.linalg.solve(G2, d.reshape(S * L)).reshape(S, L)
    # sum_j (c_j * s_j) with c_j an L-tap filter
    nfft = 1 << (n + L - 1).bit_length()
    SF = torch.fft.rfft(sources, n=nfft, dim=-1)
    CF = torch.fft.rfft(c, n=nfft, dim=-1)
    return torch.fft.irfft(torch.sum(SF * CF, dim=0), n=nfft)[:n]


def _bss_eval(refs: torch.Tensor, e: torch.Tensor, target_index: int, L: int,
              eps: float) -> dict:
    """bss_eval_sources in the inputs' own float dtype (float32 from the
    public entry point)."""
    s_target = _project(refs[target_index:target_index + 1], e, L, eps)
    p_all = _project(refs, e, L, eps)
    e_interf = p_all - s_target
    e_artif = e - p_all
    P_t = torch.sum(s_target**2)
    P_i = torch.sum(e_interf**2)
    P_a = torch.sum(e_artif**2)
    return {
        "sdr": 10.0 * torch.log10(P_t / (P_i + P_a + eps) + eps),
        "sir": 10.0 * torch.log10(P_t / (P_i + eps) + eps),
        "sar": 10.0 * torch.log10((P_t + P_i) / (P_a + eps) + eps),
    }


def bss_eval_sources(reference_sources, estimated_source, target_index: int = 0,
                     filter_len: int = 512, eps: float = 1e-10, device=None) -> dict:
    """BSS-eval of one estimate against nsrc references.

    Args:
      reference_sources: (nsrc, n) true source signals (target first by
        default).
      estimated_source: (n,) enhanced signal.
      filter_len: allowed distortion filter length (mir_eval default 512).
      device: where NumPy input runs (CUDA unless "cpu"); a tensor stays on
        its device.

    Returns a dict of scalar float32 tensors 'sdr', 'sir', 'sar' (dB).
    """
    refs = as_input(reference_sources, device).to(torch.float32)
    e = as_input(estimated_source, device).to(device=refs.device, dtype=torch.float32)
    return _bss_eval(refs, e, target_index, filter_len, eps)
