"""Projection-based separation metrics (counterpart of
azoom.eval.projection): output SINR/SIR with unit-normalised references,
and (SDR, SIR) with the output normalised too. float32, batched over
leading dimensions, on the device of the inputs."""

from __future__ import annotations

import torch

__all__ = ["osinr_osir", "sdr_sir", "sir_improvement_db"]

_EPS = 1e-10


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + _EPS)


def osinr_osir(output: torch.Tensor, target_ref: torch.Tensor, interference_ref: torch.Tensor):
    """(osinr_db, osir_db), each (...,), of an output (..., n) against the
    ground-truth stems (..., n): the references are unit-normalised, the
    output is projected onto them, the residual is noise + artifacts."""
    t = _unit(torch.as_tensor(target_ref).to(torch.float32))
    i = _unit(torch.as_tensor(interference_ref).to(torch.float32))
    y = torch.as_tensor(output).to(torch.float32)
    e_t = torch.sum(y * t, dim=-1, keepdim=True) * t
    e_i = torch.sum(y * i, dim=-1, keepdim=True) * i
    e_n = y - e_t - e_i
    P_t = torch.sum(e_t**2, dim=-1)
    P_i = torch.sum(e_i**2, dim=-1)
    P_n = torch.sum(e_n**2, dim=-1)
    osinr = 10.0 * torch.log10(P_t / (P_i + P_n + _EPS) + _EPS)
    osir = 10.0 * torch.log10(P_t / (P_i + _EPS) + _EPS)
    return osinr, osir


def sdr_sir(output: torch.Tensor, target_ref: torch.Tensor, interference_ref: torch.Tensor):
    """(SDR, SIR) in dB with the output unit-normalised too; SDR counts
    interference and artifacts as distortion."""
    y = _unit(torch.as_tensor(output).to(torch.float32))
    t = _unit(torch.as_tensor(target_ref).to(torch.float32))
    i = _unit(torch.as_tensor(interference_ref).to(torch.float32))
    e_t = torch.sum(y * t, dim=-1, keepdim=True) * t
    e_i = torch.sum(y * i, dim=-1, keepdim=True) * i
    e_a = y - e_t - e_i
    P_t = torch.sum(e_t**2, dim=-1)
    P_i = torch.sum(e_i**2, dim=-1) + _EPS
    P_a = torch.sum(e_a**2, dim=-1) + _EPS
    sir = 10.0 * torch.log10(P_t / P_i + _EPS)
    sdr = 10.0 * torch.log10(P_t / (P_i + P_a) + _EPS)
    return sdr, sir


def sir_improvement_db(enhanced, mixture_ch0, target_ref, interference_ref) -> torch.Tensor:
    """SIR(enhanced) - SIR(mixture channel 0), the headline number."""
    _, sir_out = osinr_osir(enhanced, target_ref, interference_ref)
    _, sir_in = osinr_osir(mixture_ch0, target_ref, interference_ref)
    return sir_out - sir_in
