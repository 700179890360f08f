"""azoom_torch.beam: see the package docstring. The names below are those
azoom.beam exports."""

from azoom_torch.beam.covariance import masked_covariance, recursive_covariance_update
from azoom_torch.beam.linalg2x2 import (
    cond_2x2,
    eigh_2x2_hermitian,
    solve_2x2_general,
    solve_2x2_hermitian,
)
from azoom_torch.beam.mvdr import apply_weights, masked_mvdr, mvdr_beamform, mvdr_weights
from azoom_torch.beam.postfilter import harmonic_regeneration
from azoom_torch.beam.rtf import rtf_from_covariances, rtf_mvdr_beamform
from azoom_torch.beam.wpd import masked_wpd, wpd_beamform

__all__ = [
    "harmonic_regeneration",
    "masked_wpd",
    "wpd_beamform",
    "rtf_from_covariances",
    "rtf_mvdr_beamform",
    "masked_covariance",
    "recursive_covariance_update",
    "cond_2x2",
    "eigh_2x2_hermitian",
    "solve_2x2_general",
    "solve_2x2_hermitian",
    "apply_weights",
    "masked_mvdr",
    "mvdr_beamform",
    "mvdr_weights",
]
