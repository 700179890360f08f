"""Fused masked MVDR: the CUDA kernel ``csrc/mvdr_kernel.cu`` and its
wrapper (counterpart of azoom.pallas.mvdr_kernel.masked_mvdr_pallas).

On a CUDA tensor the wrapper launches the kernel, one launch for the whole
batch, or raises if the inputs are not what the kernel takes. On a CPU
tensor it runs the plain PyTorch version, :func:`azoom_torch.beam.mvdr.masked_mvdr`,
which computes the same function.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from azoom_torch import kernels
from azoom_torch.beam.mvdr import masked_mvdr
from azoom_torch.kernels import build

__all__ = ["masked_mvdr_fused"]

_SIGNATURE = (
    [ctypes.c_void_p] * 5 + [ctypes.c_float, ctypes.c_void_p, ctypes.c_float,
                             ctypes.c_float, ctypes.c_void_p]
    + [ctypes.c_int] * 3 + [ctypes.c_void_p]
)


@functools.cache
def _entry():
    fn = build.load_library("mvdr_kernel").azt_masked_mvdr
    fn.argtypes = _SIGNATURE
    fn.restype = ctypes.c_int
    return fn


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"masked_mvdr_fused: {msg}")


def masked_mvdr_fused(
    Y: torch.Tensor,
    noise_mask: torch.Tensor,
    d: torch.Tensor,
    freqs_hz: torch.Tensor,
    target_mask: torch.Tensor | None = None,
    sigma=1e-7,
    hp_cutoff_hz: float = 100.0,
    mask_floor: float = 0.0,
) -> torch.Tensor:
    """Masked MVDR + high-pass zeroing + floored target-mask gain.

    Y complex64 (..., 2, F, T); noise_mask and target_mask float32
    (..., F, T); d complex64 (F, 2); freqs_hz float32 (F,); sigma a Python
    scalar or a float32 tensor of shape () or (F,). Returns complex64
    (..., F, T).
    """
    if Y.device.type == "cpu":
        return masked_mvdr(
            Y, noise_mask, d, freqs_hz, target_mask=target_mask, sigma=sigma,
            hp_cutoff_hz=hp_cutoff_hz, mask_floor=mask_floor,
        )
    _require(Y.device.type == "cuda", f"unsupported device {Y.device}")
    _require(Y.dtype == torch.complex64 and Y.ndim >= 3 and Y.shape[-3] == 2,
             f"Y must be complex64 (..., 2, F, T), got {Y.dtype} {tuple(Y.shape)}")
    lead, (F, T) = Y.shape[:-3], Y.shape[-2:]
    tensors = {"Y": Y, "noise_mask": noise_mask, "d": d, "freqs_hz": freqs_hz}
    if target_mask is not None:
        tensors["target_mask"] = target_mask
    sigma_f = None
    if isinstance(sigma, torch.Tensor):
        _require(sigma.ndim == 0 or tuple(sigma.shape) == (F,),
                 f"sigma must be a scalar or (F,), got {tuple(sigma.shape)}")
        if sigma.ndim == 0:
            sigma = float(sigma)
        else:
            sigma_f = tensors["sigma"] = sigma
    for name, t in tensors.items():
        _require(t.device == Y.device, f"{name} is on {t.device}, Y on {Y.device}")
        _require(t.is_contiguous(), f"{name} must be contiguous")
    for name in ("noise_mask", "target_mask"):
        if name in tensors:
            t = tensors[name]
            _require(t.dtype == torch.float32 and t.shape == lead + (F, T),
                     f"{name} must be float32 {tuple(lead + (F, T))}, got "
                     f"{t.dtype} {tuple(t.shape)}")
    _require(d.dtype == torch.complex64 and tuple(d.shape) == (F, 2),
             f"d must be complex64 ({F}, 2), got {d.dtype} {tuple(d.shape)}")
    _require(freqs_hz.dtype == torch.float32 and tuple(freqs_hz.shape) == (F,),
             f"freqs_hz must be float32 ({F},)")
    if sigma_f is not None:
        _require(sigma_f.dtype == torch.float32, "sigma must be float32")
    B = 1
    for n in lead:
        B *= n
    _require(B * F * T > 0, "empty input")

    S = torch.empty(lead + (F, T), dtype=torch.complex64, device=Y.device)
    with torch.cuda.device(Y.device):
        rc = _entry()(
            Y.data_ptr(), noise_mask.data_ptr(),
            None if target_mask is None else target_mask.data_ptr(),
            d.data_ptr(), None if sigma_f is None else sigma_f.data_ptr(),
            float(sigma) if sigma_f is None else 0.0, freqs_hz.data_ptr(),
            float(hp_cutoff_hz), float(mask_floor), S.data_ptr(), B, F, T,
            torch.cuda.current_stream(Y.device).cuda_stream,
        )
    build.check(rc, "masked_mvdr kernel")
    kernels.launches["masked_mvdr"] += 1
    return S
