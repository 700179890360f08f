"""Fused hybrid hard-null beamformer: the CUDA kernel
``csrc/nullsteer_kernel.cu``, its wrapper and its plain PyTorch version.

Replaces azoom/pallas/nullsteer_kernel.py:_kernel (reached through
hard_null_pallas and hybrid_hard_null_pallas), together with the mic-0
bypass below 200 Hz and the post-filter multiply that the learned pipeline
applies after it.

It computes the XLA function azoom.beam.nullsteer.hybrid_hard_null_beamform
at M = 2, not the Pallas kernel's arithmetic. The Pallas kernel floors the
squared norm of the UNNORMALISED eigenvector candidate (nullsteer_kernel.py:59),
the phase (:62) and |det|^2 (:79) at an absolute 1e-10. At speech level the
interference covariance is ~1e-5, so its eigenvector comes out far shorter
than unit length, the cond test reads "ill-conditioned" and the row falls
back to delay-and-sum: on a seeded test scene 502 of 513 rows against the
XLA function's 142, and the count changes with the input's scale. The XLA
function judges degeneracy relative to the matrix scale, so its output is
scale-covariant; the port keeps that (tests/test_torch_nullsteer.py records
the difference).

What bounds it: bytes. Per (stream, bin, frame) element it reads Y (16 B),
the target mask (4 B) and the post-filter mask (4 B) and writes S (8 B);
the arithmetic is a few dozen flops per element plus ~350 float64
instructions per row for the closed form. Design: one launch for the batch;
a warp takes 4 rows, sums each over its frames as a warp per row would
(same order, same bits) and runs the closed form once per lane, for one of
the 4 rows, so a warp instruction of it serves 4 rows. The five covariance
sums and the closed form (eigenvector, Cramer solve, cond gate) run in
float64: the card and the CPU plain version then flip the cond gate only on
rows within ~1e-12 of the threshold, where float32 with two summation
orders would put every row near it at risk. S is rounded to complex64 once,
then multiplied by the post-filter mask in float32, as the pipeline does.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from azoom_torch import kernels
from azoom_torch.beam.covariance import masked_covariance
from azoom_torch.beam.linalg2x2 import cond_2x2
from azoom_torch.beam.nullsteer import constraint_matrix, hybrid_hard_null_beamform
from azoom_torch.kernels import build

__all__ = ["hard_null_fused", "hard_null_plain", "hard_null_cond"]


def hard_null_plain(
    Y: torch.Tensor,
    target_mask: torch.Tensor,
    d: torch.Tensor,
    freqs_hz: torch.Tensor,
    post_mask: torch.Tensor | None = None,
    cond_threshold: float = 10.0,
    lowfreq_bypass_hz: float = 200.0,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch: hybrid_hard_null_beamform in
    float64 (the interference weights 1 - target_mask taken in float32, as
    the reference takes them), rounded to complex64, times ``post_mask``.
    d is (F, 2) or one per stream (..., F, 2), as the kernel takes it."""
    S = hybrid_hard_null_beamform(
        Y.to(torch.complex128), target_mask, d.to(torch.complex128), freqs_hz,
        lowfreq_bypass_hz=lowfreq_bypass_hz, cond_threshold=cond_threshold,
    ).to(torch.complex64)
    return S if post_mask is None else S * post_mask


def hard_null_cond(Y: torch.Tensor, target_mask: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """cond(C) per (stream, bin) row, float64 (..., F): the value the kernel
    and its plain version hold against ``cond_threshold``."""
    R = masked_covariance(Y.to(torch.complex128), 1.0 - target_mask)
    return cond_2x2(constraint_matrix(R, d.to(torch.complex128)))


def bind(lib: ctypes.CDLL):
    """The C entry point ``azt_hard_null`` of a build of the kernel, with its
    argument types."""
    fn = lib.azt_hard_null
    fn.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_long, ctypes.c_void_p, ctypes.c_double, ctypes.c_float,
                                 ctypes.c_void_p]
        + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _entry():
    return bind(build.load_library("nullsteer_kernel"))


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"hard_null_fused: {msg}")


def hard_null_fused(
    Y: torch.Tensor,
    target_mask: torch.Tensor,
    d: torch.Tensor,
    freqs_hz: torch.Tensor,
    post_mask: torch.Tensor | None = None,
    cond_threshold: float = 10.0,
    lowfreq_bypass_hz: float = 200.0,
) -> torch.Tensor:
    """Hybrid hard-null beamforming + mic-0 bypass + post-filter.

    Y complex64 (..., 2, F, T); target_mask and post_mask float32
    (..., F, T) (the interference covariance is weighted by 1 -
    target_mask); d complex64, phase-normalised, shared (F, 2) or one per
    stream (..., F, 2) (the tracked pipeline steers each chunk on its own);
    freqs_hz float32 (F,). Returns complex64 (..., F, T). On a CUDA tensor
    one kernel launch for the whole batch; on a CPU tensor
    :func:`hard_null_plain`.
    """
    if Y.device.type == "cpu":
        return hard_null_plain(Y, target_mask, d, freqs_hz, post_mask, cond_threshold,
                               lowfreq_bypass_hz)
    _require(Y.device.type == "cuda", f"unsupported device {Y.device}")
    _require(Y.dtype == torch.complex64 and Y.ndim >= 3 and Y.shape[-3] == 2,
             f"Y must be complex64 (..., 2, F, T), got {Y.dtype} {tuple(Y.shape)}")
    lead, (F, T) = Y.shape[:-3], Y.shape[-2:]
    tensors = {"Y": Y, "target_mask": target_mask, "d": d, "freqs_hz": freqs_hz}
    if post_mask is not None:
        tensors["post_mask"] = post_mask
    for name, t in tensors.items():
        _require(t.device == Y.device, f"{name} is on {t.device}, Y on {Y.device}")
        _require(t.is_contiguous(), f"{name} must be contiguous")
    for name in ("target_mask", "post_mask"):
        if name in tensors:
            t = tensors[name]
            _require(t.dtype == torch.float32 and t.shape == lead + (F, T),
                     f"{name} must be float32 {tuple(lead + (F, T))}, got "
                     f"{t.dtype} {tuple(t.shape)}")
    _require(d.dtype == torch.complex64 and tuple(d.shape) in ((F, 2), tuple(lead) + (F, 2)),
             f"d must be complex64 ({F}, 2) or {tuple(lead) + (F, 2)}, got {d.dtype} "
             f"{tuple(d.shape)}")
    d_bstride = 0 if d.ndim == 2 else 2 * F
    _require(freqs_hz.dtype == torch.float32 and tuple(freqs_hz.shape) == (F,),
             f"freqs_hz must be float32 ({F},)")
    B = 1
    for n in lead:
        B *= n
    _require(B * F * T > 0, "empty input")

    S = torch.empty(lead + (F, T), dtype=torch.complex64, device=Y.device)
    with torch.cuda.device(Y.device):
        rc = _entry()(
            Y.data_ptr(), target_mask.data_ptr(),
            None if post_mask is None else post_mask.data_ptr(),
            d.data_ptr(), d_bstride, freqs_hz.data_ptr(), float(cond_threshold),
            float(lowfreq_bypass_hz), S.data_ptr(), B, F, T,
            torch.cuda.current_stream(Y.device).cuda_stream,
        )
    build.check(rc, "hard_null kernel")
    kernels.launches["hard_null"] += 1
    return S
