"""Recursive (online) masked MVDR: the CUDA kernels
``csrc/online_mvdr_kernel.cu`` (M = 2) and ``csrc/online_mvdr_mmic_kernel.cu``
(M >= 3), their wrapper and their plain PyTorch version.

The reference has no Pallas kernel here: it runs the recursion as an XLA
``lax.scan`` over STFT frames (azoom.stream.online.online_masked_mvdr and
the one-hop step of azoom.stream.lowlat). On a CUDA tensor the wrapper
launches the kernel of its mic count, one launch for all T frames of every
stream, or raises if the inputs are not what the kernel takes (a ValueError
above the mic count whose state snapshots fit one block's shared memory:
M = 57 on an H100). On a CPU tensor it runs :func:`online_mvdr_plain`, the
reference's scan as a Python loop over frames. Either way the state
``(R_sum, w_sum)`` is read before the first frame and written back, in
place, after the last, so a stream carries it from one call (one hop) to
the next.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from azoom_torch import kernels
from azoom_torch.beam.linalgmm import solve_hermitian
from azoom_torch.kernels import build

__all__ = ["online_mvdr", "online_mvdr_plain", "initial_state"]

_SIGNATURE = (
    [ctypes.c_void_p] * 4 + [ctypes.c_float, ctypes.c_void_p] + [ctypes.c_float] * 4
    + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
)

@functools.cache
def _entry():
    fn = build.load_library("online_mvdr_kernel").azt_online_mvdr
    fn.argtypes = _SIGNATURE
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _entry_m():
    lib = build.load_library("online_mvdr_mmic_kernel")
    fn = lib.azt_online_mvdr_m
    fn.argtypes = [ctypes.c_int] + _SIGNATURE
    fn.restype = ctypes.c_int
    smem = lib.azt_online_mvdr_m_smem
    smem.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_long)]
    smem.restype = ctypes.c_long
    return fn, smem


_TOO_LARGE = -1  # the M-general entry's code: M's plan exceeds one block's shared memory


def _smem_error(M: int) -> ValueError:
    """The M-general kernel's one limit, in words: M mics' state snapshots
    do not fit one block's shared memory on the current card."""
    limit = ctypes.c_long()
    need = _entry_m()[1](M, ctypes.byref(limit))
    return ValueError(
        f"online_mvdr: {M} mics need {need} bytes of shared memory per block (two tiles "
        f"of 8 frames of M (M + 1) / 2 + 1 complex state snapshots, and the input tiles), "
        f"above this card's {limit.value}; the CPU plain version takes any M")


def initial_state(lead, n_freqs: int, n_mics: int = 2, device=None, eps: float = 1e-6):
    """A fresh stream's state, as the reference primes its scan:
    R_sum = eps * I complex64 (*lead, F, M, M) and w_sum = eps float32
    (*lead, F), on ``device``."""
    lead = tuple(lead)
    eye = torch.eye(n_mics, dtype=torch.complex64, device=device) * eps
    R_sum = eye.expand(lead + (n_freqs, n_mics, n_mics)).contiguous()
    w_sum = torch.full(lead + (n_freqs,), eps, dtype=torch.float32, device=device)
    return R_sum, w_sum


def online_mvdr_plain(
    Y: torch.Tensor,
    noise_mask: torch.Tensor,
    d: torch.Tensor,
    freqs_hz: torch.Tensor,
    R_sum: torch.Tensor,
    w_sum: torch.Tensor,
    target_mask: torch.Tensor | None = None,
    sigma: float = 1e-7,
    hp_cutoff_hz: float = 100.0,
    forget: float = 0.98,
    mask_floor: float = 0.0,
    eps: float = 1e-6,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch: the reference's scan step
    (azoom/stream/online.py:61-76) as a Python loop over frames, in its
    order, then the high-pass zeroing and the floored target-mask gain.
    Shapes as :func:`online_mvdr`; any M (beam.linalgmm.solve_hermitian: the
    closed form at M = 2, the unrolled Cholesky above)."""
    eye = torch.eye(Y.shape[-3], dtype=Y.dtype, device=Y.device)
    R, w_acc = R_sum, w_sum
    out = []
    for t in range(Y.shape[-1]):
        y_t = Y[..., t].transpose(-1, -2)  # (..., F, M)
        m_t = noise_mask[..., t]
        outer = y_t[..., :, None] * torch.conj(y_t)[..., None, :]  # y y^H, (..., F, M, M)
        R = forget * R + outer * m_t[..., None, None]
        w_acc = forget * w_acc + m_t
        R_loaded = R / (w_acc + eps)[..., None, None] + sigma * eye
        Rinv_d = solve_hermitian(R_loaded, d)
        denom = torch.sum(torch.conj(d) * Rinv_d, dim=-1, keepdim=True)
        w = Rinv_d / (denom + 1e-10)
        out.append(torch.sum(torch.conj(w) * y_t, dim=-1))  # (..., F)
    S = torch.stack(out, dim=-1)
    keep = (freqs_hz >= hp_cutoff_hz)[:, None]
    S = torch.where(keep, S, torch.zeros((), dtype=S.dtype, device=S.device))
    if target_mask is not None:
        S = S * (torch.clamp(target_mask, min=mask_floor) if mask_floor > 0 else target_mask)
    R_sum.copy_(R)
    w_sum.copy_(w_acc)
    return S


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"online_mvdr: {msg}")


def online_mvdr(
    Y: torch.Tensor,
    noise_mask: torch.Tensor,
    d: torch.Tensor,
    freqs_hz: torch.Tensor,
    R_sum: torch.Tensor,
    w_sum: torch.Tensor,
    target_mask: torch.Tensor | None = None,
    sigma: float = 1e-7,
    hp_cutoff_hz: float = 100.0,
    forget: float = 0.98,
    mask_floor: float = 0.0,
    eps: float = 1e-6,
) -> torch.Tensor:
    """Causal masked MVDR over T frames, the state carried in place.

    Y complex64 (..., M, F, T); noise_mask and target_mask float32
    (..., F, T); d complex64 (F, M); freqs_hz float32 (F,); R_sum complex64
    (..., F, M, M) and w_sum float32 (..., F), updated in place; sigma, the
    cutoff, forget, the floor and eps Python floats. Frame t's weights use
    frames <= t only. Returns S complex64 (..., F, T): w^H y, zero below the
    cutoff, times max(target_mask, mask_floor) when a target mask is given
    (the raw mask when the floor is 0). On CUDA, M = 2 launches the 2-mic
    kernel and M >= 3 the M-general one (counted apart, as
    "online_mvdr" and "online_mvdr_mmic"), up to the mic count whose state
    snapshots fit one block's shared memory (M = 57 on an H100; above it a
    ValueError)."""
    if Y.device.type == "cpu":
        return online_mvdr_plain(Y, noise_mask, d, freqs_hz, R_sum, w_sum, target_mask, sigma,
                                 hp_cutoff_hz, forget, mask_floor, eps)
    _require(Y.device.type == "cuda", f"unsupported device {Y.device}")
    _require(Y.dtype == torch.complex64 and Y.ndim >= 3 and Y.shape[-3] >= 2,
             f"Y must be complex64 (..., M, F, T) with M >= 2, got {Y.dtype} {tuple(Y.shape)}")
    M = Y.shape[-3]
    lead, (F, T) = Y.shape[:-3], Y.shape[-2:]
    tensors = {"Y": Y, "noise_mask": noise_mask, "d": d, "freqs_hz": freqs_hz, "R_sum": R_sum,
               "w_sum": w_sum}
    if target_mask is not None:
        tensors["target_mask"] = target_mask
    for name, t in tensors.items():
        _require(t.device == Y.device, f"{name} is on {t.device}, Y on {Y.device}")
        _require(t.is_contiguous(), f"{name} must be contiguous")
    for name in ("noise_mask", "target_mask"):
        if name in tensors:
            t = tensors[name]
            _require(t.dtype == torch.float32 and t.shape == lead + (F, T),
                     f"{name} must be float32 {tuple(lead + (F, T))}, got {t.dtype} "
                     f"{tuple(t.shape)}")
    _require(d.dtype == torch.complex64 and tuple(d.shape) == (F, M),
             f"d must be complex64 ({F}, {M}), got {d.dtype} {tuple(d.shape)}")
    _require(freqs_hz.dtype == torch.float32 and tuple(freqs_hz.shape) == (F,),
             f"freqs_hz must be float32 ({F},)")
    _require(R_sum.dtype == torch.complex64 and R_sum.shape == lead + (F, M, M),
             f"R_sum must be complex64 {tuple(lead + (F, M, M))}, got {R_sum.dtype} "
             f"{tuple(R_sum.shape)}")
    _require(w_sum.dtype == torch.float32 and w_sum.shape == lead + (F,),
             f"w_sum must be float32 {tuple(lead + (F,))}, got {w_sum.dtype} "
             f"{tuple(w_sum.shape)}")
    B = 1
    for n in lead:
        B *= n
    _require(B * F * T > 0, "empty input")

    S = torch.empty(lead + (F, T), dtype=torch.complex64, device=Y.device)
    args = (Y.data_ptr(), noise_mask.data_ptr(),
            None if target_mask is None else target_mask.data_ptr(), d.data_ptr(),
            float(sigma), freqs_hz.data_ptr(), float(hp_cutoff_hz), float(forget), float(eps),
            float(mask_floor), R_sum.data_ptr(), w_sum.data_ptr(), S.data_ptr(), B, F, T,
            torch.cuda.current_stream(Y.device).cuda_stream)
    with torch.cuda.device(Y.device):
        rc = _entry()(*args) if M == 2 else _entry_m()[0](M, *args)
        if M > 2 and rc == _TOO_LARGE:
            raise _smem_error(M)
    name = "online_mvdr" if M == 2 else "online_mvdr_mmic"
    build.check(rc, f"{name} kernel")
    kernels.count(kernels.launches, name)
    return S
