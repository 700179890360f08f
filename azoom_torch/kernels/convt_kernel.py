"""The TPUFPU's (1, 2)-stride ConvTranspose as a float32 product summed in a
fixed order: the CUDA kernel ``csrc/convt_kernel.cu``, its wrapper and its
plain PyTorch version.

Each output is one FMA chain over K in order, then the bias:

    acc = fma(x[p, k], W[k, c], acc)  for k = 0 .. K-1;   out = acc + bias

That is the order of the reference's float32 product on the CPU, and with
it the card, the plain version and the reference give the same bits. A
library GEMM would not: its summation order is its own, and the next layer
quantises this output to int8, where a one-ulp difference flips codes.

On a CUDA tensor the wrapper launches the kernel or raises; on a CPU tensor
it runs :func:`convt1x2_plain`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from azoom_torch import kernels
from azoom_torch.kernels import build

__all__ = ["convt1x2", "convt1x2_plain"]


def convt1x2_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch: x (B, F, T, K) float32,
    weight (K, 2*Cout) = [W1 | W0], bias (Cout,) -> (B, F, 2T, Cout).

    The FMA chain is emulated in float64: x*w is exact in float64, and the
    float64 sum rounded to float32 equals the fused multiply-add except in
    rare double-rounding ties."""
    B, F, T, K = x.shape
    cout = bias.shape[0]
    x64 = x.reshape(-1, K).to(torch.float64)
    w64 = weight.to(torch.float64)
    acc = torch.zeros((x64.shape[0], 2 * cout), dtype=torch.float64, device=x.device)
    for k in range(K):
        acc = (acc + x64[:, k:k + 1] * w64[k]).to(torch.float32).to(torch.float64)
    out = acc.to(torch.float32).reshape(B, F, 2 * T, cout)
    return out + bias


@functools.cache
def _entry():
    fn = build.load_library("convt_kernel").azt_convt1x2
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_long] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"convt1x2: {msg}")


def convt1x2(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """(1, 2)-stride ConvTranspose on (B, F, T, K) float32 -> (B, F, 2T, Cout)."""
    if x.device.type == "cpu":
        return convt1x2_plain(x, weight, bias)
    _require(x.device.type == "cuda", f"unsupported device {x.device}")
    _require(x.dtype == torch.float32 and x.ndim == 4,
             f"x must be float32 (B, F, T, K), got {x.dtype} {tuple(x.shape)}")
    B, F, T, K = x.shape
    cout = bias.shape[0]
    _require(weight.dtype == torch.float32 and tuple(weight.shape) == (K, 2 * cout),
             f"weight must be float32 ({K}, {2 * cout}), got {weight.dtype} {tuple(weight.shape)}")
    _require(bias.dtype == torch.float32 and bias.ndim == 1, "bias must be float32 (Cout,)")
    _require(B * F * T > 0, "empty input")
    _require(K % 4 == 0, f"K must be a multiple of 4, got {K}")
    _require(32 * K * 4 <= 227 * 1024, f"K = {K} is too deep for the shared-memory tile")
    for name, t in (("x", x), ("weight", weight), ("bias", bias)):
        _require(t.device == x.device, f"{name} is on {t.device}, x on {x.device}")
        _require(t.is_contiguous(), f"{name} must be contiguous")

    out = torch.empty((B, F, 2 * T, cout), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = _entry()(
            x.data_ptr(), weight.data_ptr(), bias.data_ptr(), out.data_ptr(),
            B * F * T, K, 2 * cout, cout, torch.cuda.current_stream(x.device).cuda_stream,
        )
    build.check(rc, "convt1x2 kernel")
    kernels.launches["convt1x2"] += 1
    return out
