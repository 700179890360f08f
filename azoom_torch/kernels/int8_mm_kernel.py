"""Int8 matrix product with exact int32 accumulation: the CUDA kernel
``csrc/int8_mm_kernel.cu``, its wrapper and its plain PyTorch version
(counterpart of the ``pallas_mm`` kernels of scripts/microbench_pallas_mm.py,
scripts/microbench_int8.py and scripts/microbench_int8b.py).

    out[m, n] = sum_k x[m, k] * w[k, n]      x (M, K) int8, w (K, N) int8 -> int32

On a CUDA tensor the wrapper launches the kernel or raises; on a CPU tensor
it runs :func:`int8_mm_plain`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from azoom_torch import kernels
from azoom_torch.kernels import build

__all__ = ["MICROBENCH_SHAPES", "int8_mm", "int8_mm_plain", "supported_shape"]

# The microbenchmarks' (M, K, N) shapes, the TPUFPU im2col products, and
# the scripts that time each.
MICROBENCH_SHAPES = {
    (21504, 4608, 512): ("scripts/microbench_pallas_mm.py", "scripts/microbench_int8b.py"),
    (8192, 4608, 512): ("scripts/microbench_int8.py",),
    (8192, 512, 512): ("scripts/microbench_int8.py",),
    (16384, 2304, 256): ("scripts/microbench_int8.py",),
    (16384, 576, 64): ("scripts/microbench_int8.py",),
    (21504, 512, 512): ("scripts/microbench_int8b.py",),
    (43008, 2304, 256): ("scripts/microbench_int8b.py",),
    (86016, 1152, 128): ("scripts/microbench_int8b.py",),
    (172032, 576, 64): ("scripts/microbench_int8b.py",),
}


def int8_mm_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch: the float64 product cast to
    int32. Exact: every partial sum is an integer of magnitude at most
    K * 128^2, below 2^53 for K < 2^39."""
    return (x.to(torch.float64) @ w.to(torch.float64)).to(torch.int32)


def supported_shape(M: int, K: int, N: int) -> bool:
    """Whether the kernel's tiles cover (M, K, N) exactly: K a multiple of
    64, and 128 x 128 output tiles (N % 128 == 0) or 256 x 64 ones."""
    if K <= 0 or K % 64:
        return False
    if N > 0 and N % 128 == 0:
        return M > 0 and M % 128 == 0
    return N > 0 and N % 64 == 0 and M > 0 and M % 256 == 0


@functools.cache
def _entry():
    fn = build.load_library("int8_mm_kernel").azt_int8_mm
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"int8_mm: {msg}")


def int8_mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """int8 (M, K) @ int8 (K, N) -> int32 (M, N), exact."""
    _require(x.dtype == torch.int8 and w.dtype == torch.int8 and x.ndim == 2 and w.ndim == 2,
             f"x and w must be 2-D int8, got {x.dtype} {tuple(x.shape)}, "
             f"{w.dtype} {tuple(w.shape)}")
    (M, K), (K2, N) = x.shape, w.shape
    _require(K == K2, f"inner dimensions differ: {K} and {K2}")
    if x.device.type == "cpu":
        return int8_mm_plain(x, w)
    _require(x.device.type == "cuda", f"unsupported device {x.device}")
    _require(w.device == x.device, f"w is on {w.device}, x on {x.device}")
    _require(supported_shape(M, K, N),
             f"shape (M, K, N) = {(M, K, N)} is not a whole number of tiles (K % 64, "
             "and M % 128 with N % 128, or M % 256 with N % 64)")
    for name, t in (("x", x), ("w", w)):
        _require(t.is_contiguous(), f"{name} must be contiguous")
        _require(t.data_ptr() % 16 == 0, f"{name} must be 16-byte aligned")
    out = torch.empty((M, N), dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        rc = _entry()(x.data_ptr(), w.data_ptr(), out.data_ptr(), M, N, K,
                      torch.cuda.current_stream(x.device).cuda_stream)
    build.check(rc, "int8_mm kernel")
    kernels.launches["int8_mm"] += 1
    return out
