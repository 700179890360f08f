"""Int8 matrix product with exact int32 accumulation: the CUDA kernel
``csrc/int8_mm_kernel.cu``, its wrapper and its plain PyTorch version
(counterpart of the ``pallas_mm`` kernels of scripts/microbench_pallas_mm.py,
scripts/microbench_int8.py and scripts/microbench_int8b.py).

    out[m, n] = sum_k x[m, k] * w[k, n]      x (M, K) int8, w (K, N) int8 -> int32

The kernel reads both operands K-major (``wgmma`` s8 takes nothing else), so
one product is two launches on the stream, counted as one in
``kernels.launches``: a pre-pass that writes ``w`` transposed into scratch
allocated here, then the product over 128 x BN output tiles.

On a CUDA tensor the wrapper launches the kernel or raises; on a CPU tensor
it runs :func:`int8_mm_plain`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from azoom_torch import kernels
from azoom_torch.kernels import build

__all__ = ["MICROBENCH_SHAPES", "int8_mm", "int8_mm_plain", "supported_shape", "tile_n"]

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
    64 (K steps of 32 bytes, transposed in 64 x 64 blocks) and output tiles of
    128 rows by :func:`tile_n` columns."""
    return min(M, K, N) > 0 and K % 64 == 0 and M % 128 == 0 and N % 64 == 0


def tile_n(N: int) -> int:
    """Columns of an output tile: the widest of 256, 128, 64 that divides N,
    as the C entry point picks it."""
    return next(bn for bn in (256, 128, 64) if N % bn == 0)


@functools.cache
def _entry():
    fn = build.load_library("int8_mm_kernel").azt_int8_mm
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
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
             f"shape (M, K, N) = {(M, K, N)} is not a whole number of tiles "
             "(M % 128, K % 64, N % 64)")
    for name, t in (("x", x), ("w", w)):
        _require(t.is_contiguous(), f"{name} must be contiguous")
        _require(t.data_ptr() % 16 == 0, f"{name} must be 16-byte aligned")
    out = torch.empty((M, N), dtype=torch.int32, device=x.device)
    w_t = torch.empty((N, K), dtype=torch.int8, device=x.device)  # scratch: w transposed
    with torch.cuda.device(x.device):
        rc = _entry()(x.data_ptr(), w.data_ptr(), w_t.data_ptr(), out.data_ptr(), M, N, K,
                      torch.cuda.current_stream(x.device).cuda_stream)
    build.check(rc, "int8_mm kernel")
    kernels.count(kernels.launches, "int8_mm")
    return out
