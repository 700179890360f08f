"""The TPUFPU's (1, 2)-stride ConvTranspose as a float32 product summed in a
fixed order: the CUDA kernel ``csrc/convt_kernel.cu``, its wrapper and its
plain PyTorch version.

Each output is one FMA chain over K in order, then the bias:

    acc = fma(x[p, k], W[k, c], acc)  for k = 0 .. K-1;   out = acc + bias

That is the order of the reference's float32 product on the CPU, and with
it the card, the plain version and the reference give the same bits. A
library GEMM would not: its summation order is its own, and the next layer
quantises this output to int8, where a one-ulp difference flips codes.

Any K >= 1 and any Cout >= 1 are taken, as the reference's flax
ConvTranspose takes any width (a net trained at any ``--base``): the
kernel masks the K and N edges of its tiles and never pads the chain with
zero steps (an FMA of a zero product can turn an accumulator of -0 into
+0).

In an int8 net on dynamic scales the next conv quantises this output by its
per-element maximum: given ``out_max``, a (B,) float32 tensor (zeros to
start with), the kernel raises it to max|out[b]| as it stores out, so no
pass of its own takes it (csrc/act_max.cuh).

On a CUDA tensor the wrapper launches the kernel or raises; on a CPU tensor
it runs :func:`convt1x2_plain`. :func:`plan` gives the kernel's tiles, grid
and shared memory from the shape alone; the C side checks them.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from azoom_torch import kernels
from azoom_torch.kernels import build

__all__ = ["convt1x2", "convt1x2_plain", "plan"]

# csrc/convt_kernel.cu: a 96 x 128 tile of out per block of 128 threads; K in
# chunks of 16 through a ring of 3 stages, each x^T (16 x (96 + 4) floats)
# and W (16 x 128 floats).
TILE_M, TILE_N, K_CHUNK, STAGES = 96, 128, 16, 3


def convt1x2_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                   out_max: torch.Tensor | None = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch: x (B, F, T, K) float32,
    weight (K, 2*Cout) = [W1 | W0], bias (Cout,) -> (B, F, 2T, Cout);
    ``out_max`` (B,) (or None) raised in place to max|out[b]|.

    The FMA chain is emulated in float64: x*w is exact in float64, and the
    float64 sum rounded to float32 equals the fused multiply-add except in
    rare double-rounding ties."""
    B, F, T, K = x.shape
    cout = bias.shape[0]
    x64 = x.reshape(-1, K).to(torch.float64)
    w64 = weight.to(torch.float64)
    acc = torch.zeros((x64.shape[0], 2 * cout), dtype=torch.float64, device=x.device)
    # The card takes every row at once; the CPU walks the chain on blocks of
    # rows whose 2 MB stay in cache (whole rows at once fault in fresh pages at
    # every step: 17x slower at 8,208 rows x 1,024 columns). Same bits.
    step = acc.shape[0] if x.is_cuda else max(1, 2**18 // (2 * cout))
    for r in range(0, acc.shape[0], step):
        a, xb = acc[r:r + step], x64[r:r + step]
        for k in range(K):
            a.copy_((a + xb[:, k:k + 1] * w64[k]).to(torch.float32))
    out = acc.to(torch.float32).reshape(B, F, 2 * T, cout) + bias
    if out_max is not None:
        m = torch.linalg.vector_norm(out, float("inf"), dim=(1, 2, 3))
        torch.maximum(out_max, m, out=out_max)
    return out


def plan(rows: int, k: int, n2: int) -> dict:
    """How the card runs out (rows, n2) = x (rows, k) @ W (k, n2): tiles of
    ``tile_m`` x ``tile_n`` outputs, one block each (``blocks``, a 1-D grid
    with the column tiles of a row tile adjacent), K in ``chunks`` of
    ``k_chunk`` (the last one short when k % 16 != 0) through ``stages``
    buffers of ``smem`` bytes in all. Raises ValueError only for an empty
    product: no rows, K = 0 or no columns."""
    if rows < 1 or k < 1 or n2 < 1:
        raise ValueError(f"convt1x2: empty product ({rows} rows, K = {k}, 2*Cout = {n2})")
    smem = STAGES * K_CHUNK * ((TILE_M + 4) + TILE_N) * 4
    grid_m, grid_n = -(-rows // TILE_M), -(-n2 // TILE_N)
    return dict(tile_m=TILE_M, tile_n=TILE_N, k_chunk=K_CHUNK, chunks=-(-k // K_CHUNK),
                stages=STAGES, grid=(grid_m, grid_n), blocks=grid_m * grid_n, smem=smem)


@functools.cache
def _entry():
    fn = build.load_library("convt_kernel").azt_convt1x2
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_long] * 2 + [ctypes.c_int] * 3
                   + [ctypes.c_long, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"convt1x2: {msg}")


def convt1x2(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
             out_max: torch.Tensor | None = None) -> torch.Tensor:
    """(1, 2)-stride ConvTranspose on (B, F, T, K) float32 -> (B, F, 2T, Cout);
    ``out_max``, a (B,) float32 tensor on x's device or None, is raised in
    place to max|out[b]|."""
    if x.device.type == "cpu":
        return convt1x2_plain(x, weight, bias, out_max)
    _require(x.device.type == "cuda", f"unsupported device {x.device}")
    _require(x.dtype == torch.float32 and x.ndim == 4,
             f"x must be float32 (B, F, T, K), got {x.dtype} {tuple(x.shape)}")
    B, F, T, K = x.shape
    cout = bias.shape[0]
    _require(weight.dtype == torch.float32 and tuple(weight.shape) == (K, 2 * cout),
             f"weight must be float32 ({K}, {2 * cout}), got {weight.dtype} {tuple(weight.shape)}")
    _require(bias.dtype == torch.float32 and bias.ndim == 1, "bias must be float32 (Cout,)")
    how = plan(B * F * T, K, 2 * cout)
    tensors = [("x", x), ("weight", weight), ("bias", bias)]
    if out_max is not None:
        _require(out_max.dtype == torch.float32 and tuple(out_max.shape) == (B,),
                 f"out_max must be float32 ({B},), got {out_max.dtype} {tuple(out_max.shape)}")
        tensors.append(("out_max", out_max))
    for name, t in tensors:
        _require(t.device == x.device, f"{name} is on {t.device}, x on {x.device}")
        _require(t.is_contiguous(), f"{name} must be contiguous")
        _require(t.data_ptr() % (4 if name == "out_max" else 16) == 0,
                 f"{name} must be {4 if name == 'out_max' else 16}-byte aligned")

    out = torch.empty((B, F, 2 * T, cout), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = _entry()(
            x.data_ptr(), weight.data_ptr(), bias.data_ptr(), out.data_ptr(),
            None if out_max is None else out_max.data_ptr(), B * F * T, F * T, K, 2 * cout, cout,
            how["blocks"], how["smem"],
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    build.check(rc, "convt1x2 kernel")
    kernels.count(kernels.launches, "convt1x2")
    return out
