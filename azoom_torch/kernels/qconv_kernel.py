"""Int8 SAME 3x3 conv with a fused epilogue: the CUDA kernel
``csrc/qconv_kernel.cu``, its wrapper and its plain PyTorch version
(counterpart of azoom.pallas.qconv_kernel.qconv3x3_pallas).

    x_q = clip(round_half_even(x / act_scale), -127, 127)
    acc = conv3x3_same(x_q, w_q)                         (exact integers)
    y   = ((acc * s1 + b1) - mean) * mul + beta  (+ residual)  (ReLU)

Weights come pre-quantised as ``w_q`` (Cout, Kpad) int8: row n holds output
channel n's 3x3xCin taps in tap-major order, K index ``(3*dy + dx) * Cin +
c`` with dy over frequency and dx over time, zero-padded from 9*Cin up to
Kpad, a multiple of 32 (:func:`pack_weights`). ``epi`` (5, Cout) float32
holds the epilogue rows s1 = act_scale * w_scale, b1 = conv bias, and the
inference BatchNorm's mean, mul = gamma / sqrt(var + eps) and beta
(:func:`epilogue_params`). The epilogue keeps the float32 operation order of
the reference (azoom.models.unet.QConv, then flax's BatchNorm) rather than
one folded affine: the next layer's int8 codes are roundings of this
output, and folded-affine rounding differences flip codes that compound
through the net.

On a CUDA tensor the wrapper launches the kernel or raises; on a CPU tensor
it runs :func:`qconv3x3_plain`.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as Fn

from azoom_torch import kernels
from azoom_torch.kernels import build

__all__ = ["qconv3x3", "qconv3x3_plain", "pack_weights", "epilogue_params", "quantize_weights"]

_BN_EPS = 1e-5  # flax nn.BatchNorm default


def k_padded(cin: int) -> int:
    """Row length of the packed weights: 9*Cin rounded up to 32."""
    return -(-9 * cin // 32) * 32


def quantize_weights(kernel: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """QConv's per-output-channel symmetric int8 weights of a float32
    (..., Cout) kernel: scale = max|w| / 127 (0 -> 1), codes =
    clip(round(w / scale), -127, 127). Returns (int8 codes, float32 scale)."""
    kf = kernel.to(torch.float32)
    w_scale = torch.amax(torch.abs(kf), dim=tuple(range(kf.ndim - 1))) / 127.0
    w_scale = torch.where(w_scale == 0, torch.ones_like(w_scale), w_scale)
    w_q = torch.clamp(torch.round(kf / w_scale), -127, 127).to(torch.int8)
    return w_q, w_scale


def pack_weights(w_q: torch.Tensor) -> torch.Tensor:
    """(3, 3, Cin, Cout) int8 codes -> (Cout, Kpad) int8, tap-major along K."""
    kh, kw, cin, cout = w_q.shape
    if (kh, kw) != (3, 3):
        raise ValueError(f"expected a 3x3 kernel, got {(kh, kw)}")
    packed = torch.zeros((cout, k_padded(cin)), dtype=torch.int8, device=w_q.device)
    packed[:, :9 * cin] = w_q.reshape(9 * cin, cout).t()
    return packed


def epilogue_params(act_scale, w_scale, bias, bn=None) -> torch.Tensor:
    """The (5, Cout) float32 epilogue rows [s1, b1, mean, mul, beta] for a
    conv with per-channel ``w_scale`` and ``bias`` and an optional inference
    BatchNorm ``bn = (gamma, beta, mean, var)``; without one the rows are the
    exact identity (0, 1, 0). mul = gamma * (1 / sqrt(var + eps)), the
    reciprocal square root correctly rounded (taken in float64)."""
    s1 = torch.as_tensor(act_scale, dtype=torch.float32) * w_scale.to(torch.float32)
    b1 = bias.to(torch.float32)
    if bn is None:
        mean, mul, beta = torch.zeros_like(b1), torch.ones_like(b1), torch.zeros_like(b1)
    else:
        gamma, beta, mean, var = (t.to(torch.float32) for t in bn)
        rs = (1.0 / torch.sqrt((var + _BN_EPS).to(torch.float64))).to(torch.float32)
        mul = rs * gamma
    return torch.stack([s1, b1, mean, mul, beta]).contiguous()


def qconv3x3_plain(
    x: torch.Tensor,
    w_q: torch.Tensor,
    epi: torch.Tensor,
    act_scale: float,
    residual: torch.Tensor | None = None,
    relu: bool = True,
    x2: torch.Tensor | None = None,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch. The integer conv runs in
    float64, which is exact here: |acc| <= 9*Cin*127^2 (3.7e7 at Cin = 256)
    is beyond float32's exact range of 2^24 but far inside float64's."""
    if x2 is not None:
        x = torch.cat([x, x2], dim=-1)
    cin, cout = x.shape[-1], w_q.shape[0]
    s = torch.tensor(act_scale, dtype=torch.float32, device=x.device)
    x_q = torch.clamp(torch.round(x / s), -127, 127)
    w = w_q[:, :9 * cin].to(torch.float64).reshape(cout, 3, 3, cin).permute(0, 3, 1, 2)
    acc = Fn.conv2d(x_q.to(torch.float64).permute(0, 3, 1, 2), w, padding=1)
    y = acc.permute(0, 2, 3, 1).to(torch.float32) * epi[0] + epi[1]
    y = (y - epi[2]) * epi[3] + epi[4]
    if residual is not None:
        y = residual + y
    if relu:
        y = torch.relu(y)
    return y.contiguous()


@functools.cache
def _entry():
    fn = build.load_library("qconv_kernel").azt_qconv3x3
    fn.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_float] + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"qconv3x3: {msg}")


def qconv3x3(
    x: torch.Tensor,
    w_q: torch.Tensor,
    epi: torch.Tensor,
    act_scale: float,
    residual: torch.Tensor | None = None,
    relu: bool = True,
    x2: torch.Tensor | None = None,
) -> torch.Tensor:
    """Fused int8 Conv3x3(SAME) + epilogue on (B, F, T, Cin) float32 ->
    (B, F, T, Cout) float32. ``act_scale`` is the static activation scale
    (a positive float32 value). With ``x2`` the input is the channel concat
    [x, x2], which the kernel reads in place."""
    if x.device.type == "cpu":
        return qconv3x3_plain(x, w_q, epi, act_scale, residual, relu, x2)
    _require(x.device.type == "cuda", f"unsupported device {x.device}")
    _require(x.dtype == torch.float32 and x.ndim == 4,
             f"x must be float32 (B, F, T, Cin), got {x.dtype} {tuple(x.shape)}")
    B, F, T, cin1 = x.shape
    cin = cin1
    if x2 is not None:
        _require(x2.dtype == torch.float32 and x2.ndim == 4 and x2.shape[:3] == x.shape[:3],
                 f"x2 must be float32 {(B, F, T)} + (C,), got {x2.dtype} {tuple(x2.shape)}")
        _require(cin1 % 4 == 0 and x2.shape[3] % 4 == 0,
                 "the channels of x and x2 must be multiples of 4")
        cin = cin1 + x2.shape[3]
    cout = w_q.shape[0]
    _require(cin % 16 == 0, f"Cin must be a multiple of 16, got {cin}")
    _require(cout in (64, 128, 256, 512), f"Cout must be 64, 128, 256 or 512, got {cout}")
    _require(w_q.dtype == torch.int8 and tuple(w_q.shape) == (cout, k_padded(cin)),
             f"w_q must be int8 ({cout}, {k_padded(cin)}), got {w_q.dtype} {tuple(w_q.shape)}")
    _require(B * F * T > 0, "empty input")
    _require(act_scale > 0 and act_scale != float("inf"), f"bad act_scale {act_scale}")
    _require(epi.dtype == torch.float32 and tuple(epi.shape) == (5, cout),
             f"epi must be float32 (5, {cout}), got {epi.dtype} {tuple(epi.shape)}")
    tensors = {"x": x, "w_q": w_q, "epi": epi}
    if x2 is not None:
        tensors["x2"] = x2
    if residual is not None:
        _require(residual.dtype == torch.float32 and residual.shape == (B, F, T, cout),
                 f"residual must be float32 {(B, F, T, cout)}")
        tensors["residual"] = residual
    for name, t in tensors.items():
        _require(t.device == x.device, f"{name} is on {t.device}, x on {x.device}")
        _require(t.is_contiguous(), f"{name} must be contiguous")
        _require(t.data_ptr() % 16 == 0, f"{name} must be 16-byte aligned")
    m_tile = 256 // (cout // 64)  # pixels per block, as the C entry point picks it
    tw = 1
    while tw * 2 <= min(T, m_tile):
        tw *= 2
    smem = (m_tile // tw + 2) * (tw + 2) * (cin + 16) + 2 * cout * 144
    _require(smem <= 227 * 1024, f"input halo needs {smem} B of shared memory")

    out = torch.empty((B, F, T, cout), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = _entry()(
            x.data_ptr(), None if x2 is None else x2.data_ptr(), w_q.data_ptr(),
            epi.data_ptr(), None if residual is None else residual.data_ptr(), out.data_ptr(),
            float(act_scale), int(relu), B, F, T, cin, cin1, cout, w_q.shape[1],
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    build.check(rc, "qconv3x3 kernel")
    kernels.launches["qconv3x3"] += 1
    return out
