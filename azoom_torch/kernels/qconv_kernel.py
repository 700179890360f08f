"""Int8 SAME 3x3 conv with a fused epilogue: the CUDA kernels
``csrc/qconv_kernel.cu`` (``wgmma``, TMA-fed weights, persistent
warp-specialised blocks; two instances of it, the second the "split" route)
and ``csrc/qconv_mma_kernel.cu`` (``mma.sync``; kept for the shapes neither
instance takes), their wrapper and its plain PyTorch version (counterpart of
azoom.pallas.qconv_kernel.qconv3x3_pallas).

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

The stems of the unfolded nets take Cin = 2 (logmag_ipd features) or 4
(physics features). Their weights are packed as if Cin were 16, the
channels beyond Cin zero (:func:`kernel_cin`), and the kernel's halo load
fills those channels with zero codes: the int32 sums are the same.

On a CUDA tensor the wrapper launches a kernel or raises; on a CPU tensor
it runs :func:`qconv3x3_plain`. Which kernel is a matter of shape alone
(:func:`plan`): the ``wgmma`` kernel takes Cin % 32 == 0 with Cout of 64, 128
or 256 where two halos of all channels and three weight stages fit (every
conv of the nano net at 64 frames but its 16-channel stem); the "split"
instance of the same kernel takes Cin % 32 == 0 with Cout of 256 or 512
where that does not fit (Cout = 512, Cin = 512, 256 -> 256 at 6 frames):
slices of 256 output channels, the halo in parts of Cs channels, a tile as
wide as pads the frames least. The ``mma.sync`` kernel takes the rest (Cin
of 2, 4 or a multiple of 16; Cout of 32, 64, 128, 256 or 512). All three
agree bit for bit (``kernels/bench.py`` checks it on the card); none is a
fallback for a failed build or launch of another.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as Fn

from azoom_torch import kernels
from azoom_torch.kernels import build

__all__ = [
    "qconv3x3", "qconv3x3_plain", "pack_weights", "epilogue_params", "quantize_weights", "plan",
    "route_counts", "kernel_cin", "k_padded", "COUTS", "STEM_CINS",
]

_BN_EPS = 1e-5  # flax nn.BatchNorm default
SMEM_LIMIT = 232_448  # bytes of shared memory a block may have on sm_90
# Preprocessor macros of the wgmma kernel's build; kernels/bench.py sets
# ("AZT_QCONV_CLOCKS",) before the first launch to time the kernel's roles.
BUILD_DEFINES: tuple[str, ...] = ()
# Launches by route since import (kernels.launches counts all as "qconv3x3").
route_counts = {"wgmma": 0, "split": 0, "mma": 0}

# csrc/qconv_kernel.cu's shared memory, beside the weight stages and the two
# halos: slack to align the swizzled tiles, the consumer warps' output
# patches (8 warps x 16 rows x 40 floats), the 5 epilogue rows, the barriers.
_TILE_ALIGN, _STAGING, _BARRIERS, _MAX_STAGES = 1024, 8 * 16 * 40 * 4, (2 * 18 + 4) * 8, 18
COUTS = (32, 64, 128, 256, 512)  # the output widths a kernel takes
STEM_CINS = (2, 4)  # input widths below 16 the kernels take, as 16 zero-extended channels


def kernel_cin(cin: int) -> int:
    """The input width the kernels compute with: 16 for a stem of
    Cin in :data:`STEM_CINS`, else Cin."""
    return 16 if cin in STEM_CINS else cin


def k_padded(cin: int) -> int:
    """Row length of the packed weights: 9 * kernel_cin(Cin) rounded up to 32."""
    return -(-9 * kernel_cin(cin) // 32) * 32


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
    """(3, 3, Cin, Cout) int8 codes -> (Cout, Kpad) int8, tap-major along K,
    each tap's channels zero-extended to kernel_cin(Cin)."""
    kh, kw, cin, cout = w_q.shape
    if (kh, kw) != (3, 3):
        raise ValueError(f"expected a 3x3 kernel, got {(kh, kw)}")
    ck = kernel_cin(cin)
    if ck != cin:
        w_q = torch.nn.functional.pad(w_q, (0, 0, 0, ck - cin))
    packed = torch.zeros((cout, k_padded(cin)), dtype=torch.int8, device=w_q.device)
    packed[:, :9 * ck] = w_q.reshape(9 * ck, cout).t()
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
    ck = kernel_cin(cin)
    s = torch.tensor(act_scale, dtype=torch.float32, device=x.device)
    x_q = torch.clamp(torch.round(x / s), -127, 127)
    w = w_q[:, :9 * ck].to(torch.float64).reshape(cout, 3, 3, ck)[..., :cin].permute(0, 3, 1, 2)
    acc = Fn.conv2d(x_q.to(torch.float64).permute(0, 3, 1, 2), w, padding=1)
    y = acc.permute(0, 2, 3, 1).to(torch.float32) * epi[0] + epi[1]
    y = (y - epi[2]) * epi[3] + epi[4]
    if residual is not None:
        y = residual + y
    if relu:
        y = torch.relu(y)
    return y.contiguous()


def _pow2_floor(n: int, cap: int) -> int:
    tw = 1
    while tw * 2 <= min(n, cap):
        tw *= 2
    return tw


def _plan_mma(cin: int, cout: int, frames: int) -> dict:
    """The ``mma.sync`` kernel's tile and shared memory, as its C entry point
    picks them: 256 * 64 / Cout pixels, the halo and two buffers of Cout
    rows of 128 + 16 weight bytes."""
    ck = kernel_cin(cin)
    m_tile = 256 * 64 // cout
    tile_w = _pow2_floor(frames, m_tile)
    tile_rows = m_tile // tile_w
    smem = (tile_rows + 2) * (tile_w + 2) * (ck + 16) + 2 * cout * 144
    if smem > SMEM_LIMIT:
        raise ValueError(f"qconv3x3: Cin {cin}, Cout {cout} at {frames} frames needs {smem} B "
                         "of shared memory")
    return dict(kernel="mma", m_tile=m_tile, tile_w=tile_w, tile_rows=tile_rows,
                k_chunks=-(-k_padded(cin) // 128), stages=2, resident=False, smem=smem)


def _split_tile_w(frames: int) -> int:
    """The split route's tile width: the power of two up to 64 that pads the
    frames least (8 for 6 frames: one tile, two columns masked, against two
    4-wide tiles of the same padding and taller halos), the wider on a tie."""
    lo = _pow2_floor(frames, 64)
    hi = min(2 * lo, 64) if lo < frames else lo
    return min((lo, hi), key=lambda tw: (-(-frames // tw) * tw, -tw))


def _plan_split(cin: int, cout: int, frames: int) -> dict | None:
    """The split instance's plan (Cin % 32 == 0, Cout of 256 or 512): tiles
    of 128 pixels, Cout / 256 slices of 256 channels, and the halo in
    ``n_parts`` parts of ``part_channels`` = Cin / n channels (a multiple of
    128 when n > 1), the fewest parts with which two halos and three weight
    stages of 256 x 128 bytes fit; None if no part size does. Its weights
    always stream through the ring."""
    if cin % 32 or cout not in (256, 512):
        return None
    tile_w = _split_tile_w(frames)
    tile_rows = 128 // tile_w
    for n_parts in (1, 2, 4, 8):
        cs = cin // n_parts
        if cin % n_parts or (n_parts > 1 and cs % 128):
            continue
        halo = (tile_rows + 2) * (tile_w + 2) * (cs + 16)
        fixed = _TILE_ALIGN + 2 * halo + _STAGING + 5 * cout * 4 + _BARRIERS
        stages = min(_MAX_STAGES, (SMEM_LIMIT - fixed) // (256 * 128))
        if stages >= 3:
            return dict(kernel="split", m_tile=128, tile_w=tile_w, tile_rows=tile_rows,
                        k_chunks=-(-9 * cs // 128), stages=stages, resident=False,
                        part_channels=cs, n_parts=n_parts, n_slices=cout // 256,
                        smem=fixed + stages * 256 * 128)
    return None


@functools.cache
def plan(cin: int, cout: int, frames: int) -> dict:
    """How the card runs a (Cin, Cout) conv on planes of ``frames`` frames:
    which kernel, its tile and its shared memory, from the shape alone.

    ``kernel`` "wgmma": tiles of ``tile_rows`` x ``tile_w`` = ``m_tile``
    pixels (256 at Cout = 64, else 128; ``tile_w`` the largest power of two
    up to min(frames, 64)) by all Cout channels. Shared memory holds two int8
    halos of (tile_rows + 2) x (tile_w + 2) pixels x (Cin + 16) bytes,
    ``stages`` weight chunks of Cout x 128 bytes and a fixed part. All
    ``k_chunks`` = ceil(9 Cin / 128) chunks are kept (``resident``) if they
    fit in 232,448 bytes, else as many stream through a ring as fit, at
    least 3. ``kernel`` "split" (:func:`_plan_split`), where that does not
    fit or Cout = 512, for Cout of 256 or 512: the same kernel walking
    ``n_slices`` slices of 256 channels and ``n_parts`` halo parts of
    ``part_channels`` channels. ``kernel`` "mma": the ``mma.sync`` kernel's
    tile (256 * 64 / Cout pixels) and bytes, for Cin % 32 != 0 (the stems of
    Cin 2, 4 and 16 among them), Cout = 32, or when neither ``wgmma`` plan
    fits. Raises ValueError for a shape no kernel takes: Cin must be 2, 4 or
    a positive multiple of 16, Cout one of :data:`COUTS`."""
    if cin not in STEM_CINS and (cin < 16 or cin % 16):
        raise ValueError(f"qconv3x3: Cin must be 2, 4 or a multiple of 16, got {cin}")
    if cout not in COUTS:
        raise ValueError(f"qconv3x3: Cout must be one of {COUTS}, got {cout}")
    if frames < 1:
        raise ValueError(f"qconv3x3: frames must be positive, got {frames}")
    if cin % 32 == 0 and 64 <= cout <= 256:
        m_tile = 256 if cout == 64 else 128
        tile_w = _pow2_floor(frames, 64)
        tile_rows = m_tile // tile_w
        halo = (tile_rows + 2) * (tile_w + 2) * (cin + 16)
        fixed = _TILE_ALIGN + 2 * halo + _STAGING + 5 * cout * 4 + _BARRIERS
        k_chunks = -(-9 * cin // 128)
        stages = min(k_chunks, _MAX_STAGES, (SMEM_LIMIT - fixed) // (cout * 128))
        if stages >= min(3, k_chunks):
            return dict(kernel="wgmma", m_tile=m_tile, tile_w=tile_w, tile_rows=tile_rows,
                        k_chunks=k_chunks, stages=stages, resident=stages == k_chunks,
                        smem=fixed + stages * cout * 128)
    return _plan_split(cin, cout, frames) or _plan_mma(cin, cout, frames)


@functools.cache
def _entry(kernel: str):
    if kernel == "wgmma":
        fn = build.load_library("qconv_kernel", BUILD_DEFINES).azt_qconv3x3
        ints = 10
    elif kernel == "split":
        fn = build.load_library("qconv_kernel", BUILD_DEFINES).azt_qconv3x3_split
        ints = 11
    else:
        fn = build.load_library("qconv_mma_kernel").azt_qconv3x3_mma
        ints = 8
    fn.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_float] + [ctypes.c_int] * ints + [ctypes.c_void_p]
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
    *,
    _kernel: str | None = None,
) -> torch.Tensor:
    """Fused int8 Conv3x3(SAME) + epilogue on (B, F, T, Cin) float32 ->
    (B, F, T, Cout) float32. ``act_scale`` is the static activation scale
    (a positive float32 value). With ``x2`` the input is the channel concat
    [x, x2], which the kernel reads in place. ``_kernel="mma"`` runs the
    ``mma.sync`` kernel where :func:`plan` would pick ``wgmma`` or "split":
    for the bit-for-bit comparison of the kernels, not for callers."""
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
    _require(B * F * T > 0, "empty input")
    how = plan(cin, cout, T)  # raises for a shape no kernel takes
    _require(w_q.dtype == torch.int8 and tuple(w_q.shape) == (cout, k_padded(cin)),
             f"w_q must be int8 ({cout}, {k_padded(cin)}), got {w_q.dtype} {tuple(w_q.shape)}")
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
    if _kernel is not None:
        _require(_kernel == "mma", f"_kernel must be None or 'mma', got {_kernel!r}")
        how = _plan_mma(cin, cout, T)

    out = torch.empty((B, F, T, cout), dtype=torch.float32, device=x.device)
    ptrs = (x.data_ptr(), None if x2 is None else x2.data_ptr(), w_q.data_ptr(), epi.data_ptr(),
            None if residual is None else residual.data_ptr(), out.data_ptr())
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        if how["kernel"] == "wgmma":
            rc = _entry("wgmma")(*ptrs, float(act_scale), int(relu), B, F, T, cin, cin1, cout,
                                 how["tile_w"], how["stages"], how["smem"], stream)
        elif how["kernel"] == "split":
            rc = _entry("split")(*ptrs, float(act_scale), int(relu), B, F, T, cin, cin1, cout,
                                 how["tile_w"], how["part_channels"], how["stages"], how["smem"],
                                 stream)
        else:
            # A stem's channels beyond Cin1 (no x2) are zeros to the kernel.
            rc = _entry("mma")(*ptrs, float(act_scale), int(relu), B, F, T, kernel_cin(cin),
                               cin1, cout, w_q.shape[1], stream)
    build.check(rc, f"qconv3x3 {how['kernel']} kernel")
    kernels.launches["qconv3x3"] += 1
    route_counts[how["kernel"]] += 1
    return out
