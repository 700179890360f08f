"""Int8 SAME 3x3 conv with a fused epilogue: the CUDA kernels
``csrc/qconv_kernel.cu`` (``wgmma``, TMA-fed weights, persistent
warp-specialised blocks; its instances serve three routes, "wgmma", "split"
and "narrow", at the bundled widths and, its any-width instances, at any
other) and ``csrc/qconv_mma_kernel.cu`` (``mma.sync``; kept for the shapes
no instance of the other reads or fits), their wrapper and its plain PyTorch
version (counterpart of azoom.pallas.qconv_kernel.qconv3x3_pallas).

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

The activation scale is static (a float, passed by value) or dynamic
(``act_scale=None``): the reference QConv's default mode, ``max|x| / 127 +
1e-30`` of the tensor the conv reads (both inputs of a concat), for each
batch element on its own (:func:`dynamic_act_scale`), as the reference
takes it where it serves such a net: under ``jax.vmap``, one chunk of a
stream (stream/chunker.py) or one scene of a sweep (parallel/sweep.py) at a
time. A dynamic launch takes the input's per-element maxima ``in_max``
((B,) float32 on the device: max|x[b]|, or a pair, max|x[b]| and
max|x2[b]|, at a concat), which the launches that produced the input wrote
as they stored it (``out_max``), and each tile forms its element's scale
from them; the epilogue's row 0 then holds the weight scales, and the kernel
forms s1 = scale * w_scale. So the scale costs no pass of its own: only an
input that no such launch produced (a net's stem) takes one reduction
(:func:`input_max`). A dynamic launch raises ``out_max`` (zeros to start
with) to the maxima of its own output (csrc/act_max.cuh). Both modes
quantise with the same code, so a dynamic launch gives the codes of a
static one at the same value. Dynamic launches count as
``qconv3x3_dynamic`` in ``kernels.launches``.

Any Cin and any Cout are served, as the reference's QConv (an XLA conv)
serves them: a net trained at any ``--base``. A Cin that is not a multiple
of 16 (the stems' 2 logmag_ipd or 4 physics features, or 8, 20, 24, ...) is
packed and computed as ceil(Cin / 16) * 16 channels, those beyond Cin zero
(:func:`kernel_cin`), and the kernels' halo loads fill them with zero
codes: the int32 sums are the same. The int32 sums are exact up to
Cin = (2^31 - 1) // (9 * 127^2) = 14,794.

On a CUDA tensor the wrapper launches a kernel or raises; on a CPU tensor
it runs :func:`qconv3x3_plain`. Which kernel is a matter of shape alone
(:func:`plan`):
  - "wgmma": Cin % 32 == 0 with Cout of 64, 128 or 256 where two halos of
    all channels and three weight stages fit (every conv of the nano net at
    64 frames but its 16-channel stem);
  - "narrow", the same kernel at 16-channel taps or N = 32: the stems (Cin
    of 2, 4 or 16, Cout of 32 or 64) and Cin % 32 == 0 with Cout = 32 (the
    base-32 nets' first and last levels), where it fits;
  - "split", the same kernel in slices of 256 output channels, the halo in
    parts of Cs channels (each made once a tile and kept for every slice)
    and a tile as wide as pads the frames least: Cin % 32 == 0 with Cout of
    256 or 512 where "wgmma" does not fit (Cout = 512, Cin = 512, 256 -> 256
    at 6 frames);
  - the same three routes on the kernel's any-width instances (plans with
    ``wide``; :func:`_plan_any`) take every other width they read (Cout of
    8, 24, 48, 96, 384, 1024, ...; Cin of 20, 48, 80, 1024, 2048, ...: the
    convs of a net trained at another ``--base``) and the bundled widths
    where those routes do not fit (one- and two-frame planes at large Cin,
    Cout of 64 or 128 at large Cin): Cout masked on the least N that holds
    it or in slices of 256, taps of any multiple of 16 channels, and halo
    parts kept for every slice or made again for each;
  - the ``mma.sync`` kernel takes the rest, in slices of at most 256 output
    channels and, where the halo of all channels does not fit, in parts of
    the channels: inputs of Cin not a multiple of 4 (but a stem of 2) or a
    concat whose halves are not, halos of kernel_cin(Cin) % 128 != 0
    channels that do not fit beside two weight stages (320 on 8-frame
    tiles), one-frame planes at large Cin on 512- and 256-pixel tiles; no
    net of the bundled architectures at bases 16, 24, 32, 48 or 64 runs it
    at 48, 64 or 80 frames.
All agree bit for bit (``kernels/bench.py`` checks it on the card); none is
a fallback for a failed build or launch of another.
"""

from __future__ import annotations

import ctypes
import functools
import itertools

import torch
import torch.nn.functional as Fn

from azoom_torch import kernels
from azoom_torch.kernels import build

__all__ = [
    "qconv3x3", "qconv3x3_plain", "pack_weights", "epilogue_params", "quantize_weights", "plan",
    "route_counts", "wide_counts", "kernel_cin", "k_padded", "STEM_CINS", "dynamic_act_scale",
    "input_max",
]

_BN_EPS = 1e-5  # flax nn.BatchNorm default
SMEM_LIMIT = 232_448  # bytes of shared memory a block may have on sm_90
# Preprocessor macros of the wgmma kernel's build; kernels/bench.py sets
# ("AZT_QCONV_CLOCKS",) before the first launch to time the kernel's roles.
BUILD_DEFINES: tuple[str, ...] = ()
# Launches by route since import (kernels.launches counts all as "qconv3x3"), and of
# those the launches of the any-width instances (plans with "wide").
route_counts = {"wgmma": 0, "narrow": 0, "split": 0, "mma": 0}
wide_counts = {"wgmma": 0, "narrow": 0, "split": 0}

# csrc/qconv_kernel.cu's shared memory, beside the weight stages and the
# halos: slack to align the swizzled tiles, the consumer warps' output
# patches (8 warps x 16 rows x 40 floats), the 5 epilogue rows, the barriers
# (of 18 weight stages and 8 halo buffers).
_TILE_ALIGN, _STAGING, _BARRIERS, _MAX_STAGES = 1024, 8 * 16 * 40 * 4, (2 * 18 + 2 * 8) * 8, 18
STEM_CINS = (2, 4)  # the stems' widths below 16, which the narrow route takes as 16 channels
_MMA_WROW = 128 + 16  # a staged weight row of its two buffers: a K chunk and 16 pad bytes


def kernel_cin(cin: int) -> int:
    """The input width the kernels compute with: Cin rounded up to a
    multiple of 16 (16 for the stems of Cin in :data:`STEM_CINS`), the
    channels beyond Cin zero."""
    return -(-cin // 16) * 16


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


_C127: dict = {}  # device -> the float32 127 a dynamic scale is divided by


def input_max(x: torch.Tensor, x2: torch.Tensor | None = None):
    """The ``in_max`` of a dynamic conv's input, one reduction of each
    tensor: max|x[b]| of each batch element (B, ...), a (B,) float32 tensor
    on x's device, or at a concat the pair (max|x[b]|, max|x2[b]|). What the
    kernels write as ``out_max``, bit for bit: a maximum is exact."""
    if x2 is not None:
        return input_max(x), input_max(x2)
    return torch.linalg.vector_norm(x, float("inf"), dim=tuple(range(1, x.ndim)))


def _scale_of_max(m: torch.Tensor) -> torch.Tensor:
    """``m / 127 + 1e-30`` in float32. The division is an IEEE division by a
    device tensor (CUDA turns a division by a host scalar into a product by
    its reciprocal), as the reference's eager ``jnp`` and the kernels
    compute it."""
    c = _C127.get(m.device)
    if c is None:
        c = _C127[m.device] = torch.tensor(127.0, dtype=torch.float32, device=m.device)
    return m / c + 1e-30


def dynamic_act_scale(x: torch.Tensor, x2: torch.Tensor | None = None) -> torch.Tensor:
    """The reference QConv's per-call scale of each batch element of its
    input [x, x2] (B, ...): ``max|x[b]| / 127 + 1e-30`` in float32, a (B,)
    tensor on x's device, made without a host synchronisation: the plain
    version of the scale a dynamic launch forms from its input's maxima."""
    m = input_max(x)
    return _scale_of_max(m if x2 is None else torch.maximum(m, input_max(x2)))


def qconv3x3_plain(
    x: torch.Tensor,
    w_q: torch.Tensor,
    epi: torch.Tensor,
    act_scale: float | None,
    residual: torch.Tensor | None = None,
    relu: bool = True,
    x2: torch.Tensor | None = None,
    *,
    in_max=None,
    out_max: torch.Tensor | None = None,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch. The integer conv runs in
    float64, which is exact here: |acc| <= 9*Cin*127^2 (3.7e7 at Cin = 256)
    is beyond float32's exact range of 2^24 but far inside float64's.
    ``act_scale`` is a float, or None for the dynamic mode: the scales then
    come from ``in_max`` and the weight scales from ``epi``'s row 0, and
    ``out_max`` (or None) is raised to the output's per-element maxima in
    place, as :func:`qconv3x3` takes them."""
    if x2 is not None:
        x = torch.cat([x, x2], dim=-1)
    cin, cout = x.shape[-1], w_q.shape[0]
    ck = kernel_cin(cin)
    s1 = epi[0]
    if act_scale is None:
        m = in_max if x2 is None else torch.maximum(in_max[0], in_max[1])
        s = _scale_of_max(m).reshape(-1, 1, 1, 1)
        s1 = s * s1  # (B, 1, 1, Cout): scale[b] * w_scale
    else:
        s = torch.tensor(act_scale, dtype=torch.float32, device=x.device)
    x_q = torch.clamp(torch.round(x / s), -127, 127)
    w = w_q[:, :9 * ck].to(torch.float64).reshape(cout, 3, 3, ck)[..., :cin].permute(0, 3, 1, 2)
    acc = Fn.conv2d(x_q.to(torch.float64).permute(0, 3, 1, 2), w, padding=1)
    y = acc.permute(0, 2, 3, 1).to(torch.float32) * s1 + epi[1]
    y = (y - epi[2]) * epi[3] + epi[4]
    if residual is not None:
        y = residual + y
    if relu:
        y = torch.relu(y)
    if out_max is not None:
        torch.maximum(out_max, input_max(y), out=out_max)
    return y.contiguous()


def _pow2_floor(n: int, cap: int) -> int:
    tw = 1
    while tw * 2 <= min(n, cap):
        tw *= 2
    return tw


def _slice_width(cout: int) -> int:
    """The ``mma.sync`` kernel's output channels a block: the least of 32,
    64, 128 and 256 that holds Cout, else slices of 256; all 512 at
    Cout = 512, the bundled widths' tile of 32 pixels, which quantises its
    input once."""
    return 512 if cout == 512 else next((n for n in (32, 64, 128, 256) if cout <= n), 256)


def _plan_mma(cin: int, cout: int, frames: int) -> dict:
    """The ``mma.sync`` kernel's plan, which its C entry point checks: a
    slice of ``slice_width`` output channels a block (:func:`_slice_width`,
    ``n_slices`` of them), tiles of
    256 * 64 / slice_width pixels, and the halo in ``n_parts`` parts of
    ``part_channels`` channels (a multiple of 16; one part of all
    kernel_cin(Cin) channels where it fits beside the two weight buffers of
    slice_width rows of 128 + 16 bytes). ``k_chunks`` is the K chunks of 128
    a block walks: each part's 9 * part_channels columns rounded up to 32.
    Every shape fits: a part of 16 channels does at every tile."""
    ck = kernel_cin(cin)
    nb = _slice_width(cout)
    m_tile = 256 * 64 // nb
    tile_w = _pow2_floor(frames, m_tile)
    tile_rows = m_tile // tile_w
    pixels = (tile_rows + 2) * (tile_w + 2)
    weights = 2 * nb * _MMA_WROW
    widest = ((SMEM_LIMIT - weights) // pixels - 16) // 16 * 16  # >= 16 at every tile
    n_parts = -(-ck // widest)
    cp = -(-ck // (16 * n_parts)) * 16
    n_parts = -(-ck // cp)
    k_part = -(-9 * cp // 32) * 32
    return dict(kernel="mma", wide=False, m_tile=m_tile, tile_w=tile_w, tile_rows=tile_rows,
                slice_width=nb, n_slices=-(-cout // nb), part_channels=cp, n_parts=n_parts,
                k_chunks=n_parts * -(-k_part // 128), stages=2, resident=False,
                smem=pixels * (cp + 16) + weights)


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
    128 when n > 1), each made once a tile and kept for every slice: the
    fewest parts that fit, one in two halo buffers beside three weight
    stages of 256 x 128 bytes, or n > 1 in a buffer each beside two; None if
    no part size fits. Its weights always stream through the ring."""
    if cin % 32 or cout not in (256, 512):
        return None
    tile_w = _split_tile_w(frames)
    tile_rows = 128 // tile_w
    n_slices = cout // 256
    for n_parts in (1, 2, 4, 8):
        cs = cin // n_parts
        if cin % n_parts or (n_parts > 1 and cs % 128):
            continue
        buffers = max(2, n_parts)
        halo = (tile_rows + 2) * (tile_w + 2) * (cs + 16)
        fixed = _TILE_ALIGN + buffers * halo + _STAGING + 5 * cout * 4 + _BARRIERS
        stages = min(_MAX_STAGES, (SMEM_LIMIT - fixed) // (256 * 128))
        if stages < (3 if buffers == 2 else 2):
            continue
        k_chunks = -(-9 * cs // 128)
        return dict(kernel="split", wide=False, m_tile=128, tile_w=tile_w, tile_rows=tile_rows,
                    k_chunks=k_chunks, stages=stages, resident=False,
                    part_channels=cs, n_parts=n_parts, n_slices=n_slices,
                    halo_buffers=buffers, smem=fixed + stages * 256 * 128,
                    weight_bytes=n_slices * n_parts * k_chunks * 256 * 128,
                    halo_bytes=(tile_rows + 2) * (tile_w + 2) * cin * 4)
    return None


def _any_width(cin: int, cin1: int | None) -> bool:
    """Whether csrc/qconv_kernel.cu's any-width instances read this input:
    x alone of a multiple of 4 channels or 2 (a stem: float2 pixels), or a
    concat of halves that are multiples of 4 (float4 loads)."""
    if cin1 is None:
        return cin % 4 == 0 or cin == 2
    return cin1 % 4 == 0 and (cin - cin1) % 4 == 0


def _plan_any(cin: int, cout: int, frames: int) -> dict | None:
    """The any-width instances' plan (azt_qconv3x3_any), for the widths the
    routes above are not built for or do not fit: Cout on N, the least of 32,
    64, 128 and 256 that holds it, or in ceil(Cout / 256) slices of N = 256,
    the columns at or beyond Cout masked (the epilogue rows padded with zeros
    to n_slices * N); kernel_cin(Cin) channels in taps of any multiple of 16;
    tiles of 512, 256 or 128 pixels (N = 32, 64, else) as wide as pad the
    frames least, or narrower where nothing below fits at that width. The
    halo: all channels in two buffers beside at least three weight stages
    (all K chunks where they fit and there is one slice: the weights stay);
    else, at more than one slice, the fewest parts of a multiple of 128
    channels (at most 8), each made once a tile in a buffer of its own,
    beside two stages; else the fewest such parts made again for every slice
    (``remade``) through two buffers, beside two stages (fewer, wider parts
    measured faster than more stages: 1024 -> 1024 at 4 frames in 4 parts
    and 2 stages took 39.35 ms for DeepFPU base 64's six convs against 42.04
    in 8 parts and 4 stages, in turns, H100 80GB HBM3, kernels/bench.py
    qconv --against); else all channels beside two stages. A halo pixel
    takes 16 bytes of padding, 32 where kernel_cin(Cin) % 32 == 16 (an odd
    number of 16-byte units, whatever the channels). None if nothing fits.
    ``kernel`` names the route: "split" with slices or parts, "narrow" at
    N = 32 or 16-channel taps, else "wgmma"."""
    ck = kernel_cin(cin)
    n = next((w for w in (32, 64, 128, 256) if cout <= w), 256)
    n_slices = -(-cout // n)
    m_tile = {32: 512, 64: 256}.get(n, 128)
    ring = [(parts, True) for parts in range(2, ck // 128 + 1) if ck % (128 * parts) == 0]
    keep = [(parts, False) for parts, _ in ring if parts <= 8] if n_slices > 1 else []
    widths = [_split_tile_w(frames)]
    while widths[-1] > 1:
        widths.append(widths[-1] // 2)
    for tile_w, ((n_parts, remade), least) in itertools.product(
            widths, [((1, False), 3)] + [(c, 2) for c in keep] + [(c, 2) for c in ring]
            + [((1, False), 2)]):
        tile_rows = m_tile // tile_w
        pixels = (tile_rows + 2) * (tile_w + 2)
        cs = ck // n_parts
        buffers = 2 if n_parts == 1 or remade else n_parts
        halo = pixels * (cs + (32 if cs % 32 else 16))
        fixed = _TILE_ALIGN + buffers * halo + _STAGING + 5 * n_slices * n * 4 + _BARRIERS
        k_chunks = -(-9 * cs // 128)
        stages = min(_MAX_STAGES, (SMEM_LIMIT - fixed) // (n * 128))
        resident = n_slices * n_parts == 1 and stages >= k_chunks
        if resident:
            stages = k_chunks
        elif stages < least:
            continue
        kernel = ("split" if n_slices * n_parts > 1 else
                  "narrow" if n == 32 or ck == 16 else "wgmma")
        made = n_slices if remade else 1  # times a tile makes each part
        return dict(kernel=kernel, wide=True, m_tile=m_tile, tile_w=tile_w,
                    tile_rows=tile_rows, k_chunks=k_chunks, stages=stages, resident=resident,
                    slice_width=n, n_slices=n_slices, part_channels=cs, n_parts=n_parts,
                    halo_buffers=buffers, remade=remade, smem=fixed + stages * n * 128,
                    weight_bytes=0 if resident else n_slices * n_parts * k_chunks * n * 128,
                    halo_bytes=made * pixels * cin * 4)
    return None


@functools.cache
def plan(cin: int, cout: int, frames: int, cin1: int | None = None) -> dict:
    """How the card runs a (Cin, Cout) conv on planes of ``frames`` frames
    (``cin1``: at a concat, the channels of its first input): which kernel,
    its tile and its shared memory, from the shape alone.

    ``kernel`` "wgmma" or "narrow": tiles of ``tile_rows`` x ``tile_w`` =
    ``m_tile`` pixels (512 at Cout = 32, 256 at 64, else 128; ``tile_w`` the
    largest power of two up to min(frames, 64)) by all Cout channels. Shared
    memory holds two int8 halos of (tile_rows + 2) x (tile_w + 2) pixels x
    (kernel_cin(Cin) + 16) bytes, ``stages`` weight chunks of Cout x 128
    bytes and a fixed part. All ``k_chunks`` = ceil(k_padded(Cin) / 128)
    chunks are kept (``resident``) if they fit in 232,448 bytes, else as many
    stream through a ring as fit, at least 3 (the consumers feed it). The
    plan also says what a tile moves from L2 into its SM: ``weight_bytes``
    (the streamed chunks; 0 where they stay) and ``halo_bytes`` (the float32
    input of its halo, at most). "narrow" is this plan at
    16-channel taps (the stems of Cin 2, 4 and 16, Cout of 32 or 64) or
    Cout = 32; "wgmma" at Cin % 32 == 0 and Cout of 64, 128 or 256.
    ``kernel`` "split" (:func:`_plan_split`), where that does not fit or
    Cout = 512, for Cout of 256 or 512: the same kernel walking ``n_slices``
    slices of 256 channels and ``n_parts`` halo parts of ``part_channels``
    channels in ``halo_buffers`` buffers. ``wide`` True: the any-width
    instances' plan (:func:`_plan_any`), under the same three route names,
    for the shapes those do not take or fit. ``kernel`` "mma": the
    ``mma.sync`` kernel's slices, tile and halo parts (:func:`_plan_mma`),
    for the inputs the others do not read (a Cin that is neither a multiple
    of 4 nor 2, a concat whose halves are not multiples of 4 channels) and
    the shapes none fits. Raises ValueError only for a Cin, Cout or frame
    count that is not positive."""
    for name, v in (("Cin", cin), ("Cout", cout), ("frames", frames)):
        if v < 1:
            raise ValueError(f"qconv3x3: {name} must be positive, got {v}")
    ck = kernel_cin(cin)
    if not _any_width(cin, cin1):  # csrc/qconv_kernel.cu's float4 (float2 at a stem) loads
        return _plan_mma(cin, cout, frames)
    narrow = (cin in STEM_CINS + (16,) and cout in (32, 64)) or (cin % 32 == 0 and cout == 32)
    if narrow or (cin % 32 == 0 and cout in (64, 128, 256)):
        m_tile = {32: 512, 64: 256}.get(cout, 128)
        tile_w = _pow2_floor(frames, 64)
        tile_rows = m_tile // tile_w
        halo = (tile_rows + 2) * (tile_w + 2) * (ck + 16)
        fixed = _TILE_ALIGN + 2 * halo + _STAGING + 5 * cout * 4 + _BARRIERS
        k_chunks = -(-k_padded(cin) // 128)
        stages = min(k_chunks, _MAX_STAGES, (SMEM_LIMIT - fixed) // (cout * 128))
        if stages >= min(3, k_chunks):
            resident = stages == k_chunks
            return dict(kernel="narrow" if narrow else "wgmma", wide=False, m_tile=m_tile,
                        tile_w=tile_w,
                        tile_rows=tile_rows, k_chunks=k_chunks, stages=stages,
                        resident=resident, smem=fixed + stages * cout * 128,
                        weight_bytes=0 if resident else k_chunks * cout * 128,
                        halo_bytes=(tile_rows + 2) * (tile_w + 2) * cin * 4)
    return _plan_split(cin, cout, frames) or _plan_any(cin, cout, frames) or _plan_mma(
        cin, cout, frames)


@functools.cache
def _entry(kernel: str):
    if kernel == "wgmma":  # the wgmma and narrow routes: instances chosen by Cout and Cin
        fn = build.load_library("qconv_kernel", BUILD_DEFINES).azt_qconv3x3
        ints = 10
    elif kernel == "split":
        fn = build.load_library("qconv_kernel", BUILD_DEFINES).azt_qconv3x3_split
        ints = 11
    elif kernel == "any":
        fn = build.load_library("qconv_kernel", BUILD_DEFINES).azt_qconv3x3_any
        ints = 12
    else:
        fn = build.load_library("qconv_mma_kernel").azt_qconv3x3_mma
        ints = 12
    fn.argtypes = (
        [ctypes.c_void_p] * 9 + [ctypes.c_float] + [ctypes.c_int] * ints + [ctypes.c_void_p]
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
    act_scale: float | None,
    residual: torch.Tensor | None = None,
    relu: bool = True,
    x2: torch.Tensor | None = None,
    *,
    in_max=None,
    out_max: torch.Tensor | None = None,
    _kernel: str | None = None,
) -> torch.Tensor:
    """Fused int8 Conv3x3(SAME) + epilogue on (B, F, T, Cin) float32 ->
    (B, F, T, Cout) float32. ``act_scale`` is the static activation scale
    (a positive float32 value), or None for dynamic scales: ``in_max`` then
    holds the input's per-element maxima, a (B,) float32 tensor on x's
    device, max|x[b]|, or at a concat a pair of them, (max|x[b]|,
    max|x2[b]|) (:func:`input_max`'s forms), from which the kernel forms
    :func:`dynamic_act_scale`'s
    value itself (their values are not checked, which would synchronise),
    and ``epi``'s row 0 holds the weight scales. ``out_max``, a (B,) float32
    tensor on x's device or None, is raised in place to max|y[b]| of the
    output (dynamic mode only; start it at zeros). With ``x2`` the input is
    the channel concat [x, x2], which the kernel reads in place.
    ``_kernel="mma"`` runs the ``mma.sync`` kernel where :func:`plan` would
    pick another route: for the bit-for-bit comparison of the kernels, not
    for callers."""
    dynamic = act_scale is None
    _require(dynamic == (in_max is not None), "in_max goes with act_scale=None, and only there")
    _require(dynamic or out_max is None, "out_max needs the dynamic mode (act_scale=None)")
    maxima = ()
    if dynamic:
        pair = x2 is not None
        _require(isinstance(in_max, torch.Tensor) != pair and (not pair or len(in_max) == 2),
                 "in_max must be one (B,) tensor, or a pair (max|x|, max|x2|) at a concat")
        maxima = tuple(in_max) if pair else (in_max,)
    if x.device.type == "cpu":
        return qconv3x3_plain(x, w_q, epi, act_scale, residual, relu, x2, in_max=in_max,
                              out_max=out_max)
    _require(x.device.type == "cuda", f"unsupported device {x.device}")
    _require(x.dtype == torch.float32 and x.ndim == 4,
             f"x must be float32 (B, F, T, Cin), got {x.dtype} {tuple(x.shape)}")
    B, F, T, cin1 = x.shape
    cin = cin1
    if x2 is not None:
        _require(x2.dtype == torch.float32 and x2.ndim == 4 and x2.shape[:3] == x.shape[:3],
                 f"x2 must be float32 {(B, F, T)} + (C,), got {x2.dtype} {tuple(x2.shape)}")
        cin = cin1 + x2.shape[3]
    cout = w_q.shape[0]
    _require(B * F * T > 0 and cin > 0 and cout > 0, "empty input")
    how = plan(cin, cout, T, None if x2 is None else cin1)
    _require(w_q.dtype == torch.int8 and tuple(w_q.shape) == (cout, k_padded(cin)),
             f"w_q must be int8 ({cout}, {k_padded(cin)}), got {w_q.dtype} {tuple(w_q.shape)}")
    if dynamic:
        act_scale = 1.0
    else:
        _require(act_scale > 0 and act_scale != float("inf"), f"bad act_scale {act_scale}")
    for name, m in [("in_max", m) for m in maxima] + [("out_max", out_max)] * (out_max is not None):
        _require(m.dtype == torch.float32 and tuple(m.shape) == (B,) and m.device == x.device
                 and m.is_contiguous(),
                 f"{name} must be ({B},) float32 on {x.device}, got "
                 f"{m.dtype} {tuple(m.shape)} on {m.device}")
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
            None if residual is None else residual.data_ptr(), out.data_ptr(),
            *[None if i >= len(maxima) else maxima[i].data_ptr() for i in range(2)],
            None if out_max is None else out_max.data_ptr())
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        # Channels beyond Cin, up to kernel_cin(Cin), are zeros to the kernels.
        if how["wide"]:
            rc = _entry("any")(*ptrs, float(act_scale), int(relu), B, F, T, cin, cin1, cout,
                               how["tile_w"], how["part_channels"], int(how["remade"]),
                               how["stages"], how["smem"], stream)
        elif how["kernel"] in ("wgmma", "narrow"):
            rc = _entry("wgmma")(*ptrs, float(act_scale), int(relu), B, F, T, kernel_cin(cin),
                                 cin1, cout, how["tile_w"], how["stages"], how["smem"], stream)
        elif how["kernel"] == "split":
            rc = _entry("split")(*ptrs, float(act_scale), int(relu), B, F, T, cin, cin1, cout,
                                 how["tile_w"], how["part_channels"], how["stages"], how["smem"],
                                 stream)
        else:
            rc = _entry("mma")(*ptrs, float(act_scale), int(relu), B, F, T, cin, cin1, cout,
                               w_q.shape[1], how["tile_w"], how["part_channels"],
                               how["slice_width"], how["smem"], stream)
    build.check(rc, f"qconv3x3 {how['kernel']} kernel")
    kernels.count(kernels.launches, "qconv3x3_dynamic" if dynamic else "qconv3x3")
    kernels.count(route_counts, how["kernel"])
    if how["wide"]:
        kernels.count(wide_counts, how["kernel"])
    return out
