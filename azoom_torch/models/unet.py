"""The bundled conv mask nets, serving forwards (counterpart of
azoom.models.unet): ``FreqPreservingUNet`` (3 levels, base 32),
``DeepFPU`` (4 residual levels, base 32) and ``TPUFPU`` (frequency
space-to-depth stem, residual U-Net, per-subband head).

Layout is channels-last (B, F, T, C) at every public function, as in the
JAX package. Pooling and upsampling touch only the time axis. With
``quant=True`` every 3x3 conv is a :class:`QConv`: int8 weights quantised
once at load, a static activation scale, and the inference BatchNorm applied
in the epilogue of the int8 conv kernel (azoom_torch.kernels.qconv_kernel).
With ``quant=False`` it is a :class:`FConv`: the float32 conv of the
reference's ``nn.Conv``, then its bias and BatchNorm in flax's order. The
forwards are serving-only; the weights come from a flax variables tree
through :func:`azoom_torch.models.convert.from_flax`.

Without calibrated scales the int8 convs quantise with the reference's
dynamic scale, ``max|x| / 127 + 1e-30`` of each batch element's input.
The nets then take it without a pass of its own: one forward zeroes one
(n, B) buffer of per-element maxima, every conv and upsampling writes its
output's row in its kernel's epilogue, and each conv reads the rows of its
inputs and forms the scale itself (:func:`_maxima_rows`, :func:`_pool`).
Only the stem's input, which no kernel of the net produced, takes one
reduction (TPUFPU's attention block feeds an upsampling, not a conv).

The time upsampling (a (1, 2)-stride ConvTranspose) stays float32 and runs
on its own kernel, which sums in the reference's order so the next layer's
int8 codes come out the same on every device. The 1x1 head is a float32
matmul, which PyTorch runs in full float32 on CUDA unless
``torch.backends.cuda.matmul.allow_tf32`` is set; its output only feeds the
sigmoid, so its rounding moves the mask by ulps.
"""

from __future__ import annotations

import copy

import torch
from torch import nn

from azoom_torch.kernels.convt_kernel import convt1x2
from azoom_torch.kernels.qconv_kernel import input_max, k_padded, qconv3x3
from azoom_torch.models.layers import FreqAttention

__all__ = [
    "FreqPreservingUNet", "DeepFPU", "TPUFPU", "QConv", "FConv", "ConvBNRelu", "ResBlock",
    "DoubleConv", "ConvTranspose1x2", "Head", "fold_freq", "unfold_freq", "pad_frames",
    "pool_time", "conv_shapes", "fold_time", "unfold_time", "time_pool_factor",
]


def fold_freq(x: torch.Tensor, fold: int) -> torch.Tensor:
    """Space-to-depth on frequency: (..., F, T, C) -> (..., ceil(F/fold), T,
    fold*C), zero-padding F. Bin k lands in row k//fold, channel
    (k % fold)*C + c."""
    F = x.shape[-3]
    pad_f = (-F) % fold
    if pad_f:
        x = nn.functional.pad(x, (0, 0, 0, 0, 0, pad_f))
    *lead, Fp, T, C = x.shape
    x = x.reshape(*lead, Fp // fold, fold, T, C).transpose(-3, -2)
    return x.reshape(*lead, Fp // fold, T, fold * C)


def unfold_freq(y: torch.Tensor, fold: int, n_freqs: int) -> torch.Tensor:
    """Inverse of :func:`fold_freq` for one lane per folded bin:
    (..., Fp, T, fold) -> (..., n_freqs, T)."""
    y = y.transpose(-1, -2)  # (..., Fp, fold, T)
    y = y.reshape(*y.shape[:-3], y.shape[-3] * fold, y.shape[-1])
    return y[..., :n_freqs, :]


def fold_time(x: torch.Tensor, tfold: int) -> torch.Tensor:
    """Space-to-depth on time: (..., T, C) -> (..., ceil(T/tfold), tfold*C),
    zero-padding T. Frame t lands in row t//tfold, channel (t % tfold)*C + c."""
    t = x.shape[-2]
    pad_t = (-t) % tfold
    if pad_t:
        x = nn.functional.pad(x, (0, 0, 0, pad_t))
    *lead, tp, c = x.shape
    return x.reshape(*lead, tp // tfold, tfold * c)


def unfold_time(y: torch.Tensor, tfold: int, n_frames: int) -> torch.Tensor:
    """Inverse of :func:`fold_time`: (..., Tp, tfold*C) -> (..., min(Tp*tfold,
    n_frames), C)."""
    *lead, tp, ch = y.shape
    return y.reshape(*lead, tp * tfold, ch // tfold)[..., :n_frames, :]


def time_pool_factor(depth: int) -> int:
    """Total time-axis downsampling of a depth-level U-Net."""
    return 2**depth


def pad_frames(x: torch.Tensor, multiple: int, axis: int = -2) -> tuple[torch.Tensor, int]:
    """Zero-pad the time axis (default axis -2 of (..., F, T, C)) to a
    multiple; returns (padded, original_length)."""
    t = x.shape[axis]
    pad = (-t) % multiple
    if pad == 0:
        return x, t
    widths = [0, 0] * x.ndim
    widths[2 * (x.ndim - 1 - axis % x.ndim) + 1] = pad
    return nn.functional.pad(x, widths), t


def pool_time(x: torch.Tensor) -> torch.Tensor:
    """MaxPool (1, 2) with stride (1, 2) on (B, F, T, C): halves time."""
    B, F, T, C = x.shape
    return x[:, :, :2 * (T // 2)].reshape(B, F, T // 2, 2, C).amax(dim=3)


def _pool(x: torch.Tensor, x_max: torch.Tensor | None):
    """:func:`pool_time` of a conv cell's output ``x`` and the maxima row to
    read for it: ``x_max``, x's own row, when the frames are even, else None
    (the reading conv then reduces the pooled tensor itself). Every cell
    ends in a ReLU, so x >= 0 and |pooled| = pooled; over an even frame
    count every frame lies in one pair, so max(pooled[b]) = max(x[b])
    exactly. An odd count drops the last frame, whose value may be the
    maximum. (The nets take T % 8 == 0, or 16 for DeepFPU, so their pools
    all see even counts.)"""
    return pool_time(x), (x_max if x.shape[2] % 2 == 0 else None)


def _no_row() -> None:
    return None


def _maxima_rows(net: nn.Module, x: torch.Tensor):
    """A callable that gives the next (B,) row of one zeroed (n, B) float32
    buffer, one for each conv or upsampling output that a later conv reads,
    when every 3x3 conv of ``net`` is int8 on dynamic scales; else one that
    gives None (each conv then quantises as it does alone). The count n (0:
    not all dynamic) is worked out once and kept on ``net`` until a QConv's
    ``act_scale`` is set again."""
    kept = net.__dict__.get("_maxima_rows_n")
    if kept is None or kept[0] != QConv.scales_set:
        convs = [m for m in net.modules() if isinstance(m, (QConv, FConv))]
        dynamic = all(isinstance(m, QConv) and m.act_scale is None for m in convs)
        n = len(convs) + sum(isinstance(m, ConvTranspose1x2) for m in net.modules())
        kept = net.__dict__["_maxima_rows_n"] = (QConv.scales_set, n if dynamic else 0)
    if not kept[1]:
        return _no_row
    return iter(torch.zeros((kept[1], x.shape[0]), dtype=torch.float32, device=x.device)).__next__


def _pair(a: torch.Tensor | None, b: torch.Tensor | None):
    """The maxima rows of a concat's two inputs, or None without both."""
    return None if a is None or b is None else (a, b)


class QConv(nn.Module):
    """Int8 SAME 3x3 conv with its dequant, bias and BatchNorm in a float32
    epilogue. Buffers: ``w_q`` (Cout, Kpad) int8 tap-major codes and ``epi``
    (5, Cout), the epilogue rows of azoom_torch.kernels.qconv_kernel.

    ``act_scale`` is the static activation scale, or None for the
    reference's dynamic mode (variables without ``quant_stats``): each call
    then quantises with ``max|x| / 127 + 1e-30`` of each batch element's
    input, which the kernel forms from the input's maxima ``in_max`` (one
    (B,) row, or a pair at a concat, written by the kernels that produced
    the input; without it one reduction of the input here), and ``epi``'s
    row 0 holds the weight scales that the kernel multiplies by it. A
    dynamic conv raises ``out_max`` to its output's maxima. Each element is
    one chunk or one scene, as the reference applies such a net to one at a
    time under ``jax.vmap``; so an element's output does not depend on the
    others in its batch."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.cin, self.cout = cin, cout
        self.register_buffer("w_q", torch.zeros((cout, k_padded(cin)), dtype=torch.int8))
        self.register_buffer("epi", torch.zeros((5, cout)))
        self.act_scale: float | None = 1.0

    scales_set = 0  # how often any QConv's act_scale was set: _maxima_rows's key

    @property
    def act_scale(self) -> float | None:
        return self._act_scale

    @act_scale.setter
    def act_scale(self, value: float | None) -> None:
        # A Python float: the kernel takes it by value, and reading it from
        # a device tensor would synchronise every call.
        self._act_scale = value
        QConv.scales_set += 1

    def forward(self, x, residual=None, relu: bool = True, x2=None, in_max=None, out_max=None):
        if self.act_scale is None and in_max is None:
            in_max = input_max(x, x2)  # an input that no kernel wrote maxima for
        return qconv3x3(x, self.w_q, self.epi, self.act_scale, residual=residual, relu=relu,
                        x2=x2, in_max=in_max, out_max=out_max)


class FConv(nn.Module):
    """Float32 SAME 3x3 conv, then its bias and the inference BatchNorm in
    flax's order: ``((conv + b1) - mean) * mul + beta`` (+ residual) (ReLU),
    with the (5, Cout) rows of :class:`QConv` in ``epi`` (row 0 unused) and
    ``weight`` (9 * Cin, Cout), tap-major as the int8 conv's packed rows.

    The reference's float convs are XLA convs, with no Pallas kernel. Here
    the nine taps are gathered (im2col, at most ``_GEMM_ELEMENTS`` floats at
    a time, in slices of the batch) and multiplied by one float32 matrix
    product: cuBLAS in full float32 on the card, as PyTorch runs float32
    matmuls unless ``torch.backends.cuda.matmul.allow_tf32`` is set. cuDNN's
    conv2d, even with TF32 off, put every float net's mask on an H100
    further from the CPU's (up to 3x) and ran the TPUFPU nets 2.7-13x slower
    (``python3 -m azoom_torch.kernels.bench float_conv``, PERF.md)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.cin, self.cout = cin, cout
        self.register_buffer("weight", torch.zeros((9 * cin, cout)))
        self.register_buffer("epi", torch.zeros((5, cout)))

    def forward(self, x, residual=None, relu: bool = True, x2=None, in_max=None, out_max=None):
        """``in_max`` and ``out_max``, the int8 convs' maxima, are ignored."""
        if x2 is not None:
            x = torch.cat([x, x2], dim=-1)
        B, F, T, C = x.shape
        xp = nn.functional.pad(x, (0, 0, 1, 1, 1, 1))
        step = max(1, _GEMM_ELEMENTS // (F * T * 9 * C))
        y = torch.cat([
            torch.matmul(torch.cat([xp[b:b + step, dy:dy + F, dx:dx + T]
                                    for dy in range(3) for dx in range(3)], dim=-1), self.weight)
            for b in range(0, B, step)])
        e = self.epi
        y = (y + e[1] - e[2]) * e[3] + e[4]
        if residual is not None:
            y = residual + y
        if relu:
            y = torch.relu(y)
        return y


_GEMM_ELEMENTS = 1 << 28  # im2col floats per matrix product of FConv (1 GiB)


def _conv3x3(cin: int, cout: int, quant: bool) -> nn.Module:
    return QConv(cin, cout) if quant else FConv(cin, cout)


class ConvBNRelu(nn.Module):
    """Conv 3x3 -> BatchNorm -> ReLU, one fused QConv (or FConv). The cells
    take their input's maxima rows ``in_max``, the row ``out_max`` of their
    output, and ``rows`` (:func:`_maxima_rows`) for the rows inside them."""

    def __init__(self, cin: int, cout: int, quant: bool = True):
        super().__init__()
        self.conv = _conv3x3(cin, cout, quant)

    def forward(self, x, x2=None, in_max=None, out_max=None):
        """``x2``: a second input, concatenated after ``x`` along channels."""
        return self.conv(x, relu=True, x2=x2, in_max=in_max, out_max=out_max)


class DoubleConv(nn.Module):
    """Two ConvBNRelu cells."""

    def __init__(self, cin: int, cout: int, quant: bool = True):
        super().__init__()
        self.cbr0 = ConvBNRelu(cin, cout, quant)
        self.cbr1 = ConvBNRelu(cout, cout, quant)

    def forward(self, x, x2=None, in_max=None, out_max=None, rows=_no_row):
        mid = rows()
        return self.cbr1(self.cbr0(x, x2, in_max, mid), in_max=mid, out_max=out_max)


class ResBlock(nn.Module):
    """relu(x + BN(Conv(relu(BN(Conv(x)))))); the residual add and the final
    ReLU run in the second conv's epilogue."""

    def __init__(self, ch: int, quant: bool = True):
        super().__init__()
        self.conv0 = _conv3x3(ch, ch, quant)
        self.conv1 = _conv3x3(ch, ch, quant)

    def forward(self, x, in_max=None, out_max=None, rows=_no_row):
        mid = rows()
        h = self.conv0(x, relu=True, in_max=in_max, out_max=mid)
        return self.conv1(h, residual=x, relu=True, in_max=mid, out_max=out_max)


def _conv_res(conv: ConvBNRelu, res: ResBlock, x, in_max, rows, x2=None, out: bool = True):
    """A ConvBNRelu then a ResBlock, as every level of DeepFPU and TPUFPU but
    the first and last runs them: (output, its maxima row; None without
    ``out``, which a level whose output feeds no conv leaves off, or without
    rows)."""
    mid, row = rows(), rows() if out else None
    return res(conv(x, x2, in_max, mid), in_max=mid, out_max=row, rows=rows), row


class ConvTranspose1x2(nn.Module):
    """flax ``nn.ConvTranspose(cout, (1, 2), strides=(1, 2))`` on (B, F, T, C):
    doubles time. flax does not flip the kernel, so with taps [W0, W1] frame
    2t gets x[t] @ W1 and frame 2t+1 gets x[t] @ W0. ``weight`` holds
    [W1 | W0] as one (Cin, 2*Cout) float32 matrix; the product runs on
    azoom_torch.kernels.convt_kernel, summed in the reference's order."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.cout = cout
        self.register_buffer("weight", torch.zeros((cin, 2 * cout)))
        self.register_buffer("bias", torch.zeros(cout))

    def forward(self, x, out_max=None):
        return convt1x2(x, self.weight, self.bias, out_max)


class Head(nn.Module):
    """The float32 1x1 conv head: (..., C) -> (..., n_out)."""

    def __init__(self, cin: int, n_out: int):
        super().__init__()
        self.register_buffer("weight", torch.zeros((cin, n_out)))
        self.register_buffer("bias", torch.zeros(n_out))

    def forward(self, x):
        return torch.matmul(x, self.weight) + self.bias


class FreqPreservingUNet(nn.Module):
    """3-level frequency-preserving U-Net -> sigmoid mask:
    (B, F, T, in_channels) features with T % 8 == 0 -> (B, F, T). Every
    level is a DoubleConv (base, 2 base, 4 base, bottleneck 8 base); the
    decoder's skip concat is read in place by the conv kernel."""

    FLAX_NAMES = {
        "e1": "DoubleConv_0", "e2": "DoubleConv_1", "e3": "DoubleConv_2", "b": "DoubleConv_3",
        "up3": "ConvTranspose_0", "d3": "DoubleConv_4",
        "up2": "ConvTranspose_1", "d2": "DoubleConv_5",
        "up1": "ConvTranspose_2", "d1": "DoubleConv_6",
        "head": "Conv_0",
    }

    def __init__(self, base: int = 32, in_channels: int = 2, quant: bool = True):
        super().__init__()
        q = quant
        self.in_channels = in_channels
        self.e1 = DoubleConv(in_channels, base, q)
        self.e2 = DoubleConv(base, 2 * base, q)
        self.e3 = DoubleConv(2 * base, 4 * base, q)
        self.b = DoubleConv(4 * base, 8 * base, q)
        self.up3, self.d3 = ConvTranspose1x2(8 * base, 4 * base), DoubleConv(8 * base, 4 * base, q)
        self.up2, self.d2 = ConvTranspose1x2(4 * base, 2 * base), DoubleConv(4 * base, 2 * base, q)
        self.up1, self.d1 = ConvTranspose1x2(2 * base, base), DoubleConv(2 * base, base, q)
        self.head = Head(base, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.float32).contiguous()
        rows = _maxima_rows(self, x)
        m1 = rows()
        skips = [(self.e1(x, out_max=m1, rows=rows), m1)]  # the stem's input: one reduction
        # every pooled tensor below is a cell's ReLU'd output: _pool keeps its row
        for enc in (self.e2, self.e3):
            p, pm = _pool(*skips[-1])
            m = rows()
            skips.append((enc(p, in_max=pm, out_max=m, rows=rows), m))
        p, pm = _pool(*skips[-1])
        h = self.b(p, in_max=pm, rows=rows)
        # decoder: conv(concat([upsampled, skip])), the concat read in place
        for up, dec in ((self.up3, self.d3), (self.up2, self.d2), (self.up1, self.d1)):
            skip, m = skips.pop()
            mu = rows()
            h = dec(up(h, mu), skip, _pair(mu, m), rows=rows)
        return torch.sigmoid(self.head(h))[..., 0]


class DeepFPU(nn.Module):
    """4-level residual frequency-preserving U-Net -> sigmoid mask:
    (B, F, T, in_channels) features with T % 16 == 0 -> (B, F, T). Encoder
    levels of base .. 8 base (a DoubleConv, then ConvBNRelu + ResBlock), a
    16 base bottleneck with two ResBlocks, a mirrored decoder."""

    FLAX_NAMES = {
        "e1": "DoubleConv_0",
        "e2_conv": "ConvBNRelu_0", "e2_res": "ResBlock_0",
        "e3_conv": "ConvBNRelu_1", "e3_res": "ResBlock_1",
        "e4_conv": "ConvBNRelu_2", "e4_res": "ResBlock_2",
        "b_conv": "ConvBNRelu_3", "b_res0": "ResBlock_3", "b_res1": "ResBlock_4",
        "up4": "ConvTranspose_0", "d4_conv": "ConvBNRelu_4", "d4_res": "ResBlock_5",
        "up3": "ConvTranspose_1", "d3_conv": "ConvBNRelu_5", "d3_res": "ResBlock_6",
        "up2": "ConvTranspose_2", "d2_conv": "ConvBNRelu_6", "d2_res": "ResBlock_7",
        "up1": "ConvTranspose_3", "d1": "DoubleConv_1",
        "head": "Conv_0",
    }

    def __init__(self, base: int = 32, in_channels: int = 4, quant: bool = True):
        super().__init__()
        q = quant
        self.in_channels = in_channels
        w1, w2, w3, w4, wb = base, 2 * base, 4 * base, 8 * base, 16 * base
        self.e1 = DoubleConv(in_channels, w1, q)
        self.e2_conv, self.e2_res = ConvBNRelu(w1, w2, q), ResBlock(w2, q)
        self.e3_conv, self.e3_res = ConvBNRelu(w2, w3, q), ResBlock(w3, q)
        self.e4_conv, self.e4_res = ConvBNRelu(w3, w4, q), ResBlock(w4, q)
        self.b_conv = ConvBNRelu(w4, wb, q)
        self.b_res0, self.b_res1 = ResBlock(wb, q), ResBlock(wb, q)
        self.up4 = ConvTranspose1x2(wb, w4)
        self.d4_conv, self.d4_res = ConvBNRelu(2 * w4, w4, q), ResBlock(w4, q)
        self.up3 = ConvTranspose1x2(w4, w3)
        self.d3_conv, self.d3_res = ConvBNRelu(2 * w3, w3, q), ResBlock(w3, q)
        self.up2 = ConvTranspose1x2(w3, w2)
        self.d2_conv, self.d2_res = ConvBNRelu(2 * w2, w2, q), ResBlock(w2, q)
        self.up1 = ConvTranspose1x2(w2, w1)
        self.d1 = DoubleConv(2 * w1, w1, q)
        self.head = Head(w1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.float32).contiguous()
        rows = _maxima_rows(self, x)
        m1 = rows()
        skips = [(self.e1(x, out_max=m1, rows=rows), m1)]  # the stem's input: one reduction
        # every pooled tensor below is a cell's ReLU'd output: _pool keeps its row
        for conv, res in ((self.e2_conv, self.e2_res), (self.e3_conv, self.e3_res),
                          (self.e4_conv, self.e4_res)):
            skips.append(_conv_res(conv, res, *_pool(*skips[-1]), rows))
        h, m = _conv_res(self.b_conv, self.b_res0, *_pool(*skips[-1]), rows)
        h = self.b_res1(h, in_max=m, rows=rows)
        # decoder: conv(concat([upsampled, skip])), the concat read in place
        for up, conv, res in ((self.up4, self.d4_conv, self.d4_res),
                              (self.up3, self.d3_conv, self.d3_res),
                              (self.up2, self.d2_conv, self.d2_res)):
            skip, m = skips.pop()
            mu = rows()
            h = _conv_res(conv, res, up(h, mu), _pair(mu, m), rows, x2=skip, out=False)[0]
        skip, m = skips.pop()
        mu = rows()
        h = self.d1(self.up1(h, mu), skip, _pair(mu, m), rows=rows)
        return torch.sigmoid(self.head(h))[..., 0]


class TPUFPU(nn.Module):
    """Frequency space-to-depth stem -> residual U-Net -> per-subband mask
    head, (B, F, T, in_channels) features with T % 8 == 0 -> (B, F, T) mask.

    ``bneck`` sets the bottleneck width (base * bneck); ``dec_div`` and
    ``enc_div`` divide the width of the non-final decoder and non-first
    encoder levels, as in azoom.models.unet.TPUFPU. ``quant`` picks the int8
    or the float convs. ``tfold`` folds time into channels at the stem as
    ``fold`` folds frequency (the stem conv takes fold * tfold *
    in_channels, the head predicts fold * tfold lanes per grid position);
    ``fattn`` heads of :class:`azoom_torch.models.layers.FreqAttention` (float32
    matrix products, in the int8 net too) follow the bottleneck, over the
    ceil(n_freqs / fold) folded rows its position embedding was made for.
    """

    # attribute -> flax module name, in the flax tree's creation order
    FLAX_NAMES = {
        "e1": "DoubleConv_0",
        "e2_conv": "ConvBNRelu_0", "e2_res": "ResBlock_0",
        "e3_conv": "ConvBNRelu_1", "e3_res": "ResBlock_1",
        "b_conv": "ConvBNRelu_2", "b_res0": "ResBlock_2", "b_res1": "ResBlock_3",
        "attn": "FreqAttention_0",
        "up3": "ConvTranspose_0", "d3_conv": "ConvBNRelu_3", "d3_res": "ResBlock_4",
        "up2": "ConvTranspose_1", "d2_conv": "ConvBNRelu_4", "d2_res": "ResBlock_5",
        "up1": "ConvTranspose_2", "d1": "DoubleConv_1",
        "head": "Conv_0",
    }

    def __init__(self, base: int = 64, fold: int = 4, in_channels: int = 4,
                 bneck: int = 8, dec_div: int = 1, enc_div: int = 1,
                 tfold: int = 1, fattn: int = 0, quant: bool = True, n_freqs: int = 513):
        super().__init__()
        self.fold, self.tfold, self.in_channels = fold, tfold, in_channels
        w_e2, w_e3 = base * 2 // enc_div, base * 4 // enc_div
        w_b = base * bneck
        w_d3, w_d2 = base * 4 // dec_div, base * 2 // dec_div
        q = quant
        self.e1 = DoubleConv(fold * tfold * in_channels, base, q)
        self.e2_conv, self.e2_res = ConvBNRelu(base, w_e2, q), ResBlock(w_e2, q)
        self.e3_conv, self.e3_res = ConvBNRelu(w_e2, w_e3, q), ResBlock(w_e3, q)
        self.b_conv = ConvBNRelu(w_e3, w_b, q)
        self.b_res0, self.b_res1 = ResBlock(w_b, q), ResBlock(w_b, q)
        self.attn = FreqAttention(-(-n_freqs // fold), w_b, fattn) if fattn > 0 else None
        self.up3 = ConvTranspose1x2(w_b, w_d3)
        self.d3_conv, self.d3_res = ConvBNRelu(w_d3 + w_e3, w_d3, q), ResBlock(w_d3, q)
        self.up2 = ConvTranspose1x2(w_d3, w_d2)
        self.d2_conv, self.d2_res = ConvBNRelu(w_d2 + w_e2, w_d2, q), ResBlock(w_d2, q)
        self.up1 = ConvTranspose1x2(w_d2, base)
        self.d1 = DoubleConv(2 * base, base, q)
        self.head = Head(base, fold * tfold)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        F, T = x.shape[-3], x.shape[-2]
        h = fold_freq(x.to(torch.float32), self.fold)
        if self.tfold > 1:
            h = fold_time(h, self.tfold)
        h = h.contiguous()
        rows = _maxima_rows(self, h)
        m1 = rows()
        skips = [(self.e1(h, out_max=m1, rows=rows), m1)]  # the stem's input: one reduction
        # every pooled tensor below is a cell's ReLU'd output: _pool keeps its row
        for conv, res in ((self.e2_conv, self.e2_res), (self.e3_conv, self.e3_res)):
            skips.append(_conv_res(conv, res, *_pool(*skips[-1]), rows))
        h, m = _conv_res(self.b_conv, self.b_res0, *_pool(*skips[-1]), rows)
        h = self.b_res1(h, in_max=m, rows=rows)
        if self.attn is not None:
            h = self.attn(h).contiguous()
        # decoder: conv(concat([upsampled, skip])), the concat read in place
        for up, conv, res in ((self.up3, self.d3_conv, self.d3_res),
                              (self.up2, self.d2_conv, self.d2_res)):
            skip, m = skips.pop()
            mu = rows()
            h = _conv_res(conv, res, up(h, mu), _pair(mu, m), rows, x2=skip, out=False)[0]
        skip, m = skips.pop()
        mu = rows()
        h = self.d1(self.up1(h, mu), skip, _pair(mu, m), rows=rows)
        out = self.head(h)
        if self.tfold > 1:
            # (..., Fp, Tp, tfold * fold) -> (..., Fp, T, fold): lanes
            # (tfold, fold), time-major, so time unfolds first
            out = unfold_time(out, self.tfold, T)
        return torch.sigmoid(unfold_freq(out, self.fold, F))


def conv_shapes(model: nn.Module, frames: int) -> list[tuple[int, int, int, bool, bool]]:
    """Each 3x3 conv of ``model`` in forward order on inputs of ``frames``
    frames: (Cin, Cout, frames, with a residual, input is a two-tensor
    channel concat). Read from a forward of a 3-bin zero input on the CPU
    through hooks, so the list is the net's, not a copy of it."""
    shapes = []

    def hook(mod, args, kwargs, out):
        x, x2 = args[0], kwargs.get("x2")
        cin = x.shape[-1] + (0 if x2 is None else x2.shape[-1])
        shapes.append((cin, mod.cout, x.shape[-2], kwargs.get("residual") is not None,
                       x2 is not None))

    probe = copy.deepcopy(model).to("cpu")
    handles = [m.register_forward_hook(hook, with_kwargs=True)
               for m in probe.modules() if isinstance(m, (QConv, FConv))]
    with torch.inference_mode():
        attn = getattr(probe, "attn", None)  # its position embedding fixes the rows
        rows = 3 if attn is None else attn.pos_emb.shape[0] * probe.fold
        probe(torch.zeros((1, rows, frames, probe.in_channels)))
    for h in handles:
        h.remove()
    return shapes
