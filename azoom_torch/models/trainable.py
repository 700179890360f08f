"""Trainable twins of the conv mask nets and the CRN (the ``train=True``
paths of azoom.models.unet and azoom.models.crn).

The serving modules (``unet.FreqPreservingUNet``, ``DeepFPU``, ``TPUFPU``,
``crn.CRNMaskNet``) hold inference buffers: int8 or im2col weights and the
BatchNorm folded into epilogue rows. Their twins here hold ``nn.Parameter``s
and BatchNorm statistics in the flax tree's layout and names
(``models.layers``), so ``variables()`` is the flax variables dict, which
``convert.from_flax`` serves on the int8 conv kernel unchanged (with the
serving class and keywords of ``serving_spec()``), and the reference's own
init loads for the parity tests (``load_variables``).

A twin is built lazily, as a flax module is initialised: the input's
frequency count and channels come from ``init(generator, sample_shape)`` or
``build(sample_shape)``. In ``train()`` mode BatchNorm takes the batch's
statistics (``layers.BatchNorm``); in ``eval()`` mode the running ones.
"""

from __future__ import annotations

import torch
from torch import nn

from azoom_torch.models.layers import (
    BatchNorm,
    Conv,
    ConvTranspose1x2,
    Dense,
    FlaxTree,
    FreqAttention,
    LSTMCell,
    lecun_normal_,
    pool_time,
)
from azoom_torch.models.unet import fold_freq, fold_time, unfold_freq, unfold_time

__all__ = [
    "TrainableNet", "FreqPreservingUNet", "DeepFPU", "TPUFPU", "CRNMaskNet", "ConvBNRelu",
    "DoubleConv", "ResBlock", "from_bundled",
]


class TrainableNet(FlaxTree):
    """A twin built at its first input shape (..., F, T, C)."""

    def __init__(self):
        super().__init__()
        self.built_shape = None

    def _build(self, n_freqs: int, in_channels: int) -> None:
        raise NotImplementedError

    def build(self, sample_shape) -> "TrainableNet":
        F, C = int(sample_shape[-3]), int(sample_shape[-1])
        if self.built_shape is None:
            self._build(F, C)
            self.built_shape = (F, C)
        elif self.built_shape != (F, C):
            raise ValueError(f"the net was built for (F, C) = {self.built_shape}, got {(F, C)}")
        return self

    @property
    def dtype(self) -> torch.dtype:
        """The parameters' dtype, which the forward casts its input to
        (float32; float64 after ``.double()``, as a rounding reference)."""
        return next(self.parameters()).dtype

    def init(self, generator: torch.Generator, sample_shape) -> "TrainableNet":
        """Build for ``sample_shape`` and draw flax's init from ``generator``."""
        return self.build(sample_shape).reset_parameters(generator)

    # The conv twins and the CRN have ``serving_spec()``, (serving class, its
    # keywords): ``convert.from_flax(cls, net.variables(), kw, quant, device)``
    # (``crn_from_flax(net.variables(), kw, device)``) serves their weights.
    # BLSTMMaskNet and QCNNMaskNet serve in their own module in ``eval()``.


class ConvBNRelu(FlaxTree):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.Conv_0 = Conv(cin, cout)
        self.BatchNorm_0 = BatchNorm(cout)

    def forward(self, x):
        return torch.relu(self.BatchNorm_0(self.Conv_0(x)))


class DoubleConv(FlaxTree):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.ConvBNRelu_0 = ConvBNRelu(cin, cout)
        self.ConvBNRelu_1 = ConvBNRelu(cout, cout)

    def forward(self, x):
        return self.ConvBNRelu_1(self.ConvBNRelu_0(x))


class ResBlock(FlaxTree):
    def __init__(self, ch: int):
        super().__init__()
        self.Conv_0, self.BatchNorm_0 = Conv(ch, ch), BatchNorm(ch)
        self.Conv_1, self.BatchNorm_1 = Conv(ch, ch), BatchNorm(ch)

    def forward(self, x):
        h = torch.relu(self.BatchNorm_0(self.Conv_0(x)))
        return torch.relu(x + self.BatchNorm_1(self.Conv_1(h)))


class _Levels:
    """Names the flax auto-named cells in creation order."""

    def __init__(self, net: nn.Module):
        self.net, self.counts = net, {}

    def add(self, kind: str, module: nn.Module) -> str:
        i = self.counts.get(kind, 0)
        self.counts[kind] = i + 1
        name = f"{kind}_{i}"
        self.net.add_module(name, module)
        return name


class FreqPreservingUNet(TrainableNet):
    """Twin of azoom.models.unet.FreqPreservingUNet."""

    def __init__(self, base: int = 32):
        super().__init__()
        self.base = base

    def _build(self, n_freqs, C):
        b = self.base
        self.DoubleConv_0 = DoubleConv(C, b)
        self.DoubleConv_1 = DoubleConv(b, 2 * b)
        self.DoubleConv_2 = DoubleConv(2 * b, 4 * b)
        self.DoubleConv_3 = DoubleConv(4 * b, 8 * b)
        self.ConvTranspose_0 = ConvTranspose1x2(8 * b, 4 * b)
        self.DoubleConv_4 = DoubleConv(8 * b, 4 * b)
        self.ConvTranspose_1 = ConvTranspose1x2(4 * b, 2 * b)
        self.DoubleConv_5 = DoubleConv(4 * b, 2 * b)
        self.ConvTranspose_2 = ConvTranspose1x2(2 * b, b)
        self.DoubleConv_6 = DoubleConv(2 * b, b)
        self.Conv_0 = Conv(b, 1, 1, 1)

    def serving_spec(self):
        from azoom_torch.models.unet import FreqPreservingUNet as Serving

        return Serving, dict(base=self.base, in_channels=self.built_shape[1])

    def forward(self, x):
        x = x.to(self.dtype)
        e1 = self.DoubleConv_0(x)
        e2 = self.DoubleConv_1(pool_time(e1))
        e3 = self.DoubleConv_2(pool_time(e2))
        b = self.DoubleConv_3(pool_time(e3))
        h = self.DoubleConv_4(torch.cat([self.ConvTranspose_0(b), e3], -1))
        h = self.DoubleConv_5(torch.cat([self.ConvTranspose_1(h), e2], -1))
        h = self.DoubleConv_6(torch.cat([self.ConvTranspose_2(h), e1], -1))
        return torch.sigmoid(self.Conv_0(h))[..., 0]


class _ResidualUNet(TrainableNet):
    """The DeepFPU / TPUFPU skeleton: a DoubleConv stem level, residual
    levels (ConvBNRelu + ResBlock), a bottleneck of a ConvBNRelu and two
    ResBlocks, a mirrored decoder, a DoubleConv last level and a 1x1 head."""

    def _build_levels(self, cin: int, enc: list[int], wb: int, dec: list[int], n_out: int,
                      attn=None) -> None:
        lv = _Levels(self)
        self.enc, self.dec = [], []
        self.enc.append((lv.add("DoubleConv", DoubleConv(cin, enc[0])),))
        for a, b in zip(enc[:-1], enc[1:]):
            self.enc.append((lv.add("ConvBNRelu", ConvBNRelu(a, b)), lv.add("ResBlock", ResBlock(b))))
        self.bott = (lv.add("ConvBNRelu", ConvBNRelu(enc[-1], wb)),
                     lv.add("ResBlock", ResBlock(wb)), lv.add("ResBlock", ResBlock(wb)))
        self.attn = lv.add("FreqAttention", attn) if attn is not None else None
        prev = wb
        skips = enc[::-1]
        for i, (w, skip) in enumerate(zip(dec, skips)):
            up = lv.add("ConvTranspose", ConvTranspose1x2(prev, w))
            if i == len(dec) - 1:
                self.dec.append((up, lv.add("DoubleConv", DoubleConv(w + skip, w))))
            else:
                self.dec.append((up, lv.add("ConvBNRelu", ConvBNRelu(w + skip, w)),
                                 lv.add("ResBlock", ResBlock(w))))
            prev = w
        self.head = lv.add("Conv", Conv(dec[-1], n_out, 1, 1))

    def _trunk(self, x):
        m = lambda name: getattr(self, name)  # noqa: E731
        skips = []
        h = x
        for i, level in enumerate(self.enc):
            if i:
                h = pool_time(h)
            for name in level:
                h = m(name)(h)
            skips.append(h)
        h = pool_time(h)
        for name in self.bott:
            h = m(name)(h)
        if self.attn is not None:
            h = m(self.attn)(h)
        for level, skip in zip(self.dec, skips[::-1]):
            h = torch.cat([m(level[0])(h), skip], -1)
            for name in level[1:]:
                h = m(name)(h)
        return m(self.head)(h)


class DeepFPU(_ResidualUNet):
    """Twin of azoom.models.unet.DeepFPU."""

    def __init__(self, base: int = 32):
        super().__init__()
        self.base = base

    def _build(self, n_freqs, C):
        b = self.base
        self._build_levels(C, [b, 2 * b, 4 * b, 8 * b], 16 * b, [8 * b, 4 * b, 2 * b, b], 1)

    def serving_spec(self):
        from azoom_torch.models.unet import DeepFPU as Serving

        return Serving, dict(base=self.base, in_channels=self.built_shape[1])

    def forward(self, x):
        return torch.sigmoid(self._trunk(x.to(self.dtype)))[..., 0]


class TPUFPU(_ResidualUNet):
    """Twin of azoom.models.unet.TPUFPU, with ``tfold`` and ``fattn``."""

    def __init__(self, base: int = 64, fold: int = 4, bneck: int = 8, dec_div: int = 1,
                 enc_div: int = 1, tfold: int = 1, fattn: int = 0):
        super().__init__()
        self.base, self.fold, self.bneck = base, fold, bneck
        self.dec_div, self.enc_div, self.tfold, self.fattn = dec_div, enc_div, tfold, fattn

    def _build(self, n_freqs, C):
        b, wb = self.base, self.base * self.bneck
        fp = -(-n_freqs // self.fold)
        attn = FreqAttention(fp, wb, self.fattn) if self.fattn > 0 else None
        self._build_levels(self.fold * self.tfold * C,
                           [b, 2 * b // self.enc_div, 4 * b // self.enc_div], wb,
                           [4 * b // self.dec_div, 2 * b // self.dec_div, b],
                           self.fold * self.tfold, attn)

    def serving_spec(self):
        from azoom_torch.models.unet import TPUFPU as Serving

        return Serving, dict(base=self.base, fold=self.fold, in_channels=self.built_shape[1],
                             bneck=self.bneck, dec_div=self.dec_div, enc_div=self.enc_div,
                             tfold=self.tfold, fattn=self.fattn, n_freqs=self.built_shape[0])

    def forward(self, x):
        F, T = x.shape[-3], x.shape[-2]
        h = fold_freq(x.to(self.dtype), self.fold)
        if self.tfold > 1:
            h = fold_time(h, self.tfold)
        out = self._trunk(h)
        if self.tfold > 1:
            out = unfold_time(out, self.tfold, T)
        return torch.sigmoid(unfold_freq(out, self.fold, F))


def _elu(y):
    return torch.where(y > 0, y, torch.expm1(torch.where(y > 0, torch.zeros_like(y), y)))


class _FreqDown(FlaxTree):
    """flax Conv((5, 1), strides=(2, 1), padding="SAME"), BatchNorm, ELU."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.Conv_0 = Conv(cin, cout, 5, 1)
        self.BatchNorm_0 = BatchNorm(cout)

    def forward(self, x):
        B, F, T, C = x.shape
        fo = -(-F // 2)
        pad = max((fo - 1) * 2 + 5 - F, 0)  # flax SAME: the extra row goes last
        xp = nn.functional.pad(x, (0, 0, 0, 0, pad // 2, pad - pad // 2))
        cols = torch.cat([xp[:, k:k + 2 * fo - 1:2] for k in range(5)], dim=-1)
        k = self.Conv_0.kernel
        y = torch.matmul(cols, k.reshape(5 * C, k.shape[-1])) + self.Conv_0.bias
        return _elu(self.BatchNorm_0(y))


class _ConvTranspose51(nn.Module):
    """flax ConvTranspose((5, 1), strides=(2, 1), padding="SAME") parameters:
    kernel (5, 1, Cin, Cout), lecun-normal (fan-in 5 Cin), bias."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(5, 1, cin, cout))
        self.bias = nn.Parameter(torch.zeros(cout))

    def reset(self, g) -> None:
        lecun_normal_(self.kernel, g, 5 * self.kernel.shape[2])
        with torch.no_grad():
            self.bias.zero_()


class _FreqUp(FlaxTree):
    """The (5, 1) stride-2 transposed conv as the serving CRN computes it:
    even output rows meet taps 1 and 3 of rows j-1 and j, odd rows taps 0, 2
    and 4 of rows j-1, j and j+1; one product with a (3 Cin, 2 Cout) kernel."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.cout = cout
        self.ConvTranspose_0 = _ConvTranspose51(cin, cout)
        self.BatchNorm_0 = BatchNorm(cout)

    def forward(self, x):
        B, F, T, C = x.shape
        k = self.ConvTranspose_0.kernel.reshape(5, C, self.cout)
        z = torch.zeros_like(k[0])
        w = torch.stack([torch.stack([k[1], k[0]], 1), torch.stack([k[3], k[2]], 1),
                         torch.stack([z, k[4]], 1)])  # (3, C, 2, Cout)
        xp = nn.functional.pad(x, (0, 0, 0, 0, 1, 1))
        cols = torch.cat([xp[:, j:j + F] for j in range(3)], dim=-1)
        y = torch.matmul(cols, w.reshape(3 * C, 2 * self.cout))
        y = y.reshape(B, F, T, 2, self.cout).transpose(2, 3).reshape(B, 2 * F, T, self.cout)
        return _elu(self.BatchNorm_0(y + self.ConvTranspose_0.bias))


class CRNMaskNet(TrainableNet):
    """Twin of azoom.models.crn.CRNMaskNet (whole-T training forward)."""

    def __init__(self, base: int = 16, hidden: int = 128, n_lstm: int = 2,
                 unidirectional: bool = True):
        super().__init__()
        self.base, self.hidden, self.n_lstm, self.unidirectional = base, hidden, n_lstm, unidirectional

    def _build(self, n_freqs, C):
        b, H = self.base, self.hidden
        rows = (n_freqs + (-n_freqs) % 8) // 8
        self._FreqDown_0, self._FreqDown_1 = _FreqDown(C, b), _FreqDown(b, 2 * b)
        self._FreqDown_2 = _FreqDown(2 * b, 4 * b)
        self.Dense_0 = Dense(rows * 4 * b, H)
        width = H if self.unidirectional else 2 * H
        lv = _Levels(self)
        self.cells = []
        for i in range(self.n_lstm):
            fwd = lv.add("OptimizedLSTMCell", LSTMCell(H if i == 0 else width, H))
            bwd = None if self.unidirectional else lv.add(
                "OptimizedLSTMCell", LSTMCell(H if i == 0 else width, H))
            self.cells.append((fwd, bwd))
        self.Dense_1 = Dense(width, rows * 4 * b)
        self._FreqUp_0, self._FreqUp_1 = _FreqUp(8 * b, 2 * b), _FreqUp(4 * b, b)
        self._FreqUp_2 = _FreqUp(2 * b, b)
        self.Conv_0 = Conv(b, 1, 1, 1)

    def serving_spec(self):
        from azoom_torch.models.crn import CRNMaskNet as Serving

        return Serving, dict(base=self.base, hidden=self.hidden, n_lstm=self.n_lstm,
                             unidirectional=self.unidirectional, n_freqs=self.built_shape[0])

    def forward(self, x):
        B, F, T, _ = x.shape
        h = nn.functional.pad(x.to(self.dtype), (0, 0, 0, 0, 0, (-F) % 8))
        e1 = self._FreqDown_0(h)
        e2 = self._FreqDown_1(e1)
        e3 = self._FreqDown_2(e2)
        _, Fr, Tr, Cr = e3.shape
        seq = self.Dense_0(e3.transpose(1, 2).reshape(B, Tr, Fr * Cr))
        for fwd, bwd in self.cells:
            f, _ = getattr(self, fwd).scan(seq)
            seq = f if bwd is None else torch.cat([f, getattr(self, bwd).scan(seq, reverse=True)[0]],
                                                  -1)
        bott = self.Dense_1(seq).reshape(B, Tr, Fr, Cr).transpose(1, 2)
        u3 = self._FreqUp_0(torch.cat([bott, e3], -1))
        u2 = self._FreqUp_1(torch.cat([u3, e2], -1))
        u1 = self._FreqUp_2(torch.cat([u2, e1], -1))
        return torch.sigmoid(self.Conv_0(u1)[:, :F, :, 0])


def from_bundled(name: str, n_freqs: int = 513, device=None):
    """A bundled artifact's float weights in its trainable twin (the warm
    start of ``fit(init_variables=...)`` and ``cli.train --init-from``):
    returns (twin on ``device`` in train mode, feature kind). The twin's
    class and keywords are the serving net's in ``models.pretrained``.
    ``device=None`` means CUDA and raises when there is no CUDA device."""
    from azoom_torch.config import resolve_device
    from azoom_torch.models import pretrained
    from azoom_torch.models.quantize import load_quantized

    fname, kind = pretrained.artifact_name(name)
    if name == "crn_causal":
        cls, kw = CRNMaskNet, pretrained._CRN_CAUSAL[1]
    else:
        serving_cls, kw = pretrained._PORTED[name][1:3]
        cls = {"FreqPreservingUNet": FreqPreservingUNet, "DeepFPU": DeepFPU,
               "TPUFPU": TPUFPU}[serving_cls.__name__]
    net = cls(**{k: v for k, v in kw.items() if k != "in_channels"})
    net.build((1, n_freqs, 16, {"logmag_ipd": 2, "physics": 4}[kind]))
    net.load_variables(load_quantized(pretrained.ASSETS / fname))
    return net.to(resolve_device(device)).train(), kind
