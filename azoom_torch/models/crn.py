"""CRN, the convolutional recurrent mask net of the low-latency path
(counterpart of azoom.models.crn.CRNMaskNet). Float32 only.

(B, F, T, 2) logmag_ipd features -> (B, F, T) mask. F is zero-padded to a multiple of 8; three
frequency-strided encoders (a (5, 1) conv of stride 2 along F, inference
BatchNorm, ELU) take it to F / 8 rows, each frame's (F / 8, 4 * base) plane
is flattened F-major and projected to ``hidden`` by a dense layer, LSTMs run
along time, a dense layer projects back, and three transposed convs (stride
2 along F, with the encoders' outputs concatenated as skips) restore F; a
1x1 head and a sigmoid give the mask, cropped to the input's F.

Every conv has time kernel 1, so with ``unidirectional=True`` the LSTM
carries are the net's only time state: :meth:`CRNMaskNet.forward` with
``carries`` (from :meth:`CRNMaskNet.initial_carries`) and
``return_carries=True`` runs a block of frames (one hop: T = 1) and hands
the carries on, with the same result as the whole-T pass (stream.lowlat).

The convs are im2col (the five taps gathered along channels) and one
matrix product, as ``unet.FConv`` (cuDNN's conv2d strays further from the
CPU). Every matrix product whose rows are frames (the convs, the dense
layers, the LSTM's input projections, the head) is taken in float64 and
rounded once to float32: a float32 GEMM's summation order, on the CPU and
on cuBLAS, depends on the number of rows, so one hop (T = 1) and a whole
clip gave rows that differ in the last bits (the dense layers by up to
2e-5), which the online MVDR's solve amplifies. Rounded once from float64
a row has the same bits whatever T is, and on either device.

The transposed conv is flax's ``ConvTranspose((5, 1), strides=(2, 1),
padding="SAME")``: the input dilated x2 along F, padded
(3, 2) and correlated with the kernel unflipped. Even output rows meet taps
1 and 3 of rows j-1 and j, odd rows taps 0, 2 and 4 of rows j-1, j and j+1,
so both phases come out of one product with a (3 Cin, 2 Cout) kernel (its
unused block zero). The LSTM is flax's ``OptimizedLSTMCell`` (gates i, f, g,
o; the input kernels without bias, the hidden kernels with it): the input
projections of all frames are one product, the recurrence a Python loop over
frames.
"""

from __future__ import annotations

import torch
from torch import nn

__all__ = ["CRNMaskNet"]


def _mm(x: torch.Tensor, w64: torch.Tensor) -> torch.Tensor:
    """x @ w64 in float64, rounded once to float32 (the module docstring
    says why)."""
    return torch.matmul(x.to(torch.float64), w64).to(torch.float32)


def _elu(y: torch.Tensor) -> torch.Tensor:
    """ELU as jax.nn.elu computes it: expm1 of the non-positive part."""
    return torch.where(y > 0, y, torch.expm1(torch.clamp(y, max=0.0)))


class _FreqConv(nn.Module):
    """(5, 1) conv of stride 2 along F (``up=False``: F -> ceil(F / 2)) or
    its transpose (``up=True``: F -> 2F), then its bias, the inference
    BatchNorm ``((y + bias) - mean) * mul + beta`` and ELU. ``weight``
    (float64) is (5 Cin, Cout), tap-major (down), or (3 Cin, 2 Cout): taps
    (1, 3, -) for the even rows beside taps (0, 2, 4) for the odd rows (up)."""

    def __init__(self, cin: int, cout: int, up: bool):
        super().__init__()
        self.cin, self.cout, self.up = cin, cout, up
        shape = (3 * cin, 2 * cout) if up else (5 * cin, cout)
        self.register_buffer("weight", torch.zeros(shape, dtype=torch.float64))
        self.register_buffer("epi", torch.zeros((4, cout)))  # bias, mean, mul, beta

    def load(self, kernel: torch.Tensor, bias, mean, mul, beta) -> None:
        """Fill from a flax kernel (5, 1, Cin, Cout) and the epilogue rows."""
        k = kernel.reshape(5, self.cin, self.cout)
        if self.up:
            w = torch.zeros((3, self.cin, 2, self.cout))
            w[0, :, 0], w[1, :, 0] = k[1], k[3]
            w[0, :, 1], w[1, :, 1], w[2, :, 1] = k[0], k[2], k[4]
            self.weight.copy_(w.reshape(3 * self.cin, 2 * self.cout))
        else:
            self.weight.copy_(k.reshape(5 * self.cin, self.cout))
        self.epi.copy_(torch.stack([bias, mean, mul, beta]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, F, T, _ = x.shape
        if self.up:
            xp = nn.functional.pad(x, (0, 0, 0, 0, 1, 1))
            cols = torch.cat([xp[:, k:k + F] for k in range(3)], dim=-1)
            y = _mm(cols, self.weight)  # (B, F, T, 2 Cout): even | odd rows
            y = y.reshape(B, F, T, 2, self.cout).transpose(2, 3).reshape(B, 2 * F, T, self.cout)
        else:
            fo = -(-F // 2)
            pad = max((fo - 1) * 2 + 5 - F, 0)  # flax SAME: the extra row goes last
            xp = nn.functional.pad(x, (0, 0, 0, 0, pad // 2, pad - pad // 2))
            cols = torch.cat([xp[:, k:k + 2 * fo - 1:2] for k in range(5)], dim=-1)
            y = _mm(cols, self.weight)
        e = self.epi
        return _elu((y + e[0] - e[1]) * e[2] + e[3])


class _LSTM(nn.Module):
    """One flax ``OptimizedLSTMCell`` over time. ``wi`` (In, 4H, float64)
    and ``wh`` (H, 4H) stack the kernels of gates i, f, g, o; ``bh`` (4H,)
    is the hidden kernels' bias. The recurrent product has B rows whatever
    T is, so it stays float32."""

    def __init__(self, n_in: int, hidden: int):
        super().__init__()
        self.hidden = hidden
        self.register_buffer("wi", torch.zeros((n_in, 4 * hidden), dtype=torch.float64))
        self.register_buffer("wh", torch.zeros((hidden, 4 * hidden)))
        self.register_buffer("bh", torch.zeros(4 * hidden))

    def forward(self, seq: torch.Tensor, carry, reverse: bool = False):
        """seq (B, T, In), carry (c, h) each (B, H) -> (outputs (B, T, H),
        the carry after the last frame processed)."""
        H = self.hidden
        xi = _mm(seq, self.wi)  # every frame's input projections at once
        c, h = carry
        outs = [None] * seq.shape[1]
        for t in (reversed(range(seq.shape[1])) if reverse else range(seq.shape[1])):
            z = torch.addmm(self.bh, h, self.wh) + xi[:, t]
            gates = torch.sigmoid(z)
            g = torch.tanh(z[:, 2 * H:3 * H])
            c = gates[:, H:2 * H] * c + gates[:, :H] * g
            h = gates[:, 3 * H:] * torch.tanh(c)
            outs[t] = h
        return torch.stack(outs, dim=1), (c, h)


class CRNMaskNet(nn.Module):
    """(B, F, T, 2) logmag_ipd features -> (B, F, T) mask for F =
    ``n_freqs`` (padded to a multiple of 8 inside). ``unidirectional=False`` is the reference's
    bidirectional form (a reversed LSTM beside each forward one, their
    outputs concatenated); it cannot stream."""

    def __init__(self, base: int = 16, hidden: int = 128, n_lstm: int = 2,
                 unidirectional: bool = True, n_freqs: int = 513):
        super().__init__()
        self.base, self.hidden, self.n_lstm = base, hidden, n_lstm
        self.unidirectional = unidirectional
        self.n_freqs = n_freqs
        self.rows = (n_freqs + (-n_freqs) % 8) // 8  # F / 8 after padding
        self.down = nn.ModuleList([
            _FreqConv(2, base, False), _FreqConv(base, 2 * base, False),
            _FreqConv(2 * base, 4 * base, False)])
        flat = self.rows * 4 * base
        self.register_buffer("w_in", torch.zeros((flat, hidden), dtype=torch.float64))
        self.register_buffer("b_in", torch.zeros(hidden))
        width = hidden if unidirectional else 2 * hidden
        self.fwd = nn.ModuleList(
            [_LSTM(hidden if i == 0 else width, hidden) for i in range(n_lstm)])
        self.bwd = nn.ModuleList(
            [] if unidirectional else [_LSTM(hidden if i == 0 else width, hidden)
                                       for i in range(n_lstm)])
        self.register_buffer("w_out", torch.zeros((width, flat), dtype=torch.float64))
        self.register_buffer("b_out", torch.zeros(flat))
        self.up = nn.ModuleList([
            _FreqConv(8 * base, 2 * base, True), _FreqConv(4 * base, base, True),
            _FreqConv(2 * base, base, True)])
        self.register_buffer("w_head", torch.zeros((base, 1), dtype=torch.float64))
        self.register_buffer("b_head", torch.zeros(1))

    def initial_carries(self, batch: int = 1):
        """Zero LSTM carries, (c, h) per layer, each (batch, hidden), on the
        net's device: the state of a fresh stream."""
        dev = self.w_in.device
        return tuple((torch.zeros((batch, self.hidden), device=dev),
                      torch.zeros((batch, self.hidden), device=dev)) for _ in range(self.n_lstm))

    def forward(self, x: torch.Tensor, carries=None, return_carries: bool = False):
        """x (B, F, T, 2) -> mask (B, F, T), and the carries after the last
        frame when ``return_carries`` (an empty tuple without ``carries``,
        as in the reference)."""
        if carries is not None and not self.unidirectional:
            raise ValueError("streaming carries require unidirectional=True")
        B, F, T, _ = x.shape
        if F != self.n_freqs:
            raise ValueError(f"the net was built for {self.n_freqs} bins, got {F}")
        h = nn.functional.pad(x.to(torch.float32), (0, 0, 0, 0, 0, (-F) % 8))
        e1 = self.down[0](h)
        e2 = self.down[1](e1)
        e3 = self.down[2](e2)
        _, Fr, Tr, Cr = e3.shape
        seq = e3.transpose(1, 2).reshape(B, Tr, Fr * Cr)
        seq = _mm(seq, self.w_in) + self.b_in
        start = carries if carries is not None else self.initial_carries(B)
        out_carries = []
        for i in range(self.n_lstm):
            fwd, carry = self.fwd[i](seq, start[i])
            if carries is not None:
                out_carries.append(carry)
            if self.unidirectional:
                seq = fwd
            else:
                zero = self.initial_carries(B)[0]
                bwd, _ = self.bwd[i](seq, zero, reverse=True)
                seq = torch.cat([fwd, bwd], dim=-1)
        seq = _mm(seq, self.w_out) + self.b_out
        bott = seq.reshape(B, Tr, Fr, Cr).transpose(1, 2)
        u3 = self.up[0](torch.cat([bott, e3], dim=-1))
        u2 = self.up[1](torch.cat([u3, e2], dim=-1))
        u1 = self.up[2](torch.cat([u2, e1], dim=-1))
        out = _mm(u1, self.w_head) + self.b_head
        mask = torch.sigmoid(out[:, :F, :, 0])
        if return_carries:
            return mask, tuple(out_carries)
        return mask
