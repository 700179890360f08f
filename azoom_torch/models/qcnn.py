"""Quaternion-CNN mask estimator (counterpart of azoom.models.qcnn).

The physics features [log|Y0|, sin IPD, cos IPD, freq] are one quaternion
per bin. A quaternion conv mixes channels through the Hamilton product,
which is linear in the input: it is one real conv whose (4 Ci, 4 Co) kernel
has the 4 x 4 Hamilton block structure, assembled from the four free kernels
(wr, wx, wy, wz) as the reference does (channels interleaved: quaternion q
at real channels 4q .. 4q + 3), then one SAME conv (im2col and one float32
product, ``models.layers``). BatchNorm is per real channel; the time
upsampling is a nearest repeat and a (1, 3) quaternion conv; the head one
real 1x1 conv. Init: ``variance_scaling(0.25, fan_in, truncated_normal)``.

One module serves and trains, as ``models.blstm``: ``eval()`` runs its
BatchNorms on the running statistics (the reference serves it in float).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from azoom_torch.models.layers import (
    BatchNorm, Conv, FlaxTree, conv_same, pool_time, truncated_normal_,
)
from azoom_torch.models.trainable import TrainableNet

__all__ = ["QuaternionConv", "QCNNMaskNet"]


class QuaternionConv(nn.Module):
    """(B, F, T, 4 Ci) -> (B, F, T, 4 Co); ``features`` = Co counts
    quaternion channels. Weights follow the left Hamilton product w (x) q."""

    def __init__(self, ci: int, features: int, kernel: tuple[int, int] = (3, 3),
                 use_bias: bool = True):
        super().__init__()
        kh, kw = kernel
        self.ci, self.co = ci, features
        for name in ("wr", "wx", "wy", "wz"):
            self.register_parameter(name, nn.Parameter(torch.zeros(kh, kw, ci, features)))
        self.bias = nn.Parameter(torch.zeros(4 * features)) if use_bias else None

    def reset(self, g) -> None:
        kh, kw, ci, _ = self.wr.shape
        for w in (self.wr, self.wx, self.wy, self.wz):
            truncated_normal_(w, g, math.sqrt(0.25 / (kh * kw * ci)))
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()

    def hamilton_kernel(self) -> torch.Tensor:
        """The (kh, kw, 4 Ci, 4 Co) real kernel: row a, column b of each
        4 x 4 block multiplies input component a into output component b."""
        wr, wx, wy, wz = self.wr, self.wx, self.wy, self.wz
        rows = ((wr, wx, wy, wz), (-wx, wr, wz, -wy), (-wy, -wz, wr, wx), (-wz, wy, -wx, wr))
        blocks = torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)
        kh, kw = wr.shape[:2]
        return blocks.permute(0, 1, 2, 4, 3, 5).reshape(kh, kw, 4 * self.ci, 4 * self.co)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[-1] % 4:
            raise ValueError(f"quaternion input needs 4k channels, got {x.shape[-1]}")
        y = conv_same(x.to(self.wr.dtype), self.hamilton_kernel())
        return y if self.bias is None else y + self.bias


class _QDoubleConv(FlaxTree):
    def __init__(self, ci: int, features: int):
        super().__init__()
        self.QuaternionConv_0 = QuaternionConv(ci, features)
        self.BatchNorm_0 = BatchNorm(4 * features)
        self.QuaternionConv_1 = QuaternionConv(features, features)
        self.BatchNorm_1 = BatchNorm(4 * features)

    def forward(self, x):
        x = torch.relu(self.BatchNorm_0(self.QuaternionConv_0(x)))
        return torch.relu(self.BatchNorm_1(self.QuaternionConv_1(x)))


class QCNNMaskNet(TrainableNet):
    """Quaternion frequency-preserving U-Net -> sigmoid mask: (B, F, T, 4)
    physics features with T % 8 == 0 -> (B, F, T). ``base`` counts
    quaternion channels."""

    def __init__(self, base: int = 8):
        super().__init__()
        self.base = base

    def _build(self, n_freqs, C):
        if C != 4:
            raise ValueError("QCNNMaskNet reads the 4-channel physics features "
                             f"(one quaternion per bin); got C={C}")
        b = self.base
        self._QDoubleConv_0 = _QDoubleConv(1, b)
        self._QDoubleConv_1 = _QDoubleConv(b, 2 * b)
        self._QDoubleConv_2 = _QDoubleConv(2 * b, 4 * b)
        self._QDoubleConv_3 = _QDoubleConv(4 * b, 8 * b)
        self.QuaternionConv_0 = QuaternionConv(8 * b, 4 * b, (1, 3))
        self._QDoubleConv_4 = _QDoubleConv(8 * b, 4 * b)
        self.QuaternionConv_1 = QuaternionConv(4 * b, 2 * b, (1, 3))
        self._QDoubleConv_5 = _QDoubleConv(4 * b, 2 * b)
        self.QuaternionConv_2 = QuaternionConv(2 * b, b, (1, 3))
        self._QDoubleConv_6 = _QDoubleConv(2 * b, b)
        self.Conv_0 = Conv(4 * b, 1, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[-1] != 4:
            raise ValueError("QCNNMaskNet reads the 4-channel physics features "
                             f"(one quaternion per bin); got C={x.shape[-1]}")
        up = lambda h, conv: conv(torch.repeat_interleave(h, 2, dim=-2))  # noqa: E731
        x = x.to(self.dtype)
        e1 = self._QDoubleConv_0(x)
        e2 = self._QDoubleConv_1(pool_time(e1))
        e3 = self._QDoubleConv_2(pool_time(e2))
        b = self._QDoubleConv_3(pool_time(e3))
        d3 = self._QDoubleConv_4(torch.cat([up(b, self.QuaternionConv_0), e3], -1))
        d2 = self._QDoubleConv_5(torch.cat([up(d3, self.QuaternionConv_1), e2], -1))
        d1 = self._QDoubleConv_6(torch.cat([up(d2, self.QuaternionConv_2), e1], -1))
        return torch.sigmoid(self.Conv_0(d1))[..., 0]
