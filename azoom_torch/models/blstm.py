"""Bi-LSTM mask estimator (counterpart of azoom.models.blstm.BLSTMMaskNet).

(B, F, T, C) features -> (B, F, T) mask: each frame's F x C features are
layer-normed (flax eps 1e-6), projected to ``hidden`` and squashed by tanh,
``n_layers`` LSTM layers (flax ``OptimizedLSTMCell``; a reversed one beside
each unless ``unidirectional``, its outputs kept in frame order) each
followed by a dense layer and tanh, and a dense head of F lanes and a sigmoid.

One module serves and trains: it holds ``nn.Parameter``s in the flax tree's
names and layout (``models.layers``; the net has no BatchNorm, so its
``eval()`` forward is its training forward), built at its first input shape
like the trainable twins of ``models.trainable``.
"""

from __future__ import annotations

import torch

from azoom_torch.models.layers import Dense, LayerNorm, LSTMCell
from azoom_torch.models.trainable import TrainableNet, _Levels

__all__ = ["BLSTMMaskNet"]


class BLSTMMaskNet(TrainableNet):
    """(B, F, T, C) features -> (B, F, T) mask."""

    def __init__(self, hidden: int = 256, n_layers: int = 2, unidirectional: bool = False):
        super().__init__()
        self.hidden, self.n_layers, self.unidirectional = hidden, n_layers, unidirectional

    def _build(self, n_freqs, C):
        H = self.hidden
        width = H if self.unidirectional else 2 * H
        self.LayerNorm_0 = LayerNorm(n_freqs * C)
        lv = _Levels(self)
        lv.add("Dense", Dense(n_freqs * C, H))
        self.layers = []
        for _ in range(self.n_layers):
            fwd = lv.add("OptimizedLSTMCell", LSTMCell(H, H))
            bwd = None if self.unidirectional else lv.add("OptimizedLSTMCell", LSTMCell(H, H))
            self.layers.append((fwd, bwd, lv.add("Dense", Dense(width, H))))
        self.head = lv.add("Dense", Dense(H, n_freqs))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, F, T, C = x.shape
        h = x.to(self.dtype).transpose(1, 2).reshape(B, T, F * C)
        h = torch.tanh(self.Dense_0(self.LayerNorm_0(h)))
        for fwd, bwd, dense in self.layers:
            f, _ = getattr(self, fwd).scan(h)
            h = f if bwd is None else torch.cat([f, getattr(self, bwd).scan(h, reverse=True)[0]], -1)
            h = torch.tanh(getattr(self, dense)(h))
        return torch.sigmoid(getattr(self, self.head)(h).transpose(1, 2))
