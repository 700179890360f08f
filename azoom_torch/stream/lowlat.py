"""Hop-granularity streaming enhancement, the low-latency product path
(counterpart of azoom.stream.lowlat).

The 2 s / 50 % path finalizes a sample about a second after capture.
:class:`OnlineEnhancer` runs the causal pipeline of
pipelines.online_learned (the CRN mask net and the online MVDR) with its
state, one STFT hop at a time: every ``hop`` new samples give one frame and
finalize one hop of output, so the algorithmic latency lies between one hop
and one window (32-64 ms at 1024 / 512 at 16 kHz).

Exactness: the CRN's convs have time kernel 1, so its only time state is
the LSTM carries, handed from hop to hop; the MVDR's state (R_sum, w_sum)
is carried by the ``online_mvdr`` kernel itself. A hop's frame is analysed
and synthesised by the frame transforms of dsp.stft (float64 inside,
rounded once), so the stream equals the port's offline
:func:`azoom_torch.pipelines.online_learned.online_learned_enhance` on the
finalized samples to float tolerance (tests/test_torch_lowlat.py).

Per hop on the device: the frame's rfft, the steer-align rotation and the
features, the CRN at T = 1, ONE ``online_mvdr`` launch (T = 1), the frame's
irfft and a one-hop overlap-add. The samples of a push go to the device in
one copy, and its finalized hops come back in one fetch.
"""

from __future__ import annotations

import numpy as np
import torch

from azoom_torch.config import PipelineConfig, resolve_device
from azoom_torch.dsp.delays import steer_rotate, steering_vector
from azoom_torch.dsp.stft import analysis_frames, rfft_freqs, synthesis_frames
from azoom_torch.dsp.windows import hann
from azoom_torch.kernels.online_mvdr_kernel import initial_state, online_mvdr
from azoom_torch.masks.features import logmag_ipd_features

__all__ = ["OnlineEnhancer"]


class OnlineEnhancer:
    """Stateful hop-by-hop enhancer: feed sample blocks of any size, get the
    finalized enhanced audio back one to two hops later.

    Args:
      cfg: physics and STFT configuration (50 % overlap: n_fft == 2 * hop).
      model: a causal mask net that streams with carries
        (CRNMaskNet(unidirectional=True)), on ``device``.
      steer_deg: look direction; :meth:`set_direction` changes it between
        pushes.
      forget, mask_floor: the covariance's forgetting factor and the
        post-filter gain's floor.
      sigma: diagonal loading (the zoom knob), cfg.sigma by default;
        :meth:`set_sigma` changes it between pushes.
      steer_align: rotate each frame by conj(d) before the features, as
        online_learned_enhance does.
      device: None for CUDA (raises without a card), or "cpu".
    """

    def __init__(self, cfg: PipelineConfig, model, steer_deg: float = 90.0, forget: float = 0.98,
                 mask_floor: float = 0.05, sigma: float | None = None, steer_align: bool = True,
                 device=None):
        if cfg.n_fft != 2 * cfg.hop:
            raise ValueError("low-latency streaming requires 50% overlap (n_fft == 2*hop)")
        if cfg.n_mics != 2:
            raise NotImplementedError(
                "the online MVDR at M > 2 needs the unrolled-Cholesky solve of "
                "azoom/beam/linalgmm.py, queued in ROADMAP.md Queue A item 3")
        self.device = resolve_device(device)
        if model.w_in.device.type != self.device.type:
            raise ValueError(f"the model is on {model.w_in.device}, the stream on {self.device}")
        self.cfg = cfg
        self.steer_deg = float(steer_deg)
        self.sigma = float(cfg.sigma if sigma is None else sigma)
        self.forget, self.mask_floor, self.steer_align = forget, mask_floor, steer_align
        self._model = model
        self._hop, self._n_fft = cfg.hop, cfg.n_fft
        dev = self.device
        self._freqs = rfft_freqs(cfg.n_fft, cfg.fs, device=dev)
        geom = cfg.geometry()
        self._geom = None if geom is None else geom.to(dev)
        win = hann(cfg.n_fft, device=dev, dtype=torch.float64)
        ww = win * win
        self._ola_norm = ww[:cfg.hop] + ww[cfg.hop:]  # as istft's overlap-added window
        self._steer = None  # (bearing, d) of the last hop
        self.reset()

    def reset(self) -> None:
        """Drop all stream state (e.g. on seek)."""
        M, F, dev = self.cfg.n_mics, self.cfg.n_freqs, self.device
        # The last n_fft samples of the extended stream; zeros at the start
        # are the STFT's lead padding (boundary='zeros').
        self._ctx = torch.zeros((M, self._n_fft), dtype=torch.float64, device=dev)
        self._carries = self._model.initial_carries(1)
        self._R, self._w = initial_state((), F, M, dev)
        self._tail = torch.zeros(self._hop, dtype=torch.float64, device=dev)
        self._inbuf = np.zeros((M, 0), np.float32)
        self._frames = 0

    def set_direction(self, steer_deg: float) -> None:
        self.steer_deg = float(steer_deg)

    def set_sigma(self, sigma: float) -> None:
        """Change the diagonal loading (zoom level) from the next hop on."""
        self.sigma = float(sigma)

    @property
    def latency_samples(self) -> int:
        """Worst-case algorithmic latency (one analysis window)."""
        return self._n_fft

    def _steering(self) -> torch.Tensor:
        if self._steer is None or self._steer[0] != self.steer_deg:
            cfg = self.cfg
            self._steer = (self.steer_deg, steering_vector(
                self._freqs, self.steer_deg, cfg.mic_dist, cfg.c, cfg.n_mics,
                positions=self._geom))
        return self._steer[1]

    def _step(self, block: torch.Tensor) -> torch.Tensor:
        """One hop: (M, hop) float64 new samples -> (hop,) float32 finalized."""
        hop = self._hop
        self._ctx = torch.cat([self._ctx[:, hop:], block], dim=1)
        y = analysis_frames(self._ctx)[..., None]  # (M, F, 1)
        d = self._steering()
        y_feat = steer_rotate(y, d) if self.steer_align else y
        mask, self._carries = self._model(logmag_ipd_features(y_feat)[None],
                                          carries=self._carries, return_carries=True)
        tgt = mask[0]  # (F, 1)
        s = online_mvdr(y, 1.0 - tgt, d, self._freqs, self._R, self._w, target_mask=tgt,
                        sigma=self.sigma, hp_cutoff_hz=self.cfg.hp_cutoff_hz,
                        forget=self.forget, mask_floor=self.mask_floor)
        frame = synthesis_frames(s.transpose(0, 1), self._n_fft)[0]  # (n_fft,) float64
        out = (self._tail + frame[:hop]) / self._ola_norm
        self._tail = frame[hop:]
        return out.to(torch.float32)

    def push(self, samples) -> np.ndarray:
        """Feed (M, k) samples; returns the finalized enhanced audio (a
        multiple of the hop, possibly empty)."""
        samples = np.asarray(samples, np.float32)
        self._inbuf = np.concatenate([self._inbuf, samples], axis=1)
        n_hops = self._inbuf.shape[1] // self._hop
        if n_hops == 0:
            return np.zeros(0, np.float32)
        cut = n_hops * self._hop
        up = torch.from_numpy(np.ascontiguousarray(self._inbuf[:, :cut])).to(self.device)
        self._inbuf = self._inbuf[:, cut:]
        up = up.to(torch.float64)
        outs = []
        with torch.inference_mode():
            for k in range(n_hops):
                out = self._step(up[:, k * self._hop:(k + 1) * self._hop])
                # Frame 0 finalizes only the lead padding: drop it.
                if self._frames > 0:
                    outs.append(out)
                self._frames += 1
            if not outs:
                return np.zeros(0, np.float32)
            return torch.cat(outs).cpu().numpy()  # one fetch per push

    def flush(self) -> np.ndarray:
        """Finalize buffered input by zero-padding one window; returns the
        remaining enhanced samples of the pushed audio."""
        n_left = self._inbuf.shape[1]
        pad = self._n_fft + (-n_left % self._hop)
        out = self.push(np.zeros((self.cfg.n_mics, pad), np.float32))
        keep = n_left + self._hop  # the hops still covering real input
        return out[:keep] if keep < out.shape[0] else out
