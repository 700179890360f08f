"""AudioZoom, the product-level facade (counterpart of azoom.zoom_api).

One object ties the pipeline to a camera UI: set the zoom state (look
direction, field of view, zoom level), then feed audio, whole clips or a
live stream. The zoom level sets the diagonal loading (beam.zoom), the field
of view gates the localization (localize.srp), and the direction steers.
Enhancement is the blind autosteer pipeline, optionally with the bundled
int8 mask net: the camera's field of view picks the region, the DOA
histogram refines the bearing inside it, the net gives the mask.

Two latency modes, both ported:

  * ``latency="high"`` (the default): 2 s windows with 50 % Hann
    overlap-add, the reference's execution model; push() output emerges one
    hop (1 s) behind the input. Every bundled conv mask net, int8 or float,
    whole-clip tracking of clips longer than a window (pipelines.tracked),
    the causal and momentum streaming trackers, the HRNR post-filter
    (``harmonic_regen``), ``pipelined`` pushes and the ``mask_reuse``
    one-slot server.
  * ``latency="low"``: hop-granularity causal streaming (the crn_causal mask
    net and the recursive online MVDR, stream.lowlat): 32-64 ms of
    algorithmic latency; ``track=True`` retargets the stream once a second.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from azoom_torch.beam.zoom import zoom_to_sigma
from azoom_torch.config import PipelineConfig, resolve_device
from azoom_torch.dsp.stft import _check_precision, stft
from azoom_torch.localize import tracking
from azoom_torch.localize.srp import ipd_angle_histogram
from azoom_torch.models.crn import CRNMaskNet
from azoom_torch.models.pretrained import geo_adapt_dist, load_bundled
from azoom_torch.pipelines.autosteer import autosteer_enhance
from azoom_torch.pipelines.learned import learned_enhance
from azoom_torch.pipelines.online_learned import online_learned_enhance
from azoom_torch.pipelines.tracked import steered_heuristic_enhance, tracked_autosteer_enhance
from azoom_torch.stream.lowlat import OnlineEnhancer
from azoom_torch.stream.server import AudioZoomServer, _MomentumBank

__all__ = ["AudioZoom"]


def _to_numpy(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@dataclasses.dataclass
class AudioZoom:
    """High-level audio-zoom processor.

    Args:
      cfg: physics and STFT configuration.
      direction_deg: where the camera looks (the center of the steering).
      fov_deg: the visual field of view (the localization gate's width).
      zoom: UI zoom level in [0, 1] (0 = wide, 1 = narrowest beam), mapped
        to the diagonal loading.
      enhance_fn: optional override (M, win) -> (win,) of the window step.
      model: optional bundled mask net (any name of models.pretrained); its
        feature kind goes with it. The causal 'crn_causal' runs the
        low-latency pipeline (pipelines.online_learned) on each window.
      int8: serve the int8 net; False (the default, as in the reference)
        serves the float net of the same checkpoint.
      autosteer: with a model, refine the bearing by the DOA histogram inside
        the field of view before steering the net; False steers exactly at
        ``direction_deg`` (the FOV still gates the noise covariance).
      track: follow a moving talker. Whole-clip enhance() of a clip longer
        than a window chunks it and steers every chunk at its bearing on
        the Viterbi MAP track (pipelines.tracked); streaming push() runs a
        forward-Viterbi bearing filter per window, its scores carried
        across windows (camera aiming prior on the first).
      tracker: 'causal' (position-only) or 'momentum' (direction state,
        which keeps identity through a crossing talker); enhance() of a long
        clip runs the offline form of either ('viterbi' or 'momentum').
      latency: 'high' (2 s windows, best quality) or 'low' (hop-level causal
        streaming, 32-64 ms; needs a causal model, 'crn_causal' when none is
        given). With ``track`` at low latency the bearing filter advances
        once per second of received audio and retargets the stream, whose
        output latency stays one hop; enhance() runs the causal pipeline on
        the whole clip.
      native: accepted; push() buffers in NumPy either way (the reference's
        own path without its C++ engine, with the same output) until
        azoom/stream/native.py is ported.
      pipelined: push() starts window N on the device and returns window
        N-1's finished result, so the device's compute overlaps the time
        between pushes; one extra hop of output latency, and a failure
        surfaces one window late. flush() drains it.
      dsp_precision: 'exact' or 'fast', checked; it selects nothing here (in
        the reference it picks the TPU's matmul-DFT precision).
      harmonic_regen: the HRNR stage-2 post-filter (beam.postfilter) on the
        learned paths that steer one window: autosteer, exact steering and
        the streaming tracker; the heuristic paths and whole-clip tracking
        ignore it, as in the reference.
      mask_reuse: streaming push() through a one-slot AudioZoomServer with
        frame-aligned mask reuse (needs a model and cfg.win_size // 2 a
        multiple of cfg.hop, e.g. win_size=32768); ``track`` composes,
        ``enhance_fn`` and ``pipelined`` do not. enhance() is unaffected.
        The server's path drops ``autosteer`` and ``harmonic_regen``: a
        defect of the reference (azoom/zoom_api.py), kept on purpose so that
        the two give the same output (ROADMAP.md Queue C).
      device: None for CUDA (raises without a card), or "cpu" for the plain
        PyTorch path.
    """

    cfg: PipelineConfig = PipelineConfig(mic_dist=0.04)
    direction_deg: float = 90.0
    fov_deg: float = 60.0
    zoom: float = 0.5
    enhance_fn: Callable | None = None
    model: str | None = None
    int8: bool = False
    autosteer: bool = True
    track: bool = False
    tracker: str = "causal"
    latency: str = "high"
    native: bool = True
    pipelined: bool = False
    dsp_precision: str = "exact"
    harmonic_regen: bool = False
    mask_reuse: bool = False
    device: str | None = None

    def __post_init__(self):
        if self.latency not in ("high", "low"):
            raise ValueError(f"latency must be 'high' or 'low', got {self.latency!r}")
        if self.tracker not in ("causal", "momentum"):
            raise ValueError(f"tracker must be 'causal' or 'momentum', got {self.tracker!r}")
        _check_precision(self.dsp_precision)
        if self.latency == "low" and self.model is None:
            self.model = "crn_causal"
        self._device = resolve_device(self.device)
        self._mask_net = None
        self._feats = None  # the net's feature kind
        self._train_mic_dist = None
        if self.model is not None:
            self._mask_net, self._feats = load_bundled(self.model, quant=self.int8,
                                                       device=self._device)
            self._train_mic_dist = geo_adapt_dist(self.model, self.cfg.mic_dist)
        causal = isinstance(self._mask_net, CRNMaskNet)
        if self.latency == "low" and not causal:
            raise ValueError(f"latency='low' needs a causal streaming model (e.g. 'crn_causal'); "
                             f"{self.model!r} cannot stream")
        if self.mask_reuse:
            if self.latency != "high" or self.model is None:
                raise ValueError("mask_reuse needs latency='high' and a mask net")
            if causal:
                raise ValueError("mask_reuse applies to windowed (non-causal) nets; "
                                 f"{self.model!r} already streams per-frame")
            if self.enhance_fn is not None or self.pipelined:
                raise ValueError(
                    "mask_reuse is the server streaming path: it does not compose with "
                    "enhance_fn or pipelined")
        self._reset_stream()

    # -- zoom state ---------------------------------------------------------

    def set_zoom(self, direction_deg=None, fov_deg=None, zoom=None) -> None:
        if direction_deg is not None:
            self.direction_deg = float(direction_deg)
            if self._online is not None:
                self._online.set_direction(self.direction_deg)
        if fov_deg is not None:
            self.fov_deg = float(fov_deg)
        if zoom is not None:
            self.zoom = float(np.clip(zoom, 0.0, 1.0))
            if self._online is not None:  # the loading, from the stream's next hop on
                self._online.set_sigma(self.sigma)
        if self._srv is not None:
            self._srv.set_zoom(0, direction_deg=direction_deg, zoom=zoom, fov_deg=fov_deg)

    @property
    def sigma(self) -> float:
        return float(zoom_to_sigma(self.zoom))

    def _zoom_cfg(self) -> PipelineConfig:
        return self.cfg.replace(sigma=self.sigma, angle_target_deg=self.direction_deg)

    # -- streaming bearing trackers ------------------------------------------

    def _update_track(self, window: torch.Tensor, cfg: PipelineConfig) -> float:
        """One forward-Viterbi filtering step of the bearing on this window's
        DOA histogram (FOV-gated log emissions), the scores carried across
        push() windows: the trellis step of localize.tracking on the host.
        The emissions are NumPy's float32 log, as the reference facade takes
        them (torch's log differs from it in the last bit on some inputs).
        The momentum tracker is the server's filter with one slot."""
        with torch.inference_mode():
            Y = stft(window, cfg.n_fft, cfg.hop)
            angles, hist = ipd_angle_histogram(Y, cfg.mic_dist, cfg.fs, c=cfg.c)
        angles, hist = angles.cpu().numpy(), hist.cpu().numpy()
        if self.tracker == "momentum":
            if self._momentum is None:
                self._momentum = _MomentumBank(1, angles)
            theta = self._momentum.update(hist[None], np.float32([self.direction_deg]),
                                          np.float32([self.fov_deg]), np.ones(1, bool))
            self._track_theta = float(theta[0])
            return self._track_theta
        p = np.maximum(hist, 0.0)
        p = p / (p.sum() + 1e-20)
        emis = np.log(p + 1e-6)
        gate = np.abs(angles - self.direction_deg) <= self.fov_deg / 2.0
        emis = np.where(gate, emis, -1e9)
        if self._track_scores is None:
            # First window: the camera's aiming prior (autosteer's scale).
            sigma_p = self.fov_deg / 5.0
            scores = emis - 0.5 * ((angles - self.direction_deg) / sigma_p) ** 2
        else:
            a = torch.from_numpy(angles)
            scores = tracking.viterbi_step(
                torch.from_numpy(self._track_scores),
                tracking.transition(a, 12.0),  # deg per window hop
                torch.from_numpy(emis))[0].numpy()
        self._track_scores = scores - scores.max()
        self._track_theta = float(angles[np.argmax(scores)])
        return self._track_theta

    # -- one window ---------------------------------------------------------

    def _enhance_window(self, window: torch.Tensor) -> torch.Tensor:
        cfg = self._zoom_cfg()
        if self.enhance_fn is not None:
            return self.enhance_fn(window)
        net = self._mask_net
        causal = isinstance(net, CRNMaskNet)
        if self.track and not causal:
            # The bearing goes in as a tensor: steered as the reference's
            # traced bearing is (the steer-align rotation always applies).
            theta = torch.tensor(self._update_track(window, cfg), dtype=torch.float32,
                                 device=window.device)
            if net is None:
                return steered_heuristic_enhance(window, cfg, theta)
            return learned_enhance(window, net, cfg, feature_kind=self._feats, steer_deg=theta,
                                   fov_deg=float(self.fov_deg),
                                   train_mic_dist=self._train_mic_dist,
                                   harmonic_regen=self.harmonic_regen)
        if net is None:
            return autosteer_enhance(window, cfg, fov_center_deg=self.direction_deg,
                                     fov_width_deg=self.fov_deg)[0]
        if causal:  # the causal pipeline, steered exactly (no autosteer, no FOV gate)
            return online_learned_enhance(window, net, cfg)
        if self.autosteer:
            # camera field of view -> DOA-refined bearing -> learned mask
            return autosteer_enhance(
                window, cfg, fov_center_deg=self.direction_deg, fov_width_deg=self.fov_deg,
                model=net, feature_kind=self._feats, fov_gate=True,
                train_mic_dist=self._train_mic_dist, harmonic_regen=self.harmonic_regen)[0]
        # exact steering; the field of view still gates the noise covariance
        return learned_enhance(window, net, cfg, feature_kind=self._feats,
                               fov_deg=float(self.fov_deg), train_mic_dist=self._train_mic_dist,
                               harmonic_regen=self.harmonic_regen)

    # -- whole clip ---------------------------------------------------------

    def _as_input(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x, np.float32)).to(self._device)

    def enhance(self, mixture) -> np.ndarray:
        """Whole-clip enhancement: (M, n) -> (n,) numpy. With ``track`` a
        clip longer than a window is chunked and every chunk steered at its
        own bearing on the offline track (the moving-talker path,
        pipelines.tracked); otherwise one window of the clip's length."""
        x = self._as_input(mixture)
        if (self.track and self.enhance_fn is None and self.latency == "high"
                and x.shape[-1] > self.cfg.win_size):
            kw = {} if self._mask_net is None else dict(
                model=self._mask_net, feature_kind=self._feats,
                train_mic_dist=self._train_mic_dist)
            out, _ = tracked_autosteer_enhance(
                x, self._zoom_cfg(), fov_center_deg=self.direction_deg,
                fov_width_deg=float(self.fov_deg),
                tracker="momentum" if self.tracker == "momentum" else "viterbi",
                dsp_precision=self.dsp_precision, **kw)
            return _to_numpy(out)
        return _to_numpy(self._enhance_window(x))

    # -- live streaming -----------------------------------------------------

    def _reset_stream(self):
        self._track_theta = None  # tracked bearing
        self._track_scores = None  # the causal tracker's forward-Viterbi scores
        self._momentum = None  # the momentum tracker (built on the first window)
        self._srv = None
        self._online = None
        if self.latency == "low":
            self._online = OnlineEnhancer(self._zoom_cfg(), self._mask_net,
                                          steer_deg=self.direction_deg, device=self._device)
            # With track: the bearing filter steps on each full second of
            # received audio (the 2 s / 50 % path's cadence, so its motion
            # model carries over) and retargets the stream.
            self._track_buf = np.zeros((self.cfg.n_mics, 0), np.float32)
            return
        if self.mask_reuse:
            # One slot: device-resident window, overlap-add and masks,
            # frame-aligned mask reuse, this stream's steer, zoom and tracking.
            self._srv = AudioZoomServer(
                1, cfg=self.cfg, model=self.model, int8=self.int8,
                dsp_precision=self.dsp_precision, mask_reuse=True, track=self.track,
                fov_deg=self.fov_deg, device=self._device)
            self._srv.set_zoom(0, direction_deg=self.direction_deg, zoom=self.zoom,
                               fov_deg=self.fov_deg)
            return
        self._win = self.cfg.win_size
        self._hop = self._win // 2
        self._inbuf = np.zeros((self.cfg.n_mics, 0), np.float32)
        self._pipe_pending = None  # the last window's result, on its way to the host
        self._tail = np.zeros(self._hop, np.float32)
        self._started = False
        # Finished hops not yet returned: kept on the object, so a failure on
        # a later window of the same push loses none of them.
        self._out_pending: list[np.ndarray] = []
        w = np.hanning(self._win + 1)[:-1].astype(np.float32)
        self._window = w
        # 50 % Hann overlap-add divided by its exact pairwise sum: gain 1.
        self._ola_norm = np.maximum(w[:self._hop] + w[self._hop:], 1e-6)

    def reset(self) -> None:
        """Drop all stream state (e.g. on seek)."""
        self._track_theta = None
        self._track_scores = None
        self._momentum = None
        if self._srv is not None:
            self._srv.reset()
            return
        if self._online is not None:
            self._online.reset()
            self._track_buf = np.zeros((self.cfg.n_mics, 0), np.float32)
            return
        self._reset_stream()

    @staticmethod
    def _start_fetch(t):
        """Start the copy of a window's result to the host: pinned memory and
        an event on CUDA, so a later push can wait for this window alone."""
        if not (isinstance(t, torch.Tensor) and t.device.type == "cuda"):
            return t, None
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done

    @staticmethod
    def _finish_fetch(pending) -> np.ndarray:
        host, done = pending
        if done is not None:
            done.synchronize()
        return _to_numpy(host)

    def push(self, samples) -> np.ndarray:
        """Feed (M, k) new samples; returns the enhanced audio that is ready
        (a multiple of the hop, possibly empty). Output sample 0 corresponds
        to input sample win_size // 2 (the one-hop overlap-add warm-up). If
        the enhancer raises, no audio is lost: finished hops come back with
        the next push, and the failed window is processed again. At
        ``latency="low"`` the hop is one STFT hop (32 ms) and output sample
        0 is input sample 0."""
        samples = np.asarray(samples, np.float32)
        if self._srv is not None:
            return self._srv.push(samples[None])[0]
        if self._online is not None:
            if self.track:
                # Strictly causal: every histogram sample is audio already received.
                buf = np.concatenate([self._track_buf, samples], axis=1)
                w = int(self.cfg.fs)
                while buf.shape[1] >= w:
                    self._online.set_direction(
                        self._update_track(self._as_input(buf[:, :w]), self._zoom_cfg()))
                    buf = buf[:, w:]
                self._track_buf = buf
            return self._online.push(samples)
        out = self._out_pending
        self._inbuf = np.concatenate([self._inbuf, samples], axis=1)
        while self._inbuf.shape[1] >= self._win:
            dev = self._enhance_window(self._as_input(self._inbuf[:, :self._win]))
            if self.pipelined:
                # Window N is queued on the device; window N-1, queued a push
                # earlier, is finished or nearly so.
                pending, self._pipe_pending = self._pipe_pending, self._start_fetch(dev)
                self._inbuf = self._inbuf[:, self._hop:]
                if pending is not None:
                    self._ola_finalize(self._finish_fetch(pending), out)
            else:
                self._ola_finalize(_to_numpy(dev), out)
                self._inbuf = self._inbuf[:, self._hop:]
        self._out_pending = []
        return np.concatenate(out) if out else np.zeros(0, np.float32)

    def _ola_finalize(self, enhanced: np.ndarray, out: list) -> None:
        weighted = enhanced * self._window
        head = weighted[:self._hop]
        if self._started:
            out.append((self._tail + head) / self._ola_norm)
        self._tail = weighted[self._hop:]
        self._started = True

    def flush(self) -> np.ndarray:
        """Drain a pipelined stream: finish the window in flight. Empty
        otherwise."""
        if getattr(self, "_pipe_pending", None) is None:
            return np.zeros(0, np.float32)
        out: list[np.ndarray] = []
        pending, self._pipe_pending = self._pipe_pending, None
        self._ola_finalize(self._finish_fetch(pending), out)
        return np.concatenate(out) if out else np.zeros(0, np.float32)
