"""Batched live serving: S concurrent streams, one batched step per tick
(counterpart of azoom.stream.server).

``AudioZoomServer`` holds S synchronized stream states; a tick takes one
hop of new samples from every stream and runs STFT -> steer-aligned mask
net -> masked MVDR -> iSTFT -> overlap-add for all of them at once. On CUDA
the mask net's int8 convs are launches of the int8 conv kernel (21 for
the TPUFPU nets; a float net's convs are float32 matrix products), its
upsamplings launches of the upsampling kernel, and the beamformer ONE
launch of the fused MVDR kernel with a steering vector and a loading per
stream (2-mic arrays; M > 2 mics, a rectangular array for one, take the
M-mic MVDR of beam.mvdr in torch, as the reference takes XLA).

* **Steer-aligned features**: the STFT is rotated by each stream's
  conjugate steering vector before the features (in complex128, rounded
  once, as ``learned_enhance`` does), so a panned stream shows the net its
  target at broadside.
* **Per-stream direction and zoom**: ``set_zoom`` changes one stream's
  bearing and loading; both ride the same launch.
* **Mask reuse** (``mask_reuse=True``, frame-aligned geometry such as
  win_size = 32768): a window's first frames see audio that the previous
  window already masked, so the net runs on [context + new] = 48 frames,
  not 80, and the previous masks are stitched in for the shared half.
* **Device-resident state and a compact wire**: the rolling window, the
  overlap-add tail and the previous masks stay on the device. A tick
  uploads the hop of new samples and fetches the hop of finished ones
  (with ``wire='int16'`` both as 16-bit PCM), plus the (S, 181) DOA
  histograms when tracking; the bearings and loadings go up only when they
  change. ``bytes_moved`` counts both directions.
* **Per-stream tracking and churn**: ``track=True`` runs a momentum bearing
  filter per stream (host NumPy) on each tick's DOA histograms; the new
  bearing steers the next tick. ``attach``/``detach`` reuse slots within
  the fixed S; a re-attached slot's state is reset inside the next tick.
* **Several devices** (``mesh=``, parallel.mesh): the streams split into
  contiguous groups of S / n, one per mesh position. Each group keeps its
  device state (window, overlap-add tail, previous masks, controls) on its
  device with that device's replica of the net, and runs its own batched
  step (one MVDR launch per group and tick); a tick issues every group's
  step before it fetches any output. The host side stays whole: the input
  buffer, the momentum filters, steer, zoom, field of view, churn and
  ``bytes_moved`` cover all S streams.
"""

from __future__ import annotations

import numpy as np
import torch

from azoom_torch.beam.zoom import zoom_to_sigma
from azoom_torch.config import PipelineConfig, resolve_device
from azoom_torch.dsp.delays import steer_rotate, steering_vector
from azoom_torch.dsp.stft import _check_precision, istft, rfft_freqs, stft
from azoom_torch.kernels.mvdr_kernel import masked_mvdr_any
from azoom_torch.localize.srp import ipd_angle_histogram
from azoom_torch.models.pretrained import geo_adapt_dist, load_bundled
from azoom_torch.parallel.mesh import make_mesh, replicated, shard_ranges
from azoom_torch.pipelines.learned import predict_mask

__all__ = ["AudioZoomServer"]


class _MomentumBank:
    """Momentum bearing filters for S streams on one shared trellis (host
    NumPy; the reference's ``_MomentumBank``): per stream a state of
    direction d in {-1, 0, +1} and bearing theta, one forward-Viterbi step
    per tick. Rate 6 deg a window hop, sigma 3, switch penalty 12, an 8 deg
    aiming prior on a slot's first window."""

    def __init__(self, n_streams: int, angles: np.ndarray):
        self.angles = angles
        dirs = np.array([-1.0, 0.0, 1.0])
        step = angles[None, :] - angles[:, None]  # (A_prev, A_next)
        step_cost = -0.5 * ((step[None] - dirs[:, None, None] * 6.0) / 3.0) ** 2
        switch = -12.0 * np.abs(dirs[:, None] - dirs[None, :])
        trans = switch[:, None, :, None] + step_cost[None].transpose(0, 2, 1, 3)
        A = angles.shape[0]
        self.trans = trans.reshape(3 * A, 3 * A).astype(np.float32)
        self.scores = np.zeros((n_streams, 3 * A), np.float32)
        self.fresh = np.ones(n_streams, bool)

    def reset(self, slot=None) -> None:
        if slot is None:
            self.fresh[:] = True
        else:
            self.fresh[slot] = True

    def update(self, hist: np.ndarray, center: np.ndarray, fov: np.ndarray,
               active: np.ndarray) -> np.ndarray:
        """One tick for every stream: hist (S, A) angle votes, center and
        fov (S,) each stream's camera gate, active (S,) (an inactive slot
        keeps its center). Returns the per-stream MAP bearing."""
        A = self.angles.shape[0]
        p = np.maximum(hist, 0.0)
        p = p / (p.sum(axis=1, keepdims=True) + 1e-20)
        emis = np.log(p + 1e-6)
        gate = np.abs(self.angles[None, :] - center[:, None]) <= fov[:, None] / 2.0
        emis = np.where(gate, emis, -1e9).astype(np.float32)
        emis_s = np.tile(emis, (1, 3))
        prior = -0.5 * ((self.angles[None, :] - center[:, None]) / 8.0) ** 2
        init = emis_s + np.tile(prior, (1, 3)).astype(np.float32)
        stepd = (self.scores[:, :, None] + self.trans[None]).max(axis=1) + emis_s
        scores = np.where(self.fresh[:, None], init, stepd)
        self.scores = scores - scores.max(axis=1, keepdims=True)
        self.fresh[:] = False
        theta = self.angles[np.argmax(scores, axis=1) % A]
        return np.where(active, theta, center).astype(np.float32)


class _Shard:
    """One mesh position's group of streams ``sl``: its device, its replica of
    the net, its constants and its device state (the rolling window, the
    overlap-add tail, the previous masks, the uploaded controls)."""

    def __init__(self, sl: slice, device: torch.device, model, cfg: PipelineConfig, win: int):
        self.sl, self.device, self.model = sl, device, model
        self.freqs = rfft_freqs(cfg.n_fft, cfg.fs, device=device)
        geom = cfg.geometry()
        self.geom = None if geom is None else geom.to(device)
        hann = torch.from_numpy(np.hanning(win + 1)[:-1].astype(np.float32)).to(device)
        self.hann = hann
        self.ola_norm = torch.clamp(hann[:win // 2] + hann[win // 2:], min=1e-6)
        self.reset()

    def reset(self) -> None:
        self.win = self.tail = self.mask = None
        self.ctrl = None  # (2, streams) float32: bearings, loadings


class AudioZoomServer:
    """S concurrent live audio-zoom streams, one batched step per tick.

    Args:
      n_streams: S, the batch of slots (see attach/detach).
      cfg: the shared physics and STFT configuration (direction and zoom are
        per stream). ``mask_reuse`` needs ``cfg.win_size // 2`` to be a
        multiple of ``cfg.hop`` (win_size = 32768 at the 1024 / 512 STFT).
      model: bundled conv mask net name (its feature kind goes with it);
        int8: serve the int8 net, or with False the float net of the same
        checkpoint.
      dsp_precision: 'exact' or 'fast', checked; it selects nothing here (in
        the reference it picks the TPU's matmul-DFT precision).
      mask_reuse: stitch the previous window's masks over the shared half
        and run the net only on [context + new] frames. A pan updates the
        reused masks one window late; the beamformer re-steers at once.
      reuse_context: net frames recomputed before the new half.
      wire: 'float32' or 'int16'. With 'int16' both legs move 16-bit PCM:
        push() takes int16 PCM or float32 (converted on the host) and
        returns int16 PCM.
      track: per-stream momentum bearing tracking inside each stream's
        camera field of view; the bearing from a tick's audio steers the
        next tick.
      fov_deg: default camera field of view of the tracking gate.
      mesh: a single-axis parallel.mesh.Mesh; the streams split over its
        devices in contiguous groups (S % mesh.size == 0), and ``device`` is
        not used.
      device: None for CUDA (raises without a card), or "cpu" for the plain
        PyTorch path.

    Every stream advances by the same block length per push. Output sample 0
    of a stream corresponds to its input sample win_size // 2 (the
    overlap-add warm-up hop), as in ``AudioZoom.push``.
    """

    def __init__(self, n_streams: int, cfg: PipelineConfig | None = None,
                 model: str = "tpufpu_nano", int8: bool = True,
                 dsp_precision: str = "fast", mask_reuse: bool = False,
                 reuse_context: int = 16, wire: str = "float32",
                 track: bool = False, fov_deg: float = 60.0, mesh=None, device=None):
        _check_precision(dsp_precision)
        if wire not in ("float32", "int16"):
            raise ValueError(f"wire must be 'float32' or 'int16', got {wire!r}")
        self.S = int(n_streams)
        self.cfg = cfg or PipelineConfig(mic_dist=0.04)
        if mesh is not None:
            if len(mesh.axis_names) != 1:
                raise ValueError("mesh must have exactly one axis")
            if self.S % mesh.size != 0:
                raise ValueError(f"n_streams={self.S} not divisible by mesh size {mesh.size}")
        else:
            mesh = make_mesh(devices=[resolve_device(device)])
        self.device = mesh.devices[0]
        self._model, self._fk = load_bundled(model, quant=int8, device=self.device)
        self._wire_i16 = wire == "int16"
        self._track = bool(track)
        self._win = self.cfg.win_size
        self._hop = self._win // 2
        # Explicit geometry: first-pair IPD and that pair's spacing for the
        # geometry adaptation, as learned_enhance.
        self._pair_mode = "mean"
        d_feat = self.cfg.mic_dist
        if self.cfg.mic_positions is not None:
            self._pair_mode = "first"
            p0 = self.cfg.mic_positions[0] + (0.0, 0.0)
            p1 = self.cfg.mic_positions[1] + (0.0, 0.0)
            d_feat = ((p0[0] - p1[0]) ** 2 + (p0[1] - p1[1]) ** 2) ** 0.5
        train_d = geo_adapt_dist(model, d_feat)
        self._ipd_scale = 1.0 if train_d is None else train_d / d_feat

        self._reuse = None
        if mask_reuse:
            if self._hop % self.cfg.hop != 0:
                raise ValueError(
                    f"mask_reuse needs frame-aligned streaming geometry: win_size//2 "
                    f"({self._hop}) must be a multiple of the STFT hop ({self.cfg.hop}), "
                    f"e.g. win_size=32768")
            shift = self._hop // self.cfg.hop
            T = self.cfg.frames_per_chunk
            ctx = int(reuse_context)
            if not 0 < shift + ctx <= T:
                raise ValueError(f"reuse_context={ctx} out of range for T={T}, shift={shift}")
            self._reuse = (shift, ctx)

        nets = replicated(mesh, self._model)
        self._shards = [_Shard(slice(r.start, r.stop), d, nets[d], self.cfg, self._win)
                        for r, d in zip(shard_ranges(self.S, mesh), mesh.devices)]

        self._steer = np.full(self.S, 90.0, np.float32)
        self._center = np.full(self.S, 90.0, np.float32)
        self._fov = np.full(self.S, float(fov_deg), np.float32)
        self._sigma = np.full(self.S, self.cfg.sigma, np.float32)
        self._active = np.ones(self.S, bool)
        self._tracker = None
        if self._track:
            # ipd_angle_histogram's angle grid
            self._tracker = _MomentumBank(self.S, np.linspace(0.0, 180.0, 181).astype(np.float32))
        self.bytes_moved = {"to_device": 0, "to_host": 0}
        self.reset()

    # -- per-stream state ---------------------------------------------------

    def reset(self) -> None:
        """Drop all stream state (all slots)."""
        dt = np.int16 if self._wire_i16 else np.float32
        self._inbuf = np.zeros((self.S, self.cfg.n_mics, 0), dt)
        self._primed = False
        for sh in self._shards:
            sh.reset()
        self._pending_reset = np.zeros(self.S, bool)
        if self._tracker is not None:
            self._tracker.reset()
            self._steer = self._center.copy()

    def set_zoom(self, stream: int, direction_deg: float | None = None,
                 zoom: float | None = None, fov_deg: float | None = None) -> None:
        """One stream's camera state: look direction, zoom level in [0, 1]
        and field of view; takes effect at the next tick."""
        if direction_deg is not None:
            self._center[stream] = float(direction_deg)
            self._steer[stream] = float(direction_deg)
            self._controls_changed()
            if self._tracker is not None:
                self._tracker.reset(stream)  # re-aimed: a fresh prior
        if fov_deg is not None:
            self._fov[stream] = float(fov_deg)
        if zoom is not None:
            self._sigma[stream] = float(zoom_to_sigma(float(zoom)))
            self._controls_changed()

    @property
    def bearings(self) -> np.ndarray:
        """Each stream's current beam bearing (tracked, or its camera's)."""
        return self._steer.copy()

    def attach(self, slot: int | None = None, direction_deg: float = 90.0,
               zoom: float | None = None, fov_deg: float | None = None) -> int:
        """Claim a free slot for a new live stream; its device state is reset
        inside the next tick, and its output ramps in over one window.
        Returns the slot index."""
        if slot is None:
            free = np.flatnonzero(~self._active)
            if free.size == 0:
                raise RuntimeError(f"all {self.S} slots active")
            slot = int(free[0])
        elif self._active[slot]:
            raise RuntimeError(f"slot {slot} already active")
        self._active[slot] = True
        self._pending_reset[slot] = True
        self._inbuf[slot] = 0
        self.set_zoom(slot, direction_deg=direction_deg, zoom=zoom, fov_deg=fov_deg)
        return slot

    def detach(self, slot: int) -> None:
        """Release a slot: its rows flow as silence until it is attached
        again (the batch's shapes never change)."""
        self._active[slot] = False
        self._inbuf[slot] = 0
        if self._tracker is not None:
            self._tracker.reset(slot)

    # -- serving ------------------------------------------------------------

    def _encode_blocks(self, blocks) -> np.ndarray:
        blocks = np.asarray(blocks)
        if self._wire_i16:
            if blocks.dtype != np.int16:
                blocks = np.clip(blocks.astype(np.float32) * 32767.0, -32767, 32767).astype(np.int16)
        else:
            blocks = blocks.astype(np.float32)
        return blocks

    def push(self, blocks) -> np.ndarray:
        """(S, M, k) new samples of every stream -> (S, j * hop) enhanced
        (j >= 0 windows became ready; all streams advance together). int16
        PCM in and out when wire='int16'. Inactive slots' input rows are
        zeroed and their output rows are to be ignored."""
        blocks = self._encode_blocks(blocks)
        if blocks.shape[0] != self.S:
            raise ValueError(f"expected {self.S} streams, got {blocks.shape[0]}")
        if not self._active.all():
            blocks = blocks.copy()
            blocks[~self._active] = 0
        self._inbuf = np.concatenate([self._inbuf, blocks], axis=2)
        outs = []
        while True:
            if not self._primed:
                if self._inbuf.shape[2] < self._win:
                    break
                self._prime(self._inbuf[:, :, :self._win])
                self._inbuf = self._inbuf[:, :, self._win:]
            else:
                if self._inbuf.shape[2] < self._hop:
                    break
                outs.append(self._tick(self._inbuf[:, :, :self._hop]))
                self._inbuf = self._inbuf[:, :, self._hop:]
        if not outs:
            return np.zeros((self.S, 0), np.int16 if self._wire_i16 else np.float32)
        return np.concatenate(outs, axis=1)

    def _controls_changed(self) -> None:
        for sh in self._shards:
            sh.ctrl = None

    def _upload(self, a: np.ndarray, device: torch.device) -> torch.Tensor:
        self.bytes_moved["to_device"] += a.nbytes
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    def _fetch(self, t: torch.Tensor) -> np.ndarray:
        a = t.cpu().numpy()
        self.bytes_moved["to_host"] += a.nbytes
        return a

    def _decode(self, a: np.ndarray, device: torch.device) -> torch.Tensor:
        """Host samples -> float32 on the device; int16 PCM goes up as int16
        and is scaled to [-1, 1) there."""
        x = self._upload(a, device)
        return x.to(torch.float32) * (1.0 / 32768.0) if x.dtype == torch.int16 else x

    def _controls(self, sh: _Shard) -> tuple[torch.Tensor, torch.Tensor]:
        """A group's per-stream bearings (s,) and loadings (s, 1) on its
        device, uploaded when one has changed. The loadings' trailing 1 says
        "per stream" to the beamformer even when s equals the number of
        bins."""
        if sh.ctrl is None:
            sh.ctrl = self._upload(np.stack([self._steer[sh.sl], self._sigma[sh.sl]]), sh.device)
        return sh.ctrl[0], sh.ctrl[1][:, None]

    def _steer_and_mask(self, sh: _Shard, Y: torch.Tensor, steer: torch.Tensor,
                        frames_from: int = 0):
        """Steering vectors (s, F, M) and the net's target masks (s, F, T')
        over frames [frames_from:] of the steer-aligned STFT."""
        cfg = self.cfg
        d = steering_vector(sh.freqs, steer, cfg.mic_dist, cfg.c, cfg.n_mics, positions=sh.geom)
        mask = predict_mask(sh.model, steer_rotate(Y[..., frames_from:], d), self._fk,
                            ipd_scale=self._ipd_scale, pair_mode=self._pair_mode)
        return d, mask

    def _beamform(self, sh: _Shard, Y, mask, d, sigma) -> torch.Tensor:
        """Masked MVDR (for 2 mics one launch for the group's streams; M > 2
        the M-mic MVDR in torch) and iSTFT, Hann-weighted for the
        overlap-add: (s, win)."""
        cfg = self.cfg
        S = masked_mvdr_any(Y, 1.0 - mask, d, sh.freqs, target_mask=mask, mask_floor=0.05,
                            sigma=sigma, hp_cutoff_hz=cfg.hp_cutoff_hz)
        return istft(S, cfg.n_fft, cfg.hop, length=self._win) * sh.hann

    def _track_update(self, Ys: list) -> None:
        """With tracking, one momentum-filter step per stream on this tick's
        DOA histograms (every group's computed, then fetched: (S, 181)
        float32)."""
        if self._track:
            cfg = self.cfg
            hists = [ipd_angle_histogram(Y, cfg.mic_dist, cfg.fs, c=cfg.c)[1] for Y in Ys]
            hist = np.concatenate([self._fetch(h) for h in hists])
            # The new bearings steer the next tick (the histogram is past audio).
            self._steer = self._tracker.update(hist, self._center, self._fov, self._active)
            self._controls_changed()

    def _prime(self, window: np.ndarray) -> None:
        """First tick: a full (S, M, win) window primes the device state and
        gives no output (the overlap-add warm-up hop)."""
        cfg = self.cfg
        with torch.inference_mode():
            Ys = []
            for sh in self._shards:
                w = self._decode(window[sh.sl], sh.device)
                steer, sigma = self._controls(sh)
                Y = stft(w, cfg.n_fft, cfg.hop)
                d, mask = self._steer_and_mask(sh, Y, steer)
                weighted = self._beamform(sh, Y, mask, d, sigma)
                sh.win, sh.tail, sh.mask = w, weighted[:, self._hop:], mask
                Ys.append(Y)
            self._primed = True
            self._pending_reset[:] = False
            self._track_update(Ys)

    def _tick_shard(self, sh: _Shard, new_hop: np.ndarray, reset: np.ndarray | None):
        """Issue one group's tick: (its finished hop on the device, its STFT)."""
        cfg, hop = self.cfg, self._hop
        x = self._decode(new_hop, sh.device)
        steer, sigma = self._controls(sh)
        win, tail, prev = sh.win, sh.tail, sh.mask
        rs = None
        if reset is not None:
            # Churned slots start from silence; their reused masks are ones
            # (delay-and-sum) until the net has seen them.
            rs = self._upload(reset, sh.device)
            win = torch.where(rs[:, None, None], 0.0, win)
            tail = torch.where(rs[:, None], 0.0, tail)
        win = torch.cat([win[:, :, hop:], x], dim=2)
        Y = stft(win, cfg.n_fft, cfg.hop)
        if self._reuse is None:
            d, mask = self._steer_and_mask(sh, Y, steer)
        else:
            shift, ctx = self._reuse
            if rs is not None:
                prev = torch.where(rs[:, None, None], 1.0, prev)
            d, new = self._steer_and_mask(sh, Y, steer, frames_from=Y.shape[-1] - shift - ctx)
            mask = torch.cat([prev[:, :, shift:], new[:, :, ctx:]], dim=-1)
        weighted = self._beamform(sh, Y, mask, d, sigma)
        out = (tail + weighted[:, :hop]) / sh.ola_norm
        if self._wire_i16:
            out = torch.clamp(out * 32767.0, -32767.0, 32767.0).to(torch.int16)
        sh.win, sh.tail, sh.mask = win, weighted[:, hop:], mask
        return out, Y

    def _tick(self, new_hop: np.ndarray) -> np.ndarray:
        """One hop of new samples in, one finished hop out: every group's
        step is issued before any output is fetched."""
        reset = self._pending_reset.copy() if self._pending_reset.any() else None
        self._pending_reset[:] = False
        with torch.inference_mode():
            outs, Ys = [], []
            for sh in self._shards:
                out, Y = self._tick_shard(sh, new_hop[sh.sl],
                                          None if reset is None else reset[sh.sl])
                outs.append(out)
                Ys.append(Y)
            out = np.concatenate([self._fetch(o) for o in outs])
            self._track_update(Ys)
        return out
