"""Central configuration for the PyTorch port (counterpart of azoom.config).

``PipelineConfig`` keeps every field, default and method of the JAX
package's config, so one configuration describes the same pipeline in both
packages. The only difference is :meth:`PipelineConfig.geometry`, which
returns a float32 ``torch.Tensor`` (on the CPU; callers move it with
``.to(device)``) instead of a JAX array.
"""

from __future__ import annotations

import dataclasses

import torch

SPEED_OF_SOUND = 343.0  # m/s


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Static physics + STFT configuration (hashable, immutable)."""

    # Audio
    fs: int = 16_000

    # STFT
    n_fft: int = 1024
    hop: int = 512

    # Streaming window: 2.0 s chunks with 50% overlap-add
    win_size: int = 32_000

    # Array geometry: a uniform linear array of ``n_mics`` spaced
    # ``mic_dist`` apart, unless ``mic_positions`` gives explicit per-mic
    # (x,), (x, y) or (x, y, z) coordinates in meters (array-centered).
    n_mics: int = 2
    mic_dist: float = 0.08
    mic_positions: tuple[tuple[float, ...], ...] | None = None
    c: float = SPEED_OF_SOUND

    # Beamforming
    angle_target_deg: float = 90.0
    sigma: float = 1e-7          # diagonal loading; doubles as "zoom" knob
    hp_cutoff_hz: float = 100.0  # bypass unstable low bins

    @property
    def n_freqs(self) -> int:
        return self.n_fft // 2 + 1

    @property
    def frames_per_chunk(self) -> int:
        """STFT frames produced for one win_size chunk (scipy conventions,
        as :func:`azoom_torch.dsp.stft.stft_frame_count`)."""
        ext = self.win_size + 2 * (self.n_fft // 2)
        n_add = (-(ext - self.n_fft)) % self.hop
        return (ext + n_add - self.n_fft) // self.hop + 1

    def replace(self, **kw) -> "PipelineConfig":
        return dataclasses.replace(self, **kw)

    def with_geometry(self, positions) -> "PipelineConfig":
        """Explicit array geometry: ``positions`` is an iterable of per-mic
        (x,), (x, y) or (x, y, z) coordinates in meters (or bare floats,
        taken as x). Sets ``mic_positions`` and keeps ``n_mics`` in step."""
        pos = tuple(
            tuple(float(v) for v in (p if hasattr(p, "__len__") else (p,)))
            for p in positions
        )
        return self.replace(mic_positions=pos, n_mics=len(pos))

    def geometry(self) -> torch.Tensor | None:
        """Explicit mic coordinates as a float32 tensor (M, k), or None for
        the canonical uniform-linear layout. Pass as ``positions=`` to the
        dsp.delays functions."""
        if self.mic_positions is None:
            return None
        return torch.tensor(self.mic_positions, dtype=torch.float32)

    def for_input(self, mixture) -> "PipelineConfig":
        """Reconcile the static mic count with an (..., M, n) input; an
        explicit geometry that disagrees with the channel count raises."""
        if getattr(mixture, "ndim", 1) < 2:
            return self
        m = int(mixture.shape[-2])
        if m == self.n_mics:
            return self
        if self.mic_positions is not None:
            raise ValueError(
                f"input has {m} channels but mic_positions describes "
                f"{self.n_mics} mics; fix the geometry or the recording"
            )
        return self.replace(n_mics=m)


DEFAULT = PipelineConfig()
