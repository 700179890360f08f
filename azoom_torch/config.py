"""Central configuration for the PyTorch port (counterpart of azoom.config).

``PipelineConfig`` keeps every field, default and method of the JAX
package's config, so one configuration describes the same pipeline in both
packages. The only difference is :meth:`PipelineConfig.geometry`, which
returns a float32 ``torch.Tensor`` (on the CPU; callers move it with
``.to(device)``) instead of a JAX array. ``RoomConfig`` is the reference's
room-simulation configuration, field for field, and ``PathsConfig`` its
run-directory layout. :func:`parse_geometry` reads the CLI's
``--geometry``. :func:`resolve_device` is the entry points' rule for their
``device`` argument.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import torch

SPEED_OF_SOUND = 343.0  # m/s


def parse_geometry(spec: str) -> tuple[tuple[float, ...], ...]:
    """Parse a CLI ``--geometry`` string into a ``mic_positions`` tuple:
    semicolon-separated mics, comma-separated coordinates in meters, ``"x"``,
    ``"x,y"`` or ``"x,y,z"`` per mic. Example, a 4-mic 3 x 2 cm rectangle:
    ``"-0.015,-0.01;0.015,-0.01;-0.015,0.01;0.015,0.01"``."""
    mics = []
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        coords = tuple(float(v) for v in part.split(","))
        if not 1 <= len(coords) <= 3:
            raise ValueError(f"--geometry mic '{part}': expected 1-3 coordinates")
        mics.append(coords)
    if len(mics) < 2:
        raise ValueError("--geometry needs at least 2 mics")
    return tuple(mics)


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

# The Gen-1 legacy configuration: a 512-point STFT at hop 256 on a 1 cm pair.
GEN1 = PipelineConfig(n_fft=512, hop=256, mic_dist=0.01)


@dataclasses.dataclass(frozen=True)
class RoomConfig:
    """Room-acoustics simulation defaults (counterpart of azoom.config.RoomConfig):
    a 4.9 m cube at RT60 0.5 s, an 8 cm mic pair at 1.5 m, the target 1 m in
    front of it, the fixed interferer at ~40 deg, image order 15. Frozen and
    hashable, as the reference's."""

    room_dim: tuple[float, float, float] = (4.9, 4.9, 4.9)
    rt60_target: float = 0.5
    sir_target_db: float = 0.0
    mic_locs: tuple[tuple[float, float, float], ...] = (
        (2.41, 2.45, 1.5),
        (2.49, 2.45, 1.5),
    )
    target_pos: tuple[float, float, float] = (2.45, 3.45, 1.5)
    interferer_pos_fixed: tuple[float, float, float] = (3.22, 3.06, 1.5)
    max_order: int = 15

    def _center(self) -> tuple[float, float, float]:
        (x0, y, z), (x1, _, _) = self.mic_locs[0], self.mic_locs[1]
        return 0.5 * (x0 + x1), y, z

    def with_mic_dist(self, mic_dist: float) -> "RoomConfig":
        """Same room, the mic pair re-spaced to ``mic_dist`` around the same
        center (to keep the room in step with ``PipelineConfig.mic_dist``)."""
        cx, y, z = self._center()
        locs = ((cx - mic_dist / 2, y, z), (cx + mic_dist / 2, y, z))
        return dataclasses.replace(self, mic_locs=locs)

    def with_linear_array(self, n_mics: int, mic_dist: float) -> "RoomConfig":
        """Same room, an ``n_mics``-element uniform linear array spaced
        ``mic_dist`` apart along x, centered where the original pair was."""
        cx, y, z = self._center()
        span = (n_mics - 1) * mic_dist
        locs = tuple((cx - span / 2 + m * mic_dist, y, z) for m in range(n_mics))
        return dataclasses.replace(self, mic_locs=locs)

    def with_array_positions(self, positions) -> "RoomConfig":
        """An explicit mic array in the room: ``positions`` is the
        ``PipelineConfig.mic_positions`` tuple of per-mic (x,), (x, y) or
        (x, y, z) offsets in meters, array-centered; the center stays where
        the original pair's was, array-x along room-x, array-y along room-y."""
        cx, y0, z0 = self._center()
        locs = []
        for p in positions:
            p = tuple(p) if hasattr(p, "__len__") else (float(p),)
            px = p[0]
            py = p[1] if len(p) > 1 else 0.0
            pz = p[2] if len(p) > 2 else 0.0
            locs.append((cx + px, y0 + py, z0 + pz))
        return dataclasses.replace(self, mic_locs=tuple(locs))


ROOM_DEFAULT = RoomConfig()


@dataclasses.dataclass(frozen=True)
class PathsConfig:
    """Run-directory layout of the CLIs (counterpart of azoom.config.PathsConfig):
    data/simulated/{name} -> data/results/{name}_results."""

    root: Path = Path("data")

    @property
    def sim_dir(self) -> Path:
        return self.root / "simulated"

    @property
    def results_dir(self) -> Path:
        return self.root / "results"

    def run_sim_dir(self, run_name: str) -> Path:
        return self.sim_dir / run_name

    def run_results_dir(self, run_name: str) -> Path:
        return self.results_dir / f"{run_name}_results"


PATHS = PathsConfig()


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA when ``device`` is None (and
    an error when there is no card), else ``device`` ("cpu" runs the plain
    PyTorch versions of the kernels)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def as_input(x, device=None) -> torch.Tensor:
    """An entry point's input as a tensor: a tensor stays where it is unless
    ``device`` is given; anything else goes to :func:`resolve_device`'s
    device (CUDA unless the caller asks for another)."""
    if isinstance(x, torch.Tensor) and device is None:
        return x
    return torch.as_tensor(x, device=resolve_device(device))
