"""Moving-source synthesis: time-varying DOA (counterpart of azoom.sim.motion).

The trajectory is sampled once per block. Each source is cut into
periodic-Hann windows of two blocks at a hop of one block, which sum to one
(50 % COLA); each window is rendered with its block's static far-field
fractional delays (or, in a room, convolved with its block's RIR), and the
windows are overlap-added: a crossfade between block anchors, exact for a
static source.

The far-field overlap-add is a sum of halves: every output sample lies under
exactly two windows, so the reference's scan (one addition to zero, then
one more) equals the second half of window b plus the first half of window
b + 1, bit for bit given the same delayed windows. The room overlap-add
spans several windows (a window plus its RIR's tail) and is a loop over
anchors on the device, adding in the scan's order.

All (anchor, source, mic) delays are one batched ``fractional_delay``, and a
moving room scene's anchor RIRs one batched ``rir_matrix``. Entry points
render on CUDA unless ``device`` names another device (a tensor input stays
where it is); ``make_moving_room_scene`` takes a ``torch.Generator`` where
the reference takes a JAX key (``sim.scene`` says how the draws differ).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from azoom_torch.config import RoomConfig, as_input, resolve_device
from azoom_torch.dsp.delays import far_field_delays, fractional_delay
from azoom_torch.sim.room import fft_convolve, rir_matrix
from azoom_torch.sim.scene import _absorption_order, _awgn, _source_positions, apply_sir_gain
from azoom_torch.sim.signals import _normal, _uniform

__all__ = [
    "traj_block_count",
    "linear_trajectory",
    "mix_far_field_moving",
    "make_moving_scene",
    "make_moving_room_scene",
]


def traj_block_count(n_samples: int, block: int) -> int:
    """Trajectory anchors a clip of ``n_samples`` needs at hop ``block``."""
    return -(-n_samples // block)


def linear_trajectory(start_deg: float, end_deg: float, n_blocks: int,
                      device=None) -> torch.Tensor:
    """(B,) float32 azimuth anchors gliding linearly from start to end."""
    return torch.linspace(start_deg, end_deg, n_blocks, dtype=torch.float32,
                          device=resolve_device(device))


def _windows(x: torch.Tensor, block: int, n_blocks: int) -> torch.Tensor:
    """(B + 1, ..., 2 block) periodic-Hann windows of x (..., n) padded with
    one leading block of zeros, so that every sample of x lies under two
    windows that sum to one."""
    seg = 2 * block
    t = torch.arange(seg, dtype=torch.float32, device=x.device)
    w = 0.5 - 0.5 * torch.cos(2.0 * math.pi * t / seg)
    xp = F.pad(x, (block, (n_blocks + 2) * block - x.shape[-1] - block))
    return xp.unfold(-1, seg, block).movedim(-2, 0) * w


def _anchors(traj: torch.Tensor) -> torch.Tensor:
    """Anchor 0 repeated: window b peaks half a block before anchor b, so
    block k crossfades between anchors k and k + 1."""
    return torch.cat([traj[..., :1], traj], dim=-1)


def _overlap_add(delayed: torch.Tensor, block: int, n: int) -> torch.Tensor:
    """Overlap-add (B + 1, ..., 2 block) windows at hop ``block`` and crop
    the leading pad block: (..., n). Block k of the output is window k's
    second half plus window k + 1's first half."""
    halves = delayed[:-1, ..., block:] + delayed[1:, ..., :block]  # (B, ..., block)
    return halves.movedim(0, -2).flatten(-2)[..., :n]


def _moving_images(sources: torch.Tensor, angle_traj_deg, mic_dist: float, c: float,
                   n_mics: int, fs: float, block: int) -> torch.Tensor:
    """(S, M, n) images of sources (S, n) gliding along their per-block
    azimuths ``angle_traj_deg`` ((S, B), a static source a constant row)."""
    S, n = sources.shape
    B = traj_block_count(n, block)
    segs = _windows(sources, block, B)  # (B + 1, S, seg)
    traj = torch.as_tensor(angle_traj_deg, dtype=torch.float32, device=sources.device)
    traj = _anchors(traj.broadcast_to(S, B)).T  # (B + 1, S)
    tau = far_field_delays(traj, mic_dist, c, n_mics, device=sources.device)  # (B + 1, S, M)
    delayed = fractional_delay(segs[:, :, None, :], tau, fs)  # (B + 1, S, M, seg)
    return _overlap_add(delayed, block, n)


def mix_far_field_moving(sources, angle_traj_deg, mic_dist: float, fs: float,
                         c: float = 343.0, n_mics: int = 2, block: int = 2048,
                         device=None) -> torch.Tensor:
    """Mix S moving far-field sources (S, n) with per-block azimuths (S, B),
    B = traj_block_count(n, block), into an (M, n) observation; constant
    rows reproduce ``mix_far_field``."""
    sources = as_input(sources, device).to(torch.float32)
    return _moving_images(sources, angle_traj_deg, mic_dist, c, n_mics, fs, block).sum(dim=0)


def make_moving_scene(target, interferers, target_traj_deg, interferer_angles_deg,
                      mic_dist: float, fs: float, c: float = 343.0, n_mics: int = 2,
                      block: int = 2048, normalize: bool = True, device=None) -> dict:
    """A far-field scene whose target (n,) glides along ``target_traj_deg``
    ((B,) anchors) while the interferers (K, n) stay at fixed azimuths (K,)
    or move too ((K, B)). Returns ``mixture`` (M, n) and the mic-0 stems
    ``target_ref`` and ``interference_ref`` (n,), sharing the mixture's peak
    normalisation."""
    target = as_input(target, device).to(torch.float32)
    dev = target.device
    interferers = torch.as_tensor(interferers, dtype=torch.float32, device=dev)
    n = target.shape[-1]
    B = traj_block_count(n, block)
    K = interferers.shape[0] if interferers.ndim == 2 else 0
    itraj = torch.as_tensor(interferer_angles_deg, dtype=torch.float32,
                            device=dev).reshape(K, -1).broadcast_to(K, B)
    traj = torch.cat([torch.as_tensor(target_traj_deg, dtype=torch.float32,
                                      device=dev)[None, :], itraj])  # (1 + K, B)
    sources = torch.cat([target[None, :], interferers.reshape(K, n)])
    imgs = _moving_images(sources, traj, mic_dist, c, n_mics, fs, block)
    mixture = imgs.sum(dim=0)
    target_ref = imgs[0, 0]
    interference_ref = imgs[1:, 0, :].sum(dim=0)
    if normalize:
        peak = mixture.abs().max() + 1e-9
        mixture, target_ref, interference_ref = (
            mixture / peak, target_ref / peak, interference_ref / peak)
    return {"mixture": mixture, "target_ref": target_ref, "interference_ref": interference_ref}


def _moving_room_scene(pos_u, noise, target: torch.Tensor, interferers: torch.Tensor,
                       target_traj_deg, room: RoomConfig, fs: int, block: int, radius: float,
                       snr_db: float, max_order: int | None, reverb: bool) -> dict:
    """The render step of :func:`make_moving_room_scene`: ``pos_u``
    (K - 1, 2) uniforms (or None below two interferers), ``noise`` (M, n)
    standard normals."""
    dev = target.device
    n = target.shape[-1]
    B = traj_block_count(n, block)
    K = interferers.shape[0] if interferers.ndim == 2 else 0
    mics = torch.tensor(room.mic_locs, dtype=torch.float32, device=dev)  # (M, 3)
    absorption, order = _absorption_order(room, reverb, max_order)
    L = min(int(0.6 * fs), n)

    # The anchors walk the azimuth circle of ``radius`` around the array's
    # center at its height; every anchor's RIRs in one batched pass.
    traj = _anchors(torch.as_tensor(target_traj_deg, dtype=torch.float32,
                                    device=dev).reshape(B))
    az = torch.deg2rad(traj)
    pos = mics.mean(dim=0) + radius * torch.stack(
        [torch.cos(az), torch.sin(az), torch.zeros_like(az)], dim=-1)  # (B + 1, 3)
    rirs = rir_matrix(pos, mics, room.room_dim, absorption, order, fs, L)  # (B + 1, M, L)

    segs = _windows(target, block, B)  # (B + 1, seg)
    out_len = 2 * block + L - 1
    wet = fft_convolve(segs[:, None, :], rirs, out_len)  # (B + 1, M, out_len)
    buf = torch.zeros((mics.shape[0], (B + 2) * block + L), dtype=torch.float32, device=dev)
    for b in range(B + 1):
        buf[:, b * block:b * block + out_len] += wet[b]
    target_wet = buf[:, block:block + n]  # (M, n)

    if K:
        ipos = _source_positions(room, K, pos_u, dev)[1:]
        irirs = rir_matrix(ipos, mics, room.room_dim, absorption, order, fs, L)  # (K, M, L)
        interf = fft_convolve(interferers[:, None, :], irirs, n).sum(dim=0)
        interf = apply_sir_gain(target_wet[0], interf, room.sir_target_db)
    else:
        interf = torch.zeros_like(target_wet)
    noisy = _awgn(target_wet + interf, noise, snr_db)
    peak = noisy.abs().max() + 1e-9
    return {"mixture": noisy / peak, "target_ref": target_wet[0] / peak,
            "interference_ref": interf[0] / peak}


def make_moving_room_scene(generator: torch.Generator, target, interferers, target_traj_deg,
                           room: RoomConfig, fs: int = 16_000, block: int = 2048,
                           radius: float = 1.0, snr_db: float = 50.0,
                           max_order: int | None = None, reverb: bool = True,
                           device=None) -> dict:
    """A moving talker in a reverberant shoebox room: the target (n,) walks
    a circle of ``radius`` meters around the array's center along
    ``target_traj_deg`` ((B,) azimuths, one per ``block`` samples; 90 deg is
    broadside), each window convolved with the image-source RIR at its
    anchor and overlap-added, the reverberant tails riding past the block
    boundaries. The interferers (K, n) are static, placed as
    ``simulate_room_scene`` places them. Returns ``mixture`` (M, n) and the
    mic-0 stems ``target_ref`` and ``interference_ref`` (n,), sharing the
    mixture's peak normalisation."""
    target = as_input(target, device).to(torch.float32)
    dev = target.device
    interferers = torch.as_tensor(interferers, dtype=torch.float32, device=dev)
    K = interferers.shape[0] if interferers.ndim == 2 else 0
    pos_u = _uniform(generator, (K - 1, 2), dev) if K >= 2 else None
    noise = _normal(generator, (len(room.mic_locs), target.shape[-1]), dev)
    return _moving_room_scene(pos_u, noise, target, interferers, target_traj_deg, room, fs,
                              block, radius, snr_db, max_order, reverb)
