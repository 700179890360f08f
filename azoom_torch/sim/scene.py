"""Scene simulation: reverberant or anechoic mixtures with their answer keys
(counterpart of azoom.sim.scene).

  * room mode: image-source RIRs (``sim.room``) convolved with each source
    at each mic;
  * SIR control: the summed interference scaled so that the channel-0
    powers meet the target SIR;
  * SNR control: white Gaussian noise at a target SNR on each channel;
  * one peak normalisation of the noisy mixture, shared with the stems.

Randomness, as in ``sim.signals``: a ``torch.Generator`` stands where the
reference takes a JAX key, the draws (the random interferer positions, the
sensor noise) are taken apart from the rendering, and a seed gives other
scenes than JAX's key with the same number. One difference of detail: the
reference draws a 2-mic scene's noise from two fixed keys and other mic
counts' from a split key; the port draws one (M, n) normal at every M.

Entry points render on CUDA unless ``device`` names another device.
"""

from __future__ import annotations

import dataclasses

import torch

from azoom_torch.config import RoomConfig, as_input, resolve_device
from azoom_torch.sim.room import fft_convolve, inverse_sabine, rir_matrix
from azoom_torch.sim.signals import _normal, _uniform, interferer_signal, speech_like

__all__ = ["add_awgn", "apply_sir_gain", "simulate_room_scene", "SceneSpec", "generate_scene"]


def _row_power(x: torch.Tensor) -> torch.Tensor:
    """The mean square of each row of ``x`` (..., n), shaped (...), summed
    pairwise in a fixed order: the squares zero-padded to a power of two,
    then halved by elementwise adds. CUDA's reduction splits a row across
    threads by the number of rows, so a batched mean would round a scene's
    power by the size of its batch (a sweep's scene would then change with
    its chunk); the adds give every row the same bits whatever the batch,
    on the card and the CPU alike, in log2(n) launches."""
    n = x.shape[-1]
    sq = x * x
    width = 1 << (n - 1).bit_length()
    if width > n:
        sq = torch.nn.functional.pad(sq, (0, width - n))
    while sq.shape[-1] > 1:
        half = sq.shape[-1] // 2
        sq = sq[..., :half] + sq[..., half:]
    return sq[..., 0] / n


def _awgn(signal: torch.Tensor, noise: torch.Tensor, snr_db: float) -> torch.Tensor:
    """``signal`` plus the standard normal ``noise`` scaled to ``snr_db``
    below each row's power."""
    sig_power = _row_power(signal)[..., None]
    noise_power = sig_power / (10.0 ** (snr_db / 10.0))
    return signal + noise * torch.sqrt(noise_power)


def add_awgn(generator: torch.Generator, signal, snr_db: float, device=None) -> torch.Tensor:
    """White Gaussian noise at ``snr_db`` below each row's power."""
    signal = as_input(signal, device)
    return _awgn(signal, _normal(generator, signal.shape, signal.device), snr_db)


def apply_sir_gain(target_ch0, interf, sir_db: float, eps: float = 1e-12,
                   device=None) -> torch.Tensor:
    """The summed interference (..., M, n) scaled so that
    ``10 log10(P_tgt / (g^2 P_int)) = sir_db``, both powers on channel 0."""
    target_ch0 = as_input(target_ch0, device)
    interf = torch.as_tensor(interf, device=target_ch0.device)
    p_t = _row_power(target_ch0)
    p_i = _row_power(interf[..., 0, :]) + eps
    gain = torch.sqrt(p_t / (p_i * 10.0 ** (sir_db / 10.0)))
    return interf * gain[..., None, None]


def _source_positions(room: RoomConfig, n_interferers: int, pos_u, device) -> torch.Tensor:
    """The target, the first interferer at the fixed position, the others
    at ``1 + u (L - 2)`` on each horizontal axis (``pos_u`` (K - 1, 2)
    uniforms) and 1.5 m high: (1 + K, 3)."""
    rows = [torch.tensor(room.target_pos, dtype=torch.float32, device=device)]
    if n_interferers >= 1:
        rows.append(torch.tensor(room.interferer_pos_fixed, dtype=torch.float32, device=device))
    if n_interferers >= 2:
        dims = torch.tensor(room.room_dim, dtype=torch.float32, device=device)
        rnd = 1.0 + pos_u * (dims[:2] - 2.0)
        rows.append(torch.cat([rnd, torch.full_like(rnd[:, :1], 1.5)], dim=1))
    return torch.cat([r.reshape(-1, 3) for r in rows])


def _absorption_order(room: RoomConfig, reverb: bool, max_order: int | None) -> tuple:
    if reverb:
        return (inverse_sabine(room.rt60_target, room.room_dim),
                room.max_order if max_order is None else max_order)
    return 1.0, 0  # beta = 0: the direct path alone


def _room_scene(pos_u, noise, target_sig: torch.Tensor, interferer_sigs: torch.Tensor,
                room: RoomConfig, reverb: bool, snr_db: float, fs: int,
                max_order: int | None) -> dict:
    """The render step of :func:`simulate_room_scene`: ``pos_u`` (K - 1, 2)
    uniforms (or None below two interferers), ``noise`` (M, n) standard
    normals."""
    dev = target_sig.device
    n = target_sig.shape[-1]
    K = interferer_sigs.shape[0] if interferer_sigs.ndim > 1 else 0
    sources = _source_positions(room, K, pos_u, dev)
    absorption, order = _absorption_order(room, reverb, max_order)
    rirs = rir_matrix(sources, room.mic_locs, room.room_dim, absorption, order, fs,
                      min(int(0.6 * fs), n))  # (S, M, L)
    sigs = torch.cat([target_sig[None], interferer_sigs.reshape(K, n)]) if K else target_sig[None]
    wet = fft_convolve(sigs[:, None, :], rirs, n)  # (S, M, n)
    target = wet[0]
    if K:
        interf = apply_sir_gain(target[0], wet[1:].sum(dim=0), room.sir_target_db)
    else:
        interf = torch.zeros_like(target)
    noisy = _awgn(target + interf, noise, snr_db)
    peak = noisy.abs().max() + 1e-9
    return {
        "mixture": noisy / peak,
        "target_ref": target[0] / peak,
        "interference_ref": interf[0] / peak,
        "target_stereo": target / peak,
        "interference_stereo": interf / peak,
        "rirs": rirs,
    }


def simulate_room_scene(generator: torch.Generator, target_sig, interferer_sigs,
                        room: RoomConfig, reverb: bool = True, snr_db: float = 50.0,
                        fs: int = 16_000, max_order: int | None = None, device=None) -> dict:
    """A room scene from given sources: ``target_sig`` (n,) and
    ``interferer_sigs`` (K, n), the first interferer at the room's fixed
    position, the others uniform inside it with 1 m wall margins. RIRs of
    ``min(0.6 fs, n)`` taps (``max_order`` overrides the room's order;
    ``reverb=False`` is the direct path alone). Returns ``mixture`` (M, n),
    ``target_ref`` and ``interference_ref`` (n,) at mic 0, their (M, n)
    ``*_stereo`` forms, all sharing the mixture's peak normalisation, and
    ``rirs`` (S, M, L)."""
    target_sig = as_input(target_sig, device).to(torch.float32)
    dev = target_sig.device
    interferer_sigs = torch.as_tensor(interferer_sigs, dtype=torch.float32, device=dev)
    K = interferer_sigs.shape[0] if interferer_sigs.ndim > 1 else 0
    pos_u = _uniform(generator, (K - 1, 2), dev) if K >= 2 else None
    noise = _normal(generator, (len(room.mic_locs), target_sig.shape[-1]), dev)
    return _room_scene(pos_u, noise, target_sig, interferer_sigs, room, reverb, snr_db, fs,
                       max_order)


@dataclasses.dataclass(frozen=True)
class SceneSpec:
    """Static knobs of :func:`generate_scene`. ``interferer_kind`` picks the
    synthetic class: 'speech', 'babble', 'music', 'noise' or 'mixed'."""

    reverb: bool = True
    n_interferers: int = 1
    snr_db: float = 50.0
    duration_s: float = 4.0
    fs: int = 16_000
    interferer_kind: str = "speech"


_F0S = (150.0, 220.0, 120.0, 260.0, 180.0)


def generate_scene(generator: torch.Generator, spec: SceneSpec = SceneSpec(),
                   room: RoomConfig = RoomConfig(), source_signals=None,
                   max_order: int | None = None, device=None) -> dict:
    """A whole scene from a generator: synthetic speech-like sources (the
    target at 150 Hz, interferer i of ``spec.interferer_kind`` at the i-th
    pitch of 150, 220, 120, 260, 180 Hz) unless ``source_signals`` (1 + K, n)
    are given, then :func:`simulate_room_scene`. A seed gives another scene
    than JAX's key with the same number."""
    n = int(spec.duration_s * spec.fs)
    if source_signals is None:
        dev = resolve_device(device)
        source_signals = torch.stack(
            [speech_like(generator, n, spec.fs, _F0S[0], device=dev)]
            + [interferer_signal(generator, n, spec.fs, spec.interferer_kind, _F0S[i % 5],
                                 device=dev)
               for i in range(1, spec.n_interferers + 1)])
    source_signals = as_input(source_signals, device).to(torch.float32)
    return simulate_room_scene(generator, source_signals[0], source_signals[1:], room,
                               reverb=spec.reverb, snr_db=spec.snr_db, fs=spec.fs,
                               max_order=max_order)
