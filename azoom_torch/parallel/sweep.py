"""Batch evaluation sweeps, the vectorized batch_run.py (counterpart of
azoom.parallel.sweep).

A sweep is a batch axis: B scenes are drawn, enhanced in one batched
pipeline call and scored, and :func:`sharded_sweep` splits the scene axis
over a device mesh so that each device makes, enhances and scores its own
run of scenes; the only traffic is the final gather of the metrics.

  * :func:`oracle_sweep` - the ideal binary mask + MVDR, the correctness
    ceiling; on CUDA one launch of the fused MVDR kernel for the batch
    (2-mic arrays).
  * :func:`learned_sweep` - a mask net feeding a beamformer over anechoic or
    image-source reverberant scenes (by default the reference's flagship
    campaign: RT60 0.5 s, 2 interferers, randomized placement); on CUDA the
    int8 nets' convs run on the int8 conv kernel, the upsamplings on the
    upsampling kernel, MVDR and hard-null on their fused kernels.

Each sweep is a draw step (:func:`sweep_scenes`) and an enhance-and-score
step (:func:`oracle_step`, :func:`learned_step`). Randomness: a ``seed``
(int) stands where the reference takes a JAX key. Scene i of a campaign
draws from its own CPU ``torch.Generator``, seeded from (seed, i) alone, so a
scene is the same whichever shard, chunk or device makes it, and the card
and the CPU render the same draws (``sim.signals``). The sources of all
scenes render as one batch, and so do the far-field mixing and the room
scenes (every RIR of the batch in one pass).

Fault tolerance is numerical, as in the reference: :func:`sweep_summary`
masks non-finite scores out of the aggregate.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from azoom_torch.config import ROOM_DEFAULT, PipelineConfig, RoomConfig, resolve_device
from azoom_torch.eval.projection import osinr_osir
from azoom_torch.eval.stoi import stoi
from azoom_torch.parallel.mesh import Mesh, replicated, run_on_devices, shard_ranges
from azoom_torch.pipelines.learned import _model_device, learned_enhance
from azoom_torch.pipelines.oracle import oracle_enhance
from azoom_torch.sim.farfield import make_scene
from azoom_torch.sim.room import fft_convolve, rir_matrix
from azoom_torch.sim.scene import _absorption_order, _awgn, apply_sir_gain
from azoom_torch.sim.signals import (
    _normal,
    _speech_draws,
    _speech_render,
    _uniform,
    interferer_signal,
)

__all__ = [
    "oracle_sweep", "learned_sweep", "sweep_summary", "sharded_sweep", "sweep_scenes",
    "oracle_step", "learned_step", "score_scenes", "scene_generator",
]

# Fixed anechoic interferer angles: 40 and 130 deg first (the reference's
# canonical geometry), more toward the endfire directions.
_FIXED_ANGLES = (40.0, 130.0, 20.0, 160.0, 60.0, 120.0)
_CPU = torch.device("cpu")


def scene_generator(seed: int, i: int) -> torch.Generator:
    """The CPU generator of scene ``i`` of the campaign ``seed``: a function
    of the pair alone."""
    state = np.random.SeedSequence([int(seed), int(i)]).generate_state(2, np.uint32)
    return torch.Generator().manual_seed(int(state[0]) << 31 | int(state[1]) >> 1)


def _random_interferer_angles(g: torch.Generator, n: int, target_deg: float) -> torch.Tensor:
    """n azimuths uniform over [10, 170] deg outside +/-15 deg of the target:
    each on the side below or above it with probability 1/2."""
    u = _uniform(g, (n,), _CPU)
    below_side = _uniform(g, (n,), _CPU) < 0.5
    lo_width = (target_deg - 15.0) - 10.0
    hi_width = 170.0 - (target_deg + 15.0)
    below = 10.0 + u * lo_width
    above = (target_deg + 15.0) + u * hi_width
    return torch.where(below_side, below, above)


def _sweep_room(cfg: PipelineConfig, room: RoomConfig) -> RoomConfig:
    """The room with the enhancement config's array: the explicit geometry
    placed in it, or the linear array re-spaced when the mic count or the
    spacing disagrees."""
    if cfg.mic_positions is not None:
        return room.with_array_positions(cfg.mic_positions)
    (x0, _, _), (x1, _, _) = room.mic_locs[0], room.mic_locs[1]
    if len(room.mic_locs) != cfg.n_mics or abs(abs(x1 - x0) - cfg.mic_dist) > 1e-9:
        return room.with_linear_array(cfg.n_mics, cfg.mic_dist)
    return room


def _draw(g: torch.Generator, cfg: PipelineConfig, n_samples: int, n_interferers: int,
          reverb: bool, randomize: bool, n_mics: int, interferer_kind: str, snr_db: float,
          device) -> dict:
    """One scene's draws, in this order: the sources' pitches (100-280 Hz),
    the speech draws (every source's, or the target's; another class's
    interferers are drawn and rendered here), then the room's interferer
    positions and sensor noise, or the far-field angles and, below 50 dB
    SNR, one noise row per mic."""
    S = n_interferers + 1
    d = {"f0": 100.0 + 180.0 * _uniform(g, (S,), _CPU)}
    if interferer_kind == "speech":
        d["speech"] = _speech_draws(g, n_samples, (S,), _CPU)
    else:
        d["speech"] = _speech_draws(g, n_samples, (1,), _CPU)
        d["others"] = torch.stack([
            interferer_signal(g, n_samples, cfg.fs, interferer_kind, float(d["f0"][i]),
                              device=device) for i in range(1, S)])
    if reverb:
        d["pos_u"] = _uniform(g, (n_interferers - 1, 2), _CPU) if n_interferers >= 2 else None
        d["noise"] = _normal(g, (n_mics, n_samples), _CPU)
        return d
    if randomize:
        d["angles"] = _random_interferer_angles(g, n_interferers, cfg.angle_target_deg)
    else:
        if n_interferers > len(_FIXED_ANGLES):
            raise ValueError(
                f"fixed-angle scenes support at most {len(_FIXED_ANGLES)} interferers "
                f"(got {n_interferers}); use randomize=True")
        d["angles"] = torch.tensor(_FIXED_ANGLES[:n_interferers], dtype=torch.float32)
    if snr_db < 50.0:  # 50: the reference's effectively noiseless default
        d["noise"] = _normal(g, (n_mics, n_samples), _CPU)
    return d


def _stack(draws: list, key: str, device) -> torch.Tensor:
    return torch.stack([d[key] for d in draws]).to(device)


def _room_scenes(pos_u, noise, sources: torch.Tensor, room: RoomConfig, snr_db: float,
                 fs: int) -> dict:
    """sim.scene's room render for a batch of scenes: ``sources`` (B, 1 + K,
    n), ``pos_u`` (B, K - 1, 2) uniforms or None, ``noise`` (B, M, n). Every
    (source, mic) RIR of the batch in one pass."""
    dev = sources.device
    B, S, n = sources.shape
    K = S - 1

    def fixed(p):
        return torch.tensor(p, dtype=torch.float32, device=dev).expand(B, 1, 3)

    rows = [fixed(room.target_pos)]
    if K >= 1:
        rows.append(fixed(room.interferer_pos_fixed))
    if K >= 2:
        dims = torch.tensor(room.room_dim, dtype=torch.float32, device=dev)
        rnd = 1.0 + pos_u * (dims[:2] - 2.0)
        rows.append(torch.cat([rnd, torch.full_like(rnd[..., :1], 1.5)], dim=-1))
    absorption, order = _absorption_order(room, True, None)
    rirs = rir_matrix(torch.cat(rows, dim=1).reshape(-1, 3), room.mic_locs, room.room_dim,
                      absorption, order, fs, min(int(0.6 * fs), n))
    rirs = rirs.reshape(B, S, *rirs.shape[1:])  # (B, S, M, L)
    wet = fft_convolve(sources[:, :, None, :], rirs, n)  # (B, S, M, n)
    target = wet[:, 0]
    if K:
        interf = apply_sir_gain(target[:, 0], wet[:, 1:].sum(dim=1), room.sir_target_db)
    else:
        interf = torch.zeros_like(target)
    noisy = _awgn(target + interf, noise, snr_db)
    peak = noisy.abs().amax(dim=(-2, -1)) + 1e-9  # (B,)
    return {"mixture": noisy / peak[:, None, None], "target_ref": target[:, 0] / peak[:, None],
            "interference_ref": interf[:, 0] / peak[:, None]}


def sweep_scenes(seed: int, cfg: PipelineConfig, n_scenes: int = 16, n_samples: int = 32_000,
                 n_interferers: int = 2, reverb: bool = False, randomize: bool = False,
                 room: RoomConfig = ROOM_DEFAULT, interferer_kind: str = "speech",
                 snr_db: float = 50.0, scene_offset: int = 0, device=None) -> dict:
    """The draw step: scenes ``scene_offset`` .. ``scene_offset + n_scenes -
    1`` of the campaign ``seed`` as one batch: ``mixture`` (B, M, n) and the
    stems ``target_ref`` and ``interference_ref`` (B, n) at mic 0, on
    ``device`` (CUDA unless it names another). Far-field scenes at the
    target's ``cfg.angle_target_deg`` with the fixed or randomized interferer
    angles (AWGN per mic below 50 dB SNR), or with ``reverb`` the room (its
    array set to cfg's, its second and later interferers at random places)."""
    dev = resolve_device(device)
    if reverb:
        room = _sweep_room(cfg, room)
    M = len(room.mic_locs) if reverb else cfg.n_mics
    draws = [_draw(scene_generator(seed, scene_offset + i), cfg, n_samples, n_interferers,
                   reverb, randomize, M, interferer_kind, snr_db, dev) for i in range(n_scenes)]
    walk, u1, u2, noise = (torch.stack(t).to(dev) for t in zip(*(d["speech"] for d in draws)))
    sources = _speech_render(walk, u1, u2, noise, n_samples, cfg.fs, _stack(draws, "f0", dev)
                             [:, :walk.shape[1]])
    if interferer_kind != "speech":
        sources = torch.cat([sources, _stack(draws, "others", dev)], dim=1)
    if reverb:
        pos_u = _stack(draws, "pos_u", dev) if n_interferers >= 2 else None
        return _room_scenes(pos_u, _stack(draws, "noise", dev), sources, room, snr_db, cfg.fs)
    sc = make_scene(sources[:, 0], sources[:, 1:], cfg.angle_target_deg,
                    _stack(draws, "angles", dev), cfg.mic_dist, cfg.fs, c=cfg.c,
                    n_mics=cfg.n_mics, positions=cfg.geometry())
    if snr_db < 50.0:
        sc["mixture"] = _awgn(sc["mixture"], _stack(draws, "noise", dev), snr_db)
    return sc


def score_scenes(out: torch.Tensor, scenes: dict, cfg: PipelineConfig,
                 with_stoi: bool) -> dict:
    """Per-scene metrics (B,) of the enhanced ``out`` (B, n): sir_in, sinr_in
    (mic 0 of the mixture), sir_out, sir_imp, sinr_out, and with
    ``with_stoi`` the STOI against the target stem."""
    sinr_out, sir_out = osinr_osir(out, scenes["target_ref"], scenes["interference_ref"])
    sinr_in, sir_in = osinr_osir(scenes["mixture"][..., 0, :], scenes["target_ref"],
                                 scenes["interference_ref"])
    res = {"sir_in": sir_in, "sinr_in": sinr_in, "sir_out": sir_out,
           "sir_imp": sir_out - sir_in, "sinr_out": sinr_out}
    if with_stoi:
        res["stoi"] = stoi(scenes["target_ref"], out, cfg.fs)
    return res


def _finish(out: torch.Tensor, scenes: dict, cfg, with_stoi: bool, with_waveforms: bool) -> dict:
    res = score_scenes(out, scenes, cfg, with_stoi)
    if with_waveforms:
        res["enhanced"] = out
        res["target"] = scenes["target_ref"]
    return res


def oracle_step(scenes: dict, cfg: PipelineConfig, with_stoi: bool = False,
                with_waveforms: bool = False, post_filter: str = "binary") -> dict:
    """The oracle sweep's enhance-and-score step on a batch of scenes (on
    their device): one batched ``oracle_enhance``, then the metrics."""
    out = oracle_enhance(scenes["mixture"], scenes["target_ref"], scenes["interference_ref"],
                         cfg, post_filter=post_filter)
    return _finish(out, scenes, cfg, with_stoi, with_waveforms)


def learned_step(scenes: dict, cfg: PipelineConfig, model, with_stoi: bool = True,
                 beamformer: str = "mvdr", feature_kind: str = "logmag_ipd",
                 with_waveforms: bool = False, steer_error_deg: float = 0.0,
                 train_mic_dist: float | None = None, dsp_precision: str = "exact",
                 harmonic_regen: bool = False) -> dict:
    """The learned sweep's enhance-and-score step: one batched
    ``learned_enhance`` steered ``steer_error_deg`` off the true target,
    then the metrics against the true stems."""
    enh_cfg = cfg.replace(angle_target_deg=cfg.angle_target_deg + steer_error_deg)
    out = learned_enhance(scenes["mixture"], model, enh_cfg, beamformer=beamformer,
                          feature_kind=feature_kind, train_mic_dist=train_mic_dist,
                          dsp_precision=dsp_precision, harmonic_regen=harmonic_regen)
    return _finish(out, scenes, cfg, with_stoi, with_waveforms)


def oracle_sweep(seed: int, cfg: PipelineConfig, n_scenes: int = 16, n_samples: int = 32_000,
                 with_stoi: bool = False, n_interferers: int = 2, reverb: bool = False,
                 randomize: bool = False, room: RoomConfig = ROOM_DEFAULT,
                 with_waveforms: bool = False, interferer_kind: str = "speech",
                 snr_db: float = 50.0, post_filter: str = "binary", scene_offset: int = 0,
                 device=None) -> dict:
    """Draw, enhance with the oracle mask and score ``n_scenes`` scenes.

    The defaults are the reference's: anechoic, 2 interferers at the fixed
    40 / 130 deg geometry; ``randomize``, ``reverb`` and ``n_interferers``
    open the robustness envelope. Returns per-scene (B,) float32 tensors
    sir_in, sinr_in, sir_out, sir_imp, sinr_out (+ stoi; ``with_waveforms``
    adds the (B, n) ``enhanced`` and ``target`` for host-side PESQ), on
    ``device`` (CUDA unless it names another)."""
    scenes = sweep_scenes(seed, cfg, n_scenes, n_samples, n_interferers, reverb, randomize,
                          room, interferer_kind, snr_db, scene_offset, device)
    return oracle_step(scenes, cfg, with_stoi, with_waveforms, post_filter)


def learned_sweep(seed: int, cfg: PipelineConfig, model, n_scenes: int = 16,
                  n_samples: int = 32_000, with_stoi: bool = True, n_interferers: int = 2,
                  reverb: bool = True, randomize: bool = True, room: RoomConfig = ROOM_DEFAULT,
                  beamformer: str = "mvdr", feature_kind: str = "logmag_ipd",
                  with_waveforms: bool = False, steer_error_deg: float = 0.0,
                  interferer_kind: str = "speech", train_mic_dist: float | None = None,
                  snr_db: float = 50.0, dsp_precision: str = "exact",
                  harmonic_regen: bool = False, scene_offset: int = 0, device=None) -> dict:
    """The blind learned-mask campaign: scenes (reverberant by default, the
    reference's RT60 0.5 s / 2-interferer configuration) enhanced by the
    mask net ``model`` (the port's nets hold their weights: no
    ``variables``) and ``beamformer``, then scored. ``steer_error_deg``
    steers the enhancement off the true target (camera pointing error);
    ``dsp_precision`` is checked and selects nothing. Runs on ``device``,
    by default the model's; the model must be there."""
    dev = _model_device(model) if device is None else torch.device(device)
    scenes = sweep_scenes(seed, cfg, n_scenes, n_samples, n_interferers, reverb, randomize,
                          room, interferer_kind, snr_db, scene_offset, dev)
    return learned_step(scenes, cfg, model, with_stoi, beamformer, feature_kind,
                        with_waveforms, steer_error_deg, train_mic_dist, dsp_precision,
                        harmonic_regen)


def _gather_processes(parts: dict[int, dict]) -> dict[int, dict]:
    """Every rank's shards' results, on every rank (host copies)."""
    import torch.distributed as dist

    local = {j: {k: v.cpu() for k, v in p.items()} for j, p in parts.items()}
    every: list = [None] * dist.get_world_size()
    dist.all_gather_object(every, local)
    return {j: p for r in every for j, p in r.items()}


def sharded_sweep(sweep_fn: Callable[..., dict], seed: int, mesh: Mesh, n_scenes: int,
                  *args: Any, **kwargs: Any) -> dict:
    """Run ``sweep_fn(seed, *args, n_scenes=..., scene_offset=..., device=...,
    **kwargs)`` (:func:`oracle_sweep`, :func:`learned_sweep`) with its scene
    axis split over ``mesh``: shard j makes, enhances and scores scenes j *
    B / n .. (j + 1) * B / n - 1 on its device, with that device's replica of
    every ``nn.Module`` argument (the net). Every distinct device's shards
    run in a thread of their own, issued together; an exception in any
    shard is raised. On a mesh spanning processes (multihost) each process
    runs its own shards and the metrics are all-gathered, so every rank
    holds the whole dict. Returns the per-scene tensors in scene order on
    this process's first mesh device, equal to the unsharded sweep."""
    if n_scenes % mesh.size != 0:
        raise ValueError(f"n_scenes={n_scenes} must divide over {mesh.size} devices")
    offset = kwargs.pop("scene_offset", 0)
    runs = shard_ranges(n_scenes, mesh)
    reps = {i: replicated(mesh, a) for i, a in enumerate(args) if isinstance(a, torch.nn.Module)}
    kreps = {k: replicated(mesh, a) for k, a in kwargs.items() if isinstance(a, torch.nn.Module)}
    local = [j for j in range(mesh.size) if mesh.is_local(j)]

    def job(j: int):
        d = mesh.devices[j]
        a = [reps[i][d] if i in reps else x for i, x in enumerate(args)]
        kw = {k: (kreps[k][d] if k in kreps else v) for k, v in kwargs.items()}
        return lambda: sweep_fn(seed, *a, n_scenes=len(runs[j]),
                                scene_offset=offset + runs[j].start, device=d, **kw)

    parts = dict(zip(local, run_on_devices([(mesh.devices[j], job(j)) for j in local])))
    if mesh.owners is not None:
        parts = _gather_processes(parts)
    home = mesh.devices[local[0]]
    return {k: torch.cat([parts[j][k].to(home) for j in range(mesh.size)])
            for k in parts[local[0]]}


def sweep_summary(results: dict) -> dict:
    """Aggregate a sweep's per-scene metrics, masking non-finite entries:
    mean, std, min, max over the finite ones, their count ``n`` and
    ``n_failed`` (float32, as the reference)."""
    out = {}
    for name, v in results.items():
        v = torch.as_tensor(v, dtype=torch.float32).cpu()
        ok = torch.isfinite(v)
        n_ok = ok.sum()
        mean = torch.where(ok, v, 0.0).sum() / n_ok.clamp(min=1)
        var = torch.where(ok, (v - mean) ** 2, 0.0).sum() / n_ok.clamp(min=1)
        out[name] = {
            "mean": float(mean),
            "std": float(torch.sqrt(var)),
            "min": float(torch.where(ok, v, torch.inf).min()),
            "max": float(torch.where(ok, v, -torch.inf).max()),
            "n": int(n_ok),
            "n_failed": int((~ok).sum()),
        }
    return out
