"""On-the-fly training data: scene synthesis is the input pipeline
(counterpart of azoom.train.data).

A batch is drawn, mixed, transformed (STFT, features) and labelled (the
oracle IBM of the target) in one call, on the device, as the reference's
jitted ``synth_batch`` does. Geometry as the reference: the target at 90
deg, interferers at 40 and 130 deg (``TRAIN_ANGLES``), optionally jittered;
or, with ``reverb``, image-source room scenes in ``RoomConfig()``, rendered
as ``sim.scene.simulate_room_scene`` renders one, for the whole batch at
once (``parallel.sweep``'s room render, held to the per-scene one in
tests/test_torch_sweep.py).

Randomness: a ``seed`` (int) and the training ``step`` stand where the
reference takes a JAX key. Scene i of step s draws from its own CPU
``torch.Generator`` seeded from (seed, s, i) alone, as the sweeps seed
scene i from (seed, i) (``parallel.sweep``), so a resumed run draws the same
batches with no generator state in its checkpoint, and the card and the CPU
render the same draws. A scene's draws come in this order: the sources'
pitches (100-280 Hz), the speech draws, the other interferer classes (drawn
and rendered one by one), then the mixing draws (the angle jitter, or the
room's random interferer position and sensor noise).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from azoom_torch.config import ROOM_DEFAULT, PipelineConfig, resolve_device
from azoom_torch.dsp.stft import stft
from azoom_torch.masks.features import logmag_ipd_features, physics_aware_features
from azoom_torch.masks.oracle import ibm_target_mask
from azoom_torch.parallel.sweep import _room_scenes
from azoom_torch.sim.farfield import _delayed_images
from azoom_torch.sim.signals import (
    _normal,
    _speech_draws,
    _speech_render,
    _uniform,
    interferer_signal,
)

__all__ = ["synth_batch", "mix_batch", "TRAIN_ANGLES", "batch_generators"]

TRAIN_ANGLES = (90.0, 40.0, 130.0)  # target, interferer 1, interferer 2
_CPU = torch.device("cpu")


def batch_generators(seed: int, step: int, batch_size: int) -> list[torch.Generator]:
    """The CPU generators of the scenes of step ``step`` of the run ``seed``:
    scene i's is a function of (seed, step, i) alone."""
    gens = []
    for i in range(batch_size):
        state = np.random.SeedSequence([int(seed), int(step), i]).generate_state(2, np.uint32)
        gens.append(torch.Generator().manual_seed(int(state[0]) << 31 | int(state[1]) >> 1))
    return gens


def _mix_draws(g: torch.Generator, reverb: bool, jitter: float, n_mics: int, n: int) -> dict:
    if reverb:  # the second interferer's place in the room, then the sensor noise
        return {"pos_u": _uniform(g, (1, 2), _CPU), "noise": _normal(g, (n_mics, n), _CPU)}
    u = _uniform(g, (3,), _CPU)
    return {"angles": torch.tensor(TRAIN_ANGLES) + jitter * (2.0 * u - 1.0)}


def _far_field(sources: torch.Tensor, angles: torch.Tensor, cfg: PipelineConfig) -> dict:
    """sim.farfield.make_scene with one set of the three angles per scene."""
    imgs = _delayed_images(sources, angles.to(sources.device), cfg.mic_dist, 343.0, 2, cfg.fs)
    mixture = imgs.sum(dim=-3)
    peak = mixture.abs().amax(dim=(-2, -1), keepdim=True) + 1e-9
    return {"mixture": mixture / peak, "target_ref": imgs[:, 0, 0] / peak[:, 0],
            "interference_ref": imgs[:, 1:, 0].sum(dim=-2) / peak[:, 0]}


def mix_batch(seed: int, sources, cfg: PipelineConfig, feature_kind: str = "logmag_ipd",
              angle_jitter_deg: float = 0.0, pad_multiple: int = 16, reverb: bool = False,
              reverb_max_order: int = 5, step: int = 0, generators=None, device=None) -> dict:
    """A training batch from given sources (B, 3, n) (target, two
    interferers): the corpus path. Each scene's mixing draws come from its
    generator (``generators``, else :func:`batch_generators` of (seed,
    step)). Returns ``features`` (B, F, T, C) (C = 2 for 'logmag_ipd', 4 for
    'physics'; T zero-padded to a multiple of ``pad_multiple``), ``label``
    (B, F, T) the oracle IBM (padded frames 0), ``mixture`` (B, M, n) and the
    stems ``target_ref`` / ``interference_ref`` (B, n) at mic 0, on
    ``device`` (CUDA unless it names another)."""
    if feature_kind not in ("logmag_ipd", "physics"):
        raise ValueError(f"unknown feature_kind {feature_kind!r}")
    dev = resolve_device(device)
    if not torch.is_tensor(sources):
        sources = torch.from_numpy(np.array(sources, dtype=np.float32))
    sources = sources.to(device=dev, dtype=torch.float32)
    B, _, n = sources.shape
    gens = generators if generators is not None else batch_generators(seed, step, B)
    room = dataclasses.replace(ROOM_DEFAULT, max_order=reverb_max_order)
    draws = [_mix_draws(g, reverb, angle_jitter_deg, len(room.mic_locs), n) for g in gens]
    if reverb:
        sc = _room_scenes(torch.stack([d["pos_u"] for d in draws]).to(dev),
                          torch.stack([d["noise"] for d in draws]).to(dev), sources, room, 50.0,
                          cfg.fs)
    else:
        sc = _far_field(sources, torch.stack([d["angles"] for d in draws]), cfg)
    mix = sc["mixture"]
    Y = stft(mix, cfg.n_fft, cfg.hop)
    feats = logmag_ipd_features(Y) if feature_kind == "logmag_ipd" else physics_aware_features(Y)
    label = ibm_target_mask(stft(sc["target_ref"], cfg.n_fft, cfg.hop),
                            stft(sc["interference_ref"], cfg.n_fft, cfg.hop))
    pad_t = (-feats.shape[2]) % pad_multiple
    if pad_t:
        feats = torch.nn.functional.pad(feats, (0, 0, 0, pad_t))
        label = torch.nn.functional.pad(label, (0, pad_t))
    return {"features": feats, "label": label.to(torch.float32), "mixture": mix,
            "target_ref": sc["target_ref"], "interference_ref": sc["interference_ref"]}


def synth_batch(seed: int, batch_size: int, cfg: PipelineConfig,
                feature_kind: str = "logmag_ipd", n_samples: int = 32_000,
                angle_jitter_deg: float = 0.0, pad_multiple: int = 16, reverb: bool = False,
                reverb_max_order: int = 5, interferer_kind: str = "speech", step: int = 0,
                device=None) -> dict:
    """One training batch of synthesized scenes (step ``step`` of the run
    ``seed``): a speech-like target and two interferers of class
    ``interferer_kind`` ('speech', 'babble', 'music', 'noise', or 'mixed': a
    class drawn per interferer), each with a pitch in 100-280 Hz; then
    :func:`mix_batch`'s mixing, features and labels (same keys)."""
    dev = resolve_device(device)
    gens = batch_generators(seed, step, batch_size)
    f0s, speech, others = [], [], []
    for g in gens:
        f0 = 100.0 + 180.0 * _uniform(g, (3,), _CPU)
        f0s.append(f0)
        if interferer_kind == "speech":
            speech.append(_speech_draws(g, n_samples, (3,), _CPU))
        else:
            speech.append(_speech_draws(g, n_samples, (1,), _CPU))
            others.append(torch.stack([
                interferer_signal(g, n_samples, cfg.fs, interferer_kind, float(f0[i]), device=dev)
                for i in (1, 2)]))
    walk, u1, u2, noise = (torch.stack(t).to(dev) for t in zip(*speech))
    sources = _speech_render(walk, u1, u2, noise, n_samples, cfg.fs,
                             torch.stack(f0s).to(dev)[:, :walk.shape[1]])
    if others:
        sources = torch.cat([sources, torch.stack(others)], dim=1)
    return mix_batch(seed, sources, cfg, feature_kind, angle_jitter_deg, pad_multiple, reverb,
                     reverb_max_order, step, gens, dev)
