#!/usr/bin/env python3
"""Smoke run of azoom_torch, the PyTorch/CUDA port, on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own line(s):
  1. build   - compile every CUDA kernel of the port with nvcc (sm_90a: the
               int8 kernels run wgmma), in parallel, into azoom_torch/_build/;
               print the card.
  2. mvdr    - the fused masked-MVDR kernel against its plain PyTorch version
               at the serving shape (128 streams, 2 mics, 513 bins, 64 frames),
               with a scalar and a per-bin sigma; then at the server's tick
               (65 frames) with 128 distinct steers and zooms (a steering
               vector and a loading per stream), and the shared-steering
               launch bit for bit against the per-stream launch given that
               steering in every stream.
  3. qconv   - the int8 3x3 conv against its plain version at each of the ten
               conv shapes of the bundled tpufpu_nano net at batch 128, with
               and without a residual (the wgmma route at nine shapes, the
               narrow route at the 16-channel stem, held bit for bit against
               the plain version and the mma.sync kernel: the wrapper picks
               by shape); torch._int_mm on explicitly im2col'd int8 operands
               is timed beside it as the bare GEMM. Then every conv of the
               net (with and without a residual, and the concat convs) at the
               frame families of the server's full tick (80 / 40 / 20 / 10)
               and reuse tick (48 / 24 / 12 / 6), with each shape's route,
               the elements that differ from the plain version and the
               kernel's time; the reuse tick's 256 -> 256 at 6 frames runs on
               the split route and the stem on the narrow route, both held
               bit for bit against the plain version and the mma.sync kernel
               and timed beside the plain version and torch._int_mm.
  4. convt   - the upsampling kernel against its plain version at the net's
               three upsampling shapes, with the count of elements that are
               not bit-equal to it (the plain version rounds twice on rare
               ties); kernel and torch.addmm timed as CUDA-graph replays;
               then at the two server frame families.
  5. main    - the user's path: load_bundled("tpufpu_nano") and
               learned_enhance on a (128, 2, 32000) mixture made from a seed,
               steered to 60 deg. The launch counts of that one call must show
               every kernel of the path; the first 4 chunks must agree with
               the same call on the CPU plain path; the median time per call
               is taken after warm-up.
  6. profile - torch.profiler over one main-path call: device time by
               kernel and the device's idle share (chiprun_out/profile.txt).
  7. hard_null - the fused hard-null kernel against its float64 plain version
               at (128, 2, 513, 64) on a far-field speech-like scene at rms
               0.1, and on it x1e-2, x1e2, x2^-7 and x2^7, at cond thresholds
               1 + 1e-6, 10 and 1e6; the output's scale covariance; the
               kernel timed as CUDA-graph replays.
  8. int8_mm - the int8 matmul: the microbenchmark path (one launch at each
               (M, K, N) of scripts/microbench_{pallas_mm,int8,int8b}.py),
               then each product held exactly against the plain version;
               torch._int_mm timed beside it (its column-major w is made
               outside the timing; int8_mm's transpose of w is inside). Both
               are timed as replays of a CUDA graph of 20 calls: kernel time,
               without the host's share of a call.
  9. main_hard_null - learned_enhance(beamformer="hard_null", steer_deg=60,
               fov_deg=30) at (128, 2, 32000): launch counts, the first 4
               chunks against the CPU, the median time per call, and a
               profile of one call (chiprun_out/profile_hard_null.txt).
 10. stream  - learned_enhance_streaming(beamformer="hard_null") over one 60 s
               recording (59 chunks): equal to the batched call over
               chunk_signal's chunks, overlap-added; a 6 s prefix against the
               CPU; the time per recorded second.
 11. oracle  - oracle_enhance(post_filter="irm") on 128 far-field scenes:
               one MVDR launch; waveform and SIR against the CPU.
 12. server  - AudioZoomServer(128, win_size=32768, mask_reuse=True,
               wire="int16", track=True) on 128 far-field scenes, each stream
               steered and zoomed its own way: a prime, then one-hop ticks;
               the launches of every tick (a reuse tick: 21 convs, 4 of them
               on the split route and the stem on the narrow route, 3
               upsamplings, 1 MVDR); the first 4
               streams against the CPU
               port's server on the same blocks (waveform and bearings);
               the median ms per tick, the bytes moved each way per tick and
               the streams served in real time at that tick; a profile of one
               tick (chiprun_out/profile_server.txt). Then the same with
               mask_reuse=False and the float32 wire.
 13. facade  - AudioZoom(model="tpufpu_nano", int8=True): enhance() of a 2 s
               clip (autosteer: the DOA histogram, then the learned path with
               the FOV gate) and push() of 6 s with tracker="momentum", each
               against the same calls on the CPU; ms per call and per window.
 14. tracked - a 128 s moving talker made with numpy (target gliding 60 -> 120
               deg, interferers fixed at 30 and 150 deg, 4 cm; 127 chunks):
               tracked_autosteer_enhance with each tracker (viterbi, causal,
               momentum, momentum_causal, ema) on the heuristic path, bearings
               equal to and waveform against the CPU port's on the whole clip;
               each tracker alone on the clip's (127, 181) histograms, on the
               card and on the host; the learned path with MVDR and hard-null
               (21 convs, 3 upsamplings, ONE beamformer launch for the whole
               clip; a 6 s prefix against the CPU; ms per recorded second);
               AudioZoom(model="tpufpu_nano", int8=True, track=True).enhance
               of the clip; a profile of one learned MVDR call
               (chiprun_out/profile_tracked.txt). Then B3 per chunk at
               (128, 2, 513, 64) with 128 steers against its plain version,
               the shared launch bit for bit against the per-chunk launch
               given that steering in every chunk, and its time as CUDA-graph
               replays.
 15. hrnr    - learned_enhance(harmonic_regen=True) at (128, 2, 32000) on the
               far-field scenes of phase 7, MVDR and hard-null: launch counts,
               the first 4 chunks against the CPU, the median ms per call; a
               profile of the HRNR stage alone (chiprun_out/profile_hrnr.txt).
 16. nets    - every bundled conv net. The int8 conv at each conv shape of
               fpu and deepfpu (unfolded 513-row planes: stems of Cin 2 and 4,
               Cout 32, Cout 512 at 4 frames) and of tpufpu and tpufpu_slim
               (129 rows) at batch 128, with its route (wgmma, narrow or
               split; none on mma.sync), bit for bit against the plain
               version (and a narrow- or split-route shape against the
               mma.sync kernel too), timed beside torch._int_mm on im2col'd
               int8. Then each of the
               seven artifacts, int8 and float (its convs float32 matrix
               products, TF32 off), on the learned MVDR path at (128, 2, 32000)
               on phase 7's scenes: launch counts and conv kernels, chunk 0
               against the CPU (int8: the waveform; float: the mask to 1e-5),
               the median ms per call. AudioZoom(model="fpu_multigeo") (float, the
               reference's default) enhance() of 2 s against the CPU; then
               AudioZoomServer(128, model="fpu", mask_reuse=True,
               wire="int16"): a prime (80 frames) and 4 reuse ticks (48), the
               launches and routes of each, the first 2 streams against a
               CPU server.
 17. lowlat  - the low-latency path with the bundled causal crn_causal net. The
               online_mvdr kernel against its plain loop at (2, 513, 1875)
               with a floored target mask (output and carried state); one
               launch over T bit for bit against T one-frame launches with
               the state carried; its time as CUDA-graph replays beside the
               byte bound and the chain floor. online_learned_enhance on a
               numpy-seeded 60 s clip: ONE online_mvdr launch, ms per
               recorded second, a profile of its first 10 s
               (chiprun_out/profile_lowlat.txt),
               the first 6 s against the CPU port (the CRN mask to 1e-5:
               TF32 off; the waveform's relative L2 stated). OnlineEnhancer
               over 10 s pushed hop by hop: ms per push, online_mvdr launches
               and device kernels per hop, equality with the card's offline
               output on the finalized samples. AudioZoom(latency="low",
               track=True) pushing 6 s: bearings equal to and waveform
               against the CPU port.
 18. mmic    - arrays of more than two mics (a 4-mic linear array at 4 cm; the
               reference runs its 2-mic Pallas kernels at M = 2 only, XLA
               above): beam.linalgmm's solve and Jacobi EVD on 128 x 513
               systems at M = 4 and 8 against the CPU port; learned_enhance at
               M = 4 with the int8 tpufpu_nano, (128, 4, 32000), MVDR and
               hard-null with 3 nulls: B2 and convt1x2 launched as in phase 5,
               B1 and B3 not at all (the M-mic beamformers run in torch on
               the card), the first 4 chunks against the CPU, ms per call;
               AudioZoom(n_mics=4, model="fpu").enhance of 2 s against the
               CPU; AudioZoomServer(128) on a 4-mic rectangle, a prime and 3
               ticks, the first 2 streams against a CPU server; the M-general
               online_mvdr instance at (4, 513, 1875) against its plain loop
               from a warmed state, one launch bit for bit against 1,875
               one-frame launches, its time as CUDA-graph replays; a 60 s
               online_learned_enhance at M = 4 (ONE online_mvdr_mmic launch,
               a 6 s prefix against the CPU) and OnlineEnhancer over 10 s hop
               by hop (one launch a hop, equal to the card's offline output).
 19. beamformers - the reference's other beamformers and dereverberation,
               torch code on the card as the reference's are XLA (no kernel
               of their own). learned_enhance with the int8 tpufpu_nano at
               (128, 2, 32000) on phase 7's scenes with rmvb, rtf and wpd,
               and wpd with harmonic_regen and fov_deg=30: B2 and convt1x2
               launched as in phase 5, B1 and B3 not at all; the first 4
               chunks against the CPU; the median ms per call; a profile of
               one wpd call and one rmvb call (chiprun_out/profile_wpd.txt,
               profile_rmvb.txt: the batched solves' share of the device
               time, the bisection's launches). The three at M = 4 (phase
               18's 4-mic line) with the float fpu against the CPU;
               tracked_autosteer_enhance(beamformer="rmvb") on phase 14's
               clip (bearings equal to the CPU port's, a 6 s prefix against
               it); wpe_dereverb of a numpy-seeded 10 s two-channel clip (a
               dry far-field mixture through a decaying tail) and duet_masks
               at (128, 2, 513, 64), each against the CPU.
 20. native_stream - AudioZoom(model="tpufpu_nano", int8=True) on the card
               pushing a 12 s far-field scene in ragged blocks (1, 7, 160,
               997, 16000 samples, repeated), once on the C++ stream engine
               (native=True, the default: the engine must be in use) and once
               on the NumPy buffer (native=False): the launches of the native
               run (21 convs, 3 upsamplings, 1 MVDR a window), both outputs of
               the same length and within 1e-6; host ms per push that runs no
               window (the buffer alone) and per window for both buffers, the
               buffers alone with the window step on the host; the device time
               of one window (chiprun_out/profile_native_window.txt).
 21. eval    - the measurement layer on the card against the CPU: stoi on three
               10 s clips at 0, 10 and 20 dB SNR (within 1e-5, rising with the
               SNR; the batch of three equal to the clips one by one),
               bss_eval_sources on 3 sources x 4 s at filter_len 512 (within
               0.05 dB), resample_poly 16 -> 10 kHz and resample_fft (within
               1e-5 of the peak); compute_run_metrics on phase 20's output
               against the stems (STOI within 1e-5 of the CPU's, SIR
               improvement positive), its report's lines; ms of each call.
 22. sim     - the port's scene simulation at the reference's full width, its
               random draws from seeded CPU generators (the card and the CPU
               see the same numbers): generate_scene of 4 s with three
               interferers in RoomConfig() (a 4.9 m cube, RT60 0.5 s, image
               order 15, 9,600-tap RIRs) against the CPU (within 1e-3; the
               RIRs at the C++ engine test's bounds; two runs on the card
               bit for bit), ms per scene and a profile
               (chiprun_out/profile_sim.txt); rir_matrix at order 15 for 4
               sources x 2 mics x 9,600 taps against the reference's C++
               engine on the host (same bounds), ms of both; make_scene at
               (128, 3 sources, 2 s, 4 cm) into learned_enhance (int8
               tpufpu_nano, MVDR and hard-null with fov_deg=30) and
               oracle_enhance: the launches (B1, B2, convt1x2, B3), ms and SIR
               of each (the oracle beside the reference's published 36.24
               dB); make_moving_scene of 128 s (a glide 40 -> 140 deg) into
               the learned tracked path: bearings against the trajectory (the
               median within 10 deg), ms; make_moving_room_scene of 4 s at
               order 15 (33 anchors' RIRs in one pass) against the CPU (within
               1e-3), ms; NativeCorpus (the C++ corpus engine) over 64
               synthetic wavs: batches per second beside LocalCorpus.
 23. sweep   - the batch sweeps at full width: oracle_sweep over 128 randomized
               anechoic 2 s scenes at 4 cm with STOI (one B1 launch), and
               learned_sweep over 128 reverberant 2 s scenes in RoomConfig()
               (RT60 0.5 s, order 15, 2 interferers) with the int8
               tpufpu_nano net and hard-null (B2 per route, convt1x2, B3):
               launches (after a warm-up at 128 scenes), scenes per second
               (median of 5 sweeps), the steps' shares (synthesis,
               enhancement, scoring) from the median of 5 runs synchronised
               between steps, a profile's idle share
               (chiprun_out/profile_sweep_{oracle,learned}.txt), the first 4
               scenes against the CPU (metrics within 0.05 dB, STOI within
               1e-4), sharded_sweep on ["cuda:0", "cuda:0"] against one
               shard; a mesh of two distinct devices, ["cuda:0", "cpu"]
               (a thread each): both sweeps and the learned chunker against
               the card alone, and a failing shard raising; phase 12's server (reuse, int16, tracking) on two
               shards of the card against one (relative 1e-4), tick ms of
               both; initialize() of a one-process NCCL group and a
               sharded_sweep over global_data_mesh() against the unsharded
               sweep.
 24. train   - training (models.trainable, train.loop): one step of the
               tpufpu_nano architecture at batch 2 from the same init and
               batch on the card and the CPU in float32 and on the card in
               float64, each leaf held on its own (train/rounding.py: every
               gradient's relative L2 distance from float64 within
               GRAD_BOUND on both devices, each BatchNorm statistic's update
               and the loss on the card within 3x the CPU's + 1e-6); the
               median ms of a step (5 after 2 warm-ups) and the
               peak memory of each bundled architecture at its published
               widths (tpufpu_nano warm-started from its artifact, tpufpu,
               tpufpu_slim, fpu, deepfpu with and without remat, crn_causal)
               at batch 16 on 2 s crops (513 bins, 64 frames); a 6-step fit
               checkpointed every 3 against 3 steps resumed to 6 (the largest
               difference, expected 0); the trained nano net calibrated on the
               card (calibrate_act_scales: every conv on the int8 kernel),
               exported (save_quantized), reloaded and served by
               learned_enhance at (128, 2, 32000) on phase 7's scenes:
               launches and routes as in phase 5, its SIR gain beside the
               bundled net's, and its 21 convs bit for bit against their plain
               version on 4 chunks.
Then one JSON line with every kernel's numbers (B1 twice: masked_mvdr is the
shared form at 64 frames with phase 5's launches, masked_mvdr_per_stream the
server's form at 65 frames with the launches of phase 12's reuse ticks; ms
is a loop of calls from Python for both; B2 seven times: qconv3x3 is the
tpufpu_nano net of phase 3 with phase 5's launches, qconv3x3_<net> the conv
set of fpu, deepfpu, tpufpu and tpufpu_slim with the launches of that int8
net's phase-16 run, qconv3x3_split the split route's four convs of the
reuse tick's net (phase 3's 48-frame family) with the split launches of
phase 12's reuse ticks, qconv3x3_narrow the narrow route's convs of those
four conv sets (the stems and Cout = 32) with the narrow launches of their
phase-16 int8 runs; B3 twice: hard_null shared with
phase 9's launches, hard_null_per_chunk with the launches of phase 14's
learned hard-null run; online_mvdr at one 60 s clip with phase 17's
launches; online_mvdr_mmic, the M-general instance, at a 60 s 4-mic clip
with phase 18's launches), the card's name and power limit, and a last line
{"ok": true, "device": {...}}.

Any failed check raises, so the script exits non-zero and prints no result.
Without CUDA it exits non-zero at once. Imports nothing of JAX or azoom.
"""

from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
INT8_OPS_PER_S = 1979e12    # H100 SXM dense int8 tensor cores
FP32_FLOPS_PER_S = 67e12    # H100 SXM float32, outside the tensor cores
FP64_FLOPS_PER_S = 34e12    # H100 SXM float64, outside the tensor cores
BATCH = 128                 # 2 s chunks per call (the serving batch)
N_SAMPLES = 32_000          # one 2 s chunk at 16 kHz
F_ROWS = 129                # folded frequency rows: ceil(513 / 4)



def nano_convs(t: int) -> list:
    """The 21 int8 convs of tpufpu_nano in forward order at t input frames:
    (Cin, Cout, frames, with residual, input is a two-tensor channel concat)."""
    h, q, e = t // 2, t // 4, t // 8
    return (
        [(16, 64, t, False, False), (64, 64, t, False, False)]                 # e1
        + [(64, 64, h, False, False), (64, 64, h, False, False), (64, 64, h, True, False)]
        + [(64, 128, q, False, False), (128, 128, q, False, False), (128, 128, q, True, False)]
        + [(128, 256, e, False, False)]                                      # bottleneck
        + [(256, 256, e, False, False), (256, 256, e, True, False)] * 2
        + [(256, 128, q, False, True), (128, 128, q, False, False), (128, 128, q, True, False)]
        + [(128, 64, h, False, True), (64, 64, h, False, False), (64, 64, h, True, False)]
        + [(128, 64, t, False, True), (64, 64, t, False, False)]               # d1
    )


def nano_convt(t: int) -> list:
    """The 3 upsamplings at t input frames: (K = Cin, Cout, input frames)."""
    return [(256, 128, t // 8), (128, 64, t // 4), (64, 64, t // 2)]


NANO_CONVS = nano_convs(64)   # a 2 s chunk: 64 frames
NANO_CONVT = nano_convt(64)
# The server's frame families at win_size 32768: a full tick runs the net on
# 65 frames padded to 80, a reuse tick on 48 (16 context + 32 new).
SERVER_FRAMES = (80, 48)


def far_field_scene(rng, batch: int, n: int, fs: int = 16_000, mic_dist: float = 0.04,
                    angles=(90.0, 40.0, 130.0), rms: float = 0.1, c: float = 343.0,
                    n_mics: int = 2, positions=None):
    """Speech-like far-field scenes made with numpy: a target and two
    interferers (first angle is the target's; ``angles`` (3,) for all scenes
    or (batch, 3) for one triple each), each low-passed noise under a
    syllable-rate envelope, delayed to the mics by an rFFT phase ramp
    (fractional delays): a linear array of ``n_mics`` at ``mic_dist``, or
    the (M, 2) ``positions`` in meters. Returns float32 (mixture
    (batch, M, n), target_ref (batch, n), interference_ref (batch, n)) at
    mic 0, the mixture scaled to ``rms``."""
    import numpy as np

    f = np.fft.rfftfreq(n, 1.0 / fs)
    t = np.arange(n) / fs
    src = np.fft.irfft(np.fft.rfft(rng.standard_normal((batch, 3, n))) / (1.0 + f / 500.0), n)
    rate = 3.0 + 2.0 * rng.random((batch, 3, 1))
    env = 0.5 * (1.0 + np.sin(2 * np.pi * rate * t + 2 * np.pi * rng.random((batch, 3, 1))))
    src = src * env**2
    src /= np.sqrt(np.mean(src**2, axis=-1, keepdims=True))
    if positions is None:  # mic m at ((M-1)/2 - m) d on the x axis
        x = ((n_mics - 1) / 2 - np.arange(n_mics)) * mic_dist
        positions = np.stack([x, np.zeros(n_mics)], axis=-1)
    theta = np.deg2rad(np.array(angles))
    u = np.stack([np.cos(theta), np.sin(theta)], axis=-1)  # ([batch,] 3, 2)
    tau = u @ np.asarray(positions, np.float64).T / c  # ([batch,] 3, M)
    ramp = np.exp(-2j * np.pi * f * tau[..., None])  # ([batch,] 3, M, F)
    img = np.fft.irfft(np.fft.rfft(src)[:, :, None, :] * ramp, n)  # (batch, 3, M, n)
    mix = img.sum(axis=1)
    g = rms / np.sqrt(np.mean(mix**2))
    return ((mix * g).astype(np.float32), (img[:, 0, 0] * g).astype(np.float32),
            (img[:, 1:, 0].sum(axis=1) * g).astype(np.float32))


def moving_scene(rng, n: int, glide=(60.0, 120.0), interferers=(30.0, 150.0), fs: int = 16_000,
                 mic_dist: float = 0.04, rms: float = 0.1, c: float = 343.0, block: int = 2048):
    """A moving talker with numpy, as azoom's moving-source renderer makes
    one: speech-like sources (as far_field_scene's), the target's azimuth
    gliding linearly from glide[0] to glide[1] over the clip, the
    interferers fixed. Each source is cut into periodic-Hann windows of
    2 * block at a hop of block (the windows sum to one), every window is
    delayed to the 2 mics by an rFFT phase ramp at its block's azimuth, and
    the windows are overlap-added: a crossfade between block anchors.
    Returns the mixture float32 (2, n) at ``rms``."""
    import numpy as np

    f = np.fft.rfftfreq(n, 1.0 / fs)
    t = np.arange(n) / fs
    src = np.fft.irfft(np.fft.rfft(rng.standard_normal((3, n))) / (1.0 + f / 500.0), n)
    rate = 3.0 + 2.0 * rng.random((3, 1))
    src = src * (0.5 * (1.0 + np.sin(2 * np.pi * rate * t + 2 * np.pi * rng.random((3, 1))))) ** 2
    src /= np.sqrt(np.mean(src**2, axis=-1, keepdims=True))
    n_blocks = -(-n // block)
    seg = 2 * block
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(seg) / seg)
    xp = np.pad(src, ((0, 0), (block, (n_blocks + 2) * block - n - block)))
    starts = np.arange(n_blocks + 1) * block
    segs = np.stack([xp[:, s:s + seg] for s in starts]) * w  # (B + 1, 3, seg)
    traj = np.linspace(glide[0], glide[1], n_blocks)
    traj = np.concatenate([traj[:1], traj])  # window b peaks half a block before anchor b
    angles = np.stack([traj] + [np.full(n_blocks + 1, a) for a in interferers], axis=1)
    pos = np.array([mic_dist / 2, -mic_dist / 2])
    tau = pos * np.cos(np.deg2rad(angles))[..., None] / c  # (B + 1, 3, 2)
    fb = np.fft.rfftfreq(seg, 1.0 / fs)
    img = np.fft.irfft(np.fft.rfft(segs)[:, :, None, :]
                       * np.exp(-2j * np.pi * fb * tau[..., None]), seg)  # (B + 1, 3, 2, seg)
    out = np.zeros((2, (n_blocks + 2) * block))
    for b, s in enumerate(starts):
        out[:, s:s + seg] += img[b].sum(axis=0)
    mix = out[:, block:block + n]
    return (mix * (rms / np.sqrt(np.mean(mix**2)))).astype(np.float32)


RECT = ((-0.015, -0.01), (0.015, -0.01), (-0.015, 0.01), (0.015, 0.01))  # a 4-mic rectangle


def phase_mmic(dev, rng, results: dict, time_ms, device_ms, bound) -> dict:
    """Phase 18: arrays of more than two mics (module docstring). ``results``
    gains the kernels line's "online_mvdr_mmic" entry; returns the phase's
    numbers for chip_smoke.json."""
    import numpy as np
    import torch

    from azoom_torch import AudioZoom, AudioZoomServer, kernels
    from azoom_torch.beam.linalgmm import eigh_hermitian_small, solve_hermitian
    from azoom_torch.config import PipelineConfig
    from azoom_torch.dsp.delays import steering_vector
    from azoom_torch.dsp.stft import rfft_freqs
    from azoom_torch.kernels.online_mvdr_kernel import initial_state, online_mvdr, online_mvdr_plain
    from azoom_torch.kernels.qconv_kernel import route_counts
    from azoom_torch.models.pretrained import load_bundled
    from azoom_torch.pipelines.learned import learned_enhance
    from azoom_torch.pipelines.online_learned import online_learned_enhance
    from azoom_torch.stream.lowlat import OnlineEnhancer

    def launched() -> dict:
        return {k: v for k, v in kernels.launches.items() if v}

    def kw_of(kw, t):  # the keywords of the first t frames
        return dict(kw, target_mask=kw["target_mask"][:, :t].contiguous())

    def rel(a, b) -> float:
        return float(np.linalg.norm(np.asarray(a) - np.asarray(b)) / np.linalg.norm(np.asarray(b)))

    mm = {}
    F = 513
    # linalgmm on (BATCH x 513) systems: the card against the CPU port
    for M in (4, 8):
        A = rng.standard_normal((BATCH, F, M, M)) + 1j * rng.standard_normal((BATCH, F, M, M))
        hpd = np.einsum("...ij,...kj->...ik", A, A.conj()) / M
        R = torch.from_numpy((hpd + 0.1 * np.eye(M)).astype(np.complex64))
        Re = torch.from_numpy((hpd + 0.01 * np.eye(M)).astype(np.complex64))
        d = torch.from_numpy((rng.standard_normal((BATCH, F, M))
                              + 1j * rng.standard_normal((BATCH, F, M))).astype(np.complex64))
        Rg, Reg, dg = R.to(dev), Re.to(dev), d.to(dev)
        x_g, x_c = solve_hermitian(Rg, dg).cpu(), solve_hermitian(R, d)
        solve_err = float(((x_g - x_c).abs().amax(-1) / x_c.abs().amax(-1)).max())
        (ev_g, U_g), (ev_c, _) = eigh_hermitian_small(Reg), eigh_hermitian_small(Re)
        scale = ev_c.abs().amax(-1)
        ev_err = float(((ev_g.cpu() - ev_c).abs().amax(-1) / scale).max())
        rec = U_g @ torch.diag_embed(ev_g.to(U_g.dtype)) @ U_g.conj().transpose(-1, -2)
        rec_err = float(((rec - Reg).abs().amax((-2, -1)).cpu() / scale).max())
        # the card against the CPU port to 1e-5 of scale; the EVD's own
        # residual (6 float32 Jacobi sweeps) is the worst of BATCH x 513 systems
        check(max(solve_err, ev_err) <= 1e-5 and rec_err <= 1e-4,
              f"linalgmm M={M}: solve {solve_err:.3e}, eigenvalues {ev_err:.3e} of scale "
              f"(card vs CPU), reconstruction {rec_err:.3e} of scale")
        ms_solve = time_ms(lambda: solve_hermitian(Rg, dg), iters=5)
        ms_eigh = time_ms(lambda: eigh_hermitian_small(Reg), iters=2, warmup=1)
        mm[f"linalgmm_m{M}"] = dict(systems=BATCH * F, solve_err=solve_err, eig_err=ev_err,
                                    reconstruction_err=rec_err, solve_ms=ms_solve,
                                    eigh_ms=ms_eigh)
        log("mmic_linalgmm", M=M, systems=BATCH * F, solve_err_of_scale=f"{solve_err:.3e}",
            eig_err_of_scale=f"{ev_err:.3e}", reconstruction_err=f"{rec_err:.3e}",
            solve_ms=f"{ms_solve:.3f}", eigh_ms=f"{ms_eigh:.3f}")
        del A, hpd, R, Re, d, Rg, Reg, dg, x_g, x_c, ev_g, U_g, rec

    # the learned path at M = 4: the int8 nano net, MVDR and hard-null (3 nulls)
    cfg4 = PipelineConfig(mic_dist=0.04, n_mics=4)
    model, _ = load_bundled("tpufpu_nano")
    model_cpu, _ = load_bundled("tpufpu_nano", device="cpu")
    mix = torch.from_numpy(far_field_scene(rng, BATCH, N_SAMPLES, n_mics=4,
                                           angles=(60.0, 20.0, 130.0))[0])
    mix_g = mix.to(dev)
    for bf, n_nulls in (("mvdr", 1), ("hard_null", 3)):
        kw = dict(beamformer=bf, n_nulls=n_nulls, feature_kind="physics", steer_deg=60.0)
        torch.cuda.synchronize()
        kernels.reset_launches()
        routes_before = dict(route_counts)
        out = learned_enhance(mix_g, model, cfg4, **kw)
        torch.cuda.synchronize()
        counts = launched()
        routes = {k: v - routes_before[k] for k, v in route_counts.items()}
        check(counts == {"qconv3x3": 21, "convt1x2": 3},
              f"M = 4 {bf}: launches {counts} (B2 and convt1x2 as at M = 2, no B1/B3)")
        check(routes == {"wgmma": 20, "narrow": 1, "split": 0, "mma": 0},
              f"M = 4 {bf}: conv kernels {routes}")
        check(out.shape == (BATCH, N_SAMPLES) and bool(torch.isfinite(out).all()),
              f"M = 4 {bf}: bad output")
        wave = rel(out[:4].cpu(), learned_enhance(mix[:4], model_cpu, cfg4, **kw))
        check(wave <= 1e-2, f"M = 4 {bf}: first 4 chunks vs CPU {wave:.3e}")
        ts = []
        for _ in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            learned_enhance(mix_g, model, cfg4, **kw)
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        med = statistics.median(ts[1:])
        mm[f"learned_{bf}"] = dict(launches=counts, routes=routes, ms=ts, ms_median=med,
                                   cpu_first4_wave_rel_l2=wave)
        log("mmic_learned", M=4, beamformer=bf, n_nulls=n_nulls, batch=BATCH, launches=counts,
            conv_kernels=routes, ms_median=f"{med:.3f}", ms_all=[round(t, 2) for t in ts],
            audio_seconds_per_second=f"{BATCH * N_SAMPLES / 16_000 / (med / 1e3):.1f}",
            cpu_first4_wave_rel_l2=f"{wave:.3e}")
    del mix, mix_g, out

    # the facade at M = 4: the reference's M-mic call (float fpu), 2 s
    clip = far_field_scene(rng, 1, N_SAMPLES, n_mics=4, angles=(95.0, 30.0, 140.0))[0][0]
    zkw = dict(cfg=cfg4, model="fpu", direction_deg=90.0)
    z_gpu, z_cpu = AudioZoom(**zkw), AudioZoom(device="cpu", **zkw)
    kernels.reset_launches()
    e_gpu = z_gpu.enhance(clip)
    torch.cuda.synchronize()
    z_counts = launched()
    check(z_counts == {"convt1x2": 3}, f"M = 4 facade launches {z_counts}")
    z_rel = rel(e_gpu, z_cpu.enhance(clip))
    check(e_gpu.shape == (N_SAMPLES,) and z_rel <= 1e-3, f"M = 4 facade vs CPU {z_rel:.3e}")
    z_ts = []
    for _ in range(4):
        t0 = time.perf_counter()
        z_gpu.enhance(clip)
        z_ts.append((time.perf_counter() - t0) * 1e3)
    mm["facade_fpu"] = dict(launches=z_counts, ms=z_ts, wave_rel_l2=z_rel)
    log("mmic_facade", M=4, model="fpu", launches=z_counts,
        ms_median=f"{statistics.median(z_ts[1:]):.3f}", wave_rel_l2=f"{z_rel:.3e}")

    # the server on the rectangle: BATCH streams, a prime and three ticks
    scfg = PipelineConfig(mic_dist=0.04).with_geometry(RECT)
    win, hop = scfg.win_size, scfg.win_size // 2
    s_mix = far_field_scene(rng, BATCH, win + 3 * hop, positions=np.array(RECT))[0]
    srv = {where: AudioZoomServer(S, cfg=scfg, device=where)
           for where, S in (("cuda", BATCH), ("cpu", 2))}
    s_out = [srv["cuda"].push(s_mix[:, :, :win])]
    s_cpu = [srv["cpu"].push(s_mix[:2, :, :win])]
    s_ms, s_counts = [], []
    for k in range(3):
        blk = s_mix[:, :, win + k * hop:win + (k + 1) * hop]
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        s_out.append(srv["cuda"].push(blk))
        s_ms.append((time.perf_counter() - t0) * 1e3)
        s_counts.append(launched())
        if k < 2:
            s_cpu.append(srv["cpu"].push(blk[:2]))
    check(all(c == {"qconv3x3": 21, "convt1x2": 3} for c in s_counts),
          f"M = 4 server tick launches {s_counts}")
    s_rel = rel(np.concatenate(s_out[1:3], axis=1)[:2], np.concatenate(s_cpu[1:], axis=1))
    check(s_rel <= 1e-2, f"M = 4 server: first 2 streams vs CPU {s_rel:.3e}")
    mm["server_rect"] = dict(streams=BATCH, tick_launches=s_counts, tick_ms=s_ms,
                             cpu_first2_wave_rel_l2=s_rel)
    log("mmic_server", geometry="rect4", streams=BATCH, ticks=3, tick_launches=s_counts[-1],
        tick_ms_median=f"{statistics.median(s_ms):.3f}", tick_ms_all=[round(t, 2) for t in s_ms],
        cpu_first2_wave_rel_l2=f"{s_rel:.3e}")
    del srv, s_mix

    # the M-general online_mvdr instance at (4, 513, 1875) against its plain loop
    M, T = 4, 1875
    gen = torch.Generator(device=dev)
    gen.manual_seed(18)
    Y = torch.complex(torch.randn((M, F, T), generator=gen, device=dev),
                      torch.randn((M, F, T), generator=gen, device=dev))
    nmask = torch.rand((F, T), generator=gen, device=dev)
    freqs = rfft_freqs(1024, 16_000, device=dev)
    d = steering_vector(freqs, 60.0, 0.04, n_mics=M)
    kw = dict(target_mask=1.0 - nmask, sigma=1e-7, hp_cutoff_hz=100.0, forget=0.98,
              mask_floor=0.05)
    # from a warmed state: a fresh one is ill-posed on its first frames (R =
    # y y^H + a 1e-6 prime, conditioned ~1e6 at M > 2), where float32 orders differ
    st_k = initial_state((), F, M, dev)
    online_mvdr_plain(Y[..., :64], nmask[:, :64], d, freqs, *st_k, **kw_of(kw, 64))
    st_p = tuple(a.clone() for a in st_k)
    got = online_mvdr(Y, nmask, d, freqs, *st_k, **kw)
    ref = online_mvdr_plain(Y, nmask, d, freqs, *st_p, **kw)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    o_rel = err / float(ref.abs().max())
    st_rel = max(float((a - b).abs().max() / b.abs().max()) for a, b in zip(st_k, st_p))
    check(bool(torch.isfinite(torch.view_as_real(got)).all()), "online_mvdr_mmic: non-finite")
    check(o_rel <= 1e-4 and st_rel <= 1e-5,
          f"online_mvdr_mmic: relative error {o_rel:.3e} (state {st_rel:.3e}) against plain")
    st_1, st_T = initial_state((), F, M, dev), initial_state((), F, M, dev)
    whole = online_mvdr(Y, nmask, d, freqs, *st_T, **kw)
    steps = [online_mvdr(Y[..., t:t + 1].contiguous(), nmask[:, t:t + 1].contiguous(), d, freqs,
                         *st_1, **dict(kw, target_mask=kw["target_mask"][:, t:t + 1].contiguous()))
             for t in range(T)]
    differ = int((torch.cat(steps, dim=-1) != whole).sum())
    differ += sum(int((a != b).sum()) for a, b in zip(st_1, st_T))
    check(differ == 0, f"online_mvdr_mmic: {differ} elements differ, one launch vs T launches")
    ms = device_ms(lambda: online_mvdr(Y, nmask, d, freqs, *st_k, **kw))
    plain_ms = time_ms(lambda: online_mvdr_plain(Y, nmask, d, freqs, *st_p, **kw), iters=1,
                       warmup=0)
    # Y's M channels, the noise and target masks in and S out per (f, t); the
    # state (M^2 complex and w_sum) read and written; d and freqs. Operations
    # per (f, t): the recursion's M (M + 1) / 2 entries (~6 each), the
    # Cholesky's ~M^3 / 6 complex multiply-adds (8 each), two substitutions
    # (~4 M^2) and the weights and output (~20 M).
    nbytes = F * T * (8 * M + 4 + 4 + 8) + 2 * F * (8 * M * M + 4) + F * (8 * M + 4)
    ops = F * T * (3.0 * M * (M + 1) + 8 * M ** 3 / 6 + 4 * M * M + 20 * M)
    b_ms, b_by = bound(nbytes, ops, FP32_FLOPS_PER_S)
    results["online_mvdr_mmic"] = dict(
        name="online_mvdr_mmic", route="cuda", source="azoom_torch/csrc/online_mvdr_mmic_kernel.cu",
        replaces="azoom/stream/online.py:61 (XLA lax.scan at M > 2, no Pallas kernel)",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None)
    mm["online_mvdr_mmic"] = dict(shape=(M, F, T), rel_err=o_rel, state_rel_err=st_rel, ms=ms,
                                  plain_ms=plain_ms, bound_ms=b_ms,
                                  one_vs_T_launches_differ=differ)
    log("online_mvdr_mmic", shape=(M, F, T), max_abs_err=f"{err:.3e}", rel_err=f"{o_rel:.3e}",
        state_rel_err=f"{st_rel:.3e}", one_vs_T_launches_elements_differ=differ, ms=f"{ms:.4f}",
        us_per_frame=f"{ms / T * 1e3:.3f}", plain_ms=f"{plain_ms:.1f}", bound_ms=f"{b_ms:.4f}",
        bound_by=b_by)
    del Y, nmask, got, ref, steps, whole

    # the causal pipeline at M = 4: 60 s offline, then 10 s hop by hop
    ll_cfg = PipelineConfig(mic_dist=0.04, n_mics=4, angle_target_deg=75.0)
    crn, _ = load_bundled("crn_causal")
    crn_cpu, _ = load_bundled("crn_causal", device="cpu")
    rec = torch.from_numpy(far_field_scene(rng, 1, 60 * 16_000, n_mics=4,
                                           angles=(75.0, 30.0, 140.0))[0][0])
    rec_g = rec.to(dev)
    torch.cuda.synchronize()
    kernels.reset_launches()
    out = online_learned_enhance(rec_g, crn, ll_cfg)
    torch.cuda.synchronize()
    ll_counts = launched()
    check(ll_counts == {"online_mvdr_mmic": 1}, f"M = 4 online_learned_enhance launches {ll_counts}")
    check(out.shape == (60 * 16_000,) and bool(torch.isfinite(out).all()),
          "M = 4 online_learned_enhance: bad output")
    results["online_mvdr_mmic"]["launches"] = ll_counts["online_mvdr_mmic"]
    ll_ts = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        online_learned_enhance(rec_g, crn, ll_cfg)
        torch.cuda.synchronize()
        ll_ts.append((time.perf_counter() - t0) * 1e3)
    pre = rec[:, :6 * 16_000]
    ll_rel = rel(online_learned_enhance(pre.to(dev), crn, ll_cfg).cpu(),
                 online_learned_enhance(pre, crn_cpu, ll_cfg))
    check(ll_rel <= 1e-3, f"M = 4 online_learned_enhance 6 s prefix vs CPU {ll_rel:.3e}")
    x10 = rec[:, :10 * 16_000].numpy()
    off10 = online_learned_enhance(rec_g[:, :10 * 16_000], crn, ll_cfg).cpu().numpy()
    oe = OnlineEnhancer(ll_cfg, crn, steer_deg=75.0)
    hop = ll_cfg.hop
    torch.cuda.synchronize()
    kernels.reset_launches()
    outs, push_ms = [], []
    for i in range(0, x10.shape[1], hop):
        t0 = time.perf_counter()
        outs.append(oe.push(x10[:, i:i + hop]))
        push_ms.append((time.perf_counter() - t0) * 1e3)
    hops = x10.shape[1] // hop
    oe_counts = launched()
    check(oe_counts == {"online_mvdr_mmic": hops}, f"M = 4 OnlineEnhancer launches {oe_counts}")
    streamed = np.concatenate(outs)
    oe_err = float(np.abs(streamed - off10[:streamed.shape[0]]).max())
    check(streamed.shape[0] == (hops - 1) * hop and oe_err <= 1e-5,
          f"M = 4 OnlineEnhancer vs the card's offline output: {oe_err:.3e}")
    ll_med = statistics.median(ll_ts)
    mm["lowlat"] = dict(offline_60s_ms=ll_ts, ms_per_recorded_second=ll_med / 60,
                        cpu_prefix_wave_rel_l2=ll_rel, push_ms=push_ms,
                        push_ms_median=statistics.median(push_ms[2:]),
                        launches_per_hop=oe_counts["online_mvdr_mmic"] / hops,
                        vs_offline_max_abs=oe_err)
    log("mmic_lowlat", M=4, offline_seconds=60, launches=ll_counts, ms_median=f"{ll_med:.3f}",
        ms_per_recorded_second=f"{ll_med / 60:.4f}", prefix_wave_rel_l2=f"{ll_rel:.3e}",
        stream_seconds=10, hops=hops, push_ms_median=f"{statistics.median(push_ms[2:]):.3f}",
        online_mvdr_mmic_per_hop=oe_counts["online_mvdr_mmic"] / hops,
        vs_offline_max_abs=f"{oe_err:.3e}")
    return mm


SOLVE_KERNELS = re.compile(r"getrf|getrs|trsm|trsv|laswp|magma|lu_factor|lu_solve|pivot", re.I)


def phase_beamformers(dev, rng, mix_s, clip, theta_cpu, model, model_cpu, profile_call) -> dict:
    """Phase 19: the RMVB, RTF and WPD beamformers and dereverberation
    (module docstring). ``mix_s`` is phase 7's (BATCH, 2, N_SAMPLES)
    far-field mixture on the card, ``clip`` phase 14's moving talker (numpy)
    and ``theta_cpu`` the CPU port's viterbi bearings of it; ``model`` and
    ``model_cpu`` the int8 tpufpu_nano on the card and on the CPU. Returns
    the phase's numbers for chip_smoke.json."""
    import numpy as np
    import torch

    from azoom_torch import kernels
    from azoom_torch.beam.rmvb import rmvb_beamform
    from azoom_torch.beam.rtf import rtf_mvdr_beamform
    from azoom_torch.beam.wpd import masked_wpd
    from azoom_torch.config import PipelineConfig
    from azoom_torch.dsp.delays import steer_rotate, steering_vector
    from azoom_torch.dsp.stft import istft, rfft_freqs, stft
    from azoom_torch.eval.projection import osinr_osir
    from azoom_torch.masks.duet import duet_masks
    from azoom_torch.models.pretrained import load_bundled
    from azoom_torch.pipelines.learned import learned_enhance, predict_mask
    from azoom_torch.pipelines.tracked import tracked_autosteer_enhance
    from azoom_torch.wpe import wpe_dereverb

    def launched() -> dict:
        return {k: v for k, v in kernels.launches.items() if v}

    def rel(a, b) -> float:
        a, b = (np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x) for x in (a, b))
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    def call_ms(fn, n: int = 6) -> list:
        ts = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        return ts

    def stage_floor(mix, net, cfg, name: str) -> float:
        """The float32 floor of a beamformer on these CPU chunks: its output
        in complex64 against complex128 (float64 masks), with the CPU port's
        masks and steering at 60 deg, as learned_enhance routes them."""
        Y, f = stft(mix), rfft_freqs(1024, 16_000)
        d = steering_vector(f, 60.0, cfg.mic_dist, n_mics=cfg.n_mics)
        tm = predict_mask(net, steer_rotate(Y, d), "logmag_ipd")

        def run(cdt, rdt):
            Yx, dx, t = Y.to(cdt), d.to(cdt), tm.to(rdt)
            nm = 1.0 - t
            if name == "rmvb":
                S = rmvb_beamform(Yx, nm, dx, f, sigma=cfg.sigma) * torch.clamp(t, min=0.05)
            elif name == "rtf":
                S = rtf_mvdr_beamform(Yx, nm, f, target_mask=t, d_fallback=dx, sigma=cfg.sigma,
                                      mask_floor=0.05)
            else:
                S = masked_wpd(Yx, 1.0 - nm, dx, f)
            return istft(S.to(torch.complex64), 1024, 512, length=mix.shape[-1])

        return rel(run(torch.complex64, torch.float32), run(torch.complex128, torch.float64))

    bf = {}
    cfg = PipelineConfig(mic_dist=0.04)
    cases = {  # name: learned_enhance keywords beyond the int8 nano net's
        "rmvb": dict(beamformer="rmvb"),
        "rtf": dict(beamformer="rtf"),
        "wpd": dict(beamformer="wpd"),
        "wpd_hrnr_fov30": dict(beamformer="wpd", harmonic_regen=True, fov_deg=30.0),
    }
    for name, bkw in cases.items():
        kw = dict(feature_kind="physics", steer_deg=60.0, **bkw)
        torch.cuda.synchronize()
        kernels.reset_launches()
        out = learned_enhance(mix_s, model, cfg, **kw)
        torch.cuda.synchronize()
        counts = launched()
        check(counts == {"qconv3x3": 21, "convt1x2": 3},
              f"{name}: launches {counts} (B2 and convt1x2 as in phase 5, no B1/B3)")
        check(out.shape == (BATCH, N_SAMPLES) and bool(torch.isfinite(out).all()),
              f"{name}: bad output")
        wave = rel(out[:4], learned_enhance(mix_s[:4].cpu(), model_cpu, cfg, **kw))
        check(wave <= 1e-2, f"{name}: first 4 chunks vs CPU {wave:.3e}")
        ts = call_ms(lambda: learned_enhance(mix_s, model, cfg, **kw))
        med = statistics.median(ts[1:])
        bf[name] = dict(launches=counts, ms=ts, ms_median=med, cpu_first4_wave_rel_l2=wave)
        log("beamformers", M=2, case=name, batch=BATCH, launches=counts, ms_median=f"{med:.3f}",
            ms_all=[round(t, 2) for t in ts],
            audio_seconds_per_second=f"{BATCH * N_SAMPLES / 16_000 / (med / 1e3):.1f}",
            cpu_first4_wave_rel_l2=f"{wave:.3e}")
    # where one call's device time goes: WPD (its batched solves) and RMVB
    # (its 30 bisection steps), by kernel
    for name, path in (("wpd", "profile_wpd.txt"), ("rmvb", "profile_rmvb.txt")):
        kw = dict(feature_kind="physics", steer_deg=60.0, **cases[name])
        rows, wall_ms, dev_ms = profile_call(f"profile_{name}",
                                             lambda: learned_enhance(mix_s, model, cfg, **kw), path)
        solve = [r for r in rows if SOLVE_KERNELS.search(r[0])]
        solve_ms = sum(r[1] for r in solve)
        bf[f"profile_{name}"] = dict(wall_ms=wall_ms, device_ms=dev_ms,
                                     kernel_launches=sum(r[2] for r in rows),
                                     solve_ms=solve_ms, solve_share=solve_ms / dev_ms,
                                     solve_kernels=[(k[:80], t, n) for k, t, n in solve])
        log(f"profile_{name}_solve", kernel_launches=sum(r[2] for r in rows),
            device_ms=f"{dev_ms:.3f}", solve_ms=f"{solve_ms:.3f}",
            solve_share=f"{solve_ms / dev_ms:.3f}",
            solve_kernels=[(k[:40], round(t, 3), n) for k, t, n in solve[:4]])

    # the same three at M = 4 (phase 18's 4-mic line) with the float fpu
    cfg4 = PipelineConfig(mic_dist=0.04, n_mics=4)
    fpu, _ = load_bundled("fpu", quant=False)
    fpu_cpu, _ = load_bundled("fpu", quant=False, device="cpu")
    mix4, tgt4, itf4 = (torch.from_numpy(a) for a in far_field_scene(
        rng, BATCH, N_SAMPLES, n_mics=4, angles=(60.0, 20.0, 130.0)))
    mix4_g = mix4.to(dev)
    for name in ("rmvb", "rtf", "wpd"):
        kw = dict(beamformer=name, steer_deg=60.0)
        torch.cuda.synchronize()
        kernels.reset_launches()
        out = learned_enhance(mix4_g, fpu, cfg4, **kw)
        torch.cuda.synchronize()
        counts = launched()
        check(counts == {"convt1x2": 3}, f"M = 4 {name}: launches {counts} (the float fpu)")
        check(out.shape == (BATCH, N_SAMPLES) and bool(torch.isfinite(out).all()),
              f"M = 4 {name}: bad output")
        out_cpu = learned_enhance(mix4[:4], fpu_cpu, cfg4, **kw)
        wave = rel(out[:4], out_cpu)
        # the card within 1e-2 of the CPU plus 4x the float32 floor of the
        # beamformer on these chunks (the card's roundings are a second draw
        # of the CPU's), and the SIR within 0.1 dB: RTF's steering is
        # ill-determined in bins whose confidence sits near its 0.7 gate,
        # where one float32 rounding moves the output by percents
        floor = stage_floor(mix4[:4], fpu_cpu, cfg4, name)
        d_sir = float((osinr_osir(out[:4].cpu(), tgt4[:4], itf4[:4])[1]
                       - osinr_osir(out_cpu, tgt4[:4], itf4[:4])[1]).mean())
        check(wave <= 1e-2 + 4.0 * floor and abs(d_sir) <= 0.1,
              f"M = 4 {name}: first 4 chunks vs CPU {wave:.3e} (float32 floor {floor:.3e}), "
              f"SIR {d_sir:+.4f} dB")
        ts = call_ms(lambda: learned_enhance(mix4_g, fpu, cfg4, **kw), n=4)
        med = statistics.median(ts[1:])
        bf[f"m4_{name}"] = dict(launches=counts, ms=ts, ms_median=med, cpu_first4_wave_rel_l2=wave,
                                cpu_float32_floor=floor, cpu_first4_dsir_db=d_sir)
        log("beamformers", M=4, case=name, net="fpu", batch=BATCH, launches=counts,
            ms_median=f"{med:.3f}", ms_all=[round(t, 2) for t in ts],
            cpu_first4_wave_rel_l2=f"{wave:.3e}", cpu_complex64_vs_128=f"{floor:.3e}",
            cpu_first4_dsir_db=f"{d_sir:+.4f}")
    del mix4, mix4_g, tgt4, itf4, out

    # the tracked path with RMVB on phase 14's clip: one batched call, a
    # steering vector per chunk
    seconds = clip.shape[-1] // 16_000
    clip_g = torch.from_numpy(clip).to(dev)
    kw = dict(model=model, feature_kind="physics", beamformer="rmvb", tracker="viterbi",
              fov_center_deg=90.0, fov_width_deg=90.0)
    torch.cuda.synchronize()
    kernels.reset_launches()
    out, theta = tracked_autosteer_enhance(clip_g, cfg, **kw)
    torch.cuda.synchronize()
    counts = launched()
    check(counts == {"qconv3x3": 21, "convt1x2": 3}, f"tracked rmvb: launches {counts}")
    check(out.shape == (seconds * 16_000,) and bool(torch.isfinite(out).all()),
          "tracked rmvb: bad output")
    check(torch.equal(theta.cpu(), theta_cpu), "tracked rmvb: bearings differ from the CPU's")
    pre = clip[:, :6 * 16_000]
    p_g, th_g = tracked_autosteer_enhance(torch.from_numpy(pre).to(dev), cfg, **kw)
    p_c, th_c = tracked_autosteer_enhance(pre, cfg, device="cpu", **{**kw, "model": model_cpu})
    check(torch.equal(th_g.cpu(), th_c), "tracked rmvb: prefix bearings")
    wave = rel(p_g, p_c)
    check(wave <= 1e-2, f"tracked rmvb: 6 s prefix vs CPU {wave:.3e}")
    ts = call_ms(lambda: tracked_autosteer_enhance(clip_g, cfg, **kw), n=4)
    med = statistics.median(ts[1:])
    bf["tracked_rmvb"] = dict(launches=counts, ms=ts, ms_median=med, seconds=seconds,
                              ms_per_recorded_second=med / seconds, prefix_wave_rel_l2=wave)
    log("beamformers_tracked", beamformer="rmvb", seconds=seconds, chunks=int(theta.shape[0]),
        launches=counts, ms_median=f"{med:.3f}", ms_per_recorded_second=f"{med / seconds:.4f}",
        prefix_wave_rel_l2=f"{wave:.3e}", bearings_first_last=[float(theta[0]), float(theta[-1])])
    del clip_g, out

    # WPE on 10 s of two channels: a dry far-field mixture through a decaying
    # noise tail per channel (~0.3 s to -60 dB)
    n = 10 * 16_000
    dry = far_field_scene(rng, 1, n)[0][0].astype(np.float64)
    t = np.arange(4_800) / 16_000
    tails = rng.standard_normal((2, t.size)) * np.exp(-t / 0.043)
    tails[:, 0] = 1.0
    wet = np.stack([np.convolve(dry[c], tails[c])[:n] for c in range(2)])
    wet = (0.1 * wet / np.sqrt(np.mean(wet**2))).astype(np.float32)
    wcfg = PipelineConfig()
    got = wpe_dereverb(wet, wcfg)
    torch.cuda.synchronize()
    check(got.device.type == dev.type and got.shape == (2, n) and bool(torch.isfinite(got).all()),
          "wpe_dereverb: bad output")
    wave = rel(got, wpe_dereverb(wet, wcfg, device="cpu"))
    check(wave <= 1e-3, f"wpe_dereverb: vs CPU {wave:.3e}")
    wet_g = torch.from_numpy(wet).to(dev)
    ts = call_ms(lambda: wpe_dereverb(wet_g, wcfg), n=4)
    med = statistics.median(ts[1:])
    bf["wpe_dereverb"] = dict(seconds=10, ms=ts, ms_median=med, wave_rel_l2=wave,
                              removed_rel_l2=rel(got, wet))
    log("beamformers_wpe", seconds=10, ms_median=f"{med:.3f}", wave_rel_l2_vs_cpu=f"{wave:.3e}",
        change_vs_input=f"{rel(got, wet):.3e}")

    # DUET masks on phase 7's scenes
    Y = stft(mix_s)
    angles = (60.0, 40.0, 130.0)
    m_g = duet_masks(Y, angles, 0.04, 16_000)
    m_c = duet_masks(Y.cpu(), angles, 0.04, 16_000)
    err = float((m_g.cpu() - m_c).abs().max())
    check(m_g.shape == (BATCH, 3, 513, Y.shape[-1]) and err <= 1e-5,
          f"duet_masks: shape {tuple(m_g.shape)}, vs CPU {err:.3e}")
    ts = call_ms(lambda: duet_masks(Y, angles, 0.04, 16_000), n=6)
    med = statistics.median(ts[1:])
    bf["duet_masks"] = dict(shape=list(Y.shape), ms=ts, ms_median=med, max_abs_err=err)
    log("beamformers_duet", shape=tuple(Y.shape), sources=3, ms_median=f"{med:.3f}",
        max_abs_err_vs_cpu=f"{err:.3e}")
    return bf


def phase_native_eval(dev, rng, profile_call) -> dict:
    """Phases 20 and 21: the facade's push on the C++ stream engine and the
    measurement layer (module docstring). Returns their numbers for
    chip_smoke.json."""
    import numpy as np
    import torch

    from azoom_torch import AudioZoom, kernels
    from azoom_torch.dsp.resample import resample_fft, resample_poly
    from azoom_torch.eval import bss_eval_sources, stoi
    from azoom_torch.eval.reports import compute_run_metrics, format_report
    from azoom_torch.stream.native import NativeStream, library_path

    def call_ms(fn, n: int = 5) -> list:
        ts = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        return ts

    def pushed(z, x, blocks) -> tuple:
        """Push x in the repeating block pattern; (output, host ms of each
        push, windows each push ran)."""
        def ready(t):  # windows in the first t samples
            return 0 if t < z.cfg.win_size else (t - z.cfg.win_size) // (z.cfg.win_size // 2) + 1

        outs, ms, wins, pos, i = [], [], [], 0, 0
        while pos < x.shape[1]:
            k = min(blocks[i % len(blocks)], x.shape[1] - pos)
            i += 1
            t0 = time.perf_counter()
            outs.append(z.push(x[:, pos:pos + k]))
            ms.append((time.perf_counter() - t0) * 1e3)
            wins.append(ready(pos + k) - ready(pos))
            pos += k
        return np.concatenate(outs), ms, wins

    def push_stats(ms, wins) -> dict:
        idle = [t for t, w in zip(ms, wins) if w == 0]
        busy = [t / w for t, w in zip(ms, wins) if w > 0]
        return dict(pushes=len(ms), windows=sum(wins), total_ms=sum(ms),
                    buffer_push_ms_median=statistics.median(idle),
                    ms_per_window_median=statistics.median(busy))

    # 20. the facade's push on the C++ engine -----------------------------------
    n = 12 * 16_000
    mix, tgt, itf = far_field_scene(rng, 1, n, angles=(75.0, 25.0, 140.0))
    mix, tgt, itf = mix[0], tgt[0], itf[0]
    blocks = (1, 7, 160, 997, 16_000)
    kw = dict(model="tpufpu_nano", int8=True, direction_deg=75.0, fov_deg=60.0, zoom=0.4)
    z_nat, z_np = AudioZoom(native=True, **kw), AudioZoom(native=False, **kw)
    check(isinstance(z_nat._native, NativeStream) and z_np._native is None,
          "AudioZoom(native=True) must buffer in the C++ engine")
    check(library_path().exists(), f"stream engine library {library_path()} missing")
    for z in (z_nat, z_np):  # warm-up: the card's first windows
        pushed(z, mix[:, :3 * 16_000], blocks)
        z.reset()
    torch.cuda.synchronize()
    kernels.reset_launches()
    out_nat, ms_nat, win_nat = pushed(z_nat, mix, blocks)
    torch.cuda.synchronize()
    counts = {k: v for k, v in kernels.launches.items() if v}
    windows = (n - 32_000) // 16_000 + 1
    check(counts == {"qconv3x3": 21 * windows, "convt1x2": 3 * windows,
                     "masked_mvdr": windows},
          f"native push launches {counts} for {windows} windows")
    out_np, ms_np, win_np = pushed(z_np, mix, blocks)
    diff = float(np.abs(out_nat - out_np).max())
    check(out_nat.shape == out_np.shape == ((windows - 1) * 16_000,)
          and bool(np.isfinite(out_nat).all()),
          f"native push: shapes {out_nat.shape} and {out_np.shape}")
    check(diff <= 1e-6, f"native push vs the NumPy buffer: {diff:.3e}")
    check(sum(win_nat) == sum(win_np) == windows, f"windows {sum(win_nat)}, {sum(win_np)}")
    # the buffers alone, the window step on the host (channel 0)
    b_ms = {}
    for nat in (True, False):
        zb = AudioZoom(enhance_fn=lambda w: w[0], native=nat, device="cpu")
        b_ms[nat] = pushed(zb, mix, blocks)[1]
    window = torch.from_numpy(mix[:, :32_000]).to(dev)
    _, win_wall, win_dev = profile_call("native_window", lambda: z_nat._enhance_window(window),
                                        "profile_native_window.txt")
    stats_nat, stats_np = push_stats(ms_nat, win_nat), push_stats(ms_np, win_np)
    native_stream = dict(seconds=12, blocks=blocks, launches=counts, vs_numpy_max_abs=diff,
                         native=stats_nat, numpy=stats_np,
                         buffer_only_total_ms={"native": sum(b_ms[True]),
                                               "numpy": sum(b_ms[False])},
                         buffer_only_push_ms_median={"native": statistics.median(b_ms[True]),
                                                     "numpy": statistics.median(b_ms[False])},
                         window_wall_ms=win_wall, window_device_ms=win_dev,
                         library=library_path().name)
    log("native_stream", seconds=12, pushes=stats_nat["pushes"], windows=windows,
        launches=counts, vs_numpy_max_abs=f"{diff:.3e}",
        native_buffer_push_ms=f"{stats_nat['buffer_push_ms_median']:.4f}",
        numpy_buffer_push_ms=f"{stats_np['buffer_push_ms_median']:.4f}",
        native_ms_per_window=f"{stats_nat['ms_per_window_median']:.3f}",
        numpy_ms_per_window=f"{stats_np['ms_per_window_median']:.3f}",
        buffer_only_total_ms=f"{sum(b_ms[True]):.2f}/{sum(b_ms[False]):.2f}",
        window_device_ms=f"{win_dev:.3f}", window_wall_ms=f"{win_wall:.3f}")

    # 21. the measurement layer -----------------------------------------------
    ev = {}
    src = far_field_scene(rng, 3, 10 * 16_000)[1]  # three speech-like 10 s clips
    noise = rng.standard_normal(src.shape).astype(np.float32)
    snrs = (0.0, 10.0, 20.0)
    noisy = np.stack([s + noise[i] * np.float32(np.linalg.norm(s) / np.linalg.norm(noise[i])
                                                  * 10 ** (-snr / 20))
                      for i, (s, snr) in enumerate(zip(src, snrs))]).astype(np.float32)
    clean_d, noisy_d = torch.from_numpy(src).to(dev), torch.from_numpy(noisy).to(dev)
    scores, cpu_scores, st_ms = [], [], []
    for i in range(3):
        scores.append(float(stoi(clean_d[i], noisy_d[i])))
        cpu_scores.append(float(stoi(src[i], noisy[i], device="cpu")))
        st_ms.append(statistics.median(call_ms(lambda: stoi(clean_d[i], noisy_d[i]))))
    batch = stoi(clean_d, noisy_d).cpu().numpy()
    st_err = max(abs(a - b) for a, b in zip(scores, cpu_scores))
    check(st_err <= 1e-5, f"stoi card vs CPU {st_err:.3e}")
    check(float(np.abs(batch - np.array(scores)).max()) <= 1e-6, "batched stoi vs per clip")
    check(0.0 < scores[0] < scores[1] < scores[2] < 1.0, f"stoi not rising with SNR: {scores}")
    ev["stoi"] = dict(snr_db=snrs, scores=scores, cpu_max_abs=st_err, ms=st_ms,
                      batch3_ms=statistics.median(call_ms(lambda: stoi(clean_d, noisy_d))))
    log("eval_stoi", seconds=10, snr_db=snrs, scores=[round(s, 5) for s in scores],
        cpu_max_abs=f"{st_err:.3e}", ms=[round(t, 3) for t in st_ms],
        batch3_ms=f"{ev['stoi']['batch3_ms']:.3f}")

    S = far_field_scene(rng, 3, 4 * 16_000)[1]
    e = (S[0] + 0.3 * S[1] + 0.1 * S[0].std() * rng.standard_normal(4 * 16_000)).astype(np.float32)
    S_d, e_d = torch.from_numpy(S).to(dev), torch.from_numpy(e).to(dev)
    got = {k: float(v) for k, v in bss_eval_sources(S_d, e_d, filter_len=512).items()}
    ref = {k: float(v) for k, v in bss_eval_sources(S, e, filter_len=512, device="cpu").items()}
    bss_err = max(abs(got[k] - ref[k]) for k in got)
    check(bss_err <= 0.05, f"bss_eval_sources card vs CPU {got} {ref}")
    check(got["sdr"] <= min(got["sir"], got["sar"]) and got["sir"] > 5.0,
          f"bss_eval_sources implausible: {got}")
    ev["bss"] = dict(sources=3, seconds=4, filter_len=512, card=got, cpu=ref, max_abs_db=bss_err,
                     ms=call_ms(lambda: bss_eval_sources(S_d, e_d, filter_len=512)))
    log("eval_bss", **{k: f"{v:.4f}" for k, v in got.items()}, max_abs_db_vs_cpu=f"{bss_err:.2e}",
        ms_median=f"{statistics.median(ev['bss']['ms']):.3f}")

    x = noisy[:2]
    x_d = noisy_d[:2]
    rs = {}
    for name, fn in (("resample_poly_16k_10k", lambda a, **k: resample_poly(a, 5, 8, **k)),
                     ("resample_fft_16k_10k", lambda a, **k: resample_fft(a, 100_000, **k))):
        g, r = fn(x_d), fn(x, device="cpu")
        err = float((g.cpu() - r).abs().max() / r.abs().max())
        check(g.shape == r.shape == (2, 100_000) and err <= 1e-5, f"{name} card vs CPU {err:.3e}")
        rs[name] = dict(rel_max_err=err, ms=statistics.median(call_ms(lambda: fn(x_d))))
    ev["resample"] = rs
    log("eval_resample", **{k: f"err={v['rel_max_err']:.2e},ms={v['ms']:.3f}"
                            for k, v in rs.items()})

    seg = slice(16_000, 16_000 + out_nat.shape[0])  # output sample 0 is input sample hop
    args = (out_nat, mix[0, seg], tgt[seg], itf[seg])
    t0 = time.perf_counter()
    m = compute_run_metrics(*args)
    run_ms = (time.perf_counter() - t0) * 1e3
    m_cpu = compute_run_metrics(*args, device="cpu")
    check(abs(m["stoi"] - m_cpu["stoi"]) <= 1e-5 and abs(m["imp"] - m_cpu["imp"]) <= 1e-3,
          f"run metrics card vs CPU: {m} {m_cpu}")
    check(m["imp"] > 0.0, f"the native push output does not improve the SIR: {m}")
    ev["run_metrics"] = dict(card=m, cpu=m_cpu, ms=run_ms)
    report = format_report("native_stream", m).splitlines()
    log("eval_report", ms=f"{run_ms:.1f}", report=" | ".join(l.strip() for l in report[3:] if ":" in l))
    return dict(native_stream=native_stream, eval=ev)


def phase_sim(dev, model, profile_call) -> dict:
    """Phase 22: the port's scene simulation at the reference's full width
    (module docstring). Returns the phase's numbers for chip_smoke.json."""
    import tempfile

    import numpy as np
    import torch

    from azoom_torch import kernels
    from azoom_torch.config import PipelineConfig, RoomConfig
    from azoom_torch.eval.projection import osinr_osir
    from azoom_torch.io.wav import write_wav
    from azoom_torch.pipelines.learned import learned_enhance
    from azoom_torch.pipelines.oracle import oracle_enhance
    from azoom_torch.pipelines.tracked import tracked_autosteer_enhance
    from azoom_torch.sim import (linear_trajectory, make_moving_room_scene, make_moving_scene,
                                 make_scene, speech_like_batch, traj_block_count)
    from azoom_torch.sim.corpus_native import NativeCorpus
    from azoom_torch.sim.datasets import LocalCorpus
    from azoom_torch.sim.native import build_flags, rir_matrix_native
    from azoom_torch.sim.room import inverse_sabine, rir_matrix
    from azoom_torch.sim.scene import SceneSpec, generate_scene

    def gen(seed: int):  # draws on the host: the card and the CPU see the same numbers
        return torch.Generator().manual_seed(seed)

    def host_ms(fn, n: int = 5, warmup: int = 1) -> list:
        for _ in range(warmup):
            fn()
        ts = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        return ts

    def rel(got, ref) -> float:
        got, ref = torch.as_tensor(got).cpu().double(), torch.as_tensor(ref).cpu().double()
        return float((got - ref).norm() / ref.norm())

    out = {}
    room = RoomConfig()
    # a reverberant scene at the reference's defaults: a 4.9 m cube, RT60
    # 0.5 s, order 15 (4,991 images), 9,600-tap RIRs, 4 s, three interferers
    spec = SceneSpec(reverb=True, n_interferers=3, duration_s=4.0)
    sc = generate_scene(gen(22), spec, room)
    sc2 = generate_scene(gen(22), spec, room)
    torch.cuda.synchronize()
    sc_cpu = generate_scene(gen(22), spec, room, device="cpu")
    bits_equal = all(torch.equal(sc[k], sc2[k]) for k in sc)
    errs = {k: rel(sc[k], sc_cpu[k]) for k in sc}
    rir_diff = float((sc["rirs"].cpu() - sc_cpu["rirs"]).abs().max())
    check(sc["mixture"].shape == (2, 64_000) and sc["rirs"].shape == (4, 2, 9_600)
          and sc["mixture"].device.type == "cuda" and bool(torch.isfinite(sc["mixture"]).all()),
          f"generate_scene: {sc['mixture'].shape} {sc['rirs'].shape} on {sc['mixture'].device}")
    check(max(errs.values()) <= 1e-3, f"generate_scene card vs CPU {errs}")
    check(torch.allclose(sc["rirs"].cpu(), sc_cpu["rirs"], atol=1e-4, rtol=1e-3),
          f"generate_scene RIRs card vs CPU {rir_diff:.3e}")
    check(bits_equal, "generate_scene: two runs on the card differ")
    ts = host_ms(lambda: generate_scene(gen(22), spec, room))
    _, g_wall, g_dev = profile_call("sim_profile", lambda: generate_scene(gen(22), spec, room),
                                    "profile_sim.txt")
    out["generate_scene"] = dict(seconds=4.0, n_interferers=3, max_order=15, card_vs_cpu=errs,
                                 rir_max_abs_vs_cpu=rir_diff, card_runs_bit_equal=bits_equal,
                                 ms=ts, profile_wall_ms=g_wall, profile_device_ms=g_dev)
    log("sim_scene", seconds=4, interferers=3, order=15, ms_median=f"{statistics.median(ts):.3f}",
        vs_cpu_rel_l2_max=f"{max(errs.values()):.2e}", rir_max_abs_vs_cpu=f"{rir_diff:.2e}",
        rir_peak=f"{float(sc_cpu['rirs'].abs().max()):.4f}", card_runs_bit_equal=bits_equal,
        device_ms=f"{g_dev:.3f}")

    # the RIR table alone: the card's ISM against the reference's C++ engine
    srcs = sc["rirs"].new_tensor([[2.45, 3.45, 1.5], [3.22, 3.06, 1.5], [1.6, 1.4, 1.5],
                                  [3.9, 1.2, 1.5]])
    a = inverse_sabine(room.rt60_target, room.room_dim)
    args = (room.mic_locs, room.room_dim, a, 15, 16_000, 9_600)
    R = rir_matrix(srcs, *args)
    t0 = time.perf_counter()
    R_cxx = rir_matrix_native(srcs.cpu().numpy(), *args)
    cxx_first = (time.perf_counter() - t0) * 1e3
    cxx_ms = [cxx_first] + host_ms(lambda: rir_matrix_native(srcs.cpu().numpy(), *args), n=3,
                                   warmup=0)
    card_ms = host_ms(lambda: rir_matrix(srcs, *args), n=10, warmup=2)
    d = np.abs(R.cpu().numpy() - R_cxx)
    check(np.allclose(R.cpu().numpy(), R_cxx, atol=1e-4, rtol=1e-3),
          f"rir_matrix card vs the C++ engine: max |diff| {float(d.max()):.3e}")
    omp = "-fopenmp" in build_flags()  # the engine's threads: OpenMP's, or one
    out["rir_matrix"] = dict(shape=(4, 2, 9_600), order=15, card_ms=card_ms, cxx_host_ms=cxx_ms,
                             max_abs_vs_cxx=float(d.max()), peak=float(np.abs(R_cxx).max()),
                             cxx_openmp=omp)
    log("sim_rir", shape=(4, 2, 9_600), order=15, card_ms=f"{statistics.median(card_ms):.3f}",
        cxx_host_ms=f"{statistics.median(cxx_ms):.2f}", cxx_openmp=omp,
        max_abs_vs_cxx=f"{float(d.max()):.2e}", peak=f"{float(np.abs(R_cxx).max()):.4f}")
    del sc, sc2, R

    # far-field scenes into the kernels: B1, B2, convt1x2 and B3 on the port's
    # own scenes (batch 128, 3 sources, 2 s, 4 cm; the target at 60 deg)
    cfg = PipelineConfig(mic_dist=0.04)
    src = speech_like_batch(gen(23), 3 * BATCH, N_SAMPLES).reshape(BATCH, 3, N_SAMPLES)
    ff = make_scene(src[:, 0], src[:, 1:], 60.0, [20.0, 130.0], 0.04, 16_000)
    mix, tgt, itf = ff["mixture"], ff["target_ref"], ff["interference_ref"]
    sir_in = float(osinr_osir(mix[:, 0], tgt, itf)[1].mean())
    calls = {
        "learned_mvdr": (lambda: learned_enhance(mix, model, cfg, feature_kind="physics",
                                                 steer_deg=60.0), {"masked_mvdr"}),
        "learned_hard_null": (lambda: learned_enhance(mix, model, cfg, feature_kind="physics",
                                                      beamformer="hard_null", steer_deg=60.0,
                                                      fov_deg=30.0), {"hard_null"}),
        "oracle": (lambda: oracle_enhance(mix, tgt, itf, cfg, post_filter="irm"), set()),
    }
    ff_out = dict(batch=BATCH, seconds=2, angles=(60.0, 20.0, 130.0), sir_in_db=sir_in)
    for name, (fn, beam) in calls.items():
        torch.cuda.synchronize()
        kernels.reset_launches()
        y = fn()
        torch.cuda.synchronize()
        counts = {k: v for k, v in kernels.launches.items() if v}
        want = ({"masked_mvdr": 1} if name == "oracle"
                else {"qconv3x3": 21, "convt1x2": 3, **{k: 1 for k in beam}})
        check(counts == want, f"{name} on the port's scenes: launches {counts}")
        check(y.shape == (BATCH, N_SAMPLES) and bool(torch.isfinite(y).all()), f"{name}: bad output")
        sir = float(osinr_osir(y, tgt, itf)[1].mean())
        ts = host_ms(fn, n=5, warmup=1)
        ff_out[name] = dict(launches=counts, ms=ts, sir_db=sir)
        log("sim_kernels", call=name, launches=counts, ms_median=f"{statistics.median(ts):.3f}",
            sir_in_db=f"{sir_in:.2f}", sir_db=f"{sir:.2f}",
            **({"reference_oracle_sir_db": 36.24} if name == "oracle" else {}))
    check(ff_out["oracle"]["sir_db"] > sir_in + 20.0,
          f"oracle on the port's scenes: SIR {ff_out['oracle']['sir_db']:.2f} dB")
    out["far_field"] = ff_out
    del src, ff, mix, tgt, itf

    # a 128 s moving talker (40 -> 140 deg, interferers fixed at 15 and 165)
    # into the learned tracked path
    n = 128 * 16_000
    B = traj_block_count(n, 2_048)
    glide = linear_trajectory(40.0, 140.0, B)
    src = speech_like_batch(gen(24), 3, n)
    t0 = time.perf_counter()
    mv = make_moving_scene(src[0], src[1:], glide, [15.0, 165.0], 0.04, 16_000)
    torch.cuda.synchronize()
    mv_first = (time.perf_counter() - t0) * 1e3
    mv_ms = host_ms(lambda: make_moving_scene(src[0], src[1:], glide, [15.0, 165.0], 0.04,
                                              16_000), n=3, warmup=0)
    tr_kw = dict(fov_center_deg=90.0, fov_width_deg=120.0, tracker="viterbi", model=model,
                 feature_kind="physics")
    torch.cuda.synchronize()
    kernels.reset_launches()
    y, theta = tracked_autosteer_enhance(mv["mixture"], cfg, **tr_kw)
    torch.cuda.synchronize()
    counts = {k: v for k, v in kernels.launches.items() if v}
    check(counts == {"qconv3x3": 21, "convt1x2": 3, "masked_mvdr": 1},
          f"tracked on the port's moving scene: launches {counts}")
    hop = cfg.win_size // 2
    centers = torch.arange(theta.shape[0], dtype=torch.float64) * hop + cfg.win_size / 2
    truth = 40.0 + 100.0 * (centers / n).clamp(max=1.0)
    err = (theta.cpu().double() - truth).abs()
    check(y.shape == (n,) and bool(torch.isfinite(y).all()), "tracked: bad output")
    check(float(err.median()) <= 10.0, f"tracked bearings vs the trajectory: median "
          f"{float(err.median()):.2f} deg")
    tr_ms = host_ms(lambda: tracked_autosteer_enhance(mv["mixture"], cfg, **tr_kw), n=3)
    out["moving"] = dict(seconds=128, blocks=B, scene_first_ms=mv_first, scene_ms=mv_ms,
                         launches=counts, tracked_ms=tr_ms,
                         bearing_err_deg=dict(median=float(err.median()), p90=float(err.quantile(0.9)),
                                              max=float(err.max())),
                         bearings_first_last=[float(theta[0]), float(theta[-1])])
    log("sim_moving", seconds=128, blocks=B, scene_ms=f"{statistics.median(mv_ms):.3f}",
        tracked_launches=counts, tracked_ms=f"{statistics.median(tr_ms):.3f}",
        bearing_err_median_deg=f"{float(err.median()):.2f}",
        bearing_err_p90_deg=f"{float(err.quantile(0.9)):.2f}",
        bearing_err_max_deg=f"{float(err.max()):.2f}")
    del src, mv, y

    # a 4 s moving talker in the room at order 15: 33 anchors' RIRs in one pass
    n = 4 * 16_000
    B = traj_block_count(n, 2_048)
    src = speech_like_batch(gen(25), 3, n)
    glide = linear_trajectory(60.0, 120.0, B)
    mr = make_moving_room_scene(gen(26), src[0], src[1:], glide, room)
    mr_cpu = make_moving_room_scene(gen(26), src[0].cpu(), src[1:].cpu(), glide.cpu(), room)
    mr_err = {k: rel(mr[k], mr_cpu[k]) for k in mr}
    check(max(mr_err.values()) <= 1e-3, f"moving room scene card vs CPU {mr_err}")
    mr_ms = host_ms(lambda: make_moving_room_scene(gen(26), src[0], src[1:], glide, room), n=3)
    out["moving_room"] = dict(seconds=4, anchors=B + 1, max_order=15, ms=mr_ms,
                              card_vs_cpu=mr_err)
    log("sim_moving_room", seconds=4, anchors=B + 1, order=15,
        ms_median=f"{statistics.median(mr_ms):.3f}",
        vs_cpu_rel_l2_max=f"{max(mr_err.values()):.2e}")
    del src, mr

    # the corpus engine over 64 synthetic wavs (3 s each, float32)
    with tempfile.TemporaryDirectory() as d:
        wavs = speech_like_batch(gen(27), 64, 3 * 16_000).cpu().numpy()
        for i, w in enumerate(wavs):
            write_wav(Path(d) / f"spk{i % 8}" / f"{i:03d}.wav", 0.5 * w, 16_000)
        with NativeCorpus(d, n_signals=32, n_samples=32_000, seed=0, depth=4) as c:
            check(len(c) == 64 and c.n_dropped == 0, f"corpus: {len(c)} files")
            first = c.next_batch()
            t0 = time.perf_counter()
            for _ in range(50):
                b = c.next_batch()
            nat_s = time.perf_counter() - t0
        check(first.shape == (32, 32_000) and bool(np.isfinite(b).all())
              and float(np.abs(b).max()) > 0.1, "corpus: bad batch")
        lc = LocalCorpus(d)
        r = np.random.default_rng(0)
        lc.sample_batch(r, 32, 32_000)
        t0 = time.perf_counter()
        for _ in range(10):
            lc.sample_batch(r, 32, 32_000)
        loc_s = (time.perf_counter() - t0) / 10
    out["corpus"] = dict(files=64, batch=(32, 32_000), native_batches_per_s=50 / nat_s,
                         local_batches_per_s=1 / loc_s)
    log("sim_corpus", files=64, batch=(32, 32_000), native_batches_per_s=f"{50 / nat_s:.1f}",
        local_corpus_batches_per_s=f"{1 / loc_s:.1f}")
    return out


def phase_sweep(dev, model, model_cpu, profile_call) -> dict:
    """Phase 23: the sweeps and the shards (module docstring). Returns the
    phase's numbers for chip_smoke.json."""
    import socket

    import numpy as np
    import torch
    import torch.distributed as dist

    from azoom_torch import AudioZoomServer, kernels
    from azoom_torch.config import PipelineConfig, RoomConfig
    from azoom_torch.kernels.qconv_kernel import route_counts
    from azoom_torch.parallel import make_mesh, sharded_sweep, sweep_summary
    from azoom_torch.parallel.multihost import global_data_mesh, initialize, is_primary
    from azoom_torch.parallel.sweep import (learned_step, learned_sweep, oracle_step,
                                            oracle_sweep, score_scenes, sweep_scenes)
    from azoom_torch.pipelines.learned import learned_enhance
    from azoom_torch.pipelines.oracle import oracle_enhance

    cfg = PipelineConfig(mic_dist=0.04)
    n_scenes, seed = BATCH, 23
    sweeps = {
        # 128 randomized anechoic 2 s scenes, with STOI
        "oracle": (oracle_sweep, (cfg,), dict(n_samples=N_SAMPLES, with_stoi=True,
                                              randomize=True), {"masked_mvdr": 1}),
        # the reference's flagship campaign: reverberant (RoomConfig(): RT60
        # 0.5 s, order 15), 2 interferers, the int8 net and hard-null
        "learned": (learned_sweep, (cfg, model),
                    dict(n_samples=N_SAMPLES, room=RoomConfig(), beamformer="hard_null",
                         feature_kind="physics"),
                    {"qconv3x3": 21, "convt1x2": 3, "hard_null": 1}),
    }
    out = {}

    def sync_ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        return r, (time.perf_counter() - t0) * 1e3

    def metric_diff(a: dict, b: dict) -> dict:
        return {k: float((a[k].cpu().double() - b[k].cpu().double()).abs().max()) for k in b}

    def close(diff: dict) -> bool:  # the metrics within 0.05 dB, STOI within 1e-4
        return all(v <= (1e-4 if k == "stoi" else 0.05) for k, v in diff.items())

    for name, (fn, args, kw, want) in sweeps.items():
        full = dict(kw)
        scene_kw = {k: v for k, v in kw.items() if k in ("n_samples", "randomize", "room")}
        if name == "learned":
            scene_kw["reverb"] = True
        fn(seed, *args, n_scenes=n_scenes, **full)  # warm-up at the timed shape
        torch.cuda.synchronize()
        kernels.reset_launches()
        routes0 = dict(route_counts)
        res, wall = sync_ms(lambda: fn(seed, *args, n_scenes=n_scenes, **full))
        counts = {k: v for k, v in kernels.launches.items() if v}
        routes = {r: route_counts[r] - routes0[r] for r in route_counts}
        check(counts == want, f"{name} sweep: launches {counts}")
        check(all(v.shape == (n_scenes,) for v in res.values())
              and all(bool(torch.isfinite(v).all()) for v in res.values()),
              f"{name} sweep: bad metrics {[(k, v.shape) for k, v in res.items()]}")
        summ = sweep_summary(res)
        # end to end: the sweep as a user calls it, 5 runs
        walls = [wall] + [sync_ms(lambda: fn(seed, *args, n_scenes=n_scenes, **full))[1]
                          for _ in range(4)]
        wall_med = statistics.median(walls)

        # instrumented: the same sweep with the card synchronised between its
        # steps (synthesis, enhancement, scoring), 5 runs; the shares are
        # those of the run whose total is the median
        def steps():
            sc, t_syn = sync_ms(lambda: sweep_scenes(seed, cfg, n_scenes, device=dev, **scene_kw))
            if name == "oracle":
                y, t_enh = sync_ms(lambda: oracle_enhance(sc["mixture"], sc["target_ref"],
                                                          sc["interference_ref"], cfg))
            else:
                y, t_enh = sync_ms(lambda: learned_enhance(sc["mixture"], model, cfg,
                                                           beamformer="hard_null",
                                                           feature_kind="physics"))
            _, t_sco = sync_ms(lambda: score_scenes(y, sc, cfg, True))
            return dict(synthesis=t_syn, enhancement=t_enh, scoring=t_sco,
                        total=t_syn + t_enh + t_sco)

        runs = sorted((steps() for _ in range(5)), key=lambda r: r["total"])
        med = runs[2]
        share = {k: med[k] / med["total"] for k in ("synthesis", "enhancement", "scoring")}
        _, p_wall, p_dev = profile_call(f"sweep_{name}_profile",
                                        lambda: fn(seed, *args, n_scenes=n_scenes, **full),
                                        f"profile_sweep_{name}.txt")
        # the card against the CPU on the first 4 scenes: the enhance-and-score
        # step on the same scenes (the kernels against their plain versions),
        # then the whole sweep, scenes drawn on each side
        sc4 = sweep_scenes(seed, cfg, 4, device=dev, **scene_kw)
        sc4_cpu = {k: v.cpu() for k, v in sc4.items()}
        if name == "oracle":
            d_step = metric_diff(oracle_step(sc4, cfg, True), oracle_step(sc4_cpu, cfg, True))
        else:
            step_kw = dict(beamformer="hard_null", feature_kind="physics")
            d_step = metric_diff(learned_step(sc4, cfg, model, **step_kw),
                                 learned_step(sc4_cpu, cfg, model_cpu, **step_kw))
        check(close(d_step), f"{name} sweep step: card vs CPU on 4 scenes {d_step}")
        args_cpu = (cfg, model_cpu) if name == "learned" else (cfg,)
        res_cpu = fn(seed, *args_cpu, n_scenes=4, device="cpu", **full)
        d_cpu = metric_diff({k: v[:4] for k, v in res.items()}, res_cpu)
        # the learned path's int8 codes flip under the scenes' ulps (the room's
        # RIRs differ by ~1e-6 of their peak between card and CPU): the
        # facade's bound there, 0.1 dB (STOI 2e-3, the CPU parity test's)
        check(close(d_cpu) if name == "oracle" else
              all(v <= (2e-3 if k == "stoi" else 0.1) for k, v in d_cpu.items()),
              f"{name} sweep: card vs CPU on 4 scenes {d_cpu}")
        # two shards on the card against one
        mesh2 = make_mesh(devices=["cuda:0"] * 2)
        shd, shd_ms = sync_ms(lambda: sharded_sweep(fn, seed, mesh2, n_scenes, *args, **full))
        d_shd = metric_diff(shd, res)
        bits = all(torch.equal(shd[k], res[k]) for k in res)
        check(close(d_shd), f"{name} sweep: 2 shards vs 1 {d_shd}")
        out[name] = dict(scenes=n_scenes, seconds=N_SAMPLES / 16_000, launches=counts,
                         conv_routes=routes, wall_ms=walls, wall_ms_median=wall_med,
                         scenes_per_s=n_scenes / (wall_med / 1e3), instrumented_runs=runs,
                         instrumented_median=med, shares=share,
                         profile_wall_ms=p_wall, profile_device_ms=p_dev,
                         idle_share=max(0.0, 1 - p_dev / p_wall), step_card_vs_cpu_4=d_step,
                         card_vs_cpu_4=d_cpu,
                         sharded2_ms=shd_ms, sharded2_vs_one=d_shd, sharded2_bit_equal=bits,
                         summary={k: summ[k] for k in ("sir_imp", "sinr_out", "stoi")})
        log(f"sweep_{name}", scenes=n_scenes, launches=counts,
            conv_routes=routes if name == "learned" else "-",
            wall_ms=[round(w, 1) for w in walls], wall_ms_median=f"{wall_med:.1f}",
            scenes_per_s=f"{out[name]['scenes_per_s']:.1f}",
            instrumented_ms=f"{med['total']:.1f}", synthesis_ms=f"{med['synthesis']:.1f}",
            enhancement_ms=f"{med['enhancement']:.1f}", scoring_ms=f"{med['scoring']:.1f}",
            shares={k: f"{v:.3f}" for k, v in share.items()},
            idle_share=f"{out[name]['idle_share']:.3f}",
            sir_imp_mean_db=f"{summ['sir_imp']['mean']:.2f}",
            stoi_mean=f"{summ['stoi']['mean']:.4f}",
            step_vs_cpu_max={k: f"{v:.2e}" for k, v in d_step.items()},
            vs_cpu_max={k: f"{v:.2e}" for k, v in d_cpu.items()},
            sharded2_ms=f"{shd_ms:.1f}", sharded2_bit_equal=bits,
            sharded2_vs_one_max=f"{max(d_shd.values()):.2e}")

    # a mesh of two distinct devices, the card and the host's CPU: a thread
    # each (run_on_devices' threaded path), the net replicated to the CPU;
    # the sweeps against the card alone at the card-against-CPU bounds, the
    # learned chunker within 1e-2 relative, and a shard's exception raised
    import threading

    from azoom_torch.parallel import replicated
    from azoom_torch.stream.chunker import streaming_enhance, streaming_enhance_sharded

    mixed = make_mesh(devices=["cuda:0", "cpu"])
    okw = dict(n_samples=N_SAMPLES, with_stoi=True, randomize=True)
    mo, mo_ms = sync_ms(lambda: sharded_sweep(oracle_sweep, seed, mixed, 4, cfg, **okw))
    d_mo = metric_diff(mo, oracle_sweep(seed, cfg, n_scenes=4, **okw))
    check(close(d_mo) and all(v.device == mixed.devices[0] for v in mo.values()),
          f"oracle sweep on the card and the CPU vs the card {d_mo}")
    lkw = dict(sweeps["learned"][2])
    kernels.reset_launches()
    ml, ml_ms = sync_ms(lambda: sharded_sweep(learned_sweep, seed, mixed, 2, cfg, model, **lkw))
    ml_launches = {k: v for k, v in kernels.launches.items() if v}
    check(ml_launches == sweeps["learned"][3],
          f"learned sweep on the card and the CPU: the card's launches {ml_launches}")
    d_ml = metric_diff(ml, learned_sweep(seed, cfg, model, n_scenes=2, **lkw))
    check(all(v <= (2e-3 if k == "stoi" else 0.1) for k, v in d_ml.items()),
          f"learned sweep on the card and the CPU vs the card {d_ml}")
    reps, seen = replicated(mixed, model), {}

    def process(chunks):
        seen[chunks.device.type] = threading.get_ident()
        return learned_enhance(chunks, reps[chunks.device], cfg, feature_kind="physics",
                               steer_deg=70.0)

    rec = torch.from_numpy(far_field_scene(np.random.default_rng(23), 1, 6 * 16_000)[0][0]).to(dev)
    st, st_ms = sync_ms(lambda: streaming_enhance_sharded(rec, process, mixed))
    threads = dict(seen)
    check(len(set(threads.values()) | {threading.get_ident()}) == 3,
          f"chunker on the card and the CPU: threads {threads}")
    st_ref = streaming_enhance(rec, process)
    st_rel = float((st - st_ref).norm() / st_ref.norm())
    check(st_rel <= 1e-2, f"chunker on the card and the CPU vs the card: relative {st_rel:.3e}")

    def failing(seed_, *a, device=None, **k):
        if torch.device(device).type == "cpu":
            raise FloatingPointError("the CPU's shard")
        return oracle_sweep(seed_, *a, device=device, **k)

    try:
        sharded_sweep(failing, seed, mixed, 4, cfg, **okw)
        raised = False
    except FloatingPointError:
        raised = True
    check(raised, "a failing shard on the CPU did not raise")
    out["two_devices"] = dict(mesh=[str(d) for d in mixed.devices], oracle_scenes=4,
                              oracle_ms=mo_ms, oracle_vs_card=d_mo, learned_scenes=2,
                              learned_ms=ml_ms, learned_card_launches=ml_launches,
                              learned_vs_card=d_ml, chunker_ms=st_ms, chunker_rel_l2=st_rel,
                              shard_error_raised=raised)
    log("sweep_two_devices", mesh=out["two_devices"]["mesh"], oracle_ms=f"{mo_ms:.1f}",
        oracle_vs_card_max=f"{max(d_mo.values()):.2e}", learned_ms=f"{ml_ms:.1f}",
        learned_card_launches=ml_launches, learned_vs_card_max=f"{max(d_ml.values()):.2e}",
        chunker_ms=f"{st_ms:.1f}", chunker_rel_l2=f"{st_rel:.3e}", shard_error_raised=raised)

    # the live server of phase 12 on two shards of the card against one
    scfg = PipelineConfig(mic_dist=0.04, win_size=32_768)
    win, hop, n_ticks = scfg.win_size, scfg.win_size // 2, 6
    steers, zooms = np.linspace(30.0, 150.0, BATCH), np.linspace(0.0, 1.0, BATCH)
    itf = np.stack([np.clip(steers - 45.0, 5.0, 175.0), np.clip(steers + 45.0, 5.0, 175.0)], 1)
    mix = far_field_scene(np.random.default_rng(12), BATCH, win + n_ticks * hop,
                          angles=np.concatenate([steers[:, None], itf], axis=1))[0]
    blocks = np.clip(mix * 32767.0, -32767, 32767).astype(np.int16)
    srv_out = {}
    for tag, mesh in (("one", None), ("two_shards", make_mesh(devices=["cuda:0"] * 2))):
        srv = AudioZoomServer(BATCH, cfg=scfg, mask_reuse=True, wire="int16", track=True,
                              mesh=mesh)
        for st in range(BATCH):
            srv.set_zoom(st, direction_deg=float(steers[st]), zoom=float(zooms[st]))
        outs, ms, launches = [srv.push(blocks[:, :, :win])], [], []
        for k in range(n_ticks):
            kernels.reset_launches()
            o, t = sync_ms(lambda: srv.push(blocks[:, :, win + k * hop:win + (k + 1) * hop]))
            outs.append(o)
            ms.append(t)
            launches.append({k2: v for k2, v in kernels.launches.items() if v})
        shards = 1 if mesh is None else 2
        want = {"qconv3x3": 21 * shards, "convt1x2": 3 * shards, "masked_mvdr": shards}
        check(all(c == want for c in launches), f"server {tag}: tick launches {launches}")
        srv_out[tag] = dict(out=np.concatenate(outs, 1).astype(np.float32), tick_ms=ms,
                            launches=launches[-1], bearings=srv.bearings)
        del srv
    a, b = srv_out["two_shards"]["out"], srv_out["one"]["out"]
    srv_rel = float(np.linalg.norm(a - b) / np.linalg.norm(b))
    srv_bits = bool(np.array_equal(a, b))
    check(srv_rel <= 1e-4, f"server: two shards vs one, waveform relative L2 {srv_rel:.3e}")
    out["server"] = dict(streams=BATCH, ticks=n_ticks, wave_rel_l2=srv_rel, bit_equal=srv_bits,
                         bearings_equal=bool(np.array_equal(srv_out["one"]["bearings"],
                                                            srv_out["two_shards"]["bearings"])),
                         **{f"{t}_tick_ms": v["tick_ms"] for t, v in srv_out.items()},
                         **{f"{t}_launches": v["launches"] for t, v in srv_out.items()})
    log("sweep_server", streams=BATCH, ticks=n_ticks,
        tick_ms_median_one=f"{statistics.median(srv_out['one']['tick_ms'][1:]):.3f}",
        tick_ms_median_two_shards=f"{statistics.median(srv_out['two_shards']['tick_ms'][1:]):.3f}",
        launches_two_shards=srv_out["two_shards"]["launches"], wave_rel_l2=f"{srv_rel:.3e}",
        bit_equal=srv_bits, bearings_equal=out["server"]["bearings_equal"])

    # a process group of one on NCCL, and a sweep over its global mesh
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    initialize(f"127.0.0.1:{port}", num_processes=1, process_id=0)
    try:
        gmesh = global_data_mesh()
        check(gmesh.size == 1 and is_primary() and dist.get_backend() == "nccl",
              f"global mesh {gmesh}, backend {dist.get_backend()}")
        g, g_ms = sync_ms(lambda: sharded_sweep(oracle_sweep, seed, gmesh, 8, cfg,
                                                n_samples=N_SAMPLES, with_stoi=True,
                                                randomize=True))
        ref8 = oracle_sweep(seed, cfg, n_scenes=8, n_samples=N_SAMPLES, with_stoi=True,
                            randomize=True)
        d_g = metric_diff(g, ref8)
        check(close(d_g), f"multihost sweep vs unsharded {d_g}")
    finally:
        dist.destroy_process_group()
    out["multihost"] = dict(backend="nccl", world_size=1, scenes=8, ms=g_ms, vs_unsharded=d_g)
    log("sweep_multihost", backend="nccl", world_size=1, scenes=8, ms=f"{g_ms:.1f}",
        vs_unsharded_max=f"{max(d_g.values()):.2e}")
    return out


_T0 = time.perf_counter()
_CARD = {}  # the card's name and power limit, once nvidia-smi has been read


def phase_train(dev, mix_s, tgt_s, itf_s) -> dict:
    """24. training (module docstring). ``mix_s``, ``tgt_s``, ``itf_s`` are
    phase 7's far-field scenes on the card. Returns the phase's numbers for
    chip_smoke.json."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from azoom_torch import kernels
    from azoom_torch.config import PipelineConfig
    from azoom_torch.eval.projection import osinr_osir
    from azoom_torch.kernels.qconv_kernel import qconv3x3, qconv3x3_plain, route_counts
    from azoom_torch.models import trainable
    from azoom_torch.models.convert import from_flax
    from azoom_torch.models.pretrained import load_bundled
    from azoom_torch.models.quantize import calibrate_act_scales, load_quantized, save_quantized
    from azoom_torch.models.unet import TPUFPU, QConv
    from azoom_torch.pipelines.learned import learned_enhance
    from azoom_torch.train import rounding
    from azoom_torch.train.data import synth_batch
    from azoom_torch.train.loop import create_state, fit, make_train_step

    cfg = PipelineConfig(mic_dist=0.04)
    nano = dict(base=64, fold=4, bneck=4, dec_div=2, enc_div=2)
    res: dict = {}

    def sync():
        torch.cuda.synchronize()

    # one nano step at batch 2 from the same init and batch, on the card and on
    # the CPU in float32, and on the card in float64 as the rounding reference:
    # a float32 step is ill-conditioned, so each float32 run is measured leaf by
    # leaf by its distance from float64, and each leaf held to its bound
    # (train/rounding.py: every gradient within GRAD_BOUND, every BatchNorm
    # statistic's update and the loss on the card within CARD_FACTOR times the
    # CPU's distance + FLOOR)
    kw, n_samples, shape = rounding.CONFIGS["nano"]
    b2 = synth_batch(0, 2, cfg, "physics", n_samples=n_samples, device="cpu")
    dist = rounding.step_distances(lambda: trainable.TPUFPU(**kw), shape, b2["features"],
                                   b2["label"], dev)
    bad = rounding.over_bound(dist)
    check(not bad, f"train step: leaves beyond their bounds from float64: {bad[:5]}")
    log("train_step", batch=2, leaves=len(dist["card"]["grad"]), statistics=len(dist["card"]["bn"]),
        loss_from_f64_card=f"{dist['card']['loss']:.3e}", loss_from_f64_cpu=f"{dist['cpu']['loss']:.3e}",
        **{k: f"{v:.3e}" for k, v in rounding.summary(dist).items()},
        grad_bound=rounding.GRAD_BOUND, over_bound=len(bad))
    res["card_vs_cpu"] = dist

    # steps per second and peak memory of each bundled architecture at batch 16
    # (2 s crops: 513 bins, 64 frames); the nano net warm-starts from its artifact
    batches = {k: synth_batch(1, 16, cfg, k, device=dev) for k in ("physics", "logmag_ipd")}
    data_times = []
    for i in range(3):  # a step's batch: host draws, the render, STFTs, features, labels
        sync()
        t0 = time.perf_counter()
        synth_batch(10 + i, 16, cfg, "physics", device=dev)
        sync()
        data_times.append((time.perf_counter() - t0) * 1e3)
    data_ms = statistics.median(data_times)
    archs = [
        ("tpufpu_nano", lambda: trainable.TPUFPU(**nano), "physics", False),
        ("tpufpu", lambda: trainable.TPUFPU(base=64, fold=4), "physics", False),
        ("tpufpu_slim", lambda: trainable.TPUFPU(base=64, fold=4, bneck=4), "physics", False),
        ("fpu", lambda: trainable.FreqPreservingUNet(base=32), "logmag_ipd", False),
        ("deepfpu", lambda: trainable.DeepFPU(base=32), "physics", False),
        ("deepfpu_remat", lambda: trainable.DeepFPU(base=32), "physics", True),
        ("crn_causal", lambda: trainable.CRNMaskNet(base=16, hidden=128), "logmag_ipd", False),
    ]
    steps, trained = {}, None
    for name, make, kind, remat in archs:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        st = create_state(make(), 0, (1, 513, 64, 4 if kind == "physics" else 2), device=dev)
        if name == "tpufpu_nano":
            st.model.load_variables(trainable.from_bundled("tpufpu_nano")[0].variables())
        step = make_train_step(remat=remat)
        b = batches[kind]
        times = []
        for i in range(7):
            sync()
            t1 = time.perf_counter()
            _, loss = step(st, b["features"], b["label"])
            sync()
            if i >= 2:
                times.append((time.perf_counter() - t1) * 1e3)
        ms = statistics.median(times)
        peak = torch.cuda.max_memory_allocated() / 2**30
        check(np.isfinite(float(loss)), f"train {name}: loss {float(loss)}")
        steps[name] = dict(ms=ms, steps_per_s=1e3 / ms, peak_gib=peak, loss=float(loss),
                           ms_all=[round(t, 3) for t in times])
        log("train_speed", net=name, remat=remat, batch=16, ms_median=f"{ms:.3f}",
            steps_per_s=f"{1e3 / ms:.2f}", peak_gib=f"{peak:.3f}", loss=f"{float(loss):.4f}")
        if name == "tpufpu_nano":
            trained = st.model
        del st
    res["steps"], res["data_ms_per_batch16"] = steps, data_ms
    log("train_data", batch=16, ms_per_batch=f"{data_ms:.3f}",
        ms_all=[round(t, 3) for t in data_times])

    # a 6-step fit checkpointed every 3, against 3 steps and a resume to 6
    tmp = Path(tempfile.mkdtemp(prefix="azt_train_"))
    try:
        kw = dict(batch_size=2, feature_kind="physics", checkpoint_every=3, log_every=3,
                  log_fn=lambda s: None, device=dev)
        t1 = time.perf_counter()
        whole = fit(trainable.TPUFPU(**nano), cfg, n_steps=6, checkpoint_dir=tmp / "a", **kw)
        fit_s = time.perf_counter() - t1
        fit(trainable.TPUFPU(**nano), cfg, n_steps=3, checkpoint_dir=tmp / "b", **kw)
        resumed = fit(trainable.TPUFPU(**nano), cfg, n_steps=6, checkpoint_dir=tmp / "b", **kw)
        check(resumed.steps_run == 3 and resumed.state.step == 6, "resume: steps")
        a, b = whole.state.model.state_dict(), resumed.state.model.state_dict()
        resume_diff = max(float((a[k] - b[k]).abs().max()) for k in a)
        resume_diff = max([resume_diff] + [float((whole.state.nu[k] - resumed.state.nu[k]).abs().max())
                                           for k in whole.state.nu])
        log("train_resume", steps=6, checkpoint_every=3, fit_s=f"{fit_s:.2f}",
            max_abs_diff=f"{resume_diff:.3e}", bits_equal=resume_diff == 0.0)
        res["resume_max_abs_diff"] = resume_diff

        # fit end to end at the CLI's batch: each step's batch made, then the step
        t1 = time.perf_counter()
        fit(trainable.TPUFPU(**nano), cfg, n_steps=4, batch_size=16, feature_kind="physics",
            log_fn=lambda s: None, device=dev)
        sync()
        fit16_ms = (time.perf_counter() - t1) * 1e3 / 4
        log("train_fit", net="tpufpu_nano", batch=16, steps=4, ms_per_step=f"{fit16_ms:.3f}",
            steps_per_s=f"{1e3 / fit16_ms:.2f}")
        res["fit_batch16_ms_per_step"] = fit16_ms

        # calibrate the trained nano net on the card, export, reload, serve
        calib = [synth_batch(2 + i, 16, cfg, "physics", device=dev)["features"] for i in range(2)]
        kernels.reset_launches()
        t1 = time.perf_counter()
        variables = calibrate_act_scales(trained, trained.variables(), calib, device=dev)
        sync()
        calib_s = time.perf_counter() - t1
        calib_launches = {k: v for k, v in kernels.launches.items() if v}
        check(calib_launches == {"qconv3x3": 42, "convt1x2": 6},
              f"calibration launches {calib_launches}")
        nbytes = save_quantized(tmp / "nano_finetuned_int8.npz", variables)
        served = from_flax(TPUFPU, load_quantized(tmp / "nano_finetuned_int8.npz"),
                           dict(nano, in_channels=4), True, dev)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    sync()
    kernels.reset_launches()
    before = dict(route_counts)
    out = learned_enhance(mix_s, served, cfg, feature_kind="physics")
    sync()
    counts = {k: v for k, v in kernels.launches.items() if v}
    routes = {k: v - before[k] for k, v in route_counts.items() if v - before[k]}
    check(counts == {"qconv3x3": 21, "convt1x2": 3, "masked_mvdr": 1},
          f"exported net: launch counts {counts}")
    check(routes == {"wgmma": 20, "narrow": 1}, f"exported net: conv kernels {routes}")
    check(out.shape == mix_s.shape[::2] and bool(torch.isfinite(out).all()), "exported net output")
    bundled, _ = load_bundled("tpufpu_nano", device=dev)
    ref = learned_enhance(mix_s, bundled, cfg, feature_kind="physics")
    sir = {k: float((osinr_osir(o, tgt_s, itf_s)[1] - osinr_osir(mix_s[:, 0], tgt_s, itf_s)[1])
                    .mean()) for k, o in (("exported", out), ("bundled", ref))}
    check(sir["exported"] > sir["bundled"] - 3.0, f"exported net SIR gain {sir}")

    # the exported net's convs against their plain version, on 4 chunks' inputs
    calls = []

    def grab(conv, args, kwargs):
        calls.append((conv, args[0], kwargs))

    handles = [m.register_forward_pre_hook(grab, with_kwargs=True)
               for m in served.modules() if isinstance(m, QConv)]
    with torch.inference_mode():
        served(calib[0][:4])
    for h in handles:
        h.remove()
    differ = 0
    for conv, x, kw in calls:
        k = dict(residual=kw.get("residual"), relu=kw.get("relu", True), x2=kw.get("x2"))
        got = qconv3x3(x, conv.w_q, conv.epi, conv.act_scale, **k)
        differ += int((got != qconv3x3_plain(x, conv.w_q, conv.epi, conv.act_scale, **k)).sum())
    check(differ == 0 and len(calls) == 21, f"exported convs: {differ} elements differ")
    log("train_export", calib_batches=2, calib_s=f"{calib_s:.2f}", calib_launches=calib_launches,
        npz_bytes=nbytes, launches=counts, conv_kernels=routes,
        sir_gain_db=f"{sir['exported']:.2f}", sir_gain_bundled_db=f"{sir['bundled']:.2f}",
        convs_vs_plain=f"{len(calls)} convs, {differ} elements differ")
    res["export"] = dict(calib_s=calib_s, npz_bytes=nbytes, launches=counts, routes=routes,
                         sir_gain_db=sir, convs_differ=differ)
    return res


def log(phase: str, **kw) -> None:
    """One line of a phase's results, ending with the card (its name and
    power limit beside every time) and the seconds since the start."""
    kw.setdefault("card", f"'{_CARD.get('smi', '')}'")
    kw["t_s"] = f"{time.perf_counter() - _T0:.1f}"
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kw.items()), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import numpy as np

    from azoom_torch import kernels
    from azoom_torch.beam.mvdr import masked_mvdr
    from azoom_torch.config import PipelineConfig
    from azoom_torch.dsp.delays import steering_vector
    from azoom_torch.dsp.stft import rfft_freqs, stft
    from azoom_torch.eval.projection import osinr_osir
    from azoom_torch.kernels import build
    from azoom_torch.kernels.bench import device_ms, int_mm_ms
    from azoom_torch.kernels.convt_kernel import convt1x2, convt1x2_plain
    from azoom_torch.kernels.int8_mm_kernel import MICROBENCH_SHAPES, int8_mm, int8_mm_plain
    from azoom_torch.kernels.mvdr_kernel import masked_mvdr_fused
    from azoom_torch.kernels.nullsteer_kernel import hard_null_cond, hard_null_fused, hard_null_plain
    from azoom_torch.kernels.qconv_kernel import k_padded, plan, qconv3x3, qconv3x3_plain, route_counts
    from azoom_torch.masks.oracle import ibm_target_mask
    from azoom_torch.models.pretrained import load_bundled
    from azoom_torch.pipelines.learned import (
        learned_enhance,
        learned_enhance_streaming,
        predict_mask,
    )
    from azoom_torch.pipelines.oracle import oracle_enhance
    from azoom_torch.stream.chunker import chunk_signal, overlap_add_chunks

    out_dir = Path("chiprun_out")
    out_dir.mkdir(exist_ok=True)
    dev = torch.device("cuda")
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmuls must stay off")

    def time_ms(fn, iters=20, warmup=3) -> float:
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(iters):
            fn()
        t1.record()
        torch.cuda.synchronize()
        return t0.elapsed_time(t1) / iters

    def active_launches() -> dict:
        return {k: v for k, v in kernels.launches.items() if v}

    def row_rel(got, ref):
        """Relative error of each (stream, bin) row of complex (..., F, T)."""
        return (got - ref).abs().norm(dim=-1) / ref.abs().norm(dim=-1).clamp(min=1e-30)

    def bound(nbytes: float, ops: float, rate: float) -> tuple[float, str]:
        t_mem, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / rate * 1e3
        return (t_mem, "bytes") if t_mem >= t_ops else (t_ops, "operations")

    def bound_by_of(parts) -> str:
        """What bounds most of the summed bound time of several launches."""
        by_bytes = sum(p["bound_ms"] for p in parts if p["bound_by"] == "bytes")
        return "bytes" if by_bytes >= sum(p["bound_ms"] for p in parts) / 2 else "operations"

    # 1. build --------------------------------------------------------------
    t0 = time.perf_counter()
    info = build.build_all()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    _CARD["smi"] = smi
    log("build", seconds=f"{time.perf_counter() - t0:.2f}",
        per_source={k: round(v["seconds"], 2) for k, v in info.items()},
        torch=torch.__version__, cuda=torch.version.cuda)
    (out_dir / "build_log.txt").write_text(
        "\n".join(f"== {k}\n{v['log']}" for k, v in info.items()))
    rng = np.random.default_rng(0)
    results = {}

    # 2. fused masked MVDR ---------------------------------------------------
    F, T = 513, 64
    shape = (BATCH, 2, F, T)
    Y = torch.complex(*(torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
                        for _ in range(2))).to(dev)
    nmask = torch.from_numpy(rng.random((BATCH, F, T), dtype=np.float32)).to(dev)
    tmask = 1.0 - nmask
    freqs = rfft_freqs(1024, 16_000, device=dev)
    d = steering_vector(freqs, 60.0, 0.04)
    sig_f = torch.from_numpy((1e-7 * (1 + rng.random(F))).astype(np.float32)).to(dev)
    worst = 0.0
    for sigma in (1e-7, sig_f):
        args = (Y, nmask, d, freqs)
        kw = dict(target_mask=tmask, sigma=sigma, hp_cutoff_hz=100.0, mask_floor=0.05)
        got = masked_mvdr_fused(*args, **kw)
        ref = masked_mvdr(*args, **kw)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        rel = err / float(ref.abs().max())
        check(bool(torch.isfinite(torch.view_as_real(got)).all()), "mvdr: non-finite output")
        check(rel <= 1e-4, f"mvdr: relative error {rel:.3e} > 1e-4")
        worst = max(worst, err)
    kw = dict(target_mask=tmask, sigma=1e-7, hp_cutoff_hz=100.0, mask_floor=0.05)
    # ms: a loop of calls from Python, as since the first slice; graph_ms: replays
    ms = time_ms(lambda: masked_mvdr_fused(Y, nmask, d, freqs, **kw))
    graph_ms = device_ms(lambda: masked_mvdr_fused(Y, nmask, d, freqs, **kw))
    plain_ms = time_ms(lambda: masked_mvdr(Y, nmask, d, freqs, **kw), iters=5)
    n_el = BATCH * F * T
    b_ms, b_by = bound(n_el * (2 * 8 + 4 + 4 + 8) + F * (16 + 4), n_el * 34.0, FP32_FLOPS_PER_S)
    results["masked_mvdr"] = dict(
        name="masked_mvdr", route="cuda", source="azoom_torch/csrc/mvdr_kernel.cu",
        replaces="azoom/pallas/mvdr_kernel.py:38", max_abs_err=worst, ms=ms,
        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None)
    mvdr_forms = dict(shared=dict(shape=shape, ms=ms, graph_ms=graph_ms, plain_ms=plain_ms,
                                  bound_ms=b_ms))
    log("mvdr", shape=shape, max_abs_err=f"{worst:.3e}", ms=f"{ms:.4f}", graph_ms=f"{graph_ms:.4f}",
        plain_ms=f"{plain_ms:.4f}", bound_ms=f"{b_ms:.4f}", bound_by=b_by)
    del Y, nmask, tmask

    # the server's tick: 65 frames, a steering vector and a loading per stream
    from azoom_torch.beam.zoom import zoom_to_sigma

    T_srv = 65
    shape = (BATCH, 2, F, T_srv)
    Y = torch.complex(*(torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
                        for _ in range(2))).to(dev)
    nmask = torch.from_numpy(rng.random((BATCH, F, T_srv), dtype=np.float32)).to(dev)
    tmask = 1.0 - nmask
    d_s = steering_vector(freqs, torch.linspace(30.0, 150.0, BATCH, device=dev), 0.04)
    sig_s = zoom_to_sigma(torch.linspace(0.0, 1.0, BATCH)).to(dev)
    kw = dict(target_mask=tmask, hp_cutoff_hz=100.0, mask_floor=0.05)
    got = masked_mvdr_fused(Y, nmask, d_s, freqs, sigma=sig_s, **kw)
    ref = masked_mvdr(Y, nmask, d_s, freqs, sigma=sig_s, **kw)
    shared = masked_mvdr_fused(Y, nmask, d_s[1], freqs, sigma=float(sig_s[1]), **kw)
    each = masked_mvdr_fused(Y, nmask, d_s[1].expand(BATCH, F, 2).contiguous(), freqs,
                             sigma=sig_s[1].expand(BATCH).contiguous(), **kw)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    rel = err / float(ref.abs().max())
    check(bool(torch.isfinite(torch.view_as_real(got)).all()), "mvdr per stream: non-finite output")
    check(rel <= 1e-4, f"mvdr per stream: relative error {rel:.3e} > 1e-4")
    differ = int((shared != each).sum())
    check(differ == 0, f"mvdr: shared steering differs from per-stream steering in {differ} elements")
    ms = time_ms(lambda: masked_mvdr_fused(Y, nmask, d_s, freqs, sigma=sig_s, **kw))
    graph_ms = device_ms(lambda: masked_mvdr_fused(Y, nmask, d_s, freqs, sigma=sig_s, **kw))
    plain_ms = time_ms(lambda: masked_mvdr(Y, nmask, d_s, freqs, sigma=sig_s, **kw), iters=5)
    n_el = BATCH * F * T_srv
    # Y, both masks in, S out; per stream d (F, 2) complex64 and sigma; freqs
    nbytes = n_el * (2 * 8 + 4 + 4 + 8) + BATCH * (F * 16 + 4) + F * 4
    b_ms, b_by = bound(nbytes, n_el * 34.0, FP32_FLOPS_PER_S)
    # The server's form: its launches are counted in phase 12.
    results["masked_mvdr_per_stream"] = dict(
        name="masked_mvdr_per_stream", route="cuda", source="azoom_torch/csrc/mvdr_kernel.cu",
        replaces="azoom/pallas/mvdr_kernel.py:38 (jax.vmap over streams, azoom/stream/server.py:129)",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None)
    mvdr_forms["per_stream"] = dict(shape=shape, ms=ms, graph_ms=graph_ms, plain_ms=plain_ms,
                                    bound_ms=b_ms, rel_err=rel)
    log("mvdr_per_stream", shape=shape, steers="30..150", zooms="0..1", max_abs_err=f"{err:.3e}",
        shared_vs_per_stream_elements_differ=differ, ms=f"{ms:.4f}", graph_ms=f"{graph_ms:.4f}",
        plain_ms=f"{plain_ms:.4f}", bound_ms=f"{b_ms:.4f}", bound_by=b_by)
    del Y, nmask, tmask, got, ref, shared, each

    # 3. int8 3x3 conv --------------------------------------------------------
    act_scale = float(np.float32(3.3 / 127))

    def conv_operands(cin, cout, t):
        x = torch.from_numpy(np.abs(rng.standard_normal((BATCH, F_ROWS, t, cin)))
                             .astype(np.float32)).to(dev)
        w_q = torch.zeros((cout, k_padded(cin)), dtype=torch.int8)
        w_q[:, :9 * cin] = torch.from_numpy(
            rng.integers(-127, 128, (cout, 9 * cin)).astype(np.int8))
        epi = torch.from_numpy(np.stack([
            np.full(cout, 2e-4), 0.1 * rng.standard_normal(cout), 0.1 * rng.standard_normal(cout),
            1 + 0.1 * rng.standard_normal(cout), 0.1 * rng.standard_normal(cout),
        ]).astype(np.float32)).to(dev)
        res = torch.from_numpy(rng.standard_normal((BATCH, F_ROWS, t, cout))
                               .astype(np.float32)).to(dev)
        return x, w_q.to(dev), epi, res

    def conv_variants(convs, cin, cout, t, x, res):
        """(with residual, concat input) of a shape: plain, +residual, and
        what the net runs there; with the conv's call arguments."""
        variants = {(False, False), (True, False)} | {c[3:] for c in convs if c[:3] == (cin, cout, t)}
        for with_res, cat in sorted(variants):
            kw = dict(residual=res if with_res else None)
            if cat:  # the decoder's concat: two inputs of cin / 2 channels each
                kw["x2"] = x[..., cin // 2:].contiguous()
            yield with_res, cat, (x[..., :cin // 2].contiguous() if cat else x), kw

    def mma_differ(xin, w_q, epi, kw) -> int:
        """Elements where the route the plan picks differs from the mma.sync kernel."""
        return int((qconv3x3(xin, w_q, epi, act_scale, **kw)
                    != qconv3x3(xin, w_q, epi, act_scale, **kw, _kernel="mma")).sum())

    def conv_check(cin, cout, t, with_res, cat, xin, w_q, epi, kw, rows=F_ROWS):
        """The kernel against the plain version on planes of ``rows`` rows:
        (max abs error, elements that differ, kernel ms, bound ms, bound by)."""
        got = qconv3x3(xin, w_q, epi, act_scale, **kw)
        ref = qconv3x3_plain(xin, w_q, epi, act_scale, **kw)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        rel = err / (float(ref.abs().max()) + 1e-30)
        check(rel < 1e-5, f"qconv {(cin, cout, t, with_res, cat)}: relative error {rel:.3e}")
        m = BATCH * rows * t
        nbytes = (m * cin * 4 + cout * 9 * cin + epi.numel() * 4
                  + m * cout * 4 * (2 if with_res else 1))
        b_ms, b_by = bound(nbytes, 2.0 * m * 9 * cin * cout, INT8_OPS_PER_S)
        ms = time_ms(lambda: qconv3x3(xin, w_q, epi, act_scale, **kw))
        return err, int((got != ref).sum()), ms, b_ms, b_by

    per_shape = {}
    worst = 0.0
    for cin, cout, t in dict.fromkeys(c[:3] for c in NANO_CONVS):
        x, w_q, epi, res = conv_operands(cin, cout, t)
        variants = [v[:2] for v in conv_variants(NANO_CONVS, cin, cout, t, x, res)]
        route = plan(cin, cout, t)["kernel"]
        for with_res, cat, xin, kw in conv_variants(NANO_CONVS, cin, cout, t, x, res):
            err, differ, ms, b_ms, b_by = conv_check(cin, cout, t, with_res, cat, xin, w_q, epi, kw)
            worst = max(worst, err)
            plain_ms = time_ms(lambda: qconv3x3_plain(xin, w_q, epi, act_scale, **kw),
                               iters=3, warmup=1)
            per_shape[(cin, cout, t, with_res, cat)] = dict(
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, max_abs_err=err,
                not_bit_equal_to_plain=differ, kernel=route)
            if route == "narrow":  # the stem, off the mma.sync kernel: bit for bit to both
                vs_mma = mma_differ(xin, w_q, epi, kw)
                check(differ == 0 and vs_mma == 0,
                      f"qconv narrow {(cin, cout, t, with_res, cat)}: {differ} elements differ "
                      f"from the plain version, {vs_mma} from the mma.sync kernel")
                per_shape[(cin, cout, t, with_res, cat)]["not_bit_equal_to_mma"] = vs_mma
        # the bare int8 GEMM of the same conv, im2col'd outside the timing
        lib_ms = int_mm_ms(x, w_q, act_scale)
        for v in variants:
            per_shape[(cin, cout, t) + v]["library_ms"] = lib_ms
        plain = per_shape[(cin, cout, t, False, False)]
        log("qconv", cin=cin, cout=cout, frames=t, batch=BATCH, kernel=route,
            ms={"+".join(n for n, on in zip(("res", "cat"), v) if on) or "plain":
                round(per_shape[(cin, cout, t) + v]["ms"], 4) for v in sorted(variants)},
            plain_ms=f"{plain['plain_ms']:.3f}", bound_ms=f"{plain['bound_ms']:.4f}",
            bound_by=plain["bound_by"], int_mm_ms=f"{lib_ms:.4f}")
        del x, res
    net = [per_shape[s] for s in NANO_CONVS]
    results["qconv3x3"] = dict(
        name="qconv3x3", route="cuda", source="azoom_torch/csrc/qconv_kernel.cu",
        replaces="azoom/pallas/qconv_kernel.py:53", max_abs_err=worst,
        ms=sum(p["ms"] for p in net), plain_ms=sum(p["plain_ms"] for p in net),
        bound_ms=sum(p["bound_ms"] for p in net), bound_by=bound_by_of(net),
        library_ms=sum(p["library_ms"] for p in net))
    log("qconv_net", convs=len(net), ms=f"{results['qconv3x3']['ms']:.4f}",
        bound_ms=f"{results['qconv3x3']['bound_ms']:.4f}",
        int_mm_ms=f"{results['qconv3x3']['library_ms']:.4f}", max_abs_err=f"{worst:.3e}")

    # the server's frame families: a full tick (80 frames: a 64-frame tile and
    # a 16-frame tail) and a reuse tick (48 frames; 6 at the bottleneck, where
    # 256 -> 256 runs on the split route). Split- and narrow-route shapes are
    # held bit for bit against the plain version and the mma.sync kernel.
    families, split_parts = {}, []
    for t0 in SERVER_FRAMES:
        convs = nano_convs(t0)
        fam = {}
        for cin, cout, t in dict.fromkeys(c[:3] for c in convs):
            x, w_q, epi, res = conv_operands(cin, cout, t)
            route = plan(cin, cout, t)["kernel"]
            for with_res, cat, xin, kw in conv_variants(convs, cin, cout, t, x, res):
                err, differ, ms, b_ms, b_by = conv_check(cin, cout, t, with_res, cat, xin, w_q,
                                                         epi, kw)
                worst = max(worst, err)
                key = (cin, cout, t, with_res, cat)
                fam[key] = dict(ms=ms, bound_ms=b_ms, bound_by=b_by, max_abs_err=err,
                                not_bit_equal_to_plain=differ, kernel=route)
                if route in ("split", "narrow"):
                    vs_mma = mma_differ(xin, w_q, epi, kw)
                    check(differ == 0 and vs_mma == 0,
                          f"qconv {route} {key}: {differ} elements differ from the plain "
                          f"version, {vs_mma} from the mma.sync kernel")
                    fam[key].update(not_bit_equal_to_mma=vs_mma, plain_ms=time_ms(
                        lambda: qconv3x3_plain(xin, w_q, epi, act_scale, **kw), iters=2, warmup=1))
            if route == "split":
                lib_ms = int_mm_ms(x, w_q, act_scale)
                for key in fam:
                    if key[:3] == (cin, cout, t):
                        fam[key]["library_ms"] = lib_ms
            del x, res
        net_t = [fam[c] for c in convs]
        if t0 == 48:  # the reuse tick's split launches, for the split route's line
            split_parts = [p for p in net_t if p["kernel"] == "split"]
        families[t0] = {str(k): v for k, v in fam.items()}
        log("qconv_family", frames=t0, shapes_checked=len(fam), batch=BATCH,
            net_ms=f"{sum(p['ms'] for p in net_t):.4f}",
            net_bound_ms=f"{sum(p['bound_ms'] for p in net_t):.4f}",
            elements_not_bit_equal_to_plain=sum(p["not_bit_equal_to_plain"] for p in fam.values()),
            max_abs_err=f"{max(p['max_abs_err'] for p in fam.values()):.3e}",
            kernels={k: [p["kernel"] for p in net_t].count(k) for k in route_counts},
            per_shape={f"{k[0]}-{k[1]}@{k[2]}" + "+res" * k[3] + "+cat" * k[4]:
                       (v["kernel"], round(v["ms"], 4)) for k, v in fam.items()})
    results["qconv3x3"]["max_abs_err"] = worst
    check(len(split_parts) == 4, f"reuse tick: {len(split_parts)} split-route convs, want 4")
    results["qconv3x3_split"] = dict(
        name="qconv3x3_split", route="cuda", source="azoom_torch/csrc/qconv_kernel.cu",
        replaces="azoom/pallas/qconv_kernel.py:53 (the split instance: 256 -> 256 at 6 frames "
                 "in the server's reuse tick)",
        max_abs_err=max(p["max_abs_err"] for p in split_parts),
        ms=sum(p["ms"] for p in split_parts), plain_ms=sum(p["plain_ms"] for p in split_parts),
        bound_ms=sum(p["bound_ms"] for p in split_parts), bound_by=bound_by_of(split_parts),
        library_ms=sum(p["library_ms"] for p in split_parts))

    # 4. upsampling -------------------------------------------------------------
    tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0)
    parts = []
    convt_shapes = {}
    worst = 0.0
    for k, cout, t in NANO_CONVT:
        x = torch.from_numpy(np.abs(rng.standard_normal((BATCH, F_ROWS, t, k))).astype(np.float32)).to(dev)
        w = torch.from_numpy((0.05 * rng.standard_normal((k, 2 * cout))).astype(np.float32)).to(dev)
        b = torch.from_numpy((0.1 * rng.standard_normal(cout)).astype(np.float32)).to(dev)
        got, ref = convt1x2(x, w, b), convt1x2_plain(x, w, b)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        rel = err / float(ref.abs().max())
        check(rel < 1e-6, f"convt {(k, cout, t)}: relative error {rel:.3e}")
        not_bit_equal = int((got != ref).sum())
        worst = max(worst, err)
        ms = device_ms(lambda: convt1x2(x, w, b))
        call_ms = time_ms(lambda: convt1x2(x, w, b))
        plain_ms = time_ms(lambda: convt1x2_plain(x, w, b), iters=2, warmup=1)
        x2, b2 = x.reshape(-1, k), b.repeat(2)
        lib_ms = device_ms(lambda: torch.addmm(b2, x2, w))
        p = x2.shape[0]
        b_ms, b_by = bound(4.0 * (p * k + k * 2 * cout + cout + p * 2 * cout),
                           2.0 * p * k * 2 * cout, FP32_FLOPS_PER_S)
        for key, v in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", b_ms), ("library_ms", lib_ms)):
            tot[key] += v
        parts.append(dict(bound_ms=b_ms, bound_by=b_by))
        convt_shapes[(k, cout, t)] = dict(ms=ms, call_ms=call_ms, plain_ms=plain_ms, bound_ms=b_ms,
                                          library_ms=lib_ms, not_bit_equal_to_plain=not_bit_equal)
        log("convt", k=k, cout=cout, frames=t, ms=f"{ms:.4f}", call_ms=f"{call_ms:.4f}",
            plain_ms=f"{plain_ms:.3f}", bound_ms=f"{b_ms:.4f}", bound_by=b_by,
            addmm_ms=f"{lib_ms:.4f}", max_abs_err=f"{err:.3e}", not_bit_equal_to_plain=not_bit_equal)
        del x, x2
    for t0 in SERVER_FRAMES:  # the server's frame families
        fam = {}
        for k, cout, t in nano_convt(t0):
            x = torch.from_numpy(np.abs(rng.standard_normal((BATCH, F_ROWS, t, k))).astype(np.float32)).to(dev)
            w = torch.from_numpy((0.05 * rng.standard_normal((k, 2 * cout))).astype(np.float32)).to(dev)
            b = torch.from_numpy((0.1 * rng.standard_normal(cout)).astype(np.float32)).to(dev)
            got, ref = convt1x2(x, w, b), convt1x2_plain(x, w, b)
            torch.cuda.synchronize()
            err = float((got - ref).abs().max())
            rel = err / float(ref.abs().max())
            check(rel < 1e-6, f"convt {(k, cout, t)}: relative error {rel:.3e}")
            worst = max(worst, err)
            p_rows = BATCH * F_ROWS * t
            b_ms, _ = bound(4.0 * (p_rows * k + k * 2 * cout + cout + p_rows * 2 * cout),
                            2.0 * p_rows * k * 2 * cout, FP32_FLOPS_PER_S)
            fam[(k, cout, t)] = dict(ms=device_ms(lambda: convt1x2(x, w, b)), bound_ms=b_ms,
                                     max_abs_err=err, not_bit_equal_to_plain=int((got != ref).sum()))
            del x, got, ref
        convt_shapes.update({(t0,) + key: v for key, v in fam.items()})
        log("convt_family", frames=t0, batch=BATCH,
            ms={f"{key[0]}->{2 * key[1]}@{key[2]}": round(v["ms"], 4) for key, v in fam.items()},
            bound_ms=f"{sum(v['bound_ms'] for v in fam.values()):.4f}",
            not_bit_equal_to_plain=[v["not_bit_equal_to_plain"] for v in fam.values()],
            max_abs_err=f"{max(v['max_abs_err'] for v in fam.values()):.3e}")
    results["convt1x2"] = dict(
        name="convt1x2", route="cuda", source="azoom_torch/csrc/convt_kernel.cu",
        replaces="azoom/models/unet.py:313 (XLA ConvTranspose, no Pallas kernel)",
        max_abs_err=worst, bound_by=bound_by_of(parts), **tot)

    # 5. main path ----------------------------------------------------------------
    model, _ = load_bundled("tpufpu_nano")
    cfg = PipelineConfig(mic_dist=0.04)
    main_kw = dict(feature_kind="physics", steer_deg=60.0)  # the nano net's features
    mix_np = (rng.standard_normal((BATCH, 2, N_SAMPLES)) * 0.1).astype(np.float32)
    mix = torch.from_numpy(mix_np).to(dev)
    torch.cuda.synchronize()
    kernels.reset_launches()
    routes_before = dict(route_counts)
    out = learned_enhance(mix, model, cfg, **main_kw)
    torch.cuda.synchronize()
    counts = active_launches()
    check(counts == {"qconv3x3": 21, "masked_mvdr": 1, "convt1x2": 3},
          f"main path launch counts {counts}")
    routes = {k: v - routes_before[k] for k, v in route_counts.items()}
    check(routes == {"wgmma": 20, "narrow": 1, "split": 0, "mma": 0},
          f"main path conv kernels {routes}")
    check(out.shape == (BATCH, N_SAMPLES) and bool(torch.isfinite(out).all()),
          "main path: bad output")
    for name, n in counts.items():
        results[name]["launches"] = n

    model_cpu, _ = load_bundled("tpufpu_nano", device="cpu")
    out_cpu = learned_enhance(mix[:4].cpu(), model_cpu, cfg, **main_kw)
    wave_rel = float((out[:4].cpu() - out_cpu).norm() / out_cpu.norm())
    Y4 = stft(mix[:4])
    mask_gpu = predict_mask(model, Y4, "physics").cpu()
    mask_cpu = predict_mask(model_cpu, Y4.cpu(), "physics")
    mask_err = (mask_gpu - mask_cpu).abs()
    check(float(mask_err.max()) < 1e-2, f"mask max error {float(mask_err.max()):.3e}")
    check(float(mask_err.mean()) < 2e-4, f"mask mean error {float(mask_err.mean()):.3e}")
    check(wave_rel <= 1e-2, f"waveform relative L2 {wave_rel:.3e}")

    times = []
    for _ in range(3):
        learned_enhance(mix, model, cfg, **main_kw)
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        learned_enhance(mix, model, cfg, **main_kw)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    med = statistics.median(times)
    rtf = BATCH * N_SAMPLES / 16_000 / (med / 1e3)
    log("main", batch=BATCH, samples=N_SAMPLES, launches=counts, conv_kernels=routes,
        ms_median=f"{med:.3f}",
        ms_all=[round(t, 3) for t in times], audio_seconds_per_second=f"{rtf:.1f}",
        mask_max_err=f"{float(mask_err.max()):.3e}", mask_mean_err=f"{float(mask_err.mean()):.3e}",
        wave_rel_l2=f"{wave_rel:.3e}")

    # where the time of one call goes, by device kernel
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def profile_call(phase: str, fn, path: str):
        """Profile one call of fn into chiprun_out/path; returns (rows of
        (kernel, device ms, launches), wall ms, device-busy ms)."""
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
        rows.sort(key=lambda r: -r[1])
        dev_ms = sum(r[1] for r in rows)
        (out_dir / path).write_text(prof.key_averages().table(
            sort_by="device_time_total", row_limit=40))
        log(phase, wall_ms=f"{wall_ms:.3f}", device_busy_ms=f"{dev_ms:.3f}",
            idle_share=f"{max(0.0, 1 - dev_ms / wall_ms):.3f}",
            top=[(k[:48], round(t, 3), n) for k, t, n in rows[:8]])
        return rows, wall_ms, dev_ms

    profile_call("profile", lambda: learned_enhance(mix, model, cfg, **main_kw),
                 "profile.txt")

    # 7. hard-null beamformer -------------------------------------------------
    mix_s, tgt_s, itf_s = (torch.from_numpy(a).to(dev) for a in far_field_scene(rng, BATCH, N_SAMPLES))
    Y = stft(mix_s)
    tmask = ibm_target_mask(stft(tgt_s), stft(itf_s))
    freqs = rfft_freqs(1024, 16_000, device=dev)
    d = steering_vector(freqs, 90.0, 0.04, normalize_phase=True)
    cond = hard_null_cond(Y, tmask, d)
    band = 1e-9  # float64 on both sides: the gate may flip only this close to the threshold
    # Scale covariance is checked at exact power-of-two scales, where s * Y is
    # exact and only a scale-dependent step could move the output, and at the
    # decimal scales where the gate acts; without a gate (threshold 1e6) rows
    # of cond up to ~1e3 amplify the float32 rounding of 1e-2 * Y beyond 1e-5.
    exact, decimal = (2.0**-7, 2.0**7), (1e-2, 1e2)
    worst = 0.0
    for thr in (1 + 1e-6, 10.0, 1e6):
        keep = (cond / thr - 1).abs() > band
        outs = {}
        for s in (1.0,) + decimal + exact:
            Ys = Y * s
            got = hard_null_fused(Ys, tmask, d, freqs, post_mask=tmask, cond_threshold=thr)
            ref = hard_null_plain(Ys, tmask, d, freqs, post_mask=tmask, cond_threshold=thr)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(torch.view_as_real(got)).all()), "hard_null: non-finite output")
            rel = float(row_rel(got, ref)[keep].max())
            check(rel <= 1e-5, f"hard_null: threshold {thr} scale {s}: row relative error {rel:.3e}")
            worst = max(worst, float((got - ref).abs().max()) / s)
            outs[s] = got
        cov = {s: float(row_rel(outs[s], outs[1.0] * s)[keep].max()) for s in decimal + exact}
        for s, c in cov.items():
            if s in exact or thr <= 10.0:
                check(c <= 1e-5, f"hard_null: not scale-covariant at threshold {thr}, x{s}: {c:.3e}")
        log("hard_null", threshold=thr, rows_in_band=int((~keep).sum()), rows=keep.numel(),
            rows_on_das=int((cond > thr).sum()),
            scale_cov_max_rel={f"x{s:g}": f"{c:.3e}" for s, c in cov.items()})
    ms = device_ms(lambda: hard_null_fused(Y, tmask, d, freqs, post_mask=tmask))
    call_ms = time_ms(lambda: hard_null_fused(Y, tmask, d, freqs, post_mask=tmask))
    plain_ms = time_ms(lambda: hard_null_plain(Y, tmask, d, freqs, post_mask=tmask), iters=5)
    n_el = BATCH * F * T
    # Y, target mask, post-filter mask in; S out. ~24 float64 flops per
    # element: the five covariance sums and the apply.
    b_ms, b_by = bound(n_el * (16 + 4 + 4 + 8) + F * (16 + 4), n_el * 24.0, FP64_FLOPS_PER_S)
    results["hard_null"] = dict(
        name="hard_null", route="cuda", source="azoom_torch/csrc/nullsteer_kernel.cu",
        replaces="azoom/pallas/nullsteer_kernel.py:30", max_abs_err=worst, ms=ms,
        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None)
    log("hard_null", shape=tuple(Y.shape), max_abs_err=f"{worst:.3e}", ms=f"{ms:.4f}",
        call_ms=f"{call_ms:.4f}", plain_ms=f"{plain_ms:.4f}", bound_ms=f"{b_ms:.4f}", bound_by=b_by)
    del Y

    # 8. int8 matmul: the microbenchmark path, then the checks -----------------
    operands = {}
    for shape in MICROBENCH_SHAPES:
        M, K, N = shape
        operands[shape] = (
            torch.from_numpy(rng.integers(-127, 127, (M, K)).astype(np.int8)).to(dev),
            torch.from_numpy(rng.integers(-127, 127, (K, N)).astype(np.int8)).to(dev))
    torch.cuda.synchronize()
    kernels.reset_launches()
    products = {shape: int8_mm(x, w) for shape, (x, w) in operands.items()}
    torch.cuda.synchronize()
    mm_counts = active_launches()
    check(mm_counts == {"int8_mm": len(MICROBENCH_SHAPES)}, f"int8_mm launch counts {mm_counts}")
    tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0)
    mm_parts = {}
    mm_err = 0
    for shape, (x, w) in operands.items():
        M, K, N = shape
        err = int((products[shape].to(torch.int64) - int8_mm_plain(x, w)).abs().max())
        check(err == 0, f"int8_mm {shape}: max abs error {err}, not exact")
        mm_err = max(mm_err, err)
        # Kernel time from a replayed graph (both launches of int8_mm: the
        # transpose of w and the product); call_ms is the same call in a loop
        # from Python, which the host bounds near 0.05 ms.
        ms = device_ms(lambda: int8_mm(x, w))
        call_ms = time_ms(lambda: int8_mm(x, w))
        plain_ms = time_ms(lambda: int8_mm_plain(x, w), iters=3, warmup=1)
        w_cm = w.t().contiguous().t()  # column-major B, the layout cuBLASLt's int8 GEMM takes
        lib_ms = device_ms(lambda: torch._int_mm(x, w_cm))
        b_ms, b_by = bound(M * K + K * N + 4 * M * N, 2.0 * M * K * N, INT8_OPS_PER_S)
        for key, v in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", b_ms), ("library_ms", lib_ms)):
            tot[key] += v
        mm_parts[shape] = dict(ms=ms, call_ms=call_ms, plain_ms=plain_ms, bound_ms=b_ms,
                               bound_by=b_by, library_ms=lib_ms, scripts=MICROBENCH_SHAPES[shape])
        log("int8_mm", M=M, K=K, N=N, ms=f"{ms:.4f}", call_ms=f"{call_ms:.4f}",
            int_mm_ms=f"{lib_ms:.4f}",
            plain_ms=f"{plain_ms:.3f}", bound_ms=f"{b_ms:.4f}", bound_by=b_by,
            tops=f"{2.0 * M * K * N / ms / 1e9:.1f}")
    del operands, products
    results["int8_mm"] = dict(
        name="int8_mm", route="cuda", source="azoom_torch/csrc/int8_mm_kernel.cu",
        replaces="scripts/microbench_pallas_mm.py:35 (and scripts/microbench_int8.py:53, "
                 "scripts/microbench_int8b.py:41)",
        launches=mm_counts["int8_mm"], max_abs_err=float(mm_err),
        bound_by=bound_by_of(list(mm_parts.values())), **tot)

    # 9. the hard-null main path ----------------------------------------------
    hn_kw = dict(beamformer="hard_null", feature_kind="physics", steer_deg=60.0, fov_deg=30.0)
    torch.cuda.synchronize()
    kernels.reset_launches()
    out = learned_enhance(mix, model, cfg, **hn_kw)
    torch.cuda.synchronize()
    hn_counts = active_launches()
    check(hn_counts == {"qconv3x3": 21, "convt1x2": 3, "hard_null": 1},
          f"hard-null path launch counts {hn_counts}")
    check(out.shape == (BATCH, N_SAMPLES) and bool(torch.isfinite(out).all()),
          "hard-null path: bad output")
    results["hard_null"]["launches"] = hn_counts["hard_null"]
    out_cpu = learned_enhance(mix[:4].cpu(), model_cpu, cfg, **hn_kw)
    hn_wave_rel = float((out[:4].cpu() - out_cpu).norm() / out_cpu.norm())
    check(hn_wave_rel <= 1e-2, f"hard-null waveform relative L2 {hn_wave_rel:.3e}")
    hn_times = []
    for _ in range(3):
        learned_enhance(mix, model, cfg, **hn_kw)
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        learned_enhance(mix, model, cfg, **hn_kw)
        torch.cuda.synchronize()
        hn_times.append((time.perf_counter() - t0) * 1e3)
    hn_med = statistics.median(hn_times)
    log("main_hard_null", batch=BATCH, samples=N_SAMPLES, launches=hn_counts,
        ms_median=f"{hn_med:.3f}", ms_all=[round(t, 3) for t in hn_times],
        audio_seconds_per_second=f"{BATCH * N_SAMPLES / 16_000 / (hn_med / 1e3):.1f}",
        mask_max_err=f"{float(mask_err.max()):.3e} (phase 5, same mixture)",
        wave_rel_l2=f"{hn_wave_rel:.3e}")
    profile_call("profile_hard_null", lambda: learned_enhance(mix, model, cfg, **hn_kw),
                 "profile_hard_null.txt")

    # 10. the chunked stream of one long recording -------------------------------
    rec = torch.from_numpy(far_field_scene(rng, 1, 60 * 16_000)[0][0]).to(dev)
    st_kw = dict(beamformer="hard_null", feature_kind="physics")
    kernels.reset_launches()
    streamed = learned_enhance_streaming(rec, model, cfg, **st_kw)
    torch.cuda.synchronize()
    st_counts = active_launches()
    chunks, n = chunk_signal(rec, cfg.win_size, cfg.win_size // 2)
    batched = overlap_add_chunks(learned_enhance(chunks, model, cfg, **st_kw),
                                 cfg.win_size // 2, n)
    check(chunks.shape[0] == 59, f"{chunks.shape[0]} chunks, expected 59")
    check(torch.equal(streamed, batched), "stream differs from the batched call over its chunks")
    check(st_counts == {"qconv3x3": 21, "convt1x2": 3, "hard_null": 1},
          f"stream launch counts {st_counts}")
    pre = rec[:, :6 * 16_000]
    pre_gpu = learned_enhance_streaming(pre, model, cfg, **st_kw).cpu()
    pre_cpu = learned_enhance_streaming(pre.cpu(), model_cpu, cfg, **st_kw)
    st_rel = float((pre_gpu - pre_cpu).norm() / pre_cpu.norm())
    check(st_rel <= 1e-2, f"stream 6 s prefix: waveform relative L2 {st_rel:.3e}")
    st_times = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        learned_enhance_streaming(rec, model, cfg, **st_kw)
        torch.cuda.synchronize()
        st_times.append((time.perf_counter() - t0) * 1e3)
    st_med = statistics.median(st_times[1:])
    log("stream", seconds=60, chunks=chunks.shape[0], launches=st_counts,
        ms_median=f"{st_med:.3f}", ms_per_recorded_second=f"{st_med / 60:.4f}",
        ms_all=[round(t, 3) for t in st_times], prefix_wave_rel_l2=f"{st_rel:.3e}")
    del chunks, batched

    # 11. the oracle path ---------------------------------------------------------
    ocfg = PipelineConfig(mic_dist=0.04)
    kernels.reset_launches()
    o_gpu = oracle_enhance(mix_s, tgt_s, itf_s, ocfg, post_filter="irm")
    torch.cuda.synchronize()
    o_counts = active_launches()
    check(o_counts == {"masked_mvdr": 1}, f"oracle path launch counts {o_counts}")
    o_cpu = oracle_enhance(mix_s.cpu(), tgt_s.cpu(), itf_s.cpu(), ocfg, post_filter="irm")
    o_rel = float((o_gpu.cpu() - o_cpu).norm() / o_cpu.norm())
    sir_gpu = osinr_osir(o_gpu.cpu(), tgt_s.cpu(), itf_s.cpu())[1]
    sir_cpu = osinr_osir(o_cpu, tgt_s.cpu(), itf_s.cpu())[1]
    sir_in = osinr_osir(mix_s[:, 0].cpu(), tgt_s.cpu(), itf_s.cpu())[1]
    d_sir = float((sir_gpu - sir_cpu).abs().max())
    check(bool(torch.isfinite(o_gpu).all()) and o_gpu.shape == tgt_s.shape, "oracle: bad output")
    check(d_sir <= 0.05, f"oracle: SIR card vs CPU differs by {d_sir:.4f} dB")
    o_ms = time_ms(lambda: oracle_enhance(mix_s, tgt_s, itf_s, ocfg, post_filter="irm"),
                   iters=5, warmup=1)
    log("oracle", batch=BATCH, launches=o_counts, wave_rel_l2=f"{o_rel:.3e}",
        sir_db_mean=f"{float(sir_gpu.mean()):.3f}", sir_in_db_mean=f"{float(sir_in.mean()):.3f}",
        sir_max_abs_diff_db=f"{d_sir:.2e}", ms=f"{o_ms:.3f}")

    # 12. the live server ----------------------------------------------------------
    from azoom_torch import AudioZoom, AudioZoomServer

    scfg = PipelineConfig(mic_dist=0.04, win_size=32_768)
    win, hop, n_ticks = scfg.win_size, scfg.win_size // 2, 10
    steers = np.linspace(30.0, 150.0, BATCH)
    zooms = np.linspace(0.0, 1.0, BATCH)
    itf = np.stack([np.clip(steers - 45.0, 5.0, 175.0), np.clip(steers + 45.0, 5.0, 175.0)], 1)
    srv_mix = far_field_scene(rng, BATCH, win + n_ticks * hop,
                              angles=np.concatenate([steers[:, None], itf], axis=1))[0]
    n_cpu_ticks = 3  # the first 4 streams, held against the CPU over the prime and 3 ticks
    server_stats = {}
    for name, kw, want in (
            ("reuse_int16", dict(mask_reuse=True, wire="int16"), np.int16),
            ("full_float32", dict(mask_reuse=False, wire="float32"), np.float32)):
        blocks = np.clip(srv_mix * 32767.0, -32767, 32767).astype(np.int16) \
            if kw["wire"] == "int16" else srv_mix
        servers = {}
        for where, S in (("cuda", BATCH), ("cpu", 4)):
            srv = AudioZoomServer(S, cfg=scfg, track=True, device=where, **kw)
            for st in range(S):
                srv.set_zoom(st, direction_deg=float(steers[st]), zoom=float(zooms[st]))
            servers[where] = srv
        srv = servers["cuda"]
        # the host's share of a tick: the momentum filters' NumPy step, timed
        track_ms = []
        host_update = srv._tracker.update

        def timed_update(*args):
            t_up = time.perf_counter()
            bearings_now = host_update(*args)
            track_ms.append((time.perf_counter() - t_up) * 1e3)
            return bearings_now

        srv._tracker.update = timed_update
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        srv.push(blocks[:, :, :win])
        prime_ms = (time.perf_counter() - t0) * 1e3
        track_ms.clear()
        cpu_outs = [servers["cpu"].push(blocks[:4, :, :win])]
        outs, tick_ms, tick_launches, tick_routes, moved = [], [], [], [], []
        for k in range(n_ticks):
            blk = blocks[:, :, win + k * hop:win + (k + 1) * hop]
            before = dict(srv.bytes_moved)
            torch.cuda.synchronize()
            kernels.reset_launches()
            routes_before = dict(route_counts)
            t0 = time.perf_counter()
            out = srv.push(blk)
            tick_ms.append((time.perf_counter() - t0) * 1e3)
            tick_launches.append(active_launches())
            tick_routes.append({r: route_counts[r] - routes_before[r] for r in route_counts})
            moved.append({d: srv.bytes_moved[d] - before[d] for d in before})
            outs.append(out)
            if k < n_cpu_ticks:
                cpu_outs.append(servers["cpu"].push(blk[:4]))
                check(np.array_equal(srv.bearings[:4], servers["cpu"].bearings),
                      f"server {name}: bearings after tick {k} differ from the CPU's: "
                      f"{srv.bearings[:4]} vs {servers['cpu'].bearings}")
        # a reuse tick runs the net on 48 frames (256 -> 256 at 6 on the split
        # route), a full one on 80; the stem on the narrow route
        want_routes = ({"wgmma": 16, "narrow": 1, "split": 4, "mma": 0} if name == "reuse_int16"
                       else {"wgmma": 20, "narrow": 1, "split": 0, "mma": 0})
        for k, (c, r) in enumerate(zip(tick_launches, tick_routes)):
            check(c == {"qconv3x3": 21, "convt1x2": 3, "masked_mvdr": 1},
                  f"server {name}: tick {k} launch counts {c}")
            check(r == want_routes, f"server {name}: tick {k} conv kernels {r}")
        if name == "reuse_int16":
            results["masked_mvdr_per_stream"]["launches"] = sum(
                c["masked_mvdr"] for c in tick_launches)
            results["qconv3x3_split"]["launches"] = sum(r["split"] for r in tick_routes)
        out = np.concatenate(outs, axis=1)
        check(out.dtype == want and out.shape == (BATCH, n_ticks * hop), f"server {name}: bad output")
        f_out = out.astype(np.float32) / (32767.0 if want == np.int16 else 1.0)
        check(bool(np.isfinite(f_out).all()), f"server {name}: non-finite output")
        a = np.concatenate(outs[:n_cpu_ticks], axis=1)[:4].astype(np.float32)
        b = np.concatenate(cpu_outs[1:], axis=1).astype(np.float32)
        srv_rel = float(np.linalg.norm(a - b) / np.linalg.norm(b))
        check(srv_rel <= 1e-2, f"server {name}: first 4 streams vs CPU, waveform relative L2 {srv_rel:.3e}")
        med = statistics.median(tick_ms[1:])
        per_tick = moved[-1]
        server_stats[name] = dict(
            streams=BATCH, win_size=win, hop=hop, ticks=n_ticks, prime_ms=prime_ms,
            tick_ms=tick_ms, tick_ms_median=med, launches_per_tick=tick_launches[-1],
            host_tracking_ms=track_ms, host_tracking_ms_median=statistics.median(track_ms),
            bytes_per_tick=per_tick, streams_real_time=BATCH * (hop / scfg.fs) / (med / 1e3),
            cpu_wave_rel_l2=srv_rel, bearings=srv.bearings[:8].tolist())
        log("server", mode=name, streams=BATCH, ticks=n_ticks, launches_per_tick=tick_launches[-1],
            conv_kernels_per_tick=tick_routes[-1],
            prime_ms=f"{prime_ms:.2f}", tick_ms_median=f"{med:.3f}",
            host_tracking_ms_median=f"{statistics.median(track_ms):.3f}",
            tick_ms_all=[round(t, 2) for t in tick_ms],
            to_device_bytes_per_tick=per_tick["to_device"], to_host_bytes_per_tick=per_tick["to_host"],
            streams_real_time=f"{server_stats[name]['streams_real_time']:.1f}",
            cpu_first4_wave_rel_l2=f"{srv_rel:.3e}", bearings_0_4=srv.bearings[:4].tolist())
        if name == "reuse_int16":
            blk = blocks[:, :, :hop]
            profile_call("profile_server", lambda: srv.push(blk), "profile_server.txt")
        del servers, srv
    del srv_mix

    # 13. the facade ----------------------------------------------------------------
    clip = far_field_scene(rng, 1, 6 * 16_000, angles=(65.0, 20.0, 130.0))[0][0]
    facade = {}
    zoom_kw = dict(model="tpufpu_nano", int8=True, direction_deg=75.0, fov_deg=60.0, zoom=0.4)
    z_gpu, z_cpu = AudioZoom(**zoom_kw), AudioZoom(device="cpu", **zoom_kw)
    kernels.reset_launches()
    e_gpu = z_gpu.enhance(clip[:, :32_000])
    torch.cuda.synchronize()
    e_counts = active_launches()
    check(e_counts == {"qconv3x3": 21, "convt1x2": 3, "masked_mvdr": 1},
          f"facade enhance launch counts {e_counts}")
    e_cpu = z_cpu.enhance(clip[:, :32_000])
    e_rel = float(np.linalg.norm(e_gpu - e_cpu) / np.linalg.norm(e_cpu))
    check(e_gpu.shape == (32_000,) and bool(np.isfinite(e_gpu).all()), "facade enhance: bad output")
    check(e_rel <= 1e-2, f"facade enhance: waveform relative L2 {e_rel:.3e} against the CPU")
    e_times = []
    for _ in range(5):
        t0 = time.perf_counter()
        z_gpu.enhance(clip[:, :32_000])
        e_times.append((time.perf_counter() - t0) * 1e3)
    z_gpu = AudioZoom(track=True, tracker="momentum", **zoom_kw)
    z_cpu = AudioZoom(track=True, tracker="momentum", device="cpu", **zoom_kw)
    p_gpu, p_cpu, push_ms, bearings = [], [], [], []
    for block in np.array_split(clip, 12, axis=1):
        t0 = time.perf_counter()
        p_gpu.append(z_gpu.push(block))
        push_ms.append((time.perf_counter() - t0) * 1e3)
        p_cpu.append(z_cpu.push(block))
        bearings.append(z_gpu._track_theta)
        check(z_gpu._track_theta == z_cpu._track_theta,
              f"facade push: bearing {z_gpu._track_theta} vs {z_cpu._track_theta} on the CPU")
    p_gpu, p_cpu = np.concatenate(p_gpu), np.concatenate(p_cpu)
    p_rel = float(np.linalg.norm(p_gpu - p_cpu) / np.linalg.norm(p_cpu))
    check(p_gpu.shape == (6 * 16_000 - 2 * 16_000,) and bool(np.isfinite(p_gpu).all()),
          f"facade push: bad output {p_gpu.shape}")
    check(p_rel <= 1e-2, f"facade push: waveform relative L2 {p_rel:.3e} against the CPU")
    windows = 1 + (clip.shape[-1] - 32_000) // 16_000
    facade = dict(enhance_ms=e_times, enhance_wave_rel_l2=e_rel, push_ms=push_ms,
                  push_wave_rel_l2=p_rel, bearings=bearings, enhance_launches=e_counts)
    log("facade", enhance_launches=e_counts, enhance_ms_median=f"{statistics.median(e_times):.3f}",
        enhance_wave_rel_l2=f"{e_rel:.3e}", push_seconds=6, pushes=len(push_ms),
        ms_per_window=f"{sum(push_ms) / windows:.3f}",
        push_wave_rel_l2=f"{p_rel:.3e}", bearings=bearings)

    # 14. whole-clip tracking --------------------------------------------------------
    from azoom_torch.localize.srp import ipd_angle_histogram
    from azoom_torch.pipelines.tracked import TRACKERS, track_bearings, tracked_autosteer_enhance

    seconds = 128
    clip = moving_scene(rng, seconds * 16_000)  # 127 chunks of 2 s at 50 %
    clip_gpu = torch.from_numpy(clip).to(dev)
    tr_kw = dict(fov_center_deg=90.0, fov_width_deg=90.0)
    tracked, theta_cpu_of = {}, {}
    for tracker in TRACKERS:  # the heuristic path (no net): the tracker and B1 per chunk
        out, theta = tracked_autosteer_enhance(clip_gpu, cfg, tracker=tracker, **tr_kw)
        torch.cuda.synchronize()
        out_cpu, theta_cpu = tracked_autosteer_enhance(clip, cfg, tracker=tracker, device="cpu",
                                                       **tr_kw)
        check(out.shape == (seconds * 16_000,) and bool(torch.isfinite(out).all()),
              f"tracked {tracker}: bad output")
        check(theta.shape == (127,) and torch.equal(theta.cpu(), theta_cpu),
              f"tracked {tracker}: bearings differ from the CPU's")
        theta_cpu_of[tracker] = theta_cpu
        rel = float((out.cpu() - out_cpu).norm() / out_cpu.norm())
        check(rel <= 1e-2, f"tracked {tracker}: waveform relative L2 {rel:.3e} against the CPU")
        tracked[tracker] = dict(wave_rel_l2=rel, bearings_first_last=[float(theta[0]),
                                                                      float(theta[-1])])
    # the trackers alone on the clip's (127, 181) histograms: on the card, and
    # on the host after one copy of the histograms
    chunks_gpu, _ = chunk_signal(clip_gpu, cfg.win_size, cfg.win_size // 2)
    angles_gpu, hists_gpu = ipd_angle_histogram(stft(chunks_gpu), cfg.mic_dist, cfg.fs)
    center = torch.tensor(90.0)
    for tracker in TRACKERS:
        def on_card():
            return track_bearings(tracker, angles_gpu, hists_gpu, center.to(dev), 90.0)

        def on_host():
            return track_bearings(tracker, angles_gpu.cpu(), hists_gpu.cpu(), center, 90.0)

        check(torch.equal(on_card().cpu(), on_host()), f"tracker {tracker}: card and host differ")
        for where, fn in (("card_ms", on_card), ("host_ms", on_host)):
            ts = []
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn().cpu()
                ts.append((time.perf_counter() - t0) * 1e3)
            tracked[tracker][where] = statistics.median(ts[1:])
        log("tracker", tracker=tracker, chunks=127, card_ms=f"{tracked[tracker]['card_ms']:.3f}",
            host_ms=f"{tracked[tracker]['host_ms']:.3f}",
            wave_rel_l2_vs_cpu=f"{tracked[tracker]['wave_rel_l2']:.3e}",
            bearings_first_last=tracked[tracker]["bearings_first_last"])
    del chunks_gpu, hists_gpu
    learned_tracked = {}
    pre = clip[:, :6 * 16_000]  # 5 chunks: the prefix held against the CPU
    for beamformer, kernel, tracker in (("mvdr", "masked_mvdr", "viterbi"),
                                        ("hard_null", "hard_null", "momentum")):
        kw = dict(model=model, feature_kind="physics", beamformer=beamformer, tracker=tracker,
                  **tr_kw)
        torch.cuda.synchronize()
        kernels.reset_launches()
        out, theta = tracked_autosteer_enhance(clip_gpu, cfg, **kw)
        torch.cuda.synchronize()
        counts = active_launches()
        check(counts == {"qconv3x3": 21, "convt1x2": 3, kernel: 1},
              f"learned tracked {beamformer}: launch counts {counts}")
        check(out.shape == (seconds * 16_000,) and bool(torch.isfinite(out).all()),
              f"learned tracked {beamformer}: bad output")
        check(torch.equal(theta.cpu(), theta_cpu_of[tracker]),
              f"learned tracked {beamformer}: bearings differ from the CPU's")
        p_gpu, th_gpu = tracked_autosteer_enhance(torch.from_numpy(pre).to(dev), cfg, **kw)
        p_cpu, th_cpu = tracked_autosteer_enhance(
            pre, cfg, device="cpu", **{**kw, "model": model_cpu})
        check(torch.equal(th_gpu.cpu(), th_cpu), f"learned tracked {beamformer}: prefix bearings")
        rel = float((p_gpu.cpu() - p_cpu).norm() / p_cpu.norm())
        check(rel <= 1e-2,
              f"learned tracked {beamformer}: 6 s prefix, waveform relative L2 {rel:.3e}")
        ts = []
        for _ in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tracked_autosteer_enhance(clip_gpu, cfg, **kw)
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        med = statistics.median(ts[1:])
        learned_tracked[beamformer] = dict(launches=counts, ms=ts, ms_median=med,
                                           ms_per_recorded_second=med / seconds,
                                           prefix_wave_rel_l2=rel, tracker=tracker)
        if beamformer == "mvdr":
            profile_call("profile_tracked", lambda: tracked_autosteer_enhance(clip_gpu, cfg, **kw),
                         "profile_tracked.txt")
        log("tracked", beamformer=beamformer, tracker=tracker, seconds=seconds, chunks=127,
            launches=counts, ms_median=f"{med:.3f}", ms_per_recorded_second=f"{med / seconds:.4f}",
            ms_all=[round(t, 2) for t in ts], prefix_wave_rel_l2=f"{rel:.3e}",
            bearings_first_last=[float(theta[0]), float(theta[-1])])
    # the facade: enhance of the whole clip with track=True
    zkw = dict(model="tpufpu_nano", int8=True, track=True, direction_deg=90.0, fov_deg=90.0,
               zoom=0.4)
    z_gpu = AudioZoom(**zkw)
    kernels.reset_launches()
    t0 = time.perf_counter()
    z_out = z_gpu.enhance(clip)
    z_ms = (time.perf_counter() - t0) * 1e3
    z_counts = active_launches()
    check(z_counts == {"qconv3x3": 21, "convt1x2": 3, "masked_mvdr": 1},
          f"facade tracked enhance: launch counts {z_counts}")
    check(z_out.shape == (seconds * 16_000,) and bool(np.isfinite(z_out).all()),
          "facade tracked enhance: bad output")
    z_pre_cpu = AudioZoom(device="cpu", **zkw).enhance(pre)
    z_rel = float(np.linalg.norm(z_gpu.enhance(pre) - z_pre_cpu) / np.linalg.norm(z_pre_cpu))
    check(z_rel <= 1e-2, f"facade tracked enhance: 6 s prefix, waveform relative L2 {z_rel:.3e}")
    log("tracked_facade", seconds=seconds, launches=z_counts, ms=f"{z_ms:.3f}",
        prefix_wave_rel_l2=f"{z_rel:.3e}")
    del clip_gpu

    # B3 per chunk: 128 chunks, each steered at its own bearing
    Y = stft(mix_s)
    tmask = ibm_target_mask(stft(tgt_s), stft(itf_s))
    freqs = rfft_freqs(1024, 16_000, device=dev)
    d_c = steering_vector(freqs, torch.linspace(30.0, 150.0, BATCH, device=dev), 0.04,
                          normalize_phase=True)
    got = hard_null_fused(Y, tmask, d_c, freqs, post_mask=tmask)
    ref = hard_null_plain(Y, tmask, d_c, freqs, post_mask=tmask)
    torch.cuda.synchronize()
    keep = (hard_null_cond(Y, tmask, d_c) / 10.0 - 1).abs() > 1e-9
    rel = float(row_rel(got, ref)[keep].max())
    check(bool(torch.isfinite(torch.view_as_real(got)).all()), "hard_null per chunk: non-finite")
    check(rel <= 1e-5, f"hard_null per chunk: row relative error {rel:.3e}")
    shared = hard_null_fused(Y, tmask, d_c[BATCH // 2], freqs, post_mask=tmask)
    each = hard_null_fused(Y, tmask, d_c[BATCH // 2].expand(BATCH, F, 2).contiguous(), freqs,
                           post_mask=tmask)
    torch.cuda.synchronize()
    differ = int((shared != each).sum())
    check(differ == 0,
          f"hard_null: shared steering differs from per-chunk steering in {differ} elements")
    ms = device_ms(lambda: hard_null_fused(Y, tmask, d_c, freqs, post_mask=tmask))
    shared_ms = device_ms(lambda: hard_null_fused(Y, tmask, d_c[BATCH // 2], freqs,
                                                  post_mask=tmask))
    call_ms = time_ms(lambda: hard_null_fused(Y, tmask, d_c, freqs, post_mask=tmask))
    plain_ms = time_ms(lambda: hard_null_plain(Y, tmask, d_c, freqs, post_mask=tmask), iters=5)
    n_el = BATCH * F * T
    # Y, target mask, post-filter mask in, S out; d (F, 2) per chunk; freqs
    b_ms, b_by = bound(n_el * (16 + 4 + 4 + 8) + BATCH * F * 16 + F * 4, n_el * 24.0,
                       FP64_FLOPS_PER_S)
    results["hard_null_per_chunk"] = dict(
        name="hard_null_per_chunk", route="cuda", source="azoom_torch/csrc/nullsteer_kernel.cu",
        replaces="azoom/pallas/nullsteer_kernel.py:30 (jax.vmap over chunks, "
                 "azoom/pipelines/tracked.py:216)",
        launches=learned_tracked["hard_null"]["launches"]["hard_null"],
        max_abs_err=float((got - ref).abs().max()), ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=None)
    log("hard_null_per_chunk", shape=tuple(Y.shape), steers="30..150", row_rel_err=f"{rel:.3e}",
        shared_vs_per_chunk_elements_differ=differ, ms=f"{ms:.4f}", shared_ms=f"{shared_ms:.4f}",
        call_ms=f"{call_ms:.4f}", plain_ms=f"{plain_ms:.4f}", bound_ms=f"{b_ms:.4f}", bound_by=b_by)
    del Y, got, ref, shared, each

    # 15. the HRNR post-filter -----------------------------------------------------------
    from azoom_torch.beam.postfilter import harmonic_regeneration

    hrnr = {}
    for beamformer, kernel in (("mvdr", "masked_mvdr"), ("hard_null", "hard_null")):
        kw = dict(beamformer=beamformer, feature_kind="physics", steer_deg=90.0,
                  harmonic_regen=True)
        torch.cuda.synchronize()
        kernels.reset_launches()
        out = learned_enhance(mix_s, model, cfg, **kw)
        torch.cuda.synchronize()
        counts = active_launches()
        check(counts == {"qconv3x3": 21, "convt1x2": 3, kernel: 1},
              f"hrnr {beamformer}: launch counts {counts}")
        check(out.shape == (BATCH, N_SAMPLES) and bool(torch.isfinite(out).all()),
              f"hrnr {beamformer}: bad output")
        out_cpu = learned_enhance(mix_s[:4].cpu(), model_cpu, cfg, **kw)
        rel = float((out[:4].cpu() - out_cpu).norm() / out_cpu.norm())
        check(rel <= 1e-2, f"hrnr {beamformer}: waveform relative L2 {rel:.3e} against the CPU")
        ts = []
        for _ in range(8):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            learned_enhance(mix_s, model, cfg, **kw)
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        hrnr[beamformer] = dict(launches=counts, ms=ts, ms_median=statistics.median(ts[2:]),
                                wave_rel_l2=rel)
        log("hrnr", beamformer=beamformer, batch=BATCH, launches=counts,
            ms_median=f"{hrnr[beamformer]['ms_median']:.3f}", ms_all=[round(t, 2) for t in ts],
            wave_rel_l2=f"{rel:.3e}")
    # the stage alone on the MVDR path's spectrum and gain: device time by kernel
    Y = stft(mix_s)
    S_bf = masked_mvdr_fused(Y, 1.0 - tmask, steering_vector(freqs, 90.0, 0.04), freqs,
                             target_mask=None, sigma=cfg.sigma, hp_cutoff_hz=cfg.hp_cutoff_hz)
    g1 = torch.clamp(tmask, min=0.05)
    harmonic_regeneration(S_bf, g1, 1024, 512, N_SAMPLES)
    profile_call("profile_hrnr", lambda: harmonic_regeneration(S_bf, g1, 1024, 512, N_SAMPLES),
                 "profile_hrnr.txt")
    del Y, S_bf

    # 16. every bundled conv net -----------------------------------------------------------
    from azoom_torch.kernels.qconv_kernel import pack_weights
    from azoom_torch.models.unet import ConvTranspose1x2, conv_shapes

    conv_sets = {"fpu": 513, "deepfpu": 513, "tpufpu": F_ROWS, "tpufpu_slim": F_ROWS}
    set_shapes, narrow_parts = {}, []
    # operands made on the card from a seed: numpy took ~6 s a shape at 513 rows
    gen = torch.Generator(device=dev)
    gen.manual_seed(16)
    for net, rows in conv_sets.items():
        convs = conv_shapes(load_bundled(net, device="cpu")[0], 64)
        shapes = {}
        for cin, cout, t in dict.fromkeys(c[:3] for c in convs):
            x = torch.randn((BATCH, rows, t, cin), generator=gen, device=dev).abs_()
            w_q = pack_weights(torch.randint(-127, 128, (3, 3, cin, cout), generator=gen,
                                             device=dev, dtype=torch.int8))
            epi = torch.from_numpy(np.stack([
                np.full(cout, 2e-4), 0.1 * rng.standard_normal(cout),
                0.1 * rng.standard_normal(cout), 1 + 0.1 * rng.standard_normal(cout),
                0.1 * rng.standard_normal(cout)]).astype(np.float32)).to(dev)
            res = torch.randn((BATCH, rows, t, cout), generator=gen, device=dev)
            for with_res, cat in sorted({c[3:] for c in convs if c[:3] == (cin, cout, t)}):
                kw = dict(residual=res if with_res else None)
                xin = x
                if cat:
                    xin, kw["x2"] = x[..., :cin // 2].contiguous(), x[..., cin // 2:].contiguous()
                err, differ, ms, b_ms, b_by = conv_check(cin, cout, t, with_res, cat, xin, w_q,
                                                         epi, kw, rows=rows)
                check(differ == 0, f"qconv {net} {(cin, cout, t, with_res, cat)}: {differ} "
                                   "elements differ from the plain version")
                route = plan(cin, cout, t)["kernel"]
                vs_mma = 0
                if route in ("split", "narrow"):  # against the mma.sync kernel they replaced
                    vs_mma = mma_differ(xin, w_q, epi, kw)
                    check(vs_mma == 0, f"qconv {net} {(cin, cout, t, with_res, cat)}: {vs_mma} "
                                       "elements differ from the mma.sync kernel")
                plain_ms = time_ms(lambda: qconv3x3_plain(xin, w_q, epi, act_scale, **kw),
                                   iters=2, warmup=1)
                shapes[(cin, cout, t, with_res, cat)] = dict(
                    ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, max_abs_err=err,
                    not_bit_equal_to_plain=differ, not_bit_equal_to_mma=vs_mma, kernel=route)
            # the bare int8 GEMM: im2col'd codes (a stem's channels zero-extended, as
            # the kernel takes them) times the packed weights, outside the timing
            lib_ms = int_mm_ms(x, w_q, act_scale)
            for key in shapes:
                if key[:3] == (cin, cout, t):
                    shapes[key]["library_ms"] = lib_ms
            del x, res
        parts = [shapes[c] for c in convs]
        kernel_of = [p["kernel"] for p in parts]
        check("mma" not in kernel_of, f"qconv {net}: convs on the mma.sync kernel {kernel_of}")
        narrow_parts += [p for p in parts if p["kernel"] == "narrow"]
        results[f"qconv3x3_{net}"] = dict(
            name=f"qconv3x3_{net}", route="cuda",
            source="azoom_torch/csrc/qconv_kernel.cu",  # every route of these nets
            replaces="azoom/pallas/qconv_kernel.py:53 (the int8 QConv convs of "
                     "azoom/models/unet.py:96 in the bundled " + net + ")",
            max_abs_err=max(p["max_abs_err"] for p in parts),
            ms=sum(p["ms"] for p in parts), plain_ms=sum(p["plain_ms"] for p in parts),
            bound_ms=sum(p["bound_ms"] for p in parts), bound_by=bound_by_of(parts),
            library_ms=sum(p["library_ms"] for p in parts))
        set_shapes[net] = {str(k): v for k, v in shapes.items()}
        log("qconv_set", net=net, rows=rows, frames=64, batch=BATCH, convs=len(convs),
            shapes_checked=len(shapes), elements_not_bit_equal_to_plain=0,
            kernels={k: kernel_of.count(k) for k in route_counts},
            ms=f"{results[f'qconv3x3_{net}']['ms']:.4f}",
            bound_ms=f"{results[f'qconv3x3_{net}']['bound_ms']:.4f}",
            int_mm_ms=f"{results[f'qconv3x3_{net}']['library_ms']:.4f}",
            per_shape={f"{k[0]}-{k[1]}@{k[2]}" + "+res" * k[3] + "+cat" * k[4]:
                       (v["kernel"], round(v["ms"], 4)) for k, v in shapes.items()})
    # the narrow route: the stems and Cout = 32 of the four sets, each conv as often as its net
    # runs it; launches from the sets' int8 runs below
    results["qconv3x3_narrow"] = dict(
        name="qconv3x3_narrow", route="cuda", source="azoom_torch/csrc/qconv_kernel.cu",
        replaces="azoom/pallas/qconv_kernel.py:53 (the narrow instances: the stems of Cin 2, 4 "
                 "and 16 and the Cout = 32 convs of the bundled fpu, deepfpu, tpufpu and "
                 "tpufpu_slim)",
        max_abs_err=max(p["max_abs_err"] for p in narrow_parts), launches=0,
        ms=sum(p["ms"] for p in narrow_parts), plain_ms=sum(p["plain_ms"] for p in narrow_parts),
        bound_ms=sum(p["bound_ms"] for p in narrow_parts), bound_by=bound_by_of(narrow_parts),
        library_ms=sum(p["library_ms"] for p in narrow_parts))
    log("qconv_narrow", convs=len(narrow_parts), ms=f"{results['qconv3x3_narrow']['ms']:.4f}",
        bound_ms=f"{results['qconv3x3_narrow']['bound_ms']:.4f}",
        int_mm_ms=f"{results['qconv3x3_narrow']['library_ms']:.4f}")

    # each bundled conv net, int8 and float, on the learned MVDR path at batch 128
    nets = {}
    mix1 = mix_s[:1].cpu()
    Y1 = stft(mix_s[:1])
    for name in ("tpufpu_nano", "tpufpu_slim", "tpufpu", "deepfpu", "fpu", "fpu_reverb",
                 "fpu_multigeo"):
        for quant in (True, False):
            net_gpu, fk = load_bundled(name, quant=quant)
            net_cpu, _ = load_bundled(name, quant=quant, device="cpu")
            n_convs = len(conv_shapes(net_cpu, 64))  # 14, 21 or 27
            n_up = sum(isinstance(m, ConvTranspose1x2) for m in net_cpu.modules())
            kw = dict(feature_kind=fk, steer_deg=60.0)
            torch.cuda.synchronize()
            kernels.reset_launches()
            routes_before = dict(route_counts)
            out = learned_enhance(mix_s, net_gpu, cfg, **kw)
            torch.cuda.synchronize()
            counts = active_launches()
            routes = {k: v - routes_before[k] for k, v in route_counts.items()}
            kinds = [plan(c[0], c[1], c[2])["kernel"] for c in conv_shapes(net_cpu, 64)]
            check(routes == {k: kinds.count(k) if quant else 0 for k in routes},
                  f"{name} int8={quant}: conv kernels {routes}")
            want = {"convt1x2": n_up, "masked_mvdr": 1}
            if quant:
                want["qconv3x3"] = n_convs
                if name in conv_sets:
                    results[f"qconv3x3_{name}"]["launches"] = counts["qconv3x3"]
                    results["qconv3x3_narrow"]["launches"] += routes["narrow"]
            check(counts == want, f"{name} int8={quant}: launch counts {counts}, want {want}")
            check(out.shape == (BATCH, N_SAMPLES) and bool(torch.isfinite(out).all()),
                  f"{name} int8={quant}: bad output")
            # one pass of the net on the CPU: chunk 0's waveform (int8: the
            # plain B2 path) or mask (float: full float32, which TF32 would
            # miss by orders of magnitude)
            if quant:
                rel = float((out[:1].cpu() - learned_enhance(mix1, net_cpu, cfg, **kw)).norm()
                            / out[:1].cpu().norm())
                check(rel <= 1e-2, f"{name} int8: waveform vs CPU {rel:.3e}")
                cpu_err = dict(wave_rel_l2=rel)
            else:
                m_err = float((predict_mask(net_gpu, Y1, fk).cpu()
                               - predict_mask(net_cpu, Y1.cpu(), fk)).abs().max())
                check(m_err <= 1e-5, f"{name} float: mask vs CPU {m_err:.3e}")
                cpu_err = dict(mask_max_err=m_err)
            ts = []
            for i in range(7):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                learned_enhance(mix_s, net_gpu, cfg, **kw)
                torch.cuda.synchronize()
                ts.append((time.perf_counter() - t0) * 1e3)
            med = statistics.median(ts[2:])
            nets[f"{name}_{'int8' if quant else 'float'}"] = dict(
                launches=counts, conv_kernels=routes, ms=ts, ms_median=med, features=fk,
                **cpu_err)
            log("net", name=name, int8=quant, features=fk, batch=BATCH, launches=counts,
                conv_kernels=routes, ms_median=f"{med:.3f}",
                audio_seconds_per_second=f"{BATCH * N_SAMPLES / 16_000 / (med / 1e3):.1f}",
                **{f"cpu_chunk0_{k}": f"{v:.3e}" for k, v in cpu_err.items()},
                matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32)
            del net_gpu, net_cpu, out

    # the facade with the reference's defaults for a real array: float fpu_multigeo
    clip2 = far_field_scene(rng, 1, N_SAMPLES, angles=(65.0, 20.0, 130.0))[0][0]
    zf_kw = dict(model="fpu_multigeo", direction_deg=75.0, fov_deg=60.0, zoom=0.4)
    zf_gpu, zf_cpu = AudioZoom(**zf_kw), AudioZoom(device="cpu", **zf_kw)
    check(not zf_gpu.int8, "AudioZoom's default must be the float net")
    kernels.reset_launches()
    e_gpu = zf_gpu.enhance(clip2)
    torch.cuda.synchronize()
    zf_counts = active_launches()
    check(zf_counts == {"convt1x2": 3, "masked_mvdr": 1}, f"facade fpu_multigeo launches {zf_counts}")
    e_cpu = zf_cpu.enhance(clip2)
    zf_rel = float(np.linalg.norm(e_gpu - e_cpu) / np.linalg.norm(e_cpu))
    check(e_gpu.shape == (N_SAMPLES,) and bool(np.isfinite(e_gpu).all()), "facade fpu_multigeo: bad")
    check(zf_rel <= 1e-4, f"facade fpu_multigeo: waveform vs CPU {zf_rel:.3e}")
    zf_ts = []
    for _ in range(6):
        t0 = time.perf_counter()
        zf_gpu.enhance(clip2)
        zf_ts.append((time.perf_counter() - t0) * 1e3)
    nets["facade_fpu_multigeo"] = dict(launches=zf_counts, ms=zf_ts,
                                       ms_median=statistics.median(zf_ts[1:]), wave_rel_l2=zf_rel)
    log("facade_fpu_multigeo", launches=zf_counts, ms_median=f"{statistics.median(zf_ts[1:]):.3f}",
        wave_rel_l2=f"{zf_rel:.3e}")

    # the server with fpu: Cout = 32 at the 80-frame prime and 48-frame reuse ticks
    f_ticks = 4
    f_mix = np.clip(far_field_scene(rng, BATCH, win + f_ticks * hop)[0] * 32767.0,
                    -32767, 32767).astype(np.int16)
    fsrv = {where: AudioZoomServer(S, cfg=scfg, model="fpu", mask_reuse=True, wire="int16",
                                   device=where) for where, S in (("cuda", BATCH), ("cpu", 2))}
    for where, srv_f in fsrv.items():
        for st in range(srv_f.S):
            srv_f.set_zoom(st, direction_deg=60.0 + st % 60, zoom=0.5)
    torch.cuda.synchronize()
    kernels.reset_launches()
    routes_before = dict(route_counts)
    f_outs = [fsrv["cuda"].push(f_mix[:, :, :win])]
    torch.cuda.synchronize()
    f_prime = active_launches()
    f_routes = [{r: route_counts[r] - routes_before[r] for r in route_counts}]
    f_cpu = [fsrv["cpu"].push(f_mix[:2, :, :win])]
    f_ms, f_launches = [], []
    for k in range(f_ticks):
        blk = f_mix[:, :, win + k * hop:win + (k + 1) * hop]
        torch.cuda.synchronize()
        kernels.reset_launches()
        routes_before = dict(route_counts)
        t0 = time.perf_counter()
        f_outs.append(fsrv["cuda"].push(blk))
        f_ms.append((time.perf_counter() - t0) * 1e3)
        f_launches.append(active_launches())
        f_routes.append({r: route_counts[r] - routes_before[r] for r in route_counts})
        if k < 2:
            f_cpu.append(fsrv["cpu"].push(blk[:2]))
    want = {"qconv3x3": 14, "convt1x2": 3, "masked_mvdr": 1}
    check(f_prime == want and all(c == want for c in f_launches),
          f"server fpu launches: prime {f_prime}, ticks {f_launches}")
    # the prime on 80 frames, the reuse ticks on 48 (256 -> 256 at 6 frames on the split
    # route); the stem, the two 32 -> 32 and the 32 || 32 concat on the narrow route
    want_routes = [{"wgmma": 10, "narrow": 4, "split": 0, "mma": 0}] + \
        [{"wgmma": 9, "narrow": 4, "split": 1, "mma": 0}] * f_ticks
    check(f_routes == want_routes, f"server fpu conv kernels {f_routes}")
    a = np.concatenate(f_outs[1:3], axis=1)[:2].astype(np.float32)
    b = np.concatenate(f_cpu[1:], axis=1).astype(np.float32)
    f_rel = float(np.linalg.norm(a - b) / np.linalg.norm(b))
    check(f_rel <= 1e-2, f"server fpu: first 2 streams vs CPU {f_rel:.3e}")
    nets["server_fpu_reuse_int16"] = dict(prime_launches=f_prime, tick_launches=f_launches,
                                          tick_ms=f_ms, tick_ms_median=statistics.median(f_ms[1:]),
                                          cpu_wave_rel_l2=f_rel)
    log("server_fpu", streams=BATCH, ticks=f_ticks, prime_launches=f_prime,
        tick_launches=f_launches[-1], prime_conv_kernels=f_routes[0],
        tick_conv_kernels=f_routes[-1], tick_ms_median=f"{statistics.median(f_ms[1:]):.3f}",
        tick_ms_all=[round(t, 2) for t in f_ms], cpu_first2_wave_rel_l2=f"{f_rel:.3e}")
    del fsrv, f_mix

    # 17. the low-latency path -----------------------------------------------------------
    from azoom_torch.kernels.online_mvdr_kernel import initial_state, online_mvdr, online_mvdr_plain
    from azoom_torch.masks.features import logmag_ipd_features
    from azoom_torch.pipelines.online_learned import online_learned_enhance
    from azoom_torch.stream.lowlat import OnlineEnhancer

    lowlat = {}
    F, T_ll = 513, 1875  # one stream, 60 s of frames
    gen.manual_seed(17)
    Y = torch.complex(torch.randn((2, F, T_ll), generator=gen, device=dev),
                      torch.randn((2, F, T_ll), generator=gen, device=dev))
    nmask = torch.rand((F, T_ll), generator=gen, device=dev)
    freqs = rfft_freqs(1024, 16_000, device=dev)
    d = steering_vector(freqs, 60.0, 0.04)
    kw = dict(target_mask=1.0 - nmask, sigma=1e-7, hp_cutoff_hz=100.0, forget=0.98,
              mask_floor=0.05)
    st_k, st_p = initial_state((), F, device=dev), initial_state((), F, device=dev)
    got = online_mvdr(Y, nmask, d, freqs, *st_k, **kw)
    ref = online_mvdr_plain(Y, nmask, d, freqs, *st_p, **kw)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    rel = err / float(ref.abs().max())
    st_rel = max(float((a - b).abs().max() / b.abs().max()) for a, b in zip(st_k, st_p))
    check(bool(torch.isfinite(torch.view_as_real(got)).all()), "online_mvdr: non-finite output")
    check(rel <= 1e-4 and st_rel <= 1e-5,
          f"online_mvdr: relative error {rel:.3e} (state {st_rel:.3e}) against the plain loop")
    # T launches of one frame, the state carried through device memory
    st_1 = initial_state((), F, device=dev)
    st_T = initial_state((), F, device=dev)
    whole = online_mvdr(Y, nmask, d, freqs, *st_T, **kw)
    steps = [online_mvdr(Y[..., t:t + 1].contiguous(), nmask[:, t:t + 1].contiguous(), d, freqs,
                         *st_1, **dict(kw, target_mask=kw["target_mask"][:, t:t + 1].contiguous()))
             for t in range(T_ll)]
    differ = int((torch.cat(steps, dim=-1) != whole).sum())
    differ += sum(int((a != b).sum()) for a, b in zip(st_1, st_T))
    check(differ == 0, f"online_mvdr: {differ} elements differ between one launch and T launches")
    ms = device_ms(lambda: online_mvdr(Y, nmask, d, freqs, *st_k, **kw))
    # one call: the plain loop launches ~15 small kernels a frame (~1.4 s)
    plain_ms = time_ms(lambda: online_mvdr_plain(Y, nmask, d, freqs, *st_p, **kw), iters=1,
                       warmup=0)
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60).stdout.split()[0])
    # Y, noise and target masks in, S out, per (f, t); the state read and
    # written; d and freqs. ~90 float32 operations per (f, t).
    nbytes = F * T_ll * (16 + 4 + 4 + 8) + 2 * F * (32 + 4) + F * (16 + 4)
    b_ms, b_by = bound(nbytes, F * T_ll * 90.0, FP32_FLOPS_PER_S)
    chain_ms = T_ll * 4 / (mhz * 1e6) * 1e3  # one dependent 4-cycle FMA per frame
    results["online_mvdr"] = dict(
        name="online_mvdr", route="cuda", source="azoom_torch/csrc/online_mvdr_kernel.cu",
        replaces="azoom/stream/online.py:61 (XLA lax.scan, no Pallas kernel)",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None)
    lowlat["kernel"] = dict(shape=(2, F, T_ll), rel_err=rel, state_rel_err=st_rel, ms=ms,
                            plain_ms=plain_ms, bound_ms=b_ms, chain_floor_ms=chain_ms,
                            us_per_frame=ms / T_ll * 1e3, one_vs_T_launches_differ=differ)
    log("online_mvdr", shape=(2, F, T_ll), max_abs_err=f"{err:.3e}", rel_err=f"{rel:.3e}",
        state_rel_err=f"{st_rel:.3e}", one_vs_T_launches_elements_differ=differ,
        ms=f"{ms:.4f}", us_per_frame=f"{ms / T_ll * 1e3:.3f}", plain_ms=f"{plain_ms:.1f}",
        bound_ms=f"{b_ms:.4f}", bound_by=b_by, chain_floor_ms=f"{chain_ms:.4f}",
        max_sm_mhz=mhz)
    del Y, nmask, got, ref, steps, whole

    # the offline causal pipeline on a 60 s clip
    ll_cfg = PipelineConfig(mic_dist=0.04, angle_target_deg=75.0)
    crn, _ = load_bundled("crn_causal")
    crn_cpu, _ = load_bundled("crn_causal", device="cpu")
    rec = torch.from_numpy(far_field_scene(rng, 1, 60 * 16_000, angles=(75.0, 30.0, 140.0))[0][0])
    rec_gpu = rec.to(dev)
    torch.cuda.synchronize()
    kernels.reset_launches()
    out = online_learned_enhance(rec_gpu, crn, ll_cfg)
    torch.cuda.synchronize()
    ll_counts = active_launches()
    check(ll_counts == {"online_mvdr": 1}, f"online_learned_enhance launches {ll_counts}")
    check(out.shape == (60 * 16_000,) and bool(torch.isfinite(out).all()),
          "online_learned_enhance: bad output")
    results["online_mvdr"]["launches"] = ll_counts["online_mvdr"]
    ll_ts = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        online_learned_enhance(rec_gpu, crn, ll_cfg)
        torch.cuda.synchronize()
        ll_ts.append((time.perf_counter() - t0) * 1e3)
    ll_med = statistics.median(ll_ts[1:])
    pre = rec[:, :6 * 16_000]
    pre_gpu = online_learned_enhance(pre.to(dev), crn, ll_cfg).cpu()
    pre_cpu = online_learned_enhance(pre, crn_cpu, ll_cfg)
    ll_rel = float((pre_gpu - pre_cpu).norm() / pre_cpu.norm())
    feats = logmag_ipd_features(stft(pre))[None]
    with torch.inference_mode():
        ll_mask_err = float((crn(feats.to(dev)).cpu() - crn_cpu(feats)).abs().max())
    check(ll_mask_err <= 1e-5, f"crn_causal mask card vs CPU {ll_mask_err:.3e}")
    check(ll_rel <= 1e-3, f"online_learned_enhance 6 s prefix: waveform vs CPU {ll_rel:.3e}")
    lowlat["offline_60s"] = dict(launches=ll_counts, ms=ll_ts, ms_median=ll_med,
                                 ms_per_recorded_second=ll_med / 60, cpu_prefix_wave_rel_l2=ll_rel,
                                 cpu_prefix_mask_max_err=ll_mask_err)
    log("lowlat_offline", seconds=60, launches=ll_counts, ms_median=f"{ll_med:.3f}",
        ms_per_recorded_second=f"{ll_med / 60:.4f}", ms_all=[round(t, 2) for t in ll_ts],
        prefix_wave_rel_l2=f"{ll_rel:.3e}", prefix_mask_max_err=f"{ll_mask_err:.3e}",
        matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32)
    # the hop-by-hop stream: 10 s pushed one hop (512 samples) at a time
    x10 = rec[:, :10 * 16_000].numpy()
    off10 = online_learned_enhance(rec_gpu[:, :10 * 16_000], crn, ll_cfg).cpu().numpy()
    # the offline call's device time by kernel, on the first 10 s (60 s
    # would trace ~40,000 launches)
    profile_call("profile_lowlat", lambda: online_learned_enhance(rec_gpu[:, :10 * 16_000], crn,
                                                                  ll_cfg), "profile_lowlat.txt")
    oe = OnlineEnhancer(ll_cfg, crn, steer_deg=75.0)
    hop = ll_cfg.hop
    torch.cuda.synchronize()
    kernels.reset_launches()
    outs, push_ms = [], []
    for i in range(0, x10.shape[1], hop):
        t0 = time.perf_counter()
        outs.append(oe.push(x10[:, i:i + hop]))
        push_ms.append((time.perf_counter() - t0) * 1e3)
    hops = x10.shape[1] // hop
    oe_counts = active_launches()
    check(oe_counts == {"online_mvdr": hops}, f"OnlineEnhancer launches {oe_counts}, {hops} hops")
    streamed = np.concatenate(outs)
    oe_err = float(np.abs(streamed - off10[:streamed.shape[0]]).max())
    check(streamed.shape[0] == (hops - 1) * hop and oe_err <= 1e-5,
          f"OnlineEnhancer vs the card's offline output: {oe_err:.3e} ({streamed.shape})")
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(20):
            oe.push(x10[:, i * hop:(i + 1) * hop])
        torch.cuda.synchronize()
    dev_kernels = sum(e.count for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0)
    dev_ms_hop = sum(e.self_device_time_total for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA) / 1e3 / 20
    push_med = statistics.median(push_ms[2:])
    lowlat["stream_10s"] = dict(hops=hops, push_ms=push_ms, push_ms_median=push_med,
                                online_mvdr_launches_per_hop=oe_counts["online_mvdr"] / hops,
                                device_kernels_per_hop=dev_kernels / 20,
                                device_ms_per_hop=dev_ms_hop, vs_offline_max_abs=oe_err)
    log("lowlat_stream", seconds=10, hops=hops, push_ms_median=f"{push_med:.3f}",
        hop_ms=f"{1e3 * hop / 16_000:.1f}", online_mvdr_per_hop=oe_counts["online_mvdr"] / hops,
        device_kernels_per_hop=dev_kernels / 20, device_ms_per_hop=f"{dev_ms_hop:.3f}",
        vs_offline_max_abs=f"{oe_err:.3e}")

    # the facade at low latency, tracking, against the CPU port
    z_kw = dict(cfg=PipelineConfig(mic_dist=0.04), direction_deg=70.0, fov_deg=60.0, zoom=0.4,
                latency="low", track=True, tracker="momentum")
    clip6 = far_field_scene(rng, 1, 6 * 16_000, angles=(65.0, 20.0, 130.0))[0][0]
    zl_gpu, zl_cpu = AudioZoom(**z_kw), AudioZoom(device="cpu", **z_kw)
    check(zl_gpu.model == "crn_causal", "latency='low' must default to crn_causal")
    zl_out, zl_ref, zl_ms, zl_bear = [], [], [], []
    for block in np.array_split(clip6, 12, axis=1):
        t0 = time.perf_counter()
        zl_out.append(zl_gpu.push(block))
        zl_ms.append((time.perf_counter() - t0) * 1e3)
        zl_ref.append(zl_cpu.push(block))
        zl_bear.append(zl_gpu._track_theta)
        check(zl_gpu._track_theta == zl_cpu._track_theta,
              f"low-latency push: bearing {zl_gpu._track_theta} vs {zl_cpu._track_theta} on the CPU")
    zl_out, zl_ref = np.concatenate(zl_out), np.concatenate(zl_ref)
    zl_rel = float(np.linalg.norm(zl_out - zl_ref) / np.linalg.norm(zl_ref))
    check(zl_out.shape[0] >= 6 * 16_000 - 2 * 1024 and bool(np.isfinite(zl_out).all()),
          f"low-latency push: bad output {zl_out.shape}")
    check(zl_rel <= 1e-3, f"low-latency push: waveform vs CPU {zl_rel:.3e}")
    lowlat["facade_push_6s"] = dict(push_ms=zl_ms, bearings=zl_bear, wave_rel_l2=zl_rel)
    log("lowlat_facade", seconds=6, pushes=len(zl_ms), ms_per_push=f"{statistics.median(zl_ms):.3f}",
        bearings=zl_bear, wave_rel_l2=f"{zl_rel:.3e}")
    del crn, rec_gpu

    # 18. arrays of more than two mics ------------------------------------------------
    mmic = phase_mmic(dev, rng, results, time_ms, device_ms, bound)

    # 19. the other beamformers and dereverberation -------------------------------------
    beamformers = phase_beamformers(dev, rng, mix_s, clip, theta_cpu_of["viterbi"], model,
                                    model_cpu, profile_call)

    # 20.-21. the native stream engine and the measurement layer ---------------------
    native_eval = phase_native_eval(dev, rng, profile_call)

    # 22. scene simulation ----------------------------------------------------------
    sim = phase_sim(dev, model, profile_call)

    # 23. sweeps and shards -----------------------------------------------------------
    sweep = phase_sweep(dev, model, model_cpu, profile_call)

    # 24. training --------------------------------------------------------------------
    train = phase_train(dev, mix_s, tgt_s, itf_s)

    line = {"kernels": [results[k] for k in (
        "masked_mvdr", "masked_mvdr_per_stream", "qconv3x3", "qconv3x3_fpu", "qconv3x3_deepfpu",
        "qconv3x3_tpufpu", "qconv3x3_tpufpu_slim", "qconv3x3_split", "qconv3x3_narrow",
        "convt1x2", "hard_null",
        "hard_null_per_chunk", "int8_mm", "online_mvdr", "online_mvdr_mmic")]}
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms"}
    for k in line["kernels"]:
        check(keys <= set(k) and k["launches"] > 0,
              f"kernel line {k['name']}: keys {sorted(set(k))}, launches {k.get('launches')}")
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {**line, "per_shape": {str(k): v for k, v in per_shape.items()},
         "qconv_server_families": families, "mvdr_forms": mvdr_forms,
         "int8_mm_per_shape": {str(k): v for k, v in mm_parts.items()},
         "convt_per_shape": {str(k): v for k, v in convt_shapes.items()},
         "main_ms": times, "main_hard_null_ms": hn_times, "stream_ms": st_times,
         "server": server_stats, "facade": facade, "tracked": tracked,
         "learned_tracked": learned_tracked, "tracked_facade_ms": z_ms, "hrnr": hrnr,
         "qconv_sets": set_shapes, "nets": nets, "lowlat": lowlat, "mmic": mmic,
         "beamformers": beamformers, **native_eval, "sim": sim, "sweep": sweep, "train": train,
         "card": smi},
        indent=1))
    print(json.dumps(line))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
