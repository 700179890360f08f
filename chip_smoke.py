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
               and without a residual (the wgmma kernel at nine shapes, the
               mma.sync kernel at the 16-channel stem: the wrapper picks by
               shape); torch._int_mm on explicitly im2col'd int8 operands is
               timed beside it as the bare GEMM. Then every conv of the net
               (with and without a residual, and the concat convs) at the
               frame families of the server's full tick (80 / 40 / 20 / 10)
               and reuse tick (48 / 24 / 12 / 6), with each shape's route,
               the elements that differ from the plain version and the
               kernel's time; the reuse tick's 256 -> 256 at 6 frames runs on
               the split route, held bit for bit against the plain version
               and the mma.sync kernel, timed beside its plain version and
               torch._int_mm.
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
               on the split route, 3 upsamplings, 1 MVDR); the first 4
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
               (129 rows) at batch 128, with its route (wgmma, split or mma),
               bit for bit against the plain version (and a split-route shape
               against the mma.sync kernel too), timed beside torch._int_mm
               on im2col'd int8. Then each of the
               seven artifacts, int8 and float (its convs float32 matrix
               products, TF32 off), on the learned MVDR path at (128, 2, 32000)
               on phase 7's scenes: launch counts and conv kernels, chunk 0
               against the CPU (int8: the waveform; float: the mask to 1e-5),
               the median ms per call. AudioZoom(model="fpu_multigeo") (float, the
               reference's default) enhance() of 2 s against the CPU; then
               AudioZoomServer(128, model="fpu", mask_reuse=True,
               wire="int16"): a prime (80 frames) and 4 reuse ticks (48), the
               launches of each, the first 2 streams against a CPU server.
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
Then one JSON line with every kernel's numbers (B1 twice: masked_mvdr is the
shared form at 64 frames with phase 5's launches, masked_mvdr_per_stream the
server's form at 65 frames with the launches of phase 12's reuse ticks; ms
is a loop of calls from Python for both; B2 six times: qconv3x3 is the
tpufpu_nano net of phase 3 with phase 5's launches, qconv3x3_<net> the conv
set of fpu, deepfpu, tpufpu and tpufpu_slim with the launches of that int8
net's phase-16 run, qconv3x3_split the split route's four convs of the
reuse tick's net (phase 3's 48-frame family) with the split launches of
phase 12's reuse ticks; B3 twice: hard_null shared with
phase 9's launches, hard_null_per_chunk with the launches of phase 14's
learned hard-null run; online_mvdr at one 60 s clip with phase 17's
launches), the card's name and power limit, and a last line
{"ok": true, "device": {...}}.

Any failed check raises, so the script exits non-zero and prints no result.
Without CUDA it exits non-zero at once. Imports nothing of JAX or azoom.
"""

from __future__ import annotations

import json
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
                    angles=(90.0, 40.0, 130.0), rms: float = 0.1, c: float = 343.0):
    """Speech-like far-field scenes made with numpy: a target and two
    interferers (first angle is the target's; ``angles`` (3,) for all scenes
    or (batch, 3) for one triple each), each low-passed noise under a
    syllable-rate envelope, delayed to a 2-mic linear array by an rFFT phase
    ramp (fractional delays). Returns float32 (mixture (batch, 2, n),
    target_ref (batch, n), interference_ref (batch, n)) at mic 0, the
    mixture scaled to ``rms``."""
    import numpy as np

    f = np.fft.rfftfreq(n, 1.0 / fs)
    t = np.arange(n) / fs
    src = np.fft.irfft(np.fft.rfft(rng.standard_normal((batch, 3, n))) / (1.0 + f / 500.0), n)
    rate = 3.0 + 2.0 * rng.random((batch, 3, 1))
    env = 0.5 * (1.0 + np.sin(2 * np.pi * rate * t + 2 * np.pi * rng.random((batch, 3, 1))))
    src = src * env**2
    src /= np.sqrt(np.mean(src**2, axis=-1, keepdims=True))
    pos = np.array([mic_dist / 2, -mic_dist / 2])  # mic m at ((M-1)/2 - m) d
    tau = pos * np.cos(np.deg2rad(np.array(angles)))[..., None] / c  # ([batch,] 3, 2)
    ramp = np.exp(-2j * np.pi * f * tau[..., None])  # ([batch,] 3, 2, F)
    img = np.fft.irfft(np.fft.rfft(src)[:, :, None, :] * ramp, n)  # (batch, 3, 2, n)
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


_T0 = time.perf_counter()
_CARD = {}  # the card's name and power limit, once nvidia-smi has been read


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
        for with_res, cat, xin, kw in conv_variants(NANO_CONVS, cin, cout, t, x, res):
            err, differ, ms, b_ms, b_by = conv_check(cin, cout, t, with_res, cat, xin, w_q, epi, kw)
            worst = max(worst, err)
            plain_ms = time_ms(lambda: qconv3x3_plain(xin, w_q, epi, act_scale, **kw),
                               iters=3, warmup=1)
            per_shape[(cin, cout, t, with_res, cat)] = dict(
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, max_abs_err=err,
                not_bit_equal_to_plain=differ)
        # the bare int8 GEMM of the same conv, im2col'd outside the timing
        lib_ms = int_mm_ms(x, w_q, act_scale)
        for v in variants:
            per_shape[(cin, cout, t) + v]["library_ms"] = lib_ms
        plain = per_shape[(cin, cout, t, False, False)]
        log("qconv", cin=cin, cout=cout, frames=t, batch=BATCH, kernel=plan(cin, cout, t)["kernel"],
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
    # 256 -> 256 runs on the split route). Split-route shapes are held bit for
    # bit against the plain version and the mma.sync kernel.
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
                if route == "split":
                    vs_mma = int((qconv3x3(xin, w_q, epi, act_scale, **kw)
                                  != qconv3x3(xin, w_q, epi, act_scale, **kw, _kernel="mma")).sum())
                    check(differ == 0 and vs_mma == 0,
                          f"qconv split {key}: {differ} elements differ from the plain version, "
                          f"{vs_mma} from the mma.sync kernel")
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
    check(routes == {"wgmma": 20, "split": 0, "mma": 1}, f"main path conv kernels {routes}")
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

    def profile_call(phase: str, fn, path: str) -> None:
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
        # route), a full one on 80
        want_routes = ({"wgmma": 16, "split": 4, "mma": 1} if name == "reuse_int16"
                       else {"wgmma": 20, "split": 0, "mma": 1})
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
    set_shapes = {}
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
                if route == "split":  # the new route against the mma.sync kernel it replaced
                    vs_mma = int((qconv3x3(xin, w_q, epi, act_scale, **kw)
                                  != qconv3x3(xin, w_q, epi, act_scale, **kw, _kernel="mma")).sum())
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
        main_kernel = max(route_counts, key=kernel_of.count)
        results[f"qconv3x3_{net}"] = dict(
            name=f"qconv3x3_{net}", route="cuda",
            source="azoom_torch/csrc/" + ("qconv_mma_kernel.cu" if main_kernel == "mma"
                                          else "qconv_kernel.cu"),
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
    f_outs = [fsrv["cuda"].push(f_mix[:, :, :win])]
    torch.cuda.synchronize()
    f_prime = active_launches()
    f_cpu = [fsrv["cpu"].push(f_mix[:2, :, :win])]
    f_ms, f_launches = [], []
    for k in range(f_ticks):
        blk = f_mix[:, :, win + k * hop:win + (k + 1) * hop]
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        f_outs.append(fsrv["cuda"].push(blk))
        f_ms.append((time.perf_counter() - t0) * 1e3)
        f_launches.append(active_launches())
        if k < 2:
            f_cpu.append(fsrv["cpu"].push(blk[:2]))
    want = {"qconv3x3": 14, "convt1x2": 3, "masked_mvdr": 1}
    check(f_prime == want and all(c == want for c in f_launches),
          f"server fpu launches: prime {f_prime}, ticks {f_launches}")
    a = np.concatenate(f_outs[1:3], axis=1)[:2].astype(np.float32)
    b = np.concatenate(f_cpu[1:], axis=1).astype(np.float32)
    f_rel = float(np.linalg.norm(a - b) / np.linalg.norm(b))
    check(f_rel <= 1e-2, f"server fpu: first 2 streams vs CPU {f_rel:.3e}")
    nets["server_fpu_reuse_int16"] = dict(prime_launches=f_prime, tick_launches=f_launches,
                                          tick_ms=f_ms, tick_ms_median=statistics.median(f_ms[1:]),
                                          cpu_wave_rel_l2=f_rel)
    log("server_fpu", streams=BATCH, ticks=f_ticks, prime_launches=f_prime,
        tick_launches=f_launches[-1], tick_ms_median=f"{statistics.median(f_ms[1:]):.3f}",
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

    line = {"kernels": [results[k] for k in (
        "masked_mvdr", "masked_mvdr_per_stream", "qconv3x3", "qconv3x3_fpu", "qconv3x3_deepfpu",
        "qconv3x3_tpufpu", "qconv3x3_tpufpu_slim", "qconv3x3_split", "convt1x2", "hard_null",
        "hard_null_per_chunk", "int8_mm", "online_mvdr")]}
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
         "qconv_sets": set_shapes, "nets": nets, "lowlat": lowlat, "card": smi}, indent=1))
    print(json.dumps(line))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
