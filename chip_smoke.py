#!/usr/bin/env python3
"""Smoke run of azoom_torch, the PyTorch/CUDA port, on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own line(s):
  1. build   - compile every CUDA kernel of the port with nvcc (sm_90a), in
               parallel, into azoom_torch/_build/; print the card.
  2. mvdr    - the fused masked-MVDR kernel against its plain PyTorch version
               at the serving shape (128 streams, 2 mics, 513 bins, 64 frames),
               with a scalar and a per-bin sigma.
  3. qconv   - the int8 3x3 conv kernel against its plain version at each of
               the ten conv shapes of the bundled tpufpu_nano net at batch 128,
               with and without a residual; torch._int_mm on explicitly
               im2col'd int8 operands is timed beside it as the bare GEMM.
  4. convt   - the upsampling kernel against its plain version at the net's
               three upsampling shapes.
  5. main    - the user's path: load_bundled("tpufpu_nano") and
               learned_enhance on a (128, 2, 32000) mixture made from a seed,
               steered to 60 deg. The launch counts of that one call must show
               every kernel of the path; the first 4 chunks must agree with
               the same call on the CPU plain path; the median time per call
               is taken after warm-up.
  6. profile - torch.profiler over one main-path call: device time by
               kernel and the device's idle share (chiprun_out/profile.txt).
Then one JSON line with every kernel's numbers, the card's name and power
limit, and a last line {"ok": true, "device": {...}}.

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
BATCH = 128                 # 2 s chunks per call (the serving batch)
N_SAMPLES = 32_000          # one 2 s chunk at 16 kHz
F_ROWS = 129                # folded frequency rows: ceil(513 / 4)

# The 21 int8 convs of tpufpu_nano in forward order at T = 64 input frames:
# (Cin, Cout, frames, with residual, input is a two-tensor channel concat).
NANO_CONVS = (
    [(16, 64, 64, False, False), (64, 64, 64, False, False)]                   # e1
    + [(64, 64, 32, False, False), (64, 64, 32, False, False), (64, 64, 32, True, False)]
    + [(64, 128, 16, False, False), (128, 128, 16, False, False), (128, 128, 16, True, False)]
    + [(128, 256, 8, False, False)]                                          # bottleneck
    + [(256, 256, 8, False, False), (256, 256, 8, True, False)] * 2
    + [(256, 128, 16, False, True), (128, 128, 16, False, False), (128, 128, 16, True, False)]
    + [(128, 64, 32, False, True), (64, 64, 32, False, False), (64, 64, 32, True, False)]
    + [(128, 64, 64, False, True), (64, 64, 64, False, False)]                 # d1
)
# The 3 upsamplings at T = 64: (K = Cin, Cout, input frames).
NANO_CONVT = [(256, 128, 8), (128, 64, 16), (64, 64, 32)]


def log(phase: str, **kw) -> None:
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
    from azoom_torch.kernels import build
    from azoom_torch.kernels.convt_kernel import convt1x2, convt1x2_plain
    from azoom_torch.kernels.mvdr_kernel import masked_mvdr_fused
    from azoom_torch.kernels.qconv_kernel import k_padded, qconv3x3, qconv3x3_plain
    from azoom_torch.models.pretrained import load_bundled
    from azoom_torch.pipelines.learned import learned_enhance, predict_mask

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
    log("build", seconds=f"{time.perf_counter() - t0:.2f}",
        per_source={k: round(v["seconds"], 2) for k, v in info.items()},
        torch=torch.__version__, cuda=torch.version.cuda, card=f"'{smi}'")
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
    ms = time_ms(lambda: masked_mvdr_fused(Y, nmask, d, freqs, **kw))
    plain_ms = time_ms(lambda: masked_mvdr(Y, nmask, d, freqs, **kw), iters=5)
    n_el = BATCH * F * T
    nbytes = n_el * (2 * 8 + 4 + 4 + 8) + F * (16 + 4)
    b_ms, b_by = bound(nbytes, n_el * 34.0, FP32_FLOPS_PER_S)
    results["masked_mvdr"] = dict(
        name="masked_mvdr", route="cuda", source="azoom_torch/csrc/mvdr_kernel.cu",
        replaces="azoom/pallas/mvdr_kernel.py:38", max_abs_err=worst, ms=ms,
        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None)
    log("mvdr", shape=shape, max_abs_err=f"{worst:.3e}", ms=f"{ms:.4f}",
        plain_ms=f"{plain_ms:.4f}", bound_ms=f"{b_ms:.4f}", bound_by=b_by)
    del Y, nmask, tmask

    # 3. int8 3x3 conv --------------------------------------------------------
    per_shape = {}
    worst = 0.0
    for cin, cout, t in dict.fromkeys(c[:3] for c in NANO_CONVS):
        x = torch.from_numpy(np.abs(rng.standard_normal((BATCH, F_ROWS, t, cin)))
                             .astype(np.float32)).to(dev)
        act_scale = float(np.float32(3.3 / 127))
        w_q = torch.zeros((cout, k_padded(cin)), dtype=torch.int8)
        w_q[:, :9 * cin] = torch.from_numpy(
            rng.integers(-127, 128, (cout, 9 * cin)).astype(np.int8))
        w_q = w_q.to(dev)
        epi = torch.from_numpy(np.stack([
            np.full(cout, 2e-4), 0.1 * rng.standard_normal(cout), 0.1 * rng.standard_normal(cout),
            1 + 0.1 * rng.standard_normal(cout), 0.1 * rng.standard_normal(cout),
        ]).astype(np.float32)).to(dev)
        res = torch.from_numpy(rng.standard_normal((BATCH, F_ROWS, t, cout))
                               .astype(np.float32)).to(dev)
        variants = {(False, False), (True, False)} | {
            c[3:] for c in NANO_CONVS if c[:3] == (cin, cout, t)}
        for with_res, cat in sorted(variants):
            kw = dict(residual=res if with_res else None)
            if cat:  # the decoder's concat: two inputs of cin / 2 channels each
                kw["x2"] = x[..., cin // 2:].contiguous()
            xin = x[..., :cin // 2].contiguous() if cat else x
            got = qconv3x3(xin, w_q, epi, act_scale, **kw)
            ref = qconv3x3_plain(xin, w_q, epi, act_scale, **kw)
            torch.cuda.synchronize()
            err = float((got - ref).abs().max())
            rel = err / (float(ref.abs().max()) + 1e-30)
            check(rel < 1e-5, f"qconv {(cin, cout, t, with_res, cat)}: relative error {rel:.3e}")
            worst = max(worst, err)
            ms = time_ms(lambda: qconv3x3(xin, w_q, epi, act_scale, **kw))
            plain_ms = time_ms(lambda: qconv3x3_plain(xin, w_q, epi, act_scale, **kw),
                               iters=3, warmup=1)
            m = BATCH * F_ROWS * t
            nbytes = (m * cin * 4 + cout * 9 * cin + epi.numel() * 4
                      + m * cout * 4 * (2 if with_res else 1))
            b_ms, b_by = bound(nbytes, 2.0 * m * 9 * cin * cout, INT8_OPS_PER_S)
            per_shape[(cin, cout, t, with_res, cat)] = dict(
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, max_abs_err=err)
        # the bare int8 GEMM of the same conv, im2col'd outside the timing
        xq = torch.clamp(torch.round(x / act_scale), -127, 127).to(torch.int8)
        xp = torch.nn.functional.pad(xq, (0, 0, 1, 1, 1, 1))
        cols = torch.stack([xp[:, dy:dy + F_ROWS, dx:dx + t] for dy in range(3) for dx in range(3)],
                           dim=3).reshape(BATCH * F_ROWS * t, 9 * cin)
        cols = torch.nn.functional.pad(cols, (0, k_padded(cin) - 9 * cin)).contiguous()
        w_t = w_q.t()
        lib_ms = time_ms(lambda: torch._int_mm(cols, w_t))
        for v in variants:
            per_shape[(cin, cout, t) + v]["library_ms"] = lib_ms
        plain = per_shape[(cin, cout, t, False, False)]
        log("qconv", cin=cin, cout=cout, frames=t, batch=BATCH,
            ms={"+".join(n for n, on in zip(("res", "cat"), v) if on) or "plain":
                round(per_shape[(cin, cout, t) + v]["ms"], 4) for v in sorted(variants)},
            plain_ms=f"{plain['plain_ms']:.3f}", bound_ms=f"{plain['bound_ms']:.4f}",
            bound_by=plain["bound_by"], int_mm_ms=f"{lib_ms:.4f}")
        del x, res, xq, xp, cols
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

    # 4. upsampling -------------------------------------------------------------
    tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0)
    parts = []
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
        worst = max(worst, err)
        ms = time_ms(lambda: convt1x2(x, w, b))
        plain_ms = time_ms(lambda: convt1x2_plain(x, w, b), iters=2, warmup=1)
        x2 = x.reshape(-1, k)
        lib_ms = time_ms(lambda: torch.addmm(b.repeat(2), x2, w))
        p = x2.shape[0]
        b_ms, b_by = bound(4.0 * (p * k + k * 2 * cout + cout + p * 2 * cout),
                           2.0 * p * k * 2 * cout, FP32_FLOPS_PER_S)
        for key, v in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", b_ms), ("library_ms", lib_ms)):
            tot[key] += v
        parts.append(dict(bound_ms=b_ms, bound_by=b_by))
        log("convt", k=k, cout=cout, frames=t, ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.3f}",
            bound_ms=f"{b_ms:.4f}", bound_by=b_by, addmm_ms=f"{lib_ms:.4f}", max_abs_err=f"{err:.3e}")
        del x, x2
    results["convt1x2"] = dict(
        name="convt1x2", route="cuda", source="azoom_torch/csrc/convt_kernel.cu",
        replaces="azoom/models/unet.py:313 (XLA ConvTranspose, no Pallas kernel)",
        max_abs_err=worst, bound_by=bound_by_of(parts), **tot)

    # 5. main path ----------------------------------------------------------------
    model, _ = load_bundled("tpufpu_nano")
    cfg = PipelineConfig(mic_dist=0.04)
    mix_np = (rng.standard_normal((BATCH, 2, N_SAMPLES)) * 0.1).astype(np.float32)
    mix = torch.from_numpy(mix_np).to(dev)
    torch.cuda.synchronize()
    kernels.reset_launches()
    out = learned_enhance(mix, model, cfg, steer_deg=60.0)
    torch.cuda.synchronize()
    counts = dict(kernels.launches)
    check(counts == {"qconv3x3": 21, "masked_mvdr": 1, "convt1x2": 3},
          f"main path launch counts {counts}")
    check(out.shape == (BATCH, N_SAMPLES) and bool(torch.isfinite(out).all()),
          "main path: bad output")
    for name, n in counts.items():
        results[name]["launches"] = n

    model_cpu, _ = load_bundled("tpufpu_nano", device="cpu")
    out_cpu = learned_enhance(mix[:4].cpu(), model_cpu, cfg, steer_deg=60.0)
    wave_rel = float((out[:4].cpu() - out_cpu).norm() / out_cpu.norm())
    Y4 = stft(mix[:4])
    mask_gpu = predict_mask(model, Y4).cpu()
    mask_cpu = predict_mask(model_cpu, Y4.cpu())
    mask_err = (mask_gpu - mask_cpu).abs()
    check(float(mask_err.max()) < 1e-2, f"mask max error {float(mask_err.max()):.3e}")
    check(float(mask_err.mean()) < 2e-4, f"mask mean error {float(mask_err.mean()):.3e}")
    check(wave_rel <= 1e-2, f"waveform relative L2 {wave_rel:.3e}")

    times = []
    for _ in range(3):
        learned_enhance(mix, model, cfg, steer_deg=60.0)
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        learned_enhance(mix, model, cfg, steer_deg=60.0)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    med = statistics.median(times)
    rtf = BATCH * N_SAMPLES / 16_000 / (med / 1e3)
    log("main", batch=BATCH, samples=N_SAMPLES, launches=counts, ms_median=f"{med:.3f}",
        ms_all=[round(t, 3) for t in times], audio_seconds_per_second=f"{rtf:.1f}",
        mask_max_err=f"{float(mask_err.max()):.3e}", mask_mean_err=f"{float(mask_err.mean()):.3e}",
        wave_rel_l2=f"{wave_rel:.3e}")

    # where the time of one call goes, by device kernel
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        learned_enhance(mix, model, cfg, steer_deg=60.0)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    dev_ms = sum(r[1] for r in rows)
    (out_dir / "profile.txt").write_text(prof.key_averages().table(
        sort_by="device_time_total", row_limit=40))
    log("profile", wall_ms=f"{wall_ms:.3f}", device_busy_ms=f"{dev_ms:.3f}",
        idle_share=f"{max(0.0, 1 - dev_ms / wall_ms):.3f}",
        top=[(k[:48], round(t, 3), n) for k, t, n in rows[:8]])

    line = {"kernels": [results[k] for k in ("masked_mvdr", "qconv3x3", "convt1x2")]}
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {**line, "per_shape": {str(k): v for k, v in per_shape.items()},
         "main_ms": times, "card": smi}, indent=1))
    print(json.dumps(line))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
