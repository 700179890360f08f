"""Single-run CLI: ``python -m azoom_torch.cli.run sim|inf|eval|full --name X``
(counterpart of azoom.cli.run).

The reference's modes, options and directory layout (data/simulated/{name}
-> data/results/{name}_results): ``sim`` writes a room scene's
mixture.wav, target.wav, interference.wav and info.txt; ``inf`` enhances the
mixture with ``--beamformer`` (oracle, gev, autosteer, online, maxsnr_fov,
or a learned mask with mvdr, hard_null, rmvb, wpd, rtf) into
{name}_enhanced.wav; ``eval`` scores it (report.txt, batch_metrics.csv).
Runs on the card unless ``--device cpu``. ``sim`` draws from a CPU
``torch.Generator`` seeded with ``--seed``: the same scene on the card and
the CPU, another scene than the reference's for the same seed. Without
``--ckpt`` or a bundled artifact for the features asked for, the learned
net is its twin's own init from seed 0 (other numbers than the reference's
``PRNGKey(0)``).
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from azoom_torch.cli.checkpoint import NETS
from azoom_torch.config import DEFAULT, PathsConfig, RoomConfig


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="azoom_torch.run",
                                description="Audio-Zoom single-run pipeline")
    p.add_argument("mode", choices=["sim", "inf", "eval", "full"])
    p.add_argument("--name", default="test_run", help="Run ID")
    p.add_argument("--interferers", type=int, default=1)
    p.add_argument("--interferer-kind", default="speech",
                   choices=["speech", "babble", "music", "noise"], help="interference class")
    p.add_argument("--no-reverb", action="store_true")
    p.add_argument("--snr", type=float, default=50.0)
    p.add_argument("--duration", type=float, default=4.0)
    p.add_argument("--max-order", type=int, default=None,
                   help="image-source order override (default RoomConfig)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--beamformer", default="oracle",
        choices=["oracle", "mvdr", "hard_null", "rmvb", "wpd", "rtf", "gev", "maxsnr_fov",
                 "autosteer", "online"],
        help="oracle = the stems' ratio mask (no model); gev = oracle-mask GEV; maxsnr_fov = "
             "blind FOV-constrained max-SNR; autosteer = blind localize-in-FOV + steered MVDR; "
             "online = causal CRN + recursive MVDR; mvdr/hard_null/rmvb/wpd/rtf use the "
             "learned mask (--ckpt or the bundled artifact)")
    p.add_argument("--fov", type=float, default=None,
                   help="field-of-view width (deg); default 10 for maxsnr_fov, 60 for autosteer")
    p.add_argument("--track", action="store_true",
                   help="follow a moving talker: a bearing per chunk (pipelines.tracked)")
    p.add_argument("--autosteer", action="store_true",
                   help="learned beamformers: refine the look direction with the blind DOA "
                        "histogram inside --angle +/- --fov/2 first")
    p.add_argument("--ckpt", default=None,
                   help="--model's weights: an int8 .npz artifact, a port checkpoint directory "
                        "(step_<n>.pt) or a reference orbax directory")
    p.add_argument("--int8", action="store_true",
                   help="serve the mask net int8 (the int8 conv kernel on the card)")
    p.add_argument("--model", default="fpu", choices=NETS, help="mask net")
    p.add_argument("--features", default=None, choices=["logmag_ipd", "physics"],
                   help="feature kind; defaults to what --model was trained on")
    p.add_argument("--no-geo-adapt", action="store_true",
                   help="disable inference-time geometry adaptation")
    p.add_argument("--mic-dist", type=float, default=None,
                   help="mic spacing in meters (default from config)")
    p.add_argument("--geometry", default=None,
                   help="explicit mic coordinates in meters ('x,y;x,y;...'), overriding "
                        "--mics/--mic-dist for sim, steering and localization")
    p.add_argument("--mics", type=int, default=2,
                   help="mic count (sim: a linear array at --mic-dist; inf follows the WAV)")
    p.add_argument("--nulls", type=int, default=1,
                   help="hard_null at M>2: interference eigenvectors to null (clamped to M-1)")
    p.add_argument("--angle", type=float, default=90.0, help="zoom steering angle (deg)")
    p.add_argument("--sigma", type=float, default=None, help="diagonal loading")
    p.add_argument("--zoom", type=float, default=None,
                   help="zoom level 0..1 (overrides --sigma via zoom_to_sigma)")
    p.add_argument("--data-root", default="data")
    p.add_argument("--history", default=None, help="append the eval report to this file")
    p.add_argument("--timed", action="store_true", help="print timing for inference")
    p.add_argument("--wpe", action="store_true",
                   help="WPE-dereverberate the mixture before enhancement")
    p.add_argument("--hrnr", action="store_true",
                   help="harmonic-regeneration post-filter on the learned paths")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' for the plain path)")
    return p


def _config(args):
    cfg = DEFAULT.replace(angle_target_deg=args.angle)
    if getattr(args, "mic_dist", None) is not None:
        cfg = cfg.replace(mic_dist=args.mic_dist)
    if getattr(args, "geometry", None):
        from azoom_torch.config import parse_geometry

        cfg = cfg.with_geometry(parse_geometry(args.geometry))
    if args.zoom is not None:
        from azoom_torch.beam.zoom import zoom_to_sigma

        cfg = cfg.replace(sigma=float(zoom_to_sigma(args.zoom)))
    elif args.sigma is not None:
        cfg = cfg.replace(sigma=args.sigma)
    return cfg


def _device(args) -> torch.device:
    from azoom_torch.config import resolve_device

    return resolve_device(getattr(args, "device", None))


def do_sim(args, paths: PathsConfig) -> Path:
    from azoom_torch.io.wav import write_wav
    from azoom_torch.sim.scene import SceneSpec, generate_scene

    spec = SceneSpec(reverb=not args.no_reverb, n_interferers=args.interferers,
                     snr_db=args.snr, duration_s=args.duration,
                     interferer_kind=args.interferer_kind)
    print(f"[SIM] Generating scene '{args.name}' ({spec})...")
    room = RoomConfig()
    if getattr(args, "geometry", None):
        from azoom_torch.config import parse_geometry

        room = room.with_array_positions(parse_geometry(args.geometry))
    elif args.mic_dist is not None or args.mics != 2:
        # the simulated array follows the enhancement's (with_linear_array(2, d)
        # is with_mic_dist(d))
        (x0, _, _), (x1, _, _) = room.mic_locs[0], room.mic_locs[1]
        d = args.mic_dist if args.mic_dist is not None else abs(x1 - x0)
        room = room.with_linear_array(args.mics, d)
    sc = generate_scene(torch.Generator().manual_seed(args.seed), spec, room,
                        max_order=args.max_order, device=_device(args))
    outdir = paths.run_sim_dir(args.name)
    fs = spec.fs
    for name, key in (("mixture", "mixture"), ("target", "target_stereo"),
                      ("interference", "interference_stereo")):
        write_wav(outdir / f"{name}.wav", sc[key].cpu().numpy().T, fs)
    (outdir / "info.txt").write_text(
        f"run: {args.name}\nreverb: {spec.reverb}\n"
        f"n_interferers: {spec.n_interferers}\n"
        f"interferer_kind: {spec.interferer_kind}\nsnr_db: {spec.snr_db}\n"
        f"duration_s: {spec.duration_s}\nfs: {spec.fs}\nseed: {args.seed}\n"
    )
    print(f"[SIM] Files saved to: {outdir}")
    return outdir


def model_features(args) -> str:
    """The feature kind the selected model was trained on; --features only
    overrides it explicitly."""
    from azoom_torch.cli.checkpoint import feature_kind

    return feature_kind(args.model) if args.features is None else args.features


def load_model(args, cfg, device):
    """(served net on ``device``, geo_dist): geo_dist is the training spacing
    to pass to the pipelines as ``train_mic_dist`` (geometry adaptation), or
    None. The bundled artifact where no --ckpt is given and its features are
    the ones asked for; --ckpt's three kinds (cli.checkpoint); else the
    twin's own init from seed 0."""
    from azoom_torch.cli.checkpoint import load_checkpoint, twin

    quant = bool(getattr(args, "int8", False))
    features = model_features(args)
    if not args.ckpt:
        from azoom_torch.models.pretrained import (
            bundled_artifact_path, geo_adapt_dist, load_bundled,
        )

        path = bundled_artifact_path(args.model)
        if path is not None:
            model, bundled_features = load_bundled(args.model, quant=quant, device=device)
            if bundled_features == features:
                geo = (None if getattr(args, "no_geo_adapt", False)
                       else geo_adapt_dist(args.model, cfg.mic_dist))
                print(f"[INF] Using bundled pretrained artifact {path.name}"
                      + (" (int8 serving)" if quant else "")
                      + (f" (geometry-adapted {geo * 100:.0f} cm -> "
                         f"{cfg.mic_dist * 100:.0f} cm)" if geo else ""))
                return model, geo
        print("[INF] WARNING: no --ckpt given; using untrained weights")
        from azoom_torch.models.convert import from_flax

        net = twin(args.model, features, cfg.n_freqs).reset_parameters(
            torch.Generator().manual_seed(0))
        cls, kw = net.serving_spec()
        return from_flax(cls, net.variables(), kw, quant, device), None
    model, step = load_checkpoint(args.model, args.ckpt, features, quant, device, cfg.n_freqs)
    if step is None:
        print(f"[INF] Loaded quantized artifact {args.ckpt}")
    else:
        print(f"[INF] Loaded checkpoint step {step} from {args.ckpt}")
    return model, None


def _stem(path: Path, device) -> torch.Tensor:
    from azoom_torch.io.wav import read_wav

    a, _ = read_wav(path)
    return torch.from_numpy(np.ascontiguousarray(a[:, 0] if a.ndim > 1 else a)).to(device)


def enhance(args, cfg, mixture: torch.Tensor, sim_dir: Path) -> torch.Tensor:
    """``inf``'s enhancement of the (M, n) ``mixture`` (on its device) with
    ``args.beamformer``; the stems, for the oracle paths, from ``sim_dir``."""
    from azoom_torch.dsp.stft import istft, rfft_freqs, stft

    dev = mixture.device
    n = mixture.shape[-1]
    fov = args.fov if args.fov is not None else 60.0
    if args.beamformer == "oracle":
        from azoom_torch.pipelines.oracle import oracle_enhance

        return oracle_enhance(mixture, _stem(sim_dir / "target.wav", dev),
                              _stem(sim_dir / "interference.wav", dev), cfg, post_filter="irm")
    if args.beamformer == "gev":
        from azoom_torch.beam.gev import gev_beamform
        from azoom_torch.masks.oracle import ibm_target_mask

        with torch.inference_mode():
            Y = stft(mixture, cfg.n_fft, cfg.hop)
            m = ibm_target_mask(stft(_stem(sim_dir / "target.wav", dev), cfg.n_fft, cfg.hop),
                                stft(_stem(sim_dir / "interference.wav", dev), cfg.n_fft,
                                     cfg.hop))
            return istft(gev_beamform(Y, m) * m, cfg.n_fft, cfg.hop, length=n)
    if args.beamformer == "autosteer":
        if args.track:
            from azoom_torch.pipelines.tracked import tracked_autosteer_enhance

            out, theta = tracked_autosteer_enhance(mixture, cfg, fov_center_deg=args.angle,
                                                   fov_width_deg=fov)
            track = ", ".join(f"{float(t):.0f}" for t in theta)
            print(f"[INF] tracked bearing per 1 s hop: {track} deg")
            return out
        from azoom_torch.pipelines.autosteer import autosteer_enhance

        out, theta = autosteer_enhance(mixture, cfg, fov_center_deg=args.angle,
                                       fov_width_deg=fov)
        print(f"[INF] autosteer locked onto {float(theta):.1f} deg")
        return out
    if args.beamformer == "online":
        from azoom_torch.models.pretrained import load_pretrained_crn_causal
        from azoom_torch.pipelines.online_learned import online_learned_enhance

        crn = load_pretrained_crn_causal(device=dev)
        print("[INF] causal CRN + recursive MVDR (32 ms algorithmic latency)")
        with torch.inference_mode():
            return online_learned_enhance(mixture, crn, cfg)
    if args.beamformer == "maxsnr_fov":
        from azoom_torch.beam.gev import max_snr_fov_beamform
        from azoom_torch.dsp.delays import far_field_delays
        from azoom_torch.masks.geometric import ipd_deviation_noise_mask

        with torch.inference_mode():
            Y = stft(mixture, cfg.n_fft, cfg.hop)
            freqs = rfft_freqs(cfg.n_fft, cfg.fs, device=dev)
            geom = cfg.geometry()
            tau = far_field_delays(cfg.angle_target_deg, cfg.mic_dist, cfg.c, cfg.n_mics,
                                   positions=None if geom is None else geom.to(dev), device=dev)
            expected_ipd = -2.0 * np.pi * freqs * (tau[0] - tau[1])
            noise_mask = ipd_deviation_noise_mask(
                Y, expected_ipd, pair_mode="first" if cfg.mic_positions is not None else "mean")
            S = max_snr_fov_beamform(Y, noise_mask, freqs, cfg.angle_target_deg,
                                     args.fov if args.fov is not None else 10.0,
                                     cfg.mic_dist, cfg.c, cfg.sigma)
            return istft(S, cfg.n_fft, cfg.hop, length=n)
    model, geo = load_model(args, cfg, dev)
    kind = model_features(args)
    if args.track:
        from azoom_torch.pipelines.tracked import tracked_autosteer_enhance

        out, theta = tracked_autosteer_enhance(
            mixture, cfg, fov_center_deg=args.angle, fov_width_deg=fov, model=model,
            feature_kind=kind, beamformer=args.beamformer, train_mic_dist=geo)
        track = ", ".join(f"{float(t):.0f}" for t in theta)
        print(f"[INF] tracked bearing per 1 s hop: {track} deg "
              f"(learned mask steered blind per chunk)")
        return out
    if args.autosteer:
        from azoom_torch.pipelines.autosteer import autosteer_enhance

        out, theta = autosteer_enhance(
            mixture, cfg, fov_center_deg=args.angle, fov_width_deg=fov, model=model,
            feature_kind=kind, beamformer=args.beamformer, train_mic_dist=geo,
            harmonic_regen=args.hrnr)
        print(f"[INF] autosteer locked onto {float(theta):.1f} deg (learned mask steered blind)")
        return out
    from azoom_torch.pipelines.learned import learned_enhance_streaming

    with torch.inference_mode():
        return learned_enhance_streaming(mixture, model, cfg, beamformer=args.beamformer,
                                         feature_kind=kind, train_mic_dist=geo,
                                         n_nulls=args.nulls, harmonic_regen=args.hrnr)


def do_inf(args, paths: PathsConfig) -> Path:
    from azoom_torch.io.wav import read_wav, write_wav

    cfg = _config(args)
    dev = _device(args)
    sim_dir = paths.run_sim_dir(args.name)
    res_dir = paths.run_results_dir(args.name)
    mix, fs = read_wav(sim_dir / "mixture.wav")
    mixture = torch.from_numpy(np.ascontiguousarray(mix.T)).to(dev)  # (M, n)
    if mixture.shape[0] != cfg.n_mics:
        # follow the recording's channel count (sim wrote an --mics array)
        cfg = cfg.replace(n_mics=int(mixture.shape[0]))
    if args.wpe:
        from azoom_torch.wpe.dereverb import wpe_dereverb

        print("[INF] WPE dereverberation preprocessing...")
        mixture = wpe_dereverb(mixture, cfg)
    print(f"[INF] Enhancing '{args.name}' with {args.beamformer} beamformer...")
    timer = None
    if args.timed:
        from azoom_torch.utils.profiling import stage_timer

        timer = stage_timer()
    out = enhance(args, cfg, mixture, sim_dir)
    if timer is not None:
        import time

        from azoom_torch.utils.profiling import force

        t0 = time.perf_counter()
        force(out)
        wall = time.perf_counter() - t0
        duration = mixture.shape[-1] / fs
        print(timer.report())
        print(f"[INF] end-to-end: {wall:.3f} s for {duration:.2f} s audio "
              f"-> RTF {duration / max(wall, 1e-9):.1f}x realtime")
    out_path = res_dir / f"{args.name}_enhanced.wav"
    write_wav(out_path, out.cpu().numpy(), fs)
    print(f"[INF] Enhanced audio saved to: {out_path}")
    return out_path


def do_eval(args, paths: PathsConfig):
    from azoom_torch.eval.reports import evaluate_run_files

    return evaluate_run_files(args.name, paths.run_sim_dir(args.name),
                              paths.run_results_dir(args.name), history_path=args.history,
                              device=_device(args))


def main(argv=None):
    args = build_parser().parse_args(argv)
    paths = PathsConfig(root=Path(args.data_root))
    if args.mode in ("sim", "full"):
        do_sim(args, paths)
    if args.mode in ("inf", "full"):
        do_inf(args, paths)
    if args.mode in ("eval", "full"):
        do_eval(args, paths)


if __name__ == "__main__":
    main()
