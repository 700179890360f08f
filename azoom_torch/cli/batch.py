"""Batch sweeps from the command line: ``python -m azoom_torch.cli.batch --n 50``
(counterpart of azoom.cli.batch, its vectorized mode).

All scenes of a campaign run as batched sweeps (parallel.sweep): streamed
in chunks of ``--chunk-scenes`` and, with several GPUs, sharded over all of
them; one CSV row per scene at the end, in the reference's columns, with
PESQ scored on the host per chunk. Scene i of the campaign is the same
whatever the chunk size (its draws come from (seed, i) alone). Runs on the
card unless ``--device cpu``.

Not ported: ``--per-run`` (the serial per-scene file pipeline; it needs
``cli/run.py``, ROADMAP.md Queue A item 10) and a ``--ckpt`` checkpoint
directory (Queue A item 9d); both raise NotImplementedError.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

_NETS = ["fpu", "deepfpu", "tpufpu", "tpufpu_slim", "tpufpu_nano"]


def build_parser():
    p = argparse.ArgumentParser(prog="azoom_torch.batch", description="Batch sweep")
    p.add_argument("--n", type=int, default=10, help="number of runs")
    p.add_argument("--interferers", type=int, default=2)
    p.add_argument("--start", type=int, default=0, help="start index (resume)")
    p.add_argument("--prefix", default="batch_test")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--per-run", action="store_true",
                   help="serial per-scene file pipeline (not ported)")
    p.add_argument("--data-root", default="data")
    p.add_argument("--beamformer", default="oracle",
                   choices=["oracle", "mvdr", "hard_null", "rmvb", "wpd", "rtf", "gev"])
    p.add_argument("--model", default="fpu", choices=_NETS,
                   help="mask net for learned beamformers")
    p.add_argument("--ckpt", default=None, help="an int8 .npz artifact of --model's net")
    p.add_argument("--int8", action="store_true",
                   help="serve the mask net int8 (the int8 conv kernel on the card)")
    p.add_argument("--no-reverb", action="store_true")
    p.add_argument("--interferer-kind", default="speech",
                   choices=["speech", "babble", "music", "noise"],
                   help="interference class: babble = summed talkers, music = harmonic "
                        "texture, noise = 1/f texture")
    p.add_argument("--fixed-angles", action="store_true",
                   help="anechoic scenes use the fixed 40/130 deg geometry instead of "
                        "randomized interferer angles")
    p.add_argument("--dsp-precision", default="exact", choices=["exact", "fast"],
                   help="checked and selects nothing (the port's DSP is float64 inside)")
    p.add_argument("--steer-error", type=float, default=0.0,
                   help="look-direction error (deg) of the enhancement in learned sweeps "
                        "(camera pointing error); scenes keep the true target angle")
    p.add_argument("--hrnr", action="store_true",
                   help="harmonic-regeneration post-filter in learned sweeps")
    p.add_argument("--duration", type=float, default=2.0)
    p.add_argument("--snr", type=float, default=50.0,
                   help="AWGN sensor-noise SNR in dB (50 = effectively noiseless)")
    p.add_argument("--mic-dist", type=float, default=0.04,
                   help="mic spacing in meters; bundled nets geometry-adapt when the array "
                        "is smaller than their 4 cm training spacing (--no-geo-adapt "
                        "disables)")
    p.add_argument("--mics", type=int, default=2,
                   help="mic count (a linear array at --mic-dist)")
    p.add_argument("--geometry", default=None,
                   help="explicit mic coordinates in meters ('x,y;x,y;...'), overriding "
                        "--mics/--mic-dist; the room places the real array")
    p.add_argument("--no-geo-adapt", action="store_true")
    p.add_argument("--max-order", type=int, default=None,
                   help="image-source order for per-run simulation")
    p.add_argument("--chunk-scenes", type=int, default=64,
                   help="scenes per batched step; a campaign streams in such chunks")
    p.add_argument("--no-pesq", action="store_true",
                   help="skip host-side PESQ scoring (and the waveform fetch)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' for the plain path)")
    return p


def _load_sweep_model(args, cfg, device):
    """(model, feature_kind, geo_dist) for the learned sweep; geo_dist is the
    geometry adaptation's ``train_mic_dist`` (bundled artifacts on arrays
    smaller than their training spacing). The bundled artifacts by default
    (the reverb-trained fpu for reverberant campaigns); ``--ckpt`` takes an
    int8 .npz artifact of ``--model``'s net."""
    from azoom_torch.models.pretrained import _PORTED, geo_adapt_dist, load_bundled

    quant = bool(args.int8)
    if args.ckpt:
        ckpt = Path(args.ckpt)
        if ckpt.suffix != ".npz":
            raise NotImplementedError(
                f"--ckpt {ckpt}: checkpoint directories are not read yet (ROADMAP.md "
                "Queue A item 9d). Pass an int8 .npz artifact")
        from azoom_torch.models.convert import from_flax
        from azoom_torch.models.quantize import load_quantized

        _, cls, kwargs, feature_kind = _PORTED[args.model]
        print(f"[BATCH] using quantized artifact {ckpt}")
        return from_flax(cls, load_quantized(ckpt), kwargs, quant, device), feature_kind, None
    # For plain --model fpu, reverberant campaigns get the reverb-trained twin.
    name = args.model
    if name == "fpu" and not args.no_reverb:
        name = "fpu_reverb"
    # Explicit geometry: the adaptation keys on the first pair's baseline.
    d_eff = cfg.mic_dist
    if cfg.mic_positions is not None:
        p = np.asarray(cfg.mic_positions, np.float64)
        if p.ndim == 1:
            p = p[:, None]
        d_eff = float(np.linalg.norm(p[0][:2] - p[1][:2]))
    geo = None if args.no_geo_adapt else geo_adapt_dist(name, d_eff)
    tag = " (int8 serving)" if quant else ""
    tag += f" (geometry-adapted to {d_eff * 100:.1f} cm)" if geo else ""
    print(f"[BATCH] using bundled {name} artifact{tag}")
    model, feature_kind = load_bundled(name, quant=quant, device=device)
    return model, feature_kind, geo


def run_vectorized(args):
    from azoom_torch.config import DEFAULT, ROOM_DEFAULT, parse_geometry, resolve_device
    from azoom_torch.eval.reports import append_to_csv
    from azoom_torch.parallel.mesh import make_mesh
    from azoom_torch.parallel.sweep import (
        learned_sweep,
        oracle_sweep,
        sharded_sweep,
        sweep_summary,
    )

    cfg = DEFAULT.replace(mic_dist=args.mic_dist, n_mics=args.mics)
    if args.geometry:
        cfg = cfg.with_geometry(parse_geometry(args.geometry))
    # The room's array follows the enhancement config (with --geometry the
    # sweep places the explicit array instead).
    room = ROOM_DEFAULT.with_linear_array(args.mics, args.mic_dist)
    reverb = not args.no_reverb
    dev = resolve_device(args.device)
    n_dev = torch.cuda.device_count() if dev.type == "cuda" else 1
    n = args.n + (-args.n) % n_dev  # rounded up to a multiple of the devices
    common = dict(
        n_samples=int(args.duration * cfg.fs),
        with_stoi=True,
        n_interferers=args.interferers,
        reverb=reverb,
        randomize=not args.fixed_angles,
        with_waveforms=not args.no_pesq,
        interferer_kind=args.interferer_kind,
        room=room,
        snr_db=args.snr,
    )
    if args.beamformer == "oracle":
        if args.steer_error:
            raise SystemExit("--steer-error applies to learned beamformers "
                             "(mvdr/hard_null/rmvb), not the oracle sweep")
        sweep_fn, sweep_args = oracle_sweep, (cfg,)
    elif args.beamformer in ("mvdr", "hard_null", "rmvb", "wpd", "rtf"):
        model, feature_kind, geo = _load_sweep_model(args, cfg, dev)
        sweep_fn, sweep_args = learned_sweep, (cfg, model)
        common.update(beamformer=args.beamformer, feature_kind=feature_kind,
                      steer_error_deg=args.steer_error, train_mic_dist=geo,
                      dsp_precision=args.dsp_precision, harmonic_regen=args.hrnr)
    else:
        raise SystemExit(f"beamformer {args.beamformer!r} is not available in vectorized "
                         "mode; use --per-run")
    chunk = max(n_dev, min(args.chunk_scenes, n))
    chunk -= chunk % n_dev
    print(f"[BATCH] vectorized sweep: {n} scenes over {n_dev} device(s) - {args.beamformer}, "
          f"{args.interferers} interferer(s), {'reverb' if reverb else 'anechoic'}, "
          f"{chunk} scenes/step")

    mesh = make_mesh() if n_dev > 1 else None

    def run_chunk(offset: int, m: int) -> dict:
        if mesh is None:
            return sweep_fn(args.seed, *sweep_args, n_scenes=m, scene_offset=offset,
                            device=dev, **common)
        return sharded_sweep(sweep_fn, args.seed, mesh, m, *sweep_args, scene_offset=offset,
                             **common)

    # Host-side PESQ per streamed chunk: the waveforms are fetched, scored
    # and dropped, so a campaign holds at most one chunk of audio.
    parts, pesq_nb_all, pesq_wb_all = [], [], []
    done = 0
    while done < n:
        m = min(chunk, n - done)
        m += (-m) % n_dev
        p = run_chunk(done, m)
        if not args.no_pesq:
            from azoom_torch.eval.pesq_bridge import pesq_scores

            enh = p.pop("enhanced").cpu().numpy()
            tgt = p.pop("target").cpu().numpy()
            for j in range(enh.shape[0]):
                nb, wb = pesq_scores(tgt[j], enh[j], cfg.fs)
                pesq_nb_all.append(nb)
                pesq_wb_all.append(wb)
        parts.append({k: v.cpu() for k, v in p.items()})
        done += m
    res = {name: torch.cat([p[name] for p in parts])[:n] for name in parts[0]}

    csv_path = Path(args.data_root) / "results" / "batch_metrics.csv"
    for i in range(args.n):
        row = {
            "sir_b": float(res["sir_in"][i]),
            "sir_s": float(res["sir_out"][i]),
            "imp": float(res["sir_imp"][i]),
            "sinr_b": float(res["sinr_in"][i]),
            "sinr_s": float(res["sinr_out"][i]),
            "stoi": float(res["stoi"][i]),
            "pesq_wb": pesq_wb_all[i] if pesq_wb_all else None,
            "pesq_nb": pesq_nb_all[i] if pesq_nb_all else None,
        }
        append_to_csv(csv_path, f"{args.prefix}_{args.start + i:03d}", row)
    summ = sweep_summary(res)
    if pesq_wb_all:
        wb_arr = np.asarray([v for v in pesq_wb_all[:args.n] if v is not None])
        nb_arr = np.asarray([v for v in pesq_nb_all[:args.n] if v is not None])
        if wb_arr.size:
            print(f"[BATCH] pesq_wb: mean {wb_arr.mean():.3f} "
                  f"[{wb_arr.min():.3f}, {wb_arr.max():.3f}]  pesq_nb: mean {nb_arr.mean():.3f}")
    print(f"[BATCH] sir_imp: mean {summ['sir_imp']['mean']:.2f} dB, "
          f"std {summ['sir_imp']['std']:.2f}, n_failed {summ['sir_imp']['n_failed']}")
    print(f"[BATCH] metrics appended to {csv_path}")
    return summ


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.per_run:
        raise NotImplementedError(
            "--per-run (the serial per-scene file pipeline) is not ported: it needs "
            "cli/run.py's sim/inf/eval steps (ROADMAP.md Queue A item 10)")
    return run_vectorized(args)


if __name__ == "__main__":
    main()
