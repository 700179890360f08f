"""Beam-pattern / beamwidth zoom study: ``python -m azoom_torch.cli.zoom_study
--out DIR`` (counterpart of azoom.cli.zoom_study). For a synthetic
interference field it sweeps sigma and plots each MVDR beam pattern
(beam_pattern_sigma_*.png), the sigma -> beamwidth curve
(sigma_vs_beamwidth.png) and the narrow and wide zoom presets
(beam_pattern_Zoom In (Narrow).png, beam_pattern_Zoom Out (Wide).png).
:func:`zoom_study` computes on the card unless ``device="cpu"``;
:func:`plot_zoom_study` needs matplotlib.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

SIGMAS = [0.0, 1e-9, 1e-6, 1e-5, 1e-3, 1e-1]
PRESETS = (("Zoom In (Narrow)", 1.0), ("Zoom Out (Wide)", 0.0))


def zoom_study(mic_dist: float = 0.08, target: float = 90.0, interferer: float = 40.0,
               sigmas=SIGMAS, device=None) -> dict:
    """The study's numbers as numpy arrays: ``angles`` (181,), ``patterns``
    {sigma: band-averaged broadband pattern (181,)}, ``sig_grid`` and
    ``widths`` (the -3 dB beamwidth per sigma of a 17-point log grid),
    ``presets`` {label: (sigma, pattern)}."""
    import torch

    from azoom_torch.beam.mvdr import mvdr_weights
    from azoom_torch.beam.zoom import beam_pattern, sigma_vs_beamwidth, zoom_to_sigma
    from azoom_torch.config import DEFAULT, resolve_device
    from azoom_torch.dsp.delays import steering_vector
    from azoom_torch.dsp.stft import rfft_freqs

    dev = resolve_device(device)
    cfg = DEFAULT
    freqs = rfft_freqs(cfg.n_fft, cfg.fs, device=dev)
    d = steering_vector(freqs, target, mic_dist)
    d_int = steering_vector(freqs, interferer, mic_dist)
    R = (torch.einsum("fm,fn->fmn", d_int, torch.conj(d_int))
         + 0.01 * torch.eye(2, dtype=torch.complex64, device=dev))
    angles = torch.arange(0.0, 180.5, 1.0, device=dev)
    band = ((freqs >= 500) & (freqs <= 3500)).cpu().numpy()

    def broadband_pattern(sigma):
        w = mvdr_weights(R, d, sigma=max(sigma, 1e-12))
        pat = beam_pattern(w, freqs, angles, mic_dist).cpu().numpy()  # (A, F)
        return (pat * band).sum(-1) / band.sum()

    sig_grid = torch.as_tensor(np.logspace(-9, -1, 17), dtype=torch.float32)
    _, widths = sigma_vs_beamwidth(R, d, freqs, sig_grid, mic_dist, target,
                                   angles_deg=angles)
    presets = {}
    for label, zoom in PRESETS:
        sigma = float(zoom_to_sigma(zoom))
        presets[label] = (sigma, broadband_pattern(sigma))
    return dict(angles=angles.cpu().numpy(),
                patterns={s: broadband_pattern(s) for s in sigmas},
                sig_grid=sig_grid.numpy(), widths=widths.cpu().numpy(), presets=presets)


def plot_zoom_study(study: dict, out, target: float = 90.0, interferer: float = 40.0) -> list:
    """The study's PNGs under ``out``; returns their paths."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    out = Path(out)
    out.mkdir(parents=True, exist_ok=True)
    angles, paths = study["angles"], []
    for sigma, bp in study["patterns"].items():
        fig, ax = plt.subplots(figsize=(8, 4))
        ax.plot(angles, 10 * np.log10(bp / bp.max() + 1e-12))
        ax.axvline(target, color="g", ls="--", label="target")
        ax.axvline(interferer, color="r", ls="--", label="interferer")
        ax.set_ylim(-60, 3)
        ax.set_xlabel("azimuth (deg)")
        ax.set_ylabel("response (dB)")
        ax.set_title(f"MVDR beam pattern, sigma={sigma:.1e}")
        ax.legend()
        paths.append(out / f"beam_pattern_sigma_{sigma:.1e}.png")
        fig.savefig(paths[-1], dpi=120, bbox_inches="tight")
        plt.close(fig)

    fig, ax = plt.subplots(figsize=(7, 4))
    ax.semilogx(study["sig_grid"], study["widths"], marker="o")
    ax.set_xlabel("diagonal loading sigma")
    ax.set_ylabel("-3 dB beamwidth (deg)")
    ax.set_title("Zoom control: sigma vs beamwidth")
    paths.append(out / "sigma_vs_beamwidth.png")
    fig.savefig(paths[-1], dpi=120, bbox_inches="tight")
    plt.close(fig)

    for label, (sigma, bp) in study["presets"].items():
        fig, ax = plt.subplots(figsize=(8, 4))
        ax.plot(angles, 10 * np.log10(bp / bp.max() + 1e-12))
        ax.set_ylim(-60, 3)
        ax.set_title(f"{label}  (sigma={sigma:.1e})")
        ax.set_xlabel("azimuth (deg)")
        ax.set_ylabel("response (dB)")
        paths.append(out / f"beam_pattern_{label}.png")
        fig.savefig(paths[-1], dpi=120, bbox_inches="tight")
        plt.close(fig)
    return paths


def main(argv=None):
    p = argparse.ArgumentParser(prog="azoom_torch.zoom_study")
    p.add_argument("--out", default="assets/plots")
    p.add_argument("--mic-dist", type=float, default=0.08)
    p.add_argument("--target", type=float, default=90.0)
    p.add_argument("--interferer", type=float, default=40.0)
    p.add_argument("--sigmas", type=float, nargs="*", default=SIGMAS)
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' for the plain path)")
    args = p.parse_args(argv)

    study = zoom_study(args.mic_dist, args.target, args.interferer, args.sigmas, args.device)
    paths = plot_zoom_study(study, args.out, args.target, args.interferer)
    print(f"[ZOOM] study plots written to {args.out}")
    return paths


if __name__ == "__main__":
    main()
