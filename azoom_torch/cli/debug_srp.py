"""SRP localization debugger: ``python -m azoom_torch.cli.debug_srp DIR``
(counterpart of azoom.cli.debug_srp): scans 0-180 deg over the 200-4000 Hz
band of DIR/mixture.wav, prints the peak and plots the normalized dB
response with markers at the expected bearings (DIR/srp_scan.png).
:func:`srp_scan` computes on the card unless ``device="cpu"``;
:func:`plot_srp` needs matplotlib.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np


def srp_scan(run_dir, mic_dist: float = 0.08, phat: bool = False, device=None):
    """(angles_deg, linear power) numpy arrays of the SRP map of
    run_dir/mixture.wav, and the peak bearing in degrees."""
    import torch

    from azoom_torch.config import DEFAULT, resolve_device
    from azoom_torch.dsp.stft import rfft_freqs, stft
    from azoom_torch.io.wav import read_wav
    from azoom_torch.localize.srp import srp_map

    dev = resolve_device(device)
    audio, fs = read_wav(Path(run_dir) / "mixture.wav")
    mixture = torch.from_numpy(np.ascontiguousarray(audio.T)).to(dev)
    cfg = DEFAULT
    Y = stft(mixture, cfg.n_fft, cfg.hop)
    freqs = rfft_freqs(cfg.n_fft, fs, device=dev)
    angles, power = srp_map(Y, freqs, mic_dist, phat=phat)
    angles, power = angles.cpu().numpy(), power.cpu().numpy()
    return angles, power, float(angles[np.argmax(power)])


def plot_srp(angles, power, peak: float, true_angles, out_path) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    power_db = 10 * np.log10(power / power.max() + 1e-12)
    fig, ax = plt.subplots(figsize=(9, 4))
    ax.plot(angles, power_db)
    for a in true_angles:
        ax.axvline(a, color="r", ls="--", alpha=0.6)
    ax.set_xlabel("azimuth (deg)")
    ax.set_ylabel("SRP (dB rel max)")
    ax.set_title(f"SRP scan — peak {peak:.1f} deg")
    fig.savefig(out_path, dpi=120, bbox_inches="tight")
    plt.close(fig)


def main(argv=None):
    p = argparse.ArgumentParser(prog="azoom_torch.debug_srp")
    p.add_argument("run_dir", help="directory containing mixture.wav")
    p.add_argument("--mic-dist", type=float, default=0.08)
    p.add_argument("--true-angles", type=float, nargs="*", default=[40.0, 90.0, 130.0])
    p.add_argument("--phat", action="store_true")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' for the plain path)")
    args = p.parse_args(argv)

    run_dir = Path(args.run_dir)
    angles, power, peak = srp_scan(run_dir, args.mic_dist, args.phat, args.device)
    print(f"[SRP] peak response at {peak:.1f} deg")
    out = run_dir / "srp_scan.png"
    plot_srp(angles, power, peak, args.true_angles, out)
    print(f"[SRP] plot saved to {out}")
    return peak


if __name__ == "__main__":
    main()
