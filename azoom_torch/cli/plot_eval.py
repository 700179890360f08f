"""Perceptual evaluation and spectrogram comparison:
``python -m azoom_torch.cli.plot_eval REF.wav DEG.wav [--out cmp.png]``
(counterpart of azoom.cli.plot_eval). Reports STOI and, where a PESQ
backend exists, PESQ (WB and NB) of channel 0 of each file, and writes a
side-by-side log-spectrogram PNG (DEG_spectrograms.png by default).
:func:`evaluate` and :func:`spectrograms_db` compute on the card unless
``device="cpu"`` (PESQ on the host); :func:`plot_spectrograms` needs
matplotlib.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np


def spectrograms_db(signals, device=None) -> list:
    """20 log10(|STFT| + 1e-8) (1024-point, hop 512) of each 1-D signal, as
    numpy (F, T) arrays."""
    import torch

    from azoom_torch.config import resolve_device
    from azoom_torch.dsp.stft import stft

    dev = resolve_device(device)
    out = []
    for sig in signals:
        Z = stft(torch.from_numpy(np.ascontiguousarray(sig, dtype=np.float32)).to(dev), 1024, 512)
        out.append(20 * np.log10(np.abs(Z.cpu().numpy()) + 1e-8))
    return out


def plot_spectrograms(ref: np.ndarray, deg: np.ndarray, fs: int, out_path,
                      titles=("Reference", "Degraded"), device=None) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 2, figsize=(12, 4.5), sharey=True)
    for ax, sig, mag_db, title in zip(axes, (ref, deg), spectrograms_db((ref, deg), device),
                                      titles):
        extent = [0, len(sig) / fs, 0, fs / 2 / 1000]
        im = ax.imshow(mag_db, origin="lower", aspect="auto", extent=extent,
                       vmin=mag_db.max() - 80, vmax=mag_db.max(), cmap="magma")
        ax.set_title(title)
        ax.set_xlabel("time (s)")
    axes[0].set_ylabel("frequency (kHz)")
    fig.colorbar(im, ax=axes, label="dB")
    fig.savefig(out_path, dpi=120, bbox_inches="tight")
    plt.close(fig)


def load_pair(ref_path, deg_path):
    """Channel 0 of both files, cut to the shorter; (ref, deg, fs)."""
    from azoom_torch.io.wav import read_wav

    ref, fs = read_wav(ref_path)
    deg, fs2 = read_wav(deg_path)
    if ref.ndim > 1:
        ref = ref[:, 0]
    if deg.ndim > 1:
        deg = deg[:, 0]
    n = min(len(ref), len(deg))
    if fs != fs2:
        print(f"[PLOT_EVAL] WARNING: fs mismatch {fs} vs {fs2}")
    return np.ascontiguousarray(ref[:n]), np.ascontiguousarray(deg[:n]), fs


def evaluate(ref: np.ndarray, deg: np.ndarray, fs: int, device=None) -> dict:
    """STOI on the device, PESQ (WB, NB) on the host where a backend exists."""
    from azoom_torch.eval.pesq_bridge import PESQ_AVAILABLE, pesq_scores
    from azoom_torch.eval.stoi import stoi

    out = {"stoi": float(stoi(ref, deg, fs, device=device))}
    if PESQ_AVAILABLE:
        out["pesq_nb"], out["pesq_wb"] = pesq_scores(ref, deg, fs)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(prog="azoom_torch.plot_eval")
    p.add_argument("ref")
    p.add_argument("deg")
    p.add_argument("--out", default=None)
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' for the plain path)")
    args = p.parse_args(argv)

    ref, deg, fs = load_pair(args.ref, args.deg)
    scores = evaluate(ref, deg, fs, args.device)
    print(f"STOI: {scores['stoi']:.4f}")
    if "pesq_wb" in scores:
        print(f"PESQ: {scores['pesq_wb']} (WB) | {scores['pesq_nb']} (NB)")
    else:
        print("PESQ: library not available (optional)")
    out = args.out or (Path(args.deg).with_suffix("").as_posix() + "_spectrograms.png")
    plot_spectrograms(ref, deg, fs, out, device=args.device)
    print(f"[PLOT_EVAL] spectrogram comparison saved to {out}")
    return scores


if __name__ == "__main__":
    main()
