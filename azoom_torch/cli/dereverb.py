"""WPE dereverberation CLI: ``python -m azoom_torch.cli.dereverb --outdir DIR``
(counterpart of azoom.cli.dereverb): reads DIR/mixture.wav, writes
DIR/mixture_wpe.wav, with the same --taps/--delay/--iters flags. Runs on the
card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
from pathlib import Path


def main(argv=None):
    p = argparse.ArgumentParser(prog="azoom_torch.dereverb")
    p.add_argument("--outdir", required=True)
    p.add_argument("--taps", type=int, default=10)
    p.add_argument("--delay", type=int, default=3)
    p.add_argument("--iters", type=int, default=3)
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' for the plain path)")
    args = p.parse_args(argv)

    import numpy as np

    from azoom_torch.config import DEFAULT
    from azoom_torch.io.wav import read_wav, write_wav
    from azoom_torch.wpe.dereverb import wpe_dereverb

    outdir = Path(args.outdir)
    audio, fs = read_wav(outdir / "mixture.wav")
    mixture = np.ascontiguousarray(audio.T)  # (C, n)
    print(f"[WPE] Dereverberating {outdir / 'mixture.wav'} "
          f"(taps={args.taps} delay={args.delay} iters={args.iters})...")
    out = wpe_dereverb(mixture, DEFAULT, args.taps, args.delay, args.iters, device=args.device)
    out_path = outdir / "mixture_wpe.wav"
    write_wav(out_path, out.cpu().numpy().T, fs)
    print(f"[WPE] Saved {out_path}")
    return out_path


if __name__ == "__main__":
    main()
