"""WAV sanity checker: ``python -m azoom_torch.cli.diagnose file.wav [...]``
(counterpart of azoom.cli.diagnose, over ``io.wav.diagnose``; host only).
Exits 1 when any file is unreadable or has an issue, else 0.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    p = argparse.ArgumentParser(prog="azoom_torch.diagnose")
    p.add_argument("paths", nargs="+")
    args = p.parse_args(argv)

    from azoom_torch.io.wav import diagnose

    any_bad = False
    for path in args.paths:
        try:
            d = diagnose(path)
        except Exception as e:  # noqa: BLE001 - an unreadable file is a finding, not a crash
            print(f"{path}: UNREADABLE ({e})")
            any_bad = True
            continue
        status = "OK" if d["ok"] else "ISSUES: " + "; ".join(d["issues"])
        print(
            f"{path}: fs={d['fs']} shape={d['shape']} dur={d['duration_s']:.2f}s "
            f"peak={d['peak']:.3f} rms={d['rms']:.4f} -> {status}"
        )
        any_bad |= not d["ok"]
    sys.exit(1 if any_bad else 0)


if __name__ == "__main__":
    main()
