"""Batch analysis: ``python -m azoom_torch.cli.analyze [--csv PATH]``
(counterpart of azoom.cli.analyze; pandas and matplotlib, on the host):
pandas describe() of the batch_metrics.csv the batch and run CLIs append
to, and three plots written next to it (metrics_boxplot.png,
sir_improvement_hist.png, sir_scatter.png).
"""

from __future__ import annotations

import argparse
from pathlib import Path


def analyze(csv_path, out_dir=None) -> dict:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import pandas as pd

    csv_path = Path(csv_path)
    if not csv_path.exists():
        print(f"[ANALYZE] No CSV at {csv_path}")
        return {}
    out_dir = Path(out_dir) if out_dir else csv_path.parent
    out_dir.mkdir(parents=True, exist_ok=True)

    df = pd.read_csv(csv_path)
    num = df[[c for c in df.columns if c != "Run_ID"]].astype(float)
    print(num.describe())

    fig, ax = plt.subplots(figsize=(8, 5))
    cols = [c for c in ("SIR_Base", "SIR_Enh", "SIR_Imp", "SINR_Enh") if c in num]
    num[cols].boxplot(ax=ax)
    ax.set_ylabel("dB")
    ax.set_title("Batch metric distribution")
    fig.savefig(out_dir / "metrics_boxplot.png", dpi=120, bbox_inches="tight")
    plt.close(fig)

    fig, ax = plt.subplots(figsize=(7, 4))
    ax.hist(num["SIR_Imp"], bins=20, edgecolor="black")
    ax.set_xlabel("SIR improvement (dB)")
    ax.set_ylabel("runs")
    ax.set_title("SIR improvement distribution")
    fig.savefig(out_dir / "sir_improvement_hist.png", dpi=120, bbox_inches="tight")
    plt.close(fig)

    fig, ax = plt.subplots(figsize=(6, 6))
    ax.scatter(num["SIR_Base"], num["SIR_Enh"], alpha=0.7)
    lim = [num[["SIR_Base", "SIR_Enh"]].min().min(), num[["SIR_Base", "SIR_Enh"]].max().max()]
    ax.plot(lim, lim, "k--", lw=1, label="no change")
    ax.set_xlabel("input SIR (dB)")
    ax.set_ylabel("output SIR (dB)")
    ax.legend()
    ax.set_title("Enhancement gain per run")
    fig.savefig(out_dir / "sir_scatter.png", dpi=120, bbox_inches="tight")
    plt.close(fig)

    print(f"[ANALYZE] plots written to {out_dir}")
    return {"n_runs": len(df), "describe": num.describe().to_dict()}


def main(argv=None):
    p = argparse.ArgumentParser(prog="azoom_torch.analyze")
    p.add_argument("--csv", default="data/results/batch_metrics.csv")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    return analyze(args.csv, args.out)


if __name__ == "__main__":
    main()
