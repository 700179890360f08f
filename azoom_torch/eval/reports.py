"""Evaluation reporting (counterpart of azoom.eval.reports): the per-run
report.txt, the central batch_metrics.csv and the append-only history.

The metrics (projection SIR/SINR, STOI) run on the device, CUDA unless
``device="cpu"``; PESQ and the files are host-side. The report's layout, the
CSV's columns and its header guard are the reference's, byte for byte.
"""

from __future__ import annotations

import csv
import datetime
import os
from pathlib import Path

import numpy as np

from azoom_torch.config import as_input
from azoom_torch.eval.pesq_bridge import PESQ_BACKEND, pesq_scores
from azoom_torch.eval.projection import osinr_osir
from azoom_torch.eval.stoi import stoi as stoi_fn

__all__ = ["CSV_HEADERS", "compute_run_metrics", "format_report", "append_to_csv",
           "evaluate_run_files"]

# The same perceptual column names under either PESQ backend (the native
# estimator scores on the P.862 MOS-LQO scale; the report's footer names the
# backend).
CSV_HEADERS = [
    "Run_ID", "SIR_Base", "SIR_Enh", "SIR_Imp",
    "SINR_Base", "SINR_Enh", "STOI", "PESQ_WB", "PESQ_NB",
]


def compute_run_metrics(enhanced, mixture_ch0, target_ref, interference_ref, fs: int = 16_000,
                        with_perceptual: bool = True, device=None) -> dict:
    """All scoreboard numbers of one run, as floats: the baseline (the
    mixture's channel 0) and enhanced SIR and SINR, the improvement, STOI and
    PESQ (None when not measured). Inputs are (n,) arrays or tensors, cut to
    the shortest."""
    n = min(map(len, (enhanced, mixture_ch0, target_ref, interference_ref)))
    est, mix, tgt, itf = (as_input(v, device)[:n] for v in
                          (enhanced, mixture_ch0, target_ref, interference_ref))
    sinr_b, sir_b = (float(v) for v in osinr_osir(mix, tgt, itf))
    sinr_s, sir_s = (float(v) for v in osinr_osir(est, tgt, itf))
    # PESQ stays None ("N/A" in the files) when unmeasured: a 0.0 would read
    # as a catastrophic score.
    out = {
        "sir_b": sir_b, "sir_s": sir_s, "imp": sir_s - sir_b,
        "sinr_b": sinr_b, "sinr_s": sinr_s,
        "stoi": None, "pesq_wb": None, "pesq_nb": None,
    }
    if with_perceptual:
        out["stoi"] = float(stoi_fn(tgt, est, fs))
        nb, wb = pesq_scores(tgt.cpu().numpy(), est.cpu().numpy(), fs)
        out["pesq_nb"] = nb
        out["pesq_wb"] = wb
    return out


def _fmt(v, spec: str) -> str:
    """Format a metric; None renders as N/A (not measured)."""
    return "N/A" if v is None else f"{v:{spec}}"


def format_report(run_name: str, m: dict) -> str:
    """The report.txt layout."""
    timestamp = datetime.datetime.now().strftime("%Y-%m-%d %H:%M:%S")
    lines = [
        f"=== EVALUATION REPORT: {run_name} ===",
        f"Date: {timestamp}",
        "------------------------------------",
        "BASELINE (Mixture):",
        f"  SIR:   {m['sir_b']:.2f} dB",
        f"  SINR:  {m['sinr_b']:.2f} dB",
        "------------------------------------",
        "ENHANCED (Output):",
        f"  SIR:   {m['sir_s']:.2f} dB",
        f"  SINR:  {m['sinr_s']:.2f} dB",
        f"  STOI:  {_fmt(m['stoi'], '.4f')}",
        f"  PESQ:  {_fmt(m['pesq_wb'], '.4f')} (WB) | {_fmt(m['pesq_nb'], '.4f')} (NB)",
        "------------------------------------",
        f"SIR IMPROVEMENT: {m['imp']:+.2f} dB",
        "====================================",
    ]
    if m.get("pesq_wb") is not None or m.get("pesq_nb") is not None:
        lines.append(f"PESQ backend: {PESQ_BACKEND}")
    return "\n".join(lines)


def append_to_csv(csv_path: str | os.PathLike, run_name: str, m: dict) -> None:
    """Append one row to the central batch CSV; a CSV started with other
    columns raises instead of taking rows it cannot hold."""
    csv_path = Path(csv_path)
    csv_path.parent.mkdir(parents=True, exist_ok=True)
    file_exists = csv_path.is_file()
    if file_exists:
        with open(csv_path, newline="") as f:
            existing = f.readline().strip().split(",")
        if existing and existing != CSV_HEADERS:
            raise ValueError(
                f"{csv_path} was written with columns {existing}; this "
                f"environment would append {CSV_HEADERS} (different PESQ "
                "backend/scale). Use a fresh CSV per backend."
            )
    with open(csv_path, "a", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=CSV_HEADERS)
        if not file_exists:
            writer.writeheader()
        writer.writerow({
            "Run_ID": run_name,
            "SIR_Base": f"{m['sir_b']:.2f}",
            "SIR_Enh": f"{m['sir_s']:.2f}",
            "SIR_Imp": f"{m['imp']:.2f}",
            "SINR_Base": f"{m['sinr_b']:.2f}",
            "SINR_Enh": f"{m['sinr_s']:.2f}",
            "STOI": _fmt(m["stoi"], ".4f"),
            "PESQ_WB": _fmt(m["pesq_wb"], ".4f"),
            "PESQ_NB": _fmt(m["pesq_nb"], ".4f"),
        })


def evaluate_run_files(run_name: str, sim_dir: str | os.PathLike,
                       results_dir: str | os.PathLike, fs: int = 16_000,
                       history_path: str | os.PathLike | None = None,
                       device=None) -> dict | None:
    """File-based evaluation: reads mixture.wav, target.wav and
    interference.wav from ``sim_dir`` and ``{run_name}_enhanced.wav`` from
    ``results_dir`` (channel 0 of each); writes report.txt, appends
    ``results_dir``'s parent's batch_metrics.csv and, when given, the history
    file. None (with a message) when the enhanced file is missing."""
    from azoom_torch.io.wav import read_wav

    sim_dir, results_dir = Path(sim_dir), Path(results_dir)
    est_path = results_dir / f"{run_name}_enhanced.wav"
    if not est_path.exists():
        print(f"[EVAL] Error: Inference output not found at {est_path}")
        return None

    def ch0(path):
        audio, _ = read_wav(path)
        return np.ascontiguousarray(audio[:, 0] if audio.ndim > 1 else audio)

    est = ch0(est_path)
    tgt = ch0(sim_dir / "target.wav")
    itf = ch0(sim_dir / "interference.wav")
    mix = ch0(sim_dir / "mixture.wav")

    m = compute_run_metrics(est, mix, tgt, itf, fs, device=device)
    report = format_report(run_name, m)
    print(report)
    (results_dir / "report.txt").write_text(report)
    append_to_csv(results_dir.parent / "batch_metrics.csv", run_name, m)
    if history_path is not None:
        with open(history_path, "a") as f:
            f.write(report + "\n\n")
    return m
