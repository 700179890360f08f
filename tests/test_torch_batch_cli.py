"""The port's batch CLI (``python -m azoom_torch.cli.batch``, vectorized
mode; ``--per-run`` and ``--ckpt`` directories also in
tests/test_torch_cli_run.py and tests/test_torch_ckpt.py) and ``config.parse_geometry`` on the CPU, against azoom.cli.batch and
azoom.config.

The CSV takes the reference CLI's columns and run names (held against a
run of the reference CLI); the scenes are the port's own (a seed where the
reference takes a JAX key), so the metric values are only checked for
sanity. Scene i of a campaign is the same whatever ``--chunk-scenes``: the
rows of two chunkings are held equal.
"""

import csv
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from azoom.cli import batch as jax_batch
from azoom.config import parse_geometry as jax_parse_geometry
from azoom_torch.cli import batch
from azoom_torch.config import parse_geometry
from azoom_torch.models.pretrained import ASSETS

REPO = Path(__file__).resolve().parent.parent
FAST = ["--duration", "0.5", "--no-pesq", "--device", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU work in one thread while this file runs (the suite's
    other workers share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rows(root: Path) -> list[dict]:
    with open(root / "results" / "batch_metrics.csv", newline="") as f:
        return list(csv.DictReader(f))


def _header(root: Path) -> list[str]:
    with open(root / "results" / "batch_metrics.csv", newline="") as f:
        return f.readline().strip().split(",")


@pytest.fixture(scope="module")
def reference_csv(tmp_path_factory):
    """The reference CLI's CSV for 4 oracle runs."""
    root = tmp_path_factory.mktemp("ref")
    jax_batch.main(["--n", "4", "--duration", "0.5", "--no-pesq", "--no-reverb",
                    "--fixed-angles", "--prefix", "sweep", "--start", "3",
                    "--data-root", str(root)])
    return root


def test_module_entry_writes_the_reference_csv(tmp_path, reference_csv):
    """``python -m azoom_torch.cli.batch`` with the oracle beamformer in the
    default reverberant room."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run(
        [sys.executable, "-m", "azoom_torch.cli.batch", "--n", "4", "--prefix", "sweep",
         "--start", "3", "--data-root", str(tmp_path), *FAST],
        env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "[BATCH] vectorized sweep: 4 scenes over 1 device(s)" in r.stdout
    assert "n_failed 0" in r.stdout
    rows, ref = _rows(tmp_path), _rows(reference_csv)
    assert _header(tmp_path) == _header(reference_csv)
    assert [r["Run_ID"] for r in rows] == [r["Run_ID"] for r in ref] == [
        f"sweep_{i:03d}" for i in range(3, 7)]
    for row in rows:
        assert float(row["SIR_Imp"]) > 10.0 and 0.0 < float(row["STOI"]) <= 1.0
        assert row["PESQ_WB"] == row["PESQ_NB"] == "N/A"


def test_learned_hard_null_sweep_with_the_nano_net(tmp_path, capsys):
    summ = batch.main(["--n", "3", "--beamformer", "hard_null", "--model", "tpufpu_nano",
                       "--int8", "--no-reverb", "--data-root", str(tmp_path), *FAST])
    out = capsys.readouterr().out
    assert "using bundled tpufpu_nano artifact (int8 serving)" in out
    assert summ["sir_imp"]["n"] == 3 and summ["sir_imp"]["n_failed"] == 0
    rows = _rows(tmp_path)
    assert [r["Run_ID"] for r in rows] == ["batch_test_000", "batch_test_001", "batch_test_002"]
    assert all(float(r["SIR_Imp"]) > 0.0 for r in rows)
    # the same net named as an int8 .npz artifact gives the same rows
    npz = tmp_path / "npz"
    batch.main(["--n", "3", "--beamformer", "hard_null", "--model", "tpufpu_nano", "--int8",
                "--no-reverb", "--ckpt", str(ASSETS / "tpufpu_b64s4d2e2_phy_int8.npz"),
                "--data-root", str(npz), *FAST])
    assert _rows(npz) == rows


def test_rows_do_not_depend_on_the_chunk_size(tmp_path):
    roots = {}
    for chunk in (2, 4):
        roots[chunk] = tmp_path / f"chunk{chunk}"
        batch.main(["--n", "4", "--no-reverb", "--chunk-scenes", str(chunk),
                    "--data-root", str(roots[chunk]), *FAST])
    assert len(_rows(roots[2])) == 4
    assert _rows(roots[2]) == _rows(roots[4])


def test_options_that_are_not_ported_raise(tmp_path, capsys):
    """``--per-run`` and a checkpoint-directory ``--ckpt`` run (they raised
    until the run CLI and the checkpoint loader were ported); the options
    the reference refuses are refused."""
    assert batch.main(["--per-run", "--n", "1", "--data-root", str(tmp_path), *FAST]) == (1, 0)
    assert (tmp_path / "results" / "batch_test_000_results" / "report.txt").is_file()
    from azoom_torch.cli.checkpoint import twin
    from azoom_torch.train.loop import create_state, save_checkpoint

    state = create_state(twin("fpu", "logmag_ipd"), 0, (1, 513, 64, 2), device="cpu")
    state.step = 7
    save_checkpoint(tmp_path / "ckpt", state)
    summ = batch.main(["--n", "1", "--beamformer", "mvdr", "--ckpt", str(tmp_path / "ckpt"),
                       "--data-root", str(tmp_path), *FAST])
    assert summ["sir_imp"]["n_failed"] == 0
    assert "using checkpoint step 7" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="learned beamformers"):
        batch.main(["--n", "1", "--steer-error", "5", "--data-root", str(tmp_path), *FAST])
    with pytest.raises(SystemExit, match="not available in vectorized mode"):
        batch.main(["--n", "1", "--beamformer", "gev", "--data-root", str(tmp_path), *FAST])


@pytest.mark.parametrize("spec", [
    "-0.015,-0.01; 0.015,-0.01", "0.04;-0.04",
    "-0.015,-0.01;0.015,-0.01;-0.015,0.01;0.015,0.01", "0,0,0;0.02,0,0.01;"])
def test_parse_geometry_matches_the_reference(spec):
    assert parse_geometry(spec) == jax_parse_geometry(spec)


@pytest.mark.parametrize("spec,msg", [("0.01", "at least 2 mics"),
                                      ("1,2,3,4;5", "expected 1-3 coordinates")])
def test_parse_geometry_refuses_what_the_reference_refuses(spec, msg):
    with pytest.raises(ValueError, match=msg):
        parse_geometry(spec)
    with pytest.raises(ValueError, match=msg):
        jax_parse_geometry(spec)
