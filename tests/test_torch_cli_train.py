"""``python -m azoom_torch.cli.train`` on the CPU: a tiny FPU trains 3
steps, checkpoints, and a second run resumes to 5 steps; the refusals match
the reference CLI's (qcnn without physics features, an --init-from artifact
of other features); the arguments map to the reference CLI's nets."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

from azoom_torch.cli import train as cli

REPO = Path(__file__).resolve().parent.parent
TINY = ["--device", "cpu", "--model", "fpu", "--base", "2", "--batch", "1", "--seconds", "0.512"]


def _run(args, cwd):
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-m", "azoom_torch.cli.train", *args], cwd=cwd,
                          env=env, capture_output=True, text=True, timeout=240)


def test_trains_checkpoints_and_resumes(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    r = _run(TINY + ["--steps", "3", "--ckpt", ckpt], tmp_path)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "finished at step 3" in r.stdout
    r = _run(TINY + ["--steps", "5", "--ckpt", ckpt], tmp_path)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "resumed from step 3" in r.stdout and "finished at step 5" in r.stdout
    assert sorted(p.name for p in Path(ckpt).glob("step_*.pt")) == [
        "step_000000003.pt", "step_000000005.pt"]


@pytest.mark.parametrize("args,message", [
    (["--model", "qcnn"], "pass --features physics"),
    (["--init-from", "tpufpu_nano"], "pass --features physics"),
    (["--model", "fpu", "--init-from", "crn_causal", "--features", "physics"],
     "pass --features logmag_ipd"),
])
def test_refusals_match_the_reference(args, message, tmp_path):
    with pytest.raises(SystemExit, match=message):
        cli.main(["--device", "cpu", "--steps", "0", "--ckpt", str(tmp_path / "c"), *args])


def test_models_follow_the_reference_cli():
    p = cli.build_parser()
    m = cli.build_model(p.parse_args(["--model", "crn", "--base", "32", "--causal"]))
    assert (m.base, m.hidden, m.unidirectional) == (16, 128, True)  # crn_causal's widths
    m = cli.build_model(p.parse_args(["--model", "tpufpu", "--base", "64", "--bneck", "4"]))
    assert (m.base, m.fold, m.bneck) == (64, 4, 4)
    m = cli.build_model(p.parse_args(["--model", "blstm", "--base", "8"]))
    assert (m.hidden, m.unidirectional) == (64, False)
    m = cli.build_model(p.parse_args(["--model", "qcnn", "--features", "physics", "--base", "2"]))
    assert m.base == 1
