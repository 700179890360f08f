"""The port's host-side evaluation and tooling on the CPU against the JAX
package: PESQ (azoom_torch.eval.pesq_native, a copy of the reference's NumPy
code, and eval.pesq_bridge), the run reports (eval.reports), WAV I/O
(io.wav), the host transfer, timing and FLOP helpers (utils), and the rule
that the port imports neither JAX nor azoom.

Bounds: PESQ bit for bit (the same NumPy code on the same float32 input);
the CSV's bytes equal given equal metrics; the report's lines equal but
for its date; the run metrics' SIR and SINR within 1e-4 dB of the
reference's (the port's projection on the same float32 input; measured
<= 4e-6 dB), STOI within 1e-5 (tests/test_torch_eval.py), PESQ equal.
"""

import csv
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import azoom.eval.reports as jax_reports
from azoom.eval.pesq_native import pesq_native as jax_pesq
from azoom.io.wav import diagnose as jax_diagnose
from azoom.sim.farfield import make_scene
from azoom.sim.signals import speech_like_batch
from azoom.utils.flops import roofline_report as jax_roofline
from azoom_torch.eval import pesq_bridge, reports
from azoom_torch.eval.pesq_native import pesq_native
from azoom_torch.io import diagnose, read_wav, write_wav
from azoom_torch.utils import (
    compiled_flops, force, realtime_factor, roofline_report, stage_timer, time_fn, to_numpy,
    trace,
)

FS = 16_000
DB_BOUND = 1e-4
STOI_BOUND = 1e-5
PORT = Path(__file__).resolve().parent.parent / "azoom_torch"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU work in one thread while this file runs (the suite's
    other workers share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def run():
    """A 2 s far-field scene and a partly enhanced output: the target plus
    a quarter of the mixture's channel 0."""
    sigs = speech_like_batch(jax.random.PRNGKey(11), 3, 2 * FS, FS)
    sc = make_scene(sigs[0], sigs[1:], 80.0, jnp.asarray([30.0, 140.0]), 0.04, FS)
    sc = {k: np.asarray(v) for k, v in sc.items()}
    enhanced = (sc["target_ref"] + 0.25 * sc["mixture"][0]).astype(np.float32)
    return dict(enhanced=enhanced, mix=sc["mixture"][0], tgt=sc["target_ref"],
                itf=sc["interference_ref"])


@pytest.fixture(scope="module")
def metrics(run):
    args = (run["enhanced"], run["mix"], run["tgt"], run["itf"], FS)
    return reports.compute_run_metrics(*args, device="cpu"), jax_reports.compute_run_metrics(*args)


@pytest.mark.parametrize("fs,modes", [(16_000, ("nb", "wb")), (8_000, ("nb",))])
def test_pesq_native_is_the_references_bits(run, fs, modes):
    ref, deg = run["tgt"], run["enhanced"]
    if fs == 8_000:  # a 2 s clip at 8 kHz
        ref, deg = ref[::2].copy(), deg[::2].copy()
    for mode in modes:
        got = pesq_native(fs, ref, deg, mode)
        assert got == jax_pesq(fs, ref, deg, mode) and 1.0 <= got <= 4.6, mode


def test_pesq_bridge(metrics):
    assert pesq_bridge.PESQ_AVAILABLE and pesq_bridge.PESQ_BACKEND in ("itu", "native")
    got, ref = metrics
    assert (got["pesq_nb"], got["pesq_wb"]) == (ref["pesq_nb"], ref["pesq_wb"])
    x = np.zeros(FS, np.float32)
    assert pesq_bridge.pesq_scores(x, x, 44_100) == (None, None)  # no mode applies


def test_compute_run_metrics_matches_jax(metrics):
    got, ref = metrics
    assert list(got) == list(ref) and all(isinstance(v, float) for v in got.values())
    for k in ("sir_b", "sir_s", "imp", "sinr_b", "sinr_s"):
        print(f"[parity] run metric {k}: port {got[k]:.6f} jax {ref[k]:.6f}")
        assert abs(got[k] - ref[k]) <= DB_BOUND, k
    assert abs(got["stoi"] - ref["stoi"]) <= STOI_BOUND
    assert got["imp"] > 5.0  # the enhanced output carries less interference
    plain = reports.compute_run_metrics(*(torch.from_numpy(v) for v in (
        np.zeros(10), np.ones(10), np.ones(10), np.ones(10))), with_perceptual=False)
    assert (plain["stoi"], plain["pesq_wb"], plain["pesq_nb"]) == (None, None, None)


def test_report_and_csv_match_jax(metrics, tmp_path):
    got, _ = metrics
    a, b = reports.format_report("run1", got), jax_reports.format_report("run1", got)
    drop_date = lambda s: [line for line in s.splitlines() if not line.startswith("Date:")]
    assert drop_date(a) == drop_date(b) and len(a.splitlines()) == len(b.splitlines())
    assert "PESQ backend:" in a and "SIR IMPROVEMENT: +" in a
    no_pesq = dict(got, pesq_wb=None, pesq_nb=None, stoi=None)
    assert drop_date(reports.format_report("r", no_pesq)) == drop_date(
        jax_reports.format_report("r", no_pesq))
    assert reports.CSV_HEADERS == jax_reports.CSV_HEADERS
    for mod, name in ((reports, "port.csv"), (jax_reports, "jax.csv")):
        mod.append_to_csv(tmp_path / name, "run1", got)
        mod.append_to_csv(tmp_path / name, "run2", no_pesq)
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "jax.csv").read_bytes()
    rows = list(csv.DictReader(open(tmp_path / "port.csv", newline="")))
    assert [r["Run_ID"] for r in rows] == ["run1", "run2"] and rows[1]["PESQ_WB"] == "N/A"
    (tmp_path / "old.csv").write_text("Run_ID,SIR_Base,PESQ_WB_native\n")
    with pytest.raises(ValueError, match="columns"):
        reports.append_to_csv(tmp_path / "old.csv", "run3", got)


def test_evaluate_run_files_matches_jax(run, tmp_path):
    sim = tmp_path / "sim"
    write_wav(sim / "mixture.wav", np.stack([run["mix"], run["mix"]], axis=1), FS)
    write_wav(sim / "target.wav", run["tgt"], FS)
    write_wav(sim / "interference.wav", run["itf"], FS)
    got_m, ref_m = {}, {}
    for out, fn, tag in ((got_m, reports.evaluate_run_files, "port"),
                         (ref_m, jax_reports.evaluate_run_files, "jax")):
        res = tmp_path / tag / "results"
        write_wav(res / "r_enhanced.wav", run["enhanced"], FS)
        kw = dict(device="cpu") if tag == "port" else {}
        out.update(fn("r", sim, res, FS, history_path=tmp_path / f"{tag}_history.txt", **kw))
        assert (res / "report.txt").exists() and (res.parent / "batch_metrics.csv").exists()
    for k in ("sir_b", "sir_s", "sinr_b", "sinr_s"):
        assert abs(got_m[k] - ref_m[k]) <= DB_BOUND
    assert abs(got_m["stoi"] - ref_m["stoi"]) <= STOI_BOUND
    assert got_m["pesq_wb"] == ref_m["pesq_wb"]
    history = (tmp_path / "port_history.txt").read_text()
    assert history.startswith("=== EVALUATION REPORT: r ===") and history.endswith("\n\n")
    assert reports.evaluate_run_files("missing", sim, tmp_path / "port" / "results",
                                      device="cpu") is None


def test_wav_round_trip_and_diagnose(tmp_path):
    rng = np.random.default_rng(0)
    stereo = (0.1 * rng.standard_normal((1600, 2))).astype(np.float32)
    write_wav(tmp_path / "a" / "s.wav", stereo, FS)
    audio, fs = read_wav(tmp_path / "a" / "s.wav")
    assert fs == FS and audio.dtype == np.float32
    np.testing.assert_array_equal(audio, stereo)
    from scipy.io import wavfile

    wavfile.write(tmp_path / "i16.wav", 8_000, np.array([0, 16384, -32768], np.int16))
    wavfile.write(tmp_path / "u8.wav", 8_000, np.array([128, 192, 0], np.uint8))
    np.testing.assert_array_equal(read_wav(tmp_path / "i16.wav")[0], [0.0, 0.5, -1.0])
    np.testing.assert_array_equal(read_wav(tmp_path / "u8.wav")[0], [0.0, 0.5, -1.0])
    cases = {"ok": stereo, "silent": np.zeros(800, np.float32),
             "nan": np.array([0.1, np.nan], np.float32),
             "quiet": np.full(800, 1e-6, np.float32), "transposed": stereo.T.copy()}
    for name, a in cases.items():
        write_wav(tmp_path / f"{name}.wav", a, FS)
        got, ref = diagnose(tmp_path / f"{name}.wav"), jax_diagnose(tmp_path / f"{name}.wav")
        assert got.keys() == ref.keys() and got["issues"] == ref["issues"], name
        assert got["ok"] == (name == "ok")


def test_profiling_and_flops_helpers(tmp_path):
    a = torch.randn(128, 128)
    assert compiled_flops(torch.matmul, a, a) == 2 * 128**3
    rep = roofline_report(torch.matmul, (a, a), 1e-3)
    ref = jax_roofline(lambda x: x @ x, (jnp.ones((8, 8)),), 1e-3)
    assert rep.keys() == ref.keys() and rep["peak_tflops"] == 67.0
    assert rep["achieved_tflops"] == pytest.approx(2 * 128**3 / 1e-3 / 1e12)
    assert force([torch.ones(3), {"z": torch.tensor([3 + 4j])}]) == 10.0
    dt, out = time_fn(torch.add, a, a, iters=2)
    assert dt > 0 and torch.equal(out, a + a)
    assert realtime_factor(lambda x: x * 2, torch.zeros(2, FS), FS, iters=2) > 0
    st = stage_timer()
    for _ in range(2):
        with st.stage("mm", [a @ a]):
            pass
    assert st.counts == {"mm": 2} and re.search(r"mm: .* ms/call \(n=2\)", st.report())
    with trace(tmp_path / "tr") as log_dir:
        a @ a
    assert Path(log_dir, "trace.json").stat().st_size > 0
    z = torch.tensor([1 + 2j, 3 - 1j], dtype=torch.complex64)
    np.testing.assert_array_equal(to_numpy(z.conj()), np.array([1 - 2j, 3 + 1j], np.complex64))
    arr = np.ones(2)
    assert to_numpy(arr) is arr and to_numpy(1.5) == 1.5


def test_the_port_imports_neither_jax_nor_azoom():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|azoom)(\.|\s|$)", re.MULTILINE)
    files = sorted(PORT.rglob("*.py")) + [PORT.parent / "chip_smoke.py"]
    offenders = [str(p) for p in files if pattern.search(p.read_text())]
    assert len(files) > 60 and not offenders
