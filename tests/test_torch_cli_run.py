"""The port's single-run CLI (``python -m azoom_torch.cli.run``) and the
batch CLI's ``--per-run`` on the CPU, against azoom.cli.run and the port's
own library calls.

Tolerances: ``sim`` writes the reference CLI's file names, info.txt lines
and WAV formats (its scene is the port's own: a ``torch.Generator`` where
the reference takes a JAX key); ``inf`` writes the port's library call on
the same WAV bit for bit; ``inf --beamformer oracle`` is within PERF.md's
bounds of the reference's ``do_inf`` on the same mixture (waveform relative L2 <= 1e-2, SIR within 0.05 dB); ``eval``'s
CSV row within the measurement layer's bounds of the reference's on the
same files (SIR and SINR 1e-4 dB, STOI 1e-5, PESQ equal).
"""

import csv
import shutil
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

import azoom.sim.scene as jax_scene
from azoom.cli import run as jax_run
from azoom.config import PathsConfig as JaxPaths
from azoom_torch.cli import batch, run
from azoom_torch.config import DEFAULT, PathsConfig
from azoom_torch.eval.projection import osinr_osir
from azoom_torch.io.wav import read_wav

NAME = "r"
CPU = ["--device", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A 1 s reverberant scene written by the port's ``sim``."""
    root = tmp_path_factory.mktemp("run") / "data"
    run.main(["sim", "--name", NAME, "--duration", "1", "--data-root", str(root), *CPU])
    return root


def _wav_format(path):
    fs, data = wavfile.read(path)
    return fs, data.dtype, data.shape


def test_sim_writes_the_reference_files(root, tmp_path, monkeypatch):
    """The reference's ``do_sim`` with the same arguments (its scene
    generator swapped for zeros of the scene's shapes: only what it writes
    is compared) writes the same files, info.txt lines and WAV formats."""
    n = 16_000

    def zeros_scene(key, spec, room, max_order=None):
        m = len(room.mic_locs)
        return {"mixture": jnp.zeros((m, n)), "target_stereo": jnp.zeros((m, n)),
                "interference_stereo": jnp.zeros((m, n))}

    monkeypatch.setattr(jax_scene, "generate_scene", zeros_scene)
    args = jax_run.build_parser().parse_args(["sim", "--name", NAME, "--duration", "1"])
    ref_dir = jax_run.do_sim(args, JaxPaths(root=tmp_path))
    port_dir = PathsConfig(root=root).run_sim_dir(NAME)
    names = sorted(p.name for p in ref_dir.iterdir())
    assert names == sorted(p.name for p in port_dir.iterdir()) == [
        "info.txt", "interference.wav", "mixture.wav", "target.wav"]
    assert (ref_dir / "info.txt").read_text() == (port_dir / "info.txt").read_text()
    for wav in names[1:]:
        assert _wav_format(ref_dir / wav) == _wav_format(port_dir / wav), wav


def _inputs(root):
    sim = PathsConfig(root=root).run_sim_dir(NAME)
    mix = torch.from_numpy(np.ascontiguousarray(read_wav(sim / "mixture.wav")[0].T))
    stems = [torch.from_numpy(np.ascontiguousarray(read_wav(sim / f"{s}.wav")[0][:, 0]))
             for s in ("target", "interference")]
    return mix, stems


def _library(bf, extra, root):
    """The port's library call that ``inf --beamformer bf`` makes."""
    from azoom_torch.beam.gev import gev_beamform, max_snr_fov_beamform
    from azoom_torch.dsp.delays import far_field_delays
    from azoom_torch.dsp.stft import istft, rfft_freqs, stft
    from azoom_torch.masks.geometric import ipd_deviation_noise_mask
    from azoom_torch.masks.oracle import ibm_target_mask
    from azoom_torch.models.pretrained import load_bundled, load_pretrained_crn_causal
    from azoom_torch.pipelines.autosteer import autosteer_enhance
    from azoom_torch.pipelines.learned import learned_enhance_streaming
    from azoom_torch.pipelines.online_learned import online_learned_enhance
    from azoom_torch.pipelines.oracle import oracle_enhance

    mix, (tgt, itf) = _inputs(root)
    cfg, n = DEFAULT, mix.shape[-1]
    with torch.inference_mode():
        if bf == "oracle":
            return oracle_enhance(mix, tgt, itf, cfg, post_filter="irm")
        if bf == "gev":
            m = ibm_target_mask(stft(tgt, 1024, 512), stft(itf, 1024, 512))
            return istft(gev_beamform(stft(mix, 1024, 512), m) * m, 1024, 512, length=n)
        if bf == "maxsnr_fov":
            Y, freqs = stft(mix, 1024, 512), rfft_freqs(1024, 16_000)
            tau = far_field_delays(90.0, 0.08, 343.0, 2)
            mask = ipd_deviation_noise_mask(Y, -2.0 * np.pi * freqs * (tau[0] - tau[1]))
            return istft(max_snr_fov_beamform(Y, mask, freqs, 90.0, 10.0, 0.08, 343.0, 1e-7),
                         1024, 512, length=n)
        if bf == "autosteer":
            return autosteer_enhance(mix, cfg, fov_center_deg=90.0, fov_width_deg=60.0)[0]
        if bf == "online":
            return online_learned_enhance(mix, load_pretrained_crn_causal(device="cpu"), cfg)
        net, kind = load_bundled("tpufpu_nano", quant="--int8" in extra, device="cpu")
        return learned_enhance_streaming(mix, net, cfg, bf, kind)


CASES = [("oracle", []), ("gev", []), ("maxsnr_fov", []), ("autosteer", []), ("online", []),
         ("mvdr", ["--int8"])]


@pytest.mark.parametrize("bf,extra", CASES, ids=[b + "".join(e) for b, e in CASES])
def test_inf_writes_the_library_call(root, bf, extra):
    """The beamformers that need no net or the causal CRN, and the int8 nano
    net with MVDR, write the library call's output bit for bit (every
    learned beamformer runs one ``learned_enhance_streaming`` call; hard_null
    is held on the card by chip_smoke.py phase 25)."""
    learned = ["--model", "tpufpu_nano"] if bf == "mvdr" else []
    run.main(["inf", "--name", NAME, "--beamformer", bf, "--data-root", str(root), *CPU,
              *learned, *extra])
    out = PathsConfig(root=root).run_results_dir(NAME) / f"{NAME}_enhanced.wav"
    got, fs = read_wav(out)
    want = _library(bf, extra, root).numpy()
    assert fs == 16_000 and got.shape == want.shape == (16_000,)
    assert np.array_equal(got, want), bf


@pytest.fixture(scope="module")
def oracle_runs(root, tmp_path_factory):
    """The port's and the reference's ``inf --beamformer oracle`` and
    ``eval`` of the same scene (the reference in a copy of the run tree)."""
    ref_root = tmp_path_factory.mktemp("ref") / "data"
    shutil.copytree(root / "simulated", ref_root / "simulated")
    run.main(["inf", "--name", NAME, "--data-root", str(root), *CPU])
    port_m = run.do_eval(run.build_parser().parse_args(
        ["eval", "--name", NAME, "--data-root", str(root), *CPU]), PathsConfig(root=root))
    args = jax_run.build_parser().parse_args(["full", "--name", NAME, "--data-root",
                                              str(ref_root)])
    jax_run.do_inf(args, JaxPaths(root=ref_root))
    return root, ref_root, port_m


def test_oracle_inf_matches_the_reference(oracle_runs):
    root, ref_root, _ = oracle_runs
    got = read_wav(PathsConfig(root=root).run_results_dir(NAME) / f"{NAME}_enhanced.wav")[0]
    ref = read_wav(PathsConfig(root=ref_root).run_results_dir(NAME) / f"{NAME}_enhanced.wav")[0]
    _, (tgt, itf) = _inputs(root)
    rel = float(np.linalg.norm(got - ref) / np.linalg.norm(ref))
    d_sir = float(osinr_osir(torch.from_numpy(got), tgt, itf)[1]
                  - osinr_osir(torch.from_numpy(ref), tgt, itf)[1])
    print(f"[parity] run inf oracle: waveform {rel:.3e}, SIR {d_sir:+.4f} dB")  # pytest -s
    assert rel <= 1e-2 and abs(d_sir) <= 0.05


def _rows(root):
    with open(Path(root) / "results" / "batch_metrics.csv") as f:
        return list(csv.DictReader(f))


def test_eval_row_matches_the_reference(oracle_runs):
    """The reference scores the port's enhanced file: the same inputs, so
    the rows agree within the measurement layer's bounds."""
    root, ref_root, port_m = oracle_runs
    shutil.copy(PathsConfig(root=root).run_results_dir(NAME) / f"{NAME}_enhanced.wav",
                PathsConfig(root=ref_root).run_results_dir(NAME) / f"{NAME}_enhanced.wav")
    jax_run.do_eval(jax_run.build_parser().parse_args(["eval", "--name", NAME, "--data-root",
                                                       str(ref_root)]), JaxPaths(root=ref_root))
    got, ref = _rows(root)[-1], _rows(ref_root)[-1]
    assert got.keys() == ref.keys() and got["Run_ID"] == ref["Run_ID"] == NAME
    for k in ("SIR_Base", "SIR_Enh", "SIR_Imp", "SINR_Enh"):
        assert abs(float(got[k]) - float(ref[k])) <= 1e-4 + 0.005, k  # the CSV keeps 2 decimals
    assert abs(float(got["STOI"]) - float(ref["STOI"])) <= 1e-5 + 5e-5, "STOI"  # 4 decimals
    assert got["PESQ_WB"] == ref["PESQ_WB"] and got["PESQ_NB"] == ref["PESQ_NB"]
    assert port_m["sir_s"] > port_m["sir_b"] + 10.0


def test_batch_per_run_runs_each_scene_through_run(tmp_path, capsys):
    ok = batch.main(["--per-run", "--n", "2", "--duration", "0.5", "--beamformer", "oracle",
                     "--data-root", str(tmp_path), *CPU])
    assert ok == (2, 0) and "[BATCH] done: 2 ok, 0 failed" in capsys.readouterr().out
    assert [r["Run_ID"] for r in _rows(tmp_path)] == ["batch_test_000", "batch_test_001"]
    infos = [(tmp_path / "simulated" / f"batch_test_00{i}" / "info.txt").read_text()
             for i in range(2)]
    assert "seed: 0" in infos[0] and "seed: 1" in infos[1]
