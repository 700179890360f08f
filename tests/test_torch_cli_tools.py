"""The port's tool CLIs (dereverb, diagnose, debug_srp, zoom_study,
plot_eval, analyze) and the named loaders of ``models.pretrained`` on the
CPU, against azoom.

Tolerances: diagnose's lines and exit codes equal; dereverb's waveform
relative L2 <= 1e-3 (tests/test_torch_dereverb.py's WPE bound); debug_srp's
peak equal to the reference ``srp_map``'s and its power within 1e-5 of the
peak; zoom_study's band-averaged patterns within 1e-5 of their peak and its
beamwidths equal, its PNG names the reference CLI's; plot_eval's STOI within
1e-5; analyze's
``describe()`` equal; every ``load_pretrained_*`` the net ``load_bundled``
serves, buffer for buffer, and ``bundled_artifact_path`` the reference's
file names.
"""

import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import azoom.models.pretrained as jax_pretrained
from azoom.beam.mvdr import mvdr_weights as jax_mvdr_weights
from azoom.beam.zoom import beam_pattern as jax_beam_pattern
from azoom.beam.zoom import sigma_vs_beamwidth as jax_sigma_vs_beamwidth
from azoom.beam.zoom import zoom_to_sigma as jax_zoom_to_sigma
from azoom.cli import analyze as jax_analyze
from azoom.cli import diagnose as jax_diagnose
from azoom.config import DEFAULT as JAX_DEFAULT
from azoom.dsp.delays import steering_vector as jax_steering_vector
from azoom.dsp.stft import rfft_freqs as jax_rfft_freqs
from azoom.dsp.stft import stft as jax_stft
from azoom.eval.stoi import stoi as jax_stoi
from azoom.localize.srp import srp_map as jax_srp_map
from azoom.wpe.dereverb import wpe_dereverb as jax_wpe_dereverb
from azoom_torch.cli import analyze, debug_srp, dereverb, diagnose, plot_eval, zoom_study
from azoom_torch.io.wav import read_wav, write_wav
from azoom_torch.models import pretrained


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """A 1 s two-talker mixture (the target at 90 deg, an interferer at 40,
    an 8 cm pair, a reverberant tail) as the run CLI's files."""
    d = tmp_path_factory.mktemp("scene")
    rng = np.random.default_rng(7)
    n, fs = 16_000, 16_000
    t = np.arange(n) / fs
    src = [np.sin(2 * np.pi * f0 * t * (1 + 0.1 * np.sin(2 * np.pi * 3 * t)))
           * (1 + np.sin(2 * np.pi * 4 * t + k)) for k, f0 in enumerate((150.0, 220.0))]
    mix, stems = np.zeros((2, n)), []
    for s, theta in zip(src, (90.0, 40.0)):
        lag = 0.08 * np.cos(np.deg2rad(theta)) / 343.0 * fs
        spec = np.fft.rfft(s)
        k = np.arange(spec.size)
        pair = np.stack([np.fft.irfft(spec, n),
                         np.fft.irfft(spec * np.exp(-2j * np.pi * k * lag / n), n)])
        pair += 0.05 * np.stack([np.convolve(c, np.exp(-np.arange(800) / 200.0)
                                             * rng.standard_normal(800), "full")[:n]
                                 for c in pair])
        stems.append(pair)
        mix += pair
    peak = np.abs(mix).max()
    for name, a in (("mixture", mix), ("target", stems[0]), ("interference", stems[1])):
        write_wav(d / f"{name}.wav", (a / peak).T.astype(np.float32), fs)
    return d


def _lines(capsys):
    return capsys.readouterr().out.splitlines()


def test_diagnose_lines_and_exit_codes_are_the_references(scene, tmp_path, capsys):
    write_wav(tmp_path / "silent.wav", np.zeros((800, 2), np.float32), 16_000)
    bad = np.zeros((800, 2), np.float32)
    bad[3, 1] = np.nan
    write_wav(tmp_path / "nan.wav", bad, 16_000)
    for paths in ([str(scene / "mixture.wav")],
                  [str(scene / "mixture.wav"), str(tmp_path / "silent.wav"),
                   str(tmp_path / "nan.wav"), str(tmp_path / "missing.wav")]):
        codes = []
        for cli in (diagnose, jax_diagnose):
            with pytest.raises(SystemExit) as e:
                cli.main(paths)
            codes.append((e.value.code, _lines(capsys)))
        assert codes[0] == codes[1]
        assert codes[0][0] == (0 if len(paths) == 1 else 1)


def test_dereverb_matches_the_reference(scene, tmp_path):
    shutil.copy(scene / "mixture.wav", tmp_path / "mixture.wav")
    out = dereverb.main(["--outdir", str(tmp_path), "--device", "cpu"])
    got, fs = read_wav(out)
    x = read_wav(scene / "mixture.wav")[0]
    want = np.asarray(jax_wpe_dereverb(jnp.asarray(x.T), JAX_DEFAULT, 10, 3, 3)).T
    rel = float(np.linalg.norm(got - want) / np.linalg.norm(want))
    print(f"[parity] dereverb: {rel:.3e}")  # pytest -s
    assert out.name == "mixture_wpe.wav" and got.shape == x.shape and rel <= 1e-3


def test_debug_srp_peak_is_the_references(scene, capsys):
    peak = debug_srp.main([str(scene), "--device", "cpu"])
    assert (scene / "srp_scan.png").is_file()
    x = read_wav(scene / "mixture.wav")[0]
    angles, power = jax_srp_map(jax_stft(jnp.asarray(x.T)), jax_rfft_freqs(1024, 16_000), 0.08)
    angles, power = np.asarray(angles), np.asarray(power)
    assert peak == float(angles[np.argmax(power)])
    a, p, _ = debug_srp.srp_scan(scene, device="cpu")
    np.testing.assert_array_equal(a, angles)
    assert float(np.abs(p - power).max()) <= 1e-5 * float(power.max())
    assert f"[SRP] peak response at {peak:.1f} deg" in capsys.readouterr().out


def test_zoom_study_matches_the_reference(tmp_path):
    sigmas = [0.0, 1e-6]
    paths = zoom_study.main(["--out", str(tmp_path), "--sigmas", *map(str, sigmas),
                             "--device", "cpu"])
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(p.name for p in paths) == [
        "beam_pattern_Zoom In (Narrow).png", "beam_pattern_Zoom Out (Wide).png",
        "beam_pattern_sigma_0.0e+00.png", "beam_pattern_sigma_1.0e-06.png",
        "sigma_vs_beamwidth.png"]
    study = zoom_study.zoom_study(sigmas=sigmas, device="cpu")
    # the reference CLI's computation (azoom/cli/zoom_study.py), by its functions
    freqs = jax_rfft_freqs(1024, 16_000)
    d, d_int = jax_steering_vector(freqs, 90.0, 0.08), jax_steering_vector(freqs, 40.0, 0.08)
    R = (jnp.einsum("fm,fn->fmn", d_int, jnp.conj(d_int))
         + 0.01 * jnp.eye(2, dtype=jnp.complex64))
    angles = jnp.arange(0.0, 180.5, 1.0)
    band = np.asarray((freqs >= 500) & (freqs <= 3500))

    def broadband(sigma):
        w = jax_mvdr_weights(R, d, sigma=max(sigma, 1e-12))
        return (np.asarray(jax_beam_pattern(w, freqs, angles, 0.08)) * band).sum(-1) / band.sum()

    presets = {"Zoom In (Narrow)": 1.0, "Zoom Out (Wide)": 0.0}
    for got, sigma in [(study["patterns"][s], s) for s in sigmas] + [
            (study["presets"][k][1], float(jax_zoom_to_sigma(z))) for k, z in presets.items()]:
        want = broadband(sigma)
        assert float(np.abs(got - want).max()) <= 1e-5 * float(want.max()), sigma
    # three points of the 17-point grid (each width is computed on its own)
    pick = [0, 8, 16]
    _, widths = jax_sigma_vs_beamwidth(R, d, freqs, jnp.asarray(np.logspace(-9, -1, 17)[pick]),
                                       0.08, 90.0)
    np.testing.assert_array_equal(study["sig_grid"], np.logspace(-9, -1, 17).astype(np.float32))
    np.testing.assert_array_equal(study["widths"][pick], np.asarray(widths))


def test_plot_eval_stoi_is_the_references(scene, tmp_path, capsys):
    deg = tmp_path / "deg.wav"
    shutil.copy(scene / "mixture.wav", deg)
    scores = plot_eval.main([str(scene / "target.wav"), str(deg), "--device", "cpu"])
    assert (tmp_path / "deg_spectrograms.png").is_file()
    ref = read_wav(scene / "target.wav")[0][:, 0]
    mix = read_wav(deg)[0][:, 0]
    want = float(jax_stoi(jnp.asarray(ref), jnp.asarray(mix), 16_000))
    assert abs(scores["stoi"] - want) <= 1e-5
    assert f"STOI: {scores['stoi']:.4f}" in capsys.readouterr().out


def test_analyze_describes_as_the_reference(tmp_path):
    rng = np.random.default_rng(3)
    rows = ["Run_ID,SIR_Base,SIR_Enh,SIR_Imp,SINR_Enh,STOI,PESQ_WB,PESQ_NB"]
    for i in range(6):
        v = rng.normal(size=7)
        rows.append(f"run_{i:03d}," + ",".join(f"{x:.2f}" for x in v))
    csv_path = tmp_path / "batch_metrics.csv"
    csv_path.write_text("\n".join(rows) + "\n")
    got = analyze.main(["--csv", str(csv_path), "--out", str(tmp_path / "port")])
    want = jax_analyze.analyze(csv_path, tmp_path / "ref")
    assert got == want and got["n_runs"] == 6
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == sorted(
        p.name for p in (tmp_path / "ref").iterdir())


NAMED = ["fpu", "fpu_reverb", "fpu_multigeo", "deepfpu", "tpufpu", "tpufpu_slim", "tpufpu_nano",
         "crn_causal"]


@pytest.mark.parametrize("name", NAMED)
def test_named_loaders_are_load_bundled(name):
    assert pretrained.bundled_artifact_path(name).name == \
        jax_pretrained.bundled_artifact_path(name).name
    loader = getattr(pretrained, f"load_pretrained_{name}")
    quant = name == "tpufpu_nano"
    got = loader(device="cpu") if name == "crn_causal" else loader(quant=quant, device="cpu")
    want, _ = pretrained.load_bundled(name, quant=quant, device="cpu")
    g, w = got.state_dict(), want.state_dict()
    assert type(got) is type(want) and g.keys() == w.keys()
    assert all(torch.equal(g[k], w[k]) for k in g)
    assert set(jax_pretrained.__all__) <= set(pretrained.__all__)
