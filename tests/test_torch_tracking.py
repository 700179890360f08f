"""The port's DOA trackers (azoom_torch.localize.tracking), the heuristic
tracked pipeline (azoom_torch.pipelines.tracked.tracked_autosteer_enhance)
and AudioZoom(track=True).enhance of a clip longer than a window, on the
CPU against azoom with JAX on the CPU.

Trackers run on synthetic (chunk x angle) histograms built as the
reference's own tracking tests build them (tests/test_tracking_fast.py,
tests/test_tracking.py): a glide, a glide with a distractor that out-votes
the target on every third chunk, two crossing glides with a louder
distractor, and a random walk with distractor bursts, each under a fixed
field of view and under a per-chunk (panning) one. The pipeline runs on a
10 s moving-talker scene of azoom.sim.motion (target 60 -> 120 deg,
interferers at 30 and 150 deg, 9 chunks).

Bounds: the bearings are EQUAL to the reference's at every chunk (the
trellis keeps the reference's operation order, and the EMA blend its fused
multiply-add); the heuristic waveforms are within 1e-4 relative L2 (float32
roundings only: no net). The learned tracked path is
tests/test_torch_tracked_learned.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import azoom
import azoom.localize.tracking as jt
from azoom.config import PipelineConfig as JaxConfig
from azoom.pipelines.tracked import tracked_autosteer_enhance as jax_tracked
from azoom.sim.motion import linear_trajectory, make_moving_scene, traj_block_count
from azoom.sim.signals import speech_like_batch
from azoom_torch import AudioZoom, PipelineConfig
from azoom_torch.localize import tracking
from azoom_torch.pipelines.tracked import TRACKERS, tracked_autosteer_enhance

ANGLES = np.linspace(0.0, 180.0, 181, dtype=np.float32)
C_SYN = 13  # chunks of every synthetic pattern: one compiled reference per tracker


def _bump(center, width):
    return np.exp(-0.5 * ((ANGLES - center) / width) ** 2).astype(np.float32)


def _glide():
    rng = np.random.default_rng(0)
    return np.stack([_bump(th, 5.0) + 0.02 * rng.random(181, dtype=np.float32)
                     for th in np.linspace(70.0, 110.0, C_SYN)])


def _distractor():
    rng = np.random.default_rng(1)
    return np.stack([_bump(th, 6.0) + (1.5 if c % 3 == 1 else 0.25) * _bump(160.0, 6.0)
                     + 0.02 * rng.random(181, dtype=np.float32)
                     for c, th in enumerate(np.linspace(60.0, 110.0, C_SYN))])


def _crossing():
    return np.stack([_bump(a, 4.0) + 1.4 * _bump(b, 4.0) for a, b in
                     zip(np.linspace(60.0, 120.0, C_SYN), np.linspace(120.0, 60.0, C_SYN))])


def _random_walk():
    rng = np.random.default_rng(2)
    true = 90.0 + np.cumsum(rng.normal(0.0, 6.0, C_SYN))
    burst = rng.random(C_SYN) > 0.6
    return np.stack([_bump(th, 6.0) + 1.5 * b * _bump(rng.uniform(0, 180), 6.0)
                     + 0.05 * rng.random(181, dtype=np.float32) for th, b in zip(true, burst)])


PATTERNS = {"glide": _glide, "distractor": _distractor, "crossing": _crossing,
            "random_walk": _random_walk}

TRACKER_CASES = {  # name: (function, keywords)
    "viterbi": ("viterbi_track", dict(trans_sigma_deg=8.0)),
    "causal": ("causal_track", dict(trans_sigma_deg=12.0)),
    "causal_lag2": ("causal_track", dict(trans_sigma_deg=12.0, lag=2)),
    "causal_prior": ("causal_track", dict(trans_sigma_deg=12.0, init_prior_sigma_deg=18.0)),
    "momentum": ("momentum_track", dict(rate_deg_per_chunk=5.0, init_prior_sigma_deg=10.0)),
    "momentum_causal": ("momentum_track", dict(trans_sigma_deg=4.8, rate_deg_per_chunk=8.4,
                                               causal=True, init_prior_sigma_deg=8.0)),
    "ema": ("ema_track", dict(rate_deg_per_chunk=24.0)),
    "two_sources": ("track_two_sources", dict(rate_deg_per_chunk=5.0, init_prior_sigma_deg=10.0)),
}


def _as_list(out):
    return [np.asarray(o) for o in (out if isinstance(out, tuple) else (out,))]


@pytest.mark.parametrize("fov", ["fixed", "panning"])
@pytest.mark.parametrize("pattern", list(PATTERNS))
@pytest.mark.parametrize("case", list(TRACKER_CASES))
def test_tracker_bearings_equal_jax(case, pattern, fov):
    name, kw = TRACKER_CASES[case]
    hists = PATTERNS[pattern]()
    C = hists.shape[0]
    center = 80.0 if fov == "fixed" else np.linspace(70.0, 100.0, C).astype(np.float32)
    jcenter = center if fov == "fixed" else jnp.asarray(center)
    tcenter = center if fov == "fixed" else torch.from_numpy(center)
    ref = getattr(jt, name)(jnp.asarray(ANGLES), jnp.asarray(hists), fov_center_deg=jcenter,
                            fov_width_deg=120.0, **kw)
    got = getattr(tracking, name)(torch.from_numpy(ANGLES), torch.from_numpy(hists),
                                  fov_center_deg=tcenter, fov_width_deg=120.0, **kw)
    ref, got = _as_list(ref), _as_list(got)
    if case == "two_sources" and pattern == "crossing":
        # The second track's MAP path ties there: test_second_track_through_a_crossing_ties.
        ref, got = ref[:1], got[:1]
    for r, g in zip(ref, got):
        assert g.shape == r.shape == (C,) and g.dtype == np.float32
        np.testing.assert_array_equal(g, r)


def _momentum_path_score(hists, path, trans_sigma_deg=3.0, rate_deg_per_chunk=5.0,
                         switch_penalty=12.0, floor=1e-6):
    """The best log-score, in float64, of an angle path (C,) through the
    momentum trellis with no gate and no prior: a max over direction labels."""
    p = np.maximum(hists, 0.0).astype(np.float64)
    emis = np.log(p / (p.sum(axis=-1, keepdims=True) + 1e-20) + floor)
    idx = np.searchsorted(ANGLES, path)
    dirs = np.array([-1.0, 0.0, 1.0])
    switch = -switch_penalty * np.abs(dirs[:, None] - dirs[None, :])
    best = np.full(3, emis[0, idx[0]])
    for c in range(1, len(path)):
        step = float(path[c]) - float(path[c - 1])
        step_cost = -0.5 * ((step - dirs * rate_deg_per_chunk) / trans_sigma_deg) ** 2
        best = np.max(best[:, None] + switch, axis=0) + step_cost + emis[c, idx[c]]
    return best.max()


@pytest.mark.parametrize("fov", ["fixed", "panning"])
def test_second_track_through_a_crossing_ties(fov):
    """On two noise-free crossing glides the second track (the momentum path
    on the spectra with the target's corridor removed) has two MAP paths of
    EQUAL score: the reference's and the port's differ, and which one wins
    is decided by one-ulp differences of the float32 emissions (XLA's row
    sum and log against torch's). Both score the same in float64, and the
    target tracks are equal."""
    kw = TRACKER_CASES["two_sources"][1]
    hists = _crossing()
    center = 80.0 if fov == "fixed" else np.linspace(70.0, 100.0, C_SYN).astype(np.float32)
    rt, ro = jt.track_two_sources(jnp.asarray(ANGLES), jnp.asarray(hists), fov_center_deg=center,
                                  fov_width_deg=120.0, **kw)
    gt, go = tracking.track_two_sources(torch.from_numpy(ANGLES), torch.from_numpy(hists),
                                        fov_center_deg=torch.as_tensor(center),
                                        fov_width_deg=120.0, **kw)
    np.testing.assert_array_equal(gt.numpy(), np.asarray(rt))
    keep = np.abs(ANGLES[None, :] - np.asarray(rt)[:, None]) > 10.0
    residual = np.where(keep, hists, 0.0)
    s_ref = _momentum_path_score(residual, np.asarray(ro))
    s_got = _momentum_path_score(residual, go.numpy())
    print(f"[parity] second track ref={np.asarray(ro).tolist()} port={go.tolist()} "
          f"scores {s_ref!r} {s_got!r}")
    assert abs(s_got - s_ref) <= 1e-9 * abs(s_ref)


def test_no_field_of_view_and_one_chunk():
    """No gate (every angle admissible) and a single chunk: nothing to
    smooth, the backtrack is the argmax."""
    hists = _distractor()
    for name, kw in TRACKER_CASES.values():
        for h in (hists, hists[:1]):
            ref = getattr(jt, name)(jnp.asarray(ANGLES), jnp.asarray(h), **kw)
            got = getattr(tracking, name)(torch.from_numpy(ANGLES), torch.from_numpy(h), **kw)
            for r, g in zip(_as_list(ref), _as_list(got)):
                np.testing.assert_array_equal(g, r)


def test_trellis_step_is_max_plus_in_float32():
    """The shared step against its definition in NumPy: the same bits."""
    rng = np.random.default_rng(3)
    score = rng.standard_normal(181).astype(np.float32)
    emis = rng.standard_normal(181).astype(np.float32)
    trans = tracking.transition(torch.from_numpy(ANGLES), 12.0)
    diff = ANGLES[:, None] - ANGLES[None, :]
    want = -0.5 * (diff / 12.0) ** 2
    np.testing.assert_array_equal(trans.numpy(), want)
    got, bp = tracking.viterbi_step(torch.from_numpy(score), trans, torch.from_numpy(emis))
    np.testing.assert_array_equal(got.numpy(), (score[:, None] + want).max(axis=0) + emis)
    np.testing.assert_array_equal(bp.numpy(), np.argmax(score[:, None] + want, axis=0))


@pytest.fixture(scope="module")
def moving_scene():
    n = 10 * 16000
    sigs = speech_like_batch(jax.random.PRNGKey(1), 3, n, 16000)
    B = traj_block_count(n, 2048)
    sc = make_moving_scene(sigs[0], sigs[1:], linear_trajectory(60.0, 120.0, B),
                           jnp.asarray([30.0, 150.0]), 0.04, 16000)
    return np.array(sc["mixture"])  # writable: torch.from_numpy shares it


def _check(tag, got, ref, bound=1e-4):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and got.size > 0
    rel = float(np.linalg.norm(got - ref) / np.linalg.norm(ref))
    print(f"[parity] {tag} wave_rel_l2={rel:.3e}")  # shown with pytest -s
    assert rel <= bound, f"{tag}: waveform relative L2 {rel:.3e}"


@pytest.mark.parametrize("fov", ["fixed", "panning"])
@pytest.mark.parametrize("tracker", TRACKERS)
def test_heuristic_tracked_matches_jax(moving_scene, tracker, fov):
    mix = moving_scene
    C = 9  # 10 s at 2 s / 50 %
    center = 90.0 if fov == "fixed" else np.linspace(70.0, 110.0, C).astype(np.float32)
    kw = dict(fov_width_deg=90.0, tracker=tracker)
    ref, theta_ref = jax_tracked(jnp.asarray(mix), JaxConfig(mic_dist=0.04),
                                 fov_center_deg=center if fov == "fixed" else jnp.asarray(center),
                                 **kw)
    got, theta = tracked_autosteer_enhance(
        torch.from_numpy(mix), PipelineConfig(mic_dist=0.04),
        fov_center_deg=center if fov == "fixed" else torch.from_numpy(center), **kw)
    assert theta.shape == (C,) and theta.device.type == "cpu"
    np.testing.assert_array_equal(theta.numpy(), np.asarray(theta_ref))
    print(f"[parity] tracked {tracker} {fov} bearings={theta.tolist()}")
    _check(f"tracked heuristic {tracker} {fov}", got.numpy(), ref)


def test_tracked_causal_knobs_match_jax(moving_scene):
    """Fixed-lag smoothing and an explicit aiming prior through the
    pipeline, on the first 6 s (5 chunks)."""
    mix = moving_scene[:, :6 * 16000]
    kw = dict(fov_center_deg=80.0, fov_width_deg=120.0, tracker="causal", track_lag=2,
              init_prior_sigma_deg=30.0, trans_sigma_deg=10.0)
    ref, theta_ref = jax_tracked(jnp.asarray(mix), JaxConfig(mic_dist=0.04), **kw)
    got, theta = tracked_autosteer_enhance(torch.from_numpy(mix), PipelineConfig(mic_dist=0.04),
                                           **kw)
    np.testing.assert_array_equal(theta.numpy(), np.asarray(theta_ref))
    _check("tracked causal lag 2", got.numpy(), ref)


def test_tracked_arguments_are_checked(moving_scene):
    mix = torch.from_numpy(moving_scene[:, :6 * 16000])  # 5 chunks
    cfg = PipelineConfig(mic_dist=0.04)
    with pytest.raises(ValueError, match="one centre per chunk"):
        tracked_autosteer_enhance(mix, cfg, fov_center_deg=torch.full((4,), 90.0))
    with pytest.raises(ValueError, match="one centre per chunk"):
        tracked_autosteer_enhance(mix, cfg, fov_center_deg=np.full((5, 1), 90.0))
    with pytest.raises(ValueError, match="unknown tracker"):
        tracked_autosteer_enhance(mix, cfg, tracker="kalman")
    with pytest.raises(ValueError, match="one"):
        tracked_autosteer_enhance(mix[None], cfg)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tracked_autosteer_enhance(moving_scene, cfg)
    out, theta = tracked_autosteer_enhance(moving_scene[:, :6 * 16000], cfg, device="cpu")
    assert out.shape == (6 * 16000,) and theta.shape == (5,)


@pytest.mark.parametrize("tracker", ["causal", "momentum"])
def test_audiozoom_tracked_enhance_matches_jax(moving_scene, tracker):
    """AudioZoom(track=True).enhance of a clip longer than a window: the
    offline track ('viterbi' for the causal tracker, 'momentum'), no model."""
    mix = moving_scene[:, :8 * 16000]
    kw = dict(direction_deg=85.0, fov_deg=90.0, zoom=0.4, track=True, tracker=tracker)
    ref = azoom.AudioZoom(native=False, **kw).enhance(mix)
    got = AudioZoom(device="cpu", **kw).enhance(mix)
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    _check(f"AudioZoom tracked enhance {tracker}", got, ref)
