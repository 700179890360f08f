"""Arrays of three and four mics on the batch paths, on the CPU against
azoom: learned_enhance (MVDR, hard-null with 2 and 3 nulls, the FOV gate,
explicit rectangular and L-shaped geometries), oracle_enhance,
heuristic_enhance, autosteer_enhance and tracked_autosteer_enhance. The
streaming paths (the chunker, the online MVDR, the causal pipeline and its
stream, AudioZoom) are in tests/test_torch_mmic_live.py, AudioZoomServer in
tests/test_torch_mmic_server.py, the stages in tests/test_torch_linalgmm.py.

Scenes: the reference's M-mic scene (tests/test_mmic.py::_three_interferer_scene:
a 150 Hz target at 90 deg, interferers at 30, 135 and 60 deg, a linear
array of 3 or 4 mics at 4 cm, azoom's simulator), the 4-mic rectangle of
tests/test_stream_server.py and a 3-mic L (target at 90 deg, one
interferer at 40). The learned paths run the bundled float fpu, the net the
reference's M-mic facade test serves.

Bounds, those of each path's 2-mic counterpart (ROADMAP Queue C): waveform
relative L2 <= 2e-2 and SIR within 0.05 dB on the learned paths (64-frame
windows); <= 1e-3 where no conv net runs (oracle, heuristic, autosteer,
tracked). Measured at M = 4 (``-s`` prints each, M = 3 beside them):
learned MVDR 2.9e-5, hard-null 2.7e-6 (3 nulls) and 3.1e-6 (2 nulls, FOV
gate), the rectangle with the FOV gate 6.3e-5 (the 3-mic L 5.1e-5);
oracle 5.2e-5 (binary) and 9.6e-5 (no post-filter), heuristic 6.9e-5,
autosteer 5.6e-5 (the same bearing), tracked 6.8e-5 (the same bearings);
every SIR within 0.002 dB.

Every reference run is shared in a module-scoped fixture; the hard-null
cases compile the reference's unrolled Jacobi EVD and 20 loaded solves
(~11 s each on one core), so they run once each, on one 2 s window.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from azoom.config import PipelineConfig as JaxConfig
from azoom.eval.projection import osinr_osir
from azoom.models.pretrained import load_bundled as jax_load_bundled
from azoom.pipelines.autosteer import autosteer_enhance as jax_autosteer
from azoom.pipelines.learned import learned_enhance as jax_learned
from azoom.pipelines.oracle import heuristic_enhance as jax_heuristic
from azoom.pipelines.oracle import oracle_enhance as jax_oracle
from azoom.pipelines.tracked import tracked_autosteer_enhance as jax_tracked
from azoom.sim.farfield import make_scene
from azoom.sim.signals import speech_like, speech_like_batch
from azoom_torch import (
    autosteer_enhance, heuristic_enhance, kernels, learned_enhance, load_bundled, oracle_enhance,
)
from azoom_torch.config import PipelineConfig
from azoom_torch.pipelines.tracked import tracked_autosteer_enhance

LEARNED_BOUND = 2e-2  # 64-frame windows through a conv net (ROADMAP Queue C)
PLAIN_BOUND = 1e-3    # no conv net, or the causal CRN
RECT = ((-0.015, -0.01), (0.015, -0.01), (-0.015, 0.01), (0.015, 0.01))
ELL = ((-0.02, 0.0), (0.02, 0.0), (0.02, 0.03))  # a 3-mic L, non-uniform


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU work in one thread while this file runs (the suite's
    other workers share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.cache
def three_interferer_scene(n_mics, n):
    """The reference's M-mic scene (tests/test_mmic.py), as numpy."""
    keys = jax.random.split(jax.random.PRNGKey(11), 4)
    target = speech_like(keys[0], n, 16_000, 150.0)
    interferers = jnp.stack([speech_like(keys[1], n, 16_000, 220.0),
                             speech_like(keys[2], n, 16_000, 120.0),
                             speech_like(keys[3], n, 16_000, 260.0)])
    sc = make_scene(target, interferers, 90.0, jnp.asarray([30.0, 135.0, 60.0]), 0.04,
                    16_000.0, n_mics=n_mics)
    return {k: np.array(v) for k, v in sc.items()}


def geometry_scene(positions, n, seed=20):
    """A target at 90 deg and one interferer at 40 on explicit mic positions."""
    sigs = speech_like_batch(jax.random.PRNGKey(seed), 2, n, 16_000)
    sc = make_scene(sigs[0], sigs[1:], 90.0, jnp.asarray([40.0]), 0.0, 16_000,
                    n_mics=len(positions), positions=jnp.asarray(positions, jnp.float32))
    return {k: np.array(v) for k, v in sc.items()}


def scene(n_mics, n=32_000):
    """The M-mic scene's first n samples (of a 3 s clip)."""
    return {k: v[..., :n] for k, v in three_interferer_scene(n_mics, 48_000).items()}


def configs(n_mics, **kw):
    """The same configuration in both packages: (JAX's, the port's)."""
    return (JaxConfig(mic_dist=0.04, n_mics=n_mics, **kw),
            PipelineConfig(mic_dist=0.04, n_mics=n_mics, **kw))


@pytest.fixture(scope="module")
def fpu():
    jm, jv, _ = jax_load_bundled("fpu", quant=False)
    tm, kind = load_bundled("fpu", quant=False, device="cpu")
    assert kind == "logmag_ipd"
    return jm, jv, tm


def _check(tag, got, ref, tgt, itf, bound):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and np.all(np.isfinite(got))
    rel = float(np.linalg.norm(got - ref) / np.linalg.norm(ref))
    m = got.shape[-1]
    sir_got = float(osinr_osir(jnp.asarray(got), tgt[..., :m], itf[..., :m])[1])
    sir_ref = float(osinr_osir(jnp.asarray(ref), tgt[..., :m], itf[..., :m])[1])
    print(f"[mmic] {tag} wave_rel_l2={rel:.3e} sir_jax={sir_ref:.3f} "
          f"dsir_db={sir_got - sir_ref:+.4f}")  # shown with pytest -s
    assert rel <= bound, f"{tag}: waveform relative L2 {rel:.3e}"
    assert abs(sir_got - sir_ref) <= 0.05


# name: (learned_enhance keywords, mics, explicit geometry); the mixture is 2 s
LEARNED = {
    "mvdr": (dict(), 4, None),
    "hard_null_3": (dict(beamformer="hard_null", n_nulls=3), 4, None),
    "hard_null_2_fov30": (dict(beamformer="hard_null", n_nulls=2, fov_deg=30.0,
                               steer_deg=85.0), 4, None),
    "mvdr_rect_fov30": (dict(fov_deg=30.0, steer_deg=80.0), 4, RECT),
    "mvdr_ell_fov30": (dict(fov_deg=30.0, steer_deg=95.0), 3, ELL),
}


def _learned_case(name):
    """(scene, JAX config, port config) of a LEARNED case."""
    _, M, geom = LEARNED[name]
    if geom is None:
        return (scene(M),) + configs(M)
    return (geometry_scene(geom, 32_000), JaxConfig(mic_dist=0.04).with_geometry(geom),
            PipelineConfig(mic_dist=0.04).with_geometry(geom))


@pytest.fixture(scope="module")
def learned_reference(fpu):
    jm, jv, _ = fpu
    out = {}
    for name, (kw, _, _) in LEARNED.items():
        sc, jcfg, _ = _learned_case(name)
        out[name] = np.asarray(jax_learned(jnp.asarray(sc["mixture"]), jm, jv, jcfg,
                                           feature_kind="logmag_ipd", **kw))
    return out


@pytest.mark.parametrize("case", list(LEARNED))
def test_learned_enhance_at_more_mics_matches_jax(fpu, learned_reference, case):
    kw = LEARNED[case][0]
    sc, _, cfg = _learned_case(case)
    before = dict(kernels.launches)
    got = learned_enhance(torch.from_numpy(sc["mixture"]), fpu[2], cfg,
                          feature_kind="logmag_ipd", **kw).numpy()
    assert kernels.launches == before  # the CPU runs no kernel
    _check(f"learned {case}", got, learned_reference[case], sc["target_ref"],
           sc["interference_ref"], LEARNED_BOUND)


@pytest.mark.parametrize("M,post_filter", [(4, "binary"), (4, "none"), (3, "binary")])
def test_oracle_enhance_matches_jax(M, post_filter):
    sc, (jcfg, cfg) = scene(M), configs(M)
    args = (sc["mixture"], sc["target_ref"], sc["interference_ref"])
    ref = jax_oracle(*(jnp.asarray(a) for a in args), jcfg, post_filter=post_filter)
    got = oracle_enhance(*args, cfg, post_filter=post_filter, device="cpu")
    _check(f"oracle {post_filter} M={M}", got.numpy(), ref, sc["target_ref"],
           sc["interference_ref"], PLAIN_BOUND)


@pytest.mark.parametrize("M", [3, 4])
def test_heuristic_and_autosteer_match_jax(M):
    sc, (jcfg, cfg) = scene(M), configs(M)
    ref = jax_heuristic(jnp.asarray(sc["mixture"]), jcfg)
    got = heuristic_enhance(sc["mixture"], cfg, device="cpu").numpy()
    _check(f"heuristic M={M}", got, ref, sc["target_ref"], sc["interference_ref"], PLAIN_BOUND)
    ref, theta_ref = jax_autosteer(jnp.asarray(sc["mixture"]), jcfg, fov_center_deg=95.0,
                                   fov_width_deg=40.0)
    got, theta = autosteer_enhance(sc["mixture"], cfg, fov_center_deg=95.0, fov_width_deg=40.0,
                                   device="cpu")
    assert float(theta) == float(theta_ref) and 75.0 <= float(theta) <= 115.0
    _check(f"autosteer M={M}", got.numpy(), ref, sc["target_ref"], sc["interference_ref"],
           PLAIN_BOUND)


@pytest.mark.parametrize("M", [3, 4])
def test_tracked_autosteer_matches_jax(M):
    kw = dict(fov_center_deg=90.0, fov_width_deg=60.0, tracker="momentum")
    sc, (jcfg, cfg) = scene(M, 48_000), configs(M, win_size=16_000)
    ref, theta_ref = jax_tracked(jnp.asarray(sc["mixture"]), jcfg, **kw)
    got, theta = tracked_autosteer_enhance(sc["mixture"], cfg, device="cpu", **kw)
    np.testing.assert_array_equal(theta.numpy(), np.asarray(theta_ref))  # bearing per chunk
    _check(f"tracked M={M}", got.numpy(), ref, sc["target_ref"], sc["interference_ref"],
           PLAIN_BOUND)
