"""The port's far-field and moving-source scenes (azoom_torch.sim.{farfield,
motion}) on the CPU against azoom.sim.farfield and azoom.sim.motion.

Bounds (ROADMAP.md Queue C, "Scene simulation"):
- far-field mixtures and scenes, static or moving, within 1e-5 relative L2
  (measured ~3e-7: float32 rFFT phase ramps, the delays rounded from
  float64 in the port and computed in float32 in the reference);
- the moving renderer's overlap-add bit for bit, given the reference's own
  delayed windows: every sample lies under two windows, and the reference's
  scan adds the second to the first on zero;
- a moving room scene rendered from the reference's draws within 1e-3
  (measured 2.4e-5 at order 3; the port adds the windows' RIR tails in a
  loop over anchors, in the scan's order);
- the reference's own properties: a constant trajectory reproduces the
  static mixer within 5e-3 and the stems add up to the mixture within 1e-5
  (tests/test_tracking.py:35-70).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from azoom.config import RoomConfig as JaxRoom
from azoom.dsp.delays import far_field_delays as jax_delays
from azoom.dsp.delays import fractional_delay as jax_fractional_delay
from azoom.sim import farfield as JF
from azoom.sim import motion as JM
from azoom.sim.signals import speech_like_batch as jax_speech_like_batch
from azoom_torch.config import RoomConfig
from azoom_torch.sim import farfield as TF
from azoom_torch.sim import motion as TM
from azoom_torch.sim.signals import speech_like_batch

FS = 16_000
BLOCK = 2_048
BOUND = 1e-5
RECT = np.array([[-0.015, -0.01], [0.015, -0.01], [-0.015, 0.01], [0.015, 0.01]], np.float32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU work in one thread while this file runs (the suite's
    other workers share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


@pytest.fixture(scope="module")
def sources():
    return (0.1 * np.random.default_rng(2).standard_normal((3, 20_000))).astype(np.float32)


@pytest.mark.parametrize("geometry", ["linear", "rectangle"])
def test_mix_far_field_batched(sources, geometry):
    src = np.stack([sources, sources[::-1]])  # (2, 3, n): a batch of two scenes
    angles = np.array([[90.0, 40.0, 130.0], [60.0, 20.0, 150.0]], np.float32)
    kw = (dict(n_mics=4, positions=RECT) if geometry == "rectangle" else {})
    got = TF.mix_far_field(src, angles, 0.04, FS, device="cpu", **kw)
    ref = JF.mix_far_field(jnp.asarray(src), jnp.asarray(angles), 0.04, FS, **kw)
    assert got.shape == ref.shape == (2, 4 if kw else 2, src.shape[-1])
    assert _rel(got, ref) <= BOUND


@pytest.mark.parametrize("positions", [None, RECT])
def test_make_scene_batched(sources, positions):
    tgt = np.stack([sources[0], sources[1]])
    itf = np.stack([sources[1:], sources[[2, 0]]])
    n_mics = 2 if positions is None else 4
    got = TF.make_scene(tgt, itf, 75.0, [20.0, 120.0], 0.04, FS, n_mics=n_mics,
                        positions=positions, device="cpu")
    ref = JF.make_scene(jnp.asarray(tgt), jnp.asarray(itf), 75.0, jnp.asarray([20.0, 120.0]),
                        0.04, FS, n_mics=n_mics, positions=positions)
    for k, v in ref.items():
        assert got[k].shape == v.shape, k
        assert _rel(got[k], v) <= BOUND, k
    raw = TF.make_scene(tgt[0], itf[0], 75.0, [20.0, 120.0], 0.04, FS, normalize=False,
                        device="cpu")
    np.testing.assert_allclose(raw["mixture"][0].numpy(),
                               (raw["target_ref"] + raw["interference_ref"]).numpy(), atol=1e-6)


def _trajectories(B):
    return np.stack([np.linspace(40, 140, B), np.full(B, 30.0),
                     np.linspace(150, 100, B)]).astype(np.float32)


def test_overlap_add_equals_the_references_scan_bit_for_bit(sources):
    n = sources.shape[-1]
    B = JM.traj_block_count(n, BLOCK)
    traj = _trajectories(B)
    ref = np.asarray(JM._moving_images(jnp.asarray(sources), jnp.asarray(traj), 0.04, 343.0, 2,
                                       float(FS), BLOCK))
    # the reference's delayed windows, as _moving_images makes them
    seg = 2 * BLOCK
    w = 0.5 - 0.5 * jnp.cos(2.0 * jnp.pi * jnp.arange(seg, dtype=jnp.float32) / seg)
    xp = jnp.pad(jnp.asarray(sources), ((0, 0), (BLOCK, (B + 2) * BLOCK - n - BLOCK)))
    segs = jnp.stack([xp[:, s:s + seg] for s in range(0, (B + 1) * BLOCK, BLOCK)]) * w
    tr = jnp.asarray(traj)
    tau = jax_delays(jnp.concatenate([tr[:, :1], tr], axis=1).T, 0.04, 343.0, 2)
    delayed = np.array(jax_fractional_delay(segs[:, :, None, :], tau, float(FS)))
    got = TM._overlap_add(torch.from_numpy(delayed), BLOCK, n)
    np.testing.assert_array_equal(got.numpy(), ref)
    port = TM._moving_images(torch.from_numpy(sources), traj, 0.04, 343.0, 2, float(FS), BLOCK)
    print(f"[motion] images: rel L2 {_rel(port, ref):.2e}")
    assert _rel(port, ref) <= BOUND


def test_moving_scene_matches_the_reference(sources):
    n = sources.shape[-1]
    B = TM.traj_block_count(n, BLOCK)
    traj = TM.linear_trajectory(60.0, 120.0, B, device="cpu")
    np.testing.assert_allclose(traj.numpy(), np.asarray(JM.linear_trajectory(60.0, 120.0, B)),
                               rtol=0, atol=1e-4)
    for itf_angles in (np.array([30.0, 150.0], np.float32), _trajectories(B)[1:]):
        got = TM.make_moving_scene(sources[0], sources[1:], traj, itf_angles, 0.04, FS,
                                   device="cpu")
        ref = JM.make_moving_scene(jnp.asarray(sources[0]), jnp.asarray(sources[1:]),
                                   jnp.asarray(traj.numpy()), jnp.asarray(itf_angles), 0.04,
                                   float(FS))
        for k, v in ref.items():
            assert got[k].shape == v.shape and _rel(got[k], v) <= BOUND, k
    mixed = TM.mix_far_field_moving(sources, _trajectories(B), 0.04, FS, device="cpu")
    assert _rel(mixed, JM.mix_far_field_moving(jnp.asarray(sources),
                                               jnp.asarray(_trajectories(B)), 0.04,
                                               float(FS))) <= BOUND


def test_the_references_motion_properties():
    """A constant trajectory reproduces the static mixer up to the circular
    wrap of each window's delay, which depends on the signal: on the
    reference test's own sources (its key 0) within its 5e-3; on the port's
    seeds the port's distance equals the reference's on the same sources."""
    n = FS
    B = TM.traj_block_count(n, BLOCK)
    traj = np.stack([np.full(B, 60.0), np.full(B, 130.0)]).astype(np.float32)

    def distances(sigs):
        port = _rel(TM.mix_far_field_moving(sigs, traj, 0.08, FS, device="cpu"),
                    TF.mix_far_field(sigs, [60.0, 130.0], 0.08, FS, device="cpu"))
        ref = _rel(JM.mix_far_field_moving(jnp.asarray(sigs), jnp.asarray(traj), 0.08, float(FS)),
                   JF.mix_far_field(jnp.asarray(sigs), jnp.asarray([60.0, 130.0]), 0.08,
                                    float(FS)))
        return port, ref

    port, ref = distances(np.array(jax_speech_like_batch(jax.random.PRNGKey(0), 2, n, FS)))
    print(f"[motion] constant trajectory vs static mixer, the reference's sources: "
          f"port {port:.2e}, reference {ref:.2e}")
    assert port < 5e-3
    for seed in range(4):
        sigs = speech_like_batch(torch.Generator().manual_seed(seed), 2, n, FS,
                                 device="cpu").numpy()
        port, ref = distances(sigs)
        print(f"[motion] the same on the port's seed {seed}: port {port:.2e}, "
              f"reference {ref:.2e}")
        assert abs(port - ref) <= 1e-6
    sigs = speech_like_batch(torch.Generator().manual_seed(0), 3, n, FS, device="cpu")
    sc = TM.make_moving_scene(sigs[0], sigs[1:], TM.linear_trajectory(60.0, 120.0, B,
                                                                     device="cpu"),
                              [30.0, 150.0], 0.08, FS)
    resid = sc["mixture"][0] - sc["target_ref"] - sc["interference_ref"]
    assert float(resid.norm() / sc["mixture"][0].norm()) < 1e-5


@pytest.fixture(scope="module")
def room_case(sources):
    n = FS
    B = TM.traj_block_count(n, BLOCK)
    traj = np.linspace(60.0, 120.0, B).astype(np.float32)
    key = jax.random.PRNGKey(9)
    ref = JM.make_moving_room_scene(key, jnp.asarray(sources[0, :n]),
                                    jnp.asarray(sources[1:, :n]), jnp.asarray(traj),
                                    JaxRoom(), max_order=3)
    k_pos, k_noise = jax.random.split(key)
    pos_u = torch.from_numpy(np.array(jax.random.uniform(k_pos, (1, 2))))
    noise = torch.from_numpy(np.stack([np.array(jax.random.normal(k, (n,)))
                                       for k in jax.random.split(k_noise, 2)]))
    return traj, {k: np.asarray(v) for k, v in ref.items()}, pos_u, noise


def test_moving_room_scene_matches_the_reference_on_its_draws(sources, room_case):
    traj, ref, pos_u, noise = room_case
    n = FS
    got = TM._moving_room_scene(pos_u, noise, torch.from_numpy(sources[0, :n]),
                                torch.from_numpy(sources[1:, :n]), traj, RoomConfig(), FS,
                                BLOCK, 1.0, 50.0, 3, True)
    assert set(got) == set(ref)
    for k, v in ref.items():
        rel = _rel(got[k], v)
        print(f"[motion] moving room {k}: rel L2 {rel:.2e}")
        assert got[k].shape == v.shape and rel <= 1e-3, k


def test_moving_room_scene_from_a_generator(sources, room_case):
    traj = room_case[0]
    n = FS

    def scene(seed, **kw):
        return TM.make_moving_room_scene(torch.Generator().manual_seed(seed), sources[0, :n],
                                         sources[1:, :n], traj, RoomConfig(), max_order=2,
                                         device="cpu", **kw)

    a, b, c = scene(0), scene(0), scene(1)
    for k in a:
        assert a[k].shape == (2, n) if k == "mixture" else (n,)
        assert torch.equal(a[k], b[k]), k
    assert not torch.equal(a["mixture"], c["mixture"])
    assert float(a["mixture"].abs().max()) <= 1.0 + 1e-6
    dry = scene(0, reverb=False)
    assert bool(torch.isfinite(dry["mixture"]).all())
