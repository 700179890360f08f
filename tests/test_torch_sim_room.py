"""The port's shoebox rooms and room scenes (azoom_torch.sim.{room,scene,
native}) on the CPU against azoom.sim.room and azoom.sim.scene.

Bounds (ROADMAP.md Queue C, "Scene simulation"), the reference's own for
its C++ engine against its ISM (tests/test_native_rir.py:19-39):
- RIRs: atol 1e-5 anechoic, atol 1e-4 with rtol 1e-3 reverberant. The taps
  are float32 in the reference's order and the scatter-add adds in index
  order as XLA's does; measured max |diff| 7.3e-7 against a 0.067 peak at
  orders 3 to 15 (a few hundred taps differ by ulps of sin, pow and cos).
- scenes rendered from the reference's own draws (interferer positions,
  sensor noise) within 1e-3 relative L2 (measured ~1.7e-5 at order 3).
- the C++ engine (double precision, per-thread partial sums) against the
  port's float32 ISM at the RIR bounds above, at orders <= 5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from azoom.config import RoomConfig as JaxRoom
from azoom.sim import room as JR
from azoom.sim import scene as JS
from azoom_torch.config import PipelineConfig, RoomConfig
from azoom_torch.eval.projection import osinr_osir
from azoom_torch.pipelines.oracle import oracle_enhance
from azoom_torch.sim import native
from azoom_torch.sim import room as TR
from azoom_torch.sim import scene as TS

FS = 16_000
ROOM = (4.9, 4.9, 4.9)
SOURCES = np.array([[2.45, 3.45, 1.5], [3.22, 3.06, 1.5], [1.3, 4.1, 1.5]])
MICS = np.array([[2.41, 2.45, 1.5], [2.49, 2.45, 1.5]])
SCENE_BOUND = 1e-3


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


def _bounds(order):
    return dict(atol=1e-5, rtol=0) if order == 0 else dict(atol=1e-4, rtol=1e-3)


def _absorption(order):
    return 1.0 if order == 0 else TR.inverse_sabine(0.5, ROOM)


def test_inverse_sabine_and_the_image_lattice():
    assert TR.inverse_sabine(0.5, ROOM) == JR.inverse_sabine(0.5, ROOM)
    assert TR.inverse_sabine(0.01, ROOM) == 0.9999
    for order, images in ((0, 1), (3, 63), (5, 231), (15, 4_991)):
        got, ref = TR._image_lattice(order), JR._image_lattice(order)
        assert got[0].shape == (images, 3)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("order", [0, 3, 5])
def test_shoebox_rir_matches_the_reference(order):
    a = _absorption(order)
    got = TR.shoebox_rir(SOURCES[0], MICS[0], ROOM, a, order, FS, device="cpu")
    ref = np.asarray(JR.shoebox_rir(SOURCES[0], MICS[0], ROOM, a, order, FS))
    print(f"[room] shoebox_rir order {order}: {ref.shape[0]} taps, max |diff| "
          f"{np.abs(got.numpy() - ref).max():.2e} of peak {np.abs(ref).max():.3f}")
    assert got.shape == ref.shape and got.dtype == torch.float32  # the default length
    np.testing.assert_allclose(got.numpy(), ref, **_bounds(order))


@pytest.mark.parametrize("order", [0, 3, 5])
def test_rir_matrix_matches_the_reference(order):
    a = _absorption(order)
    got = TR.rir_matrix(torch.from_numpy(SOURCES), MICS, ROOM, a, order, FS, 6_000)
    ref = np.asarray(JR.rir_matrix(SOURCES, MICS, ROOM, a, order, FS, 6_000))
    assert got.shape == ref.shape == (3, 2, 6_000)
    np.testing.assert_allclose(got.numpy(), ref, **_bounds(order))
    # one pair at a time gives the batched pass's bits
    np.testing.assert_array_equal(
        TR.shoebox_rir(SOURCES[2], MICS[1], ROOM, a, order, FS, 6_000, device="cpu").numpy(),
        got[2, 1].numpy())


def test_rirs_on_the_cpu_do_not_depend_on_its_threads():
    """The scatter-add of every image's taps sums each sample in the
    original order on the CPU (``index_add_``; its ``index_put_`` adds from
    several threads in any order): at order 15 the RIRs are the same bits
    in one thread and in eight, run after run."""
    a = _absorption(15)
    n = torch.get_num_threads()
    try:
        runs = []
        for threads in (1, 8, 8, 8):
            torch.set_num_threads(threads)
            runs.append(TR.rir_matrix(torch.from_numpy(SOURCES), MICS, ROOM, a, 15, FS))
    finally:
        torch.set_num_threads(n)
    assert all(torch.equal(runs[0], r) for r in runs[1:])


@pytest.mark.parametrize("order", [0, 3, 5])
def test_the_cxx_engine_matches_the_ports_ism(order):
    a = _absorption(order)
    ism = TR.rir_matrix(SOURCES[:2], MICS, ROOM, a, order, FS, 4_000, device="cpu").numpy()
    cxx = native.rir_matrix_native(SOURCES[:2], MICS, ROOM, a, order, FS, 4_000)
    assert cxx.shape == ism.shape == (2, 2, 4_000) and cxx.dtype == np.float32
    np.testing.assert_allclose(cxx, ism, **_bounds(order))
    one = native.shoebox_rir_native(SOURCES[1], MICS[0], ROOM, a, order, FS, 4_000)
    np.testing.assert_allclose(one, ism[1, 0], **_bounds(order))


def test_a_failed_rir_engine_build_raises_with_the_compilers_output(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("CXX", "false")  # a compiler that fails
    with pytest.raises(RuntimeError, match=r"building the RIR engine failed \(rc 1\)"):
        native.rir_matrix_native(SOURCES, MICS, ROOM, 0.3, 1, FS, 100)
    assert list(tmp_path.iterdir()) == []  # no half-written library left
    assert not native.native_available()
    with pytest.raises(RuntimeError, match="RIR engine"):
        native.shoebox_rir_native(SOURCES[0], MICS[0], ROOM, 0.3, 1, FS, 100)


def test_the_rir_engine_builds_without_openmp_where_the_compiler_has_none(monkeypatch,
                                                                          tmp_path):
    """A toolchain without OpenMP's runtime refuses -fopenmp: the engine is
    then built without it (the same loop on one thread) and still matches."""
    cxx = tmp_path / "cxx-without-openmp"
    cxx.write_text('#!/bin/sh\nfor a in "$@"; do [ "$a" = -fopenmp ] && exit 1; done\n'
                   'exec g++ "$@"\n')
    cxx.chmod(0o755)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("CXX", str(cxx))
    assert "-fopenmp" in native.CXX_FLAGS and "-fopenmp" not in native.build_flags()
    a = _absorption(3)
    ism = TR.rir_matrix(SOURCES[:1], MICS, ROOM, a, 3, FS, 3_000, device="cpu").numpy()
    np.testing.assert_allclose(native.rir_matrix_native(SOURCES[:1], MICS, ROOM, a, 3, FS, 3_000),
                               ism, **_bounds(3))
    assert [p.name[:4] for p in (tmp_path / "build").iterdir()] == ["libr"]


def test_fft_convolve_and_apply_sir_gain():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 1, 500)).astype(np.float32)
    h = rng.standard_normal((3, 64)).astype(np.float32)
    got = TR.fft_convolve(x, h, 500, device="cpu")
    assert got.shape == (2, 3, 500)
    np.testing.assert_allclose(got.numpy(), np.asarray(JR.fft_convolve(x, h, 500)), atol=1e-5)
    np.testing.assert_allclose(got[1, 2].numpy(), np.convolve(x[1, 0], h[2])[:500], atol=1e-4)
    tgt = rng.standard_normal(4_000).astype(np.float32)
    interf = (3.0 * rng.standard_normal((2, 4_000))).astype(np.float32)
    for sir in (0.0, 10.0):
        scaled = TS.apply_sir_gain(tgt, interf, sir, device="cpu")
        ref = np.asarray(JS.apply_sir_gain(jnp.asarray(tgt), jnp.asarray(interf), sir))
        np.testing.assert_allclose(scaled.numpy(), ref, rtol=1e-6, atol=0)
        got_sir = 10 * np.log10(np.mean(tgt**2) / float(torch.mean(scaled[0] ** 2)))
        assert abs(got_sir - sir) < 0.1


@pytest.mark.parametrize("n", [4_096, 32_000])
def test_row_power_has_the_same_bits_at_any_batch(n):
    """sim.scene's power of a row (the SIR gain's and the AWGN's) sums
    pairwise in a fixed order: a row alone, in a batch of 2 and in a batch
    of 5 gives the same bits, within float32 rounding of the float64 mean
    square, at a power-of-two length and at another."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((5, 2, n)).astype(np.float32))
    whole = TS._row_power(x)
    assert whole.shape == (5, 2)
    assert torch.equal(TS._row_power(x[:2]), whole[:2])
    assert torch.equal(TS._row_power(x[3, 1]), whole[3, 1])
    ref = (x.double() ** 2).mean(-1)
    assert float(((whole.double() - ref) / ref).abs().max()) <= 1e-6


@pytest.mark.parametrize("n_interferers,reverb", [(3, True), (1, False), (0, True)])
def test_room_scene_matches_the_reference_on_its_draws(n_interferers, reverb):
    rng = np.random.default_rng(n_interferers)
    n = FS
    sig = (0.1 * rng.standard_normal((1 + n_interferers, n))).astype(np.float32)
    key = jax.random.PRNGKey(5)
    ref = JS.simulate_room_scene(key, jnp.asarray(sig[0]), jnp.asarray(sig[1:]), JaxRoom(),
                                 reverb=reverb, max_order=3)
    k_pos, k_noise0, k_noise1 = jax.random.split(key, 3)
    pos_u = (torch.from_numpy(np.array(jax.random.uniform(k_pos, (n_interferers - 1, 2))))
             if n_interferers >= 2 else None)
    noise = torch.from_numpy(np.stack([np.array(jax.random.normal(k, (n,)))
                                       for k in (k_noise0, k_noise1)]))
    got = TS._room_scene(pos_u, noise, torch.from_numpy(sig[0]), torch.from_numpy(sig[1:]),
                         RoomConfig(), reverb, 50.0, FS, 3)
    assert set(got) == set(ref)
    for k, v in ref.items():
        v = np.asarray(v)
        assert got[k].shape == v.shape, k
        if np.linalg.norm(v) > 0:
            rel = _rel(got[k], v)
            print(f"[room] scene K={n_interferers} reverb={reverb} {k}: rel L2 {rel:.2e}")
            assert rel <= SCENE_BOUND, k
        else:
            assert float(got[k].abs().max()) == 0.0, k


@pytest.mark.parametrize("kind", ["speech", "music", "mixed"])
def test_generate_scene_from_a_generator(kind):
    spec = TS.SceneSpec(reverb=True, n_interferers=2, duration_s=0.5, interferer_kind=kind)

    def scene(seed):
        return TS.generate_scene(torch.Generator().manual_seed(seed), spec, max_order=2,
                                 device="cpu")

    a, b, c = scene(0), scene(0), scene(1)
    n = FS // 2
    assert a["mixture"].shape == (2, n) and a["target_ref"].shape == (n,)
    assert a["rirs"].shape == (3, 2, int(0.6 * FS) if n > 0.6 * FS else n)
    assert float(a["mixture"].abs().max()) <= 1.0 + 1e-6
    assert bool(torch.isfinite(a["mixture"]).all()) and float(a["interference_ref"].std()) > 0
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert not torch.equal(a["mixture"], c["mixture"])
    # given sources, the scene follows them and the room's mic count
    src = a["target_stereo"][:, :4_000].contiguous()
    four = TS.generate_scene(torch.Generator().manual_seed(0), spec,
                             RoomConfig().with_linear_array(4, 0.04), source_signals=src,
                             max_order=1)
    assert four["mixture"].shape == (4, 4_000) and four["rirs"].shape == (2, 4, 4_000)


def test_reverb_oracle_pipeline_improves():
    """tests/test_room.py:83-97 on the port's own scene: the oracle IBM MVDR
    gains more than 8 dB of SIR in a reverberant room."""
    spec = TS.SceneSpec(reverb=True, n_interferers=1, duration_s=2.0, snr_db=50.0)
    sc = TS.generate_scene(torch.Generator().manual_seed(4), spec, max_order=4, device="cpu")
    cfg = PipelineConfig(mic_dist=0.08, sigma=1e-6)
    out = oracle_enhance(sc["mixture"], sc["target_ref"], sc["interference_ref"], cfg,
                         post_filter="irm")
    _, sir = osinr_osir(out, sc["target_ref"], sc["interference_ref"])
    _, sir_in = osinr_osir(sc["mixture"][0], sc["target_ref"], sc["interference_ref"])
    print(f"[room] oracle on a port scene: SIR {float(sir_in):.2f} -> {float(sir):.2f} dB")
    assert float(sir) - float(sir_in) > 8.0


def test_room_config_matches_the_reference():
    for method, args in (("with_mic_dist", (0.04,)), ("with_linear_array", (4, 0.03)),
                         ("with_array_positions", (((-0.02, 0.01), 0.0, (0.02, -0.01, 0.1)),))):
        got = getattr(RoomConfig(), method)(*args)
        ref = getattr(JaxRoom(), method)(*args)
        assert got.mic_locs == ref.mic_locs
    assert hash(RoomConfig()) == hash(RoomConfig())
    import dataclasses

    assert [f.name for f in dataclasses.fields(RoomConfig)] == \
        [f.name for f in dataclasses.fields(JaxRoom)]
    assert dataclasses.astuple(RoomConfig()) == dataclasses.astuple(JaxRoom())
