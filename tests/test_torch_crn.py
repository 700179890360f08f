"""Parity of the port's causal CRN mask net (azoom_torch.models.crn) with
azoom.models.crn.CRNMaskNet (CPU), and ``load_bundled("crn_causal")``.

The nets are held against flax's eager ``model.apply``: at random weights
and BatchNorm statistics in flax's variable tree at small widths,
unidirectional and bidirectional, and with the bundled crn_causal weights on
one 2 s scene's logmag_ipd features (the reference's own STFT and
features). The streaming form (T = 1 with carries, the low-latency path's
per-hop step) is held against the whole-T pass and against the carries
flax returns.

Bounds: mask max <= 1e-5 against the reference (measured ~1e-7 at small
widths, ~1e-6 for the bundled net; the port takes its frame-row products
in float64 and rounds once, XLA in float32). The streaming form against the
whole-T pass: <= 1e-6 (the products give the same bits for one row or many;
the elementwise tails of CPU kernels can differ by an ulp with the length).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from azoom.dsp.stft import stft as jax_stft
from azoom.masks.features import logmag_ipd_features as jax_logmag_ipd
from azoom.models.crn import CRNMaskNet as JaxCRN
from azoom.models.pretrained import load_pretrained_crn_causal
from azoom.sim.farfield import make_scene
from azoom.sim.signals import speech_like_batch
from azoom_torch.models.convert import crn_from_flax
from azoom_torch.models.crn import CRNMaskNet
from azoom_torch.models.pretrained import load_bundled


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU work in one thread while this file runs (beside the
    suite's other workers torch's intra-op threads oversubscribe the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _small(unidirectional: bool, seed: int = 1):
    """A flax CRN at base 4, hidden 8, F = 33 with random numpy variables in
    the tree flax's init gives (its shapes by ``jax.eval_shape``: an eager
    init compiles every initializer, ~20 s on one core); the BatchNorm
    variances positive."""
    rng = np.random.default_rng(seed)
    jm = JaxCRN(base=4, hidden=8, n_lstm=2, unidirectional=unidirectional)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(seed), jnp.zeros((1, 33, 5, 2)))
    v = jax.tree_util.tree_map(
        lambda a: (0.3 * rng.standard_normal(a.shape)).astype(np.float32), shapes)
    v["batch_stats"] = jax.tree_util.tree_map(
        lambda a: (0.5 + np.abs(rng.standard_normal(a.shape))).astype(np.float32),
        v["batch_stats"])
    tm = crn_from_flax(v, dict(base=4, hidden=8, n_lstm=2, unidirectional=unidirectional,
                               n_freqs=33))
    return jm, v, tm


@pytest.fixture(scope="module")
def bundled():
    jm, jv = load_pretrained_crn_causal()
    tm, kind = load_bundled("crn_causal", device="cpu")
    return jm, jv, tm, kind


@pytest.fixture(scope="module")
def scene_features():
    """logmag_ipd features (1, 513, 63, 2) of a 2 s scene, by the reference."""
    sigs = speech_like_batch(jax.random.PRNGKey(2), 3, 32_000, 16_000)
    sc = make_scene(sigs[0], sigs[1:], 75.0, jnp.asarray([40.0, 130.0]), 0.04, 16_000)
    return np.asarray(jax_logmag_ipd(jax_stft(sc["mixture"])))[None]


def _close(got, ref, what, bound):
    err = float(np.max(np.abs(np.asarray(got) - np.asarray(ref))))
    print(f"[parity] {what}: max={err:.3e}")  # pytest -s
    assert np.shape(got) == np.shape(ref)
    assert err <= bound, f"{what}: max error {err:.2e}"


@pytest.mark.parametrize("unidirectional", [True, False], ids=["uni", "bi"])
def test_crn_matches_flax_at_small_widths(unidirectional):
    jm, v, tm = _small(unidirectional)
    x = np.random.default_rng(5).standard_normal((2, 33, 5, 2)).astype(np.float32)
    ref = np.asarray(jm.apply(v, jnp.asarray(x)))
    with torch.inference_mode():
        got = tm(torch.from_numpy(x)).numpy()
    _close(got, ref, f"crn small {'uni' if unidirectional else 'bi'}", 1e-5)
    assert np.all((got >= 0) & (got <= 1))


def test_bundled_crn_matches_the_reference(bundled, scene_features):
    jm, jv, tm, kind = bundled
    assert kind == "logmag_ipd"
    ref = np.asarray(jm.apply(jv, jnp.asarray(scene_features)))
    with torch.inference_mode():
        got = tm(torch.from_numpy(scene_features)).numpy()
    _close(got, ref, "crn_causal on a 2 s scene", 1e-5)


def test_streaming_form_matches_the_whole_pass_and_flax_carries(bundled, scene_features):
    jm, jv, tm, _ = bundled
    x = scene_features[:, :, :16]
    xt = torch.from_numpy(x)
    with torch.inference_mode():
        whole = tm(xt)
        carries, steps = tm.initial_carries(1), []
        for t in range(x.shape[2]):
            m, carries = tm(xt[:, :, t:t + 1], carries=carries, return_carries=True)
            steps.append(m)
    _close(torch.cat(steps, dim=-1).numpy(), whole.numpy(), "frame by frame vs whole T", 1e-6)
    ref, ref_carries = jm.apply(jv, jnp.asarray(x), carries=jm.initial_carries(1),
                                return_carries=True)
    _close(whole.numpy(), np.asarray(ref), "whole T vs flax", 1e-5)
    assert len(carries) == len(ref_carries) == 2
    for (c, h), (rc, rh) in zip(carries, ref_carries):
        _close(c.numpy(), np.asarray(rc), "LSTM c vs flax", 1e-5)
        _close(h.numpy(), np.asarray(rh), "LSTM h vs flax", 1e-5)


def test_streaming_needs_the_unidirectional_net():
    tm = CRNMaskNet(base=4, hidden=8, unidirectional=False, n_freqs=33)
    x = torch.zeros((1, 33, 1, 2))
    with pytest.raises(ValueError, match="unidirectional"):
        tm(x, carries=tm.initial_carries(1))
    with pytest.raises(ValueError, match="33"):
        tm(torch.zeros((1, 32, 1, 2)))


def test_load_bundled_crn_causal():
    net, kind = load_bundled("crn_causal", device="cpu")
    assert isinstance(net, CRNMaskNet) and kind == "logmag_ipd"
    assert (net.base, net.hidden, net.n_lstm, net.unidirectional) == (16, 128, 2, True)
    assert tuple(net.w_in.shape) == (65 * 64, 128) and tuple(net.w_out.shape) == (128, 65 * 64)
    q, _ = load_bundled("crn_causal", quant=False, device="cpu")  # quant is ignored
    for a, b in zip(net.buffers(), q.buffers()):
        assert torch.equal(a, b)
    c = net.initial_carries(3)
    assert len(c) == 2 and all(tuple(t.shape) == (3, 128) for pair in c for t in pair)
    with torch.inference_mode():
        mask, carries = net(torch.zeros((3, 513, 2, 2)), carries=c, return_carries=True)
    assert tuple(mask.shape) == (3, 513, 2) and bool(torch.isfinite(mask).all())
    assert all(tuple(t.shape) == (3, 128) for pair in carries for t in pair)
