"""Parity of the port's full-width TPUFPU nets, ``tpufpu`` (a 512-wide
bottleneck) and ``tpufpu_slim``, int8 and float, with azoom's bundled nets
(CPU), on two 96-bin x 16-frame crops of a scene's physics features with the
bundled weights, against the reference's eager ``model.apply``. Bounds as
tests/test_torch_models.py: int8 mask max < 1e-2 and mean < 2e-4, and 1e-6
with the reference's BatchNorm multipliers (XLA's rsqrt) put into the port's
epilogue rows; float nets max <= 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from azoom.dsp.stft import stft as jax_stft
from azoom.masks.features import physics_aware_features as jax_physics
from azoom.models.pretrained import load_bundled as jax_load_bundled
from azoom.sim.farfield import make_scene
from azoom.sim.signals import speech_like_batch
from azoom_torch.models import convert
from azoom_torch.models.pretrained import load_bundled

NETS = ["tpufpu", "tpufpu_slim"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU work in one thread while this file runs: beside the
    suite's other workers, torch's intra-op threads oversubscribe the cores
    and slow these tests many-fold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def references():
    """name -> (features, JAX int8 mask, JAX float mask)."""
    sigs = speech_like_batch(jax.random.PRNGKey(3), 3, 8000, 16000)
    sc = make_scene(sigs[0], sigs[1:], 90.0, jnp.array([40.0, 130.0]), 0.04, 16000)
    f = np.asarray(jax_physics(jax_stft(sc["mixture"])))
    x = np.stack([f[0:96, :16], f[200:296, :16]])
    refs = {}
    for name in NETS:
        masks = [np.asarray(m.apply(v, jnp.asarray(x)))
                 for m, v, _ in (jax_load_bundled(name, quant=q) for q in (True, False))]
        refs[name] = (x, *masks)
    return refs


def _mask(name, quant, x):
    model, kind = load_bundled(name, quant=quant, device="cpu")
    assert kind == "physics"
    with torch.inference_mode():
        return model(torch.from_numpy(x)).numpy()


def _close(got, ref, what, max_bound, mean_bound=None):
    err = np.abs(got - ref)
    print(f"[parity] {what}: mask max={err.max():.3e} mean={err.mean():.3e}")  # pytest -s
    assert got.shape == ref.shape
    assert float(err.max()) < max_bound
    assert mean_bound is None or float(err.mean()) < mean_bound


@pytest.mark.parametrize("name", NETS)
def test_int8_nets_match_flax(references, name):
    x, ref, _ = references[name]
    _close(_mask(name, True, x), ref, f"int8 {name}", 1e-2, 2e-4)


@pytest.mark.parametrize("name", NETS)
def test_int8_nets_match_flax_with_its_batchnorm_multipliers(references, name, monkeypatch):
    x, ref, _ = references[name]
    exact = convert.epilogue_params

    def with_xla_rsqrt(act_scale, w_scale, bias, bn=None):
        epi = exact(act_scale, w_scale, bias, bn)
        if bn is not None:
            rs = np.asarray(jax.lax.rsqrt(jnp.asarray(bn[3].numpy()) + 1e-5))
            epi[3] = torch.from_numpy(np.array(rs)) * bn[0]
        return epi

    monkeypatch.setattr(convert, "epilogue_params", with_xla_rsqrt)
    _close(_mask(name, True, x), ref, f"int8 {name} with XLA's BatchNorm multipliers", 1e-6)


@pytest.mark.parametrize("name", NETS)
def test_float_nets_match_flax(references, name):
    x, _, ref = references[name]
    _close(_mask(name, False, x), ref, f"float {name}", 1e-5)
