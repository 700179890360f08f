"""Parity of the port's TPUFPU mask net, carried across from flax by
tpufpu_from_flax, with azoom.models.unet.TPUFPU(quant=True) (CPU).

Bounds are those of tests/test_qconv_pallas.py for a whole net: mask max
error < 1e-2 and mean < 2e-4. Each of the 21 convs re-quantises its input,
so a one-ulp difference at a rounding boundary flips an int8 code and flips
compound; the port keeps the reference's float32 operation order in the conv
epilogue and the upsampling, which keeps it far inside these bounds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from azoom.dsp.stft import stft as jax_stft
from azoom.masks.features import physics_aware_features as jax_features
from azoom.models.pretrained import load_bundled as jax_load_bundled
from azoom.models.quantize import calibrate_act_scales
from azoom.models.quantize import load_quantized as jax_load_quantized
from azoom.models.unet import TPUFPU as FlaxTPUFPU
from azoom.models.unet import fold_freq as jax_fold_freq
from azoom.models.unet import pad_frames as jax_pad_frames
from azoom.models.unet import unfold_freq as jax_unfold_freq
from azoom.sim.farfield import make_scene
from azoom.sim.signals import speech_like_batch
from azoom_torch.models.convert import tpufpu_from_flax
from azoom_torch.models.pretrained import ASSETS, load_bundled
from azoom_torch.models.quantize import load_quantized
from azoom_torch.models.unet import TPUFPU, QConv, fold_freq, pad_frames, unfold_freq

NANO = "tpufpu_b64s4d2e2_phy_int8.npz"


def _np_tree(tree):
    if hasattr(tree, "items"):
        return {k: _np_tree(v) for k, v in tree.items()}
    return np.array(tree)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _assert_masks_close(got, ref, what):
    assert got.shape == ref.shape
    err = np.abs(got - ref)
    print(f"[parity] {what}: mask max={err.max():.3e} mean={err.mean():.3e}")  # pytest -s
    assert float(err.max()) < 1e-2, f"mask max error {err.max():.2e}"
    assert float(err.mean()) < 2e-4, f"mask mean error {err.mean():.2e}"
    assert np.all((got >= 0) & (got <= 1))


def test_small_tpufpu_carried_across_matches_flax(rng):
    kwargs = dict(base=8, fold=4, bneck=4, dec_div=2, enc_div=2)
    model = FlaxTPUFPU(dtype=jnp.float32, quant=True, **kwargs)
    x = rng.standard_normal((2, 513, 16, 4)).astype(np.float32)
    v = _np_tree(model.init(jax.random.PRNGKey(4), x))
    for coll in ("params", "batch_stats"):
        for name, leaf in _leaves(v[coll]):
            if "BatchNorm" not in name:
                continue
            node = v[coll]
            *path, last = name.split("/")
            for p in path:
                node = node[p]
            if last == "var":
                node[last] = (0.5 + rng.random(leaf.shape)).astype(np.float32)
            elif last == "scale":
                node[last] = (0.7 + 0.6 * rng.random(leaf.shape)).astype(np.float32)
            else:
                node[last] = (0.3 * rng.standard_normal(leaf.shape)).astype(np.float32)
    v = _np_tree(calibrate_act_scales(model, v, [x]))
    ref = np.asarray(model.apply(v, x))
    port = tpufpu_from_flax(v, kwargs, device="cpu")
    got = port(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 513, 16)
    _assert_masks_close(got, ref, "small TPUFPU")


@pytest.fixture(scope="module")
def nano_case():
    """Features of a 0.5 s scene and the reference nano mask on them."""
    sigs = speech_like_batch(jax.random.PRNGKey(3), 3, 8000, 16000)
    sc = make_scene(sigs[0], sigs[1:], 90.0, jnp.array([40.0, 130.0]), 0.04, 16000)
    feats, _ = jax_pad_frames(jax_features(jax_stft(sc["mixture"]))[None], 16)
    jm, jv, kind = jax_load_bundled("tpufpu_nano", quant=True)
    assert kind == "physics"
    return torch.from_numpy(np.array(feats)), np.asarray(jm.apply(jv, feats))


def test_bundled_nano_matches_flax(nano_case):
    """The bundled int8 nano net at full width."""
    feats, ref = nano_case
    model, feature_kind = load_bundled("tpufpu_nano", device="cpu")
    assert feature_kind == "physics"
    _assert_masks_close(model(feats).numpy(), ref, "bundled tpufpu_nano")


def test_folded_affine_epilogue_breaks_parity(nano_case):
    """Why the conv epilogue keeps the reference's order of float32
    operations: folding dequant and BatchNorm into one affine (as the Pallas
    kernel does) moves outputs by ulps, which flip int8 codes downstream and
    compound over the 21 convs, well past the whole-net bound."""
    feats, ref = nano_case
    model, _ = load_bundled("tpufpu_nano", device="cpu")
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, QConv):
                s1, b1, mean, mul, beta = m.epi
                m.epi.copy_(torch.stack([s1 * mul, (b1 - mean) * mul + beta,
                                         torch.zeros_like(mean), torch.ones_like(mul),
                                         torch.zeros_like(beta)]))
    err = np.abs(model(feats).numpy() - ref)
    print(f"[parity] folded-affine epilogue: mask max={err.max():.3e} mean={err.mean():.3e}")
    assert err.max() > 1e-2


def test_load_quantized_matches_jax_reader():
    ours = dict(_leaves(load_quantized(ASSETS / NANO)))
    theirs = {k: np.asarray(v) for k, v in _leaves(_np_tree(jax_load_quantized(ASSETS / NANO)))}
    assert ours.keys() == theirs.keys()
    assert sum(k.startswith("quant_stats/") for k in ours) == 21
    for k, v in ours.items():
        assert v.dtype == theirs[k].dtype, k
        np.testing.assert_array_equal(v, theirs[k], err_msg=k)


def test_fold_unfold_match_jax(rng):
    x = rng.standard_normal((2, 513, 8, 4)).astype(np.float32)
    folded = fold_freq(torch.from_numpy(x), 4)
    np.testing.assert_array_equal(folded.numpy(), np.asarray(jax_fold_freq(x, 4)))
    y = rng.standard_normal((2, 129, 8, 4)).astype(np.float32)
    np.testing.assert_array_equal(unfold_freq(torch.from_numpy(y), 4, 513).numpy(),
                                  np.asarray(jax_unfold_freq(y, 4, 513)))
    padded, t = pad_frames(torch.from_numpy(x[:, :, :5]), 16)
    jp, jt = jax_pad_frames(x[:, :, :5], 16)
    assert t == jt == 5
    np.testing.assert_array_equal(padded.numpy(), np.asarray(jp))


def test_unported_knobs_raise():
    """tfold and fattn are ported (tests/test_torch_quantize_export.py holds
    them against the reference): they build the stem, head and attention
    block of their widths. A net without calibrated scales serves the int8
    path on the reference's dynamic scales (tests/test_torch_dynamic_int8.py
    holds them against the reference)."""
    net = TPUFPU(base=64, fold=4, tfold=2, fattn=4)
    assert net.e1.cbr0.conv.cin == 4 * 2 * 4 and net.head.weight.shape == (64, 4 * 2)
    assert net.attn.pos_emb.shape == (129, 512)
    assert TPUFPU().attn is None
    v = load_quantized(ASSETS / NANO)
    net = tpufpu_from_flax({k: v[k] for k in ("params", "batch_stats")},
                           dict(base=64, fold=4, bneck=4, dec_div=2, enc_div=2), "cpu")
    convs = [m for m in net.modules() if isinstance(m, QConv)]
    assert len(convs) == 21 and all(m.act_scale is None for m in convs)
