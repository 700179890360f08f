"""Parity of the port's bundled base-32 conv mask nets (FreqPreservingUNet,
DeepFPU; int8 and float) and of the logmag_ipd features with azoom (CPU);
``load_bundled`` for every conv net. The full-width TPUFPU nets are held the
same way in tests/test_torch_tpufpu_nets.py.

The nets are fully convolutional, so they are held on small feature planes
(two crops of 96 bins x 16 frames of a 0.5 s scene's features, made by the
reference's own STFT and feature functions), with the bundled weights: JAX's
int8 DeepFPU takes ~33 s for one 2 s window on one core here, ~18 s for
these planes. The reference runs eagerly (``model.apply``): its jitted
graph fuses the dequant into multiply-adds and flips other int8 codes, so
the port is held to the reference's op-by-op arithmetic, as
tests/test_torch_tpufpu.py holds the nano net.

Bounds: int8 nets mask max < 1e-2 and mean < 2e-4 (tests/test_qconv_pallas.py's
whole-net bounds), float nets max <= 1e-5. One difference is left between
the int8 nets: the port's BatchNorm multiplier takes the correctly rounded
1/sqrt(var + eps), XLA's CPU rsqrt is off by an ulp in ~14 % of channels,
and the ulps flip int8 codes (ROADMAP Queue C). With the reference's own
multipliers put into the port's epilogue rows, every int8 net agrees with
the reference to 2e-7 (test_int8_nets_match_flax_with_its_batchnorm_multipliers),
which pins the difference on that rounding; as shipped, DeepFPU's mask mean
error on these planes is 2.2e-4, held to 5e-4 (fpu: 6.4e-9).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from azoom.dsp.stft import stft as jax_stft
from azoom.masks.features import logmag_ipd_features as jax_logmag_ipd
from azoom.masks.features import physics_aware_features as jax_physics
from azoom.models.pretrained import load_bundled as jax_load_bundled
from azoom.sim.farfield import make_scene
from azoom.sim.signals import speech_like_batch
from azoom_torch.kernels.qconv_kernel import STEM_CINS
from azoom_torch.masks.features import logmag_ipd_features
from azoom_torch.models import convert
from azoom_torch.models.convert import from_flax
from azoom_torch.models.pretrained import ASSETS, load_bundled
from azoom_torch.models.quantize import load_quantized
from azoom_torch.models.unet import (
    TPUFPU, DeepFPU, FConv, FreqPreservingUNet, QConv, conv_shapes,
)

NETS = ["fpu", "deepfpu"]
# int8 mask mean bound per net: DeepFPU's BatchNorm-rounding flips (docstring)
INT8_MEAN_BOUND = {"fpu": 2e-4, "deepfpu": 5e-4}
ALL_CONV_NETS = ["fpu", "fpu_reverb", "fpu_multigeo", "deepfpu", "tpufpu", "tpufpu_slim",
                 "tpufpu_nano"]


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
def planes():
    """Two 96-bin x 16-frame crops of each feature kind of one scene."""
    sigs = speech_like_batch(jax.random.PRNGKey(3), 3, 8000, 16000)
    sc = make_scene(sigs[0], sigs[1:], 90.0, jnp.array([40.0, 130.0]), 0.04, 16000)
    Y = jax_stft(sc["mixture"])
    out = {}
    for kind, fn in (("logmag_ipd", jax_logmag_ipd), ("physics", jax_physics)):
        f = np.asarray(fn(Y))
        out[kind] = np.stack([f[0:96, :16], f[200:296, :16]])
    return out


@pytest.fixture(scope="module")
def references(planes):
    """name -> (features, JAX int8 mask, JAX float mask), eager applies."""
    refs = {}
    for name in NETS:
        jm, jv, kind = jax_load_bundled(name, quant=True)
        x = planes[kind]
        int8 = np.asarray(jm.apply(jv, jnp.asarray(x)))
        fm, fv, _ = jax_load_bundled(name, quant=False)
        flt = np.asarray(fm.apply(fv, jnp.asarray(x)))
        refs[name] = (x, int8, flt)
    return refs


def _close(got, ref, what, max_bound, mean_bound=None):
    err = np.abs(got - ref)
    print(f"[parity] {what}: mask max={err.max():.3e} mean={err.mean():.3e}")  # pytest -s
    assert got.shape == ref.shape
    assert float(err.max()) < max_bound, f"{what}: mask max error {err.max():.2e}"
    if mean_bound is not None:
        assert float(err.mean()) < mean_bound, f"{what}: mask mean error {err.mean():.2e}"
    assert np.all((got >= 0) & (got <= 1))


@pytest.mark.parametrize("name", NETS)
def test_int8_nets_match_flax(references, name):
    x, ref, _ = references[name]
    model, _ = load_bundled(name, quant=True, device="cpu")
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
    _close(got, ref, f"int8 {name}", 1e-2, INT8_MEAN_BOUND[name])


@pytest.mark.parametrize("name", NETS)
def test_int8_nets_match_flax_with_its_batchnorm_multipliers(references, name, monkeypatch):
    """The port given XLA's rsqrt for the BatchNorm multipliers (the one
    rounding it does differently) computes the reference's int8 net."""
    x, ref, _ = references[name]
    exact = convert.epilogue_params

    def with_xla_rsqrt(act_scale, w_scale, bias, bn=None):
        epi = exact(act_scale, w_scale, bias, bn)
        if bn is not None:
            gamma, _, _, var = bn
            rs = np.asarray(jax.lax.rsqrt(jnp.asarray(var.numpy()) + 1e-5))
            epi[3] = torch.from_numpy(np.array(rs)) * gamma
        return epi

    monkeypatch.setattr(convert, "epilogue_params", with_xla_rsqrt)
    model, _ = load_bundled(name, quant=True, device="cpu")
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
    _close(got, ref, f"int8 {name} with XLA's BatchNorm multipliers", 1e-6)


@pytest.mark.parametrize("name", NETS)
def test_float_nets_match_flax(references, name):
    x, _, ref = references[name]
    model, _ = load_bundled(name, quant=False, device="cpu")
    assert not any(isinstance(m, QConv) for m in model.modules())
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
    _close(got, ref, f"float {name}", 1e-5)


@pytest.mark.parametrize("name", ALL_CONV_NETS)
@pytest.mark.parametrize("quant", [True, False])
def test_load_bundled_serves_every_conv_net(name, quant):
    kinds = {"fpu": "logmag_ipd", "fpu_reverb": "logmag_ipd", "fpu_multigeo": "logmag_ipd"}
    classes = {"fpu": FreqPreservingUNet, "fpu_reverb": FreqPreservingUNet,
               "fpu_multigeo": FreqPreservingUNet, "deepfpu": DeepFPU}
    model, kind = load_bundled(name, quant=quant, device="cpu")
    assert kind == kinds.get(name, "physics")
    assert type(model) is classes.get(name, TPUFPU) and not model.training
    assert model.in_channels == (2 if kind == "logmag_ipd" else 4)
    convs = [m for m in model.modules() if isinstance(m, (QConv, FConv))]
    assert convs and all(isinstance(m, QConv if quant else FConv) for m in convs)
    assert len(conv_shapes(model, 16)) == {FreqPreservingUNet: 14, DeepFPU: 27,
                                           TPUFPU: 21}[type(model)]
    with torch.inference_mode():
        mask = model(torch.zeros((1, 9, 16, model.in_channels)))
    assert mask.shape == (1, 9, 16) and bool(torch.isfinite(mask).all())


def test_the_causal_crn_loads():
    """crn_causal, float only (quant is ignored), at the reference's widths:
    513 bins padded to 520, 65 rows of 64 channels into a 128-wide LSTM."""
    net, kind = load_bundled("crn_causal", quant=False, device="cpu")
    assert kind == "logmag_ipd" and (net.base, net.hidden, net.n_lstm) == (16, 128, 2)
    assert tuple(net.w_in.shape) == (4160, 128) and tuple(net.w_out.shape) == (128, 4160)
    assert [tuple(c.weight.shape) for c in net.down] == [(10, 16), (80, 32), (160, 64)]
    assert [tuple(c.weight.shape) for c in net.up] == [(384, 64), (192, 32), (96, 32)]
    assert tuple(net.fwd[0].wi.shape) == (128, 512) and tuple(net.fwd[1].wh.shape) == (128, 512)
    with torch.inference_mode():
        mask = net(torch.zeros((1, 513, 3, 2)))
    assert mask.shape == (1, 513, 3) and bool(torch.isfinite(mask).all())


def test_from_flax_modes():
    """The int8 mode takes the calibrated static activation scales, or
    without them the reference's dynamic per-call scale; the float mode
    ignores them, and both carry the same float weights across."""
    v = load_quantized(ASSETS / "fpu_b32_int8.npz")
    dyn = from_flax(FreqPreservingUNet, {k: v[k] for k in ("params", "batch_stats")}, {},
                    device="cpu")
    convs = [m for m in dyn.modules() if isinstance(m, QConv)]
    assert len(convs) == 14 and all(m.act_scale is None for m in convs)
    flt = from_flax(FreqPreservingUNet, {k: v[k] for k in ("params", "batch_stats")}, {},
                    quant=False, device="cpu")
    kernel = v["params"]["DoubleConv_0"]["ConvBNRelu_0"]["Conv_0"]["kernel"]
    np.testing.assert_array_equal(flt.e1.cbr0.conv.weight.numpy(), kernel.reshape(18, 32))
    q = from_flax(FreqPreservingUNet, v, dict(base=32, in_channels=2), quant=True,
                  device="cpu")
    assert q.e1.cbr0.conv.w_q.shape == (32, 160)  # the stem's 2 channels packed as 16
    d = load_quantized(ASSETS / "deepfpu_b32_phy_int8.npz")
    assert isinstance(from_flax(DeepFPU, d, dict(base=32), quant=False, device="cpu")
                      .b_res1.conv1, FConv)


@pytest.mark.parametrize("name", ["fpu", "deepfpu"])
def test_conv_shapes_of_the_base32_nets(name):
    model, _ = load_bundled(name, device="cpu")
    shapes = conv_shapes(model, 64)
    assert shapes[0][:3] == ({"fpu": 2, "deepfpu": 4}[name], 32, 64)
    assert min(s[1] for s in shapes) == 32 and shapes[0][0] in STEM_CINS
    if name == "deepfpu":  # the bottleneck: Cout 512 at 64 / 16 frames
        assert (512, 512, 4, True, False) in shapes
    assert shapes[-1] == (32, 32, 64, False, False)
    assert shapes[-2] == (64, 32, 64, False, True)  # the last decoder concat


def _complex(rng, shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


# name: (mics, ipd_scale, pair_mode, IPD atol). At M = 2 and unit scale the
# raw difference of two float32 angles; under adaptation and at M = 3 the
# re-wrapped principal value of the cross-spectrum, whose float32 mean the
# port takes in float64 (M = 3: a few ulps of the angle, times the scale).
FEATURE_CASES = {
    "m2_raw": (2, 1.0, "mean", 2e-6),
    "m2_adapt_mean": (2, 4.0, "mean", 2e-6),
    "m2_adapt_first": (2, 4.0, "first", 2e-6),
    "m3_mean": (3, 1.0, "mean", 1e-5),
    "m3_adapt_mean": (3, 4.0, "mean", 4e-5),
    "m3_adapt_first": (3, 4.0, "first", 2e-6),
}


@pytest.mark.parametrize("case", list(FEATURE_CASES))
def test_logmag_ipd_features_match_jax(case):
    m, scale, pair_mode, atol = FEATURE_CASES[case]
    Y = _complex(np.random.default_rng(m), (2, m, 513, 32))
    ref = np.asarray(jax_logmag_ipd(jnp.asarray(Y), scale, pair_mode))
    got = logmag_ipd_features(torch.from_numpy(Y), scale, pair_mode).numpy()
    assert got.shape == ref.shape == (2, 513, 32, 2) and got.dtype == np.float32
    np.testing.assert_allclose(got[..., 0], ref[..., 0], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[..., 1], ref[..., 1], rtol=0, atol=atol)
    if scale != 1.0 or m > 2:
        assert np.all(np.abs(got[..., 1]) <= np.pi)
    else:  # the raw difference spans (-2 pi, 2 pi)
        assert np.abs(got[..., 1]).max() > np.pi


def test_raw_ipd_keeps_the_float32_order_of_the_reference():
    """angle(Y0) and angle(Y1) rounded to float32, then subtracted in float32:
    a float64 difference rounded once differs from the reference in more
    elements (XLA's float32 atan2 is not correctly rounded either, so some
    remain)."""
    Y = _complex(np.random.default_rng(2), (2, 2, 513, 64))
    ref = np.asarray(jax_logmag_ipd(jnp.asarray(Y)))[..., 1]
    got = logmag_ipd_features(torch.from_numpy(Y)).numpy()[..., 1]
    once = (np.angle(Y[:, 0].astype(np.complex128))
            - np.angle(Y[:, 1].astype(np.complex128))).astype(np.float32)
    n_got, n_once = int((got != ref).sum()), int((once != ref).sum())
    print(f"[parity] raw IPD elements differing from JAX: {n_got} (float64 once: {n_once}) "
          f"of {ref.size}")
    assert n_got < n_once / 2


def test_stem_codes_of_the_fpu_on_the_port_features():
    """How many int8 codes of fpu's stem conv differ when the port's features
    replace the reference's on a scene (both from the reference's STFT)."""
    sigs = speech_like_batch(jax.random.PRNGKey(5), 3, 16000, 16000)
    sc = make_scene(sigs[0], sigs[1:], 60.0, jnp.array([40.0, 130.0]), 0.04, 16000)
    Y = np.asarray(jax_stft(sc["mixture"]))
    ref = np.asarray(jax_logmag_ipd(jnp.asarray(Y)))
    got = logmag_ipd_features(torch.from_numpy(Y)).numpy()
    model, _ = load_bundled("fpu", device="cpu")
    s = np.float32(model.e1.cbr0.conv.act_scale)
    codes = [np.clip(np.round(f / s), -127, 127) for f in (got, ref)]
    differ = int((codes[0] != codes[1]).sum())
    print(f"[parity] fpu stem codes differing: {differ} of {ref.size} "
          f"(feature elements differing: {int((got != ref).sum())})")
    assert differ <= 1e-4 * ref.size


# a net trained at another base (cli/train.py's --base takes any integer), served int8: its
# widths (stem 2 -> 24, 24 / 48 / 96 / 192, the decoder's 96 + 96 concat ...) are none of the
# bundled nets', and go to the mma.sync route on the card
BASE24 = dict(base=24, in_channels=2)


@pytest.fixture(scope="module")
def base24():
    """(plane, variables with the port's calibrated quant_stats, the
    reference's eager mask on static scales, on dynamic scales): a
    FreqPreservingUNet at base 24 from numpy-seeded variables in the tree
    flax's init gives (shapes by ``jax.eval_shape``: an eager init compiles
    every initializer), calibrated by the port on the CPU. One plane of one
    element: the reference's dynamic scale is that of its whole input."""
    from azoom.models.unet import FreqPreservingUNet as FlaxFPU
    from azoom_torch.models.quantize import calibrate_act_scales

    rng = np.random.default_rng(24)
    x = np.abs(rng.standard_normal((1, 24, 16, 2))).astype(np.float32)
    flax_net = FlaxFPU(base=24, quant=True)
    shapes = jax.eval_shape(flax_net.init, jax.random.PRNGKey(0), jnp.asarray(x))

    def fill(path, a):
        name = "/".join(str(getattr(k, "key", k)) for k in path)
        if name.endswith("var"):
            return (0.5 + rng.random(a.shape)).astype(np.float32)
        if "BatchNorm" in name and name.endswith("scale"):
            return (0.7 + 0.6 * rng.random(a.shape)).astype(np.float32)
        if name.endswith("kernel"):
            return (rng.standard_normal(a.shape) / np.sqrt(np.prod(a.shape[:-1]))).astype(np.float32)
        return (0.1 * rng.standard_normal(a.shape)).astype(np.float32)

    filled = jax.tree_util.tree_map_with_path(fill, shapes)
    v = {k: jax.tree_util.tree_map(np.asarray, dict(filled[k])) for k in ("params", "batch_stats")}
    static = calibrate_act_scales((FreqPreservingUNet, BASE24), v, [x], device="cpu")
    refs = {mode: np.asarray(flax_net.apply(tree, jnp.asarray(x)))
            for mode, tree in (("static", static), ("dynamic", v))}
    return x, static, refs


@pytest.mark.parametrize("mode", ["static", "dynamic"])
@pytest.mark.parametrize("multipliers", ["xla", "port"])
def test_an_int8_net_at_base_24_matches_flax(base24, mode, multipliers, monkeypatch):
    """The whole int8 net at widths no bundled net has, on calibrated static
    scales and on the reference's dynamic ones: to 1e-6 with XLA's BatchNorm
    multipliers in the port's epilogue rows (the one rounding it does
    differently), within the whole-net int8 bounds as shipped."""
    x, static, refs = base24
    if multipliers == "xla":
        exact = convert.epilogue_params

        def with_xla_rsqrt(act_scale, w_scale, bias, bn=None):
            epi = exact(act_scale, w_scale, bias, bn)
            if bn is not None:
                gamma, _, _, var = bn
                rs = np.asarray(jax.lax.rsqrt(jnp.asarray(var.numpy()) + 1e-5))
                epi[3] = torch.from_numpy(np.array(rs)) * gamma
            return epi

        monkeypatch.setattr(convert, "epilogue_params", with_xla_rsqrt)
    tree = static if mode == "static" else {k: static[k] for k in ("params", "batch_stats")}
    model = from_flax(FreqPreservingUNet, tree, BASE24, quant=True, device="cpu")
    convs = [m for m in model.modules() if isinstance(m, QConv)]
    assert len(convs) == 14 and all((m.act_scale is None) == (mode == "dynamic") for m in convs)
    assert {(m.cin, m.cout) for m in convs} >= {(2, 24), (24, 48), (96, 192), (192, 96), (48, 24)}
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
    what = f"int8 fpu base 24 {mode} ({multipliers} multipliers)"
    if multipliers == "xla":
        _close(got, refs[mode], what, 1e-6)
    else:
        _close(got, refs[mode], what, 1e-2, 2e-4)
