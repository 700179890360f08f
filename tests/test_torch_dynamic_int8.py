"""The int8 nets' dynamic activation scales (the reference QConv's default
mode, for variables without ``quant_stats``) against azoom (CPU).

The port takes the scale of each batch element on its own, as the
reference takes it wherever it serves such a net: under ``jax.vmap``, one
chunk (stream/chunker.py) or one scene (parallel/sweep.py) at a time. So
each reference here is the eager ``apply`` of one element at a time.

Tolerances: the scale bit for bit (``max|x[b]| / 127 + 1e-30`` in float32,
as the reference's eager ``jnp`` computes it, all-zero input included);
``qconv3x3_plain`` on dynamic scales (formed from the input's (B,) maxima)
bit for bit the float-scale call of each element; a small TPUFPU's mask and the FreqPreservingUNet's stem and
decoder cells within 1.5e-7 (of the output's scale, for the cells) of the
reference's eager ``apply`` once the port's epilogue rows carry XLA's
BatchNorm multipliers (the one rounding the port does differently,
tests/test_torch_models.py), and within the whole-net int8 bounds (max
1e-2, mean 2e-4) as shipped; an element's output bit for bit the same in
its batch and alone.

The reference's jitted graph contracts the scale to one fused multiply-add
by float32(1/127) on XLA's CPU (1 ulp away in ~7 % of tensors), so it is
held against the eager expression, as the nets are.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from azoom.models.unet import TPUFPU as FlaxTPUFPU
from azoom.models.unet import DoubleConv as FlaxDoubleConv
from azoom_torch.kernels.qconv_kernel import (
    dynamic_act_scale, epilogue_params, input_max, qconv3x3_plain, quantize_weights,
)
from azoom_torch.models import convert
from azoom_torch.models.unet import TPUFPU, DoubleConv, QConv


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reference_scales(x):
    """The reference's expression on each element of ``x`` on its own."""
    return np.stack([np.asarray(jnp.max(jnp.abs(jnp.asarray(xb))) / 127.0 + 1e-30) for xb in x])


def _tensors(seed):
    """Batches of 3 whose elements lie decades apart; one element all zeros,
    and in every other batch an element whose largest magnitude is negative."""
    rng = np.random.default_rng(seed)
    out = [np.zeros((2, 5, 7), np.float32)]
    for i in range(20):
        x = (10.0 ** rng.uniform(-30, 6, (3, 1, 1, 1))
             * rng.standard_normal((3, 9, 4, 3))).astype(np.float32)
        x[1] = -np.abs(x[1]) if i % 2 else 0.0
        out.append(x)
    return out


def test_the_dynamic_scale_is_the_reference_expression_bit_for_bit():
    for x in _tensors(0):
        got = dynamic_act_scale(torch.from_numpy(x))
        assert got.dtype == torch.float32 and got.shape == (x.shape[0],)
        assert got.numpy().tobytes() == _reference_scales(x).tobytes(), got
    zero = dynamic_act_scale(torch.zeros(2, 4, 4, 3))
    assert zero.numpy().tobytes() == np.full(2, 1e-30, np.float32).tobytes()


def test_the_dynamic_scale_of_a_concat_covers_both_inputs():
    rng = np.random.default_rng(1)
    for big in (0, 1):
        x = rng.standard_normal((2, 3, 4, 8)).astype(np.float32)
        x2 = rng.standard_normal((2, 3, 4, 4)).astype(np.float32)
        (x2 if big else x)[1, 2, 3, 0] = 40.0
        ref = _reference_scales(np.concatenate([x, x2], -1))
        got = dynamic_act_scale(torch.from_numpy(x), torch.from_numpy(x2))
        assert got.numpy().tobytes() == ref.tobytes()
        assert float(got[1]) > 5 * float(got[0])  # the 40 is in element 1


def test_the_plain_conv_takes_a_tensor_scale_bit_for_bit():
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((2, 6, 5, 16)).astype(np.float32))
    w_q, w_scale = quantize_weights(torch.from_numpy(
        0.2 * rng.standard_normal((3, 3, 16, 32)).astype(np.float32)))
    from azoom_torch.kernels.qconv_kernel import pack_weights

    packed = pack_weights(w_q)
    x[1] *= 1e-3
    scale = dynamic_act_scale(x)
    bias = torch.from_numpy(rng.standard_normal(32).astype(np.float32))
    res = torch.from_numpy(rng.standard_normal((2, 6, 5, 32)).astype(np.float32))
    a = qconv3x3_plain(x, packed, epilogue_params(1.0, w_scale, bias), None, residual=res,
                       in_max=input_max(x))
    for b in range(2):
        s = float(scale[b])
        want = qconv3x3_plain(x[b:b + 1], packed, epilogue_params(s, w_scale, bias), s,
                              residual=res[b:b + 1])
        assert torch.equal(a[b:b + 1], want), b


def _random_variables(model, x, seed):
    """The flax tree of ``model`` (shapes by ``jax.eval_shape``: an eager init
    compiles every initializer) filled from numpy: kernels at lecun scale,
    BatchNorm variances positive and scales near 1."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.asarray(x))

    def fill(path, a):
        name = "/".join(str(getattr(k, "key", k)) for k in path)
        if name.endswith("var"):
            return (0.5 + rng.random(a.shape)).astype(np.float32)
        if "BatchNorm" in name and name.endswith("scale"):
            return (0.7 + 0.6 * rng.random(a.shape)).astype(np.float32)
        if name.endswith("kernel"):
            fan_in = int(np.prod(a.shape[:-1]))
            return (rng.standard_normal(a.shape) / np.sqrt(fan_in)).astype(np.float32)
        return (0.1 * rng.standard_normal(a.shape)).astype(np.float32)

    v = jax.tree_util.tree_map_with_path(fill, shapes)
    return {k: jax.tree_util.tree_map(np.asarray, dict(v[k])) for k in ("params", "batch_stats")}


# name -> (flax module, the port's module, keywords, input channels, frames,
# whose decoder input is a concat): the whole small TPUFPU (its folded stem,
# ResBlocks and two concat convs) and the FreqPreservingUNet's two cells of
# its own, its 2-channel unfolded stem and a decoder DoubleConv on [up, skip]
# (an eager flax apply compiles every op: the whole base-8 FPU costs ~13 s).
NETS = {
    "tpufpu": (lambda: FlaxTPUFPU(quant=True, **TPUFPU_KW), lambda: TPUFPU(**TPUFPU_KW),
               4, 16, False),
    "fpu_stem": (lambda: FlaxDoubleConv(8, quant=True), lambda: DoubleConv(2, 8), 2, 16, False),
    "fpu_decoder": (lambda: FlaxDoubleConv(16, quant=True), lambda: DoubleConv(32, 16), 32, 4,
                    True),
}
TPUFPU_KW = dict(base=8, fold=4, bneck=4, dec_div=2, enc_div=2)


def _port(name, v):
    """The port's module of ``name`` on ``v`` without quant_stats: int8 convs
    on dynamic scales."""
    if name == "tpufpu":
        return convert.from_flax(TPUFPU, v, TPUFPU_KW, quant=True, device="cpu")
    m = NETS[name][1]()
    with torch.no_grad():
        convert._load_cell(m, v["params"], v["batch_stats"], None)
    return m.eval()


@pytest.fixture(scope="module")
def references():
    """name -> (input, variables without quant_stats, eager reference output
    of one element at a time). The two elements lie a decade apart, so one
    scale over both would quantise the second at a tenth of its resolution."""
    out = {}
    for i, (name, (flax_mod, _, ch, t, _)) in enumerate(NETS.items()):
        rng = np.random.default_rng(10 + i)
        x = np.abs(rng.standard_normal((2, 40, t, ch))).astype(np.float32)
        x[1] *= 0.1
        model = flax_mod()
        v = _random_variables(model, x, 20 + i)
        ref = np.concatenate([np.asarray(model.apply(v, jnp.asarray(x[b:b + 1])))
                              for b in range(2)])
        out[name] = (x, v, ref)
    return out


def _xla_multipliers(monkeypatch):
    exact = convert.epilogue_params

    def with_xla_rsqrt(act_scale, w_scale, bias, bn=None):
        epi = exact(act_scale, w_scale, bias, bn)
        if bn is not None:
            gamma, _, _, var = bn
            rs = np.asarray(jax.lax.rsqrt(jnp.asarray(var.numpy()) + 1e-5))
            epi[3] = torch.from_numpy(np.array(rs)) * gamma
        return epi

    monkeypatch.setattr(convert, "epilogue_params", with_xla_rsqrt)


@pytest.mark.parametrize("name", list(NETS))
@pytest.mark.parametrize("multipliers", ["xla", "port"])
def test_small_nets_without_quant_stats_match_the_reference(references, name, multipliers,
                                                            monkeypatch):
    """The concat convs take the scale of both inputs (the FPU's decoder
    cell reads [x, x2] in place), TPUFPU's stem that of its folded input."""
    x, v, ref = references[name]
    if multipliers == "xla":
        _xla_multipliers(monkeypatch)
    net = _port(name, v)
    convs = [m for m in net.modules() if isinstance(m, QConv)]
    assert convs and all(m.act_scale is None for m in convs)
    t = torch.from_numpy(x)

    def run(t):
        with torch.inference_mode():
            if NETS[name][4]:  # the decoder's concat, as the net feeds it: [upsampled, skip]
                return net(t[..., : x.shape[-1] // 2].contiguous(),
                           t[..., x.shape[-1] // 2:].contiguous()).numpy()
            return net(t).numpy()

    got = run(t)
    if multipliers == "port":  # an element alone gives what it gives in its batch
        assert np.array_equal(run(t[1:]), got[1:])
    err = np.abs(got - ref)
    print(f"[parity] dynamic {name} ({multipliers} multipliers): max={err.max():.3e} "
          f"mean={err.mean():.3e}")  # pytest -s
    assert got.shape == ref.shape
    if multipliers == "xla":
        assert float(err.max()) <= 1.5e-7 * max(1.0, float(np.abs(ref).max()))
    else:
        assert float(err.max()) < 1e-2 * max(1.0, float(np.abs(ref).max()))
        assert float(err.mean()) < 2e-4 * max(1.0, float(np.abs(ref).mean()))
