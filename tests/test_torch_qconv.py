"""Parity of the port's int8 3x3 conv (the plain version of the CUDA kernel)
and of its (1, 2) ConvTranspose with the flax modules of azoom.models.unet
(CPU).

The int8 codes are the same by construction (QConv's quantisation formula,
integer accumulation) and the epilogue keeps flax's order of float32
operations, so the cells agree far inside the bound of
tests/test_qconv_pallas.py (relative error < 2e-5).
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from azoom.models.unet import ConvBNRelu as FlaxConvBNRelu
from azoom.models.unet import QConv as FlaxQConv
from azoom.models.unet import ResBlock as FlaxResBlock
from azoom_torch import kernels
from azoom_torch.kernels.convt_kernel import convt1x2_plain
from azoom_torch.kernels.qconv_kernel import (
    epilogue_params, k_padded, pack_weights, qconv3x3, qconv3x3_plain,
)
from azoom_torch.models.convert import load_conv_transpose, load_qconv
from azoom_torch.models.unet import ConvBNRelu, ConvTranspose1x2, QConv, ResBlock


def _np_tree(tree):
    if hasattr(tree, "items"):
        return {k: _np_tree(v) for k, v in tree.items()}
    return np.array(tree)


def _randomize_bn(variables, rng):
    """Non-trivial BatchNorm statistics and affine, so the epilogue's BN
    rows are exercised (init leaves them at identity)."""
    v = _np_tree(variables)

    def walk(tree):
        for name, sub in tree.items():
            if name.startswith("BatchNorm"):
                for leaf, val in sub.items():
                    if leaf == "var":
                        sub[leaf] = (0.5 + rng.random(val.shape)).astype(np.float32)
                    elif leaf == "scale":
                        sub[leaf] = (0.7 + 0.6 * rng.random(val.shape)).astype(np.float32)
                    else:
                        sub[leaf] = (0.3 * rng.standard_normal(val.shape)).astype(np.float32)
            elif isinstance(sub, dict):
                walk(sub)

    walk(v["params"])
    walk(v["batch_stats"])
    return v


def _calibrated(module, x, rng, key=0):
    v = _randomize_bn(module.init(jax.random.PRNGKey(key), x), rng)
    _, mut = module.apply(v, x, mutable=["quant_stats"])
    return {**v, "quant_stats": _np_tree(mut["quant_stats"])}


def _rel(got, ref):
    return float(np.max(np.abs(got - ref)) / (np.max(np.abs(ref)) + 1e-9))


@pytest.mark.parametrize("cin,cout", [(16, 64), (128, 128)])
def test_conv_bn_relu_cell_matches_flax(rng, cin, cout):
    x = rng.standard_normal((2, 9, 8, cin)).astype(np.float32)
    cell = FlaxConvBNRelu(cout, dtype=jnp.float32, quant=True)
    v = _calibrated(cell, x, rng)
    ref = np.asarray(cell.apply(v, x))
    m = ConvBNRelu(cin, cout)
    p, s, q = v["params"], v["batch_stats"], v["quant_stats"]
    with torch.no_grad():
        load_qconv(m.conv, p["Conv_0"], q["Conv_0"]["act_scale"], p["BatchNorm_0"], s["BatchNorm_0"])
    got = m(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape
    assert _rel(got, ref) < 2e-5


def test_resblock_matches_flax(rng):
    x = rng.standard_normal((2, 9, 8, 128)).astype(np.float32)
    block = FlaxResBlock(128, dtype=jnp.float32, quant=True)
    v = _calibrated(block, x, rng, key=1)
    ref = np.asarray(block.apply(v, x))
    m = ResBlock(128)
    p, s, q = v["params"], v["batch_stats"], v["quant_stats"]
    with torch.no_grad():
        for i, conv in enumerate((m.conv0, m.conv1)):
            load_qconv(conv, p[f"Conv_{i}"], q[f"Conv_{i}"]["act_scale"],
                       p[f"BatchNorm_{i}"], s[f"BatchNorm_{i}"])
    assert _rel(m(torch.from_numpy(x)).numpy(), ref) < 2e-5


def test_bare_qconv_matches_flax(rng):
    x = rng.standard_normal((1, 7, 8, 16)).astype(np.float32)
    conv = FlaxQConv(32, (3, 3), dtype=jnp.float32)
    v = _np_tree(conv.init(jax.random.PRNGKey(2), x))
    _, mut = conv.apply(v, x, mutable=["quant_stats"])
    v["quant_stats"] = _np_tree(mut["quant_stats"])
    ref = np.asarray(conv.apply(v, x))
    m = QConv(16, 32)
    with torch.no_grad():
        load_qconv(m, v["params"], v["quant_stats"]["act_scale"])
    got = m(torch.from_numpy(x), relu=False).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_odd_plane(rng):
    """129 folded rows, as the mask net's stem sees them."""
    x = rng.standard_normal((3, 129, 8, 16)).astype(np.float32)
    cell = FlaxConvBNRelu(32, dtype=jnp.float32, quant=True)
    v = _calibrated(cell, x, rng, key=3)
    ref = np.asarray(cell.apply(v, x))
    m = ConvBNRelu(16, 32)
    p, s, q = v["params"], v["batch_stats"], v["quant_stats"]
    with torch.no_grad():
        load_qconv(m.conv, p["Conv_0"], q["Conv_0"]["act_scale"], p["BatchNorm_0"], s["BatchNorm_0"])
    assert _rel(m(torch.from_numpy(x)).numpy(), ref) < 2e-5


def test_integer_accumulation_is_exact_at_cin_256(rng):
    """|acc| reaches 9 * 256 * 127^2 = 3.7e7 > 2^24, beyond float32's exact
    integers: the plain version must still give the int64 sums."""
    cin, cout = 256, 8
    w = np.full((3, 3, cin, cout), 127, np.int8)  # every product at its largest
    xq = np.full((1, 5, 4, cin), 127, np.float32)
    xq[0, 1, 1, :5] = -127
    epi = epilogue_params(1.0, torch.ones(cout), torch.zeros(cout))  # identity epilogue
    got = qconv3x3_plain(torch.from_numpy(xq), pack_weights(torch.from_numpy(w)), epi, 1.0,
                         relu=False).numpy()
    xp = np.pad(xq.astype(np.int64), ((0, 0), (1, 1), (1, 1), (0, 0)))
    ref = np.zeros(got.shape, np.int64)
    for dy in range(3):
        for dx in range(3):
            ref += np.einsum("bftc,cn->bftn", xp[:, dy:dy + 5, dx:dx + 4], w[dy, dx].astype(np.int64))
    assert ref.max() > 2**24
    np.testing.assert_array_equal(got, ref.astype(np.float32))


def test_packed_weight_layout():
    w = torch.arange(3 * 3 * 16 * 8, dtype=torch.int32).reshape(3, 3, 16, 8) % 101 - 50
    packed = pack_weights(w.to(torch.int8))
    assert packed.shape == (8, k_padded(16)) == (8, 160)
    # row n, K index (3*dy + dx) * Cin + c holds w[dy, dx, c, n]; zero padding after 9*Cin
    assert packed[5, (3 * 2 + 1) * 16 + 3] == w[2, 1, 3, 5]
    assert torch.all(packed[:, 144:] == 0)


def test_qconv_wrapper_on_cpu_counts_nothing(rng):
    x = torch.from_numpy(rng.standard_normal((1, 5, 4, 16)).astype(np.float32))
    w = pack_weights(torch.ones((3, 3, 16, 8), dtype=torch.int8))
    epi = epilogue_params(0.01, torch.ones(8), torch.zeros(8))
    before = dict(kernels.launches)
    np.testing.assert_array_equal(qconv3x3(x, w, epi, 0.05).numpy(),
                                  qconv3x3_plain(x, w, epi, 0.05).numpy())
    assert kernels.launches == before


@pytest.mark.parametrize("cin,cout", [(256, 128), (64, 64)])
def test_conv_transpose_matches_flax(rng, cin, cout):
    x = np.abs(rng.standard_normal((2, 9, 8, cin))).astype(np.float32)
    up = nn.ConvTranspose(cout, (1, 2), strides=(1, 2))
    v = _np_tree(up.init(jax.random.PRNGKey(4), x))
    v["params"]["bias"] = (0.1 * rng.standard_normal(cout)).astype(np.float32)
    ref = np.asarray(up.apply(v, x))
    m = ConvTranspose1x2(cin, cout)
    with torch.no_grad():
        load_conv_transpose(m, v["params"])
    got = m(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (2, 9, 16, cout)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def test_conv_transpose_plain_sums_in_order(rng):
    """The plain version is one FMA chain per output in K order; on this
    host's float32 product (MKL) that is bit for bit what torch.matmul gives,
    which is the order the reference's float32 product uses."""
    x = np.abs(rng.standard_normal((1, 7, 4, 128))).astype(np.float32)
    w = (0.05 * rng.standard_normal((128, 64))).astype(np.float32)
    b = np.zeros(32, np.float32)
    got = convt1x2_plain(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b))
    ref = torch.matmul(torch.from_numpy(x), torch.from_numpy(w)).reshape(1, 7, 8, 32)
    assert torch.equal(got, ref)


def test_concat_input_equals_concatenated_tensor(rng):
    """x2 (the decoder's skip, read in place by the kernel) means the channel
    concat [x, x2]."""
    a = torch.from_numpy(rng.standard_normal((1, 6, 4, 8)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((1, 6, 4, 8)).astype(np.float32))
    w = pack_weights(torch.from_numpy(rng.integers(-127, 128, (3, 3, 16, 8)).astype(np.int8)))
    epi = epilogue_params(0.01, torch.ones(8), torch.zeros(8))
    np.testing.assert_array_equal(qconv3x3(a, w, epi, 0.05, x2=b).numpy(),
                                  qconv3x3(torch.cat([a, b], -1), w, epi, 0.05).numpy())
