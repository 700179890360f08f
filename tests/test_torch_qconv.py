"""Parity of the port's int8 3x3 conv (the plain version of the CUDA kernel)
and of its (1, 2) ConvTranspose with the flax modules of azoom.models.unet
(CPU).

The int8 codes are the same by construction (QConv's quantisation formula,
integer accumulation) and the epilogue keeps flax's order of float32
operations, so the cells agree far inside the bound of
tests/test_qconv_pallas.py (relative error < 2e-5).
"""

import functools
import json
from pathlib import Path

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
    SMEM_LIMIT, epilogue_params, k_padded, kernel_cin, pack_weights, plan, qconv3x3,
    qconv3x3_plain,
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


@pytest.mark.parametrize("cin,cout,cin1", [
    pytest.param(16, 64, None, id="16-64"), pytest.param(128, 128, None, id="128-128"),
    # widths of nets trained at other bases (the mma.sync route on the card), and a
    # decoder concat of two 20-channel halves, read in place
    pytest.param(8, 16, None, id="8-16"), pytest.param(20, 24, None, id="20-24"),
    pytest.param(48, 96, None, id="48-96"), pytest.param(40, 24, 20, id="20+20-24")])
def test_conv_bn_relu_cell_matches_flax(rng, cin, cout, cin1):
    x = rng.standard_normal((2, 9, 8, cin)).astype(np.float32)
    cell = FlaxConvBNRelu(cout, dtype=jnp.float32, quant=True)
    v = _calibrated(cell, x, rng)
    ref = np.asarray(cell.apply(v, x))
    m = ConvBNRelu(cin, cout)
    p, s, q = v["params"], v["batch_stats"], v["quant_stats"]
    with torch.no_grad():
        load_qconv(m.conv, p["Conv_0"], q["Conv_0"]["act_scale"], p["BatchNorm_0"], s["BatchNorm_0"])
    t = torch.from_numpy(x)
    got = (m(t) if cin1 is None else m(t[..., :cin1].contiguous(), t[..., cin1:].contiguous())).numpy()
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


@pytest.mark.parametrize("cin,cout", [(256, 128), (64, 64), (10, 5), (6, 3)])
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


# ---- the host-side plan of the CUDA kernels (pure Python) ---------------------

F_ROWS = 129  # folded frequency rows of the mask net: ragged against every tile height
# (Cin, Cout, frames at T = 64 input frames, launches) of the bundled tpufpu_nano net
NANO_SHAPES = [
    (16, 64, 64, 1), (64, 64, 64, 2), (64, 64, 32, 5), (64, 128, 16, 1), (128, 128, 16, 4),
    (128, 256, 8, 1), (256, 256, 8, 4), (256, 128, 16, 1), (128, 64, 32, 1), (128, 64, 64, 1),
]
# (Cin, Cout) of the classic tree (base 64, bottleneck 8, no width division)
CLASSIC_WIDTHS = [
    (16, 64), (64, 64), (64, 128), (128, 128), (128, 256), (256, 256), (256, 512), (512, 512),
    (512, 256), (256, 128), (128, 64),
]


def _smem_as_the_c_side_sums_it(cin, cout, how):
    """Shared memory of a plan, restated from the C entry points (a stem of
    Cin 2 or 4 is 16 channels to the kernels; a split halo holds one part of
    the channels; the narrow route is azt_qconv3x3 at N = Cout; the
    any-width instances, azt_qconv3x3_any, take N = slice_width, pad a halo
    pixel of 16 * odd channels by 32 bytes and their epilogue rows to
    n_slices * N, and keep remade parts in two buffers)."""
    cs = how.get("part_channels", kernel_cin(cin))
    pad = 32 if how["wide"] and cs % 32 else 16
    halo = (how["tile_rows"] + 2) * (how["tile_w"] + 2) * (cs + pad)
    if how["kernel"] == "mma":  # csrc/qconv_mma_kernel.cu: a part's halo + 2 buffers of a
        return halo + 2 * how["slice_width"] * 144  # slice's rows x (128 + 16)
    # csrc/qconv_kernel.cu: alignment slack, weight stages (N = Cout, or 256 on the split
    # route), two halos (a split tile's n_parts, one a part, where it has parts and keeps
    # them), the warps' output patches, 5 epilogue rows of n_slices * N channels, barriers
    # (18 weight stages and 8 halos, full and empty)
    n = how["slice_width"] if how["wide"] else 256 if how["kernel"] == "split" else cout
    parts = how.get("n_parts", 1)
    buffers = 2 if parts == 1 or how.get("remade") else parts
    return (1024 + how["stages"] * n * 128 + buffers * halo + 8 * 16 * 40 * 4
            + 5 * how.get("n_slices", 1) * n * 4 + 52 * 8)


def _check_plan(cin, cout, frames, f_rows=F_ROWS):
    how = plan(cin, cout, frames)
    assert how["smem"] <= SMEM_LIMIT == 232_448
    assert how["smem"] == _smem_as_the_c_side_sums_it(cin, cout, how)
    tw, rows = how["tile_w"], how["tile_rows"]
    # a tile no wider than the plane, but for the split route's (see below)
    assert tw & (tw - 1) == 0 and tw * rows == how["m_tile"]
    assert tw <= max(frames, 1) or how["kernel"] == "split" or how["wide"]
    # whole tiles cover the ragged plane: ceil(F / rows) row tiles, ceil(T / tw) frame tiles
    assert -(-f_rows // rows) * rows >= f_rows and -(-frames // tw) * tw >= frames
    ck = kernel_cin(cin)
    if how["wide"]:
        _check_any_width_plan(cin, cout, frames, how)
        return how
    if how["kernel"] == "wgmma":
        assert cin % 32 == 0 and cout in (64, 128, 256) and tw <= 64
        assert how["m_tile"] == (256 if cout == 64 else 128)
        assert how["k_chunks"] == -(-9 * cin // 128) and k_padded(cin) == 9 * cin
    if how["kernel"] == "narrow":
        # csrc/qconv_kernel.cu at 16-channel taps (the stems, Cout of 32 or 64) or N = 32
        assert (ck == 16 and cout in (32, 64)) or (cin % 32 == 0 and cout == 32)
        assert tw <= 64 and how["m_tile"] == (512 if cout == 32 else 256)
        # the tensor map reads the packed rows: 160 bytes at 16-channel taps, else 9 * Cin
        assert how["k_chunks"] == -(-k_padded(cin) // 128)
        assert k_padded(cin) == (160 if ck == 16 else 9 * cin)
    if how["kernel"] in ("wgmma", "narrow"):
        assert min(3, how["k_chunks"]) <= how["stages"] <= min(how["k_chunks"], 18)
        assert how["resident"] == (how["stages"] == how["k_chunks"])
        # one more stage would not have fit
        assert how["resident"] or how["stages"] == 18 or how["smem"] + cout * 128 > SMEM_LIMIT
    elif how["kernel"] == "split":
        assert cin % 32 == 0 and cout in (256, 512) and tw <= 64 and how["m_tile"] == 128
        cs, parts = how["part_channels"], how["n_parts"]
        assert cs * parts == cin and (parts == 1 or cs % 128 == 0)
        assert how["n_slices"] == cout // 256
        assert how["k_chunks"] == -(-9 * cs // 128)
        # each part made once a tile in a buffer of its own (two buffers for one part) beside
        # three weight stages, or two where there are more buffers than two
        assert how["halo_buffers"] == max(2, parts)
        assert (3 if parts <= 2 else 2) <= how["stages"] <= 18
        assert how["halo_bytes"] == (rows + 2) * (tw + 2) * cin * 4
        # the widest part that fits: parts twice as wide would leave room for too few stages
        if parts > 1:
            wider = dict(how, part_channels=2 * cs, n_parts=parts // 2)
            assert _smem_as_the_c_side_sums_it(cin, cout, wider) - how["stages"] * 256 * 128 \
                + (3 if parts <= 4 else 2) * 256 * 128 > SMEM_LIMIT
        # the tile is the power of two just below or just above the frames (up to 64) that
        # pads them least: 8 for 6 or 7 frames, 4 for 4
        lo = 1 << (min(frames, 64).bit_length() - 1)
        widths = {lo, min(2 * lo, 64)}
        assert tw in widths and -(-frames // tw) * tw == min(-(-frames // w) * w for w in widths)
    else:
        # slices of the least of 32, 64, 128, 256 output channels that holds Cout, else of
        # 256; one of 512 at Cout = 512
        nb = how["slice_width"]
        assert how["kernel"] == "mma" and nb == (
            512 if cout == 512 else min(max(32, 1 << (cout - 1).bit_length()), 256))
        assert how["m_tile"] == 256 * 64 // nb
        assert how["n_slices"] == -(-cout // nb)
        # the halo in parts of Cp channels (a multiple of 16) that cover kernel_cin(Cin); one
        # part where all fit, else the fewest: one part fewer would not have fit
        cp, parts = how["part_channels"], how["n_parts"]
        assert cp % 16 == 0 and (parts - 1) * cp < ck <= parts * cp
        if parts > 1:
            fewer = -(-ck // (16 * (parts - 1))) * 16
            assert (rows + 2) * (tw + 2) * (fewer + 16) + 2 * nb * 144 > SMEM_LIMIT
        assert how["k_chunks"] == parts * -(-(-(-9 * cp // 32) * 32) // 128)
    return how


def _check_any_width_plan(cin, cout, frames, how):
    """csrc/qconv_kernel.cu's any-width instances (azt_qconv3x3_any): Cout
    on the least N of 32, 64, 128, 256 that holds it, or in slices of 256;
    the halo of all kernel_cin(Cin) channels in two buffers, or in parts of a
    multiple of 128 channels, kept (a buffer each, at most 8) or remade for
    every slice (two buffers); the weights stay only at one slice and part."""
    ck, tw, rows = kernel_cin(cin), how["tile_w"], how["tile_rows"]
    n, slices = how["slice_width"], how["n_slices"]
    assert n == min(max(32, 1 << (cout - 1).bit_length()), 256) and slices == -(-cout // n)
    assert how["m_tile"] == {32: 512, 64: 256}.get(n, 128) and tw <= 64
    cs, parts = how["part_channels"], how["n_parts"]
    assert cs * parts == ck and (parts == 1 or cs % 128 == 0)
    assert how["remade"] or parts <= 8
    assert how["halo_buffers"] == (2 if parts == 1 or how["remade"] else parts)
    assert how["k_chunks"] == -(-9 * cs // 128)
    assert how["resident"] == (slices * parts == 1 and how["stages"] == how["k_chunks"])
    assert 2 <= how["stages"] <= 18 or how["resident"]
    made = slices if how["remade"] else 1
    assert how["halo_bytes"] == made * (rows + 2) * (tw + 2) * cin * 4
    assert how["weight_bytes"] == (0 if how["resident"] else slices * parts * how["k_chunks"] * n * 128)
    assert how["kernel"] == ("split" if slices * parts > 1 else
                             "narrow" if n == 32 or ck == 16 else "wgmma")
    # the tile is as wide as pads the frames least, or narrower where that does not fit
    lo = 1 << (min(frames, 64).bit_length() - 1)
    widths = {lo, min(2 * lo, 64)}
    best = min(-(-frames // w) * w for w in widths)
    assert tw in widths and -(-frames // tw) * tw == best or tw < lo


@pytest.mark.parametrize("cin,cout,frames,launches", NANO_SHAPES)
def test_plan_of_the_nano_shapes(cin, cout, frames, launches):
    how = _check_plan(cin, cout, frames)
    # wgmma wherever the net spends its time; the 16-channel stem on the narrow route
    assert how["kernel"] == ("narrow" if cin == 16 else "wgmma")
    if cin >= 64:  # the weights stay in shared memory unless they are 295 KB or more (147 KB fits)
        assert how["resident"] == (9 * cin * cout < 200_000)


def test_plan_keeps_weights_resident_for_15_of_the_21_convs():
    def count(pred):
        return sum(n for cin, cout, t, n in NANO_SHAPES if pred(plan(cin, cout, t)))

    resident = count(lambda how: how["resident"])
    on_wgmma = count(lambda how: how["kernel"] == "wgmma")
    on_narrow = count(lambda how: how["kernel"] == "narrow")
    assert (resident, on_wgmma, on_narrow) == (15, 20, 1)  # the 15th is the stem, on narrow


@pytest.mark.parametrize("frames", [1, 7, 8, 64])
@pytest.mark.parametrize("cin,cout", CLASSIC_WIDTHS)
def test_plan_of_the_classic_widths(cin, cout, frames):
    how = _check_plan(cin, cout, frames)
    if cin % 32:  # the 16-channel stem
        assert how["kernel"] == "narrow"
    elif cout == 512:  # split, but where no split tile fits its stages: at one frame, and
        # 512 -> 512 on 64-frame tiles, whose four parts' halos leave no room for two, the
        # any-width instances' slices and parts
        on_any = frames == 1 or (cin == 512 and frames == 64)
        assert how["kernel"] == "split" and how["wide"] == on_any
    if how["kernel"] == "mma":  # one block takes all Cout channels and the halo of all Cin
        assert (how["n_slices"], how["n_parts"], how["m_tile"]) == (1, 1, 256 * 64 // cout)


@pytest.mark.parametrize("cin,cout,frames", [(64, 64, 0), (2, 32, 0), (0, 32, 8), (32, 0, 8)])
def test_plan_refuses_what_no_kernel_takes(cin, cout, frames):
    """Only an empty conv: every positive Cin, Cout and frame count has a route."""
    with pytest.raises(ValueError, match="qconv3x3"):
        plan(cin, cout, frames)


# (Cin, Cout) of widths the reference's QConv serves (an XLA conv at any width: a net
# trained at any --base) that the bundled nets' routes of csrc/qconv_kernel.cu do not take
ANY_WIDTHS = (
    [(8, 64), (24, 64), (64, 96), (1, 32), (3, 32), (8, 32), (2, 16), (4, 48), (32, 1024),
     (20, 32)]
    + [(64, c) for c in (1, 8, 16, 24, 48, 96, 768, 1024)]
    + [(c, 48) for c in (1, 3, 8, 20, 24, 48, 1024, 2048, 4096)]
    + [(4096, 1024), (2048, 768), (1024, 1024), (1024, 512), (512, 1024), (40, 20), (5, 10)])


@pytest.mark.parametrize("cin,cout", ANY_WIDTHS)
def test_plan_routes_every_width_the_reference_serves(cin, cout):
    """At 1 ... 80 frames and at 4,096 each width goes to the any-width
    instances of csrc/qconv_kernel.cu, on slices of output channels that
    cover Cout and halo parts that cover Cin, its shared memory within the
    limit; the mma.sync kernel takes only the inputs those do not read (Cin of
    1, 3 or 5: neither a multiple of 4 nor 2) and one-frame planes at large
    Cin on their 512- and 256-pixel tiles (N = 32 and 64), whose halos fit in
    no part."""
    for frames in list(range(1, 81)) + [4096]:
        how = _check_plan(cin, cout, frames)
        assert how["n_slices"] * how["slice_width"] >= cout
        assert how["n_parts"] * how["part_channels"] >= kernel_cin(cin)
        unread = cin % 4 and cin != 2
        if how["kernel"] == "mma":
            assert unread or (frames == 1 and cout <= 64), (frames, how)
        else:
            assert how["wide"] and not unread, (frames, how)


# the routes of csrc/qconv_kernel.cu take these output widths; the rest take a slice width
# of the mma.sync kernel at its edges (1, 32 +- 1, ...) and the widest Cout
PLAN_COUTS = [1, 31, 32, 33, 64, 65, 128, 129, 256, 257, 512, 513, 4096]


@pytest.mark.parametrize("cout", PLAN_COUTS)
def test_plan_fits_every_cin_and_frame_count(cout):
    """Every Cin of 1 ... 4,096 at this Cout gets a plan whose shared memory
    fits at frame counts that give every tile width (powers of two up to 64
    and the mma.sync kernel's 512-pixel tiles, 1 ... 4,096 frames): a plan
    depends on the frames only through its tile's width, the largest power
    of two up to min(frames, tile), and on Cout only through the slice width
    beside the routes' own widths, which these Couts span."""
    fresh = plan.__wrapped__  # uncached: 53,248 plans
    for cin in range(1, 4097):
        for frames in (1, 2, 3, 4, 8, 16, 32, 64, 80, 128, 256, 512, 4096):
            how = fresh(cin, cout, frames)
            assert how["smem"] <= SMEM_LIMIT, (cin, frames, how)
            if how["kernel"] == "mma" or how["wide"]:
                assert how["n_parts"] * how["part_channels"] >= kernel_cin(cin)


@pytest.mark.parametrize("cin,cout,cin1", [(64, 64, 30), (64, 128, 2), (16, 32, 6), (256, 256, 126),
                                           (512, 512, 250), (64, 64, 32)])
def test_a_concat_of_halves_not_multiples_of_4_goes_to_mma(cin, cout, cin1):
    """csrc/qconv_kernel.cu loads each input in float4: a concat whose halves
    are not multiples of 4 channels goes to the mma.sync kernel, which loads
    such a half channel by channel; whole float4 halves keep their route."""
    how = plan(cin, cout, 64, cin1)
    if cin1 % 4:
        assert how["kernel"] == "mma" and how["smem"] <= SMEM_LIMIT
    else:
        assert how == plan(cin, cout, 64)


@pytest.mark.parametrize("cin", [32, 64, 96, 128, 256, 512])
def test_packed_rows_have_no_padding_where_wgmma_reads_them(cin):
    """The TMA tensor map of the wgmma kernel takes the packed rows as they
    are: exactly 9 * Cin bytes (a multiple of 16) at Cin % 32 == 0; only
    Cin % 32 != 0 pads: the 16-channel taps' rows (the narrow route: 144
    bytes and 16 zeros, two K chunks) and, on the any-width instances, taps
    of 16 * odd channels (48: 432 bytes and 16 zeros, four K chunks)."""
    assert k_padded(cin) == 9 * cin and (9 * cin) % 16 == 0
    assert k_padded(16) == k_padded(2) == k_padded(4) == 160 and k_padded(48) == 448
    assert plan(16, 64, 64)["k_chunks"] == plan(2, 32, 64)["k_chunks"] == 2
    how = plan(48, 64, 64)
    assert (how["kernel"], how["wide"], how["k_chunks"], how["resident"]) == ("wgmma", True, 4, True)


# (Cin, Cout, frames at T = 64) of the base-32 nets on unfolded 513-row planes:
# FreqPreservingUNet (logmag_ipd stem of 2 channels) and DeepFPU (physics stem
# of 4, a 512-wide bottleneck at 4 frames)
FPU_SHAPES = [
    (2, 32, 64), (32, 32, 64), (32, 64, 32), (64, 64, 32), (64, 128, 16), (128, 128, 16),
    (128, 256, 8), (256, 256, 8), (256, 128, 16), (128, 64, 32), (64, 32, 64),
]
DEEPFPU_SHAPES = FPU_SHAPES[1:] + [(4, 32, 64), (256, 512, 4), (512, 512, 4), (512, 256, 8)]


@pytest.mark.parametrize("cin,cout,frames", sorted(set(FPU_SHAPES + DEEPFPU_SHAPES)))
def test_plan_of_the_base32_shapes(cin, cout, frames):
    how = _check_plan(cin, cout, frames, f_rows=513)
    # narrow: the stems and Cout of 32; split: Cout of 512 and 512 -> 256 (two halos of all
    # 512 channels leave no room for 3 weight stages)
    on_narrow = cin in (2, 4) or cout == 32
    on_split = cout == 512 or (cin, cout) == (512, 256)
    assert how["kernel"] == ("narrow" if on_narrow else "split" if on_split else "wgmma")
    if cout == 32:
        assert how["m_tile"] == 512 and how["tile_w"] * how["tile_rows"] == 512


# (Cin, Cout, frames at T = 64) of the bundled tpufpu net (129 folded rows), whose
# bottleneck is 512 wide, and of the nano net's tree, at the server's frame families
TPUFPU_SHAPES = [
    (16, 64, 64), (64, 64, 64), (64, 128, 32), (128, 64, 64), (128, 128, 32), (128, 256, 16),
    (256, 128, 32), (256, 256, 16), (256, 512, 8), (512, 256, 16), (512, 512, 8),
]


def _family(shapes, frames):
    """A net's shapes at ``frames`` input frames instead of 64."""
    return [(cin, cout, t * frames // 64) for cin, cout, t in shapes]


ROUTE_CASES = sorted(
    {(shape, F_ROWS) for frames in (48, 80)
     for shape in _family([s[:3] for s in NANO_SHAPES], frames)}
    | {(shape, F_ROWS) for frames in (48, 64, 80) for shape in _family(TPUFPU_SHAPES, frames)}
    | {(shape, 513) for frames in (48, 64, 80)
       for shape in _family(DEEPFPU_SHAPES + FPU_SHAPES[:1], frames)})


@pytest.mark.parametrize("shape,rows", ROUTE_CASES, ids=lambda v: "x".join(map(str, v))
                         if isinstance(v, tuple) else str(v))
def test_every_bundled_shape_has_a_route_that_fits(shape, rows):
    """The server's frame families (48 and 80 frames) at every depth of the
    nano tree, and tpufpu's, DeepFPU's and fpu's shapes at 48, 64 and 80
    frames: each goes to a kernel whose shared memory fits, none to
    mma.sync: the stems and Cout = 32 on the narrow route, every other shape
    on wgmma or split (the 256 -> 256 at 6 frames of the reuse tick on the
    split route)."""
    cin, cout, frames = shape
    how = _check_plan(cin, cout, frames, f_rows=rows)
    assert how["smem"] <= SMEM_LIMIT
    assert how["kernel"] != "mma"
    assert (how["kernel"] == "narrow") == (cin in (2, 4, 16) or cout == 32)
    if (cin, cout, frames) == (256, 256, 6):
        assert how["kernel"] == "split" and how["tile_w"] == 8 and how["stages"] == 3


# (Cin, Cout) of the bundled nets' stems and Cout = 32 convs, and the other
# stems the narrow route takes
NARROW_WIDTHS = [(2, 32), (4, 32), (16, 64), (32, 32), (64, 32), (16, 32), (2, 64), (4, 64)]


@pytest.mark.parametrize("rows", [513, 129, 131])
@pytest.mark.parametrize("cin,cout", NARROW_WIDTHS)
def test_stems_and_cout_32_fit_a_route_at_every_frame_count(cin, cout, rows):
    """At T = 1 ... 80 frames each stem and Cout = 32 width gets a route
    whose shared memory fits: the narrow route, but at one frame for
    Cin = 64 (a 512-row tile's two halos of 80-byte pixels are 247 KB),
    which mma.sync takes."""
    for frames in range(1, 81):
        how = _check_plan(cin, cout, frames, f_rows=rows)
        assert how["kernel"] == ("mma" if (cin, frames) == (64, 1) else "narrow"), frames
        assert how["tile_w"] == min(1 << (frames.bit_length() - 1), 64)
        assert how["resident"] or how["kernel"] == "mma"  # at most 5 chunks of 32 x 128 bytes


def test_stem_weights_pack_as_16_channels():
    """Cin 2 or 4 is packed as if Cin were 16, the taps' other channels zero:
    the kernel's zero-extended halo then gives the same int32 sums."""
    w = torch.arange(3 * 3 * 2 * 32, dtype=torch.int32).reshape(3, 3, 2, 32) % 101 - 50
    packed = pack_weights(w.to(torch.int8))
    assert kernel_cin(2) == kernel_cin(4) == 16 and kernel_cin(32) == 32
    assert packed.shape == (32, k_padded(2)) == (32, 160)
    for dy, dx, c, n in ((0, 0, 1, 0), (2, 1, 0, 31), (1, 2, 1, 7)):
        assert packed[n, (3 * dy + dx) * 16 + c] == w[dy, dx, c, n]
    taps = packed[:, :144].reshape(32, 9, 16)
    assert torch.all(taps[..., 2:] == 0) and torch.all(packed[:, 144:] == 0)


@pytest.mark.parametrize("cin,cout", [(2, 32), (4, 32), (32, 32), (64, 32), (4, 64)])
def test_plain_conv_at_the_base32_widths_matches_an_integer_reference(rng, cin, cout):
    """The plain version at the stems and at Cout = 32 against an int64 conv
    of the same codes and the epilogue's float32 order in numpy."""
    x = (rng.standard_normal((2, 7, 5, cin)) * 2).astype(np.float32)
    w = rng.integers(-127, 128, (3, 3, cin, cout)).astype(np.int8)
    s = np.float32(0.02)
    epi = epilogue_params(float(s), torch.from_numpy(rng.random(cout).astype(np.float32) * 1e-2),
                          torch.from_numpy(rng.standard_normal(cout).astype(np.float32)),
                          tuple(torch.from_numpy(a.astype(np.float32)) for a in (
                              1 + 0.1 * rng.standard_normal(cout), rng.standard_normal(cout),
                              rng.standard_normal(cout), 0.5 + rng.random(cout))))
    got = qconv3x3_plain(torch.from_numpy(x), pack_weights(torch.from_numpy(w)), epi, float(s),
                         relu=False).numpy()
    xq = np.clip(np.round(x / s), -127, 127).astype(np.int64)
    xp = np.pad(xq, ((0, 0), (1, 1), (1, 1), (0, 0)))
    acc = np.zeros(got.shape, np.int64)
    for dy in range(3):
        for dx in range(3):
            acc += np.einsum("bftc,cn->bftn", xp[:, dy:dy + 7, dx:dx + 5], w[dy, dx].astype(np.int64))
    e = epi.numpy()
    ref = ((acc.astype(np.float32) * e[0] + e[1]) - e[2]) * e[3] + e[4]
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("cin,cout", [(8, 16), (20, 24), (1, 8), (3, 5)])
def test_packed_weights_of_any_cin_match_an_integer_reference(rng, cin, cout):
    """A Cin that is not a multiple of 16 packs as kernel_cin(Cin) channels a
    tap, those beyond Cin zero (8 -> 16, 160 bytes a row; 20 -> 32, 288),
    and the plain conv of those rows is an int64 conv of the same codes
    with the epilogue's float32 order."""
    ck = kernel_cin(cin)
    assert ck == -(-cin // 16) * 16 and k_padded(cin) == -(-9 * ck // 32) * 32
    assert (kernel_cin(8), k_padded(8), kernel_cin(20), k_padded(20)) == (16, 160, 32, 288)
    w = rng.integers(-127, 128, (3, 3, cin, cout)).astype(np.int8)
    packed = pack_weights(torch.from_numpy(w))
    assert packed.shape == (cout, k_padded(cin))
    taps = packed[:, :9 * ck].reshape(cout, 3, 3, ck).numpy()
    np.testing.assert_array_equal(taps[..., :cin], w.transpose(3, 0, 1, 2))
    assert not taps[..., cin:].any() and not packed[:, 9 * ck:].any()
    x = (rng.standard_normal((2, 6, 5, cin)) * 2).astype(np.float32)
    s = np.float32(0.02)
    epi = epilogue_params(float(s), torch.from_numpy(rng.random(cout).astype(np.float32) * 1e-2),
                          torch.from_numpy(rng.standard_normal(cout).astype(np.float32)))
    got = qconv3x3_plain(torch.from_numpy(x), packed, epi, float(s), relu=False).numpy()
    xp = np.pad(np.clip(np.round(x / s), -127, 127).astype(np.int64),
                ((0, 0), (1, 1), (1, 1), (0, 0)))
    acc = np.zeros(got.shape, np.int64)
    for dy in range(3):
        for dx in range(3):
            acc += np.einsum("bftc,cn->bftn", xp[:, dy:dy + 6, dx:dx + 5], w[dy, dx].astype(np.int64))
    e = epi.numpy()
    np.testing.assert_array_equal(got, ((acc.astype(np.float32) * e[0] + e[1]) - e[2]) * e[3] + e[4])


@functools.cache
def _bundled_conv_shapes(name, frames):
    from azoom_torch.models.pretrained import load_bundled
    from azoom_torch.models.unet import TPUFPU, conv_shapes

    torch.set_num_threads(1)
    model, _ = load_bundled(name, device="cpu")
    rows = F_ROWS if isinstance(model, TPUFPU) else 513
    return rows, sorted({c[:3] for c in conv_shapes(model, frames)})


@pytest.mark.parametrize("name", ["tpufpu_nano", "tpufpu", "tpufpu_slim", "fpu", "deepfpu",
                                  "fpu_multigeo"])
def test_the_route_cases_hold_every_bundled_conv(name):
    """Every 3x3 conv of every bundled conv net at 48, 64 and 80 frames is a
    case of test_every_bundled_shape_has_a_route_that_fits (or, the nano net
    at 64 frames, of test_plan_of_the_nano_shapes), on its net's rows: the
    shape lists there are the nets' own."""
    cases = set(ROUTE_CASES) | {(s[:3], F_ROWS) for s in NANO_SHAPES}
    for frames in (48, 64, 80):
        rows, shapes = _bundled_conv_shapes(name, frames)
        missing = [s for s in shapes if (s, rows) not in cases]
        assert not missing, (frames, missing)


@pytest.mark.parametrize("name", ["tpufpu_nano", "tpufpu", "tpufpu_slim", "fpu", "deepfpu",
                                  "fpu_multigeo", "fpu_reverb"])
def test_every_bundled_conv_on_mma_takes_all_its_channels_in_one_block(name):
    """At 16, 32, 48, 64 and 80 input frames (the pipelines pad the frames to
    a multiple of 16) no bundled net's conv goes to the mma.sync kernel: the
    convs that the bundled routes do not fit (the one- and two-frame planes
    of tpufpu and deepfpu at large Cin) go to the any-width instances, in
    whole slices of 256 output channels (the bundled widths need no mask)."""
    from azoom_torch.models.pretrained import load_bundled
    from azoom_torch.models.unet import conv_shapes

    torch.set_num_threads(1)
    model, _ = load_bundled(name, device="cpu")
    on_any = 0
    for frames in range(16, 81, 16):
        for cin, cout, t, _, cat in conv_shapes(model, frames):
            how = plan(cin, cout, t, cin // 2 if cat else None)
            assert how["kernel"] != "mma", (cin, cout, t)
            if how["wide"]:
                on_any += 1
                assert how["n_slices"] * how["slice_width"] == cout, (cin, cout, t)
    assert on_any > 0 or name not in ("tpufpu", "deepfpu")


# nets trained at other bases (cli/train.py's --base takes any integer), served int8: the
# three conv net classes at six bases each, and DeepFPU at 64 (its 1024-channel bottleneck)
TRAINED_BASES = [(cls, base) for cls in ("FreqPreservingUNet", "DeepFPU", "TPUFPU")
                 for base in (8, 16, 24, 40, 48, 96)] + [("DeepFPU", 64)]
# (Cin, Cout) the routes of csrc/qconv_kernel.cu are built for: the bundled nets' widths
ROUTE_WIDTHS = {(cin, cout) for cin in (2, 4, 16) for cout in (32, 64)} | {
    (cin, cout) for cin in range(32, 4097, 32) for cout in (32, 64, 128, 256, 512)}


@functools.cache
def _trained_net_convs(cls, base):
    """(Cin1 at a concat or None, Cin, Cout, frames at T = 64) of each 3x3
    conv of the serving net ``cls`` at ``base``, read by hooks from a
    forward of a zero input on the CPU: the net's own list."""
    from azoom_torch.models import unet

    model = getattr(unet, cls)(base=base, in_channels=2 if cls == "FreqPreservingUNet" else 4)
    calls = []

    def hook(conv, args, kwargs):
        x, x2 = args[0], kwargs.get("x2")
        calls.append((None if x2 is None else x.shape[-1],
                      x.shape[-1] + (0 if x2 is None else x2.shape[-1]), conv.cout, x.shape[-2]))

    for m in model.modules():
        if isinstance(m, QConv):
            m.register_forward_pre_hook(hook, with_kwargs=True)
    with torch.inference_mode():
        model(torch.zeros((1, 3, 64, model.in_channels)))
    return calls


@pytest.mark.parametrize("cls,base", TRAINED_BASES, ids=lambda v: str(v))
def test_every_conv_of_a_net_at_any_base_has_a_route_that_fits(cls, base):
    """Every conv of the int8 net at the 64-frame window's levels and at the
    server's 80- and 48-frame families gets a route whose shared memory
    fits: a width that the bundled routes of csrc/qconv_kernel.cu are not
    built for goes to its any-width instances, the mma.sync kernel only where
    none fits (kernel_cin(Cin) not a multiple of 128, whose halo has no parts:
    base 40's 320 channels), and the concats (halves that are multiples of 4
    channels at these bases) keep the plan of their whole width."""
    convs = _trained_net_convs(cls, base)
    assert len(convs) == {"FreqPreservingUNet": 14, "DeepFPU": 27, "TPUFPU": 21}[cls]
    rows = F_ROWS if cls == "TPUFPU" else 513
    for cin1, cin, cout, t64 in convs:
        for frames in (64, 80, 48):
            t = t64 * frames // 64
            how = _check_plan(cin, cout, t, f_rows=rows)
            assert plan(cin, cout, t, cin1) == how
            if (cin, cout) not in ROUTE_WIDTHS:
                assert how["wide"] or (how["kernel"] == "mma" and kernel_cin(cin) % 128), (
                    cin, cout, t)


# (Cin, Cout, frames, Cin1 at a concat) of the any-width instances: masked Cout (5, 24,
# 48, 96, 192, 384), taps of 16 * odd channels (48, 80), a stem of 2 channels, halo parts
# kept for every slice (384 -> 384, 512 -> 1024) or remade for each (1024 -> 1024,
# 1024 -> 512 at a concat, 2048 -> 1024), and the plan each must take
ANY_WIDTH_PLANS = [
    ((2, 48, 64, None), dict(kernel="narrow", slice_width=64, n_parts=1, resident=True)),
    ((16, 24, 64, None), dict(kernel="narrow", slice_width=32, n_parts=1, resident=True)),
    ((48, 48, 64, None), dict(kernel="wgmma", slice_width=64, part_channels=48, resident=True)),
    ((80, 5, 7, None), dict(kernel="narrow", slice_width=32, tile_w=8, n_parts=1)),
    ((96, 192, 16, None), dict(kernel="wgmma", slice_width=256, resident=False)),
    ((192, 384, 8, None), dict(kernel="split", n_slices=2, n_parts=1, remade=False)),
    ((384, 384, 8, None), dict(kernel="split", n_slices=2, n_parts=3, remade=False,
                               halo_buffers=3)),
    ((384, 192, 16, 192), dict(kernel="split", n_slices=1, n_parts=3, halo_buffers=2)),
    ((512, 1024, 4, None), dict(kernel="split", n_slices=4, n_parts=2, remade=False)),
    ((1024, 1024, 4, None), dict(kernel="split", n_slices=4, n_parts=4, remade=True,
                                 halo_buffers=2, part_channels=256, stages=2)),
    ((1024, 512, 8, 512), dict(kernel="split", n_slices=2, n_parts=4, remade=True)),
    ((2048, 1024, 8, None), dict(kernel="split", n_slices=4, n_parts=8, remade=True)),
]


@pytest.mark.parametrize("shape,expect", ANY_WIDTH_PLANS, ids=lambda v: "x".join(
    str(c) for c in v if c is not None) if isinstance(v, tuple) else None)
def test_any_width_plan_takes_its_shared_memory_as_the_c_side_sums_it(shape, expect):
    """A masked-Cout or remade-part plan of the any-width instances: its
    shared memory is azt_qconv3x3_any's own sum (epilogue rows padded to
    n_slices * N, a halo pixel of 16 * odd channels padded by 32 bytes,
    remade parts in two buffers) and within the limit; one weight stage more
    would not fit, nor, where it has parts, all channels in two buffers."""
    cin, cout, frames, cin1 = shape
    how = plan(cin, cout, frames, cin1)
    assert how == plan(cin, cout, frames) and how["wide"]
    assert {k: how[k] for k in expect} == expect
    _check_plan(cin, cout, frames, f_rows=513)
    assert how["smem"] == _smem_as_the_c_side_sums_it(cin, cout, how) <= SMEM_LIMIT
    n = how["slice_width"]
    if not how["resident"] and how["stages"] < 18:
        assert how["smem"] + n * 128 > SMEM_LIMIT
    if how["n_parts"] > 1:  # the fewest parts: all channels in two buffers did not fit
        whole = dict(how, part_channels=kernel_cin(cin), n_parts=1, stages=2)
        assert _smem_as_the_c_side_sums_it(cin, cout, whole) > SMEM_LIMIT


# the bases the port serves int8 at on the Hopper routes alone, at every frame family
HOPPER_BASES = [(cls, base) for cls in ("FreqPreservingUNet", "DeepFPU", "TPUFPU")
                for base in (16, 24, 48, 64)]


@pytest.mark.parametrize("cls,base", HOPPER_BASES, ids=lambda v: str(v))
def test_every_conv_of_a_net_at_bases_16_to_64_runs_on_a_hopper_route(cls, base):
    """FreqPreservingUNet, DeepFPU and TPUFPU at bases 16, 24, 48 and 64, at
    48, 64 and 80 frames: every conv plans to a route of csrc/qconv_kernel.cu
    (its any-width instances where the bundled routes are not built for the
    width), none to the mma.sync kernel, each within the shared memory."""
    rows = F_ROWS if cls == "TPUFPU" else 513
    kinds = set()
    for cin1, cin, cout, t64 in _trained_net_convs(cls, base):
        for frames in (48, 64, 80):
            t = t64 * frames // 64
            how = _check_plan(cin, cout, t, f_rows=rows)
            assert plan(cin, cout, t, cin1) == how
            assert how["kernel"] in ("wgmma", "narrow", "split"), (cin, cout, t)
            kinds.add(how["wide"])
    # at base 64 only DeepFPU's 1024-channel convs leave the bundled widths
    assert (True in kinds) == (base != 64 or cls == "DeepFPU")


def _bundled_plans_of_the_parent():
    """The parent tree's plan of every bundled conv shape at 48, 64 and 80
    frames, field for field (tests/torch_qconv_bundled_plans.json: keys
    "Cin Cout frames Cin1", Cin1 "-" but at a concat)."""
    path = Path(__file__).with_name("torch_qconv_bundled_plans.json")
    return {tuple(None if v == "-" else int(v) for v in key.split()): how
            for key, how in json.loads(path.read_text()).items()}


@pytest.mark.parametrize("name", ["tpufpu_nano", "tpufpu", "tpufpu_slim", "fpu", "deepfpu",
                                  "fpu_multigeo", "fpu_reverb"])
def test_bundled_plans_equal_the_parents(name):
    """The bundled nets keep their routes: at 48, 64 and 80 frames each conv's
    plan equals the one before the any-width instances, for every field that
    plan had (the any-width instances add ``wide``, False here)."""
    from azoom_torch.models.pretrained import load_bundled
    from azoom_torch.models.unet import conv_shapes

    torch.set_num_threads(1)
    model, _ = load_bundled(name, device="cpu")
    parent = _bundled_plans_of_the_parent()
    for frames in (48, 64, 80):
        for cin, cout, t, _, cat in conv_shapes(model, frames):
            key = (cin, cout, t, cin // 2 if cat else None)
            how = plan(*key)
            assert not how["wide"] and {k: how[k] for k in parent[key]} == parent[key], key
