"""Parity of the port's int8 3x3 conv (the plain version of the CUDA kernel)
and of its (1, 2) ConvTranspose with the flax modules of azoom.models.unet
(CPU).

The int8 codes are the same by construction (QConv's quantisation formula,
integer accumulation) and the epilogue keeps flax's order of float32
operations, so the cells agree far inside the bound of
tests/test_qconv_pallas.py (relative error < 2e-5).
"""

import functools

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
    """Shared memory of a plan, restated from the three C entry points (a
    stem of Cin 2 or 4 is 16 channels to the kernels; a split halo holds one
    part of the channels; the narrow route is azt_qconv3x3 at N = Cout)."""
    cs = how.get("part_channels", kernel_cin(cin))
    halo = (how["tile_rows"] + 2) * (how["tile_w"] + 2) * (cs + 16)
    if how["kernel"] == "mma":  # csrc/qconv_mma_kernel.cu: halo + 2 buffers of Cout x (128 + 16)
        return halo + 2 * cout * 144
    # csrc/qconv_kernel.cu: alignment slack, weight stages (N = Cout, or 256 on the split
    # route), two halos (a split tile's n_parts, one a part, where it has parts), the warps'
    # output patches, 5 epilogue rows, barriers (18 weight stages and 8 halos, full and empty)
    n = 256 if how["kernel"] == "split" else cout
    buffers = max(2, how.get("n_parts", 1))
    return (1024 + how["stages"] * n * 128 + buffers * halo + 8 * 16 * 40 * 4 + 5 * cout * 4
            + 52 * 8)


def _check_plan(cin, cout, frames, f_rows=F_ROWS):
    how = plan(cin, cout, frames)
    assert how["smem"] <= SMEM_LIMIT == 232_448
    assert how["smem"] == _smem_as_the_c_side_sums_it(cin, cout, how)
    tw, rows = how["tile_w"], how["tile_rows"]
    # a tile no wider than the plane, but for the split route's (see below)
    assert tw & (tw - 1) == 0 and tw * rows == how["m_tile"]
    assert tw <= max(frames, 1) or how["kernel"] == "split"
    # whole tiles cover the ragged plane: ceil(F / rows) row tiles, ceil(T / tw) frame tiles
    assert -(-f_rows // rows) * rows >= f_rows and -(-frames // tw) * tw >= frames
    ck = kernel_cin(cin)
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
        assert how["kernel"] == "mma" and how["m_tile"] == 256 * 64 // cout
    return how


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
        # 512 -> 512 on 64-frame tiles, whose four parts' halos leave no room for two
        on_mma = frames == 1 or (cin == 512 and frames == 64)
        assert how["kernel"] == ("mma" if on_mma else "split")


@pytest.mark.parametrize("cin,cout,frames", [
    (8, 64, 8), (24, 64, 8), (64, 96, 8), (64, 64, 0), (1, 32, 8), (3, 32, 8), (8, 32, 8),
    (2, 16, 8), (4, 48, 8), (32, 1024, 8), (2, 32, 0), (20, 32, 8)])
def test_plan_refuses_what_no_kernel_takes(cin, cout, frames):
    with pytest.raises(ValueError, match="qconv3x3"):
        plan(cin, cout, frames)


@pytest.mark.parametrize("cin", [32, 64, 96, 128, 256, 512])
def test_packed_rows_have_no_padding_where_wgmma_reads_them(cin):
    """The TMA tensor map of the wgmma kernel takes the packed rows as they
    are: exactly 9 * Cin bytes (a multiple of 16) at Cin % 32 == 0; only
    Cin % 32 != 0 pads, and of those the kernel reads only the 16-channel
    taps' rows (the narrow route: 144 bytes and 16 zeros, two K chunks)."""
    assert k_padded(cin) == 9 * cin and (9 * cin) % 16 == 0
    assert k_padded(16) == k_padded(2) == k_padded(4) == 160 and k_padded(48) == 448
    assert plan(16, 64, 64)["k_chunks"] == plan(2, 32, 64)["k_chunks"] == 2
    assert plan(48, 64, 64)["kernel"] == "mma"


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
