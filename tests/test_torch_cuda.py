"""Tests of the port's CUDA kernels; they need an NVIDIA GPU (marker
``cuda``) and skip without one. Each kernel is held against its plain
PyTorch version on the card, and the main path's launch counts are checked.

On a machine with a card (this file imports no JAX, so the JAX conftest is
left out):

    python -m pytest tests/test_torch_cuda.py --noconftest -m cuda -q -p no:cacheprovider
"""

import numpy as np
import pytest
import torch

from azoom_torch import kernels
from azoom_torch.beam.mvdr import masked_mvdr
from azoom_torch.config import PipelineConfig
from azoom_torch.dsp.delays import steering_vector
from azoom_torch.dsp.stft import rfft_freqs
from azoom_torch.kernels.convt_kernel import convt1x2, convt1x2_plain
from azoom_torch.kernels.int8_mm_kernel import int8_mm, int8_mm_plain
from azoom_torch.kernels.mvdr_kernel import masked_mvdr_fused
from azoom_torch.kernels.nullsteer_kernel import hard_null_cond, hard_null_fused, hard_null_plain
from azoom_torch.kernels.qconv_kernel import (
    dynamic_act_scale, input_max, k_padded, pack_weights, plan, qconv3x3, qconv3x3_plain,
    route_counts,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _t(a, dev):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


@pytest.mark.parametrize("cin,cout,t,res,cat", [
    (16, 64, 64, False, False), (64, 128, 16, True, False), (256, 256, 8, True, False),
    (128, 64, 5, False, False), (256, 128, 16, False, True), (128, 64, 64, True, True)])
def test_qconv_kernel_matches_plain(cuda, cin, cout, t, res, cat):
    rng = np.random.default_rng(cin + t)
    x = _t(np.abs(rng.standard_normal((2, 129, t, cin))).astype(np.float32), cuda)
    w = torch.zeros((cout, k_padded(cin)), dtype=torch.int8)
    w[:, :9 * cin] = torch.from_numpy(rng.integers(-127, 128, (cout, 9 * cin)).astype(np.int8))
    epi = _t(np.stack([np.full(cout, 2e-4), *(0.1 * rng.standard_normal((2, cout))),
                       1 + 0.1 * rng.standard_normal(cout), 0.1 * rng.standard_normal(cout)])
             .astype(np.float32), cuda)
    r = _t(rng.standard_normal((2, 129, t, cout)).astype(np.float32), cuda) if res else None
    kw = dict(residual=r)
    if cat:  # the decoder's concat read in place: [x[..., :cin/2], x2]
        x, kw["x2"] = x[..., :cin // 2].contiguous(), x[..., cin // 2:].contiguous()
    got = qconv3x3(x, w.to(cuda), epi, 0.026, **kw)
    ref = qconv3x3_plain(x, w.to(cuda), epi, 0.026, **kw)
    assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


def _conv_case(rng, dev, batch, f_rows, t, cin, cout, res):
    x = _t(np.abs(rng.standard_normal((batch, f_rows, t, cin))).astype(np.float32), dev)
    w = torch.zeros((cout, k_padded(cin)), dtype=torch.int8)
    w[:, :9 * cin] = torch.from_numpy(rng.integers(-127, 128, (cout, 9 * cin)).astype(np.int8))
    epi = _t(np.stack([np.full(cout, 2e-4), *(0.1 * rng.standard_normal((2, cout))),
                       1 + 0.1 * rng.standard_normal(cout), 0.1 * rng.standard_normal(cout)])
             .astype(np.float32), dev)
    r = _t(rng.standard_normal((batch, f_rows, t, cout)).astype(np.float32), dev) if res else None
    return x, w.to(dev), epi, r


# Ragged and tiny planes, one stream, the widest Cout and the classic tree's
# widths: batch, F, T, Cin, Cout, residual, relu.
@pytest.mark.parametrize("batch,f_rows,t,cin,cout,res,relu", [
    (2, 129, 1, 64, 64, True, True), (2, 129, 7, 64, 128, False, True),
    (3, 1, 8, 128, 256, True, False), (1, 129, 8, 256, 256, True, True),
    (1, 5, 3, 32, 64, False, True), (2, 129, 8, 256, 512, True, True),
    (1, 129, 8, 512, 512, False, True), (1, 129, 16, 512, 256, True, True),
    (2, 129, 40, 64, 64, True, True), (1, 129, 100, 128, 64, False, True),
    (1, 300, 64, 96, 128, True, True)])
def test_qconv_kernels_on_ragged_and_tiny_shapes(cuda, batch, f_rows, t, cin, cout, res, relu):
    rng = np.random.default_rng(1000 * cin + 10 * t + batch)
    x, w, epi, r = _conv_case(rng, cuda, batch, f_rows, t, cin, cout, res)
    got = qconv3x3(x, w, epi, 0.026, residual=r, relu=relu)
    ref = qconv3x3_plain(x, w, epi, 0.026, residual=r, relu=relu)
    assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


@pytest.mark.parametrize("cin,cout,t", [(64, 64, 32), (128, 128, 16), (256, 256, 8), (256, 128, 16)])
def test_qconv_wgmma_equals_mma_kernel_bit_for_bit(cuda, cin, cout, t):
    rng = np.random.default_rng(cin + cout + t)
    assert plan(cin, cout, t)["kernel"] == "wgmma"
    x, w, epi, r = _conv_case(rng, cuda, 3, 129, t, cin, cout, True)
    new = qconv3x3(x, w, epi, 0.026, residual=r)
    old = qconv3x3(x, w, epi, 0.026, residual=r, _kernel="mma")
    assert torch.equal(new, old)


# The base-32 nets' shapes on unfolded 513-row planes (and ragged ones):
# stems of Cin 2 and 4, Cout = 32 (with the decoder's concat), Cout = 512 at
# 4 frames, 512 -> 256 on a concat. batch, F, T, Cin, Cout, residual, concat.
@pytest.mark.parametrize("batch,f_rows,t,cin,cout,res,cat", [
    (2, 513, 64, 2, 32, False, False), (2, 513, 64, 4, 32, False, False),
    (2, 513, 64, 32, 32, False, False), (2, 513, 64, 64, 32, False, True),
    (2, 513, 32, 32, 64, True, False), (2, 513, 4, 256, 512, False, False),
    (2, 513, 4, 512, 512, True, False), (2, 513, 8, 512, 256, False, True),
    (3, 13, 7, 2, 32, True, False), (1, 40, 5, 4, 64, False, False),
    (2, 33, 3, 32, 32, True, False), (1, 513, 48, 64, 32, False, True)])
def test_qconv_base32_shapes_bit_equal_to_plain(cuda, batch, f_rows, t, cin, cout, res, cat):
    rng = np.random.default_rng(100 * cin + cout + t)
    x = _t(np.abs(rng.standard_normal((batch, f_rows, t, cin))).astype(np.float32), cuda)
    w = pack_weights(torch.from_numpy(
        rng.integers(-127, 128, (3, 3, cin, cout)).astype(np.int8))).to(cuda)
    epi = _t(np.stack([np.full(cout, 2e-4), *(0.1 * rng.standard_normal((2, cout))),
                       1 + 0.1 * rng.standard_normal(cout), 0.1 * rng.standard_normal(cout)])
             .astype(np.float32), cuda)
    kw = dict(residual=_t(rng.standard_normal((batch, f_rows, t, cout)).astype(np.float32), cuda)
              if res else None)
    if cat:
        x, kw["x2"] = x[..., :cin // 2].contiguous(), x[..., cin // 2:].contiguous()
    got = qconv3x3(x, w, epi, 0.026, **kw)
    ref = qconv3x3_plain(x, w, epi, 0.026, **kw)
    assert torch.equal(got, ref)


# The split route's shapes (Cout = 512, Cin = 512, 256 -> 256 at few frames)
# on ragged 131-row planes at batch 2, and at 6 and 7 frames against the tile
# of 8; 512 -> 256 at 4 and 20 frames in four parts on one slice: Cin, Cout,
# T, residual, concat.
@pytest.mark.parametrize("cin,cout,t,res,cat", [
    (256, 512, 4, False, False), (512, 512, 4, True, False), (512, 256, 8, False, True),
    (256, 512, 8, True, False), (512, 512, 8, False, False), (512, 256, 16, True, True),
    (256, 256, 6, True, False), (256, 256, 7, False, False), (512, 512, 3, True, False),
    (256, 512, 6, False, False), (512, 256, 4, True, False), (512, 256, 20, False, True)])
def test_qconv_split_route_bit_equal_to_plain_and_mma(cuda, cin, cout, t, res, cat):
    rng = np.random.default_rng(7 * cin + cout + t)
    assert plan(cin, cout, t)["kernel"] == "split"
    x, w, epi, r = _conv_case(rng, cuda, 2, 131, t, cin, cout, res)
    kw = dict(residual=r)
    if cat:
        x, kw["x2"] = x[..., :cin // 2].contiguous(), x[..., cin // 2:].contiguous()
    got = qconv3x3(x, w, epi, 0.026, **kw)
    assert torch.equal(got, qconv3x3_plain(x, w, epi, 0.026, **kw))
    assert torch.equal(got, qconv3x3(x, w, epi, 0.026, **kw, _kernel="mma"))


# The instances whose weights stream through the ring that their consumers
# feed: wgmma at N = 256 (128 -> 256, 256 -> 256) and N = 128 (256 -> 128, the
# decoder's concat), and the split route, each part made once a tile: four
# parts on two slices (512 -> 512 at 4 frames) or on one (512 -> 256 at 4),
# two on one slice (512 -> 256 at 8), one on two slices (256 -> 512) or on
# one (256 -> 256 at 6 frames): one stream, one tile or a few, F not a
# multiple of the tile's rows, and a residual or a concat. batch, F, T, Cin,
# Cout, residual, concat.
@pytest.mark.parametrize("batch,f_rows,t,cin,cout,res,cat", [
    (1, 129, 8, 256, 256, True, False), (3, 17, 8, 128, 256, False, False),
    (1, 5, 8, 256, 256, False, True), (2, 131, 16, 256, 128, True, True),
    (1, 9, 12, 256, 128, False, True), (1, 513, 4, 512, 512, True, False),
    (3, 40, 4, 512, 512, False, True), (1, 3, 4, 256, 512, True, False),
    (2, 131, 4, 256, 512, False, False), (1, 129, 6, 256, 256, True, False),
    (3, 7, 8, 512, 256, False, True), (1, 1, 6, 128, 256, True, False),
    (1, 131, 4, 512, 256, True, False), (3, 5, 4, 512, 256, False, True)])
def test_streaming_instances_bit_equal_static_and_dynamic(cuda, batch, f_rows, t, cin, cout,
                                                          res, cat):
    """Each instance whose weights stream, on the static and the dynamic
    scale: the output bit for bit the plain version and the mma.sync
    kernel, the maxima a dynamic launch writes bit for bit vector_norm(inf)'s
    and the plain version's."""
    rng = np.random.default_rng(13 * cin + cout + t + f_rows)
    how = plan(cin, cout, t)
    assert how["kernel"] in ("wgmma", "split") and not how["resident"]
    x, w, epi, r = _conv_case(rng, cuda, batch, f_rows, t, cin, cout, res)
    kw = dict(residual=r)
    if cat:
        x, kw["x2"] = x[..., :cin // 2].contiguous(), x[..., cin // 2:].contiguous()
    got = qconv3x3(x, w, epi, 0.026, **kw)
    assert torch.equal(got, qconv3x3_plain(x, w, epi, 0.026, **kw))
    assert torch.equal(got, qconv3x3(x, w, epi, 0.026, **kw, _kernel="mma"))
    in_max = input_max(x, kw.get("x2"))
    maxima = [torch.zeros(batch, device=cuda) for _ in range(3)]
    dyn = qconv3x3(x, w, epi, None, **kw, in_max=in_max, out_max=maxima[0])
    assert torch.equal(dyn, qconv3x3_plain(x, w, epi, None, **kw, in_max=in_max,
                                           out_max=maxima[1]))
    assert torch.equal(dyn, qconv3x3(x, w, epi, None, **kw, in_max=in_max, out_max=maxima[2],
                                     _kernel="mma"))
    assert torch.equal(maxima[0].view(torch.int32), input_max(dyn).view(torch.int32))
    assert torch.equal(maxima[0], maxima[1]) and torch.equal(maxima[0], maxima[2])


# The narrow route's shapes (stems of Cin1 2, 4 and 16; Cout = 32, the 32 || 32
# concat among them; a weight ring at N = 32) on 131- and 513-row planes:
# batch, F, T, Cin, Cout, residual, concat, relu.
@pytest.mark.parametrize("batch,f_rows,t,cin,cout,res,cat,relu", [
    (1, 513, 64, 2, 32, False, False, True), (3, 131, 7, 2, 32, True, False, False),
    (1, 513, 64, 4, 32, False, False, True), (3, 131, 33, 4, 32, True, False, True),
    (1, 131, 64, 16, 64, False, False, True), (3, 131, 1, 16, 64, True, False, False),
    (1, 513, 48, 32, 32, True, False, True), (3, 131, 80, 32, 32, False, False, False),
    (1, 513, 64, 64, 32, False, True, True), (3, 131, 48, 64, 32, True, True, True),
    (1, 131, 80, 64, 32, False, True, False), (1, 131, 1, 32, 32, True, False, True),
    (3, 131, 1, 4, 64, False, False, True), (1, 131, 7, 16, 32, False, False, True),
    (3, 131, 80, 2, 64, True, False, True), (1, 131, 33, 128, 32, True, False, True)])
def test_qconv_narrow_route_bit_equal_to_plain_and_mma(cuda, batch, f_rows, t, cin, cout, res,
                                                       cat, relu):
    rng = np.random.default_rng(11 * cin + cout + t + batch)
    assert plan(cin, cout, t)["kernel"] == "narrow"
    x = _t(np.abs(rng.standard_normal((batch, f_rows, t, cin))).astype(np.float32), cuda)
    w = pack_weights(torch.from_numpy(
        rng.integers(-127, 128, (3, 3, cin, cout)).astype(np.int8))).to(cuda)
    epi = _t(np.stack([np.full(cout, 2e-4), *(0.1 * rng.standard_normal((2, cout))),
                       1 + 0.1 * rng.standard_normal(cout), 0.1 * rng.standard_normal(cout)])
             .astype(np.float32), cuda)
    kw = dict(relu=relu, residual=_t(rng.standard_normal((batch, f_rows, t, cout))
                                     .astype(np.float32), cuda) if res else None)
    if cat:
        x, kw["x2"] = x[..., :cin // 2].contiguous(), x[..., cin // 2:].contiguous()
    before = route_counts["narrow"]
    got = qconv3x3(x, w, epi, 0.026, **kw)
    assert route_counts["narrow"] == before + 1
    assert torch.equal(got, qconv3x3_plain(x, w, epi, 0.026, **kw))
    assert torch.equal(got, qconv3x3(x, w, epi, 0.026, **kw, _kernel="mma"))


@pytest.mark.parametrize("name", ["fpu", "deepfpu", "tpufpu", "tpufpu_slim"])
@pytest.mark.parametrize("quant", [True, False])
def test_bundled_net_on_the_card_matches_the_cpu(cuda, name, quant):
    """Each bundled conv net's mask on the card against the same net on the
    CPU: the int8 nets to the whole-net mask bounds (B2 is bit-equal to its
    plain version; convt1x2's plain version rounds twice on rare ties), the
    float nets (full float32 matrix products, not TF32) to 1e-5."""
    from azoom_torch import load_bundled

    model, fk = load_bundled(name, quant=quant)
    model_cpu, _ = load_bundled(name, quant=quant, device="cpu")
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((2, 513, 64, model.in_channels)).astype(np.float32))
    with torch.inference_mode():
        got = model(x.to(cuda)).cpu()
        ref = model_cpu(x)
    err = (got - ref).abs()
    if quant:
        assert float(err.max()) < 1e-2 and float(err.mean()) < 2e-4
    else:
        assert float(err.max()) <= 1e-5


def test_mvdr_kernel_matches_plain(cuda):
    rng = np.random.default_rng(1)
    shape = (3, 2, 513, 64)
    Y = torch.complex(_t(rng.standard_normal(shape).astype(np.float32), cuda),
                      _t(rng.standard_normal(shape).astype(np.float32), cuda))
    nm = _t(rng.random((3, 513, 64), dtype=np.float32), cuda)
    f = rfft_freqs(1024, 16000, device=cuda)
    d = steering_vector(f, 60.0, 0.04)
    for sigma in (1e-7, torch.full((513,), 2e-7, device=cuda)):
        kw = dict(target_mask=1 - nm, sigma=sigma, mask_floor=0.05)
        got, ref = masked_mvdr_fused(Y, nm, d, f, **kw), masked_mvdr(Y, nm, d, f, **kw)
        assert float((got - ref).abs().max()) <= 1e-4 * float(ref.abs().max())


def test_mvdr_kernel_per_stream_steering_and_loading(cuda):
    """d (S, F, 2) and sigma (S,) or (S, F): one launch against the plain
    version; the shared-d launch is bit for bit the per-stream launch with
    that d (and that loading) in every stream: the same arithmetic."""
    rng = np.random.default_rng(7)
    S, F, T = 5, 513, 65
    Y = torch.complex(_t(rng.standard_normal((S, 2, F, T)).astype(np.float32), cuda),
                      _t(rng.standard_normal((S, 2, F, T)).astype(np.float32), cuda))
    nm = _t(rng.random((S, F, T), dtype=np.float32), cuda)
    f = rfft_freqs(1024, 16000, device=cuda)
    steers = torch.tensor([30.0, 60.0, 90.0, 120.0, 150.0], device=cuda)
    d = steering_vector(f, steers, 0.04)
    assert d.shape == (S, F, 2)
    sig_s = torch.tensor([1e-7, 1e-5, 1e-3, 3e-6, 1e-2], device=cuda)
    sig_sf = sig_s[:, None] * (1 + torch.arange(F, device=cuda) / F)
    kw = dict(target_mask=1 - nm, mask_floor=0.05)
    for dd, sg in ((d, sig_s), (d, sig_sf), (d, 2e-7), (d[1], sig_s)):
        kernels.reset_launches()
        got = masked_mvdr_fused(Y, nm, dd, f, sigma=sg, **kw)
        assert kernels.launches["masked_mvdr"] == 1
        ref = masked_mvdr(Y, nm, dd, f, sigma=sg, **kw)
        assert float((got - ref).abs().max()) <= 1e-4 * float(ref.abs().max())
    shared = masked_mvdr_fused(Y, nm, d[1], f, sigma=3e-6, **kw)
    each = masked_mvdr_fused(Y, nm, d[1].expand(S, F, 2).contiguous(), f,
                             sigma=torch.full((S,), 3e-6, device=cuda), **kw)
    assert torch.equal(shared, each)
    per_bin = torch.full((F,), 3e-6, device=cuda)
    assert torch.equal(shared, masked_mvdr_fused(Y, nm, d[1], f, sigma=per_bin, **kw))


def test_server_tick_on_the_card_matches_the_cpu(cuda):
    """Two streams, mask reuse, the int16 wire and tracking: prime and two
    ticks on the card against the CPU port. A reuse tick launches 21 convs,
    3 upsamplings and one MVDR."""
    from azoom_torch import AudioZoomServer

    cfg = PipelineConfig(mic_dist=0.04, win_size=32768)
    rng = np.random.default_rng(9)
    mix = (0.1 * rng.standard_normal((2, 2, 2 * 32768))).astype(np.float32)
    outs = {}
    for dev in ("cuda", "cpu"):
        srv = AudioZoomServer(2, cfg=cfg, mask_reuse=True, wire="int16", track=True, device=dev)
        srv.set_zoom(0, direction_deg=60.0, zoom=0.3)
        srv.set_zoom(1, direction_deg=120.0, zoom=0.8)
        srv.push(mix[:, :, :32768])
        ticks = []
        for k in range(2):
            kernels.reset_launches()
            ticks.append(srv.push(mix[:, :, 32768 + k * 16384:32768 + (k + 1) * 16384]))
            if dev == "cuda":
                torch.cuda.synchronize()
                assert _active(kernels.launches) == {"qconv3x3": 21, "convt1x2": 3,
                                                     "masked_mvdr": 1}
        outs[dev] = (np.concatenate(ticks, axis=1), srv.bearings)
    (a, ba), (b, bb) = outs["cuda"], outs["cpu"]
    assert a.dtype == np.int16 and a.shape == (2, 2 * 16384)
    np.testing.assert_array_equal(ba, bb)
    a, b = a.astype(np.float32), b.astype(np.float32)
    assert float(np.linalg.norm(a - b) / np.linalg.norm(b)) <= 1e-4


def test_convt_kernel_matches_plain(cuda):
    rng = np.random.default_rng(2)
    x = _t(np.abs(rng.standard_normal((2, 129, 8, 256))).astype(np.float32), cuda)
    w = _t((0.05 * rng.standard_normal((256, 256))).astype(np.float32), cuda)
    b = _t((0.1 * rng.standard_normal(128)).astype(np.float32), cuda)
    got, ref = convt1x2(x, w, b), convt1x2_plain(x, w, b)
    assert float((got - ref).abs().max()) <= 1e-6 * float(ref.abs().max())


# The net's three upsamplings at a batch of 3 (3 x 129 x T rows: a partial
# last row tile at T = 8 and 16), and K = 36, 2*Cout = 40 over 1,290 rows: a
# short last K chunk, a partial column tile and a partial row tile.
@pytest.mark.parametrize("k,cout,t,batch", [(256, 128, 8, 3), (128, 64, 16, 3), (64, 64, 32, 3),
                                            (36, 20, 5, 2)])
def test_convt_kernel_on_ragged_shapes(cuda, k, cout, t, batch):
    rng = np.random.default_rng(k + t)
    x = _t(np.abs(rng.standard_normal((batch, 129, t, k))).astype(np.float32), cuda)
    w = _t((0.05 * rng.standard_normal((k, 2 * cout))).astype(np.float32), cuda)
    b = _t((0.1 * rng.standard_normal(cout)).astype(np.float32), cuda)
    got, ref = convt1x2(x, w, b), convt1x2_plain(x, w, b)
    assert float((got - ref).abs().max()) <= 1e-6 * float(ref.abs().max())
    # one chain per output in K order: bit for bit the plain version's, but
    # where its float64 emulation of the FMA rounds twice (rare ties)
    assert int((got != ref).sum()) <= got.numel() // 100_000 + 1


def test_hard_null_kernel_on_ragged_groups_without_post_filter(cuda):
    """35 rows of 5 bins (warps' row groups straddle streams; the last is
    partial), 50 frames (a partial step of 32), bins 0 and 1 below the
    200 Hz bypass, and a threshold between the cond of rows 2 and 3, so the
    first rows mix bypass, delay-and-sum and nulled rows."""
    rng = np.random.default_rng(5)
    B, F, T = 7, 5, 50
    Y = 0.01 * torch.complex(_t(rng.standard_normal((B, 2, F, T)).astype(np.float32), cuda),
                             _t(rng.standard_normal((B, 2, F, T)).astype(np.float32), cuda))
    Y[:, 1] += torch.from_numpy(rng.random((B, 1, 1)).astype(np.float32)).to(cuda) * Y[:, 0]
    tm = _t(rng.random((B, F, T), dtype=np.float32), cuda)
    f = torch.tensor([0.0, 150.0, 300.0, 1000.0, 4000.0], device=cuda)
    d = steering_vector(f, 60.0, 0.04, normalize_phase=True)
    cond = hard_null_cond(Y, tm, d)
    lo, hi = sorted((float(cond[0, 2]), float(cond[0, 3])))
    assert hi > 1.01 * lo
    thr = (lo * hi) ** 0.5
    got = hard_null_fused(Y, tm, d, f, post_mask=None, cond_threshold=thr)
    ref = hard_null_plain(Y, tm, d, f, post_mask=None, cond_threshold=thr)
    keep = (cond / thr - 1).abs() > 1e-9
    err = ((got - ref).abs().norm(dim=-1) / ref.abs().norm(dim=-1).clamp(min=1e-30))[keep]
    assert float(err.max()) <= 1e-5
    assert torch.equal(got[:, :2], Y[:, 0, :2])  # the bypass rows are mic 0, unfiltered


@pytest.mark.parametrize("thr", [1 + 1e-6, 10.0, 1e6])
def test_hard_null_kernel_matches_plain(cuda, thr):
    rng = np.random.default_rng(4)
    shape = (3, 2, 513, 64)
    Y = 0.01 * torch.complex(_t(rng.standard_normal(shape).astype(np.float32), cuda),
                             _t(rng.standard_normal(shape).astype(np.float32), cuda))
    Y[:, 1] += 0.5 * Y[:, 0]  # correlated mics: anisotropic covariances
    tm = _t(rng.random((3, 513, 64), dtype=np.float32), cuda)
    f = rfft_freqs(1024, 16000, device=cuda)
    d = steering_vector(f, 60.0, 0.04, normalize_phase=True)
    got = hard_null_fused(Y, tm, d, f, post_mask=tm, cond_threshold=thr)
    ref = hard_null_plain(Y, tm, d, f, post_mask=tm, cond_threshold=thr)
    keep = (hard_null_cond(Y, tm, d) / thr - 1).abs() > 1e-9
    err = ((got - ref).abs().norm(dim=-1) / ref.abs().norm(dim=-1).clamp(min=1e-30))[keep]
    assert float(err.max()) <= 1e-5


def test_hard_null_kernel_per_chunk_steering(cuda):
    """d (C, F, 2), one phase-normalised steering vector per chunk, in one
    launch against the plain version; the shared-d launch is bit for bit the
    per-chunk launch with that d in every chunk (C = 7 at F = 513: the
    warps' row groups straddle chunks)."""
    rng = np.random.default_rng(8)
    C, F, T = 7, 513, 64
    Y = 0.01 * torch.complex(_t(rng.standard_normal((C, 2, F, T)).astype(np.float32), cuda),
                             _t(rng.standard_normal((C, 2, F, T)).astype(np.float32), cuda))
    Y[:, 1] += 0.5 * Y[:, 0]
    tm = _t(rng.random((C, F, T), dtype=np.float32), cuda)
    f = rfft_freqs(1024, 16000, device=cuda)
    d = steering_vector(f, torch.linspace(20.0, 160.0, C, device=cuda), 0.04,
                        normalize_phase=True)
    for post in (tm, None):
        kernels.reset_launches()
        got = hard_null_fused(Y, tm, d, f, post_mask=post)
        assert kernels.launches["hard_null"] == 1
        ref = hard_null_plain(Y, tm, d, f, post_mask=post)
        keep = (hard_null_cond(Y, tm, d) / 10.0 - 1).abs() > 1e-9
        err = ((got - ref).abs().norm(dim=-1) / ref.abs().norm(dim=-1).clamp(min=1e-30))[keep]
        assert float(err.max()) <= 1e-5
    shared = hard_null_fused(Y, tm, d[3], f, post_mask=tm)
    each = hard_null_fused(Y, tm, d[3].expand(C, F, 2).contiguous(), f, post_mask=tm)
    assert torch.equal(shared, each)


@pytest.mark.parametrize("beamformer,kernel", [("mvdr", "masked_mvdr"), ("hard_null", "hard_null")])
def test_tracked_and_hrnr_paths_launch_once_and_match_cpu(cuda, beamformer, kernel):
    """A 4 s clip tracked (3 chunks, each at its own bearing) and one
    2 s window with the HRNR post-filter: 21 convs, 3 upsamplings and ONE
    beamformer launch each, and the CPU's bearings and waveform."""
    from azoom_torch import learned_enhance, load_bundled
    from azoom_torch.pipelines.tracked import tracked_autosteer_enhance

    rng = np.random.default_rng(9)
    mix = torch.from_numpy((0.1 * rng.standard_normal((2, 64000))).astype(np.float32))
    cfg = PipelineConfig(mic_dist=0.04)
    model, model_cpu = load_bundled("tpufpu_nano")[0], load_bundled("tpufpu_nano", device="cpu")[0]
    kernels.reset_launches()
    out, theta = tracked_autosteer_enhance(mix.to(cuda), cfg, model=model, beamformer=beamformer,
                                           feature_kind="physics", tracker="momentum")
    torch.cuda.synchronize()
    assert _active(kernels.launches) == {"qconv3x3": 21, kernel: 1, "convt1x2": 3}
    ref, theta_ref = tracked_autosteer_enhance(mix, cfg, model=model_cpu, beamformer=beamformer,
                                               feature_kind="physics", tracker="momentum")
    assert torch.equal(theta.cpu(), theta_ref)
    assert float((out.cpu() - ref).norm() / ref.norm()) <= 1e-2
    kernels.reset_launches()
    out = learned_enhance(mix[:, :32000].to(cuda), model, cfg, beamformer=beamformer,
                          feature_kind="physics", harmonic_regen=True)
    torch.cuda.synchronize()
    assert _active(kernels.launches) == {"qconv3x3": 21, kernel: 1, "convt1x2": 3}
    ref = learned_enhance(mix[:, :32000], model_cpu, cfg, beamformer=beamformer,
                          feature_kind="physics", harmonic_regen=True)
    assert float((out.cpu() - ref).norm() / ref.norm()) <= 1e-2


# (128, 64, 64) is the smallest supported product: one 128 x 64 tile, one K chunk of 64.
@pytest.mark.parametrize("shape", [(256, 576, 64), (128, 4608, 512), (512, 1152, 128),
                                   (128, 64, 64), (128, 64, 256), (384, 192, 128),
                                   (17024, 320, 192)])
def test_int8_mm_kernel_is_exact(cuda, shape):
    M, K, N = shape
    rng = np.random.default_rng(M + K)
    x = _t(rng.integers(-128, 128, (M, K)).astype(np.int8), cuda)
    w = _t(rng.integers(-128, 128, (K, N)).astype(np.int8), cuda)
    assert torch.equal(int8_mm(x, w), int8_mm_plain(x, w))


def _active(launches):
    return {k: v for k, v in launches.items() if v}


@pytest.mark.parametrize("beamformer,kernel", [("mvdr", "masked_mvdr"), ("hard_null", "hard_null")])
def test_main_path_launches_and_matches_cpu(cuda, beamformer, kernel):
    from azoom_torch import learned_enhance, load_bundled

    rng = np.random.default_rng(3)
    mix = torch.from_numpy((0.1 * rng.standard_normal((2, 2, 32000))).astype(np.float32))
    cfg = PipelineConfig(mic_dist=0.04)
    model, _ = load_bundled("tpufpu_nano")
    kw = dict(beamformer=beamformer, feature_kind="physics", steer_deg=60.0,
              fov_deg=30.0 if beamformer == "hard_null" else None)
    kernels.reset_launches()
    routes_before = dict(route_counts)
    out = learned_enhance(mix.to(cuda), model, cfg, **kw)
    torch.cuda.synchronize()
    assert _active(kernels.launches) == {"qconv3x3": 21, kernel: 1, "convt1x2": 3}
    # 20 convs on wgmma, the stem on the narrow route
    assert {r: route_counts[r] - routes_before[r] for r in route_counts} == {
        "wgmma": 20, "narrow": 1, "split": 0, "mma": 0}
    ref = learned_enhance(mix, load_bundled("tpufpu_nano", device="cpu")[0], cfg, **kw)
    assert float((out.cpu() - ref).norm() / ref.norm()) <= 1e-2


def test_oracle_path_launches_once(cuda):
    from azoom_torch import oracle_enhance

    rng = np.random.default_rng(6)
    tgt, itf = (_t((0.1 * rng.standard_normal((2, 32000))).astype(np.float32), cuda)
                for _ in range(2))
    mix = torch.stack([tgt + itf, tgt + 0.5 * itf], dim=-2)
    kernels.reset_launches()
    out = oracle_enhance(mix, tgt, itf, PipelineConfig(mic_dist=0.04), post_filter="irm")
    torch.cuda.synchronize()
    assert _active(kernels.launches) == {"masked_mvdr": 1}
    ref = oracle_enhance(mix.cpu(), tgt.cpu(), itf.cpu(), PipelineConfig(mic_dist=0.04),
                         post_filter="irm")
    assert float((out.cpu() - ref).norm() / ref.norm()) <= 1e-4


def _online_case(rng, dev, lead, F, T, M=2):
    shape = lead + (M, F, T)
    Y = torch.complex(_t(rng.standard_normal(shape).astype(np.float32), dev),
                      _t(rng.standard_normal(shape).astype(np.float32), dev))
    nm = _t(rng.random(lead + (F, T), dtype=np.float32), dev)
    f = _t((np.arange(F) * 8000.0 / max(F - 1, 1)).astype(np.float32), dev)
    return Y, nm, f, steering_vector(f, 60.0, 0.04, n_mics=M)


# one stream of 513 bins, ragged F with several streams, T = 1, and T not a
# multiple of the kernel's 32-frame tile
@pytest.mark.parametrize("lead,F,T", [((), 513, 300), ((3,), 37, 50), ((2,), 7, 1),
                                      ((), 513, 1), ((), 513, 31), ((), 513, 1875),
                                      ((2,), 513, 33)])
def test_online_mvdr_kernel_matches_plain(cuda, lead, F, T):
    """Output and carried state against the plain loop, with and without the
    floored target-mask gain, from a state warmed on 30 other frames, then
    from the state each carried. (From a fresh state the first frames are
    ill-posed: R is y y^H plus a 1e-6 prime, the beamformer nulls y itself,
    and the tiny outputs carry float32 cancellation errors of a few %, in
    the reference too.)"""
    from azoom_torch.kernels.online_mvdr_kernel import initial_state, online_mvdr, online_mvdr_plain

    rng = np.random.default_rng(F + T)
    warm = initial_state(lead, F, device=cuda)
    Yw, nmw, f, d = _online_case(rng, cuda, lead, F, 30)
    online_mvdr_plain(Yw, nmw, d, f, *warm)
    Y, nm, _, _ = _online_case(rng, cuda, lead, F, T)
    for target, floor in ((None, 0.0), (1 - nm, 0.05)):
        st_k, st_p = [t.clone() for t in warm], [t.clone() for t in warm]
        for _ in range(2):  # the second call starts from the carried state
            kw = dict(target_mask=target, sigma=1e-5, forget=0.98, mask_floor=floor)
            kernels.reset_launches()
            got = online_mvdr(Y, nm, d, f, *st_k, **kw)
            assert kernels.launches["online_mvdr"] == 1
            ref = online_mvdr_plain(Y, nm, d, f, *st_p, **kw)
            torch.cuda.synchronize()
            assert float((got - ref).abs().max()) <= 1e-4 * float(ref.abs().max())
            for a, b in zip(st_k, st_p):
                assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


# T of one frame (a hop), one short of the kernel's 32-frame tile, ragged
# against it, and a 60 s clip; one stream or two (rows of both in a block)
@pytest.mark.parametrize("lead,T", [((), 40), ((2,), 1), ((2,), 31), ((2,), 1875)])
def test_online_mvdr_one_launch_equals_one_launch_per_frame(cuda, lead, T):
    """T launches of one frame, the state carried through device memory,
    give the bits of one launch over T frames: the same per-frame code."""
    from azoom_torch.kernels.online_mvdr_kernel import initial_state, online_mvdr

    rng = np.random.default_rng(11)
    Y, nm, f, d = _online_case(rng, cuda, lead, 513, T)
    kw = dict(target_mask=1 - nm, sigma=1e-6, mask_floor=0.05)
    st = initial_state(lead, 513, device=cuda)
    whole = online_mvdr(Y, nm, d, f, *st, **kw)
    st1 = initial_state(lead, 513, device=cuda)
    steps = [online_mvdr(Y[..., t:t + 1].contiguous(), nm[..., t:t + 1].contiguous(), d, f,
                         *st1, target_mask=kw["target_mask"][..., t:t + 1].contiguous(),
                         sigma=1e-6, mask_floor=0.05) for t in range(T)]
    assert torch.equal(torch.cat(steps, dim=-1), whole)
    assert all(torch.equal(a, b) for a, b in zip(st, st1))


def test_online_mvdr_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    from azoom_torch.kernels.online_mvdr_kernel import initial_state, online_mvdr

    rng = np.random.default_rng(2)
    Y, nm, f, d = _online_case(rng, cuda, (), 33, 4)
    R, w = initial_state((), 33, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        online_mvdr(Y, nm.t().contiguous().t(), d, f, R, w)
    with pytest.raises(ValueError, match="R_sum"):
        online_mvdr(Y, nm, d, f, R[:, 0].contiguous(), w)
    with pytest.raises(ValueError, match="on cpu"):
        online_mvdr(Y, nm.cpu(), d, f, R, w)


def test_low_latency_path_on_the_card(cuda):
    """online_learned_enhance: one online_mvdr launch, the CRN mask and the
    waveform against the CPU; OnlineEnhancer: one launch per hop and the
    card's offline output on the finalized samples."""
    from azoom_torch import load_bundled
    from azoom_torch.dsp.stft import stft
    from azoom_torch.masks.features import logmag_ipd_features
    from azoom_torch.pipelines.online_learned import online_learned_enhance
    from azoom_torch.stream.lowlat import OnlineEnhancer

    rng = np.random.default_rng(4)
    mix = torch.from_numpy((0.1 * rng.standard_normal((2, 32000))).astype(np.float32))
    cfg = PipelineConfig(mic_dist=0.04, angle_target_deg=75.0)
    net, _ = load_bundled("crn_causal")
    net_cpu, _ = load_bundled("crn_causal", device="cpu")
    kernels.reset_launches()
    out = online_learned_enhance(mix.to(cuda), net, cfg)
    torch.cuda.synchronize()
    assert _active(kernels.launches) == {"online_mvdr": 1}
    ref = online_learned_enhance(mix, net_cpu, cfg)
    assert float((out.cpu() - ref).norm() / ref.norm()) <= 1e-3
    feats = logmag_ipd_features(stft(mix))[None]
    with torch.inference_mode():
        m_err = float((net(feats.to(cuda)).cpu() - net_cpu(feats)).abs().max())
    assert m_err <= 1e-5
    oe = OnlineEnhancer(cfg, net, steer_deg=75.0)
    kernels.reset_launches()
    x = mix.numpy()
    st = np.concatenate([oe.push(x[:, i:i + 2048]) for i in range(0, x.shape[1], 2048)])
    assert kernels.launches["online_mvdr"] == x.shape[1] // cfg.hop
    assert float(np.abs(st - out.cpu().numpy()[:st.shape[0]]).max()) <= 1e-5


# -- arrays of more than two mics ---------------------------------------------

# 3, 4, 8, 9, 12 and 16 mics on one stream of 513 bins (both sides of the
# kernel's switch from a thread to a group of lanes a solve, and of the
# group's switch from 16 lanes to a warp); several streams of a ragged F;
# one frame (a hop)
@pytest.mark.parametrize("M,lead,F,T", [(3, (), 513, 300), (4, (), 513, 300), (8, (), 513, 300),
                                        (4, (3,), 37, 50), (4, (), 513, 1), (8, (2,), 65, 33),
                                        (9, (), 513, 300), (12, (2,), 65, 40),
                                        (16, (), 513, 120), (12, (), 513, 1)])
def test_online_mvdr_mmic_matches_plain(cuda, M, lead, F, T):
    """The M-general online_mvdr instance against its plain loop (beam.linalgmm's
    Cholesky per frame): output and carried state, twice in a row from a
    state the plain loop warmed on 32 frames (a fresh state is ill-posed on
    its first frames, R = y y^H + a 1e-6 prime, where float32 orders part);
    one launch, counted as online_mvdr_mmic."""
    from azoom_torch.kernels.online_mvdr_kernel import initial_state, online_mvdr, online_mvdr_plain

    rng = np.random.default_rng(M + T)
    Y, nm, f, d = _online_case(rng, cuda, lead, F, T, M)
    kw = dict(target_mask=1 - nm, sigma=1e-6, mask_floor=0.05)
    st_k = initial_state(lead, F, M, cuda)
    Yw, nw, _, _ = _online_case(rng, cuda, lead, F, 32, M)
    online_mvdr_plain(Yw, nw, d, f, *st_k)
    st_p = tuple(a.clone() for a in st_k)
    for _ in range(2):
        kernels.reset_launches()
        got = online_mvdr(Y, nm, d, f, *st_k, **kw)
        assert _active(kernels.launches) == {"online_mvdr_mmic": 1}
        ref = online_mvdr_plain(Y, nm, d, f, *st_p, **kw)
        torch.cuda.synchronize()
        assert float((got - ref).abs().max()) <= 1e-4 * float(ref.abs().max())
        for a, b in zip(st_k, st_p):
            assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


@pytest.mark.parametrize("M,lead,T", [(3, (), 40), (4, (2,), 33), (8, (), 40), (4, (), 1875),
                                      (9, (), 40), (12, (2,), 33), (16, (), 40)])
def test_online_mvdr_mmic_one_launch_equals_one_launch_per_frame(cuda, M, lead, T):
    """T launches of one frame, the state carried through device memory in
    float32, give the bits of one launch over T frames."""
    from azoom_torch.kernels.online_mvdr_kernel import initial_state, online_mvdr

    rng = np.random.default_rng(5 + M)
    Y, nm, f, d = _online_case(rng, cuda, lead, 513, T, M)
    kw = dict(sigma=1e-6, mask_floor=0.05)
    g = 1 - nm
    st = initial_state(lead, 513, M, cuda)
    whole = online_mvdr(Y, nm, d, f, *st, target_mask=g, **kw)
    st1 = initial_state(lead, 513, M, cuda)
    steps = [online_mvdr(Y[..., t:t + 1].contiguous(), nm[..., t:t + 1].contiguous(), d, f, *st1,
                         target_mask=g[..., t:t + 1].contiguous(), **kw) for t in range(T)]
    assert torch.equal(_bits(torch.cat(steps, dim=-1)), _bits(whole))
    assert all(torch.equal(_bits(a), _bits(b)) for a, b in zip(st, st1))


def _bits(x):
    """The bit patterns of a float or complex tensor: NaN equals its own
    pattern (from a fresh state, the first frames above ~12 mics overflow
    float32 in places: see the next test)."""
    return (torch.view_as_real(x) if x.is_complex() else x).view(torch.int32)


def _not_finite(x):
    return ~torch.isfinite(torch.view_as_real(x)).all(-1)


def _c128(x):
    return x.to(torch.complex128) if x.is_complex() else x.double()


def _dist(a, b):
    """The largest |a - b| where both are finite."""
    a, b = _c128(a), _c128(b)
    ok = ~(_not_finite(a) | _not_finite(b))
    return float(torch.where(ok, (a - b).abs(), torch.zeros_like(b.real)).max())


@pytest.mark.parametrize("M", [12, 16])
def test_online_mvdr_mmic_from_a_fresh_state(cuda, M):
    """From a fresh state (a new stream) against the plain loop and its
    complex128 twin, which is finite everywhere. Frames t >= M: all finite,
    within the warmed bounds (output 1e-4, state 1e-5). Frames t < M solve
    t + 1 rank-one terms over a 1e-6 prime, past float32: the plain loop
    itself overflows x = R^-1 d in places there (in other places on the
    CPU than on the card), so non-finite outputs may lie there only."""
    from azoom_torch.kernels.online_mvdr_kernel import initial_state, online_mvdr, online_mvdr_plain

    T = 48
    Y, nm, f, d = _online_case(np.random.default_rng(40 + M), cuda, (), 513, T, M)
    kw = dict(sigma=1e-7, hp_cutoff_hz=100.0, forget=0.98, mask_floor=0.05)
    st_k, st_p = initial_state((), 513, M, cuda), initial_state((), 513, M, cuda)
    got = online_mvdr(Y, nm, d, f, *st_k, target_mask=1 - nm, **kw)
    ref = online_mvdr_plain(Y, nm, d, f, *st_p, target_mask=1 - nm, **kw)
    ref64 = online_mvdr_plain(_c128(Y), _c128(nm), _c128(d), _c128(f),
                              *(_c128(a) for a in initial_state((), 513, M, cuda)),
                              target_mask=_c128(1 - nm), **kw)
    torch.cuda.synchronize()
    assert not bool(_not_finite(ref64).any())
    late = slice(M, T)
    assert not bool(_not_finite(got[:, late]).any() or _not_finite(ref[:, late]).any())
    assert _dist(got[:, late], ref[:, late]) <= 1e-4 * float(ref[:, late].abs().max())
    for a, b in zip(st_k, st_p):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


@pytest.mark.parametrize("M", [8, 12, 16])
def test_online_mvdr_mmic_where_the_distortionless_denominator_overflows(cuda, M):
    """A quiet stream at a small loading (sigma 0, R_sum a random Hermitian
    matrix at 1e-24, y at 1e-13): d^H x ~ 1e24 M, whose |.|^2 overflows
    float32, while w = x / d^H x is well-conditioned. Both solvers (a thread
    a slot at M <= 8, a group of lanes above) give the plain loop's finite
    output and state at the warmed bounds."""
    from azoom_torch.kernels.online_mvdr_kernel import online_mvdr, online_mvdr_plain

    rng = np.random.default_rng(60 + M)
    Y, nm, f, d = _online_case(rng, cuda, (), 65, 8, M)
    A = _t((rng.standard_normal((65, M, M)) + 1j * rng.standard_normal((65, M, M)))
           .astype(np.complex64), cuda)
    H = A @ A.mH
    R0 = 1e-24 * ((H + H.mH) / (2 * M) + torch.eye(M, device=cuda))
    st_k = (R0.clone(), torch.ones(65, device=cuda))
    st_p = tuple(a.clone() for a in st_k)
    kw = dict(target_mask=1 - nm, sigma=0.0, mask_floor=0.05)
    got = online_mvdr(1e-13 * Y, nm, d, f, *st_k, **kw)
    ref = online_mvdr_plain(1e-13 * Y, nm, d, f, *st_p, **kw)
    torch.cuda.synchronize()
    assert not bool(_not_finite(got).any() or _not_finite(ref).any())
    assert float((got - ref).abs().max()) <= 1e-4 * float(ref.abs().max())
    for a, b in zip(st_k, st_p):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


def test_online_mvdr_runs_more_than_eight_mics_on_the_card(cuda):
    """Nine mics launch the M-general kernel; a mic count whose state
    snapshots do not fit one block's shared memory raises a ValueError that
    says so, and so do a steering vector or a state of the wrong width."""
    from azoom_torch.kernels.online_mvdr_kernel import initial_state, online_mvdr

    rng = np.random.default_rng(3)
    Y, nm, f, d = _online_case(rng, cuda, (), 33, 4, 9)
    kernels.reset_launches()
    S = online_mvdr(Y, nm, d, f, *initial_state((), 33, 9, cuda))
    torch.cuda.synchronize()
    assert _active(kernels.launches) == {"online_mvdr_mmic": 1}
    assert S.shape == (33, 4) and bool(torch.isfinite(torch.view_as_real(S)).all())
    Y, nm, f, d = _online_case(rng, cuda, (), 9, 2, 60)
    with pytest.raises(ValueError, match="shared memory"):
        online_mvdr(Y, nm, d, f, *initial_state((), 9, 60, cuda))
    Y, nm, f, d = _online_case(rng, cuda, (), 33, 4, 4)
    R, w = initial_state((), 33, 4, cuda)
    with pytest.raises(ValueError, match="d must be"):
        online_mvdr(Y, nm, d[:, :2].contiguous(), f, R, w)
    with pytest.raises(ValueError, match="R_sum"):
        online_mvdr(Y, nm, d, f, R[..., :2, :2].contiguous(), w)


@pytest.mark.parametrize("beamformer,n_nulls", [("mvdr", 1), ("hard_null", 3)])
def test_learned_path_at_four_mics_on_the_card(cuda, beamformer, n_nulls):
    """Four mics: the int8 net's 21 convs and 3 upsamplings as at M = 2, no
    launch of the 2-mic beamformer kernels (the M-mic MVDR or LCMV runs in
    torch on the card), and the CPU's output; the fused wrappers refuse M = 4."""
    from azoom_torch import learned_enhance, load_bundled

    rng = np.random.default_rng(12)
    mix = torch.from_numpy((0.1 * rng.standard_normal((2, 4, 32000))).astype(np.float32))
    cfg = PipelineConfig(mic_dist=0.04, n_mics=4)
    kw = dict(beamformer=beamformer, n_nulls=n_nulls, feature_kind="physics", steer_deg=60.0)
    model, model_cpu = load_bundled("tpufpu_nano")[0], load_bundled("tpufpu_nano", device="cpu")[0]
    kernels.reset_launches()
    routes = dict(route_counts)
    out = learned_enhance(mix.to(cuda), model, cfg, **kw)
    torch.cuda.synchronize()
    assert _active(kernels.launches) == {"qconv3x3": 21, "convt1x2": 3}
    assert {k: v - routes[k] for k, v in route_counts.items()} == {
        "wgmma": 20, "narrow": 1, "split": 0, "mma": 0}
    ref = learned_enhance(mix, model_cpu, cfg, **kw)
    assert float((out.cpu() - ref).norm() / ref.norm()) <= 1e-2
    Y = torch.zeros((1, 4, 513, 8), dtype=torch.complex64, device=cuda)
    m = torch.zeros((1, 513, 8), device=cuda)
    f = torch.zeros(513, device=cuda)
    d = torch.zeros((513, 4), dtype=torch.complex64, device=cuda)
    with pytest.raises(ValueError, match="2-mic"):
        masked_mvdr_fused(Y, m, d, f)
    with pytest.raises(ValueError, match="2-mic"):
        hard_null_fused(Y, m, d, f)


def test_low_latency_path_at_four_mics_on_the_card(cuda):
    """online_learned_enhance at M = 4: one online_mvdr_mmic launch and the
    CPU's waveform; OnlineEnhancer: one launch a hop and the card's offline
    output on the finalized samples."""
    from azoom_torch import load_bundled
    from azoom_torch.pipelines.online_learned import online_learned_enhance
    from azoom_torch.stream.lowlat import OnlineEnhancer

    rng = np.random.default_rng(8)
    mix = torch.from_numpy((0.1 * rng.standard_normal((4, 32000))).astype(np.float32))
    cfg = PipelineConfig(mic_dist=0.04, n_mics=4, angle_target_deg=75.0)
    net, net_cpu = load_bundled("crn_causal")[0], load_bundled("crn_causal", device="cpu")[0]
    kernels.reset_launches()
    out = online_learned_enhance(mix.to(cuda), net, cfg)
    torch.cuda.synchronize()
    assert _active(kernels.launches) == {"online_mvdr_mmic": 1}
    ref = online_learned_enhance(mix, net_cpu, cfg)
    assert float((out.cpu() - ref).norm() / ref.norm()) <= 1e-3
    oe = OnlineEnhancer(cfg, net, steer_deg=75.0)
    kernels.reset_launches()
    x = mix.numpy()
    st = np.concatenate([oe.push(x[:, i:i + 2048]) for i in range(0, x.shape[1], 2048)])
    assert _active(kernels.launches) == {"online_mvdr_mmic": x.shape[1] // cfg.hop}
    assert float(np.abs(st - out.cpu().numpy()[:st.shape[0]]).max()) <= 1e-5


def _cut_matrices_cpu():
    """Real 2x2 matrices with +0 and -0 imaginary parts, many on the complex
    square root's branch cut (tests/test_torch_beamformers.py)."""
    import itertools

    vals = np.array([-2.0, -1.0, 1.0, 3.0], np.float32)
    re = np.array(list(itertools.product(vals, repeat=4)), np.float32)
    sg = np.array(list(itertools.product([0.0, -0.0], repeat=4)), np.float32)
    A = np.empty((len(re) * len(sg), 4), np.complex64)
    A.real, A.imag = np.repeat(re, len(sg), axis=0), np.tile(sg, (len(re), 1))
    return torch.from_numpy(A.reshape(-1, 2, 2))


def test_eig_principal_on_the_branch_cut_on_the_card(cuda):
    """The card picks the same root as the CPU on the branch cut, whatever
    sign its complex products give the operand's imaginary zero."""
    from azoom_torch.beam.gev import eig_principal_2x2

    A = _cut_matrices_cpu()
    got, ref = eig_principal_2x2(A.to(cuda)).cpu(), eig_principal_2x2(A)
    bad = (got - ref).abs().amax(-1) > 1e-6
    assert not bool(bad.any()), f"{int(bad.sum())} matrices differ, e.g. {A[bad][:2]}"


@pytest.mark.parametrize("beamformer,kw", [("rmvb", {}), ("rtf", {}), ("wpd", {}),
                                           ("wpd", dict(fov_deg=30.0, harmonic_regen=True))])
def test_new_beamformers_on_the_card(cuda, beamformer, kw):
    """rmvb, rtf and wpd on the learned path: the int8 net's 21 convs and 3
    upsamplings, no B1 or B3 launch (the beamformers run in torch on the
    card), and the CPU's output."""
    from azoom_torch import learned_enhance, load_bundled

    rng = np.random.default_rng(5)
    mix = torch.from_numpy((0.1 * rng.standard_normal((2, 2, 32000))).astype(np.float32))
    cfg = PipelineConfig(mic_dist=0.04)
    kw = dict(beamformer=beamformer, feature_kind="physics", steer_deg=60.0, **kw)
    model, model_cpu = load_bundled("tpufpu_nano")[0], load_bundled("tpufpu_nano", device="cpu")[0]
    kernels.reset_launches()
    out = learned_enhance(mix.to(cuda), model, cfg, **kw)
    torch.cuda.synchronize()
    assert _active(kernels.launches) == {"qconv3x3": 21, "convt1x2": 3}
    ref = learned_enhance(mix, model_cpu, cfg, **kw)
    assert float((out.cpu() - ref).norm() / ref.norm()) <= 1e-2


def test_beamformer_solves_do_not_wait_for_the_host(cuda):
    """The WPD and WPE batched solves, RMVB's bisection and RTF's gate run
    without a host synchronisation (torch's sync debug mode raises on one),
    and a singular WPE bin gives NaN on the card as on the CPU, not an error."""
    from azoom_torch.beam.rmvb import rmvb_beamform
    from azoom_torch.beam.rtf import rtf_mvdr_beamform
    from azoom_torch.beam.wpd import wpd_beamform
    from azoom_torch.wpe import wpe

    rng = np.random.default_rng(6)
    Y = _t((rng.standard_normal((4, 2, 513, 64)) + 1j * rng.standard_normal((4, 2, 513, 64)))
           .astype(np.complex64), cuda)
    m = _t(rng.random((4, 513, 64), dtype=np.float32), cuda)
    f = rfft_freqs(1024, 16_000, device=cuda)
    d = steering_vector(f, 70.0, 0.04)
    Yw = Y[0].transpose(0, 1).contiguous()  # (F, C, T)
    Yw[100] = 0.0
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs = [wpd_beamform(Y, m, d, f, iterations=2), rmvb_beamform(Y, 1 - m, d, f),
                rtf_mvdr_beamform(Y, 1 - m, f, target_mask=m, d_fallback=d), wpe(Yw)]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    refs = [wpd_beamform(Y.cpu(), m.cpu(), d.cpu(), f.cpu(), iterations=2),
            rmvb_beamform(Y.cpu(), 1 - m.cpu(), d.cpu(), f.cpu()),
            rtf_mvdr_beamform(Y.cpu(), 1 - m.cpu(), f.cpu(), target_mask=m.cpu(), d_fallback=d.cpu()),
            wpe(Yw.cpu())]
    # random covariances are ill-conditioned: the card's float32 roundings
    # move the output by up to ~1e-3 of the CPU's (measured 1.0e-3)
    for name, got, ref in zip(("wpd", "rmvb", "rtf", "wpe"), outs, refs):
        got = got.cpu()
        assert torch.equal(torch.isfinite(got), torch.isfinite(ref)), name
        fin = torch.isfinite(ref)
        err = float((got[fin] - ref[fin]).norm() / ref[fin].norm())
        assert err <= 1e-2, f"{name}: {err:.3e}"
    assert not bool(torch.isfinite(outs[-1][100].cpu()).any())


def test_wpe_dereverb_on_the_card(cuda):
    from azoom_torch.wpe import wpe_dereverb

    rng = np.random.default_rng(9)
    n = 48_000
    dry = rng.standard_normal((2, n)) * np.exp(-np.arange(n) / 8000.0)
    tail = rng.standard_normal(4000) * np.exp(-np.arange(4000) / 800.0)
    x = np.stack([np.convolve(c, tail)[:n] for c in dry]).astype(np.float32)
    got = wpe_dereverb(x, PipelineConfig())
    assert got.device.type == "cuda" and got.shape == (2, n)
    ref = wpe_dereverb(x, PipelineConfig(), device="cpu")
    assert float((got.cpu() - ref).norm() / ref.norm()) <= 1e-3


def test_native_engine_under_the_cards_facade(cuda):
    """AudioZoom's default push (the C++ engine) on the card against its
    NumPy buffer (native=False): the same windows go to the card, only the
    overlap-add differs (within 1e-6)."""
    from azoom_torch import AudioZoom
    from azoom_torch.stream.native import NativeStream

    rng = np.random.default_rng(13)
    clip = (0.1 * rng.standard_normal((2, 5 * 16_000))).astype(np.float32)
    kw = dict(model="tpufpu_nano", int8=True, direction_deg=75.0)
    z_nat, z_np = AudioZoom(**kw), AudioZoom(native=False, **kw)
    assert isinstance(z_nat._native, NativeStream) and z_np._native is None
    outs = []
    for z in (z_nat, z_np):
        outs.append(np.concatenate([z.push(clip[:, s:s + 997])
                                    for s in range(0, clip.shape[1], 997)]))
    assert outs[0].shape == outs[1].shape == (3 * 16_000,)
    np.testing.assert_allclose(outs[0], outs[1], rtol=0, atol=1e-6)


def test_measurement_layer_on_the_card_matches_the_cpu(cuda):
    """stoi, bss_eval_sources and the resamplers on the card against the CPU:
    STOI within 1e-5, SDR and SIR within 0.05 dB, resampling within 1e-5 of
    the signal's peak."""
    from azoom_torch.dsp.resample import resample_fft, resample_poly
    from azoom_torch.eval import bss_eval_sources, stoi

    rng = np.random.default_rng(5)
    clean = rng.standard_normal((3, 48_000)).astype(np.float32)
    clean *= np.sin(np.linspace(0, 20, 48_000)).astype(np.float32) ** 2  # pauses
    noisy = clean + np.float32(0.5) * rng.standard_normal((3, 48_000)).astype(np.float32)
    got = stoi(clean, noisy)
    assert got.device.type == "cuda" and got.shape == (3,)
    assert float((got.cpu() - stoi(clean, noisy, device="cpu")).abs().max()) <= 1e-5
    x = rng.standard_normal((2, 137_815)).astype(np.float32)
    for fn, args in ((resample_poly, (20, 17)), (resample_poly, (5, 8)),
                     (resample_fft, (90_000,))):
        g, r = fn(x, *args), fn(x, *args, device="cpu")
        assert g.device.type == "cuda" and g.shape == r.shape
        assert float((g.cpu() - r).abs().max() / r.abs().max()) <= 1e-5
    S = rng.standard_normal((3, 16_000)).astype(np.float32)
    e = (S[0] + 0.3 * S[1] + 0.1 * rng.standard_normal(16_000)).astype(np.float32)
    g, r = bss_eval_sources(S, e, filter_len=128), bss_eval_sources(S, e, filter_len=128,
                                                                    device="cpu")
    for k in ("sdr", "sir", "sar"):
        assert g[k].device.type == "cuda" and abs(float(g[k]) - float(r[k])) <= 0.05, k


def test_scene_simulation_on_the_card_matches_the_cpu(cuda):
    """sim/ on the card from a CPU generator's draws against the same calls
    on the CPU: signals within 1e-4 relative L2 (music within 1e-3: a one-ulp
    note frequency from pow shifts its cumulative phase), RIRs at the C++
    engine test's bounds and the same bits in two runs (the sort-based
    scatter-add), scenes within 1e-3."""
    from azoom_torch.config import RoomConfig
    from azoom_torch.sim import make_moving_room_scene, make_moving_scene, make_scene
    from azoom_torch.sim.room import inverse_sabine, rir_matrix
    from azoom_torch.sim.scene import SceneSpec, generate_scene
    from azoom_torch.sim.signals import INTERFERER_KINDS, interferer_signal

    def g(seed):
        return torch.Generator().manual_seed(seed)

    def rel(a, b):
        return float((a.cpu().double() - b.double()).norm() / b.double().norm())

    for kind in INTERFERER_KINDS:
        got = interferer_signal(g(1), 64_000, kind=kind, f0=150.0)
        assert got.device.type == "cuda"
        ref = interferer_signal(g(1), 64_000, kind=kind, f0=150.0, device="cpu")
        assert rel(got, ref) <= (1e-3 if kind == "music" else 1e-4), kind
    room = RoomConfig()
    srcs = [[2.45, 3.45, 1.5], [3.22, 3.06, 1.5], [1.6, 1.4, 1.5]]
    a = inverse_sabine(0.5, room.room_dim)
    R1, R2 = (rir_matrix(srcs, room.mic_locs, room.room_dim, a, 15, 16_000, 9_600)
              for _ in range(2))
    R_cpu = rir_matrix(srcs, room.mic_locs, room.room_dim, a, 15, 16_000, 9_600, device="cpu")
    assert torch.equal(R1, R2)
    assert torch.allclose(R1.cpu(), R_cpu, atol=1e-4, rtol=1e-3)
    spec = SceneSpec(reverb=True, n_interferers=2, duration_s=2.0)
    sc = generate_scene(g(2), spec, room, max_order=6)
    sc_cpu = generate_scene(g(2), spec, room, max_order=6, device="cpu")
    for k in sc:
        assert sc[k].device.type == "cuda" and rel(sc[k], sc_cpu[k]) <= 1e-3, k
    src = torch.randn((3, 40_000), generator=g(3))
    ff = make_scene(src[0].to(cuda), src[1:].to(cuda), 70.0, [20.0, 140.0], 0.04, 16_000)
    ff_cpu = make_scene(src[0], src[1:], 70.0, [20.0, 140.0], 0.04, 16_000)
    mv = make_moving_scene(src[0].to(cuda), src[1:].to(cuda), torch.linspace(40, 140, 20),
                           [20.0, 160.0], 0.04, 16_000)
    mv_cpu = make_moving_scene(src[0], src[1:], torch.linspace(40, 140, 20), [20.0, 160.0],
                               0.04, 16_000)
    mr = make_moving_room_scene(g(4), src[0, :16_000].to(cuda), src[1:, :16_000].to(cuda),
                                torch.linspace(60, 120, 8), room, max_order=3)
    mr_cpu = make_moving_room_scene(g(4), src[0, :16_000], src[1:, :16_000],
                                    torch.linspace(60, 120, 8), room, max_order=3)
    for got, ref in ((ff, ff_cpu), (mv, mv_cpu), (mr, mr_cpu)):
        for k in ref:
            assert got[k].device.type == "cuda" and rel(got[k], ref[k]) <= 1e-4, k


def _metric_diff(a: dict, b: dict) -> dict:
    return {k: float((a[k].cpu().double() - b[k].cpu().double()).abs().max()) for k in b}


def _metrics_close(diff: dict) -> bool:
    """The metrics within 0.05 dB, STOI within 1e-4."""
    return all(v <= (1e-4 if k == "stoi" else 0.05) for k, v in diff.items())


def test_sweeps_on_the_card_match_the_cpu(cuda):
    """A few scenes of each sweep: B1 for the oracle, B2, convt1x2 and B3
    for the learned hard-null sweep in a reverberant room. The learned
    step on the same scenes is held at 0.05 dB; the whole learned sweep,
    scenes drawn on each side, at the facade's 0.1 dB and STOI 2e-3 (the
    int8 net flips codes under the room scenes' ulps, as phase 23 shows)."""
    from azoom_torch.config import RoomConfig
    from azoom_torch.models.pretrained import load_bundled
    from azoom_torch.parallel.sweep import learned_step, learned_sweep, oracle_sweep, sweep_scenes

    cfg = PipelineConfig(mic_dist=0.04)
    kw = dict(n_scenes=4, n_samples=16_000, with_stoi=True, randomize=True)
    kernels.reset_launches()
    got = oracle_sweep(1, cfg, **kw)
    assert {k: v for k, v in kernels.launches.items() if v} == {"masked_mvdr": 1}
    assert _metrics_close(_metric_diff(got, oracle_sweep(1, cfg, device="cpu", **kw)))
    net, fk = load_bundled("tpufpu_nano")
    net_cpu, _ = load_bundled("tpufpu_nano", device="cpu")
    kw = dict(n_scenes=2, n_samples=32_000, room=RoomConfig(max_order=6), beamformer="hard_null",
              feature_kind=fk)
    kernels.reset_launches()
    got = learned_sweep(2, cfg, net, **kw)
    assert {k: v for k, v in kernels.launches.items() if v} == {
        "qconv3x3": 21, "convt1x2": 3, "hard_null": 1}
    whole = _metric_diff(got, learned_sweep(2, cfg, net_cpu, **kw))
    assert all(v <= (2e-3 if k == "stoi" else 0.1) for k, v in whole.items()), whole
    sc = sweep_scenes(2, cfg, 2, n_samples=32_000, reverb=True, randomize=True,
                      room=RoomConfig(max_order=6))
    step_kw = dict(beamformer="hard_null", feature_kind=fk)
    step = _metric_diff(learned_step(sc, cfg, net, **step_kw),
                        learned_step({k: v.cpu() for k, v in sc.items()}, cfg, net_cpu, **step_kw))
    assert _metrics_close(step), step


@pytest.mark.parametrize("reverb", [False, True])
def test_a_sweeps_scenes_do_not_depend_on_its_chunk_on_the_card(cuda, reverb):
    """Scenes 0-3 of a campaign drawn in one block of 4 and in two blocks of 2
    give the same bits: far-field scenes with AWGN at 20 dB, and room
    scenes (sim.scene sums each row's power in a fixed order)."""
    from azoom_torch.config import RoomConfig
    from azoom_torch.parallel.sweep import sweep_scenes

    cfg = PipelineConfig(mic_dist=0.04)
    kw = dict(n_samples=16_000, randomize=True, reverb=reverb, snr_db=20.0)
    if reverb:
        kw["room"] = RoomConfig(max_order=6)
    whole = sweep_scenes(7, cfg, 4, **kw)
    halves = [sweep_scenes(7, cfg, 2, scene_offset=o, **kw) for o in (0, 2)]
    for k in ("mixture", "target_ref", "interference_ref"):
        assert torch.equal(whole[k], torch.cat([h[k] for h in halves])), k


def test_two_shards_on_the_card_match_one(cuda):
    """sharded_sweep and the server on ["cuda:0", "cuda:0"] against one shard."""
    import numpy as np

    from azoom_torch import AudioZoomServer
    from azoom_torch.parallel import make_mesh, oracle_sweep, sharded_sweep

    cfg = PipelineConfig(mic_dist=0.04)
    mesh = make_mesh(devices=["cuda:0", "cuda:0"])
    kw = dict(n_samples=16_000, with_stoi=True, randomize=True)
    assert _metrics_close(_metric_diff(sharded_sweep(oracle_sweep, 4, mesh, 8, cfg, **kw),
                                       oracle_sweep(4, cfg, n_scenes=8, **kw)))
    scfg = PipelineConfig(mic_dist=0.04, win_size=32_768)
    rng = np.random.default_rng(6)
    x = (0.1 * rng.standard_normal((4, 2, 32_768 + 3 * 16_384))).astype(np.float32)
    outs = []
    for m in (None, mesh):
        srv = AudioZoomServer(4, cfg=scfg, mask_reuse=True, wire="int16", track=True, mesh=m)
        for s in range(4):
            srv.set_zoom(s, direction_deg=50.0 + 25.0 * s, zoom=0.2 * s)
        outs.append(srv.push(x).astype(np.float32))
    rel = np.linalg.norm(outs[1] - outs[0]) / np.linalg.norm(outs[0])
    assert outs[0].shape == (4, 3 * 16_384) and rel <= 1e-4


def test_a_mesh_of_the_card_and_the_cpu_runs_a_thread_each(cuda):
    """A mesh of two distinct devices, ["cuda:0", "cpu"], takes
    run_on_devices' threaded path: each device's shard runs in a thread of
    its own (the card's with cuda:0 current), the net is replicated to the
    CPU, and the results gather on the card. Held at the card-against-CPU
    bounds: the oracle sweep 0.05 dB / STOI 1e-4, the learned sweep the
    facade's 0.1 dB / 2e-3, the learned chunker 1e-2 relative; an
    exception in the CPU's shard is raised."""
    import threading

    from azoom_torch import learned_enhance
    from azoom_torch.config import RoomConfig
    from azoom_torch.models.pretrained import load_bundled
    from azoom_torch.parallel import make_mesh, oracle_sweep, replicated, sharded_sweep
    from azoom_torch.parallel.sweep import learned_sweep
    from azoom_torch.stream.chunker import streaming_enhance, streaming_enhance_sharded

    cfg = PipelineConfig(mic_dist=0.04)
    mesh = make_mesh(devices=["cuda:0", "cpu"])
    kw = dict(n_samples=16_000, with_stoi=True, randomize=True)
    got = sharded_sweep(oracle_sweep, 4, mesh, 4, cfg, **kw)
    assert all(v.device == mesh.devices[0] for v in got.values())
    assert _metrics_close(_metric_diff(got, oracle_sweep(4, cfg, n_scenes=4, **kw)))

    net, fk = load_bundled("tpufpu_nano")
    lkw = dict(n_samples=32_000, room=RoomConfig(max_order=6), beamformer="hard_null",
               feature_kind=fk)
    kernels.reset_launches()
    got = sharded_sweep(learned_sweep, 2, mesh, 2, cfg, net, **lkw)
    assert _active(kernels.launches) == {"qconv3x3": 21, "convt1x2": 3, "hard_null": 1}
    whole = _metric_diff(got, learned_sweep(2, cfg, net, n_scenes=2, **lkw))
    assert all(v <= (2e-3 if k == "stoi" else 0.1) for k, v in whole.items()), whole

    reps, seen = replicated(mesh, net), {}

    def process(chunks):
        seen[chunks.device.type] = threading.get_ident()
        return learned_enhance(chunks, reps[chunks.device], cfg, feature_kind=fk, steer_deg=70.0)

    mix = torch.from_numpy((0.1 * np.random.default_rng(9).standard_normal(
        (2, 80_000))).astype(np.float32)).to(cuda)
    out = streaming_enhance_sharded(mix, process, mesh)
    threads = dict(seen)
    assert len(set(threads.values()) | {threading.get_ident()}) == 3, threads
    ref = streaming_enhance(mix, process)
    assert out.device.type == "cuda" and float((out - ref).norm() / ref.norm()) <= 1e-2

    def failing(seed, *a, device=None, **k):
        if torch.device(device).type == "cpu":
            raise FloatingPointError("the CPU's shard")
        return oracle_sweep(seed, *a, device=device, **k)

    with pytest.raises(FloatingPointError, match="the CPU's shard"):
        sharded_sweep(failing, 4, mesh, 4, cfg, **kw)


def test_a_train_step_on_the_card_matches_the_cpu(cuda):
    """One step of a narrow TPUFPU from the same init and batch on the card
    and the CPU in float32 and on the card in float64: a float32 step is
    ill-conditioned (BatchNorm's fast variance over few bottleneck frames,
    ReLU and max-pool decisions near ties), so each float32 run is measured
    leaf by leaf by its distance from float64 and each leaf held to its
    bound (azoom_torch.train.rounding: every gradient within GRAD_BOUND,
    every BatchNorm statistic's update and the loss on the card within
    CARD_FACTOR times the CPU's distance + FLOOR), as chip_smoke.py's phase
    24 holds the nano net."""
    from azoom_torch.models import trainable
    from azoom_torch.train import rounding
    from azoom_torch.train.data import synth_batch

    kw, n_samples, shape = rounding.CONFIGS["narrow"]
    b = synth_batch(0, 2, PipelineConfig(mic_dist=0.04), "physics", n_samples=n_samples,
                    device="cpu")
    dist = rounding.step_distances(lambda: trainable.TPUFPU(**kw), shape, b["features"],
                                   b["label"], cuda)
    assert len(dist["card"]["grad"]) > 50 and len(dist["card"]["bn"]) > 30
    assert not rounding.over_bound(dist), rounding.over_bound(dist)


def test_the_export_round_trip_serves_on_the_card(cuda, tmp_path):
    """A narrow trained TPUFPU calibrated on the card (every conv on the
    int8 kernel), saved, reloaded and served: its convs bit for bit against
    their plain version, its mask within the int8 nets' bound of the CPU's."""
    from azoom_torch.models import trainable
    from azoom_torch.models.convert import from_flax
    from azoom_torch.models.quantize import calibrate_act_scales, load_quantized, save_quantized
    from azoom_torch.models.unet import TPUFPU, QConv
    from azoom_torch.train.data import synth_batch

    cfg = PipelineConfig(mic_dist=0.04)
    kw = dict(base=32, fold=4, bneck=4, dec_div=2, enc_div=2)
    net = trainable.TPUFPU(**kw).init(torch.Generator().manual_seed(0), (1, 513, 64, 4))
    feats = synth_batch(3, 4, cfg, "physics", device=cuda)["features"]
    kernels.reset_launches()
    v = calibrate_act_scales(net, net.variables(), [feats], device=cuda)
    assert kernels.launches["qconv3x3"] == 21
    save_quantized(tmp_path / "net.npz", v)
    served = {d: from_flax(TPUFPU, load_quantized(tmp_path / "net.npz"), dict(kw, in_channels=4),
                           True, d) for d in ("cpu", cuda)}
    calls = []
    handles = [m.register_forward_pre_hook(lambda c, a, k: calls.append((c, a[0], k)),
                                           with_kwargs=True)
               for m in served[cuda].modules() if isinstance(m, QConv)]
    with torch.inference_mode():
        got = served[cuda](feats).cpu()
        ref = served["cpu"](feats.cpu())
    for h in handles:
        h.remove()
    assert len(calls) == 21
    for conv, x, k in calls:
        k = dict(residual=k.get("residual"), relu=k.get("relu", True), x2=k.get("x2"))
        assert torch.equal(qconv3x3(x, conv.w_q, conv.epi, conv.act_scale, **k),
                           qconv3x3_plain(x, conv.w_q, conv.epi, conv.act_scale, **k))
    assert float((got - ref).abs().max()) < 1e-2 and float((got - ref).abs().mean()) < 5e-4


def test_a_tfold_fattn_net_serves_its_convs_on_the_card(cuda):
    """An int8 TPUFPU(tfold=2, fattn=2) at the nano widths, calibrated on the
    card: its stem takes fold x tfold x 4 = 32 channels, which ``plan``
    routes to ``wgmma``; every conv runs on the route ``plan`` gives it, bit
    for bit against its plain version, and the mask is within the int8 nets'
    bound of the CPU's."""
    from azoom_torch.models import trainable
    from azoom_torch.models.convert import from_flax
    from azoom_torch.models.quantize import calibrate_act_scales
    from azoom_torch.models.unet import QConv
    from azoom_torch.train.data import synth_batch

    kw = dict(base=64, fold=4, bneck=4, dec_div=2, enc_div=2, tfold=2, fattn=2)
    net = trainable.TPUFPU(**kw).init(torch.Generator().manual_seed(0), (1, 513, 64, 4))
    feats = synth_batch(4, 2, PipelineConfig(mic_dist=0.04), "physics", device=cuda)["features"]
    cls, skw = net.serving_spec()
    kernels.reset_launches()
    v = calibrate_act_scales(net, net.variables(), [feats], device=cuda)
    calib_launches = kernels.launches["qconv3x3"]
    served = {d: from_flax(cls, v, skw, True, d) for d in ("cpu", cuda)}
    n_convs = sum(isinstance(m, QConv) for m in served[cuda].modules())
    assert calib_launches == n_convs == 21
    calls = []
    handles = [m.register_forward_pre_hook(lambda c, a, k: calls.append((c, a[0], k)),
                                           with_kwargs=True)
               for m in served[cuda].modules() if isinstance(m, QConv)]
    routes0 = dict(route_counts)
    with torch.inference_mode():
        got = served[cuda](feats).cpu()
        ref = served["cpu"](feats.cpu())
    routes = {r: route_counts[r] - routes0[r] for r in route_counts}
    for h in handles:
        h.remove()
    assert len(calls) == n_convs
    stem = calls[0][1]
    assert stem.shape[-1] == 32 and plan(32, 64, stem.shape[-2])["kernel"] == "wgmma"
    want = {}
    for conv, x, k in calls:
        cin = x.shape[-1] + (k["x2"].shape[-1] if k.get("x2") is not None else 0)
        r = plan(cin, conv.w_q.shape[0], x.shape[-2])["kernel"]
        want[r] = want.get(r, 0) + 1
        k = dict(residual=k.get("residual"), relu=k.get("relu", True), x2=k.get("x2"))
        assert torch.equal(qconv3x3(x, conv.w_q, conv.epi, conv.act_scale, **k),
                           qconv3x3_plain(x, conv.w_q, conv.epi, conv.act_scale, **k))
    assert routes == {r: want.get(r, 0) for r in route_counts}, (routes, want)
    assert got.shape == (2, 513, 64) and bool(torch.isfinite(got).all())
    assert float((got - ref).abs().max()) < 1e-2 and float((got - ref).abs().mean()) < 5e-4


def test_the_train_cli_trains_and_resumes_on_the_card_by_default(cuda, tmp_path, capsys):
    """``python -m azoom_torch.cli.train`` without ``--device`` trains a
    tiny FPU on the card (its memory is used), checkpoints, and a second
    run resumes to 5 steps, as tests/test_torch_cli_train.py runs it on the
    CPU."""
    from pathlib import Path

    from azoom_torch.cli import train as cli

    ckpt = tmp_path / "ckpt"
    args = ["--model", "fpu", "--base", "2", "--batch", "1", "--seconds", "0.512",
            "--ckpt", str(ckpt)]
    torch.cuda.reset_peak_memory_stats()
    cli.main(args + ["--steps", "3"])
    assert torch.cuda.max_memory_allocated() > 0
    cli.main(args + ["--steps", "5"])
    out = capsys.readouterr().out
    assert "finished at step 3" in out and "resumed from step 3" in out
    assert "finished at step 5" in out
    assert sorted(p.name for p in Path(ckpt).glob("step_*.pt")) == [
        "step_000000003.pt", "step_000000005.pt"]


@pytest.mark.parametrize("cin,cout,t,res,cat,kernel", [
    (4, 32, 64, False, False, None), (16, 64, 64, False, False, None),
    (64, 64, 32, True, False, None), (128, 64, 64, False, True, None),
    (256, 256, 6, True, False, None), (128, 64, 16, False, True, "mma")])
def test_dynamic_scales_match_plain_and_the_static_launch(cuda, cin, cout, t, res, cat, kernel):
    """B2 forming one activation scale per batch element from its input's
    maxima in device memory (the reference QConv's dynamic mode; a pair at a
    concat) on the narrow (a physics stem among them), wgmma, split and
    mma.sync routes, on signed inputs whose elements lie decades apart (one
    all zeros at a concat): the scales bit for bit the CPU's, the output bit
    for bit its plain version and, element by element, the static launch at
    that element's scale; the maxima it writes of its output bit for bit
    vector_norm(inf)'s, and the plain version's."""
    rng = np.random.default_rng(cin + cout + t)
    x, w, epi, r = _conv_case(rng, cuda, 3, 129, t, cin, cout, res)
    signs = np.sign(rng.standard_normal(tuple(x.shape))) * np.array([1, 1e-3, 30]).reshape(3, 1, 1, 1)
    x = x * _t(signs.astype(np.float32), cuda)
    x[2].view(-1)[7] = -2 * float(x[2].abs().max())  # element 2's largest magnitude is negative
    kw = dict(residual=r, _kernel=kernel)
    in_max = input_max(x)
    if cat:
        x, kw["x2"] = x[..., :cin // 2].contiguous(), x[..., cin // 2:].contiguous()
        x[1], kw["x2"][1] = 0.0, 0.0  # element 1 is all zeros: scale 1e-30
        x[0] *= 1e-2  # element 0's larger maximum is in x2
        in_max = (input_max(x), input_max(kw["x2"]))
    s = dynamic_act_scale(x, kw.get("x2"))
    x2 = kw.get("x2")
    assert torch.equal(s.cpu(), dynamic_act_scale(x.cpu(), None if x2 is None else x2.cpu()))
    epi[0] = _t(1e-3 * (1 + rng.random(cout)).astype(np.float32), cuda)  # the weight scales
    kernels.reset_launches()
    out_max = torch.zeros(3, device=cuda)
    got = qconv3x3(x, w, epi, None, **kw, in_max=in_max, out_max=out_max)
    assert kernels.launches["qconv3x3_dynamic"] == 1 and kernels.launches["qconv3x3"] == 0
    assert torch.equal(out_max.view(torch.int32), input_max(got).view(torch.int32))
    plain_kw = {k: v for k, v in kw.items() if k != "_kernel"}
    plain_max = torch.zeros(3, device=cuda)
    assert torch.equal(got, qconv3x3_plain(x, w, epi, None, **plain_kw, in_max=in_max,
                                           out_max=plain_max))
    assert torch.equal(plain_max, out_max)
    for b in range(3):
        one = {k: v if v is None or k == "_kernel" else v[b:b + 1] for k, v in kw.items()}
        epi_b = epi.clone()
        epi_b[0] = s[b] * epi[0]
        assert torch.equal(got[b:b + 1], qconv3x3(x[b:b + 1], w, epi_b, float(s[b]), **one)), b


def test_a_training_checkpoint_serves_int8_on_the_card(cuda, tmp_path):
    """A port checkpoint of the nano twin served by the batch CLI's loader
    with --int8: every conv on B2 with a dynamic scale (21 launches), each
    bit for bit against its plain version, the mask within the int8 nets'
    bound of the CPU's."""
    from azoom_torch.cli.checkpoint import load_checkpoint, twin
    from azoom_torch.models.unet import QConv
    from azoom_torch.train.data import synth_batch
    from azoom_torch.train.loop import create_state, save_checkpoint

    state = create_state(twin("tpufpu_nano", "physics"), 0, (1, 513, 64, 4), device=cuda)
    state.step = 3
    save_checkpoint(tmp_path, state)
    served = {d: load_checkpoint("tpufpu_nano", tmp_path, "physics", True, d)[0]
              for d in ("cpu", cuda)}
    feats = synth_batch(5, 2, PipelineConfig(mic_dist=0.04), "physics", device=cuda)["features"]
    calls = []
    handles = [m.register_forward_pre_hook(lambda c, a, k: calls.append((c, a[0], k)),
                                           with_kwargs=True)
               for m in served[cuda].modules() if isinstance(m, QConv)]
    kernels.reset_launches()
    with torch.inference_mode():
        got = served[cuda](feats).cpu()
    assert kernels.launches["qconv3x3_dynamic"] == 21 and kernels.launches["qconv3x3"] == 0
    with torch.inference_mode():
        ref = served["cpu"](feats.cpu())
    for h in handles:
        h.remove()
    for conv, x, k in calls:
        x2 = k.get("x2")
        k = dict(residual=k.get("residual"), relu=k.get("relu", True), x2=x2,
                 in_max=input_max(x, x2))
        assert torch.equal(qconv3x3(x, conv.w_q, conv.epi, None, **k),
                           qconv3x3_plain(x, conv.w_q, conv.epi, None, **k))
    assert float((got - ref).abs().max()) < 1e-2 and float((got - ref).abs().mean()) < 5e-4


# The net's three upsamplings (a 96-row tile crosses an element every ~10 to
# 40 tiles) and a plane of 6 rows an element (every tile crosses many).
@pytest.mark.parametrize("k,cout,f_rows,t,batch", [
    (256, 128, 129, 8, 5), (128, 64, 129, 16, 3), (64, 64, 129, 32, 3), (36, 20, 3, 2, 70)])
def test_convt_kernel_writes_the_maxima_of_its_output(cuda, k, cout, f_rows, t, batch):
    rng = np.random.default_rng(k + t + batch)
    x = _t(rng.standard_normal((batch, f_rows, t, k)).astype(np.float32), cuda)
    x[1] = 0.0  # an all-zero element: its maximum is the bias's
    x[2] *= 1e-3
    w = _t((0.05 * rng.standard_normal((k, 2 * cout))).astype(np.float32), cuda)
    b = _t((0.1 * rng.standard_normal(cout)).astype(np.float32), cuda)
    out_max = torch.zeros(batch, device=cuda)
    kernels.reset_launches()
    got = convt1x2(x, w, b, out_max)
    assert kernels.launches["convt1x2"] == 1
    assert torch.equal(got, convt1x2(x, w, b))
    assert torch.equal(out_max.view(torch.int32), input_max(got).view(torch.int32))
    assert float(out_max[1]) == float(b.abs().max())


def test_the_dynamic_nano_net_equals_its_unfused_wiring_on_the_card(cuda, monkeypatch):
    """The bundled nano net without its calibrated scales at batch 6: 21
    dynamic launches, 3 upsamplings and the stem's one reduction; every
    producer's maxima bit for bit vector_norm(inf) of its output, and the
    mask bit for bit the wiring where each conv reduces its own input."""
    from azoom_torch.models import unet
    from azoom_torch.models.convert import from_flax
    from azoom_torch.models.pretrained import _PORTED, ASSETS, artifact_name
    from azoom_torch.models.quantize import load_quantized
    from azoom_torch.train.data import synth_batch

    v = load_quantized(ASSETS / artifact_name("tpufpu_nano")[0])
    net = from_flax(unet.TPUFPU, {k: v[k] for k in ("params", "batch_stats")},
                    _PORTED["tpufpu_nano"][2], True, cuda)
    feats = synth_batch(6, 6, PipelineConfig(mic_dist=0.04), "physics", device=cuda)["features"]
    feats[1] = 0.0
    calls, reductions = [], []
    handles = [m.register_forward_hook(
        lambda mod, a, kw, y: calls.append((kw.get("out_max", a[1] if len(a) > 1 else None), y)),
        with_kwargs=True) for m in net.modules() if isinstance(m, (unet.QConv, unet.ConvTranspose1x2))]
    counted = unet.input_max
    monkeypatch.setattr(unet, "input_max", lambda *a: reductions.append(a) or counted(*a))
    kernels.reset_launches()
    with torch.inference_mode():
        got = net(feats)
    for h in handles:
        h.remove()
    assert {k: n for k, n in kernels.launches.items() if n} == {"qconv3x3_dynamic": 21,
                                                                  "convt1x2": 3}
    assert len(reductions) == 1 and len(calls) == 24
    written = [(m, y) for m, y in calls if m is not None]
    assert len(written) == 20
    for m, y in written:
        assert torch.equal(m.view(torch.int32), input_max(y).view(torch.int32))

    def unfused(self, x, residual=None, relu=True, x2=None, in_max=None, out_max=None):
        return qconv3x3(x, self.w_q, self.epi, None, residual, relu, x2,
                        in_max=counted(x, x2))

    monkeypatch.setattr(unet.QConv, "forward", unfused)
    with torch.inference_mode():
        want = net(feats)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_the_run_cli_writes_the_library_call_on_the_card(cuda, tmp_path):
    """``cli.run full`` without ``--device`` on the card: the int8 nano
    net's MVDR output is the library call's on the card bit for bit, and
    ``batch --per-run`` runs two scenes."""
    from azoom_torch.cli import batch, run
    from azoom_torch.io.wav import read_wav
    from azoom_torch.models.pretrained import load_bundled
    from azoom_torch.pipelines.learned import learned_enhance_streaming

    root = ["--name", "c", "--duration", "2", "--data-root", str(tmp_path)]
    kernels.reset_launches()
    run.main(["full", *root, "--beamformer", "mvdr", "--model", "tpufpu_nano", "--int8"])
    assert kernels.launches["qconv3x3"] == 21 and kernels.launches["masked_mvdr"] == 1
    mix = read_wav(tmp_path / "simulated" / "c" / "mixture.wav")[0]
    got = read_wav(tmp_path / "results" / "c_results" / "c_enhanced.wav")[0]
    net, kind = load_bundled("tpufpu_nano", quant=True, device=cuda)
    with torch.inference_mode():
        want = learned_enhance_streaming(_t(mix.T, cuda), net, PipelineConfig(), "mvdr", kind)
    assert np.array_equal(got, want.cpu().numpy())
    assert batch.main(["--per-run", "--n", "2", "--duration", "1", "--data-root",
                       str(tmp_path / "batch")]) == (2, 0)


def _any_width_case(rng, dev, batch, f_rows, t, cin, cout, res, cin1):
    """Operands of a conv at any width: the packed weights of any Cin, and at a
    concat (``cin1`` channels in x, the rest in x2) the two inputs."""
    x = _t(rng.standard_normal((batch, f_rows, t, cin)).astype(np.float32), dev)
    w = pack_weights(torch.from_numpy(
        rng.integers(-127, 128, (3, 3, cin, cout)).astype(np.int8))).to(dev)
    epi = _t(np.stack([np.full(cout, 2e-4), *(0.1 * rng.standard_normal((2, cout))),
                       1 + 0.1 * rng.standard_normal(cout), 0.1 * rng.standard_normal(cout)])
             .astype(np.float32), dev)
    kw = dict(residual=_t(rng.standard_normal((batch, f_rows, t, cout)).astype(np.float32), dev)
              if res else None)
    if cin1 is not None:
        x, kw["x2"] = x[..., :cin1].contiguous(), x[..., cin1:].contiguous()
    return x, w, epi, kw


# Widths the reference serves that no bundled net has: Cout of 8, 24, 48, 1024 (four
# slices) and odd ones; Cin of 1, 3, 20, 1024 and 2048 (halo parts at 64 frames); concats
# whose halves are not multiples of 4 channels; ragged rows and one-frame planes. The
# any-width instances of csrc/qconv_kernel.cu take them but the inputs they do not read
# (Cin of 1 or 3, halves that are not multiples of 4), which stay on the mma.sync route.
# batch, F, T, Cin, Cout, residual, Cin1 of a concat.
@pytest.mark.parametrize("batch,f_rows,t,cin,cout,res,cin1", [
    (2, 131, 64, 2, 8, False, None), (3, 13, 7, 1, 24, True, None),
    (1, 131, 64, 3, 48, False, None), (2, 40, 1, 20, 48, True, None),
    (1, 33, 8, 48, 96, True, None), (2, 17, 16, 96, 1024, False, None),
    (1, 9, 64, 1024, 1024, True, None), (1, 5, 64, 2048, 24, False, None),
    (1, 7, 80, 1024, 512, False, 512), (2, 11, 5, 40, 24, True, 20),
    (1, 131, 33, 30, 8, False, 10), (3, 9, 1, 21, 7, True, 13),
    (1, 129, 64, 6, 5, False, 3), (1, 1, 1, 2048, 1024, True, 1024),
    (2, 513, 16, 384, 192, True, 192), (1, 65, 48, 20, 1, False, None)])
def test_mma_route_at_any_width_bit_equal_to_plain(cuda, batch, f_rows, t, cin, cout, res, cin1):
    """Static and dynamic: the output bit for bit the plain version's, the
    maxima a dynamic launch writes bit for bit vector_norm(inf)'s and the
    plain version's."""
    rng = np.random.default_rng(17 * cin + cout + t + f_rows)
    how = plan(cin, cout, t, cin1)
    unread = cin % 4 and cin != 2 if cin1 is None else cin1 % 4 or (cin - cin1) % 4
    assert how["wide"] == (not unread) and (how["kernel"] == "mma") == bool(unread)
    x, w, epi, kw = _any_width_case(rng, cuda, batch, f_rows, t, cin, cout, res, cin1)
    before = dict(route_counts)
    got = qconv3x3(x, w, epi, 0.026, **kw)
    assert route_counts[how["kernel"]] == before[how["kernel"]] + 1
    assert torch.equal(got, qconv3x3_plain(x, w, epi, 0.026, **kw))
    assert torch.equal(got, qconv3x3(x, w, epi, 0.026, **kw, _kernel="mma"))
    in_max = input_max(x, kw.get("x2"))
    maxima = [torch.zeros(batch, device=cuda) for _ in range(2)]
    dyn = qconv3x3(x, w, epi, None, **kw, in_max=in_max, out_max=maxima[0])
    assert torch.equal(dyn, qconv3x3_plain(x, w, epi, None, **kw, in_max=in_max,
                                           out_max=maxima[1]))
    assert torch.equal(maxima[0].view(torch.int32), input_max(dyn).view(torch.int32))
    assert torch.equal(maxima[0], maxima[1])


# The any-width instances of csrc/qconv_kernel.cu: masked Cout (5, 24, 36, 47, 48, 96,
# 192, 384) on N = 32, 64, 128, 256 and in slices of 256 (384, 512, 1024); taps of 16 *
# odd channels (16, 48, 80) and Cin past its channels (20 as 32); a stem of 2; halo parts
# kept for every slice (384 -> 384 in three, 512 -> 1024 in two) or remade for each
# (1024 -> 1024, 1024 -> 512 at a concat, 2048 -> 1024 in 8, 1024 -> 24 and 2048 -> 96 on
# one slice); a weight ring on one slice (96 -> 192, 80 -> 47 at one frame); concats,
# residuals, ragged frames (1, 5, 7) and rows. batch, F, T, Cin, Cout, residual, Cin1.
@pytest.mark.parametrize("batch,f_rows,t,cin,cout,res,cin1", [
    (2, 131, 64, 48, 24, True, None), (1, 513, 64, 2, 48, False, None),
    (3, 33, 7, 80, 48, True, None), (2, 129, 5, 48, 96, False, 24),
    (1, 131, 16, 96, 192, True, None), (2, 17, 8, 192, 384, True, None),
    (1, 40, 8, 384, 384, False, 192), (1, 129, 4, 512, 1024, True, None),
    (1, 65, 4, 1024, 1024, True, None), (1, 33, 8, 1024, 512, False, 512),
    (1, 9, 8, 2048, 1024, True, None), (2, 7, 1, 80, 47, True, None),
    (3, 11, 5, 16, 5, False, None), (1, 131, 7, 1024, 24, False, None),
    (2, 17, 1, 2048, 96, True, None), (1, 40, 80, 20, 36, True, None)])
def test_any_width_instances_bit_equal_static_and_dynamic(cuda, batch, f_rows, t, cin, cout, res,
                                                          cin1):
    """Static and dynamic: the output bit for bit the plain version's and the
    mma.sync kernel's, the maxima a dynamic launch writes bit for bit
    vector_norm(inf)'s, the plain version's and the mma.sync kernel's."""
    rng = np.random.default_rng(19 * cin + cout + t + f_rows)
    how = plan(cin, cout, t, cin1)
    assert how["wide"] and how["kernel"] in ("wgmma", "narrow", "split")
    x, w, epi, kw = _any_width_case(rng, cuda, batch, f_rows, t, cin, cout, res, cin1)
    before = dict(route_counts)
    got = qconv3x3(x, w, epi, 0.026, **kw)
    assert route_counts[how["kernel"]] == before[how["kernel"]] + 1
    assert torch.equal(got, qconv3x3_plain(x, w, epi, 0.026, **kw))
    assert torch.equal(got, qconv3x3(x, w, epi, 0.026, **kw, _kernel="mma"))
    in_max = input_max(x, kw.get("x2"))
    maxima = [torch.zeros(batch, device=cuda) for _ in range(3)]
    dyn = qconv3x3(x, w, epi, None, **kw, in_max=in_max, out_max=maxima[0])
    assert torch.equal(dyn, qconv3x3_plain(x, w, epi, None, **kw, in_max=in_max,
                                           out_max=maxima[1]))
    assert torch.equal(dyn, qconv3x3(x, w, epi, None, **kw, in_max=in_max, out_max=maxima[2],
                                     _kernel="mma"))
    assert torch.equal(maxima[0].view(torch.int32), input_max(dyn).view(torch.int32))
    assert torch.equal(maxima[0], maxima[1]) and torch.equal(maxima[0], maxima[2])


# Odd K and odd Cout (2*Cout % 4 == 2): a short last K chunk, W staged in 8-byte pairs,
# the last column pair of a tile masked; with and without the maxima.
@pytest.mark.parametrize("k,cout,f_rows,t,batch", [
    (10, 5, 129, 8, 3), (6, 3, 33, 16, 2), (1, 1, 7, 4, 2), (383, 191, 17, 5, 2),
    (20, 65, 129, 3, 2), (13, 130, 9, 8, 3)])
def test_convt_kernel_at_odd_widths(cuda, k, cout, f_rows, t, batch):
    """Each output one FMA chain in K order, then the bias: bit for bit the
    plain version's but where its float64 emulation of the FMA rounds twice
    (rare ties, counted)."""
    rng = np.random.default_rng(3 * k + cout)
    x = _t(rng.standard_normal((batch, f_rows, t, k)).astype(np.float32), cuda)
    w = _t((0.05 * rng.standard_normal((k, 2 * cout))).astype(np.float32), cuda)
    b = _t((0.1 * rng.standard_normal(cout)).astype(np.float32), cuda)
    out_max = torch.zeros(batch, device=cuda)
    got, ref = convt1x2(x, w, b, out_max), convt1x2_plain(x, w, b)
    assert got.shape == (batch, f_rows, 2 * t, cout)
    ties = int((got != ref).sum())
    print(f"[convt] K {k} Cout {cout}: {ties} of {got.numel()} outputs off the plain version")
    assert float((got - ref).abs().max()) <= 1e-6 * float(ref.abs().max())
    assert ties <= got.numel() // 100_000 + 1
    assert torch.equal(got, convt1x2(x, w, b))
    assert torch.equal(out_max.view(torch.int32), input_max(got).view(torch.int32))


def test_a_net_at_another_base_serves_on_the_card(cuda):
    """An int8 FreqPreservingUNet at base 24 (a seeded init of its trainable
    twin, calibrated on the card: every conv on a route of
    csrc/qconv_kernel.cu, its any-width instances, none on mma.sync), static
    and dynamic, against the same net on the CPU (convt1x2's plain version
    rounds twice on rare ties); its convs bit for bit the plain version."""
    from azoom_torch.models import trainable
    from azoom_torch.models.convert import from_flax
    from azoom_torch.models.quantize import calibrate_act_scales
    from azoom_torch.models.unet import FreqPreservingUNet, QConv

    twin = trainable.FreqPreservingUNet(base=24).init(torch.Generator().manual_seed(3),
                                                      (1, 513, 64, 2))
    rng = np.random.default_rng(5)
    feats = torch.from_numpy(rng.standard_normal((2, 513, 64, 2)).astype(np.float32))
    v = calibrate_act_scales(twin, twin.variables(), [feats], device=cuda)
    kw = dict(base=24, in_channels=2)
    for tree in (v, {k: v[k] for k in ("params", "batch_stats")}):  # static, dynamic
        net = from_flax(FreqPreservingUNet, tree, kw, True, cuda)
        before = dict(route_counts)
        with torch.inference_mode():
            got = net(feats.to(cuda)).cpu()
            ref = from_flax(FreqPreservingUNet, tree, kw, True, "cpu")(feats)
        assert route_counts["mma"] == before["mma"]
        assert sum(route_counts.values()) - sum(before.values()) == 14
        err = (got - ref).abs()  # the whole-net int8 bounds, as the bundled nets'
        assert float(err.max()) < 1e-2 and float(err.mean()) < 2e-4
    calls = []
    net = from_flax(FreqPreservingUNet, v, kw, True, cuda)
    for m in net.modules():
        if isinstance(m, QConv):
            m.register_forward_pre_hook(lambda c, a, k: calls.append((c, a[0], k)),
                                        with_kwargs=True)
    with torch.inference_mode():
        net(feats.to(cuda))
        for conv, x, k in calls:
            k = dict(residual=k.get("residual"), relu=k.get("relu", True), x2=k.get("x2"))
            assert torch.equal(qconv3x3(x, conv.w_q, conv.epi, conv.act_scale, **k),
                               qconv3x3_plain(x, conv.w_q, conv.epi, conv.act_scale, **k))
