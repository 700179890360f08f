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
    k_padded, pack_weights, plan, qconv3x3, qconv3x3_plain, route_counts,
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
# of 8: Cin, Cout, T, residual, concat.
@pytest.mark.parametrize("cin,cout,t,res,cat", [
    (256, 512, 4, False, False), (512, 512, 4, True, False), (512, 256, 8, False, True),
    (256, 512, 8, True, False), (512, 512, 8, False, False), (512, 256, 16, True, True),
    (256, 256, 6, True, False), (256, 256, 7, False, False), (512, 512, 3, True, False),
    (256, 512, 6, False, False)])
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

# 3, 4 and 8 mics on one stream of 513 bins; several streams of a ragged F;
# one frame (a hop)
@pytest.mark.parametrize("M,lead,F,T", [(3, (), 513, 300), (4, (), 513, 300), (8, (), 513, 300),
                                        (4, (3,), 37, 50), (4, (), 513, 1), (8, (2,), 65, 33)])
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


@pytest.mark.parametrize("M,lead,T", [(3, (), 40), (4, (2,), 33), (8, (), 40), (4, (), 1875)])
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
    assert torch.equal(torch.cat(steps, dim=-1), whole)
    assert all(torch.equal(a, b) for a, b in zip(st, st1))


def test_online_mvdr_refuses_more_than_eight_mics_on_the_card(cuda):
    from azoom_torch.kernels.online_mvdr_kernel import initial_state, online_mvdr

    rng = np.random.default_rng(3)
    Y, nm, f, d = _online_case(rng, cuda, (), 33, 4, 9)
    with pytest.raises(NotImplementedError, match="registers"):
        online_mvdr(Y, nm, d, f, *initial_state((), 33, 9, cuda))
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
