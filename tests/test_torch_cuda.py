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
    k_padded, pack_weights, plan, qconv3x3, qconv3x3_plain,
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
    out = learned_enhance(mix.to(cuda), model, cfg, **kw)
    torch.cuda.synchronize()
    assert _active(kernels.launches) == {"qconv3x3": 21, kernel: 1, "convt1x2": 3}
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


def _online_case(rng, dev, lead, F, T):
    shape = lead + (2, F, T)
    Y = torch.complex(_t(rng.standard_normal(shape).astype(np.float32), dev),
                      _t(rng.standard_normal(shape).astype(np.float32), dev))
    nm = _t(rng.random(lead + (F, T), dtype=np.float32), dev)
    f = _t((np.arange(F) * 8000.0 / max(F - 1, 1)).astype(np.float32), dev)
    return Y, nm, f, steering_vector(f, 60.0, 0.04)


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
