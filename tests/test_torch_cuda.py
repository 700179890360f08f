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
from azoom_torch.kernels.mvdr_kernel import masked_mvdr_fused
from azoom_torch.kernels.qconv_kernel import k_padded, qconv3x3, qconv3x3_plain

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


def test_convt_kernel_matches_plain(cuda):
    rng = np.random.default_rng(2)
    x = _t(np.abs(rng.standard_normal((2, 129, 8, 256))).astype(np.float32), cuda)
    w = _t((0.05 * rng.standard_normal((256, 256))).astype(np.float32), cuda)
    b = _t((0.1 * rng.standard_normal(128)).astype(np.float32), cuda)
    got, ref = convt1x2(x, w, b), convt1x2_plain(x, w, b)
    assert float((got - ref).abs().max()) <= 1e-6 * float(ref.abs().max())


def test_main_path_launches_and_matches_cpu(cuda):
    from azoom_torch import learned_enhance, load_bundled

    rng = np.random.default_rng(3)
    mix = torch.from_numpy((0.1 * rng.standard_normal((2, 2, 32000))).astype(np.float32))
    cfg = PipelineConfig(mic_dist=0.04)
    model, _ = load_bundled("tpufpu_nano")
    kernels.reset_launches()
    out = learned_enhance(mix.to(cuda), model, cfg, steer_deg=60.0)
    torch.cuda.synchronize()
    assert kernels.launches == {"qconv3x3": 21, "masked_mvdr": 1, "convt1x2": 3}
    ref = learned_enhance(mix, load_bundled("tpufpu_nano", device="cpu")[0], cfg, steer_deg=60.0)
    assert float((out.cpu() - ref).norm() / ref.norm()) <= 1e-2
