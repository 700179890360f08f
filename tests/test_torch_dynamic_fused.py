"""The int8 nets on dynamic activation scales, wired without a pass of their
own (CPU, plain path): every conv and upsampling raises its output's row of
per-element maxima, and each conv forms its scale from the rows of its
inputs (models/unet.py, kernels/qconv_kernel.py, kernels/convt_kernel.py).

No JAX here: tests/test_torch_dynamic_int8.py holds the dynamic nets against
the reference. This file holds the wiring against the wiring it replaced,
each conv taking ``dynamic_act_scale`` of its own input, run element by
element as static convs at those scales. Tolerances: none; the maxima, the
scales and the masks are compared bit for bit (a maximum is exact, so only
where it is taken changes).

The nets are TPUFPU(**TINY) (tests/test_torch_quantize_export.py: tfold 2,
attention) and base-8 FreqPreservingUNet and DeepFPU, random weights from
numpy, batches of 3 whose element 1 is all zeros and element 2 lies three
decades below element 0. The first upsampling's weights are scaled down, so
that its concat's larger maximum lies in the skip.
"""

import numpy as np
import pytest
import torch

from azoom_torch.kernels import qconv_kernel as qk
from azoom_torch.kernels.convt_kernel import convt1x2, convt1x2_plain
from azoom_torch.models import convert, unet
from azoom_torch.models.layers import FreqAttention
from azoom_torch.models.unet import (
    TPUFPU, ConvTranspose1x2, DeepFPU, FreqPreservingUNet, Head, QConv,
)

TINY = dict(base=16, fold=4, bneck=2, tfold=2, fattn=2)
# name -> (net, input (F, T, C)); the frames are what each net takes
NETS = {
    "tpufpu": (lambda: TPUFPU(**TINY), (513, 16, 4)),
    "fpu": (lambda: FreqPreservingUNet(base=8, in_channels=2), (12, 8, 2)),
    "deepfpu": (lambda: DeepFPU(base=8, in_channels=4), (10, 16, 4)),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, dtype=np.float32))


def _net(name):
    """The net with random weights and every conv on dynamic scales, and its
    input batch."""
    make, (f, t, c) = NETS[name]
    net = make()
    rng = np.random.default_rng(sorted(NETS).index(name))
    ups = [m for m in net.modules() if isinstance(m, ConvTranspose1x2)]
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, QConv):
                w = rng.standard_normal((3, 3, m.cin, m.cout)) / np.sqrt(9 * m.cin)
                w_q, w_scale = qk.quantize_weights(_t(w))
                bn = (_t(0.7 + 0.6 * rng.random(m.cout)), _t(0.1 * rng.standard_normal(m.cout)),
                      _t(0.1 * rng.standard_normal(m.cout)), _t(0.5 + rng.random(m.cout)))
                m.w_q.copy_(qk.pack_weights(w_q))
                m.epi.copy_(qk.epilogue_params(1.0, w_scale, _t(0.1 * rng.standard_normal(m.cout)),
                                               bn))
                m.act_scale = None
            elif isinstance(m, ConvTranspose1x2):
                scale = 1e-2 if m is ups[0] else 1.0
                m.weight.copy_(_t(scale * rng.standard_normal(m.weight.shape)
                                  / np.sqrt(m.weight.shape[0])))
                m.bias.copy_(_t(0.1 * scale * rng.standard_normal(m.cout)))
            elif isinstance(m, (Head, FreqAttention)):
                for p in [*m.parameters(), *m.buffers()]:
                    p.copy_(_t(0.1 * rng.standard_normal(p.shape)))
    x = np.abs(rng.standard_normal((3, f, t, c))).astype(np.float32)
    x[1] = 0.0
    x[2] *= 1e-3
    return net.eval(), torch.from_numpy(x)


def _parent_forward(self, x, residual=None, relu=True, x2=None, in_max=None, out_max=None):
    """A dynamic QConv as the wiring before it ran: ``dynamic_act_scale`` of
    its own input, then each element as a static conv at its scale."""
    s = qk.dynamic_act_scale(x, x2)
    outs = []
    for b in range(x.shape[0]):
        epi = self.epi.clone()
        epi[0] = s[b] * self.epi[0]
        one = [None if a is None else a[b:b + 1] for a in (residual, x2)]
        outs.append(qk.qconv3x3_plain(x[b:b + 1], self.w_q, epi, float(s[b]), one[0], relu,
                                      one[1]))
    return torch.cat(outs)


@pytest.fixture(scope="module")
def runs():
    """name -> (net, input, mask, the calls of every QConv and upsampling:
    (module, inputs, in_max, out_max, output), the reductions taken)."""
    out = {}
    for name in NETS:
        net, x = _net(name)
        calls, reductions = [], []

        def hook(mod, args, kwargs, y):
            x2 = kwargs.get("x2")
            out_max = kwargs.get("out_max", args[1] if len(args) > 1 else None)
            calls.append((mod, args[0], x2, kwargs.get("in_max"), out_max, y))

        counted = qk.input_max

        def reduce(*a):
            reductions.append(a)
            return counted(*a)

        handles = [m.register_forward_hook(hook, with_kwargs=True) for m in net.modules()
                   if isinstance(m, (QConv, ConvTranspose1x2))]
        unet.input_max = reduce
        try:
            with torch.inference_mode():
                mask = net(x)
        finally:
            unet.input_max = counted
            for h in handles:
                h.remove()
        out[name] = (net, x, mask, calls, reductions)
    return out


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("name", list(NETS))
def test_every_producer_writes_the_maxima_of_its_output(runs, name):
    """Each row a conv or upsampling raised is vector_norm(inf) of its output
    bit for bit, and each conv read the maxima of its inputs, a concat's two
    apart: after a pool, its producer's row."""
    _, _, _, calls, reductions = runs[name]
    convs = [c for c in calls if isinstance(c[0], QConv)]
    n_convs = sum(isinstance(m, QConv) for m in runs[name][0].modules())
    assert len(convs) == n_convs
    written = 0
    for mod, _, _, _, out_max, y in calls:
        if out_max is not None:
            written += 1
            assert np.array_equal(_bits(out_max), _bits(qk.input_max(y))), mod
    # all but the outputs that only an upsampling or the head reads
    assert written == len(calls) - sum(isinstance(c[0], ConvTranspose1x2) for c in calls) - 1
    assert convs[0][3] is None and len(reductions) == 1  # the stem's input: one reduction
    skip_larger = 0
    for mod, x, x2, in_max, _, _ in convs[1:]:
        if x2 is None:
            assert np.array_equal(_bits(in_max), _bits(qk.input_max(x))), mod
        else:
            assert np.array_equal(_bits(in_max[0]), _bits(qk.input_max(x)))
            assert np.array_equal(_bits(in_max[1]), _bits(qk.input_max(x2)))
            skip_larger += int((in_max[1] > in_max[0]).sum())
    assert skip_larger > 0


@pytest.mark.parametrize("name", list(NETS))
def test_the_mask_is_the_earlier_wiring_bit_for_bit(runs, name, monkeypatch):
    net, x, mask, _, _ = runs[name]
    monkeypatch.setattr(QConv, "forward", _parent_forward)
    with torch.inference_mode():
        want = net(x)
    assert mask.shape == x.shape[:3] and torch.isfinite(mask).all()
    assert np.array_equal(mask.numpy().view(np.uint32), want.numpy().view(np.uint32))


@pytest.mark.parametrize("name", list(NETS))
def test_an_element_alone_gives_what_it_gives_in_its_batch(runs, name):
    net, x, mask, _, _ = runs[name]
    with torch.inference_mode():
        for b in (0, 2):
            assert torch.equal(net(x[b:b + 1]), mask[b:b + 1]), b


def test_a_pool_keeps_the_maximum_over_even_frames_only():
    """Of a ReLU'd tensor over an even frame count the pooled maximum is the
    tensor's; over an odd count the dropped last frame may hold it, and the
    pooled tensor gets no row (the conv that reads it reduces it)."""
    rng = np.random.default_rng(5)
    for t in (6, 7):
        y = torch.relu(_t(rng.standard_normal((2, 3, t, 4))))
        y[:, :, -1] = 9.0  # the last frame holds each element's maximum
        row = qk.input_max(y)
        p, m = unet._pool(y, row)
        assert p.shape[2] == t // 2
        if t % 2 == 0:
            assert m is row and np.array_equal(_bits(qk.input_max(p)), _bits(row))
        else:
            assert m is None and (qk.input_max(p) < row).all()


def test_the_rows_follow_the_scales_as_they_are_set():
    """A net gets maxima rows while every conv is dynamic, and none once a
    conv takes a static scale again: the kept count follows each set."""
    net = TPUFPU(**TINY)
    x = torch.zeros(2, 513, 16, 4)
    convs = [m for m in net.modules() if isinstance(m, QConv)]
    assert unet._maxima_rows(net, x)() is None  # static scales
    for m in convs:
        m.act_scale = None
    row = unet._maxima_rows(net, x)()
    assert row.shape == (2,) and not row.any()
    convs[3].act_scale = 0.5
    assert unet._maxima_rows(net, x)() is None


def test_the_conv_forms_the_scale_from_maxima_and_raises_out_max():
    """The wrapper's dynamic mode on the CPU: the pair of a concat's maxima
    gives the output of dynamic_act_scale's value as a static conv, element
    by element; out_max is raised in place, only where the output's maximum
    is larger; static scales take no maxima, and a concat takes its maxima
    as a pair only."""
    rng = np.random.default_rng(6)
    x, x2 = _t(rng.standard_normal((3, 5, 4, 16))), _t(rng.standard_normal((3, 5, 4, 16)))
    x2[1] *= 50.0  # element 1's maximum is in x2
    x[2] = 0.0
    x2[2] = 0.0  # element 2 is all zeros: scale 1e-30
    w_q, w_scale = qk.quantize_weights(_t(0.2 * rng.standard_normal((3, 3, 32, 64))))
    w_q = qk.pack_weights(w_q)
    epi = qk.epilogue_params(1.0, w_scale, _t(0.1 * rng.standard_normal(64)))
    pair = (qk.input_max(x), qk.input_max(x2))
    out_max = torch.tensor([0.0, 0.0, 1e9])
    assert all(torch.equal(a, b) for a, b in zip(qk.input_max(x, x2), pair))
    got = qk.qconv3x3(x, w_q, epi, None, x2=x2, in_max=pair, out_max=out_max)
    s = qk.dynamic_act_scale(x, x2)
    assert float(s[2]) == np.float32(1e-30)
    for b in range(3):
        e = epi.clone()
        e[0] = s[b] * epi[0]
        assert torch.equal(got[b:b + 1], qk.qconv3x3(x[b:b + 1], w_q, e, float(s[b]),
                                                      x2=x2[b:b + 1])), b
    want = qk.input_max(got)
    assert torch.equal(out_max[:2], want[:2]) and float(out_max[2]) == 1e9
    for kw in (dict(out_max=torch.zeros(3)), dict(in_max=pair)):
        with pytest.raises(ValueError):
            qk.qconv3x3(x, w_q, epi, 0.01, x2=x2, **kw)
    for in_max in (None, torch.maximum(*pair), pair[:1]):
        with pytest.raises(ValueError):
            qk.qconv3x3(x, w_q, epi, None, x2=x2, in_max=in_max)
    with pytest.raises(ValueError):
        qk.qconv3x3(x, w_q, epi, None, in_max=pair)


def test_the_upsampling_raises_out_max():
    rng = np.random.default_rng(7)
    x = _t(rng.standard_normal((3, 4, 5, 8)))
    x[1] = 0.0
    w, bias = _t(rng.standard_normal((8, 12))), _t(rng.standard_normal(6))
    out_max = torch.zeros(3)
    y = convt1x2(x, w, bias, out_max)
    assert torch.equal(y, convt1x2_plain(x, w, bias))
    assert np.array_equal(_bits(out_max), _bits(qk.input_max(y)))
    assert float(out_max[1]) == float(bias.abs().max())  # a zero element: the bias alone


@pytest.mark.parametrize("fn", ["from_flax", "tpufpu_from_flax", "crn_from_flax"])
def test_the_weight_carrying_entry_points_default_to_the_card(fn, monkeypatch):
    """Without ``device`` they resolve to CUDA, and raise without a card
    before they touch the variables; ``device="cpu"`` takes the plain path."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = {"from_flax": (TPUFPU, {}, {}), "tpufpu_from_flax": ({}, {}),
            "crn_from_flax": ({}, {})}[fn]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(convert, fn)(*args)
