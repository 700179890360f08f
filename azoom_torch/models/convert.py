"""Carry a flax variables tree of a mask net (the conv nets
FreqPreservingUNet, DeepFPU, TPUFPU; the causal CRN) across into the port's
modules.

The tree is nested dicts of numpy arrays with the collections ``params``,
``batch_stats`` and, for the int8 serving path, ``quant_stats`` (the
calibrated static activation scales; without it the int8 convs take the
reference's dynamic scales, one per batch element), as
:func:`azoom_torch.models.quantize.load_quantized` returns it or as a flax
model's variables give it after ``numpy`` conversion. In the int8 mode each
3x3 conv is quantised here, once, with QConv's formula, and its dequant and
BatchNorm become the rows of the conv kernel's epilogue; in the float mode
the kernel is kept as it is and ``quant_stats`` is ignored. The CRN is
float only (:func:`crn_from_flax`).
"""

from __future__ import annotations

import numpy as np
import torch

from azoom_torch.config import resolve_device
from azoom_torch.kernels.qconv_kernel import epilogue_params, pack_weights, quantize_weights
from azoom_torch.models.crn import CRNMaskNet
from azoom_torch.models.layers import FreqAttention
from azoom_torch.models.unet import (
    TPUFPU, ConvBNRelu, ConvTranspose1x2, FConv, Head, QConv, ResBlock,
)

__all__ = [
    "from_flax", "tpufpu_from_flax", "crn_from_flax", "load_qconv", "load_fconv",
    "load_conv_transpose",
]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def load_qconv(conv: QConv, conv_params: dict, act_scale, bn_params=None, bn_stats=None) -> None:
    """Fill ``conv`` from a flax Conv's params (``kernel`` (3, 3, Cin, Cout),
    ``bias``), its calibrated ``act_scale`` (None: the dynamic scales of
    each call, the epilogue's row 0 then the weight scales) and an optional
    BatchNorm (params ``scale``/``bias``, stats ``mean``/``var``)."""
    w_q, w_scale = quantize_weights(_t(conv_params["kernel"]))
    bn = None
    if bn_params is not None:
        bn = (_t(bn_params["scale"]), _t(bn_params["bias"]),
              _t(bn_stats["mean"]), _t(bn_stats["var"]))
    if act_scale is not None:
        act_scale = float(np.float32(act_scale))
    epi = epilogue_params(1.0 if act_scale is None else act_scale, w_scale,
                          _t(conv_params["bias"]), bn)
    if w_q.shape[2:] != (conv.cin, conv.cout):
        raise ValueError(f"kernel {tuple(w_q.shape)} does not fit QConv({conv.cin}, {conv.cout})")
    conv.w_q.copy_(pack_weights(w_q))
    conv.epi.copy_(epi)
    conv.act_scale = act_scale


def load_fconv(conv: FConv, conv_params: dict, bn_params=None, bn_stats=None) -> None:
    """Fill ``conv`` from a flax Conv's params and an optional BatchNorm, for
    the float path: the kernel as (9 * Cin, Cout) rows in tap-major order,
    the epilogue rows with b1 = bias."""
    kernel = _t(conv_params["kernel"])
    if tuple(kernel.shape) != (3, 3, conv.cin, conv.cout):
        raise ValueError(
            f"kernel {tuple(kernel.shape)} does not fit FConv({conv.cin}, {conv.cout})")
    bn = None
    if bn_params is not None:
        bn = (_t(bn_params["scale"]), _t(bn_params["bias"]),
              _t(bn_stats["mean"]), _t(bn_stats["var"]))
    conv.weight.copy_(kernel.reshape(9 * conv.cin, conv.cout))
    conv.epi.copy_(epilogue_params(1.0, torch.ones(conv.cout), _t(conv_params["bias"]), bn))


def load_conv_transpose(up: ConvTranspose1x2, params: dict) -> None:
    """Fill ``up`` from a flax ConvTranspose (1, 2) kernel (1, 2, Cin, Cout)."""
    k = _t(params["kernel"])
    up.weight.copy_(torch.cat([k[0, 1], k[0, 0]], dim=1))
    up.bias.copy_(_t(params["bias"]))


def _load_conv(conv, p: dict, s: dict, q: dict | None, i: int) -> None:
    """Conv_i and BatchNorm_i of a flax cell into ``conv`` (a QConv or an
    FConv); ``q`` the cell's quant_stats, None for a float conv or dynamic
    scales."""
    bn_p, bn_s = p[f"BatchNorm_{i}"], s[f"BatchNorm_{i}"]
    if isinstance(conv, FConv):
        load_fconv(conv, p[f"Conv_{i}"], bn_p, bn_s)
    elif q is None:
        load_qconv(conv, p[f"Conv_{i}"], None, bn_p, bn_s)
    else:
        load_qconv(conv, p[f"Conv_{i}"], q[f"Conv_{i}"]["act_scale"], bn_p, bn_s)
        # where it came from, for quantize.calibrate_act_scales
        conv.flax_source = (p[f"Conv_{i}"], bn_p, bn_s, q[f"Conv_{i}"])


def _load_cell(m, p: dict, s: dict, q: dict | None) -> None:
    if isinstance(m, ConvBNRelu):
        _load_conv(m.conv, p, s, q, 0)
    elif isinstance(m, ResBlock):
        for i, conv in enumerate((m.conv0, m.conv1)):
            _load_conv(conv, p, s, q, i)
    else:  # DoubleConv
        for i, cbr in enumerate((m.cbr0, m.cbr1)):
            name = f"ConvBNRelu_{i}"
            _load_cell(cbr, p[name], s[name], None if q is None else q[name])


def from_flax(cls, variables: dict, model_kwargs: dict, quant: bool = True, device=None):
    """Build the port's ``cls`` (FreqPreservingUNet, DeepFPU or TPUFPU) with
    ``model_kwargs`` and carry the flax ``variables`` across, walking
    ``cls.FLAX_NAMES``. ``quant`` serves the int8 convs or the float ones.
    The int8 convs take the calibrated static scales of
    ``variables['quant_stats']`` where it is present; without it (a training
    checkpoint) each conv quantises its input with the reference QConv's
    dynamic scale, max|x| / 127 + 1e-30 of each batch element's input (one
    chunk or scene, as the reference applies such a net under ``jax.vmap``).
    Returns the model on ``device`` in eval mode: CUDA when ``device`` is
    None (a RuntimeError without a card), ``"cpu"`` for the plain path."""
    device = resolve_device(device)
    kw = {k: v for k, v in model_kwargs.items() if k not in ("quant", "dtype")}
    p, s = variables["params"], variables["batch_stats"]
    if cls is TPUFPU and "FreqAttention_0" in p and "n_freqs" not in kw:
        # the position embedding's rows are the folded rows it was made for
        kw["n_freqs"] = np.shape(p["FreqAttention_0"]["pos_emb"])[0] * kw.get("fold", 4)
    model = cls(**kw, quant=quant)
    q = variables.get("quant_stats") if quant else None
    with torch.no_grad():
        for attr, name in cls.FLAX_NAMES.items():
            m = getattr(model, attr)
            if m is None:  # an optional block the net was built without
                continue
            if isinstance(m, FreqAttention):
                m.load_variables({"params": p[name], "batch_stats": {}})
            elif isinstance(m, ConvTranspose1x2):
                load_conv_transpose(m, p[name])
            elif isinstance(m, Head):
                m.weight.copy_(_t(p[name]["kernel"])[0, 0])
                m.bias.copy_(_t(p[name]["bias"]))
            else:
                _load_cell(m, p[name], s[name], None if q is None else q[name])
    return model.to(device).eval()


def tpufpu_from_flax(variables: dict, model_kwargs: dict, device=None):
    """:func:`from_flax` for the int8 TPUFPU (``in_channels`` defaults to the
    4 physics features), on CUDA unless ``device`` names another."""
    return from_flax(TPUFPU, variables, model_kwargs, True, device)


def crn_from_flax(variables: dict, model_kwargs: dict, device=None) -> CRNMaskNet:
    """Build the port's CRNMaskNet with ``model_kwargs`` (base, hidden,
    n_lstm, unidirectional) and carry the flax ``variables`` of
    azoom.models.crn.CRNMaskNet across. The frequency count comes from
    Dense_0's kernel (F / 8 rows of 4 * base channels, F padded to a
    multiple of 8; 513 unless ``n_freqs`` is given). The flax cells are
    named in the order they were built: OptimizedLSTMCell_i for layer i, or
    2i (forward) and 2i + 1 (backward) when bidirectional. Returns the model
    on ``device`` in eval mode: CUDA when ``device`` is None (a RuntimeError
    without a card), ``"cpu"`` for the plain path."""
    device = resolve_device(device)
    kw = {k: v for k, v in model_kwargs.items() if k != "dtype"}
    p, s = variables["params"], variables["batch_stats"]
    model = CRNMaskNet(**kw)
    flat = np.shape(p["Dense_0"]["kernel"])[0]
    if flat != model.rows * 4 * model.base:
        raise ValueError(f"Dense_0 takes {flat} inputs; the net at n_freqs={model.n_freqs} "
                         f"flattens {model.rows * 4 * model.base}")
    with torch.no_grad():
        for name, convs in (("_FreqDown", model.down), ("_FreqUp", model.up)):
            for k, conv in enumerate(convs):
                cp, bs = p[f"{name}_{k}"], s[f"{name}_{k}"]["BatchNorm_0"]
                kernel = cp["ConvTranspose_0" if conv.up else "Conv_0"]
                bn = cp["BatchNorm_0"]
                epi = epilogue_params(1.0, torch.ones(conv.cout), _t(kernel["bias"]),
                                      (_t(bn["scale"]), _t(bn["bias"]), _t(bs["mean"]),
                                       _t(bs["var"])))
                conv.load(_t(kernel["kernel"]), *epi[1:])
        model.w_in.copy_(_t(p["Dense_0"]["kernel"]))
        model.b_in.copy_(_t(p["Dense_0"]["bias"]))
        model.w_out.copy_(_t(p["Dense_1"]["kernel"]))
        model.b_out.copy_(_t(p["Dense_1"]["bias"]))
        cells = [(model.fwd[i], 2 * i if model.bwd else i) for i in range(model.n_lstm)]
        cells += [(model.bwd[i], 2 * i + 1) for i in range(len(model.bwd))]
        for lstm, j in cells:
            c = p[f"OptimizedLSTMCell_{j}"]
            lstm.wi.copy_(torch.cat([_t(c[f"i{g}"]["kernel"]) for g in "ifgo"], dim=1))
            lstm.wh.copy_(torch.cat([_t(c[f"h{g}"]["kernel"]) for g in "ifgo"], dim=1))
            lstm.bh.copy_(torch.cat([_t(c[f"h{g}"]["bias"]) for g in "ifgo"]))
        model.w_head.copy_(_t(p["Conv_0"]["kernel"]).reshape(model.base, 1))
        model.b_head.copy_(_t(p["Conv_0"]["bias"]))
    return model.to(device).eval()
