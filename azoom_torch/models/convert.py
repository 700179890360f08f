"""Carry a flax TPUFPU variables tree across into the port's modules.

The tree is nested dicts of numpy arrays with the collections ``params``,
``batch_stats`` and ``quant_stats`` (the calibrated static activation
scales the int8 serving path needs), as
:func:`azoom_torch.models.quantize.load_quantized` returns it or as a flax
model's variables give it after ``numpy`` conversion. Each 3x3 conv is
quantised here, once, with QConv's formula, and its dequant and BatchNorm
become the rows of the conv kernel's epilogue.
"""

from __future__ import annotations

import numpy as np
import torch

from azoom_torch.kernels.qconv_kernel import epilogue_params, pack_weights, quantize_weights
from azoom_torch.models.unet import (
    TPUFPU, ConvBNRelu, ConvTranspose1x2, DoubleConv, Head, QConv, ResBlock,
)

__all__ = ["tpufpu_from_flax", "load_qconv", "load_conv_transpose"]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def load_qconv(conv: QConv, conv_params: dict, act_scale, bn_params=None, bn_stats=None) -> None:
    """Fill ``conv`` from a flax Conv's params (``kernel`` (3, 3, Cin, Cout),
    ``bias``), its calibrated ``act_scale`` and an optional BatchNorm
    (params ``scale``/``bias``, stats ``mean``/``var``)."""
    w_q, w_scale = quantize_weights(_t(conv_params["kernel"]))
    bn = None
    if bn_params is not None:
        bn = (_t(bn_params["scale"]), _t(bn_params["bias"]),
              _t(bn_stats["mean"]), _t(bn_stats["var"]))
    act_scale = float(np.float32(act_scale))
    epi = epilogue_params(act_scale, w_scale, _t(conv_params["bias"]), bn)
    if w_q.shape[2:] != (conv.cin, conv.cout):
        raise ValueError(f"kernel {tuple(w_q.shape)} does not fit QConv({conv.cin}, {conv.cout})")
    conv.w_q.copy_(pack_weights(w_q))
    conv.epi.copy_(epi)
    conv.act_scale = act_scale


def load_conv_transpose(up: ConvTranspose1x2, params: dict) -> None:
    """Fill ``up`` from a flax ConvTranspose (1, 2) kernel (1, 2, Cin, Cout)."""
    k = _t(params["kernel"])
    up.weight.copy_(torch.cat([k[0, 1], k[0, 0]], dim=1))
    up.bias.copy_(_t(params["bias"]))


def _load_cbr(m: ConvBNRelu, p, s, q) -> None:
    load_qconv(m.conv, p["Conv_0"], q["Conv_0"]["act_scale"], p["BatchNorm_0"], s["BatchNorm_0"])


def _load_res(m: ResBlock, p, s, q) -> None:
    for i, conv in enumerate((m.conv0, m.conv1)):
        load_qconv(conv, p[f"Conv_{i}"], q[f"Conv_{i}"]["act_scale"],
                   p[f"BatchNorm_{i}"], s[f"BatchNorm_{i}"])


def _load_double(m: DoubleConv, p, s, q) -> None:
    for i, cbr in enumerate((m.cbr0, m.cbr1)):
        name = f"ConvBNRelu_{i}"
        _load_cbr(cbr, p[name], s[name], q[name])


def tpufpu_from_flax(variables: dict, model_kwargs: dict, device="cpu") -> TPUFPU:
    """Build the port's TPUFPU with ``model_kwargs`` (base, fold, bneck,
    dec_div, enc_div, ...; ``in_channels`` defaults to the 4 physics
    features) and carry the flax ``variables`` across. Returns the model on
    ``device`` in eval mode."""
    if "quant_stats" not in variables:
        raise ValueError(
            "the int8 serving path needs calibrated static activation scales "
            "(variables['quant_stats'])"
        )
    kw = {k: v for k, v in model_kwargs.items() if k not in ("quant", "dtype")}
    model = TPUFPU(**kw)
    p, s, q = variables["params"], variables["batch_stats"], variables["quant_stats"]
    with torch.no_grad():
        for attr, name in TPUFPU.FLAX_NAMES.items():
            m = getattr(model, attr)
            if isinstance(m, ConvTranspose1x2):
                load_conv_transpose(m, p[name])
            elif isinstance(m, Head):
                m.weight.copy_(_t(p[name]["kernel"])[0, 0])
                m.bias.copy_(_t(p[name]["bias"]))
            elif isinstance(m, DoubleConv):
                _load_double(m, p[name], s[name], q[name])
            elif isinstance(m, ResBlock):
                _load_res(m, p[name], s[name], q[name])
            else:
                _load_cbr(m, p[name], s[name], q[name])
    return model.to(device).eval()
