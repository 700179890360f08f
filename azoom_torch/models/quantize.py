"""Weight quantization and export of the mask nets (counterpart of
azoom.models.quantize), with no JAX.

An artifact holds a flax variables tree flattened to '/'-joined keys.
Large weights are stored as ``<path>/__q__`` int8 codes plus a
``<path>/__scale__`` float32 per-channel scale; everything else is stored
as it is (``np.savez_compressed``).

:func:`quantize_variables`, :func:`dequantize_variables`,
:func:`quantized_size_bytes`, :func:`quantization_error`,
:func:`save_quantized` and :func:`fold_batchnorm` work on numpy trees in
float32 as the reference does (per-last-axis scales, round half to even,
tensors under 64 elements or 1-D left in float), so their arrays equal the
reference's bit for bit. :func:`calibrate_act_scales` runs the int8 serving
net (``convert.from_flax``; on CUDA every 3x3 conv on the int8 conv kernel)
over calibration batches and records each conv's static activation scale.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from azoom_torch.config import resolve_device

__all__ = [
    "quantize_variables", "dequantize_variables", "quantized_size_bytes", "quantization_error",
    "save_quantized", "load_quantized", "calibrate_act_scales", "fold_batchnorm",
]

_MIN_QUANT_SIZE = 64  # leave tiny tensors (biases, BN) in float
_BN_EPS = 1e-5  # flax nn.BatchNorm's default (no net overrides it)
_CALIB_PCT = 99.9  # |x| percentile recorded during calibration


def _is_qpair(x) -> bool:
    return isinstance(x, dict) and set(x) == {"q", "scale"}


def _tree_map(fn, tree, is_leaf=lambda x: False):
    if is_leaf(tree) or not isinstance(tree, dict):
        return fn(tree)
    return {k: _tree_map(fn, v, is_leaf) for k, v in tree.items()}


def _leaves(tree) -> list:
    """Leaves in jax's order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    return [tree]


def _quantize_leaf(w):
    w = np.asarray(w)
    if w.ndim < 2 or w.size < _MIN_QUANT_SIZE:
        return w  # float passthrough
    w = w.astype(np.float32, copy=False)
    scale = np.max(np.abs(w), axis=tuple(range(w.ndim - 1)), keepdims=True) / np.float32(127.0)
    scale = np.where(scale == 0, np.float32(1.0), scale).astype(np.float32)
    q = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
    return {"q": q, "scale": scale}


def quantize_variables(variables: dict) -> dict:
    """Every >= 2-D weight of at least 64 elements to int8 codes with a
    per-last-axis float32 scale ({"q", "scale"}); the rest stays float."""
    return _tree_map(_quantize_leaf, variables)


def dequantize_variables(qvariables: dict, dtype=np.float32) -> dict:
    """Inverse of :func:`quantize_variables`: q * scale in float32."""
    def leaf(x):
        if _is_qpair(x):
            return (np.asarray(x["q"]).astype(np.float32) * np.asarray(x["scale"])).astype(dtype)
        return x
    return _tree_map(leaf, qvariables, _is_qpair)


def quantized_size_bytes(qvariables: dict) -> int:
    """Bytes of every leaf (int8 codes, scales, float passthroughs)."""
    return int(sum(np.asarray(leaf).nbytes for leaf in _leaves(qvariables)))


def quantization_error(variables: dict, qvariables: dict) -> float:
    """Max relative weight error of the quantization (< 1/127 per channel
    by construction), in float32 as the reference computes it."""
    worst = 0.0
    for o, d in zip(_leaves(variables), _leaves(dequantize_variables(qvariables))):
        o = np.asarray(o, dtype=np.float32)
        denom = np.max(np.abs(o)) + np.float32(1e-12)
        worst = max(worst, float(np.max(np.abs(o - d)) / denom))
    return worst


def save_quantized(path, variables: dict) -> int:
    """Quantize a variables tree and write it as one ``.npz`` (the reference's
    layout: '/'-joined keys, ``__q__`` / ``__scale__`` pairs). Returns the
    bytes written."""
    flat = {}

    def walk(prefix, node):
        if _is_qpair(node):
            flat[prefix + "/__q__"] = np.asarray(node["q"])
            flat[prefix + "/__scale__"] = np.asarray(node["scale"])
        elif isinstance(node, dict):
            for k, v in node.items():
                walk(f"{prefix}/{k}" if prefix else k, v)
        else:
            flat[prefix] = np.asarray(node)

    walk("", quantize_variables(variables))
    path = os.fspath(path)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(path, **flat)
    return os.path.getsize(path)


def fold_batchnorm(variables: dict) -> dict:
    """Absorb every Conv_i -> BatchNorm_i pair (one module's params, matching
    channels) into the conv's kernel and bias and make the BatchNorm the
    identity (scale 1, bias 0, mean 0, var 1 - eps), in numpy float32 as the
    reference does. For serving: fine-tuning folded variables re-learns the
    BatchNorm from an identity start."""
    def plain(t):
        if isinstance(t, dict):
            return {k: plain(v) for k, v in t.items()}
        return np.asarray(t)

    params = plain(variables["params"])
    stats = plain(variables.get("batch_stats", {}))

    def walk(p: dict, s: dict):
        for name in list(p):
            if not name.startswith("Conv_"):
                continue
            bn = "BatchNorm_" + name.split("_")[1]
            if bn not in p or bn not in s:
                continue
            conv, bnp, bns = p[name], p[bn], s[bn]
            if "kernel" not in conv or "bias" not in conv or conv["kernel"].ndim < 2:
                continue
            if bns["mean"].shape[-1] != conv["kernel"].shape[-1]:
                continue
            scale = bnp["scale"] / np.sqrt(bns["var"] + _BN_EPS)
            conv["kernel"] = conv["kernel"] * scale
            conv["bias"] = (conv["bias"] - bns["mean"]) * scale + bnp["bias"]
            bnp["scale"] = np.ones_like(bnp["scale"])
            bnp["bias"] = np.zeros_like(bnp["bias"])
            bns["mean"] = np.zeros_like(bns["mean"])
            bns["var"] = np.full_like(bns["var"], 1.0 - _BN_EPS)
        for name, child in p.items():
            if isinstance(child, dict) and isinstance(s.get(name), dict):
                walk(child, s[name])

    walk(params, stats)
    out = dict(variables)
    out["params"] = params
    if stats:
        out["batch_stats"] = stats
    return out


def _percentile(a: torch.Tensor, pct: float) -> torch.Tensor:
    """jnp.percentile(a, pct) of a flat float32 tensor (linear interpolation,
    the position q (n - 1) in float32 as jax takes it), from the top values
    alone: torch.quantile refuses more than 2^24 elements."""
    n = a.numel()
    q = np.float32(np.float32(pct) / np.float32(100.0))
    pos = np.float32(q * (np.float32(n) - np.float32(1.0)))
    lo = min(max(int(np.floor(pos)), 0), n - 1)
    hi = min(max(int(np.ceil(pos)), 0), n - 1)
    hw = np.float32(pos - np.float32(np.floor(pos)))
    top = torch.topk(a, n - lo, sorted=True).values  # a[lo] is the last, a[lo + 1] before it
    v_lo, v_hi = top[-1], top[-1 - (hi - lo)]
    return v_lo * float(np.float32(1.0) - hw) + v_hi * float(hw)


def _quant_stats_like(params: dict, old: dict | None) -> dict:
    """A quant_stats tree with an act_scale for every 3x3 conv of ``params``
    (the existing scale, or 0)."""
    out = {}
    for k, v in params.items():
        if not isinstance(v, dict):
            continue
        if "kernel" in v and np.ndim(v["kernel"]) == 4 and np.shape(v["kernel"])[:2] == (3, 3):
            prev = None if old is None else old.get(k, {}).get("act_scale")
            out[k] = {"act_scale": np.float32(0.0 if prev is None else prev)}
        else:
            sub = _quant_stats_like(v, None if old is None else old.get(k))
            if sub:
                out[k] = sub
    return out


def calibrate_act_scales(model, variables: dict, batches, device=None) -> dict:
    """Post-training activation-scale calibration for int8 serving.

    ``model`` is a trainable twin (``models.trainable``: its serving class
    and keywords come from it) or a (serving class, keywords) pair. The int8
    serving net of ``variables`` runs over ``batches`` (feature arrays or
    tensors, (B, F, T, C)) on ``device`` (CUDA unless it names another).
    Before each 3x3 conv the 99.9th percentile of |x| / 127 + 1e-30 of its
    input is taken; the conv records max(running, that) and runs with that
    batch's percentile scale (as the reference's QConv forward-propagates it,
    so deeper layers calibrate on what they will see). Returns ``variables``
    with the ``quant_stats`` collection that ``convert.from_flax`` reads."""
    from azoom_torch.models.convert import from_flax, load_qconv

    cls, kw = model.serving_spec() if hasattr(model, "serving_spec") else model
    dev = resolve_device(device)
    qs = _quant_stats_like(variables["params"], variables.get("quant_stats"))
    if not qs:
        raise ValueError("no 3x3 conv to calibrate in these variables")
    net = from_flax(cls, {**variables, "quant_stats": qs}, kw, True, dev)

    def hook(conv, args, kwargs):
        x, x2 = args[0], kwargs.get("x2")
        full = x if x2 is None else torch.cat([x, x2], dim=-1)
        pct = float(np.float32(float(_percentile(full.abs().reshape(-1), _CALIB_PCT)))
                    / np.float32(127.0) + np.float32(1e-30))
        conv_params, bn_p, bn_s, node = conv.flax_source
        node["act_scale"] = np.maximum(np.float32(node["act_scale"]), np.float32(pct))
        load_qconv(conv, conv_params, pct, bn_p, bn_s)

    handles = [m.register_forward_pre_hook(hook, with_kwargs=True) for m in net.modules()
               if hasattr(m, "flax_source")]
    try:
        with torch.inference_mode():
            for feats in batches:
                if not torch.is_tensor(feats):
                    feats = torch.from_numpy(np.array(feats, dtype=np.float32))
                net(feats.to(device=dev, dtype=torch.float32).contiguous())
    finally:
        for h in handles:
            h.remove()
    return {**variables, "quant_stats": qs}


def load_quantized(path) -> dict:
    """Load an artifact into a nested dict of numpy arrays, each quantised
    weight dequantised as the float32 product ``q.astype(float32) * scale``,
    exactly as the JAX reader computes it (a float64 step would move the
    weights by an ulp and with them the int8 codes re-derived at load)."""
    tree: dict = {}
    pairs: dict[tuple, dict] = {}
    with np.load(path) as data:
        for key in data.files:
            *node, leaf = key.split("/")
            if leaf in ("__q__", "__scale__"):
                pairs.setdefault(tuple(node), {})[leaf] = data[key]
                continue
            cur = tree
            for p in node:
                cur = cur.setdefault(p, {})
            cur[leaf] = data[key]
    for node, pair in pairs.items():
        cur = tree
        for p in node[:-1]:
            cur = cur.setdefault(p, {})
        cur[node[-1]] = pair["__q__"].astype(np.float32) * pair["__scale__"].astype(np.float32)
    return tree
