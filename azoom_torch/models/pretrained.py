"""Bundled mask-net artifacts (counterpart of azoom.models.pretrained).

The artifacts are read in place from ``azoom/assets/`` by path; the port
imports nothing of the JAX package. This slice serves ``tpufpu_nano``, the
int8 TPUFPU (base 64, fold 4, bneck 4, dec_div 2, enc_div 2) that the
learned serving path runs.
"""

from __future__ import annotations

from pathlib import Path

import torch

from azoom_torch.models.convert import tpufpu_from_flax
from azoom_torch.models.quantize import load_quantized

__all__ = ["load_bundled", "bundled_train_mic_dist", "geo_adapt_dist", "ASSETS"]

ASSETS = Path(__file__).resolve().parents[2] / "azoom" / "assets"

_PORTED = {
    "tpufpu_nano": (
        "tpufpu_b64s4d2e2_phy_int8.npz",
        dict(base=64, fold=4, bneck=4, dec_div=2, enc_div=2),
        "physics",
    ),
}

# Mic spacing each artifact's phase features were trained at (geometry
# adaptation rescales the measured IPD by train / actual). None: trained
# across spacings on unscaled features, so its cues must not be rescaled.
_TRAIN_MIC_DIST = {
    "fpu": 0.04,
    "fpu_reverb": 0.04,
    "fpu_multigeo": None,
    "deepfpu": 0.04,
    "tpufpu": 0.04,
    "tpufpu_slim": 0.04,
    "tpufpu_nano": 0.04,
    "crn_causal": 0.04,
}


def bundled_train_mic_dist(model: str) -> float | None:
    """Training spacing for geometry adaptation, or None for artifacts that
    must see raw (unscaled) phase features."""
    return _TRAIN_MIC_DIST[model]


def geo_adapt_dist(model: str, actual_mic_dist: float) -> float | None:
    """The ``train_mic_dist`` to pass to the learned pipeline for this
    (artifact, array) pairing, or None to serve raw features: adaptation
    engages only for arrays smaller than the training spacing."""
    train = _TRAIN_MIC_DIST[model]
    if train is None or actual_mic_dist >= train:
        return None
    return train


def load_bundled(name: str, quant: bool = True, device=None):
    """Returns (model, feature_kind) for a bundled artifact, the model on
    ``device`` in eval mode. ``device=None`` means CUDA and raises when
    there is no CUDA device; pass ``device="cpu"`` for the plain path."""
    if name not in _TRAIN_MIC_DIST:
        raise KeyError(f"unknown bundled model {name!r}; have {sorted(_TRAIN_MIC_DIST)}")
    if name not in _PORTED:
        raise NotImplementedError(
            f"bundled model {name!r} is not ported yet; the other nets are "
            "queued in ROADMAP.md Queue A item 9"
        )
    if not quant:
        raise NotImplementedError("the port serves the int8 path only (quant=True)")
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "load_bundled: no CUDA device; pass device='cpu' to run the "
                "plain PyTorch path on the CPU"
            )
        device = "cuda"
    fname, kwargs, feature_kind = _PORTED[name]
    path = ASSETS / fname
    if not path.exists():
        raise FileNotFoundError(f"bundled artifact missing: {path}")
    return tpufpu_from_flax(load_quantized(path), kwargs, device), feature_kind
