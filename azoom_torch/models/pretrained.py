"""Bundled mask-net artifacts (counterpart of azoom.models.pretrained).

The artifacts are read in place from ``azoom/assets/`` by path; the port
imports nothing of the JAX package. Every conv mask net is served, int8
(``quant=True``) or float: the FreqPreservingUNet nets ``fpu``,
``fpu_reverb`` and ``fpu_multigeo`` (base 32, logmag_ipd features),
``deepfpu`` (DeepFPU base 32, physics features) and the TPUFPU nets
``tpufpu``, ``tpufpu_slim`` and ``tpufpu_nano`` (physics features). The
causal CRN ``crn_causal`` (CRNMaskNet base 16, hidden 128, two
unidirectional LSTMs, logmag_ipd features), the streaming net of the
low-latency path, is float only: ``quant`` is ignored for it, as in the
reference.

The reference's named loaders are here too: ``bundled_artifact_path`` and
one ``load_pretrained_<name>`` per artifact. Each returns the served model
(the port's nets hold their weights; the reference returns (model,
variables)), float unless ``quant=True`` as in the reference, on ``device``.
"""

from __future__ import annotations

from pathlib import Path

from azoom_torch.config import resolve_device
from azoom_torch.models.convert import crn_from_flax, from_flax
from azoom_torch.models.quantize import fold_batchnorm, load_quantized
from azoom_torch.models.unet import TPUFPU, DeepFPU, FreqPreservingUNet

__all__ = [
    "bundled_artifact_path", "bundled_train_mic_dist", "load_bundled", "load_pretrained_fpu",
    "load_pretrained_deepfpu", "load_pretrained_tpufpu", "load_pretrained_tpufpu_slim",
    "load_pretrained_tpufpu_nano", "load_pretrained_fpu_reverb", "load_pretrained_fpu_multigeo",
    "load_pretrained_crn_causal", "geo_adapt_dist", "artifact_name", "ASSETS",
]

ASSETS = Path(__file__).resolve().parents[2] / "azoom" / "assets"

# name: (artifact, net, its keywords as the reference builds it, feature kind)
_PORTED = {
    "fpu": ("fpu_b32_int8.npz", FreqPreservingUNet, dict(base=32, in_channels=2), "logmag_ipd"),
    "fpu_reverb": ("fpu_b32_reverb_int8.npz", FreqPreservingUNet, dict(base=32, in_channels=2),
                   "logmag_ipd"),
    "fpu_multigeo": ("fpu_b32_multigeo_int8.npz", FreqPreservingUNet,
                     dict(base=32, in_channels=2), "logmag_ipd"),
    "deepfpu": ("deepfpu_b32_phy_int8.npz", DeepFPU, dict(base=32, in_channels=4), "physics"),
    "tpufpu": ("tpufpu_b64_phy_int8.npz", TPUFPU, dict(base=64, fold=4), "physics"),
    "tpufpu_slim": ("tpufpu_b64s4_phy_int8.npz", TPUFPU, dict(base=64, fold=4, bneck=4),
                    "physics"),
    "tpufpu_nano": ("tpufpu_b64s4d2e2_phy_int8.npz", TPUFPU,
                    dict(base=64, fold=4, bneck=4, dec_div=2, enc_div=2), "physics"),
}

# the causal CRN: (artifact, its keywords as the reference builds it, feature kind)
_CRN_CAUSAL = ("crn_causal_int8.npz", dict(base=16, hidden=128, n_lstm=2, unidirectional=True),
               "logmag_ipd")

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


def artifact_name(name: str) -> tuple[str, str]:
    """(artifact file under ASSETS, feature kind) of a bundled net."""
    if name == "crn_causal":
        return _CRN_CAUSAL[0], _CRN_CAUSAL[2]
    if name not in _PORTED:
        raise KeyError(f"unknown bundled model {name!r}; have {sorted(_TRAIN_MIC_DIST)}")
    return _PORTED[name][0], _PORTED[name][3]


def load_bundled(name: str, quant: bool = True, device=None, fold_bn: bool = False):
    """Returns (model, feature_kind) for a bundled artifact, the model on
    ``device`` in eval mode: the int8 net with ``quant=True``, the float net
    of the same checkpoint otherwise (``crn_causal`` is float only and
    ignores ``quant``). ``device=None`` means CUDA and raises when there is
    no CUDA device; pass ``device="cpu"`` for the plain path. (The reference
    defaults to ``quant=False``; the port keeps ``True``, the serving path it
    had first.) ``fold_bn`` absorbs every Conv -> BatchNorm pair into the
    conv's kernel and bias first (``quantize.fold_batchnorm``; the conv nets
    only, as in the reference)."""
    if name not in _TRAIN_MIC_DIST:
        raise KeyError(f"unknown bundled model {name!r}; have {sorted(_TRAIN_MIC_DIST)}")
    device = resolve_device(device)
    fname = _CRN_CAUSAL[0] if name == "crn_causal" else _PORTED[name][0]
    path = ASSETS / fname
    if not path.exists():
        raise FileNotFoundError(f"bundled artifact missing: {path}")
    if name == "crn_causal":
        _, kwargs, feature_kind = _CRN_CAUSAL
        return crn_from_flax(load_quantized(path), kwargs, device), feature_kind
    _, cls, kwargs, feature_kind = _PORTED[name]
    variables = load_quantized(path)
    if fold_bn:
        variables = fold_batchnorm(variables)
    return from_flax(cls, variables, kwargs, bool(quant), device), feature_kind


def bundled_artifact_path(model: str = "fpu") -> Path | None:
    """The bundled artifact of ``model`` under ASSETS, or None if it is not
    there."""
    path = ASSETS / artifact_name(model)[0]
    return path if path.exists() else None


def load_pretrained_fpu(quant: bool = False, device=None):
    """The bundled FreqPreservingUNet (logmag_ipd features), int8 with
    ``quant=True``; raises FileNotFoundError without its artifact."""
    return load_bundled("fpu", quant, device)[0]


def load_pretrained_fpu_reverb(quant: bool = False, device=None):
    """The reverb-robust FreqPreservingUNet (trained on room scenes)."""
    return load_bundled("fpu_reverb", quant, device)[0]


def load_pretrained_fpu_multigeo(quant: bool = False, device=None):
    """The mic-spacing-robust FreqPreservingUNet (raw, unadapted features)."""
    return load_bundled("fpu_multigeo", quant, device)[0]


def load_pretrained_crn_causal(device=None):
    """The causal CRN of the low-latency path (float only)."""
    return load_bundled("crn_causal", False, device)[0]


def load_pretrained_deepfpu(quant: bool = False, device=None):
    """The bundled DeepFPU (physics features)."""
    return load_bundled("deepfpu", quant, device)[0]


def load_pretrained_tpufpu(quant: bool = False, device=None):
    """The bundled TPUFPU (base 64, fold 4; physics features)."""
    return load_bundled("tpufpu", quant, device)[0]


def load_pretrained_tpufpu_slim(quant: bool = False, device=None):
    """The slim-bottleneck TPUFPU (bneck 4)."""
    return load_bundled("tpufpu_slim", quant, device)[0]


def load_pretrained_tpufpu_nano(quant: bool = False, device=None):
    """The nano TPUFPU (bneck 4, dec_div 2, enc_div 2)."""
    return load_bundled("tpufpu_nano", quant, device)[0]
