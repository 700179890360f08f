"""The ``--ckpt`` loader that ``cli.batch`` and ``cli.run`` share: the
served mask net of ``--model`` from one of three kinds of checkpoint.

  - an int8 ``.npz`` artifact (``models.quantize.save_quantized``'s layout),
    served by ``convert.from_flax`` with its calibrated static scales;
  - a port checkpoint directory (``step_<n>.pt``, ``train.loop.fit``):
    ``train.loop.restore_checkpoint`` into ``create_state`` of the
    ``--model`` twin (``models.trainable``), then ``from_flax`` of the twin's
    ``variables()``;
  - a reference orbax directory (``azoom.train.loop.fit``): its
    ``params`` and ``batch_stats`` read by ``train.orbax``, checked against
    the twin, then the same ``from_flax``.

A training checkpoint carries no ``quant_stats``, so ``quant=True`` serves
it on the reference QConv's dynamic activation scales, as the reference
does. The twins have the reference CLIs' widths (``models.pretrained``'s
``_PORTED``: fpu base 32, deepfpu base 32, the TPUFPU nets base 64, fold 4).
"""

from __future__ import annotations

from pathlib import Path

__all__ = ["NETS", "feature_kind", "twin", "checkpoint_variables", "load_checkpoint"]

NETS = ["fpu", "deepfpu", "tpufpu", "tpufpu_slim", "tpufpu_nano"]


def feature_kind(model: str) -> str:
    """The features ``model``'s bundled net was trained on
    (``models.pretrained._PORTED``): logmag_ipd for the fpu nets, physics
    for the others."""
    from azoom_torch.models.pretrained import _PORTED

    return _PORTED[model][3]


def _channels(feature_kind: str) -> int:
    return 2 if feature_kind == "logmag_ipd" else 4


def twin(model: str, feature_kind: str, n_freqs: int = 513):
    """The trainable twin of ``model`` built for (1, n_freqs, 64, C) input,
    as the reference's ``create_state(model, key, (1, n_freqs, 64, C))``."""
    from azoom_torch.models import trainable
    from azoom_torch.models.pretrained import _PORTED

    serving_cls, kw = _PORTED[model][1:3]
    cls = getattr(trainable, serving_cls.__name__)
    net = cls(**{k: v for k, v in kw.items() if k != "in_channels"})
    return net.build((1, n_freqs, 64, _channels(feature_kind)))


def checkpoint_variables(model: str, ckpt, feature_kind: str, device, n_freqs: int = 513):
    """(variables, step, twin) of a checkpoint directory: a port one
    (``step_<n>.pt``) or a reference orbax one."""
    from azoom_torch.train import orbax

    ckpt = Path(ckpt)
    net = twin(model, feature_kind, n_freqs)
    if any(ckpt.glob("step_*.pt")):
        from azoom_torch.train.loop import create_state, restore_checkpoint

        state = create_state(net, 0, (1, n_freqs, 64, _channels(feature_kind)),
                             device=device)
        state, step = restore_checkpoint(ckpt, state)
        return state.model.variables(), step, net
    if orbax.is_orbax_dir(ckpt):
        variables, step = orbax.read_orbax_variables(ckpt, net.variables())
        return variables, step, net
    raise FileNotFoundError(
        f"--ckpt {ckpt}: neither an .npz artifact, a port checkpoint directory (step_<n>.pt) "
        "nor an orbax checkpoint directory")


def load_checkpoint(model: str, ckpt, feature_kind: str, quant: bool, device,
                    n_freqs: int = 513):
    """(served net on ``device`` in eval mode, step or None for an artifact)."""
    from azoom_torch.models.convert import from_flax
    from azoom_torch.models.pretrained import _PORTED

    ckpt = Path(ckpt)
    if ckpt.suffix == ".npz":
        from azoom_torch.models.quantize import load_quantized

        cls, kw = _PORTED[model][1:3]
        kw = {**kw, "in_channels": _channels(feature_kind)}
        return from_flax(cls, load_quantized(ckpt), kw, quant, device), None
    variables, step, net = checkpoint_variables(model, ckpt, feature_kind, device, n_freqs)
    cls, kw = net.serving_spec()
    return from_flax(cls, variables, kw, quant, device), step
