"""Read a reference training checkpoint (an orbax ``CheckpointManager``
directory of ``azoom.train.loop``) without JAX or orbax: the ``params`` and
``batch_stats`` of a step, as nested dicts of numpy arrays in the flax
tree's layout, which a trainable twin's ``load_variables`` and
``convert.from_flax`` take.

The layout read: each finished step is ``<dir>/<step>/`` holding
``_CHECKPOINT_METADATA`` (a save in progress leaves ``*.orbax-checkpoint-
tmp-*`` directories, skipped); its tree is ``<dir>/<step>/default/_METADATA``,
JSON whose ``tree_metadata`` lists each leaf's keys; each array leaf is a
zarr array in the step's OCDBT store, at the keys joined by dots: the layout
the reference's ``CheckpointManager`` writes with its default
``StandardSave``. A step that declares another layout (``use_zarr3``, or
no ``use_ocdbt``) is refused, naming the key. The arrays are read with ``tensorstore``, imported when a checkpoint is
read (the card's host does not have it). The Adam state and ``step`` leaves
are not read; the step is the directory's name, as the reference's
``restore_checkpoint`` returns it.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

__all__ = ["orbax_steps", "is_orbax_dir", "read_orbax_variables"]

_COLLECTIONS = ("params", "batch_stats")


def orbax_steps(checkpoint_dir) -> list[int]:
    """The finished steps under an orbax directory, ascending."""
    d = Path(checkpoint_dir)
    if not d.is_dir():
        return []
    return sorted(int(p.name) for p in d.iterdir()
                  if p.name.isdigit() and (p / "_CHECKPOINT_METADATA").is_file())


def is_orbax_dir(path) -> bool:
    return bool(orbax_steps(path))


def _leaves(tree: dict, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _tensorstore():
    try:
        import tensorstore
    except ImportError as e:
        raise ImportError(
            "reading an orbax checkpoint directory needs the 'tensorstore' package, which is "
            "not installed; pass a port checkpoint directory (step_<n>.pt) or an int8 .npz "
            "artifact instead") from e
    return tensorstore


def read_orbax_variables(checkpoint_dir, template: dict, step: int | None = None):
    """The ``params`` and ``batch_stats`` of ``step`` (the latest unless
    named) of an orbax directory, checked leaf by leaf against
    ``template`` (a twin's ``variables()``): the same paths and shapes, else
    ValueError naming the leaf. Returns (variables, step)."""
    d = Path(checkpoint_dir).absolute()
    steps = orbax_steps(d)
    if not steps:
        raise FileNotFoundError(f"no finished orbax checkpoint step under {d}")
    step = steps[-1] if step is None else int(step)
    if step not in steps:
        raise FileNotFoundError(f"no step {step} under {d}; have {steps}")
    item = d / str(step) / "default"
    meta = json.loads((item / "_METADATA").read_text())
    for key, default in (("use_ocdbt", True), ("use_zarr3", False)):
        if meta.get(key, default) != default:
            raise ValueError(f"{item / '_METADATA'}: {key} is {meta[key]}; only the layout of "
                             "azoom.train.loop's CheckpointManager (OCDBT, zarr) is read")
    stored = {}
    for entry in meta["tree_metadata"].values():
        keys = tuple(str(k["key"]) for k in entry["key_metadata"])
        if keys[0] in _COLLECTIONS:
            stored[keys] = entry["value_metadata"]
    want = {path: np.shape(leaf) for coll in _COLLECTIONS
            for path, leaf in _leaves(template.get(coll, {}), (coll,))}
    for path in sorted(want.keys() - stored.keys())[:1]:
        raise ValueError(f"{'/'.join(path)}: missing from the checkpoint at step {step}")
    for path in sorted(stored.keys() - want.keys())[:1]:
        raise ValueError(f"{'/'.join(path)}: in the checkpoint at step {step}, not in the net")
    ts = _tensorstore()
    out: dict = {}
    for path in sorted(want):
        shape = tuple(stored[path].get("write_shape", want[path]))
        if shape != want[path]:
            raise ValueError(
                f"{'/'.join(path)}: {shape} in the checkpoint, {want[path]} in the net")
        kvstore = {"driver": "ocdbt", "base": f"file://{item}/", "path": ".".join(path) + "/"}
        arr = ts.open({"driver": "zarr", "kvstore": kvstore}, open=True).result().read().result()
        if tuple(arr.shape) != want[path]:
            raise ValueError(f"{'/'.join(path)}: {tuple(arr.shape)} in the checkpoint, "
                             f"{want[path]} in the net")
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = np.asarray(arr, dtype=np.float32)
    return out, step
