"""Reader for the bundled ``.npz`` weight artifacts (counterpart of
azoom.models.quantize.load_quantized), with no JAX.

An artifact holds a flax variables tree flattened to '/'-joined keys.
Large weights are stored as ``<path>/__q__`` int8 codes plus a
``<path>/__scale__`` float32 per-channel scale; everything else is stored
as it is.
"""

from __future__ import annotations

import numpy as np

__all__ = ["load_quantized"]


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
