"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

``launches`` counts, per kernel, the launches its wrapper has made. A
wrapper adds one where it launches its kernel and nowhere else, so a caller
that zeroes the counts with :func:`reset_launches` before a run and reads
them after can show which kernels the run went through.
"""

from __future__ import annotations

launches: dict[str, int] = {
    "masked_mvdr": 0, "qconv3x3": 0, "convt1x2": 0, "hard_null": 0, "int8_mm": 0,
    "online_mvdr": 0,
}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0
