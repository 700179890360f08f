"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

``launches`` counts, per kernel, the launches its wrapper has made. A
wrapper adds one where it launches its kernel and nowhere else, so a caller
that zeroes the counts with :func:`reset_launches` before a run and reads
them after can show which kernels the run went through. :func:`count`
adds under a lock: the shards of a mesh launch from one thread per device.
"""

from __future__ import annotations

import threading

launches: dict[str, int] = {
    "masked_mvdr": 0, "qconv3x3": 0, "qconv3x3_dynamic": 0, "convt1x2": 0, "hard_null": 0,
    "int8_mm": 0, "online_mvdr": 0, "online_mvdr_mmic": 0,
}


_lock = threading.Lock()


def count(table: dict, name: str) -> None:
    """Add one launch to ``table[name]`` (``launches`` or a kernel's own
    count, such as qconv_kernel.route_counts)."""
    with _lock:
        table[name] += 1


def reset_launches() -> None:
    with _lock:
        for name in launches:
            launches[name] = 0
