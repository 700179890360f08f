"""Host-side PESQ with a native fallback (counterpart of
azoom.eval.pesq_bridge).

If the ``pesq`` package (the ITU C extension) is installed it scores;
otherwise :mod:`azoom_torch.eval.pesq_native` does, so perceptual quality is
always measurable. ``PESQ_BACKEND`` records which one produced the numbers
("itu" / "native"). Device pipelines never depend on this module.
"""

from __future__ import annotations

import numpy as np

try:  # pragma: no cover - depends on the installation
    from pesq import pesq as _pesq

    PESQ_BACKEND = "itu"
except ImportError:  # pragma: no cover
    from azoom_torch.eval.pesq_native import pesq_native as _pesq

    PESQ_BACKEND = "native"

PESQ_AVAILABLE = True  # always: the native fallback is built in

__all__ = ["PESQ_AVAILABLE", "PESQ_BACKEND", "pesq_scores"]


def pesq_scores(ref: np.ndarray, deg: np.ndarray, fs: int) -> tuple[float | None, float | None]:
    """(narrowband, wideband) MOS-LQO, or None per mode where it does not
    apply: NB at 8 and 16 kHz, WB only at 16 kHz; a scoring error is printed
    and leaves None, as the reference's evaluator does."""
    nb = wb = None
    ref = np.asarray(ref, np.float32)
    deg = np.asarray(deg, np.float32)
    n = min(len(ref), len(deg))
    try:
        if fs in (8_000, 16_000):
            nb = float(_pesq(fs, ref[:n], deg[:n], "nb"))
        if fs == 16_000:
            wb = float(_pesq(fs, ref[:n], deg[:n], "wb"))
    except Exception as e:  # noqa: BLE001 - the reference's guard: report, score None
        print(f"PESQ Error: {e}")
    return nb, wb
