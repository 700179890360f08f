"""FLOP accounting and roofline analysis (counterpart of azoom.utils.flops).

:func:`compiled_flops` counts the floating-point operations of one call with
``torch.utils.flop_counter.FlopCounterMode`` (matrix products and
convolutions: 2 per multiply-add; elementwise work is not counted), and
:func:`roofline_report` sets a measured time against the card's peak.
"""

from __future__ import annotations

__all__ = ["compiled_flops", "roofline_report"]

# NVIDIA H100 SXM, dense float32 outside the tensor cores (NVIDIA's data
# sheet, at the 700 W power limit).
H100_FP32_TFLOPS = 67.0


def compiled_flops(fn, *args, **kwargs) -> float:
    """FLOPs of one call of fn(*args, **kwargs) as FlopCounterMode counts
    them (the call runs once)."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    return float(counter.get_total_flops())


def roofline_report(fn, args: tuple, measured_seconds: float,
                    peak_tflops: float = H100_FP32_TFLOPS) -> dict:
    """Achieved against peak for a measured execution time; the keys are the
    reference's (``mxu_utilization`` is the share of ``peak_tflops``)."""
    flops = compiled_flops(fn, *args)
    achieved = flops / measured_seconds / 1e12 if measured_seconds > 0 else 0.0
    return {
        "flops": flops,
        "measured_s": measured_seconds,
        "achieved_tflops": achieved,
        "peak_tflops": peak_tflops,
        "mxu_utilization": achieved / peak_tflops if peak_tflops else 0.0,
    }
