"""azoom_torch.utils: host transfer, timing and tracing, FLOP accounting."""

from azoom_torch.utils.flops import compiled_flops, roofline_report
from azoom_torch.utils.host import to_numpy
from azoom_torch.utils.profiling import force, realtime_factor, stage_timer, time_fn, trace

__all__ = [
    "compiled_flops",
    "roofline_report",
    "to_numpy",
    "force",
    "realtime_factor",
    "stage_timer",
    "time_fn",
    "trace",
]
