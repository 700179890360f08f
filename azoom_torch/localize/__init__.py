"""azoom_torch.localize: SRP-PHAT, GCC-PHAT and the IPD angle histogram
(``srp``), and the trackers (``tracking``), with the names of azoom.localize."""

from azoom_torch.localize.srp import (
    gcc_phat_localize,
    gcc_phat_map,
    ipd_angle_histogram,
    ipd_histogram_localize,
    srp_localize,
    srp_map,
)
from azoom_torch.localize.tracking import ema_track, viterbi_track

__all__ = [
    "gcc_phat_localize",
    "gcc_phat_map",
    "ipd_angle_histogram",
    "ipd_histogram_localize",
    "srp_localize",
    "srp_map",
    "ema_track",
    "viterbi_track",
]
