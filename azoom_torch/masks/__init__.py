"""azoom_torch.masks: oracle, geometric, DUET and learned-feature masks and
the post-filters, with the names of azoom.masks."""

from azoom_torch.masks.geometric import (
    hard_geometric_noise_mask,
    ipd,
    ipd_deviation_noise_mask,
)
from azoom_torch.masks.oracle import (
    ibm_noise_mask,
    ibm_target_mask,
    irm_target_mask,
    wiener_target_mask,
)

__all__ = [
    "hard_geometric_noise_mask",
    "ipd",
    "ipd_deviation_noise_mask",
    "ibm_noise_mask",
    "ibm_target_mask",
    "irm_target_mask",
    "wiener_target_mask",
]
