"""azoom_torch.eval: separation and intelligibility metrics (projection
SINR/SIR, BSS-eval, STOI) on the device; PESQ and the run reports on the
host (eval.pesq_bridge, eval.reports)."""

from azoom_torch.eval.bss import bss_eval_sources
from azoom_torch.eval.projection import osinr_osir, sdr_sir, sir_improvement_db
from azoom_torch.eval.stoi import stoi

__all__ = ["bss_eval_sources", "osinr_osir", "sdr_sir", "sir_improvement_db", "stoi"]
