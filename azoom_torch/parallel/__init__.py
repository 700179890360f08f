"""Several devices and processes (counterpart of azoom.parallel): device
meshes (``mesh``), batch evaluation sweeps sharded over them (``sweep``) and
the multi-process entry layer (``multihost``)."""

from azoom_torch.parallel.mesh import data_sharding, make_mesh, replicated
from azoom_torch.parallel.sweep import oracle_sweep, sharded_sweep, sweep_summary

__all__ = [
    "data_sharding",
    "make_mesh",
    "replicated",
    "oracle_sweep",
    "sharded_sweep",
    "sweep_summary",
]
