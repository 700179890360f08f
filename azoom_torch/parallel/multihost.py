"""Several processes (counterpart of azoom.parallel.multihost).

Scenes are embarrassingly parallel, so the processes of a sweep farm share
nothing but the final gather of the metrics:

  * :func:`initialize` joins ``torch.distributed`` at a TCP coordinator
    address (NCCL for processes on CUDA devices, gloo on the CPU); it does
    nothing when unconfigured, so one script runs alone or in a group;
  * :func:`global_data_mesh` is a 1-D mesh over every process's devices,
    each marked with its process; ``sharded_sweep`` over it runs this
    process's shards and all-gathers the per-scene metrics to every rank;
  * :func:`host_shard` gives each process its contiguous slice of a work
    list; :func:`is_primary` is true on rank 0.

A process on CUDA holds one device, ``cuda:(rank % device_count)``. NCCL
refuses two ranks on one GPU, so a group on one card runs on gloo with
``device="cpu"``.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from azoom_torch.config import resolve_device
from azoom_torch.parallel.mesh import Mesh, make_mesh

__all__ = ["initialize", "global_data_mesh", "host_shard", "is_primary"]


def initialize(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, device=None) -> None:
    """Join the process group at ``coordinator_address`` ("host:port") as
    rank ``process_id`` of ``num_processes``, on CUDA (NCCL) unless
    ``device="cpu"`` (gloo). No-op when neither the address nor the count is
    given (a single process)."""
    if coordinator_address is None and num_processes is None:
        return
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", int(process_id or 0) % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=f"tcp://{coordinator_address}",
                            world_size=int(num_processes), rank=int(process_id or 0))


def global_data_mesh(axis_name: str = "data") -> Mesh:
    """A 1-D mesh over every device of every process, in rank order (every
    CUDA device of this process when it is alone)."""
    if not dist.is_initialized():
        return make_mesh(axis_name=axis_name)
    # A rank holds the device initialize() made current (NCCL), or the CPU.
    here = (torch.device("cuda", torch.cuda.current_device())
            if dist.get_backend() == "nccl" else torch.device("cpu"))
    every: list = [None] * dist.get_world_size()
    dist.all_gather_object(every, [str(here)])
    devices = tuple(torch.device(d) for ds in every for d in ds)
    owners = tuple(r for r, ds in enumerate(every) for _ in ds)
    return Mesh(devices, (axis_name,), owners)


def _rank_and_size() -> tuple[int, int]:
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def host_shard(n_items: int) -> range:
    """This process's contiguous slice of [0, n_items)."""
    p, n = _rank_and_size()
    per = -(-n_items // n)
    return range(p * per, min((p + 1) * per, n_items))


def is_primary() -> bool:
    return _rank_and_size()[0] == 0
