"""Device meshes and shardings (counterpart of azoom.parallel.mesh).

The reference builds a ``jax.sharding.Mesh`` and lets XLA partition its
programs over it. The port's mesh is an ordered tuple of ``torch.device``s
with one axis name; work is split over it by hand:

  * :func:`shard_ranges` is the split rule: contiguous runs of the leading
    axis, one per mesh position, in order;
  * :func:`data_sharding` splits a tensor's leading axis into those
    per-device shards (``NamedSharding(mesh, P(axis))``);
  * :func:`replicated` gives one copy per device of a tensor or an
    ``nn.Module`` (``NamedSharding(mesh, P())``): a net is moved once per
    distinct device, so two shards on one device share one replica;
  * :func:`run_on_devices` runs one job per shard and returns their results
    in shard order, every distinct device's jobs in a thread of their own
    (issued together, joined after), an exception in any job raised.

A device may appear more than once (``["cpu", "cpu"]``, ``["cuda:0",
"cuda:0"]``): that is how a host with one card, or the CPU, holds several
shards. Two shards on one CUDA device share its stream, so they run in turn.

Axes, as in the reference:
  * 'data'  - scenes, batch entries, live streams;
  * 'chunk' - the streaming chunk axis of one long recording.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import threading
from typing import Any, Callable, Sequence

import torch
import torch.distributed as dist

__all__ = ["Mesh", "make_mesh", "shard_ranges", "data_sharding", "replicated", "run_on_devices"]


def _device(d) -> torch.device:
    """A torch.device with its CUDA index filled in, so that it compares
    equal to the device of a tensor on it."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


@dataclasses.dataclass(frozen=True)
class Mesh:
    """An ordered tuple of devices over named axes. ``owners`` gives the
    process rank that holds each device of a mesh spanning processes
    (multihost.global_data_mesh); None means every device is this
    process's."""

    devices: tuple[torch.device, ...]
    axis_names: tuple[str, ...] = ("data",)
    owners: tuple[int, ...] | None = None

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def axis_name(self) -> str:
        return self.axis_names[0]

    def is_local(self, i: int) -> bool:
        """Whether shard i's device belongs to this process."""
        if self.owners is None:
            return True
        rank = dist.get_rank() if dist.is_initialized() else 0
        return self.owners[i] == rank


def make_mesh(n_devices: int | None = None, axis_name: str = "data", devices=None) -> Mesh:
    """1-D mesh over the first ``n_devices`` of ``devices`` (default: every
    CUDA device; raises when there is none). ``devices`` may name one device
    several times."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device; pass devices=['cpu', ...] for a CPU mesh")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [_device(d) for d in devices]
    if n_devices is not None:
        devices = devices[:n_devices]
    if not devices:
        raise ValueError("a mesh needs at least one device")
    return Mesh(tuple(devices), (axis_name,))


def shard_ranges(n: int, mesh: Mesh) -> list[range]:
    """The contiguous runs of [0, n) that the mesh's shards hold in order
    (``n`` must divide over the mesh)."""
    if n % mesh.size:
        raise ValueError(f"{n} rows do not divide over {mesh.size} devices")
    per = n // mesh.size
    return [range(i * per, (i + 1) * per) for i in range(mesh.size)]


def data_sharding(mesh: Mesh, x: torch.Tensor) -> list[torch.Tensor]:
    """Shard the leading axis over the mesh: x (n, ...) -> one (n / size,
    ...) shard per mesh position, each on its device."""
    return [x[r.start:r.stop].to(d) for r, d in zip(shard_ranges(x.shape[0], mesh), mesh.devices)]


def replicated(mesh: Mesh, x) -> dict:
    """One copy of a tensor or module per distinct device of the mesh:
    {device: x on that device}. A module already on a device is that
    device's replica; it is deep-copied once for each other device."""
    out = {}
    for d in dict.fromkeys(mesh.devices):
        if isinstance(x, torch.nn.Module):
            here = next(iter(x.buffers()), None)
            here = next(x.parameters()).device if here is None else here.device
            out[d] = x if _device(here) == d else copy.deepcopy(x).to(d)
        else:
            out[d] = torch.as_tensor(x).to(d)
    return out


def run_on_devices(jobs: Sequence[tuple[torch.device, Callable[[], Any]]]) -> list:
    """Run ``jobs`` [(device, fn), ...] and return their results in order.

    The jobs of each distinct device run in turn in one thread (with that
    device current, for CUDA); the threads start together and are joined
    after, so every device's work is issued before any is waited on. The
    first exception of any job is raised once all threads have ended, so no
    shard is dropped silently.
    """
    results: list = [None] * len(jobs)
    errors: list[BaseException] = []
    by_device: dict[torch.device, list[int]] = {}
    for i, (d, _) in enumerate(jobs):
        by_device.setdefault(_device(d), []).append(i)

    def work(d: torch.device, idx: list[int]) -> None:
        try:
            with torch.cuda.device(d) if d.type == "cuda" else contextlib.nullcontext():
                for i in idx:
                    results[i] = jobs[i][1]()
        except BaseException as e:  # noqa: BLE001 - re-raised in the caller's thread
            errors.append(e)

    if len(by_device) == 1:  # one device: no thread needed
        (d, idx), = by_device.items()
        work(d, idx)
    else:
        threads = [threading.Thread(target=work, args=(d, idx), daemon=True)
                   for d, idx in by_device.items()]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    if errors:
        raise errors[0]
    return results
