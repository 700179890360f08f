"""Performance instrumentation (counterpart of azoom.utils.profiling):
real-time factor, per-stage timing and profiler traces.

CUDA launches return before the device has finished, so every timer here
waits for the card (``torch.cuda.synchronize``) before it reads the clock,
and :func:`force` reduces a result to a host scalar. Host-clock times
include the host's share of each call; a kernel's own time comes from CUDA
events (``azoom_torch.kernels.bench``).
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from typing import Callable

import torch

__all__ = ["force", "time_fn", "realtime_factor", "stage_timer", "trace"]


def _leaves(x):
    if isinstance(x, dict):
        for v in x.values():
            yield from _leaves(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _leaves(v)
    else:
        yield x


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def force(x) -> float:
    """Wait for a computation and reduce every tensor in ``x`` (nested
    lists, tuples and dicts) to one host scalar: the sum of absolute values
    (real and imaginary parts apart for complex tensors)."""
    _sync()
    total = 0.0
    for leaf in _leaves(x):
        leaf = torch.as_tensor(leaf)
        if leaf.is_complex():
            total += float(leaf.real.abs().sum()) + float(leaf.imag.abs().sum())
        else:
            total += float(leaf.to(torch.float32).abs().sum())
    return total


def time_fn(fn: Callable, *args, iters: int = 5, warmup: int = 1, **kwargs):
    """Host-clock seconds per call of ``fn(*args, **kwargs)`` over ``iters``
    calls after ``warmup``, the device waited for at both ends. Returns
    (seconds_per_call, last_result)."""
    out = None
    for _ in range(warmup):
        out = fn(*args, **kwargs)
    force(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args, **kwargs)
    force(out)
    return (time.perf_counter() - t0) / iters, out


def realtime_factor(process_fn: Callable, audio, fs: int, iters: int = 5) -> float:
    """Seconds of audio processed per wall-clock second (> 1: faster than
    real time)."""
    dt, _ = time_fn(process_fn, audio, iters=iters)
    return (audio.shape[-1] / fs) / dt


class stage_timer:
    """Per-stage wall-clock accumulator, as a context manager per stage; the
    device is waited for at each stage's end."""

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str, result_ref: list | None = None):
        t0 = time.perf_counter()
        yield
        if result_ref:
            force(result_ref[0])
        else:
            _sync()
        dt = time.perf_counter() - t0
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        lines = ["=== stage timing ==="]
        for name, total in self.totals.items():
            n = self.counts[name]
            lines.append(f"  {name}: {total * 1e3:.1f} ms total, "
                         f"{total / n * 1e3:.2f} ms/call (n={n})")
        return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: str | os.PathLike | None = None):
    """``torch.profiler`` trace of the block (the host, and the card when
    there is one), written as a Chrome/Perfetto trace to
    ``log_dir/trace.json`` (default: ``azoom_torch_trace`` in the temporary
    directory). Yields ``log_dir``."""
    from torch.profiler import ProfilerActivity, profile

    log_dir = os.fspath(log_dir or os.path.join(tempfile.gettempdir(), "azoom_torch_trace"))
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield log_dir
        _sync()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
