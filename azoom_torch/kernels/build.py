"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``azoom_torch/csrc/<name>.cu`` is compiled on first use into its own
shared library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o azoom_torch/_build/<name>-<hash>.so <name>.cu

The file name carries a hash of the source, of every ``csrc/*.cuh`` header it
includes (directly or through another header) and of the flags, so an edited
source or header is rebuilt and an unchanged one is loaded as it is. The int8
kernels (``wgmma``, ``setmaxnreg``) exist only for ``sm_90a``, not plain
``sm_90``. Their TMA tensor maps need libcuda's ``cuTensorMapEncodeTiled``;
``csrc/wgmma_s8.cuh`` looks it up through the runtime
(``cudaGetDriverEntryPoint``), so no library is linked with ``-lcuda``. ``--use_fast_math``
is never passed: the int8 conv's activation quantisation needs IEEE
division and round-half-to-even to give the same codes as the reference.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["KERNEL_SOURCES", "build_all", "check", "load_library"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
KERNEL_SOURCES = (
    "mvdr_kernel", "qconv_kernel", "qconv_mma_kernel", "convt_kernel", "nullsteer_kernel",
    "int8_mm_kernel", "online_mvdr_kernel", "online_mvdr_mmic_kernel",
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: dict[tuple[str, tuple[str, ...]], ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _sources(name: str) -> list[Path]:
    """``<name>.cu`` and the local headers it includes, transitively, in a
    fixed order."""
    found, todo = [], [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop()
        if path in found:
            continue
        found.append(path)
        todo += sorted(CSRC / inc.decode() for inc in _INCLUDE.findall(path.read_bytes()))
    return found


def _target(name: str, defines: tuple[str, ...] = ()) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + tuple(f"-D{d}" for d in defines)).encode())
    for path in _sources(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str, defines: tuple[str, ...] = ()) -> tuple[subprocess.Popen, Path, Path] | None:
    """Start nvcc for one source, or return None when it is built already."""
    target = _target(name, defines)
    if target.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, *(f"-D{d}" for d in defines), "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, target


def _finish(name: str, job) -> str:
    proc, tmp, target = job
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu (rc {proc.returncode}):\n{out}")
    os.replace(tmp, target)
    (target.with_suffix(".log")).write_text(out)
    return out


def build_all(names=KERNEL_SOURCES) -> dict[str, dict]:
    """Compile every kernel source at once (one nvcc each, started together)
    and load them. Returns {name: {"seconds": wall time until that build
    finished, "log": nvcc/ptxas output}}."""
    t0 = time.perf_counter()
    jobs = {n: _start(n) for n in names}
    info = {}
    for n, job in jobs.items():
        log = _finish(n, job) if job is not None else "(already built)"
        info[n] = {"seconds": time.perf_counter() - t0, "log": log}
        load_library(n)
    return info


def load_library(name: str, defines: tuple[str, ...] = ()) -> ctypes.CDLL:
    """The loaded library for kernel source ``name``, built if missing.
    ``defines`` are preprocessor macros of a diagnostic variant (the
    conv's ``AZT_QCONV_CLOCKS``), built and cached beside the plain one."""
    lib = _LIBS.get((name, defines))
    if lib is None:
        target = _target(name, defines)
        if not target.exists():
            job = _start(name, defines)
            if job is not None:
                _finish(name, job)
        lib = ctypes.CDLL(str(target))
        _LIBS[(name, defines)] = lib
    return lib


def check(rc: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
