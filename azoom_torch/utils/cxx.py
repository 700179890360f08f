"""Build the reference's host engines (``cpp/*.cpp``, unchanged) into the
port's own build directory.

One source is compiled with ``$CXX`` (else ``g++``) and ``cpp/Makefile``'s
flags plus the library's own into ``azoom_torch/_build/lib<name>-<hash>.so``.
The hash covers the compiler, the flags, the source and what
``-march=native`` expands to on this host, so a checkout shared by two kinds
of CPU keeps one library for each. The compiler writes a temporary file that
is renamed into place, so processes building at once never load a
half-written library. The port never runs ``make -C cpp``: that writes
``cpp/build/``, which the JAX package builds and loads.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

__all__ = ["CPP_DIR", "BUILD_DIR", "MAKEFILE_FLAGS", "compiler", "library_path", "build",
           "load", "accepted"]

CPP_DIR = Path(__file__).resolve().parents[2] / "cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
MAKEFILE_FLAGS = ("-O3", "-march=native", "-fPIC", "-Wall", "-Wextra")


def compiler() -> str:
    return os.environ.get("CXX", "g++")


def _native_arch() -> bytes:
    """What ``-march=native`` means on this host: the compiler's own command
    line for an empty C++ input (the target CPU and its feature flags)."""
    out = subprocess.run([compiler(), "-march=native", "-x", "c++", "-E", "-v", "-"],
                         input=b"", capture_output=True, timeout=60)
    return b"\n".join(line for line in out.stderr.splitlines() if b"cc1" in line)


def library_path(name: str, source: Path, flags: tuple, build_dir: Path) -> Path:
    """The library ``lib<name>-<hash>.so`` this host builds from ``source``."""
    h = hashlib.sha256(" ".join((compiler(),) + tuple(flags)).encode() + b"\0" + _native_arch())
    h.update(source.read_bytes())
    return build_dir / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(target: Path, source: Path, flags: tuple, what: str) -> None:
    """Compile ``source`` into ``target``; raise with the compiler's exit
    code and output when it fails (``what`` names the library)."""
    target.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=target.stem + ".", suffix=".tmp", dir=target.parent)
    os.close(fd)
    try:
        proc = subprocess.run([compiler(), *flags, str(source), "-o", tmp],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"building {what} failed (rc {proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, target)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load(name: str, source: Path, flags: tuple, build_dir: Path, what: str) -> ctypes.CDLL:
    """Build the library unless this host's is already there, and load it."""
    target = library_path(name, source, flags, build_dir)
    if not target.exists():
        build(target, source, flags, what)
    return ctypes.CDLL(str(target))


@functools.lru_cache(maxsize=None)
def _accepts(cxx: str, flag: str, build_dir: Path) -> bool:
    build_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".probe.so", dir=build_dir)
    os.close(fd)
    try:
        proc = subprocess.run([cxx, flag, "-shared", "-fPIC", "-x", "c++", "-", "-o", tmp],
                              input=b"", capture_output=True, timeout=60)
        return proc.returncode == 0
    finally:
        os.unlink(tmp)


def accepted(flags: tuple, optional: tuple, build_dir: Path) -> tuple:
    """``flags`` without those of ``optional`` that this compiler refuses
    (an empty shared object built with the flag fails: e.g. ``-fopenmp``
    where the toolchain has no OpenMP runtime)."""
    return tuple(f for f in flags if f not in optional or _accepts(compiler(), f, build_dir))
