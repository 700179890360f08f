"""Every name a reference subpackage exports (``azoom.<pkg>.__all__``) and
the reference's top-level names, ``__version__`` among them, resolve in the
port to the function or class, not to a submodule; the port's own submodule
imports keep working; and no module of the port imports JAX, flax, optax or
azoom. ``azoom.pallas`` (the Pallas kernels) has its counterpart in
``azoom_torch.kernels`` and ``azoom.cli`` exports no names, so neither is
compared."""

import importlib
import os
import subprocess
import sys
import types
from pathlib import Path

import pytest

import azoom

REPO = Path(__file__).resolve().parent.parent
PACKAGES = ["beam", "dsp", "eval", "io", "localize", "masks", "models", "parallel", "pipelines",
            "sim", "stream", "train", "utils", "wpe"]


@pytest.mark.parametrize("pkg", PACKAGES)
def test_subpackage_names_resolve_to_the_port(pkg):
    ref = importlib.import_module(f"azoom.{pkg}")
    port = importlib.import_module(f"azoom_torch.{pkg}")
    missing = [n for n in ref.__all__ if not hasattr(port, n)]
    modules = [n for n in ref.__all__ if isinstance(getattr(port, n, None), types.ModuleType)]
    assert not missing and not modules, (missing, modules)
    assert set(ref.__all__) <= set(port.__all__)
    for name in ref.__all__:
        obj = getattr(importlib.import_module(f"azoom_torch.{pkg}"), name)
        assert obj.__module__.startswith("azoom_torch") if hasattr(obj, "__module__") else True


def test_top_level_names():
    import azoom_torch

    for name in azoom.__all__:
        assert hasattr(azoom_torch, name) and name in azoom_torch.__all__, name
    assert azoom_torch.__version__ == azoom.__version__


def test_submodule_imports_keep_working():
    from azoom_torch.dsp import stft
    from azoom_torch.dsp.stft import stft as stft_fn
    from azoom_torch.localize import tracking
    from azoom_torch.masks import postfilter
    from azoom_torch.models import convert
    from azoom_torch.stream import native

    assert stft is stft_fn and callable(stft)
    assert sys.modules["azoom_torch.dsp.stft"].stft is stft_fn
    for mod in (tracking, postfilter, convert, native):
        assert isinstance(mod, types.ModuleType)
    from azoom_torch.pipelines import oracle_enhance
    from azoom_torch.pipelines.oracle import oracle_enhance as direct
    assert oracle_enhance is direct


_BLOCKER = r"""
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "flax", "optax", "orbax", "azoom"):
    sys.modules[name] = None  # any import of these fails
import azoom_torch
names = [m.name for m in pkgutil.walk_packages(azoom_torch.__path__, "azoom_torch.")]
for name in names:
    importlib.import_module(name)
print(len(names))
"""


def test_no_port_module_imports_jax_or_azoom():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-c", _BLOCKER], env=env, capture_output=True, text=True,
                       timeout=240, cwd=str(REPO))
    assert r.returncode == 0, r.stderr[-3000:]
    assert int(r.stdout.strip().splitlines()[-1]) > 60
