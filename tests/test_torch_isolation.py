"""The port stands alone: importing every ``repro_torch`` module (and
``chip_smoke.py``) loads neither JAX nor the JAX package, and entry
points that default to the card refuse to fall back to the CPU."""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]

_CHECK = r"""
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
sys.path.insert(0, sys.argv[1])
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "repro" or m.startswith("repro."))
print(len(names), bad)
assert not bad, bad
"""


def test_port_imports_no_jax_and_no_repro():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _CHECK, str(ROOT)],
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    n_modules = int(out.stdout.split()[0])
    assert n_modules >= 15  # every module of the slice was imported


def test_default_device_entry_points_raise_without_card(monkeypatch):
    from repro_torch import resolve_device
    from repro_torch.launch import serve
    from repro_torch.serving import ServingEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.init_model("qwen2-7b", reduced=True, seed=0)
    assert resolve_device("cpu") == torch.device("cpu")


def test_unported_arch_raises_naming_roadmap():
    from repro_torch.configs import get_config

    with pytest.raises(KeyError, match="ROADMAP"):
        get_config("gemma3-27b")
    assert get_config("qwen2-7b").d_model == 3584
