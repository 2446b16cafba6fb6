"""The port stands alone: importing every ``repro_torch`` module (and
``chip_smoke.py``, ``scripts/scan_round.py``,
``scripts/mixtral_pod_cards.py`` and every
``examples/torch_*.py``) loads neither JAX nor the JAX package, entry points that default to the card refuse to fall
back to the CPU, and the serve entry point refuses on the card a config
its kernels do not take."""

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
sys.path.insert(0, sys.argv[1] + "/scripts")
import scan_round
import mixtral_pod_cards
import glob, importlib.util
examples = sorted(glob.glob(sys.argv[1] + "/examples/torch_*.py"))
assert len(examples) == 5, examples
for path in examples:
    spec = importlib.util.spec_from_file_location(
        "ex_" + path.rsplit("/", 1)[1][:-3], path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
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


def test_mixtral_pod_cards_refuses_without_two_cards():
    """The two-card script exits non-zero with its reason on a machine
    with fewer than two cards, and runs no smaller case instead."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable,
                          str(ROOT / "scripts" / "mixtral_pod_cards.py")],
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert "needs two cards" in out.stderr and not out.stdout


def test_registry_holds_every_reference_arch():
    """The port registers every architecture of the JAX package's
    registry, under the same ids in the same order; an unknown id raises
    ``KeyError``."""
    from repro.configs import all_arch_ids as jax_arch_ids
    from repro_torch.configs import all_arch_ids, get_config

    assert all_arch_ids() == jax_arch_ids()
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("no-such-arch")
    assert get_config("qwen2-7b").d_model == 3584
    assert get_config("seamless-m4t-large-v2").family == "encdec"
    assert get_config("llama-3.2-vision-11b").family == "vlm"


def test_serve_refuses_head_dims_the_kernels_do_not_take(monkeypatch,
                                                         capsys):
    """On the card the reduced configs (head dim 16; hymba's SSM state 8)
    are served; a config whose head dim the attention kernels are not
    built for (8) or whose state size the scan does not take is refused
    before any weight is drawn, with a message naming what the kernels
    take and the CPU."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch import serve

    for arch in ("qwen2-7b", "hymba-1.5b", "rwkv6-1.6b", "starcoder2-15b",
                 "gemma3-27b", "seamless-m4t-large-v2",
                 "llama-3.2-vision-11b"):
        assert serve.head_dim_refusal(get_config(arch, reduced=True)) is None
        assert serve.head_dim_refusal(get_config(arch)) is None
    assert "head dim 8" in serve.head_dim_refusal(
        get_config("qwen1.5-110b", reduced=True))
    narrow = dataclasses.replace(get_config("qwen2-7b", reduced=True),
                                 head_dim=8)
    assert narrow.dh == 8
    refusal = serve.head_dim_refusal(narrow)
    assert "(16, 32, 64, 128)" in refusal and "--device cpu" in refusal
    for arch in ("seamless-m4t-large-v2", "llama-3.2-vision-11b"):
        narrow_ctx = dataclasses.replace(get_config(arch, reduced=True),
                                         head_dim=8)
        assert "head dim 8" in serve.head_dim_refusal(narrow_ctx)
    small_state = dataclasses.replace(get_config("hymba-1.5b", reduced=True),
                                      ssm_state=4)
    assert "(8, 16)" in serve.head_dim_refusal(small_state)
    drawn = []
    monkeypatch.setattr(serve, "init_model",
                        lambda *a, **k: drawn.append(a))
    monkeypatch.setattr(serve, "get_config", lambda *a, **k: narrow)
    with pytest.raises(SystemExit) as exit_info:
        serve.main(["--reduced"])
    assert exit_info.value.code == 2 and not drawn
    assert "head dims (16, 32, 64, 128)" in capsys.readouterr().err


def test_serve_reduced_on_the_cpu(capsys):
    from repro_torch.launch import serve

    serve.main(["--reduced", "--device", "cpu", "--requests", "2",
                "--max-new-tokens", "2"])
    assert "completed 2/2 requests" in capsys.readouterr().out
