"""Loading the examples (``examples/*.py``, not a package) for the tests
that run each of the port's ``examples/torch_*.py`` beside its JAX
twin."""

import importlib.util
import sys
from pathlib import Path

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def load(name: str):
    """``examples/<name>.py`` as a module of its own."""
    key = f"examples_{name}"
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            key, EXAMPLES / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        sys.modules[key] = mod
    return sys.modules[key]
