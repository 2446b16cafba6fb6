"""Shared fixtures of the benchmark's tests: the repository's ``src`` on
the path, a tiny model and traffic on the CPU, and the card check for
tests marked ``gpu``."""

import sys
from pathlib import Path

import pytest
import torch

# Test workers share the CPU: a few threads each keeps a tiny run's window
# from stalling on oversubscribed cores.
torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def tiny_config(family: str, layers: int = 2) -> dict:
    """A configuration file's keys at a size the CPU runs in seconds."""
    base = {"source": "test", "hidden_size": 64, "intermediate_size": 128,
            "num_attention_heads": 4, "num_key_value_heads": 2,
            "num_hidden_layers": layers, "vocab_size": 256,
            "rope_theta": 10000.0, "rms_norm_eps": 1e-5}
    if family in ("moe", "moe_full"):  # moe_full: no window, bucketed
        base.update(model_type="mixtral", hidden_act="silu",
                    num_local_experts=4, num_experts_per_tok=2,
                    sliding_window=16 if family == "moe" else None,
                    serve={"family": "moe", "dtype": "bfloat16",
                           "capacity_factor": 2.0})
    else:
        base.update(model_type="starcoder2", hidden_act="gelu_pytorch_tanh",
                    use_bias=True,
                    serve={"family": "dense", "dtype": "bfloat16",
                           "window": None})
    return base


def tiny_traffic(loop: str) -> dict:
    return {"loop": loop, "arrivals": "poisson", "rate_per_s": 20.0,
            "clients": 6, "pool": 200, "order_block": 6, "size_seed": 5,
            "prompt": {"dist": "lognormal", "median": 12, "sigma": 0.5,
                       "min": 4, "max": 40},
            "output": {"dist": "uniform", "min": 4, "max": 12},
            "functions": [{"instances": 2, "max_batch": 4, "max_len": 64,
                           "alloc": {"sm": 0.5, "quota_request": 0.5,
                                     "quota_limit": 1.0}}],
            "check": {"served_tokens": 64, "ref_tokens": 2000}}


def tiny_cell(family: str, loop: str, limits: dict) -> dict:
    from bench import spec
    man = spec.manifest()
    return {"cell": {"name": f"tiny-{family}.{loop}", "config": "tiny",
                     "traffic": loop, "chips": 1},
            "config": tiny_config(family), "traffic": tiny_traffic(loop),
            "limits": {k: {"limit": v} for k, v in limits.items()},
            "end_to_end": man["end_to_end"], "per_layer": man["per_layer"]}
