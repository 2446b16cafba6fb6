"""The benchmark's manifest and data files, found by the names in
``BENCHMARK.json``: a cell's configuration (``bench/configs/<config>.json``),
its traffic mix (``bench/traffic/<traffic>.json``), its limits
(``bench/limits/<cell>.json``) and the metrics it reports, each read by
``bench/metrics/<metric>.py``.  Nothing here imports the program."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "bench"


def manifest() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _listed(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell_spec(name: str, man: dict | None = None) -> dict:
    """Everything one cell runs from: the entry of ``workloads``, its
    configuration file, its traffic file, its limits and the end-to-end
    and per-layer metrics it reports."""
    man = man or manifest()
    cells = {w["name"]: w for w in man["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                       f"known: {sorted(cells)}")
    cell = cells[name]
    conf = {c["name"]: c for c in man["configs"]}[cell["config"]]
    return dict(
        cell=cell,
        config=json.loads((ROOT / conf["file"]).read_text()),
        traffic=json.loads(
            (BENCH / "traffic" / f"{cell['traffic']}.json").read_text()),
        limits=json.loads((BENCH / "limits" / f"{name}.json").read_text()),
        end_to_end=[m for m in man["end_to_end"] if _listed(m, name)],
        per_layer=[m for m in man["per_layer"] if _listed(m, name)])


def reader(metric: str):
    """The ``read(record)`` function of ``bench/metrics/<metric>.py`` (a
    metric's name may hold dots, so the file is loaded by its path)."""
    path = BENCH / "metrics" / f"{metric}.py"
    mod_spec = importlib.util.spec_from_file_location(
        f"bench.metrics.{metric}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def model_dims(config: dict) -> dict:
    """The sizes the harness, the counts and the reference need, from a
    configuration file (published ``config.json`` keys)."""
    d, h = config["hidden_size"], config["num_attention_heads"]
    family = config["serve"]["family"]
    window = config["serve"].get("window", config.get("sliding_window"))
    act = config["hidden_act"]
    return dict(
        family=family, n_layers=config["num_hidden_layers"], d_model=d,
        n_heads=h, n_kv_heads=config["num_key_value_heads"], dh=d // h,
        d_ff=config["intermediate_size"], vocab=config["vocab_size"],
        rope_theta=float(config["rope_theta"]),
        norm_eps=float(config.get("rms_norm_eps",
                                  config.get("norm_epsilon", 1e-6))),
        window=window, gated=act == "silu",
        act="silu" if act == "silu" else "gelu_tanh",
        bias=bool(config.get("use_bias", False)),
        n_experts=config.get("num_local_experts", 0),
        top_k=config.get("num_experts_per_tok", 0),
        capacity_factor=config["serve"].get("capacity_factor"))
