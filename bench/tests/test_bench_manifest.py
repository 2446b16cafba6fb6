"""``BENCHMARK.json`` against the benchmark's contract and its own files:
names and units, what each per-layer metric moves, the files each entry
names, and that nothing under ``bench/`` imports JAX or its package."""

import ast
import json
import re

import pytest

from bench import spec
from conftest import ROOT

MAN = spec.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def metrics():
    return MAN["end_to_end"] + MAN["per_layer"]


def reports(cell, metric):
    return "workloads" not in metric or cell in metric["workloads"]


def test_top_level_keys_and_command():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["paths"] == ["bench"]
    assert MAN["command"] == ["python3", "bench/run.py"]
    assert isinstance(MAN["run_seconds"], int) and \
        1 <= MAN["run_seconds"] <= 51


def test_names_and_units_use_the_allowed_characters():
    names = [m["name"] for m in metrics()] + \
        [w["name"] for w in MAN["workloads"]] + \
        [c["name"] for c in MAN["configs"]] + \
        [w["traffic"] for w in MAN["workloads"]] + \
        [k for c in MAN["configs"] for k in c["reduced"]]
    for n in names:
        assert NAME.match(n), n
    for m in metrics():
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for text in ([w["why"] for w in MAN["workloads"]]
                 + [c["why"] for c in MAN["configs"]]
                 + [c["source"] for c in MAN["configs"]]
                 + [m["layer"] for m in MAN["per_layer"]]):
        assert LINE.match(text), text
    assert len({m["name"] for m in metrics()}) == len(metrics())
    assert len({w["name"] for w in MAN["workloads"]}) == len(MAN["workloads"])


def test_every_cell_reports_setup_an_end_to_end_and_a_per_layer_metric():
    for w in MAN["workloads"]:
        e2e = [m["name"] for m in MAN["end_to_end"] if reports(w["name"], m)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(reports(w["name"], m) for m in MAN["per_layer"])
        assert w["chips"] == 1


@pytest.mark.parametrize("metric", MAN["per_layer"],
                         ids=[m["name"] for m in MAN["per_layer"]])
def test_moves_target_is_reported_where_the_metric_is(metric):
    target = {m["name"]: m for m in MAN["end_to_end"]}[metric["moves"]]
    for w in MAN["workloads"]:
        if reports(w["name"], metric):
            assert reports(w["name"], target), (metric["name"], w["name"])


def test_bounds():
    for m in MAN["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_every_named_file_exists():
    cells = {w["name"] for w in MAN["workloads"]}
    for c in MAN["configs"]:
        path = ROOT / c["file"]
        assert path.is_file() and c["file"].startswith("bench/")
        conf = json.loads(path.read_text())
        assert set(c["reduced"]) == set(conf["reduced_from"])
        assert any(w["config"] == c["name"] for w in MAN["workloads"])
    for w in MAN["workloads"]:
        assert (ROOT / "bench" / "traffic" / f"{w['traffic']}.json").is_file()
        assert (ROOT / "bench" / "limits" / f"{w['name']}.json").is_file()
        assert w["config"] in {c["name"] for c in MAN["configs"]}
    for m in metrics():
        assert (ROOT / "bench" / "metrics" / f"{m['name']}.py").is_file()
        assert set(m.get("workloads", cells)) <= cells


def test_no_width_is_reduced():
    width = re.compile(r"(_size$|_dim$|_rank$|^head|expansion|"
                       r"experts_per_tok|window)")
    for c in MAN["configs"]:
        for k in c["reduced"]:
            assert not width.search(k), k


def imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and \
                not node.level:
            names.add(node.module.split(".")[0])
    return names


def test_nothing_under_bench_imports_jax_or_its_package():
    files = sorted((ROOT / "bench").rglob("*.py"))
    assert len(files) > 10
    for path in files:
        assert not imports(path) & FORBIDDEN, path


def test_nothing_reads_the_jax_benchmarks_folder():
    folder = "bench" + "marks"  # the JAX package's harness
    for path in (ROOT / "bench").rglob("*.py"):
        text = path.read_text()
        assert f"{folder}/" not in text and f"{folder}." not in text, path


@pytest.mark.parametrize("cell", [w["name"] for w in MAN["workloads"]])
def test_each_limit_lies_between_its_readings(cell):
    from bench import check
    lims = {k: v for k, v in spec.cell_spec(cell)["limits"].items()
            if k in check.NUMBERS}
    assert lims
    for k, v in lims.items():
        lo, hi, lim = v["lower"], v["upper"], v["limit"]
        assert hi >= 3 * lo, (k, v)
        assert (lo + hi) / 2 < lim < hi, (k, v)
