"""The port's dry run (``repro_torch.launch.dryrun``) on the meta device.

* **Skips:** every cell of every registered config (reduced) is ``ok`` or
  ``skipped``; the long-context cells skipped are JAX's
  ``LONG_CTX_SKIPS``, read from ``src/repro/launch/dryrun.py`` with
  ``ast`` (importing that module sets ``XLA_FLAGS`` for the whole
  process), and the pods skipped are the context families' beyond one
  member, with the engine's refusal.
* **Bytes:** the param bytes a device holds under each layout equal the
  port's sharding rules as the serving code places them (``shard_put``
  on meta) and, for the training layouts of up to four devices, JAX's
  ``resolve_pspec`` under a mesh of the forced host devices.
* **FLOPs:** the FLOPs a trace counts on meta (the kernels left out)
  equal ``FlopCounterMode``'s count of the same step on CPU tensors with
  the kernels' plain versions hidden from it; the kernels' reckoned FLOPs
  of a dense causal prefill equal ``model_flops``' attention term.
* **Full-width pods** (bytes only, no trace): no column-only pod of
  qwen1.5-110b fits a card's 80 GB, mixtral-8x7b fits at 2 members, and
  rwkv6-1.6b's and hymba-1.5b's members hold the bytes the smoke's
  ``POD_MEMBER_BYTES`` holds.
"""

import ast
import dataclasses
import functools
import json
import math
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from torch.utils._python_dispatch import _disable_current_modes
from torch.utils.flop_counter import FlopCounterMode

from repro.distributed import sharding as jshard
from repro.models import layers  # noqa: F401 - adds the "tp" rule
from repro_torch.analysis.roofline import kernel_call_cost, model_flops
from repro_torch.configs import all_arch_ids, get_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import ssm_scan as ss
from repro_torch.kernels import wkv6 as wk
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import HBM_BYTES, MESH_LAYOUTS, POD_LAYOUTS
from repro_torch.models import SHAPE_CASES, ShapeCase, build_model
from repro_torch.models import input_specs

ROOT = Path(__file__).resolve().parents[1]
ARCHS = all_arch_ids()
CONTEXT = {"seamless-m4t-large-v2", "llama-3.2-vision-11b"}

torch.set_num_threads(2)


def jax_long_ctx_skips() -> set:
    tree = ast.parse((ROOT / "src/repro/launch/dryrun.py").read_text())
    for node in tree.body:
        if (isinstance(node, ast.Assign)
                and any(getattr(t, "id", "") == "LONG_CTX_SKIPS"
                        for t in node.targets)):
            return set(ast.literal_eval(node.value))
    raise AssertionError("LONG_CTX_SKIPS not found")


@functools.lru_cache(maxsize=None)
def reduced_cells(arch: str) -> tuple:
    return tuple(r for case in SHAPE_CASES
                 for r in dryrun.run_cells(arch, case, reduced=True))


def test_long_context_skips_are_jax_s():
    assert dryrun.LONG_CTX_SKIPS == jax_long_ctx_skips()


@pytest.mark.parametrize("arch", ARCHS)
def test_every_cell_ok_or_skipped_as_jax_skips(arch):
    skips = jax_long_ctx_skips()
    cells = reduced_cells(arch)
    want = {(c, m) for c, case in SHAPE_CASES.items()
            for m in dryrun.layouts_for(case)}
    assert {(r.case, r.mesh) for r in cells} == want
    for r in cells:
        pod = r.mesh.startswith("pod") and r.mesh != "pod1"
        if r.case == "long_500k" and arch in skips:
            assert r.status == "skipped" and "full-attention" in r.error
        elif pod and arch in CONTEXT:
            assert r.status == "skipped" and "context" in r.error
        else:
            assert r.status == "ok", (r.case, r.mesh, r.error)
            assert r.flops_per_device > 0 and r.hlo_flops_per_device > 0
            assert r.memory["params"] > 0 and r.compute_s > 0
            assert r.temporaries == "not reckoned on meta"
            json.dumps(r.to_json())
    # one trace per (arch, case): every layout of a case shares its seconds
    for case in SHAPE_CASES:
        ok = [r for r in cells if r.case == case and r.status == "ok"]
        assert len({r.kernel_calls == ok[0].kernel_calls for r in ok}) <= 1


def _mesh(sizes):
    devs = np.asarray(jax.devices()[: math.prod(sizes.values())])
    return Mesh(devs.reshape(tuple(sizes.values())), tuple(sizes))


def _jax_param_bytes(model, sizes) -> int:
    mesh = _mesh(sizes)
    total = 0
    for path, spec in dryrun._walk(model.specs):
        names = dryrun._at(model.param_names(), path)
        pspec = jshard.resolve_pspec(names, spec.shape, mesh)
        n = 1
        for d, entry in zip(spec.shape, tuple(pspec)):
            axes = () if entry is None else (
                entry if isinstance(entry, tuple) else (entry,))
            n *= d // math.prod(sizes[a] for a in axes)
        total += n * spec.dtype.itemsize
    return total


@pytest.mark.skipif(len(jax.devices()) < 4,
                    reason="needs 4 (forced host) devices")
@pytest.mark.parametrize("arch", ARCHS)
def test_param_bytes_follow_the_sharding_rules(arch):
    cfg = get_config(arch, reduced=True)
    model = build_model(cfg)
    case = SHAPE_CASES["decode_32k"]
    for name, sizes in MESH_LAYOUTS.items():
        got = dryrun.held_bytes(model, case, sizes)["params"]
        if math.prod(sizes.values()) <= 4:
            assert got == _jax_param_bytes(model, sizes), name
    for name, sizes in POD_LAYOUTS.items():
        n = sizes["serve"]
        weights, _ = dryrun.serve_member_bytes(cfg, n, 2, 32)
        assert dryrun.held_bytes(model, case, sizes)["params"] == weights


def _hidden(fn):
    """``fn`` run with every dispatch mode off: the kernels' plain
    versions, which the meta trace replaces by recorded calls."""
    @functools.wraps(fn)
    def run(*args, **kwargs):
        with _disable_current_modes():
            return fn(*args, **kwargs)
    return run


def _cpu_inputs(model, case):
    specs, _ = input_specs(model, case)

    def real(t):
        if isinstance(t, dict):
            return {k: real(v) for k, v in t.items()}
        return torch.zeros(t.shape, dtype=t.dtype)
    return real(specs)


SMALL = {kind: ShapeCase(f"small_{kind}", kind, 16, 2)
         for kind in ("train", "prefill", "decode")}


@pytest.mark.parametrize("arch", ARCHS)
def test_meta_flops_equal_flop_counter_on_cpu(arch, monkeypatch):
    for mod, name in ((fa, "flash_attention"), (wk, "wkv6_scan"),
                      (ss, "ssm_scan"), (ops, "decode_attention"),
                      (ops, "paged_decode_attention"),
                      (ops, "decode_attention_quant"),
                      (ops, "paged_decode_attention_quant"),
                      (fa, "recompute_grads"), (wk, "recompute_grads"),
                      (ss, "recompute_grads")):
        monkeypatch.setattr(mod, name, _hidden(getattr(mod, name)))
    model = build_model(get_config(arch, reduced=True))
    gen = torch.Generator().manual_seed(0)
    kinds = ("train", "prefill", "decode") if arch in (
        "qwen2-7b", "rwkv6-1.6b", "hymba-1.5b", "qwen2-moe-a2.7b") else (
        "prefill", "decode")
    for kind in kinds:
        case = SMALL[kind]
        tally = dryrun.trace(model, case)
        params = model.init(gen)
        run = dryrun.step_thunk(model, case, params, _cpu_inputs(model, case))
        with FlopCounterMode(display=False) as counter:
            run()
        assert tally.flops == counter.get_total_flops() > 0, kind
        # mixtral decodes every layer from a rolled cache, in plain torch
        assert bool(tally.calls) != (kind == "decode"
                                     and arch == "mixtral-8x7b"), kind


def test_kernel_flops_equal_model_flops_attention_term():
    cfg = get_config("qwen2-7b", reduced=True)
    case = SHAPE_CASES["prefill_32k"]
    tally = dryrun.trace(build_model(cfg), case)
    assert {c.name for c in tally.calls} == {"flash_attention"}
    kernel = sum(kernel_call_cost(c)[0] for c in tally.calls)
    b, s = case.global_batch, case.seq_len
    n_matmul = cfg.active_param_count() - cfg.padded_vocab * cfg.d_model
    attention = model_flops(cfg, case) - 2.0 * n_matmul * b * s
    assert kernel == attention == cfg.n_layers * 2.0 * b * s * s * cfg.q_dim


def test_full_width_pods_fit_as_reckoned():
    rows = {r["arch"]: r for r in dryrun.fit_table(
        ["qwen1.5-110b", "mixtral-8x7b", "qwen2-7b", "llama-3.2-vision-11b"])}
    assert rows["qwen1.5-110b"]["fewest"] is None
    assert all(sum(b) > HBM_BYTES
               for b in rows["qwen1.5-110b"]["members"].values())
    assert rows["mixtral-8x7b"]["fewest"] == 2
    assert rows["qwen2-7b"]["fewest"] == 1
    vision = rows["llama-3.2-vision-11b"]
    assert vision["refused_as_pod"] and list(vision["members"]) == [1]
    # the rwkv and hybrid pods' members, as JAX's ``per_device_bytes`` counts
    # them (``chip_smoke.py``'s ``POD_MEMBER_BYTES``)
    want = {"rwkv6-1.6b": {2: (2_144_477_184, 51_904_544),
                           4: (1_632_772_096, 26_738_720)},
            "hymba-1.5b": {2: (1_839_646_400, 361_758_752),
                           4: (1_408_132_800, 361_758_752)}}
    for arch, by_n in want.items():
        for n, sizes in by_n.items():
            assert dryrun.serve_member_bytes(get_config(arch), n) == sizes


def test_cli_writes_a_line_a_cell_and_the_fit_table(tmp_path, capsys):
    assert dryrun.main(["--arch", "rwkv6-1.6b", "--case", "decode_32k",
                        "--out", str(tmp_path)]) == 0
    lines = [json.loads(x) for x in
             (tmp_path / "dryrun.jsonl").read_text().splitlines()]
    assert [r["mesh"] for r in lines] == list(
        dryrun.layouts_for(SHAPE_CASES["decode_32k"]))
    assert all(r["status"] == "ok" and r["fits"] for r in lines)
    assert {r["kernel_calls"]["wkv6_step"] for r in lines} == {24}
    out = capsys.readouterr().out
    assert "fewest that fit 80 GB" in out and "rwkv6-1.6b" in out
    pod2 = next(r for r in lines if r["mesh"] == "pod2")
    assert pod2["collectives"]["all-gather"] > 0
    assert pod2["memory"]["params"] < lines[0]["memory"]["params"]
    assert dataclasses.fields(dryrun.CellResult)[0].name == "arch"


def test_wrappers_on_meta_compute_nothing_and_record_their_calls():
    """Each of the seven wrappers, given meta tensors, returns empty
    outputs of the kernel's shapes and dtypes, launches nothing (no
    counter moves) and records the call with its shapes."""
    from repro_torch import kernels
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import meta

    def m(*shape, dtype=torch.bfloat16):
        return torch.empty(shape, dtype=dtype, device="meta")

    b, s, h, kv, d = 2, 48, 8, 2, 64
    q1, lens = m(b, 1, h, d), m(b, dtype=torch.int32)
    cache, codes = m(b, s, kv, d), m(b, s, kv, d, dtype=torch.int8)
    scales = m(b, s, kv, 1)
    pages, tables = m(7, 16, kv, d), m(b, 3, dtype=torch.int32)
    qpages, spages = m(7, 16, kv, d, dtype=torch.int8), m(7, 16, kv, 1)
    x = m(1, 20, 4, 64)
    before = kernels.counter_values()
    with meta.recording() as calls:
        outs = [
            fa.flash_attention(m(b, s, h, d), cache, cache),
            da.decode_attention(q1, cache, cache, lens),
            da.paged_decode_attention(q1, pages, pages, tables, lens),
            da.decode_attention_quant(q1, codes, codes, scales, scales, lens),
            da.paged_decode_attention_quant(q1, qpages, qpages, spages,
                                            spages, tables, lens),
            *wk.wkv6_scan(x, x, x, x, m(4, 64), m(1, 4, 64, 64,
                                                  dtype=torch.float32)),
            *ss.ssm_scan(x, m(1, 20, 4), m(4, 16), m(1, 20, 4, 16),
                         m(1, 20, 4, 16), m(1, 4, 64, 16,
                                           dtype=torch.float32)),
        ]
    assert kernels.counter_values() == before
    assert all(t.is_meta for t in outs)
    assert [tuple(t.shape) for t in outs[:5]] == \
        [(b, s, h, d)] + [(b, 1, h, d)] * 4
    assert [c.name for c in calls] == [
        "flash_attention", "decode_attention", "paged_decode_attention",
        "decode_attention_quant", "paged_decode_attention_quant",
        "wkv6_chunked", "ssm_chunked"]
    assert calls[2].option("rows") == 3 * 16
    assert calls[0].reads[0] == ((b, s, h, d), 2)
    assert outs[6].dtype == torch.float32 and outs[8].dtype == torch.float32
