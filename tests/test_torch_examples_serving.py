"""``examples/torch_quickstart.py`` and
``examples/torch_multi_tenant_isolation.py`` on the CPU beside their JAX
twins.

* quickstart: the request counts and the weight and store bytes printed
  equal the twin's; the first completion's tokens equal the twin's flow
  in f32 from bridged weights (bf16 greedy streams are not portable
  between the packages);
* isolation: every request of both functions completes in all three
  runs, and each run deploys the twin's allocations; the victim's rate
  is read while the aggressor runs, and is the twin's reading where the
  aggressor outlasts the victim.  The wall-clock
  ratio the example asserts is held on the card only (the smoke's
  examples phase): a loaded CPU under the test runner moves it.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from examples_twins import load
from repro.configs import get_config as jax_config
from repro.core.resources import Alloc as JAlloc
from repro.models import build_model as jax_build
from repro.serving.engine import ServingEngine as JEngine
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core.slo import SLORecorder
from repro_torch.models import build_model

torch.set_num_threads(2)


def _lines(text: str, prefix: str) -> list[str]:
    return [x for x in text.splitlines() if x.startswith(prefix)]


def test_quickstart_prints_the_twin_s_counts_and_bytes(capsys):
    load("quickstart").main()
    jax_out = capsys.readouterr().out
    out = load("torch_quickstart").main(["--device", "cpu"])
    torch_out = capsys.readouterr().out
    assert out["done"] == len(out["reqs"]) == 8
    assert _lines(torch_out, "deployed") == _lines(jax_out, "deployed")
    served = [x.split(":")[0] for x in _lines(jax_out, "served")]
    assert [x.split(":")[0] for x in _lines(torch_out, "served")] == served
    assert all(len(r.tokens_out) == 6 for r in out["reqs"])


def test_quickstart_first_completion_equals_the_twin_s_in_f32():
    cfg = jax_config("qwen2-7b", reduced=True)
    jm = jax_build(cfg)
    jp = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32),
                                jm.init(jax.random.PRNGKey(0)))
    # The twin's flow (examples/quickstart.py:31-46) on f32 weights.
    engine = JEngine(window=0.25)
    engine.deploy("qwen2", jm, jp, JAlloc(sm=0.24, quota_request=0.5,
                                          quota_limit=1.0),
                  n_instances=2, max_batch=4, max_len=24)
    rng = np.random.default_rng(1)
    jreqs = [engine.submit("qwen2", rng.integers(0, cfg.vocab_size, 12)
                           .astype(np.int32), max_new_tokens=6)
             for _ in range(8)]
    assert engine.pump(budget_s=60.0) == 8
    tm = build_model(get_config("qwen2-7b", reduced=True))
    out = load("torch_quickstart").run(
        tm, bridge.to_torch(jax.device_get(jp)), torch.device("cpu"))
    assert out["done"] == 8
    assert [r.tokens_out for r in out["reqs"]] == \
        [list(r.tokens_out) for r in jreqs]


def _alloc(a) -> tuple:
    return (a.sm, a.quota_request, a.quota_limit)


def test_isolation_completes_every_request_with_the_twin_s_allocations(
        monkeypatch):
    twin = load("multi_tenant_isolation")
    seen = []

    class Recording(JEngine):
        def deploy(self, fn, model, params, alloc, **kw):
            seen.append((fn, _alloc(alloc), kw["max_batch"], kw["max_len"]))
            return super().deploy(fn, model, params, alloc, **kw)

    monkeypatch.setattr(twin, "ServingEngine", Recording)
    runs = (("alone", False, True), ("contended", True, False),
            ("isolated", True, True))
    for _, aggressor, isolated in runs:
        twin.serve_victim(aggressor=aggressor, isolated=isolated)
    ex = load("torch_multi_tenant_isolation")
    mine = []
    fns = ex.models(torch.device("cpu"))
    for name, aggressor, isolated in runs:
        got = ex.serve_victim(aggressor, isolated, fns, torch.device("cpu"))
        engine = got["engine"]
        assert all(r.done for r in got["reqs"]), name
        assert len(got["reqs"]) == (70 if aggressor else 30)
        assert engine.recorders["victim"].count() == 30
        assert got["rate"] > 0
        allocs = ex.allocs(isolated)
        for fn in (("victim", "aggressor") if aggressor else ("victim",)):
            mine.append((fn, _alloc(allocs[fn]), 2, 20))
    assert mine == seen
    assert {fn: m.cfg.name for fn, (m, _) in fns.items()} == {
        "victim": "rwkv6-smoke", "aggressor": "qwen2-7b-smoke"}


def test_isolation_reads_the_victim_only_while_the_aggressor_runs():
    """The victim's rate counts its completions up to the aggressor's
    last (past it the victim serves alone); with no aggressor, or one
    that outlasts the victim, it is the twin's trailing-3/4 rate."""
    ex = load("torch_multi_tenant_isolation")
    victim = SLORecorder("victim",
                         completion_times=[0.1 * i for i in range(1, 21)])
    twin = (20 - 1 - 5) / (2.0 - 0.6)
    assert ex.victim_rate({"victim": victim}) == pytest.approx(twin)
    late = SLORecorder("aggressor", completion_times=[0.5, 3.0])
    assert ex.victim_rate({"victim": victim, "aggressor": late}) == \
        pytest.approx(twin)
    # Up to 1.0: ten completions, the trailing 3/4 from the third.
    early = SLORecorder("aggressor", completion_times=[0.2, 1.0])
    assert ex.victim_rate({"victim": victim, "aggressor": early}) == \
        pytest.approx(7 / 0.7)
    idle = SLORecorder("aggressor")
    assert ex.victim_rate({"victim": victim, "aggressor": idle}) == 0.0
