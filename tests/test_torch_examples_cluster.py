"""``examples/torch_serve_cluster.py`` and
``examples/torch_autoscale_live.py`` on the CPU beside their JAX twins.

* serve_cluster: the simulator's section prints the twin's lines, line
  for line; the live section places each function on the twin's nodes
  and serves the twin's count of requests, every one;
* autoscale_live: the live fleet's ``decision_signature`` equals the
  twin's and the port's simulator replay, with no request dropped, with
  and without a node failing mid-burst;
* on the card both are refused before anything runs (their tiny models'
  head dim 8 is one the kernels do not take), with no CPU fallback.
"""

import pytest
import torch

from examples_twins import load

torch.set_num_threads(2)


def _split(text: str) -> tuple[list[str], list[str]]:
    lines = text.splitlines()
    at = next(i for i, x in enumerate(lines) if x.startswith("[live]"))
    return lines[:at], lines[at:]


def test_serve_cluster_prints_the_twin_s_simulation_and_placements(capsys):
    load("serve_cluster").main()
    jax_sim, jax_live = _split(capsys.readouterr().out)
    out = load("torch_serve_cluster").main(["--device", "cpu"])
    sim, live = _split(capsys.readouterr().out)
    assert sim == jax_sim
    assert [x for x in live if "instances on nodes" in x] == \
        [x for x in jax_live if "instances on nodes" in x]
    served = [x.split(",")[0] for x in jax_live if "served" in x]
    assert [x.split(",")[0] for x in live if "served" in x] == served
    assert out["done"] == len(out["reqs"]) == 48
    assert out["placed"] == {"chat": [0, 1], "code": [0, 1]}


@pytest.mark.parametrize("flags", [[], ["--fail-node"]])
def test_autoscale_live_decisions_equal_the_twin_s(monkeypatch, capsys,
                                                   flags):
    twin = load("autoscale_live")
    signatures = []
    real = twin.decision_signature

    def recording(log):
        sig = real(log)
        signatures.append(sig)
        return sig

    monkeypatch.setattr(twin, "decision_signature", recording)
    monkeypatch.setattr("sys.argv", ["autoscale_live.py", *flags])
    twin.main()
    jax_live, jax_sim = signatures
    out = load("torch_autoscale_live").main(["--device", "cpu", *flags])
    assert out["live"] == out["sim"] == jax_live == jax_sim
    assert len(out["live"]) >= 2
    assert out["done"] == len(out["reqs"]) > 0
    assert all(r.done for r in out["reqs"])


@pytest.mark.parametrize("name", ["torch_serve_cluster",
                                  "torch_autoscale_live"])
def test_head_dim_8_examples_are_refused_on_the_card(monkeypatch, capsys,
                                                     name):
    ex = load(name)
    monkeypatch.setattr(ex, "resolve_device",
                        lambda device: torch.device("cuda", 0))
    ran = []
    for hook in ("simulate", "run"):
        if hasattr(ex, hook):
            monkeypatch.setattr(ex, hook, lambda *a, **k: ran.append(a))
    with pytest.raises(SystemExit) as err:
        ex.main([])
    assert err.value.code == 2 and not ran
    assert "head dim 8" in capsys.readouterr().err
