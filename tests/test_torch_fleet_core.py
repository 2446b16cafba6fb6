"""The port's copies of the scheduling core and the control plane against
the JAX package's originals (``repro.core`` and ``repro.control``): the
MRA placement sequence over random ``Alloc`` streams (a hypothesis
property), one simulator run over a ``PAPER_ZOO`` workload, Alg. 1's
decisions on ``FunctionPodQueue``s, a chaos schedule and its replay,
``MemoryModel`` and ``node_shared_footprint``, the round alpha, the
simulated profiler, and the demand forecasters.

These modules are pure Python and numpy in both packages, so the
tolerance is exact equality (the same float arithmetic).
"""

import dataclasses

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from conftest import tiny_config
from repro.control import spec as jspec
from repro.core import chaos as jchaos
from repro.core import cluster as jcluster
from repro.core import maximal_rectangles as jmra
from repro.core import model_sharing as jms
from repro.core import profiler as jprof
from repro.core import resources as jres
from repro.core import scaling as jscaling
from repro.core import workload as jwork
from repro_torch import core as tcore
from repro_torch.control import spec as tspec
from repro_torch.core import chaos as tchaos
from repro_torch.core import cluster as tcluster
from repro_torch.core import maximal_rectangles as tmra
from repro_torch.core import model_sharing as tms
from repro_torch.core import profiler as tprof
from repro_torch.core import resources as tres
from repro_torch.core import scaling as tscaling
from repro_torch.core import workload as twork
from repro_torch.models.config import ModelConfig as TorchConfig

_FRACTIONS = st.sampled_from([0.06, 0.1, 0.12, 0.2, 0.24, 0.25, 0.3, 0.45,
                              0.5, 0.6, 0.8, 1.0])
_OPS = st.lists(st.tuples(st.sampled_from(["place", "release"]), _FRACTIONS,
                          _FRACTIONS, st.integers(0, 50)),
                min_size=1, max_size=40)


def _mra_trace(mra, res, n_nodes, ops):
    """Schedule and release over one pool; the sequence of (node, rect)
    outcomes, fragmentation and load after every step."""
    pool = mra.MaxRectsPool(n_nodes, allow_grow=False)
    live, out = [], []
    for i, (op, sm, q, pick) in enumerate(ops):
        if op == "release" and live:
            pool.release(live.pop(pick % len(live)))
            out.append(("release",))
        else:
            p = pool.schedule(res.Alloc(sm=sm, quota_request=q,
                                        quota_limit=q), f"pod-{i}")
            if p is not None:
                live.append(p)
            out.append(None if p is None else (p.node, p.rect))
        out.append((pool.fragmentation(), pool.node_load()))
    return out


@settings(max_examples=60, deadline=None)
@given(ops=_OPS, n_nodes=st.integers(1, 3))
def test_maxrects_placement_sequences_equal(ops, n_nodes):
    got = _mra_trace(tmra, tres, n_nodes, ops)
    want = _mra_trace(jmra, jres, n_nodes, ops)
    assert [(x if x is None or isinstance(x[0], (str, dict, float))
             else (x[0], dataclasses.astuple(x[1])))
            for x in got] == \
        [(x if x is None or isinstance(x[0], (str, dict, float))
          else (x[0], dataclasses.astuple(x[1]))) for x in want]


def _sim_metrics(cl, wl, scaling):
    """One simulator run of two PAPER_ZOO functions on two nodes, with
    an autoscaling pass; its recorder metrics and placements."""
    cluster = cl.Cluster(n_nodes=2, sharing=True)
    out = []
    for fn, sm, q in (("resnet", 0.24, 0.5), ("rnnt", 0.12, 0.6)):
        curve = wl.PAPER_ZOO[fn]
        cluster.register_function(fn, curve)
        point = scaling.ProfilePoint(sm=sm, quota=q,
                                     throughput=curve.rate(sm, q))
        out.append(cluster.deploy(fn, point))
        cluster.submit_all(wl.poisson_arrivals(fn, curve.rate(sm, q) * 1.5,
                                               12.0, seed=3))
    cluster.run(14.0)
    for fn in ("resnet", "rnnt"):
        rec = cluster.recorders[fn]
        out.append((fn, rec.throughput(2.0, 12.0), rec.p50(since=2.0),
                    rec.p99(since=2.0), cluster.sim.now))
    return out


def test_simulator_run_over_paper_zoo_identical():
    assert _sim_metrics(tcluster, twork, tscaling) == \
        _sim_metrics(jcluster, jwork, jscaling)


def test_simulate_trial_and_profile_points_identical():
    for fn in ("resnet", "gnmt"):
        curve_t, curve_j = twork.PAPER_ZOO[fn], jwork.PAPER_ZOO[fn]
        assert dataclasses.astuple(tprof.simulate_trial(
            curve_t, 0.24, 0.6, duration=8.0)) == dataclasses.astuple(
            jprof.simulate_trial(curve_j, 0.24, 0.6, duration=8.0))
        kw = dict(spatial=(0.12, 0.5), temporal=(0.4, 1.0), duration=6.0,
                  kv_budget_bytes=1 << 20, kv_block_bytes=4096,
                  kv_shared_frac=0.25)
        assert [dataclasses.astuple(p)
                for p in tprof.profile_points(curve_t, **kw)] == \
            [dataclasses.astuple(p) for p in jprof.profile_points(curve_j,
                                                                  **kw)]


def _alg1_trace(scaling, gaps):
    """Alg. 1 over one queue: every decision's (direction, point) and the
    queue's capacity after settling it."""
    pts = [scaling.ProfilePoint(sm=0.25, quota=0.4, throughput=2.0,
                                p99_latency=0.05),
           scaling.ProfilePoint(sm=0.45, quota=0.8, throughput=5.0,
                                p99_latency=0.03),
           scaling.ProfilePoint(sm=0.1, quota=0.1, throughput=3.0,
                                p99_latency=0.5)]
    queues = {"f": scaling.FunctionPodQueue()}
    out = []
    for i, gap in enumerate(gaps):
        ds = scaling.heuristic_scale({"f": gap}, {"f": pts}, queues,
                                     slo_latency={"f": 0.1})
        for j, d in enumerate(ds):
            if d.direction > 0:
                if (i + j) % 3 == 2:
                    queues["f"].abort(d.pod_id)
                else:
                    queues["f"].confirm(d.pod_id, f"real-{i}-{j}")
            out.append((d.direction, dataclasses.astuple(d.point)))
        out.append((len(queues["f"]), queues["f"].capacity(),
                    scaling.processing_gap({"f": 7.0}, queues)))
    return out


@pytest.mark.parametrize("gaps", [
    (6.5, 0.0, -3.0, 11.0, -20.0),
    (1.0, 1.0, 1.0, -0.5, -2.5, 4.9),
])
def test_alg1_decisions_on_pod_queues_identical(gaps):
    assert _alg1_trace(tscaling, gaps) == _alg1_trace(jscaling, gaps)
    assert tscaling.expected_tokens_per_round(4, 0.7) == \
        jscaling.expected_tokens_per_round(4, 0.7)


def _chaos_replay(ch, cl):
    sched = ch.ChaosSchedule.generate(seed=11, duration=30.0, n_nodes=4,
                                      n_events=10)
    cluster = cl.Cluster(n_nodes=4, sharing=True)
    inj = ch.ChaosInjector(sched, ch.SimChaosTarget(cluster))
    state = []
    for t in range(0, 32, 2):
        inj.advance(float(t))
        state.append((inj.pending(), [
            (n.alive, n.slowdown, n.mem_bytes) for n in cluster.nodes]))
    return ([dataclasses.astuple(e) for e in sched.events],
            [dataclasses.astuple(e) for _, e in inj.applied], state)


def test_chaos_schedule_and_replay_identical():
    assert _chaos_replay(tchaos, tcluster) == _chaos_replay(jchaos,
                                                            jcluster)


@pytest.mark.parametrize("weight,framework,overhead", [
    (1 << 20, 32 << 20, None), (15_231_233_024, 470_679_552, None),
    (7 << 30, 1 << 30, 0)])
def test_memory_model_identical(weight, framework, overhead):
    kw = {} if overhead is None else {"server_overhead": overhead}
    t = tms.MemoryModel(weight_bytes=weight, framework_bytes=framework, **kw)
    j = jms.MemoryModel(weight_bytes=weight, framework_bytes=framework, **kw)
    for n in range(6):
        for sharing in (False, True):
            assert t.footprint(n, sharing) == j.footprint(n, sharing)
            assert t.footprint(n, sharing, server=False) == \
                j.footprint(n, sharing, server=False)
        if n:
            assert t.reduction(n) == j.reduction(n)
    for cap in (16 << 30, 40 << 30, 80 << 30):
        for sharing in (False, True):
            assert t.max_instances(cap, sharing) == \
                j.max_instances(cap, sharing)
    pairs = [(2, 3), (1, 0), (0, 5)]
    second = dict(weight_bytes=1 << 30, framework_bytes=1 << 28,
                  server_overhead=5 << 20)
    assert tms.node_shared_footprint(
        zip([t, tms.MemoryModel(**second), t], (n for n, _ in pairs))) == \
        jms.node_shared_footprint(
            zip([j, jms.MemoryModel(**second), j], (n for n, _ in pairs)))
    assert tms.SERVER_CONTEXT_OVERHEAD == jms.SERVER_CONTEXT_OVERHEAD


def test_round_alpha_identical_without_the_roofline_module():
    """The port's ``decode_round_alpha`` (``repro_torch.analysis.roofline``,
    which ``calibrate_round_alpha`` imports) equals the JAX package's for
    the dense tiny config, a windowed one, and the rwkv and hybrid
    families."""
    from repro.configs import get_config

    cfgs = [tiny_config(), tiny_config(sliding_window=16)]
    cfgs += [get_config(name) for name in ("qwen2-7b", "rwkv6-1.6b",
                                           "hymba-1.5b")]
    for cfg in cfgs:
        tcfg = TorchConfig(**dataclasses.asdict(cfg))
        for seq in (1, 64, 2048):
            got = twork.calibrate_round_alpha(
                twork.PAPER_ZOO["resnet"], tcfg, seq_len=seq)
            want = jwork.calibrate_round_alpha(
                jwork.PAPER_ZOO["resnet"], cfg, seq_len=seq)
            assert dataclasses.astuple(got) == dataclasses.astuple(want), \
                (cfg.name, seq)


def test_demand_forecasters_and_spec_validation_identical():
    rng = np.random.default_rng(0)
    series = list(10 + 5 * np.sin(np.arange(48) * 2 * np.pi / 12)
                  + rng.normal(0, 0.5, 48))
    assert tspec.autocorr_season(series) == jspec.autocorr_season(series)
    fits = [mod.fit_holt_winters(series) for mod in (tspec, jspec)]
    assert [(f.alpha, f.beta, f.gamma, f.season) for f in fits[:1]] == \
        [(f.alpha, f.beta, f.gamma, f.season) for f in fits[1:]]
    for t_cls, j_cls in ((tspec.EWMADemand, jspec.EWMADemand),
                         (tspec.HoltWintersDemand, jspec.HoltWintersDemand)):
        a, b = t_cls(), j_cls()
        for i, x in enumerate(series):
            a.observe(float(i), x)
            b.observe(float(i), x)
            assert a(float(i) + 1) == b(float(i) + 1)
    ramp_t = tspec.ramp([(0.0, 1.0), (2.0, 8.0), (6.0, 1.0)])
    ramp_j = jspec.ramp([(0.0, 1.0), (2.0, 8.0), (6.0, 1.0)])
    assert [ramp_t(t / 2) for t in range(16)] == \
        [ramp_j(t / 2) for t in range(16)]
    point_t = tscaling.ProfilePoint(sm=0.25, quota=0.4, throughput=2.0)
    point_j = jscaling.ProfilePoint(sm=0.25, quota=0.4, throughput=2.0)
    for bad in (dict(min_instances=3, max_instances=2), dict(headroom=0.5),
                dict(slo_tier="gold"), dict(deadline_s=-1.0),
                dict(shards=0), dict(cold_start_s=-1.0),
                dict(kv_shared_frac=0.5), dict(profile=())):
        msgs = []
        for mod, point in ((tspec, point_t), (jspec, point_j)):
            kw = {"name": "f", "profile": (point,), **bad}
            with pytest.raises(ValueError) as err:
                mod.FunctionSpec(**kw)
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1]


def test_core_exports_match_the_jax_package():
    import repro.core as jcore

    assert sorted(tcore.__all__) == sorted(jcore.__all__)
