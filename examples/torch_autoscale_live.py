"""Live autoscaling on the PyTorch port: one declarative spec drives the
port's engines AND the simulator, producing the identical scale-decision
sequence (the port's twin of ``examples/autoscale_live.py``).

A ``FunctionSpec`` declares a tiny chat model with a latency SLO, a
profile table, and a deterministic RPS ramp (1 -> burst -> 1 req/s).  The
``ControlPlane`` reconciles the live fleet (``ClusterFrontend`` over two
``ServingEngine`` nodes) once per virtual tick: Alg. 1 scales the function
from 1 instance up to several at the burst and back down to the floor,
placing via MRA + memory admission and evicting with graceful drain — the
run asserts **zero dropped in-flight requests**.  The same spec is then
replayed through the simulator backend and the two decision logs are
compared entry for entry.

With ``--fail-node`` the busiest node is killed mid-burst: its instances
(weights, KV) die instantly and every stranded request re-executes on the
healed fleet.  ``fail_node`` itself places nothing — the next reconcile
tick prunes the dead pods from L_j (``Backend.alive``) and the processing
gap + below-floor healing re-converge the fleet.  The run still asserts
zero dropped requests, and the simulator replay (same failure injected at
the same tick) still produces the identical decision sequence.

With ``--measured-profile`` the hand-written profile table is replaced by
one MEASURED on the port's live instances
(``profiler.measure_engine_profile`` -> ``measure_callable_trial``: the
temporal quota duty-cycles actual wall-clock decode rounds), the RPS ramp
is re-scaled to the measured capacity so the burst still forces a
scale-out, and both the live fleet and the simulator replay reconcile the
same measured spec — the decision sequences must still match.

The tiny model has head dim 8, which the card's kernels do not take (they
take 16, 32, 64 and 128): on the card the example is refused before
anything runs or any weight is drawn; ``--device cpu`` runs it on the
plain PyTorch path.

Run:  PYTHONPATH=src python examples/torch_autoscale_live.py --device cpu \
          [--fail-node] [--measured-profile]
"""

import argparse
from collections import Counter
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.control import (ControlPlane, FunctionSpec, LiveBackend,
                                 SimBackend, decision_signature, ramp)
from repro_torch.core.cluster import Cluster
from repro_torch.core.scaling import ProfilePoint
from repro_torch.core.workload import ServiceCurve
from repro_torch.launch.serve import head_dim_refusal
from repro_torch.models import build_model
from repro_torch.models.config import ModelConfig
from repro_torch.serving import ClusterFrontend

# Profile table for the tiny model: throughputs are in ticks of the
# reconcile loop, so the decision arithmetic is easy to follow by hand.
PROFILE = (
    ProfilePoint(sm=0.25, quota=0.4, throughput=2.0, p99_latency=0.05),
    ProfilePoint(sm=0.45, quota=0.8, throughput=5.0, p99_latency=0.03),
    ProfilePoint(sm=0.45, quota=0.8, throughput=4.0, p99_latency=0.30),  # SLO-infeasible
)

RAMP = ramp([(0.0, 1.0), (3.0, 12.0), (7.0, 1.0)])
TICKS = 11
FAIL_TICK = 5  # mid-burst, --fail-node only


TINY = ModelConfig(
    name="tiny-chat", family="dense", n_layers=2, d_model=32, n_heads=4,
    n_kv_heads=2, d_ff=64, vocab_size=64, vocab_pad_multiple=32)


def model_factory(device, params=None):
    """The spec's ``model_factory``: the tiny model and its weights on
    ``device`` (drawn from seed 0, or ``params`` when given)."""
    def make_model():
        model = build_model(TINY)
        if params is not None:
            return model, params
        return model, model.init(
            torch.Generator(device=device).manual_seed(0))
    return make_model


def measured_profile_and_ramp(make_model, device):
    """Profile the live instances and scale the demand ramp to what they
    measured, so the burst still drives Alg. 1 past one instance."""
    from repro_torch.core.profiler import measure_engine_profile

    model, params = make_model()
    # The analytic spatial factor stands in for SM partitioning (no
    # instance holds a share of the SMs): capacity saturates at sm ~0.45
    # like the hand-written curve.
    points = measure_engine_profile(
        model, params, spatial=(0.25, 0.45), temporal=(0.4, 0.8),
        max_batch=2, max_len=32, prompt_len=8, new_tokens=3,
        window=0.1, n_windows=3, sm_scale=lambda sm: min(sm / 0.45, 1.0),
        device=device)
    cap = max(p.throughput for p in points)
    slo = 2.0 * max(p.p99_latency for p in points)
    profile = tuple(points)
    # Base load below one instance's capacity, burst past two of them.
    demand = ramp([(0.0, cap * 0.5), (3.0, cap * 2.2), (7.0, cap * 0.5)])
    return profile, slo, demand


def make_spec(make_model, profile=PROFILE, slo: float = 0.1,
              demand=RAMP) -> FunctionSpec:
    return FunctionSpec(
        name="chat", profile=profile, slo_latency=slo, target_rps=demand,
        headroom=1.2, min_instances=1, max_instances=6,
        model_factory=make_model, max_batch=2, max_len=32,
        framework_bytes=32 * 1024 * 1024,
        curve=ServiceCurve(name="chat", r_max=5.0, sm_sat=0.45, p=1.0,
                           weight_bytes=1 << 20, framework_bytes=32 << 20))


def busiest_node(plane: ControlPlane, backend) -> int:
    counts = Counter(backend.node_of(p) for p in plane.placed["chat"])
    return counts.most_common(1)[0][0]


def main(argv: Optional[list[str]] = None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--fail-node", action="store_true",
                        help="kill the busiest node mid-burst and let the "
                             "reconciler heal the fleet")
    parser.add_argument("--measured-profile", action="store_true",
                        help="measure the {<F,S,Q,T>} profile table on the "
                             "live instances instead of the hand-written "
                             "one")
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    refusal = head_dim_refusal(TINY) if device.type == "cuda" else None
    if refusal:
        parser.error(refusal)
    return run(model_factory(device), device, fail_node=args.fail_node,
               measured_profile=args.measured_profile)


def run(make_model, device, *, fail_node: bool = False,
        measured_profile: bool = False) -> dict:
    """The live fleet on ``device`` under the spec whose model comes from
    ``make_model``, then the simulator's replay; returns both decision
    signatures and the live requests."""
    if measured_profile:
        profile, slo, demand = measured_profile_and_ramp(make_model, device)
        print("[profiler] measured on live executors:")
        for p in profile:
            print(f"    sm={p.sm:.2f} quota={p.quota:.1f} "
                  f"T={p.throughput:7.1f} req/s  p99={p.p99_latency:.4f}s")
    else:
        profile, slo, demand = PROFILE, 0.1, RAMP
    spec_args = dict(profile=profile, slo=slo, demand=demand)

    # -- live fleet ------------------------------------------------------
    frontend = ClusterFrontend(n_nodes=2, window=0.1, device=device)
    backend = LiveBackend(frontend)
    live = ControlPlane(backend)
    live.register(make_spec(make_model, **spec_args))
    print(f"[live] registered: {live.instances('chat')} instance(s)")

    rng = np.random.default_rng(0)
    reqs = []
    n_base = None  # fleet size the base (pre-burst) demand settles at
    for tick in range(TICKS):
        if fail_node and tick == FAIL_TICK:
            victim = busiest_node(live, backend)
            lost = frontend.fail_node(victim)
            print(f"  t={tick:2d} node {victim} FAILED: {lost} instance(s) "
                  f"lost, stranded requests re-queued; reconcile heals")
        live.reconcile(now=float(tick))
        n_inst = live.instances("chat")
        if n_base is None:
            n_base = n_inst
        # Offer load matching the declared ramp; prompts of varying length
        # exercise the bucketed prefill (one compile per bucket).  The
        # measured-profile capacity can run to hundreds of req/s on this
        # container — cap the offered sample so the example stays short
        # (decisions follow the declared ramp, not the sampled arrivals).
        for _ in range(min(int(demand(float(tick))), 40)):
            prompt = rng.integers(0, 64, int(rng.integers(4, 12)),
                                  dtype=np.int32)
            reqs.append(frontend.submit("chat", prompt, max_new_tokens=3))
        frontend.pump(budget_s=5.0)
        print(f"  t={tick:2d} target={demand(float(tick)):7.1f} rps  "
              f"instances={n_inst}  inflight={frontend.inflight('chat')}")
    frontend.pump(budget_s=30.0)

    peak = max(e.instances_before for e in live.events)
    assert peak > n_base, "burst must scale the function out"
    assert live.instances("chat") == n_base, \
        "ramp-down must return to the pre-burst fleet size"
    done = sum(1 for r in reqs if r.done)
    assert done == len(reqs), f"dropped {len(reqs) - done} in-flight requests"
    if fail_node:
        healed = next(e for e in live.events if e.pruned)
        print(f"[live] t={healed.now:.0f}: reconcile pruned "
              f"{len(healed.pruned)} dead pod(s) and re-placed "
              f"{sum(1 for d in healed.applied if d.direction > 0)}")
    print(f"[live] served {done}/{len(reqs)} requests "
          f"(zero dropped across scale-up, {'node failure, ' if fail_node else ''}"
          f"AND drain-down), peak instances={peak}")

    # -- simulator replay of the same spec (same failure injected) --------
    cluster = Cluster(n_nodes=2, sharing=True)
    sim_backend = SimBackend(cluster)
    sim = ControlPlane(sim_backend)
    sim.register(make_spec(make_model, **spec_args))
    for tick in range(TICKS):
        if fail_node and tick == FAIL_TICK:
            cluster.fail_node(busiest_node(sim, sim_backend))
        sim.reconcile(now=float(tick))

    live_sig = decision_signature(live.log)
    sim_sig = decision_signature(sim.log)
    assert live_sig == sim_sig, (
        f"decision logs diverged:\n live={live_sig}\n  sim={sim_sig}")
    print(f"[replay] simulator produced the identical "
          f"{len(sim_sig)}-decision sequence: OK")
    for sig in live_sig:
        fn, direction, sm, quota = sig
        arrow = "up" if direction > 0 else "down"
        print(f"    {fn}: scale-{arrow} at (sm={sm}, quota={quota})")
    return dict(live=live_sig, sim=sim_sig, reqs=reqs, done=done)


if __name__ == "__main__":
    main()
