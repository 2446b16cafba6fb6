"""Full control plane on the PyTorch port: profile -> autoscale -> schedule
-> survive failures (the port's twin of ``examples/serve_cluster.py``).

Reproduces the paper's serving story end to end on the discrete-event
cluster: FaST-Profiler sweeps two functions, Alg. 1 autoscales them under a
diurnal load with a latency SLO, MRA packs pods onto the fewest GPUs, a
node is killed mid-run (fault tolerance), and the run ends with utilization
/ occupancy / SLO numbers.  A final section replays the same stack on the
*live* data plane: a ``ClusterFrontend`` places two functions across two
``ServingEngine`` nodes (MRA + memory admission) and serves real
continuous-batching decodes through the per-node token schedulers.

The live section's tiny models have head dim 8, which the card's kernels
do not take (they take 16, 32, 64 and 128): on the card the example is
refused before anything runs or any weight is drawn; ``--device cpu``
runs it on the plain PyTorch path.

Run:  PYTHONPATH=src python examples/torch_serve_cluster.py --device cpu
"""

import argparse
from typing import Optional

from repro_torch import resolve_device
from repro_torch.core.cluster import Cluster
from repro_torch.core.profiler import profile_points
from repro_torch.core.workload import PAPER_ZOO, diurnal_trace, trace_arrivals
from repro_torch.launch.serve import head_dim_refusal
from repro_torch.models.config import ModelConfig

SLO = {"resnet": 0.069, "bert": 0.15}
DURATION = 120.0
TINY = dict(family="dense", n_layers=2, d_model=32, n_heads=4,
            n_kv_heads=2, d_ff=64, vocab_size=64, vocab_pad_multiple=32)


def simulate() -> dict:
    """Sections 1-4: the simulated cluster; returns its recorders."""
    # 1. FaST-Profiler: Experiment -> Trial grid for each function,
    #    emitted as the spec-ready {<F, S, Q, T>} table.
    profiles = {fn: profile_points(PAPER_ZOO[fn]) for fn in SLO}
    for fn, pts in profiles.items():
        best = max(pts, key=lambda p: p.rpr)
        print(f"[profile] {fn}: best RPR at sm={best.sm} quota={best.quota} "
              f"-> {best.throughput:.1f} req/s")

    # 2. Cluster with autoscaling control loop.
    cluster = Cluster(n_nodes=6, sharing=True, max_batch=2)
    arrivals = []
    for i, fn in enumerate(SLO):
        cluster.register_function(fn, PAPER_ZOO[fn], slo_latency=SLO[fn])
        cluster.deploy(fn, max(profiles[fn], key=lambda p: p.rpr),
                       elastic_limit=1.0)
        trace = diurnal_trace(15.0, 150.0, DURATION, DURATION, 5.0) + [
            (DURATION, 0.0)]
        arrivals += trace_arrivals(fn, trace, seed=10 + i)
    cluster.submit_all(arrivals)

    def control() -> None:
        now = cluster.sim.now
        pred = {}
        for fn in SLO:
            recent = [r for r in arrivals
                      if r.fn == fn and now - 2.0 <= r.arrival <= now]
            pred[fn] = len(recent) / 2.0
        cluster.autoscale(pred, profiles, slo_latency=SLO, headroom=1.6)
        if now < DURATION:
            cluster.sim.after(0.5, control)

    cluster.sim.after(0.5, control)

    # 3. Kill a node mid-run: the failure path only records the damage
    #    (pods dead, requests re-queued); the 0.5 s Alg.-1 control loop
    #    above sees the lost L_j capacity and re-places on survivors.
    def failure() -> None:
        victim = next((n.node_id for n in cluster.nodes if n.pods), 0)
        lost = cluster.fail_node(victim)
        print(f"[t={cluster.sim.now:5.1f}] node {victim} FAILED; "
              f"{lost} pods lost — the autoscale loop heals the gap")

    cluster.sim.at(DURATION / 2, failure)
    cluster.run(DURATION + 10)

    # 4. Report.
    print(f"\n[cluster] nodes in use: {cluster.nodes_in_use()} / 6  "
          f"(dropped={cluster.dropped}, rescheduled={cluster.rescheduled})")
    print(f"[cluster] utilization={cluster.gpu_utilization(30):.2f}  "
          f"occupancy={cluster.sm_occupancy(30):.2f}")
    for fn in SLO:
        rec = cluster.recorders[fn]
        print(f"  {fn:8s} served={rec.count():5d}  p99={rec.p99(5.0):.3f}s  "
              f"SLO violations={rec.violation_ratio(5.0):.2%}")
        assert rec.violation_ratio(5.0) < 0.05, "SLO badly violated"
    return cluster.recorders


def tiny_models() -> dict:
    from repro_torch.models import build_model
    return {"chat": build_model(ModelConfig(name="tiny-chat", **TINY)),
            "code": build_model(ModelConfig(name="tiny-code", **TINY))}


def run(fns: dict, params: dict, device) -> dict:
    """Section 5: ``fns``' models with ``params`` (on ``device``) placed
    by a live ``ClusterFrontend`` over two nodes; 24 requests a
    function.  Returns the frontend, the placements and the requests."""
    import numpy as np

    from repro_torch.core.resources import Alloc
    from repro_torch.serving import ClusterFrontend

    print("\n[live] ClusterFrontend: 2 functions x 2 engine nodes, "
          "continuous batching")
    frontend = ClusterFrontend(n_nodes=2, window=0.1, device=device)
    # A 0.6-quota x 0.55-SM rectangle cannot pack twice on one node, so
    # each function's two instances land on different nodes; the smaller
    # function then fills the leftover strips (the sim's MRA, live).
    allocs = {"chat": Alloc(sm=0.55, quota_request=0.6, quota_limit=0.8),
              "code": Alloc(sm=0.35, quota_request=0.6, quota_limit=0.8)}
    placed = {}
    for fn, model in fns.items():
        frontend.deploy(fn, model, params[fn], allocs[fn], n_instances=2,
                        max_batch=4, max_len=32)
        placed[fn] = frontend.nodes_for(fn)
        print(f"  {fn}: instances on nodes {placed[fn]}")
    rng = np.random.default_rng(0)
    reqs = [frontend.submit(fn, rng.integers(0, 64, 8, dtype=np.int32),
                            max_new_tokens=4 + i % 5)
            for i in range(24) for fn in fns]
    done = frontend.pump(budget_s=60.0)
    refills = sum(inst.refills for e in frontend.engines
                  for inst in e.instances.values())
    assert done == len(reqs) and all(r.done for r in reqs)
    print(f"  served {done} requests, {refills} mid-flight slot refills, "
          f"occupancy={frontend.occupancy():.2f}, "
          f"shared weights={frontend.memory_bytes() / 1024:.0f} KiB")
    return dict(frontend=frontend, placed=placed, reqs=reqs, done=done)


def main(argv: Optional[list[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    refusal = (head_dim_refusal(ModelConfig(name="tiny-chat", **TINY))
               if device.type == "cuda" else None)
    if refusal:
        ap.error(refusal)
    import torch

    simulate()
    # 5. The same stack, live: ClusterFrontend over the port's engines.
    fns = tiny_models()
    params = {fn: model.init(torch.Generator(device=device).manual_seed(i))
              for i, (fn, model) in enumerate(fns.items())}
    return run(fns, params, device)


if __name__ == "__main__":
    main()
