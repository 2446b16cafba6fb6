"""Backend-agnostic reconciler: paper Alg. 1 converging a declared fleet.

One ``reconcile(now)`` tick is the paper's closed loop:

0. **Prune** — pods that died behind the reconciler's back (node failure)
   are dropped from ``placed`` and the L_j capacity queue via
   ``backend.alive``, so the gap below sees the real fleet.  This is the
   entire failure-recovery story: a dead pod is just missing capacity,
   and steps 1-4 re-converge it — identically on both backends.
1. **Demand** — per function, read ``R_j`` from the spec's target-RPS
   source (deterministic replay; predictive ``DemandSource``s are fed the
   backend's observed rate first) or the backend's observed trailing-
   window arrival rate, then inflate by the spec's headroom.
2. **Gap** — ``ΔRPS_j = R_j - Σ_i T_{j,i}`` over the L_j capacity queue
   (``processing_gap``).
3. **Decide** — ``heuristic_scale`` (Alg. 1) filtered to SLO-feasible
   profile points: bulk ``p_eff`` pods + one minimal-sufficient
   ``p_ideal`` on scale-up; lowest-RPR victims on scale-down.
4. **Converge** — scale-ups go through ``backend.place`` (MRA + memory
   admission with node spillover); each provisional L_j reservation is
   settled with ``confirm``/``abort`` so capacity never drifts above
   reality.  Scale-downs go through ``backend.evict``, which drains the
   victim's in-flight slots before releasing its rectangle and weight
   refcount.  ``min/max_instances`` clamps are applied here, on top of
   Alg. 1.
5. **Defragment** — when the worst node's MRA fragmentation exceeds
   ``defrag_threshold``, the lowest-RPR pod on that node migrates to the
   least-loaded node that admits it (``backend.migrate`` — a real KV move
   on the live path).  Migrations re-key L_j entries in place; they are
   capacity-neutral and logged separately (``migrations``), never in the
   decision log, so replay signatures stay backend-independent.

Because every decision is computed here — the backend only places,
evicts, and moves — the simulator and the live torch data plane run
literally the same scheduler code, and a live run can be replayed through
the simulator decision-for-decision, node failures included.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Iterable, Optional

from repro_torch.control.backend import Backend
from repro_torch.control.spec import DemandSource, FunctionSpec
from repro_torch.core.scaling import (FunctionPodQueue, ProfilePoint, ScaleDecision,
                                heuristic_scale, processing_gap)


def decision_signature(decisions: Iterable[ScaleDecision]
                       ) -> list[tuple[str, int, float, float]]:
    """Backend-independent fingerprint of a decision sequence.

    Pod ids differ between backends (``fn-3`` vs ``1:fn/0``); what must
    match when replaying a live run through the simulator is *what* was
    scaled: (function, direction, S_p, Q_p) per decision, in order.
    """
    return [(d.function, d.direction, d.point.sm, d.point.quota)
            for d in decisions]


@dataclasses.dataclass
class ReconcileEvent:
    """Telemetry for one reconcile tick of one function."""

    now: float
    fn: str
    target_rps: float
    capacity_before: float
    instances_before: int
    inflight: int
    applied: list[ScaleDecision] = dataclasses.field(default_factory=list)
    pruned: list[str] = dataclasses.field(default_factory=list)


@dataclasses.dataclass(frozen=True)
class MigrationEvent:
    """One defragmentation move applied by the reconciler."""

    now: float
    fn: str
    old_pod: str
    new_pod: str
    source: int
    target: int
    fragmentation: float  # source-node fragmentation that triggered it


@dataclasses.dataclass(frozen=True)
class QuarantineEvent:
    """One gray-failure quarantine applied by the reconciler."""

    now: float
    node: int
    score: float      # backend.health(node) that tripped the threshold
    instances: int    # instances taken out of rotation


class ControlPlane:
    """Declarative reconciler over any :class:`Backend`.

    ``history`` bounds the retained telemetry (``log`` / ``events``) so a
    long-lived control loop doesn't grow without bound.  ``defrag_threshold``
    arms the defragmentation pass: when any node's MRA fragmentation
    exceeds it, up to ``defrag_max_moves`` lowest-RPR pods migrate off the
    worst node per tick (None disables the pass).  ``quarantine_threshold``
    arms the gray-failure sweep: a node whose ``backend.health`` drops
    below it is quarantined — routing stops, occupants drain, and the
    reconciler's ordinary prune + processing gap heal the capacity exactly
    like a crash (None disables the sweep).
    """

    def __init__(self, backend: Backend, history: int = 10_000,
                 defrag_threshold: Optional[float] = None,
                 defrag_max_moves: int = 1,
                 quarantine_threshold: Optional[float] = None):
        self.backend = backend
        self.defrag_threshold = defrag_threshold
        self.defrag_max_moves = defrag_max_moves
        self.quarantine_threshold = quarantine_threshold
        self.specs: dict[str, FunctionSpec] = {}
        self.queues: dict[str, FunctionPodQueue] = {}
        # fn -> pod_id -> profile point, for every live instance we placed.
        self.placed: dict[str, dict[str, ProfilePoint]] = {}
        self.log: deque[ScaleDecision] = deque(maxlen=history)
        self.events: deque[ReconcileEvent] = deque(maxlen=history)
        self.migrations: deque[MigrationEvent] = deque(maxlen=history)
        self.quarantines: deque[QuarantineEvent] = deque(maxlen=history)
        self._quarantined: set[int] = set()

    # -- registration ------------------------------------------------------

    def register(self, spec: FunctionSpec) -> None:
        """Declare a function and bring up its ``min_instances`` floor at
        the most efficient SLO-feasible profile point.

        All-or-nothing: a failed bring-up evicts whatever it placed and
        unregisters the spec, so the caller can retry cleanly.
        """
        if spec.name in self.specs:
            raise ValueError(f"function {spec.name!r} already registered")
        self.backend.register(spec)
        self.specs[spec.name] = spec
        self.queues[spec.name] = FunctionPodQueue()
        self.placed[spec.name] = {}
        point = spec.best_point()
        for _ in range(spec.min_instances):
            if self._place(spec, point) is None:
                for pod_id in list(self.placed[spec.name]):
                    self.backend.evict(spec, pod_id)
                del self.specs[spec.name]
                del self.queues[spec.name]
                del self.placed[spec.name]
                raise RuntimeError(
                    f"cannot bring up min_instances={spec.min_instances} "
                    f"for {spec.name!r}: no node admits {point}")

    def _place(self, spec: FunctionSpec,
               point: ProfilePoint) -> Optional[str]:
        real = self.backend.place(spec, point)
        if real is not None:
            self.queues[spec.name].push(real, point)
            self.placed[spec.name][real] = point
        return real

    # -- introspection -----------------------------------------------------

    def instances(self, fn: str) -> int:
        return len(self.placed[fn])

    def capacity(self, fn: str) -> float:
        return self.queues[fn].capacity()

    # -- the loop ----------------------------------------------------------

    def reconcile(self, now: Optional[float] = None) -> list[ScaleDecision]:
        """One Alg.-1 tick over every registered function.

        ``now`` defaults to the backend clock; pass explicit ticks to make
        live and simulated runs comparable (their clocks differ, their
        decisions must not).
        """
        if now is None:
            now = self.backend.now()
        # Gray-failure sweep FIRST: a node quarantined here reads dead to
        # ``alive`` below, so the same tick's prune + gap already heal it.
        if self.quarantine_threshold is not None:
            self._sweep_health(now)
        # Prune pods that died behind our back (node failure): L_j and
        # ``placed`` are authoritative only over pods the backend still
        # reports alive, so the gap below re-provisions lost capacity.
        pruned: dict[str, list[str]] = {}
        for fn in self.specs:
            gone = [p for p in self.placed[fn]
                    if not self.backend.alive(p)]
            for pod_id in gone:
                self.placed[fn].pop(pod_id)
                self.queues[fn].remove(pod_id)
            if gone:
                pruned[fn] = gone
        demand: dict[str, float] = {}
        pre: dict[str, ReconcileEvent] = {}
        for fn, spec in self.specs.items():
            source = spec.target_rps
            if source is None:
                rps = self.backend.observed_rps(fn, spec.rps_window)
            else:
                if isinstance(source, DemandSource):
                    # Forecasters eat the arrival log, one tick at a time.
                    source.observe(
                        now, self.backend.observed_rps(fn, spec.rps_window))
                rps = source(now)
            demand[fn] = rps * spec.headroom
            pre[fn] = ReconcileEvent(
                now=now, fn=fn, target_rps=rps,
                capacity_before=self.queues[fn].capacity(),
                instances_before=len(self.placed[fn]),
                inflight=self.backend.inflight(fn),
                pruned=pruned.get(fn, []))
        gaps = processing_gap(demand, self.queues)
        # SLO feasibility is filtered once, by the spec (the same filter
        # best_point() used at registration) — heuristic_scale's own
        # slo_latency re-filter stays for legacy Cluster.autoscale callers.
        profiles = {fn: s.feasible_points() for fn, s in self.specs.items()}
        decisions = heuristic_scale(gaps, profiles, self.queues)
        applied: list[ScaleDecision] = []
        for d in decisions:
            spec = self.specs[d.function]
            queue = self.queues[d.function]
            live = self.placed[d.function]
            if d.direction > 0:
                if len(live) >= spec.max_instances:
                    queue.abort(d.pod_id)  # fleet-size ceiling
                    continue
                real = self.backend.place(spec, d.point)
                if real is None:
                    queue.abort(d.pod_id)  # no node admits it
                    continue
                queue.confirm(d.pod_id, real)
                live[real] = d.point
                applied.append(dataclasses.replace(d, pod_id=real))
            else:
                assert d.pod_id is not None
                if len(live) <= spec.min_instances:
                    # Alg. 1 popped the victim; fleet floor puts it back.
                    queue.push(d.pod_id, d.point)
                    continue
                self.backend.evict(spec, d.pod_id)
                live.pop(d.pod_id, None)
                applied.append(d)
        # Heal below-floor fleets (a pod died, or an earlier bring-up was
        # capacity-starved): the floor is declared state, not a one-shot.
        for fn, spec in self.specs.items():
            while len(self.placed[fn]) < spec.min_instances:
                point = spec.best_point()
                real = self._place(spec, point)
                if real is None:
                    break  # still no capacity; retry next tick
                applied.append(ScaleDecision(fn, point, +1, pod_id=real))
        # Defragmentation: heal the MRA rectangle space a long ramp
        # shattered by moving cheap pods off the worst node.
        if self.defrag_threshold is not None:
            self._defrag(now)
        for d in applied:
            pre[d.function].applied.append(d)
        self.events.extend(pre.values())
        self.log.extend(applied)
        return applied

    # -- gray-failure quarantine -------------------------------------------

    def _sweep_health(self, now: float) -> list[QuarantineEvent]:
        """Quarantine every schedulable node whose health score fell below
        the threshold, always keeping at least one node in rotation.

        Quarantine is a health action, not a scheduling decision: events
        go to ``self.quarantines``, never the decision log, so a replay's
        ``decision_signature`` is unaffected by WHICH backend detected the
        degradation — only by the capacity gap it opened, which both
        backends heal through the same Alg.-1 path.
        """
        swept: list[QuarantineEvent] = []
        in_rotation = sorted(set(self.backend.node_load())
                             - self._quarantined)
        scores = {n: self.backend.health(n) for n in in_rotation}
        # Worst node first, so the keep-one floor protects the healthiest.
        for node in sorted(in_rotation, key=lambda n: scores[n]):
            if scores[node] >= self.quarantine_threshold:
                break
            if len(in_rotation) - len(swept) <= 1:
                break  # never quarantine the last schedulable node
            n_inst = self.backend.quarantine(node)
            self._quarantined.add(node)
            event = QuarantineEvent(now=now, node=node,
                                    score=scores[node], instances=n_inst)
            self.quarantines.append(event)
            swept.append(event)
        return swept

    # -- defragmentation ---------------------------------------------------

    def _defrag(self, now: float) -> list[MigrationEvent]:
        """Migrate up to ``defrag_max_moves`` lowest-RPR pods off the most
        fragmented node to the least-loaded node that admits them.

        Migrations are capacity-neutral: the pod keeps its profile point,
        its L_j entry is re-keyed, and nothing enters the decision log —
        so a simulator replay's ``decision_signature`` is unaffected by
        how (or whether) the two fleets happened to defragment.
        """
        moved: list[MigrationEvent] = []
        for _ in range(self.defrag_max_moves):
            frag = self.backend.fragmentation()
            if not frag:
                break
            worst = max(sorted(frag), key=lambda n: frag[n])
            if frag[worst] <= self.defrag_threshold:
                break
            # Victim: the lowest-RPR pod we placed on the worst node (the
            # cheapest capacity to move, per Alg. 1's own eviction order).
            cands = [(point.rpr, pod_id, fn)
                     for fn, pods in self.placed.items()
                     for pod_id, point in pods.items()
                     if self.backend.node_of(pod_id) == worst]
            if not cands:
                break
            _, pod_id, fn = min(cands)
            spec = self.specs[fn]
            loads = self.backend.node_load()
            # Warm-aware targeting: among admitting nodes, prefer one that
            # already holds the function's weights (host-staged or device-
            # resident) so the move skips the cold upload.  getattr-guarded:
            # minimal test backends without the verb defrag as before.
            warm = set(getattr(self.backend, "warm_nodes",
                               lambda _fn: [])(fn))
            new_id = None
            for target in sorted((n for n in loads if n != worst),
                                 key=lambda n: (n not in warm,
                                                loads[n], n)):
                new_id = self.backend.migrate(spec, pod_id, target)
                if new_id is not None:
                    break
            if new_id is None:
                break  # nothing admits it (or the pod is mid-step): retry
            self.placed[fn][new_id] = self.placed[fn].pop(pod_id)
            self.queues[fn].rekey(pod_id, new_id)
            event = MigrationEvent(now=now, fn=fn, old_pod=pod_id,
                                   new_pod=new_id, source=worst,
                                   target=target,
                                   fragmentation=frag[worst])
            self.migrations.append(event)
            moved.append(event)
        return moved
