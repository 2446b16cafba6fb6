"""Cluster control plane + discrete-event simulator.

Faithfully executes the paper's full serving stack — FaST-Manager token
scheduling per node, MRA node selection, heuristic auto-scaling, model
sharing admission — over virtual time, so every benchmark figure can be
reproduced deterministically on this CPU-only container.  The *algorithms*
are the real implementations from this package (not re-derivations); only
step wall-times come from calibrated ``ServiceCurve``s (DESIGN.md §7).

Fault-tolerance features exercised here (large-scale runnability):

* **Node failure**: ``fail_node`` only records the damage — pods are marked
  dead, their rectangles dropped, and stranded requests re-queued to
  surviving replicas (or parked until one exists).  Re-placement is the
  reconciler's job: ``ControlPlane.reconcile`` prunes dead pods from its
  L_j capacity queues (the ``Backend.alive`` verb) and the resulting
  processing gap + below-floor healing re-converge the fleet.
* **Pod migration**: ``migrate`` moves one pod (queue + occupied decode
  slots) to a target node between token-gated steps — the simulator
  analogue of the live engine's KV migration, used by the reconciler's
  MRA defragmentation pass.
* **Straggler mitigation**: nodes carry a ``slowdown`` factor; the control
  loop compares per-pod service rates against the fleet median and re-places
  pods whose node is degraded beyond a threshold.
* **Elastic scaling**: the autoscale loop adds/removes pods from live
  predicted RPS using the paper's Alg. 1.
"""

from __future__ import annotations

import bisect
import dataclasses
import heapq
import itertools
import statistics
from collections import deque
from typing import Callable, Optional

from repro_torch.core.links import NetworkLinks
from repro_torch.core.manager import TokenScheduler
from repro_torch.core.maximal_rectangles import MaxRectsPool, Placement
from repro_torch.core.model_sharing import MemoryModel
from repro_torch.core.resources import Alloc
from repro_torch.core.scaling import (FunctionPodQueue, ProfilePoint, ScaleDecision,
                                heuristic_scale, processing_gap)
from repro_torch.core.slo import (TIER_BATCH, TIER_BEST_EFFORT, TIER_GUARANTEED,
                            RetryPolicy, SLORecorder, deadline_budget,
                            observed_rate, record_arrival)
from repro_torch.core.workload import Request, ServiceCurve


# --------------------------------------------------------------------------
# Event engine
# --------------------------------------------------------------------------


class Simulator:
    """Minimal deterministic discrete-event engine."""

    def __init__(self) -> None:
        self._heap: list[tuple[float, int, Callable[[], None]]] = []
        self._seq = itertools.count()
        self.now = 0.0

    def at(self, time: float, fn: Callable[[], None]) -> None:
        if time < self.now - 1e-12:
            raise ValueError(f"event in the past: {time} < {self.now}")
        heapq.heappush(self._heap, (time, next(self._seq), fn))

    def after(self, delay: float, fn: Callable[[], None]) -> None:
        self.at(self.now + delay, fn)

    def run(self, until: float) -> None:
        while self._heap and self._heap[0][0] <= until:
            time, _, fn = heapq.heappop(self._heap)
            self.now = time
            fn()
        self.now = max(self.now, until)


# --------------------------------------------------------------------------
# Pods and nodes
# --------------------------------------------------------------------------


@dataclasses.dataclass
class _DecodeSlot:
    """One occupied decode slot: a request and its remaining token rounds."""

    req: Request
    remaining: int


@dataclasses.dataclass
class PodRuntime:
    """A running function instance bound to a node.

    ``slots`` is the pod's decode-slot pool (slot-level batching, mirroring
    the live engine): each entry is a request part-way through its
    ``n_tokens`` decode rounds.  ``in_flight`` lists the requests being
    advanced by the step currently holding a token (empty between steps).
    """

    pod_id: str
    fn: str
    curve: ServiceCurve
    alloc: Alloc
    point: ProfilePoint
    placement: Placement
    max_batch: int = 1
    queue: deque = dataclasses.field(default_factory=deque)
    slots: list = dataclasses.field(default_factory=list)
    in_flight: list = dataclasses.field(default_factory=list)
    waiting_token: bool = False
    retired: bool = False
    steps: int = 0
    refills: int = 0  # mid-flight slot admissions (continuous only)
    # Virtual time the pod's weights finish uploading (cold-start tier):
    # no token is granted before it.  0 = instantly ready (legacy model).
    ready_at: float = 0.0
    # Tensor-parallel pod: one MRA rectangle per member device, index 0
    # being the primary (``placement`` / ``placement.node``).  Empty tuples
    # for single-device pods.  ``link_bps`` is the group's bottleneck link
    # bandwidth, fed into ``ServiceCurve.round_time``'s collective term.
    shards: int = 1
    member_nodes: tuple = ()
    member_placements: tuple = ()
    link_bps: float = 0.0
    # A member node died: the pod's KV shard is gone and the pod must fold
    # as soon as any in-flight step returns its token.
    dead: bool = False

    def pending(self) -> bool:
        """Work exists: queued requests or slots with rounds remaining."""
        return bool(self.queue) or any(s.remaining > 0 for s in self.slots)


class Node:
    """One accelerator node: token scheduler + memory accounting."""

    def __init__(self, node_id: int, mem_bytes: int, window: float = 1.0,
                 sharing: bool = True, slowdown: float = 1.0):
        self.node_id = node_id
        self.mem_bytes = mem_bytes
        self.scheduler = TokenScheduler(window=window)
        self.sharing = sharing
        self.slowdown = slowdown
        self.alive = True
        # Gray-failure state: a quarantined node stops receiving new routes
        # and placements but keeps draining its occupants (unlike death).
        self.quarantined = False
        # EWMA of observed/nominal round-duration ratio (1.0 = nominal);
        # ``Cluster.health`` inverts it into a 0..1 health score.
        self.lat_ewma = 1.0
        self.pods: dict[str, PodRuntime] = {}
        # function -> instance count, for the shared-memory footprint model
        self._fn_instances: dict[str, int] = {}
        self._fn_memmodel: dict[str, MemoryModel] = {}
        # Functions whose weights are staged in this node's host RAM — the
        # simulator's model of the fleet store's warm tier.  Populated by
        # deploys that model a cold start (``cold_start_s > 0``); cleared
        # when the node dies (host RAM dies with it).
        self.warm_fns: set[str] = set()

    def mem_used(self) -> int:
        return sum(
            self._fn_memmodel[fn].footprint(n, self.sharing)
            for fn, n in self._fn_instances.items() if n > 0
        )

    def admits(self, fn: str, mm: MemoryModel) -> bool:
        n = self._fn_instances.get(fn, 0)
        projected = self.mem_used() - mm.footprint(n, self.sharing) \
            + mm.footprint(n + 1, self.sharing)
        return projected <= self.mem_bytes

    def add_pod(self, pod: PodRuntime, mm: MemoryModel) -> None:
        self.pods[pod.pod_id] = pod
        self._fn_memmodel[pod.fn] = mm
        self._fn_instances[pod.fn] = self._fn_instances.get(pod.fn, 0) + 1
        # DCGM-style occupancy: a pod drains at most its model's saturation
        # share, however large its allocation (Fig. 1b's racing pods).
        self.scheduler.register(
            pod.pod_id, pod.alloc,
            occupied_sm=min(pod.alloc.sm, pod.curve.sm_sat))

    def remove_pod(self, pod_id: str) -> PodRuntime:
        pod = self.pods.pop(pod_id)
        self._fn_instances[pod.fn] -= 1
        self.scheduler.deregister(pod_id)
        return pod

    def add_member(self, fn: str, mm: MemoryModel) -> None:
        """Charge a sharded pod's secondary member shard to this node's
        memory model.  No scheduler registration: the pod's decode rounds
        are token-gated on its primary node only (all members advance in
        lockstep, so one token stream models the whole group)."""
        self._fn_memmodel[fn] = mm
        self._fn_instances[fn] = self._fn_instances.get(fn, 0) + 1

    def remove_member(self, fn: str) -> None:
        self._fn_instances[fn] -= 1


# --------------------------------------------------------------------------
# Cluster
# --------------------------------------------------------------------------


class Cluster:
    """FaST-GShare control plane over a simulated node fleet."""

    def __init__(
        self,
        n_nodes: int,
        mem_bytes: int = 16 * 1024**3,
        window: float = 1.0,
        sharing: bool = True,
        allow_grow: bool = False,
        max_batch: int = 1,
        scheduler_period: float = 0.05,
        continuous: bool = False,
        batch_alpha: Optional[float] = None,
        links: Optional[NetworkLinks] = None,
        retry: Optional[RetryPolicy] = None,
    ):
        """``continuous=True`` enables slot-level batching: finished
        requests free their decode slot immediately and queued requests are
        admitted mid-flight, matching the live engine's continuous mode.
        ``continuous=False`` keeps static batches that retire together.
        ``batch_alpha`` overrides the weight-bound (batch-shared) fraction
        of a decode round for EVERY function; the default (None) uses each
        curve's own ``alpha`` — 0.5 unless roofline-calibrated via
        ``workload.calibrate_round_alpha``.  ``links`` is the inter-node
        bandwidth graph used by sharded (multi-rectangle) deploys; the
        default is a uniform topology.  ``retry`` (a
        ``repro_torch.core.slo.RetryPolicy``) turns failure re-routing into
        bounded jittered-backoff retries from the policy's own seeded
        PRNG; the default (None) keeps the legacy immediate re-route."""
        self.sim = Simulator()
        self.links = links if links is not None else NetworkLinks(n_nodes)
        self.window = window
        self.max_batch = max_batch
        self.continuous = continuous
        self.batch_alpha = batch_alpha
        self.nodes = [Node(i, mem_bytes, window, sharing) for i in range(n_nodes)]
        self.pool = MaxRectsPool(n_nodes, allow_grow=allow_grow)
        self.pods: dict[str, PodRuntime] = {}
        self.fn_pods: dict[str, list[str]] = {}
        self.fn_curves: dict[str, ServiceCurve] = {}
        self.fn_queues: dict[str, FunctionPodQueue] = {}
        self.recorders: dict[str, SLORecorder] = {}
        self._rr: dict[str, int] = {}
        self._pod_seq = itertools.count()
        self._arrival_log: dict[str, list[float]] = {}
        self._rps_horizon: dict[str, float] = {}
        # Requests for a registered function that momentarily has zero live
        # pods (e.g. every replica died with the node): parked here and
        # re-routed as soon as a replacement pod deploys.
        self._pending: dict[str, deque] = {}
        self.dropped = 0
        self.rescheduled = 0
        self.migrated = 0
        # SLO lifecycle (all zero unless deadlines/retries are configured):
        self.retry = retry
        self.shed = 0      # rejected at admission: could not make deadline
        self.expired = 0   # deadline passed while queued
        self.lost = 0      # retry budget exhausted after failures
        self.fn_tiers: dict[str, str] = {}
        self.fn_deadlines: dict[str, Optional[float]] = {}
        # Cold-start tier telemetry: one entry per delayed deploy —
        # {pod, fn, node, tier, delay}.
        self.cold_events: list[dict] = []
        # Periodic scheduler pump so window rolls release blocked pods.
        for node in self.nodes:
            self._tick(node, scheduler_period)

    # -- deployment -------------------------------------------------------

    def register_function(self, fn: str, curve: ServiceCurve,
                          slo_latency: Optional[float] = None,
                          slo_tier: str = TIER_BEST_EFFORT,
                          deadline_s: Optional[float] = None) -> None:
        self.fn_curves[fn] = curve
        self.fn_queues.setdefault(fn, FunctionPodQueue())
        self.recorders[fn] = SLORecorder(fn=fn, slo_latency=slo_latency)
        self.fn_pods.setdefault(fn, [])
        self.fn_tiers[fn] = slo_tier
        # None (best-effort, no deadline) keeps the whole deadline/shedding
        # machinery dormant for this function.
        self.fn_deadlines[fn] = deadline_budget(slo_tier, deadline_s,
                                                slo_latency)

    def memory_model(self, fn: str) -> MemoryModel:
        c = self.fn_curves[fn]
        return MemoryModel(weight_bytes=c.weight_bytes,
                           framework_bytes=c.framework_bytes)

    def deploy(self, fn: str, point: ProfilePoint,
               elastic_limit: float | None = None,
               track: bool = True,
               cold_start_s: float = 0.0,
               shards: int = 1) -> Optional[str]:
        """Place one pod of ``fn`` at profile point ``point`` via MRA.

        ``track=False`` skips the L_j capacity-queue push — used by
        ``autoscale``, which manages L_j itself (Alg. 1 already pushed a
        provisional entry).

        ``cold_start_s`` models the weight-upload tier: node selection
        prefers warm nodes (whose host RAM already stages the function's
        weights), and the pod's first token grant is delayed by the full
        ``cold_start_s`` on a cold node, half of it on a peer-warm
        placement (host-to-host copy + upload), and nothing on a warm
        node.  The delay never enters scale decisions — ``decision_
        signature`` replay is unaffected by whether a fleet modeled it.

        ``shards`` (or a sharded ``point.shards`` — the larger wins) makes
        this a tensor-parallel pod spanning that many nodes: one rectangle
        per member, acquired atomically on the best-linked group.
        """
        alloc = point.to_alloc(elastic_limit)
        pod_id = f"{fn}-{next(self._pod_seq)}"
        mm = self.memory_model(fn)
        shards = max(shards, point.shards)
        if shards > 1:
            return self._deploy_sharded(fn, point, alloc, pod_id, mm,
                                        shards, cold_start_s, track)
        warm_ids = ({n.node_id for n in self.nodes
                     if n.alive and fn in n.warm_fns}
                    if cold_start_s > 0 else set())
        all_ids = {n.node_id for n in self.pool.nodes}
        phases: list[set[int]] = []
        if warm_ids and warm_ids != all_ids:
            phases.append(all_ids - warm_ids)  # warm-first pass
        phases.append(set())
        placement = None
        for base_exclude in phases:
            excluded = set(base_exclude)
            while True:
                placement = self.pool.schedule(alloc, pod_id,
                                               exclude=excluded)
                if placement is None:
                    break
                if placement.node >= len(self.nodes):  # grew (allow_grow)
                    self.nodes.append(Node(placement.node,
                                           self.nodes[0].mem_bytes,
                                           self.window,
                                           self.nodes[0].sharing))
                    self.links.grow(len(self.nodes))
                    self._tick(self.nodes[-1], 0.05)
                node = self.nodes[placement.node]
                if node.alive and node.admits(fn, mm):
                    break
                # Rectangle fit but node infeasible (dead / memory): retry
                # the remaining nodes.
                self.pool.release(placement)
                excluded.add(placement.node)
            if placement is not None:
                break
        if placement is None:
            return None
        node = self.nodes[placement.node]
        pod = PodRuntime(pod_id=pod_id, fn=fn, curve=self.fn_curves[fn],
                         alloc=alloc, point=point, placement=placement,
                         max_batch=self.max_batch)
        if cold_start_s > 0:
            if placement.node in warm_ids:
                tier, delay = "host", 0.0
            elif warm_ids:
                tier, delay = "peer", 0.5 * cold_start_s
            else:
                tier, delay = "cold", cold_start_s
            pod.ready_at = self.sim.now + delay
            node.warm_fns.add(fn)  # staged by this placement's upload
            self.cold_events.append({"pod": pod_id, "fn": fn,
                                     "node": placement.node, "tier": tier,
                                     "delay": delay})
            if delay > 0:
                # Wake the pod once its weights land (idempotent: the
                # ready gate in _want_token refuses earlier grants).
                self.sim.at(pod.ready_at, lambda: self._want_token(pod))
        node.add_pod(pod, mm)
        self.pods[pod_id] = pod
        self.fn_pods[fn].append(pod_id)
        if track:
            self.fn_queues[fn].push(pod_id, point)
        # Requests parked while the function had zero live pods.
        pending = self._pending.pop(fn, None)
        if pending:
            for r in pending:
                self._route(r)
        return pod_id

    def _deploy_sharded(self, fn: str, point: ProfilePoint, alloc: Alloc,
                        pod_id: str, mm: MemoryModel, shards: int,
                        cold_start_s: float, track: bool) -> Optional[str]:
        """Multi-rectangle deploy: one (S, Q) rectangle per member node.

        Walks candidate groups best collective link first (Helix-style:
        the pod's per-round all-gather rides the group's bottleneck link)
        and takes the first group where every member yields a rectangle
        AND admits the memory footprint — acquired rectangles are rolled
        back whole-group on any member failure, so a half-placed pod never
        leaks.  Link bandwidth outranks the warm tier here: re-uploading
        weights is a one-off, a slow collective is paid every round.
        """
        candidates = [n.node_id for n in self.nodes if n.alive]
        all_ids = {n.node_id for n in self.pool.nodes}
        for group in self.links.best_groups(candidates, shards):
            rects: list[Placement] = []
            for member in group:
                rect = self.pool.schedule(alloc, f"{pod_id}@{member}",
                                          exclude=all_ids - {member})
                if rect is not None and not self.nodes[member].admits(fn, mm):
                    self.pool.release(rect)
                    rect = None
                if rect is None:
                    for r in rects:
                        self.pool.release(r)
                    rects = []
                    break
                rects.append(rect)
            if not rects:
                continue
            primary = group[0]
            node = self.nodes[primary]
            pod = PodRuntime(pod_id=pod_id, fn=fn, curve=self.fn_curves[fn],
                             alloc=alloc, point=point, placement=rects[0],
                             max_batch=self.max_batch, shards=shards,
                             member_nodes=tuple(group),
                             member_placements=tuple(rects),
                             link_bps=self.links.bottleneck(group))
            if cold_start_s > 0:
                warm = {n.node_id for n in self.nodes
                        if n.alive and fn in n.warm_fns}
                if primary in warm:
                    tier, delay = "host", 0.0
                elif warm:
                    tier, delay = "peer", 0.5 * cold_start_s
                else:
                    tier, delay = "cold", cold_start_s
                pod.ready_at = self.sim.now + delay
                for m in group:
                    self.nodes[m].warm_fns.add(fn)
                self.cold_events.append({"pod": pod_id, "fn": fn,
                                         "node": primary, "tier": tier,
                                         "delay": delay})
                if delay > 0:
                    self.sim.at(pod.ready_at,
                                lambda: self._want_token(pod))
            node.add_pod(pod, mm)
            for m in group[1:]:
                self.nodes[m].add_member(fn, mm)
            self.pods[pod_id] = pod
            self.fn_pods[fn].append(pod_id)
            if track:
                self.fn_queues[fn].push(pod_id, point)
            pending = self._pending.pop(fn, None)
            if pending:
                for r in pending:
                    self._route(r)
            return pod_id
        return None

    def retire(self, pod_id: str, drain: bool = True) -> None:
        """Scale-down: stop routing to the pod; release resources when idle."""
        pod = self.pods[pod_id]
        pod.retired = True
        self.fn_pods[pod.fn].remove(pod_id)
        self.fn_queues[pod.fn].remove(pod_id)
        if not drain or (not pod.pending() and not pod.in_flight
                         and not pod.waiting_token):
            self._teardown(pod)

    def _teardown(self, pod: PodRuntime) -> None:
        node = self.nodes[pod.placement.node]
        if pod.pod_id in node.pods and not pod.waiting_token \
                and node.scheduler.pods[pod.pod_id].holding is None:
            node.remove_pod(pod.pod_id)
            self.pool.release(pod.placement)
            for m, rect in zip(pod.member_nodes[1:],
                               pod.member_placements[1:]):
                if self.nodes[m].alive:
                    self.nodes[m].remove_member(pod.fn)
                    self.pool.release(rect)
            self.pods.pop(pod.pod_id, None)

    # -- request path -------------------------------------------------------

    def submit(self, req: Request) -> None:
        self.sim.at(req.arrival, lambda: self._arrive(req))

    def submit_all(self, reqs: list[Request]) -> None:
        for r in reqs:
            self.submit(r)

    def _arrive(self, req: Request) -> None:
        record_arrival(self._arrival_log, self._rps_horizon, req.fn,
                       self.sim.now)
        # Stamp the function's deadline/tier onto the request at admission
        # (inert when the function has no deadline budget — the default).
        budget = self.fn_deadlines.get(req.fn)
        tier = self.fn_tiers.get(req.fn, TIER_BEST_EFFORT)
        if budget is not None and req.deadline is None:
            req = dataclasses.replace(req, deadline=self.sim.now + budget,
                                      tier=tier)
        elif tier != req.tier:
            req = dataclasses.replace(req, tier=tier)
        self._route(req, admission=True)

    def _route(self, req: Request, admission: bool = False) -> None:
        """Route without logging an arrival (re-injection after failures
        must not inflate the observed-RPS signal)."""
        pods = [p for p in self.fn_pods.get(req.fn, ())
                if not self.pods[p].retired
                and not self.nodes[self.pods[p].placement.node].quarantined]
        if not pods:
            if req.fn in self.fn_curves:
                # Registered but momentarily podless (a failure killed the
                # last replica): park until the reconciler heals the fleet.
                self._pending.setdefault(req.fn, deque()).append(req)
            else:
                self.dropped += 1
            return
        # Join-shortest-queue routing across the function's replicas
        # (queue depth + occupied decode slots).
        pod = min((self.pods[p] for p in pods),
                  key=lambda p: len(p.queue) + len(p.slots))
        # Deadline shedding ("reject fast"): at admission only, estimate
        # completion from queue depth x the profile point's service rate
        # and shed a non-guaranteed request that cannot make its deadline.
        if (admission and req.deadline is not None
                and req.tier != TIER_GUARANTEED):
            load = len(pod.queue) + len(pod.slots)
            est = (load + 1) / max(pod.point.throughput, 1e-9)
            if self.sim.now + est > req.deadline + 1e-12:
                self.shed += 1
                self.recorders[req.fn].record_shed()
                return
        self._enqueue_pod(pod, req)
        self._want_token(pod)

    def _enqueue_pod(self, pod: PodRuntime, req: Request) -> None:
        """Queue with the batch lane preempted: a non-batch request inserts
        ahead of parked batch-tier work; uniform tiers reduce to a plain
        FIFO append (the bit-identical legacy order)."""
        if req.tier != TIER_BATCH:
            idx = next((i for i, r in enumerate(pod.queue)
                        if r.tier == TIER_BATCH), None)
            if idx is not None:
                pod.queue.insert(idx, req)
                return
        pod.queue.append(req)

    def _want_token(self, pod: PodRuntime) -> None:
        node = self.nodes[pod.placement.node]
        if not node.alive or pod.waiting_token or not pod.pending():
            return
        if self.sim.now < pod.ready_at - 1e-12:
            # Weights still uploading (cold-start tier): the wake event
            # scheduled at deploy re-arms the pod at ready_at.
            return
        if node.scheduler.pods[pod.pod_id].holding is not None:
            return
        pod.waiting_token = True
        node.scheduler.request_token(pod.pod_id, self.sim.now)
        self._pump(node)

    def _pump(self, node: Node) -> None:
        if not node.alive:
            return
        for token in node.scheduler.dispatch(self.sim.now):
            pod = node.pods[token.pod_id]
            pod.waiting_token = False
            self._start_step(node, pod)

    def _start_step(self, node: Node, pod: PodRuntime) -> None:
        """One token-gated step: slot admission + one decode round.

        Admission — continuous mode tops up free slots every step; static
        mode only forms a new batch once the previous one has fully
        retired.  The round then advances every live (unfinished) slot by
        one token; its wall time comes from the calibrated service curve at
        the *live* slot count, and its drained SM occupancy is scaled by
        slot fill — an underfilled round cannot saturate the partition.
        """
        if self.continuous or not pod.slots:
            # A refill = joining a batch that was already decoding before
            # this step; cold-start co-admissions in the same pass aren't.
            had_live = bool(pod.slots)
            while pod.queue and len(pod.slots) < pod.max_batch:
                r = pod.queue.popleft()
                # Mid-queue expiry: a non-guaranteed request whose deadline
                # already passed is dropped with a typed outcome instead of
                # wasting a decode slot on a response nobody can use.
                if (r.deadline is not None and r.tier != TIER_GUARANTEED
                        and self.sim.now > r.deadline + 1e-12):
                    self.expired += 1
                    self.recorders[r.fn].record_expired()
                    continue
                if had_live and self.continuous:
                    pod.refills += 1
                pod.slots.append(_DecodeSlot(r, max(1, r.n_tokens)))
        live = [s for s in pod.slots if s.remaining > 0]
        if not live:
            # Token granted but work drained (e.g. rebalanced away).
            node.scheduler.complete(pod.pod_id, 0.0, self.sim.now)
            return
        pod.in_flight = [s.req for s in live]
        dur = (pod.curve.round_time(pod.alloc.sm, len(live),
                                    alpha=self.batch_alpha,
                                    shards=pod.shards,
                                    link_bps=pod.link_bps)
               * node.slowdown)
        occ = (min(pod.alloc.sm, pod.curve.sm_sat)
               * len(live) / max(pod.max_batch, 1))
        pod.steps += 1
        self.sim.after(dur,
                       lambda: self._finish_step(node, pod, live, dur, occ))

    def _finish_step(self, node: Node, pod: PodRuntime,
                     live: list[_DecodeSlot], dur: float, occ: float) -> None:
        if not node.alive:
            return  # failure handler already re-queued them
        if pod.dead:
            # A member node died mid-step: the round's result is void (its
            # KV shard went with the node, the strays were already
            # re-queued).  Return the token, then fold the pod.
            pod.in_flight = []
            node.scheduler.complete(pod.pod_id, dur, self.sim.now, occ=occ)
            self._teardown(pod)
            self._pump(node)
            return
        pod.in_flight = []
        completed: list[Request] = []
        for s in live:
            s.remaining -= 1
            if s.remaining <= 0:
                completed.append(s.req)
        if self.continuous:
            # Continuous: finished requests free their slot immediately.
            pod.slots = [s for s in pod.slots if s.remaining > 0]
        elif all(s.remaining <= 0 for s in pod.slots):
            # Static: the batch retires together once ALL members finish.
            pod.slots = []
        rec = self.recorders[pod.fn]
        for r in completed:
            met = (None if r.deadline is None
                   else self.sim.now <= r.deadline + 1e-12)
            rec.record(self.sim.now - r.arrival, self.sim.now,
                       deadline_met=met)
        # Gray-failure signal: EWMA of the observed/nominal duration ratio
        # (the straggler multiplier is exactly that ratio here).
        nominal = dur / max(node.slowdown, 1e-9)
        ratio = dur / max(nominal, 1e-12)
        node.lat_ewma = 0.7 * node.lat_ewma + 0.3 * ratio
        node.scheduler.complete(pod.pod_id, dur, self.sim.now, occ=occ)
        if pod.retired and not pod.pending():
            self._teardown(pod)
        else:
            self._want_token(pod)
        self._pump(node)

    def _tick(self, node: Node, period: float) -> None:
        def tick() -> None:
            if node.alive:
                self._pump(node)
                # Re-arm any pod that has work but lost its request across a
                # window roll.
                for pod in list(node.pods.values()):
                    if (pod.pending() and not pod.waiting_token
                            and not pod.in_flight):
                        self._want_token(pod)
            self.sim.after(period, tick)

        self.sim.after(period, tick)

    # -- autoscaling (paper Alg. 1 in the loop) ------------------------------

    def autoscale(self, predicted: dict[str, float],
                  profiles: dict[str, list[ProfilePoint]],
                  slo_latency: dict[str, float] | None = None,
                  headroom: float = 1.2,
                  elastic_limit: float | None = 1.0) -> list[ScaleDecision]:
        """Paper Alg. 1 in the loop.

        ``headroom`` over-provisions capacity relative to predicted load
        (target utilization 1/headroom) so queueing delay stays bounded —
        provisioning at exactly rho=1 would violate any latency SLO.
        ``elastic_limit`` sets Q_limit above Q_request for scaled-up pods
        (§3.3.2: "enable pods to utilize more GPU resources when the GPU is
        idle") — Poisson bursts are absorbed instead of blocking until the
        next window.
        """
        inflated = {fn: rps * headroom for fn, rps in predicted.items()}
        gaps = processing_gap(inflated, self.fn_queues)
        decisions = heuristic_scale(gaps, profiles, self.fn_queues, slo_latency)
        applied: list[ScaleDecision] = []
        for d in decisions:
            if d.direction > 0:
                # Alg. 1 reserved capacity under a provisional id; settle the
                # reservation against the deployer's outcome so L_j capacity
                # never drifts above what is actually running.
                queue = self.fn_queues[d.function]
                real = self.deploy(d.function, d.point,
                                   elastic_limit=elastic_limit, track=False)
                if real is None:
                    queue.abort(d.pod_id)
                    continue
                queue.confirm(d.pod_id, real)
                applied.append(d)
            else:
                assert d.pod_id is not None
                if d.pod_id in self.pods:
                    self.retire(d.pod_id)
                applied.append(d)
        return applied

    # -- fault tolerance -------------------------------------------------------

    def fail_node(self, node_id: int) -> int:
        """Kill a node: mark its pods dead, re-queue stranded requests.

        Deliberately NOT self-healing: the failure only records the damage
        (dead pods leave ``pods``/``fn_pods``/the tracked L_j queues, the
        node's rectangles are dropped, unfinished requests re-route to
        surviving replicas or park in the pending buffer).  Re-placement
        is owned by the reconciler — ``ControlPlane.reconcile`` prunes the
        dead pods via ``Backend.alive`` and the processing gap + below-
        floor healing bring the fleet back, identically on the live path.
        Returns the number of pods lost.
        """
        node = self.nodes[node_id]
        node.alive = False
        node.warm_fns.clear()  # host RAM (staged weights) dies with it
        self.pool.drain_node(node_id)
        displaced: list[PodRuntime] = list(node.pods.values())
        strays: list[Request] = []
        for pod in displaced:
            # Only unfinished slot occupants: static mode keeps completed
            # (already-recorded) requests in their slots until the batch
            # retires, and those must not be served twice.
            strays.extend(s.req for s in pod.slots if s.remaining > 0)
            strays.extend(pod.queue)
            pod.slots, pod.in_flight, pod.queue = [], [], deque()
            if pod.fn in self.fn_pods and pod.pod_id in self.fn_pods[pod.fn]:
                self.fn_pods[pod.fn].remove(pod.pod_id)
            self.fn_queues[pod.fn].remove(pod.pod_id)
            # Sharded primary: member rectangles on surviving nodes free up.
            for m, rect in zip(pod.member_nodes[1:],
                               pod.member_placements[1:]):
                if m != node_id and self.nodes[m].alive:
                    self.nodes[m].remove_member(pod.fn)
                    self.pool.release(rect)
            del self.pods[pod.pod_id]
        node.pods.clear()
        # Sharded pods anchored elsewhere that had a member shard here die
        # too: the shard's rectangle (and its slice of every KV cache) went
        # with the node, so the whole pod folds.
        for pod in [p for p in self.pods.values()
                    if node_id in p.member_nodes
                    and p.placement.node != node_id]:
            strays.extend(s.req for s in pod.slots if s.remaining > 0)
            strays.extend(pod.queue)
            pod.slots, pod.in_flight, pod.queue = [], [], deque()
            self.fn_pods[pod.fn].remove(pod.pod_id)
            self.fn_queues[pod.fn].remove(pod.pod_id)
            pod.retired = True
            pod.dead = True
            displaced.append(pod)
            primary = self.nodes[pod.placement.node]
            if primary.scheduler.pods[pod.pod_id].holding is None:
                # Between steps: tear down now (the token request, if any,
                # dies with the scheduler deregistration, as in migrate).
                pod.waiting_token = False
                self._teardown(pod)
            # else: _finish_step's dead-pod guard returns the token and
            # tears down when the in-flight round lands.
            self.pods.pop(pod.pod_id, None)
        self.rescheduled += len(displaced)
        # Re-inject stranded requests at the current time (no arrival log:
        # they were already counted when they first arrived).
        for r in strays:
            self._reinject(r)
        return len(displaced)

    def _reinject(self, req: Request) -> None:
        """Re-route a stranded request — immediately (legacy, no policy) or
        through the bounded jittered-backoff retry policy."""
        if self.retry is None:
            self._route(dataclasses.replace(req, arrival=req.arrival))
            return
        attempt = req.attempts + 1
        if (req.tier != TIER_GUARANTEED
                and self.retry.exhausted(req.attempts)):
            # Best-effort/batch: retry budget spent — typed loss, not an
            # eternal park.  Guaranteed requests retry without bound.
            self.lost += 1
            if req.fn in self.recorders:
                self.recorders[req.fn].record_lost()
            return
        retry_req = dataclasses.replace(req, attempts=attempt)
        self.sim.after(self.retry.delay(attempt),
                       lambda: self._route(retry_req))

    def alive(self, pod_id: str) -> bool:
        """Whether a pod still exists on a live, non-quarantined node (dead
        pods are removed from ``pods`` by ``fail_node``, drained ones by
        ``_teardown``; a quarantined node's pods read as not-alive so the
        reconciler prunes and heals them exactly like a crash)."""
        pod = self.pods.get(pod_id)
        if pod is None:
            return False
        nodes = set(pod.member_nodes) or {pod.placement.node}
        return not any(self.nodes[n].quarantined for n in nodes)

    def health(self, node_id: int) -> float:
        """Node health score in (0, 1]: 1.0 nominal, lower = slower.  The
        inverse of the node's observed/nominal round-duration EWMA."""
        node = self.nodes[node_id]
        if not node.alive:
            return 0.0
        return 1.0 / max(node.lat_ewma, 1.0)

    def quarantine(self, node_id: int) -> int:
        """Gray-failure quarantine: stop routing and placement to the node,
        let occupants drain.  One-way, like death — but the node keeps
        serving what it already holds.  The reconciler heals the capacity
        through the ordinary ``alive`` prune + processing gap.  Returns the
        number of pods the quarantine took out of rotation."""
        node = self.nodes[node_id]
        if node.quarantined or not node.alive:
            return 0
        node.quarantined = True
        self.pool.cordon(node_id)
        return sum(1 for p in self.pods.values()
                   if node_id in (set(p.member_nodes)
                                  or {p.placement.node}))

    def node_of(self, pod_id: str) -> Optional[int]:
        pod = self.pods.get(pod_id)
        return None if pod is None else pod.placement.node

    def fragmentation(self) -> dict[int, float]:
        """Per-node MRA fragmentation over schedulable (alive) nodes."""
        return self.pool.fragmentation()

    def node_load(self) -> dict[int, float]:
        """Per-node allocated-area fraction over schedulable nodes."""
        return self.pool.node_load()

    def warm_nodes(self, fn: str) -> list[int]:
        """Alive nodes whose host RAM stages ``fn``'s weights (the
        simulator's fleet-store warm tier; empty unless deploys modeled a
        ``cold_start_s``)."""
        return sorted(n.node_id for n in self.nodes
                      if n.alive and fn in n.warm_fns)

    def migrate(self, pod_id: str, target: int) -> Optional[str]:
        """Move one pod to ``target``: the simulator's KV migration.

        The pod must be between token-gated steps (its per-slot decode
        state is then plain host bookkeeping); its queue and occupied
        decode slots transfer wholesale, and the source rectangle is only
        released after the replacement pod is live (copy-then-delete, so
        an admission failure on the target leaves the pod untouched).
        Returns the new pod id, or None when the pod is mid-step, retired,
        or the target cannot host it.
        """
        pod = self.pods.get(pod_id)
        if pod is None or pod.retired:
            return None
        if pod.shards > 1:
            # A sharded pod's KV lives as one shard per member; moving it
            # means re-acquiring a whole device group — re-place instead
            # (the live path refuses identically).
            return None
        src = pod.placement.node
        if target == src or not 0 <= target < len(self.nodes):
            return None
        src_node = self.nodes[src]
        if pod.in_flight or src_node.scheduler.pods[pod_id].holding is not None:
            return None  # mid-step: its KV is "on device"; retry next tick
        tnode = self.nodes[target]
        mm = self.memory_model(pod.fn)
        if not tnode.alive or not tnode.admits(pod.fn, mm):
            return None
        new_id = f"{pod.fn}-{next(self._pod_seq)}"
        exclude = {n.node_id for n in self.pool.nodes} - {target}
        placement = self.pool.schedule(pod.alloc, new_id, exclude=exclude)
        if placement is None:
            return None
        if placement.node != target:  # pool grew instead of using target
            self.pool.release(placement)
            return None
        new_pod = PodRuntime(pod_id=new_id, fn=pod.fn, curve=pod.curve,
                             alloc=pod.alloc, point=pod.point,
                             placement=placement, max_batch=pod.max_batch,
                             steps=pod.steps, refills=pod.refills)
        if pod.fn in src_node.warm_fns:
            # The move stages the weights on the target; the source's host
            # copy stays cached (both nodes are warm afterwards).
            tnode.warm_fns.add(pod.fn)
        # Pause -> move: between steps the queue and slot state are host
        # data; the live path's gather/merge per slot collapses to this.
        new_pod.queue, pod.queue = pod.queue, deque()
        new_pod.slots, pod.slots = pod.slots, []
        pod.waiting_token = False  # the token request dies with deregister
        tnode.add_pod(new_pod, mm)
        self.pods[new_id] = new_pod
        self.fn_pods[pod.fn].append(new_id)
        # Source teardown only after the replacement is live.
        self.fn_pods[pod.fn].remove(pod_id)
        if pod_id in self.fn_queues[pod.fn]:
            self.fn_queues[pod.fn].rekey(pod_id, new_id)
        src_node.remove_pod(pod_id)
        self.pool.release(pod.placement)
        del self.pods[pod_id]
        self.migrated += 1
        self._want_token(new_pod)
        return new_id

    def detect_stragglers(self, threshold: float = 2.0) -> list[int]:
        """Nodes whose effective service rate lags the fleet median."""
        rates = {n.node_id: 1.0 / n.slowdown for n in self.nodes if n.alive}
        if len(rates) < 2:
            return []
        med = statistics.median(rates.values())
        return [nid for nid, r in rates.items() if med / max(r, 1e-9) > threshold]

    def mitigate_stragglers(self, threshold: float = 2.0) -> int:
        """Re-place pods off straggler nodes (paper-adjacent; DESIGN.md §5)."""
        moved = 0
        for nid in self.detect_stragglers(threshold):
            node = self.nodes[nid]
            self.pool.cordon(nid)  # stop MRA from re-choosing the straggler
            for pod in list(node.pods.values()):
                if pod.retired or pod.shards > 1:
                    continue  # sharded pods re-place via the reconciler
                if pod.in_flight or pod.slots or pod.waiting_token:
                    continue  # move only idle pods; busy ones drain first
                node.remove_pod(pod.pod_id)
                self.pool.release(pod.placement)
                self.fn_pods[pod.fn].remove(pod.pod_id)
                self.fn_queues[pod.fn].remove(pod.pod_id)
                strays = list(pod.queue)
                del self.pods[pod.pod_id]
                if self.deploy(pod.fn, pod.point) is not None:
                    moved += 1
                for r in strays:
                    self._route(r)
        return moved

    # -- metrics ---------------------------------------------------------------

    def run(self, until: float) -> None:
        self.sim.run(until)

    def observed_rps(self, fn: str, window: float) -> float:
        """Arrival rate over the trailing ``window`` of virtual time — the
        simulator's analogue of gateway-side RPS observation."""
        return observed_rate(self._arrival_log, self._rps_horizon,
                             fn, window, self.sim.now)

    def inflight(self, fn: str) -> int:
        """Queued + live slot-occupying requests across the function's
        pods, draining (retired) ones included — matching the live
        frontend's count.  Finished members lingering in a static batch
        don't count."""
        return sum(len(pod.queue)
                   + sum(1 for s in pod.slots if s.remaining > 0)
                   for pod in self.pods.values() if pod.fn == fn)

    def gpu_utilization(self, last_n: int = 10) -> float:
        live = [n for n in self.nodes if n.alive and n.pods]
        if not live:
            return 0.0
        return sum(n.scheduler.utilization(last_n) for n in live) / len(live)

    def sm_occupancy(self, last_n: int = 10) -> float:
        live = [n for n in self.nodes if n.alive and n.pods]
        if not live:
            return 0.0
        return sum(n.scheduler.occupancy(last_n) for n in live) / len(live)

    def nodes_in_use(self) -> int:
        return sum(1 for n in self.nodes if n.alive and n.pods)
