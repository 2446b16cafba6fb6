"""Backend protocol: the thin seam between the reconciler and a fleet.

The ``ControlPlane`` never touches nodes, rectangles, or engines directly —
it sees a fleet through a small verb set:

* ``place(spec, point)``   — deploy one instance at a profile point (MRA +
  memory admission with spillover happen inside); returns the concrete pod
  id, or None when no node can host it.
* ``evict(spec, pod_id)``  — gracefully retire an instance: stop routing,
  drain its in-flight decode slots, then release its rectangle and weight
  refcount.
* ``alive(pod_id)``        — whether a placed pod still exists on a live
  node; the reconciler prunes dead pods from L_j/``placed`` with this, so
  node failures heal through the ordinary processing gap.
* ``node_of(pod_id)``      — which node hosts a pod (defrag victim
  selection).
* ``fragmentation()``      — per-node MRA fragmentation telemetry over
  schedulable nodes.
* ``node_load()``          — per-node allocated-area fraction (defrag
  target selection).
* ``migrate(spec, pod_id, target)`` — move one running pod to a target
  node with its queue and occupied decode slots intact (a real KV move on
  the live path); returns the new pod id or None when it cannot move.
* ``observed_rps(fn, w)``  — trailing-window arrival rate (used when the
  spec declares no target-RPS source, and to feed predictive
  ``DemandSource``s).
* ``inflight(fn)``         — queued + slot-occupying requests (reported in
  reconcile telemetry).
* ``warm_nodes(fn)``       — nodes holding warm weights for ``fn`` (the
  cold-start tier; scale-up and defrag prefer them, empty when the tier
  is off).
* ``links()``              — the fleet's inter-node bandwidth table
  (every (a < b) pair, symmetric bytes/s): the link model behind sharded
  multi-rectangle placement and bandwidth-aware peer weight transfers.
* ``health(node)``         — gray-failure score in [0, 1]: 1.0 nominal,
  ~1/N for a node running N times slower than its own baseline, 0.0 dead.
* ``quarantine(node)``     — take a degraded-but-alive node out of
  routing and placement; occupants drain, the reconciler heals the lost
  capacity through the ordinary ``alive`` prune.  Returns the number of
  instances taken out of rotation.  Quarantine is a health action, never
  a scheduling decision: it is logged outside ``decision_signature``.

Two implementations ship: ``SimBackend`` over the discrete-event
``repro_torch.core.cluster.Cluster`` and ``LiveBackend`` over the real torch
``repro_torch.serving.frontend.ClusterFrontend``.  Both are deliberately thin —
every scheduling decision lives in the shared ``ControlPlane``, which is
what lets a live fleet be replayed through the simulator decision-for-
decision, node failures included.
"""

from __future__ import annotations

from typing import Any, Optional, Protocol, runtime_checkable

from repro_torch.control.spec import FunctionSpec
from repro_torch.core.scaling import ProfilePoint


@runtime_checkable
class Backend(Protocol):
    """What a fleet must expose to be reconciled."""

    def register(self, spec: FunctionSpec) -> None: ...

    def place(self, spec: FunctionSpec,
              point: ProfilePoint) -> Optional[str]: ...

    def evict(self, spec: FunctionSpec, pod_id: str) -> None: ...

    def alive(self, pod_id: str) -> bool: ...

    def node_of(self, pod_id: str) -> Optional[int]: ...

    def fragmentation(self) -> dict[int, float]: ...

    def node_load(self) -> dict[int, float]: ...

    def migrate(self, spec: FunctionSpec, pod_id: str,
                target: int) -> Optional[str]: ...

    def observed_rps(self, fn: str, window: float) -> float: ...

    def inflight(self, fn: str) -> int: ...

    def warm_nodes(self, fn: str) -> list[int]: ...

    def links(self) -> dict[tuple[int, int], float]: ...

    def health(self, node: int) -> float: ...

    def quarantine(self, node: int) -> int: ...

    def now(self) -> float: ...


class SimBackend:
    """Adapter: the discrete-event ``Cluster`` as a reconciler backend.

    Pod ids are the cluster's own (``fn-N``); time is virtual
    (``cluster.sim.now``); observed RPS comes from the cluster's arrival
    log over virtual time.
    """

    def __init__(self, cluster: Any):
        self.cluster = cluster

    def register(self, spec: FunctionSpec) -> None:
        if spec.curve is None:
            raise ValueError(
                f"spec {spec.name!r} needs a ServiceCurve for the simulator")
        self.cluster.register_function(spec.name, spec.curve,
                                       slo_latency=spec.slo_latency,
                                       slo_tier=spec.slo_tier,
                                       deadline_s=spec.deadline_s)

    def place(self, spec: FunctionSpec,
              point: ProfilePoint) -> Optional[str]:
        # track=False: the ControlPlane owns the L_j capacity queue.
        # Effective tensor-parallel degree: the spec's fleet-wide setting
        # or the point's own profiled one, whichever is wider (same rule
        # as the live backend, so decision replays stay aligned).
        return self.cluster.deploy(spec.name, point,
                                   elastic_limit=spec.elastic_limit,
                                   track=False,
                                   cold_start_s=spec.cold_start_s,
                                   shards=max(spec.shards, point.shards))

    def evict(self, spec: FunctionSpec, pod_id: str) -> None:
        # Idempotent by design, but NOT the dead-pod authority: the
        # reconciler prunes pods that died behind its back via ``alive``
        # at the top of every tick, so a scale-down can only ever name a
        # pod that existed when the tick started (it may still lose a race
        # against a mid-tick failure, hence the tolerance here).
        if pod_id in self.cluster.pods:
            self.cluster.retire(pod_id, drain=True)

    def alive(self, pod_id: str) -> bool:
        return self.cluster.alive(pod_id)

    def node_of(self, pod_id: str) -> Optional[int]:
        return self.cluster.node_of(pod_id)

    def fragmentation(self) -> dict[int, float]:
        return self.cluster.fragmentation()

    def node_load(self) -> dict[int, float]:
        return self.cluster.node_load()

    def migrate(self, spec: FunctionSpec, pod_id: str,
                target: int) -> Optional[str]:
        return self.cluster.migrate(pod_id, target)

    def observed_rps(self, fn: str, window: float) -> float:
        return self.cluster.observed_rps(fn, window)

    def inflight(self, fn: str) -> int:
        return self.cluster.inflight(fn)

    def warm_nodes(self, fn: str) -> list[int]:
        return self.cluster.warm_nodes(fn)

    def links(self) -> dict[tuple[int, int], float]:
        return self.cluster.links.pairs()

    def health(self, node: int) -> float:
        return self.cluster.health(node)

    def quarantine(self, node: int) -> int:
        return self.cluster.quarantine(node)

    def now(self) -> float:
        return self.cluster.sim.now


class LiveBackend:
    """Adapter: the port's ``ClusterFrontend`` as a reconciler backend.

    Pod ids are ``node:inst_id`` handles; time is wall-clock.  Models are
    built once per spec at registration (``spec.model_factory``) and their
    params shared zero-copy across instances by the per-node ModelStore.
    """

    def __init__(self, frontend: Any):
        self.frontend = frontend
        self._models: dict[str, tuple[Any, Any]] = {}
        self._drafts: dict[str, Any] = {}

    def register(self, spec: FunctionSpec) -> None:
        if spec.model_factory is None:
            raise ValueError(
                f"spec {spec.name!r} needs a model_factory for live serving")
        self._models[spec.name] = spec.model_factory()
        if spec.speculate is not None:
            if spec.draft_factory is None:
                raise ValueError(
                    f"spec {spec.name!r} sets speculate but no "
                    f"draft_factory for the draft weights")
            # Draft weights built once per spec, shared by every placement
            # through the per-node store (same sharing as the target).
            self._drafts[spec.name] = spec.draft_factory()

    def place(self, spec: FunctionSpec,
              point: ProfilePoint) -> Optional[str]:
        model, params = self._models[spec.name]
        alloc = point.to_alloc(spec.elastic_limit)
        # Paged block budget: an explicit spec override wins; otherwise the
        # profiled capacity of this allocation (ProfilePoint.kv_blocks, via
        # profiler.paged_kv_capacity); otherwise the engine's dense-
        # equivalent default.
        n_kv_blocks = spec.n_kv_blocks
        if (n_kv_blocks is None and spec.batching == "paged"
                and point.kv_blocks >= 2):
            n_kv_blocks = point.kv_blocks
        # Shared-fraction axis: the spec declaration and the profiled
        # point both carry it; charge admission with the larger (the spec
        # is the operator's override, the point the profiler's evidence).
        shared_frac = max(spec.kv_shared_frac, point.kv_shared_frac)
        if spec.batching != "paged" or not spec.prefix_sharing:
            shared_frac = 0.0
        # Arm the frontend's deadline/shedding lifecycle here rather than
        # at register: the shed admission check needs a per-instance
        # service-rate estimate, and the profile point is the first place
        # one exists.  With a best-effort tier and no deadline this stores
        # (tier, None, rate) and the whole machinery stays dormant.
        self.frontend.configure_slo(spec.name, tier=spec.slo_tier,
                                    deadline_s=spec.deadline_budget(),
                                    est_rps=point.throughput)
        return self.frontend.place_instance(
            spec.name, model, params, alloc,
            max_batch=spec.max_batch, max_len=spec.max_len,
            batching=spec.batching, framework_bytes=spec.framework_bytes,
            block_size=spec.block_size, n_kv_blocks=n_kv_blocks,
            prefix_sharing=spec.prefix_sharing,
            kv_shared_frac=shared_frac,
            speculate=spec.speculate,
            draft_params=self._drafts.get(spec.name),
            shards=max(spec.shards, point.shards))

    def evict(self, spec: FunctionSpec, pod_id: str) -> None:
        # Same mid-tick failure tolerance as SimBackend.evict.
        if self.frontend.alive(pod_id):
            self.frontend.evict(pod_id)

    def alive(self, pod_id: str) -> bool:
        return self.frontend.alive(pod_id)

    def node_of(self, pod_id: str) -> Optional[int]:
        return self.frontend.node_of(pod_id)

    def fragmentation(self) -> dict[int, float]:
        return self.frontend.fragmentation()

    def node_load(self) -> dict[int, float]:
        return self.frontend.node_load()

    def migrate(self, spec: FunctionSpec, pod_id: str,
                target: int) -> Optional[str]:
        model, params = self._models[spec.name]
        return self.frontend.migrate(spec.name, pod_id, model, params,
                                     target)

    def observed_rps(self, fn: str, window: float) -> float:
        return self.frontend.observed_rps(fn, window)

    def inflight(self, fn: str) -> int:
        return self.frontend.inflight(fn)

    def warm_nodes(self, fn: str) -> list[int]:
        return self.frontend.warm_nodes(fn)

    def links(self) -> dict[tuple[int, int], float]:
        return self.frontend.links.pairs()

    def health(self, node: int) -> float:
        return self.frontend.health(node)

    def quarantine(self, node: int) -> int:
        return self.frontend.quarantine(node)

    def now(self) -> float:
        return self.frontend.now()
