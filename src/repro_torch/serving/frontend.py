"""Multi-engine frontend: the live analogue of ``repro_torch.core.cluster``
(counterpart of ``repro.serving.frontend``).

``ClusterFrontend`` routes requests across N ``ServingEngine`` nodes so the
port's data plane exercises the simulator's full stack:

* **Placement** — function instances are bound to nodes by the same
  ``MaxRectsPool`` (paper Alg. 2) the simulator uses: each instance's
  ``Alloc`` rectangle is packed best-area-fit across the fleet, and a
  candidate node must also pass ``MemoryModel`` admission (model-sharing
  footprints, paper Fig. 13 / §3.5) before the engine deploys there.
* **Routing** — ``submit`` joins the shortest queue across all nodes
  hosting the function (queue depth + occupied decode slots), mirroring
  ``Cluster._arrive``.
* **Dispatch** — ``pump`` interleaves the per-node token schedulers
  (FaST-Manager, one per engine) until the fleet is idle.
* **Scale-down** — ``evict`` retires one instance: its queued requests are
  re-routed to surviving replicas, its occupied decode slots drain under
  the token scheduler, and only then are its MRA rectangle and weight
  refcount released (zero dropped in-flight requests).

The frontend is one of the two ``repro_torch.control`` backends: the
``ControlPlane`` reconciler drives ``place_instance`` / ``evict`` /
``observed_rps`` / ``inflight`` so the live fleet and the simulator run
literally the same Alg.-1 scheduler code.

Weights are shared *per node*: deploying the same function on two nodes
stores one param tree in each node's ``ModelStore``; instances within a
node alias it zero-copy.

Every node is a ``ServingEngine`` on the frontend's one ``device``
(``None`` = the card), or on its own entry of ``devices``: on one card
the nodes are logical, each with its own weight copy, token scheduler
and memory budget (``mem_bytes``).
With a fleet ``model_store``, an overlapped upload's copies run on a
side stream; the frontend makes the card's current stream, which the
engines launch on, wait on the upload's event before it deploys the
instance, so the instance's first admission and its graph captures
follow the copies and the host never waits for them.

``sampling`` and ``speculate`` deploy the engine's sampled and
speculative rounds; the draft weights (``draft_params``) are charged with
the function's and, with a fleet ``model_store``, ride its tiers under
``"{fn}#draft"``.

``shards > 1`` places a tensor-parallel pod (frontend.py:457-548 of the
JAX package): one rectangle on each of ``shards`` member nodes of the
best-linked group, the KV charge divided by ``shards`` per member, and
one instance on the primary member's engine driving a ``TPGroup`` of the
members' devices (``engine.FunctionInstance``).  A pod dies with any
member, does not migrate and does not speculate.  It serves the dense
and moe families, full, rolled and dual caches, bf16 or int8 KV, and
the rwkv and hybrid families (continuous batching, exact-length
prefill).  A family that prefills with a context (encdec, vlm) is
refused at any ``shards``, before any rectangle is taken.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
import time
import weakref
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.links import NetworkLinks
from repro_torch.core.maximal_rectangles import MaxRectsPool, Placement
from repro_torch.core.model_sharing import (MemoryModel, node_shared_footprint,
                                      pytree_nbytes)
from repro_torch.core.resources import Alloc
from repro_torch.core.slo import (TIER_BEST_EFFORT, TIER_GUARANTEED, RetryPolicy,
                            observed_rate, record_arrival)
from repro_torch.distributed.sharding import (TPGroup, serve_pspec,
                                              sharding_for, tp_group)
from repro_torch.models import build_model
from repro_torch.models.model import Model
from repro_torch.serving.engine import (ServeRequest, ServingEngine,
                                       context_refusal)
from repro_torch.serving.modelstore import ColdStartEvent, FleetModelStore
from repro_torch.serving.paging import blocks_needed

# Per-instance runtime footprint (the JAX package's jit executables and
# host bookkeeping; the port's round and admission graph pools) charged by
# admission on top of the KV pool when the caller gives no measurement.
# On the card an instance's graph pools alone reserve more: pass a
# measured ``framework_bytes`` there.
DEFAULT_FRAMEWORK_BYTES = 64 * 1024 * 1024


def _closed(ref: weakref.ref, node: int, inst_id: str) -> None:
    frontend = ref()
    if frontend is not None:
        frontend._instance_closed(node, inst_id)


@dataclasses.dataclass
class InstancePlacement:
    """One live instance: which node it landed on and its MRA rectangle.

    A sharded pod holds one rectangle on every member node; ``node`` and
    ``placement`` are the primary's (the engine hosting the instance),
    ``member_nodes``/``member_placements`` list all of them, primary
    first.  A one-device pod leaves the member tuples empty.
    """

    fn: str
    inst_id: str
    node: int
    placement: Placement
    member_nodes: tuple[int, ...] = ()
    member_placements: tuple[Placement, ...] = ()

    def all_nodes(self) -> tuple[int, ...]:
        return self.member_nodes or (self.node,)

    def all_placements(self) -> tuple[Placement, ...]:
        return self.member_placements or (self.placement,)


class ClusterFrontend:
    """Join-shortest-queue router over N token-scheduled engine nodes."""

    def __init__(self, n_nodes: int = 2, *,
                 mem_bytes: int = 16 * 1024**3, window: float = 0.2,
                 model_store: Optional[FleetModelStore] = None,
                 cold_start: str = "overlap",
                 links: Optional[NetworkLinks] = None,
                 idle_sleep_s: float = 0.001,
                 retry: Optional[RetryPolicy] = None, device=None,
                 devices: Optional[list] = None):
        if n_nodes <= 0:
            raise ValueError("need at least one node")
        if devices is not None and len(devices) != n_nodes:
            raise ValueError(f"devices names {len(devices)} nodes' devices, "
                             f"the fleet has {n_nodes}")
        if cold_start not in ("overlap", "blocking"):
            raise ValueError(f"unknown cold_start mode {cold_start!r}")
        # Inter-node bandwidth graph: the fleet store picks its transfer
        # peer by link speed.
        self.links = links if links is not None else NetworkLinks(n_nodes)
        self.links.grow(n_nodes)
        # Optional fleet weight tier (serving/modelstore.py): placements
        # source their params through it (device -> host -> peer -> cold),
        # scale-up prefers warm nodes, and memory admission charges the
        # storage-server context once per node instead of per function.
        self.model_store = model_store
        if model_store is not None and getattr(model_store, "links",
                                               None) is None:
            # Bandwidth-aware peer selection for host-to-host transfers.
            model_store.links = self.links
        self.cold_start = cold_start
        # (event, node, inst_id): TTFT resolved lazily from the instance's
        # first landed token by cold_start_events().
        self._cold_instances: list[tuple[ColdStartEvent, int, str]] = []
        self.device = resolve_device(device)
        # Each node's device: the frontend's one device, or ``devices``
        # (several cards: a sharded pod's members then span them).
        self.node_devices = ([resolve_device(d) for d in devices]
                             if devices is not None
                             else [self.device] * n_nodes)
        self.engines = [ServingEngine(window=window, device=dev,
                                      idle_sleep_s=idle_sleep_s)
                        for dev in self.node_devices]
        # The engines call back through a weak reference: the frontend and
        # its engines form no cycle, so a dropped fleet frees its
        # instances' pools at once, never in a later garbage collection
        # (which may run inside another instance's graph capture).
        ref = weakref.ref(self)
        for i, eng in enumerate(self.engines):
            eng.on_instance_closed = functools.partial(_closed, ref, i)
        self.pool = MaxRectsPool(n_nodes, allow_grow=False)
        self.mem_bytes = mem_bytes
        self.placements: list[InstancePlacement] = []
        self._fn_mm: dict[str, MemoryModel] = {}
        self._pod_seq = itertools.count()
        self._arrival_log: dict[str, list[float]] = {}
        self._rps_horizon: dict[str, float] = {}
        # Requests stranded by a node failure while their function has zero
        # live instances: re-routed as soon as a replacement deploys.
        self._pending: dict[str, list[ServeRequest]] = {}
        # fn -> (max_len, block_size, paged block capacity or None, spec_k),
        # learned at placement so submissions during a podless heal window
        # can still be validated (and parked) instead of dropped.
        self._fn_limits: dict[str, tuple[int, int, Optional[int], int]] = {}
        # Functions whose placements pinned draft weights in the fleet
        # store (speculative decoding), so closing releases both keys.
        self._fn_draft: set[str] = set()
        # fn -> draft Model, built once for fleet-store staging.
        self._draft_models: dict[str, Model] = {}
        self._req_seq = itertools.count()
        self._t0 = time.perf_counter()
        # SLO lifecycle (all dormant until ``configure_slo`` sets a
        # deadline): fn -> (tier, deadline budget seconds or None,
        # per-instance requests/s estimate for the shed admission check).
        self._fn_slo: dict[str, tuple[str, Optional[float], float]] = {}
        self.retry = retry
        # (not_before, fn, req): stranded requests waiting out their
        # jittered backoff; flushed by pump.
        self._retry_buf: list[tuple[float, str, ServeRequest]] = []
        self.shed = 0      # rejected at admission: could not make deadline
        self.lost = 0      # retry budget exhausted after failures
        self.rejected = 0  # parked requests whose function was unregistered

    def now(self) -> float:
        return time.perf_counter() - self._t0

    def configure_slo(self, fn: str, tier: str = TIER_BEST_EFFORT,
                      deadline_s: Optional[float] = None,
                      est_rps: float = 0.0) -> None:
        """Arm the deadline/shedding lifecycle for ``fn``.

        ``deadline_s`` is the per-request budget from submission (None
        keeps the machinery dormant); ``est_rps`` is the per-instance
        service-rate estimate (the profile point's throughput) behind the
        queue-depth completion estimate that drives shedding."""
        self._fn_slo[fn] = (tier, deadline_s, est_rps)

    # -- memory admission (same closed form as core.cluster.Node) ---------

    def _fn_instances_on(self, node: int) -> dict[str, int]:
        counts: dict[str, int] = {}
        for p in self.placements:
            if node in p.all_nodes():
                counts[p.fn] = counts.get(p.fn, 0) + 1
        return counts

    def mem_used(self, node: int) -> int:
        counts = self._fn_instances_on(node)
        if self.model_store is not None:
            # The fleet store is the node's single storage server: its
            # context overhead is charged once per node, not per function.
            return node_shared_footprint(
                (self._fn_mm[fn], n) for fn, n in counts.items())
        return sum(self._fn_mm[fn].footprint(n, sharing=True)
                   for fn, n in counts.items() if n > 0)

    def admits(self, node: int, fn: str, mm: MemoryModel) -> bool:
        n = self._fn_instances_on(node).get(fn, 0)
        if self.model_store is not None:
            counts = self._fn_instances_on(node)
            counts[fn] = n + 1
            mms = {**self._fn_mm, fn: mm}
            projected = node_shared_footprint(
                (mms[f], c) for f, c in counts.items())
        else:
            projected = (self.mem_used(node)
                         - mm.footprint(n, sharing=True)
                         + mm.footprint(n + 1, sharing=True))
        return projected <= self.mem_bytes

    # -- warm-node lookup (cold-start tier) --------------------------------

    def warm_nodes(self, fn: str) -> list[int]:
        """Nodes that can serve ``fn``'s weights without a cold stage:
        device-resident (engine ModelStore) or host-staged (fleet store).
        Empty without a fleet store — warm-aware selection is then off."""
        if self.model_store is None:
            return []
        warm = set(self.model_store.warm_nodes(fn))
        warm |= {i for i, eng in enumerate(self.engines)
                 if eng.alive and eng.store.contains(fn)}
        return sorted(warm)

    # -- deployment --------------------------------------------------------

    def place_instance(self, fn: str, model: Model, params: Any,
                       alloc: Alloc, *, max_batch: int = 4, max_len: int = 64,
                       batching: str = "continuous",
                       framework_bytes: int = DEFAULT_FRAMEWORK_BYTES,
                       block_size: int = 16,
                       n_kv_blocks: Optional[int] = None,
                       fused: bool = True, prefix_sharing: bool = True,
                       kv_shared_frac: float = 0.0,
                       weights_loader: Optional[Any] = None,
                       sampling: Optional[Any] = None,
                       speculate: Optional[Any] = None,
                       draft_params: Optional[Any] = None,
                       shards: int = 1
                       ) -> Optional[str]:
        """Place ONE instance via MRA + memory admission with spillover.

        Returns a ``node:inst_id`` handle, or None when no node has both a
        free rectangle and the memory headroom.  On engine failure after a
        successful rectangle reservation, the rectangle (and a freshly
        created ``MemoryModel`` entry) is rolled back instead of leaking.

        Admission charges the instance's REAL decode-cache layout on top of
        ``framework_bytes``: ``n_kv_blocks x block_bytes`` for a paged
        instance, the dense ``max_batch x max_len`` slot pool otherwise —
        so a paged deployment with a tight block budget admits more
        replicas per node than its dense equivalent.

        ``kv_shared_frac`` is the shared-fraction admission axis: the
        declared fraction of KV blocks expected to be prefix-shared
        duplicates of resident blocks (profiled, or observed via
        ``kv_shared_fraction``).  The KV charge is discounted to
        ``(1 - frac)`` of the physical pool — honest over-admission, in
        HAS-GPU's sense of charging what is actually used: the engine
        enforces the worst case per request at block granularity, and the
        observed ``kv_bytes_saved`` telemetry validates the declared
        fraction.  ``prefix_sharing=False`` deploys the unshared
        reference plane (and such a function must declare frac 0).

        With a fleet ``model_store`` attached, placement prefers warm
        nodes (host-staged or device-resident weights) over cold ones,
        sources the params through the tier (device -> host -> peer ->
        cold), and records a ``ColdStartEvent``.  ``params=None`` is
        then allowed: a host/peer hit re-uploads the staged shards, and
        a true cold miss calls ``weights_loader()`` — the origin fetch
        is paid inside the measured cold-start window.

        The KV charge is the instance's pool as the instance will build
        it (``Model.kv_cache_bytes`` under the int8 gate read now), without
        the paged pool's sink block.  An overlapped upload's event is
        waited on by the card's current stream before the deploy.

        ``speculate`` (a ``SpecConfig``) deploys the draft/verify round:
        the draft weights (``draft_params``) charge the same rectangle and
        memory admission as the target (their bytes fold into the
        function's weight footprint), and with a fleet ``model_store``
        they ride the same tiers under ``"{fn}#draft"``.  ``sampling`` (a
        ``SamplingConfig``) samples on the device
        (frontend.py:218-440 of the JAX package).

        ``shards > 1`` deploys ONE tensor-parallel pod spanning that many
        nodes (``_place_sharded``): a rectangle on every member of the
        best-linked node group, the KV charge divided by ``shards`` per
        node, and the primary member's engine running the instance over a
        ``TPGroup`` of the members' devices.  A family that prefills with
        a context raises the engine's refusal (``ValueError``, at any
        ``shards``) before any rectangle is taken.
        """
        t_start = time.perf_counter()
        if shards < 1:
            raise ValueError(f"shards must be >= 1, got {shards}")
        if shards > 1 and speculate is not None:
            raise ValueError(
                "speculate cannot ride a sharded pod: the draft/verify "
                "round is not tensor-parallel")
        why = context_refusal(model.cfg)
        if why:
            raise ValueError(why)
        if not 0.0 <= kv_shared_frac < 1.0:
            raise ValueError(
                f"kv_shared_frac must be in [0, 1), got {kv_shared_frac}")
        if kv_shared_frac > 0.0 and (batching != "paged"
                                     or not prefix_sharing):
            raise ValueError(
                "kv_shared_frac needs batching='paged' with prefix "
                "sharing enabled — nothing else can share KV blocks")
        kv_bytes = int(model.kv_cache_bytes(
            batching=batching, max_batch=max_batch, max_len=max_len,
            block_size=block_size, n_kv_blocks=n_kv_blocks,
            kv_int8=model.kv_int8())
            * (1.0 - kv_shared_frac))
        if shards > 1:
            # Per-member charge, kept exactly as JAX's (frontend.py:
            # 299-307): where the pool splits its heads over the members
            # each holds about 1/shards of it (a pool whose heads do not
            # divide the group, hymba-1.5b's, is whole on every member and
            # charged the same share); weights stay charged in full per
            # node, the honest bound under column-only TP.
            kv_bytes //= shards
        if params is None:
            if self.model_store is None:
                raise ValueError(
                    "params=None requires a fleet model_store")
            weight_bytes = self.model_store.staged_nbytes(fn)
            if weight_bytes is None:
                if weights_loader is None:
                    raise ValueError(
                        f"function {fn!r} has no staged weights and no "
                        "weights_loader — nothing to place")
                # Origin fetch: genuinely cold, and charged to this
                # placement's cold-start window.
                params = weights_loader()
                weight_bytes = pytree_nbytes(params)
        else:
            weight_bytes = pytree_nbytes(params)
        if speculate is not None:
            # The draft charges the same rectangle and admission as the
            # target: its bytes fold into the function's weight footprint.
            if draft_params is not None:
                weight_bytes += pytree_nbytes(draft_params)
            else:
                staged = (self.model_store.staged_nbytes(f"{fn}#draft")
                          if self.model_store is not None else None)
                if staged is None:
                    raise ValueError(
                        f"function {fn!r} sets speculate but has no draft "
                        f"weights (pass draft_params or stage them in the "
                        f"fleet store)")
                weight_bytes += staged
        created_mm = fn not in self._fn_mm
        mm = self._fn_mm.setdefault(
            fn, MemoryModel(weight_bytes=weight_bytes,
                            framework_bytes=framework_bytes + kv_bytes))
        if mm.framework_bytes != framework_bytes + kv_bytes:
            # The per-function MemoryModel is shared by all replicas; a
            # placement with a different data-plane config would silently
            # mis-account every node's footprint.
            raise ValueError(
                f"function {fn!r} already placed with a different "
                f"per-instance footprint ({mm.framework_bytes} vs "
                f"{framework_bytes + kv_bytes} bytes); one data-plane "
                f"config per function")

        def rollback_mm() -> None:
            if created_mm and not any(p.fn == fn for p in self.placements):
                del self._fn_mm[fn]

        if shards > 1:
            return self._place_sharded(
                fn, model, params, alloc, mm, rollback_mm, shards,
                max_batch=max_batch, max_len=max_len, batching=batching,
                block_size=block_size, n_kv_blocks=n_kv_blocks,
                fused=fused, prefix_sharing=prefix_sharing,
                sampling=sampling, weights_loader=weights_loader,
                t_start=t_start)
        pod_id = f"{fn}-{next(self._pod_seq)}"
        # Warm-first phases: with a fleet store attached, the MRA search
        # first restricts itself to warm nodes (host-staged or
        # device-resident weights) and only then falls back to the whole
        # fleet — warm-aware selection riding next to the existing fit.
        all_nodes = {n.node_id for n in self.pool.nodes}
        phases: list[set[int]] = []
        warm = set(self.warm_nodes(fn))
        if warm and warm != all_nodes:
            phases.append(all_nodes - warm)
        phases.append(set())
        placement = None
        for base_exclude in phases:
            excluded = set(base_exclude)
            while True:
                placement = self.pool.schedule(alloc, pod_id,
                                               exclude=excluded)
                if placement is None:
                    break
                if self.admits(placement.node, fn, mm):
                    break
                # Spillover: rectangle fit but memory admission failed on
                # this node — release and retry the remaining nodes.
                self.pool.release(placement)
                excluded.add(placement.node)
            if placement is not None:
                break
        if placement is None:
            rollback_mm()
            return None
        event = None
        deploy_params = params
        deploy_draft = draft_params
        draft_acquired = False
        if self.model_store is not None:
            deploy_params, event = self._acquire(placement.node, fn, model,
                                                 params, weights_loader)
            event.placed_at = t_start  # TTFT window opens at call entry
            if speculate is not None:
                # The draft rides the same tiers under "{fn}#draft".
                dmodel = self._draft_models.get(fn)
                if dmodel is None:
                    dmodel = self._draft_models[fn] = build_model(
                        speculate.draft_cfg)
                deploy_draft, _ = self._acquire(placement.node,
                                                f"{fn}#draft", dmodel,
                                                draft_params, None)
                draft_acquired = True
                self._fn_draft.add(fn)
        try:
            inst_id = self.engines[placement.node].deploy(
                fn, model, deploy_params, alloc, n_instances=1,
                max_batch=max_batch, max_len=max_len, batching=batching,
                block_size=block_size, n_kv_blocks=n_kv_blocks,
                fused=fused, prefix_sharing=prefix_sharing,
                sampling=sampling, speculate=speculate,
                draft_params=deploy_draft)[0]
        except Exception:
            # The rectangle was reserved before the engine ran; a failed
            # deploy must not leak it (or a provisional memory-model entry,
            # or a host-cache pin).
            self.pool.release(placement)
            if self.model_store is not None:
                self.model_store.release(placement.node, fn)
                if draft_acquired:
                    self.model_store.release(placement.node, f"{fn}#draft")
            rollback_mm()
            raise
        if event is not None:
            self._cold_instances.append((event, placement.node, inst_id))
        self.placements.append(InstancePlacement(
            fn=fn, inst_id=inst_id, node=placement.node,
            placement=placement))
        inst = self.engines[placement.node].instances[inst_id]
        self._fn_limits[fn] = (max_len, block_size,
                               inst.allocator.capacity
                               if batching == "paged" else None,
                               speculate.k if speculate is not None else 0)
        # Requests parked while the function had zero live instances.
        for req in self._pending.pop(fn, []):
            self._enqueue(fn, req)
        return f"{placement.node}:{inst_id}"

    def _acquire(self, node: int, fn: str, model: Model, params: Any,
                 loader: Optional[Any], group: Optional[TPGroup] = None
                 ) -> tuple[Any, ColdStartEvent]:
        """Source the weights stored under ``fn`` (a function's, or its
        draft's, ``"{fn}#draft"``) for ``node`` through the fleet tier and
        order the card's current stream (the engines') after an overlapped
        upload's copies.  A re-upload only ever reaches a node that holds
        no copy, hence no instance of the function whose graphs captured
        one.  With a pod's ``group`` the upload gives each member its
        ``serve_pspec`` slices, and the node's copy is the engine's
        ``group.weights_key(fn)`` entry."""
        eng = self.engines[node]
        resident = eng.store.contains(
            fn if group is None else group.weights_key(fn))
        owner = fn.split("#")[0]
        if not resident and any(k.startswith(owner + "/")
                                for k in eng.instances):
            raise RuntimeError(f"node {node} runs {owner} without its "
                               f"weights")
        sharding = (None if group is None else functools.partial(
            sharding_for, group=group, resolver=serve_pspec))
        deploy_params, event = self.model_store.acquire(
            node, fn, model, params=params, loader=loader,
            resident=resident, mode=self.cold_start, device=eng.device,
            sharding_for=sharding)
        if event.ready is not None:
            torch.cuda.current_stream(eng.device).wait_event(event.ready)
        return deploy_params, event

    def _place_sharded(self, fn: str, model: Model, params: Any,
                       alloc: Alloc, mm: MemoryModel, rollback_mm: Any,
                       shards: int, *, max_batch: int, max_len: int,
                       batching: str, block_size: int,
                       n_kv_blocks: Optional[int], fused: bool,
                       prefix_sharing: bool, sampling: Optional[Any],
                       weights_loader: Optional[Any],
                       t_start: float) -> Optional[str]:
        """Acquire ``shards`` MRA rectangles, one per member node, on the
        best-connected node group and deploy ONE tensor-parallel instance
        across them (frontend.py:457-548).

        Candidate groups are walked in ``NetworkLinks.best_groups`` order,
        highest bottleneck bandwidth first, so the pod's gathers ride the
        fastest links.  Every member must fit the rectangle and pass memory
        admission; a group that fails anywhere gives back the rectangles
        it took and the next group is tried.  The primary (first member)
        hosts the instance; its group names each member's node and
        device.  With a fleet store the weights are staged under ``fn``
        and uploaded as each member's slices (``sharding_for``, by
        ``serve_pspec``)."""
        all_nodes = {n.node_id for n in self.pool.nodes}
        candidates = sorted(n for n in all_nodes if self.engines[n].alive)
        pod_id = f"{fn}-{next(self._pod_seq)}"
        group: Optional[list[int]] = None
        rects: list[Placement] = []
        for cand in self.links.best_groups(candidates, shards):
            acquired: list[Placement] = []
            ok = True
            for member in cand:
                rect = self.pool.schedule(alloc, f"{pod_id}@{member}",
                                          exclude=all_nodes - {member})
                if rect is None or not self.admits(member, fn, mm):
                    if rect is not None:
                        self.pool.release(rect)
                    ok = False
                    break
                acquired.append(rect)
            if ok:
                group, rects = list(cand), acquired
                break
            for rect in acquired:
                self.pool.release(rect)
        if group is None:
            rollback_mm()
            return None
        primary = group[0]
        tp = tp_group(shards, devices=[self.node_devices[n] for n in group],
                      nodes=group)
        event = None
        deploy_params = params
        acquired_store = False
        try:
            if self.model_store is not None:
                deploy_params, event = self._acquire(
                    primary, fn, model, params, weights_loader, tp)
                acquired_store = True
                event.placed_at = t_start
            inst_id = self.engines[primary].deploy(
                fn, model, deploy_params, alloc, n_instances=1,
                max_batch=max_batch, max_len=max_len, batching=batching,
                block_size=block_size, n_kv_blocks=n_kv_blocks,
                fused=fused, prefix_sharing=prefix_sharing,
                sampling=sampling, group=tp)[0]
        except Exception:
            for rect in rects:
                self.pool.release(rect)
            if acquired_store:
                self.model_store.release(primary, fn)
            rollback_mm()
            raise
        if event is not None:
            self._cold_instances.append((event, primary, inst_id))
        self.placements.append(InstancePlacement(
            fn=fn, inst_id=inst_id, node=primary, placement=rects[0],
            member_nodes=tuple(group), member_placements=tuple(rects)))
        inst = self.engines[primary].instances[inst_id]
        self._fn_limits[fn] = (max_len, block_size,
                               inst.allocator.capacity
                               if batching == "paged" else None, 0)
        for req in self._pending.pop(fn, []):
            self._enqueue(fn, req)
        return f"{primary}:{inst_id}"

    def deploy(self, fn: str, model: Model, params: Any, alloc: Alloc, *,
               n_instances: int = 1, max_batch: int = 4, max_len: int = 64,
               batching: str = "continuous",
               framework_bytes: int = DEFAULT_FRAMEWORK_BYTES,
               block_size: int = 16,
               n_kv_blocks: Optional[int] = None,
               fused: bool = True, prefix_sharing: bool = True,
               kv_shared_frac: float = 0.0,
               sampling: Optional[Any] = None,
               speculate: Optional[Any] = None,
               draft_params: Optional[Any] = None,
               shards: int = 1) -> list[str]:
        """Place ``n_instances`` of ``fn`` across the fleet via MRA +
        memory admission; returns ``node:inst_id`` handles."""
        handles = []
        for _ in range(n_instances):
            handle = self.place_instance(
                fn, model, params, alloc, max_batch=max_batch,
                max_len=max_len, batching=batching,
                framework_bytes=framework_bytes,
                block_size=block_size, n_kv_blocks=n_kv_blocks, fused=fused,
                prefix_sharing=prefix_sharing,
                kv_shared_frac=kv_shared_frac, sampling=sampling,
                speculate=speculate, draft_params=draft_params,
                shards=shards)
            if handle is None:
                raise RuntimeError(
                    f"no node can host {fn} at alloc {alloc} "
                    f"(rectangles or memory exhausted)")
            handles.append(handle)
        return handles

    def nodes_for(self, fn: str) -> list[int]:
        return sorted({p.node for p in self.placements if p.fn == fn})

    # -- request path ------------------------------------------------------

    def _fn_load(self, node: int, fn: str) -> int:
        eng = self.engines[node]
        return sum(inst.load() for key, inst in eng.instances.items()
                   if key.startswith(fn + "/"))

    def _live_nodes(self, fn: str) -> list[int]:
        """Nodes with at least one routable (non-retired, non-paused)
        instance of ``fn``."""
        out = []
        for node in self.nodes_for(fn):
            eng = self.engines[node]
            if eng.alive and not eng.quarantined and any(
                    k.startswith(fn + "/") and not inst.retired
                    and not inst.paused
                    for k, inst in eng.instances.items()):
                out.append(node)
        return out

    def _pick_node(self, fn: str) -> int:
        """Join-shortest-queue node selection over live instances."""
        nodes = self._live_nodes(fn)
        if not nodes:
            raise KeyError(f"function {fn} is not deployed")
        return min(nodes, key=lambda n: self._fn_load(n, fn))

    def _enqueue(self, fn: str, req: ServeRequest) -> None:
        """Route an EXISTING request (drain re-route) the same way submit
        routes new ones: JSQ node, then JSQ live instance."""
        eng = self.engines[self._pick_node(fn)]
        cands = [v for k, v in eng.instances.items()
                 if k.startswith(fn + "/") and not v.retired
                 and not v.paused]
        ServingEngine.enqueue(min(cands, key=lambda i: i.load()), req)

    def submit(self, fn: str, prompt: np.ndarray, max_new_tokens: int = 8
               ) -> ServeRequest:
        tier, budget, est_rps = self._fn_slo.get(
            fn, (TIER_BEST_EFFORT, None, 0.0))
        deadline = None if budget is None else self.now() + budget
        if not self._live_nodes(fn):
            # Podless window (a failure killed the last replica, or the
            # fleet scaled to zero): park the request — mirroring the
            # simulator's pending buffer — and let the reconciler's next
            # placement flush it.  Functions never placed here stay a hard
            # error: there is no config to validate against.
            if fn not in self._fn_limits:
                raise KeyError(f"function {fn} is not deployed")
            max_len, block_size, blocks_cap, spec_k = self._fn_limits[fn]
            rows = (int(prompt.shape[0]) + max_new_tokens - 1
                    + (spec_k if max_new_tokens > 1 else 0))
            if rows > max_len:
                raise ValueError(
                    f"request needs {rows} KV rows > max_len {max_len} "
                    f"of function {fn}")
            if (blocks_cap is not None and max_new_tokens > 1
                    and blocks_needed(rows, block_size) > blocks_cap):
                raise ValueError(
                    f"request needs {blocks_needed(rows, block_size)} KV "
                    f"blocks > pool capacity {blocks_cap} of function {fn}")
            record_arrival(self._arrival_log, self._rps_horizon, fn,
                           self.now())
            req = ServeRequest(req_id=next(self._req_seq), prompt=prompt,
                               max_new_tokens=max_new_tokens,
                               submitted_at=self.now(), deadline=deadline,
                               tier=tier)
            self._pending.setdefault(fn, []).append(req)
            return req
        node = self._pick_node(fn)
        record_arrival(self._arrival_log, self._rps_horizon, fn, self.now())
        # Deadline shedding ("reject fast"): estimate completion from the
        # chosen node's queue depth x the configured per-instance service
        # rate and reject a non-guaranteed request that cannot make its
        # deadline with a typed outcome instead of queuing it to die.
        if (deadline is not None and tier != TIER_GUARANTEED
                and est_rps > 0.0):
            est = (self._fn_load(node, fn) + 1) / est_rps
            if self.now() + est > deadline:
                self.shed += 1
                eng = self.engines[node]
                if fn in eng.recorders:
                    eng.recorders[fn].record_shed()
                return ServeRequest(req_id=next(self._req_seq),
                                    prompt=prompt,
                                    max_new_tokens=max_new_tokens,
                                    submitted_at=self.now(),
                                    deadline=deadline, tier=tier,
                                    done=True, outcome="shed",
                                    finished_at=self.now())
        # Second JSQ level across the chosen node's instances happens in
        # ServingEngine.submit.
        return self.engines[node].submit(fn, prompt, max_new_tokens,
                                         deadline=deadline, tier=tier)

    def has_work(self) -> bool:
        return any(e.has_work() for e in self.engines)

    def pump(self, budget_s: float = 1.0, slice_s: float = 0.02) -> int:
        """Interleave the per-node schedulers until idle or out of budget."""
        completed = 0
        deadline = time.perf_counter() + budget_s
        self._flush_retries()
        while ((time.perf_counter() < deadline)
               and (self.has_work() or self._retry_buf)):
            for eng in self.engines:
                if eng.has_work():
                    completed += eng.pump(budget_s=slice_s)
            self._flush_retries()
            if not self.has_work() and self._retry_buf:
                # Only backoff timers outstanding: wait one out instead of
                # spinning the whole budget.
                wake = min(t for t, _, _ in self._retry_buf)
                wait = min(wake - self.now(), deadline - time.perf_counter())
                if wait > 0:
                    time.sleep(wait)
                self._flush_retries()
        return completed

    def _flush_retries(self) -> None:
        """Re-route stranded requests whose jittered backoff has elapsed."""
        if not self._retry_buf:
            return
        now = self.now()
        due = [e for e in self._retry_buf if e[0] <= now]
        if not due:
            return
        self._retry_buf = [e for e in self._retry_buf if e[0] > now]
        for _, fn, req in due:
            if self._live_nodes(fn):
                self._enqueue(fn, req)
            elif fn in self._fn_limits:
                self._pending.setdefault(fn, []).append(req)
            else:
                req.done = True
                req.outcome = "rejected"
                req.finished_at = now
                self.rejected += 1

    # -- scale-down --------------------------------------------------------

    def evict(self, handle: str) -> None:
        """Gracefully retire the instance behind ``node:inst_id``.

        Queued (not yet admitted) requests are immediately re-routed to the
        function's surviving instances; occupied decode slots keep decoding
        until they finish.  The MRA rectangle and weight refcount are only
        released once the instance has fully drained (``on_instance_closed``
        fires from the engine pump)."""
        node_s, inst_id = handle.split(":", 1)
        node = int(node_s)
        fn = inst_id.split("/")[0]
        victim = self.engines[node].instances[inst_id]
        survivors = any(
            inst is not victim and not inst.retired
            for eng in self.engines for k, inst in eng.instances.items()
            if k.startswith(fn + "/"))
        # Last replica: keep its queue — it drains everything (queued AND
        # in-flight) before closing, so nothing is dropped.
        strays = self.engines[node].retire(inst_id,
                                           strip_queue=survivors)
        for req in strays:
            self._enqueue(fn, req)

    # -- lifecycle: failure + live KV migration ----------------------------

    def alive(self, handle: str) -> bool:
        """Whether the instance behind ``node:inst_id`` is still running on
        a non-quarantined node (failed nodes lose all their instances
        instantly; a quarantined node's instances read as not-alive so the
        reconciler prunes and heals them exactly like a crash)."""
        node_s, inst_id = handle.split(":", 1)
        node = int(node_s)
        if not 0 <= node < len(self.engines):
            return False
        eng = self.engines[node]
        if not eng.alive or eng.quarantined or inst_id not in eng.instances:
            return False
        # A sharded pod reads dead when ANY member node is quarantined.
        for p in self.placements:
            if p.node == node and p.inst_id == inst_id:
                return not any(self.engines[m].quarantined
                               for m in p.all_nodes())
        return True

    def health(self, node: int) -> float:
        """Node health score in (0, 1]: the engine's slow/fast pass-latency
        EWMA ratio (1.0 nominal; a node running Nx slower scores ~1/N)."""
        if not 0 <= node < len(self.engines):
            return 0.0
        return self.engines[node].health()

    def quarantine(self, node: int) -> int:
        """Gray-failure quarantine: stop routing and placement to the node,
        let occupants drain through pump.  One-way, like death — but the
        engine keeps serving what it already holds, and the reconciler
        heals the capacity through the ordinary ``alive`` prune +
        processing gap.  Returns the number of instances taken out of
        rotation."""
        eng = self.engines[node]
        if eng.quarantined or not eng.alive:
            return 0
        eng.quarantined = True
        self.pool.cordon(node)
        return sum(1 for p in self.placements if node in p.all_nodes())

    def unregister(self, fn: str) -> list[ServeRequest]:
        """Delete a function: evict its live instances and reject every
        parked request with the typed outcome ``"rejected"`` — a parked
        request must never outlive its function's registration.  Returns
        the rejected requests; subsequent submits raise ``KeyError``."""
        for p in [p for p in self.placements if p.fn == fn]:
            handle = f"{p.node}:{p.inst_id}"
            if self.alive(handle):
                self.evict(handle)
        rejected = self._pending.pop(fn, [])
        self._retry_buf, orphans = (
            [e for e in self._retry_buf if e[1] != fn],
            [e[2] for e in self._retry_buf if e[1] == fn])
        rejected.extend(orphans)
        now = self.now()
        for req in rejected:
            req.done = True
            req.outcome = "rejected"
            req.finished_at = now
        self.rejected += len(rejected)
        self._fn_limits.pop(fn, None)
        self._fn_slo.pop(fn, None)
        return rejected

    def node_of(self, handle: str) -> Optional[int]:
        node = int(handle.split(":", 1)[0])
        return node if 0 <= node < len(self.engines) else None

    def fragmentation(self) -> dict[int, float]:
        """Per-node MRA fragmentation over schedulable (alive) nodes."""
        return self.pool.fragmentation()

    def node_load(self) -> dict[int, float]:
        """Per-node allocated-area fraction over schedulable nodes."""
        return self.pool.node_load()

    def fail_node(self, node: int) -> int:
        """Crash one engine node: its instances, weights, and KV die.

        Mirrors ``Cluster.fail_node``: the node is cordoned, its
        rectangles dropped, and every stranded unfinished request (queued
        AND slot-occupying — partial output reset, since the KV died with
        the node) is re-routed to surviving replicas or parked until the
        reconciler re-places the function.  No self-healing here:
        ``ControlPlane.reconcile`` prunes the dead pods via ``alive`` and
        re-converges the fleet.  Returns the number of instances lost.
        The engine drops its instances' graphs and pools and its weight
        store (``ServingEngine.fail``); the caller's
        ``torch.cuda.empty_cache()`` returns what no live tensor shares a
        segment with.
        """
        eng = self.engines[node]
        strays = eng.fail()
        if self.model_store is not None:
            # Host RAM died with the node; peer caches stay warm.
            self.model_store.drop_node(node)
        self.pool.drain_node(node)
        # A sharded pod dies with ANY member: a KV share and a weight share
        # lived on the dead node.  A secondary member's death also kills
        # the (still running) instance on the primary's engine, and the
        # rectangles on surviving members are released here (drain_node
        # dropped only the dead node's).
        lost = [p for p in self.placements if node in p.all_nodes()]
        self.placements = [p for p in self.placements
                           if node not in p.all_nodes()]
        for p in lost:
            if p.node != node:
                strays.extend(self._kill_remote_member(p))
            for n_, rect in zip(p.all_nodes(), p.all_placements()):
                if n_ != node and self.engines[n_].alive:
                    self.pool.release(rect)
        for fn in {p.fn for p in lost}:
            if not any(p.fn == fn for p in self.placements):
                # No replica left anywhere: drop the per-function
                # MemoryModel so the healing redeploy may re-create it.
                self._fn_mm.pop(fn, None)
        for fn, req in strays:
            self._reinject(fn, req)
        return len(lost)

    def _reinject(self, fn: str, req: ServeRequest) -> None:
        """Re-route one stranded request — immediately (legacy, no retry
        policy) or through the bounded jittered-backoff retry buffer."""
        if self.retry is None:
            if self._live_nodes(fn):
                self._enqueue(fn, req)
            else:
                self._pending.setdefault(fn, []).append(req)
            return
        if (req.tier != TIER_GUARANTEED
                and self.retry.exhausted(req.attempts)):
            # Best-effort/batch: retry budget spent — typed loss, not an
            # eternal park.  Guaranteed requests retry without bound.
            req.done = True
            req.outcome = "failed"
            req.finished_at = self.now()
            self.lost += 1
            for eng in self.engines:
                if eng.alive and fn in eng.recorders:
                    eng.recorders[fn].record_lost()
                    break
            return
        req.attempts += 1
        self._retry_buf.append(
            (self.now() + self.retry.delay(req.attempts), fn, req))

    def _kill_remote_member(self, p: InstancePlacement
                            ) -> list[tuple[str, ServeRequest]]:
        """Tear down a sharded pod whose SECONDARY member died
        (frontend.py:896-920): the primary engine lives but the pod lost a
        member, so the instance dies crash-style (no drain: a KV share is
        gone) and its unfinished requests strand for re-routing, slot
        occupants restarting from the prompt as after a primary crash."""
        eng = self.engines[p.node]
        inst = eng.instances.pop(p.inst_id, None)
        if inst is None:
            return []
        eng.scheduler.deregister(p.inst_id)
        strays: list[tuple[str, ServeRequest]] = []
        occupants = (inst.active if inst.batching == "static"
                     else inst.slots)
        for req in occupants:
            if req is None or req.done:
                continue
            req.tokens_out = []  # KV share lost: re-execute from scratch
            strays.append((p.fn, req))
        strays.extend((p.fn, req) for req in inst.queue)
        inst.queue.clear()
        inst.close()  # drops the engine-store weight refcount
        if self.model_store is not None:
            self.model_store.release(p.node, p.fn)
        return strays

    def migrate(self, fn: str, handle: str, model: Model, params: Any,
                target: int) -> Optional[str]:
        """Live KV migration: move the instance behind ``handle`` to node
        ``target`` with zero dropped in-flight requests.

        The protocol is pause -> gather -> merge -> re-route: admission and
        decode pause on the source, a fresh instance (same data-plane
        config) deploys into a reserved rectangle on the target, every
        occupied decode slot's cache entry is gathered
        (``Model.gather_slot`` / ``gather_pages``) and merged into the same
        slot of the target (``merge_slot`` / page re-append), queued
        requests re-route, and only then does the source close and release
        its rectangle.  Remaining decode rounds produce bit-identical
        tokens.  Prefix sharing re-establishes on the target as the slots
        import: the first cohort member to land registers its full prompt
        blocks, later members map them read-only instead of re-writing
        them (``import_slot``).  Returns the new ``node:inst_id`` handle,
        or None when the
        instance cannot move (static batch, retired, target full or dead).
        """
        node_s, inst_id = handle.split(":", 1)
        src = int(node_s)
        if target == src or not 0 <= target < len(self.engines):
            return None
        if not self.engines[target].alive:
            return None
        eng = self.engines[src]
        inst = eng.instances.get(inst_id)
        if inst is None or inst.retired or inst.batching == "static":
            return None
        if inst.group is not None:
            # Sharded pods do not migrate: the KV lives as one share per
            # member and a target would need a like group; the reconciler
            # re-places instead.
            return None
        if inst.speculate is not None:
            # The draft's side pool and the key stream do not export:
            # speculating pods scale, they do not migrate.
            return None
        mm = self._fn_mm.get(fn)
        # Copy-then-delete: the target must admit the instance while the
        # source still holds its memory.
        if mm is None or not self.admits(target, fn, mm):
            return None
        pod_id = f"{fn}-{next(self._pod_seq)}"
        exclude = {n.node_id for n in self.pool.nodes} - {target}
        alloc = eng.scheduler.pods[inst_id].alloc
        placement = self.pool.schedule(alloc, pod_id, exclude=exclude)
        if placement is None:
            return None
        if placement.node != target:
            self.pool.release(placement)
            return None
        event = None
        deploy_params = params
        if self.model_store is not None:
            deploy_params, event = self._acquire(target, fn, model, params,
                                                 None)
        inst.paused = True  # pause admission + decode while the KV moves
        try:
            new_inst_id = self.engines[target].deploy(
                fn, model, deploy_params, alloc, n_instances=1,
                max_batch=inst.max_batch, max_len=inst.max_len,
                batching=inst.batching,
                block_size=getattr(inst, "block_size", 16),
                n_kv_blocks=(inst.allocator.n_blocks
                             if inst.batching == "paged" else None),
                fused=inst.fused,
                prefix_sharing=inst.prefix_sharing,
                sampling=inst.sampling)[0]
        except Exception:
            self.pool.release(placement)
            if self.model_store is not None:
                self.model_store.release(target, fn)
            inst.paused = False
            raise
        if event is not None:
            self._cold_instances.append((event, target, new_inst_id))
        new_inst = self.engines[target].instances[new_inst_id]
        # Gather -> merge, slot by slot: same slot index on the target, so
        # the decode batch resumes exactly where it paused.
        for slot, req in enumerate(inst.slots):
            if req is None:
                continue
            new_inst.import_slot(slot, *inst.export_slot(slot))
            inst.slots[slot] = None
            if inst.batching == "paged":
                inst._release_paged(slot)
        # Re-route queued (not yet admitted) requests to the new instance.
        new_inst.queue.extend(inst.queue)
        inst.queue.clear()
        self.placements.append(InstancePlacement(
            fn=fn, inst_id=new_inst_id, node=target, placement=placement))
        # The source is now empty: retiring it closes immediately and
        # releases its rectangle + weight refcount via on_instance_closed.
        eng.retire(inst_id)
        return f"{target}:{new_inst_id}"

    def _instance_closed(self, node: int, inst_id: str) -> None:
        """Engine callback: a retired instance finished draining."""
        for p in self.placements:
            if p.node == node and p.inst_id == inst_id:
                for rect in p.all_placements():
                    self.pool.release(rect)
                self.placements.remove(p)
                if self.model_store is not None:
                    # The pod's hold on its host-staged weights ends here;
                    # the entry stays cached (evictable) for the next
                    # scale-up to hit warm.
                    self.model_store.release(node, p.fn)
                    if p.fn in self._fn_draft:
                        self.model_store.release(node, f"{p.fn}#draft")
                if not any(q.fn == p.fn for q in self.placements):
                    # Fully drained: drop the per-function MemoryModel so a
                    # redeploy may use a different data-plane config.
                    self._fn_mm.pop(p.fn, None)
                    self._fn_draft.discard(p.fn)
                return

    # -- metrics -----------------------------------------------------------

    def observed_rps(self, fn: str, window: float) -> float:
        """Submit rate over the trailing wall-clock ``window`` seconds."""
        return observed_rate(self._arrival_log, self._rps_horizon,
                             fn, window, self.now())

    def inflight(self, fn: str) -> int:
        """Queued + slot-occupying requests across the function's
        instances (draining ones included)."""
        return sum(self._fn_load(node, fn) for node in self.nodes_for(fn))

    def occupancy(self, last_n: int = 10) -> float:
        live = [e for e in self.engines if e.instances]
        if not live:
            return 0.0
        return sum(e.scheduler.occupancy(last_n) for e in live) / len(live)

    def utilization(self, last_n: int = 10) -> float:
        live = [e for e in self.engines if e.instances]
        if not live:
            return 0.0
        return sum(e.scheduler.utilization(last_n) for e in live) / len(live)

    def memory_bytes(self) -> int:
        return sum(e.memory_bytes() for e in self.engines)

    def kv_bytes_in_use(self) -> int:
        """Physical KV bytes live requests hold across the fleet."""
        return sum(e.kv_bytes_in_use() for e in self.engines)

    def dense_kv_reserved(self) -> int:
        """Dense slot-pool reservation for the fleet's current capacity."""
        return sum(e.dense_kv_reserved() for e in self.engines)

    def kv_bytes_saved(self) -> int:
        """Bytes prefix sharing is saving fleet-wide right now (extra
        block references minus reserved COW spares, in bytes)."""
        return sum(e.kv_bytes_saved() for e in self.engines)

    def cold_start_events(self) -> list[ColdStartEvent]:
        """Every placement's trip through the weight tier, with
        time-to-first-token resolved lazily: ``ttft_s`` fills in once the
        placed instance lands its first token (``first_token_at``)."""
        out = []
        for event, node, inst_id in self._cold_instances:
            if event.ttft_s is None:
                inst = self.engines[node].instances.get(inst_id)
                first = inst.first_token_at if inst is not None else None
                if first is not None:
                    event.ttft_s = first - event.placed_at
            out.append(event)
        return out

    def kv_shared_fraction(self) -> float:
        """Observed shared fraction: saved / (in_use + saved) — the honest
        value to feed back into ``kv_shared_frac`` / profile tables."""
        saved = self.kv_bytes_saved()
        live = self.kv_bytes_in_use()
        return saved / (saved + live) if saved + live > 0 else 0.0

    def recorder(self, fn: str):
        """Merged view is unnecessary: latency records live per node."""
        return [e.recorders[fn] for e in self.engines if fn in e.recorders]
