"""Heuristic Scaling Algorithm (paper Alg. 1).

Given each function's RPS processing gap ``ΔRPS_j`` and the profile table
``P = {<F_j, S_p, Q_p, T_p>}`` from the FaST-Profiler, emit scale-up /
scale-down configuration decisions:

* Scale **up** (``ΔRPS_j >= 0``): choose the most *efficient* profile point
  ``p_eff = argmax_p RPR`` where ``RPR = T_p / (S_p * Q_p)`` ("RPS per
  Resource"); deploy ``n = floor(ΔRPS / T_eff)`` pods of it, then one
  minimal-but-sufficient ``p_ideal = argmin_p (T_p - r)`` with ``T_p > r``
  for the residual ``r``.
* Scale **down** (``ΔRPS_j < 0``): pop lowest-RPR running pods (the ``L_j``
  priority queue is kept in ascending RPR) while removing a pod keeps the
  remaining capacity sufficient (``ΔR + T_i <= 0``).
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
import math
from typing import Iterable, Optional

from repro_torch.core.resources import Alloc


@dataclasses.dataclass(frozen=True)
class ProfilePoint:
    """One profiler measurement: throughput T at allocation (S, Q)."""

    sm: float
    quota: float
    throughput: float  # requests/second
    p99_latency: float = 0.0  # seconds, used for SLO-feasibility filtering
    # Paged-KV block budget (TOTAL pool, incl. the null page) handed to an
    # instance placed at this point.  profile_points stamps one shared
    # budget on every point of a table — it does not scale with (sm, quota).
    # 0 = not profiled / dense slot pool.
    kv_blocks: int = 0
    # Shared-fraction axis: the profiled fraction of KV blocks expected to
    # be prefix-shared duplicates at this point's workload (0 = unshared /
    # not profiled).  ``paged_kv_capacity`` folds it into kv_blocks and the
    # live frontend discounts its KV admission charge by it — honest
    # over-admission backed by the engine's per-request worst-case
    # reservation and validated by observed ``kv_bytes_saved``.
    kv_shared_frac: float = 0.0
    # Speculation axis: the profiled speculation depth and the measured
    # draft-token acceptance fraction at this point's workload.  When
    # ``spec_k > 0`` the point's ``throughput`` is already *effective*
    # (verify rounds x expected_tokens_per_round(spec_k, acceptance)), so
    # Alg. 1 budgets real emitted tokens/s — 0 = not speculating.
    spec_k: int = 0
    acceptance: float = 0.0
    # Tensor-parallel axis: devices one pod of this point spans.  A sharded
    # point's ``throughput`` is the *aggregate* rate of the whole pod (the
    # profiler measures the pod, not a member), so Alg. 1 needs no special
    # casing — but its RPR divides by the full resource footprint below.
    shards: int = 1

    def __post_init__(self) -> None:
        if self.shards < 1:
            raise ValueError(f"shards must be >= 1, got {self.shards}")
        if not 0.0 <= self.kv_shared_frac < 1.0:
            raise ValueError(
                f"kv_shared_frac must be in [0, 1), got "
                f"{self.kv_shared_frac}")
        if self.spec_k < 0:
            raise ValueError(f"spec_k must be >= 0, got {self.spec_k}")
        if not 0.0 <= self.acceptance <= 1.0:
            raise ValueError(
                f"acceptance must be in [0, 1], got {self.acceptance}")
        if self.acceptance > 0.0 and self.spec_k == 0:
            raise ValueError("acceptance > 0 needs spec_k > 0")

    @property
    def rpr(self) -> float:
        """RPS per Resource = T / (shards * S * Q).

        A sharded pod occupies one (S, Q) rectangle on *each* member
        device, so efficiency divides by the whole footprint — otherwise
        Alg. 1 would prefer an N-way pod over N independent pods with the
        same aggregate throughput despite identical resource use.
        """
        return self.throughput / (self.shards * self.sm * self.quota)

    def to_alloc(self, elastic_limit: float | None = None,
                 mem_bytes: int = 0) -> Alloc:
        limit = self.quota if elastic_limit is None else max(self.quota, elastic_limit)
        return Alloc(sm=self.sm, quota_request=self.quota,
                     quota_limit=limit, mem_bytes=mem_bytes)


def expected_tokens_per_round(k: int, acceptance: float) -> float:
    """Expected emitted tokens per speculative verify round under i.i.d.
    per-position acceptance probability ``a``: sum_{i=0..k} a^i =
    (1 - a^(k+1)) / (1 - a), saturating at ``k + 1`` for a = 1.  The factor
    the profiler scales verify-round throughput by to get *effective*
    tokens/s (the canonical definition; ``repro_torch.serving.speculative``
    re-exports it)."""
    if k <= 0:
        return 1.0
    a = min(max(acceptance, 0.0), 1.0)
    if a >= 1.0:
        return float(k + 1)
    return (1.0 - a ** (k + 1)) / (1.0 - a)


@dataclasses.dataclass(frozen=True)
class ScaleDecision:
    function: str
    point: ProfilePoint
    direction: int  # +1 scale-up, -1 scale-down
    # Scale-down: the concrete victim pod.  Scale-up: the provisional id the
    # algorithm pushed into L_j; the deployer replaces it with the real pod id
    # (or removes it if placement fails).
    pod_id: Optional[str] = None


@dataclasses.dataclass(order=True)
class _RunningPod:
    rpr: float
    seq: int
    pod_id: str = dataclasses.field(compare=False)
    point: ProfilePoint = dataclasses.field(compare=False)


class FunctionPodQueue:
    """Per-function priority queue L_j, ascending RPR (Alg. 1 input).

    Scale-up entries start *provisional*: Alg. 1 reserves capacity under a
    fresh pod id before any deployer has run, so repeated gap computations
    don't double-provision.  The deployer then settles each reservation with
    :meth:`confirm` (placement succeeded — re-key to the real pod id) or
    :meth:`abort` (placement failed — drop the reservation), keeping
    ``capacity()`` from drifting above what is actually running.
    """

    def __init__(self) -> None:
        self._heap: list[_RunningPod] = []
        self._ids: set[str] = set()  # pushed and not yet removed/popped
        self._dead: set[str] = set()
        self._seq = itertools.count()
        self._provisional: dict[str, ProfilePoint] = {}

    def push(self, pod_id: str, point: ProfilePoint) -> None:
        self._ids.add(pod_id)
        heapq.heappush(self._heap, _RunningPod(point.rpr, next(self._seq),
                                               pod_id, point))

    def push_provisional(self, pod_id: str, point: ProfilePoint) -> None:
        """Reserve capacity for a pod the deployer has not placed yet."""
        self._provisional[pod_id] = point
        self.push(pod_id, point)

    def confirm(self, provisional_id: str, real_id: str) -> None:
        """Placement succeeded: swap the reservation for the real pod id."""
        point = self._provisional.pop(provisional_id)
        self.remove(provisional_id)
        self.push(real_id, point)

    def abort(self, provisional_id: str) -> None:
        """Placement failed: release the reserved capacity."""
        self._provisional.pop(provisional_id)
        self.remove(provisional_id)

    def provisional_ids(self) -> set[str]:
        return set(self._provisional)

    def __contains__(self, pod_id: str) -> bool:
        return pod_id in self._ids

    def rekey(self, old_id: str, new_id: str) -> None:
        """Re-key a live entry (pod migration): same profile point, same
        capacity, a new concrete pod id.  Raises ``KeyError`` when
        ``old_id`` is not a live entry."""
        if old_id not in self._ids:
            raise KeyError(f"pod {old_id!r} is not in the queue")
        point = next(p.point for p in self._heap
                     if p.pod_id == old_id and p.pod_id not in self._dead)
        self.remove(old_id)
        self.push(new_id, point)

    def remove(self, pod_id: str) -> None:
        # No-op for ids never pushed (e.g. untracked pods a shared teardown
        # path retires) — a lazy tombstone for them would never be GC'd.
        if pod_id in self._ids:
            self._ids.discard(pod_id)
            self._dead.add(pod_id)

    def _gc(self) -> None:
        while self._heap and self._heap[0].pod_id in self._dead:
            self._dead.discard(heapq.heappop(self._heap).pod_id)

    def front(self) -> Optional[_RunningPod]:
        self._gc()
        return self._heap[0] if self._heap else None

    def pop(self) -> _RunningPod:
        self._gc()
        pod = heapq.heappop(self._heap)
        self._ids.discard(pod.pod_id)
        return pod

    def __len__(self) -> int:
        self._gc()
        return sum(1 for p in self._heap if p.pod_id not in self._dead)

    def capacity(self) -> float:
        self._gc()
        return sum(p.point.throughput for p in self._heap
                   if p.pod_id not in self._dead)


def heuristic_scale(
    delta_rps: dict[str, float],
    profiles: dict[str, list[ProfilePoint]],
    queues: dict[str, FunctionPodQueue],
    slo_latency: dict[str, float] | None = None,
) -> list[ScaleDecision]:
    """Paper Algorithm 1. Mutates ``queues`` to reflect the decisions.

    ``slo_latency`` optionally filters profile points whose measured p99
    exceeds the function's SLO — a point that violates latency cannot be used
    no matter how efficient (FaST-Profiler records latency for exactly this).

    Scale-up entries are pushed as *provisional* reservations; the caller
    must settle each one with ``queue.confirm(pod_id, real_id)`` once the
    deployer places the pod, or ``queue.abort(pod_id)`` when placement
    fails, before the next scaling pass reads ``capacity()``.  Scale-down
    decisions pop concrete running pods; the caller evicts them.
    """
    cfgs: list[ScaleDecision] = []
    for fn, gap in delta_rps.items():
        points = profiles[fn]
        if slo_latency and fn in slo_latency:
            feasible = [p for p in points if p.p99_latency <= slo_latency[fn]]
            points = feasible or points  # degrade gracefully if none feasible
        if not points:
            raise ValueError(f"no profile points for function {fn}")
        queue = queues.setdefault(fn, FunctionPodQueue())
        if gap >= 0:
            if gap == 0:
                continue
            p_eff = max(points, key=lambda p: p.rpr)
            t_eff = p_eff.throughput
            n = math.floor(gap / t_eff)
            r = gap - n * t_eff
            for _ in range(n):
                pid = _fresh_pod_id(fn)
                cfgs.append(ScaleDecision(fn, p_eff, +1, pod_id=pid))
                queue.push_provisional(pid, p_eff)
            if r > 0:
                # Minimal sufficient residual config: argmin (T_p - r), T_p > r.
                candidates = [p for p in points if p.throughput > r]
                if candidates:
                    p_ideal = min(candidates, key=lambda p: p.throughput - r)
                else:  # residual exceeds every point: one more p_eff pod
                    p_ideal = p_eff
                pid = _fresh_pod_id(fn)
                cfgs.append(ScaleDecision(fn, p_ideal, +1, pod_id=pid))
                queue.push_provisional(pid, p_ideal)
        else:
            delta_r = gap
            while delta_r < 0 and len(queue) > 0:
                front = queue.front()
                assert front is not None
                # Only remove while the remaining pods still cover the load.
                if delta_r + front.point.throughput <= 0:
                    queue.pop()
                    cfgs.append(ScaleDecision(fn, front.point, -1,
                                              pod_id=front.pod_id))
                    delta_r += front.point.throughput
                else:
                    break
    return cfgs


_pod_counter = itertools.count()


def _fresh_pod_id(fn: str) -> str:
    return f"{fn}-pod-{next(_pod_counter)}"


def processing_gap(predicted_rps: dict[str, float],
                   queues: dict[str, FunctionPodQueue]) -> dict[str, float]:
    """ΔRPS_j = R_j - Σ T_{j,i} over the function's running pods."""
    return {
        fn: rps - (queues[fn].capacity() if fn in queues else 0.0)
        for fn, rps in predicted_rps.items()
    }
