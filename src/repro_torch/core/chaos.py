"""Deterministic chaos harness: one seeded fault schedule, two fleets.

Robustness claims are only credible when the faults that back them are
reproducible.  This module separates chaos into three pieces so the SAME
schedule can be replayed against the simulator and the live torch fleet:

* **ChaosSchedule** — a frozen, seeded list of :class:`FaultEvent`s.
  ``ChaosSchedule.generate(seed, ...)`` derives every event (time, kind,
  node, magnitude, duration) from its own ``np.random.default_rng(seed)``
  — no wall-clock randomness, so two runs with the same seed inject
  byte-identical fault sequences.
* **Targets** — thin adapters mapping each fault kind onto one backend:
  ``SimChaosTarget`` over ``repro_torch.core.cluster.Cluster`` and
  ``LiveChaosTarget`` over ``repro_torch.serving.frontend.ClusterFrontend``.
  Every non-kill fault returns an undo closure, so bounded-duration
  faults restore cleanly.
* **ChaosInjector** — the clock-agnostic replayer: ``advance(now)``
  applies every event (and expires every bounded fault) whose time has
  come, in deterministic order.  The caller owns the clock — virtual
  ticks for the simulator, wall time for the live fleet — which is what
  lets one schedule drive both through identical logical timelines.

Fault kinds and their per-backend semantics:

==============  ==================================  =========================
kind            simulator                           live fleet
==============  ==================================  =========================
``kill``        ``Cluster.fail_node``               ``ClusterFrontend.fail_node``
``straggler``   ``Node.slowdown *= magnitude``      ``engine.pump_delay_s`` +=
                (rounds dilate, health EWMA          unit x (magnitude - 1)
                rises toward magnitude)              (passes dilate inside the
                                                     timed region)
``link``        all links touching ``node``         same, through the shared
                divided by ``magnitude``             ``NetworkLinks`` table
``kv_pressure`` ``Node.mem_bytes /= magnitude``     fleet admission budget
                (per-node admission shrinks)         ``mem_bytes /= magnitude``
==============  ==================================  =========================

``kill`` is permanent (restore would be resurrection); the other kinds
honour ``duration`` and restore exactly what they changed.
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
from typing import Any, Callable, Optional

import numpy as np

FAULT_KINDS = ("kill", "straggler", "link", "kv_pressure")


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault: ``kind`` hits ``node`` at time ``at``.

    ``magnitude`` is the severity knob (slowdown factor for stragglers,
    bandwidth/memory divisor for link/kv faults; ignored by ``kill``).
    ``duration`` bounds non-kill faults — the injector restores the
    original state at ``at + duration``; None means permanent.
    """

    at: float
    kind: str
    node: int
    magnitude: float = 2.0
    duration: Optional[float] = None

    def __post_init__(self) -> None:
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}")
        if self.at < 0:
            raise ValueError(f"fault time must be >= 0, got {self.at}")
        if self.kind != "kill" and self.magnitude <= 1.0:
            raise ValueError(
                f"{self.kind} magnitude must be > 1, got {self.magnitude}")
        if self.duration is not None and self.duration <= 0:
            raise ValueError(f"duration must be > 0, got {self.duration}")


@dataclasses.dataclass(frozen=True)
class ChaosSchedule:
    """A frozen fault timeline, optionally derived from a seed."""

    events: tuple[FaultEvent, ...]
    seed: int = 0

    @classmethod
    def generate(cls, seed: int, *, duration: float, n_nodes: int,
                 n_events: int = 6,
                 kinds: tuple[str, ...] = FAULT_KINDS,
                 max_kills: Optional[int] = None,
                 fault_duration: float | None = None) -> "ChaosSchedule":
        """Derive a schedule entirely from ``seed`` (deterministic).

        Kills draw nodes without replacement and are capped at
        ``max_kills`` (default ``n_nodes - 1``) so at least one node
        survives; non-kill faults get ``fault_duration`` (default a
        quarter of the horizon) and a magnitude in [2, 5).
        """
        if n_nodes < 1:
            raise ValueError("need at least one node")
        rng = np.random.default_rng(seed)
        if max_kills is None:
            max_kills = n_nodes - 1
        if fault_duration is None:
            fault_duration = duration / 4.0
        killable = list(rng.permutation(n_nodes))
        events = []
        for _ in range(n_events):
            kind = kinds[int(rng.integers(len(kinds)))]
            at = float(rng.uniform(0.0, duration))
            if kind == "kill":
                if max_kills <= 0 or not killable:
                    kind = "straggler"  # kill budget spent: degrade instead
                else:
                    max_kills -= 1
                    events.append(FaultEvent(at=at, kind="kill",
                                             node=int(killable.pop())))
                    continue
            events.append(FaultEvent(
                at=at, kind=kind, node=int(rng.integers(n_nodes)),
                magnitude=float(rng.uniform(2.0, 5.0)),
                duration=float(fault_duration)))
        events.sort(key=lambda e: (e.at, e.node, e.kind))
        return cls(events=tuple(events), seed=seed)


class SimChaosTarget:
    """Fault application over the discrete-event ``Cluster``."""

    def __init__(self, cluster: Any):
        self.cluster = cluster

    def kill(self, node: int) -> None:
        if self.cluster.nodes[node].alive:
            self.cluster.fail_node(node)
        return None

    def straggler(self, node: int, magnitude: float) -> Callable[[], None]:
        n = self.cluster.nodes[node]
        prev = n.slowdown
        n.slowdown = prev * magnitude

        def undo() -> None:
            n.slowdown = prev
        return undo

    def link(self, node: int, magnitude: float) -> Callable[[], None]:
        links = self.cluster.links
        prev = {other: links.bandwidth(node, other)
                for other in range(links.n_nodes) if other != node}
        for other, bps in prev.items():
            links.set_link(node, other, bps / magnitude)

        def undo() -> None:
            for other, bps in prev.items():
                links.set_link(node, other, bps)
        return undo

    def kv_pressure(self, node: int, magnitude: float) -> Callable[[], None]:
        n = self.cluster.nodes[node]
        prev = n.mem_bytes
        n.mem_bytes = int(prev / magnitude)

        def undo() -> None:
            n.mem_bytes = prev
        return undo


class LiveChaosTarget:
    """Fault application over the live ``ClusterFrontend``.

    ``straggler_unit_s`` converts the schedule's dimensionless slowdown
    factor into the engine's pump-delay hook: a magnitude-M straggler
    sleeps ``unit x (M - 1)`` seconds INSIDE each pass's timed region, so
    the degradation shows up in both the health EWMAs and the token
    scheduler's measured quota usage — a gray failure, not a crash.
    """

    def __init__(self, frontend: Any, straggler_unit_s: float = 0.02):
        self.frontend = frontend
        self.straggler_unit_s = straggler_unit_s

    def kill(self, node: int) -> None:
        if self.frontend.engines[node].alive:
            self.frontend.fail_node(node)
        return None

    def straggler(self, node: int, magnitude: float) -> Callable[[], None]:
        eng = self.frontend.engines[node]
        prev = eng.pump_delay_s
        eng.pump_delay_s = prev + self.straggler_unit_s * (magnitude - 1.0)

        def undo() -> None:
            eng.pump_delay_s = prev
        return undo

    def link(self, node: int, magnitude: float) -> Callable[[], None]:
        links = self.frontend.links
        prev = {other: links.bandwidth(node, other)
                for other in range(links.n_nodes) if other != node}
        for other, bps in prev.items():
            links.set_link(node, other, bps / magnitude)

        def undo() -> None:
            for other, bps in prev.items():
                links.set_link(node, other, bps)
        return undo

    def kv_pressure(self, node: int, magnitude: float) -> Callable[[], None]:
        # The live admission budget is fleet-wide (one mem_bytes for all
        # nodes), so KV pressure squeezes every node's headroom at once.
        prev = self.frontend.mem_bytes
        self.frontend.mem_bytes = int(prev / magnitude)

        def undo() -> None:
            self.frontend.mem_bytes = prev
        return undo


class ChaosInjector:
    """Replay one schedule against one target, clock supplied by caller.

    ``advance(now)`` applies every not-yet-applied event with
    ``event.at <= now`` (and runs every due restore) in deterministic
    (time, insertion) order.  Call it at the top of each control tick with
    the same logical timestamps on both backends and the two fleets see
    identical fault histories.
    """

    def __init__(self, schedule: ChaosSchedule, target: Any):
        self.schedule = schedule
        self.target = target
        self._seq = itertools.count()
        # (time, seq, fn): applies and restores share one heap so a
        # restore due before a later fault runs first.
        self._heap: list[tuple[float, int, Callable[[], Any]]] = []
        for ev in schedule.events:
            heapq.heappush(self._heap,
                           (ev.at, next(self._seq),
                            lambda e=ev: self._apply(e)))
        self.applied: list[tuple[float, FaultEvent]] = []

    def _apply(self, ev: FaultEvent) -> None:
        undo = getattr(self.target, ev.kind)(**self._kwargs(ev))
        self.applied.append((ev.at, ev))
        if undo is not None and ev.duration is not None:
            heapq.heappush(self._heap,
                           (ev.at + ev.duration, next(self._seq), undo))

    @staticmethod
    def _kwargs(ev: FaultEvent) -> dict[str, Any]:
        if ev.kind == "kill":
            return {"node": ev.node}
        return {"node": ev.node, "magnitude": ev.magnitude}

    def advance(self, now: float) -> int:
        """Apply everything due at or before ``now``; returns the number
        of actions (faults + restores) executed."""
        n = 0
        while self._heap and self._heap[0][0] <= now + 1e-12:
            _, _, fn = heapq.heappop(self._heap)
            fn()
            n += 1
        return n

    def pending(self) -> int:
        """Scheduled actions (faults or restores) not yet due."""
        return len(self._heap)
