"""SLO accounting: tiers, deadlines, retry policy, and goodput recording."""

from __future__ import annotations

import bisect
import dataclasses
from typing import Optional

import numpy as np

# ---------------------------------------------------------------------------
# SLO tiers and typed request outcomes
# ---------------------------------------------------------------------------

#: Never shed, never expired, retried without bound: losing one is a bug.
TIER_GUARANTEED = "guaranteed"
#: The default: sheddable under load, bounded retries.  Dormant unless a
#: deadline is configured — with no deadline the tier behaves exactly like
#: the pre-SLO plane.
TIER_BEST_EFFORT = "best_effort"
#: Preemptible batch lane: same shedding rules as best-effort, but queued
#: BEHIND every non-batch request (guaranteed/best-effort admissions insert
#: ahead of parked batch work).
TIER_BATCH = "batch"

SLO_TIERS = (TIER_GUARANTEED, TIER_BEST_EFFORT, TIER_BATCH)

#: Typed request outcomes (the "reject fast" contract): a request that will
#: not complete gets exactly one of these instead of parking forever.
OUTCOME_SHED = "shed"          # rejected at admission: cannot make deadline
OUTCOME_EXPIRED = "expired"    # deadline passed while queued
OUTCOME_REJECTED = "rejected"  # function unregistered / no longer servable
OUTCOME_FAILED = "failed"      # retry budget exhausted after failures


def deadline_budget(tier: str, deadline_s: Optional[float],
                    slo_latency: Optional[float]) -> Optional[float]:
    """Per-request deadline budget (seconds from arrival), or None.

    An explicit ``deadline_s`` always wins; a non-best-effort tier falls
    back to the latency SLO; the default (best-effort, no deadline) yields
    None — the whole deadline machinery stays dormant.
    """
    if deadline_s is not None:
        return deadline_s
    if tier != TIER_BEST_EFFORT:
        return slo_latency
    return None


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded jittered-backoff retry for stranded/timed-out requests.

    All randomness comes from the policy's own seeded PRNG stream — no
    wall-clock entropy ever enters a scheduling decision, so two fleets
    constructed with the same seed retry at identical offsets.
    """

    max_attempts: int = 3
    base_s: float = 0.05
    multiplier: float = 2.0
    jitter: float = 0.5      # fraction of the backoff added as U[0, jitter)
    seed: int = 0

    def __post_init__(self) -> None:
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        if self.base_s < 0 or self.multiplier < 1.0:
            raise ValueError("base_s >= 0 and multiplier >= 1 required")
        if not 0.0 <= self.jitter <= 1.0:
            raise ValueError("jitter must be in [0, 1]")
        object.__setattr__(self, "_rng",
                           np.random.default_rng(self.seed))

    def delay(self, attempt: int) -> float:
        """Backoff before retry number ``attempt`` (1-based)."""
        base = self.base_s * self.multiplier ** max(attempt - 1, 0)
        rng = getattr(self, "_rng")
        return base * (1.0 + self.jitter * float(rng.random()))

    def exhausted(self, attempt: int) -> bool:
        return attempt >= self.max_attempts


def record_arrival(log: dict[str, list[float]], horizons: dict[str, float],
                   fn: str, now: float, retention: float = 60.0) -> None:
    """Append an arrival timestamp with append-side pruning.

    Entries older than the largest observation window asked of ``fn`` (or
    ``retention``, whichever is larger) are dropped opportunistically, so
    the log stays bounded even when nobody ever polls ``observed_rate``
    (e.g. a spec with an explicit target-RPS source).
    """
    ts = log.setdefault(fn, [])
    ts.append(now)
    horizon = max(horizons.get(fn, 0.0), retention)
    if len(ts) > 1024 and ts[0] < now - 2 * horizon:
        del ts[:bisect.bisect_right(ts, now - horizon)]


def observed_rate(log: dict[str, list[float]], horizons: dict[str, float],
                  fn: str, window: float, now: float) -> float:
    """Trailing-window event rate over a per-function timestamp log.

    Prunes opportunistically: timestamps older than the largest window
    ever asked of ``fn`` are dropped, so long-lived gateways don't grow
    their arrival logs without bound.
    """
    if window <= 0:
        return 0.0
    ts = log.get(fn)
    if not ts:
        return 0.0
    horizons[fn] = max(window, horizons.get(fn, 0.0))
    cut = bisect.bisect_right(ts, now - horizons[fn])
    if cut:
        del ts[:cut]
    lo = bisect.bisect_right(ts, now - window)
    return (len(ts) - lo) / window


@dataclasses.dataclass
class SLORecorder:
    """Streaming latency recorder for one function.

    Beyond latency percentiles it tracks the *goodput* view: a completion
    is counted deadline-met or deadline-missed, and the non-completions
    (shed at admission, expired in queue, lost to retry exhaustion) are
    tallied so ``goodput()`` is honest about every request the gateway
    accepted responsibility for.
    """

    fn: str
    slo_latency: Optional[float] = None  # seconds; None = best-effort
    latencies: list[float] = dataclasses.field(default_factory=list)
    completion_times: list[float] = dataclasses.field(default_factory=list)
    deadline_met: int = 0
    deadline_missed: int = 0
    shed: int = 0
    expired: int = 0
    lost: int = 0

    def record(self, latency: float, completed_at: float,
               deadline_met: Optional[bool] = None) -> None:
        self.latencies.append(latency)
        self.completion_times.append(completed_at)
        # A request with no deadline (the dormant default) counts as met.
        if deadline_met is None or deadline_met:
            self.deadline_met += 1
        else:
            self.deadline_missed += 1

    def record_shed(self) -> None:
        self.shed += 1

    def record_expired(self) -> None:
        self.expired += 1

    def record_lost(self) -> None:
        self.lost += 1

    def goodput(self) -> float:
        """Fraction of accepted-or-offered requests that completed in time."""
        total = (self.deadline_met + self.deadline_missed
                 + self.shed + self.expired + self.lost)
        if total == 0:
            return 1.0
        return self.deadline_met / total

    def count(self) -> int:
        return len(self.latencies)

    def percentile(self, q: float, since: float = 0.0) -> float:
        lats = self._window(since)
        return float(np.percentile(lats, q)) if lats else 0.0

    def p50(self, since: float = 0.0) -> float:
        return self.percentile(50, since)

    def p99(self, since: float = 0.0) -> float:
        return self.percentile(99, since)

    def violation_ratio(self, since: float = 0.0) -> float:
        """Fraction of requests exceeding the SLO (paper: <=1% for ResNet)."""
        if self.slo_latency is None:
            return 0.0
        lats = self._window(since)
        if not lats:
            return 0.0
        return sum(1 for l in lats if l > self.slo_latency) / len(lats)

    def throughput(self, t_start: float, t_end: float) -> float:
        lo = bisect.bisect_left(self.completion_times, t_start)
        hi = bisect.bisect_right(self.completion_times, t_end)
        dur = max(t_end - t_start, 1e-9)
        return (hi - lo) / dur

    def _window(self, since: float) -> list[float]:
        if since <= 0.0:
            return self.latencies
        lo = bisect.bisect_left(self.completion_times, since)
        return self.latencies[lo:]
