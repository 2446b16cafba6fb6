"""Declarative per-function serving contract (``FunctionSpec``).

A spec is everything the control plane needs to serve one function — the
paper's per-function inputs to Alg. 1 gathered into a single declarative
object instead of imperative ``deploy()`` arguments:

* the **profile table** ``P_j = {<F_j, S_p, Q_p, T_p>}`` from the
  FaST-Profiler (``ProfilePoint``s, each with a measured p99),
* the **latency SLO** used to filter profile points to the feasible set,
* the **target-RPS source** ``R_j`` (a trace / predictor callable, or None
  to observe arrivals from the backend),
* data-plane options (model factory, batching mode, slot pool size) for
  the live backend, and the calibrated ``ServiceCurve`` for the simulator.

The same spec object drives both backends; that is what makes the
"replay the live fleet through the simulator" workflow possible.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Sequence

import numpy as np

from repro_torch.core.scaling import ProfilePoint
from repro_torch.core.slo import SLO_TIERS, TIER_BEST_EFFORT, deadline_budget
from repro_torch.core.workload import ServiceCurve

# A target-RPS source: virtual-or-wall time -> offered requests/second.
RPSSource = Callable[[float], float]

DEFAULT_FRAMEWORK_BYTES = 64 * 1024 * 1024


def ramp(steps: Sequence[tuple[float, float]]) -> RPSSource:
    """Piecewise-constant RPS schedule ``[(t_start, rps), ...]``.

    The canonical deterministic target-RPS source: both backends see the
    identical demand signal, so their scale-decision sequences can be
    compared bit-for-bit.
    """
    ordered = sorted(steps)

    def source(now: float) -> float:
        rps = 0.0
        for t0, r in ordered:
            if now >= t0:
                rps = r
            else:
                break
        return rps

    return source


class DemandSource:
    """A *predictive* target-RPS source fed from the backend arrival log.

    A plain ``RPSSource`` callable is an oracle (a declared trace); a
    ``DemandSource`` is a forecaster: the reconciler calls
    ``observe(now, rps)`` with the backend's trailing-window arrival rate
    at the top of every tick, then reads the one-tick-ahead forecast via
    ``__call__(now)``.  Construct one instance per control plane — the
    state is the forecast, so sharing a source between a live fleet and
    its simulator replay would double-feed it.
    """

    def observe(self, now: float, rps: float) -> None:
        raise NotImplementedError

    def __call__(self, now: float) -> float:
        raise NotImplementedError


class EWMADemand(DemandSource):
    """Exponentially-weighted moving average of observed RPS.

    ``level <- alpha * obs + (1 - alpha) * level``; the forecast is the
    level.  Reacts to an RPS step within ~``1/alpha`` ticks instead of
    waiting out the full trailing ``rps_window`` — shrinking the
    detection-lag SLO-violation window — while smoothing Poisson noise a
    raw last-window estimate passes straight through.
    """

    def __init__(self, alpha: float = 0.5):
        if not 0.0 < alpha <= 1.0:
            raise ValueError("need 0 < alpha <= 1")
        self.alpha = alpha
        self.level: Optional[float] = None

    def observe(self, now: float, rps: float) -> None:
        self.level = (rps if self.level is None
                      else self.alpha * rps + (1 - self.alpha) * self.level)

    def __call__(self, now: float) -> float:
        return max(self.level or 0.0, 0.0)


class HoltWintersDemand(DemandSource):
    """Holt-Winters (triple-exponential) forecast of observed RPS.

    Level + trend (Holt's linear method), plus an optional additive
    seasonal component of ``season`` ticks (set ``season=None`` for
    non-periodic traffic).  The trend term *extrapolates* a ramp one tick
    ahead instead of trailing it, so capacity is provisioned before the
    arrivals land; ``horizon`` scales how far ahead the trend projects.
    """

    def __init__(self, alpha: float = 0.5, beta: float = 0.3,
                 gamma: float = 0.2, season: Optional[int] = None,
                 horizon: float = 1.0):
        for name, v in (("alpha", alpha), ("beta", beta), ("gamma", gamma)):
            if not 0.0 < v <= 1.0:
                raise ValueError(f"need 0 < {name} <= 1")
        if season is not None and season < 2:
            raise ValueError("season needs at least 2 ticks")
        self.alpha, self.beta, self.gamma = alpha, beta, gamma
        self.season = season
        self.horizon = horizon
        self.level: Optional[float] = None
        self.trend = 0.0
        self._seasonal: list[float] = [0.0] * (season or 0)
        self._tick = 0

    def observe(self, now: float, rps: float) -> None:
        if self.level is None:
            self.level = rps
            self._tick += 1
            return
        s = (self._seasonal[self._tick % self.season]
             if self.season else 0.0)
        prev_level = self.level
        self.level = (self.alpha * (rps - s)
                      + (1 - self.alpha) * (self.level + self.trend))
        self.trend = (self.beta * (self.level - prev_level)
                      + (1 - self.beta) * self.trend)
        if self.season:
            i = self._tick % self.season
            self._seasonal[i] = (self.gamma * (rps - self.level)
                                 + (1 - self.gamma) * self._seasonal[i])
        self._tick += 1

    def __call__(self, now: float) -> float:
        if self.level is None:
            return 0.0
        s = (self._seasonal[self._tick % self.season]
             if self.season else 0.0)
        return max(self.level + self.horizon * self.trend + s, 0.0)


def autocorr_season(series: Sequence[float], *, min_lag: int = 2,
                    threshold: float = 0.3) -> Optional[int]:
    """Dominant period of an RPS series via its autocorrelation peak.

    Returns the lag (in ticks) of the highest *interior* local maximum of
    the normalized autocorrelation function at or beyond ``min_lag``, or
    ``None`` when no peak clears ``threshold`` — flat, monotone, or
    noise-dominated traffic has no season worth modelling, and feeding
    Holt-Winters a spurious one is worse than level+trend alone.  Requiring
    a local maximum (not a bare argmax) rejects the smooth ACF decay every
    trending series produces at the ``min_lag`` boundary.
    """
    x = np.asarray(list(series), dtype=float)
    n = x.size
    if n < 3 * min_lag:
        return None
    x = x - x.mean()
    denom = float(x @ x)
    if denom <= 0.0:
        return None
    max_lag = n // 2
    acf = np.array([float(x[:-k] @ x[k:]) / denom
                    for k in range(1, max_lag + 1)])
    best_lag: Optional[int] = None
    best_val = threshold
    for k in range(max(min_lag, 2), max_lag):
        i = k - 1
        if acf[i] > acf[i - 1] and acf[i] >= acf[i + 1] and acf[i] >= best_val:
            best_lag, best_val = k, float(acf[i])
    return best_lag


def fit_holt_winters(series: Sequence[float], *,
                     season: int | str | None = "auto",
                     horizon: float = 1.0,
                     grid: Sequence[float] = (0.1, 0.3, 0.5, 0.7, 0.9),
                     ) -> HoltWintersDemand:
    """Auto-tune a ``HoltWintersDemand`` on an observed RPS series.

    Replays every ``(alpha, beta, gamma)`` combination from ``grid``
    through a fresh forecaster over ``series`` (one observation per tick)
    and scores the one-step-ahead squared forecast error, skipping the
    first season of warm-up ticks.  ``season="auto"`` detects the period
    with :func:`autocorr_season`; pass an int to force one or ``None``
    for level+trend only (then ``gamma`` is inert and not searched).

    Returns a **fresh, unfed** forecaster carrying the winning parameters
    — hand it to ``FunctionSpec.target_rps`` and let the reconciler feed
    it live observations; replaying the fit series into it would
    double-count history the real arrivals are about to repeat.
    """
    xs = [float(v) for v in series]
    if season == "auto":
        season = autocorr_season(xs)
    if season is not None and not isinstance(season, int):
        raise TypeError(f"season must be int, None or 'auto', got {season!r}")
    warmup = season if season else 1
    gammas = tuple(grid) if season else (tuple(grid)[0],)
    best: Optional[tuple[float, float, float, float]] = None
    for a in grid:
        for b in grid:
            for g in gammas:
                hw = HoltWintersDemand(alpha=a, beta=b, gamma=g,
                                       season=season, horizon=horizon)
                err = 0.0
                for t, v in enumerate(xs):
                    if t >= warmup:
                        err += (hw(float(t)) - v) ** 2
                    hw.observe(float(t), v)
                if best is None or err < best[0]:
                    best = (err, a, b, g)
    assert best is not None
    _, a, b, g = best
    return HoltWintersDemand(alpha=a, beta=b, gamma=g, season=season,
                             horizon=horizon)


@dataclasses.dataclass(frozen=True)
class FunctionSpec:
    """Declarative serving contract for one function.

    Attributes:
      name: function id ``F_j``.
      profile: FaST-Profiler table ``P_j`` — one ``ProfilePoint`` per
        profiled ``(S_p, Q_p)`` allocation, with measured throughput
        ``T_p`` and p99 latency.
      slo_latency: latency SLO ``L_j`` in seconds; profile points whose
        measured p99 exceeds it are infeasible for Alg. 1.  None =
        best-effort.
      target_rps: demand source ``R_j(t)``; None means the reconciler asks
        the backend for the observed trailing-window arrival rate.  A
        ``DemandSource`` (``EWMADemand`` / ``HoltWintersDemand``) is fed
        the backend's observed rate every tick and forecasts ahead.
      rps_window: trailing horizon (seconds) for observed-RPS estimation.
      headroom: capacity over-provisioning factor (target utilization
        ``1/headroom``) so queueing delay stays bounded at the SLO.
      min_instances / max_instances: fleet-size clamps enforced by the
        reconciler on top of Alg. 1's decisions.
      elastic_limit: ``Q_limit`` for scaled-up pods (§3.3.2 elastic quota);
        None keeps ``Q_limit == Q_request``.
      model_factory: live backend only — builds ``(model, params)`` once at
        registration; instances share the params via the node ModelStore.
      max_batch / max_len / batching: live instance decode-slot options
        (``batching="paged"`` runs the block-paged KV data plane).
      block_size / n_kv_blocks: paged mode only — tokens per KV block and
        the per-instance physical block budget (None = the dense pool's
        worst case, so paging can only reduce bytes-in-use).  Profile
        tables record the matching capacity in ``ProfilePoint.kv_blocks``.
      prefix_sharing: paged mode only — content-hash prefix matching with
        copy-on-write (default on; False deploys the unshared reference
        plane).
      kv_shared_frac: shared-fraction admission axis — the declared
        fraction of KV blocks expected to be prefix-shared duplicates.
        The live frontend discounts its KV admission charge by it (honest
        over-admission; the engine still enforces worst-case per-request
        block reservations).  Profile tables carry the same axis in
        ``ProfilePoint.kv_shared_frac``; the larger of the two wins at
        placement.
      framework_bytes: per-instance runtime footprint charged by memory
        admission on the live path.
      cold_start_s: estimated scale-from-zero cold-start latency (origin
        fetch + staging + full weight upload) — the cold-start axis.  The
        simulator delays a freshly placed pod's first token grant by it
        (scaled down for host-warm / peer-warm nodes); the live path
        measures the real thing through the fleet model store and reports
        it in ``ClusterFrontend.cold_start_events()``.  0 keeps the
        legacy instant-ready model.
      speculate: speculative-decoding axis — a
        ``repro_torch.serving.speculative.SpecConfig`` (duck-typed here so the
        control plane stays import-free of the serving engine).  Live
        placements run the draft/verify round on the fused hot path; the
        profile table should carry the matching ``spec_k`` / ``acceptance``
        so Alg. 1 budgets *effective* tokens/s.  The simulator treats the
        axis as already folded into the profile throughputs, which keeps
        sim-vs-live decision signatures equal with the axis on.
      draft_factory: live backend only — builds the draft model's params
        once at registration (the draft config ships inside ``speculate``).
        Required when ``speculate`` is set on a live fleet; the weights are
        staged per node under ``"{fn}#draft"`` and admission charges them
        on top of the target weights.
      shards: tensor-parallel axis — devices each pod of this function
        spans.  1 (default) is today's single-device pod.  >1 makes every
        placement a multi-rectangle pod: the live backend acquires one MRA
        rectangle per member on the link-fastest device group, the
        simulator charges the same multi-node footprint and folds the
        collective cost into its round time.  A per-point
        ``ProfilePoint.shards`` may widen individual points further; the
        effective degree at placement is ``max(spec.shards,
        point.shards)``.  Mutually exclusive with ``speculate`` — the
        draft/verify round is not tensor-parallel.
      slo_tier: SLO tier of every request admitted under this spec —
        ``"guaranteed"`` (never shed or expired; retried without bound),
        ``"best_effort"`` (the default; sheddable once a deadline is
        configured), or ``"batch"`` (the preemptible lane: same shedding
        rules, but queued behind every non-batch request).
      deadline_s: per-request deadline budget in seconds from arrival.
        None (default) falls back to ``slo_latency`` for non-best-effort
        tiers and to *no deadline at all* for best-effort — so a spec that
        sets neither field runs the exact pre-SLO request lifecycle.
      curve: simulator backend only — the calibrated ``ServiceCurve``.
    """

    name: str
    profile: tuple[ProfilePoint, ...]
    slo_latency: Optional[float] = None
    slo_tier: str = TIER_BEST_EFFORT
    deadline_s: Optional[float] = None
    target_rps: Optional[RPSSource] = None
    rps_window: float = 2.0
    headroom: float = 1.2
    min_instances: int = 1
    max_instances: int = 32
    elastic_limit: Optional[float] = 1.0
    model_factory: Optional[Callable[[], tuple[Any, Any]]] = None
    max_batch: int = 4
    max_len: int = 64
    batching: str = "continuous"
    block_size: int = 16
    n_kv_blocks: Optional[int] = None
    prefix_sharing: bool = True
    kv_shared_frac: float = 0.0
    framework_bytes: int = DEFAULT_FRAMEWORK_BYTES
    cold_start_s: float = 0.0
    speculate: Optional[Any] = None
    draft_factory: Optional[Callable[[], Any]] = None
    shards: int = 1
    curve: Optional[ServiceCurve] = None

    def __post_init__(self) -> None:
        if not self.profile:
            raise ValueError(f"spec {self.name!r} needs a profile table")
        if not (0 <= self.min_instances <= self.max_instances):
            raise ValueError(
                f"need 0 <= min_instances <= max_instances, got "
                f"{self.min_instances}, {self.max_instances}")
        if self.batching not in ("continuous", "static", "paged"):
            raise ValueError(f"unknown batching mode {self.batching!r}")
        if self.batching == "paged":
            if self.block_size <= 0 or self.max_len % self.block_size:
                raise ValueError(
                    "block_size must be positive and divide max_len")
            if self.n_kv_blocks is not None and self.n_kv_blocks < 2:
                raise ValueError(
                    "n_kv_blocks needs the null page plus one usable "
                    "block (>= 2)")
        if not 0.0 <= self.kv_shared_frac < 1.0:
            raise ValueError(
                f"kv_shared_frac must be in [0, 1), got "
                f"{self.kv_shared_frac}")
        if self.kv_shared_frac > 0.0 and (self.batching != "paged"
                                          or not self.prefix_sharing):
            raise ValueError(
                "kv_shared_frac needs batching='paged' with prefix "
                "sharing enabled")
        if self.headroom < 1.0:
            raise ValueError("headroom < 1 provisions below offered load")
        if self.cold_start_s < 0.0:
            raise ValueError(
                f"cold_start_s must be >= 0, got {self.cold_start_s}")
        if self.speculate is not None:
            if self.batching == "static":
                raise ValueError(
                    "speculative decoding needs a slot batching mode "
                    "(continuous/paged)")
            if getattr(self.speculate, "k", 0) < 1:
                raise ValueError(
                    "speculate must be a SpecConfig-like object with k >= 1")
        if self.slo_tier not in SLO_TIERS:
            raise ValueError(
                f"slo_tier must be one of {SLO_TIERS}, got "
                f"{self.slo_tier!r}")
        if self.deadline_s is not None and self.deadline_s <= 0.0:
            raise ValueError(
                f"deadline_s must be positive, got {self.deadline_s}")
        if self.shards < 1:
            raise ValueError(f"shards must be >= 1, got {self.shards}")
        if self.shards > 1 and self.speculate is not None:
            raise ValueError(
                "speculate cannot ride a sharded pod: the draft/verify "
                "round is not tensor-parallel")

    def feasible_points(self) -> list[ProfilePoint]:
        """Profile points meeting the SLO (all points when none do, so the
        scaler can degrade gracefully instead of dropping traffic)."""
        if self.slo_latency is None:
            return list(self.profile)
        ok = [p for p in self.profile if p.p99_latency <= self.slo_latency]
        return ok or list(self.profile)

    def best_point(self) -> ProfilePoint:
        """Most efficient SLO-feasible point: ``argmax_p RPR``."""
        return max(self.feasible_points(), key=lambda p: p.rpr)

    def deadline_budget(self) -> Optional[float]:
        """Seconds from arrival each request of this function has, or None
        (no deadline — the dormant default for best-effort specs)."""
        return deadline_budget(self.slo_tier, self.deadline_s,
                               self.slo_latency)
