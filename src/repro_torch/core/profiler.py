"""FaST-Profiler (paper §3.2): Experiment -> Trial automatic profiling.

Profiles a function's throughput and latency over a grid of spatio-temporal
allocations.  Two trial backends:

* ``simulate_trial`` — deploys one FaSTPod on a dedicated simulated node
  (real TokenScheduler + MRA in the loop) and drives closed-loop load,
  measuring completed RPS and p99 — the default, exact reproduction of the
  paper's Experiment->Trial workflow.
* ``measure_callable_trial`` — wall-clock profiles a *real* executor
  (on the card, or a reduced config on the CPU); the spatial axis is
  realized by the token scheduler's concurrency accounting, the temporal
  axis by duty-cycling the dispatch loop.  ``measure_engine_profile``
  wires it to a live ``FunctionInstance``'s fused round and admission
  (CUDA graphs on the card) and emits a spec-ready ``{<F, S, Q, T>}``
  table (``FunctionSpec.profile`` takes it directly).

Default profiling grid = the paper's (§5.2):
  temporal: 20/40/60/80/100%;  spatial: 6/12/24/50/60/80/100%.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Sequence

from repro_torch.core.cluster import Cluster
from repro_torch.core.scaling import ProfilePoint, expected_tokens_per_round
from repro_torch.core.workload import Request, ServiceCurve, poisson_arrivals

TEMPORAL_GRID: tuple[float, ...] = (0.2, 0.4, 0.6, 0.8, 1.0)
SPATIAL_GRID: tuple[float, ...] = (0.06, 0.12, 0.24, 0.5, 0.6, 0.8, 1.0)
# Steps a live trial's window holds at the lowest quota: the window is
# widened to that from a timed step, or the temporal axis measures nothing
# when one step is long (a full-width model's batch takes tenths of a s).
STEPS_PER_WINDOW = 4


@dataclasses.dataclass(frozen=True)
class TrialResult:
    sm: float
    quota: float
    throughput: float
    p50: float
    p99: float

    def to_point(self) -> ProfilePoint:
        return ProfilePoint(sm=self.sm, quota=self.quota,
                            throughput=self.throughput, p99_latency=self.p99)


def simulate_trial(curve: ServiceCurve, sm: float, quota: float, *,
                   duration: float = 30.0, overload_factor: float = 1.5,
                   seed: int = 0) -> TrialResult:
    """One Trial: dedicated node, one pod at (sm, quota), saturating load.

    The client over-drives the pod (``overload_factor`` x its analytic rate)
    so the measured completion rate is the pod's *capacity* under the token
    scheduler — which is what the paper's profiler records.
    """
    cluster = Cluster(n_nodes=1, sharing=True)
    cluster.register_function(curve.name, curve)
    point = ProfilePoint(sm=sm, quota=quota, throughput=0.0)
    pod = cluster.deploy(curve.name, point)
    assert pod is not None, "dedicated profiling node must admit one pod"
    target_rps = max(curve.rate(sm, quota) * overload_factor, 1.0)
    cluster.submit_all(
        poisson_arrivals(curve.name, target_rps, duration, seed=seed)
    )
    cluster.run(duration + 5.0)
    rec = cluster.recorders[curve.name]
    warm = duration * 0.2  # discard warm-up
    thr = rec.throughput(warm, duration)
    return TrialResult(sm=sm, quota=quota, throughput=thr,
                       p50=rec.p50(since=warm), p99=rec.p99(since=warm))


def measure_callable_trial(step_fn: Callable[[], None], sm: float, quota: float,
                           *, window: float = 0.2, n_windows: int = 5,
                           warmup: int = 2) -> TrialResult:
    """Profile a real executor by duty-cycled dispatch (wall-clock).

    ``step_fn`` runs one inference step to completion (blocking: a port
    step ends in the instance's host sync, so its wall time includes the
    device time).  The temporal quota is enforced exactly as FaST-Manager
    does: within each scheduling window, steps are dispatched until
    ``quota * window`` seconds of measured execution have been charged,
    then the pod blocks to the next window.  The spatial share is not
    enforced (nothing partitions the card's SMs yet); it is recorded so
    the caller can attach an analytic scaling factor.
    """
    for _ in range(warmup):
        step_fn()
    lat: list[float] = []
    completed = 0
    t_total0 = time.perf_counter()
    for _ in range(n_windows):
        w0 = time.perf_counter()
        used = 0.0
        while used < quota * window:
            s0 = time.perf_counter()
            step_fn()
            dt = time.perf_counter() - s0
            used += dt
            lat.append(dt)
            completed += 1
        # Block for the remainder of the window (Q_remain <= 0).
        leftover = window - (time.perf_counter() - w0)
        if leftover > 0:
            time.sleep(leftover)
    elapsed = time.perf_counter() - t_total0
    lat.sort()
    return TrialResult(
        sm=sm, quota=quota, throughput=completed / elapsed,
        p50=lat[len(lat) // 2] if lat else 0.0,
        p99=lat[min(len(lat) - 1, int(len(lat) * 0.99))] if lat else 0.0,
    )


def measure_engine_profile(
    model,
    params,
    *,
    spatial: Sequence[float] = (0.25, 0.45),
    temporal: Sequence[float] = (0.4, 0.8),
    max_batch: int = 4,
    max_len: int = 64,
    batching: str = "continuous",
    prompt_len: int = 8,
    new_tokens: int = 4,
    window: float = 0.1,
    n_windows: int = 3,
    seed: int = 0,
    sm_scale=None,
    kv_budget_bytes: int = 0,
    kv_block_bytes: int = 0,
    kv_shared_frac: float = 0.0,
    sampling=None,
    speculate=None,
    draft_params=None,
    device=None,
) -> list[ProfilePoint]:
    """Spec-ready ``{<F, S, Q, T>}`` table measured on a live instance
    (profiler.py:114-232 of the JAX package).

    Builds one ``FunctionInstance`` per spatial share on ``device``
    (``None`` = the card) — the same fused round and admission the
    serving engine dispatches, CUDA graphs on the card — and runs
    ``measure_callable_trial`` per grid cell: one ``step_fn`` serves a
    full batch of ``max_batch`` requests (``prompt_len`` prompt +
    ``new_tokens`` greedy tokens each) to completion, so the temporal
    quota is enforced on real wall-clock executor time exactly as
    FaST-Manager charges ``Q_used``.  Throughput is scaled to requests/s;
    the batch's step latency stands in for per-request p99 (batch members
    finish together).  The spatial axis is not partitioned:
    ``sm_scale(sm) -> factor`` attaches an analytic scaling when given
    (throughput x factor, latency / factor), else points share the
    measured rate.  The returned ``ProfilePoint``s feed
    ``repro_torch.control.FunctionSpec.profile`` directly.

    ``kv_budget_bytes`` / ``kv_block_bytes`` / ``kv_shared_frac`` stamp
    paged capacity and the shared-fraction axis
    (``ProfilePoint.kv_blocks`` / ``kv_shared_frac``) as in
    :func:`profile_points`.

    ``window`` is a floor: each instance runs two warm-up steps (the
    first captures its graphs), the second timed, and the trials' window
    is widened to hold ``STEPS_PER_WINDOW`` such steps at the lowest
    quota.

    ``sampling``, ``speculate`` and ``draft_params`` are not ported yet
    and raise ``NotImplementedError`` (ROADMAP.md, Queue 1 item 7).
    """
    import itertools

    import numpy as np

    # Lazy import: repro_torch.core must not depend on repro_torch.serving
    # at import time (the serving engine already imports core modules).
    from repro_torch import resolve_device
    from repro_torch.core.model_sharing import ModelStore
    from repro_torch.serving.engine import FunctionInstance, ServeRequest

    if (sampling is not None or speculate is not None
            or draft_params is not None):
        raise NotImplementedError(
            "sampling and speculative decoding are not ported yet "
            "(ROADMAP.md, Queue 1 item 7)")
    dev = resolve_device(device)
    store = ModelStore()
    store.store("__profile__", params)
    req_ids = itertools.count()
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, model.cfg.vocab_size, prompt_len,
                            dtype=np.int32) for _ in range(max_batch)]
    kv_blocks = paged_kv_capacity(kv_budget_bytes, kv_block_bytes,
                                  kv_shared_frac)
    points: list[ProfilePoint] = []
    for sm in spatial:
        inst = FunctionInstance(
            "__profile__/0", model, store, "__profile__", device=dev,
            max_batch=max_batch, max_len=max_len, batching=batching)

        def step_fn() -> None:
            for p in prompts:
                inst.queue.append(ServeRequest(req_id=next(req_ids),
                                               prompt=p,
                                               max_new_tokens=new_tokens))
            while inst.has_work():
                inst.run_step()

        step_fn()  # warm-up: the graphs' eager pass and capture
        t0 = time.perf_counter()
        step_fn()
        step_s = time.perf_counter() - t0
        win = max(window, STEPS_PER_WINDOW * step_s / min(temporal))
        factor = sm_scale(sm) if sm_scale is not None else 1.0
        trials = [(quota, measure_callable_trial(step_fn, sm, quota,
                                                 window=win,
                                                 n_windows=n_windows,
                                                 warmup=0))
                  for quota in temporal]
        for quota, r in trials:
            points.append(ProfilePoint(
                sm=sm, quota=quota,
                throughput=r.throughput * max_batch * factor,
                p99_latency=r.p99 / max(factor, 1e-9),
                kv_blocks=kv_blocks, kv_shared_frac=kv_shared_frac,
                spec_k=0, acceptance=0.0))
        inst.close()
    return points


@dataclasses.dataclass
class ProfileDB:
    """The profiler's results database (paper: stored for the scheduler)."""

    points: dict[str, list[ProfilePoint]] = dataclasses.field(default_factory=dict)

    def add(self, fn: str, result: TrialResult) -> None:
        self.points.setdefault(fn, []).append(result.to_point())

    def best_rpr(self, fn: str) -> ProfilePoint:
        return max(self.points[fn], key=lambda p: p.rpr)

    def table(self, fn: str) -> list[ProfilePoint]:
        return list(self.points[fn])


def profile_function(
    curve: ServiceCurve,
    *,
    temporal: Sequence[float] = TEMPORAL_GRID,
    spatial: Sequence[float] = SPATIAL_GRID,
    duration: float = 30.0,
    db: ProfileDB | None = None,
) -> ProfileDB:
    """The Experiment phase: sweep the full grid (paper Fig. 8)."""
    db = db or ProfileDB()
    for sm in spatial:
        for quota in temporal:
            db.add(curve.name, simulate_trial(curve, sm, quota,
                                              duration=duration))
    return db


def paged_kv_capacity(kv_budget_bytes: int, kv_block_bytes: int,
                      shared_frac: float = 0.0) -> int:
    """TOTAL physical KV blocks a memory budget can hold — the value to
    hand the engine as ``n_kv_blocks`` (the null page is one of them, so
    a usable pool needs at least 2; smaller budgets report 0).

    ``shared_frac`` is the shared-fraction axis: with fraction ``s`` of a
    workload's blocks expected to be prefix-shared duplicates, the same
    budget honestly covers a pool stretched by ``1 / (1 - s)`` — the
    expected PHYSICAL use of the larger pool is back at the budget,
    because duplicated blocks are mapped, not materialised.  This mirrors
    the live frontend's discounted KV admission charge; the engine still
    enforces worst-case per-request reservations inside whatever pool it
    is handed.
    """
    if not 0.0 <= shared_frac < 1.0:
        raise ValueError(
            f"shared_frac must be in [0, 1), got {shared_frac}")
    if kv_block_bytes <= 0 or kv_budget_bytes <= 0:
        return 0
    n = int(kv_budget_bytes / (kv_block_bytes * (1.0 - shared_frac)))
    return n if n >= 2 else 0


def profile_points(
    curve: ServiceCurve,
    *,
    spatial: Sequence[float] = (0.12, 0.24, 0.5),
    temporal: Sequence[float] = (0.4, 1.0),
    duration: float = 12.0,
    loaded_factor: float = 0.8,
    seed: int = 0,
    kv_budget_bytes: int = 0,
    kv_block_bytes: int = 0,
    kv_shared_frac: float = 0.0,
    spec_k: int = 0,
    acceptance: float = 0.0,
) -> list[ProfilePoint]:
    """Spec-ready profile table: ``{<F_j, S_p, Q_p, T_p>}`` with SLO p99s.

    Per grid cell, two Trials: a *saturating* probe for capacity ``T_p``
    (the throughput Alg. 1 budgets with) and a *loaded* probe at
    ``loaded_factor`` of the analytic rate for the p99 latency (the SLO
    filter must see service latency under realistic load, not the queueing
    blow-up of the saturation probe).  The merged points feed
    ``repro_torch.control.FunctionSpec.profile`` directly.

    ``kv_budget_bytes`` / ``kv_block_bytes`` (both > 0) additionally stamp
    each point with its paged-KV capacity (``ProfilePoint.kv_blocks``) —
    the block budget a ``batching="paged"`` spec hands the engine, derived
    from the same ``Model.kv_block_bytes`` layout admission charges.
    ``kv_shared_frac`` stretches that capacity for prefix-shared workloads
    (see :func:`paged_kv_capacity`) and is stamped on the points so the
    live frontend can discount its admission charge by the same axis.

    ``spec_k`` / ``acceptance`` stamp the speculation axis: the simulated
    curve models the non-speculative round rate, so with ``spec_k > 0``
    each point's throughput is scaled by
    ``expected_tokens_per_round(spec_k, acceptance)`` — the reconciler
    then budgets *effective* tokens/s, exactly matching what a live
    speculating instance completes per verify round.
    """
    kv_blocks = paged_kv_capacity(kv_budget_bytes, kv_block_bytes,
                                  kv_shared_frac)
    spec_factor = expected_tokens_per_round(spec_k, acceptance)
    points: list[ProfilePoint] = []
    for sm in spatial:
        for quota in temporal:
            cap = simulate_trial(curve, sm, quota, duration=duration,
                                 seed=seed)
            lat = simulate_trial(curve, sm, quota, duration=duration,
                                 overload_factor=loaded_factor, seed=seed)
            points.append(ProfilePoint(sm=sm, quota=quota,
                                       throughput=cap.throughput
                                       * spec_factor,
                                       p99_latency=lat.p99,
                                       kv_blocks=kv_blocks,
                                       kv_shared_frac=kv_shared_frac,
                                       spec_k=spec_k,
                                       acceptance=acceptance))
    return points
