"""FaST-Manager: the multi-token spatio-temporal scheduler (paper §3.3).

One ``TokenScheduler`` runs per accelerator node (the paper's FaST Backend).
Instances (pods) register their 2D allocation; whenever an instance wants to
launch work it *requests a token*.  Each scheduling round performs the three
operations of the paper's Multi-tokens Scheduler:

1. **Filtering** — compute ``Q_miss = Q_request - Q_used`` and
   ``Q_remain = Q_limit - Q_used``; block pods with ``Q_remain <= 0`` until
   the next window (elastic quota: pods past ``Q_request`` but under
   ``Q_limit`` stay eligible, realizing the Kubernetes-style request/limit
   elasticity of §3.3.2).
2. **Candidate enqueuing** — ready pods enter a priority queue sorted
   descending by ``Q_miss`` (largest timing gap first).
3. **Token dispatching** — the SM Allocation Adapter grants tokens from the
   queue head while ``S_running + S_next <= SM_GLOBAL_LIMIT``.

The scheduler is time-agnostic: callers pass ``now`` (virtual time in the
discrete-event simulator, wall time in the live serving engine).  A token
covers one dispatched inference step — a burst of CUDA kernels
launched between synchronization points (DESIGN.md §2).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from repro_torch.core.resources import Alloc


@dataclasses.dataclass
class Token:
    """Permission for one step-dispatch on the node."""

    pod_id: str
    granted_at: float
    sm: float  # spatial share *held* (allocation) while outstanding
    occ: float = 0.0  # spatial share actually *drained* by the kernels
    #                   (DCGM-style occupancy: min(allocated, model's
    #                   saturation share) — a racing pod holds 100% but
    #                   occupies only what its kernels can fill, Fig. 1b)


@dataclasses.dataclass
class _PodState:
    alloc: Alloc
    occupied_sm: float = 0.0  # effective occupancy while holding a token
    q_used: float = 0.0  # seconds of accelerator time used this window
    wants_token: bool = False
    holding: Optional[Token] = None
    # lifetime accounting
    total_busy: float = 0.0
    tokens_granted: int = 0
    blocked_rounds: int = 0

    def q_miss(self, window: float) -> float:
        return self.alloc.quota_request * window - self.q_used

    def q_remain(self, window: float) -> float:
        return self.alloc.quota_limit * window - self.q_used


@dataclasses.dataclass
class WindowStats:
    """Per-window utilization accounting (drives Fig. 1/10/11 metrics)."""

    start: float
    busy_time: float = 0.0  # Σ token-held seconds (temporal load, can be >1)
    busy_area: float = 0.0  # Σ token-held seconds x SM share (occupancy)
    busy_union: float = 0.0  # union of token-held intervals (nvidia-smi
    #                          style "GPU utilization", capped at window)


class TokenScheduler:
    """FaST Backend with Multi-tokens Scheduler for one node."""

    def __init__(
        self,
        window: float = 1.0,
        sm_global_limit: float = 1.0,
        on_grant: Optional[Callable[[Token], None]] = None,
    ):
        if window <= 0:
            raise ValueError("window must be positive")
        self.window = window
        self.sm_global_limit = sm_global_limit
        self.on_grant = on_grant
        self.pods: dict[str, _PodState] = {}
        self._window_start = 0.0
        self.stats_history: list[WindowStats] = []
        self._stats = WindowStats(start=0.0)
        # busy-union tracking: #outstanding tokens + last accrual time.
        self._active = 0
        self._last_evt = 0.0

    # -- registration (FaSTPod sync of the backend table, §3.2) ----------

    def register(self, pod_id: str, alloc: Alloc,
                 occupied_sm: Optional[float] = None) -> None:
        """``occupied_sm``: the share the pod's kernels can actually drain
        (defaults to the allocation; callers with a service model pass
        ``min(alloc.sm, sm_sat)``)."""
        if pod_id in self.pods:
            raise ValueError(f"pod {pod_id} already registered")
        self.pods[pod_id] = _PodState(
            alloc=alloc,
            occupied_sm=alloc.sm if occupied_sm is None else occupied_sm)

    def deregister(self, pod_id: str) -> None:
        state = self.pods.pop(pod_id)
        if state.holding is not None:
            raise RuntimeError(f"pod {pod_id} deregistered while holding a token")

    def update_alloc(self, pod_id: str, alloc: Alloc) -> None:
        """FaST-Scheduler pushed a new resource configuration."""
        self.pods[pod_id].alloc = alloc

    # -- frontend hook: token request / completion ------------------------

    def request_token(self, pod_id: str, now: float) -> None:
        self._maybe_roll(now)
        self.pods[pod_id].wants_token = True

    def complete(self, pod_id: str, elapsed: float, now: float,
                 occ: Optional[float] = None) -> None:
        """Frontend sync point: step finished, charge ``elapsed`` to Q_used.

        ``occ`` overrides the token's registered drained occupancy for this
        step — continuous-batching callers scale it by slot fill, since an
        underfilled decode round cannot saturate the pod's SM share.
        """
        state = self.pods[pod_id]
        if state.holding is None:
            raise RuntimeError(f"pod {pod_id} completed without a token")
        state.q_used += elapsed
        state.total_busy += elapsed
        self._stats.busy_time += elapsed
        self._stats.busy_area += elapsed * (
            state.holding.occ if occ is None else occ)
        self._maybe_roll(now)  # accrue busy-union while the token is live
        self._active = max(self._active - 1, 0)
        state.holding = None

    # -- scheduling round --------------------------------------------------

    def sm_running(self) -> float:
        return sum(p.holding.sm for p in self.pods.values() if p.holding)

    def dispatch(self, now: float) -> list[Token]:
        """One Filter -> Enqueue -> Dispatch round; returns granted tokens."""
        self._maybe_roll(now)
        # 1. Filtering.
        ready: list[tuple[float, str]] = []
        for pod_id, st in self.pods.items():
            if not st.wants_token or st.holding is not None:
                continue
            if st.q_remain(self.window) <= 0:
                st.blocked_rounds += 1  # blocked until next window (e.g. F3)
                continue
            ready.append((st.q_miss(self.window), pod_id))
        # 2. Ready-function priority queue: descending Q_miss.
        ready.sort(key=lambda t: (-t[0], t[1]))
        # 3. SM Allocation Adapter.
        granted: list[Token] = []
        s_running = self.sm_running()
        for _, pod_id in ready:
            st = self.pods[pod_id]
            if s_running + st.alloc.sm > self.sm_global_limit + 1e-9:
                # Head-of-queue blocking, per the paper: the adapter returns
                # tokens "until it encounters S_SMs + S_running > 100%".
                break
            token = Token(pod_id=pod_id, granted_at=now, sm=st.alloc.sm,
                          occ=st.occupied_sm)
            st.holding = token
            st.wants_token = False
            st.tokens_granted += 1
            s_running += st.alloc.sm
            granted.append(token)
            if self.on_grant:
                self.on_grant(token)
        self._active += len(granted)
        return granted

    # -- window management ---------------------------------------------------

    def _maybe_roll(self, now: float) -> None:
        """Roll complete windows and accrue the busy-interval union."""
        while now - self._window_start >= self.window:
            end = self._window_start + self.window
            if self._active > 0 and end > self._last_evt:
                self._stats.busy_union += end - max(self._last_evt,
                                                    self._window_start)
            self._last_evt = max(self._last_evt, end)
            self.stats_history.append(self._stats)
            self._window_start = end
            self._stats = WindowStats(start=end)
            for st in self.pods.values():
                st.q_used = 0.0
        if self._active > 0 and now > self._last_evt:
            self._stats.busy_union += now - self._last_evt
        self._last_evt = max(self._last_evt, now)

    # -- metrics ---------------------------------------------------------------

    def utilization(self, last_n: int = 10) -> float:
        """GPU utilization: union of busy intervals / window (nvidia-smi
        semantics — "some kernel is running", capped at 1; cf. Fig. 1)."""
        hist = self.stats_history[-last_n:]
        if not hist:
            return 0.0
        return sum(w.busy_union for w in hist) / (len(hist) * self.window)

    def temporal_load(self, last_n: int = 10) -> float:
        """Σ token-held seconds / window — the uncapped concurrency load."""
        hist = self.stats_history[-last_n:]
        if not hist:
            return 0.0
        return sum(w.busy_time for w in hist) / (len(hist) * self.window)

    def occupancy(self, last_n: int = 10) -> float:
        """SM occupancy: busy-area / window (spatial x temporal product)."""
        hist = self.stats_history[-last_n:]
        if not hist:
            return 0.0
        return sum(w.busy_area for w in hist) / (len(hist) * self.window)

    def isolation_error(self, pod_id: str, last_n: int = 10) -> float:
        """|delivered - entitled| quota over recent windows, for isolation tests."""
        st = self.pods[pod_id]
        hist = self.stats_history[-last_n:]
        if not hist:
            return 0.0
        entitled = st.alloc.quota_limit * len(hist) * self.window
        # Delivered time is tracked per-pod only in total_busy; scope it by
        # assuming steady registration (tests use dedicated schedulers).
        delivered = st.total_busy
        return max(0.0, delivered - entitled) / max(entitled, 1e-9)


def fair_share_baseline(allocs: dict[str, Alloc], window: float = 1.0) -> dict[str, float]:
    """NVIDIA time-slicing reference: equal time slices, no SM awareness.

    Used by benchmarks as the paper's "time sharing" baseline — each pod gets
    ``window / n`` seconds at 100% SM serially, which is why its SM occupancy
    collapses (Fig. 1b).
    """
    n = len(allocs)
    if n == 0:
        return {}
    return {pod: window / n for pod in allocs}
