"""The measured window: requests sent to ``ServingEngine.submit`` as the
traffic plans them, ``ServingEngine.pump`` driven one pass at a time,
and every token stamped when it reaches the host.

Each instance's ``sync_step`` (the pass's one host pull, where tokens
land in ``ServeRequest.tokens_out``) is wrapped so that the tokens it
lands are stamped right after it returns.  An open-loop request is timed
from when it was due, not from when the generator got to send it; a
closed-loop request is due when its client's previous request finished.
"""

from __future__ import annotations

import dataclasses
import math
import time

import numpy as np

from bench.traffic_gen import Planned, plan, prompt_tokens

PASS_BUDGET_S = 1e-4  # pump's budget: shorter than any pass, so one pass
IDLE_S = 0.0005       # the loop's sleep while nothing is due or running


@dataclasses.dataclass
class Sent:
    planned: Planned
    req: object          # the program's ServeRequest
    due: float           # perf_counter seconds
    sent: float
    times: list = dataclasses.field(default_factory=list)


class Driver:
    """One function's traffic against an engine: ``run`` sends and pumps
    for a window, ``drain`` pumps on after it."""

    def __init__(self, engine, fn: str, traffic: dict, seconds: float,
                 seed: int, vocab: int):
        self.engine, self.fn, self.traffic = engine, fn, traffic
        self.seconds, self.seed, self.vocab = seconds, seed, vocab
        self.plan = plan(traffic, seconds, seed)
        self.sent: list[Sent] = []
        self.live: list[Sent] = []
        self.freed: list[float] = []  # closed loop: when clients freed
        self.next = 0
        self.t0 = self.t1 = 0.0
        self.queued: list[int] = []  # requests queued, each second
        for inst in engine.instances.values():
            inst.sync_step = self._stamping(inst.sync_step)

    def _stamping(self, sync):
        def run():
            out = sync()
            now = time.perf_counter()
            still = []
            for s in self.live:
                n = len(s.req.tokens_out)
                s.times.extend([now] * (n - len(s.times)))
                if s.req.done:
                    if self.traffic["loop"] == "closed":
                        self.freed.append(now)
                else:
                    still.append(s)
            self.live = still
            return out
        return run

    def _send(self, due: float) -> None:
        p = self.plan[self.next]
        self.next += 1
        req = self.engine.submit(self.fn, prompt_tokens(p, self.vocab,
                                                        self.seed),
                                 max_new_tokens=p.max_new)
        s = Sent(p, req, due, time.perf_counter())
        self.sent.append(s)
        self.live.append(s)

    def _send_due(self, now: float) -> None:
        if self.traffic["loop"] == "open":
            while (self.next < len(self.plan)
                   and self.t0 + self.plan[self.next].due <= now):
                self._send(self.t0 + self.plan[self.next].due)
        else:
            while self.freed and self.next < len(self.plan):
                self._send(self.freed.pop(0))

    def run(self) -> None:
        """Send and pump from now for ``seconds``; at the close, send what
        fell due meanwhile (late) and stop sending."""
        self.t0 = time.perf_counter()
        self.t1 = self.t0 + self.seconds
        if self.traffic["loop"] == "closed":
            self.freed = [self.t0] * int(self.traffic["clients"])
        tick = self.t0
        while True:
            now = time.perf_counter()
            if now >= self.t1:
                break
            if now >= tick:
                self.queued.append(sum(len(i.queue) for i in
                                       self.engine.instances.values()))
                tick += 1.0
            self._send_due(now)
            if self.engine.has_work():
                self.engine.pump(budget_s=PASS_BUDGET_S)
            else:
                nxt = self.t1
                if self.traffic["loop"] == "open" and \
                        self.next < len(self.plan):
                    nxt = min(nxt, self.t0 + self.plan[self.next].due)
                time.sleep(max(0.0, min(IDLE_S, nxt - now)))
        if self.traffic["loop"] == "open":
            self._send_due(self.t1)

    def drain(self, until: str, cap_s: float) -> None:
        """Pump on, sending nothing, until every request sent has its
        first token (``until="first"``) or is done (``"done"``), or for at
        most ``cap_s`` seconds."""
        stop = time.perf_counter() + cap_s
        while time.perf_counter() < stop and self.engine.has_work():
            if until == "first" and all(s.times for s in self.sent):
                return
            self.engine.pump(budget_s=PASS_BUDGET_S)

    # -- what the window measured -------------------------------------------

    def due_in_window(self) -> list[Sent]:
        return [s for s in self.sent if s.due < self.t1]

    def finished(self) -> list:
        return [s.req for s in self.sent if s.req.done]

    def lateness(self) -> dict:
        late = np.array([s.sent - s.due for s in self.sent] or [0.0])
        return {"p95_ms": float(np.percentile(late, 95) * 1e3),
                "max_ms": float(late.max() * 1e3)}


def nearest_rank(values, q: float) -> float:
    """The ``q``-quantile (0-1) by nearest rank: an infinite value is a
    value like any other."""
    v = sorted(values)
    if not v:
        return float("nan")
    return v[max(0, math.ceil(q * len(v)) - 1)]


def bucket_of(n: int, max_len: int) -> int:
    """The prefill bucket a prompt of ``n`` tokens pads to (the
    engine's power-of-two buckets, capped at ``max_len``)."""
    return min(1 << max(n - 1, 0).bit_length(), max_len)


def warm(engine, fn: str, lengths: list[int], vocab: int, seed: int) -> dict:
    """Warm the shapes the traffic uses, before the window: on bucketed
    instances two admissions of every bucket the traffic's prompts pad to
    (the first runs eagerly, the second is captured and replayed), on
    exact-length instances one admission of the longest and one of the
    shortest prompt each; every instance's round is captured (3 tokens a
    request make 2 rounds).  Fails unless each instance then holds its
    round graph and one prefill graph a bucket; returns them."""
    insts = list(engine.instances.values())
    n = len(insts)
    rng = np.random.default_rng([seed, 4])
    bucketed = all(i.bucketed for i in insts)
    max_len = insts[0].max_len
    if bucketed:
        buckets = sorted({bucket_of(x, max_len) for x in lengths})
        # a bucket's longest prompt that leaves room for 3 tokens
        lens = [min(b, max_len - 2) for b in buckets for _ in range(2 * n)]
    else:
        buckets = []
        lens = [max(lengths)] * n + [min(lengths)] * n
    for x in lens:
        engine.submit(fn, rng.integers(0, vocab, x).astype(np.int32),
                      max_new_tokens=3)
    while engine.has_work():
        engine.pump(budget_s=60.0)
    graphs = {}
    for k, inst in engine.instances.items():
        rg, pg = inst.round_graph, inst.prefill_graphs
        card = inst.device.type == "cuda"
        if card and rg.graph is None:
            raise RuntimeError(f"{k}: the warm-up captured no round")
        got = sorted(pg.by_bucket) if pg is not None else []
        if bucketed and (got != buckets or card and any(
                g.graph is None for g in pg.by_bucket.values())):
            raise RuntimeError(f"{k}: warm-up prefill graphs of buckets "
                               f"{got}, the traffic's {buckets}")
        graphs[k] = (rg and rg.graph,
                     pg and {b: g.graph for b, g in pg.by_bucket.items()})
    return graphs


def same_graphs(engine, graphs: dict) -> None:
    """Fails unless every instance still holds the graphs of its warm-up
    and no other: nothing was captured inside the window."""
    for k, inst in engine.instances.items():
        rg, pg = inst.round_graph, inst.prefill_graphs
        now = (rg and rg.graph,
               pg and {b: g.graph for b, g in pg.by_bucket.items()})
        if now[0] is not graphs[k][0] or (now[1] or {}) != (graphs[k][1]
                                                           or {}):
            raise RuntimeError(f"{k}: a graph was captured inside the "
                               f"window")
