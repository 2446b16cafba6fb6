"""Spans and the device trace of a traced run (``--trace 1``).

Spans are recorded from the benchmark's own files, around the program's
calls, as ``chip_smoke.py``'s ``profile_window`` does: each instance's
admission of one request (``_admit_fused``), its decode round
(``_dispatch_round``) and its sync (``sync_step``) run inside a
``record_function`` named ``bench.<kind>.<n>``, where ``n`` indexes the
span's own record (a prompt's length; a round's active slots and their
key counts).  ``torch.profiler`` traces a steady sub-window in the middle
of the window.  Each device record is put down to the host span whose
launch call carries its correlation id: a graph replay's kernels carry
the replay's.  Nothing is written to disk."""

from __future__ import annotations

import bisect
from collections import defaultdict

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaGraphLaunch", "cudaMemcpyAsync",
                "cudaMemsetAsync")  # host calls that put work on the card
SUBWINDOW = "bench.subwindow"


class Spans:
    """The wrappers that name each admission, round and sync, and what
    each span's record holds."""

    def __init__(self, engine):
        self.admissions: list[dict] = []
        self.rounds: list[dict] = []
        for inst in engine.instances.values():
            self._wrap(inst)

    def _wrap(self, inst) -> None:
        admit, dispatch, sync = (inst._admit_fused, inst._dispatch_round,
                                 inst.sync_step)

        def admit_one(slot, req, done, plan=None):
            self.admissions.append({"prompt_len": int(len(req.prompt))})
            with record_function(f"bench.admission.{len(self.admissions) - 1}"):
                return admit(slot, req, done, plan)

        def round_():
            rows = [len(r.prompt) + max(len(r.tokens_out), 1)
                    for r in inst.slots if r is not None]
            self.rounds.append({"rows": rows, "max_batch": inst.max_batch})
            with record_function(f"bench.round.{len(self.rounds) - 1}"):
                return dispatch()

        def sync_():
            with record_function("bench.sync.0"):
                return sync()

        inst._admit_fused, inst._dispatch_round, inst.sync_step = (
            admit_one, round_, sync_)


def warm_profiler() -> None:
    """Start and stop the profiler once over a trivial kernel: its first
    start (CUPTI's set-up) takes seconds, which belong to set-up."""
    if not torch.cuda.is_available():
        return
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()


class SubWindow:
    """``torch.profiler`` over [start, stop) of the window; ``stop``
    synchronises first, so every kernel launched inside is recorded."""

    def __init__(self):
        self.prof = None
        self.mark = None

    def start(self) -> None:
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.start()
        self.mark = record_function(SUBWINDOW)
        self.mark.__enter__()

    def stop(self) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.mark.__exit__(None, None, None)
        self.prof.stop()


def _raw(prof) -> list[tuple]:
    """(name, on device, start ns, end ns, correlation id) of every
    record, read straight from the profiler's results (building its event
    list takes longer than the window)."""
    out = []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        out.append((e.name(), e.device_type() != DeviceType.CPU, start,
                    start + e.duration_ns(), e.correlation_id()))
    return out


def _union(intervals: list[tuple[int, int]]) -> list[tuple[int, int]]:
    merged: list[list[int]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def digest(sub: SubWindow) -> dict:
    """The traced sub-window as the metric readers take it:

    * ``window_s``, ``busy_s``: its length, and the union of the device
      records' intervals inside it;
    * ``kernels``: (name, seconds, span kind, span index) of every device
      record, put down to its launching span (kind None outside one);
    * ``spans``: {kind: [index, ...]} of the spans begun inside it, and
      ``launches``: {(kind, index): host launch calls inside the span};
    * ``device_ops``, ``idle``: the device's time by record name, and its
      idle time by the span the host was in (``host`` outside one)."""
    events = _raw(sub.prof)
    win = [(a, b) for n, dev, a, b, _ in events if n == SUBWINDOW and not dev]
    if not win:
        return {}
    w0, w1 = win[0]
    spans = sorted((a, b, n) for n, dev, a, b, _ in events
                   if not dev and n.startswith("bench.") and n != SUBWINDOW)
    starts = [a for a, _, _ in spans]

    def span_at(t):
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t <= spans[i][1]:
            _, kind, idx = spans[i][2].split(".")
            return kind, int(idx)
        return None

    launch_at = {}
    launches: dict = defaultdict(int)
    for n, dev, a, _, corr in events:
        if not dev and n in LAUNCH_CALLS:
            launch_at[corr] = a
            s = span_at(a)
            if s is not None:
                launches[s] += 1
    kernels, busy, ops = [], [], defaultdict(float)
    for n, dev, a, b, corr in events:
        if not dev or b <= a or n.startswith("bench."):
            continue
        t = launch_at.get(corr)
        s = span_at(t) if t is not None else None
        kernels.append((n, (b - a) / 1e9, *(s or (None, None))))
        lo, hi = max(a, w0), min(b, w1)
        if hi > lo:
            busy.append((lo, hi))
            ops[n] += (hi - lo) / 1e9
    merged = _union(busy)
    idle: dict = defaultdict(float)
    edge = w0
    for a, b in merged + [(w1, w1)]:
        if a > edge:
            s = span_at((a + edge) // 2)
            idle[s[0] if s else "host"] += (a - edge) / 1e9
        edge = max(edge, b)
    begun = defaultdict(list)
    for a, _, n in spans:
        if w0 <= a <= w1:
            _, kind, idx = n.split(".")
            begun[kind].append(int(idx))
    return {"window_s": (w1 - w0) / 1e9,
            "busy_s": sum(b - a for a, b in merged) / 1e9,
            "kernels": kernels, "spans": dict(begun),
            "launches": dict(launches),
            "device_ops": sorted(ops.items(), key=lambda x: -x[1])[:10],
            "idle": sorted(idle.items(), key=lambda x: -x[1])[:10]}


def port_kernel(name: str) -> str:
    """``flash_kernel`` from a profiler name of one of the port's kernels
    (in anonymous namespaces, templated); "" for any other."""
    tag = "(anonymous namespace)::"
    if tag not in name:
        return ""
    return name.split(tag, 1)[1].split("(")[0].split("<")[0]
