"""Run one cell of the benchmark once and print its result line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell (``BENCHMARK.json``'s ``workloads``) names a configuration and a
traffic mix.  One run makes the weights from ``--seed`` on the card,
deploys the traffic's functions on one ``ServingEngine`` of the port
(``repro_torch``; each function's instances share one weight copy), warms
the shapes the traffic uses, sends the traffic for ``--seconds`` while
pumping the engine one pass at a time, reads the metrics, frees the
engine and checks a sample of what the window served against the plain
reference (``bench/check.py``).  ``--trace 1`` records spans and traces a
sub-window with ``torch.profiler``, and reports the per-layer metrics in
place of the end-to-end ones.

The last line of standard output is one JSON object; the numbers
compared come last there and on standard error.  Set-up runs from this
process's start to the window's start.  Exit codes: 0 with a result, 2
without the card the cell asks for, 3 when a JAX module was loaded.

Measurement aids (never part of a cell's run): ``--control 1`` also runs
the control (fp8 reference in the program's place) on the same sample and
judges it by the cell's limits, where it has to come out not correct;
``--seeds a,b,..`` reads several seeds in one process (the weights drawn
anew in place, one window each, drained before the next); ``--rates
r1,r2,..`` sweeps an open loop's offered rate (one window each).
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if sys.path and Path(sys.path[0]).resolve() == ROOT / "bench":
    sys.path.pop(0)  # the script's folder would shadow the standard library
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))
# Every build and kernel cache at a fixed path inside the checkout.
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = str(ROOT / "build" / sub)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from bench import check, serve_loop, spec, weights  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
DRAIN_S = 60.0


def port_model(m: dict, name: str):
    """The port's model of the configuration's dims."""
    from repro_torch.models import ModelConfig, build_model
    kw = dict(name=name, family=m["family"], n_layers=m["n_layers"],
              d_model=m["d_model"], n_heads=m["n_heads"],
              n_kv_heads=m["n_kv_heads"], d_ff=m["d_ff"],
              vocab_size=m["vocab"], head_dim=m["dh"], qkv_bias=m["bias"],
              mlp="swiglu" if m["gated"] else "gelu",
              rope_theta=m["rope_theta"], norm_eps=m["norm_eps"],
              sliding_window=m["window"])
    if m["family"] == "moe":
        kw.update(n_experts=m["n_experts"], top_k=m["top_k"],
                  moe_cf_eval=m["capacity_factor"])
    return build_model(ModelConfig(**kw))


def deploy(cell: dict, m: dict, traffic: dict, seed: int, device):
    """(engine, function name, weights): one engine with the
    traffic's function(s) deployed, weights made from ``seed``."""
    from repro_torch.core.resources import Alloc
    from repro_torch.serving import ServingEngine
    model = port_model(m, cell["config"])
    w = weights.make(m, seed, device)
    weights.check_layout(w, model.specs)
    engine = ServingEngine(device=device)
    fn = cell["config"]
    for f in traffic["functions"]:
        engine.deploy(fn, model, w, Alloc(**f["alloc"]),
                      n_instances=f["instances"], max_batch=f["max_batch"],
                      max_len=f["max_len"])
    return engine, fn, w


def loaded_forbidden() -> list[str]:
    return sorted({k.split(".")[0] for k in sys.modules} & set(FORBIDDEN))


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def window(engine, fn, traffic, seconds, seed, vocab, trace: bool):
    """One measured window (and its drain); returns the driver, the
    telemetry over the window and the trace's digest."""
    from bench import tracing
    drv = serve_loop.Driver(engine, fn, traffic, seconds, seed, vocab)
    spans = tracing.Spans(engine) if trace else None
    before = engine.telemetry()
    sub = None
    if trace:
        span = min(5.0, seconds / 3)
        sub_at = seconds / 2 - span / 2
        sub = tracing.SubWindow()
        orig_pump = engine.pump
        state = {"until": None, "done": False}

        def pump(budget_s=1.0, **kw):  # start and stop the profiler on time
            now = time.perf_counter()
            if state["until"] is None and not state["done"] and \
                    now - drv.t0 >= sub_at:
                sub.start()
                state["until"] = time.perf_counter() + span
            elif state["until"] is not None and now >= state["until"]:
                sub.stop()
                state.update(until=None, done=True)
            return orig_pump(budget_s=budget_s, **kw)
        engine.pump = pump
    drv.run()
    after = engine.telemetry()
    if trace:
        if state["until"] is not None:
            sub.stop()
        engine.pump = orig_pump
    delta = {k: {c: v[c] - before[k][c] for c in v} for k, v in after.items()}
    digest = tracing.digest(sub) if sub is not None and sub.prof else None
    return drv, delta, digest, spans


def record(m, engine, drv, delta, digest, spans, setup_s, mem) -> dict:
    """What the metric readers read (``bench/metrics``)."""
    return {"m": m, "t0": drv.t0, "t1": drv.t1, "sent": drv.sent,
            "setup_s": setup_s, "mem_peak_bytes": mem,
            "telemetry": delta,
            "max_batch": {k: i.max_batch for k, i in engine.instances.items()},
            "trace": digest,
            "admissions": spans.admissions if spans else [],
            "rounds": spans.rounds if spans else []}


def device_info(device) -> dict:
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1, "memory_peak_bytes": torch.cuda.max_memory_reserved()}


def read_metrics(metrics: list[dict], rec: dict) -> dict:
    out = {}
    for met in metrics:
        v = spec.reader(met["name"])(rec)
        if v is not None:
            out[met["name"]] = {"value": float(v), "unit": met["unit"]}
    return out


def run_cell(sp: dict, seed: int, seconds: float, trace: bool, device,
             control: bool = False, t_start: float = T_START) -> dict:
    """One run of the cell ``sp`` (``spec.cell_spec``): the result's
    fields, with ``checked`` (each number compared beside its limit)
    last."""
    cell, traffic = sp["cell"], sp["traffic"]
    m = spec.model_dims(sp["config"])
    engine, fn, w = deploy(cell, m, traffic, seed, device)
    from bench.traffic_gen import all_prompt_lengths
    graphs = serve_loop.warm(engine, fn, all_prompt_lengths(traffic, seconds),
                             m["vocab"], seed)
    if trace:
        from bench import tracing
        tracing.warm_profiler()
    _sync(device)
    setup_s = time.perf_counter() - t_start
    drv, delta, digest, spans = window(engine, fn, traffic, seconds, seed,
                                       m["vocab"], trace)
    if traffic["loop"] == "open":
        drv.drain("first", DRAIN_S)
    _sync(device)
    serve_loop.same_graphs(engine, graphs)
    dev = device_info(device)
    rec = record(m, engine, drv, delta, digest, spans, setup_s,
                 dev["memory_peak_bytes"])
    metrics = read_metrics(sp["per_layer"] if trace else sp["end_to_end"],
                           rec)
    due = drv.due_in_window() if traffic["loop"] == "open" else drv.sent
    failed = sum(1 for s in due if not s.times) \
        if traffic["loop"] == "open" else 0
    finished = drv.finished()
    lateness = drv.lateness()
    ttft = sorted(round((s.times[0] - s.due) * 1e3, 1) if s.times
                  else float("inf") for s in due) \
        if traffic["loop"] == "open" else None
    del engine, drv, rec, spans
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    reqs = check.sample(finished, traffic, seed)
    got = check.run_check(reqs, m, w, device, control)
    correct, shown = check.verdict(got["program"], sp["limits"])
    ctl = None
    if "control" in got:  # the control through the same comparison
        ok, ctl_shown = check.verdict(got["control"], sp["limits"])
        ctl = {"correct": ok, "checked": ctl_shown}
    out = {"correct": correct and failed == 0, "attempted": len(due),
           "failed": failed, "metrics": metrics, "device": dev}
    if trace and digest:
        out["device"].update(busy_s=digest["busy_s"],
                             window_s=digest["window_s"])
        out["breakdown"] = {"device_ops": [[n[:120], s] for n, s in
                                           digest["device_ops"]],
                            "idle_gaps": [[n, s] for n, s in digest["idle"]]}
    out["info"] = {"generator_late": lateness, "sample": {
        k: got[k] for k in ("requests", "tokens")},
        "program": got["program"], "control": got.get("control"),
        "control_verdict": ctl,
        "untied": got.get("untied"), "ttft_ms": ttft}
    out["checked"] = shown
    return out


def readings(sp, seeds, seconds, device, rates=None,
             control_seeds: int = 6) -> None:
    """Measurement aid: one process, one deploy, a window a seed (weights
    drawn anew in place) or a rate, each drained to its end; one JSON
    line each.  A seed's window is checked as a run checks it, with the
    control beside the program on the first ``control_seeds`` seeds."""
    cell, traffic = sp["cell"], dict(sp["traffic"])
    m = spec.model_dims(sp["config"])
    engine, fn, w = deploy(cell, m, traffic, seeds[0], device)
    from bench.traffic_gen import all_prompt_lengths
    serve_loop.warm(engine, fn, all_prompt_lengths(traffic, seconds),
                    m["vocab"], seeds[0])
    runs = ([(s, None) for s in seeds] if rates is None
            else [(seeds[0], r) for r in rates])
    for seed, rate in runs:
        if rate is not None:
            traffic["rate_per_s"] = rate
        weights.fill(w, m, seed)
        drv = serve_loop.Driver(engine, fn, traffic, seconds, seed, m["vocab"])
        drv.run()
        rec = {"t0": drv.t0, "t1": drv.t1, "sent": drv.sent, "m": m}
        line = {"seed": seed, "rate": rate, "late": drv.lateness(),
                "sent": len(drv.sent), "queued": drv.queued}
        for name in ("tokens_per_s", "itl_p95_ms", "mfu"):
            line[name] = spec.reader(name)(rec)
        if rate is None:  # the sample a run checks, then the rest cut short
            if traffic["loop"] == "open":
                drv.drain("first", DRAIN_S)
            line.update(check.run_check(
                check.sample(drv.finished(), traffic, seed), m, w, device,
                control=seeds.index(seed) < control_seeds))
            for side in ("program", "control"):
                if side in line:
                    line[f"{side}_correct"] = check.verdict(
                        line[side], sp["limits"])[0]
            for s in drv.sent:
                s.req.max_new_tokens = min(s.req.max_new_tokens,
                                           len(s.req.tokens_out) + 1)
        drv.drain("done", 120.0)
        line["ttft_p90_ms"] = spec.reader("ttft_p90_ms")(rec)
        ttft = [(s.times[0] - s.due) * 1e3 for s in drv.sent if s.times]
        third = max(1, len(ttft) // 3)
        line["ttft_p50_ms_by_third"] = [
            serve_loop.nearest_rank(ttft[i:i + third], 0.5)
            for i in (0, third, len(ttft) - third)]
        for inst in engine.instances.values():  # the driver's wrappers
            inst.__dict__.pop("sync_step", None)
        print(json.dumps(line), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--rates", default="")
    args = ap.parse_args(argv)
    sp = spec.cell_spec(args.workload)
    chips = sp["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    if args.seeds or args.rates:
        seeds = [int(s) for s in args.seeds.split(",")] if args.seeds \
            else [args.seed]
        rates = [float(r) for r in args.rates.split(",")] if args.rates \
            else None
        readings(sp, seeds, args.seconds, "cuda", rates)
        return 0
    out = run_cell(sp, args.seed, args.seconds, bool(args.trace), "cuda",
                   bool(args.control))
    bad = loaded_forbidden()
    if bad:
        print(f"JAX or its package was loaded: {bad}", file=sys.stderr)
        return 3
    print(f"generator late: {json.dumps(out['info']['generator_late'])}",
          file=sys.stderr)
    print(f"sample: {json.dumps(out['info'])}", file=sys.stderr)
    ctl = out["info"]["control_verdict"]
    if ctl is not None:
        for k, v in ctl["checked"].items():
            print(f"control check {k} {v['value']!r} limit {v['limit']!r}",
                  file=sys.stderr)
        print(f"control correct {ctl['correct']}", file=sys.stderr)
    for k, v in out["checked"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
