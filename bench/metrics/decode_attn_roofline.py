"""The bf16 decode kernel's share of its roofline over its calls launched
from the round spans of the traced sub-window: each call's bound is the
KV rows its round's active slots attend (one delivered token each), with
q and the output, read and written once (``bench.counts.decode_cost``);
free slots count for nothing.  Summed bounds over summed device time,
in percent."""

from bench import counts
from bench.tracing import port_kernel


def read(rec):
    tr = rec.get("trace")
    if not tr:
        return None
    m = rec["m"]
    want = set(tr["spans"].get("round", []))
    bound = time = 0.0
    for name, sec, kind, idx in tr["kernels"]:
        if kind == "round" and idx in want and \
                port_kernel(name) == "decode_bf16_kernel":
            rows = rec["rounds"][idx]["rows"]
            if m["window"]:
                rows = [min(r, m["window"]) for r in rows]
            bound += counts.bound_s(*counts.decode_cost(
                rows, m["n_heads"], m["n_kv_heads"], m["dh"]))
            time += sec
    return 100.0 * bound / time if time else None
