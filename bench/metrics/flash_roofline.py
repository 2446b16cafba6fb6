"""The flash kernel's share of its roofline over its calls launched from
the admission spans of the traced sub-window: the sum of each call's
bound (``bench.counts.flash_cost`` at the prompt's true length, not its
bucket) over the sum of the calls' device time, in percent."""

from bench import counts
from bench.tracing import port_kernel


def read(rec):
    tr = rec.get("trace")
    if not tr:
        return None
    m = rec["m"]
    want = set(tr["spans"].get("admission", []))
    bound = time = 0.0
    for name, sec, kind, idx in tr["kernels"]:
        if kind == "admission" and idx in want and \
                port_kernel(name) == "flash_kernel":
            n = rec["admissions"][idx]["prompt_len"]
            bound += counts.bound_s(*counts.flash_cost(
                n, m["n_heads"], m["n_kv_heads"], m["dh"], m["window"]))
            time += sec
    return 100.0 * bound / time if time else None
