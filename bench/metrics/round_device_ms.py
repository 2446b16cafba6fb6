"""Device time of the records launched from the decode-round spans begun
in the traced sub-window, a round (a graph replay's kernels carry the
replay's correlation id)."""


def read(rec):
    tr = rec.get("trace")
    if not tr:
        return None
    want = set(tr["spans"].get("round", []))
    per = {}
    for _, sec, kind, idx in tr["kernels"]:
        if kind == "round" and idx in want:
            per[idx] = per.get(idx, 0.0) + sec
    return 1e3 * sum(per.values()) / len(per) if per else None
