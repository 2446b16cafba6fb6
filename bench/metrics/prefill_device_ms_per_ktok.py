"""Device time of the records launched from the admission spans begun in
the traced sub-window, over their prompts' true tokens / 1000."""


def read(rec):
    tr = rec.get("trace")
    if not tr:
        return None
    want = set(tr["spans"].get("admission", []))
    per = {}
    for _, sec, kind, idx in tr["kernels"]:
        if kind == "admission" and idx in want:
            per[idx] = per.get(idx, 0.0) + sec
    tokens = sum(rec["admissions"][i]["prompt_len"] for i in per)
    return 1e3 * sum(per.values()) / (tokens / 1e3) if tokens else None
