"""Host calls that put work on the card (kernel and graph launches,
copies, sets) inside the admission spans begun in the traced sub-window,
a prefill (``chip_smoke.py``'s count)."""


def read(rec):
    tr = rec.get("trace")
    if not tr:
        return None
    want = tr["spans"].get("admission", [])
    if not want:
        return None
    n = sum(tr["launches"].get(("admission", i), 0) for i in want)
    return n / len(want)
