"""Output tokens that reached the host inside the window, over the
window's seconds (every request's, the first token included)."""


def read(rec):
    t0, t1 = rec["t0"], rec["t1"]
    n = sum(1 for s in rec["sent"] for t in s.times if t0 <= t <= t1)
    return n / (t1 - t0)
