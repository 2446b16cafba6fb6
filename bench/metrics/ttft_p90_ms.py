"""90th percentile (nearest rank), over every request due in the window,
of the time from when it was due to when its first token reached the
host; a request with no first token by the end of the drain counts as
infinite.  The 90th is the highest percentile that leaves at least ten
requests beyond it in every open loop's window (122 and 163 requests)."""

from bench.serve_loop import nearest_rank


def read(rec):
    ttft = [(s.times[0] - s.due) if s.times else float("inf")
            for s in rec["sent"] if s.due < rec["t1"]]
    return nearest_rank(ttft, 0.90) * 1e3 if ttft else None
