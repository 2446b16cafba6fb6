"""95th percentile (nearest rank) of every gap between successive output
tokens of every request whose later token reached the host inside the
window (two tokens of one sync make a gap of 0)."""

from bench.serve_loop import nearest_rank


def read(rec):
    t0, t1 = rec["t0"], rec["t1"]
    gaps = [b - a for s in rec["sent"] for a, b in zip(s.times, s.times[1:])
            if t0 <= b <= t1]
    return nearest_rank(gaps, 0.95) * 1e3 if gaps else None
