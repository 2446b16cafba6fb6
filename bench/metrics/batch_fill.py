"""Decode rounds' fill: the tokens the window's rounds delivered (every
token but each request's first, which its prefill makes) over the rounds
dispatched times each instance's ``max_batch`` (``telemetry()``)."""


def read(rec):
    t0, t1 = rec["t0"], rec["t1"]
    tokens = sum(1 for s in rec["sent"] for t in s.times[1:] if t0 <= t <= t1)
    slots = sum(d["rounds"] * rec["max_batch"][k]
                for k, d in rec["telemetry"].items())
    return tokens / slots if slots else None
