"""1 - (union of the device records' intervals / wall time) over the
traced sub-window."""


def read(rec):
    tr = rec.get("trace")
    if not tr:
        return None
    return 1.0 - tr["busy_s"] / tr["window_s"]
