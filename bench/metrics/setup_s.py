"""Process start to the first due request: imports, weights, deploy,
the kernel build where it runs, and the warm-up's captures."""


def read(rec):
    return rec["setup_s"]
