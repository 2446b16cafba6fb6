"""``torch.cuda.max_memory_reserved()`` over set-up and window, in GiB:
what the function takes from a node that other functions share."""


def read(rec):
    b = rec["mem_peak_bytes"]
    return b / 2 ** 30 if b else None
