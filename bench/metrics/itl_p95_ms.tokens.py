"""``itl_p95_ms`` in a cell that does not report it as an end-to-end
metric (its spread over sets of runs was not measured there): the same
reading, moving ``tokens_per_s``."""

from bench.metrics.itl_p95_ms import read  # noqa: F401
