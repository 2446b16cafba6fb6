"""``round_device_ms`` in the cells that do not report the end-to-end
metric it moves elsewhere: there it moves ``tokens_per_s``.  The same
reading."""

from bench.metrics.round_device_ms import read  # noqa: F401
