"""One reader a metric, found by the metric's name in ``BENCHMARK.json``:
``read(record)`` returns the metric's value from a run's record
(``bench/run.py``'s ``record``), or None where the run holds nothing to
read it from; the harness then leaves the metric out of the line."""
