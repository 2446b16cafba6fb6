"""The port's benchmark: see ``bench/run.py``."""
