"""The port's benchmark: one cell a run (``benchmark/run.py``)."""
