"""The port's benchmark: one cell's run by `portbench/run.py`."""
