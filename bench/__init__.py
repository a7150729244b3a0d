"""The benchmark of the PyTorch/CUDA port (`repro_torch`): offline batch
serving on one H100, driven by `BENCHMARK.json` at the repository root.

`run.py` runs one cell once.  Everything that measures (traffic, weights,
the plain reference, FLOP and byte counts, peaks, the energy counter, the
trace reduction, the metric readers) lives here; from the port the harness
takes only the engine it serves through and the engine's counters.
"""
