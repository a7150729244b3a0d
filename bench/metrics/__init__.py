"""One reader a metric, in a file named after it: `read(run)` returns the
metric's value from a `bench.measure.Run`, or None where the run holds
nothing to read it from (the harness then leaves the metric out)."""
