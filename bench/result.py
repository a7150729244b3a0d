"""A run's result line: the cell's metrics, each read by its own reader
(`bench/metrics/<name>.py`), the device record, the traced breakdown and,
last, the numbers compared with their limits."""

from __future__ import annotations

import importlib.util

from bench import devtrace
from bench.spec import BENCH, metric_entries


def read_metric(name: str, run):
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(run)


def correct(cell, found: dict) -> bool:
    return all(found[k] <= v for k, v in cell.cell["check"]["limits"].items())


def result_line(cell, run, device: dict, found: dict, trace: bool) -> dict:
    metrics = {}
    for m in metric_entries(cell.name, trace):
        v = read_metric(m["name"], run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    out = {"correct": correct(cell, found), "attempted": sum(1 for _ in run.requests()),
           "failed": 0, "metrics": metrics, "device": device}
    if trace:
        out["breakdown"] = {"device_ops": devtrace.top(run.trace["ops"]),
                            "idle_gaps": devtrace.top(run.trace["idle"])}
    out["check"] = {k: {"value": found[k], "limit": v}
                    for k, v in cell.cell["check"]["limits"].items()}
    return out
