"""Reduce a `torch.profiler` trace of the traced span to what the per-layer
readers and the result's `breakdown` need.

Device operations are the trace's CUDA activities (kernels, copies, sets),
user annotations left out.  The span is the host interval of the
`SPAN` annotation the harness records around the traced batches; busy
time is the union of the device operations' intervals inside it, and each
idle gap inside it is put down to what the host was doing at its middle:
the innermost host event (operator, runtime call or the harness's own
annotation) that covers that instant, else "host python".
"""

from __future__ import annotations

import bisect
import collections

from torch.autograd import DeviceType

SPAN = "bench.traced"
B1_KERNEL = "flash_decode"          # kernel B1's CUDA kernels' names hold this
NAME_CHARS = 160


def short(name: str) -> str:
    """A kernel's name without its return type, namespace and arguments."""
    name = name.removeprefix("void ").removeprefix("(anonymous namespace)::")
    return name.split("(")[0][:NAME_CHARS]


def reduce(prof) -> dict:
    """{"window_s", "busy_s", "ops" {name: s}, "idle" {host label: s},
    "b1_s", "b1_calls"} of the traced span."""
    dev, host, span = [], [], None
    for e in prof.profiler.kineto_results.events():
        t0, t1, name = e.start_ns(), e.end_ns(), e.name()
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation() and not name.startswith("bench."):
                dev.append((t0, t1, name))
        elif name == SPAN:
            span = (t0, t1)
        else:
            host.append((t0, t1, name))
    if span is None:
        raise RuntimeError(f"the trace holds no {SPAN!r} span")
    lo, hi = span
    dev = [(max(a, lo), min(b, hi), n) for a, b, n in dev if b > lo and a < hi]
    ops: dict[str, float] = collections.defaultdict(float)
    b1_ns, b1_calls = 0, 0
    for a, b, n in dev:
        ops[short(n)] += (b - a) / 1e9
        if B1_KERNEL in n:
            b1_ns += b - a
            b1_calls += 1
    busy, gaps, end = 0, [], lo
    for a, b, _ in sorted(dev):
        if a > end:
            gaps.append((end, a))
        if b > end:
            busy += b - max(a, end)
            end = b
    if hi > end:
        gaps.append((end, hi))
    return {"window_s": (hi - lo) / 1e9, "busy_s": busy / 1e9, "ops": dict(ops),
            "idle": idle_by_host(gaps, host), "b1_s": b1_ns / 1e9, "b1_calls": b1_calls}


def idle_by_host(gaps: list[tuple[int, int]], host: list[tuple[int, int, str]]) -> dict:
    """Seconds of the idle gaps by the innermost host event at each gap's middle."""
    mids = sorted(((a + b) // 2, i) for i, (a, b) in enumerate(gaps))
    keys = [m for m, _ in mids]
    best: dict[int, tuple[int, str]] = {}
    for t0, t1, name in host:
        for j in range(bisect.bisect_left(keys, t0), bisect.bisect_right(keys, t1)):
            i = mids[j][1]
            if i not in best or t1 - t0 < best[i][0]:
                best[i] = (t1 - t0, name)
    out: dict[str, float] = collections.defaultdict(float)
    for i, (a, b) in enumerate(gaps):
        out[short(best[i][1]) if i in best else "host python"] += (b - a) / 1e9
    return dict(out)


def top(d: dict, n: int = 10) -> list[list]:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
