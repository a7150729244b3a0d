"""Port copy of `repro.obs.tracing`, numpy only, with its imports renamed;
tests/test_torch_obs.py holds it to the reference.

Structured event tracing with Chrome trace_event JSON export.

The tracer records simulation events — arrivals, phase spans (prefill /
decode / preempted decode), power transitions (gate/wake spans), DVFS
shifts, preemption settlements, routing decisions — as compact tuples and
exports the Chrome ``trace_event`` JSON format, loadable in
chrome://tracing and Perfetto (https://ui.perfetto.dev): one track (tid)
per cluster node, phase spans as complete ("X") events, instants ("i"),
and sampled time series (queue depth, batch occupancy, bucket power) as
counter ("C") tracks.

Event arguments are passed as *flat* ``(k1, v1, k2, v2, ...)`` tuples —
one tuple allocation per event, no dict on the hot path (the recording
hooks sit inside the simulator event loop and are budgeted by the
perf-suite metrics_overhead gate).  Key order is call-site order, which is
deterministic for a given code path; ``to_json`` sorts keys at export.

Timestamps are *simulation* seconds converted to trace microseconds —
wall-clock never enters, so a seeded run traces byte-identically
(tests/test_obs.py pins this).  Memory is bounded by ``max_events``:
beyond the cap events are counted in ``dropped`` instead of stored (the
cap is generous — a 10⁴-request fig4 run emits ~10⁵ events)."""

from __future__ import annotations

import json
from pathlib import Path

# record layout: (ph, name, cat, ts_us, dur_us, tid, flat_args)
_PH, _NAME, _CAT, _TS, _DUR, _TID, _ARGS = range(7)


class EventTracer:
    """Append-only trace of simulation events in (record-time) order."""

    def __init__(self, max_events: int = 1_000_000):
        if max_events < 1:
            raise ValueError("max_events must be >= 1")
        self.max_events = max_events
        self.events: list[tuple] = []
        self.dropped = 0
        self._thread_names: dict[int, str] = {}
        # sharded runs: a fleet-wide monotone counter (shared by every
        # shard's tracer) stamping each record with its global append
        # order, so `absorb` can interleave per-shard traces back into
        # the exact order a fused tracer would have recorded
        self.stamp_source = None
        self._stamps: list[int] = []

    def __len__(self) -> int:
        return len(self.events)

    # --- recording ----------------------------------------------------
    def thread_name(self, tid: int, name: str) -> None:
        """Name a track (one per cluster node, plus tid 0 for the sim)."""
        self._thread_names[int(tid)] = name

    def instant(self, name: str, ts_s: float, tid: int = 0,
                cat: str = "sim", args: tuple = ()) -> None:
        events = self.events
        if len(events) >= self.max_events:
            self.dropped += 1
            return
        events.append(("i", name, cat, ts_s * 1e6, None, tid, args))
        if self.stamp_source is not None:
            self._stamps.append(self.stamp_source())

    def complete(self, name: str, start_s: float, dur_s: float,
                 tid: int = 0, cat: str = "sim", args: tuple = ()) -> None:
        """A span [start_s, start_s + dur_s] — a phase, a wake ramp."""
        events = self.events
        if len(events) >= self.max_events:
            self.dropped += 1
            return
        events.append(("X", name, cat, start_s * 1e6, dur_s * 1e6, tid,
                       args))
        if self.stamp_source is not None:
            self._stamps.append(self.stamp_source())

    def counter(self, name: str, ts_s: float, values: tuple,
                tid: int = 0) -> None:
        """A sampled time-series point (queue depth, bucket power, ...);
        `values` is the same flat (k1, v1, ...) layout."""
        events = self.events
        if len(events) >= self.max_events:
            self.dropped += 1
            return
        events.append(("C", name, "sample", ts_s * 1e6, None, tid, values))
        if self.stamp_source is not None:
            self._stamps.append(self.stamp_source())

    # --- sharded fold -------------------------------------------------
    def absorb(self, tracers) -> "EventTracer":
        """Fold stamp-ordered per-shard tracers into this one: records
        interleave by their global append-order stamps (so the merged
        trace is byte-identical to a fused single-tracer run), thread
        names union (duplicates agree by construction), drop counts add.
        The shard tracers must all share one ``stamp_source``."""
        stamped: list[tuple[int, tuple]] = []
        for t in tracers:
            if len(t._stamps) != len(t.events):
                raise ValueError("absorb needs stamp-ordered tracers "
                                 "(set stamp_source before recording)")
            self._thread_names.update(t._thread_names)
            self.dropped += t.dropped
            stamped.extend(zip(t._stamps, t.events))
        stamped.sort(key=lambda p: p[0])
        self.events.extend(rec for _, rec in stamped)
        return self

    # --- export -------------------------------------------------------
    def to_chrome(self) -> dict:
        """The Chrome trace_event JSON object (dict form)."""
        out = []
        for tid in sorted(self._thread_names):
            out.append({"ph": "M", "name": "thread_name", "pid": 0,
                        "tid": tid,
                        "args": {"name": self._thread_names[tid]}})
        for rec in self.events:
            ev = {"ph": rec[_PH], "name": rec[_NAME], "cat": rec[_CAT],
                  "ts": rec[_TS], "pid": 0, "tid": rec[_TID]}
            if rec[_DUR] is not None:
                ev["dur"] = rec[_DUR]
            flat = rec[_ARGS]
            if flat:
                ev["args"] = dict(zip(flat[0::2], flat[1::2]))
            out.append(ev)
        return {"traceEvents": out, "displayTimeUnit": "ms",
                "otherData": {"dropped_events": self.dropped}}

    def to_json(self) -> str:
        return json.dumps(self.to_chrome(), sort_keys=True)

    def write(self, path: str | Path) -> Path:
        p = Path(path)
        p.write_text(self.to_json() + "\n")
        return p
