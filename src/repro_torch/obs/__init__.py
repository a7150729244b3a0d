"""Port copy of `repro.obs`, numpy only, with its imports renamed;
tests/test_torch_obs.py holds it to the reference.

Observability for the cluster simulator: metrics, traces, live audits.

Architecture note
-----------------
The subsystem is three independent components behind one facade:

    Telemetry  (telemetry.py)  — the hook surface `simulate_cluster`,
      │                          ClusterNode and the policies call into;
      │                          owns which events become which metrics.
      ├─ MetricsRegistry (metrics.py) — named Counter / Gauge / Histogram
      │    families labeled by (node, model, phase, ...).  Histograms are
      │    log-bucketed, bounded-memory and mergeable; the registry
      │    exports Prometheus text exposition (`prometheus_text()`) and a
      │    JSON-able snapshot (`to_dict()`).
      ├─ EventTracer (tracing.py) — append-only event log exporting
      │    Chrome trace_event JSON for chrome://tracing / Perfetto: one
      │    track per node, phase spans, power transitions, sampled
      │    queue/energy counter series.
      └─ InvariantAuditor (audit.py) — re-derives the four-bucket energy
           partition and the split-energy preemption contract at *every*
           settlement event and raises InvariantViolation with recent
           event context on the first broken check.

Design rules that everything here obeys:

  * hooks are read-only observers — telemetry on vs. off yields
    byte-identical ClusterReports (gated in benchmarks/perf_suite.py);
  * no wall-clock — timestamps are simulation seconds, so seeded runs
    export byte-identical traces and metric dumps;
  * everything merges — counters add, gauges add (or max), histograms
    add per-bucket, registries merge family-wise.  This is the substrate
    the planned actor-sharded simulator partitions per node and reduces
    with `MetricsRegistry.merged`, so mergeability is by construction,
    not retrofit.

Typical use::

    from repro_torch.obs import Telemetry, EventTracer, InvariantAuditor
    tel = Telemetry(tracer=EventTracer(), auditor=InvariantAuditor(),
                    sample_every_s=5.0)
    report = simulate_cluster(trace, nodes, policy, telemetry=tel)
    print(tel.prometheus_text())
    tel.tracer.write("trace.json")          # open in ui.perfetto.dev
"""

from repro_torch.obs.audit import InvariantAuditor, InvariantViolation
from repro_torch.obs.metrics import (Counter, Gauge, Histogram, MetricFamily,
                               MetricsRegistry)
from repro_torch.obs.telemetry import Telemetry
from repro_torch.obs.tracing import EventTracer

__all__ = [
    "Counter",
    "EventTracer",
    "Gauge",
    "Histogram",
    "InvariantAuditor",
    "InvariantViolation",
    "MetricFamily",
    "MetricsRegistry",
    "Telemetry",
]
