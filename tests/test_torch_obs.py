"""The port's observability layer (`repro_torch.obs`) against the
reference's (`repro.obs`): the metric primitives, the Chrome-trace
tracer, the invariant auditor's verdicts and messages, and fig4's
telemetry cell (full Telemetry over the governed fleet at 2 qps) with
its Prometheus text, Chrome trace and instrumented report.  Every
comparison is `==` on strings or exact values.
"""

import itertools
import json
from types import SimpleNamespace

import numpy as np
import pytest

import torch_cluster_pair as pair
from torch_cluster_pair import PORT, REF, STACKS, both, report_json


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    yield from pair.one_thread()


# ---------------------------------------------------------------------------
# metric primitives
# ---------------------------------------------------------------------------

# label values that need Prometheus escaping: quote, backslash, newline
AWKWARD = ('plain', 'q"uote', 'back\\slash', 'new\nline', 'all"\\\n')


def populated_registry(s, seed):
    """Every primitive and both gauge merge rules, fed float values from a
    seeded numpy stream (the same values in both packages), awkward label
    values and a help text that needs escaping."""
    rng = np.random.default_rng(seed)
    r = s.obs.MetricsRegistry()
    c = r.counter("events_total", 'events "seen"\\n', ("node", "kind"))
    g = r.gauge("depth", "queue depth", ("node",))
    hw = r.gauge("high_water", "max depth seen", ("node",), merge="max")
    h = r.histogram("latency_seconds", "latency", ("model",))
    for _ in range(300):
        c.labels(int(rng.integers(0, 3)),
                 AWKWARD[int(rng.integers(0, len(AWKWARD)))]).inc(
            float(rng.exponential(2.0)))
        g.labels(int(rng.integers(0, 3))).inc(float(rng.normal()))
        hw.labels(int(rng.integers(0, 3))).set(float(rng.normal(0.0, 5.0)))
        h.labels(AWKWARD[int(rng.integers(0, len(AWKWARD)))]).observe(
            float(rng.lognormal(0.0, 4.0)))
    r.counter(f"shard_{seed}_total").get().inc(seed + 0.5)
    return r


def registry_artifacts(s, seeds):
    regs = [populated_registry(s, k) for k in seeds]
    merged = s.obs.MetricsRegistry.merged(regs)
    return (merged.prometheus_text(),
            json.dumps(merged.to_dict(), sort_keys=True),
            [r.prometheus_text() for r in regs],
            merged.value("high_water", "1"), merged.value("depth", "2"))


@pytest.mark.parametrize("seeds", [(1,), (1, 2, 3), (3, 1, 2), (7, 7)])
def test_registries_and_merges_identical(seeds):
    ref, port = both(registry_artifacts, seeds)
    assert port == ref


def histogram_artifacts(s, values, base):
    h = s.obs.Histogram() if base is None else s.obs.Histogram(base=base)
    for v in values:
        h.observe(float(v))
    qs = [h.quantile(q) for q in np.linspace(0.0, 1.0, 41)]
    half = s.obs.Histogram() if base is None else s.obs.Histogram(base=base)
    for v in values[::2]:
        half.observe(float(v))
    rest = s.obs.Histogram() if base is None else s.obs.Histogram(base=base)
    for v in values[1::2]:
        rest.observe(float(v))
    half.merge_from(rest)
    return (qs, h.mean, h.count, h.sum, h.min, h.max, h.zero_count,
            sorted(h.counts.items()),
            [half.quantile(q) for q in (0.5, 0.9, 0.99)], sorted(half.counts.items()))


def _edges():
    # exactly on bucket edges: the -1e-12 guard keeps them in the lower bucket
    return pair.REF.metrics.DEFAULT_BASE ** np.arange(-40, 40).astype(float)


HIST_CASES = {
    "log_uniform": lambda: 10.0 ** np.random.default_rng(0).uniform(-4, 5, 2000),
    "edges": _edges,
    "with_zeros": lambda: np.concatenate(
        [np.zeros(200), -np.ones(3), np.random.default_rng(4).exponential(2.0, 600)]),
    "pareto": lambda: np.random.default_rng(1).pareto(1.1, 2000) + 1e-3,
}


@pytest.mark.parametrize("base", [None, 4.0])
@pytest.mark.parametrize("case", sorted(HIST_CASES))
def test_histogram_buckets_quantiles_and_merge_identical(case, base):
    values = HIST_CASES[case]()
    assert PORT.metrics.DEFAULT_BASE == REF.metrics.DEFAULT_BASE
    ref, port = both(histogram_artifacts, values, base)
    assert port == ref


def counter_gauge_artifacts(s):
    r = s.obs.MetricsRegistry()
    c = r.counter("c_total", "c").get()
    for v in (0.1, 0.2, 3.0, 1e-17, 2.5e15):
        c.inc(v)
    g = r.gauge("g", "g").get()
    g.set(-3.25)
    g.inc(0.1)
    g.dec(7.0)
    m = r.gauge("m", "m", merge="max").get()
    m.set(-2.0)
    other = s.obs.MetricsRegistry()
    other.gauge("m", "m", merge="max").get().set(-5.0)
    other.gauge("fresh", "only here", merge="max").get().set(-1.5)
    merged = s.obs.MetricsRegistry.merged([r, other])
    return r.prometheus_text(), merged.prometheus_text(), c.value, g.value


def test_counter_and_gauge_values_identical():
    ref, port = both(counter_gauge_artifacts)
    assert port == ref


def tracer_with_event(s):
    tr = s.obs.EventTracer()
    tr.instant("unstamped", 0.0)
    return tr


def error_messages(s):
    """The message of every ValueError the primitives raise."""
    r = s.obs.MetricsRegistry()
    r.counter("x_total", labelnames=("node",))
    other = s.obs.MetricsRegistry()
    other.counter("x_total", labelnames=("node", "model"))
    attempts = [
        lambda: r.counter("x_total", labelnames=("node",)).labels().inc(),
        lambda: r.counter("y_total").get().inc(-1.0),
        lambda: r.gauge("x_total", labelnames=("node",)),
        lambda: r.merge(other),
        lambda: r.counter("bad name"),
        lambda: r.counter("ok_total", labelnames=("bad-label",)),
        lambda: r.gauge("g", merge="min"),
        lambda: s.obs.Histogram(base=1.0),
        lambda: s.obs.Histogram().quantile(1.5),
        lambda: s.obs.Histogram().merge_from(s.obs.Histogram(base=4.0)),
        lambda: s.obs.EventTracer(max_events=0),
        lambda: s.obs.EventTracer().absorb([tracer_with_event(s)]),
        lambda: s.obs.InvariantAuditor(tol=0.0),
    ]
    out = []
    for attempt in attempts:
        with pytest.raises(ValueError) as ei:
            attempt()
        out.append(str(ei.value))
    return out


def test_rejections_raise_the_same_messages():
    ref, port = both(error_messages)
    assert port == ref


# ---------------------------------------------------------------------------
# tracer
# ---------------------------------------------------------------------------

def tracer_artifacts(s, max_events):
    tr = s.obs.EventTracer(max_events=max_events)
    tr.thread_name(0, "cluster")
    tr.thread_name(1, 'node"1')
    for i in range(12):
        tr.instant(f"arrival {i}", 0.1 * i, tid=i % 2, args=("req", i))
        tr.complete("decode", 0.1 * i, 0.037 * i, tid=1, args=("batch", i % 3))
        tr.counter("load", 0.1 * i + 0.05, ("q", i, "busy", i % 2))
    # the sharded fold: two tracers stamped by one fleet-wide counter
    stamp = itertools.count().__next__
    a, b = s.obs.EventTracer(), s.obs.EventTracer()
    a.stamp_source = b.stamp_source = stamp
    a.thread_name(2, "node2")
    for i in range(5):
        (a if i % 2 else b).instant("x", 0.3 * i, tid=i)
        b.complete("y", 0.5 * i, 0.25, tid=i)
    merged = s.obs.EventTracer().absorb([a, b])
    return tr.to_json(), len(tr), tr.dropped, merged.to_json()


@pytest.mark.parametrize("max_events", [1_000_000, 7])
def test_tracer_chrome_json_identical(max_events):
    ref, port = both(tracer_artifacts, max_events)
    assert port == ref


# ---------------------------------------------------------------------------
# auditor
# ---------------------------------------------------------------------------

def fake_node(nid=0, busy_s=0.0, busy_e=0.0, accounted=0.0):
    return SimpleNamespace(
        node_id=nid, busy_s=busy_s, busy_energy_j=busy_e,
        accounted_s=accounted, idle_s=0.0, idle_energy_j=0.0,
        gated_s=0.0, gated_energy_j=0.0, transition_s=0.0,
        transition_energy_j=0.0, n_wakes=0, n_gates=0,
        idle_power_w=100.0, transition_power_w=150.0,
        phase_stretch=1.0, accel_static_w=0.0,
        wasted_energy_j=0.0, shipping_s=0.0, shipping_energy_j=0.0,
        power=SimpleNamespace(gated_w=10.0, wake_j=50.0, gate_j=20.0))


def auditor_verdicts(s):
    """The auditor's unit contracts (as tests/test_obs.py drives them):
    one passing settle, then each broken one, as the message raised."""
    out = []
    aud = s.obs.InvariantAuditor()
    aud.on_settle(fake_node(busy_s=2.0, busy_e=900.0, accounted=3.0),
                  "decode", 1.0, 2.0, 900.0)
    out.append(aud.n_checks)

    def drift():
        a = s.obs.InvariantAuditor()
        a.note(("arrival", "req-7"))
        a.on_settle(fake_node(busy_s=2.0, busy_e=901.0, accounted=3.0),
                    "decode", 1.0, 2.0, 900.0)

    def partition():
        s.obs.InvariantAuditor().on_settle(
            fake_node(busy_s=2.0, busy_e=900.0, accounted=2.5),
            "decode", 1.0, 2.0, 900.0)

    def offphase():
        node = fake_node(busy_s=1.0, busy_e=10.0, accounted=6.0)
        node.idle_s, node.idle_energy_j = 5.0, 123.0
        s.obs.InvariantAuditor().on_settle(node, "prefill", 5.0, 1.0, 10.0)

    def unsettled_split():
        s.obs.InvariantAuditor().on_preempt_split(fake_node(), 1, 1, 2, 1, 1.0)

    for broken in (drift, partition, offphase, unsettled_split):
        with pytest.raises(s.obs.InvariantViolation) as ei:
            broken()
        out.append(str(ei.value))
    return out


def test_auditor_verdicts_and_messages_identical():
    ref, port = both(auditor_verdicts)
    assert port == ref
    assert "busy-energy drift" in port[1] and "req-7" in port[1]


def leaky_run(s):
    """A node that misaccounts a millijoule per settlement, under a live
    auditor: the first bad settle raises, with the same message."""

    class LeakyNode(s.cluster.ClusterNode):
        def _charge(self, members, t, e_accel, **kw):
            super()._charge(members, t, e_accel, **kw)
            self.busy_energy_j += 1e-3

    name = "llama2-7b"
    leaky = LeakyNode(0, s.configs.PAPER_ZOO[name], s.profile(name),
                      s.energy.SWING_NODE, max_batch=4)
    with pytest.raises(s.obs.InvariantViolation) as ei:
        s.cluster.simulate_cluster(
            s.cluster.poisson_trace(10, 4.0, seed=5), [leaky],
            s.cluster.ZetaOnlinePolicy(),
            telemetry=s.obs.Telemetry(auditor=s.obs.InvariantAuditor()))
    return str(ei.value)


def test_broken_settlement_raises_the_same_violation():
    ref, port = both(leaky_run)
    assert port == ref
    assert "busy-energy drift" in port


# ---------------------------------------------------------------------------
# fig4's telemetry cell
# ---------------------------------------------------------------------------

def telemetry_cell(s, telemetry=None, *, shards=1, obs_mode=None):
    """fig4_online_gap.telemetry_cell: the governed (per-phase DVFS) fleet
    with a τout-predictor router, a reactive autoscaler and an SLO
    preempter at 2 qps.  `obs_mode` runs it through the engine's Runner
    directly (the facade has no such parameter)."""
    c = s.cluster
    kw = dict(zeta=0.5,
              autoscaler=c.ReactiveIdlePolicy(idle_timeout_s=pair.IDLE_TIMEOUT_S),
              preempter=c.SLOPreemptionPolicy(slowdown_slo=2.0),
              telemetry=telemetry)
    args = (s.alpaca_trace(2.0), s.nodes(dvfs="per_phase"),
            c.ZetaOnlinePolicy(tau_out_predictor=c.TauOutPredictor()))
    if obs_mode is None:
        return c.simulate_cluster(*args, shards=shards, **kw)
    return s.engine.Runner(*args, shard_count=shards, obs_mode=obs_mode, **kw).run()


def full_telemetry(s):
    return s.obs.Telemetry(tracer=s.obs.EventTracer(),
                           auditor=s.obs.InvariantAuditor(),
                           sample_every_s=5.0)


def instrumented_artifacts(s, shards=1, obs_mode=None):
    tel = full_telemetry(s)
    rep = telemetry_cell(s, tel, shards=shards, obs_mode=obs_mode)
    rebuilt = type(rep).from_registry(tel.registry)
    return (report_json(rep), tel.prometheus_text(), tel.tracer.to_json(),
            tel.auditor.n_checks, json.dumps(rebuilt.to_dict(), sort_keys=True))


@pytest.mark.parametrize("shards", [1, 4])
def test_telemetry_cell_identical_to_reference(shards):
    ref, port = both(instrumented_artifacts, shards)
    assert port[0] == ref[0]   # the instrumented report
    assert port[1] == ref[1]   # Prometheus text
    assert port[2] == ref[2]   # Chrome trace JSON
    assert port[3:] == ref[3:]
    assert port[3] > 100 and json.loads(port[2])["otherData"]["dropped_events"] == 0


def test_instrumented_report_equals_bare_report():
    bare = report_json(telemetry_cell(PORT))
    assert instrumented_artifacts(PORT)[0] == bare


@pytest.mark.parametrize("shards", [2, 4])
def test_sharded_observability_equals_fused(shards):
    fused = instrumented_artifacts(PORT, shards, "fused")
    assert instrumented_artifacts(PORT, shards, "sharded") == fused
    assert instrumented_artifacts(REF, shards, "sharded") == fused


def test_stacks_are_distinct_packages():
    """The differential tests above compare two independent stacks: the
    port's classes are its own, never the reference's."""
    assert PORT.obs.Telemetry is not REF.obs.Telemetry
    assert PORT.cluster.ClusterNode.__module__ == "repro_torch.cluster.node"
    assert all(s.obs.__name__ == f"{s.pkg}.obs" for s in STACKS)
