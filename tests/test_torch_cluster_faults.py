"""The port's fault machinery (`repro_torch.cluster.faults`, FailoverPolicy,
the failure-aware oracle, failure domains, checkpointing and the
survivability autoscaler) against the reference's, run live at the same
seeds: seeded fault traces, fig4's availability cell over its MTTF sweep
and fig4's blast-radius cell on its heterogeneous two-rack fleet.  Every
`ClusterReport.to_json(include_records=True)` is held byte-identical, at
1 and 4 shards.
"""

import dataclasses

import pytest

import torch_cluster_pair as pair
from torch_cluster_pair import PORT, both, report_json


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    yield from pair.one_thread()


def trace_key(ft):
    return (ft.name, [dataclasses.astuple(ev) for ev in ft.events], ft.domains,
            {n: ft.down_intervals(n) for n in range(8)})


def injected(s, seed, correlated):
    topo = (s.cluster.rack_pdu_topology(range(8), rack_size=2, racks_per_pdu=2)
            if correlated else None)
    return s.cluster.FaultInjector(
        mttf_s=40.0, mttr_s=15.0, straggle_mttf_s=30.0, straggle_mttr_s=10.0,
        slowdown_range=(1.5, 2.5), seed=seed, domains=topo,
    ).generate(range(8), 400.0)


@pytest.mark.parametrize("correlated", [False, True])
@pytest.mark.parametrize("seed", [0, 13])
def test_fault_traces_identical(seed, correlated):
    ref, port = both(lambda s: trace_key(injected(s, seed, correlated)))
    assert port == ref
    assert len(port[1]) > 10


# ---------------------------------------------------------------------------
# fig4's availability cell: 2x llama2-7b + llama2-13b, 120 requests, 2 qps
# ---------------------------------------------------------------------------

AVAIL_FLEET = ("llama2-7b", "llama2-7b", "llama2-13b")


def availability_cell(s, mult, shards):
    """fig4_online_gap.availability_cells at one MTTF multiple: the
    no-fault baseline, then FailoverPolicy rescue under a live auditor,
    a load-only failover, and the failure-aware oracle replay on the same
    realized fault trace."""
    c = s.cluster
    builders = s.node_builders(AVAIL_FLEET, max_batch=4)
    trace = s.alpaca_trace(2.0, n=120)

    def run(policy, **kw):
        return c.simulate_cluster(trace, c.fresh_nodes(builders), policy,
                                  zeta=0.5, shards=shards, **kw)

    base = run(c.FailoverPolicy(c.ZetaOnlinePolicy()))
    mean_service_s = (sum(r.isolated_runtime_s for r in base.records)
                      / len(base.records))
    mttf = mult * mean_service_s
    faults = c.FaultInjector(
        mttf_s=mttf, mttr_s=2.0 * mean_service_s,
        straggle_mttf_s=mttf, straggle_mttr_s=2.0 * mean_service_s,
        slowdown_range=(1.5, 2.5), seed=13,
    ).generate(range(len(AVAIL_FLEET)), trace.duration_s)
    tel = s.obs.Telemetry(auditor=s.obs.InvariantAuditor())
    reps = [base,
            run(c.FailoverPolicy(c.ZetaOnlinePolicy()), faults=faults, telemetry=tel),
            run(c.FailoverPolicy(c.LeastLoadedPolicy()), faults=faults),
            run(c.FailureAwareOraclePolicy(faults), faults=faults)]
    return (trace_key(faults), [report_json(r) for r in reps], tel.auditor.n_checks,
            tel.prometheus_text())


@pytest.mark.parametrize("shards", [1, 4])
@pytest.mark.parametrize("mult", [5.0, 10.0, 50.0])
def test_availability_cell_identical(mult, shards):
    ref, port = both(availability_cell, mult, shards)
    assert port == ref
    assert len(port[0][1]) > 0 and port[2] > 100


def failover_governance(s, shards):
    """Retry limits, abandonment and straggler draining: a dense crash
    storm on a two-node fleet with a tight retry budget."""
    c = s.cluster
    faults = c.FaultInjector(mttf_s=3.0, mttr_s=2.0, straggle_mttf_s=4.0,
                             slowdown_range=(2.0, 3.0), seed=11
                             ).generate([0, 1], 40.0)
    out = []
    for pol in (c.FailoverPolicy(c.LeastLoadedPolicy(), max_retries=1,
                                 base_delay_s=0.5),
                c.FailoverPolicy(c.ZetaOnlinePolicy(), abandon_after_s=6.0,
                                 straggle_threshold=1.5)):
        out.append(report_json(c.simulate_cluster(
            c.poisson_trace(40, 4.0, seed=2), s.nodes(("llama2-7b", "llama2-13b"),
                                                      max_batch=2),
            pol, zeta=0.5, faults=faults, shards=shards,
            telemetry=s.obs.Telemetry(auditor=s.obs.InvariantAuditor()))))
    return out


@pytest.mark.parametrize("shards", [1, 4])
def test_failover_governance_identical(shards):
    ref, port = both(failover_governance, shards)
    assert port == ref
    assert '"abandoned": [{' in port[0] or '"abandoned": [{' in port[1]


# ---------------------------------------------------------------------------
# fig4's blast-radius cell: SWING rack + TPU_NODE standby rack, llama2-7b
# ---------------------------------------------------------------------------

BLAST_N = 300
BLAST_RATE_QPS = 2.0
BLAST_CKPT_INTERVALS = (128, 512)
BLAST_MTTF_S, BLAST_MTTR_S = 30.0, 25.0
BLAST_WINDOWS = ((0, 0.06, 0.26), (0, 0.43, 0.63), (0, 0.80, 0.99))


def blast_hardware(s):
    # TPU_NODE is the reference's modelled v5e node (energy.hardware), a
    # second rack flavour for the simulator, not a number of any card here
    e = s.energy
    return (e.SWING_NODE, e.SWING_NODE, e.TPU_NODE, e.TPU_NODE)


def blast_storm(s, duration_s, rack_size):
    """fig4_online_gap.blast_storm: the efficient rack's first `rack_size`
    nodes crash and recover together in each window."""
    f = s.faults
    racks = s.cluster.rack_pdu_topology(range(4), rack_size=2).groups()
    events = []
    for rack, f0, f1 in BLAST_WINDOWS:
        for nid in racks[rack][:rack_size]:
            events.append(s.cluster.FaultEvent(f0 * duration_s, nid, f.CRASH))
            events.append(s.cluster.FaultEvent(f1 * duration_s, nid, f.RECOVER))
    events.sort(key=lambda ev: (ev.time_s, ev.node_id))
    domains = tuple(r[:rack_size] for r in racks) + tuple(
        (n,) for r in racks for n in r[rack_size:])
    return s.cluster.FaultTrace(f"blast@rack_size={rack_size}", tuple(events),
                                domains=domains)


def blast_builders(s, interval=None):
    c = s.cluster
    ck = None if interval is None else c.CheckpointConfig(interval_tokens=interval)
    power = c.PowerConfig(wake_s=30.0)
    return [
        (lambda i=i, hw=hw: c.ClusterNode(
            i, s.configs.PAPER_ZOO["llama2-7b"], s.profile("llama2-7b", hw), hw,
            max_batch=4, power=power, checkpoint=ck))
        for i, hw in enumerate(blast_hardware(s))]


def blast_cell(s, rack_size, shards):
    """fig4_online_gap.blast_radius_cells at one rack size: the naive
    stack, the hardened stack at both checkpoint intervals, and the
    domain-masked failure-aware oracle, each under a live auditor."""
    c = s.cluster
    queries = s.data.alpaca_like_workload(s.data.WorkloadSpec(
        n_queries=BLAST_N, in_log_mean=5.8, in_log_sigma=0.8, seed=7))
    trace = c.replay_trace(queries, BLAST_RATE_QPS, seed=11,
                           name=f"alpaca-long@{BLAST_RATE_QPS:g}qps")
    storm = blast_storm(s, BLAST_N / BLAST_RATE_QPS, rack_size)

    def run(builders, policy, **kw):
        tel = s.obs.Telemetry(auditor=s.obs.InvariantAuditor())
        rep = c.simulate_cluster(trace, c.fresh_nodes(builders), policy,
                                 zeta=0.5, faults=storm, shards=shards,
                                 telemetry=tel, **kw)
        return report_json(rep), tel.auditor.n_checks

    out = [run(blast_builders(s), c.FailoverPolicy(c.ReplicaEnergyPolicy()),
               autoscaler=c.ReactiveIdlePolicy(idle_timeout_s=4.0, min_awake=2))]
    for interval in BLAST_CKPT_INTERVALS:
        out.append(run(
            blast_builders(s, interval),
            c.FailoverPolicy(c.DomainSpreadPolicy(storm.domains)),
            autoscaler=c.SurvivabilityAutoscalePolicy(
                BLAST_MTTF_S, BLAST_MTTR_S, domains=storm.domains,
                target_util=1.0, min_awake_per_model=2, idle_timeout_s=4.0)))
    out.append(run(blast_builders(s),
                   c.FailureAwareOraclePolicy(storm, domains=storm.domains)))
    return trace_key(storm), out


@pytest.mark.parametrize("shards", [1, 4])
@pytest.mark.parametrize("rack_size", [1, 2])
def test_blast_radius_cell_identical(rack_size, shards):
    ref, port = both(blast_cell, rack_size, shards)
    assert port == ref
    assert '"total_checkpoints": 0' not in port[1][1][0]


def test_blast_profiles_identical():
    ref, port = both(lambda s: pair.profiles_json(
        [s.profile("llama2-7b", hw) for hw in blast_hardware(s)]))
    assert port == ref


def test_fault_rejections_identical():
    def messages(s):
        c, out = s.cluster, []
        for bad in (lambda: c.FaultEvent(0.0, 0, "melt"),
                    lambda: c.FaultEvent(0.0, 0, s.faults.SLOW, 0.5),
                    lambda: c.FaultEvent(0.0, 0, s.faults.CRASH, 2.0),
                    lambda: c.FaultTrace("t", (c.FaultEvent(0.0, 0, s.faults.RECOVER),)),
                    lambda: c.rack_pdu_topology([], rack_size=2),
                    lambda: c.FaultInjector(mttf_s=5.0, domains=((0, 1),)).generate([0, 2], 10.0),
                    lambda: c.FailoverPolicy(c.LeastLoadedPolicy(), max_retries=-1)):
            with pytest.raises(ValueError) as ei:
                bad()
            out.append(str(ei.value))
        return out

    ref, port = both(messages)
    assert port == ref
    assert PORT.faults.CRASH == "crash"
