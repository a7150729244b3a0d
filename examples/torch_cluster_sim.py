"""Serve streaming Alpaca-like traffic on a heterogeneous cluster and
print the offline→online gap — a narrated single run of repro_torch.cluster —
then rerun the same trace on a 2-replica-per-model fleet with
decode-boundary preemption enabled.

The port of `examples/cluster_sim.py` over `repro_torch`; it prints what
the reference prints.  `MAX_BATCH`, `FIT_POINTS`, `fit_fleet`,
`node_builders`, `make_policies` and `replica_node_builders` are a private
copy of what the reference takes from the Figure 4 benchmark
(`benchmarks/fig4_online_gap.py`).  Host numpy only, as the reference.

    PYTHONPATH=src python examples/torch_cluster_sim.py
"""

from repro_torch.cluster import (
    ClusterNode,
    GreedyEnergyPolicy,
    LeastLoadedPolicy,
    OfflineOraclePolicy,
    RandomPolicy,
    ReplicaEnergyPolicy,
    ReplicaOraclePolicy,
    RoundRobinPolicy,
    SLOPreemptionPolicy,
    ZetaOnlinePolicy,
    bursty_trace,
    compare_policies,
)
from repro_torch.configs import CASE_STUDY_MODELS, PAPER_ZOO, TABLE1
from repro_torch.core.energy_model import LLMProfile, fit_profile
from repro_torch.energy import SWING_NODE, AnalyticLLMSimulator

N, RATE, ZETA = 80, 4.0, 0.5

MAX_BATCH = 8

# (τin, τout) probe grid for fitting Eq. 6/7 profiles off the simulator
FIT_POINTS = [(8, 8), (64, 64), (256, 128), (1024, 256), (32, 512),
              (512, 512), (128, 32), (2048, 64), (2048, 1024)]


def fit_fleet() -> list[LLMProfile]:
    """Bilinear e_K/r_K profiles for the case-study fleet, fit against the
    same analytic simulator the cluster nodes integrate with."""
    profiles = []
    for name in CASE_STUDY_MODELS:
        sim = AnalyticLLMSimulator(PAPER_ZOO[name], SWING_NODE, batch=1,
                                   kv_cache=True, noise_sigma=0.0)
        tin = [p[0] for p in FIT_POINTS]
        tout = [p[1] for p in FIT_POINTS]
        pbs = [sim.simulate(a, b) for a, b in FIT_POINTS]
        profiles.append(fit_profile(
            name, TABLE1[name]["a_k"], tin, tout,
            [pb.energy_j for pb in pbs], [pb.runtime_s for pb in pbs]))
    return profiles


def node_builders(profiles, *, dvfs: str = "off"):
    return [
        (lambda i=i, name=name, prof=prof: ClusterNode(
            i, PAPER_ZOO[name], prof, SWING_NODE, max_batch=MAX_BATCH,
            dvfs=dvfs))
        for i, (name, prof) in enumerate(zip(CASE_STUDY_MODELS, profiles))
    ]


def make_policies():
    return [RoundRobinPolicy(), RandomPolicy(seed=0), LeastLoadedPolicy(),
            GreedyEnergyPolicy(), ZetaOnlinePolicy(), OfflineOraclePolicy()]


def replica_node_builders(profiles, *, replicas=2, max_batch=MAX_BATCH):
    """`replicas` nodes per case-study model (the multi-replica fleet)."""
    return [
        (lambda nid=len(CASE_STUDY_MODELS) * r + i, name=name, prof=prof:
         ClusterNode(nid, PAPER_ZOO[name], prof, SWING_NODE,
                     max_batch=max_batch))
        for r in range(replicas)
        for i, (name, prof) in enumerate(zip(CASE_STUDY_MODELS, profiles))
    ]


def main():
    profiles = fit_fleet()
    builders = node_builders(profiles)
    trace = bursty_trace(N, RATE, burstiness=6.0, seed=5)
    print(f"trace: {len(trace)} requests, mean rate "
          f"{trace.mean_rate_qps:.2f} qps (bursty), "
          f"fleet: {[p.name for p in profiles]}\n")
    reports = compare_policies(trace, builders, make_policies(), zeta=ZETA)
    oracle = reports["offline_oracle"]
    for rep in reports.values():
        print(rep.summary())
    print(f"\noffline oracle objective bound: {oracle.objective:+.3f}")
    for name, rep in reports.items():
        if name == "offline_oracle":
            continue
        gap = rep.objective - oracle.objective
        print(f"  {name:>15s}: online gap = {gap:8.4f} "
              f"({'matches the bound' if gap < 1e-6 else 'suboptimal'})"
              f"  p95 {rep.latency_p95:5.2f}s vs oracle {oracle.latency_p95:5.2f}s")

    # --- the same trace on a replicated fleet, preemption enabled -------
    print("\n=== 2 replicas per model, SLO preemption enabled ===")
    rep_reports = compare_policies(
        trace, replica_node_builders(profiles, replicas=2, max_batch=4),
        [ZetaOnlinePolicy(), ReplicaEnergyPolicy(), ReplicaOraclePolicy()],
        zeta=ZETA,
        preempter_builder=lambda: SLOPreemptionPolicy(slowdown_slo=2.0))
    for rep in rep_reports.values():
        print(rep.summary())
    r_oracle = rep_reports["replica_oracle"]
    print(f"replica-aware oracle bound: {r_oracle.objective:+.3f} "
          f"(never worse than any online policy — asserted in fig4); "
          f"preemptions: "
          f"{ {n: r.total_preemptions for n, r in rep_reports.items()} }")


if __name__ == "__main__":
    main()
