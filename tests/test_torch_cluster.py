"""The port's cluster simulator (`repro_torch.cluster`) and `OnlineRouter`
against the reference's, run live at the same seeds: fig4's main table
(six policies x both ζ), the power, DVFS, predictor, preemption and
replica cells, and route sequences of the online router.  Each package
builds its own fleet from its own `PAPER_ZOO` and fits its own profiles
from the same probe points; the profiles are held equal first, then every
`ClusterReport.to_json(include_records=True)` is held byte-identical, at
1 and 4 shards.
"""

import importlib.util
import json

import numpy as np
import pytest

import torch_cluster_pair as pair
from torch_cluster_pair import PORT, REF, both, profiles_json, report_json

HAVE_HYPOTHESIS = importlib.util.find_spec("hypothesis") is not None


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    yield from pair.one_thread()


def test_fig4_profiles_identical():
    ref, port = both(lambda s: profiles_json(s.fig4_profiles()))
    assert port == ref
    assert profiles_json([REF.profile("llama2-7b", REF.energy.TPU_NODE)]) \
        == profiles_json([PORT.profile("llama2-7b", PORT.energy.TPU_NODE)])


# ---------------------------------------------------------------------------
# fig4's main table: the six policies of make_policies(), both ζ
# ---------------------------------------------------------------------------

FIG4_RATE_QPS = 2.0


def fig4_table_run(s, zeta, shards, k):
    pol = s.fig4_policies()[k]
    rep = s.cluster.simulate_cluster(s.alpaca_trace(FIG4_RATE_QPS), s.nodes(),
                                     pol, zeta=zeta, shards=shards)
    return pol.name, report_json(rep)


@pytest.mark.parametrize("k", range(6))
@pytest.mark.parametrize("shards", [1, 4])
@pytest.mark.parametrize("zeta", [0.5, 1.0])
def test_fig4_table_reports_identical(zeta, shards, k):
    ref, port = both(fig4_table_run, zeta, shards, k)
    assert port == ref
    assert len(port[1]) > 10_000


def test_fig4_compare_policies_identical():
    """The facade's `compare_policies` (fresh nodes per policy) at 8 qps,
    where queues build: the same six reports in the same order."""
    def run(s):
        out = s.cluster.compare_policies(
            s.alpaca_trace(8.0), s.node_builders(), s.fig4_policies(), zeta=0.5)
        return [(name, report_json(rep)) for name, rep in out.items()]

    ref, port = both(run)
    assert port == ref


# ---------------------------------------------------------------------------
# power, DVFS, τout prediction, preemption, replicas
# ---------------------------------------------------------------------------

def _run(s, shards, trace, nodes, policy, **kw):
    return report_json(s.cluster.simulate_cluster(
        trace, nodes, policy, zeta=kw.pop("zeta", 0.5), shards=shards, **kw))


def _replica_nodes(s, max_batch=4):
    """fig4's replica fleet: two nodes per case-study model."""
    names = s.configs.CASE_STUDY_MODELS * 2
    return s.nodes(names, max_batch=max_batch)


def dvfs_per_phase(s, shards):
    return _run(s, shards, s.alpaca_trace(2.0), s.nodes(dvfs="per_phase"),
                s.cluster.ZetaOnlinePolicy())


def reactive_idle(s, shards):
    return _run(s, shards, s.alpaca_trace(0.5), s.nodes(),
                s.cluster.ZetaOnlinePolicy(),
                autoscaler=s.cluster.ReactiveIdlePolicy(
                    idle_timeout_s=pair.IDLE_TIMEOUT_S))


def reactive_idle_dvfs(s, shards):
    return _run(s, shards, s.alpaca_trace(2.0), s.nodes(dvfs="per_phase"),
                s.cluster.ZetaOnlinePolicy(),
                autoscaler=s.cluster.ReactiveIdlePolicy(
                    idle_timeout_s=pair.IDLE_TIMEOUT_S))


def predictive_rate(s, shards):
    return _run(s, shards, s.cluster.poisson_trace(120, 0.3, seed=4), s.nodes(),
                s.cluster.ZetaOnlinePolicy(),
                autoscaler=s.cluster.PredictiveRatePolicy(
                    window_s=30.0, target_util=0.5, idle_timeout_s=5.0))


def replica_rate(s, shards):
    """fig4's replica power cell (the wake-cost-aware replica router over a
    gated two-replica fleet at 0.5 qps), then a bursty trace with a short
    window that makes the autoscaler wake replicas."""
    c = s.cluster
    return [_run(s, shards, s.alpaca_trace(0.5), _replica_nodes(s),
                 c.ReplicaEnergyPolicy(),
                 autoscaler=c.ReplicaRatePolicy(idle_timeout_s=pair.IDLE_TIMEOUT_S)),
            _run(s, shards, c.bursty_trace(120, 1.0, burstiness=8.0, seed=4),
                 _replica_nodes(s), c.ReplicaEnergyPolicy(),
                 autoscaler=c.ReplicaRatePolicy(idle_timeout_s=5.0, window_s=30.0))]


def zeta_replan(s, shards):
    """The warm-start re-planner: the port's core.sweep.IncrementalScheduler
    under a bursty trace."""
    return _run(s, shards, s.cluster.bursty_trace(160, 6.0, burstiness=8.0, seed=13),
                s.nodes(), s.cluster.ZetaReplanPolicy(window=64))


def predictor_routers(s, shards):
    """fig4's information-gap cell: both energy routers pricing τout at the
    predictor's quantile."""
    c = s.cluster
    return [_run(s, shards, s.alpaca_trace(2.0), s.nodes(), pol)
            for pol in (c.ZetaOnlinePolicy(tau_out_predictor=c.TauOutPredictor()),
                        c.GreedyEnergyPolicy(tau_out_predictor=c.TauOutPredictor(
                            quantile=0.7, window=32, min_obs=2)))]


def slo_preempt(s, shards):
    return _run(s, shards, s.alpaca_trace(8.0), s.nodes(max_batch=2),
                s.cluster.ZetaOnlinePolicy(),
                preempter=s.cluster.SLOPreemptionPolicy(slowdown_slo=2.0,
                                                        min_remaining=2))


def slo_preempt_predictor(s, shards):
    c = s.cluster
    return _run(s, shards, s.alpaca_trace(8.0), s.nodes(max_batch=2),
                c.ZetaOnlinePolicy(tau_out_predictor=c.TauOutPredictor(min_obs=2)),
                preempter=c.SLOPreemptionPolicy(
                    slowdown_slo=1.5, min_remaining=2,
                    tau_out_predictor=c.TauOutPredictor(min_obs=2)))


def replica_preempt(s, shards):
    """fig4's replica cell at 8 qps: every router of the cell, with the SLO
    preempter, on the two-replica fleet."""
    c = s.cluster
    return [_run(s, shards, s.alpaca_trace(8.0), _replica_nodes(s), pol,
                 preempter=c.SLOPreemptionPolicy(slowdown_slo=2.0))
            for pol in (c.LeastLoadedPolicy(), c.ZetaOnlinePolicy(),
                        c.ReplicaEnergyPolicy(), c.ReplicaOraclePolicy())]


def governed_everything(s, shards):
    """fig4's telemetry-cell stack without telemetry: DVFS, predictor
    router, reactive gating and the preempter at once."""
    c = s.cluster
    return _run(s, shards, s.alpaca_trace(2.0), s.nodes(dvfs="per_phase"),
                c.ZetaOnlinePolicy(tau_out_predictor=c.TauOutPredictor()),
                autoscaler=c.ReactiveIdlePolicy(idle_timeout_s=pair.IDLE_TIMEOUT_S),
                preempter=c.SLOPreemptionPolicy(slowdown_slo=2.0))


SCENARIOS = {f.__name__: f for f in (
    dvfs_per_phase, reactive_idle, reactive_idle_dvfs, predictive_rate,
    replica_rate, zeta_replan, predictor_routers, slo_preempt,
    slo_preempt_predictor, replica_preempt, governed_everything)}


@pytest.mark.parametrize("shards", [1, 4])
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_power_preemption_replica_reports_identical(name, shards):
    ref, port = both(SCENARIOS[name], shards)
    assert port == ref


def test_scenarios_exercise_their_mechanisms():
    """The scenarios above reach what they are named for (in the port)."""
    rep = json.loads(slo_preempt(PORT, 1))
    assert rep["total_preemptions"] > 0
    rep = json.loads(reactive_idle(PORT, 1))
    assert sum(n["n_gates"] for n in rep["node_stats"]) > 0
    rep = json.loads(replica_rate(PORT, 1)[1])
    assert sum(n["n_wakes"] for n in rep["node_stats"]) > 0
    rep = json.loads(predictive_rate(PORT, 1))
    assert sum(n["n_wakes"] for n in rep["node_stats"]) > 0


# ---------------------------------------------------------------------------
# profiles fitted on the card: a negative predicted energy
# ---------------------------------------------------------------------------

# Eq. 6/7 coefficients (energy, runtime, A_K) that chip_smoke.py phase 6
# fitted on an NVIDIA H100 80GB HBM3 (700 W) from host-bound KV-off runs
# at τ ≤ 32.  llama2-13b's τin·τout coefficient is negative, so at fig4's
# request (τin, τout) = (225, 39) it predicts -9.38 J.
CARD_FITTED = {
    "llama2-7b": ((-0.10908761565673625, 1.552053224100415, 0.018504763525131966),
                  (-0.0037772943200347544, 0.053745725839910115, 0.0006400688868535826),
                  50.97),
    "llama2-13b": ((0.09903179725474161, 2.4401710443223665, -0.014453274581666252),
                   (0.003424232027759319, 0.0843960030987055, -0.0004988986273828707),
                   55.69)}


def card_fitted_run(s, k, zeta):
    em, c = s.em, s.cluster
    nodes = [c.ClusterNode(i, s.configs.PAPER_ZOO[name],
                           em.LLMProfile(name, em.BilinearModel(e), em.BilinearModel(r),
                                         em.AccuracyModel(a)),
                           s.energy.SWING_NODE, max_batch=pair.MAX_BATCH)
             for i, (name, (e, r, a)) in enumerate(CARD_FITTED.items())]
    return c.simulate_cluster(s.alpaca_trace(FIG4_RATE_QPS), nodes, s.fig4_policies()[k],
                              zeta=zeta, shards=1)


@pytest.mark.parametrize("k", [0, 1, 2, 4, 5])
@pytest.mark.parametrize("zeta", [0.5, 1.0])
def test_card_fitted_profiles_reports_identical(zeta, k):
    ref, port = both(lambda s: report_json(card_fitted_run(s, k, zeta)))
    assert port == ref


@pytest.mark.parametrize("zeta", [0.5, 1.0])
def test_greedy_energy_routes_a_negative_prediction(zeta):
    """The reference's greedy router keeps the predictions within
    `best * (1 + 1e-12)`, an empty band when the least predicted energy
    is negative, and raises.  The port's band is relative on either side
    of zero (the same band where the least prediction is >= 0), so it
    serves every request, the negative one on its argmin, and the offline
    oracle still bounds it."""
    with pytest.raises(ValueError, match="empty"):
        card_fitted_run(REF, 3, zeta)
    rep = card_fitted_run(PORT, 3, zeta)
    assert len(rep.records) == 200
    assert [r.model for r in rep.records if (r.tau_in, r.tau_out) == (225, 39)] \
        == ["llama2-13b"]
    assert card_fitted_run(PORT, 5, zeta).objective <= rep.objective + 1e-9


# ---------------------------------------------------------------------------
# OnlineRouter
# ---------------------------------------------------------------------------

def route_sequence(s, policy_name, zeta):
    """Route 60 requests of the Alpaca-like workload one at a time,
    completing the oldest outstanding request after every third route."""
    c = s.cluster
    policy = {"least_loaded": c.LeastLoadedPolicy,
              "zeta_online": c.ZetaOnlinePolicy}[policy_name]()
    router = s.serving.OnlineRouter(s.fig4_profiles(), policy=policy, zeta=zeta)
    queries = s.data.alpaca_like_workload(s.data.WorkloadSpec(n_queries=60, seed=3))
    out, open_ = [], []
    for i, (tin, tout) in enumerate(queries):
        req = s.serving.Request(request_id=i, tokens=np.zeros(int(tin), np.int32),
                                max_new_tokens=int(tout))
        est = None if i % 4 else max(1, int(tout) // 2)
        out.append(router.route_one(req, tau_out_estimate=est))
        assert req.model == out[-1]
        open_.append(req)
        if i % 3 == 2:
            router.complete(open_.pop(0))
        out.append(tuple(v.outstanding for v in router.views))
    # completing a request the router never saw is a no-op
    router.complete(s.serving.Request(request_id=10_000, tokens=np.zeros(1, np.int32),
                                      max_new_tokens=1))
    out.append(tuple(v.outstanding for v in router.views))
    return out


@pytest.mark.parametrize("zeta", [0.5, 1.0])
@pytest.mark.parametrize("policy_name", ["least_loaded", "zeta_online"])
def test_online_router_route_sequences_identical(policy_name, zeta):
    ref, port = both(route_sequence, policy_name, zeta)
    assert port == ref
    if policy_name == "least_loaded":   # load-driven: spreads over the fleet
        assert len(set(port[0:-1:2])) == 3


def test_online_router_rejects_the_offline_oracle():
    msgs = []
    for s in (REF, PORT):
        with pytest.raises(ValueError) as ei:
            s.serving.OnlineRouter(s.fig4_profiles(),
                                   policy=s.cluster.OfflineOraclePolicy())
        msgs.append(str(ei.value))
    # the same message, each pointing at its own package's simulator
    assert msgs[1] == msgs[0].replace("repro.cluster", "repro_torch.cluster")
    assert "repro_torch.cluster.simulate_cluster" in msgs[1]


# ---------------------------------------------------------------------------
# property: random small Poisson traces and policies
# ---------------------------------------------------------------------------

PROPERTY_POLICIES = ("round_robin", "random", "least_loaded", "greedy_energy",
                     "zeta_online", "offline_oracle", "replica_energy",
                     "zeta_replan")


def property_run(s, seed, n, rate, policy_name, zeta, max_batch, shards):
    c = s.cluster
    policy = {"round_robin": c.RoundRobinPolicy,
              "random": lambda: c.RandomPolicy(seed=seed),
              "least_loaded": c.LeastLoadedPolicy,
              "greedy_energy": c.GreedyEnergyPolicy,
              "zeta_online": c.ZetaOnlinePolicy,
              "offline_oracle": c.OfflineOraclePolicy,
              "replica_energy": c.ReplicaEnergyPolicy,
              "zeta_replan": lambda: c.ZetaReplanPolicy(window=16)}[policy_name]()
    return _run(s, shards, c.poisson_trace(n, rate, seed=seed),
                s.nodes(("llama2-7b", "llama2-13b", "llama2-7b"),
                        max_batch=max_batch),
                policy, zeta=zeta)


def check_identical(*args):
    ref, port = both(property_run, *args)
    assert port == ref


def test_seeded_random_traces_identical():
    """Seeded corners of the hypothesis property below; they run on every
    pass, hypothesis or not."""
    for args in [(0, 5, 0.5, "random", 0.5, 1, 1),
                 (7, 40, 12.0, "zeta_replan", 0.0, 2, 4),
                 (101, 24, 4.0, "greedy_energy", 1.0, 4, 3),
                 (2024, 17, 7.5, "offline_oracle", 0.3, 2, 2)]:
        check_identical(*args)


if HAVE_HYPOTHESIS:
    from hypothesis import given, settings, strategies as st

    @settings(max_examples=15, deadline=None)
    @given(seed=st.integers(0, 2 ** 16), n=st.integers(1, 40),
           rate=st.floats(0.2, 15.0), policy_name=st.sampled_from(PROPERTY_POLICIES),
           zeta=st.floats(0.0, 1.0), max_batch=st.integers(1, 8),
           shards=st.integers(1, 4))
    def test_random_poisson_traces_identical(seed, n, rate, policy_name, zeta,
                                             max_batch, shards):
        check_identical(seed, n, rate, policy_name, zeta, max_batch, shards)
