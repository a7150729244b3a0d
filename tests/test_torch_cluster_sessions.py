"""The port's conversational serving (session traces, the per-node KV
prefix cache, SessionAffinityPolicy, the cache-aware oracle) against the
reference's, run live at the same seeds: fig4's session cell (depth x
cache capacity) and the golden session replay of tests/test_sessions.py.
Reports are held byte-identical to the live reference run, at 1 and 4
shards.  The committed golden fixture is held only to rel 1e-12, because
the reference itself no longer reproduces it byte for byte (see
`test_golden_run_against_committed_fixture`).
"""

import json
import math
import pathlib

import pytest

import torch_cluster_pair as pair
from torch_cluster_pair import PORT, both, report_json

GOLDEN = pathlib.Path(__file__).parent / "data" / "golden_session_report.json"

SESSION_N = 40
SESSION_RATE_QPS = 0.4
SESSION_THINK_S = 10.0
SESSION_SMALL_TOKENS = 1500   # fig4: ~1.5k tokens of KV per node


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    yield from pair.one_thread()


def cache_point(s, tag):
    c = s.cluster
    if tag == "disabled":
        return None
    if tag == "small":
        small = SESSION_SMALL_TOKENS * s.energy.kv_bytes_per_token(
            s.configs.PAPER_ZOO["llama2-13b"])
        return c.PrefixCacheConfig(capacity_bytes=small)
    return c.PrefixCacheConfig()


def session_cell(s, depth, tag, shards):
    """fig4_online_gap.session_cells at one (depth, capacity) point: the
    session-sticky router under a live auditor, then the cache-aware
    oracle replay conditioned on the hit sequence that run realized, and
    both runs' Eq. 2 objectives under the same discounted cost matrix."""
    c = s.cluster
    trace = c.session_trace(SESSION_N, turns=depth, think_s=SESSION_THINK_S,
                            rate_qps=SESSION_RATE_QPS, seed=17,
                            name=f"sessions@depth{depth}")
    cache = cache_point(s, tag)
    tel = s.obs.Telemetry(auditor=s.obs.InvariantAuditor())
    rep = c.simulate_cluster(trace, s.nodes(prefix_cache=cache),
                             c.SessionAffinityPolicy(), zeta=0.5,
                             telemetry=tel, shards=shards)
    out = [[(r.request_id, r.session_id, r.turn, r.prefix_tokens)
            for r in trace.requests], report_json(rep), tel.auditor.n_checks]
    if cache is not None:
        cached = c.realized_cache_hits(rep.records)
        cvec = [cached.get(r.request_id, 0) for r in trace.requests]
        orep = c.simulate_cluster(trace, s.nodes(prefix_cache=cache),
                                  c.CacheAwareOraclePolicy(cached), zeta=0.5,
                                  shards=shards)
        profiles = s.fig4_profiles()
        objectives = []
        for r_ in (rep, orep):
            model_of = {r.request_id: r.model for r in r_.records}
            objectives.append(c.objective_of_assignment(
                profiles, trace.queries(),
                [model_of[r.request_id] for r in trace.requests], 0.5,
                cached=cvec))
        out += [sorted(cached.items()), report_json(orep), objectives]
    return out


@pytest.mark.parametrize("shards", [1, 4])
@pytest.mark.parametrize("tag", ["disabled", "small", "ample"])
@pytest.mark.parametrize("depth", [2, 8])
def test_session_cell_identical(depth, tag, shards):
    ref, port = both(session_cell, depth, tag, shards)
    assert port == ref
    if tag != "disabled":
        online, oracle = port[5]
        assert oracle <= online + 1e-9


def test_session_workload_identical():
    def run(s):
        return [s.data.workloads.session_workload(6, turns=t, seed=seed)
                for t in (1, 4) for seed in (0, 9)]

    ref, port = both(run)
    assert port == ref


# ---------------------------------------------------------------------------
# the golden session replay of tests/test_sessions.py
# ---------------------------------------------------------------------------

GOLDEN_POINTS = ((8, 8), (64, 64), (256, 128), (512, 512), (128, 32))


def golden_run(s):
    """tests/test_sessions.golden_run, built in one package: 8 sessions of
    5 turns over a 4-node llama2-7b/13b fleet with prefix caches,
    SessionAffinityPolicy, a live auditor."""
    c = s.cluster
    trace = c.session_trace(8, turns=5, think_s=12.0, rate_qps=0.4, seed=42)
    names = ("llama2-7b", "llama2-13b", "llama2-7b", "llama2-13b")
    nodes = [c.ClusterNode(i, s.configs.PAPER_ZOO[n],
                           s.profile(n, points=GOLDEN_POINTS), s.energy.SWING_NODE,
                           max_batch=2, prefix_cache=c.PrefixCacheConfig())
             for i, n in enumerate(names)]
    return c.simulate_cluster(trace, nodes, c.SessionAffinityPolicy(), zeta=0.5,
                              telemetry=s.obs.Telemetry(auditor=s.obs.InvariantAuditor()))


def test_golden_run_identical_to_live_reference():
    ref, port = both(lambda s: json.dumps(golden_run(s).to_dict(include_records=True),
                                          sort_keys=True))
    assert port == ref


def _close(got, want, path=""):
    """Structure, strings and integers equal; floats within rel 1e-12."""
    if isinstance(want, dict):
        assert got.keys() == want.keys(), path
        for k in want:
            _close(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{path}[{i}]")
    elif isinstance(want, float):
        assert isinstance(got, float) and math.isclose(got, want, rel_tol=1e-12), \
            (path, got, want)
    else:
        assert got == want, path


def test_golden_run_against_committed_fixture():
    """The committed fixture was written by an earlier run of the
    reference.  Today the reference's own golden run differs from it in one
    number, the top-level `predicted_energy_j`, by one ulp
    (6576.157107027579 against the fixture's ...578), so it fails its own
    byte-for-byte test.  The port equals the live reference byte for byte
    (above) and is held to the fixture at rel 1e-12, which that one-ulp
    difference meets."""
    got = golden_run(PORT).to_dict(include_records=True)
    want = json.loads(GOLDEN.read_text())
    _close(got, want)
    assert got["total_cache_hits"] == want["total_cache_hits"] > 0
