"""The PyTorch port's analytic energy stack against the JAX package.

The structural cost model (`energy/costs.py`), the roofline simulator
(`energy/simulator.py`, with its closed-form decode integral, noise stream,
memos and DVFS governor), the ζ-sweep engine (`core/sweep.py`) and the
parameter counts behind them are numpy float64 in both packages, in the
same order of operations: every value must equal the reference's (`==`).
No weights are needed, so everything runs at the full published configs:
the paper's zoo, the ten assigned archs and their `-reduced` variants.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import list_archs as jlist_archs
from repro.core import characterize as jchar
from repro.core import scheduler as jsched
from repro.core import sweep as jsweep
from repro.core.energy_model import normalized_costs as jnormalized
from repro.data import workloads as jwl
from repro.energy import costs as jcosts
from repro.energy.simulator import AnalyticLLMSimulator as JSim
from repro.models import active_params as jactive
from repro.models import get_api as jget_api
from repro_torch.configs import (
    CASE_STUDY_GAMMA,
    CASE_STUDY_MODELS,
    PAPER_ZOO,
    TABLE1,
    get_config,
    list_archs,
)
from repro_torch.core import characterize, scheduler, sweep
from repro_torch.core.energy_model import LLMProfile, normalized_costs
from repro_torch.data import workloads
from repro_torch.energy import costs
from repro_torch.energy.simulator import AnalyticLLMSimulator
from repro_torch.models import active_params, get_api

ARCHS = list_archs()
ALL_CONFIGS = ARCHS + [a + "-reduced" for a in ARCHS]

# one config per family branch of the cost model (tests/test_cost_kernels.py's
# six, plus encdec and vlm)
FAMILY_ARCHS = {
    "dense": "llama2-7b", "moe": "mixtral-8x7b", "windowed": "mistral-7b",
    "ssm": "mamba2-130m", "hybrid": "recurrentgemma-9b", "mla": "deepseek-v3-671b",
    "encdec": "seamless-m4t-large-v2", "vlm": "internvl2-2b",
}
# crosses the mistral/recurrentgemma window clamps, the MoE saturation
# point, tiny phases, and the τout = 0 prefill-only edge
TIN = [1, 2, 8, 100, 512, 3000, 4095, 4096, 5000, 64]
TOUT = [1, 3, 100, 4096, 512, 2000, 2, 1, 0, 300]
# new tokens x context x batch: across every window (2048, 4096) and the
# MoE saturation points n_experts / (batch top_k) (4, 5, 32 at batch 1)
NEW_TOKENS = [1, 2, 3, 4, 5, 31, 32, 33, 512, 4096]
CONTEXTS = [1, 2, 100, 2047, 2048, 2049, 4095, 4096, 4097, 32768]
BATCHES = [1, 4, 32]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Run torch on one CPU thread here, as every port test file does: with
    several pytest-xdist workers torch's default threads oversubscribe the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pc(p):
    return p.flops, p.hbm_bytes


class TestRegistry:
    def test_both_registries_list_the_same_archs(self):
        assert list_archs() == jlist_archs()

    @pytest.mark.parametrize("arch", ALL_CONFIGS)
    def test_config_and_param_counts_match_reference(self, arch):
        cfg, jcfg = get_config(arch), jget_config(arch)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert get_api(cfg).count_params(cfg) == jget_api(jcfg).count_params(jcfg)
        assert active_params(cfg) == jactive(jcfg)


class TestCosts:
    @pytest.mark.parametrize("arch", ALL_CONFIGS)
    def test_pass_costs_match_reference(self, arch):
        cfg, jcfg = get_config(arch), jget_config(arch)
        assert costs.kv_bytes_per_token(cfg) == jcosts.kv_bytes_per_token(jcfg)
        assert costs.attention_window(cfg) == jcosts.attention_window(jcfg)
        for iw in (True, False):
            for dec in (True, False, None):
                for nt in NEW_TOKENS:
                    for ctx in CONTEXTS:
                        for bt in BATCHES:
                            assert _pc(costs.pass_costs(cfg, nt, ctx, bt, include_weights=iw,
                                                        decode=dec)) == \
                                _pc(jcosts.pass_costs(jcfg, nt, ctx, bt, include_weights=iw,
                                                      decode=dec)), (iw, dec, nt, ctx, bt)
        nt, ctx, bt = (np.array(v, dtype=float).reshape(s) for v, s in (
            (NEW_TOKENS, (-1, 1, 1)), (CONTEXTS, (1, -1, 1)), (BATCHES, (1, 1, -1))))
        for iw in (True, False):
            for dec in (True, False):
                ours = costs.pass_costs_batch(cfg, nt, ctx, bt, include_weights=iw, decode=dec)
                ref = jcosts.pass_costs_batch(jcfg, nt, ctx, bt, include_weights=iw, decode=dec)
                np.testing.assert_array_equal(ours.flops, ref.flops)
                np.testing.assert_array_equal(ours.hbm_bytes, ref.hbm_bytes)

    @pytest.mark.parametrize("arch", ALL_CONFIGS)
    def test_decode_step_polys_match_reference(self, arch):
        cfg, jcfg = get_config(arch), jget_config(arch)
        for reprefix in (True, False):
            for bt in BATCHES:
                assert costs.decode_step_breakpoints(cfg, bt, reprefix=reprefix) == \
                    jcosts.decode_step_breakpoints(jcfg, bt, reprefix=reprefix)
                for lo, hi in ((0.5, 0.5), (1.5, 3.5), (1.5, 100.5), (100.5, 5000.5),
                               (2000.5, 2100.5), (0.5, 40000.5)):
                    for iw in (True, False):
                        ours = costs.decode_step_polys(cfg, bt, lo, hi, reprefix=reprefix,
                                                       include_weights=iw)
                        ref = jcosts.decode_step_polys(jcfg, bt, lo, hi, reprefix=reprefix,
                                                       include_weights=iw)
                        assert [dataclasses.astuple(s) for s in ours] == \
                            [dataclasses.astuple(s) for s in ref], (reprefix, bt, lo, hi, iw)
        with pytest.raises(ValueError):
            costs.decode_step_polys(cfg, 1, 2.0, 1.0, reprefix=True)

    @pytest.mark.parametrize("arch", ["llama2-70b", "mistral-7b", "recurrentgemma-9b",
                                      "deepseek-v3-671b", "mixtral-8x7b"])
    def test_fp8_cache_halves_kv_bytes_as_the_reference(self, arch):
        cfg = get_config(arch).replace(cache_dtype="float8_e4m3fn")
        jcfg = jget_config(arch).replace(cache_dtype="float8_e4m3fn")
        assert costs.dtype_bytes("float8_e4m3fn") == 1
        assert costs.dtype_bytes("bfloat16") == 2 and costs.dtype_bytes("float32") == 4
        kvb = costs.kv_bytes_per_token(cfg)
        assert kvb == jcosts.kv_bytes_per_token(jcfg)
        assert 2 * kvb == costs.kv_bytes_per_token(get_config(arch))
        for dec in (True, False):
            assert _pc(costs.pass_costs(cfg, 1, 3000, 8, decode=dec)) == \
                _pc(jcosts.pass_costs(jcfg, 1, 3000, 8, decode=dec))


def _sims(arch, kv, **kw):
    return (AnalyticLLMSimulator(get_config(arch), kv_cache=kv, **kw),
            JSim(jget_config(arch), kv_cache=kv, **kw))


class TestSimulator:
    @pytest.mark.parametrize("kv", [True, False])
    @pytest.mark.parametrize("family", sorted(FAMILY_ARCHS))
    def test_phase_costs_and_governor_match_reference(self, family, kv):
        ours, ref = _sims(FAMILY_ARCHS[family], kv, batch=4, noise_sigma=0.0)
        assert dataclasses.asdict(ours.node) == dataclasses.asdict(ref.node)
        assert ours.host_power_w == ref.host_power_w
        scales = ours.node.accel.dvfs_scales
        assert len(scales) > 1
        for tin, tout in zip(TIN, TOUT):
            assert dataclasses.astuple(ours.simulate(tin, tout)) == \
                dataclasses.astuple(ref.simulate(tin, tout))
            for s in scales:
                assert ours.prefill_cost(tin, freq_scale=s) == ref.prefill_cost(tin, freq_scale=s)
                assert ours.decode_cost(tin, tout, freq_scale=s) == \
                    ref.decode_cost(tin, tout, freq_scale=s)
                assert ours.decode_cost_chunked(tin, tout, 8, freq_scale=s) == \
                    ref.decode_cost_chunked(tin, tout, 8, freq_scale=s)
            if tout <= 512:
                assert ours.decode_cost_chunked(tin, tout, chunk=1) == \
                    ref.decode_cost_chunked(tin, tout, chunk=1)
            w = ours.host_power_w
            assert ours.best_prefill_frequency(tin, extra_w=w) == \
                ref.best_prefill_frequency(tin, extra_w=w)
            assert ours.best_decode_frequency(tin, tout, 2, extra_w=w) == \
                ref.best_decode_frequency(tin, tout, 2, extra_w=w)
            assert ours.best_decode_frequency(tin, tout) == ref.best_decode_frequency(tin, tout)
        for a, b in zip(ours.prefill_cost_batch(np.array(TIN)),
                        ref.prefill_cost_batch(np.array(TIN))):
            np.testing.assert_array_equal(a, b)

    @pytest.mark.parametrize("family", sorted(FAMILY_ARCHS))
    def test_noise_stream_matches_reference(self, family):
        ours, ref = _sims(FAMILY_ARCHS[family], False, seed=11)
        for tin, tout in zip(TIN, TOUT):
            assert ours.measure(tin, tout) == ref.measure(tin, tout)
            assert ours.measure_per_query(tin, tout) == ref.measure_per_query(tin, tout)
        for a, b in zip(ours.measure_batch(TIN + TIN, TOUT + TOUT),
                        ref.measure_batch(TIN + TIN, TOUT + TOUT)):
            np.testing.assert_array_equal(a, b)
        assert ours.measure(64, 64) == ref.measure(64, 64)

    def test_private_memos_and_batch_override(self):
        ours, ref = _sims("llama2-13b", True, batch=8, shared_memos=False)
        assert ours.prefill_cost(100, batch=1) == ref.prefill_cost(100, batch=1)
        assert ours.decode_cost(100, 50, batch=2) == ref.decode_cost(100, 50, batch=2)
        assert ours.decode_cost(100, 0) == (0.0, 0.0)


def fitted_profiles():
    """Reference profiles of the case-study fleet, fitted from a short
    analytic campaign, carried to the port by value."""
    settings = jchar.CampaignSettings(grid_range=(8, 256), max_trials=2, min_trials=2,
                                      vary_input_range=(8, 8), vary_output_range=(8, 8),
                                      seed=9)
    ref = []
    for name in CASE_STUDY_MODELS:
        sim = JSim(jget_config(name), kv_cache=False, seed=13)
        trials = jchar.run_campaign(name, sim.measure_per_query, settings)
        ref.append(jchar.fit_profile_from_trials(name, TABLE1[name]["a_k"], trials))
    return [LLMProfile.from_dict(p.to_dict()) for p in ref], ref


@pytest.fixture(scope="module")
def fleet():
    ours, ref = fitted_profiles()
    queries = jwl.alpaca_like_workload(jwl.WorkloadSpec(n_queries=150, seed=3))
    assert queries == workloads.alpaca_like_workload(workloads.WorkloadSpec(n_queries=150,
                                                                            seed=3))
    return ours, ref, queries


def _same_assignment(a, b):
    assert a.model_names == b.model_names
    np.testing.assert_array_equal(a.assignee, b.assignee)
    assert (a.objective, a.total_energy_j, a.total_runtime_s, a.total_accuracy,
            a.mean_accuracy_ak) == (b.objective, b.total_energy_j, b.total_runtime_s,
                                    b.total_accuracy, b.mean_accuracy_ak)


class TestSweep:
    @pytest.mark.parametrize("gamma", [None, CASE_STUDY_GAMMA])
    def test_pareto_frontier_grid_matches_reference(self, fleet, gamma):
        ours, ref, qs = fleet
        zetas = np.round(np.linspace(0.0, 1.0, 9), 3)
        a = sweep.pareto_frontier(ours, qs, zetas, gamma=gamma, check=gamma is not None)
        b = jsweep.pareto_frontier(ref, qs, zetas, gamma=gamma, check=gamma is not None)
        assert a.zetas == b.zetas and a.breakpoints is b.breakpoints is None
        for x, y in zip(a.assignments, b.assignments, strict=True):
            _same_assignment(x, y)

    def test_pareto_frontier_breakpoints_match_reference(self, fleet):
        ours, ref, qs = fleet
        a = sweep.pareto_frontier(ours, qs, breakpoints=True)
        b = jsweep.pareto_frontier(ref, qs, breakpoints=True)
        assert a.breakpoints == b.breakpoints and a.zetas == b.zetas
        assert len(a.breakpoints) > 0
        for x, y in zip(a.assignments, b.assignments, strict=True):
            _same_assignment(x, y)
        np.testing.assert_array_equal(sweep.frontier_breakpoints(normalized_costs(ours, qs)),
                                      jsweep.frontier_breakpoints(jnormalized(ref, qs)))

    def test_incremental_reschedule_matches_reference(self, fleet):
        ours, ref, qs = fleet
        a = sweep.IncrementalScheduler(ours, qs[:100], 0.4, CASE_STUDY_GAMMA, check=True)
        b = jsweep.IncrementalScheduler(ref, qs[:100], 0.4, CASE_STUDY_GAMMA, check=True)
        _same_assignment(a.assignment, b.assignment)
        edits = [dict(added=qs[100:130]),
                 dict(removed=list(range(0, 60, 3))),
                 dict(capacity_deltas=np.array([2, -3, 1])),
                 dict(added=qs[130:150], removed=[1, 2, 100, 101], zeta=0.7),
                 dict(capacity_deltas=np.array([-1, 0, 1]), zeta=0.2)]
        for edit in edits:
            _same_assignment(a.reschedule(**edit), b.reschedule(**edit))
            np.testing.assert_array_equal(a.active_ids, b.active_ids)
            assert a.next_id == b.next_id
        assert a.active_queries() == b.active_queries()


def case_study(pkg):
    """benchmarks/fig3_zeta_sweep.py's run(): the paper's §6.3 case study
    through one package's modules."""
    sim_cls, char, sched, wl, get = pkg
    settings = char.CampaignSettings(grid_range=(8, 2048), max_trials=2, min_trials=2,
                                     vary_input_range=(8, 8), vary_output_range=(8, 8),
                                     seed=9)
    profiles = []
    for name in CASE_STUDY_MODELS:
        sim = sim_cls(get(name), kv_cache=False, seed=13)
        trials = char.run_campaign(name, sim.measure_per_query, settings)
        profiles.append(char.fit_profile_from_trials(name, TABLE1[name]["a_k"], trials))
    queries = wl.alpaca_like_workload()
    sweep_ = sched.zeta_sweep(profiles, queries, np.round(np.linspace(0.0, 1.0, 11), 2))
    capped = sched.zeta_sweep(profiles, queries, [0.0, 0.5, 1.0], gamma=CASE_STUDY_GAMMA)
    baselines = [sched.schedule_round_robin(profiles, queries),
                 sched.schedule_random(profiles, queries, seed=4)]
    baselines += [sched.schedule_single_model(profiles, queries, i)
                  for i in range(len(profiles))]
    return profiles, sweep_, capped, baselines


class TestCaseStudy:
    def test_fig3_case_study_matches_reference(self):
        """Coefficients, R², assignments and totals identical."""
        assert set(CASE_STUDY_MODELS) <= set(PAPER_ZOO)
        ours = case_study((AnalyticLLMSimulator, characterize, scheduler, workloads,
                           get_config))
        ref = case_study((JSim, jchar, jsched, jwl, jget_config))
        assert [p.to_dict() for p in ours[0]] == [p.to_dict() for p in ref[0]]
        for p in ours[0]:
            assert 0.9 < p.energy.r_squared <= 1.0 and 0.9 < p.runtime.r_squared <= 1.0
        for a_list, b_list in zip(ours[1:], ref[1:]):
            for a, b in zip(a_list, b_list, strict=True):
                _same_assignment(a, b)
        energies = [a.total_energy_j for a in ours[1]]
        assert all(b <= a + 1e-6 for a, b in zip(energies, energies[1:]))
