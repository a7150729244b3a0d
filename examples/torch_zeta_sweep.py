"""Reproduce the paper's Figure 3 (the zeta trade-off curves) as an ASCII
table on the PyTorch port: energy / runtime / accuracy vs zeta, with the
constant baselines.

The port of `examples/zeta_sweep.py` over `repro_torch`; it prints what the
reference prints.  `SETTINGS`, `ZETAS`, `fit_fleet` and `run` are a private
copy of the four names the reference takes from the Figure 3 benchmark
(`benchmarks/fig3_zeta_sweep.py`).  Host numpy only, as the reference.

    PYTHONPATH=src python examples/torch_zeta_sweep.py
"""

import numpy as np

from repro_torch.configs import CASE_STUDY_GAMMA, CASE_STUDY_MODELS, PAPER_ZOO, TABLE1
from repro_torch.core import scheduler
from repro_torch.core.characterize import (
    CampaignSettings,
    fit_profile_from_trials,
    run_campaign,
)
from repro_torch.data import alpaca_like_workload
from repro_torch.energy import AnalyticLLMSimulator

SETTINGS = CampaignSettings(grid_range=(8, 2048), max_trials=2, min_trials=2,
                            vary_input_range=(8, 8), vary_output_range=(8, 8),
                            seed=9)

ZETAS = np.round(np.linspace(0.0, 1.0, 11), 2)


def fit_fleet():
    profiles = []
    for name in CASE_STUDY_MODELS:
        sim = AnalyticLLMSimulator(PAPER_ZOO[name], kv_cache=False, seed=13)
        # per-query costs: batch-normalized measurements (the scheduler
        # assigns individual queries)
        trials = run_campaign(name, sim.measure_per_query, SETTINGS)
        profiles.append(fit_profile_from_trials(name, TABLE1[name]["a_k"], trials))
    return profiles


def run():
    profiles = fit_fleet()
    queries = alpaca_like_workload()
    # the paper's Eq. 2-5 objective (coverage + non-empty shares only):
    sweep = scheduler.zeta_sweep(profiles, queries, ZETAS)
    # deployment variant: gamma-capacitated partition (exactly binding when
    # sum(gamma) = 1 — counts are then fixed by gamma and only the query
    # MIX per model moves with zeta)
    capped = scheduler.zeta_sweep(profiles, queries, [0.0, 0.5, 1.0],
                                  gamma=CASE_STUDY_GAMMA)
    baselines = {
        "round_robin": scheduler.schedule_round_robin(profiles, queries),
        "random": scheduler.schedule_random(profiles, queries, seed=4),
        **{f"only_{p.name}": scheduler.schedule_single_model(profiles, queries, i)
           for i, p in enumerate(profiles)},
    }
    return profiles, queries, sweep, capped, baselines


def main():
    profiles, queries, sweep, capped, baselines = run()
    m = len(queries)
    w = 46

    def bar(v, vmax):
        n = int(v / vmax * w)
        return "#" * n

    emax = max(a.total_energy_j for a in sweep)
    print(f"{'zeta':>5} {'energy (J)':>12} {'s/query':>8} {'mean A_K':>8}")
    for z, a in zip(ZETAS, sweep):
        print(f"{z:5.2f} {a.total_energy_j:12.0f} "
              f"{a.total_runtime_s / m:8.3f} {a.mean_accuracy_ak:8.2f}  "
              f"|{bar(a.total_energy_j, emax)}")
    print("\nbaselines (constant in zeta):")
    for name, a in baselines.items():
        print(f"  {name:22s} E={a.total_energy_j:12.0f} J  "
              f"{a.total_runtime_s / m:6.3f} s/query  A_K={a.mean_accuracy_ak:.2f}")


if __name__ == "__main__":
    main()
