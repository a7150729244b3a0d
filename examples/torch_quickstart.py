"""Quickstart on the PyTorch port: the paper's pipeline in one page.

1. Characterize two LLMs with the analytic energy simulator (A100 node).
2. Fit the workload-based energy/runtime models (Eq. 6/7) — check R^2.
3. Route a workload with the offline energy-optimal scheduler (Eq. 2).

The port of `examples/quickstart.py` over `repro_torch`; it prints what the
reference prints.  Host numpy only, as the reference.

    PYTHONPATH=src python examples/torch_quickstart.py
"""

from repro_torch.configs import PAPER_ZOO, TABLE1
from repro_torch.core import scheduler
from repro_torch.core.characterize import (
    CampaignSettings,
    fit_profile_from_trials,
    run_campaign,
)
from repro_torch.data import alpaca_like_workload
from repro_torch.energy import AnalyticLLMSimulator


def main():
    # 1+2: characterize + fit
    settings = CampaignSettings(grid_range=(8, 1024), max_trials=2,
                                min_trials=2,
                                vary_input_range=(8, 8),
                                vary_output_range=(8, 8))
    profiles = []
    for name in ("llama2-7b", "llama2-70b"):
        sim = AnalyticLLMSimulator(PAPER_ZOO[name], kv_cache=False)
        trials = run_campaign(name, sim.measure_per_query, settings)
        prof = fit_profile_from_trials(name, TABLE1[name]["a_k"], trials)
        print(f"{name}: e_K coeffs={['%.3g' % c for c in prof.energy.coeffs]} "
              f"R2={prof.energy.r_squared:.3f} (paper claims > 0.96)")
        profiles.append(prof)

    # 3: schedule 500 Alpaca-like queries at three operating points
    queries = alpaca_like_workload()
    for zeta in (0.0, 0.5, 1.0):
        asg = scheduler.schedule(profiles, queries, zeta)
        print(f"zeta={zeta:.1f}: energy={asg.total_energy_j:9.0f} J  "
              f"mean A_K={asg.mean_accuracy_ak:.2f}  "
              f"counts={dict(zip([p.name for p in profiles], asg.counts()))}")

    rr = scheduler.schedule_round_robin(profiles, queries)
    opt = scheduler.schedule(profiles, queries, 1.0)
    print(f"energy saving vs round-robin at zeta=1: "
          f"{1 - opt.total_energy_j / rr.total_energy_j:.1%}")


if __name__ == "__main__":
    main()
