"""Core contribution of the paper: workload-based energy/runtime models,
the statistics pipeline behind them, and the offline energy-optimal
scheduler with its ζ-sweep engine."""

from repro_torch.core.energy_model import (  # noqa: F401
    AccuracyModel,
    BilinearModel,
    LLMProfile,
    NormalizedCosts,
    Query,
    fit_profile,
    load_profiles,
    normalized_costs,
    objective_matrix,
    save_profiles,
)
from repro_torch.core.scheduler import (  # noqa: F401
    Assignment,
    capacitated_optimality_certificate,
    schedule,
    schedule_capacitated,
    schedule_random,
    schedule_round_robin,
    schedule_single_model,
    zeta_sweep,
)
from repro_torch.core.sweep import (  # noqa: F401
    IncrementalScheduler,
    ParetoFrontier,
    frontier_breakpoints,
    pareto_frontier,
)
