"""Port copy of `repro.core.characterize`, numpy only, with its imports renamed;
tests/test_torch_serve.py holds it to the reference.

Characterization campaign runner (paper §5.1).

Runs the paper's three experimental conditions against any measurement
backend (`measure(tau_in, tau_out) -> (energy_j, runtime_s)`):

  * vary-input:  τin ∈ {8 … 2048} powers of two, τout = 32      (§5.1.1)
  * vary-output: τout ∈ {8 … 4096} powers of two, τin = 32      (§5.1.2)
  * grid:        τin, τout ∈ {8 … 2048} powers of two           (§6.1, ANOVA)

with randomized trial order and the CI stopping criterion of §5.1.3
(95% CI half-width ≤ 0.5 s, at most 25 trials).
"""

from __future__ import annotations

import dataclasses
import random
from typing import Callable, Iterable, Sequence

import numpy as np

from repro_torch.core import stats
from repro_torch.core.energy_model import LLMProfile, fit_profile

MeasureFn = Callable[[int, int], tuple[float, float]]  # -> (energy_j, runtime_s)
# arrays of (tau_in, tau_out) -> (energy_j[], runtime_s[])
MeasureBatchFn = Callable[[np.ndarray, np.ndarray], tuple[np.ndarray, np.ndarray]]


@dataclasses.dataclass(frozen=True)
class Trial:
    model: str
    condition: str          # "vary_input" | "vary_output" | "grid"
    tau_in: int
    tau_out: int
    trial_index: int
    energy_j: float
    runtime_s: float


@dataclasses.dataclass(frozen=True)
class CampaignSettings:
    vary_input_range: tuple[int, int] = (8, 2048)    # §5.1.1
    vary_input_fixed_out: int = 32
    vary_output_range: tuple[int, int] = (8, 4096)   # §5.1.2
    vary_output_fixed_in: int = 32
    grid_range: tuple[int, int] = (8, 2048)          # §6.1
    ci_tolerance_s: float = 0.5                      # §5.1.3 (i)
    max_trials: int = 25                             # §5.1.3 (ii)
    min_trials: int = 2
    seed: int = 0


def _pow2_levels(lo: int, hi: int) -> list[int]:
    out = []
    v = lo
    while v <= hi:
        out.append(v)
        v *= 2
    return out


def _conditions(settings: CampaignSettings) -> list[tuple[str, int, int]]:
    conds: list[tuple[str, int, int]] = []
    for tin in _pow2_levels(*settings.vary_input_range):
        conds.append(("vary_input", tin, settings.vary_input_fixed_out))
    for tout in _pow2_levels(*settings.vary_output_range):
        conds.append(("vary_output", settings.vary_output_fixed_in, tout))
    for tin in _pow2_levels(*settings.grid_range):
        for tout in _pow2_levels(*settings.grid_range):
            conds.append(("grid", tin, tout))
    return conds


def run_campaign(
    model_name: str,
    measure: MeasureFn | None,
    settings: CampaignSettings = CampaignSettings(),
    *,
    measure_batch: MeasureBatchFn | None = None,
) -> list[Trial]:
    """Run the full §5.1 campaign for one model; returns all trials.

    With `measure` (scalar backend) trials run one (τin, τout, trial) at a
    time.  With `measure_batch` (e.g. `AnalyticLLMSimulator.measure_batch`)
    the campaign runs round-based: every still-active condition gets its
    next trial from ONE vectorized call per round, and the §5.1.3 stopping
    rule is checked for the whole grid at once
    (`stats.should_stop_trials_batch`) — the same adaptive-trial semantics,
    orders of magnitude fewer backend calls."""
    rng = random.Random(settings.seed)
    conds = _conditions(settings)
    rng.shuffle(conds)  # §5.1.3 randomized order

    if measure_batch is not None:
        return _run_campaign_batched(model_name, measure_batch, conds, settings)
    if measure is None:
        raise ValueError("need a measure or measure_batch backend")

    trials: list[Trial] = []
    for condition, tin, tout in conds:
        runtimes: list[float] = []
        while True:
            energy, runtime = measure(tin, tout)
            trials.append(
                Trial(
                    model=model_name,
                    condition=condition,
                    tau_in=tin,
                    tau_out=tout,
                    trial_index=len(runtimes),
                    energy_j=float(energy),
                    runtime_s=float(runtime),
                )
            )
            runtimes.append(float(runtime))
            if len(runtimes) >= settings.min_trials and stats.should_stop_trials(
                runtimes,
                tolerance_s=settings.ci_tolerance_s,
                max_trials=settings.max_trials,
            ):
                break
    return trials


def _run_campaign_batched(
    model_name: str,
    measure_batch: MeasureBatchFn,
    conds: list[tuple[str, int, int]],
    settings: CampaignSettings,
) -> list[Trial]:
    """Round-based campaign: one `measure_batch` call per trial round.

    Every active condition has the same trial count within a round, so the
    stopping rule vectorizes over the whole (conditions, trials) matrix."""
    trials: list[Trial] = []
    active = list(range(len(conds)))
    runtime_hist: list[list[float]] = [[] for _ in conds]
    round_no = 0
    while active:
        tin = np.array([conds[c][1] for c in active], dtype=np.int64)
        tout = np.array([conds[c][2] for c in active], dtype=np.int64)
        energy, runtime = measure_batch(tin, tout)
        for c, e, r in zip(active, energy, runtime):
            condition, ti, to = conds[c]
            trials.append(
                Trial(
                    model=model_name,
                    condition=condition,
                    tau_in=ti,
                    tau_out=to,
                    trial_index=round_no,
                    energy_j=float(e),
                    runtime_s=float(r),
                )
            )
            runtime_hist[c].append(float(r))
        round_no += 1
        if round_no >= settings.min_trials:
            mat = np.array([runtime_hist[c] for c in active], dtype=np.float64)
            stop = stats.should_stop_trials_batch(
                mat,
                tolerance_s=settings.ci_tolerance_s,
                max_trials=settings.max_trials,
            )
            active = [c for c, s in zip(active, stop) if not s]
    return trials


def trials_to_arrays(
    trials: Iterable[Trial], *, conditions: Sequence[str] | None = None
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(tau_in, tau_out, energy, runtime) arrays, optionally filtered."""
    sel = [
        t for t in trials if conditions is None or t.condition in conditions
    ]
    tin = np.array([t.tau_in for t in sel], dtype=np.float64)
    tout = np.array([t.tau_out for t in sel], dtype=np.float64)
    e = np.array([t.energy_j for t in sel], dtype=np.float64)
    r = np.array([t.runtime_s for t in sel], dtype=np.float64)
    return tin, tout, e, r


def fit_profile_from_trials(
    model_name: str, a_k: float, trials: Iterable[Trial]
) -> LLMProfile:
    """Fit the paper's Eq. 6/7 models from the grid condition (as §6.1/6.2:
    'grid search … to eliminate the bias of holding the input or output size
    constant')."""
    tin, tout, e, r = trials_to_arrays(trials, conditions=("grid",))
    if len(tin) == 0:  # fall back to all conditions
        tin, tout, e, r = trials_to_arrays(trials)
    return fit_profile(model_name, a_k, tin, tout, e, r)


def anova_from_trials(trials: Iterable[Trial]) -> dict[str, stats.AnovaResult]:
    """Two-way ANOVA on the grid data (paper Table 2), for energy & runtime.

    Aggregates across models as the paper does ('data aggregated across all
    models in Table 1').
    """
    sel = [t for t in trials if t.condition == "grid"]
    tin = [t.tau_in for t in sel]
    tout = [t.tau_out for t in sel]
    e = [t.energy_j for t in sel]
    r = [t.runtime_s for t in sel]
    return {
        "energy": stats.anova_two_way(tin, tout, e),
        "runtime": stats.anova_two_way(tin, tout, r),
    }


def trials_to_csv(trials: Iterable[Trial], path: str) -> None:
    with open(path, "w") as f:
        f.write("model,condition,tau_in,tau_out,trial_index,energy_j,runtime_s\n")
        for t in trials:
            f.write(
                f"{t.model},{t.condition},{t.tau_in},{t.tau_out},"
                f"{t.trial_index},{t.energy_j:.6f},{t.runtime_s:.6f}\n"
            )
