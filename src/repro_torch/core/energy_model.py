"""Port copy of `repro.core.energy_model`, numpy only, with its imports renamed;
tests/test_torch_serve.py holds it to the reference.

Workload-based energy / runtime / accuracy models (paper §4 and §6.2).

The paper's per-LLM models:

    e_K(τin, τout) = α0·τin + α1·τout + α2·τin·τout        (Eq. 6)
    r_K(τin, τout) = β0·τin + β1·τout + β2·τin·τout        (Eq. 7)
    a_K(τin, τout) = A_K·τin + A_K·τout                    (Eq. 1)

fit by OLS per model (Table 3), plus the normalized counterparts
ê_K, â_K ∈ [0, 1] used by the scheduler objective (Eq. 2).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Mapping, Sequence

import numpy as np

from repro_torch.core import stats


Query = tuple[int, int]  # (tau_in, tau_out) — the paper's q = (τin, τout)


@dataclasses.dataclass(frozen=True)
class BilinearModel:
    """c0·τin + c1·τout + c2·τin·τout with fit diagnostics."""

    coeffs: tuple[float, float, float]
    r_squared: float = float("nan")
    f_statistic: float = float("nan")
    f_pvalue: float = float("nan")

    def __call__(self, tau_in, tau_out):
        c0, c1, c2 = self.coeffs
        tau_in = np.asarray(tau_in, dtype=np.float64)
        tau_out = np.asarray(tau_out, dtype=np.float64)
        return c0 * tau_in + c1 * tau_out + c2 * tau_in * tau_out

    @staticmethod
    def fit(
        tau_in: Sequence[float], tau_out: Sequence[float], y: Sequence[float]
    ) -> "BilinearModel":
        X = stats.bilinear_design(np.asarray(tau_in), np.asarray(tau_out))
        res = stats.ols(X, np.asarray(y, dtype=np.float64))
        return BilinearModel(
            coeffs=(float(res.params[0]), float(res.params[1]), float(res.params[2])),
            r_squared=res.r_squared,
            f_statistic=res.f_statistic,
            f_pvalue=res.f_pvalue,
        )

    def to_dict(self) -> dict:
        return {
            "coeffs": list(self.coeffs),
            "r_squared": self.r_squared,
            "f_statistic": self.f_statistic,
            "f_pvalue": self.f_pvalue,
        }

    @staticmethod
    def from_dict(d: Mapping) -> "BilinearModel":
        return BilinearModel(
            coeffs=tuple(d["coeffs"]),
            r_squared=d.get("r_squared", float("nan")),
            f_statistic=d.get("f_statistic", float("nan")),
            f_pvalue=d.get("f_pvalue", float("nan")),
        )


@dataclasses.dataclass(frozen=True)
class AccuracyModel:
    """a_K(τin, τout) = A_K·(τin + τout), A_K = leaderboard average (Eq. 1)."""

    a_k: float  # A_K in percent, e.g. 50.97 for Llama-2 7B

    def __call__(self, tau_in, tau_out):
        tau_in = np.asarray(tau_in, dtype=np.float64)
        tau_out = np.asarray(tau_out, dtype=np.float64)
        return self.a_k * tau_in + self.a_k * tau_out


@dataclasses.dataclass(frozen=True)
class LLMProfile:
    """Everything the scheduler needs to know about one hosted model K."""

    name: str
    energy: BilinearModel       # e_K, joules
    runtime: BilinearModel      # r_K, seconds
    accuracy: AccuracyModel     # a_K

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "energy": self.energy.to_dict(),
            "runtime": self.runtime.to_dict(),
            "a_k": self.accuracy.a_k,
        }

    @staticmethod
    def from_dict(d: Mapping) -> "LLMProfile":
        return LLMProfile(
            name=d["name"],
            energy=BilinearModel.from_dict(d["energy"]),
            runtime=BilinearModel.from_dict(d["runtime"]),
            accuracy=AccuracyModel(a_k=float(d["a_k"])),
        )


def fit_profile(
    name: str,
    a_k: float,
    tau_in: Sequence[float],
    tau_out: Sequence[float],
    energy_j: Sequence[float],
    runtime_s: Sequence[float],
) -> LLMProfile:
    """Fit e_K and r_K from a characterization campaign (paper §6.2)."""
    return LLMProfile(
        name=name,
        energy=BilinearModel.fit(tau_in, tau_out, energy_j),
        runtime=BilinearModel.fit(tau_in, tau_out, runtime_s),
        accuracy=AccuracyModel(a_k=a_k),
    )


# ---------------------------------------------------------------------------
# Normalization (the ê_K / â_K of Eq. 2)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class NormalizedCosts:
    """Pre-computed ê_K(q) and â_K(q) for a workload × model-set.

    The paper: "we dynamically normalize our energy and accuracy measures
    across all the queries ... by dividing by the largest known value of
    energy and accuracy prior to optimization."
    """

    model_names: tuple[str, ...]
    queries: tuple[Query, ...]
    energy: np.ndarray          # (m, K) raw joules
    accuracy: np.ndarray        # (m, K) raw a_K values
    runtime: np.ndarray         # (m, K) raw seconds
    energy_hat: np.ndarray      # (m, K) in [0, 1]
    accuracy_hat: np.ndarray    # (m, K) in [0, 1]


def normalized_costs(
    profiles: Sequence[LLMProfile], queries: Sequence[Query]
) -> NormalizedCosts:
    tin = np.array([q[0] for q in queries], dtype=np.float64)
    tout = np.array([q[1] for q in queries], dtype=np.float64)
    energy = np.stack([p.energy(tin, tout) for p in profiles], axis=1)
    runtime = np.stack([p.runtime(tin, tout) for p in profiles], axis=1)
    acc = np.stack([p.accuracy(tin, tout) for p in profiles], axis=1)

    e_max = float(energy.max())
    a_max = float(acc.max())
    e_hat = energy / e_max if e_max > 0 else energy
    a_hat = acc / a_max if a_max > 0 else acc
    return NormalizedCosts(
        model_names=tuple(p.name for p in profiles),
        queries=tuple((int(a), int(b)) for a, b in queries),
        energy=energy,
        runtime=runtime,
        accuracy=acc,
        energy_hat=e_hat,
        accuracy_hat=a_hat,
    )


def objective_matrix(costs: NormalizedCosts, zeta: float) -> np.ndarray:
    """Per-(query, model) cost of Eq. 2: ζ·ê_K(q) − (1−ζ)·â_K(q)."""
    if not 0.0 <= zeta <= 1.0:
        raise ValueError(f"zeta must be in [0, 1], got {zeta}")
    return zeta * costs.energy_hat - (1.0 - zeta) * costs.accuracy_hat


# ---------------------------------------------------------------------------
# (De)serialization of a fitted fleet
# ---------------------------------------------------------------------------


def save_profiles(profiles: Sequence[LLMProfile], path: str) -> None:
    with open(path, "w") as f:
        json.dump([p.to_dict() for p in profiles], f, indent=2)


def load_profiles(path: str) -> list[LLMProfile]:
    with open(path) as f:
        return [LLMProfile.from_dict(d) for d in json.load(f)]
