"""Port copy of `repro.core.stats`, numpy only, with its imports renamed;
tests/test_torch_serve.py holds it to the reference.

Statistical machinery for the paper's modeling pipeline.

Implements, dependency-free (numpy only):

  * ordinary least squares with the summary statistics the paper reports
    (R^2, overall F-statistic, p-value) — Table 3 of the paper,
  * two-way ANOVA with interaction — Table 2 of the paper,
  * the F-distribution survival function via the regularized incomplete
    beta function (Lentz continued fraction), since scipy/statsmodels are
    not available in this environment,
  * Student-t critical values for the paper's §5.1.3 confidence-interval
    stopping criterion.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np

# ---------------------------------------------------------------------------
# Special functions
# ---------------------------------------------------------------------------

_BETACF_MAX_ITER = 300
_BETACF_EPS = 3.0e-12
_BETACF_FPMIN = 1.0e-300


def _betacf(a: float, b: float, x: float) -> float:
    """Continued fraction for the incomplete beta function (Lentz)."""
    qab = a + b
    qap = a + 1.0
    qam = a - 1.0
    c = 1.0
    d = 1.0 - qab * x / qap
    if abs(d) < _BETACF_FPMIN:
        d = _BETACF_FPMIN
    d = 1.0 / d
    h = d
    for m in range(1, _BETACF_MAX_ITER + 1):
        m2 = 2 * m
        aa = m * (b - m) * x / ((qam + m2) * (a + m2))
        d = 1.0 + aa * d
        if abs(d) < _BETACF_FPMIN:
            d = _BETACF_FPMIN
        c = 1.0 + aa / c
        if abs(c) < _BETACF_FPMIN:
            c = _BETACF_FPMIN
        d = 1.0 / d
        h *= d * c
        aa = -(a + m) * (qab + m) * x / ((a + m2) * (qap + m2))
        d = 1.0 + aa * d
        if abs(d) < _BETACF_FPMIN:
            d = _BETACF_FPMIN
        c = 1.0 + aa / c
        if abs(c) < _BETACF_FPMIN:
            c = _BETACF_FPMIN
        d = 1.0 / d
        delta = d * c
        h *= delta
        if abs(delta - 1.0) < _BETACF_EPS:
            break
    return h


def betainc_reg(a: float, b: float, x: float) -> float:
    """Regularized incomplete beta function I_x(a, b)."""
    if x <= 0.0:
        return 0.0
    if x >= 1.0:
        return 1.0
    ln_front = (
        math.lgamma(a + b)
        - math.lgamma(a)
        - math.lgamma(b)
        + a * math.log(x)
        + b * math.log1p(-x)
    )
    front = math.exp(ln_front)
    if x < (a + 1.0) / (a + b + 2.0):
        return front * _betacf(a, b, x) / a
    return 1.0 - front * _betacf(b, a, 1.0 - x) / b


def f_sf(f_stat: float, dfn: float, dfd: float) -> float:
    """Survival function (p-value) of the F(dfn, dfd) distribution."""
    if not np.isfinite(f_stat):
        return 0.0
    if f_stat <= 0.0:
        return 1.0
    x = dfd / (dfd + dfn * f_stat)
    return betainc_reg(dfd / 2.0, dfn / 2.0, x)


def t_sf(t_stat: float, df: float) -> float:
    """Two-sided not — one-sided survival function of Student-t."""
    if not np.isfinite(t_stat):
        return 0.0
    x = df / (df + t_stat * t_stat)
    p = 0.5 * betainc_reg(df / 2.0, 0.5, x)
    return p if t_stat >= 0 else 1.0 - p


# 97.5% one-sided Student-t critical values, df = 1..30 (then ~normal).
_T975 = [
    12.706, 4.303, 3.182, 2.776, 2.571, 2.447, 2.365, 2.306, 2.262, 2.228,
    2.201, 2.179, 2.160, 2.145, 2.131, 2.120, 2.110, 2.101, 2.093, 2.086,
    2.080, 2.074, 2.069, 2.064, 2.060, 2.056, 2.052, 2.048, 2.045, 2.042,
]


def t_critical_975(df: int) -> float:
    """t_{0.975, df} for the paper's 95% CI stopping rule."""
    if df < 1:
        return float("inf")
    if df <= 30:
        return _T975[df - 1]
    return 1.96


# ---------------------------------------------------------------------------
# Ordinary least squares (Table 3 of the paper)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class OLSResult:
    """Fit summary mirroring what the paper reports per model."""

    params: np.ndarray          # (p,) coefficients
    bse: np.ndarray             # (p,) standard errors
    tvalues: np.ndarray         # (p,) per-coefficient t statistics
    pvalues: np.ndarray         # (p,) per-coefficient two-sided p-values
    r_squared: float            # uncentered when no intercept (statsmodels convention)
    f_statistic: float          # overall regression F
    f_pvalue: float
    df_model: int
    df_resid: int
    resid: np.ndarray

    def predict(self, X: np.ndarray) -> np.ndarray:
        return np.asarray(X, dtype=np.float64) @ self.params


def ols(X: np.ndarray, y: np.ndarray, *, has_intercept: bool = False) -> OLSResult:
    """OLS with summary statistics.

    The paper's e_K / r_K models (Eqs. 6–7) have NO intercept, so by default
    R^2 is the uncentered version — identical to what statsmodels' OLS
    reports for a model without a constant column, which is what the paper
    used (statsmodels v0.14.2).
    """
    X = np.asarray(X, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64).reshape(-1)
    n, p = X.shape
    if n <= p:
        raise ValueError(f"need more observations ({n}) than regressors ({p})")

    params, _, rank, _ = np.linalg.lstsq(X, y, rcond=None)
    if rank < p:
        raise ValueError("design matrix is rank deficient")
    fitted = X @ params
    resid = y - fitted
    ssr = float(resid @ resid)

    if has_intercept:
        sst = float(np.sum((y - y.mean()) ** 2))
        df_model = p - 1
    else:
        sst = float(y @ y)
        df_model = p
    df_resid = n - p
    r2 = 1.0 - ssr / sst if sst > 0 else 0.0

    sigma2 = ssr / df_resid if df_resid > 0 else np.nan
    xtx_inv = np.linalg.inv(X.T @ X)
    bse = np.sqrt(np.maximum(np.diag(xtx_inv) * sigma2, 0.0))
    with np.errstate(divide="ignore", invalid="ignore"):
        tvals = np.where(bse > 0, params / bse, np.inf)
    pvals = np.array([2.0 * t_sf(abs(t), df_resid) for t in tvals])

    if r2 >= 1.0:
        f_stat = float("inf")
    else:
        f_stat = (r2 / df_model) / ((1.0 - r2) / df_resid)
    f_p = f_sf(f_stat, df_model, df_resid)

    return OLSResult(
        params=params, bse=bse, tvalues=tvals, pvalues=pvals,
        r_squared=r2, f_statistic=f_stat, f_pvalue=f_p,
        df_model=df_model, df_resid=df_resid, resid=resid,
    )


def bilinear_design(tau_in: np.ndarray, tau_out: np.ndarray) -> np.ndarray:
    """Design matrix [τin, τout, τin·τout] of the paper's Eqs. 6–7."""
    tau_in = np.asarray(tau_in, dtype=np.float64).reshape(-1)
    tau_out = np.asarray(tau_out, dtype=np.float64).reshape(-1)
    return np.stack([tau_in, tau_out, tau_in * tau_out], axis=1)


# ---------------------------------------------------------------------------
# Two-way ANOVA with interaction (Table 2 of the paper)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AnovaRow:
    source: str
    sum_sq: float
    df: int
    f_statistic: float
    p_value: float


@dataclasses.dataclass(frozen=True)
class AnovaResult:
    factor_a: AnovaRow
    factor_b: AnovaRow
    interaction: AnovaRow
    residual_sum_sq: float
    residual_df: int

    def rows(self) -> list[AnovaRow]:
        return [self.factor_a, self.factor_b, self.interaction]


def anova_two_way(
    a_levels: Sequence,
    b_levels: Sequence,
    y: Sequence[float],
    *,
    a_name: str = "Input Tokens",
    b_name: str = "Output Tokens",
) -> AnovaResult:
    """Two-way ANOVA with interaction, via sequential (Type-I) sums of
    squares computed by nested OLS projections.  Handles unbalanced cells,
    which the paper's randomized-trial campaign produces.
    """
    a = np.asarray(a_levels)
    b = np.asarray(b_levels)
    y = np.asarray(y, dtype=np.float64).reshape(-1)
    if not (len(a) == len(b) == len(y)):
        raise ValueError("a_levels, b_levels and y must be the same length")
    n = len(y)

    ua, ia = np.unique(a, return_inverse=True)
    ub, ib = np.unique(b, return_inverse=True)
    na, nb = len(ua), len(ub)
    if na < 2 or nb < 2:
        raise ValueError("each factor needs at least 2 levels")

    def dummies(idx: np.ndarray, k: int) -> np.ndarray:
        # treatment coding, drop first level
        d = np.zeros((n, k - 1))
        for j in range(1, k):
            d[idx == j, j - 1] = 1.0
        return d

    one = np.ones((n, 1))
    da = dummies(ia, na)
    db = dummies(ib, nb)
    # interaction dummies
    dab = np.einsum("ni,nj->nij", da, db).reshape(n, -1)

    def rss(X: np.ndarray) -> tuple[float, int]:
        beta, _, rank, _ = np.linalg.lstsq(X, y, rcond=None)
        r = y - X @ beta
        return float(r @ r), int(rank)

    rss0, rk0 = rss(one)
    rss_a, rk_a = rss(np.hstack([one, da]))
    rss_ab, rk_ab = rss(np.hstack([one, da, db]))
    rss_full, rk_full = rss(np.hstack([one, da, db, dab]))

    ss_a, df_a = rss0 - rss_a, rk_a - rk0
    ss_b, df_b = rss_a - rss_ab, rk_ab - rk_a
    ss_i, df_i = rss_ab - rss_full, rk_full - rk_ab
    df_resid = n - rk_full
    if df_resid <= 0:
        raise ValueError("no residual degrees of freedom — need replicates")
    ms_e = rss_full / df_resid

    def row(name: str, ss: float, df: int) -> AnovaRow:
        f = (ss / df) / ms_e if df > 0 and ms_e > 0 else float("nan")
        p = f_sf(f, df, df_resid) if df > 0 else float("nan")
        return AnovaRow(source=name, sum_sq=ss, df=df, f_statistic=f, p_value=p)

    return AnovaResult(
        factor_a=row(a_name, ss_a, df_a),
        factor_b=row(b_name, ss_b, df_b),
        interaction=row("Interaction", ss_i, df_i),
        residual_sum_sq=rss_full,
        residual_df=df_resid,
    )


# ---------------------------------------------------------------------------
# Confidence-interval stopping rule (paper §5.1.3)
# ---------------------------------------------------------------------------


def ci_halfwidth_95(samples: Sequence[float]) -> float:
    """Half-width of the 95% CI of the mean of `samples`."""
    x = np.asarray(samples, dtype=np.float64)
    n = len(x)
    if n < 2:
        return float("inf")
    s = x.std(ddof=1)
    return t_critical_975(n - 1) * s / math.sqrt(n)


def ci_halfwidth_95_batch(samples: np.ndarray) -> np.ndarray:
    """Row-wise `ci_halfwidth_95` over a (conditions, trials) matrix —
    the vectorized form the batched characterization campaign uses to
    check the §5.1.3 stopping rule for a whole grid per call."""
    x = np.asarray(samples, dtype=np.float64)
    if x.ndim != 2:
        raise ValueError(f"need a (conditions, trials) matrix, got {x.shape}")
    n = x.shape[1]
    if n < 2:
        return np.full(x.shape[0], np.inf)
    s = x.std(axis=1, ddof=1)
    return t_critical_975(n - 1) * s / math.sqrt(n)


def should_stop_trials_batch(
    runtimes: np.ndarray, *, tolerance_s: float = 0.5, max_trials: int = 25
) -> np.ndarray:
    """Vectorized §5.1.3 stopping rule over a (conditions, trials) matrix
    (every row has the same trial count, as in round-based batched
    campaigns).  Returns a boolean mask of conditions that may stop."""
    x = np.asarray(runtimes, dtype=np.float64)
    if x.shape[1] >= max_trials:
        return np.ones(x.shape[0], dtype=bool)
    return ci_halfwidth_95_batch(x) <= tolerance_s


def should_stop_trials(
    runtimes: Sequence[float], *, tolerance_s: float = 0.5, max_trials: int = 25
) -> bool:
    """Paper §5.1.3: stop when the runtime CI half-width is within 0.5 s at
    95% confidence, or when 25 trials have been run."""
    if len(runtimes) >= max_trials:
        return True
    return ci_halfwidth_95(runtimes) <= tolerance_s
