"""Port copy of `repro.cluster.predictors`, numpy only, with its imports renamed;
tests/test_torch_cluster*.py hold it to the reference.

Non-oracle τout prediction for online routing.

The paper's scheduler assumes τout is known when a query is routed — an
offline-oracle assumption it flags itself, citing Zheng et al. (response-
length perception) for online estimation.  This module supplies the
online counterpart: per-model *empirical quantile* predictors fit over a
sliding window of observed completions, so a router's information model
can be downgraded from "knows every output length" to "has seen recent
traffic", and the two gaps that were previously conflated become
separately measurable in benchmarks/fig4_online_gap.py:

    information gap  = predictor router − oracle-τout router   (same
                       commitment rule, degraded τout knowledge)
    commitment gap   = oracle-τout router − offline oracle     (full
                       knowledge, online one-shot routing)

Causality: a completion is the only moment τout is revealed, so
observations enter through ``RoutingPolicy.observe_completion`` (wired by
the event loop), never from the trace.  Until a model has `min_obs`
completions the predictor falls back to the pooled cross-model window,
and before any completion at all to a fixed `prior` guess — it never
peeks at a pending request's true τout.

Quantile choice: the energy models are increasing in τout, so a median
(0.5) predictor under-provisions on the heavy Alpaca-like tail; the
default 0.7 hedges upward, the same skew Zheng et al. adopt for
scheduling (over- rather than under-predict lengths).
"""

from __future__ import annotations

from collections import deque

import numpy as np


class TauOutPredictor:
    """Per-model empirical τout quantiles over a sliding history window."""

    def __init__(self, *, quantile: float = 0.7, window: int = 256,
                 prior: float = 64.0, min_obs: int = 8):
        if not 0.0 < quantile < 1.0:
            raise ValueError(f"quantile must be in (0, 1), got {quantile}")
        if window < 1 or min_obs < 1:
            raise ValueError("window and min_obs must be >= 1")
        self.quantile = quantile
        self.window = window
        self.prior = float(prior)
        self.min_obs = min_obs
        self._per_model: dict[str, deque] = {}
        self._pooled: deque = deque(maxlen=window)
        self.n_observed = 0
        # predictions only change on completions, but are read O(k) times
        # per arrival — memoize per model key between observations
        self._cache: dict[str | None, float] = {}

    def observe(self, model: str, tau_out: int) -> None:
        """Fold one completed request's revealed output length."""
        dq = self._per_model.get(model)
        if dq is None:
            dq = self._per_model[model] = deque(maxlen=self.window)
        dq.append(int(tau_out))
        self._pooled.append(int(tau_out))
        self.n_observed += 1
        self._cache.clear()

    def predict(self, model: str | None = None) -> float:
        """τ̂out for a request about to be served by `model` (pooled
        estimate when model is None or its history is too thin)."""
        out = self._cache.get(model)
        if out is not None:
            return out
        dq = self._per_model.get(model) if model is not None else None
        if dq is not None and len(dq) >= self.min_obs:
            out = float(np.quantile(np.asarray(dq), self.quantile))
        elif len(self._pooled) >= self.min_obs:
            out = float(np.quantile(np.asarray(self._pooled), self.quantile))
        else:
            out = self.prior
        self._cache[model] = out
        return out

    def peek(self, model: str | None = None) -> float | None:
        """The memoized prediction for `model`, if one was computed since
        the last observation — O(1), no quantile work.  Telemetry uses
        this to report the error of predictions the router actually acted
        on without adding quantile computations to the completion path."""
        return self._cache.get(model)

    def reset(self) -> None:
        self._per_model.clear()
        self._pooled.clear()
        self._cache.clear()
        self.n_observed = 0
