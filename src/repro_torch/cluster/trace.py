"""Port copy of `repro.cluster.trace`, numpy only, with its imports renamed;
tests/test_torch_cluster*.py hold it to the reference.

Arrival traces: streaming request workloads for the cluster simulator.

A trace is an immutable, time-sorted sequence of TracedRequests.  Shapes
(τin, τout) come from the same Alpaca-like distribution the offline case
study uses (repro_torch.data.workloads); timestamps come from the arrival
processes in repro_torch.data.workloads.arrival_times (Poisson, bursty/Gamma,
diurnal thinning) or are replayed from an explicit (t, query) list.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

from repro_torch.data.workloads import (
    Query,
    WorkloadSpec,
    arrival_times,
    session_workload,
    timestamped_workload,
)


@dataclasses.dataclass(frozen=True)
class TracedRequest:
    """One streaming request: the offline Query plus an arrival time.

    Session requests (from `session_trace`) additionally carry the
    conversation metadata a KV prefix cache prices: `session_id` groups
    the turns of one conversation, `turn` orders them, and
    `prefix_tokens` counts how many of this turn's τin tokens re-submit
    the previous context (always < τin).  Plain requests keep the
    defaults (session_id = -1 ⇒ never cached)."""

    request_id: int
    arrival_s: float
    tau_in: int
    tau_out: int
    session_id: int = -1
    turn: int = 0
    prefix_tokens: int = 0

    @property
    def query(self) -> Query:
        return (self.tau_in, self.tau_out)


@dataclasses.dataclass(frozen=True)
class ArrivalTrace:
    name: str
    requests: tuple[TracedRequest, ...]

    def __len__(self) -> int:
        return len(self.requests)

    def __iter__(self):
        return iter(self.requests)

    def queries(self) -> list[Query]:
        """The offline view of the trace (feeds core.scheduler)."""
        return [r.query for r in self.requests]

    @property
    def duration_s(self) -> float:
        return self.requests[-1].arrival_s if self.requests else 0.0

    @property
    def mean_rate_qps(self) -> float:
        d = self.duration_s
        return len(self.requests) / d if d > 0 else float("inf")


def _build(name: str, times, queries: Sequence[Query]) -> ArrivalTrace:
    reqs = tuple(
        TracedRequest(i, float(t), int(q[0]), int(q[1]))
        for i, (t, q) in enumerate(sorted(zip(times, queries))))
    return ArrivalTrace(name=name, requests=reqs)


def _shaped_trace(name: str, pattern: str, n: int, rate_qps: float,
                  spec: WorkloadSpec | None, seed: int,
                  **arrival_kw) -> ArrivalTrace:
    """Delegates to data.workloads.timestamped_workload so the shape/arrival
    seed pairing lives in exactly one place.  A caller-supplied spec keeps
    its own seed; the `seed` argument applies only when no spec is given."""
    if spec is None:
        spec = WorkloadSpec(n_queries=n, seed=seed)
    else:
        spec = dataclasses.replace(spec, n_queries=n)
    items = timestamped_workload(spec, rate_qps=rate_qps, pattern=pattern,
                                 **arrival_kw)
    return timestamped_trace(items, name=name)


def poisson_trace(n: int, rate_qps: float, *,
                  spec: WorkloadSpec | None = None,
                  seed: int = 0) -> ArrivalTrace:
    """Memoryless arrivals at rate_qps over Alpaca-like shapes."""
    return _shaped_trace(f"poisson@{rate_qps:g}", "poisson", n, rate_qps,
                         spec, seed)


def bursty_trace(n: int, rate_qps: float, *, burstiness: float = 4.0,
                 spec: WorkloadSpec | None = None,
                 seed: int = 0) -> ArrivalTrace:
    """Gamma interarrivals with squared CV = burstiness (same mean rate)."""
    return _shaped_trace(f"bursty@{rate_qps:g}", "bursty", n, rate_qps,
                         spec, seed, burstiness=burstiness)


def diurnal_trace(n: int, rate_qps: float, *, amplitude: float = 0.8,
                  period_s: float = 600.0,
                  spec: WorkloadSpec | None = None,
                  seed: int = 0) -> ArrivalTrace:
    """Sinusoidally-modulated Poisson (thinning), mean rate = rate_qps."""
    return _shaped_trace(f"diurnal@{rate_qps:g}", "diurnal", n, rate_qps,
                         spec, seed, diurnal_amplitude=amplitude,
                         diurnal_period_s=period_s)


def onoff_trace(n: int, rate_qps: float, *, on_s: float = 30.0,
                off_s: float = 120.0, spec: WorkloadSpec | None = None,
                seed: int = 0) -> ArrivalTrace:
    """Square-wave traffic (Poisson bursts separated by silences, same
    mean rate) — the gate/wake-churn adversary for power management."""
    return _shaped_trace(f"onoff@{rate_qps:g}", "onoff", n, rate_qps,
                         spec, seed, onoff_on_s=on_s, onoff_off_s=off_s)


def replay_trace(queries: Sequence[Query], rate_qps: float, *,
                 pattern: str = "poisson", seed: int = 0,
                 name: str = "replay") -> ArrivalTrace:
    """Replay an explicit offline workload (e.g. the 500-query case study)
    under a synthetic arrival process — the offline→online bridge."""
    times = arrival_times(len(queries), rate_qps, pattern=pattern, seed=seed)
    return _build(name, times, queries)


def timestamped_trace(items: Sequence[tuple[float, Query]], *,
                      name: str = "timestamped") -> ArrivalTrace:
    """Wrap pre-timestamped (arrival_s, query) pairs (e.g. from
    repro_torch.data.workloads.timestamped_workload) into a trace."""
    times = [t for t, _ in items]
    queries = [q for _, q in items]
    return _build(name, times, queries)


def session_trace(n_sessions: int, *, turns: int = 4, think_s: float = 20.0,
                  rate_qps: float = 0.2, pattern: str = "poisson",
                  spec: WorkloadSpec | None = None, seed: int = 0,
                  name: str | None = None, **arrival_kw) -> ArrivalTrace:
    """Multi-turn conversational arrivals: `n_sessions` seeded sessions of
    `turns` turns each (shared-prefix growth, Exp(think_s) gaps between a
    session's turns) with session starts shaped by any arrival `pattern`.
    Each TracedRequest carries (session_id, turn, prefix_tokens) so nodes
    with a KV prefix cache can price the warm prefix.  Same seed ⇒ the
    identical stream — replayable like arrival and fault traces."""
    items = session_workload(n_sessions, turns=turns, think_s=think_s,
                             rate_qps=rate_qps, pattern=pattern,
                             spec=spec if spec is not None else WorkloadSpec(),
                             seed=seed, **arrival_kw)
    reqs = tuple(
        TracedRequest(i, float(t), int(q[0]), int(q[1]), session_id=int(sid),
                      turn=int(turn), prefix_tokens=int(prefix))
        for i, (t, q, (sid, turn, prefix)) in enumerate(items))
    return ArrivalTrace(name=name or f"sessions@{rate_qps:g}x{turns}",
                        requests=reqs)
