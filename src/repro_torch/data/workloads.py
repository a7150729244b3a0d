"""Port copy of `repro.data.workloads`, numpy only, with its imports renamed;
tests/test_torch_serve.py holds it to the reference.

Workload generation.

The paper's case study uses 500 queries from the Alpaca dataset (52,002
instruction/GPT-4-answer pairs).  Alpaca is not shippable in this offline
container, so `alpaca_like_workload` draws (τin, τout) from log-normal
distributions fit to Alpaca's published token-length statistics
(instruction+input: median ≈ 21 tokens, long tail to ~500; output:
median ≈ 65, long tail to ~1000), truncated to the paper's measured range.

`token_batches` turns a workload into padded token/label arrays for the
training and serving paths (synthetic ids — the substrate is length-
driven, exactly like the paper's standardized prompts).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Sequence

import numpy as np

Query = tuple[int, int]


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    n_queries: int = 500
    in_log_mean: float = 3.4      # exp(3.4) ~ 30 tokens
    in_log_sigma: float = 0.9
    out_log_mean: float = 4.2     # exp(4.2) ~ 67 tokens
    out_log_sigma: float = 0.9
    min_tokens: int = 8
    max_in: int = 2048
    max_out: int = 4096
    seed: int = 0


def alpaca_like_workload(spec: WorkloadSpec = WorkloadSpec()) -> list[Query]:
    rng = np.random.default_rng(spec.seed)
    tin = np.exp(rng.normal(spec.in_log_mean, spec.in_log_sigma, spec.n_queries))
    tout = np.exp(rng.normal(spec.out_log_mean, spec.out_log_sigma, spec.n_queries))
    tin = np.clip(tin, spec.min_tokens, spec.max_in).astype(int)
    tout = np.clip(tout, spec.min_tokens, spec.max_out).astype(int)
    return [(int(a), int(b)) for a, b in zip(tin, tout)]


def arrival_times(
    n: int,
    rate_qps: float,
    *,
    pattern: str = "poisson",
    burstiness: float = 4.0,
    diurnal_amplitude: float = 0.8,
    diurnal_period_s: float = 600.0,
    onoff_on_s: float = 30.0,
    onoff_off_s: float = 120.0,
    seed: int = 0,
) -> np.ndarray:
    """Timestamps (seconds, ascending, starting near 0) for n requests.

    pattern="poisson"  — exponential interarrivals at rate_qps.
    pattern="bursty"   — Gamma interarrivals with squared CV = burstiness
                         (shape 1/burstiness), same mean rate; models the
                         clustered arrivals of real serving traffic.
    pattern="diurnal"  — nonhomogeneous Poisson via thinning with
                         rate(t) = rate_qps·(1 + A·sin(2πt/period)); the
                         mean rate over a full period is rate_qps.
    pattern="onoff"    — square-wave traffic: Poisson bursts during
                         onoff_on_s-second windows separated by
                         onoff_off_s seconds of silence (mean rate over a
                         full period is rate_qps).  The adversarial input
                         for node power-gating: long idle gaps that invite
                         gating, followed by fronts that force wakes.
    """
    if rate_qps <= 0:
        raise ValueError(f"rate_qps must be > 0, got {rate_qps}")
    rng = np.random.default_rng(seed)
    if pattern == "poisson":
        gaps = rng.exponential(1.0 / rate_qps, n)
        return np.cumsum(gaps)
    if pattern == "bursty":
        shape = 1.0 / burstiness
        gaps = rng.gamma(shape, burstiness / rate_qps, n)
        return np.cumsum(gaps)
    if pattern == "diurnal":
        a = min(max(diurnal_amplitude, 0.0), 1.0)
        peak = rate_qps * (1.0 + a)
        out = np.empty(n, dtype=np.float64)
        t, i = 0.0, 0
        while i < n:
            t += rng.exponential(1.0 / peak)
            lam = rate_qps * (1.0 + a * np.sin(2.0 * np.pi * t / diurnal_period_s))
            if rng.random() * peak < lam:
                out[i] = t
                i += 1
        return out
    if pattern == "onoff":
        on = float(onoff_on_s)
        off = float(onoff_off_s)
        if on <= 0 or off < 0:
            raise ValueError("need onoff_on_s > 0 and onoff_off_s >= 0")
        # draw a homogeneous Poisson stream in on-window time, then map
        # on-time to wall time by inserting the off windows
        lam = rate_qps * (on + off) / on
        tau = np.cumsum(rng.exponential(1.0 / lam, n))
        return tau + np.floor(tau / on) * off
    raise ValueError(f"unknown arrival pattern: {pattern!r}")


def fault_trace(
    n_nodes: int,
    horizon_s: float,
    *,
    mttf_s: float | None = None,
    mttr_s: float = 60.0,
    straggle_mttf_s: float | None = None,
    straggle_mttr_s: float = 30.0,
    slowdown_range: tuple[float, float] = (1.5, 3.0),
    seed: int = 0,
    domains: Sequence[Sequence[int]] | None = None,
) -> list[tuple[float, int, str, float]]:
    """Seeded fault-event stream for a fleet of `n_nodes` nodes: the
    failure-side counterpart of `arrival_times`.

    Two independent alternating-renewal processes, both with exponential
    holding times (the classic MTTF/MTTR availability model):

      * crash/recovery — up for Exp(mttf_s), down for Exp(mttr_s):
        emits ("crash", 1.0) then ("recover", 1.0) pairs;
      * straggle/normal — healthy for Exp(straggle_mttf_s), degraded for
        Exp(straggle_mttr_s) at a slowdown factor drawn uniformly from
        `slowdown_range`: emits ("slow", σ) then ("normal", 1.0) pairs.

    `domains` switches crash/recovery to *correlated* mode: it must be a
    partition of range(n_nodes) (each index in exactly one group); each
    group runs ONE crash/recover renewal whose events are emitted
    simultaneously for every member — the blast-radius model for racks
    and PDU legs.  Straggling stays per-node (a slow NIC is not a rack
    event).  `domains=None` and the one-node-per-domain partition
    [(0,), (1,), ...] draw the identical RNG stream and return the
    identical event list — independent faults are the degenerate
    topology, pinned in tests.

    Passing None for a process's MTTF disables it.  Events are returned
    as (time_s, node_index, kind, value) tuples sorted by time (ties
    break by node index then emission order), truncated to `horizon_s`.
    The same seed always replays the identical stream — fault traces are
    first-class replayable inputs, like arrival traces.
    """
    if n_nodes <= 0:
        raise ValueError(f"n_nodes must be >= 1, got {n_nodes}")
    if horizon_s <= 0:
        raise ValueError(f"horizon_s must be > 0, got {horizon_s}")
    if mttf_s is not None and (mttf_s <= 0 or mttr_s <= 0):
        raise ValueError("mttf_s and mttr_s must be > 0")
    if straggle_mttf_s is not None and (straggle_mttf_s <= 0
                                        or straggle_mttr_s <= 0):
        raise ValueError("straggle_mttf_s and straggle_mttr_s must be > 0")
    lo, hi = slowdown_range
    if not (1.0 <= lo <= hi):
        raise ValueError("slowdown_range must satisfy 1 <= lo <= hi")
    if domains is None:
        groups: list[tuple[int, ...]] = [(i,) for i in range(n_nodes)]
    else:
        groups = [tuple(g) for g in domains]
        flat = [n for g in groups for n in g]
        if sorted(flat) != list(range(n_nodes)):
            raise ValueError(
                "domains must partition range(n_nodes): every node index "
                "in exactly one domain")
    rng = np.random.default_rng(seed)
    events: list[tuple[float, int, str, float]] = []

    def alternating(members: tuple[int, ...], up_s: float, down_s: float,
                    down_kind: str, up_kind: str, draw_value) -> None:
        t = float(rng.exponential(up_s))
        while t < horizon_s:
            value = draw_value()
            for node in members:
                events.append((t, node, down_kind, value))
            t += float(rng.exponential(down_s))
            if t >= horizon_s:
                break
            for node in members:
                events.append((t, node, up_kind, 1.0))
            t += float(rng.exponential(up_s))

    for members in groups:
        if mttf_s is not None:
            alternating(members, mttf_s, mttr_s, "crash", "recover",
                        lambda: 1.0)
        if straggle_mttf_s is not None:
            for node in members:
                alternating((node,), straggle_mttf_s, straggle_mttr_s,
                            "slow", "normal",
                            lambda: float(rng.uniform(lo, hi)))
    events.sort(key=lambda ev: (ev[0], ev[1]))
    return events


def session_workload(
    n_sessions: int,
    *,
    turns: int = 4,
    think_s: float = 20.0,
    rate_qps: float = 0.2,
    pattern: str = "poisson",
    spec: WorkloadSpec = WorkloadSpec(),
    seed: int = 0,
    **arrival_kw,
) -> list[tuple[float, Query, tuple[int, int, int]]]:
    """Seeded multi-turn conversational sessions: the prefix-sharing
    counterpart of `timestamped_workload` (and the third replayable
    input class after arrival and fault traces).

    Each of the `n_sessions` sessions opens at a time drawn from the
    usual arrival processes (`pattern` + `rate_qps` over session starts,
    so sessions compose with Poisson/bursty/diurnal/onoff shaping) and
    runs `turns` turns.  Turn 0 is an ordinary Alpaca-like query.  Every
    later turn re-submits the full previous context — prompt plus the
    model's answer — as a *shared prefix* and appends a fresh
    Alpaca-like user input:

        τin(k) = prefix(k) + fresh(k),
        prefix(k) = min(τin(k−1) + τout(k−1), max_in − fresh(k)),

    (the min truncates histories that outgrow the model's `max_in`
    context window — the truncated tail is still reported as shared so
    prefix < τin always holds and a KV prefix cache can price the hit).
    Think-time gaps between a session's turns are Exp(`think_s`).

    Returns time-sorted (arrival_s, (τin, τout), (session_id, turn,
    prefix_tokens)) triples; ties break by (session, turn).  The same
    seed always replays the identical stream — session traces are
    first-class replayable inputs, like arrival and fault traces.
    """
    if n_sessions <= 0:
        raise ValueError(f"n_sessions must be >= 1, got {n_sessions}")
    if turns < 1:
        raise ValueError(f"turns must be >= 1, got {turns}")
    if think_s <= 0:
        raise ValueError(f"think_s must be > 0, got {think_s}")
    starts = arrival_times(n_sessions, rate_qps, pattern=pattern,
                           seed=seed + 1, **arrival_kw)
    rng = np.random.default_rng(seed)
    items: list[tuple[float, Query, tuple[int, int, int]]] = []
    for sid in range(n_sessions):
        fresh = np.exp(rng.normal(spec.in_log_mean, spec.in_log_sigma, turns))
        fresh = np.clip(fresh, spec.min_tokens, spec.max_in).astype(int)
        touts = np.exp(rng.normal(spec.out_log_mean, spec.out_log_sigma,
                                  turns))
        touts = np.clip(touts, spec.min_tokens, spec.max_out).astype(int)
        gaps = rng.exponential(think_s, turns)   # gaps[0] unused: fixed draw
        t = float(starts[sid])
        prefix = 0
        for k in range(turns):
            if k > 0:
                t += float(gaps[k])
                prefix = min(prefix, spec.max_in - int(fresh[k]))
                prefix = max(prefix, 0)
            tau_in = prefix + int(fresh[k])
            tau_out = int(touts[k])
            items.append((t, (tau_in, tau_out), (sid, k, prefix)))
            prefix = tau_in + tau_out
    items.sort(key=lambda it: (it[0], it[2][0], it[2][1]))
    return items


def timestamped_workload(
    spec: WorkloadSpec = WorkloadSpec(),
    *,
    rate_qps: float = 1.0,
    pattern: str = "poisson",
    seed: int | None = None,
    **arrival_kw,
) -> list[tuple[float, Query]]:
    """Alpaca-like queries with streaming arrival timestamps:
    [(arrival_s, (τin, τout)), ...] sorted by time — the online-serving
    counterpart of `alpaca_like_workload` (consumed by repro.cluster)."""
    seed = spec.seed if seed is None else seed
    queries = alpaca_like_workload(dataclasses.replace(spec, seed=seed))
    times = arrival_times(len(queries), rate_qps, pattern=pattern,
                          seed=seed + 1, **arrival_kw)
    return [(float(t), q) for t, q in zip(times, queries)]


def grid_workload(lo: int = 8, hi: int = 2048) -> list[Query]:
    """Power-of-two grid, the paper's §6.1 ANOVA campaign."""
    levels = []
    v = lo
    while v <= hi:
        levels.append(v)
        v *= 2
    return [(a, b) for a in levels for b in levels]


def token_batches(
    queries: Sequence[Query],
    batch_size: int,
    vocab_size: int,
    *,
    pad_to: int | None = None,
    seed: int = 0,
) -> Iterator[dict]:
    """Yield padded batches {"tokens": [B, S], "lengths": [B], "tau_out": [B]}.

    Token ids are synthetic (uniform); lengths drive cost, as in the paper's
    standardized prompts.  S = pad_to or the max τin in the batch, rounded
    up to a multiple of 8.
    """
    rng = np.random.default_rng(seed)
    for i in range(0, len(queries), batch_size):
        chunk = queries[i : i + batch_size]
        if len(chunk) < batch_size:  # repeat-pad the final partial batch
            chunk = list(chunk) + [chunk[-1]] * (batch_size - len(chunk))
        lens = np.array([q[0] for q in chunk], dtype=np.int32)
        touts = np.array([q[1] for q in chunk], dtype=np.int32)
        S = int(pad_to or max(8, int(np.ceil(lens.max() / 8)) * 8))
        toks = rng.integers(1, vocab_size, size=(batch_size, S), dtype=np.int64)
        mask = np.arange(S)[None, :] < lens[:, None]
        toks = np.where(mask, toks, 0)
        yield {
            "tokens": toks.astype(np.int32),
            "lengths": lens,
            "tau_out": touts,
        }


def lm_train_batches(
    n_steps: int, batch_size: int, seq_len: int, vocab_size: int, *,
    seed: int = 0, kind: str = "markov", noise: float = 0.15
) -> Iterator[dict]:
    """Synthetic LM training batches with next-token labels.

    kind="markov": a noisy deterministic chain (next = 3*cur+7 mod V with
    prob 1-noise, else uniform) — learnable structure, so training loss
    visibly falls below ln(V).  kind="uniform": i.i.d. tokens (loss floor
    is exactly ln(V); useful for cost benchmarking only)."""
    rng = np.random.default_rng(seed)
    for _ in range(n_steps):
        if kind == "uniform":
            toks = rng.integers(1, vocab_size,
                                size=(batch_size, seq_len + 1), dtype=np.int64)
        else:
            toks = np.empty((batch_size, seq_len + 1), np.int64)
            toks[:, 0] = rng.integers(1, vocab_size, batch_size)
            for t in range(seq_len):
                nxt = (3 * toks[:, t] + 7) % vocab_size
                flip = rng.random(batch_size) < noise
                nxt[flip] = rng.integers(1, vocab_size, int(flip.sum()))
                toks[:, t + 1] = nxt
        yield {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
        }
