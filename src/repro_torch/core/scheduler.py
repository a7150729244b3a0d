"""Port copy of `repro.core.scheduler`, numpy only, with its imports renamed;
tests/test_torch_serve.py holds it to the reference.

Offline energy-optimal workload scheduling (paper §4, §6.3).

The paper encodes Eq. 2 as an ILP in PuLP.  The evaluated problem has a
transportation structure (each query assigned to exactly one model; per-model
share constraints), for which exact combinatorial algorithms exist:

  * ``schedule()`` — per-query argmin over the cost matrix.  This is the
    exact optimum of Eq. 2 subject only to coverage/disjointness (Eqs. 4–5);
    the strict-share constraint (Eq. 3: every model gets >0 queries) is
    repaired with minimum-regret swaps, which preserves optimality among
    feasible solutions when m >> K (argument: the repair chooses the global
    minimum extra cost over all ways to give a starved model one query).

  * ``schedule_capacitated()`` — γ-constrained variant (the paper's data
    center partition γ_K).  Two exact solvers:

      - method="chains" (default): successive shortest reassignment chains
        on the K-bin aggregated residual graph.  Start from the
        unconstrained argmin; while some model is over its cap, move one
        query along the cheapest surplus→deficit chain (arc (u,v) costs
        the minimum regret C[i,v] − C[i,u] over queries i currently on u,
        maintained in per-arc heaps; Floyd–Warshall over the K ≪ m bins
        finds the chain).  This is the successive-shortest-path min-cost
        flow algorithm run on the contracted network, so it terminates at
        an exact optimum — in O(surplus · (K³ + K log m)) instead of the
        per-query Dijkstra augmentations of the full flow network.

      - method="flow": the original ``_MinCostFlow`` (successive shortest
        augmenting paths with Johnson potentials on the full m-node
        network), kept as the reference oracle the fast path is asserted
        against.

    ``capacitated_optimality_certificate`` checks any assignment for
    residual negative cycles/chains — an O(Km + K³) exact LP-optimality
    certificate used by the perf suite at sizes where the oracle is too
    slow to run.

    ``schedule_capacitated(..., warm_start=prior_assignee)`` repairs an
    existing assignment instead of solving from scratch:
    negative-cycle/negative-chain canceling on the same K-bin residual
    graph (``_repair_assignment``), terminating exactly when the
    optimality certificate holds.  With a near-optimal prior (the previous
    ζ of a sweep, or a workload that changed by a few queries) the repair
    does O(delta) chain moves instead of O(m) — the substrate of
    ``repro.core.sweep``'s incremental re-planner.

Baselines from the paper's Figure 3: single-model, round-robin, random.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Sequence

import numpy as np

from repro_torch.core.energy_model import (
    LLMProfile,
    NormalizedCosts,
    Query,
    normalized_costs,
    objective_matrix,
)


@dataclasses.dataclass(frozen=True)
class Assignment:
    """A disjoint partition of the workload Q into {Q_K} (Eqs. 4–5)."""

    model_names: tuple[str, ...]
    assignee: np.ndarray        # (m,) int — model index per query
    objective: float            # Eq. 2 value
    total_energy_j: float
    total_runtime_s: float
    total_accuracy: float       # Σ a_K(q) over assignment (paper's accuracy metric)
    mean_accuracy_ak: float     # workload-weighted mean A_K (plotted in Fig. 3c)

    def counts(self) -> np.ndarray:
        return np.bincount(self.assignee, minlength=len(self.model_names))


def _evaluate(
    costs: NormalizedCosts, assignee: np.ndarray, zeta: float,
    *, C: np.ndarray | None = None,
) -> Assignment:
    """Score an assignment.  Callers that already hold the ζ objective
    matrix pass it via `C` to avoid recomputing it (once per ζ in
    `zeta_sweep`)."""
    if C is None:
        C = objective_matrix(costs, zeta)
    m = len(assignee)
    rows = np.arange(m)
    obj = C[rows, assignee].sum()
    tin = np.array([q[0] for q in costs.queries], dtype=np.float64)
    tout = np.array([q[1] for q in costs.queries], dtype=np.float64)
    tok = tin + tout
    a_k_per_query = costs.accuracy[rows, assignee] / np.maximum(tok, 1.0)
    return Assignment(
        model_names=costs.model_names,
        assignee=assignee.copy(),
        objective=float(obj),
        total_energy_j=float(costs.energy[rows, assignee].sum()),
        total_runtime_s=float(costs.runtime[rows, assignee].sum()),
        total_accuracy=float(costs.accuracy[rows, assignee].sum()),
        mean_accuracy_ak=float(a_k_per_query.mean()),
    )


# ---------------------------------------------------------------------------
# Exact unconstrained (coverage-only) scheduler
# ---------------------------------------------------------------------------


def schedule(
    profiles: Sequence[LLMProfile],
    queries: Sequence[Query],
    zeta: float,
    *,
    enforce_nonempty: bool = True,
    costs: NormalizedCosts | None = None,
) -> Assignment:
    """Optimal partition for Eq. 2 (argmin per query + Eq. 3 repair)."""
    if costs is None:
        costs = normalized_costs(profiles, queries)
    C = objective_matrix(costs, zeta)
    m, k = C.shape
    assignee = C.argmin(axis=1)

    if enforce_nonempty and m >= k:
        counts = np.bincount(assignee, minlength=k)
        starved = np.nonzero(counts == 0)[0]
        if len(starved):
            # exact joint repair: assign one query to each starved model,
            # donors keep >= 1 — a small min-cost flow over the regrets
            # (greedy per-starved-model repair is not optimal when several
            # models are starved at once)
            n_s = len(starved)
            mcf = _MinCostFlow(1 + n_s + m + k + 1)
            src = 0
            snk = 1 + n_s + m + k
            base = C[np.arange(m), assignee]
            shift = float(np.max(C)) + 1.0  # make arc costs non-negative
            for si, s in enumerate(starved):
                mcf.add_edge(src, 1 + si, 1, 0.0)
                for i in range(m):
                    regret = float(C[i, s] - base[i])
                    mcf.add_edge(1 + si, 1 + n_s + i, 1, regret + shift)
            for i in range(m):
                mcf.add_edge(1 + n_s + i, 1 + n_s + m + int(assignee[i]), 1, 0.0)
            for j in range(k):
                cap = max(0, int(counts[j]) - 1)
                mcf.add_edge(1 + n_s + m + j, snk, cap, 0.0)
            flow, _ = mcf.min_cost_flow(src, snk, n_s)
            if flow == n_s:
                for si, s in enumerate(starved):
                    for e in mcf.graph[1 + si]:
                        v, cap, _, _ = e
                        if 1 + n_s <= v < 1 + n_s + m and cap == 0:
                            assignee[v - 1 - n_s] = s
                            break
    return _evaluate(costs, assignee, zeta, C=C)


def schedule_with_liveness(
    profiles: Sequence[LLMProfile],
    queries: Sequence[Query],
    zeta: float,
    live: np.ndarray,
    *,
    costs: NormalizedCosts | None = None,
) -> Assignment:
    """Failure-aware Eq. 2 optimum: per-query argmin restricted to *live*
    model columns.

    `live` is an (m, k) matrix: either a boolean mask — live[i, j] ==
    False means model j cannot serve query i on the realized fault trace
    (every hosting node permanently down from the query's arrival; see
    ``FaultTrace.down_forever_from``) — or integer *capacity counts*
    (surviving replicas, or surviving fault domains under correlated
    failures: the domain-masked form), where a column is masked exactly
    when its count is 0.  The unconstrained Eq. 2 separates per query,
    so masking columns keeps the solve an exact argmin — this is the
    offline bound replayed against the *same* fault trace the online
    policies faced, so the offline→online gap stays a true bound under
    failures.  A query with no live column falls back to the full row
    (the online fleet would abandon it; pricing it at its best model
    keeps the bound conservative)."""
    if costs is None:
        costs = normalized_costs(profiles, queries)
    C = objective_matrix(costs, zeta)
    if live.shape != C.shape:
        raise ValueError(f"live mask shape {live.shape} != {C.shape}")
    if live.dtype != np.bool_:
        if not np.issubdtype(live.dtype, np.integer):
            raise ValueError(
                f"live must be boolean or integer counts, got {live.dtype}")
        if (live < 0).any():
            raise ValueError("live counts must be >= 0")
        live = live > 0
    masked = np.where(live, C, np.inf)
    dead_rows = ~live.any(axis=1)
    if dead_rows.any():
        masked[dead_rows] = C[dead_rows]
    assignee = masked.argmin(axis=1)
    return _evaluate(costs, assignee, zeta, C=C)


def cached_costs(
    profiles: Sequence[LLMProfile],
    queries: Sequence[Query],
    cached: Sequence[int] | np.ndarray,
) -> NormalizedCosts:
    """Cost matrices conditioned on a realized KV prefix-cache hit
    sequence: query i's energy and runtime under every model are
    discounted by the profile-predicted cost of a prefill-only pass over
    its `cached[i]` warm tokens — the same prefix-difference contract the
    node charges (prefill(τin) − prefill(cached)), expressed through the
    fitted profiles so the offline replay prices cached prefills the way
    the online fleet did.  cached[i] == 0 leaves row i exactly unchanged;
    discounts never drive a cost below zero.  Accuracy is untouched (the
    cache changes where tokens come from, not what the model answers),
    and ê is re-normalized over the discounted matrix."""
    cached = np.asarray(cached, dtype=np.int64)
    if cached.shape != (len(queries),):
        raise ValueError(
            f"cached must have one entry per query: shape {cached.shape} "
            f"for {len(queries)} queries")
    if (cached < 0).any():
        raise ValueError("cached token counts must be >= 0")
    tin = np.array([q[0] for q in queries], dtype=np.int64)
    if (cached >= tin).any():
        raise ValueError("cached token counts must be < tau_in (a suffix "
                         "always remains to prefill)")
    base = normalized_costs(profiles, queries)
    if not cached.any():
        return base
    warm = cached > 0
    tin_c = cached.astype(np.float64)
    tout_c = np.zeros_like(tin_c)
    e_disc = np.stack([p.energy(tin_c, tout_c) for p in profiles], axis=1)
    r_disc = np.stack([p.runtime(tin_c, tout_c) for p in profiles], axis=1)
    e_disc[~warm] = 0.0
    r_disc[~warm] = 0.0
    energy = np.maximum(base.energy - e_disc, 0.0)
    runtime = np.maximum(base.runtime - r_disc, 0.0)
    e_max = float(energy.max())
    a_max = float(base.accuracy.max())
    return NormalizedCosts(
        model_names=base.model_names,
        queries=base.queries,
        energy=energy,
        runtime=runtime,
        accuracy=base.accuracy,
        energy_hat=energy / e_max if e_max > 0 else energy,
        accuracy_hat=(base.accuracy / a_max if a_max > 0
                      else base.accuracy),
    )


def schedule_with_cache(
    profiles: Sequence[LLMProfile],
    queries: Sequence[Query],
    zeta: float,
    cached: Sequence[int] | np.ndarray,
    *,
    costs: NormalizedCosts | None = None,
) -> Assignment:
    """Cache-aware Eq. 2 optimum: per-query argmin over the cost columns
    conditioned on the realized hit sequence (`cached_costs`).  The
    oracle bound stays valid because the *online* assignment is scored
    under the same discounted matrix (policies.objective_of_assignment
    with cached=): the row-wise argmin is ≤ any realized column choice
    by construction, whatever node the session-affinity router picked."""
    if costs is None:
        costs = cached_costs(profiles, queries, cached)
    C = objective_matrix(costs, zeta)
    assignee = C.argmin(axis=1)
    return _evaluate(costs, assignee, zeta, C=C)


# ---------------------------------------------------------------------------
# Capacity-constrained (γ partition) scheduler
# ---------------------------------------------------------------------------


def _capacities_from_gamma(gamma: Sequence[float], m: int) -> np.ndarray:
    g = np.asarray(gamma, dtype=np.float64)
    if abs(g.sum() - 1.0) > 1e-6:
        raise ValueError(f"gamma must sum to 1, got {g.sum()}")
    caps = np.floor(g * m).astype(int)
    # distribute the remainder to largest fractional parts
    rem = m - caps.sum()
    frac = g * m - np.floor(g * m)
    for j in np.argsort(-frac)[:rem]:
        caps[j] += 1
    return caps


class _MinCostFlow:
    """Successive shortest augmenting paths with Johnson potentials."""

    def __init__(self, n: int):
        self.n = n
        self.graph: list[list[list]] = [[] for _ in range(n)]  # [to, cap, cost, rev_idx]

    def add_edge(self, u: int, v: int, cap: int, cost: float) -> None:
        self.graph[u].append([v, cap, cost, len(self.graph[v])])
        self.graph[v].append([u, 0, -cost, len(self.graph[u]) - 1])

    def min_cost_flow(self, s: int, t: int, maxf: int) -> tuple[int, float]:
        n = self.n
        prevv = [0] * n
        preve = [0] * n
        INF = float("inf")
        flow, cost = 0, 0.0
        h = [0.0] * n  # potentials (all edge costs are >= 0 after row shift)
        while flow < maxf:
            dist = [INF] * n
            dist[s] = 0.0
            pq = [(0.0, s)]
            while pq:
                d, u = heapq.heappop(pq)
                if d > dist[u] + 1e-12:
                    continue
                for ei, e in enumerate(self.graph[u]):
                    v, cap, c, _ = e
                    if cap <= 0:
                        continue
                    nd = d + c + h[u] - h[v]
                    if nd < dist[v] - 1e-12:
                        dist[v] = nd
                        prevv[v] = u
                        preve[v] = ei
                        heapq.heappush(pq, (nd, v))
            if dist[t] == INF:
                break
            for i in range(n):
                if dist[i] < INF:
                    h[i] += dist[i]
            # bottleneck along path
            d = maxf - flow
            v = t
            while v != s:
                d = min(d, self.graph[prevv[v]][preve[v]][1])
                v = prevv[v]
            v = t
            while v != s:
                e = self.graph[prevv[v]][preve[v]]
                e[1] -= d
                self.graph[v][e[3]][1] += d
                cost += e[2] * d
                v = prevv[v]
            flow += d
        return flow, cost


def _solve_capacitated_flow(C: np.ndarray, caps: np.ndarray) -> np.ndarray:
    """Reference oracle: exact min-cost flow on the full m-node network."""
    m, k = C.shape
    # Row-shift so all arc costs are non-negative (doesn't change argmin
    # structure: every query is assigned exactly once).
    shift = C.min(axis=1, keepdims=True)
    Cs = C - shift

    # nodes: 0 = source, 1..m = queries, m+1..m+k = models, m+k+1 = sink
    mcf = _MinCostFlow(m + k + 2)
    src, snk = 0, m + k + 1
    for i in range(m):
        mcf.add_edge(src, 1 + i, 1, 0.0)
        for j in range(k):
            mcf.add_edge(1 + i, 1 + m + j, 1, float(Cs[i, j]))
    for j in range(k):
        mcf.add_edge(1 + m + j, snk, int(caps[j]), 0.0)

    flow, _ = mcf.min_cost_flow(src, snk, m)
    if flow < m:
        raise RuntimeError(f"infeasible: routed {flow}/{m} queries")

    assignee = np.full(m, -1, dtype=int)
    for i in range(m):
        for e in mcf.graph[1 + i]:
            v, cap, _, _ = e
            if m + 1 <= v <= m + k and cap == 0:  # saturated forward arc
                assignee[i] = v - m - 1
                break
    assert (assignee >= 0).all()
    return assignee


class _ArcHeaps:
    """Lazy per-arc regret heaps over an assignment (the chains solver's
    and the warm-start repair's shared bookkeeping).

    ``heaps[u][v]`` holds (C[i,v] − C[i,u], i) for queries i assigned to u
    at push time; entries go stale when i moves (or is retired to bin −1)
    and are skipped lazily against the live ``assignee`` array, which is
    shared by reference with the caller."""

    def __init__(self, C: np.ndarray, assignee: np.ndarray, k: int,
                 n_rows: int | None = None):
        """`n_rows` bounds the initial scan (rows beyond it are treated as
        unassigned — callers holding capacity-sized buffers pass the used
        height; later `push` calls may register any row of C)."""
        self.C = C
        self.assignee = assignee
        self.k = k
        self.heaps: list[list[list]] = [[[] for _ in range(k)]
                                        for _ in range(k)]
        scan = assignee if n_rows is None else assignee[:n_rows]
        for u in range(k):
            idx = np.nonzero(scan == u)[0]
            if not len(idx):
                continue
            base = C[idx, u]
            for v in range(k):
                if v == u:
                    continue
                h = list(zip((C[idx, v] - base).tolist(), idx.tolist()))
                heapq.heapify(h)
                self.heaps[u][v] = h

    def arc_min(self, u: int, v: int):
        """(cost, query) of the current cheapest u→v reassignment."""
        h = self.heaps[u][v]
        a = self.assignee
        while h and a[h[0][1]] != u:
            heapq.heappop(h)
        return h[0] if h else None

    def push(self, i: int, v: int) -> None:
        """Register query i as newly assigned to bin v."""
        ci = self.C[i]
        bv = ci[v]
        for w in range(self.k):
            if w != v:
                heapq.heappush(self.heaps[v][w], (float(ci[w] - bv), i))

    def residual(self, counts: np.ndarray) -> list[list[float]]:
        """Current cheapest-regret matrix R (inf where no query to move)."""
        k = self.k
        INF = float("inf")
        R = [[INF] * k for _ in range(k)]
        for u in range(k):
            if counts[u] == 0:
                continue
            for v in range(k):
                if v != u:
                    top = self.arc_min(u, v)
                    if top is not None:
                        R[u][v] = top[0]
        return R


def _cheapest_chain(R: list[list[float]], k: int,
                    sources, targets) -> tuple[float, list[int]] | None:
    """Cheapest residual chain from any source bin to any target bin.

    Edge-count-bounded Bellman–Ford DP (≤ k−1 arcs) with per-level parent
    pointers: unlike Floyd–Warshall next-hop reconstruction, it cannot
    loop when fp rounding of tied path sums creates ~1e-19-weight residual
    cycles (degenerate workloads with many duplicate queries do this).
    Any cycle a pathological instance still smuggles into the parent chain
    is spliced out — the removed cycle weight is fp noise by the no-
    negative-cycle invariant, so the cost is unchanged up to ulps."""
    INF = float("inf")
    src = set(int(s) for s in sources)
    tgt = [int(t) for t in targets]
    if not src or not tgt:
        return None
    prev = [0.0 if v in src else INF for v in range(k)]
    pars: list[list[int]] = []
    best: tuple[float, int, int] | None = None   # (cost, n_edges, dest)
    for _ in range(1, k):
        cur = [INF] * k
        par = [-1] * k
        for u in range(k):
            pu = prev[u]
            if pu == INF:
                continue
            Ru = R[u]
            for v in range(k):
                w = Ru[v]
                if w < INF and pu + w < cur[v]:
                    cur[v] = pu + w
                    par[v] = u
        pars.append(par)
        for d in tgt:
            if cur[d] < INF and (best is None or cur[d] < best[0]):
                best = (cur[d], len(pars), d)
        prev = cur
    if best is None:
        return None
    cost, e, v = best
    path = [v]
    for level in range(e - 1, -1, -1):
        v = pars[level][v]
        path.append(v)
    path.reverse()
    while len(set(path)) != len(path):   # splice out fp-tie cycles
        seen: dict[int, int] = {}
        for i, b in enumerate(path):
            if b in seen:
                path = path[:seen[b]] + path[i:]
                break
            seen[b] = i
    return cost, path


def _solve_capacitated_chains(C: np.ndarray, caps: np.ndarray) -> np.ndarray:
    """Exact fast path exploiting k ≪ m: successive shortest reassignment
    chains on the k-bin aggregated residual graph.

    Starts from the unconstrained argmin (an ε=0-optimal pseudoflow for the
    transportation LP) and, while any bin exceeds its cap, moves one query
    along the cheapest chain from a surplus bin to a deficit bin.  Each
    chain is a shortest path in the residual graph, so reduced-cost
    optimality is preserved at every step (the classical correctness
    argument for successive-shortest-path min-cost flow with excesses) and
    the terminal feasible assignment is an exact optimum.
    """
    m, k = C.shape
    if int(caps.sum()) < m:
        raise RuntimeError(f"infeasible: capacities {caps.tolist()} < {m} queries")
    assignee = C.argmin(axis=1).astype(np.int64)
    counts = np.bincount(assignee, minlength=k)
    surplus = counts - caps
    n_moves = int(surplus[surplus > 0].sum())
    if n_moves == 0:
        return assignee

    arcs = _ArcHeaps(C, assignee, k)
    for _ in range(n_moves):
        R = arcs.residual(counts)
        found = _cheapest_chain(
            R, k,
            sources=[s for s in range(k) if counts[s] > caps[s]],
            targets=[d for d in range(k) if counts[d] < caps[d]])
        if found is None:
            raise RuntimeError("no augmenting chain — infeasible capacities")
        _, path = found
        # gather the chain's moves from the pre-move state, then apply
        moves = []
        for u, v in zip(path, path[1:]):
            top = arcs.arc_min(u, v)
            assert top is not None, "arc vanished mid-chain"
            moves.append((u, v, top[1]))
        for u, v, i in moves:
            assignee[i] = v
            counts[u] -= 1
            counts[v] += 1
            arcs.push(i, v)
    return assignee


def capacitated_optimality_certificate(
    C: np.ndarray, assignee: np.ndarray, caps: np.ndarray, *,
    tol: float | None = None,
) -> bool:
    """Exact LP-optimality check for a capacitated assignment.

    A feasible assignment is optimal iff the k-bin residual graph (arc
    (u,v) = cheapest regret of moving one query from u to v) has no
    negative cycle and no negative chain into a bin with spare capacity.
    O(km + k³) — usable at sizes where re-solving with the flow oracle is
    intractable."""
    m, k = C.shape
    counts = np.bincount(assignee, minlength=k)
    if (counts > caps).any():
        return False
    if tol is None:
        tol = 1e-9 * max(1.0, float(np.abs(C).max()))
    base = C[np.arange(m), assignee]
    R = np.full((k, k), np.inf)
    for u in range(k):
        mask = assignee == u
        if mask.any():
            R[u] = (C[mask] - base[mask, None]).min(axis=0)
    np.fill_diagonal(R, np.inf)
    dist = R.copy()
    np.fill_diagonal(dist, 0.0)
    for w in range(k):
        dist = np.minimum(dist, dist[:, [w]] + dist[[w], :])
    if (np.diag(dist) < -tol).any():          # improving cycle
        return False
    slack = np.nonzero(counts < caps)[0]
    if len(slack) and (dist[:, slack] < -tol).any():   # improving chain
        return False
    return True


def _find_negative_cycle(R: list[list[float]], k: int,
                         tol: float) -> list[int] | None:
    """Bellman–Ford negative-cycle detection on the k-bin residual graph.
    Returns the cycle as a bin sequence [b0, ..., bl] whose arcs are the
    consecutive pairs plus the closing (bl, b0), or None."""
    INF = float("inf")
    dist = [0.0] * k          # virtual source at distance 0 to every bin
    pred = [-1] * k
    x = -1
    for _ in range(k):
        x = -1
        for u in range(k):
            du = dist[u]
            Ru = R[u]
            for v in range(k):
                w = Ru[v]
                if w < INF and du + w < dist[v] - tol:
                    dist[v] = du + w
                    pred[v] = u
                    x = v
        if x < 0:
            return None
    for _ in range(k):        # walk into the cycle x is reachable from
        x = pred[x]
    cyc = [x]
    v = pred[x]
    while v != x:
        cyc.append(v)
        v = pred[v]
    cyc.reverse()             # arcs: (cyc[i], cyc[i+1]) and (cyc[-1], cyc[0])
    return cyc


def _repair_assignment(C: np.ndarray, caps: np.ndarray, assignee: np.ndarray,
                       *, tol: float | None = None) -> np.ndarray:
    """Exact repair of an arbitrary warm-start assignment to the optimum of
    the capacitated transportation LP.

    Restores feasibility (cheapest surplus→deficit chains) and optimality
    (negative-cycle / negative-chain canceling, Klein's algorithm on the
    k-bin aggregated residual graph), terminating exactly when
    ``capacitated_optimality_certificate`` holds.  Arc minima come from
    the same lazy ``_ArcHeaps`` the cold chains solver uses — O(k log m)
    per move after an O(mk) build — so a near-optimal warm start costs
    O(delta) chain moves, and even a far-from-optimal one (e.g. the
    normalizers shifted under a workload edit, re-ranking whole duplicate
    groups) stays a constant factor of the cold solve.  Termination is
    guaranteed: every cancellation strictly decreases the objective by
    more than ``tol`` at fixed counts, and every feasibility move strictly
    decreases total surplus."""
    m, k = C.shape
    if int(caps.sum()) < m:
        raise RuntimeError(f"infeasible: capacities {caps.tolist()} < {m} queries")
    assignee = np.asarray(assignee, dtype=np.int64).copy()
    if assignee.shape != (m,) or ((assignee < 0) | (assignee >= k)).any():
        raise ValueError("warm_start must be an (m,) array of bin indices")
    if tol is None:
        tol = 1e-12 * max(1.0, float(np.abs(C).max()))
    arcs = _ArcHeaps(C, assignee, k)
    _repair_live(caps, assignee, arcs, tol=tol, n_rows=m)
    return assignee


def _repair_live(caps: np.ndarray, assignee: np.ndarray, arcs: _ArcHeaps,
                 *, tol: float, n_rows: int) -> None:
    """The repair inner loop, in place over row-aligned buffers.

    `assignee` may be taller than the live workload and may hold −1
    sentinels (retired rows — skipped by the lazy heaps and excluded from
    counts); only rows < `n_rows` are scanned.  `arcs` must index the same
    (C, assignee) pair — passing a prebuilt instance is what lets
    ``sweep.IncrementalScheduler`` reuse its heaps across same-ζ delta
    repairs instead of rebuilding them O(mk) per call.  Terminates exactly
    when the ``capacitated_optimality_certificate`` conditions hold on the
    live rows (same argument as ``_repair_assignment``)."""
    k = len(caps)
    live = assignee[:n_rows]
    counts = np.bincount(live[live >= 0], minlength=k).astype(np.int64)
    m_live = int(counts.sum())
    if int(caps.sum()) < m_live:
        raise RuntimeError(
            f"infeasible: capacities {caps.tolist()} < {m_live} queries")

    def apply_moves(path: list[int], cyclic: bool) -> None:
        pairs = list(zip(path, path[1:]))
        if cyclic:
            pairs.append((path[-1], path[0]))
        # gather every move from the pre-move state, then apply (a query
        # entering bin v mid-chain must not be re-moved by the (v, w) arc)
        moves = []
        for u, v in pairs:
            top = arcs.arc_min(u, v)
            assert top is not None, "stale residual arc"
            moves.append((u, v, top[1]))
        for u, v, i in moves:
            assert assignee[i] == u, "stale residual arc"
            assignee[i] = v
            counts[u] -= 1
            counts[v] += 1
            arcs.push(i, v)

    max_iter = 64 * (m_live + k * k) + 1024   # bug guard, not an algorithmic bound
    for _ in range(max_iter):
        R = arcs.residual(counts)
        cyc = _find_negative_cycle(R, k, tol)
        if cyc is not None:
            apply_moves(cyc, cyclic=True)
            continue
        surplus = np.nonzero(counts > caps)[0]
        deficit = [d for d in range(k) if counts[d] < caps[d]]
        if len(surplus):
            found = _cheapest_chain(R, k, sources=surplus, targets=deficit)
            if found is None:
                raise RuntimeError("no augmenting chain — infeasible capacities")
            apply_moves(found[1], cyclic=False)
            continue
        found = _cheapest_chain(R, k, sources=range(k), targets=deficit)
        if found is None or found[0] >= -tol:
            return               # certificate conditions hold — exact optimum
        apply_moves(found[1], cyclic=False)
    raise RuntimeError("warm-start repair did not converge (pathological C?)")


def schedule_capacitated(
    profiles: Sequence[LLMProfile],
    queries: Sequence[Query],
    zeta: float,
    gamma: Sequence[float] | None = None,
    *,
    costs: NormalizedCosts | None = None,
    method: str = "chains",
    caps: Sequence[int] | None = None,
    warm_start: np.ndarray | None = None,
) -> Assignment:
    """Exact optimum of Eq. 2 with |Q_K| ≤ γ_K·|Q| capacities.

    method="chains" (default) is the fast aggregated successive-shortest-
    path solver; method="flow" is the full min-cost-flow reference oracle.
    Both are exact — the perf suite and tests assert their objectives
    coincide.

    Capacities come from `gamma` (shares of m, the paper's γ_K) or an
    explicit integer `caps` vector — exactly one of the two.  With
    `warm_start=` (a prior (m,) assignee array, chains method only) the
    solution is repaired from the prior via `_repair_assignment` instead
    of re-solved; the result is still exact."""
    if costs is None:
        costs = normalized_costs(profiles, queries)
    C = objective_matrix(costs, zeta)
    m, k = C.shape
    if (gamma is None) == (caps is None):
        raise ValueError("pass exactly one of gamma= or caps=")
    if caps is None:
        caps_arr = _capacities_from_gamma(gamma, m)
    else:
        caps_arr = np.asarray(caps, dtype=np.int64)
        if caps_arr.shape != (k,) or (caps_arr < 0).any():
            raise ValueError(f"caps must be a non-negative ({k},) vector")
        if int(caps_arr.sum()) < m:
            raise ValueError(f"infeasible caps: sum {caps_arr.sum()} < {m}")
    if warm_start is not None:
        if method != "chains":
            raise ValueError("warm_start= requires method='chains'")
        assignee = _repair_assignment(C, caps_arr, warm_start)
    elif method == "chains":
        assignee = _solve_capacitated_chains(C, caps_arr)
    elif method == "flow":
        assignee = _solve_capacitated_flow(C, caps_arr)
    else:
        raise ValueError(f"unknown method {method!r}; use 'chains' or 'flow'")
    return _evaluate(costs, assignee, zeta, C=C)


# ---------------------------------------------------------------------------
# Replica-split capacities (multi-replica models over several nodes)
# ---------------------------------------------------------------------------


def replica_capacities(
    caps: Sequence[int], replica_counts: Sequence[int],
) -> tuple[np.ndarray, np.ndarray]:
    """Split per-model capacities into balanced per-replica capacities.

    Model K's bin (capacity caps[K]) is mapped onto its replica_counts[K]
    replicas: each gets ⌊caps[K]/R⌋ queries, the remainder going one each
    to the first replicas — totals are preserved exactly, so the
    replica-level transportation problem has the same model-level optimum
    as the unsplit one (replica columns are duplicates).  Returns
    (caps_rep (R_total,), model_of_replica (R_total,)) with replicas
    flattened model-major in registry order."""
    caps = np.asarray(caps, dtype=np.int64)
    rc = np.asarray(replica_counts, dtype=np.int64)
    if caps.shape != rc.shape:
        raise ValueError("caps and replica_counts must align per model")
    if (rc < 1).any():
        raise ValueError("every model needs at least one replica")
    if (caps < 0).any():
        raise ValueError("capacities must be non-negative")
    model_of = np.repeat(np.arange(len(caps)), rc)
    caps_rep = np.empty(int(rc.sum()), dtype=np.int64)
    pos = 0
    for c, r in zip(caps.tolist(), rc.tolist()):
        base, extra = divmod(c, r)
        caps_rep[pos:pos + r] = base
        caps_rep[pos:pos + extra] += 1
        pos += r
    return caps_rep, model_of


@dataclasses.dataclass(frozen=True)
class ReplicaAssignment:
    """A model-level Assignment plus the replica placement realizing it."""

    assignment: Assignment      # model-level view (objective, totals)
    replica_of: np.ndarray      # (m,) int — global replica index per query
    model_of_replica: np.ndarray  # (R,) int — model index of each replica
    replica_caps: np.ndarray    # (R,) int — per-replica capacity

    def replica_counts(self) -> np.ndarray:
        return np.bincount(self.replica_of,
                           minlength=len(self.model_of_replica))


def schedule_replicated(
    profiles: Sequence[LLMProfile],
    queries: Sequence[Query],
    zeta: float,
    replica_counts: Sequence[int],
    *,
    gamma: Sequence[float] | None = None,
    caps: Sequence[int] | None = None,
    costs: NormalizedCosts | None = None,
) -> ReplicaAssignment:
    """Replica-aware Eq. 2 optimum: each model's bin split over its
    replicas as balanced γ-shares, solved exactly on the expanded
    (duplicate-column) cost matrix with the chains solver.

    Capacity source, in precedence order: explicit integer `caps` per
    model; `gamma` shares of m (the paper's γ_K); or — the default — the
    realized counts of the *unconstrained* optimum (`schedule` with
    coverage/disjointness only), in which case the model-level objective
    is bit-identical to the unconstrained one (the argmin is feasible for
    its own counts) and only the placement across replicas is solved.
    That default is what keeps a replica-aware oracle a true lower bound
    on every online policy's objective.

    Exactness without an expanded solve: replicas of one model are
    duplicate columns of the cost matrix, so *any* caps-respecting
    placement of the model-level optimum is a replica-level optimum.  The
    model-level problem is solved once (schedule / schedule_capacitated —
    both exact), then each model's queries are dealt over its replicas
    round-robin in O(m); the resulting per-replica counts are the
    balanced split of the realized count, componentwise ≤ the balanced
    capacity split, so the caps always hold."""
    if costs is None:
        costs = normalized_costs(profiles, queries)
    m = len(costs.queries)
    k = len(costs.model_names)
    if len(replica_counts) != k:
        raise ValueError("replica_counts must have one entry per model")
    if gamma is not None and caps is not None:
        raise ValueError("pass at most one of gamma= or caps=")
    if caps is not None:
        caps_model = np.asarray(caps, dtype=np.int64)
        if caps_model.shape != (k,) or (caps_model < 0).any():
            raise ValueError(f"caps must be a non-negative ({k},) vector")
        if int(caps_model.sum()) < m:
            raise ValueError(f"infeasible caps: sum {caps_model.sum()} < {m}")
        base = schedule_capacitated(profiles, queries, zeta,
                                    caps=caps_model, costs=costs)
    elif gamma is not None:
        caps_model = _capacities_from_gamma(gamma, m)
        base = schedule_capacitated(profiles, queries, zeta, gamma,
                                    costs=costs)
    else:
        base = schedule(profiles, queries, zeta,
                        enforce_nonempty=False, costs=costs)
        caps_model = base.counts()
    caps_rep, model_of = replica_capacities(caps_model, replica_counts)
    rc = np.asarray(replica_counts, dtype=np.int64)
    rep_start = np.concatenate([[0], np.cumsum(rc)])
    rep_assignee = np.empty(m, dtype=np.int64)
    for j in range(k):
        idx = np.nonzero(base.assignee == j)[0]
        rep_assignee[idx] = rep_start[j] + np.arange(len(idx)) % rc[j]
    return ReplicaAssignment(
        assignment=base,
        replica_of=rep_assignee,
        model_of_replica=model_of,
        replica_caps=caps_rep,
    )


# ---------------------------------------------------------------------------
# Baselines (paper Fig. 3 constant lines)
# ---------------------------------------------------------------------------


def schedule_single_model(
    profiles: Sequence[LLMProfile],
    queries: Sequence[Query],
    model_index: int,
    *,
    zeta: float = 0.5,
    costs: NormalizedCosts | None = None,
) -> Assignment:
    if costs is None:
        costs = normalized_costs(profiles, queries)
    assignee = np.full(len(queries), model_index, dtype=int)
    return _evaluate(costs, assignee, zeta)


def schedule_round_robin(
    profiles: Sequence[LLMProfile],
    queries: Sequence[Query],
    *,
    zeta: float = 0.5,
    costs: NormalizedCosts | None = None,
) -> Assignment:
    if costs is None:
        costs = normalized_costs(profiles, queries)
    assignee = np.arange(len(queries)) % len(profiles)
    return _evaluate(costs, assignee, zeta)


def schedule_random(
    profiles: Sequence[LLMProfile],
    queries: Sequence[Query],
    *,
    zeta: float = 0.5,
    seed: int = 0,
    costs: NormalizedCosts | None = None,
) -> Assignment:
    if costs is None:
        costs = normalized_costs(profiles, queries)
    rng = np.random.default_rng(seed)
    assignee = rng.integers(0, len(profiles), size=len(queries))
    return _evaluate(costs, assignee, zeta)


def zeta_sweep(
    profiles: Sequence[LLMProfile],
    queries: Sequence[Query],
    zetas: Sequence[float],
    *,
    gamma: Sequence[float] | None = None,
) -> list[Assignment]:
    """The paper's Figure 3 sweep: one Assignment per ζ value.

    Cold solve per ζ (kept as the simple reference); the streaming engine
    with warm-start reuse across adjacent ζ and exact frontier breakpoints
    is ``repro.core.sweep.pareto_frontier``."""
    costs = normalized_costs(profiles, queries)
    out = []
    for z in zetas:
        if gamma is None:
            out.append(schedule(profiles, queries, z, costs=costs))
        else:
            out.append(schedule_capacitated(profiles, queries, z, gamma, costs=costs))
    return out
