"""Port copy of `repro.core.sweep`, numpy only, with its imports renamed.

Parametric ζ-sweep engine: warm-start incremental scheduling and
streaming Pareto-frontier tracing (the paper's §6 energy–runtime trade-off
study, made cheap enough for periodic online re-planning).

Three cooperating layers:

  * ``IncrementalScheduler`` — holds one capacitated scheduling problem
    (profiles × workload × ζ × capacities) across edits.  The raw
    energy/runtime/accuracy matrices are built once per query and grown
    in-place; ``reschedule(added=, removed=, capacity_deltas=, zeta=)``
    re-normalizes, rebuilds the ζ objective with one saxpy, and repairs
    the previous assignment via ``scheduler._repair_assignment`` instead
    of re-solving — O(delta) chain moves for small edits, against O(m)
    for a cold solve.

  * ``pareto_frontier`` — the streaming ζ sweep.  Normalized cost
    matrices are computed once for the whole sweep; each capacitated ζ
    point warm-starts from its neighbour's assignment.  For the
    unconstrained (coverage-only) objective it can instead return the
    EXACT frontier breakpoints — see below — so the whole frontier is
    described by O(#breakpoints) assignments rather than a grid.

  * ``frontier_breakpoints`` — per query, the Eq. 2 objective of model v
    is the line f_v(ζ) = ζ·(ê_v + â_v) − â_v; the argmin over v follows
    the lower envelope of k lines, so the assignment changes only at
    envelope crossings.  The union of those crossings over the workload
    is the exact, finite set of ζ where the optimal unconstrained
    assignment changes.

Exactness contract
------------------
Everything this module returns is exact — never "approximately equal":

  * ``IncrementalScheduler.reschedule`` terminates only when the repaired
    assignment satisfies the residual-graph optimality conditions of
    ``scheduler.capacitated_optimality_certificate`` (pass ``check=True``
    to assert the certificate on every solve).  Its objective matches a
    cold ``schedule_capacitated`` solve on the identical workload within
    the same ≤1e-12-relative equivalence class the chains-vs-flow tests
    use (permuted exact optima over duplicate queries may differ in the
    last ulp of the pairwise sum; the assignments themselves are both
    LP-optimal).
  * ``frontier_breakpoints`` returns the exact crossing ζ values (joint
    minimality of the crossing lines is verified against the full
    envelope), not a grid refinement.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

import numpy as np

from repro_torch.core import scheduler
from repro_torch.core.energy_model import (
    LLMProfile,
    NormalizedCosts,
    Query,
    normalized_costs,
    objective_matrix,
)
from repro_torch.core.scheduler import Assignment


class IncrementalScheduler:
    """One capacitated Eq. 2 problem, solved warm across edits.

    Queries get stable integer ids in insertion order (``next_id`` before
    an add is the id of the first added query); ``removed=`` takes those
    ids.  Capacities come from ``gamma`` (re-materialized over the current
    workload size every solve, so shares track m) or a fixed integer
    ``caps`` vector; ``capacity_deltas`` accumulates signed per-model
    shifts on top of either."""

    def __init__(
        self,
        profiles: Sequence[LLMProfile],
        queries: Sequence[Query],
        zeta: float,
        gamma: Sequence[float] | None = None,
        *,
        caps: Sequence[int] | None = None,
        costs: NormalizedCosts | None = None,
        check: bool = False,
    ):
        self.profiles = list(profiles)
        self.model_names = tuple(p.name for p in self.profiles)
        self.k = len(self.profiles)
        if self.k < 1:
            raise ValueError("need at least one profile")
        if not 0.0 <= zeta <= 1.0:
            raise ValueError(f"zeta must be in [0, 1], got {zeta}")
        self.zeta = float(zeta)
        if (gamma is None) == (caps is None):
            raise ValueError("pass exactly one of gamma= or caps=")
        self.gamma = None if gamma is None else tuple(float(g) for g in gamma)
        self._caps_base = (None if caps is None
                           else np.asarray(caps, dtype=np.int64).copy())
        self._cap_deltas = np.zeros(self.k, dtype=np.int64)
        self.check = check

        # cached repair bookkeeping: the lazy _ArcHeaps (and the row-aligned
        # objective buffer they index) survive across reschedules while
        # (ζ, e_max, a_max) are unchanged — a delta repair then skips the
        # O(mk) heap rebuild.  Invalidated on ζ moves, normalization-maxima
        # shifts, and buffer reallocation (_grow/_compact re-home rows).
        self._arcs = None
        self._arcs_key: tuple[float, float, float] | None = None
        self._arcs_rows = 0          # _C_buf rows filled under _arcs_key
        self._C_buf: np.ndarray | None = None
        self.arc_reuse_count = 0     # observability for tests/benchmarks
        self.arc_rebuild_count = 0

        # row-parallel buffers (grown by doubling, compacted when dead rows
        # dominate, so a long stream of reschedules over a sliding window
        # stays O(window) in memory and per-solve cost, not O(arrivals))
        self._next_id = 0                      # external ids handed out
        self._m_total = 0                      # rows in use
        self._queries: list[Query] = []        # by row
        self._row_of: dict[int, int] = {}      # external id -> row
        cap0 = max(64, 2 * len(queries))
        self._E = np.empty((cap0, self.k))
        self._A = np.empty((cap0, self.k))
        self._Rt = np.empty((cap0, self.k))
        self._ids = np.empty(cap0, dtype=np.int64)
        self._alive = np.zeros(cap0, dtype=bool)
        self._assignee = np.empty(cap0, dtype=np.int64)  # -1 = never solved
        self._assignment: Assignment | None = None
        if costs is not None:
            if (costs.model_names != self.model_names
                    or len(costs.queries) != len(queries)):
                raise ValueError("costs= does not match profiles/queries")
            self._append(queries, rows=(costs.energy, costs.accuracy,
                                        costs.runtime))
            self._solve()
        else:
            self.reschedule(added=queries)

    # ------------------------------------------------------------------
    @property
    def next_id(self) -> int:
        """Id the next added query will receive (insertion counter)."""
        return self._next_id

    @property
    def m_active(self) -> int:
        return int(self._alive[:self._m_total].sum())

    @property
    def assignment(self) -> Assignment:
        if self._assignment is None:
            raise RuntimeError("no solve yet")
        return self._assignment

    def _active_rows(self) -> np.ndarray:
        return np.nonzero(self._alive[:self._m_total])[0]

    @property
    def active_ids(self) -> np.ndarray:
        """External ids of live queries, in id (= insertion) order."""
        return self._ids[self._active_rows()]

    def active_queries(self) -> list[Query]:
        """Current workload in id order — the cold-solve-equivalent input."""
        return [self._queries[r] for r in self._active_rows()]

    def _live_row(self, query_id: int) -> int:
        row = self._row_of.get(query_id)
        if row is None or not self._alive[row]:
            raise KeyError(f"query id {query_id} is not live")
        return row

    def bin_of(self, query_id: int) -> int:
        """Current model index of a live query."""
        return int(self._assignee[self._live_row(query_id)])

    def model_of(self, query_id: int) -> str:
        return self.model_names[self.bin_of(query_id)]

    # ------------------------------------------------------------------
    def _invalidate_arcs(self) -> None:
        self._arcs = None
        self._arcs_key = None
        self._arcs_rows = 0
        self._C_buf = None

    def _grow(self, n_new: int) -> None:
        need = self._m_total + n_new
        cap = self._E.shape[0]
        if need <= cap:
            return
        self._invalidate_arcs()   # reallocation re-homes the rows arcs index
        new_cap = max(need, 2 * cap)
        m = self._m_total
        for name in ("_E", "_A", "_Rt"):
            old = getattr(self, name)
            buf = np.empty((new_cap, self.k))
            buf[:m] = old[:m]
            setattr(self, name, buf)
        for name, dtype in (("_ids", np.int64), ("_assignee", np.int64)):
            old = getattr(self, name)
            buf = np.empty(new_cap, dtype=dtype)
            buf[:m] = old[:m]
            setattr(self, name, buf)
        alive = np.zeros(new_cap, dtype=bool)
        alive[:m] = self._alive[:m]
        self._alive = alive

    def _compact(self) -> None:
        """Drop dead rows (triggered when they dominate, so a sliding-
        window stream stays O(window), not O(total arrivals)).  Also the
        bound on stale heap entries: compaction rebuilds the arcs cache."""
        self._invalidate_arcs()
        keep = self._active_rows()
        n = len(keep)
        for name in ("_E", "_A", "_Rt", "_ids", "_assignee"):
            buf = getattr(self, name)
            buf[:n] = buf[keep]
        self._alive[:n] = True
        self._alive[n:self._m_total] = False
        self._queries = [self._queries[r] for r in keep]
        self._m_total = n
        self._row_of = {int(q): r for r, q in enumerate(self._ids[:n])}

    def _append(self, queries: Sequence[Query],
                rows: tuple[np.ndarray, np.ndarray, np.ndarray] | None = None
                ) -> None:
        n = len(queries)
        if n == 0:
            return
        self._grow(n)
        lo, hi = self._m_total, self._m_total + n
        if rows is None:
            tin = np.array([q[0] for q in queries], dtype=np.float64)
            tout = np.array([q[1] for q in queries], dtype=np.float64)
            # same elementwise model evaluations normalized_costs performs,
            # so a cold solve over the identical workload sees bit-identical
            # raw matrices
            self._E[lo:hi] = np.stack([p.energy(tin, tout)
                                       for p in self.profiles], axis=1)
            self._Rt[lo:hi] = np.stack([p.runtime(tin, tout)
                                        for p in self.profiles], axis=1)
            self._A[lo:hi] = np.stack([p.accuracy(tin, tout)
                                       for p in self.profiles], axis=1)
        else:
            e, a, r = rows
            self._E[lo:hi], self._A[lo:hi], self._Rt[lo:hi] = e, a, r
        self._queries.extend((int(a), int(b)) for a, b in queries)
        self._alive[lo:hi] = True
        self._assignee[lo:hi] = -1
        ids = np.arange(self._next_id, self._next_id + n, dtype=np.int64)
        self._ids[lo:hi] = ids
        self._row_of.update((int(q), lo + i) for i, q in enumerate(ids))
        self._next_id += n
        self._m_total = hi

    def _caps_for(self, m: int) -> np.ndarray:
        if self.gamma is not None:
            caps = scheduler._capacities_from_gamma(self.gamma, m)
        else:
            caps = self._caps_base.copy()
        caps = np.maximum(caps + self._cap_deltas, 0)
        if int(caps.sum()) < m:
            raise RuntimeError(
                f"infeasible capacities {caps.tolist()} for {m} queries")
        return caps

    def _objective_rows(self, rows: np.ndarray, e_max: float,
                        a_max: float) -> np.ndarray:
        """Eq. 2 objective rows under the given normalization maxima —
        elementwise-identical to ``objective_matrix(normalized_costs(...))``
        on the same rows (same divisions, same saxpy)."""
        E, A = self._E[rows], self._A[rows]
        e_hat = E / e_max if e_max > 0 else E
        a_hat = A / a_max if a_max > 0 else A
        return self.zeta * e_hat - (1.0 - self.zeta) * a_hat

    def _solve(self) -> Assignment:
        act = self._active_rows()
        m = len(act)
        if m == 0:
            raise ValueError("empty workload")
        E, A, Rt = self._E[act], self._A[act], self._Rt[act]
        # the same normalization arithmetic normalized_costs applies (its
        # "divide by the largest known value" rule over the active rows)
        e_max = float(E.max())
        a_max = float(A.max())
        costs = NormalizedCosts(
            model_names=self.model_names,
            queries=tuple(self._queries[r] for r in act),
            energy=E, accuracy=A, runtime=Rt,
            energy_hat=E / e_max if e_max > 0 else E,
            accuracy_hat=A / a_max if a_max > 0 else A,
        )
        caps = self._caps_for(m)
        key = (self.zeta, e_max, a_max)

        if self._arcs is not None and key == self._arcs_key:
            # same ζ and normalization maxima: every cached regret
            # (C[i,v] − C[i,u]) is still exact for surviving rows, so the
            # heaps extend instead of rebuilding — removed rows were
            # retired to −1 (skipped lazily), added rows get their
            # objective row appended and an argmin warm seed pushed.
            self.arc_reuse_count += 1
            lo, hi = self._arcs_rows, self._m_total
            if hi > lo:
                self._C_buf[lo:hi] = self._objective_rows(
                    np.arange(lo, hi), e_max, a_max)
                self._arcs_rows = hi
            fresh_rows = act[self._assignee[act] < 0]
            for r in fresh_rows:
                j = int(self._C_buf[r].argmin())
                self._assignee[r] = j
                self._arcs.push(int(r), j)
            C = self._C_buf[act]
            scheduler._repair_live(
                caps, self._assignee, self._arcs,
                tol=1e-12 * max(1.0, float(np.abs(C).max())),
                n_rows=self._m_total)
            assignee = self._assignee[act].copy()
        else:
            # ζ or a normalization maximum moved (or buffers were
            # re-homed): every objective entry changed — rebuild the
            # row-aligned buffer and heaps, then warm-repair as before.
            self.arc_rebuild_count += 1
            C_act = objective_matrix(costs, self.zeta)
            cap_rows = self._E.shape[0]
            if self._C_buf is None or self._C_buf.shape[0] != cap_rows:
                self._C_buf = np.empty((cap_rows, self.k))
            self._C_buf[act] = C_act
            fresh_rows = act[self._assignee[act] < 0]
            if len(fresh_rows):  # new queries start at their argmin
                self._assignee[fresh_rows] = (
                    self._C_buf[fresh_rows].argmin(axis=1))
            self._arcs = scheduler._ArcHeaps(
                self._C_buf, self._assignee, self.k, n_rows=self._m_total)
            self._arcs_key = key
            self._arcs_rows = self._m_total
            C = self._C_buf[act]
            scheduler._repair_live(
                caps, self._assignee, self._arcs,
                tol=1e-12 * max(1.0, float(np.abs(C).max())),
                n_rows=self._m_total)
            assignee = self._assignee[act].copy()
        if self.check and not scheduler.capacitated_optimality_certificate(
                C, assignee, caps):
            raise RuntimeError("optimality certificate failed after repair")
        self._assignment = scheduler._evaluate(costs, assignee, self.zeta, C=C)
        return self._assignment

    # ------------------------------------------------------------------
    def reschedule(
        self,
        added: Sequence[Query] = (),
        removed: Iterable[int] = (),
        capacity_deltas: Sequence[int] | None = None,
        *,
        zeta: float | None = None,
    ) -> Assignment:
        """Apply a workload/capacity/ζ delta and re-solve warm.

        ``added`` queries get ids ``next_id, next_id+1, ...``; ``removed``
        are existing live ids; ``capacity_deltas`` shifts per-model caps
        (accumulating across calls); ``zeta`` moves the objective.
        Returns the exact Assignment over the updated workload (active
        queries in id order)."""
        if zeta is not None:
            if not 0.0 <= zeta <= 1.0:
                raise ValueError(f"zeta must be in [0, 1], got {zeta}")
            self.zeta = float(zeta)
        if capacity_deltas is not None:
            d = np.asarray(capacity_deltas, dtype=np.int64)
            if d.shape != (self.k,):
                raise ValueError(f"capacity_deltas must have shape ({self.k},)")
            self._cap_deltas += d
        for rid in removed:
            row = self._live_row(int(rid))
            self._alive[row] = False
            self._assignee[row] = -1   # retire: cached heaps skip −1 lazily
        if self._m_total > 256 and self.m_active < self._m_total // 2:
            self._compact()
        self._append(list(added))
        return self._solve()


# ---------------------------------------------------------------------------
# Streaming ζ sweep / Pareto frontier
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ParetoFrontier:
    """A traced energy–runtime–accuracy frontier.

    ``zetas[i]`` is where ``assignments[i]`` was evaluated.  In breakpoint
    mode, ``breakpoints`` are the exact ζ where the unconstrained argmin
    assignment changes and ``zetas`` are the segment midpoints (one
    representative per constant-assignment piece); in grid mode
    ``breakpoints`` is None."""

    zetas: tuple[float, ...]
    assignments: tuple[Assignment, ...]
    breakpoints: tuple[float, ...] | None = None

    def energies(self) -> np.ndarray:
        return np.array([a.total_energy_j for a in self.assignments])

    def runtimes(self) -> np.ndarray:
        return np.array([a.total_runtime_s for a in self.assignments])

    def accuracies(self) -> np.ndarray:
        return np.array([a.mean_accuracy_ak for a in self.assignments])

    def objectives(self) -> np.ndarray:
        return np.array([a.objective for a in self.assignments])


def frontier_breakpoints(costs: NormalizedCosts, *,
                         tol: float = 1e-12) -> np.ndarray:
    """Exact ζ ∈ (0, 1) where the unconstrained argmin assignment changes.

    Per query, model v's objective is the line f_v(ζ) = ζ·(ê_v+â_v) − â_v;
    candidates are pairwise crossings, kept iff the crossing pair is
    jointly minimal over all k lines there (i.e. the crossing lies on the
    lower envelope, where the argmin actually switches)."""
    S = costs.energy_hat + costs.accuracy_hat     # line slopes
    A = costs.accuracy_hat                        # line intercepts are -A
    m, k = S.shape
    scale = max(1.0, float(np.abs(S).max()), float(np.abs(A).max()))
    out: list[np.ndarray] = []
    for u in range(k):
        for v in range(u + 1, k):
            ds = S[:, u] - S[:, v]
            ok = np.abs(ds) > tol * scale         # parallel lines never cross
            z = np.where(ok, (A[:, u] - A[:, v]) / np.where(ok, ds, 1.0), -1.0)
            inside = ok & (z > tol) & (z < 1.0 - tol)
            if not inside.any():
                continue
            zi = z[inside]
            F = zi[:, None] * S[inside] - A[inside]
            on_envelope = F[:, u] <= F.min(axis=1) + 1e-9 * scale
            if on_envelope.any():
                out.append(zi[on_envelope])
    if not out:
        return np.empty(0)
    z = np.unique(np.concatenate(out))
    keep = [float(z[0])]
    for val in z[1:]:                             # merge fp-duplicate crossings
        if val - keep[-1] > tol:
            keep.append(float(val))
    return np.array(keep)


def pareto_frontier(
    profiles: Sequence[LLMProfile],
    queries: Sequence[Query],
    zetas: Sequence[float] | None = None,
    *,
    gamma: Sequence[float] | None = None,
    caps: Sequence[int] | None = None,
    costs: NormalizedCosts | None = None,
    breakpoints: bool = False,
    check: bool = False,
) -> ParetoFrontier:
    """Trace the Eq. 2 energy–runtime–accuracy frontier over ζ.

    The normalized cost matrices are built ONCE for the whole sweep; each
    ζ objective is one saxpy over them.  Modes:

      * ``breakpoints=True`` (unconstrained only): exact frontier — the ζ
        where the argmin assignment changes, plus one assignment per
        constant segment (evaluated at the segment midpoint, with pure
        argmin semantics: ``schedule(..., enforce_nonempty=False)``).
      * grid (default): one assignment per requested ζ.  Capacitated
        solves warm-start from the adjacent ζ's assignment through
        ``IncrementalScheduler``; unconstrained solves are the vectorized
        argmin of ``scheduler.schedule``.
    """
    if costs is None:
        costs = normalized_costs(profiles, queries)
    constrained = gamma is not None or caps is not None
    if breakpoints:
        if constrained:
            raise ValueError("exact breakpoints apply to the unconstrained "
                             "argmin; use a ζ grid for capacitated sweeps")
        bps = frontier_breakpoints(costs)
        edges = np.concatenate([[0.0], bps, [1.0]])
        mids = (edges[:-1] + edges[1:]) / 2.0
        asgs = []
        for z in mids:
            C = objective_matrix(costs, float(z))
            asgs.append(scheduler._evaluate(costs, C.argmin(axis=1),
                                            float(z), C=C))
        return ParetoFrontier(tuple(float(z) for z in mids), tuple(asgs),
                              tuple(float(b) for b in bps))

    if zetas is None:
        raise ValueError("grid mode needs zetas= (or pass breakpoints=True)")
    zs = [float(z) for z in zetas]
    order = np.argsort(zs, kind="stable")
    asg_by_pos: dict[int, Assignment] = {}
    if not constrained:
        for pos in order:
            asg_by_pos[pos] = scheduler.schedule(profiles, queries, zs[pos],
                                                 costs=costs)
    else:
        inc: IncrementalScheduler | None = None
        for pos in order:
            if inc is None:
                inc = IncrementalScheduler(profiles, queries, zs[pos],
                                           gamma, caps=caps, costs=costs,
                                           check=check)
                asg_by_pos[pos] = inc.assignment
            else:
                asg_by_pos[pos] = inc.reschedule(zeta=zs[pos])
    return ParetoFrontier(tuple(zs), tuple(asg_by_pos[i]
                                           for i in range(len(zs))), None)
