"""Port copy of `repro.cluster.policies`, numpy only, with its imports renamed
and one repair: `GreedyEnergyPolicy` keeps its ties in a band relative on
either side of zero, where the reference raises once the least predicted
energy is negative (a fitted profile can extrapolate below zero).
tests/test_torch_cluster*.py hold it to the reference.

Pluggable online routing policies.

A policy sees each request exactly once, at its arrival instant, and must
pick a node before the next arrival — the online counterpart of the
paper's offline partition.  The common interface:

    policy.attach(nodes, trace, zeta)   # once, before the event loop
    policy.select(req, nodes, now) -> node_id

`attach` may precompute whatever the policy's information model allows:
the load-based policies use nothing; the energy-aware policies use the
fitted LLMProfiles (the paper's offline-knowledge assumption for τout,
citing Zheng et al. for online estimation); the offline oracle uses the
*entire* trace and replays core.scheduler.schedule() — the paper's exact
optimum, serving as the lower bound every online policy is measured
against (the offline→online gap).

ZetaOnlinePolicy implements the paper's "dynamically normalize ... by the
largest known value" rule *causally*: its normalizers grow as requests
stream in, so early routing decisions use stale maxima — a genuine source
of online regret that vanishes as the trace warms up.

τout information models: the energy-aware policies take an optional
``tau_out_predictor`` (repro_torch.cluster.predictors.TauOutPredictor).  Without
one they read the request's true τout — the paper's offline-knowledge
assumption.  With one they price each candidate model at its predicted
quantile, learning only from completions the event loop echoes through
``observe_completion`` — never from the trace — so fig4 can measure the
information gap (oracle-τout vs predicted-τout router) separately from
the commitment gap (oracle-τout router vs the offline replay).

Multi-replica fleets: several nodes may host the same model
(``replica_registry`` maps model → node ids).  ``ReplicaEnergyPolicy`` is
the replica-*set* router — it scores nodes, not models, folding each
replica's pending wake energy (amortized over an expected burst) into the
Eq. 2 argmin, so the fleet's power state shapes the objective instead of
just breaking ties.  ``ReplicaOraclePolicy`` is the replica-aware offline
bound: it replays ``core.scheduler.schedule_replicated`` — the same
model-level optimum as ``OfflineOraclePolicy``, with each model's bin
split into per-replica capacities — so the oracle commits to *node*
placement offline and the fig4 commitment gap stays apples-to-apples on
replicated fleets.

Preemption: ``PreemptionPolicy.consider`` is consulted by the event loop
at every arrival, after routing.  ``SLOPreemptionPolicy`` cuts the routed
node's decode segment — evicting the lowest-ζ-value active member — when
a higher-value arrival would otherwise wait past its slowdown SLO; the
victim suspends at the next decode step boundary (KV intact) and resumes
when a slot frees.
"""

from __future__ import annotations

from collections import deque
from typing import Sequence

import numpy as np

from repro_torch.core.energy_model import LLMProfile, normalized_costs, objective_matrix
from repro_torch.core.scheduler import (
    cached_costs,
    schedule,
    schedule_replicated,
    schedule_with_cache,
    schedule_with_liveness,
)
from repro_torch.core.sweep import IncrementalScheduler

from repro_torch.cluster.faults import (
    NORMAL,
    RECOVER,
    FaultTrace,
    domain_groups,
    domain_index,
)
from repro_torch.cluster.metrics import replica_registry  # noqa: F401  (re-export)
from repro_torch.cluster.predictors import TauOutPredictor
from repro_torch.cluster.trace import ArrivalTrace, TracedRequest


def unique_profiles(nodes: Sequence) -> list[LLMProfile]:
    """Distinct hosted models in node order (replicas collapse)."""
    seen: dict[str, LLMProfile] = {}
    for n in nodes:
        seen.setdefault(n.profile.name, n.profile)
    return list(seen.values())


class RoutingPolicy:
    name = "base"
    telemetry = None   # repro_torch.obs.Telemetry, set per-run by simulate_cluster
    #: What the policy reads off each candidate node at `select` time —
    #: the engine's process-pool runner keeps node state in worker
    #: processes and routes over light node views, so it only admits
    #: policies that declare a view-compatible information model:
    #:   "none"   — static attributes only (ids, hosted model, profile)
    #:   "counts" — also load()/power_rank/accepting (the shipped view)
    #:   "full"   — arbitrary node internals; merge/windowed modes only
    fleet_reads = "full"
    #: Soonest a displaced request can re-enter routing (the first rung
    #: of retry_delay's backoff ladder).  The sharded engine's
    #: conservative lookahead (engine.runner.cross_shard_floor_s) reads
    #: this: no cross-shard retry can land sooner than the floor.
    retry_floor_s = 1.0

    def attach(self, nodes: Sequence, trace: ArrivalTrace, zeta: float) -> None:
        pass

    def select(self, req: TracedRequest, nodes: Sequence, now: float) -> int:
        raise NotImplementedError

    def observe_completion(self, record, now: float) -> None:
        """Causal completion feedback (a metrics.RequestRecord): the only
        channel through which a non-oracle policy learns true τout."""

    # --- rescue hooks (consulted by the event loop on fault runs only) --
    def retry_delay(self, req: TracedRequest, attempts: int,
                    now: float) -> float | None:
        """Backoff before re-routing a request no node would accept:
        capped exponential (1, 2, 4, ... up to 60 s), giving up — return
        None to abandon — after 8 attempts.  Policies override for
        deadline-aware abandonment."""
        if attempts >= 8:
            return None
        return min(float(2 ** attempts), 60.0)

    def allow_rerun(self, req: TracedRequest, now: float) -> bool:
        """Whether a refugee decode with no surviving same-model replica
        may re-run from scratch on a different model (its accrued joules
        are wasted either way).  Default: abandon instead."""
        return False

    def on_fault(self, event, nodes: Sequence, now: float) -> None:
        """Fault-stream notification (a faults.FaultEvent, after the sim
        applied it) — the governance channel for failover policies."""

    def drain_updates(self, nodes: Sequence,
                      now: float) -> list[tuple[int, bool]] | None:
        """Straggler governance, polled at completion boundaries: return
        [(node_id, drain?), ...] to start/stop draining nodes (a draining
        node takes no new routes and ships its parked refugees off; its
        running decodes finish naturally).  Default: never drains."""
        return None

    # ------------------------------------------------------------------
    @staticmethod
    def _least_loaded(candidates: Sequence) -> int:
        # equal load breaks toward the node that can serve soonest
        # (powered < waking < gated < gating < failed); always-on fleets
        # have power_rank 0 everywhere, so the load-only ordering is unchanged
        best = min(candidates,
                   key=lambda n: (n.load(), n.power_rank, n.node_id))
        return best.node_id

    @staticmethod
    def _nodes_hosting(nodes: Sequence, model_name: str) -> list:
        hosts = [n for n in nodes if n.profile.name == model_name]
        return hosts or list(nodes)


class RoundRobinPolicy(RoutingPolicy):
    name = "round_robin"
    fleet_reads = "none"

    def __init__(self):
        self._i = 0

    def attach(self, nodes, trace, zeta):
        self._i = 0

    def select(self, req, nodes, now):
        nid = nodes[self._i % len(nodes)].node_id
        self._i += 1
        return nid


class RandomPolicy(RoutingPolicy):
    name = "random"
    fleet_reads = "none"

    def __init__(self, seed: int = 0):
        self.seed = seed
        self._rng = np.random.default_rng(seed)

    def attach(self, nodes, trace, zeta):
        self._rng = np.random.default_rng(self.seed)

    def select(self, req, nodes, now):
        return nodes[int(self._rng.integers(len(nodes)))].node_id


class LeastLoadedPolicy(RoutingPolicy):
    """Join-the-shortest-queue over waiting + in-flight counts."""

    name = "least_loaded"
    fleet_reads = "counts"

    def select(self, req, nodes, now):
        return self._least_loaded(nodes)


class _TauOutMixin:
    """Shared τout information model: oracle (read the trace's true value)
    or a TauOutPredictor fed causally from completions."""

    def _init_predictor(self, tau_out_predictor: TauOutPredictor | None):
        self.predictor = tau_out_predictor
        if tau_out_predictor is not None:
            self.name = f"{self.name}+tau_pred"

    def _reset_predictor(self):
        if self.predictor is not None:
            self.predictor.reset()

    def _tau_for(self, req, model_name: str | None) -> float:
        if self.predictor is None:
            return float(req.tau_out)
        return self.predictor.predict(model_name)

    def observe_completion(self, record, now):
        if self.predictor is not None:
            if self.telemetry is not None:
                # pre-update prediction vs truth: the error the router
                # actually acted on when it placed this request (peek is
                # O(1); None when no arrival priced this model since the
                # last observation, in which case there is no acted-on
                # prediction to score)
                pred = self.predictor.peek(record.model)
                if pred is not None:
                    self.telemetry.on_prediction_error(
                        self.name, record.model, pred, record.tau_out)
            self.predictor.observe(record.model, record.tau_out)


class GreedyEnergyPolicy(_TauOutMixin, RoutingPolicy):
    """Per-request argmin of predicted energy e_K(τin, τout); ties and
    replicas break toward the least-loaded host."""

    name = "greedy_energy"
    fleet_reads = "counts"

    def __init__(self, *, tau_out_predictor: TauOutPredictor | None = None):
        self._init_predictor(tau_out_predictor)

    def attach(self, nodes, trace, zeta):
        self._reset_predictor()

    def select(self, req, nodes, now):
        preds = [float(n.profile.energy(
                     req.tau_in, self._tau_for(req, n.profile.name)))
                 for n in nodes]
        best = min(preds)
        # a relative tie band on either side of zero: a fitted profile can
        # extrapolate to a negative energy, where the reference's band
        # `best * (1 + 1e-12)` holds no prediction and its select raises
        band = best * (1 + 1e-12) if best >= 0 else best * (1 - 1e-12)
        hosts = [n for n, p in zip(nodes, preds) if p <= band]
        return self._least_loaded(hosts)


class ZetaOnlinePolicy(_TauOutMixin, RoutingPolicy):
    """Causal Eq. 2: ζ·ê − (1−ζ)·â with *running* normalizers.

    The paper normalizes by the largest energy/accuracy over the whole
    workload before optimizing; online, only requests seen so far are
    known, so the maxima grow as traffic streams in."""

    name = "zeta_online"
    fleet_reads = "counts"

    def __init__(self, zeta: float | None = None, *,
                 tau_out_predictor: TauOutPredictor | None = None):
        self.zeta_override = zeta
        self.zeta = 0.5
        self._e_max = 0.0
        self._a_max = 0.0
        self._init_predictor(tau_out_predictor)

    def attach(self, nodes, trace, zeta):
        self.zeta = self.zeta_override if self.zeta_override is not None else zeta
        self._e_max = 0.0
        self._a_max = 0.0
        self._reset_predictor()

    def _observe(self, req, nodes):
        """Fold a request into the running normalizers (every arrival must
        pass through here, whatever routing rule ends up deciding it).
        Under a predictor the normalizers, like the scores, are built from
        predicted τout — the true value is not observable at routing time."""
        e = np.array([float(n.profile.energy(
                          req.tau_in, self._tau_for(req, n.profile.name)))
                      for n in nodes])
        a = np.array([float(n.profile.accuracy(
                          req.tau_in, self._tau_for(req, n.profile.name)))
                      for n in nodes])
        self._e_max = max(self._e_max, float(e.max()))
        self._a_max = max(self._a_max, float(a.max()))
        return e, a

    def select(self, req, nodes, now):
        e, a = self._observe(req, nodes)
        obj = self.zeta * e / self._e_max - (1.0 - self.zeta) * a / self._a_max
        order = np.argsort(obj, kind="stable")
        best = [nodes[i] for i in order if obj[i] <= obj[order[0]] + 1e-12]
        return self._least_loaded(best)


class ZetaReplanPolicy(ZetaOnlinePolicy):
    """Periodic warm-start re-planner: zeta_online upgraded with the
    γ-capacitated offline partition, maintained incrementally online.

    Keeps a sliding window of the last `window` observed queries inside a
    ``core.sweep.IncrementalScheduler`` and, every `replan_every`
    arrivals, applies the delta (arriving queries in, expired window
    entries out) via ``reschedule`` — an O(delta) warm-start repair of the
    exact capacitated Eq. 2 optimum, not a cold re-solve.  An arrival that
    was part of the latest re-plan is routed to the model its slot got in
    the refreshed partition; arrivals between re-plans (replan_every > 1)
    and the pre-warmup prefix fall back to the causal zeta_online rule.

    `gamma` defaults to the fleet's replica shares, so the plan enforces
    the data-center partition of the paper's §6.3 case study causally —
    something the pointwise-argmin policies cannot express."""

    name = "zeta_replan"

    def __init__(self, zeta: float | None = None, *,
                 gamma: Sequence[float] | None = None,
                 window: int = 512, replan_every: int = 1,
                 min_queries: int = 4,
                 tau_out_predictor: TauOutPredictor | None = None):
        super().__init__(zeta, tau_out_predictor=tau_out_predictor)
        if window < 1 or replan_every < 1:
            raise ValueError("window and replan_every must be >= 1")
        if replan_every > window:
            raise ValueError("replan_every must be <= window (each replan "
                             "folds at most a window's worth of arrivals)")
        self.gamma_arg = None if gamma is None else tuple(gamma)
        self.window = window
        self.replan_every = replan_every
        self.min_queries = min_queries

    def attach(self, nodes, trace, zeta):
        super().attach(nodes, trace, zeta)
        self._profiles = unique_profiles(nodes)
        if self.gamma_arg is not None:
            self._gamma = self.gamma_arg
        else:  # replica shares: each model's fraction of the fleet
            hosts = {p.name: 0 for p in self._profiles}
            for n in nodes:
                hosts[n.profile.name] += 1
            self._gamma = tuple(hosts[p.name] / len(nodes)
                                for p in self._profiles)
        if len(self._gamma) != len(self._profiles):
            raise ValueError("gamma length must match the distinct models")
        self._sched: IncrementalScheduler | None = None
        self._window_ids: deque[int] = deque()
        self._pending: list[tuple[int, int]] = []

    def _replan(self) -> None:
        """Fold pending arrivals in, expired window entries out — one
        warm-start reschedule call for the whole delta."""
        if self._sched is None:
            self._sched = IncrementalScheduler(
                self._profiles, self._pending, self.zeta, self._gamma)
            self._window_ids.extend(range(len(self._pending)))
            if len(self._window_ids) > self.window:  # warmup > window
                expired = [self._window_ids.popleft() for _ in
                           range(len(self._window_ids) - self.window)]
                self._sched.reschedule(removed=expired)
        else:
            first_id = self._sched.next_id
            n_new = len(self._pending)
            expired = []
            while (self._window_ids
                   and len(self._window_ids) + n_new > self.window):
                expired.append(self._window_ids.popleft())
            self._sched.reschedule(added=self._pending, removed=expired)
            self._window_ids.extend(range(first_id, first_id + n_new))
        self._pending = []

    def select(self, req, nodes, now):
        # the plan's query uses the pooled τ̂out under a predictor (the
        # partition is chosen before the serving model is known)
        self._pending.append((req.tau_in,
                              int(round(self._tau_for(req, None)))))
        n_seen = (len(self._pending) if self._sched is None
                  else self._sched.next_id + len(self._pending))
        warmed = n_seen >= max(self.min_queries, len(self._profiles))
        if warmed and (self._sched is None
                       or len(self._pending) >= self.replan_every):
            # normalizers see every arrival: here explicitly, on the
            # fallback path inside super().select
            self._observe(req, nodes)
            self._replan()
            model = self._sched.model_of(self._sched.next_id - 1)
            hosts = self._nodes_hosting(nodes, model)
            return self._least_loaded(hosts)
        # pre-warmup / between re-plans: causal zeta_online fallback
        return super().select(req, nodes, now)


class OfflineOraclePolicy(RoutingPolicy):
    """Replays the paper's offline optimum (core.scheduler.schedule with
    coverage/disjointness only) over the full trace — the upper bound on
    what any online policy can achieve on the Eq. 2 objective."""

    name = "offline_oracle"

    def __init__(self):
        self._model_of: dict[int, str] = {}

    def attach(self, nodes, trace, zeta):
        profiles = unique_profiles(nodes)
        asg = schedule(profiles, trace.queries(), zeta, enforce_nonempty=False)
        self._model_of = {
            r.request_id: asg.model_names[int(k)]
            for r, k in zip(trace.requests, asg.assignee)}

    def select(self, req, nodes, now):
        hosts = self._nodes_hosting(nodes, self._model_of[req.request_id])
        return self._least_loaded(hosts)


class ReplicaEnergyPolicy(ZetaOnlinePolicy):
    """Replica-set router: the causal Eq. 2 argmin taken over *nodes*, with
    each replica's power state priced into the objective instead of only
    breaking ties.

    A gated (or still-gating) replica costs `pending_wake_j` to bring up
    before it can serve; that energy is shared by however many requests
    the wake ends up serving, so the router amortizes it over
    `wake_amortize` expected requests and adds the share to the candidate
    score on the same normalization as the energy term:

        score(node) = ζ·ê/ê_max − (1−ζ)·â/â_max
                      + ζ·(pending_wake_j / wake_amortize)/ê_max

    With every replica awake the wake term vanishes and the policy reduces
    exactly to zeta_online over the replica set; near-ties still break
    least-loaded-first, so replicas of the chosen model share load."""

    name = "replica_energy"

    def __init__(self, zeta: float | None = None, *,
                 wake_amortize: float = 8.0,
                 tau_out_predictor: TauOutPredictor | None = None):
        if wake_amortize <= 0:
            raise ValueError("wake_amortize must be > 0")
        super().__init__(zeta, tau_out_predictor=tau_out_predictor)
        self.wake_amortize = wake_amortize

    def select(self, req, nodes, now):
        e, a = self._observe(req, nodes)
        wake = np.array([n.pending_wake_j for n in nodes])
        obj = (self.zeta * (e + wake / self.wake_amortize) / self._e_max
               - (1.0 - self.zeta) * a / self._a_max)
        order = np.argsort(obj, kind="stable")
        best = [nodes[i] for i in order if obj[i] <= obj[order[0]] + 1e-12]
        return self._least_loaded(best)


class DomainSpreadPolicy(ZetaOnlinePolicy):
    """Survivability-aware router: the causal Eq. 2 argmin with a
    blast-radius anti-affinity term priced into the objective.

    Each node belongs to one fault domain (a rack or PDU leg from
    ``faults.FaultDomain`` / ``rack_pdu_topology``, or an explicit
    partition of node ids).  A correlated outage takes a whole domain at
    once, so the expected work lost to the next outage is proportional
    to how concentrated the fleet's in-flight work is — the router
    therefore charges each candidate the live-load fraction already
    sitting in its domain, on the same normalization as the energy term:

        score(node) = ζ·ê/ê_max − (1−ζ)·â/â_max
                      + ζ·spread_weight·(domain_load / fleet_load)

    With all load in one domain the penalty is maximal there and zero in
    an empty domain; with load perfectly spread the penalty is uniform
    and the policy reduces exactly to zeta_online.  Near-ties break
    toward the *emptiest domain* first (the hard anti-affinity guard:
    replicas of concurrent work land in different domains whenever the
    Eq. 2 scores cannot tell them apart), then least-loaded."""

    name = "domain_spread"

    def __init__(self, domains, zeta: float | None = None, *,
                 spread_weight: float = 0.25,
                 tau_out_predictor: TauOutPredictor | None = None):
        if spread_weight < 0:
            raise ValueError("spread_weight must be >= 0")
        super().__init__(zeta, tau_out_predictor=tau_out_predictor)
        groups = domain_groups(domains)
        if groups is None:
            raise ValueError("DomainSpreadPolicy needs a fault-domain "
                             "topology (FaultDomain or groups of node ids)")
        self._dom_of = domain_index(groups)
        self.n_domains = len(groups)
        self.spread_weight = spread_weight

    def attach(self, nodes, trace, zeta):
        super().attach(nodes, trace, zeta)
        missing = [n.node_id for n in nodes if n.node_id not in self._dom_of]
        if missing:
            raise ValueError(
                f"nodes {missing} are in no fault domain — the topology "
                f"must cover the fleet")

    def _domain_loads(self, nodes) -> dict[int, float]:
        loads: dict[int, float] = {}
        for n in nodes:
            d = self._dom_of[n.node_id]
            loads[d] = loads.get(d, 0.0) + n.load()
        return loads

    def select(self, req, nodes, now):
        e, a = self._observe(req, nodes)
        dom_load = self._domain_loads(nodes)
        fleet = sum(dom_load.values())
        conc = np.array([
            (dom_load[self._dom_of[n.node_id]] / fleet) if fleet else 0.0
            for n in nodes])
        obj = (self.zeta * e / self._e_max
               - (1.0 - self.zeta) * a / self._a_max
               + self.zeta * self.spread_weight * conc)
        order = np.argsort(obj, kind="stable")
        best = [nodes[i] for i in order if obj[i] <= obj[order[0]] + 1e-12]
        pick = min(best, key=lambda n: (dom_load[self._dom_of[n.node_id]],
                                        n.load(), n.power_rank, n.node_id))
        return pick.node_id


class SessionAffinityPolicy(ZetaOnlinePolicy):
    """Session-sticky router: the causal Eq. 2 argmin with a warm-prefix
    discount priced into the objective.

    The policy remembers, per session, the last node it routed that
    session to.  A follow-up turn carrying ``prefix_tokens`` re-used
    context can only hit the KV prefix cache on *that* node (caches are
    per-node and crash-volatile), so the remembered node's energy term is
    discounted by the fraction of the prompt the cache would absorb:

        obj(warm) −= ζ · affinity_weight · (prefix/τin) · ê_warm/ê_max

    The discount is an *estimate* folded into the same normalization the
    base argmin uses — the realized saving is whatever the node's cache
    actually serves (it may have evicted the entry).  First turns, cold
    sessions, and sessionless traffic score identically to zeta_online.
    When the remembered node is absent from the candidate list or not
    immediately serviceable (``power_rank != 0``: waking, gated, gating,
    or failed), the discount is skipped entirely and the policy falls
    back to the plain causal argmin — affinity never routes work into a
    dead or sleeping node."""

    name = "session_affinity"
    fleet_reads = "counts"

    def __init__(self, zeta: float | None = None, *,
                 affinity_weight: float = 0.5,
                 tau_out_predictor: TauOutPredictor | None = None):
        if affinity_weight < 0:
            raise ValueError("affinity_weight must be >= 0")
        super().__init__(zeta, tau_out_predictor=tau_out_predictor)
        self.affinity_weight = affinity_weight

    def attach(self, nodes, trace, zeta):
        super().attach(nodes, trace, zeta)
        self._warm: dict[int, int] = {}

    def select(self, req, nodes, now):
        e, a = self._observe(req, nodes)
        obj = self.zeta * e / self._e_max - (1.0 - self.zeta) * a / self._a_max
        warm_node = (self._warm.get(req.session_id)
                     if req.session_id >= 0 and req.prefix_tokens > 0
                     else None)
        if warm_node is not None:
            frac = min(req.prefix_tokens / max(req.tau_in, 1), 1.0)
            for i, n in enumerate(nodes):
                if n.node_id == warm_node and n.power_rank == 0:
                    obj[i] -= (self.zeta * self.affinity_weight * frac
                               * e[i] / self._e_max)
                    break
        order = np.argsort(obj, kind="stable")
        best = [nodes[i] for i in order if obj[i] <= obj[order[0]] + 1e-12]
        pick = self._least_loaded(best)
        if req.session_id >= 0:
            self._warm[req.session_id] = pick
        return pick


class ReplicaOraclePolicy(OfflineOraclePolicy):
    """Replica-aware offline oracle: replays
    ``core.scheduler.schedule_replicated`` over the full trace, committing
    each request to a *node* (a specific replica), not just a model.

    With the default ``gamma=None`` the model-level assignment is the
    unconstrained Eq. 2 optimum — identical objective to
    ``OfflineOraclePolicy`` — and each model's realized query count is
    split into balanced per-replica capacities, so the oracle bound on the
    objective is preserved while replica placement is priced by the same
    capacitated machinery the γ-constrained case study uses.  Passing
    ``gamma=`` instead prices the paper's data-center partition across
    the replica set."""

    name = "replica_oracle"

    def __init__(self, gamma: Sequence[float] | None = None):
        self.gamma_arg = None if gamma is None else tuple(gamma)
        self._node_of: dict[int, int] = {}

    def attach(self, nodes, trace, zeta):
        profiles = unique_profiles(nodes)
        registry = replica_registry(nodes)
        counts = [len(registry[p.name]) for p in profiles]
        self._node_of = {}
        if not len(trace):
            return
        rasg = schedule_replicated(profiles, trace.queries(), zeta, counts,
                                   gamma=self.gamma_arg)
        # global replica index -> node id, in the same flattening order
        rep_nodes = [nid for p in profiles for nid in registry[p.name]]
        for r, rr in zip(trace.requests, rasg.replica_of):
            self._node_of[r.request_id] = rep_nodes[int(rr)]

    def select(self, req, nodes, now):
        return self._node_of[req.request_id]


class FailoverPolicy(RoutingPolicy):
    """Fault-tolerant wrapper: any routing policy, plus rescue governance.

    Routing delegates to the wrapped `inner` policy (the sim already
    filters the candidate list to accepting nodes on fault runs), and the
    wrapper supplies the fault-run hooks:

      * *retry* — capped exponential backoff (`base_delay_s` doubling to
        `max_delay_s`) when no node accepts, up to `max_retries` attempts;
        deadline-aware: with `abandon_after_s` set, a request whose age
        exceeds it is abandoned instead of retried again.
      * *re-run* — `rerun=True` (default) lets a refugee with no
        surviving same-model replica restart from scratch on another
        model rather than be abandoned.
      * *straggler mitigation* — a causal per-node EWMA of realized
        service stretch ((finish − start) / isolated runtime, fed only by
        the `observe_completion` channel, never by telemetry or the fault
        trace) is compared against the fleet median at every completion;
        a node exceeding `straggle_threshold` × median (after
        `min_observations` samples, and never the last accepting replica
        of its model) is *drained* — it finishes its running work, ships
        parked refugees off, and takes no new routes.  A drained node is
        probed again after `drain_cooldown_s` (its EWMA resets), and a
        `normal`/`recover` fault event un-drains it immediately — the
        drain-before-gate loop of the straggler-governance design."""

    def __init__(self, inner: RoutingPolicy, *,
                 max_retries: int = 8, base_delay_s: float = 1.0,
                 max_delay_s: float = 60.0,
                 abandon_after_s: float | None = None,
                 rerun: bool = True,
                 straggle_threshold: float = 1.75,
                 min_observations: int = 4,
                 drain_cooldown_s: float = 120.0,
                 ewma_alpha: float = 0.3):
        if max_retries < 0 or base_delay_s <= 0 or max_delay_s < base_delay_s:
            raise ValueError("need max_retries >= 0 and "
                             "0 < base_delay_s <= max_delay_s")
        if straggle_threshold <= 1.0:
            raise ValueError("straggle_threshold must be > 1")
        if not 0.0 < ewma_alpha <= 1.0:
            raise ValueError("ewma_alpha must be in (0, 1]")
        self.inner = inner
        self.name = f"failover({inner.name})"
        # routing is delegated, so the wrapper's information model (and
        # hence pool-runner eligibility) is exactly the inner policy's;
        # retry_floor_s mirrors the first backoff rung for the engine's
        # cross-shard lookahead
        self.fleet_reads = inner.fleet_reads
        self.retry_floor_s = base_delay_s
        self.max_retries = max_retries
        self.base_delay_s = base_delay_s
        self.max_delay_s = max_delay_s
        self.abandon_after_s = abandon_after_s
        self.rerun = rerun
        self.straggle_threshold = straggle_threshold
        self.min_observations = min_observations
        self.drain_cooldown_s = drain_cooldown_s
        self.ewma_alpha = ewma_alpha
        self._stretch: dict[int, tuple[int, float]] = {}  # nid -> (n, ewma)
        self._drained: dict[int, float] = {}              # nid -> drained_at
        self._undrain_now: set[int] = set()
        self._telemetry = None

    # simulate_cluster assigns `policy.telemetry` per run; forward it so
    # the wrapped policy's own hooks (e.g. prediction-error gauges) fire
    @property
    def telemetry(self):
        return self._telemetry

    @telemetry.setter
    def telemetry(self, value):
        self._telemetry = value
        self.inner.telemetry = value

    def attach(self, nodes, trace, zeta):
        self.inner.attach(nodes, trace, zeta)
        self._stretch = {}
        self._drained = {}
        self._undrain_now = set()

    def select(self, req, nodes, now):
        return self.inner.select(req, nodes, now)

    def observe_completion(self, record, now):
        self.inner.observe_completion(record, now)
        if record.isolated_runtime_s > 0:
            stretch = ((record.finish_s - record.start_s)
                       / record.isolated_runtime_s)
            n, ew = self._stretch.get(record.node_id, (0, 0.0))
            ew = (stretch if n == 0
                  else (1.0 - self.ewma_alpha) * ew
                  + self.ewma_alpha * stretch)
            self._stretch[record.node_id] = (n + 1, ew)

    def retry_delay(self, req, attempts, now):
        if (self.abandon_after_s is not None
                and now - req.arrival_s >= self.abandon_after_s):
            return None   # deadline-aware abandon: too old to keep trying
        if attempts >= self.max_retries:
            return None
        return min(self.base_delay_s * (2.0 ** attempts), self.max_delay_s)

    def allow_rerun(self, req, now):
        return self.rerun

    def on_fault(self, event, nodes, now):
        if event.kind in (RECOVER, NORMAL):
            # the disruption this node was drained (or suspect) for is
            # over: fresh slate, and un-drain at the next governance poll
            self._stretch.pop(event.node_id, None)
            if event.node_id in self._drained:
                self._undrain_now.add(event.node_id)

    def drain_updates(self, nodes, now):
        updates: list[tuple[int, bool]] = []
        for nid in sorted(self._drained):
            if (nid in self._undrain_now
                    or now - self._drained[nid] >= self.drain_cooldown_s):
                del self._drained[nid]
                self._undrain_now.discard(nid)
                self._stretch.pop(nid, None)   # probe with a fresh EWMA
                updates.append((nid, False))
        seasoned = {nid: ew for nid, (n, ew) in self._stretch.items()
                    if n >= self.min_observations}
        if len(seasoned) >= 2:
            med = float(np.median(list(seasoned.values())))
            if med > 0:
                for node in nodes:
                    nid = node.node_id
                    ew = seasoned.get(nid)
                    if (ew is None or nid in self._drained
                            or not node.accepting):
                        continue
                    if ew > self.straggle_threshold * med:
                        peers = [n for n in nodes
                                 if n.model_name == node.model_name
                                 and n.accepting and n.node_id != nid]
                        if peers:   # never drain the last replica standing
                            self._drained[nid] = now
                            updates.append((nid, True))
        return updates or None


class FailureAwareOraclePolicy(OfflineOraclePolicy):
    """Offline oracle re-solved against the realized fault trace: the
    Eq. 2 per-query argmin restricted to models that remain *reachable*
    on that trace (``core.scheduler.schedule_with_liveness``).

    Liveness notions:

      * ``"ever_after"`` (default) — a model is excluded for a query only
        when every hosting node is down at the query's arrival *and never
        recovers* (``FaultTrace.down_forever_from``).  Any capacity an
        online policy could reach via retry/backoff stays priced in, so
        the oracle objective is a provable lower bound on every online
        policy's realized objective over the same trace — the bound the
        fig4 availability cell asserts.
      * ``"at_arrival"`` — stricter realism: excluded when every host is
        down at the arrival instant (no waiting for recovery).

    ``domains=`` switches the liveness matrix to *domain-masked
    capacity*: instead of a boolean per model, each entry counts the
    distinct fault domains with at least one reachable host — the
    integer-count form ``schedule_with_liveness`` masks at count 0.
    Under correlated faults a domain is the unit that dies, so surviving
    *domains*, not surviving nodes, are the capacity the plan may rely
    on; the masking itself is identical (a model with zero live domains
    has zero live nodes), but the counts are the quantity a
    survivability bound reasons about.

    At serving time the planned model's hosts may all be dead or draining
    (the plan only guards against *permanent* loss): routing then falls
    back over whatever accepts, and `allow_rerun` keeps refugees alive
    across models — the oracle never abandons recoverable work."""

    name = "failure_oracle"

    def __init__(self, faults: FaultTrace, *, liveness: str = "ever_after",
                 domains=None):
        super().__init__()
        if liveness not in ("ever_after", "at_arrival"):
            raise ValueError(f"unknown liveness {liveness!r}")
        self.faults = faults
        self.liveness = liveness
        groups = domain_groups(domains)
        self._dom_of = None if groups is None else domain_index(groups)

    def attach(self, nodes, trace, zeta):
        profiles = unique_profiles(nodes)
        registry = replica_registry(nodes)
        down = (self.faults.is_down if self.liveness == "at_arrival"
                else self.faults.down_forever_from)
        if self._dom_of is None:
            live = np.ones((len(trace), len(profiles)), dtype=bool)
            for i, r in enumerate(trace.requests):
                for j, p in enumerate(profiles):
                    live[i, j] = any(not down(nid, r.arrival_s)
                                     for nid in registry[p.name])
        else:
            dom_of = self._dom_of
            missing = [n.node_id for n in nodes
                       if n.node_id not in dom_of]
            if missing:
                raise ValueError(
                    f"nodes {missing} are in no fault domain — the "
                    f"topology must cover the fleet")
            live = np.zeros((len(trace), len(profiles)), dtype=np.int64)
            for i, r in enumerate(trace.requests):
                for j, p in enumerate(profiles):
                    live[i, j] = len({dom_of[nid]
                                      for nid in registry[p.name]
                                      if not down(nid, r.arrival_s)})
        asg = schedule_with_liveness(profiles, trace.queries(), zeta, live)
        self._model_of = {
            r.request_id: asg.model_names[int(k)]
            for r, k in zip(trace.requests, asg.assignee)}

    def allow_rerun(self, req, now):
        return True


def realized_cache_hits(records) -> dict[int, int]:
    """request_id → realized KV prefix-cache hit (warm tokens served) from
    a completed run's ``ClusterReport.records`` — the hit sequence the
    cache-aware oracle is conditioned on."""
    return {r.request_id: r.cached_tokens
            for r in records if r.cached_tokens > 0}


class CacheAwareOraclePolicy(OfflineOraclePolicy):
    """Offline oracle re-solved against a *realized* prefix-cache hit
    sequence: the Eq. 2 per-query argmin over cost columns discounted by
    each request's warm tokens (``core.scheduler.schedule_with_cache``).

    The hit sequence comes from an already-completed run
    (``realized_cache_hits(report.records)``) — the oracle is conditioned
    on the cache behavior the online fleet actually exhibited, not on a
    hypothetical best-case reuse.  Scoring the online assignment under
    the *same* discounted matrix (``objective_of_assignment`` with
    ``cached=``) makes the bound exact: the oracle's row-wise argmin is
    ≤ any realized column choice, so oracle ≤ online holds per run by
    construction — the inequality the fig4 ``--sessions`` cell asserts."""

    name = "cache_oracle"

    def __init__(self, cached: dict[int, int]):
        super().__init__()
        self.cached = dict(cached)

    def attach(self, nodes, trace, zeta):
        profiles = unique_profiles(nodes)
        if not len(trace):
            self._model_of = {}
            return
        cached_vec = np.array(
            [self.cached.get(r.request_id, 0) for r in trace.requests],
            dtype=np.int64)
        asg = schedule_with_cache(profiles, trace.queries(), zeta, cached_vec)
        self._model_of = {
            r.request_id: asg.model_names[int(k)]
            for r, k in zip(trace.requests, asg.assignee)}


# ---------------------------------------------------------------------------
# Preemption policies (consulted by the event loop at every arrival)
# ---------------------------------------------------------------------------


class PreemptionPolicy:
    """Base preemption policy: sees every arrival (after routing), may ask
    the routed node to cut its running decode segment.  The base class
    never preempts — installing it is behaviorally identical to running
    without a preempter."""

    name = "no_preemption"
    telemetry = None   # repro_torch.obs.Telemetry, set per-run by simulate_cluster

    def attach(self, nodes: Sequence, trace: ArrivalTrace, zeta: float) -> None:
        self.zeta = zeta

    def consider(self, req: TracedRequest, node, nodes: Sequence,
                 now: float) -> int | None:
        """Return the request_id of an active decode member to evict on
        `node` (the node `req` was just routed to), or None."""
        return None

    def observe_completion(self, record, now: float) -> None:
        """Causal completion feedback — same channel the routers get."""


class SLOPreemptionPolicy(_TauOutMixin, PreemptionPolicy):
    """Evict the lowest-ζ-value decode when a higher-value waiting request
    would miss its slowdown SLO.

    The freed slot goes to the *head* of the node's FIFO queue at the
    settle boundary, so that head — not necessarily the arrival that
    triggered the check — is the beneficiary the policy evaluates.
    Trigger: the routed node is mid-decode with a full batch (no slot
    until the segment boundary) and the boundary is further past the
    beneficiary's arrival than its SLO slack,
    `(slowdown_slo − 1) · r̂_iso` (its isolated runtime under the node's
    fitted profile).  Victim: the active member with the worst (highest)
    Eq. 2 per-query score on this node's model, among members with more
    than `min_remaining` decode steps left (a nearly-done decode frees
    its slot soon anyway — cutting it buys nothing).  The eviction only
    fires when the beneficiary's own score beats the victim's by at least
    `margin` — preemption trades the fleet's lowest-value work for
    higher-value work, never sideways.

    Scores use running ζ-normalizers fed by every arrival (the same
    causal normalization rule as zeta_online); `consider` is therefore
    called on every arrival even when no preemption can trigger.

    τout information model: the shared ``_TauOutMixin`` channel the
    routers use — without a `tau_out_predictor` the policy reads true
    output lengths (the paper's offline-knowledge assumption, matching
    the oracle-τout routers); with one, waiting requests are priced at
    the predicted quantile and in-flight victims at max(prediction,
    tokens already generated) — generated tokens are observable, a total
    length is not — learning only from the completions the event loop
    echoes through `observe_completion`."""

    name = "slo_preempt"

    def __init__(self, *, slowdown_slo: float = 3.0, min_remaining: int = 8,
                 margin: float = 0.0,
                 tau_out_predictor: TauOutPredictor | None = None):
        if slowdown_slo < 1.0:
            raise ValueError("slowdown_slo must be >= 1")
        if min_remaining < 0 or margin < 0:
            raise ValueError("min_remaining and margin must be >= 0")
        self.slowdown_slo = slowdown_slo
        self.min_remaining = min_remaining
        self.margin = margin
        self._init_predictor(tau_out_predictor)

    def attach(self, nodes, trace, zeta):
        super().attach(nodes, trace, zeta)
        self._profiles = unique_profiles(nodes)
        self._e_max = 0.0
        self._a_max = 0.0
        self._reset_predictor()

    def _waiting_query(self, req: TracedRequest, model: str):
        """(τin, τ̂out) of a not-yet-served request."""
        return (req.tau_in, self._tau_for(req, model))

    def _victim_query(self, member, model: str):
        """(τin, τ̂out) of an in-flight decode: its generated-token count
        is observed fact, so the estimate never undershoots it."""
        if self.predictor is None:
            return member.req.query
        return (member.req.tau_in,
                max(self.predictor.predict(model), float(member.generated)))

    def _fold(self, query) -> None:
        tin, tout = query
        for p in self._profiles:
            self._e_max = max(self._e_max, float(p.energy(tin, tout)))
            self._a_max = max(self._a_max, float(p.accuracy(tin, tout)))

    def _score(self, profile: LLMProfile, query) -> float:
        tin, tout = query
        return (self.zeta * float(profile.energy(tin, tout)) / self._e_max
                - (1.0 - self.zeta)
                * float(profile.accuracy(tin, tout)) / self._a_max)

    def consider(self, req, node, nodes, now):
        model = node.profile.name
        self._fold(self._waiting_query(req, model))  # every arrival feeds
        if (not node.in_decode or node.preempt_pending
                or len(node.active) < node.max_batch or not node.waiting):
            return None
        # the request the freed slot will actually admit: the FIFO head
        # (req itself when the queue was empty before this arrival)
        beneficiary = node.waiting[0]
        bq = self._waiting_query(beneficiary, model)
        r_iso = float(node.profile.runtime(*bq))
        wait_s = node.phase_end_s - beneficiary.arrival_s
        if wait_s <= (self.slowdown_slo - 1.0) * r_iso:
            return None    # the beneficiary makes its SLO by just queueing
        candidates = [m for m in node.active
                      if m.remaining > self.min_remaining]
        if not candidates:
            return None
        victim = max(
            candidates,
            key=lambda m: (self._score(node.profile,
                                       self._victim_query(m, model)),
                           m.req.request_id))
        if (self._score(node.profile, bq) + self.margin
                >= self._score(node.profile,
                               self._victim_query(victim, model))):
            return None    # the beneficiary is not worth more than the work
        return victim.req.request_id


DEFAULT_POLICIES = (
    RoundRobinPolicy,
    RandomPolicy,
    LeastLoadedPolicy,
    GreedyEnergyPolicy,
    ZetaOnlinePolicy,
)


def objective_of_assignment(
    profiles: Sequence[LLMProfile],
    queries: Sequence[tuple[int, int]],
    model_names: Sequence[str],
    zeta: float,
    *,
    cached: Sequence[int] | np.ndarray | None = None,
) -> float:
    """Eq. 2 value of an arbitrary (online) assignment, on the same
    normalization the offline scheduler uses — the yardstick for the
    offline→online gap.

    With ``cached=`` (a realized per-query warm-token sequence) the
    assignment is scored under the cache-discounted cost matrix
    (``core.scheduler.cached_costs``) — the same matrix the cache-aware
    oracle minimizes over, which is what makes oracle ≤ online exact."""
    if cached is None:
        costs = normalized_costs(profiles, queries)
    else:
        costs = cached_costs(profiles, queries, np.asarray(cached))
    C = objective_matrix(costs, zeta)
    col = {name: j for j, name in enumerate(costs.model_names)}
    idx = np.array([col[m] for m in model_names], dtype=int)
    return float(C[np.arange(len(queries)), idx].sum())
