"""Port copy of `repro.cluster.power`, numpy only, with its imports renamed;
tests/test_torch_cluster*.py hold it to the reference.

Node power management: power states, transition costs, autoscalers.

At low arrival rates the fig4 idle columns dominate total cluster energy —
no routing policy can recover joules burned by powered-but-idle replicas.
This module adds the missing lever: nodes can be *gated* (powered down to
a residual draw) and woken back, with configurable transition latency and
energy, under a pluggable autoscaling policy.

Power-state lifecycle (ClusterNode drives it, the event loop times it)::

            enqueue/phase            idle-timer + policy ok
      ACTIVE <────────> IDLE ──────────────────────────> GATING
        ^                ^                                  │ gate_s
        │ wake done      │ wake done (no work)              v
      (work waiting)     WAKING <──────────────────────── GATED
                              arrival routed here / proactive wake

    * ACTIVE  — serving a phase; busy seconds/joules (accelerator idle+
                dynamic plus host serving draw, as before).
    * IDLE    — powered, no work: idle_power_w (accel idle · n + host idle).
    * GATED   — powered down: `PowerConfig.gated_w` residual (BMC, NIC).
    * GATING / WAKING — transitions: `transition_w` draw (defaults to the
                idle power — fans spin, links train) for gate_s / wake_s
                seconds plus the fixed extras gate_j / wake_j.

    Every second of a node's horizon lands in exactly one bucket
    (busy/idle/gated/transition) — gated time is never double-charged as
    idle; `tests/test_power.py` and the perf-suite conservation gate
    assert the partition to 1e-9.

Autoscalers see three moments: `on_idle` (a node just ran out of work —
arm a gate timer?), `should_gate` (the timer fired and the node is still
idle — commit?), and `on_arrival` (wake gated nodes proactively?).  A
request routed to a gated node always triggers an on-demand wake — work
is never stranded, whatever the policy does.

Three built-in policies:

    * ReactiveIdlePolicy   — gate a node once it has sat idle for
      `idle_timeout_s`, keeping at least `min_awake` nodes up (and, with
      `min_awake_per_model`, at least that many awake replicas of every
      hosted model — a fleet-wide floor alone can gate a model's entire
      replica set); wakes are purely on demand (first routed request pays
      the wake latency).
    * PredictiveRatePolicy — estimates the arrival rate over a sliding
      window and the mean service time from observed completions, sizes
      the awake fleet to `rate · service / target_util`, wakes gated
      nodes *ahead* of need on arrivals and gates down below it.  The
      reactive/predictive split is exactly the tradeoff the §6.3-style
      case study needs: reactive saves more joules but pays wake latency
      on the first request of every burst.
    * ReplicaRatePolicy    — the multi-replica refinement: the sizing
      variable is each model's *replica count*, not the node count.
      Per-model demand (completion rate × mean service time, learned
      causally from completions) sizes that model's awake replica set;
      replicas of an under-provisioned model pre-wake on arrivals while
      an over-provisioned model's spares gate down, independently per
      model.
    * SurvivabilityAutoscalePolicy — ReplicaRatePolicy with an
      MTTF-conditioned availability floor: under the steady-state
      unavailability q = MTTR/(MTTF+MTTR) of one fault domain, keeping a
      model awake in d independent domains bounds P[every awake replica
      down at once] by q^d, so d = ceil(ln p_outage_max / ln q) domains
      are required to meet the outage-probability target — demand may
      size the replica set *up* from there, but gating never drops a
      model's awake capacity below d distinct domains.
"""

from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import Sequence

from repro_torch.cluster.faults import domain_groups, domain_index
from repro_torch.cluster.metrics import replica_registry

# power-state tags (kept as plain strings: cheap, printable, json-able)
ACTIVE = "active"
IDLE = "idle"
GATED = "gated"
GATING = "gating"
WAKING = "waking"
# a crashed node (repro_torch.cluster.faults): draws 0 W, serves nothing, and
# rejoins at IDLE on its recovery event.  Not an autoscaler state — a
# failed node is neither awake nor gateable, and `_awake` counting it
# would let the predictive policies size phantom capacity.
FAILED = "failed"


@dataclasses.dataclass(frozen=True)
class PowerConfig:
    """Transition costs and residual draw of a gateable node.

    Defaults are deliberately conservative for an A100-class server:
    ~15 s to bring the node back (power rails + model weights re-resident)
    against a 5 s ramp down, a 10 W gated residual, and transitions drawn
    at the node's idle power unless `transition_w` overrides it."""

    gated_w: float = 10.0          # residual draw while gated (BMC, NIC)
    wake_s: float = 15.0           # gated -> ready latency
    gate_s: float = 5.0            # idle -> gated latency
    wake_j: float = 0.0            # fixed extra energy per wake
    gate_j: float = 0.0            # fixed extra energy per gate-down
    transition_w: float | None = None   # draw during gate/wake (None = idle)

    def __post_init__(self):
        if min(self.gated_w, self.wake_s, self.gate_s,
               self.wake_j, self.gate_j) < 0:
            raise ValueError("PowerConfig fields must be non-negative")


class AutoscalePolicy:
    """Base autoscaler: never gates (the always-on fleet)."""

    name = "always_on"
    telemetry = None   # repro_torch.obs.Telemetry, set per-run by simulate_cluster

    def attach(self, nodes: Sequence) -> None:
        self.nodes = list(nodes)

    def on_idle(self, node, now: float) -> float | None:
        """Node just went idle.  Return an absolute time at which to
        re-check it for gating (an idle timer), or None to leave it up."""
        return None

    def should_gate(self, node, now: float) -> bool:
        """The idle timer fired and the node is still idle: commit?"""
        return False

    def on_arrival(self, req, nodes: Sequence, now: float) -> list[int]:
        """Node ids to wake proactively (before the request is routed)."""
        return []

    def on_completion(self, completion, now: float) -> None:
        """Observed a finished request (service-time feedback)."""

    # ------------------------------------------------------------------
    @staticmethod
    def _awake(nodes: Sequence) -> int:
        """Nodes currently up or on their way up (serving capacity that
        does not need a wake)."""
        return sum(1 for n in nodes if n.power_state in (ACTIVE, IDLE, WAKING))

    @staticmethod
    def _replicas(nodes: Sequence) -> dict[str, list]:
        """The shared replica registry (metrics.replica_registry — one
        grouping rule fleet-wide), resolved to live node objects."""
        by_id = {n.node_id: n for n in nodes}
        return {name: [by_id[i] for i in nids]
                for name, nids in replica_registry(nodes).items()}


class ReactiveIdlePolicy(AutoscalePolicy):
    """Gate after `idle_timeout_s` of idleness; wake on demand only.

    `min_awake` floors the fleet; `min_awake_per_model` floors every
    model's awake *replica set* — with replicated models the fleet floor
    alone can concentrate all awake capacity on one model and gate every
    replica of another, which the per-model floor forbids."""

    name = "reactive_idle"

    def __init__(self, idle_timeout_s: float = 30.0, *, min_awake: int = 1,
                 min_awake_per_model: int = 0):
        if idle_timeout_s < 0 or min_awake < 0 or min_awake_per_model < 0:
            raise ValueError("idle_timeout_s, min_awake and "
                             "min_awake_per_model must be >= 0")
        self.idle_timeout_s = idle_timeout_s
        self.min_awake = min_awake
        self.min_awake_per_model = min_awake_per_model

    def attach(self, nodes):
        super().attach(nodes)
        self._model_nodes = self._replicas(self.nodes)

    def on_idle(self, node, now):
        return now + self.idle_timeout_s

    def should_gate(self, node, now):
        if self._awake(self.nodes) <= self.min_awake:
            return False
        peers = self._model_nodes[node.profile.name]
        return self._awake(peers) > self.min_awake_per_model


class PredictiveRatePolicy(AutoscalePolicy):
    """Size the awake fleet from a sliding-window arrival-rate estimate.

    required ≈ ceil(rate · mean_service_s / target_util), clamped to
    [min_awake, fleet].  `mean_service_s` is learned from completions
    (queue-free service time, start→finish); until the first completion a
    `service_prior_s` seeds it.  Wakes happen ahead of routing on the
    arrival that pushes the estimate over capacity; gating goes through
    the same idle timer as the reactive policy but only below the
    requirement."""

    name = "predictive_rate"

    def __init__(self, window_s: float = 60.0, *, target_util: float = 0.6,
                 min_awake: int = 1, idle_timeout_s: float = 10.0,
                 service_prior_s: float = 2.0):
        if window_s <= 0 or not 0 < target_util <= 1:
            raise ValueError("window_s > 0 and target_util in (0, 1] required")
        self.window_s = window_s
        self.target_util = target_util
        self.min_awake = min_awake
        self.idle_timeout_s = idle_timeout_s
        self.service_prior_s = service_prior_s
        self._arrivals: deque[float] = deque()
        self._service_sum = 0.0
        self._service_n = 0

    def attach(self, nodes):
        super().attach(nodes)
        self._arrivals.clear()
        self._service_sum = 0.0
        self._service_n = 0

    # --- estimates ----------------------------------------------------
    def _rate(self, now: float) -> float:
        while self._arrivals and self._arrivals[0] < now - self.window_s:
            self._arrivals.popleft()
        span = min(self.window_s, max(now, 1e-9))
        return len(self._arrivals) / span

    def _service_s(self) -> float:
        if self._service_n == 0:
            return self.service_prior_s
        return self._service_sum / self._service_n

    def required_nodes(self, now: float) -> int:
        demand = self._rate(now) * self._service_s() / self.target_util
        return int(min(len(self.nodes),
                       max(self.min_awake, math.ceil(demand))))

    # --- hooks --------------------------------------------------------
    def on_arrival(self, req, nodes, now):
        self._arrivals.append(now)
        need = self.required_nodes(now)
        awake = self._awake(nodes)
        if awake >= need:
            return []
        gated = [n.node_id for n in nodes if n.power_state == GATED]
        return gated[:need - awake]

    def on_completion(self, completion, now):
        self._service_sum += completion.finish_s - completion.start_s
        self._service_n += 1

    def on_idle(self, node, now):
        return now + self.idle_timeout_s

    def should_gate(self, node, now):
        return self._awake(self.nodes) > self.required_nodes(now)


class ReplicaRatePolicy(AutoscalePolicy):
    """Per-model replica-count autoscaler: each model's awake replica set
    is sized from that model's own demand estimate.

    required_K ≈ ceil(rate_K · mean_service_K / target_util), clamped to
    [min_awake_per_model, |replicas of K|].  Both estimates are causal:
    rate_K counts completions of model K inside a sliding `window_s` (a
    router-agnostic proxy for the model's arrival share — the autoscaler
    sees arrivals *before* routing, so it cannot know their model), and
    mean_service_K averages observed start→finish times, seeded by
    `service_prior_s` until the first completion.  On every arrival the
    under-provisioned models pre-wake gated replicas; gating goes through
    the usual idle timer and commits only while the node's model is above
    its requirement.  This is the replica sizing rule: replica counts
    per model, not node counts, are the autoscaling variable."""

    name = "replica_rate"

    def __init__(self, window_s: float = 60.0, *, target_util: float = 0.6,
                 min_awake_per_model: int = 1, idle_timeout_s: float = 10.0,
                 service_prior_s: float = 2.0):
        if window_s <= 0 or not 0 < target_util <= 1:
            raise ValueError("window_s > 0 and target_util in (0, 1] required")
        if min_awake_per_model < 0 or idle_timeout_s < 0:
            raise ValueError("min_awake_per_model and idle_timeout_s "
                             "must be >= 0")
        self.window_s = window_s
        self.target_util = target_util
        self.min_awake_per_model = min_awake_per_model
        self.idle_timeout_s = idle_timeout_s
        self.service_prior_s = service_prior_s

    def attach(self, nodes):
        super().attach(nodes)
        self._model_nodes = self._replicas(self.nodes)
        self._completions: dict[str, deque] = {
            name: deque() for name in self._model_nodes}
        self._service_sum: dict[str, float] = dict.fromkeys(
            self._model_nodes, 0.0)
        self._service_n: dict[str, int] = dict.fromkeys(self._model_nodes, 0)

    # --- per-model estimates ------------------------------------------
    def _rate(self, model: str, now: float) -> float:
        dq = self._completions[model]
        while dq and dq[0] < now - self.window_s:
            dq.popleft()
        span = min(self.window_s, max(now, 1e-9))
        return len(dq) / span

    def _service_s(self, model: str) -> float:
        n = self._service_n[model]
        return (self._service_sum[model] / n) if n else self.service_prior_s

    def required_replicas(self, model: str, now: float) -> int:
        demand = self._rate(model, now) * self._service_s(model) / \
            self.target_util
        return int(min(len(self._model_nodes[model]),
                       max(self.min_awake_per_model, math.ceil(demand))))

    # --- hooks --------------------------------------------------------
    def on_arrival(self, req, nodes, now):
        wake: list[int] = []
        for model, peers in self._model_nodes.items():
            need = self.required_replicas(model, now)
            awake = self._awake(peers)
            if awake >= need:
                continue
            gated = [n.node_id for n in peers if n.power_state == GATED]
            wake.extend(gated[:need - awake])
        return wake

    def on_completion(self, completion, now):
        model = completion.model
        if model not in self._completions:   # unseen model: defensive
            return
        self._completions[model].append(now)
        self._service_sum[model] += completion.finish_s - completion.start_s
        self._service_n[model] += 1

    def on_idle(self, node, now):
        return now + self.idle_timeout_s

    def should_gate(self, node, now):
        model = node.profile.name
        return (self._awake(self._model_nodes[model])
                > self.required_replicas(model, now))


class SurvivabilityAutoscalePolicy(ReplicaRatePolicy):
    """MTTF-conditioned replica autoscaler: demand sizes the awake set
    up, but an availability floor stops gating from shrinking it below
    the outage-probability target.

    Each fault domain (rack/PDU leg; one node per domain when no
    topology is given) is down with steady-state probability
    q = MTTR/(MTTF+MTTR) — the classic alternating-renewal availability
    model `data.workloads.fault_trace` draws from.  Domains fail
    independently, so a model kept awake in d distinct domains is
    entirely dark with probability q^d; meeting
    P[all awake replicas down] <= p_outage_max therefore requires

        d  =  ceil( ln(p_outage_max) / ln(q) )

    awake domains (clamped to [1, domains hosting the model] — a target
    tighter than the fleet can express saturates at every domain).  The
    floor conditions *gating only*: `should_gate` refuses any gate-down
    that would leave the node's model awake in fewer than d distinct
    domains, and `on_arrival` pre-wakes gated replicas — emptiest
    domains first — whenever the floor is violated (e.g. after crashes
    took domains out).  Demand sizing (`required_replicas`) is inherited
    unchanged from ReplicaRatePolicy."""

    name = "survivability_rate"

    def __init__(self, mttf_s: float, mttr_s: float, *,
                 p_outage_max: float = 1e-3, domains=None,
                 window_s: float = 60.0, target_util: float = 0.6,
                 min_awake_per_model: int = 1, idle_timeout_s: float = 10.0,
                 service_prior_s: float = 2.0):
        super().__init__(window_s, target_util=target_util,
                         min_awake_per_model=min_awake_per_model,
                         idle_timeout_s=idle_timeout_s,
                         service_prior_s=service_prior_s)
        if mttf_s <= 0 or mttr_s <= 0:
            raise ValueError("mttf_s and mttr_s must be > 0")
        if not 0.0 < p_outage_max < 1.0:
            raise ValueError("p_outage_max must be in (0, 1)")
        self.mttf_s = mttf_s
        self.mttr_s = mttr_s
        self.p_outage_max = p_outage_max
        self.unavailability = q = mttr_s / (mttf_s + mttr_s)
        self.required_domains = max(
            1, math.ceil(math.log(p_outage_max) / math.log(q)))
        groups = domain_groups(domains)
        self._dom_of = None if groups is None else domain_index(groups)

    def attach(self, nodes):
        super().attach(nodes)
        if self._dom_of is None:   # degenerate: every node its own domain
            self._dom_of = {n.node_id: n.node_id for n in self.nodes}
        missing = [n.node_id for n in self.nodes
                   if n.node_id not in self._dom_of]
        if missing:
            raise ValueError(
                f"nodes {missing} are in no fault domain — the topology "
                f"must cover the fleet")

    def _awake_domains(self, peers, *, excluding=None) -> set:
        return {self._dom_of[n.node_id] for n in peers
                if n is not excluding
                and n.power_state in (ACTIVE, IDLE, WAKING)}

    def required_awake_domains(self, model: str) -> int:
        hosted = {self._dom_of[n.node_id]
                  for n in self._model_nodes[model]}
        return min(self.required_domains, len(hosted))

    # --- hooks --------------------------------------------------------
    def on_arrival(self, req, nodes, now):
        wake = super().on_arrival(req, nodes, now)
        waking = set(wake)
        for model, peers in self._model_nodes.items():
            have = self._awake_domains(peers)
            have |= {self._dom_of[nid] for nid in waking
                     if any(n.node_id == nid for n in peers)}
            deficit = self.required_awake_domains(model) - len(have)
            if deficit <= 0:
                continue
            gated = sorted(
                (n for n in peers if n.power_state == GATED
                 and self._dom_of[n.node_id] not in have
                 and n.node_id not in waking),
                key=lambda n: (self._dom_of[n.node_id], n.node_id))
            picked: set = set()
            for n in gated:
                d = self._dom_of[n.node_id]
                if d in picked:
                    continue   # one wake per dark domain is enough
                wake.append(n.node_id)
                waking.add(n.node_id)
                picked.add(d)
                if len(picked) >= deficit:
                    break
        return wake

    def should_gate(self, node, now):
        if not super().should_gate(node, now):
            return False
        peers = self._model_nodes[node.profile.name]
        remaining = self._awake_domains(peers, excluding=node)
        return len(remaining) >= self.required_awake_domains(
            node.profile.name)
