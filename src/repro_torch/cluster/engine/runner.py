"""Port copy of `repro.cluster.engine.runner`, numpy only, with its imports renamed;
tests/test_torch_cluster*.py hold it to the reference.

The Runner: shards, barriers, and the deterministic merge.

The engine advances a partitioned fleet through three execution modes,
all built from the same typed parts (events / shard heaps / mailbox):

* **merge** (the default, exact for every configuration): one fleet-wide
  ``(time, seq)`` order is maintained by always consuming the globally
  least key across the mailbox and every shard heap.  Because sequence
  numbers come from one fleet-wide :class:`SeqAllocator` drawn in
  handler order — the same order the old monolithic loop drew them in —
  the merged stream is bit-identical to the sequential loop *by
  construction*, whatever the partition.  Shard count never changes the
  event stream, the seven-bucket energy partition, or the ClusterReport.

* **windowed** (decomposable configurations): between consecutive
  mailbox deliveries (barriers), every shard drains its *local* events
  independently — no cross-heap peeking — up to the conservative
  horizon ``min(next mailbox key, barrier + cross_shard_floor_s(...))``.
  The floor is the minimum latency any cross-shard effect needs to
  propagate (KV ship time, retry backoff floor, wake ramp), so nothing
  a shard does inside the window can influence a peer before the next
  barrier.  Completions observed mid-window are *deferred* and replayed
  to the policy/preempter at the barrier in merged
  ``(finish, node, order)`` order — a partition-invariant order, so the
  report is identical for every partition (and identical to merge mode
  up to the ordering of completions landing at the exact same float
  instant on different nodes — the differential tests pin equality on
  the seeded traces).  Requires a decomposable configuration: no
  autoscaler (idle-gating reads fleet-wide awake counts between
  barriers), no fault trace (rescue re-routes mid-window), no telemetry
  (trace stamps encode the merge order).

* **windowed + workers** (process-pool): the windowed barrier protocol
  over ``multiprocessing`` fork workers, each owning its shard's node
  state machines for the whole run.  The parent owns the policy, the
  arrival trace and the record books, and routes over lightweight
  per-node views (load / power rank / accepting) refreshed at each
  barrier — so it additionally requires a policy that declares its
  fleet reads are view-expressible (``policy.fleet_reads`` in
  ``{"none", "counts"}``).  Worker nodes are finalized in-place and
  reduced to NodeStats; the caller's node objects keep their pre-run
  state (the report is the product).  With ``workers="auto"`` the pool
  sizes to ``min(shards, cpu_count)`` and degrades to the inline
  windowed loop when that is 1 — same barriers, same report.

Observability attaches **per shard** when ``obs_mode="sharded"``: each
shard gets a child Telemetry (own registry, own stamped tracer), fleet-
scoped hooks go to a fleet child, and at finalize the children fold into
the caller's Telemetry through the associative reductions
(:meth:`MetricsRegistry.merge` and the stamp-ordered
:meth:`EventTracer.absorb`) — byte-identical Prometheus text and Chrome
trace to the fused single-registry run.  ``obs_mode="fused"`` (the
facade default) reports into the one caller-supplied Telemetry exactly
as the monolithic loop did.
"""

from __future__ import annotations

import dataclasses
import heapq
import os
from typing import Callable, Sequence

from repro_torch.cluster.engine.events import (
    Event,
    EventKind,
    Retry,
    SeqAllocator,
    Shipment,
)
from repro_torch.cluster.engine.mailbox import Mailbox
from repro_torch.cluster.engine.shard import NodeShard
from repro_torch.cluster.faults import CRASH, RECOVER, SLOW, FaultTrace
from repro_torch.cluster.metrics import (
    AbandonedRecord,
    ClusterReport,
    RequestRecord,
    per_node_stats,
)
from repro_torch.cluster.policies import (
    objective_of_assignment,
    replica_registry,
    unique_profiles,
)
from repro_torch.cluster.power import GATED, IDLE
from repro_torch.energy.costs import kv_bytes_per_token

_INF = float("inf")

_ARRIVAL = EventKind.ARRIVAL
_PHASE_END = EventKind.PHASE_END
_WAKE_END = EventKind.WAKE_END
_GATE_END = EventKind.GATE_END
_IDLE_TIMER = EventKind.IDLE_TIMER
_PREEMPT_END = EventKind.PREEMPT_END
_FAULT = EventKind.FAULT
_CRASH_END = EventKind.CRASH_END
_SHIP_END = EventKind.SHIP_END
_RETRY = EventKind.RETRY


def partition_nodes(nodes: Sequence, shard_count: int) -> list[list]:
    """Deterministic contiguous partition into `shard_count` balanced
    groups (first ``len % shard_count`` groups take the extra node).
    Any partition yields the same merge-mode stream; this one keeps
    co-declared replicas near each other for the windowed modes."""
    n = len(nodes)
    shard_count = max(1, min(int(shard_count), n))
    base, extra = divmod(n, shard_count)
    out, i = [], 0
    for s in range(shard_count):
        size = base + (1 if s < extra else 0)
        out.append(list(nodes[i:i + size]))
        i += size
    return out


def cross_shard_floor_s(nodes: Sequence, policy,
                        faults: FaultTrace | None = None) -> float:
    """Conservative lookahead: the minimum simulated latency any
    runtime-generated cross-shard effect needs before it can land on a
    peer shard.  Three channels exist, all fault-mode-only (arrivals and
    the fault trace itself are preloaded, so they are barriers, not
    lookahead): a KV shipment takes at least one token's bytes over the
    fastest interconnect, a routing retry waits out the policy's backoff
    floor, and a pre-wake takes the wake ramp.  Without a fault trace no
    cross-shard event is ever generated mid-window and the floor is
    infinite — windows run to the next preloaded barrier."""
    if faults is None:
        return _INF
    floor = getattr(policy, "retry_floor_s", 1.0)  # 2**0 backoff floor
    for n in nodes:
        accel = n.hardware.accel
        floor = min(floor, kv_bytes_per_token(n.sim.cfg) / accel.ici_bw)
        if n.power is not None:
            floor = min(floor, n.power.wake_s)
    return floor


class Runner:
    """One simulation run over a sharded fleet.

    Parameters mirror ``simulate_cluster`` plus the engine knobs:
    `shard_count` / `partition` (explicit list of node groups), `mode`
    ("merge" or "windowed"), `workers` (windowed only: int or "auto"),
    `obs_mode` ("fused" or "sharded"), and `stream` — an optional
    callable receiving every consumed :class:`Event` in merge order
    (the event-stream equivalence gates feed it ``list.append`` and
    compare ``describe()`` lines)."""

    def __init__(self, trace, nodes: Sequence, policy, *,
                 zeta: float = 0.5, autoscaler=None, preempter=None,
                 faults: FaultTrace | None = None, telemetry=None,
                 shard_count: int = 1,
                 partition: Sequence[Sequence] | None = None,
                 mode: str = "merge", workers: int | str | None = None,
                 obs_mode: str = "fused",
                 stream: Callable[[Event], None] | None = None):
        if not nodes:
            raise ValueError("need at least one node")
        self.nodes = list(nodes)
        self.by_id = {n.node_id: n for n in self.nodes}
        if len(self.by_id) != len(self.nodes):
            raise ValueError("node_ids must be unique")
        if mode not in ("merge", "windowed"):
            raise ValueError(f"unknown mode {mode!r}")
        if obs_mode not in ("fused", "sharded"):
            raise ValueError(f"unknown obs_mode {obs_mode!r}")
        self.trace = trace
        self.policy = policy
        self.zeta = zeta
        self.autoscaler = autoscaler
        self.preempter = preempter
        self.faults = faults
        self.telemetry = telemetry
        self.mode = mode
        self.obs_mode = obs_mode
        self.stream = stream
        if partition is not None:
            groups = [list(g) for g in partition if len(g)]
            flat = [n.node_id for g in groups for n in g]
            if sorted(flat) != sorted(self.by_id):
                raise ValueError(
                    "partition must cover every node exactly once")
        else:
            groups = partition_nodes(self.nodes, shard_count)
        self.next_seq = SeqAllocator()
        self.shards = [NodeShard(i, g, self.next_seq)
                       for i, g in enumerate(groups)]
        self.shard_of = {n.node_id: sh
                         for sh in self.shards for n in sh.nodes}
        self.mailbox = Mailbox()
        if workers == "auto":
            workers = min(len(self.shards), os.cpu_count() or 1)
        self.workers = int(workers) if workers is not None else 1
        if mode == "windowed":
            self._check_decomposable()

    # ------------------------------------------------------------------
    def _check_decomposable(self) -> None:
        """Windowed execution requires a configuration whose only
        cross-shard couplings are the preloaded barriers."""
        why = None
        if self.autoscaler is not None:
            why = ("autoscaler gating reads fleet-wide awake counts "
                   "between barriers")
        elif self.faults is not None:
            why = "fault rescue re-routes across shards mid-window"
        elif self.telemetry is not None:
            why = "telemetry trace stamps encode the merge order"
        if why is None and self.workers > 1:
            if self.preempter is not None:
                why = "a preempter reads live fleet state at barriers"
            elif getattr(self.policy, "fleet_reads", "full") not in (
                    "none", "counts"):
                why = (f"policy {self.policy.name!r} does not declare "
                       f"view-expressible fleet reads "
                       f"(fleet_reads='none'|'counts')")
        if why is not None:
            raise ValueError(f"windowed mode unsupported here: {why} — "
                             f"use mode='merge' (exact for every "
                             f"configuration)")

    # ------------------------------------------------------------------
    def run(self) -> ClusterReport:
        if self.mode == "windowed" and self.workers > 1:
            return self._execute(pooled=True)
        return self._execute(pooled=False)

    # ------------------------------------------------------------------
    # The single entry point for merge / windowed-inline / pooled: shared
    # setup + bookkeeping closures (a faithful port of the monolithic
    # loop's, drawing seqs in the same handler order), then the
    # mode-specific consumption loop.
    def _execute(self, *, pooled: bool) -> ClusterReport:
        trace, nodes, policy = self.trace, self.nodes, self.policy
        by_id, zeta = self.by_id, self.zeta
        autoscaler, preempter = self.autoscaler, self.preempter
        faults, telemetry = self.faults, self.telemetry
        shards, shard_of, mailbox = self.shards, self.shard_of, self.mailbox
        next_seq = self.next_seq

        replicas = replica_registry(nodes)
        policy.attach(nodes, trace, zeta)
        if autoscaler is not None:
            autoscaler.attach(nodes)
        if preempter is not None:
            preempter.attach(nodes, trace, zeta)

        # --- observability wiring (fused = the monolith's single object;
        # sharded = per-shard children folded at finalize) --------------
        node_tel: dict[int, object] | None = None
        fleet_tel = None
        obs_children: list = []
        sharded_obs = telemetry is not None and self.obs_mode == "sharded"
        if sharded_obs:
            from repro_torch.obs.metrics import MetricsRegistry
            from repro_torch.obs.telemetry import Telemetry
            from repro_torch.obs.tracing import EventTracer
            stamp = SeqAllocator()   # global append-order stamp
            node_tel = {}

            def _child(with_tracer: bool):
                tr = None
                if telemetry.tracer is not None and with_tracer:
                    tr = EventTracer(telemetry.tracer.max_events)
                    tr.stamp_source = stamp
                return Telemetry(registry=MetricsRegistry(), tracer=tr,
                                 auditor=telemetry.auditor)

            for sh in shards:
                child = _child(True)
                child.attach(sh.nodes, policy, trace, zeta)
                sh.telemetry = child
                obs_children.append(child)
                for n in sh.nodes:
                    node_tel[n.node_id] = child
            # The fleet child attaches the *whole* node list: it owns the
            # cross-shard families (model-labeled request histograms via
            # on_completion, policy-labeled decision counters), and a
            # single writer in global event order keeps their float sums
            # bit-identical to the fused run.  Its per-node channels stay
            # at their attach-time zeros (node-scoped hooks go to the
            # owning shard's child), which merge exactly.
            fleet_tel = _child(True)
            fleet_tel.attach(nodes, policy, trace, zeta)
            obs_children.append(fleet_tel)
        elif telemetry is not None:
            node_tel = {n.node_id: telemetry for n in nodes}
            fleet_tel = telemetry
        # per-run observer references, set unconditionally so reused
        # nodes/policies never carry a stale one from a previous run
        for n in nodes:
            n.telemetry = node_tel[n.node_id] if node_tel else None
        policy.telemetry = fleet_tel
        if autoscaler is not None:
            autoscaler.telemetry = fleet_tel
        if preempter is not None:
            preempter.telemetry = fleet_tel
        if telemetry is not None and self.obs_mode == "fused":
            telemetry.attach(nodes, policy, trace, zeta)
        sample_every = (telemetry.sample_every_s
                        if telemetry is not None else None)
        next_sample = 0.0

        fault_mode = faults is not None
        for req in trace:   # preload: arrivals in trace order, then faults
            mailbox.post(Event(req.arrival_s, next_seq(), _ARRIVAL, req))
        if fault_mode:
            for fev in faults:
                if fev.node_id not in by_id:
                    raise ValueError(f"fault trace names unknown node "
                                     f"{fev.node_id}")
                mailbox.post(Event(fev.time_s, next_seq(), _FAULT, fev))

        records: list[RequestRecord] = []
        abandoned: list[AbandonedRecord] = []
        makespan = trace.duration_s
        state = {"makespan": makespan, "arrivals_left": len(trace)}

        # --- rescue orchestration (fault runs only) --------------------
        def fallback_node(eligible):
            return min(eligible,
                       key=lambda n: (n.load(), n.power_rank, n.node_id))

        def abandon_request(req, now, reason, attempts, *,
                            member=None, model=""):
            wasted = 0.0
            if member is not None:
                for w_nid, e in sorted(member.energy_on.items()):
                    by_id[w_nid].book_waste(e)
                    wasted += e
                member.energy_on.clear()
            rec = AbandonedRecord(
                request_id=req.request_id, model=model,
                tau_in=req.tau_in, tau_out=req.tau_out,
                arrival_s=req.arrival_s, abandoned_s=now, reason=reason,
                attempts=attempts, wasted_j=wasted)
            abandoned.append(rec)
            state["makespan"] = max(state["makespan"], now)
            if fleet_tel is not None:
                fleet_tel.on_abandon(rec, now)

        def schedule_retry(req, attempts, now):
            delay = policy.retry_delay(req, attempts, now)
            if delay is None:
                abandon_request(req, now, "no_capacity", attempts)
                return
            mailbox.post(Event(now + delay, next_seq(), _RETRY,
                               Retry(req, attempts + 1)), now=now)

        def route_or_retry(req, attempts, now):
            eligible = [n for n in nodes if n.accepting]
            if not eligible:
                schedule_retry(req, attempts, now)
                return
            nid = policy.select(req, eligible, now)
            node = by_id.get(nid)
            if node is None or not node.accepting:
                node = fallback_node(eligible)
            if node_tel is not None:
                node_tel[node.node_id].on_retry(req, node.node_id,
                                                attempts, now)
            shard_of[node.node_id].push_node_event(
                node, node.enqueue(req, now))

        def rerun_or_abandon(member, home, now, reason):
            if (policy.allow_rerun(member.req, now)
                    and any(n.accepting for n in nodes)):
                for w_nid, e in sorted(member.energy_on.items()):
                    by_id[w_nid].book_waste(e)
                member.energy_on.clear()
                route_or_retry(member.req, 0, now)
            else:
                abandon_request(member.req, now, reason, 0,
                                member=member, model=home.model_name)

        def dispatch_refugee(member, home, now):
            if member.prefill_done is not None:
                if member.ckpt_tokens >= member.req.tau_in:
                    member.prefill_done = None
                elif member.ckpt_tokens <= 0:
                    rerun_or_abandon(member, home, now, "prefill_lost")
                    return
            candidates = [n for n in nodes
                          if n.accepting and n.model_name == home.model_name
                          and n.node_id != home.node_id]
            if candidates:
                recipient = fallback_node(candidates)
                tokens = (member.ckpt_tokens
                          if member.prefill_done is not None
                          else member.context)
                n_bytes = tokens * kv_bytes_per_token(home.sim.cfg)
                ship_s = n_bytes / recipient.hardware.accel.ici_bw
                ship_j = n_bytes * recipient.hardware.accel.j_per_byte_ici
                recipient.book_shipping(ship_s, ship_j)
                member.shipped_bytes += n_bytes
                home.n_migrations_out += 1
                if node_tel is not None:
                    node_tel[recipient.node_id].on_migration(
                        home, recipient, tokens, n_bytes, ship_s, ship_j,
                        now)
                mailbox.post(Event(now + ship_s, next_seq(), _SHIP_END,
                                   Shipment(recipient.node_id, member)),
                             now=now)
            else:
                rerun_or_abandon(member, home, now, "no_survivor")

        def handle_failed(node, now):
            while node.suspended:
                dispatch_refugee(node.suspended.popleft(), node, now)
            while node.waiting:
                route_or_retry(node.waiting.popleft(), 0, now)

        def apply_drains(now):
            updates = policy.drain_updates(nodes, now)
            if not updates:
                return
            for d_nid, drain in updates:
                dnode = by_id[d_nid]
                if drain and not dnode.draining and not dnode.failed:
                    dnode.draining = True
                    if node_tel is not None:
                        node_tel[d_nid].on_drain(dnode, True, now)
                    while dnode.suspended:
                        dispatch_refugee(dnode.suspended.popleft(), dnode,
                                         now)
                    while dnode.waiting:
                        route_or_retry(dnode.waiting.popleft(), 0, now)
                elif not drain and dnode.draining:
                    dnode.draining = False
                    if node_tel is not None:
                        node_tel[d_nid].on_drain(dnode, False, now)

        # correlated-kill aggregation: crash events sharing one timestamp
        # are one domain outage
        kill_batch = [None, 0]

        def flush_kill_batch():
            if kill_batch[0] is not None and fleet_tel is not None:
                fleet_tel.on_domain_outage(kill_batch[0], kill_batch[1])
            kill_batch[0], kill_batch[1] = None, 0

        def complete(node, c, now):
            """Book one finished request and echo it to the observers."""
            state["makespan"] = max(state["makespan"], c.finish_s)
            rec = RequestRecord(
                request_id=c.req.request_id,
                node_id=node.node_id,
                model=node.model_name,
                tau_in=c.req.tau_in,
                tau_out=c.req.tau_out,
                arrival_s=c.req.arrival_s,
                start_s=c.start_s,
                finish_s=c.finish_s,
                energy_j=c.energy_j,
                isolated_runtime_s=c.isolated_runtime_s,
                preemptions=c.preemptions,
                migrations=c.migrations,
                shipped_bytes=c.shipped_bytes,
                cached_tokens=c.cached_tokens,
            )
            records.append(rec)
            return rec

        def observe(rec, now):
            policy.observe_completion(rec, now)
            if autoscaler is not None:
                autoscaler.on_completion(rec, now)
            if preempter is not None:
                preempter.observe_completion(rec, now)
            if fleet_tel is not None:
                # completion writes the model-labeled request histograms
                # (shared across shards) — single fleet-child writer in
                # global event order keeps their sums bit-identical
                fleet_tel.on_completion(rec, now)

        def handle_arrival(req, now):
            state["arrivals_left"] -= 1
            if autoscaler is not None:
                prewoken = 0
                for nid in autoscaler.on_arrival(req, nodes, now):
                    node = by_id[nid]
                    if node.power_state == GATED:   # proactive pre-wake
                        shard_of[nid].push_node_event(
                            node, (_WAKE_END, node.begin_wake(now)))
                        prewoken += 1
                if fleet_tel is not None:
                    fleet_tel.on_prewake(autoscaler.name, prewoken)
            if fault_mode:
                eligible = [n for n in nodes if n.accepting]
                if not eligible:   # whole fleet down/draining: back off
                    schedule_retry(req, 0, now)
                    return
                nid = policy.select(req, eligible, now)
                node = by_id.get(nid)
                if node is None or not node.accepting:
                    node = fallback_node(eligible)
                    nid = node.node_id
            else:
                nid = policy.select(req, nodes, now)
                if nid not in by_id:
                    raise ValueError(
                        f"{policy.name} routed to unknown node {nid}")
                node = by_id[nid]
            if node_tel is not None:
                node_tel[nid].on_arrival(req, policy.name, nid,
                                         node.model_name, now)
            shard_of[nid].push_node_event(node, node.enqueue(req, now))
            if preempter is not None:
                victim = preempter.consider(req, node, nodes, now)
                if fleet_tel is not None:
                    fleet_tel.on_preempt_decision(preempter.name,
                                                  victim is not None)
                if victim is not None:
                    shard_of[nid].push_node_event(
                        node, node.preempt_decode(victim, now))

        def handle_event(ev, now):
            """The merge-order handler for every non-arrival kind — a
            faithful port of the monolithic loop's dispatch (seqs are
            drawn at the same sites in the same order)."""
            kind = ev.kind
            if kind is _PHASE_END:
                ref = ev.payload
                node = by_id[ref.node_id]
                if ref.epoch != node.phase_epoch:
                    return   # preempted; this end never happened
                completions, next_ev = node.on_phase_end(now)
                for c in completions:
                    observe(complete(node, c, now), now)
                sh = shard_of[ref.node_id]
                sh.push_node_event(node, next_ev)
                if next_ev is None:
                    if fault_mode and node.failed:
                        handle_failed(node, now)
                    else:
                        sh.arm_idle_timer(node, autoscaler, now)
                if fault_mode and completions:
                    apply_drains(now)
            elif kind is _PREEMPT_END:
                ref = ev.payload
                node = by_id[ref.node_id]
                if ref.epoch != node.phase_epoch:
                    return   # a crash got there first
                next_ev = node.on_preempt_end(now)
                sh = shard_of[ref.node_id]
                sh.push_node_event(node, next_ev)
                if next_ev is None:
                    if fault_mode and node.failed:
                        handle_failed(node, now)
                    else:
                        sh.arm_idle_timer(node, autoscaler, now)
            elif kind is _WAKE_END:
                ref = ev.payload
                node = by_id[ref.node_id]
                if ref.epoch != node.phase_epoch:
                    return   # node crashed mid-wake
                next_ev = node.on_wake_end(now)
                sh = shard_of[ref.node_id]
                sh.push_node_event(node, next_ev)
                if next_ev is None:   # pre-woken with nothing to do (yet)
                    sh.arm_idle_timer(node, autoscaler, now)
            elif kind is _GATE_END:
                ref = ev.payload
                node = by_id[ref.node_id]
                if ref.epoch != node.phase_epoch:
                    return   # node crashed mid-gate
                shard_of[ref.node_id].push_node_event(
                    node, node.on_gate_end(now))
            elif kind is _FAULT:
                fev = ev.payload
                node = by_id[fev.node_id]
                if node_tel is not None:
                    node_tel[fev.node_id].on_fault(fev, node, now)
                if fev.kind == CRASH:
                    if kill_batch[0] is not None and kill_batch[0] != now:
                        flush_kill_batch()
                    kill_batch[0] = now
                    kill_batch[1] += 1
                    crash_ev = node.begin_crash(now)
                    if crash_ev is not None:
                        shard_of[fev.node_id].push_node_event(node,
                                                              crash_ev)
                    elif node.failed:   # off-phase: crashed right here
                        handle_failed(node, now)
                elif fev.kind == RECOVER:
                    if node.failed:
                        next_ev = node.recover(now)
                        sh = shard_of[fev.node_id]
                        sh.push_node_event(node, next_ev)
                        if next_ev is None:
                            sh.arm_idle_timer(node, autoscaler, now)
                    elif node.crash_pending:
                        # re-deliver the recovery at the settle instant
                        mailbox.post(Event(
                            node.phase_end_s, next_seq(), _FAULT,
                            dataclasses.replace(
                                fev, time_s=node.phase_end_s)), now=now)
                elif fev.kind == SLOW:
                    node.slowdown = fev.value
                else:   # NORMAL: straggler episode over
                    node.slowdown = 1.0
                policy.on_fault(fev, nodes, now)
            elif kind is _CRASH_END:
                ref = ev.payload
                node = by_id[ref.node_id]
                if ref.epoch != node.phase_epoch:
                    return
                node.on_crash_settle(now)
                handle_failed(node, now)
            elif kind is _SHIP_END:
                ship = ev.payload
                node = by_id[ship.node_id]
                if not node.accepting:
                    # recipient died/drained while the KV was in flight
                    dispatch_refugee(ship.member, node, now)
                else:
                    shard_of[ship.node_id].push_node_event(
                        node, node.receive_migrant(ship.member, now))
            elif kind is _RETRY:
                route_or_retry(ev.payload.req, ev.payload.attempts, now)
            else:   # _IDLE_TIMER
                tok = ev.payload
                node = by_id[tok.node_id]
                if (node.power_state == IDLE
                        and node.power_state_since == tok.since
                        and node.can_gate
                        and autoscaler is not None):
                    gate = autoscaler.should_gate(node, now)
                    if fleet_tel is not None:
                        fleet_tel.on_gate_decision(autoscaler.name, gate)
                    sh = shard_of[tok.node_id]
                    if gate:
                        sh.push_node_event(node, node.begin_gate(now))
                    elif state["arrivals_left"] > 0:
                        # declined: re-check later (stops with the last
                        # arrival so the loop terminates)
                        sh.arm_idle_timer(node, autoscaler, now)

        # the fleet starts idle — armed in *fleet* order (not shard
        # order) so the initial timers draw the same sequence numbers as
        # the monolithic loop under any partition
        for n in nodes:
            shard_of[n.node_id].arm_idle_timer(n, autoscaler, 0.0)

        # --- consumption -----------------------------------------------
        if pooled:
            self._pooled_loop(observe, records, state)
        elif self.mode == "windowed":
            self._windowed_loop(handle_arrival, observe, records, state)
        else:
            stream = self.stream
            peekables = [mailbox] + shards
            while True:
                src = None
                best = (_INF, -1)
                for p in peekables:
                    k = p.peek_key()
                    if src is None or k < best:
                        best, src = k, p
                if best[1] < 0:
                    break   # every heap drained
                ev = src.pop()
                now = ev.time
                if stream is not None:
                    stream(ev)
                if sample_every is not None:
                    # sample fleet state as of the previous event,
                    # stamped on the period grid, before this one
                    # mutates it
                    while next_sample <= now:
                        if sharded_obs:
                            for n in nodes:   # fleet order, per-shard books
                                node_tel[n.node_id].sample([n], next_sample)
                        else:
                            telemetry.sample(nodes, next_sample)
                        next_sample += sample_every
                if ev.kind is _ARRIVAL:
                    handle_arrival(ev.payload, now)
                else:
                    handle_event(ev, now)

        flush_kill_batch()

        # --- settlement ------------------------------------------------
        makespan = state["makespan"]
        if pooled:
            node_stats, suspended_left = self._pool_finish(makespan)
            if suspended_left:
                raise RuntimeError(
                    "preempted requests left suspended at the end of the "
                    "trace — resume/rescue logic bug")
        else:
            if any(n.suspended for n in nodes):
                raise RuntimeError(
                    "preempted requests left suspended at the end of the "
                    "trace — resume/rescue logic bug")
            for n in nodes:   # close the books at the common horizon
                n.finalize(makespan)
            node_stats = per_node_stats(nodes, makespan)
        if len(records) + len(abandoned) != len(trace):
            raise RuntimeError(
                f"served {len(records)} + abandoned {len(abandoned)} != "
                f"{len(trace)} requests — event loop bug")
        records.sort(key=lambda r: r.request_id)
        abandoned.sort(key=lambda r: r.request_id)

        profiles = unique_profiles(nodes)
        queries = (trace.queries() if not abandoned
                   else [(r.tau_in, r.tau_out) for r in records])
        assigned = [r.model for r in records]
        objective = (objective_of_assignment(profiles, queries, assigned,
                                             zeta)
                     if records else 0.0)
        prof_of = {p.name: p for p in profiles}
        predicted = sum(float(prof_of[r.model].energy(r.tau_in, r.tau_out))
                        for r in records)

        report = ClusterReport(
            policy=policy.name,
            zeta=zeta,
            records=tuple(records),
            node_stats=node_stats,
            makespan_s=makespan,
            objective=objective,
            predicted_energy_j=predicted,
            replicas=tuple((name, tuple(nids))
                           for name, nids in replicas.items()),
            abandoned=tuple(abandoned),
        )
        if telemetry is not None:
            if obs_children:
                fleet_tel.finalize(nodes, report)
                for child in obs_children:
                    telemetry.registry.merge(child.registry)
                if telemetry.tracer is not None:
                    telemetry.tracer.absorb(
                        [c.tracer for c in obs_children
                         if c.tracer is not None])
            else:
                telemetry.finalize(nodes, report)
        return report

    # ------------------------------------------------------------------
    # Windowed mode (inline): barriers at mailbox deliveries; each shard
    # drains its local heap independently below the conservative horizon.
    def _windowed_loop(self, handle_arrival, observe, records,
                       state) -> None:
        mailbox, shards, by_id = self.mailbox, self.shards, self.by_id
        floor = cross_shard_floor_s(self.nodes, self.policy, self.faults)
        deferred: list[tuple[float, int, int, object]] = []

        def drain(sh: NodeShard, horizon: float) -> None:
            heap = sh.heap
            while heap and heap[0][0] < horizon:
                ev = heapq.heappop(heap)[2]
                ref = ev.payload
                node = by_id[ref.node_id]
                if ref.epoch != node.phase_epoch:
                    continue   # preempted: this end never happened
                now = ev.time
                if ev.kind is _PHASE_END:
                    completions, next_ev = node.on_phase_end(now)
                    for i, c in enumerate(completions):
                        rec = RequestRecord(
                            request_id=c.req.request_id,
                            node_id=node.node_id,
                            model=node.model_name,
                            tau_in=c.req.tau_in,
                            tau_out=c.req.tau_out,
                            arrival_s=c.req.arrival_s,
                            start_s=c.start_s,
                            finish_s=c.finish_s,
                            energy_j=c.energy_j,
                            isolated_runtime_s=c.isolated_runtime_s,
                            preemptions=c.preemptions,
                            migrations=c.migrations,
                            shipped_bytes=c.shipped_bytes,
                            cached_tokens=c.cached_tokens,
                        )
                        records.append(rec)
                        if c.finish_s > state["makespan"]:
                            state["makespan"] = c.finish_s
                        deferred.append((c.finish_s, node.node_id, i, rec))
                    sh.push_node_event(node, next_ev)
                elif ev.kind is _PREEMPT_END:
                    sh.push_node_event(node, node.on_preempt_end(now))
                else:   # pragma: no cover — decomposability precondition
                    raise AssertionError(
                        f"non-decomposable event {ev.kind.name} in a "
                        f"windowed shard")

        def flush() -> None:
            # replay completions to policy/preempter in a partition-
            # invariant merged order: (finish, node, intra-node order)
            if not deferred:
                return
            deferred.sort(key=lambda d: d[:3])
            for _, _, _, rec in deferred:
                observe(rec, rec.finish_s)
            deferred.clear()

        while len(mailbox):
            barrier = mailbox.peek_time()
            horizon = min(barrier, barrier + floor)   # floor is inf here
            for sh in shards:
                drain(sh, horizon)
            flush()
            ev = mailbox.pop()
            handle_arrival(ev.payload, ev.time)
        for sh in shards:
            drain(sh, _INF)
        flush()

    # ------------------------------------------------------------------
    # Pooled mode: the windowed barrier protocol with each shard's nodes
    # owned by a forked worker process for the whole run.
    def _pooled_loop(self, observe, records, state) -> None:
        import multiprocessing as mp
        try:
            ctx = mp.get_context("fork")
        except ValueError as exc:   # pragma: no cover — non-fork platform
            raise RuntimeError(
                "pooled windowed mode needs the fork start method; use "
                "workers=1") from exc
        policy, by_id, mailbox = self.policy, self.by_id, self.mailbox
        views = {n.node_id: _NodeView(n) for n in self.nodes}
        view_list = [views[n.node_id] for n in self.nodes]
        pool = []
        conn_of: dict[int, object] = {}
        for sh in self.shards:
            parent_conn, child_conn = ctx.Pipe()
            proc = ctx.Process(target=_shard_worker,
                               args=(child_conn, sh.nodes), daemon=True)
            proc.start()
            child_conn.close()
            pool.append((parent_conn, proc, sh))
            for n in sh.nodes:
                conn_of[n.node_id] = parent_conn
        self._pool = pool

        def apply_views(updates):
            for nid, load, rank, acc in updates:
                v = views[nid]
                v._load, v.power_rank, v.accepting = load, rank, acc

        deferred: list[tuple[float, int, int, object]] = []

        def drain_all(horizon: float) -> None:
            for conn, _, _ in pool:
                conn.send(("drain", horizon))
            for conn, _, _ in pool:
                recs, updates, mk = conn.recv()
                apply_views(updates)
                if mk > state["makespan"]:
                    state["makespan"] = mk
                for i, rec in enumerate(recs):
                    records.append(rec)
                    deferred.append((rec.finish_s, rec.node_id, i, rec))
            if deferred:
                deferred.sort(key=lambda d: d[:3])
                for _, _, _, rec in deferred:
                    observe(rec, rec.finish_s)
                deferred.clear()

        while len(mailbox):
            barrier = mailbox.peek_time()
            drain_all(barrier)
            ev = mailbox.pop()
            req, now = ev.payload, ev.time
            state["arrivals_left"] -= 1
            nid = policy.select(req, view_list, now)
            if nid not in by_id:
                raise ValueError(f"{policy.name} routed to unknown node "
                                 f"{nid}")
            conn = conn_of[nid]
            conn.send(("enqueue", nid, req, now))
            apply_views(conn.recv())
        drain_all(_INF)

    def _pool_finish(self, makespan: float):
        """Close every worker's books at the common horizon and fold the
        per-shard NodeStats back, in fleet node order."""
        stats_by_id, suspended = {}, False
        for conn, proc, _ in self._pool:
            conn.send(("finish", makespan))
            shard_stats, any_suspended = conn.recv()
            suspended = suspended or any_suspended
            for s in shard_stats:
                stats_by_id[s.node_id] = s
            conn.send(("exit",))
            conn.close()
            proc.join(timeout=30)
        return (tuple(stats_by_id[n.node_id] for n in self.nodes),
                suspended)


class _NodeView:
    """The parent-side routing view of a worker-owned node: static
    identity plus the dynamic counters a `fleet_reads="counts"` policy
    may consult (load, power rank, accepting)."""

    __slots__ = ("node_id", "model_name", "profile", "hardware",
                 "_load", "power_rank", "accepting")

    def __init__(self, node):
        self.node_id = node.node_id
        self.model_name = node.model_name
        self.profile = node.profile
        self.hardware = node.hardware
        self._load = node.load()
        self.power_rank = node.power_rank
        self.accepting = node.accepting

    def load(self) -> int:
        return self._load


def _shard_worker(conn, nodes) -> None:
    """Worker process body: owns one shard's node state machines,
    drains windows, applies barrier enqueues, finalizes in place."""
    by_id = {n.node_id: n for n in nodes}
    for n in nodes:
        n.telemetry = None
    shard = NodeShard(0, nodes, SeqAllocator())

    def view_updates():
        return [(n.node_id, n.load(), n.power_rank, n.accepting)
                for n in nodes]

    def drain(horizon):
        recs, makespan = [], 0.0
        heap = shard.heap
        while heap and heap[0][0] < horizon:
            ev = heapq.heappop(heap)[2]
            ref = ev.payload
            node = by_id[ref.node_id]
            if ref.epoch != node.phase_epoch:
                continue
            if ev.kind is _PHASE_END:
                completions, next_ev = node.on_phase_end(ev.time)
                for c in completions:
                    makespan = max(makespan, c.finish_s)
                    recs.append(RequestRecord(
                        request_id=c.req.request_id,
                        node_id=node.node_id,
                        model=node.model_name,
                        tau_in=c.req.tau_in,
                        tau_out=c.req.tau_out,
                        arrival_s=c.req.arrival_s,
                        start_s=c.start_s,
                        finish_s=c.finish_s,
                        energy_j=c.energy_j,
                        isolated_runtime_s=c.isolated_runtime_s,
                        preemptions=c.preemptions,
                        migrations=c.migrations,
                        shipped_bytes=c.shipped_bytes,
                        cached_tokens=c.cached_tokens,
                    ))
                shard.push_node_event(node, next_ev)
            else:   # pragma: no cover — decomposability precondition
                raise AssertionError(
                    f"non-decomposable event {ev.kind.name} in a pooled "
                    f"shard")
        return recs, makespan

    while True:
        msg = conn.recv()
        op = msg[0]
        if op == "drain":
            recs, mk = drain(msg[1])
            conn.send((recs, view_updates(), mk))
        elif op == "enqueue":
            _, nid, req, now = msg
            node = by_id[nid]
            shard.push_node_event(node, node.enqueue(req, now))
            conn.send(view_updates())
        elif op == "finish":
            makespan = msg[1]
            any_suspended = any(n.suspended for n in nodes)
            for n in nodes:
                n.finalize(makespan)
            conn.send((per_node_stats(nodes, makespan), any_suspended))
        else:   # "exit"
            conn.close()
            return
