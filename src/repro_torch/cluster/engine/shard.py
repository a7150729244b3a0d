"""Port copy of `repro.cluster.engine.shard`, numpy only, with its imports renamed;
tests/test_torch_cluster*.py hold it to the reference.

NodeShard: one node group's event heap and timer bookkeeping.

A shard owns a disjoint subset of the fleet and every *node-local* event
those nodes generate: phase segment ends, preemption and crash
settlements, wake/gate transition completions, idle timers.  The state
machines themselves stay in :class:`repro_torch.cluster.node.ClusterNode` —
what the shard takes over from the old monolithic loop is the timer
bookkeeping around them: mapping a node's event hint ``(EventKind,
end_s)`` to a scheduled :class:`~repro_torch.cluster.engine.events.Event`
(stamping the phase epoch for the guarded kinds), arming the
autoscaler's idle timers with the idle-stretch token, and keeping the
group's heap ordered by ``(time, seq)``.

Sequence numbers come from the fleet-wide
:class:`~repro_torch.cluster.engine.events.SeqAllocator` the runner hands
every shard, so the merged stream across shards is bit-identical to the
sequential loop whatever the partition.

Cross-node events (arrivals, faults, KV shipments, retries) never enter
a shard heap — they live in the runner's
:class:`~repro_torch.cluster.engine.mailbox.Mailbox`.
"""

from __future__ import annotations

import heapq
from typing import Sequence

from repro_torch.cluster.engine.events import (
    Event,
    EventKind,
    IdleToken,
    NodeRef,
    SeqAllocator,
)
from repro_torch.cluster.power import IDLE

_INF = float("inf")


class NodeShard:
    """One node group's heap plus its node-event bookkeeping."""

    __slots__ = ("index", "nodes", "by_id", "heap", "next_seq", "telemetry")

    def __init__(self, index: int, nodes: Sequence, next_seq: SeqAllocator):
        self.index = index
        self.nodes = list(nodes)
        self.by_id = {n.node_id: n for n in self.nodes}
        self.heap: list[tuple[float, int, Event]] = []
        self.next_seq = next_seq
        self.telemetry = None   # per-shard obs child (set by the runner)

    def __repr__(self) -> str:
        return (f"NodeShard({self.index}, "
                f"nodes={[n.node_id for n in self.nodes]}, "
                f"pending={len(self.heap)})")

    # --- scheduling ----------------------------------------------------
    def push(self, ev: Event) -> Event:
        heapq.heappush(self.heap, (ev.time, ev.seq, ev))
        return ev

    def push_node_event(self, node, hint) -> Event | None:
        """Schedule a node's event hint ``(EventKind, end_s)`` (or None).
        Guarded kinds get the node's phase epoch stamped at scheduling
        time; a later preemption or crash bumps the epoch and the stale
        event dies in the heap when popped."""
        if hint is None:
            return None
        kind, end_s = hint
        return self.push(Event(end_s, self.next_seq(), kind,
                               NodeRef(node.node_id, node.phase_epoch)))

    def arm_idle_timer(self, node, autoscaler, now: float) -> Event | None:
        """Ask the autoscaler whether (and when) to revisit an idle node.
        The timer carries the idle-epoch token so a node that served work
        and went idle again in between invalidates the stale timer."""
        if autoscaler is None or node.power_state != IDLE:
            return None
        t = autoscaler.on_idle(node, now)
        if t is None:
            return None
        return self.push(Event(t, self.next_seq(), EventKind.IDLE_TIMER,
                               IdleToken(node.node_id,
                                         node.power_state_since)))

    # --- consumption ---------------------------------------------------
    def peek_time(self) -> float:
        """Earliest pending local event's time (inf when drained)."""
        return self.heap[0][0] if self.heap else _INF

    def peek_key(self) -> tuple[float, int]:
        """Earliest pending local event's (time, seq) order key."""
        h = self.heap
        return (h[0][0], h[0][1]) if h else (_INF, -1)

    def pop(self) -> Event:
        return heapq.heappop(self.heap)[2]
