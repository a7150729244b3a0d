"""Port copy of `repro.cluster.engine.events`, numpy only, with its imports renamed;
tests/test_torch_cluster*.py hold it to the reference.

Typed event core of the cluster engine.

The monolithic loop in ``cluster/sim.py`` drove the simulation with ten
magic int codes (``range(10)``) and raw ``(time, seq, kind, payload)``
heap tuples whose payload shape depended on the kind — a ``(nid, epoch)``
pair here, a bare request there.  This module replaces both with a typed
surface shared by every engine layer:

* :class:`EventKind` — an ``IntEnum`` of the ten kinds.  The numeric
  values are the historical codes, so an event stream printed from the
  engine is directly comparable against any stream captured from the old
  loop.  ``EventKind.epoch_guarded`` names the kinds whose payload
  carries the scheduling-time phase epoch (a preemption or crash bumps
  the node's epoch, so a stale event still sitting in a heap is
  recognized and dropped when popped — the only event-invalidation path
  in the engine).
* Payload dataclasses — one shape per kind family (:class:`NodeRef`,
  :class:`IdleToken`, :class:`Shipment`, :class:`Retry`; arrivals carry
  the traced request itself and fault events the ``FaultEvent`` from the
  fault trace, both already typed).
* :class:`Event` — the scheduled unit: ``(time, seq, kind, payload)``
  with a total order on ``(time, seq)``.  The sequence number is issued
  by one fleet-wide counter (:class:`SeqAllocator`) whatever shard the
  event lives on, which is what makes the sharded engine's merged stream
  bit-identical to the sequential loop's: ties in time are broken by the
  same sequence numbers the monolithic heap would have assigned.

Heaps store ``(time, seq, Event)`` triples (``Event.entry``) so ordering
stays a C-level tuple comparison; handlers, the stream-capture hook, and
the obs layer only ever see the typed ``Event``.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any


class EventKind(enum.IntEnum):
    """The ten event kinds, numbered as the historical int codes."""

    ARRIVAL = 0       # a traced request enters the system
    PHASE_END = 1     # a node's running phase segment settles
    WAKE_END = 2      # a gated node finished powering back up
    GATE_END = 3      # an idle node finished ramping down
    IDLE_TIMER = 4    # autoscaler re-check of an idle node
    PREEMPT_END = 5   # a preempted decode segment's truncation settles
    FAULT = 6         # crash/recover/slow/normal from the fault trace
    CRASH_END = 7     # a dying node's final truncated charge settles
    SHIP_END = 8      # a refugee's KV finished landing on its recipient
    RETRY = 9         # capped-backoff re-route of an unrouteable request

    @property
    def epoch_guarded(self) -> bool:
        """Kinds whose payload pins the node's phase epoch at scheduling
        time (dropped on pop when the epoch has moved on)."""
        return self in _EPOCH_GUARDED

    @property
    def node_local(self) -> bool:
        """Kinds a :class:`~repro_torch.cluster.engine.shard.NodeShard` owns —
        everything that times a single node's own state machine.  The
        complement (arrivals, faults, shipments, retries) crosses node
        boundaries and lives in the cross-shard
        :class:`~repro_torch.cluster.engine.mailbox.Mailbox`."""
        return self in _NODE_LOCAL


_EPOCH_GUARDED = frozenset((
    EventKind.PHASE_END, EventKind.PREEMPT_END, EventKind.WAKE_END,
    EventKind.GATE_END, EventKind.CRASH_END,
))
_NODE_LOCAL = frozenset((
    EventKind.PHASE_END, EventKind.PREEMPT_END, EventKind.WAKE_END,
    EventKind.GATE_END, EventKind.CRASH_END, EventKind.IDLE_TIMER,
))


@dataclasses.dataclass(frozen=True, slots=True)
class NodeRef:
    """Payload of every epoch-guarded node event: which node, and the
    phase epoch the event was scheduled under."""

    node_id: int
    epoch: int


@dataclasses.dataclass(frozen=True, slots=True)
class IdleToken:
    """Payload of an IDLE_TIMER: the node and the ``power_state_since``
    stamp of the idle stretch that armed it — a node that served work
    and went idle again in between invalidates the stale timer."""

    node_id: int
    since: float


@dataclasses.dataclass(frozen=True, slots=True)
class Shipment:
    """Payload of a SHIP_END: the recipient node and the in-flight
    refugee whose KV is landing there."""

    node_id: int
    member: Any   # cluster.node._InFlight (kept opaque: engine-agnostic)


@dataclasses.dataclass(frozen=True, slots=True)
class Retry:
    """Payload of a RETRY: the unrouteable request and how many routing
    attempts it has already burned."""

    req: Any      # cluster.trace.TracedRequest
    attempts: int


@dataclasses.dataclass(slots=True)
class Event:
    """One scheduled occurrence.  Total order is ``(time, seq)``; the
    fleet-wide sequence counter makes simultaneous events deterministic
    (and unique, so comparison never reaches kind or payload)."""

    time: float
    seq: int
    kind: EventKind
    payload: Any

    def __lt__(self, other: "Event") -> bool:
        return (self.time, self.seq) < (other.time, other.seq)

    @property
    def key(self) -> tuple[float, int]:
        return (self.time, self.seq)

    @property
    def entry(self) -> tuple[float, int, "Event"]:
        """Heap representation: C-speed tuple ordering, typed cargo."""
        return (self.time, self.seq, self)

    def describe(self) -> str:
        """One-line canonical rendering, used by the event-stream
        equivalence gates (two engines replaying the same run must
        produce byte-identical describe() streams)."""
        p = self.payload
        if type(p) is NodeRef:
            body = f"n{p.node_id}@e{p.epoch}"
        elif type(p) is IdleToken:
            body = f"n{p.node_id}@s{p.since!r}"
        elif type(p) is Shipment:
            body = f"n{p.node_id}+req{p.member.req.request_id}"
        elif type(p) is Retry:
            body = f"req{p.req.request_id}#{p.attempts}"
        elif p is None:
            body = "-"
        else:   # arrival (TracedRequest) or FaultEvent
            rid = getattr(p, "request_id", None)
            if rid is not None:
                body = f"req{rid}"
            else:
                body = f"n{p.node_id}:{p.kind}"
        return f"{self.time!r} #{self.seq} {self.kind.name} {body}"


class SeqAllocator:
    """The fleet-wide monotone sequence counter.  Every event — whatever
    shard pushes it — draws from this one counter in handler order, which
    is what pins tie-breaking (and therefore the whole merged stream) to
    the sequential loop's behavior."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0

    def __call__(self) -> int:
        v = self.value
        self.value = v + 1
        return v
