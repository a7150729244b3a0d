"""Port copy of `repro.cluster.engine.mailbox`, numpy only, with its imports renamed;
tests/test_torch_cluster*.py hold it to the reference.

Mailbox: the cross-shard event channel.

Everything that crosses a node-group boundary flows through here, in one
``(time, seq)``-ordered heap: request arrivals (routing decisions read a
merged fleet view, so they are fleet events by nature), fault-trace
deliveries (a correlated domain outage posts one event per member node
at a single instant — every member shard sees the outage at the same
barrier), KV-shipping completions (a refugee's state landing on a node
that may live on a different shard than its donor), routing retries, and
deferred recovery re-deliveries.

The mailbox is the merge point the determinism argument rests on: the
runner always takes the globally least ``(time, seq)`` key across the
mailbox and every shard heap, and sequence numbers come from the same
fleet-wide allocator the shards use — so the interleaving of mailbox
deliveries with shard-local events is identical whatever the partition,
and shard count never changes the event stream.

Every cross-shard delivery also has a *minimum latency* — ship time is
bytes over interconnect bandwidth, retries wait out the policy's backoff
floor, a pre-wake takes the node's wake ramp.  ``post`` asserts the
invariant (``time >= posted-at``); the runner's windowed mode turns the
same floors into its conservative lookahead
(:func:`repro_torch.cluster.engine.runner.cross_shard_floor_s`).
"""

from __future__ import annotations

import heapq

from repro_torch.cluster.engine.events import Event

_INF = float("inf")


class Mailbox:
    """(time, seq)-ordered heap of fleet-scoped / cross-shard events."""

    __slots__ = ("heap", "posted")

    def __init__(self) -> None:
        self.heap: list[tuple[float, int, Event]] = []
        self.posted = 0

    def __len__(self) -> int:
        return len(self.heap)

    def post(self, ev: Event, *, now: float | None = None) -> Event:
        """Deliver `ev` at its own (time, seq) slot.  `now` (when given)
        asserts causality: nothing may be posted into the past."""
        assert now is None or ev.time >= now, \
            f"mailbox post into the past: {ev.describe()} at now={now!r}"
        heapq.heappush(self.heap, (ev.time, ev.seq, ev))
        self.posted += 1
        return ev

    def peek_time(self) -> float:
        return self.heap[0][0] if self.heap else _INF

    def peek_key(self) -> tuple[float, int]:
        h = self.heap
        return (h[0][0], h[0][1]) if h else (_INF, -1)

    def pop(self) -> Event:
        return heapq.heappop(self.heap)[2]
