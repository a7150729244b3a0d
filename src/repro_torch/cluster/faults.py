"""Port copy of `repro.cluster.faults`, numpy only, with its imports renamed;
tests/test_torch_cluster*.py hold it to the reference.

Fault injection: seeded node crashes, recoveries, stragglers, and
correlated failure domains.

The cluster simulator assumed every node survives the horizon; this
module supplies the disruption stream that breaks that assumption in a
*replayable* way.  A :class:`FaultTrace` is the failure-side counterpart
of an :class:`~repro_torch.cluster.trace.ArrivalTrace` — an immutable,
time-sorted tuple of :class:`FaultEvent`\\ s that, together with the
arrival trace, fully determines a faulted run (same traces + policy →
bit-identical ClusterReport; an *empty* fault trace is bit-identical to
running with no faults at all — both invariants are pinned in
tests/test_faults.py).

Four event kinds:

  * ``crash``   — the node fails.  Takes effect at the next decode step
                  boundary (the in-flight token finishes) or prefill end,
                  immediately when off-phase — so every energy charge
                  stays an exact closed-form boundary charge.  Active and
                  suspended decodes become *refugees*: the sim ships their
                  KV to a healthy replica (``node.py``/``sim.py``
                  migration) or books their accrued joules as wasted.
                  Checkpointed prefills (``node.CheckpointConfig``) ship
                  their persisted prefix the same way and restart paying
                  only the closed-form cost of the unfinished suffix.
  * ``recover`` — the node powers back up into IDLE and rejoins the
                  eligible set.
  * ``slow``    — a sustained straggler begins: every subsequent phase is
                  stretched by ``value`` (σ ≥ 1) in wall time, with the
                  extra seconds burning static power (see
                  ``ClusterNode._stretched``).
  * ``normal``  — the straggler ends (σ back to 1).

:class:`FaultInjector` draws the stream from configurable exponential
MTTF/MTTR holding times (delegating to
:func:`repro_torch.data.workloads.fault_trace`, the seeded generator exported
next to the arrival-time generators), mapping generator node indexes onto
real fleet node ids.

Correlated blast radii: real fleets do not fail one node at a time — a
rack switch or PDU leg takes out every node behind it at once.
:class:`FaultDomain` models the fleet topology as a node → rack → PDU
tree; ``FaultDomain.groups()`` flattens it into the co-failure partition
(one tuple of node ids per leaf domain) that the correlated generator
consumes: each group runs ONE crash/recover renewal process whose events
are emitted simultaneously for every member.  Per-node independent
faults are the degenerate one-node-per-domain topology — bit-identical
to the per-node traces, pinned in tests.
"""

from __future__ import annotations

import dataclasses
import math
from bisect import bisect_right
from typing import Iterator, Sequence

from repro_torch.data.workloads import fault_trace as _raw_fault_trace

CRASH = "crash"
RECOVER = "recover"
SLOW = "slow"
NORMAL = "normal"
FAULT_KINDS = (CRASH, RECOVER, SLOW, NORMAL)

# kinds whose `value` carries no payload — anything but the 1.0 default
# is an authoring error (e.g. a slowdown factor attached to a crash)
_UNIT_VALUE_KINDS = frozenset((CRASH, RECOVER, NORMAL))


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One disruption: at `time_s`, `node_id` crashes / recovers /
    starts straggling at factor `value` / returns to normal."""

    time_s: float
    node_id: int
    kind: str
    value: float = 1.0

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}")
        if self.kind == SLOW and self.value < 1.0:
            raise ValueError("straggler slowdown must be >= 1")
        if self.kind in _UNIT_VALUE_KINDS and self.value != 1.0:
            raise ValueError(
                f"{self.kind!r} events carry no payload: value must be 1.0, "
                f"got {self.value}")


@dataclasses.dataclass(frozen=True)
class FaultDomain:
    """One blast radius in the fleet topology (node → rack → PDU tree).

    A domain either holds node ids directly (a leaf: one rack, one PDU
    leg) or groups child domains — never both.  ``groups()`` flattens
    the tree into the co-failure partition the correlated generator
    consumes: one tuple of node ids per leaf domain, in tree order."""

    name: str
    nodes: tuple[int, ...] = ()
    children: tuple["FaultDomain", ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "nodes", tuple(self.nodes))
        object.__setattr__(self, "children", tuple(self.children))
        if self.nodes and self.children:
            raise ValueError(
                f"FaultDomain {self.name!r} holds nodes or children, not both")

    @property
    def all_nodes(self) -> tuple[int, ...]:
        """Every node id under this domain, in tree order."""
        if self.nodes:
            return self.nodes
        out: list[int] = []
        for child in self.children:
            out.extend(child.all_nodes)
        return tuple(out)

    def groups(self) -> tuple[tuple[int, ...], ...]:
        """Co-failure partition: one node-id tuple per leaf domain."""
        if self.nodes:
            return (self.nodes,)
        out: list[tuple[int, ...]] = []
        for child in self.children:
            out.extend(child.groups())
        return tuple(out)


def rack_pdu_topology(node_ids: Sequence[int], *, rack_size: int,
                      racks_per_pdu: int | None = None) -> FaultDomain:
    """Standard node → rack → PDU tree over `node_ids`: consecutive runs
    of `rack_size` ids share a rack; with `racks_per_pdu`, consecutive
    runs of racks share a PDU leg.  The co-failure granularity is the
    rack (the leaf level) — pass ``FaultDomain(name, nodes=...)`` groups
    directly for coarser PDU-sized blast radii."""
    if rack_size < 1:
        raise ValueError(f"rack_size must be >= 1, got {rack_size}")
    ids = tuple(node_ids)
    if not ids:
        raise ValueError("need at least one node id")
    racks = tuple(
        FaultDomain(name=f"rack{r}", nodes=ids[i:i + rack_size])
        for r, i in enumerate(range(0, len(ids), rack_size)))
    if racks_per_pdu is None:
        return FaultDomain(name="cluster", children=racks)
    if racks_per_pdu < 1:
        raise ValueError(f"racks_per_pdu must be >= 1, got {racks_per_pdu}")
    pdus = tuple(
        FaultDomain(name=f"pdu{p}", children=racks[i:i + racks_per_pdu])
        for p, i in enumerate(range(0, len(racks), racks_per_pdu)))
    return FaultDomain(name="cluster", children=pdus)


def domain_groups(
    domains: "FaultDomain | Sequence[Sequence[int]] | None",
) -> tuple[tuple[int, ...], ...] | None:
    """Normalize a domain spec — a FaultDomain tree or a flat partition —
    into the canonical tuple-of-tuples co-failure partition."""
    if domains is None:
        return None
    if isinstance(domains, FaultDomain):
        return domains.groups()
    return tuple(tuple(g) for g in domains)


def domain_index(
    domains: "FaultDomain | Sequence[Sequence[int]]",
) -> dict[int, int]:
    """node id → co-failure group ordinal.  Raises on a node claimed by
    two domains; nodes absent from `domains` are simply missing (callers
    treat them as singleton domains of their own)."""
    out: dict[int, int] = {}
    for gi, group in enumerate(domain_groups(domains)):
        for nid in group:
            if nid in out:
                raise ValueError(f"node {nid} appears in two fault domains")
            out[nid] = gi
    return out


@dataclasses.dataclass(frozen=True)
class FaultTrace:
    """Immutable, time-sorted fault stream (replayable alongside the
    arrival trace).  `domains`, when set, records the co-failure
    partition (tuples of node ids) the trace was generated under —
    metadata consumed by survivability-aware policies, not by replay.

    `__post_init__` builds a per-node [crash, recover) interval index
    once (bisected by `is_down`) and rejects malformed streams: a
    RECOVER with no preceding CRASH is an authoring error.  A repeated
    CRASH while already down stays idempotent — correlated domain traces
    legitimately re-kill a node that a wider outage already took down."""

    name: str
    events: tuple[FaultEvent, ...]
    domains: tuple[tuple[int, ...], ...] | None = None

    def __post_init__(self):
        times = [ev.time_s for ev in self.events]
        if times != sorted(times):
            raise ValueError("fault events must be time-sorted")
        index: dict[int, tuple[list[float], list[float]]] = {}
        open_at: dict[int, float] = {}
        for ev in self.events:
            if ev.kind == CRASH:
                open_at.setdefault(ev.node_id, ev.time_s)
            elif ev.kind == RECOVER:
                if ev.node_id not in open_at:
                    raise ValueError(
                        f"recover for node {ev.node_id} at t={ev.time_s} "
                        "with no preceding crash")
                starts, ends = index.setdefault(ev.node_id, ([], []))
                starts.append(open_at.pop(ev.node_id))
                ends.append(ev.time_s)
        for nid, t0 in open_at.items():
            starts, ends = index.setdefault(nid, ([], []))
            starts.append(t0)
            ends.append(math.inf)
        object.__setattr__(
            self, "_down_index",
            {nid: (tuple(s), tuple(e)) for nid, (s, e) in index.items()})
        if self.domains is not None:
            object.__setattr__(self, "domains",
                               tuple(tuple(g) for g in self.domains))
            domain_index(self.domains)  # raises on overlapping domains

    def __len__(self) -> int:
        return len(self.events)

    def __iter__(self) -> Iterator[FaultEvent]:
        return iter(self.events)

    def down_intervals(self, node_id: int) -> list[tuple[float, float]]:
        """[crash, recover) spans for one node; an unrecovered crash
        yields an interval open to +inf."""
        starts, ends = self._down_index.get(node_id, ((), ()))
        return list(zip(starts, ends))

    def is_down(self, node_id: int, t: float) -> bool:
        starts, ends = self._down_index.get(node_id, ((), ()))
        i = bisect_right(starts, t) - 1
        return i >= 0 and t < ends[i]

    def down_forever_from(self, node_id: int, t: float) -> bool:
        """True when the node is down at `t` and never recovers — the
        liveness notion the failure-aware oracle excludes capacity by
        (a model is only *lost* to a request if every host is gone for
        good; anything that recovers is still reachable via retry)."""
        spans = self.down_intervals(node_id)
        return bool(spans) and spans[-1][1] == math.inf and spans[-1][0] <= t


@dataclasses.dataclass(frozen=True)
class FaultInjector:
    """Seeded crash/recovery + straggler event source.

    Holding times are exponential: nodes stay up for Exp(`mttf_s`) and
    down for Exp(`mttr_s`); independently, they run healthy for
    Exp(`straggle_mttf_s`) and straggle for Exp(`straggle_mttr_s`) at a
    slowdown drawn uniformly from `slowdown_range`.  A None MTTF disables
    that process.  `generate` is deterministic in (seed, node_ids,
    horizon_s) — the replayable-trace contract.

    `domains` (a FaultDomain tree or flat node-id partition) switches the
    crash/recover process to *correlated* mode: one renewal process per
    co-failure group, emitting simultaneous events for every member
    (straggling stays per-node — a slow NIC is not a rack event).  The
    partition must cover `node_ids` exactly.  One-node-per-domain is
    bit-identical to `domains=None`."""

    mttf_s: float | None = None
    mttr_s: float = 60.0
    straggle_mttf_s: float | None = None
    straggle_mttr_s: float = 30.0
    slowdown_range: tuple[float, float] = (1.5, 3.0)
    seed: int = 0
    domains: "FaultDomain | tuple[tuple[int, ...], ...] | None" = None

    def generate(self, node_ids: Sequence[int],
                 horizon_s: float) -> FaultTrace:
        ids = list(node_ids)
        id_groups = domain_groups(self.domains)
        idx_groups = None
        if id_groups is not None:
            pos = {nid: i for i, nid in enumerate(ids)}
            unknown = sorted({n for g in id_groups for n in g} - pos.keys())
            if unknown:
                raise ValueError(
                    f"fault domains name node ids not in the fleet: {unknown}")
            idx_groups = tuple(tuple(pos[n] for n in g) for g in id_groups)
        raw = _raw_fault_trace(
            len(ids), horizon_s,
            mttf_s=self.mttf_s, mttr_s=self.mttr_s,
            straggle_mttf_s=self.straggle_mttf_s,
            straggle_mttr_s=self.straggle_mttr_s,
            slowdown_range=self.slowdown_range, seed=self.seed,
            domains=idx_groups)
        events = tuple(FaultEvent(t, ids[idx], kind, value)
                       for t, idx, kind, value in raw)
        name = f"faults@mttf={self.mttf_s}/seed={self.seed}"
        if id_groups is not None:
            name += f"/domains={len(id_groups)}"
        return FaultTrace(name=name, events=events, domains=id_groups)
