"""Port copy of `repro.cluster.sim`, numpy only, with its imports renamed;
tests/test_torch_cluster*.py hold it to the reference.

The simulation facade: one call serving a trace over a sharded engine.

`simulate_cluster` is the stable public entry point the benchmarks,
oracle replays and tests drive.  Since the engine refactor the event
loop itself lives in :mod:`repro_torch.cluster.engine` — a typed event core
(:class:`~repro_torch.cluster.engine.events.EventKind` + payload dataclasses
in place of the old ten magic int codes and raw ``(time, seq, kind,
payload)`` tuples), per-node-group :class:`NodeShard` heaps, a
cross-shard :class:`Mailbox`, and the :class:`Runner` that merges them
in fleet-wide ``(time, seq)`` order.  This module is a thin facade over
that engine in its exact **merge** mode, which is bit-identical to the
historical monolithic loop *by construction*: sequence numbers come
from one fleet-wide allocator drawn at the same handler sites in the
same order, so a fixed trace + policy (+ autoscaler + preempter + fault
trace) always yields a bit-identical ClusterReport — at any shard
count.

Shard count defaults to the ``REPRO_SIM_SHARDS`` environment variable
(1 when unset), letting CI run the whole suite against a sharded
partition without touching a single call site; pass ``shards=`` to pin
it per call.  The semantics of every event kind — arrivals, phase and
preemption settlements, the power triple (wake/gate/idle-timer), and
the fault quartet (fault, crash settle, KV-ship completion, retry) —
are documented on the engine modules; the rescue orchestration,
epoch-based invalidation and completion-echo contracts are unchanged
from the monolith (the engine's handlers are a line-faithful port,
differentially pinned by tests/test_engine.py).

Observability (`telemetry=`, a repro_torch.obs.Telemetry) reports exactly as
before (fused mode: one registry/tracer/auditor); the engine can also
attach telemetry *per shard* and fold through the mergeable-registry
reduction — see :class:`Runner`'s ``obs_mode="sharded"``.
"""

from __future__ import annotations

import os
from typing import Sequence

from repro_torch.cluster.engine.runner import Runner
from repro_torch.cluster.faults import FaultTrace
from repro_torch.cluster.metrics import ClusterReport
from repro_torch.cluster.node import ClusterNode
from repro_torch.cluster.policies import PreemptionPolicy, RoutingPolicy
from repro_torch.cluster.power import AutoscalePolicy
from repro_torch.cluster.trace import ArrivalTrace


def default_shards() -> int:
    """Shard count for facade calls: ``REPRO_SIM_SHARDS`` (default 1)."""
    try:
        return max(1, int(os.environ.get("REPRO_SIM_SHARDS", "1")))
    except ValueError:
        return 1


def simulate_cluster(
    trace: ArrivalTrace,
    nodes: Sequence[ClusterNode],
    policy: RoutingPolicy,
    *,
    zeta: float = 0.5,
    autoscaler: AutoscalePolicy | None = None,
    preempter: PreemptionPolicy | None = None,
    faults: FaultTrace | None = None,
    telemetry=None,
    shards: int | None = None,
) -> ClusterReport:
    """Serve the whole trace; returns the aggregate ClusterReport.
    `shards=None` reads REPRO_SIM_SHARDS (default 1); any value yields
    the identical report (merge mode is exact at every partition)."""
    return Runner(
        trace, nodes, policy, zeta=zeta, autoscaler=autoscaler,
        preempter=preempter, faults=faults, telemetry=telemetry,
        shard_count=default_shards() if shards is None else shards,
    ).run()


def fresh_nodes(builders: Sequence) -> list[ClusterNode]:
    """Call a list of zero-arg node factories — each policy comparison needs
    pristine node state, so callers pass builders rather than nodes."""
    return [b() for b in builders]


def compare_policies(
    trace: ArrivalTrace,
    node_builders: Sequence,
    policies: Sequence[RoutingPolicy],
    *,
    zeta: float = 0.5,
    autoscaler_builder=None,
    preempter_builder=None,
    faults: FaultTrace | None = None,
) -> dict[str, ClusterReport]:
    """Run every policy on identical fresh clusters over the same trace.
    `autoscaler_builder`/`preempter_builder` are zero-arg factories
    (autoscalers and preemption policies hold per-run state, so they need
    the same fresh-per-run treatment as nodes).  A `faults=` trace is
    replayed identically against every policy — the apples-to-apples
    availability comparison fig4's MTTF sweep plots."""
    out: dict[str, ClusterReport] = {}
    for pol in policies:
        nodes = fresh_nodes(node_builders)
        scaler = autoscaler_builder() if autoscaler_builder is not None else None
        pre = preempter_builder() if preempter_builder is not None else None
        out[pol.name] = simulate_cluster(trace, nodes, pol, zeta=zeta,
                                         autoscaler=scaler, preempter=pre,
                                         faults=faults)
    return out
