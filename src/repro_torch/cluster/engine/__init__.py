"""Port copy of `repro.cluster.engine`, numpy only, with its imports renamed;
tests/test_torch_cluster*.py hold it to the reference.

The sharded deterministic event engine behind `simulate_cluster`.

Layer map (bottom up):

    events.py   — EventKind IntEnum + typed payloads (NodeRef /
                  IdleToken / Shipment / Retry), the Event unit ordered
                  by (time, seq), and the fleet-wide SeqAllocator.
    shard.py    — NodeShard: one node group's heap + the node-event
                  bookkeeping (epoch stamping, idle-timer tokens).
    mailbox.py  — Mailbox: the (time, seq)-ordered cross-shard channel
                  (arrivals, faults, KV shipments, retries).
    runner.py   — Runner: merge mode (exact, any configuration),
                  windowed mode (barrier-parallel over decomposable
                  configurations, conservative lookahead via
                  cross_shard_floor_s), and the process-pool variant.

Determinism contract: sequence numbers are drawn from one fleet-wide
allocator at the same handler sites in the same order as the historical
monolithic loop, so merge-mode replay is bit-identical to the
sequential loop at every shard count — the property tests/test_engine.py
pins on seeded fault+preemption traces at shards {1, 2, 4, 8} and under
random partitions.
"""

from repro_torch.cluster.engine.events import (  # noqa: F401
    Event,
    EventKind,
    IdleToken,
    NodeRef,
    Retry,
    SeqAllocator,
    Shipment,
)
from repro_torch.cluster.engine.mailbox import Mailbox  # noqa: F401
from repro_torch.cluster.engine.runner import (  # noqa: F401
    Runner,
    cross_shard_floor_s,
    partition_nodes,
)
from repro_torch.cluster.engine.shard import NodeShard  # noqa: F401
