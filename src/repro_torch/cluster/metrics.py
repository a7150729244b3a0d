"""Port copy of `repro.cluster.metrics`, numpy only, with its imports renamed;
tests/test_torch_cluster*.py hold it to the reference.

Aggregate metrics for a cluster run.

Energy accounting is split into eight buckets per node:

  * *busy*       — accelerator dynamic+idle during phases plus the host
                   serving draw (exactly what the per-request
                   AnalyticLLMSimulator would report);
  * *idle*       — node idle power over powered-but-workless seconds;
  * *gated*      — the residual draw while powered down;
  * *transition* — gate/wake ramps (latency at transition power plus any
                   fixed per-transition joules);
  * *shipping*   — cross-node KV migration: bytes over the interconnect
                   at J/byte, on the recipient's meter (faulted runs only);
  * *checkpoint* — durable prefill-KV persistence (node.CheckpointConfig):
                   new-prefix bytes at j_per_byte_ckpt, charged at each
                   interval boundary (checkpointed runs only);
  * *cache_read* — KV prefix-cache hits (node.PrefixCacheConfig): the
                   warm prefix streamed back at j_per_byte_read
                   (session runs with a cache only);
  * *wasted*     — work lost to un-rescuable crashes, *moved* out of busy
                   (never double-counted) so re-run joules are visible.

The time buckets (busy/idle/gated/transition/failed — a crashed node
draws 0 W, so FAILED seconds carry no energy bucket; shipping,
checkpoint and cache_read are background NIC/storage DMA concurrent with
serving and stay outside the horizon partition) partition each node's
horizon exactly — one second lands in exactly one bucket, so gated time
is never double-charged as idle — and the sum of the eight energy buckets IS the
total energy (the conservation invariant gated in the perf suite at
1e-9).  The busy bucket alone carries the conservation invariant against
the offline simulator, while fleet-level J/token still includes the cost
of keeping under-utilized replicas powered (or the savings from gating
them)."""

from __future__ import annotations

import dataclasses
import functools
import json
from typing import Sequence

import numpy as np


def replica_registry(nodes: Sequence) -> dict[str, tuple[int, ...]]:
    """Per-model replica registry: model name → node ids hosting it, in
    node order (the order `core.scheduler.schedule_replicated` flattens
    replicas in).  The single grouping rule the routers, the replica
    oracle, the autoscalers, and the sim loop all size against."""
    reg: dict[str, list[int]] = {}
    for n in nodes:
        reg.setdefault(n.profile.name, []).append(n.node_id)
    return {name: tuple(nids) for name, nids in reg.items()}


@dataclasses.dataclass(frozen=True)
class RequestRecord:
    request_id: int
    node_id: int
    model: str
    tau_in: int
    tau_out: int
    arrival_s: float
    start_s: float
    finish_s: float
    energy_j: float             # attributed busy-energy share
    isolated_runtime_s: float   # uncontended batch-1 service time
    preemptions: int = 0        # suspend/resume round-trips en route
    migrations: int = 0         # cross-node KV shipments en route
    shipped_bytes: float = 0.0  # KV bytes moved across the interconnect
    cached_tokens: int = 0      # τin tokens served from the KV prefix cache

    @property
    def latency_s(self) -> float:
        return self.finish_s - self.arrival_s

    @property
    def queue_s(self) -> float:
        return self.start_s - self.arrival_s

    @property
    def slowdown(self) -> float:
        if self.isolated_runtime_s <= 0:
            return 1.0
        return self.latency_s / self.isolated_runtime_s


@dataclasses.dataclass(frozen=True)
class AbandonedRecord:
    """A request the fleet gave up on (faulted runs only): the retry
    budget ran out, the deadline passed, or a crash stranded its decode
    with no surviving replica.  Any joules it had already accrued were
    moved to the wasted bucket (`wasted_j` here), so conservation still
    closes over completed + abandoned work."""

    request_id: int
    model: str                  # last host's model ("" if never served)
    tau_in: int
    tau_out: int
    arrival_s: float
    abandoned_s: float          # when the fleet gave up
    reason: str                 # "no_capacity" | "deadline" | "no_survivor"
    attempts: int = 0           # routing attempts before giving up
    wasted_j: float = 0.0       # accrued joules moved to the wasted bucket


@dataclasses.dataclass(frozen=True)
class NodeStats:
    node_id: int
    model: str
    n_served: int
    busy_s: float
    busy_energy_j: float
    idle_energy_j: float
    utilization: float          # busy_s / makespan
    # --- power-management buckets (all zero for an always-on node) ----
    idle_s: float = 0.0
    gated_s: float = 0.0
    gated_energy_j: float = 0.0
    transition_s: float = 0.0
    transition_energy_j: float = 0.0
    horizon_s: float = 0.0      # busy+idle+gated+transition == horizon
    n_wakes: int = 0
    n_gates: int = 0
    # --- preemption counters (zero when no preempter is installed) ----
    n_preemptions: int = 0
    n_resumes: int = 0
    # --- fault buckets/counters (zero when no faults are injected) ----
    failed_s: float = 0.0           # crashed: 0 W, partitions the horizon
    shipping_s: float = 0.0         # background NIC DMA (outside horizon)
    shipping_energy_j: float = 0.0  # inbound KV migration joules
    wasted_energy_j: float = 0.0    # lost work, moved out of busy
    n_crashes: int = 0
    n_recoveries: int = 0
    n_migrations_in: int = 0
    n_migrations_out: int = 0
    # --- checkpoint bucket/counters (zero without a CheckpointConfig) --
    checkpoint_s: float = 0.0        # background storage DMA (outside horizon)
    checkpoint_energy_j: float = 0.0  # durable prefill-KV persistence joules
    n_checkpoints: int = 0
    n_restores: int = 0
    # --- prefix-cache bucket/counters (zero without a PrefixCacheConfig)
    cache_read_s: float = 0.0        # background cache DMA (outside horizon)
    cache_read_energy_j: float = 0.0  # warm-prefix read-back joules
    n_cache_hits: int = 0
    n_cache_misses: int = 0
    n_cache_evictions: int = 0
    cache_hit_tokens: int = 0        # Σ reused prefix tokens (reuse depth)

    @property
    def total_energy_j(self) -> float:
        return (self.busy_energy_j + self.idle_energy_j
                + self.gated_energy_j + self.transition_energy_j
                + self.shipping_energy_j + self.checkpoint_energy_j
                + self.cache_read_energy_j + self.wasted_energy_j)

    @property
    def accounted_s(self) -> float:
        return (self.busy_s + self.idle_s + self.gated_s
                + self.transition_s + self.failed_s)


@dataclasses.dataclass(frozen=True)
class ClusterReport:
    policy: str
    zeta: float
    records: tuple[RequestRecord, ...]
    node_stats: tuple[NodeStats, ...]
    makespan_s: float
    objective: float            # Eq. 2 value of the realized assignment
    predicted_energy_j: float   # Σ e_K(q) under the fitted profiles
    # model name -> node ids hosting a replica (the sim's replica registry)
    replicas: tuple[tuple[str, tuple[int, ...]], ...] = ()
    # requests the fleet gave up on (faulted runs only; empty otherwise)
    abandoned: tuple[AbandonedRecord, ...] = ()

    # --- totals -----------------------------------------------------------
    @property
    def total_busy_energy_j(self) -> float:
        return sum(s.busy_energy_j for s in self.node_stats)

    @property
    def total_idle_energy_j(self) -> float:
        return sum(s.idle_energy_j for s in self.node_stats)

    @property
    def total_gated_energy_j(self) -> float:
        return sum(s.gated_energy_j for s in self.node_stats)

    @property
    def total_transition_energy_j(self) -> float:
        return sum(s.transition_energy_j for s in self.node_stats)

    @property
    def total_shipping_energy_j(self) -> float:
        return sum(s.shipping_energy_j for s in self.node_stats)

    @property
    def total_wasted_energy_j(self) -> float:
        return sum(s.wasted_energy_j for s in self.node_stats)

    @property
    def total_checkpoint_energy_j(self) -> float:
        return sum(s.checkpoint_energy_j for s in self.node_stats)

    @property
    def total_cache_read_energy_j(self) -> float:
        return sum(s.cache_read_energy_j for s in self.node_stats)

    @property
    def total_energy_j(self) -> float:
        return (self.total_busy_energy_j + self.total_idle_energy_j
                + self.total_gated_energy_j + self.total_transition_energy_j
                + self.total_shipping_energy_j
                + self.total_checkpoint_energy_j
                + self.total_cache_read_energy_j
                + self.total_wasted_energy_j)

    @property
    def total_wakes(self) -> int:
        return sum(s.n_wakes for s in self.node_stats)

    @property
    def total_gates(self) -> int:
        return sum(s.n_gates for s in self.node_stats)

    @property
    def total_preemptions(self) -> int:
        return sum(s.n_preemptions for s in self.node_stats)

    @property
    def total_resumes(self) -> int:
        return sum(s.n_resumes for s in self.node_stats)

    @property
    def total_crashes(self) -> int:
        return sum(s.n_crashes for s in self.node_stats)

    @property
    def total_migrations(self) -> int:
        return sum(s.n_migrations_in for s in self.node_stats)

    @property
    def total_checkpoints(self) -> int:
        return sum(s.n_checkpoints for s in self.node_stats)

    @property
    def total_restores(self) -> int:
        return sum(s.n_restores for s in self.node_stats)

    @property
    def total_cache_hits(self) -> int:
        return sum(s.n_cache_hits for s in self.node_stats)

    @property
    def total_cache_misses(self) -> int:
        return sum(s.n_cache_misses for s in self.node_stats)

    @property
    def total_cache_evictions(self) -> int:
        return sum(s.n_cache_evictions for s in self.node_stats)

    @property
    def total_cache_hit_tokens(self) -> int:
        return sum(s.cache_hit_tokens for s in self.node_stats)

    @property
    def cache_hit_rate(self) -> float:
        """Hits over session-request admissions (non-session requests
        never consult the cache and don't count)."""
        n = self.total_cache_hits + self.total_cache_misses
        return self.total_cache_hits / n if n else 0.0

    def replica_counts(self) -> dict[str, int]:
        """Replicas hosted per model (from the sim's replica registry)."""
        return {name: len(nids) for name, nids in self.replicas}

    @property
    def total_tokens(self) -> int:
        return sum(r.tau_in + r.tau_out for r in self.records)

    @property
    def j_per_token(self) -> float:
        tok = self.total_tokens
        return self.total_energy_j / tok if tok else 0.0

    def energy_breakdown(self) -> dict[str, float]:
        """The eight-bucket split (joules) — sums to total_energy_j."""
        return {
            "busy": self.total_busy_energy_j,
            "idle": self.total_idle_energy_j,
            "gated": self.total_gated_energy_j,
            "transition": self.total_transition_energy_j,
            "shipping": self.total_shipping_energy_j,
            "checkpoint": self.total_checkpoint_energy_j,
            "cache_read": self.total_cache_read_energy_j,
            "wasted": self.total_wasted_energy_j,
        }

    # --- latency ----------------------------------------------------------
    # The latency/slowdown vectors are materialized once per report
    # (cached_property writes the instance __dict__ directly, so it works
    # on a frozen dataclass); every percentile/SLO query reads the array
    # instead of rebuilding a Python list per call.
    @functools.cached_property
    def _latencies(self) -> np.ndarray:
        return np.array([r.latency_s for r in self.records], dtype=float)

    @functools.cached_property
    def _slowdowns(self) -> np.ndarray:
        return np.array([r.slowdown for r in self.records], dtype=float)

    def latency_percentile(self, q: float) -> float:
        lat = self._latencies
        return float(np.percentile(lat, q)) if lat.size else 0.0

    @property
    def latency_p50(self) -> float:
        return self.latency_percentile(50)

    @property
    def latency_p95(self) -> float:
        return self.latency_percentile(95)

    @property
    def latency_p99(self) -> float:
        return self.latency_percentile(99)

    @property
    def mean_latency_s(self) -> float:
        lat = self._latencies
        return float(lat.mean()) if lat.size else 0.0

    def slo_attainment(self, *, slo_s: float | None = None,
                       slowdown: float = 3.0) -> float:
        """Fraction of requests meeting the SLO: an absolute deadline if
        slo_s is given, else latency ≤ slowdown × isolated runtime."""
        if not self.records:
            return 1.0
        if slo_s is not None:
            ok = int((self._latencies <= slo_s).sum())
        else:
            ok = int((self._slowdowns <= slowdown).sum())
        return ok / len(self.records)

    def goodput(self, *, slo_s: float | None = None,
                slowdown: float = 3.0) -> float:
        """Fraction of *offered* requests (completed + abandoned) that
        completed within the SLO — the availability metric: unlike
        `slo_attainment`, giving up on a request hurts this number."""
        offered = len(self.records) + len(self.abandoned)
        if offered == 0:
            return 1.0
        return self.slo_attainment(slo_s=slo_s,
                                   slowdown=slowdown) * len(self.records) / offered

    # --- structured export ------------------------------------------------
    def to_dict(self, *, include_records: bool = False) -> dict:
        """JSON-able snapshot: run identity, totals, the four-bucket
        energy split, latency summary, and per-node stats — what the
        benchmarks dump instead of parsing `summary()` strings.  Request
        records are bulky and off by default."""
        out = {
            "policy": self.policy,
            "zeta": self.zeta,
            "makespan_s": self.makespan_s,
            "objective": self.objective,
            "predicted_energy_j": self.predicted_energy_j,
            "total_energy_j": self.total_energy_j,
            "energy_breakdown_j": self.energy_breakdown(),
            "total_tokens": self.total_tokens,
            "j_per_token": self.j_per_token,
            "n_requests": len(self.records),
            "latency_s": {
                "mean": self.mean_latency_s,
                "p50": self.latency_p50,
                "p95": self.latency_p95,
                "p99": self.latency_p99,
            },
            "slo_attainment": self.slo_attainment(),
            "goodput": self.goodput(),
            "total_wakes": self.total_wakes,
            "total_gates": self.total_gates,
            "total_preemptions": self.total_preemptions,
            "total_resumes": self.total_resumes,
            "total_crashes": self.total_crashes,
            "total_migrations": self.total_migrations,
            "total_checkpoints": self.total_checkpoints,
            "total_restores": self.total_restores,
            "total_cache_hits": self.total_cache_hits,
            "total_cache_misses": self.total_cache_misses,
            "total_cache_evictions": self.total_cache_evictions,
            "total_cache_hit_tokens": self.total_cache_hit_tokens,
            "cache_hit_rate": self.cache_hit_rate,
            "n_abandoned": len(self.abandoned),
            "replicas": {name: list(nids) for name, nids in self.replicas},
            "node_stats": [dataclasses.asdict(s) for s in self.node_stats],
            "abandoned": [dataclasses.asdict(a) for a in self.abandoned],
        }
        if include_records:
            out["records"] = [dataclasses.asdict(r) for r in self.records]
        return out

    def to_json(self, *, include_records: bool = False) -> str:
        return json.dumps(self.to_dict(include_records=include_records),
                          sort_keys=True)

    @classmethod
    def from_registry(cls, registry) -> "ClusterReport":
        """Rebuild the aggregate report view from a telemetry registry
        (the end-of-run gauges `Telemetry.finalize` writes).  This is the
        reduction path the actor-sharded simulator will use: per-partition
        registries merge (`MetricsRegistry.merged`), then one report is
        read off the merged registry.  Per-request `records` and the
        replica registry are not representable as metrics, so they come
        back empty — totals, buckets and node stats are exact."""
        if "sim_run_info" not in registry:
            raise ValueError(
                "registry has no sim_run_info — was Telemetry.finalize run?")
        (policy_key, _), = registry["sim_run_info"].sorted_children()
        served_fam = registry["sim_node_served"]
        stats = []
        for (nid_s, model), child in served_fam.sorted_children():
            nid = int(nid_s)
            e = {b: registry.value("sim_node_energy_joules", nid, b)
                 for b in ("busy", "idle", "gated", "transition",
                           "shipping", "checkpoint", "cache_read", "wasted")}
            s = {b: registry.value("sim_node_seconds", nid, b)
                 for b in ("busy", "idle", "gated", "transition",
                           "failed", "shipping", "checkpoint", "cache_read")}
            stats.append(NodeStats(
                node_id=nid,
                model=model,
                n_served=int(child.value),
                busy_s=s["busy"],
                busy_energy_j=e["busy"],
                idle_energy_j=e["idle"],
                utilization=registry.value("sim_node_utilization",
                                           nid, model),
                idle_s=s["idle"],
                gated_s=s["gated"],
                gated_energy_j=e["gated"],
                transition_s=s["transition"],
                transition_energy_j=e["transition"],
                horizon_s=registry.value("sim_node_horizon_seconds", nid),
                n_wakes=int(registry.value("sim_node_wakes", nid)),
                n_gates=int(registry.value("sim_node_gates", nid)),
                n_preemptions=int(registry.value("sim_node_preemptions",
                                                 nid)),
                n_resumes=int(registry.value("sim_node_resumes", nid)),
                failed_s=s["failed"],
                shipping_s=s["shipping"],
                shipping_energy_j=e["shipping"],
                wasted_energy_j=e["wasted"],
                n_crashes=int(registry.value("sim_node_crashes", nid)),
                n_recoveries=int(registry.value("sim_node_recoveries", nid)),
                n_migrations_in=int(
                    registry.value("sim_node_migrations_in", nid)),
                n_migrations_out=int(
                    registry.value("sim_node_migrations_out", nid)),
                checkpoint_s=s["checkpoint"],
                checkpoint_energy_j=e["checkpoint"],
                n_checkpoints=int(registry.value("sim_node_checkpoints", nid)),
                n_restores=int(registry.value("sim_node_restores", nid)),
                cache_read_s=s["cache_read"],
                cache_read_energy_j=e["cache_read"],
                n_cache_hits=int(registry.value("sim_node_cache_hits", nid)),
                n_cache_misses=int(
                    registry.value("sim_node_cache_misses", nid)),
                n_cache_evictions=int(
                    registry.value("sim_node_cache_evictions", nid)),
                cache_hit_tokens=int(
                    registry.value("sim_node_cache_hit_tokens", nid)),
            ))
        stats.sort(key=lambda st: st.node_id)
        return cls(
            policy=policy_key[0],
            zeta=registry.value("sim_zeta"),
            records=(),
            node_stats=tuple(stats),
            makespan_s=registry.value("sim_makespan_seconds"),
            objective=registry.value("sim_objective"),
            predicted_energy_j=registry.value("sim_predicted_energy_joules"),
        )

    # --- display ----------------------------------------------------------
    def summary(self) -> str:
        power = ""
        if self.total_gates or self.total_gated_energy_j:
            power = (f"gated={self.total_gated_energy_j:.0f} "
                     f"trans={self.total_transition_energy_j:.0f} "
                     f"wakes={self.total_wakes} ")
        if self.total_preemptions:
            power += (f"preempt={self.total_preemptions} "
                      f"resume={self.total_resumes} ")
        if self.total_checkpoints or self.total_restores:
            power += (f"ckpt={self.total_checkpoints} "
                      f"restore={self.total_restores} ")
        if self.total_cache_hits or self.total_cache_evictions:
            power += (f"cache={self.cache_hit_rate:.0%} "
                      f"reuse={self.total_cache_hit_tokens} "
                      f"evict={self.total_cache_evictions} ")
        if self.total_crashes or self.abandoned:
            power += (f"crash={self.total_crashes} "
                      f"migrate={self.total_migrations} "
                      f"abandon={len(self.abandoned)} "
                      f"wasted={self.total_wasted_energy_j:.0f}J ")
        return (f"{self.policy:>15s}: E={self.total_energy_j:12.0f}J "
                f"(busy={self.total_busy_energy_j:.0f} idle={self.total_idle_energy_j:.0f}) "
                f"{power}"
                f"pred={self.predicted_energy_j:.0f}J obj={self.objective:+.3f} "
                f"J/tok={self.j_per_token:7.2f} "
                f"p50={self.latency_p50:6.2f}s p95={self.latency_p95:6.2f}s "
                f"p99={self.latency_p99:6.2f}s "
                f"slo={self.slo_attainment():5.1%} "
                f"util={[round(s.utilization, 2) for s in self.node_stats]}")


def per_node_stats(nodes: Sequence, makespan_s: float) -> tuple[NodeStats, ...]:
    """Snapshot the per-node accounting.  Nodes must have been finalized
    (books closed at the makespan) by the simulation loop."""
    out = []
    for n in nodes:
        out.append(NodeStats(
            node_id=n.node_id,
            model=n.model_name,
            n_served=n.n_served,
            busy_s=n.busy_s,
            busy_energy_j=n.busy_energy_j,
            idle_energy_j=n.idle_energy_j,
            utilization=(n.busy_s / makespan_s) if makespan_s > 0 else 0.0,
            idle_s=n.idle_s,
            gated_s=n.gated_s,
            gated_energy_j=n.gated_energy_j,
            transition_s=n.transition_s,
            transition_energy_j=n.transition_energy_j,
            horizon_s=n.horizon_s,
            n_wakes=n.n_wakes,
            n_gates=n.n_gates,
            n_preemptions=n.n_preemptions,
            n_resumes=n.n_resumes,
            failed_s=n.failed_s,
            shipping_s=n.shipping_s,
            shipping_energy_j=n.shipping_energy_j,
            wasted_energy_j=n.wasted_energy_j,
            n_crashes=n.n_crashes,
            n_recoveries=n.n_recoveries,
            n_migrations_in=n.n_migrations_in,
            n_migrations_out=n.n_migrations_out,
            checkpoint_s=n.checkpoint_s,
            checkpoint_energy_j=n.checkpoint_energy_j,
            n_checkpoints=n.n_checkpoints,
            n_restores=n.n_restores,
            cache_read_s=n.cache_read_s,
            cache_read_energy_j=n.cache_read_energy_j,
            n_cache_hits=n.n_cache_hits,
            n_cache_misses=n.n_cache_misses,
            n_cache_evictions=n.n_cache_evictions,
            cache_hit_tokens=n.cache_hit_tokens,
        ))
    return tuple(out)
