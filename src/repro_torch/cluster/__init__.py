"""Port copy of `repro.cluster`, numpy only, with its imports renamed;
tests/test_torch_cluster*.py hold it to the reference.

Online cluster-serving simulator: the offline→online bridge.

The paper derives workload-based energy models and uses them for *offline*
energy-optimal scheduling over a known workload.  This package serves the
same workloads as *streaming traffic* against a heterogeneous fleet and
quantifies the offline→online optimality gap.  It also manages the
fleet's *power*: node power-gating under pluggable autoscalers, per-phase
DVFS, and non-oracle τout prediction.  It runs first-class
*multi-replica models* (several nodes hosting one model, with a replica
registry, a wake-cost-aware replica-set router, per-model replica-count
autoscaling, and a replica-aware offline oracle) and *decode-boundary
preemption* (suspend a decode at its next step boundary with the KV
position intact, resume for free when a slot opens — energy split
exactly by the closed-form decode integral).  It adds *failure realism*:
seeded fault injection (crashes, recoveries, stragglers — faults.py),
cross-node migration rescue (a crashed node's refugees ship their KV to
a healthy replica under an explicit interconnect cost model), straggler
governance and retry/abandon policies (FailoverPolicy), and a
failure-aware offline oracle (FailureAwareOraclePolicy) that re-solves
the paper's assignment against the realized fault trace.  Then
*blast-radius realism*:
correlated failure domains (FaultDomain rack/PDU topologies whose whole
leaf fails at once), prefill checkpointing (CheckpointConfig: durable
KV persistence at token-interval boundaries — a crash loses at most one
interval instead of the whole prefill, restored refugees pay only the
closed-form unfinished-suffix cost), and survivability-aware control
(DomainSpreadPolicy anti-affinity routing, the MTTF-conditioned
SurvivabilityAutoscalePolicy availability floor, and domain-masked
capacity in the failure-aware oracle).  The newest layer is
*conversational serving*: multi-turn session traces (session_trace —
each turn's prompt re-submits the grown shared prefix after a think-time
gap), a per-node KV prefix cache (PrefixCacheConfig: LRU over sessions,
capacity in kv_bytes_per_token units, crash-volatile) that serves a warm
turn with the exact telescoping suffix prefill prefill_cost(τin) −
prefill_cost(cached) plus a closed-form cache-read DMA term (the eighth
`cache_read` energy bucket), session-sticky routing
(SessionAffinityPolicy), and a cache-aware oracle
(CacheAwareOraclePolicy) conditioned on the realized hit sequence.

Module map (the event model, and how the pieces plug together):

    trace.py      — TracedRequest / ArrivalTrace + generators (Poisson,
                    bursty Gamma, diurnal thinning, on/off square-wave
                    churn, replay of the offline Alpaca-like case-study
                    workload, and session_trace — multi-turn sessions
                    whose TracedRequests carry session_id/turn/
                    prefix_tokens).  A trace is the only stochastic
                    input; everything downstream is deterministic.
    faults.py     — FaultEvent / FaultTrace / FaultInjector: seeded node
                    crash–recovery and straggler onset–clear processes
                    (exponential MTTF/MTTR alternating renewals, per-node,
                    from data.workloads.fault_trace).  A FaultTrace is the
                    second stochastic input; replaying the same trace over
                    the same arrival trace is byte-identical, and passing
                    faults=None (the default) leaves the loop bit-identical
                    to the pre-fault simulator.  FaultDomain models the
                    node → rack → PDU co-failure topology
                    (rack_pdu_topology builds it); a correlated trace runs
                    one crash/recover renewal per leaf domain, killing
                    every member simultaneously — the one-node-per-domain
                    degenerate topology reproduces the independent traces
                    bit-identically.
    node.py       — ClusterNode: one model replica on one hardware Node.
                    Continuous batching at phase granularity (batched
                    prefill, decode segments to the next completion
                    boundary, joiner prefills in between).  Per-phase
                    time/energy delegates to repro_torch.energy.simulator, so an
                    uncontended node conserves energy against the
                    per-request AnalyticLLMSimulator.  Owns the power-state
                    machine, the per-phase DVFS governor (below), and the
                    optional per-node KV prefix cache (PrefixCacheConfig:
                    LRU admission/eviction at request-arrival boundaries,
                    a hit starts the warm request as a dedicated batch-1
                    suffix prefill charged prefill_cost(τin) −
                    prefill_cost(cached), a crash invalidates the whole
                    cache).
    power.py      — PowerConfig (transition latency/energy, gated residual
                    draw) and autoscalers: reactive_idle (gate after an
                    idle timeout, wake on demand) and predictive_rate
                    (sliding-window arrival-rate estimate sizes the awake
                    fleet, pre-waking ahead of need).
    predictors.py — TauOutPredictor: per-model empirical τout quantiles
                    over a sliding completion window (Zheng-et-al-style
                    length estimation) — the non-oracle information model
                    for the routers.
    policies.py   — online routers: round_robin, random, least_loaded,
                    greedy_energy (profile-predicted argmin), zeta_online
                    (Eq. 2 with causal running normalizers), zeta_replan
                    (the γ-capacitated partition maintained online over a
                    sliding window via core.sweep.IncrementalScheduler's
                    warm-start reschedule), replica_energy (the replica-
                    set router: wake-cost-aware Eq. 2 argmin over nodes —
                    a gated replica's wake energy, amortized over an
                    expected burst, is priced into the objective instead
                    of only breaking ties), offline_oracle (replays
                    core.scheduler.schedule() over the full trace — the
                    lower bound on the Eq. 2 objective), and
                    replica_oracle (schedule_replicated replay: the same
                    bound, committed to per-node replica placement).
                    Preemption policies live here too: SLOPreemptionPolicy
                    evicts the lowest-ζ-value active decode when the
                    higher-value queue-head request (the one the freed
                    slot actually admits) would miss its slowdown SLO —
                    causally, under an optional tau_out_predictor.  The
                    energy-aware policies accept tau_out_predictor= to
                    downgrade their information model from oracle to
                    learned.  Failure handling: FailoverPolicy wraps any
                    inner router with capped-exponential-backoff retry,
                    deadline-aware abandonment, crash re-run consent, and
                    EWMA-latency straggler detection that drains chronic
                    stragglers (never a model's last accepting replica)
                    and undrains them on recovery or cooldown;
                    FailureAwareOraclePolicy extends the offline oracle
                    with a liveness mask — the assignment argmin excludes
                    models whose every host is down forever from a
                    query's arrival, so the bound stays meaningful under
                    faults.  Session serving: SessionAffinityPolicy
                    steers a follow-up turn back to the node whose cache
                    is warm (the energy term discounted by the warm-
                    prefix fraction, skipped when that node is waking/
                    gated/failed), and CacheAwareOraclePolicy re-solves
                    the offline optimum over cost columns discounted by
                    the *realized* hit sequence
                    (realized_cache_hits(report.records)) — scoring the
                    online assignment under the same discounted matrix
                    keeps oracle ≤ online exact per run.
                    New policies subclass RoutingPolicy and
                    implement select(req, nodes, now); attach() gives them
                    the fleet and (for oracle-grade information models)
                    the trace; observe_completion() is their causal
                    feedback channel, and the fault hooks (retry_delay,
                    on_fault, drain_updates, allow_rerun) have safe
                    defaults so existing policies run unchanged under
                    fault injection.
    engine/       — the sharded discrete-event engine (see the layer
                    diagram below).  events.py types the ten event kinds
                    (EventKind: arrivals, node phase completions,
                    preemption settlements, wake/gate completions,
                    autoscaler idle timers, fault events, crash-
                    quantization settlements, KV-shipment completions,
                    retry re-submissions) with payload dataclasses —
                    phase-shaped events carry the node's phase epoch so
                    a preempted (or crashed) segment's stale end event
                    is dropped.  shard.py owns one node group's heap;
                    mailbox.py is the cross-shard channel; runner.py
                    merges them in fleet-wide (time, seq) order (exact
                    at any partition), runs barrier-windowed parallel
                    drains over decomposable configs, and orchestrates
                    the rescue path: a crashed node's refugees migrate,
                    re-run, or are abandoned with their joules booked
                    as wasted.
    sim.py        — the facade over the engine's exact merge mode:
                    simulate_cluster (shard count from REPRO_SIM_SHARDS,
                    default 1 — any value is bit-identical), and
                    compare_policies() rerunning a trace (and fault
                    trace) over fresh fleets for an apples-to-apples
                    policy table.
    metrics.py    — ClusterReport: the eight-bucket busy/idle/gated/
                    transition/shipping/checkpoint/wasted/cache_read
                    energy split (the time buckets partition each node's
                    horizon — FAILED time draws exactly 0 W; shipping,
                    checkpointing, and cache reads are background
                    NIC/DMA — and the buckets sum exactly to total
                    energy), cache hit/miss/eviction counters and
                    hit-token reuse depth, J/token, latency p50/p95/
                    p99, slowdown-SLO attainment, goodput under
                    abandonment, per-node utilization, AbandonedRecords,
                    and the realized Eq. 2 objective used to measure the
                    gap to the offline oracle.  `from_registry` rebuilds
                    the aggregate view from a telemetry registry — the
                    reduction path for sharded runs.
    ../obs/       — the observability layer (repro_torch.obs): a Telemetry
                    facade bundling a mergeable MetricsRegistry, an
                    optional Chrome-trace EventTracer, and an optional
                    live InvariantAuditor.  Pass telemetry= to
                    simulate_cluster; hooks are read-only observers, so
                    the ClusterReport is byte-identical on or off (the
                    perf-suite `metrics_overhead` gate bounds the cost
                    and pins the identity exact).

Engine layers (one simulation run; the perf-suite `sharded_replay`
gate pins every artifact byte-identical across partitions)::

                    ArrivalTrace + FaultTrace (preloaded, (time, seq))
                                        │
                                        v
                   ┌─────────────── Mailbox ────────────────┐
                   │  cross-shard: arrivals, domain faults,  │
                   │  KV shipments, retries, pre-wakes       │
                   └──┬──────────────┬──────────────┬────────┘
          routed by policies.py over the merged fleet view
                      │              │              │
                      v              v              v
                ┌──────────┐   ┌──────────┐   ┌──────────┐
                │ NodeShard│   │ NodeShard│   │ NodeShard│   one heap +
                │  nodes   │   │  nodes   │   │  nodes   │   node-local
                │  0..i    │   │  i+1..j  │   │  j+1..n  │   events each
                └────┬─────┘   └────┬─────┘   └────┬─────┘
                     └──────────────┼──────────────┘
                                    v
        Runner — merge mode: consume the globally least (time, seq)
        across mailbox + shards, sequence numbers from ONE fleet-wide
        allocator at the monolith's handler sites (bit-identical by
        construction, any partition, any configuration); windowed
        mode: shards drain independently below the conservative
        horizon min(next barrier, now + cross_shard_floor_s) between
        mailbox barriers, completions replayed in a partition-
        invariant order (decomposable configs; workers>1 forks the
        shards into a process pool routing over light node views).
                                    │
                                    v
        obs/ children attach per shard + one fleet child, fold at
        finalize through the mergeable-registry reduction; tracer
        records carry fleet-order stamps so absorbed traces replay
        in merge order.  →  ClusterReport (eight-bucket partition)

Power-state lifecycle (driven by ClusterNode, timed by sim.py).
Telemetry hooks fire at the marked (*) edges: `on_power_begin` as a
WAKING/GATING ramp starts, `on_power_span` as it completes, the
autoscaler's gate verdicts/pre-wakes via `on_gate_decision`/`on_prewake`,
and `on_fault` as a fault event lands::

        enqueue / next phase         idle timer + autoscaler ok
    ACTIVE <────────────> IDLE ─────────────────────────────> GATING*
       ^  │                ^  │                                  │ gate_s
       │  │ wake done      │  │ wake done (no queued work)       v
       │  │ (work waiting) │ WAKING* <──────────────────────── GATED
       │  │                │    on-demand (routed request,       │
       │  │                │    landed migrant) or pre-wake      │
       │  v                │                                     v
       │ FAILED* <─────────┴─(crash fault event, from any state)─┘
       │   │  crash quantized to the next exact charge boundary:
       │   │  mid-decode settles the truncated segment first (the
       │   │  donor half of the cross-node split), then 0 W while
       │   │  down; active members become suspended *refugees*
       │   └──────> recovery fault event: FAILED → IDLE, rejoins
       └──────────  the eligible set (serves anything queued)

    Two governance overlays are orthogonal to the power state:
    DRAINING (FailoverPolicy flagged a chronic straggler: the node
    finishes in-flight work but accepts no new routing; suspended work
    migrates off; cleared on recovery/cooldown) and SLOW (a straggler
    fault stretches every phase by σ — same work, σ× the wall time, the
    stalled extra seconds at accelerator static draw).

Request lifecycle (PREEMPTED/RESUMING added by the preemption layer;
MIGRATING/RETRY/ABANDONED by the fault layer; CHECKPOINTING/RESTORING
by the checkpoint layer).  Telemetry hooks: `on_arrival` at routing,
`on_phase_settle` (plus the auditor's conservation checks) at every
prefill/decode/restore charge, `on_preempt_split` at a preemption or
crash settlement (auditing the split-energy identity), `on_migration`
as a KV shipment starts, `on_checkpoint` at every durable persist,
`on_restore` as a suffix re-run begins, `on_retry`/`on_abandon` on the
failover path, `on_completion` at DONE.  The prefix-cache layer adds
`on_cache_lookup` at every session-request admission, `on_cache_hit`
(plus the auditor's telescoping + closed-form cache-read checks) as a
warm suffix prefill starts, `on_cache_evict` at an LRU displacement, and
`on_cache_invalidate` as a crash wipes a node's cache::

              routed*       joiner prefill*         last token*
    WAITING ──────────> QUEUED ─────────> DECODING ──────────> DONE
       ^  ^                                │    ^
       │  │        preempter picks victim; │    │ RESUMING: rejoins the
       │  │        segment cut at the next │    │ active set at a phase
       │  │        decode step boundary*   v    │ start with a free slot
       │  │                               PREEMPTED (suspended: KV
       │  │                                position intact, zero-cost
       │  │                                resume — never re-prefilled)
       │  │                                │ host node crashes (or is
       │  │                                │ drained off a straggler)
       │  │                                v
       │  │  KV landed on the recipient  MIGRATING* — refugee's KV ships
       │  ├──────────────────────────────  to an accepting same-model
       │  │                                node: bytes/ici_bw seconds,
       │  │                                bytes·j_per_byte_ici joules on
       │  │                                the recipient's meter; resumes
       │  │                                via the PREEMPTED path
       │  │  re-run from scratch (crash   │ no accepting same-model node
       │  └─────────────────────────────  v
       │     mid-prefill, or rerun=True) RESCUE FAILED → accrued joules
       │ retry* (capped exponential       move busy → wasted* and the
       └── backoff while no node          request books an
           accepts; deadline/attempts     AbandonedRecord (reason:
           exhausted → abandoned*)        no_survivor/no_capacity/
                                          deadline)

    A preempted request keeps everything it has generated; the truncated
    decode segment is charged for exactly the steps it ran (the closed-
    form integral split at the boundary — the two halves sum to the
    unpreempted decode_cost to 1e-9), and the slot it frees admits the
    queue-head request the preemption policy cut it for.  A crash is the
    same split crossing nodes: the donor's truncated charge + the
    shipping energy + the recipient's resumed charge reconcile against
    the unfaulted closed form to 1e-9, and un-rescuable work is booked
    as wasted so conservation still closes.

    Under a CheckpointConfig the prefill itself gains two states.  A
    prefill runs as a chain of interval_tokens-sized chunks (each
    chunk's charge is the exact closed-form difference prefill_cost(b₂)
    − prefill_cost(b₁) at one pinned operating point, so the chain
    telescopes to the unchunked prefill to 1e-9); at every interior
    boundary the request is CHECKPOINTING — the fresh KV prefix
    persists durably at bytes·j_per_byte_ckpt joules over bytes/ckpt_bw
    background-DMA seconds (the seventh `checkpoint` bucket, outside
    the horizon partition like shipping).  A crash quantized to a chunk
    boundary wastes only that chunk's charge (members roll back to the
    last durable checkpoint); the refugee ships its checkpointed prefix
    like a decode refugee and enters RESTORING on the recipient — a
    dedicated batch-1 phase charging prefill_cost(τin) −
    prefill_cost(ckpt), the telescoping suffix — after which it is
    decode-ready.  Without a CheckpointConfig the crash semantics are
    bit-identical to the pre-checkpoint simulator (a mid-prefill crash
    completes the pass, then ships the full KV).

    Under a PrefixCacheConfig a session request's admission consults the
    node's KV prefix cache.  A hit (the session's entry holds cached > 0
    of this turn's prefix_tokens) pins the entry and the request later
    starts as a dedicated batch-1 *warm suffix prefill* — charged the
    exact telescoping difference prefill_cost(τin) − prefill_cost(cached)
    at one pinned operating point, the same contract as the checkpoint
    RESTORING phase — plus a closed-form cache-read term: cached ·
    kv_bytes_per_token bytes at bytes/read_bw background-DMA seconds and
    bytes·j_per_byte_read joules (the eighth `cache_read` bucket, outside
    the horizon partition like shipping).  A miss reserves τin + τout
    tokens for the session, LRU-evicting unpinned entries; a crash
    invalidates the node's whole cache (warm state is volatile), while
    power-gating preserves it.  Without a PrefixCacheConfig (the default)
    every path is bit-identical to the cache-free simulator.

DVFS operating-point semantics: an AcceleratorSpec exposes discrete
`dvfs_scales`; at scale s, peak_flops ∝ s, hbm_bw keeps its `dvfs_bw_floor`
fraction plus the coupled remainder, dyn_w ∝ s^α, idle_w fixed.  A node
with dvfs="per_phase" asks the simulator for the energy-minimal point per
phase (closed-form evaluation per candidate, host draw included), so
compute-bound prefill runs near max clock while bandwidth-bound decode
underclocks; freq_scale= pins a fixed point instead.

Gap definitions measured by benchmarks/fig4_online_gap.py:

    commitment gap  — oracle-τout online router vs the offline-oracle
                      replay: the cost of routing one request at a time,
                      with full per-request knowledge.
    information gap — predicted-τout router vs the same router with
                      oracle τout: the cost of *not knowing* output
                      lengths, isolated from the commitment gap.
    availability    — the fault axis: energy, SLO attainment, and
                      goodput vs node MTTF, FailoverPolicy rescue vs
                      no-fault baseline vs the failure-aware oracle
                      bound on the realized fault trace.

Entry points: `simulate_cluster` and `compare_policies` here, and
`serving.OnlineRouter` for live traffic.  The reference's
benchmarks/fig4_online_gap.py (arrival-rate × ζ sweep, power-gating and
DVFS columns, the two-gap split) drives `repro.cluster`; chip_smoke.py
phase 10 runs its cells on this package.
"""

from repro_torch.cluster.engine import (  # noqa: F401
    Event,
    EventKind,
    Mailbox,
    NodeShard,
    Runner,
    cross_shard_floor_s,
    partition_nodes,
)
from repro_torch.cluster.faults import (  # noqa: F401
    FaultDomain,
    FaultEvent,
    FaultInjector,
    FaultTrace,
    domain_groups,
    domain_index,
    rack_pdu_topology,
)
from repro_torch.cluster.metrics import (  # noqa: F401
    AbandonedRecord,
    ClusterReport,
    NodeStats,
    RequestRecord,
)
from repro_torch.cluster.node import (  # noqa: F401
    CheckpointConfig,
    ClusterNode,
    PrefixCacheConfig,
)
from repro_torch.cluster.policies import (  # noqa: F401
    DEFAULT_POLICIES,
    CacheAwareOraclePolicy,
    DomainSpreadPolicy,
    FailoverPolicy,
    FailureAwareOraclePolicy,
    GreedyEnergyPolicy,
    LeastLoadedPolicy,
    OfflineOraclePolicy,
    PreemptionPolicy,
    RandomPolicy,
    ReplicaEnergyPolicy,
    ReplicaOraclePolicy,
    RoundRobinPolicy,
    RoutingPolicy,
    SLOPreemptionPolicy,
    SessionAffinityPolicy,
    ZetaOnlinePolicy,
    ZetaReplanPolicy,
    objective_of_assignment,
    realized_cache_hits,
    replica_registry,
)
from repro_torch.cluster.power import (  # noqa: F401
    AutoscalePolicy,
    PowerConfig,
    PredictiveRatePolicy,
    ReactiveIdlePolicy,
    ReplicaRatePolicy,
    SurvivabilityAutoscalePolicy,
)
from repro_torch.cluster.predictors import TauOutPredictor  # noqa: F401
from repro_torch.cluster.sim import compare_policies, fresh_nodes, simulate_cluster  # noqa: F401
from repro_torch.cluster.trace import (  # noqa: F401
    ArrivalTrace,
    TracedRequest,
    bursty_trace,
    diurnal_trace,
    onoff_trace,
    poisson_trace,
    replay_trace,
    session_trace,
    timestamped_trace,
)
