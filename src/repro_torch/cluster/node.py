"""Port copy of `repro.cluster.node`, numpy only, with its imports renamed;
tests/test_torch_cluster*.py hold it to the reference.

Per-node serving state machine with continuous batching + power states.

A ClusterNode hosts one model replica on one hardware Node and serves the
requests a routing policy sends it.  Service is phase-granular:

  * prefill phase — up to max_batch waiting requests are admitted together
    and their (padded) prompts processed in one batched pass;
  * decode segment — the active batch decodes until the *next completion
    boundary* (the smallest remaining τout among members), after which
    finished requests leave and new waiting requests may join via a joiner
    prefill.  This is iteration-level continuous batching coarsened to
    completion boundaries, which keeps the event count O(requests) instead
    of O(tokens).

Time and energy per phase delegate to repro_torch.energy.simulator
(AnalyticLLMSimulator.prefill_cost / decode_cost) on the node's hardware
(repro_torch.energy.hardware.Node), so an uncontended node reproduces the
per-request simulator's PhaseBreakdown exactly — the energy-conservation
invariant tested in tests/test_cluster.py.

Power management (repro_torch.cluster.power) adds the off-phase lifecycle:
besides serving (ACTIVE) the node can sit powered (IDLE), be powered down
(GATED, residual draw) or be mid-transition (GATING/WAKING, with
configurable latency and energy).  Every second of the node's horizon is
accounted to exactly one of the busy/idle/gated/transition buckets —
gated seconds are never double-charged as idle — and the sum of the four
energy buckets IS the node's total energy (the conservation invariant the
perf suite gates at 1e-9).  A request routed to a gated node triggers an
on-demand wake; autoscalers may gate idle nodes and pre-wake gated ones.

Per-phase DVFS (`dvfs="per_phase"`): before charging a phase the node asks
the simulator for the energy-minimal operating point over
`accel.dvfs_scales` (closed-form evaluation per candidate, host serving
draw included as `extra_w`), so compute-bound prefills run near max clock
while bandwidth-bound decode segments underclock — the per-phase split of
Fernandez et al.  `freq_scale=` pins a fixed operating point instead
(the fixed-frequency baseline fig4 compares against).

Decode-boundary preemption (`preempt_decode`): a running decode segment
can be cut at the *next step boundary* after the request instant — the
in-flight token finishes, nothing re-runs.  The truncated segment is
charged via the same closed-form integral as the full one, split at the
boundary: because the integral is exactly additive in the step count
(decode_cost(c, a) + decode_cost(c+a, b) == decode_cost(c, a+b)), the
two halves of a preempted decode sum to the unpreempted `decode_cost` to
1e-9 — the perf-suite `preemption_split` gate.  The evicted member keeps
its KV position (`_InFlight.generated`) in the node's `suspended` list
and later *resumes* by rejoining the active set at a phase start for
free: no re-prefill, the Fernandez-et-al observation that decode
interruption is cheap while prefill re-work is not.  Decode segments are
charged when they settle (segment end or preemption boundary), never up
front, so a truncated segment is only ever charged once.

Faults (repro_torch.cluster.faults) extend the lifecycle with a FAILED state
and two extra energy buckets:

  * crash — quantized to the same decode step boundary preemption uses
    (the in-flight token finishes; a prefill completes first; off-phase
    crashes are immediate), so the dying node's last charge is still an
    exact closed-form boundary charge.  Every active/suspended member
    becomes a *refugee* with its KV position and accrued joules intact;
    the sim loop ships refugees to a healthy replica (`receive_migrant`)
    or books their joules as wasted (`book_waste`).  FAILED time draws
    0 W into the `failed_s` bucket until the recovery event.
  * shipping — a migrated member's KV bytes cross the interconnect on
    the *recipient's* meter (`book_shipping`: bytes/ici_bw seconds at
    j_per_byte_ici — a pull over the NIC, which still works when the
    donor is dead).  Shipping runs as background DMA concurrent with
    serving, so `shipping_s` is tracked but excluded from the horizon
    partition; `shipping_energy_j` joins the energy total.
  * wasted — work lost to an un-rescuable crash *moves* from the busy
    bucket to `wasted_energy_j` (never double-counted), so the fleet
    invariant "per-request attributed energy == Σ busy" and the full
    partition busy+idle+gated+transition+shipping+wasted == total both
    stay exact to 1e-9.

Prefill checkpointing (`CheckpointConfig`): decode interruption is cheap
(KV intact, resume free) but prefill interruption was all-or-nothing —
a mid-prefill crash quantized to the *prefill end* (the whole pass
completes, then ships).  With a checkpoint policy the batch prefill runs
as a sequence of chunk phases cut at `interval_tokens` boundaries; each
chunk charges the exact closed-form difference
prefill_cost(b_k) − prefill_cost(b_{k−1}) (the roofline pass is additive
over prompt prefixes, so the chunk sum telescopes to the unchunked pass
to float exactness and chunking changes *when* energy settles, never how
much) and each interior boundary persists the new KV prefix — bytes =
new_tokens × kv_bytes_per_token charged at `j_per_byte_ckpt` into the
seventh energy bucket (`checkpoint_s` stays outside the horizon
partition like shipping: background DMA concurrent with the next
chunk).  A crash now quantizes to the *chunk* boundary: the in-flight
chunk's charge moves busy → wasted (lost work bounded by one interval —
against the per-boundary persistence overhead, the tradeoff fig4's
blast-radius cell sweeps), members roll back to their last checkpoint,
and the sim ships the persisted prefix to a healthy replica where a
`restore` phase re-runs only the unfinished suffix
(prefill_cost(τin) − prefill_cost(ckpt), batch-1, the same telescoping
identity) before the request continues as an ordinary decode; a crash
mid-restore likewise wastes the restore charge and requeues the still-
checkpointed refugee.  An *uncheckpointed* prefill refugee (crashed in
its first chunk) has nothing durable to ship: it re-runs from scratch
on a survivor or abandons, its accrued joules booked wasted.
`checkpoint=None` keeps the old semantics bit-identically (a
mid-prefill crash completes the pass, then ships full KV).

KV prefix cache (`PrefixCacheConfig`): multi-turn sessions re-submit
their whole previous context as a shared prefix each turn.  With a
cache, a completed turn's KV stays resident keyed by session_id; the
next turn's admission (`enqueue` → `_cache_admit`) looks the session up
— a warm entry grants a *pending hit* and the turn later prefills as a
dedicated batch-1 phase charged prefill_cost(τin) − prefill_cost(cached)
at one pinned operating point (the same telescoping identity chunks and
restores use), plus a closed-form cache-read term: cached ×
kv_bytes_per_token bytes streamed back at `read_bw` (background DMA —
seconds outside the horizon partition) and `j_per_byte_read` — the
eighth energy bucket (`cache_read`).  Capacity is bookkept in reserved
tokens; LRU eviction happens only at admission boundaries, pending-hit
entries pinned.  A crash invalidates the whole cache (entries and
pending hits — rescued requests re-admit cold elsewhere); gating does
not.  `prefix_cache=None` (default) leaves every code path and every
accounting bucket bit-identical to the cache-less simulator.

Stragglers: a `slow` fault sets `self.slowdown = σ`; each phase fixes
the factor at its start (`phase_stretch`) and is charged the *stretch
transform* (t, e) → (σ·t, e + (σ−1)·t·accel_static_w): the same work at
σ× the wall time, with the extra seconds burning accelerator static
power.  The transform is linear in t, so the preemption split identity
survives stretching exactly.
"""

from __future__ import annotations

import dataclasses
from collections import Counter, OrderedDict, deque

from repro_torch.core.energy_model import LLMProfile
from repro_torch.energy.costs import kv_bytes_per_token
from repro_torch.energy.hardware import Node, SWING_NODE
from repro_torch.energy.simulator import AnalyticLLMSimulator
from repro_torch.models.common import ModelConfig

from repro_torch.cluster.power import (
    ACTIVE,
    FAILED,
    GATED,
    GATING,
    IDLE,
    WAKING,
    PowerConfig,
)
from repro_torch.cluster.trace import TracedRequest

# event hints returned to the engine: (EventKind, absolute time) — the
# owning NodeShard stamps the phase epoch and schedules the typed Event
from repro_torch.cluster.engine.events import EventKind

_PHASE = EventKind.PHASE_END
_WAKE = EventKind.WAKE_END
_GATE = EventKind.GATE_END
_PREEMPT = EventKind.PREEMPT_END
_CRASH = EventKind.CRASH_END


@dataclasses.dataclass
class _InFlight:
    req: TracedRequest
    start_s: float              # first service (prefill start)
    generated: int = 0          # decode tokens produced so far
    energy_j: float = 0.0       # attributed share of phase energy
    preemptions: int = 0        # times this request was suspended
    migrations: int = 0         # cross-node KV shipments en route
    shipped_bytes: float = 0.0  # KV bytes moved across the interconnect
    # per-node slice of energy_j: where each accrued joule's busy bucket
    # lives, so an abandoned refugee's waste can be booked back on the
    # node(s) that actually spent the energy (conservation stays per-node)
    energy_on: dict = dataclasses.field(default_factory=dict)
    # prefill-checkpoint state: None once the prompt is fully processed
    # (every pre-checkpoint member); an int marks a *prefill refugee*
    # whose prompt is processed only to that token — restorable from
    # ckpt_tokens (the durably persisted prefix) on a healthy node
    prefill_done: int | None = None
    ckpt_tokens: int = 0
    # KV prefix-cache hit: how many of this request's τin tokens were
    # served from the node's warm cache (its prefill charged only the
    # uncached suffix); 0 for misses and non-session requests
    cached_tokens: int = 0

    @property
    def remaining(self) -> int:
        return self.req.tau_out - self.generated

    @property
    def context(self) -> int:
        return self.req.tau_in + self.generated


@dataclasses.dataclass(frozen=True)
class Completion:
    req: TracedRequest
    start_s: float
    finish_s: float
    energy_j: float             # attributed accelerator+host joules
    isolated_runtime_s: float   # batch-1 uncontended service time (slowdown SLO)
    preemptions: int = 0        # suspend/resume round-trips en route
    migrations: int = 0         # cross-node KV shipments en route
    shipped_bytes: float = 0.0  # KV bytes moved across the interconnect
    cached_tokens: int = 0      # τin tokens served from the KV prefix cache


@dataclasses.dataclass(frozen=True)
class PrefixCacheConfig:
    """Per-node KV prefix cache for multi-turn sessions: completed turns
    leave their KV (prompt + generated answer) resident, keyed by
    session_id, so the next turn's shared prefix prefills only the
    uncached suffix — the exact closed-form difference
    prefill_cost(τin) − prefill_cost(cached) at one pinned operating
    point, the same telescoping contract checkpoint chunks and restores
    use.  The warm prefix streams back from the cache as background DMA:
    `read_bw` bytes/s (seconds outside the horizon partition, like
    shipping/checkpoint) at `j_per_byte_read` joules per byte — the
    eighth energy bucket (`cache_read`).  Capacity is `capacity_bytes`
    of KV (entries sized via kv_bytes_per_token); eviction is LRU at
    request-admission boundaries, entries with an in-flight pending hit
    pinned.  A crash wipes the cache (KV dies with the node); gating
    does not."""

    capacity_bytes: float = 64e9
    j_per_byte_read: float = 5.0e-11
    read_bw: float = 64e9

    def __post_init__(self):
        if self.capacity_bytes <= 0:
            raise ValueError(
                f"capacity_bytes must be > 0, got {self.capacity_bytes}")
        if self.j_per_byte_read < 0:
            raise ValueError("j_per_byte_read must be >= 0")
        if self.read_bw <= 0:
            raise ValueError("read_bw must be > 0")


@dataclasses.dataclass
class _CacheEntry:
    """One session's resident KV: `tokens` are valid (persisted by a
    completed turn), `reserved` is the capacity held (the admitted
    turn's full τin + τout), `pinned` counts in-flight pending hits
    that protect the entry from eviction."""

    tokens: int = 0
    reserved: int = 0
    pinned: int = 0


@dataclasses.dataclass(frozen=True)
class CheckpointConfig:
    """Prefill checkpoint policy: cut the batch prefill at
    `interval_tokens` boundaries and durably persist the new KV prefix at
    each interior boundary.  Persistence is background DMA to node-local
    durable storage: `ckpt_bw` bytes/s concurrent with the next chunk
    (the seconds stay outside the horizon partition, like shipping) at
    `j_per_byte_ckpt` joules per byte — the seventh energy bucket.
    Smaller intervals lose less work per crash but persist more often;
    fig4's blast-radius cell sweeps the tradeoff."""

    interval_tokens: int = 256
    j_per_byte_ckpt: float = 2.0e-10
    ckpt_bw: float = 16e9

    def __post_init__(self):
        if self.interval_tokens < 1:
            raise ValueError(
                f"interval_tokens must be >= 1, got {self.interval_tokens}")
        if self.j_per_byte_ckpt < 0:
            raise ValueError("j_per_byte_ckpt must be >= 0")
        if self.ckpt_bw <= 0:
            raise ValueError("ckpt_bw must be > 0")


class ClusterNode:
    """One model replica on one hardware node, with a waiting queue, a
    continuously-batched active set, and a power-state machine.  Driven by
    repro_torch.cluster.sim."""

    def __init__(
        self,
        node_id: int,
        model_cfg: ModelConfig,
        profile: LLMProfile,
        hardware: Node = SWING_NODE,
        *,
        max_batch: int = 8,
        kv_cache: bool = True,
        decode_chunk: int = 256,   # legacy reference-loop chunk (decode_cost
                                   # itself is closed-form and chunk-free)
        power: PowerConfig | None = None,
        dvfs: str = "off",         # "off" (pinned freq_scale) | "per_phase"
        freq_scale: float = 1.0,   # fixed operating point when dvfs="off"
        telemetry=None,            # repro_torch.obs.Telemetry (sim.py also sets it)
        checkpoint: CheckpointConfig | None = None,
        prefix_cache: PrefixCacheConfig | None = None,
    ):
        if dvfs not in ("off", "per_phase"):
            raise ValueError(f"dvfs must be 'off' or 'per_phase', got {dvfs!r}")
        self.node_id = node_id
        self.model_cfg = model_cfg
        self.profile = profile
        self.max_batch = max_batch
        self.power = power if power is not None else PowerConfig()
        self.dvfs = dvfs
        self.freq_scale = freq_scale
        self.telemetry = telemetry
        self.checkpoint = checkpoint
        self.prefix_cache = prefix_cache
        self.sim = AnalyticLLMSimulator(
            model_cfg, hardware, batch=1, kv_cache=kv_cache,
            noise_sigma=0.0, decode_chunk=decode_chunk)
        self.hardware = self.sim.node  # n_accel resolved to fit the weights

        # KV prefix cache (None ⇒ every path below is untouched):
        # session_id → _CacheEntry in LRU order (admission touches),
        # capacity bookkept in reserved tokens (capacity_bytes /
        # kv_bytes_per_token; a KV-free model caches unboundedly)
        self._cache: OrderedDict[int, _CacheEntry] = OrderedDict()
        self._cache_tokens = 0
        self._pending_hits: dict[int, int] = {}   # request_id → hit tokens
        self._cache_cap_tokens: int | None = None
        if prefix_cache is not None:
            kvb = kv_bytes_per_token(self.sim.cfg)
            self._cache_cap_tokens = (
                int(prefix_cache.capacity_bytes // kvb) if kvb > 0 else None)

        self.waiting: deque[TracedRequest] = deque()
        self.active: list[_InFlight] = []
        self.suspended: deque[_InFlight] = deque()   # preempted, KV intact
        self._phase_end_s: float | None = None
        self._phase_members: list[_InFlight] = []
        self._phase_steps: int = 0
        # decode-segment bookkeeping (settle-time charging + preemption)
        self._phase_kind: str | None = None      # "prefill" | "decode"
        self._phase_start_s: float = 0.0
        self._phase_base: int = 0                # decode base context
        self._phase_scale: float = 1.0           # chosen operating point
        self._phase_t: float = 0.0               # full-segment time
        self._phase_e: float = 0.0               # full-segment accel joules
        self._phase_epoch: int = 0               # invalidates stale events
        self._preempt_steps: int | None = None   # pending truncation point
        self._preempt_victims: list[_InFlight] = []

        # fault state (repro_torch.cluster.faults drives the transitions)
        self.slowdown = 1.0          # current straggler factor (σ >= 1)
        self.draining = False        # governance: accept no new routes
        self._phase_stretch = 1.0    # σ fixed at the running phase's start
        self._crash_pending = False  # crash lands at the next boundary
        self._crash_steps: int | None = None   # decode truncation point

        # checkpointed-prefill chunk state (None/0 outside a chunked
        # prefill): the running chunk's upper boundary, the full padded
        # prompt length, and the chunk's charged joules (what a crash at
        # the chunk settle moves busy → wasted)
        self._ckpt_chunk_to: int | None = None
        self._ckpt_total = 0
        self._ckpt_chunk_charge = 0.0
        # restore-phase state: the prefill refugee whose suffix is being
        # re-run, and its charged joules (wasted if the node dies mid-way)
        self._restore_member: _InFlight | None = None
        self._restore_charge = 0.0

        # power-state machine (starts powered and idle at t = 0)
        self._pstate = IDLE
        self._pstate_since = 0.0

        # aggregate accounting: time and energy buckets.  failed_s draws
        # exactly 0 W (a crashed node is off the PDU), so it partitions
        # the horizon without an energy bucket of its own; shipping_s is
        # background NIC DMA concurrent with serving and stays *outside*
        # the horizon partition while shipping_energy_j joins the total.
        self.busy_s = 0.0
        self.busy_energy_j = 0.0
        self.idle_s = 0.0
        self.idle_energy_j = 0.0
        self.gated_s = 0.0
        self.gated_energy_j = 0.0
        self.transition_s = 0.0
        self.transition_energy_j = 0.0
        self.failed_s = 0.0
        self.shipping_s = 0.0
        self.shipping_energy_j = 0.0
        self.wasted_energy_j = 0.0
        self.checkpoint_s = 0.0        # background DMA, like shipping_s
        self.checkpoint_energy_j = 0.0
        self.cache_read_s = 0.0        # background DMA, like shipping_s
        self.cache_read_energy_j = 0.0
        self.horizon_s = 0.0       # set by finalize()
        self.n_served = 0
        self.n_wakes = 0
        self.n_gates = 0
        self.n_preemptions = 0
        self.n_resumes = 0
        self.n_crashes = 0
        self.n_recoveries = 0
        self.n_migrations_in = 0
        self.n_migrations_out = 0
        self.n_checkpoints = 0         # member-boundary persists taken
        self.n_restores = 0            # suffix restore phases begun
        self.n_cache_hits = 0          # warm-prefix admissions
        self.n_cache_misses = 0        # cold session admissions
        self.n_cache_evictions = 0     # LRU entry evictions (+ overflows)
        self.cache_hit_tokens = 0      # Σ reused prefix tokens (reuse depth)
        self.freq_choices: Counter = Counter()   # (phase_kind, scale) -> count

    # ------------------------------------------------------------------
    @property
    def model_name(self) -> str:
        return self.profile.name

    @property
    def busy(self) -> bool:
        return self._phase_end_s is not None

    def load(self) -> int:
        """Queue depth + in-flight + suspended count (the least-loaded
        policy signal; suspended work still owes this node decode time)."""
        return len(self.waiting) + len(self.active) + len(self.suspended)

    @property
    def idle_power_w(self) -> float:
        a, h = self.hardware.accel, self.hardware.host
        return a.idle_w * self.hardware.n_accel + h.idle_w

    @property
    def transition_power_w(self) -> float:
        w = self.power.transition_w
        return self.idle_power_w if w is None else w

    # --- power-state surface (read by sim loop, autoscalers, policies) --
    @property
    def power_state(self) -> str:
        return self._pstate

    @property
    def power_state_since(self) -> float:
        return self._pstate_since

    @property
    def awake(self) -> bool:
        return self._pstate in (ACTIVE, IDLE)

    @property
    def failed(self) -> bool:
        return self._pstate == FAILED

    @property
    def accepting(self) -> bool:
        """Routable: not crashed (nor about to be — a pending crash is
        already fatal) and not being drained by governance."""
        return (self._pstate != FAILED and not self.draining
                and not self._crash_pending)

    @property
    def crash_pending(self) -> bool:
        """A crash is quantizing to its charge boundary (the node is
        still finishing the in-flight work before going FAILED).  The
        sim loop defers a recovery event that pops in this window — a
        node cannot recover from a failure that has not landed yet."""
        return self._crash_pending

    @property
    def phase_stretch(self) -> float:
        """Straggler factor σ of the running (or just-settled) phase —
        fixed at phase start, read by the auditor's split-charge check."""
        return self._phase_stretch

    @property
    def accel_static_w(self) -> float:
        """Accelerator static draw — what a straggler's stalled extra
        seconds burn (the host serving draw is charged on wall time
        separately in `_charge`)."""
        return self.hardware.accel.idle_w * self.hardware.n_accel

    @property
    def can_gate(self) -> bool:
        return (self._pstate == IDLE and not self.waiting and not self.active
                and not self.suspended)

    @property
    def in_decode(self) -> bool:
        """Mid-decode-segment — the only phase kind that can be preempted."""
        return self._phase_end_s is not None and self._phase_kind == "decode"

    @property
    def preempt_pending(self) -> bool:
        return self._preempt_steps is not None

    @property
    def phase_end_s(self) -> float | None:
        """Absolute end time of the running phase (None when idle) — the
        preemption policy's wait estimate for a queued arrival."""
        return self._phase_end_s

    @property
    def phase_epoch(self) -> int:
        """Monotone phase generation counter: a scheduled phase/preempt
        event is valid only if its epoch still matches (preemption is the
        one path that invalidates an already-scheduled segment end)."""
        return self._phase_epoch

    @property
    def pending_wake_j(self) -> float:
        """Energy a fresh request routed here would spend waking the node:
        zero while powered or already waking, the full transition cost
        while gated (or ramping down, since the gate must finish first).
        The wake-cost-aware router folds this into its argmin."""
        if self._pstate in (GATED, GATING):
            return self.power.wake_j + self.power.wake_s * self.transition_power_w
        return 0.0

    @property
    def power_rank(self) -> int:
        """Tie-break key for routing: who serves a fresh request soonest.
        0 = powered (idle/active), 1 = waking, 2 = gated (one wake away),
        3 = gating (must finish ramping down, then wake), 4 = failed
        (serves nothing until its recovery event)."""
        return {ACTIVE: 0, IDLE: 0, WAKING: 1, GATED: 2, GATING: 3,
                FAILED: 4}[self._pstate]

    # --- time/energy bucket accounting ---------------------------------
    def _accrue(self, now: float) -> None:
        """Close the open interval of the current state at `now`.  ACTIVE
        time/energy is charged per phase by _charge (exact closed forms),
        so only the off-phase states accrue here."""
        dt = now - self._pstate_since
        if dt <= 0.0:
            return
        if self._pstate == IDLE:
            self.idle_s += dt
            self.idle_energy_j += dt * self.idle_power_w
        elif self._pstate == GATED:
            self.gated_s += dt
            self.gated_energy_j += dt * self.power.gated_w
        elif self._pstate in (GATING, WAKING):
            self.transition_s += dt
            self.transition_energy_j += dt * self.transition_power_w
        elif self._pstate == FAILED:
            self.failed_s += dt   # off the PDU: 0 W by definition

    def _set_state(self, state: str, now: float) -> None:
        if state == self._pstate:
            return
        self._accrue(now)
        self._pstate = state
        self._pstate_since = now

    def finalize(self, end_s: float) -> None:
        """Close the books at the end of a simulation.  The node's horizon
        is the report makespan, extended if a power transition was still
        settling past it (that time is accounted, not dropped — the
        conservation invariant stays exact)."""
        horizon = max(end_s, self._pstate_since)
        self._accrue(horizon)
        self._pstate_since = horizon
        self.horizon_s = horizon

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

    # ------------------------------------------------------------------
    def enqueue(self, req: TracedRequest, now: float
                ) -> tuple[str, float] | None:
        """Accept a routed request.  Returns the next timed event this
        creates — (EventKind.PHASE_END, end_s) if an idle node starts
        serving, (EventKind.WAKE_END, end_s) if a gated node begins its
        on-demand wake — or
        None when the request just queues (node busy or mid-transition)."""
        if self._pstate == FAILED:
            raise RuntimeError(
                f"request routed to failed node {self.node_id} — the sim "
                f"loop must filter to accepting nodes")
        self._cache_admit(req)
        self.waiting.append(req)
        if self._pstate == GATED:
            return (_WAKE, self.begin_wake(now))
        if self._pstate in (WAKING, GATING) or self.busy:
            return None
        return self._phase_event(self._start_phase(now))

    # --- power transitions ---------------------------------------------
    def begin_wake(self, now: float) -> float:
        """Start powering the node back up; returns the ready time."""
        assert self._pstate == GATED, f"wake from {self._pstate}"
        self._set_state(WAKING, now)
        self.transition_energy_j += self.power.wake_j
        self.n_wakes += 1
        if self.telemetry is not None:
            self.telemetry.on_power_begin(self, "wake", now)
        return now + self.power.wake_s

    def on_wake_end(self, now: float) -> tuple[str, float] | None:
        """Node is powered again: serve whatever queued during the wake."""
        assert self._pstate == WAKING, f"wake ended in {self._pstate}"
        span_start = self._pstate_since
        self._set_state(IDLE, now)
        if self.telemetry is not None:
            self.telemetry.on_power_span(self, "wake", span_start, now)
        return self._phase_event(self._start_phase(now))

    def begin_gate(self, now: float) -> tuple[str, float]:
        """Start ramping an idle node down; uninterruptible (an arrival
        during the ramp queues, then triggers a wake once gated)."""
        assert self.can_gate, f"gate from {self._pstate} (work pending?)"
        self._set_state(GATING, now)
        self.transition_energy_j += self.power.gate_j
        self.n_gates += 1
        if self.telemetry is not None:
            self.telemetry.on_power_begin(self, "gate", now)
        return (_GATE, now + self.power.gate_s)

    def on_gate_end(self, now: float) -> tuple[str, float] | None:
        assert self._pstate == GATING, f"gate ended in {self._pstate}"
        span_start = self._pstate_since
        self._set_state(GATED, now)
        if self.telemetry is not None:
            self.telemetry.on_power_span(self, "gate", span_start, now)
        if self.waiting or self.suspended:
            # something arrived mid-ramp (a queued request, or a migrant
            # whose KV landed during the ramp): wake right back up
            return (_WAKE, self.begin_wake(now))
        return None

    # --- phases ---------------------------------------------------------
    @staticmethod
    def _phase_event(end_s: float | None) -> tuple[str, float] | None:
        return None if end_s is None else (_PHASE, end_s)

    def _charge(self, members: list[_InFlight], t: float, e_accel: float, *,
                kind: str, start_s: float, scale: float) -> None:
        e_total = e_accel + self.sim.host_power_w * t
        self.busy_s += t
        self.busy_energy_j += e_total
        share = e_total / len(members)
        nid = self.node_id
        for m in members:
            m.energy_j += share
            m.energy_on[nid] = m.energy_on.get(nid, 0.0) + share
        if self.telemetry is not None:
            self.telemetry.on_phase_settle(self, kind, start_s, t, e_total,
                                           len(members), scale)

    def _stretched(self, t: float, e_accel: float) -> tuple[float, float]:
        """Apply the running phase's straggler factor: same work, σ× the
        wall time, the extra (σ−1)·t seconds at accelerator static draw.
        Exactly the identity transform at σ == 1, and linear in t, so the
        decode split additivity survives stretching to 1e-9."""
        s = self._phase_stretch
        if s == 1.0:
            return t, e_accel
        return s * t, e_accel + (s - 1.0) * t * self.accel_static_w

    def _prefill(self, tau_in: int, batch: int) -> tuple[float, float, float]:
        if self.dvfs == "per_phase":
            s, t, e = self.sim.best_prefill_frequency(
                tau_in, batch=batch, extra_w=self.sim.host_power_w)
        else:
            s = self.freq_scale
            t, e = self.sim.prefill_cost(tau_in, batch=batch, freq_scale=s)
        self.freq_choices[("prefill", s)] += 1
        return s, t, e

    def _decode(self, base: int, n_steps: int, batch: int
                ) -> tuple[float, float, float]:
        if self.dvfs == "per_phase":
            s, t, e = self.sim.best_decode_frequency(
                base, n_steps, batch=batch, extra_w=self.sim.host_power_w)
        else:
            s = self.freq_scale
            t, e = self.sim.decode_cost(base, n_steps, batch=batch,
                                        freq_scale=s)
        self.freq_choices[("decode", s)] += 1
        return s, t, e

    # --- KV prefix cache: admission, LRU eviction, invalidation ---------
    def _cache_admit(self, req: TracedRequest) -> None:
        """Request-admission boundary of the KV prefix cache: look the
        session up (a warm entry grants a pending hit of
        min(valid tokens, prefix_tokens) — clamped below τin so a suffix
        always remains to prefill), touch its LRU position, and reserve
        capacity for this turn's full context (τin + τout tokens, valid
        once the turn completes here).  Reserving may LRU-evict unpinned
        colder sessions; a turn too large to ever fit is simply not
        cached (its own pending hit, if any, still serves — the pinned
        entry survives at its old size until the hit lands)."""
        cfg = self.prefix_cache
        if cfg is None or req.session_id < 0:
            return
        key = req.session_id
        entry = self._cache.get(key)
        hit = 0
        if entry is not None:
            hit = min(entry.tokens, req.prefix_tokens, req.tau_in - 1)
            self._cache.move_to_end(key)
        if hit > 0:
            self._pending_hits[req.request_id] = hit
            entry.pinned += 1
            self.n_cache_hits += 1
            self.cache_hit_tokens += hit
        else:
            self.n_cache_misses += 1
        if self.telemetry is not None:
            self.telemetry.on_cache_lookup(self, req, hit)
        new_reserved = req.tau_in + req.tau_out
        held = entry.reserved if entry is not None else 0
        cap = self._cache_cap_tokens
        if cap is not None and new_reserved > held:
            need = self._cache_tokens - held + new_reserved
            if need > cap:
                self._cache_evict_lru(need - cap, keep=key)
            if self._cache_tokens - held + new_reserved > cap:
                # no room even after evicting everything unpinned: drop
                # the entry unless a pending hit still pins it
                if entry is not None and entry.pinned == 0:
                    self._cache_drop(key)
                return
        if entry is None:
            self._cache[key] = _CacheEntry(tokens=0, reserved=new_reserved)
            self._cache_tokens += new_reserved
        elif new_reserved > entry.reserved:
            self._cache_tokens += new_reserved - entry.reserved
            entry.reserved = new_reserved

    def _cache_drop(self, key: int) -> None:
        entry = self._cache.pop(key)
        self._cache_tokens -= entry.reserved
        self.n_cache_evictions += 1
        if self.telemetry is not None:
            self.telemetry.on_cache_evict(self, key, entry.reserved)

    def _cache_evict_lru(self, excess_tokens: int, *, keep: int) -> None:
        """Evict unpinned entries in LRU order until `excess_tokens` of
        reserved capacity are freed (or nothing evictable remains)."""
        for key in list(self._cache.keys()):
            if excess_tokens <= 0:
                break
            if key == keep:
                continue
            entry = self._cache[key]
            if entry.pinned > 0:
                continue
            excess_tokens -= entry.reserved
            self._cache_drop(key)

    def _cache_invalidate(self, now: float) -> None:
        """A crash kills every resident KV prefix: the cache empties and
        all pending hits die with it (rescued requests re-admit — cold —
        wherever the sim loop re-routes them)."""
        if self.prefix_cache is None:
            return
        n = len(self._cache)
        self._cache.clear()
        self._cache_tokens = 0
        self._pending_hits.clear()
        if n and self.telemetry is not None:
            self.telemetry.on_cache_invalidate(self, n, now)

    def _cache_commit(self, m: _InFlight) -> None:
        """A session turn completed here: its KV (prompt + answer) is now
        resident, so mark the entry's valid-token high-water mark — up to
        the capacity actually reserved at admission.  LRU order is
        untouched (only admissions rank recency)."""
        if self.prefix_cache is None or m.req.session_id < 0:
            return
        entry = self._cache.get(m.req.session_id)
        if entry is not None:
            entry.tokens = max(entry.tokens,
                               min(m.req.tau_in + m.generated, entry.reserved))

    def _start_cached_prefill(self, req: TracedRequest, now: float) -> float:
        """Batch-1 joiner prefill over a warm KV prefix: charge only the
        uncached suffix — the closed-form difference prefill_cost(τin) −
        prefill_cost(cached) at one pinned operating point, the exact
        telescoping identity restores use — plus the closed-form
        cache-read term for streaming the warm prefix back (background
        DMA: seconds outside the horizon partition, joules into the
        eighth bucket).  Runs unchunked even under a CheckpointConfig
        (the suffix is one restore-like pass)."""
        cfg = self.prefix_cache
        cached = self._pending_hits.pop(req.request_id)
        entry = self._cache.get(req.session_id)
        if entry is not None and entry.pinned > 0:
            entry.pinned -= 1
        tau = req.tau_in
        assert 0 < cached < tau, (cached, tau)
        m = _InFlight(req, start_s=now, cached_tokens=cached)
        if self.dvfs == "per_phase":
            s, _, _ = self.sim.best_prefill_frequency(
                tau, batch=1, extra_w=self.sim.host_power_w)
        else:
            s = self.freq_scale
        self.freq_choices[("prefill", s)] += 1
        t_full, e_full = self.sim.prefill_cost(tau, batch=1, freq_scale=s)
        t_base, e_base = self.sim.prefill_cost(cached, batch=1, freq_scale=s)
        t, e = self._stretched(t_full - t_base, e_full - e_base)
        self._set_state(ACTIVE, now)
        self._charge([m], t, e, kind="prefill", start_s=now, scale=s)
        n_bytes = cached * kv_bytes_per_token(self.sim.cfg)
        read_s = n_bytes / cfg.read_bw
        read_j = n_bytes * cfg.j_per_byte_read
        self.cache_read_s += read_s
        self.cache_read_energy_j += read_j
        self.active.append(m)
        self._phase_members = [m]
        self._phase_steps = 0
        self._phase_kind = "prefill"
        self._phase_start_s = now
        self._phase_scale = s
        self._phase_end_s = now + t
        if self.telemetry is not None:
            self.telemetry.on_cache_hit(self, tau, cached, n_bytes,
                                        read_s, read_j, s)
        return self._phase_end_s

    def _start_phase(self, now: float) -> float | None:
        """Pick the next phase; returns its end time (None if going idle).

        Slot order: waiting requests first (a preemption was triggered
        *for* an arrival, which must not lose the freed slot back to its
        own victim), then suspended requests resume into whatever slots
        remain — a resume is free (KV position intact, no re-prefill), the
        member simply rejoins the active set for the coming segments.  A
        *prefill refugee* at the head of the suspended queue cannot
        resume for free (its prompt is only part-processed): it gets a
        dedicated batch-1 `restore` phase re-running the unfinished
        suffix, which — like a joiner prefill — runs before any decode
        segment (FIFO order over the suspended queue is preserved, so
        decode-ready refugees behind it wait for the restore)."""
        self._phase_epoch += 1
        self._phase_stretch = self.slowdown   # σ fixed for this phase
        slots = self.max_batch - len(self.active)
        joiners = [self.waiting.popleft()
                   for _ in range(min(slots, len(self.waiting)))]
        slots -= len(joiners)
        if slots > 0 and self.suspended:
            resumed = []
            while (len(resumed) < slots and self.suspended
                   and self.suspended[0].prefill_done is None):
                resumed.append(self.suspended.popleft())
            slots -= len(resumed)
            self.n_resumes += len(resumed)
            self.active.extend(resumed)
        if joiners and self._pending_hits:
            # a warm-prefix joiner gets a dedicated batch-1 telescoped
            # prefill (like a restore); the other joiners go back to the
            # head of the queue, order intact, for the next phase start
            i = next((i for i, r in enumerate(joiners)
                      if r.request_id in self._pending_hits), None)
            if i is not None:
                warm = joiners.pop(i)
                for r in reversed(joiners):
                    self.waiting.appendleft(r)
                return self._start_cached_prefill(warm, now)
        if joiners:
            # (joiner) prefill for as many waiting requests as fit
            members = [_InFlight(r, start_s=now) for r in joiners]
            if self.checkpoint is not None:
                return self._begin_chunked_prefill(members, now)
            s, t, e = self._prefill(max(r.tau_in for r in joiners),
                                    len(joiners))
            t, e = self._stretched(t, e)
            self._set_state(ACTIVE, now)
            self._charge(members, t, e, kind="prefill", start_s=now, scale=s)
            self.active.extend(members)
            self._phase_members = members
            self._phase_steps = 0
            self._phase_kind = "prefill"
            self._phase_start_s = now
            self._phase_scale = s
            self._phase_end_s = now + t
            return self._phase_end_s
        if (self.suspended and self.suspended[0].prefill_done is not None
                and slots > 0):
            return self._start_restore(now)
        if self.active:
            # decode to the next completion boundary (padded batch: every
            # step attends up to the longest member context); closed-form
            # and memoized on (base, n_steps, batch, freq), so bursts of
            # identical requests price each segment shape exactly once.
            # The charge is deferred to settle time (segment end or
            # preemption boundary) so a truncated segment is charged once,
            # for exactly the steps it ran.
            n_steps = min(m.remaining for m in self.active)
            base = max(m.context for m in self.active)
            s, t, e = self._decode(base, n_steps, len(self.active))
            t, e = self._stretched(t, e)
            self._set_state(ACTIVE, now)
            self._phase_members = list(self.active)
            self._phase_steps = n_steps
            self._phase_kind = "decode"
            self._phase_start_s = now
            self._phase_base = base
            self._phase_scale = s
            self._phase_t = t
            self._phase_e = e
            self._phase_end_s = now + t
            return self._phase_end_s
        self._set_state(IDLE, now)
        self._phase_kind = None
        self._phase_end_s = None
        return None

    def on_phase_end(self, now: float
                     ) -> tuple[list[Completion], tuple[str, float] | None]:
        """Advance past the finished phase.  Returns (completions, next
        phase event or None if the node went idle)."""
        assert self._phase_end_s is not None
        if self._ckpt_chunk_to is not None:
            # checkpointed-prefill chunk boundary
            if self._crash_pending:
                self._waste_inflight_chunk(now)
                return [], None
            if self._ckpt_chunk_to < self._ckpt_total:
                return [], self._phase_event(self._settle_prefill_chunk(now))
            # final boundary: the full (padded) prompt is processed
            for m in self._phase_members:
                m.prefill_done = None
            self._clear_chunk_state()
        elif self._phase_kind == "restore":
            if self._crash_pending:
                self._waste_restore(now)
                return [], None
            m = self._restore_member
            self._restore_member = None
            self._restore_charge = 0.0
            m.prefill_done = None
            self.active.append(m)   # completion check below catches τout==0
        if self._phase_kind == "decode":   # settle the deferred charge
            self._charge(self._phase_members, self._phase_t, self._phase_e,
                         kind="decode", start_s=self._phase_start_s,
                         scale=self._phase_scale)
        done: list[Completion] = []
        for m in self._phase_members:
            m.generated += self._phase_steps
        # τout == 0 requests complete straight after their prefill, so this
        # check runs after every phase, not only decode segments
        finished = [m for m in self.active if m.remaining <= 0]
        if finished:
            self.active = [m for m in self.active if m.remaining > 0]
            for m in finished:
                self.n_served += 1
                self._cache_commit(m)
                done.append(Completion(
                    req=m.req,
                    start_s=m.start_s,
                    finish_s=now,
                    energy_j=m.energy_j,
                    isolated_runtime_s=self.sim.simulate(
                        m.req.tau_in, m.req.tau_out).runtime_s,
                    preemptions=m.preemptions,
                    migrations=m.migrations,
                    shipped_bytes=m.shipped_bytes,
                    cached_tokens=m.cached_tokens,
                ))
        self._phase_members = []
        self._phase_steps = 0
        self._phase_kind = None
        self._phase_end_s = None
        if self._crash_pending:
            # the crash was quantized to this settle (prefill end, or a
            # decode that reached its natural boundary first): members
            # finishing exactly here completed legitimately — the
            # in-flight work is never re-run — and the rest are refugees
            self._complete_crash(now)
            return done, None
        return done, self._phase_event(self._start_phase(now))

    # --- checkpointed prefill: chunks, persistence, restore -------------
    def _clear_chunk_state(self) -> None:
        self._ckpt_chunk_to = None
        self._ckpt_total = 0
        self._ckpt_chunk_charge = 0.0

    def _begin_chunked_prefill(self, members: list[_InFlight],
                               now: float) -> float:
        """First chunk of a checkpointed prefill.  One operating point
        (and one straggler stretch) is fixed for the whole prefill — a
        per-chunk re-pick would break the telescoping identity that makes
        the chunk sum equal the unchunked `prefill_cost` exactly."""
        total = max(m.req.tau_in for m in members)
        batch = len(members)
        if self.dvfs == "per_phase":
            s, _, _ = self.sim.best_prefill_frequency(
                total, batch=batch, extra_w=self.sim.host_power_w)
        else:
            s = self.freq_scale
        self.freq_choices[("prefill", s)] += 1
        for m in members:
            m.prefill_done = 0
        b1 = min(self.checkpoint.interval_tokens, total)
        t, e = self.sim.prefill_cost(b1, batch=batch, freq_scale=s)
        t, e = self._stretched(t, e)
        self._set_state(ACTIVE, now)
        self._charge(members, t, e, kind="prefill", start_s=now, scale=s)
        self.active.extend(members)
        self._phase_members = members
        self._phase_steps = 0
        self._phase_kind = "prefill"
        self._phase_start_s = now
        self._phase_scale = s
        self._ckpt_chunk_to = b1
        self._ckpt_total = total
        self._ckpt_chunk_charge = e + self.sim.host_power_w * t
        self._phase_end_s = now + t
        return self._phase_end_s

    def _settle_prefill_chunk(self, now: float) -> float:
        """An interior chunk boundary lands: advance every member's
        processed-prompt position, durably persist the new KV prefix
        (bytes = new tokens × kv_bytes_per_token into the checkpoint
        bucket), and charge the next chunk — the exact closed-form
        difference prefill_cost(b₂) − prefill_cost(b₁) at the phase's
        pinned operating point."""
        b = self._ckpt_chunk_to
        members = self._phase_members
        new_tokens = 0
        n_members = 0
        for m in members:
            done = min(b, m.req.tau_in)
            m.prefill_done = done
            if done > m.ckpt_tokens:
                new_tokens += done - m.ckpt_tokens
                m.ckpt_tokens = done
                n_members += 1
                self.n_checkpoints += 1
        if new_tokens > 0:
            n_bytes = new_tokens * kv_bytes_per_token(self.sim.cfg)
            ckpt_s = n_bytes / self.checkpoint.ckpt_bw
            ckpt_j = n_bytes * self.checkpoint.j_per_byte_ckpt
            self.checkpoint_s += ckpt_s
            self.checkpoint_energy_j += ckpt_j
            if self.telemetry is not None:
                self.telemetry.on_checkpoint(self, new_tokens, n_bytes,
                                             ckpt_s, ckpt_j, n_members)
        b2 = min(b + self.checkpoint.interval_tokens, self._ckpt_total)
        batch = len(members)
        s = self._phase_scale
        t1, e1 = self.sim.prefill_cost(b, batch=batch, freq_scale=s)
        t2, e2 = self.sim.prefill_cost(b2, batch=batch, freq_scale=s)
        t, e = self._stretched(t2 - t1, e2 - e1)
        self._charge(members, t, e, kind="prefill", start_s=now, scale=s)
        self._ckpt_chunk_to = b2
        self._ckpt_chunk_charge = e + self.sim.host_power_w * t
        self._phase_start_s = now
        self._phase_end_s = now + t
        return self._phase_end_s

    def _waste_inflight_chunk(self, now: float) -> None:
        """A crash quantized to this chunk boundary: the in-flight
        chunk's work dies with the node — its charge moves busy → wasted
        (deducting the exact per-member shares `_charge` attributed) and
        every member rolls back to its last durable checkpoint.  Lost
        work is bounded by one interval — the finer quantization that
        checkpointing buys over the complete-the-whole-prefill crash
        semantics of checkpoint=None."""
        charge = self._ckpt_chunk_charge
        share = charge / len(self._phase_members)
        nid = self.node_id
        for m in self._phase_members:
            m.energy_j -= share
            m.energy_on[nid] -= share
            m.prefill_done = min(m.ckpt_tokens, m.req.tau_in)
        self.book_waste(charge)
        self._clear_chunk_state()
        self._phase_members = []
        self._phase_kind = None
        self._phase_end_s = None
        self._complete_crash(now)

    def _start_restore(self, now: float) -> float:
        """Batch-1 restore phase for the prefill refugee at the head of
        the suspended queue: re-run only the unfinished suffix of its
        prompt — the closed-form difference prefill_cost(τin) −
        prefill_cost(ckpt), the same telescoping identity the chunks use
        — after which the member is decode-ready like any resume."""
        m = self.suspended.popleft()
        tau = m.req.tau_in
        base = m.ckpt_tokens
        assert 0 < base < tau, (base, tau)   # sim.py normalizes the rest
        if self.dvfs == "per_phase":
            s, _, _ = self.sim.best_prefill_frequency(
                tau, batch=1, extra_w=self.sim.host_power_w)
        else:
            s = self.freq_scale
        self.freq_choices[("restore", s)] += 1
        t_full, e_full = self.sim.prefill_cost(tau, batch=1, freq_scale=s)
        t_base, e_base = self.sim.prefill_cost(base, batch=1, freq_scale=s)
        t, e = self._stretched(t_full - t_base, e_full - e_base)
        self._set_state(ACTIVE, now)
        self._charge([m], t, e, kind="restore", start_s=now, scale=s)
        self.n_restores += 1
        self._restore_member = m
        self._restore_charge = e + self.sim.host_power_w * t
        self._phase_members = [m]
        self._phase_steps = 0
        self._phase_kind = "restore"
        self._phase_start_s = now
        self._phase_scale = s
        self._phase_end_s = now + t
        if self.telemetry is not None:
            self.telemetry.on_restore(self, tau, base, s)
        return self._phase_end_s

    def _waste_restore(self, now: float) -> None:
        """A crash quantized to the restore settle: the re-run suffix
        dies with the node (charge moves busy → wasted) and the member —
        still holding its durable checkpoint — goes back to the suspended
        queue as a prefill refugee for the sim loop to re-dispatch."""
        m = self._restore_member
        charge = self._restore_charge
        m.energy_j -= charge
        m.energy_on[self.node_id] -= charge
        self.suspended.append(m)
        self.book_waste(charge)
        self._restore_member = None
        self._restore_charge = 0.0
        self._phase_members = []
        self._phase_kind = None
        self._phase_end_s = None
        self._complete_crash(now)

    # --- decode-boundary preemption ------------------------------------
    def _decode_time_at(self, n_steps: int) -> float:
        """Closed-form time of the running segment truncated to n_steps
        (memoized — the binary search below costs O(log n) cached evals)."""
        t, _ = self.sim.decode_cost(self._phase_base, n_steps,
                                    batch=len(self._phase_members),
                                    freq_scale=self._phase_scale)
        return t

    def _segment_time_at(self, n_steps: int) -> float:
        """Wall time of the running segment truncated to n_steps — the
        closed form under the phase's straggler stretch (what elapsed
        simulation time actually compares against)."""
        return self._phase_stretch * self._decode_time_at(n_steps)

    def preempt_decode(self, request_id: int, now: float
                       ) -> tuple[str, float] | None:
        """Ask to evict `request_id` from the running decode segment at the
        next step boundary ≥ `now` (the in-flight token always finishes —
        nothing is re-run, so the energy split is exact).  Returns the
        (EventKind.PREEMPT_END, settle_s) event, or None when there is
        nothing to
        preempt: not mid-decode, a preemption already pending, the victim
        is not an active member, or the segment ends before another step
        boundary anyway.  The already-scheduled segment-end event is
        invalidated by bumping the phase epoch."""
        if not self.in_decode or self.preempt_pending:
            return None
        member = next((m for m in self.active
                       if m.req.request_id == request_id), None)
        if member is None:
            return None
        lo = self._boundary_at(now)
        if lo >= self._phase_steps:
            return None                    # segment finishing anyway
        self._preempt_steps = lo
        self._preempt_victims = [member]
        self._phase_epoch += 1             # stale segment-end event dies
        self._phase_end_s = self._phase_start_s + self._segment_time_at(lo)
        return (_PREEMPT, self._phase_end_s)

    def _boundary_at(self, now: float) -> int:
        """Smallest n with wall-time(n) >= now − phase start: the boundary
        of the token in flight at `now` (never in the past — causality
        holds exactly; stretched segments search the stretched clock)."""
        elapsed = now - self._phase_start_s
        lo, hi = 0, self._phase_steps
        while lo < hi:
            mid = (lo + hi) // 2
            if self._segment_time_at(mid) >= elapsed:
                hi = mid
            else:
                lo = mid + 1
        return lo

    def on_preempt_end(self, now: float) -> tuple[str, float] | None:
        """Settle a truncated decode segment at its preemption boundary:
        charge exactly the steps that ran (closed form over [0, n_done) —
        the first half of the split whose two parts sum to the unpreempted
        `decode_cost` to 1e-9), advance every member's KV position, move
        the victims to the suspended set, and start the next phase (which
        admits the waiting arrival the preemption made room for)."""
        assert self._preempt_steps is not None and self.in_decode
        n_done = self._preempt_steps
        t_done, e_done = self.sim.decode_cost(
            self._phase_base, n_done, batch=len(self._phase_members),
            freq_scale=self._phase_scale)
        t_done, e_done = self._stretched(t_done, e_done)
        self._charge(self._phase_members, t_done, e_done, kind="decode",
                     start_s=self._phase_start_s, scale=self._phase_scale)
        if self.telemetry is not None:
            self.telemetry.on_preempt_split(
                self, self._phase_base, n_done, self._phase_steps,
                len(self._phase_members), self._phase_scale)
        for m in self._phase_members:
            m.generated += n_done
        # n_done < n_steps = min remaining, so nobody can have completed
        assert all(m.remaining > 0 for m in self._phase_members)
        for victim in self._preempt_victims:
            self.active.remove(victim)
            victim.preemptions += 1
            self.suspended.append(victim)
            self.n_preemptions += 1
        self._preempt_steps = None
        self._preempt_victims = []
        self._phase_members = []
        self._phase_steps = 0
        self._phase_kind = None
        self._phase_end_s = None
        if self._crash_pending:   # crash arrived while the settle was due
            self._complete_crash(now)
            return None
        return self._phase_event(self._start_phase(now))

    # --- faults: crash, recovery, migration, waste ---------------------
    def begin_crash(self, now: float) -> tuple[str, float] | None:
        """The node fails at `now`, quantized to the next exact charge
        boundary so the dying node's last settlement stays a closed-form
        charge:

          * off-phase — immediate (nothing in flight; state goes FAILED
            right here and the caller rescues `suspended`/`waiting`);
          * mid-decode — the in-flight token finishes: returns a
            (EventKind.CRASH_END, settle_s) event for the truncated-segment
            boundary
            (the same binary search preemption uses), invalidating the
            scheduled segment end via the phase epoch;
          * mid-prefill, with a preemption already pending, or with the
            decode at its natural boundary anyway — the crash lands at
            the already-scheduled settle (`on_phase_end`/`on_preempt_end`
            complete it), so no new event is needed.

        Callers detect the immediate case via `self.failed`."""
        if self._pstate == FAILED or self._crash_pending:
            return None
        self._crash_pending = True
        if not self.busy:
            self._complete_crash(now)
            return None
        if self._phase_kind == "decode" and not self.preempt_pending:
            lo = self._boundary_at(now)
            if lo < self._phase_steps:
                self._crash_steps = lo
                self._phase_epoch += 1     # stale segment-end event dies
                self._phase_end_s = (self._phase_start_s
                                     + self._segment_time_at(lo))
                return (_CRASH, self._phase_end_s)
        return None

    def on_crash_settle(self, now: float) -> None:
        """Settle the truncated decode segment at the crash boundary —
        the donor's half of the cross-node split contract: charged via
        the same closed-form split as a preemption (audited through the
        same `on_preempt_split` hook) — then complete the crash."""
        assert self._crash_steps is not None and self.in_decode
        n_done = self._crash_steps
        t_done, e_done = self.sim.decode_cost(
            self._phase_base, n_done, batch=len(self._phase_members),
            freq_scale=self._phase_scale)
        t_done, e_done = self._stretched(t_done, e_done)
        self._charge(self._phase_members, t_done, e_done, kind="decode",
                     start_s=self._phase_start_s, scale=self._phase_scale)
        if self.telemetry is not None:
            self.telemetry.on_preempt_split(
                self, self._phase_base, n_done, self._phase_steps,
                len(self._phase_members), self._phase_scale)
        for m in self._phase_members:
            m.generated += n_done
        assert all(m.remaining > 0 for m in self._phase_members)
        self._crash_steps = None
        self._complete_crash(now)

    def _complete_crash(self, now: float) -> None:
        """The quantized crash instant: every active member joins the
        suspended set (KV position and accrued energy intact — they are
        the refugees the sim loop migrates or abandons), all phase state
        clears, every stale heap event for this node dies with the epoch
        bump, and the node draws 0 W until its recovery event."""
        for m in self.active:
            self.suspended.append(m)
        self.active = []
        self._phase_members = []
        self._phase_steps = 0
        self._phase_kind = None
        self._phase_end_s = None
        self._preempt_steps = None
        self._preempt_victims = []
        self._clear_chunk_state()
        self._restore_member = None
        self._restore_charge = 0.0
        self._cache_invalidate(now)
        self._phase_epoch += 1
        self._crash_pending = False
        self._set_state(FAILED, now)
        self.n_crashes += 1

    def recover(self, now: float) -> tuple[str, float] | None:
        """The recovery event: FAILED → IDLE, serving whatever queued
        (the sim drains waiting/suspended at crash time, so normally
        nothing — the node simply rejoins the eligible set)."""
        assert self._pstate == FAILED, f"recover from {self._pstate}"
        self._set_state(IDLE, now)
        self.n_recoveries += 1
        return self._phase_event(self._start_phase(now))

    def book_waste(self, e_j: float) -> None:
        """Move `e_j` joules of lost work from the busy bucket to the
        wasted bucket (a *move*, not a new charge: total energy is
        unchanged and the fleet invariant 'attributed energy of completed
        requests == Σ busy' stays exact)."""
        self.busy_energy_j -= e_j
        self.wasted_energy_j += e_j
        if self.telemetry is not None:
            self.telemetry.on_waste(self, e_j)

    def book_shipping(self, ship_s: float, ship_j: float) -> None:
        """Meter an inbound KV shipment (the recipient pulls over its
        interconnect: bytes/ici_bw seconds at j_per_byte_ici, billed by
        the sim loop).  Background NIC DMA — concurrent with serving, so
        the seconds stay outside the horizon partition."""
        self.shipping_s += ship_s
        self.shipping_energy_j += ship_j

    def receive_migrant(self, member: _InFlight, now: float
                        ) -> tuple[str, float] | None:
        """A shipped refugee lands (its KV just finished transferring):
        it joins the suspended set and resumes for free at the next phase
        start with a spare slot — exactly the preemption resume path, now
        crossing nodes.  Mirrors `enqueue`'s power handling: a gated
        recipient wakes on demand."""
        assert self._pstate != FAILED, "migrant shipped to a failed node"
        self.suspended.append(member)
        member.migrations += 1
        self.n_migrations_in += 1
        if self._pstate == GATED:
            return (_WAKE, self.begin_wake(now))
        if self._pstate in (WAKING, GATING) or self.busy:
            return None
        return self._phase_event(self._start_phase(now))
