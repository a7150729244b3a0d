"""Port copy of `repro.obs.telemetry`, numpy only, with its imports renamed;
tests/test_torch_obs.py holds it to the reference.

The telemetry facade: one object the cluster stack reports into.

A :class:`Telemetry` bundles the three observability components —

  * a :class:`~repro_torch.obs.metrics.MetricsRegistry` (always present),
  * an optional :class:`~repro_torch.obs.tracing.EventTracer`,
  * an optional :class:`~repro_torch.obs.audit.InvariantAuditor`,

— behind the narrow hook surface the instrumented code calls
(`on_arrival`, `on_phase_settle`, `on_power_span`, `on_completion`, ...).
Hooks are **read-only observers**: they never mutate node, policy or
event-loop state, touch no RNG, and do no float arithmetic that feeds
back into the simulation, which is what makes the telemetry-on vs
telemetry-off ClusterReport byte-identity a structural guarantee rather
than a tested accident (it is also tested — tests/test_obs.py and the
perf-suite `metrics_overhead` gate).

Lifecycle: one Telemetry per `simulate_cluster` call (like autoscalers
and preempters, it holds per-run state); `attach` raises on reuse.
`sample_every_s` enables periodic time-series sampling of queue depth,
batch occupancy and per-bucket energy inside the event loop (None — the
default — disables sampling; hooks alone are cheap enough for the
metrics_overhead gate's budget, sampling cost scales with the chosen period)."""

from __future__ import annotations

from typing import Sequence

from repro_torch.obs.audit import InvariantAuditor
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.tracing import EventTracer


class Telemetry:
    """Streaming metrics + tracing + auditing for one simulation run."""

    def __init__(self, *, registry: MetricsRegistry | None = None,
                 tracer: EventTracer | None = None,
                 auditor: InvariantAuditor | None = None,
                 sample_every_s: float | None = None):
        if sample_every_s is not None and sample_every_s <= 0:
            raise ValueError("sample_every_s must be > 0 (or None)")
        self.registry = registry if registry is not None else MetricsRegistry()
        self.tracer = tracer
        self.auditor = auditor
        self.sample_every_s = sample_every_s
        self._attached = False

    # ------------------------------------------------------------------
    def attach(self, nodes: Sequence, policy, trace, zeta: float) -> None:
        """Declare the metric families and name the trace tracks.  Called
        once by `simulate_cluster`; a Telemetry accumulates per-run state,
        so reuse across runs is an error (fresh one per run, like
        autoscalers)."""
        if self._attached:
            raise ValueError(
                "Telemetry objects are single-run (their registries and "
                "auditors accumulate); build a fresh one per simulate_cluster")
        self._attached = True
        r = self.registry
        node_model = ("node", "model")
        # counters — the live event stream
        self._arrivals = r.counter(
            "sim_arrivals_total", "requests routed, by destination node",
            node_model)
        self._completions = r.counter(
            "sim_completions_total", "requests completed", node_model)
        self._phases = r.counter(
            "sim_phases_total", "phase settlements",
            ("node", "model", "phase"))
        self._routes = r.counter(
            "sim_routing_decisions_total", "router picks, by policy",
            ("policy", "node"))
        self._preempt_considered = r.counter(
            "sim_preempt_considered_total",
            "preemption checks at arrivals", ("policy",))
        self._preempt_fired = r.counter(
            "sim_preempt_fired_total", "preemptions requested", ("policy",))
        self._wakes = r.counter("sim_wakes_total", "node wake transitions",
                                ("node",))
        self._gates = r.counter("sim_gates_total", "node gate transitions",
                                ("node",))
        self._prewakes = r.counter(
            "sim_autoscaler_prewakes_total",
            "proactive wakes requested by the autoscaler", ("policy",))
        self._gate_decisions = r.counter(
            "sim_autoscaler_gate_decisions_total",
            "idle-timer gate verdicts", ("policy", "verdict"))
        self._dvfs = r.counter(
            "sim_dvfs_choice_total", "operating-point picks per phase",
            ("node", "phase", "scale"))
        self._faults = r.counter(
            "sim_faults_total", "injected fault events applied",
            ("node", "kind"))
        self._migrations = r.counter(
            "sim_migrations_total", "cross-node KV shipments",
            ("src", "dst"))
        self._retries = r.counter(
            "sim_retries_total", "re-routes of displaced/backed-off "
            "requests, by destination node", ("node",))
        self._abandons = r.counter(
            "sim_abandons_total", "requests the fleet gave up on",
            ("reason",))
        self._drains = r.counter(
            "sim_drain_transitions_total", "straggler-governance drain "
            "starts/stops", ("node", "action"))
        self._checkpoints = r.counter(
            "sim_checkpoints_total", "prefill-KV checkpoint persists",
            ("node",))
        self._restores = r.counter(
            "sim_restores_total", "checkpoint-restore phases begun",
            ("node",))
        self._domain_outages = r.counter(
            "sim_domain_outages_total",
            "correlated fault batches (simultaneous crash groups)", ())
        self._cache_hits = r.counter(
            "sim_cache_hits_total",
            "KV prefix-cache hits at request admission", ("node",))
        self._cache_misses = r.counter(
            "sim_cache_misses_total",
            "KV prefix-cache misses at request admission "
            "(session requests only)", ("node",))
        self._cache_evictions = r.counter(
            "sim_cache_evictions_total",
            "LRU prefix-cache entry evictions", ("node",))
        self._cache_hit_tokens = r.counter(
            "sim_cache_hit_tokens_total",
            "warm prefix tokens reused (reuse depth)", ("node",))
        self._cache_invalidations = r.counter(
            "sim_cache_invalidations_total",
            "crash wipes of a node's resident prefix cache", ("node",))
        # gauges — live fleet state + end-of-run snapshot
        self._queue_depth = r.gauge(
            "sim_queue_depth", "waiting requests per node", ("node",))
        self._batch_occupancy = r.gauge(
            "sim_batch_occupancy", "active batch members per node", ("node",))
        self._bucket_energy = r.gauge(
            "sim_node_energy_joules",
            "per-node energy by accounting bucket", ("node", "bucket"))
        self._bucket_seconds = r.gauge(
            "sim_node_seconds", "per-node horizon split by bucket",
            ("node", "bucket"))
        self._pred_err = r.gauge(
            "sim_tau_out_prediction_abs_error",
            "last |τ̂out − τout| per model (predictor policies)",
            ("policy", "model"))
        # histograms — the quantile surface
        self._h_latency = r.histogram(
            "sim_request_latency_seconds", "arrival → finish", ("model",))
        self._h_queue = r.histogram(
            "sim_request_queue_seconds", "arrival → first service",
            ("model",))
        self._h_slowdown = r.histogram(
            "sim_request_slowdown", "latency / isolated runtime", ("model",))
        self._h_energy = r.histogram(
            "sim_request_energy_joules", "attributed busy energy per request",
            ("model",))
        self._h_phase_s = r.histogram(
            "sim_phase_seconds", "settled phase durations",
            ("node", "model", "phase"))
        self._h_outage_size = r.histogram(
            "sim_domain_outage_size",
            "nodes killed per correlated fault batch")
        # Pre-resolve the hot-path children once per node: hooks fire per
        # event, and `labels()` stringifies its key on every call — caching
        # the child objects here keeps the instrumented run inside the
        # perf-suite metrics_overhead budget.  (Side effect: per-node series
        # exist from t=0 with value 0, which is standard Prometheus
        # practice anyway.)
        self._node_ch: dict[int, dict] = {}
        self._lazy_ch: dict[tuple, object] = {}
        pol = policy.name
        for n in nodes:
            nid, model = n.node_id, n.model_name
            self._node_ch[nid] = {
                "arrival": self._arrivals.labels(nid, model),
                "route": self._routes.labels(pol, nid),
                "completion": self._completions.labels(nid, model),
                "phase_c": {k: self._phases.labels(nid, model, k)
                            for k in ("prefill", "decode", "restore")},
                "phase_h": {k: self._h_phase_s.labels(nid, model, k)
                            for k in ("prefill", "decode", "restore")},
                "h_latency": self._h_latency.labels(model),
                "h_queue": self._h_queue.labels(model),
                "h_slowdown": self._h_slowdown.labels(model),
                "h_energy": self._h_energy.labels(model),
                "wake": self._wakes.labels(nid),
                "gate": self._gates.labels(nid),
                "queue_depth": self._queue_depth.labels(nid),
                "batch_occ": self._batch_occupancy.labels(nid),
                "track": f"node{nid}",
            }
        if self.tracer is not None:
            self.tracer.thread_name(0, "cluster")
            for n in nodes:
                self.tracer.thread_name(
                    n.node_id + 1, f"node{n.node_id}:{n.model_name}")

    def _lazy(self, fam, *key):
        """Cached child lookup for the cooler paths whose label values are
        not known at attach time (DVFS scales, autoscaler verdicts, ...)."""
        k = (fam.name,) + key
        child = self._lazy_ch.get(k)
        if child is None:
            child = self._lazy_ch[k] = fam.labels(*key)
        return child

    # --- event-loop hooks (called by repro_torch.cluster.sim) ----------------
    def on_arrival(self, req, policy_name: str, nid: int, model: str,
                   now: float) -> None:
        ch = self._node_ch[nid]
        ch["arrival"].inc()
        ch["route"].inc()
        if self.tracer is not None:
            self.tracer.instant("arrival", now, nid + 1, "arrival",
                                ("request", req.request_id,
                                 "tau_in", req.tau_in))

    def on_preempt_decision(self, policy_name: str, fired: bool) -> None:
        self._lazy(self._preempt_considered, policy_name).inc()
        if fired:
            self._lazy(self._preempt_fired, policy_name).inc()

    def on_prewake(self, policy_name: str, n: int) -> None:
        if n:
            self._lazy(self._prewakes, policy_name).inc(n)

    def on_gate_decision(self, policy_name: str, gated: bool) -> None:
        self._lazy(self._gate_decisions, policy_name,
                   "gate" if gated else "decline").inc()

    def on_completion(self, rec, now: float) -> None:
        ch = self._node_ch[rec.node_id]
        ch["completion"].inc()
        ch["h_latency"].observe(rec.latency_s)
        ch["h_queue"].observe(rec.queue_s)
        ch["h_slowdown"].observe(rec.slowdown)
        ch["h_energy"].observe(rec.energy_j)
        if self.tracer is not None:
            self.tracer.instant("completion", now, rec.node_id + 1,
                                "completion",
                                ("request", rec.request_id,
                                 "tau_out", rec.tau_out,
                                 "preemptions", rec.preemptions))

    def sample(self, nodes: Sequence, now: float) -> None:
        """Periodic time series: queue depth, batch occupancy, per-bucket
        energy so far — gauges for scraping, counter tracks for the trace."""
        for n in nodes:
            ch = self._node_ch[n.node_id]
            ch["queue_depth"].set(len(n.waiting))
            ch["batch_occ"].set(len(n.active))
            if self.tracer is not None:
                track = ch["track"]
                self.tracer.counter(
                    track, now,
                    ("queue", len(n.waiting), "batch", len(n.active)),
                    n.node_id + 1)
                self.tracer.counter(
                    track + "_energy_j", now,
                    ("busy", n.busy_energy_j, "idle", n.idle_energy_j,
                     "gated", n.gated_energy_j,
                     "transition", n.transition_energy_j),
                    n.node_id + 1)

    # --- node hooks (called by repro_torch.cluster.node) ----------------------
    def on_phase_settle(self, node, kind: str, start_s: float, t: float,
                        e_total: float, batch: int, scale: float) -> None:
        ch = self._node_ch[node.node_id]
        ch["phase_c"][kind].inc()
        ch["phase_h"][kind].observe(t)
        self._lazy(self._dvfs, node.node_id, kind, scale).inc()
        if self.tracer is not None:
            self.tracer.complete(kind, start_s, t, node.node_id + 1,
                                 "phase", ("batch", batch,
                                           "energy_j", e_total,
                                           "scale", scale))
        if self.auditor is not None:
            self.auditor.on_settle(node, kind, start_s, t, e_total)

    def on_preempt_split(self, node, base: int, n_done: int, n_total: int,
                         batch: int, scale: float) -> None:
        if self.tracer is not None:
            self.tracer.instant("preempt", node.phase_end_s or 0.0,
                                node.node_id + 1, "preempt",
                                ("n_done", n_done, "n_total", n_total))
        if self.auditor is not None:
            self.auditor.on_preempt_split(node, base, n_done, n_total,
                                          batch, scale)

    def on_power_begin(self, node, kind: str, now: float) -> None:
        self._node_ch[node.node_id][kind].inc()

    def on_checkpoint(self, node, new_tokens: int, n_bytes: float,
                      ckpt_s: float, ckpt_j: float, n_members: int) -> None:
        """A chunk boundary durably persisted `new_tokens` of fresh KV
        prefix across `n_members` batch members (the chunk itself settles
        through on_phase_settle; this hook carries the persistence cost)."""
        self._lazy(self._checkpoints, node.node_id).inc(n_members)
        if self.tracer is not None:
            self.tracer.instant("checkpoint", node.phase_end_s or 0.0,
                                node.node_id + 1, "checkpoint",
                                ("tokens", new_tokens, "bytes", n_bytes,
                                 "energy_j", ckpt_j, "members", n_members))
        if self.auditor is not None:
            self.auditor.on_checkpoint(node, new_tokens, n_bytes,
                                       ckpt_s, ckpt_j, n_members)

    def on_restore(self, node, tau_in: int, base: int,
                   scale: float) -> None:
        """A prefill refugee began its batch-1 restore phase (fired at
        phase start, right after the charge lands, so the auditor can
        cross-check the suffix cost against the just-settled charge)."""
        self._lazy(self._restores, node.node_id).inc()
        if self.auditor is not None:
            self.auditor.on_restore(node, tau_in, base, scale)

    # --- prefix-cache hooks (called by repro_torch.cluster.node) --------------
    def on_cache_lookup(self, node, req, hit_tokens: int) -> None:
        """A session request hit the admission boundary: `hit_tokens` of
        its shared prefix were warm (0 ⇒ miss)."""
        if hit_tokens > 0:
            self._lazy(self._cache_hits, node.node_id).inc()
            self._lazy(self._cache_hit_tokens,
                       node.node_id).inc(hit_tokens)
        else:
            self._lazy(self._cache_misses, node.node_id).inc()

    def on_cache_hit(self, node, tau_in: int, cached: int, n_bytes: float,
                     read_s: float, read_j: float, scale: float) -> None:
        """A warm-prefix batch-1 prefill began (fired at phase start,
        right after the charge lands, like on_restore): the suffix charge
        and the closed-form cache-read term are both auditable here."""
        if self.tracer is not None:
            self.tracer.instant("cache_hit", node.phase_end_s or 0.0,
                                node.node_id + 1, "cache",
                                ("tau_in", tau_in, "cached", cached,
                                 "bytes", n_bytes, "energy_j", read_j))
        if self.auditor is not None:
            self.auditor.on_cache_hit(node, tau_in, cached, n_bytes,
                                      read_s, read_j, scale)

    def on_cache_evict(self, node, session_id: int,
                       reserved_tokens: int) -> None:
        self._lazy(self._cache_evictions, node.node_id).inc()
        if self.tracer is not None:
            self.tracer.instant("cache_evict", node.phase_end_s or 0.0,
                                node.node_id + 1, "cache",
                                ("session", session_id,
                                 "tokens", reserved_tokens))

    def on_cache_invalidate(self, node, n_entries: int, now: float) -> None:
        self._lazy(self._cache_invalidations, node.node_id).inc()
        if self.tracer is not None:
            self.tracer.instant("cache_invalidate", now, node.node_id + 1,
                                "cache", ("entries", n_entries))

    # --- fault/rescue hooks (called by repro_torch.cluster.sim) ---------------
    def on_fault(self, event, node, now: float) -> None:
        self._lazy(self._faults, event.node_id, event.kind).inc()
        if self.tracer is not None:
            self.tracer.instant(event.kind, now, event.node_id + 1, "fault",
                                ("value", event.value))

    def on_migration(self, home, recipient, context: int, n_bytes: float,
                     ship_s: float, ship_j: float, now: float) -> None:
        self._lazy(self._migrations, home.node_id, recipient.node_id).inc()
        if self.tracer is not None:
            self.tracer.complete("kv_ship", now, ship_s,
                                 recipient.node_id + 1, "migration",
                                 ("from", home.node_id, "context", context,
                                  "bytes", n_bytes, "energy_j", ship_j))
        if self.auditor is not None:
            self.auditor.on_migration(home, recipient, context, n_bytes,
                                      ship_s, ship_j)

    def on_domain_outage(self, now: float, size: int) -> None:
        """A batch of simultaneous crash events finished applying: one
        correlated outage of `size` nodes (size 1 for independent faults
        — the degenerate one-node-per-domain topology)."""
        self._domain_outages.get().inc()
        self._h_outage_size.get().observe(size)
        if self.tracer is not None:
            self.tracer.instant("domain_outage", now, 0, "fault",
                                ("size", size))

    def on_retry(self, req, nid: int, attempts: int, now: float) -> None:
        self._lazy(self._retries, nid).inc()
        if self.tracer is not None:
            self.tracer.instant("retry", now, nid + 1, "retry",
                                ("request", req.request_id,
                                 "attempts", attempts))

    def on_abandon(self, rec, now: float) -> None:
        self._lazy(self._abandons, rec.reason).inc()
        if self.tracer is not None:
            self.tracer.instant("abandon", now, 0, "abandon",
                                ("request", rec.request_id,
                                 "reason", rec.reason,
                                 "wasted_j", rec.wasted_j))

    def on_drain(self, node, draining: bool, now: float) -> None:
        self._lazy(self._drains, node.node_id,
                   "drain" if draining else "undrain").inc()
        if self.tracer is not None:
            self.tracer.instant("drain" if draining else "undrain", now,
                                node.node_id + 1, "drain")

    def on_waste(self, node, e_j: float) -> None:
        if self.auditor is not None:
            self.auditor.on_waste(node, e_j)

    def on_power_span(self, node, kind: str, start_s: float,
                      end_s: float) -> None:
        if self.tracer is not None:
            self.tracer.complete(kind, start_s, end_s - start_s,
                                 node.node_id + 1, "power")

    # --- policy hooks (called by repro_torch.cluster.policies) ----------------
    def on_prediction_error(self, policy_name: str, model: str,
                            predicted: float, actual: int) -> None:
        self._lazy(self._pred_err, policy_name, model).set(
            abs(predicted - float(actual)))

    # --- end of run -----------------------------------------------------
    def finalize(self, nodes: Sequence, report) -> None:
        """Write the end-of-run snapshot gauges (the aggregate view
        ClusterReport.from_registry rebuilds) and close the audit."""
        for n in report.node_stats:
            for bucket, e_j, secs in (
                    ("busy", n.busy_energy_j, n.busy_s),
                    ("idle", n.idle_energy_j, n.idle_s),
                    ("gated", n.gated_energy_j, n.gated_s),
                    ("transition", n.transition_energy_j, n.transition_s),
                    ("shipping", n.shipping_energy_j, n.shipping_s),
                    ("checkpoint", n.checkpoint_energy_j, n.checkpoint_s),
                    ("cache_read", n.cache_read_energy_j, n.cache_read_s),
                    ("wasted", n.wasted_energy_j, None),
                    ("failed", None, n.failed_s)):
                if e_j is not None:
                    self._bucket_energy.labels(n.node_id, bucket).set(e_j)
                if secs is not None:
                    self._bucket_seconds.labels(n.node_id, bucket).set(secs)
        r = self.registry
        # run-level gauges merge by max: every per-node partition of a
        # sharded run writes the same values, so the fold is idempotent
        info = r.gauge("sim_run_info", "run identity (always 1)",
                       ("policy",), merge="max")
        info.labels(report.policy).set(1)
        r.gauge("sim_zeta", "Eq. 2 tradeoff weight",
                merge="max").get().set(report.zeta)
        r.gauge("sim_makespan_seconds", "trace horizon",
                merge="max").get().set(report.makespan_s)
        r.gauge("sim_objective", "realized Eq. 2 objective",
                merge="max").get().set(report.objective)
        r.gauge("sim_predicted_energy_joules",
                "Σ e_K(q) under the fitted profiles",
                merge="max").get().set(report.predicted_energy_j)
        served = r.gauge("sim_node_served", "requests served per node",
                         ("node", "model"))
        util = r.gauge("sim_node_utilization", "busy_s / makespan",
                       ("node", "model"), merge="max")
        horizon = r.gauge("sim_node_horizon_seconds",
                          "accounted node horizon", ("node",), merge="max")
        pre = r.gauge("sim_node_preemptions", "preemptions per node",
                      ("node",))
        res = r.gauge("sim_node_resumes", "resumes per node", ("node",))
        wk = r.gauge("sim_node_wakes", "wake transitions per node",
                     ("node",))
        gt = r.gauge("sim_node_gates", "gate transitions per node",
                     ("node",))
        cr = r.gauge("sim_node_crashes", "crashes per node", ("node",))
        rc = r.gauge("sim_node_recoveries", "recoveries per node",
                     ("node",))
        mi = r.gauge("sim_node_migrations_in",
                     "refugee decodes received per node", ("node",))
        mo = r.gauge("sim_node_migrations_out",
                     "refugee decodes shipped away per node", ("node",))
        ck = r.gauge("sim_node_checkpoints",
                     "prefill-KV checkpoint persists per node", ("node",))
        rs = r.gauge("sim_node_restores",
                     "restore phases begun per node", ("node",))
        chh = r.gauge("sim_node_cache_hits",
                      "prefix-cache hits per node", ("node",))
        chm = r.gauge("sim_node_cache_misses",
                      "prefix-cache misses per node", ("node",))
        che = r.gauge("sim_node_cache_evictions",
                      "prefix-cache evictions per node", ("node",))
        cht = r.gauge("sim_node_cache_hit_tokens",
                      "reused warm prefix tokens per node", ("node",))
        for s in report.node_stats:
            served.labels(s.node_id, s.model).set(s.n_served)
            util.labels(s.node_id, s.model).set(s.utilization)
            horizon.labels(s.node_id).set(s.horizon_s)
            pre.labels(s.node_id).set(s.n_preemptions)
            res.labels(s.node_id).set(s.n_resumes)
            wk.labels(s.node_id).set(s.n_wakes)
            gt.labels(s.node_id).set(s.n_gates)
            cr.labels(s.node_id).set(s.n_crashes)
            rc.labels(s.node_id).set(s.n_recoveries)
            mi.labels(s.node_id).set(s.n_migrations_in)
            mo.labels(s.node_id).set(s.n_migrations_out)
            ck.labels(s.node_id).set(s.n_checkpoints)
            rs.labels(s.node_id).set(s.n_restores)
            chh.labels(s.node_id).set(s.n_cache_hits)
            chm.labels(s.node_id).set(s.n_cache_misses)
            che.labels(s.node_id).set(s.n_cache_evictions)
            cht.labels(s.node_id).set(s.cache_hit_tokens)
        if self.auditor is not None:
            self.auditor.on_finalize(nodes, report)

    # --- convenience ----------------------------------------------------
    def prometheus_text(self) -> str:
        return self.registry.prometheus_text()
