"""Port copy of `repro.obs.audit`, numpy only, with its imports renamed;
tests/test_torch_obs.py holds it to the reference.

Live invariant auditing: conservation contracts checked as they accrue.

The repo's two core accounting contracts — the four-bucket
busy/idle/gated/transition energy partition and the split-energy
preemption settlement — were previously gated only at *report* time (perf
suite, tests).  The auditor checks them **incrementally at every
settlement event**, so a violation surfaces at the first settle that
breaks the books, with the recent event context attached, instead of as
an end-of-run aggregate mismatch thousands of events later.

What is re-derived independently (never read back from the quantity it
checks):

  * busy bucket    — the auditor accumulates its own Σ(t, e) over the
    settlement stream and compares against the node's busy_s /
    busy_energy_j after every settle;
  * time partition — after a settle of phase [start, start+t], every
    node second through start+t is accounted: busy_s + idle_s + gated_s
    + transition_s == start + t (prefill charges at phase start, decode
    at settle — both close the books exactly at the segment end);
  * idle / gated / transition buckets — recomputed from first
    principles: idle_s·idle_power_w, gated_s·gated_w, and
    transition_s·transition_w + wakes·wake_j + gates·gate_j (the only
    closed forms those buckets may follow);
  * split-energy contract — at a preemption (or crash-quantization)
    settlement, the truncated charge must equal decode_cost(base,
    n_done) under the phase's straggler stretch transform, and the two
    raw halves must sum to the unpreempted decode_cost(base, n_total),
    both to `tol` (the closed-form additivity identity the perf suite
    gates — linear in t, so it survives stretching);
  * wasted bucket  — `book_waste` is a *move* (busy → wasted), never a
    new charge: the auditor mirrors every booking, checks the node's
    wasted bucket against its own Σ, and keeps the busy drift check
    exact by moving its accumulator in lockstep (gross settlements ==
    busy + wasted at all times);
  * shipping bucket — every KV migration must follow the interconnect
    closed form (bytes == context · kv_bytes_per_token; seconds ==
    bytes / ici_bw; joules == bytes · j_per_byte_ici, all on the
    *recipient's* spec and meter);
  * checkpoint bucket — every durable prefill-KV persist must follow
    its closed form (bytes == new tokens · kv_bytes_per_token; seconds
    == bytes / ckpt_bw; joules == bytes · j_per_byte_ckpt, all on the
    node's CheckpointConfig and meter), and every restore phase's
    charge must equal the telescoping suffix prefill_cost(τin) −
    prefill_cost(ckpt) under the phase's stretch transform;
  * cache_read bucket — every warm-prefix hit must charge the
    telescoping suffix prefill_cost(τin) − prefill_cost(cached) at
    batch 1 (the same identity restores use) and its cache-read term
    must follow the closed form (bytes == cached · kv_bytes_per_token;
    seconds == bytes / read_bw; joules == bytes · j_per_byte_read, all
    on the node's PrefixCacheConfig and meter).

`on_finalize` re-checks the fleet-level books (per-request attributed
energy == Σ busy buckets; horizon == accounted seconds including FAILED
time; wasted and shipping buckets == the audited migration/waste
streams; gross settlements == busy + wasted) once the report exists.
All checks raise :class:`InvariantViolation` with the last few audited
events formatted into the message."""

from __future__ import annotations

from collections import deque


class InvariantViolation(AssertionError):
    """An accounting contract broke; the message carries event context."""


class InvariantAuditor:
    """Incremental checker for the cluster accounting contracts.

    One auditor per simulation run (it accumulates per-node settlement
    totals).  `tol` is the relative tolerance of every check (default the
    repo-wide 1e-9 conservation class)."""

    def __init__(self, tol: float = 1e-9, *, context_events: int = 16):
        if tol <= 0:
            raise ValueError("tol must be > 0")
        self.tol = tol
        self.n_checks = 0
        self._busy_t: dict[int, float] = {}
        self._busy_e: dict[int, float] = {}
        # gross settled joules: never decremented by waste moves, so at
        # any instant gross == busy + wasted per node (leak detector)
        self._gross_e: dict[int, float] = {}
        self._waste_e: dict[int, float] = {}
        self._ship_t: dict[int, float] = {}
        self._ship_e: dict[int, float] = {}
        self._ckpt_t: dict[int, float] = {}
        self._ckpt_e: dict[int, float] = {}
        self._cache_t: dict[int, float] = {}
        self._cache_e: dict[int, float] = {}
        self._last_settle: dict[int, tuple[str, float, float, float]] = {}
        self._context: deque = deque(maxlen=context_events)
        # per-node power constants (idle_w, gated_w, transition_w, wake_j,
        # gate_j), cached on first settle — they are fixed for a node's
        # lifetime and the closed-form re-derivation reads them every event
        self._const: dict[int, tuple[float, float, float, float, float]] = {}
        # last-verified off-phase book signature per node: consecutive busy
        # settles leave the idle/gated/transition buckets untouched, so the
        # closed-form re-check can skip until the books actually move
        self._off_sig: dict[int, tuple] = {}

    # --- helpers ------------------------------------------------------
    def _close(self, a: float, b: float) -> bool:
        return abs(a - b) <= self.tol * max(1.0, abs(a), abs(b))

    def _fail(self, what: str) -> None:
        ctx = "\n  ".join(
            c if isinstance(c, str) else " ".join(map(str, c))
            for c in self._context) or "(no prior events)"
        raise InvariantViolation(
            f"{what}\nrecent audited events:\n  {ctx}")

    def note(self, desc) -> None:
        """Fold an event description into the context ring buffer: a
        string, or a flat tuple of fields formatted lazily — the hot
        settlement path stores tuples so no string work happens unless a
        check actually fails."""
        self._context.append(desc)

    # --- settlement-time checks ---------------------------------------
    def on_settle(self, node, kind: str, start_s: float, t: float,
                  e_total: float) -> None:
        """Audit one phase settlement (prefill charge at phase start,
        decode charge at segment end or preemption boundary)."""
        nid = node.node_id
        self._context.append(("settle", nid, kind, "start", start_s,
                              "t", t, "e", e_total))
        self._busy_t[nid] = bt = self._busy_t.get(nid, 0.0) + t
        self._busy_e[nid] = be = self._busy_e.get(nid, 0.0) + e_total
        self._gross_e[nid] = self._gross_e.get(nid, 0.0) + e_total
        self._last_settle[nid] = (kind, start_s, t, e_total)
        self.n_checks += 1
        # inlined `_close` — this path runs at every settlement
        tol, nb, ne = self.tol, node.busy_s, node.busy_energy_j
        if abs(bt - nb) > tol * max(1.0, abs(bt), abs(nb)):
            self._fail(f"busy-time drift on node {nid}: settlements sum to "
                       f"{bt!r} s but node.busy_s == {nb!r}")
        if abs(be - ne) > tol * max(1.0, abs(be), abs(ne)):
            self._fail(f"busy-energy drift on node {nid}: settlements sum "
                       f"to {be!r} J but node.busy_energy_j == {ne!r}")
        # the time partition: every second through this settle's segment
        # end lands in exactly one bucket
        end_s = start_s + t
        acc = node.accounted_s
        if abs(acc - end_s) > tol * max(1.0, abs(acc), abs(end_s)):
            self._fail(f"time-partition violation on node {nid} at "
                       f"{kind} settle: accounted_s == {acc!r} but the "
                       f"settled segment ends at {end_s!r}")
        # off-phase books only move on power transitions; skip the
        # closed-form re-derivation while the signature is unchanged
        sig = (node.idle_s, node.idle_energy_j, node.gated_s,
               node.gated_energy_j, node.transition_s,
               node.transition_energy_j, node.n_wakes, node.n_gates)
        if self._off_sig.get(nid) != sig:
            self._check_offphase_buckets(node)
            self._off_sig[nid] = sig

    def _check_offphase_buckets(self, node) -> None:
        """idle/gated/transition energies must follow their closed forms —
        catches double-charging (e.g. gated seconds billed as idle)."""
        nid = node.node_id
        cst = self._const.get(nid)
        if cst is None:
            cst = self._const[nid] = (
                node.idle_power_w, node.power.gated_w,
                node.transition_power_w, node.power.wake_j,
                node.power.gate_j)
        idle_w, gated_w, trans_w, wake_j, gate_j = cst
        if not self._close(node.idle_energy_j, node.idle_s * idle_w):
            self._fail(f"idle bucket off closed form on node {nid}: "
                       f"{node.idle_energy_j!r} J over {node.idle_s!r} s "
                       f"at {idle_w!r} W")
        if not self._close(node.gated_energy_j, node.gated_s * gated_w):
            self._fail(f"gated bucket off closed form on node {nid}: "
                       f"{node.gated_energy_j!r} J over {node.gated_s!r} s "
                       f"at {gated_w!r} W")
        expect_trans = (node.transition_s * trans_w
                        + node.n_wakes * wake_j + node.n_gates * gate_j)
        if not self._close(node.transition_energy_j, expect_trans):
            self._fail(f"transition bucket off closed form on node {nid}: "
                       f"{node.transition_energy_j!r} J vs expected "
                       f"{expect_trans!r}")

    def on_preempt_split(self, node, base: int, n_done: int, n_total: int,
                         batch: int, scale: float) -> None:
        """Audit the split-energy contract right after a truncated decode
        settled (a preemption boundary or a crash quantization — both
        charge through the same path): the charge must equal the
        closed-form integral over [0, n_done) under the phase's straggler
        stretch, and the two raw halves of the split must sum to the
        unpreempted decode_cost."""
        nid = node.node_id
        self.note(("preempt-split", nid, "base", base, "n_done", n_done,
                   "n_total", n_total, "batch", batch, "scale", scale))
        self.n_checks += 1
        last = self._last_settle.get(nid)
        if last is None:
            self._fail(f"preemption settled on node {nid} with no prior "
                       f"settlement event")
        _, _, t_charged, e_charged = last
        t1, e1 = node.sim.decode_cost(base, n_done, batch=batch,
                                      freq_scale=scale)
        # the stretch transform (t, e) → (σ·t, e + (σ−1)·t·static) the
        # node applied to the truncated charge, re-derived independently
        sigma = node.phase_stretch
        t1s = sigma * t1
        e1s = e1 + (sigma - 1.0) * t1 * node.accel_static_w
        e1_total = e1s + node.sim.host_power_w * t1s
        if not (self._close(t_charged, t1s)
                and self._close(e_charged, e1_total)):
            self._fail(
                f"preemption charge mismatch on node {nid}: settled "
                f"(t={t_charged!r}, e={e_charged!r}) but decode_cost"
                f"({base}, {n_done}) at stretch {sigma!r} gives "
                f"(t={t1s!r}, e={e1_total!r})")
        t2, e2 = node.sim.decode_cost(base + n_done, n_total - n_done,
                                      batch=batch, freq_scale=scale)
        tf, ef = node.sim.decode_cost(base, n_total, batch=batch,
                                      freq_scale=scale)
        if not (self._close(t1 + t2, tf) and self._close(e1 + e2, ef)):
            self._fail(
                f"split-energy contract violated on node {nid}: "
                f"decode_cost({base},{n_done}) + decode_cost"
                f"({base + n_done},{n_total - n_done}) != decode_cost"
                f"({base},{n_total}): t {t1 + t2!r} vs {tf!r}, "
                f"e {e1 + e2!r} vs {ef!r}")

    # --- fault-path checks --------------------------------------------
    def on_waste(self, node, e_j: float) -> None:
        """Audit a `book_waste` move (busy → wasted, booked on the node
        that actually spent the joules): mirror it into the auditor's
        accumulators — the busy drift check stays exact because the move
        is applied to both sides — and re-check the node's wasted bucket
        against the audited stream."""
        nid = node.node_id
        self.note(("waste", nid, "e", e_j))
        self.n_checks += 1
        if e_j < 0.0:
            self._fail(f"negative waste booking on node {nid}: {e_j!r} J")
        self._busy_e[nid] = self._busy_e.get(nid, 0.0) - e_j
        self._waste_e[nid] = we = self._waste_e.get(nid, 0.0) + e_j
        nw = node.wasted_energy_j
        if not self._close(we, nw):
            self._fail(f"wasted-energy drift on node {nid}: bookings sum "
                       f"to {we!r} J but node.wasted_energy_j == {nw!r}")
        nb, be = node.busy_energy_j, self._busy_e[nid]
        if not self._close(be, nb):
            self._fail(f"waste booking on node {nid} broke the busy "
                       f"bucket: settlements − wastes == {be!r} J but "
                       f"node.busy_energy_j == {nb!r}")

    def on_migration(self, home, recipient, context: int, n_bytes: float,
                     ship_s: float, ship_j: float) -> None:
        """Audit one cross-node KV shipment against the interconnect
        closed form — bytes from the *donor's* KV layout at the decode
        boundary, seconds and joules from the *recipient's* spec — and
        the recipient's running shipping meter."""
        from repro_torch.energy.costs import kv_bytes_per_token

        rid = recipient.node_id
        self.note(("migrate", home.node_id, "->", rid, "ctx", context,
                   "bytes", n_bytes, "s", ship_s, "j", ship_j))
        self.n_checks += 1
        expect_bytes = context * kv_bytes_per_token(home.sim.cfg)
        if not self._close(n_bytes, expect_bytes):
            self._fail(f"KV shipment size off closed form: {n_bytes!r} B "
                       f"for {context} tokens but kv_bytes_per_token "
                       f"gives {expect_bytes!r} B")
        accel = recipient.hardware.accel
        if not self._close(ship_s, n_bytes / accel.ici_bw):
            self._fail(f"KV shipping time off closed form on node {rid}: "
                       f"{ship_s!r} s for {n_bytes!r} B over "
                       f"{accel.ici_bw!r} B/s")
        if not self._close(ship_j, n_bytes * accel.j_per_byte_ici):
            self._fail(f"KV shipping energy off closed form on node "
                       f"{rid}: {ship_j!r} J for {n_bytes!r} B at "
                       f"{accel.j_per_byte_ici!r} J/B")
        self._ship_t[rid] = st = self._ship_t.get(rid, 0.0) + ship_s
        self._ship_e[rid] = se = self._ship_e.get(rid, 0.0) + ship_j
        if not (self._close(st, recipient.shipping_s)
                and self._close(se, recipient.shipping_energy_j)):
            self._fail(f"shipping-meter drift on node {rid}: audited "
                       f"(t={st!r}, e={se!r}) but node books "
                       f"(t={recipient.shipping_s!r}, "
                       f"e={recipient.shipping_energy_j!r})")

    def on_checkpoint(self, node, new_tokens: int, n_bytes: float,
                      ckpt_s: float, ckpt_j: float, n_members: int) -> None:
        """Audit one durable prefill-KV persist against the checkpoint
        closed form (bytes from the model's KV layout, seconds and joules
        from the node's CheckpointConfig) and the node's running
        checkpoint meters."""
        from repro_torch.energy.costs import kv_bytes_per_token

        nid = node.node_id
        self.note(("checkpoint", nid, "tokens", new_tokens, "bytes",
                   n_bytes, "s", ckpt_s, "j", ckpt_j,
                   "members", n_members))
        self.n_checks += 1
        if new_tokens <= 0 or n_members <= 0:
            self._fail(f"empty checkpoint persisted on node {nid}: "
                       f"{new_tokens} tokens over {n_members} members")
        expect_bytes = new_tokens * kv_bytes_per_token(node.sim.cfg)
        if not self._close(n_bytes, expect_bytes):
            self._fail(f"checkpoint size off closed form on node {nid}: "
                       f"{n_bytes!r} B for {new_tokens} tokens but "
                       f"kv_bytes_per_token gives {expect_bytes!r} B")
        ck = node.checkpoint
        if not self._close(ckpt_s, n_bytes / ck.ckpt_bw):
            self._fail(f"checkpoint time off closed form on node {nid}: "
                       f"{ckpt_s!r} s for {n_bytes!r} B over "
                       f"{ck.ckpt_bw!r} B/s")
        if not self._close(ckpt_j, n_bytes * ck.j_per_byte_ckpt):
            self._fail(f"checkpoint energy off closed form on node {nid}: "
                       f"{ckpt_j!r} J for {n_bytes!r} B at "
                       f"{ck.j_per_byte_ckpt!r} J/B")
        self._ckpt_t[nid] = ct = self._ckpt_t.get(nid, 0.0) + ckpt_s
        self._ckpt_e[nid] = ce = self._ckpt_e.get(nid, 0.0) + ckpt_j
        if not (self._close(ct, node.checkpoint_s)
                and self._close(ce, node.checkpoint_energy_j)):
            self._fail(f"checkpoint-meter drift on node {nid}: audited "
                       f"(t={ct!r}, e={ce!r}) but node books "
                       f"(t={node.checkpoint_s!r}, "
                       f"e={node.checkpoint_energy_j!r})")

    def on_restore(self, node, tau_in: int, base: int,
                   scale: float) -> None:
        """Audit a restore phase's charge (fired at phase start, right
        after the charge settled): it must equal the telescoping suffix
        prefill_cost(τin) − prefill_cost(base) at batch 1 under the
        phase's straggler stretch — the same identity that makes the
        chunk sum exact, applied to the unfinished remainder."""
        nid = node.node_id
        self.note(("restore", nid, "tau", tau_in, "base", base,
                   "scale", scale))
        self.n_checks += 1
        last = self._last_settle.get(nid)
        if last is None or last[0] != "restore":
            self._fail(f"restore began on node {nid} without a settled "
                       f"restore charge (last settle: {last!r})")
        _, _, t_charged, e_charged = last
        if not 0 < base < tau_in:
            self._fail(f"restore on node {nid} for a non-partial prefill: "
                       f"ckpt {base} of τin {tau_in}")
        t1, e1 = node.sim.prefill_cost(base, batch=1, freq_scale=scale)
        t2, e2 = node.sim.prefill_cost(tau_in, batch=1, freq_scale=scale)
        sigma = node.phase_stretch
        ts = sigma * (t2 - t1)
        es = (e2 - e1) + (sigma - 1.0) * (t2 - t1) * node.accel_static_w
        e_total = es + node.sim.host_power_w * ts
        if not (self._close(t_charged, ts)
                and self._close(e_charged, e_total)):
            self._fail(
                f"restore charge off the telescoping suffix on node "
                f"{nid}: settled (t={t_charged!r}, e={e_charged!r}) but "
                f"prefill_cost({tau_in}) − prefill_cost({base}) at "
                f"stretch {sigma!r} gives (t={ts!r}, e={e_total!r})")

    def on_cache_hit(self, node, tau_in: int, cached: int, n_bytes: float,
                     read_s: float, read_j: float, scale: float) -> None:
        """Audit a warm-prefix batch-1 prefill (fired at phase start,
        right after the charge settled): the suffix charge must equal the
        telescoping difference prefill_cost(τin) − prefill_cost(cached)
        under the phase's stretch — the restore identity, applied to a
        cache hit — and the cache-read term must follow its closed form
        on the node's PrefixCacheConfig and meters."""
        from repro_torch.energy.costs import kv_bytes_per_token

        nid = node.node_id
        self.note(("cache-hit", nid, "tau", tau_in, "cached", cached,
                   "bytes", n_bytes, "s", read_s, "j", read_j,
                   "scale", scale))
        self.n_checks += 1
        last = self._last_settle.get(nid)
        if last is None or last[0] != "prefill":
            self._fail(f"cache-hit prefill began on node {nid} without a "
                       f"settled prefill charge (last settle: {last!r})")
        _, _, t_charged, e_charged = last
        if not 0 < cached < tau_in:
            self._fail(f"cache hit on node {nid} outside (0, τin): "
                       f"{cached} of {tau_in}")
        t1, e1 = node.sim.prefill_cost(cached, batch=1, freq_scale=scale)
        t2, e2 = node.sim.prefill_cost(tau_in, batch=1, freq_scale=scale)
        sigma = node.phase_stretch
        ts = sigma * (t2 - t1)
        es = (e2 - e1) + (sigma - 1.0) * (t2 - t1) * node.accel_static_w
        e_total = es + node.sim.host_power_w * ts
        if not (self._close(t_charged, ts)
                and self._close(e_charged, e_total)):
            self._fail(
                f"cache-hit charge off the telescoping suffix on node "
                f"{nid}: settled (t={t_charged!r}, e={e_charged!r}) but "
                f"prefill_cost({tau_in}) − prefill_cost({cached}) at "
                f"stretch {sigma!r} gives (t={ts!r}, e={e_total!r})")
        expect_bytes = cached * kv_bytes_per_token(node.sim.cfg)
        if not self._close(n_bytes, expect_bytes):
            self._fail(f"cache-read size off closed form on node {nid}: "
                       f"{n_bytes!r} B for {cached} tokens but "
                       f"kv_bytes_per_token gives {expect_bytes!r} B")
        pc = node.prefix_cache
        if not self._close(read_s, n_bytes / pc.read_bw):
            self._fail(f"cache-read time off closed form on node {nid}: "
                       f"{read_s!r} s for {n_bytes!r} B over "
                       f"{pc.read_bw!r} B/s")
        if not self._close(read_j, n_bytes * pc.j_per_byte_read):
            self._fail(f"cache-read energy off closed form on node {nid}: "
                       f"{read_j!r} J for {n_bytes!r} B at "
                       f"{pc.j_per_byte_read!r} J/B")
        self._cache_t[nid] = ct = self._cache_t.get(nid, 0.0) + read_s
        self._cache_e[nid] = ce = self._cache_e.get(nid, 0.0) + read_j
        if not (self._close(ct, node.cache_read_s)
                and self._close(ce, node.cache_read_energy_j)):
            self._fail(f"cache-read-meter drift on node {nid}: audited "
                       f"(t={ct!r}, e={ce!r}) but node books "
                       f"(t={node.cache_read_s!r}, "
                       f"e={node.cache_read_energy_j!r})")

    # --- end-of-run checks --------------------------------------------
    def on_finalize(self, nodes, report) -> None:
        """Close the audit: fleet-level conservation against the report."""
        self.n_checks += 1
        for n in nodes:
            if not self._close(n.accounted_s, n.horizon_s):
                self._fail(f"node {n.node_id} horizon not partitioned: "
                           f"accounted {n.accounted_s!r} s of "
                           f"{n.horizon_s!r} s")
            self._check_offphase_buckets(n)
            nid = n.node_id
            # waste is a move, never a leak: the gross settlement stream
            # must reappear exactly as busy + wasted
            gross = self._gross_e.get(nid, 0.0)
            split = n.busy_energy_j + n.wasted_energy_j
            if not self._close(gross, split):
                self._fail(f"energy leak on node {nid}: settlements sum "
                           f"to {gross!r} J but busy + wasted == "
                           f"{split!r} J")
        attributed = sum(r.energy_j for r in report.records)
        busy = sum(s.busy_energy_j for s in report.node_stats)
        if report.records and not self._close(attributed, busy):
            self._fail(f"attributed per-request energy {attributed!r} J "
                       f"does not sum to the fleet busy bucket {busy!r} J")
        wasted = sum(s.wasted_energy_j for s in report.node_stats)
        if not self._close(wasted, sum(self._waste_e.values())):
            self._fail(f"fleet wasted bucket {wasted!r} J does not match "
                       f"the audited waste stream "
                       f"{sum(self._waste_e.values())!r} J")
        shipping = sum(s.shipping_energy_j for s in report.node_stats)
        if not self._close(shipping, sum(self._ship_e.values())):
            self._fail(f"fleet shipping bucket {shipping!r} J does not "
                       f"match the audited migration stream "
                       f"{sum(self._ship_e.values())!r} J")
        ckpt = sum(s.checkpoint_energy_j for s in report.node_stats)
        if not self._close(ckpt, sum(self._ckpt_e.values())):
            self._fail(f"fleet checkpoint bucket {ckpt!r} J does not "
                       f"match the audited persistence stream "
                       f"{sum(self._ckpt_e.values())!r} J")
        ckpt_s = sum(s.checkpoint_s for s in report.node_stats)
        if not self._close(ckpt_s, sum(self._ckpt_t.values())):
            self._fail(f"fleet checkpoint seconds {ckpt_s!r} do not "
                       f"match the audited persistence stream "
                       f"{sum(self._ckpt_t.values())!r} s")
        cache = sum(s.cache_read_energy_j for s in report.node_stats)
        if not self._close(cache, sum(self._cache_e.values())):
            self._fail(f"fleet cache_read bucket {cache!r} J does not "
                       f"match the audited hit stream "
                       f"{sum(self._cache_e.values())!r} J")
        cache_s = sum(s.cache_read_s for s in report.node_stats)
        if not self._close(cache_s, sum(self._cache_t.values())):
            self._fail(f"fleet cache_read seconds {cache_s!r} do not "
                       f"match the audited hit stream "
                       f"{sum(self._cache_t.values())!r} s")
