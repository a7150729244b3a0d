"""Per-request analytic energy/runtime simulator (the NVML/uProf stand-in).

Port copy of `repro.energy.simulator`, numpy only, with its imports
renamed: the same noise stream, memos and DVFS governor, value for value.

Integrates the structural cost model (repro_torch.energy.costs) over a request's
lifetime on a Node using roofline timing:

    t_pass = max(flops / (n·peak·eff), bytes / (n·bw·eff)) + dispatch
    E_pass = idle_w·n·t_pass + e_flop·flops + e_byte·bytes + host

With kv_cache=False (the paper's measurement mode) each generated token
re-runs the full prefix — runtime/energy pick up τin·τout and τout²
terms, which is what makes the paper's interaction-term OLS non-vacuous.

Multiplicative log-normal noise gives trial-to-trial variance so the
§5.1.3 CI stopping rule operates as in the paper.

The decode phase is integrated in EXACT closed form: the per-step cost is
piecewise-polynomial in the context length L (repro_torch.energy.costs.
decode_step_polys), so Σ over steps reduces to power sums per roofline
branch — O(#segments) instead of O(τout) Python-loop passes, and exact
where the old midpoint-chunk loop was approximate.  The loop survives as
`decode_cost_chunked` (chunk=1 is the exact per-step reference the closed
form is tested against).  Phase costs are memoized per
(context, steps, batch, frequency) so cluster simulations never
re-integrate a repeated decode segment, and `measure_batch` vectorizes
whole characterization grids per call (noise-stream-compatible with
sequential `measure`).

Per-phase DVFS: `prefill_cost`/`decode_cost` take `freq_scale=` — the
phase is priced at `node.accel.at_frequency(s)` (scaled peak_flops /
hbm_bw / dyn_w, fixed idle_w; FLOP/byte counts are frequency-invariant,
so the same piecewise-polynomial closed forms apply at any operating
point, with the roofline crossover re-solved under the scaled caps).
`best_prefill_frequency`/`best_decode_frequency` pick the energy-minimal
operating point analytically: one O(#segments) closed-form evaluation per
allowed scale, argmin over `accel.dvfs_scales` of phase energy plus any
time-proportional draw the caller charges per busy second (`extra_w`,
e.g. the host serving power).  No per-step simulation anywhere.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.energy import costs as costs_lib
from repro_torch.energy.hardware import Node, SWING_NODE, min_accelerators
from repro_torch.models import get_api
from repro_torch.models.common import ModelConfig

_MEMO_MAX_ENTRIES = 1 << 17   # per-cache LRU bound

# Process-wide phase-cost memo store, keyed by the *physics token* — the
# exact set of inputs prefill_cost/decode_cost depend on besides their
# arguments: (model config, accelerator spec, accelerator count, dispatch
# overhead, kv-cache mode), all frozen dataclasses and hence value-hashable.
# Cluster campaigns rebuild pristine fleets per run (fresh_nodes /
# compare_policies), which used to reset every per-instance memo; two
# simulators with equal tokens compute bit-identical values, so sharing
# the (prefill, decode) dicts across instances only changes *when* a value
# is computed, never what it is.
_SHARED_MEMOS: dict[tuple, tuple[dict, dict]] = {}


def _shared_memos(token: tuple) -> tuple[dict, dict]:
    memos = _SHARED_MEMOS.get(token)
    if memos is None:
        memos = _SHARED_MEMOS[token] = ({}, {})
    return memos


def _lru_get(memo: dict, key):
    """Hit = move-to-end (dicts preserve insertion order, so the front is
    always the least-recently-used entry)."""
    out = memo.pop(key, None)
    if out is not None:
        memo[key] = out
    return out


def _lru_put(memo: dict, key, val, limit: int) -> None:
    """Insert, evicting the least-recently-used entry at the bound —
    wholesale clearing used to drop the hot keys mid-campaign."""
    if len(memo) >= limit:
        memo.pop(next(iter(memo)))
    memo[key] = val


@dataclasses.dataclass(frozen=True)
class PhaseBreakdown:
    prefill_s: float
    decode_s: float
    prefill_j: float
    decode_j: float
    host_j: float

    @property
    def runtime_s(self) -> float:
        return self.prefill_s + self.decode_s

    @property
    def energy_j(self) -> float:
        return self.prefill_j + self.decode_j + self.host_j


def _poly_sum(coeffs: tuple[float, float, float], u0: float, count: int) -> float:
    """Σ_{j=0}^{count-1} p(u0 + j) for p(u) = c0 + c1·u + c2·u² (exact
    power-sum form — the closed-form decode integral's workhorse)."""
    c0, c1, c2 = coeffs
    s1 = count * (count - 1) / 2.0                    # Σ j
    s2 = (count - 1) * count * (2 * count - 1) / 6.0  # Σ j²
    return (c0 * count
            + c1 * (count * u0 + s1)
            + c2 * (count * u0 * u0 + 2.0 * u0 * s1 + s2))


def _quad_roots_in(c2: float, c1: float, c0: float,
                   lo: float, hi: float) -> list[float]:
    """Real roots of c2·u² + c1·u + c0 strictly inside (lo, hi)."""
    roots: list[float] = []
    if c2 == 0.0:
        if c1 != 0.0:
            roots = [-c0 / c1]
    else:
        disc = c1 * c1 - 4.0 * c2 * c0
        if disc > 0.0:
            sq = math.sqrt(disc)
            q = -0.5 * (c1 + math.copysign(sq, c1)) if c1 != 0.0 else sq * 0.5
            r1 = q / c2
            r2 = c0 / q if q != 0.0 else r1
            roots = [r1, r2]
        elif disc == 0.0:
            roots = [-c1 / (2.0 * c2)]
    out = sorted({r for r in roots if lo < r < hi})
    return out


class AnalyticLLMSimulator:
    """measure(tau_in, tau_out) -> (energy_j, runtime_s) — plug-compatible
    with the characterization campaign."""

    def __init__(
        self,
        cfg: ModelConfig,
        node: Node = SWING_NODE,
        *,
        batch: int = 32,               # the paper fixes batch 32
        kv_cache: bool = False,        # the paper disables the KV cache
        noise_sigma: float = 0.015,
        seed: int = 0,
        decode_chunk: int = 256,       # chunk size of the legacy reference loop
        shared_memos: bool = True,     # join the process-wide phase-cost store
    ):
        self.cfg = cfg
        self.batch = batch
        self.kv_cache = kv_cache
        self.noise_sigma = noise_sigma
        self.rng = np.random.default_rng(seed)
        self.decode_chunk = decode_chunk

        api = get_api(cfg)
        pbytes = api.count_params(cfg) * (2 if cfg.param_dtype == "bfloat16" else 4)
        n = min_accelerators(pbytes, node.accel)
        self.node = node.with_accelerators(n)

        # phase-cost memos: repeated (context, steps, batch, freq) segments
        # are common in cluster sims (identical queries, completion-boundary
        # batching) and must not re-integrate.  LRU-bounded (move-to-end on
        # hit, evict-oldest on insert) so long campaigns keep hot keys.
        # Shared process-wide across simulators with the same physics token
        # so fresh fleets start warm (see _SHARED_MEMOS); pass
        # shared_memos=False for a private cache (tests that reason about
        # eviction, or a caller that shrinks _memo_max_entries and must not
        # thrash the global store).
        if shared_memos:
            self._prefill_memo, self._decode_memo = _shared_memos(
                (cfg, self.node.accel, self.node.n_accel,
                 self.node.dispatch_overhead_s, kv_cache))
        else:
            self._prefill_memo = {}
            self._decode_memo = {}
        self._memo_max_entries = _MEMO_MAX_ENTRIES
        # per-operating-point accelerator specs (freq_scale -> spec)
        self._accel_at: dict[float, object] = {1.0: self.node.accel}

    # ------------------------------------------------------------------
    def _accel(self, scale: float):
        spec = self._accel_at.get(scale)
        if spec is None:
            spec = self.node.accel.at_frequency(scale)
            self._accel_at[scale] = spec
        return spec

    def _pass_time_energy(self, pc: costs_lib.PassCosts,
                          scale: float = 1.0) -> tuple[float, float]:
        a = self._accel(scale)
        n = self.node.n_accel
        t_c = pc.flops / (n * a.peak_flops * a.flops_efficiency)
        t_m = pc.hbm_bytes / (n * a.hbm_bw * a.bw_efficiency)
        t = max(t_c, t_m) + self.node.dispatch_overhead_s
        e = (a.idle_w * n * t
             + a.j_per_flop * pc.flops
             + a.j_per_byte_hbm * pc.hbm_bytes)
        return t, e

    def _pass_time_energy_batch(
        self, pc: costs_lib.PassCostsBatch
    ) -> tuple[np.ndarray, np.ndarray]:
        """Vectorized roofline timing/energy over arrays of pass costs."""
        a = self.node.accel
        n = self.node.n_accel
        t_c = pc.flops / (n * a.peak_flops * a.flops_efficiency)
        t_m = pc.hbm_bytes / (n * a.hbm_bw * a.bw_efficiency)
        t = np.maximum(t_c, t_m) + self.node.dispatch_overhead_s
        e = (a.idle_w * n * t
             + a.j_per_flop * pc.flops
             + a.j_per_byte_hbm * pc.hbm_bytes)
        return t, e

    # --- phase-level costs (the cluster simulator delegates to these) ----

    @property
    def host_power_w(self) -> float:
        """Host-side draw while serving (paper's EPYC uProf term)."""
        h = self.node.host
        return h.idle_w / 4.0 + h.active_w_per_core * h.serving_cores

    def prefill_cost(self, tau_in: int, batch: int | None = None,
                     *, freq_scale: float = 1.0) -> tuple[float, float]:
        """(seconds, accelerator joules) of one prefill pass over the prompt,
        priced at core-clock scale `freq_scale` (per-phase DVFS)."""
        B = self.batch if batch is None else batch
        key = (tau_in, B, freq_scale)
        out = _lru_get(self._prefill_memo, key)
        if out is None:
            pc = costs_lib.pass_costs(self.cfg, tau_in, tau_in, B, decode=False)
            out = self._pass_time_energy(pc, freq_scale)
            _lru_put(self._prefill_memo, key, out, self._memo_max_entries)
        return out

    def prefill_cost_batch(self, tau_in, batch: int | None = None
                           ) -> tuple[np.ndarray, np.ndarray]:
        """Vectorized prefill_cost over an array of prompt lengths."""
        B = self.batch if batch is None else batch
        tin = np.asarray(tau_in, dtype=np.float64)
        pc = costs_lib.pass_costs_batch(self.cfg, tin, tin, B, decode=False)
        return self._pass_time_energy_batch(pc)

    # --- decode: exact closed-form integration ------------------------

    def decode_cost(self, ctx0: float, n_steps: int,
                    batch: int | None = None,
                    *, freq_scale: float = 1.0) -> tuple[float, float]:
        """(seconds, accelerator joules) of `n_steps` decode steps starting
        at absolute context length `ctx0` (= τin + tokens already generated),
        priced at core-clock scale `freq_scale` (per-phase DVFS).

        Exact: step t attends context L_t = ctx0 + t + ½ (the convention
        the per-step reference loop uses); the per-step cost is piecewise
        polynomial in L_t, so the phase total is evaluated in closed form
        via power sums per roofline branch (the compute/memory crossover is
        re-solved under the frequency-scaled caps).  Exactness makes the
        integral additive — decode_cost(c, a) + decode_cost(c+a, b) ==
        decode_cost(c, a+b) — which is what lets the cluster simulator's
        segment-split decode conserve energy against simulate()."""
        B = self.batch if batch is None else batch
        if n_steps <= 0:
            return 0.0, 0.0
        key = (ctx0, n_steps, B, freq_scale)
        out = _lru_get(self._decode_memo, key)
        if out is None:
            out = self._decode_closed_form(ctx0, n_steps, B, freq_scale)
            _lru_put(self._decode_memo, key, out, self._memo_max_entries)
        return out

    def _step_pass(self, L: float, B: float) -> costs_lib.PassCosts:
        if self.kv_cache:
            return costs_lib.pass_costs(self.cfg, 1, L, B, decode=True)
        # paper mode: re-run the full prefix for every generated token
        return costs_lib.pass_costs(self.cfg, L, L, B, decode=False)

    def _decode_closed_form(self, ctx0: float, n_steps: int, B: float,
                            scale: float = 1.0) -> tuple[float, float]:
        a = self._accel(scale)
        n = self.node.n_accel
        fcap = n * a.peak_flops * a.flops_efficiency
        bcap = n * a.hbm_bw * a.bw_efficiency

        base = ctx0 + 0.5                      # grid: L_t = base + t
        if n_steps <= 4:                       # tiny phases: sum directly
            t_dec = e_dec = 0.0
            for t in range(n_steps):
                t1, e1 = self._pass_time_energy(self._step_pass(base + t, B),
                                                scale)
                t_dec += t1
                e_dec += e1
            return t_dec, e_dec

        segs = costs_lib.decode_step_polys(
            self.cfg, B, base, base + (n_steps - 1),
            reprefix=not self.kv_cache)

        t_sum = 0.0          # Σ max(t_c, t_m), dispatch added at the end
        flops_sum = 0.0
        bytes_sum = 0.0
        t_begin = 0
        for si, seg in enumerate(segs):
            if si == len(segs) - 1:
                t_end = n_steps
            else:  # grid points with L ≤ seg.hi belong to this piece
                t_end = min(n_steps, int(math.floor(seg.hi - base)) + 1)
            t_end = max(t_end, t_begin)
            count = t_end - t_begin
            if count == 0:
                continue
            u0 = (base + t_begin) - seg.lo
            flops_sum += _poly_sum(seg.flops, u0, count)
            bytes_sum += _poly_sum(seg.hbm_bytes, u0, count)

            # roofline branch: q(u) = flops(u)/fcap − bytes(u)/bcap
            qc = tuple(f / fcap - b / bcap
                       for f, b in zip(seg.flops, seg.hbm_bytes))
            uhi = u0 + (count - 1)
            splits = _quad_roots_in(qc[2], qc[1], qc[0], u0, uhi)
            # sub-ranges in relative index j, split where q crosses zero
            edges = [0] + [min(count, max(0, int(math.ceil(r - u0))))
                           for r in splits] + [count]
            edges = sorted(set(edges))

            def q_at(j: int) -> float:
                u = u0 + j
                return qc[0] + qc[1] * u + qc[2] * u * u

            for j0, j1 in zip(edges, edges[1:]):
                if j1 <= j0:
                    continue
                probes = (q_at(j0), q_at((j0 + j1 - 1) // 2), q_at(j1 - 1))
                if all(p >= 0.0 for p in probes):
                    t_sum += _poly_sum(seg.flops, u0 + j0, j1 - j0) / fcap
                elif all(p <= 0.0 for p in probes):
                    t_sum += _poly_sum(seg.hbm_bytes, u0 + j0, j1 - j0) / bcap
                else:  # crossover landed inside despite the split: sum directly
                    for j in range(j0, j1):
                        u = u0 + j
                        fv = seg.flops[0] + seg.flops[1] * u + seg.flops[2] * u * u
                        bv = (seg.hbm_bytes[0] + seg.hbm_bytes[1] * u
                              + seg.hbm_bytes[2] * u * u)
                        t_sum += max(fv / fcap, bv / bcap)
            t_begin = t_end

        t_dec = t_sum + n_steps * self.node.dispatch_overhead_s
        e_dec = (a.idle_w * n * t_dec
                 + a.j_per_flop * flops_sum
                 + a.j_per_byte_hbm * bytes_sum)
        return t_dec, e_dec

    def decode_cost_chunked(self, ctx0: float, n_steps: int,
                            batch: int | None = None, *,
                            chunk: int | None = None,
                            freq_scale: float = 1.0) -> tuple[float, float]:
        """The legacy midpoint-chunk integration loop, kept as the reference
        the closed form is validated against: chunk=1 evaluates every step
        at its true context L = ctx0 + t + ½ (exact; what `decode_cost`
        reproduces), larger chunks approximate runs of steps by their
        midpoint (the pre-closed-form default)."""
        B = self.batch if batch is None else batch
        t_dec = 0.0
        e_dec = 0.0
        step = self.decode_chunk if chunk is None else chunk
        for t0 in range(0, n_steps, step):
            c = min(step, n_steps - t0)
            L = ctx0 + t0 + c / 2.0
            t1, e1 = self._pass_time_energy(self._step_pass(L, B), freq_scale)
            t_dec += t1 * c
            e_dec += e1 * c
        return t_dec, e_dec

    # --- per-phase DVFS governor --------------------------------------

    def _best_frequency(self, cost_at, extra_w: float
                        ) -> tuple[float, float, float]:
        """argmin over the accelerator's operating points of
        phase_energy + extra_w · phase_time, each candidate priced by one
        closed-form evaluation.  Ties break toward the higher clock (same
        energy, less latency).  Returns (scale, seconds, accel joules)."""
        best = None
        for s in self.node.accel.dvfs_scales:
            t, e = cost_at(s)
            tot = e + extra_w * t
            if best is None or tot < best[0] - 1e-12 * max(1.0, abs(best[0])):
                best = (tot, s, t, e)
            elif abs(tot - best[0]) <= 1e-12 * max(1.0, abs(best[0])) \
                    and s > best[1]:
                best = (tot, s, t, e)
        return best[1], best[2], best[3]

    def best_prefill_frequency(self, tau_in: int, batch: int | None = None,
                               *, extra_w: float = 0.0
                               ) -> tuple[float, float, float]:
        """Energy-minimal operating point for one prefill pass:
        (freq_scale, seconds, accelerator joules).  `extra_w` is any
        time-proportional power the caller charges per busy second (host
        serving draw) — it belongs in the argmin, else the governor
        underclocks into latency that costs more than it saves."""
        return self._best_frequency(
            lambda s: self.prefill_cost(tau_in, batch, freq_scale=s), extra_w)

    def best_decode_frequency(self, ctx0: float, n_steps: int,
                              batch: int | None = None,
                              *, extra_w: float = 0.0
                              ) -> tuple[float, float, float]:
        """Energy-minimal operating point for a decode segment:
        (freq_scale, seconds, accelerator joules)."""
        return self._best_frequency(
            lambda s: self.decode_cost(ctx0, n_steps, batch, freq_scale=s),
            extra_w)

    # ------------------------------------------------------------------

    def simulate(self, tau_in: int, tau_out: int) -> PhaseBreakdown:
        t_pre, e_pre = self.prefill_cost(tau_in)
        t_dec, e_dec = self.decode_cost(tau_in, tau_out)
        e_host = self.host_power_w * (t_pre + t_dec)
        return PhaseBreakdown(t_pre, t_dec, e_pre, e_dec, e_host)

    def measure(self, tau_in: int, tau_out: int) -> tuple[float, float]:
        pb = self.simulate(tau_in, tau_out)
        # np.exp (not math.exp) so the noise factors are bit-identical to
        # measure_batch's vectorized np.exp on the same generator stream
        noise = float(np.exp(self.rng.normal(0.0, self.noise_sigma)))
        noise2 = float(np.exp(self.rng.normal(0.0, self.noise_sigma)))
        return pb.energy_j * noise, pb.runtime_s * noise2

    def measure_batch(self, tau_in, tau_out) -> tuple[np.ndarray, np.ndarray]:
        """Vectorized `measure` over arrays of (τin, τout): phase costs are
        computed once per unique pair (closed form + memo), and the noise
        draws consume the generator stream in the same order as the
        equivalent sequence of `measure` calls on the same pairs — one
        batched call is bit-identical to that call sequence.  (A batched
        *campaign* still differs from a sequential one: the round-based
        driver interleaves conditions, so the same draws land on
        different trials.)"""
        tin = np.atleast_1d(np.asarray(tau_in, dtype=np.int64))
        tout = np.atleast_1d(np.asarray(tau_out, dtype=np.int64))
        tin, tout = np.broadcast_arrays(tin, tout)
        pairs = np.stack([tin.ravel(), tout.ravel()], axis=1)
        uniq, inv = np.unique(pairs, axis=0, return_inverse=True)
        e_u = np.empty(len(uniq))
        r_u = np.empty(len(uniq))
        for i, (a, b) in enumerate(uniq):
            pb = self.simulate(int(a), int(b))
            e_u[i] = pb.energy_j
            r_u[i] = pb.runtime_s
        energy = e_u[inv]
        runtime = r_u[inv]
        draws = self.rng.normal(0.0, self.noise_sigma, size=2 * len(pairs))
        return (energy * np.exp(draws[0::2]),
                runtime * np.exp(draws[1::2]))

    # per-query (batch-normalized) versions used by the scheduler case study
    def measure_per_query(self, tau_in: int, tau_out: int) -> tuple[float, float]:
        e, r = self.measure(tau_in, tau_out)
        return e / self.batch, r / self.batch
