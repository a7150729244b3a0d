"""Batch cost surfaces on the device: the analytic energy/runtime of whole
query arrays in a few device calls, and kernel B2.

Port of `repro.kernels.cost_batch`.  ``simulate_batch(sim, tau_in,
tau_out)`` evaluates what ``AnalyticLLMSimulator.simulate`` computes (one
prefill roofline pass plus the exact closed-form decode integral: the
piecewise-quadratic power sums per roofline branch of
``repro_torch.energy.simulator``) over whole arrays of (τin, τout) in
float64 torch ops, with no Python loop over queries and no read of the
device until the result; ``cost_matrices(sims, ...)`` stacks k per-node
evaluations into the m×k energy/runtime matrices the scheduler consumes.
The decode power sums reach count³ ≈ 1e18 at τout ~ 10⁶, far beyond
float32, so the whole path is float64 (the H100 runs it natively).

``pass_surface`` is the elementwise pass-cost surface every one of those
evaluations calls: once for the prefill and three times (the quadratic
probes) per decode segment.  For CPU tensors it runs
``pass_surface_plain``, the same function in plain PyTorch; for CUDA
tensors it launches kernel B2 (``csrc/cost_batch.cu``, which replaces the
TPU kernel ``repro.kernels.cost_batch.pass_costs_pallas``) or raises, and
never falls back.  ``pass_costs_kernel`` is the counterpart of
``pass_costs_pallas`` itself: the surface in float32 over numpy inputs.

Model structure (family branches, window clamps, MoE breakpoints) is
resolved on the host from the hashable ``ModelConfig``, as the reference
resolves it at trace time; the number of device calls per evaluation is
therefore fixed per config: 1 + 3·(1 + number of breakpoints).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.energy import costs as costs_lib
from repro_torch.energy.costs import _interp_quadratic
from repro_torch.energy.simulator import _poly_sum
from repro_torch.kernels import _build
from repro_torch.models import active_params, get_api
from repro_torch.models.common import ModelConfig

# Launches of the CUDA kernel through `pass_surface` since the last reset;
# a run sets it to 0 and reads it to show that it went through B2.
launches = 0

_DTYPE_CODES = {torch.float32: 0, torch.float64: 1}


# ---------------------------------------------------------------------------
# Elementwise pass-cost surface (torch mirror of costs.pass_costs_batch)
# ---------------------------------------------------------------------------


def pass_surface_plain(cfg: ModelConfig, new_tokens: torch.Tensor,
                       context: torch.Tensor, batch: torch.Tensor, *,
                       include_weights: bool = True, decode: bool = False):
    """(flops, hbm_bytes) of a forward pass over broadcastable tensors, in
    plain PyTorch in the tensors' dtype.  Term for term the reference's
    ``pass_surface``: Python numbers enter as scalars that torch rounds to
    the tensors' dtype, as jax's weak types do, and the products run in
    the reference's order."""
    nt, ctx, bt = torch.broadcast_tensors(new_tokens, context, batch)
    b = 2 if cfg.param_dtype == "bfloat16" else 4
    n_active = float(active_params(cfg))
    tokens = bt * nt

    flops = 2.0 * n_active * tokens
    # attention
    if cfg.family == "ssm":
        H, P, N = cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state
        flops = flops + cfg.n_layers * bt * nt * (2 * H * P * N * 4)
    else:
        heads = cfg.n_heads
        hd = cfg.head_dim_
        if cfg.use_mla:
            hd = cfg.qk_nope_dim + cfg.qk_rope_dim
        if cfg.family == "hybrid":
            n_attn = cfg.n_layers // max(1, len(cfg.block_pattern))
            c = ctx.clamp(max=cfg.local_window) if cfg.local_window else ctx
            flops = flops + n_attn * bt * 4 * heads * hd * nt * c
        else:
            n_layers = cfg.dec_layers if cfg.family == "encdec" else cfg.n_layers
            c = ctx.clamp(max=cfg.window) if cfg.window else ctx
            flops = flops + n_layers * bt * 4 * heads * hd * nt * c
            if cfg.family == "encdec":
                flops = flops + (cfg.dec_layers * bt * 4 * heads * hd
                                 * nt * cfg.n_frames)
    # MoE router overhead
    if cfg.family == "moe":
        nm = cfg.n_layers - cfg.n_dense_layers
        flops = flops + nm * bt * nt * (2 * cfg.d_model * cfg.n_experts
                                        + 32 * cfg.n_experts)

    bytes_ = torch.zeros_like(tokens)
    if include_weights:
        api = get_api(cfg)
        if cfg.family != "moe":
            bytes_ = bytes_ + float(api.count_params(cfg) * b)
        else:
            total = api.count_params(cfg)
            de = cfg.d_expert or cfg.d_ff
            nm = cfg.n_layers - cfg.n_dense_layers
            per_expert = 3 * cfg.d_model * de
            routed = nm * cfg.n_experts * per_expert
            hit = (tokens * cfg.top_k).clamp(max=float(cfg.n_experts))
            bytes_ = bytes_ + (float(total - routed)
                               + hit * float(nm * per_expert)) * b
    bytes_ = bytes_ + tokens * float(cfg.n_layers * cfg.d_model * 12 * b)
    kvb = costs_lib.kv_bytes_per_token(cfg)
    bytes_ = bytes_ + tokens * kvb
    if decode:
        if cfg.family == "hybrid":
            c = ctx.clamp(max=cfg.local_window) if cfg.local_window else ctx
        elif cfg.window:
            c = ctx.clamp(max=cfg.window)
        else:
            c = ctx
        extra = bt * c * kvb
        if cfg.family == "ssm":
            ssm_state_bytes = (cfg.n_layers * cfg.ssm_nheads * cfg.ssm_headdim
                               * cfg.ssm_state * 4)
            extra = extra + bt * float(2 * ssm_state_bytes)
        bytes_ = bytes_ + extra
    return flops, bytes_


class CostBatchParams(ctypes.Structure):
    """`CostBatchParams` of csrc/cost_batch.cu, field for field."""

    _fields_ = [(name, ctypes.c_double) for name in (
        "k_dense", "attn_layers", "heads", "head_dim", "clamp", "xattn_layers",
        "n_frames", "ssm_layers", "ssm_flops", "router_layers", "router_flops",
        "weight_bytes", "n_experts", "top_k", "expert_bytes", "elem_bytes",
        "act_bytes", "kv_bytes", "ssm_state_bytes")] + [
        (name, ctypes.c_int32) for name in (
            "ssm", "has_clamp", "has_xattn", "moe", "include_weights", "decode")]


@functools.lru_cache(maxsize=256)
def surface_params(cfg: ModelConfig, include_weights: bool, decode: bool,
                   dtype: torch.dtype) -> CostBatchParams:
    """Every constant of `pass_surface_plain` for this config, resolved on
    the host: exact as Python computes them, and for float32 rounded to
    float32 once, where the reference's weak-typed constants round."""
    b = 2 if cfg.param_dtype == "bfloat16" else 4
    api = get_api(cfg)
    nm = cfg.n_layers - cfg.n_dense_layers
    hd = cfg.qk_nope_dim + cfg.qk_rope_dim if cfg.use_mla else cfg.head_dim_
    hybrid = cfg.family == "hybrid"
    clamp = cfg.local_window if hybrid else cfg.window
    de = cfg.d_expert or cfg.d_ff
    per_expert = 3 * cfg.d_model * de
    moe = cfg.family == "moe"
    values = dict(
        k_dense=2.0 * float(active_params(cfg)),
        attn_layers=(cfg.n_layers // max(1, len(cfg.block_pattern)) if hybrid
                     else cfg.dec_layers if cfg.family == "encdec" else cfg.n_layers),
        heads=cfg.n_heads, head_dim=hd, clamp=clamp,
        xattn_layers=cfg.dec_layers, n_frames=cfg.n_frames,
        ssm_layers=cfg.n_layers,
        ssm_flops=(2 * cfg.ssm_nheads * cfg.ssm_headdim * cfg.ssm_state * 4
                   if cfg.family == "ssm" else 0),
        router_layers=nm, router_flops=2 * cfg.d_model * cfg.n_experts + 32 * cfg.n_experts,
        weight_bytes=(float(api.count_params(cfg) - nm * cfg.n_experts * per_expert) if moe
                      else float(api.count_params(cfg) * b)),
        n_experts=float(cfg.n_experts), top_k=cfg.top_k,
        expert_bytes=float(nm * per_expert), elem_bytes=b,
        act_bytes=float(cfg.n_layers * cfg.d_model * 12 * b),
        kv_bytes=costs_lib.kv_bytes_per_token(cfg),
        ssm_state_bytes=(float(2 * cfg.n_layers * cfg.ssm_nheads * cfg.ssm_headdim
                               * cfg.ssm_state * 4) if cfg.family == "ssm" else 0.0))
    if dtype == torch.float32:
        values = {k: float(np.float32(v)) for k, v in values.items()}
    return CostBatchParams(
        **values, ssm=cfg.family == "ssm", has_clamp=bool(clamp),
        has_xattn=cfg.family == "encdec", moe=moe,
        include_weights=include_weights, decode=decode)


def pass_surface(cfg: ModelConfig, new_tokens: torch.Tensor, context: torch.Tensor,
                 batch: torch.Tensor, *, include_weights: bool = True,
                 decode: bool = False):
    """`pass_surface_plain`'s function: the plain version on CPU tensors,
    kernel B2 on CUDA tensors (float32 or float64, one device)."""
    tensors = (new_tokens, context, batch)
    devices = {t.device for t in tensors}
    if devices == {torch.device("cpu")}:
        return pass_surface_plain(cfg, new_tokens, context, batch,
                                  include_weights=include_weights, decode=decode)
    if len(devices) != 1 or new_tokens.device.type != "cuda":
        raise ValueError(f"pass_surface runs on CPU or CUDA tensors on one device; "
                         f"got {sorted(map(str, devices))}")
    dtypes = {t.dtype for t in tensors}
    if len(dtypes) != 1 or new_tokens.dtype not in _DTYPE_CODES:
        raise TypeError(f"kernel B2 takes float32 or float64 tensors of one dtype; "
                        f"got {sorted(map(str, dtypes))}")
    return _launch(cfg, *tensors, include_weights=include_weights, decode=decode)


@functools.cache
def _kernel():
    lib = _build.load("cost_batch")
    size = lib.cost_batch_params_size()
    if size != ctypes.sizeof(CostBatchParams):
        raise RuntimeError(f"CostBatchParams is {ctypes.sizeof(CostBatchParams)} bytes "
                           f"here and {size} in csrc/cost_batch.cu")
    fn = lib.cost_batch_launch
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 5
                   + [ctypes.c_longlong, CostBatchParams] + [ctypes.c_int] * 3
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


# Operand modes of csrc/cost_batch.cu: m elements, one value for every
# query, or (context only) the new_tokens tensor itself.
ARRAY, UNIFORM, ALIAS = 0, 1, 2


def operand_mode(t: torch.Tensor, shape: torch.Size) -> tuple[torch.Tensor, int]:
    """(tensor, mode) of one operand of an output of `shape`: UNIFORM for a
    single element (a 0-d or one-element tensor, or a view that repeats one
    element with stride 0), whose pointer the kernel reads; else ARRAY, the
    operand broadcast to `shape` and made contiguous (no copy when it
    already is)."""
    if t.numel() == 1:
        return t, UNIFORM
    e = t.expand(shape)
    if all(st == 0 for st, n in zip(e.stride(), e.shape) if n > 1):
        return e, UNIFORM
    return e.contiguous(), ARRAY


def same_tensor(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether a and b view the same elements: one pointer, shape and stride."""
    return (a.data_ptr() == b.data_ptr() and a.shape == b.shape
            and a.stride() == b.stride())


def _launch(cfg, nt, ctx, bt, *, include_weights, decode):
    global launches
    fn = _kernel()
    shape = torch.broadcast_shapes(nt.shape, ctx.shape, bt.shape)
    alias = same_tensor(ctx, nt)
    nt, nt_mode = operand_mode(nt, shape)
    ctx, ctx_mode = (nt, ALIAS) if alias and nt_mode == ARRAY else operand_mode(ctx, shape)
    bt, bt_mode = operand_mode(bt, shape)
    flops = torch.empty(shape, dtype=nt.dtype, device=nt.device)
    bytes_ = torch.empty(shape, dtype=nt.dtype, device=nt.device)
    m = shape.numel()
    if m == 0:
        return flops, bytes_
    err = fn(_DTYPE_CODES[nt.dtype], nt.data_ptr(), ctx.data_ptr(), bt.data_ptr(),
             flops.data_ptr(), bytes_.data_ptr(), m,
             surface_params(cfg, include_weights, decode, nt.dtype),
             nt_mode, ctx_mode, bt_mode, torch.cuda.current_stream(nt.device).cuda_stream)
    if err:
        raise RuntimeError(f"cost_batch kernel launch failed: cudaError_t {err}")
    launches += 1
    return flops, bytes_


def pass_costs_kernel(cfg: ModelConfig, new_tokens, context, batch, *,
                      include_weights: bool = True, decode: bool = False,
                      device: str | torch.device = "cuda"
                      ) -> tuple[np.ndarray, np.ndarray]:
    """(flops, hbm_bytes) float32 numpy arrays of the pass-cost surface:
    the counterpart of the TPU kernel `pass_costs_pallas`, with its float32
    numerics, through kernel B2 on a card (the plain version with
    device="cpu").  new_tokens and context are flattened; batch broadcasts."""
    dev = resolve_device(device)
    nt = torch.as_tensor(np.asarray(new_tokens, dtype=np.float32).ravel(), device=dev)
    ctx = torch.as_tensor(np.asarray(context, dtype=np.float32).ravel(), device=dev)
    bt = torch.as_tensor(np.asarray(batch, dtype=np.float32), device=dev)
    f, b = pass_surface(cfg, nt, ctx, bt, include_weights=include_weights, decode=decode)
    return f.cpu().numpy(), b.cpu().numpy()


# ---------------------------------------------------------------------------
# Closed-form decode integral (torch mirror of _decode_closed_form)
# ---------------------------------------------------------------------------


def _clip(x, lo, hi):
    """jnp.clip: max with lo, then min with hi (tensors or numbers)."""
    x = torch.maximum(x, lo) if torch.is_tensor(lo) else x.clamp(min=lo)
    return torch.minimum(x, hi) if torch.is_tensor(hi) else x.clamp(max=hi)


def _quad_roots_sorted(qc, u0, uhi):
    """Roots of c2 u² + c1 u + c0 strictly inside (u0, uhi), as two values
    (invalid → +inf, which the edge clamp maps to an empty split),
    branchless: simulator._quad_roots_in over tensors.  Every division has
    a safe denominator, so no NaN reaches a `where`."""
    c0, c1, c2 = qc
    inf = torch.inf
    lin = c2 == 0.0
    c1_safe = torch.where(c1 != 0.0, c1, 1.0)
    r_lin = torch.where(c1 != 0.0, -c0 / c1_safe, inf)
    disc = c1 * c1 - 4.0 * c2 * c0
    sq = torch.sqrt(disc.clamp(min=0.0))
    q = torch.where(c1 != 0.0, -0.5 * (c1 + torch.sign(c1_safe) * sq), 0.5 * sq)
    c2_safe = torch.where(lin, 1.0, c2)
    ra = q / c2_safe
    rb = torch.where(q != 0.0, c0 / torch.where(q != 0.0, q, 1.0), ra)
    r_dbl = -c1 / (2.0 * c2_safe)
    q1 = torch.where(disc > 0.0, ra, torch.where(disc == 0.0, r_dbl, inf))
    q2 = torch.where(disc > 0.0, rb, inf)
    r1 = torch.where(lin, r_lin, q1)
    r2 = torch.where(lin, inf, q2)
    valid1 = (r1 > u0) & (r1 < uhi)
    valid2 = (r2 > u0) & (r2 < uhi)
    r1 = torch.where(valid1, r1, inf)
    r2 = torch.where(valid2, r2, inf)
    return torch.minimum(r1, r2), torch.maximum(r1, r2)


def surface_calls(cfg: ModelConfig, kv_cache: bool) -> int:
    """`pass_surface` calls of one `simulate_batch` evaluation: the prefill,
    and three probes per decode segment.  The segments are split at the
    attention-window clamp and, with the KV cache off, at the MoE
    expert-saturation point."""
    n_bps = int(np.isfinite(costs_lib.attention_window(cfg)))
    n_bps += int(not kv_cache and cfg.family == "moe" and bool(cfg.top_k))
    return 1 + 3 * (1 + n_bps)


def _decode_phase(cfg: ModelConfig, node, ctx0, n, batch, *, kv_cache: bool):
    """(seconds, accelerator joules) of the decode phase, vectorized: the
    exact piecewise-quadratic power-sum integral of
    ``AnalyticLLMSimulator._decode_closed_form`` in float64 torch."""
    a = node.accel
    fcap = node.n_accel * a.peak_flops * a.flops_efficiency
    bcap = node.n_accel * a.hbm_bw * a.bw_efficiency
    reprefix = not kv_cache

    n_eff = n.clamp(min=1.0)
    base = ctx0 + 0.5                  # grid: L_t = base + t
    lo = base
    hi = base + (n_eff - 1.0)

    one = ctx0.new_ones(())

    def step_costs(L):
        if reprefix:   # paper mode: re-run the full L-token prefix per step
            return pass_surface(cfg, L, L, batch, decode=False)
        return pass_surface(cfg, one, L, batch, decode=True)

    # static breakpoint structure (≤ 2: attention-window clamp, MoE
    # expert-saturation in re-prefix mode); values may depend on batch
    bps = []
    w = costs_lib.attention_window(cfg)
    if np.isfinite(w):
        bps.append(w * torch.ones_like(base))
    if reprefix and cfg.family == "moe" and cfg.top_k:
        bps.append(cfg.n_experts / (batch * cfg.top_k) * torch.ones_like(base))
    if len(bps) == 2:
        bps = [torch.minimum(bps[0], bps[1]), torch.maximum(bps[0], bps[1])]

    # segment coordinates and the step-index boundaries (grid points with
    # L ≤ seg.hi belong to the segment, exactly as the numpy loop assigns)
    edges_s = [lo] + [_clip(b, lo, hi) for b in bps] + [hi]
    t_bounds = [torch.zeros_like(base)]
    run = torch.zeros_like(base)
    for b in bps:
        raw = _clip(torch.floor(b - base) + 1.0, 0.0, n_eff)
        te = torch.where(b <= lo, 0.0, torch.where(b >= hi, n_eff, raw))
        run = torch.maximum(run, te)
        t_bounds.append(run)
    t_bounds.append(n_eff)

    t_sum = torch.zeros_like(base)
    flops_sum = torch.zeros_like(base)
    bytes_sum = torch.zeros_like(base)
    for s in range(len(edges_s) - 1):
        s0, s1 = edges_s[s], edges_s[s + 1]
        t0, t1 = t_bounds[s], t_bounds[s + 1]
        count = (t1 - t0).clamp(min=0.0)
        live = count > 0.0
        h = (s1 - s0) / 2.0
        hs = torch.where(h > 0.0, h, 1.0)   # degenerate segments have count 0
        y0f, y0b = step_costs(s0)
        y1f, y1b = step_costs(s0 + hs)
        y2f, y2b = step_costs(s0 + 2.0 * hs)
        cf = _interp_quadratic(y0f, y1f, y2f, hs)
        cb = _interp_quadratic(y0b, y1b, y2b, hs)
        u0 = (base + t0) - s0
        flops_sum = flops_sum + torch.where(live, _poly_sum(cf, u0, count), 0.0)
        bytes_sum = bytes_sum + torch.where(live, _poly_sum(cb, u0, count), 0.0)

        # roofline branch: q(u) = flops(u)/fcap − bytes(u)/bcap; split the
        # step range at the quadratic's roots, then pick the branch per
        # sub-range from the same three probes the numpy path uses
        qc = tuple(f / fcap - bb / bcap for f, bb in zip(cf, cb))
        uhi = u0 + (count - 1.0)
        r1, r2 = _quad_roots_sorted(qc, u0, uhi)
        e1 = torch.where(torch.isfinite(r1), _clip(torch.ceil(r1 - u0), 0.0, count), 0.0)
        e2 = torch.where(torch.isfinite(r2), _clip(torch.ceil(r2 - u0), 0.0, count), 0.0)
        elo = torch.minimum(e1, e2)
        ehi = torch.maximum(e1, e2)

        def q_at(j):
            u = u0 + j
            return qc[0] + qc[1] * u + qc[2] * u * u

        for j0, j1 in ((torch.zeros_like(count), elo), (elo, ehi), (ehi, count)):
            cnt = (j1 - j0).clamp(min=0.0)
            sub = live & (cnt > 0.0)
            probes = (q_at(j0), q_at(torch.floor((j0 + j1 - 1.0) / 2.0)),
                      q_at(j1 - 1.0))
            use_f = (probes[0] >= 0.0) & (probes[1] >= 0.0) & (probes[2] >= 0.0)
            use_b = (probes[0] <= 0.0) & (probes[1] <= 0.0) & (probes[2] <= 0.0)
            tf = _poly_sum(cf, u0 + j0, cnt) / fcap
            tb = _poly_sum(cb, u0 + j0, cnt) / bcap
            # mixed probes cannot occur for a true root-split quadratic;
            # max() is the conservative fp-edge-case fallback
            val = torch.where(use_f, tf, torch.where(use_b, tb, torch.maximum(tf, tb)))
            t_sum = t_sum + torch.where(sub, val, 0.0)

    t_dec = t_sum + n_eff * node.dispatch_overhead_s
    e_dec = (a.idle_w * node.n_accel * t_dec
             + a.j_per_flop * flops_sum
             + a.j_per_byte_hbm * bytes_sum)
    empty = n <= 0.0
    return torch.where(empty, 0.0, t_dec), torch.where(empty, 0.0, e_dec)


def simulate_batch(sim, tau_in, tau_out, *, batch=None,
                   device: str | torch.device = "cuda"
                   ) -> tuple[np.ndarray, np.ndarray]:
    """Noise-free (energy_j, runtime_s) float64 numpy arrays per query for
    an ``AnalyticLLMSimulator``: the batched equivalent of
    ``[sim.simulate(a, b) for a, b in zip(...)]``, ≤1e-9 relative against
    the numpy closed form.  On a card every pass-cost evaluation is a
    launch of kernel B2 (``surface_calls`` of them); device="cpu" runs the
    plain versions."""
    dev = resolve_device(device)
    cfg, node = sim.cfg, sim.node
    a = node.accel
    fcap = node.n_accel * a.peak_flops * a.flops_efficiency
    bcap = node.n_accel * a.hbm_bw * a.bw_efficiency
    B = torch.tensor(float(sim.batch if batch is None else batch),
                     dtype=torch.float64, device=dev)
    tin = torch.as_tensor(np.asarray(tau_in, dtype=np.float64), device=dev)
    tout = torch.as_tensor(np.asarray(tau_out, dtype=np.float64), device=dev)

    pf, pb = pass_surface(cfg, tin, tin, B, decode=False)
    t_pre = torch.maximum(pf / fcap, pb / bcap) + node.dispatch_overhead_s
    e_pre = (a.idle_w * node.n_accel * t_pre
             + a.j_per_flop * pf + a.j_per_byte_hbm * pb)
    t_dec, e_dec = _decode_phase(cfg, node, tin, tout, B, kv_cache=sim.kv_cache)
    runtime = t_pre + t_dec
    energy = e_pre + e_dec + sim.host_power_w * runtime
    return energy.cpu().numpy(), runtime.cpu().numpy()


def cost_matrices(sims: Sequence, tau_in, tau_out, *, per_query: bool = False,
                  device: str | torch.device = "cuda"
                  ) -> tuple[np.ndarray, np.ndarray]:
    """m×k energy/runtime matrices over k simulators (one per fleet node),
    each column one `simulate_batch`.  ``per_query=True`` divides by each
    simulator's batch (the scheduler's batch-normalized convention)."""
    cols_e, cols_r = [], []
    for sim in sims:
        e, r = simulate_batch(sim, tau_in, tau_out, device=device)
        if per_query:
            e, r = e / sim.batch, r / sim.batch
        cols_e.append(e)
        cols_r.append(r)
    return np.stack(cols_e, axis=1), np.stack(cols_r, axis=1)
