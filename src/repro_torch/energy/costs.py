"""Analytic per-pass FLOP/byte cost model for every architecture family.

Port copy of `repro.energy.costs`, numpy float64 in the same order of
operations, so every value equals the reference's; only the dtype
itemsize comes from torch (`dtype_bytes`).

`pass_costs(cfg, new_tokens, context, batch)` returns the FLOPs and HBM
bytes of one forward pass that processes `new_tokens` positions per
sequence against `context` total attended positions.  This is the
structural cost surface the energy simulator integrates over a request —
deliberately richer than the paper's bilinear e_K (quadratic attention
terms, MoE router overhead, constant-state SSM), so fitting Eq. 6/7 against
it is a real test of the paper's model form.

Two fast entry points back the vectorized engine:

  * `pass_costs_batch` — the same surface evaluated over numpy arrays of
    (new_tokens, context, batch) in one shot (used by
    `AnalyticLLMSimulator.measure_batch` and the perf suite);
  * `decode_step_polys` — the per-decode-step cost as an explicit
    piecewise polynomial in the absolute context length L.  Within a
    piece the surface is a polynomial of degree ≤ 2 (attention is
    new_tokens·context, everything else is affine), with breakpoints only
    at the attention-window clamp and the MoE expert-saturation point, so
    Σ_L over a decode phase has an exact power-sum closed form — this is
    what replaces the midpoint-chunk loop in
    `AnalyticLLMSimulator.decode_cost`.

Decode-vs-prefill is an explicit `decode` kwarg (threaded from
`prefill_cost`/`decode_cost`): the old `new_tokens <= 2` heuristic
misclassified genuine τin ≤ 2 prefills as decode-like passes and charged
them a full-cache read.  `decode=None` keeps the heuristic for legacy
direct callers.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.models import active_params, get_api
from repro_torch.models.common import ModelConfig


@dataclasses.dataclass(frozen=True)
class PassCosts:
    flops: float
    hbm_bytes: float

    def __add__(self, other: "PassCosts") -> "PassCosts":
        return PassCosts(self.flops + other.flops, self.hbm_bytes + other.hbm_bytes)


@dataclasses.dataclass(frozen=True)
class PassCostsBatch:
    """Elementwise FLOPs/bytes for a batch of passes (numpy arrays)."""

    flops: np.ndarray
    hbm_bytes: np.ndarray


def _dtype_bytes(cfg: ModelConfig) -> int:
    return 2 if cfg.param_dtype == "bfloat16" else 4


def dtype_bytes(name: str) -> int:
    """Itemsize of a dtype named as `ModelConfig.cache_dtype` names it
    ("bfloat16", "float8_e4m3fn", ...), read from torch's dtype.  The
    reference reads it from `jax.numpy`."""
    return getattr(torch, name).itemsize


def kv_bytes_per_token(cfg: ModelConfig) -> float:
    """Cache bytes written per token per layer-stack (all layers)."""
    b = dtype_bytes(cfg.cache_dtype) if cfg.cache_dtype else _dtype_bytes(cfg)
    if cfg.family == "ssm":
        return 0.0  # constant-size state, no per-token growth
    if cfg.use_mla:
        return cfg.n_layers * (cfg.kv_lora_rank + cfg.qk_rope_dim) * b
    if cfg.family == "hybrid":
        n_attn = cfg.n_layers // max(1, len(cfg.block_pattern))
        return n_attn * 2 * cfg.n_kv_heads * cfg.head_dim_ * b
    n_layers = cfg.dec_layers if cfg.family == "encdec" else cfg.n_layers
    return n_layers * 2 * cfg.n_kv_heads * cfg.head_dim_ * b


def attention_window(cfg: ModelConfig) -> float:
    """The context clamp applied to attention reads/FLOPs (inf = unclamped)."""
    if cfg.family == "hybrid":
        return float(cfg.local_window) if cfg.local_window else float("inf")
    return float(cfg.window) if cfg.window else float("inf")


def _attention_flops(cfg: ModelConfig, new_tokens, context, batch):
    """Score + weighted-value FLOPs for all attention layers.  Array-generic:
    every operand may be a scalar or a broadcastable numpy array (the one
    implementation serves both `pass_costs` and `pass_costs_batch`)."""
    if cfg.family == "ssm":
        # SSD: intra-chunk quadratic within chunk + state updates, ~linear
        H, P, N = cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state
        per_tok = 2 * H * P * N * 4  # B·x outer product, C·h, decay, gather
        return cfg.n_layers * batch * new_tokens * per_tok
    heads = cfg.n_heads
    hd = cfg.head_dim_
    if cfg.use_mla:
        hd = cfg.qk_nope_dim + cfg.qk_rope_dim
    if cfg.family == "hybrid":
        n_attn = cfg.n_layers // max(1, len(cfg.block_pattern))
        ctx = np.minimum(context, cfg.local_window) if cfg.local_window else context
        return n_attn * batch * 4 * heads * hd * new_tokens * ctx
    n_layers = cfg.dec_layers if cfg.family == "encdec" else cfg.n_layers
    ctx = np.minimum(context, cfg.window) if cfg.window else context
    flops = n_layers * batch * 4 * heads * hd * new_tokens * ctx
    if cfg.family == "encdec":
        # cross attention into n_frames memory
        flops = flops + (cfg.dec_layers * batch * 4 * heads * hd
                         * new_tokens * cfg.n_frames)
    return flops


def router_overhead_flops(cfg: ModelConfig, new_tokens, batch):
    """MoE routing: logits + top-k + dispatch bookkeeping (the 'added
    runtime and energy overhead' of §5.2).  Array-generic."""
    if cfg.family != "moe":
        return 0.0
    nm = cfg.n_layers - cfg.n_dense_layers
    return nm * batch * new_tokens * (2 * cfg.d_model * cfg.n_experts
                                      + 32 * cfg.n_experts)


def _decode_cache_read_bytes(cfg: ModelConfig, context, batch, kvb: float):
    """HBM bytes of an incremental decode step's cache read (the whole
    attended context, window-clamped) plus SSM state traffic.  Array-generic."""
    if cfg.family == "hybrid":
        ctx = np.minimum(context, cfg.local_window) if cfg.local_window else context
    elif cfg.window:
        ctx = np.minimum(context, cfg.window)
    else:
        ctx = context
    bytes_ = batch * ctx * kvb
    if cfg.family == "ssm":
        ssm_state_bytes = (cfg.n_layers * cfg.ssm_nheads * cfg.ssm_headdim
                           * cfg.ssm_state * 4)
        bytes_ = bytes_ + batch * 2 * ssm_state_bytes
    return bytes_


def pass_costs(cfg: ModelConfig, new_tokens: float, context: float,
               batch: float, *, include_weights: bool = True,
               decode: bool | None = None) -> PassCosts:
    """One forward pass: `new_tokens` positions/sequence, `context` attended.

    `decode=True` charges the full-cache read of an incremental decode
    step; `decode=False` is a prefill-style pass (no existing cache).
    `decode=None` falls back to the legacy `new_tokens <= 2` heuristic for
    direct callers that predate the explicit flag.
    """
    if decode is None:
        decode = new_tokens <= 2
    b = _dtype_bytes(cfg)
    n_active = active_params(cfg)
    tokens = batch * new_tokens

    flops = 2.0 * n_active * tokens
    flops += _attention_flops(cfg, new_tokens, context, batch)
    flops += router_overhead_flops(cfg, new_tokens, batch)

    bytes_ = 0.0
    if include_weights:
        api = get_api(cfg)
        bytes_ += api.count_params(cfg) * b if cfg.family != "moe" else _moe_weight_bytes(cfg, tokens, b)
    # activations: ~12 d_model reads/writes per token per layer
    bytes_ += cfg.n_layers * tokens * cfg.d_model * 12 * b
    # cache traffic: write new tokens, read full context per new token (decode)
    kvb = kv_bytes_per_token(cfg)
    bytes_ += tokens * kvb
    if decode:  # incremental decode pass: read the whole cache
        bytes_ += _decode_cache_read_bytes(cfg, context, batch, kvb)
    return PassCosts(flops=float(flops), hbm_bytes=float(bytes_))


def pass_costs_batch(cfg: ModelConfig, new_tokens, context, batch, *,
                     include_weights: bool = True,
                     decode: bool = False) -> PassCostsBatch:
    """Vectorized `pass_costs` over broadcastable arrays of
    (new_tokens, context, batch).  `decode` applies to the whole batch
    (mixed prefill/decode batches are two calls).  Shares the array-generic
    term helpers with the scalar path, so the two can never drift."""
    nt = np.asarray(new_tokens, dtype=np.float64)
    ctx_in = np.asarray(context, dtype=np.float64)
    bt = np.asarray(batch, dtype=np.float64)
    nt, ctx_in, bt = np.broadcast_arrays(nt, ctx_in, bt)

    b = _dtype_bytes(cfg)
    n_active = active_params(cfg)
    tokens = bt * nt

    flops = 2.0 * n_active * tokens
    flops = flops + _attention_flops(cfg, nt, ctx_in, bt)
    flops = flops + router_overhead_flops(cfg, nt, bt)

    bytes_ = np.zeros_like(tokens)
    if include_weights:
        api = get_api(cfg)
        if cfg.family != "moe":
            bytes_ = bytes_ + api.count_params(cfg) * b
        else:
            bytes_ = bytes_ + _moe_weight_bytes(cfg, tokens, b)
    bytes_ = bytes_ + cfg.n_layers * tokens * cfg.d_model * 12 * b
    kvb = kv_bytes_per_token(cfg)
    bytes_ = bytes_ + tokens * kvb
    if decode:
        bytes_ = bytes_ + _decode_cache_read_bytes(cfg, ctx_in, bt, kvb)
    return PassCostsBatch(flops=flops, hbm_bytes=bytes_)


def _moe_weight_bytes(cfg: ModelConfig, tokens, b: int):
    """MoE weight traffic: non-expert weights once + experts actually hit.
    With many tokens every expert is touched; with few (decode), only
    ~tokens*top_k experts stream in.  Array-generic."""
    api = get_api(cfg)
    total = api.count_params(cfg)
    de = cfg.d_expert or cfg.d_ff
    nm = cfg.n_layers - cfg.n_dense_layers
    per_expert = 3 * cfg.d_model * de
    routed = nm * cfg.n_experts * per_expert
    base = total - routed
    hit = np.minimum(float(cfg.n_experts), tokens * cfg.top_k)
    return (base + nm * hit * per_expert) * b


# ---------------------------------------------------------------------------
# Closed-form decode integration support
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class StepPolySegment:
    """Per-decode-step cost on L ∈ [lo, hi] as exact degree-≤2 polynomials
    in u = L − lo: poly(u) = c0 + c1·u + c2·u²."""

    lo: float
    hi: float
    flops: tuple[float, float, float]
    hbm_bytes: tuple[float, float, float]


def _interp_quadratic(y0: float, y1: float, y2: float,
                      h: float) -> tuple[float, float, float]:
    """Coefficients in u of the unique degree-≤2 polynomial through
    (0, y0), (h, y1), (2h, y2)."""
    c0 = y0
    c1 = (-3.0 * y0 + 4.0 * y1 - y2) / (2.0 * h)
    c2 = (y0 - 2.0 * y1 + y2) / (2.0 * h * h)
    return c0, c1, c2


def decode_step_breakpoints(cfg: ModelConfig, batch: float, *,
                            reprefix: bool) -> list[float]:
    """Context lengths where the per-step decode cost changes polynomial
    piece: the attention-window clamp, and (re-prefix mode only) the MoE
    expert-saturation point tokens·top_k = n_experts."""
    bps: list[float] = []
    w = attention_window(cfg)
    if np.isfinite(w):
        bps.append(w)
    if reprefix and cfg.family == "moe" and cfg.top_k and batch > 0:
        bps.append(cfg.n_experts / (batch * cfg.top_k))
    return sorted(set(bps))


def decode_step_polys(cfg: ModelConfig, batch: float, lo: float, hi: float, *,
                      reprefix: bool,
                      include_weights: bool = True) -> list[StepPolySegment]:
    """Exact piecewise-polynomial form of the per-step decode cost over
    L ∈ [lo, hi].

    reprefix=False (KV cache on): one single-token pass attending L context.
    reprefix=True (the paper's no-cache mode): the full L-token prefix is
    re-run for each generated token — a prefill-style pass of L new tokens.

    The cost surface is continuous and polynomial (degree ≤ 2 in L) between
    breakpoints, so interpolating through 3 points of each piece recovers
    it exactly; keeping this derived from `pass_costs` itself (rather than
    re-deriving coefficients per family) means the closed form can never
    drift from the reference surface.
    """
    if hi < lo:
        raise ValueError(f"need hi >= lo, got [{lo}, {hi}]")

    def step(L: float) -> PassCosts:
        if reprefix:
            return pass_costs(cfg, L, L, batch,
                              include_weights=include_weights, decode=False)
        return pass_costs(cfg, 1.0, L, batch,
                          include_weights=include_weights, decode=True)

    if hi == lo:  # degenerate single-point range
        pc = step(lo)
        return [StepPolySegment(lo, hi, (pc.flops, 0.0, 0.0),
                                (pc.hbm_bytes, 0.0, 0.0))]

    bounds = [lo] + [b for b in decode_step_breakpoints(cfg, batch,
                                                        reprefix=reprefix)
                     if lo < b < hi] + [hi]
    segs: list[StepPolySegment] = []
    for s0, s1 in zip(bounds, bounds[1:]):
        h = (s1 - s0) / 2.0
        p0, p1, p2 = step(s0), step(s0 + h), step(s1)
        segs.append(StepPolySegment(
            lo=s0, hi=s1,
            flops=_interp_quadratic(p0.flops, p1.flops, p2.flops, h),
            hbm_bytes=_interp_quadratic(p0.hbm_bytes, p1.hbm_bytes,
                                        p2.hbm_bytes, h),
        ))
    return segs
