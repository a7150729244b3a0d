"""Shared model substrate: config, parameter definitions, norms, RoPE,
embeddings, losses.

Port of `repro.models.common`.  Params are nested dicts of tensors with the
reference's paths and layouts; a layer-stacked parameter is `[L, ...]` and
the model runs a Python loop over the layer index where the reference runs
`jax.lax.scan`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import shard


# ---------------------------------------------------------------------------
# Config
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One config object drives every family; family-specific fields default
    to 'off'.  Field for field the reference's `ModelConfig`."""

    name: str
    family: str                    # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // n_heads

    # attention options
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10000.0
    window: int = 0                # 0 = full causal attention
    long_context_window: int = 8192  # sliding window used in long_500k mode
    attn_logit_softcap: float = 0.0

    # norm / misc
    rmsnorm_eps: float = 1e-5
    tie_embeddings: bool = False

    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    d_expert: int = 0              # expert FFN width (d_ff used if 0)
    n_dense_layers: int = 0        # leading dense layers (DeepSeek-V3)
    dense_d_ff: int = 0            # FFN width of those dense layers
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    moe_token_chunk: int = 32768
    expert_shard_axes: tuple[str, ...] = ("model",)

    # MLA (DeepSeek-V3)
    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    mla_absorb: bool = False
    mtp: bool = False

    # SSM (Mamba-2 / SSD)
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_ngroups: int = 1
    ssm_chunk: int = 256
    conv_kernel: int = 4

    # hybrid (RecurrentGemma / Griffin)
    block_pattern: tuple[str, ...] = ()
    lru_width: int = 0
    local_window: int = 0

    # encoder-decoder (Seamless)
    enc_layers: int = 0
    dec_layers: int = 0
    n_frames: int = 4096

    # VLM (InternVL2)
    n_patches: int = 0

    # numerics
    param_dtype: str = "float32"
    cache_dtype: str = ""          # "" = param dtype
    # training
    microbatch: int = 0
    grad_accum_dtype: str = "float32"
    optimizer: str = "adamw"
    remat: bool = True
    # metadata
    n_params_note: str = ""
    source: str = ""
    accuracy_ak: float = 0.0       # A_K for the paper's accuracy model

    @property
    def head_dim_(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def d_inner(self) -> int:       # SSM inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def kv_dtype(self) -> torch.dtype:
        return getattr(torch, self.cache_dtype) if self.cache_dtype else self.dtype

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Parameter definitions
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]   # logical axes, same rank as shape
    init: str = "normal"           # normal | zeros | ones
    scale: float = 0.02

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} differ in rank")


ParamTree = Mapping[str, object]   # nested dict: str -> ParamDef | ParamTree


def _flatten_defs(defs: ParamTree, prefix: str = "") -> list[tuple[str, ParamDef]]:
    out = []
    for k in sorted(defs):
        v = defs[k]
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, ParamDef):
            out.append((path, v))
        else:
            out.extend(_flatten_defs(v, path))
    return out


def _set_path(tree: dict, path: str, value) -> None:
    keys = path.split("/")
    for k in keys[:-1]:
        tree = tree.setdefault(k, {})
    tree[keys[-1]] = value


def init_params(defs: ParamTree, generator: torch.Generator,
                dtype: torch.dtype, device: torch.device) -> dict:
    """Materialize parameters from defs: the reference's paths, shapes,
    scales and zero-inits.  Normal leaves are drawn in f32 from `generator`
    in sorted path order, so a seed fixes them; the values differ from the
    reference's, whose `jax.random` keys torch cannot reproduce."""
    params: dict = {}
    for path, d in _flatten_defs(defs):
        if d.init == "zeros":
            val = torch.zeros(d.shape, dtype=dtype, device=device)
        elif d.init == "ones":
            val = torch.ones(d.shape, dtype=dtype, device=device)
        else:
            val = torch.randn(d.shape, generator=generator, dtype=torch.float32,
                              device=device).mul_(d.scale).to(dtype)
        _set_path(params, path, val)
    return params


def param_specs(defs: ParamTree, rules=None) -> dict:
    """Spec tree matching init_params' structure."""
    specs: dict = {}
    for path, d in _flatten_defs(defs):
        _set_path(specs, path, shard.resolve(d.axes, rules))
    return specs


def param_shapes(defs: ParamTree, dtype: torch.dtype) -> dict:
    """init_params' tree as tensors on the meta device (shape and dtype,
    no storage)."""
    out: dict = {}
    for path, d in _flatten_defs(defs):
        _set_path(out, path, torch.empty(d.shape, dtype=dtype, device="meta"))
    return out


def unstack_layers(tree: dict) -> list[dict]:
    """A layer-stacked param tree as a list of per-layer trees (views of
    one `unbind` per leaf).  Its backward is one stack per leaf, where
    indexing layer by layer would make a full-size zero gradient per
    layer and leaf.  A DTensor leaf whose layer axis is sharded (FSDP may
    pick it) is gathered first: DTensor unbinds no sharded dim."""
    per_leaf = {k: (unstack_layers(v) if isinstance(v, dict)
                    else shard.gather_dim(v, 0).unbind(0))
                for k, v in tree.items()}
    n = len(next(iter(per_leaf.values())))
    return [{k: v[i] for k, v in per_leaf.items()} for i in range(n)]


def count_params(defs: ParamTree) -> int:
    return int(sum(np.prod(d.shape) for _, d in _flatten_defs(defs)))


# ---------------------------------------------------------------------------
# Numerics building blocks
# ---------------------------------------------------------------------------


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + w.float())).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding.  x: [..., S, H, D] (D even), positions broadcastable
    to [..., S]."""
    d = x.shape[-1]
    if d % 2:
        raise ValueError("rope head dim must be even")
    exps = torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d
    freqs = 1.0 / (theta ** exps)
    angles = positions[..., :, None, None].float() * freqs  # [..., S, 1, D/2]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    g = x @ w_gate
    u = x @ w_up
    h = F.silu(g.float()).to(x.dtype) * u
    h = shard.constrain(h, "batch", None, "mlp") if h.ndim == 3 else h
    return h @ w_down


def mlp_defs(d_model: int, d_ff: int, n_layers: int | None = None, *,
             scale: float = 0.02) -> dict:
    """SwiGLU MLP ParamDefs, optionally stacked over layers."""
    lead = () if n_layers is None else (n_layers,)
    lax_ = () if n_layers is None else ("layers",)
    return {
        "w_gate": ParamDef(lead + (d_model, d_ff), lax_ + ("embed_w", "mlp"), scale=scale),
        "w_up": ParamDef(lead + (d_model, d_ff), lax_ + ("embed_w", "mlp"), scale=scale),
        "w_down": ParamDef(lead + (d_ff, d_model), lax_ + ("mlp", "embed_w"), scale=scale),
    }


# ---------------------------------------------------------------------------
# Embedding / head / loss
# ---------------------------------------------------------------------------


def padded_vocab(v: int, multiple: int = 128) -> int:
    """Vocabulary rows padded to a multiple of 128, as in the reference.
    Padded logit columns are masked in lm_logits."""
    return ((v + multiple - 1) // multiple) * multiple


def embed_tokens(emb: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    x = emb.index_select(0, tokens.reshape(-1)).reshape(*tokens.shape, emb.shape[-1])
    return shard.constrain(x, "batch", "seq", None)


def lm_logits(x: torch.Tensor, head: torch.Tensor, n_valid: int | None = None) -> torch.Tensor:
    """x [..., d] @ head [d, Vp] -> f32 logits; columns >= n_valid
    (padding) are set to -1e30."""
    logits = (x @ head).float()
    if n_valid is not None and n_valid < head.shape[-1]:
        col = torch.arange(head.shape[-1], device=logits.device)
        logits = torch.where(col < n_valid, logits, -1e30)
    if logits.ndim == 3:
        logits = shard.constrain(logits, "batch", "seq", "vocab")
    else:
        logits = shard.constrain(logits, "batch", "vocab")
    return logits


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Masked mean CE.  labels: int32, -1 = ignore.  Returns (loss, n_valid)."""
    mask = (labels >= 0).float()
    safe = labels.clamp(min=0).long()
    logz = torch.logsumexp(logits, dim=-1)
    # a vocab-sharded DTensor's gather is a masked partial sum: reduced
    # before the index drops its dim (DTensor's mask misapplies after it)
    gold = shard.reduce_partial(torch.gather(logits, -1, safe[..., None]))[..., 0]
    nll = (logz - gold) * mask
    n = mask.sum().clamp(min=1.0)
    return nll.sum() / n, n


def maybe_remat(fn: Callable, enabled: bool) -> Callable:
    """fn recomputed in the backward pass instead of keeping what it saves
    (the reference's `jax.checkpoint` with `nothing_saveable`): only fn's
    inputs are kept.  A no-op when grad is off (serving)."""
    if not enabled:
        return fn

    def run(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        # the recompute runs inside the backward: with_layouts restores the
        # rules there (a no-op without them)
        return checkpoint(shard.with_layouts(fn), *args, use_reentrant=False)

    return run
