"""Mamba-2 (SSD — state-space duality, arXiv:2405.21060).

Port of `repro.models.ssm`.  The full-sequence pass (prefill, and every
forward of the KV-off measurement mode) runs the chunked SSD through
kernel B3 (`repro_torch.kernels.ssd_scan`) on CUDA and its plain version on
the CPU; decode is a one-token state update in plain PyTorch.  Unlike the
reference's `ssd_chunked`, B3 takes any sequence length, so prefill needs
no S % chunk == 0.

No attention, no KV cache: decode cost is position-independent, which is
exactly the workload-model contrast this arch contributes to the paper's
e_K(τin, τout) study (no τin·τout interaction from cache reads).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import shard
from repro_torch.kernels import ssd_scan as _ssd
from repro_torch.models import cache as cachelib
from repro_torch.models.common import (
    ModelConfig,
    ParamDef,
    cross_entropy,
    embed_tokens,
    lm_logits,
    maybe_remat,
    padded_vocab,
    rmsnorm,
    unstack_layers,
)


def conv_channels(cfg: ModelConfig) -> int:
    return cfg.d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state


def layer_defs(cfg: ModelConfig) -> dict:
    d, di = cfg.d_model, cfg.d_inner
    G, N, H = cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_nheads
    cc = conv_channels(cfg)
    L = (cfg.n_layers,)
    A = ("layers",)
    proj_out = 2 * di + 2 * G * N + H
    return {
        "in_proj": ParamDef(L + (d, proj_out), A + ("embed_w", "mlp")),
        "conv_w": ParamDef(L + (cfg.conv_kernel, cc), A + (None, "mlp"), scale=0.1),
        "conv_b": ParamDef(L + (cc,), A + ("mlp",), init="zeros"),
        "A_log": ParamDef(L + (H,), A + (None,), init="zeros"),   # A = -exp(A_log) ~ -1
        "D": ParamDef(L + (H,), A + (None,), init="ones"),
        "dt_bias": ParamDef(L + (H,), A + (None,), init="zeros"),
        "norm_w": ParamDef(L + (di,), A + ("mlp",), init="zeros"),
        "out_proj": ParamDef(L + (di, d), A + ("mlp", "embed_w"),
                             scale=0.02 / max(1, (2 * cfg.n_layers) ** 0.5)),
        "ln": {"w": ParamDef(L + (d,), A + (None,), init="zeros")},
    }


def param_defs(cfg: ModelConfig) -> dict:
    return {
        "embed": ParamDef((padded_vocab(cfg.vocab_size), cfg.d_model), ("vocab", "embed_w")),
        "blocks": layer_defs(cfg),
        "final_norm": {"w": ParamDef((cfg.d_model,), (None,), init="zeros")},
        "head": ParamDef((cfg.d_model, padded_vocab(cfg.vocab_size)), ("embed_w", "vocab")),
    }


# ---------------------------------------------------------------------------
# Mamba-2 block
# ---------------------------------------------------------------------------


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: torch.Tensor | None = None):
    """Depthwise causal conv, kernel K.  x [B,S,C], w [K,C], b [C].
    state [B,K-1,C] holds the trailing context (decode).  Returns (y, new_state)."""
    K = w.shape[0]
    if state is None:
        pad = x.new_zeros((x.shape[0], K - 1, x.shape[2]))
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                           # [B, S+K-1, C]
    y = sum(xp[:, i : i + x.shape[1]] * w[i] for i in range(K)) + b
    new_state = xp[:, -(K - 1):, :]
    return F.silu(y.float()).to(x.dtype), new_state


def _split_proj(cfg: ModelConfig, z: torch.Tensor):
    di, G, N, H = cfg.d_inner, cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_nheads
    zg = z[..., :di]
    xbc = z[..., di : di + di + 2 * G * N]
    dt = z[..., -H:]
    return zg, xbc, dt


def _ssm_params(cfg: ModelConfig, pl: dict, dt_raw: torch.Tensor):
    A = -torch.exp(pl["A_log"].float())                       # [H]
    dt = F.softplus(dt_raw.float() + pl["dt_bias"].float())
    return A, dt


def _split_groups(cfg: ModelConfig, bc: torch.Tensor):
    """[..., 2*G*N] -> B, C each [..., G, N], contiguous."""
    G, N = cfg.ssm_ngroups, cfg.ssm_state
    B_, C_ = torch.chunk(bc, 2, dim=-1)
    return (B_.reshape(B_.shape[:-1] + (G, N)).contiguous(),
            C_.reshape(C_.shape[:-1] + (G, N)).contiguous())


def _broadcast_groups(cfg: ModelConfig, bc: torch.Tensor):
    """[..., 2*G*N] -> B, C each [..., H, N] with groups broadcast to heads."""
    rep = cfg.ssm_nheads // cfg.ssm_ngroups
    return tuple(t.repeat_interleave(rep, dim=-2) for t in _split_groups(cfg, bc))


def ssd_scan(xdt, dA, B, C, *, chunk: int):
    """Kernel B3 (`kernels.ssd_scan.ssd_scan`); on DTensors, on each
    device's shards (`shard.local_call`): batch and heads stay as they are
    sharded (groups follow the heads when there are several), and a
    sharded sequence — the axis the scan runs along — is gathered first,
    as a partitioner must gather it."""
    if not shard.is_dtensor(xdt):
        return _ssd.ssd_scan(xdt, dA, B, C, chunk=chunk)
    x_pl = shard.moved(xdt.placements, {0: 0, 2: 2})
    bc_pl = shard.moved(xdt.placements, {0: 0, 2: 2} if B.shape[2] > 1 else {0: 0})
    fin_pl = shard.moved(xdt.placements, {0: 0, 2: 1})
    split = [m for m, p in enumerate(x_pl) if p.is_shard()]
    return shard.local_call(lambda x, a, b, c: _ssd.ssd_scan(x, a, b, c, chunk=chunk),
                            xdt.device_mesh, (xdt, dA, B, C), (x_pl, x_pl, bc_pl, bc_pl),
                            [x_pl, fin_pl], split_dims=split)


def mamba_block_full(cfg: ModelConfig, pl: dict, x: torch.Tensor):
    """Full-sequence Mamba-2 block.  x [B,S,d] -> (y [B,S,d], final_state,
    conv_state).  The SSD runs through kernel B3, which reads B and C per
    group."""
    Bsz, S, _ = x.shape
    H, P = cfg.ssm_nheads, cfg.ssm_headdim
    z = x @ pl["in_proj"]
    zg, xbc, dt_raw = _split_proj(cfg, z)
    xbc, conv_state = _causal_conv(xbc, pl["conv_w"], pl["conv_b"])
    x_ssm = xbc[..., : cfg.d_inner].reshape(Bsz, S, H, P)
    x_ssm = shard.constrain(x_ssm, "batch", "seq", "ssm_heads", None)
    B_, C_ = _split_groups(cfg, xbc[..., cfg.d_inner:])
    A, dt = _ssm_params(cfg, pl, dt_raw)                      # [H], [B,S,H]
    dA = dt * A
    xdt = x_ssm * dt[..., None].to(x_ssm.dtype)
    y, final = ssd_scan(xdt, dA, B_, C_, chunk=min(cfg.ssm_chunk, S))
    y = y + pl["D"].to(y.dtype)[None, None, :, None] * x_ssm
    y = y.reshape(Bsz, S, cfg.d_inner)
    y = y * F.silu(zg.float()).to(y.dtype)
    y = rmsnorm(y, pl["norm_w"], cfg.rmsnorm_eps)
    return y @ pl["out_proj"], final, conv_state


def mamba_block_decode(cfg: ModelConfig, pl: dict, x: torch.Tensor,
                       state: torch.Tensor, conv_state: torch.Tensor):
    """One-token Mamba-2 step.  x [B,d]; state [B,H,P,N] f32;
    conv_state [B,K-1,cc].  Returns (y [B,d], new state, new conv state)."""
    Bsz = x.shape[0]
    H, P = cfg.ssm_nheads, cfg.ssm_headdim
    z = x @ pl["in_proj"]
    zg, xbc, dt_raw = _split_proj(cfg, z)
    xbc, conv_state = _causal_conv(xbc[:, None], pl["conv_w"], pl["conv_b"],
                                   state=conv_state)
    xbc = xbc[:, 0]
    x_ssm = xbc[..., : cfg.d_inner].reshape(Bsz, H, P)
    B_, C_ = _broadcast_groups(cfg, xbc[..., cfg.d_inner:])   # [B,H,N]
    A, dt = _ssm_params(cfg, pl, dt_raw)                      # [H], [B,H]
    decay = torch.exp(dt * A)                                 # [B,H]
    upd = torch.einsum("bhp,bhn->bhpn",
                       (x_ssm * dt[..., None].to(x_ssm.dtype)).float(), B_.float())
    state = state * decay[:, :, None, None] + upd
    y = torch.einsum("bhpn,bhn->bhp", state, C_.float()).to(x.dtype)
    y = y + pl["D"].to(y.dtype)[None, :, None] * x_ssm
    y = y.reshape(Bsz, cfg.d_inner)
    y = y * F.silu(zg.float()).to(y.dtype)
    y = rmsnorm(y, pl["norm_w"], cfg.rmsnorm_eps)
    return y @ pl["out_proj"], state, conv_state


# ---------------------------------------------------------------------------
# Registry API
# ---------------------------------------------------------------------------


def forward_full(cfg: ModelConfig, params: dict, x: torch.Tensor, *,
                 collect: bool = False):
    """Run the layer stack over embeddings x [B,S,d].  Returns (hidden,
    (final_states [L,B,H,P,N], conv_states [L,B,K-1,cc]) | None).  Each
    layer is recomputed in the backward pass when cfg.remat is on."""

    def body(h, pl):
        h = shard.constrain(h, "batch", "seq", None)
        y, final, conv = mamba_block_full(cfg, pl, rmsnorm(h, pl["ln"]["w"], cfg.rmsnorm_eps))
        return h + y, final, conv

    body = maybe_remat(body, cfg.remat)
    h = x
    finals, convs = [], []
    for pl in unstack_layers(params["blocks"]):
        h, final, conv = body(h, pl)
        if collect:
            finals.append(final)
            convs.append(conv)
    return h, ((torch.stack(finals), torch.stack(convs)) if collect else None)


def train_loss(cfg: ModelConfig, params: dict, batch: dict):
    """Mean next-token cross-entropy.  On CUDA the SSD goes through kernel
    B3 in both directions (its backward kernel carries the gradients)."""
    x = embed_tokens(params["embed"], batch["tokens"])
    h, _ = forward_full(cfg, params, x)
    h = rmsnorm(h, params["final_norm"]["w"], cfg.rmsnorm_eps)
    logits = lm_logits(h, params["head"], cfg.vocab_size)
    loss, _ = cross_entropy(logits, batch["labels"])
    return loss, {}


def prefill(cfg: ModelConfig, params: dict, batch: dict, *,
            cache_len: int = 0, long_context: bool = False):
    tokens = batch["tokens"]
    x = embed_tokens(params["embed"], tokens)
    h, (finals, convs) = forward_full(cfg, params, x, collect=True)
    h = rmsnorm(h[:, -1], params["final_norm"]["w"], cfg.rmsnorm_eps)
    logits = lm_logits(h, params["head"], cfg.vocab_size)
    # capture-safe: no host-to-card copy (see dense._finish_cache)
    pos = torch.full((), tokens.shape[1], dtype=torch.int32, device=tokens.device)
    return logits, cachelib.SSMCache(convs, finals, pos)


def init_cache(cfg: ModelConfig, batch: int, cache_len: int = 0, *,
               long_context: bool = False, dtype=None, device):
    return cachelib.SSMCache.init(cfg.n_layers, batch, cfg.conv_kernel,
                                  conv_channels(cfg), cfg.ssm_nheads,
                                  cfg.ssm_headdim, cfg.ssm_state,
                                  dtype or cfg.dtype, device)


def decode_step(cfg: ModelConfig, params: dict, cache, batch: dict):
    """batch: {"token": [B] int32}.  Overwrites each layer's SSD and conv
    state in place and returns the cache with pos + 1 (same tensors)."""
    h = embed_tokens(params["embed"], batch["token"])
    for i, pl in enumerate(unstack_layers(params["blocks"])):
        y, st, cv = mamba_block_decode(cfg, pl, rmsnorm(h, pl["ln"]["w"], cfg.rmsnorm_eps),
                                       cache.state[i], cache.conv[i])
        cache.state[i].copy_(st)
        cache.conv[i].copy_(cv)
        h = h + y
    h = rmsnorm(h, params["final_norm"]["w"], cfg.rmsnorm_eps)
    logits = lm_logits(h, params["head"], cfg.vocab_size)
    return logits, cachelib.SSMCache(cache.conv, cache.state, cache.pos + 1)
