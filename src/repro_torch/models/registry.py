"""Family dispatch: one uniform API over all six architecture families.

    api = get_api(cfg)
    params = api.init_params(cfg, generator, device)
    loss, metrics = api.train_loss(cfg, params, batch)
    logits, cache = api.prefill(cfg, params, batch, cache_len=...)
    cache = api.init_cache(cfg, batch_size, cache_len, device=...)
    logits, cache = api.decode_step(cfg, params, cache, {"token": ...})

Port of `repro.models.registry`.  All six families run: dense, moe,
ssm, hybrid, encdec (the batch also carries "frames") and vlm ("patches").
`count_params` and `active_params` work for every family (the analytic
cost model needs them).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import torch

from repro_torch.models import dense, encdec, hybrid, moe, ssm, vlm
from repro_torch.models.common import (
    ModelConfig,
    count_params,
    init_params as _init,
    param_shapes as _shapes,
    param_specs as _specs,
)

_FAMILIES = {
    "dense": dense,
    "moe": moe,
    "ssm": ssm,
    "hybrid": hybrid,
    "encdec": encdec,
    "vlm": vlm,
}


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    family: str
    param_defs: Callable[[ModelConfig], dict]
    train_loss: Callable
    prefill: Callable
    init_cache: Callable
    decode_step: Callable

    def init_params(self, cfg: ModelConfig, generator: torch.Generator,
                    device: torch.device) -> dict:
        return _init(self.param_defs(cfg), generator, cfg.dtype, device)

    def param_shapes(self, cfg: ModelConfig) -> dict:
        return _shapes(self.param_defs(cfg), cfg.dtype)

    def param_specs(self, cfg: ModelConfig, rules=None) -> dict:
        return _specs(self.param_defs(cfg), rules)

    def count_params(self, cfg: ModelConfig) -> int:
        return _count_params_cached(cfg)


@functools.lru_cache(maxsize=64)
def get_api(cfg_or_family: ModelConfig | str) -> ModelAPI:
    family = (cfg_or_family if isinstance(cfg_or_family, str)
              else cfg_or_family.family)
    if family not in _FAMILIES:
        raise KeyError(f"unknown family {family!r}; have {sorted(_FAMILIES)}")
    mod = _FAMILIES[family]
    return ModelAPI(
        family=family,
        param_defs=mod.param_defs,
        train_loss=mod.train_loss,
        prefill=mod.prefill,
        init_cache=mod.init_cache,
        decode_step=mod.decode_step,
    )


@functools.lru_cache(maxsize=256)
def _count_params_cached(cfg: ModelConfig) -> int:
    return count_params(_FAMILIES[cfg.family].param_defs(cfg))


@functools.lru_cache(maxsize=256)
def active_params(cfg: ModelConfig) -> int:
    """Parameters touched per token (MoE: shared + top-k routed experts +
    attention/embedding), for MODEL_FLOPS = 2·N_active·D."""
    api = get_api(cfg)
    total = api.count_params(cfg)
    if cfg.family != "moe" or not cfg.n_experts:
        return total
    de = cfg.d_expert or cfg.d_ff
    per_expert = 3 * cfg.d_model * de
    nm = cfg.n_layers - cfg.n_dense_layers
    routed_total = nm * cfg.n_experts * per_expert
    routed_active = nm * cfg.top_k * per_expert
    return total - routed_total + routed_active
