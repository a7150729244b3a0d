"""Family dispatch: one uniform API over the ported architecture families.

    api = get_api(cfg)
    params = api.init_params(cfg, generator, device)
    logits, cache = api.prefill(cfg, params, batch, cache_len=...)
    cache = api.init_cache(cfg, batch_size, cache_len, device=...)
    logits, cache = api.decode_step(cfg, params, cache, {"token": ...})

Port of `repro.models.registry`.  The dense, ssm and hybrid families are
ported; the others raise NotImplementedError naming the ROADMAP item that
ports them.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import torch

from repro_torch.models import dense, hybrid, ssm
from repro_torch.models.common import ModelConfig, count_params, init_params as _init

_FAMILIES = {"dense": dense, "ssm": ssm, "hybrid": hybrid}

# families of the reference that later slices port (ROADMAP queue 1)
_NOT_YET = ("moe", "encdec", "vlm")


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    family: str
    param_defs: Callable[[ModelConfig], dict]
    prefill: Callable
    init_cache: Callable
    decode_step: Callable

    def init_params(self, cfg: ModelConfig, generator: torch.Generator,
                    device: torch.device) -> dict:
        return _init(self.param_defs(cfg), generator, cfg.dtype, device)

    def count_params(self, cfg: ModelConfig) -> int:
        return count_params(self.param_defs(cfg))


@functools.lru_cache(maxsize=64)
def get_api(cfg_or_family: ModelConfig | str) -> ModelAPI:
    family = (cfg_or_family if isinstance(cfg_or_family, str)
              else cfg_or_family.family)
    if family in _NOT_YET:
        raise NotImplementedError(
            f"family {family!r} is not ported to repro_torch yet: ROADMAP queue 1 "
            f"(moe/encdec/vlm, with fp8 caches in kernel B1)")
    if family not in _FAMILIES:
        raise KeyError(f"unknown family {family!r}; have {sorted(_FAMILIES)}")
    mod = _FAMILIES[family]
    return ModelAPI(
        family=family,
        param_defs=mod.param_defs,
        prefill=mod.prefill,
        init_cache=mod.init_cache,
        decode_step=mod.decode_step,
    )
