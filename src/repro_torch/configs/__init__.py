"""Config registry: the repo's ten assigned architectures and the paper's
7-model zoo by --arch id, plus the reduced smoke variants ('<id>-reduced')
and the assigned input shapes.

Port of `repro.configs`."""

from __future__ import annotations

import importlib

from repro_torch.configs.paper_zoo import (  # noqa: F401
    CASE_STUDY_GAMMA,
    CASE_STUDY_MODELS,
    PAPER_ZOO,
    TABLE1,
)
from repro_torch.configs.reduced import reduce_config  # noqa: F401
from repro_torch.configs.shapes import (  # noqa: F401
    INPUT_SHAPES,
    InputShape,
    long_context_note,
    token_specs,
)
from repro_torch.models.common import ModelConfig

# arch id -> module (one file per assigned architecture)
_ASSIGNED_MODULES = {
    "internvl2-2b": "internvl2_2b",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "mamba2-130m": "mamba2_130m",
    "qwen2.5-14b": "qwen2_5_14b",
    "deepseek-67b": "deepseek_67b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "llama3.2-3b": "llama3_2_3b",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "qwen3-1.7b": "qwen3_1_7b",
}

ASSIGNED_ARCHS = tuple(_ASSIGNED_MODULES)


def get_config(arch: str) -> ModelConfig:
    """Resolve an --arch id (assigned archs, paper zoo, or '<id>-reduced')."""
    if arch.endswith("-reduced"):
        return reduce_config(get_config(arch[: -len("-reduced")]))
    if arch in _ASSIGNED_MODULES:
        mod = importlib.import_module(f"repro_torch.configs.{_ASSIGNED_MODULES[arch]}")
        return mod.CONFIG
    if arch in PAPER_ZOO:
        return PAPER_ZOO[arch]
    raise KeyError(
        f"unknown arch {arch!r}; assigned={sorted(_ASSIGNED_MODULES)}, "
        f"paper zoo={sorted(PAPER_ZOO)}")


def list_archs() -> list[str]:
    return sorted(_ASSIGNED_MODULES) + sorted(PAPER_ZOO)
