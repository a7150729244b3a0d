"""Config registry: the paper's 7-model zoo by --arch id, plus the reduced
smoke variants ('<id>-reduced').

The repo's ten assigned architectures are not ported yet; asking for one
raises a KeyError that says so (they arrive with their model families,
ROADMAP queue 1)."""

from __future__ import annotations

from repro_torch.configs.paper_zoo import (  # noqa: F401
    CASE_STUDY_GAMMA,
    CASE_STUDY_MODELS,
    PAPER_ZOO,
    TABLE1,
)
from repro_torch.configs.reduced import reduce_config  # noqa: F401
from repro_torch.models.common import ModelConfig

ASSIGNED_ARCHS = (
    "internvl2-2b", "granite-moe-3b-a800m", "mamba2-130m", "qwen2.5-14b",
    "deepseek-67b", "seamless-m4t-large-v2", "llama3.2-3b",
    "deepseek-v3-671b", "recurrentgemma-9b", "qwen3-1.7b",
)


def get_config(arch: str) -> ModelConfig:
    """Resolve an --arch id (paper zoo, or '<id>-reduced')."""
    if arch.endswith("-reduced"):
        return reduce_config(get_config(arch[: -len("-reduced")]))
    if arch in PAPER_ZOO:
        return PAPER_ZOO[arch]
    if arch in ASSIGNED_ARCHS:
        raise KeyError(
            f"arch {arch!r} is not yet ported to repro_torch; it comes with "
            f"its model family (ROADMAP queue 1)")
    raise KeyError(f"unknown arch {arch!r}; paper zoo={sorted(PAPER_ZOO)}")
