"""Config registry: the paper's 7-model zoo and the ported assigned
architectures by --arch id, plus the reduced smoke variants
('<id>-reduced').

Of the repo's ten assigned architectures, mamba2-130m (ssm) and
recurrentgemma-9b (hybrid) are ported; asking for another raises a
KeyError that says so (they arrive with their model families, ROADMAP
queue 1)."""

from __future__ import annotations

from repro_torch.configs.paper_zoo import (  # noqa: F401
    CASE_STUDY_GAMMA,
    CASE_STUDY_MODELS,
    PAPER_ZOO,
    TABLE1,
)
from repro_torch.configs.mamba2_130m import CONFIG as MAMBA2_130M
from repro_torch.configs.recurrentgemma_9b import CONFIG as RECURRENTGEMMA_9B
from repro_torch.configs.reduced import reduce_config  # noqa: F401
from repro_torch.models.common import ModelConfig

ASSIGNED_ARCHS = (
    "internvl2-2b", "granite-moe-3b-a800m", "mamba2-130m", "qwen2.5-14b",
    "deepseek-67b", "seamless-m4t-large-v2", "llama3.2-3b",
    "deepseek-v3-671b", "recurrentgemma-9b", "qwen3-1.7b",
)

# the assigned archs whose family is ported
PORTED_ASSIGNED = {c.name: c for c in (MAMBA2_130M, RECURRENTGEMMA_9B)}


def get_config(arch: str) -> ModelConfig:
    """Resolve an --arch id (paper zoo, ported assigned arch, or
    '<id>-reduced')."""
    if arch.endswith("-reduced"):
        return reduce_config(get_config(arch[: -len("-reduced")]))
    if arch in PAPER_ZOO:
        return PAPER_ZOO[arch]
    if arch in PORTED_ASSIGNED:
        return PORTED_ASSIGNED[arch]
    if arch in ASSIGNED_ARCHS:
        raise KeyError(
            f"arch {arch!r} is not yet ported to repro_torch; it comes with "
            f"its model family (ROADMAP queue 1)")
    raise KeyError(f"unknown arch {arch!r}; paper zoo={sorted(PAPER_ZOO)}")
