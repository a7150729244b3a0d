"""InternVL2 language backbone (VLM family): parameter definitions.

Port of the shape tables of `repro.models.vlm`: the dense decoder's
parameters plus the MLP projector (VISION_DIM -> d_model) that feeds the
stubbed vision tower's patch embeddings into the causal stream.  The cost
model and the simulator count its parameters through them.  The forward
passes are not ported yet: ROADMAP queue 1.
"""

from __future__ import annotations

from repro_torch.models import dense
from repro_torch.models.common import ModelConfig, ParamDef

VISION_DIM = 1024  # InternViT-300M output width (frontend stub contract)


def param_defs(cfg: ModelConfig) -> dict:
    defs = dense.param_defs(cfg)
    defs["projector"] = {
        "w1": ParamDef((VISION_DIM, cfg.d_model), (None, "embed_w")),
        "b1": ParamDef((cfg.d_model,), (None,), init="zeros"),
        "w2": ParamDef((cfg.d_model, cfg.d_model), ("embed_w", None)),
        "b2": ParamDef((cfg.d_model,), (None,), init="zeros"),
    }
    return defs
