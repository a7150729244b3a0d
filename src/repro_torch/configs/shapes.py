"""The four assigned input shapes and the per-family model inputs.

Port of `repro.configs.shapes`: the stubbed frontends' input contract.
`token_specs(cfg, shape)` gives the model inputs of one step kind as
tensors on the meta device, which carry a shape and a torch dtype and
allocate nothing.  Decode shapes take ONE token against a cache of
seq_len (window-bounded for the long_500k sliding-window and recurrent
modes).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.common import ModelConfig
from repro_torch.models.vlm import VISION_DIM


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                 # train | prefill | decode
    long_context: bool = False


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode", long_context=True),
}


def _spec(shape: tuple, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _i32(*shape) -> torch.Tensor:
    return _spec(shape, torch.int32)


def token_specs(cfg: ModelConfig, shape: InputShape) -> dict:
    """Model inputs (tokens / frontend-stub embeddings) for one step kind.
    A decode step's cache is a separate argument (the family's
    `init_cache`)."""
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        return {"token": _i32(B)}
    if cfg.family == "vlm":
        s_txt = S - cfg.n_patches
        specs = {"patches": _spec((B, cfg.n_patches, VISION_DIM), cfg.dtype),
                 "tokens": _i32(B, s_txt)}
    elif cfg.family == "encdec":
        specs = {"frames": _spec((B, cfg.n_frames, cfg.d_model), cfg.dtype),
                 "tokens": _i32(B, S)}
    else:
        specs = {"tokens": _i32(B, S)}
    if shape.kind == "train":
        specs["labels"] = _i32(*specs["tokens"].shape)
    return specs


def long_context_note(cfg: ModelConfig) -> str:
    """How each family runs the 524288-token decode."""
    if cfg.family == "ssm":
        return "native (constant-size SSD state)"
    if cfg.family == "hybrid":
        return "native (RG-LRU state + local attention window)"
    return f"sliding_window({cfg.long_context_window})"
