"""Carry weights from the JAX package into the port, by value.

`from_jax_params` takes the reference's param tree with its leaves as
numpy arrays (`jax.tree.map(np.asarray, params)`) and returns the port's
tree of tensors.  It is the only way weights cross between the packages:
torch cannot redraw the reference's `jax.random` values.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.checkpoint import flatten_tree
from repro_torch.models import get_api
from repro_torch.models.common import ModelConfig, _flatten_defs, _set_path


def from_jax_params(cfg: ModelConfig, tree: dict, device) -> dict:
    """Copy a tree of numpy arrays shaped like `cfg`'s params onto `device`.
    Raises on a missing, extra, mis-shaped or mis-typed leaf."""
    defs = dict(_flatten_defs(get_api(cfg).param_defs(cfg)))
    leaves = dict(flatten_tree(tree))
    missing, extra = sorted(defs.keys() - leaves.keys()), sorted(leaves.keys() - defs.keys())
    if missing or extra:
        raise ValueError(f"{cfg.name}: param tree missing {missing}, extra {extra}")
    params: dict = {}
    for path, d in defs.items():
        arr = np.asarray(leaves[path])
        if arr.shape != d.shape:
            raise ValueError(f"{cfg.name}: {path} has shape {arr.shape}, want {d.shape}")
        if arr.dtype.name != cfg.param_dtype:
            raise ValueError(f"{cfg.name}: {path} is {arr.dtype.name}, want {cfg.param_dtype}")
        # bfloat16 has no numpy dtype torch reads; widening to f32 is exact.
        host = torch.from_numpy(np.array(
            arr, dtype=np.float32 if arr.dtype.name == "bfloat16" else arr.dtype))
        _set_path(params, path, host.to(device=device, dtype=cfg.dtype))
    return params
