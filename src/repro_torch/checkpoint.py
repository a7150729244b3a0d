"""Checkpointing: save/restore parameter + optimizer-state trees.

Port of `repro.checkpoint`, in its on-disk format, so a checkpoint moves
between the packages: one raw `.npy` per tensor, named `t%05d.npy` in the
sorted `/`-joined path order, beside a `manifest.json` with `step`,
`metadata` and `tensors` (path -> file and dtype).  bfloat16 is stored as
its uint16 view and float8 as its uint8 view (npy has neither type).
Atomic: written to a temporary directory beside `path`, then renamed.
`load_checkpoint` places every tensor on `device`, the card by default
(the reference takes a tree of shardings instead).
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
from pathlib import Path
from typing import Any

import numpy as np
import torch

from repro_torch import resolve_device


def flatten_tree(tree: Any, prefix: str = "") -> list[tuple[str, Any]]:
    """(path, leaf) pairs of a nested dict, in sorted `/`-joined path order."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(flatten_tree(tree[k], f"{prefix}/{k}" if prefix else str(k)))
        return out
    return [(prefix, tree)]


def unflatten_tree(items: dict[str, Any]) -> dict:
    root: dict = {}
    for path, v in items.items():
        keys = path.split("/")
        node = root
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = v
    return root


def _to_numpy(t: torch.Tensor) -> tuple[np.ndarray, str]:
    """A tensor's bytes as numpy (bf16 as uint16, float8 as uint8) and its
    dtype's name as the reference writes it."""
    dtype = str(t.dtype).removeprefix("torch.")
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), dtype
    if "float8" in dtype:
        return t.view(torch.uint8).numpy(), dtype
    return t.numpy(), dtype


def _from_numpy(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    if "float8" in dtype:
        return torch.from_numpy(arr).view(getattr(torch, dtype))
    return torch.from_numpy(arr)


def save_checkpoint(path: str | Path, tree: Any, *, step: int = 0,
                    metadata: dict | None = None) -> None:
    """Write `tree` (nested dict of tensors) to `path` atomically."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=path.parent, prefix=path.name + ".tmp"))
    manifest: dict = {"step": step, "metadata": metadata or {}, "tensors": {}}
    try:
        for i, (name, leaf) in enumerate(flatten_tree(tree)):
            arr, dtype = _to_numpy(leaf)
            fname = f"t{i:05d}.npy"
            np.save(tmp / fname, arr)
            manifest["tensors"][name] = {"file": fname, "dtype": dtype}
        (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
        if path.exists():
            shutil.rmtree(path)
        os.replace(tmp, path)
    finally:
        if tmp.exists():
            shutil.rmtree(tmp, ignore_errors=True)


def load_checkpoint(path: str | Path, *, device: str | torch.device = "cuda"
                    ) -> tuple[dict, int, dict]:
    """Returns (tree, step, metadata), every tensor on `device`: the card
    unless the caller asks for the CPU."""
    device = resolve_device(device)
    path = Path(path)
    manifest = json.loads((path / "manifest.json").read_text())
    items = {name: _from_numpy(np.load(path / info["file"]), info["dtype"]).to(device)
             for name, info in manifest["tensors"].items()}
    return unflatten_tree(items), int(manifest["step"]), manifest["metadata"]


def latest_step(ckpt_dir: str | Path) -> int | None:
    """Highest step among `step_NNNNN` children of ckpt_dir."""
    d = Path(ckpt_dir)
    if not d.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in d.glob("step_*")
             if p.name.split("_")[1].isdigit()]
    return max(steps) if steps else None


def step_path(ckpt_dir: str | Path, step: int) -> Path:
    return Path(ckpt_dir) / f"step_{step:08d}"
