"""PyTorch/CUDA port of the `repro` package (offline energy-optimal LLM
serving), built for an NVIDIA H100.

The module layout mirrors `repro`: each module here has its counterpart at
the same path there.  Entry points run on the GPU (`device="cuda"`) unless
the caller asks for the CPU; nothing moves to the CPU on its own.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device a caller asked for, checked.  Raises when CUDA is asked
    for (the default) and no CUDA device is present."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on the CPU")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
