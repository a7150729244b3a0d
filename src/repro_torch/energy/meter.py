"""Energy meters — the PyJoules/uProf adaptation layer (paper §3.2).

Port of `repro.energy.meter`.  `WallClockMeter` measures real wall time
and converts to joules with the host power model (the AMD-uProf method:
power-per-active-core x time).  `ModeledMeter` instead charges an analytic
roofline energy for a declared cost.

Both expose  measure(fn) -> (result, seconds, joules)  — the engine's
metering contract.  A timed window ends when the device has finished the
work: `torch.cuda.synchronize()` when the result holds a CUDA tensor,
where the reference calls `jax.block_until_ready`.
"""

from __future__ import annotations

import time

import torch

from repro_torch.energy.hardware import GENERIC_HOST, HostSpec, Node


def block_until_ready(out):
    """Wait for the device work behind `out` (a tensor or a tuple/list
    holding some), then return it."""
    items = out if isinstance(out, (tuple, list)) else (out,)
    for x in items:
        if isinstance(x, torch.Tensor) and x.is_cuda:
            torch.cuda.synchronize(x.device)
            break
    return out


class WallClockMeter:
    """E = P·t with P from the host spec (cores actively serving)."""

    def __init__(self, host: HostSpec = GENERIC_HOST):
        self.host = host
        self.total_s = 0.0
        self.total_j = 0.0

    @property
    def power_w(self) -> float:
        return self.host.idle_w / 4.0 + self.host.active_w_per_core * self.host.serving_cores

    def measure(self, fn):
        t0 = time.perf_counter()
        out = block_until_ready(fn())
        dt = time.perf_counter() - t0
        joules = self.power_w * dt
        self.total_s += dt
        self.total_j += joules
        return out, dt, joules


class ModeledMeter:
    """Wall time measured; energy charged from a per-call cost estimate
    produced by `cost_fn() -> (flops, bytes)` against a Node power model."""

    def __init__(self, node: Node, cost_fn):
        self.node = node
        self.cost_fn = cost_fn
        self.total_s = 0.0
        self.total_j = 0.0

    def measure(self, fn):
        t0 = time.perf_counter()
        out = block_until_ready(fn())
        dt = time.perf_counter() - t0
        flops, bytes_ = self.cost_fn()
        a = self.node.accel
        joules = (a.idle_w * self.node.n_accel * dt
                  + a.j_per_flop * flops + a.j_per_byte_hbm * bytes_)
        self.total_s += dt
        self.total_j += joules
        return out, dt, joules
