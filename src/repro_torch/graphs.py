"""Compiled steps: the port's counterpart of `jax.jit`.

The reference jits its serving engine's prefill and decode step and its
training step, so each call runs one XLA program compiled for the call's
input signature.  Here such a program is a `Step`: a body over static
buffers, keyed as XLA keys its programs (`signature`: each input tensor's
name, shape and dtype), which every call first copies its inputs into
(`copy_into`; nothing is copied where the caller passes the statics
themselves).  On CUDA the body is captured once into a
`torch.cuda.CUDAGraph`: an eager run on a side stream first (`warm_up`,
which also loads the kernels' modules and sizes B1's workspace), then
`capture` on the same stream into a memory pool the caller owns; every
later call replays the graph.  The CPU runs the body eagerly each call.
A failed capture or replay raises: nothing falls back to eager steps.

The kernel modules count their launches (B3 and B4 their backward
launches too, `bwd_launches`).  A capture runs nothing on the device, so
it takes the launches it made back out of the counts and records them in
the step, and each replay adds them again: the counts stay the work the
calls did.

`serving.engine.InferenceEngine` and `launch.steps.compile_train_step`
build their steps from these parts.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.kernels import decode_attention as _kda
from repro_torch.kernels import rglru_scan as _krg
from repro_torch.kernels import ssd_scan as _kss


class BackwardCount:
    """A kernel module's backward launch count (`bwd_launches`), read and
    written as `launches`, the way a module's forward count is."""

    def __init__(self, mod):
        self.mod = mod
        self.__name__ = f"{mod.__name__}.bwd_launches"

    @property
    def launches(self) -> int:
        return self.mod.bwd_launches

    @launches.setter
    def launches(self, n: int) -> None:
        self.mod.bwd_launches = n


# The launch counts a replay adds to: B1, B3 and B4 forward, B3 and B4
# backward.
COUNTERS = (_kda, _kss, BackwardCount(_kss), _krg, BackwardCount(_krg))


def tensors(x):
    """The tensors of a step's inputs or outputs (dicts, caches, tuples), in
    a fixed order, with their names."""
    if isinstance(x, torch.Tensor):
        yield "", x
    elif isinstance(x, dict):
        for k in sorted(x):
            for name, t in tensors(x[k]):
                yield f"{k}.{name}" if name else k, t
    elif dataclasses.is_dataclass(x):
        for f in dataclasses.fields(x):
            for name, t in tensors(getattr(x, f.name)):
                yield f"{f.name}.{name}" if name else f.name, t
    elif isinstance(x, (tuple, list)):
        for i, v in enumerate(x):
            for name, t in tensors(v):
                yield f"{i}.{name}" if name else str(i), t


def signature(x) -> tuple:
    """What jax.jit keys a program on besides its static arguments: each
    input tensor's name, shape and dtype."""
    return tuple((name, tuple(t.shape), t.dtype) for name, t in tensors(x))


def copy_into(static, value) -> None:
    """Copy `value`'s tensors into the same-shaped static buffers."""
    for (_, dst), (_, src) in zip(tensors(static), tensors(value), strict=True):
        if dst is not src:
            dst.copy_(src)


class Step:
    """One compiled program: `body` over the static buffers `inputs`.
    Eager on the CPU (and before its capture); once `capture` has captured
    the body, every call replays its graph and adds the launches the
    capture recorded to each count.  Outputs made inside the graph hold
    only until the next replay of a graph in the same pool: the caller
    reads or copies each before its next call."""

    def __init__(self, key: tuple, inputs: dict, body: Callable):
        self.key, self.inputs, self.body = key, inputs, body
        self.graph = None            # torch.cuda.CUDAGraph, once captured
        self.outputs = None          # the graph's static outputs (eager: the last)
        self.launches: tuple = ()    # (count, launches a replay)
        self.workspaces: list = []   # B1 workspaces the graph writes

    def __call__(self, inputs: dict):
        for k, v in inputs.items():
            copy_into(self.inputs[k], v)
        if self.graph is None:
            self.outputs = self.body()
            return self.outputs
        self.graph.replay()
        for mod, n in self.launches:
            mod.launches += n
        return self.outputs


def warm_up(step: Step, stream: torch.cuda.Stream):
    """Run `step`'s body eagerly on `stream`, after the current stream's
    work and before its later work.  Its launches stay counted.  Returns
    its outputs."""
    cur = torch.cuda.current_stream(stream.device)
    stream.wait_stream(cur)
    with torch.cuda.stream(stream):
        out = step.body()
    cur.wait_stream(stream)
    return out


def capture(step: Step, *, pool, stream: torch.cuda.Stream, counters=COUNTERS,
            generators=()) -> None:
    """Capture `step`'s body into a CUDA graph on `stream` (on which it was
    warmed up) into `pool`, the graph drawing from each of `generators`.
    Records in the step the launches the capture made per count and takes
    them back out of the counts, keeps the B1 workspaces the graph writes,
    and sets the step's graph and static outputs."""
    before = [m.launches for m in counters]
    graph = torch.cuda.CUDAGraph()
    for g in generators:
        graph.register_generator_state(g)
    with _kda.record_workspaces() as used, \
            torch.cuda.graph(graph, pool=pool, stream=stream):
        outputs = step.body()
    step.launches = tuple((m, m.launches - b) for m, b in zip(counters, before)
                          if m.launches != b)
    for m, b in zip(counters, before):
        m.launches = b
    step.graph, step.outputs, step.workspaces = graph, outputs, used


def pool_bytes(pool) -> int:
    """Device memory a graph pool holds (its reserved segments)."""
    return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
               if tuple(s.get("segment_pool_id", ())) == tuple(pool))
