"""Per-device FLOPs, collective bytes and peak live bytes of a traced step.

The counterpart of `repro.analysis.hlo`, which parses the post-SPMD HLO of
a compiled step.  Torch produces no HLO: `StepCounter` is a
`TorchDispatchMode` that watches the step run, on DTensors over a mesh,
and counts what one device does:

  * FLOPs of each op on its **local shard**, by the formulas of
    `torch.utils.flop_counter` (and its decompositions, as
    `FlopCounterMode` takes them), so replicated work counts once on every
    device, as the reference's per-device HLO counts it.  (A
    `FlopCounterMode` around DTensor ops sees each op once at its global
    shape: the cluster's work, not a device's.)
  * the operand bytes of each functional collective that DTensor issues,
    by kind under the reference's opcode names (`COLLECTIVE_OPS`);
  * the peak of live storage bytes on the device, the state the step was
    given included (`track`), each storage rounded up to the CUDA caching
    allocator's 512-byte blocks; with `timeline=True` also the live bytes
    after each op, in order (`timeline`), from which the dry run extends
    the peak of a shallow step to its full depth.

The mode lets DTensor turn each op into local ops and collectives first
(it returns NotImplemented for DTensor operands, as `CommDebugMode` does)
and ignores the global-shape ops that DTensor's sharding propagation runs
on fake tensors to learn output shapes.

The reference multiplies while bodies by their trip counts; the port
loops over layers and microbatches in Python and every iteration is seen,
so no such step exists here.  Its `float_normalization_bytes` corrects an
XLA:CPU artifact (f32 copies of bf16 stacks that the target never holds)
and has no counterpart: nothing here is upcast behind the program's back.
"""

from __future__ import annotations

import contextlib
import dataclasses
import weakref
from collections import defaultdict

import torch
import torch.utils._pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

COLLECTIVE_OPS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                  "collective-permute")

# functional collective -> the reference's opcode
_COLLECTIVES = {
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
}

_BLOCK = 512   # the CUDA caching allocator's rounding

_aten = torch.ops.aten
# metadata queries FlopCounterMode also passes through uncounted
_SKIP = {_aten.sym_is_contiguous.default, _aten.is_contiguous.default,
         _aten.is_contiguous.memory_format, _aten.is_strides_like_format.default,
         _aten.is_non_overlapping_and_dense.default, _aten.size.default,
         _aten.sym_size.default, _aten.stride.default, _aten.sym_stride.default,
         _aten.storage_offset.default, _aten.sym_storage_offset.default,
         _aten.numel.default, _aten.sym_numel.default, _aten.dim.default,
         torch.ops.prim.layout.default}


@dataclasses.dataclass
class Totals:
    flops: float = 0.0
    collective_bytes: dict = dataclasses.field(default_factory=lambda: defaultdict(float))
    collective_count: dict = dataclasses.field(default_factory=lambda: defaultdict(float))

    def add(self, other: "Totals", mult: float = 1.0) -> None:
        self.flops += other.flops * mult
        for k, v in other.collective_bytes.items():
            self.collective_bytes[k] += v * mult
        for k, v in other.collective_count.items():
            self.collective_count[k] += v * mult

    @property
    def total_collective_bytes(self) -> float:
        return float(sum(self.collective_bytes.values()))


_propagating = 0


def _planning(fn, count_as_propagation: bool):
    """fn run with the fake mode off (DTensor's planners build small real
    index tensors and read them back) and, if asked, its ops not counted."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily

    def wrapped(*args, **kwargs):
        global _propagating
        _propagating += count_as_propagation
        try:
            with unset_fake_temporarily():
                return fn(*args, **kwargs)
        finally:
            _propagating -= count_as_propagation

    return wrapped


@contextlib.contextmanager
def _dtensor_planning_outside_fake_mode():
    """While tracing: DTensor's sharding propagation (which also runs each
    new op once at its global shape on fake tensors of its own, to learn
    the output's shape: not the device's work) and its redistribution
    planner run outside the trace's fake mode and uncounted."""
    from torch.distributed.tensor import DTensor, _redistribute

    from torch.distributed.tensor import placement_types

    prop = DTensor._op_dispatcher.sharding_propagator
    patches = [(prop, "propagate", True), (prop, "propagate_op_sharding", True),
               (prop, "propagate_op_sharding_non_cached", True),
               (_redistribute, "_gen_transform_infos_non_cached", False)]
    strided = getattr(placement_types, "_StridedShard", None)
    if strided is not None and "local_shard_size_and_offset" in strided.__dict__:
        patches.append((strided, "local_shard_size_and_offset", False))
    saved = []
    for owner, name, uncounted in patches:
        raw = owner.__dict__.get(name)
        orig = getattr(owner, name, None)
        if orig is None:
            continue
        saved.append((owner, name, raw))
        if isinstance(raw, staticmethod):
            setattr(owner, name, staticmethod(_planning(raw.__func__, uncounted)))
        elif isinstance(raw, classmethod):
            setattr(owner, name, classmethod(_planning(raw.__func__, uncounted)))
        elif isinstance(owner, type) and raw is not None:
            setattr(owner, name, _planning(raw, uncounted))
        else:
            setattr(owner, name, _planning(orig, uncounted))
    try:
        yield
    finally:
        for owner, name, orig in saved:
            if orig is None:
                delattr(owner, name)
            else:
                setattr(owner, name, orig)


def _bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class StepCounter(TorchDispatchMode):
    """Counts one device's work while active: `totals` (FLOPs, collective
    bytes and counts by kind), `live` and `peak` (bytes), and with
    timeline=True `timeline`: (op, live bytes once its outputs are held)
    for each op counted, in order."""

    def __init__(self, timeline: bool = False):
        super().__init__()
        self.totals = Totals()
        self.live = 0
        self.peak = 0
        self.timeline: list | None = [] if timeline else None
        self._storages: dict[int, weakref.finalize] = {}
        self._stack = contextlib.ExitStack()
        self._depth = 0

    # -- memory ------------------------------------------------------------
    def _free(self, key: int, nbytes: int) -> None:
        self._storages.pop(key, None)
        self.live -= nbytes

    def _hold(self, t: torch.Tensor) -> None:
        from torch.distributed.tensor import DTensor

        if isinstance(t, DTensor):
            t = t._local_tensor
        st = t.untyped_storage()
        key = id(st)
        if key in self._storages:
            return
        nbytes = -(-st.nbytes() // _BLOCK) * _BLOCK
        self._storages[key] = weakref.finalize(st, self._free, key, nbytes)
        self.live += nbytes
        self.peak = max(self.peak, self.live)

    def track(self, *trees) -> None:
        """Count the tensors of `trees` (params, optimizer state, inputs,
        caches) as live from now until they die."""
        for tree in trees:
            for leaf in _leaves(tree):
                self._hold(leaf)

    # -- the mode ----------------------------------------------------------
    def __enter__(self):
        # the mode re-enters itself to count decompositions: patch once
        if not self._depth:
            self._stack.enter_context(_dtensor_planning_outside_fake_mode())
        self._depth += 1
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._depth -= 1
            if not self._depth:
                self._stack.close()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types) or func in _SKIP:
            return NotImplemented
        if _propagating:
            return func(*args, **kwargs)
        if func not in flop_registry and func is not torch.ops.prim.device.default:
            with self:
                r = func.decompose(*args, **kwargs)
                if r is not NotImplemented:
                    return r
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        if packet in flop_registry:
            # an overload's dtype argument (bmm.dtype's out_dtype) is no
            # shape: the formulas take the operands' shapes alone
            shaped = tuple(a for a in args if not isinstance(a, torch.dtype))
            self.totals.flops += flop_registry[packet](*shaped, **kwargs, out_val=out)
        ns = getattr(packet, "_qualified_op_name", "")
        if "c10d_functional::" in ns:
            name = ns.split("::", 1)[1]
            if name in _COLLECTIVES:
                kind = _COLLECTIVES[name]
                self.totals.collective_bytes[kind] += sum(
                    _bytes(t) for t in pytree.tree_leaves((args[0],))
                    if isinstance(t, torch.Tensor))
                self.totals.collective_count[kind] += 1
        for t in pytree.tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self._hold(t)
        if self.timeline is not None and func is not torch.ops.prim.device.default:
            self.timeline.append((func, self.live))
        return out


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _leaves(getattr(tree, f.name))
