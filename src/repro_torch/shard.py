"""Logical-axis sharding: the one leaf module models and launch both import.

Port of `repro.shard` onto DTensor.  Models annotate activations and params
with *logical* axis names ("batch", "heads", "mlp", "expert", ...).  A
rules table maps logical names to mesh axes.  Outside any rules context
(CPU unit tests, one-card serving) every constraint is a no-op, so the
model code runs unchanged on one device.

A spec is a `P`: a tuple of mesh-axis entries, one per tensor dim (a mesh
axis name, a tuple of them, or None), with trailing Nones trimmed, so that
`tuple(P)` compares equal to the reference's `tuple(PartitionSpec)`.
`to_placements` turns one into DTensor placements on a `DeviceMesh`.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
from typing import Mapping, Sequence

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

# logical axis -> mesh axis (str), tuple of mesh axes, or None (replicated)
Rules = Mapping[str, object]

# Baseline rules for the production mesh ("data", "model") [+ "pod"].
# "pod" is folded into the batch axis by make_rules(multi_pod=True).
DEFAULT_RULES: dict[str, object] = {
    "batch": "data",
    "seq": None,          # activation sequence dim ("model" = Megatron-SP, set for train)
    "kv_seq": "model",    # KV-cache sequence dim: flash-decode layout by default
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "embed": None,        # activation d_model dim
    "embed_w": None,      # weight d_model (contraction) dim
    "mlp": "model",       # d_ff
    "vocab": "model",
    "expert": "model",
    "capacity": "data",   # MoE expert-capacity dim
    "moe_embed": "model",  # d dim of token-major MoE intermediates (gathers
                           # run locally per d-shard; rows stay replicated)
    "ssm_heads": "model",
    "state": None,
    "lru": "model",
    "frames": None,
    "layers": None,
}


class P(tuple):
    """A partition spec: one entry per tensor dim, trailing Nones trimmed."""
    def __new__(cls, *entries):
        entries = list(entries)
        while entries and entries[-1] is None:
            entries.pop()
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"

    def __reduce__(self):
        return (P, tuple(self))


_rules_var: contextvars.ContextVar[Rules | None] = contextvars.ContextVar(
    "shard_rules", default=None
)
_axis_sizes_var: contextvars.ContextVar[dict | None] = contextvars.ContextVar(
    "shard_axis_sizes", default=None
)


def make_rules(*, multi_pod: bool = False, overrides: Rules | None = None) -> dict:
    rules = dict(DEFAULT_RULES)
    if multi_pod:
        rules["batch"] = ("pod", "data")
    if overrides:
        rules.update(overrides)
    return rules


@contextlib.contextmanager
def use_rules(rules: Rules | None, axis_sizes: dict | None = None):
    """Activate logical-axis rules.  Pass the mesh's {axis: size} so
    constraints are legalized consistently with input shardings (see
    legalize_spec).  While rules are active, views, matmuls and einsums
    of DTensors go through `_DTensorLayouts`."""
    token = _rules_var.set(rules)
    token2 = _axis_sizes_var.set(axis_sizes)
    try:
        with _DTensorLayouts() if rules is not None else contextlib.nullcontext():
            yield
    finally:
        _rules_var.reset(token)
        _axis_sizes_var.reset(token2)


def current_rules() -> Rules | None:
    return _rules_var.get()


def current_axis_sizes() -> dict | None:
    return _axis_sizes_var.get()


def legalize_spec(shape: tuple, spec: P, axis_sizes: dict) -> P:
    """Make `spec` divisibility-valid for `shape` by RELOCATING any mesh
    axis on a non-dividing dim to the largest free dim it divides.

    This is the layout policy, not just a fallback:
      * GQA kv=8 weights against a model=16 axis -> row-parallel (d_model)
      * KV caches with few kv heads -> sequence-sharded (flash-decode)
      * odd vocab (92553) -> shard d_model instead

    Deterministic, so model-internal constraints and input layouts
    resolve to the SAME layout (no hidden reshards)."""
    entries: list = list(spec) + [None] * (len(shape) - len(spec))

    def factor(entry) -> int:
        if entry is None:
            return 1
        axes = entry if isinstance(entry, tuple) else (entry,)
        f = 1
        for a in axes:
            f *= axis_sizes[a]
        return f

    for i in range(len(entries)):
        e = entries[i]
        if e is None:
            continue
        f = factor(e)
        if f <= 1 or shape[i] % f == 0:
            continue
        entries[i] = None
        candidates = sorted(
            (j for j in range(len(entries))
             if entries[j] is None and shape[j] % f == 0 and shape[j] >= f),
            key=lambda j: -shape[j])
        if candidates:
            entries[candidates[0]] = e
    return P(*entries)


def resolve(axes: Sequence[str | None], rules: Rules | None = None) -> P:
    """Logical axes -> P under the active rules.  A mesh axis may appear
    only once per spec: first logical occurrence wins (e.g. an MoE expert
    weight [E, d, ff] with expert->model keeps ff replicated)."""
    if rules is None:
        rules = current_rules()
    if rules is None:
        return P()
    entries = []
    used: set = set()
    for ax in axes:
        entry = None if ax is None else rules.get(ax, None)
        if entry is not None:
            mesh_axes = entry if isinstance(entry, tuple) else (entry,)
            if any(a in used for a in mesh_axes):
                entry = None
            else:
                used.update(mesh_axes)
        entries.append(entry)
    return P(*entries)


def to_placements(spec: Sequence, mesh) -> tuple:
    """DTensor placements on `mesh` (a DeviceMesh with named dims) for a
    spec: a tensor dim whose entry names a mesh axis is `Shard(dim)` on
    that mesh dim, every other mesh dim `Replicate()`.  A tuple entry
    ("pod", "data") shards one tensor dim over both mesh dims, the first
    named the major one, as JAX does; DTensor splits a dim sharded on
    several mesh dims in mesh-dim order, so the tuple must follow it."""

    names = list(mesh.mesh_dim_names)
    placements: list = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r} is not in the mesh's dim order {names}")
        for i in idx:
            placements[i] = Shard(dim)
    return tuple(placements)


def constrain(x: torch.Tensor, *axes: str | None) -> torch.Tensor:
    """The reference's `with_sharding_constraint` via logical axes: with
    rules active and `x` a DTensor, `x` redistributed to the legalized
    placements; `x` itself without rules, when it is a plain tensor, or
    when the spec is empty (as in the reference, which then leaves the
    layout to the partitioner)."""
    rules = current_rules()
    if rules is None or not isinstance(x, DTensor):
        return x
    spec = resolve(axes, rules)
    sizes = current_axis_sizes()
    if sizes:
        spec = legalize_spec(tuple(x.shape), spec, sizes)
    if not spec:
        return x
    placements = to_placements(spec, x.device_mesh)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(x.device_mesh, placements)


def redistribute_like(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """x laid out as `like` is, when both are DTensors; x otherwise."""
    if not (isinstance(x, DTensor) and isinstance(like, DTensor)):
        return x
    if tuple(x.placements) == tuple(like.placements):
        return x
    return x.redistribute(like.device_mesh, like.placements)


# ---------------------------------------------------------------------------
# Running code on each device's shards
# ---------------------------------------------------------------------------


def is_dtensor(x) -> bool:
    return isinstance(x, DTensor)


def mesh_dims_of(x, dim: int) -> list[int]:
    """The mesh dims that shard tensor dim `dim` of DTensor x, in mesh
    order (the first the major one)."""
    return [i for i, p in enumerate(x.placements) if p.is_shard(dim)]


def shard_offset(x, dim: int) -> tuple[int, int]:
    """(offset, length) of this device's piece of tensor dim `dim` of
    DTensor x (dims split evenly, as legalized specs guarantee)."""
    mesh = x.device_mesh
    coord = mesh.get_coordinate()
    n, idx = 1, 0
    for i in mesh_dims_of(x, dim):
        idx = idx * mesh.size(i) + coord[i]
        n *= mesh.size(i)
    length = x.shape[dim] // n
    return idx * length, length


def gather_dim(x, dim: int):
    """x with tensor dim `dim` whole on every device (an all-gather when a
    DTensor shards it); x itself otherwise."""
    if not is_dtensor(x) or not mesh_dims_of(x, dim):
        return x

    placements = [Replicate() if p.is_shard(dim) else p for p in x.placements]
    return x.redistribute(x.device_mesh, placements)


def reduce_partial(x):
    """x with its pending (partial) sums reduced, when a DTensor holds
    any: those mesh dims become Replicate."""
    if not is_dtensor(x) or not any(p.is_partial() for p in x.placements):
        return x

    placements = [Replicate() if p.is_partial() else p for p in x.placements]
    return x.redistribute(x.device_mesh, placements)


def moved(placements, keep: dict) -> tuple:
    """Placements for a tensor derived from one with `placements`: a mesh
    dim sharding tensor dim d shards dim keep[d] of the new tensor, or
    replicates it when d is not in `keep`."""
    return tuple(Shard(keep[p.dim]) if p.is_shard() and p.dim in keep else Replicate()
                 for p in placements)


def replicated(fn):
    """fn run on the whole value of its DTensor arguments (each gathered to
    every device) with its tensor outputs replicated DTensors, as a
    partitioner replicates an op it has no sharded form of.  Plain
    arguments pass as they are; without DTensor arguments fn runs as is."""

    def run(*args):
        mesh = next((a.device_mesh for a in args if isinstance(a, DTensor)), None)
        if mesh is None:
            return fn(*args)
        rep = (Replicate(),) * mesh.ndim
        out = fn(*(a.redistribute(mesh, rep).to_local() if isinstance(a, DTensor) else a
                   for a in args))

        def wrap(t):
            if isinstance(t, torch.Tensor):
                return DTensor.from_local(t, mesh, rep, run_check=False)
            if dataclasses.is_dataclass(t):
                return type(t)(**{f.name: wrap(getattr(t, f.name))
                                  for f in dataclasses.fields(t)})
            if isinstance(t, tuple):
                return tuple(wrap(v) for v in t)
            return t

        return wrap(out)

    return run


# ---------------------------------------------------------------------------
# Views, matmuls and einsums of DTensors, legal on every DTensor version
# ---------------------------------------------------------------------------


def _view_groups(a: tuple, b: tuple) -> list:
    """(input dims, output dims) groups of a view from shape a to shape b:
    each group's sizes multiply to the same product."""
    groups, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        gi, gj, pa, pb = [i], [j], a[i], b[j]
        i, j = i + 1, j + 1
        while pa != pb:
            if pa < pb:
                gi.append(i)
                pa *= a[i]
                i += 1
            else:
                gj.append(j)
                pb *= b[j]
                j += 1
        groups.append((gi, gj))
    groups += [([k], []) for k in range(i, len(a))] + [([], [k]) for k in range(j, len(b))]
    return groups


def legal_for_view(x, out_shape: tuple):
    """x redistributed so that viewing it as out_shape keeps every shard
    whole: a sharded dim may map to one output dim, lead a group of
    flattened dims, or be split when the first piece takes its shards
    evenly.  Other sharded dims are gathered (DTensor versions differ in
    which of these they allow: some refuse every other case, some record
    a strided layout)."""
    mesh, shape = x.device_mesh, tuple(x.shape)
    keep = list(x.placements)
    for gi, gj in _view_groups(shape, tuple(out_shape)):
        for d in gi:
            dims = mesh_dims_of(x, d)
            if not dims:
                continue
            n = math.prod(mesh.size(m) for m in dims)
            ok = (len(gi) == 1 and len(gj) == 1
                  or len(gj) == 1 and d == gi[0]
                  or len(gi) == 1 and len(gj) > 1 and out_shape[gj[0]] % n == 0)
            if not ok:
                for m in dims:
                    keep[m] = Replicate()
    if keep == list(x.placements):
        return x
    return x.redistribute(mesh, keep)


class _ToLocal(torch.autograd.Function):
    """A DTensor's local shard; its gradient goes back as a DTensor with
    `grad_placements` (a partial sum where the computation split work
    across a mesh dim the input was replicated on)."""

    @staticmethod
    def forward(ctx, x, grad_placements):
        ctx.meta = (x.device_mesh, grad_placements, x.shape, x.stride())
        return x._local_tensor.view_as(x._local_tensor)

    @staticmethod
    def backward(ctx, grad):
        mesh, placements, shape, stride = ctx.meta
        return DTensor.from_local(grad, mesh, placements, run_check=False, shape=shape,
                                  stride=stride), None


class _FromLocal(torch.autograd.Function):
    """A local result as a DTensor with `placements`; its gradient comes
    back as the local piece of the gradient laid out so (a partial sum's
    gradient is the whole gradient on every device)."""

    @staticmethod
    def forward(ctx, local, mesh, placements):
        ctx.meta = (mesh, tuple(Replicate() if p.is_partial() else p for p in placements))
        return DTensor.from_local(local, mesh, placements, run_check=False)

    @staticmethod
    def backward(ctx, grad):
        mesh, placements = ctx.meta
        if tuple(grad.placements) != placements:
            grad = grad.redistribute(mesh, placements)
        return grad._local_tensor, None, None


def local_call(fn, mesh, args, in_placements, out_placements, split_dims=()):
    """fn on each device's shards: each DTensor in `args` redistributed to
    its `in_placements` entry (None: passed as it is), fn's tensor outputs
    wrapped with `out_placements` (one list per output).  `split_dims` are
    the mesh dims along which devices compute different things: an input
    replicated on one of them gets its gradient back as a partial sum.
    The counterpart of `torch.distributed.tensor.experimental.local_map`,
    with the backward spelled out (DTensor versions differ in what a
    partial output's gradient becomes)."""
    locals_ = []
    for a, pl in zip(args, in_placements):
        if not isinstance(a, DTensor) or pl is None:
            locals_.append(a)
            continue
        pl = tuple(pl)
        if tuple(a.placements) != pl:
            a = a.redistribute(mesh, pl)
        grad_pl = tuple(Partial() if p.is_replicate() and m in split_dims else p
                        for m, p in enumerate(pl))
        locals_.append(_ToLocal.apply(a, grad_pl) if torch.is_grad_enabled() and
                       a.requires_grad else a._local_tensor)
    out = fn(*locals_)
    if out is None:
        return None
    single = not isinstance(out, tuple)
    outs = (out,) if single else out
    wrapped = tuple(_FromLocal.apply(o, mesh, tuple(pl)) if isinstance(o, torch.Tensor) else o
                    for o, pl in zip(outs, out_placements))
    return wrapped[0] if single else wrapped


def local_einsum(eq: str, operands, fn=None):
    """torch.einsum of DTensors on each device's shards, as a partitioner
    runs a dot: per mesh dim the first sharded letter decides (an operand
    holding it is sharded along it, one without it is gathered); the
    result is sharded along that letter, or, where it is contracted, a
    partial sum that is all-reduced.  `fn`, when given, computes the same
    product on the local shards (so a caller keeps its own arithmetic,
    e.g. matmul's, and a one-device mesh gives the unsharded result bit
    for bit)."""
    ins, out = eq.replace(" ", "").split("->")
    ins = ins.split(",")
    ops = [reduce_partial(t) for t in operands]
    mesh = next(t.device_mesh for t in ops if isinstance(t, DTensor))
    want = [[Replicate()] * mesh.ndim for _ in ops]
    out_pl = [Replicate()] * mesh.ndim
    split = []
    for m in range(mesh.ndim):
        letter = next((ins[i][t.placements[m].dim] for i, t in enumerate(ops)
                       if isinstance(t, DTensor) and t.placements[m].is_shard()), None)
        if letter is None or any(letter in s and t.shape[s.index(letter)] % mesh.size(m)
                                 for s, t in zip(ins, ops)):
            continue
        for i, s in enumerate(ins):
            if letter in s:
                want[i][m] = Shard(s.index(letter))
        out_pl[m] = Shard(out.index(letter)) if letter in out else Partial()
        split.append(m)
    in_pl = [w if isinstance(t, DTensor) else None for w, t in zip(want, ops)]
    fn = fn or (lambda *ts: torch.einsum(eq, *ts))
    out = local_call(fn, mesh, ops, in_pl, [out_pl], split_dims=split)
    # reduced at once: DTensor versions differ in how (or whether) a
    # partial sum meets a sharded operand in the next op
    return reduce_partial(out)


class _Reshape(torch.autograd.Function):
    """A DTensor reshaped legally both ways: the backward's reshape of the
    gradient (which autograd would otherwise issue as a plain view) is
    legalized as the forward's is."""

    @staticmethod
    def forward(ctx, x, shape):
        ctx.shape = tuple(x.shape)
        return _legal_reshape(x, shape)

    @staticmethod
    def backward(ctx, grad):
        return _legal_reshape(grad, ctx.shape), None


def _legal_reshape(x, shape):
    """(Run where autograd is off: inside _Reshape.)"""
    x = legal_for_view(x, shape)
    if not x._local_tensor.is_contiguous():
        # DTensor views the local shard, it never copies (and its own
        # contiguous() goes by the global layout)
        x = DTensor.from_local(x._local_tensor.contiguous(), x.device_mesh, x.placements,
                               run_check=False, shape=x.shape, stride=x.stride())
    return x.reshape(shape)


_VIEWS = (torch.Tensor.reshape, torch.Tensor.view, torch.reshape, torch.Tensor.flatten,
          torch.flatten, torch.Tensor.unflatten)
_MATMULS = (torch.matmul, torch.Tensor.matmul, torch.Tensor.__matmul__)


class _DTensorLayouts(torch.overrides.TorchFunctionMode):
    """Active with the rules: views, matmuls and einsums of DTensors
    made legal for every DTensor version (`legal_for_view`,
    `local_einsum`); everything else passes through.  What runs inside a
    call it passes through runs without it (a backward's recompute:
    `with_layouts`)."""
    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _VIEWS and is_dtensor(args[0]) and not (
                len(args) > 1 and isinstance(args[1], torch.dtype)):
            out_shape = func(torch.empty(args[0].shape, device="meta"), *args[1:],
                             **kwargs).shape
            if func is torch.Tensor.view:
                args = (legal_for_view(args[0], tuple(out_shape)),) + tuple(args[1:])
            else:
                return _Reshape.apply(args[0], tuple(out_shape))
        elif (func in _MATMULS and (is_dtensor(args[0]) or is_dtensor(args[1]))
              and 2 <= args[0].ndim <= 10 and args[1].ndim == 2):
            lead = "abcdefghij"[:args[0].ndim - 1]
            return local_einsum(f"{lead}y,yz->{lead}z", args[:2], torch.matmul)
        elif func is torch.einsum and any(is_dtensor(t) for t in args[1:]):
            return local_einsum(args[0], args[1:])
        return func(*args, **kwargs)


def capture():
    """A context-manager factory that restores the rules active now (and
    with them `_DTensorLayouts`) wherever it is entered: the autograd
    engine runs a CUDA backward on a thread of its own, where context
    variables set by `use_rules` are not set."""
    rules, sizes = current_rules(), current_axis_sizes()

    def restore():
        if rules is None or (current_rules() is not None and any(
                isinstance(m, _DTensorLayouts)
                for m in torch.overrides._get_current_function_mode_stack())):
            return contextlib.nullcontext()
        return use_rules(rules, sizes)

    return restore


def with_layouts(fn):
    """fn run under the rules active when with_layouts was called, also
    where they are not set or the mode is off (the recompute of a
    checkpointed layer, which runs inside the backward)."""
    restore = capture()

    def run(*args):
        with restore():
            return fn(*args)

    return run
