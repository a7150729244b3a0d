"""Sharding rule resolution for the launch layer: batch/cache/optimizer
specs per (config x input shape x mesh), built on the logical-axis rules in
repro_torch.shard.

Port of `repro.launch.sharding`.  The spec functions give the reference's
specs entry for entry (as `shard.P`).  Its `with_sharding`, `named_legal`
and `to_named` attach `NamedSharding`s to shape structs and outputs; here
`distribute_tree` lays a tree of tensors (or, with `make_local`, of
stand-ins built from their shapes) out as DTensors with the legalized
placements, `redistribute_tree` lays out a tree a step returned, and
`placements_for` gives one tensor's placements.

The rules table is the perf lever: dryrun.py accepts overrides like
--rule kv_seq=model to move the KV cache onto the flash-decode layout
without touching model code.
"""

from __future__ import annotations

import copy
import dataclasses

import torch
from torch.distributed.tensor import DTensor

from repro_torch import shard
from repro_torch.configs.shapes import InputShape
from repro_torch.models import cache as cachelib
from repro_torch.models.common import ModelConfig, ParamDef, _flatten_defs, _set_path
from repro_torch.shard import P


def config_rule_overrides(cfg: ModelConfig) -> dict:
    """Per-config logical-axis overrides (e.g. DeepSeek-V3 shards its 256
    experts over data x model)."""
    ov: dict = {}
    if cfg.family == "moe":
        axes = tuple(cfg.expert_shard_axes)
        ov["expert"] = axes if len(axes) > 1 else axes[0]
        if len(axes) > 1:
            ov["capacity"] = None   # capacity dim can't reuse the data axis
    return ov


def shape_rule_overrides(shape: InputShape) -> dict:
    """Per-input-shape layout policy.

    train    — sequence-parallel activations ("seq": model): the per-layer
               hidden states saved for backward shard 16x further.
    decode   — fully sequence-parallel attention: cache S-sharded over
               model (flash-decode), attention heads replicated, weights
               row-parallel ("embed_w": model) so per-token all-reduces are
               tiny instead of per-layer cache all-gathers.
    long_500k— batch=1: cache sequence takes the data axis too.
    """
    if shape.kind == "train":
        return {"seq": "model"}
    if shape.kind == "decode":
        ov = {"embed_w": "model", "heads": None, "kv_heads": None}
        if shape.name == "long_500k":
            ov.update({"batch": None, "kv_seq": "data", "capacity": None})
        return ov
    return {}


def build_rules(cfg: ModelConfig, shape: InputShape, *, multi_pod: bool,
                extra: dict | None = None) -> dict:
    rules = shard.make_rules(multi_pod=multi_pod,
                             overrides=config_rule_overrides(cfg))
    rules.update(shape_rule_overrides(shape))
    if extra:
        rules.update(extra)
    return rules


# ---------------------------------------------------------------------------
# Input / cache / optimizer specs
# ---------------------------------------------------------------------------

_INPUT_AXES = {
    "tokens": ("batch", "seq"),
    "labels": ("batch", "seq"),
    "token": ("batch",),
    "patches": ("batch", None, None),
    "frames": ("batch", "frames", None),
}


def input_pspecs(specs: dict, rules: dict) -> dict:
    return {k: shard.resolve(_INPUT_AXES[k], rules) for k in specs}


_CACHE_AXES = {
    cachelib.KVCache: {
        "k": ("layers", "batch", "kv_seq", "kv_heads", None),
        "v": ("layers", "batch", "kv_seq", "kv_heads", None),
        "pos": (),
    },
    cachelib.WindowKVCache: {
        "k": ("layers", "batch", "kv_seq", "kv_heads", None),
        "v": ("layers", "batch", "kv_seq", "kv_heads", None),
        "pos": (),
    },
    cachelib.MLACache: {
        "c_kv": ("layers", "batch", "kv_seq", None),
        "k_rope": ("layers", "batch", "kv_seq", None),
        "pos": (),
    },
    cachelib.SSMCache: {
        "conv": ("layers", "batch", None, "mlp"),
        "state": ("layers", "batch", "ssm_heads", None, None),
        "pos": (),
    },
    cachelib.HybridCache: {
        "lru": ("layers", "batch", "lru"),
        "conv": ("layers", "batch", None, "lru"),
        "k": ("layers", "batch", "kv_seq", "kv_heads", None),
        "v": ("layers", "batch", "kv_seq", "kv_heads", None),
        "pos": (),
    },
    cachelib.EncDecCache: {
        "self_k": ("layers", "batch", "kv_seq", "kv_heads", None),
        "self_v": ("layers", "batch", "kv_seq", "kv_heads", None),
        "cross_k": ("layers", "batch", "frames", "kv_heads", None),
        "cross_v": ("layers", "batch", "frames", "kv_heads", None),
        "pos": (),
    },
}


def cache_pspecs(cache_struct, rules: dict):
    """A cache of the same type whose fields are the specs of its tensors."""
    axes_map = _CACHE_AXES[type(cache_struct)]
    kw = {name: shard.resolve(axes, rules) for name, axes in axes_map.items()}
    return type(cache_struct)(**kw)


def opt_state_pspecs(opt_name: str, param_defs: dict, rules: dict, *,
                     param_spec_tree: dict | None = None, mesh=None) -> dict:
    """Optimizer-state specs mirroring the (possibly FSDP'd) parameter
    layout."""
    flat = _flatten_defs(param_defs)

    def leaf_entries(path: str, d: ParamDef) -> list:
        if param_spec_tree is not None:
            node = param_spec_tree
            for k in path.split("/"):
                node = node[k]
            spec = node
        else:
            spec = shard.resolve(d.axes, rules)
            if mesh is not None:
                spec = legalize_spec(d.shape, spec, mesh)
        return list(spec) + [None] * (len(d.shape) - len(spec))

    if opt_name in ("adamw", "sgd"):
        m: dict = {}
        for path, d in flat:
            _set_path(m, path, P(*leaf_entries(path, d)))
        if opt_name == "sgd":
            return {"m": m}
        return {"m": m, "v": copy.deepcopy(m), "step": P()}
    if opt_name == "adafactor":
        f: dict = {}
        for path, d in flat:
            e = leaf_entries(path, d)
            if len(d.shape) >= 2:
                _set_path(f, path, {"vr": P(*e[:-1]), "vc": P(*(e[:-2] + e[-1:]))})
            else:
                _set_path(f, path, {"v": P(*e)})
        return {"f": f, "step": P()}
    raise KeyError(opt_name)


def mesh_axis_sizes(mesh) -> dict:
    """{axis name: size} of a DeviceMesh, or of any mesh-like object with
    `axis_names` and `devices.shape` (as the reference's mesh has)."""
    if hasattr(mesh, "mesh_dim_names"):
        return {n: mesh.size(i) for i, n in enumerate(mesh.mesh_dim_names)}
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def legalize_spec(shape: tuple, spec: P, mesh) -> P:
    """Input-sharding legalization (see repro_torch.shard.legalize_spec)."""
    return shard.legalize_spec(shape, spec, mesh_axis_sizes(mesh))


def fsdp_specs(param_defs: dict, rules: dict, mesh, *,
               fsdp_axes: tuple = ("data",)) -> dict:
    """ZeRO/FSDP parameter layout: after resolving the tensor-parallel spec,
    additionally shard each parameter over the data axis on its largest
    free dividing dim.  Weights are then all-gathered per layer where
    they are used (the FSDP exchange)."""
    sizes = mesh_axis_sizes(mesh)
    f = 1
    for a in fsdp_axes:
        f *= sizes[a]
    fsdp_entry = fsdp_axes if len(fsdp_axes) > 1 else fsdp_axes[0]

    out: dict = {}
    for path, d in _flatten_defs(param_defs):
        spec = shard.legalize_spec(d.shape, shard.resolve(d.axes, rules), sizes)
        entries = list(spec) + [None] * (len(d.shape) - len(spec))
        used = set()
        for e in entries:
            if e is not None:
                used.update(e if isinstance(e, tuple) else (e,))
        if not any(a in used for a in fsdp_axes):
            cands = sorted(
                (j for j in range(len(entries))
                 if entries[j] is None and d.shape[j] % f == 0 and d.shape[j] >= f),
                key=lambda j: -d.shape[j])
            if cands:
                entries[cands[0]] = fsdp_entry
        _set_path(out, path, P(*entries))
    return out


# ---------------------------------------------------------------------------
# Tensors onto the mesh (the reference's named_legal / to_named /
# with_sharding)
# ---------------------------------------------------------------------------


def local_shape(shape: tuple, placements, mesh) -> tuple:
    """The shape of one device's shard of a tensor of `shape` (every dim
    a placement shards divides evenly, as legalized specs guarantee)."""
    out = list(shape)
    for mesh_dim, pl in enumerate(placements):
        if pl.is_shard():
            n = mesh.size(mesh_dim)
            if out[pl.dim] % n:
                raise ValueError(f"dim {pl.dim} of {tuple(shape)} does not split {n} ways")
            out[pl.dim] //= n
    return tuple(out)


def placements_for(shape: tuple, spec: P, mesh) -> tuple:
    """Legalized placements of a tensor of `shape` under `spec`."""
    return shard.to_placements(legalize_spec(tuple(shape), spec, mesh), mesh)


def to_dtensor(t: torch.Tensor, spec: P, mesh):
    """One tensor as a DTensor with `spec`'s legalized placements: `t` is
    the global value, the same on every rank, and each rank keeps its
    shard (no communication)."""
    if isinstance(t, DTensor):
        return t
    placements = placements_for(t.shape, spec, mesh)
    piece = t
    coord = mesh.get_coordinate()
    for mesh_dim, pl in enumerate(placements):
        if pl.is_shard():
            piece = piece.tensor_split(mesh.size(mesh_dim), dim=pl.dim)[coord[mesh_dim]]
    # tensor_split on the same tensor dim twice splits the major mesh dim
    # first, as the placements' default order does
    return DTensor.from_local(piece.contiguous(), mesh, placements, run_check=False)


def distribute_tree(tree, spec_tree, mesh, *, make_local=None):
    """A tree of tensors (nested dicts, lists or cache dataclasses) laid out
    on `mesh` as DTensors, leaf by leaf with the spec at the same place in
    `spec_tree` (legalized against the leaf's shape).  make_local(shape,
    dtype, ref) -> tensor, when given, builds each rank's shard from its
    shape instead of cutting it out of the leaf (the dry run passes one
    that makes fake tensors); leaves need only a shape and a dtype then."""
    def leaf(t, spec):
        if make_local is None:
            return to_dtensor(t, spec, mesh)
        placements = placements_for(t.shape, spec, mesh)
        local = make_local(local_shape(tuple(t.shape), placements, mesh), t.dtype, t)
        return DTensor.from_local(local, mesh, placements, run_check=False,
                                  shape=torch.Size(t.shape),
                                  stride=_contiguous_stride(tuple(t.shape)))

    return map_tree(leaf, tree, spec_tree)


def redistribute_tree(tree, spec_tree, mesh):
    """A tree laid out anew by `spec_tree`: each DTensor leaf redistributed
    to its spec's legalized placements, each plain tensor leaf (the same
    value on every rank, such as a cache's `pos`) cut into its shard."""
    def leaf(t, spec):
        if isinstance(t, DTensor):
            return t.redistribute(mesh, placements_for(t.shape, spec, mesh))
        return to_dtensor(t, spec, mesh)

    return map_tree(leaf, tree, spec_tree)


def _contiguous_stride(shape: tuple) -> tuple:
    stride, acc = [], 1
    for s in reversed(shape):
        stride.append(acc)
        acc *= s
    return tuple(reversed(stride))


def map_tree(fn, tree, spec_tree):
    """fn(leaf, spec) over a tree of tensors and the spec tree beside it."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, spec_tree)
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, spec_tree[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tree(fn, v, s) for v, s in zip(tree, spec_tree))
    if dataclasses.is_dataclass(tree):
        return type(tree)(**{f.name: map_tree(fn, getattr(tree, f.name),
                                              getattr(spec_tree, f.name))
                             for f in dataclasses.fields(tree)})
    return tree
