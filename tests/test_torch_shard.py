"""The port's sharding layer against the reference's: `repro_torch.shard`
and `repro_torch.launch.sharding` beside `repro.shard` and
`repro.launch.sharding`, spec for spec, over the ten assigned archs x the
four input shapes x the pod and multi-pod meshes.

The reference's spec functions read a mesh only through
`mesh_axis_sizes` (its `axis_names` and `devices.shape`): a stand-in with
those two serves both packages, so no devices are needed.  Specs compare
as tuples: the port's `shard.P` trims trailing Nones as the reference's
functions do before they build a `PartitionSpec`."""

from __future__ import annotations

import dataclasses
import types
from functools import partial

import numpy as np
import pytest
import torch

from repro_torch import shard
from repro_torch.configs import ASSIGNED_ARCHS, INPUT_SHAPES, get_config, token_specs
from repro_torch.launch import sharding as shardrules
from repro_torch.models import get_api

AXES = {"data": 16, "model": 16}
MESHES = {"pod": ((16, 16), ("data", "model")),
          "multipod": ((2, 16, 16), ("pod", "data", "model"))}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref():
    import jax
    from jax.sharding import PartitionSpec

    from repro import shard as rshard
    from repro.configs import get_config as rget_config
    from repro.configs import token_specs as rtoken_specs
    from repro.configs.shapes import INPUT_SHAPES as RSHAPES
    from repro.launch import sharding as rrules
    from repro.models import get_api as rget_api

    return types.SimpleNamespace(jax=jax, P=PartitionSpec, shard=rshard, rules=rrules,
                                 get_config=rget_config, get_api=rget_api,
                                 token_specs=rtoken_specs, shapes=RSHAPES)


def stand_in(mesh: str):
    shape, names = MESHES[mesh]
    return types.SimpleNamespace(axis_names=names, devices=np.empty(shape))


def flat_specs(tree, prefix=""):
    """{path: tuple(spec)} of a tree of specs: nested dicts, or a cache
    dataclass whose fields are specs."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat_specs(v, f"{prefix}/{k}"))
        return out
    if dataclasses.is_dataclass(tree):
        out = {}
        for f in dataclasses.fields(tree):
            out.update(flat_specs(getattr(tree, f.name), f"{prefix}.{f.name}"))
        return out
    return {prefix: tuple(tree)}


CELLS = [(a, s, m) for a in ASSIGNED_ARCHS for s in INPUT_SHAPES for m in MESHES]


def ids(cell):
    return "-".join(cell)


# ---------------------------------------------------------------------------
# The reference's own unit cases (tests/test_launch.py), on the port
# ---------------------------------------------------------------------------


class TestLegalizeSpec:
    def test_divisible_kept(self):
        out = shard.legalize_spec((64, 128), shard.P("data", "model"), AXES)
        assert tuple(out) == ("data", "model")

    def test_relocates_kv_heads_to_seq(self):
        out = shard.legalize_spec((28, 128, 32768, 8, 128),
                                  shard.P(None, "data", None, "model"), AXES)
        assert tuple(out) == (None, "data", "model")

    def test_relocates_odd_vocab_to_dmodel(self):
        out = shard.legalize_spec((92553, 2048), shard.P("model", None), AXES)
        assert tuple(out) == (None, "model")

    def test_drops_when_nothing_fits(self):
        out = shard.legalize_spec((3, 5), shard.P("model", None), AXES)
        assert tuple(out) == ()

    def test_tuple_axes(self):
        out = shard.legalize_spec((256, 7168), shard.P(("data", "model"), None), AXES)
        assert tuple(out) == (("data", "model"),)


class TestRules:
    def test_resolve_dedups_mesh_axes(self):
        rules = {"expert": "model", "mlp": "model"}
        spec = shard.resolve(("expert", "embed_w", "mlp"), rules)
        assert tuple(spec) == ("model",)

    def test_constrain_noop_without_rules(self):
        x = torch.ones((4, 4))
        assert shard.constrain(x, "batch", "mlp") is x

    def test_constrain_noop_on_plain_tensors_under_rules(self):
        x = torch.ones((4, 4))
        with shard.use_rules(shard.make_rules(), AXES):
            assert shard.constrain(x, "batch", "mlp") is x

    def test_shape_overrides(self):
        tr = shardrules.shape_rule_overrides(INPUT_SHAPES["train_4k"])
        assert tr["seq"] == "model"
        dc = shardrules.shape_rule_overrides(INPUT_SHAPES["decode_32k"])
        assert dc["embed_w"] == "model" and dc["heads"] is None
        lg = shardrules.shape_rule_overrides(INPUT_SHAPES["long_500k"])
        assert lg["batch"] is None and lg["kv_seq"] == "data"

    def test_config_overrides_v3_experts(self):
        ov = shardrules.config_rule_overrides(get_config("deepseek-v3-671b"))
        assert ov["expert"] == ("data", "model")

    def test_p_trims_and_survives_deepcopy(self):
        import copy
        p = shard.P("data", None, None)
        assert tuple(p) == ("data",) and copy.deepcopy(p) == p
        assert type(copy.deepcopy({"a": p})["a"]) is shard.P


class TestPlacements:
    def _mesh(self, names, shape):
        sizes = dict(zip(names, shape))
        return types.SimpleNamespace(mesh_dim_names=names, size=lambda i: shape[i],
                                     ndim=len(names), sizes=sizes)

    def test_named_axis_shards_its_dim(self):
        from torch.distributed.tensor import Replicate, Shard
        mesh = self._mesh(("data", "model"), (2, 2))
        assert shard.to_placements(shard.P(None, "model", "data"), mesh) == (Shard(2), Shard(1))
        assert shard.to_placements(shard.P(), mesh) == (Replicate(), Replicate())

    def test_tuple_entry_shards_one_dim_over_both_major_first(self):
        from torch.distributed.tensor import Replicate, Shard
        mesh = self._mesh(("pod", "data", "model"), (2, 2, 2))
        assert shard.to_placements(shard.P(("pod", "data"), None), mesh) == (
            Shard(0), Shard(0), Replicate())
        with pytest.raises(ValueError):
            shard.to_placements(shard.P(("data", "pod")), mesh)


# ---------------------------------------------------------------------------
# Entry for entry against the reference over archs x shapes x meshes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cell", CELLS, ids=ids)
def test_rules_match_reference(ref, cell):
    arch, shape_name, mesh = cell
    multi = mesh == "multipod"
    assert shard.make_rules(multi_pod=multi) == ref.shard.make_rules(multi_pod=multi)
    ours = shardrules.build_rules(get_config(arch), INPUT_SHAPES[shape_name], multi_pod=multi)
    theirs = ref.rules.build_rules(ref.get_config(arch), ref.shapes[shape_name],
                                   multi_pod=multi)
    assert ours == theirs
    sizes = shardrules.mesh_axis_sizes(stand_in(mesh))
    assert sizes == ref.rules.mesh_axis_sizes(stand_in(mesh))
    # resolve + legalize on every param's logical axes
    for _, d in shard_defs(arch):
        a = shard.resolve(d.axes, ours)
        b = ref.shard.resolve(d.axes, theirs)
        assert tuple(a) == tuple(b), d.axes
        assert (tuple(shard.legalize_spec(d.shape, a, sizes))
                == tuple(ref.shard.legalize_spec(d.shape, b, sizes))), (d.shape, d.axes)


def shard_defs(arch):
    from repro_torch.models.common import _flatten_defs
    cfg = get_config(arch)
    return _flatten_defs(get_api(cfg).param_defs(cfg))


@pytest.mark.parametrize("cell", CELLS, ids=ids)
def test_param_and_state_specs_match_reference(ref, cell):
    arch, shape_name, mesh = cell
    multi = mesh == "multipod"
    cfg, rcfg = get_config(arch), ref.get_config(arch)
    api, rapi = get_api(cfg), ref.get_api(rcfg)
    shape, rshape = INPUT_SHAPES[shape_name], ref.shapes[shape_name]
    rules = shardrules.build_rules(cfg, shape, multi_pod=multi)
    m = stand_in(mesh)
    defs, rdefs = api.param_defs(cfg), rapi.param_defs(rcfg)

    assert flat_specs(api.param_specs(cfg, rules)) == flat_specs(rapi.param_specs(rcfg, rules))
    fsdp = shardrules.fsdp_specs(defs, rules, m)
    rfsdp = ref.rules.fsdp_specs(rdefs, rules, m)
    assert flat_specs(fsdp) == flat_specs(rfsdp)
    for opt in ("adamw", "adafactor", "sgd"):
        assert (flat_specs(shardrules.opt_state_pspecs(opt, defs, rules, param_spec_tree=fsdp))
                == flat_specs(ref.rules.opt_state_pspecs(opt, rdefs, rules,
                                                         param_spec_tree=rfsdp))), opt
        assert (flat_specs(shardrules.opt_state_pspecs(opt, defs, rules, mesh=m))
                == flat_specs(ref.rules.opt_state_pspecs(opt, rdefs, rules, mesh=m))), opt

    specs = token_specs(cfg, shape)
    rspecs = ref.token_specs(rcfg, rshape)
    assert set(specs) == set(rspecs)
    assert (flat_specs(shardrules.input_pspecs(specs, rules))
            == flat_specs(ref.rules.input_pspecs(rspecs, rules)))

    B, S = shape.global_batch, shape.seq_len
    cache = api.init_cache(cfg, B, S, long_context=shape.long_context, device="meta")
    rcache = ref.jax.eval_shape(partial(rapi.init_cache, rcfg, B, S,
                                        long_context=shape.long_context))
    assert type(cache).__name__ == type(rcache).__name__
    assert (flat_specs(shardrules.cache_pspecs(cache, rules))
            == flat_specs(ref.rules.cache_pspecs(rcache, rules)))
    # and the legalized layout of every cache tensor
    rcs = ref.rules.cache_pspecs(rcache, rules)
    cs = shardrules.cache_pspecs(cache, rules)
    for f in dataclasses.fields(cs):
        t = getattr(cache, f.name)
        assert (tuple(shardrules.legalize_spec(tuple(t.shape), getattr(cs, f.name), m))
                == tuple(ref.rules.legalize_spec(tuple(t.shape), getattr(rcs, f.name), m)))


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "deepseek-v3-671b", "mamba2-130m",
                                  "recurrentgemma-9b", "seamless-m4t-large-v2"])
def test_cache_pspecs_structure_matches(arch):
    cfg = get_config(arch + "-reduced")
    cache = get_api(cfg).init_cache(cfg, 2, 32, device="meta")
    specs = shardrules.cache_pspecs(cache, shard.make_rules())
    assert type(specs) is type(cache)
    assert ({f.name for f in dataclasses.fields(specs)}
            == {f.name for f in dataclasses.fields(cache)})


def test_adafactor_factored():
    cfg = get_config("deepseek-v3-671b")
    specs = shardrules.opt_state_pspecs("adafactor", get_api(cfg).param_defs(cfg),
                                        shard.make_rules())
    assert set(specs["f"]["embed"]) == {"vr", "vc"}


def test_with_layouts_restores_the_rules_on_another_thread():
    """A checkpointed layer's recompute runs inside the backward, which
    the autograd engine runs on a thread of its own for CUDA tensors,
    where `use_rules`' context variables are unset: `with_layouts`
    restores them, and the layouts mode with them."""
    import threading
    seen = {}

    def body():
        seen["rules"] = shard.current_rules()
        seen["mode"] = any(isinstance(m, shard._DTensorLayouts)
                           for m in torch.overrides._get_current_function_mode_stack())

    rules = shard.make_rules()
    with shard.use_rules(rules, AXES):
        wrapped = shard.with_layouts(body)
    t = threading.Thread(target=wrapped)
    t.start()
    t.join()
    assert seen == {"rules": rules, "mode": True}
    assert shard.current_rules() is None
    shard.with_layouts(body)()           # made without rules: runs as it is
    assert seen == {"rules": None, "mode": False}
