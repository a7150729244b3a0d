"""The port's optimizers (`repro_torch.optim`) against the JAX package's.

The same parameters and the same numpy gradients go through three updates
of each package's AdamW, Adafactor and SGD.  f32 parameters and every
state leaf must match within rtol 1e-6 of the element, or 1e-6 of the
leaf's largest element where an update cancels an element to near zero:
XLA's f32 square root on the CPU is not correctly rounded (about 0.7 % of
its results are an ulp off torch's), so an element that ends near zero
can differ far more than 1e-6 relative to itself.  Both packages fuse
a*b + c into one rounding (the port through `torch.addcmul`), so the
momenta agree bit for bit.  bf16 parameters must be equal or one bf16
ulp apart.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import get_optimizer as jget_optimizer
from repro_torch.checkpoint import flatten_tree
from repro_torch.optim import get_optimizer

NAMES = ["adamw", "adafactor", "sgd"]
LR = {"adamw": 1e-2, "adafactor": 1e-1, "sgd": 1e-2}
SHAPES = {"w": (8, 16), "b": (16,), "blocks": {"k": (3, 4, 6), "s": (5,)}}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Run torch on one CPU thread here, as the other port tests do."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(fn, shapes=SHAPES):
    return {k: (_tree(fn, v) if isinstance(v, dict) else fn(v)) for k, v in shapes.items()}


def _draw(seed):
    rng = np.random.default_rng(seed)
    return _tree(lambda shape: rng.normal(size=shape).astype(np.float32))


def _updates(name, dtype, n=3):
    """Both packages' params and state after n updates with the same
    gradients.  Returns flattened numpy trees (ref params, ref state,
    port params, port state)."""
    params0, grads = _draw(0), [_draw(1 + i) for i in range(n)]
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jopt, opt = jget_optimizer(name), get_optimizer(name)
    jparams = jax.tree.map(lambda a: jnp.asarray(a, jdt), params0)
    params = _tree_t(params0, getattr(torch, dtype))
    jstate, state = jopt.init(jparams), opt.init(params)
    jupdate = jax.jit(lambda g, s, p: jopt.update(g, s, p, LR[name]))
    for g in grads:
        jparams, jstate = jupdate(jax.tree.map(lambda a: jnp.asarray(a, jdt), g), jstate,
                                  jparams)
        params, state = opt.update(_tree_t(g, getattr(torch, dtype)), state, params, LR[name])

    def ref_np(tree):
        return {k: np.asarray(v, np.float32) for k, v in
                flatten_tree(jax.tree.map(np.asarray, tree))}

    def port_np(tree):
        return {k: v.float().numpy() for k, v in flatten_tree(tree)}

    return ref_np(jparams), ref_np(jstate), port_np(params), port_np(state)


def _tree_t(tree, dtype):
    """numpy leaves -> copies as tensors (the updates write in place, and a
    jax array made from the same numpy array may share its memory)."""
    return {k: (_tree_t(v, dtype) if isinstance(v, dict) else torch.tensor(v, dtype=dtype))
            for k, v in tree.items()}


class TestAgainstReference:
    @pytest.mark.parametrize("name", NAMES)
    def test_three_updates_f32(self, name):
        ref_p, ref_s, p, s = _updates(name, "float32")
        assert p.keys() == ref_p.keys() and s.keys() == ref_s.keys()
        for ours, ref in ((p, ref_p), (s, ref_s)):
            for path in ref:
                np.testing.assert_allclose(ours[path], ref[path], rtol=1e-6,
                                           atol=1e-6 * np.abs(ref[path]).max(), err_msg=path)
        if name != "adafactor":                   # its momenta: fused, so bit for bit
            for path in ref_s:
                if path.startswith("m/"):
                    np.testing.assert_array_equal(s[path], ref_s[path], err_msg=path)

    @pytest.mark.parametrize("name", NAMES)
    def test_three_updates_bf16(self, name):
        """bf16 params stay bf16, equal to the reference's or one bf16 ulp
        apart; the f32 state within rtol 1e-6."""
        ref_p, ref_s, p, s = _updates(name, "bfloat16")
        for path in ref_p:
            ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ref_p[path]), 1e-30))) - 7)
            assert (np.abs(p[path] - ref_p[path]) <= ulp).all(), path
        for path in ref_s:
            np.testing.assert_allclose(s[path], ref_s[path], rtol=1e-6, atol=0, err_msg=path)

    @pytest.mark.parametrize("name", NAMES)
    def test_state_tree_keys_match(self, name):
        """The state trees have the reference's keys and shapes, so a
        checkpoint of one loads into the other."""
        params = _draw(0)
        jstate = jget_optimizer(name).init(jax.tree.map(jnp.asarray, params))
        state = get_optimizer(name).init(_tree_t(params, torch.float32))
        ref = {k: np.shape(v) for k, v in flatten_tree(jax.tree.map(np.asarray, jstate))}
        assert {k: tuple(v.shape) for k, v in flatten_tree(state)} == ref
        for k, v in flatten_tree(state):
            assert v.dtype == (torch.int32 if k == "step" else torch.float32), k


class TestBehaviour:
    """The reference's own optimizer tests (`tests/test_optim.py`), on the port."""

    @pytest.mark.parametrize("name,lr", [("adamw", 3e-2), ("adafactor", 3e-1),
                                         ("sgd", 1e-2)])
    def test_optimizer_descends(self, name, lr):
        target = _tree_t({"w": _draw(7)["w"], "b": _draw(8)["b"]}, torch.float32)
        params = {k: torch.zeros_like(v) for k, v in target.items()}
        opt = get_optimizer(name)
        state = opt.init(params)

        def loss_fn():
            return sum(((params[k] - target[k]) ** 2).sum() for k in target)

        l0 = float(loss_fn())
        for _ in range(60):
            grads = {k: 2 * (params[k] - target[k]) for k in target}
            params, state = opt.update(grads, state, params, lr)
        assert float(loss_fn()) < 0.2 * l0

    def test_adafactor_state_is_factored(self):
        state = get_optimizer("adafactor").init({"w": torch.zeros(32, 64),
                                                 "b": torch.zeros(64)})
        assert state["f"]["w"]["vr"].shape == (32,)
        assert state["f"]["w"]["vc"].shape == (64,)
        assert state["f"]["b"]["v"].shape == (64,)

    def test_adamw_bias_correction_first_step(self):
        opt = get_optimizer("adamw", weight_decay=0.0)
        params = {"w": torch.ones(4)}
        new, _ = opt.update({"w": torch.full((4,), 0.5)}, opt.init(params), params, 0.1)
        np.testing.assert_allclose(new["w"].numpy(), 1.0 - 0.1, rtol=1e-4)

    def test_update_in_place_keeps_dtypes(self):
        """bf16 params stay bf16 and f32 moments f32; the update writes the
        same tensors it was given (one copy on the card) and leaves the
        gradients as they were."""
        opt = get_optimizer("adamw")
        params = {"w": torch.ones(4, dtype=torch.bfloat16)}
        state = opt.init(params)
        w, m = params["w"], state["m"]["w"]
        grads = {"w": torch.ones(4)}
        new, new_state = opt.update(grads, state, params, 1e-2)
        assert new["w"] is w and new_state["m"]["w"] is m
        assert new["w"].dtype == torch.bfloat16 and m.dtype == torch.float32
        assert float(new["w"][0]) < 1.0 and int(new_state["step"]) == 1
        assert torch.equal(grads["w"], torch.ones(4))

    def test_unknown_optimizer_raises(self):
        with pytest.raises(KeyError, match="unknown optimizer"):
            get_optimizer("lion")
